"""Parallel layers of the port (counterpart of ``seldon_core_tpu/parallel``).

Ported: the switch mixture-of-experts FFN on one device (``moe``). The
mesh, ring attention, pipeline and training step are not ported yet.
"""
