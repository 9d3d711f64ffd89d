"""Parallel layers of the port (counterpart of ``seldon_core_tpu/parallel``).

Mesh parallelism over torch.distributed, one process a rank: dp / tp / pp /
sp (ring attention) / ep over a :class:`~.mesh.Mesh`. Axes, by convention:

  data  — batch (DP; gradients summed here)
  stage — pipeline stages (PP; ppermute activation ring, ``pipeline.py``)
  seq   — sequence chunks (SP; ring attention over ppermute, ``ring.py``)
  model — attention heads / FFN columns (TP; psum after row-parallel mats)
  expert parallelism rides the combined (data, seq) axes via all_to_all
  (``moe.py``).

Ported: the mesh (``mesh.py``, ``launch.py`` for N ranks on one host), the
collectives with their transposes (``collectives.py``), ring attention,
GPipe, the switch MoE on one device and expert-parallel, and the explicit
parallel training step (``train.py``: ``make_train_step``,
``dryrun_multichip``), and the serving mesh of sharded generate serving
(``mesh.py``: ``ServingMesh``, one process over N devices, and
``ShardedTensor``, the storage it splits).
"""

from .mesh import (  # noqa: F401
    factor_devices,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
)
from .ring import ring_attention  # noqa: F401
