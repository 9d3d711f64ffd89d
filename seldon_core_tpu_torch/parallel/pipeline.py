"""GPipe pipeline parallelism over the ``stage`` axis.

Counterpart of ``seldon_core_tpu/parallel/pipeline.py``. Stages live on
the ranks of the ``stage`` axis; activations flow stage -> stage over a
:func:`~.collectives.ppermute` ring while microbatches stream in: the
(M + S - 1)-tick schedule. The body is uniform: every rank computes every
tick, and injection and collection are masked with ``torch.where`` by
stage index. torch.distributed needs every rank of a group to issue the
same collectives in the same order, the backward's included, so no rank
branches around one: a masked-out value stays in the autograd graph with
a zero gradient, and every ppermute's backward runs on every rank.

The backward is autograd's through the ppermute chain (its transpose is
the reverse ring): the standard GPipe backward schedule.
"""

from __future__ import annotations

from typing import Callable

import torch

from .collectives import ppermute, ring_perm
from .mesh import Axis


def gpipe(stage_fn: Callable, stage_params, x_mb: torch.Tensor, axis: Axis):
    """Run the pipeline. ``stage_fn(stage_params, x)`` is this rank's
    stage; ``x_mb`` [M, mb, ...] the microbatched input (read on stage 0).
    Returns [M, mb, ...] outputs: valid on the last stage, zeros
    elsewhere (mask the loss downstream by stage)."""
    S = axis.size
    idx = axis.index
    M = x_mb.shape[0]
    dev = x_mb.device
    perm = ring_perm(S)
    first = torch.tensor(idx == 0, device=dev)
    last = idx == S - 1
    state = x_mb[0] * 0
    outputs = x_mb * 0
    for t in range(M + S - 1):
        inject = x_mb[min(max(t, 0), M - 1)]
        x_in = torch.where(first, inject, state)
        y = stage_fn(stage_params, x_in)
        out_idx = t - (S - 1)
        valid = torch.tensor(out_idx >= 0 and last, device=dev)
        slot = torch.tensor([min(max(out_idx, 0), M - 1)], device=dev)
        updated = outputs.index_copy(0, slot, y.to(outputs.dtype)[None])
        outputs = torch.where(valid, updated, outputs)
        state = ppermute(y, axis, perm)
    return outputs
