"""Switch mixture-of-experts FFN, on one device and expert-parallel.

Counterpart of ``seldon_core_tpu/parallel/moe.py``. :func:`moe_ffn` is
the JAX ``moe_ffn`` at ``ep_axes=None``, the serving path:
tokens route top-1 to an expert with a capacity buffer, and a token past
its expert's capacity is dropped (its FFN output is 0). Dispatch and
combine are dense one-hot tensors of static shape, so a decode step that
runs this layer captures into a CUDA graph: nothing here reads back to
the host (the one-hots compare against an ``arange``, and the capacity
comes from the static row count).

The capacity counts every row of the call, ``max(1, int(capacity_factor
* N / E))`` over the ``N`` flattened rows, pad rows and parked lanes
included, and a row's place in its expert's buffer is its rank among the
rows before it that chose the same expert. So a row's output depends on
what shares its call, as in the JAX package.

:func:`moe_ffn_ep` is the JAX ``moe_ffn`` with ``ep_axes``, the training
path: the experts are sharded over an expert axis (the combined
``("data", "seq")`` ranks, data-major, so expert k lives where
``train.param_specs`` puts it) and two tiled all_to_alls trade each
expert's buffer for the ranks' rows. The capacity is per rank, over the
rank's own rows, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .collectives import all_to_all


class Routing(NamedTuple):
    """The router's decisions for ``N`` rows over ``E`` experts."""

    expert_idx: torch.Tensor  # [N] int64 top-1 expert (the first on a tie)
    gate: torch.Tensor  # [N] float32 probability of the chosen expert
    pos: torch.Tensor  # [N] int64 place in the chosen expert's buffer
    kept: torch.Tensor  # [N] bool: the place is under the capacity
    capacity: int
    aux_loss: torch.Tensor  # [] float32 Switch load-balancing loss


def route(x, router_w, capacity_factor: float = 1.25) -> Routing:
    """Top-1 routing of ``x`` [N, D] through ``router_w`` [D, E]: gate
    logits in ``x.dtype`` cast to float32, softmax, argmax, then each
    row's place in its expert's buffer by a cumulative count."""
    N = x.shape[0]
    E = router_w.shape[1]
    probs = torch.softmax((x @ router_w).float(), dim=-1)
    expert_idx = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert_idx[:, None])[:, 0]
    one_hot = (expert_idx[:, None] == torch.arange(E, device=x.device)).float()
    # Switch aux loss: E * sum_e(fraction of rows to e * mean prob of e)
    aux_loss = E * torch.sum(one_hot.mean(0) * probs.mean(0))
    capacity = max(1, int(capacity_factor * N / E))
    pos_in_expert = (torch.cumsum(one_hot, dim=0) - 1.0) * one_hot
    pos = (pos_in_expert * one_hot).sum(-1).long()
    kept = pos < capacity
    return Routing(expert_idx, gate, pos, kept, capacity, aux_loss)


def dispatch_combine(r: Routing, n_experts: int, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``dispatch`` [N, E, C]: 1 at (row, its expert, its place) for a
    kept row; ``combine``: the same weighted by the row's gate. Both in
    ``dtype``."""
    dev = r.expert_idx.device
    to_e = r.expert_idx[:, None] == torch.arange(n_experts, device=dev)
    to_c = r.pos[:, None] == torch.arange(r.capacity, device=dev)
    dispatch = (to_e[:, :, None] & to_c[:, None, :] & r.kept[:, None, None]).to(dtype)
    return dispatch, dispatch * r.gate.to(dtype)[:, None, None]


def experts(expert_in, w1, w2):
    """Each expert's FFN over its buffer: [E, C, D] -> [E, C, D], a
    tanh-approximated GELU between two batched matmuls."""
    h = torch.nn.functional.gelu(torch.bmm(expert_in, w1), approximate="tanh")
    return torch.bmm(h, w2)


def moe_ffn(x, router_w, w1, w2, capacity_factor: float = 1.25):
    """Top-1 switch MoE over ``x`` [N, D] with experts ``w1`` [E, D, F]
    and ``w2`` [E, F, D]. Returns ``([N, D] outputs, aux loss)``."""
    E = router_w.shape[1]
    r = route(x, router_w, capacity_factor)
    dispatch, combine = dispatch_combine(r, E, x.dtype)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, x)
    out = torch.einsum("nec,ecd->nd", combine, experts(expert_in, w1, w2))
    return out, r.aux_loss


def moe_ffn_ep(x, router_w, w1, w2, ep, capacity_factor: float = 1.25):
    """Top-1 switch MoE over this rank's ``x`` [N, D] with this rank's
    experts ``w1`` [E_local, D, F] and ``w2`` [E_local, F, D] of the
    ``router_w`` [D, E] experts, sharded over ``ep`` (a mesh ``Axis``, or
    None for one device): ``E_local * ep.size == E``. Returns ``([N, D]
    outputs, aux loss)``."""
    N, D = x.shape
    E = router_w.shape[1]
    n = 1 if ep is None else ep.size
    e_local = w1.shape[0]
    if e_local * n != E:
        raise ValueError(f"experts {E} != {e_local} x ep {n}")
    r = route(x, router_w, capacity_factor)
    dispatch, combine = dispatch_combine(r, E, x.dtype)
    C = r.capacity
    expert_in = torch.einsum("nec,nd->ecd", dispatch, x)  # [E, C, D]
    # [ep, E_local, C, D]: block j to index j, received blocks along C
    expert_in = all_to_all(expert_in.reshape(n, e_local, C, D), ep, 0, 2)
    expert_out = experts(expert_in.reshape(e_local, n * C, D), w1, w2)
    expert_out = all_to_all(expert_out.reshape(e_local, n, C, D), ep, 1, 0)
    out = torch.einsum("nec,ecd->nd", combine, expert_out.reshape(n * e_local, C, D))
    return out, r.aux_loss
