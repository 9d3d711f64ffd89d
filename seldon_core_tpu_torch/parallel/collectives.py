"""The ``lax`` collectives of the JAX training body, over torch.distributed.

Inside ``shard_map`` JAX differentiates through each collective with its
transpose, and it inserts a ``pvary`` wherever a value replicated over an
axis meets one that varies over it. In the port every such sum is
written out. Each function here is an ``autograd.Function`` whose
backward is the JAX transpose:

* :func:`psum` — all_reduce SUM forward; identity backward (the transpose
  of ``psum`` is ``pvary``). The result is replicated: a caller that mixes
  it with a varying value puts a :func:`pvary` between, as JAX would.
* :func:`pvary` — identity forward; all_reduce SUM backward. Megatron's
  ``f``: the entry of every column-parallel product.
* :func:`ppermute` — send along ``perm``, receive what is sent here (zeros
  where nothing is); backward along the inverse permutation. Sends and
  receives go out as one ``batch_isend_irecv``, so no rank waits on
  another's order.
* :func:`all_to_all` — JAX's ``tiled=True`` exchange; backward is the same
  exchange with split and concat swapped.
* :func:`axis_index`, :func:`axis_size`.

Every function takes an :class:`~.mesh.Axis` and is the identity on an axis
of size 1, as in JAX, and on None (one device). ``torch.distributed.nn.functional.all_reduce`` is not
used for :func:`psum`: its backward sums again, which multiplies the
gradient of a replicated loss by the axis size.

Every rank of a group must issue the same collectives in the same order,
the backward's included: callers keep the body uniform (masks by rank
index with ``torch.where``, never a branch around a collective).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Axis


def axis_index(axis: Axis) -> int:
    """This rank's index along ``axis`` (linear, first axis major, over a
    tuple of axes)."""
    return axis.index


def axis_size(axis: Axis) -> int:
    return axis.size


def _all_reduce(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    out = x.contiguous().clone()
    for part in axis.parts or (axis,):
        if part.size > 1:
            dist.all_reduce(out, group=part.group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum over ``axis``; the gradient passes through unchanged."""
    if axis is None or axis.size == 1:
        return x
    return _PSum.apply(x, axis)


def pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return x
    return psum(x, axis) / axis.size


def pvary(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A replicated value entering varying work: the identity, whose
    gradient is summed over ``axis``."""
    if axis is None or axis.size == 1:
        return x
    return _PVary.apply(x, axis)


def _exchange(x: torch.Tensor, axis: Axis, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` from index s to index d for each (s, d) of ``perm``;
    the result is what arrived here, zeros where nothing did."""
    dst = dict(perm)
    src = {d: s for s, d in perm}
    x = x.contiguous()
    out = torch.zeros_like(x)
    me = axis.index
    if dst.get(me) == me:
        out.copy_(x)
        return out
    ops = []
    if me in dst:
        ops.append(dist.P2POp(dist.isend, x, axis.members[dst[me]], axis.group))
    if me in src:
        ops.append(dist.P2POp(dist.irecv, out, axis.members[src[me]], axis.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _exchange(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis, [(d, s) for s, d in ctx.perm]), None, None


def ppermute(x: torch.Tensor, axis: Axis, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` pairs (source index, destination index)
    along ``axis``; a rank no pair sends to receives zeros."""
    if axis is None or axis.size == 1:
        return x
    return _PPermute.apply(x, axis, tuple(perm))


def ring_perm(n: int):
    """The ring i -> i + 1 (mod n)."""
    return [(i, (i + 1) % n) for i in range(n)]


def _all_to_all_chunks(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` [n, ...]: chunk j goes to index j; returns [n, ...] with
    chunk j the one index j sent here."""
    pos = axis.group_pos
    ordered = pos != sorted(pos)
    if ordered:  # chunks in group-rank order
        x = x[torch.argsort(torch.tensor(pos)).to(x.device)]
    x = x.contiguous()  # the output takes x's strides: both must be dense
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    if ordered:
        out = out[torch.tensor(pos).to(x.device)]
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _all_to_all_chunks(x, axis)

    @staticmethod
    def backward(ctx, g):
        # out[j] here = in[me] at index j: the transpose is the same exchange
        return _all_to_all_chunks(g, ctx.axis), None


def all_to_all(x: torch.Tensor, axis: Axis, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x``'s ``split_axis`` cut into ``n`` equal blocks, block j sent to
    index j, and the blocks received concatenated along ``concat_axis``
    in index order. The result has ``split_axis`` n times shorter and
    ``concat_axis`` n times longer."""
    if axis is None or axis.size == 1:
        return x
    if axis.group is None:
        raise ValueError(f"all_to_all over {axis.names} needs a group of its own")
    n = axis.size
    blocks = x.unflatten(split_axis, (n, x.shape[split_axis] // n)).movedim(split_axis, 0)
    got = _AllToAll.apply(blocks.contiguous(), axis)
    return got.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)
