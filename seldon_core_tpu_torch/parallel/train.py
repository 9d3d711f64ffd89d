"""The parallel LM train step: dp x pp x sp x tp x ep, one process a rank.

Counterpart of ``seldon_core_tpu/parallel/train.py``. JAX writes the step
as one ``shard_map`` body with manual collectives and lets ``jax.grad``
transpose them; here every rank runs that body on its own shard with the
collectives of :mod:`.collectives`, and autograd runs their transposes:
``psum`` for the tensor-parallel row products, ``ppermute`` rings for both
the GPipe stage loop and ring attention, ``all_to_all`` for the experts.

The rest of JAX's gradient sums come from the transposes of its implicit
``pvary``: a parameter replicated over an axis that the activations it
meets vary over has its gradient summed over that axis. The port takes
those sums once per leaf after the backward (:func:`grad_sum_axes`, next
to :func:`param_specs`).

Parameters are float32 and sharded as :func:`param_specs` says; the
forward computes in the model's dtype (bf16 over float32 params on the
card) and the update is SGD, ``p - lr * g`` in the parameter's dtype.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..convert import sorted_leaves
from ..device import resolve_device
from ..models.llm import _rms_norm, token_ce
from .collectives import pmean, psum
from .mesh import AXES, EP_AXES, Mesh, factor_devices, make_mesh
from .pipeline import gpipe

COL = {"wq", "wk", "wv", "w1", "w3"}  # last dim over model
ROW = {"wo", "w2"}  # second-to-last dim over model
EXPERT = {"w1e", "w2e"}  # the expert dim over (data, seq)


def _map_blocks(params, fn):
    out = dict(params)
    out["blocks"] = {name: fn(leaf) for name, leaf in params["blocks"].items()}
    return out


def stack_stages(params: Dict[str, Any], n_stages: int) -> Dict[str, Any]:
    """Reshape block leaves [L, ...] -> [S, L/S, ...] for stage sharding
    (tensors or numpy arrays)."""

    def reshape(leaf):
        L = leaf.shape[0]
        if L % n_stages:
            raise ValueError(f"n_layers {L} not divisible by {n_stages} stages")
        return leaf.reshape(n_stages, L // n_stages, *leaf.shape[1:])

    return _map_blocks(params, reshape)


def unstack_stages(params: Dict[str, Any]) -> Dict[str, Any]:
    return _map_blocks(
        params, lambda leaf: leaf.reshape(leaf.shape[0] * leaf.shape[1], *leaf.shape[2:]))


def _block_ndims(cfg) -> Dict[str, int]:
    """Dims of each block leaf, unstacked ([L, ...])."""
    nd = {"ln1": 2, "wq": 3, "wk": 3, "wv": 3, "wo": 3, "ln2": 2}
    if cfg.n_experts > 0:
        nd.update(router=3, w1e=4, w2e=4)
    else:
        nd.update(w1=3, w3=3, w2=3)
    return nd


def _leaf_spec(path: Tuple[str, ...], nd: int):
    """The spec of one stage-stacked leaf from its key path and dims."""
    if path[0] != "blocks":
        return ()
    name = path[-1]
    if name in COL:
        return ("stage",) + (None,) * (nd - 2) + ("model",)
    if name in ROW:
        return ("stage",) + (None,) * (nd - 3) + ("model", None)
    if name in EXPERT:  # [S, Ls, E, D, F] / [S, Ls, E, F, D]
        return ("stage", None, EP_AXES, None, None)
    return ("stage",) + (None,) * (nd - 1)  # ln1/ln2/router


def param_specs(model, n_stages: int) -> Dict[str, Any]:
    """Which mesh axes shard each dim of each stage-stacked leaf: a tuple
    per leaf, one entry per dim (None, an axis name, or a tuple of names
    taken together), as JAX's ``PartitionSpec``s. ``()`` is replicated.

    Block leaves are [S, L/S, ...]: dim 0 over ``stage``; the
    tensor-parallel dims over ``model`` (the last of ``wq``/``wk``/``wv``/
    ``w1``/``w3``, the second-to-last of ``wo``/``w2``); the expert dim of
    ``w1e``/``w2e`` over ``("data", "seq")``."""
    del n_stages  # the stage dim is sharded at every stage count
    blocks = {name: _leaf_spec(("blocks", name), nd + 1)
              for name, nd in _block_ndims(model.cfg).items()}
    return {"embed": (), "blocks": blocks, "ln_f": (), "unembed": ()}


def grad_sum_axes(path: Tuple[str, ...]) -> Tuple[str, ...]:
    """The axes one leaf's gradient is summed over after the backward:
    JAX's transposes of the implicit ``pvary`` where the replicated
    parameter meets activations that vary.

    * every leaf not sharded over ``data`` and ``seq`` meets tokens that
      vary over both: summed over ``("data", "seq")``;
    * the expert weights are sharded over them, and the all_to_all's
      transpose already brings back every rank's rows: no sum;
    * ``embed``, ``ln_f`` and ``unembed`` sit outside the stage-sharded
      blocks: also summed over ``stage`` (only stage 0's embedding
      gradient and the last stage's head gradient are non-zero);
    * no leaf sums over ``model``: the activations a replicated leaf
      meets are replicated over it, the column products' ``pvary`` and the
      row products' ``psum`` having summed what varies.
    """
    if path[0] != "blocks":
        return ("data", "seq", "stage")
    if path[-1] in EXPERT:
        return ()
    return ("data", "seq")


def _put(tree: Dict[str, Any], path: Tuple[str, ...], leaf) -> None:
    (tree.setdefault("blocks", {}) if path[0] == "blocks" else tree)[path[-1]] = leaf


def shard_params(host_params: Dict[str, Any], mesh: Mesh, device="cuda"):
    """This rank's shard of a full (unstacked [L, ...]) parameter tree of
    tensors or numpy arrays, as fresh contiguous tensors on ``device``,
    stage-stacked as :func:`param_specs` says. With
    ``convert.params_from_numpy``'s layout the JAX package's parameters
    carry across: port rank r gets JAX device r's shard."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for path, leaf in sorted_leaves(stack_stages(host_params, mesh.shape["stage"])):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        for dim, axes in enumerate(_leaf_spec(path, t.dim())):
            if axes is not None:
                ax = mesh.axis(axes)
                width = t.shape[dim] // ax.size
                t = t.narrow(dim, ax.index * width, width)
        _put(out, path, t.to(dev).contiguous().clone())
    return out


def _gather_dim(t: torch.Tensor, dim: int, axis) -> torch.Tensor:
    if axis.size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return torch.cat([parts[p] for p in axis.group_pos], dim=dim)


def gather_params(sharded: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The full parameter tree back from every rank's shard (a collective:
    every rank calls it), unstacked [L, ...], as float32 numpy arrays."""
    out: Dict[str, Any] = {}
    for path, t in sorted_leaves(sharded):
        t = t.detach()
        for dim, axes in enumerate(_leaf_spec(path, t.dim())):
            if axes is not None:
                t = _gather_dim(t, dim, mesh.axis(axes))
        _put(out, path, t.float().cpu().numpy())
    return unstack_stages(out)


def make_train_step(
    model,
    mesh: Mesh,
    n_microbatches: int = 2,
    learning_rate: float = 1e-2,
    use_pipeline: Optional[bool] = None,
    device="cuda",
):
    """Build ``(init_sharded_params, train_step)`` for a mesh with axes
    (data, stage, seq, model).

    ``train_step(params, tokens) -> (params, loss)`` updates this rank's
    shard in place and returns it with the global mean loss (a 0-dim
    float32 tensor, equal on every rank). ``tokens``: the GLOBAL batch
    [B, T+1] (the same on every rank, as JAX takes it); each rank reads
    its data shard of rows and, under ``seq``, its [T/sp] chunk plus the
    next-token targets that spill across the chunk boundary. T must
    divide by sp, B by dp * n_microbatches under a pipeline.
    ``train_step.value_and_grad(params, tokens) -> (loss, grads)`` is the
    same step without the update: the gradients, summed as
    :func:`grad_sum_axes` says, in the shape of the shard.

    Every rank must call ``train_step`` together: it issues collectives.
    """
    dev = resolve_device(device)
    cfg = model.cfg
    S = mesh.shape["stage"]
    dp = mesh.shape["data"]
    sp = mesh.shape["seq"]
    if use_pipeline is None:
        use_pipeline = S > 1
    data, stage, seq, tp = (mesh.axis(a) for a in AXES)
    ep = mesh.axis(EP_AXES)  # experts and the loss's row sums
    lr = float(learning_rate)

    def local_loss(params, tokens):
        """This rank's share of the global mean loss, psummed into it."""
        dt = model.dtype
        B = tokens.shape[0]
        if B % dp:
            raise ValueError(f"batch {B} not divisible by data={dp}")
        b_local = B // dp
        tokens = tokens[data.index * b_local:(data.index + 1) * b_local]
        T = tokens.shape[1] - 1
        if T % sp:
            raise ValueError(f"sequence {T} not divisible by seq={sp}")
        t_local = T // sp
        start = seq.index * t_local
        inputs = tokens[:, start:start + t_local].long()
        targets = tokens[:, start + 1:start + 1 + t_local].long()
        positions = start + torch.arange(t_local, device=tokens.device)

        x = params["embed"][inputs].to(dt)  # [B_local, T_local, D]
        # the stage shard arrives as [1, L/S, ...]; drop the unit dim (a
        # view: its backward copies nothing)
        blocks = {k: v.squeeze(0) for k, v in params["blocks"].items()}

        def run(bp, xx):
            return model.backbone(bp, xx, positions, tp=tp, sp=seq, ep=ep)

        if use_pipeline:
            M = n_microbatches
            if b_local % M:
                raise ValueError(f"local batch {b_local} not divisible by {M} microbatches")
            x_mb = x.reshape(M, b_local // M, t_local, -1)
            # KNOWN LIMIT (as JAX): the MoE aux loss is dropped on the
            # pipelined path; the ring carries activations only
            y = gpipe(lambda bp, xx: run(bp, xx)[0], blocks, x_mb, stage)
            y = y.reshape(b_local, t_local, -1)
        else:
            y, aux = run(blocks, x)
            if cfg.n_experts > 0:
                # a per-rank routing statistic: average over the ep ranks
                aux = pmean(aux, ep)

        y = _rms_norm(y, params["ln_f"].to(dt), cfg.norm_eps)
        logits = (y @ params["unembed"].to(dt)).float()
        ce = token_ce(logits, targets)
        loss_sum = psum(ce.sum(), ep)
        count = float(ce.numel() * ep.size)
        # only the last stage computed real logits; zero the rest and
        # share across stages
        is_last = float(stage.index == S - 1)
        loss = psum(loss_sum * is_last, stage) / count
        if not use_pipeline and cfg.n_experts > 0:
            loss = loss + cfg.aux_loss_weight * psum(aux * is_last, stage)
        return loss

    def value_and_grad(params, tokens):
        tokens = torch.as_tensor(tokens, device=dev)
        leaves = sorted_leaves(params)
        with torch.enable_grad():
            for _, p in leaves:
                p.requires_grad_(True)
            try:
                loss = local_loss(params, tokens)
                grads = torch.autograd.grad(loss, [p for _, p in leaves], allow_unused=True)
            finally:
                for _, p in leaves:
                    p.requires_grad_(False)
        out: Dict[str, Any] = {}
        with torch.no_grad():
            for (path, p), g in zip(leaves, grads):
                g = torch.zeros_like(p) if g is None else g  # unused: JAX's zero
                _put(out, path, psum(g, mesh.axis(grad_sum_axes(path))))
        return loss.detach(), out

    def train_step(params, tokens):
        loss, grads = value_and_grad(params, tokens)
        with torch.no_grad():
            for (_, p), (_, g) in zip(sorted_leaves(params), sorted_leaves(grads)):
                p.sub_(g * lr)
        return params, loss

    train_step.value_and_grad = value_and_grad

    def init_sharded_params(seed: int = 0):
        return shard_params(model.init_params(seed, device=dev), mesh, dev)

    return init_sharded_params, train_step


def dryrun_factorizations(n_devices: int):
    """The meshes ``__graft_entry__.dryrun_multichip`` runs on n devices:
    ``factor_devices(n)`` with a factor of 2 moved to ``seq`` (ring
    attention must run), then, when that left ``data`` at 1, the same with
    ``seq`` folded back into ``data`` (data-parallel gradients composed
    with pp/tp)."""
    first = factor_devices(n_devices)
    if first["seq"] == 1:
        for donor in ("data", "model", "stage"):
            if first[donor] % 2 == 0:
                first[donor] //= 2
                first["seq"] *= 2
                break
    runs = [first]
    if first.get("data", 1) == 1 and first["seq"] > 1:
        second = dict(first)
        second["data"] = second["data"] * second["seq"]
        second["seq"] = 1
        runs.append(second)
    return runs


def _dryrun_rank(rank: int, runs, device: str):
    out = []
    for axes in runs:
        mesh = make_mesh(axes)
        dp, sp = axes["data"], axes["seq"]
        # experts ride the combined (data, seq) ranks
        model = _dryrun_model(axes)
        init, step = make_train_step(model, mesh, n_microbatches=2, learning_rate=1e-2,
                                     device=device)
        params = init(0)
        B, T = dp * 2 * 2, 8 * sp
        tokens = np.random.RandomState(0).randint(0, 256, (B, T + 1))
        params, loss = step(params, tokens)
        loss_val = float(loss)
        if not math.isfinite(loss_val):
            raise RuntimeError(f"dry-run loss not finite: {loss_val}")
        out.append((dict(axes), loss_val))
    return out


def _dryrun_model(axes: Dict[str, int]):
    """The dry run's tiny model of one factorization (MoE with ``2 * ep``
    experts, widths that split over ``model``)."""
    from ..models.llm import DecoderLM

    ep = axes["data"] * axes["seq"]
    n_heads = 4 * axes["model"]
    return DecoderLM(
        vocab_size=256, d_model=32 * axes["model"], n_layers=2 * axes["stage"],
        n_heads=n_heads, n_kv_heads=n_heads, d_ff=64 * axes["model"],
        max_seq=8 * axes["seq"], n_experts=2 * ep, dtype="float32",
    )


def dryrun_serving(axes: Dict[str, int], device="cuda") -> Tuple[int, ...]:
    """The serving half of ``__graft_entry__.dryrun_multichip``: the
    sharded ``apply`` over a serving mesh of the same axes, its params
    stored under ``param_sharding`` (one process over the mesh's
    devices: the cards, or CPU positions). Raises unless the logits are
    finite and equal to the unsharded ``apply``'s bit for bit; returns
    their shape."""
    from .mesh import make_serving_mesh, place_tree

    dev = resolve_device(device)
    total = int(np.prod(list(axes.values())))
    mesh = make_serving_mesh(axes, device=dev,
                             devices=None if dev.type == "cuda" else [dev] * total)
    model = _dryrun_model(axes)
    params = model.init_params(0, device=mesh.device)
    sharded = place_tree(params, model.param_sharding(mesh, params))
    B, T = axes["data"] * 2 * 2, 8 * axes["seq"]
    x = torch.as_tensor(np.random.RandomState(0).randint(0, 256, (B, T)), device=mesh.device)
    logits = model.apply(sharded, x)
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("dry-run serving forward produced non-finite logits")
    if not torch.equal(logits, model.apply(params, x)):
        raise RuntimeError("dry-run sharded serving forward differs from the unsharded one")
    return tuple(logits.shape)


def dryrun_multichip(n_devices: int, axes: Optional[Dict[str, int]] = None,
                     device="cuda"):
    """``__graft_entry__.dryrun_multichip``: the FULL training step
    (tp/pp/dp/sp/ep) on tiny shapes over ``n_devices`` spawned ranks
    (NCCL, one card each, by default; ``device="cpu"``: gloo), one step
    per factorization (:func:`dryrun_factorizations`, or ``axes``) with
    ``n_experts = 2 * ep``, then the sharded serving forward over a
    serving mesh of the same axes (:func:`dryrun_serving`). Returns
    ``[(axes, loss)]`` as every rank computed it (rank 0's list), after
    checking that all ranks agree; raises if a loss is not finite."""
    from .launch import launch

    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    dev = resolve_device(device)
    runs = [dict(axes)] if axes is not None else dryrun_factorizations(n_devices)
    results = launch(_dryrun_rank, n_devices, args=(runs, str(dev.type)),
                     backend="nccl" if dev.type == "cuda" else "gloo")
    if any(r != results[0] for r in results):
        raise RuntimeError(f"ranks disagree on the dry-run losses: {results}")
    for ax, loss in results[0]:
        ep = ax["data"] * ax["seq"]
        shape = dryrun_serving(ax, device=dev)
        print(f"dryrun_multichip ok: mesh={ax} (ep={ep} via data x seq) loss={loss:.4f} "
              f"serve_logits={shape}")
    return results[0]
