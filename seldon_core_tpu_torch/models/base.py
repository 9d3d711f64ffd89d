"""Served-model protocol: init/apply over a plain parameter dict.

Counterpart of ``seldon_core_tpu/models/base.py``. Every model family
exposes:
  * ``init_params(seed, device) -> params`` (nested dict of tensors)
  * ``apply(params, x) -> y``
  * ``example_input_shape`` (without batch) for warmup

Parameters stay a nested dict (or list) of tensors keyed exactly as the
JAX package's pytree, so weights carry across one-to-one (see
``convert``). A family whose forward wants the weights in another layout
or dtype (ResNet-50's OIHW convolutions, the encoders' compute-dtype
copies) derives them once per parameter tree in :meth:`ServedModel.prepare`
and reads them through :meth:`ServedModel.prepared`; the tree itself,
what ``convert.save_npz`` writes, keeps the JAX keys and shapes.

Sharding rules, as in the JAX package: ``input_sharding(mesh)`` (the
batch rides ``data``) and ``param_sharding(mesh, params)`` (replicated
by default; the encoders and the LLM split their matmul weights over
``model``), as ``parallel/mesh.py`` :class:`ServingSharding`s. Under a
serving mesh the storage is split and the compute replicated: a forward
reads layer ``l`` of a stacked, possibly split, leaf through
:meth:`ServedModel._layer`, which gathers the blocks onto the mesh's
compute device into a tensor of the unsharded shape, dtype and strides,
so the numbers are the one-device forward's.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..parallel.mesh import ServingSharding

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def torch_dtype(name) -> torch.dtype:
    """A dtype name of the JAX package's configs as a ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(DTYPES)}") from None


class ServedModel:
    example_input_shape: Tuple[int, ...] = ()
    # dtype for activations; params stay in param_dtype until the server
    # casts them
    compute_dtype = "bfloat16"
    param_dtype = "float32"

    def init_params(self, seed: int = 0, device="cuda"):
        raise NotImplementedError

    def apply(self, params, x):
        raise NotImplementedError

    def prepare(self, params) -> Any:
        """Tensors derived from ``params`` for the forward (permuted or
        cast copies); by default the params themselves."""
        return params

    def prepared(self, params) -> Any:
        """:meth:`prepare` of ``params``, computed on the first forward over
        this tree (a server's warmup, before it serves) and kept while the
        same tree object is served (one entry: a new tree replaces it)."""
        cached = getattr(self, "_prepared_for", None)
        if cached is None or cached[0] is not params:
            cached = (params, self.prepare(params))
            self._prepared_for = cached
        return cached[1]

    def flops_per_row(self, seq_len: int = None) -> float:
        """Analytic forward-pass FLOPs for one input row (a multiply-add
        counts 2); ``None`` means unknown."""
        return None

    # -- sharded serving: sharded storage, replicated compute ---------------

    def input_sharding(self, mesh) -> ServingSharding:
        """The request batch rides ``data`` when the mesh has it."""
        return ServingSharding(mesh, ("data",) if "data" in mesh.axis_names else ())

    def param_sharding(self, mesh, params):
        """The storage layout of ``params``, leaf for leaf: fully
        replicated by default."""
        return replicated_sharding(mesh, params)

    def _take(self, tag: str, w, key) -> torch.Tensor:
        """``w[key]``: from a sharded ``w``, the region gathered onto the
        compute device into a fresh tensor, so concurrent forwards (the
        predict path's thread pool) and a backward (the explainer's) each
        read their own copy."""
        return w[key]

    def _layer(self, blocks, l: int) -> Dict[str, torch.Tensor]:
        """Layer ``l`` of every stacked leaf of ``blocks``."""
        return {name: self._take(name, w, (l,)) for name, w in blocks.items()}


def replicated_sharding(mesh, params):
    """Every leaf of ``params`` (nested dicts and lists) replicated."""
    repl = ServingSharding(mesh, ())

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v) for v in tree]
        return repl

    return walk(params)


def encoder_param_sharding(mesh, params):
    """The encoders' tensor-parallel storage layout (the JAX package's
    BERT and ViT rule): on the stacked ``[L, ...]`` leaves, ``wq wk wv
    w1`` split their columns and ``wo w2`` their rows over ``model``;
    every other leaf, and every leaf on a mesh without ``model``, is
    replicated."""
    col = ServingSharding(mesh, (None, None, "model"))
    row = ServingSharding(mesh, (None, "model", None))
    repl = ServingSharding(mesh, ())
    has_model = "model" in mesh.axis_names

    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if has_model and name in ("wq", "wk", "wv", "w1"):
            return col
        if has_model and name in ("wo", "w2"):
            return row
        return repl

    return walk(params, None)


def layer_norm(x, scale, bias, eps: float):
    """Shared LayerNorm (the JAX package's ``models.base.layer_norm``):
    float32 statistics with the population variance, the result cast back
    to ``x.dtype``. One implementation for every encoder family (BERT eps
    1e-12, ViT eps from its config)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.reciprocal(torch.sqrt(var + eps))
    return (out * scale + bias).to(x.dtype)
