"""Carry weights between the JAX package and the port.

* :func:`params_from_numpy` turns the JAX package's parameter pytree, with
  numpy leaves (``jax.tree.map(np.asarray, params)``), into the port's
  parameter dict on a device. Keys and shapes are the same on both sides.
* :func:`save_npz` / :func:`load_npz` keep a parameter dict in one ``.npz``
  file with flat ``"blocks/wq"``-style keys — the checkpoint format of
  ``servers/torchserver``. bfloat16 leaves are stored as their raw 16-bit
  patterns under a ``"@bfloat16"`` key suffix (numpy has no bfloat16).

A tree may hold lists as well as dicts (the MLP's layers, ResNet-50's
``stages``): a list index is a path segment (``"stages/2/0/conv1"``), and
a file that holds lists names their paths in one ``"@lists"`` entry, so
they come back as lists while a dict-only tree's keys stay exactly as
they were.

No safetensors and no ml_dtypes: plain numpy reads and writes these files.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .device import resolve_device

_BF16_SUFFIX = "@bfloat16"
_LISTS_KEY = "@lists"


def _leaf_to_tensor(arr, device, dtype=None) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes array handed over by JAX
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dicts and lists of numpy arrays -> the same tree of tensors
    on ``device`` (floating leaves cast to ``dtype`` when given)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf_to_tensor(node, dev, dtype)

    return walk(tree)


def _children(node):
    if isinstance(node, dict):
        return node.items()
    return enumerate(node)


def flatten(params, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts and lists -> ``{"blocks/wq": leaf, "stages/0/0/conv1":
    leaf, ...}`` (a list index is a path segment)."""
    out: Dict[str, Any] = {}
    for k, v in _children(params):
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def list_paths(params, prefix: str = "") -> List[str]:
    """The ``/``-joined paths of the list nodes of a tree (``""`` for a
    root list), the record :func:`unflatten` takes to rebuild them."""
    out: List[str] = []
    if isinstance(params, (list, tuple)):
        out.append(prefix.rstrip("/"))
    for k, v in _children(params):
        if isinstance(v, (dict, list, tuple)):
            out.extend(list_paths(v, f"{prefix}{k}/"))
    return out


def unflatten(flat: Dict[str, Any], lists=()):
    """``{"blocks/wq": leaf}`` -> nested dict; the nodes at the paths in
    ``lists`` (as :func:`list_paths` gives them) come back as lists, in
    index order."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    lists = set(lists)
    if not lists:
        return out

    def rebuild(node, path):
        if not isinstance(node, dict):
            return node
        kids = {k: rebuild(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        if path in lists:
            return [kids[str(i)] for i in range(len(kids))]
        return kids

    return rebuild(out, "")


def sorted_leaves(tree, path=()) -> List[Tuple[Tuple[Any, ...], Any]]:
    """``[(key path, leaf)]`` of a tree in the JAX package's
    ``tree_flatten`` order (dict keys sorted at every level, lists in
    index order, an index an ``int`` in the path): the order its weight
    pager frames leaves in and its swap check reports them."""
    if isinstance(tree, dict):
        out: List[Tuple[Tuple[Any, ...], Any]] = []
        for k in sorted(tree):
            out.extend(sorted_leaves(tree[k], path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(sorted_leaves(v, path + (i,)))
        return out
    return [(path, tree)]


def save_npz(params, path: str) -> None:
    """Write a parameter tree (tensors or numpy arrays) to ``path``."""
    arrays = {}
    lists = list_paths(params)
    if lists:
        arrays[_LISTS_KEY] = np.asarray(lists, dtype=np.str_)
    for key, leaf in flatten(params).items():
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            if t.dtype == torch.bfloat16:
                arrays[key + _BF16_SUFFIX] = t.view(torch.int16).numpy()
                continue
            arrays[key] = t.numpy()
        else:
            a = np.asarray(leaf)
            if a.dtype.name == "bfloat16":
                arrays[key + _BF16_SUFFIX] = a.view(np.int16)
            else:
                arrays[key] = a
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_npz(path: str, device="cuda", dtype=None):
    """Read a parameter tree written by :func:`save_npz` (or by
    ``np.savez`` with flat ``"a/b"`` keys) onto ``device``."""
    dev = resolve_device(device)
    flat = {}
    lists: List[str] = []
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            a = z[key]
            if key == _LISTS_KEY:
                lists = [str(p) for p in a]
                continue
            if key.endswith(_BF16_SUFFIX):
                t = torch.from_numpy(a.astype(np.int16, copy=False)).view(torch.bfloat16)
                key = key[: -len(_BF16_SUFFIX)]
            else:
                t = torch.from_numpy(a)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            flat[key] = t.to(dev)
    return unflatten(flat, lists)
