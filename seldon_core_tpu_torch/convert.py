"""Carry weights between the JAX package and the port.

* :func:`params_from_numpy` turns the JAX package's parameter pytree, with
  numpy leaves (``jax.tree.map(np.asarray, params)``), into the port's
  parameter dict on a device. Keys and shapes are the same on both sides.
* :func:`save_npz` / :func:`load_npz` keep a parameter dict in one ``.npz``
  file with flat ``"blocks/wq"``-style keys — the checkpoint format of
  ``servers/torchserver``. bfloat16 leaves are stored as their raw 16-bit
  patterns under a ``"@bfloat16"`` key suffix (numpy has no bfloat16).

No safetensors and no ml_dtypes: plain numpy reads and writes these files.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device

_BF16_SUFFIX = "@bfloat16"


def _leaf_to_tensor(arr, device, dtype=None) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes array handed over by JAX
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cuda", dtype=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device`` (floating leaves cast to ``dtype`` when given)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf_to_tensor(node, dev, dtype)

    return walk(tree)


def flatten(params, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> ``{"blocks/wq": leaf, ...}``."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"blocks/wq": leaf}`` -> nested dict."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def save_npz(params, path: str) -> None:
    """Write a parameter dict (tensors or numpy arrays) to ``path``."""
    arrays = {}
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


def load_npz(path: str, device="cuda", dtype=None) -> Dict[str, Any]:
    """Read a parameter dict written by :func:`save_npz` (or by
    ``np.savez`` with flat ``"a/b"`` keys) onto ``device``."""
    dev = resolve_device(device)
    flat = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            a = z[key]
            if key.endswith(_BF16_SUFFIX):
                t = torch.from_numpy(a.astype(np.int16, copy=False)).view(torch.bfloat16)
                key = key[: -len(_BF16_SUFFIX)]
            else:
                t = torch.from_numpy(a)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            flat[key] = t.to(dev)
    return unflatten(flat)
