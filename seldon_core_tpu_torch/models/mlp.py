"""MLP classifier family: the smallest served model (the iris parity case).

Counterpart of ``seldon_core_tpu/models/mlp.py``: dense layers with ReLU
between them in the compute dtype, a softmax in float32. The parameters
are a list of ``{"w": [d_in, d_out], "b": [d_out]}``, one per layer, as
in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..device import resolve_device
from .base import ServedModel, torch_dtype


class MLP(ServedModel):
    def __init__(
        self,
        in_features: int = 4,
        hidden: Sequence[int] = (64, 64),
        num_classes: int = 3,
        dtype: str = "bfloat16",
        device=None,
        **_config_extras,
    ):
        # _config_extras absorbs jax_config.json keys consumed elsewhere
        # (seed -> init_params, class_names -> TorchServer)
        self.in_features = int(in_features)
        self.hidden = tuple(int(h) for h in hidden)
        self.num_classes = int(num_classes)
        self.compute_dtype = dtype
        self.dtype = torch_dtype(dtype)
        self.example_input_shape = (self.in_features,)

    def init_params(self, seed: int = 0, device="cuda"):
        """Random float32 layers with the JAX package's shapes and scales
        (normal times sqrt(2 / d_in), zero biases) from a
        ``torch.Generator`` seeded with ``seed``: the numbers differ from
        the JAX package's ``init_params(seed)``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        dims = (self.in_features, *self.hidden, self.num_classes)
        return [
            {
                "w": torch.randn((d_in, d_out), generator=gen, device=dev)
                * math.sqrt(2.0 / d_in),
                "b": torch.zeros((d_out,), device=dev),
            }
            for d_in, d_out in zip(dims[:-1], dims[1:])
        ]

    def apply(self, params, x):
        """x [B, in_features] -> class probabilities [B, classes] (float32)."""
        dt = self.dtype
        h = x.to(dt)
        for i, layer in enumerate(params):
            h = h @ layer["w"].to(dt) + layer["b"].to(dt)
            if i < len(params) - 1:
                h = torch.relu(h)
        return torch.softmax(h.float(), dim=-1)
