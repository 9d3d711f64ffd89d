"""ViT (vision transformer) image classifier family, ViT-B/16 defaults.

Counterpart of ``seldon_core_tpu/models/vit.py``: patchify as one
reshape + matmul, a CLS token, learned positions, a pre-LN encoder with
an exact (erf) GELU FFN (layers stacked on a leading axis, run one after
another), ``ln_f`` and a float32 head on CLS.

Dtypes follow the JAX forward: its attention products take bf16 operands
with ``preferred_element_type=float32``, so here the operands are widened
to float32 (exact) and multiplied there; the softmax is float32 and its
result goes back to the compute dtype before the product with V, whose
float32 result is cast to the compute dtype. The attention is dense over
the fixed patch grid: PyTorch ops, as XLA lowered it.
Under a serving mesh (``param_sharding``) each layer's weights are
gathered onto the compute device as the forward reaches them
(``ServedModel._layer``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .base import ServedModel, encoder_param_sharding, layer_norm, torch_dtype


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    num_classes: int = 1000
    # HF ViT checkpoints use 1e-12 (transformers default); 1e-6 is the
    # original-paper value
    ln_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def n_patches(self):
        return (self.image_size // self.patch_size) ** 2


_CAST = ("wq", "wq_b", "wk", "wk_b", "wv", "wv_b", "wo", "wo_b", "w1", "w1_b", "w2", "w2_b")


class ViTClassifier(ServedModel):
    def __init__(self, device=None, **config):
        fields = {f.name for f in dataclasses.fields(ViTConfig)}
        self.cfg = ViTConfig(**{k: v for k, v in config.items() if k in fields})
        if self.cfg.image_size % self.cfg.patch_size:
            raise ValueError(
                f"image_size {self.cfg.image_size} must tile by patch_size "
                f"{self.cfg.patch_size}"
            )
        self.example_input_shape = (self.cfg.image_size, self.cfg.image_size, 3)
        self.compute_dtype = self.cfg.dtype
        self.dtype = torch_dtype(self.cfg.dtype)

    def init_params(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random float32 params with the JAX package's shapes and scales
        (normal times 0.02, zero biases, unit LayerNorm scales) from a
        ``torch.Generator`` seeded with ``seed``: the numbers differ from
        the JAX package's ``init_params(seed)``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        cfg = self.cfg
        D, L, F_, P = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.patch_size

        def init(shape, scale=0.02):
            return torch.randn(shape, generator=gen, device=dev) * scale

        def zeros(*shape):
            return torch.zeros(shape, device=dev)

        def ones(*shape):
            return torch.ones(shape, device=dev)

        return {
            "patch_embed": {"w": init((P * P * 3, D)), "b": zeros(D)},
            "cls_token": init((1, 1, D)),
            "pos_embed": init((cfg.n_patches + 1, D)),
            "blocks": {
                "ln1_scale": ones(L, D), "ln1_bias": zeros(L, D),
                "wq": init((L, D, D)), "wq_b": zeros(L, D),
                "wk": init((L, D, D)), "wk_b": zeros(L, D),
                "wv": init((L, D, D)), "wv_b": zeros(L, D),
                "wo": init((L, D, D)), "wo_b": zeros(L, D),
                "ln2_scale": ones(L, D), "ln2_bias": zeros(L, D),
                "w1": init((L, D, F_)), "w1_b": zeros(L, F_),
                "w2": init((L, F_, D)), "w2_b": zeros(L, D),
            },
            "ln_f": {"scale": ones(D), "bias": zeros(D)},
            "head": {"w": init((D, cfg.num_classes)), "b": zeros(cfg.num_classes)},
        }

    def param_sharding(self, mesh, params):
        """The JAX package's ViT layout: see
        :func:`~seldon_core_tpu_torch.models.base.encoder_param_sharding`."""
        return encoder_param_sharding(mesh, params)

    def prepare(self, params) -> Dict[str, Any]:
        """The weights the JAX forward casts to the compute dtype at each
        use, cast once. A split leaf is cast block by block and stays
        split."""
        dt = self.dtype
        blocks = params["blocks"]
        return {
            "blocks": {k: (blocks[k].to(dt) if k in _CAST else blocks[k]) for k in blocks},
            "patch": (params["patch_embed"]["w"].to(dt), params["patch_embed"]["b"].to(dt)),
            "cls": params["cls_token"].to(dt),
            "pos": params["pos_embed"].to(dt),
        }

    def apply(self, params, x):
        """x [B, H, W, 3] (uint8 or float, any scale) -> logits [B, classes]
        (float32)."""
        cfg = self.cfg
        dt = self.dtype
        p = self.prepared(params)
        B = x.shape[0]
        P = cfg.patch_size
        g = cfg.image_size // P
        # patchify as one reshape + matmul:
        # [B,H,W,3] -> [B, g, P, g, P, 3] -> [B, g*g, P*P*3]
        x = x.to(dt).reshape(B, g, P, g, P, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, g * g, P * P * 3)
        pw, pb = p["patch"]
        x = x @ pw + pb
        cls = p["cls"].expand(B, 1, cfg.d_model)
        x = torch.cat([cls, x], dim=1)  # [B, N+1, D]
        x = x + p["pos"][None]
        T = x.shape[1]
        H, Dh = cfg.n_heads, cfg.head_dim
        eps = cfg.ln_eps
        scale = math.sqrt(Dh)

        def heads(t):
            return t.reshape(B, T, H, Dh).transpose(1, 2)

        blocks = p["blocks"]
        for i in range(cfg.n_layers):
            w = self._layer(blocks, i)
            h = layer_norm(x, w["ln1_scale"], w["ln1_bias"], eps)
            q = heads(h @ w["wq"] + w["wq_b"])
            k = heads(h @ w["wk"] + w["wk_b"])
            v = heads(h @ w["wv"] + w["wv_b"])
            s = (q.float() @ k.float().transpose(-1, -2)) / scale
            a = torch.softmax(s, dim=-1).to(dt)
            o = (a.float() @ v.float()).to(dt)
            o = o.transpose(1, 2).reshape(B, T, H * Dh)
            x = x + (o @ w["wo"] + w["wo_b"])
            h2 = layer_norm(x, w["ln2_scale"], w["ln2_bias"], eps)
            f = F.gelu(h2 @ w["w1"] + w["w1_b"], approximate="none")
            x = x + (f @ w["w2"] + w["w2_b"])
        # LayerNorm is per row: ln_f of the CLS row alone is ln_f(x)[:, 0]
        ln = params["ln_f"]
        cls_out = layer_norm(x[:, 0], ln["scale"], ln["bias"], eps)
        head = params["head"]
        return cls_out.float() @ head["w"] + head["b"]

    def flops_per_row(self, *_a) -> float:
        cfg = self.cfg
        T = cfg.n_patches + 1
        D, F_ = cfg.d_model, cfg.d_ff
        per_token = cfg.n_layers * (8.0 * D * D + 4.0 * T * D + 4.0 * D * F_)
        patchify = 2.0 * cfg.n_patches * (cfg.patch_size**2 * 3) * D
        return T * per_token + patchify + 2.0 * D * cfg.num_classes
