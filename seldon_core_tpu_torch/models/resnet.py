"""ResNet-50 (v1.5) image classifier family.

Counterpart of ``seldon_core_tpu/models/resnet.py``: the stride on the
3x3 convolution of each stage's first block, inference batch norm folded
into one multiply-add in the compute dtype, a global average pool and a
float32 head. Input is NHWC of any scale (uint8 off the wire).

The parameter tree keeps the JAX package's keys and shapes (HWIO
convolutions, ``params["stages"]`` a list of lists of block dicts), so a
checkpoint moves between the packages unchanged. :meth:`ResNet50.prepare`
derives, once per tree, the convolutions as OIHW in the compute dtype
(channels-last in memory) and each batch norm as its folded scale and
shift. The wire's NHWC batch is viewed as channels-last NCHW, which is
the same memory.

XLA's ``"SAME"`` padding puts the odd pixel of a stride-2 window on an
even input below and to the right (the 7x7/2 stem on 224: 2 above, 3
below); PyTorch's ``padding=`` pads both sides alike, which would shift
every window by one. So an asymmetric pad is spelt out with ``F.pad``,
with ``-inf`` for the max pool as ``lax.reduce_window(-inf, max)`` pads.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .base import ServedModel, torch_dtype

# (blocks, channels) per stage — standard ResNet-50
STAGES = [(3, 256), (4, 512), (6, 1024), (3, 2048)]
BN_EPS = 1e-5


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: ``(before, after)``
    with the odd pixel after."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int):
    """NCHW (channels-last) convolution with XLA's SAME padding."""
    k = w.shape[-1]
    ph, pw = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _max_pool_same(x, k: int = 3, stride: int = 2):
    ph, pw = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.max_pool2d(x, k, stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


class ResNet50(ServedModel):
    def __init__(self, num_classes: int = 1000, image_size: int = 224,
                 dtype: str = "bfloat16", device=None, **_config_extras):
        # _config_extras absorbs jax_config.json keys consumed elsewhere
        # (seed -> init_params, class_names -> TorchServer)
        self.num_classes = int(num_classes)
        self.image_size = int(image_size)
        self.compute_dtype = dtype
        self.dtype = torch_dtype(dtype)
        self.example_input_shape = (self.image_size, self.image_size, 3)

    # -- params ---------------------------------------------------------

    def init_params(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random float32 params with the JAX package's shapes and scales
        (He-normal HWIO convolutions, identity batch norms, a 0.01-scale
        head) from a ``torch.Generator`` seeded with ``seed``: the numbers
        differ from the JAX package's ``init_params(seed)``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

        def conv_init(shape):  # HWIO
            fan_in = shape[0] * shape[1] * shape[2]
            return torch.randn(shape, generator=gen, device=dev) * math.sqrt(2.0 / fan_in)

        def bn_init(c):
            return {
                "scale": torch.ones((c,), device=dev),
                "bias": torch.zeros((c,), device=dev),
                "mean": torch.zeros((c,), device=dev),
                "var": torch.ones((c,), device=dev),
            }

        params: Dict[str, Any] = {
            "stem": {"conv": conv_init((7, 7, 3, 64)), "bn": bn_init(64)},
            "stages": [],
        }
        c_in = 64
        for blocks, c_out in STAGES:
            stage: List[Dict[str, Any]] = []
            width = c_out // 4
            for b in range(blocks):
                blk = {
                    "conv1": conv_init((1, 1, c_in, width)),
                    "bn1": bn_init(width),
                    "conv2": conv_init((3, 3, width, width)),
                    "bn2": bn_init(width),
                    "conv3": conv_init((1, 1, width, c_out)),
                    "bn3": bn_init(c_out),
                }
                if b == 0:
                    blk["proj"] = conv_init((1, 1, c_in, c_out))
                    blk["proj_bn"] = bn_init(c_out)
                stage.append(blk)
                c_in = c_out
            params["stages"].append(stage)
        params["fc"] = {
            "w": torch.randn((2048, self.num_classes), generator=gen, device=dev) * 0.01,
            "b": torch.zeros((self.num_classes,), device=dev),
        }
        return params

    # -- forward --------------------------------------------------------

    def prepare(self, params) -> Dict[str, Any]:
        """The convolutions as OIHW in the compute dtype (channels-last
        memory) and each batch norm folded to ``(scale, shift)`` in the
        compute dtype, computed in float32 as the JAX forward computes it."""
        dt = self.dtype

        def conv(w):
            return w.permute(3, 2, 0, 1).to(dt).contiguous(memory_format=torch.channels_last)

        def bn(p):
            inv = torch.reciprocal(torch.sqrt(p["var"] + BN_EPS)) * p["scale"]
            shift = p["bias"] - p["mean"] * inv
            return inv.to(dt).view(1, -1, 1, 1), shift.to(dt).view(1, -1, 1, 1)

        blocks = []
        for stage_idx, stage in enumerate(params["stages"]):
            for b, blk in enumerate(stage):
                blocks.append({
                    # v1.5: the stride lives on the 3x3
                    "stride": 2 if (b == 0 and stage_idx > 0) else 1,
                    "conv": [conv(blk[f"conv{i}"]) for i in (1, 2, 3)],
                    "bn": [bn(blk[f"bn{i}"]) for i in (1, 2, 3)],
                    "proj": (conv(blk["proj"]), bn(blk["proj_bn"])) if "proj" in blk else None,
                })
        return {
            "stem": (conv(params["stem"]["conv"]), bn(params["stem"]["bn"])),
            "blocks": blocks,
            "fc": (params["fc"]["w"], params["fc"]["b"]),
        }

    def apply(self, params, x):
        """x [B, H, W, 3] (uint8 or float, any scale) -> logits [B, classes]
        (float32)."""
        p = self.prepared(params)
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC memory, channels-last NCHW view
        w, (s, t) = p["stem"]
        x = torch.relu(_conv(x, w, 2) * s + t)
        x = _max_pool_same(x)
        for blk in p["blocks"]:
            stride = blk["stride"]
            shortcut = x
            if blk["proj"] is not None:
                pw, (ps, pt) = blk["proj"]
                shortcut = _conv(x, pw, stride) * ps + pt
            (w1, w2, w3), ((s1, t1), (s2, t2), (s3, t3)) = blk["conv"], blk["bn"]
            y = torch.relu(_conv(x, w1, 1) * s1 + t1)
            y = torch.relu(_conv(y, w2, stride) * s2 + t2)
            y = _conv(y, w3, 1) * s3 + t3
            x = torch.relu(y + shortcut)
        x = x.mean(dim=(2, 3))  # global average pool
        fw, fb = p["fc"]
        return x.float() @ fw + fb

    def flops_per_row(self, seq_len: int = None) -> float:
        """Exact conv+fc FLOPs for one image, counting a multiply-add as 2
        (the MFU convention) — ~8.2 GFLOP at 224x224 (= 2 x 4.1 GMAC)."""

        def conv(h, kh, kw, cin, cout, stride):
            h_out = -(-h // stride)  # SAME padding
            return h_out, 2.0 * h_out * h_out * kh * kw * cin * cout

        h, total = conv(self.image_size, 7, 7, 3, 64, 2)
        h = -(-h // 2)  # 3x3/2 max pool
        c_in = 64
        for stage_idx, (blocks, c_out) in enumerate(STAGES):
            width = c_out // 4
            for b in range(blocks):
                stride = 2 if (b == 0 and stage_idx > 0) else 1
                _, f1 = conv(h, 1, 1, c_in, width, 1)
                h2, f2 = conv(h, 3, 3, width, width, stride)
                _, f3 = conv(h2, 1, 1, width, c_out, 1)
                total += f1 + f2 + f3
                if b == 0:
                    _, fp = conv(h, 1, 1, c_in, c_out, stride)
                    total += fp
                h, c_in = h2, c_out
        return total + 2.0 * 2048 * self.num_classes
