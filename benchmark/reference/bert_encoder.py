"""Plain PyTorch reference of BERT-base with a classification head.

The published encoder: the sum of token, position and type-0 embeddings
under a LayerNorm, then post-LN layers (self-attention over the unpadded
keys, an exact erf GELU FFN), a tanh pooler on the first token and a
linear head. LayerNorm eps from the configuration (1e-12). Every product
in float32 with TF32 off, a block of rows at a time, no kernel and
nothing of the program.

Weights come from the seed by the scheme the program documents for its
random initialisation: a ``torch.Generator`` on the device seeded with
the seed, normal draws times 0.02 in the order tok_embed, pos_embed,
type_embed, wq, wk, wv, wo, w1, w2, the pooler's and the head's
weights; biases at zero, LayerNorm scales at one. The published
checkpoint is float32, and so are these.

The comparison (:func:`compare`): each sampled row's class logits
against the reference's, the largest difference over the sample divided
by the largest reference logit in magnitude. The control
(``control="fp8"``) puts the reference in the program's place with
every matrix weight rounded to float8 e4m3 (one scale per output
column) and reads the same number of its own logits.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from benchmark.reference.decoder import fp8_columns

MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2")


def make_weights(cfg: Dict[str, Any], seed: int, device):
    D, L, F, V = cfg["d_model"], cfg["n_layers"], cfg["d_ff"], cfg["vocab_size"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32) * 0.02

    w = {"tok_embed": draw(V, D), "pos_embed": draw(cfg["max_seq"], D),
         "type_embed": draw(cfg["type_vocab"], D)}
    w["blocks"] = {k: draw(L, *((F, D) if k == "w2" else (D, F) if k == "w1" else (D, D)))
                   for k in MATRICES}
    w["pooler"] = draw(D, D)
    w["classifier"] = draw(D, cfg["num_classes"])
    return w


def _ln(x, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


@torch.no_grad()
def forward(cfg: Dict[str, Any], w, ids: torch.Tensor, control: Optional[str] = None):
    """ids [B, T] (0 = padding) -> logits [B, classes], float32."""
    conv = fp8_columns if control == "fp8" else (lambda t: t.float())
    eps = float(cfg.get("layer_norm_eps", 1e-12))
    H = cfg["n_heads"]
    B, T = ids.shape
    Dh = cfg["d_model"] // H
    ids = ids.long()
    x = w["tok_embed"][ids] + w["pos_embed"][:T][None] + w["type_embed"][0][None, None]
    x = _ln(x, eps)
    keep = (ids != 0)[:, None, None, :]
    for l in range(cfg["n_layers"]):
        p = {k: conv(w["blocks"][k][l]) for k in MATRICES}

        def heads(t):
            return t.reshape(B, T, H, Dh).transpose(1, 2)

        q, k, v = heads(x @ p["wq"]), heads(x @ p["wk"]), heads(x @ p["wv"])
        s = (q @ k.transpose(-1, -2)) / math.sqrt(Dh)
        s = s.masked_fill(~keep, float("-inf"))
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, T, H * Dh)
        x = _ln(x + o @ p["wo"], eps)
        f = torch.nn.functional.gelu(x @ p["w1"], approximate="none") @ p["w2"]
        x = _ln(x + f, eps)
    pooled = torch.tanh(x[:, 0] @ conv(w["pooler"]))
    return pooled @ conv(w["classifier"])


def compare(cfg: Dict[str, Any], w, ids: torch.Tensor, served: torch.Tensor,
            control: Optional[str] = None, block: int = 64) -> Dict[str, float]:
    """``ids`` [N, T] and the program's logits ``served`` [N, classes] of
    the sampled rows: ``{"logit_err": max |served - ref| / max |ref|,
    "rows": N}``, and with ``control`` also ``control_err`` (the same of
    the control's logits)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref = torch.cat([forward(cfg, w, ids[i:i + block]) for i in range(0, len(ids), block)])
        scale = float(ref.abs().max())
        out = {"logit_err": float((served.float() - ref).abs().max()) / scale,
               "rows": int(len(ids))}
        if control:
            ctl = torch.cat([forward(cfg, w, ids[i:i + block], control=control)
                             for i in range(0, len(ids), block)])
            out["control_err"] = float((ctl - ref).abs().max()) / scale
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
