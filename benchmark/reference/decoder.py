"""Plain PyTorch reference of the decoder: Mistral-7B-v0.3's block.

RMSNorm (eps from the configuration), rotary embeddings on the two
halves of each head (theta from the configuration), grouped-query
attention (query head h reads key/value head h // (heads / kv_heads)),
causal softmax at 1/sqrt(head_dim), a SwiGLU FFN (silu(x W1) * (x W3)) W2,
a final RMSNorm and an untied unembedding: the published block. Every
product in float32 with TF32 off, one sequence and one layer at a time,
no cache, no batching and no kernel of the program.

Weights come from the seed by the scheme the program documents for its
random initialisation: a ``torch.Generator`` on the device seeded with
the seed, normal draws in the order wq, wk, wv, wo, w1, w3, w2, embed,
unembed, scaled by 1/sqrt(fan-in) (the embedding by 1), norms at one.
They are drawn here again, not taken from the program, and rounded to
the configuration's type (bfloat16, the published checkpoint's); the
reference computes on them in float32.

The comparison (:func:`compare`): run once over each sampled request's
prompt and served tokens, and read at each served position the gap by
which the served token's logit lies below the reference's best. Greedy
decoding at the reference's arithmetic would read 0 everywhere; the
widest gap over the sample is the number judged. The control
(:func:`compare` with ``control="fp8"``) puts the reference in the
program's place with every matrix weight rounded to float8 e4m3 (one
scale per output column) and reads the gap of the token that it ranks
first at each of the same positions.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch

MATRICES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def make_weights(cfg: Dict[str, Any], seed: int, device):
    """The seed's weights in the configuration's served type (drawn as
    float32, scaled, cast), made on ``device`` in one large draw per leaf."""
    dtype = getattr(torch, cfg.get("dtype", "bfloat16"))
    D, H, KV, F, L, V = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"],
                         cfg["n_layers"], cfg["vocab_size"])
    Dh = D // H
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def draw(shape, scale):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    s = 1.0 / math.sqrt(D)
    blocks = {
        "wq": draw((L, D, H * Dh), s),
        "wk": draw((L, D, KV * Dh), s),
        "wv": draw((L, D, KV * Dh), s),
        "wo": draw((L, H * Dh, D), 1.0 / math.sqrt(H * Dh)),
        "w1": draw((L, D, F), s),
        "w3": draw((L, D, F), s),
        "w2": draw((L, F, D), 1.0 / math.sqrt(F)),
    }
    embed = draw((V, D), 1.0)
    unembed = draw((D, V), s)
    return {"blocks": blocks, "embed": embed, "unembed": unembed}


def fp8_columns(w: torch.Tensor) -> torch.Tensor:
    """``w`` [in, out] rounded to float8 e4m3 with one scale per output
    column (its largest magnitude at e4m3's 448), back in float32."""
    w = w.float()
    scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def _rms(x, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps)


def _rope(x, theta):
    """x [H, T, Dh] at positions 0..T-1."""
    T, Dh = x.shape[-2], x.shape[-1]
    half = Dh // 2
    inv = 1.0 / torch.pow(float(theta), torch.arange(half, dtype=torch.float32,
                                                     device=x.device) / half)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(cfg, p, x):
    """One block over one sequence x [T, D] (float32)."""
    D, H, KV = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    Dh = D // H
    T = x.shape[0]
    eps = float(cfg.get("norm_eps", 1e-5))
    theta = float(cfg.get("rope_theta", 10000.0))
    h = _rms(x, eps)
    q = _rope((h @ p["wq"]).reshape(T, H, Dh).transpose(0, 1), theta)
    k = _rope((h @ p["wk"]).reshape(T, KV, Dh).transpose(0, 1), theta)
    v = (h @ p["wv"]).reshape(T, KV, Dh).transpose(0, 1)
    rep = H // KV
    k = k.repeat_interleave(rep, dim=0)
    v = v.repeat_interleave(rep, dim=0)
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    o = torch.empty(H, T, Dh, dtype=torch.float32, device=x.device)
    for h0 in range(0, H, 8):  # a few heads at a time: [8, T, T] scores
        s = (q[h0:h0 + 8] @ k[h0:h0 + 8].transpose(-1, -2)) / math.sqrt(Dh)
        s = s.masked_fill(~mask, float("-inf"))
        o[h0:h0 + 8] = torch.softmax(s, dim=-1) @ v[h0:h0 + 8]
    x = x + o.transpose(0, 1).reshape(T, H * Dh) @ p["wo"]
    h = _rms(x, eps)
    return x + (torch.nn.functional.silu(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"]


@torch.no_grad()
def logits(cfg: Dict[str, Any], w, seqs: Sequence[List[int]], starts: Sequence[int],
           control: Optional[str] = None) -> List[torch.Tensor]:
    """For each token list ``seqs[i]``, the float32 logits [n, V] at its
    positions ``starts[i]`` .. end, layer by layer over all sequences.
    ``control="fp8"`` rounds every matrix weight to float8 first."""
    dev = w["embed"].device
    conv = fp8_columns if control == "fp8" else (lambda t: t.float())
    xs = [w["embed"][torch.tensor(s, device=dev)].float() for s in seqs]
    for l in range(cfg["n_layers"]):
        p = {k: conv(w["blocks"][k][l]) for k in MATRICES}
        xs = [_layer(cfg, p, x) for x in xs]
        del p
    eps = float(cfg.get("norm_eps", 1e-5))
    un = conv(w["unembed"])
    return [_rms(x[st:], eps) @ un for x, st in zip(xs, starts)]


def compare(cfg: Dict[str, Any], w, sample: Sequence[Dict[str, Any]],
            control: Optional[str] = None) -> Dict[str, float]:
    """``sample``: dicts with ``prompt`` and ``served`` token lists. Returns
    ``{"logit_gap": widest gap, "positions": n}`` for the served tokens;
    with ``control`` also ``control_gap``, the widest gap of the tokens
    the control ranks first at the same positions."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        seqs = [list(r["prompt"]) + list(r["served"][:-1]) for r in sample]
        starts = [len(r["prompt"]) - 1 for r in sample]
        ref = logits(cfg, w, seqs, starts)
        gap, n = 0.0, 0
        for r, lg in zip(sample, ref):
            served = torch.tensor(r["served"], device=lg.device)
            best = lg.max(dim=-1).values
            g = best - lg.gather(1, served[:, None])[:, 0]
            gap = max(gap, float(g.max()))
            n += len(r["served"])
        out = {"logit_gap": gap, "positions": n}
        if control:
            ctl = logits(cfg, w, seqs, starts, control=control)
            cgap = 0.0
            for lg, cl in zip(ref, ctl):
                pick = cl.argmax(dim=-1)
                g = lg.max(dim=-1).values - lg.gather(1, pick[:, None])[:, 0]
                cgap = max(cgap, float(g.max()))
            out["control_gap"] = cgap
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
