"""Operations and bytes, and the chip's peaks: the benchmark's yardstick.

Frozen copies of the program's analytic counts, so that a later change
to the program cannot move what its work is measured against
(``benchmark/tests/test_bench_counts.py`` holds them equal to the
program's today):

* :func:`decoder_flops_per_token` -- ``DecoderLM.flops_per_token``
* :func:`decoder_decode_bytes_per_token` -- ``DecoderLM.decode_bytes_per_token``
  with :func:`decoder_n_params` (``DecoderLM.n_params``)
* :func:`bert_flops_per_row` -- ``BertClassifier.flops_per_row``
* :func:`flash_flops` / :func:`flash_bytes` -- the flash kernel's count
  of the kernel table in ``PERF.md``: q.k and p.v over the visible keys
  only, q, k, v read once and o written once.

Configurations use the port's keys (``d_model``, ``n_layers``, ...).
"""

from __future__ import annotations

from typing import Any, Dict

# NVIDIA H100 SXM, dense, at the full 700 W power limit (NVIDIA's data
# sheet): bf16 tensor cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES_S = 3.35e12


def decoder_flops_per_token(cfg: Dict[str, Any], context_len: float) -> float:
    """Matmul FLOPs to process one token attending over ``context_len``
    keys: q/kv/out projections, scores and attn*V, the gated FFN, the lm
    head (a multiply-add is 2)."""
    D, F = cfg["d_model"], cfg["d_ff"]
    head_dim = D // cfg["n_heads"]
    kv_dim = cfg["n_kv_heads"] * head_dim
    per_layer = (2.0 * D * D + 2.0 * 2.0 * D * kv_dim + 2.0 * D * D
                 + 4.0 * context_len * D + 6.0 * D * F)
    return cfg["n_layers"] * per_layer + 2.0 * D * cfg["vocab_size"]


def decoder_prefill_flops(cfg: Dict[str, Any], start: int, n: int) -> float:
    """FLOPs of prefilling positions ``start .. start + n - 1`` (token at
    position p attends over p + 1 keys)."""
    if n <= 0:
        return 0.0
    # flops_per_token is affine in the context: sum it in closed form
    a = decoder_flops_per_token(cfg, 0.0)
    slope = decoder_flops_per_token(cfg, 1.0) - a
    ctx_sum = n * (start + 1) + n * (n - 1) / 2.0
    return n * a + slope * ctx_sum


def decoder_n_params(cfg: Dict[str, Any]) -> int:
    D, F, L, V = cfg["d_model"], cfg["d_ff"], cfg["n_layers"], cfg["vocab_size"]
    head_dim = D // cfg["n_heads"]
    kv = cfg["n_kv_heads"] * head_dim
    h = cfg["n_heads"] * head_dim
    per_layer = 2 * D + D * h + 2 * D * kv + h * D + 3 * D * F
    return L * per_layer + 2 * V * D + D


def decoder_decode_bytes_per_token(cfg: Dict[str, Any], context_len: float, batch: int = 1,
                                   param_bytes: int = 2) -> float:
    """Bytes read per decoded token at a batch: the params once per step,
    shared by the batch, plus the lane's bf16 K/V over its context."""
    head_dim = cfg["d_model"] // cfg["n_heads"]
    kv_per_tok_layer = 2 * cfg["n_kv_heads"] * head_dim * 2
    cache_read = cfg["n_layers"] * kv_per_tok_layer * context_len
    return decoder_n_params(cfg) * param_bytes / max(1, batch) + cache_read


def bert_flops_per_row(cfg: Dict[str, Any], seq_len: int) -> float:
    """Matmul FLOPs of one sequence: per token per layer 8 D^2 (qkv and
    out) + 4 T D (scores, attn*V) + 4 D F (FFN), plus pooler and head."""
    D, F = cfg["d_model"], cfg["d_ff"]
    per_token = cfg["n_layers"] * (8.0 * D * D + 4.0 * seq_len * D + 4.0 * D * F)
    return seq_len * per_token + 2.0 * D * D + 2.0 * D * cfg["num_classes"]


def flash_flops(b: int, h: int, t: int, dh: int, causal: bool = True) -> float:
    """FLOPs a causal self-attention of ``t`` queries over ``t`` keys
    needs: q.k and p.v over the visible keys only."""
    keys = t * (t + 1) // 2 if causal else t * t
    return 4.0 * b * h * dh * keys


def flash_bytes(b: int, h: int, kv: int, t: int, dh: int, item: int = 2) -> float:
    """q (h heads), k and v (kv heads) read once, o (h heads) written once."""
    return float(item * dh * t * b * (2 * h + 2 * kv))


def flash_bound_s(b: int, h: int, kv: int, t: int, dh: int, dtype: str = "bfloat16") -> float:
    """The least time of one launch: the larger of its FLOPs at the peak
    and its bytes at the HBM rate."""
    return max(flash_flops(b, h, t, dh) / PEAK_FLOPS[dtype],
               flash_bytes(b, h, kv, t, dh) / PEAK_BYTES_S)
