"""Ring attention: sequence-parallel exact attention over a ring of ranks.

Counterpart of ``seldon_core_tpu/parallel/ring.py``. Each rank of the
``seq`` axis holds one sequence chunk of Q, K, V. K/V chunks rotate
around the ring by :func:`~.collectives.ppermute` while each rank
accumulates its Q-chunk's attention with an online softmax in float32
(running max and denominator), so memory stays O(T/n) per rank.

Causal masking works on global positions: rank r owns rows
[r*C, (r+1)*C); at ring step s it sees the K/V chunk first owned by rank
(r - s) mod n. Blocks wholly in the future are computed and masked (the
body is uniform, as a scan's), and the last rotation, whose chunks nobody
reads, still runs, as in JAX: every rank issues the same collectives.

Plain PyTorch: JAX trains through XLA's attention, not the Pallas kernel
(which has no backward), so training runs no kernel here either.
"""

from __future__ import annotations

import math

import torch

from .collectives import ppermute, ring_perm
from .mesh import Axis

NEG_INF = -1e30


def _block_attn(q, k, v, bias, scale):
    """One (Q-chunk x K-chunk) block: (unnormalised out, row max, row
    denominator) for the online-softmax merge. q: [B,H,Tq,Dh], k/v:
    [B,H,Tk,Dh]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o, m, l


def ring_attention(q, k, v, axis: Axis, causal: bool = True):
    """Exact attention over a sequence-sharded ring.

    q, k, v: [B, H, C, Dh] local chunks (C = T / ring size). Returns the
    local [B, H, C, Dh] attention output in q's dtype."""
    ring = axis.size
    rank = axis.index
    chunk = q.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    dev = q.device
    q32 = q.float()
    row_pos = rank * chunk + torch.arange(chunk, device=dev)  # global row ids
    perm = ring_perm(ring)
    o_acc = q32 * 0.0
    m_acc = o_acc.sum(dim=-1, keepdim=True) - 1e30
    l_acc = o_acc.sum(dim=-1, keepdim=True)
    k_cur, v_cur = k, v
    for s in range(ring):
        src_rank = (rank - s) % ring  # owner of the visiting chunk
        col_pos = src_rank * chunk + torch.arange(chunk, device=dev)
        bias = None
        if causal:
            mask = row_pos[:, None] >= col_pos[None, :]
            bias = torch.where(mask, 0.0, NEG_INF)[None, None]
        o, m, l = _block_attn(q32, k_cur.float(), v_cur.float(), bias, scale)
        m_new = torch.maximum(m_acc, m)
        alpha = torch.exp(m_acc - m_new)
        beta = torch.exp(m - m_new)
        o_acc = o_acc * alpha + o * beta
        l_acc = l_acc * alpha + l * beta
        m_acc = m_new
        k_cur = ppermute(k_cur, axis, perm)
        v_cur = ppermute(v_cur, axis, perm)
    out = o_acc / torch.clamp(l_acc, min=1e-30)
    return out.to(q.dtype)


def full_attention(q, k, v, causal: bool = True, kv_len=None):
    """One-device reference attention (``ring_attention`` without the
    ring): float32 scores and softmax, masked at -1e30. ``kv_len``
    (optional scalar) masks key positions >= kv_len."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    t_q, t_k = q.shape[2], k.shape[2]
    dev = q.device
    if causal:
        mask = torch.arange(t_q, device=dev)[:, None] >= torch.arange(t_k, device=dev)[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
    if kv_len is not None:
        s = torch.where(torch.arange(t_k, device=dev)[None, None, None, :] < kv_len, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
