"""The flash kernel's mma route (float32 at every head dim, bfloat16 at a
head dim off a multiple of 8), checked on the CPU where the kernel cannot
run: the route table, the block-rows choice, the copy width picked from
the views' alignment, the input checks, and the numerics argument of
3xTF32 — a numpy emulation of the kernel's float32 arithmetic held
against the port's plain attention and the JAX package's Pallas kernel
in interpret mode.

Tolerance: 5e-5 max-abs, the float32 tolerance the on-card smoke run
holds the kernel to. The emulation rounds each operand to TF32 as
``cvt.rna.tf32.f32`` does (10 mantissa bits, to nearest, ties away from
zero), splits it into hi + lo, and sums hi.hi + hi.lo + lo.hi in
float32: it lands within ~1e-6 of the plain version. One-pass TF32
(hi.hi alone) misses by ~1e-3, which is why the kernel does not use it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.ops.flash_attention import flash_attention
from seldon_core_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)
TOL = 5e-5
H100_SMS = 132
LOG2E = 1.4426950408889634


# (a) the route table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mma_route_table(dtype):
    """float32 takes the mma route at every head dim 1-256; bfloat16 takes
    it at every head dim off a multiple of 8 and the wgmma route at the
    multiples of 8."""
    for dh in range(1, tfa.MAX_HEAD_DIM + 1):
        wgmma = dtype == torch.bfloat16 and dh % 8 == 0
        assert tfa.kernel_route(dtype, dh) == ("wgmma" if wgmma else "mma"), dh


# (b) the block-rows choice


@pytest.mark.parametrize("b,h,t,want", [
    (1, 8, 512, 32),     # f32 Dh 256 of the kernels phase: 128 blocks of 32 rows
    (1, 16, 1024, 32),   # llm-1.26b-f32's prefill: 512 blocks of 32 rows
    (2, 16, 1024, 64),   # two of them: 512 blocks of 64 rows
    (8, 16, 512, 64),    # an 8-slot batched admission at bucket 512
    (8, 16, 1024, 64),   # and at 1024
    (2, 4, 256, 32),     # the small f32 model (Dh 64)
    (1, 2, 128, 32),     # S1's Dh 8 draft
    (2, 8, 300, 32),     # f32 Dh 32
    (1, 4, 130, 32),     # ragged T
    (1, 4, 512, 32),     # bf16 Dh 12
    (1, 4, 256, 32),     # bf16 Dh 7
    (8, 4, 1024, 64),    # bf16 Dh 12 at 8 x 1024: 512 blocks of 64 rows
])
def test_mma_block_rows_fill_the_card(b, h, t, want):
    """Four warps a block either way: 64 rows (each warp 16 rows over
    every key) once the grid is three waves of the H100's 132 SMs, else
    32 rows with the keys split between two warps a row group, so that a
    small grid has twice the blocks (at least one full wave wherever
    (B, H, T) allow it at 32 rows)."""
    bm = tfa.choose_mma_block_m(b, h, t, H100_SMS)
    assert bm == want
    blocks = b * h * -(-t // bm)
    assert blocks >= 3 * H100_SMS if bm == 64 else b * h * -(-t // 64) < 3 * H100_SMS
    assert blocks >= H100_SMS or b * h * -(-t // 32) < H100_SMS


# (d) the input checks and the copy width


def _views(dtype, b, t, h, dh, extra=0, offset=0):
    """q-like views as DecoderLM.prefill makes them: head-transposed
    [B, T, H*Dh] projections, with `extra` elements after each row of T
    and the base `offset` elements into its allocation."""
    flat = torch.zeros(offset + b * t * (h * dh + extra), dtype=dtype)
    x = flat[offset:].view(b, t, h * dh + extra)[:, :, : h * dh]
    return x.unflatten(2, (h, dh)).transpose(1, 2)


@pytest.mark.parametrize("dtype,dh,extra,offset,width", [
    (torch.float32, 64, 0, 0, 16),   # the serving path's views: 16-byte copies
    (torch.float32, 128, 1, 0, 4),   # T stride off a multiple of 4 elements
    (torch.float32, 64, 0, 1, 4),    # base one element off
    (torch.float32, 8, 2, 0, 8),     # T stride 2 elements off: 8-byte copies
    (torch.float32, 3, 0, 0, 4),     # a row of 12 bytes
    (torch.bfloat16, 12, 0, 0, 8),   # 24-byte rows
    (torch.bfloat16, 7, 0, 0, 2),    # rows 2 bytes apart: plain 2-byte loads
    (torch.bfloat16, 12, 1, 0, 2),   # odd T stride
    (torch.bfloat16, 20, 0, 2, 4),   # base 4 bytes off
])
def test_mma_route_takes_any_stride_and_picks_its_copy_width(dtype, dh, extra, offset, width):
    q = _views(dtype, 2, 33, 4, dh, extra, offset)
    k = _views(dtype, 2, 33, 2, dh, extra, offset)
    assert tfa.kernel_route(dtype, dh) == "mma"
    tfa.check_kernel_inputs(q, k, k)
    tfa.check_kernel_inputs(q, k, k, kv_len=20)
    assert tfa.copy_bytes(q, k, k) == width
    es = q.element_size()
    for t_ in (q, k):  # every copy of `width` bytes starts aligned
        assert t_.data_ptr() % width == 0 and (dh * es) % width == 0
        assert all((t_.stride(d) * es) % width == 0 for d in range(3))


@pytest.mark.parametrize("dh", [8, 64, 128, 256])
def test_wgmma_route_still_refuses_tma_illegal_views(dh):
    """The same layouts at a bfloat16 multiple of 8 go to the wgmma route,
    whose TMA loads refuse a misaligned base or stride (no copy is made,
    no other route taken); at float32 they pass on the mma route."""
    assert tfa.kernel_route(torch.bfloat16, dh) == "wgmma"
    odd_t = _views(torch.bfloat16, 1, 16, 2, dh, extra=4)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        tfa.check_kernel_inputs(odd_t, odd_t, odd_t)
    odd_base = _views(torch.bfloat16, 1, 16, 2, dh, offset=1)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.check_kernel_inputs(odd_base, odd_base, odd_base)
    for x in (_views(torch.float32, 1, 16, 2, dh, extra=1),
              _views(torch.float32, 1, 16, 2, dh, offset=1)):
        tfa.check_kernel_inputs(x, x, x)
        assert tfa.copy_bytes(x, x, x) == 4


# (c) the numerics of 3xTF32, emulated


def _tf32(x):
    """x (float32) rounded to TF32 as cvt.rna.tf32.f32 does: 10 mantissa
    bits, to nearest, ties away from zero (on the sign-magnitude bits,
    adding half of the dropped 13 bits rounds the magnitude)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul(a, b, passes):
    """a @ b in float32 from TF32 operands: 3 passes are hi.hi + (hi.lo +
    lo.hi), the small terms in their own float32 sum as the kernel keeps
    them; 1 pass is hi.hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    big = ah @ bh
    if passes == 1:
        return big
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return big + (al @ bh + ah @ bl)


def _emulate(q, k, v, kv_len=None, passes=3, block_n=32):
    """The mma kernel's float32 arithmetic in numpy, causal: key tiles of
    `block_n`, S from TF32 products over Dh rounded up to 8 (zero
    columns), the raw-score row max, one FFMA per score folding
    1/sqrt(Dh) * log2(e), exp2, the rescale by alpha, and P.V from TF32
    products with the keys of every k8 step taken in the kernel's order
    (2t, 2t + 1: 0 2 4 6 1 3 5 7); masked scores are -1e30."""
    b, h, t_q, dh = q.shape
    kvh, t_k = k.shape[1], k.shape[2]
    rep = h // kvh
    width = -(-dh // 8) * 8
    pad = [(0, 0)] * 3 + [(0, width - dh)]
    q, k, v = (np.pad(x, pad).astype(np.float32) for x in (q, k, v))
    limit = t_k if kv_len is None else min(kv_len, t_k)
    scale_log2 = np.float32(LOG2E / np.sqrt(dh))
    perm = np.array([0, 2, 4, 6, 1, 3, 5, 7])
    out = np.zeros((b, h, t_q, width), np.float32)
    rows = np.arange(t_q)[:, None]
    for bi in range(b):
        for hi in range(h):
            qh, kh, vh = q[bi, hi], k[bi, hi // rep], v[bi, hi // rep]
            m = np.full((t_q, 1), -1e30, np.float32)
            l = np.zeros((t_q, 1), np.float32)
            acc = np.zeros((t_q, width), np.float32)
            for n0 in range(0, min(limit, t_q), block_n):
                cols = n0 + np.arange(block_n)
                kt = np.zeros((block_n, width), np.float32)
                vt = np.zeros((block_n, width), np.float32)
                live = cols < limit
                kt[live], vt[live] = kh[cols[live]], vh[cols[live]]
                s = _matmul(qh, kt.T, passes)
                s = np.where((cols[None, :] < limit) & (cols[None, :] <= rows), s,
                             np.float32(-1e30))
                m_new = np.maximum(m, s.max(axis=1, keepdims=True))
                alpha = np.exp2((m - m_new) * scale_log2)
                p = np.exp2(s * scale_log2 - m_new * scale_log2).astype(np.float32)
                l = l * alpha + p.sum(axis=1, keepdims=True)
                order = (np.arange(0, block_n, 8)[:, None] + perm[None, :]).ravel()
                acc = acc * alpha + _matmul(p[:, order], vt[order], passes)
                m = m_new
            out[bi, hi] = acc / l
    return out[..., :dh]


def _qkv(seed, b, h, kv, t, dh):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, n, t, dh).astype(np.float32) for n in (h, kv, kv))


def _plain(q, k, v, kv_len=None):
    return tfa.attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                               kv_len=kv_len, causal=True).numpy()


@pytest.mark.parametrize("dh,t,kv_len", [
    (8, 130, None), (8, 130, 100),
    (64, 130, None), (64, 97, 60),
    (128, 130, 100),
    (256, 130, None), (256, 70, 50),
])
def test_3xtf32_emulation_holds_float32_tolerance_one_pass_does_not(dh, t, kv_len):
    """Ragged T (off the 32-key tile) and a key-length mask included: the
    3xTF32 emulation stays within 5e-5 of the plain version; one-pass
    TF32 on the same inputs does not."""
    q, k, v = _qkv(dh + t, 1, 4, 2, t, dh)
    ref = _plain(q, k, v, kv_len)
    three = _emulate(q, k, v, kv_len, passes=3, block_n=64 if dh <= 64 else 32)
    one = _emulate(q, k, v, kv_len, passes=1, block_n=64 if dh <= 64 else 32)
    assert np.abs(three - ref).max() <= TOL
    assert np.abs(one - ref).max() > TOL


@pytest.mark.parametrize("dh", [64, 128, 256])
def test_3xtf32_emulation_matches_the_pallas_kernel(dh):
    """Where the shape tiles the JAX kernel's blocks (T = 128), the
    emulation agrees with the Pallas kernel in interpret mode, as the JAX
    package's own tests run it."""
    q, k, v = _qkv(dh, 1, 2, 2, 128, dh)
    jax_out = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, interpret=True))
    three = _emulate(q, k, v, block_n=64 if dh <= 64 else 32)
    assert np.abs(three - jax_out).max() <= TOL


def test_tf32_rounding_is_to_nearest_ties_away():
    """The emulated cvt.rna: 1 + 2^-11 (half an ulp of TF32 at 1) rounds
    away to 1 + 2^-10, just below it rounds down, negatives mirror, and
    the remainder of a split is exact."""
    ulp = 2.0 ** -10
    x = np.array([1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23, -(1 + ulp / 2), 3.0], np.float32)
    assert _tf32(x).tolist() == [1 + ulp, 1.0, -(1 + ulp), 3.0]
    y = np.random.RandomState(0).randn(1000).astype(np.float32)
    hi = _tf32(y)
    lo = _tf32(y - hi)
    assert np.abs((hi.astype(np.float64) + lo) - y).max() <= 2.0 ** -21 * np.abs(y).max()
