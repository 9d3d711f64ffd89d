"""Port's prefill attention (seldon_core_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernel and its einsum reference.

On the CPU the port's ``attention()`` runs its plain PyTorch version; the
JAX kernel runs in interpret mode, as the JAX package's own tests run it.
Tolerance: max-abs <= 1e-5 in float32 — both sides compute f32 scores,
an f32 softmax and an f32 weighted sum, so they differ only in summation
order (~1e-7 relative at these lengths).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.ops.flash_attention import _xla_attention, flash_attention
from seldon_core_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)
TOL = 1e-5


def _qkv(seed, b, h, t_q, t_k, dh, kv=None):
    rs = np.random.RandomState(seed)
    kv = h if kv is None else kv
    q = rs.randn(b, h, t_q, dh).astype(np.float32)
    k = rs.randn(b, kv, t_k, dh).astype(np.float32)
    v = rs.randn(b, kv, t_k, dh).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize(
    "b,h,t_q,t_k,dh,causal",
    [
        (2, 4, 256, 256, 64, True),
        (1, 2, 128, 256, 64, False),  # cross-length, non-causal
        (2, 2, 256, 256, 128, True),
        (1, 1, 384, 384, 64, True),  # 3 blocks, diagonal not block-aligned^2
        (1, 1, 128, 128, 64, True),  # single block
    ],
)
def test_plain_matches_jax_kernel_and_reference(b, h, t_q, t_k, dh, causal):
    q, k, v = _qkv(0, b, h, t_q, t_k, dh)
    got = tfa.attention(*_t(q, k, v), causal=causal).numpy()
    kernel = np.asarray(flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True
    ))
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    assert np.abs(got - kernel).max() <= TOL
    assert np.abs(got - ref).max() <= TOL


def test_plain_matches_jax_kernel_block_sizes():
    q, k, v = _qkv(1, 1, 2, 512, 512, 64)
    got = tfa.attention(*_t(q, k, v), causal=True).numpy()
    for bq, bk in ((128, 128), (256, 256), (512, 512), (128, 256)):
        kernel = np.asarray(flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            block_q=bq, block_k=bk, interpret=True,
        ))
        assert np.abs(got - kernel).max() <= TOL, (bq, bk)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_length_with_kv_len(causal):
    """A prompt length no block divides, with a key-length mask: the CUDA
    kernel masks both itself, so the plain version must agree with the
    JAX reference here too."""
    q, k, v = _qkv(2, 1, 2, 130, 130, 64)
    got = tfa.attention(*_t(q, k, v), kv_len=100, causal=causal).numpy()
    ref = np.asarray(_xla_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, kv_len=100
    ))
    assert np.abs(got - ref).max() <= TOL


def test_untileable_shapes_non_causal():
    q, k, v = _qkv(3, 2, 2, 17, 23, 32)
    got = tfa.attention(*_t(q, k, v), causal=False).numpy()
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False))
    assert np.abs(got - ref).max() <= TOL


@pytest.mark.parametrize("h,kv", [(4, 2), (16, 8), (4, 1)])
def test_grouped_kv_matches_repeated(h, kv):
    """Grouped K/V (q head h reads kv head h // (H / KV)) equals the JAX
    path, which repeats the kv heads before attention."""
    q, k, v = _qkv(4, 2, h, 64, 64, 16, kv=kv)
    got = tfa.attention(*_t(q, k, v), causal=True).numpy()
    rep = h // kv
    ref = np.asarray(_xla_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=1),
        jnp.repeat(jnp.asarray(v), rep, axis=1), causal=True,
    ))
    assert np.abs(got - ref).max() <= TOL


def test_strided_views_match_contiguous():
    """prefill hands attention head-transposed views; the result must not
    depend on the layout."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(2, 40, 4, 16).astype(np.float32))
    view = x.transpose(1, 2)
    a = tfa.attention(view, view, view, causal=True)
    b = tfa.attention(view.contiguous(), view.contiguous(), view.contiguous(), causal=True)
    assert torch.equal(a, b)


def test_cpu_tensors_never_touch_the_kernel():
    before = dict(tfa.LAUNCHES)
    q, k, v = _t(*_qkv(6, 1, 2, 64, 64, 64))
    tfa.attention(q, k, v, causal=True)
    tfa.attention(q, k, v, kv_len=10, causal=False)
    assert tfa.LAUNCHES == before
    # the kernel wrapper refuses CPU tensors instead of launching
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_cuda(q, k, v)
    assert tfa.LAUNCHES == before


def test_rejects_bad_inputs():
    q, k, v = _t(*_qkv(7, 1, 3, 8, 8, 16, kv=2))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.attention(q, k, v)
    q, k, v = _t(*_qkv(7, 1, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="kv_len"):
        tfa.attention(q, k, v, kv_len=0)


# ---------------------------------------------------------------------------
# The CUDA kernel's input contract, checked on CPU tensors (no card needed)
# ---------------------------------------------------------------------------


def _prefill_views(b, h, kv, t, dh, dtype=torch.bfloat16):
    """q/k/v as DecoderLM.prefill hands them over: head-transposed views
    of [B, T, heads * Dh] projections."""
    q = torch.zeros(b, t, h * dh, dtype=dtype).view(b, t, h, dh).transpose(1, 2)
    k = torch.zeros(b, t, kv * dh, dtype=dtype).view(b, t, kv, dh).transpose(1, 2)
    v = torch.zeros(b, t, kv * dh, dtype=dtype).view(b, t, kv, dh).transpose(1, 2)
    return q, k, v


@pytest.mark.parametrize("b,t,dh", [(1, 32, 128), (1, 1024, 128), (8, 512, 128), (2, 200, 64),
                                    (1, 1, 64)])
def test_kernel_check_accepts_main_path_views(b, t, dh):
    q, k, v = _prefill_views(b, 16, 8, t, dh)
    tfa.check_kernel_inputs(q, k, v)
    tfa.check_kernel_inputs(q, k, v, kv_len=t)


def test_kernel_check_rejects_misaligned_base():
    flat = torch.zeros(4 + 1 * 64 * 2 * 64, dtype=torch.bfloat16)
    x = flat[4:].view(1, 64, 2, 64).transpose(1, 2)  # base 8 bytes past 16-byte alignment
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.check_kernel_inputs(x, x, x)


def test_kernel_check_rejects_stride_off_16_bytes():
    # rows of 2 * 64 + 4 bf16: a T stride of 264 bytes, base aligned
    x = torch.zeros(1, 64, 2 * 64 + 4, dtype=torch.bfloat16)[:, :, : 2 * 64]
    x = x.unflatten(2, (2, 64)).transpose(1, 2)
    assert x.stride(2) * 2 == 264
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        tfa.check_kernel_inputs(x, x, x)


def test_kernel_check_rejects_other_head_dims_and_dtypes():
    q, k, v = _prefill_views(1, 4, 2, 16, 320)
    with pytest.raises(ValueError, match="head dims 1..256"):
        tfa.check_kernel_inputs(q, k, v)
    q, k, v = _prefill_views(1, 4, 2, 16, 64, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        tfa.check_kernel_inputs(q, k, v)
    q, k, v = _prefill_views(1, 4, 2, 16, 64)
    with pytest.raises(ValueError, match="q is torch.bfloat16"):
        tfa.check_kernel_inputs(q, k.float(), v)
    with pytest.raises(ValueError, match="contiguous in its head dim"):  # d strided
        tfa.check_kernel_inputs(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.check_kernel_inputs(q, *(_prefill_views(1, 4, 3, 16, 64)[1:]))


@pytest.mark.parametrize("dh", [8, 12, 16, 32, 96, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_check_accepts_every_head_dim_up_to_256(dh, dtype):
    """Every head dim up to 256 goes to the kernel: bfloat16 at a multiple
    of 8 to the wgmma route, which loads through TMA (a base one element
    off 16-byte alignment raises), everything else to the mma route,
    which takes any stride."""
    q, k, v = _prefill_views(2, 4, 2, 33, dh, dtype)
    tfa.check_kernel_inputs(q, k, v)
    tfa.check_kernel_inputs(q, k, v, kv_len=20)
    tma = dtype == torch.bfloat16 and dh % 8 == 0
    assert tfa.kernel_route(dtype, dh) == ("wgmma" if tma else "mma")
    flat = torch.zeros(1 + 33 * 4 * dh, dtype=dtype)  # base one element off
    x = flat[1:].view(1, 33, 4, dh).transpose(1, 2)
    if tma:
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfa.check_kernel_inputs(x, x, x)
    else:
        tfa.check_kernel_inputs(x, x, x)


def test_kernel_route():
    assert tfa.kernel_route(torch.bfloat16, 64) == "wgmma"
    assert tfa.kernel_route(torch.bfloat16, 128) == "wgmma"
    assert tfa.kernel_route(torch.float32, 128) == "mma"
    assert tfa.kernel_route(torch.bfloat16, 256) == "wgmma"
    assert tfa.kernel_route(torch.bfloat16, 8) == "wgmma"
    assert tfa.kernel_route(torch.bfloat16, 12) == "mma"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_route_every_head_dim(dtype):
    """The route follows from dtype and head dim alone, before any launch:
    bfloat16 at a multiple of 8 up to 256 takes the wgmma route (on the
    instance of width 64, 128 or 256 next up), every other head dim up to
    256 and float32 at all of them the mma route."""
    for dh in range(1, tfa.MAX_HEAD_DIM + 1):
        want = "wgmma" if dtype == torch.bfloat16 and dh % 8 == 0 else "mma"
        assert tfa.kernel_route(dtype, dh) == want, dh
    assert tfa._WGMMA_HEAD_DIMS[-1] == tfa.MAX_HEAD_DIM


@pytest.mark.parametrize("dh", [8, 32, 200, 256])
def test_kernel_check_accepts_prefill_views_of_the_model(dh):
    """q/k/v exactly as DecoderLM.prefill hands them to attention() (RoPE'd
    q/k, head-transposed v) at narrow, padded and wide head dims: the
    wgmma route's TMA contract holds for all three, so a bf16 model at
    these head dims prefills on the tensor cores."""
    from seldon_core_tpu_torch.models import llm as llm_mod

    model = llm_mod.DecoderLM(vocab_size=64, d_model=2 * dh, n_layers=1, n_heads=2,
                              n_kv_heads=1, d_ff=32, max_seq=32, dtype="bfloat16")
    params = model.init_params(0, device="cpu")
    params = {key: ({n: w.to(torch.bfloat16) for n, w in val.items()}
                    if isinstance(val, dict) else val.to(torch.bfloat16))
              for key, val in params.items()}
    seen = []

    def record(q, k, v, kv_len=None, causal=True):
        seen.append((q, k, v))
        return tfa.attention_plain(q, k, v, kv_len=kv_len, causal=causal)

    saved = llm_mod.prefill_attention
    llm_mod.prefill_attention = record
    try:
        model.prefill(params, torch.tensor([[1, 2, 3, 4, 5, 6, 7]]), 16)
    finally:
        llm_mod.prefill_attention = saved
    assert len(seen) == 1
    q, k, v = seen[0]
    assert q.shape == (1, 2, 7, dh) and k.shape == v.shape == (1, 1, 7, dh)
    assert tfa.kernel_route(q.dtype, dh) == "wgmma"
    tfa.check_kernel_inputs(q, k, v)


@pytest.mark.parametrize("dh", [8, 32, 200, 256])
def test_kernel_check_rejects_tma_illegal_strides_on_the_wgmma_route(dh):
    """A bf16 view whose T stride is 4 elements (8 bytes) off a multiple
    of 16 bytes raises on the wgmma route, naming the cause: no copy is
    made and no other route is taken. At a head dim off the multiple of 8
    the same layout is the mma route's, which reads any stride."""
    x = torch.zeros(1, 16, 2 * dh + 4, dtype=torch.bfloat16)[:, :, : 2 * dh]
    x = x.unflatten(2, (2, dh)).transpose(1, 2)
    assert (x.stride(2) * 2) % 16 == 8
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        tfa.check_kernel_inputs(x, x, x)
    y = torch.zeros(1, 16, 2 * (dh - 1) + 4, dtype=torch.bfloat16)[:, :, : 2 * (dh - 1)]
    y = y.unflatten(2, (2, dh - 1)).transpose(1, 2)
    assert tfa.kernel_route(y.dtype, dh - 1) == "mma"
    tfa.check_kernel_inputs(y, y, y)


@pytest.mark.parametrize("dh,dtype,cause", [
    (320, "bfloat16", "head dims 1..256"), (512, "float32", "head dims 1..256"),
    (64, "float16", "float32/bfloat16"),
])
def test_model_the_kernel_cannot_serve_is_refused_when_built(dh, dtype, cause):
    """A DecoderLM whose prefill the card cannot run raises, naming the
    cause, when it is built for CUDA (checked here with the config check
    and on meta tensors of its prefill shape: no card needed)."""
    from seldon_core_tpu_torch.models.llm import DecoderLM

    model = DecoderLM(vocab_size=64, d_model=2 * dh, n_layers=1, n_heads=2, n_kv_heads=1,
                      d_ff=32, max_seq=32, dtype=dtype)
    with pytest.raises(ValueError, match=cause):
        model.check_device("cuda")
    q = torch.empty((1, 2, 16, dh), dtype=model.dtype, device="meta")
    kv = torch.empty((1, 1, 16, dh), dtype=model.dtype, device="meta")
    with pytest.raises(ValueError, match=cause):
        tfa.check_kernel_inputs(q, kv, kv)
    model.check_device("cpu")  # the CPU runs the plain version: nothing to refuse
    ok = DecoderLM(vocab_size=64, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1,
                   d_ff=32, max_seq=32, dtype="float32")
    ok.check_device("cuda")  # head dim 8 at float32: the mma route takes it


@pytest.mark.parametrize("dh", [8, 16, 32, 256])
def test_plain_matches_jax_at_small_and_wide_head_dims(dh):
    """The head dims the mma route serves (the JAX package runs them
    through XLA; 256 also through its Pallas kernel, here in interpret
    mode), ragged T and a key-length mask included."""
    q, k, v = _qkv(9, 2, 4, 130, 130, dh, kv=2)
    rep = 2
    jk = jnp.repeat(jnp.asarray(k), rep, axis=1)
    jv = jnp.repeat(jnp.asarray(v), rep, axis=1)
    for kv_len in (None, 100):
        got = tfa.attention(*_t(q, k, v), kv_len=kv_len, causal=True).numpy()
        ref = np.asarray(_xla_attention(jnp.asarray(q), jk, jv, causal=True, kv_len=kv_len))
        assert np.abs(got - ref).max() <= TOL
    if dh == 256:
        q, k, v = _qkv(10, 1, 2, 256, 256, dh)
        got = tfa.attention(*_t(q, k, v), causal=True).numpy()
        kernel = np.asarray(flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, interpret=True))
        assert np.abs(got - kernel).max() <= TOL


def _odd_views(dtype):
    """q/k/v views whose base is one element past an aligned allocation and
    whose T stride is 2 * 64 + 1 elements."""
    flat = torch.zeros(1 + 64 * (2 * 64 + 1), dtype=dtype)
    x = flat[1:].view(64, 2 * 64 + 1)[:, : 2 * 64].unflatten(1, (2, 64))
    return x.unsqueeze(0).transpose(1, 2)


def test_kernel_check_float32_needs_no_tma_alignment():
    """The float32 kernel reads through plain loads: an odd base or stride
    is fine there, only the bfloat16 (TMA) kernel refuses it."""
    x = _odd_views(torch.float32)
    tfa.check_kernel_inputs(x, x, x)
    y = _odd_views(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned|multiple of 16 bytes"):
        tfa.check_kernel_inputs(y, y, y)


@pytest.mark.parametrize("b,h,t,sms,want", [
    (1, 16, 32, 132, 64),     # 16 blocks of 128 rows: too few for the card
    (1, 16, 1024, 132, 64),   # 128 blocks of 128 rows < 132 SMs
    (4, 16, 128, 132, 64),
    (8, 16, 512, 132, 128),   # 256 blocks of 128 rows
    (8, 16, 1024, 132, 128),
    (1, 16, 1024, 128, 128),  # a card with 128 SMs is filled at 128 rows
])
def test_choose_block_m(b, h, t, sms, want):
    assert tfa.choose_block_m(b, h, t, sms) == want
