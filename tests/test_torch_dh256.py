"""Head dim 256 (the shape of llm-1.26b-dh256: llm-1.26b with Gemma-2B's
attention, 8 heads / 1 kv head) at a small size, on the CPU: a DecoderLM
with d_model 512, 2 heads and 1 kv head (Dh 256), 2 layers, held against
the JAX package's DecoderLM on the same weights (carried over with
convert.params_from_numpy) and the same numpy-seeded inputs; and the
prefill attention at Dh 256 against the JAX Pallas kernel in interpret
mode, as the JAX package's own tests run it.

Tolerances: max-abs <= 1e-4 on float32 logits and caches (both run the
same f32 math through two layers; the frameworks round matmuls and
transcendentals differently in the last bits), <= 1e-5 on the attention
output (f32 scores, softmax and weighted sum; only the summation order
differs). Token streams must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.llm import DecoderLM as JaxLM
from seldon_core_tpu.ops.flash_attention import flash_attention
from seldon_core_tpu_torch.convert import params_from_numpy
from seldon_core_tpu_torch.models.llm import DecoderLM as TorchLM
from seldon_core_tpu_torch.ops import flash_attention as tfa
from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

torch.set_num_threads(1)
TOL = 1e-4
ATTN_TOL = 1e-5

CFG = dict(vocab_size=256, d_model=512, n_layers=2, n_heads=2, n_kv_heads=1,
           d_ff=256, max_seq=64, dtype="float32")


@pytest.fixture(scope="module")
def pair():
    jm, tm = JaxLM(**CFG), TorchLM(**CFG)
    jp = jax.jit(jm.init_params)(0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _prompt(seed, b, t):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"], (b, t)).astype(np.int32)


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a) - b.detach().numpy()).max())


def test_head_dim_256_and_its_kernel_routes(pair):
    """Both packages derive Dh = d_model / n_heads = 256 from the config
    as it is; on the card the bf16 model runs the wgmma route's Dh 256
    instance, the f32 one the mma route, and both are admitted."""
    jm, _jp, tm, _tp = pair
    assert jm.cfg.head_dim == tm.cfg.head_dim == 256
    assert tfa.kernel_route(torch.bfloat16, 256) == "wgmma"
    assert tfa.kernel_route(torch.float32, 256) == "mma"
    TorchLM(**{**CFG, "dtype": "bfloat16"}).check_device("cuda")
    tm.check_device("cuda")


def test_prefill_logits_and_slab_match_jax(pair):
    jm, jp, tm, tp = pair
    prompt = _prompt(0, 2, 24)
    last = np.array([17, 23], np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, jnp.asarray(prompt), 48, last_index=jnp.asarray(last))
    tl, tc = tm.prefill(tp, torch.from_numpy(prompt), 48, last_index=torch.from_numpy(last))
    assert tc["k"].shape == tuple(jc["k"].shape) == (2, 2, 1, 48, 256)
    assert _maxdiff(jl, tl) <= TOL
    assert _maxdiff(jc["k"], tc["k"]) <= TOL
    assert _maxdiff(jc["v"], tc["v"]) <= TOL


def test_apply_matches_jax(pair):
    jm, jp, tm, tp = pair
    toks = _prompt(1, 2, 20)
    assert _maxdiff(jax.jit(jm.apply)(jp, jnp.asarray(toks)),
                    tm.apply(tp, torch.from_numpy(toks))) <= TOL


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 3)])
def test_generate_tokens_equal_jax(pair, temperature, seed):
    jm, jp, tm, tp = pair
    prompt = _prompt(2, 2, 6)
    gen = jax.jit(jm.generate, static_argnums=(2, 3, 4))
    want = np.asarray(gen(jp, jnp.asarray(prompt), 16, temperature, seed))
    got = tm.generate(tp, torch.from_numpy(prompt), 16,
                      temperature=temperature, seed=seed).numpy()
    np.testing.assert_array_equal(got, want)


def test_batcher_greedy_equals_jax_generate(pair):
    """Greedy requests of three prompt buckets, concurrent on two slots
    (more requests than lanes): every stream equals the JAX package's
    generate() and the port's, token for token."""
    jm, jp, tm, tp = pair
    prompts = [_prompt(3, 1, n)[0].tolist() for n in (5, 13, 30)]
    b = ContinuousBatcher(tm, tp, slots=2, max_seq=64, prefill_buckets=(8, 16, 32),
                          steps_per_poll=2)
    try:
        got = [f.result(timeout=300) for f in
               [b.submit(p, max_new_tokens=12) for p in prompts]]
    finally:
        b.close()
    gen = jax.jit(jm.generate, static_argnums=2)
    for p, g in zip(prompts, got):
        want = np.asarray(gen(jp, jnp.asarray([p], jnp.int32), 12))[0].tolist()
        assert g == want
        assert g == tm.generate(tp, torch.tensor([p]), 12)[0].tolist()


@pytest.mark.parametrize("causal", [True, False])
def test_pallas_kernel_at_dh256_equals_plain(causal):
    """The JAX package's Pallas kernel in interpret mode at Dh 256 (its
    third head dim), fed the kv head repeated as the JAX model does,
    against the port's plain version reading the grouped K/V in place."""
    rs = np.random.RandomState(4)
    q = rs.randn(1, 4, 256, 256).astype(np.float32)
    k = rs.randn(1, 1, 256, 256).astype(np.float32)
    v = rs.randn(1, 1, 256, 256).astype(np.float32)
    want = np.asarray(flash_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), 4, axis=1),
        jnp.repeat(jnp.asarray(v), 4, axis=1), causal=causal, interpret=True))
    got = tfa.attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal).numpy()
    assert np.abs(got - want).max() <= ATTN_TOL
