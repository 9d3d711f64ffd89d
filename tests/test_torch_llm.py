"""Port's DecoderLM (seldon_core_tpu_torch.models.llm) against the JAX
package's DecoderLM on the same weights (carried over with
convert.params_from_numpy) and the same inputs, on the CPU.

Tolerance: max-abs <= 1e-4 on float32 logits and caches — both run the
same f32 math through a few layers; the frameworks round matmul and
transcendental results differently in the last bits (~1e-6 observed).
Token streams must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.llm import DecoderLM as JaxLM
from seldon_core_tpu_torch import models as tmodels
from seldon_core_tpu_torch.convert import load_npz, params_from_numpy, save_npz
from seldon_core_tpu_torch.models.llm import DecoderLM as TorchLM

torch.set_num_threads(1)
TOL = 1e-4

CONFIGS = {
    # tests/test_generate_serving.py's CFG (head_dim 8, GQA 4:2)
    "small": dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                  d_ff=64, max_seq=64, dtype="float32"),
    # head_dim 64, GQA 2:1: the kernel's head width
    "dh64": dict(vocab_size=128, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
                 d_ff=128, max_seq=64, dtype="float32"),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    jm, tm = JaxLM(**cfg), TorchLM(**cfg)
    jp = jax.jit(jm.init_params)(0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _prompt(seed, b, t, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(np.int32)


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a) - b.detach().numpy()).max())


def test_prefill_logits_and_slab(pair):
    jm, jp, tm, tp = pair
    prompt = _prompt(0, 2, 16, jm.cfg.vocab_size)
    last = np.array([10, 15], np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, jnp.asarray(prompt), 32, last_index=jnp.asarray(last)
    )
    tl, tc = tm.prefill(tp, torch.from_numpy(prompt), 32, last_index=torch.from_numpy(last))
    assert tc["k"].shape == tuple(jc["k"].shape)  # [L, B, KV, max_seq, Dh]
    assert _maxdiff(jl, tl) <= TOL
    assert _maxdiff(jc["k"], tc["k"]) <= TOL
    assert _maxdiff(jc["v"], tc["v"]) <= TOL


def test_apply(pair):
    jm, jp, tm, tp = pair
    toks = _prompt(1, 2, 10, jm.cfg.vocab_size)
    want = jax.jit(jm.apply)(jp, jnp.asarray(toks))
    assert _maxdiff(want, tm.apply(tp, torch.from_numpy(toks))) <= TOL


def test_decode_step_ragged_list(pair):
    """Ragged positions, a bounded attention read, and one row whose write
    position lies past the cache: JAX drops that scatter, so must the
    port (and its attention still reads the whole cache)."""
    jm, jp, tm, tp = pair
    L, T = jm.cfg.n_layers, 32
    prompt = _prompt(2, 3, 16, jm.cfg.vocab_size)
    _, jc = jax.jit(jm.prefill, static_argnums=2)(jp, jnp.asarray(prompt), T)
    decode = jax.jit(jm.decode_step_ragged_list, static_argnames=("attn_len",))
    _, tc = tm.prefill(tp, torch.from_numpy(prompt), T)
    tok = _prompt(3, 3, 1, jm.cfg.vocab_size)
    for pos, attn_len in (([11, 16, 3], 32), ([5, 7, 9], 16), ([20, 31, 32], None)):
        pos = np.asarray(pos, np.int32)
        jks = [jc["k"][l] for l in range(L)]
        jvs = [jc["v"][l] for l in range(L)]
        tks = [tc["k"][l].clone() for l in range(L)]
        tvs = [tc["v"][l].clone() for l in range(L)]
        jl, jks, jvs = decode(
            jp, jks, jvs, jnp.asarray(tok), jnp.asarray(pos), attn_len=attn_len
        )
        tl, tks, tvs = tm.decode_step_ragged_list(
            tp, tks, tvs, torch.from_numpy(tok), torch.from_numpy(pos), attn_len=attn_len
        )
        assert _maxdiff(jl, tl) <= TOL
        for l in range(L):
            assert _maxdiff(jks[l], tks[l]) <= TOL
            assert _maxdiff(jvs[l], tvs[l]) <= TOL


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 3)])
def test_generate_tokens_equal(pair, temperature, seed):
    """32 generated steps, greedy and seeded (the port reproduces JAX's
    threefry key chain), as tests/test_llm.py drives generate."""
    jm, jp, tm, tp = pair
    prompt = _prompt(4, 2, 4, jm.cfg.vocab_size)
    gen = jax.jit(jm.generate, static_argnums=(2, 3, 4))
    want = np.asarray(gen(jp, jnp.asarray(prompt), 32, temperature, seed))
    got = tm.generate(tp, torch.from_numpy(prompt), 32,
                      temperature=temperature, seed=seed).numpy()
    assert got.shape == (2, 36)
    np.testing.assert_array_equal(got, want)


def test_counts_and_init_shapes(pair):
    jm, jp, tm, _tp = pair
    assert tm.n_params() == jm.n_params()
    assert tm.flops_per_token(100) == jm.flops_per_token(100)
    mine = tm.init_params(0, device="cpu")
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    flat_t = {}
    for name, leaf in mine.items():
        if isinstance(leaf, dict):
            flat_t.update({f"{name}/{k}": v for k, v in leaf.items()})
        else:
            flat_t[name] = leaf
    assert sorted(flat_t) == sorted(flat_j)
    for key, leaf in flat_t.items():
        assert tuple(leaf.shape) == tuple(flat_j[key].shape), key
        assert leaf.dtype == torch.float32
    assert sum(v.numel() for v in flat_t.values()) == tm.n_params()
    # same scales as the JAX init: the residual projections' std tracks
    # residual_scale / sqrt(fan-in)
    ratio = float(flat_t["blocks/wq"].std()) / float(np.std(flat_j["blocks/wq"]))
    assert 0.8 < ratio < 1.25


def test_npz_roundtrip(tmp_path, pair):
    _jm, jp, _tm, tp = pair
    save_npz(jax.tree.map(np.asarray, jp), str(tmp_path / "p.npz"))
    back = load_npz(str(tmp_path / "p.npz"), device="cpu")
    assert torch.equal(back["blocks"]["wq"], tp["blocks"]["wq"])
    bf = {"a": {"b": tp["embed"].to(torch.bfloat16)}}
    save_npz(bf, str(tmp_path / "bf.npz"))
    assert torch.equal(load_npz(str(tmp_path / "bf.npz"), device="cpu")["a"]["b"], bf["a"]["b"])


def test_registry_lists_llm_only():
    assert isinstance(tmodels.build("llm", **CONFIGS["small"]), TorchLM)
    with pytest.raises(NotImplementedError, match="'bert' is not ported"):
        tmodels.build("bert")
    with pytest.raises(ValueError, match="unknown model family"):
        tmodels.build("nope")
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        TorchLM(**{**CONFIGS["small"], "n_experts": 4})
