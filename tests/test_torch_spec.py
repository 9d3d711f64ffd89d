"""Speculative decoding in the port: ``DecoderLM.decode_chunk_ragged_list``
(the verify step), the per-lane draws a speculation round makes, and the
batcher's draft/verify rounds, held against the JAX package on the same
numpy-seeded weights at the tiny config of tests/test_torch_serving.py
on the CPU (float32), following tests/test_generate_serving.py and
tests/test_fused_decode.py.

The gates: greedy speculation emits the target's own greedy decode
(JAX ``DecoderLM.generate``), for any draft and composed with every
scheduler knob; a seeded stream with speculation on equals the JAX
batcher's stream with speculation on, on the same seed (the JAX batcher
runs each one on a fresh lane: its draft cache keeps what earlier
occupants left, the port's is cleared per request, see
``ContinuousBatcher._draft_admit_tokens``); the emitted distribution is
the target's. Logits and caches agree within 1e-5 (f32, summation order
only).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.llm import DecoderLM as JaxLM
from seldon_core_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from seldon_core_tpu_torch import rng
from seldon_core_tpu_torch.convert import params_from_numpy, save_npz
from seldon_core_tpu_torch.models.llm import DecoderLM as TorchLM
from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

from _torch_sched import CFG, EagerGraphs, make_models, port

TOL = 1e-5
# a draft that shares nothing with the target (other width, depth and
# seed; head dim 8): near-zero acceptance
DRAFT_CFG = dict(vocab_size=256, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1,
                 d_ff=32, max_seq=64, dtype="float32")
SMALL_CFG = dict(vocab_size=16, d_model=16, n_layers=1, n_heads=2, n_kv_heads=2,
                 d_ff=32, max_seq=16, dtype="float32")
MIXED_PROMPTS = [(3, 8), (40, 8), (5, 12), (35, 6), (9, 10), (28, 4)]


def _pair(cfg, seed):
    """(jax model, jax params, port model, port params) on one set of
    JAX-initialised weights."""
    jm, tm = JaxLM(**cfg), TorchLM(**cfg)
    jp = jax.jit(jm.init_params)(seed)
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def draft():
    return _pair(DRAFT_CFG, 99)


@pytest.fixture(scope="module")
def greedy_ref(models):
    """The JAX model's own greedy decode, memoised per (prompt, budget)."""
    jm, jp = models[0], models[1]
    memo = {}

    def ref(prompt, m):
        key = (tuple(prompt), m)
        if key not in memo:
            memo[key] = np.asarray(jm.generate(jp, jnp.asarray([prompt], jnp.int32), m))[0].tolist()
        return memo[key]

    return ref


def _spec(models, draft_pair, **kw):
    return port(models, draft_model=draft_pair[2], draft_params=draft_pair[3], **kw)


# -- the verify step -------------------------------------------------------------


@pytest.mark.parametrize("attn_len", [None, 48])
def test_decode_chunk_matches_jax(models, attn_len):
    """A window of W = 5 tokens at per-row start positions, one row's
    window running past the cache (those writes are dropped, as the JAX
    scatter drops them): logits and both caches within 1e-5."""
    jm, jp, tm, tp = models
    rs = np.random.RandomState(0)
    B, T, W = 3, 64, 5
    ks = [rs.randn(B, 2, T, 8).astype(np.float32) for _ in range(2)]
    vs = [rs.randn(B, 2, T, 8).astype(np.float32) for _ in range(2)]
    tokens = rs.randint(0, 256, (B, W))
    pos = np.array([3, 40, 61] if attn_len is None else [3, 40, 20])
    jl, jks, jvs = jm.decode_chunk_ragged_list(
        jp, [jnp.asarray(a) for a in ks], [jnp.asarray(a) for a in vs], jnp.asarray(tokens),
        jnp.asarray(pos), attn_len=attn_len)
    tks = [torch.from_numpy(a.copy()) for a in ks]
    tvs = [torch.from_numpy(a.copy()) for a in vs]
    tl, tks2, tvs2 = tm.decode_chunk_ragged_list(
        tp, tks, tvs, torch.from_numpy(tokens), torch.from_numpy(pos), attn_len=attn_len)
    assert tl.shape == (B, W, 256) and tl.dtype == torch.float32
    assert tks2[0] is tks[0]  # written in place
    assert np.abs(np.asarray(jl) - tl.numpy()).max() <= TOL
    for a, b in zip(jks + jvs, tks2 + tvs2):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= TOL


def test_decode_chunk_w1_equals_decode_step(models):
    """At W = 1 the verify step is the one-position decode step: the same
    logits and the same cache writes, bit for bit."""
    tm, tp = models[2], models[3]
    rs = np.random.RandomState(1)
    ks = [torch.from_numpy(rs.randn(4, 2, 64, 8).astype(np.float32)) for _ in range(2)]
    vs = [torch.from_numpy(rs.randn(4, 2, 64, 8).astype(np.float32)) for _ in range(2)]
    tok = torch.from_numpy(rs.randint(0, 256, (4, 1)))
    pos = torch.tensor([0, 7, 33, 63])
    a_ks, a_vs = [x.clone() for x in ks], [x.clone() for x in vs]
    b_ks, b_vs = [x.clone() for x in ks], [x.clone() for x in vs]
    a, _, _ = tm.decode_chunk_ragged_list(tp, a_ks, a_vs, tok, pos, attn_len=64)
    b, _, _ = tm.decode_step_ragged_list(tp, b_ks, b_vs, tok, pos, attn_len=64)
    assert torch.equal(a[:, 0], b)
    assert all(torch.equal(x, y) for x, y in zip(a_ks + a_vs, b_ks + b_vs))


# -- the draws of a round --------------------------------------------------------


def test_spec_round_draws_bit_exact_with_jax():
    """What spec_round draws per lane: ``vmap(split)`` of the lane keys,
    ``vmap(uniform(k, (gamma,)))``, and ``vmap(categorical)`` on scaled
    draft logits and on ``log(dist + 1e-30)`` of a residual: equal bits
    and equal tokens."""
    S, gamma, V = 16, 4, 64
    seeds = np.arange(S, dtype=np.int32) * 7 + 3
    jk = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    tk = rng.prng_key(torch.from_numpy(seeds.astype(np.int64)))
    rs = np.random.RandomState(4)
    for _ in range(6):
        js = jax.vmap(jax.random.split)(jk)
        ts = rng.split(tk)
        np.testing.assert_array_equal(np.asarray(js).astype(np.int64), ts.numpy())
        jk, jsub = js[:, 0], js[:, 1]
        tk, tsub = ts[:, 0], ts[:, 1]
        ju = jax.vmap(lambda k: jax.random.uniform(k, (gamma,)))(jsub)
        tu = rng.uniform(tsub, (gamma,))
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
        logits = (rs.randn(S, V) * 3).astype(np.float32)
        temps = rs.uniform(0.2, 1.5, (S, 1)).astype(np.float32)
        scaled = logits / np.maximum(temps, 1e-6)
        jc = jax.vmap(jax.random.categorical)(jsub, jnp.asarray(scaled))
        tc = rng.categorical_rows(tsub, torch.from_numpy(scaled))
        np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
        dist = np.maximum(rs.dirichlet(np.ones(V), S) - 0.01, 0).astype(np.float32)
        jr = jax.vmap(jax.random.categorical)(jsub, jnp.log(jnp.asarray(dist) + 1e-30))
        tr = rng.categorical_rows(tsub, torch.log(torch.from_numpy(dist) + 1e-30))
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())


# -- the batcher -------------------------------------------------------------------


def test_speculative_exact_with_bad_draft(models, draft, greedy_ref):
    """A draft that shares nothing with the target (head dim 8) still
    gives exactly the target's greedy decode, for every request of a
    churning batch."""
    b = _spec(models, draft, slots=3, prefill_buckets=(8, 16), pipeline_depth=3,
              speculate_tokens=3)
    try:
        rs = np.random.RandomState(3)
        prompts = [rs.randint(0, 256, n).tolist() for n in (3, 9, 5, 12, 4)]
        budgets = (7, 4, 10, 3, 8)
        futs = [b.submit(p, max_new_tokens=m) for p, m in zip(prompts, budgets)]
        for p, m, f in zip(prompts, budgets, futs):
            assert f.result(timeout=120) == greedy_ref(p, m)
        assert b.stats["spec_rounds"] > 0
    finally:
        b.close()


def test_speculative_self_draft_and_eos(models, greedy_ref):
    """Draft = target: most proposals accepted, and eos stops the output
    exactly where plain decode stops it."""
    b = port(models, slots=2, prefill_buckets=(8,), draft_model=models[2],
             draft_params=models[3], speculate_tokens=4)
    try:
        prompt = [3, 17, 42]
        full = b.generate(prompt, max_new_tokens=20)
        assert full == greedy_ref(prompt, 20)
        eos = full[len(prompt) + 3]
        assert b.generate(prompt, max_new_tokens=20, eos_id=eos) == full[: len(prompt) + 4]
        # far fewer target rounds than tokens
        assert b.stats["tokens"] > b.stats["steps"]
    finally:
        b.close()


def test_speculative_sampling_distribution_exact():
    """Stochastic speculation samples the target's distribution: the
    empirical distribution of the second generated token (the first the
    speculative path produces) matches the analytic target marginal
    within the JAX test's band (bin sd <= 0.014; 0.05 is ~4 sigma), with
    a draft that shares nothing with the target."""
    jm, jp, tm, tp = _pair(SMALL_CFG, 0)
    _jd, _jdp, td, tdp = _pair(dict(vocab_size=16, d_model=8, n_layers=1, n_heads=1,
                                    n_kv_heads=1, d_ff=16, max_seq=16, dtype="float32"), 123)
    prompt, T, V = [3, 5], 1.0, SMALL_CFG["vocab_size"]

    def probs_after(toks):
        lg = np.asarray(jm.apply(jp, jnp.asarray([toks], jnp.int32)))[0, -1]
        e = np.exp((lg - lg.max()) / T)
        return e / e.sum()

    p1 = probs_after(prompt)
    marginal = sum(p1[t1] * probs_after(prompt + [t1]) for t1 in range(V))
    b = ContinuousBatcher(tm, tp, slots=8, max_seq=16, prefill_buckets=(4,), steps_per_poll=1,
                          draft_model=td, draft_params=tdp, speculate_tokens=2)
    try:
        n = 1200
        futs = [b.submit(prompt, max_new_tokens=2, temperature=T, seed=s) for s in range(n)]
        second = np.array([f.result(timeout=300)[3] for f in futs])
    finally:
        b.close()
    emp = np.bincount(second, minlength=V) / n
    assert np.abs(emp - marginal).max() < 0.05, (emp, marginal)


def test_speculative_self_draft_accepts_everything_stochastic():
    """Draft = target at a temperature: p/q = 1, so a round emits close to
    gamma + 1 tokens (the JAX test's bound)."""
    _jm, _jp, tm, tp = _pair(SMALL_CFG, 0)
    b = ContinuousBatcher(tm, tp, slots=2, max_seq=16, prefill_buckets=(4,), steps_per_poll=2,
                          draft_model=tm, draft_params=tp, speculate_tokens=3)
    try:
        for s in range(4):
            b.generate([1, 2], max_new_tokens=8, temperature=0.9, seed=s)
        assert b.stats["spec_emitted"] / max(1, b.stats["spec_rounds"]) > 3.5
    finally:
        b.close()


def test_seeded_spec_streams_equal_jax(models, draft):
    """Seeded (and greedy) streams with speculation on equal the JAX
    batcher's with speculation on, on the same seeds: each JAX request on
    a fresh batcher, the port's all on one batcher, one at a time and
    then all together (a port stream depends on its request alone)."""
    reqs = [([3, 17, 42], 0.0, 0), ([3, 17, 42], 0.9, 4),
            ([1, 2, 3, 4, 5, 6, 7, 8, 9], 0.7, 11), ([5, 5], 1.0, 2)]
    knobs = dict(slots=2, max_seq=64, prefill_buckets=(8, 16), steps_per_poll=2,
                 speculate_tokens=3)
    b = _spec(models, draft, **knobs)
    try:
        alone = [b.generate(p, max_new_tokens=20, temperature=t, seed=s) for p, t, s in reqs]
        futs = [b.submit(p, max_new_tokens=20, temperature=t, seed=s) for p, t, s in reqs]
        assert [f.result(timeout=120) for f in futs] == alone
    finally:
        b.close()
    for (p, t, s), got in zip(reqs, alone):
        jb = JaxBatcher(models[0], models[1], draft_model=draft[0], draft_params=draft[1],
                        **knobs)
        try:
            assert jb.generate(p, max_new_tokens=20, temperature=t, seed=s) == got
        finally:
            jb.close()


def test_spec_on_equals_off_greedy(models, draft, greedy_ref):
    """Greedy: speculation on = off = the JAX package, a mixed batch of
    shallow and deep prompts submitted together."""
    rs = np.random.RandomState(17)
    prompts = [rs.randint(0, 256, n).tolist() for n, _ in MIXED_PROMPTS]
    outs = {}
    for name, kw in (("off", {}), ("on", dict(draft_model=draft[2], draft_params=draft[3],
                                               speculate_tokens=3))):
        b = port(models, **kw)
        try:
            futs = [b.submit(p, max_new_tokens=m) for p, (_n, m) in zip(prompts, MIXED_PROMPTS)]
            outs[name] = [f.result(timeout=120) for f in futs]
        finally:
            b.close()
    assert outs["on"] == outs["off"]
    for p, (_n, m), got in zip(prompts, MIXED_PROMPTS, outs["on"]):
        assert got == greedy_ref(p, m)


def test_spec_warm_then_serve(models, draft, greedy_ref):
    """warm() runs the single-request prefills, the draft prefill and the
    spec burst at every attention bucket, greedy-only and stochastic;
    serving afterwards is unchanged."""
    b = _spec(models, draft, speculate_tokens=3)
    b._graphs = graphs = EagerGraphs(b)
    try:
        b.warm(prompt_lens=(5, 20), max_new_tokens=8)
        spec = [key for key in graphs.graphs if key[0] == "spec"]
        assert {key[2] for key in spec} == {False, True}
        assert {key[1] for key in spec} == {b._attn_need(20 + 8)}
        assert b.generate([4, 5, 6], max_new_tokens=8) == greedy_ref([4, 5, 6], 8)
        assert b.stats["graph_captures_inline"] == 0
        assert graphs.stale == []
    finally:
        b.close()


def test_prefix_cache_with_speculation_exact(models, draft, greedy_ref):
    """Prefix hits compose with speculation: the target's prefix comes
    from the pool, the draft's is re-derived from the whole prompt."""
    b = _spec(models, draft, slots=2, prefill_buckets=(8, 16), speculate_tokens=3,
              prefix_cache_hbm_bytes=1 << 26, prefix_cache_min_tokens=4)
    try:
        rs = np.random.RandomState(2)
        shared = rs.randint(0, 256, 9).tolist()
        for tail_len in (3, 4, 2):
            p = shared + rs.randint(0, 256, tail_len).tolist()
            assert b.generate(p, max_new_tokens=6) == greedy_ref(p, 6)
        assert b.stats["prefix_hits"] >= 2
    finally:
        b.close()


def test_depth_knobs_with_speculation_exact(models, draft, greedy_ref):
    """Speculation composes with depth groups and chunked prefill: chunked
    prompts get the draft's whole-prompt prefill at activation, spec
    bursts stay whole-batch."""
    old = (ContinuousBatcher.MIN_ATTN_BUCKET, JaxBatcher.MIN_ATTN_BUCKET)
    ContinuousBatcher.MIN_ATTN_BUCKET = JaxBatcher.MIN_ATTN_BUCKET = 16
    try:
        rs = np.random.RandomState(17)
        prompts = [rs.randint(0, 256, n).tolist() for n, _ in MIXED_PROMPTS]
        b = _spec(models, draft, attn_bucket=16, speculate_tokens=3, depth_groups=4,
                  depth_group_split_bytes=0, prefill_chunk=16)
        try:
            futs = []
            for i, (p, (_n, m)) in enumerate(zip(prompts, MIXED_PROMPTS)):
                futs.append(b.submit(p, max_new_tokens=m))
                if i % 2:
                    time.sleep(0.03)  # stagger so depths mix
            out = [f.result(timeout=120) for f in futs]
            stats = dict(b.stats)
        finally:
            b.close()
    finally:
        ContinuousBatcher.MIN_ATTN_BUCKET, JaxBatcher.MIN_ATTN_BUCKET = old
    for p, (_n, m), got in zip(prompts, MIXED_PROMPTS, out):
        assert got == greedy_ref(p, m)
    assert stats["prefill_chunks"] > 0
    assert stats["group_bursts"] == 0  # spec bursts stay whole-batch


def test_fused_degrades_under_speculation(models, draft, greedy_ref):
    """With a draft configured the fused plan stands down: spec bursts run
    and the output is the target's greedy decode."""
    b = _spec(models, draft, fused_steps_per_dispatch=16, speculate_tokens=3)
    try:
        p = [3, 17, 42, 99, 7]
        assert b.generate(p, max_new_tokens=10) == greedy_ref(p, 10)
        assert b.stats["spec_rounds"] > 0
        assert b.stats["fused_dispatches"] == 0
    finally:
        b.close()


def test_spec_admits_one_request_at_a_time(models, draft):
    """Speculation admits singly (a draft prefix is a per-request prefill):
    a wave of four same-bucket prompts is four prefills, not one m=4."""
    b = _spec(models, draft, speculate_tokens=3)
    try:
        futs = [b.submit([i + 1, 2, 3], max_new_tokens=3) for i in range(4)]
        [f.result(timeout=120) for f in futs]
        assert b.stats["prefill_steps"] == 4
    finally:
        b.close()


# -- the server ----------------------------------------------------------------------


def _model_dir(path, cfg, seed):
    """A model directory of the JAX package's weights (``init_params(seed)``)
    as the port's npz checkpoint."""
    path.mkdir()
    jm = JaxLM(**cfg)
    save_npz(jax.tree.map(np.asarray, jax.jit(jm.init_params)(seed)), str(path / "params.npz"))
    (path / "jax_config.json").write_text(
        json.dumps({"family": "llm", "config": cfg, "checkpoint": "params.npz"}))
    return str(path)


def test_generateserver_self_draft_speculation(tmp_path, greedy_ref):
    """``draft_layers`` builds the early-exit self-draft (its blocks are
    views of the served model's, its embed/unembed/norm the same
    tensors); the served output equals the plain server's and the JAX
    model's, and the tokens-per-round gauge ships."""
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    d = _model_dir(tmp_path / "llm", CFG, 0)
    plain = GenerateServer(model_uri=d, device="cpu", slots=2, steps_per_poll=2)
    spec = GenerateServer(model_uri=d, device="cpu", slots=2, steps_per_poll=2,
                          speculate_tokens=3, draft_layers=1)
    try:
        body = {"prompt_tokens": [[5, 17, 42]], "max_new_tokens": 8}
        out_plain = plain.predict(dict(body), [])
        out_spec = spec.predict(dict(body), [])
        assert out_plain["tokens"] == out_spec["tokens"] == [greedy_ref([5, 17, 42], 8)]
        b = spec.batcher
        assert b.speculate_tokens == 3 and b.draft_model.cfg.n_layers == 1
        dp, tp = b._draft_params, b.params
        assert dp["embed"] is tp["embed"] and dp["unembed"] is tp["unembed"]
        assert dp["blocks"]["wq"].shape[0] == 1
        assert dp["blocks"]["wq"].data_ptr() == tp["blocks"]["wq"].data_ptr()  # a view
        gauges = {m["key"]: m["value"] for m in spec.metrics() if m["type"] == "GAUGE"}
        assert 1.0 <= gauges["gen_spec_tokens_per_round"] <= 4.0
    finally:
        plain.close()
        spec.close()


def test_generateserver_draft_uri(tmp_path, greedy_ref):
    """``draft_uri`` loads a separate draft (head dim 8, its own weights)
    through the same loader as the served model; greedy output is the
    target's."""
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    d = _model_dir(tmp_path / "llm", CFG, 0)
    dd = _model_dir(tmp_path / "draft", DRAFT_CFG, 99)
    spec = GenerateServer(model_uri=d, device="cpu", slots=2, steps_per_poll=2,
                          speculate_tokens=2, draft_uri=dd)
    try:
        out = spec.predict({"prompt_tokens": [[9, 8, 7, 6], [1, 2]], "max_new_tokens": 9}, [])
        assert out["tokens"] == [greedy_ref([9, 8, 7, 6], 9), greedy_ref([1, 2], 9)]
        assert spec.batcher.draft_model.cfg.head_dim == 8
        assert spec.batcher.stats["spec_rounds"] > 0
    finally:
        spec.close()


def test_generateserver_speculation_refusals(tmp_path):
    """speculate_tokens needs a draft; the self-draft must be shallower
    than the model; speculation with features not ported yet still
    raises, as those features do."""
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    d = _model_dir(tmp_path / "llm", CFG, 0)
    with pytest.raises(ValueError, match="needs draft_layers or draft_uri"):
        GenerateServer(model_uri=d, device="cpu", speculate_tokens=3).load()
    with pytest.raises(ValueError, match="must be < the served model's n_layers"):
        GenerateServer(model_uri=d, device="cpu", speculate_tokens=3, draft_layers=2).load()
    # resume tokens assume the plain decode's key chain: refused with a
    # draft, as the JAX server refuses them; a swap is refused at request
    # time (the early-exit draft shares the served tensors)
    with pytest.raises(ValueError, match="resume_tokens"):
        GenerateServer(model_uri=d, device="cpu", speculate_tokens=3, draft_layers=1,
                       resume_tokens=1)
    srv = GenerateServer(model_uri=d, device="cpu", speculate_tokens=3, draft_layers=1,
                         swap_drain_ms=100)
    srv.load()
    try:
        with pytest.raises(RuntimeError, match="speculative"):
            srv.hot_swap(d)
        with pytest.raises(RuntimeError, match="speculative"):
            srv.batcher.request_weight_swap(TorchLM(**CFG).init_params(1, device="cpu"))
    finally:
        srv.close()
    with pytest.raises(ValueError, match="draft_params"):
        ContinuousBatcher(TorchLM(**CFG), TorchLM(**CFG).init_params(0, device="cpu"),
                          draft_model=TorchLM(**DRAFT_CFG))
