"""Mixture-of-experts DecoderLM in the port (``parallel/moe.py`` and the
MoE branch of ``models/llm.py``) against the JAX package on the same
weights and numpy-seeded inputs, on the CPU at float32.

Routing is held exactly: the expert of every row and whether it was kept
under the capacity must equal JAX's, and each fixture's smallest margin
between a row's top-1 and top-2 router probabilities is printed in the
assertion message (a tie at float32 noise would be reported, not dodged).
Outputs then agree to 1e-5 (moe_ffn) and 1e-4 (whole forwards, the
tolerance of tests/test_torch_llm.py), and token streams are equal.

The capacity counts every row of a call, so under MoE a request's tokens
depend on what shares its batch, in both packages. The batcher gates are
therefore single requests against ``DecoderLM.generate`` and greedy
whole batches against the JAX batcher on the same rows: every request is
queued before either loop starts, with ``pipeline_depth`` 1, so both
loops admit and read bursts at the same polls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.llm import DecoderLM as JaxLM
from seldon_core_tpu.parallel import moe as jax_moe
from seldon_core_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from seldon_core_tpu_torch import models as tmodels
from seldon_core_tpu_torch.convert import load_npz, params_from_numpy, save_npz
from seldon_core_tpu_torch.models import llm as llm_mod
from seldon_core_tpu_torch.models.llm import DecoderLM as TorchLM
from seldon_core_tpu_torch.parallel.moe import moe_ffn, route
from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher, MoEKnobRefused

torch.set_num_threads(1)
FFN_TOL = 1e-5
TOL = 1e-4

CFG = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
           max_seq=64, n_experts=4, dtype="float32")
BASE = dict(slots=4, max_seq=64, prefill_buckets=(8, 16, 32), steps_per_poll=2,
            pipeline_depth=1)


def jax_routing(x, router_w, capacity_factor):
    """The routing of ``seldon_core_tpu/parallel/moe.py`` (lines 48-66),
    step for step in jax.numpy: expert index, kept mask, capacity."""
    N = x.shape[0]
    E = router_w.shape[1]
    probs = jax.nn.softmax((x @ router_w).astype(jnp.float32), axis=-1)
    idx = jnp.argmax(probs, axis=-1)
    one_hot = jax.nn.one_hot(idx, E, dtype=jnp.float32)
    capacity = max(1, int(capacity_factor * N / E))
    pos_in_expert = (jnp.cumsum(one_hot, axis=0) - 1.0) * one_hot
    keep = (pos_in_expert < capacity) & (one_hot > 0)
    return np.asarray(idx), np.asarray(jnp.any(keep, axis=-1)), capacity, np.asarray(probs)


def margin(probs) -> float:
    top2 = np.sort(np.asarray(probs), axis=-1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def assert_same_routing(jx, tx, router_w, cf, what):
    """JAX's and the port's routing of their own inputs to one layer."""
    j_idx, j_kept, j_cap, j_probs = jax_routing(jnp.asarray(jx), jnp.asarray(router_w), cf)
    r = route(torch.from_numpy(np.array(tx)), torch.from_numpy(np.array(router_w)), cf)
    msg = f"{what}: smallest top-1/top-2 router margin {margin(j_probs):.3e}"
    assert r.capacity == j_cap, msg
    assert np.array_equal(r.expert_idx.numpy(), j_idx), msg
    assert np.array_equal(r.kept.numpy(), j_kept), msg
    return r


@pytest.fixture(scope="module")
def pair():
    jm, tm = JaxLM(**CFG), TorchLM(**CFG)
    jp = jax.jit(jm.init_params)(0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


# -- the layer ------------------------------------------------------------------------


@pytest.mark.parametrize("n,e,cf", [(8, 4, 1.25), (37, 8, 1.0), (64, 4, 2.0), (5, 8, 1.25),
                                    (96, 4, 0.5), (1, 4, 1.25)])
def test_moe_ffn_equals_jax(n, e, cf):
    """Routing, drops, aux loss and outputs of the layer, overflow included
    (capacity factor 0.5 and 1.0 drop rows; one row alone is kept)."""
    rs = np.random.RandomState(n * 10 + e)
    D, F = 16, 24
    x = rs.randn(n, D).astype(np.float32)
    rw = rs.randn(D, e).astype(np.float32)
    w1 = (rs.randn(e, D, F) / 4).astype(np.float32)
    w2 = (rs.randn(e, F, D) / 5).astype(np.float32)
    r = assert_same_routing(x, x, rw, cf, f"N={n} E={e} cf={cf}")
    if cf < 1.0:
        assert not bool(r.kept.all())  # overflow drops rows
    j_out, j_aux = jax.jit(jax_moe.moe_ffn, static_argnums=(4, 5))(x, rw, w1, w2, None, cf)
    t_out, t_aux = moe_ffn(*map(torch.from_numpy, (x, rw, w1, w2)), cf)
    assert abs(float(j_aux) - float(t_aux)) <= FFN_TOL
    assert float(np.abs(np.asarray(j_out) - t_out.numpy()).max()) <= FFN_TOL
    # a dropped row's FFN output is 0
    assert torch.all(t_out[~r.kept] == 0)


# -- the model ------------------------------------------------------------------------


class _Recorder:
    """The inputs of every MoE layer call of one forward, per package."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        j_orig, t_orig = jax_moe.moe_ffn, llm_mod.moe_ffn

        def j_rec(x, router_w, *a, **kw):
            self.jax.append((np.asarray(x), np.asarray(router_w)))
            return j_orig(x, router_w, *a, **kw)

        def t_rec(x, router_w, *a, **kw):
            self.port.append((x.detach().numpy().copy(), router_w.detach().numpy().copy()))
            return t_orig(x, router_w, *a, **kw)

        monkeypatch.setattr(jax_moe, "moe_ffn", j_rec)
        monkeypatch.setattr(llm_mod, "moe_ffn", t_rec)

    def check(self, what):
        assert len(self.jax) == len(self.port) == CFG["n_layers"]
        for layer, ((jx, jw), (tx, _tw)) in enumerate(zip(self.jax, self.port)):
            assert jx.shape == tx.shape
            assert_same_routing(jx, tx, jw, 1.25, f"{what} layer {layer}")
        self.jax.clear()
        self.port.clear()


def _prompt(seed, b, t):
    return np.random.RandomState(seed).randint(0, CFG["vocab_size"], (b, t)).astype(np.int32)


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a) - b.detach().numpy()).max())


def test_init_params_shapes_and_registry(pair):
    """The registry builds the MoE model (the refusal of earlier slices is
    gone) and its init has the JAX package's leaves and shapes."""
    jm, jp, _tm, _tp = pair
    built = tmodels.build("llm", **CFG)
    assert isinstance(built, TorchLM) and built.cfg.n_experts == 4
    mine = built.init_params(0, device="cpu")
    want = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda a: tuple(a.shape), mine) == want
    assert set(mine["blocks"]) >= {"router", "w1e", "w2e"}
    assert not set(mine["blocks"]) & {"w1", "w2", "w3"}


def test_apply_equals_jax(pair, monkeypatch):
    jm, jp, tm, tp = pair
    prompt = _prompt(1, 2, 12)
    rec = _Recorder(monkeypatch)
    with jax.disable_jit():
        want = jm.apply(jp, jnp.asarray(prompt))
    got = tm.apply(tp, torch.from_numpy(prompt))
    rec.check("apply")
    assert _maxdiff(want, got) <= TOL


def test_prefill_equals_jax(pair, monkeypatch):
    jm, jp, tm, tp = pair
    prompt = _prompt(2, 3, 16)
    last = np.array([15, 4, 9], np.int32)
    rec = _Recorder(monkeypatch)
    with jax.disable_jit():
        jl, jc = jm.prefill(jp, jnp.asarray(prompt), 32, last_index=jnp.asarray(last))
    tl, tc = tm.prefill(tp, torch.from_numpy(prompt), 32, last_index=torch.from_numpy(last))
    rec.check("prefill")
    assert _maxdiff(jl, tl) <= TOL
    for name in ("k", "v"):
        assert _maxdiff(jc[name], tc[name]) <= TOL


def _caches(jm, jp, tm, tp, b, t, seed):
    prompt = _prompt(seed, b, t)
    _jl, jc = jax.jit(jm.prefill, static_argnums=2)(jp, jnp.asarray(prompt), 32)
    j_ks = [jc["k"][l] for l in range(CFG["n_layers"])]
    j_vs = [jc["v"][l] for l in range(CFG["n_layers"])]
    t_ks = [torch.from_numpy(np.array(a)) for a in j_ks]
    t_vs = [torch.from_numpy(np.array(a)) for a in j_vs]
    return j_ks, j_vs, t_ks, t_vs


def test_decode_step_ragged_list_equals_jax(pair, monkeypatch):
    jm, jp, tm, tp = pair
    j_ks, j_vs, t_ks, t_vs = _caches(*pair, 4, 10, 3)
    toks = np.array([[7], [3], [200], [41]], np.int32)
    pos = np.array([10, 4, 7, 9], np.int32)
    rec = _Recorder(monkeypatch)
    with jax.disable_jit():
        jl, j_ks, j_vs = jm.decode_step_ragged_list(jp, j_ks, j_vs, jnp.asarray(toks),
                                                    jnp.asarray(pos), attn_len=16)
    tl, t_ks, t_vs = tm.decode_step_ragged_list(tp, t_ks, t_vs, torch.from_numpy(toks),
                                                torch.from_numpy(pos), attn_len=16)
    rec.check("decode_step_ragged_list")
    assert _maxdiff(jl, tl) <= TOL
    for a, b in zip(j_ks + j_vs, t_ks + t_vs):
        assert _maxdiff(a, b) <= TOL


def test_decode_chunk_ragged_list_equals_jax(pair, monkeypatch):
    jm, jp, tm, tp = pair
    j_ks, j_vs, t_ks, t_vs = _caches(*pair, 3, 10, 4)
    toks = _prompt(5, 3, 4)
    pos = np.array([10, 3, 6], np.int32)
    rec = _Recorder(monkeypatch)
    with jax.disable_jit():
        jl, j_ks, j_vs = jm.decode_chunk_ragged_list(jp, j_ks, j_vs, jnp.asarray(toks),
                                                     jnp.asarray(pos), attn_len=16)
    tl, t_ks, t_vs = tm.decode_chunk_ragged_list(tp, t_ks, t_vs, torch.from_numpy(toks),
                                                 torch.from_numpy(pos), attn_len=16)
    rec.check("decode_chunk_ragged_list")
    assert _maxdiff(jl, tl) <= TOL
    for a, b in zip(j_ks + j_vs, t_ks + t_vs):
        assert _maxdiff(a, b) <= TOL


def test_prefill_chunk_and_prefix_equal_jax(pair, monkeypatch):
    jm, jp, tm, tp = pair
    _jl, jc = jax.jit(jm.prefill, static_argnums=2)(jp, jnp.asarray(_prompt(6, 1, 8)), 16)
    tc = {n: torch.from_numpy(np.array(jc[n])) for n in ("k", "v")}
    chunk = _prompt(7, 1, 4)
    rec = _Recorder(monkeypatch)
    with jax.disable_jit():
        jl, jc2 = jm.prefill_chunk(jp, jc, jnp.asarray(chunk), 8, 16,
                                   last_index=jnp.asarray([2]))
    tl, tc2 = tm.prefill_chunk(tp, tc, torch.from_numpy(chunk), 8, 16,
                               last_index=torch.tensor([2]))
    rec.check("prefill_chunk")
    assert _maxdiff(jl, tl) <= TOL
    assert _maxdiff(jc2["k"], tc2["k"]) <= TOL
    suffix = _prompt(8, 1, 8)
    with jax.disable_jit():
        jl, js = jm.prefill_with_prefix(jp, jc2, jnp.asarray(suffix), 5,
                                        last_index=jnp.asarray([6]))
    tl, ts = tm.prefill_with_prefix(tp, tc2, torch.from_numpy(suffix), 5,
                                    last_index=torch.tensor([6]))
    rec.check("prefill_with_prefix")
    assert _maxdiff(jl, tl) <= TOL
    assert _maxdiff(js["v"], ts["v"]) <= TOL


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.9, 5)])
def test_generate_equals_jax(pair, temperature, seed):
    jm, jp, tm, tp = pair
    prompt = _prompt(9, 2, 6)
    want = np.asarray(jm.generate(jp, jnp.asarray(prompt), 10, temperature=temperature,
                                  seed=seed))
    got = tm.generate(tp, torch.from_numpy(prompt), 10, temperature=temperature, seed=seed)
    assert got.tolist() == want.tolist()


def test_weights_carry_through_npz(tmp_path, pair):
    _jm, jp, _tm, tp = pair
    save_npz(jax.tree.map(np.asarray, jp), str(tmp_path / "p.npz"))
    back = load_npz(str(tmp_path / "p.npz"), device="cpu")
    for name in ("router", "w1e", "w2e"):
        assert torch.equal(back["blocks"][name], tp["blocks"][name])


def test_params_swappable_compares_the_experts(pair):
    _jm, _jp, tm, tp = pair
    ok, why = tm.params_swappable(tp, tm.init_params(1, device="cpu"))
    assert ok, why
    other = TorchLM(**{**CFG, "n_experts": 2}).init_params(0, device="cpu")
    ok, why = tm.params_swappable(tp, other)
    assert not ok and "['blocks']['router']" in why
    dense = TorchLM(**{**CFG, "n_experts": 0}).init_params(0, device="cpu")
    ok, why = tm.params_swappable(tp, dense)
    assert not ok and "structure" in why


@pytest.mark.parametrize("experts", [0, 4])
def test_analytic_counts_equal_jax(experts):
    cfg = {**CFG, "n_experts": experts}
    jm, tm = JaxLM(**cfg), TorchLM(**cfg)
    assert tm.n_params() == jm.n_params()
    leaves = jax.tree.leaves(jax.eval_shape(jm.init_params, 0))
    assert tm.n_params() == sum(int(np.prod(a.shape)) for a in leaves)
    for t in (None, 16, 1024):
        assert tm.flops_per_row(t) == jm.flops_per_row(t)
        assert tm.flops_per_token(t or 7) == jm.flops_per_token(t or 7)
    for ctx, b, pb in ((0, 1, 2), (100.5, 8, 2), (512, 3, 4)):
        assert tm.decode_bytes_per_token(ctx, b, pb) == jm.decode_bytes_per_token(ctx, b, pb)


def test_batcher_prices_the_experts(pair):
    """The ledger's parameter bytes are the live tree's, which under MoE
    hold every expert: the closed form times the dtype's size."""
    _jm, _jp, tm, tp = pair
    b = ContinuousBatcher(tm, tp, **BASE)
    try:
        assert b._param_bytes == tm.n_params() * 4
    finally:
        b.close()


# -- the batcher ----------------------------------------------------------------------


def _queued(b, requests):
    """Every request submitted before ``b``'s loop starts (its ``start``
    held back), so that the first poll sees all of them."""
    b.start = lambda: None
    try:
        futs = [b.submit(p, **kw) for p, kw in requests]
    finally:
        del b.start
    b.start()
    return [f.result(timeout=300) for f in futs]


@pytest.mark.parametrize("n,temperature,seed", [(8, 0.0, 0), (16, 0.0, 0), (8, 0.9, 3),
                                                (16, 1.0, 11)])
def test_single_request_equals_jax(pair, n, temperature, seed):
    """One request alone through the port batcher: greedy equals JAX's and
    the port's ``generate``, and greedy or seeded equals the JAX batcher
    serving it alone (a batcher samples its first token from a split of
    ``PRNGKey(seed)``, ``generate`` from the key itself, in both
    packages). The prompt fills its prefill bucket, so the batcher's
    prefill runs the rows ``generate``'s does (a shorter prompt adds pad
    rows to the experts' capacity), and the lane decodes in row 0, ahead
    of every parked row in the experts' buffers."""
    jm, jp, tm, tp = pair
    prompt = _prompt(20 + n, 1, n)
    kw = dict(max_new_tokens=9, temperature=temperature, seed=seed)
    jb, tb = JaxBatcher(jm, jp, **BASE), ContinuousBatcher(tm, tp, **BASE)
    try:
        want = jb.generate(prompt[0].tolist(), **kw)
        got = tb.generate(prompt[0].tolist(), **kw)
    finally:
        jb.close()
        tb.close()
    assert got == want
    if temperature == 0.0:
        ref = np.asarray(jm.generate(jp, jnp.asarray(prompt), 9))[0].tolist()
        assert tm.generate(tp, torch.from_numpy(prompt), 9)[0].tolist() == ref == got


# six requests over four lanes: staggered budgets free lanes at different
# polls, so parked rows sit before live ones and later admissions land
# among them; prompts 5 and 6 share a prefix with prompts 1 and 2
_RS = np.random.RandomState(31)
_P = [_RS.randint(0, CFG["vocab_size"], n).tolist() for n in (11, 3, 20, 6, 9, 7)]
_P[4] = _P[0][:8] + [17]
_P[5] = _P[2][:16] + [5, 9]
WHOLE = [(p, dict(max_new_tokens=m)) for p, m in zip(_P, (7, 12, 5, 9, 6, 8))]

KNOBS = {
    "default": {},
    "fused": dict(fused_steps_per_dispatch=8),
    "groups": dict(attn_bucket=16, depth_groups=4, depth_group_split_bytes=0),
    "groups_fused": dict(attn_bucket=16, depth_groups=4, depth_group_split_bytes=0,
                         fused_steps_per_dispatch=8),
    "chunked": dict(prefill_chunk=8),
    "prefix": dict(prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=4),
}


@pytest.fixture
def _sub_tile_attn_buckets():
    old = (ContinuousBatcher.MIN_ATTN_BUCKET, JaxBatcher.MIN_ATTN_BUCKET)
    ContinuousBatcher.MIN_ATTN_BUCKET = JaxBatcher.MIN_ATTN_BUCKET = 16
    yield
    ContinuousBatcher.MIN_ATTN_BUCKET, JaxBatcher.MIN_ATTN_BUCKET = old


@pytest.mark.parametrize("name", sorted(KNOBS))
def test_whole_batch_equals_jax_batcher(pair, name, _sub_tile_attn_buckets):
    """A greedy batch queued whole gives the JAX batcher's tokens under
    each knob the port keeps for MoE: the same rows reach the experts in
    every prefill, chunk, suffix prefill, decode step and depth group."""
    jm, jp, tm, tp = pair
    knobs = {**BASE, **KNOBS[name]}
    jb, tb = JaxBatcher(jm, jp, **knobs), ContinuousBatcher(tm, tp, **knobs)
    try:
        want = _queued(jb, WHOLE)
        got = _queued(tb, WHOLE)
        j_stats, t_stats = dict(jb.stats), dict(tb.stats)
    finally:
        jb.close()
        tb.close()
    assert got == want
    for key in ("admitted", "prefill_steps", "prefill_chunks", "prefix_hits", "group_bursts"):
        assert t_stats.get(key) == j_stats.get(key), key
    if name == "prefix":
        assert t_stats["prefix_hits"] >= 1
    if name.startswith("groups"):
        assert t_stats["group_bursts"] > 0
    if name == "chunked":
        assert t_stats["prefill_chunks"] > 0


# four prompts of the 8-token bucket in the first wave share one batched
# prefill (m = 4); two more arrive as lanes free
_B = [_RS.randint(0, CFG["vocab_size"], n).tolist() for n in (5, 8, 3, 7, 12, 6)]
BATCHED = [(p, dict(max_new_tokens=m)) for p, m in zip(_B, (6, 10, 4, 8, 5, 7))]


def test_batched_prefill_equals_jax_batcher(pair):
    """An m = 4 batched prefill runs the JAX package's rows: four prompts
    right-padded to one bucket, the pad rows in the experts' capacity."""
    jm, jp, tm, tp = pair
    jb, tb = JaxBatcher(jm, jp, **BASE), ContinuousBatcher(tm, tp, **BASE)
    try:
        want = _queued(jb, BATCHED)
        got = _queued(tb, BATCHED)
        steps = tb.stats["prefill_steps"]
    finally:
        jb.close()
        tb.close()
    assert got == want
    assert steps < len(BATCHED)  # four admissions shared one prefill


def test_preemption_whole_batch_equals_jax_batcher(pair):
    """The same mid-run ledger shrink through both packages' fault hooks:
    lanes are preempted and resume (a prompt recompute, then the lane's
    replay alone) where the JAX batcher's do, with its tokens."""
    from seldon_core_tpu.resilience.faults import FaultInjector as JaxInjector
    from seldon_core_tpu_torch.resilience import FaultInjector

    jm, jp, tm, tp = pair
    knobs = {**BASE, "hbm_ledger_bytes": 1 << 40}
    jb, tb = JaxBatcher(jm, jp, **knobs), ContinuousBatcher(tm, tp, **knobs)
    try:
        shrink = int(1.3 * tb._attn_need(tb.max_seq) * tb._kv_key_bytes)
        cfg = {"shrink_to_bytes": shrink, "after_polls": 3, "restore_after_polls": 8}
        jb.pressure_hook = JaxInjector([], pressure=cfg).pressure_hook()
        tb.pressure_hook = FaultInjector([], pressure=cfg).pressure_hook()
        want = _queued(jb, WHOLE)
        got = _queued(tb, WHOLE)
        j_stats, t_stats = dict(jb.stats), dict(tb.stats)
    finally:
        jb.close()
        tb.close()
    assert got == want
    assert t_stats["preemptions"] == j_stats["preemptions"] > 0
    assert t_stats["preempt_resumes"] == t_stats["preemptions"]
    assert t_stats["replayed_tokens"] > 0


def test_export_prefill_equals_jax(pair):
    """Disaggregation's prefill half under MoE: the exported slab and
    first token are the JAX package's (one prompt at its bucket, as
    both export it)."""
    jm, jp, tm, tp = pair
    jb, tb = JaxBatcher(jm, jp, **BASE), ContinuousBatcher(tm, tp, **BASE)
    try:
        prompt = _P[0]
        j_meta, j_slab = jb.export_prefill(prompt, max_new_tokens=4)
        t_meta, t_slab = tb.export_prefill(prompt, max_new_tokens=4)
    finally:
        jb.close()
        tb.close()
    assert t_meta["first_token"] == j_meta["first_token"]
    assert t_meta["bucket"] == j_meta["bucket"]
    for name in ("k", "v"):
        assert _maxdiff(j_slab[name], t_slab[name]) <= TOL


def test_replay_runs_the_lane_alone_as_jax(pair):
    """A resume's teacher-forced replay under MoE runs the lane alone, one
    row per step, as the JAX package's ``replay_burst``: over the same
    cache it writes the same K/V. (Run over the whole batch, the parked
    rows ahead of the lane would take the experts' capacity.)"""
    jm, jp, tm, tp = pair
    jb, tb = JaxBatcher(jm, jp, **BASE), ContinuousBatcher(tm, tp, **BASE)
    try:
        rs = np.random.RandomState(5)
        shape = tuple(tb._cache["k"][0].shape)
        fill_of = {}
        for name in ("k", "v"):
            fill = [rs.randn(*shape).astype(np.float32) for _ in range(CFG["n_layers"])]
            fill_of[name] = fill
            jb._cache[name] = [jnp.asarray(a) for a in fill]
            for layer, a in zip(tb._cache[name], fill):
                layer.copy_(torch.from_numpy(a))
        toks = [int(t) for t in rs.randint(0, CFG["vocab_size"], 5)]
        jb._replay_emitted(2, 9, toks)
        tb._replay_emitted(2, 9, toks)
        end = 9 + len(toks)
        for name in ("k", "v"):
            for j_layer, t_layer, old in zip(jb._cache[name], tb._cache[name], fill_of[name]):
                j_layer = np.array(j_layer)
                # JAX pads its last chunk of k=2 with a token-0 step that
                # writes the lane's next position, which that lane's next
                # decode step overwrites before any read; the port has no pad
                assert not np.allclose(j_layer[2, :, end], t_layer[2, :, end].numpy())
                j_layer[2, :, end] = t_layer[2, :, end].numpy()
                assert _maxdiff(j_layer, t_layer) <= TOL
                assert not np.allclose(j_layer[2, :, 9:end], old[2, :, 9:end])
        assert tb.stats["replayed_tokens"] == len(toks)
        assert tb.stats["graphs_captured"] == 0
    finally:
        jb.close()
        tb.close()


def test_speculation_is_refused_under_moe(pair, tmp_path):
    import json

    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    _jm, _jp, tm, tp = pair
    dense = TorchLM(**{**CFG, "n_experts": 0})
    dense_p = dense.init_params(0, device="cpu")
    for target, tparams, draft, dparams in ((tm, tp, dense, dense_p), (dense, dense_p, tm, tp)):
        with pytest.raises(MoEKnobRefused, match="mixture-of-experts"):
            ContinuousBatcher(target, tparams, draft_model=draft, draft_params=dparams,
                              speculate_tokens=2, **BASE)
    (tmp_path / "jax_config.json").write_text(json.dumps({"family": "llm", "config": CFG}))
    server = GenerateServer(model_uri=str(tmp_path), device="cpu", slots=2,
                            speculate_tokens=2, draft_layers=1)
    with pytest.raises(MoEKnobRefused):
        server.load()


# -- the servers ----------------------------------------------------------------------


def _moe_dir(root, jp):
    import json

    save_npz(jax.tree.map(np.asarray, jp), str(root / "params.npz"))
    (root / "jax_config.json").write_text(json.dumps(
        {"family": "llm", "config": CFG, "checkpoint": "params.npz"}))
    return str(root)


def test_generateserver_serves_an_moe_dir(pair, tmp_path):
    """An MoE ``jax_config.json`` with the JAX package's weights serves
    greedy tokens through GenerateServer equal to JAX's ``generate`` (a
    prompt that fills the 32-token bucket)."""
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    jm, jp, _tm, _tp = pair
    server = GenerateServer(model_uri=_moe_dir(tmp_path, jp), device="cpu", slots=2,
                            steps_per_poll=4)
    prompt = _prompt(40, 1, 32)
    try:
        server.load()
        out = server.predict({"prompt_tokens": prompt.tolist(), "max_new_tokens": 6}, [])
    finally:
        server.close()
    assert out["tokens"] == np.asarray(jm.generate(jp, jnp.asarray(prompt), 6)).tolist()


def test_torchserver_predict_applies_the_moe_model(pair, tmp_path):
    """The same directory through TorchServer's REST predict: the logits
    of ``apply`` equal JAX's."""
    import asyncio
    import json

    from seldon_core_tpu_torch import microservice, wrapper
    from seldon_core_tpu_torch.http_server import Request

    jm, jp, _tm, _tp = pair
    user = microservice.build_user_object(
        "seldon_core_tpu_torch.servers.torchserver.TorchServer", json.dumps([
            {"name": "model_uri", "value": _moe_dir(tmp_path, jp), "type": "STRING"},
            {"name": "device", "value": "cpu", "type": "STRING"}]))
    user.load()
    tokens = _prompt(41, 2, 10)
    app = wrapper.get_rest_microservice(user)
    body = json.dumps({"data": {"ndarray": tokens.tolist()}}).encode()
    resp = asyncio.run(app._dispatch(Request(
        "POST", "/predict", "", {"content-type": "application/json"}, body)))
    assert resp.status == 200
    got = np.asarray(json.loads(resp.body)["data"]["ndarray"], np.float32)
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(tokens)))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL
