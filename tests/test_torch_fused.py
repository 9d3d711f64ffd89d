"""Fused stop-aware decode in the port (``fused_steps_per_dispatch``)
against the port with it off and against the JAX batcher with the same
knob, on the CPU at the tiny config of tests/test_torch_serving.py.

One dispatch runs up to K decode steps with on-device stop detection and
per-lane done masks; tokens must equal the step-at-a-time path's, greedy
and seeded, with a stop at any step of a burst. Float32 logits and the
parked cache are held against JAX at 1e-5 (the frameworks round matmuls
differently in the last bits, ~1e-6 observed).
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.graph.engine_metrics import MetricsRegistry as JaxRegistry
from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
from seldon_core_tpu_torch.servers.generateserver import GenerateServer
from seldon_core_tpu_torch.serving.continuous import _StepGraphs

from _torch_sched import CFG, PROMPTS, JaxReference, batch, make_models, port, run_port

TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def jax_ref(models):
    ref = JaxReference(models)
    yield ref
    ref.close()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_fused_equals_off_and_jax(models, jax_ref, temperature):
    reqs = batch(temperature)
    off, _ = run_port(models, reqs)
    on, stats = run_port(models, reqs, fused_steps_per_dispatch=16)
    assert on == off
    assert on == jax_ref(reqs, fused_steps_per_dispatch=16)
    assert stats["fused_dispatches"] > 0
    # the point of it: more device steps than host dispatches
    assert stats["fused_steps"] > stats["fused_dispatches"]


@pytest.mark.parametrize("step", range(9))
def test_eos_at_every_burst_position(models, jax_ref, step):
    """K = 8: the prefill's token (step 0, caught by the done0 check) and
    each of the burst's 8 steps. The stream stops exactly there, as the
    step-at-a-time path and the JAX fused batcher stop it."""
    p = PROMPTS[0]
    full = jax_ref([(p, dict(max_new_tokens=16))])[0]
    eos = full[len(p) + step]
    want = full[: full.index(eos, len(p)) + 1]
    b = port(models, fused_steps_per_dispatch=8)
    try:
        got = b.generate(p, max_new_tokens=16, eos_id=eos)
    finally:
        b.close()
    assert got == want
    assert got == jax_ref([(p, dict(max_new_tokens=16, eos_id=eos))],
                          fused_steps_per_dispatch=8)[0]


@pytest.mark.parametrize("steps_per_poll", [2, 4])
def test_k_shrinks_to_stop_budget_never_below_poll(models, steps_per_poll):
    b = port(models, slots=2, fused_steps_per_dispatch=16, steps_per_poll=steps_per_poll)
    b.trace_groups = []
    try:
        b.generate(PROMPTS[0], max_new_tokens=20)
    finally:
        b.close()
    ks = [t["k"] for t in b.trace_groups]
    assert max(ks) == 16 and min(ks) < 16
    for k in ks:
        assert k >= b._k and k & (k - 1) == 0  # a pow2, never below the poll
    assert b._fused_plan(16) == (16, None)  # no lane: no shrink


def test_fused_k_is_pow2_floored(models):
    b = port(models, fused_steps_per_dispatch=12)
    try:
        assert b._fused_k == 8
    finally:
        b.close()


def test_write_pos_parks_writes_against_jax(models):
    """decode_step_ragged_list(write_pos=): rows parked at or past the
    cache length write nothing (JAX scatter semantics); the others write
    at their own position. Same numpy cache into both frameworks."""
    jm, jp, tm, tp = models
    L, B, T = CFG["n_layers"], 4, 16
    rs = np.random.RandomState(0)
    shape = (B, CFG["n_kv_heads"], T, CFG["d_model"] // CFG["n_heads"])
    ks = [rs.randn(*shape).astype(np.float32) for _ in range(L)]
    vs = [rs.randn(*shape).astype(np.float32) for _ in range(L)]
    tok = rs.randint(0, CFG["vocab_size"], (B, 1)).astype(np.int32)
    pos = np.array([5, 9, 3, 12], np.int32)
    wpos = np.array([5, T, 3, T + 7], np.int32)  # rows 1 and 3 parked
    decode = jax.jit(jm.decode_step_ragged_list, static_argnames=("attn_len",))
    jl, jks, jvs = decode(jp, [jnp.asarray(a) for a in ks], [jnp.asarray(a) for a in vs],
                          jnp.asarray(tok), jnp.asarray(pos), write_pos=jnp.asarray(wpos))
    tks = [torch.from_numpy(a.copy()) for a in ks]
    tvs = [torch.from_numpy(a.copy()) for a in vs]
    tl, tks, tvs = tm.decode_step_ragged_list(
        tp, tks, tvs, torch.from_numpy(tok), torch.from_numpy(pos),
        write_pos=torch.from_numpy(wpos))
    assert float(np.abs(np.asarray(jl) - tl.numpy()).max()) <= TOL
    for l in range(L):
        for got, want, before in ((tks[l].numpy(), np.asarray(jks[l]), ks[l]),
                                  (tvs[l].numpy(), np.asarray(jvs[l]), vs[l])):
            # parked rows bit-equal to the cache they were given, in both
            for row in (1, 3):
                np.testing.assert_array_equal(got[row], before[row])
                np.testing.assert_array_equal(want[row], before[row])
            # written rows: only their own position moved
            for row in (0, 2):
                keep = np.arange(T) != wpos[row]
                np.testing.assert_array_equal(got[row][:, keep], before[row][:, keep])
                assert float(np.abs(got[row] - want[row]).max()) <= TOL
                assert not np.array_equal(got[row], before[row])


def test_server_knob_counters_and_engine_series(tmp_path):
    """GenerateServer forwards the knob, serves the tokens of a fused-off
    server, exports gen_fused_* counters, and the engine maps them to
    the JAX engine's seldon_engine_fused_* series."""
    d = tmp_path / "llm"
    d.mkdir()
    (d / "jax_config.json").write_text(json.dumps({"family": "llm", "config": CFG}))
    plain = GenerateServer(model_uri=str(d), device="cpu", slots=2, steps_per_poll=2)
    fused = GenerateServer(model_uri=str(d), device="cpu", slots=2, steps_per_poll=2,
                           fused_steps_per_dispatch="16")
    try:
        body = {"prompt_tokens": [[5, 17, 42], [7, 7, 7, 7]], "max_new_tokens": 8}
        seeded = {"prompt_tokens": [[5, 17, 42]], "max_new_tokens": 8,
                  "temperature": 0.8, "seed": 3}
        for b in (body, seeded):
            assert plain.predict(dict(b), [])["tokens"] == fused.predict(dict(b), [])["tokens"]
        assert fused.batcher._fused_k == 16
        metrics = fused.metrics()
        keys = {m["key"]: m for m in metrics}
        assert keys["gen_fused_steps"]["type"] == "COUNTER"
        assert keys["gen_fused_steps"]["value"] > keys["gen_fused_dispatches"]["value"] > 0
        assert "gen_fused_steps" not in {m["key"] for m in plain.metrics()}
    finally:
        plain.close()
        fused.close()
    series = {}
    for cls in (MetricsRegistry, JaxRegistry):
        reg = cls()
        reg.record_custom(metrics, {"deployment": "d"})
        series[cls] = (reg.counter_total("seldon_engine_fused_steps"),
                       reg.counter_total("seldon_engine_fused_dispatches"))
    assert series[MetricsRegistry] == series[JaxRegistry]
    assert series[MetricsRegistry] == (keys["gen_fused_steps"]["value"],
                                       keys["gen_fused_dispatches"]["value"])


class _ReplayGraphs(_StepGraphs):
    """CUDA-graph semantics on the CPU: a key's phase is recorded once
    and every later run of the key replays THAT recording (the function
    bound at capture, over the same buffers), whatever the caller passes
    then. A phase that reads anything but its persistent buffers, or two
    phases sharing a key, then give other tokens than the eager path."""

    def capture(self, key, fn, warm_first):
        if warm_first:
            with torch.inference_mode():
                fn()

        def replay(fn=fn):
            with torch.inference_mode():
                fn()

        self.graphs[key] = types.SimpleNamespace(replay=replay)
        self.stats["graphs_captured"] += 1


@pytest.mark.parametrize("knobs", [
    {}, dict(fused_steps_per_dispatch=8),
    dict(attn_bucket=16, depth_groups=4, depth_group_split_bytes=0),
    dict(attn_bucket=16, depth_groups=4, depth_group_split_bytes=0,
         fused_steps_per_dispatch=8, prefill_chunk=8),
], ids=["plain", "fused", "groups", "all"])
def test_recorded_phases_replay_as_eager(models, knobs):
    """Every burst phase replayed from its first recording gives the
    eager path's tokens, and warm() records every key the traffic takes
    (none recorded later)."""
    from _torch_sched import mixed
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    # three shallow lanes beside a deep one: a group as wide as the batch
    reqs = mixed(17, (3, 4, 5, 40, 9, 28), max_new=6, temperature=0.9)
    old = ContinuousBatcher.MIN_ATTN_BUCKET
    ContinuousBatcher.MIN_ATTN_BUCKET = 16
    try:
        eager, _ = run_port(models, reqs, **knobs)
        b = port(models, **knobs)
        try:
            b._graphs = _ReplayGraphs(b.device, b.stats)
            b.warm(prompt_lens=[len(p) for p, _kw in reqs], max_new_tokens=8)
            captured = b.stats["graphs_captured"]
            futs = [b.submit(p, **kw) for p, kw in reqs]
            got = [f.result(timeout=120) for f in futs]
        finally:
            b.close()
    finally:
        ContinuousBatcher.MIN_ATTN_BUCKET = old
    assert got == eager
    assert captured > 0 and b.stats["graph_captures_inline"] == 0
    assert b.stats["graph_replays"] > b.stats["steps"]
