"""HBM pressure in the port: the ledger's watermark controller and the
fault hook against the JAX package's, and the reclaim ladder in the
port's batcher (prefix eviction, lane preemption with recompute-resume
and teacher-forced replay, admission holds and 429 sheds), held against
the port with pressure off and the JAX batcher running each request
alone, at the tiny config of tests/test_torch_serving.py on the CPU
(float32). Tokens are compared exactly: preempt-on equals preempt-off,
greedy and seeded, streamed spans included.
"""

import time

import pytest

from seldon_core_tpu.resilience.faults import FaultInjector as JaxInjector
from seldon_core_tpu.serving.pressure import PressureController as JaxController
from seldon_core_tpu_torch.resilience import FaultInjector, ShedError
from seldon_core_tpu_torch.serving.continuous import GenRequest
from seldon_core_tpu_torch.serving.pressure import PressureController

from _torch_engine import build_app, close_app, dispatch, gen_unit, generator_of, make_model_dir
from _torch_sched import JaxReference, PROMPTS, make_models, port

GREEDY = [(p, dict(max_new_tokens=40)) for p in PROMPTS]
SAMPLED = [(p, dict(max_new_tokens=30, temperature=0.8, seed=11 + i))
           for i, p in enumerate(PROMPTS)]
ON = dict(hbm_ledger_bytes=1 << 40)


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def references(models):
    """Pressure-off port outputs, checked against the JAX batcher's."""
    ref = JaxReference(models)
    try:
        out = {}
        for name, reqs in (("greedy", GREEDY), ("sampled", SAMPLED)):
            b = port(models)
            try:
                out[name] = [b.submit(p, **kw).result(timeout=120) for p, kw in reqs]
            finally:
                b.close()
            assert out[name] == ref(reqs)
        return out
    finally:
        ref.close()


def arm_shrink(b, lanes=1.3, after=1, restore=12):
    """A mid-run ledger shrink to ~``lanes`` lanes at the deepest bucket
    through the fault config's pressure section."""
    shrink = int(lanes * b._attn_need(b.max_seq) * b._kv_key_bytes)
    b.pressure_hook = FaultInjector([], pressure={
        "shrink_to_bytes": shrink, "after_polls": b._work_poll_count + after,
        "restore_after_polls": restore,
    }).pressure_hook()


def wait_lanes(b, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(b._active) + len(b._chunked) >= n:
            return True
        time.sleep(0.002)
    return False


def run_shrunk(models, reqs, lanes=1.3, on_tokens=None, **kw):
    """Submit ``reqs`` to a batcher with the ledger on, shrink it once two
    lanes are live: ``(outputs, stats)``."""
    b = port(models, **{**ON, **kw})
    try:
        futs = [b.submit(p, on_tokens=on_tokens if i == 0 else None, **r)
                for i, (p, r) in enumerate(reqs)]
        assert wait_lanes(b, 2)
        arm_shrink(b, lanes=lanes)
        return [f.result(timeout=120) for f in futs], dict(b.stats)
    finally:
        b.close()


# -- the controller and the hook ------------------------------------------------


@pytest.mark.parametrize("cls", [PressureController, JaxController])
def test_controller_watermark_hysteresis(cls):
    pc = cls(1000, high=0.9, low=0.5)
    seq = [pc.update({"decode": used}) for used in (800, 950, 700, 400, 899, 900)]
    assert seq == [False, True, True, False, False, True]
    assert pc.stats["activations"] == 2
    assert pc.overshoot_bytes() == 400
    assert pc.retry_after_s() == 1.0


def test_controller_equals_jax_on_a_random_walk():
    import numpy as np

    rs = np.random.RandomState(3)
    a, b = PressureController(10_000, 0.8, 0.6), JaxController(10_000, 0.8, 0.6)
    for _ in range(300):
        comp = {"decode": int(rs.randint(0, 7000)), "prefix": int(rs.randint(0, 4000))}
        if rs.rand() < 0.05:
            nb = int(rs.randint(0, 12_000))
            a.set_budget(nb)
            b.set_budget(nb)
        assert a.update(comp) == b.update(comp)
        assert (a.used, a.overshoot_bytes(), a.retry_after_s()) == \
            (b.used, b.overshoot_bytes(), b.retry_after_s())
    assert a.stats == b.stats


def test_controller_budget_and_restore():
    pc = PressureController(0)
    assert not pc.update({"decode": 1 << 40})  # budget 0 = off
    pc.set_budget(100)
    assert pc.update({"decode": 95})
    pc.restore_budget()
    assert pc.budget_bytes == 0
    assert not pc.update({"decode": 95})
    assert pc.stats["budget_changes"] == 2


@pytest.mark.parametrize("high,low", [(1.5, 0.5), (0.5, 0.9), (0.0, 0.0)])
def test_bad_watermarks_raise(models, high, low):
    with pytest.raises(ValueError):
        PressureController(100, high=high, low=low)
    with pytest.raises(ValueError):
        port(models, hbm_ledger_bytes=100, pressure_high=high, pressure_low=low)


def test_fault_hook_fires_and_restores_as_jax():
    cfg = {"shrink_to_bytes": 4096, "after_polls": 3, "restore_after_polls": 5}
    hooks = [FaultInjector([], pressure=cfg).pressure_hook(),
             JaxInjector([], pressure=cfg).pressure_hook()]
    seqs = [[hook(poll) for poll in range(1, 12)] for hook in hooks]
    assert seqs[0] == seqs[1]
    assert seqs[0][2] == 4096 and seqs[0][7] == -1  # polls 3 and 8
    assert [v for v in seqs[0] if v is not None] == [4096, -1]
    assert FaultInjector([]).pressure_hook() is None
    once = FaultInjector([], pressure={"shrink_to_bytes": 64, "after_polls": 2}).pressure_hook()
    assert [once(p) for p in range(1, 6)] == [None, 64, None, None, None]  # never restored


# -- preemption and resume ----------------------------------------------------------


def test_preemption_greedy_byte_identical(models, references):
    got, stats = run_shrunk(models, GREEDY)
    assert got == references["greedy"]
    assert stats["preemptions"] >= 1
    assert stats["preempt_resumes"] == stats["preemptions"]


def test_preemption_seeded_byte_identical(models, references):
    """The checkpointed post-split lane key continues the sampling
    stream across preempt and resume."""
    got, stats = run_shrunk(models, SAMPLED)
    assert got == references["sampled"]
    assert stats["preemptions"] >= 1 and stats["replayed_tokens"] > 0


@pytest.mark.parametrize("knobs", [
    dict(fused_steps_per_dispatch=8),
    dict(fused_steps_per_dispatch=8, depth_groups=4, depth_group_split_bytes=0),
])
def test_preemption_under_fused_and_grouped_decode(models, references, knobs):
    got, stats = run_shrunk(models, SAMPLED, **knobs)
    assert got == references["sampled"]
    assert stats["preemptions"] >= 1


def test_preemption_mid_stream_no_duplicate_spans(models, references):
    spans = []
    got, stats = run_shrunk(models, GREEDY, on_tokens=spans.append)
    assert got == references["greedy"]
    assert stats["preemptions"] >= 1
    streamed = [t for span in spans for t in span]
    assert streamed == references["greedy"][0][len(PROMPTS[0]):]


def test_preemption_of_a_chunked_admission(models):
    """A chunked admission mid-prefill is a victim before any decode
    lane: its staging slab goes and the request is requeued whole."""
    long_prompt = list(range(1, 21))  # bucket 32 > chunk 8
    ref = port(models, slots=2, prefill_chunk=8)
    try:
        want_short = ref.generate(PROMPTS[1], max_new_tokens=40)
        want = ref.generate(long_prompt, max_new_tokens=20)
    finally:
        ref.close()
    b = port(models, slots=2, prefill_chunk=8, **ON)
    try:
        f1 = b.submit(PROMPTS[1], max_new_tokens=40)
        f2 = b.submit(long_prompt, max_new_tokens=20)
        deadline = time.monotonic() + 60
        while not b._chunked and time.monotonic() < deadline:
            time.sleep(0.001)
        assert b._chunked
        arm_shrink(b, lanes=1.05, restore=20)
        assert f1.result(timeout=120) == want_short
        assert f2.result(timeout=120) == want
        assert b.stats["preemptions"] >= 1
        assert b.stats["preempt_resumes"] <= b.stats["preemptions"]
    finally:
        b.close()


def test_resume_splices_a_prefix_hit(models):
    """A resume goes through the prefix cache: the cached prompt prefix
    splices into the resume (suffix-only recompute), the emitted tokens
    replay, and the continuation is unchanged."""
    b = port(models, slots=2, prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=4)
    try:
        prompt = PROMPTS[0]
        want = b.generate(prompt, max_new_tokens=24)  # publishes the prompt
        assert b.stats["prefix_hits"] == 0
        cut = 10
        req = GenRequest(tokens=list(prompt), max_new_tokens=24)
        req.submit_t = time.monotonic()
        req.future.gen_request = req
        # greedy lanes ignore the key: a crafted checkpoint drives the path
        req.resume = {"emitted": want[len(prompt):][:cut], "key": [0, 0]}
        b._resume_queue.append(req)
        b.start()
        assert req.future.result(timeout=120) == want
        assert b.stats["prefix_hits"] == 1 and req.cache_hit_tokens == len(prompt) - 1
        assert b.stats["preempt_resumes"] == 1 and b.stats["replayed_tokens"] == cut - 1
    finally:
        b.close()


def test_resume_of_a_chunked_prompt(models):
    """A decode lane whose prompt is longer than one chunk is preempted
    (it has the most budget left) and resumes through the chunked path:
    its prompt chunks again, the last chunk inserts the checkpoint, the
    emitted tokens replay, and the seeded stream is unchanged."""
    long_prompt = list(range(3, 30))  # 27 tokens, bucket 32: 4 chunks of 8
    reqs = [(long_prompt, dict(max_new_tokens=30, temperature=0.7, seed=5)),
            (PROMPTS[2], dict(max_new_tokens=20))]
    ref = port(models, slots=2, prefill_chunk=8)
    try:
        want = [ref.generate(p, **kw) for p, kw in reqs]
    finally:
        ref.close()
    b = port(models, slots=2, prefill_chunk=8, **ON)
    try:
        futs = [b.submit(p, **kw) for p, kw in reqs]
        deadline = time.monotonic() + 60
        while len(b._active) < 2 and time.monotonic() < deadline:
            time.sleep(0.001)
        arm_shrink(b, lanes=1.05, restore=8)
        assert [f.result(timeout=120) for f in futs] == want
        assert b.stats["preemptions"] == b.stats["preempt_resumes"] == 1
        assert b.stats["prefill_chunks"] == 8 and b.stats["replayed_tokens"] > 0
    finally:
        b.close()


def test_no_hang_under_a_permanently_tiny_budget(models, references):
    """A budget below one lane's footprint, never restored: the last live
    lane is never preempted and admissions pass through it one by one."""
    b = port(models, **ON)
    try:
        b.pressure_hook = FaultInjector([], pressure={
            "shrink_to_bytes": 64, "after_polls": 2}).pressure_hook()
        futs = [b.submit(p, **kw) for p, kw in GREEDY]
        assert [f.result(timeout=120) for f in futs] == references["greedy"]
        assert b._pressure.budget_bytes == 64
    finally:
        b.close()


# -- admission, the ladder and the ledger ----------------------------------------


def test_pressure_sheds_submits_with_the_429_contract(models):
    b = port(models, slots=2, **ON)
    try:
        f = b.submit([1, 2, 3], max_new_tokens=58)
        b._pressure.set_budget(256)  # far under one live lane
        shed, extra = None, []
        while not f.done():
            try:
                extra.append(b.submit([4, 5, 6], max_new_tokens=4))
            except ShedError as e:
                shed = e
                break
            time.sleep(0.002)
        assert shed is not None, "no shed before the lane completed"
        assert shed.retry_after_s >= 1.0
        assert b.stats["pressure_sheds"] >= 1 and b.stats["shed"] >= 1
        b._pressure.restore_budget()
        f.result(timeout=120)
        for e in extra:  # queued before the latch: still served
            e.result(timeout=120)
    finally:
        b.close()


def test_pressure_shed_is_429_at_the_engine(tmp_path):
    """hbm_ledger_bytes as a unit parameter; a latched ledger answers the
    engine's predict with 429, counted as load shed, and the engine
    exports the pressure series."""
    unit = gen_unit(make_model_dir(tmp_path))
    unit["parameters"] = unit["parameters"] + [
        {"name": "hbm_ledger_bytes", "value": str(1 << 40), "type": "INT"}]
    app = build_app("seldon_core_tpu_torch", unit)
    try:
        b = generator_of(app).batcher
        b.fault_hook = lambda _poll: time.sleep(0.01)  # keep the lane live a while
        f = b.submit([1, 2, 3], max_new_tokens=58)
        b._pressure.set_budget(256)
        deadline = time.monotonic() + 30
        while not b._pressure.active and time.monotonic() < deadline:
            time.sleep(0.001)
        assert b._pressure.active and not f.done()
        status, out = dispatch(app.rest_app(), "/api/v0.1/predictions", {
            "jsonData": {"prompt_tokens": [4, 5], "max_new_tokens": 2}})
        assert status == 429, out
        assert "high watermark" in out["status"]["info"]
        assert app.metrics.counter_total("seldon_engine_load_shed") >= 1
        b._pressure.restore_budget()
        b.fault_hook = None
        f.result(timeout=120)
        status, _ = dispatch(app.rest_app(), "/api/v0.1/predictions", {
            "jsonData": {"prompt_tokens": [4, 5], "max_new_tokens": 2}})
        assert status == 200
        text = app.metrics.expose()
        assert "seldon_engine_pressure_sheds" in text
        assert "seldon_engine_pressure_budget_bytes" in text
    finally:
        close_app(app)


def test_ladder_evicts_prefixes_first(models):
    b = port(models, slots=2, prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=4,
             **ON)
    try:
        b.generate(PROMPTS[0], max_new_tokens=8)
        assert b._prefix_index.total_bytes > 0
        f = b.submit(PROMPTS[1], max_new_tokens=58)
        b._pressure.set_budget(1024)
        deadline = time.monotonic() + 60
        while (b.stats["pressure_prefix_evictions"] == 0 and not f.done()
               and time.monotonic() < deadline):
            time.sleep(0.002)
        f.cancel()
        assert b.stats["pressure_prefix_evictions"] >= 1
        assert b.stats["prefix_evicted"] >= b.stats["pressure_prefix_evictions"]
        assert b._prefix_index.total_bytes == 0
        assert b.stats["preemptions"] == 0  # one lane: never preempted
    finally:
        b.close()


def test_ledger_components_track_live_state(models):
    b = port(models, slots=2, prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=4,
             hbm_ledger_bytes=1 << 30)
    try:
        assert b._ledger_components() == {"decode": 0, "staging": 0, "prefix": 0}
        b.generate(PROMPTS[0], max_new_tokens=8)
        deadline = time.monotonic() + 30
        while (b._pressure.components.get("prefix", 0) != b._prefix_index.total_bytes
               and time.monotonic() < deadline):
            time.sleep(0.002)
        assert b._pressure.components["prefix"] == b._prefix_index.total_bytes > 0
        summary = b.pressure_summary()
        assert summary["budget_bytes"] == 1 << 30
        assert set(summary["components"]) == {"decode", "staging", "prefix"}
        # a live lane at position p costs its attention bucket of K/V
        b._pos_host[1] = 70
        assert b._ledger_components()["decode"] == b._attn_need(70) * b._kv_key_bytes
        del b._pos_host[1]
    finally:
        b.close()


def test_pressure_off_is_byte_identical_and_unconsulted(models, references):
    b = port(models)
    try:
        futs = [b.submit(p, **kw) for p, kw in GREEDY]
        assert [f.result(timeout=120) for f in futs] == references["greedy"]
        assert b.stats["preemptions"] == 0
        assert b._pressure.stats["updates"] == 0
        assert b.pressure_summary() is None
    finally:
        b.close()
