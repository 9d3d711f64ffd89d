"""The port's telemetry (flight recorder, device-time ledger, SLO burn,
the fleet plane and the engine's /flightrecorder, /fleet routes) held
against the JAX package on the same inputs, on the CPU at the tiny
2-layer config.

Tolerances: exact equality for recorder dumps, ledger rows (``n``,
``bytes``, ``tokens``; never the measured seconds), burn verdicts, read
bytes and payload keys; token equality for the float32 streams. Each
JAX reference request runs alone (ROADMAP.md queue C)."""

import asyncio
import importlib.util
import json
import os
import re
import threading
import time

import numpy as np
import pytest
import torch

from _torch_engine import build_app, dispatch, gen_unit, make_model_dir
from _torch_sched import BASE, CFG, JaxReference, batch, make_models, mixed, port
from seldon_core_tpu.graph import engine_metrics as jax_em
from seldon_core_tpu.serving import flightrecorder as jax_fr
from seldon_core_tpu.serving import profiler as jax_prof
from seldon_core_tpu.serving import slo_burn as jax_burn
from seldon_core_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from seldon_core_tpu_torch.graph import engine_metrics as port_em
from seldon_core_tpu_torch.models.llm import DecoderLM as TorchLM
from seldon_core_tpu_torch.serving import flightrecorder as port_fr
from seldon_core_tpu_torch.serving import profiler as port_prof
from seldon_core_tpu_torch.serving import slo_burn as port_burn

JAX, PORT = "seldon_core_tpu", "seldon_core_tpu_torch"


def _flight_report():
    spec = importlib.util.spec_from_file_location(
        "flight_report", os.path.join(os.path.dirname(__file__), "..", "tools",
                                      "flight_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def reference(models):
    ref = JaxReference(models)
    yield ref
    ref.close()


# -- flight recorder -----------------------------------------------------------


@pytest.mark.parametrize("capacity,n,limit", [
    (4, 0, None), (4, 3, None), (4, 10, None), (1, 3, None), (0, 5, None),
    (8, 20, 3), (8, 5, 0),
])
def test_flight_recorder_ring_equals_jax(capacity, n, limit):
    """Ring, drop-oldest, ``seq`` and ``dump`` equal the JAX recorder's
    for the same record sequence (``t_us`` given, so nothing depends on
    the clock)."""
    dumps = []
    for mod in (jax_fr, port_fr):
        rec = mod.FlightRecorder(capacity)
        for i in range(n):
            rec.record({"type": "poll", "i": i, "t_us": 1000 + i})
        dumps.append((rec.enabled, rec.dump(limit), rec.snapshot(limit)))
    assert dumps[0] == dumps[1]


def test_flight_recorder_clear_and_wall_stamp_as_jax():
    for mod in (jax_fr, port_fr):
        rec = mod.FlightRecorder(2)
        rec.record({"type": "shed"})
        assert rec.snapshot()[0]["t_us"] > 0 and rec.snapshot()[0]["seq"] == 0
        rec.clear()
        assert rec.dump() == {"capacity": 2, "enabled": True, "recorded_total": 0,
                              "dropped": 0, "entries": []}


# -- device-time ledger: unit semantics ------------------------------------------

SEQUENCES = {
    "one": [("prefill", "p32", "", 500, 5)],
    "repeat": [("decode_burst", "b64", "t1", 1000, 8)] * 3,
    "mixed": [("decode_burst", "b64", "t1", 1000, 8), ("prefill", "p32", "", 500, 5),
              ("insert", "b32", "t1", 64, 3), ("decode_burst", "b64", "t1", 1000, 8)],
    "every_kind": [(k, f"v{i}", "", 10 * i, i) for i, k in enumerate(jax_prof.KINDS)],
    "tenants": [("fused_burst", "k8b64", t, 100, 2) for t in ("a", "b", "", "a")],
}


def _strip(rows):
    return [{k: v for k, v in r.items() if k != "s"} for r in rows or []]


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_ledger_rows_equal_jax(name):
    """Rows (``n``, ``bytes``, ``tokens``), the flush-once rule, the
    cumulative buckets after a flush and the summary's keys (but the JAX
    package's deep-sample count: the port has no deep mode) equal the JAX
    ledger's."""
    out = []
    for mod in (jax_prof, port_prof):
        led = mod.DeviceTimeLedger(enabled=True, hbm_gb_s=100.0, dispatch_floor_us=5.0)
        for kind, variant, tenant, nbytes, toks in SEQUENCES[name]:
            with led.measure(kind, variant=variant, tenant=tenant, bytes_read=nbytes,
                             tokens=toks):
                pass
        first, second = led.poll_flush(), led.poll_flush()
        s = led.summary()
        buckets = {k: v[1:] for k, v in led.buckets().items()}
        out.append((_strip(first), second, _strip(s["buckets"]), sorted(s["by_kind"]),
                    s["enabled"], sorted(set(s) - {"deep_samples"}), buckets,
                    sorted(led.gauges())))
    assert out[0] == out[1]
    assert out[1][1] is None  # flushed once only


def test_ledger_disabled_and_unknown_kind_as_jax():
    for mod in (jax_prof, port_prof):
        off = mod.DeviceTimeLedger(enabled=False)
        with off.measure("not_a_kind", bytes_read=10):
            pass  # a disabled ledger checks nothing: one attribute test
        assert off.buckets() == {} and off.poll_flush() is None
        assert off.summary()["enabled"] is False
        with pytest.raises(ValueError, match="unknown ledger kind"):
            mod.DeviceTimeLedger(enabled=True).measure("not_a_kind")
    assert port_prof.KINDS == jax_prof.KINDS


class _FakeEvent:
    """A CUDA event stand-in: ``query()`` is what the test says it is."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None
        self.done = False
        self.synced = 0

    def record(self, stream=None):
        self.t = _FakeEvent.clock
        _FakeEvent.clock += 2.5
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.synced += 1
        self.done = True

    def elapsed_time(self, end):
        # the stream passed ``end``, so also ``self``, recorded before it
        assert end.done
        return end.t - self.t


def test_ledger_cuda_path_resolves_by_query_without_synchronize(monkeypatch):
    """On a CUDA device the ledger records a start/end event pair per
    dispatch, resolves a record only once ``end.query()`` passes (never
    by synchronising), takes the seconds from
    ``elapsed_time`` and reuses its event pairs; during a graph capture
    it records nothing."""
    _FakeEvent.made, _FakeEvent.clock = 0, 0.0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    capturing = {"on": False}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing["on"])
    led = port_prof.DeviceTimeLedger(enabled=True, device="cuda")
    with led.measure("decode_burst", variant="b64", bytes_read=100, tokens=8):
        pass
    assert led.poll_flush() is None  # enqueued, not passed by the stream yet
    m, start, end = led._pending[0]
    start.done = end.done = True
    rows = led.poll_flush()
    assert rows == [{"kind": "decode_burst", "variant": "b64", "s": 0.0025, "n": 1,
                     "bytes": 100, "tokens": 8}]
    assert start.synced == end.synced == 0
    for _ in range(5):  # the pair went back to the pool: reused
        with led.measure("prefill", variant="p32"):
            pass
        for _m, s, e in list(led._pending):
            s.done = e.done = True
        led.resolve()
    assert _FakeEvent.made == 2
    capturing["on"] = True
    with led.measure("insert", variant="b32"):
        pass
    assert not led._pending and _FakeEvent.made == 2


# -- SLO burn ----------------------------------------------------------------------

BURN_CASES = {
    "quiet": [("ttft", 0.05, "")] * 20,
    "page": [("ttft", 0.5, "")] * 20,
    "warn": [("ttft", 0.5, "")] * 1 + [("ttft", 0.05, "")] * 19,
    "tenants": [("ttft", 0.5, "a"), ("ttft", 0.05, "b"), ("tpot", 0.02, "a"),
                ("queue_wait", 1.0, "b"), ("nope", 9.0, "a"), ("tpot", None, "")],
}


@pytest.mark.parametrize("name", sorted(BURN_CASES))
def test_slo_burn_verdicts_equal_jax(name):
    """Verdicts, verdict counts, the worst severity and the summary equal
    the JAX burn engine's on the same observations (within one second:
    both windows hold every sample)."""
    out = []
    for mod in (jax_burn, port_burn):
        objs = mod.SloObjective.parse({"ttft": {"threshold_ms": 200, "target": 0.9},
                                       "tpot": {"threshold_s": 0.05}})
        eng = mod.SloBurnEngine(objs, fast_window_s=60.0, slow_window_s=3600.0)
        for slo, val, tenant in BURN_CASES[name]:
            eng.observe(slo, val, tenant)
        out.append((eng.verdicts(), eng.verdict_counts(), eng.worst(), eng.summary(),
                    eng.stats))
    assert out[0] == out[1]
    assert port_burn.SEVERITIES == jax_burn.SEVERITIES


@pytest.mark.parametrize("args", [("ttft", 0.2, 1.0), ("ttft", 0.0, 0.9), ("ttft", 0.2, 0.0)])
def test_slo_objective_validation_as_jax(args):
    for mod in (jax_burn, port_burn):
        with pytest.raises(ValueError):
            mod.SloObjective(*args)


# -- the cost model ----------------------------------------------------------------


@pytest.mark.parametrize("kind", list(jax_prof.KINDS) + ["unknown"])
def test_dispatch_read_bytes_equal_jax(models, kind):
    jm = models[0]
    tm = TorchLM(**CFG)
    for kw in ({}, {"rows": 4, "k": 8, "bucket": 64, "tokens": 20},
               {"rows": 2, "k": 2, "bucket": 32, "tokens": 7, "param_bytes": 1e6,
                "kv_row_bytes": 96.0}):
        assert tm.dispatch_read_bytes(kind, **kw) == jm.dispatch_read_bytes(kind, **kw)
    assert tm.kv_bytes_per_token() == jm.kv_bytes_per_token()


# -- the batcher -------------------------------------------------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_ledger_and_recorder_on_equal_off(models, reference, temperature):
    """Profiler and recorder on vs off: byte-identical greedy and seeded
    streams inside the port, equal to the JAX batcher's (each request
    alone), and no decode graph set grows."""
    reqs = batch(temperature) + mixed(3, (4, 12, 25), temperature=temperature)
    outs, stats = [], []
    for kw in ({"flight_recorder_capacity": 0},
               {"profiler": port_prof.DeviceTimeLedger(enabled=True)}):
        b = port(models, fused_steps_per_dispatch=8, **kw)
        try:
            outs.append([b.submit(p, **rkw).result(timeout=120) for p, rkw in reqs])
            stats.append(b.stats["graphs_captured"])
            if "profiler" in kw:
                assert b._prof.buckets()
                assert b.flight.dump()["entries"]
            else:
                assert b.flight is None
        finally:
            b.close()
    assert outs[0] == outs[1] == reference(reqs, fused_steps_per_dispatch=8)
    assert stats[0] == stats[1]


class _Gate:
    """A fault hook that holds the scheduler's first poll until released,
    so that requests submitted meanwhile form one admission wave."""

    def __init__(self):
        self.release = threading.Event()

    def __call__(self, _poll):
        self.release.wait(60)


def _rows_run(b, requests, wave):
    if wave:
        gate = _Gate()
        b.fault_hook = gate
        b.start()
        futs = [b.submit(p, **kw) for p, kw in requests]
        gate.release.set()
        for f in futs:
            f.result(timeout=120)
    else:
        for p, kw in requests:
            b.submit(p, **kw).result(timeout=120)


RUNS = {
    # name: (knobs, requests, one admission wave?)
    "plain": ({}, batch(), False),
    "fused": ({"fused_steps_per_dispatch": 8}, batch(0.8), False),
    "chunked": ({"prefill_chunk": 8}, mixed(5, (20, 30, 6)), False),
    "prefix": ({"prefix_cache_hbm_bytes": 1 << 20, "prefix_cache_min_tokens": 4},
               [([7] * 12, {"max_new_tokens": 4}), ([7] * 12 + [9] * 3, {"max_new_tokens": 5}),
                ([7] * 12 + [9] * 3, {"max_new_tokens": 3})], False),
    "prefix_chunked": ({"prefix_cache_hbm_bytes": 1 << 20, "prefix_cache_min_tokens": 4,
                        "prefill_chunk": 8},
                       [([7] * 16, {"max_new_tokens": 4}),
                        ([7] * 16 + [9] * 12, {"max_new_tokens": 4})], False),
    "batched_wave": ({}, [(p, {"max_new_tokens": 6, "seed": i})
                          for i, p in enumerate([[1, 2, 3], [4, 5], [6, 7, 8, 9], [3] * 5])],
                     True),
    "groups_wave": ({"depth_groups": 4, "depth_group_split_bytes": 0, "attn_bucket": 16,
                     "fused_steps_per_dispatch": 4},
                    [([1, 2, 3], {"max_new_tokens": 12}), ([5] * 25, {"max_new_tokens": 6})],
                    True),
}


@pytest.fixture()
def _sub_tile_attn_buckets():
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    old = (JaxBatcher.MIN_ATTN_BUCKET, ContinuousBatcher.MIN_ATTN_BUCKET)
    JaxBatcher.MIN_ATTN_BUCKET = ContinuousBatcher.MIN_ATTN_BUCKET = 16
    yield
    JaxBatcher.MIN_ATTN_BUCKET, ContinuousBatcher.MIN_ATTN_BUCKET = old


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ledger_rows_equal_jax_batcher(models, name, _sub_tile_attn_buckets):
    """The same traffic gives the JAX batcher's ledger rows: every
    ``(kind, variant, tenant)`` with its dispatch count, modelled read
    bytes and tokens (the measured seconds differ by nature). Requests
    run one at a time, or as one admission wave held at the first poll,
    so both schedulers see one batch composition."""
    knobs, requests, wave = RUNS[name]
    rows = []
    for ctor, prof in ((lambda **kw: JaxBatcher(models[0], models[1], **{**BASE, **kw}),
                        jax_prof.DeviceTimeLedger(enabled=True)),
                       (lambda **kw: port(models, **kw),
                        port_prof.DeviceTimeLedger(enabled=True))):
        b = ctor(profiler=prof, **knobs)
        try:
            _rows_run(b, requests, wave)
        finally:
            b.close()
        rows.append(_strip(prof.summary()["buckets"]))
    assert rows[0] == rows[1]
    kinds = {r["kind"] for r in rows[1]}
    assert "insert" in kinds and ("prefill" in kinds or "chunked" in name)
    if name == "groups_wave":
        assert "group_burst" in kinds
    if name.startswith("prefix"):
        assert "extract" in kinds
    if name == "prefix_chunked":
        assert {"splice", "chunk_prefill"} <= kinds


def test_replay_rows_differ_by_design(models):
    """A preempted lane's resume replays its emitted tokens one decode
    step each in the port (the JAX batcher replays k at a time): the
    port's ``replay`` rows are ``k1`` variants, one per token."""
    from seldon_core_tpu_torch.resilience import FaultInjector

    prof = port_prof.DeviceTimeLedger(enabled=True)
    b = port(models, hbm_ledger_bytes=1 << 40, profiler=prof)
    try:
        futs = [b.submit(p, max_new_tokens=40) for p, _kw in batch()]
        deadline = time.monotonic() + 60
        while len(b._active) < 2 and time.monotonic() < deadline:
            time.sleep(0.002)
        end = b.max_seq
        shrink = int(1.3 * b._attn_need(end) * b._kv_key_bytes)
        inj = FaultInjector([], pressure={"shrink_to_bytes": shrink,
                                          "after_polls": b._work_poll_count + 1,
                                          "restore_after_polls": 12})
        b.pressure_hook = inj.pressure_hook()
        for f in futs:
            f.result(timeout=120)
        assert b.stats["preemptions"] >= 1
        replay = [k for k in prof.buckets() if k[0] == "replay"]
        assert replay and all(v.startswith("k1b") for _k, v, _t in replay)
        n = sum(v[1] for k, v in prof.buckets().items() if k[0] == "replay")
        assert n == b.stats["replayed_tokens"]
        types = {e["type"] for e in b.flight.snapshot()}
        assert {"preempt", "preempt_resume", "pressure_budget"} <= types
    finally:
        b.close()


def test_poll_records_carry_jax_keys_and_ledger_deltas(models):
    """Poll records carry the JAX batcher's keys and plan vocabulary, and
    the ledger's per-poll rows, whose sum is the ledger's total."""
    keys, plans = [], []
    for ctor, prof in ((lambda **kw: JaxBatcher(models[0], models[1], **{**BASE, **kw}),
                        jax_prof.DeviceTimeLedger(enabled=True)),
                       (lambda **kw: port(models, **kw),
                        port_prof.DeviceTimeLedger(enabled=True))):
        b = ctor(profiler=prof, fused_steps_per_dispatch=8)
        try:
            for p, kw in batch():
                b.submit(p, **kw).result(timeout=120)
            entries = b.flight.dump()["entries"]
        finally:
            b.close()
        polls = [e for e in entries if e["type"] == "poll"]
        keys.append(set().union(*(set(e) for e in polls)))
        plans.append(sorted({(p["mode"], tuple(sorted(p))) for p in
                             (e["plan"] for e in polls if "plan" in e)}))
        rows = [r for e in polls for r in e.get("device_time") or []]
        total = {(r["kind"], r["variant"]): 0 for r in rows}
        for r in rows:
            total[(r["kind"], r["variant"])] += r["n"]
        assert total == {(k, v): int(x[1]) for (k, v, _t), x in prof.buckets().items()}
    assert keys[0] == keys[1]
    assert plans[0] == plans[1]


def test_flight_report_renders_port_dump_with_jax_sections(models):
    """``tools/flight_report.py``, unchanged, renders the port's dump
    into the JAX dump's sections for the same traffic."""
    fr = _flight_report()
    sections = []
    for ctor, prof in ((lambda **kw: JaxBatcher(models[0], models[1], **{**BASE, **kw}),
                        jax_prof.DeviceTimeLedger(enabled=True)),
                       (lambda **kw: port(models, **kw),
                        port_prof.DeviceTimeLedger(enabled=True))):
        b = ctor(profiler=prof, fused_steps_per_dispatch=8,
                 prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=4)
        try:
            for p, kw in batch() + batch():
                b.submit(p, **kw).result(timeout=120)
            dump = b.flight.dump()
        finally:
            b.close()
        lines = fr.diagnose(dump)
        sections.append({re.sub(r"[\d.]+", "#", ln.split(":")[0])
                         for ln in lines if not ln.startswith("DIAGNOSIS")})
    assert sections[0] == sections[1]
    assert any("device-time window" in s for s in sections[1])


def test_shed_record_equal_jax(models):
    """A shed decision's record equals the JAX batcher's (the admit
    queue filled past its cap before the loop runs)."""
    recs = []
    for b in (JaxBatcher(models[0], models[1], **{**BASE, "admit_queue_limit": 1}),
              port(models, admit_queue_limit=1)):
        b._queue.put(object())
        try:
            with pytest.raises(Exception, match="admit queue full"):
                b.submit([1, 2, 3], max_new_tokens=2)
            recs.append([{k: v for k, v in e.items() if k != "t_us"}
                         for e in b.flight.snapshot()])
        finally:
            b._queue.get_nowait()
            b.close()
    assert recs[0] == recs[1] == [{"type": "shed", "reason": "queue_full", "queue": 1,
                                   "rate_per_s": None, "seq": 0}]


# -- server, wrapper and engine --------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("telemetry"))


TELEMETRY_PARAMS = [
    {"name": "profiler", "value": "1", "type": "INT"},
    {"name": "profiler_hbm_gb_s", "value": "100", "type": "FLOAT"},
    {"name": "slo_objectives", "value": "ttft:200:0.99,tpot:50:0.9", "type": "STRING"},
    {"name": "flight_recorder", "value": "512", "type": "INT"},
]


def _telemetry_unit(model_dir):
    unit = gen_unit(model_dir)
    unit["parameters"] = unit["parameters"] + TELEMETRY_PARAMS
    return unit


@pytest.fixture(scope="module")
def apps(model_dir):
    """A JAX and a port engine over one telemetry-on generate unit, each
    having served the same two requests."""
    from _torch_engine import close_app

    out = {}
    for pkg in (JAX, PORT):
        app = build_app(pkg, _telemetry_unit(model_dir))
        rest = app.rest_app()
        for toks in ([5, 17, 42], [1, 2, 3, 4, 5, 6]):
            status, _ = dispatch(rest, "/api/v0.1/predictions",
                                 {"jsonData": {"prompt_tokens": toks, "max_new_tokens": 5}})
            assert status == 200
        out[pkg] = (app, rest)
    yield out
    for app, _rest in out.values():
        close_app(app)


def test_engine_flightrecorder_route_equals_jax_keys(apps):
    payloads = {}
    for pkg, (_app, rest) in apps.items():
        status, out = dispatch(rest, "/flightrecorder", method="GET")
        assert status == 200
        payloads[pkg] = out["units"]["llm"]
        status, lim = dispatch(rest, "/flightrecorder?limit=1", method="GET")
    jd, pd = payloads[JAX], payloads[PORT]
    assert set(pd) == set(jd)
    # the profiler summary's keys, but the JAX package's deep-sample count
    # (the port has no deep mode)
    assert set(pd["profiler"]) == set(jd["profiler"]) - {"deep_samples"}
    assert set(pd["slo_burn"]) == set(jd["slo_burn"])
    assert any(e["type"] == "poll" and "device_time" in e for e in pd["entries"])
    assert pd["slo"]["samples"] == 2


def test_engine_flightrecorder_limit_and_404(apps):
    from seldon_core_tpu_torch.http_server import Request

    _app, rest = apps[PORT]
    handler = rest.routes["/flightrecorder"]
    resp = asyncio.run(handler(Request("GET", "/flightrecorder", "limit=1", {}, b"")))
    assert resp.status == 200
    assert len(json.loads(resp.body)["units"]["llm"]["entries"]) == 1
    plain = build_app(PORT, {"name": "m", "implementation": "SIMPLE_MODEL"}).rest_app()
    status, out = dispatch(plain, "/flightrecorder", method="GET")
    assert status == 404 and "flight recorder" in out["status"]["info"]


def test_engine_fleet_route_equals_jax_keys(apps):
    out = {}
    for pkg, (_app, rest) in apps.items():
        status, body = dispatch(rest, "/fleet", method="GET")
        assert status == 200
        out[pkg] = body
    jf, pf = out[JAX], out[PORT]
    assert set(pf) == set(jf) == {"predictor", "metrics", "units"}
    assert set(pf["units"]["llm"]) == set(jf["units"]["llm"])
    assert pf["units"]["llm"]["planning"]["config"] == jf["units"]["llm"]["planning"]["config"]
    assert set(pf["metrics"]) == set(jf["metrics"])
    assert pf["metrics"]["buckets"] == jf["metrics"]["buckets"]
    # the server's telemetry series reached the engine's registry under the
    # JAX names
    for name in ("seldon_engine_device_time_seconds", "seldon_engine_device_dispatches",
                 "seldon_engine_device_bytes", "seldon_engine_slo_burn_verdicts"):
        assert name in pf["metrics"]["counters"] and name in jf["metrics"]["counters"]
    for name in ("seldon_engine_slo_burn_rate", "seldon_engine_slo_budget_remaining",
                 "seldon_engine_mbu_pct", "seldon_engine_device_busy_frac"):
        assert name in pf["metrics"]["gauges"]


def test_wrapper_flightrecorder_route(model_dir):
    from seldon_core_tpu_torch import wrapper
    from seldon_core_tpu_torch.http_server import Request
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    srv = GenerateServer(model_uri=model_dir, device="cpu", slots=2, steps_per_poll=2)
    srv.load()
    try:
        srv.predict({"prompt_tokens": [[3, 1, 4]], "max_new_tokens": 3}, [])
        handler = wrapper.get_rest_microservice(srv).routes["/flightrecorder"]
        resp = asyncio.run(handler(Request("GET", "/flightrecorder", "", {}, b"")))
        assert resp.status == 200
        dump = json.loads(resp.body)
        assert dump["entries"] and dump["slo"]["samples"] == 1
        assert "profiler" not in dump  # the ledger is off by default
    finally:
        srv.close()
    off = GenerateServer(model_uri=model_dir, device="cpu", slots=2, flight_recorder=0)
    off.load()
    try:
        handler = wrapper.get_rest_microservice(off).routes["/flightrecorder"]
        resp = asyncio.run(handler(Request("GET", "/flightrecorder", "", {}, b"")))
        assert resp.status == 404
    finally:
        off.close()

    class Plain:
        def predict(self, X, names, meta=None):
            return X

    assert "/flightrecorder" not in wrapper.get_rest_microservice(Plain()).routes


def test_server_metrics_series_equal_jax(model_dir):
    """The telemetry-on server's metrics() ships the JAX server's
    telemetry series (keys and tag sets; the ledger's values differ by
    nature), and the burn feed sees every completed request."""
    from seldon_core_tpu.servers.generateserver import GenerateServer as JaxServer
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    kw = {p["name"]: p["value"] for p in TELEMETRY_PARAMS}
    series = []
    for cls in (JaxServer, GenerateServer):
        srv = cls(model_uri=model_dir, device="cpu", slots=2, steps_per_poll=2, **kw)
        srv.load()
        try:
            for toks in ([5, 17, 42], [9, 9, 9, 9]):
                srv.predict({"prompt_tokens": [toks], "max_new_tokens": 4}, [])
            ms = srv.metrics()
            assert srv.slo_burn.stats["samples"] >= 4
        finally:
            srv.batcher.close()
        series.append(sorted({(m["key"], tuple(sorted(m.get("tags") or {})))
                              for m in ms if m["key"].startswith(("gen_device", "gen_slo",
                                                                   "gen_mbu"))}))
    assert series[0] == series[1]
    assert any(k == "gen_device_time_ms" for k, _t in series[1])


def test_jax_config_with_recorder_default_is_accepted(model_dir):
    """A JAX GenerateServer config spelling its default flight_recorder
    512 is accepted; the recorder defaults to 512 as in the JAX server."""
    from seldon_core_tpu_torch import microservice

    params = json.dumps([
        {"name": "model_uri", "value": model_dir, "type": "STRING"},
        {"name": "device", "value": "cpu", "type": "STRING"},
        {"name": "flight_recorder", "value": "512", "type": "INT"},
    ])
    srv = microservice.build_user_object(
        "seldon_core_tpu_torch.servers.generateserver.GenerateServer", params)
    srv.load()
    try:
        assert srv.batcher.flight.capacity == 512
    finally:
        srv.close()


# -- fleet plane ----------------------------------------------------------------------


def _registry_ops(mod, step):
    reg = mod.MetricsRegistry()
    reg.counter_inc("seldon_engine_device_dispatches", {"kind": "prefill"}, 3.0 * step)
    reg.counter_inc("seldon_engine_requests", {"code": "200"}, 5.0 + step)
    reg.gauge_set("seldon_engine_mbu_pct", 12.5 * step, {"unit": "llm"})
    for s in (0.001, 0.02, 0.3)[: step + 1]:
        reg.observe("seldon_engine_generate_ttft_seconds", s, {"unit": "llm"})
    return reg


@pytest.mark.parametrize("case", ["snapshot", "diff", "restart", "ingest"])
def test_fleet_snapshot_ingest_diff_equal_jax(case):
    out = []
    for mod in (jax_em, port_em):
        prev, cur = _registry_ops(mod, 1).fleet_snapshot(), _registry_ops(mod, 2).fleet_snapshot()
        if case == "snapshot":
            out.append(cur)
        elif case == "diff":
            out.append(mod.diff_fleet_snapshot(prev, cur))
        elif case == "restart":
            out.append(mod.diff_fleet_snapshot(cur, prev))  # totals went down
        else:
            agg = mod.MetricsRegistry()
            agg.ingest_fleet(mod.diff_fleet_snapshot(None, prev), {"member": "a"})
            agg.ingest_fleet(mod.diff_fleet_snapshot(prev, cur), {"member": "a"})
            agg.ingest_fleet({**cur, "buckets": [1.0]}, {"member": "b"})
            out.append((agg.fleet_snapshot(), agg.expose()))
    assert out[0] == out[1]
