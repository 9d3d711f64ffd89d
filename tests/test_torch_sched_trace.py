"""The port scheduler's poll phases, the first token's hold, the
per-request timeline spans and the device profile taken on the scheduler
thread, on the CPU at the tiny 2-layer config.

* The seven ``stats["sched_s_<phase>"]`` counters sum to the scheduler
  thread's wall time (within 2%).
* Every completed sample ``(queue_wait, ttft, tpot, hold)`` has ``0 <=
  hold <= ttft - queue_wait``: whole prefills, batched prefills, prefix
  hits and chunked admissions.
* Under ``TRACING=1`` a streamed request's ``gen.*`` spans are children
  of the engine's ``generate`` span; tracing off records none, and the
  streams are the same bytes either way.
* A trace taken through ``tracing.start_device_profile`` while the
  batcher serves holds the scheduler thread's ranges; a ``torch.profiler``
  session started on another thread holds none of them.
* A ``Tracer`` span and the profiler range of the same interval start
  within 1 ms of each other.
"""

import glob
import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_engine import Served, build_app, close_app, gen_unit, make_model_dir
from _torch_sched import make_models, mixed, port
from seldon_core_tpu_torch import tracing
from seldon_core_tpu_torch.serving.continuous import _PHASES

torch.set_num_threads(1)

PORT = "seldon_core_tpu_torch"
SCHED_RANGES = {"gen.poll", "gen.read", "gen.prefill"}


@pytest.fixture(scope="module")
def models():
    return make_models()


def _serve(b, requests, stagger=0.0):
    futs = []
    for i, (p, kw) in enumerate(requests):
        futs.append(b.submit(p, **kw))
        if stagger and i % 2:
            time.sleep(stagger)
    return [f.result(timeout=120) for f in futs]


# knobs and traffic: whole prefills, prefix hits (a shared 20-token head),
# and chunked admissions (prompts past one chunk of 8)
HEAD = list(range(40, 60))
CASES = {
    "plain": ({}, mixed(1, (3, 7, 12, 25, 5, 9))),
    "batched": ({}, mixed(2, (5, 6, 7, 5, 6, 7, 5, 6))),
    "prefix": ({"prefix_cache_hbm_bytes": 1 << 20, "prefix_cache_min_tokens": 4},
               [(HEAD + [i, i + 1], {"max_new_tokens": 6}) for i in range(6)]),
    "chunked": ({"prefill_chunk": 8}, mixed(3, (20, 30, 4, 27), max_new=6)),
    "chunked_prefix": ({"prefill_chunk": 8, "prefix_cache_hbm_bytes": 1 << 20,
                        "prefix_cache_min_tokens": 4},
                       [(HEAD + [i] * 9, {"max_new_tokens": 5}) for i in range(5)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_phase_counters_sum_to_the_scheduler_wall_time(models, case):
    knobs, reqs = CASES[case]
    b = port(models, **knobs)
    try:
        t0 = time.monotonic()
        b.start()
        _serve(b, reqs, stagger=0.01)
        _serve(b, reqs[:2])  # again: the prefix cases hit
        time.sleep(0.2)  # idle polls too
    finally:
        b.close()
        wall = time.monotonic() - t0
    phases = {k: b.stats[k] for k in _PHASES.values()}
    assert all(v >= 0.0 for v in phases.values())
    assert sum(phases.values()) == pytest.approx(wall, rel=0.02)
    for busy in ("admit", "prefill", "decode", "credit", "idle", "other"):
        assert phases[f"sched_s_{busy}"] > 0.0, busy
    if case.startswith("prefix"):
        assert b.stats["prefix_hits"] > 0
    if case.startswith("chunked"):
        assert b.stats["prefill_chunks"] > 0


def test_phase_counters_over_a_window_match_its_length(models):
    """Deltas between two reads of ``stats`` while the scheduler serves
    (the benchmark's window) sum to the window's length within 2%: the
    phase running at either edge is the only part a read leaves out."""
    b = port(models)
    stop = threading.Event()
    reqs = mixed(4, (3, 9, 14, 6), max_new=6)

    def traffic():
        # four requests always in flight: the scheduler never idles, so
        # no phase outlasts a few milliseconds
        inflight = [b.submit(p, **kw) for p, kw in reqs]
        i = 0
        while not stop.is_set():
            inflight[i % 4].result(timeout=60)
            p, kw = reqs[i % 4]
            inflight[i % 4] = b.submit(p, **kw)
            i += 1

    t = threading.Thread(target=traffic, daemon=True)
    try:
        b.start()
        t.start()
        time.sleep(0.5)
        a_t, a = time.monotonic(), dict(b.stats)
        time.sleep(3.0)
        b_t, z = time.monotonic(), dict(b.stats)
    finally:
        stop.set()
        t.join(60)
        b.close()
    total = sum(z[k] - a[k] for k in _PHASES.values())
    assert total == pytest.approx(b_t - a_t, rel=0.02)


@pytest.mark.parametrize("case", sorted(CASES))
def test_hold_lies_between_zero_and_ttft_less_queue_wait(models, case):
    knobs, reqs = CASES[case]
    b = port(models, **knobs)
    try:
        _serve(b, reqs, stagger=0.01)
        _serve(b, reqs[:3])
        samples = list(b.slo_recent)
        summary = b.slo_summary()
        hold_sum = b.stats["hold_s_sum"]
    finally:
        b.close()
    assert len(samples) == len(reqs) + 3
    for queue_wait, ttft, _tpot, hold in samples:
        assert 0.0 <= hold <= ttft - queue_wait + 1e-9
    assert hold_sum == pytest.approx(sum(s[3] for s in samples))
    assert summary["hold_ms"]["p50_ms"] >= 0.0


def test_server_exports_the_hold_timer(models):
    """``GenerateServer.metrics()`` unpacks the four-element samples and
    ships the hold beside TTFT (the engine records it as a custom
    histogram)."""
    from seldon_core_tpu_torch.metrics import CounterDeltas
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    b = port(models)
    try:
        _serve(b, mixed(5, (4, 6), max_new=5))
        srv = GenerateServer.__new__(GenerateServer)
        srv.batcher = b
        srv._deltas = CounterDeltas()
        timers = [m for m in srv.metrics() if m["type"] == "TIMER"]
    finally:
        b.close()
    keys = [m["key"] for m in timers]
    assert keys.count("gen_first_token_hold_ms") == keys.count("gen_ttft_ms") == 2
    hold = [m["value"] for m in timers if m["key"] == "gen_first_token_hold_ms"]
    ttft = [m["value"] for m in timers if m["key"] == "gen_ttft_ms"]
    assert all(0.0 <= h <= t for h, t in zip(hold, ttft))


# -- per-request spans ---------------------------------------------------------


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    app = build_app(PORT, gen_unit(make_model_dir(tmp_path_factory.mktemp("llm"))))
    with Served(app, grpc=True) as s:
        yield s
    close_app(app)


@pytest.fixture
def tracer_on():
    tr = tracing.init_tracer(enabled=True)
    yield tr
    tracing.init_tracer(enabled=False)


BODIES = [
    {"prompt_tokens": [5, 17, 42], "max_new_tokens": 9},
    {"prompt_tokens": [9, 8, 7, 6, 5], "max_new_tokens": 7, "temperature": 0.9, "seed": 21},
]


def _gen_spans(tr, n_roots=1):
    """The ``generate`` roots and the ``gen.*`` spans, once ``n_roots``
    roots are recorded: a root ends as its stream's last chunk goes out,
    which may come a moment after the client has read it."""
    deadline = time.monotonic() + 10
    while True:
        spans = tr.finished_spans()
        roots = [s for s in spans if s.operation == "generate"]
        if len(roots) >= n_roots or time.monotonic() > deadline:
            return roots, [s for s in spans if s.operation.startswith("gen.")]
        time.sleep(0.005)


def _grpc_stream(served, body, metadata=None):
    import grpc

    from seldon_core_tpu_torch.payload import json_to_proto, proto_to_json
    from seldon_core_tpu_torch.proto import prediction_pb2 as pb
    from seldon_core_tpu_torch.proto.services import method_path

    with grpc.insecure_channel(f"127.0.0.1:{served.grpc_port}") as ch:
        rpc = ch.unary_stream(method_path("Seldon", "GenerateStream"),
                              request_serializer=lambda m: m.SerializeToString(),
                              response_deserializer=pb.SeldonMessage.FromString)
        return [proto_to_json(m)["jsonData"]
                for m in rpc(json_to_proto(body), timeout=120, metadata=metadata)]


def _assert_timeline_under(root, gen):
    """The four timeline spans are children of ``root`` and lie inside
    it (within a clock tick of rounding)."""
    assert {s.operation for s in gen} == {"gen.queue_wait", "gen.prefill",
                                         "gen.first_token", "gen.decode"}
    assert all(s.trace_id == root.trace_id and s.parent_id == root.span_id for s in gen)
    root_end = root.start_us + root.duration_us
    for s in gen:
        assert root.start_us - 2 <= s.start_us, s.operation
        assert s.start_us + s.duration_us <= root_end + 2, s.operation


@pytest.mark.parametrize("body", BODIES, ids=["greedy", "seeded"])
def test_streamed_spans_parent_under_the_generate_span(served, tracer_on, body):
    tracer_on.reset()
    status, _ctype, events = served.sse({"jsonData": body})
    assert status == 200 and events[-1]["done"]
    roots, gen = _gen_spans(tracer_on)
    assert len(roots) == 1
    root = roots[0]
    assert root.tags["prompt_tokens"] == len(body["prompt_tokens"])
    _assert_timeline_under(root, gen)
    by = {s.operation: s for s in gen}
    # the timeline runs in order, each span starting where the last ended
    # (within a clock tick of rounding)
    order = ["gen.queue_wait", "gen.prefill", "gen.first_token", "gen.decode"]
    for a, z in zip(order, order[1:]):
        assert abs(by[a].start_us + by[a].duration_us - by[z].start_us) <= 2
    assert by["gen.decode"].tags["tokens"] == body["max_new_tokens"]


@pytest.mark.parametrize("transport", ["sse", "grpc"])
def test_streamed_request_joins_the_callers_trace(served, tracer_on, transport):
    """A caller's ``uber-trace-id`` (an HTTP header, or gRPC metadata)
    makes the ``generate`` span its child, with the timeline under it."""
    tracer_on.reset()
    trace_id, parent = "00000000000000aa", "00000000000000bb"
    ctx = {tracing.TRACE_HEADER: f"{trace_id}:{parent}:0:1"}
    body = {"jsonData": BODIES[0]}
    if transport == "sse":
        status, _ctype, events = served.sse(body, headers=ctx)
        assert status == 200
    else:
        events = _grpc_stream(served, body, metadata=tuple(ctx.items()))
    assert events[-1]["done"]
    roots, gen = _gen_spans(tracer_on)
    assert len(roots) == 1
    root = roots[0]
    assert root.trace_id == trace_id and root.parent_id == parent
    _assert_timeline_under(root, gen)


def test_tracing_off_records_no_span_and_streams_the_same_bytes(served):
    off = []
    tr = tracing.init_tracer(enabled=False)
    for body in BODIES:
        off.append(served.sse({"jsonData": body})[2])
    assert tr.finished_spans() == []
    on = tracing.init_tracer(enabled=True)
    try:
        got = [served.sse({"jsonData": body})[2] for body in BODIES]
        assert len(_gen_spans(on, len(BODIES))[0]) == len(BODIES)
    finally:
        tracing.init_tracer(enabled=False)
    assert got == off


def test_unsampled_requests_grow_no_spans(served):
    tr = tracing.init_tracer(enabled=True)
    tr.sample_rate = 0.0
    try:
        status, _c, events = served.sse({"jsonData": BODIES[0]})
        assert status == 200 and events[-1]["done"]
        assert tr.finished_spans() == []
    finally:
        tracing.init_tracer(enabled=False)


def test_preempted_request_records_a_preempt_span(models, tracer_on):
    """A request the pressure ladder preempts records ``gen.preempt``
    under its submit span, and every timeline still completes."""
    from seldon_core_tpu_torch.resilience import FaultInjector

    from _torch_sched import PROMPTS

    b = port(models, hbm_ledger_bytes=1 << 40)
    try:
        with tracer_on.span("client") as root:
            futs = [b.submit(p, max_new_tokens=40) for p in PROMPTS]
        deadline = time.monotonic() + 60
        while len(b._active) < 2 and time.monotonic() < deadline:
            time.sleep(0.002)
        shrink = int(1.3 * b._attn_need(b.max_seq) * b._kv_key_bytes)
        b.pressure_hook = FaultInjector([], pressure={
            "shrink_to_bytes": shrink, "after_polls": b._work_poll_count + 1,
            "restore_after_polls": 12}).pressure_hook()
        for f in futs:
            f.result(timeout=120)
    finally:
        b.close()
    assert b.stats["preemptions"] >= 1, "the ladder preempted nothing"
    ops = [s.operation for s in tracer_on.finished_spans() if s.parent_id == root.span_id]
    assert ops.count("gen.preempt") == b.stats["preemptions"]
    assert ops.count("gen.decode") == len(PROMPTS)


# -- the device profile --------------------------------------------------------


def _trace(logdir):
    files = glob.glob(f"{logdir}/*.pt.trace.json")
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)


def _ranges_by_thread(trace):
    out = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            out.setdefault(e["tid"], set()).add(e["name"])
    return out


def test_profile_through_the_scheduler_holds_its_ranges(models, tmp_path):
    b = port(models, prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=4)
    try:
        b.start()
        tracing.start_device_profile(str(tmp_path))
        _serve(b, mixed(7, (4, 9, 13), max_new=6))
        tracing.stop_device_profile()
        sched = b._thread.native_id
    finally:
        b.close()
    by_tid = _ranges_by_thread(_trace(tmp_path))
    assert SCHED_RANGES <= by_tid.get(sched, set())
    assert {"gen.admit", "gen.decode_burst", "gen.credit", "gen.lane_insert"} <= by_tid[sched]


def test_profile_started_on_another_thread_holds_no_scheduler_range(models):
    """The finding the repair answers: a session started on a thread that
    is not the scheduler's (as a harness around the server starts it)
    records none of the scheduler's ranges."""
    b = port(models)
    try:
        b.start()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _serve(b, mixed(8, (4, 9), max_new=6))
    finally:
        b.close()
    names = {e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()}
    assert not names & (SCHED_RANGES | {"gen.decode_burst", "gen.admit"})


def test_profile_running_when_the_batcher_closes_is_written(models, tmp_path):
    b = port(models)
    b.start()
    tracing.start_device_profile(str(tmp_path))
    _serve(b, mixed(9, (4,), max_new=4))
    sched = b._thread.native_id
    b.close()  # the scheduler stops the session as its loop ends
    tracing.stop_device_profile()  # nothing left to stop: returns
    assert "gen.poll" in _ranges_by_thread(_trace(tmp_path))[sched]
    with pytest.raises(RuntimeError, match="no device profile"):
        tracing.stop_device_profile()


def test_device_trace_costs_one_check_without_a_session():
    assert tracing.device_trace("gen.poll") is tracing.device_trace("gen.read")


def test_span_and_range_of_one_interval_start_within_a_millisecond(models, tmp_path):
    """A ``Tracer`` span and a ``gen``-style range opened together on the
    scheduler thread, under a session it hosts."""
    tr = tracing.Tracer("t")
    b = port(models)
    try:
        b.start()
        tracing.start_device_profile(str(tmp_path))

        def probe():
            for i in range(5):
                with tr.span(f"probe{i}"), tracing.device_trace(f"probe{i}"):
                    torch.ones(64).sum()

        b.call_on_scheduler(probe).result(timeout=30)
        tracing.stop_device_profile()
    finally:
        b.close()
    trace = _trace(tmp_path)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    ranges = {e["name"]: base_us + e["ts"] for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    spans = {s.operation: s.start_us for s in tr.finished_spans()}
    assert len(spans) == 5 and set(spans) <= set(ranges)
    for name, start_us in spans.items():
        assert abs(ranges[name] - start_us) < 1000.0, name


# -- tools/trace_gaps.py -------------------------------------------------------


def _tool(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(name, ts, dur, cat, tid=7):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "pid": 1, "tid": tid}


def test_trace_gaps_attributes_idle_time_to_the_innermost_range():
    """Device work 0-10 and 30-40 and 60-100 us; the scheduler's poll
    0-100 holds a read 5-35 and a prefill 50-70 (which holds an insert
    62-66); another thread's range is not the scheduler's."""
    trace = {"traceEvents": [
        _x("k1", 0, 10, "kernel", 99), _x("k2", 30, 10, "gpu_memcpy", 99),
        _x("k3", 60, 40, "kernel", 99),
        _x("gen.poll", 0, 100, "user_annotation"), _x("gen.read", 5, 30, "user_annotation"),
        _x("gen.prefill", 50, 20, "user_annotation"),
        _x("gen.lane_insert", 62, 4, "user_annotation"),
        _x("gen.other_thread", 0, 100, "user_annotation", tid=8),
        _x("aten::mm", 0, 100, "cpu_op"),
    ]}
    got = _tool("trace_gaps").summarize(trace)
    assert got["scheduler_tid"] == 7
    assert got["window_s"] == pytest.approx(100e-6) and got["busy_s"] == pytest.approx(60e-6)
    # idle 10-30 (read) and 40-60 (poll 40-50, prefill 50-60)
    want = {"gen.read": 20e-6, "gen.poll": 10e-6, "gen.prefill": 10e-6, "outside": 0.0}
    assert got["idle_by_range"] == pytest.approx(want)
    assert got["in_gen_share"] == pytest.approx(1.0)
    assert got["ranges_s"]["gen.lane_insert"] == pytest.approx(4e-6)
    assert got["ranges_s"]["gen.prefill"] == pytest.approx(16e-6)


def test_trace_gaps_reads_a_trace_of_the_scheduler(models, tmp_path):
    """A CPU trace through the hook: the scheduler's ranges, no device
    work (nothing to attribute)."""
    b = port(models)
    try:
        b.start()
        tracing.start_device_profile(str(tmp_path))
        _serve(b, mixed(10, (5, 11), max_new=5))
        tracing.stop_device_profile()
        sched = b._thread.native_id
    finally:
        b.close()
    got = _tool("trace_gaps").summarize(_tool("trace_gaps").load(str(tmp_path)))
    assert got["scheduler_tid"] == sched and got["busy_s"] is None
    assert {"gen.poll", "gen.decode_burst", "gen.read"} <= set(got["ranges_s"])


def test_trace_gaps_reads_the_phases_and_the_hold_of_a_flight_dump(models, tmp_path, capsys):
    """``trace_gaps.py phases`` over a ``/flightrecorder`` payload: the
    phase shares sum to one, the hold's percentiles and mean sit inside
    TTFT's."""
    b = port(models)
    try:
        _serve(b, mixed(11, (4, 7), max_new=5))
        dump = {"entries": [], "slo": b.slo_summary(), "stats": dict(b.stats)}
    finally:
        b.close()
    path = tmp_path / "fr.json"
    path.write_text(json.dumps({"units": {"llm": dump}}))
    assert _tool("trace_gaps").main(["phases", str(path)]) == 0
    got = json.loads(capsys.readouterr().out)["llm"]
    assert set(got["sched_share"]) == {p[len("sched_s_"):] for p in _PHASES.values()}
    assert sum(got["sched_share"].values()) == pytest.approx(1.0)
    assert got["requests"] == 2
    assert 0.0 <= got["hold_ms"]["p50_ms"] <= dump["slo"]["ttft_ms"]["p50_ms"]
    assert 0.0 <= got["mean_hold_ms"] <= got["mean_ttft_ms"]
