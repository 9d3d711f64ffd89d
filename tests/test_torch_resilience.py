"""The port's resilience, tracing and engine-metrics modules against the
JAX package's, on the same inputs and seeds (CPU).

Deadline parsing, breaker state machines, retry backoffs, fault
schedules and the outcome sequence of a retried, breaker-guarded unit
under injected faults must be the JAX package's exactly; spans and their
propagation headers keep the same shape; the device hooks run on
``torch.profiler``.
"""

import asyncio
import json
import os
import random

import pytest
import torch

import seldon_core_tpu.graph.engine_metrics as jax_em
import seldon_core_tpu.metrics as jax_metrics
import seldon_core_tpu.resilience as jax_res
import seldon_core_tpu.tracing as jax_tracing
import seldon_core_tpu_torch.graph.engine_metrics as port_em
import seldon_core_tpu_torch.metrics as port_metrics
import seldon_core_tpu_torch.resilience as port_res
import seldon_core_tpu_torch.tracing as port_tracing
from _torch_engine import build_app, dispatch

torch.set_num_threads(1)

BOTH = [jax_res, port_res]


@pytest.mark.parametrize("headers,ann", [
    ({"seldon-deadline-ms": "250"}, None),
    ({"seldon-deadline-ms": "junk"}, {"seldon.io/deadline-ms": "400"}),
    ({"seldon-deadline-ms": "-5"}, None),
    ({}, {"seldon.io/deadline-ms": "0"}),
    (None, None),
])
def test_deadline_from_request_equals_jax(headers, ann):
    got = [res.deadline_from_request(headers, ann) for res in BOTH]
    if got[0] is None:
        assert got[1] is None
    else:
        assert abs(got[0].remaining_ms() - got[1].remaining_ms()) <= 5


def test_deadline_meta_roundtrip_equals_jax():
    for res in BOTH:
        d = res.Deadline.after_ms(1000)
        stamped = res.stamp_meta({"data": {}, "meta": {"puid": "x"}}, d)
        assert set(stamped["meta"]) == {"puid", "deadlineMs"}
        assert 0.9 < res.deadline_s_from_meta(stamped["meta"]) <= 1.0
        assert res.stamp_meta({"a": 1}, None) == {"a": 1}
    for meta in ({"deadlineMs": "12"}, {"deadlineMs": "x"}, {}, None, {"deadlineMs": -3}):
        assert jax_res.deadline_s_from_meta(meta) == port_res.deadline_s_from_meta(meta)
    assert port_res.DeadlineExceeded.status == 504 and port_res.ShedError("x").status == 429


def _breaker_trace(res, script):
    clock = {"t": 0.0}
    transitions = []
    b = res.CircuitBreaker(window=4, error_rate=0.5, min_calls=2, open_s=1.0,
                           time_fn=lambda: clock["t"],
                           on_transition=lambda a, z: transitions.append((a, z)))
    out = []
    for step in script:
        if step == "tick":
            clock["t"] += 0.6
            continue
        allowed = b.allow()
        out.append((allowed, b.state))
        if allowed:
            {"ok": b.record_success, "fail": b.record_failure, "drop": b.abandon}[step]()
    return out, transitions


def test_breaker_state_machine_equals_jax():
    script = ["ok", "fail", "fail", "fail", "ok", "tick", "ok", "tick", "fail", "tick",
              "tick", "drop", "ok", "ok", "fail", "ok", "fail", "fail", "tick", "tick", "ok"]
    assert _breaker_trace(port_res, script) == _breaker_trace(jax_res, script)


@pytest.mark.parametrize("ann", [
    {"seldon.io/retries": "3", "seldon.io/retry-backoff-ms": "10"},
    {"seldon.io/retries.m": "2", "seldon.io/retries": "5"},
    {},
])
def test_retry_and_hedge_policies_equal_jax(ann):
    got = [res.RetryPolicy.from_annotations(ann, "m") for res in BOTH]
    assert (got[0] is None) == (got[1] is None)
    if got[0] is not None:
        assert vars(got[0]) == vars(got[1])
        rngs = [random.Random("retry/0/m"), random.Random("retry/0/m")]
        assert [got[0].backoff_s(i, rngs[0]) for i in range(5)] == \
            [got[1].backoff_s(i, rngs[1]) for i in range(5)]
    hedge_ann = {**ann, "seldon.io/hedge": "true", "seldon.io/hedge-delay-ms": "30"}
    hedges = [res.HedgePolicy.from_annotations(hedge_ann, "m", "REST", "MODEL")
              for res in BOTH]
    assert vars(hedges[0]) == vars(hedges[1])
    for res in BOTH:
        assert res.HedgePolicy.from_annotations(hedge_ann, "m", "INPROCESS", "MODEL") is None
        with pytest.raises(ValueError):
            res.RetryPolicy.from_annotations({"seldon.io/retries": "3x"}, "m")


class _Ok:
    async def call(self, method, message):
        return {"ok": True}

    async def ready(self):
        return True

    async def close(self):
        pass


def _fault_schedule(res, rules, seed, n=40):
    inj = res.FaultInjector(rules, seed=seed)
    client = inj.wrap(_Ok(), "m")

    async def run():
        out = []
        for _ in range(n):
            try:
                await client.call("predict", {})
                out.append("ok")
            except res.InjectedFault as e:
                out.append(e.status)
        return out

    return asyncio.run(run()), inj.injected


@pytest.mark.parametrize("rules,seed", [
    ([{"unit": "m", "error_rate": 0.3}], 7),
    ([{"unit": "*", "fail_first": 3, "error_rate": 0.1, "error_status": 500}], 1),
    ([{"unit": "m", "method": "predict", "error_rate": 0.5, "jitter_ms": 0.01},
      {"unit": "m", "error_rate": 0.2, "error_status": 429}], 3),
])
def test_fault_schedule_equals_jax(rules, seed):
    assert _fault_schedule(port_res, rules, seed) == _fault_schedule(jax_res, rules, seed)


def test_retry_breaker_under_faults_equals_jax():
    """One engine per package over a SIMPLE_MODEL unit with retries and
    a breaker, the same seeded fault schedule: the same status, request
    after request."""
    ann = {"seldon.io/retries": "2", "seldon.io/retry-backoff-ms": "1",
           "seldon.io/retry-max-backoff-ms": "2", "seldon.io/breaker": "true",
           "seldon.io/breaker-window": "6", "seldon.io/breaker-min-calls": "3",
           "seldon.io/breaker-error-rate": "0.6", "seldon.io/breaker-open-ms": "600000"}
    rules = [{"unit": "m", "error_rate": 0.45}]
    seqs = {}
    for name, res in (("jax", jax_res), ("port", port_res)):
        pkg = res.__name__.rsplit(".", 1)[0]
        app = build_app(pkg, {"name": "m", "implementation": "SIMPLE_MODEL"}, ann,
                        faults=res.FaultInjector(rules, seed=11))
        rest = app.rest_app()
        seqs[name] = [dispatch(rest, "/api/v0.1/predictions",
                               {"data": {"ndarray": [[1.0]]}})[0] for _ in range(25)]
        seqs[name + "_retries"] = app.metrics.counter_total("seldon_engine_unit_retries")
        seqs[name + "_open"] = app.metrics.counter_total(
            "seldon_engine_breaker_transitions", {"to": "open"})
    assert seqs["port"] == seqs["jax"]
    assert {200, 503} <= set(seqs["port"])  # both outcomes occur
    assert seqs["port_retries"] == seqs["jax_retries"] > 0
    assert seqs["port_open"] == seqs["jax_open"] == 1


def test_faults_from_env_and_not_ported_fields(tmp_path):
    cfg = {"seed": 4, "rules": [{"unit": "m", "error_rate": 0.5}],
           "scheduler": {"die_after_polls": 3, "times": 2}}
    path = tmp_path / "faults.json"
    path.write_text(json.dumps(cfg))
    for env in ({"SELDON_FAULTS": json.dumps(cfg)}, {"SELDON_FAULTS": f"@{path}"}):
        inj = port_res.FaultInjector.from_env(env)
        assert inj.seed == 4 and inj.rules[0].error_rate == 0.5
    assert port_res.FaultInjector.from_env({}) is None
    hooks = [res.FaultInjector([], scheduler=cfg["scheduler"]).scheduler_hook() for res in BOTH]
    deaths = [[], []]
    for poll in range(1, 12):
        for i, hook in enumerate(hooks):
            try:
                hook(poll)
            except Exception:  # noqa: BLE001 - the injected poll death
                deaths[i].append(poll)
    assert deaths[0] == deaths[1] == [3, 6]
    with pytest.raises(NotImplementedError, match="KV-transport"):
        port_res.FaultInjector([{"unit": "*", "kv_corrupt_rate": 0.5}])
    # the pressure section (ported now): both packages' hooks re-budget
    # the ledger on the same working polls
    pressure = {"shrink_to_bytes": 4096, "after_polls": 3, "restore_after_polls": 5}
    phooks = [res.FaultInjector([], pressure=pressure).pressure_hook() for res in BOTH]
    seqs = [[hook(poll) for poll in range(1, 12)] for hook in phooks]
    assert seqs[0] == seqs[1]
    assert [v for v in seqs[1] if v is not None] == [4096, -1]


def test_ewma_equals_jax():
    a, b = jax_metrics.Ewma(alpha=0.2), port_metrics.Ewma(alpha=0.2)
    for x in (0.5, 0.1, 0.9, 0.3, 0.3):
        assert a.update(x) == b.update(x)


def test_record_custom_exposition_equals_jax():
    """The generate server's metric keys land in the same series, with
    the same values, in both registries."""
    metrics = [
        {"key": "gen_tokens", "type": "COUNTER", "value": 12},
        {"key": "gen_prefill_steps", "type": "COUNTER", "value": 2},
        {"key": "gen_decode_steps", "type": "COUNTER", "value": 8},
        {"key": "gen_prefill_tokens", "type": "COUNTER", "value": 64},
        {"key": "gen_batcher_restarts", "type": "COUNTER", "value": 1},
        {"key": "gen_batcher_healthy", "type": "GAUGE", "value": 1.0},
        {"key": "gen_ttft_ms", "type": "TIMER", "value": 12.5},
        {"key": "gen_tpot_ms", "type": "TIMER", "value": 3.0},
        {"key": "gen_queue_wait_ms", "type": "TIMER", "value": 0.5},
        {"key": "gen_shed_total", "type": "COUNTER", "value": 1, "tags": {"unit": "llm"}},
    ]
    texts = []
    for em in (jax_em, port_em):
        reg = em.MetricsRegistry()
        reg.record_custom(metrics, {"deployment": "d"})
        reg.observe("seldon_api_engine_server_requests_seconds", 0.02, {"deployment": "d"})
        texts.append(sorted(reg.expose().splitlines()))
        assert reg.counter_total("seldon_engine_generate_steps", {"phase": "decode"}) == 8
        assert reg.histogram_totals("seldon_engine_generate_ttft_seconds") == (0.0125, 1.0)
        assert reg.quantile("seldon_engine_generate_tpot_seconds", 0.5,
                            {"deployment": "d"}) == 0.005
    assert texts[0] == texts[1]


def test_tracer_spans_and_headers_match_jax():
    shapes = []
    for tr_mod in (jax_tracing, port_tracing):
        tracer = tr_mod.Tracer("svc")
        with tracer.span("root", tags={"a": 1}) as root:
            headers = tracer.inject({})
            with tracer.span("child"):
                pass
        child_of_remote = None
        with tracer.span("remote-child", headers=headers) as s:
            child_of_remote = s
        assert child_of_remote.trace_id == root.trace_id
        assert tracer.extract({tr_mod.TRACE_HEADER: "a:b:0:0"}) is not None
        recorded = tracer.record_span("gen.decode", root.trace_id, root.span_id, 5, 7)
        assert recorded.parent_id == root.span_id
        data = tracer.export_jaeger()["data"]
        shapes.append((len(data), sorted(s["operationName"] for s in data[0]["spans"]),
                       headers[tr_mod.TRACE_HEADER].count(":"),
                       sorted(data[0]["spans"][0])))
        off = tr_mod.Tracer("svc", sample_rate=0.0)
        with off.span("dropped"):
            assert off.inject({})[tr_mod.TRACE_HEADER].endswith(":0")
        assert off.finished_spans() == []
    assert shapes[0] == shapes[1]


def test_device_trace_names_work_in_torch_profiler(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with port_tracing.device_trace("gen.prefill"):
            torch.ones(4).sum()
    assert any(e.key == "gen.prefill" for e in prof.key_averages())
    port_tracing.start_device_profile(str(tmp_path))
    with pytest.raises(RuntimeError, match="already running"):
        port_tracing.start_device_profile(str(tmp_path))
    with port_tracing.device_trace("gen.lane_insert"):
        torch.ones(4).sum()
    port_tracing.stop_device_profile()
    files = os.listdir(tmp_path)
    assert files and all(f.endswith(".pt.trace.json") for f in files)
    with pytest.raises(RuntimeError, match="no device profile"):
        port_tracing.stop_device_profile()


def test_init_tracer_reads_env(monkeypatch):
    monkeypatch.setenv("TRACING", "1")
    monkeypatch.setenv("JAEGER_SAMPLER_TYPE", "probabilistic")
    monkeypatch.setenv("JAEGER_SAMPLER_PARAM", "0.25")
    monkeypatch.delenv("JAEGER_AGENT_HOST", raising=False)
    try:
        tracer = port_tracing.init_tracer("svc")
        assert tracer.enabled and tracer.sample_rate == 0.25 and tracer.exporter is None
        assert port_tracing.get_tracer() is tracer
    finally:
        monkeypatch.setenv("TRACING", "0")
        port_tracing.init_tracer()


def test_scheduler_faults_from_env_restart_the_batcher(tmp_path, monkeypatch):
    """SELDON_FAULTS' scheduler section kills the port's batcher loop on
    its poll count; the supervisor restarts it and requests succeed."""
    from _torch_engine import make_model_dir
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    monkeypatch.setenv("SELDON_FAULTS", json.dumps(
        {"scheduler": {"die_after_polls": 2, "times": 1}}))
    gen = GenerateServer(model_uri=make_model_dir(tmp_path), device="cpu", slots=2,
                         restart_backoff_s=0.01)
    gen.load()
    try:
        import time

        t0 = time.monotonic()
        while gen.batcher.stats["batcher_restarts"] < 1 and time.monotonic() - t0 < 60:
            time.sleep(0.01)
        assert gen.batcher.stats["batcher_restarts"] == 1
        out = gen.predict({"prompt_tokens": [1, 2], "max_new_tokens": 3}, [])
        assert out["tokens"][0][:2] == [1, 2] and len(out["tokens"][0]) == 5
    finally:
        gen.close()
