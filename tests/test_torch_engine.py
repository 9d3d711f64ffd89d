"""The port's inference-graph engine (seldon_core_tpu_torch.graph) against
the JAX package's engine on the same specs, on the CPU.

Generate graphs (one GENERATE_SERVER unit; RAG_PROMPT_BUILDER ->
GENERATE_SERVER) load the same tiny float32 weights in both engines
(``_torch_engine.make_model_dir``): tokens must be equal, greedy and
seeded. Builtin graphs must give equal ``data`` and equal
``meta.routing``/``meta.requestPath``. Each JAX reference request runs
alone (ROADMAP.md queue C).
"""

import asyncio
import json
import re

import pytest
import torch

from _torch_engine import (
    build_app,
    build_spec,
    close_app,
    dispatch,
    gen_unit,
    generator_of,
    make_model_dir,
    rag_graph,
)

torch.set_num_threads(1)

JAX, PORT = "seldon_core_tpu", "seldon_core_tpu_torch"
PRED = "/api/v0.1/predictions"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("llm"))


@pytest.fixture(scope="module")
def engines(model_dir):
    """(JAX app, port app) serving one GENERATE_SERVER unit."""
    apps = [build_app(pkg, gen_unit(model_dir)) for pkg in (JAX, PORT)]
    yield apps
    for app in apps:
        close_app(app)


REQUESTS = [
    {"prompt_tokens": [5, 17, 42], "max_new_tokens": 6},
    {"prompt_tokens": [1, 2, 3, 4, 5, 6, 7, 8, 9], "max_new_tokens": 9,
     "temperature": 0.8, "seed": 4},
    {"prompt_tokens": list(range(30, 60)), "max_new_tokens": 5,
     "temperature": 1.2, "seed": 11},
]


@pytest.mark.parametrize("body", REQUESTS)
def test_single_unit_generate_equals_jax(engines, body):
    jax_app, port_app = engines
    want_status, want = dispatch(jax_app.rest_app(), PRED, {"jsonData": body})
    status, got = dispatch(port_app.rest_app(), PRED, {"jsonData": body})
    assert status == want_status == 200
    assert got["jsonData"] == want["jsonData"]
    assert got["meta"]["requestPath"] == want["meta"]["requestPath"] == {
        "llm": "GENERATE_SERVER"}


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.9, 5)])
def test_two_unit_rag_graph_equals_jax_and_single_unit(model_dir, engines, temperature, seed):
    """The executor's walk and the jsonData handoff between hops: the
    transformer's generate body reaches the generate unit intact."""
    doc = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3, 8, 4]]
    graph = rag_graph(model_dir, max_new_tokens=7, temperature=temperature, seed=seed)
    outs = {}
    for pkg in (JAX, PORT):
        app = build_app(pkg, graph)
        try:
            outs[pkg] = dispatch(app.rest_app(), PRED, {"data": {"ndarray": doc}})
        finally:
            close_app(app)
    (js, jout), (ps, pout) = outs[JAX], outs[PORT]
    assert js == ps == 200
    assert pout["jsonData"]["tokens"] == jout["jsonData"]["tokens"]
    assert pout["meta"]["requestPath"] == jout["meta"]["requestPath"]
    single = dispatch(engines[1].rest_app(), PRED, {"jsonData": {
        "prompt_tokens": doc[0], "max_new_tokens": 7, "temperature": temperature,
        "seed": seed}})[1]
    assert pout["jsonData"]["tokens"] == single["jsonData"]["tokens"]


ABTEST = {"name": "ab", "implementation": "RANDOM_ABTEST", "children": [
    {"name": "a", "implementation": "SIMPLE_MODEL"},
    {"name": "b", "implementation": "SIMPLE_MODEL"}]}
COMBINER = {"name": "avg", "implementation": "AVERAGE_COMBINER", "children": [
    {"name": "m1", "implementation": "SIMPLE_MODEL"},
    {"name": "m2", "implementation": "SIMPLE_MODEL"}]}
NESTED = {"name": "ab", "implementation": "RANDOM_ABTEST",
          "parameters": [{"name": "ratio_a", "value": "0.3", "type": "FLOAT"}],
          "children": [{"name": "r", "implementation": "SIMPLE_ROUTER",
                        "children": [{"name": "a", "implementation": "SIMPLE_MODEL"}]},
                       COMBINER]}
BUILTIN = {"simple_model": {"name": "m", "implementation": "SIMPLE_MODEL"},
           "random_abtest": ABTEST, "average_combiner": COMBINER, "nested": NESTED}


@pytest.mark.parametrize("name", sorted(BUILTIN))
def test_builtin_graph_equals_jax(name):
    """Same data, routing and request path, request after request (the
    A/B router draws from Random(1337) in both engines)."""
    bodies = [{"data": {"ndarray": [[1.0, 2.0]]}},
              {"data": {"names": ["x", "y"], "ndarray": [[1.0, 2.0], [3.0, 4.0]]}}] * 4
    seqs = {}
    for pkg in (JAX, PORT):
        rest = build_app(pkg, BUILTIN[name]).rest_app()
        seqs[pkg] = [dispatch(rest, PRED, b) for b in bodies]
    for (js, jout), (ps, pout) in zip(seqs[JAX], seqs[PORT]):
        assert js == ps == 200
        assert pout["data"] == jout["data"]
        for key in ("routing", "requestPath"):
            assert pout["meta"].get(key) == jout["meta"].get(key)


def test_feedback_walk_equals_jax():
    for pkg in (JAX, PORT):
        app = build_app(pkg, ABTEST)
        rest = app.rest_app()
        _s, out = dispatch(rest, PRED, {"data": {"ndarray": [[1.0]]}})
        status, fb = dispatch(rest, "/api/v0.1/feedback",
                              {"request": {}, "response": out, "reward": 1.0})
        assert status == 200 and fb["meta"]["tags"]["reward"] == 1.0


def _series(text):
    return {m.group(1) for m in re.finditer(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)", text, re.M)
            if not text[m.start():].startswith("#")}


def test_prometheus_series_equal_jax_builtin():
    names = {}
    for pkg in (JAX, PORT):
        rest = build_app(pkg, COMBINER).rest_app()
        dispatch(rest, PRED, {"data": {"ndarray": [[1.0, 2.0]]}})
        status, text = dispatch(rest, "/prometheus", method="GET")
        assert status == 200
        names[pkg] = _series(text.decode())
    assert names[PORT] == names[JAX]
    assert "seldon_api_engine_server_requests" in names[PORT]


def test_prometheus_series_generate_graph(engines):
    """The engine's own series and the generate SLO histograms are the
    JAX engine's; of the generate server's custom series the port ships
    a subset, the modelled burst reads and read bytes among them."""
    names = {}
    for app in engines:
        rest = app.rest_app()
        dispatch(rest, PRED, {"jsonData": {"prompt_tokens": [7, 8], "max_new_tokens": 3}})
        names[app] = _series(dispatch(rest, "/prometheus", method="GET")[1].decode())
    jax_names, port_names = names[engines[0]], names[engines[1]]
    def own(ns):
        return {n for n in ns if not n.startswith("seldon_custom_")}
    assert own(port_names) == own(jax_names)
    assert port_names - own(port_names) <= jax_names - own(jax_names)
    assert "seldon_engine_generate_ttft_seconds_bucket" in port_names
    assert {"seldon_custom_gen_burst_reads", "seldon_custom_gen_burst_read_bytes"} \
        <= port_names & jax_names


@pytest.mark.parametrize("shed", [False, True])
def test_generate_deadline_refusal_equals_jax(engines, shed):
    """A 1 ms budget cannot cover a generate request. With shedding on
    and a service time already observed, both engines refuse it before
    work (429, load-shed counter); with shedding off, the walk runs out
    of budget (504, deadline counter, partial request path)."""
    body = {"jsonData": {"prompt_tokens": [5, 17, 42], "max_new_tokens": 40}}
    hdr = {"seldon-deadline-ms": "1"}
    want = 429 if shed else 504
    counter = "seldon_engine_load_shed" if shed else "seldon_engine_deadline_exceeded"
    for app in engines:
        rest = app.rest_app()
        assert dispatch(rest, PRED, {"jsonData": {"prompt_tokens": [1], "max_new_tokens": 2}})[0] == 200
        before = app.metrics.counter_total(counter)
        app.shed_on_deadline = shed
        try:
            status, out = dispatch(rest, PRED, body, headers=hdr)
        finally:
            app.shed_on_deadline = True
        assert status == want, (type(app).__module__, out)
        assert app.metrics.counter_total(counter) == before + 1
        if not shed:
            assert out["meta"]["requestPath"] == {"llm": "GENERATE_SERVER"}


def test_generate_deadline_frees_the_lane(engines):
    """Past its deadline a request is cancelled and its decode lane
    freed: the batcher counts it cancelled, and the next request runs."""
    gen = generator_of(engines[1])
    b = gen.batcher
    cancelled = b.stats["cancelled"]
    fut = b.submit([5, 17, 42], max_new_tokens=50, deadline_s=0.0)
    with pytest.raises(BaseException):
        fut.result(timeout=60)
    assert fut.cancelled()
    import time

    t0 = time.monotonic()
    while b.stats["cancelled"] == cancelled and time.monotonic() - t0 < 30:
        time.sleep(0.01)
    assert b.stats["cancelled"] == cancelled + 1
    assert b.submit([1, 2], max_new_tokens=3).result(timeout=60)[:2] == [1, 2]


class Slow:
    def __init__(self, delay):
        self.delay = delay

    def predict(self, X, names, meta=None):
        import time

        time.sleep(self.delay)
        return X


def _slow_app(pkg, annotations=None, delay=0.05):
    graph = {"name": "m", "type": "MODEL"}
    return build_app(pkg, graph, annotations, registry={"m": Slow(delay)})


def test_deadline_shed_429_equals_jax():
    """Once a service time is observed, a budget below it is shed before
    work with 429 + Retry-After (predict path and header gate alike)."""
    for pkg in (JAX, PORT):
        app = _slow_app(pkg)
        rest = app.rest_app()
        assert dispatch(rest, PRED, {"data": {"ndarray": [[1.0]]}})[0] == 200
        status, out = dispatch(rest, PRED, {"data": {"ndarray": [[1.0]]}},
                               headers={"seldon-deadline-ms": "5"})
        assert status == 429, (pkg, out)
        assert "shed before work" in out["status"]["info"]
        gate = rest.early_gate("POST", PRED, {"seldon-deadline-ms": "5"})
        assert gate.status == 429 and gate.headers["Retry-After"] == "1"
        assert app.metrics.counter_total("seldon_engine_load_shed") == 2


def test_max_inflight_429_equals_jax():
    async def burst(app):
        msgs = [app.predict({"data": {"ndarray": [[1.0]]}}) for _ in range(3)]
        return await asyncio.gather(*msgs, return_exceptions=True)

    outcomes = {}
    for pkg in (JAX, PORT):
        app = _slow_app(pkg, {"seldon.io/max-inflight": "1"}, delay=0.2)
        res = asyncio.run(burst(app))
        outcomes[pkg] = sorted(getattr(r, "status", 200) for r in res)
    assert outcomes[PORT] == outcomes[JAX] == [200, 429, 429]


def test_batcher_admit_queue_shed_is_429(model_dir, monkeypatch):
    """admit_queue_limit (ported now): a submit while the admit queue
    holds its cap is a ShedError, which the engine answers 429 and
    counts as load shed."""
    from seldon_core_tpu_torch.resilience import ShedError

    unit = gen_unit(model_dir)
    unit["parameters"] = unit["parameters"] + [
        {"name": "admit_queue_limit", "value": "1", "type": "INT"}]
    app = build_app(PORT, unit)
    try:
        b = generator_of(app).batcher
        assert b.admit_queue_limit == 1
        assert b.submit([1, 2], max_new_tokens=2).result(timeout=60)[:2] == [1, 2]
        monkeypatch.setattr(b._queue, "qsize", lambda: 1)  # one queued request
        with pytest.raises(ShedError, match="admit queue full"):
            b.submit([1, 2], max_new_tokens=2)
        status, out = dispatch(app.rest_app(), PRED, {"jsonData": {
            "prompt_tokens": [1, 2], "max_new_tokens": 2}})
        assert status == 429 and "admit queue full" in out["status"]["info"]
        assert app.metrics.counter_total("seldon_engine_load_shed") == 1
        assert b.stats["shed"] == 2
    finally:
        close_app(app)


def test_batcher_deadline_shed_matches_jax_rule(engines, monkeypatch):
    """The batcher's deadline rule, as the JAX batcher's: expected queue
    wait (depth over the observed completion rate) beyond the budget is
    shed before work; a budget that covers it is admitted."""
    from seldon_core_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
    from seldon_core_tpu_torch.resilience import ShedError

    b = generator_of(engines[1]).batcher
    monkeypatch.setattr(b, "_finish_times", [0.0, 0.5, 1.0])  # 2 completions/s
    monkeypatch.setattr(b._queue, "qsize", lambda: 4)  # 2 s of expected wait
    assert b.observed_rate() == JaxBatcher.observed_rate(b) == 2.0
    shed = b.stats["shed"]
    with pytest.raises(ShedError, match="shed before work") as e:
        b.submit([1, 2], max_new_tokens=2, deadline_s=1.5)
    assert e.value.retry_after_s == 2.0 and b.stats["shed"] == shed + 1
    with pytest.raises(ShedError):
        generator_of(engines[1]).predict(
            {"prompt_tokens": [1, 2], "max_new_tokens": 2}, [], meta={"deadlineMs": 1500})
    monkeypatch.setattr(b._queue, "qsize", lambda: 0)
    assert b.submit([1, 2], max_new_tokens=2, deadline_s=1.5).result(timeout=60)[:2] == [1, 2]


@pytest.mark.parametrize("annotation", [
    ("seldon.io/disagg-prefill-replicas", "2"), ("seldon.io/disagg", "true"),
    ("seldon.io/kv-tier-bytes", "1024"), ("seldon.io/mesh", "data=1,model=2"),
    ("seldon.io/tenants", "a=strict"), ("seldon.io/planner", "true"),
])
def test_not_ported_annotations_raise(annotation):
    """Only sharded serving (``seldon.io/mesh``) is still refused as not
    ported. The disagg, KV-tier, tenants and planner annotations are
    validated as the JAX engine validates them: on this SIMPLE_MODEL
    graph each gives the JAX package's verdict, word for word."""
    from seldon_core_tpu_torch.graph.spec import GraphSpecError

    graph = {"name": "m", "implementation": "SIMPLE_MODEL"}
    if annotation[0] == "seldon.io/mesh":
        with pytest.raises(GraphSpecError, match="not ported"):
            build_spec(PORT, graph, dict([annotation]))
    else:
        verdicts = []
        for pkg in (JAX, PORT):
            try:
                build_spec(pkg, graph, dict([annotation]))
                verdicts.append(None)
            except Exception as e:  # noqa: BLE001 - the verdict is the datum
                verdicts.append((type(e).__name__, str(e)))
        assert verdicts[1] == verdicts[0]
        assert verdicts[1] is None or "not ported" not in verdicts[1][1]
    # the off values are accepted
    build_spec(PORT, graph, {"seldon.io/fuse": "false", "seldon.io/planner": "false"})


def test_junk_fuse_annotation_refused():
    """``seldon.io/fuse`` takes "true" or "false" only (any case): junk
    fails the apply and the executor's construction, as in the JAX
    engine."""
    from seldon_core_tpu_torch.graph.executor import GraphExecutor
    from seldon_core_tpu_torch.graph.spec import GraphSpecError, PredictorSpec

    graph = {"name": "m", "implementation": "SIMPLE_MODEL"}
    for pkg in (JAX, PORT):
        with pytest.raises(Exception, match="seldon.io/fuse"):
            build_spec(pkg, graph, {"seldon.io/fuse": "yes"})
    spec = PredictorSpec.from_dict(
        {"name": "p", "graph": graph, "annotations": {"seldon.io/fuse": "on"}})
    with pytest.raises(GraphSpecError, match="seldon.io/fuse"):
        GraphExecutor(spec)
    build_spec(PORT, graph, {"seldon.io/fuse": "TRUE"})


@pytest.mark.parametrize("kind", ["fuse", "microbatch", "mesh", "server"])
def test_not_ported_engine_options_raise(kind, monkeypatch):
    """A device mesh raises "not ported". Graph fusion is ported: alone it
    builds a plan (a single-unit graph has no segment), and beside
    micro-batching it builds and counts the micro-batched unit's
    ``microbatch`` plan reason. The prepackaged servers are ported: a
    SKLEARN_SERVER unit resolves and, without joblib, raises the JAX
    engine's ImportError naming it."""
    from seldon_core_tpu_torch.graph.batching import batching_from_annotations
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
    from seldon_core_tpu_torch.graph.executor import GraphExecutor
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    graph = {"name": "m", "implementation": "SIMPLE_MODEL"}
    ann = {}
    if kind in ("fuse", "microbatch"):
        ann = {"seldon.io/fuse": "true"}
        if kind == "microbatch":
            ann["seldon.io/microbatch"] = "true"
            graph = {"name": "m", "type": "MODEL"}
        spec = PredictorSpec.from_dict({"name": "p", "graph": graph, "annotations": ann})
        metrics = MetricsRegistry()
        ex = GraphExecutor(spec, registry={"m": _Doubler()}, metrics=metrics,
                           batching=batching_from_annotations(spec))
        assert ex.fusion is not None and ex.fusion.segments == {}
        want = 1.0 if kind == "microbatch" else 0.0
        assert metrics.counter_total("seldon_engine_fusion_fallbacks",
                                     {"unit": "m", "reason": "microbatch"}) == want
        out = asyncio.run(ex.predict({"data": {"ndarray": [[1.0, 2.0]]}}))
        assert out["data"]["ndarray"] == [[2.0, 4.0]]
        asyncio.run(ex.close())
        return
    if kind == "server":
        import sys

        from seldon_core_tpu.graph.executor import GraphExecutor as JaxGraphExecutor
        from seldon_core_tpu.graph.spec import PredictorSpec as JaxPredictorSpec

        monkeypatch.setitem(sys.modules, "joblib", None)
        graph = {"name": "m", "implementation": "SKLEARN_SERVER", "modelUri": "/x"}
        errors = []
        for ex, ps in ((JaxGraphExecutor, JaxPredictorSpec), (GraphExecutor, PredictorSpec)):
            with pytest.raises(ImportError, match="joblib") as e:
                ex(ps.from_dict({"name": "p", "graph": graph}))
            errors.append(e.value)
        assert type(errors[1]) is type(errors[0]) and "not ported" not in str(errors[1])
        return
    spec = PredictorSpec.from_dict({"name": "p", "graph": graph, "annotations": ann})
    with pytest.raises(NotImplementedError, match="not ported"):
        GraphExecutor(spec, mesh=object())


class _Doubler:
    def predict(self, X, names, meta=None):
        import numpy as np

        return np.asarray(X) * 2


@pytest.mark.parametrize("path", ["/flightrecorder", "/fleet", "/openapi.json", "/retune"])
def test_not_ported_routes_answer_501(path):
    """These routes are all ported now; on a graph without a generate unit
    they answer as the JAX engine's: /openapi.json 200 with the JAX
    engine's document, no recorder 404, the fleet snapshot 200, a retune
    without knobs 400."""
    rest = build_app(PORT, {"name": "m", "implementation": "SIMPLE_MODEL"}).rest_app()
    status, out = dispatch(rest, path, {})
    jax_status, jax_out = dispatch(
        build_app(JAX, {"name": "m", "implementation": "SIMPLE_MODEL"}).rest_app(), path, {})
    assert status == jax_status == {"/flightrecorder": 404, "/fleet": 200,
                                    "/openapi.json": 200, "/retune": 400}[path]
    if path == "/openapi.json":
        assert out == jax_out and set(out["paths"]) == set(rest.routes)


@pytest.mark.parametrize("path,body", [
    ("/weights/swap", {"model_uri": "/x"}), ("/weights/swap", {"cancel": True}),
    ("/drain", {"to": "127.0.0.1:1"}), ("/drain", {"checkpoints": []}),
])
def test_swap_and_drain_routes_without_a_generate_unit_answer_501(path, body):
    """The routes are ported; a graph with no unit that can swap or
    migrate answers 501 as the JAX engine does."""
    for pkg in (JAX, PORT):
        rest = build_app(pkg, {"name": "m", "implementation": "SIMPLE_MODEL"}).rest_app()
        status, out = dispatch(rest, path, body)
        assert status == 501 and "no unit supports" in out["status"]["info"]


def test_swap_and_drain_routes_equal_jax(model_dir):
    """/weights/swap and /drain on a generate graph answer as the JAX
    engine's: a missing model_uri or peer is a 400, a cancel with
    nothing staged reports it, a same-architecture swap flips (both
    engines load the same checkpoint: the tokens after it stay equal)."""
    apps = [build_app(pkg, gen_unit(model_dir)) for pkg in (JAX, PORT)]
    try:
        _swap_and_drain_routes(apps, model_dir)
    finally:
        for app in apps:
            close_app(app)


def _swap_and_drain_routes(engines, model_dir):
    jax_app, port_app = engines
    for path, body in (("/weights/swap", {}), ("/drain", {})):
        want = dispatch(jax_app.rest_app(), path, body)
        got = dispatch(port_app.rest_app(), path, body)
        assert got[0] == want[0] == 400
    want = dispatch(jax_app.rest_app(), "/weights/swap", {"cancel": True})
    got = dispatch(port_app.rest_app(), "/weights/swap", {"cancel": True})
    assert got == want == (200, {"units": {"llm": {"cancelled": False, "weight_version": 0}}})
    swapped = []
    for app in engines:
        status, out = dispatch(app.rest_app(), "/weights/swap", {"model_uri": model_dir})
        assert status == 200, out
        swapped.append(out["units"]["llm"])
    assert swapped[0] == swapped[1]
    assert swapped[1]["swapped"] and swapped[1]["weight_version"] == "v1"
    body = {"jsonData": REQUESTS[1]}
    assert dispatch(port_app.rest_app(), PRED, body)[1]["jsonData"] == dispatch(
        jax_app.rest_app(), PRED, body)[1]["jsonData"]


def test_tenant_header_and_resume_token_answer_501(engines):
    """Both are ported: a single-tenant server serves a request carrying
    the Seldon-Tenant header as the JAX engine does (the id rides the
    meta, unused), and a malformed resume token answers 400, as the
    JAX engine's."""
    jax_app, port_app = engines
    body = {"jsonData": {"prompt_tokens": [1, 2], "max_new_tokens": 2}}
    want = dispatch(jax_app.rest_app(), PRED, body, headers={"seldon-tenant": "a"})
    got = dispatch(port_app.rest_app(), PRED, body, headers={"seldon-tenant": "a"})
    assert got[0] == want[0] == 200
    assert got[1]["jsonData"] == want[1]["jsonData"]
    body = {"jsonData": {"resume_token": "x", "max_new_tokens": 2}}
    assert dispatch(port_app.rest_app(), PRED, body)[0] == dispatch(
        jax_app.rest_app(), PRED, body)[0] == 400


def test_routes_and_pause(engines):
    rest = engines[1].rest_app()
    for path in ("/ready", "/live", "/ping", "/inflight", "/traces"):
        assert dispatch(rest, path, method="GET")[0] == 200
    assert dispatch(rest, "/pause", method="GET")[0] == 200
    try:
        assert dispatch(rest, PRED, {"jsonData": {"prompt_tokens": [1]}})[0] == 503
    finally:
        dispatch(rest, "/unpause", method="GET")
    assert dispatch(rest, "/inflight", method="GET")[1] == {"inflight": 0, "paused": False}


def test_engine_main_loads_spec(tmp_path, model_dir, monkeypatch):
    """``engine_main`` defaults and validates the spec, and refuses a
    tpuMesh (sharded serving is not ported)."""
    import base64

    from seldon_core_tpu_torch import engine_main

    path = tmp_path / "graph.json"
    path.write_text(json.dumps({"name": "p", "graph": gen_unit(model_dir)}))
    spec = engine_main.load_spec(str(path))
    assert spec.graph.endpoint.service_port == 9000
    blob = base64.b64encode(json.dumps(
        {"name": "p", "graph": gen_unit(model_dir), "tpuMesh": {"model": 2}}).encode())
    monkeypatch.setenv("ENGINE_PREDICTOR", blob.decode())
    with pytest.raises(NotImplementedError, match="tpuMesh"):
        engine_main.load_spec(None)


def test_generate_unit_defaults_to_cuda(model_dir):
    """No quiet fallback: a GENERATE_SERVER unit without a device
    parameter asks for CUDA and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable here")
    graph = {"name": "llm", "implementation": "GENERATE_SERVER", "modelUri": model_dir}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_app(PORT, graph)
