"""The port's fronts: ``/openapi.json`` (``openapi.py``), the CloudEvents
request logger (``request_logging.py``), ``persistence.py`` and the
microservice CLI's ``FBS``, ``--workers``, ``--persistence`` and tracer.

Each group runs the JAX package's own cases (``tests/test_openapi.py``,
``test_request_logging.py``, ``test_persistence.py``,
``test_multiworker.py``) against the port, then holds the port against
the JAX package on the same inputs. The CLI cases run the microservice
as a subprocess."""

import asyncio
import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from _net import free_port, serve_on_thread, wait_port
from _torch_engine import build_app, dispatch

from seldon_core_tpu import openapi as jax_openapi
from seldon_core_tpu import persistence as jax_persistence
from seldon_core_tpu import request_logging as jax_request_logging
from seldon_core_tpu_torch import persistence, tracing
from seldon_core_tpu_torch.graph.service import EngineApp, RequestLogger
from seldon_core_tpu_torch.graph.spec import PredictorSpec, default_predictor
from seldon_core_tpu_torch.http_server import Request
from seldon_core_tpu_torch.openapi import engine_spec, wrapper_spec
from seldon_core_tpu_torch.request_logging import (
    CloudEventsSink,
    RequestLoggerApp,
    flatten_pair,
)
from seldon_core_tpu_torch.user_model import SeldonComponent
from seldon_core_tpu_torch.wrapper import get_rest_microservice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "seldon_core_tpu", "seldon_core_tpu_torch"
SIMPLE = {"name": "m", "implementation": "SIMPLE_MODEL"}


def _call(app, path, body=None, method="POST", headers=None):
    raw = json.dumps(body).encode() if body is not None else b""
    hdrs = {"content-type": "application/json"} if raw else {}
    hdrs.update(headers or {})
    resp = asyncio.run(app._dispatch(Request(method, path, "", hdrs, raw)))
    return resp.status, (json.loads(resp.body) if resp.body else None)


def _simple_engine(**kw):
    spec = default_predictor(PredictorSpec.from_dict({"name": "d", "graph": SIMPLE}))
    return EngineApp(spec, **kw)


class Echo(SeldonComponent):
    def predict(self, X, names, meta=None):
        return np.asarray(X)


# -- openapi: the JAX package's cases (tests/test_openapi.py) ----------------


def test_engine_spec_shape():
    doc = engine_spec()
    assert doc["openapi"].startswith("3.")
    assert "/api/v0.1/predictions" in doc["paths"]
    assert "/api/v0.1/feedback" in doc["paths"]
    assert "/inflight" in doc["paths"]
    schema = doc["components"]["schemas"]["SeldonMessage"]
    assert "raw" in schema["properties"]["data"]["properties"]
    json.dumps(doc)


def test_wrapper_spec_shape():
    doc = wrapper_spec()
    for path in ("/predict", "/route", "/aggregate", "/send-feedback", "/explain"):
        assert path in doc["paths"], path
    json.dumps(doc)


def test_reconcile_tracks_real_routes():
    doc = engine_spec(served_paths={"/api/v0.1/predictions", "/made-up"})
    assert set(doc["paths"]) == {"/api/v0.1/predictions", "/made-up"}
    assert "undocumented" in doc["paths"]["/made-up"]["post"]["summary"]


def test_engine_serves_openapi():
    app = _simple_engine()
    rest = app.rest_app()
    status, doc = _call(rest, "/openapi.json", method="GET")
    assert status == 200
    assert "/api/v0.1/predictions" in doc["paths"]
    assert set(doc["paths"]) == set(rest.routes)
    asyncio.run(app.executor.close())


def test_wrapper_serves_openapi():
    app = get_rest_microservice(Echo())
    status, doc = _call(app, "/openapi.json", method="GET")
    assert status == 200
    assert "/predict" in doc["paths"]
    assert set(doc["paths"]) == set(app.routes)
    app._hook_pool.shutdown(wait=False)


# -- openapi: the port against the JAX package -------------------------------


def _served_sets():
    engine = build_app(PORT, SIMPLE).rest_app()
    micro = get_rest_microservice(Echo())
    micro._hook_pool.shutdown(wait=False)
    return {"none": None, "engine": set(engine.routes), "wrapper": set(micro.routes),
            "made_up": {"/predict", "/x", "/y/z"}, "empty": set()}


@pytest.mark.parametrize("which", ["none", "engine", "wrapper", "made_up", "empty"])
def test_specs_equal_jax(which):
    served = _served_sets()[which]
    assert engine_spec(served_paths=served) == jax_openapi.engine_spec(served_paths=served)
    assert wrapper_spec(served_paths=served) == jax_openapi.wrapper_spec(served_paths=served)


def test_engine_document_equals_the_jax_engines():
    """Both engines serve the same route set, so their live documents are
    equal key for key."""
    port_rest = build_app(PORT, SIMPLE).rest_app()
    jax_rest = build_app(JAX, SIMPLE).rest_app()
    assert set(port_rest.routes) == set(jax_rest.routes)
    s1, port_doc = dispatch(port_rest, "/openapi.json", method="GET")
    s2, jax_doc = dispatch(jax_rest, "/openapi.json", method="GET")
    assert s1 == s2 == 200 and port_doc == jax_doc


def test_wrapper_document_equals_the_jax_wrappers():
    from seldon_core_tpu.wrapper import get_rest_microservice as jax_rest_microservice

    port_app = get_rest_microservice(Echo())
    jax_app = jax_rest_microservice(Echo())
    assert set(port_app.routes) == set(jax_app.routes)
    _s, port_doc = dispatch(port_app, "/openapi.json", method="GET")
    _s, jax_doc = dispatch(jax_app, "/openapi.json", method="GET")
    assert port_doc == jax_doc
    port_app._hook_pool.shutdown(wait=False)
    jax_app._hook_pool.shutdown(wait=False)


# -- request logging: the JAX package's cases (tests/test_request_logging.py) -


def make_event(req_rows, resp_rows, puid="p1"):
    return {
        "specversion": "1.0",
        "type": "seldon.message.pair",
        "id": puid,
        "data": {
            "request": {"data": {"names": ["a", "b"], "ndarray": req_rows}},
            "response": {
                "data": {"names": ["p0"], "ndarray": resp_rows},
                "meta": {"puid": puid, "tags": {"v": 1}},
            },
        },
    }


def test_flatten_pair_one_doc_per_row():
    docs = flatten_pair(make_event([[1, 2], [3, 4]], [[0.9], [0.1]]))
    assert len(docs) == 2
    assert docs[0]["request"] == [1, 2]
    assert docs[0]["response"] == [0.9]
    assert docs[0]["puid"] == "p1"
    assert docs[0]["index"] == 0
    assert docs[1]["request"] == [3, 4]
    assert docs[1]["tags"] == {"v": 1}


def test_flatten_pair_strdata_and_jsondata():
    docs = flatten_pair({"id": "x", "data": {"request": {"strData": "hello"},
                                             "response": {"jsonData": {"tokens": [1, 2]}}}})
    assert len(docs) == 1
    assert docs[0]["request"] == "hello"
    assert docs[0]["response"] == {"tokens": [1, 2]}


def test_logger_app_ingest_and_routes():
    app = RequestLoggerApp(capacity=10)
    srv = app.app()
    status, body = _call(srv, "/", make_event([[1, 2]], [[0.5]]))
    assert status == 200 and body["indexed"] == 1
    status, body = _call(srv, "/entries", method="GET")
    assert status == 200
    assert len(body["entries"]) == 1
    assert body["stats"]["events"] == 1


def test_logger_app_binary_content_mode():
    app = RequestLoggerApp()
    status, body = _call(
        app.app(), "/",
        {"request": {"data": {"ndarray": [[1.0]]}}, "response": {"data": {"ndarray": [[2.0]]}}},
        headers={"ce-id": "abc", "ce-source": "test"},
    )
    assert status == 200 and body["indexed"] == 1
    assert app.entries[0]["ce_id"] == "abc"


def test_logger_app_ring_capacity():
    app = RequestLoggerApp(capacity=3)
    for i in range(5):
        app.ingest(make_event([[i]], [[i]], puid=f"p{i}"))
    assert len(app.entries) == 3
    assert app.entries[0]["puid"] == "p2"


def test_cloudevents_sink_posts_to_collector():
    """Engine predict -> CloudEvents POST -> collector flattening, over a
    real socket."""
    port = free_port()
    collector = RequestLoggerApp()
    stop = serve_on_thread(collector.app().serve_forever("127.0.0.1", port), port)
    sink = CloudEventsSink(f"http://127.0.0.1:{port}/", maxsize=8)
    app = _simple_engine(request_logger=RequestLogger(sink))
    asyncio.run(app.predict({"data": {"ndarray": [[1.0, 2.0]]}}))
    deadline = time.time() + 5
    while time.time() < deadline and sink.stats["posted"] < 1:
        time.sleep(0.05)
    sink.close()
    stop()
    assert sink.stats["posted"] == 1
    assert sink.stats["errors"] == 0
    assert collector.stats["events"] == 1
    doc = collector.entries[0]
    assert doc["request"] == [1.0, 2.0]
    assert doc["response"] == [0.9, 0.05, 0.05]
    assert doc["puid"]


def test_cloudevents_sink_overflow_drops_not_blocks():
    sink = CloudEventsSink("http://127.0.0.1:1/", maxsize=4, timeout_s=0.2)
    t0 = time.perf_counter()
    for i in range(100):
        sink({"id": str(i), "data": {}})
    assert time.perf_counter() - t0 < 1.0
    deadline = time.time() + 3
    while time.time() < deadline and sink.stats["dropped"] == 0:
        time.sleep(0.02)
    assert sink.stats["dropped"] > 0
    sink.close()


def test_request_logger_from_env(monkeypatch):
    """SELDON_MESSAGE_LOGGING_SERVICE selects the CloudEvents sink (the
    port's engine refused to start with it before)."""
    monkeypatch.delenv("SELDON_MESSAGE_LOGGING_SERVICE", raising=False)
    assert RequestLogger.from_env().sink is None
    monkeypatch.setenv("SELDON_MESSAGE_LOGGING_SERVICE", "http://127.0.0.1:1/")
    rl = RequestLogger.from_env()
    assert isinstance(rl.sink, CloudEventsSink)
    assert rl.sink.url == "http://127.0.0.1:1/"
    rl.sink.close()


# -- request logging: the port against the JAX package -----------------------

EVENTS = {
    "rows": make_event([[1, 2], [3, 4]], [[0.9], [0.1]]),
    "more_requests": make_event([[1, 2], [3, 4], [5, 6]], [[0.5]], puid="p9"),
    "str_json": {"id": "x", "source": "s", "data": {
        "request": {"strData": "hello"}, "response": {"jsonData": {"tokens": [[1, 2]]},
                                                      "meta": {"requestPath": {"m": "i"}}}}},
    "tensor": {"id": "t", "data": {
        "request": {"data": {"tensor": {"shape": [2, 2], "values": [1.0, 2.0, 3.0, 4.0]}}},
        "response": {"data": {"names": ["y"], "tensor": {"shape": [2, 1],
                                                        "values": [0.1, 0.2]}}}}},
    "bad_payload": {"id": "b", "data": {
        "request": {"data": {"raw": {"dtype": "no-such-dtype", "shape": [1], "data": ""}}},
        "response": {"strData": "err"}}},
    "empty": {"id": "e"},
}


@pytest.mark.parametrize("name", sorted(EVENTS))
def test_flatten_pair_equals_jax(name):
    assert flatten_pair(EVENTS[name]) == jax_request_logging.flatten_pair(EVENTS[name])


def test_collector_documents_equal_jax():
    port_app, jax_app = RequestLoggerApp(capacity=5), jax_request_logging.RequestLoggerApp(
        capacity=5)
    for name in sorted(EVENTS):
        assert port_app.ingest(EVENTS[name]) == jax_app.ingest(EVENTS[name])
    assert list(port_app.entries) == list(jax_app.entries)
    assert port_app.stats == jax_app.stats


def test_collector_cli_indexes_a_generate_engines_pairs(tmp_path):
    """The collector started through its CLI receives the CloudEvents of a
    port engine over a CPU GenerateServer; its documents are the JAX
    flattening of the same pairs."""
    from _torch_engine import gen_unit, make_model_dir

    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.request_logging",
         "--host", "127.0.0.1", "--port", str(port)],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    sent = []
    try:
        wait_port(port, timeout=60)
        sink = CloudEventsSink(f"http://127.0.0.1:{port}/")
        posted = []

        def tee(event):
            posted.append(json.loads(json.dumps(event)))
            sink(event)

        app = build_app(PORT, gen_unit(make_model_dir(tmp_path)),
                        request_logger=RequestLogger(tee))
        for body in ({"prompt_tokens": [5, 17, 42], "max_new_tokens": 4},
                     {"prompt_tokens": [1, 2], "max_new_tokens": 3, "temperature": 0.7,
                      "seed": 2}):
            sent.append(asyncio.run(app.predict({"jsonData": body})))
        deadline = time.time() + 10
        while time.time() < deadline and sink.stats["posted"] < 2:
            time.sleep(0.02)
        sink.close()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/entries", timeout=10) as r:
            entries = json.loads(r.read())
        gen = app.executor.root.client.user_object
        gen.close()
    finally:
        proc.terminate()
        proc.wait(30)
    assert sink.stats == {"posted": 2, "dropped": 0, "errors": 0}
    want = [doc for ev in posted for doc in jax_request_logging.flatten_pair(
        {**ev, "source": "seldon-tpu-engine"})]
    assert entries["entries"] == want
    assert [d["response"]["tokens"] for d in entries["entries"]] == [
        out["jsonData"]["tokens"] for out in sent]


# -- persistence: the JAX package's cases (tests/test_persistence.py) --------

X4 = np.zeros((4, 2))


class PlainCounter(SeldonComponent):
    def __init__(self):
        self.count = 0

    def predict(self, X, names, meta=None):
        self.count += 1
        return X


class BanditCounts(SeldonComponent):
    """Test-only state-dict component (the port's routers and detectors,
    which carry these hooks, come with the rest of the zoo)."""

    def __init__(self, n_branches=3):
        self.success = np.zeros(n_branches)
        self.tries = np.zeros(n_branches, dtype=np.int64)
        self.best = -1

    def send_feedback(self, X, names, reward, truth, routing=None):
        self.tries[routing] += 1
        self.success[routing] += reward
        self.best = int(np.argmax(self.success))

    def to_state_dict(self):
        return {"counts": {"success": self.success, "tries": self.tries},
                "best": np.asarray(self.best)}

    def from_state_dict(self, state):
        self.success = np.asarray(state["counts"]["success"])
        self.tries = np.asarray(state["counts"]["tries"])
        self.best = int(state["best"])


def test_state_key_env(monkeypatch):
    monkeypatch.setenv("PREDICTOR_ID", "pred")
    monkeypatch.setenv("SELDON_DEPLOYMENT_ID", "dep")
    assert persistence.state_key("router") == "pred_dep_router"
    assert persistence.state_key("r", "a", "b") == "a_b_r"
    assert persistence.state_key("router") == jax_persistence.state_key("router")


def test_npz_roundtrip_for_state_dict_components(tmp_path):
    """The JAX package writes state dicts with orbax; the port writes one
    .npz of ``/``-joined keys and rebuilds the nested dict."""
    r = BanditCounts()
    r.send_feedback(X4, [], reward=1.0, truth=None, routing=2)
    path = persistence.persist(r, str(tmp_path), "k")
    assert path.endswith(".npz")
    with np.load(path) as z:
        assert sorted(z.files) == ["best", "counts/success", "counts/tries"]
    assert not os.path.exists(path + ".tmp") and not any(
        f.endswith(".orbax") for f in os.listdir(tmp_path))
    r2 = persistence.restore(BanditCounts, {"n_branches": 3}, str(tmp_path), "k")
    assert r2.best == 2
    assert r2.success.tolist() == r.success.tolist()
    assert r2.tries.dtype == np.int64 and r2.tries.tolist() == [0, 0, 1]


def test_pickle_fallback_for_plain_components(tmp_path):
    c = PlainCounter()
    c.predict(X4, [])
    c.predict(X4, [])
    path = persistence.persist(c, str(tmp_path), "k")
    assert path.endswith(".pkl")
    c2 = persistence.restore(PlainCounter, {}, str(tmp_path), "k")
    assert c2.count == 2


def test_restore_without_snapshot_is_fresh(tmp_path):
    r = persistence.restore(BanditCounts, {"n_branches": 2}, str(tmp_path), "nope")
    assert r.tries.sum() == 0


def test_persistence_thread_pushes(tmp_path):
    c = PlainCounter()
    t = persistence.PersistenceThread(c, str(tmp_path), "k", push_frequency=0.05)
    t.start()
    c.predict(X4, [])
    time.sleep(0.2)
    t.stop(final_push=True)
    c2 = persistence.restore(PlainCounter, {}, str(tmp_path), "k")
    assert c2.count == 1


# -- persistence: the port against the JAX package ---------------------------


def test_failed_snapshot_keeps_the_previous_one(tmp_path):
    """tmp-then-os.replace: a snapshot that fails mid-write leaves the last
    good one in place."""
    r = BanditCounts()
    r.send_feedback(X4, [], reward=1.0, truth=None, routing=1)
    path = persistence.persist(r, str(tmp_path), "k")
    before = open(path, "rb").read()
    r.to_state_dict = lambda: {"bad/key": np.zeros(1)}
    with pytest.raises(ValueError, match="separator"):
        persistence.persist(r, str(tmp_path), "k")
    assert open(path, "rb").read() == before


def test_pickle_snapshots_cross_packages(tmp_path):
    """A plain component's pickle is the same bytes from either package,
    and each package restores the other's."""
    c = PlainCounter()
    c.predict(X4, [])
    port_path = persistence.persist(c, str(tmp_path / "port"), "k")
    jax_path = jax_persistence.persist(c, str(tmp_path / "jax"), "k")
    assert open(port_path, "rb").read() == open(jax_path, "rb").read()
    assert persistence.restore(PlainCounter, {}, str(tmp_path / "jax"), "k").count == 1
    assert jax_persistence.restore(PlainCounter, {}, str(tmp_path / "port"), "k").count == 1


# -- the microservice CLI ----------------------------------------------------

COMPONENTS = {
    "Doubler": """
import numpy as np

class Doubler:
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2
""",
    "PidModel": """
import os
import numpy as np

class PidModel:
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2

    def tags(self):
        return {"pid": os.getpid()}
""",
    "Tally": """
import numpy as np

class Tally:
    def __init__(self):
        self.seen = np.zeros(1)

    def predict(self, X, names, meta=None):
        self.seen += 1
        return self.seen.reshape(1, 1)

    def to_state_dict(self):
        return {"tally": {"seen": self.seen}}

    def from_state_dict(self, state):
        self.seen = np.asarray(state["tally"]["seen"], dtype=float)
""",
}


def _cli(tmp_path, cls, *args, stdout=subprocess.DEVNULL):
    (tmp_path / f"{cls}.py").write_text(COMPONENTS[cls])
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{tmp_path}", OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.microservice", cls, *args],
        env=env, cwd=str(tmp_path), stdout=stdout, stderr=subprocess.PIPE)


def _predict(port, rows, timeout=10):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict",
        data=json.dumps({"data": {"ndarray": rows}}).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def _sigterm(proc, timeout=30):
    proc.send_signal(signal.SIGTERM)
    return proc.wait(timeout)


def _wait_up(port, proc, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
        try:
            socket.create_connection(("127.0.0.1", port), 0.2).close()
            return
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"port {port} never opened")


def test_cli_fbs_serves_predict(tmp_path):
    from seldon_core_tpu_torch import fbs

    port = free_port()
    proc = _cli(tmp_path, "Doubler", "FBS", "--service-port", str(port), "--host", "127.0.0.1",
                "--no-warmup")
    try:
        _wait_up(port, proc)
        out = fbs.fbs_predict("127.0.0.1", port, [[1.0, 2.5]], ["a", "b"])
        assert out["status"]["code"] == 200
        np.testing.assert_array_equal(out["data"], [[2.0, 5.0]])
        assert _sigterm(proc) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


@pytest.mark.skipif(sys.platform != "linux", reason="SO_REUSEPORT")
def test_workers_share_port_and_all_serve(tmp_path):
    """``REST --workers 2``: two spawned workers share the port and both
    answer (the JAX package's tests/test_multiworker.py); SIGTERM to the
    parent ends both workers cleanly, and the parent exits 0."""
    port = free_port()
    proc = _cli(tmp_path, "PidModel", "REST", "--service-port", str(port), "--workers", "2",
                "--no-warmup")
    try:
        _wait_up(port, proc, timeout=30)
        pids = set()
        deadline = time.time() + 30
        while time.time() < deadline and len(pids) < 2:
            out = _predict(port, [[2.0]])
            assert out["data"]["ndarray"] == [[4.0]]
            pids.add(out["meta"]["tags"]["pid"])
        assert len(pids) == 2, f"expected 2 worker pids, saw {pids}"
        assert proc.pid not in pids
        assert _sigterm(proc) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


def test_cli_workers_with_persistence_refused(tmp_path):
    proc = _cli(tmp_path, "Doubler", "REST", "--workers", "2", "--persistence",
                "--persistence-dir", str(tmp_path / "state"), "--no-warmup")
    _out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0
    assert b"--workers > 1 cannot be combined with --persistence" in err


def test_cli_persistence_snapshot_survives_restart(tmp_path):
    """``--persistence``: the state-dict snapshot (``.npz``) pushed at
    shutdown is restored by the next boot."""
    state = tmp_path / "state"
    for expected in ([[1.0], [2.0], [3.0]], [[4.0], [5.0]]):
        port = free_port()
        proc = _cli(tmp_path, "Tally", "REST", "--service-port", str(port), "--persistence",
                    "--persistence-dir", str(state), "--persistence-frequency", "60",
                    "--no-warmup")
        try:
            _wait_up(port, proc)
            got = [_predict(port, [[0.0]])["data"]["ndarray"][0] for _ in expected]
            assert got == expected
            assert _sigterm(proc) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
        assert sorted(os.listdir(state)) == ["default_default_Tally.npz"]


def test_microservice_span_carries_the_class_name(tmp_path, monkeypatch):
    """The CLI names its tracer after the component class, as the JAX CLI
    does, so a microservice span goes out under ``Doubler``, not the
    tracer's fallback name."""
    from seldon_core_tpu_torch import microservice

    (tmp_path / "Doubler.py").write_text(COMPONENTS["Doubler"])
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TRACING", "1")
    monkeypatch.delenv("JAEGER_AGENT_HOST", raising=False)
    seen = {}

    async def serve_rest(user_object, host, port, state=None, reuse_port=False):
        app = get_rest_microservice(user_object, state)
        body = json.dumps({"data": {"ndarray": [[1.0]]}}).encode()
        resp = await app._dispatch(Request(
            "POST", "/predict", "", {"content-type": "application/json"}, body))
        seen["status"] = resp.status
        seen["traces"] = tracing.get_tracer().export_jaeger()
        app._hook_pool.shutdown(wait=False)

    saved = tracing._GLOBAL
    monkeypatch.setattr(microservice, "serve_rest", serve_rest)
    try:
        microservice.main(["Doubler", "REST", "--no-warmup"])
    finally:
        tracing._GLOBAL.close()
        tracing._GLOBAL = saved
    assert seen["status"] == 200
    (trace,) = seen["traces"]["data"]
    assert trace["processes"]["p1"]["serviceName"] == "Doubler"
    (span,) = trace["spans"]
    assert span["operationName"] == "predict"
    assert {"key": "component", "type": "string", "value": "Doubler"} in span["tags"]


def test_cli_accepts_every_jax_command_line(monkeypatch, tmp_path):
    """Every option of the JAX CLI parses in the port's (``FBS``,
    ``--persistence*``, ``--workers``, ``--reuse-port``)."""
    from seldon_core_tpu_torch import microservice

    (tmp_path / "Doubler.py").write_text(COMPONENTS["Doubler"])
    monkeypatch.chdir(tmp_path)
    served = []

    async def serve_rest(user_object, host, port, state=None, reuse_port=False):
        served.append((host, port, reuse_port, type(user_object).__name__))

    monkeypatch.setattr(microservice, "serve_rest", serve_rest)
    microservice.main(["Doubler", "REST", "--service-port", "9123", "--host", "127.0.0.1",
                       "--persistence", "--persistence-dir", str(tmp_path / "s"),
                       "--persistence-frequency", "30", "--workers", "1", "--reuse-port",
                       "--no-warmup", "--log-level", "WARNING", "--parameters", "[]",
                       "--grpc-port", "9124", "--grpc-max-message-bytes", "1024"])
    assert served == [("127.0.0.1", 9123, True, "Doubler")]
    # the final push of --persistence ran at shutdown
    assert os.listdir(tmp_path / "s") == ["default_default_Doubler.pkl"]
    with open(tmp_path / "s" / "default_default_Doubler.pkl", "rb") as f:
        assert type(pickle.load(f)).__name__ == "Doubler"
