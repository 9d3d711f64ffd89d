"""The port's bindings to the native C++ engine (seldon_core_tpu_torch/
native_engine.py) held against the port's Python engine on the CPU.

Counterpart of tests/test_native_engine.py. The library is built from
``native/`` with the port's own copy of the wire contract (byte-identical
to the JAX package's) into ``build/native/``, never into ``native/``;
``torch`` is loaded in this process, the case ``RTLD_DEEPBIND`` is for.
On the same graphs the native engine answers what the port's Python
engine answers: builtin units, a combiner over a router, a seeded A/B
test, a remote REST unit served by the port's microservice, binary
protobuf bodies; pause, unpause, ``/inflight`` and feedback."""

import asyncio
import json
import os
import subprocess
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch  # noqa: F401 - loaded first on purpose (RTLD_DEEPBIND)

from _net import free_port, wait_port
from _torch_tools import engine_app, serve_microservice

from seldon_core_tpu_torch import native_engine as ne

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    bool(ne.missing_toolchain()),
    reason=f"the native build needs {', '.join(ne.missing_toolchain())}")


def post(port, path, body, timeout=10):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def post_binary(port, body, timeout=10):
    from seldon_core_tpu_torch.proto import prediction_pb2 as pb

    req = urllib.request.Request(f"http://127.0.0.1:{port}/api/v0.1/predictions", data=body,
                                 headers={"Content-Type": "application/x-protobuf"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, pb.SeldonMessage.FromString(r.read())
    except urllib.error.HTTPError as e:
        return e.code, pb.SeldonMessage.FromString(e.read())


def python_engine(graph, body):
    """The port's Python engine's answer to ``body`` on ``graph``."""
    app = engine_app(graph)

    async def go():
        try:
            return await app.predict(json.loads(json.dumps(body)))
        finally:
            await app.executor.close()

    return asyncio.run(go())


@pytest.fixture(scope="module")
def built():
    return ne.build()


def test_port_proto_is_byte_identical_to_jax():
    with open(os.path.join(REPO, "seldon_core_tpu", "protos", "prediction.proto"), "rb") as f:
        want = f.read()
    with open(os.path.join(ne.PROTO_DIR, "prediction.proto"), "rb") as f:
        assert f.read() == want


def test_build_writes_only_under_its_own_gitignored_directory(built):
    assert built == ne.LIB_PATH == os.path.join(REPO, "build", "native", "libseldon_engine.so")
    assert os.path.exists(built)
    dry = subprocess.run(["make", "-n"] + ne.make_argv(force=True)[1:], capture_output=True,
                         text=True, check=True).stdout
    outputs = [w for line in dry.splitlines() for w in line.split()
               if line.startswith(("g++", "protoc", "mkdir")) and w.startswith("/")]
    assert outputs and all(w.startswith((ne.BUILD_DIR, ne.PROTO_DIR)) for w in outputs)
    assert "-I " + ne.PROTO_DIR in dry and ne.LIB_PATH in dry
    # only the library: not the standalone binary nor the sanitizer build
    assert "seldon-tpu-engine" not in dry.replace("seldon_engine", "")
    ignored = subprocess.run(["git", "check-ignore", "-q", ne.LIB_PATH], cwd=REPO)
    assert ignored.returncode == 0


def test_version(built):
    assert ne.version().startswith("seldon-tpu-engine/")


GRAPHS = {
    "stub": {"name": "stub", "implementation": "SIMPLE_MODEL"},
    "combiner-router": {"name": "comb", "implementation": "AVERAGE_COMBINER", "children": [
        {"name": "m1", "implementation": "SIMPLE_MODEL"},
        {"name": "r", "implementation": "SIMPLE_ROUTER", "children": [
            {"name": "m2", "implementation": "SIMPLE_MODEL"},
            {"name": "m3", "implementation": "SIMPLE_MODEL"}]}]},
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_native_equals_python_engine_on_builtin_graphs(built, name):
    graph = GRAPHS[name]
    body = {"data": {"ndarray": [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]}}
    want = python_engine(graph, body)
    port = free_port()
    with ne.NativeEngine({"name": "p", "graph": graph}, port=port):
        wait_port(port)
        status, got = post(port, "/api/v0.1/predictions", body)
    assert status == 200
    np.testing.assert_allclose(got["data"]["ndarray"], want["data"]["ndarray"])
    assert got["data"]["names"] == want["data"]["names"]
    assert got["meta"]["requestPath"] == want["meta"]["requestPath"]
    assert got["meta"].get("routing", {}) == want["meta"].get("routing", {})
    assert got["meta"]["puid"]


def test_abtest_seeded_and_both_arms(built):
    spec = {"name": "t", "graph": {
        "name": "ab", "implementation": "RANDOM_ABTEST",
        "parameters": [{"name": "ratio_a", "value": 0.5, "type": "FLOAT"}],
        "children": [{"name": "a", "implementation": "SIMPLE_MODEL"},
                     {"name": "b", "implementation": "SIMPLE_MODEL"}]}}

    def arms():
        port = free_port()
        with ne.NativeEngine(spec, port=port):
            wait_port(port)
            return [post(port, "/api/v0.1/predictions", {"data": {"ndarray": [[1.0]]}})[1][
                "meta"]["routing"]["ab"] for _ in range(20)]

    first = arms()
    assert first == arms() and set(first) == {0, 1}


class Doubler:
    def predict(self, X, names, meta=None):
        return torch.as_tensor(np.asarray(X, dtype=np.float32)).mul(2).numpy()

    def tags(self):
        return {"backend": "torch"}


def test_native_fronting_the_port_microservice_equals_python_engine(built):
    """The mixed path: the native data plane forwarding to the port's
    microservice as a remote REST unit, over keep-alive, JSON and binary."""
    from seldon_core_tpu_torch.payload import array_to_raw, pb, raw_to_array

    rest, _g, stop = serve_microservice(Doubler(), grpc=False)
    host, mport = rest.split(":")
    graph = {"name": "py", "type": "MODEL", "endpoint": {
        "service_host": host, "service_port": int(mport), "transport": "REST"}}
    try:
        port = free_port()
        with ne.NativeEngine({"name": "mixed", "graph": graph}, port=port):
            wait_port(port)
            for rows in ([[1.5, 2.5]], [[2.0]], [[1.0, 2.0], [3.0, 4.0]]):
                body = {"data": {"ndarray": rows}}
                status, got = post(port, "/api/v0.1/predictions", body)
                want = python_engine(graph, body)
                assert status == 200
                assert got["data"] == want["data"]
                assert got["meta"]["tags"] == want["meta"]["tags"] == {"backend": "torch"}
                assert got["meta"]["requestPath"] == want["meta"]["requestPath"]
            arr = np.asarray([[1.0, 2.0, 3.0]], np.float32)
            msg = pb.SeldonMessage(data=pb.DefaultData(raw=array_to_raw(arr)))
            status, out = post_binary(port, msg.SerializeToString())
            assert status == 200
            np.testing.assert_allclose(raw_to_array(out.data.raw), 2 * arr)
    finally:
        stop()


def test_binary_raw_round_trip_and_errors(built):
    from seldon_core_tpu_torch.payload import array_to_raw, pb, raw_to_array

    port = free_port()
    with ne.NativeEngine({"name": "t", "graph": GRAPHS["stub"]}, port=port):
        wait_port(port)
        arr = np.asarray([[1, 2, 3], [4, 5, 6]], np.float32)
        status, out = post_binary(port, pb.SeldonMessage(
            data=pb.DefaultData(raw=array_to_raw(arr))).SerializeToString())
        assert status == 200 and out.data.WhichOneof("data_oneof") == "raw"
        want = python_engine(GRAPHS["stub"], {"data": {"ndarray": arr.tolist()}})
        np.testing.assert_allclose(raw_to_array(out.data.raw), want["data"]["ndarray"])
        assert out.meta.request_path["stub"] == "SIMPLE_MODEL"
        status, out = post_binary(port, b"\xff\xfe garbage bytes")
        assert status == 400 and out.status.status == pb.Status.FAILURE


def test_pause_inflight_and_feedback(built):
    port = free_port()
    with ne.NativeEngine({"name": "t", "graph": GRAPHS["stub"]}, port=port):
        wait_port(port)
        urllib.request.urlopen(f"http://127.0.0.1:{port}/pause", timeout=5)
        assert post(port, "/api/v0.1/predictions", {"data": {"ndarray": [[1]]}})[0] == 503
        urllib.request.urlopen(f"http://127.0.0.1:{port}/unpause", timeout=5)
        assert post(port, "/api/v0.1/predictions", {"data": {"ndarray": [[1]]}})[0] == 200
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/inflight", timeout=5) as r:
            assert json.loads(r.read()) == {"inflight": 0, "paused": False}
        status, body = post(port, "/api/v0.1/feedback", {
            "request": {"data": {"ndarray": [[1.0]]}},
            "response": {"data": {"ndarray": [[0.9]]}}, "reward": 0.75})
        assert status == 200 and body["meta"]["tags"]["reward"] == 0.75
