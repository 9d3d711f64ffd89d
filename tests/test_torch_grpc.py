"""The port's gRPC fronts on the CPU: the engine's Seldon service
(Predict, SendFeedback, GenerateStream), the component server of
``wrapper.get_grpc_server`` / ``microservice ... GRPC``, and the engine's
gRPC unit transport. Each answer must equal the REST answer to the same
request; refusals map to the JAX engine's gRPC status codes."""

import asyncio
import json
import os
import subprocess
import sys
import time

import grpc
import numpy as np
import pytest
import torch

from _torch_engine import (
    Served,
    build_app,
    close_app,
    free_port,
    gen_unit,
    generator_of,
    make_model_dir,
    rag_graph,
)
from seldon_core_tpu_torch import wrapper
from seldon_core_tpu_torch.payload import json_to_proto, proto_to_json
from seldon_core_tpu_torch.proto import prediction_pb2 as pb
from seldon_core_tpu_torch.proto.services import method_path

torch.set_num_threads(1)

PORT = "seldon_core_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ser(m):
    return m.SerializeToString()


def _unary(ch, service, method):
    return ch.unary_unary(method_path(service, method), request_serializer=_ser,
                          response_deserializer=pb.SeldonMessage.FromString)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("llm"))


@pytest.fixture(scope="module")
def engine(model_dir):
    app = build_app(PORT, gen_unit(model_dir))
    with Served(app, grpc=True) as served:
        yield served
    close_app(app)


@pytest.mark.parametrize("body", [
    {"prompt_tokens": [5, 17, 42], "max_new_tokens": 6},
    {"prompt_tokens": [[1, 2, 3, 4]], "max_new_tokens": 7, "temperature": 0.9, "seed": 3},
])
def test_engine_grpc_predict_equals_rest(engine, body):
    status, raw = engine.post("/api/v0.1/predictions", {"jsonData": body})
    assert status == 200
    rest = json.loads(raw)
    with grpc.insecure_channel(f"127.0.0.1:{engine.grpc_port}") as ch:
        out = proto_to_json(_unary(ch, "Seldon", "Predict")(
            json_to_proto({"jsonData": body}), timeout=120))
    assert out["jsonData"] == rest["jsonData"]
    assert out["meta"]["requestPath"] == rest["meta"]["requestPath"]


def test_engine_grpc_generate_stream_equals_rest(engine):
    body = {"prompt_tokens": [9, 9, 2], "max_new_tokens": 9, "temperature": 0.7, "seed": 8}
    unary = json.loads(engine.post("/api/v0.1/predictions", {"jsonData": body})[1])
    _status, _ctype, events = engine.sse({"jsonData": body})
    with grpc.insecure_channel(f"127.0.0.1:{engine.grpc_port}") as ch:
        rpc = ch.unary_stream(method_path("Seldon", "GenerateStream"), request_serializer=_ser,
                              response_deserializer=pb.SeldonMessage.FromString)
        chunks = [proto_to_json(m)["jsonData"] for m in rpc(
            json_to_proto({"jsonData": body}), timeout=120)]
    assert chunks == events
    assert chunks[-1]["tokens"] == unary["jsonData"]["tokens"][0]
    assert [t for c in chunks[:-1] for t in c["tokens"]] == unary["jsonData"]["tokens"][0][3:]


def test_engine_grpc_stream_refusals(engine, model_dir):
    with grpc.insecure_channel(f"127.0.0.1:{engine.grpc_port}") as ch:
        rpc = ch.unary_stream(method_path("Seldon", "GenerateStream"), request_serializer=_ser,
                              response_deserializer=pb.SeldonMessage.FromString)
        with pytest.raises(grpc.RpcError) as e:
            list(rpc(json_to_proto({"jsonData": {"prompt_tokens": [[1], [2]]}}), timeout=60))
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    app = build_app(PORT, rag_graph(model_dir))
    try:
        with Served(app, grpc=True) as served, \
                grpc.insecure_channel(f"127.0.0.1:{served.grpc_port}") as ch:
            rpc = ch.unary_stream(method_path("Seldon", "GenerateStream"),
                                  request_serializer=_ser,
                                  response_deserializer=pb.SeldonMessage.FromString)
            with pytest.raises(grpc.RpcError) as e:
                list(rpc(json_to_proto({"jsonData": {"prompt_tokens": [1]}}), timeout=60))
            assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
    finally:
        close_app(app)


def test_engine_grpc_feedback_and_routing():
    graph = {"name": "ab", "implementation": "RANDOM_ABTEST", "children": [
        {"name": "a", "implementation": "SIMPLE_MODEL"},
        {"name": "b", "implementation": "SIMPLE_MODEL"}]}
    app = build_app(PORT, graph)
    with Served(app, grpc=True) as served, \
            grpc.insecure_channel(f"127.0.0.1:{served.grpc_port}") as ch:
        msg = {"data": {"ndarray": [[1.0, 2.0]]}}
        out = proto_to_json(_unary(ch, "Seldon", "Predict")(json_to_proto(msg), timeout=30))
        rest = json.loads(served.post("/api/v0.1/predictions", msg)[1])
        assert out["data"] == rest["data"]
        assert set(out["meta"]["routing"]) == {"ab"}
        fb = pb.Feedback(reward=1.0)
        fb.response.CopyFrom(json_to_proto(out))
        rpc = ch.unary_unary(method_path("Seldon", "SendFeedback"), request_serializer=_ser,
                             response_deserializer=pb.SeldonMessage.FromString)
        reply = proto_to_json(rpc(fb, timeout=30))
        assert reply["meta"]["tags"]["reward"] == 1.0


class Slow:
    def predict(self, X, names, meta=None):
        time.sleep(0.5)
        return X


def test_engine_grpc_over_capacity_is_resource_exhausted():
    """The JAX engine's mapping: a max-inflight refusal is
    RESOURCE_EXHAUSTED on gRPC (429 on REST)."""
    app = build_app(PORT, {"name": "m", "type": "MODEL"},
                    {"seldon.io/max-inflight": "1"}, registry={"m": Slow()})
    with Served(app, grpc=True) as served, \
            grpc.insecure_channel(f"127.0.0.1:{served.grpc_port}") as ch:
        rpc = _unary(ch, "Seldon", "Predict")
        first = rpc.future(json_to_proto({"data": {"ndarray": [[1.0]]}}), timeout=30)
        time.sleep(0.1)
        with pytest.raises(grpc.RpcError) as e:
            rpc(json_to_proto({"data": {"ndarray": [[1.0]]}}), timeout=30)
        assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert first.result() is not None


@pytest.fixture(scope="module")
def component(engine):
    """The engine's generate server behind the component gRPC server."""
    gen = generator_of(engine.app)
    port = free_port()
    server = wrapper.get_grpc_server(gen)
    server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    rest = wrapper.get_rest_microservice(gen)
    yield gen, port, rest
    server.stop(grace=0.1)
    rest._hook_pool.shutdown(wait=False)


def test_component_grpc_predict_equals_rest(component):
    from seldon_core_tpu_torch.http_server import Request

    _gen, port, rest = component
    body = {"jsonData": {"prompt_tokens": [4, 5, 6], "max_new_tokens": 5}}
    resp = asyncio.run(rest._dispatch(Request(
        "POST", "/predict", "", {"content-type": "application/json"}, json.dumps(body).encode())))
    want = json.loads(resp.body)
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        stub = wrapper.grpc_stub(ch, "Model", "Predict")
        out = proto_to_json(stub(json_to_proto(body), timeout=60))
    assert out["jsonData"] == want["jsonData"]


def test_engine_grpc_unit_transport_equals_inprocess(component, engine, model_dir):
    """A GENERATE_SERVER unit reached over the gRPC transport (the
    executor's GrpcClient) gives the in-process unit's tokens."""
    _gen, port, _rest = component
    unit = gen_unit(model_dir, endpoint={"service_host": "127.0.0.1", "grpc_port": port,
                                         "transport": "GRPC"})
    app = build_app(PORT, unit, {"seldon.io/grpc-read-timeout": "60000"})
    body = {"jsonData": {"prompt_tokens": [8, 1, 8], "max_new_tokens": 6, "temperature": 0.5,
                         "seed": 1}}
    with Served(app) as served:
        status, raw = served.post("/api/v0.1/predictions", body)
    assert status == 200
    want = json.loads(engine.post("/api/v0.1/predictions", body)[1])
    assert json.loads(raw)["jsonData"] == want["jsonData"]


def test_microservice_cli_grpc(tmp_path):
    """``python -m seldon_core_tpu_torch.microservice Comp GRPC`` serves
    the component services over gRPC."""
    (tmp_path / "Comp.py").write_text(
        "import numpy as np\n"
        "class Comp:\n"
        "    def predict(self, X, names, meta=None):\n"
        "        return np.asarray(X) * 10\n")
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.microservice", "Comp", "GRPC",
         "--grpc-port", str(port)], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
            grpc.channel_ready_future(ch).result(timeout=60)
            stub = wrapper.grpc_stub(ch, "Model", "Predict")
            out = proto_to_json(stub(json_to_proto({"data": {"ndarray": [[1.0, 2.0]]}}),
                                     timeout=30))
        np.testing.assert_array_equal(out["data"]["ndarray"], [[10.0, 20.0]])
    finally:
        proc.terminate()
        proc.wait(30)
