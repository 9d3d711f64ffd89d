"""The port's slice as a whole: the REST microservice of
seldon_core_tpu_torch serving GenerateServer on the CPU, against the JAX
package's GenerateServer on the same model directory and weights.

The model directory holds the JAX package's ``init_params(0)`` as an npz
checkpoint (``convert.save_npz``), named by ``jax_config.json``; the JAX
server reads the same ``jax_config.json`` and initialises the same
weights from seed 0. Tokens must be equal, greedy and seeded.
"""

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.llm import DecoderLM as JaxLM
from seldon_core_tpu.servers.generateserver import GenerateServer as JaxGenerateServer
from seldon_core_tpu_torch import microservice, wrapper
from seldon_core_tpu_torch.convert import save_npz
from seldon_core_tpu_torch.http_server import Request
from seldon_core_tpu_torch.servers.generateserver import GenerateServer

torch.set_num_threads(1)

CFG = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, max_seq=64, dtype="float32")
CLS = "seldon_core_tpu_torch.servers.generateserver.GenerateServer"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("llm")
    params = jax.jit(JaxLM(**CFG).init_params)(0)
    save_npz(jax.tree.map(np.asarray, params), str(d / "params.npz"))
    (d / "jax_config.json").write_text(
        json.dumps({"family": "llm", "config": CFG, "checkpoint": "params.npz"})
    )
    return str(d)


def _typed(**kw):
    kinds = {int: "INT", float: "FLOAT", str: "STRING", bool: "BOOL"}
    return json.dumps([{"name": k, "value": v, "type": kinds[type(v)]} for k, v in kw.items()])


@pytest.fixture(scope="module")
def port_app(model_dir):
    """What ``python -m seldon_core_tpu_torch.microservice <GenerateServer>
    REST`` builds: the typed-parameter user object, load() (with warmup)
    before listening, and the REST app."""
    user = microservice.build_user_object(CLS, _typed(
        model_uri=model_dir, device="cpu", slots=2, steps_per_poll=2,
        warmup_prompt_lens="3,12", warmup_max_new_tokens=8,
    ))
    user.load()
    app = wrapper.get_rest_microservice(user)
    yield app
    user.close()
    app._hook_pool.shutdown(wait=False)


@pytest.fixture(scope="module")
def jax_server(model_dir):
    s = JaxGenerateServer(model_uri=model_dir, slots=2, steps_per_poll=2)
    s.load()
    yield s
    s.close()


def _call(app, path, body=None, method="POST", ctype="application/json", raw=None):
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else b"")
    req = Request(method, path, "", {"content-type": ctype} if data else {}, data)
    resp = asyncio.run(app._dispatch(req))
    return resp.status, resp.body


REQUESTS = [
    {"prompt_tokens": [5, 17, 42], "max_new_tokens": 6},
    {"prompt_tokens": [1, 2, 3, 4, 5, 6, 7, 8, 9], "max_new_tokens": 9,
     "temperature": 0.8, "seed": 4},
    {"prompt_tokens": list(range(30, 60)), "max_new_tokens": 5, "temperature": 1.2,
     "seed": 11},
]


@pytest.mark.parametrize("body", REQUESTS)
def test_rest_generate_equals_jax(port_app, jax_server, body):
    status, raw = _call(port_app, "/predict", {"jsonData": body})
    assert status == 200
    out = json.loads(raw)
    want = jax_server.predict(body, [])
    assert out["jsonData"] == want
    keys = {m["key"] for m in out["meta"]["metrics"]}
    assert {"gen_tokens", "gen_ttft_ms"} <= keys


def test_text_prompt_equals_jax(port_app, jax_server):
    body = {"prompt": "hi there", "max_new_tokens": 5}
    status, raw = _call(port_app, "/api/v1.0/predictions", {"jsonData": body})
    assert status == 200
    assert json.loads(raw)["jsonData"] == jax_server.predict(body, [])


def test_multi_prompt_request(port_app, jax_server):
    """Prompts of one request ride the same decode batch; each prompt's
    tokens are what it gets alone."""
    body = {"prompt_tokens": [[5, 17, 42], [9, 9, 9, 9]], "max_new_tokens": 4,
            "temperature": 0.7, "seed": 3}
    status, raw = _call(port_app, "/predict", {"jsonData": body})
    assert status == 200
    got = json.loads(raw)["jsonData"]["tokens"]
    for prompt, tokens in zip(body["prompt_tokens"], got):
        alone = {**body, "prompt_tokens": prompt}
        assert [tokens] == jax_server.predict(alone, [])["tokens"]


def test_binary_protobuf_body(port_app):
    from seldon_core_tpu_torch.proto import prediction_pb2 as pb

    msg = pb.SeldonMessage(json_data=json.dumps({"prompt_tokens": [5, 17, 42],
                                                 "max_new_tokens": 6}))
    status, raw = _call(port_app, "/predict", ctype="application/x-protobuf",
                        raw=msg.SerializeToString())
    assert status == 200
    out = json.loads(pb.SeldonMessage.FromString(raw).json_data)
    _s, raw_json = _call(port_app, "/predict", {"jsonData": {"prompt_tokens": [5, 17, 42],
                                                             "max_new_tokens": 6}})
    assert out == json.loads(raw_json)["jsonData"]


def test_health_routes_and_errors(port_app):
    assert _call(port_app, "/health/status", method="GET")[0] == 200
    assert _call(port_app, "/ready", method="GET")[0] == 200
    status, raw = _call(port_app, "/predict", {"jsonData": {"prompt_tokens": list(range(64)),
                                                           "max_new_tokens": 2}})
    assert status == 400 and b"exceeds" in raw  # PromptTooLong is a ValueError
    status, _ = _call(port_app, "/predict", {"jsonData": {"max_new_tokens": 2}})
    assert status == 400


def test_unported_parameter_raises(model_dir):
    # the mesh parameters are ported: typed strings parse, a malformed
    # mesh_shape refuses at construction as the JAX server refuses it
    from seldon_core_tpu_torch.parallel.mesh import MeshShapeError

    srv = microservice.build_user_object(CLS, _typed(
        model_uri=model_dir, device="cpu", mesh_shape="data=1,seq=2,model=2",
        shard_cache_seq="true"))
    assert srv._mesh_shape == {"data": 1, "seq": 2, "model": 2} and srv._shard_cache_seq
    with pytest.raises(MeshShapeError, match="rows"):
        microservice.build_user_object(CLS, _typed(
            model_uri=model_dir, device="cpu", mesh_shape="rows=2"))
    # the telemetry parameters are ported: a JAX config spelling the JAX
    # default flight_recorder 512, the profiler and SLO objectives, as
    # typed strings, is accepted; off values too
    srv = microservice.build_user_object(CLS, _typed(
        model_uri=model_dir, device="cpu", flight_recorder=512, profiler="1",
        slo_objectives="ttft:200:0.99"))
    assert srv._flight_recorder == 512 and srv.profiler.enabled
    assert [o.slo for o in srv.slo_burn.objectives] == ["ttft"]
    GenerateServer(model_uri=model_dir, device="cpu", profiler="0", flight_recorder=0)
    # the swap and resume-token parameters are ported: typed strings
    # parse, and a bad swap policy is refused as the JAX server's batcher
    # refuses it
    srv = microservice.build_user_object(CLS, _typed(
        model_uri=model_dir, device="cpu", swap_drain_ms="100", resume_tokens="1"))
    assert srv._swap_drain_ms == 100 and srv._resume_tokens
    bad = GenerateServer(model_uri=model_dir, device="cpu", swap_resume_policy="maybe")
    with pytest.raises(ValueError, match="swap_resume_policy"):
        bad.load()


def test_default_api_type_is_both(tmp_path, monkeypatch):
    """With no api_type the microservice serves REST and gRPC, as the JAX
    package's does (``seldon_core_tpu/microservice.py``). Where grpc does
    not import, that default fails at start with the ImportError, as the
    JAX package's does, and never drops quietly to REST alone."""
    import sys

    (tmp_path / "Comp.py").write_text(
        "class Comp:\n"
        "    def predict(self, X, names, meta=None):\n"
        "        return X\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "grpc", None)  # `import grpc` raises
    served = []

    async def serve_rest(*args, **kwargs):
        served.append(args)

    monkeypatch.setattr(microservice, "serve_rest", serve_rest)
    with pytest.raises(ImportError):
        microservice.main(["Comp", "--no-warmup"])
    with pytest.raises(ImportError):
        microservice.main(["Comp", "BOTH", "--no-warmup"])
    assert not served
    microservice.main(["Comp", "REST", "--no-warmup"])  # REST alone needs no grpc
    assert len(served) == 1
