"""The engine's ``seldon_engine_prefix_cache_hit_tokens`` roll-up in
seldon_core_tpu_torch against the JAX package's engine on the same
weights and traffic.

A generate graph with the prefix cache on answers the same prompt over
unary REST (a miss, then a hit), SSE and gRPC GenerateStream. After each
request the engine's counter must equal the JAX engine's: the unary
path sums the response's ``cache_hit_tokens``, the stream paths read the
final event's.
"""

import json

import grpc
import numpy as np
import pytest
import torch

from _torch_engine import GEN_PARAMS, Served, build_app, close_app, make_model_dir
from seldon_core_tpu_torch.payload import json_to_proto
from seldon_core_tpu_torch.proto import prediction_pb2 as pb
from seldon_core_tpu_torch.proto.services import method_path

torch.set_num_threads(1)

JAX, PORT = "seldon_core_tpu", "seldon_core_tpu_torch"
SERIES = "seldon_engine_prefix_cache_hit_tokens"
PREFIX_PARAMS = [
    {"name": "prefix_cache_hbm_bytes", "value": str(1 << 20), "type": "INT"},
    {"name": "prefix_cache_min_tokens", "value": "4", "type": "INT"},
]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("llm"))


def _counts(pkg, model_dir, prompt):
    """The engine's counter after each of: unary, unary again, SSE, gRPC."""
    unit = {"name": "llm", "implementation": "GENERATE_SERVER", "modelUri": model_dir,
            "parameters": GEN_PARAMS + PREFIX_PARAMS}
    body = {"jsonData": {"prompt_tokens": prompt, "max_new_tokens": 3}}
    app = build_app(pkg, unit)
    counts = []
    try:
        with Served(app, grpc=True) as served:
            for _ in range(2):
                status, raw = served.post("/api/v0.1/predictions", body)
                assert status == 200, raw
                counts.append(app.metrics.counter_total(SERIES))
            status, _ctype, events = served.sse(body)
            assert status == 200 and events[-1]["done"]
            counts.append(app.metrics.counter_total(SERIES))
            with grpc.insecure_channel(f"127.0.0.1:{served.grpc_port}") as ch:
                rpc = ch.unary_stream(method_path("Seldon", "GenerateStream"),
                                      request_serializer=lambda m: m.SerializeToString(),
                                      response_deserializer=pb.SeldonMessage.FromString)
                assert list(rpc(json_to_proto(json.loads(json.dumps(body))), timeout=120))
            counts.append(app.metrics.counter_total(SERIES))
    finally:
        close_app(app)
    return counts


def test_prefix_cache_hit_rollup_equals_jax(model_dir):
    prompt = np.random.RandomState(23).randint(0, 256, 24).tolist()
    port, jax_counts = _counts(PORT, model_dir, prompt), _counts(JAX, model_dir, prompt)
    assert port == jax_counts
    # a miss, then a hit on each of unary, SSE and gRPC
    assert port[0] == 0 and port[1] > 0
    assert port[2] - port[1] == port[1] and port[3] - port[2] == port[1]
