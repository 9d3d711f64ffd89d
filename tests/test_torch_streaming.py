"""Token streaming of the port's engine (SSE at /api/v0.1/generate) and of
``GenerateServer.stream``, on the CPU, against the JAX package's engine
on the same weights.

Streamed spans must concatenate to the unary result, which must equal
the JAX engine's final tokens (greedy and seeded). Validation is eager
(a batch body is a 400 before any stream byte), a multi-node graph is a
501, and a client that drops the stream cancels its request and frees
the decode lane. Each JAX reference request runs alone.
"""

import json
import socket
import time

import pytest
import torch

from _torch_engine import (
    Served,
    build_app,
    close_app,
    dispatch,
    gen_unit,
    generator_of,
    make_model_dir,
    rag_graph,
)

torch.set_num_threads(1)

JAX, PORT = "seldon_core_tpu", "seldon_core_tpu_torch"


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("llm"))


@pytest.fixture(scope="module")
def jax_app(model_dir):
    app = build_app(JAX, gen_unit(model_dir))
    yield app
    close_app(app)


@pytest.fixture(scope="module")
def port(model_dir):
    app = build_app(PORT, gen_unit(model_dir))
    with Served(app) as served:
        yield served
    close_app(app)


BODIES = [
    {"prompt_tokens": [5, 17, 42], "max_new_tokens": 10},
    {"prompt_tokens": [[9, 8, 7, 6]], "max_new_tokens": 11, "temperature": 0.9,
     "seed": 21},
    {"prompt": "hi there", "max_new_tokens": 8, "temperature": 1.1, "seed": 2},
]


@pytest.mark.parametrize("body", BODIES)
def test_sse_spans_concatenate_to_unary_and_jax(port, jax_app, body):
    status, raw = port.post("/api/v0.1/predictions", {"jsonData": body})
    assert status == 200
    unary = json.loads(raw)["jsonData"]
    _s, want = dispatch(jax_app.rest_app(), "/api/v0.1/predictions", {"jsonData": body})
    assert unary == want["jsonData"]

    status, ctype, events = port.sse({"jsonData": body})
    assert status == 200 and ctype == "text/event-stream"
    final = events[-1]
    assert final["done"] is True and final["tokens"] == unary["tokens"][0]
    prompt_len = len(final["tokens"]) - body["max_new_tokens"]
    streamed = [t for ev in events[:-1] for t in ev["tokens"]]
    assert streamed == unary["tokens"][0][prompt_len:]
    assert len(events) > 2  # incremental, not one blob
    if "prompt" in body:
        assert "".join(ev["text"] for ev in events[:-1]) == unary["text"][0]
        assert final["text"] == unary["text"][0]


def test_stream_validates_eagerly(port):
    gen = generator_of(port.app)
    with pytest.raises(ValueError, match="ONE prompt"):
        gen.stream({"prompt_tokens": [[1, 2], [3, 4]]})
    status, _ctype, events = port.sse({"jsonData": {"prompt_tokens": [[1, 2], [3, 4]]}})
    assert status == 400 and events == []
    status, _ctype, _ev = port.sse({"jsonData": {"prompt_tokens": list(range(64)),
                                                 "max_new_tokens": 2}})
    assert status == 413
    # a malformed resume token is a client fault (the token is ported)
    status, _ctype, _ev = port.sse({"jsonData": {"resume_token": "x"}})
    assert status == 400


def test_multi_node_graph_streaming_is_501(model_dir):
    app = build_app(PORT, rag_graph(model_dir))
    try:
        with Served(app) as served:
            status, _ctype, _ev = served.sse({"jsonData": {"prompt_tokens": [1, 2]}})
        assert status == 501
    finally:
        close_app(app)
    app = build_app(PORT, {"name": "m", "implementation": "SIMPLE_MODEL"})
    with Served(app) as served:
        assert served.sse({"jsonData": {"prompt_tokens": [1, 2]}})[0] == 501


def test_disconnect_cancels_request_and_frees_lane(port):
    """Dropping the connection after the first event cancels the
    request: the batcher counts it cancelled, the engine's in-flight
    gauge returns to zero, and the next request is admitted."""
    b = generator_of(port.app).batcher
    cancelled = b.stats["cancelled"]
    body = json.dumps({"jsonData": {"prompt_tokens": [3, 4, 5], "max_new_tokens": 55}}).encode()
    sock = socket.create_connection(("127.0.0.1", port.http_port))
    sock.sendall(b"POST /api/v0.1/generate HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    assert sock.recv(16).startswith(b"HTTP/1.1 200")  # the stream is live
    sock.close()  # the client vanishes mid-stream
    t0 = time.monotonic()
    while (b.stats["cancelled"] == cancelled or port.app.inflight) and time.monotonic() - t0 < 60:
        time.sleep(0.02)
    assert b.stats["cancelled"] == cancelled + 1
    assert port.app.inflight == 0
    status, raw = port.post("/api/v0.1/predictions", {"jsonData": {
        "prompt_tokens": [1, 2], "max_new_tokens": 3}})
    assert status == 200 and len(json.loads(raw)["jsonData"]["tokens"][0]) == 5


def test_stream_handle_cancel_frees_lane(port):
    gen = generator_of(port.app)
    b = gen.batcher
    cancelled = b.stats["cancelled"]
    handle = gen.stream({"prompt_tokens": [7, 7, 7], "max_new_tokens": 50})
    first = next(iter(handle.chunks))
    assert first["tokens"]
    assert handle.cancel()
    t0 = time.monotonic()
    while b.stats["cancelled"] == cancelled and time.monotonic() - t0 < 60:
        time.sleep(0.02)
    assert b.stats["cancelled"] == cancelled + 1
