"""Shared fixtures for the engine tests of seldon_core_tpu_torch: a tiny
float32 LLM directory both packages load, spec builders, and a harness
serving an EngineApp of either package on real sockets from a
background event-loop thread."""

import asyncio
import http.client
import json
import socket
import threading

CFG = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, max_seq=64, dtype="float32")

# generate-server parameters both engines get (the JAX server accepts
# and ignores ``device``)
GEN_PARAMS = [
    {"name": "device", "value": "cpu", "type": "STRING"},
    {"name": "slots", "value": "2", "type": "INT"},
    {"name": "steps_per_poll", "value": "2", "type": "INT"},
]


def make_model_dir(path):
    """The JAX package's ``init_params(0)`` as the port's npz checkpoint;
    the JAX server initialises the same weights from seed 0."""
    import jax
    import numpy as np

    from seldon_core_tpu.models.llm import DecoderLM as JaxLM
    from seldon_core_tpu_torch.convert import save_npz

    params = jax.jit(JaxLM(**CFG).init_params)(0)
    save_npz(jax.tree.map(np.asarray, params), str(path / "params.npz"))
    (path / "jax_config.json").write_text(
        json.dumps({"family": "llm", "config": CFG, "checkpoint": "params.npz"})
    )
    return str(path)


def gen_unit(model_dir, name="llm", **extra):
    return {"name": name, "implementation": "GENERATE_SERVER",
            "modelUri": model_dir, "parameters": GEN_PARAMS, **extra}


def rag_graph(model_dir, max_new_tokens=6, temperature=0.0, seed=0):
    """RAG_PROMPT_BUILDER (transformer) -> GENERATE_SERVER."""
    return {
        "name": "rag", "implementation": "RAG_PROMPT_BUILDER",
        "parameters": [
            {"name": "max_new_tokens", "value": str(max_new_tokens), "type": "INT"},
            {"name": "temperature", "value": str(temperature), "type": "FLOAT"},
            {"name": "seed", "value": str(seed), "type": "INT"},
        ],
        "children": [gen_unit(model_dir)],
    }


def build_spec(pkg, graph, annotations=None, name="p"):
    spec_mod = __import__(f"{pkg}.graph.spec", fromlist=["spec"])
    spec = spec_mod.PredictorSpec.from_dict(
        {"name": name, "graph": graph, "annotations": annotations or {}})
    spec = spec_mod.default_predictor(spec)
    spec_mod.validate_predictor(spec)
    return spec


def build_app(pkg, graph, annotations=None, **kw):
    """An EngineApp of ``pkg`` ("seldon_core_tpu" or
    "seldon_core_tpu_torch") over ``graph`` with its own registry."""
    service = __import__(f"{pkg}.graph.service", fromlist=["service"])
    metrics = __import__(f"{pkg}.graph.engine_metrics", fromlist=["m"])
    return service.EngineApp(build_spec(pkg, graph, annotations),
                             metrics=metrics.MetricsRegistry(), **kw)


def dispatch(rest, path, body=None, method="POST", headers=None):
    """One request through an app's REST router, without sockets."""
    request_cls = type(rest).__module__.rsplit(".", 1)[0] + ".http_server"
    Request = __import__(request_cls, fromlist=["Request"]).Request
    data = json.dumps(body).encode() if body is not None else b""
    hdrs = {"content-type": "application/json"} if data else {}
    hdrs.update(headers or {})
    resp = asyncio.run(rest._dispatch(Request(method, path, "", hdrs, data)))
    ctype = resp.content_type
    out = json.loads(resp.body) if ctype == "application/json" and resp.body else resp.body
    return resp.status, out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Served:
    """An EngineApp served on loopback REST (and gRPC when asked) from a
    background event-loop thread."""

    def __init__(self, app, grpc=False):
        self.app = app
        self.http_port = free_port()
        self.grpc_port = free_port() if grpc else None
        self._grpc = grpc
        self._stopped = threading.Event()

    def __enter__(self):
        started = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            self._loop = loop
            self._stop = asyncio.Event()

            async def amain():
                http = self.app.rest_app()
                await http.start("127.0.0.1", self.http_port)
                gsrv = None
                if self._grpc:
                    gsrv = self.app.grpc_server()
                    gsrv.add_insecure_port(f"127.0.0.1:{self.grpc_port}")
                    await gsrv.start()
                started.set()
                await self._stop.wait()
                http.close()
                if gsrv is not None:
                    await gsrv.stop(grace=0.1)
                await self.app.executor.close()

            loop.run_until_complete(amain())
            loop.close()
            self._stopped.set()

        threading.Thread(target=run, daemon=True).start()
        assert started.wait(120), "engine did not start"
        return self

    def __exit__(self, *exc):
        self._loop.call_soon_threadsafe(self._stop.set)
        self._stopped.wait(10)

    def post(self, path, body, headers=None, timeout=120):
        conn = http.client.HTTPConnection("127.0.0.1", self.http_port, timeout=timeout)
        try:
            conn.request("POST", path, json.dumps(body).encode(),
                         {"Content-Type": "application/json", **(headers or {})})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def sse(self, body, timeout=120):
        """POST /api/v0.1/generate; (status, content type, [events])."""
        status, raw = None, b""
        conn = http.client.HTTPConnection("127.0.0.1", self.http_port, timeout=timeout)
        try:
            conn.request("POST", "/api/v0.1/generate", json.dumps(body).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            status, ctype, raw = resp.status, resp.getheader("Content-Type"), resp.read()
        finally:
            conn.close()
        events = [json.loads(block[len("data: "):])
                  for block in raw.decode().split("\n\n") if block.startswith("data: ")]
        return status, ctype, events


def generator_of(app):
    """The in-process GenerateServer behind a single-unit or two-unit
    generate graph."""
    rt = app.executor.root
    while rt.children:
        rt = rt.children[0]
    return rt.client.user_object


def close_app(app):
    gen = generator_of(app)
    if getattr(gen, "batcher", None) is not None:
        gen.batcher.close()
    app.executor._pool.shutdown(wait=False)
