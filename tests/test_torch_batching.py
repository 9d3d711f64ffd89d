"""Engine-side micro-batching of seldon_core_tpu_torch (graph/batching.py),
on the CPU.

Mirrors the JAX package's micro-batching cases (tests/test_engine_service.py)
on the port's engine: concurrent requests fuse, a lone request passes
through, annotations turn it on with metrics, padding is capped at
max_batch, bf16 outputs split as raw, each caller's rows come back in its
own encoding, and the device path (slabs put on the device at arrival,
fused there, handed on under ``__torch__``). Then what the port adds:
the device put's fallback count and H2D time, and the same concurrent
requests to an MLP through both engines giving the same rows.
"""

import asyncio

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch import payload
from seldon_core_tpu_torch.graph.batching import (
    MicroBatchingClient,
    _bucket,
    batching_from_annotations,
)
from seldon_core_tpu_torch.graph.client import InProcessClient
from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
from seldon_core_tpu_torch.graph.service import EngineApp
from seldon_core_tpu_torch.graph.spec import PredictorSpec, default_predictor
from seldon_core_tpu_torch.user_model import SeldonComponent, TorchComponent

torch.set_num_threads(1)


def _spec(annotations=None, graph=None):
    return default_predictor(PredictorSpec.from_dict({
        "name": "d", "graph": graph or {"name": "m", "type": "MODEL"},
        "annotations": annotations or {}}))


def _app(model, batching=None, annotations=None, metrics=None):
    return EngineApp(_spec(annotations), registry={"m": model},
                     metrics=metrics or MetricsRegistry(), batching=batching)


def _fire(app, bodies):
    async def go():
        return await asyncio.gather(*(app.predict(b) for b in bodies))
    return asyncio.run(go())


class CountingBatchModel(SeldonComponent):
    def __init__(self):
        self.calls = []

    def predict(self, X, names, meta=None):
        arr = np.asarray(X)
        self.calls.append(arr.shape[0])
        return arr * 2


def test_bucket():
    assert [_bucket(n, 8) for n in (1, 2, 3, 5, 8, 9, 20)] == [1, 2, 4, 8, 8, 8, 8]


def test_micro_batching_fuses_concurrent_requests():
    model = CountingBatchModel()
    app = _app(model, {"m": {"max_batch": 8, "timeout_ms": 20.0}})
    outs = _fire(app, [{"data": {"ndarray": [[float(i), 0.0]]}} for i in range(6)])
    for i, out in enumerate(outs):
        np.testing.assert_allclose(out["data"]["ndarray"], [[2.0 * i, 0.0]])
    assert len(model.calls) < 6  # fused
    assert sum(model.calls) >= 6  # padding allowed


def test_micro_batching_single_request_passthrough():
    model = CountingBatchModel()
    app = _app(model, {"m": {"max_batch": 8, "timeout_ms": 1.0}})
    out = asyncio.run(app.predict({"data": {"ndarray": [[3.0]]}}))
    np.testing.assert_allclose(out["data"]["ndarray"], [[6.0]])
    assert model.calls == [1]


def test_non_batchable_payloads_pass_through():
    class Echo(SeldonComponent):
        def predict(self, X, names, meta=None):
            return X

    app = _app(Echo(), {"m": {"max_batch": 8, "timeout_ms": 5.0}})
    outs = _fire(app, [{"strData": "a"}, {"jsonData": {"k": 1}}])
    assert outs[0]["strData"] == "a" and outs[1]["jsonData"] == {"k": 1}


def test_micro_batching_from_annotations_with_metrics():
    """Annotation-driven batching and the per-unit batch metrics in the
    engine registry (the JAX engine's series names)."""
    model = CountingBatchModel()
    registry = MetricsRegistry()
    ann = {"seldon.io/microbatch": "true", "seldon.io/microbatch-max-batch": "8",
           "seldon.io/microbatch-timeout-ms": "20"}
    app = _app(model, annotations=ann, metrics=registry)
    outs = _fire(app, [{"data": {"ndarray": [[float(i), 0.0]]}} for i in range(6)])
    assert len(outs) == 6
    assert len(model.calls) < 6  # fused via annotations alone
    flushes = registry.counter_total("seldon_engine_microbatch_flushes", {"unit": "m"})
    assert 0 < flushes < 6
    assert registry.counter_total("seldon_engine_microbatch_rows", {"unit": "m"}) == 6
    text = registry.expose()
    for series in ("seldon_engine_microbatch_flushes", "seldon_engine_microbatch_rows",
                   "seldon_engine_microbatch_padded_rows",
                   "seldon_engine_microbatch_queue_depth"):
        assert series in text
    assert 'unit="m"' in text


def test_batching_from_annotations():
    graph = {"name": "r", "type": "ROUTER", "implementation": "SIMPLE_ROUTER",
             "children": [{"name": "a", "type": "MODEL"}, {"name": "b", "type": "MODEL"}]}
    assert batching_from_annotations(_spec({}, graph)) == {}
    cfg = batching_from_annotations(_spec({
        "seldon.io/microbatch": "true", "seldon.io/microbatch-max-batch": "16",
        "seldon.io/microbatch-timeout-ms": "2.5", "seldon.io/microbatch-pad": "false"}, graph))
    assert cfg == {u: {"max_batch": 16, "timeout_ms": 2.5, "pad_to_bucket": False}
                   for u in ("a", "b")}
    with pytest.raises(ValueError, match="microbatch"):
        batching_from_annotations(_spec({"seldon.io/microbatch": "true",
                                         "seldon.io/microbatch-max-batch": "x"}, graph))


@pytest.mark.parametrize("ann", [{"seldon.io/fuse": "true"}, "mesh"])
def test_fuse_and_mesh_still_refused(ann, tmp_path):
    """Micro-batching is ported, and so are a mesh and graph fusion beside
    it; nothing is refused any more. With a serving mesh the engine
    builds as the JAX engine builds: the micro-batched registry unit
    keeps its MicroBatchingClient and fuses requests, the executor holds
    the mesh for its mesh-aware units, and the predict path's
    TorchServer (a JAX_SERVER unit) serves on it: its concurrent
    requests fuse on the mesh's compute device into one forward whose
    rows are the unmeshed server's. Beside micro-batching, fusion keeps
    the micro-batched unit on the per-unit path, counted as the
    ``microbatch`` plan reason."""
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
    from seldon_core_tpu_torch.graph.executor import GraphExecutor

    if ann == "mesh":
        from seldon_core_tpu.graph.batching import MicroBatchingClient as JaxMBC
        from seldon_core_tpu.graph.batching import batching_from_annotations as jax_batching
        from seldon_core_tpu.graph.executor import GraphExecutor as JaxExecutor
        from seldon_core_tpu.graph.spec import PredictorSpec as JaxSpec
        from seldon_core_tpu.graph.spec import default_predictor as jax_default
        from seldon_core_tpu.parallel.mesh import make_mesh
        from seldon_core_tpu_torch.parallel.mesh import make_serving_mesh

        ann = {"seldon.io/microbatch": "true"}
        mesh = make_serving_mesh({"data": 2, "model": 4}, device="cpu")
        spec = _spec(ann)
        model = CountingBatchModel()
        ex = GraphExecutor(spec, registry={"m": model}, mesh=mesh,
                           batching=batching_from_annotations(spec))
        jspec = jax_default(JaxSpec.from_dict({
            "name": "d", "graph": {"name": "m", "type": "MODEL"}, "annotations": ann}))
        jex = JaxExecutor(jspec, registry={"m": CountingBatchModel()},
                          mesh=make_mesh({"data": 2, "model": 4}),
                          batching=jax_batching(jspec))
        assert ex._mesh is mesh
        assert isinstance(ex.root.client, MicroBatchingClient)
        assert isinstance(jex.root.client, JaxMBC)

        async def burst():
            return await asyncio.gather(*[
                ex.predict({"data": {"ndarray": [[float(i)]]}}) for i in range(4)])

        outs = asyncio.run(burst())
        assert [o["data"]["ndarray"] for o in outs] == [[[2.0 * i]] for i in range(4)]
        asyncio.run(ex.close())
        import json

        from seldon_core_tpu_torch.servers.torchserver import TorchServer

        (tmp_path / "jax_config.json").write_text(json.dumps({"family": "mlp", "config": {
            "in_features": 4, "hidden": [8], "num_classes": 3, "dtype": "float32"}}))
        torch_unit = _spec(ann, {"name": "c", "type": "MODEL", "implementation": "JAX_SERVER",
                                 "modelUri": str(tmp_path), "parameters": [
                                     {"name": "device", "value": "cpu", "type": "STRING"}]})
        tex = GraphExecutor(torch_unit, mesh=mesh, batching=batching_from_annotations(torch_unit))
        mbc = tex.root.client
        assert isinstance(mbc, MicroBatchingClient)
        server = mbc.inner.user_object
        assert server._mesh is mesh and server.device == mesh.device
        seen = []
        forward = server._apply

        def spy(params, x):
            seen.append((x.device, tuple(x.shape)))
            return forward(params, x)

        server._apply = spy
        rows = np.random.RandomState(4).randn(4, 2, 4).astype(np.float32)

        async def fused():
            return await asyncio.gather(*[
                tex.predict({"data": {"ndarray": r.tolist()}}) for r in rows])

        outs = asyncio.run(fused())
        assert seen and all(dev == mesh.device for dev, _ in seen)
        assert max(shape[0] for _, shape in seen) > 2  # requests fused
        assert mbc.prefetch_failures == 0  # every 2-row slab tiles data=2
        plain = TorchServer(model_uri=str(tmp_path), device="cpu")
        plain.load()
        for r, o in zip(rows, outs):
            want = payload.json_data_to_array({"ndarray": plain.predict(r, []).tolist()})
            np.testing.assert_array_equal(payload.json_data_to_array(o["data"]), want)
        asyncio.run(tex.close())
        return
    spec = _spec({"seldon.io/microbatch": "true", **ann})
    model = CountingBatchModel()
    metrics = MetricsRegistry()
    ex = GraphExecutor(spec, registry={"m": model}, metrics=metrics,
                       batching=batching_from_annotations(spec))
    assert ex.fusion.segments == {}
    assert metrics.counter_total("seldon_engine_fusion_fallbacks",
                                 {"unit": "m", "reason": "microbatch"}) == 1.0
    assert isinstance(ex.root.client, MicroBatchingClient)


def test_micro_batching_padding_capped_at_max_batch():
    """An oversized flush (> max_batch rows) passes through unpadded."""
    model = CountingBatchModel()
    client = MicroBatchingClient(InProcessClient(model), max_batch=4, timeout_ms=5.0)

    async def go(*bodies):
        return await asyncio.gather(*(client.call("predict", b) for b in bodies))

    outs = asyncio.run(go({"data": {"ndarray": [[1.0]] * 3}},
                          {"data": {"ndarray": [[2.0]] * 3}}))
    assert len(outs) == 2 and 6 in model.calls  # no padding past max_batch
    outs = asyncio.run(go({"data": {"ndarray": [[1.0]] * 2}}, {"data": {"ndarray": [[3.0]]}}))
    assert outs[1]["data"]["ndarray"] == [[6.0]]
    assert 4 in model.calls  # 3 rows padded to bucket 4


def test_mismatched_trailing_dims_fail_every_waiter():
    model = CountingBatchModel()
    client = MicroBatchingClient(InProcessClient(model), max_batch=8, timeout_ms=20.0)

    async def go():
        return await asyncio.gather(
            client.call("predict", {"data": {"ndarray": [[1.0, 2.0]]}}),
            client.call("predict", {"data": {"ndarray": [[1.0, 2.0, 3.0]]}}),
            return_exceptions=True)

    outs = asyncio.run(go())
    assert all(isinstance(o, ValueError) and "mismatched" in str(o) for o in outs)
    assert model.calls == []


class Bf16BatchModel(SeldonComponent):
    """Outputs bfloat16 (TorchComponent's default compute dtype): the split
    must answer raw even to a JSON ndarray caller."""

    def predict(self, X, names, meta=None):
        return torch.as_tensor(np.asarray(X) * 2).to(torch.bfloat16)


def test_micro_batching_bf16_output_splits_as_raw():
    app = _app(Bf16BatchModel(), {"m": {"max_batch": 8, "timeout_ms": 20.0}})
    outs = _fire(app, [{"data": {"ndarray": [[float(i), 1.0]]}} for i in range(4)])
    for i, out in enumerate(outs):
        assert "raw" in out["data"], out["data"].keys()
        arr = payload.json_data_to_array(out["data"])
        np.testing.assert_allclose(np.asarray(arr, dtype=np.float32), [[2.0 * i, 2.0]])


def test_micro_batching_int_requests_mirror_requester_encoding():
    """Int token batches fuse over raw bytes, but each JSON ndarray caller
    gets ndarray back, and a raw caller raw."""
    model = CountingBatchModel()
    app = _app(model, {"m": {"max_batch": 8, "timeout_ms": 20.0}})
    raw = payload.array_to_json_data(np.asarray([[7, 8]], np.int32), [], "raw")
    outs = _fire(app, [{"data": {"ndarray": [[i, i + 1]]}} for i in range(3)]
                 + [{"data": raw}])
    assert len(model.calls) < 4  # fused
    for i, out in enumerate(outs[:3]):
        assert "ndarray" in out["data"], out["data"].keys()
        np.testing.assert_allclose(out["data"]["ndarray"], [[2 * i, 2 * (i + 1)]])
    assert "raw" in outs[3]["data"]
    np.testing.assert_array_equal(payload.json_data_to_array(outs[3]["data"]), [[14, 16]])


class Doubler(TorchComponent):
    warmup_shape = (2,)

    def __init__(self, seen):
        super().__init__(device="cpu")
        self.seen = seen

    def build(self):
        return (lambda params, x: x * 2.0), {}

    def predict(self, X, names, meta=None):
        self.seen.append(type(X).__name__)
        return super().predict(X, names, meta)


def test_micro_batching_device_path_fuses_on_the_device():
    """An in-process TorchComponent takes the device path: slabs put on its
    device at arrival, fused with one torch.cat, and the forward handed a
    tensor under ``__torch__``; each caller's response still mirrors its
    encoding (bf16 forces raw)."""
    seen = []
    model = Doubler(seen)
    model.load()
    app = _app(model, {"m": {"max_batch": 8, "timeout_ms": 20.0}})
    outs = _fire(app, [{"data": {"ndarray": [[float(i), 1.0]]}} for i in range(6)])
    for i, out in enumerate(outs):
        got = np.asarray(payload.json_data_to_array(out["data"]), np.float64)
        np.testing.assert_allclose(got, [[2.0 * i, 2.0]])
    assert seen and all(t == "Tensor" for t in seen)
    assert len(seen) < 6  # fused
    client = app.executor.root.client
    assert client.h2d_puts == 6 and client.h2d_seconds > 0 and client.prefetch_failures == 0


def test_micro_batching_device_path_singleton_no_redecode():
    """A singleton flush whose slab is already on the device goes through
    the device hop, not a re-decode of the wire message."""
    seen = []
    model = Doubler(seen)
    model.load()
    app = _app(model, {"m": {"max_batch": 8, "timeout_ms": 1.0}})
    out = asyncio.run(app.predict({"data": {"ndarray": [[3.0, 1.0]]}}))
    np.testing.assert_allclose(
        np.asarray(payload.json_data_to_array(out["data"]), np.float64), [[6.0, 2.0]])
    assert seen == ["Tensor"]


def test_failed_device_put_fuses_on_the_host_and_counts():
    """A slab whose device put raises stays on the host; its flush fuses
    there (the forward still runs) and the client counts the failure."""
    seen = []
    model = Doubler(seen)
    model.load()
    app = _app(model, {"m": {"max_batch": 8, "timeout_ms": 20.0}})
    client = app.executor.root.client

    def broken(arr):
        raise RuntimeError("no device memory")

    client.inner.device_put = broken
    outs = _fire(app, [{"data": {"ndarray": [[float(i), 1.0]]}} for i in range(4)])
    for i, out in enumerate(outs):
        got = np.asarray(payload.json_data_to_array(out["data"]), np.float64)
        np.testing.assert_allclose(got, [[2.0 * i, 2.0]])
    assert client.prefetch_failures == 4
    assert len(seen) < 4


def test_mlp_rows_per_request_equal_jax_engine(tmp_path):
    """The same concurrent requests to an MLP through both engines, each
    with micro-batching on: every caller gets the same rows."""
    import json

    import jax

    from seldon_core_tpu import models as jax_models
    from seldon_core_tpu.graph.engine_metrics import MetricsRegistry as JaxRegistry
    from seldon_core_tpu.graph.service import EngineApp as JaxEngineApp
    from seldon_core_tpu.graph.spec import PredictorSpec as JaxSpec
    from seldon_core_tpu.graph.spec import default_predictor as jax_default
    from seldon_core_tpu_torch.convert import save_npz

    cfg = {"dtype": "float32"}
    save_npz(jax.tree.map(np.asarray, jax_models.build("mlp", **cfg).init_params(0)),
             str(tmp_path / "params.npz"))
    (tmp_path / "jax_config.json").write_text(json.dumps(
        {"family": "mlp", "config": cfg, "checkpoint": "params.npz"}))
    graph = {"name": "m", "implementation": "JAX_SERVER", "modelUri": str(tmp_path),
             "parameters": [{"name": "device", "value": "cpu", "type": "STRING"}]}
    ann = {"seldon.io/microbatch": "true", "seldon.io/microbatch-max-batch": "16",
           "seldon.io/microbatch-timeout-ms": "50"}
    rs = np.random.RandomState(0)
    bodies = [{"data": {"ndarray": rs.randn(n, 4).round(3).tolist()}} for n in (1, 3, 2, 1)]

    jax_graph = dict(graph, parameters=[])
    jax_app = JaxEngineApp(jax_default(JaxSpec.from_dict(
        {"name": "p", "graph": jax_graph, "annotations": ann})), metrics=JaxRegistry())
    registry = MetricsRegistry()
    port_app = EngineApp(default_predictor(PredictorSpec.from_dict(
        {"name": "p", "graph": graph, "annotations": ann})), metrics=registry)
    want = [o["data"]["ndarray"] for o in _fire(jax_app, bodies)]
    got = [o["data"]["ndarray"] for o in _fire(port_app, bodies)]
    assert registry.counter_total("seldon_engine_microbatch_flushes") < len(bodies)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(g).sum(-1), 1.0, rtol=1e-5)
