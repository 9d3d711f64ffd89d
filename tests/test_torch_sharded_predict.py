"""Sharded predict in seldon_core_tpu_torch (a serving mesh for
``TorchComponent``, ``TorchServer``, the zoo and the ``Explainer``)
against the JAX package on the CPU.

The port's ``ServingMesh`` stands for 8 CPU positions (data=2, model=4)
beside a JAX mesh of the same shape over the 8 virtual CPU devices. The
same model directory (the JAX package's seed-0 params written as
``params.npz``, the small configs of ``tests/test_torch_zoo.py``) is
served by both packages on the same numpy-seeded inputs.

* Port meshed equals port unmeshed bit for bit at float32: the port
  stores the params split and gathers each layer onto the compute
  device, so the arithmetic is the one-device forward's.
* Port meshed equals JAX meshed within 1e-5 of the largest |output|,
  with equal argmax: JAX partitions the compute (partial sums plus an
  all-reduce), so the summation order differs.
* IG attributions hold the same two gates.
"""

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu import models as jax_models
from seldon_core_tpu.parallel.mesh import make_mesh
from seldon_core_tpu_torch import models as torch_models
from seldon_core_tpu_torch.convert import save_npz
from seldon_core_tpu_torch.parallel.mesh import ShardedTensor, make_serving_mesh

from test_torch_zoo import FAMILIES, _inputs, _rel_err

torch.set_num_threads(2)

SHAPE = {"data": 2, "model": 4}
TOL = 1e-5


@pytest.fixture(scope="module")
def meshes():
    return make_mesh(dict(SHAPE)), make_serving_mesh(dict(SHAPE), device="cpu")


def _model_dir(path, family, **extra):
    cfg = dict(FAMILIES[family], dtype="float32", **extra)
    path.mkdir(parents=True, exist_ok=True)
    params = jax_models.build(family, **cfg).init_params(0)
    save_npz(jax.tree.map(np.asarray, params), str(path / "params.npz"))
    (path / "jax_config.json").write_text(json.dumps(
        {"family": family, "config": cfg, "checkpoint": "params.npz"}))
    return str(path)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo")
    return {f: _model_dir(root / f, f) for f in FAMILIES}


def _even(x):
    """A batch that tiles data=2."""
    return x if x.shape[0] % 2 == 0 else np.concatenate([x, x[:1]])


def _servers(model_dir, meshes):
    from seldon_core_tpu.servers.jaxserver import JAXServer
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    jmesh, tmesh = meshes
    jax_meshed = JAXServer(model_dir, mesh=jmesh)
    plain = TorchServer(model_dir, device="cpu")
    meshed = TorchServer(model_dir, device="cpu", mesh=tmesh)
    for s in (jax_meshed, plain, meshed):
        s.load()
    return jax_meshed, plain, meshed


# -- the sharding rules -----------------------------------------------------


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "spec"):
        return {k: v for i, leaf in enumerate(tree) for k, v in _flat(leaf, path + (i,)).items()}
    return {path: tree}


def _norm(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


LLM = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
           max_seq=32, dtype="float32")


@pytest.mark.parametrize("shape", [{"data": 2, "model": 4}, {"data": 8}, {"model": 8}])
@pytest.mark.parametrize("family", sorted(FAMILIES) + ["llm"])
def test_sharding_specs_equal_jax(family, shape):
    """``param_sharding``'s specs equal the JAX ``PartitionSpec``s leaf for
    leaf, and ``input_sharding``'s spec equals JAX's."""
    cfg = LLM if family == "llm" else dict(FAMILIES[family], dtype="float32")
    jm, tm = jax_models.build(family, **cfg), torch_models.build(family, **cfg)
    jparams = jm.init_params(0)
    tparams = tm.init_params(0, device="cpu")
    jmesh, tmesh = make_mesh(dict(shape)), make_serving_mesh(dict(shape), device="cpu")
    want = {k: _norm(v.spec) for k, v in _flat(jax.tree_util.tree_map(
        lambda s: s, jm.param_sharding(jmesh, jparams),
        is_leaf=lambda s: hasattr(s, "spec"))).items()}
    got = {k: _norm(v.spec) for k, v in _flat(tm.param_sharding(tmesh, tparams)).items()}
    assert got == want
    assert _norm(tm.input_sharding(tmesh).spec) == _norm(jm.input_sharding(jmesh).spec)


# -- forwards ---------------------------------------------------------------


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_meshed_equals_unmeshed_and_jax(family, dirs, meshes):
    jax_meshed, plain, meshed = _servers(dirs[family], meshes)
    x = _even(_inputs(family))
    got = meshed.predict(x, []).float().numpy()
    np.testing.assert_array_equal(got, plain.predict(x, []).float().numpy())
    want = np.asarray(jax_meshed.predict(x, [])).astype(np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_err(got, want) <= TOL, _rel_err(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    if family in ("bert", "vit"):
        blocks = meshed.params["blocks"]
        for name, split in (("wq", 2), ("w1", 2), ("wo", 1), ("w2", 1)):
            leaf = blocks[name]
            assert isinstance(leaf, ShardedTensor) and leaf.sharding.split_dims() == {
                split: "model"}
        assert not isinstance(blocks["wq_b"], ShardedTensor)


@pytest.mark.parametrize("family", ["mlp", "bert"])
def test_non_tiling_batch_refused_in_both(family, dirs, meshes):
    """A batch that does not tile ``data`` is refused with a ValueError
    in both packages (JAX: the device put of the request)."""
    jax_meshed, _plain, meshed = _servers(dirs[family], meshes)
    x = _inputs(family)[:3]
    with pytest.raises(ValueError):
        jax_meshed.predict(x, [])
    with pytest.raises(ValueError, match="does not divide over data=2"):
        meshed.predict(x, [])


def test_bert_prepared_bf16_weights_stay_split(tmp_path, meshes):
    """At bfloat16 the forward's compute-dtype copies of the matmul
    weights are cast block by block: they stay split over ``model``, and
    no whole bf16 copy sits on the compute device."""
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    d = _model_dir(tmp_path, "bert")
    cfg = json.loads((tmp_path / "jax_config.json").read_text())
    cfg["config"]["dtype"] = "bfloat16"
    (tmp_path / "jax_config.json").write_text(json.dumps(cfg))
    _jmesh, tmesh = meshes
    meshed = TorchServer(d, device="cpu", mesh=tmesh)
    plain = TorchServer(d, device="cpu")
    meshed.load()
    plain.load()
    prep = meshed._model.prepared(meshed.params)["blocks"]
    for name in ("wq", "wk", "wv", "w1", "wo", "w2"):
        leaf = prep[name]
        assert isinstance(leaf, ShardedTensor) and leaf.dtype == torch.bfloat16
        assert len(leaf.blocks()) == 4
        assert leaf.shard_nbytes * 4 == leaf.nbytes
    x = _inputs("bert")[:2]
    torch.testing.assert_close(meshed.predict(x, []), plain.predict(x, []), rtol=0, atol=0)


def test_concurrent_meshed_predicts_equal_unmeshed(tmp_path, meshes):
    """Concurrent requests to a meshed BERT through the engine (its
    in-process units run in a thread pool) each get the unmeshed
    server's logits bit for bit: every forward gathers the split layers
    into tensors of its own."""
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    pkg = "seldon_core_tpu_torch"
    d = _model_dir(tmp_path, "bert", n_layers=4)
    _jmesh, tmesh = meshes
    app = _engine(pkg, _unit("b", d, pkg), tmesh)
    plain = TorchServer(d, device="cpu")
    plain.load()
    rs = np.random.RandomState(3)
    batches = [rs.randint(1, 100, (4, 16)).astype(np.int32) for _ in range(16)]
    try:
        for _round in range(3):
            outs = _fire(app, [{"data": {"ndarray": b.tolist()}} for b in batches])
            for b, out in zip(batches, outs):
                assert not isinstance(out, Exception), out
                want = plain.predict(b, []).float().numpy()
                np.testing.assert_array_equal(
                    np.asarray(out["data"]["ndarray"], dtype=np.float32), want)
    finally:
        asyncio.run(app.executor.close())


def test_mesh_placement_lets_each_whole_leaf_go(dirs, meshes):
    """``place_params`` under a mesh replaces each leaf of the tree it is
    given by its placed form: no whole split leaf outlives its blocks."""
    import weakref

    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    _jmesh, tmesh = meshes
    server = TorchServer(dirs["bert"], device="cpu", mesh=tmesh)
    _apply, params = server.build()
    whole = weakref.ref(params["blocks"]["wq"])
    placed = server.place_params(params)
    assert isinstance(placed["blocks"]["wq"], ShardedTensor)
    assert whole() is None


# -- explanation ------------------------------------------------------------


@pytest.mark.parametrize("family", ["mlp", "vit", "resnet50"])
def test_meshed_ig_equals_unmeshed_and_jax(family, dirs, meshes):
    """IG through the meshed forward (autograd through the gathers of
    every layer) equals the unmeshed explainer's bit for bit, and the
    JAX meshed explainer's within 1e-5 with equal targets."""
    from seldon_core_tpu.components.explainer import Explainer as JaxExplainer
    from seldon_core_tpu_torch.components.explainer import Explainer

    jmesh, tmesh = meshes
    kw = dict(explainer_type="integrated_gradients", model_uri=dirs[family], n_steps=4)
    x = _even(_inputs(family)).astype(np.float32)
    outs = [e.explain(x, []) for e in (
        Explainer(device="cpu", mesh=tmesh, **kw), Explainer(device="cpu", **kw),
        JaxExplainer(mesh=jmesh, **kw))]
    meshed, plain, jax_out = outs
    assert meshed == plain
    assert meshed["target"] == jax_out["target"]
    got, want = np.asarray(meshed["attributions"]), np.asarray(jax_out["attributions"])
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    assert _rel_err(got, want) <= TOL, _rel_err(got, want)


# -- the engine -------------------------------------------------------------


def _engine(pkg, graph, mesh, annotations=None):
    spec_m = __import__(f"{pkg}.graph.spec", fromlist=["x"])
    service = __import__(f"{pkg}.graph.service", fromlist=["x"])
    batching = __import__(f"{pkg}.graph.batching", fromlist=["x"])
    spec = spec_m.default_predictor(spec_m.PredictorSpec.from_dict({
        "name": "p", "graph": json.loads(json.dumps(graph)),
        "annotations": dict(annotations or {})}))
    return service.EngineApp(spec, mesh=mesh, batching=batching.batching_from_annotations(spec))


def _unit(name, model_dir, pkg, **extra):
    u = {"name": name, "type": "MODEL", "implementation": "JAX_SERVER", "modelUri": model_dir,
         **extra}
    if pkg == "seldon_core_tpu_torch":
        u["parameters"] = [{"name": "device", "value": "cpu", "type": "STRING"}]
    return u


def _fire(app, bodies):
    async def go():
        return await asyncio.gather(*[app.predict(b) for b in bodies], return_exceptions=True)

    return asyncio.run(go())


def test_microbatched_single_row_flush_as_jax(dirs, meshes):
    """A micro-batched meshed unit at data=2: requests of one row each
    cannot go to the device alone (a row does not tile ``data``), so
    they fuse on the host and a flush pads to a bucket that tiles it.
    A flush of ONE such request reaches the unit unpadded and is refused
    there, in the JAX engine as in the port; two and three concurrent
    rows are served, equal to the JAX engine's answers."""
    # a flush waits 500 ms: concurrent requests always share one
    ann = {"seldon.io/microbatch": "true", "seldon.io/microbatch-timeout-ms": "500"}
    row = {"data": {"ndarray": [[1.0, 2.0, 3.0, 4.0]]}}
    results = {}
    for pkg, mesh in zip(("seldon_core_tpu", "seldon_core_tpu_torch"), meshes):
        app = _engine(pkg, _unit("c", dirs["mlp"], pkg), mesh, ann)
        results[pkg] = [_fire(app, [row] * n) for n in (1, 2, 3)]
        asyncio.run(app.executor.close())
    jax_res, port_res = results["seldon_core_tpu"], results["seldon_core_tpu_torch"]
    (jone,), (pone,) = jax_res[0], port_res[0]
    assert isinstance(jone, ValueError) and isinstance(pone, ValueError)
    for jouts, pouts in zip(jax_res[1:], port_res[1:]):
        for j, p in zip(jouts, pouts):
            got, want = np.asarray(p["data"]["ndarray"]), np.asarray(j["data"]["ndarray"])
            assert _rel_err(got, want) <= TOL


def test_fused_two_stage_meshed_graph_equals_hop_walk(tmp_path, meshes):
    """ViT then an MLP over its 10 logits, both JAX_SERVER units on the
    engine's mesh: the fusion planner fuses the chain (every stage on
    the engine's mesh), and the fused segment answers what the hop walk
    answers, byte for byte."""
    vit = _model_dir(tmp_path / "vit", "vit")
    mlp = _model_dir(tmp_path / "mlp", "mlp", in_features=10)
    pkg = "seldon_core_tpu_torch"
    graph = dict(_unit("v", vit, pkg), children=[_unit("m", mlp, pkg)])
    _jmesh, tmesh = meshes
    fused = _engine(pkg, graph, tmesh, {"seldon.io/fuse": "true"})
    hop = _engine(pkg, graph, tmesh)
    assert set(fused.executor.fusion.segments) == {"v"}
    body = {"data": {"ndarray": _inputs("vit").tolist()}}
    outs = []
    for app in (fused, hop):
        out = asyncio.run(app.predict(json.loads(json.dumps(body))))
        out.get("meta", {}).pop("puid", None)
        outs.append(json.loads(json.dumps(out)))
        asyncio.run(app.executor.close())
    assert outs[0] == outs[1]
    assert fused.executor.fusion.segments["v"].dispatches == 1


# -- the control plane ------------------------------------------------------


def test_meshed_jax_server_reconciles_available_in_both(dirs):
    """A predictor with a ``tpuMesh`` and a JAX_SERVER unit, applied to
    each package's controller over 8 devices (the port's: 8 CPU
    positions): Available in both, the member's TorchServer on a mesh of
    its placed block, answering what the JAX member answers."""
    import seldon_core_tpu.controlplane as jcp
    import seldon_core_tpu_torch.controlplane as tcp
    from seldon_core_tpu.controlplane.runtime import InProcessRuntime as JaxRuntime
    from seldon_core_tpu_torch.controlplane.runtime import InProcessRuntime

    x = _inputs("mlp")[:4].tolist()
    answers = []
    for pkg, cp, runtime, placement in (
            ("seldon_core_tpu", jcp, JaxRuntime, lambda: jcp.TpuPlacement(devices=jax.devices())),
            ("seldon_core_tpu_torch", tcp, InProcessRuntime,
             lambda: tcp.DevicePlacement(devices=[torch.device("cpu")] * 8))):
        async def go():
            store = cp.ResourceStore()
            pl = placement()
            ctl = cp.DeploymentController(store, runtime=runtime(open_ports=False),
                                          placement=pl, gateway=cp.Gateway())
            dep = cp.SeldonDeployment.from_dict({"name": "zoo", "predictors": [{
                "name": "p0", "tpuMesh": dict(SHAPE), "graph": _unit("clf", dirs["mlp"], pkg)}]})
            store.apply(dep)
            status = await ctl.reconcile(dep.clone())
            assert status.state == "Available", status.description
            assert pl.capacity()["used"] == 8
            (app,) = [h.app for h, _ in ctl.components.values() if h.spec.kind == "engine"]
            if pkg.endswith("torch"):
                server = app.executor.root.client.user_object
                assert server._mesh is app.executor._mesh
                assert server._mesh.shape == SHAPE
            out = await app.predict({"data": {"ndarray": x}})
            await ctl.delete(dep)
            assert pl.capacity()["used"] == 0
            return np.asarray(out["data"]["ndarray"])

        answers.append(asyncio.run(go()))
    assert _rel_err(answers[1], answers[0]) <= TOL
