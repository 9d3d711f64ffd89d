"""The predict path's model zoo of seldon_core_tpu_torch (MLP, ResNet-50,
BERT, ViT) against the JAX package on the CPU.

Each family is built in both packages at a small size (ResNet-50 at full
depth on 32x32 images with 10 classes; BERT and ViT at 2 layers and
narrow widths; the iris MLP), the JAX package's ``init_params(0)`` is
handed over through ``convert.params_from_numpy``, and the same
numpy-seeded inputs go through both forwards.

Tolerances, relative to the largest |output| of the JAX forward:
  * float32: 1e-5 (summation order only; ResNet-50's random identity-BN
    logits reach ~1e4, so the bound is relative), and equal argmax;
  * bfloat16: 3e-2 (both round every activation to bf16, in different
    places: XLA fuses a matmul and its bias add, PyTorch rounds twice).
"""

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu import models as jax_models
from seldon_core_tpu_torch import models as torch_models
from seldon_core_tpu_torch.convert import list_paths, load_npz, params_from_numpy, save_npz
from seldon_core_tpu_torch.models import resnet as torch_resnet

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 3e-2}

FAMILIES = {
    "mlp": {},
    "resnet50": {"image_size": 32, "num_classes": 10},
    "bert": dict(vocab_size=100, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                 max_seq=32, num_classes=3),
    "vit": dict(image_size=32, patch_size=8, d_model=32, n_layers=2, n_heads=4,
                d_ff=64, num_classes=10),
}


def _photo(n, size, seed=0):
    """Non-constant, asymmetric uint8 images: low-frequency sines plus
    noise (the smoke run's synthetic photos, small)."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:size, 0:size]
    imgs = []
    for _ in range(n):
        chans = []
        for _c in range(3):
            fx, fy = rs.uniform(0.5, 3.0, 2)
            ph = rs.uniform(0, 2 * np.pi)
            chans.append(127 + 100 * np.sin(2 * np.pi * fx * x / size + ph)
                         * np.cos(2 * np.pi * fy * y / size))
        imgs.append(np.stack(chans, -1) + rs.normal(0, 6.0, (size, size, 3)))
    return np.clip(np.asarray(imgs), 0, 255).astype(np.uint8)


def _inputs(family):
    rs = np.random.RandomState(1)
    if family == "mlp":
        return rs.randn(5, 4).astype(np.float32)
    if family == "bert":
        toks = rs.randint(1, 100, (3, 16)).astype(np.int32)
        toks[1, 9:] = 0  # a padded tail
        return toks
    return _photo(2, 32)


def _pair(family, dtype):
    cfg = dict(FAMILIES[family], dtype=dtype)
    jm, tm = jax_models.build(family, **cfg), torch_models.build(family, **cfg)
    jp = jm.init_params(0)
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _jax_forward(jm, jp, x):
    return np.asarray(jax.jit(jm.apply)(jp, x)).astype(np.float32)


def _torch_forward(tm, tp, x):
    with torch.no_grad():
        return tm.apply(tp, torch.from_numpy(x)).float().numpy()


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_equals_jax(family, dtype):
    jm, jp, tm, tp = _pair(family, dtype)
    x = _inputs(family)
    want, got = _jax_forward(jm, jp, x), _torch_forward(tm, tp, x)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _rel_err(got, want) <= TOL[dtype], _rel_err(got, want)
    if dtype == "float32":
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_mlp_rows_sum_to_one():
    _jm, _jp, tm, tp = _pair("mlp", "float32")
    out = _torch_forward(tm, tp, _inputs("mlp"))
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-6)


def test_resnet_same_padding_is_asymmetric(monkeypatch):
    """A stride-2 window on an even input (the 7x7/2 stem on 32: 2 above,
    3 below; the max pool and each stage's first 3x3: 0 and 1) pads more
    after than before, as XLA's SAME does. PyTorch's symmetric
    ``padding=k // 2`` gives the same shapes with every window shifted by
    one, and on a non-constant image a different answer."""
    assert torch_resnet.same_pads(224, 7, 2) == (2, 3)
    assert torch_resnet.same_pads(112, 3, 2) == (0, 1)
    assert torch_resnet.same_pads(56, 3, 2) == (0, 1)
    assert torch_resnet.same_pads(33, 7, 2) == (3, 3)
    assert torch_resnet.same_pads(56, 1, 2) == (0, 0)
    jm, jp, tm, tp = _pair("resnet50", "float32")
    x = _photo(2, 32, seed=3)
    want = _jax_forward(jm, jp, x)
    assert _rel_err(_torch_forward(tm, tp, x), want) <= TOL["float32"]
    monkeypatch.setattr(torch_resnet, "same_pads", lambda n, k, s: (k // 2, k // 2))
    tm._prepared_for = None
    assert _rel_err(_torch_forward(tm, tp, x), want) > 100 * TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bert_fully_padded_row_is_finite(dtype):
    """A row of token 0 (what the micro-batcher pads with) masks every key:
    the f32 -1e30 bias keeps its softmax uniform and its logits finite at
    bf16 too, and the real rows still equal the JAX package's."""
    jm, jp, tm, tp = _pair("bert", dtype)
    toks = _inputs("bert")
    toks[2] = 0
    want, got = _jax_forward(jm, jp, toks), _torch_forward(tm, tp, toks)
    assert np.isfinite(got).all()
    assert _rel_err(got[:2], want[:2]) <= TOL[dtype]


def test_flops_per_row_equal_jax():
    for family in ("resnet50", "bert", "vit"):
        cfg = FAMILIES[family]
        assert torch_models.build(family, **cfg).flops_per_row() == \
            jax_models.build(family, **cfg).flops_per_row()
    full = torch_models.build("resnet50")
    assert full.flops_per_row() == jax_models.build("resnet50").flops_per_row()
    assert 8.0e9 < full.flops_per_row() < 8.4e9


def test_port_init_params_match_jax_shapes():
    for family in sorted(FAMILIES):
        jm, jp, tm, _tp = _pair(family, "float32")
        mine = tm.init_params(0, device="cpu")
        got = jax.tree.map(lambda t: tuple(t.shape), mine)
        want = jax.tree.map(lambda a: tuple(np.shape(a)), jp)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert jax.tree.leaves(got) == jax.tree.leaves(want)


def test_registry():
    for family in FAMILIES:
        torch_models.build(family, **FAMILIES[family])
    # the retrieval families build too, and refuse what the JAX ones do
    assert type(torch_models.build("retrieval")).__name__ == "RetrievalIndex"
    assert type(torch_models.build("reranker")).__name__ == "Reranker"
    for family in ("retrieval", "reranker"):
        with pytest.raises(ValueError, match="corpus_size"):
            torch_models.build(family, corpus_size=512)
    with pytest.raises(ValueError, match="unknown model family"):
        torch_models.build("nope")


def test_list_trees_roundtrip_npz(tmp_path):
    """ResNet-50's stages (a list of lists of dicts) and the MLP's layers
    (a root list) go through ``.npz`` and come back as lists, an index a
    path segment."""
    for family in ("resnet50", "mlp"):
        _jm, jp, _tm, tp = _pair(family, "float32")
        path = str(tmp_path / f"{family}.npz")
        save_npz(jax.tree.map(np.asarray, jp), path)
        back = load_npz(path, device="cpu")
        assert jax.tree.structure(jax.tree.map(np.asarray, back)) == \
            jax.tree.structure(jax.tree.map(np.asarray, jp))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tp)):
            assert torch.equal(a, b)
    keys = np.load(str(tmp_path / "resnet50.npz")).files
    assert "stages/2/0/conv1" in keys and "@lists" in keys


def test_dict_tree_keys_unchanged(tmp_path):
    """An llm-1.26b-shaped dict tree (tiny leaves) keeps its keys byte for
    byte and writes no list record."""
    tree = {"embed": np.ones((4, 2), np.float32),
            "blocks": {k: np.full((2, 3), i, np.float32) for i, k in
                       enumerate(("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w3", "w2"))},
            "ln_f": np.ones(2, np.float32), "unembed": np.ones((2, 4), np.float32)}
    assert list_paths(tree) == []
    path = str(tmp_path / "llm.npz")
    save_npz(tree, path)
    assert sorted(np.load(path).files) == sorted(
        ["embed", "ln_f", "unembed"] + [f"blocks/{k}" for k in tree["blocks"]])
    back = load_npz(path, device="cpu")
    assert back.keys() == tree.keys() and back["blocks"].keys() == tree["blocks"].keys()


# -- the slice as a whole: TorchServer behind the REST microservice -------


def _model_dir(tmp_path, family, dtype="float32", **extra):
    cfg = dict(FAMILIES[family], dtype=dtype, **extra)
    jp = jax_models.build(family, **cfg).init_params(0)
    save_npz(jax.tree.map(np.asarray, jp), str(tmp_path / "params.npz"))
    (tmp_path / "jax_config.json").write_text(json.dumps(
        {"family": family, "config": cfg, "checkpoint": "params.npz"}))
    return str(tmp_path)


def _rest(pkg, user, body):
    wrapper = __import__(f"{pkg}.wrapper", fromlist=["w"])
    Request = __import__(f"{pkg}.http_server", fromlist=["Request"]).Request
    app = wrapper.get_rest_microservice(user)
    resp = asyncio.run(app._dispatch(Request(
        "POST", "/predict", "", {"content-type": "application/json"},
        json.dumps(body).encode())))
    return resp.status, json.loads(resp.body)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torchserver_rest_equals_jaxserver(tmp_path, family):
    """The same model directory served by both packages' REST
    microservices: the JAX server initialises seed 0, the port loads the
    same weights from the npz checkpoint; the responses agree at f32."""
    from seldon_core_tpu.servers.jaxserver import JAXServer
    from seldon_core_tpu_torch import microservice

    model_dir = _model_dir(tmp_path, family)
    x = _inputs(family)
    body = {"data": {"ndarray": x.tolist()}}
    jax_user = JAXServer(model_uri=model_dir)
    jax_user.load()
    user = microservice.build_user_object(
        "seldon_core_tpu_torch.servers.torchserver.TorchServer", json.dumps([
            {"name": "model_uri", "value": model_dir, "type": "STRING"},
            {"name": "device", "value": "cpu", "type": "STRING"},
            {"name": "batch_size_hint", "value": "16", "type": "INT"}]))
    assert user.batch_size_hint == 16
    user.load()
    (js, jout), (ts, tout) = _rest("seldon_core_tpu", jax_user, body), _rest(
        "seldon_core_tpu_torch", user, body)
    assert js == ts == 200
    want = np.asarray(jout["data"]["ndarray"], np.float32)
    got = np.asarray(tout["data"]["ndarray"], np.float32)
    # the JAX component casts float requests to bf16 on the way in, and
    # so does the port: both forwards see the same inputs
    assert _rel_err(got, want) <= TOL["float32"]
    assert tout["meta"]["tags"] == {"family": family, "server": "torchserver"}
    if family == "mlp":
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_torchserver_refuses_a_mesh(tmp_path):
    """Once a refusal (sharded predict was not ported), now the mesh
    serves: a TorchServer over a data=2, model=4 mesh of CPU positions
    answers what the unmeshed server answers, bit for bit, and refuses
    a batch that does not tile ``data`` with a ValueError, as the JAX
    server's device put does."""
    from seldon_core_tpu_torch.parallel.mesh import make_serving_mesh
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    d = _model_dir(tmp_path, "mlp")
    mesh = make_serving_mesh({"data": 2, "model": 4}, device="cpu")
    plain = TorchServer(model_uri=d, device="cpu")
    meshed = TorchServer(model_uri=d, device="cpu", mesh=mesh)
    plain.load()
    meshed.load()
    x = np.random.RandomState(3).randn(6, 4).astype(np.float32)
    torch.testing.assert_close(meshed.predict(x, []), plain.predict(x, []), rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not divide"):
        meshed.predict(x[:5], [])


def test_device_key_is_interior_only(tmp_path):
    """``__torch__`` carries a tensor in-process (answered raw); a wire
    client that smuggles the key gets a 400."""
    from seldon_core_tpu_torch import payload, seldon_methods
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    user = TorchServer(model_uri=_model_dir(tmp_path, "mlp"), device="cpu")
    user.load()
    status, out = _rest("seldon_core_tpu_torch", user, {"data": {"__torch__": [[1, 2, 3, 4]]}})
    assert status == 400 and "interior-only" in out["status"]["info"]
    x = torch.from_numpy(_inputs("mlp")).to(torch.bfloat16)
    out = seldon_methods.predict(user, {"data": {"__torch__": x, "names": []}})
    assert "raw" in out["data"]
    rows = payload.json_data_to_array(out["data"])
    np.testing.assert_allclose(rows, user.predict(x, []).numpy())


def test_transform_component_runs_the_forward_in_a_graph(tmp_path):
    """A TorchTransformComponent on a TRANSFORMER node computes its
    forward on the input transform; a bare TorchComponent degrades to the
    identity there, as in the JAX package."""
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
    from seldon_core_tpu_torch.graph.service import EngineApp
    from seldon_core_tpu_torch.graph.spec import PredictorSpec, default_predictor
    from seldon_core_tpu_torch.servers.torchserver import TorchServer
    from seldon_core_tpu_torch.user_model import TorchTransformComponent

    class MLPTransformer(TorchTransformComponent, TorchServer):
        pass

    model_dir = _model_dir(tmp_path, "mlp")
    graph = {"name": "t", "type": "TRANSFORMER",
             "children": [{"name": "m", "implementation": "SIMPLE_MODEL"}]}
    spec = default_predictor(PredictorSpec.from_dict({"name": "p", "graph": graph}))
    x = _inputs("mlp")
    outs = []
    for cls in (MLPTransformer, TorchServer):
        unit = cls(model_uri=model_dir, device="cpu")
        unit.load()
        app = EngineApp(spec, registry={"t": unit}, metrics=MetricsRegistry())
        captured = {}
        model = app.executor.root.children[0].client.user_object
        orig = model.predict

        def spy(X, names, meta=None, _orig=orig):
            captured["x"] = np.asarray(X, np.float32)
            return _orig(X, names, meta)

        model.predict = spy
        asyncio.run(app.predict({"data": {"ndarray": x.tolist()}}))
        outs.append(captured["x"])
    expected = unit.predict(x, []).float().numpy()
    np.testing.assert_allclose(outs[0], expected, rtol=1e-6)
    np.testing.assert_allclose(outs[1], x, rtol=1e-6)
