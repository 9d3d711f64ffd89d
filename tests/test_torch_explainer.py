"""The port's explainer (seldon_core_tpu_torch.components.explainer)
against the JAX package's, on the CPU.

White-box: the same model directory (the JAX package's seed-0 params
written as ``params.npz`` beside its ``jax_config.json``) explained by
both packages on the same numpy-seeded inputs. At float32 the targets
are equal and the attributions agree within ``F32_TOL`` of the largest
|attribution| (1e-5: float32 gradients in another summation order; the
port measures ~1e-7 on the MLP and ~2e-6 on ResNet-50). At bfloat16
(ResNet-50, the serving dtype) the gradients round at other points over
50 layers and a max-pool tie may route elsewhere: the targets are equal
and the attributions' cosine similarity is at least ``BF16_COSINE``
(0.95; the port measures 0.98-0.998). The completeness axiom holds for
the port: the attributions sum to f(x) - f(baseline).

Black-box: ablation and the anchors behind a fake predictor (no
network): the port's response equals the JAX package's.
"""

import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu import models as jax_models
from seldon_core_tpu.components.explainer import Explainer as JaxExplainer
from seldon_core_tpu_torch.components.explainer import Explainer
from seldon_core_tpu_torch.convert import save_npz

torch.set_num_threads(2)

F32_TOL = 1e-5
BF16_COSINE = 0.95
MLP = {"in_features": 4, "hidden": [8], "num_classes": 3, "seed": 0, "dtype": "float32"}
RESNET = {"image_size": 32, "num_classes": 10, "seed": 0}


def _model_dir(path, family, config):
    path.mkdir(parents=True, exist_ok=True)
    params = jax_models.build(family, **config).init_params(config.get("seed", 0))
    save_npz(jax.tree.map(np.asarray, params), str(path / "params.npz"))
    (path / "jax_config.json").write_text(json.dumps(
        {"family": family, "config": config, "checkpoint": "params.npz"}))
    return str(path)


@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    return _model_dir(tmp_path_factory.mktemp("mlp"), "mlp", MLP)


@pytest.fixture(scope="module")
def resnet_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("resnet")
    return {dt: _model_dir(root / dt, "resnet50", dict(RESNET, dtype=dt))
            for dt in ("float32", "bfloat16")}


def _images(n=2, seed=0):
    return np.random.RandomState(seed).uniform(0, 255, (n, 32, 32, 3)).astype(np.float32)


def _pair(kind, model_dir, **kw):
    je = JaxExplainer(explainer_type=kind, model_uri=model_dir, **kw)
    te = Explainer(explainer_type=kind, model_uri=model_dir, device="cpu", **kw)
    je.load()
    te.load()
    return je, te


def _score(explainer, x, target):
    """f(x)[target] through the port's loaded forward, float32."""
    with torch.no_grad():
        logits = explainer._apply(explainer._params, torch.from_numpy(x)).float().numpy()
    return logits[np.arange(len(target)), target]


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- white-box --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["integrated_gradients", "saliency"])
@pytest.mark.parametrize("baseline", [None, 0.3])
def test_mlp_attributions_equal_jax(mlp_dir, kind, baseline):
    je, te = _pair(kind, mlp_dir, n_steps=32)
    x = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    meta = None if baseline is None else {"tags": {"baseline": baseline}}
    jo, to = je.explain(x, ["a", "b", "c", "d"], meta), te.explain(x, ["a", "b", "c", "d"], meta)
    assert to.keys() == jo.keys()
    assert to["explainer"] == kind and to["names"] == ["a", "b", "c", "d"]
    assert to["target"] == jo["target"]
    assert _rel_err(np.asarray(to["attributions"]), np.asarray(jo["attributions"])) <= F32_TOL
    assert _rel_err(np.asarray(to["prediction"]), np.asarray(jo["prediction"])) <= F32_TOL


def test_mlp_integrated_gradients_completeness(mlp_dir):
    """The JAX test's axiom on the port: attributions sum to f(x) -
    f(baseline) for the target score (midpoint rule, 128 steps)."""
    te = Explainer(explainer_type="integrated_gradients", model_uri=mlp_dir,
                   n_steps=128, device="cpu")
    te.load()
    x = np.array([[0.7, -1.2, 0.4, 2.0]], np.float32)
    out = te.explain(x, [])
    target = np.asarray(out["target"])
    gap = _score(te, x, target) - _score(te, np.zeros_like(x), target)
    assert abs(np.asarray(out["attributions"]).sum() - gap[0]) < 5e-3


@pytest.mark.parametrize("kind", ["integrated_gradients", "saliency"])
@pytest.mark.parametrize("baseline", [None, 64.0])
def test_resnet_f32_attributions_equal_jax(resnet_dirs, kind, baseline):
    """ResNet-50 at 32x32, 10 classes, 4 steps, float32: the target and the
    attributions of the JAX package; completeness for the port: with the
    zero baseline the random-weight network (zero biases, identity batch
    norms) is positively homogeneous, so the sum is f(x) to float32
    rounding; with a gray baseline the 4-step midpoint rule is held to
    the JAX package's own gap."""
    je, te = _pair(kind, resnet_dirs["float32"], n_steps=4)
    x = _images()
    meta = None if baseline is None else {"tags": {"baseline": baseline}}
    jo, to = je.explain(x, [], meta), te.explain(x, [], meta)
    assert to["target"] == jo["target"]
    ja, ta = np.asarray(jo["attributions"]), np.asarray(to["attributions"])
    assert ta.shape == x.shape
    assert _rel_err(ta, ja) <= F32_TOL
    target = np.asarray(to["target"])
    fx = _score(te, x, target)
    sums = ta.reshape(len(x), -1).sum(axis=1)
    if baseline is None:
        np.testing.assert_allclose(sums, fx, rtol=1e-4)
    elif kind == "integrated_gradients":
        gap = fx - _score(te, np.full_like(x, baseline), target)
        jsums = ja.reshape(len(x), -1).sum(axis=1)
        np.testing.assert_allclose(sums - gap, jsums - gap, rtol=0, atol=1e-4 * np.abs(gap).max())


@pytest.mark.parametrize("kind", ["integrated_gradients", "saliency"])
def test_resnet_bf16_same_target_and_direction(resnet_dirs, kind):
    je, te = _pair(kind, resnet_dirs["bfloat16"], n_steps=4)
    x = _images(seed=2)
    jo, to = je.explain(x, []), te.explain(x, [])
    assert to["target"] == jo["target"]
    ja, ta = np.asarray(jo["attributions"]), np.asarray(to["attributions"])
    assert np.isfinite(ta).all()
    cos = float((ja * ta).sum() / np.linalg.norm(ja) / np.linalg.norm(ta))
    assert cos >= BF16_COSINE


@pytest.mark.parametrize("kind", ["integrated_gradients", "saliency"])
def test_resnet_float64_config(resnet_dirs, tmp_path, kind):
    """A ``jax_config.json`` asking for float64 builds a ResNet-50 that
    computes its convolutions and batch norms in float64 (the reference
    the card's float32 attributions are measured against): the same
    target as the JAX package at float32 and attributions within
    ``F32_TOL`` of the largest (float32's own rounding)."""
    import shutil

    d = tmp_path / "f64"
    d.mkdir()
    shutil.copy(f"{resnet_dirs['float32']}/params.npz", d / "params.npz")
    (d / "jax_config.json").write_text(json.dumps(
        {"family": "resnet50", "config": dict(RESNET, dtype="float64"),
         "checkpoint": "params.npz"}))
    te = Explainer(explainer_type=kind, model_uri=str(d), n_steps=4, device="cpu")
    te.load()
    assert te._apply.__self__.dtype is torch.float64
    je = JaxExplainer(explainer_type=kind, model_uri=resnet_dirs["float32"], n_steps=4)
    je.load()
    x = _images(seed=6)
    jo, to = je.explain(x, []), te.explain(x, [])
    assert to["target"] == jo["target"]
    assert _rel_err(np.asarray(to["attributions"]), np.asarray(jo["attributions"])) <= F32_TOL


def test_alpha_chunks_do_not_change_the_result(resnet_dirs, monkeypatch):
    """The alphas folded into the batch (MAX_ROWS 32: all 4 steps of 2
    images in one pass) against one step per pass (MAX_ROWS 1)."""
    from seldon_core_tpu_torch.components import explainer

    d = resnet_dirs["float32"]
    outs = []
    for rows in (1, 3, 32):
        monkeypatch.setattr(explainer, "MAX_ROWS", rows)
        te = Explainer(explainer_type="integrated_gradients", model_uri=d, n_steps=4,
                       device="cpu")
        outs.append(np.asarray(te.explain(_images(), [])["attributions"]))
    for o in outs[1:]:
        assert _rel_err(o, outs[0]) <= 1e-6


def test_grad_needs_no_param_gradients(mlp_dir):
    te = Explainer(explainer_type="saliency", model_uri=mlp_dir, device="cpu")
    te.load()
    te.explain(np.ones((1, 4), np.float32), [])
    leaves = [t for layer in te._params for t in layer.values()]
    assert all(not t.requires_grad and t.grad is None for t in leaves)


def test_explain_under_inference_mode(resnet_dirs):
    """A caller inside ``torch.inference_mode`` (the generate path's
    mode), loading and explaining there, still gets gradients: the
    parameters, ResNet-50's derived weights and the input are made
    outside it."""
    d = resnet_dirs["float32"]
    x = _images(n=1, seed=5)
    want = Explainer(explainer_type="saliency", model_uri=d, device="cpu").explain(x, [])
    with torch.inference_mode():
        got = Explainer(explainer_type="saliency", model_uri=d, device="cpu").explain(x, [])
    assert got == want


def test_white_box_needs_model_uri_cuda_and_no_mesh(mlp_dir):
    """A white-box explainer needs a model_uri and CUDA by default. A
    mesh, once refused (sharded explanation was not ported), now loads
    the model split over it and explains as the unmeshed explainer does,
    bit for bit."""
    from seldon_core_tpu_torch.parallel.mesh import make_serving_mesh

    with pytest.raises(ValueError, match="model_uri"):
        Explainer(explainer_type="integrated_gradients", device="cpu").load()
    mesh = make_serving_mesh({"data": 2, "model": 4}, device="cpu")
    meshed = Explainer(explainer_type="integrated_gradients", model_uri=mlp_dir,
                       device="cpu", mesh=mesh)
    plain = Explainer(explainer_type="integrated_gradients", model_uri=mlp_dir, device="cpu")
    x = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    assert meshed.explain(x, []) == plain.explain(x, [])
    assert meshed.device == mesh.device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Explainer(explainer_type="integrated_gradients", model_uri=mlp_dir)


@pytest.mark.parametrize("cls", [JaxExplainer, Explainer], ids=["jax", "port"])
def test_type_names_as_jax(cls):
    with pytest.raises(ValueError, match="unknown explainer type"):
        cls(explainer_type="nope")
    assert cls(explainer_type="anchor_images", predictor_endpoint="x:1").explainer_type == "ablation"
    with pytest.raises(ValueError, match="train_data_uri"):
        cls(explainer_type="anchor_tabular", predictor_endpoint="x:1")


# -- black-box --------------------------------------------------------------


def _both(kind, monkeypatch, fake, **kw):
    out = []
    for cls in (JaxExplainer, Explainer):
        e = cls(explainer_type=kind, predictor_endpoint="fake:1", **kw)
        monkeypatch.setattr(e, "_query_predictor", fake)
        out.append(e)
    return out


def test_ablation_equals_jax_on_a_linear_model(monkeypatch):
    W = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    calls = []

    def fake(batch):
        calls.append(batch.shape)
        return batch @ W

    je, te = _both("ablation", monkeypatch, fake)
    x = np.array([[1.0, -2.0, 0.5, 3.0], [0.2, 0.1, -1.0, 0.4]], np.float32)
    jo, to = je.explain(x, []), te.explain(x, [])
    assert to == jo
    target = np.argmax(x @ W, axis=-1)
    np.testing.assert_allclose(to["attributions"], W[:, target].T * x, atol=1e-5)
    assert calls == [(10, 4), (10, 4)]  # B*(F+1) rows in ONE call, per package


def test_anchor_images_alias_flattens_like_jax(monkeypatch):
    je, te = _both("anchor_images", monkeypatch, lambda b: b.sum(axis=1, keepdims=True))
    x = np.random.RandomState(0).rand(2, 4, 4, 1).astype(np.float32)
    meta = {"tags": {"baseline": 0.5}}
    jo, to = je.explain(x, [], meta), te.explain(x, [], meta)
    assert to == jo and to["requested_type"] == "anchor_images"
    assert np.asarray(to["attributions"]).shape == (2, 4, 4, 1)


def test_anchor_tabular_equals_jax(monkeypatch, tmp_path):
    """The background data through each package's Storage (file://), the
    same seed and fake predictor: identical anchors."""
    rs = np.random.RandomState(0)
    train = rs.uniform(-1, 1, size=(400, 3))
    np.save(tmp_path / "train.npy", train)

    def fake(z):
        z = np.asarray(z)
        return np.stack([(z[:, 0] > 0), (z[:, 0] <= 0)], axis=1).astype(np.float32)

    je, te = _both("anchor_tabular", monkeypatch, fake,
                   train_data_uri=f"file://{tmp_path}/train.npy", anchor_seed=3)
    x = np.array([[0.9, 0.1, -0.5], [-0.6, 0.7, 0.2]])
    jo, to = je.explain(x, ["a", "b", "c"]), te.explain(x, ["a", "b", "c"])
    assert to == jo
    assert to["anchors"][0]["anchor_features"] == ["a"] and to["precision"] >= 0.95


def test_anchor_text_equals_jax(monkeypatch):
    """anchor_text posts strData batches to the predictor: a fake urlopen
    answers for both packages."""
    import io
    import urllib.request

    posted = []

    def fake_urlopen(req, timeout=None):
        texts = json.loads(req.data)["data"]["ndarray"]
        posted.append((req.full_url, len(texts)))
        labels = [[1.0 if "good" in t.split() else 0.0] for t in texts]
        return io.BytesIO(json.dumps({"data": {"ndarray": labels}}).encode())

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    outs = [cls(explainer_type="anchor_text", predictor_endpoint="fake:1",
                anchor_seed=3).explain("this movie is good fun", [])
            for cls in (JaxExplainer, Explainer)]
    assert outs[1] == outs[0] and outs[1]["anchor"] == ["good"]
    half = len(posted) // 2
    assert posted[:half] == posted[half:]
    assert posted[0][0] == "http://fake:1/api/v0.1/predictions"


def test_ablation_needs_an_endpoint():
    with pytest.raises(ValueError, match="predictor_endpoint"):
        Explainer(explainer_type="ablation").explain(np.ones((1, 2), np.float32), [])


# -- the microservice's /explain --------------------------------------------


def _rest(pkg, user, path, body):
    wrapper = __import__(f"{pkg}.wrapper", fromlist=["w"])
    Request = __import__(f"{pkg}.http_server", fromlist=["Request"]).Request
    app = wrapper.get_rest_microservice(user)
    resp = asyncio.run(app._dispatch(Request(
        "POST", path, "", {"content-type": "application/json"}, json.dumps(body).encode())))
    return resp.status, json.loads(resp.body)


def test_explain_route_equals_jax(mlp_dir):
    """The white-box explainer built by the port's microservice from typed
    parameters, answering /explain as the JAX microservice does."""
    from seldon_core_tpu_torch import microservice

    user = microservice.build_user_object(
        "seldon_core_tpu_torch.components.explainer.Explainer", json.dumps([
            {"name": "explainer_type", "value": "integrated_gradients", "type": "STRING"},
            {"name": "model_uri", "value": mlp_dir, "type": "STRING"},
            {"name": "n_steps", "value": "16", "type": "INT"},
            {"name": "device", "value": "cpu", "type": "STRING"}]))
    user.load()
    jax_user = JaxExplainer(explainer_type="integrated_gradients", model_uri=mlp_dir, n_steps=16)
    body = {"data": {"names": ["a", "b", "c", "d"], "ndarray": [[0.1, 0.2, 0.3, 0.4]]}}
    (js, jout), (ts, tout) = (_rest("seldon_core_tpu", jax_user, "/explain", body),
                              _rest("seldon_core_tpu_torch", user, "/api/v1.0/explain", body))
    assert js == ts == 200
    assert tout["meta"]["tags"] == jout["meta"]["tags"] == {"explainer": "integrated_gradients"}
    j, t = jout["jsonData"], tout["jsonData"]
    assert t["target"] == j["target"] and t["names"] == j["names"]
    assert _rel_err(np.asarray(t["attributions"]), np.asarray(j["attributions"])) <= F32_TOL
