"""The port's host-side prepackaged servers (sklearn, xgboost, mlflow,
tensorflow, Triton, SageMaker) against the JAX package's, on the CPU,
with the JAX tests' fakes: each resolves from a graph spec in the port's
engine, serves what the JAX server serves, and raises the JAX server's
clear error when its library is missing. Also ``TorchServer`` building
from a remote model URI through ``Storage``."""

import asyncio
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest

from seldon_core_tpu.graph import spec as jax_spec
from seldon_core_tpu_torch.graph import spec as port_spec

JAX, PORT = "seldon_core_tpu", "seldon_core_tpu_torch"


def _mod(pkg, name):
    return __import__(f"{pkg}.{name}", fromlist=["x"])


def _executor(pkg, graph, registry=None):
    spec = _mod(pkg, "graph.spec")
    ex = _mod(pkg, "graph.executor").GraphExecutor
    s = spec.default_predictor(spec.PredictorSpec.from_dict({"name": "p", "graph": graph}))
    spec.validate_predictor(s)
    return ex(s, registry=registry) if registry else ex(s)


def _predict(ex, rows):
    out = asyncio.run(ex.predict({"data": {"ndarray": rows}}))
    asyncio.run(ex.close())
    return out


def _block(monkeypatch, module):
    """``module`` unimportable for the test, installed or not."""
    monkeypatch.setitem(sys.modules, module, None)
    parent, _, child = module.rpartition(".")
    if parent in sys.modules and hasattr(sys.modules[parent], child):
        monkeypatch.delattr(sys.modules[parent], child)


def test_all_eight_servers_resolve():
    """The JAX package's eight implementation names, each to the class of
    the same name in the port."""
    assert sorted(port_spec.PREPACKAGED_SERVERS) == sorted(jax_spec.PREPACKAGED_SERVERS)
    assert not hasattr(port_spec, "NOT_PORTED_SERVERS")
    renamed = {"JAXServer": "TorchServer"}
    for impl, path in port_spec.PREPACKAGED_SERVERS.items():
        module, cls = path.rsplit(".", 1)
        assert module.startswith("seldon_core_tpu_torch.servers.")
        assert getattr(__import__(module, fromlist=[cls]), cls)
        jcls = jax_spec.PREPACKAGED_SERVERS[impl].rsplit(".", 1)[1]
        assert cls == renamed.get(jcls, jcls)


@pytest.fixture(scope="module")
def iris_model_dir(tmp_path_factory):
    pytest.importorskip("sklearn")
    import joblib
    from sklearn.datasets import load_iris
    from sklearn.linear_model import LogisticRegression

    d = tmp_path_factory.mktemp("iris")
    X, y = load_iris(return_X_y=True)
    joblib.dump(LogisticRegression(max_iter=200).fit(X, y), d / "model.joblib")
    return str(d)


@pytest.mark.parametrize("method", ["predict_proba", "predict", "decision_function"])
def test_sklearn_server_equals_jax(iris_model_dir, method):
    graph = {"name": "clf", "implementation": "SKLEARN_SERVER", "modelUri": iris_model_dir,
             "parameters": [{"name": "method", "value": method, "type": "STRING"}]}
    rows = [[5.1, 3.5, 1.4, 0.2], [6.7, 3.0, 5.2, 2.3]]
    jout, tout = (_predict(_executor(pkg, graph), rows) for pkg in (JAX, PORT))
    assert tout["data"] == jout["data"]
    if method == "predict_proba":
        assert tout["data"]["names"] == ["t:0", "t:1", "t:2"]
        assert int(np.argmax(tout["data"]["ndarray"][0])) == 0  # setosa


MISSING = {
    # implementation: (module blocked, exception type, message match)
    "SKLEARN_SERVER": ("joblib", ImportError, "joblib"),
    "XGBOOST_SERVER": ("xgboost", RuntimeError, "xgboost"),
    "MLFLOW_SERVER": ("mlflow", RuntimeError, "mlflow"),
    "TENSORFLOW_SERVER": ("tensorflow", RuntimeError, "tensorflow"),
    "SAGEMAKER_SERVER": ("boto3", RuntimeError, "boto3"),
}


@pytest.mark.parametrize("impl", sorted(MISSING))
def test_missing_library_error_as_jax(tmp_path, monkeypatch, impl):
    """Resolved from a graph spec by each package's engine, a server whose
    library is missing raises the JAX server's error type naming the
    library, and never "not ported"."""
    module, exc, match = MISSING[impl]
    _block(monkeypatch, module)
    graph = {"name": "m", "implementation": impl, "modelUri": str(tmp_path)}
    errors = []
    for pkg in (JAX, PORT):
        with pytest.raises(exc, match=match) as e:
            _executor(pkg, graph)
        errors.append(e.value)
    assert type(errors[1]) is type(errors[0])
    assert "not ported" not in str(errors[1])


# -- Triton proxy -------------------------------------------------------------


def _trt_transport(calls):
    def transport(url, body, timeout):
        calls.append((url, body))
        if body is None:
            return {"name": "resnet",
                    "inputs": [{"name": "input0", "datatype": "INT32", "shape": [-1, 3]}],
                    "outputs": [{"name": "prob"}]}
        req = json.loads(body)
        assert req["inputs"][0]["datatype"] == "INT32"
        rows = np.asarray(req["inputs"][0]["data"]).reshape(req["inputs"][0]["shape"])
        return {"outputs": [{"name": "prob", "datatype": "FP32", "shape": list(rows.shape),
                             "data": (rows * 0.5).ravel().tolist()}]}
    return transport


def test_trt_proxy_equals_jax():
    outs, calls = [], []
    for pkg in (JAX, PORT):
        server = _mod(pkg, "servers.trtserver").TRTServer(
            url="http://trt:8000/", model_name="resnet", model_version="2",
            transport=_trt_transport(calls))
        outs.append((server.predict(np.asarray([[1.5, 2.5, 3.5], [4, 5, 6]]), []),
                     server.class_names(), server.tags()))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert outs[1][1:] == outs[0][1:] == (["prob"], {"server": "trtserver", "model": "resnet"})
    assert calls[:2] == calls[2:]
    assert calls[0][0] == "http://trt:8000/v2/models/resnet/versions/2"
    assert calls[1][0].endswith("/v2/models/resnet/versions/2/infer")


@pytest.mark.parametrize("meta,infer,match", [
    ({"inputs": [{"name": "x", "datatype": "FP32"}]}, {"outputs": []}, "no outputs"),
    ({"inputs": []}, None, "no inputs"),
    ({"inputs": [{"name": "x", "datatype": "BYTES"}]}, None, "BYTES"),
    ({"inputs": [{"name": "x", "datatype": "FP32"}]},
     {"outputs": [{"name": "y", "datatype": "BF16", "data": [1.0]}]}, "unsupported"),
])
def test_trt_proxy_errors_as_jax(meta, infer, match):
    for pkg in (JAX, PORT):
        server = _mod(pkg, "servers.trtserver").TRTServer(
            model_name="m", transport=lambda url, body, timeout: meta if body is None else infer)
        with pytest.raises(RuntimeError, match=match):
            server.predict(np.zeros((1, 2)), [])


def test_triton_server_through_the_engine():
    """TRITON_SERVER as a registered unit of both engines, against the
    stub transport: the same response."""
    def transport(url, body, timeout):
        if body is None:
            return {"inputs": [{"name": "x", "datatype": "FP64", "shape": [-1, 2]}]}
        req = json.loads(body)
        rows = np.asarray(req["inputs"][0]["data"]).reshape(req["inputs"][0]["shape"])
        return {"outputs": [{"name": "y", "datatype": "FP64", "shape": list(rows.shape),
                             "data": (rows * 3).ravel().tolist()}]}

    outs = []
    for pkg in (JAX, PORT):
        server = _mod(pkg, "servers.trtserver").TRTServer(transport=transport)
        ex = _executor(pkg, {"name": "m", "type": "MODEL"}, registry={"m": server})
        outs.append(_predict(ex, [[1.0, 2.0]])["data"])
    assert outs[1] == outs[0] and outs[1]["ndarray"] == [[3.0, 6.0]]


# -- SageMaker proxy ------------------------------------------------------------


class FakeSMClient:
    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def invoke_endpoint(self, EndpointName, ContentType, Accept, Body):
        self.calls.append((EndpointName, ContentType, Accept, Body))
        return {"Body": io.BytesIO(self.fn(Body, ContentType))}


def _sm_json(body, ctype):
    arr = np.asarray(json.loads(body)["instances"])
    return json.dumps({"predictions": (arr * 2).tolist()}).encode()


def _sm_csv(body, ctype):
    arr = np.loadtxt(io.StringIO(body.decode()), delimiter=",", ndmin=2)
    out = io.StringIO()
    np.savetxt(out, arr + 1, delimiter=",", fmt="%g")
    return out.getvalue().encode()


@pytest.mark.parametrize("ctype,fn", [("application/json", _sm_json), ("text/csv", _sm_csv)])
def test_sagemaker_proxy_equals_jax(ctype, fn):
    outs, calls = [], []
    for pkg in (JAX, PORT):
        client = FakeSMClient(fn)
        server = _mod(pkg, "servers.sagemakerserver").SageMakerServer(
            model_uri="s3://bkt/endpoints/ep1", content_type=ctype,
            client_factory=lambda c=client: c)
        outs.append(server.predict(np.asarray([[1.0, 2.0], [3.0, 4.0]]), []))
        calls.append(client.calls)
        assert server.tags() == {"server": "sagemaker", "endpoint": "ep1"}
    np.testing.assert_array_equal(outs[1], outs[0])
    assert calls[1] == calls[0]


def test_sagemaker_errors_as_jax():
    for pkg in (JAX, PORT):
        cls = _mod(pkg, "servers.sagemakerserver").SageMakerServer
        with pytest.raises(ValueError, match="endpoint_name"):
            cls()
        server = cls(endpoint_name="ep", client_factory=lambda: FakeSMClient(
            lambda b, c: json.dumps({"scores": [1]}).encode()))
        with pytest.raises(RuntimeError, match="predictions"):
            server.predict(np.ones((1, 1)), [])


# -- TFServer through its injectable loader -------------------------------------


def test_tfserver_loader_equals_jax(tmp_path):
    model_dir = tmp_path / "saved"
    model_dir.mkdir()
    (model_dir / "saved_model.pb").write_bytes(b"\x00")
    outs, seen = [], []

    def loader(path, signature):
        seen.append((os.path.exists(os.path.join(path, "saved_model.pb")), signature))
        return lambda arr: arr * 10

    for pkg in (JAX, PORT):
        server = _mod(pkg, "servers.tfserver").TFServer(
            model_uri=f"file://{model_dir}", signature="sig", loader=loader)
        outs.append(server.predict(np.asarray([[1.0, 2.0]]), []))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert seen == [(True, "sig"), (True, "sig")]


# -- TorchServer from a remote model URI ----------------------------------------


def test_torchserver_builds_from_a_remote_uri(tmp_path):
    """A gs:// model URI, served by a fake GCS client over a local model
    directory, gives the same forward as the local path."""
    import jax
    import torch

    from seldon_core_tpu import models as jax_models
    from seldon_core_tpu_torch.convert import save_npz
    from seldon_core_tpu_torch.servers.torchserver import TorchServer
    from seldon_core_tpu_torch.storage import Storage

    cfg = {"in_features": 4, "hidden": [8], "num_classes": 3, "dtype": "float32"}
    local = tmp_path / "mlp"
    local.mkdir()
    save_npz(jax.tree.map(np.asarray, jax_models.build("mlp", **cfg).init_params(0)),
             str(local / "params.npz"))
    (local / "jax_config.json").write_text(json.dumps(
        {"family": "mlp", "config": cfg, "checkpoint": "params.npz"}))

    class Blob:
        def __init__(self, name):
            self.name = name

        def download_to_filename(self, dst):
            shutil.copy(local / os.path.basename(self.name), dst)

    class Client:
        def bucket(self, name):
            assert name == "models"

            class Bucket:
                def list_blobs(self, prefix=""):
                    return [Blob(f"zoo/mlp/{f}") for f in sorted(os.listdir(local))
                            if f"zoo/mlp/{f}".startswith(prefix)]
            return Bucket()

    Storage.set_client_factory("gcs", Client)
    try:
        remote = TorchServer("gs://models/zoo/mlp", device="cpu")
        remote.load()
    finally:
        Storage.set_client_factory("gcs", None)
    near = TorchServer(str(local), device="cpu")
    near.load()
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    got, want = (np.asarray(s.predict(x, [])) for s in (remote, near))
    np.testing.assert_array_equal(got, want)
    assert torch.allclose(torch.from_numpy(got).sum(-1), torch.ones(3))
