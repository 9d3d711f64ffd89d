"""The port's Storage (seldon_core_tpu_torch.storage) against the JAX
package's, with the JAX tests' fake cloud clients (no network): every
scheme gives the same files under both packages, the prefix-escape
guard holds, and a missing SDK raises a clear error naming it."""

import os

import numpy as np
import pytest

from seldon_core_tpu.storage import Storage as JaxStorage
from seldon_core_tpu_torch.storage import Storage


@pytest.fixture(autouse=True)
def reset_factories():
    yield
    for cls in (JaxStorage, Storage):
        for kind in ("gcs", "s3", "azure"):
            cls.set_client_factory(kind, None)


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path) as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


class FakeBlob:
    def __init__(self, name, content):
        self.name = name
        self._content = content

    def download_to_filename(self, dst):
        with open(dst, "w") as f:
            f.write(self._content)


class FakeGcsClient:
    def __init__(self, blobs):
        self._blobs = blobs

    def bucket(self, name):
        assert name == "mybucket"
        client = self

        class Bucket:
            def list_blobs(self, prefix=""):
                return [b for b in client._blobs if b.name.startswith(prefix)]

        return Bucket()


class FakeS3Client:
    def __init__(self, objects):
        self.objects = objects  # key -> content

    def get_paginator(self, op):
        assert op == "list_objects_v2"
        client = self

        class P:
            def paginate(self, Bucket, Prefix):
                assert Bucket == "bkt"
                keys = [k for k in client.objects if k.startswith(Prefix)]
                yield {"Contents": [{"Key": k} for k in keys]} if keys else {}

        return P()

    def download_file(self, bucket, key, dst):
        with open(dst, "w") as f:
            f.write(self.objects[key])


class FakeAzureService:
    def __init__(self, account_url, containers):
        self.account_url = account_url
        self.containers = containers

    def get_container_client(self, name):
        blobs = self.containers[name]

        class Download:
            def __init__(self, content):
                self._content = content

            def readall(self):
                return self._content.encode()

        class Container:
            def list_blobs(self, name_starts_with=""):
                return [{"name": n} for n in blobs if n.startswith(name_starts_with)]

            def download_blob(self, name):
                return Download(blobs[name])

        return Container()


GCS_BLOBS = [FakeBlob("models/iris/jax_config.json", "{}"),
             FakeBlob("models/iris/ckpt/params", "P"),
             FakeBlob("models/iris2/evil", "X"),
             FakeBlob("models/other/x", "X")]
S3_OBJECTS = {"m/1/conf.json": "C", "m/1/w/p": "W", "m/10/z": "Z", "m/2/z": "Z"}
AZURE = {"models": {"iris/conf.json": "A", "iris/ckpt/p": "B", "iris-old/q": "Q"}}

CASES = {
    "gcs": ("gcs", lambda: FakeGcsClient(GCS_BLOBS), "gs://mybucket/models/iris",
            {"jax_config.json": "{}", os.path.join("ckpt", "params"): "P"}),
    "s3": ("s3", lambda: FakeS3Client(S3_OBJECTS), "s3://bkt/m/1",
           {"conf.json": "C", os.path.join("w", "p"): "W"}),
    "azure": ("azure", lambda url: FakeAzureService(url, AZURE),
              "https://acct.blob.core.windows.net/models/iris",
              {"conf.json": "A", os.path.join("ckpt", "p"): "B"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cloud_scheme_equals_jax(tmp_path, case):
    """The same fake client behind both packages: the same files, and a
    sibling prefix (``iris2``, ``m/10``, ``iris-old``) neither downloaded
    nor written outside the output directory."""
    kind, factory, uri, want = CASES[case]
    trees = []
    for i, cls in enumerate((JaxStorage, Storage)):
        cls.set_client_factory(kind, factory)
        out = cls.download(uri, str(tmp_path / f"o{i}"))
        trees.append(_tree(out))
    assert trees[1] == trees[0] == want
    assert sorted(os.listdir(tmp_path)) == ["o0", "o1"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_empty_prefix_raises(tmp_path, case):
    kind, _, uri, _ = CASES[case]
    empty = {"gcs": lambda: FakeGcsClient([]), "s3": lambda: FakeS3Client({}),
             "azure": lambda url: FakeAzureService(url, {"models": {}})}[kind]
    Storage.set_client_factory(kind, empty)
    with pytest.raises(RuntimeError, match="no objects"):
        Storage.download(uri, str(tmp_path / "o"))


def test_azure_account_url_and_container(tmp_path):
    seen = {}

    def factory(account_url):
        seen["url"] = account_url
        return FakeAzureService(account_url, AZURE)

    Storage.set_client_factory("azure", factory)
    Storage.download("https://acct.blob.core.windows.net/models/iris", str(tmp_path / "o"))
    assert seen["url"] == "https://acct.blob.core.windows.net"
    with pytest.raises(ValueError, match="no container"):
        Storage.download("https://acct.blob.core.windows.net/", str(tmp_path / "p"))


def _block(monkeypatch, module):
    """Make ``module`` unimportable for the test, whether or not it is
    installed: None in ``sys.modules`` and no attribute on its parent
    package, so that no real client is ever built."""
    import sys

    monkeypatch.setitem(sys.modules, module, None)
    parent, _, child = module.rpartition(".")
    if parent in sys.modules and hasattr(sys.modules[parent], child):
        monkeypatch.delattr(sys.modules[parent], child)


@pytest.mark.parametrize("uri,sdk,module", [
    ("gs://mybucket/m", "google-cloud-storage", "google.cloud.storage"),
    ("s3://bkt/m", "boto3", "boto3"),
    ("https://a.blob.core.windows.net/c/m", "azure-storage-blob", "azure.storage.blob"),
])
def test_missing_sdk_raises_clear_error(tmp_path, monkeypatch, uri, sdk, module):
    """Without the SDK both packages raise a RuntimeError naming it."""
    _block(monkeypatch, module)
    for i, cls in enumerate((JaxStorage, Storage)):
        with pytest.raises(RuntimeError, match=sdk):
            cls.download(uri, str(tmp_path / f"o{i}"))


def test_local_and_unknown_schemes_as_jax(tmp_path):
    src = tmp_path / "model"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_text("A")
    (src / "sub" / "b.txt").write_text("B")
    for i, uri in enumerate((f"file://{src}", str(src), f"file://{src}/a.txt")):
        out = Storage.download(uri, str(tmp_path / f"o{i}"))
        assert _tree(out) == _tree(JaxStorage.download(uri, str(tmp_path / f"j{i}")))
    with pytest.raises(RuntimeError, match="does not exist"):
        Storage.download(str(tmp_path / "nope"))
    with pytest.raises(ValueError, match="cannot recognize"):
        Storage.download("ftp://bucket/model")
    with pytest.raises(ValueError, match="unknown storage kind"):
        Storage.set_client_factory("ftp", None)


def test_local_artifact_is_read_in_place(tmp_path, monkeypatch):
    """Without ``out_dir`` a local directory (a path or ``file://`` URI)
    comes back as itself and no temporary copy is made (the reference's
    local no-op; the JAX package copies it on every load). A local file is
    copied into a fresh directory, as in the JAX package, because every
    caller joins its file name onto the result."""
    import tempfile

    made = []

    def mkdtemp(*a, **k):
        d = tmp_path / f"tmp{len(made)}"
        d.mkdir()
        made.append(d)
        return str(d)

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    (tmp_path / "model").mkdir()
    (tmp_path / "model" / "jax_config.json").write_text("{}")
    (tmp_path / "train.npy").write_bytes(b"x")
    assert Storage.download(str(tmp_path / "model")) == str(tmp_path / "model")
    assert Storage.download(f"file://{tmp_path}/model") == str(tmp_path / "model")
    assert made == []
    out = Storage.download(f"file://{tmp_path}/train.npy")
    assert made == [tmp_path / "tmp0"] and out == str(made[0])
    assert _tree(out) == {"train.npy": "x"}
    with pytest.raises(ValueError, match="cannot recognize"):
        Storage.download("ftp://bucket/model")
    assert len(made) == 1


def test_single_file_vae_uri_loads_as_in_jax(tmp_path):
    """A ``file://`` URI naming ``vae.pkl`` itself loads in the port's
    detector, as it does in the JAX package's, and scores the same."""
    from seldon_core_tpu.components import outlier as jout
    from seldon_core_tpu_torch.components import outlier as tout

    X = np.random.RandomState(0).randn(40, 4).astype(np.float32)
    jout.VAEOutlier(mc_samples=2, seed=1).fit(X, epochs=1, batch_size=16).save(str(tmp_path))
    uri = f"file://{tmp_path}/vae.pkl"
    jd = jout.VAEOutlier(mc_samples=2, seed=1, model_uri=uri)
    jd.load()
    td = tout.VAEOutlier(mc_samples=2, seed=1, model_uri=uri, device="cpu")
    td.load()
    np.testing.assert_allclose(td.score(X[:5]), jd.score(X[:5]), rtol=1e-5)


def test_single_file_joblib_uri_loads_as_in_jax(tmp_path):
    """A ``file://`` URI naming ``model.joblib`` itself loads in the
    port's SKLEARN_SERVER, as in the JAX package's, with equal answers."""
    pytest.importorskip("sklearn")
    import joblib
    from sklearn.linear_model import LogisticRegression

    from seldon_core_tpu.servers.sklearnserver import SKLearnServer as JaxSK
    from seldon_core_tpu_torch.servers.sklearnserver import SKLearnServer

    X = np.random.RandomState(0).randn(40, 4)
    joblib.dump(LogisticRegression().fit(X, X[:, 0] > 0), tmp_path / "model.joblib")
    uri = f"file://{tmp_path}/model.joblib"
    ours, theirs = SKLearnServer(uri), JaxSK(uri)
    ours.load()
    theirs.load()
    np.testing.assert_array_equal(ours.predict(X[:5], []), theirs.predict(X[:5], []))


def test_plain_http_takes_the_http_branch(tmp_path):
    """A non-azure http(s) URI downloads over plain HTTP: a refused
    connection on localhost proves the route."""
    with pytest.raises(Exception, match="(refused|unreachable|Connection)"):
        Storage.download("http://127.0.0.1:1/model.bin", str(tmp_path / "o"))
