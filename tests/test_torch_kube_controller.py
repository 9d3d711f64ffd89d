"""The port's live-cluster operator (seldon_core_tpu_torch/controlplane/
kube.py) held against the JAX package's on the CPU.

Counterpart of tests/test_kube_controller.py (and the ``controller
--kube`` cases of tests/test_cli.py): both packages' controllers, each
against an in-memory kube API fed the same CR events, make the same
sequence of ``(verb, path)`` calls and report the same op counts —
create and converge to zero writes, update, drift repair, pruning by
label, CR deletion, a bad CR failing alone, the run loop; the port's
objects are its own render (the GPU, its engine); the watch stream, the
monotonic CRD wait and ``sdctl controller --kube --once``."""

import copy
import json
import socket
import threading
import time

import pytest

from _torch_tools import JAX, PKGS, PORT, fake_kube, m, put_cr


def kube(pkg):
    return m(pkg, "controlplane.kube")


CR = {
    "apiVersion": "machinelearning.seldon.io/v1alpha2",
    "kind": "SeldonDeployment",
    "metadata": {"name": "iris", "namespace": "prod"},
    "spec": {"predictors": [{
        "name": "main", "replicas": 2,
        "graph": {"name": "clf", "type": "MODEL", "implementation": "SKLEARN_SERVER",
                  "modelUri": "gs://bucket/iris"}}]},
}


def gpu_cr(name="mnist", replicas=1):
    cr = copy.deepcopy(CR)
    cr["metadata"]["name"] = name
    cr["spec"]["predictors"][0]["replicas"] = replicas
    cr["spec"]["predictors"][0]["graph"].update(implementation="JAX_SERVER",
                                                modelUri="file:///models/mnist")
    return cr


def with_canary(cr):
    cr = copy.deepcopy(cr)
    cr["spec"]["predictors"][0]["traffic"] = 90
    cr["spec"]["predictors"].append({
        "name": "canary", "replicas": 1, "traffic": 10,
        "graph": {"name": "clf", "type": "MODEL", "implementation": "SKLEARN_SERVER",
                  "modelUri": "gs://bucket/iris-v2"}})
    return cr


def bad_cr():
    bad = copy.deepcopy(CR)
    bad["metadata"]["name"] = "broken"
    bad["spec"]["predictors"][0]["graph"] = {"name": "x", "type": "MODEL"}
    bad["spec"]["predictors"][0]["replicas"] = -3
    return bad


def scenario(pkg, name):
    """Drive one scenario against a fresh fake API: every step's op
    counts and the calls it made, and the final store's keys."""
    k = kube(pkg)
    fake = fake_kube(pkg)
    steps = []

    def ctl_pass(ctl):
        fake.reset_calls()
        ops = ctl.reconcile_all()
        steps.append((ops, list(fake.calls)))

    if name == "create-converge":
        put_cr(pkg, fake, CR)
        put_cr(pkg, fake, gpu_cr())
        ctl = k.KubeController(fake, namespace="prod")
        ctl_pass(ctl)
        ctl_pass(ctl)
    elif name == "update":
        put_cr(pkg, fake, CR)
        ctl = k.KubeController(fake, namespace="prod")
        ctl_pass(ctl)
        cr2 = copy.deepcopy(CR)
        cr2["spec"]["predictors"][0]["replicas"] = 5
        put_cr(pkg, fake, cr2)
        ctl_pass(ctl)
    elif name == "drift":
        put_cr(pkg, fake, gpu_cr())
        ctl = k.KubeController(fake, namespace="prod")
        ctl_pass(ctl)
        path = k.object_path("Deployment", "prod", "mnist-main")
        fake.objects[path]["spec"]["replicas"] = 9
        fake.objects[path]["spec"]["template"]["spec"]["containers"][0]["image"] = "x"
        ctl_pass(ctl)
        steps.append(fake.objects[path]["spec"]["replicas"])
    elif name == "prune-predictor":
        put_cr(pkg, fake, with_canary(CR))
        ctl = k.KubeController(fake, namespace="prod")
        ctl_pass(ctl)
        put_cr(pkg, fake, CR)
        ctl_pass(ctl)
    elif name == "cr-delete":
        put_cr(pkg, fake, CR)
        put_cr(pkg, fake, dict(gpu_cr(), metadata={"name": "other", "namespace": "dev"}))
        ctl = k.KubeController(fake)
        ctl_pass(ctl)
        fake.delete(k.object_path("SeldonDeployment", "prod", "iris"))
        ctl_pass(ctl)
        fake.delete(k.object_path("SeldonDeployment", "dev", "other"))
        ctl_pass(ctl)
    elif name == "bad-cr":
        put_cr(pkg, fake, CR)
        put_cr(pkg, fake, bad_cr())
        ctl = k.KubeController(fake, namespace="prod")
        ctl_pass(ctl)
        steps.append(fake.objects[k.object_path("SeldonDeployment", "prod", "broken")][
            "status"]["state"])
    elif name == "run-iterations":
        put_cr(pkg, fake, CR)
        ctl = k.KubeController(fake, namespace="prod", resync_s=0.01)
        ctl.run(iterations=2)
        steps.append(list(fake.calls))
    return steps, sorted(fake.objects)


SCENARIOS = ["create-converge", "update", "drift", "prune-predictor", "cr-delete", "bad-cr",
             "run-iterations"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_controllers_make_the_same_calls_as_jax(name):
    want = scenario(JAX, name)
    got = scenario(PORT, name)
    assert got == want


def test_cr_create_converges_then_zero_writes():
    fake = fake_kube(PORT)
    put_cr(PORT, fake, gpu_cr(replicas=2))
    ctl = kube(PORT).KubeController(fake, namespace="prod")
    ops = ctl.reconcile_all()
    assert ops["created"] >= 2 and ops["failed"] == 0
    dep = fake.objects[kube(PORT).object_path("Deployment", "prod", "mnist-main")]
    assert dep["spec"]["replicas"] == 2
    assert dep["metadata"]["labels"]["seldon-deployment-id"] == "mnist"
    assert dep["metadata"]["ownerReferences"][0]["kind"] == "SeldonDeployment"
    pod = dep["spec"]["template"]["spec"]
    assert pod["containers"][0]["command"] == ["seldon-tpu-torch-engine"]
    assert pod["containers"][0]["resources"]["limits"] == {"nvidia.com/gpu": "1"}
    cr_path = kube(PORT).object_path("SeldonDeployment", "prod", "mnist")
    assert fake.objects[cr_path]["status"]["state"] == "Available"
    fake.reset_calls()
    ops = ctl.reconcile_all()
    assert ops["created"] == ops["replaced"] == ops["deleted"] == 0
    assert [c for c in fake.writes() if "/status" not in c[1]] == []


@pytest.mark.parametrize("mesh", [{"tpuMesh": {"model": 4}},
                                  {"annotations": {"seldon.io/mesh": "model=4"}},
                                  {"tpuMesh": {"data": 2, "model": 8}},
                                  {"jax_server": {"model": 4}}])
def test_mesh_cr_fails_alone_not_ported(mesh):
    """A generate CR with a mesh converges in both packages' controllers:
    the same ops and object paths, its Deployment asking the port for
    the mesh's 4 cards (the JAX controller's for 4 TPU chips, or, for
    the annotation, nothing). A mesh for TorchServer (a JAX_SERVER unit:
    sharded predict), once refused, converges the same way. Still failing
    alone, not ported, while the other CR converges: a mesh of 16 cards
    (more than one host's: the JAX controller's multi-host
    StatefulSet)."""
    cr = gpu_cr()
    pred = cr["spec"]["predictors"][0]
    if "jax_server" in mesh:
        pred["tpuMesh"] = mesh["jax_server"]
    else:
        pred["graph"].update(implementation="GENERATE_SERVER", modelUri="/models/llm")
        pred.update(copy.deepcopy(mesh))
    refused = mesh.get("tpuMesh") == {"data": 2, "model": 8}
    if refused:
        pred["replicas"] = 1  # JAX renders one slice of a multi-host mesh
    ops, paths = {}, {}
    for pkg in PKGS:
        fake = fake_kube(pkg)
        put_cr(pkg, fake, CR)
        put_cr(pkg, fake, cr)
        ops[pkg] = kube(pkg).KubeController(fake, namespace="prod").reconcile_all()
        paths[pkg] = fake
    fake = paths[PORT]
    status = fake.objects[kube(PORT).object_path("SeldonDeployment", "prod", "mnist")]["status"]
    assert kube(PORT).object_path("Deployment", "prod", "iris-main") in fake.objects
    if refused:
        assert ops[PORT]["failed"] == 1 and ops[JAX]["failed"] == 0
        assert status["state"] == "Failed" and "not ported" in status["description"]
        assert kube(PORT).object_path("Deployment", "prod", "mnist-main") not in fake.objects
        return
    assert ops[PORT] == ops[JAX] and ops[PORT]["failed"] == 0
    assert status["state"] == "Available"
    assert sorted(paths[PORT].objects) == sorted(paths[JAX].objects)
    dep = fake.objects[kube(PORT).object_path("Deployment", "prod", "mnist-main")]
    engine = dep["spec"]["template"]["spec"]["containers"][0]
    assert engine["resources"]["limits"] == {"nvidia.com/gpu": "4"}
    env = {e["name"]: e.get("value") for e in engine["env"]}
    spec = m(PORT, "graph.spec").PredictorSpec.from_env_b64(env["ENGINE_PREDICTOR"])
    assert spec.tpu_mesh == {"model": 4} and "seldon.io/mesh" not in spec.annotations


@pytest.mark.parametrize("desired,live", [
    ({"a": 1}, {"a": 1, "b": 2}),
    ({"a": 1}, {"a": 2, "b": 2}),
    ({"a": [{"x": 1}]}, {"a": [{"x": 1, "y": 2}]}),
    ({"a": [1, 2]}, {"a": [1]}),
    (2, 2.0),
    ({"a": {"b": 1}}, {"a": 3}),
    ("1", 1),
])
def test_subset_equal_equals_jax(desired, live):
    assert kube(PORT).subset_equal(desired, live) == kube(JAX).subset_equal(desired, live)


def test_kind_routes_and_paths_equal_jax():
    assert kube(PORT).KIND_ROUTES == kube(JAX).KIND_ROUTES
    for kind in kube(PORT).KIND_ROUTES:
        for ns, name in (("prod", "x"), ("prod", None), (None, "y")):
            assert kube(PORT).object_path(kind, ns, name) == kube(JAX).object_path(kind, ns, name)
    with pytest.raises(ValueError, match="no API route"):
        kube(PORT).object_path("Pod", "x")


def test_watch_events_accelerate_the_loop():
    import queue

    fake = fake_kube(PORT)
    events: "queue.Queue" = queue.Queue()

    def watch(path, timeout_s=300.0):
        while True:
            ev = events.get()
            if ev is None:
                return
            yield ev

    fake.watch = watch
    ctl = kube(PORT).KubeController(fake, namespace="prod", resync_s=30.0)
    t = threading.Thread(target=ctl.run, daemon=True)
    t.start()
    try:
        time.sleep(0.2)
        put_cr(PORT, fake, CR)
        events.put({"type": "ADDED", "object": CR})
        deadline = time.time() + 5.0
        path = kube(PORT).object_path("Deployment", "prod", "iris-main")
        while time.time() < deadline and path not in fake.objects:
            time.sleep(0.05)
        assert path in fake.objects
    finally:
        ctl.stop()
        events.put(None)
        t.join(timeout=5)
        assert not t.is_alive()


def test_http_kube_api_watch_and_verbs_against_a_socket():
    """HttpKubeApi over a real socket: a watch stream of JSON lines, then
    GET/list/POST/PUT/DELETE with the apiserver's status codes."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    port = srv.getsockname()[1]
    seen = []
    events = [{"type": "ADDED", "object": {"metadata": {"name": "a"}}},
              {"type": "MODIFIED", "object": {"metadata": {"name": "a"}}}]
    replies = {
        "GET": (200, {"items": [{"metadata": {"name": "a"}}]}),
        "POST": (201, {"metadata": {"name": "b"}}),
        "PUT": (409, {"message": "conflict"}),
        "DELETE": (404, {}),
    }

    def serve():
        for _ in range(5):
            conn, _ = srv.accept()
            req = b""
            while b"\r\n\r\n" not in req:
                req += conn.recv(4096)
            head = req.split(b"\r\n")[0].decode()
            seen.append((head, [h for h in req.split(b"\r\n") if h.lower().startswith(
                b"authorization")]))
            method = head.split()[0]
            if "watch=1" in head:
                body = b"".join(json.dumps(e).encode() + b"\n" for e in events)
                status = 200
            else:
                status, obj = replies[method]
                body = json.dumps(obj).encode()
            conn.sendall(f"HTTP/1.1 {status} X\r\nContent-Type: application/json\r\n"
                         f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
            conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    k = kube(PORT)
    api = k.HttpKubeApi(server=f"http://127.0.0.1:{port}", token="tok")
    got = list(api.watch("apis/machinelearning.seldon.io/v1alpha2/seldondeployments",
                         timeout_s=5))
    assert [e["type"] for e in got] == ["ADDED", "MODIFIED"]
    assert api.list("api/v1/namespaces/p/services", "a=b,c=d") == [{"metadata": {"name": "a"}}]
    assert api.create("api/v1/namespaces/p/services", {"x": 1}) == {"metadata": {"name": "b"}}
    with pytest.raises(k.KubeApiError, match="409: conflict") as e:
        api.replace("api/v1/namespaces/p/services/a", {"x": 1})
    assert e.value.status == 409
    assert api.delete("api/v1/namespaces/p/services/a") is False
    t.join(5)
    srv.close()
    assert "labelSelector=a%3Db%2Cc%3Dd" in seen[1][0]
    assert all(auth == [b"Authorization: Bearer tok"] for _h, auth in seen)


def test_wait_crd_established_never_reads_the_wall_clock(monkeypatch):
    k = kube(PORT)
    fake = fake_kube(PORT)
    ctl = k.KubeController(fake)

    def boom():
        raise AssertionError("wait_crd_established read time.time()")

    monkeypatch.setattr(k.time, "time", boom)
    monkeypatch.setattr(k.time, "sleep", lambda s: None)
    real_list = fake.list

    def not_established(path):
        raise k.KubeApiError(404, "endpoint not established")

    monkeypatch.setattr(fake, "list", not_established)
    assert ctl.wait_crd_established(timeout_s=0.05) is False
    monkeypatch.setattr(fake, "list", real_list)
    assert ctl.wait_crd_established(timeout_s=0.05) is True


def test_install_crd_idempotent():
    fake = fake_kube(PORT)
    ctl = kube(PORT).KubeController(fake)
    assert ctl.install_crd() is True and ctl.install_crd() is False
    path = kube(PORT).object_path("CustomResourceDefinition", None,
                                  kube(PORT).CRD_MANIFEST["metadata"]["name"])
    assert fake.objects[path]["spec"]["names"]["kind"] == "SeldonDeployment"


def _kube_cli(pkg, monkeypatch, capsys, tmp_path, crs, *extra):
    fake = fake_kube(pkg)
    for cr in crs:
        put_cr(pkg, fake, cr)
    monkeypatch.setattr(kube(pkg), "HttpKubeApi", lambda **kw: fake)
    with pytest.raises(SystemExit) as e:
        m(pkg, "controlplane.cli").main(["--store-dir", str(tmp_path / pkg), "-n", "prod",
                                         "controller", "--kube", "--once", *extra])
    return e.value.code, json.loads(capsys.readouterr().out.strip().splitlines()[-1]), fake


@pytest.mark.parametrize("crs,code", [([CR], 0), ([CR, bad_cr()], 1)])
def test_sdctl_controller_kube_once_equals_jax(monkeypatch, capsys, tmp_path, crs, code):
    got = {pkg: _kube_cli(pkg, monkeypatch, capsys, tmp_path, crs) for pkg in PKGS}
    assert got[PORT][:2] == got[JAX][:2] and got[PORT][0] == code
    assert got[PORT][2].calls == got[JAX][2].calls
    assert kube(PORT).object_path("Deployment", "prod", "iris-main") in got[PORT][2].objects


def test_sdctl_controller_kube_needs_a_cluster(tmp_path, monkeypatch):
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(RuntimeError, match="kubectl proxy"):
        m(PORT, "controlplane.cli").main(["--store-dir", str(tmp_path), "controller", "--kube"])
