"""Shared set-up for the tests of the port's user tools and operator side
(client, testers, load tester, batch scorer, native engine, Kubernetes
render and the kube operator): a component behind the port's
microservice, the port's engine on real sockets, and an in-memory kube
API for either package."""

import copy
import importlib

import numpy as np

from _net import free_port, serve_on_thread

JAX, PORT = "seldon_core_tpu", "seldon_core_tpu_torch"
PKGS = (JAX, PORT)


def m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


class Proba:
    """A three-class component with every hook the client can reach."""

    def predict(self, X, names, meta=None):
        X = np.asarray(X, dtype=float)
        z = np.abs(X[:, :1]) + 1.0
        return np.concatenate([0.2 * np.ones_like(z), 0.3 * np.ones_like(z),
                               0.5 * np.ones_like(z)], axis=1)

    def transform_input(self, X, names, meta=None):
        return np.asarray(X, dtype=float) + 1.0

    def route(self, X, names, meta=None):
        return 1

    def aggregate(self, features_list, names_list, meta_list=None):
        return np.mean([np.asarray(f, dtype=float) for f in features_list], axis=0)

    def send_feedback(self, features, names, reward, truth, routing=None):
        self.last_reward = reward
        return []


def serve_microservice(obj, grpc=True):
    """``obj`` behind the port's REST microservice (and its gRPC server):
    ``(rest "host:port", grpc "host:port" or None, stop)``."""
    wrapper = m(PORT, "wrapper")
    port = free_port()
    stop_rest = serve_on_thread(
        wrapper.get_rest_microservice(obj).serve_forever("127.0.0.1", port), port)
    server, gaddr = None, None
    if grpc:
        gport = free_port()
        server = wrapper.get_grpc_server(obj)
        server.add_insecure_port(f"127.0.0.1:{gport}")
        server.start()
        gaddr = f"127.0.0.1:{gport}"

    def stop():
        if server is not None:
            server.stop(grace=0)
        stop_rest()

    return f"127.0.0.1:{port}", gaddr, stop


def engine_app(graph, name="p", annotations=None):
    """The port's EngineApp over ``graph`` (defaulted and validated)."""
    spec = m(PORT, "graph.spec")
    metrics = m(PORT, "graph.engine_metrics")
    pspec = spec.default_predictor(spec.PredictorSpec.from_dict(
        {"name": name, "graph": copy.deepcopy(graph), "annotations": annotations or {}}))
    spec.validate_predictor(pspec)
    return m(PORT, "graph.service").EngineApp(pspec, metrics=metrics.MetricsRegistry())


def serve_engine(graph, grpc=False, **kw):
    """The port's engine over ``graph`` on free ports:
    ``(app, rest port, grpc port or None, stop)``."""
    app = engine_app(graph, **kw)
    port = free_port()
    gport = free_port() if grpc else None

    async def run():
        srv = None
        if grpc:
            srv = app.grpc_server()
            srv.add_insecure_port(f"127.0.0.1:{gport}")
            await srv.start()
        try:
            await app.rest_app().serve_forever("127.0.0.1", port)
        finally:
            if srv is not None:
                await srv.stop(0)
            await app.executor.close()

    stop = serve_on_thread(run(), port)
    return app, port, gport, stop


def fake_kube(pkg):
    """An in-memory kube-apiserver speaking ``pkg``'s ``KubeApi`` (and
    raising its ``KubeApiError``): objects keyed by resource path, every
    call recorded as ``(verb, path)`` — the JAX tests' FakeKube, with
    lists across namespaces."""
    kube = m(pkg, "controlplane.kube")

    class FakeKube(kube.KubeApi):
        def __init__(self):
            self.objects = {}
            self.calls = []
            self._rv = 0

        def _record(self, verb, path):
            self.calls.append((verb, path))

        def writes(self):
            return [c for c in self.calls if c[0] in ("create", "replace", "delete")]

        def reset_calls(self):
            self.calls = []

        def get(self, path):
            self._record("get", path)
            obj = self.objects.get(path)
            return copy.deepcopy(obj) if obj is not None else None

        def list(self, path, label_selector=""):
            self._record("list", path)
            want = dict(kv.split("=", 1) for kv in label_selector.split(",") if kv)
            out = []
            for p, obj in self.objects.items():
                collection = p.rsplit("/", 1)[0]
                if "/namespaces/" not in path and "/namespaces/" in collection:
                    # a list across namespaces: drop the namespace segment
                    head, rest = collection.split("/namespaces/", 1)
                    collection = head + "/" + rest.split("/", 1)[1]
                if collection != path:
                    continue
                labels = obj.get("metadata", {}).get("labels", {})
                if all(labels.get(k) == v for k, v in want.items()):
                    out.append(copy.deepcopy(obj))
            return out

        def create(self, path, obj):
            self._record("create", path)
            full = f"{path}/{obj['metadata']['name']}"
            if full in self.objects:
                raise kube.KubeApiError(409, f"already exists: {full}")
            self._rv += 1
            stored = copy.deepcopy(obj)
            stored["metadata"]["resourceVersion"] = str(self._rv)
            stored["metadata"].setdefault("uid", f"uid-{self._rv}")
            self.objects[full] = stored
            return copy.deepcopy(stored)

        def replace(self, path, obj):
            self._record("replace", path)
            base = path[: -len("/status")] if path.endswith("/status") else path
            if base not in self.objects:
                raise kube.KubeApiError(404, f"not found: {base}")
            if path.endswith("/status"):
                self.objects[base]["status"] = copy.deepcopy(obj.get("status", {}))
                return copy.deepcopy(self.objects[base])
            self._rv += 1
            stored = copy.deepcopy(obj)
            stored["metadata"]["resourceVersion"] = str(self._rv)
            self.objects[base] = stored
            return copy.deepcopy(stored)

        def delete(self, path):
            self._record("delete", path)
            return self.objects.pop(path, None) is not None

    return FakeKube()


def put_cr(pkg, fake, cr):
    """Create or update a CR in ``fake`` as a user's kubectl would."""
    path = m(pkg, "controlplane.kube").object_path("SeldonDeployment", cr["metadata"]["namespace"])
    full = f"{path}/{cr['metadata']['name']}"
    if full in fake.objects:
        stored = copy.deepcopy(cr)
        stored["metadata"]["resourceVersion"] = fake.objects[full]["metadata"]["resourceVersion"]
        stored["metadata"]["uid"] = fake.objects[full]["metadata"]["uid"]
        fake.objects[full] = stored
    else:
        fake.create(path, copy.deepcopy(cr))
        fake.reset_calls()
