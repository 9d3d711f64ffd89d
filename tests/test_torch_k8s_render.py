"""The port's Kubernetes renderer (seldon_core_tpu_torch/controlplane/
k8s.py) held against the JAX package's on the CPU.

Counterpart of tests/test_k8s_render.py. For the same SeldonDeployment the
two packages' manifests differ exactly where the device differs and
nowhere else: the engine's command and default image, and, for a
predictor whose engine runs a model on the card, ``nvidia.com/gpu`` (the
mesh's product of cards for sharded serving) with its toleration and
node selector (``ROADMAP.md``, "Deliberate differences"). A multi-host
mesh refuses, in the renderer and in ``sdctl render``; the canary's semantics round-trip through the YAML;
validation and YAML output equal the JAX package's."""

import base64
import copy
import json

import pytest
import yaml

from _torch_tools import JAX, PKGS, PORT, m

MISSING = "<absent>"


def k8s(pkg):
    return m(pkg, "controlplane.k8s")


def render(pkg, dep_dict):
    dep = m(pkg, "controlplane.resource").SeldonDeployment.from_dict(copy.deepcopy(dep_dict))
    manifests = k8s(pkg).render(dep)
    k8s(pkg).validate_manifests(manifests)
    return manifests


def unit(name, impl, **extra):
    return {"name": name, "type": "MODEL", "implementation": impl, **extra}


def dep(predictors, annotations=None, name="mnist", namespace="prod"):
    return {"apiVersion": "machinelearning.seldon.io/v1alpha2", "kind": "SeldonDeployment",
            "metadata": {"name": name, "namespace": namespace,
                         **({"annotations": annotations} if annotations else {})},
            "spec": {"name": name, "predictors": predictors}}


CANARY = dep([
    {"name": "main", "replicas": 3, "traffic": 90,
     "hpaSpec": {"minReplicas": 2, "maxReplicas": 8, "targetConcurrency": 16},
     "graph": unit("clf", "JAX_SERVER", modelUri="file:///models/mnist")},
    {"name": "canary", "replicas": 1, "traffic": 10,
     "graph": unit("clf", "JAX_SERVER", modelUri="file:///models/mnist-v2")},
    {"name": "shadow", "replicas": 1, "annotations": {"seldon.io/shadow": "true"},
     "graph": unit("clf", "JAX_SERVER", modelUri="file:///models/mnist-exp")},
])

# case -> (deployment, which predictors' engines run on the card)
CASES = {
    "canary-on-the-card": (CANARY, {"main", "canary", "shadow"}),
    "host-units": (dep([{"name": "p", "graph": {
        "name": "r", "implementation": "RANDOM_ABTEST",
        "children": [unit("a", "SIMPLE_MODEL"),
                     unit("b", "SKLEARN_SERVER", modelUri="gs://b/iris")]}}]), set()),
    "remote-and-cpu-units": (dep([
        {"name": "remote", "traffic": 50, "graph": unit(
            "clf", "JAX_SERVER", modelUri="/m",
            endpoint={"service_host": "model-svc", "service_port": 9000, "transport": "REST"})},
        {"name": "cpu", "traffic": 50, "graph": unit(
            "llm", "GENERATE_SERVER", modelUri="/m",
            parameters=[{"name": "device", "value": "cpu", "type": "STRING"}])},
    ]), set()),
    "generate-with-annotations": (dep(
        [{"name": "gen", "replicas": 2, "labels": {"team": "a"},
          "annotations": {"seldon.io/engine-env-foo-bar": "1"},
          "hpaSpec": {"minReplicas": 1, "maxReplicas": 4, "targetConcurrency": 2.5},
          "graph": {"name": "rag", "implementation": "RAG_PROMPT_BUILDER",
                    "children": [unit("llm", "GENERATE_SERVER", modelUri="/m", parameters=[
                        {"name": "device", "value": "cuda", "type": "STRING"}])]}}],
        annotations={"seldon.io/engine-image": "registry.local/engine:1",
                     "seldon.io/gpu-accelerator": "nvidia-h100-mega-80gb",
                     "seldon.io/engine-cpu": "2"}), {"gen"}),
}

CONTAINER = ("spec", "template", "spec", "containers", 0)
# the deliberate differences of every rendered Deployment
ENGINE_DIFFERENCES = [
    (CONTAINER + ("command", 0), "seldon-tpu-engine", "seldon-tpu-torch-engine"),
    (CONTAINER + ("image",), "ghcr.io/seldon-core-tpu/engine:latest",
     "ghcr.io/seldon-core-tpu/engine-torch-cuda:latest"),
]


def gpu_differences(accelerator="nvidia-h100-80gb"):
    """The deliberate differences of a Deployment whose engine runs a
    model on the card."""
    return [
        (CONTAINER + ("resources", "limits"), MISSING, {"nvidia.com/gpu": "1"}),
        (CONTAINER + ("resources", "requests", "nvidia.com/gpu"), MISSING, "1"),
        (("spec", "template", "spec", "nodeSelector"), MISSING,
         {"cloud.google.com/gke-accelerator": accelerator}),
        (("spec", "template", "spec", "tolerations"), MISSING,
         [{"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"}]),
    ]


def json_diff(a, b, path=()):
    """The leaves where ``a`` and ``b`` differ: ``[(path, a's, b's)]``,
    ``MISSING`` for a key one side lacks."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = []
        for k in sorted(set(a) | set(b)):
            out += json_diff(a.get(k, MISSING), b.get(k, MISSING), path + (k,))
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in json_diff(x, y, path + (i,))]
    return [] if a == b else [(path, a, b)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_differs_from_jax_exactly_where_the_device_differs(case):
    dep_dict, on_card = CASES[case]
    want, got = (render(pkg, dep_dict) for pkg in PKGS)
    assert [x["kind"] for x in got] == [x["kind"] for x in want]
    ann = dep_dict["metadata"].get("annotations", {})
    for i, (w, g) in enumerate(zip(want, got)):
        expected = []
        if g["kind"] == "Deployment":
            expected = [d for d in ENGINE_DIFFERENCES
                        if d[0][-1] != "image" or "seldon.io/engine-image" not in ann]
            predictor = g["metadata"]["labels"]["seldon-predictor"]
            if predictor in on_card:
                expected += gpu_differences(ann.get("seldon.io/gpu-accelerator",
                                                    "nvidia-h100-80gb"))
        assert sorted(json_diff(w, g), key=repr) == sorted(expected, key=repr), (
            case, i, g["kind"], g["metadata"]["name"])


def test_engine_predictor_env_boots_the_port_engine(monkeypatch):
    """Each pod's ENGINE_PREDICTOR loads through the port engine's own
    loader (defaulted, validated, traffic zeroed)."""
    engine_main = m(PORT, "engine_main")
    for d in render(PORT, CASES["generate-with-annotations"][0]):
        if d["kind"] != "Deployment":
            continue
        env = {e["name"]: e.get("value") for e in d["spec"]["template"]["spec"][
            "containers"][0]["env"]}
        assert env["FOO_BAR"] == "1"
        monkeypatch.setenv("ENGINE_PREDICTOR", env["ENGINE_PREDICTOR"])
        spec = engine_main.load_spec(None)
        assert spec.name == "gen" and spec.traffic == 0
        assert [u.implementation for u in spec.graph.walk()] == [
            "RAG_PROMPT_BUILDER", "GENERATE_SERVER"]
        assert json.loads(base64.b64decode(env["ENGINE_PREDICTOR"]))["graph"]["name"] == "rag"


def test_render_round_trips_canary_semantics():
    docs = list(yaml.safe_load_all(k8s(PORT).to_yaml(render(PORT, CANARY))))
    by_kind = {}
    for d in docs:
        by_kind.setdefault(d["kind"], []).append(d)
    deps = {d["metadata"]["name"]: d for d in by_kind["Deployment"]}
    assert set(deps) == {"mnist-main", "mnist-canary", "mnist-shadow"}
    main = deps["mnist-main"]
    assert main["spec"]["replicas"] == 3
    pod = main["spec"]["template"]["spec"]
    assert pod["nodeSelector"] == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    assert pod["tolerations"][0]["key"] == "nvidia.com/gpu"
    engine = pod["containers"][0]
    assert engine["command"] == ["seldon-tpu-torch-engine"]
    assert engine["resources"]["limits"]["nvidia.com/gpu"] == "1"
    assert engine["resources"]["requests"]["nvidia.com/gpu"] == "1"
    assert "/pause" in engine["lifecycle"]["preStop"]["exec"]["command"][2]
    assert "/inflight" in engine["lifecycle"]["preStop"]["exec"]["command"][2]
    spec = m(PORT, "graph.spec").PredictorSpec.from_env_b64(
        {e["name"]: e.get("value") for e in engine["env"]}["ENGINE_PREDICTOR"])
    assert spec.name == "main" and spec.traffic == 0
    assert spec.graph.model_uri == "file:///models/mnist"
    (hpa,) = by_kind["HorizontalPodAutoscaler"]
    assert (hpa["spec"]["minReplicas"], hpa["spec"]["maxReplicas"]) == (2, 8)
    assert hpa["spec"]["metrics"][0]["pods"]["metric"]["name"] == "seldon_engine_inflight"
    vs = by_kind["VirtualService"][0]["spec"]
    weights = {r["destination"]["host"].split(".")[0]: r["weight"]
               for r in vs["http"][0]["route"]}
    assert weights == {"mnist-main": 90, "mnist-canary": 10}
    assert vs["http"][0]["mirror"]["host"].startswith("mnist-shadow.")
    services = {s["metadata"]["name"]: s for s in by_kind["Service"]}
    assert services["mnist"]["spec"]["selector"]["seldon-traffic"] == "live"


def test_canary_vs_and_dr_pair_routably():
    by_kind = {}
    for d in render(PORT, CANARY):
        by_kind.setdefault(d["kind"], []).append(d)
    drs = {(d["spec"]["host"], s["name"]): s["labels"]
           for d in by_kind["DestinationRule"] for s in d["spec"]["subsets"]}
    pod_labels = {d["spec"]["template"]["metadata"]["labels"]["seldon-predictor"]
                  for d in by_kind["Deployment"]}
    for rule in by_kind["VirtualService"][0]["spec"]["http"]:
        dests = [r["destination"] for r in rule["route"]]
        if "mirror" in rule:
            dests.append(rule["mirror"])
        for dest in dests:
            key = (dest["host"], dest["subset"])
            assert key in drs and drs[key]["seldon-predictor"] in pod_labels


GEN_DEP = dep([{"name": "gen", "replicas": 2,
                "graph": unit("llm", "GENERATE_SERVER", modelUri="/m")}])
TORCH_DEP = dep([{"name": "main", "replicas": 2,
                  "graph": unit("clf", "JAX_SERVER", modelUri="file:///models/mnist")}])
POD = ("spec", "template", "spec")


@pytest.mark.parametrize("where", ["tpuMesh", "predictor-annotation", "deployment-annotation",
                                   "multi-host", "torchserver"])
def test_mesh_refuses_not_ported(where, tmp_path, capsys, monkeypatch):
    """Sharded generate serving renders: a generate predictor with a
    ``tpuMesh`` or a ``seldon.io/mesh`` annotation is one pod per replica
    asking for the mesh's product of ``nvidia.com/gpu`` (4 here), where
    the JAX renderer asks for ``google.com/tpu`` (for a tpuMesh; it
    renders the annotation as no mesh at all). The annotation reaches the
    engine as the predictor's tpuMesh. A deployment-level annotation is
    not a predictor's mesh, in either package. A mesh for TorchServer (a
    JAX_SERVER unit: sharded predict), once refused, renders the same
    way. Still refused, not ported: a mesh past one host's cards (JAX: a
    multi-host StatefulSet)."""
    d = copy.deepcopy(TORCH_DEP if where == "torchserver" else GEN_DEP)
    p = d["spec"]["predictors"][0]
    if where in ("tpuMesh", "torchserver"):
        p["tpuMesh"] = {"data": 1, "model": 4}
    elif where == "multi-host":
        p["tpuMesh"] = {"data": 2, "model": 8}
        p["replicas"] = 1  # JAX renders one slice of a multi-host mesh
    elif where == "predictor-annotation":
        p["annotations"] = {"seldon.io/mesh": "data=1,model=4"}
    else:
        d["metadata"]["annotations"] = {"seldon.io/mesh": "model=2"}
    if where == "multi-host":
        render(JAX, d)  # the JAX renderer renders it
        with pytest.raises(m(PORT, "graph.spec").GraphSpecError, match="not ported"):
            render(PORT, d)
        f = tmp_path / "dep.json"
        f.write_text(json.dumps(d))
        with pytest.raises(SystemExit, match="sdctl render: .*not ported"):
            m(PORT, "controlplane.cli").main(["--store-dir", str(tmp_path / "s"), "render",
                                              "-f", str(f)])
        return
    want, got = (render(pkg, d) for pkg in PKGS)
    assert [x["kind"] for x in got] == [x["kind"] for x in want]
    cards = "1" if where == "deployment-annotation" else "4"
    (deployment,) = [x for x in got if x["kind"] == "Deployment"]
    engine = deployment["spec"]["template"]["spec"]["containers"][0]
    assert engine["resources"]["limits"] == {"nvidia.com/gpu": cards}
    assert engine["resources"]["requests"]["nvidia.com/gpu"] == cards
    assert deployment["spec"]["replicas"] == 2
    env = {e["name"]: e.get("value") for e in engine["env"]}
    monkeypatch.setenv("ENGINE_PREDICTOR", env["ENGINE_PREDICTOR"])
    spec = m(PORT, "engine_main").load_spec(None)
    assert spec.tpu_mesh == (None if cards == "1" else {"data": 1, "model": 4})
    assert "seldon.io/mesh" not in spec.annotations
    for w, g in zip(want, got):
        paths = {d_[0] for d_ in json_diff(w, g)}
        if g["kind"] != "Deployment":
            assert paths == set()
            continue
        expected = {d_[0] for d_ in ENGINE_DIFFERENCES + gpu_differences()}
        if where == "predictor-annotation":
            expected.add(CONTAINER + ("env", 0, "value"))  # tpuMesh injected
        if where in ("tpuMesh", "torchserver"):
            # JAX asks for 4 TPU chips where the port asks for 4 cards
            assert w["spec"]["template"]["spec"]["containers"][0]["resources"]["limits"] == {
                "google.com/tpu": "4"}
            prefixes = [CONTAINER + ("command",), CONTAINER + ("image",),
                        CONTAINER + ("resources",), POD + ("nodeSelector",),
                        POD + ("tolerations",)]
            assert all(any(q[:len(pre)] == pre for pre in prefixes) for q in paths), paths
            continue
        assert paths == expected, where


def test_to_yaml_equals_jax():
    manifests = render(PORT, CANARY)
    assert k8s(PORT).to_yaml(manifests) == k8s(JAX).to_yaml(manifests)


def _breakages(manifests):
    cases = []
    broken = copy.deepcopy(manifests)
    for x in broken:
        if x["kind"] == "HorizontalPodAutoscaler":
            x["spec"]["scaleTargetRef"]["name"] = "nope"
    cases.append(broken)
    broken = copy.deepcopy(manifests)
    broken[0]["spec"]["selector"]["matchLabels"]["extra"] = "x"
    cases.append(broken)
    broken = copy.deepcopy(manifests)
    broken[0]["spec"]["template"]["spec"]["containers"][0]["readinessProbe"]["httpGet"][
        "port"] = "admin"
    cases.append(broken)
    cases.append(manifests + [copy.deepcopy(manifests[0])])
    broken = copy.deepcopy(manifests)
    del broken[1]["metadata"]["namespace"]
    cases.append(broken)
    broken = copy.deepcopy(manifests)
    for x in broken:
        if x["kind"] == "HorizontalPodAutoscaler":
            x["spec"]["minReplicas"] = 9
    cases.append(broken)
    return cases


@pytest.mark.parametrize("i", range(6))
def test_validate_rejects_incoherent_manifests_as_jax(i):
    broken = _breakages(render(PORT, CANARY))[i]
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError) as e:
            k8s(pkg).validate_manifests(copy.deepcopy(broken))
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_render_cli_writes_the_render(tmp_path, capsys):
    f = tmp_path / "dep.json"
    f.write_text(json.dumps(CANARY))
    out = tmp_path / "out.yaml"
    m(PORT, "controlplane.cli").main(["--store-dir", str(tmp_path / "store"), "render",
                                      "-f", str(f), "-o", str(out)])
    assert out.read_text() == k8s(PORT).to_yaml(render(PORT, CANARY))
    assert "wrote 12 objects" in capsys.readouterr().err
    m(PORT, "controlplane.cli").main(["--store-dir", str(tmp_path / "store"), "-n", "staging",
                                      "render", "-f", str(f)])
    docs = list(yaml.safe_load_all(capsys.readouterr().out))
    assert {d["metadata"]["namespace"] for d in docs} == {"prod"}
