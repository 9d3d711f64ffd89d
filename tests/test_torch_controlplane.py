"""The port's control plane (seldon_core_tpu_torch/controlplane/ and the
annotation parsers of graph/spec.py) held against the JAX package's on
the CPU.

Every flow runs through both packages on the same inputs and the
outcomes are compared; the port's own checks ride beside them. Mirrors
tests/test_controlplane.py: store generations and watch events, the
k8s-manifest form, the desired components of every deployment kind
(names, kinds, predictor specs, injected parameters and env equal once
module names are mapped), the annotation parsers, reconcile and rolling
update, placement (single-process preference, the recreate fallback,
partial-block release), the autoscaler's stabilisation, a bad component
start, the gateway's seeded picks, shadow fan-out and auth, a 2-layer
float32 GENERATE_SERVER deployment giving equal greedy tokens through
both gateways, disaggregated pools equal to the unified deployment, the
subprocess runtime launching the port's engine, and the CLI. Sharded
serving (``seldon.io/mesh``, ``tpuMesh``) reconciles onto a placed block
in both packages and serves the same tokens.
"""

import asyncio
import dataclasses
import importlib
import json
import re

import pytest

from _torch_engine import GEN_PARAMS, make_model_dir

JAX, PORT = "seldon_core_tpu", "seldon_core_tpu_torch"
PKGS = (JAX, PORT)


def m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def run(coro):
    return asyncio.run(coro)


def dep_of(pkg, d):
    return m(pkg, "controlplane.resource").SeldonDeployment.from_dict(json.loads(json.dumps(d)))


def simple(name="dep", traffic=None, replicas=1, impl="SIMPLE_MODEL"):
    return {"name": name, "predictors": [
        {"name": f"p{i}", "replicas": replicas, "traffic": w,
         "graph": {"name": "clf", "implementation": impl}}
        for i, w in enumerate(traffic or [100])]}


def controller(pkg, **kw):
    cp = m(pkg, "controlplane")
    rt = m(pkg, "controlplane.runtime")
    store = cp.ResourceStore()
    kw.setdefault("runtime", rt.InProcessRuntime(open_ports=False))
    return store, cp.DeploymentController(store, **kw)


def outcome(fn, *args, **kw):
    """``("ok", value)`` or ``("raise", type name, message)``."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the outcome is the datum
        return ("raise", type(e).__name__, str(e))


def mapped(obj):
    """JSON of ``obj`` with the JAX package's module names mapped to the
    port's: the one difference allowed between the two control planes."""
    return re.sub(r"\bseldon_core_tpu\.", "seldon_core_tpu_torch.",
                  json.dumps(obj, sort_keys=True, default=str))


# -- store and resource ------------------------------------------------------


def test_store_apply_generations(tmp_path):
    seen, files = {}, {}
    for pkg in PKGS:
        cp = m(pkg, "controlplane")
        d = tmp_path / pkg
        store = cp.ResourceStore(persist_dir=str(d))
        events = []
        for body in (simple(), simple(), simple(replicas=2)):
            dep, event = store.apply(dep_of(pkg, body))
            events.append((event, dep.generation))
        again = cp.ResourceStore(persist_dir=str(d)).get("dep")
        seen[pkg] = (events, again.generation, again.predictors[0].replicas)
        files[pkg] = {p.name: p.read_text() and json.loads(p.read_text())
                      for p in sorted(d.iterdir())}
    assert seen[PORT] == seen[JAX] == ([("ADDED", 1), ("UNCHANGED", 1), ("MODIFIED", 2)], 2, 2)
    assert files[PORT] == files[JAX]


def test_store_delete_and_watch():
    got = {}
    for pkg in PKGS:
        store = m(pkg, "controlplane").ResourceStore()

        async def go():
            q = store.watch()
            store.apply(dep_of(pkg, simple()))
            a = await q.get()
            store.delete("dep")
            b = await q.get()
            return [(a[0], a[1].name), (b[0], b[1].name)]

        got[pkg] = run(go())
    assert got[PORT] == got[JAX] == [("ADDED", "dep"), ("DELETED", "dep")]


def test_k8s_manifest_style():
    manifest = {
        "apiVersion": "machinelearning.seldon.io/v1alpha2", "kind": "SeldonDeployment",
        "metadata": {"name": "mymodel", "namespace": "prod", "annotations": {"a": "1"}},
        "spec": {"predictors": [{"name": "main", "graph": {
            "name": "clf", "implementation": "SIMPLE_MODEL"}}]},
    }
    out = {pkg: dep_of(pkg, manifest) for pkg in PKGS}
    assert out[PORT].key == out[JAX].key == "prod/mymodel"
    assert out[PORT].to_dict() == out[JAX].to_dict()
    assert out[PORT].spec_hash() == out[JAX].spec_hash()


def test_store_load_skips_bad_files(tmp_path):
    store = m(PORT, "controlplane").ResourceStore(persist_dir=str(tmp_path))
    store.apply(dep_of(PORT, simple()))
    (tmp_path / "torn.json").write_text('{"name": "x", "predi')
    (tmp_path / "schema_drift.json").write_text('{"name": "y", "predictors": []}')
    again = m(PORT, "controlplane").ResourceStore(persist_dir=str(tmp_path))
    assert [d.name for d in again.list()] == ["dep"]


# -- desired components ------------------------------------------------------


def _gen(model_uri="/models/llm", params=None):
    return {"name": "llm", "implementation": "GENERATE_SERVER", "modelUri": model_uri,
            **({"parameters": params} if params else {})}


DEPLOYMENTS = {
    "simple": simple(replicas=2),
    "separate-engine": {
        "name": "sep", "annotations": {"seldon.io/engine-separate-pod": "true"},
        "predictors": [{"name": "p0", "graph": {
            "name": "m", "implementation": "SKLEARN_SERVER", "modelUri": "/models/sk",
            "endpoint": {"transport": "REST"}}}]},
    "no-engine": {
        "name": "ne", "annotations": {"seldon.io/no-engine": "true"},
        "predictors": [{"name": "p0", "replicas": 2, "graph": {
            "name": "m", "implementation": "SKLEARN_SERVER", "modelUri": "/models/sk",
            "parameters": [{"name": "method", "value": "predict", "type": "STRING"}]}}]},
    "disagg": {
        "name": "dis", "predictors": [{"name": "p0", "graph": _gen(params=[
            {"name": "slots", "value": "2", "type": "INT"}]), "annotations": {
            "seldon.io/disagg": "true", "seldon.io/disagg-prefill-replicas": "2",
            "seldon.io/disagg-decode-replicas": "3", "seldon.io/kv-tier-bytes": "4096"}}]},
    "kv-tier": {
        "name": "kv", "predictors": [{"name": "p0", "replicas": 2, "graph": _gen(),
                                      "annotations": {"seldon.io/kv-tier-bytes": "1048576"}}]},
    "tenants": {
        "name": "ten", "predictors": [{"name": "p0", "graph": _gen(), "annotations": {
            "seldon.io/tenants": "acme=strict,globex=best_effort@/models/b"}}]},
    "explainer": {
        "name": "ex", "predictors": [{"name": "p0", "graph": _gen(), "annotations": {
            "seldon.io/explainer-type": "integrated_gradients",
            "seldon.io/explainer-model-uri": "/models/rn"}}]},
    "planner": {
        "name": "pl", "predictors": [{"name": "p0", "graph": _gen(), "annotations": {
            "seldon.io/planner": "true", "seldon.io/planner-profile": "/profiles/a.spf1"}}]},
    "shadow": {
        "name": "sh", "predictors": [
            {"name": "base", "traffic": 100, "graph": _gen()},
            {"name": "cand", "graph": _gen(), "annotations": {
                "seldon.io/shadow": "true", "seldon.io/rollout": "shadow",
                "seldon.io/rollout-steps": "2"}}]},
}


def _desired(pkg, body, monkeypatch):
    rt = m(pkg, "controlplane.runtime")
    ports = iter(range(20000, 20100))
    monkeypatch.setattr(rt, "free_port", lambda: next(ports))
    _store, ctl = controller(pkg)
    specs = run(ctl.desired_components(dep_of(pkg, body)))
    rows = []
    for s in specs:
        row = dataclasses.asdict(s)
        row.pop("mesh")
        rows.append(row)
    return rows


@pytest.mark.parametrize("kind", sorted(DEPLOYMENTS))
def test_desired_components_equal(kind, monkeypatch):
    jax_rows = _desired(JAX, DEPLOYMENTS[kind], monkeypatch)
    port_rows = _desired(PORT, DEPLOYMENTS[kind], monkeypatch)
    assert mapped(port_rows) == mapped(jax_rows)
    assert port_rows and "seldon_core_tpu." not in json.dumps(port_rows)
    injected = {p["name"]: p["value"]
                for r in port_rows if r["engine_spec"]
                for p in r["engine_spec"]["graph"].get("parameters", [])}
    if kind == "disagg":
        roles = sorted(p["value"] for r in port_rows
                       for p in r["engine_spec"]["graph"]["parameters"] if p["name"] == "role")
        assert roles == ["decode"] * 3 + ["prefill"] * 2
        assert injected["peer"] == "127.0.0.1:20000,127.0.0.1:20001"
        assert injected["host_kv_tier_bytes"] == "4096"
        assert [r["routable"] for r in port_rows] == [False, False, True, True, True]
    if kind == "kv-tier":
        assert injected["host_kv_tier_bytes"] == "1048576"
        assert all("seldon.io/kv-tier-bytes" not in r["engine_spec"]["annotations"]
                   for r in port_rows)
    if kind == "tenants":
        assert injected["tenants"] == "acme=strict,globex=best_effort@/models/b"
    if kind == "explainer":
        ex = [r for r in port_rows if r["kind"] == "explainer"]
        assert ex[0]["interface_name"] == \
            "seldon_core_tpu_torch.components.explainer.Explainer"
    if kind in ("separate-engine", "no-engine"):
        svc = [r for r in port_rows if r["kind"] == "microservice"]
        assert svc[0]["interface_name"] == \
            "seldon_core_tpu_torch.servers.sklearnserver.SKLearnServer"


# -- the annotation parsers --------------------------------------------------


def _pspec(pkg, annotations, graph=None, replicas=1, tpu_mesh=None):
    spec = m(pkg, "graph.spec")
    d = {"name": "p", "replicas": replicas, "graph": graph or _gen(),
         "annotations": annotations}
    if tpu_mesh:
        d["tpuMesh"] = tpu_mesh
    return spec.PredictorSpec.from_dict(json.loads(json.dumps(d)))


SIMPLE_GRAPH = {"name": "m", "implementation": "SIMPLE_MODEL"}
ROLE_GRAPH = _gen(params=[{"name": "role", "value": "decode", "type": "STRING"}])
TIER_GRAPH = _gen(params=[{"name": "host_kv_tier_bytes", "value": "1", "type": "STRING"}])
TENANT_GRAPH = _gen(params=[{"name": "tenants", "value": "a=strict", "type": "STRING"}])
TWO_NODE = {"name": "r", "implementation": "RAG_PROMPT_BUILDER", "children": [_gen()]}

PARSER_CASES = [
    ("parse_disagg_annotations", {}, None),
    ("parse_disagg_annotations", {"seldon.io/disagg": "false"}, None),
    ("parse_disagg_annotations", {"seldon.io/disagg": "true"}, None),
    ("parse_disagg_annotations", {"seldon.io/disagg": "TRUE",
                                  "seldon.io/disagg-prefill-replicas": "3"}, None),
    ("parse_disagg_annotations", {"seldon.io/disagg": "true",
                                  "seldon.io/disagg-decode-replicas": "x"}, None),
    ("parse_disagg_annotations", {"seldon.io/disagg": "true",
                                  "seldon.io/disagg-prefill-replicas": "0"}, None),
    ("parse_disagg_annotations", {"seldon.io/disagg": "true"}, SIMPLE_GRAPH),
    ("parse_disagg_annotations", {"seldon.io/disagg": "true"}, TWO_NODE),
    ("parse_disagg_annotations", {"seldon.io/disagg": "true"}, ROLE_GRAPH),
    ("parse_kv_tier_annotation", {}, None),
    ("parse_kv_tier_annotation", {"seldon.io/kv-tier-bytes": "0"}, None),
    ("parse_kv_tier_annotation", {"seldon.io/kv-tier-bytes": " 4096 "}, None),
    ("parse_kv_tier_annotation", {"seldon.io/kv-tier-bytes": "-1"}, None),
    ("parse_kv_tier_annotation", {"seldon.io/kv-tier-bytes": "1e6"}, None),
    ("parse_kv_tier_annotation", {"seldon.io/kv-tier-bytes": "4096"}, SIMPLE_GRAPH),
    ("parse_kv_tier_annotation", {"seldon.io/kv-tier-bytes": "4096"}, TIER_GRAPH),
    ("parse_tenants_annotation", {}, None),
    ("parse_tenants_annotation", {"seldon.io/tenants": "a=strict,b=best_effort@/m"}, None),
    ("parse_tenants_annotation", {"seldon.io/tenants": "a=platinum"}, None),
    ("parse_tenants_annotation", {"seldon.io/tenants": "a=strict,a=gold"}, None),
    ("parse_tenants_annotation", {"seldon.io/tenants": ""}, None),
    ("parse_tenants_annotation", {"seldon.io/tenants": "a=strict"}, SIMPLE_GRAPH),
    ("parse_tenants_annotation", {"seldon.io/tenants": "a=strict"}, TENANT_GRAPH),
    ("parse_planner_annotations", {}, None),
    ("parse_planner_annotations", {"seldon.io/planner": "true"}, None),
    ("parse_planner_annotations", {"seldon.io/planner": "False"}, None),
    ("parse_planner_annotations", {"seldon.io/planner": "yes"}, None),
    ("parse_planner_annotations", {"seldon.io/planner": "true",
                                   "seldon.io/planner-profile": " /p.spf1 "}, None),
    ("parse_planner_annotations", {"seldon.io/planner-profile": "/p.spf1"}, None),
    ("parse_planner_annotations", {"seldon.io/planner": "false",
                                   "seldon.io/planner-profile": "/p.spf1"}, None),
    ("parse_planner_annotations", {"seldon.io/planner": "true"}, SIMPLE_GRAPH),
    ("parse_mesh_annotation", {}, None),
    ("parse_mesh_annotation", {"seldon.io/mesh": "data=2,model=4"}, None),
    ("parse_mesh_annotation", {"seldon.io/mesh": "model=0"}, None),
    ("parse_mesh_annotation", {"seldon.io/mesh": "tensor=2"}, None),
    ("parse_mesh_annotation", {"seldon.io/mesh": "model=2,model=2"}, None),
    ("parse_mesh_annotation", {"seldon.io/mesh": "model=2"}, SIMPLE_GRAPH),
    ("parse_fuse_annotation", {"seldon.io/fuse": "TRUE"}, None),
    ("parse_fuse_annotation", {"seldon.io/fuse": "on"}, None),
]


@pytest.mark.parametrize("fn,ann,graph", PARSER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(PARSER_CASES)])
def test_annotation_parsers_agree(fn, ann, graph):
    got = {pkg: outcome(getattr(m(pkg, "graph.spec"), fn), _pspec(pkg, ann, graph))
           for pkg in PKGS}
    assert got[PORT] == got[JAX]
    # and the mesh annotation alone keeps the tpuMesh conflict refusal
    if fn == "parse_mesh_annotation" and ann and graph is None and got[PORT][0] == "ok":
        both = {pkg: outcome(getattr(m(pkg, "graph.spec"), fn),
                             _pspec(pkg, ann, tpu_mesh={"model": 2})) for pkg in PKGS}
        assert both[PORT] == both[JAX] and both[PORT][0] == "raise"


def test_injectors_agree():
    for fn, arg in (("inject_kv_tier_param", 4096), ("inject_tenants_param", "a=strict")):
        got = {}
        for pkg in PKGS:
            d = {"name": "p", "graph": TWO_NODE}
            got[pkg] = getattr(m(pkg, "graph.spec"), fn)(json.loads(json.dumps(d)), arg)
        assert got[PORT] == got[JAX]
        assert got[PORT]["graph"]["children"][0]["parameters"][-1]["value"] == str(arg)
    for name in ("ANNOTATION_DISAGG", "ANNOTATION_DISAGG_PREFILL_REPLICAS",
                 "ANNOTATION_DISAGG_DECODE_REPLICAS", "ANNOTATION_KV_TIER_BYTES",
                 "ANNOTATION_MESH", "ANNOTATION_TENANTS", "ANNOTATION_PLANNER",
                 "ANNOTATION_PLANNER_PROFILE", "ANNOTATION_FUSE"):
        assert getattr(m(PORT, "graph.spec"), name) == getattr(m(JAX, "graph.spec"), name)


VALIDATE_CASES = {
    "one": [(None, 0, {})],
    "canary": [(None, 90, {}), (None, 10, {})],
    "bad-sum": [(None, 50, {}), (None, 40, {})],
    "single-50": [(None, 50, {})],
    "dup-names": [(None, 50, {}), (None, 50, {})],
    "shadow-weighted": [(None, 100, {}), (None, 10, {"seldon.io/shadow": "true"})],
    "shadow": [(None, 100, {}), (None, 0, {"seldon.io/shadow": "true"})],
    "rollout-bad-steps": [(None, 100, {}), (None, 0, {"seldon.io/rollout": "canary",
                                                       "seldon.io/rollout-steps": "5,x"})],
    "rollout-canary": [(None, 90, {}), (None, 10, {"seldon.io/rollout": "canary"})],
    "disagg": [(None, 0, {"seldon.io/disagg": "true"})],
    "disagg-simple": [(SIMPLE_GRAPH, 0, {"seldon.io/disagg": "true"})],
    "kv-tier": [(None, 0, {"seldon.io/kv-tier-bytes": "1024"})],
    "tenants": [(None, 0, {"seldon.io/tenants": "a=strict"})],
    "tenants-bad": [(None, 0, {"seldon.io/tenants": "a=nope"})],
    "planner": [(None, 0, {"seldon.io/planner": "true"})],
    "planner-bad": [(None, 0, {"seldon.io/planner": "maybe"})],
    "hpa-bad": [(None, 0, {})],
}


@pytest.mark.parametrize("case", sorted(VALIDATE_CASES))
def test_validate_deployment_agrees(case):
    got = {}
    for pkg in PKGS:
        spec = m(pkg, "graph.spec")
        preds = []
        for i, (graph, traffic, ann) in enumerate(VALIDATE_CASES[case]):
            name = "p" if case == "dup-names" else f"p{i}"
            p = spec.PredictorSpec.from_dict(json.loads(json.dumps({
                "name": name, "traffic": traffic, "graph": graph or _gen(),
                "annotations": ann})))
            if case == "hpa-bad":
                p.hpa_spec = {"minReplicas": 3, "maxReplicas": 1, "targetConcurrency": 1}
            preds.append(p)
        got[pkg] = outcome(spec.validate_deployment, preds)
    assert got[PORT] == got[JAX]


@pytest.mark.parametrize("ann,tpu_mesh", [
    ({"seldon.io/mesh": "data=1,model=2"}, None),
    ({"seldon.io/mesh": "junk"}, None),
    ({}, {"model": 2}),
])
def test_mesh_still_refused(ann, tpu_mesh, llm_dir):
    """Sharded serving is ported. The annotation validates as the JAX
    package validates it (a junk shape fails the apply in both, word for
    word); a legal annotation or a predictor tpuMesh reconciles Available
    in both packages over a placed block of 2 of 8 devices (the port's are
    CPU positions), each member's generate server on a mesh of the
    block, the same greedy tokens through both gateways; the block is
    released on delete. The placement's ``mesh_for`` builds the mesh of
    the JAX placement's shape."""
    import jax
    import torch

    graph = _gen(llm_dir, params=GEN_PARAMS)
    body = {"name": "sh", "predictors": [{"name": "p0", "graph": graph, "annotations": ann,
                                          **({"tpuMesh": tpu_mesh} if tpu_mesh else {})}]}
    verdicts = {pkg: outcome(m(pkg, "graph.spec").validate_predictor, _pspec(pkg, ann, graph))
                for pkg in PKGS}
    assert verdicts[PORT] == verdicts[JAX]
    devices = {JAX: jax.devices(), PORT: [torch.device("cpu") for _ in range(8)]}
    got = {}
    for pkg in PKGS:
        cp = m(pkg, "controlplane")
        placement = (cp.TpuPlacement if pkg == JAX else cp.DevicePlacement)(devices=devices[pkg])
        gw = cp.Gateway(seed=0)
        store, ctl = controller(pkg, gateway=gw, placement=placement)
        dep, _ = store.apply(dep_of(pkg, body))
        status = run(ctl.reconcile(dep.clone()))
        if verdicts[PORT][0] == "raise":
            got[pkg] = (status.state, "malformed" in status.description)
            assert ctl.components == {} and placement.capacity()["used"] == 0
            continue
        assert status.state == "Available", (pkg, status.description)
        try:
            assert placement.capacity()["used"] == 2
            (app,) = [h.app for h, _ in ctl.components.values() if h.spec.kind == "engine"]
            server = app.executor.root.client.user_object
            assert dict(server.batcher.mesh.shape) == (tpu_mesh or {"data": 1, "model": 2})
            got[pkg] = [_predict_through(pkg, gw, "default/sh", p) for p in PROMPTS]
            run(ctl.delete(dep))
            assert placement.capacity()["used"] == 0
        finally:
            run(ctl.shutdown())
    assert got[PORT] == got[JAX]
    if verdicts[PORT][0] == "raise":
        assert got[PORT] == ("Failed", True)
    pl = m(PORT, "controlplane").DevicePlacement(devices=[torch.device("cpu") for _ in range(2)])
    want = m(JAX, "controlplane").TpuPlacement(devices=jax.devices()[:2]).mesh_for(
        "k", {"model": 2})
    mesh = pl.mesh_for("k", {"model": 2})
    assert mesh.shape == dict(want.shape) and mesh.size == want.devices.size == 2


# -- reconcile flows ---------------------------------------------------------


def _names(ctl):
    return sorted(ctl.components)


def test_reconcile_available_and_delete():
    got = {}
    for pkg in PKGS:
        store, ctl = controller(pkg)

        async def go():
            dep, _ = store.apply(dep_of(pkg, simple()))
            status = await ctl.reconcile(dep.clone())
            out = (status.state, status.predictor_status[0].replicas_available, _names(ctl))
            await ctl.delete(dep)
            return out + (ctl.components,)

        got[pkg] = run(go())
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == "Available" and got[PORT][3] == {}


def test_reconcile_bad_graph_fails():
    got = {}
    for pkg in PKGS:
        _store, ctl = controller(pkg)
        status = run(ctl.reconcile(dep_of(pkg, simple(traffic=[50, 40]))))
        got[pkg] = (status.state, status.description)
    assert got[PORT] == got[JAX] and got[PORT][0] == "Failed"


def test_reconcile_replicas_and_rolling_update():
    got = {}
    for pkg in PKGS:
        store, ctl = controller(pkg)

        async def go():
            dep, _ = store.apply(dep_of(pkg, simple(replicas=2)))
            s1 = await ctl.reconcile(dep.clone())
            first = _names(ctl)
            handles = {n: h for n, (h, _) in ctl.components.items()}
            changed, _ = store.apply(dep_of(pkg, simple(replicas=3)))
            s2 = await ctl.reconcile(changed.clone())
            kept = all(ctl.components[n][0] is h for n, h in handles.items())
            # a spec change other than the replica count renames every
            # component: create-before-delete replaces the generation
            relabel = dep_of(pkg, simple(replicas=3))
            relabel.predictors[0].labels["v"] = "2"
            applied, _ = store.apply(relabel)
            s3 = await ctl.reconcile(applied.clone())
            third = _names(ctl)
            await ctl.shutdown()
            return (s1.predictor_status[0].replicas_available, first,
                    s2.predictor_status[0].replicas_available, kept,
                    s3.state, third, set(first).isdisjoint(third))

        got[pkg] = run(go())
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == 2 and got[PORT][2] == 3 and got[PORT][3] and got[PORT][6]


def test_annotation_flip_replaces_components():
    got = {}
    for pkg in PKGS:
        store, ctl = controller(pkg)

        async def go():
            dep, _ = store.apply(dep_of(pkg, simple()))
            await ctl.reconcile(dep.clone())
            before = _names(ctl)
            flipped = dep_of(pkg, simple())
            flipped.annotations["seldon.io/some-flag"] = "true"
            applied, event = store.apply(flipped)
            await ctl.reconcile(applied.clone())
            return before, event, _names(ctl)

        got[pkg] = run(go())
    assert got[PORT] == got[JAX]
    assert got[PORT][1] == "MODIFIED" and got[PORT][0] != got[PORT][2]


def test_controller_watch_loop_end_to_end():
    got = {}
    for pkg in PKGS:
        gw = m(pkg, "controlplane").Gateway(seed=7)
        store, ctl = controller(pkg, gateway=gw)

        async def go():
            stop = asyncio.Event()
            task = asyncio.create_task(ctl.run(stop))
            store.apply(dep_of(pkg, simple()))
            for _ in range(200):
                if store.get("dep").status.state == "Available":
                    break
                await asyncio.sleep(0.02)
            state, table = store.get("dep").status.state, gw.route_table()
            store.delete("dep")
            for _ in range(200):
                if not ctl.components:
                    break
                await asyncio.sleep(0.02)
            stop.set()
            await task
            return state, table, ctl.components

        got[pkg] = run(go())
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == "Available" and "default/dep" in got[PORT][1]


def test_reconcile_bad_component_start_does_not_kill_controller():
    body = {"name": "bad", "predictors": [{"name": "p0", "graph": {
        "name": "m", "implementation": "SKLEARN_SERVER", "modelUri": "xyz://nope"}}]}
    got = {}
    for pkg in PKGS:
        store, ctl = controller(pkg)

        async def go():
            bad = await ctl.reconcile(dep_of(pkg, body))
            good, _ = store.apply(dep_of(pkg, simple()))
            ok = await ctl.reconcile(good.clone())
            return bad.state, "xyz" in bad.description, ok.state

        got[pkg] = run(go())
    assert got[PORT] == got[JAX] == ("Failed", True, "Available")


def test_no_engine_mode_refuses_multi_node_graph():
    body = {"name": "ne2", "annotations": {"seldon.io/no-engine": "true"}, "predictors": [
        {"name": "p0", "graph": {"name": "r", "implementation": "SIMPLE_ROUTER",
                                 "children": [{"name": "a", "implementation": "SIMPLE_MODEL"}]}}]}
    got = {}
    for pkg in PKGS:
        _store, ctl = controller(pkg)
        status = run(ctl.reconcile(dep_of(pkg, body)))
        got[pkg] = (status.state, status.description)
    assert got[PORT] == got[JAX] and "single-node" in got[PORT][1]


# -- placement ---------------------------------------------------------------


class FakeDevice:
    def __init__(self, id, process_index):
        self.id = id
        self.process_index = process_index

    def __repr__(self):
        return f"dev{self.id}@p{self.process_index}"


def _placement(pkg, devs):
    cp = m(pkg, "controlplane")
    cls = cp.DevicePlacement if pkg == PORT else cp.TpuPlacement
    return cls(devices=devs)


def test_placement_prefers_single_process():
    got = {}
    for pkg in PKGS:
        devs = [FakeDevice(i, i // 4) for i in range(8)]  # 2 processes x 4 devices
        pl = _placement(pkg, devs)
        a = pl.allocate("a", {"data": 2, "model": 2})
        b = pl.allocate("b", {"model": 4})
        full = outcome(pl.allocate, "c", {"model": 1})[0]
        pl.release("a")
        c = pl.allocate("c", None)
        got[pkg] = ([d.id for d in a], [d.id for d in b], full, [d.id for d in c],
                    pl.capacity())
    assert got[PORT] == got[JAX]
    assert got[PORT][2] == "raise" and got[PORT][4] == {"total": 8, "free": 3, "used": 5}


def test_placement_counts_cuda_devices(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    pl = m(PORT, "controlplane").DevicePlacement()
    assert pl.devices == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert pl.allocate("a", None) == [torch.device("cuda", 0)]
    assert pl.capacity() == {"total": 2, "free": 1, "used": 1}


def test_placement_rolling_update_falls_back_to_recreate():
    """One device, one replica: create-before-delete cannot fit two
    generations, so the reconciler recreates instead of failing."""
    got = {}
    for pkg in PKGS:
        pl = _placement(pkg, [FakeDevice(0, 0)])
        store, ctl = controller(pkg, placement=pl)

        async def go():
            dep, _ = store.apply(dep_of(pkg, simple()))
            s1 = await ctl.reconcile(dep.clone())
            first = _names(ctl)
            changed = dep_of(pkg, simple())
            changed.predictors[0].labels["v"] = "2"
            applied, _ = store.apply(changed)
            s2 = await ctl.reconcile(applied.clone())
            return s1.state, s2.state, first != _names(ctl), pl.capacity()["used"]

        got[pkg] = run(go())
    assert got[PORT] == got[JAX] == ("Available", "Available", True, 1)


def test_placement_failed_allocation_releases_partial_blocks():
    got = {}
    for pkg in PKGS:
        pl = _placement(pkg, [FakeDevice(0, 0)])
        _store, ctl = controller(pkg, placement=pl)
        status = run(ctl.reconcile(dep_of(pkg, simple(replicas=2))))
        got[pkg] = (status.state, status.description, pl.capacity()["used"], ctl.components)
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == "Failed" and "devices" in got[PORT][1] and got[PORT][2] == 0


# -- autoscaler --------------------------------------------------------------


def hpa(lo=1, hi=4, target=4.0, replicas=1):
    body = simple(name="hdep", replicas=replicas)
    body["predictors"][0]["hpaSpec"] = {"minReplicas": lo, "maxReplicas": hi,
                                        "targetConcurrency": target}
    return body


def _engines(ctl):
    return [h for h, _ in ctl.components.values() if h.spec.kind == "engine"]


def test_autoscale_up_down_with_stabilization():
    got = {}
    for pkg in PKGS:
        store, ctl = controller(pkg)

        async def go():
            trail = []
            dep, _ = store.apply(dep_of(pkg, hpa()))
            await ctl.reconcile(dep.clone())
            _engines(ctl)[0].app.inflight = 9
            trail.append(await ctl.autoscale_once())
            await ctl.reconcile(store.get("hdep").clone())
            trail.append(len(_engines(ctl)))
            for e in _engines(ctl):
                e.app.inflight = 0
            for _ in range(3):
                trail.append(await ctl.autoscale_once())
            await ctl.reconcile(store.get("hdep").clone())
            trail.append(len(_engines(ctl)))
            _engines(ctl)[0].app.inflight = 40
            trail.append(await ctl.autoscale_once())
            _engines(ctl)[0].app.inflight = 0  # nothing to drain at shutdown
            await ctl.shutdown()
            return trail

        got[pkg] = run(go())
    assert got[PORT] == got[JAX] == [
        {"default/hdep/p0": 3}, 3, {}, {}, {"default/hdep/p0": 1}, 1, {"default/hdep/p0": 4}]


def test_autoscale_scale_event_keeps_existing_replicas():
    store, ctl = controller(PORT)

    async def go():
        dep, _ = store.apply(dep_of(PORT, hpa()))
        await ctl.reconcile(dep.clone())
        before = {n: h for n, (h, _) in ctl.components.items()}
        _engines(ctl)[0].app.inflight = 9
        await ctl.autoscale_once()
        await ctl.reconcile(store.get("hdep").clone())
        after = dict(ctl.components)
        for e in _engines(ctl):
            e.app.inflight = 0
        await ctl.shutdown()
        return before, after

    before, after = run(go())
    assert len(after) == 3
    for name, handle in before.items():
        assert after[name][0] is handle


def test_hpa_spec_validation():
    cases = [dict(lo=0), dict(lo=3, hi=1), dict(target=0), {}]
    for kw in cases:
        got = {pkg: outcome(m(pkg, "graph.spec").validate_deployment,
                            dep_of(pkg, hpa(**kw)).predictors) for pkg in PKGS}
        assert got[PORT] == got[JAX]


# -- gateway -----------------------------------------------------------------


def _gateway_deployment(pkg, body, seed):
    cp = m(pkg, "controlplane")
    gw = cp.Gateway(seed=seed)
    store, ctl = controller(pkg, gateway=gw)
    dep, _ = store.apply(dep_of(pkg, body))
    run(ctl.reconcile(dep.clone()))
    return gw, ctl


def test_gateway_weighted_canary_and_header_override():
    picks = {}
    for pkg in PKGS:
        gw, _ctl = _gateway_deployment(pkg, simple(traffic=[90, 10]), seed=42)
        seq = []
        for _ in range(400):
            h, shadows = gw.select("default/dep")
            assert shadows == []
            seq.append((h.spec.predictor, h.spec.name))
        pinned = gw.select("default/dep", header_predictor="p1")[0].spec.predictor
        missing = gw.select("default/dep", header_predictor="nope")
        picks[pkg] = (seq, pinned, missing)
    assert picks[PORT] == picks[JAX]
    counts = [p for p, _ in picks[PORT][0]]
    assert counts.count("p0") > 300 and counts.count("p1") > 10
    assert picks[PORT][1] == "p1" and picks[PORT][2] == (None, [])


def test_gateway_shadow_fan_out():
    body = simple(traffic=[100, 0], replicas=2)
    body["predictors"][1]["annotations"] = {"seldon.io/shadow": "true"}
    got = {}
    for pkg in PKGS:
        gw, _ctl = _gateway_deployment(pkg, body, seed=0)
        seq = []
        for _ in range(20):
            h, shadows = gw.select("default/dep")
            seq.append((h.spec.name, [s.spec.name for s in shadows]))
        got[pkg] = (seq, gw.route_table())
    assert got[PORT] == got[JAX]
    assert all(len(s) == 1 for _h, s in got[PORT][0])


def _http(pkg, app, method, path, body=b"", headers=None):
    Request = m(pkg, "http_server").Request
    resp = run(app._dispatch(Request(method, path, "", headers or {}, body)))
    return resp.status, (json.loads(resp.body) if resp.body else None)


def test_gateway_http_front_serves_predictions():
    from urllib.parse import quote

    got = {}
    body = json.dumps({"data": {"ndarray": [[1.0, 2.0]]}}).encode()
    form = f"json={quote(json.dumps({'data': {'ndarray': [[1.0]]}}))}".encode()
    for pkg in PKGS:
        gw, _ctl = _gateway_deployment(pkg, simple(), seed=1)
        app = gw.app()
        ok = _http(pkg, app, "POST", "/seldon/default/dep/api/v0.1/predictions", body,
                   {"content-type": "application/json"})
        formed = _http(pkg, app, "POST", "/seldon/default/dep/api/v0.1/predictions", form,
                       {"content-type": "application/x-www-form-urlencoded"})
        nope = _http(pkg, app, "POST", "/seldon/default/nope/api/v0.1/predictions", body,
                     {"content-type": "application/json"})
        unknown = _http(pkg, app, "GET", "/seldon/default/dep/api/v0.1/doesnotexist")
        routes = _http(pkg, app, "GET", "/routes")
        got[pkg] = (ok[0], ok[1]["data"], formed[0], formed[1]["data"], nope[0],
                    unknown[0], routes)
    assert got[PORT] == got[JAX]
    assert got[PORT][:1] == (200,) and got[PORT][4] == 503 and got[PORT][5] == 404


def test_gateway_bearer_token_auth():
    import base64

    got = {}
    body = json.dumps({"data": {"ndarray": [[1.0]]}}).encode()
    for pkg in PKGS:
        cp = m(pkg, "controlplane")
        gw = cp.Gateway(seed=3, oauth={"key": "secret"})
        store, ctl = controller(pkg, gateway=gw)
        dep, _ = store.apply(dep_of(pkg, simple()))
        run(ctl.reconcile(dep.clone()))
        app = gw.app()
        path = "/seldon/default/dep/api/v0.1/predictions"
        closed = _http(pkg, app, "POST", path, body, {"content-type": "application/json"})[0]
        bad = _http(pkg, app, "POST", "/oauth/token", b"", {
            "authorization": "Basic " + base64.b64encode(b"key:wrong").decode()})[0]
        status, tok = _http(pkg, app, "POST", "/oauth/token", b"", {
            "authorization": "Basic " + base64.b64encode(b"key:secret").decode()})
        opened = _http(pkg, app, "POST", path, body, {
            "content-type": "application/json",
            "authorization": f"Bearer {tok['access_token']}"})[0]
        got[pkg] = (closed, bad, status, tok["token_type"], opened)
    assert got[PORT] == got[JAX] == (401, 401, 200, "bearer", 200)


# -- generate deployments ----------------------------------------------------


@pytest.fixture(scope="module")
def llm_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("llm"))


PROMPTS = [[5, 17, 42], [3, 1, 4, 1, 5, 9, 2, 6], [7, 7, 7, 7, 7]]


def _predict_through(pkg, gw, key, prompt, n=6):
    app = gw.app()
    body = json.dumps({"jsonData": {"prompt_tokens": prompt, "max_new_tokens": n}}).encode()
    status, out = _http(pkg, app, "POST", f"/seldon/{key}/api/v0.1/predictions", body,
                        {"content-type": "application/json"})
    assert status == 200, out
    return out["jsonData"]["tokens"][0]


def _gen_deployment(name, model_dir, annotations=None, replicas=1, params=GEN_PARAMS):
    return {"name": name, "predictors": [{
        "name": "p0", "replicas": replicas, "annotations": annotations or {},
        "graph": {"name": "llm", "implementation": "GENERATE_SERVER", "modelUri": model_dir,
                  "parameters": params}}]}


def test_generate_deployment_tokens_equal_jax(llm_dir):
    """A 2-layer f32 GENERATE_SERVER deployment reconciled in process by
    each package's controller: the same prompts through each gateway give
    the same greedy tokens."""
    got = {}
    for pkg in PKGS:
        gw = m(pkg, "controlplane").Gateway(seed=0)
        store, ctl = controller(pkg, gateway=gw)
        dep, _ = store.apply(dep_of(pkg, _gen_deployment("gen", llm_dir)))
        status = run(ctl.reconcile(dep.clone()))
        assert status.state == "Available", status.description
        try:
            got[pkg] = [_predict_through(pkg, gw, "default/gen", p) for p in PROMPTS]
        finally:
            run(ctl.shutdown())
    assert got[PORT] == got[JAX]
    assert all(len(t) == len(p) + 6 for t, p in zip(got[PORT], PROMPTS))


def test_disagg_deployment_equals_unified(llm_dir):
    """``seldon.io/disagg`` with one prefill and one decode member, in
    process on loopback ports (the decode member's peer is the prefill
    member's KV port): the same greedy tokens as the unified deployment,
    and the gateway routes to the decode pool only."""
    gw = m(PORT, "controlplane").Gateway(seed=0)
    store, ctl = controller(
        PORT, gateway=gw, runtime=m(PORT, "controlplane.runtime").InProcessRuntime())
    try:
        uni, _ = store.apply(dep_of(PORT, _gen_deployment("uni", llm_dir)))
        dis, _ = store.apply(dep_of(PORT, _gen_deployment("dis", llm_dir, {
            "seldon.io/disagg": "true", "seldon.io/kv-tier-bytes": "1048576"})))
        for d in (uni, dis):
            status = run(ctl.reconcile(d.clone()))
            assert status.state == "Available", status.description
        assert gw.route_table()["default/dis"] == [("p0", 0, 1, False)]
        want = [_predict_through(PORT, gw, "default/uni", p) for p in PROMPTS]
        assert [_predict_through(PORT, gw, "default/dis", p) for p in PROMPTS] == want
        roles = {}
        for h, _ in ctl.components.values():
            if h.spec.deployment == "default/dis":
                params = {p["name"]: p["value"] for p in h.spec.engine_spec["graph"]["parameters"]}
                roles[params["role"]] = params
        assert set(roles) == {"prefill", "decode"}
        assert roles["decode"]["peer"] == f"127.0.0.1:{roles['prefill']['kv_port']}"
        assert roles["prefill"]["host_kv_tier_bytes"] == "1048576"
        dec = next(h for h, _ in ctl.components.values()
                   if h.spec.deployment == "default/dis" and h.spec.routable)
        unit = next(u for _n, u in dec.app.units_with("batcher"))
        assert unit.batcher.stats["kv_imports"] >= len(PROMPTS)
    finally:
        run(ctl.shutdown())


def test_tenants_and_planner_deployments_serve(llm_dir, tmp_path):
    """The tenants roster and the planner annotation reach the port's
    engine through the reconciler: the members serve, the roster is the
    annotation's, and a planner tick runs over the fleet scrape."""
    import shutil

    other = tmp_path / "b"
    shutil.copytree(llm_dir, other)
    gw = m(PORT, "controlplane").Gateway(seed=0)
    store, ctl = controller(PORT, gateway=gw)
    try:
        ten, _ = store.apply(dep_of(PORT, _gen_deployment(
            "ten", llm_dir, {"seldon.io/tenants": f"acme=strict,globex=best_effort@{other}"},
            params=GEN_PARAMS + [{"name": "weight_pager_host_bytes", "value": str(64 << 20),
                                  "type": "INT"}])))
        pl, _ = store.apply(dep_of(PORT, _gen_deployment(
            "pl", llm_dir, {"seldon.io/planner": "true"})))
        for d in (ten, pl):
            status = run(ctl.reconcile(d.clone()))
            assert status.state == "Available", status.description
        want = _predict_through(PORT, gw, "default/pl", PROMPTS[0])
        assert _predict_through(PORT, gw, "default/ten", PROMPTS[0]) == want
        h = next(h for h, _ in ctl.components.values() if h.spec.deployment == "default/ten")
        server = next(u for _n, u in h.app.units_with("tenant_scheduler"))
        assert sorted(server.tenant_pager.tenants()) == ["acme", "globex"]
        members = run(ctl.fleet_scrape_once())
        assert len(members) == 2
        events = run(ctl.planner_tick_once())
        assert list(events) == ["default/pl/p0"] and ctl.planner_stats["ticks"] == 1
    finally:
        run(ctl.shutdown())


# -- the subprocess runtime and the CLI --------------------------------------


def test_subprocess_runtime_launches_the_port():
    """A SubprocessRuntime member is the port's engine_main in a child
    process: it serves, reports load(), answers the /drain probe of a
    scale-down with 501 (no generate unit), and is terminated on delete."""
    import urllib.request

    cp = m(PORT, "controlplane")
    rt = m(PORT, "controlplane.runtime")

    async def go():
        store = cp.ResourceStore()
        ctl = cp.DeploymentController(store, runtime=rt.SubprocessRuntime(),
                                      ready_timeout_s=120.0)
        dep, _ = store.apply(dep_of(PORT, simple(name="subp", replicas=2)))
        status = await ctl.reconcile(dep.clone())
        assert status.state == "Available", status.description
        engines = sorted(_engines(ctl), key=lambda h: h.spec.replica)
        assert len(engines) == 2
        for h in engines:
            assert h.proc.poll() is None
            assert h.proc.args[1:3] == ["-m", "seldon_core_tpu_torch.engine_main"]

        def predict(handle):
            req = urllib.request.Request(
                f"{handle.url}/api/v0.1/predictions",
                data=json.dumps({"data": {"ndarray": [[1.0, 2.0]]}}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())

        out = await asyncio.get_running_loop().run_in_executor(None, predict, engines[0])
        assert out["data"]["ndarray"] == [[0.9, 0.05, 0.05]]
        assert await engines[0].load() == 0.0
        assert await engines[1].drain_to(f"127.0.0.1:{engines[0].spec.http_port}", 1.0) is None
        scaled, _ = store.apply(dep_of(PORT, simple(name="subp", replicas=1)))
        status = await ctl.reconcile(scaled.clone())
        assert status.predictor_status[0].replicas_available == 1
        assert engines[1].proc.poll() is not None and engines[0].proc.poll() is None
        await ctl.delete(dep)
        assert engines[0].proc.poll() is not None

    run(go())


def _cli(pkg, store_dir, *argv, capsys):
    cli = m(pkg, "controlplane.cli")
    code = 0
    try:
        cli.main(["--store-dir", str(store_dir), *argv])
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return code, out.out


def test_cli_apply_get_scale_status_delete(tmp_path, capsys):
    f = tmp_path / "dep.json"
    f.write_text(json.dumps(simple(name="cli", replicas=1)))
    got = {}
    for pkg in PKGS:
        store = tmp_path / pkg
        steps = [
            _cli(pkg, store, "apply", "-f", str(f), capsys=capsys),
            _cli(pkg, store, "apply", "-f", str(f), capsys=capsys),
            _cli(pkg, store, "scale", "cli", "3", capsys=capsys),
            _cli(pkg, store, "scale", "cli", "0", capsys=capsys),
            _cli(pkg, store, "status", "cli", capsys=capsys),
            _cli(pkg, store, "get", capsys=capsys),
            _cli(pkg, store, "get", "cli", capsys=capsys),
            _cli(pkg, store, "get", "nope", capsys=capsys),
            _cli(pkg, store, "delete", "cli", capsys=capsys),
            _cli(pkg, store, "delete", "cli", capsys=capsys),
        ]
        got[pkg] = steps
    assert got[PORT] == got[JAX]
    assert got[PORT][2][1].strip().endswith("predictor p0 scaled to 3")
    assert json.loads(got[PORT][6][1])["spec"]["predictors"][0]["replicas"] == 3


@pytest.mark.parametrize("argv,module", [
    (["render", "-f", "x.json"], "k8s.py"),
    (["crd"], "kube.py"),
    (["controller", "--kube"], "kube.py"),
    (["build", "--src", "s", "--model-name", "M", "--out", "o"], "build.py"),
])
def test_cli_unported_commands_name_their_module(argv, module, tmp_path, monkeypatch, capsys):
    """``render``, ``crd``, ``controller --kube`` and ``build`` once exited
    "not ported yet" naming the module they waited for; each now runs that
    module of the port."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    (tmp_path / "x.json").write_text(json.dumps(simple(name="x")))
    (tmp_path / "s").mkdir()
    (tmp_path / "s" / "M.py").write_text("class M:\n    pass\n")
    cli = m(PORT, "controlplane.cli")
    if module == "kube.py" and "controller" in argv:
        # the port's HttpKubeApi, outside a cluster with no --kube-server
        with pytest.raises(RuntimeError, match="kubectl proxy"):
            cli.main(["--store-dir", str(tmp_path), *argv])
        return
    cli.main(["--store-dir", str(tmp_path), *argv])
    out = capsys.readouterr().out
    assert "not ported" not in out
    if module == "k8s.py":
        assert "seldon-tpu-torch-engine" in out and "kind: Deployment" in out
    elif module == "kube.py":
        assert out == m(PORT, "controlplane.k8s").to_yaml(
            [m(PORT, "controlplane.kube").CRD_MANIFEST])
    else:
        assert "seldon-tpu-torch-microservice" in (tmp_path / "o" / "Dockerfile").read_text()


def test_cli_crd_equals_jax(capsys):
    out = []
    for pkg in PKGS:
        m(pkg, "controlplane.cli").main(["crd"])
        out.append(capsys.readouterr().out)
    assert out[1] == out[0] and "seldondeployments.machinelearning.seldon.io" in out[1]
