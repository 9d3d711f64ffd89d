"""Kubernetes manifest renderer: SeldonDeployment -> Deployments/Services/
HPAs/VirtualService for nodes with NVIDIA GPUs.

Counterpart of ``seldon_core_tpu/controlplane/k8s.py``. The reference
materializes these objects imperatively inside its Go controller
(reference: operator/controllers/seldondeployment_controller.go:
855-1122 createDeployments/createServices/createHpas, engine sidecar
injection seldondeployment_engine.go:101-214, Istio canary routing
istio.go + seldondeployment_controller.go:113-224). The control plane
of this package is self-hosted (reconciler.py), so the K8s path is a
*renderer*: ``sdctl render -f dep.json`` emits the YAML an operator
would have applied, and ``kube.py``'s controller applies it to a live
cluster.

Design notes (vs the reference's output):

* **One pod per predictor replica, whole graph inside.** The engine
  hosts in-process units on its card (graph hops are function calls,
  not network hops), so the unit of K8s scheduling is the predictor,
  not the unit.
* **GPU scheduling.** The engine (``seldon-tpu-torch-engine``) runs its
  in-process model servers on CUDA and refuses to start without it, so a
  predictor with such a unit (``DEVICE_IMPLEMENTATIONS`` without a
  ``device`` parameter of ``cpu``) requests one ``nvidia.com/gpu``,
  tolerates the ``nvidia.com/gpu`` NoSchedule taint and selects the
  GKE accelerator (``seldon.io/gpu-accelerator``, default
  ``DEFAULT_GPU_ACCELERATOR``). A predictor whose units run on the host
  (builtins, host servers, remote units) gets no accelerator.
* **A mesh is one pod.** A predictor with a ``tpuMesh`` or a
  ``seldon.io/mesh`` annotation (sharded generate serving, or sharded
  predict through a JAX_SERVER unit's TorchServer) renders one pod per
  replica that asks for the mesh's product of ``nvidia.com/gpu``: one
  engine process drives every card of its mesh. The annotation's shape
  reaches the engine as the predictor's ``tpuMesh`` (injected into
  ``ENGINE_PREDICTOR``, the annotation stripped there, as the reconciler
  does). Refused, not ported yet: a mesh larger than one host's cards
  (``seldon.io/gpus-per-host``, default ``DEFAULT_GPUS_PER_HOST``), the
  JAX renderer's multi-host StatefulSet, which one process cannot
  drive.
* **Exact preStop drain**: ``/pause`` then poll ``/inflight`` to zero
  (the engine exposes an exact gauge) instead of the reference's blind
  ``curl /pause; sleep 10`` (seldondeployment_engine.go:173-177).

Everything else — labels, env names, probes, Services, the HPA on
``seldon_engine_inflight``, the Istio objects — is the JAX renderer's
output.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..graph.spec import (
    ANNOTATION_MESH,
    GraphSpecError,
    PredictorSpec,
    check_not_ported_annotations,
    default_predictor,
    parse_mesh_annotation,
)
from .resource import SeldonDeployment

ENGINE_HTTP_PORT = 8000
ENGINE_GRPC_PORT = 5001

ANNOTATION_ENGINE_IMAGE = "seldon.io/engine-image"
# the GPU counterparts of the JAX renderer's seldon.io/tpu-accelerator and
# seldon.io/tpu-chips-per-host: the docs (the JAX package's) name those
# seldon-lint: disable=annotation-drift
ANNOTATION_GPU_ACCELERATOR = "seldon.io/gpu-accelerator"
ANNOTATION_ENGINE_CPU = "seldon.io/engine-cpu"
# reference: getEngineEnvAnnotations / ANNOTATION_JAVA_OPTS idiom — any
# annotation under this prefix becomes an engine-container env var
ENGINE_ENV_ANNOTATION_PREFIX = "seldon.io/engine-env-"

# the engine image carries PyTorch built for CUDA and this package
DEFAULT_ENGINE_IMAGE = "ghcr.io/seldon-core-tpu/engine-torch-cuda:latest"
ENGINE_COMMAND = "seldon-tpu-torch-engine"
# GKE's node label value for a node pool of H100 80GB cards
DEFAULT_GPU_ACCELERATOR = "nvidia-h100-80gb"
GPU_RESOURCE = "nvidia.com/gpu"
ANNOTATION_GPUS_PER_HOST = "seldon.io/gpus-per-host"  # seldon-lint: disable=annotation-drift
# the cards of one H100 host (an 8-GPU node)
DEFAULT_GPUS_PER_HOST = 8
# in-process implementations whose model runs on the card (graph/spec.py
# PREPACKAGED_SERVERS: the others run on the host)
DEVICE_IMPLEMENTATIONS = ("JAX_SERVER", "GENERATE_SERVER")


def _labels(dep: SeldonDeployment, p: PredictorSpec) -> Dict[str, str]:
    """Selector labels (reference: createComponents labels app.kubernetes.io
    + seldon-deployment-id, seldondeployment_controller.go:509-511)."""
    return {
        "app.kubernetes.io/managed-by": "seldon-core-tpu",
        "seldon-deployment-id": dep.name,
        "seldon-predictor": p.name,
    }


def _meta(name: str, dep: SeldonDeployment, p: Optional[PredictorSpec] = None,
          extra_labels: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    labels = dict(dep.labels)
    if p is not None:
        labels.update(_labels(dep, p))
        labels.update(p.labels)
    if extra_labels:
        labels.update(extra_labels)
    # every rendered object is findable by owner: the kube controller prunes
    # orphans via these two labels (reference does it with ownerReferences +
    # the GC, seldondeployment_controller.go:1129-1199 owner-indexed watches)
    labels.setdefault("app.kubernetes.io/managed-by", "seldon-core-tpu")
    labels.setdefault("seldon-deployment-id", dep.name)
    meta: Dict[str, Any] = {"name": name, "namespace": dep.namespace}
    if labels:
        meta["labels"] = labels
    if dep.annotations:
        meta["annotations"] = dict(dep.annotations)
    return meta


def _engine_container(dep: SeldonDeployment, p: PredictorSpec) -> Dict[str, Any]:
    """The engine container (reference: createEngineContainer
    seldondeployment_engine.go:101-214 — env names, probe cadence and the
    traffic-zeroed ENGINE_PREDICTOR are kept for parity; JAVA_OPTS and the
    jmx/admin ports have no counterpart here)."""
    p_env = PredictorSpec.from_dict(p.to_dict())  # deep copy
    p_env.traffic = 0  # reference parity: zero so canary flips don't re-roll pods
    mesh = _mesh_of(p)
    if mesh is not None and not p.tpu_mesh:
        # the annotation's shape rides as tpuMesh, which the engine builds
        # its serving mesh from; stripped, so re-validation sees one source
        p_env.tpu_mesh = dict(mesh)
        p_env.annotations = {k: v for k, v in p_env.annotations.items()
                             if k != ANNOTATION_MESH}
    env = [
        {"name": "ENGINE_PREDICTOR", "value": p_env.to_env_b64()},
        {"name": "DEPLOYMENT_NAME", "value": dep.name},
        {"name": "DEPLOYMENT_NAMESPACE", "value": dep.namespace},
        {"name": "ENGINE_SERVER_PORT", "value": str(ENGINE_HTTP_PORT)},
        {"name": "ENGINE_SERVER_GRPC_PORT", "value": str(ENGINE_GRPC_PORT)},
    ]
    seen = {e["name"] for e in env}
    ann = {**dep.annotations, **p.annotations}
    for key, value in sorted(ann.items()):
        if key.startswith(ENGINE_ENV_ANNOTATION_PREFIX):
            name = key[len(ENGINE_ENV_ANNOTATION_PREFIX):].upper().replace("-", "_")
            if name not in seen:
                env.append({"name": name, "value": value})
                seen.add(name)
    if "SELDON_LOG_MESSAGES_EXTERNALLY" not in seen:
        env.append({"name": "SELDON_LOG_MESSAGES_EXTERNALLY", "value": "false"})
    drain = (
        f"curl -s 127.0.0.1:{ENGINE_HTTP_PORT}/pause; "
        f"for i in $(seq 1 60); do "
        f'[ "$(curl -s 127.0.0.1:{ENGINE_HTTP_PORT}/inflight)" = "0" ] && break; '
        f"sleep 1; done"
    )
    return {
        "name": "seldon-engine",
        "image": ann.get(ANNOTATION_ENGINE_IMAGE, DEFAULT_ENGINE_IMAGE),
        "command": [ENGINE_COMMAND],
        "env": env,
        "ports": [
            {"containerPort": ENGINE_HTTP_PORT, "name": "http", "protocol": "TCP"},
            {"containerPort": ENGINE_GRPC_PORT, "name": "grpc", "protocol": "TCP"},
        ],
        "readinessProbe": {
            "httpGet": {"path": "/ready", "port": "http", "scheme": "HTTP"},
            "initialDelaySeconds": 20, "periodSeconds": 5,
            "failureThreshold": 3, "successThreshold": 1, "timeoutSeconds": 60,
        },
        "livenessProbe": {
            "httpGet": {"path": "/live", "port": "http", "scheme": "HTTP"},
            "initialDelaySeconds": 20, "periodSeconds": 5,
            "failureThreshold": 3, "successThreshold": 1, "timeoutSeconds": 60,
        },
        "lifecycle": {"preStop": {"exec": {"command": ["/bin/sh", "-c", drain]}}},
        "resources": {
            "requests": {"cpu": ann.get(ANNOTATION_ENGINE_CPU, "0.1")},
        },
    }


def _uses_device(p: PredictorSpec) -> bool:
    """Whether the predictor's engine runs a model on the card: an
    in-process unit of ``DEVICE_IMPLEMENTATIONS`` whose ``device``
    parameter (default CUDA) is not ``cpu``."""
    for unit in p.graph.walk():
        if (unit.endpoint.transport or "INPROCESS").upper() in ("REST", "HTTP", "GRPC"):
            continue
        if unit.implementation not in DEVICE_IMPLEMENTATIONS:
            continue
        params = {q.name: str(q.value) for q in unit.parameters}
        if params.get("device", "cuda").strip().lower() != "cpu":
            return True
    return False


def _gpu_scheduling(ann: Dict[str, str], cards: int = 1) -> Dict[str, Any]:
    """nodeSelector/tolerations/resources for ``cards`` NVIDIA cards on a
    GKE GPU node pool (the NVIDIA device plugin's ``nvidia.com/gpu``
    resource and taint)."""
    return {
        "nodeSelector": {
            "cloud.google.com/gke-accelerator": ann.get(
                ANNOTATION_GPU_ACCELERATOR, DEFAULT_GPU_ACCELERATOR
            ),
        },
        "tolerations": [
            {"key": GPU_RESOURCE, "operator": "Exists", "effect": "NoSchedule"}
        ],
        "resources": {GPU_RESOURCE: str(cards)},
    }


def _mesh_of(p: PredictorSpec) -> Optional[Dict[str, int]]:
    """The predictor's serving-mesh shape: its ``tpuMesh``, else its
    ``seldon.io/mesh`` annotation, validated as at apply (the predictor's
    own, as the reconciler reads it)."""
    if p.tpu_mesh:
        return dict(p.tpu_mesh)
    return parse_mesh_annotation(p)


def _check_predictor(dep: SeldonDeployment, p: PredictorSpec) -> None:
    """Refuse what this renderer cannot render: an unported feature's
    annotation, and a mesh past one host's cards (the JAX renderer's
    multi-host StatefulSet: one engine process drives one host's
    cards)."""
    merged = PredictorSpec.from_dict(p.to_dict())
    merged.annotations = {**dep.annotations, **p.annotations}
    check_not_ported_annotations(merged)
    mesh = _mesh_of(p)
    if mesh is None:
        return
    cards = _cards(mesh)
    per_host = int(merged.annotations.get(ANNOTATION_GPUS_PER_HOST, DEFAULT_GPUS_PER_HOST))
    if cards > per_host:
        raise GraphSpecError(
            f"predictor {p.name!r}: a mesh {mesh} of {cards} cards spans more than "
            f"one host of {per_host}; multi-host sharded serving is not ported to "
            "seldon_core_tpu_torch yet"
        )


def _cards(mesh: Dict[str, int]) -> int:
    n = 1
    for v in mesh.values():
        n *= int(v)
    return n


def _pod_spec(dep: SeldonDeployment, p: PredictorSpec) -> Dict[str, Any]:
    container = _engine_container(dep, p)
    pod: Dict[str, Any] = {"containers": [container], "terminationGracePeriodSeconds": 90}
    if _uses_device(p):
        mesh = _mesh_of(p)
        sched = _gpu_scheduling({**dep.annotations, **p.annotations},
                                _cards(mesh) if mesh else 1)
        pod["nodeSelector"] = sched["nodeSelector"]
        pod["tolerations"] = sched["tolerations"]
        resources = container.setdefault("resources", {})
        resources.setdefault("requests", {}).update(sched["resources"])
        resources.setdefault("limits", {}).update(sched["resources"])
    return pod


def _workload(dep: SeldonDeployment, p: PredictorSpec) -> List[Dict[str, Any]]:
    """One Deployment per predictor."""
    name = f"{dep.name}-{p.name}"
    labels = _labels(dep, p)
    pod = _pod_spec(dep, p)
    # seldon-traffic rides only on the POD template (not the per-predictor
    # selector, which predates it): it lets the deployment-wide Service
    # backing the VirtualService host select live pods while excluding
    # shadow predictors from default routing.
    traffic = {"seldon-traffic": "shadow" if _is_shadow(p) else "live"}
    template = {
        "metadata": {"labels": {**labels, **traffic, **p.labels}},
        "spec": pod,
    }
    return [{
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": _meta(name, dep, p),
        "spec": {
            "replicas": p.replicas,
            "selector": {"matchLabels": labels},
            "template": template,
        },
    }]


def _engine_service_ports() -> List[Dict[str, Any]]:
    """The one place the engine Service ports live — per-predictor and
    deployment-wide Services must stay in lockstep."""
    return [
        {"name": "http", "port": ENGINE_HTTP_PORT,
         "targetPort": ENGINE_HTTP_PORT, "protocol": "TCP"},
        {"name": "grpc", "port": ENGINE_GRPC_PORT,
         "targetPort": ENGINE_GRPC_PORT, "protocol": "TCP"},
    ]


def _service(dep: SeldonDeployment, p: PredictorSpec) -> Dict[str, Any]:
    """Per-predictor Service (reference: createServices
    seldondeployment_controller.go:747-803)."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": _meta(f"{dep.name}-{p.name}", dep, p),
        "spec": {
            "selector": _labels(dep, p),
            "ports": _engine_service_ports(),
        },
    }


def _hpa(dep: SeldonDeployment, p: PredictorSpec) -> Optional[Dict[str, Any]]:
    """HPA from hpaSpec (reference: createHpas
    seldondeployment_controller.go:805-853). The scaling metric is
    in-flight concurrency per engine replica — the engine exports
    seldon_engine_inflight on /prometheus (engine_metrics.py), scraped
    into a Pods metric."""
    if not p.hpa_spec:
        return None
    from ..graph.spec import parse_hpa_spec

    lo, hi, target = parse_hpa_spec(p.hpa_spec, who=f"{dep.name}/{p.name}")
    return {
        "apiVersion": "autoscaling/v2",
        "kind": "HorizontalPodAutoscaler",
        "metadata": _meta(f"{dep.name}-{p.name}", dep, p),
        "spec": {
            "scaleTargetRef": {
                "apiVersion": "apps/v1", "kind": "Deployment",
                "name": f"{dep.name}-{p.name}",
            },
            "minReplicas": lo,
            "maxReplicas": hi,
            "metrics": [{
                "type": "Pods",
                "pods": {
                    "metric": {"name": "seldon_engine_inflight"},
                    # k8s quantity syntax: integral values must not carry
                    # a decimal point; fractional targets use milli-units
                    "target": {
                        "type": "AverageValue",
                        "averageValue": (
                            str(int(target)) if float(target).is_integer()
                            else f"{int(float(target) * 1000)}m"
                        ),
                    },
                },
            }],
            # mirror the reconciler's scale-down stabilization streak
            "behavior": {"scaleDown": {"stabilizationWindowSeconds": 300}},
        },
    }


def _is_shadow(p: PredictorSpec) -> bool:
    return p.annotations.get("seldon.io/shadow", "false") == "true"


def _deployment_service(dep: SeldonDeployment) -> Dict[str, Any]:
    """ClusterIP Service named after the DEPLOYMENT, backing the
    VirtualService host: without it '<dep>.<ns>.svc.cluster.local' has no
    DNS entry and in-mesh clients can never reach the canary weights
    (the reference instead binds its VS to an Istio gateway with
    hosts:["*"], seldondeployment_controller.go:126-148). Selector spans
    every LIVE predictor via the pod-template-only seldon-traffic label,
    so shadows receive mirrored traffic only."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": _meta(dep.name, dep),
        "spec": {
            "selector": {
                "app.kubernetes.io/managed-by": "seldon-core-tpu",
                "seldon-deployment-id": dep.name,
                "seldon-traffic": "live",
            },
            "ports": _engine_service_ports(),
        },
    }


def _virtual_service(dep: SeldonDeployment) -> Optional[Dict[str, Any]]:
    """Istio VirtualService carrying the canary weights and shadow mirror
    (reference: createIstioResources seldondeployment_controller.go:113-224;
    shadow == Gateway mirroring in ingress.py)."""
    is_shadow = _is_shadow

    live = [p for p in dep.predictors if not is_shadow(p)]
    shadows = [p for p in dep.predictors if is_shadow(p)]
    if len(live) < 2 and not shadows:
        return None
    total = sum(p.traffic for p in live)

    def rule_for_port(port: int) -> Dict[str, Any]:
        routes = []
        for p in live:
            # no explicit weights -> even split (webhook-default parity)
            weight = p.traffic if total else 100 // len(live)
            routes.append({
                "destination": {
                    "host": (f"{dep.name}-{p.name}.{dep.namespace}"
                             ".svc.cluster.local"),
                    # subset pairs with the predictor's DestinationRule —
                    # on a mesh running mTLS/subset policies a bare host
                    # route is not routable (reference: HTTPRouteDestination
                    # {Host, Subset}, seldondeployment_controller.go:196-215)
                    "subset": p.name,
                    "port": {"number": port},
                },
                "weight": weight,
            })
        # weights must sum to 100 for Istio; pad the first route
        pad = 100 - sum(r["weight"] for r in routes)
        if routes and pad:
            routes[0]["weight"] += pad
        # port-scoped match: a port-free http rule would apply to EVERY
        # HTTP/gRPC port of the host, sending grpc:5001 traffic to the
        # REST port's destination
        rule: Dict[str, Any] = {"match": [{"port": port}], "route": routes}
        if shadows:
            s = shadows[0]
            rule["mirror"] = {
                "host": f"{dep.name}-{s.name}.{dep.namespace}.svc.cluster.local",
                "subset": s.name,
                "port": {"number": port},
            }
            rule["mirrorPercentage"] = {"value": 100.0}
        return rule

    return {
        "apiVersion": "networking.istio.io/v1beta1",
        "kind": "VirtualService",
        "metadata": _meta(dep.name, dep),
        "spec": {
            "hosts": [f"{dep.name}.{dep.namespace}.svc.cluster.local"],
            "http": [rule_for_port(ENGINE_HTTP_PORT),
                     rule_for_port(ENGINE_GRPC_PORT)],
        },
    }


def _destination_rules(dep: SeldonDeployment) -> List[Dict[str, Any]]:
    """One DestinationRule per predictor: subset named after the predictor
    selecting its pods, mTLS ISTIO_MUTUAL so the canary weights route on
    a mesh with strict TLS (reference: createIstioResources' drules,
    seldondeployment_controller.go:171-193 — there the subset label is
    ``version``; here the renderer's own ``seldon-predictor`` pod label is
    the discriminator, present on every rendered pod template)."""
    rules = []
    for p in dep.predictors:
        host = f"{dep.name}-{p.name}.{dep.namespace}.svc.cluster.local"
        rules.append({
            "apiVersion": "networking.istio.io/v1beta1",
            "kind": "DestinationRule",
            "metadata": _meta(f"{dep.name}-{p.name}", dep, p),
            "spec": {
                "host": host,
                "trafficPolicy": {"tls": {"mode": "ISTIO_MUTUAL"}},
                "subsets": [
                    {
                        "name": p.name,
                        "labels": {"seldon-predictor": p.name},
                    }
                ],
            },
        })
    return rules


def render(dep: SeldonDeployment) -> List[Dict[str, Any]]:
    """SeldonDeployment -> ordered manifest list (workloads, services,
    HPAs, then routing), webhook-defaulted first like the operator. A
    mesh past one host's cards raises GraphSpecError (not ported yet)."""
    manifests: List[Dict[str, Any]] = []
    defaulted = []
    for p in dep.predictors:
        _check_predictor(dep, p)
        defaulted.append(default_predictor(PredictorSpec.from_dict(p.to_dict())))
    dep = SeldonDeployment(
        name=dep.name, namespace=dep.namespace, predictors=defaulted,
        annotations=dep.annotations, labels=dep.labels, protocol=dep.protocol,
    )
    for p in dep.predictors:
        manifests.extend(_workload(dep, p))
    for p in dep.predictors:
        manifests.append(_service(dep, p))
    for p in dep.predictors:
        hpa = _hpa(dep, p)
        if hpa:
            manifests.append(hpa)
    vs = _virtual_service(dep)
    if vs:
        # the deployment-wide Service must exist for the VS host to resolve
        manifests.append(_deployment_service(dep))
        # DestinationRules BEFORE the VirtualService that names their
        # subsets: applying in manifest order never leaves the VS dangling
        manifests.extend(_destination_rules(dep))
        manifests.append(vs)
    return manifests


def to_yaml(manifests: List[Dict[str, Any]]) -> str:
    try:
        import yaml
    except Exception:  # pragma: no cover - pyyaml is in the image, but the
        # renderer must not hard-require it (kubectl accepts JSON streams)
        return "\n".join(json.dumps(m, indent=2) for m in manifests)
    return yaml.safe_dump_all(manifests, sort_keys=False, default_flow_style=False)


# -- minimal structural validation (no k8s client in the image) -------------

_REQUIRED_TOP = ("apiVersion", "kind", "metadata")


def validate_manifests(manifests: List[Dict[str, Any]]) -> None:
    """Schema sanity for rendered objects: required keys, selector/label
    coherence, container port/probe consistency. Raises ValueError."""
    names = set()
    for m in manifests:
        for k in _REQUIRED_TOP:
            if k not in m:
                raise ValueError(f"manifest missing {k}: {m}")
        meta = m["metadata"]
        if "name" not in meta or "namespace" not in meta:
            raise ValueError(f"metadata incomplete: {meta}")
        key = (m["kind"], meta["namespace"], meta["name"])
        if key in names:
            raise ValueError(f"duplicate object {key}")
        names.add(key)
        if m["kind"] in ("Deployment", "StatefulSet"):
            spec = m["spec"]
            sel = spec["selector"]["matchLabels"]
            tpl_labels = spec["template"]["metadata"]["labels"]
            for k, v in sel.items():
                if tpl_labels.get(k) != v:
                    raise ValueError(
                        f"{meta['name']}: selector {k}={v} not in template labels"
                    )
            for c in spec["template"]["spec"]["containers"]:
                port_names = {p.get("name") for p in c.get("ports", [])}
                for probe in ("readinessProbe", "livenessProbe"):
                    http = c.get(probe, {}).get("httpGet", {})
                    port = http.get("port")
                    if isinstance(port, str) and port not in port_names:
                        raise ValueError(
                            f"{meta['name']}/{c['name']}: {probe} references "
                            f"unknown port {port!r}"
                        )
        if m["kind"] == "HorizontalPodAutoscaler":
            spec = m["spec"]
            if spec["minReplicas"] > spec["maxReplicas"]:
                raise ValueError(f"{meta['name']}: minReplicas > maxReplicas")
    # every HPA must target a rendered workload of the SAME kind (an HPA
    # naming a Deployment that rendered as a StatefulSet FailedGetScales
    # forever on a real cluster)
    workloads = {(k, ns, n) for k, ns, n in names if k in ("Deployment", "StatefulSet")}
    for m in manifests:
        if m["kind"] == "HorizontalPodAutoscaler":
            ref = m["spec"]["scaleTargetRef"]
            if (ref["kind"], m["metadata"]["namespace"], ref["name"]) not in workloads:
                raise ValueError(
                    f"HPA targets unknown workload {ref['kind']}/{ref['name']}"
                )
