"""Live-Kubernetes operator mode: watch SeldonDeployment CRs, apply the
rendered manifests, correct drift.

Counterpart of ``seldon_core_tpu/controlplane/kube.py`` and of the
reference's kubebuilder controller (reference:
operator/controllers/seldondeployment_controller.go:1067-1122 Reconcile;
owner-indexed watches ``SetupWithManager`` :1129-1199; JSON-equality diff
``jsonEquals`` :842) — the piece that turns ``k8s.py``'s render-only output
into a *controller*: a level-triggered loop that converges a live cluster
onto the CR's desired state and re-converges when someone mutates an owned
object out from under it. The CRD (schema and CEL rules) is the JAX
package's, byte for byte, so either operator serves the same CRs; the
objects it applies are this package's render (GPU scheduling, the port's
engine).

Design differences from the reference, on purpose:

* **No client-go / controller-runtime** — a minimal typed client over the
  Kubernetes REST API (``HttpKubeApi``) with an injectable fake for tests
  (mirroring envtest's role, reference: operator/controllers/suite_test.go:
  17-30). The controller logic is transport-agnostic.
* **Level-triggered resync instead of edge-triggered caches**: every
  ``resync_s`` (and on every watch event) each CR is re-reconciled from
  scratch.  Apply is idempotent — create if absent, replace only when the
  desired spec is not a subset of the live object (``subset_equal``), so a
  converged cluster sees zero writes per cycle.
* **Label-based ownership** (``seldon-deployment-id`` +
  ``app.kubernetes.io/managed-by``) for pruning, *plus* ownerReferences on
  every object so a real cluster's GC also works.

The webhook-defaulting/validation step the reference runs server-side
(seldondeployment_webhook.go) happens inside ``k8s.render`` and
``graph/spec.validate_deployment`` here.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .k8s import render, validate_manifests
from .resource import SeldonDeployment

logger = logging.getLogger(__name__)

GROUP = "machinelearning.seldon.io"
VERSION = "v1alpha2"
PLURAL = "seldondeployments"
MANAGED_BY = "seldon-core-tpu"

# kind -> (api prefix, plural). Everything k8s.render can emit.
KIND_ROUTES: Dict[str, Tuple[str, str]] = {
    "Deployment": ("apis/apps/v1", "deployments"),
    "StatefulSet": ("apis/apps/v1", "statefulsets"),
    "Service": ("api/v1", "services"),
    "ConfigMap": ("api/v1", "configmaps"),
    "HorizontalPodAutoscaler": ("apis/autoscaling/v2", "horizontalpodautoscalers"),
    "VirtualService": ("apis/networking.istio.io/v1beta1", "virtualservices"),
    "DestinationRule": ("apis/networking.istio.io/v1beta1", "destinationrules"),
    "SeldonDeployment": (f"apis/{GROUP}/{VERSION}", PLURAL),
    "CustomResourceDefinition": (
        "apis/apiextensions.k8s.io/v1", "customresourcedefinitions"
    ),
    "Lease": ("apis/coordination.k8s.io/v1", "leases"),
}

# Prepackaged server implementations that require a modelUri (reference:
# checkPredictiveUnits, seldondeployment_webhook.go:356-363, extended with
# this repo's TRT/SageMaker servers)
PREPACKAGED_IMPLEMENTATIONS = (
    "SKLEARN_SERVER", "XGBOOST_SERVER", "TENSORFLOW_SERVER",
    "MLFLOW_SERVER", "TRT_SERVER", "SAGEMAKER_SERVER", "JAX_SERVER",
)

# CEL admission rules (x-kubernetes-validations): the apiserver rejects an
# invalid CR BEFORE it reaches etcd — the modern, webhook-server-free
# equivalent of the reference's ValidateCreate/ValidateUpdate
# (seldondeployment_webhook.go:388-411). Each rule has a Python twin in
# _CEL_TWINS below (used by validate_cr for fake-apiserver tests and
# defense-in-depth); a test pins the two lists in sync.
CEL_RULES = [
    {
        "rule": "self.predictors.all(p, self.predictors.exists_one("
                "q, q.name == p.name))",
        "message": "Duplicate predictor name",
    },
    {
        "rule": "size(self.predictors) <= 1 || "
                "self.predictors.map(p, has(p.traffic) ? p.traffic : 0)"
                ".sum() == 100",
        "message": "Traffic must sum to 100 for multiple predictors",
    },
    {
        "rule": "size(self.predictors) != 1 || "
                "!has(self.predictors[0].traffic) || "
                "self.predictors[0].traffic in [0, 100]",
        "message": "Traffic must be 100 for a single predictor when set",
    },
    {
        "rule": "self.predictors.all(p, "
                "!(has(p.graph.implementation) && p.graph.implementation in "
                + json.dumps(list(PREPACKAGED_IMPLEMENTATIONS))
                + ") || has(p.graph.modelUri))",
        "message": "Predictive unit modelUri required when using "
                   "standalone servers",
    },
]


def _graph_schema(depth: int) -> Dict[str, Any]:
    """Structural schema for a PredictiveUnit, nested to ``depth`` levels
    (structural schemas cannot recurse; below the bounded depth children
    stay open and are caught by the reconcile-time validator)."""
    unit: Dict[str, Any] = {
        "type": "object",
        "required": ["name"],
        "properties": {
            "name": {"type": "string", "minLength": 1},
            "type": {
                "type": "string",
                "enum": [
                    "MODEL", "ROUTER", "COMBINER", "TRANSFORMER",
                    "OUTPUT_TRANSFORMER",
                ],
            },
            "implementation": {"type": "string"},
            "modelUri": {"type": "string"},
            "endpoint": {
                "type": "object",
                "x-kubernetes-preserve-unknown-fields": True,
            },
            "parameters": {
                "type": "array",
                "items": {
                    "type": "object",
                    "x-kubernetes-preserve-unknown-fields": True,
                },
            },
        },
        "x-kubernetes-preserve-unknown-fields": True,
    }
    if depth > 0:
        unit["properties"]["children"] = {
            "type": "array", "maxItems": 16,
            "items": _graph_schema(depth - 1),
        }
    return unit


CRD_OPENAPI_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "properties": {
        "spec": {
            "type": "object",
            "required": ["predictors"],
            "x-kubernetes-validations": CEL_RULES,
            "properties": {
                "name": {"type": "string"},
                "predictors": {
                    "type": "array",
                    "minItems": 1,
                    # bounded so the apiserver's CEL cost estimator accepts
                    # the quadratic uniqueness rule (unbounded arrays fail
                    # CRD admission on k8s >= 1.25 with "rule cost exceeds
                    # budget")
                    "maxItems": 32,
                    "items": {
                        "type": "object",
                        "required": ["name", "graph"],
                        "properties": {
                            "name": {"type": "string", "minLength": 1},
                            "replicas": {"type": "integer", "minimum": 0},
                            "traffic": {
                                "type": "integer",
                                "minimum": 0,
                                "maximum": 100,
                            },
                            "graph": _graph_schema(4),
                        },
                        "x-kubernetes-preserve-unknown-fields": True,
                    },
                },
            },
        },
        "status": {
            "type": "object",
            "x-kubernetes-preserve-unknown-fields": True,
        },
    },
}

CRD_MANIFEST: Dict[str, Any] = {
    "apiVersion": "apiextensions.k8s.io/v1",
    "kind": "CustomResourceDefinition",
    "metadata": {"name": f"{PLURAL}.{GROUP}"},
    "spec": {
        "group": GROUP,
        "names": {
            "kind": "SeldonDeployment",
            "listKind": "SeldonDeploymentList",
            "plural": PLURAL,
            "singular": "seldondeployment",
            "shortNames": ["sdep"],
        },
        "scope": "Namespaced",
        "versions": [
            {
                "name": VERSION,
                "served": True,
                "storage": True,
                "subresources": {"status": {}},
                "schema": {"openAPIV3Schema": CRD_OPENAPI_SCHEMA},
            }
        ],
    },
}


def _schema_check(schema: Dict[str, Any], obj: Any, path: str,
                  errs: List[str]) -> None:
    """Evaluate the structural subset CRD_OPENAPI_SCHEMA uses (type,
    required, enum, minItems, minLength, minimum/maximum) — the same
    checks a real apiserver applies from the manifest. Unknown fields
    pass (x-kubernetes-preserve-unknown-fields)."""
    t = schema.get("type")
    if t == "object":
        if not isinstance(obj, dict):
            errs.append(f"{path}: expected object")
            return
        for req in schema.get("required", ()):
            if req not in obj:
                errs.append(f"{path}.{req}: required")
        for key, sub in schema.get("properties", {}).items():
            if key in obj:
                _schema_check(sub, obj[key], f"{path}.{key}", errs)
    elif t == "array":
        if not isinstance(obj, list):
            errs.append(f"{path}: expected array")
            return
        if len(obj) < schema.get("minItems", 0):
            errs.append(f"{path}: fewer than {schema['minItems']} items")
        items = schema.get("items")
        if items:
            for i, item in enumerate(obj):
                _schema_check(items, item, f"{path}[{i}]", errs)
    elif t == "string":
        if not isinstance(obj, str):
            errs.append(f"{path}: expected string")
            return
        if len(obj) < schema.get("minLength", 0):
            errs.append(f"{path}: shorter than minLength")
        if "enum" in schema and obj not in schema["enum"]:
            errs.append(f"{path}: {obj!r} not one of {schema['enum']}")
    elif t == "integer":
        if not isinstance(obj, int) or isinstance(obj, bool):
            errs.append(f"{path}: expected integer")
            return
        if "minimum" in schema and obj < schema["minimum"]:
            errs.append(f"{path}: below minimum {schema['minimum']}")
        if "maximum" in schema and obj > schema["maximum"]:
            errs.append(f"{path}: above maximum {schema['maximum']}")


def _twin_unique_names(spec: Dict[str, Any]) -> bool:
    names = [p.get("name") for p in spec.get("predictors", [])]
    return len(names) == len(set(names))


def _twin_traffic_sum(spec: Dict[str, Any]) -> bool:
    preds = spec.get("predictors", [])
    if len(preds) <= 1:
        return True
    return sum(int(p.get("traffic", 0)) for p in preds) == 100


def _twin_traffic_single(spec: Dict[str, Any]) -> bool:
    preds = spec.get("predictors", [])
    if len(preds) != 1 or "traffic" not in preds[0]:
        return True
    return int(preds[0]["traffic"]) in (0, 100)


def _twin_model_uri(spec: Dict[str, Any]) -> bool:
    for p in spec.get("predictors", []):
        g = p.get("graph", {})
        if (
            g.get("implementation") in PREPACKAGED_IMPLEMENTATIONS
            and not g.get("modelUri")
        ):
            return False
    return True


# index-aligned with CEL_RULES — test_kube_admission pins the pairing
_CEL_TWINS = [
    _twin_unique_names, _twin_traffic_sum, _twin_traffic_single,
    _twin_model_uri,
]


def validate_cr(obj: Dict[str, Any]) -> None:
    """Admission-time validation of a SeldonDeployment CR: the structural
    schema plus every CEL rule's Python twin, exactly what a real
    apiserver enforces from CRD_MANIFEST before the object reaches etcd.
    Raises KubeApiError(422) — the apiserver's Invalid status — on the
    first batch of violations. Fake-apiserver tests install this on
    create/replace; on a live cluster the CRD schema itself enforces it
    (no webhook server needed)."""
    errs: List[str] = []
    _schema_check(CRD_OPENAPI_SCHEMA, obj, "", errs)
    spec = obj.get("spec")
    if isinstance(spec, dict) and isinstance(spec.get("predictors"), list):
        for rule, twin in zip(CEL_RULES, _CEL_TWINS):
            try:
                ok = twin(spec)
            except Exception:  # noqa: BLE001 - malformed spec: structural
                ok = False     # errors above already describe it
            if not ok:
                errs.append(f"spec: {rule['message']}")
    if errs:
        raise KubeApiError(
            422, "SeldonDeployment is invalid: " + "; ".join(errs[:8])
        )


class KubeApiError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"kube api {status}: {message}")
        self.status = status


class KubeApi:
    """Minimal REST surface the controller needs. Paths are full resource
    paths like ``apis/apps/v1/namespaces/default/deployments[/name]``."""

    def get(self, path: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def list(self, path: str, label_selector: str = "") -> List[Dict[str, Any]]:
        raise NotImplementedError

    def create(self, path: str, obj: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def replace(self, path: str, obj: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    def delete(self, path: str) -> bool:
        raise NotImplementedError


class HttpKubeApi(KubeApi):
    """Talk to a real kube-apiserver. In-cluster by default (service-account
    token + CA from the pod filesystem, KUBERNETES_SERVICE_HOST env), or an
    explicit ``server``/``token`` pair (e.g. `kubectl proxy` => server=
    "http://127.0.0.1:8001", token=None)."""

    SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

    def __init__(self, server: Optional[str] = None, token: Optional[str] = None,
                 ca_file: Optional[str] = None, timeout: float = 10.0):
        import os

        if server is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            if not host:
                raise RuntimeError(
                    "not in-cluster (no KUBERNETES_SERVICE_HOST) and no "
                    "--kube-server given; try `kubectl proxy` + "
                    "--kube-server http://127.0.0.1:8001"
                )
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            server = f"https://{host}:{port}"
            if token is None and os.path.exists(f"{self.SA_DIR}/token"):
                with open(f"{self.SA_DIR}/token") as f:
                    token = f.read().strip()
            if ca_file is None and os.path.exists(f"{self.SA_DIR}/ca.crt"):
                ca_file = f"{self.SA_DIR}/ca.crt"
        self.server = server.rstrip("/")
        self.token = token
        self._ctx = None
        if self.server.startswith("https"):
            import ssl

            self._ctx = (
                ssl.create_default_context(cafile=ca_file)
                if ca_file else ssl.create_default_context()
            )
        self.timeout = timeout

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 query: str = "") -> Tuple[int, Any]:
        import urllib.error
        import urllib.request

        url = f"{self.server}/{path}{('?' + query) if query else ''}"
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(
                req, timeout=self.timeout, context=self._ctx
            ) as r:
                return r.status, json.loads(r.read() or b"null")
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read() or b"{}")
            except Exception:  # noqa: BLE001
                payload = {}
            return e.code, payload

    def get(self, path: str) -> Optional[Dict[str, Any]]:
        status, body = self._request("GET", path)
        if status == 404:
            return None
        if status >= 400:
            raise KubeApiError(status, str(body.get("message", body)))
        return body

    def list(self, path: str, label_selector: str = "") -> List[Dict[str, Any]]:
        import urllib.parse

        q = f"labelSelector={urllib.parse.quote(label_selector)}" if label_selector else ""
        status, body = self._request("GET", path, query=q)
        if status >= 400:
            raise KubeApiError(status, str(body.get("message", body)))
        return body.get("items", [])

    def create(self, path: str, obj: Dict[str, Any]) -> Dict[str, Any]:
        status, body = self._request("POST", path, obj)
        if status >= 400:
            raise KubeApiError(status, str(body.get("message", body)))
        return body

    def replace(self, path: str, obj: Dict[str, Any]) -> Dict[str, Any]:
        status, body = self._request("PUT", path, obj)
        if status >= 400:
            raise KubeApiError(status, str(body.get("message", body)))
        return body

    def delete(self, path: str) -> bool:
        status, body = self._request("DELETE", path)
        if status == 404:
            return False
        if status >= 400:
            raise KubeApiError(status, str(body.get("message", body)))
        return True

    def watch(self, path: str, timeout_s: float = 300.0):
        """Kubernetes watch stream: yields event dicts ({type, object})
        until the server closes the window. The controller treats every
        event as 'reconcile now' — level-triggered logic stays the source
        of truth, the watch only shortens reaction time."""
        import urllib.request

        url = f"{self.server}/{path}?watch=1&timeoutSeconds={int(timeout_s)}"
        req = urllib.request.Request(url)
        req.add_header("Accept", "application/json")
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        with urllib.request.urlopen(
            req, timeout=timeout_s + 10, context=self._ctx
        ) as r:
            for line in r:
                if not line.strip():
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue


def object_path(kind: str, namespace: Optional[str], name: Optional[str] = None) -> str:
    """REST path for a (kind, namespace, name). Cluster-scoped kinds (the
    CRD itself) ignore namespace."""
    if kind not in KIND_ROUTES:
        raise ValueError(f"no API route for kind {kind!r}")
    prefix, plural = KIND_ROUTES[kind]
    if kind == "CustomResourceDefinition":
        base = f"{prefix}/{plural}"
    else:
        base = f"{prefix}/namespaces/{namespace}/{plural}"
    return f"{base}/{name}" if name else base


def subset_equal(desired: Any, live: Any) -> bool:
    """True when ``desired`` is structurally contained in ``live``: every
    key/value the render produced matches, while server-populated fields
    (status, resourceVersion, defaulted specs) are ignored. The reference
    normalizes both sides and compares JSON (jsonEquals,
    seldondeployment_controller.go:842); subset containment gives the same
    idempotency without having to model every admission default."""
    if isinstance(desired, dict):
        if not isinstance(live, dict):
            return False
        return all(k in live and subset_equal(v, live[k]) for k, v in desired.items())
    if isinstance(desired, list):
        if not isinstance(live, list) or len(desired) != len(live):
            return False
        return all(subset_equal(d, l) for d, l in zip(desired, live))
    if isinstance(desired, (int, float)) and isinstance(live, (int, float)):
        return float(desired) == float(live)
    return desired == live


class LeaderElector:
    """coordination.k8s.io/v1 Lease leader election: acquire if absent,
    renew while held, steal when the holder's lease lapses.

    Two controller replicas would otherwise double-reconcile and fight
    over status writes (reference: the manager's EnableLeaderElection,
    operator/main.go:49-93). ``clock`` is injectable so tests drive
    expiry without sleeping.
    """

    def __init__(self, api: KubeApi, namespace: str = "default",
                 name: str = "seldon-tpu-controller",
                 identity: Optional[str] = None,
                 lease_duration_s: float = 15.0,
                 clock=time.time):
        import os
        import socket

        self.api = api
        self.namespace = namespace
        self.name = name
        self.identity = identity or f"{socket.gethostname()}-{os.getpid()}"
        self.lease_duration_s = float(lease_duration_s)
        self.clock = clock
        self.is_leader = False

    def _path(self, with_name: bool) -> str:
        prefix, plural = KIND_ROUTES["Lease"]
        base = f"{prefix}/namespaces/{self.namespace}/{plural}"
        return f"{base}/{self.name}" if with_name else base

    @staticmethod
    def _fmt(epoch: float) -> str:
        import datetime as dt

        return dt.datetime.fromtimestamp(
            epoch, dt.timezone.utc
        ).strftime("%Y-%m-%dT%H:%M:%S.%fZ")

    @staticmethod
    def _parse(stamp: str) -> float:
        import datetime as dt

        return dt.datetime.strptime(
            stamp, "%Y-%m-%dT%H:%M:%S.%fZ"
        ).replace(tzinfo=dt.timezone.utc).timestamp()

    def _spec(self, now: float, transitions: int) -> Dict[str, Any]:
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_duration_s),
            "renewTime": self._fmt(now),
            "leaseTransitions": transitions,
        }

    def try_acquire(self) -> bool:
        """One election round: returns whether this identity holds the
        lease afterwards. Safe to call every loop pass — holding costs
        one GET + one conditional write."""
        now = self.clock()
        try:
            lease = self.api.get(self._path(True))
            if lease is None:
                self.api.create(self._path(False), {
                    "apiVersion": "coordination.k8s.io/v1",
                    "kind": "Lease",
                    "metadata": {"name": self.name,
                                 "namespace": self.namespace},
                    "spec": self._spec(now, 0),
                })
                self.is_leader = True
                return True
            spec = lease.get("spec", {})
            holder = spec.get("holderIdentity")
            try:
                renewed = self._parse(spec.get("renewTime", ""))
            except (ValueError, TypeError):
                renewed = 0.0  # malformed lease: treat as lapsed
            duration = float(
                spec.get("leaseDurationSeconds", self.lease_duration_s)
            )
            if holder == self.identity:
                lease["spec"] = self._spec(
                    now, int(spec.get("leaseTransitions", 0))
                )
                self.api.replace(self._path(True), lease)
                self.is_leader = True
                return True
            if now - renewed > duration:
                # holder lapsed: steal. resourceVersion rides along, so a
                # racing steal loses with a conflict instead of splitting
                # the brain
                lease["spec"] = self._spec(
                    now, int(spec.get("leaseTransitions", 0)) + 1
                )
                self.api.replace(self._path(True), lease)
                self.is_leader = True
                return True
        except KubeApiError as e:
            logger.debug("leader election round lost: %s", e)
        self.is_leader = False
        return False


class KubeController:
    """Converge a cluster onto its SeldonDeployment CRs.

    ``reconcile_all`` is one level-triggered pass: list CRs, render+apply
    each, prune owned objects whose CR is gone. ``run`` loops it with a
    resync period. Every write path is recorded by the injectable
    ``KubeApi``, so tests assert convergence (second pass => zero writes)
    and drift repair exactly like the reference's envtest suite asserts
    reconcile results."""

    def __init__(self, api: KubeApi, namespace: Optional[str] = None,
                 resync_s: float = 30.0,
                 elector: Optional[LeaderElector] = None):
        self.api = api
        self.namespace = namespace  # None = all namespaces the api can list
        self.resync_s = resync_s
        self.elector = elector  # None = single-replica mode, always leader
        self._stop = threading.Event()
        self._kick = threading.Event()  # watch events accelerate the loop
        # namespaces this controller has ever reconciled into: pruning after
        # the LAST CR in a namespace is deleted needs somewhere to look.
        # Survives for the controller's lifetime; across restarts a real
        # cluster's ownerReference GC covers the same case.
        self._known_namespaces: set = set()

    # -- setup --------------------------------------------------------------

    def install_crd(self) -> bool:
        """Create the SeldonDeployment CRD if missing; True if created."""
        path = object_path("CustomResourceDefinition", None,
                           CRD_MANIFEST["metadata"]["name"])
        if self.api.get(path) is not None:
            return False
        self.api.create(object_path("CustomResourceDefinition", None), CRD_MANIFEST)
        logger.info("installed CRD %s", CRD_MANIFEST["metadata"]["name"])
        return True

    def wait_crd_established(self, timeout_s: float = 10.0) -> bool:
        """Block until the CRD serves list requests (Established).

        Right after install_crd() a real apiserver needs a beat before the
        seldondeployments endpoint exists; a one-shot pass that lists
        immediately would crash on KubeApiError (the daemon loop tolerates
        this via catch-and-resync). Polls the list endpoint itself — the
        exact capability the next step needs — rather than parsing
        status.conditions, so it also works against minimal fake servers.
        """
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                self._list_crs()
                return True
            except KubeApiError:
                if time.monotonic() >= deadline:
                    return False
                time.sleep(0.2)

    # -- one reconcile pass --------------------------------------------------

    def _list_crs(self) -> List[Dict[str, Any]]:
        if self.namespace:
            return self.api.list(object_path("SeldonDeployment", self.namespace))
        prefix, plural = KIND_ROUTES["SeldonDeployment"]
        return self.api.list(f"{prefix}/{plural}")

    def reconcile_all(self) -> Dict[str, int]:
        """One pass over every CR. Returns op counts for observability."""
        ops = {"created": 0, "replaced": 0, "deleted": 0, "unchanged": 0,
               "failed": 0}
        crs = self._list_crs()
        live_ids = set()
        for cr in crs:
            ns = cr.get("metadata", {}).get("namespace", "default")
            name = cr.get("metadata", {}).get("name", "?")
            live_ids.add((ns, name))
            self._known_namespaces.add(ns)
            try:
                self.reconcile_cr(cr, ops)
            except Exception as e:  # noqa: BLE001 - one bad CR must not
                # block the rest (reference: Reconcile returns the error and
                # requeues only that object)
                ops["failed"] += 1
                logger.warning("reconcile %s/%s failed: %s", ns, name, e)
                self._set_status(cr, "Failed", str(e))
        self._prune_orphans(live_ids, ops)
        return ops

    def reconcile_cr(self, cr: Dict[str, Any], ops: Optional[Dict[str, int]] = None
                     ) -> Dict[str, int]:
        """Render the CR and converge its owned objects."""
        ops = ops if ops is not None else {
            "created": 0, "replaced": 0, "deleted": 0, "unchanged": 0}
        dep = SeldonDeployment.from_dict(cr)
        # admission parity: same webhook-equivalent validation the
        # self-hosted reconciler runs (reference: ValidateCreate,
        # seldondeployment_webhook.go:388-411)
        from ..graph.spec import validate_deployment

        validate_deployment(dep.predictors)
        manifests = render(dep)
        validate_manifests(manifests)
        owner = self._owner_ref(cr)
        desired_keys = set()
        apply_errors: List[str] = []
        for m in manifests:
            if owner:
                m.setdefault("metadata", {})["ownerReferences"] = [owner]
            kind = m["kind"]
            ns = m["metadata"].get("namespace", "default")
            name = m["metadata"]["name"]
            desired_keys.add((kind, ns, name))
            try:
                self._apply_object(m, ops)
            except KubeApiError as e:
                # one rejected object must not block its siblings — record,
                # keep converging, surface in status, retry next resync
                apply_errors.append(f"{kind}/{name}: {e}")
                logger.warning("apply %s/%s %s/%s failed: %s",
                               kind, ns, name, dep.name, e)
        # prune: owned objects of this CR that the render no longer emits
        # (e.g. a predictor was removed -> its Deployment/Service must go)
        for kind in KIND_ROUTES:
            if kind in ("SeldonDeployment", "CustomResourceDefinition",
                        "Lease"):
                continue
            ns = cr.get("metadata", {}).get("namespace", "default")
            sel = f"seldon-deployment-id={dep.name},app.kubernetes.io/managed-by={MANAGED_BY}"
            try:
                existing = self.api.list(object_path(kind, ns), sel)
            except KubeApiError:
                continue  # API group absent (no istio) — nothing to prune
            for obj in existing:
                key = (kind, ns, obj["metadata"]["name"])
                if key not in desired_keys:
                    self.api.delete(object_path(kind, ns, obj["metadata"]["name"]))
                    ops["deleted"] += 1
        if apply_errors:
            # surfaced in ops too: --once CI mode exits nonzero on ANY
            # unconverged object, not just CR-level validation failures
            ops["failed"] = ops.get("failed", 0) + len(apply_errors)
            self._set_status(
                cr, "Creating",
                f"{len(apply_errors)} of {len(manifests)} objects failed: "
                + "; ".join(apply_errors[:3]),
            )
        else:
            self._set_status(cr, "Available", f"{len(manifests)} objects converged")
        return ops

    @staticmethod
    def _merge_for_put(desired: Any, live: Any) -> Any:
        """Desired state layered over the live object for a PUT: every
        rendered key wins, server-populated keys the render doesn't mention
        survive. A bare PUT of the rendered manifest would drop immutable
        server-set fields (Service spec.clusterIP, metadata.uid) and the
        apiserver would reject it with 422 — wedging drift repair."""
        if isinstance(desired, dict) and isinstance(live, dict):
            out = dict(live)
            for k, v in desired.items():
                out[k] = KubeController._merge_for_put(v, live.get(k))
            return out
        return desired

    def _apply_object(self, m: Dict[str, Any], ops: Dict[str, int]) -> None:
        kind = m["kind"]
        ns = m["metadata"].get("namespace", "default")
        name = m["metadata"]["name"]
        path = object_path(kind, ns, name)
        live = self.api.get(path)
        if live is None:
            self.api.create(object_path(kind, ns), m)
            ops["created"] += 1
            return
        if subset_equal(m, live):
            ops["unchanged"] += 1
            return
        self.api.replace(path, self._merge_for_put(m, live))
        ops["replaced"] += 1

    def _prune_orphans(self, live_ids: set, ops: Dict[str, int]) -> None:
        """Delete managed objects whose owning CR no longer exists — covers
        CR deletion on clusters without (or before) ownerRef GC. Looks in
        every namespace this controller has ever reconciled into, so the
        LAST CR of a namespace leaving still triggers cleanup there."""
        namespaces = {ns for ns, _ in live_ids} | set(self._known_namespaces)
        if self.namespace:
            namespaces.add(self.namespace)
        for kind in KIND_ROUTES:
            if kind in ("SeldonDeployment", "CustomResourceDefinition",
                        "Lease"):
                continue
            for ns in namespaces or {"default"}:
                try:
                    objs = self.api.list(
                        object_path(kind, ns),
                        f"app.kubernetes.io/managed-by={MANAGED_BY}",
                    )
                except KubeApiError:
                    continue
                for obj in objs:
                    dep_id = obj["metadata"].get("labels", {}).get(
                        "seldon-deployment-id"
                    )
                    if dep_id and (ns, dep_id) not in live_ids:
                        self.api.delete(
                            object_path(kind, ns, obj["metadata"]["name"])
                        )
                        ops["deleted"] += 1

    def _owner_ref(self, cr: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        meta = cr.get("metadata", {})
        if not meta.get("uid"):
            return None
        return {
            "apiVersion": f"{GROUP}/{VERSION}",
            "kind": "SeldonDeployment",
            "name": meta.get("name"),
            "uid": meta["uid"],
            "controller": True,
            "blockOwnerDeletion": True,
        }

    def _set_status(self, cr: Dict[str, Any], state: str, description: str) -> None:
        """Status rollup on the CR's /status subresource (reference:
        seldondeployment_controller.go:1111-1119)."""
        ns = cr.get("metadata", {}).get("namespace", "default")
        name = cr.get("metadata", {}).get("name")
        if not name:
            return
        body = dict(cr)
        body["status"] = {"state": state, "description": description}
        try:
            self.api.replace(
                object_path("SeldonDeployment", ns, name) + "/status", body
            )
        except KubeApiError as e:
            logger.debug("status update for %s/%s skipped: %s", ns, name, e)

    # -- loop ---------------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()  # wake the run loop immediately

    def run(self, iterations: Optional[int] = None) -> None:
        """Level-triggered control loop: reconcile everything, wait for a
        CR watch event OR the resync period, repeat. Watch events only
        shorten the wait — every pass is a full level-triggered reconcile,
        so a dropped event costs at most resync_s of staleness, never
        correctness (the reference gets the same property from
        controller-runtime's informers + periodic resync)."""
        self.install_crd()
        kick = self._kick
        watcher: Optional[threading.Thread] = None
        if hasattr(self.api, "watch"):
            def watch_loop() -> None:
                if self.namespace:
                    path = object_path("SeldonDeployment", self.namespace)
                else:
                    prefix, plural = KIND_ROUTES["SeldonDeployment"]
                    path = f"{prefix}/{plural}"
                failures = 0
                while not self._stop.is_set():
                    try:
                        for _event in self.api.watch(path):
                            kick.set()
                            failures = 0
                            if self._stop.is_set():
                                return
                        failures = 0  # clean window close
                    except Exception as e:  # noqa: BLE001 - watch is an
                        # accelerator; resync covers a broken stream. But a
                        # PERSISTENT failure (RBAC missing the watch verb)
                        # silently degrades reactivity — say so, once.
                        failures += 1
                        log = logger.warning if failures in (1, 10) else logger.debug
                        log("watch stream failed (x%d, falling back to %ss "
                            "resync): %s", failures, self.resync_s, e)
                        self._stop.wait(min(1.0 * failures, 30.0))

            watcher = threading.Thread(
                target=watch_loop, daemon=True, name="sdep-watch"
            )
            watcher.start()
        # leader election: ONE synchronous round up front (so a one-shot
        # `run(iterations=1)` reflects current leadership), then a
        # dedicated renewer thread — a reconcile pass longer than the
        # lease duration must never let the lease lapse mid-pass (client-go
        # renews on its own goroutine for the same reason)
        renew_stop = threading.Event()
        renewer: Optional[threading.Thread] = None
        if self.elector is not None:
            self.elector.try_acquire()

            def renew_loop() -> None:
                period = self.elector.lease_duration_s / 3.0
                while not renew_stop.is_set() and not self._stop.is_set():
                    renew_stop.wait(period)
                    if renew_stop.is_set() or self._stop.is_set():
                        return
                    try:
                        self.elector.try_acquire()
                    except Exception as e:  # noqa: BLE001 - election must
                        logger.warning("lease renew failed: %s", e)  # retry

            renewer = threading.Thread(
                target=renew_loop, daemon=True, name="lease-renew"
            )
            renewer.start()
        n = 0
        try:
            while not self._stop.is_set():
                # clear BEFORE reconciling: an event landing mid-pass must
                # wake the next wait instead of being erased after the pass
                kick.clear()
                if self.elector is not None and not self.elector.is_leader:
                    # follower: never writes; the renewer keeps polling the
                    # lease so takeover happens within ~one duration of the
                    # leader lapsing (reference: operator/main.go:49-93)
                    n += 1
                    if iterations is not None and n >= iterations:
                        return
                    self._stop.wait(
                        min(self.elector.lease_duration_s / 3.0, self.resync_s)
                    )
                    continue
                try:
                    ops = self.reconcile_all()
                    if any(ops[k] for k in ("created", "replaced", "deleted")):
                        logger.info("reconcile pass: %s", ops)
                except Exception as e:  # noqa: BLE001 - the loop must survive
                    logger.warning("reconcile pass failed: %s", e)
                n += 1
                if iterations is not None and n >= iterations:
                    return
                # woken early by a watch event or stop(); else the resync
                kick.wait(self.resync_s)
        finally:
            renew_stop.set()
