"""Inference-graph schema: PredictiveUnit tree + PredictorSpec.

Counterpart of ``seldon_core_tpu/graph/spec.py`` (schema parity with the
reference CRD graph types, reference: proto/seldon_deployment.proto:89-162
and operator/api/v1alpha2/seldondeployment_types.go:246-370): unit types
ROUTER/COMBINER/MODEL/TRANSFORMER/OUTPUT_TRANSFORMER, implementations
SIMPLE_MODEL/SIMPLE_ROUTER/RANDOM_ABTEST/AVERAGE_COMBINER/
RAG_PROMPT_BUILDER plus the prepackaged servers, typed parameters,
endpoints.

Defaulting + validation mirror the admission webhook
(reference: operator/api/v1alpha2/seldondeployment_webhook.go:137-411):
port allocation from 9000, endpoint host defaulting, graph/type inference,
modelUri required for prepackaged servers. The annotations of features
not ported to this package yet fail validation when they turn the
feature on.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional


class GraphSpecError(ValueError):
    pass


class UnitType(str, Enum):
    UNKNOWN_TYPE = "UNKNOWN_TYPE"
    ROUTER = "ROUTER"
    COMBINER = "COMBINER"
    MODEL = "MODEL"
    TRANSFORMER = "TRANSFORMER"
    OUTPUT_TRANSFORMER = "OUTPUT_TRANSFORMER"


# Prepackaged server implementations (reference:
# operator/controllers/seldondeployment_prepackaged_servers.go:30-176):
# the JAX package's eight. JAX_SERVER and GENERATE_SERVER run on the
# card; the others run on the host and raise a clear error on load when
# their library is missing.
PREPACKAGED_SERVERS = {
    "SKLEARN_SERVER": "seldon_core_tpu_torch.servers.sklearnserver.SKLearnServer",
    "XGBOOST_SERVER": "seldon_core_tpu_torch.servers.xgboostserver.XGBoostServer",
    "MLFLOW_SERVER": "seldon_core_tpu_torch.servers.mlflowserver.MLFlowServer",
    "TENSORFLOW_SERVER": "seldon_core_tpu_torch.servers.tfserver.TFServer",
    "JAX_SERVER": "seldon_core_tpu_torch.servers.torchserver.TorchServer",
    "GENERATE_SERVER": "seldon_core_tpu_torch.servers.generateserver.GenerateServer",
    "TRITON_SERVER": "seldon_core_tpu_torch.servers.trtserver.TRTServer",
    "SAGEMAKER_SERVER": "seldon_core_tpu_torch.servers.sagemakerserver.SageMakerServer",
}

FIRST_PORT = 9000
FIRST_GRPC_PORT = 9500


@dataclass
class Endpoint:
    # empty host means "not yet defaulted"; default_predictor fills it with
    # localhost (co-located) or the predictor-scoped DNS name (separate pods)
    service_host: str = ""
    service_port: int = 0
    grpc_port: int = 0
    transport: str = "INPROCESS"  # INPROCESS | REST | GRPC


@dataclass
class Parameter:
    name: str
    value: str
    type: str = "STRING"


@dataclass
class PredictiveUnit:
    name: str
    type: Optional[UnitType] = None
    implementation: Optional[str] = None
    children: List["PredictiveUnit"] = field(default_factory=list)
    endpoint: Endpoint = field(default_factory=Endpoint)
    parameters: List[Parameter] = field(default_factory=list)
    model_uri: Optional[str] = None
    service_account: Optional[str] = None
    # explicit method set override (reference: PredictiveUnitState methods)
    methods: Optional[List[str]] = None

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PredictiveUnit":
        if "name" not in d:
            raise GraphSpecError("graph node missing name")
        ep = d.get("endpoint") or {}
        return PredictiveUnit(
            name=d["name"],
            type=UnitType(d["type"]) if d.get("type") else None,
            implementation=d.get("implementation"),
            children=[PredictiveUnit.from_dict(c) for c in d.get("children", [])],
            endpoint=Endpoint(
                service_host=ep.get("service_host", ep.get("serviceHost", "")),
                service_port=int(ep.get("service_port", ep.get("servicePort", 0))),
                grpc_port=int(ep.get("grpc_port", ep.get("grpcPort", 0))),
                transport=ep.get("transport", ep.get("type", "INPROCESS")).replace("GRPC", "GRPC"),
            ),
            parameters=[
                Parameter(p["name"], str(p["value"]), p.get("type", "STRING"))
                for p in d.get("parameters", [])
            ],
            model_uri=d.get("modelUri") or d.get("model_uri"),
            service_account=d.get("serviceAccountName"),
            methods=d.get("methods"),
        )


@dataclass
class PredictorSpec:
    name: str
    graph: PredictiveUnit
    replicas: int = 1
    # 0, not 100: the reference CRD's Traffic is omitempty (defaults 0) so
    # shadow predictors and single-predictor manifests may omit it
    # (reference: seldondeployment_types.go PredictorSpec.Traffic,
    # seldondeployment_webhook.go:372-386 checkTraffic)
    traffic: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    # device mesh this predictor wants, e.g. {"data": 1, "model": 8}
    # (sharded serving: not ported yet, refused by engine_main)
    tpu_mesh: Optional[Dict[str, int]] = None
    # autoscaling (reference CRD HpaSpec, seldon_deployment.proto /
    # seldondeployment_types.go + createHpas controller.go:805): the
    # scaling metric is in-flight concurrency per replica —
    # {"minReplicas": 1, "maxReplicas": 4, "targetConcurrency": 8}
    hpa_spec: Optional[Dict[str, Any]] = None

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PredictorSpec":
        if "graph" not in d:
            raise GraphSpecError(f"predictor {d.get('name')!r} missing graph")
        return PredictorSpec(
            name=d.get("name", "default"),
            graph=PredictiveUnit.from_dict(d["graph"]),
            replicas=int(d.get("replicas", 1)),
            traffic=int(d.get("traffic", 0)),
            labels=d.get("labels", {}),
            annotations=d.get("annotations", {}),
            tpu_mesh=d.get("tpuMesh") or d.get("tpu_mesh"),
            hpa_spec=d.get("hpaSpec") or d.get("hpa_spec"),
        )

    @staticmethod
    def from_env_b64(blob: str) -> "PredictorSpec":
        """Decode the base64 JSON the scheduler injects, like the engine's
        ENGINE_PREDICTOR env (reference: engine/.../EnginePredictor.java:58-108)."""
        return PredictorSpec.from_dict(json.loads(base64.b64decode(blob)))


# ---------------------------------------------------------------------------
# Defaulting (webhook parity:
# operator/api/v1alpha2/seldondeployment_webhook.go:137-338)
# ---------------------------------------------------------------------------


def default_predictor(spec: PredictorSpec, separate_pods: bool = False) -> PredictorSpec:
    """Fill in types, implementations and ports.

    * infer type from implementation for builtin units
    * prepackaged servers: inject implementation class parameter + model_uri
    * allocate REST ports from 9000 / gRPC from 9500 in graph walk order
      (reference: seldondeployment_webhook.go:139-150)
    * endpoint host defaults: localhost when co-located, predictor-scoped
      DNS name when separate (reference: webhook.go:211-217,285-295)
    """
    port, grpc_port = FIRST_PORT, FIRST_GRPC_PORT
    for unit in spec.graph.walk():
        if unit.type is None:
            impl = unit.implementation or ""
            if impl == "SIMPLE_MODEL" or impl in PREPACKAGED_SERVERS:
                unit.type = UnitType.MODEL
            elif impl in ("SIMPLE_ROUTER", "RANDOM_ABTEST"):
                unit.type = UnitType.ROUTER
            elif impl == "AVERAGE_COMBINER":
                unit.type = UnitType.COMBINER
            elif impl == "RAG_PROMPT_BUILDER":
                unit.type = UnitType.TRANSFORMER
            else:
                unit.type = UnitType.MODEL
        if unit.endpoint.service_port == 0:
            unit.endpoint.service_port = port
            port += 1
        if unit.endpoint.grpc_port == 0:
            unit.endpoint.grpc_port = grpc_port
            grpc_port += 1
        if unit.endpoint.service_host in ("", None):
            unit.endpoint.service_host = (
                f"{spec.name}-{unit.name}" if separate_pods else "localhost"
            )
    return spec


def parse_hpa_spec(hpa: Dict[str, Any], who: str = "?") -> "tuple[int, int, float]":
    """Parse + validate an hpaSpec into (minReplicas, maxReplicas,
    targetConcurrency). The ONE parser shared by admission validation and
    the autoscaler, so defaults can't drift. Raises GraphSpecError on any
    malformed field."""
    import math as _math

    try:
        lo = int(hpa.get("minReplicas", 1))
        hi = int(hpa.get("maxReplicas", lo))
        target = float(hpa.get("targetConcurrency", 0))
    except (TypeError, ValueError) as e:
        raise GraphSpecError(f"{who}: malformed hpaSpec field: {e}") from e
    if lo < 1 or hi < lo:
        raise GraphSpecError(
            f"{who}: hpaSpec needs 1 <= minReplicas <= maxReplicas, got {lo}..{hi}"
        )
    if not _math.isfinite(target) or target <= 0:
        raise GraphSpecError(
            f"{who}: hpaSpec.targetConcurrency must be a finite number > 0, "
            f"got {target}"
        )
    return lo, hi, target


# graph fusion (``graph/fusion.py``): opt-in flag running chains of
# co-resident in-process units as one device segment
ANNOTATION_FUSE = "seldon.io/fuse"


def parse_fuse_annotation(spec: PredictorSpec) -> bool:
    """Strict-at-apply parse of ``seldon.io/fuse``: only "true"/"false"
    (any case) are meaningful; a typo'd value means the operator
    believes fusion is on, so it fails the apply instead of silently
    serving hop-by-hop."""
    raw = (spec.annotations or {}).get(ANNOTATION_FUSE)
    if raw is None:
        return False
    val = str(raw).strip().lower()
    if val not in ("true", "false"):
        raise GraphSpecError(
            f"predictor {spec.name!r}: {ANNOTATION_FUSE} must be "
            f'"true" or "false", got {raw!r}'
        )
    return val == "true"


# Predictor annotations of the JAX engine whose feature is not ported to
# this package yet, with the values that leave the feature off
# (disaggregated serving, the host KV tier, sharded serving,
# multi-tenant paging, the autonomic planner)
NOT_PORTED_ANNOTATIONS = {
    "seldon.io/disagg": ("false",),
    "seldon.io/disagg-prefill-replicas": (),
    "seldon.io/disagg-decode-replicas": (),
    "seldon.io/kv-tier-bytes": ("0",),
    "seldon.io/mesh": (),
    "seldon.io/tenants": (),
    "seldon.io/planner": ("false",),
    "seldon.io/planner-profile": (),
}


def check_not_ported_annotations(spec: PredictorSpec) -> None:
    """Raise for an annotation of an unported feature set to anything but
    its off value: validated-then-ignored would leave the operator
    believing the feature is on."""
    for key, off in NOT_PORTED_ANNOTATIONS.items():
        raw = (spec.annotations or {}).get(key)
        if raw is None or str(raw).strip().lower() in off:
            continue
        raise GraphSpecError(
            f"predictor {spec.name!r}: annotation {key}={raw!r} is not ported "
            "to seldon_core_tpu_torch yet"
        )


def validate_predictor(spec: PredictorSpec) -> None:
    """Reference checks: seldondeployment_webhook.go:388-411."""
    if spec.replicas < 0:
        raise GraphSpecError(
            f"predictor {spec.name!r}: negative replicas {spec.replicas}"
        )
    names = [u.name for u in spec.graph.walk()]
    if len(names) != len(set(names)):
        raise GraphSpecError(f"duplicate unit names in graph: {names}")
    for unit in spec.graph.walk():
        if unit.implementation in PREPACKAGED_SERVERS and not unit.model_uri:
            raise GraphSpecError(
                f"unit {unit.name}: modelUri is required for {unit.implementation}"
            )
        if unit.type == UnitType.COMBINER and not unit.children:
            raise GraphSpecError(f"combiner {unit.name} has no children")
        if unit.type == UnitType.ROUTER and not unit.children:
            raise GraphSpecError(f"router {unit.name} has no children")
    if spec.hpa_spec is not None:
        parse_hpa_spec(spec.hpa_spec, who=spec.name)
    parse_fuse_annotation(spec)
    check_not_ported_annotations(spec)

