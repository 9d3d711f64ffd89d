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
modelUri required for prepackaged servers, traffic weights sum to 100,
duplicate predictor names rejected, and the feature annotations parsed
strictly at apply (disagg pools, the host KV tier, tenants, the
planner, graph fusion). Sharded serving (``seldon.io/mesh``, a
predictor ``tpuMesh``) is not ported yet and refuses.
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


class UnitImplementation(str, Enum):
    UNKNOWN_IMPLEMENTATION = "UNKNOWN_IMPLEMENTATION"
    SIMPLE_MODEL = "SIMPLE_MODEL"
    SIMPLE_ROUTER = "SIMPLE_ROUTER"
    RANDOM_ABTEST = "RANDOM_ABTEST"
    AVERAGE_COMBINER = "AVERAGE_COMBINER"


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

    def to_dict(self) -> Dict[str, str]:
        return {"name": self.name, "value": str(self.value), "type": self.type}


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

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name}
        if self.type:
            out["type"] = self.type.value
        if self.implementation:
            out["implementation"] = self.implementation
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        if self.parameters:
            out["parameters"] = [p.to_dict() for p in self.parameters]
        if self.model_uri:
            out["modelUri"] = self.model_uri
        out["endpoint"] = {
            "service_host": self.endpoint.service_host,
            "service_port": self.endpoint.service_port,
            "grpc_port": self.endpoint.grpc_port,
            "transport": self.endpoint.transport,
        }
        return out


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
    # (sharded serving: not ported yet, refused by engine_main and the
    # control plane)
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

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "graph": self.graph.to_dict(),
            "replicas": self.replicas,
            "traffic": self.traffic,
            "labels": self.labels,
            "annotations": self.annotations,
            **({"tpuMesh": self.tpu_mesh} if self.tpu_mesh else {}),
            **({"hpaSpec": self.hpa_spec} if self.hpa_spec else {}),
        }

    @staticmethod
    def from_env_b64(blob: str) -> "PredictorSpec":
        """Decode the base64 JSON the scheduler injects, like the engine's
        ENGINE_PREDICTOR env (reference: engine/.../EnginePredictor.java:58-108)."""
        return PredictorSpec.from_dict(json.loads(base64.b64decode(blob)))

    def to_env_b64(self) -> str:
        return base64.b64encode(json.dumps(self.to_dict()).encode()).decode()


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
            if impl in ("SIMPLE_MODEL",) or impl in PREPACKAGED_SERVERS:
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


# disaggregated generate serving (docs/generate.md "Disaggregated
# serving"): the annotation splits a GENERATE_SERVER predictor into a
# prefill pool and a decode pool with a KV-slab handoff between them
ANNOTATION_DISAGG = "seldon.io/disagg"
ANNOTATION_DISAGG_PREFILL_REPLICAS = "seldon.io/disagg-prefill-replicas"
ANNOTATION_DISAGG_DECODE_REPLICAS = "seldon.io/disagg-decode-replicas"


def parse_disagg_annotations(spec: PredictorSpec) -> "Optional[tuple]":
    """``(prefill_replicas, decode_replicas)`` when the predictor opts
    into disaggregated serving, None otherwise. The ONE parser shared by
    admission validation and the reconciler's pool splitting, strict at
    apply time: a disagg predictor must be a single-node
    GENERATE_SERVER graph and the per-pool replica counts must be
    positive integers."""
    ann = spec.annotations or {}
    if str(ann.get(ANNOTATION_DISAGG, "false")).lower() != "true":
        return None
    root = spec.graph
    if root.children or root.implementation != "GENERATE_SERVER":
        raise GraphSpecError(
            f"predictor {spec.name!r}: {ANNOTATION_DISAGG} needs a "
            "single-node GENERATE_SERVER graph (prefill/decode pools "
            "split one generate unit)"
        )
    for unit in root.walk():
        for p in unit.parameters:
            if p.name in ("role", "peer", "kv_port"):
                raise GraphSpecError(
                    f"predictor {spec.name!r}: {ANNOTATION_DISAGG} owns "
                    f"the {p.name!r} parameter — drop it from the graph "
                    "(the reconciler assigns roles per pool)"
                )
    try:
        prefill = int(ann.get(ANNOTATION_DISAGG_PREFILL_REPLICAS, 1))
        decode = int(
            ann.get(ANNOTATION_DISAGG_DECODE_REPLICAS, max(1, spec.replicas))
        )
    except (TypeError, ValueError) as e:
        raise GraphSpecError(
            f"predictor {spec.name!r}: malformed disagg replica "
            f"annotation: {e}"
        ) from e
    if prefill < 1 or decode < 1:
        raise GraphSpecError(
            f"predictor {spec.name!r}: disagg pools need >= 1 replica "
            f"each, got prefill={prefill} decode={decode}"
        )
    return prefill, decode


# graph fusion (``graph/fusion.py``): opt-in flag running chains of
# co-resident in-process units as one device segment
ANNOTATION_FUSE = "seldon.io/fuse"


def parse_fuse_annotation(spec: PredictorSpec) -> bool:
    """Strict-at-apply parse of ``seldon.io/fuse``: only "true"/"false"
    (any case) are meaningful — a typo'd value means the operator
    believes fusion is on, so it fails the apply instead of silently
    serving hop-by-hop."""
    ann = spec.annotations or {}
    raw = ann.get(ANNOTATION_FUSE)
    if raw is None:
        return False
    val = str(raw).strip().lower()
    if val not in ("true", "false"):
        raise GraphSpecError(
            f"predictor {spec.name!r}: {ANNOTATION_FUSE} must be "
            f'"true" or "false", got {raw!r}'
        )
    return val == "true"


# tiered KV memory (docs/generate.md "Tiered KV memory"): byte budget
# of the generate scheduler's pinned host-RAM KV spill tier
ANNOTATION_KV_TIER_BYTES = "seldon.io/kv-tier-bytes"


def parse_kv_tier_annotation(spec: PredictorSpec) -> "Optional[int]":
    """The ``seldon.io/kv-tier-bytes`` byte budget when the predictor
    opts into the host KV tier, None otherwise. The ONE parser shared
    by admission validation and the reconciler's parameter injection,
    strict at apply time: the graph must contain a GENERATE_SERVER unit
    (the tier is a generate-scheduler subsystem), the value must be a
    non-negative integer, and the graph must not also set the
    ``host_kv_tier_bytes`` parameter by hand (the annotation owns it —
    two sources of truth for one budget is how operators get neither)."""
    ann = spec.annotations or {}
    raw = ann.get(ANNOTATION_KV_TIER_BYTES)
    if raw is None:
        return None
    try:
        tier_bytes = int(str(raw).strip())
    except (TypeError, ValueError) as e:
        raise GraphSpecError(
            f"predictor {spec.name!r}: malformed {ANNOTATION_KV_TIER_BYTES} "
            f"annotation {raw!r}: {e}"
        ) from e
    if tier_bytes < 0:
        raise GraphSpecError(
            f"predictor {spec.name!r}: {ANNOTATION_KV_TIER_BYTES} must be "
            f">= 0, got {tier_bytes}"
        )
    gen_units = [
        u for u in spec.graph.walk()
        if u.implementation == "GENERATE_SERVER"
    ]
    if not gen_units:
        raise GraphSpecError(
            f"predictor {spec.name!r}: {ANNOTATION_KV_TIER_BYTES} needs a "
            "GENERATE_SERVER unit (the KV tier is a generate-scheduler "
            "subsystem)"
        )
    for unit in gen_units:
        for p in unit.parameters:
            if p.name == "host_kv_tier_bytes":
                raise GraphSpecError(
                    f"predictor {spec.name!r}: {ANNOTATION_KV_TIER_BYTES} "
                    "owns the 'host_kv_tier_bytes' parameter — drop it "
                    "from the graph (the reconciler injects it per member)"
                )
    return tier_bytes


# sharded serving (docs/generate.md "Sharded serving"): the mesh shape
# a generate predictor's engines partition ONE model replica across
ANNOTATION_MESH = "seldon.io/mesh"


def parse_mesh_annotation(spec: PredictorSpec) -> "Optional[Dict[str, int]]":
    """The ``seldon.io/mesh`` shape (``"data=2,model=4"``) when the
    predictor opts into sharded serving, None otherwise. The ONE parser
    shared by admission validation and the reconciler's placement path,
    strict at apply time: axis=size pairs only (typed
    ``parallel.mesh.MeshShapeError`` surfaces as a GraphSpecError), the
    graph must contain a GENERATE_SERVER unit (the mesh partitions the
    generate model + KV cache), and the spec must not also set
    ``tpuMesh`` by hand (the annotation owns the shape — two sources of
    truth for one mesh is how operators get neither)."""
    ann = spec.annotations or {}
    raw = ann.get(ANNOTATION_MESH)
    if raw is None:
        return None
    from ..parallel.mesh import MeshShapeError, parse_mesh_shape

    try:
        shape = parse_mesh_shape(str(raw))
    except MeshShapeError as e:
        raise GraphSpecError(
            f"predictor {spec.name!r}: malformed {ANNOTATION_MESH} "
            f"annotation {raw!r}: {e}"
        ) from e
    gen_units = [
        u for u in spec.graph.walk()
        if u.implementation == "GENERATE_SERVER"
    ]
    if not gen_units:
        raise GraphSpecError(
            f"predictor {spec.name!r}: {ANNOTATION_MESH} needs a "
            "GENERATE_SERVER unit (the mesh partitions the generate "
            "model and its KV cache)"
        )
    if spec.tpu_mesh:
        raise GraphSpecError(
            f"predictor {spec.name!r}: {ANNOTATION_MESH} owns the mesh "
            "shape — drop the explicit tpuMesh field (two sources of "
            "truth for one mesh)"
        )
    return shape


def inject_kv_tier_param(spec_dict: Dict, tier_bytes: int) -> Dict:
    """Append ``host_kv_tier_bytes`` to every GENERATE_SERVER node of a
    predictor-spec dict (the reconciler's injection half of the
    annotation contract). Mutates and returns ``spec_dict``."""

    def visit(node: Dict) -> None:
        if node.get("implementation") == "GENERATE_SERVER":
            params = list(node.get("parameters") or [])
            params.append({
                "name": "host_kv_tier_bytes",
                "value": str(int(tier_bytes)),
                "type": "STRING",
            })
            node["parameters"] = params
        for child in node.get("children") or []:
            visit(child)

    visit(spec_dict["graph"])
    return spec_dict


# multi-tenant serving (docs/generate.md "Multi-tenant serving"): the
# tenant roster a generate predictor's weight pager multiplexes —
# name=slo_class[@model_uri] CSV, first tenant boots resident
ANNOTATION_TENANTS = "seldon.io/tenants"


def parse_tenants_annotation(
    spec: PredictorSpec,
) -> "Optional[List[tuple]]":
    """The parsed ``seldon.io/tenants`` roster when the predictor opts
    into multi-tenant paging, None otherwise. The ONE parser shared by
    admission validation and the reconciler's parameter injection,
    strict at apply time: the grammar itself is delegated to
    ``serving.weightpager.parse_tenant_spec`` (a typo'd SLO class or a
    duplicate tenant fails the apply, not the member boot), the graph
    must contain a GENERATE_SERVER unit (the pager is a
    generate-scheduler subsystem), and the graph must not also set the
    ``tenants`` parameter by hand (the annotation owns the roster —
    two sources of truth for one tenant list is how operators get
    neither)."""
    ann = spec.annotations or {}
    raw = ann.get(ANNOTATION_TENANTS)
    if raw is None:
        return None
    from ..serving.weightpager import parse_tenant_spec

    try:
        roster = parse_tenant_spec(str(raw))
    except ValueError as e:
        raise GraphSpecError(
            f"predictor {spec.name!r}: malformed {ANNOTATION_TENANTS} "
            f"annotation {raw!r}: {e}"
        ) from e
    gen_units = [
        u for u in spec.graph.walk()
        if u.implementation == "GENERATE_SERVER"
    ]
    if not gen_units:
        raise GraphSpecError(
            f"predictor {spec.name!r}: {ANNOTATION_TENANTS} needs a "
            "GENERATE_SERVER unit (the weight pager is a "
            "generate-scheduler subsystem)"
        )
    for unit in gen_units:
        for p in unit.parameters:
            if p.name == "tenants":
                raise GraphSpecError(
                    f"predictor {spec.name!r}: {ANNOTATION_TENANTS} owns "
                    "the 'tenants' parameter — drop it from the graph "
                    "(the reconciler injects it per member)"
                )
    return roster


# autonomic planning (docs/operate.md "Autonomic planning"): opt the
# predictor into the reconciler's planner tick, optionally pointing it
# at an SPF1 serving-profile artifact for the cost model
ANNOTATION_PLANNER = "seldon.io/planner"
ANNOTATION_PLANNER_PROFILE = "seldon.io/planner-profile"


def parse_planner_annotations(
    spec: PredictorSpec,
) -> "Optional[Dict[str, Any]]":
    """``{"enabled": bool, "profile": Optional[str]}`` when the
    predictor carries planner annotations, None otherwise. The ONE
    parser shared by admission validation and the reconciler's planner
    tick, strict at apply time: ``seldon.io/planner`` takes only
    "true"/"false" (a typo'd value means the operator believes the
    loop is closed, so it fails the apply instead of silently serving
    hand-tuned), ``seldon.io/planner-profile`` requires the planner to
    be enabled (an orphan profile path is the same operator error),
    and the graph must contain a GENERATE_SERVER unit (every knob the
    planner actuates is a generate-scheduler knob)."""
    ann = spec.annotations or {}
    raw = ann.get(ANNOTATION_PLANNER)
    profile = ann.get(ANNOTATION_PLANNER_PROFILE)
    if raw is None:
        if profile is not None:
            raise GraphSpecError(
                f"predictor {spec.name!r}: {ANNOTATION_PLANNER_PROFILE} "
                f"without {ANNOTATION_PLANNER}: \"true\" — an orphan "
                "profile closes no loop"
            )
        return None
    val = str(raw).strip().lower()
    if val not in ("true", "false"):
        raise GraphSpecError(
            f"predictor {spec.name!r}: {ANNOTATION_PLANNER} must be "
            f'"true" or "false", got {raw!r}'
        )
    enabled = val == "true"
    if profile is not None and not enabled:
        raise GraphSpecError(
            f"predictor {spec.name!r}: {ANNOTATION_PLANNER_PROFILE} "
            f"set while {ANNOTATION_PLANNER} is \"false\""
        )
    if enabled and not any(
        u.implementation == "GENERATE_SERVER" for u in spec.graph.walk()
    ):
        raise GraphSpecError(
            f"predictor {spec.name!r}: {ANNOTATION_PLANNER} needs a "
            "GENERATE_SERVER unit (the planner actuates "
            "generate-scheduler knobs)"
        )
    return {
        "enabled": enabled,
        "profile": str(profile).strip() if profile is not None else None,
    }


def inject_tenants_param(spec_dict: Dict, tenants: str) -> Dict:
    """Append ``tenants`` to every GENERATE_SERVER node of a
    predictor-spec dict (the reconciler's injection half of the
    annotation contract). Mutates and returns ``spec_dict``."""

    def visit(node: Dict) -> None:
        if node.get("implementation") == "GENERATE_SERVER":
            params = list(node.get("parameters") or [])
            params.append({
                "name": "tenants",
                "value": str(tenants),
                "type": "STRING",
            })
            node["parameters"] = params
        for child in node.get("children") or []:
            visit(child)

    visit(spec_dict["graph"])
    return spec_dict


# Predictor annotations of the JAX engine whose feature is not ported to
# this package yet, with the values that leave the feature off (sharded
# serving)
NOT_PORTED_ANNOTATIONS = {
    "seldon.io/mesh": (),
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
    # sharded serving is not ported: its annotation refuses before the
    # JAX package's checks run
    check_not_ported_annotations(spec)
    # disagg annotations parse strictly at admission (same policy as
    # rollout annotations): a typo'd pool size or a multi-node disagg
    # graph fails the apply, not the reconcile
    parse_disagg_annotations(spec)
    # kv-tier annotation: same strict-at-apply policy (a typo'd budget
    # or a tier on a non-generate graph fails the apply)
    parse_kv_tier_annotation(spec)
    # fuse annotation: strict-at-apply (a typo'd value must not silently
    # serve hop-by-hop while the operator believes fusion is on)
    parse_fuse_annotation(spec)
    # mesh annotation: strict-at-apply (a malformed shape must refuse
    # the apply, never surface as an opaque failure at member boot)
    parse_mesh_annotation(spec)
    # tenants annotation: strict-at-apply (a typo'd SLO class must not
    # misroute a tenant's traffic at serve time)
    parse_tenants_annotation(spec)
    # planner annotations: strict-at-apply (a typo'd flag must not
    # leave the operator believing the serving loop is closed)
    parse_planner_annotations(spec)


def validate_deployment(predictors: List[PredictorSpec]) -> None:
    names = [p.name for p in predictors]
    if len(names) != len(set(names)):
        raise GraphSpecError(f"duplicate predictor names: {names}")
    # shadow predictors carry no traffic weight (they receive mirrored
    # traffic, not routed traffic) — exclude them from the sum, mirroring
    # the ambassador/istio weight handling (reference: ambassador.go
    # shadow mappings; checkTraffic seldondeployment_webhook.go:372-386)
    live = [p for p in predictors if p.annotations.get("seldon.io/shadow", "false") != "true"]
    # a shadow carrying a weight is a manifest typo, not a routing choice:
    # silently excluding it from the 100-sum (the old behavior) hid e.g. a
    # canary manifest where the shadow flag was left on the 10% predictor
    for p in predictors:
        if p.annotations.get("seldon.io/shadow", "false") == "true" and p.traffic:
            raise GraphSpecError(
                f"shadow predictor {p.name!r} must not carry a traffic "
                f"weight (got {p.traffic}); shadows receive mirrored "
                "traffic only — drop the weight or the seldon.io/shadow "
                "annotation"
            )
    total = sum(p.traffic for p in live)
    if len(live) > 1 and total != 100:
        raise GraphSpecError(f"traffic weights must sum to 100, got {total}")
    if len(live) == 1 and total not in (0, 100):
        raise GraphSpecError(f"traffic must be 100 for a single predictor when set, got {total}")
    # rollout annotations parse strictly at admission, like the traffic
    # sum: a typo'd gate or step list must fail the apply, not silently
    # log-and-skip at controller tick time (rollout/plan.py docstring).
    # Late import: rollout.plan imports this module at load time.
    if any("seldon.io/rollout" in (p.annotations or {}) for p in predictors):
        from ..rollout.plan import plan_from_predictors

        plan_from_predictors(predictors)
    for p in predictors:
        validate_predictor(p)
