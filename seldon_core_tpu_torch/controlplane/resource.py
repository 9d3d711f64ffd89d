"""SeldonDeployment resource: the deployment-level config surface.

Counterpart of ``seldon_core_tpu/controlplane/resource.py``.

Schema parity with the reference CRD (reference:
proto/seldon_deployment.proto:12-88 — SeldonDeployment{metadata, spec{
name, predictors[], annotations, oauth...}, status{state, description,
predictorStatus[]}}; Go mirror operator/api/v1alpha2/
seldondeployment_types.go:246-370). Accepts both k8s-manifest style
(apiVersion/kind/metadata/spec) and flat dicts.
"""

from __future__ import annotations

import copy
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..graph.spec import GraphSpecError, PredictorSpec

STATE_CREATING = "Creating"
STATE_AVAILABLE = "Available"
STATE_FAILED = "Failed"


@dataclass
class PredictorStatus:
    """Per-predictor rollup (reference: seldon_deployment.proto:72-80)."""

    name: str
    replicas: int = 0
    replicas_available: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "replicas": self.replicas,
            "replicasAvailable": self.replicas_available,
        }


@dataclass
class DeploymentStatus:
    """Status rollup written by the reconciler (reference:
    seldondeployment_controller.go:1111-1119 Available/Creating)."""

    state: str = STATE_CREATING
    description: str = ""
    predictor_status: List[PredictorStatus] = field(default_factory=list)
    # progressive-delivery checkpoint (rollout/controller.py): status
    # writes skip the generation bump, so the rollout state machine can
    # durably record its resume point — after a control-plane restart a
    # mid-ramp rollout keeps its TRUE pre-rollout baseline weights and a
    # promoted/rolled-back one stays terminal instead of re-ramping
    rollout: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        out = {
            "state": self.state,
            "description": self.description,
            "predictorStatus": [p.to_dict() for p in self.predictor_status],
        }
        if self.rollout is not None:
            out["rollout"] = self.rollout
        return out

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DeploymentStatus":
        return DeploymentStatus(
            state=d.get("state", STATE_CREATING),
            description=d.get("description", ""),
            predictor_status=[
                PredictorStatus(
                    name=p["name"],
                    replicas=int(p.get("replicas", 0)),
                    replicas_available=int(p.get("replicasAvailable", 0)),
                )
                for p in d.get("predictorStatus", [])
            ],
            rollout=d.get("rollout"),
        )


@dataclass
class SeldonDeployment:
    name: str
    predictors: List[PredictorSpec]
    namespace: str = "default"
    annotations: Dict[str, str] = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    protocol: str = "seldon"
    generation: int = 1
    status: DeploymentStatus = field(default_factory=DeploymentStatus)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SeldonDeployment":
        if "spec" in d:  # k8s-manifest style
            meta = d.get("metadata") or {}
            spec = d["spec"]
            name = spec.get("name") or meta.get("name")
            namespace = meta.get("namespace", "default")
            annotations = {**(meta.get("annotations") or {}), **(spec.get("annotations") or {})}
            labels = meta.get("labels") or {}
        else:
            spec = d
            name = d.get("name")
            namespace = d.get("namespace", "default")
            annotations = d.get("annotations") or {}
            labels = d.get("labels") or {}
        if not name:
            raise GraphSpecError("deployment missing name")
        predictors = [PredictorSpec.from_dict(p) for p in spec.get("predictors", [])]
        if not predictors:
            raise GraphSpecError(f"deployment {name!r} has no predictors")
        return SeldonDeployment(
            name=name,
            namespace=namespace,
            predictors=predictors,
            annotations=annotations,
            labels=labels,
            protocol=spec.get("protocol", "seldon"),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "apiVersion": "machinelearning.seldon.io/v1alpha2",
            "kind": "SeldonDeployment",
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "annotations": self.annotations,
                "labels": self.labels,
                "generation": self.generation,
            },
            "spec": {
                "name": self.name,
                "protocol": self.protocol,
                "predictors": [p.to_dict() for p in self.predictors],
            },
            "status": self.status.to_dict(),
        }

    def spec_hash(self, include_replicas: bool = True) -> str:
        """Stable digest of the spec (not metadata/status) used by the
        reconciler's change diff, like the operator's JSON-equality check
        (reference: seldondeployment_controller.go:842-853 jsonEquals).

        ``include_replicas=False`` gives the component-naming variant: a
        scale event must not rename (and so recreate) surviving replica
        components, only add/remove. Traffic weights are excluded there
        too — a canary ramp step (rollout controller rewriting
        ``PredictorSpec.traffic``) re-routes the gateway, it must never
        restart an engine mid-rollout."""
        import hashlib

        preds = [p.to_dict() for p in self.predictors]
        if not include_replicas:
            preds = [{**p, "replicas": None, "traffic": None} for p in preds]
            # disagg pool sizes are replica counts too: scaling the
            # prefill or decode pool must add/remove pool members, never
            # rename (and so restart) the survivors
            scale_keys = (
                "seldon.io/disagg-prefill-replicas",
                "seldon.io/disagg-decode-replicas",
            )
            preds = [
                {
                    **p,
                    "annotations": {
                        k: v
                        for k, v in (p.get("annotations") or {}).items()
                        if k not in scale_keys
                    },
                }
                for p in preds
            ]
        blob = json.dumps(
            {"protocol": self.protocol, "predictors": preds},
            sort_keys=True,
        )
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def clone(self) -> "SeldonDeployment":
        return copy.deepcopy(self)

    def predictor(self, name: str) -> Optional[PredictorSpec]:
        for p in self.predictors:
            if p.name == name:
                return p
        return None
