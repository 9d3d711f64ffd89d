"""Control plane: declarative SeldonDeployment resources reconciled onto
local runtimes on a CUDA host.

Counterpart of ``seldon_core_tpu/controlplane`` and of the reference's
Go operator stack
(reference: operator/main.go:49-93, operator/controllers/
seldondeployment_controller.go:253-1199): a resource store stands in for
the K8s API server, an admission step mirrors the defaulting/validating
webhook, and the reconciler materializes engines + microservice processes
(instead of Deployments/Services) with device placement over the
host's CUDA devices instead of node-pool scheduling. The operator side
for a Kubernetes cluster is here too: ``k8s.py`` renders the objects (one
``nvidia.com/gpu`` for an engine whose units run on the card) and
``kube.py`` installs the CRD and converges a live cluster onto its
SeldonDeployments. Sharded serving (``seldon.io/mesh``, a ``tpuMesh``)
places a block of devices per engine and serves one model replica split
over it.
"""

from .resource import DeploymentStatus, SeldonDeployment
from .store import ResourceStore
from .placement import DevicePlacement, PlacementError
from .reconciler import DeploymentController
from .ingress import Gateway

__all__ = [
    "SeldonDeployment",
    "DeploymentStatus",
    "ResourceStore",
    "DevicePlacement",
    "PlacementError",
    "DeploymentController",
    "Gateway",
]
