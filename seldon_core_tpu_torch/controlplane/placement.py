"""Device placement for the control plane: CUDA devices by component.

Counterpart of ``seldon_core_tpu/controlplane/placement.py``. The
reference schedules replicas as pods onto nodes and leaves placement to
the K8s scheduler (reference: operator/controllers/
seldondeployment_controller.go:855-900 createDeployments); here the
control plane counts device blocks itself: each engine takes a block of
the host's CUDA devices (one device unless the predictor asks for a
mesh), all-or-nothing, so a generation that does not fit is refused
before anything starts. The devices are ``torch.cuda.device_count()``
devices, all in process 0; a caller may pass its own device list.

As in the JAX package, a non-mesh engine is counted against its block
but not pinned to it: the child picks its device by its own default. A
mesh engine (sharded serving) gets a ``ServingMesh`` over its block
(``mesh_for``). A placement over CPU devices (the tests) makes CPU
meshes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence


class PlacementError(RuntimeError):
    pass


def _mesh_size(mesh_spec: Dict[str, int]) -> int:
    size = 1
    for v in mesh_spec.values():
        size *= int(v)
    return size


class DevicePlacement:
    """Tracks which devices are assigned to which component key."""

    def __init__(self, devices: Optional[Sequence[Any]] = None):
        self._devices = list(devices) if devices is not None else None
        self._assignments: Dict[str, List[Any]] = {}

    @property
    def devices(self) -> List[Any]:
        if self._devices is None:
            import torch

            self._devices = [
                torch.device("cuda", i) for i in range(torch.cuda.device_count())
            ]
        return self._devices

    def _free(self) -> List[Any]:
        used = {id(d) for devs in self._assignments.values() for d in devs}
        return [d for d in self.devices if id(d) not in used]

    def allocate(self, key: str, mesh_spec: Optional[Dict[str, int]]) -> List[Any]:
        """Reserve a device block for component `key`.

        mesh_spec None means "one device". Prefers a block fully inside one
        process; falls back to the smallest process span.
        """
        if key in self._assignments:
            return self._assignments[key]
        n = _mesh_size(mesh_spec) if mesh_spec else 1
        free = self._free()
        if len(free) < n:
            raise PlacementError(
                f"{key}: wants {n} devices, only {len(free)} free of {len(self.devices)}"
            )
        # group free devices by process, try to fit inside one
        by_proc: Dict[int, List[Any]] = {}
        for d in free:
            by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
        block: Optional[List[Any]] = None
        for procs_needed in range(1, len(by_proc) + 1):
            # greedy: largest processes first
            pools = sorted(by_proc.values(), key=len, reverse=True)[:procs_needed]
            pool = [d for p in pools for d in p]
            if len(pool) >= n:
                block = pool[:n]
                break
        if block is None:
            block = free[:n]
        self._assignments[key] = block
        return block

    def release(self, key: str) -> None:
        self._assignments.pop(key, None)

    def assigned(self, key: str) -> Optional[List[Any]]:
        return self._assignments.get(key)

    def mesh_for(self, key: str, mesh_spec: Dict[str, int]):
        """The ``ServingMesh`` of ``mesh_spec`` over the block allocated to
        ``key`` (allocated here when it is not yet), positions row-major
        over the block, as the JAX placement reshapes its devices."""
        from ..parallel.mesh import make_serving_mesh

        devs = self._assignments.get(key)
        if devs is None:
            devs = self.allocate(key, mesh_spec)
        n = _mesh_size(mesh_spec)
        if len(devs) != n:
            raise PlacementError(f"{key}: mesh {mesh_spec} wants {n} devices, have {len(devs)}")
        return make_serving_mesh(dict(mesh_spec), devices=list(devs))

    def capacity(self) -> Dict[str, int]:
        free = len(self._free())
        return {"total": len(self.devices), "free": free, "used": len(self.devices) - free}
