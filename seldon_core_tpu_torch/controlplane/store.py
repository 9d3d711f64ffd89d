"""Resource store: the control plane's stand-in for the K8s API server.

Counterpart of ``seldon_core_tpu/controlplane/store.py`` (the same
generations, watch events and on-disk layout).

Apply/get/list/delete with generation bumps on spec change, async watch
streams feeding the reconciler (reference: controller-runtime watches with
owner references, operator/controllers/seldondeployment_controller.go:
1129-1199), and optional JSON-file persistence so `sdctl` CLI invocations
and a long-running controller share state.
"""

from __future__ import annotations

import asyncio
import contextlib
import fcntl
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from .resource import SeldonDeployment

EVENT_ADDED = "ADDED"
EVENT_MODIFIED = "MODIFIED"
EVENT_DELETED = "DELETED"


class ResourceStore:
    def __init__(self, persist_dir: Optional[str] = None):
        self._items: Dict[str, SeldonDeployment] = {}
        self._lock = threading.Lock()
        self._watchers: List[asyncio.Queue] = []
        self._persist_dir = persist_dir
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)
            self._load()

    # -- persistence --------------------------------------------------------

    def _path(self, key: str) -> str:
        assert self._persist_dir
        return os.path.join(self._persist_dir, key.replace("/", "__") + ".json")

    def _load(self) -> None:
        for fn in os.listdir(self._persist_dir):
            if not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(self._persist_dir, fn)) as f:
                    d = json.load(f)
                dep = SeldonDeployment.from_dict(d)
                dep.generation = (d.get("metadata") or {}).get("generation", 1)
                if "status" in d:
                    from .resource import DeploymentStatus

                    dep.status = DeploymentStatus.from_dict(d["status"])
            except Exception as e:  # noqa: BLE001 - a torn write or schema
                # drift in one file must not brick the whole control plane
                import logging

                logging.getLogger(__name__).warning("skipping unreadable %s: %s", fn, e)
                continue
            self._items[dep.key] = dep

    @staticmethod
    @contextlib.contextmanager
    def _file_lock(path: str):
        """Cross-process exclusive lock scoped to one store file, so a CLI
        ``apply`` and a controller status write serialize their
        read-modify-write cycles instead of clobbering each other."""
        with open(path + ".lock", "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lf, fcntl.LOCK_UN)

    @staticmethod
    def _write_json(path: str, doc: dict) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
        os.replace(tmp, path)  # atomic: readers never see a torn file

    def _persist(self, dep: SeldonDeployment) -> None:
        if self._persist_dir:
            path = self._path(dep.key)
            with self._file_lock(path):
                self._write_json(path, dep.to_dict())

    def _unpersist(self, key: str) -> None:
        if self._persist_dir and os.path.exists(self._path(key)):
            os.remove(self._path(key))

    # -- api ----------------------------------------------------------------

    def apply(self, dep: SeldonDeployment) -> Tuple[SeldonDeployment, str]:
        """Create or update; bumps generation when the spec changed
        (no-op applies do not retrigger reconcile, like jsonEquals at
        seldondeployment_controller.go:842-853)."""
        with self._lock:
            existing = self._items.get(dep.key)
            if existing is None:
                dep.generation = 1
                self._items[dep.key] = dep
                self._persist(dep)
                event = EVENT_ADDED
            elif existing.spec_hash() == dep.spec_hash() and existing.annotations == dep.annotations:
                return existing, "UNCHANGED"
            else:
                dep.generation = existing.generation + 1
                dep.status = existing.status
                self._items[dep.key] = dep
                self._persist(dep)
                event = EVENT_MODIFIED
        self._notify(event, dep)
        return dep, event

    def get(self, name: str, namespace: str = "default") -> Optional[SeldonDeployment]:
        return self._items.get(f"{namespace}/{name}")

    def list(self, namespace: Optional[str] = None) -> List[SeldonDeployment]:
        return [
            d for d in self._items.values() if namespace is None or d.namespace == namespace
        ]

    def delete(self, name: str, namespace: str = "default") -> bool:
        key = f"{namespace}/{name}"
        with self._lock:
            dep = self._items.pop(key, None)
            if dep is None:
                return False
            self._unpersist(key)
        self._notify(EVENT_DELETED, dep)
        return True

    def update_status(self, dep: SeldonDeployment) -> None:
        """Status-only write: no generation bump, no reconcile retrigger.

        Persists via read-merge-write of only the ``status`` field, under
        the per-file flock, so a concurrent CLI ``apply`` that already
        wrote a newer spec to the store file is not clobbered by an
        in-flight reconcile's status rollup (the rescan would otherwise
        see no diff and drop the apply).
        """
        with self._lock:
            if dep.key not in self._items:
                return
            self._items[dep.key].status = dep.status
            if not self._persist_dir:
                return
            path = self._path(dep.key)
            with self._file_lock(path):
                doc = None
                if os.path.exists(path):
                    try:
                        with open(path) as f:
                            doc = json.load(f)
                    except Exception:  # torn write: rewrite from memory
                        doc = None
                if doc is None:
                    doc = self._items[dep.key].to_dict()
                doc["status"] = dep.status.to_dict()
                self._write_json(path, doc)

    # -- watch --------------------------------------------------------------

    def watch(self) -> asyncio.Queue:
        """Subscribe to (event, deployment) tuples; caller consumes the
        queue from its own event loop."""
        q: asyncio.Queue = asyncio.Queue()
        self._watchers.append(q)
        return q

    def unwatch(self, q: asyncio.Queue) -> None:
        if q in self._watchers:
            self._watchers.remove(q)

    def _notify(self, event: str, dep: SeldonDeployment) -> None:
        for q in list(self._watchers):
            q.put_nowait((event, dep))
