"""Periodic persistence of stateful components (bandit routers, online
outlier detectors).

Counterpart of ``seldon_core_tpu/persistence.py``: restore on boot keyed
by predictor + deployment + component name, then a
:class:`PersistenceThread` pushing a snapshot every ``push_frequency``
seconds. The store is a filesystem path (local disk or any mounted
bucket).

A component exposing ``to_state_dict()`` / ``from_state_dict()`` (a
nested dict of arrays) is written as ``<key>.npz``: the dict is
flattened to ``/``-joined keys, written to a tmp file and moved into
place with ``os.replace``, and rebuilt on restore. A component without
the hooks falls back to a whole-object pickle, ``<key>.pkl``, written
the same atomic way. The JAX package writes state dicts as ``.orbax``
checkpoints; the port neither reads nor writes those.
"""

from __future__ import annotations

import logging
import os
import pickle
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

DEFAULT_PUSH_FREQUENCY = 60  # seconds


def state_key(
    component_name: str,
    predictor_name: Optional[str] = None,
    deployment_name: Optional[str] = None,
) -> str:
    """``<predictor>_<deployment>_<component>``, the predictor and the
    deployment from ``PREDICTOR_ID`` / ``SELDON_DEPLOYMENT_ID``."""
    pred = predictor_name or os.environ.get("PREDICTOR_ID", "default")
    dep = deployment_name or os.environ.get("SELDON_DEPLOYMENT_ID", "default")
    return f"{pred}_{dep}_{component_name}"


def _has_state_dict(obj: Any) -> bool:
    return hasattr(obj, "to_state_dict") and hasattr(obj, "from_state_dict")


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        k = str(k)
        if "/" in k:
            raise ValueError(f"state dict key {k!r} holds the separator '/'")
        path = prefix + k
        if isinstance(v, dict):
            flat.update(_flatten(v, path + "/"))
        else:
            flat[path] = np.asarray(v)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, path)  # atomic, so a crash mid-write never corrupts


def persist(user_object: Any, store_dir: str, key: str) -> str:
    """Write one snapshot; returns the path written."""
    os.makedirs(store_dir, exist_ok=True)
    if _has_state_dict(user_object):
        path = os.path.join(store_dir, key + ".npz")
        flat = _flatten(user_object.to_state_dict())
        _write_atomic(path, lambda f: np.savez(f, **flat))
        return path
    path = os.path.join(store_dir, key + ".pkl")
    _write_atomic(path, lambda f: pickle.dump(user_object, f))
    return path


def restore(user_class, parameters: dict, store_dir: str, key: str) -> Any:
    """Instantiate the component and, if a snapshot exists, load it:
    construct fresh, then overwrite state from the store when present."""
    obj = user_class(**parameters) if parameters else user_class()
    npz_path = os.path.join(store_dir, key + ".npz")
    pkl_path = os.path.join(store_dir, key + ".pkl")
    if _has_state_dict(obj) and os.path.exists(npz_path):
        with np.load(npz_path, allow_pickle=False) as z:
            obj.from_state_dict(_unflatten({k: z[k] for k in z.files}))
        logger.info("restored component state from %s", npz_path)
    elif os.path.exists(pkl_path):
        with open(pkl_path, "rb") as f:
            obj = pickle.load(f)
        logger.info("restored pickled component from %s", pkl_path)
    return obj


class PersistenceThread(threading.Thread):
    """Push a snapshot every ``push_frequency`` seconds until stopped."""

    def __init__(
        self,
        user_object: Any,
        store_dir: str,
        key: str,
        push_frequency: float = DEFAULT_PUSH_FREQUENCY,
    ):
        super().__init__(daemon=True, name="seldon-persistence")
        self.user_object = user_object
        self.store_dir = store_dir
        self.key = key
        self.push_frequency = float(push_frequency)
        self._stop_event = threading.Event()

    def _push(self) -> None:
        # components that mutate state on the request thread can expose a
        # `_state_lock` (threading.Lock) to get a consistent snapshot; without
        # one, retry the handful of races pickling a live dict can raise
        lock = getattr(self.user_object, "_state_lock", None)
        if lock is not None:
            with lock:
                persist(self.user_object, self.store_dir, self.key)
            return
        for attempt in range(3):
            try:
                persist(self.user_object, self.store_dir, self.key)
                return
            except RuntimeError:  # "dictionary changed size during iteration"
                if attempt == 2:
                    raise
                time.sleep(0.01)

    def run(self) -> None:
        while not self._stop_event.wait(self.push_frequency):
            try:
                self._push()
            except Exception:  # keep serving even if a push fails
                logger.exception("persistence push failed")

    def stop(self, final_push: bool = True) -> None:
        self._stop_event.set()
        # join first: a concurrent periodic push writes the same tmp path,
        # and two interleaved writers could publish a corrupt snapshot
        self.join(timeout=30)
        if final_push:
            try:
                persist(self.user_object, self.store_dir, self.key)
            except Exception:
                logger.exception("final persistence push failed")
