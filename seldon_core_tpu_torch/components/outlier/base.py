"""Shared outlier-detector plumbing.

Counterpart of ``seldon_core_tpu/components/outlier/base.py`` (the
reference's per-detector boilerplate, components/outlier-detection/*/
Core*.py: predict/transform_input both call the scoring core; tags expose
per-row outlier flags; metrics expose is_outlier / outlier_score /
nb_outliers / fraction_outliers / observation / threshold gauges;
Outlier*.py subclasses add label bookkeeping in send_feedback), plus the
state-dict helpers the device-backed detectors share.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from seldon_core_tpu_torch.user_model import SeldonComponent


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to seldon_core_tpu_torch yet: train with the JAX "
        "package and load the parameters through fit_from"
    )


def numpy_tree(tree) -> Any:
    """A parameter tree (tensors or arrays in dicts and lists) with numpy
    leaves, the layout the JAX package pickles."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy_tree(v) for v in tree]
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def state_tree(tree) -> Any:
    """A numpy parameter tree as nested dicts only (a list's index becomes
    its key), the shape ``persistence.py`` writes to ``.npz``."""
    if isinstance(tree, dict):
        return {k: state_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): state_tree(v) for i, v in enumerate(tree)}
    return np.asarray(tree)


def params_tree(state) -> Any:
    """Inverse of :func:`state_tree`: a dict whose keys are 0..n-1 is a
    list again."""
    if not isinstance(state, dict):
        return state
    kids = {k: params_tree(v) for k, v in state.items()}
    if kids and all(k.isdigit() for k in kids) and \
            sorted(int(k) for k in kids) == list(range(len(kids))):
        return [kids[str(i)] for i in range(len(kids))]
    return kids


class OutlierDetector(SeldonComponent):
    """Base for outlier detectors used as MODELs (predict -> 0/1 flags) or
    as input TRANSFORMERs (transform_input -> passthrough + tags/metrics).

    Subclasses implement ``score(X) -> np.ndarray[batch]`` (higher = more
    anomalous) and may override ``observe(X)`` for online state updates.
    ``threshold``: scores strictly above it are flagged as outliers.
    """

    def __init__(self, threshold: float = 0.0):
        self.threshold = float(threshold)
        self.score_: Optional[np.ndarray] = None
        self.prediction_: Optional[np.ndarray] = None
        self.n_observed = 0
        self.nb_outliers = 0
        self._labels: List[np.ndarray] = []

    # -- subclass surface ---------------------------------------------------
    def score(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def observe(self, X: np.ndarray) -> None:
        """Online detectors update their state here; offline ones ignore."""

    def _coerce(self, X) -> np.ndarray:
        """Input coercion hook; sequence detectors override (3-d input)."""
        return np.atleast_2d(np.asarray(X, dtype=np.float64))

    # -- SeldonComponent hooks ---------------------------------------------
    def _flag(self, X) -> np.ndarray:
        X = self._coerce(X)
        s = np.asarray(self.score(X), dtype=np.float64).reshape(-1)
        self.observe(X)
        self.score_ = s
        self.prediction_ = (s > self.threshold).astype(np.int64)
        self.n_observed += X.shape[0]
        self.nb_outliers += int(self.prediction_.sum())
        return self.prediction_

    def predict(self, X, names, meta=None):
        return self._flag(X)

    def transform_input(self, X, names, meta=None):
        self._flag(X)
        return X

    def send_feedback(self, X, names, reward, truth, routing=None):
        if truth is not None:
            self._labels.append(np.asarray(truth).reshape(-1))
        return []

    def tags(self) -> Dict:
        if self.prediction_ is None:
            return {}
        return {"outlier-predictions": self.prediction_.tolist()}

    def metrics(self) -> List[Dict]:
        if self.prediction_ is None:
            return []
        g = lambda k, v: {"type": "GAUGE", "key": k, "value": float(v)}  # noqa: E731
        return [
            g("is_outlier", self.prediction_.mean()),
            g("outlier_score", self.score_.mean()),
            g("nb_outliers", self.nb_outliers),
            g("fraction_outliers", self.nb_outliers / max(1, self.n_observed)),
            g("observation", self.n_observed),
            g("threshold", self.threshold),
        ]
