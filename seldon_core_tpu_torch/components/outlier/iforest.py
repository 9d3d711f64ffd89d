"""Isolation-forest outlier detector (sklearn-backed).

Counterpart of ``seldon_core_tpu/components/outlier/iforest.py``: sklearn
is imported where it is used (``fit``, ``load``), so without it those
raise the same ``ModuleNotFoundError`` as the JAX package's. Behavioral
counterpart of the reference's
components/outlier-detection/isolation-forest/CoreIsolationForest.py:
sklearn ``IsolationForest.decision_function`` scores (negative = anomalous),
rows *below* ``threshold`` are outliers. To keep the shared base-class
convention (higher = more anomalous, score > threshold flags), the score is
negated here and the threshold mirrored; the externally observable flags
match the reference for the same data and threshold magnitude.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np

from .base import OutlierDetector


class IsolationForestOutlier(OutlierDetector):
    def __init__(
        self,
        threshold: float = 0.0,
        n_estimators: int = 100,
        model_uri: Optional[str] = None,
        seed: int = 0,
    ):
        super().__init__(threshold=float(threshold))
        self.n_estimators = int(n_estimators)
        self.clf = None
        self.model_uri = model_uri
        self._seed = int(seed)

    def load(self) -> None:
        if self.model_uri:
            from seldon_core_tpu_torch.storage import Storage

            path = Storage.download(self.model_uri)
            with open(f"{path}/iforest.pkl", "rb") as f:
                self.clf = pickle.load(f)

    def fit(self, X: np.ndarray, **kwargs) -> "IsolationForestOutlier":
        from sklearn.ensemble import IsolationForest

        self.clf = IsolationForest(
            n_estimators=self.n_estimators, random_state=self._seed, **kwargs
        )
        self.clf.fit(np.atleast_2d(X))
        return self

    def save(self, path: str) -> None:
        with open(f"{path}/iforest.pkl", "wb") as f:
            pickle.dump(self.clf, f)

    def score(self, X: np.ndarray) -> np.ndarray:
        if self.clf is None:
            raise RuntimeError("IsolationForestOutlier not fitted/loaded")
        # negate: decision_function is low for outliers; base flags score>threshold
        return -self.clf.decision_function(np.atleast_2d(X))
