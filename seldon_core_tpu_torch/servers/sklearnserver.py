"""SKLearn prepackaged server, on the host.

Counterpart of ``seldon_core_tpu/servers/sklearnserver.py`` (reference:
servers/sklearnserver/sklearnserver/SKLearnServer.py:15-43): a
joblib-loaded model, the ``method`` parameter selecting predict_proba,
predict or decision_function. Without joblib, ``load`` raises an
ImportError naming it, as the JAX package's server does.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..storage import Storage
from ..user_model import SeldonComponent

logger = logging.getLogger(__name__)

JOBLIB_FILE = "model.joblib"


class SKLearnServer(SeldonComponent):
    def __init__(self, model_uri: str, method: str = "predict_proba", **kwargs):
        self.model_uri = model_uri
        self.method = method
        self._model = None

    def load(self) -> None:
        try:
            import joblib
        except ImportError as e:
            raise ModuleNotFoundError(
                "SKLEARN_SERVER requires joblib (and scikit-learn), which is not installed",
                name="joblib",
            ) from e
        model_dir = Storage.download(self.model_uri)
        path = os.path.join(model_dir, JOBLIB_FILE)
        if not os.path.exists(path):
            candidates = [f for f in os.listdir(model_dir) if f.endswith((".joblib", ".pkl"))]
            if not candidates:
                raise RuntimeError(f"no {JOBLIB_FILE} (or .pkl) under {self.model_uri}")
            path = os.path.join(model_dir, candidates[0])
        self._model = joblib.load(path)
        logger.info("sklearn model loaded from %s", path)

    def predict(self, X, names, meta=None):
        if self._model is None:
            self.load()
        arr = np.asarray(X)
        if self.method == "predict_proba" and hasattr(self._model, "predict_proba"):
            return self._model.predict_proba(arr)
        if self.method == "decision_function" and hasattr(self._model, "decision_function"):
            return self._model.decision_function(arr)
        return self._model.predict(arr)

    def class_names(self):
        if self._model is not None and hasattr(self._model, "classes_"):
            return [f"t:{c}" for c in self._model.classes_]
        return []
