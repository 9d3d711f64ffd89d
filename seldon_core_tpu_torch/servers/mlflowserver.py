"""MLflow prepackaged server, on the host.

Counterpart of ``seldon_core_tpu/servers/mlflowserver.py`` (reference:
servers/mlflowserver/mlflowserver/MLFlowServer.py): an MLmodel-format
pyfunc. Without mlflow, ``load`` raises a clear error.
"""

from __future__ import annotations

import numpy as np

from ..storage import Storage
from ..user_model import SeldonComponent


class MLFlowServer(SeldonComponent):
    def __init__(self, model_uri: str, **kwargs):
        self.model_uri = model_uri
        self._model = None

    def load(self) -> None:
        try:
            from mlflow import pyfunc
        except ImportError as e:
            raise RuntimeError(
                "MLFLOW_SERVER requires the mlflow package, which is not installed"
            ) from e
        model_dir = Storage.download(self.model_uri)
        self._model = pyfunc.load_model(model_dir)

    def predict(self, X, names, meta=None):
        if self._model is None:
            self.load()
        return np.asarray(self._model.predict(np.asarray(X)))
