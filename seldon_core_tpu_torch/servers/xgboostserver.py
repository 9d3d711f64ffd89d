"""XGBoost prepackaged server, on the host.

Counterpart of ``seldon_core_tpu/servers/xgboostserver.py`` (reference:
servers/xgboostserver/xgboostserver/XGBoostServer.py): a Booster loaded
from ``model.bst``. Without xgboost, ``load`` raises a clear error.
"""

from __future__ import annotations

import os

import numpy as np

from ..storage import Storage
from ..user_model import SeldonComponent

BOOSTER_FILE = "model.bst"


class XGBoostServer(SeldonComponent):
    def __init__(self, model_uri: str, **kwargs):
        self.model_uri = model_uri
        self._booster = None

    def load(self) -> None:
        try:
            import xgboost as xgb
        except ImportError as e:
            raise RuntimeError(
                "XGBOOST_SERVER requires the xgboost package, which is not installed"
            ) from e
        model_dir = Storage.download(self.model_uri)
        self._booster = xgb.Booster(model_file=os.path.join(model_dir, BOOSTER_FILE))

    def predict(self, X, names, meta=None):
        import xgboost as xgb

        if self._booster is None:
            self.load()
        dmat = xgb.DMatrix(np.asarray(X))
        return self._booster.predict(dmat)
