"""TensorFlow model server: a SavedModel's serving signature, on the host.

Counterpart of ``seldon_core_tpu/servers/tfserver.py`` (the reference
bridged to a TF-Serving container: integrations/tfserving/
TfServingProxy.py:21-60, TENSORFLOW_SERVER in operator/controllers/
seldondeployment_prepackaged_servers.go:30-107). The SavedModel loads
with ``tf.saved_model.load`` in this process. The ``loader`` is
injectable, so the load and predict path runs without tensorflow; when
tensorflow is missing the server fails before any download with a clear
error that points at the ``jax_config.json`` + ``params.npz`` layout
JAX_SERVER serves.
"""

from __future__ import annotations

import numpy as np

from ..storage import Storage
from ..user_model import SeldonComponent

NO_TENSORFLOW = (
    "TENSORFLOW_SERVER requires tensorflow, which is not installed. Convert the "
    "SavedModel to the jax_config.json + params.npz layout and use JAX_SERVER instead."
)


class TFServer(SeldonComponent):
    """``loader(model_dir, signature) -> fn(np.ndarray) -> np.ndarray`` is
    injectable so the full load+predict path is testable without
    tensorflow (the default loader wraps tf.saved_model.load)."""

    def __init__(self, model_uri: str, signature: str = "serving_default",
                 loader=None, **kwargs):
        self.model_uri = model_uri
        self.signature = signature
        self._loader = loader
        self._fn = None

    @staticmethod
    def _tf_loader(model_dir: str, signature: str):
        try:
            import tensorflow as tf
        except ImportError as e:
            raise RuntimeError(NO_TENSORFLOW) from e

        sig = tf.saved_model.load(model_dir).signatures[signature]

        def fn(arr: np.ndarray) -> np.ndarray:
            out = sig(tf.constant(arr))
            return next(iter(out.values())).numpy()

        return fn

    def load(self) -> None:
        if self._loader is None:
            # fail on a missing tensorflow BEFORE the (potentially multi-GB)
            # model download
            try:
                import tensorflow  # noqa: F401
            except ImportError as e:
                raise RuntimeError(NO_TENSORFLOW) from e
        model_dir = Storage.download(self.model_uri)
        loader = self._loader or self._tf_loader
        self._fn = loader(model_dir, self.signature)

    def predict(self, X, names, meta=None):
        if self._fn is None:
            self.load()
        return self._fn(np.asarray(X))
