"""Outlier detectors as graph nodes (reference:
components/outlier-detection/{mahalanobis,vae,isolation-forest,seq2seq-lstm}).

Counterpart of ``seldon_core_tpu/components/outlier``. Use as MODELs
(predict -> 0/1 flags) or input TRANSFORMERs (passthrough +
``outlier-predictions`` tag + gauges). The VAE and seq2seq detectors
train (``train_vae``, ``train_seq2seq``, ``fit``) and score on a torch
device (CUDA unless asked for the CPU); parameters trained by the JAX
package load through ``fit_from`` or their pickles."""

from .base import OutlierDetector  # noqa: F401
from .iforest import IsolationForestOutlier  # noqa: F401
from .mahalanobis import Mahalanobis  # noqa: F401
from .seq2seq import Seq2SeqOutlier, seq2seq_apply, seq2seq_init, train_seq2seq  # noqa: F401
from .vae import VAEOutlier, train_vae, vae_apply, vae_init  # noqa: F401
