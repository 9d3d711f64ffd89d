"""Online Mahalanobis-distance outlier detector.

Counterpart of ``seldon_core_tpu/components/outlier/mahalanobis.py``
(numpy, as there). Behavioral counterpart of the reference's
components/outlier-detection/mahalanobis/CoreMahalanobis.py: maintain a
running mean/covariance of everything seen, project onto the top
``n_components`` principal components, score each row by its squared
Mahalanobis distance in that subspace, flag scores above ``threshold``;
feature-wise clipping (mean +/- n_stdev * stdev) kicks in after
``start_clip`` observations, and ``max_n`` caps the effective history so
the estimator keeps adapting.

Re-designed rather than ported: the reference interleaves a per-row
Sherman-Morrison running inverse inside the batch; here the batch is scored
against the pre-batch estimate in one vectorized shot (eigh + matmul — XLA/
MXU-friendly shapes), then mean/cov are updated once per batch. State stays
in numpy: it's a tiny sequential estimator, not device work.

The state dict stores an empty array where the estimator has no mean or
covariance yet: ``persistence.py`` reads ``.npz`` without pickles.
"""

from __future__ import annotations

import numpy as np

from .base import OutlierDetector


class Mahalanobis(OutlierDetector):
    def __init__(
        self,
        threshold: float = 25.0,
        n_components: int = 3,
        n_stdev: float = 3.0,
        start_clip: int = 50,
        max_n: int = -1,
    ):
        super().__init__(threshold=float(threshold))
        self.n_components = int(n_components)
        self.n_stdev = float(n_stdev)
        self.start_clip = int(start_clip)
        self.max_n = int(max_n)
        self.mean: np.ndarray | None = None
        self.C: np.ndarray | None = None
        self.n = 0  # effective observations folded into mean/C

    def _effective_n(self) -> float:
        return float(min(self.n, self.max_n) if self.max_n > 0 else self.n)

    def _clip(self, X: np.ndarray) -> np.ndarray:
        if self.n > self.start_clip and self.C is not None:
            stdev = np.sqrt(np.clip(np.diag(self.C), 0.0, None))
            lo = self.mean - self.n_stdev * stdev
            hi = self.mean + self.n_stdev * stdev
            return np.clip(X, lo, hi)
        return X

    def score(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(X)
        p = X.shape[1]
        if self.mean is None or self.n < 2:
            return np.zeros(X.shape[0])
        k = min(self.n_components, p)
        cov = self.C + 1e-8 * np.eye(p)
        # top-k principal subspace of the running covariance
        eigvals, eigvects = np.linalg.eigh(cov)
        V = eigvects[:, -k:]
        lam = np.clip(eigvals[-k:], 1e-8, None)
        proj = (X - self.mean) @ V  # [b, k]
        # Mahalanobis distance in the PC basis is diagonal: sum(z_i^2 / lam_i)
        return np.einsum("bk,k->b", proj**2, 1.0 / lam)

    def observe(self, X: np.ndarray) -> None:
        Xc = self._clip(np.atleast_2d(X))
        nb, p = Xc.shape
        bmean = Xc.mean(axis=0)
        bcov = np.cov(Xc, rowvar=False, bias=True) if nb > 1 else np.zeros((p, p))
        if self.mean is None:
            self.mean, self.C, self.n = bmean, bcov, nb
            return
        n = self._effective_n()
        tot = n + nb
        delta = bmean - self.mean
        new_mean = self.mean + (nb / tot) * delta
        # parallel-update of covariance (Chan et al. batch merge)
        self.C = (
            (n / tot) * self.C
            + (nb / tot) * bcov
            + (n * nb / tot**2) * np.outer(delta, delta)
        )
        self.mean = new_mean
        self.n += nb

    # persistence hooks
    def to_state_dict(self):
        empty = np.zeros((0,))
        return {
            "mean": empty if self.mean is None else self.mean,
            "C": empty if self.C is None else self.C,
            "n": np.asarray(self.n),
            "n_observed": np.asarray(self.n_observed),
            "nb_outliers": np.asarray(self.nb_outliers),
        }

    def from_state_dict(self, d):
        def arr(v):
            return None if v is None or np.asarray(v).size == 0 else np.asarray(v)

        self.mean = arr(d["mean"])
        self.C = arr(d["C"])
        self.n = int(np.asarray(d["n"]))
        self.n_observed = int(np.asarray(d["n_observed"]))
        self.nb_outliers = int(np.asarray(d["nb_outliers"]))
