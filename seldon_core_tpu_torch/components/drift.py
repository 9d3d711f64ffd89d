"""Data-drift detector: is the serving distribution still the training
distribution?

Counterpart of ``seldon_core_tpu/components/drift.py`` (numpy, as there).

The reference era paired Seldon with alibi-detect drift detectors wired
as input transformers next to the outlier components
(components/outlier-detection/ is in-tree; drift was the sibling
capability). Same graph idiom here: a TRANSFORMER node that passes the
payload through untouched while accumulating a window of serving data,
comparing it per-feature against a reference sample, and surfacing the
verdict in tags + metrics for Prometheus/alerting.

Statistics (pure numpy: windows are small, the model's device stays on
the hot path):
  * Kolmogorov–Smirnov two-sample statistic per feature (continuous
    features, distribution-free),
  * with Bonferroni correction across features: drift is flagged when
    any feature's KS exceeds the threshold for the configured p-value.

State (reference window + rolling serving window) is a plain dict of
arrays, so `persistence.py` checkpoints it like the bandit routers.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..user_model import SeldonComponent


def ks_statistic(a: np.ndarray, b: np.ndarray, a_sorted: bool = False) -> float:
    """Two-sample Kolmogorov–Smirnov statistic (sup of CDF distance)."""
    a = np.asarray(a, np.float64) if a_sorted else np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    grid = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, grid, side="right") / len(a)
    cdf_b = np.searchsorted(b, grid, side="right") / len(b)
    return float(np.abs(cdf_a - cdf_b).max())


def ks_threshold(n: int, m: int, p_value: float) -> float:
    """Critical KS value for samples of size n, m at significance
    ``p_value`` (asymptotic two-sample form)."""
    c = np.sqrt(-0.5 * np.log(p_value / 2.0))
    return float(c * np.sqrt((n + m) / (n * m)))


class KSDrift(SeldonComponent):
    """Feature-wise KS drift detector as a graph TRANSFORMER.

    Parameters:
      reference      [N, F] training-distribution sample (list or array);
                     may also be loaded later via ``fit``.
      window         serving rows held for each test (default 256)
      min_window     rows required before testing (default 32)
      p_value        per-test significance BEFORE Bonferroni (default 0.05)
    """

    def __init__(
        self,
        reference=None,
        window: int = 256,
        min_window: int = 32,
        p_value: float = 0.05,
    ):
        self.window = int(window)
        self.min_window = int(min_window)
        self.p_value = float(p_value)
        self._ref: Optional[np.ndarray] = None
        self._ref_sorted: Optional[np.ndarray] = None
        self._buf: deque = deque(maxlen=self.window)
        self.drifted = False
        self.feature_scores: List[float] = []
        self.n_tests = 0
        self.n_drifted = 0
        if reference is not None:
            self.fit(reference)

    def fit(self, reference) -> None:
        ref = np.atleast_2d(np.asarray(reference, np.float64))
        if ref.shape[0] < 2:
            raise ValueError("reference sample needs at least 2 rows")
        self._ref = ref
        # ks_statistic sorts both sides; the reference never changes, so
        # sort its columns ONCE here instead of per request
        self._ref_sorted = np.sort(ref, axis=0)

    # -- detection ----------------------------------------------------------

    def _test(self) -> None:
        cur = np.asarray(self._buf, np.float64)
        n, m = self._ref.shape[0], cur.shape[0]
        n_feat = self._ref.shape[1]
        # Bonferroni: the any-feature test holds the family-wise p_value
        thresh = ks_threshold(n, m, self.p_value / n_feat)
        self.feature_scores = [
            ks_statistic(self._ref_sorted[:, f], cur[:, f], a_sorted=True)
            for f in range(n_feat)
        ]
        self.drifted = bool(max(self.feature_scores) > thresh)
        self.n_tests += 1
        self.n_drifted += int(self.drifted)

    def _observe(self, X) -> None:
        if self._ref is None:
            raise RuntimeError("KSDrift has no reference sample; call fit()")
        rows = np.atleast_2d(np.asarray(X, np.float64))
        if rows.shape[1] != self._ref.shape[1]:
            raise ValueError(
                f"feature count {rows.shape[1]} != reference {self._ref.shape[1]}"
            )
        self._buf.extend(rows)
        if len(self._buf) >= self.min_window:
            self._test()

    # -- SeldonComponent hooks ----------------------------------------------

    def transform_input(self, X, names, meta=None):
        self._observe(X)
        return X  # payload passes through untouched

    def predict(self, X, names, meta=None):
        """MODEL mode: per-request drift verdict for the batch seen so far."""
        self._observe(X)
        return np.asarray([[1.0 if self.drifted else 0.0]])

    def tags(self) -> Dict:
        return {
            "drift": bool(self.drifted),
            "drift_score": float(max(self.feature_scores or [0.0])),
        }

    def metrics(self) -> List[Dict]:
        return [
            {"type": "GAUGE", "key": "drift_detected", "value": float(self.drifted)},
            {
                "type": "GAUGE",
                "key": "drift_score_max",
                "value": float(max(self.feature_scores or [0.0])),
            },
            {"type": "GAUGE", "key": "drift_window_rows", "value": float(len(self._buf))},
            {"type": "GAUGE", "key": "drift_tests_total", "value": float(self.n_tests)},
            {"type": "GAUGE", "key": "drift_flagged_total", "value": float(self.n_drifted)},
        ]

    # -- persistence (the to_state_dict/from_state_dict protocol
    # persistence.py writes to .npz, as for the bandit routers) -----------

    def to_state_dict(self) -> Dict:
        n_feat = self._ref.shape[1] if self._ref is not None else 0
        return {
            "reference": self._ref
            if self._ref is not None
            else np.zeros((0, 0), np.float64),
            "buffer": np.asarray(self._buf, np.float64)
            if len(self._buf)
            else np.zeros((0, n_feat), np.float64),
            "n_tests": np.asarray(self.n_tests),
            "n_drifted": np.asarray(self.n_drifted),
            "drifted": np.asarray(int(self.drifted)),
            "feature_scores": np.asarray(self.feature_scores, np.float64),
        }

    def from_state_dict(self, state: Dict) -> None:
        ref = np.asarray(state.get("reference", []), np.float64)
        if ref.size:
            self.fit(ref)
        else:
            self._ref = None
        self._buf = deque(maxlen=self.window)
        buf = np.asarray(state.get("buffer", []), np.float64)
        if buf.size:
            self._buf.extend(np.atleast_2d(buf))
        self.n_tests = int(state.get("n_tests", 0))
        self.n_drifted = int(state.get("n_drifted", 0))
        # the verdict survives restarts: an alert firing on drift_detected
        # must not silently clear until a fresh window says otherwise
        self.drifted = bool(int(state.get("drifted", 0)))
        self.feature_scores = list(
            np.asarray(state.get("feature_scores", []), np.float64)
        )
