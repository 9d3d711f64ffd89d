"""Anchors: black-box rule explanations (Ribeiro et al., AAAI'18).

Counterpart of ``seldon_core_tpu/components/anchors.py``, copied so that
this package stands alone: the same numpy code, so that the same seed
and the same ``predict_fn`` give the same rule, precision, coverage and
prediction under both packages.

The reference's default explainer deployment is alibi's anchors family
(reference: operator/controllers/seldondeployment_explainers.go:32-187,
image default :54-56 ``seldonio/alibiexplainer`` with types
``anchor_tabular`` / ``anchor_text`` / ``anchor_images``): a rule
("anchor") A is a set of predicates on the instance such that
``P(f(z) = f(x) | z ~ D(.|A))`` >= a precision threshold. It needs no
model internals, so it is the ``/explain`` of the non-differentiable
servers (sklearn, xgboost, Triton).

* **Tabular**: features are discretized into quantile bins; candidate
  predicates pin a feature to the instance's bin. Perturbations resample
  unpinned features from the background data. Beam search grows
  anchors; each candidate's precision is estimated with adaptive
  sampling under Hoeffding bounds (stop when the lower bound clears the
  threshold or the upper bound cannot).
* **Text**: predicates pin words; perturbations drop unpinned words
  with probability ``p_drop``.

The model is consulted only through ``predict_fn(batch) -> labels/probs``,
batched: behind the :class:`~seldon_core_tpu_torch.components.explainer.Explainer`
that is one engine REST call per sampling round.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

PredictFn = Callable[[np.ndarray], np.ndarray]


def _labels_of(preds: np.ndarray) -> np.ndarray:
    """Normalize predict output (probs [N,C] or labels [N]) to int labels."""
    preds = np.asarray(preds)
    if preds.ndim >= 2 and preds.shape[-1] > 1:
        return np.argmax(preds, axis=-1)
    return np.rint(preds.reshape(len(preds))).astype(np.int64)


def _hoeffding_delta(n: int, confidence: float) -> float:
    """+/- half-width of the (1-confidence) Hoeffding interval after n
    Bernoulli samples."""
    if n <= 0:
        return 1.0
    return math.sqrt(math.log(2.0 / confidence) / (2.0 * n))


class AnchorExplanation(Dict[str, Any]):
    """Dict result with attribute access for readability in user code."""

    @property
    def anchor(self) -> List[str]:
        return self["anchor"]

    @property
    def precision(self) -> float:
        return self["precision"]

    @property
    def coverage(self) -> float:
        return self["coverage"]


class AnchorTabular:
    """Anchor explanations for tabular models.

    ``train_data`` plays two roles: the perturbation distribution
    (unpinned features are resampled from it, row-wise per feature) and
    the coverage denominator (fraction of it an anchor matches)."""

    def __init__(
        self,
        predict_fn: PredictFn,
        train_data: np.ndarray,
        feature_names: Optional[Sequence[str]] = None,
        n_bins: int = 4,
        precision_threshold: float = 0.95,
        confidence: float = 0.1,
        batch_size: int = 256,
        max_samples_per_candidate: int = 2048,
        beam_size: int = 2,
        max_anchor_size: Optional[int] = None,
        seed: int = 0,
    ):
        self.predict_fn = predict_fn
        self.train = np.asarray(train_data, dtype=np.float64)
        if self.train.ndim != 2 or len(self.train) < 2:
            raise ValueError("train_data must be [N>=2, F]")
        n, f = self.train.shape
        self.feature_names = (
            list(feature_names) if feature_names else [f"f{j}" for j in range(f)]
        )
        if len(self.feature_names) != f:
            raise ValueError(
                f"{len(self.feature_names)} feature names for {f} features"
            )
        self.precision_threshold = float(precision_threshold)
        self.confidence = float(confidence)
        self.batch_size = int(batch_size)
        self.max_samples = int(max_samples_per_candidate)
        self.beam_size = int(beam_size)
        self.max_anchor_size = max_anchor_size or f
        self._rng = np.random.RandomState(seed)
        # quantile discretization per feature; constant features get 1 bin
        self.bin_edges: List[np.ndarray] = []
        for j in range(f):
            qs = np.quantile(
                self.train[:, j], np.linspace(0, 1, n_bins + 1)[1:-1]
            )
            self.bin_edges.append(np.unique(qs))
        self._train_bins = self._discretize(self.train)

    # -- discretization ------------------------------------------------------

    def _discretize(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        out = np.empty(X.shape, dtype=np.int64)
        for j, edges in enumerate(self.bin_edges):
            out[:, j] = np.searchsorted(edges, X[:, j], side="right")
        return out

    def _predicate_str(self, j: int, b: int) -> str:
        name = self.feature_names[j]
        edges = self.bin_edges[j]
        if len(edges) == 0:
            return f"{name} = const"
        if b == 0:
            return f"{name} <= {edges[0]:.3g}"
        if b == len(edges):
            return f"{name} > {edges[-1]:.3g}"
        return f"{edges[b - 1]:.3g} < {name} <= {edges[b]:.3g}"

    # -- sampling ------------------------------------------------------------

    def _sample_perturbations(self, x: np.ndarray, anchor: Tuple[int, ...],
                              n: int) -> np.ndarray:
        """n rows ~ D(.|anchor): background rows with anchored features
        overwritten by x's values (the alibi tabular sampler's scheme:
        per-feature row resampling keeps marginals realistic)."""
        idx = self._rng.randint(0, len(self.train), size=(n, self.train.shape[1]))
        z = self.train[idx, np.arange(self.train.shape[1])[None, :]]
        for j in anchor:
            z[:, j] = x[j]
        return z

    def _precision(self, x: np.ndarray, label: int, anchor: Tuple[int, ...]
                   ) -> Tuple[float, float, int]:
        """Adaptive precision estimate: sample until the Hoeffding interval
        clears (or can't clear) the threshold, or the budget is spent.
        Returns (p_hat, lower_bound, n)."""
        hits = 0
        n = 0
        while n < self.max_samples:
            take = min(self.batch_size, self.max_samples - n)
            z = self._sample_perturbations(x, anchor, take)
            labels = _labels_of(self.predict_fn(z))
            hits += int(np.sum(labels == label))
            n += take
            p = hits / n
            d = _hoeffding_delta(n, self.confidence)
            if p - d >= self.precision_threshold:
                break  # confidently above
            if p + d < self.precision_threshold:
                break  # confidently below — stop wasting samples
        p = hits / max(n, 1)
        return p, p - _hoeffding_delta(n, self.confidence), n

    def _coverage(self, x_bins: np.ndarray, anchor: Tuple[int, ...]) -> float:
        if not anchor:
            return 1.0
        match = np.ones(len(self._train_bins), dtype=bool)
        for j in anchor:
            match &= self._train_bins[:, j] == x_bins[j]
        return float(match.mean())

    # -- search --------------------------------------------------------------

    def explain(self, x: np.ndarray) -> AnchorExplanation:
        x = np.asarray(x, dtype=np.float64).reshape(-1)
        if x.shape[0] != self.train.shape[1]:
            raise ValueError(
                f"instance has {x.shape[0]} features, train {self.train.shape[1]}"
            )
        label = int(_labels_of(self.predict_fn(x[None, :]))[0])
        x_bins = self._discretize(x[None, :])[0]
        f = x.shape[0]

        # beam search over anchors (sets of pinned features)
        beam: List[Tuple[Tuple[int, ...], float, float]] = [((), 0.0, 0.0)]
        best: Optional[Tuple[Tuple[int, ...], float, float, float]] = None
        total_samples = 0
        for _size in range(1, self.max_anchor_size + 1):
            scored: List[Tuple[Tuple[int, ...], float, float]] = []
            seen = set()
            for anchor, _, _ in beam:
                for j in range(f):
                    if j in anchor:
                        continue
                    cand = tuple(sorted(anchor + (j,)))
                    if cand in seen:
                        continue
                    seen.add(cand)
                    p, lb, n = self._precision(x, label, cand)
                    total_samples += n
                    scored.append((cand, p, lb))
            if not scored:
                break
            scored.sort(key=lambda t: (t[2], t[1]), reverse=True)
            # any candidate whose LOWER bound clears the threshold is done;
            # prefer the highest coverage among them (shorter = broader)
            winners = [c for c in scored if c[2] >= self.precision_threshold]
            if winners:
                with_cov = [
                    (a, p, lb, self._coverage(x_bins, a)) for a, p, lb in winners
                ]
                with_cov.sort(key=lambda t: t[3], reverse=True)
                best = with_cov[0]
                break
            beam = scored[: self.beam_size]
        if best is None:
            # no anchor reached the threshold within budget: report the best
            # candidate found, flagged — alibi raises; a flagged result is
            # more useful behind a serving endpoint
            a, p, lb = beam[0] if beam else ((), 1.0, 1.0)
            best = (a, p, lb, self._coverage(x_bins, a))
        anchor, precision, lb, coverage = best
        return AnchorExplanation(
            anchor=[self._predicate_str(j, int(x_bins[j])) for j in anchor],
            anchor_features=[self.feature_names[j] for j in anchor],
            precision=round(float(precision), 4),
            precision_lower_bound=round(float(lb), 4),
            coverage=round(float(coverage), 4),
            prediction=label,
            converged=bool(lb >= self.precision_threshold),
            n_samples=total_samples,
        )


class AnchorText:
    """Word-pinning anchors for text classifiers.

    ``predict_fn`` takes a list of strings. Perturbations drop each
    unpinned word independently with probability ``p_drop``."""

    def __init__(
        self,
        predict_fn: Callable[[List[str]], np.ndarray],
        precision_threshold: float = 0.95,
        confidence: float = 0.1,
        p_drop: float = 0.5,
        batch_size: int = 128,
        max_samples_per_candidate: int = 1024,
        beam_size: int = 2,
        max_anchor_size: int = 4,
        seed: int = 0,
    ):
        self.predict_fn = predict_fn
        self.precision_threshold = float(precision_threshold)
        self.confidence = float(confidence)
        self.p_drop = float(p_drop)
        self.batch_size = int(batch_size)
        self.max_samples = int(max_samples_per_candidate)
        self.beam_size = int(beam_size)
        self.max_anchor_size = int(max_anchor_size)
        self._rng = np.random.RandomState(seed)

    def _sample(self, words: List[str], anchor: Tuple[int, ...], n: int
                ) -> List[str]:
        keep = self._rng.random_sample((n, len(words))) >= self.p_drop
        keep[:, list(anchor)] = True
        return [
            " ".join(w for w, k in zip(words, row) if k) or words[anchor[0]]
            if anchor else " ".join(w for w, k in zip(words, row))
            for row in keep
        ]

    def _precision(self, words: List[str], label: int, anchor: Tuple[int, ...]
                   ) -> Tuple[float, float, int]:
        hits = 0
        n = 0
        while n < self.max_samples:
            take = min(self.batch_size, self.max_samples - n)
            labels = _labels_of(self.predict_fn(self._sample(words, anchor, take)))
            hits += int(np.sum(labels == label))
            n += take
            p = hits / n
            d = _hoeffding_delta(n, self.confidence)
            if p - d >= self.precision_threshold or p + d < self.precision_threshold:
                break
        p = hits / max(n, 1)
        return p, p - _hoeffding_delta(n, self.confidence), n

    def explain(self, text: str) -> AnchorExplanation:
        words = text.split()
        if not words:
            raise ValueError("empty text")
        label = int(_labels_of(self.predict_fn([text]))[0])
        beam: List[Tuple[Tuple[int, ...], float, float]] = [((), 0.0, 0.0)]
        best = None
        total = 0
        for _size in range(1, min(self.max_anchor_size, len(words)) + 1):
            scored = []
            seen = set()
            for anchor, _, _ in beam:
                for j in range(len(words)):
                    if j in anchor:
                        continue
                    cand = tuple(sorted(anchor + (j,)))
                    if cand in seen:
                        continue
                    seen.add(cand)
                    p, lb, n = self._precision(words, label, cand)
                    total += n
                    scored.append((cand, p, lb))
            if not scored:
                break
            scored.sort(key=lambda t: (t[2], t[1]), reverse=True)
            winners = [c for c in scored if c[2] >= self.precision_threshold]
            if winners:
                # shortest anchor wins (broadest rule); already size-ordered
                best = winners[0]
                break
            beam = scored[: self.beam_size]
        if best is None:
            best = beam[0] if beam else ((), 1.0, 1.0)
        anchor, precision, lb = best
        return AnchorExplanation(
            anchor=[words[j] for j in anchor],
            precision=round(float(precision), 4),
            precision_lower_bound=round(float(lb), 4),
            coverage=round(float((1.0 - self.p_drop) ** len(anchor)), 4),
            prediction=label,
            converged=bool(lb >= self.precision_threshold),
            n_samples=total,
        )
