"""Shared outlier-detector plumbing.

Counterpart of ``seldon_core_tpu/components/outlier/base.py`` (the
reference's per-detector boilerplate, components/outlier-detection/*/
Core*.py: predict/transform_input both call the scoring core; tags expose
per-row outlier flags; metrics expose is_outlier / outlier_score /
nb_outliers / fraction_outliers / observation / threshold gauges;
Outlier*.py subclasses add label bookkeeping in send_feedback), plus the
state-dict helpers and the training loop's Adam that the device-backed
detectors share.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.convert import params_from_numpy, sorted_leaves
from seldon_core_tpu_torch.user_model import SeldonComponent


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


class Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) over a
    list of float32 tensors, its arithmetic in its order: ``mu = (1 - b1)
    g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, both divided by ``1 - b^t``
    (float32), then ``p += -lr * mu_hat / (sqrt(nu_hat) + eps)``.
    ``torch.optim.Adam`` folds the bias corrections into the step size
    instead, which rounds otherwise, and where ``|g|`` is near ``eps`` a
    rounding can move a step by a share of ``lr``."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params = params
        self.lr = lr
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """One update of every parameter, in place."""
        self.count += 1
        # 1 - b**t in float32, as optax's bias correction computes it
        c1 = float(np.float32(1) - np.float32(self.B1) ** np.float32(self.count))
        c2 = float(np.float32(1) - np.float32(self.B2) ** np.float32(self.count))
        for i, (p, g) in enumerate(zip(self.params, grads)):
            self.mu[i] = (1 - self.B1) * g + self.B1 * self.mu[i]
            self.nu[i] = (1 - self.B2) * (g * g) + self.B2 * self.nu[i]
            update = (self.mu[i] / c1) / (torch.sqrt(self.nu[i] / c2) + self.EPS)
            p.add_(-self.lr * update)


def train_loop(params, loss_fn, Xs: np.ndarray, epochs: int, batch_size: int,
               seed: int, lr: float, device, on_batch=None):
    """The JAX package's training loop on ``device``: Adam over every
    parameter, the batches of each epoch in the order of
    ``np.random.default_rng(seed).permutation``, ``loss_fn(params, batch,
    extra)`` per batch with ``extra = on_batch()`` (the VAE's noise key).
    Returns the trained parameters (a tree of tensors on ``device``)."""
    params = params_from_numpy(numpy_tree(params), device=device)
    leaves = [t.requires_grad_(True) for _, t in sorted_leaves(params)]
    opt = Adam(leaves, lr)
    X = torch.from_numpy(np.ascontiguousarray(Xs, np.float32)).to(device)
    order_rng = np.random.default_rng(seed)
    n = X.shape[0]
    for _ in range(epochs):
        order = torch.from_numpy(order_rng.permutation(n)).to(device)
        for i in range(0, n, batch_size):
            extra = on_batch() if on_batch is not None else None
            loss = loss_fn(params, X[order[i:i + batch_size]], extra)
            opt.step(torch.autograd.grad(loss, leaves))
    for t in leaves:
        t.requires_grad_(False)
    return params


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
