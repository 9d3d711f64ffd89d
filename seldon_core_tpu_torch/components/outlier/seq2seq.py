"""Seq2seq-LSTM outlier detector, scored on a torch device.

Counterpart of ``seldon_core_tpu/components/outlier/seq2seq.py`` (the
reference's components/outlier-detection/seq2seq-lstm, Keras): a
sequence autoencoder scores each sequence by reconstruction MSE and
flags scores above ``threshold``.

A single-layer LSTM encoder + LSTM decoder, each a loop over time where
the JAX package runs ``lax.scan``, with the JAX cell's forget-gate bias
(``sigmoid(f + 1.0)``); the decoder starts from the encoder state and is
fed the input shifted by one step (teacher forcing).

``train_seq2seq`` is the JAX package's: the initial parameters from
``PRNGKey(seed)``, the batch order of ``np.random.default_rng(seed)``,
and optax's Adam step
(:class:`~seldon_core_tpu_torch.components.outlier.base.Adam`), with the
loop over time under autograd where JAX differentiates ``lax.scan``.
The init is drawn on the CPU and moved, so that every device starts
from the same numbers. ``fit`` trains on the detector's device.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

from seldon_core_tpu_torch import rng
from seldon_core_tpu_torch.convert import params_from_numpy
from seldon_core_tpu_torch.device import resolve_device
from .base import OutlierDetector, numpy_tree, params_tree, state_tree, train_loop


def _lstm_init(key, in_dim: int, hidden: int):
    k1, k2 = rng.split(key)
    scale = (1.0 / max(in_dim + hidden, 1)) ** 0.5
    return {
        "wx": rng.normal(k1, (in_dim, 4 * hidden)) * scale,
        "wh": rng.normal(k2, (hidden, 4 * hidden)) * scale,
        "b": torch.zeros((4 * hidden,), dtype=torch.float32, device=key.device),
    }


def _lstm_cell(params, h, c, x_t):
    gates = x_t @ params["wx"] + h @ params["wh"] + params["b"]
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def seq2seq_init(key, n_features: int, hidden: int):
    """The JAX package's ``seq2seq_init`` on ``key``'s device (float32)."""
    ke, kd, kp = rng.split(key, 3)
    return {
        "enc": _lstm_init(ke, n_features, hidden),
        "dec": _lstm_init(kd, n_features, hidden),
        "proj": {
            "w": rng.normal(kp, (hidden, n_features)) * (1.0 / hidden) ** 0.5,
            "b": torch.zeros((n_features,), dtype=torch.float32, device=key.device),
        },
    }


def seq2seq_apply(params, x):
    """x: [batch, time, features] -> reconstruction of the same shape."""
    B, T, _F = x.shape
    H = params["proj"]["w"].shape[0]
    h = c = torch.zeros((B, H), dtype=x.dtype, device=x.device)
    for t in range(T):
        h, c = _lstm_cell(params["enc"], h, c, x[:, t])
    # decoder input: zero then x[:, :-1] (teacher forcing)
    dec_in = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    hs = []
    for t in range(T):
        h, c = _lstm_cell(params["dec"], h, c, dec_in[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1) @ params["proj"]["w"] + params["proj"]["b"]


def train_seq2seq(
    X: np.ndarray,
    hidden: int = 16,
    lr: float = 1e-2,
    epochs: int = 50,
    batch_size: int = 32,
    seed: int = 0,
    device="cuda",
):
    """Fit on normal sequences X [n, time, features] on ``device``;
    returns (params, stats), the JAX package's ``train_seq2seq``."""
    dev = resolve_device(device)
    X = np.asarray(X, dtype=np.float32)
    mean = X.mean(axis=(0, 1))
    std = X.std(axis=(0, 1)) + 1e-8
    Xs = (X - mean) / std
    params = seq2seq_init(rng.prng_key(seed), X.shape[2], hidden)

    def loss(p, batch, _extra):
        return ((batch - seq2seq_apply(p, batch)) ** 2).mean()

    params = train_loop(params, loss, Xs, epochs, batch_size, seed, lr, dev)
    return params, {"mean": mean, "std": std}


class Seq2SeqOutlier(OutlierDetector):
    """Score = per-sequence reconstruction MSE. Accepts [batch, T, F] input
    or [batch, T*F] flattened rows (reshaped with ``seq_len``)."""

    def __init__(
        self,
        threshold: float = 1.0,
        seq_len: Optional[int] = None,
        model_uri: Optional[str] = None,
        device="cuda",
    ):
        super().__init__(threshold=float(threshold))
        self.device = resolve_device(device)
        self.seq_len = None if seq_len is None else int(seq_len)
        self.params = None
        self.stats = None
        self.model_uri = model_uri

    def load(self) -> None:
        if self.model_uri:
            from seldon_core_tpu_torch.storage import Storage

            path = Storage.download(self.model_uri)
            with open(f"{path}/seq2seq.pkl", "rb") as f:
                blob = pickle.load(f)
            self.fit_from(blob["params"], blob["stats"])

    def fit(self, X: np.ndarray, **train_kwargs) -> "Seq2SeqOutlier":
        params, stats = train_seq2seq(X, device=self.device, **train_kwargs)
        return self.fit_from(params, stats)

    def fit_from(self, params, stats) -> "Seq2SeqOutlier":
        self.params = params_from_numpy(numpy_tree(params), device=self.device)
        self.stats = {k: np.asarray(v) for k, v in stats.items()}
        return self

    def save(self, path: str) -> None:
        blob = {"params": numpy_tree(self.params), "stats": self.stats}
        with open(f"{path}/seq2seq.pkl", "wb") as f:
            pickle.dump(blob, f)

    def score(self, X: np.ndarray) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("Seq2SeqOutlier not fitted/loaded")
        X = np.asarray(X, np.float32)
        if X.ndim == 2:
            if not self.seq_len:
                raise ValueError("flattened input needs seq_len")
            X = X.reshape(X.shape[0], self.seq_len, -1)
        Xs = (X - self.stats["mean"]) / self.stats["std"]
        x = torch.from_numpy(np.ascontiguousarray(Xs, np.float32)).to(self.device)
        with torch.no_grad():
            s = ((x - seq2seq_apply(self.params, x)) ** 2).mean(dim=(1, 2))
        return s.cpu().numpy()

    def _coerce(self, X) -> np.ndarray:
        # sequences are 3-d; skip the base class's atleast_2d coercion
        return np.asarray(X, dtype=np.float64)

    # persistence hooks: params + stats
    def to_state_dict(self):
        return {"params": state_tree(numpy_tree(self.params)), "stats": dict(self.stats)}

    def from_state_dict(self, d) -> None:
        self.fit_from(params_tree(d["params"]), d["stats"])
