"""VAE outlier detector, scored on a torch device.

Counterpart of ``seldon_core_tpu/components/outlier/vae.py`` (the
reference's components/outlier-detection/vae, Keras): standardize inputs
with training statistics, score each row by mean reconstruction MSE over
``mc_samples`` latent draws, flag rows whose error exceeds ``threshold``.

The encoder/decoder are the JAX package's plain layer lists (``{"w",
"b"}`` per layer, tanh between them); all MC samples are evaluated in one
batched pass over a leading sample axis (the JAX package's ``vmap``).
The latent noise follows the JAX key chain through
:mod:`seldon_core_tpu_torch.rng`: ``PRNGKey(seed + 1)`` split once per
score, the sub-key split into ``mc_samples`` keys, one ``normal`` draw of
the latent shape per key. Keys stay on the CPU and every draw is made
there, then moved to the device, so that the card and the CPU score and
train on the same noise (``rng.normal``'s ``log1p`` is the device's own).

``train_vae`` is the JAX package's: the same initial parameters from
``seed`` (``PRNGKey(seed)`` split once for the init), the same batch
order (``np.random.default_rng(seed).permutation`` per epoch), one key
split per batch for its noise, and optax's Adam step
(:class:`~seldon_core_tpu_torch.components.outlier.base.Adam`); the
gradient comes from ``torch.autograd.grad`` where JAX runs
``jax.value_and_grad``. ``fit`` trains on the detector's device.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch import rng
from seldon_core_tpu_torch.convert import params_from_numpy
from seldon_core_tpu_torch.device import resolve_device
from .base import OutlierDetector, numpy_tree, params_tree, state_tree, train_loop


def _mlp_init(key, dims):
    keys = rng.split(key, len(dims) - 1)
    return [
        {
            "w": rng.normal(k, (i, o)) * (2.0 / i) ** 0.5,
            "b": torch.zeros((o,), dtype=torch.float32, device=key.device),
        }
        for k, (i, o) in zip(keys, zip(dims[:-1], dims[1:]))
    ]


def _mlp_apply(layers, x, final_linear=True):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or not final_linear:
            x = torch.tanh(x)
    return x


def vae_init(key, n_features: int, hidden: Sequence[int], latent_dim: int):
    """The JAX package's ``vae_init`` on ``key``'s device (float32)."""
    ke, km, kv, kd = rng.split(key, 4)
    return {
        "enc": _mlp_init(ke, (n_features, *hidden)),
        "mu": _mlp_init(km, (hidden[-1], latent_dim)),
        "logvar": _mlp_init(kv, (hidden[-1], latent_dim)),
        "dec": _mlp_init(kd, (latent_dim, *reversed(hidden), n_features)),
    }


def vae_apply(params, x, key):
    """One stochastic forward pass: returns (reconstruction, mu, logvar).
    ``key`` may be a batch of keys ``[S, 2]``: the reconstructions then
    carry a leading sample axis, one draw per key (the JAX package's
    ``vmap`` over keys). The draw is made on ``key``'s device and moved to
    ``x``'s."""
    h = _mlp_apply(params["enc"], x, final_linear=False)
    mu = _mlp_apply(params["mu"], h)
    logvar = _mlp_apply(params["logvar"], h)
    z = mu + torch.exp(0.5 * logvar) * rng.normal(key, tuple(mu.shape)).to(mu.device)
    return _mlp_apply(params["dec"], z), mu, logvar


def vae_loss(params, x, key, beta: float = 1.0):
    recon, mu, logvar = vae_apply(params, x, key)
    mse = ((x - recon) ** 2).sum(dim=-1).mean()
    kl = -0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar)).sum(dim=-1).mean()
    return mse + beta * kl


def train_vae(
    X: np.ndarray,
    hidden: Sequence[int] = (32, 16),
    latent_dim: int = 2,
    beta: float = 1.0,
    lr: float = 1e-3,
    epochs: int = 50,
    batch_size: int = 64,
    seed: int = 0,
    device="cuda",
):
    """Fit a VAE on inlier rows on ``device``; returns (params,
    standardization stats), the JAX package's ``train_vae``."""
    dev = resolve_device(device)
    X = np.atleast_2d(np.asarray(X, dtype=np.float32))
    mean, std = X.mean(axis=0), X.std(axis=0) + 1e-8
    Xs = (X - mean) / std
    key, init_key = rng.split(rng.prng_key(seed))
    params = vae_init(init_key, X.shape[1], tuple(hidden), latent_dim)

    def noise_keys(key):
        while True:
            key, sub = rng.split(key)
            yield sub

    keys = noise_keys(key)
    params = train_loop(
        params, lambda p, batch, key: vae_loss(p, batch, key, beta), Xs,
        epochs, batch_size, seed, lr, dev, on_batch=lambda: next(keys))
    return params, {"mean": mean, "std": std}


class VAEOutlier(OutlierDetector):
    """Score = mean per-row reconstruction MSE over mc_samples latent draws."""

    def __init__(
        self,
        threshold: float = 10.0,
        mc_samples: int = 5,
        model_uri: Optional[str] = None,
        seed: int = 0,
        device="cuda",
    ):
        super().__init__(threshold=float(threshold))
        self.device = resolve_device(device)
        self.mc_samples = int(mc_samples)
        self.params = None
        self.stats: Optional[Dict[str, np.ndarray]] = None
        self._seed = int(seed)
        self._key = None
        self.model_uri = model_uri

    def load(self) -> None:
        if self.model_uri:
            from seldon_core_tpu_torch.storage import Storage

            path = Storage.download(self.model_uri)
            with open(f"{path}/vae.pkl", "rb") as f:
                blob = pickle.load(f)
            self.fit_from(blob["params"], blob["stats"])

    def fit(self, X: np.ndarray, **train_kwargs) -> "VAEOutlier":
        params, stats = train_vae(X, seed=self._seed, device=self.device, **train_kwargs)
        return self.fit_from(params, stats)

    def fit_from(self, params, stats) -> "VAEOutlier":
        """Serve ``params`` (numpy or tensors, the JAX package's layout)
        standardizing with ``stats`` (``mean``/``std`` arrays)."""
        self.params = params_from_numpy(numpy_tree(params), device=self.device)
        self.stats = {k: np.asarray(v) for k, v in stats.items()}
        self._key = rng.prng_key(self._seed + 1)  # on the CPU: see the module doc
        return self

    def save(self, path: str) -> None:
        blob = {"params": numpy_tree(self.params), "stats": self.stats}
        with open(f"{path}/vae.pkl", "wb") as f:
            pickle.dump(blob, f)

    def score(self, X: np.ndarray) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("VAEOutlier not fitted/loaded")
        Xs = (np.asarray(X, np.float32) - self.stats["mean"]) / self.stats["std"]
        pair = rng.split(self._key)
        self._key, sk = pair[0], pair[1]
        x = torch.from_numpy(np.ascontiguousarray(Xs, np.float32)).to(self.device)
        with torch.no_grad():
            recons = vae_apply(self.params, x, rng.split(sk, self.mc_samples))[0]
            s = ((x[None] - recons) ** 2).mean(dim=-1).mean(dim=0)
        return s.cpu().numpy()

    # persistence hooks: params (lists as index-keyed dicts) + stats
    def to_state_dict(self):
        return {"params": state_tree(numpy_tree(self.params)), "stats": dict(self.stats)}

    def from_state_dict(self, d) -> None:
        self.fit_from(params_tree(d["params"]), d["stats"])
