"""JAX's counter-based PRNG (threefry2x32) in PyTorch integer ops.

The JAX package samples with ``jax.random`` under this tree's settings:
the ``threefry2x32`` implementation with ``jax_threefry_partitionable``
on, and the low-dynamic-range Gumbel sampler. A seeded request's tokens
are a function of that key chain, so the port reproduces it bit for bit
instead of using ``torch.Generator``: the same request and seed draw the
same tokens under both packages.

A key is a pair of uint32 words. Here every uint32 lives in an int64
tensor, masked to 32 bits after each add and shift, so the same integer
ops give the same bits on the CPU and on CUDA. Keys are ``[..., 2]``
int64 tensors holding ``(hi, lo)`` words, the layout of JAX's raw keys.

Recipes (``jax/_src/prng.py``, ``jax/_src/random.py``):

* ``PRNGKey(seed)`` = ``[seed >> 32, seed & 0xFFFFFFFF]``; seeds are
  32-bit here, so the high word is 0.
* ``split(key, n)``: threefry2x32 of the key over the counter pairs
  ``(i >> 32, i & 0xFFFFFFFF)`` for ``i < n``; the two output words of
  counter ``i`` are new key ``i``.
* 32 random bits for a ``shape``: the same hash over the flat index of
  each element, the two output words XORed.
* ``uniform`` (float32): the top 23 random bits become a mantissa in
  [1, 2), minus 1, then ``max(minval, u * (maxval - minval) + minval)``.
* ``categorical(key, logits)`` = ``argmax(-log(-log(U)) + logits)`` with
  ``U = uniform(minval=tiny, maxval=1)`` over the logits' shape.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x1, x2)``
    under key words ``(k1, k2)``; all int64 tensors holding uint32 values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for one seed or a 1-D batch of seeds
    (a Python int, a sequence, a numpy array or an integer tensor),
    placed on ``device``. 32-bit seeds only, as the JAX package passes
    them."""
    s = torch.as_tensor(seed, dtype=torch.int64)
    if bool(((s < -(1 << 31)) | (s >= (1 << 31))).any()):
        raise ValueError("PRNG seeds must fit in 32 bits")
    return torch.stack([torch.zeros_like(s), s & MASK], dim=-1).to(device)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(tuple(shape))
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` for a key ``[..., 2]`` (a batch of keys splits
    each one, like ``vmap(split)``): returns ``[..., num, 2]``."""
    hi, lo = _counters((num,), key.device)
    k1 = key[..., 0:1]
    k2 = key[..., 1:2]
    a, b = threefry2x32(k1, k2, hi, lo)
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` from each key of ``key``
    ``[..., 2]``: returns ``[..., *shape]`` int64 in [0, 2**32)."""
    hi, lo = _counters(shape, key.device)
    lead = key.shape[:-1]
    view = (*lead, *([1] * len(shape)))
    k1 = key[..., 0].reshape(view)
    k2 = key[..., 1].reshape(view)
    a, b = threefry2x32(k1, k2, hi, lo)
    return a ^ b


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 for each key of ``key``."""
    bits = random_bits(key, shape)
    mant = (bits >> 9) | 0x3F800000  # 1.0's exponent with 23 random bits
    floats = mant.to(torch.int32).view(torch.float32) - 1.0
    # float32 scalars, computed on the host: a device scalar tensor would
    # cost a host-to-device copy (and a stream sync) per draw
    lo = torch.tensor(minval, dtype=torch.float32)
    width = (torch.tensor(maxval, dtype=torch.float32) - lo).item()
    lo = lo.item()
    return torch.clamp(floats * width + lo, min=lo)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, low-dynamic-range mode)."""
    u = uniform(key, shape, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for ONE key
    ``[2]``: the Gumbel noise spans the whole logits shape."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)


def categorical_rows(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``vmap(jax.random.categorical)`` over rows: key ``i`` ``[S, 2]``
    draws from ``logits[i]`` ``[S, V]``."""
    return torch.argmax(gumbel(keys, logits.shape[1:]) + logits, dim=-1)


def sample_next(keys: torch.Tensor, logits: torch.Tensor, temps: torch.Tensor,
                stochastic: bool = True):
    """The batcher's per-lane sampler: split every lane's key, draw
    categorical at ``temps > 0``, argmax otherwise. Returns
    ``(new_keys [S, 2], tokens [S] int64)``.

    Every lane's key splits every step, busy or idle, as in the JAX
    batcher, so a lane's stream does not depend on its neighbours.
    ``stochastic=False`` (no lane has a temperature) skips the Gumbel
    draw, whose result the greedy select would discard anyway."""
    greedy = torch.argmax(logits, dim=-1)
    pair = split(keys)
    keys, subs = pair[:, 0], pair[:, 1]
    if not stochastic:
        return keys, greedy
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sampled = categorical_rows(subs, scaled)
    return keys, torch.where(temps > 0, sampled, greedy)
