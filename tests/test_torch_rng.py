"""Port's threefry PRNG (seldon_core_tpu_torch.rng) against jax.random as
this tree configures it (threefry2x32, partitionable, low-range Gumbel).

Key words must be bit-equal. Categorical draws must be equal: the Gumbel
noise itself may differ in its last bit (XLA's and PyTorch's float32 log
round differently), which changes a draw only when two candidates tie to
within that bit — these fixed logits have no such tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu_torch import rng

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_prng_key_and_split_chain_bit_equal():
    seeds = np.arange(-50, 950, dtype=np.int32)
    jk = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds))
    tk = rng.prng_key(torch.from_numpy(seeds.astype(np.int64)))
    np.testing.assert_array_equal(_np(jk), tk.numpy())
    jsplit = jax.jit(jax.vmap(jax.random.split))
    for _ in range(64):
        js = jsplit(jk)
        ts = rng.split(tk)
        np.testing.assert_array_equal(_np(js), ts.numpy())
        jk, tk = js[:, 1], ts[:, 1]  # walk the sub-key branch too
    # multi-way split of one key
    np.testing.assert_array_equal(
        _np(jax.random.split(jax.random.PRNGKey(7), 5)), rng.split(rng.prng_key(7), 5).numpy()
    )


def test_known_words():
    assert rng.split(rng.prng_key(7)).tolist() == [
        [3625411723, 1954958720], [195045567, 4062205631]
    ]


def test_seed_range_enforced():
    with pytest.raises(ValueError, match="32 bits"):
        rng.prng_key(1 << 31)


def test_uniform_bit_equal():
    tiny = float(np.finfo(np.float32).tiny)
    for seed in range(20):
        want = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(seed), (3, 257), minval=tiny, maxval=1.0))
        got = rng.uniform(rng.prng_key(seed), (3, 257), minval=tiny).numpy()
        np.testing.assert_array_equal(got, want)


def test_categorical_draws_equal():
    logits = (np.random.RandomState(0).randn(4, 256) * 3).astype(np.float32)
    cat = jax.jit(lambda k, lg: jax.random.categorical(k, lg, axis=-1))
    rows = jax.jit(jax.vmap(lambda k, lg: jax.random.categorical(k, lg)))
    for seed in range(200):
        want = np.asarray(cat(jax.random.PRNGKey(seed), jnp.asarray(logits)))
        got = rng.categorical(rng.prng_key(seed), torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)
        keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(seed, seed + 4))
        want = np.asarray(rows(keys, jnp.asarray(logits)))
        got = rng.categorical_rows(
            rng.prng_key(torch.arange(seed, seed + 4)), torch.from_numpy(logits)
        ).numpy()
        np.testing.assert_array_equal(got, want)


@jax.jit
def _jax_sample_next(keys, logits, temps):
    # seldon_core_tpu/serving/continuous.py's sample_next, verbatim
    greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    split = jax.vmap(jax.random.split)(keys)
    keys, subs = split[:, 0], split[:, 1]
    sampled = jax.vmap(
        lambda k, lg, t: jax.random.categorical(k, lg / jnp.maximum(t, 1e-6))
    )(subs, logits, temps).astype(jnp.int32)
    return keys, jnp.where(temps > 0, sampled, greedy)


@pytest.mark.parametrize("temps", [[0.0, 0.7, 1.0, 0.0, 1.5, 0.3],
                                   [0.0] * 6])
def test_batched_sample_next_equal(temps):
    """A step of the batcher's per-lane sampler, many steps in a row:
    every lane's key splits each step (idle greedy lanes too), so the
    keys and the drawn tokens stay equal along the whole chain."""
    rs = np.random.RandomState(1)
    temps = np.asarray(temps, np.float32)
    jk = jax.vmap(jax.random.PRNGKey)(jnp.arange(6))
    tk = rng.prng_key(torch.arange(6))
    tt = torch.from_numpy(temps)
    for _ in range(40):
        logits = (rs.randn(6, 256) * 2).astype(np.float32)
        jk, jtok = _jax_sample_next(jk, jnp.asarray(logits), jnp.asarray(temps))
        tk, ttok = rng.sample_next(tk, torch.from_numpy(logits), tt,
                                   stochastic=bool((temps > 0).any()))
        np.testing.assert_array_equal(_np(jk), tk.numpy())
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
