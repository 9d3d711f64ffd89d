"""The RAG graph's retrieval families and the port's new samplers against
the JAX package, on the CPU.

* ``rng.randint`` and the threefry bits equal ``jax.random`` bit for bit.
* ``rng.normal`` equals ``jax.random.normal`` within ``NORMAL_ULPS``
  float32 ulps: the uniform draw is bit-exact, XLA's ``ErfInv``
  polynomial is spelled out with each Horner step rounded once (XLA
  contracts them into FMAs), and the rest is ``log1p``, the device's own
  (measured: at most 3 ulps, on about 1% of draws).
* The corpus (``corpus_params``) is the JAX package's: doc rows bit for
  bit, embeddings within ``NORMAL_ULPS``.
* ``RetrievalIndex`` and ``Reranker`` at float32 on the JAX package's
  parameters give its indices and doc rows exactly; equal scores give
  the lower index (``lax.top_k``'s order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import retrieval as jret
from seldon_core_tpu_torch import models as tmodels
from seldon_core_tpu_torch import rng
from seldon_core_tpu_torch.convert import params_from_numpy
from seldon_core_tpu_torch.models import retrieval as tret

torch.set_num_threads(1)

NORMAL_ULPS = 4

CFG = dict(corpus_size=64, d_embed=16, top_k=4, doc_len=6, vocab_size=256, seed=7)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 7 ^ 0x5EED, 2**31 - 1])
def test_bits_and_split_equal_jax(seed):
    key, tkey = jax.random.PRNGKey(seed), rng.prng_key(seed)
    np.testing.assert_array_equal(
        rng.split(tkey, 5).numpy(), np.asarray(jax.random.split(key, 5)).astype(np.int64))
    np.testing.assert_array_equal(
        rng.random_bits(tkey, (3, 33)).numpy(),
        np.asarray(jax.random.bits(key, (3, 33), jnp.uint32)).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(1, 256), (1, 32000), (0, 1), (5, 5), (9, 3),
                                   (-7, 3), (-2**31, 2**31 - 1), (0, 2**31 - 1)])
def test_randint_equals_jax_bit_for_bit(lo, hi):
    key = jax.random.PRNGKey(11)
    got = rng.randint(rng.prng_key(11), (17, 40), lo, hi)
    want = np.asarray(jax.random.randint(key, (17, 40), lo, hi, jnp.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 3, 7 ^ 0x5EED])
def test_normal_equals_jax_within_ulps(seed):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (256, 256), jnp.float32))
    got = rng.normal(rng.prng_key(seed), (256, 256))
    assert got.dtype == torch.float32
    ulps = _ulps(got.numpy(), want)
    assert ulps.max() <= NORMAL_ULPS
    assert (ulps > 0).mean() < 0.05  # almost every draw bit-exact
    # a batch of keys draws per key, as vmap over keys does
    keys = rng.split(rng.prng_key(seed), 3)
    jkeys = jax.random.split(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (5, 7)))(jkeys))
    assert _ulps(rng.normal(keys, (5, 7)).numpy(), want).max() <= NORMAL_ULPS


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.5, 0.999999], dtype=torch.float32)
    got = rng.erf_inv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.isneginf(got[0]) and np.isposinf(got[1]) and got[2] == 0.0
    assert _ulps(got[2:], want[2:]).max() <= NORMAL_ULPS


def test_corpus_equals_jax():
    """Both families' corpus under both packages: the contract that lets
    two units (and two packages) with one config serve one corpus."""
    jemb, jdocs = jret.corpus_params(7, 64, 16, 6, 256)
    temb, tdocs = tret.corpus_params(7, 64, 16, 6, 256, device="cpu")
    np.testing.assert_array_equal(tdocs.numpy(), np.asarray(jdocs))
    assert tdocs.dtype == torch.int32 and int(tdocs.min()) >= 1
    assert _ulps(temb.numpy(), jemb).max() <= NORMAL_ULPS
    for fam in ("retrieval", "reranker"):
        jp = jret.RetrievalIndex(**CFG) if fam == "retrieval" else jret.Reranker(**CFG)
        tp = tmodels.build(fam, **CFG).init_params(device="cpu")
        jp = jp.init_params()
        assert _ulps(tp["emb"].numpy(), jp["emb"]).max() <= NORMAL_ULPS
        if fam == "reranker":
            np.testing.assert_array_equal(tp["docs"].numpy(), np.asarray(jp["docs"]))
            assert [set(layer) for layer in tp["scorer"]] == [set(layer) for layer in jp["scorer"]]


def _pair(dtype):
    cfg = dict(CFG, dtype=dtype)
    ji, jr = jret.RetrievalIndex(**cfg), jret.Reranker(**cfg)
    ti, tr = tret.RetrievalIndex(**cfg), tret.Reranker(**cfg)
    jpi, jpr = ji.init_params(), jr.init_params()
    tpi = params_from_numpy(jax.tree.map(np.asarray, jpi), device="cpu")
    tpr = params_from_numpy(jax.tree.map(np.asarray, jpr), device="cpu")
    return (ji, jpi, ti, tpi), (jr, jpr, tr, tpr)


def test_retrieval_and_rerank_equal_jax_f32():
    (ji, jpi, ti, tpi), (jr, jpr, tr, tpr) = _pair("float32")
    q = np.random.RandomState(0).randn(12, 16).astype(np.float32)
    jo = np.asarray(jax.jit(ji.apply)(jpi, q))
    to = ti.apply(tpi, torch.from_numpy(q))
    assert to.dtype == torch.float32 and to.shape == (12, 16 + 4)
    np.testing.assert_array_equal(to.numpy(), jo)  # query rows and indices
    jd = np.asarray(jax.jit(jr.apply)(jpr, jo))
    td = tr.apply(tpr, torch.from_numpy(np.array(jo)))
    assert td.dtype == torch.int32 and td.shape == (12, 6)
    np.testing.assert_array_equal(td.numpy(), jd)


def test_retrieval_and_rerank_bf16_hop():
    """At the default bf16 the candidate indices ride as bf16 floats and
    stay exact (corpus <= 256); the port's doc rows equal the JAX
    package's on the same indices."""
    (ji, jpi, ti, tpi), (jr, jpr, tr, tpr) = _pair("bfloat16")
    q = np.random.RandomState(1).randn(6, 16).astype(np.float32)
    to = ti.apply(tpi, torch.from_numpy(q).to(torch.bfloat16))
    idx = to[:, 16:]
    assert torch.equal(idx, idx.round()) and int(idx.max()) < 64
    x = to.to(torch.bfloat16)
    jd = np.asarray(jr.apply(jpr, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)))
    np.testing.assert_array_equal(tr.apply(tpr, x).numpy(), jd)


def test_top_k_ties_break_to_lower_index():
    scores = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                           [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    got = tret.top_k_indices(scores, 4)
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores.numpy()), 4)[1])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [[1, 2, 4, 5], [0, 1, 2, 3]])
    # through the model: a corpus with repeated rows scores equal
    idx = tret.RetrievalIndex(corpus_size=8, d_embed=4, top_k=3, dtype="float32")
    emb = torch.ones(8, 4)
    out = idx.apply({"emb": emb}, torch.ones(2, 4))
    np.testing.assert_array_equal(out[:, 4:].numpy(), [[0, 1, 2], [0, 1, 2]])


def test_refusals():
    for cls in (tret.RetrievalIndex, tret.Reranker):
        with pytest.raises(ValueError, match="corpus_size 257 > 256"):
            cls(corpus_size=257, d_embed=8)
        cls(corpus_size=256, d_embed=8)  # the bf16-exact limit itself is served
    with pytest.raises(ValueError, match="top_k 8 > corpus_size 4"):
        tret.RetrievalIndex(corpus_size=4, top_k=8)
    assert tret.Reranker(hidden=16).flops_per_row() == jret.Reranker(hidden=16).flops_per_row()
    assert tret.RetrievalIndex(**CFG).flops_per_row() == jret.RetrievalIndex(**CFG).flops_per_row()
