"""Chunked prefill in the port (``prefill_chunk``): the model half
(``DecoderLM.prefill_chunk`` and the ``[B, T]`` attention bound) against
the JAX package's, and the scheduler half (one chunk per poll into a
staging slab, then the ordinary lane insert) against whole-prompt
admission and against the JAX batcher with the same knobs, on the CPU at
the tiny config of tests/test_torch_serving.py.

Tolerances: float32 logits within 1e-5 and the slab within 1e-6 (the
frameworks round matmuls differently in the last bits; the slab holds
one projection, the logits a whole forward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.llm import DecoderLM as JaxLM
from seldon_core_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from seldon_core_tpu_torch.models.llm import DecoderLM as TorchLM
from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

from _torch_sched import CFG, JaxReference, make_models, mixed, port, run_port

LOGITS_TOL, SLAB_TOL = 1e-5, 1e-6
L, KV, DH = CFG["n_layers"], CFG["n_kv_heads"], CFG["d_model"] // CFG["n_heads"]


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def jax_ref(models):
    ref = JaxReference(models)
    yield ref
    ref.close()


def _maxdiff(a, b):
    return float(np.abs(np.asarray(a) - b.detach().numpy()).max())


@pytest.mark.parametrize("start,attn_len,want_logits", [
    (0, 8, True), (8, 16, True), (16, 32, False), (24, 32, True),
])
def test_prefill_chunk_against_jax(models, start, attn_len, want_logits):
    jm, jp, tm, tp = models
    rs = np.random.RandomState(start)
    bucket, C = 32, 8
    slab = {n: rs.randn(L, 1, KV, bucket, DH).astype(np.float32) for n in ("k", "v")}
    toks = rs.randint(0, CFG["vocab_size"], (1, C)).astype(np.int32)
    last = np.array([5], np.int32)
    chunk = jax.jit(jm.prefill_chunk, static_argnames=("attn_len", "want_logits"))
    jl, jslab = chunk(jp, {n: jnp.asarray(a) for n, a in slab.items()}, jnp.asarray(toks),
                      start, attn_len=attn_len, last_index=jnp.asarray(last),
                      want_logits=want_logits)
    tslab = {n: torch.from_numpy(a.copy()) for n, a in slab.items()}
    tl, out = tm.prefill_chunk(tp, tslab, torch.from_numpy(toks), start, attn_len,
                               last_index=torch.from_numpy(last), want_logits=want_logits)
    assert out is tslab  # extended in place
    for n in ("k", "v"):
        assert _maxdiff(jslab[n], tslab[n]) <= SLAB_TOL
        # positions outside the chunk are untouched
        keep = np.ones(bucket, bool)
        keep[start:start + C] = False
        np.testing.assert_array_equal(tslab[n].numpy()[:, :, :, keep], slab[n][:, :, :, keep])
    if want_logits:
        assert _maxdiff(jl, tl) <= LOGITS_TOL
    else:
        assert jl is None and tl is None


def test_prefill_chunk_refuses_a_chunk_past_the_slab(models):
    tm, tp = models[2], models[3]
    slab = {n: torch.zeros(L, 1, KV, 16, DH) for n in ("k", "v")}
    with pytest.raises(ValueError, match="does not fit"):
        tm.prefill_chunk(tp, slab, torch.zeros((1, 8), dtype=torch.long), 12, 16)


@pytest.mark.parametrize("bound_rank", [1, 2])
def test_cache_attention_bound_against_jax(bound_rank):
    """``_cache_attention`` with a [B] bound (decode) and a [B, T] bound
    (a chunk: prefix plus in-window causality), grouped K/V (H 4, KV 2)."""
    rs = np.random.RandomState(bound_rank)
    B, H, T, Ta, Dh = 2, 4, 5, 12, 8
    q = rs.randn(B, H, T, Dh).astype(np.float32)
    kc = rs.randn(B, 2, Ta, Dh).astype(np.float32)
    vc = rs.randn(B, 2, Ta, Dh).astype(np.float32)
    if bound_rank == 1:
        bound = np.array([4, 11], np.int32)
    else:
        bound = (np.array([[3], [6]]) + np.arange(T)[None, :]).astype(np.int32)
    want = JaxLM._cache_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(bound), jnp.float32)
    got = TorchLM._cache_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                   torch.from_numpy(vc), torch.from_numpy(bound).long(),
                                   torch.float32)
    assert _maxdiff(want, got) <= SLAB_TOL


def _long(temperature=0.0):
    # bucket 16, 32 and the max_seq bucket 64: all longer than one chunk
    return mixed(5, (12, 30, 40, 4, 20), max_new=6, temperature=temperature)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_chunked_equals_whole_prompt(models, jax_ref, temperature):
    reqs = _long(temperature)
    whole, _ = run_port(models, reqs)
    chunked, stats = run_port(models, reqs, prefill_chunk=8)
    assert chunked == whole
    assert chunked == jax_ref(reqs)
    assert stats["prefill_chunks"] > 0
    # the 4-token prompt fits one chunk: admitted whole
    assert stats["prefill_steps"] > stats["prefill_chunks"]


@pytest.fixture()
def _sub_tile_attn_buckets():
    old = (ContinuousBatcher.MIN_ATTN_BUCKET, JaxBatcher.MIN_ATTN_BUCKET)
    ContinuousBatcher.MIN_ATTN_BUCKET = JaxBatcher.MIN_ATTN_BUCKET = 16
    yield
    ContinuousBatcher.MIN_ATTN_BUCKET, JaxBatcher.MIN_ATTN_BUCKET = old


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_chunked_fused_grouped_equal_jax(models, jax_ref, _sub_tile_attn_buckets,
                                         temperature):
    knobs = dict(prefill_chunk=16, fused_steps_per_dispatch=16, depth_groups=4,
                 depth_group_split_bytes=0, attn_bucket=16)
    reqs = _long(temperature)
    got, stats = run_port(models, reqs, stagger=0.03, **knobs)
    assert got == jax_ref(reqs, **knobs)
    assert got == run_port(models, reqs, attn_bucket=16)[0]
    assert stats["prefill_chunks"] > 0 and stats["fused_dispatches"] > 0


def test_cancelled_chunk_job_frees_its_slot(models, jax_ref):
    """One lane: a long prompt reserves it for chunked prefill and is
    cancelled after its first chunk; the lane is free again and the next
    request is served."""
    b = port(models, slots=1, prefill_chunk=8)
    cancelled = {}

    def hook(poll):
        job = next(iter(b._chunked.values()), None)
        if job is not None and job.next_start > 0 and not cancelled:
            cancelled["at"] = job.next_start
            job.request.future.cancel()

    b.fault_hook = hook
    try:
        long_f = b.submit(list(range(1, 41)), max_new_tokens=4)
        nxt = b.generate([4, 5, 6], max_new_tokens=5)
        assert long_f.cancelled() and cancelled["at"] == 8
        assert not b._chunked and b.stats["cancelled"] == 1
        assert b.stats["prefill_chunks"] == 1
    finally:
        b.close()
    assert nxt == jax_ref([([4, 5, 6], dict(max_new_tokens=5))])[0]


def test_warm_runs_chunk_variants_then_serves_equal(models, jax_ref):
    reqs = _long()
    b = port(models, prefill_chunk=8, fused_steps_per_dispatch=8)
    try:
        b.warm(prompt_lens=(12, 30, 40), max_new_tokens=8)
        got = [b.submit(p, **kw).result(timeout=120) for p, kw in reqs]
        assert not b._chunked and not b._active
    finally:
        b.close()
    assert got == jax_ref(reqs)
