"""The radix prefix KV cache in the port: the host index
(``serving/prefix_cache.py``) against the JAX package's, the model half
(``DecoderLM.prefill_with_prefix``) against the JAX model's, and the
scheduler half (publish on finish and pre-free, suffix-only admission,
hits under chunking, crash reset) against the JAX batcher with the same
knobs and against the port with the cache off, at the tiny config of
tests/test_torch_serving.py on the CPU.

Tolerances: float32 logits within 1e-5 and the suffix slab within 1e-6
(the frameworks round matmuls differently in the last bits; the slab
holds one projection, the logits a whole forward). Tokens and counters
are compared exactly.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_prefix_cache as reference_cases
from seldon_core_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from seldon_core_tpu.serving.prefix_cache import RadixPrefixIndex as JaxIndex
from seldon_core_tpu_torch.serving import prefix_cache as port_prefix
from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher
from seldon_core_tpu_torch.serving.prefix_cache import RadixPrefixIndex

from _torch_sched import BASE, CFG, JaxReference, make_models, port

LOGITS_TOL, SLAB_TOL = 1e-5, 1e-6
L, KV, DH = CFG["n_layers"], CFG["n_kv_heads"], CFG["d_model"] // CFG["n_heads"]
CACHE = dict(prefix_cache_hbm_bytes=1 << 26, prefix_cache_min_tokens=4)


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def jax_ref(models):
    ref = JaxReference(models)
    yield ref
    ref.close()


# -- the host index --------------------------------------------------------


@pytest.mark.parametrize(
    "case", sorted(n for n in dir(reference_cases) if n.startswith("test_")))
def test_reference_case_on_port_index(case, monkeypatch):
    """Every case of tests/test_prefix_cache.py, run on the port's index."""
    monkeypatch.setattr(reference_cases, "RadixPrefixIndex", RadixPrefixIndex)
    getattr(reference_cases, case)()


def test_version_rules_equal_jax():
    from seldon_core_tpu.serving import prefix_cache as jax_prefix

    versions = [0, 1, "a@1", "a@2", "b@1", "x@y@3", None]
    for old in versions:
        assert port_prefix.version_namespace(old) == jax_prefix.version_namespace(old)
        for new in versions:
            assert (port_prefix.version_retains(old, new)
                    == jax_prefix.version_retains(old, new))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_ops_equal_jax_index(seed):
    """A random sequence of inserts, matches, probes, evictions,
    removals and version switches gives the same answers, bytes and
    eviction counts on both indexes (slabs are tags)."""
    rs = np.random.RandomState(seed)
    j, p = JaxIndex(900), RadixPrefixIndex(900)
    seen = []
    for step in range(400):
        op = rs.randint(7)
        toks = [int(t) for t in rs.randint(0, 4, rs.randint(1, 9))]
        if op <= 1:
            nb = int(rs.randint(50, 300))
            assert j.insert(toks, f"s{step}", nb) == p.insert(toks, f"s{step}", nb)
            seen.append(toks)
        elif op <= 3:
            assert j.match(toks) == p.match(toks)
        elif op == 4:
            assert j.covered_len(toks) == p.covered_len(toks)
        elif op == 5:
            target = int(rs.randint(0, 900))
            assert j.evict_to(target) == p.evict_to(target)
        elif seen:
            gone = seen[rs.randint(len(seen))]
            assert j.remove(gone) == p.remove(gone)
        if step % 97 == 96:
            v = int(rs.randint(3))
            assert j.set_version(v) == p.set_version(v)
        assert (j.total_bytes, j.slab_count, j.node_count) == \
            (p.total_bytes, p.slab_count, p.node_count)


# -- the model half ----------------------------------------------------------


@pytest.mark.parametrize("start,width,prefix_len", [
    (0, 8, 8), (5, 8, 16), (16, 16, 32), (23, 8, 32), (31, 32, 32),
])
def test_prefill_with_prefix_against_jax(models, start, width, prefix_len):
    """Logits and suffix slab at several match depths; the donor's
    residue past the match is random, so the masking is exercised."""
    import torch

    jm, jp, tm, tp = models
    rs = np.random.RandomState(start + width)
    slab = {n: rs.randn(L, 1, KV, prefix_len, DH).astype(np.float32) for n in ("k", "v")}
    toks = rs.randint(0, CFG["vocab_size"], (1, width)).astype(np.int32)
    last = np.array([width - 3], np.int32)
    jl, jslab = jm.prefill_with_prefix(
        jp, {n: jnp.asarray(a) for n, a in slab.items()}, jnp.asarray(toks), start,
        last_index=jnp.asarray(last))
    tslab = {n: torch.from_numpy(a.copy()) for n, a in slab.items()}
    tl, out = tm.prefill_with_prefix(tp, tslab, torch.from_numpy(toks), start,
                                     last_index=torch.from_numpy(last))
    assert float(np.abs(np.asarray(jl) - tl.numpy()).max()) <= LOGITS_TOL
    for n in ("k", "v"):
        assert out[n].shape == (L, 1, KV, width, DH)
        assert float(np.abs(np.asarray(jslab[n]) - out[n].numpy()).max()) <= SLAB_TOL
        np.testing.assert_array_equal(tslab[n].numpy(), slab[n])  # read, not written


def test_prefill_with_prefix_refuses_a_start_past_the_slab(models):
    import torch

    tm, tp = models[2], models[3]
    slab = {n: torch.zeros(L, 1, KV, 8, DH) for n in ("k", "v")}
    with pytest.raises(ValueError, match="outside a prefix slab"):
        tm.prefill_with_prefix(tp, slab, torch.zeros((1, 8), dtype=torch.long), 9)


# -- the scheduler half --------------------------------------------------------


def _shared(seed=23, lens=(4, 6, 3, 25), shared_len=20):
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, CFG["vocab_size"], shared_len).tolist()
    return [shared + rs.randint(0, CFG["vocab_size"], t).tolist() for t in lens]


def _requests(temperature, max_new=6):
    return [(p, dict(max_new_tokens=max_new + i % 3, temperature=temperature if i % 2 else 0.0,
                     seed=7 + i))
            for i, p in enumerate(_shared())]


def _primed(models, reqs, **kw):
    """The first request alone (it publishes), then the rest together:
    ``(outputs, stats)``."""
    b = port(models, **kw)
    try:
        first = b.submit(reqs[0][0], **reqs[0][1]).result(timeout=120)
        futs = [b.submit(p, **r) for p, r in reqs[1:]]
        return [first] + [f.result(timeout=120) for f in futs], dict(b.stats)
    finally:
        b.close()


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_cache_on_equals_jax_and_cache_off(models, jax_ref, temperature):
    reqs = _requests(temperature)
    got, stats = _primed(models, reqs, **CACHE)
    off, _ = _primed(models, reqs)
    assert got == off
    assert got == jax_ref(reqs, **CACHE)
    assert stats["prefix_hits"] == 3 and stats["prefix_misses"] == 1
    assert stats["prefix_tokens_saved"] >= 3 * 20


def _sequential_stats(batcher, reqs):
    try:
        outs = [batcher.generate(p, **r) for p, r in reqs]
        keys = ("prefix_hits", "prefix_misses", "prefix_evicted", "prefix_tokens_saved",
                "prefix_cache_bytes", "admitted", "prefill_tokens")
        return outs, {k: batcher.stats[k] for k in keys}
    finally:
        batcher.close()


def test_counts_equal_jax_under_a_tiny_budget(models):
    """Three families of shared prefixes, one request at a time, under a
    budget of two 32-position slabs (8 KiB each): the same hits, misses,
    saved tokens, evictions and cache bytes as the JAX batcher."""
    reqs = [(p, dict(max_new_tokens=4)) for seed in (1, 2, 3, 1, 3, 2, 1)
            for p in _shared(seed, lens=(4, 7), shared_len=16)]
    knobs = dict(prefix_cache_hbm_bytes=20000, prefix_cache_min_tokens=4)
    jm, jp = models[0], models[1]
    want = _sequential_stats(JaxBatcher(jm, jp, **BASE, **knobs), reqs)
    got = _sequential_stats(port(models, **knobs), reqs)
    assert got == want
    assert got[1]["prefix_evicted"] > 0 and got[1]["prefix_hits"] > 0


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_fused_with_prefix_splice(models, temperature):
    """Hits under fused decode equal the step-at-a-time path's over the
    same splices, and the cache-off run."""
    reqs = _requests(temperature)
    fused, fs = _primed(models, reqs, fused_steps_per_dispatch=16, **CACHE)
    plain, ps = _primed(models, reqs, **CACHE)
    assert fused == plain == _primed(models, reqs)[0]
    assert fs["prefix_hits"] == ps["prefix_hits"] == 3
    assert fs["fused_dispatches"] > 0 and ps["fused_dispatches"] == 0


@pytest.fixture()
def _sub_tile_attn_buckets():
    old = (ContinuousBatcher.MIN_ATTN_BUCKET, JaxBatcher.MIN_ATTN_BUCKET)
    ContinuousBatcher.MIN_ATTN_BUCKET = JaxBatcher.MIN_ATTN_BUCKET = 16
    yield
    ContinuousBatcher.MIN_ATTN_BUCKET, JaxBatcher.MIN_ATTN_BUCKET = old


def test_depth_groups_and_chunking_with_prefix_hits(models, jax_ref, _sub_tile_attn_buckets):
    """Hits whose suffix is longer than one chunk splice the donor into
    the staging slab up to the chunk grid and chunk the rest; with depth
    groups forced to split and fused decode on, the tokens equal the
    JAX batcher's with the same knobs and the port's cache-off run."""
    knobs = dict(attn_bucket=16, depth_groups=4, depth_group_split_bytes=0,
                 prefill_chunk=16, fused_steps_per_dispatch=8)
    reqs = [(p, dict(max_new_tokens=6)) for p in _shared(lens=(4, 6, 25, 3))]
    got, stats = _primed(models, reqs, **knobs, **CACHE)
    assert got == _primed(models, reqs, **knobs)[0]
    assert got == jax_ref(reqs, **knobs, **CACHE)
    assert stats["prefix_hits"] == 3
    assert stats["prefill_chunks"] > 0 and stats["group_bursts"] > 0
    # the 25-token suffix chunked from the grid point below its match
    assert stats["prefix_tokens_saved"] == 20 + 20 + 16


def test_restart_resets_prefix_index(models):
    """The rebuilt loop starts with an empty index and refills it from
    completions after the restart; the tokens stay the same."""
    b = port(models, restart_budget=2, restart_backoff_s=0.01, **CACHE)
    try:
        prompt = list(range(1, 9))
        ref = b.generate(prompt, max_new_tokens=4)
        assert b._prefix_index.covered_len(prompt) == len(prompt)
        died = []

        def hook(poll):
            if not died:
                died.append(poll)
                raise RuntimeError("injected poll death")

        b.fault_hook = hook
        b.submit([9, 9], max_new_tokens=2)
        deadline = time.monotonic() + 30
        while b.stats["batcher_restarts"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert b.stats["batcher_restarts"] == 1
        assert b._prefix_index.covered_len(prompt) == 0
        assert b.stats["prefix_cache_bytes"] == 0
        assert b.generate(prompt, max_new_tokens=4) == ref
        assert b._prefix_index.covered_len(prompt) == len(prompt)
    finally:
        b.close()


def test_short_prompts_and_long_donors_are_declined(models):
    """Below prefix_cache_min_tokens nothing publishes or hits; a donor
    whose bucket exceeds the prompt's is declined (a miss)."""
    b = port(models, prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=6)
    try:
        b.generate([1, 2, 3, 4, 5], max_new_tokens=2)
        assert b._prefix_index.slab_count == 0
        long_ = list(range(1, 21))  # bucket 32
        b.generate(long_, max_new_tokens=2)
        b.generate(long_[:7], max_new_tokens=2)  # bucket 8 < the donor's 32
        assert b.stats["prefix_hits"] == 0 and b.stats["prefix_misses"] == 3
        b.generate(long_[:18], max_new_tokens=2)  # bucket 32: a hit of 17
        assert b.stats["prefix_hits"] == 1 and b.stats["prefix_tokens_saved"] == 17
    finally:
        b.close()


def test_server_reports_cache_hit_tokens(tmp_path):
    """GenerateServer: unary responses and a stream's final chunk carry
    each request's cache_hit_tokens, the metrics the prefix series; the
    knobs arrive as typed parameters."""
    import json

    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    (tmp_path / "jax_config.json").write_text(json.dumps({"family": "llm", "config": CFG}))
    srv = GenerateServer(str(tmp_path), device="cpu", slots=2, steps_per_poll=2,
                         prefix_cache_hbm_bytes=str(1 << 20), prefix_cache_min_tokens="4")
    try:
        p = _shared()[0]
        first = srv.predict({"prompt_tokens": p, "max_new_tokens": 3}, [])
        assert first["cache_hit_tokens"] == [0]
        again = srv.predict({"prompt_tokens": [p, p[:22]], "max_new_tokens": 3}, [])
        assert again["cache_hit_tokens"] == [len(p) - 1, 21]
        assert again["tokens"][0] == first["tokens"][0]
        chunks = list(srv.stream({"prompt_tokens": p, "max_new_tokens": 3}).chunks)
        assert chunks[-1]["done"] and chunks[-1]["cache_hit_tokens"] == len(p) - 1
        keys = {m["key"]: m for m in srv.metrics()}
        assert keys["prefix_cache_hits"]["value"] == 3
        assert keys["prefix_cache_bytes"]["type"] == "GAUGE"
    finally:
        srv.close()
