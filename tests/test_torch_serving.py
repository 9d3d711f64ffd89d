"""Port's ContinuousBatcher (seldon_core_tpu_torch.serving.continuous)
against the JAX package's ContinuousBatcher on the same weights and the
same requests, on the CPU, following tests/test_generate_serving.py.

Token streams must be equal — greedy and seeded — whatever shares the
decode batch, however requests are staggered, and at any pipeline depth:
a request's tokens depend only on its prompt, its seed and the weights.
The JAX reference runs each request on one long-lived batcher.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.llm import DecoderLM as JaxLM
from seldon_core_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from seldon_core_tpu_torch.convert import params_from_numpy
from seldon_core_tpu_torch.models.llm import DecoderLM as TorchLM
from seldon_core_tpu_torch.serving.continuous import (
    BatcherDead,
    BudgetExceeded,
    ContinuousBatcher,
    GenRequest,
    PromptTooLong,
)

torch.set_num_threads(1)

CFG = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
           d_ff=64, max_seq=64, dtype="float32")
BUCKETS = (8, 16, 32)


@pytest.fixture(scope="module")
def models():
    jm, tm = JaxLM(**CFG), TorchLM(**CFG)
    jp = jax.jit(jm.init_params)(0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def reference(models):
    """JAX batcher outputs, memoised per (prompt, sampling) request. Each
    reference request runs alone on the JAX batcher (see ROADMAP.md
    queue C: under concurrent submits on the CPU, the JAX batcher has been
    seen crediting an idle lane's filler token 0 into a stream)."""
    jm, jp, _tm, _tp = models
    b = JaxBatcher(jm, jp, slots=4, max_seq=64, prefill_buckets=BUCKETS, steps_per_poll=2)
    memo = {}

    def run(requests):
        for p, kw in requests:
            key = (tuple(p), tuple(sorted(kw.items())))
            if key not in memo:
                memo[key] = b.submit(p, **kw).result(timeout=300)
        return [memo[(tuple(p), tuple(sorted(kw.items())))] for p, kw in requests]

    yield run
    b.close()


def _port(models, **kw):
    _jm, _jp, tm, tp = models
    opts = dict(slots=4, max_seq=64, prefill_buckets=BUCKETS, steps_per_poll=2)
    opts.update(kw)
    return ContinuousBatcher(tm, tp, **opts)


def _requests(seed, lengths, seeded=True, max_new=6):
    rs = np.random.RandomState(seed)
    out = []
    for i, n in enumerate(lengths):
        kw = dict(max_new_tokens=max_new + i % 3)
        if seeded and i % 2:
            kw.update(temperature=0.9, seed=i)
        out.append((rs.randint(0, 256, n).tolist(), kw))
    return out


def test_greedy_matches_jax_and_generate(models, reference):
    jm, jp, _tm, _tp = models
    prompt = [3, 17, 42, 99, 7]
    b = _port(models)
    try:
        got = b.generate(prompt, max_new_tokens=10)
    finally:
        b.close()
    assert got == reference([(prompt, dict(max_new_tokens=10))])[0]
    want = np.asarray(jax.jit(jm.generate, static_argnums=2)(
        jp, jnp.asarray([prompt], jnp.int32), 10))[0].tolist()
    assert got == want


def test_concurrent_greedy_and_seeded_equal_jax(models, reference):
    """More requests than slots, mixed lengths and buckets (incl. the
    max_seq bucket), greedy and seeded cotenants."""
    reqs = _requests(1, (3, 7, 12, 5, 9, 4, 20, 33))
    b = _port(models)
    try:
        futs = [b.submit(p, **kw) for p, kw in reqs]
        got = [f.result(timeout=120) for f in futs]
        assert b.stats["finished"] == len(reqs)
    finally:
        b.close()
    assert got == reference(reqs)


def test_batched_admission_equal_jax(models, reference):
    """Eight same-bucket requests queued before the loop starts are
    admitted as m=4 batched prefills, one per wave of free lanes."""
    reqs = _requests(2, (4, 6, 5, 7, 3, 8, 6, 4))
    b = _port(models)
    try:
        queued = [GenRequest(tokens=p, **kw) for p, kw in reqs]
        for r in queued:
            b._queue.put(r)
        b.start()
        got = [r.future.result(timeout=120) for r in queued]
        # the first wave of four free lanes shares one batched prefill
        assert b.stats["prefill_steps"] <= len(reqs) - 3
    finally:
        b.close()
    assert got == reference(reqs)


def test_mid_flight_admission(models, reference):
    b = _port(models, slots=2, prefill_buckets=(8,))
    try:
        long_f = b.submit([1, 2, 3], max_new_tokens=40)
        time.sleep(0.2)  # the first request is mid-decode now
        short_f = b.submit([9, 8, 7], max_new_tokens=4, temperature=1.0, seed=2)
        short, long_ = short_f.result(timeout=120), long_f.result(timeout=120)
        assert b.stats["admitted"] == 2
    finally:
        b.close()
    assert [short, long_] == reference([
        ([9, 8, 7], dict(max_new_tokens=4, temperature=1.0, seed=2)),
        ([1, 2, 3], dict(max_new_tokens=40)),
    ])


@pytest.mark.parametrize("depth", [1, 3])
def test_eos_stops_early(models, reference, depth):
    prompt = [3, 17, 42]
    full = reference([(prompt, dict(max_new_tokens=20))])[0]
    eos = full[len(prompt) + 3]
    b = _port(models, slots=2, pipeline_depth=depth)
    try:
        stopped = b.generate(prompt, max_new_tokens=20, eos_id=eos)
    finally:
        b.close()
    assert stopped == full[: len(prompt) + 4]
    assert stopped == reference([(prompt, dict(max_new_tokens=20, eos_id=eos))])[0]


def test_pipeline_depths_equivalent(models, reference):
    """Depth 1 (synchronous) and 3 emit the same tokens as JAX under
    churn: more requests than slots, staggered submits, early eos."""
    reqs = _requests(7, (3, 9, 5, 14, 4, 6, 11, 2))
    reqs[2][1]["eos_id"] = reference([reqs[2]])[0][len(reqs[2][0]) + 2]
    results = {}
    for depth in (1, 3):
        b = _port(models, slots=3, prefill_buckets=(8, 16), pipeline_depth=depth)
        try:
            futs = []
            for i, (p, kw) in enumerate(reqs):
                futs.append(b.submit(p, **kw))
                if i % 3 == 2:
                    time.sleep(0.02)  # stagger admissions mid-decode
            results[depth] = [f.result(timeout=120) for f in futs]
        finally:
            b.close()
    assert results[1] == results[3] == reference(reqs)


def test_seed_reproducible_across_cotenants(models):
    b = _port(models)
    try:
        alone = b.generate([7, 7, 7], max_new_tokens=6, temperature=1.0, seed=5)
        fs = [b.submit([i + 1, i + 2], max_new_tokens=12, temperature=0.9, seed=i)
              for i in range(3)]
        crowded = b.generate([7, 7, 7], max_new_tokens=6, temperature=1.0, seed=5)
        for f in fs:
            f.result(timeout=120)
    finally:
        b.close()
    assert alone == crowded


def test_refusals(models):
    b = _port(models)
    try:
        with pytest.raises(PromptTooLong, match="exceeds"):
            b.submit(list(range(64)), max_new_tokens=4)
        with pytest.raises(BudgetExceeded, match="max_new_tokens"):
            b.submit(list(range(40)), max_new_tokens=40)
        with pytest.raises(ValueError, match="empty prompt"):
            b.submit([])
        with pytest.raises(PromptTooLong, match="largest prefill bucket"):
            b._bucket(b.max_seq + 1)
        assert b._bucket(5) == 8
        assert b._bucket(33) == b.max_seq  # falls back to max_seq
    finally:
        b.close()
    with pytest.raises(BatcherDead, match="closed"):
        b.submit([1, 2, 3])


def test_cancel_frees_the_lane(models, reference):
    b = _port(models, slots=1, prefill_buckets=(8,))
    try:
        f = b.submit([1, 2, 3], max_new_tokens=50)
        f.cancel()
        got = b.generate([4, 5, 6], max_new_tokens=5)
    finally:
        b.close()
    assert got == reference([([4, 5, 6], dict(max_new_tokens=5))])[0]


def test_loop_death_fails_inflight_then_restarts(models, reference):
    b = _port(models, restart_backoff_s=0.0)
    calls = {"n": 0}

    def boom(poll):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected")

    b.fault_hook = boom
    try:
        f = b.submit([1, 2, 3], max_new_tokens=30)
        with pytest.raises(BatcherDead, match="restarting"):
            f.result(timeout=120)
        deadline = time.time() + 30
        while b.health != "serving" or not b.stats["batcher_restarts"]:
            assert time.time() < deadline
            time.sleep(0.01)
        assert b.generate([4, 5, 6], max_new_tokens=5) == \
            reference([([4, 5, 6], dict(max_new_tokens=5))])[0]
    finally:
        b.close()


def test_warm_then_serve_equal(models, reference):
    reqs = _requests(3, (5, 20))
    b = _port(models)
    try:
        b.warm(prompt_lens=(5, 20), max_new_tokens=8)
        got = [b.submit(p, **kw).result(timeout=120) for p, kw in reqs]
    finally:
        b.close()
    assert got == reference(reqs)


@pytest.mark.parametrize("knob,on,off", [
    ("hbm_ledger_bytes", 1 << 30, 0), ("host_kv_tier_bytes", 1 << 20, 0),
    ("prefix_cache_hbm_bytes", 1 << 20, 0), ("swap_drain_ms", 100, 0),
    ("flight_recorder_capacity", 512, 0),
])
def test_unported_knobs_raise(models, knob, on, off):
    with pytest.raises(NotImplementedError, match="not ported"):
        _port(models, **{knob: on})
    _port(models, **{knob: off}).close()  # the off value is accepted
