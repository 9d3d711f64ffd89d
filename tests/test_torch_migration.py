"""Live-lane migration, graceful drain, resume tokens and weight swap in
the port (serving/migration.py, ContinuousBatcher.drain /
submit_checkpoint / request_weight_swap, GenerateServer.drain_to /
resume_checkpoint / hot_swap and the engine's /drain and /weights/swap),
held against the JAX package at the 2-layer float32 config of
tests/_torch_sched.py on the CPU.

Mirrors tests/test_migration.py and the swap cases of
tests/test_rollout.py: SGC1 frames are byte-identical between the
packages and each decodes the other's, ``derive_lane_key`` gives the JAX
package's words and the key a live lane holds on every admission path,
drained, token-resumed and swapped streams equal the JAX package's token
for token (greedy and seeded; every JAX reference request run alone, as
ROADMAP.md §C asks), and the refusals are the JAX package's statuses.
"""

import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.llm import DecoderLM as JaxLM
from seldon_core_tpu.serving import migration as jax_migration
from seldon_core_tpu_torch.convert import params_from_numpy
from seldon_core_tpu_torch.models.llm import DecoderLM as TorchLM
from seldon_core_tpu_torch.serving.continuous import BatcherDead
from seldon_core_tpu_torch.serving.disagg import (
    ChecksumError,
    TruncatedStream,
    WeightVersionMismatch,
)
from seldon_core_tpu_torch.serving.migration import (
    MigrationError,
    ResumeTokenError,
    checkpoint_of,
    checkpoint_token,
    decode_checkpoint,
    derive_lane_key,
    encode_checkpoint,
    parse_token,
)

from _torch_engine import Served, build_app, close_app, gen_unit, generator_of, make_model_dir
from _torch_sched import BASE, CFG, JaxBatcher, JaxReference, make_models, port

PORT = "seldon_core_tpu_torch"
PROMPTS = [[3, 17, 42, 99, 7], [1, 2, 3], [9, 8, 7, 6]]
GREEDY = [(p, dict(max_new_tokens=40)) for p in PROMPTS[:2]]
SEEDED = (PROMPTS[2], dict(max_new_tokens=30, temperature=0.8, seed=13))
# the generate server's geometry (its batcher's default buckets clip to
# max_seq 64), so its JAX references prefill at the same bucket
SERVER_KNOBS = dict(slots=2, steps_per_poll=1, prefill_buckets=(32,))


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def jax_ref(models):
    ref = JaxReference(models)
    yield ref
    ref.close()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("mig-llm"))


def wait_lanes(b, n, emitted=0, timeout=60.0):
    """Until ``n`` lanes are live (chunk jobs count while ``emitted`` is
    0) and each has credited at least ``emitted`` tokens."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        lanes = list(b._active.values())
        live = len(lanes) + (0 if emitted else len(b._chunked))
        if live >= n and all(len(s.emitted) >= emitted for s in lanes):
            return True
        time.sleep(0.001)
    return False


def _server(model_dir, **kw):
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    kw.setdefault("slots", 2)
    kw.setdefault("steps_per_poll", 1)
    srv = GenerateServer(model_uri=model_dir, device="cpu", **kw)
    srv.load()
    return srv


def _consume(handle, spans, box, done):
    try:
        for ch in handle.chunks:
            if ch.get("done"):
                box["final"] = ch
                break
            spans.append(list(ch["tokens"]))
    except Exception as e:  # noqa: BLE001 - reported by the test
        box["error"] = e
    finally:
        done.set()


# -- SGC1 codec ------------------------------------------------------------------


CK = {
    "v": 1, "prompt": [1, 2, 3], "emitted": [4, 5],
    "rng_key": [7, 9], "max_new_tokens": 16, "temperature": 0.5,
    "eos_id": None, "seed": 3, "weight_version": 0,
    "wait_s": 0.25, "submit_wall_us": 123456, "deadline_s": None,
    "stream_pos": 2,
}


@pytest.mark.parametrize("ck", [CK, {**CK, "rng_key": None, "weight_version": "acme@2",
                                     "text_mode": True, "deadline_s": 1.5}])
def test_codec_frames_byte_identical_and_cross_decode(ck):
    frame = encode_checkpoint(ck)
    assert frame == jax_migration.encode_checkpoint(ck)
    assert decode_checkpoint(frame) == ck
    assert jax_migration.decode_checkpoint(frame) == ck
    token = checkpoint_token(ck)
    assert token == jax_migration.checkpoint_token(ck)
    assert parse_token(token) == jax_migration.parse_token(token) == ck


def test_codec_typed_refusals():
    ck = {"v": 1, "prompt": [1], "emitted": [], "seed": 0}
    raw = bytearray(encode_checkpoint(ck))
    raw[-2] ^= 0xFF  # corrupt the JSON payload
    with pytest.raises(ChecksumError):
        decode_checkpoint(bytes(raw))
    with pytest.raises(TruncatedStream):
        decode_checkpoint(encode_checkpoint(ck)[:-4])
    with pytest.raises(MigrationError, match="magic"):
        decode_checkpoint(b"XXXX" + encode_checkpoint(ck)[4:])
    with pytest.raises(MigrationError, match="version"):
        decode_checkpoint(encode_checkpoint({**ck, "v": 99}))
    with pytest.raises(MigrationError, match="base64"):
        parse_token("!!not//base64!!")
    with pytest.raises(MigrationError, match="prompt"):
        decode_checkpoint(encode_checkpoint({"v": 1, "prompt": []}))


def test_malformed_resume_token_is_client_fault_400():
    tok = checkpoint_token({"v": 1, "prompt": [1, 2], "emitted": [3], "seed": 0})
    corrupted = tok[:-6] + ("AAAAAA" if not tok.endswith("AAAAAA") else "BBBBBB")
    for bad in ("!!not//base64!!", corrupted, tok[: len(tok) // 2]):
        with pytest.raises(ResumeTokenError) as ei:
            parse_token(bad)
        assert ei.value.status == 400
        with pytest.raises(jax_migration.ResumeTokenError):
            jax_migration.parse_token(bad)


@pytest.mark.parametrize("seed,emitted", [(0, 0), (5, 1), (5, 7), (13, 30),
                                          (2**31 - 1, 12), (-3, 4)])
def test_derive_lane_key_matches_jax(seed, emitted):
    assert derive_lane_key(seed, emitted) == jax_migration.derive_lane_key(seed, emitted)


# -- the key a live lane holds, on every admission path ----------------------------


def _drain_keys(b, submits, emitted=3):
    """Submit (the loop held until every request is queued, so they share
    one admission wave), wait until every lane credited ``emitted``
    tokens, drain: the drained requests' checkpoints."""
    gate = threading.Event()
    b.fault_hook = lambda _n: gate.wait(10)
    b.start()
    futs = [b.submit(p, **kw) for p, kw in submits]
    gate.set()
    assert wait_lanes(b, len(submits), emitted=emitted)
    drained = b.drain()
    assert drained and all(r.resume is not None for r in drained)
    for f in futs:
        f.cancel()
    return drained


@pytest.mark.parametrize("path", ["whole", "batched", "prefix", "chunked", "fused"])
def test_derived_lane_key_matches_live_checkpoint(models, path):
    """A keyless crash token is resumed with ``derive_lane_key(seed, n)``:
    it must be the key the lane really holds after n emitted tokens,
    whichever path admitted the lane and however its bursts ran."""
    long_prompt = list(range(1, 41))
    kw = dict(max_new_tokens=20, temperature=0.7)
    if path == "whole":
        b, submits = port(models, steps_per_poll=1), [(PROMPTS[0], dict(kw, seed=5))]
    elif path == "batched":
        b = port(models, steps_per_poll=1)
        submits = [([i + 1, 2, 3, 4], dict(kw, seed=20 + i)) for i in range(4)]
    elif path == "prefix":
        b = port(models, steps_per_poll=1, prefix_cache_hbm_bytes=1 << 20,
                 prefix_cache_min_tokens=4)
        b.generate(long_prompt[:20], max_new_tokens=2)  # publishes the prefix
        submits = [(long_prompt[:20] + [7, 7], dict(kw, seed=9))]
    elif path == "chunked":
        b = port(models, steps_per_poll=1, prefill_chunk=8)
        submits = [(long_prompt, dict(kw, seed=11))]
    else:
        b = port(models, fused_steps_per_dispatch=8)
        submits = [(PROMPTS[1], dict(kw, max_new_tokens=30, seed=4))]
    try:
        prefill_steps0 = b.stats["prefill_steps"]
        drained = _drain_keys(b, submits)
        for req in drained:
            n = len(req.resume["emitted"])
            assert derive_lane_key(req.seed, n) == req.resume["key"], (path, n)
        if path == "batched":
            assert b.stats["prefill_steps"] - prefill_steps0 == 1  # one m = 4 prefill
        if path == "prefix":
            assert b.stats["prefix_hits"] >= 1
        if path == "chunked":
            assert b.stats["prefill_chunks"] >= 2
        if path == "fused":
            assert b.stats["fused_dispatches"] >= 1
    finally:
        b.close()


# -- drain and checkpoint resume (batcher level) ------------------------------------


def test_drain_mid_decode_resumes_equal_to_jax(models, jax_ref):
    """A greedy and seeded batch drained mid-decode: every checkpoint
    resumes on a second port batcher, and on a JAX batcher, with the
    uninterrupted JAX stream; the exact post-split key rides along."""
    want = jax_ref(GREEDY + [SEEDED])
    a = port(models, steps_per_poll=1)
    b = port(models)
    jb = JaxBatcher(models[0], models[1], **BASE)
    try:
        futs = [a.submit(p, **kw) for p, kw in GREEDY + [SEEDED]]
        assert wait_lanes(a, 3, emitted=2)
        drained = a.drain()
        assert a.health == "draining" and a.stats["drains"] == 1
        by_prompt = {tuple(p): w for (p, _kw), w in zip(GREEDY + [SEEDED], want)}
        for req in drained:
            ck = checkpoint_of(req, a.weight_version)
            assert b.submit_checkpoint(ck).result(timeout=60) == by_prompt[tuple(req.tokens)]
            # the port's checkpoint resumes in the JAX package too
            assert jb.submit_checkpoint(ck).result(timeout=120) == by_prompt[tuple(req.tokens)]
        for f, (p, _kw) in zip(futs, GREEDY + [SEEDED]):
            if f.done() and not f.cancelled():
                assert f.result() == by_prompt[tuple(p)]
        assert b.stats["migrated_resumes"] == len(drained)
        assert b.stats["preempt_resumes"] == sum(r.resume is not None for r in drained)
    finally:
        a.close()
        b.close()
        jb.close()


def test_draining_member_refuses_typed_503(models):
    b = port(models)
    try:
        b.drain()
        with pytest.raises(BatcherDead) as ei:
            b.submit([1, 2, 3])
        assert ei.value.status == 503 and "draining" in str(ei.value)
        with pytest.raises(BatcherDead):
            b.submit_checkpoint({"prompt": [1, 2], "emitted": []})
        with pytest.raises(BatcherDead):
            b.drain()  # one drain per member
    finally:
        b.close()


def test_drain_timeout_cancels_and_member_resumes_serving(models):
    b = port(models)
    entered, block = threading.Event(), threading.Event()

    def slow_poll(_n):
        entered.set()
        block.wait(0.5)

    b.fault_hook = slow_poll
    b.start()
    try:
        assert entered.wait(10)
        with pytest.raises(RuntimeError, match="drain did not complete"):
            b.drain(timeout_s=0.05)
        block.set()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and b.health != "serving":
            time.sleep(0.01)
        assert b.health == "serving"
        b.fault_hook = None
        assert len(b.generate([1, 2, 3], max_new_tokens=4)) == 7
    finally:
        block.set()
        b.close()


def test_dead_member_drain_raises_typed(models):
    b = port(models, restart_budget=0)

    def die(_n):
        raise RuntimeError("injected death")

    b.fault_hook = die
    b.submit([1, 2, 3], max_new_tokens=4)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and b.health != "dead":
        time.sleep(0.005)
    assert b.health == "dead"
    with pytest.raises(BatcherDead):
        b.drain()
    b.close()


def test_drain_collects_queued_requests(models, jax_ref):
    """A 2-lane member with 3 submissions hands all of them over: the two
    checkpointed lanes and the queued one."""
    reqs = [(p, dict(max_new_tokens=40)) for p in PROMPTS]
    want = jax_ref(reqs)
    a = port(models, slots=2, steps_per_poll=1)
    b = port(models)
    try:
        for p, kw in reqs:
            a.submit(p, **kw)
        assert wait_lanes(a, 2, emitted=1)
        drained = a.drain()
        assert len(drained) == 3
        assert sum(r.resume is None for r in drained) >= 1  # the queued one
        for req in drained:
            out = b.submit_checkpoint(checkpoint_of(req, a.weight_version)).result(timeout=60)
            assert out == want[PROMPTS.index(list(req.tokens))]
    finally:
        a.close()
        b.close()


def test_drain_with_host_tier_on_leaves_the_tier_unchanged(models):
    """A drained lane's checkpoint carries no K/V: the drain must not
    spill it to the host tier (an orphan entry would pin host bytes)."""
    b = port(models, steps_per_poll=1, host_kv_tier_bytes=1 << 22, kv_tier_min_tokens=2,
             hbm_ledger_bytes=1 << 40)
    try:
        before = b.kv_tier_summary()
        for p, kw in GREEDY:
            b.submit(p, **kw)
        assert wait_lanes(b, 2, emitted=2)
        drained = b.drain()
        assert drained and all(r.resume is not None for r in drained)
        assert all("tier" not in r.resume for r in drained)
        assert b.kv_tier_summary() == before
        assert b.stats["kv_tier_demotions"] == 0
    finally:
        b.close()


def test_checkpoint_weight_version_mismatch_refused(models):
    b = port(models)
    jb = JaxBatcher(models[0], models[1], **BASE)
    try:
        ck = {"prompt": [1, 2, 3], "emitted": [4], "weight_version": "v-other"}
        with pytest.raises(WeightVersionMismatch) as ei:
            b.submit_checkpoint(ck)
        assert ei.value.status == 409
        with pytest.raises(jax_migration.WeightVersionMismatch):
            jb.submit_checkpoint(ck)
        assert b.stats["migrated_resumes"] == 0
    finally:
        b.close()
        jb.close()


def test_checkpoint_wait_anchor_is_cumulative(models):
    """A migrated request keeps its first member's submit anchor: its
    queue-wait sample covers both members' waits, down to the engine's
    first-class histogram."""
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
    from seldon_core_tpu_torch.metrics import CounterDeltas
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    b = port(models)
    try:
        ck = {"prompt": list(PROMPTS[1]), "emitted": [], "max_new_tokens": 8,
              "temperature": 0.0, "seed": 0, "wait_s": 2.5, "submit_wall_us": 777}
        f = b.submit_checkpoint(ck)
        f.result(timeout=60)
        assert b.stats["queue_wait_s_sum"] >= 2.5
        assert f.gen_request.submit_wall_us == 777
        srv = GenerateServer.__new__(GenerateServer)
        srv.batcher = b
        srv._deltas = CounterDeltas()
        reg = MetricsRegistry()
        reg.record_custom(srv.metrics(), {"unit": "g"})
        total, count = reg.histogram_totals(
            "seldon_engine_generate_queue_wait_seconds", {"unit": "g"})
        assert count >= 1 and total >= 2.5
        assert reg.counter_total("seldon_engine_migrations_resumed", {"unit": "g"}) == 1
    finally:
        b.close()


def test_complete_checkpoint_answers_on_the_host(models):
    """A final-state checkpoint (every token emitted) is answered without
    a lane, as the JAX batcher answers it."""
    b = port(models)
    jb = JaxBatcher(models[0], models[1], **BASE)
    try:
        ck = {"prompt": [1, 2, 3], "emitted": [4, 5, 6], "max_new_tokens": 3, "seed": 0}
        assert b.submit_checkpoint(ck).result(timeout=10) == [1, 2, 3, 4, 5, 6]
        assert jb.submit_checkpoint(ck).result(timeout=10) == [1, 2, 3, 4, 5, 6]
        assert b.stats["admitted"] == 0 and b.stats["migrated_resumes"] == 1
    finally:
        b.close()
        jb.close()


# -- weight swap ---------------------------------------------------------------------


def own(models):
    """``models`` with a private copy of the port's params: a swap writes
    the new weights into the served tensors in place."""
    jm, jp, tm, tp = models
    clone = {k: ({n: w.clone() for n, w in v.items()} if isinstance(v, dict) else v.clone())
             for k, v in tp.items()}
    return jm, jp, tm, clone


@pytest.fixture(scope="module")
def new_params(models):
    """The JAX package's init_params(1): the swap target of both packages."""
    jp1 = jax.jit(models[0].init_params)(1)
    return jp1, params_from_numpy(jax.tree.map(np.asarray, jp1), device="cpu")


def test_weight_swap_equals_jax_on_the_new_params(models, new_params, jax_ref):
    """In-flight requests finish on the old weights with the JAX tokens;
    after the flip, greedy and seeded requests equal the JAX batcher
    serving the new params, and the prefix cache is purged."""
    jp1, tp1 = new_params
    reqs = GREEDY + [SEEDED]
    old = jax_ref(reqs)
    fresh = JaxReference((models[0], jp1))
    b = port(own(models), prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=4)
    served = {name: w.data_ptr() for name, w in b.params["blocks"].items()}
    try:
        futs = [b.submit(p, **kw) for p, kw in reqs]
        assert wait_lanes(b, 3)
        sw = b.request_weight_swap(tp1, version="v1")
        assert [f.result(timeout=60) for f in futs] == old
        assert sw.result(timeout=60) == "v1" and b.weight_version == "v1"
        assert b.stats["weight_swaps"] == 1 and b.stats["prefix_evicted"] >= 1
        assert b._prefix_index.total_bytes == 0
        got = [b.submit(p, **kw).result(timeout=60) for p, kw in reqs]
        assert got == fresh(reqs)
        # the served tensors were written in place, not rebound
        assert {name: w.data_ptr() for name, w in b.params["blocks"].items()} == served
        assert torch.equal(b.params["blocks"]["wq"], tp1["blocks"]["wq"])
    finally:
        b.close()
        fresh.close()


def _other(**over):
    cfg = {**CFG, **over}
    return JaxLM(**cfg).init_params(0), TorchLM(**cfg).init_params(0, device="cpu")


@pytest.mark.parametrize("case", ["same", "shape", "dtype", "structure"])
def test_params_swappable_reasons_match_jax(models, case):
    jp, tp = models[1], models[3]
    if case == "same":
        jnew, tnew = jp, tp
    elif case == "shape":
        jnew, tnew = _other(d_model=16, n_heads=2)
    elif case == "dtype":
        jnew = jax.tree.map(lambda a: a.astype("bfloat16"), jp)
        tnew = {k: ({n: w.to(torch.bfloat16) for n, w in v.items()} if isinstance(v, dict)
                    else v.to(torch.bfloat16)) for k, v in tp.items()}
    else:
        jnew, tnew = {**jp, "extra": jp["ln_f"]}, {**tp, "extra": tp["ln_f"]}
    got = TorchLM.params_swappable(tp, tnew)
    assert got == JaxLM.params_swappable(jp, jnew)
    assert got[0] == (case == "same")


def test_weight_swap_refusals_and_cancel(models, new_params):
    _jp1, tp1 = new_params
    b = port(own(models), slots=2)
    try:
        with pytest.raises(ValueError, match="rejected"):
            b.request_weight_swap(_other(d_model=16, n_heads=2)[1])
        before = b.generate(PROMPTS[0], max_new_tokens=6)
        slow = b.submit([9, 8, 7, 6, 5], max_new_tokens=40)
        assert wait_lanes(b, 1)
        fut = b.request_weight_swap(tp1, version="v9")
        assert b.swap_pending()
        with pytest.raises(RuntimeError, match="already pending"):
            b.request_weight_swap(tp1)
        assert b.cancel_weight_swap() and not b.cancel_weight_swap()
        with pytest.raises(RuntimeError, match="cancelled"):
            fut.result(timeout=10)
        slow.result(timeout=60)
        assert b.weight_version == 0 and b.stats["weight_swaps"] == 0
        assert b.generate(PROMPTS[0], max_new_tokens=6) == before
        assert b.request_weight_swap(tp1).result(timeout=60) == 1  # auto sequence
        with pytest.raises(ValueError, match="already the served version"):
            b.request_weight_swap(tp1, version=1)
    finally:
        b.close()
    with pytest.raises(BatcherDead, match="closed"):
        b.request_weight_swap(tp1)


def test_weight_swap_refused_under_speculation(models, new_params):
    draft = TorchLM(**{**CFG, "n_layers": 1})
    b = port(models, draft_model=draft, draft_params=draft.init_params(9, device="cpu"),
             speculate_tokens=2)
    try:
        with pytest.raises(RuntimeError, match="speculative"):
            b.request_weight_swap(new_params[1])
    finally:
        b.close()


@pytest.mark.parametrize("policy", ["resume", "fail"])
def test_swap_straggler_bound(models, new_params, policy):
    """Past swap_drain_ms a long generation is checkpointed so the flip
    lands: under "resume" it finishes on the new weights, under "fail"
    it is refused with a 409."""
    jp1, tp1 = new_params
    b = port(own(models), slots=2, steps_per_poll=1, swap_drain_ms=40,
             swap_resume_policy=policy)
    try:
        f = b.submit([1, 2, 3], max_new_tokens=58)
        assert wait_lanes(b, 1, emitted=1)
        assert b.request_weight_swap(tp1, version="v9").result(timeout=60) == "v9"
        if policy == "resume":
            assert len(f.result(timeout=60)) == 3 + 58
        else:
            with pytest.raises(WeightVersionMismatch):
                f.result(timeout=60)
        assert b.stats["swap_preemptions"] >= 1 and b.weight_version == "v9"
    finally:
        b.close()


def test_swap_without_straggler_bound_keeps_waiting(models, new_params, jax_ref):
    b = port(own(models), slots=2, steps_per_poll=1)
    try:
        f = b.submit([1, 2, 3], max_new_tokens=40)
        assert wait_lanes(b, 1)
        sw = b.request_weight_swap(new_params[1], version="v1")
        assert f.result(timeout=60) == jax_ref([([1, 2, 3], dict(max_new_tokens=40))])[0]
        assert sw.result(timeout=60) == "v1" and b.stats["swap_preemptions"] == 0
    finally:
        b.close()


# -- server level: streams, resume tokens, drain_to ---------------------------------


def _ref_alone(jax_ref, prompt, kw):
    return jax_ref([(list(prompt), kw)], **SERVER_KNOBS)[0]


def test_drain_to_peer_keeps_stream_alive(model_dir, jax_ref):
    """A live stream's member drains mid-decode to a peer over loopback:
    the stream completes through the original handle with the JAX tokens,
    no span re-sent or lost."""
    prompt = [5, 6, 7, 8]
    kw = dict(max_new_tokens=24, temperature=0.8, eos_id=None, seed=9)
    want = _ref_alone(jax_ref, prompt, kw)
    a, b = _server(model_dir), _server(model_dir)
    try:
        handle = a.stream({"prompt_tokens": prompt, **kw})
        spans, box, done = [], {}, threading.Event()
        threading.Thread(target=_consume, args=(handle, spans, box, done), daemon=True).start()
        assert wait_lanes(a.batcher, 1, emitted=2)
        summary = a.drain_to(b)
        assert done.wait(60) and "error" not in box, box
        assert box["final"]["tokens"] == want
        assert [t for s in spans for t in s] == want[len(prompt):]
        assert summary == {"drained": 1, "checkpoints": 1, "handed": 1, "failed": 0}
        assert a.batcher.stats["checkpoint_exports"] == 1
        assert a.batcher.stats["migrations"] == 1
        assert b.batcher.stats["migrated_resumes"] == 1
        with pytest.raises(RuntimeError, match="draining"):
            a.health_status()
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_member_kill_resume_token_stream(model_dir, jax_ref, temperature):
    """A member dies mid-stream (loop death, restart budget 0): the last
    span's keyless resume token continues on a peer, the spans adding up
    to the JAX stream with none re-sent."""
    prompt = [2, 4, 6, 8]
    kw = dict(max_new_tokens=20, temperature=temperature, eos_id=None, seed=4)
    want = _ref_alone(jax_ref, prompt, kw)
    a = _server(model_dir, resume_tokens=1, restart_budget=0)
    b = _server(model_dir, resume_tokens="true")
    try:
        it = iter(a.stream({"prompt_tokens": prompt, **kw}).chunks)
        first = next(it)
        delivered, token = list(first["tokens"]), first["resume_token"]
        assert parse_token(token)["rng_key"] is None  # keyless

        def die(_n):
            raise RuntimeError("injected member kill")

        a.batcher.fault_hook = die
        died = None
        try:
            for ch in it:
                if ch.get("done"):
                    break
                delivered.extend(ch["tokens"])
                token = ch.get("resume_token", token)
        except Exception as e:  # noqa: BLE001
            died = e
        assert died is not None and getattr(died, "status", None) == 503
        assert a.batcher.health == "dead"
        resumed, final = [], None
        for ch in b.stream({"resume_token": token}).chunks:
            if ch.get("done"):
                final = ch
                break
            resumed.extend(ch["tokens"])
        assert final["tokens"] == want
        assert delivered + resumed == want[len(prompt):]
        assert b.batcher.stats["migrated_resumes"] == 1
    finally:
        a.close()
        b.close()


def test_unary_resume_token_round_trip(model_dir, jax_ref):
    prompt = [7, 7, 7]
    kw = dict(max_new_tokens=10, temperature=0.6, eos_id=None, seed=2)
    a = _server(model_dir, resume_tokens=1)
    try:
        out = a.predict({"prompt_tokens": [list(prompt)], **kw}, None)
        assert out["tokens"][0] == _ref_alone(jax_ref, prompt, kw)
        assert len(out["resume_tokens"]) == 1
        # the final-state token reproduces the response
        out2 = a.predict({"resume_token": out["resume_tokens"][0]}, None)
        assert out2["tokens"] == out["tokens"]
        # a mid-generation token resumes to the same tokens
        ck = parse_token(out["resume_tokens"][0])
        ck.update(emitted=ck["emitted"][:4], stream_pos=4)
        assert a.predict({"resume_token": checkpoint_token(ck)}, None)["tokens"] == out["tokens"]
    finally:
        a.close()


def test_text_mode_survives_token_resume(model_dir):
    a = _server(model_dir, resume_tokens=1)
    b = _server(model_dir, resume_tokens=1)
    try:
        it = iter(a.stream({"prompt": "hi", "max_new_tokens": 6, "temperature": 0.0}).chunks)
        first = next(it)
        assert "text" in first
        tok = first["resume_token"]
        assert parse_token(tok)["text_mode"] is True
        for _ch in it:
            pass
        chunks = list(b.stream({"resume_token": tok}).chunks)
        assert chunks and all("text" in ch for ch in chunks)
    finally:
        a.close()
        b.close()


def test_resume_tokens_refused_with_speculation(model_dir):
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    with pytest.raises(ValueError, match="resume_tokens"):
        GenerateServer(model_uri=model_dir, device="cpu", resume_tokens=1,
                       speculate_tokens=2, draft_layers=1)


def test_server_hot_swap_and_stale_resume_token(model_dir, tmp_path, jax_ref):
    """hot_swap flips to a checkpoint of the same architecture (version
    "v1", in the response meta's tags); a resume token of the old
    version is then refused with a 409; an architecture change is
    refused before any swap is staged."""
    from seldon_core_tpu_torch.convert import save_npz

    jp1 = jax.jit(JaxLM(**CFG).init_params)(1)
    d1 = tmp_path / "v1"
    d1.mkdir()
    save_npz(jax.tree.map(np.asarray, jp1), str(d1 / "params.npz"))
    (d1 / "jax_config.json").write_text(json.dumps(
        {"family": "llm", "config": {**CFG, "residual_scale": 0.5},
         "checkpoint": "params.npz"}))
    d2 = tmp_path / "wide"
    d2.mkdir()
    (d2 / "jax_config.json").write_text(json.dumps(
        {"family": "llm", "config": {**CFG, "d_model": 64}}))
    a = _server(model_dir, resume_tokens=1)
    try:
        old = a.predict({"prompt_tokens": [[1, 2, 3]], "max_new_tokens": 6}, None)
        out = a.hot_swap(str(d1))
        assert out["swapped"] and out["weight_version"] == "v1"
        assert a.tags()["weight_version"] == "v1"
        ref = JaxReference((JaxLM(**CFG), jp1))
        try:
            assert a.predict({"prompt_tokens": [[1, 2, 3]], "max_new_tokens": 6}, None)[
                "tokens"][0] == ref([([1, 2, 3], dict(max_new_tokens=6))], **SERVER_KNOBS)[0]
        finally:
            ref.close()
        with pytest.raises(WeightVersionMismatch) as ei:
            a.predict({"resume_token": old["resume_tokens"][0]}, None)
        assert ei.value.status == 409
        with pytest.raises(ValueError, match="architecture differs"):
            a.hot_swap(str(d2))
        assert a.cancel_hot_swap() == {"cancelled": False, "weight_version": "v1"}
        assert any(m["key"] == "gen_weight_swaps" for m in a.metrics())
    finally:
        a.close()


# -- the engine's /drain and /weights/swap routes --------------------------------------


def _post(port_, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port_, timeout=120)
    try:
        conn.request("POST", path, json.dumps(body).encode(), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_engine_drain_route_tcp(model_dir, jax_ref):
    """POST /drain {"to": peer} on one engine checkpoints over TCP into
    the peer engine's /drain import: the original future gets the JAX
    tokens, the source is draining (unready), and the peer's import
    refuses a checkpoint of another weight version with a 409 before
    admitting any."""
    prompt = [1, 3, 5, 7]
    kw = dict(max_new_tokens=24, temperature=0.8, eos_id=None, seed=6)
    want = _ref_alone(jax_ref, prompt, kw)
    params = [{"name": "device", "value": "cpu", "type": "STRING"},
              {"name": "slots", "value": "2", "type": "INT"},
              {"name": "steps_per_poll", "value": "1", "type": "INT"}]
    apps = [build_app(PORT, {**gen_unit(model_dir), "parameters": params}) for _ in range(2)]
    try:
        with Served(apps[0]) as src, Served(apps[1]) as dst:
            a, b = generator_of(apps[0]), generator_of(apps[1])
            fut = a.batcher.submit(list(prompt), **kw)
            assert wait_lanes(a.batcher, 1, emitted=2)
            status, payload = _post(src.http_port, "/drain",
                                    {"to": f"127.0.0.1:{dst.http_port}"})
            assert status == 200, payload
            unit = next(iter(payload["units"].values()))
            assert unit == {"drained": 1, "checkpoints": 1, "handed": 1, "failed": 0}
            assert fut.result(timeout=60) == want
            assert a.batcher.health == "draining"
            assert b.batcher.stats["migrated_resumes"] == 1
            stale = checkpoint_token({"v": 1, "prompt": [1, 2], "emitted": [3],
                                      "weight_version": "v-other", "seed": 0})
            good = checkpoint_token({"v": 1, "prompt": [1, 2], "emitted": [], "seed": 0,
                                     "max_new_tokens": 2, "weight_version": 0})
            status, payload = _post(dst.http_port, "/drain", {"checkpoints": [good, stale]})
            assert status == 409, payload
            assert b.batcher.stats["migrated_resumes"] == 1  # nothing admitted
            status, _ = _post(dst.http_port, "/drain", {"checkpoints": ["!!bad"]})
            assert status == 400
            status, _ = _post(dst.http_port, "/drain", {})
            assert status == 400
    finally:
        for app in apps:
            close_app(app)
