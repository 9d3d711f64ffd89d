"""The host KV tier in the port (serving/kvtier.py and the batcher's
demote, promote, checkpoint and copy-back paths), held against the JAX
package at the 2-layer float32 config of tests/_torch_sched.py on the
CPU.

Mirrors tests/test_kvtier.py: the tier's put/match/LRU budget, one-shot
checkpoints, typed corruption, version purge and release (its stored
SKV1 entries byte-identical to the JAX tier's); at the batcher, a warm
hit promoted from the tier after a demotion equals the JAX batcher's
device-resident warm hit, a copy-back resume under pressure gives the
uninterrupted JAX streams (greedy and seeded, each JAX request run
alone), a lost checkpoint falls back to recompute and replay with the
same stream, peers pull prefixes from each other's tiers over loopback
and TCP, and warm() reaches every width a lane can spill at.
"""

import time

import pytest
import torch

from seldon_core_tpu.serving.kvtier import HostKVTier as JaxTier
from seldon_core_tpu_torch.resilience import FaultInjector
from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher, GenRequest
from seldon_core_tpu_torch.serving.disagg import FailoverKVClient, PrefillTransportServer, TierMiss
from seldon_core_tpu_torch.serving.kvtier import HostKVTier, TierEntryCorrupt

from _torch_engine import make_model_dir
from _torch_sched import BASE, EagerGraphs, JaxBatcher, JaxReference, PROMPTS, make_models, port

GREEDY = [(p, dict(max_new_tokens=40)) for p in PROMPTS]
SAMPLED = [(p, dict(max_new_tokens=30, temperature=0.8, seed=11 + i))
           for i, p in enumerate(PROMPTS)]
TIER = dict(hbm_ledger_bytes=1 << 40, host_kv_tier_bytes=1 << 22, kv_tier_min_tokens=2)


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def jax_ref(models):
    ref = JaxReference(models)
    yield ref
    ref.close()


def _slab(w=8):
    return {
        "k": torch.arange(2 * 2 * w * 4, dtype=torch.float32).reshape(2, 1, 2, w, 4),
        "v": torch.zeros((2, 1, 2, w, 4), dtype=torch.float32),
    }


def arm_shrink(b, lanes=1.3, after=1, restore=12):
    shrink = int(lanes * b._attn_need(b.max_seq) * b._kv_key_bytes)
    b.pressure_hook = FaultInjector([], pressure={
        "shrink_to_bytes": shrink, "after_polls": b._work_poll_count + after,
        "restore_after_polls": restore,
    }).pressure_hook()


def wait_lanes(b, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(b._active) + len(b._chunked) >= n:
            return True
        time.sleep(0.002)
    return False


# -- the tier ------------------------------------------------------------------------


def test_tier_put_match_and_lru_budget():
    tier, jtier = HostKVTier(1 << 20, min_tokens=4), JaxTier(1 << 20, min_tokens=4)
    s = _slab()
    toks = list(range(8))
    assert tier.put_prefix(toks, s, 0)
    assert jtier.put_prefix(toks, {n: t.numpy() for n, t in s.items()}, 0)
    # the stored entry is the JAX tier's, byte for byte
    assert tier._index.match(toks)[1][2] == jtier._index.match(toks)[1][2]
    depth, meta, got = tier.match_prefix(toks + [99], 0)
    assert depth == 8 and meta["tokens"] == toks
    assert torch.equal(got["k"], s["k"]) and torch.equal(got["v"], s["v"])
    assert not tier.put_prefix([1, 2], s, 0)  # below the demote threshold
    tiny = HostKVTier(100, min_tokens=1)
    assert not tiny.put_prefix(toks, s, 0)  # over half the budget
    assert tiny.stats["refused"] >= 1
    one_entry = len(tier._index.match(toks)[1][2])
    lru = HostKVTier(int(one_entry * 2.5), min_tokens=4)
    assert lru.put_prefix(list(range(100, 108)), s, 0)
    assert lru.put_prefix(list(range(200, 208)), s, 0)
    lru.match_prefix(list(range(100, 108)), 0)  # touch the first
    assert lru.put_prefix(list(range(300, 308)), s, 0)
    assert lru.stats["evictions"] >= 1
    assert lru.match_prefix(list(range(200, 208)), 0) is None  # the LRU victim
    assert lru.match_prefix(list(range(100, 108)), 0) is not None


def test_tier_ckpt_one_shot_and_eviction_policy():
    tier = HostKVTier(1 << 20, min_tokens=4)
    s = _slab()
    assert tier.put_ckpt("a", {"pos": 9}, s, 0)
    meta, got = tier.take_ckpt("a", 0)
    assert meta["pos"] == 9 and torch.equal(got["k"], s["k"])
    assert tier.take_ckpt("a", 0) is None  # one-shot
    assert tier.put_ckpt("b", {"pos": 3}, s, 0)
    assert tier.take_ckpt("b", "v1") is None  # a stale-version take misses
    one = len(HostKVTier._encode({"kind": "tier_ckpt", "pos": 0, "weight_version": 0}, s))
    small = HostKVTier(int(one * 2.5), min_tokens=4)
    assert small.put_prefix(list(range(8)), s, 0)
    assert small.put_ckpt("c1", {"pos": 1}, s, 0)
    assert small.put_ckpt("c2", {"pos": 2}, s, 0)
    assert small.match_prefix(list(range(8)), 0) is None  # pure cache went first
    assert small.put_ckpt("c3", {"pos": 3}, s, 0)
    assert small.take_ckpt("c1", 0) is None  # the oldest checkpoint, never a newer
    assert small.take_ckpt("c2", 0) is not None
    assert small.take_ckpt("c3", 0) is not None


def test_tier_corruption_refuses_typed_and_drops():
    tier = HostKVTier(1 << 20, min_tokens=4)
    s = _slab()
    toks = list(range(8))
    tier.put_prefix(toks, s, 0)
    tag, etoks, payload = tier._index.match(toks)[1]
    bad = bytearray(payload)
    bad[len(bad) // 2] ^= 0xFF
    tier._index.remove(etoks)
    tier._index.insert(etoks, (tag, etoks, bytes(bad)), len(bad))
    with pytest.raises(TierEntryCorrupt):
        tier.match_prefix(toks, 0)
    assert tier.match_prefix(toks, 0) is None  # dropped: never re-served
    assert tier.stats["evictions"] >= 1
    tier.put_ckpt("k", {"pos": 5}, s, 0)
    ent = tier._ckpts["k"]
    raw = bytearray(ent.payload)
    raw[len(raw) // 2] ^= 0xFF
    ent.payload = bytes(raw)
    with pytest.raises(TierEntryCorrupt):
        tier.take_ckpt("k", 0)
    assert tier.take_ckpt("k", 0) is None


def test_tier_put_prefix_cannot_evict_itself_or_double_encode():
    s = _slab()
    one_ck = len(HostKVTier._encode({"kind": "tier_ckpt", "pos": 0, "weight_version": 0}, s))
    tier = HostKVTier(int(one_ck * 2.2), min_tokens=4)
    assert tier.put_ckpt("a", {"pos": 1}, s, 0)
    assert tier.put_ckpt("b", {"pos": 2}, s, 0)
    d0 = tier.stats["demotions"]
    assert not tier.put_prefix(list(range(8)), s, 0)
    assert tier.stats["demotions"] == d0
    assert tier.take_ckpt("a", 0) is not None
    big = HostKVTier(1 << 20, min_tokens=4)
    assert big.put_prefix(list(range(12)), s, 0)
    d1 = big.stats["demotions"]
    assert not big.put_prefix(list(range(12)), s, 0)  # the exact path
    assert not big.put_prefix(list(range(8)), s, 0)  # a covered sub-path
    assert big.stats["demotions"] == d1


def test_tier_drop_ckpt_and_version_purge():
    s = _slab()
    tier = HostKVTier(1 << 20, min_tokens=4)
    assert tier.put_ckpt("dead", {"pos": 1}, s, 0)
    assert tier.total_bytes > 0
    assert tier.drop_ckpt("dead") and tier.total_bytes == 0
    assert not tier.drop_ckpt("dead")  # idempotent
    assert tier.stats["released"] == 1
    tier.put_prefix(list(range(8)), s, 0)
    tier.put_ckpt("a", {"pos": 1}, s, 0)
    assert tier.set_version("v1") == 2
    assert tier.total_bytes == 0
    assert tier.match_prefix(list(range(8)), "v1") is None
    assert not tier.put_prefix(list(range(8)), s, 0)  # the old version is refused
    summary = tier.summary()
    assert summary["version"] == "v1" and summary["prefix_entries"] == 0


# -- the batcher -----------------------------------------------------------------------


def test_cancelled_preempted_request_releases_tier_ckpt(models):
    b = port(models, slots=2, host_kv_tier_bytes=1 << 22, kv_tier_min_tokens=2)
    try:
        prompt = PROMPTS[0]
        want = b.generate(prompt, max_new_tokens=8)
        b._kv_tier.put_ckpt(7, {"pos": 3}, _slab(), b.weight_version)
        req = GenRequest(tokens=list(prompt), max_new_tokens=8)
        req.submit_t = time.monotonic()
        req.future.gen_request = req
        req.resume = {"emitted": want[len(prompt):][:4], "key": [0, 0], "tier": 7}
        req.future.cancel()
        b._resume_queue.append(req)
        deadline = time.monotonic() + 30
        while 7 in b._kv_tier._ckpts and time.monotonic() < deadline:
            b.submit([1, 2], max_new_tokens=2).result(timeout=30)
        assert 7 not in b._kv_tier._ckpts
        assert b._kv_tier.stats["released"] == 1
    finally:
        b.close()
    # a preempted request still queued at close() releases its checkpoint
    b = port(models, slots=2, host_kv_tier_bytes=1 << 22, kv_tier_min_tokens=2)
    b._kv_tier.put_ckpt(8, {"pos": 3}, _slab(), b.weight_version)
    req = GenRequest(tokens=list(prompt), max_new_tokens=8)
    req.resume = {"emitted": [1], "key": [0, 0], "tier": 8}
    b._resume_queue.append(req)
    b.close()
    assert not b._kv_tier._ckpts and b._kv_tier.stats["released"] == 1
    assert isinstance(req.future.exception(timeout=1), RuntimeError)


def test_demote_then_promote_warm_hit_equals_jax(models):
    """Reclaim rung 1 demotes the published prefix slab; the next
    shared-prefix admission promotes it from the tier and its stream
    equals the JAX batcher's device-resident warm hit (warm against
    warm)."""
    sys_prompt = [7, 3, 9, 1, 4, 4, 2, 8]
    p_seed, p_warm = sys_prompt + [10, 11], sys_prompt + [20, 21]
    cache = dict(slots=2, prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=4)
    jb = JaxBatcher(models[0], models[1], **{**BASE, **cache})
    try:
        jb.generate(p_seed, max_new_tokens=8)
        want = jb.generate(p_warm, max_new_tokens=12)
        assert jb.stats["prefix_hits"] == 1
    finally:
        jb.close()
    b = port(models, hbm_ledger_bytes=1 << 30, host_kv_tier_bytes=1 << 22,
             kv_tier_min_tokens=4, **cache)
    try:
        b.generate(p_seed, max_new_tokens=8)
        deadline = time.monotonic() + 30
        while b._prefix_index.total_bytes == 0 and time.monotonic() < deadline:
            time.sleep(0.002)
        f = b.submit([1, 2, 3], max_new_tokens=50)
        b._pressure.set_budget(1024)
        while b.stats["pressure_prefix_evictions"] == 0 and time.monotonic() < deadline:
            time.sleep(0.002)
        b._pressure.restore_budget()
        f.result(timeout=120)
        assert b._prefix_index.total_bytes == 0
        b.sync_kv_tier_stats()
        assert b.stats["kv_tier_demotions"] >= 1 and b.stats["kv_tier_bytes"] > 0
        events = [e for e in b.pressure_events if e["action"] == "evict_prefix"]
        assert events and events[0]["demoted"] >= 1
        hits0 = b.stats["prefix_hits"]
        assert b.generate(p_warm, max_new_tokens=12) == want
        assert b.stats["prefix_hits"] == hits0 + 1
        assert b.stats["kv_tier_promotions"] == 1
        summary = b._pressure.summary()
        assert summary["host_tier_bytes"] > 0
        assert "host_tier_bytes" not in summary["components"]
        assert summary["used_bytes"] == sum(summary["components"].values())
    finally:
        b.close()


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_copyback_resume_equals_jax(models, jax_ref, kind):
    """Preemption with the tier on resumes by copying the lane's K/V
    back: no token is replayed, no resume falls back, and the streams
    are the uninterrupted JAX ones."""
    reqs = GREEDY if kind == "greedy" else SAMPLED
    b = port(models, **TIER)
    try:
        futs = [b.submit(p, **kw) for p, kw in reqs]
        assert wait_lanes(b, 2)
        arm_shrink(b)
        outs = [f.result(timeout=120) for f in futs]
        st = b.stats
        assert st["preemptions"] >= 1 and st["preempt_resumes"] == st["preemptions"]
        assert st["kv_tier_promotions"] == st["preempt_resumes"]
        assert st["replayed_tokens"] == 0 and st["kv_tier_replay_fallbacks"] == 0
        assert not b._kv_tier._ckpts  # every checkpoint was taken
    finally:
        b.close()
    assert outs == jax_ref(reqs)


def test_replay_fallback_when_tier_lost_the_checkpoint(models):
    """A resume whose checkpoint is gone (never stored), corrupt, or at
    another position recomputes and replays, with the same stream, and
    each fallback is counted."""
    b = port(models, slots=2, host_kv_tier_bytes=1 << 22, kv_tier_min_tokens=2)
    try:
        prompt = PROMPTS[0]
        want = b.generate(prompt, max_new_tokens=24)
        generated = want[len(prompt):]

        def resume_with(tier_key):
            req = GenRequest(tokens=list(prompt), max_new_tokens=24)
            req.submit_t = time.monotonic()
            req.future.gen_request = req
            req.resume = {"emitted": generated[:10], "key": [0, 0], "tier": tier_key}
            b._resume_queue.append(req)
            b.start()
            return req.future.result(timeout=120)

        assert resume_with(991) == want
        assert b.stats["kv_tier_replay_fallbacks"] == 1
        b._kv_tier.put_ckpt(992, {"pos": len(prompt) + 9}, _slab(), b.weight_version)
        ent = b._kv_tier._ckpts[992]
        raw = bytearray(ent.payload)
        raw[len(raw) // 2] ^= 0xFF
        ent.payload = bytes(raw)
        assert resume_with(992) == want
        b._kv_tier.put_ckpt(993, {"pos": 1}, _slab(), b.weight_version)
        assert resume_with(993) == want
        assert b.stats["kv_tier_replay_fallbacks"] == 3
        assert b.stats["replayed_tokens"] == 3 * 9
    finally:
        b.close()


def test_budget_too_small_for_a_checkpoint_replays(models, jax_ref):
    """A tier too small for any lane's checkpoint refuses them all: every
    resume recomputes and replays, with the uninterrupted streams."""
    b = port(models, **{**TIER, "host_kv_tier_bytes": 1024})
    try:
        futs = [b.submit(p, **kw) for p, kw in GREEDY]
        assert wait_lanes(b, 2)
        arm_shrink(b)
        outs = [f.result(timeout=120) for f in futs]
        assert b.stats["preemptions"] >= 1 and b.stats["kv_tier_promotions"] == 0
        assert b.stats["replayed_tokens"] > 0 and b._kv_tier.stats["refused"] >= 1
    finally:
        b.close()
    assert outs == jax_ref(GREEDY)


class _SmallBuckets(ContinuousBatcher):
    MIN_ATTN_BUCKET = 8


def test_warm_touches_every_tier_width(models, jax_ref):
    """warm() runs the spill extract and the copy-back insert at every
    attention width a lane of the declared traffic can spill at, and the
    preempted traffic then captures no graph after warm()."""
    b = _SmallBuckets(models[2], models[3], **{**BASE, **TIER, "attn_bucket": 16})
    b._graphs = EagerGraphs(b)
    try:
        lens = [len(p) for p in PROMPTS]
        b.warm(prompt_lens=lens, max_new_tokens=40)
        hi = max(lens) + 40 + b._k * b.pipeline_depth
        assert b._warm_tier_widths == sorted(
            {b._attn_need(p) for p in range(min(lens), hi + 1)})
        assert b._warm_tier_widths == [16, 32, 48, 64]
        futs = [b.submit(p, **kw) for p, kw in GREEDY]
        assert wait_lanes(b, 2)
        arm_shrink(b)
        outs = [f.result(timeout=120) for f in futs]
        assert b.stats["kv_tier_promotions"] >= 1
        assert b.stats["graph_captures_inline"] == 0
    finally:
        b.close()
    assert outs == jax_ref(GREEDY)


# -- cluster-wide sharing: peer pulls -------------------------------------------------


def test_peer_tier_pull_loopback_and_tcp(models, tmp_path):
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    d = make_model_dir(tmp_path)
    common = dict(model_uri=d, device="cpu", slots=2, steps_per_poll=2,
                  prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=8,
                  host_kv_tier_bytes=1 << 22)
    system = list(range(20, 32))
    kw = dict(max_new_tokens=6, temperature=0.0, eos_id=None, seed=0)
    jb = JaxBatcher(models[0], models[1], slots=2, max_seq=64)
    servers = []

    def server(**extra):
        s = GenerateServer(**common, **extra)
        s.load()
        servers.append(s)
        return s

    try:
        prefill = server(role="prefill")
        listener = PrefillTransportServer(prefill, port=0, host="127.0.0.1")
        dec_lo = server(role="decode")
        dec_lo.set_peer(prefill)
        dec_tcp = server(role="decode", peer=f"127.0.0.1:{listener.port}")
        # an export publishes its host slab into the prefill member's tier
        prefill.batcher.export_prefill(system + [40, 41], max_new_tokens=6)
        assert prefill.batcher.kv_tier_summary()["prefix_entries"] == 1
        want = jb.generate(system + [50, 51], max_new_tokens=6)
        for dec in (dec_lo, dec_tcp):
            fut = dec._remote_submit(system + [50, 51], dict(kw), None)
            assert fut.result(timeout=60) == want
            # the shared prefix came from the PEER's tier, promoted here,
            # and the slab crossed suffix-only
            assert fut.gen_request.cache_hit_tokens >= 8
            assert dec.batcher.stats["kv_tier_promotions"] == 1
            assert dec.batcher.stats["kv_transfer_bytes_saved"] > 0
        prefill.batcher.sync_kv_tier_stats()
        assert prefill.batcher.stats["kv_tier_hits"] >= 2
        # no shared prefix: a TierMiss passes the failover layer (nobody
        # ejected) and the request still answers
        probe = [99, 98, 97, 96, 95, 94, 93, 92, 91]
        want = jb.generate(probe, max_new_tokens=6)
        assert dec_tcp._remote_submit(probe, dict(kw), None).result(timeout=60) == want
        assert dec_tcp.batcher.stats["peer_ejections"] == 0
        keys = {m["key"] for m in dec_lo.metrics()}
        assert {"gen_kv_tier_promotions", "gen_kv_tier_bytes"} <= keys
        listener.close()
    finally:
        jb.close()
        for s in servers:
            s.close()


def test_failover_rotates_tier_miss_without_ejecting():
    class Cold:
        name = "cold"

        def __init__(self, addr):
            self.addr = addr

        def prefill(self, request, deadline_s=None):
            raise TierMiss(f"{self.addr} tier is cold")

        def probe(self, timeout_s=2.0):
            return True

        def close(self):
            pass

    class Warm(Cold):
        def prefill(self, request, deadline_s=None):
            return {"tokens": [1, 2]}, {"k": "slab"}

    fc = FailoverKVClient([Cold("a"), Warm("b")])
    meta, _slab_ = fc.prefill({"prefix_lookup": True})
    assert meta["tokens"] == [1, 2] and fc.healthy_count() == 2
    cold = FailoverKVClient([Cold("a"), Cold("b")])
    with pytest.raises(TierMiss):
        cold.prefill({"prefix_lookup": True})
    assert cold.healthy_count() == 2


def test_kv_tier_metrics_map_to_first_class_series():
    from seldon_core_tpu.graph.engine_metrics import MetricsRegistry as JaxRegistry
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry

    metrics = [{"type": "COUNTER", "key": f"gen_kv_tier_{k}", "value": v}
               for k, v in (("demotions", 3), ("promotions", 2), ("hits", 2),
                            ("evictions", 1), ("replay_fallbacks", 1))]
    metrics.append({"type": "GAUGE", "key": "gen_kv_tier_bytes", "value": 4096.0})
    regs = [MetricsRegistry(), JaxRegistry()]
    for reg in regs:
        reg.record_custom(metrics, {"deployment": "d"})
    for k in ("demotions", "promotions", "hits", "evictions", "replay_fallbacks"):
        name = f"seldon_engine_kv_tier_{k}"
        assert regs[0].counter_total(name, {"deployment": "d"}) == \
            regs[1].counter_total(name, {"deployment": "d"}) > 0
    assert 'seldon_engine_kv_tier_bytes{deployment="d"} 4096.0' in regs[0].expose()
