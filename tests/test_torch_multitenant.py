"""Multi-tenant serving in the port (serving/weightpager.py, the batcher's
tenant fields, victim guard, SLO split and ledger component, the
server's ``tenants`` knob and the engine's Seldon-Tenant header), held
against the JAX package at the 2-layer float32 config of
tests/_torch_sched.py on the CPU.

Mirrors tests/test_multitenant.py (its control-plane, flight-recorder
and gateway cases stay JAX-only): version namespacing in the prefix
cache and host tier, SWP1 blobs byte-identical to the JAX package's,
the pager's LRU budget, refusals and resident pin, the spec grammar and
meta stamping, the victim policy's choices equal to the JAX batcher's,
every tenant's greedy and seeded tokens on the paged server equal to a
JAX batcher serving that tenant's weights (each request alone) across
page-outs and page-ins, scale-to-zero without a graph recapture, the
starvation bound, the per-tenant SLO split and metrics, the ledger's
``pager`` component, and the typed refusals.
"""

import io
import json
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.llm import DecoderLM as JaxLM
from seldon_core_tpu.serving import continuous as jax_continuous
from seldon_core_tpu.serving import prefix_cache as jax_prefix
from seldon_core_tpu.serving import weightpager as jax_pager
from seldon_core_tpu_torch.convert import save_npz
from seldon_core_tpu_torch.serving.continuous import GenRequest
from seldon_core_tpu_torch.serving.kvtier import HostKVTier
from seldon_core_tpu_torch.serving.prefix_cache import (
    RadixPrefixIndex,
    version_namespace,
    version_retains,
)
from seldon_core_tpu_torch.serving.weightpager import (
    PagerEntryCorrupt,
    PagerRefused,
    TenantUnknown,
    WeightPager,
    _decode_ckpt,
    _encode_ckpt,
    parse_tenant_spec,
    stamp_tenant_meta,
    tenant_from_meta,
)

from _torch_engine import build_app, close_app, dispatch, generator_of
from _torch_sched import CFG, EagerGraphs, JaxReference, make_models, port

PORT = "seldon_core_tpu_torch"
PROMPTS = [[3, 17, 42, 99, 7], [1, 2, 3], [9, 8, 7, 6]]
SEEDS = {"acme": 0, "globex": 7}
# the generate server's geometry (default buckets clip to max_seq 64)
SERVER_KNOBS = dict(slots=2, steps_per_poll=2, prefill_buckets=(32,))


def _tree(seed: int, kb: int = 4):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(kb * 1024 // 8 // 2, 2).astype(np.float32),
            "b": rng.randn(8).astype(np.float32)}


def _ttree(seed: int, kb: int = 4):
    return {k: torch.from_numpy(v) for k, v in _tree(seed, kb).items()}


# -- version namespacing ---------------------------------------------------------------


@pytest.mark.parametrize("entry,new", [
    ("acme@1", "acme@1"), ("acme@1", "globex@1"), ("acme@1", "acme@2"),
    ("v1", "acme@1"), ("acme@1", "v2"), (0, 1), ("a@b@7", "a@b@7"),
])
def test_version_namespace_and_retains_truth_table(entry, new):
    assert version_namespace(entry) == jax_prefix.version_namespace(entry)
    assert version_retains(entry, new) == jax_prefix.version_retains(entry, new)
    assert version_retains(entry, new) == (
        entry == new or (version_namespace(entry) is not None
                         and version_namespace(new) is not None
                         and version_namespace(entry) != version_namespace(new)))


def test_prefix_index_namespaced_purge_and_page_back():
    idx = RadixPrefixIndex(1 << 20)
    idx.set_version("acme@1")
    idx.insert(list(range(8)), {"k": torch.ones((2, 1, 2, 8, 4))}, 4096)
    assert idx.match(list(range(8)))[0] == 8
    # tenant B pages in: A's slab is retained but invisible
    assert idx.set_version("globex@1") == 0
    assert idx.match(list(range(8)))[0] == 0
    idx.insert(list(range(100, 108)), {"k": torch.zeros((2, 1, 2, 8, 4))}, 4096)
    # A pages back: its slab is warm again
    idx.set_version("acme@1")
    depth, slab = idx.match(list(range(8)))
    assert depth == 8 and bool((slab["k"] == 1).all())
    # A re-puts (new weights): only acme@1 entries purge
    assert idx.set_version("acme@2") >= 1
    assert idx.match(list(range(8)))[0] == 0
    idx.set_version("globex@1")
    assert idx.match(list(range(100, 108)))[0] == 8
    # an un-namespaced switch purges everything
    assert idx.set_version(7) >= 1
    idx.set_version("globex@1")
    assert idx.match(list(range(100, 108)))[0] == 0


def test_host_tier_namespaced_ckpt_and_prefix_purges():
    tier = HostKVTier(1 << 20, min_tokens=4)
    tier.set_version("acme@1")
    slab = {"k": torch.arange(2 * 2 * 8 * 4, dtype=torch.float32).reshape(2, 1, 2, 8, 4),
            "v": torch.zeros((2, 1, 2, 8, 4))}
    toks = list(range(8))
    assert tier.put_prefix(toks, slab, "acme@1")
    assert tier.put_ckpt(("lane", 0), {"emitted": [1]}, slab, "acme@1")
    tier.set_version("globex@1")
    assert tier.match_prefix(toks, "globex@1") is None
    assert tier.take_ckpt(("lane", 0), "globex@1") is None
    tier.set_version("acme@1")  # the gated lookups destroyed nothing
    hit = tier.match_prefix(toks, "acme@1")
    assert hit is not None and hit[0] == 8
    assert tier.take_ckpt(("lane", 0), "acme@1") is not None
    tier.set_version("acme@2")
    tier.set_version("acme@1")
    assert tier.match_prefix(toks, "acme@1") is None


# -- the SWP1 codec and the pager --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pager_codec_byte_identical_and_cross_decode(dtype):
    leaves = [torch.arange(12, dtype=torch.float32).reshape(3, 4), torch.tensor([7]),
              torch.randn(2, 5)]
    if dtype == "bfloat16":
        leaves = [t.to(torch.bfloat16) if t.is_floating_point() else t for t in leaves]
    # the same values as the JAX package holds them (bfloat16 via ml_dtypes)
    jleaves = [np.asarray(jax.numpy.asarray(t.float().numpy()).astype(dtype))
               if t.is_floating_point() else t.numpy() for t in leaves]
    meta = {"tenant": "t", "weight_version": "t@1"}
    blob = _encode_ckpt(meta, leaves)
    assert blob == jax_pager._encode_ckpt(meta, jleaves)
    got_meta, out = _decode_ckpt(io.BytesIO(blob).read)
    assert got_meta["tenant"] == "t"
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(leaves, out))
    _m, jout = jax_pager._decode_ckpt(io.BytesIO(blob).read)
    assert all(np.array_equal(np.asarray(j, np.float64), t.double().numpy())
               for j, t in zip(jout, leaves))


def test_pager_put_promote_and_versions():
    pager = WeightPager(1 << 20)
    assert pager.put("acme", _ttree(0), "strict") == "acme@1"
    pager.mark_resident("acme")
    assert pager.resident == "acme" and pager.slo_class("acme") == "strict"
    params, version = pager.promote("acme")
    assert version == "acme@1" and torch.equal(params["w"], _ttree(0)["w"])
    assert pager.put("acme", _ttree(1), "strict") == "acme@2"
    with pytest.raises(TenantUnknown) as ei:
        pager.promote("nobody")
    assert ei.value.status == 404
    # the blob is the JAX pager's, byte for byte
    jpager = jax_pager.WeightPager(1 << 20)
    jpager.put("acme", _tree(0), "strict")
    mine = WeightPager(1 << 20)
    mine.put("acme", _ttree(0), "strict")
    assert mine._entries["acme"].payload == jpager._entries["acme"].payload


def test_pager_lru_budget_refusal_and_resident_pin():
    blob = len(_encode_ckpt({}, list(_ttree(0).values())))
    pager = WeightPager(int(blob * 2.5))
    pager.put("a", _ttree(0))
    pager.mark_resident("a")
    pager.put("b", _ttree(1))
    pager.promote("b")
    pager.put("c", _ttree(2))  # b evicts: a is resident-pinned
    assert set(pager.tenants()) == {"a", "c"} and pager.stats["evictions"] == 1
    with pytest.raises(PagerRefused) as ei:
        WeightPager(blob + 8).put("big", _ttree(3))
    assert ei.value.status == 507
    with pytest.raises(PagerRefused):  # a failed re-put keeps the old one
        pager.put("a", _ttree(4, kb=3 * (blob // 1024)))
    assert "a" in pager.tenants() and pager.promote("a")[1] == "a@1"


def test_pager_crc_drop_is_typed_and_terminal():
    pager = WeightPager(1 << 20)
    pager.put("acme", _ttree(0))
    entry = pager._entries["acme"]
    bad = bytearray(entry.payload)
    bad[len(bad) // 2] ^= 0xFF
    entry.payload = bytes(bad)
    with pytest.raises(PagerEntryCorrupt):
        pager.promote("acme")
    assert pager.stats["corrupt_dropped"] == 1
    with pytest.raises(TenantUnknown):
        pager.promote("acme")


@pytest.mark.parametrize("spec", ["a=strict, b=best_effort@/m/b", "x=standard",
                                  "a", "a=", "a=gold", "a=strict,a=strict", "", "a b=strict",
                                  "a@b=strict"])
def test_tenant_spec_grammar_strict(spec):
    try:
        want = jax_pager.parse_tenant_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_tenant_spec(spec)
        return
    assert parse_tenant_spec(spec) == want


def test_tenant_meta_stamp_roundtrip():
    msg = stamp_tenant_meta({"jsonData": {}, "meta": {"puid": "x"}}, "acme")
    assert tenant_from_meta(msg["meta"]) == "acme" and msg["meta"]["puid"] == "x"
    assert msg == jax_pager.stamp_tenant_meta({"jsonData": {}, "meta": {"puid": "x"}}, "acme")
    assert tenant_from_meta(None) is None and tenant_from_meta({}) is None
    assert tenant_from_meta({"tenant": "  "}) is None
    m = {"jsonData": {}}
    assert stamp_tenant_meta(m, None) is m


# -- the victim policy -----------------------------------------------------------------


def _lane(req_cls, tenant, slo, emitted=0, max_new=40, deadline_t=None):
    req = req_cls(tokens=[1, 2], max_new_tokens=max_new, tenant=tenant, slo=slo,
                  deadline_t=deadline_t)
    return types.SimpleNamespace(request=req, emitted=[0] * emitted)


LANE_SETS = {
    "best_effort_first": [("acme", "strict", 0), ("globex", "best_effort", 0)],
    "strict_singleton_protected": [("acme", "strict", 39), ("globex", "best_effort", 0)],
    "two_strict_same_tenant": [("acme", "strict", 10), ("acme", "strict", 2)],
    "all_protected_fallback": [("acme", "strict", 0), ("initech", "strict", 0),
                               ("globex", "best_effort", 39)],
    "single_tenant_order": [(None, "standard", 5), (None, "standard", 0),
                            (None, "standard", 0, 60.0)],
}


@pytest.mark.parametrize("case", sorted(LANE_SETS))
def test_pick_victim_prefers_best_effort_and_protects_strict(models, case):
    b = port(models, slots=4)
    jb = jax_continuous.ContinuousBatcher(models[0], models[1], slots=4, max_seq=64,
                                          prefill_buckets=(8,))
    now = time.monotonic()
    try:
        for batcher, cls in ((b, GenRequest), (jb, jax_continuous.GenRequest)):
            batcher._active = {
                i: _lane(cls, t, slo, em, deadline_t=(now + rest[0]) if rest else None)
                for i, (t, slo, em, *rest) in enumerate(LANE_SETS[case])}
        assert b._pick_victim() == jb._pick_victim()
    finally:
        b._active, jb._active = {}, {}
        b.close()
        jb.close()


# -- the multi-tenant server ---------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def tenant_params():
    return {name: jax.jit(JaxLM(**CFG).init_params)(seed) for name, seed in SEEDS.items()}


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory, tenant_params):
    root = tmp_path_factory.mktemp("tenants")
    dirs = []
    for name in SEEDS:
        d = root / name
        d.mkdir()
        save_npz(jax.tree.map(np.asarray, tenant_params[name]), str(d / "params.npz"))
        (d / "jax_config.json").write_text(json.dumps(
            {"family": "llm", "config": CFG, "checkpoint": "params.npz"}))
        dirs.append(str(d))
    return tuple(dirs)


@pytest.fixture(scope="module")
def dedicated_refs(tenant_params):
    """Each tenant's greedy and seeded tokens from a JAX batcher serving
    that tenant's weights, every request alone."""
    refs = {}
    for name, jp in tenant_params.items():
        ref = JaxReference((JaxLM(**CFG), jp))
        try:
            refs[name] = {
                "greedy": ref([(p, dict(max_new_tokens=12)) for p in PROMPTS], **SERVER_KNOBS),
                "sampled": ref([(p, dict(max_new_tokens=12, temperature=0.8, seed=11 + i))
                                for i, p in enumerate(PROMPTS)], **SERVER_KNOBS),
            }
        finally:
            ref.close()
    return refs


def _mk_server(model_dirs, **kw):
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    dir_a, dir_b = model_dirs
    kw.setdefault("slots", 2)
    kw.setdefault("steps_per_poll", 2)
    s = GenerateServer(model_uri=dir_a, device="cpu",
                       tenants=f"acme=strict,globex=best_effort@{dir_b}",
                       weight_pager_host_bytes=64 << 20, **kw)
    s.load()
    return s


def _gen(server, prompt, tenant=None, n=12, temperature=0.0, seed=0):
    body = {"prompt_tokens": [list(prompt)], "max_new_tokens": n,
            "temperature": temperature, "seed": seed}
    if tenant is not None:
        body["tenant"] = tenant
    return server.predict(body, [])["tokens"][0]


def test_multitenant_tokens_equal_dedicated_jax_across_paging(model_dirs, dedicated_refs):
    """Interleaved per prompt, so each tenant's requests straddle the
    other's page-in: every tenant's greedy and seeded tokens equal the
    JAX batcher on that tenant's weights."""
    s = _mk_server(model_dirs, tenant_min_resident_ms=0)
    try:
        assert s.tenant_pager.resident == "acme"
        assert s.batcher.weight_version == "acme@1"
        got = {t: {"greedy": [], "sampled": []} for t in SEEDS}
        for i, p in enumerate(PROMPTS):
            for t in SEEDS:
                got[t]["greedy"].append(_gen(s, p, tenant=t))
            for t in SEEDS:
                got[t]["sampled"].append(_gen(s, p, tenant=t, temperature=0.8, seed=11 + i))
        assert got == dedicated_refs
        assert s.tenant_pager.stats["page_ins"] >= 3
        assert s.tenant_scheduler.stats["switches"] >= 2
        assert s.batcher.weight_version in ("acme@1", "globex@1")
    finally:
        s.close()


def test_scale_to_zero_pages_back_without_recapture(model_dirs):
    """A demote and page-back cycle captures no decode graph: the graphs
    of the first cycle serve every tenant (they read the served tensors,
    which a page-in rewrites in place)."""
    s = _mk_server(model_dirs, tenant_min_resident_ms=0)
    try:
        b = s.batcher
        b._graphs = EagerGraphs(b)  # the loop is idle: no dispatch in flight
        for t in ("acme", "globex", "acme"):
            _gen(s, PROMPTS[0], tenant=t)
        captured, keys = b.stats["graphs_captured"], set(b._graphs.graphs)
        inline = b.stats["graph_captures_inline"]
        switches = s.tenant_scheduler.stats["switches"]
        assert captured > 0
        assert _gen(s, PROMPTS[0], tenant="globex")  # acme demotes
        assert _gen(s, PROMPTS[0], tenant="acme")  # and pages back
        assert s.tenant_scheduler.stats["switches"] >= switches + 2
        assert b.stats["graphs_captured"] == captured and set(b._graphs.graphs) == keys
        assert b.stats["graph_captures_inline"] == inline
        assert b._graphs.stale == []
    finally:
        s.close()


def test_starvation_bound_forces_the_flip(model_dirs):
    s = _mk_server(model_dirs, tenant_max_wait_polls=1, tenant_min_resident_ms=0)
    try:
        stop = threading.Event()

        def flood():
            while not stop.is_set():
                try:
                    _gen(s, PROMPTS[0], tenant="acme", n=8)
                except RuntimeError:
                    return

        t = threading.Thread(target=flood, daemon=True)
        t.start()
        try:
            assert len(_gen(s, PROMPTS[1], tenant="globex", n=8)) == len(PROMPTS[1]) + 8
        finally:
            stop.set()
            t.join(timeout=60)
        assert not t.is_alive()
        assert s.tenant_scheduler.stats["switches"] >= 1
        assert s.tenant_scheduler.stats["forced_switches"] >= 1
    finally:
        s.close()


def test_per_tenant_slo_split_and_metrics_tags(model_dirs):
    s = _mk_server(model_dirs, tenant_min_resident_ms=0)
    try:
        for t in ("acme", "globex", "acme"):
            _gen(s, PROMPTS[0], tenant=t)
        b = s.batcher
        assert b.tenant_slo["acme"]["slo_samples"] >= 2
        assert b.tenant_slo["globex"]["slo_samples"] >= 1
        assert b.tenant_slo["acme"]["ttft_s_sum"] > 0
        by_key = {}
        for m in s.metrics():
            by_key.setdefault(m["key"], []).append(m)
        assert {"gen_weight_page_ins", "gen_weight_page_outs", "gen_weight_pager_host_bytes",
                "gen_weight_pager_resident_bytes", "gen_tenants_registered",
                "gen_tenant_switches"} <= set(by_key)
        assert by_key["gen_tenants_registered"][0]["value"] == 2.0
        assert {m["tags"]["tenant"] for m in by_key["gen_tenant_requests"]} == set(SEEDS)
        assert {m["tags"]["tenant"] for m in by_key["gen_tenant_ttft_ms"]} == set(SEEDS)
        _gen(s, PROMPTS[1], tenant="acme")
        again = {m["tags"]["tenant"]: m["value"] for m in s.metrics()
                 if m["key"] == "gen_tenant_requests"}
        assert again == {"acme": 1.0, "globex": 0.0}
    finally:
        s.close()


def test_pressure_ledger_counts_pager_component(model_dirs):
    s = _mk_server(model_dirs, hbm_ledger_bytes=1 << 30, tenant_min_resident_ms=0)
    try:
        _gen(s, PROMPTS[0], tenant="acme")
        deadline = time.monotonic() + 30
        while not s.batcher._pressure.components.get("pager") and time.monotonic() < deadline:
            time.sleep(0.002)
        assert s.batcher._pressure.components["pager"] == s.tenant_pager.resident_hbm_bytes > 0
        assert s.tenant_pager.resident_hbm_bytes == s.batcher._param_bytes
    finally:
        s.close()


def test_unknown_tenant_refuses_typed(model_dirs):
    s = _mk_server(model_dirs)
    try:
        with pytest.raises(TenantUnknown) as ei:
            _gen(s, PROMPTS[0], tenant="nobody")
        assert ei.value.status == 404
        # tenant-less traffic routes to the first declared tenant
        assert _gen(s, PROMPTS[0]) == _gen(s, PROMPTS[0], tenant="acme")
    finally:
        s.close()


@pytest.mark.parametrize("kw", [
    dict(tenants="a=gold", weight_pager_host_bytes=1 << 20),
    dict(tenants="a=strict"),  # the pager budget is mandatory
    dict(tenants="a=strict", weight_pager_host_bytes=1 << 20, role="decode"),
])
def test_tenants_knob_refuses_misconfiguration(model_dirs, kw):
    from seldon_core_tpu.servers.generateserver import GenerateServer as JaxServer
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    with pytest.raises(ValueError):
        JaxServer(model_uri=model_dirs[0], **kw)
    with pytest.raises(ValueError):
        GenerateServer(model_uri=model_dirs[0], device="cpu", **kw)


def test_tenant_architecture_mismatch_refused(model_dirs, tmp_path):
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    wide = tmp_path / "wide"
    wide.mkdir()
    (wide / "jax_config.json").write_text(json.dumps(
        {"family": "llm", "config": {**CFG, "d_ff": 32}}))
    s = GenerateServer(model_uri=model_dirs[0], device="cpu",
                       tenants=f"acme=strict,wide=standard@{wide}",
                       weight_pager_host_bytes=64 << 20)
    try:
        with pytest.raises(ValueError, match="architecture differs.*d_ff"):
            s.load()
    finally:
        s.close()


# -- the engine ------------------------------------------------------------------------


def test_engine_stamps_tenant_header_into_meta():
    import asyncio

    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
    from seldon_core_tpu_torch.graph.service import EngineApp
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    seen = {}

    class Probe:
        def predict(self, X, names, meta=None):
            seen["tenant"] = tenant_from_meta(meta)
            return {"routed": True}

    spec = PredictorSpec.from_dict({"name": "p", "graph": {
        "name": "m", "type": "MODEL", "implementation": "SIMPLE_MODEL"}})
    app = EngineApp(spec, registry={"m": Probe()}, metrics=MetricsRegistry())
    asyncio.run(app.predict({"jsonData": {"x": 1}}, headers={"seldon-tenant": "acme"}))
    assert seen["tenant"] == "acme"
    asyncio.run(app.predict({"jsonData": {"x": 1}}, headers={}))
    assert seen["tenant"] is None


def test_engine_routes_tenant_header_to_the_paged_server(model_dirs, dedicated_refs):
    """Through the port's engine: the Seldon-Tenant header (unary and
    SSE) picks the tenant whose weights serve the request; an unknown
    tenant answers 404."""
    params = [{"name": "device", "value": "cpu", "type": "STRING"},
              {"name": "slots", "value": "2", "type": "INT"},
              {"name": "steps_per_poll", "value": "2", "type": "INT"},
              {"name": "tenants", "value": f"acme=strict,globex=best_effort@{model_dirs[1]}",
               "type": "STRING"},
              {"name": "weight_pager_host_bytes", "value": str(64 << 20), "type": "INT"},
              {"name": "tenant_min_resident_ms", "value": "0", "type": "INT"}]
    app = build_app(PORT, {"name": "llm", "implementation": "GENERATE_SERVER",
                           "modelUri": model_dirs[0], "parameters": params})
    rest = app.rest_app()
    try:
        body = {"jsonData": {"prompt_tokens": PROMPTS[0], "max_new_tokens": 12}}
        for t in ("globex", "acme"):
            status, out = dispatch(rest, "/api/v0.1/predictions", body,
                                   headers={"seldon-tenant": t})
            assert status == 200, out
            assert out["jsonData"]["tokens"][0] == dedicated_refs[t]["greedy"][0]
            assert out["meta"]["tags"]["weight_version"] == f"{t}@1"
        status, _out = dispatch(rest, "/api/v0.1/predictions", body,
                                headers={"seldon-tenant": "nobody"})
        assert status == 404
        gen = generator_of(app)
        handle = gen.stream({**body["jsonData"], "meta": {"tenant": "globex"}})
        final = [ch for ch in handle.chunks if ch.get("done")][0]
        assert final["tokens"] == dedicated_refs["globex"]["greedy"][0]
    finally:
        generator_of(app).close()
        close_app(app)


def test_tenant_metrics_map_to_first_class_series():
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry

    reg = MetricsRegistry()
    reg.record_custom([
        {"type": "COUNTER", "key": "gen_tenant_requests", "value": 2, "tags": {"tenant": "acme"}},
        {"type": "COUNTER", "key": "gen_tenant_requests", "value": 5,
         "tags": {"tenant": "globex"}},
        {"type": "COUNTER", "key": "gen_tenant_switches", "value": 3},
        {"type": "COUNTER", "key": "gen_weight_page_ins", "value": 4},
        {"type": "COUNTER", "key": "gen_weight_page_outs", "value": 3},
        {"type": "COUNTER", "key": "gen_weight_pager_evictions", "value": 0},
        {"type": "COUNTER", "key": "gen_weight_pager_refused", "value": 0},
        {"type": "GAUGE", "key": "gen_weight_pager_host_bytes", "value": 4096.0},
        {"type": "GAUGE", "key": "gen_weight_pager_resident_bytes", "value": 2048.0},
        {"type": "GAUGE", "key": "gen_tenants_registered", "value": 2.0},
        {"type": "TIMER", "key": "gen_tenant_ttft_ms", "value": 12.0, "tags": {"tenant": "acme"}},
        {"type": "TIMER", "key": "gen_tenant_tpot_ms", "value": 3.0, "tags": {"tenant": "acme"}},
        {"type": "TIMER", "key": "gen_tenant_queue_wait_ms", "value": 1.0,
         "tags": {"tenant": "acme"}},
        {"type": "COUNTER", "key": "gen_drains", "value": 1},
        {"type": "COUNTER", "key": "gen_migrated_resumes", "value": 2},
    ], {"unit": "gen"})
    expo = reg.expose()
    for series in ("seldon_engine_tenant_requests", "seldon_engine_tenant_switches",
                   "seldon_engine_weight_page_ins", "seldon_engine_weight_page_outs",
                   "seldon_engine_weight_pager_evictions", "seldon_engine_weight_pager_refused",
                   "seldon_engine_weight_pager_host_bytes",
                   "seldon_engine_weight_pager_resident_bytes",
                   "seldon_engine_tenants_registered", "seldon_engine_tenant_ttft_seconds",
                   "seldon_engine_tenant_tpot_seconds",
                   "seldon_engine_tenant_queue_wait_seconds",
                   "seldon_engine_drains_total", "seldon_engine_migrations_resumed"):
        assert series in expo, series
    assert reg.counter_total("seldon_engine_tenant_requests", {"tenant": "acme"}) == 2.0
    assert reg.counter_total("seldon_engine_tenant_requests", {"tenant": "globex"}) == 5.0
