"""Sharded generate serving in the port (seldon_core_tpu_torch), held
against the JAX package's on the CPU.

Counterpart of tests/test_sharded_serving.py. The JAX reference serves on
the 8-virtual-device CPU mesh that conftest.py forces; the port's
``ServingMesh`` maps its positions onto the CPU, its params and KV cache
stored split into real blocks (``ShardedTensor``). The house gate at mesh
scale: greedy AND seeded tokens are equal for the port meshed, the port
unmeshed and the JAX meshed server (each JAX request run alone, ROADMAP
§C) across plain decode, prefix splice, chunked prefill, fused decode and
a pressure preemption/resume. Plus the refusals with the JAX messages,
``auto``, the gauges and the warm census, the ``seldon.io/mesh`` round
trip through the reconciler to a serving engine, the per-shard ledger on
a 2x2 mesh, ``param_sharding``'s table leaf for leaf, and the serving
half of ``dryrun_multichip``.
"""

import asyncio
import json
import logging
import time

import jax
import numpy as np
import pytest
import torch

from seldon_core_tpu.models.llm import DecoderLM as JaxLM
from seldon_core_tpu.parallel import mesh as jax_mesh
from seldon_core_tpu.servers.generateserver import GenerateServer as JaxServer
from seldon_core_tpu_torch.convert import params_from_numpy, save_npz
from seldon_core_tpu_torch.models.llm import DecoderLM
from seldon_core_tpu_torch.parallel import mesh as port_mesh
from seldon_core_tpu_torch.parallel.mesh import (
    MeshShapeError,
    ServingMesh,
    ServingSharding,
    ShardedTensor,
    make_serving_mesh,
)
from seldon_core_tpu_torch.resilience.faults import FaultInjector
from seldon_core_tpu_torch.servers.generateserver import GenerateServer
from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

torch.set_num_threads(1)

# tests/test_sharded_serving.py's LLM_TINY at float32: the two packages
# are held token for token at float32 (bf16 equality across frameworks is
# not claimed)
LLM_TINY = {
    "vocab_size": 64, "d_model": 32, "n_layers": 2, "n_heads": 4,
    "n_kv_heads": 4, "d_ff": 64, "max_seq": 64, "dtype": "float32",
}
MESH_SHAPE = "data=2,model=4"
PROMPTS = [[3, 17, 42, 11, 7], [1, 2, 3], [9, 8, 7, 6], [5, 5, 5, 5, 5, 5]]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The JAX ``init_params(0)`` as the port's npz; the JAX server
    initialises the same weights from seed 0."""
    d = tmp_path_factory.mktemp("shard-llm")
    params = jax.jit(JaxLM(**LLM_TINY).init_params)(0)
    save_npz(jax.tree.map(np.asarray, params), str(d / "params.npz"))
    (d / "jax_config.json").write_text(
        json.dumps({"family": "llm", "config": LLM_TINY, "checkpoint": "params.npz"}))
    return str(d)


def gen(server, prompt, n, temperature=0.0, seed=0):
    out = server.predict({
        "prompt_tokens": [list(prompt)], "max_new_tokens": n,
        "temperature": temperature, "seed": seed,
    }, [])
    return [int(t) for t in out["tokens"][0]]


class JaxMeshed:
    """The JAX meshed server per knob set, every request run alone,
    memoised."""

    def __init__(self, model_dir):
        self.model_dir = model_dir
        self.servers = {}
        self.memo = {}

    def __call__(self, knobs, prompt, n, temperature=0.0, seed=0):
        kkey = tuple(sorted(knobs.items()))
        key = (kkey, tuple(prompt), n, temperature, seed)
        if key not in self.memo:
            if kkey not in self.servers:
                s = JaxServer(model_uri=self.model_dir, mesh_shape=MESH_SHAPE,
                              **{"slots": 4, "steps_per_poll": 2, **knobs})
                s.load()
                self.servers[kkey] = s
            self.memo[key] = gen(self.servers[kkey], prompt, n, temperature, seed)
        return self.memo[key]

    def close(self):
        for s in self.servers.values():
            s.batcher.close()


@pytest.fixture(scope="module")
def jax_ref(model_dir):
    ref = JaxMeshed(model_dir)
    yield ref
    ref.close()


def twin_servers(model_dir, **kw):
    """The 1-vs-N probe pair of the port: identical knobs and checkpoint,
    only the serving mesh differs."""
    kw.setdefault("slots", 4)
    kw.setdefault("steps_per_poll", 2)
    plain = GenerateServer(model_uri=model_dir, device="cpu", **kw)
    shard = GenerateServer(model_uri=model_dir, device="cpu", mesh_shape=MESH_SHAPE, **kw)
    plain.load()
    shard.load()
    return plain, shard


def close_pair(plain, shard):
    plain.batcher.close()
    shard.batcher.close()


def three_way(jax_ref, knobs, plain, shard, prompt, n, temperature=0.0, seed=0):
    """port meshed == port unmeshed == JAX meshed, each alone."""
    a = gen(plain, prompt, n, temperature, seed)
    b = gen(shard, prompt, n, temperature, seed)
    assert b == a, (prompt, temperature, seed)
    assert b == jax_ref(knobs, prompt, n, temperature, seed), (prompt, temperature, seed)
    return b


def outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the verdict is the datum
        return ("raise", type(e).__name__, str(e))


# -- the mesh: typed refusals with the JAX messages ----------------------------


def test_mesh_shape_error_is_a_value_error():
    assert issubclass(MeshShapeError, ValueError)
    assert issubclass(jax_mesh.MeshShapeError, ValueError)


@pytest.mark.parametrize("n", [0, -4, "8", 1, 8, 16, 32])
def test_factor_devices_agrees(n):
    got = [outcome(mod.factor_devices, n) for mod in (jax_mesh, port_mesh)]
    assert got[1] == got[0]


@pytest.mark.parametrize("shape", [
    {"model": 0}, {"data": -2}, {"model": "4"},   # bad sizes
    {"data": 16},                                  # oversubscription
    {"data": 3}, {"data": 5, "model": 1},          # stranded chips
])
def test_make_serving_mesh_refuses_as_jax(shape):
    """Over the CPU's 8 positions the port refuses every bad shape with
    the JAX ``make_mesh`` message (8 virtual devices)."""
    assert jax.device_count() == 8 == port_mesh.CPU_DEVICE_COUNT
    with pytest.raises(jax_mesh.MeshShapeError) as want:
        jax_mesh.make_mesh(shape)
    with pytest.raises(MeshShapeError) as got:
        make_serving_mesh(shape, device="cpu")
    assert str(got.value) == str(want.value)


def test_make_serving_mesh_accepts_dividing_sub_block():
    mesh = make_serving_mesh({"data": 2, "model": 2}, device="cpu")
    want = jax_mesh.make_mesh({"data": 2, "model": 2})
    assert mesh.size == want.devices.size == 4
    assert mesh.shape == dict(want.shape) == {"data": 2, "model": 2}
    assert mesh.axis_names == tuple(want.axis_names)
    assert [mesh.coords(i) for i in range(4)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 1}]


@pytest.mark.parametrize("raw", [
    "data=2,model=4", " model=8 ", "data=1,stage=2,seq=1,model=4",
    "", "data", "data=", "data=x", "data=0", "data=-2", "data=2,data=4",
    "rows=2", "data=2,,model=4", "data=2.5",
])
def test_parse_mesh_shape_agrees(raw):
    got = [outcome(mod.parse_mesh_shape, raw) for mod in (jax_mesh, port_mesh)]
    assert got[1] == got[0]


@pytest.mark.parametrize("args", [
    ({"data": 2, "model": 4}, 4, 64), ({"model": 8}, 4, 64),
    ({"model": 4}, 4, 66), ({"model": 4}, 4, 64, 2),
])
def test_validate_model_dims_agrees(args):
    got = [outcome(mod.validate_model_dims, *args) for mod in (jax_mesh, port_mesh)]
    assert got[1] == got[0]


def _spec(s):
    return tuple(s.spec)


def test_cache_and_slab_sharding_match_jax_with_gqa_fallback():
    jm = jax_mesh.make_mesh({"data": 2, "model": 4})
    pm = make_serving_mesh({"data": 2, "model": 4}, device="cpu")
    for kv in (4, 2):  # 2 % 4 != 0: the KV cache replicates
        cfg = {**LLM_TINY, "n_kv_heads": kv}
        j, p = JaxLM(**cfg), DecoderLM(**cfg)
        assert _spec(p.cache_sharding(pm)) == _spec(j.cache_sharding(jm))
        assert _spec(p.slab_sharding(pm)) == _spec(j.slab_sharding(jm))
    assert _spec(DecoderLM(**LLM_TINY).cache_sharding(pm)) == (None, "model", None, None)
    jq = jax_mesh.make_mesh({"data": 1, "seq": 2, "model": 4})
    pq = make_serving_mesh({"data": 1, "seq": 2, "model": 4}, device="cpu")
    j, p = JaxLM(**LLM_TINY), DecoderLM(**LLM_TINY)
    assert (_spec(p.cache_sharding(pq, shard_seq=True))
            == _spec(j.cache_sharding(jq, shard_seq=True)) == (None, "model", "seq", None))


@pytest.mark.parametrize("n_experts", [0, 4])
@pytest.mark.parametrize("shape", [{"data": 2, "model": 4}, {"data": 8}])
def test_param_sharding_table_matches_jax(n_experts, shape):
    """``param_sharding`` leaf for leaf against the JAX PartitionSpecs,
    MoE's ``w1e``/``w2e`` included; a mesh without ``model`` replicates
    every leaf."""
    cfg = {**LLM_TINY, "n_experts": n_experts}
    jm, pm = JaxLM(**cfg), DecoderLM(**cfg)
    jp = jax.jit(jm.init_params)(0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    want = jm.param_sharding(jax_mesh.make_mesh(shape), jp)
    got = pm.param_sharding(make_serving_mesh(shape, device="cpu"), tp)

    def flat(tree, path=()):
        if isinstance(tree, dict):
            return {k: v for key in tree for k, v in flat(tree[key], path + (key,)).items()}
        return {path: tuple(tree.spec)}

    assert flat(got) == flat(want)
    if n_experts and "model" in shape:
        assert flat(got)[("blocks", "w1e")] == (None, None, None, "model")


def test_sharded_tensor_blocks_round_trip():
    """A ``ShardedTensor`` holds real blocks (one per model index here,
    two data replicas on one device collapse to one) and its reads and
    writes equal the whole tensor's, also with T split over ``seq``."""
    mesh = ServingMesh({"data": 2, "model": 4}, ["cpu"] * 8)
    t = torch.randn(3, 8, 10, 4)
    st = ShardedTensor.from_tensor(t, ServingSharding(mesh, (None, "model", None, None)))
    assert len(st.blocks()) == 4 and st.shard_nbytes * 4 == st.nbytes == t.nbytes
    ix = torch.tensor([0, 2])
    assert torch.equal(st[ix, :, :5], t[ix, :, :5]) and torch.equal(st[1, :, 2:7], t[1, :, 2:7])
    v = torch.randn(2, 8, 5, 4)
    st[ix, :, :5] = v
    t[ix, :, :5] = v
    st[1, :, 5:] = 0
    t[1, :, 5:] = 0
    st.narrow(0, 2, 1)[0, :, 3] = 7.0
    t[2, :, 3] = 7.0
    assert torch.equal(st.full(), t)
    seq = ServingMesh({"data": 1, "seq": 2, "model": 2}, ["cpu"] * 4)
    t2 = torch.randn(3, 4, 10, 4)
    s2 = ShardedTensor.from_tensor(t2, ServingSharding(seq, (None, "model", "seq", None)))
    assert len(s2.blocks()) == 4
    s2[ix, :, 3:8] = 1.5
    t2[ix, :, 3:8] = 1.5
    assert torch.equal(s2[:, :, :7], t2[:, :, :7]) and torch.equal(s2.full(), t2)


# -- the mesh_shape knob: strict at construction --------------------------------


@pytest.mark.parametrize("raw", ["rows=2", "data=0"])
def test_mesh_shape_malformed_refused_at_construction(model_dir, raw):
    with pytest.raises(jax_mesh.MeshShapeError) as want:
        JaxServer(model_uri=model_dir, mesh_shape=raw)
    with pytest.raises(MeshShapeError) as got:
        GenerateServer(model_uri=model_dir, device="cpu", mesh_shape=raw)
    assert str(got.value) == str(want.value)


def test_mesh_shape_model_indivisible_refused_at_load(model_dir):
    errors = []
    for cls, kw in ((JaxServer, {}), (GenerateServer, {"device": "cpu"})):
        s = cls(model_uri=model_dir, slots=2, mesh_shape="model=8", **kw)
        with pytest.raises(ValueError, match="n_heads") as e:
            s.load()
        errors.append(str(e.value))
    assert errors[1] == errors[0]


def test_mesh_shape_auto_builds_data_model_mesh(model_dir, jax_ref):
    s = GenerateServer(model_uri=model_dir, device="cpu", slots=2, steps_per_poll=2,
                       mesh_shape="auto")
    s.load()
    want = JaxServer(model_uri=model_dir, slots=2, steps_per_poll=2, mesh_shape="auto")
    want.load()
    try:
        # factor_devices(8) collapsed to the 2D serving mesh, as JAX
        assert s.batcher.mesh.shape == dict(want.batcher.mesh.shape) == {"data": 4, "model": 2}
        assert gen(s, [1, 2, 3], 4) == gen(want, [1, 2, 3], 4)
    finally:
        s.batcher.close()
        want.batcher.close()


# -- byte identity: port meshed == port unmeshed == JAX meshed --------------------


def test_plain_decode_byte_identity(model_dir, jax_ref):
    plain, shard = twin_servers(model_dir)
    try:
        assert plain.batcher.mesh is None
        assert shard.batcher.mesh.shape == {"data": 2, "model": 4}
        # the served params are really split into blocks ...
        blocks = shard.batcher.params["blocks"]
        assert isinstance(blocks["wq"], ShardedTensor) and len(blocks["wq"].blocks()) == 4
        assert isinstance(shard.batcher.params["embed"], torch.Tensor)
        # ... and so is the KV cache (heads over model)
        k0 = shard.batcher._cache["k"][0]
        assert isinstance(k0, ShardedTensor) and k0.sharding.spec[1] == "model"
        for p in PROMPTS:
            three_way(jax_ref, {}, plain, shard, p, 16)
        for i, p in enumerate(PROMPTS):
            three_way(jax_ref, {}, plain, shard, p, 12, temperature=0.8, seed=11 + i)
    finally:
        close_pair(plain, shard)


def test_prefix_splice_byte_identity(model_dir, jax_ref):
    knobs = dict(prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=4)
    plain, shard = twin_servers(model_dir, **knobs)
    try:
        stem = [7, 3, 9, 4, 1, 8, 2, 6]
        three_way(jax_ref, knobs, plain, shard, stem, 12)
        # the second pass splices the published prefix on both servers; the
        # meshed prefix slab lives split like the cache
        for tail in (stem + [5], stem + [9, 9]):
            three_way(jax_ref, knobs, plain, shard, tail, 12)
        assert shard.batcher.stats["prefix_hits"] >= 1
        assert plain.batcher.stats["prefix_hits"] >= 1
        # the published prefix slab is stored split like the cache
        _m, slab = shard.batcher._prefix_index.match(stem)
        assert isinstance(slab["k"], ShardedTensor) and slab["k"].sharding.spec[2] == "model"
    finally:
        close_pair(plain, shard)


def test_chunked_prefill_byte_identity(model_dir, jax_ref):
    knobs = dict(prefill_chunk=8)
    plain, shard = twin_servers(model_dir, **knobs)
    try:
        assert isinstance(shard.batcher._new_slab(16)["k"], ShardedTensor)
        long_prompt = [(i * 7 + 3) % 61 for i in range(30)]
        three_way(jax_ref, knobs, plain, shard, long_prompt, 16)
        three_way(jax_ref, knobs, plain, shard, long_prompt, 10, temperature=0.8, seed=5)
        assert shard.batcher.stats["prefill_chunks"] > 0
    finally:
        close_pair(plain, shard)


def test_fused_decode_byte_identity(model_dir, jax_ref):
    knobs = dict(fused_steps_per_dispatch=4)
    plain, shard = twin_servers(model_dir, **knobs)
    try:
        for p in PROMPTS[:2]:
            three_way(jax_ref, knobs, plain, shard, p, 16)
        three_way(jax_ref, knobs, plain, shard, PROMPTS[0], 12, temperature=0.8, seed=3)
        assert shard.batcher.stats["fused_dispatches"] > 0
    finally:
        close_pair(plain, shard)


def test_pressure_preemption_resume_byte_identity(model_dir, jax_ref):
    """A preempt/resume cycle on the meshed server: the checkpoint and the
    resume run against the split cache, and every output still equals the
    unpressured run (port unmeshed and JAX meshed, each alone)."""
    knobs = dict(hbm_ledger_bytes=1 << 40)
    plain, shard = twin_servers(model_dir, **knobs)
    try:
        refs = [gen(plain, p, 24) for p in PROMPTS]
        assert refs == [jax_ref(knobs, p, 24) for p in PROMPTS]
        b = shard.batcher
        futs = [b.submit(p, max_new_tokens=24, temperature=0.0) for p in PROMPTS]
        deadline = time.monotonic() + 60
        while len(b._active) + len(b._chunked) < 2 and time.monotonic() < deadline:
            time.sleep(0.002)
        # a mid-run ledger shrink to ~1.3 live lanes; the meshed ledger
        # prices one shard, so the lane cost is the whole cache's over
        # _kv_shard
        shrink = int(1.3 * b._attn_need(b.max_seq) * b._kv_key_bytes / b._kv_shard)
        inj = FaultInjector([], pressure={
            "shrink_to_bytes": shrink,
            "after_polls": b._work_poll_count + 1,
            "restore_after_polls": 12,
        })
        b.pressure_hook = inj.pressure_hook()
        outs = [f.result(timeout=120) for f in futs]
        assert outs == refs
        assert b.stats["preemptions"] >= 1
        assert b.stats["preempt_resumes"] == b.stats["preemptions"]
    finally:
        close_pair(plain, shard)


class _Gate:
    """A poll hook that parks the loop while a wave is submitted, so the
    whole wave is queued before the loop takes any of it."""

    def __init__(self):
        import threading

        self.hold, self.parked, self.go = (threading.Event(), threading.Event(),
                                           threading.Event())

    def __call__(self, _poll):
        if self.hold.is_set():
            self.parked.set()
            self.go.wait(60)

    def submit_together(self, b, prompts, n):
        self.go.clear()
        self.parked.clear()
        self.hold.set()
        assert self.parked.wait(30)
        try:
            return [b.submit(p, max_new_tokens=n) for p in prompts]
        finally:
            self.hold.clear()
            self.go.set()


def test_pressure_decisions_equal_unsharded():
    """The per-shard ledger takes the unmeshed batcher's decisions: with
    the shrink scaled by ``_kv_shard``, the same traffic (eight prefix
    slabs published, then four lanes queued whole under a budget that
    evicting six slabs satisfies) gives the same evictions and no
    preemption on both, and the same tokens. Rung 1 must win back the
    per-shard overshoot times the slab's split: a quarter of it would
    leave the ledger over and preempt a lane. pipeline_depth 1 makes
    the two loops' polls match."""
    from seldon_core_tpu_torch.resilience.faults import FaultInjector

    jm = JaxLM(**LLM_TINY)
    tp = params_from_numpy(jax.tree.map(np.asarray, jax.jit(jm.init_params)(0)), device="cpu")
    kw = dict(slots=4, max_seq=64, prefill_buckets=(8, 16, 32), steps_per_poll=2,
              pipeline_depth=1, prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=4,
              hbm_ledger_bytes=1 << 30)
    plain = ContinuousBatcher(DecoderLM(**LLM_TINY), tp, **kw)
    shard = ContinuousBatcher(DecoderLM(**LLM_TINY), tp, **kw,
                              mesh=make_serving_mesh({"data": 2, "model": 4}, device="cpu"))
    rs = np.random.RandomState(3)
    stems = [rs.randint(0, 64, 12).tolist() for _ in range(8)]
    got = {}
    try:
        for name, b in (("plain", plain), ("shard", shard)):
            gate = _Gate()
            b.fault_hook = gate
            alone = [b.generate(st, max_new_tokens=6) for st in stems]
            # the wave's lanes plus every prefix slab: over the high
            # watermark, and the overshoot under the prefix bytes
            lanes = len(PROMPTS) * b._attn_need(b.max_seq) * b._kv_key_bytes
            b.pressure_hook = FaultInjector([], pressure={
                "shrink_to_bytes": (lanes + b._prefix_index.total_bytes) // b._kv_shard,
                "after_polls": b._work_poll_count + 2,
                "restore_after_polls": 8}).pressure_hook()
            outs = [f.result(60) for f in gate.submit_together(b, PROMPTS, 20)]
            keys = ("prefix_hits", "pressure_prefix_evictions", "preemptions",
                    "preempt_resumes", "replayed_tokens")
            got[name] = (alone, outs, {k: b.stats[k] for k in keys})
        assert got["shard"] == got["plain"]
        counters = got["shard"][2]
        assert counters["pressure_prefix_evictions"] >= 1 and counters["preemptions"] == 0
    finally:
        plain.close()
        shard.close()


@pytest.mark.parametrize("knobs", [
    dict(depth_groups=2),
    dict(speculate_tokens=2, draft_layers=1),
    dict(host_kv_tier_bytes=1 << 20, prefix_cache_hbm_bytes=1 << 20,
         prefix_cache_min_tokens=4),
], ids=["depth-groups", "speculation", "kv-tier"])
def test_more_knobs_meshed_equal_unmeshed(model_dir, knobs):
    """Depth groups (a group's lanes scattered back into the split
    cache), speculation (the draft's params and cache split too) and the
    host tier under a mesh: greedy and seeded streams equal the unmeshed
    server's, requests alone and queued together."""
    plain, shard = twin_servers(model_dir, **knobs)
    try:
        prompts = PROMPTS + [[7, 3, 9, 4, 1, 8, 2, 6], [7, 3, 9, 4, 1, 8, 2, 6, 5]]
        for i, p in enumerate(prompts):
            assert gen(shard, p, 10) == gen(plain, p, 10)
            assert gen(shard, p, 8, 0.8, i) == gen(plain, p, 8, 0.8, i)
        both = [[b.submit(p, max_new_tokens=9) for p in prompts]
                for b in (plain.batcher, shard.batcher)]
        assert [f.result(60) for f in both[1]] == [f.result(60) for f in both[0]]
    finally:
        close_pair(plain, shard)


def test_shard_cache_seq_equals_unmeshed(model_dir):
    """``shard_cache_seq`` splits the cache length over ``seq`` too: four
    blocks per layer, ``kv_shard`` 4, the same tokens."""
    plain = GenerateServer(model_uri=model_dir, device="cpu", slots=4, steps_per_poll=2,
                           prefill_chunk=8)
    shard = GenerateServer(model_uri=model_dir, device="cpu", slots=4, steps_per_poll=2,
                           prefill_chunk=8, mesh_shape="data=2,seq=2,model=2",
                           shard_cache_seq="true")
    plain.load()
    shard.load()
    try:
        k0 = shard.batcher._cache["k"][0]
        assert k0.sharding.spec == (None, "model", "seq", None) and len(k0.blocks()) == 4
        assert shard.batcher._kv_shard == 4 and shard.batcher._kv_seq_shard == 2
        for p in PROMPTS + [[(i * 7 + 3) % 61 for i in range(30)]]:
            assert gen(shard, p, 12) == gen(plain, p, 12)
            assert gen(shard, p, 8, 0.8, 4) == gen(plain, p, 8, 0.8, 4)
    finally:
        close_pair(plain, shard)


# -- observability: the mesh gauges and the warm census ---------------------------


def test_mesh_gauges_exposed(model_dir):
    s = GenerateServer(model_uri=model_dir, device="cpu", slots=2, steps_per_poll=2,
                       mesh_shape=MESH_SHAPE)
    s.load()
    want = JaxServer(model_uri=model_dir, slots=2, steps_per_poll=2, mesh_shape=MESH_SHAPE)
    want.load()
    try:
        gen(s, [1, 2, 3], 4)
        gen(want, [1, 2, 3], 4)
        m = {d["key"]: d["value"] for d in s.metrics()}
        jm = {d["key"]: d["value"] for d in want.metrics()}
        keys = ("gen_mesh_devices", "gen_mesh_data", "gen_mesh_model",
                "gen_mesh_param_shard_bytes", "gen_mesh_kv_shard")
        assert {k: m[k] for k in keys} == {k: jm[k] for k in keys}
        assert (m["gen_mesh_devices"], m["gen_mesh_data"], m["gen_mesh_model"],
                m["gen_mesh_kv_shard"]) == (8, 2, 4, 4)
        total = s.batcher._param_bytes
        assert total // 4 <= m["gen_mesh_param_shard_bytes"] < total
        # and the engine maps them to first-class series, as JAX
        from seldon_core_tpu.graph.engine_metrics import MetricsRegistry as JaxReg
        from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
        for k in keys:
            assert MetricsRegistry._RECOVERY_GAUGES[k] == JaxReg._RECOVERY_GAUGES[k]
    finally:
        s.batcher.close()
        want.batcher.close()


def test_unmeshed_server_emits_no_mesh_gauges(model_dir):
    s = GenerateServer(model_uri=model_dir, device="cpu", slots=2, steps_per_poll=2)
    s.load()
    try:
        gen(s, [1, 2, 3], 4)
        assert not any(d["key"].startswith("gen_mesh_") for d in s.metrics())
    finally:
        s.batcher.close()


def test_warm_census_names_the_sharded_layout(model_dir, caplog):
    s = GenerateServer(model_uri=model_dir, device="cpu", slots=2, steps_per_poll=2,
                       mesh_shape=MESH_SHAPE, warmup_prompt_lens=[8],
                       warmup_max_new_tokens=4)
    with caplog.at_level(logging.INFO, logger="seldon_core_tpu_torch.serving.continuous"):
        s.load()
    try:
        census = [r.getMessage() for r in caplog.records
                  if "sharded serving census" in r.getMessage()]
        assert census, "warm() emitted no sharded serving census"
        msg = census[-1]
        assert "devices=8" in msg and "kv_shard=4" in msg
        assert f"param_shard_bytes={s.batcher._param_shard_bytes}" in msg
        # 7 of the 12 leaves split: wq wk wv wo w1 w3 w2
        assert "partitioned_params=7/12" in msg
        assert len(gen(s, [1, 2, 3, 4, 5, 6, 7, 8], 4)) == 12
    finally:
        s.batcher.close()


# -- seldon.io/mesh: apply -> reconciler -> serving engine --------------------------


def _pspec(pkg, ann=None, impl="GENERATE_SERVER", tpu_mesh=None, uri="file:///m"):
    spec = __import__(f"{pkg}.graph.spec", fromlist=["spec"])
    d = {"name": "p", "annotations": ann or {},
         "graph": {"name": "gen", "type": "MODEL", "implementation": impl, "modelUri": uri}}
    if tpu_mesh:
        d["tpuMesh"] = tpu_mesh
    return spec, spec.PredictorSpec.from_dict(d)


@pytest.mark.parametrize("case", [
    ({}, "GENERATE_SERVER", None), ({"seldon.io/mesh": "data=2,model=4"}, "GENERATE_SERVER", None),
    ({"seldon.io/mesh": "rows=2"}, "GENERATE_SERVER", None),
    ({"seldon.io/mesh": "data=0"}, "GENERATE_SERVER", None),
    ({"seldon.io/mesh": "model=4"}, "SKLEARN_SERVER", None),
    ({"seldon.io/mesh": "model=4"}, "GENERATE_SERVER", {"model": 4}),
])
def test_mesh_annotation_parse_and_validation(case):
    ann, impl, tpu_mesh = case
    got = []
    for pkg in ("seldon_core_tpu", "seldon_core_tpu_torch"):
        spec, p = _pspec(pkg, ann, impl, tpu_mesh)
        got.append((outcome(spec.parse_mesh_annotation, p), outcome(spec.validate_predictor, p)))
    assert got[1] == got[0]


def test_reconciler_injects_mesh_into_member_spec():
    from seldon_core_tpu_torch.controlplane.reconciler import DeploymentController
    from seldon_core_tpu_torch.controlplane.resource import SeldonDeployment

    rec = DeploymentController.__new__(DeploymentController)
    rec._kv_ports = {}
    rec.components = {}
    dep = SeldonDeployment.from_dict({
        "metadata": {"name": "d", "namespace": "ns"},
        "spec": {"predictors": [{
            "name": "p", "annotations": {"seldon.io/mesh": "data=2,model=4"},
            "graph": {"name": "gen", "type": "MODEL", "implementation": "GENERATE_SERVER",
                      "modelUri": "file:///m"},
        }]},
    })
    specs = asyncio.run(rec.desired_components(dep))
    engines = [s for s in specs if s.kind == "engine"]
    assert engines
    for es in engines:
        assert es.engine_spec.get("tpuMesh") == {"data": 2, "model": 4}
        assert "seldon.io/mesh" not in (es.engine_spec.get("annotations") or {})


def test_mesh_annotation_round_trips_to_serving_engine(model_dir, jax_ref):
    """Apply a CR carrying ``seldon.io/mesh`` -> the reconciler validates
    and injects tpuMesh -> placement carves 8 CPU positions -> the
    engine's generate server serves on that very mesh, the JAX meshed
    server's tokens."""
    from seldon_core_tpu_torch.controlplane import (
        DeploymentController, DevicePlacement, Gateway, ResourceStore, SeldonDeployment,
    )
    from seldon_core_tpu_torch.controlplane.resource import STATE_AVAILABLE
    from seldon_core_tpu_torch.controlplane.runtime import InProcessRuntime

    async def go():
        store = ResourceStore()
        placement = DevicePlacement(devices=[torch.device("cpu") for _ in range(8)])
        ctl = DeploymentController(store, runtime=InProcessRuntime(open_ports=False),
                                   placement=placement, gateway=Gateway())
        dep = SeldonDeployment.from_dict({
            "name": "meshdep",
            "predictors": [{
                "name": "p0", "annotations": {"seldon.io/mesh": "data=2,model=4"},
                "graph": {"name": "g", "implementation": "GENERATE_SERVER",
                          "modelUri": model_dir, "parameters": [
                              {"name": "device", "value": "cpu", "type": "STRING"},
                              {"name": "slots", "value": "4", "type": "INT"},
                              {"name": "steps_per_poll", "value": "2", "type": "INT"}]},
            }],
        })
        store.apply(dep)
        status = await ctl.reconcile(dep.clone())
        assert status.state == STATE_AVAILABLE, status.description
        assert placement.capacity()["used"] == 8
        engines = [h for h, _ in ctl.components.values() if h.spec.kind == "engine"]
        assert len(engines) == 1
        app = engines[0].app
        assert app.executor._mesh.shape == {"data": 2, "model": 4}
        server = app.executor.root.client.user_object
        assert server.batcher.mesh is app.executor._mesh
        out = await app.predict({"jsonData": {"prompt_tokens": [[1, 2, 3]],
                                              "max_new_tokens": 4}})
        toks = [int(t) for t in out["jsonData"]["tokens"][0]]
        assert toks == jax_ref({}, [1, 2, 3], 4)
        server.batcher.close()
        await ctl.delete(dep)
        assert placement.capacity()["used"] == 0

    asyncio.run(go())


def test_engine_main_builds_the_mesh_of_tpu_mesh(model_dir, monkeypatch):
    """A standalone engine with a predictor ``tpuMesh`` builds the serving
    mesh over its own devices (the CPU's positions here) and its generate
    unit serves on it. The predict path's TorchServer, which once refused
    a mesh as not ported, serves the same model on it: its params split
    over ``model`` and its logits the unmeshed server's bit for bit."""
    from seldon_core_tpu_torch import engine_main
    from seldon_core_tpu_torch.graph.executor import GraphExecutor
    from seldon_core_tpu_torch.graph.spec import PredictorSpec

    spec = PredictorSpec.from_dict({
        "name": "p", "tpuMesh": {"data": 1, "model": 2},
        "graph": {"name": "g", "implementation": "GENERATE_SERVER", "modelUri": model_dir,
                  "parameters": [{"name": "device", "value": "cpu", "type": "STRING"},
                                 {"name": "slots", "value": "2", "type": "INT"}]}})
    monkeypatch.setenv("ENGINE_PREDICTOR", spec.to_env_b64())
    loaded = engine_main.load_spec(None)
    mesh = engine_main.build_mesh(loaded)
    assert mesh.shape == {"data": 1, "model": 2} and mesh.device.type == "cpu"
    ex = GraphExecutor(loaded, mesh=mesh)
    try:
        server = ex.root.client.user_object
        assert server.batcher.mesh is mesh
        assert len(gen(server, [1, 2, 3], 3)) == 6
    finally:
        server.batcher.close()
        asyncio.run(ex.close())
    from seldon_core_tpu_torch.parallel.mesh import ShardedTensor
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    torch_spec = PredictorSpec.from_dict({
        "name": "p", "graph": {"name": "c", "implementation": "JAX_SERVER",
                               "modelUri": model_dir, "parameters": [
                                   {"name": "device", "value": "cpu", "type": "STRING"}]}})
    ex = GraphExecutor(torch_spec, mesh=mesh)
    try:
        meshed = ex.root.client.user_object
        assert isinstance(meshed.params["blocks"]["wq"], ShardedTensor)
        plain = TorchServer(model_dir, device="cpu")
        plain.load()
        toks = np.asarray([[1, 2, 3, 4]], np.int32)
        torch.testing.assert_close(meshed.predict(toks, []), plain.predict(toks, []),
                                   rtol=0, atol=0)
    finally:
        asyncio.run(ex.close())


# -- per-shard ledger accounting (2x2 mesh) -------------------------------------


def test_per_shard_ledger_accounting_2x2():
    """The pressure ledger sees one position's bytes: on data=2,model=2
    with 4 KV heads each slab holds half the heads per position. The
    split factors, the per-shard param bytes and the halved prefix
    component equal the JAX batcher's."""
    from seldon_core_tpu.serving.continuous import ContinuousBatcher as JaxBatcher

    jm = JaxLM(**LLM_TINY)
    jp = jax.jit(jm.init_params)(0)
    tm = DecoderLM(**LLM_TINY)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(slots=2, max_seq=64, prefill_buckets=(8, 16, 32), steps_per_poll=2,
              prefix_cache_hbm_bytes=1 << 20, prefix_cache_min_tokens=4,
              hbm_ledger_bytes=1 << 30)
    plain = ContinuousBatcher(tm, tp, **kw)
    shard = ContinuousBatcher(tm, tp, mesh=make_serving_mesh({"data": 2, "model": 2},
                                                            device="cpu"), **kw)
    ref = JaxBatcher(jm, jp, mesh=jax_mesh.make_mesh({"data": 2, "model": 2}), **kw)
    try:
        for name in ("_kv_model_shard", "_kv_seq_shard", "_kv_shard", "_param_bytes",
                     "_param_shard_bytes", "_kv_key_bytes"):
            assert getattr(shard, name) == getattr(ref, name), name
        assert (shard._kv_model_shard, shard._kv_shard, plain._kv_shard) == (2, 2, 1)
        assert plain._param_shard_bytes == plain._param_bytes
        assert shard._param_bytes // 2 <= shard._param_shard_bytes < shard._param_bytes

        prompt = [7, 3, 9, 4, 1, 8, 2, 6]
        out = [b.generate(prompt, max_new_tokens=8) for b in (plain, shard, ref)]
        assert [int(t) for t in out[2]] == out[1] == out[0]

        def wait_prefix(b, divisor):
            deadline = time.monotonic() + 30
            while True:
                total = b._prefix_index.total_bytes
                got = b._pressure.components.get("prefix", 0)
                if total > 0 and got == total // divisor:
                    return total, got
                if time.monotonic() > deadline:
                    raise AssertionError(f"prefix component never settled: total={total} "
                                         f"component={got} divisor={divisor}")
                time.sleep(0.002)

        p_total, p_bytes = wait_prefix(plain, 1)
        s_total, s_bytes = wait_prefix(shard, 2)
        r_total, r_bytes = wait_prefix(ref, 2)
        assert p_total == s_total == r_total > 0
        assert s_bytes == r_bytes == p_bytes // 2
        summary, want = shard.pressure_summary(), ref.pressure_summary()
        assert (summary["kv_shard"], summary["param_shard_bytes"]) == (
            want["kv_shard"], want["param_shard_bytes"]) == (2, shard._param_shard_bytes)
        assert "kv_shard" not in plain.pressure_summary()
    finally:
        plain.close()
        shard.close()
        ref.close()


# -- the serving half of dryrun_multichip ----------------------------------------


def test_dryrun_serving_half_equals_unsharded():
    """The sharded ``apply`` over each factorization's serving mesh (the
    serving half of ``__graft_entry__.dryrun_multichip``): finite logits
    equal to the unsharded forward's bit for bit (checked inside), the
    JAX dry run's shapes."""
    from seldon_core_tpu_torch.parallel.train import dryrun_factorizations, dryrun_serving

    shapes = [dryrun_serving(ax, device="cpu") for ax in dryrun_factorizations(8)]
    want = [(ax["data"] * 4, 8 * ax["seq"], 256) for ax in dryrun_factorizations(8)]
    assert shapes == want
