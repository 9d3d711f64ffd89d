"""Depth groups in the port (``depth_groups``): lanes split into
sub-bursts by attention-read bucket, each group gathering its lanes'
cache prefix, decoding over it and scattering it back. Held against the
JAX batcher's plan on the same lane positions, against the port with
groups off, and against the JAX batcher with the same knobs, on the CPU
at the tiny config of tests/test_torch_serving.py. ``MIN_ATTN_BUCKET``
is lowered to 16 so that a 64-position cache holds several buckets (the
JAX package's tests do the same)."""

import numpy as np
import pytest
import torch

from seldon_core_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

from _torch_sched import JaxReference, make_models, mixed, port, run_port

GROUPS = dict(attn_bucket=16, depth_groups=4, depth_group_split_bytes=0)


@pytest.fixture(autouse=True)
def _sub_tile_attn_buckets():
    old = (ContinuousBatcher.MIN_ATTN_BUCKET, JaxBatcher.MIN_ATTN_BUCKET)
    ContinuousBatcher.MIN_ATTN_BUCKET = JaxBatcher.MIN_ATTN_BUCKET = 16
    yield
    ContinuousBatcher.MIN_ATTN_BUCKET, JaxBatcher.MIN_ATTN_BUCKET = old


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def jax_ref(models):
    ref = JaxReference(models)
    yield ref
    ref.close()


def _mixed(temperature=0.0):
    # 6 requests over 4 lanes, shallow and deep prompts mixed
    return mixed(17, (3, 40, 5, 35, 9, 28), max_new=6, temperature=temperature)


@pytest.mark.parametrize("seed", range(8))
def test_plan_groups_equal_jax(models, seed):
    rs = np.random.RandomState(seed)
    slots = int(rs.choice([4, 6, 8]))
    knobs = dict(slots=slots, max_seq=64, prefill_buckets=(8, 16, 32), attn_bucket=16,
                 depth_groups=int(rs.choice([2, 3, 4])),
                 depth_group_split_bytes=[0, None, 200_000][seed % 3])
    jb = JaxBatcher(models[0], models[1], **knobs)
    tb = ContinuousBatcher(models[2], models[3], **knobs)
    try:
        assert tb._kv_key_bytes == jb._kv_key_bytes
        assert tb._param_bytes == jb._param_bytes
        assert tb._group_split_bytes == jb._group_split_bytes
        assert tb._warm_group_sizes() == jb._warm_group_sizes()
        for n in range(1, slots + 1):
            assert tb._group_size_bucket(n) == jb._group_size_bucket(n)
        for _ in range(10):
            lanes = rs.choice(slots, size=rs.randint(1, slots + 1), replace=False)
            pos = {int(s): int(rs.randint(1, 56)) for s in lanes}
            for b in (jb, tb):
                b._active = {s: object() for s in pos}
                b._pos_host = dict(pos)
            adv = int(rs.choice([1, 2, 8]))
            assert tb._plan_groups(adv) == jb._plan_groups(adv)
    finally:
        for b in (jb, tb):
            b._active = {}
            b.close()


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_grouped_equals_ungrouped_and_jax(models, jax_ref, temperature):
    reqs = _mixed(temperature)
    off, _ = run_port(models, reqs, stagger=0.03, attn_bucket=16)
    on, stats = run_port(models, reqs, stagger=0.03, **GROUPS)
    assert on == off
    assert on == jax_ref(reqs, **GROUPS)
    assert stats["group_bursts"] > 0  # the forced split really split
    assert stats["group_pad_lanes"] >= 0 and stats["group_lanes"] > 0


def test_no_lane_reads_past_its_group_bucket(models):
    b = port(models, **GROUPS)
    b.trace_groups = []
    try:
        futs = [b.submit(p, **kw) for p, kw in _mixed()]
        for f in futs:
            f.result(timeout=120)
    finally:
        b.close()
    assert any(t["grouped"] for t in b.trace_groups)
    for t in b.trace_groups:
        assert all(need <= t["attn_len"] for need in t["need"].values())
        if t["grouped"]:
            # a group's read is its own deepest lane's bucket
            assert t["attn_len"] == max(t["need"].values())


def test_groups_repack_as_prefixes_cross_buckets(models):
    """Three lanes deepening at once: the partition changes from poll to
    poll as lanes cross attention buckets, and a lane's group bucket
    grows with its own depth."""
    b = port(models, slots=3, **GROUPS)
    b.trace_groups = []
    try:
        futs = [b.submit(list(range(1, n + 1)), max_new_tokens=26) for n in (3, 12, 30)]
        for f in futs:
            f.result(timeout=120)
    finally:
        b.close()
    polls, current = [], []
    for t in b.trace_groups:
        current.append(tuple(sorted(t["lanes"])))
        if sum(len(c) for c in current) == 3:
            polls.append(tuple(sorted(current)))
            current = []
    assert len(set(polls)) >= 2
    buckets = {}
    for t in b.trace_groups:
        for lane in t["lanes"]:
            buckets.setdefault(lane, []).append(t["attn_len"])
    for seq in buckets.values():
        assert seq == sorted(seq) and len(set(seq)) >= 2


def test_group_pads_round_trip_bit_identical(models):
    """A group burst over lanes [2] padded with lanes 0, 1, 3 (other
    groups' lanes): the pads' cache rows and registers come back bit for
    bit, the real lane advances."""
    b = port(models, slots=4, **GROUPS)
    try:
        rs = np.random.RandomState(3)
        for layer in b._cache["k"] + b._cache["v"]:
            layer.copy_(torch.from_numpy(rs.randn(*layer.shape).astype(np.float32)))
        b._whole.cur.copy_(torch.tensor([5, 6, 7, 8]))
        b._whole.pos.copy_(torch.tensor([20, 9, 14, 30]))
        b._whole.act.fill_(True)
        before = {n: [l.clone() for l in b._cache[n]] for n in ("k", "v")}
        regs = [t.clone() for t in (b._whole.cur, b._whole.pos, b._whole.keys)]
        toks, counts = b._group_burst([2, 0, 1, 3], 1, k=2, attn_len=32,
                                      stochastic=False, masked=False)
        assert counts is None and toks.shape == (3, 4)
        for n in ("k", "v"):
            for new, old in zip(b._cache[n], before[n]):
                assert torch.equal(new[[0, 1, 3]], old[[0, 1, 3]])
                assert torch.equal(new[2, :, :14], old[2, :, :14])
                assert not torch.equal(new[2, :, 14:16], old[2, :, 14:16])
        for new, old in zip((b._whole.cur, b._whole.pos, b._whole.keys), regs):
            assert torch.equal(new[[0, 1, 3]], old[[0, 1, 3]])
        assert b._whole.pos[2].item() == 16
        assert toks[1:, 1:].eq(0).all()  # pads emit nothing
    finally:
        b.close()


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_fused_with_groups(models, jax_ref, temperature):
    reqs = _mixed(temperature)
    knobs = dict(GROUPS, fused_steps_per_dispatch=8)
    off, _ = run_port(models, reqs, stagger=0.03, attn_bucket=16)
    on, stats = run_port(models, reqs, stagger=0.03, **knobs)
    assert on == off
    assert on == jax_ref(reqs, **knobs)
    assert stats["group_bursts"] > 0 and stats["fused_dispatches"] > 0
