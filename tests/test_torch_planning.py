"""The port's serving planner (seldon_core_tpu_torch/planning/) held
against the JAX package's on the CPU.

Mirrors tests/test_planning.py (its retune cases are the batcher's, held
in tests/test_torch_retune.py): SPF1 bytes identical for the same
profile and the same typed refusals (``ProfileError`` a subclass of the
port's ``serving/disagg.py`` ``DisaggError``), ``CostModel`` predictions,
rankings and fusion gate equal, ``ServingPlanner`` decisions equal on the
same telemetry sequence, ``TrafficSim`` traces equal from the same seed,
the reconciler's planner actuation (the burn-page veto, the shared
stabilisation streak, the tick) equal, and ``run_sweep`` over the port's
``ContinuousBatcher`` (2-layer float32) giving the JAX sweep's grid and
keys; its timings are not compared.
"""

import asyncio
import dataclasses
import importlib
import json
import struct
import zlib

import pytest

JAX, PORT = "seldon_core_tpu", "seldon_core_tpu_torch"
PKGS = (JAX, PORT)


def m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def P(pkg):
    return m(pkg, "planning")


def run(coro):
    return asyncio.run(coro)


def outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the outcome is the datum
        return ("raise", type(e).__name__, str(e))


def entry(slots=4, fused=0, tps=100.0, ttft=800.0, tpot=50.0,
          hbm=1_000_000_000, chunk=0, dg=0, split=0, kv=0, **extra):
    return {
        "config": {"slots": slots, "prefill_chunk": chunk,
                   "fused_steps_per_dispatch": fused, "depth_groups": dg,
                   "depth_group_split_bytes": split, "kv_tier_bytes": kv},
        "tokens_per_s": tps, "ttft_p50_ms": ttft / 2, "ttft_p99_ms": ttft,
        "tpot_p50_ms": tpot / 2, "tpot_p99_ms": tpot, "hbm_bytes": hbm, **extra,
    }


GRID3 = (
    entry(slots=4, fused=0, tps=100, ttft=800, tpot=50, hbm=10**9),
    entry(slots=4, fused=8, tps=400, ttft=300, tpot=20, hbm=10**9),
    entry(slots=8, fused=8, tps=600, ttft=250, tpot=15, hbm=2 * 10**9),
)
CENSUS = {"fused_ks": (2, 4, 8), "depth_groups": 1, "prefill_chunk": 0, "pipeline_depth": 1}
CONFIG0 = dict(GRID3[0]["config"])


def profile(pkg, *entries, family="tiny"):
    return P(pkg).build_profile(family, json.loads(json.dumps(list(entries))),
                                created="2026-01-01T00:00:00Z")


# -- SPF1 ----------------------------------------------------------------------


def test_spf1_bytes_identical(tmp_path):
    data = {}
    for pkg in PKGS:
        prof = profile(pkg, *GRID3, entry(slots=2, fused=4, compile_census={
            "variants": 2, "compile_s": 1.5}, device_time={"decode": 0.25}))
        data[pkg] = P(pkg).encode_profile(prof)
        path = tmp_path / f"{pkg}.spf1"
        P(pkg).write_profile(str(path), prof)
        assert path.read_bytes() == data[pkg]
        assert P(pkg).read_profile(str(path)) == prof
    assert data[PORT] == data[JAX] and data[PORT][:4] == b"SPF1"
    # each package decodes the other's bytes
    assert P(PORT).decode_profile(data[JAX]) == P(JAX).decode_profile(data[PORT])


def _frame(payload: bytes) -> bytes:
    return b"SPF1" + struct.pack("<II", len(payload), zlib.crc32(payload)) + payload


def _corruptions(data):
    flipped = bytearray(data)
    flipped[20] ^= 0x40
    future = json.loads(data[12:])
    future["v"] = 99
    return {
        "header": data[:8], "cut": data[:-5], "empty": b"", "flip": bytes(flipped),
        "magic": b"XXXX" + data[4:], "version": _frame(json.dumps(future).encode()),
        "not-json": _frame(b"{nope"),
    }


@pytest.mark.parametrize("case", ["header", "cut", "empty", "flip", "magic", "version",
                                  "not-json"])
def test_spf1_corruption_refuses_typed_as_jax(case):
    got = {}
    for pkg in PKGS:
        data = P(pkg).encode_profile(profile(pkg, *GRID3))
        got[pkg] = outcome(P(pkg).decode_profile, _corruptions(data)[case])
    assert got[PORT] == got[JAX] and got[PORT][0] == "raise"
    disagg = m(PORT, "serving.disagg")
    err = getattr(disagg, got[PORT][1], None) or getattr(P(PORT), got[PORT][1])
    assert issubclass(err, disagg.DisaggError)


def test_profile_error_subclasses_the_ports_disagg_error():
    assert issubclass(P(PORT).ProfileError, m(PORT, "serving.disagg").DisaggError)
    assert P(PORT).ProfileError.__mro__[1].__module__ == "seldon_core_tpu_torch.serving.disagg"


def _bad_grids():
    dup = [entry(slots=4), entry(slots=4)]
    neg = entry(slots=4)
    neg["tokens_per_s"] = -1.0
    missing = entry(slots=4)
    del missing["config"]["kv_tier_bytes"]
    return {"empty": [], "dup": dup, "neg": [neg], "missing": [missing]}


@pytest.mark.parametrize("case", ["empty", "dup", "neg", "missing"])
def test_malformed_grid_refuses_as_jax(case):
    got = {pkg: outcome(P(pkg).build_profile, "tiny", _bad_grids()[case]) for pkg in PKGS}
    assert got[PORT] == got[JAX] and got[PORT][1] == "ProfileError"


def test_sweep_grid_equal():
    for kw in ({}, dict(slots=(4, 8), fused_steps=(0, 4, 8)),
               dict(prefill_chunk=(0, 64), depth_groups=(0, 2), kv_tier_bytes=(0, 1 << 20))):
        got = {pkg: P(pkg).sweep_grid(**kw) for pkg in PKGS}
        assert got[PORT] == got[JAX]
    assert P(PORT).CONFIG_KEYS == P(JAX).CONFIG_KEYS


# -- the cost model ------------------------------------------------------------


NOISY = (entry(slots=4, fused=0, tps=100), entry(slots=4, fused=4, tps=300),
         entry(slots=4, fused=8, tps=290), entry(slots=2, fused=0, hbm=3 * 10**9),
         entry(slots=8, fused=8, hbm=2 * 10**9))


@pytest.mark.parametrize("grid", ["grid3", "noisy"])
def test_cost_model_predictions_equal(grid):
    entries = GRID3 if grid == "grid3" else NOISY
    got = {}
    for pkg in PKGS:
        cm = P(pkg).CostModel(profile(pkg, *entries))
        preds = [cm.predict({"slots": s, "fused_steps_per_dispatch": k})
                 for s in (1, 2, 4, 8, 16) for k in (0, 1, 2, 4, 8, 16, 32)]
        prices = [cm.price({"slots": 4, "fused_steps_per_dispatch": k}) for k in (0, 2, 8)]
        gate = cm.fusion_gate(expected_dispatches=1000)
        got[pkg] = json.loads(json.dumps([preds, prices, gate]))
    assert got[PORT] == got[JAX]


@pytest.mark.parametrize("kw", [
    dict(ttft_p99_ms=500, tpot_p99_ms=30),
    dict(ttft_p99_ms=500, tpot_p99_ms=30, require={"slots": 4}),
    dict(ttft_p99_ms=100, tpot_p99_ms=5),
    dict(ttft_p99_ms=500, require={"slots": 99}),
    dict(ttft_p99_ms=500, tpot_p99_ms=30, hbm_budget_bytes=int(1.5 * 10**9)),
])
def test_cost_model_best_equal(kw):
    got = {pkg: outcome(P(pkg).CostModel(profile(pkg, *GRID3)).best, **kw) for pkg in PKGS}
    assert json.loads(json.dumps(got[PORT])) == json.loads(json.dumps(got[JAX]))


def test_fusion_gate_drives_the_ports_segment_check():
    prof = (entry(slots=4, fused=0, tps=100, compile_census={"variants": 2, "compile_s": 4.0}),
            entry(slots=4, fused=8, tps=400, compile_census={"variants": 4, "compile_s": 8.0}))
    worth = m(PORT, "graph.fusion").segment_worth_compiling
    gate = P(PORT).CostModel(profile(PORT, *prof)).fusion_gate(expected_dispatches=1000)
    assert gate == P(JAX).CostModel(profile(JAX, *prof)).fusion_gate(expected_dispatches=1000)
    assert worth(2, dict(gate, expected_dispatches=10**9))
    assert not worth(2, dict(gate, expected_dispatches=1))


# -- the traffic simulator -----------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(seed=7, duration_s=30),
    dict(seed=8, duration_s=30),
    dict(seed=3, duration_s=60, tenants=6, deadline_frac=0.5),
    dict(seed=5, base_rps=40, burst_mult=8, gamma_shape=1.0, duration_s=20),
])
def test_trafficsim_traces_equal(kw):
    got = {}
    for pkg in PKGS:
        sim = P(pkg).TrafficSim(**kw)
        trace = sim.trace()
        got[pkg] = ([dataclasses.asdict(ev) for ev in trace], sim.summary(trace),
                    sim._prefixes, sim.deadline_bounds)
    assert got[PORT] == got[JAX] and len(got[PORT][0]) > 20


def test_trafficsim_replay_equal():
    got = {}
    for pkg in PKGS:
        trace = P(pkg).TrafficSim(seed=9, duration_s=10).trace(max_events=20)
        seen = []
        handles = P(pkg).replay(trace, lambda ev: seen.append(ev) or len(seen))
        clock, slept = {"t": 0.0}, []

        def sleep(d):
            slept.append(d)
            clock["t"] += d

        P(pkg).replay(trace, lambda ev: ev, time_scale=1.0, clock=lambda: clock["t"],
                      sleep=sleep)
        got[pkg] = (handles, [dataclasses.asdict(e) for e in seen], slept)
    assert got[PORT] == got[JAX]


# -- the decision table ----------------------------------------------------------


def warn(slo="ttft_p99", thr=0.5):
    return {"slo": slo, "severity": "warn", "threshold_s": thr}


PLANNER_SEQUENCES = {
    "page-resets-idle": (dict(scale_down_ticks=2), [
        dict(gauges={"device_busy_frac": 0.01}),
        dict(verdicts=[{"slo": "x", "severity": "page"}]),
        dict(gauges={"device_busy_frac": 0.01})]),
    "sustained-pressure": (dict(hot_ticks=2), [
        dict(verdicts=[warn()], counter_totals={"sheds": 5.0, "preemptions": 0.0}),
        dict(verdicts=[warn()], counter_totals={"sheds": 9.0, "preemptions": 1.0})]),
    "warn-retunes": ("model", [
        dict(verdicts=[warn("ttft_p99", 0.5), warn("tpot_p99", 0.03)],
             current_config=CONFIG0, census=CENSUS)]),
    "census-pins": ("dg-model", [
        dict(verdicts=[warn("ttft_p99", 0.5)], current_config=CONFIG0, census=CENSUS)]),
    "unswept-axes": ("model", [
        dict(verdicts=[warn("ttft_p99", 0.5), warn("tpot_p99", 0.03)],
             current_config=dict(CONFIG0, depth_group_split_bytes=69952), census=CENSUS)]),
    "nothing-meets": ("model", [
        dict(verdicts=[warn("ttft_p99", 0.01)], current_config=CONFIG0, census=CENSUS)]),
    "no-model": ({}, [dict(verdicts=[warn()], current_config=CONFIG0)]),
    "quiet-sheds": ({}, [dict(counter_totals={"sheds": 4.0}, gauges={"pressure_high": 0.80}),
                         dict(counter_totals={"sheds": 9.0}, gauges={"pressure_high": 0.94})]),
    "idle-streak": (dict(scale_down_ticks=3), [
        dict(gauges={"device_busy_frac": 0.02})] * 3 + [
        dict(gauges={"device_busy_frac": 0.9}), dict(gauges={"device_busy_frac": 0.02})]),
    "cooldown": ("model-cooldown", [
        dict(verdicts=[warn()], current_config=CONFIG0, census=CENSUS)] * 4),
    "counter-reset": (dict(hot_ticks=1), [
        dict(counter_totals={"sheds": 50.0}),
        dict(verdicts=[warn()], counter_totals={"sheds": 0.0})]),
}


def _planner(pkg, how):
    planning = P(pkg)
    if how == "model":
        return planning.ServingPlanner(cost_model=planning.CostModel(profile(pkg, *GRID3)))
    if how == "model-cooldown":
        return planning.ServingPlanner(cost_model=planning.CostModel(profile(pkg, *GRID3)),
                                       retune_cooldown_ticks=2)
    if how == "dg-model":
        grid = (entry(slots=4, fused=0, tps=100, ttft=800, tpot=50),
                entry(slots=4, fused=8, dg=2, tps=500, ttft=200, tpot=10),
                entry(slots=4, fused=8, tps=400, ttft=300, tpot=20))
        return planning.ServingPlanner(cost_model=planning.CostModel(profile(pkg, *grid)))
    return planning.ServingPlanner(**how)


@pytest.mark.parametrize("name", sorted(PLANNER_SEQUENCES))
def test_planner_decisions_equal(name):
    how, ticks = PLANNER_SEQUENCES[name]
    got = {}
    for pkg in PKGS:
        planner = _planner(pkg, how)
        got[pkg] = [dataclasses.asdict(planner.tick(**json.loads(json.dumps(t))))
                    for t in ticks]
    assert json.loads(json.dumps(got[PORT])) == json.loads(json.dumps(got[JAX]))


def test_retunable_axes_equal():
    assert P(PORT).RETUNABLE_AXES == P(JAX).RETUNABLE_AXES


# -- the reconciler's actuation site --------------------------------------------


def make_controller(pkg):
    cp = m(pkg, "controlplane")
    store = cp.ResourceStore()
    ctl = cp.DeploymentController(
        store, runtime=m(pkg, "controlplane.runtime").InProcessRuntime(open_ports=False))
    dep, _ = store.apply(cp.SeldonDeployment.from_dict({
        "name": "gdep", "predictors": [{
            "name": "p0", "replicas": 2, "annotations": {"seldon.io/planner": "true"},
            "graph": {"name": "g", "implementation": "GENERATE_SERVER"}}]}))
    return store, ctl, dep


ACTUATIONS = {
    "veto": ("page", 2, ("scale_down", "idle", 6)),
    "scale-up-resets-streak": (None, 2, ("scale_up", "warn burn", 4)),
    "scale-down-quiet": (None, 0, ("scale_down", "idle", 6)),
    "hold": (None, 1, ("hold", "quiet", 0)),
}


@pytest.mark.parametrize("name", sorted(ACTUATIONS))
def test_planner_actuation_equal(name):
    burn, streak, (action, reason, rank) = ACTUATIONS[name]
    got = {}
    for pkg in PKGS:
        store, ctl, dep = make_controller(pkg)
        if burn:
            ctl._burn_verdicts[(dep.key, "p0")] = [{"slo": "ttft_p99", "severity": burn}]
        if streak:
            ctl._scale_down_streak[(dep.key, "p0")] = streak
        decision = P(pkg).Decision(action, reason, rank=rank)
        out = run(ctl._planner_actuate(dep, dep.predictors[0], decision))
        got[pkg] = (out, dict(ctl.planner_stats), store.get("gdep").predictors[0].replicas,
                    (dep.key, "p0") in ctl._scale_down_streak)
    assert got[PORT] == got[JAX]


def test_planner_tick_once_closes_the_loop_on_page():
    got = {}
    for pkg in PKGS:
        store, ctl, dep = make_controller(pkg)
        ctl._burn_verdicts[(dep.key, "p0")] = [{"slo": "tpot_p99", "severity": "page"}]
        first = run(ctl.planner_tick_once())
        replicas = store.get("gdep").predictors[0].replicas
        dep2 = store.get("gdep").clone()
        dep2.predictors[0].annotations = {}
        store.apply(dep2)
        second = run(ctl.planner_tick_once())
        got[pkg] = (first, replicas, second, ctl._planners)
    assert got[PORT] == got[JAX]
    assert got[PORT][0]["default/gdep/p0"]["action"] == "scale_up" and got[PORT][1] == 3


def test_planner_corrupt_profile_runs_model_less(tmp_path):
    got = {}
    for pkg in PKGS:
        store, ctl, dep = make_controller(pkg)
        bad = tmp_path / f"{pkg}-bad.spf1"
        bad.write_bytes(b"SPF1garbage")
        good = tmp_path / f"{pkg}-good.spf1"
        P(pkg).write_profile(str(good), profile(pkg, *GRID3))
        a = ctl._planner_for((dep.key, "p0"), {"enabled": True, "profile": str(bad)})
        b = ctl._planner_for(("default/other", "p0"), {"enabled": True, "profile": str(good)})
        got[pkg] = (a.cost_model is None, a.scale_down_ticks == ctl.scale_down_ticks,
                    b.cost_model is not None)
    assert got[PORT] == got[JAX] == (True, True, True)


# -- the sweep over a live batcher -----------------------------------------------


def test_run_sweep_over_the_ports_batcher():
    """The same seeded trace through each package's batcher: the port's
    profile has the JAX sweep's grid (configs in order) and keys, every
    point measured real tokens, and it encodes as SPF1."""
    import jax
    import numpy as np

    from seldon_core_tpu.models.llm import DecoderLM as JaxLM
    from seldon_core_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
    from seldon_core_tpu_torch.convert import params_from_numpy
    from seldon_core_tpu_torch.models.llm import DecoderLM as TorchLM
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    cfg = dict(vocab_size=256, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
               max_seq=64, dtype="float32")
    jm = JaxLM(**cfg)
    jp = jax.jit(jm.init_params)(0)
    tm = TorchLM(**cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    base = dict(max_seq=64, prefill_buckets=(8, 16, 32), steps_per_poll=2)

    def factory(pkg):
        def build(config):
            kw = dict(base, slots=config["slots"],
                      fused_steps_per_dispatch=config["fused_steps_per_dispatch"],
                      prefill_chunk=config["prefill_chunk"])
            if pkg == PORT:
                return ContinuousBatcher(tm, tp, **kw)
            return JaxBatcher(jm, jp, **kw)
        return build

    got = {}
    for pkg in PKGS:
        sim = P(pkg).TrafficSim(seed=42, duration_s=8, base_rps=4, tenants=3,
                                prompt_families=4, prefix_len=8, suffix_len=(2, 10),
                                vocab=256, max_new_tokens=(4, 12), deadline_s=(2.0, 10.0),
                                deadline_frac=0.3)
        grid = P(pkg).sweep_grid(slots=(2,), fused_steps=(0, 8), prefill_chunk=(0, 8))
        got[pkg] = P(pkg).run_sweep(factory(pkg), grid, sim, model_family="llm-tiny",
                                    max_events=8, created="2026-01-01T00:00:00Z")
    port, ref = got[PORT], got[JAX]
    assert [e["config"] for e in port["grid"]] == [e["config"] for e in ref["grid"]]
    assert [sorted(e) for e in port["grid"]] == [sorted(e) for e in ref["grid"]]
    assert sorted(port) == sorted(ref)
    assert [e["compile_census"]["variants"] for e in port["grid"]] == \
        [e["compile_census"]["variants"] for e in ref["grid"]]
    assert [e["hbm_bytes"] for e in port["grid"]] == [e["hbm_bytes"] for e in ref["grid"]]
    assert all(e["tokens_per_s"] > 0 and e["requests"] + e["shed"] == 8 for e in port["grid"])
    assert P(PORT).decode_profile(P(PORT).encode_profile(port)) == port
