"""Live retune in the port's batcher, server and engine, held against the
JAX package on the same numpy-seeded inputs at the tiny 2-layer config
on the CPU.

A retune applies at a poll boundary and the retuned batcher emits what
one booted with the new knobs emits: token equality of the float32
streams, greedy and seeded, with the JAX batcher's tokens for each
request run alone (ROADMAP.md queue C). Censuses, refusals, route
statuses and flight records are compared exactly."""

import importlib.util
import os

import pytest

from _torch_engine import build_app, dispatch, gen_unit, make_model_dir
from _torch_sched import BASE, EagerGraphs, JaxReference, batch, make_models, mixed, port
from seldon_core_tpu.serving.continuous import ContinuousBatcher as JaxBatcher
from seldon_core_tpu.serving.continuous import RetuneError as JaxRetuneError
from seldon_core_tpu_torch.serving.continuous import RetuneError

JAX, PORT = "seldon_core_tpu", "seldon_core_tpu_torch"


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def reference(models):
    ref = JaxReference(models)
    yield ref
    ref.close()


def _run(b, reqs):
    return [b.submit(p, **kw).result(timeout=120) for p, kw in reqs]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_retune_applies_at_poll_boundary_equals_boot(models, reference, temperature):
    """Fused K retuned both ways gives the tokens of a batcher booted with
    the new K, and the JAX batcher's (each request alone)."""
    reqs = batch(temperature)
    want = reference(reqs, fused_steps_per_dispatch=2)
    b = port(models, fused_steps_per_dispatch=8)
    try:
        assert _run(b, reqs) == want
        changed = b.retune(fused_steps_per_dispatch=2).result(timeout=30)
        assert changed == {"fused_steps_per_dispatch": [8, 2]}
        assert b.serving_config()["fused_steps_per_dispatch"] == 2
        assert _run(b, reqs) == want
        assert b.retune(fused_steps_per_dispatch=8).result(timeout=30) == {
            "fused_steps_per_dispatch": [2, 8]}
        assert _run(b, reqs) == want
        assert b.stats["planner_retunes"] == 2
    finally:
        b.close()
    booted = port(models, fused_steps_per_dispatch=2)
    try:
        assert _run(booted, reqs) == want
    finally:
        booted.close()


def test_retune_under_in_flight_traffic(models, reference):
    """Staged while the batch decodes, the retune lands between polls: the
    reference tokens still come out."""
    reqs = batch() + mixed(9, (6, 14, 27))
    b = port(models, fused_steps_per_dispatch=8)
    try:
        futs = [b.submit(p, **kw) for p, kw in reqs]
        assert b.retune(fused_steps_per_dispatch=4).result(timeout=30) in (
            {"fused_steps_per_dispatch": [8, 4]},)
        assert [f.result(timeout=120) for f in futs] == reference(
            reqs, fused_steps_per_dispatch=4)
        assert b.serving_config()["fused_steps_per_dispatch"] == 4
    finally:
        b.close()


def test_retune_fused_off_on_a_fused_member(models, reference):
    """fused 0 on a member booted fused keeps the masked step it captured,
    at the poll burst length: the step-at-a-time tokens, no fused
    dispatch counted after the retune."""
    reqs = batch(0.8) + batch()
    b = port(models, fused_steps_per_dispatch=8)
    try:
        b.retune(fused_steps_per_dispatch=0).result(timeout=30)
        before = b.stats["fused_dispatches"]
        assert _run(b, reqs) == reference(reqs)
        assert b.stats["fused_dispatches"] == before
    finally:
        b.close()


@pytest.fixture()
def _sub_tile_attn_buckets():
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    old = ContinuousBatcher.MIN_ATTN_BUCKET
    ContinuousBatcher.MIN_ATTN_BUCKET = 16
    yield
    ContinuousBatcher.MIN_ATTN_BUCKET = old


def test_retune_groups_chunk_and_depth_without_capture(models, reference,
                                                       _sub_tile_attn_buckets):
    """Depth groups, chunk size, pipeline depth and the cost-model price
    move within the census on a warmed member: the same tokens, and no
    decode graph captured after ``warm()`` (the CPU stand-in records
    every capture)."""
    knobs = dict(fused_steps_per_dispatch=8, depth_groups=4, depth_group_split_bytes=0,
                 attn_bucket=16, prefill_chunk=16)
    reqs = batch() + mixed(4, (5, 20, 30, 9), temperature=0.8)
    want = reference(reqs)
    b = port(models, **knobs)
    b._graphs = EagerGraphs(b)
    try:
        b.warm(prompt_lens=sorted({len(p) for p, _ in reqs}), max_new_tokens=20)
        captured = b.stats["graphs_captured"]
        for step in ({"depth_groups": 1, "prefill_chunk": 0, "pipeline_depth": 1},
                     {"fused_steps_per_dispatch": 2, "depth_group_split_bytes": 1 << 40},
                     {"depth_groups": 2, "prefill_chunk": 16, "pipeline_depth": 3,
                      "fused_steps_per_dispatch": 8, "depth_group_split_bytes": 0}):
            b.retune(origin="test", **step).result(timeout=30)
            # all at once: lanes at mixed depths, so groups can split
            futs = [b.submit(p, **kw) for p, kw in reqs]
            assert [f.result(timeout=120) for f in futs] == want
        assert b.stats["graph_captures_inline"] == 0
        assert b.stats["graphs_captured"] == captured
        assert b.stats["planner_retunes"] == 3
        assert b.stats["group_bursts"] > 0 and b.stats["prefill_chunks"] > 0
    finally:
        b.close()


# -- census and refusals ----------------------------------------------------------

BOOTS = {
    "plain": {},
    "fused": {"fused_steps_per_dispatch": 8},
    "full": {"fused_steps_per_dispatch": 16, "depth_groups": 4, "prefill_chunk": 16,
             "pipeline_depth": 2, "steps_per_poll": 4},
}


@pytest.mark.parametrize("boot", sorted(BOOTS))
def test_census_and_serving_config_equal_jax(models, boot):
    knobs = BOOTS[boot]
    j = JaxBatcher(models[0], models[1], **{**BASE, **knobs})
    p = port(models, **knobs)
    try:
        assert p.retune_census() == j.retune_census()
        assert p.serving_config() == j.serving_config()
        assert p.RETUNABLE_KNOBS == j.RETUNABLE_KNOBS
    finally:
        j.close()
        p.close()


REFUSALS = [
    ("fused", {"fused_steps_per_dispatch": 16}, "census"),
    ("fused", {"depth_groups": 2}, "depth_groups"),
    ("fused", {"prefill_chunk": 16}, "prefill_chunk"),
    ("fused", {"slots": 8}, "knob"),
    ("fused", {}, "no knobs"),
    ("fused", {"pipeline_depth": 4}, "pipeline_depth"),
    ("fused", {"pipeline_depth": 0}, "pipeline_depth"),
    ("fused", {"fused_steps_per_dispatch": "eight"}, "int"),
    ("fused", {"pressure_high": 1.5}, "pressure_high"),
    ("fused", {"pressure_low": 0.95}, "pressure_low"),
    ("plain", {"fused_steps_per_dispatch": 8}, "census"),
    ("full", {"prefill_chunk": 32}, "prefill_chunk"),
    ("full", {"fused_steps_per_dispatch": 2}, "census"),
]


@pytest.mark.parametrize("boot,knobs,match", REFUSALS)
def test_out_of_census_refused_typed_as_jax(models, boot, knobs, match):
    """A value outside the boot census (or an unknown or ill-typed knob)
    is refused with RetuneError before anything is staged, as the JAX
    batcher refuses it."""
    j = JaxBatcher(models[0], models[1], **{**BASE, **BOOTS[boot]})
    p = port(models, **BOOTS[boot])
    try:
        with pytest.raises(JaxRetuneError, match=match):
            j.retune(**knobs)
        with pytest.raises(RetuneError, match=match):
            p.retune(**knobs)
        assert p.stats["planner_retunes"] == 0 and p._pending_retune is None
    finally:
        j.close()
        p.close()


def test_second_retune_while_pending_and_cancel(models):
    """One retune at a time: a second while one is staged is refused; a
    staged one cancels before its poll boundary, its future failing
    typed. The scheduler is held at its first poll meanwhile."""
    import threading

    release = threading.Event()
    p = port(models, fused_steps_per_dispatch=8)
    p.fault_hook = lambda _poll: release.wait(60)
    try:
        fut = p.retune(fused_steps_per_dispatch=4)
        with pytest.raises(RetuneError, match="already pending"):
            p.retune(depth_groups=0)
        assert p.cancel_retune() is True
        with pytest.raises(RetuneError, match="cancelled"):
            fut.result(timeout=5)
        assert p.cancel_retune() is False
        release.set()
        assert p.retune(fused_steps_per_dispatch=2).result(timeout=30) == {
            "fused_steps_per_dispatch": [8, 2]}
        assert p.stats["planner_retunes"] == 1
    finally:
        release.set()
        p.close()


def test_retune_flight_records_render_with_thrash_diagnosis(models):
    """The port's planner_retune records render through the unchanged
    tools/flight_report.py as the JAX batcher's do, revert diagnosed as
    thrash."""
    spec = importlib.util.spec_from_file_location(
        "flight_report", os.path.join(os.path.dirname(__file__), "..", "tools",
                                      "flight_report.py"))
    fr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fr)
    recs = []
    for b in (JaxBatcher(models[0], models[1], **{**BASE, "fused_steps_per_dispatch": 8}),
              port(models, fused_steps_per_dispatch=8)):
        try:
            b.retune(fused_steps_per_dispatch=2).result(timeout=30)
            b.retune(fused_steps_per_dispatch=8).result(timeout=30)
            dump = b.flight.dump()
        finally:
            b.close()
        recs.append([{k: v for k, v in e.items() if k != "t_us"}
                     for e in dump["entries"] if e.get("type") == "planner_retune"])
        text = "\n".join(fr.diagnose(dump))
        assert "planner retunes: 2 applied at poll boundaries" in text
        assert "THRASHING" in text and "fused_steps_per_dispatch" in text
    assert recs[0] == recs[1]


# -- server and engine -------------------------------------------------------------


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_model_dir(tmp_path_factory.mktemp("retune"))


def _fused_unit(model_dir):
    unit = gen_unit(model_dir)
    unit["parameters"] = unit["parameters"] + [
        {"name": "fused_steps_per_dispatch", "value": "8", "type": "INT"}]
    return unit


@pytest.mark.parametrize("body,status", [
    ({}, 400), ({"knobs": {}}, 400), ({"knobs": {"fused_steps_per_dispatch": 64}}, 409),
    ({"knobs": {"slots": 4}}, 409),
    ({"knobs": {"fused_steps_per_dispatch": 4}, "origin": "test"}, 200),
])
def test_engine_retune_route_equals_jax(model_dir, body, status):
    from _torch_engine import close_app

    outs = []
    for pkg in (JAX, PORT):
        app = build_app(pkg, _fused_unit(model_dir))
        rest = app.rest_app()
        try:
            # the unit loads with its first request
            got, _ = dispatch(rest, "/api/v0.1/predictions",
                              {"jsonData": {"prompt_tokens": [5, 17, 42], "max_new_tokens": 3}})
            assert got == 200
            outs.append(dispatch(rest, "/retune", body))
        finally:
            close_app(app)
    assert outs[0][0] == outs[1][0] == status
    if status == 200:
        assert outs[0][1] == outs[1][1]
        assert outs[1][1]["units"]["llm"]["changed"] == {"fused_steps_per_dispatch": [8, 4]}


def test_engine_retune_route_without_a_generate_unit_answers_501():
    for pkg in (JAX, PORT):
        rest = build_app(pkg, {"name": "m", "implementation": "SIMPLE_MODEL"}).rest_app()
        status, out = dispatch(rest, "/retune", {"knobs": {"depth_groups": 0}})
        assert status == 501 and "no unit supports retune" in out["status"]["info"]


def test_server_retune_metrics_and_tokens(model_dir):
    """GenerateServer.retune answers as the JAX server's; the retune is
    counted in metrics() and the engine maps it to
    seldon_engine_planner_retunes; the tokens stay the JAX server's."""
    from seldon_core_tpu.servers.generateserver import GenerateServer as JaxServer
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer

    outs = []
    for cls in (JaxServer, GenerateServer):
        srv = cls(model_uri=model_dir, device="cpu", slots=2, steps_per_poll=2,
                  fused_steps_per_dispatch=8, depth_groups=2)
        srv.load()
        try:
            res = srv.retune({"fused_steps_per_dispatch": 2, "depth_groups": 0}, origin="t")
            with pytest.raises(Exception, match="census"):
                srv.retune({"fused_steps_per_dispatch": 32})
            toks = srv.predict({"prompt_tokens": [[7, 3, 9, 1]], "max_new_tokens": 6}, [])
            metrics = srv.metrics()
            outs.append((res, srv.retune_census(), srv.serving_config(), toks["tokens"]))
        finally:
            srv.batcher.close()
        if cls is GenerateServer:
            reg = MetricsRegistry()
            reg.record_custom(metrics)
            assert reg.counter_total("seldon_engine_planner_retunes") == 1.0
    assert outs[0] == outs[1]
