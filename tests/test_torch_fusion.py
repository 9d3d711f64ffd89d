"""Graph fusion of seldon_core_tpu_torch (graph/fusion.py): a segment of
in-process TorchComponents run as one device hop, on the CPU.

The cases of the JAX package's tests/test_fusion.py on the port's
engine: (1) byte-identity: a fused segment's response (tensor payload,
names, tags, requestPath) is identical to the hop-by-hop walk's, chain
and combiner fan-in alike, the RAG greedy-generate tail included; (2)
per-unit semantics are never hidden: a remote client, fault injector,
micro-batcher, open breaker, deadline budget, live shadow mirror or a
non-tensor body forces a counted, logged fallback to the per-unit path;
(3) one fused segment is ONE device hop: a single ``gen.fused_segment``
span replaces the N per-stage spans. Then the port's fused RAG graph
against the JAX package's fused RAG graph on the same weights and
requests (float32): equal greedy tokens and meta.
"""

import asyncio
import json
import os
import time

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.graph import GraphExecutor, PredictorSpec
from seldon_core_tpu_torch.graph.client import UnitCallError
from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
from seldon_core_tpu_torch.graph.spec import (
    GraphSpecError,
    default_predictor,
    parse_fuse_annotation,
)
from seldon_core_tpu_torch.user_model import TorchComponent, TorchTransformComponent

torch.set_num_threads(1)

FUSE_ANN = {"seldon.io/fuse": "true"}


def run(coro):
    return asyncio.run(coro)


def _matmul(p, x):
    """``x @ p`` with numpy's type promotion (bf16 @ f32 is f32), as the
    JAX stage computes it."""
    dt = torch.promote_types(x.dtype, p.dtype)
    return x.to(dt) @ p.to(dt)


class MatMul(TorchComponent):
    """Tiny stage: x @ W, with a distinguishable W per instance."""

    warmup_shape = (4,)

    def __init__(self, scale=0.1, out=4, device="cpu"):
        super().__init__(device=device)
        self._scale = scale
        self._out = out

    def build(self):
        w = (torch.arange(4 * self._out, dtype=torch.float32)
             .reshape(4, self._out) * self._scale)
        return _matmul, w


class MatMulTransform(TorchTransformComponent, MatMul):
    pass


def make_executor(graph, registry, fuse=True, annotations=None,
                  metrics=None, faults=None):
    ann = dict(FUSE_ANN) if fuse else {}
    ann.update(annotations or {})
    spec = default_predictor(PredictorSpec.from_dict({
        "name": "p",
        **({"annotations": ann} if ann else {}),
        "graph": json.loads(json.dumps(graph)),
    }))
    return GraphExecutor(spec, registry=registry, metrics=metrics, faults=faults)


def chain_graph(*names, types=None):
    node = None
    for name in reversed(names):
        t = (types or {}).get(name, "MODEL")
        node = {"name": name, "type": t, **({"children": [node]} if node else {})}
    return node


def strip_puid(out):
    out = json.loads(json.dumps(out))
    out.get("meta", {}).pop("puid", None)
    return out


@pytest.fixture()
def loaded_pair():
    a, b = MatMul(0.1), MatMul(0.3, out=3)
    a.load()
    b.load()
    return a, b


REQ = {"data": {"ndarray": [[1.0, 2.0, 3.0, 4.0]]}}


# -- planning ----------------------------------------------------------------


def test_plans_model_chain_segment(loaded_pair):
    a, b = loaded_pair
    ex = make_executor(chain_graph("a", "b"), {"a": a, "b": b})
    assert set(ex.fusion.segments) == {"a"}
    seg = ex.fusion.segments["a"]
    assert seg.names == ["a", "b"] and seg.kind == "subtree"


def test_fusion_off_by_default(loaded_pair):
    a, b = loaded_pair
    ex = make_executor(chain_graph("a", "b"), {"a": a, "b": b}, fuse=False)
    assert ex.fusion is None


def test_parse_fuse_annotation_strict():
    spec = default_predictor(PredictorSpec.from_dict({
        "name": "p", "annotations": {"seldon.io/fuse": "tru"},
        "graph": {"name": "m", "type": "MODEL"},
    }))
    with pytest.raises(GraphSpecError, match="seldon.io/fuse"):
        parse_fuse_annotation(spec)
    spec.annotations["seldon.io/fuse"] = "TRUE"
    assert parse_fuse_annotation(spec) is True
    spec.annotations.pop("seldon.io/fuse")
    assert parse_fuse_annotation(spec) is False


def test_remote_unit_is_counted_plan_fallback(loaded_pair):
    """A remote hop in the middle keeps everything per-unit: the chain
    around it is too short to fuse, and the exclusion is counted."""
    a, b = loaded_pair
    graph = {
        "name": "a", "type": "MODEL", "children": [{
            "name": "r", "type": "MODEL",
            "endpoint": {"service_host": "127.0.0.1", "service_port": 19987,
                         "transport": "REST"},
            "children": [{"name": "b", "type": "MODEL"}],
        }],
    }
    reg = MetricsRegistry()
    ex = make_executor(graph, {"a": a, "b": b}, metrics=reg)
    assert not ex.fusion.segments
    assert reg.counter_total(
        "seldon_engine_fusion_fallbacks", {"unit": "r", "reason": "remote"}
    ) == 1.0


def test_fault_injected_unit_is_counted_plan_fallback(loaded_pair):
    from seldon_core_tpu_torch.resilience import FaultInjector

    a, b = loaded_pair
    reg = MetricsRegistry()
    faults = FaultInjector([{"unit": "b", "latency_ms": 1}])
    ex = make_executor(chain_graph("a", "b"), {"a": a, "b": b},
                       metrics=reg, faults=faults)
    assert not ex.fusion.segments
    assert reg.counter_total(
        "seldon_engine_fusion_fallbacks", {"unit": "b", "reason": "faults"}
    ) == 1.0


def test_microbatched_unit_not_fused(loaded_pair):
    a, b = loaded_pair
    spec = default_predictor(PredictorSpec.from_dict({
        "name": "p", "annotations": dict(FUSE_ANN),
        "graph": chain_graph("a", "b"),
    }))
    reg = MetricsRegistry()
    ex = GraphExecutor(spec, registry={"a": a, "b": b}, metrics=reg,
                       batching={"b": {"max_batch": 4}})
    assert not ex.fusion.segments
    assert reg.counter_total(
        "seldon_engine_fusion_fallbacks", {"unit": "b", "reason": "microbatch"},
    ) == 1.0


def test_bare_torchcomponent_on_transformer_node_not_fused(loaded_pair):
    """A bare TorchComponent's transform hooks degrade to identity:
    fusing its forward on a TRANSFORMER node would CHANGE the output."""
    a, b = loaded_pair
    ex = make_executor(
        chain_graph("a", "b", types={"a": "TRANSFORMER"}), {"a": a, "b": b}
    )
    assert not ex.fusion.segments


def test_transform_component_chain_fuses_with_output_transformer():
    """TRANSFORMER -> MODEL -> OUTPUT_TRANSFORMER, all forward-backed: one
    subtree segment whose execution order is in, model, out."""
    t_in, model, t_out = MatMulTransform(0.1), MatMul(0.2), MatMulTransform(0.3)
    for c in (t_in, model, t_out):
        c.load()
    graph = {
        "name": "out", "type": "OUTPUT_TRANSFORMER", "children": [{
            "name": "in", "type": "TRANSFORMER",
            "children": [{"name": "model", "type": "MODEL"}],
        }],
    }
    reg = {"in": t_in, "model": model, "out": t_out}
    ex_f = make_executor(graph, reg)
    ex_h = make_executor(graph, reg, fuse=False)
    seg = ex_f.fusion.segments["out"]
    assert [s.name for s in seg.stages] == ["in", "model", "out"]
    of = strip_puid(run(ex_f.predict(dict(REQ))))
    oh = strip_puid(run(ex_h.predict(dict(REQ))))
    assert of == oh
    assert seg.dispatches == 1


# -- byte-identity -----------------------------------------------------------


def test_chain_byte_identity_with_tags_and_request_path(loaded_pair):
    a, b = loaded_pair
    ex_f = make_executor(chain_graph("a", "b"), {"a": a, "b": b})
    ex_h = make_executor(chain_graph("a", "b"), {"a": a, "b": b}, fuse=False)
    of = strip_puid(run(ex_f.predict(dict(REQ))))
    oh = strip_puid(run(ex_h.predict(dict(REQ))))
    assert of == oh
    assert list(of["meta"]["requestPath"]) == ["a", "b"]


def test_combiner_fanin_fuses_and_matches_hop_by_hop():
    """AVERAGE_COMBINER over two IDENTICAL children (the mean is then
    exact at every precision: the fused f32 mean and the host f64 mean
    agree bitwise)."""
    m1, m2 = MatMul(0.25), MatMul(0.25)
    m1.load()
    m2.load()
    graph = {
        "name": "comb", "implementation": "AVERAGE_COMBINER",
        "children": [
            {"name": "m1", "type": "MODEL"},
            {"name": "m2", "type": "MODEL"},
        ],
    }
    reg = {"m1": m1, "m2": m2}
    ex_f = make_executor(graph, reg)
    ex_h = make_executor(graph, reg, fuse=False)
    seg = ex_f.fusion.segments["comb"]
    assert seg.kind == "subtree"
    assert [s.name for s in seg.stages] == ["m1", "m2", "comb"]
    of = strip_puid(run(ex_f.predict(dict(REQ))))
    oh = strip_puid(run(ex_h.predict(dict(REQ))))
    assert of == oh
    assert seg.dispatches == 1


def test_fused_segment_is_one_span_with_stage_names(loaded_pair):
    from seldon_core_tpu_torch import tracing

    a, b = loaded_pair
    tracer = tracing.init_tracer(enabled=True)
    try:
        ex_f = make_executor(chain_graph("a", "b"), {"a": a, "b": b})
        run(ex_f.predict(dict(REQ)))
        ops = [s.operation for s in tracer.finished_spans()]
        assert "gen.fused_segment" in ops
        # the N per-stage dispatch spans are GONE: one hop
        assert "a.predict" not in ops and "b.predict" not in ops
        fused = next(s for s in tracer.finished_spans()
                     if s.operation == "gen.fused_segment")
        assert fused.tags["units"] == "a,b"
        assert fused.tags["stages"] == 2 and fused.tags["kind"] == "subtree"
        ex_h = make_executor(chain_graph("a", "b"), {"a": a, "b": b}, fuse=False)
        run(ex_h.predict(dict(REQ)))
        ops = [s.operation for s in tracer.finished_spans()]
        assert "a.predict" in ops and "b.predict" in ops
    finally:
        tracing.init_tracer(enabled=False)


# -- dynamic fallbacks -------------------------------------------------------


def test_deadline_request_falls_back_counted(loaded_pair):
    from seldon_core_tpu_torch.resilience import Deadline

    a, b = loaded_pair
    reg = MetricsRegistry()
    ex_f = make_executor(chain_graph("a", "b"), {"a": a, "b": b}, metrics=reg)
    ex_h = make_executor(chain_graph("a", "b"), {"a": a, "b": b}, fuse=False)
    of = strip_puid(run(ex_f.predict(dict(REQ), deadline=Deadline(30_000))))
    oh = strip_puid(run(ex_h.predict(dict(REQ), deadline=Deadline(30_000))))
    assert of == oh
    seg = ex_f.fusion.segments["a"]
    assert seg.dispatches == 0 and seg.fallbacks == {"deadline": 1}
    assert reg.counter_total(
        "seldon_engine_fusion_fallbacks", {"unit": "a|b", "reason": "deadline"},
    ) == 1.0


def test_open_breaker_on_interior_unit_forces_fallback(loaded_pair):
    """With the breaker CLOSED the segment fuses; the moment it is not,
    every request takes the per-unit path where the breaker's own refusal
    applies: fused and unfused engines stay identical on both sides of
    the transition."""
    from seldon_core_tpu_torch.resilience.breaker import OPEN

    a, b = loaded_pair
    ann = {"seldon.io/breaker.b": "true"}
    reg_f, reg_h = MetricsRegistry(), MetricsRegistry()
    ex_f = make_executor(chain_graph("a", "b"), {"a": a, "b": b},
                         annotations=ann, metrics=reg_f)
    ex_h = make_executor(chain_graph("a", "b"), {"a": a, "b": b},
                         annotations=ann, fuse=False, metrics=reg_h)
    seg = ex_f.fusion.segments["a"]
    assert [s.name for s in seg.stages] == ["a", "b"]
    assert strip_puid(run(ex_f.predict(dict(REQ)))) == strip_puid(
        run(ex_h.predict(dict(REQ)))
    )
    assert seg.dispatches == 1

    def force_open(ex):
        rc = ex.root.children[0].client  # ResilientClient around b
        rc.breaker.state = OPEN
        rc.breaker._opened_at = time.monotonic()

    force_open(ex_f)
    force_open(ex_h)
    with pytest.raises(UnitCallError) as ef:
        run(ex_f.predict(dict(REQ)))
    with pytest.raises(UnitCallError) as eh:
        run(ex_h.predict(dict(REQ)))
    assert ef.value.status == eh.value.status == 503
    assert seg.fallbacks == {"breaker_open": 1}
    assert reg_f.counter_total(
        "seldon_engine_fusion_fallbacks", {"unit": "a|b", "reason": "breaker_open"},
    ) == 1.0


def test_shadow_mirror_active_forces_fallback(loaded_pair):
    a, b = loaded_pair
    ex_f = make_executor(chain_graph("a", "b"), {"a": a, "b": b})
    ex_h = make_executor(chain_graph("a", "b"), {"a": a, "b": b}, fuse=False)
    mirror_on = [True]
    ex_f.shadow_active_fn = lambda: mirror_on[0]
    of = strip_puid(run(ex_f.predict(dict(REQ))))
    oh = strip_puid(run(ex_h.predict(dict(REQ))))
    assert of == oh
    seg = ex_f.fusion.segments["a"]
    assert seg.dispatches == 0 and seg.fallbacks == {"shadow": 1}
    # shadow unwired (rollout terminal): fusion resumes
    mirror_on[0] = False
    assert strip_puid(run(ex_f.predict(dict(REQ)))) == oh
    assert seg.dispatches == 1


def test_engine_app_wires_shadow_inhibit(loaded_pair):
    from seldon_core_tpu_torch.graph.service import EngineApp

    a, b = loaded_pair
    spec = default_predictor(PredictorSpec.from_dict({
        "name": "p", "annotations": dict(FUSE_ANN),
        "graph": chain_graph("a", "b"),
    }))
    app = EngineApp(spec, registry={"a": a, "b": b}, metrics=MetricsRegistry())
    assert app.executor.shadow_active_fn() is False
    app.shadow_mirror = object()
    assert app.executor.shadow_active_fn() is True


def test_fused_dispatch_error_falls_back_to_per_unit_path(loaded_pair):
    a, b = loaded_pair
    ex_f = make_executor(chain_graph("a", "b"), {"a": a, "b": b})
    ex_h = make_executor(chain_graph("a", "b"), {"a": a, "b": b}, fuse=False)
    seg = ex_f.fusion.segments["a"]

    def boom(_params, _x):
        raise RuntimeError("device exploded")

    seg._fn = boom
    of = strip_puid(run(ex_f.predict(dict(REQ))))
    oh = strip_puid(run(ex_h.predict(dict(REQ))))
    assert of == oh  # the hop path served the request
    assert seg.fallbacks == {"error": 1} and seg.dispatches == 0


def test_non_tensor_payload_falls_back(loaded_pair):
    a, b = loaded_pair
    ex_f = make_executor(chain_graph("a", "b"), {"a": a, "b": b})
    seg = ex_f.fusion.segments["a"]
    with pytest.raises(Exception):
        run(ex_f.predict({"strData": "not a tensor"}))
    assert seg.fallbacks == {"payload": 1}


@pytest.mark.parametrize("gate,fused", [
    ({"dispatch_floor_us": 50, "compile_cost_s": 10, "expected_dispatches": 1000}, False),
    ({"dispatch_floor_us": 50, "compile_cost_s": 0.01, "expected_dispatches": 1000}, True),
    ({"compile_cost_s": 10}, True),  # unpriced: gates nothing
])
def test_cost_gate_prunes_counted(loaded_pair, monkeypatch, gate, fused):
    """A segment whose dispatch savings ((stages - 1) floors x expected
    dispatches) are below the gate's build cost serves hop-by-hop,
    counted as reason "cost" with a ``fusion_skipped`` record; the gate
    comes from ``SELDON_FUSION_COST_GATE`` when none is passed."""
    from seldon_core_tpu_torch.graph.fusion import segment_worth_compiling

    a, b = loaded_pair
    assert segment_worth_compiling(2, gate) is fused
    monkeypatch.setenv("SELDON_FUSION_COST_GATE", json.dumps(gate))
    reg = MetricsRegistry()
    ex = make_executor(chain_graph("a", "b"), {"a": a, "b": b}, metrics=reg)
    assert (set(ex.fusion.segments) == {"a"}) is fused
    skipped = reg.counter_total("seldon_engine_fusion_skipped", {"unit": "a", "reason": "cost"})
    assert skipped == (0.0 if fused else 1.0)
    recs = [e["type"] for e in ex.fusion.dump()["entries"]]
    assert ("fusion_skipped" in recs) is not fused
    out = strip_puid(run(ex.predict(dict(REQ))))
    ex_h = make_executor(chain_graph("a", "b"), {"a": a, "b": b}, fuse=False)
    assert out == strip_puid(run(ex_h.predict(dict(REQ))))


# -- observability -----------------------------------------------------------


def test_fused_segments_metric_and_flight_dump(loaded_pair):
    a, b = loaded_pair
    reg = MetricsRegistry()
    ex = make_executor(chain_graph("a", "b"), {"a": a, "b": b}, metrics=reg)
    run(ex.predict(dict(REQ)))
    run(ex.predict(dict(REQ)))
    assert reg.counter_total("seldon_engine_fused_segments", {"unit": "a|b"}) == 2.0
    dump = ex.fusion.dump()
    assert dump["segments"]["a"]["dispatches"] == 2
    assert dump["segments"]["a"]["stages"] == ["a", "b"]
    recs = [e for e in dump["entries"] if e["type"] == "fused_dispatch"]
    assert len(recs) == 2 and recs[0]["stages"] == 2
    assert "seldon_engine_fused_segments" in reg.expose()


def test_flightrecorder_route_serves_fusion_dump(loaded_pair, rest_client):
    from seldon_core_tpu_torch.graph.service import EngineApp

    a, b = loaded_pair
    spec = default_predictor(PredictorSpec.from_dict({
        "name": "p", "annotations": dict(FUSE_ANN),
        "graph": chain_graph("a", "b"),
    }))
    app = EngineApp(spec, registry={"a": a, "b": b}, metrics=MetricsRegistry())
    run(app.predict(dict(REQ)))
    client = rest_client(app.rest_app())
    status, body = client.call("/flightrecorder", method="GET")
    assert status == 200
    assert "(fusion)" in body["units"]
    assert body["units"]["(fusion)"]["segments"]["a"]["dispatches"] == 1


# -- the RAG graph -----------------------------------------------------------


RAG_E, RAG_K, RAG_L, RAG_V = 16, 4, 6, 256
RAG_BERT = {"vocab_size": RAG_V, "d_model": 32, "n_layers": 2, "n_heads": 2,
            "d_ff": 64, "max_seq": 32, "num_classes": RAG_E}
RAG_RET = {"corpus_size": 64, "d_embed": RAG_E, "top_k": RAG_K, "doc_len": RAG_L,
           "vocab_size": RAG_V, "seed": 7}
RAG_LLM = {"vocab_size": RAG_V, "d_model": 32, "n_layers": 2, "n_heads": 2,
           "n_kv_heads": 2, "d_ff": 64, "max_seq": 32}


def _write_model(root, family, cfg, checkpoint=None):
    d = os.path.join(root, family)
    os.makedirs(d, exist_ok=True)
    if checkpoint is not None:
        from seldon_core_tpu_torch.convert import save_npz

        save_npz(checkpoint, os.path.join(d, "params.npz"))
    with open(os.path.join(d, "jax_config.json"), "w") as f:
        json.dump({"family": family, "config": cfg,
                   **({"checkpoint": "params.npz"} if checkpoint is not None else {})}, f)
    return d


def _rag_components(root, dtype=None, checkpoints=None):
    """The five units of the RAG graph on the CPU; ``checkpoints`` maps a
    family to the numpy params its port unit loads."""
    from seldon_core_tpu_torch.graph.units import RagPromptBuilder
    from seldon_core_tpu_torch.servers.generateserver import GenerateServer
    from seldon_core_tpu_torch.servers.torchserver import TorchServer

    checkpoints = checkpoints or {}
    extra = {"dtype": dtype} if dtype else {}

    def unit(family, cfg):
        return TorchServer(model_uri=_write_model(
            root, family, {**cfg, **extra}, checkpoints.get(family)), device="cpu")

    comps = {"embed": unit("bert", RAG_BERT), "retrieve": unit("retrieval", RAG_RET),
             "rerank": unit("reranker", RAG_RET)}
    for c in comps.values():
        c.load()
    gen = GenerateServer(
        model_uri=_write_model(root, "llm", {**RAG_LLM, **extra}, checkpoints.get("llm")),
        device="cpu", slots=2, steps_per_poll=1, warmup_prompt_lens=[RAG_L],
        warmup_max_new_tokens=8,
    )
    gen.load()
    comps.update(prompt=RagPromptBuilder(max_new_tokens=8), generate=gen)
    return comps


@pytest.fixture(scope="module")
def rag_components(tmp_path_factory):
    comps = _rag_components(str(tmp_path_factory.mktemp("rag-models")))
    yield comps
    comps["generate"].close()


RAG_GRAPH = {
    "name": "embed", "type": "MODEL", "children": [{
        "name": "retrieve", "type": "MODEL", "children": [{
            "name": "rerank", "type": "MODEL", "children": [{
                "name": "prompt", "implementation": "RAG_PROMPT_BUILDER",
                "children": [{"name": "generate", "type": "MODEL"}],
            }],
        }],
    }],
}


def _rag_request(n=2, seed=0):
    rs = np.random.RandomState(seed)
    return {"data": {"ndarray": rs.randint(1, RAG_V, (n, 8)).tolist()}}


def _drop_timers(out):
    """TIMER metrics are wall-clock telemetry; every other byte of the
    response (tokens, tags, requestPath, counters) is data."""
    out["meta"]["metrics"] = [
        m for m in out["meta"].get("metrics", []) if m.get("type") != "TIMER"
    ]
    return out


def test_rag_graph_fused_vs_hop_byte_identity(rag_components):
    """embed -> retrieve -> rerank fuses into one device hop (a prefix
    segment continuing at the prompt builder), the greedy generate tail
    included in the comparison; token output and meta identical."""
    ex_f = make_executor(RAG_GRAPH, rag_components)
    ex_h = make_executor(RAG_GRAPH, rag_components, fuse=False)
    seg = ex_f.fusion.segments["embed"]
    assert seg.kind == "prefix"
    assert seg.names == ["embed", "retrieve", "rerank"]
    assert seg.continue_at.name == "prompt"
    for seed in range(3):
        of = _drop_timers(strip_puid(run(ex_f.predict(_rag_request(seed=seed)))))
        oh = _drop_timers(strip_puid(run(ex_h.predict(_rag_request(seed=seed)))))
        assert of == oh
        assert of["jsonData"]["tokens"]  # the greedy tail actually ran
        assert list(of["meta"]["requestPath"]) == [
            "embed", "retrieve", "rerank", "prompt", "generate",
        ]
    assert seg.dispatches == 3 and seg.fallbacks == {}


def test_rag_retrieval_families_corpus_contract():
    """retrieval + reranker configured alike serve the SAME corpus; a
    corpus past the bf16-exact integer range is refused at build."""
    from seldon_core_tpu_torch.models.retrieval import (
        Reranker,
        RetrievalIndex,
        corpus_params,
    )

    emb1, docs1 = corpus_params(3, 32, 8, 5, 100, device="cpu")
    emb2, docs2 = corpus_params(3, 32, 8, 5, 100, device="cpu")
    assert torch.equal(emb1, emb2) and torch.equal(docs1, docs2)
    assert int(docs1.min()) >= 1  # 0 stays PAD
    ri = RetrievalIndex(corpus_size=32, d_embed=8, doc_len=5, vocab_size=100, seed=3)
    rr = Reranker(corpus_size=32, d_embed=8, doc_len=5, vocab_size=100, seed=3)
    assert torch.equal(ri.init_params(device="cpu")["emb"],
                       rr.init_params(device="cpu")["emb"])
    with pytest.raises(ValueError, match="corpus_size"):
        RetrievalIndex(corpus_size=512, d_embed=8)
    with pytest.raises(ValueError, match="corpus_size"):
        Reranker(corpus_size=512, d_embed=8)
    with pytest.raises(ValueError, match="top_k"):
        RetrievalIndex(corpus_size=4, top_k=8)


def test_rag_prompt_builder_bridges_tensor_to_generate_body():
    from seldon_core_tpu_torch.graph.units import RagPromptBuilder

    pb = RagPromptBuilder(max_new_tokens="12", temperature="0.5", seed="3", eos_id="7")
    body = pb.transform_input(np.array([[5, 6, 7], [8, 9, 10]]), [])
    assert body == {
        "prompt_tokens": [[5, 6, 7], [8, 9, 10]],
        "max_new_tokens": 12, "temperature": 0.5, "seed": 3, "eos_id": 7,
    }
    with pytest.raises(ValueError, match="doc_len"):
        pb.transform_input(np.array([1, 2, 3]), [])


class Bf16MatMul(TorchComponent):
    """Stage whose OUTPUT stays bfloat16: the hop-by-hop walk then flips
    the wire encoding to 'raw' at this hop, and raw is sticky."""

    warmup_shape = (4,)

    def __init__(self, device="cpu"):
        super().__init__(device=device)

    def build(self):
        return _matmul, torch.full((4, 4), 0.5, dtype=torch.bfloat16)


def test_bf16_intermediate_keeps_sticky_raw_encoding():
    """An extended-dtype intermediate forces the unfused walk onto the
    raw wire encoding for every later hop; the fused response must mirror
    that, or fused-vs-unfused responses differ in shape."""
    from seldon_core_tpu_torch.payload import jsonable

    a, b = Bf16MatMul(), MatMul(0.3, out=3)
    a.load()
    b.load()
    ex_f = make_executor(chain_graph("a", "b"), {"a": a, "b": b})
    ex_h = make_executor(chain_graph("a", "b"), {"a": a, "b": b}, fuse=False)
    assert ex_f.fusion.segments["a"]._forces_raw is True
    of = strip_puid(jsonable(run(ex_f.predict(dict(REQ)))))
    oh = strip_puid(jsonable(run(ex_h.predict(dict(REQ)))))
    assert "raw" in oh["data"]  # the hop path really did go raw
    assert of == oh


class NoWarmupBf16(Bf16MatMul):
    """bf16-emitting stage that declares NO warmup shape: the encoding
    probe cannot run at warm and must run on the first dispatch."""

    warmup_shape = None


def test_no_warmup_shape_probes_encoding_on_first_dispatch():
    from seldon_core_tpu_torch.payload import jsonable

    a, b = NoWarmupBf16(), MatMul(0.3, out=3)
    a.load()
    b.load()
    ex_f = make_executor(chain_graph("a", "b"), {"a": a, "b": b})
    ex_h = make_executor(chain_graph("a", "b"), {"a": a, "b": b}, fuse=False)
    seg = ex_f.fusion.segments["a"]
    assert seg._probed is False  # warm had nothing to probe with
    of = strip_puid(jsonable(run(ex_f.predict(dict(REQ)))))
    oh = strip_puid(jsonable(run(ex_h.predict(dict(REQ)))))
    assert seg._probed is True and seg._forces_raw is True
    assert "raw" in oh["data"]
    assert of == oh


def test_tensorless_data_body_counts_payload_not_error(loaded_pair):
    a, b = loaded_pair
    ex_f = make_executor(chain_graph("a", "b"), {"a": a, "b": b})
    seg = ex_f.fusion.segments["a"]
    with pytest.raises(Exception):
        run(ex_f.predict({"data": {"names": ["x"]}}))
    assert seg.fallbacks == {"payload": 1}


def test_executor_rejects_junk_fuse_annotation(loaded_pair):
    """The executor parses seldon.io/fuse with the SAME strict parser
    admission uses: a typo'd value fails construction instead of
    silently serving hop-by-hop."""
    a, b = loaded_pair
    with pytest.raises(GraphSpecError, match="seldon.io/fuse"):
        make_executor(chain_graph("a", "b"), {"a": a, "b": b}, fuse=False,
                      annotations={"seldon.io/fuse": "yes"})


# -- the port against the JAX package ----------------------------------------


def test_rag_graph_fused_equals_jax_fused(tmp_path):
    """The JAX package's fused RAG graph and the port's, float32, the
    port's units loading the JAX units' parameters: the same greedy
    tokens and meta per request, and both served by their fused
    segment."""
    import jax

    from seldon_core_tpu.graph import GraphExecutor as JaxExecutor
    from seldon_core_tpu.graph import PredictorSpec as JaxSpec
    from seldon_core_tpu.graph.spec import default_predictor as jax_default
    from seldon_core_tpu.graph.units import RagPromptBuilder as JaxPrompt
    from seldon_core_tpu.models.llm import DecoderLM as JaxLM
    from seldon_core_tpu.servers.generateserver import GenerateServer as JaxGen
    from seldon_core_tpu.servers.jaxserver import JAXServer

    f32 = {"dtype": "float32"}
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_units = {}
    for name, family, cfg in (("embed", "bert", RAG_BERT), ("retrieve", "retrieval", RAG_RET),
                              ("rerank", "reranker", RAG_RET)):
        u = JAXServer(model_uri=_write_model(jroot, family, {**cfg, **f32}))
        u.load()
        jax_units[name] = u
    llm_params = jax.jit(JaxLM(**RAG_LLM, **f32).init_params)(0)
    jgen = JaxGen(model_uri=_write_model(jroot, "llm", {**RAG_LLM, **f32}), slots=2,
                  steps_per_poll=1, warmup_prompt_lens=[RAG_L], warmup_max_new_tokens=8)
    jgen.load()
    jax_units.update(prompt=JaxPrompt(max_new_tokens=8), generate=jgen)
    checkpoints = {
        "bert": jax.tree.map(np.asarray, jax_units["embed"].params),
        "retrieval": jax.tree.map(np.asarray, jax_units["retrieve"].params),
        "reranker": jax.tree.map(np.asarray, jax_units["rerank"].params),
        "llm": jax.tree.map(np.asarray, llm_params),
    }
    port_units = _rag_components(troot, dtype="float32", checkpoints=checkpoints)
    jex = JaxExecutor(jax_default(JaxSpec.from_dict({
        "name": "p", "annotations": dict(FUSE_ANN), "graph": RAG_GRAPH})), registry=jax_units)
    tex = make_executor(RAG_GRAPH, port_units)
    try:
        for seed in range(3):
            req = _rag_request(seed=seed)
            jo = _drop_timers(strip_puid(run(jex.predict(json.loads(json.dumps(req))))))
            to = _drop_timers(strip_puid(run(tex.predict(json.loads(json.dumps(req))))))
            assert to["jsonData"]["tokens"] == jo["jsonData"]["tokens"]
            assert to["jsonData"]["tokens"]
            # the meta whole (requestPath, tags, counters) but the port
            # generate server's own weight_version tag
            tags = to["meta"]["tags"]
            assert tags.pop("weight_version") == "0"
            assert to["meta"] == jo["meta"]
        assert jex.fusion.segments["embed"].dispatches == 3
        assert tex.fusion.segments["embed"].dispatches == 3
        assert tex.fusion.segments["embed"].fallbacks == {}
    finally:
        jgen.close()
        port_units["generate"].close()
