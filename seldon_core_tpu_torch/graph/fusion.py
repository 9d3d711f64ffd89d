"""Graph fusion: multi-stage inference as ONE device hop.

Counterpart of ``seldon_core_tpu/graph/fusion.py``. The executor's
hop-by-hop walk (executor.py) pays a per-unit tax even when every unit
lives in-process on the same device: each hop serializes the previous
stage's output to the host (``array_to_json_data``: a D2H copy),
re-extracts it, re-uploads it (``_to_dev``: an H2D copy) and runs its
own forward. For a chain of co-resident stages those transfers move
activations that never needed to leave device memory.

This pass walks the :class:`~.executor.UnitRuntime` tree at engine
build time (opt-in via the ``seldon.io/fuse: "true"`` predictor
annotation) and composes every *maximal fusable segment* into one
function run on the device between one H2D and one D2H:

* **linear chains**: consecutive single-child TRANSFORMER/MODEL units
  whose down-phase ops run back to back;
* **fusable subtrees**: a unit whose whole subtree is fusable
  (including OUTPUT_TRANSFORMER tails and COMBINER fan-ins through the
  combiner's ``fused_aggregate``) fuses down-ops, children and up-ops.

A unit is *stage-eligible* when its client is the plain in-process one
(or a breaker/retry wrapper around it) and its component exposes
:meth:`~seldon_core_tpu_torch.user_model.TorchComponent.fused_stage` (a
pure ``fn(params, x)``). The composition replicates the hop boundary
exactly: each stage's input is cast to that component's
``compute_dtype`` when floating, which is what ``_to_dev`` does on the
hop-by-hop path, so fused output is byte-identical to hop-by-hop
(asserted by tests/test_torch_fusion.py and the smoke run's ``rag``
phase). The composition runs eagerly: one device hop, but still one
kernel launch per op (a CUDA graph per warmed shape is later work).

Per-unit semantics are never hidden: any condition that requires the
engine to observe a unit boundary forces a counted, logged fallback to
the hop-by-hop walk instead:

========================  =======  ====================================
condition                 when     reason label
========================  =======  ====================================
remote client (REST/gRPC) plan     ``remote``
fault injector on a unit  plan     ``faults``
micro-batcher on a unit   plan     ``microbatch``
hedge policy on a unit    plan     ``hedge``
circuit breaker not       request  ``breaker_open`` (the breaker's own
  CLOSED on any stage              refusal/probe logic must run per
                                   unit)
request carries a         request  ``deadline`` (budget is enforced as
  deadline budget                  each hop's timeout; one fused
                                   dispatch cannot honor a mid-segment
                                   expiry)
rollout shadow mirror     request  ``shadow`` (divergence verdicts must
  active on the engine             never include the fusion planner)
non-tensor request body   request  ``payload`` (the per-unit path
                                   raises the typed 400)
fused dispatch raised     request  ``error`` (re-run hop-by-hop for
                                   per-unit attribution)
========================  =======  ====================================

Fallbacks land in ``seldon_engine_fusion_fallbacks{unit,reason}``;
served fused dispatches in ``seldon_engine_fused_segments{unit}``; each
fused dispatch emits a ``gen.fused_segment`` trace span carrying the
per-stage names and a ``fused_dispatch`` record in the plan's ring
(served as the ``(fusion)`` pseudo-unit of ``/flightrecorder``).

Segments are additionally COST-GATED when a gate is supplied (the
``cost_gate`` argument or the ``SELDON_FUSION_COST_GATE`` env JSON): a
candidate only fuses when its dispatch savings, ``(stages - 1)``
eliminated dispatch floors times the expected dispatch count, exceed
the gate's per-segment build cost. A gated-out segment serves
hop-by-hop and counts ``seldon_engine_fusion_skipped{unit,
reason="cost"}`` (plus a ``fusion_skipped`` record). No gate means
everything eligible fuses.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..models.base import torch_dtype
from ..payload import (
    DEVICE_KEY,
    Parts,
    _to_numpy,
    extract_parts_json,
    is_extended_torch_dtype,
)
from ..resilience.breaker import CLOSED
from ..user_model import client_class_names
from .engine_metrics import FUSED_SEGMENTS, FUSION_FALLBACKS, FUSION_SKIPPED
from .spec import UnitType

logger = logging.getLogger(__name__)

# plan-time reasons that represent per-unit semantics (counted); plain
# ineligibility (a component without a fused stage) is structure, not
# semantics, and is not counted
_SEMANTIC_PLAN_REASONS = ("remote", "faults", "microbatch", "hedge")


def segment_worth_compiling(n_stages: int, gate: Dict[str, Any]) -> bool:
    """The fusion cost gate: fuse only when the dispatch savings a
    segment buys (one eliminated per-dispatch floor per interior hop,
    times the expected dispatch count) exceed the build cost per
    segment. An unpriced gate (no dispatch floor or no expected volume)
    gates nothing: fusing is the default, the gate only prunes."""
    try:
        floor_us = float(gate.get("dispatch_floor_us", 0.0))
        compile_s = float(gate.get("compile_cost_s", 0.0))
        dispatches = float(gate.get("expected_dispatches", 0.0))
    except (TypeError, ValueError, AttributeError):
        return True
    if floor_us <= 0 or dispatches <= 0:
        return True
    savings_s = max(0, int(n_stages) - 1) * floor_us * 1e-6 * dispatches
    return savings_s >= compile_s


def _gate_from_env() -> Optional[Dict[str, Any]]:
    """``SELDON_FUSION_COST_GATE`` env JSON (keys ``dispatch_floor_us``,
    ``compile_cost_s``, ``expected_dispatches``)."""
    raw = os.environ.get("SELDON_FUSION_COST_GATE")
    if not raw:
        return None
    try:
        gate = json.loads(raw)
        if not isinstance(gate, dict):
            raise ValueError("must be a JSON object")
        return gate
    except ValueError as e:
        logger.warning(
            "fusion: SELDON_FUSION_COST_GATE unparseable (%s): %r; gating nothing", e, raw,
        )
        return None


class _Stage:
    """One unit's contribution to a fused segment."""

    __slots__ = ("rt", "method", "comp", "breaker")

    def __init__(self, rt, method: str, comp, breaker=None):
        self.rt = rt
        self.method = method  # predict | transform_input | transform_output | aggregate
        self.comp = comp
        self.breaker = breaker

    @property
    def name(self) -> str:
        return self.rt.name


def _unwrap(client) -> Tuple[Any, Optional[Any], Optional[str]]:
    """(inprocess_client, breaker, plan_reason). ``plan_reason`` is a
    counted per-unit-semantics exclusion; (None, None, None) marks a
    plainly non-fusable client."""
    from ..resilience import FaultyClient, ResilientClient
    from .batching import MicroBatchingClient
    from .client import GrpcClient, InProcessClient, RestClient

    breaker = None
    if isinstance(client, ResilientClient):
        if client.hedge is not None:
            return None, None, "hedge"
        breaker = client.breaker
        client = client.inner
    if isinstance(client, FaultyClient):
        return None, None, "faults"
    if isinstance(client, MicroBatchingClient):
        return None, None, "microbatch"
    if isinstance(client, (RestClient, GrpcClient)):
        return None, None, "remote"
    if isinstance(client, InProcessClient):
        return client, breaker, None
    return None, None, None


def _cast(x, comp):
    """The hop boundary's dtype rule on the device: ``_to_dev`` casts
    floating inputs to the component's compute dtype (integers pass
    through untouched), replicated here so a fused interior value is bit
    for bit what the next hop would have uploaded."""
    dt = torch_dtype(getattr(comp, "compute_dtype", "bfloat16"))
    if x.is_floating_point() and x.dtype != dt:
        return x.to(dt)
    return x


def _note(probe: Optional[List[Any]], y):
    if probe is not None:
        probe.append(y.dtype)
    return y


class FusedSegment:
    """A maximal fusable segment run as one device hop.

    ``kind`` is ``"subtree"`` (the whole subtree under ``head`` is the
    segment; running it replaces the recursive walk) or ``"prefix"``
    (the down-phase ops of a linear chain; the walk continues at
    ``continue_at``, the last fused node's child)."""

    def __init__(self, plan: "FusionPlan", head, kind: str,
                 stages: List[_Stage], composed: Callable, params: Tuple,
                 continue_at=None, combiner_first_child_comp=None):
        self.plan = plan
        self.head = head
        self.kind = kind
        self.stages = stages  # execution order
        self.continue_at = continue_at
        # composed(params, x, probe) runs every stage; probe, when a list,
        # collects each op's output dtype
        self._raw_fn = composed
        self._fn = lambda ps, x: composed(ps, x, None)
        self._params = params
        # set by the first run (warm, or the first dispatch when the head
        # has no warmup shape): True when any INTERMEDIATE stage output
        # is an extended dtype (bf16/fp8 where ml_dtypes names it). The
        # hop-by-hop walk then flips the wire encoding to 'raw' at that
        # hop and it stays raw to the end (effective_encoding is sticky),
        # so the fused response must mirror it
        self._forces_raw = False
        self._probed = False
        # the final op builds the response; a combiner-final segment
        # replicates the aggregate hop's fallback-names rule, which needs
        # the first child chain's final component
        self._final = stages[-1]
        self._combiner_child_comp = combiner_first_child_comp
        self.names = [s.name for s in stages]
        self.label = "|".join(self.names)
        self.dispatches = 0
        self.fallbacks: Dict[str, int] = {}

    # -- gating --------------------------------------------------------------

    def blocked(self, executor, ctx, message) -> Optional[str]:
        """Reason this request must take the hop-by-hop path, else None."""
        if ctx.deadline is not None:
            return "deadline"
        shadow = getattr(executor, "shadow_active_fn", None)
        if shadow is not None and shadow():
            return "shadow"
        for s in self.stages:
            if s.breaker is not None and s.breaker.state != CLOSED:
                return "breaker_open"
        data = message.get("data") if isinstance(message, dict) else None
        if not isinstance(data, dict) or not any(
            k in data for k in ("ndarray", "tensor", "raw", DEVICE_KEY)
        ):
            # non-tensor bodies (strData/jsonData/tensor-less data) take
            # the per-unit path, which raises the proper typed 400
            return "payload"
        return None

    def note_fallback(self, reason: str, detail: str = "") -> None:
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1
        self.plan.count_fallback(self.label, reason, detail)

    # -- execution -----------------------------------------------------------

    def _run(self, x):
        """The composition on ``x``. The first run records every stage
        output's dtype under the plan's probe lock: concurrent first
        dispatches (worker threads) must not both decide the encoding,
        and one of them latching a wrong one would hold for the life of
        the engine. Later runs take no lock."""
        import torch

        with torch.no_grad():
            if self._probed:
                return self._fn(self._params, x)
            with self.plan._probe_lock:
                if self._probed:
                    return self._fn(self._params, x)
                probe: List[Any] = []
                y = self._raw_fn(self._params, x, probe)
                # every probed output except the FINAL op's crosses a hop
                # boundary in the unfused walk
                self._forces_raw = any(is_extended_torch_dtype(d) for d in probe[:-1])
                self._probed = True
                return y

    def warm(self, batch: int = 1) -> None:
        """Run the segment once on ``batch`` rows of zeros of the head's
        warmup shape before traffic arrives (the compile-before-listen
        discipline of the components' own ``load``), which also records
        the intermediate dtypes. Heads without a warmup shape record them
        on the first dispatch instead."""
        import numpy as np
        import torch

        head_comp = self.stages[0].comp
        shape = getattr(head_comp, "warmup_shape", None)
        if shape is None:
            return
        x = np.zeros((batch, *shape), getattr(head_comp, "warmup_dtype", "float32"))
        y = self._run(head_comp._to_dev(x))
        if y.device.type == "cuda":
            torch.cuda.synchronize(y.device)

    async def run(self, executor, message: Dict[str, Any], ctx) -> Dict[str, Any]:
        """Execute the segment as ONE hop: one H2D, the composed stages on
        the device, one D2H; then replicate the per-unit meta/requestPath
        bookkeeping the hop-by-hop walk would have produced."""
        import asyncio
        import contextvars

        import numpy as np

        from ..seldon_methods import _respond
        from ..tracing import get_tracer

        parts = extract_parts_json(message)
        if parts.array is None:
            # blocked() pre-checks the shape of the message, but a
            # malformed tensor body can still surface here: refuse into
            # the hop path, which raises the proper typed 400
            raise ValueError("fused segment needs a tensor payload")
        head_comp = self.stages[0].comp

        def dispatch():
            x = head_comp._to_dev(parts.array)  # the ONE H2D
            return _to_numpy(self._run(x))      # the ONE D2H

        loop = asyncio.get_running_loop()
        with get_tracer().span(
            "gen.fused_segment",
            tags={"units": ",".join(self.names), "stages": len(self.stages),
                  "kind": self.kind},
        ):
            cctx = contextvars.copy_context()
            t0 = time.perf_counter()
            y_np = await loop.run_in_executor(executor._pool, cctx.run, dispatch)
            dur_ms = (time.perf_counter() - t0) * 1000.0
        # bookkeeping AFTER the dispatch succeeded, and ctx mutation only
        # after EVERYTHING that can raise has run: a failure anywhere in
        # this tail falls back to hop-by-hop, which must not find
        # half-absorbed tags/metrics already on the request
        path: List[Tuple[str, str]] = []
        absorbs: List[Tuple[str, Dict[str, Any]]] = []
        meta = self._meta_walk(self.head, parts.meta, path, absorbs)
        fallback_names = None
        if self._combiner_child_comp is not None:
            # the aggregate hop's fallback-names rule: the first child's
            # response names feed the combiner's _respond; re-derive them
            # from the child's component (the synthesized t:N form only
            # depends on the output width)
            width = y_np.shape[-1] if y_np.ndim else 0
            fallback_names = client_class_names(
                self._combiner_child_comp, np.zeros((1, width))
            )
        datadef = "raw" if self._forces_raw else parts.datadef_type
        final_parts = Parts(meta=meta, datadef_type=datadef)
        out = _respond(
            self._final.comp, final_parts, y_np, False,
            fallback_names=fallback_names,
        )
        for name, ident in path:
            ctx.request_path[name] = ident
        for name, m in absorbs:
            ctx.absorb(name, {"meta": m})
        ctx.absorb(self._final.name, out)
        # breaker window parity: each stage logically served this request;
        # without this a breaker-annotated stage's rolling window would
        # only ever see the (rare) fallback-path outcomes
        for s in self.stages:
            if s.breaker is not None:
                s.breaker.record_success()
        self.dispatches += 1
        self.plan.count_dispatch(self, dur_ms)
        return out

    def _meta_walk(self, rt, meta: Dict[str, Any], path, absorbs) -> Dict[str, Any]:
        """Replicate the hop-by-hop meta threading for every fused unit
        EXCEPT the final op (whose response ``run`` builds via
        ``_respond``): requestPath entries in tree-walk order, per-unit
        tag/metric absorption in execution order, each hop's response
        meta derived from its request meta as seldon_methods would. PURE:
        collects the pending ctx mutations into ``path``/``absorbs`` for
        the caller to apply at once. Returns the meta the final op's
        request would carry."""
        from ..seldon_methods import _merged_meta

        path.append((rt.name, rt.identity))
        stage = self._stage_of(rt)
        if (
            stage is not None
            and stage.method in ("predict", "transform_input")
            and stage is not self._final
        ):
            # the FINAL op's merge happens inside run()'s _respond; merging
            # here too would double its custom tags/metrics
            meta = _merged_meta(stage.comp, meta)
            absorbs.append((rt.name, meta))
        if rt.children and self._covers(rt.children[0]):
            if rt.type == UnitType.COMBINER:
                child_metas = [
                    self._meta_walk(c, meta, path, absorbs) for c in rt.children
                ]
                agg = self._stage_of(rt)
                meta = child_metas[0]
                if agg is not None and agg.method == "aggregate" and agg is not self._final:
                    meta = _merged_meta(agg.comp, meta)
                    absorbs.append((rt.name, meta))
            else:
                meta = self._meta_walk(rt.children[0], meta, path, absorbs)
        if stage is not None and stage.method == "transform_output":
            if stage is not self._final:
                meta = _merged_meta(stage.comp, meta)
                absorbs.append((rt.name, meta))
        return meta

    def _stage_of(self, rt) -> Optional[_Stage]:
        for s in self.stages:
            if s.rt is rt:
                return s
        return None

    def _covers(self, rt) -> bool:
        return self._stage_of(rt) is not None


class FusionPlan:
    """Plans, warms and serves every fused segment of one executor.

    Built once at engine construction when the predictor carries
    ``seldon.io/fuse: "true"``; also owns the fusion observability
    surface (metrics counters + a bounded ring of records)."""

    RING = 512

    def __init__(self, executor, warm: bool = True,
                 cost_gate: Optional[Dict[str, Any]] = None):
        self.executor = executor
        self.metrics = executor._metrics
        # cost gate (module docstring): an explicit gate wins, else the
        # env escape hatch, else gate nothing
        self.cost_gate = cost_gate if cost_gate is not None else _gate_from_env()
        self.segments: Dict[str, FusedSegment] = {}  # head unit name -> segment
        self._records: deque = deque(maxlen=self.RING)
        self._recorded_total = 0
        self._lock = threading.Lock()
        self._eligible_cache: Dict[int, bool] = {}
        self._probe_lock = threading.Lock()
        # first-occurrence latch per (segment label, reason): fallback
        # counters always count, but the log line + ring record fire once
        # per pair (a deadline-heavy workload must not flood the log or
        # evict the ring's dispatch records at traffic rate)
        self._fallback_seen: set = set()
        self._plan(executor.root)
        if warm and self.segments:
            t0 = time.perf_counter()
            # at the mesh's data width: the batch a meshed engine serves
            batch = 1
            mesh = getattr(executor, "_mesh", None)
            if mesh is not None:
                batch = int(mesh.shape.get("data", 1)) or 1
            for seg in self.segments.values():
                seg.warm(batch)
            logger.info(
                "fusion: %d segment(s) (%s) warmed in %.1fs",
                len(self.segments),
                ", ".join(f"{s.label}[{s.kind}:{len(s.stages)}]"
                          for s in self.segments.values()),
                time.perf_counter() - t0,
            )

    # -- observability -------------------------------------------------------

    def _labels(self, extra: Dict[str, str]) -> Dict[str, str]:
        return {"deployment": getattr(self.executor.spec, "name", ""), **extra}

    def count_dispatch(self, seg: FusedSegment, dur_ms: float) -> None:
        if self.metrics is not None:
            self.metrics.counter_inc(FUSED_SEGMENTS, self._labels({"unit": seg.label}))
        self._record({
            "type": "fused_dispatch", "segment": seg.label,
            "stages": len(seg.stages), "kind": seg.kind,
            "dur_ms": round(dur_ms, 3),
        })

    def count_fallback(self, unit: str, reason: str, detail: str = "") -> None:
        if self.metrics is not None:
            self.metrics.counter_inc(
                FUSION_FALLBACKS, self._labels({"unit": unit, "reason": reason})
            )
        # the counter carries the rate; the log line and the ring record
        # fire on the FIRST (segment, reason) occurrence only. Cumulative
        # per-reason totals stay visible in dump()["segments"]
        first = (unit, reason) not in self._fallback_seen
        self._fallback_seen.add((unit, reason))
        (logger.info if first else logger.debug)(
            "fusion: fallback to hop-by-hop for %s (reason=%s%s)",
            unit, reason, f": {detail}" if detail else "",
        )
        if first:
            self._record({
                "type": "fusion_fallback", "segment": unit, "reason": reason,
                **({"detail": detail} if detail else {}),
            })

    def count_skip(self, unit: str, n_stages: int) -> None:
        """A segment the cost gate pruned: counted
        (``seldon_engine_fusion_skipped``, reason="cost") + one record, so
        the absent segment is a diagnosis instead of a silent no-op."""
        if self.metrics is not None:
            self.metrics.counter_inc(
                FUSION_SKIPPED, self._labels({"unit": unit, "reason": "cost"})
            )
        logger.info(
            "fusion: segment at %s (%d stages) not fused (reason=cost: gate %s "
            "prices the build above the dispatch savings)", unit, n_stages, self.cost_gate,
        )
        self._record({
            "type": "fusion_skipped", "segment": unit, "stages": n_stages, "reason": "cost",
        })

    def _record(self, rec: Dict[str, Any]) -> None:
        from ..tracing import wall_us

        with self._lock:
            rec["t_us"] = wall_us()
            self._records.append(rec)
            self._recorded_total += 1

    def dump(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """Flight-recorder-shaped dump served under the engine's
        ``/flightrecorder`` route as the ``(fusion)`` pseudo-unit."""
        with self._lock:
            entries = list(self._records)
            total = self._recorded_total
        if limit:
            entries = entries[-int(limit):]
        return {
            "entries": entries,
            "recorded_total": total,
            "dropped": max(0, total - len(self._records)),
            "segments": {
                name: {
                    "stages": seg.names, "kind": seg.kind,
                    "dispatches": seg.dispatches,
                    "fallbacks": dict(seg.fallbacks),
                }
                for name, seg in self.segments.items()
            },
        }

    def segment_at(self, unit_name: str) -> Optional[FusedSegment]:
        return self.segments.get(unit_name)

    # -- planning ------------------------------------------------------------

    def _stage_parts(self, rt) -> Tuple[Optional[Any], Optional[Any], Optional[str]]:
        """(component, breaker, why_not) for one unit. ``why_not`` is a
        counted plan reason for per-unit-semantics exclusions, the string
        "structural" for plain non-fusable units, None when the unit is
        stage-eligible."""
        client, breaker, reason = _unwrap(rt.client)
        if reason is not None:
            return None, None, reason
        if client is None or client.user_object is None:
            return None, None, "structural"
        comp = client.user_object
        if rt.type == UnitType.COMBINER:
            # a combiner fuses through its device aggregate hook; it has
            # no forward of its own
            if not hasattr(comp, "fused_aggregate"):
                return None, None, "structural"
            return comp, breaker, None
        if not hasattr(comp, "fused_stage"):
            return None, None, "structural"
        try:
            comp.fused_stage()  # forces load; raises on a broken build
        except Exception as e:  # noqa: BLE001 - broken stage = not fusable
            logger.warning("fusion: unit %s stage build failed: %s", rt.name, e)
            return None, None, "structural"
        if getattr(comp, "_mesh", None) is not getattr(self.executor, "_mesh", None):
            # every stage must live on the engine's mesh (or all off it):
            # a mixed segment would move its activations between layouts
            return None, None, "structural"
        return comp, breaker, None

    def _eligible(self, rt) -> bool:
        # memoized: planning probes the same node from the subtree sweep
        # AND the prefix walk, and a counted plan-time fallback must fire
        # exactly once per unit
        cached = self._eligible_cache.get(id(rt))
        if cached is None:
            cached = self._eligible_cache[id(rt)] = self._eligible_uncached(rt)
        return cached

    def _eligible_uncached(self, rt) -> bool:
        comp, _b, why = self._stage_parts(rt)
        if comp is None:
            if why in _SEMANTIC_PLAN_REASONS:
                # counted once at plan time: this unit's semantics keep its
                # whole neighborhood on the per-unit path
                self.count_fallback(rt.name, why)
            return False
        if rt.type in (UnitType.TRANSFORMER, UnitType.OUTPUT_TRANSFORMER):
            # a bare TorchComponent backs ONLY predict with its forward:
            # on a transform hop it degrades to identity, and fusing
            # _apply there would CHANGE the graph's output
            return bool(getattr(comp, "fused_transforms", False))
        return rt.type in (UnitType.MODEL, UnitType.COMBINER, None)

    def _subtree_fusable(self, rt) -> bool:
        if not self._eligible(rt):
            return False
        if rt.type == UnitType.ROUTER:
            return False
        if len(rt.children) > 1 and rt.type != UnitType.COMBINER:
            return False
        if rt.type == UnitType.COMBINER:
            # the fused input is uploaded (and cast) ONCE; hop-by-hop each
            # child casts the original host array itself: those only
            # agree when every fan-in branch leads with one compute dtype
            dts = {str(getattr(self._first_comp(c), "compute_dtype", "bfloat16"))
                   for c in rt.children}
            if len(dts) > 1:
                return False
        return all(self._subtree_fusable(c) for c in rt.children)

    def _first_comp(self, rt):
        """Component of the first op a subtree executes (pre-order
        down-phase walk): the one whose ``_to_dev``/cast rule governs the
        fused input."""
        comp, _b, _why = self._stage_parts(rt)
        if rt.type in (UnitType.MODEL, UnitType.TRANSFORMER, None) or not rt.children:
            return comp
        return self._first_comp(rt.children[0])

    def _plan(self, rt) -> None:
        """Pre-order sweep: at each uncovered node try a subtree segment,
        then a linear-prefix segment; recurse past whatever was (or
        wasn't) fused. Candidates that fail the cost gate are counted and
        served hop-by-hop."""
        if self._subtree_fusable(rt):
            n_units = sum(1 for _ in self._walk(rt))
            # a single-unit "segment" has no fusion win; leave it alone
            if n_units >= 2 and self._gate_allows(rt.name, n_units):
                self._compile_subtree(rt)
            return
        chain = self._linear_prefix(rt)
        if len(chain) >= 2:
            if self._gate_allows(chain[0].name, len(chain)):
                self._compile_prefix(chain)
            tail = chain[-1]
            if tail.children:
                self._plan(tail.children[0])
            return
        for c in rt.children:
            self._plan(c)

    def _gate_allows(self, unit: str, n_stages: int) -> bool:
        if not self.cost_gate or segment_worth_compiling(n_stages, self.cost_gate):
            return True
        self.count_skip(unit, n_stages)
        return False

    def _walk(self, rt):
        yield rt
        for c in rt.children:
            yield from self._walk(c)

    def _linear_prefix(self, rt) -> List[Any]:
        """Maximal run of single-child, down-phase (TRANSFORMER/MODEL)
        stage-eligible units starting at ``rt``."""
        chain: List[Any] = []
        node = rt
        while (
            node is not None
            and node.type in (UnitType.MODEL, UnitType.TRANSFORMER, None)
            and len(node.children) <= 1
            and self._eligible(node)
        ):
            chain.append(node)
            node = node.children[0] if node.children else None
        return chain

    # -- composition ---------------------------------------------------------

    def _compile_prefix(self, chain: List[Any]) -> None:
        stages: List[_Stage] = []
        fns: List[Tuple[Callable, Any]] = []
        params: List[Any] = []
        for rt in chain:
            comp, breaker, _why = self._stage_parts(rt)
            method = "predict" if rt.type in (UnitType.MODEL, None) else "transform_input"
            stages.append(_Stage(rt, method, comp, breaker))
            fn, p, _dt = comp.fused_stage()
            fns.append((fn, comp))
            params.append(p)

        def composed(ps, x, probe):
            for (fn, comp), p in zip(fns, ps):
                x = _note(probe, fn(p, _cast(x, comp)))
            return x

        tail = chain[-1]
        self.segments[chain[0].name] = FusedSegment(
            self, chain[0], "prefix", stages, composed, tuple(params),
            continue_at=tail.children[0] if tail.children else None,
        )

    def _compile_subtree(self, head) -> None:
        stages: List[_Stage] = []
        params: List[Any] = []

        def build(rt) -> Callable:
            comp, breaker, _why = self._stage_parts(rt)
            fn = p = None
            if rt.type != UnitType.COMBINER:
                fn, p, _dt = comp.fused_stage()
            pre_ix = post_ix = agg_stage = None
            if rt.type in (UnitType.MODEL, UnitType.TRANSFORMER, None):
                method = "transform_input" if rt.type == UnitType.TRANSFORMER else "predict"
                stages.append(_Stage(rt, method, comp, breaker))
                params.append(p)
                pre_ix = len(params) - 1
            child_fns = [build(c) for c in rt.children]
            if rt.type == UnitType.COMBINER:
                agg_stage = _Stage(rt, "aggregate", comp, breaker)
                stages.append(agg_stage)
            if rt.type == UnitType.OUTPUT_TRANSFORMER:
                stages.append(_Stage(rt, "transform_output", comp, breaker))
                params.append(p)
                post_ix = len(params) - 1

            def node_fn(ps, x, probe):
                if pre_ix is not None:
                    x = _note(probe, fn(ps[pre_ix], _cast(x, comp)))
                if child_fns:
                    if agg_stage is not None:
                        x = _note(probe, comp.fused_aggregate(
                            [cf(ps, x, probe) for cf in child_fns]))
                    else:
                        x = child_fns[0](ps, x, probe)
                if post_ix is not None:
                    x = _note(probe, fn(ps[post_ix], _cast(x, comp)))
                return x

            return node_fn

        root_fn = build(head)
        # a combiner-FINAL segment replicates the aggregate hop's
        # fallback-names rule: the names of the FIRST child chain's
        # response, i.e. of its final executed op
        combiner_child = None
        final = stages[-1]
        if final.method == "aggregate":
            first = final.rt.children[0]
            sub = [s for s in stages if self._in_subtree(s.rt, first)]
            combiner_child = sub[-1].comp if sub else None
        self.segments[head.name] = FusedSegment(
            self, head, "subtree", stages, root_fn, tuple(params),
            continue_at=None, combiner_first_child_comp=combiner_child,
        )

    @staticmethod
    def _in_subtree(rt, root) -> bool:
        if rt is root:
            return True
        return any(FusionPlan._in_subtree(rt, c) for c in root.children)
