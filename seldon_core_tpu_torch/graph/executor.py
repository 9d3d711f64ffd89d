"""Async inference-graph executor.

Counterpart of ``seldon_core_tpu/graph/executor.py``, with behavior
parity with the reference engine's recursive walk (reference:
engine/.../predictors/PredictiveUnitBean.java:81-241):

  request -> transformInput (MODEL=>predict, TRANSFORMER=>transform-input)
          -> route (ROUTER; branch -1 = broadcast to all children)
          -> child subtrees concurrently (asyncio.gather ~= Spring @Async
             fan-out, PredictiveUnitBean.java:169-180)
          -> aggregate (COMBINER; single child passes through; multiple
             children without a combiner is an error)
          -> transformOutput (OUTPUT_TRANSFORMER)

with per-request meta accumulation: ``routing`` (unit -> branch),
``requestPath`` (unit -> implementation id), merged ``tags`` and appended
``metrics`` (reference: mergeMeta PredictiveUnitBean.java:354-372), puid
assignment (reference: PredictionService.PuidGenerator:77), and the
feedback walk that replays the routing map
(reference: sendFeedbackAsync:204-241).

Units co-located with the engine are in-process objects (no
serialization), called on a thread pool; device work stays on each
unit's own threads (the generate server's batcher thread). MODEL units
may be micro-batched (``graph/batching.py``, ``seldon.io/microbatch``):
concurrent requests fuse into one forward, on the device for in-process
TorchComponents. With ``seldon.io/fuse: "true"`` chains of in-process
TorchComponents run as one device hop (``graph/fusion.py``); any
per-unit condition falls back, counted, to this walk. A device mesh
(``parallel/mesh.py`` ``ServingMesh``, the predictor's ``tpuMesh``) is
handed to the mesh-aware prepackaged servers (``GenerateServer``,
``TorchServer``, the ``Explainer``), which store their params split over
it and compute on its compute device; a micro-batched meshed unit gets
its fused batch there.
"""

from __future__ import annotations

import asyncio
import importlib
import logging
import uuid
from typing import Any, Dict, List, Optional

import numpy as np

from .client import GrpcClient, InProcessClient, RestClient, UnitCallError, UnitClient
from .spec import PREPACKAGED_SERVERS, PredictorSpec, PredictiveUnit, UnitType
from .units import BUILTIN_IMPLEMENTATIONS
from ..resilience import (
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    FaultInjector,
    HedgePolicy,
    ResilientClient,
    RetryPolicy,
    stamp_meta,
)

logger = logging.getLogger(__name__)


class RequestCtx:
    """Per-request meta accumulator (the reference used ConcurrentHashMaps
    on the bean, PredictiveUnitBean.java:82-96)."""

    __slots__ = ("puid", "tags", "metrics", "routing", "request_path", "deadline")

    def __init__(self, puid: str, deadline: Optional[Deadline] = None):
        self.puid = puid
        self.tags: Dict[str, Any] = {}
        self.metrics: List[Dict] = []
        self.routing: Dict[str, int] = {}
        self.request_path: Dict[str, str] = {}
        self.deadline = deadline

    def absorb(self, unit_name: str, response: Dict[str, Any]) -> None:
        meta = response.get("meta") or {}
        self.tags.update(meta.get("tags") or {})
        for m in meta.get("metrics") or []:
            # stamp the emitting graph node so the engine's exposition
            # keeps per-unit series (a multi-node graph's counters would
            # otherwise collapse into one unattributed stream)
            if isinstance(m, dict) and "unit" not in (m.get("tags") or {}):
                m = dict(m)
                m["tags"] = {**(m.get("tags") or {}), "unit": unit_name}
            self.metrics.append(m)

    def to_meta(self) -> Dict[str, Any]:
        meta: Dict[str, Any] = {"puid": self.puid}
        if self.tags:
            meta["tags"] = self.tags
        if self.metrics:
            meta["metrics"] = self.metrics
        if self.routing:
            meta["routing"] = self.routing
        if self.request_path:
            meta["requestPath"] = self.request_path
        return meta


class UnitRuntime:
    """A spec node bound to a client + its children runtimes."""

    def __init__(self, unit: PredictiveUnit, client: Optional[UnitClient], children):
        self.unit = unit
        self.client = client
        self.children: List[UnitRuntime] = children
        self.name = unit.name
        self.type = unit.type or UnitType.MODEL

    @property
    def identity(self) -> str:
        return self.unit.implementation or self.unit.model_uri or self.name


def _branch_index(route_response: Dict[str, Any], n_children: int,
                  unit: str = "?") -> int:
    """Decode + validate the branch from the router's response tensor
    (reference: getBranchIndex PredictiveUnitBean.java:301-312).

    A malformed route response — non-numeric, a non-integral float
    (``int()`` used to TRUNCATE 0.7 to branch 0 silently), or a branch
    outside ``[-1, n_children)`` — is a typed 400: the route decision is
    request-shaped garbage, and retrying the identical request cannot
    pick a valid child. ``-1`` stays the broadcast branch."""
    data = route_response.get("data") or {}
    if "ndarray" in data:
        v = np.asarray(data["ndarray"]).ravel()
    elif "tensor" in data:
        v = np.asarray(data["tensor"].get("values", [])).ravel()
    else:
        raise UnitCallError(500, "router response has no tensor/ndarray data")
    if v.size == 0:
        raise UnitCallError(500, "router returned empty branch tensor")
    try:
        raw = float(v[0])
    except (TypeError, ValueError):
        raise UnitCallError(
            400, f"router {unit} returned non-numeric branch {v[0]!r}"
        ) from None
    if not raw.is_integer():
        raise UnitCallError(
            400, f"router {unit} returned non-integer branch {raw!r}"
        )
    branch = int(raw)
    if branch >= n_children or branch < -1:
        raise UnitCallError(
            400, f"router {unit} chose branch {branch} of {n_children}"
        )
    return branch


def _ann_seconds(ann: Dict[str, str], key: str, default_s: float) -> float:
    """Millisecond annotation -> seconds, falling back on junk (the
    reference logs-and-defaults too rather than failing the pod)."""
    try:
        return float(ann[key]) / 1000.0
    except (KeyError, TypeError, ValueError):
        return default_s


def _ann_int(ann: Dict[str, str], key: str) -> Optional[int]:
    try:
        return int(ann[key])
    except (KeyError, TypeError, ValueError):
        return None


class GraphExecutor:
    def __init__(
        self,
        spec: PredictorSpec,
        registry: Optional[Dict[str, Any]] = None,
        timeout_s: float = 5.0,
        batching: Optional[Dict[str, Dict]] = None,
        inprocess_workers: int = 32,
        mesh=None,
        metrics=None,
        faults: Optional[FaultInjector] = None,
    ):
        """registry: unit name -> user object for INPROCESS units that are
        neither builtin implementations nor prepackaged servers.
        inprocess_workers: thread-pool size for in-process unit calls,
        sized independently of cpu_count so concurrent requests to a
        blocking unit (a generate request waiting on its batcher) do not
        queue behind each other on a small host.
        batching: unit name -> MicroBatchingClient kwargs for the MODEL
        units to micro-batch (``batching_from_annotations``).
        mesh: the ``ServingMesh`` handed to mesh-aware in-process
        prepackaged servers (the predictor spec's tpuMesh, placed by the
        control plane)."""
        from concurrent.futures import ThreadPoolExecutor

        from .spec import parse_fuse_annotation

        ann = getattr(spec, "annotations", None) or {}
        self._mesh = mesh
        # the ONE strict parser (admission uses the same): a typo'd value
        # fails construction, never serves hop-by-hop while the operator
        # believes fusion is on
        fuse = parse_fuse_annotation(spec)
        self._batching = batching or {}
        self.spec = spec
        self._registry = registry or {}
        self._timeout = timeout_s
        # per-annotation unit-call tuning, the reference's feature-flag
        # idiom (InternalPredictionService.java:82-91 reads seldon.io/
        # rest-read-timeout, grpc-read-timeout [ms] and
        # grpc-max-message-size [bytes] from pod annotations)
        self._ann = ann
        self._rest_timeout = _ann_seconds(ann, "seldon.io/rest-read-timeout", timeout_s)
        self._grpc_timeout = _ann_seconds(ann, "seldon.io/grpc-read-timeout", timeout_s)
        self._grpc_max_message = _ann_int(ann, "seldon.io/grpc-max-message-size")
        # deterministic fault injection (tests, degraded-mode runs): an
        # explicit injector wins; else SELDON_FAULTS env config; else None
        self._faults = faults if faults is not None else FaultInjector.from_env()
        self._metrics = metrics
        self._pool = ThreadPoolExecutor(
            max_workers=int(inprocess_workers), thread_name_prefix="unit-call"
        )
        self.root = self._build(spec.graph)
        # graph fusion (opt-in via seldon.io/fuse): chains of co-resident
        # in-process units run as ONE device hop so activations never
        # leave the device between stages; any per-unit semantics
        # condition falls back to the hop-by-hop walk (fusion.py's module
        # docstring has the contract). The engine app sets the hook below
        # to report a live rollout shadow mirror: divergence analysis
        # keeps the per-unit path.
        self.shadow_active_fn = None
        self.fusion = None
        if fuse:
            from .fusion import FusionPlan

            self.fusion = FusionPlan(self)

    # -- construction -------------------------------------------------------

    def _build(self, unit: PredictiveUnit) -> UnitRuntime:
        children = [self._build(c) for c in unit.children]
        client = self._make_client(unit)
        return UnitRuntime(unit, client, children)

    def _make_client(self, unit: PredictiveUnit) -> UnitClient:
        transport = (unit.endpoint.transport or "INPROCESS").upper()
        retry = RetryPolicy.from_annotations(self._ann, unit.name)
        breaker = CircuitBreaker.from_annotations(self._ann, unit.name)
        hedge = HedgePolicy.from_annotations(
            self._ann, unit.name, unit.endpoint.transport, unit.type
        )
        resilient = retry is not None or breaker is not None or hedge is not None
        # ONLY a configured RetryPolicy replaces the transport's inner
        # 3-connect loop (else 3 policy retries x 3 connects = 12 attempts
        # against a down unit). Breaker-only and hedge-only configs keep
        # the inner loop: removing it with nothing replacing it would turn
        # transient connect blips the baseline absorbs into client-visible
        # 503s — the breaker then counts LOGICAL call outcomes, which is
        # what callers experience.
        if transport in ("REST", "HTTP"):
            client: UnitClient = RestClient(
                unit.endpoint.service_host, unit.endpoint.service_port,
                self._rest_timeout,
                **({"retries": 1} if retry is not None else {}),
            )
        elif transport == "GRPC":
            client = GrpcClient(
                unit.endpoint.service_host, unit.endpoint.grpc_port,
                self._grpc_timeout,
                max_message_bytes=self._grpc_max_message,
            )
        else:
            client = InProcessClient(self._resolve_object(unit), executor=self._pool)
        # fault injection hugs the transport: everything above (batching,
        # retries, breaker, hedging) sees injected faults exactly where
        # real unit failures would surface
        if self._faults is not None:
            client = self._faults.wrap(client, unit.name)
        if unit.name in self._batching and unit.type in (None, UnitType.MODEL):
            from .batching import MicroBatchingClient

            client = MicroBatchingClient(
                client, metrics=self._metrics, unit=unit.name,
                **self._batching[unit.name],
            )
        # resilience policies (annotation-gated, off by default): only
        # wrap when at least one is active so unconfigured graphs keep
        # their exact client objects — the happy path must not change
        if resilient:
            client = ResilientClient(
                client, unit=unit.name, retry=retry, breaker=breaker,
                hedge=hedge, metrics=self._metrics,
            )
        return client

    def _resolve_object(self, unit: PredictiveUnit):
        if unit.name in self._registry:
            return self._registry[unit.name]
        impl = unit.implementation
        params = {p.name: p.value for p in unit.parameters}
        if impl in BUILTIN_IMPLEMENTATIONS:
            cls = BUILTIN_IMPLEMENTATIONS[impl]
            try:
                return cls(**params) if params else cls()
            except TypeError:
                return cls()
        if impl in PREPACKAGED_SERVERS:
            module_name, cls_name = PREPACKAGED_SERVERS[impl].rsplit(".", 1)
            cls = getattr(importlib.import_module(module_name), cls_name)
            if self._mesh is not None:
                import inspect

                # signature-gated, not try/except: a constructor fault must
                # surface, never degrade an N-device allocation quietly
                sig = inspect.signature(cls.__init__)
                mesh_aware = "mesh" in sig.parameters or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
                )
                if mesh_aware:
                    obj = cls(model_uri=unit.model_uri, mesh=self._mesh, **params)
                else:
                    logger.warning(
                        "unit %s: %s is not mesh-aware; serving unsharded "
                        "despite a %d-device allocation",
                        unit.name, cls_name, self._mesh.size,
                    )
                    obj = cls(model_uri=unit.model_uri, **params)
            else:
                obj = cls(model_uri=unit.model_uri, **params)
            if hasattr(obj, "load"):
                obj.load()
            return obj
        raise ValueError(
            f"unit {unit.name!r}: no in-process object in registry and "
            f"implementation {impl!r} is not builtin/prepackaged"
        )

    # -- predict path -------------------------------------------------------

    async def predict(
        self, message: Dict[str, Any], deadline: Optional[Deadline] = None
    ) -> Dict[str, Any]:
        meta_in = message.get("meta") or {}
        puid = meta_in.get("puid") or uuid.uuid4().hex
        ctx = RequestCtx(puid, deadline=deadline)
        ctx.tags.update(meta_in.get("tags") or {})
        try:
            out = await self._get_output(self.root, message, ctx)
        except UnitCallError as e:
            # every mid-graph failure gets hop attribution, not just the
            # resilience-converted ones: a plain 503 from a dead REST unit
            # is the failure operators most need the partial path for
            if e.meta is None:
                e.meta = ctx.to_meta()
            raise
        except Exception as e:
            # resilience-layer failures (DeadlineExceeded 504, BreakerOpen
            # 503, ShedError 429, InjectedFault ...) carry a wire status;
            # surface them as UnitCallError with the PARTIAL meta attached
            # — a 504's requestPath shows exactly how far the walk got
            status = getattr(e, "status", None)
            if not isinstance(status, int):
                raise
            err = UnitCallError(status, str(e))
            err.meta = ctx.to_meta()
            retry_after = getattr(e, "retry_after_s", None)
            if retry_after is not None:
                err.retry_after_s = retry_after
            raise err from e
        out["meta"] = ctx.to_meta()
        return out

    async def _call(self, rt: UnitRuntime, method: str, message, ctx: RequestCtx):
        from ..tracing import get_tracer

        deadline = ctx.deadline
        if deadline is not None:
            if deadline.expired():
                raise DeadlineExceeded(
                    f"deadline exhausted before {rt.name}.{method}"
                )
            # re-encode the remaining budget into the hop's meta so
            # IN-PROCESS components see it via their meta argument (the
            # generate server's admit-queue shed reads it). Remote hops
            # are excluded: the Meta proto has no deadline field and
            # strict ParseDict would reject the key — their budget is
            # enforced as the clamped call timeout below instead.
            transport = (rt.unit.endpoint.transport or "INPROCESS").upper()
            if transport not in ("REST", "HTTP", "GRPC") and method != "aggregate":
                message = stamp_meta(message, deadline)
        # span per graph hop (reference: async span re-activation,
        # PredictiveUnitBean.java:85-118)
        with get_tracer().span(
            f"{rt.name}.{method}",
            tags={"unit": rt.name, "method": method,
                  "transport": rt.unit.endpoint.transport},
        ):
            if isinstance(rt.client, ResilientClient):
                coro = rt.client.call(method, message, deadline=deadline)
            else:
                coro = rt.client.call(method, message)
            if deadline is None:
                response = await coro
            else:
                # the remaining budget IS the per-call timeout: a slow hop
                # is cut off at the deadline instead of spending the whole
                # budget and starving every hop after it
                try:
                    response = await asyncio.wait_for(coro, deadline.remaining())
                except asyncio.TimeoutError:
                    raise DeadlineExceeded(
                        f"unit {rt.name}.{method} ran past the request deadline"
                    ) from None
        ctx.absorb(rt.name, response)
        return response

    async def _get_output(self, rt: UnitRuntime, message: Dict[str, Any], ctx: RequestCtx):
        if self.fusion is not None:
            seg = self.fusion.segment_at(rt.name)
            if seg is not None:
                reason = seg.blocked(self, ctx, message)
                if reason is None:
                    try:
                        out = await seg.run(self, message, ctx)
                    except Exception as e:  # noqa: BLE001 - counted fallback
                        # per-unit attribution of the failure comes from
                        # re-running hop-by-hop (stages are pure forwards:
                        # re-running them has no side effect)
                        seg.note_fallback("error", detail=str(e))
                    else:
                        if seg.continue_at is not None:
                            return await self._get_output(seg.continue_at, out, ctx)
                        return out
                else:
                    seg.note_fallback(reason)
        ctx.request_path[rt.name] = rt.identity

        # 1. input transform
        if rt.type == UnitType.MODEL:
            message = await self._call(rt, "predict", message, ctx)
        elif rt.type == UnitType.TRANSFORMER:
            message = await self._call(rt, "transform_input", message, ctx)

        # 2/3. routing + children
        if rt.children:
            if rt.type == UnitType.ROUTER:
                route_resp = await self._call(rt, "route", message, ctx)
                branch = _branch_index(route_resp, len(rt.children), rt.name)
                ctx.routing[rt.name] = branch
                selected = rt.children if branch == -1 else [rt.children[branch]]
            else:
                selected = rt.children
            outputs = await asyncio.gather(
                *(self._get_output(c, message, ctx) for c in selected)
            )

            # 4. aggregation
            if rt.type == UnitType.COMBINER:
                merged = await self._call(
                    rt, "aggregate", {"seldonMessages": list(outputs)}, ctx
                )
            elif len(outputs) == 1:
                merged = outputs[0]
            else:
                raise UnitCallError(
                    500, f"unit {rt.name} has {len(outputs)} child outputs but is no combiner"
                )
            message = merged

        # 5. output transform
        if rt.type == UnitType.OUTPUT_TRANSFORMER:
            message = await self._call(rt, "transform_output", message, ctx)
        return message

    # -- feedback path ------------------------------------------------------

    async def send_feedback(self, feedback: Dict[str, Any]) -> Dict[str, Any]:
        routing = ((feedback.get("response") or {}).get("meta") or {}).get("routing") or {}
        reward = float(feedback.get("reward", 0.0))
        await self._feedback_walk(self.root, feedback, routing)
        # the response is a conforming SeldonMessage (the proto's
        # SendFeedback returns one) — the echoed reward rides in tags,
        # not as a top-level key no transport could serialize
        return {
            "meta": {"tags": {"reward": reward}, "metrics": []},
            "status": {"code": 200, "status": "SUCCESS"},
        }

    async def _feedback_walk(self, rt: UnitRuntime, feedback: Dict[str, Any], routing):
        try:
            await rt.client.call("send_feedback", feedback)
        except Exception as e:
            # status-less exceptions are engine bugs and must surface
            if not isinstance(e, UnitCallError) and not isinstance(
                getattr(e, "status", None), int
            ):
                raise
            # units without the hook are fine (reference: doSendFeedback:288)
            # — but a real failure silently vanishing makes reward loss
            # undiagnosable, so count every drop per unit while keeping
            # the lenient walk
            if self._metrics is not None:
                self._metrics.counter_inc(
                    "seldon_engine_feedback_errors", {"unit": rt.name}
                )
            logger.debug("feedback to unit %s dropped: %s", rt.name, e)
        if not rt.children:
            return
        branch = routing.get(rt.name)
        if rt.type == UnitType.ROUTER and branch is not None and branch != -1:
            targets = [rt.children[branch]] if 0 <= branch < len(rt.children) else []
        else:
            targets = rt.children
        await asyncio.gather(*(self._feedback_walk(c, feedback, routing) for c in targets))

    # -- readiness ----------------------------------------------------------

    async def ready(self) -> bool:
        """All units reachable (reference: SeldonGraphReadyChecker.java:45-115).

        A client whose ready() RAISES (connection refused at startup, DNS
        not yet resolving) is simply not ready — it must not crash the
        readiness loop that would otherwise keep polling it to health."""
        checks = await asyncio.gather(
            *(rt.client.ready() for rt in self._walk(self.root)),
            return_exceptions=True,
        )
        return all(c is True for c in checks)

    def _walk(self, rt: UnitRuntime):
        yield rt
        for c in rt.children:
            yield from self._walk(c)

    async def close(self) -> None:
        await asyncio.gather(*(rt.client.close() for rt in self._walk(self.root)))
        self._pool.shutdown(wait=False)
