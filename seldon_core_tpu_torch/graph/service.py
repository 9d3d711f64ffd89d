"""Engine application: external REST/gRPC API over a GraphExecutor.

Counterpart of ``seldon_core_tpu/graph/service.py``, with parity with the
reference engine's external surface:
  * ``POST /api/v0.1/predictions`` and ``/api/v1.0/predictions``
    (reference: engine/.../api/rest/RestClientController.java:136-291)
  * ``POST /api/v0.1/feedback``
  * ``/ping /ready /live /pause /unpause /inflight``
  * SSE token streaming at ``/api/v0.1/generate`` for single-node
    GENERATE_SERVER graphs
  * gRPC ``Seldon.Predict`` / ``Seldon.SendFeedback`` /
    ``Seldon.GenerateStream`` (reference: SeldonGrpcServer.java:40-143)
  * bounded admission (``seldon.io/max-inflight``) and deadline-aware
    shedding before work, both answered 429 + Retry-After
  * engine-side micro-batching of MODEL units from the
    ``seldon.io/microbatch*`` annotations (``graph/batching.py``)
  * periodic graph readiness check gating /ready
    (reference: SeldonGraphReadyChecker.java:24-115, 5s fixedDelay)
  * request/response pair logging hook
  * Prometheus exposition at /prometheus, spans at /traces
  * live weight swap at ``POST /weights/swap`` and live-lane migration
    at ``POST /drain`` (units exposing ``hot_swap`` / ``drain_to`` and
    ``resume_checkpoint``: the generate server), and the
    ``Seldon-Tenant`` header stamped into the message meta for
    multi-tenant generate servers
  * telemetry and retune: ``/flightrecorder`` (every unit's scheduler
    flight recorder), ``/fleet`` (the mergeable metric snapshot with each
    unit's device-time ledger, SLO burn verdicts and retune census) and
    ``POST /retune`` (a live knob change applied at a poll boundary);
    with graph fusion on, ``/flightrecorder`` also serves the fusion
    plan's records under the ``(fusion)`` pseudo-unit

  * ``/openapi.json``: the engine's OpenAPI document reconciled against
    the routes it serves (equal to the JAX engine's, key for key)
  * ``SELDON_MESSAGE_LOGGING_SERVICE`` selects a CloudEvents sink for the
    request/response pairs (``request_logging.py``)

The REST front needs no protobuf runtime (a binary body loads it); the
gRPC front imports ``grpc`` when it is built.
"""

from __future__ import annotations

import asyncio
import json
import logging
import sys
import threading
import time
from typing import Any, Dict, Optional

from ..http_server import HTTPServer, Request, Response, error_body
from ..metrics import Ewma
from ..payload import json_to_proto, pb, proto_to_json
from ..resilience import DEADLINE_HEADER, Deadline, ShedError, deadline_from_request
from .client import UnitCallError
from .engine_metrics import REGISTRY, MetricsRegistry
from .executor import GraphExecutor
from .spec import PredictorSpec

logger = logging.getLogger(__name__)

READINESS_PERIOD_S = 5.0


def _tenant_header(headers) -> Optional[str]:
    """The ``Seldon-Tenant`` header's value (the HTTP layer lower-cases
    keys; gRPC metadata and direct callers may not), or None."""
    if not headers:
        return None
    tenant = str(headers.get("seldon-tenant") or headers.get("Seldon-Tenant") or "").strip()
    return tenant or None


def _pb():
    """``prediction_pb2`` itself: gRPC handler signatures need the
    message classes, and building the gRPC front may load protobuf."""
    from ..proto import prediction_pb2

    return prediction_pb2


class RequestLogger:
    """Pluggable request/response pair sink (CloudEvents-style dicts)."""

    def __init__(self, sink=None):
        self.sink = sink

    @classmethod
    def from_env(cls) -> "RequestLogger":
        """CloudEvents POST sink when SELDON_MESSAGE_LOGGING_SERVICE is set;
        no-op logger otherwise."""
        import os

        url = os.environ.get("SELDON_MESSAGE_LOGGING_SERVICE")
        if not url:
            return cls()
        from ..request_logging import CloudEventsSink

        return cls(CloudEventsSink(url))

    def log(self, puid: str, request: Dict, response: Dict) -> None:
        if self.sink is None:
            return
        from ..payload import jsonable

        try:
            self.sink(
                {
                    "specversion": "1.0",
                    "type": "seldon.message.pair",
                    "id": puid,
                    "data": {"request": jsonable(request), "response": jsonable(response)},
                }
            )
        except Exception as e:  # noqa: BLE001 - logging must not break serving
            logger.warning("request logging failed: %s", e)


def _cuda_summary() -> Optional[Dict[str, Any]]:
    """This process's CUDA device, its memory and the flash kernel's
    launch counts, once the process has used the card (None before, and
    on the CPU): what a control plane reads to see that a member runs on
    the card."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    fa = sys.modules.get("seldon_core_tpu_torch.ops.flash_attention")
    dev = torch.cuda.current_device()
    return {
        "name": torch.cuda.get_device_name(dev),
        "index": dev,
        "memory_allocated": torch.cuda.memory_allocated(dev),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "memory_reserved": torch.cuda.memory_reserved(dev),
        "kernel_launches": dict(fa.LAUNCHES) if fa is not None else {},
    }


class EngineApp:
    def __init__(
        self,
        spec: PredictorSpec,
        registry: Optional[Dict[str, Any]] = None,
        metrics: MetricsRegistry = REGISTRY,
        request_logger: Optional[RequestLogger] = None,
        batching: Optional[Dict[str, Dict]] = None,
        mesh=None,
        faults=None,
    ):
        if batching is None:
            # annotation-driven config, the reference's feature-flag idiom
            # (seldon.io/microbatch* — InternalPredictionService.java:82-91)
            from .batching import batching_from_annotations

            batching = batching_from_annotations(spec)
        self.spec = spec
        self.executor = GraphExecutor(
            spec, registry=registry, batching=batching, mesh=mesh, metrics=metrics,
            faults=faults,
        )
        self.metrics = metrics
        self.request_logger = request_logger or RequestLogger()
        self.paused = False
        self.graph_ready = True
        # in-flight request gauge: rolling updates pause the engine then
        # wait for this to hit zero before tearing the graph down
        # (reference's preStop `curl /pause; sleep 10` drain idiom,
        # seldondeployment_engine.go:173-177 — here the wait is exact).
        # Mutated from the event loop AND stream-iterator executor threads,
        # so updates go through _inflight_add's lock.
        self.inflight = 0
        self._inflight_lock = threading.Lock()
        self._ready_task: Optional[asyncio.Task] = None
        # admission control: seldon.io/max-inflight caps concurrent predict
        # calls — excess gets a fast 429 (REST, with Retry-After) /
        # RESOURCE_EXHAUSTED (gRPC) instead of queueing behind the device.
        # Off (0) by default: unbounded queueing is the reference's behavior.
        from .executor import _ann_int

        self.max_inflight = _ann_int(
            getattr(spec, "annotations", None) or {}, "seldon.io/max-inflight"
        ) or 0
        # deadline budgets + deadline-aware load shedding: the observed
        # per-request service time (EWMA) turns queue depth into an
        # expected wait; a request whose remaining budget is below it is
        # shed with 429 BEFORE any graph work (shed-before-work).
        # ``seldon.io/shed-on-deadline: "false"`` opts out.
        self._ann = getattr(spec, "annotations", None) or {}
        self._service_ewma = Ewma(alpha=0.1)
        # shed decisions need a LIVE estimate: only admitted requests
        # update the EWMA, so a shed-everything state would freeze it and
        # latch the 429 forever. When nothing has been admitted within
        # the probe window, one request is let through to re-measure.
        self._shed_probe_s = 5.0
        self._last_admit_t = 0.0
        self.shed_on_deadline = (
            str(self._ann.get("seldon.io/shed-on-deadline", "true")).lower()
            != "false"
        )
        # progressive delivery (a rollout's shadow mirror) is not ported:
        # the mirror stays None, one attribute check on the hot path.
        # While a mirror is live, fused segments fall back to the per-unit
        # walk so a divergence verdict can never implicate the fusion
        # planner (fusion.py's "shadow" fallback reason)
        self.shadow_mirror = None
        self.executor.shadow_active_fn = lambda: self.shadow_mirror is not None

    def _inflight_add(self, n: int) -> None:
        with self._inflight_lock:
            self.inflight += n

    def units_with(self, attr: str):
        """``(unit name, user object)`` of every in-process unit exposing
        ``attr`` (the swap and drain routes use it)."""
        try:
            for rt in self.executor._walk(self.executor.root):
                target = getattr(rt.client, "user_object", None)
                if target is not None and hasattr(target, attr):
                    yield rt.name, target
        except Exception:  # noqa: BLE001 - a half-built graph during teardown
            return

    def fleet_summary(self) -> Dict[str, Any]:
        """The ``/fleet`` payload: this member's whole metric state
        (mergeable: counters, gauges, histogram bucket arrays) plus each
        unit's device-time ledger summary, SLO burn feed and retune
        census beside its current knob values. Each unit's pending
        ``metrics()`` deltas are flushed first, so a scrape between
        requests sees fresh ledger and burn state."""
        units: Dict[str, Any] = {}
        for _name, target in self.units_with("metrics"):
            self._flush_unit_metrics(target)
        for name, target in self.units_with("profiler"):
            prof = target.profiler
            if prof is not None and prof.enabled:
                units.setdefault(name, {})["profiler"] = prof.summary()
        for name, target in self.units_with("slo_burn"):
            burn = target.slo_burn
            if burn is not None:
                units.setdefault(name, {})["slo_burn"] = burn.summary()
        for name, target in self.units_with("serving_config"):
            cfg = target.serving_config()
            if cfg is not None:
                units.setdefault(name, {})["planning"] = {
                    "config": cfg, "census": target.retune_census()}
        out = {
            "predictor": self.spec.name,
            "metrics": self.metrics.fleet_snapshot(),
            "units": units,
        }
        device = _cuda_summary()
        if device is not None:
            out["device"] = device
        return out

    def _flush_unit_metrics(self, unit) -> None:
        """Fold one in-process unit's ``metrics()`` deltas into the
        registry outside the response path: after a drain or a migration
        import the unit may never answer the request that would carry
        them."""
        fn = getattr(unit, "metrics", None)
        if fn is None:
            return
        try:
            self.metrics.record_custom(fn(), {"deployment": self.spec.name})
        except Exception:  # noqa: BLE001 - telemetry must not fail the operation
            logger.exception("unit metrics flush failed")

    # -- core entrypoints (shared by REST and gRPC fronts) ------------------

    def _shed_wait_s(self, deadline: Optional[Deadline]) -> Optional[float]:
        """Expected completion time when it already exceeds the request's
        remaining budget (the shed-before-work decision), else None.
        Expected time = queue wait (inflight over capacity x observed
        service time) + one service time; with no max-inflight cap there
        is no queue — only a request that cannot finish even unqueued
        (service estimate alone over budget) is shed."""
        if deadline is None or not self.shed_on_deadline:
            return None
        ewma = self._service_ewma.value
        if ewma <= 0.0:
            return None  # no estimate yet: never shed blind
        if time.monotonic() - self._last_admit_t > self._shed_probe_s:
            # stale estimate (everything recently shed, or idle): admit a
            # probe so the EWMA re-tracks reality — otherwise a transient
            # slowdown could latch the deployment into 429s forever
            return None
        queue_factor = (self.inflight / self.max_inflight) if self.max_inflight else 0.0
        est = (queue_factor + 1.0) * ewma
        return est if est > deadline.remaining() else None

    async def predict(self, message: Dict[str, Any],
                      headers: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
        from ..tracing import get_tracer

        t0 = time.perf_counter()
        labels = {"deployment": self.spec.name}
        if self.max_inflight and self.inflight >= self.max_inflight:
            # bounded admission: reject NOW so client-visible latency tracks
            # service time, not queue depth; clients back off and retry
            self.metrics.counter_inc("seldon_api_engine_server_rejected", labels)
            raise UnitCallError(
                429, f"over capacity: {self.inflight} in-flight "
                f"(seldon.io/max-inflight={self.max_inflight})"
            )
        deadline = deadline_from_request(headers, self._ann)
        # tenant routing: the Seldon-Tenant header rides the message meta
        # to every unit, so a multi-tenant generate server sees the id
        # without the HTTP layer leaking into the executor
        tenant = _tenant_header(headers)
        if tenant:
            from ..serving.weightpager import stamp_tenant_meta

            message = stamp_tenant_meta(message, tenant)
        est = self._shed_wait_s(deadline)
        if est is not None:
            self.metrics.counter_inc("seldon_api_engine_server_rejected", labels)
            self.metrics.counter_inc("seldon_engine_load_shed", labels)
            err = UnitCallError(
                429,
                f"deadline {deadline.remaining_ms()}ms below estimated "
                f"completion {est * 1000:.0f}ms — shed before work",
            )
            err.retry_after_s = est
            raise err
        self._last_admit_t = time.monotonic()
        self._inflight_add(1)
        completed = False
        try:
            with get_tracer().span(
                "predictions", tags={"deployment": self.spec.name}, headers=headers
            ):
                # positional-compatible call when no deadline is in play
                # (test doubles and subclasses wrap predict(message))
                if deadline is None:
                    out = await self.executor.predict(message)
                else:
                    out = await self.executor.predict(message, deadline=deadline)
            completed = True
        except UnitCallError as e:
            self.metrics.counter_inc("seldon_api_engine_server_errors", labels)
            if e.status == 504:
                self.metrics.counter_inc("seldon_engine_deadline_exceeded", labels)
            elif e.status == 429:
                # only downstream sheds reach here (the engine-level shed
                # raised before the try): a batcher admit-queue rejection
                # must land in the same shed series the gate feeds, or
                # dashboards undercount the unary hot path
                self.metrics.counter_inc("seldon_engine_load_shed", labels)
            raise
        except Exception:
            # a unit raising outside the UnitCallError contract (bad
            # payload, over-bucket prompt) is still a failed request: the
            # errors series must see it or error-rate gates (the rollout
            # controller's) undercount exactly the requests that broke
            self.metrics.counter_inc("seldon_api_engine_server_errors", labels)
            raise
        finally:
            self._inflight_add(-1)
            dur = time.perf_counter() - t0
            # the shed gate's estimate tracks SUCCESSFUL service time
            # only: a deadline-capped 504 lasts exactly the deadline and
            # a downstream 429 returns in microseconds — feeding either
            # in would drag the estimate toward the failure path and
            # defeat shed-before-work for the very traffic it protects
            if completed:
                self._service_ewma.update(dur)
            self.metrics.observe(
                "seldon_api_engine_server_requests_seconds", dur, labels
            )
        self.metrics.counter_inc("seldon_api_engine_server_requests", labels)
        self.metrics.record_custom((out.get("meta") or {}).get("metrics"), labels)
        self.request_logger.log((out.get("meta") or {}).get("puid", ""), message, out)
        if self.shadow_mirror is not None:
            self.shadow_mirror.submit(message, out)
        return out

    async def send_feedback(self, feedback: Dict[str, Any]) -> Dict[str, Any]:
        self._inflight_add(1)
        try:
            out = await self.executor.send_feedback(feedback)
            self.metrics.counter_inc(
                "seldon_api_engine_server_feedback_reward",
                {"deployment": self.spec.name},
                float(feedback.get("reward", 0.0)),
            )
            return out
        finally:
            self._inflight_add(-1)

    # -- readiness loop -----------------------------------------------------

    async def _readiness_loop(self):
        while True:
            try:
                self.graph_ready = await self.executor.ready()
            except Exception:
                self.graph_ready = False
            await asyncio.sleep(READINESS_PERIOD_S)

    def start_readiness_loop(self):
        self._ready_task = asyncio.ensure_future(self._readiness_loop())

    # -- REST front ---------------------------------------------------------

    def rest_app(self) -> HTTPServer:
        from .executor import _ann_int, _ann_seconds

        # request-size / read-timeout limits come off predictor annotations
        # like the reference's message-size knobs
        # (InternalPredictionService.java:82-91); the default cap stops a
        # single Content-Length from OOMing the engine
        ann = getattr(self.spec, "annotations", None) or {}
        from ..http_server import max_body_from_env

        max_body = _ann_int(ann, "seldon.io/rest-max-body")
        if not max_body or max_body <= 0:  # junk/non-positive -> default
            max_body = max_body_from_env()
        # DEDICATED server-side knob: seldon.io/rest-read-timeout keeps its
        # pre-existing meaning (client timeout on engine->unit hops,
        # executor.py) — reusing it here would retune existing deployments'
        # server front behind their backs
        read_timeout = _ann_seconds(ann, "seldon.io/rest-server-read-timeout", 0.0)
        if read_timeout <= 0:  # junk/negative/absent -> no server timeout
            read_timeout = None
        app = HTTPServer(
            "engine-rest", max_body_bytes=max_body, read_timeout_s=read_timeout
        )

        if self.max_inflight or self.shed_on_deadline:
            labels = {"deployment": self.spec.name}

            def admission_gate(method: str, path: str, headers) -> Optional[Response]:
                # shed load from the HEADERS: a rejected request's body is
                # discarded unparsed (see HTTPServer.early_gate). predict()
                # re-checks, so gate races only cost a parse, not capacity.
                if method != "POST" or path != "/api/v0.1/predictions":
                    return None
                if self.max_inflight and self.inflight >= self.max_inflight:
                    self.metrics.counter_inc(
                        "seldon_api_engine_server_rejected", labels
                    )
                    return Response(
                        error_body(
                            429,
                            f"over capacity: {self.inflight} in-flight "
                            f"(seldon.io/max-inflight={self.max_inflight})",
                        ),
                        429,
                        headers={"Retry-After": "1"},
                    )
                # deadline-aware shed, also from the headers: the budget
                # rides Seldon-Deadline-Ms, so an unmeetable request is
                # answered without even reading its body. Only an EXPLICIT
                # header sheds here (the annotation default is handled in
                # predict(), which sees every route) — and without one the
                # hot path skips the deadline parse entirely
                if headers.get(DEADLINE_HEADER) is None:
                    return None
                deadline = deadline_from_request(headers, self._ann)
                est = self._shed_wait_s(deadline)
                if est is not None:
                    self.metrics.counter_inc(
                        "seldon_api_engine_server_rejected", labels
                    )
                    self.metrics.counter_inc("seldon_engine_load_shed", labels)
                    return Response(
                        error_body(
                            429,
                            f"deadline {deadline.remaining_ms()}ms below "
                            f"estimated completion {est * 1000:.0f}ms — "
                            "shed before work",
                        ),
                        429,
                        headers={"Retry-After": str(max(1, int(est + 0.5)))},
                    )
                return None

            app.early_gate = admission_gate

        PROTO_TYPES = ("application/x-protobuf", "application/octet-stream")

        async def predictions(req: Request) -> Response:
            if self.paused:
                return Response(error_body(503, "paused"), 503)
            ctype = (req.headers.get("content-type") or "").split(";")[0].strip()
            binary = ctype in PROTO_TYPES
            if binary:
                # binary SeldonMessage body: no JSON text parse, and raw
                # tensors cross the wire as bytes instead of base64 — the
                # zero-copy encoding's REST transport
                try:
                    body = proto_to_json(pb.SeldonMessage.FromString(req.body))
                except Exception as e:  # noqa: BLE001 - malformed proto
                    return Response(error_body(400, f"bad protobuf body: {e}"), 400)
            else:
                body = req.json()
            if body is None:
                return Response(error_body(400, "empty request body"), 400)
            try:
                out = await self.predict(body, headers=req.headers)
            except UnitCallError as e:
                hdrs = None
                if e.status in (429, 503):
                    # 429 = shed before work; 503 = transient
                    # unavailability with a known horizon — a dead/
                    # restarting batcher (BatcherDead.retry_after_s) or
                    # an open breaker. Both carry Retry-After so clients
                    # back off instead of hammering a recovering member.
                    after = getattr(e, "retry_after_s", None)
                    hdrs = {"Retry-After": str(max(1, int(after + 0.5)))
                            if after else "1"}
                err = error_body(e.status, e.info)
                # a mid-graph failure (504 deadline, 503 breaker) reports
                # the PARTIAL requestPath — how far the walk got — so tail
                # failures are attributable to a hop, not just a status
                meta = getattr(e, "meta", None)
                if meta:
                    err["meta"] = meta
                return Response(err, e.status, headers=hdrs)
            if binary:
                return Response(
                    json_to_proto(out).SerializeToString(),
                    content_type="application/x-protobuf",
                )
            return Response(out)

        async def feedback(req: Request) -> Response:
            if self.paused:
                return Response(error_body(503, "paused"), 503)
            body = req.json()
            if body is None:
                return Response(error_body(400, "empty request body"), 400)
            return Response(await self.send_feedback(body))

        async def inflight(req: Request) -> Response:
            # drain probe: a runtime replacing this engine polls here after
            # /pause until live work hits zero (exact preStop drain)
            return Response({"inflight": self.inflight, "paused": self.paused})

        async def ready(req: Request) -> Response:
            if self.paused or not self.graph_ready:
                return Response(error_body(503, "not ready"), 503)
            return Response({"status": "ok"})

        async def live(req: Request) -> Response:
            return Response({"status": "ok"})

        async def ping(req: Request) -> Response:
            return Response("pong", content_type="text/plain")

        async def pause(req: Request) -> Response:
            self.paused = True
            return Response({"status": "paused"})

        async def unpause(req: Request) -> Response:
            self.paused = False
            return Response({"status": "ok"})

        async def prometheus(req: Request) -> Response:
            return Response(self.metrics.expose(), content_type="text/plain; version=0.0.4")

        async def traces(req: Request) -> Response:
            # filterable span buffer: ?operation=<substring>&limit=<N most
            # recent spans>&since_us=<epoch us> — a 4096-span ring is
            # inspectable without dumping it whole
            from ..tracing import get_tracer

            return Response(get_tracer().export_jaeger(
                operation=req.params().get("operation"),
                limit=req.int_param("limit"),
                since_us=req.int_param("since_us"),
            ))

        async def openapi(req: Request) -> Response:
            from ..openapi import engine_spec

            return Response(engine_spec(served_paths=app.routes))

        app.add_route("/api/v0.1/predictions", predictions)
        app.add_route("/api/v1.0/predictions", predictions)
        app.add_route("/predict", predictions)
        app.add_route("/api/v0.1/feedback", feedback)
        app.add_route("/api/v1.0/feedback", feedback)
        app.add_route("/ready", ready)
        app.add_route("/live", live)
        app.add_route("/ping", ping)
        async def generate_stream(req: Request):
            """SSE token streaming for single-node GENERATE_SERVER graphs:
            each credited token span arrives as `data: {"tokens": [...]}`
            and the stream ends with `data: {"done": true, ...}`. Unary
            graphs (or multi-node ones) 501 — streaming can't flow through
            transformer hops."""
            from ..http_server import StreamingResponse

            if self.paused:
                return Response(error_body(503, "paused"), 503)
            target = getattr(self.executor.root.client, "user_object", None)
            if target is None or not hasattr(target, "stream"):
                return Response(
                    error_body(
                        501,
                        "streaming needs a single in-process GENERATE_SERVER graph",
                    ),
                    501,
                )
            body = req.json()
            if body is None:
                return Response(error_body(400, "empty request body"), 400)
            if "jsonData" in body:
                body = body["jsonData"]
            tenant = _tenant_header(req.headers)
            if tenant:
                from ..serving.weightpager import stamp_tenant_meta

                body = stamp_tenant_meta(body, tenant)
            try:
                # stream() validates AND submits eagerly — malformed bodies
                # and dead batchers raise here, before any bytes go out
                handle = target.stream(body)
            except ShedError as e:
                # admit-queue shed: same 429 + Retry-After contract as the
                # unary path, decided before any stream bytes exist
                self.metrics.counter_inc(
                    "seldon_engine_load_shed", {"deployment": self.spec.name}
                )
                return Response(
                    error_body(429, str(e)), 429,
                    headers={"Retry-After": str(max(1, int(e.retry_after_s + 0.5)))},
                )
            except Exception as e:  # noqa: BLE001 - typed vs bad-request split
                status = getattr(e, "status", None)
                if status == 503:
                    # dead/restarting batcher (BatcherDead) or a typed
                    # transport refusal: transient — 503 + Retry-After,
                    # exactly like the unary path, never a client-fault 400
                    after = getattr(e, "retry_after_s", None)
                    return Response(
                        error_body(503, str(e)), 503,
                        headers={"Retry-After": str(max(1, int(after + 0.5)))
                                 if after else "1"},
                    )
                if status in (400, 404, 409, 413):
                    # a malformed resume token (400), an unknown tenant
                    # (404), a resume token of another weight version
                    # (409), an over-bucket prompt or prompt+budget past
                    # max_seq (413): the typed statuses the unary path
                    # answers
                    return Response(error_body(status, str(e)), status)
                if isinstance(e, (ValueError, RuntimeError)):
                    return Response(error_body(400, str(e)), 400)
                raise

            # in-flight from SUBMISSION (the decode lane is already
            # occupied), not from the first pulled chunk — a rolling-update
            # drain polling between submit and first pull must see it. The
            # generator is the single decrementer; the connection handler
            # guarantees it runs (it drains/starts the iterator even on
            # abort), so the pair always balances.
            self._inflight_add(1)

            def sse():
                try:
                    for chunk in handle.chunks:
                        yield b"data: " + json.dumps(chunk).encode() + b"\n\n"
                finally:
                    self._inflight_add(-1)

            # on client disconnect the server cancels the request, which
            # frees the decode lane and unblocks the generator's queue
            return StreamingResponse(sse(), on_abort=handle.cancel)

        app.add_route("/pause", pause)
        app.add_route("/unpause", unpause)
        app.add_route("/inflight", inflight)
        app.add_route("/api/v0.1/generate", generate_stream)
        app.add_route("/api/v1.0/generate", generate_stream)
        app.add_route("/metrics", prometheus)
        app.add_route("/prometheus", prometheus)
        app.add_route("/traces", traces)
        app.add_route("/weights/swap", self._weights_swap_route)
        app.add_route("/drain", self._drain_route)
        app.add_route("/retune", self._retune_route)
        app.add_route("/flightrecorder", self._flightrecorder_route)
        app.add_route("/fleet", self._fleet_route)
        app.add_route("/openapi.json", openapi)
        return app

    async def _flightrecorder_route(self, req: Request) -> Response:
        """Every in-process unit's scheduler flight recorder, keyed by unit
        name (``?limit=`` caps the entries per unit); 404 when no unit has
        one on."""
        limit = req.int_param("limit")
        units: Dict[str, Any] = {}
        for name, target in self.units_with("flight_dump"):
            dump = target.flight_dump(limit)
            if dump is not None:
                units[name] = dump
        # fusion records live on the EXECUTOR, not on a unit: a reserved
        # pseudo-unit key keeps one payload shape
        if self.executor.fusion is not None:
            units["(fusion)"] = self.executor.fusion.dump(limit)
        if not units:
            return Response(error_body(404, "no unit exposes a flight recorder"), 404)
        return Response({"units": units})

    async def _fleet_route(self, req: Request) -> Response:
        return Response(self.fleet_summary())

    async def _retune_route(self, req: Request) -> Response:
        """POST ``{"knobs": {...}, "origin": "...", "wait_s": 10}``: stage a
        validated live retune on every unit exposing ``retune`` and wait
        (off the event loop) until each applies it at a poll boundary. 400
        without knobs, 409 for a value outside a unit's boot census
        (``RetuneError``), 501 when no unit retunes."""
        from ..serving.continuous import RetuneError

        body = req.json() or {}
        knobs = body.get("knobs")
        if not isinstance(knobs, dict) or not knobs:
            return Response(error_body(400, "need 'knobs' (non-empty object)"), 400)
        origin = str(body.get("origin", "planner"))
        wait_s = float(body.get("wait_s", 10.0))
        loop = asyncio.get_running_loop()
        units: Dict[str, Any] = {}
        for name, target in self.units_with("retune"):
            try:
                units[name] = await loop.run_in_executor(
                    None, lambda f=target.retune: f(knobs, origin, wait_s))
                self._flush_unit_metrics(target)
            except RetuneError as e:
                return Response(error_body(409, f"{name}: {e}"), 409)
            except Exception as e:  # noqa: BLE001 - the apply failed
                status = getattr(e, "status", None) or 502
                return Response(error_body(status, f"{name}: {e}"), status)
        if not units:
            return Response(error_body(501, "no unit supports retune"), 501)
        return Response({"units": units})

    async def _weights_swap_route(self, req: Request) -> Response:
        """Live weight swap for units exposing ``hot_swap``: POST
        ``{"model_uri": "...", "wait_s": 30}`` stages the checkpoint and
        flips at a scheduler poll boundary (in-flight lanes finish on the
        old version); ``{"cancel": true}`` aborts a staged swap whose
        drain does not converge."""
        body = req.json() or {}
        if body.get("cancel"):
            cancels = {name: unit.cancel_hot_swap()
                       for name, unit in self.units_with("cancel_hot_swap")}
            if not cancels:
                return Response(error_body(501, "no unit supports weight hot-swap"), 501)
            return Response({"units": cancels})
        uri = body.get("model_uri")
        if not uri:
            return Response(error_body(400, "need model_uri"), 400)
        wait_s = float(body.get("wait_s", 30.0))
        loop = asyncio.get_running_loop()
        units: Dict[str, Any] = {}
        for name, unit in self.units_with("hot_swap"):
            try:
                # checkpoint load and upload block: off the event loop
                units[name] = await loop.run_in_executor(
                    None, lambda f=unit.hot_swap: f(uri, wait_s))
            except Exception as e:  # noqa: BLE001 - a bad checkpoint
                # units swapped before the failure ARE on the new weights
                detail = f"{name}: {e}"
                if units:
                    detail += f" (units already swapped: {sorted(units)})"
                return Response(error_body(400, detail), 400)
        if not units:
            return Response(error_body(501, "no unit supports weight hot-swap"), 501)
        return Response({"units": units})

    async def _drain_route(self, req: Request) -> Response:
        """Live-lane migration, two modes:
        ``{"to": "host:port"}`` (source: checkpoint every in-flight
        generation and hand it to the peer engine; the member turns
        ``draining`` and refuses new work with a 503), and
        ``{"checkpoints": [<base64 SGC1>, ...]}`` (import: resume each
        checkpoint here and answer the final token lists once all are
        done). An import parses every frame and checks its
        ``weight_version`` before it admits any."""
        body = req.json() or {}
        loop = asyncio.get_running_loop()
        if "checkpoints" in body:
            return await self._drain_import(body, loop)
        peer = body.get("to")
        units: Dict[str, Any] = {}
        for name, unit in self.units_with("drain_to"):
            if not peer:
                return Response(error_body(
                    400, "need 'to' (peer engine host:port) or 'checkpoints'"), 400)
            timeout_s = float(body.get("timeout_s", 60.0))
            try:
                units[name] = await loop.run_in_executor(
                    None, lambda f=unit.drain_to: f(peer, timeout_s))
            except Exception as e:  # noqa: BLE001 - the drain failed
                status = getattr(e, "status", None) or 502
                return Response(error_body(status, f"{name}: {e}"), status)
            # a drained member answers no further request: its drain
            # counters would never ride a response's meta
            self._flush_unit_metrics(unit)
        if not units:
            return Response(error_body(501, "no unit supports migration"), 501)
        return Response({"units": units})

    async def _drain_import(self, body: Dict[str, Any], loop) -> Response:
        from ..serving.disagg import WeightVersionMismatch
        from ..serving.migration import parse_token

        unit = next((u for _n, u in self.units_with("resume_checkpoint")), None)
        if unit is None:
            return Response(error_body(501, "no unit supports migration"), 501)
        timeout_s = float(body.get("timeout_s", 600.0))
        try:
            # all frames parsed and version-checked before any is
            # admitted: a bad one refuses the whole handoff up front
            cks = [parse_token(t) if isinstance(t, str) else t for t in body["checkpoints"]]
            serving_wv = getattr(getattr(unit, "batcher", None), "weight_version", None)
            for ck in cks:
                wv = ck.get("weight_version")
                if serving_wv is not None and wv is not None and wv != serving_wv:
                    raise WeightVersionMismatch(
                        f"checkpoint weight_version {wv!r} vs serving {serving_wv!r}")
        except Exception as e:  # noqa: BLE001 - a typed refusal
            status = getattr(e, "status", None) or 400
            return Response(error_body(status, str(e)), status)
        futures = []
        try:
            for ck in cks:
                futures.append(unit.resume_checkpoint(ck))
        except Exception as e:  # noqa: BLE001 - a typed refusal
            for f in futures:
                f.cancel()
            status = getattr(e, "status", None) or 400
            return Response(error_body(status, str(e)), status)

        def collect():
            return [f.result(timeout=timeout_s) for f in futures]

        try:
            results = await loop.run_in_executor(None, collect)
        except Exception as e:  # noqa: BLE001 - a resumed generation failed
            for f in futures:
                f.cancel()
            status = getattr(e, "status", None) or 502
            return Response(error_body(status, str(e)), status)
        self._flush_unit_metrics(unit)
        return Response({"results": results, "accepted": len(futures)})

    # -- gRPC front ---------------------------------------------------------

    def grpc_server(self, max_workers: int = 4, max_message_bytes: Optional[int] = None):
        """grpc.aio server registering the Seldon service
        (reference: SeldonGrpcServer.java:40-143).

        Honors ``seldon.io/grpc-max-message-size`` like the reference's
        SeldonGrpcServer (SeldonGrpcServer.java:40) when no explicit limit
        is passed."""
        if max_message_bytes is None:
            from .executor import _ann_int

            max_message_bytes = _ann_int(
                getattr(self.spec, "annotations", None) or {},
                "seldon.io/grpc-max-message-size",
            )
        import grpc

        options = []
        if max_message_bytes:
            options = [
                ("grpc.max_send_message_length", max_message_bytes),
                ("grpc.max_receive_message_length", max_message_bytes),
            ]
        server = grpc.aio.server(options=options)
        app = self
        pb = _pb()

        async def predict_rpc(request: pb.SeldonMessage, context):
            if app.paused:
                await context.abort(grpc.StatusCode.UNAVAILABLE, "paused")
            try:
                out = await app.predict(proto_to_json(request))
                return json_to_proto(out)
            except UnitCallError as e:
                if e.status == 429:
                    code = grpc.StatusCode.RESOURCE_EXHAUSTED
                elif e.status == 504:
                    code = grpc.StatusCode.DEADLINE_EXCEEDED
                elif e.status == 503:
                    code = grpc.StatusCode.UNAVAILABLE
                elif e.status in (400, 413):
                    # client-fault requests (over-bucket prompt,
                    # prompt+budget past max_seq): typed INVALID_ARGUMENT,
                    # never INTERNAL — retrying unchanged cannot succeed
                    code = grpc.StatusCode.INVALID_ARGUMENT
                else:
                    code = grpc.StatusCode.INTERNAL
                await context.abort(code, e.info)

        async def feedback_rpc(request: pb.Feedback, context):
            if app.paused:
                await context.abort(grpc.StatusCode.UNAVAILABLE, "paused")
            out = await app.send_feedback(proto_to_json(request))
            return json_to_proto(out)

        async def generate_stream_rpc(request: pb.SeldonMessage, context):
            """Server-streaming generate: the gRPC twin of the SSE route."""
            if app.paused:
                await context.abort(grpc.StatusCode.UNAVAILABLE, "paused")
            target = getattr(app.executor.root.client, "user_object", None)
            if target is None or not hasattr(target, "stream"):
                await context.abort(
                    grpc.StatusCode.UNIMPLEMENTED,
                    "streaming needs a single in-process GENERATE_SERVER graph",
                )
            body = proto_to_json(request)
            if "jsonData" in body:
                body = body["jsonData"]
            try:
                handle = target.stream(body)
            except (ValueError, RuntimeError) as e:
                if getattr(e, "status", None) == 503:
                    # dead/restarting batcher: transient, retryable
                    await context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
                await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            app._inflight_add(1)
            it = iter(handle.chunks)
            sentinel = object()
            loop = asyncio.get_running_loop()
            try:
                while True:
                    chunk = await loop.run_in_executor(None, next, it, sentinel)
                    if chunk is sentinel:
                        break
                    yield json_to_proto({"jsonData": chunk})
            finally:
                app._inflight_add(-1)
                # no-op on a finished future; on client cancellation this
                # releases the decode lane
                handle.cancel()

        handlers = {
            "Predict": grpc.unary_unary_rpc_method_handler(
                predict_rpc,
                request_deserializer=pb.SeldonMessage.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            ),
            "SendFeedback": grpc.unary_unary_rpc_method_handler(
                feedback_rpc,
                request_deserializer=pb.Feedback.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            ),
            "GenerateStream": grpc.unary_stream_rpc_method_handler(
                generate_stream_rpc,
                request_deserializer=pb.SeldonMessage.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            ),
        }
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler("seldontpu.Seldon", handlers),)
        )
        return server

    async def serve(self, host: str = "0.0.0.0", http_port: int = 8000,
                    grpc_port: Optional[int] = 5001):
        self.start_readiness_loop()
        servers = [self.rest_app().serve_forever(host, http_port)]
        if grpc_port:
            gsrv = self.grpc_server()
            gsrv.add_insecure_port(f"{host}:{grpc_port}")
            await gsrv.start()
        await asyncio.gather(*servers)
