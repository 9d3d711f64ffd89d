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
  * periodic graph readiness check gating /ready
    (reference: SeldonGraphReadyChecker.java:24-115, 5s fixedDelay)
  * request/response pair logging hook
  * Prometheus exposition at /prometheus, spans at /traces

The REST front needs no protobuf runtime (a binary body loads it); the
gRPC front imports ``grpc`` when it is built. The flight-recorder,
fleet, openapi, weight-swap, drain and retune routes answer 501: their
subsystems are not ported yet.
"""

from __future__ import annotations

import asyncio
import json
import logging
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
        """No-op logger; the CloudEvents POST sink that
        SELDON_MESSAGE_LOGGING_SERVICE selects in the JAX package is not
        ported yet and raises when that variable is set."""
        import os

        if os.environ.get("SELDON_MESSAGE_LOGGING_SERVICE"):
            raise NotImplementedError(
                "SELDON_MESSAGE_LOGGING_SERVICE (the CloudEvents request "
                "logger) is not ported to seldon_core_tpu_torch yet"
            )
        return cls()

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
        # the mirror stays None, one attribute check on the hot path
        self.shadow_mirror = None

    def _inflight_add(self, n: int) -> None:
        with self._inflight_lock:
            self.inflight += n

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
        if headers and (headers.get("seldon-tenant") or headers.get("Seldon-Tenant")):
            # tenant routing feeds the multi-tenant weight pager
            raise UnitCallError(
                501, "the Seldon-Tenant header (multi-tenant serving) is not "
                "ported to seldon_core_tpu_torch yet"
            )
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

        async def not_ported(req: Request) -> Response:
            return Response(
                error_body(501, f"{req.path} is not ported to "
                           "seldon_core_tpu_torch yet"),
                501,
            )

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
                if status in (413, 501):
                    # over-bucket prompt / prompt+budget past max_seq
                    # (413), a request field not ported yet (501): the
                    # typed statuses the unary path answers, not a
                    # generic 400
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
        for path in ("/flightrecorder", "/fleet", "/openapi.json",
                     "/weights/swap", "/drain", "/retune"):
            app.add_route(path, not_ported)
        return app

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
