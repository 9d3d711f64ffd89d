"""Internal unit clients: in-process, REST, gRPC.

Counterpart of ``seldon_core_tpu/graph/client.py`` and of the reference
engine's InternalPredictionService (reference:
engine/.../service/InternalPredictionService.java:186-453 — per-type
method dispatch, URI caches, 3 retries, per-annotation timeouts, cached
gRPC channels via grpc/GrpcChannelHandler.java).

Units co-located with the engine are plain Python objects, so a hop
costs a function call on a worker thread instead of a network round
trip; REST/gRPC transports cover units in other processes or hosts.
The in-process and REST clients need no protobuf runtime: the protobuf
bindings load only on a binary (``application/x-protobuf``) hop and in
:class:`GrpcClient`.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Dict, Optional

from .. import seldon_methods
from ..payload import json_to_proto, pb, proto_to_json

logger = logging.getLogger(__name__)

RETRIES = 3  # reference: InternalPredictionService.java:87-91
DEFAULT_TIMEOUT_S = 5.0

# method name -> REST path + (service, rpc) for gRPC
METHOD_TABLE = {
    "predict": ("/predict", ("Model", "Predict")),
    "transform_input": ("/transform-input", ("Transformer", "TransformInput")),
    "transform_output": ("/transform-output", ("OutputTransformer", "TransformOutput")),
    "route": ("/route", ("Router", "Route")),
    "aggregate": ("/aggregate", ("Combiner", "Aggregate")),
    "send_feedback": ("/send-feedback", ("Model", "SendFeedback")),
}


class UnitClient:
    """Calls one graph unit. Messages are JSON-style dicts internally."""

    async def call(self, method: str, message: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError

    async def ready(self) -> bool:
        return True

    async def close(self) -> None:
        pass


class InProcessClient(UnitClient):
    def __init__(self, user_object, executor=None):
        self.user_object = user_object
        self._executor = executor

    async def call(self, method: str, message: Dict[str, Any]) -> Dict[str, Any]:
        import contextvars

        fn = getattr(seldon_methods, method)
        loop = asyncio.get_running_loop()
        # run under a COPY of the caller's context: run_in_executor does
        # not propagate contextvars, which would strand the active trace
        # span on the event loop — in-process components (the generate
        # server threading request timelines into its scheduler) need the
        # graph-hop span visible on the worker thread
        ctx = contextvars.copy_context()
        return await loop.run_in_executor(
            self._executor, ctx.run, fn, self.user_object, message
        )

    def accepts_device_arrays(self) -> bool:
        """True when this unit is an in-process TorchComponent with a loaded
        forward: the micro-batcher can then put request slabs on the device
        at arrival and hand the fused hop a device tensor under the
        ``__torch__`` message key."""
        from ..user_model import TorchComponent

        return (
            isinstance(self.user_object, TorchComponent)
            and self.user_object._apply is not None
        )

    def device_put(self, arr):
        """Host slab -> device, through the component's own input transform
        (its device and compute-dtype cast), so the fused forward sees
        exactly what a request alone would."""
        return self.user_object._to_dev(arr)

    async def ready(self) -> bool:
        from ..user_model import client_health_status

        try:
            client_health_status(self.user_object)
            return True
        except Exception:
            return False


class RestClient(UnitClient):
    """Keep-alive HTTP/1.1 client on raw asyncio streams (no aiohttp in image).

    ``retries`` is the INNER connection-level attempt count (the
    reference's hardcoded 3). When a resilience RetryPolicy wraps this
    client, the executor passes ``retries=1`` so the two layers don't
    stack multiplicatively (3 policy retries x 3 transport retries = 12
    connects per request against a down unit, with the breaker seeing
    only a third of the real failures)."""

    def __init__(self, host: str, port: int, timeout: float = DEFAULT_TIMEOUT_S,
                 retries: int = RETRIES):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.retries = max(1, int(retries))
        self._pool: asyncio.Queue = asyncio.Queue()

    async def _connection(self):
        try:
            while True:
                reader, writer = self._pool.get_nowait()
                if not writer.is_closing():
                    return reader, writer
        except asyncio.QueueEmpty:
            pass
        return await asyncio.open_connection(self.host, self.port, limit=64 * 1024 * 1024)

    async def _request(self, path: str, body: bytes,
                       ctype: str = "application/json") -> Dict[str, Any]:
        from ..tracing import get_tracer

        reader, writer = await self._connection()
        pooled = False
        try:
            # propagate the active span across the process hop (reference:
            # TracingRestTemplateInterceptor, InternalPredictionService.java:141-144)
            trace_headers = get_tracer().inject({})
            extra = "".join(f"{k}: {v}\r\n" for k, v in trace_headers.items())
            head = (
                f"POST {path} HTTP/1.1\r\nHost: {self.host}\r\n"
                f"Content-Type: {ctype}\r\nContent-Length: {len(body)}\r\n"
                f"{extra}\r\n"
            ).encode()
            writer.write(head + body)
            await writer.drain()
            status_line = await reader.readline()
            status = int(status_line.split(b" ", 2)[1])
            length = 0
            resp_ctype = ""
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                key = k.strip().lower()
                if key == "content-length":
                    length = int(v)
                elif key == "content-type":
                    resp_ctype = v.strip().split(";")[0]
            payload = await reader.readexactly(length)
            self._pool.put_nowait((reader, writer))
            pooled = True
            if status >= 400:
                raise UnitCallError(status, payload.decode("utf-8", "replace"))
            if resp_ctype in ("application/x-protobuf", "application/octet-stream"):
                return proto_to_json(pb.SeldonMessage.FromString(payload))
            return json.loads(payload)
        finally:
            # Anything that prevented pooling (connection error, timeout
            # cancellation from wait_for, parse error) closes the socket —
            # a half-read connection must never return to the pool.
            if not pooled:
                writer.close()

    async def engine_predict(self, message: Dict[str, Any]) -> Dict[str, Any]:
        """POST to an ENGINE's external predictions route (the ingest tier
        and batch scorers talk to engines, not bare units). Deadline-bound
        like call(): a wedged engine must surface as an error the caller's
        retry/dead-letter path can act on, not an eternal hang."""
        return await asyncio.wait_for(
            self._request(
                "/api/v0.1/predictions",
                json.dumps(message, separators=(",", ":")).encode(),
            ),
            self.timeout,
        )

    async def call(self, method: str, message: Dict[str, Any]) -> Dict[str, Any]:
        from ..payload import has_raw_bytes, jsonable

        path, _ = METHOD_TABLE[method]
        if method != "send_feedback" and has_raw_bytes(message):
            # zero-copy hop: raw tensor bytes go as a binary SeldonMessage
            # body (the wrapper's application/x-protobuf route) — no
            # base64, no JSON text on the unit hop
            body = json_to_proto(message).SerializeToString()
            ctype = "application/x-protobuf"
        elif method == "aggregate" and any(
            has_raw_bytes(m) for m in message.get("seldonMessages", ())
        ):
            # combiner hop: the message list serializes via the recursive
            # SeldonMessageList builder, keeping every tensor binary
            body = json_to_proto(message, pb.SeldonMessageList).SerializeToString()
            ctype = "application/x-protobuf"
        else:
            body = json.dumps(jsonable(message), separators=(",", ":")).encode()
            ctype = "application/json"
        last_err: Optional[Exception] = None
        for attempt in range(self.retries):
            try:
                return await asyncio.wait_for(
                    self._request(path, body, ctype), self.timeout
                )
            except UnitCallError:
                raise  # application error: do not retry
            except Exception as e:  # connection/timeout: retry
                last_err = e
                logger.warning(
                    "REST %s:%d%s attempt %d failed: %s", self.host, self.port, path, attempt, e
                )
        raise UnitCallError(
            503, f"unit unreachable after {self.retries} tries: {last_err}"
        )

    async def ready(self) -> bool:
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port), 2.0
            )
            writer.write(b"GET /ready HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
            await writer.drain()
            line = await reader.readline()
            writer.close()
            return b" 200 " in line
        except Exception:
            return False

    async def close(self) -> None:
        while not self._pool.empty():
            _, writer = self._pool.get_nowait()
            writer.close()


async def engine_predict_url(url: str, message: Dict[str, Any],
                             timeout: float = DEFAULT_TIMEOUT_S * 2) -> Dict[str, Any]:
    """One-shot POST to an ENGINE's predictions route by URL
    (``http://host:port``): a connection per call, so there is no pool
    to leak when the caller goes away."""
    rest = url.split("//", 1)[-1]
    host, _, port = rest.partition(":")
    client = RestClient(host, int(port or 80), timeout=timeout, retries=1)
    try:
        return await client.engine_predict(message)
    finally:
        await client.close()


class GrpcClient(UnitClient):
    """grpc.aio channel with generic method stubs; dict<->proto at the edge."""

    def __init__(self, host: str, port: int, timeout: float = DEFAULT_TIMEOUT_S,
                 max_message_bytes: Optional[int] = None):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.max_message_bytes = max_message_bytes
        self._channel = None
        self._stubs: Dict[str, Any] = {}

    @property
    def channel(self):
        # Lazily created: grpc.aio channels bind to the running event loop,
        # and the executor is constructed before the loop starts.
        if self._channel is None:
            import grpc

            options = []
            if self.max_message_bytes:
                options = [
                    ("grpc.max_send_message_length", self.max_message_bytes),
                    ("grpc.max_receive_message_length", self.max_message_bytes),
                ]
            self._channel = grpc.aio.insecure_channel(
                f"{self.host}:{self.port}", options=options
            )
        return self._channel

    def _stub(self, method: str):
        if method not in self._stubs:
            from ..proto import services as svc

            _, (service, rpc) = METHOD_TABLE[method]
            req_cls, resp_cls = svc.SERVICES[service][rpc]
            self._stubs[method] = (
                self.channel.unary_unary(
                    svc.method_path(service, rpc),
                    request_serializer=lambda m: m.SerializeToString(),
                    response_deserializer=resp_cls.FromString,
                ),
                req_cls,
            )
        return self._stubs[method]

    # gRPC status -> wire status, so retry/breaker classification (and the
    # engine's error mapping) treat gRPC units exactly like REST ones —
    # AioRpcError itself carries no int ``status`` and would otherwise
    # make every resilience policy a silent no-op on GRPC transports
    _GRPC_STATUS_HTTP = {
        "UNAVAILABLE": 503,
        "DEADLINE_EXCEEDED": 504,
        "RESOURCE_EXHAUSTED": 429,
        "UNIMPLEMENTED": 501,
        "INVALID_ARGUMENT": 400,
        "NOT_FOUND": 404,
    }

    async def call(self, method: str, message: Dict[str, Any]) -> Dict[str, Any]:
        import grpc

        stub, req_cls = self._stub(method)
        proto_req = json_to_proto(message, req_cls)
        try:
            resp = await stub(proto_req, timeout=self.timeout)
        except grpc.aio.AioRpcError as e:
            code = e.code()
            status = self._GRPC_STATUS_HTTP.get(code.name, 500)
            raise UnitCallError(
                status, f"gRPC {code.name}: {e.details()}"
            ) from e
        return proto_to_json(resp)

    async def ready(self) -> bool:
        try:
            await asyncio.wait_for(self.channel.channel_ready(), 2.0)
            return True
        except Exception:
            return False

    async def close(self) -> None:
        if self._channel is not None:
            await self._channel.close()


class UnitCallError(RuntimeError):
    """A unit call failed with a wire status.

    The resilience layer (resilience/) attaches two optional fields when
    it converts its own failures at the executor boundary:

    * ``meta`` — the request's PARTIAL accumulated meta (requestPath up
      to the failing hop) for 504/503 attribution in error bodies;
    * ``retry_after_s`` — the estimated wait behind a 429 load shed,
      surfaced to clients as the ``Retry-After`` header.
    """

    def __init__(self, status: int, info: str):
        super().__init__(info)
        self.status = status
        self.info = info
        self.meta: Optional[Dict[str, Any]] = None
        self.retry_after_s: Optional[float] = None
