"""REST and gRPC fronts around a user component.

Counterpart of ``seldon_core_tpu/wrapper.py``. REST routes: ``/predict`` (and ``/api/v1.0/predictions``,
``/api/v0.1/predictions``), ``/transform-input``, ``/transform-output``,
``/route``, ``/aggregate``, ``/send-feedback``, ``/explain``, plus
``/health/status``, ``/ready``, ``/live``, ``/pause``, ``/unpause``.
JSON bodies take the protobuf-free path; a binary ``SeldonMessage`` body
(``application/x-protobuf``) is transcoded at the edge.

:func:`get_grpc_server` serves the seven component services of
``proto/services.py`` (imports ``grpc`` and protobuf when called);
:func:`grpc_stub` builds a client callable in place of generated stubs.
"""

from __future__ import annotations

import asyncio
import logging
from concurrent import futures
from typing import Optional

from . import seldon_methods
from .http_server import HTTPServer, Request, Response, error_body

logger = logging.getLogger(__name__)


class ServerState:
    """Pause/drain flag."""

    def __init__(self):
        self.paused = False
        self.ready = True


def get_rest_microservice(
    user_object,
    state: Optional[ServerState] = None,
    hook_workers: int = 64,
    max_body_bytes: Optional[int] = None,
) -> HTTPServer:
    if max_body_bytes is None:
        from .http_server import max_body_from_env

        max_body_bytes = max_body_from_env()
    app = HTTPServer("microservice-rest", max_body_bytes=max_body_bytes)
    state = state or ServerState()
    # Hooks run on a pool owned by this app: a long-blocking hook (a
    # generate request waiting on the continuous batcher) must not starve
    # health probes that share the loop.
    pool = futures.ThreadPoolExecutor(
        max_workers=hook_workers, thread_name_prefix=f"hooks-{type(user_object).__name__}"
    )
    app._hook_pool = pool

    def _sync(fn, *args):
        return asyncio.get_running_loop().run_in_executor(pool, fn, *args)

    PROTO_TYPES = ("application/x-protobuf", "application/octet-stream")

    def endpoint(method_fn, needs_body=True, msg_cls: str = "SeldonMessage"):
        async def handler(req: Request) -> Response:
            if state.paused:
                return Response(error_body(503, "paused"), 503)
            ctype = (req.headers.get("content-type") or "").split(";")[0].strip()
            binary = ctype in PROTO_TYPES
            if binary:
                from .payload import json_to_proto, pb, proto_to_json

                def _parse(raw_body):
                    return proto_to_json(getattr(pb, msg_cls).FromString(raw_body))

                try:
                    body = await _sync(_parse, req.body)
                except Exception as e:  # noqa: BLE001 - malformed proto
                    return Response(error_body(400, f"bad protobuf body: {e}"), 400)
            else:
                body = req.json()
            if body is None and needs_body:
                return Response(error_body(400, "empty request body"), 400)
            out = await _sync(method_fn, user_object, body)
            if binary:
                def _serialize(result):
                    return json_to_proto(result).SerializeToString()

                return Response(
                    await _sync(_serialize, out),
                    content_type="application/x-protobuf",
                )
            return Response(out)

        return handler

    app.add_route("/predict", endpoint(seldon_methods.predict))
    app.add_route("/api/v1.0/predictions", endpoint(seldon_methods.predict))
    app.add_route("/api/v0.1/predictions", endpoint(seldon_methods.predict))
    app.add_route("/transform-input", endpoint(seldon_methods.transform_input))
    app.add_route("/transform-output", endpoint(seldon_methods.transform_output))
    app.add_route("/route", endpoint(seldon_methods.route))
    app.add_route(
        "/aggregate", endpoint(seldon_methods.aggregate, msg_cls="SeldonMessageList")
    )
    app.add_route(
        "/send-feedback", endpoint(seldon_methods.send_feedback, msg_cls="Feedback")
    )
    app.add_route("/explain", endpoint(seldon_methods.explain))
    app.add_route("/api/v1.0/explain", endpoint(seldon_methods.explain))

    async def health(req: Request) -> Response:
        out = await _sync(seldon_methods.health_status, user_object)
        return Response(out)

    async def live(req: Request) -> Response:
        return Response({"status": "ok"})

    async def ready(req: Request) -> Response:
        if state.paused or not state.ready:
            return Response(error_body(503, "not ready"), 503)
        return Response({"status": "ok"})

    async def pause(req: Request) -> Response:
        state.paused = True
        return Response({"status": "paused"})

    async def unpause(req: Request) -> Response:
        state.paused = False
        return Response({"status": "ok"})

    app.add_route("/health/status", health)
    app.add_route("/live", live)
    app.add_route("/ready", ready)
    app.add_route("/pause", pause)
    app.add_route("/unpause", unpause)
    return app


# ---------------------------------------------------------------------------
# gRPC
# ---------------------------------------------------------------------------

_METHOD_IMPL = {
    "Predict": seldon_methods.predict,
    "TransformInput": seldon_methods.transform_input,
    "TransformOutput": seldon_methods.transform_output,
    "Route": seldon_methods.route,
    "Aggregate": seldon_methods.aggregate,
    "SendFeedback": seldon_methods.send_feedback,
}


def _make_handler(user_object, method: str, req_cls, grpc, pb):
    impl = _METHOD_IMPL[method]

    def run(request, context):
        try:
            return impl(user_object, request)
        except Exception as e:  # noqa: BLE001 - wire errors back to caller
            logger.error("grpc %s failed: %s", method, e, exc_info=True)
            context.set_code(grpc.StatusCode.INTERNAL)
            context.set_details(f"{type(e).__name__}: {e}")
            return pb.SeldonMessage()

    return grpc.unary_unary_rpc_method_handler(
        run,
        request_deserializer=req_cls.FromString,
        response_serializer=lambda m: m.SerializeToString(),
    )


def get_grpc_server(
    user_object,
    max_workers: int = 4,
    max_message_bytes: Optional[int] = None,
    service_names=None,
):
    """A ``grpc.server`` with a handler per method of every component
    service (or of ``service_names``); the caller adds a port and
    starts it. Each handler runs the same ``seldon_methods`` dispatch as
    the REST routes, on protobuf messages."""
    import grpc

    from .proto import prediction_pb2 as pb
    from .proto import services as svc

    options = []
    if max_message_bytes:
        options += [
            ("grpc.max_send_message_length", max_message_bytes),
            ("grpc.max_receive_message_length", max_message_bytes),
        ]
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers), options=options)
    for service, methods in svc.SERVICES.items():
        if service_names and service not in service_names:
            continue
        handlers = {
            m: _make_handler(user_object, m, req_cls, grpc, pb)
            for m, (req_cls, _resp_cls) in methods.items()
        }
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(svc.full_service_name(service), handlers),)
        )
    return server


def grpc_stub(channel, service: str, method: str):
    """Client callable for a component method (replaces generated stubs)."""
    from .proto import services as svc

    _req_cls, resp_cls = svc.SERVICES[service][method]
    return channel.unary_unary(
        svc.method_path(service, method),
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=resp_cls.FromString,
    )
