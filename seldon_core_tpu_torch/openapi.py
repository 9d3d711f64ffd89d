"""OpenAPI 3.0 documents for the external (engine) and internal
(microservice wrapper) HTTP APIs.

Counterpart of ``seldon_core_tpu/openapi.py``: the documents are built
from one schema table and served live at ``GET /openapi.json`` on the
engine and on the microservice, reconciled against the server's
registered routes (undocumented routes appear with a generic entry,
unserved documented paths are dropped), so the published document cannot
drift from the routes that exist. For the same served paths the
documents equal the JAX package's, key for key.
"""

from __future__ import annotations

from typing import Any, Dict

SELDON_MESSAGE_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "description": "SeldonMessage (protos/prediction.proto): Status + Meta "
    "+ one payload of data/binData/strData/jsonData. The `raw` encoding "
    "(dtype, shape, little-endian bytes) also crosses REST as a binary "
    "protobuf body with Content-Type application/x-protobuf.",
    "properties": {
        "status": {
            "type": "object",
            "properties": {
                "code": {"type": "integer"},
                "info": {"type": "string"},
                "reason": {"type": "string"},
                "status": {"type": "string"},
            },
        },
        "meta": {
            "type": "object",
            "properties": {
                "puid": {"type": "string"},
                "tags": {"type": "object"},
                "routing": {"type": "object", "additionalProperties": {"type": "integer"}},
                "requestPath": {"type": "object", "additionalProperties": {"type": "string"}},
                "metrics": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "properties": {
                            "key": {"type": "string"},
                            "type": {"type": "string", "enum": ["COUNTER", "GAUGE", "TIMER"]},
                            "value": {"type": "number"},
                        },
                    },
                },
            },
        },
        "data": {
            "type": "object",
            "properties": {
                "names": {"type": "array", "items": {"type": "string"}},
                "tensor": {
                    "type": "object",
                    "properties": {
                        "shape": {"type": "array", "items": {"type": "integer"}},
                        "values": {"type": "array", "items": {"type": "number"}},
                    },
                },
                "ndarray": {"type": "array", "items": {}},
                "raw": {
                    "type": "object",
                    "properties": {
                        "dtype": {"type": "string"},
                        "shape": {"type": "array", "items": {"type": "integer"}},
                        "data": {"type": "string", "format": "byte"},
                    },
                },
            },
        },
        "binData": {"type": "string", "format": "byte"},
        "strData": {"type": "string"},
        "jsonData": {},
    },
}

FEEDBACK_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "properties": {
        "request": {"$ref": "#/components/schemas/SeldonMessage"},
        "response": {"$ref": "#/components/schemas/SeldonMessage"},
        "reward": {"type": "number"},
        "truth": {"$ref": "#/components/schemas/SeldonMessage"},
    },
}

MESSAGE_LIST_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "description": "SeldonMessageList: combiner input (one message per child branch).",
    "properties": {
        "seldonMessages": {
            "type": "array",
            "items": {"$ref": "#/components/schemas/SeldonMessage"},
        }
    },
}


def _message_op(
    summary: str, tag: str, request_schema: str = "SeldonMessage"
) -> Dict[str, Any]:
    body = {
        "required": True,
        "content": {
            "application/json": {
                "schema": {"$ref": f"#/components/schemas/{request_schema}"}
            },
            "application/x-protobuf": {
                "schema": {"type": "string", "format": "binary"}
            },
        },
    }
    return {
        "summary": summary,
        "tags": [tag],
        "requestBody": body,
        "responses": {
            "200": {
                "description": "SeldonMessage response",
                "content": {
                    "application/json": {
                        "schema": {"$ref": "#/components/schemas/SeldonMessage"}
                    },
                    "application/x-protobuf": {
                        "schema": {"type": "string", "format": "binary"}
                    },
                },
            },
            "400": {"description": "malformed payload"},
            "503": {"description": "paused or graph not ready"},
        },
    }


def _probe_op(summary: str, tag: str) -> Dict[str, Any]:
    return {
        "summary": summary,
        "tags": [tag],
        "responses": {"200": {"description": "ok"}},
    }


def _base(title: str, description: str) -> Dict[str, Any]:
    return {
        "openapi": "3.0.3",
        "info": {"title": title, "version": "1.0.0", "description": description},
        "components": {
            "schemas": {
                "SeldonMessage": SELDON_MESSAGE_SCHEMA,
                "Feedback": FEEDBACK_SCHEMA,
                "SeldonMessageList": MESSAGE_LIST_SCHEMA,
            }
        },
    }


def _reconcile(doc: Dict[str, Any], served_paths) -> Dict[str, Any]:
    """Make the document match the routes a server REALLY registered:
    drop documented paths the server doesn't serve, add generic entries
    for served paths the table doesn't know — so a new add_route can
    never silently drift out of the published spec."""
    if served_paths is None:
        return doc
    served = set(served_paths)
    doc["paths"] = {p: op for p, op in doc["paths"].items() if p in served}
    for p in sorted(served - set(doc["paths"])):
        # method/shape unknown: advertise both verbs with no required body
        # rather than inventing a POST-only SeldonMessage contract
        unknown = {
            "summary": f"(undocumented route {p})",
            "tags": ["extra"],
            "responses": {"200": {"description": "see server source"}},
        }
        doc["paths"][p] = {"get": dict(unknown), "post": dict(unknown)}
    return doc


def engine_spec(served_paths=None) -> Dict[str, Any]:
    """External API of the graph engine (reference: openapi/engine.oas3.json).

    ``served_paths``: the serving app's registered routes; when given,
    the document is reconciled against them (see _reconcile). The native
    C++ engine serves the predictions/probes/lifecycle/metrics subset of
    these routes — not feedback, /traces, or /openapi.json.
    """
    doc = _base(
        "seldon-core-tpu engine API",
        "External data-plane API of the inference-graph engine "
        "(graph/service.py; native/engine.cpp serves the predictions + "
        "probe + lifecycle + metrics subset).",
    )
    feedback_op = _message_op("Send reward feedback through the graph", "engine")
    feedback_op["requestBody"]["content"]["application/json"]["schema"] = {
        "$ref": "#/components/schemas/Feedback"
    }
    predict_op = _message_op("Run the inference graph", "engine")
    doc["paths"] = {
        "/api/v0.1/predictions": {"post": predict_op},
        "/api/v1.0/predictions": {"post": predict_op},
        "/predict": {"post": predict_op},
        "/api/v0.1/feedback": {"post": feedback_op},
        "/api/v1.0/feedback": {"post": feedback_op},
        **{
            p: {
                "post": {
                    "summary": "SSE token streaming (GENERATE_SERVER graphs)",
                    "tags": ["engine"],
                    "requestBody": {
                        "required": True,
                        "content": {"application/json": {"schema": {}}},
                    },
                    "responses": {
                        "200": {
                            "description": "text/event-stream of "
                            '`data: {"tokens": [...]}` events, ending with '
                            '`data: {"done": true, "tokens": [...]}`',
                        },
                        "501": {
                            "description": "graph is not a single generate server"
                        },
                    },
                }
            }
            for p in ("/api/v0.1/generate", "/api/v1.0/generate")
        },
        "/ready": {"get": _probe_op("Readiness (graph-gated)", "probes")},
        "/live": {"get": _probe_op("Liveness", "probes")},
        "/ping": {"get": _probe_op("Ping", "probes")},
        "/pause": {"get": _probe_op("Reject new work (drain step 1)", "lifecycle")},
        "/unpause": {"get": _probe_op("Accept work again", "lifecycle")},
        "/inflight": {"get": _probe_op("Live-request gauge (drain step 2)", "lifecycle")},
        "/prometheus": {"get": _probe_op("Prometheus metrics", "observability")},
        "/metrics": {"get": _probe_op("Prometheus metrics", "observability")},
        "/traces": {"get": _probe_op(
            "Jaeger-JSON trace export (?operation=&limit=&since_us=)",
            "observability")},
        "/flightrecorder": {"get": _probe_op(
            "Scheduler flight-recorder dump (generate graphs; ?limit=)",
            "observability")},
        "/openapi.json": {"get": _probe_op("This document", "meta")},
    }
    return _reconcile(doc, served_paths)


def wrapper_spec(served_paths=None) -> Dict[str, Any]:
    """Internal API of a model microservice (reference: openapi/wrapper.oas3.json)."""
    doc = _base(
        "seldon-core-tpu microservice API",
        "Internal per-component API the engine calls (wrapper.py routes; "
        "the gRPC services mirror these one-to-one).",
    )
    doc["paths"] = {
        path: {"post": _message_op(summary, "component", request_schema=schema)}
        for path, summary, schema in [
            ("/predict", "Model predict", "SeldonMessage"),
            ("/api/v0.1/predictions", "Model predict", "SeldonMessage"),
            ("/api/v1.0/predictions", "Model predict", "SeldonMessage"),
            ("/transform-input", "Input transformer", "SeldonMessage"),
            ("/transform-output", "Output transformer", "SeldonMessage"),
            ("/route", "Router: pick a child branch", "SeldonMessage"),
            ("/aggregate", "Combiner: merge child outputs", "SeldonMessageList"),
            ("/send-feedback", "Reward feedback", "Feedback"),
            ("/explain", "Explanation (integrated gradients)", "SeldonMessage"),
            ("/api/v1.0/explain", "Explanation (integrated gradients)", "SeldonMessage"),
        ]
    }
    doc["paths"]["/health/status"] = {
        "get": _probe_op("Model health (calls the component's health hook)", "probes")
    }
    for path, summary in [
        ("/live", "Liveness"),
        ("/ready", "Readiness (503 while paused)"),
        ("/pause", "Reject new work"),
        ("/unpause", "Accept work again"),
    ]:
        doc["paths"][path] = {"get": _probe_op(summary, "probes")}
    doc["paths"]["/openapi.json"] = {"get": _probe_op("This document", "meta")}
    return _reconcile(doc, served_paths)
