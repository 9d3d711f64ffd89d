"""Polymorphic dispatch from wire payloads to user hooks.

Counterpart of ``seldon_core_tpu/seldon_methods.py``: each method tries
the user's ``*_raw`` proto-level hook first, else decodes the payload,
calls the typed hook, and re-wraps the result in the requester's encoding
with custom metrics/tags merged into ``meta``.

Works on JSON dicts (the REST path, which builds no proto objects and
needs no protobuf runtime) and on protos; a request that is not a dict is
a proto.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, Optional

import numpy as np

from . import payload
from .user_model import (
    SeldonNotImplementedError,
    _has_hook,
    client_aggregate,
    client_custom_metrics,
    client_custom_tags,
    client_has_raw,
    client_explain,
    client_predict,
    client_raw,
    client_route,
    client_send_feedback,
    client_class_names,
    client_transform_input,
    client_transform_output,
)

logger = logging.getLogger(__name__)

Message = Any  # a JSON dict or a protobuf message


def _merged_meta(user_model, request_meta: Dict, extra_tags: Optional[Dict] = None) -> Dict:
    """puid propagation + custom tags/metrics merge
    (as the JAX package's seldon_methods)."""
    meta: Dict[str, Any] = {}
    puid = request_meta.get("puid")
    if puid:
        meta["puid"] = puid
    tags = dict(request_meta.get("tags") or {})
    tags.update(client_custom_tags(user_model))
    if extra_tags:
        tags.update(extra_tags)
    if tags:
        meta["tags"] = tags
    metrics = client_custom_metrics(user_model)
    if metrics:
        meta["metrics"] = metrics
    return meta


def _respond(user_model, parts: payload.Parts, result: Any, is_proto: bool,
             extra_tags: Optional[Dict] = None,
             fallback_names: Optional[list] = None) -> Message:
    width = None
    if fallback_names and (isinstance(result, (list, tuple)) or hasattr(result, "shape")):
        shape = np.asarray(result).shape
        width = shape[-1] if shape else 0  # 0-d results can't match names
    if (
        fallback_names
        and not _has_hook(user_model, "class_names")
        and (width is None or len(fallback_names) == width)
    ):
        # combiner semantics: a component without its own class_names
        # inherits the (first) upstream names instead of synthesizing
        # t:N placeholders (reference: AverageCombinerUnit.java keeps
        # outputs[0]'s DefaultData names via PredictorUtils.updateData).
        # Width-changed aggregates fall back to synthesized names.
        names = list(fallback_names)
    else:
        names = client_class_names(user_model, result)
    meta = _merged_meta(user_model, parts.meta, extra_tags)
    if is_proto:
        return payload.build_proto_response(result, names, parts.datadef_type, meta)
    return payload.build_json_response(result, names, parts.datadef_type, meta)


def _extract(request: Message, is_proto: bool) -> payload.Parts:
    return payload.extract_parts_proto(request) if is_proto else payload.extract_parts_json(request)


def predict(user_model, request: Message) -> Message:
    is_proto = not isinstance(request, dict)
    if client_has_raw(user_model, "predict"):
        return _raw_roundtrip(user_model, "predict", request, is_proto)
    parts = _extract(request, is_proto)
    result = client_predict(user_model, parts.payload, parts.names, parts.meta)
    return _respond(user_model, parts, result, is_proto)


def transform_input(user_model, request: Message) -> Message:
    is_proto = not isinstance(request, dict)
    if client_has_raw(user_model, "transform_input"):
        return _raw_roundtrip(user_model, "transform_input", request, is_proto)
    parts = _extract(request, is_proto)
    result = client_transform_input(user_model, parts.payload, parts.names, parts.meta)
    return _respond(user_model, parts, result, is_proto)


def transform_output(user_model, request: Message) -> Message:
    is_proto = not isinstance(request, dict)
    if client_has_raw(user_model, "transform_output"):
        return _raw_roundtrip(user_model, "transform_output", request, is_proto)
    parts = _extract(request, is_proto)
    result = client_transform_output(user_model, parts.payload, parts.names, parts.meta)
    return _respond(user_model, parts, result, is_proto)


def route(user_model, request: Message) -> Message:
    """Branch choice is returned as a 1x1 ndarray, like the reference
    (reference: python/seldon_core/seldon_methods.py:171-211; engine decodes
    it via getBranchIndex, PredictiveUnitBean.java:301)."""
    is_proto = not isinstance(request, dict)
    if client_has_raw(user_model, "route"):
        return _raw_roundtrip(user_model, "route", request, is_proto)
    parts = _extract(request, is_proto)
    branch = client_route(user_model, parts.payload, parts.names, parts.meta)
    result = [[branch]]
    parts.datadef_type = "ndarray" if not parts.datadef_type else parts.datadef_type
    if parts.datadef_type == "raw":
        parts.datadef_type = "ndarray"  # branch index must stay human-readable
    return _respond(user_model, parts, result, is_proto)


def aggregate(user_model, request) -> Message:
    """request: JSON {"seldonMessages": [...]} or pb.SeldonMessageList."""
    is_proto = not isinstance(request, dict)
    if client_has_raw(user_model, "aggregate"):
        return _raw_roundtrip(user_model, "aggregate", request, is_proto)
    if is_proto:
        msgs = list(request.seldon_messages)
    else:
        if not isinstance(request, dict) or "seldonMessages" not in request:
            raise payload.PayloadError('aggregate body needs "seldonMessages"')
        msgs = request["seldonMessages"]
    parts_list = [
        payload.extract_parts_proto(m) if is_proto else payload.extract_parts_json(m)
        for m in msgs
    ]
    if not parts_list:
        raise payload.PayloadError("aggregate of zero messages")
    result = client_aggregate(
        user_model,
        [p.payload for p in parts_list],
        [p.names for p in parts_list],
        [p.meta for p in parts_list],
    )
    first = parts_list[0]
    return _respond(user_model, first, result, is_proto, fallback_names=first.names)


def explain(user_model, request: Message) -> Message:
    """Explanation endpoint: result rides ``jsonData`` (attributions are a
    structured document, not a tensor). REST-first like the reference's
    alibi explainer (seldondeployment_explainers.go:32-187)."""
    is_proto = not isinstance(request, dict)
    parts = _extract(request, is_proto)
    result = client_explain(user_model, parts.payload, parts.names, parts.meta)
    return _respond(user_model, parts, result, is_proto)


def send_feedback(user_model, feedback) -> Message:
    """feedback: JSON dict or pb.Feedback. Replays reward to the component
    (bandit-router learning path, reference: seldon_methods.py:244-303)."""
    is_proto = not isinstance(feedback, dict)
    if client_has_raw(user_model, "send_feedback"):
        return _raw_roundtrip(user_model, "send_feedback", feedback, is_proto)
    if is_proto:
        req_parts = payload.extract_parts_proto(feedback.request) if feedback.HasField("request") else payload.Parts()
        truth_parts = payload.extract_parts_proto(feedback.truth) if feedback.HasField("truth") else payload.Parts()
        reward = feedback.reward
        routing_map = dict(feedback.response.meta.routing) if feedback.HasField("response") else {}
    else:
        req_parts = payload.extract_parts_json(feedback.get("request") or {})
        truth_parts = payload.extract_parts_json(feedback.get("truth") or {})
        reward = float(feedback.get("reward", 0.0))
        routing_map = ((feedback.get("response") or {}).get("meta") or {}).get("routing") or {}
    routing = next(iter(routing_map.values()), None)
    result = client_send_feedback(
        user_model, req_parts.payload, req_parts.names, reward, truth_parts.payload, routing
    )
    if result is None:
        return payload.pb.SeldonMessage() if is_proto else {}
    return _respond(user_model, req_parts, result, is_proto)


def health_status(user_model) -> Message:
    from .user_model import client_health_status

    result = client_health_status(user_model)
    return payload.build_json_response(result)


# ---------------------------------------------------------------------------


def _raw_roundtrip(user_model, method: str, request, is_proto: bool):
    """Call the proto-level hook; transcode JSON<->proto at the edges."""
    if is_proto:
        proto_req = request
    else:
        if method == "aggregate":
            proto_req = payload.json_to_proto(request, payload.pb.SeldonMessageList)
        elif method == "send_feedback":
            proto_req = payload.json_to_proto(request, payload.pb.Feedback)
        else:
            proto_req = payload.json_to_proto(request)
    out = client_raw(user_model, method, proto_req)
    if not isinstance(out, payload.pb.SeldonMessage):
        raise ValueError(f"{method}_raw must return SeldonMessage")
    return out if is_proto else payload.proto_to_json(out)
