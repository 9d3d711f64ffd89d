"""Client SDK: drive deployments through the gateway, an engine, or a
single microservice, over REST or gRPC.

Counterpart of ``seldon_core_tpu/client.py`` (reference:
python/seldon_core/seldon_client.py:104-1106 — SeldonClient with
gateway/transport/payload-type axes, `predict`/`feedback` external calls
and `microservice`/`microservice_feedback` internal calls). The
"gateway" is the port's ingress (``controlplane/ingress.py``); payloads
can also use the zero-copy ``raw`` tensor encoding. gRPC imports
``grpc`` on first use, so the REST client needs neither grpcio nor the
protobuf runtime.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from .payload import array_to_json_data, json_data_to_array, jsonable

logger = logging.getLogger(__name__)


@dataclass
class SeldonClientResponse:
    """Mirror of the reference's SeldonClientPrediction: success flag, raw
    request/response dicts, and the decoded ndarray when present."""

    success: bool
    request: Optional[Dict[str, Any]] = None
    response: Optional[Dict[str, Any]] = None
    msg: str = ""

    @property
    def data(self) -> Optional[np.ndarray]:
        if not self.response or "data" not in self.response:
            return None
        return json_data_to_array(self.response["data"])

    @property
    def meta(self) -> Dict[str, Any]:
        return (self.response or {}).get("meta", {})


MICROSERVICE_PATHS = {
    "predict": "/predict",
    "transform-input": "/transform-input",
    "transform-output": "/transform-output",
    "route": "/route",
    "aggregate": "/aggregate",
    "send-feedback": "/send-feedback",
}

GRPC_METHODS = {
    "predict": ("Model", "Predict"),
    "transform-input": ("Transformer", "TransformInput"),
    "transform-output": ("OutputTransformer", "TransformOutput"),
    "route": ("Router", "Route"),
    "aggregate": ("Combiner", "Aggregate"),
    "send-feedback": ("Model", "SendFeedback"),
}


class SeldonClient:
    """One client, three targets:

    * ``gateway_endpoint`` + ``deployment_name`` → external API through the
      ingress (``/seldon/<ns>/<name>/api/v0.1/predictions``)
    * ``engine_endpoint`` → one engine directly (``/api/v0.1/predictions``)
    * ``microservice_endpoint`` → one wrapped component
      (``/predict``, ``/route``, ... — reference: seldon_client.py:587-930)
    """

    def __init__(
        self,
        deployment_name: Optional[str] = None,
        namespace: str = "default",
        gateway_endpoint: Optional[str] = None,
        engine_endpoint: Optional[str] = None,
        microservice_endpoint: Optional[str] = None,
        transport: str = "rest",
        payload_type: str = "ndarray",
        timeout_s: float = 30.0,
        oauth_key: Optional[str] = None,
        oauth_secret: Optional[str] = None,
    ):
        self.deployment_name = deployment_name
        self.namespace = namespace
        self.gateway_endpoint = gateway_endpoint
        self.engine_endpoint = engine_endpoint
        self.microservice_endpoint = microservice_endpoint
        self.transport = transport
        self.payload_type = payload_type
        self.timeout_s = timeout_s
        # oauth flow against the gateway's /oauth/token (reference:
        # seldon_client.py:931-1106 oauth gateway support)
        self.oauth_key = oauth_key
        self.oauth_secret = oauth_secret
        self._token: Optional[str] = None

    def _gateway_token(self, force: bool = False) -> Optional[str]:
        if not self.oauth_key or not self.gateway_endpoint:
            return None
        if self._token is not None and not force:
            return self._token
        import base64

        creds = base64.b64encode(
            f"{self.oauth_key}:{self.oauth_secret or ''}".encode()
        ).decode()
        req = urllib.request.Request(
            f"http://{self.gateway_endpoint}/oauth/token",
            data=b"{}",
            headers={"authorization": f"Basic {creds}",
                     "content-type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            self._token = json.loads(r.read())["access_token"]
        return self._token

    def _auth_headers(self, headers: Optional[Dict[str, str]],
                      force: bool = False) -> Optional[Dict[str, str]]:
        token = self._gateway_token(force=force)
        if token is None:
            return headers
        return {**(headers or {}), "authorization": f"Bearer {token}"}

    def _post_authed(self, url: str, body: Dict[str, Any],
                     headers: Optional[Dict[str, str]]) -> "SeldonClientResponse":
        """_post with the oauth flow: token fetch failures honour the
        never-raise contract, and one 401 retries with a fresh token
        (tokens expire server-side after TOKEN_TTL_S)."""
        try:
            authed = self._auth_headers(headers)
        except (urllib.error.URLError, OSError, json.JSONDecodeError, KeyError) as e:
            return SeldonClientResponse(False, body, None, msg=f"oauth token: {e}")
        out = self._post(url, body, authed)
        if not out.success and self.oauth_key and "401" in (out.msg or ""):
            try:
                authed = self._auth_headers(headers, force=True)
            except (urllib.error.URLError, OSError, json.JSONDecodeError, KeyError) as e:
                return SeldonClientResponse(False, body, None, msg=f"oauth token: {e}")
            out = self._post(url, body, authed)
        return out

    # -- payload construction ----------------------------------------------

    def _message(self, data=None, bin_data=None, str_data=None, json_data=None,
                 names=None) -> Dict[str, Any]:
        if bin_data is not None:
            import base64

            return {"binData": base64.b64encode(bin_data).decode()}
        if str_data is not None:
            return {"strData": str_data}
        if json_data is not None:
            return {"jsonData": json_data}
        arr = np.asarray(data if data is not None else np.random.rand(1, 1))
        return {"data": array_to_json_data(arr, names=list(names or []), encoding=self.payload_type)}

    # -- HTTP plumbing ------------------------------------------------------

    def _post(self, url: str, body: Dict[str, Any],
              headers: Optional[Dict[str, str]] = None) -> SeldonClientResponse:
        req = urllib.request.Request(
            url,
            data=json.dumps(jsonable(body)).encode(),
            headers={"content-type": "application/json", **(headers or {})},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                out = json.loads(r.read())
            return SeldonClientResponse(True, body, out)
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read())
            except Exception:
                payload = None
            return SeldonClientResponse(False, body, payload, msg=str(e))
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
            return SeldonClientResponse(False, body, None, msg=str(e))

    # -- external API -------------------------------------------------------

    def _external_base(self) -> str:
        if self.gateway_endpoint and self.deployment_name:
            return (
                f"http://{self.gateway_endpoint}/seldon/{self.namespace}/"
                f"{self.deployment_name}"
            )
        if self.engine_endpoint:
            return f"http://{self.engine_endpoint}"
        raise ValueError("need gateway_endpoint+deployment_name or engine_endpoint")

    def predict(self, data=None, names=None, headers: Optional[Dict[str, str]] = None,
                **payload_kwargs) -> SeldonClientResponse:
        if self.transport == "grpc":
            return self._grpc_external("Predict", self._message(data, names=names, **payload_kwargs))
        body = self._message(data, names=names, **payload_kwargs)
        url = self._external_base() + "/api/v0.1/predictions"
        return self._post_authed(url, body, headers)

    def feedback(self, request: Dict[str, Any], response: Dict[str, Any],
                 reward: float = 0.0, truth=None) -> SeldonClientResponse:
        body: Dict[str, Any] = {"request": request, "response": response, "reward": reward}
        if truth is not None:
            body["truth"] = self._message(truth)
        if self.transport == "grpc":
            return self._grpc_external("SendFeedback", body)
        url = self._external_base() + "/api/v0.1/feedback"
        return self._post_authed(url, body, None)

    def _grpc_external(self, method: str, body: Dict[str, Any]) -> SeldonClientResponse:
        import grpc

        from .payload import json_to_proto, proto_to_json
        from .proto import prediction_pb2 as pb

        endpoint = self.engine_endpoint
        if not endpoint:
            raise ValueError(
                "gateway does not serve gRPC; set engine_endpoint for transport='grpc'"
            )
        msg_cls = pb.Feedback if method == "SendFeedback" else pb.SeldonMessage
        with grpc.insecure_channel(endpoint) as channel:
            call = channel.unary_unary(
                f"/seldontpu.Seldon/{method}",
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=pb.SeldonMessage.FromString,
            )
            try:
                out = call(json_to_proto(body, msg_cls), timeout=self.timeout_s)
                return SeldonClientResponse(True, body, proto_to_json(out))
            except grpc.RpcError as e:
                return SeldonClientResponse(False, body, None, msg=str(e))

    # -- internal (microservice) API ---------------------------------------

    def microservice(self, data=None, method: str = "predict", names=None,
                     **payload_kwargs) -> SeldonClientResponse:
        if method not in MICROSERVICE_PATHS:
            raise ValueError(f"unknown microservice method {method!r}")
        if method == "aggregate":
            # aggregate takes a message list: data is a list of batches
            msgs = [self._message(d, names=names) for d in (data or [])]
            body: Dict[str, Any] = {"seldonMessages": msgs}
        else:
            body = self._message(data, names=names, **payload_kwargs)
        if self.transport == "grpc":
            return self._grpc_microservice(method, body)
        url = f"http://{self.microservice_endpoint}{MICROSERVICE_PATHS[method]}"
        return self._post(url, body)

    def microservice_feedback(self, request: Dict[str, Any], response: Dict[str, Any],
                              reward: float = 0.0) -> SeldonClientResponse:
        body = {"request": request, "response": response, "reward": reward}
        if self.transport == "grpc":
            return self._grpc_microservice("send-feedback", body)
        url = f"http://{self.microservice_endpoint}/send-feedback"
        return self._post(url, body)

    def _grpc_microservice(self, method: str, body: Dict[str, Any]) -> SeldonClientResponse:
        import grpc

        from .payload import json_to_proto, proto_to_json
        from .proto import prediction_pb2 as pb
        from .wrapper import grpc_stub

        service, rpc = GRPC_METHODS[method]
        if method == "send-feedback":
            msg_cls = pb.Feedback
        elif method == "aggregate":
            msg_cls = pb.SeldonMessageList
        else:
            msg_cls = pb.SeldonMessage
        with grpc.insecure_channel(self.microservice_endpoint) as channel:
            call = grpc_stub(channel, service, rpc)
            try:
                out = call(json_to_proto(body, msg_cls), timeout=self.timeout_s)
                return SeldonClientResponse(True, body, proto_to_json(out))
            except grpc.RpcError as e:
                return SeldonClientResponse(False, body, None, msg=str(e))
