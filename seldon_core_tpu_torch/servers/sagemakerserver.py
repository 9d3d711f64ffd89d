"""SageMaker endpoint proxy, on the host.

Counterpart of ``seldon_core_tpu/servers/sagemakerserver.py`` (reference:
integrations/sagemaker/SagemakerProxy.py): a component forwarding
predict traffic to a SageMaker invoke-endpoint. boto3 is optional; the
runtime client is injectable (``client_factory``), so the bridge runs
without AWS, and without boto3 ``load`` raises a clear error.

Parameters: ``endpoint_name``, ``region``, ``content_type``
(text/csv | application/json).
"""

from __future__ import annotations

import io
import json
import logging
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..user_model import SeldonComponent

logger = logging.getLogger(__name__)


class SageMakerServer(SeldonComponent):
    def __init__(
        self,
        model_uri: str = "",
        endpoint_name: str = "",
        region: str = "",
        content_type: str = "application/json",
        client_factory: Optional[Callable[[], Any]] = None,
        **kwargs,
    ):
        self.endpoint_name = endpoint_name or model_uri.rsplit("/", 1)[-1]
        if not self.endpoint_name:
            raise ValueError("sagemaker proxy needs endpoint_name (or modelUri)")
        self.region = region
        self.content_type = content_type
        self._client_factory = client_factory
        self._client = None

    def load(self) -> None:
        if self._client is not None:
            return
        if self._client_factory is not None:
            self._client = self._client_factory()
            return
        try:
            import boto3  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "SAGEMAKER_SERVER requires boto3, which is not installed; "
                "inject client_factory for tests"
            ) from e
        self._client = boto3.client(
            "sagemaker-runtime", region_name=self.region or None
        )

    def _encode(self, arr: np.ndarray) -> bytes:
        if self.content_type == "text/csv":
            buf = io.StringIO()
            np.savetxt(buf, arr, delimiter=",", fmt="%g")
            return buf.getvalue().encode()
        return json.dumps({"instances": arr.tolist()}).encode()

    def _decode(self, body: bytes) -> np.ndarray:
        text = body.decode()
        if self.content_type == "text/csv":
            return np.loadtxt(io.StringIO(text), delimiter=",", ndmin=2)
        out = json.loads(text)
        if isinstance(out, dict):
            for key in ("predictions", "outputs"):
                if key in out:
                    out = out[key]
                    break
            else:
                raise RuntimeError(
                    f"unrecognized sagemaker response shape: keys {sorted(out)}"
                    " (expected 'predictions' or 'outputs')"
                )
        return np.asarray(out)

    def predict(self, X, names, meta=None):
        if self._client is None:
            self.load()
        arr = np.asarray(X)
        resp = self._client.invoke_endpoint(
            EndpointName=self.endpoint_name,
            ContentType=self.content_type,
            Accept=self.content_type,
            Body=self._encode(arr),
        )
        body = resp["Body"]
        raw = body.read() if hasattr(body, "read") else body
        return self._decode(raw if isinstance(raw, bytes) else raw.encode())

    def tags(self) -> Dict[str, Any]:
        return {"server": "sagemaker", "endpoint": self.endpoint_name}
