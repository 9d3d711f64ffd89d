"""Triton / TensorRT Inference Server proxy, on the host.

Counterpart of ``seldon_core_tpu/servers/trtserver.py`` (reference:
integrations/nvidia-inference-server/TRTProxy.py:1-40): a component that
bridges graph traffic to an external inference server, negotiating the
model's input dtype and shape from its model metadata, over Triton's
KServe-v2 HTTP protocol. The transport is injectable, so the bridge runs
without a Triton server.

Parameters: ``url`` (http://host:8000), ``model_name``, ``model_version``.
"""

from __future__ import annotations

import json
import logging
import urllib.request
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..user_model import SeldonComponent

logger = logging.getLogger(__name__)

# numpy dtype name -> KServe v2 datatype
V2_DTYPES = {
    "bool": "BOOL",
    "uint8": "UINT8",
    "uint16": "UINT16",
    "uint32": "UINT32",
    "uint64": "UINT64",
    "int8": "INT8",
    "int16": "INT16",
    "int32": "INT32",
    "int64": "INT64",
    "float16": "FP16",
    "float32": "FP32",
    "float64": "FP64",
}
NP_DTYPES = {v: k for k, v in V2_DTYPES.items()}


def _http_transport(url: str, body: Optional[bytes], timeout: float) -> Dict:
    req = urllib.request.Request(
        url, data=body,
        headers={"Content-Type": "application/json"} if body else {},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


class TRTServer(SeldonComponent):
    """Bridge: SeldonMessage tensors in, KServe-v2 infer call out.

    ``transport(url, body_bytes_or_None, timeout) -> dict`` is injectable
    for tests; default is plain HTTP.
    """

    def __init__(
        self,
        model_uri: str = "",
        url: str = "http://localhost:8000",
        model_name: str = "",
        model_version: str = "",
        timeout_s: float = 10.0,
        transport: Callable[[str, Optional[bytes], float], Dict] = _http_transport,
        **kwargs,
    ):
        self.url = url.rstrip("/")
        self.model_name = model_name or model_uri.rsplit("/", 1)[-1] or "model"
        self.model_version = str(model_version) if model_version else ""
        self.timeout_s = float(timeout_s)
        self.transport = transport
        self._meta: Optional[Dict] = None

    def _model_path(self) -> str:
        base = f"{self.url}/v2/models/{self.model_name}"
        if self.model_version:
            base += f"/versions/{self.model_version}"
        return base

    def load(self) -> None:
        """Dtype/shape negotiation from the server's model metadata
        (reference parse_model, TRTProxy.py:1-40)."""
        self._meta = self.transport(self._model_path(), None, self.timeout_s)
        logger.info(
            "trtserver: model %s inputs=%s",
            self.model_name, [i.get("name") for i in self._meta.get("inputs", [])],
        )

    def _input_spec(self) -> Dict:
        if self._meta is None:
            self.load()
        inputs = self._meta.get("inputs") or []
        if not inputs:
            raise RuntimeError(f"model {self.model_name} reports no inputs")
        return inputs[0]

    def predict(self, X, names, meta=None):
        spec = self._input_spec()
        arr = np.asarray(X)
        v2_dtype = spec.get("datatype", "FP32")
        np_dtype = NP_DTYPES.get(v2_dtype)
        if np_dtype is None:
            raise RuntimeError(
                f"model {self.model_name} input datatype {v2_dtype!r} is not a "
                f"numeric KServe-v2 type this bridge supports ({sorted(NP_DTYPES)})"
            )
        arr = arr.astype(np_dtype, copy=False)
        body = json.dumps(
            {
                "inputs": [
                    {
                        "name": spec.get("name", "input"),
                        "shape": list(arr.shape),
                        "datatype": v2_dtype,
                        "data": arr.ravel().tolist(),
                    }
                ]
            }
        ).encode()
        out = self.transport(self._model_path() + "/infer", body, self.timeout_s)
        outputs = out.get("outputs") or []
        if not outputs:
            raise RuntimeError(f"model {self.model_name} returned no outputs")
        first = outputs[0]
        out_v2 = first.get("datatype", "FP32")
        out_np = NP_DTYPES.get(out_v2)
        if out_np is None:
            raise RuntimeError(
                f"model {self.model_name} output datatype {out_v2!r} unsupported"
            )
        result = np.asarray(first.get("data", []), dtype=out_np)
        shape = first.get("shape")
        return result.reshape(shape) if shape else result

    def class_names(self) -> List[str]:
        outputs = (self._meta or {}).get("outputs") or []
        return [o.get("name", f"t:{i}") for i, o in enumerate(outputs)]

    def tags(self) -> Dict[str, Any]:
        return {"server": "trtserver", "model": self.model_name}
