"""Marshaling between wire payloads and tensors.

Counterpart of ``seldon_core_tpu/payload.py``, with the same codecs: the
``tensor`` / ``ndarray`` / ``raw`` data encodings plus ``binData`` /
``strData`` / ``jsonData``, in the canonical protobuf JSON mapping of
``SeldonMessage`` (camelCase keys), so REST and gRPC bodies transcode
1:1. ``raw`` (dtype + shape + little-endian bytes) decodes with one
``np.frombuffer`` view; :func:`to_device` lands a host array on a torch
device.

The protobuf bindings (``proto/``) load on first use of a proto path, so
the REST JSON path runs without the protobuf runtime.
"""

from __future__ import annotations

import base64
import json
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

try:  # ml_dtypes gives numpy bfloat16/fp8 dtypes where it is installed
    import ml_dtypes

    _EXTENDED_DTYPES = {
        "bfloat16": np.dtype(ml_dtypes.bfloat16),
        "float8_e4m3fn": np.dtype(ml_dtypes.float8_e4m3fn),
        "float8_e5m2": np.dtype(ml_dtypes.float8_e5m2),
    }
except ImportError:  # pragma: no cover - bf16/fp8 raw tensors need ml_dtypes
    _EXTENDED_DTYPES = {}


class _LazyProto:
    """``prediction_pb2``, imported on first attribute access."""

    def __getattr__(self, name):
        from .proto import prediction_pb2

        return getattr(prediction_pb2, name)


pb = _LazyProto()


class _Raw(NamedTuple):
    """The fields of a ``RawTensor`` without the protobuf runtime."""

    dtype: str
    shape: Tuple[int, ...]
    data: bytes
    encoding: str = ""

JsonDict = Dict[str, Any]
ArrayLike = Any  # np.ndarray | torch.Tensor


class PayloadError(ValueError):
    """Malformed wire payload (maps to HTTP 400 / gRPC INVALID_ARGUMENT)."""


DEFAULT_MAX_DECODED_BYTES = 512 * 1024 * 1024


def max_decoded_bytes(default: int = DEFAULT_MAX_DECODED_BYTES) -> int:
    """Server-side ceiling on the *decoded* size of compressed tensor
    encodings (``zlib``, ``jpeg-rows``). The REST/gRPC body caps bound the
    wire bytes, but the decoded size is declared by the client in
    ``RawTensor.shape`` — a <=64MB zlib body can legally inflate ~1000:1,
    so the shape-declared size must be checked against a server-side limit
    *before* any decompression happens. ``SELDON_MAX_DECODED_BYTES`` env
    overrides the 512MiB default."""
    import os

    try:
        v = int(os.environ["SELDON_MAX_DECODED_BYTES"])
        if v > 0:
            return v
    except (KeyError, ValueError):
        pass
    return default


def _declared_nbytes(shape, dtype: np.dtype) -> int:
    """Byte size a client-declared shape claims, in exact Python ints —
    np.prod wraps at int64, which would let a huge shape slip past the
    cap below and surface as an uncaught OverflowError downstream."""
    import math

    dims = [int(s) for s in shape]
    if any(s < 0 for s in dims):
        raise PayloadError(f"negative dimension in shape {tuple(shape)}")
    return math.prod(dims) * dtype.itemsize if dims else dtype.itemsize


def _check_decoded_size(expected: int, shape, dtype_str: str) -> None:
    cap = max_decoded_bytes()
    if expected > cap:
        raise PayloadError(
            f"decoded tensor shape {tuple(shape)} x {dtype_str} is "
            f"{expected} bytes, over the SELDON_MAX_DECODED_BYTES cap {cap}"
        )


# ---------------------------------------------------------------------------
# dtype helpers
# ---------------------------------------------------------------------------


def dtype_from_name(name: str) -> np.dtype:
    if name in _EXTENDED_DTYPES:
        return _EXTENDED_DTYPES[name]
    try:
        return np.dtype(name)
    except TypeError as e:
        raise PayloadError(f"unknown dtype {name!r}") from e


def is_extended_dtype(dtype: Any) -> bool:
    """True for the ml_dtypes types (bfloat16/fp8) that can't ride
    'tensor'/'ndarray' JSON without a silent upcast."""
    return np.dtype(dtype).name in _EXTENDED_DTYPES


def effective_encoding(arr: ArrayLike, requested: Optional[str]) -> str:
    """Wire encoding to actually use for ``arr``: honours ``requested``
    except that bfloat16/fp8 can't ride 'tensor'/'ndarray' JSON without a
    silent upcast — those are forced to 'raw'. The single place this rule
    lives; response builders and the micro-batch split all use it."""
    enc = requested or "ndarray"
    if np.dtype(_to_numpy(arr).dtype).name in _EXTENDED_DTYPES and enc != "raw":
        enc = "raw"
    return enc


def dtype_name(dtype) -> str:
    return np.dtype(dtype).name


def _to_numpy(arr: ArrayLike) -> np.ndarray:
    """Materialise on host: a device tensor costs one device-to-host copy."""
    if isinstance(arr, np.ndarray):
        return arr
    if hasattr(arr, "detach") and hasattr(arr, "cpu"):  # torch.Tensor
        import torch

        t = arr.detach().cpu()
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16: keep the bits where ml_dtypes can
            # name them, else widen to float32 (exact)
            if "bfloat16" in _EXTENDED_DTYPES:
                return t.view(torch.int16).numpy().view(_EXTENDED_DTYPES["bfloat16"])
            return t.float().numpy()
        return t.numpy()
    return np.asarray(arr)


# ---------------------------------------------------------------------------
# Tensor encodings -> numpy
# ---------------------------------------------------------------------------


def _decode_jpeg_rows(data: bytes, shape, dtype: np.dtype) -> np.ndarray:
    """Length-prefixed JPEG per leading-dim row -> stacked uint8 array.

    The wire-tier answer to a slow client->host pipe: a 224x224x3 raw row
    is ~150KB, its JPEG ~20-50KB — the H2D transport roofline moves ~5x
    (BASELINE.md documents the pipe). Decode is host-side, before
    ``to_device``."""
    if dtype != np.uint8:
        raise PayloadError(f"jpeg-rows requires uint8, got {dtype.name}")
    if len(shape) < 3:
        raise PayloadError(f"jpeg-rows needs [N, H, W(, C)] shape, got {shape}")
    if shape[0] <= 0:
        raise PayloadError(f"jpeg-rows needs at least one row, got shape {shape}")
    _check_decoded_size(_declared_nbytes(shape, dtype), shape, dtype.name)
    try:
        import io

        from PIL import Image
    except ImportError as e:  # pragma: no cover - PIL is in the image
        raise PayloadError("jpeg-rows encoding requires Pillow") from e
    blobs = []
    off, n = 0, shape[0]
    row_shape = tuple(shape[1:])
    for _ in range(n):
        if off + 4 > len(data):
            raise PayloadError("jpeg-rows: truncated length prefix")
        ln = int.from_bytes(data[off:off + 4], "little")
        off += 4
        if off + ln > len(data):
            raise PayloadError("jpeg-rows: truncated JPEG blob")
        blobs.append(data[off:off + ln])
        off += ln
    if off != len(data):
        raise PayloadError(f"jpeg-rows: {len(data) - off} trailing bytes")

    def decode(blob):
        img = np.asarray(Image.open(io.BytesIO(blob)))
        if img.shape != row_shape:
            raise PayloadError(
                f"jpeg-rows: decoded row shape {img.shape} != {row_shape}"
            )
        return img

    if len(blobs) > 4:
        # libjpeg releases the GIL: pooled decode keeps a 32-row batch from
        # serializing ~100ms of host CPU in front of the device step
        rows = list(decode_pool().map(decode, blobs))
    else:
        rows = [decode(b) for b in blobs]
    return np.stack(rows).astype(np.uint8, copy=False)


_DECODE_POOL = None


def decode_pool():
    """Shared host-side decode pool (JPEG rows, request unpacking). One
    persistent pool for the process: creating a ThreadPoolExecutor per
    request costs ~ms of thread spawn/teardown on the serving hot path."""
    global _DECODE_POOL
    if _DECODE_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _DECODE_POOL = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="seldon-decode"
        )
    return _DECODE_POOL


def encode_jpeg_rows(arr: np.ndarray, quality: int = 90) -> bytes:
    """Inverse of ``_decode_jpeg_rows`` (client-side edge encoder)."""
    import io

    from PIL import Image

    if arr.dtype != np.uint8:
        raise PayloadError(f"jpeg-rows requires uint8, got {arr.dtype.name}")
    out = bytearray()
    for row in arr:
        buf = io.BytesIO()
        Image.fromarray(row).save(buf, format="JPEG", quality=quality)
        blob = buf.getvalue()
        out += len(blob).to_bytes(4, "little") + blob
    return bytes(out)


def raw_to_array(raw: pb.RawTensor) -> np.ndarray:
    dtype = dtype_from_name(raw.dtype)
    shape = tuple(raw.shape)
    encoding = getattr(raw, "encoding", "") or ""
    if encoding == "jpeg-rows":
        return _decode_jpeg_rows(raw.data, shape, dtype)
    expected = _declared_nbytes(shape, dtype)
    if encoding == "zlib":
        import zlib

        # Two-stage bomb defence: the shape-declared size itself is checked
        # against SELDON_MAX_DECODED_BYTES (shape is attacker-declared, so
        # capping at expected+1 alone would still allow a multi-GB inflate),
        # then decompression is bounded at that declared size.
        _check_decoded_size(expected, shape, raw.dtype)
        d = zlib.decompressobj()
        try:
            data = d.decompress(raw.data, expected + 1)
        except zlib.error as e:
            raise PayloadError(f"bad zlib raw tensor: {e}") from e
        if len(data) > expected or d.unconsumed_tail or not d.eof:
            raise PayloadError(
                f"zlib raw tensor inflates past shape {shape} x {raw.dtype}"
            )
    elif encoding == "":
        data = raw.data
    else:
        raise PayloadError(f"unknown raw encoding {encoding!r}")
    if len(data) != expected:
        raise PayloadError(
            f"raw tensor: {len(data)} bytes != shape {shape} x {raw.dtype}"
        )
    # frombuffer is zero-copy; the result is read-only which is fine because
    # the next hop is to_device (which copies to the device) or a copy.
    return np.frombuffer(data, dtype=dtype).reshape(shape)


def tensor_to_array(tensor: pb.Tensor) -> np.ndarray:
    arr = np.asarray(tensor.values, dtype=np.float64)
    shape = tuple(tensor.shape)
    if shape:
        if int(np.prod(shape)) != arr.size:
            raise PayloadError(f"tensor: {arr.size} values != shape {shape}")
        arr = arr.reshape(shape)
    return arr


def ndarray_value_to_array(listvalue) -> np.ndarray:
    from google.protobuf import json_format

    nested = json_format.MessageToDict(listvalue)
    return np.asarray(nested)


def proto_data_to_array(data: pb.DefaultData) -> np.ndarray:
    which = data.WhichOneof("data_oneof")
    if which == "raw":
        return raw_to_array(data.raw)
    if which == "tensor":
        return tensor_to_array(data.tensor)
    if which == "ndarray":
        return ndarray_value_to_array(data.ndarray)
    raise PayloadError("DefaultData has no tensor/ndarray/raw payload")


# ---------------------------------------------------------------------------
# numpy -> tensor encodings
# ---------------------------------------------------------------------------


def _raw_fields(arr: ArrayLike, encoding: str = "",
                jpeg_quality: int = 90) -> _Raw:
    np_arr = np.ascontiguousarray(_to_numpy(arr))
    if encoding == "jpeg-rows":
        data = encode_jpeg_rows(np_arr, quality=jpeg_quality)
    elif encoding == "zlib":
        import zlib

        data = zlib.compress(np_arr.tobytes(), level=1)
    elif encoding == "":
        data = np_arr.tobytes()
    else:
        raise PayloadError(f"unknown raw encoding {encoding!r}")
    return _Raw(dtype_name(np_arr.dtype), tuple(np_arr.shape), data, encoding)


def array_to_raw(arr: ArrayLike, encoding: str = "",
                 jpeg_quality: int = 90) -> pb.RawTensor:
    r = _raw_fields(arr, encoding, jpeg_quality)
    return pb.RawTensor(
        dtype=r.dtype, shape=list(r.shape), data=r.data, encoding=r.encoding
    )


def array_to_tensor(arr: ArrayLike) -> pb.Tensor:
    np_arr = _to_numpy(arr).astype(np.float64, copy=False)
    return pb.Tensor(shape=list(np_arr.shape), values=np_arr.ravel().tolist())


def array_to_proto_data(
    arr: ArrayLike, names: Optional[List[str]] = None, encoding: str = "raw"
) -> pb.DefaultData:
    data = pb.DefaultData(names=list(names) if names else [])
    if encoding == "raw":
        data.raw.CopyFrom(array_to_raw(arr))
    elif encoding == "tensor":
        data.tensor.CopyFrom(array_to_tensor(arr))
    elif encoding == "ndarray":
        from google.protobuf import json_format

        json_format.ParseDict(_to_numpy(arr).tolist(), data.ndarray)
    else:
        raise PayloadError(f"unknown tensor encoding {encoding!r}")
    return data


# ---------------------------------------------------------------------------
# JSON body <-> numpy (REST fast path: no proto objects constructed)
# ---------------------------------------------------------------------------


def json_data_to_array(data: JsonDict) -> np.ndarray:
    if "raw" in data:
        raw = data["raw"]
        if not isinstance(raw, dict):
            raise PayloadError(f"raw tensor must be an object, got {type(raw).__name__}")
        buf = raw.get("data")
        if isinstance(buf, (bytes, bytearray, memoryview)):
            # zero-copy interior path: proto_to_json keeps raw tensor bytes
            # as bytes, so in-process hops never pay the base64 tax
            buf = bytes(buf)
        else:
            try:
                buf = base64.b64decode(raw["data"])
            except (KeyError, TypeError, ValueError) as e:
                raise PayloadError(f"bad raw tensor in JSON: {e}") from e
        return raw_to_array(_Raw(
            dtype=raw.get("dtype", "float32"),
            shape=tuple(int(s) for s in raw.get("shape", [])),
            data=buf,
            encoding=raw.get("encoding", ""),
        ))
    if "tensor" in data:
        t = data["tensor"]
        arr = np.asarray(t.get("values", []), dtype=np.float64)
        shape = tuple(int(s) for s in t.get("shape", ()))
        if shape:
            if int(np.prod(shape)) != arr.size:
                raise PayloadError(f"tensor: {arr.size} values != shape {shape}")
            arr = arr.reshape(shape)
        return arr
    if "ndarray" in data:
        try:
            return np.asarray(data["ndarray"])
        except ValueError as e:
            raise PayloadError(f"ragged ndarray: {e}") from e
    raise PayloadError("JSON data has no tensor/ndarray/raw field")


def array_to_json_data(
    arr: ArrayLike, names: Optional[List[str]] = None, encoding: str = "ndarray"
) -> JsonDict:
    np_arr = _to_numpy(arr)
    out: JsonDict = {"names": list(names) if names else []}
    # "raw/zlib" and "raw/jpeg-rows" select a wire compression for the
    # bytes (client edge; decoded host-side by raw_to_array)
    raw_encoding = ""
    if encoding.startswith("raw/"):
        encoding, raw_encoding = "raw", encoding[4:]
    if encoding == "raw":
        # interior representation keeps BYTES (zero-copy all the way to the
        # proto edge); JSON edges base64 them via jsonable()/_json_default
        np_arr = np.ascontiguousarray(np_arr)
        r = _raw_fields(np_arr, encoding=raw_encoding)
        out["raw"] = {
            "dtype": r.dtype,
            "shape": list(r.shape),
            "data": r.data,
            **({"encoding": r.encoding} if r.encoding else {}),
        }
    elif encoding == "tensor":
        out["tensor"] = {
            "shape": list(np_arr.shape),
            "values": np_arr.astype(np.float64, copy=False).ravel().tolist(),
        }
    elif encoding == "ndarray":
        out["ndarray"] = np_arr.tolist()
    else:
        raise PayloadError(f"unknown tensor encoding {encoding!r}")
    return out


# ---------------------------------------------------------------------------
# Request part extraction / response construction
#
# The dispatch layer works on (payload, names, meta) triples in either
# representation. `Parts.datadef_type` remembers the requester's encoding so
# the response mirrors it (reference: python/seldon_core/utils.py:410-470).
# ---------------------------------------------------------------------------

TENSOR_KEYS = ("tensor", "ndarray", "raw")


class Parts:
    """Decoded request: exactly one of array/binary/string/jsondata is set."""

    __slots__ = ("array", "binary", "string", "jsondata", "names", "meta", "datadef_type")

    def __init__(
        self,
        array: Optional[np.ndarray] = None,
        binary: Optional[bytes] = None,
        string: Optional[str] = None,
        jsondata: Any = None,
        names: Optional[List[str]] = None,
        meta: Optional[JsonDict] = None,
        datadef_type: Optional[str] = None,
    ):
        self.array = array
        self.binary = binary
        self.string = string
        self.jsondata = jsondata
        self.names = names or []
        self.meta = meta or {}
        self.datadef_type = datadef_type

    @property
    def payload(self):
        if self.array is not None:
            return self.array
        if self.binary is not None:
            return self.binary
        if self.string is not None:
            return self.string
        return self.jsondata


def meta_from_proto(meta: pb.Meta) -> JsonDict:
    from google.protobuf import json_format

    return json_format.MessageToDict(meta)


def extract_parts_json(body: JsonDict) -> Parts:
    if not isinstance(body, dict):
        raise PayloadError("request body must be a JSON object")
    meta = body.get("meta") or {}
    if "data" in body:
        data = body["data"]
        datadef_type = next((k for k in TENSOR_KEYS if k in data), "ndarray")
        return Parts(
            array=json_data_to_array(data),
            names=list(data.get("names", [])),
            meta=meta,
            datadef_type=datadef_type,
        )
    if "binData" in body:
        try:
            raw = base64.b64decode(body["binData"])
        except (TypeError, ValueError) as e:
            raise PayloadError(f"bad binData: {e}") from e
        return Parts(binary=raw, meta=meta)
    if "strData" in body:
        return Parts(string=str(body["strData"]), meta=meta)
    if "jsonData" in body:
        return Parts(jsondata=body["jsonData"], meta=meta)
    # Empty-payload message (e.g. health probe predict) — treat as jsonData {}.
    return Parts(jsondata=None, meta=meta)


def extract_parts_proto(msg: pb.SeldonMessage) -> Parts:
    which = msg.WhichOneof("data_oneof")
    meta = meta_from_proto(msg.meta) if msg.HasField("meta") else {}
    if which == "data":
        return Parts(
            array=proto_data_to_array(msg.data),
            names=list(msg.data.names),
            meta=meta,
            datadef_type=msg.data.WhichOneof("data_oneof"),
        )
    if which == "bin_data":
        return Parts(binary=msg.bin_data, meta=meta)
    if which == "str_data":
        return Parts(string=msg.str_data, meta=meta)
    if which == "json_data":
        return Parts(jsondata=json.loads(msg.json_data) if msg.json_data else None, meta=meta)
    return Parts(jsondata=None, meta=meta)


def _is_arraylike(x) -> bool:
    if isinstance(x, np.ndarray):
        return True
    # torch.Tensor and other array types
    return hasattr(x, "__array__") and hasattr(x, "dtype") and hasattr(x, "shape")


def build_json_response(
    result: Any,
    names: Optional[List[str]] = None,
    datadef_type: Optional[str] = None,
    meta: Optional[JsonDict] = None,
) -> JsonDict:
    """Wrap a user-hook return value in the requester's encoding."""
    out: JsonDict = {}
    if meta:
        out["meta"] = meta
    if result is None:
        out["jsonData"] = None
    elif isinstance(result, (list, tuple)) or _is_arraylike(result):
        arr = result if _is_arraylike(result) else np.asarray(result)
        out["data"] = array_to_json_data(
            arr, names, effective_encoding(arr, datadef_type)
        )
    elif isinstance(result, bytes):
        out["binData"] = base64.b64encode(result).decode("ascii")
    elif isinstance(result, str):
        out["strData"] = result
    else:
        out["jsonData"] = result
    return out


def build_proto_response(
    result: Any,
    names: Optional[List[str]] = None,
    datadef_type: Optional[str] = None,
    meta: Optional[JsonDict] = None,
) -> pb.SeldonMessage:
    msg = pb.SeldonMessage()
    if meta:
        from google.protobuf import json_format

        json_format.ParseDict(meta, msg.meta)
    if result is None:
        msg.json_data = "null"
    elif isinstance(result, (list, tuple)) or _is_arraylike(result):
        arr = result if _is_arraylike(result) else np.asarray(result)
        enc = effective_encoding(arr, datadef_type or "raw")
        msg.data.CopyFrom(array_to_proto_data(arr, names, enc))
    elif isinstance(result, bytes):
        msg.bin_data = result
    elif isinstance(result, str):
        msg.str_data = result
    else:
        msg.json_data = json.dumps(result)
    return msg


# ---------------------------------------------------------------------------
# proto <-> JSON transcoding for whole messages (engine boundary)
# ---------------------------------------------------------------------------


def has_raw_bytes(message: JsonDict) -> bool:
    """True when message.data.raw.data carries interior BYTES (the
    zero-copy representation) — the single predicate shared by the
    binary-hop/jsonable/proto fast paths."""
    data = message.get("data") if isinstance(message, dict) else None
    raw = data.get("raw") if isinstance(data, dict) else None
    return raw is not None and isinstance(
        raw.get("data"), (bytes, bytearray, memoryview)
    )


def jsonable(body: JsonDict) -> JsonDict:
    """Return a json.dumps-safe copy: raw tensor bytes (the zero-copy
    interior representation) become base64 strings. Recurses through the
    message shapes that can nest tensors — Feedback's request/response/
    truth and SeldonMessageList — and is a no-op (same object) when the
    body carries no bytes."""
    if not isinstance(body, dict):
        return body
    out = None  # copy-on-write: only allocate when something changes

    def put(key, value):
        nonlocal out
        if out is None:
            out = dict(body)
        out[key] = value

    if has_raw_bytes(body):
        data = body["data"]
        new_data = dict(data)
        new_data["raw"] = dict(data["raw"])
        new_data["raw"]["data"] = base64.b64encode(bytes(data["raw"]["data"])).decode("ascii")
        put("data", new_data)
    for key in ("request", "response", "truth"):
        nested = body.get(key)
        if isinstance(nested, dict):
            converted = jsonable(nested)
            if converted is not nested:
                put(key, converted)
    for key in ("seldonMessages", "requests"):
        nested = body.get(key)
        if isinstance(nested, list):
            converted_list = [jsonable(m) for m in nested]
            if any(c is not m for c, m in zip(converted_list, nested)):
                put(key, converted_list)
    return out if out is not None else body


def proto_to_json(msg) -> JsonDict:
    from google.protobuf import json_format

    if (
        isinstance(msg, pb.SeldonMessage)
        and msg.HasField("data")
        and msg.data.WhichOneof("data_oneof") == "raw"
    ):
        # fast path: keep the raw tensor's bytes as bytes instead of paying
        # MessageToDict's base64 encode (which the unit would immediately
        # decode again) — measured ~27 ms/request host CPU for a 4.8 MB
        # batch of images on one core
        out: JsonDict = {}
        if msg.HasField("meta"):
            out["meta"] = json_format.MessageToDict(msg.meta)
        if msg.HasField("status"):
            out["status"] = json_format.MessageToDict(msg.status)
        raw = msg.data.raw
        out["data"] = {
            "names": list(msg.data.names),
            "raw": {
                "dtype": raw.dtype,
                "shape": list(raw.shape),
                "data": raw.data,
                **({"encoding": raw.encoding} if raw.encoding else {}),
            },
        }
        return out
    out = json_format.MessageToDict(msg)
    # proto json_data is a STRING field; the JSON-side convention (REST
    # bodies, unit hooks) is the decoded structure — decode here so the
    # gRPC front hands units the same shape the REST front does
    if isinstance(out.get("jsonData"), str):
        try:
            out["jsonData"] = json.loads(out["jsonData"])
        except ValueError as e:
            raise PayloadError(f"malformed jsonData payload: {e}") from e
    return out


def json_to_proto(body: JsonDict, msg_cls=None):
    from google.protobuf import json_format

    if msg_cls is None:
        msg_cls = pb.SeldonMessage
    # composite messages nest SeldonMessages that may carry interior raw
    # BYTES: build recursively so every level takes the bytes fast path
    # (ParseDict on a bytes value would silently base64-"decode" garbage)
    if msg_cls is pb.Feedback:
        unknown = set(body) - {"request", "response", "truth", "reward"}
        if unknown:
            # preserve ParseDict's strictness: a typo'd key must 400, not
            # silently drop the field it was meant to set
            raise PayloadError(f"unknown Feedback fields {sorted(unknown)}")
        msg = pb.Feedback()
        for key, field in (("request", msg.request), ("response", msg.response),
                           ("truth", msg.truth)):
            if isinstance(body.get(key), dict):
                field.CopyFrom(json_to_proto(body[key]))
        if "reward" in body:
            msg.reward = float(body["reward"])
        return msg
    if msg_cls is pb.SeldonMessageList:
        unknown = set(body) - {"seldonMessages", "seldon_messages"}
        if unknown:
            raise PayloadError(f"unknown SeldonMessageList fields {sorted(unknown)}")
        msg = pb.SeldonMessageList()
        for m in body.get("seldonMessages") or body.get("seldon_messages") or []:
            msg.seldon_messages.append(json_to_proto(m))
        return msg
    if msg_cls is pb.SeldonMessage and has_raw_bytes(body):
        # bytes fast path (mirror of proto_to_json's): build the proto
        # directly, ParseDict only sees the remaining JSON-safe fields
        raw = body["data"]["raw"]
        rest = {k: v for k, v in body.items() if k != "data"}
        msg = pb.SeldonMessage()
        try:
            json_format.ParseDict(rest, msg)
        except json_format.ParseError as e:
            raise PayloadError(str(e)) from e
        msg.data.names.extend(body["data"].get("names") or [])
        msg.data.raw.dtype = raw.get("dtype", "float32")
        msg.data.raw.shape.extend(int(s) for s in raw.get("shape", ()))
        msg.data.raw.data = bytes(raw["data"])
        msg.data.raw.encoding = raw.get("encoding", "")
        return msg
    if (
        msg_cls is pb.SeldonMessage
        and "jsonData" in body
        and not isinstance(body["jsonData"], (str, type(None)))
    ):
        # inverse of proto_to_json's decode: the structured payload goes
        # back into the proto's string field
        body = {**body, "jsonData": json.dumps(body["jsonData"])}
    msg = msg_cls()
    try:
        # jsonable() base64-encodes any interior bytes the fast paths above
        # did not consume, so ParseDict round-trips them correctly
        json_format.ParseDict(jsonable(body), msg)
    except json_format.ParseError as e:
        raise PayloadError(str(e)) from e
    return msg


# ---------------------------------------------------------------------------
# Device placement
# ---------------------------------------------------------------------------


def to_device(arr: ArrayLike, device, dtype=None):
    """Host array -> tensor on ``device`` (optionally cast).

    A downcast (e.g. to bfloat16) happens on the device after the copy
    when numpy cannot represent the target type, and on the host
    otherwise, so the host-to-device copy moves the smaller array."""
    import torch

    np_arr = np.ascontiguousarray(_to_numpy(arr))
    if not np_arr.flags.writeable:
        np_arr = np_arr.copy()
    tdt = None
    if dtype is not None:
        tdt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, str(dtype))
        np_name = str(tdt).replace("torch.", "")
        if np_name in ("float16", "float32", "float64") and \
                np.dtype(np_name).itemsize < np_arr.dtype.itemsize:
            np_arr = np_arr.astype(np_name)
    out = torch.from_numpy(np_arr).to(device)
    if tdt is not None and out.dtype != tdt:
        out = out.to(tdt)
    return out
