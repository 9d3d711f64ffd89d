"""Client of the engine's gRPC ``Seldon/Predict`` with raw tensors.

A request is a SeldonMessage whose ``data.raw`` holds the rows as
little-endian int32 (the wire's ``raw`` encoding, ``payload.py``); the
answer's ``data.raw`` holds the logits. The messages are written and read
here from the protocol's wire format (field numbers of
``prediction.proto``: SeldonMessage.data 3, DefaultData.raw 4, RawTensor
dtype 1 / shape 2 / data 3), so the load generator needs only ``grpc``
and numpy, and nothing of the program.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np

METHOD = "/seldontpu.Seldon/Predict"


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def encode(rows: np.ndarray) -> bytes:
    shape = b"".join(_varint(int(d)) for d in rows.shape)
    raw = (_field(1, b"int32") + _field(2, shape)
           + _field(3, np.ascontiguousarray(rows, dtype="<i4").tobytes()))
    return _field(3, _field(4, raw))


def _fields(buf: bytes) -> List[Tuple[int, int, Any]]:
    """(field number, wire type, value) of each field of one message."""
    out, i = [], 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
        elif wt == 2:
            n, i = _read_varint(buf, i)
            val, i = buf[i:i + n], i + n
        elif wt == 1:
            val, i = buf[i:i + 8], i + 8
        elif wt == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"wire type {wt} in a response")
        out.append((num, wt, val))
    return out


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _packed(buf: bytes) -> List[int]:
    out, i = [], 0
    while i < len(buf):
        v, i = _read_varint(buf, i)
        out.append(v)
    return out


def decode(msg: bytes) -> np.ndarray:
    """The float32 array of a response's ``data.raw``."""
    for num, _wt, val in _fields(msg):
        if num != 3:
            continue
        for dnum, _dwt, dval in _fields(val):
            if dnum == 4:
                f = {n: v for n, _w, v in _fields(dval)}
                dtype = np.dtype(f.get(1, b"").decode()).newbyteorder("<")
                arr = np.frombuffer(f.get(3, b""), dtype)
                return arr.reshape(_packed(f.get(2, b""))).astype(np.float32)
    raise ValueError("response carries no raw tensor")


def body(plan, i: int, _params: Dict[str, Any]) -> bytes:
    """Request ``i``'s bytes (the load generator builds them all before
    the window)."""
    return encode(plan.rows(i))


class _Conn:
    def __init__(self, host: str, port: int):
        import grpc

        self.grpc = grpc
        opts = [("grpc.max_send_message_length", 1 << 30),
                ("grpc.max_receive_message_length", 1 << 30)]
        self.channel = grpc.aio.insecure_channel(f"{host}:{port}", options=opts)
        self.rpc = self.channel.unary_unary(
            METHOD, request_serializer=lambda b: b, response_deserializer=lambda b: b)


async def open(host: str, port: int, params: Dict[str, Any]) -> _Conn:
    """One channel for the whole run."""
    return _Conn(host, port)


async def close(conn: _Conn) -> None:
    await conn.channel.close()


async def send(conn: _Conn, data: bytes, rec: Dict[str, Any]) -> None:
    """Send one predict request (``data``, from :func:`body`); fill ``rec``
    with ``out`` (the logits as a list) and ``done``, or ``error`` (and
    ``refused`` when the engine shed it)."""
    try:
        out = await conn.rpc(data, timeout=600.0)
    except conn.grpc.RpcError as e:
        rec["error"] = f"gRPC {e.code().name}: {e.details()}"
        # RESOURCE_EXHAUSTED: shed before work (the engine's 429)
        rec["refused"] = e.code() == conn.grpc.StatusCode.RESOURCE_EXHAUSTED
        return
    rec["done"] = time.monotonic()
    rec["out"] = decode(out).tolist()
