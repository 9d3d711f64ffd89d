"""Literal FlatBuffers transport: the ``<Class> FBS`` microservice front.

Counterpart of ``seldon_core_tpu/fbs.py``. A length-prefixed TCP framing
carries ``SeldonRPC { method, SeldonMessage }`` flatbuffers of the
``fbs/prediction.fbs`` schema: 4-byte little-endian payload length, then
the flatbuffer. The response is a ``SeldonRPC`` with ``method =
RESPONSE``.

The port carries its own flatbuffers runtime and needs no ``flatbuffers``
package: :class:`_Builder` implements exactly the builder calls the
encoder makes, with the Python flatbuffers builder's layout (built back
to front, the same alignment padding, the same vtable deduplication), so
a frame is byte-identical to the JAX package's for the same message. The
decoder reads the buffer with ``struct`` and ``numpy.frombuffer``.

The schema's ``Tensor.values:[double]`` costs 4x the bytes of bf16 and
cannot carry extended dtypes; the preferred binary encoding is protobuf
with ``RawTensor`` on the REST port (``application/x-protobuf``). A
``jsonData`` answer (a generate server's) crosses as a JSON string in
``StrData``, the schema having no JSON member.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

SELDON_PROTOCOL_V1 = 134361921  # fbs/prediction.fbs SeldonProtocolVersion.V1
METHOD_PREDICT = 0
METHOD_RESPONSE = 1
STATUS_SUCCESS = 0
STATUS_FAILURE = 1
# union Data { DefaultData = 1, ByteData = 2, StrData = 3 } (union types
# are 1-indexed in flatbuffers; 0 = NONE)
DATA_DEFAULT = 1
DATA_BYTES = 2
DATA_STR = 3
PAYLOAD_SELDON_MESSAGE = 1


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------


class _Builder:
    """A flatbuffer built back to front into ``buf``: ``head`` is where the
    written data starts, and an offset is counted from the buffer's end.

    Each call follows the flatbuffers Python builder step for step:
    ``Prep`` pads so that a scalar lands aligned after ``additional``
    bytes (and raises the buffer's minimum alignment to the largest
    scalar seen), a table's vtable is looked up by its field offsets and
    object size and written only if no equal one exists, and ``Finish``
    aligns the root offset to the minimum alignment."""

    def __init__(self, initial_size: int = 1024):
        self.buf = bytearray(initial_size)
        self.head = initial_size
        self.minalign = 1
        self.vtable: Optional[list] = None
        self.object_end = 0
        self.vtables: Dict[tuple, int] = {}
        self.vector_num_elems = 0
        self.finished = False

    # -- raw space ----------------------------------------------------------

    def Offset(self) -> int:
        return len(self.buf) - self.head

    def _grow(self) -> None:
        new_size = max(1, len(self.buf) * 2)
        grown = bytearray(new_size)
        grown[new_size - len(self.buf):] = self.buf
        self.head += new_size - len(self.buf)
        self.buf = grown

    def Pad(self, n: int) -> None:
        if n > 0:
            self.head -= n
            self.buf[self.head:self.head + n] = bytes(n)

    def Prep(self, size: int, additional: int) -> None:
        if size > self.minalign:
            self.minalign = size
        align = (-(len(self.buf) - self.head + additional)) & (size - 1)
        while self.head < align + size + additional:
            self._grow()
        self.Pad(align)

    def _place(self, fmt: str, x) -> None:
        self.head -= struct.calcsize(fmt)
        struct.pack_into(fmt, self.buf, self.head, x)

    def _prepend(self, fmt: str, x) -> None:
        self.Prep(struct.calcsize(fmt), 0)
        self._place(fmt, x)

    def PrependInt32(self, x: int) -> None:
        self._prepend("<i", x)

    def PrependUOffsetTRelative(self, off: int) -> None:
        self.Prep(4, 0)
        if off > self.Offset():
            raise ValueError("flatbuffers: offset arithmetic error")
        self._place("<I", self.Offset() - off + 4)

    # -- vectors and strings ------------------------------------------------

    def StartVector(self, elem_size: int, num_elems: int, alignment: int) -> int:
        self.vector_num_elems = num_elems
        self.Prep(4, elem_size * num_elems)
        self.Prep(alignment, elem_size * num_elems)
        return self.Offset()

    def EndVector(self) -> int:
        self._place("<I", self.vector_num_elems)
        return self.Offset()

    def _bytes(self, data: bytes) -> None:
        self.head -= len(data)
        self.buf[self.head:self.head + len(data)] = data

    def CreateString(self, s) -> int:
        data = s.encode("utf-8") if isinstance(s, str) else bytes(s)
        self.Prep(4, len(data) + 1)
        self._place("<B", 0)
        self._bytes(data)
        self.vector_num_elems = len(data)
        return self.EndVector()

    def CreateByteVector(self, data: bytes) -> int:
        self.Prep(4, len(data))
        self._bytes(data)
        self.vector_num_elems = len(data)
        return self.EndVector()

    def CreateNumpyVector(self, x: np.ndarray) -> int:
        self.StartVector(x.itemsize, x.size, x.dtype.alignment)
        self._bytes(x.astype(x.dtype.newbyteorder("<"), copy=False).tobytes(order="C"))
        self.vector_num_elems = x.size
        return self.EndVector()

    # -- tables -------------------------------------------------------------

    def StartObject(self, num_fields: int) -> None:
        self.vtable = [0] * num_fields
        self.object_end = self.Offset()

    def _slot(self, slot: int) -> None:
        self.vtable[slot] = self.Offset()

    def _prepend_slot(self, fmt: str, slot: int, x: int, default: int) -> None:
        if x != default:
            self._prepend(fmt, x)
            self._slot(slot)

    def PrependInt8Slot(self, slot: int, x: int, default: int) -> None:
        self._prepend_slot("<b", slot, x, default)

    def PrependUint8Slot(self, slot: int, x: int, default: int) -> None:
        self._prepend_slot("<B", slot, x, default)

    def PrependInt32Slot(self, slot: int, x: int, default: int) -> None:
        self._prepend_slot("<i", slot, x, default)

    def PrependUOffsetTRelativeSlot(self, slot: int, off: int, default: int) -> None:
        if off != default:
            self.PrependUOffsetTRelative(off)
            self._slot(slot)

    def EndObject(self) -> int:
        # the object's vtable offset, patched once the vtable is placed
        self.Prep(4, 0)
        self._place("<i", 0)
        object_offset = self.Offset()
        used = len(self.vtable)
        while used and self.vtable[used - 1] == 0:
            used -= 1  # trailing empty slots are trimmed from the vtable
        fields = [object_offset - o if o else 0 for o in self.vtable[:used]]
        object_size = object_offset - self.object_end
        key = tuple(reversed(fields)) + (object_size,)
        existing = self.vtables.get(key)
        if existing is None:
            for field in reversed(fields):
                self._prepend("<H", field)
            self._prepend("<H", object_size)
            self._prepend("<H", (used + 2) * 2)
            struct.pack_into("<i", self.buf, len(self.buf) - object_offset,
                             self.Offset() - object_offset)
            self.vtables[key] = self.Offset()
        else:
            self.head = len(self.buf) - object_offset
            struct.pack_into("<i", self.buf, self.head, existing - object_offset)
        self.vtable = None
        return object_offset

    def Finish(self, root: int) -> None:
        self.Prep(self.minalign, 4)
        self.PrependUOffsetTRelative(root)
        self.finished = True

    def Output(self) -> bytes:
        if not self.finished:
            raise RuntimeError("flatbuffers: Output() before Finish()")
        return bytes(self.buf[self.head:])


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _build_tensor(b: _Builder, arr: np.ndarray) -> int:
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    # values vector (doubles) — schema Tensor.values:[double]
    values = b.CreateNumpyVector(arr.ravel())
    shape_list = list(arr.shape)
    b.StartVector(4, len(shape_list), 4)
    for s in reversed(shape_list):
        b.PrependInt32(s)
    shape = b.EndVector()
    b.StartObject(2)
    b.PrependUOffsetTRelativeSlot(0, shape, 0)
    b.PrependUOffsetTRelativeSlot(1, values, 0)
    return b.EndObject()


def _build_default_data(b: _Builder, arr: np.ndarray, names) -> int:
    name_offs = [b.CreateString(str(n)) for n in (names or [])]
    names_vec = 0
    if name_offs:
        b.StartVector(4, len(name_offs), 4)
        for off in reversed(name_offs):
            b.PrependUOffsetTRelative(off)
        names_vec = b.EndVector()
    tensor = _build_tensor(b, arr)
    b.StartObject(2)
    if names_vec:
        b.PrependUOffsetTRelativeSlot(0, names_vec, 0)
    b.PrependUOffsetTRelativeSlot(1, tensor, 0)
    return b.EndObject()


def _build_status(b: _Builder, code: int, info: str, flag: int) -> int:
    info_off = b.CreateString(info) if info else 0
    b.StartObject(4)
    b.PrependInt32Slot(0, code, 0)
    if info_off:
        b.PrependUOffsetTRelativeSlot(1, info_off, 0)
    b.PrependInt8Slot(3, flag, 0)
    return b.EndObject()


def _build_meta(b: _Builder, puid: str) -> int:
    puid_off = b.CreateString(puid) if puid else 0
    b.StartObject(3)
    if puid_off:
        b.PrependUOffsetTRelativeSlot(0, puid_off, 0)
    return b.EndObject()


def encode_message(
    arr: Optional[np.ndarray] = None,
    names=None,
    *,
    str_data: Optional[str] = None,
    bin_data: Optional[bytes] = None,
    puid: str = "",
    status: Optional[Tuple[int, str, int]] = None,
    method: int = METHOD_PREDICT,
) -> bytes:
    """numpy/str/bytes -> length-prefixed SeldonRPC flatbuffer."""
    b = _Builder(1024)
    data_off, data_type = 0, 0
    if arr is not None:
        data_off = _build_default_data(b, np.asarray(arr), names)
        data_type = DATA_DEFAULT
    elif str_data is not None:
        s = b.CreateString(str_data)
        b.StartObject(1)
        b.PrependUOffsetTRelativeSlot(0, s, 0)
        data_off = b.EndObject()
        data_type = DATA_STR
    elif bin_data is not None:
        vec = b.CreateByteVector(bin_data)
        b.StartObject(1)
        b.PrependUOffsetTRelativeSlot(0, vec, 0)
        data_off = b.EndObject()
        data_type = DATA_BYTES
    status_off = _build_status(b, *status) if status else 0
    meta_off = _build_meta(b, puid)
    # SeldonMessage: protocol s0, status s1, meta s2, data_type s3, data s4
    b.StartObject(5)
    b.PrependInt32Slot(0, SELDON_PROTOCOL_V1, 0)
    if status_off:
        b.PrependUOffsetTRelativeSlot(1, status_off, 0)
    if meta_off:
        b.PrependUOffsetTRelativeSlot(2, meta_off, 0)
    if data_type:
        b.PrependUint8Slot(3, data_type, 0)
        b.PrependUOffsetTRelativeSlot(4, data_off, 0)
    msg = b.EndObject()
    # SeldonRPC: method s0, message_type s1, message s2
    b.StartObject(3)
    b.PrependInt8Slot(0, method, 0)
    b.PrependUint8Slot(1, PAYLOAD_SELDON_MESSAGE, 0)
    b.PrependUOffsetTRelativeSlot(2, msg, 0)
    rpc = b.EndObject()
    b.Finish(rpc)
    payload = b.Output()
    return struct.pack("<I", len(payload)) + payload


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


class _T:
    """A table at ``pos`` of ``buf``: each field is found through the
    table's vtable (``pos`` minus the signed offset stored at ``pos``)."""

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_size = struct.unpack_from("<H", buf, self.vt)[0]

    def _field(self, slot: int) -> int:
        """The field's absolute position, or 0 when it is absent."""
        vo = 4 + 2 * slot
        if vo >= self.vt_size:
            return 0
        off = struct.unpack_from("<H", self.buf, self.vt + vo)[0]
        return self.pos + off if off else 0

    def _scalar(self, fmt: str, slot: int, default: int) -> int:
        p = self._field(slot)
        return struct.unpack_from(fmt, self.buf, p)[0] if p else default

    def i32(self, slot: int, default: int = 0) -> int:
        return self._scalar("<i", slot, default)

    def i8(self, slot: int, default: int = 0) -> int:
        return self._scalar("<b", slot, default)

    def u8(self, slot: int, default: int = 0) -> int:
        return self._scalar("<B", slot, default)

    def _indirect(self, p: int) -> int:
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def _string_at(self, p: int) -> str:
        start = self._indirect(p)
        n = struct.unpack_from("<I", self.buf, start)[0]
        return bytes(self.buf[start + 4:start + 4 + n]).decode("utf-8")

    def string(self, slot: int) -> Optional[str]:
        p = self._field(slot)
        return self._string_at(p) if p else None

    def table(self, slot: int) -> Optional["_T"]:
        p = self._field(slot)
        return _T(self.buf, self._indirect(p)) if p else None

    # a union value slot stores an offset to the member table, exactly
    # like a table field — one reader serves both
    union_table = table

    def _vector(self, slot: int) -> Tuple[int, int]:
        """(start of the elements, element count), or (0, 0) if absent."""
        p = self._field(slot)
        if not p:
            return 0, 0
        start = self._indirect(p)
        return start + 4, struct.unpack_from("<I", self.buf, start)[0]

    def vector_np(self, slot: int, dtype) -> np.ndarray:
        start, n = self._vector(slot)
        if not start:
            return np.zeros((0,), dtype)
        return np.frombuffer(self.buf, dtype=np.dtype(dtype).newbyteorder("<"),
                             count=n, offset=start)

    def string_vector(self, slot: int):
        start, n = self._vector(slot)
        return [self._string_at(start + 4 * i) for i in range(n)]


def decode_message(blob: bytes, *, prefixed: bool = True) -> Dict[str, Any]:
    """SeldonRPC flatbuffer -> dict with keys method, data
    (np.ndarray | None), names, strData, binData, puid,
    status {code, info, status}.

    Framing is explicit: ``prefixed=True`` (the default; ``encode_message``
    writes 4-byte length-prefixed frames) reads the root after the
    prefix, ``prefixed=False`` parses a bare flatbuffer. The prefix is
    never guessed from the first word: a bare buffer whose root offset
    happens to equal len-4 must not be misparsed from the wrong base."""
    base = 0
    if prefixed:
        if len(blob) < 4:
            raise ValueError("length-prefixed flatbuffer shorter than 4 bytes")
        (ln,) = struct.unpack_from("<I", blob)
        if ln != len(blob) - 4:
            raise ValueError(
                f"flatbuffer length prefix {ln} != payload size {len(blob) - 4}"
            )
        # offsets are relative, so the root is simply shifted by the
        # prefix: no copy of the (up to 64 MiB) frame
        base = 4
    buf = blob if isinstance(blob, (bytes, bytearray)) else bytes(blob)
    rpc = _T(buf, base + struct.unpack_from("<I", buf, base)[0])
    out: Dict[str, Any] = {
        "method": rpc.i8(0),
        "data": None, "names": [], "strData": None, "binData": None,
        "puid": "", "status": None,
    }
    if rpc.u8(1) != PAYLOAD_SELDON_MESSAGE:
        return out
    msg = rpc.union_table(2)
    if msg is None:
        return out
    protocol = msg.i32(0)
    if protocol and protocol != SELDON_PROTOCOL_V1:
        raise ValueError(f"unknown fbs protocol version {protocol}")
    st = msg.table(1)
    if st is not None:
        out["status"] = {
            "code": st.i32(0), "info": st.string(1) or "",
            "status": "FAILURE" if st.i8(3) == STATUS_FAILURE else "SUCCESS",
        }
    meta = msg.table(2)
    if meta is not None:
        out["puid"] = meta.string(0) or ""
    dtype_tag = msg.u8(3)
    data = msg.union_table(4)
    if data is None:
        return out
    if dtype_tag == DATA_DEFAULT:
        out["names"] = data.string_vector(0)
        tensor = data.table(1)
        if tensor is not None:
            shape = tensor.vector_np(0, np.int32)
            arr = np.array(tensor.vector_np(1, np.float64), dtype=np.float64)
            if shape.size:
                arr = arr.reshape([int(s) for s in shape])
            out["data"] = arr
    elif dtype_tag == DATA_STR:
        out["strData"] = data.string(0)
    elif dtype_tag == DATA_BYTES:
        out["binData"] = data.vector_np(0, np.int8).tobytes()
    return out


# ---------------------------------------------------------------------------
# TCP server (the FBS microservice front)
# ---------------------------------------------------------------------------


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes or None on EOF (shared by server and client)."""
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(min(65536, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return buf


class FBSServer:
    """Length-prefixed FlatBuffers predict server: one SeldonRPC in, one
    SeldonRPC (method=RESPONSE) out, connection kept alive. Runs the user
    object's predict through the same dispatch the REST front uses."""

    MAX_FRAME = 64 << 20  # same OOM guard as the HTTP fronts

    def __init__(self, user_object, host: str = "0.0.0.0", port: int = 5000,
                 reuse_port: bool = False):
        self.user_object = user_object
        self.host, self.port = host, port
        self.reuse_port = reuse_port
        self._srv: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def start(self) -> "FBSServer":
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if self.reuse_port:
            # --workers: every worker binds the same port and the kernel
            # spreads the accepted connections over them
            self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        self._srv.bind((self.host, self.port))
        if self.port == 0:
            self.port = self._srv.getsockname()[1]
        self._srv.listen(16)
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="fbs-accept").start()
        return self

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="fbs-conn").start()

    def _serve_conn(self, conn: socket.socket):
        from .seldon_methods import predict

        try:
            while not self._stop.is_set():
                head = _recv_exact(conn, 4)
                if head is None:
                    return
                (ln,) = struct.unpack("<I", head)
                if ln > self.MAX_FRAME:
                    # drain (bounded) before responding: closing with the
                    # frame still inbound resets the socket and destroys
                    # the 413 before the client reads it
                    conn.settimeout(1.0)
                    remaining = ln
                    try:
                        while remaining > 0:
                            chunk = conn.recv(min(65536, remaining))
                            if not chunk:
                                break
                            remaining -= len(chunk)
                    except socket.timeout:
                        pass
                    conn.sendall(encode_message(
                        status=(413, f"frame {ln} exceeds {self.MAX_FRAME}",
                                STATUS_FAILURE),
                        method=METHOD_RESPONSE,
                    ))
                    return
                payload = _recv_exact(conn, ln)
                if payload is None:
                    return
                try:
                    req = decode_message(head + payload)
                    if req["method"] != METHOD_PREDICT:
                        conn.sendall(encode_message(
                            status=(400, f"unsupported method {req['method']}"
                                    " (only PREDICT is served)", STATUS_FAILURE),
                            method=METHOD_RESPONSE,
                        ))
                        continue
                    body: Dict[str, Any] = {}
                    if req["data"] is not None:
                        body["data"] = {"ndarray": req["data"].tolist(),
                                        "names": req["names"]}
                    elif req["strData"] is not None:
                        body["strData"] = req["strData"]
                    elif req["binData"] is not None:
                        import base64

                        body["binData"] = base64.b64encode(
                            req["binData"]).decode("ascii")
                    out = predict(self.user_object, body)
                    data = out.get("data") or {}
                    arr = None
                    if "ndarray" in data:
                        arr = np.asarray(data["ndarray"])
                    elif "tensor" in data:
                        t = data["tensor"]
                        arr = np.asarray(t.get("values", [])).reshape(
                            t.get("shape", [-1])
                        )
                    elif "raw" in data:
                        from .payload import json_data_to_array

                        arr = json_data_to_array(data)
                    str_out = out.get("strData")
                    bin_out = None
                    if out.get("binData") is not None:
                        import base64

                        bin_out = base64.b64decode(out["binData"])
                    elif str_out is None and out.get("jsonData") is not None:
                        # the schema has no jsonData: it crosses as a
                        # JSON string in StrData
                        import json as _json

                        str_out = _json.dumps(out["jsonData"])
                    resp = encode_message(
                        arr,
                        data.get("names"),
                        str_data=str_out,
                        bin_data=bin_out,
                        puid=(out.get("meta") or {}).get("puid", ""),
                        status=(200, "", STATUS_SUCCESS),
                        method=METHOD_RESPONSE,
                    )
                except Exception as e:  # noqa: BLE001 - wire errors back
                    resp = encode_message(
                        status=(500, f"{type(e).__name__}: {e}", STATUS_FAILURE),
                        method=METHOD_RESPONSE,
                    )
                conn.sendall(resp)
        except OSError:
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def close(self):
        """Stop accepting AND unblock live handlers (a bare listener close
        would leave keep-alive connections parked in recv forever)."""
        self._stop.set()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        with self._conns_lock:
            live = list(self._conns)
        for conn in live:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


def fbs_predict(host: str, port: int, arr, names=None, timeout: float = 10.0):
    """Client helper: one predict round-trip over the FBS transport."""
    with socket.create_connection((host, port), timeout) as conn:
        conn.sendall(encode_message(np.asarray(arr), names))
        head = _recv_exact(conn, 4)
        if head is None:
            raise ConnectionError("fbs server closed mid-response")
        (ln,) = struct.unpack("<I", head)
        payload = _recv_exact(conn, ln)
        if payload is None:
            raise ConnectionError("fbs server closed mid-response")
    return decode_message(head + payload)
