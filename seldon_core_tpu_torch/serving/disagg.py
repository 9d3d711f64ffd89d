"""Prefill/decode disaggregation: KV-slab wire codec + transports.

The port's own copy of ``seldon_core_tpu/serving/disagg.py`` (it imports
nothing of the JAX package). Prefill and decode run in independently
scaled pools, and the finished prompt K/V slab crosses a transport
instead of a lane insert. This module is the wire half -- the batcher
half lives in ``continuous.py`` (``ContinuousBatcher.export_prefill`` /
``admit_remote``).

The unit of transfer is a **slab message**: the ``cache_one``-layout
prompt K/V stack ``{"k","v"}`` of ``[L, 1, KV, W, Dh]`` host tensors
plus a metadata dict (prompt tokens + hash, dtype/layout, the first
sampled token, the post-split RNG lane key, ``weight_version``,
sampling params, and ``covered_len`` -- how many leading prompt tokens
the decode side already holds in its radix prefix cache, so only the
suffix slab is on the wire).

Wire format (version ``SKV1``), streamed **layer-major** so the decode
side can start on layer 0 while layer L-1 is still in flight::

    b"SKV1" | u32 header_len | u32 crc32(header) | header JSON
    per layer l in 0..L-1, for each of k, v:
        u32 payload_len | u32 crc32(payload) | payload bytes
    b"SKVE" | u32 total_crc32 (running crc over every payload)

The header carries its own CRC because a flipped bit there is the
nastiest corruption: a still-valid-JSON header with a wrong
``first_token`` or RNG key would seed a lane with silently wrong output,
not a crash. Every frame is checksummed; a mismatch raises
:class:`ChecksumError` and a short read raises :class:`TruncatedStream`
-- both BEFORE any lane state exists on the decode side. Errors from the
prefill peer travel as a ``b"SKV!"``-prefixed JSON frame instead of a
header.

The frames are byte-identical to the JAX package's, header included: a
slab from one package decodes in the other. bfloat16 crosses as its raw
16-bit patterns under the header's ``"slab_dtype": "bfloat16"`` -- numpy
has no bfloat16 without ``ml_dtypes``, so :func:`encode_slab` takes
torch tensors (any device) or numpy arrays, and :func:`decode_slab`
returns CPU torch tensors of the slab's dtype, each assembled from the
payloads with one copy (into pinned memory when CUDA is available, so
the device upload is a single asynchronous copy).

Transports:

* :class:`LoopbackTransport` -- in-process: the decode server holds a
  direct reference to the prefill server, but the slab still round-trips
  the full encode/decode codec through memory.
* :class:`TcpKVClient` / :class:`PrefillTransportServer` -- chunked TCP:
  the client sends one JSON request line, the server streams the slab
  back in ``chunk_bytes`` writes, deadline-aware (the remaining request
  budget becomes the socket timeout on both connect and read).
* :class:`FailoverKVClient` -- a peer LIST with ejection, backoff,
  re-probe and readmission.
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import socket
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

MAGIC = b"SKV1"
END = b"SKVE"
ERR = b"SKV!"
WIRE_VERSION = 1

# slab dtypes the codec carries, by their header name (numpy's names,
# and "bfloat16" as ml_dtypes spells it)
_TORCH_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
}


class DisaggError(RuntimeError):
    """Base for disaggregation failures; carries a wire status so the
    graph executor surfaces it as a typed UnitCallError."""

    status = 502


class ChecksumError(DisaggError):
    """A slab frame's CRC did not match -- the stream is corrupt."""


class TruncatedStream(DisaggError):
    """The stream ended mid-frame -- nothing was admitted."""


class WeightVersionMismatch(DisaggError):
    """The slab was prefilled under a different weight version than the
    decode pool is serving: the K/V would be stale, refuse the splice."""

    status = 409


class PrefixGone(DisaggError):
    """The decode-side radix entry that justified suffix-only transfer
    was evicted before the admit; the caller re-requests a full slab."""


class TierMiss(DisaggError):
    """A peer prefix-lookup found nothing usable in the listener's host
    KV tier (no entry, below the promote gate, caps, or a weight-version
    gap). Peer-SPECIFIC state, not peer death: the failover layer
    rotates the lookup to another peer's tier WITHOUT ejecting, and when
    every consulted tier misses the decode side simply prefills as
    usual -- a cold tier must never look like a dead pool."""

    status = 404


class PeerBusy(DisaggError):
    """The prefill peer shed the transfer at its capacity bound -- busy,
    not dead. The failover layer tries another peer WITHOUT ejecting
    this one."""

    status = 503


class AllPeersDown(DisaggError):
    """Every configured prefill peer is currently ejected. The decode
    server catches this and degrades to LOCAL unified prefill, counting
    the regression in ``degraded_local_prefill``."""

    status = 503


def prompt_hash(tokens) -> str:
    return hashlib.sha256(np.asarray(tokens, np.int32).tobytes()).hexdigest()[:16]


def _read_exact(read: Callable[[int], bytes], n: int) -> bytes:
    """Read exactly n bytes or raise TruncatedStream."""
    chunks = []
    got = 0
    while got < n:
        b = read(n - got)
        if not b:
            raise TruncatedStream(f"stream ended after {got} of {n} expected bytes")
        chunks.append(b)
        got += len(b)
    return b"".join(chunks) if len(chunks) != 1 else chunks[0]


def _host_layers(arr):
    """``(dtype name, shape, [per-layer byte views])`` of one slab half:
    a torch tensor (any device; copied to the host once) or a numpy
    array (an ``ml_dtypes`` bfloat16 one included). The byte views share
    memory with the host copy, so framing copies nothing."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        t = t.contiguous()
        name = str(t.dtype).replace("torch.", "")
        flat = t.reshape(t.shape[0], -1)
        if t.element_size() > 1:
            flat = flat.view(torch.uint8)
        return name, tuple(t.shape), [flat[i].numpy() for i in range(t.shape[0])]
    a = np.ascontiguousarray(arr)
    flat = a.reshape(a.shape[0], -1).view(np.uint8)
    return str(a.dtype), tuple(a.shape), [flat[i] for i in range(a.shape[0])]


def encode_slab(
    meta: Dict[str, Any],
    slab: Dict[str, Any],
    chunk_bytes: int = 1 << 20,
) -> Iterator[bytes]:
    """Yield the wire frames of one slab message. ``slab`` holds ``k``
    and ``v`` ``[L, 1, KV, W, Dh]`` (torch tensors or numpy arrays);
    frames come out layer-major (k then v per layer) in writes of at
    most ``chunk_bytes`` so a streaming sender never holds more than one
    chunk in flight."""
    kname, kshape, klayers = _host_layers(slab["k"])
    vname, vshape, vlayers = _host_layers(slab["v"])
    if kshape != vshape or kname != vname:
        raise DisaggError(f"k/v mismatch: {kname}{kshape} vs {vname}{vshape}")
    header = dict(meta)
    header["wire_version"] = WIRE_VERSION
    header["shape"] = list(kshape)
    header["slab_dtype"] = kname
    hdr = json.dumps(header).encode()
    yield MAGIC + struct.pack("<II", len(hdr), zlib.crc32(hdr)) + hdr
    total_crc = 0
    for layer in range(kshape[0]):
        for lay in (klayers[layer], vlayers[layer]):
            payload = memoryview(lay)
            total_crc = zlib.crc32(payload, total_crc)
            yield struct.pack("<II", len(payload), zlib.crc32(payload))
            for off in range(0, len(payload), chunk_bytes):
                yield payload[off:off + chunk_bytes]
    yield END + struct.pack("<I", total_crc)


def buffer_reader(payload) -> Callable[[int], memoryview]:
    """A ``recv``-style reader over an in-memory message that hands out
    views of it, not copies (the host tier decodes its stored entries
    through it)."""
    view = memoryview(payload)
    pos = [0]

    def read(n: int) -> memoryview:
        b = view[pos[0]:pos[0] + n]
        pos[0] += len(b)
        return b

    return read


def decode_slab(
    read: Callable[[int], bytes],
    pin: Optional[bool] = None,
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Consume one slab message from ``read`` (a ``recv``-style callable
    returning up to n bytes, b"" at EOF). Returns ``(meta, slab)`` with
    ``slab`` CPU tensors of the header's dtype (pinned when ``pin``;
    default: when CUDA is available). Raises :class:`ChecksumError` /
    :class:`TruncatedStream` / :class:`DisaggError` -- always before
    returning partial data."""
    magic = _read_exact(read, 4)
    if magic == ERR:
        (n,) = struct.unpack("<I", _read_exact(read, 4))
        err = json.loads(bytes(_read_exact(read, n)))
        cls = {
            "weight_version": WeightVersionMismatch,
            "capacity": PeerBusy,
            "tier_miss": TierMiss,
        }.get(err.get("kind"), DisaggError)
        raise cls(err.get("error", "prefill peer error"))
    if magic != MAGIC:
        raise DisaggError(f"bad slab magic {magic!r} (want {MAGIC!r})")
    hdr_len, hdr_crc = struct.unpack("<II", _read_exact(read, 8))
    hdr = _read_exact(read, hdr_len)
    if zlib.crc32(hdr) != hdr_crc:
        raise ChecksumError("slab header failed its checksum")
    meta = json.loads(bytes(hdr))
    if meta.get("wire_version") != WIRE_VERSION:
        raise DisaggError(f"unsupported slab wire version {meta.get('wire_version')!r}")
    shape = tuple(meta["shape"])
    dtype = _TORCH_DTYPES.get(meta.get("slab_dtype"))
    if dtype is None:
        raise DisaggError(f"unsupported slab dtype {meta.get('slab_dtype')!r}")
    if len(shape) != 5:
        raise DisaggError(f"slab shape must be [L,1,KV,W,Dh], got {shape}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    layer_bytes = int(np.prod(shape[1:])) * itemsize
    pin = torch.cuda.is_available() if pin is None else pin
    out = {}
    host = {}
    for name in ("k", "v"):
        buf = torch.empty((shape[0] * layer_bytes,), dtype=torch.uint8, pin_memory=pin)
        out[name] = buf
        host[name] = buf.numpy()
    total_crc = 0
    for layer in range(shape[0]):
        for name in ("k", "v"):
            n, crc = struct.unpack("<II", _read_exact(read, 8))
            if n != layer_bytes:
                raise DisaggError(
                    f"layer {layer} {name} frame is {n} bytes, "
                    f"expected {layer_bytes} for shape {shape}"
                )
            payload = _read_exact(read, n)
            if zlib.crc32(payload) != crc:
                raise ChecksumError(f"layer {layer} {name} frame failed its checksum")
            total_crc = zlib.crc32(payload, total_crc)
            off = layer * layer_bytes
            host[name][off:off + n] = np.frombuffer(payload, np.uint8)
    tail = _read_exact(read, 8)
    if tail[:4] != END:
        raise TruncatedStream(f"missing end frame (got {tail[:4]!r})")
    (want,) = struct.unpack("<I", tail[4:])
    if want != total_crc:
        raise ChecksumError("stream total checksum mismatch")
    return meta, {name: buf.view(dtype).view(shape) for name, buf in out.items()}


def encode_error(err: Exception, kind: Optional[str] = None) -> bytes:
    if kind is None:
        if isinstance(err, WeightVersionMismatch):
            kind = "weight_version"
        elif isinstance(err, PeerBusy):
            kind = "capacity"
        elif isinstance(err, TierMiss):
            kind = "tier_miss"
        else:
            kind = "error"
    body = json.dumps({"error": str(err), "kind": kind}).encode()
    return ERR + struct.pack("<I", len(body)) + body


def encode_pong() -> bytes:
    """Health-probe answer, riding the SKV1 error-frame path: ``kind ==
    "pong"`` never raises -- the probing client reads it directly."""
    return encode_error(DisaggError("pong"), kind="pong")


# ---------------------------------------------------------------------------
# Transports
# ---------------------------------------------------------------------------


class LoopbackTransport:
    """In-process transport: a direct reference to the prefill-side
    handler, with the slab still round-tripping the full codec through a
    memory buffer (framing bugs can't hide behind shared memory).
    ``fault`` (resilience.faults.KVFaults) perturbs the byte stream the
    same way it perturbs the TCP reads."""

    name = "loopback"

    def __init__(self, prefill_server, chunk_bytes: int = 1 << 20, fault=None):
        self._server = prefill_server
        self._chunk = int(chunk_bytes)
        self._fault = fault
        self.addr = f"loopback:{id(prefill_server):x}"

    def prefill(self, request: Dict[str, Any], deadline_s: Optional[float] = None):
        if self._fault is not None:
            self._fault.before_connect()
        buf = io.BytesIO()
        try:
            meta, slab = self._server.prefill_export(request)
            for frame in encode_slab(meta, slab, self._chunk):
                buf.write(frame)
        except DisaggError as e:
            buf = io.BytesIO(encode_error(e))
        buf.seek(0)
        read = buf.read
        if self._fault is not None:
            read = self._fault.wrap_read(read)
        return decode_slab(read)

    def probe(self, timeout_s: float = 2.0) -> bool:
        """Loopback health probe: ask the in-process prefill server's
        ``kv_ping`` hook (False once its batcher is dead/closed)."""
        if self._fault is not None and not self._fault.connectable():
            return False
        ping = getattr(self._server, "kv_ping", None)
        if ping is None:
            return True
        try:
            return bool(ping())
        except Exception:  # noqa: BLE001 - an unhealthy peer must probe False
            return False

    def close(self) -> None:
        pass


class TcpKVClient:
    """Decode-side client for the chunked TCP transport: one connection
    per transfer (the slab dominates any handshake cost), deadline-aware
    -- the remaining request budget is the socket timeout for connect
    and every read."""

    name = "tcp"

    def __init__(self, peer: str, connect_timeout_s: float = 10.0, fault=None):
        host, _, port = peer.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"peer must be host:port, got {peer!r}")
        self.host, self.port = host, int(port)
        self.addr = f"{self.host}:{self.port}"
        self._connect_timeout = float(connect_timeout_s)
        self._fault = fault

    def prefill(self, request: Dict[str, Any], deadline_s: Optional[float] = None):
        timeout = (
            min(self._connect_timeout, deadline_s)
            if deadline_s is not None else self._connect_timeout
        )
        expires_at = time.monotonic() + deadline_s if deadline_s is not None else None
        try:
            if self._fault is not None:
                self._fault.before_connect()
            sock = socket.create_connection((self.host, self.port), timeout=timeout)
        except OSError as e:
            raise DisaggError(f"prefill peer {self.host}:{self.port} unreachable: {e}") from e

        def read(n: int) -> bytes:
            # the REMAINING budget bounds every read: a peer dripping one
            # chunk per almost-deadline must still finish the whole
            # transfer inside the request budget
            if expires_at is not None:
                remaining = expires_at - time.monotonic()
                if remaining <= 0:
                    raise socket.timeout("kv transfer budget exhausted")
                sock.settimeout(remaining)
            return sock.recv(n)

        if self._fault is not None:
            read = self._fault.wrap_read(read)
        try:
            sock.settimeout(
                max(0.001, expires_at - time.monotonic()) if expires_at is not None else 60.0
            )
            sock.sendall(json.dumps(request).encode() + b"\n")
            return decode_slab(read)
        except socket.timeout as e:
            raise DisaggError(
                f"kv transfer from {self.host}:{self.port} ran past the deadline"
            ) from e
        except OSError as e:
            # mid-stream connection loss surfaces with the same typed
            # status every other transport failure carries
            raise DisaggError(
                f"kv transfer from {self.host}:{self.port} failed mid-stream: {e}"
            ) from e
        finally:
            sock.close()

    def probe(self, timeout_s: float = 2.0) -> bool:
        """Cheap KV-port health ping: one connection, one ``{"ping":
        true}`` line, one SKV1 error-frame pong back -- no device work,
        no handler slot at the peer. True means the listener is up AND
        answering the wire protocol."""
        if self._fault is not None and not self._fault.connectable():
            return False
        try:
            sock = socket.create_connection((self.host, self.port), timeout=timeout_s)
        except OSError:
            return False
        try:
            sock.settimeout(timeout_s)
            sock.sendall(b'{"ping": true}\n')
            if _read_exact(sock.recv, 4) != ERR:
                return False
            (n,) = struct.unpack("<I", _read_exact(sock.recv, 4))
            body = json.loads(_read_exact(sock.recv, n))
            return body.get("kind") == "pong"
        except (OSError, ValueError, DisaggError):
            return False
        finally:
            sock.close()

    def close(self) -> None:
        pass


class PrefillTransportServer:
    """Prefill-side TCP listener: accepts one JSON request line per
    connection and streams the slab back frame by frame (``chunk_bytes``
    per write). Runs accept + handler threads, at most ``max_inflight``
    concurrently -- each handler holds a device prefill plus a whole
    host-side slab, so over-limit connections get an immediate typed
    shed frame (:class:`PeerBusy`) instead of queueing. ``close()``
    unblocks the accept loop."""

    def __init__(
        self,
        prefill_server,
        port: int = 0,
        host: str = "0.0.0.0",
        chunk_bytes: int = 1 << 20,
        max_inflight: int = 8,
    ):
        self._server = prefill_server
        self._chunk = int(chunk_bytes)
        self._slots = threading.Semaphore(max(1, int(max_inflight)))
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, name="kv-export", daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # closed
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        # ONE bounded read classifies the connection: pings are answered
        # WITHOUT consuming a handler slot (a pool at capacity is busy,
        # not dead), everything else hits the capacity check BEFORE the
        # rest of its request uploads (shed before work)
        try:
            conn.settimeout(60.0)
            first = conn.recv(65536)
            if not first:
                conn.close()
                return
        except Exception:  # noqa: BLE001 - one bad peer must not kill accept
            conn.close()
            return
        if first.startswith(b'{"ping"'):
            try:
                conn.sendall(encode_pong())
            except OSError:
                pass
            finally:
                conn.close()
            return
        if not self._slots.acquire(blocking=False):
            try:
                conn.sendall(encode_error(PeerBusy("prefill pool at capacity — retry")))
            except OSError:
                pass
            finally:
                conn.close()
            return
        try:
            self._handle_locked(conn, first)
        finally:
            self._slots.release()

    def _handle_locked(self, conn: socket.socket, line: bytes) -> None:
        try:
            while not line.endswith(b"\n"):
                b = conn.recv(65536)
                if not b:
                    return
                line += b
                if len(line) > 8 << 20:
                    raise DisaggError("oversized prefill request")
            request = json.loads(line)
            if request.get("ping"):
                conn.sendall(encode_pong())
                return
            try:
                meta, slab = self._server.prefill_export(request)
            except DisaggError as e:
                conn.sendall(encode_error(e))
                return
            except Exception as e:  # noqa: BLE001 - bad request params
                conn.sendall(encode_error(DisaggError(str(e))))
                return
            for frame in encode_slab(meta, slab, self._chunk):
                conn.sendall(frame)
        except (ConnectionResetError, BrokenPipeError) as e:
            # the client hung up mid-stream (deadline, corruption abort,
            # its own failover retry): routine under chaos
            logger.info("kv export client disconnected mid-stream: %s", e)
        except Exception:  # noqa: BLE001 - one bad peer must not kill accept
            logger.exception("kv export connection failed")
        finally:
            conn.close()

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)


class _PeerState:
    """One prefill peer inside a FailoverKVClient: its transport plus
    the ejection bookkeeping (consecutive failures drive an exponential
    re-probe backoff; a probe success resets it)."""

    __slots__ = ("transport", "addr", "healthy", "fails", "eject_until")

    def __init__(self, transport):
        self.transport = transport
        self.addr = getattr(transport, "addr", transport.name)
        self.healthy = True
        self.fails = 0
        self.eject_until = 0.0


class FailoverKVClient:
    """Decode-side transport over a prefill-peer LIST.

    Peers are tried round-robin. A transfer failure that smells like a
    dead peer (unreachable, truncated/corrupt stream, handler crash)
    **ejects** that peer -- it sits out an exponential backoff, then the
    next selection **probes** it and readmits on success. A failed
    transfer is retried ONCE on the next healthy peer before surfacing.
    Typed refusals about the *request* -- :class:`WeightVersionMismatch`,
    :class:`PrefixGone` -- pass straight through; :class:`PeerBusy` and
    :class:`TierMiss` rotate to another peer WITHOUT ejecting. When every
    peer is ejected, :class:`AllPeersDown` surfaces so the decode server
    can degrade to local unified prefill.

    ``on_eject(addr, reason)`` / ``on_readmit(addr)`` hooks feed the
    decode server's ``peer_ejections`` / ``peer_readmissions`` counters."""

    name = "failover"

    def __init__(
        self,
        transports,
        eject_backoff_s: float = 1.0,
        max_backoff_s: float = 30.0,
        probe_timeout_s: float = 2.0,
        on_eject: Optional[Callable[[str, str], None]] = None,
        on_readmit: Optional[Callable[[str], None]] = None,
    ):
        if not transports:
            raise ValueError("FailoverKVClient needs at least one peer")
        self._peers = [_PeerState(t) for t in transports]
        self._eject_backoff = float(eject_backoff_s)
        self._max_backoff = float(max_backoff_s)
        self._probe_timeout = float(probe_timeout_s)
        self._on_eject = on_eject
        self._on_readmit = on_readmit
        self._cursor = 0
        self._lock = threading.Lock()

    @property
    def peers(self):
        return list(self._peers)

    def healthy_count(self) -> int:
        return sum(1 for p in self._peers if p.healthy)

    def _backoff_s(self, fails: int) -> float:
        """Exponential re-probe backoff for ``fails`` consecutive
        failures; the exponent is clamped so a peer dead for hours
        cannot overflow the float."""
        return min(self._eject_backoff * (2 ** min(int(fails), 16)), self._max_backoff)

    def _probe_failed(self, peer: _PeerState, now: float) -> None:
        with self._lock:
            peer.eject_until = now + self._backoff_s(peer.fails)
            peer.fails += 1

    def _eject(self, peer: _PeerState, reason: str) -> None:
        with self._lock:
            peer.fails += 1
            backoff = self._backoff_s(peer.fails - 1)
            peer.healthy = False
            peer.eject_until = time.monotonic() + backoff
        logger.warning("prefill peer %s ejected for %.1fs (failure %d): %s",
                       peer.addr, backoff, peer.fails, reason)
        if self._on_eject is not None:
            try:
                self._on_eject(peer.addr, reason)
            except Exception:  # noqa: BLE001 - telemetry must not break failover
                logger.exception("on_eject hook failed")

    def _readmit(self, peer: _PeerState) -> None:
        with self._lock:
            peer.healthy = True
            peer.fails = 0
            peer.eject_until = 0.0
        logger.info("prefill peer %s readmitted (probe ok)", peer.addr)
        if self._on_readmit is not None:
            try:
                self._on_readmit(peer.addr)
            except Exception:  # noqa: BLE001
                logger.exception("on_readmit hook failed")

    def probe_ejected(self) -> int:
        """Probe every backoff-expired ejected peer now; returns how many
        were readmitted (the selection path does this lazily per pick)."""
        now = time.monotonic()
        readmitted = 0
        for peer in self._peers:
            if not peer.healthy and now >= peer.eject_until:
                if peer.transport.probe(self._probe_timeout):
                    self._readmit(peer)
                    readmitted += 1
                else:
                    self._probe_failed(peer, now)
        return readmitted

    def _pick(self, exclude) -> Optional[_PeerState]:
        """Next usable peer round-robin: healthy first; an ejected peer
        whose backoff expired is probed and readmitted inline."""
        n = len(self._peers)
        now = time.monotonic()
        for _ in range(n):
            with self._lock:
                peer = self._peers[self._cursor % n]
                self._cursor += 1
            if peer in exclude:
                continue
            if peer.healthy:
                return peer
            if now >= peer.eject_until:
                if peer.transport.probe(self._probe_timeout):
                    self._readmit(peer)
                    return peer
                self._probe_failed(peer, now)
        return None

    def _all_down(self) -> AllPeersDown:
        return AllPeersDown(
            f"all {len(self._peers)} prefill peers are ejected "
            f"({', '.join(p.addr for p in self._peers)})"
        )

    def prefill(self, request: Dict[str, Any], deadline_s: Optional[float] = None):
        tried: list = []
        busy_err: Optional[Exception] = None
        miss_err: Optional[Exception] = None
        while len(tried) < 2:
            peer = self._pick(exclude=tried)
            if peer is None:
                if miss_err is not None:
                    raise miss_err  # consulted tiers all missed
                if busy_err is not None:
                    raise busy_err  # every peer busy != every peer dead
                raise self._all_down()
            try:
                out = peer.transport.prefill(request, deadline_s=deadline_s)
            except (WeightVersionMismatch, PrefixGone):
                raise  # about the request/version, not the peer
            except TierMiss as e:
                # that member's tier is cold: rotate WITHOUT ejecting
                miss_err = e
                tried.append(peer)
                continue
            except PeerBusy as e:
                busy_err = e
                tried.append(peer)
                continue
            except ValueError:
                raise  # malformed request: no peer would serve it
            except Exception as e:  # noqa: BLE001 - peer-death class
                self._eject(peer, f"{type(e).__name__}: {e}")
                tried.append(peer)
                continue
            if peer.fails:
                with self._lock:
                    peer.fails = 0
            return out
        # two peers failed the SAME transfer: surface a typed error
        if miss_err is not None:
            raise miss_err
        if busy_err is not None:
            raise busy_err
        if self.healthy_count() == 0:
            raise self._all_down()
        raise DisaggError(
            f"kv transfer failed on {len(tried)} peers "
            f"({', '.join(p.addr for p in tried)}); retry"
        )

    def close(self) -> None:
        for peer in self._peers:
            try:
                peer.transport.close()
            except Exception:  # noqa: BLE001
                pass


def make_transport(peer, chunk_bytes: int = 1 << 20, fault=None):
    """``peer`` is either a live prefill-server object (loopback) or a
    ``"host:port"`` string (TCP)."""
    if isinstance(peer, str):
        return TcpKVClient(peer, fault=fault)
    return LoopbackTransport(peer, chunk_bytes=chunk_bytes, fault=fault)


def make_failover(
    peers,
    chunk_bytes: int = 1 << 20,
    fault_for: Optional[Callable[[str], Any]] = None,
    **failover_kw,
):
    """Build the decode side's transport from a peer LIST (each entry a
    live prefill-server object or ``host:port`` string; a lone
    ``"a:1,b:2"`` string is split). Always returns a
    :class:`FailoverKVClient` -- a single peer is just a list of one.
    ``fault_for(addr)`` resolves the chaos injector's per-peer KV fault
    hook (None = no faults)."""
    if isinstance(peers, str):
        peers = [p.strip() for p in peers.split(",") if p.strip()]
    elif not isinstance(peers, (list, tuple)):
        peers = [peers]
    transports = []
    for p in peers:
        addr = p if isinstance(p, str) else f"loopback:{id(p):x}"
        fault = fault_for(addr) if fault_for is not None else None
        transports.append(make_transport(p, chunk_bytes=chunk_bytes, fault=fault))
    return FailoverKVClient(transports, **failover_kw)
