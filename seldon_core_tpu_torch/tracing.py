"""Distributed tracing: per-hop spans, Jaeger agent export, device ranges.

Counterpart of ``seldon_core_tpu/tracing.py`` (a copy of its pure-Python
span machinery), with the device hooks on PyTorch. Parity with the
reference's Jaeger/OpenTracing wiring (reference: engine
TracingProvider + span re-activation across async graph hops
PredictiveUnitBean.java:85-118, outbound header injection
InternalPredictionService.java:141-144, Python wrapper jaeger setup
python/seldon_core/microservice.py:116-151). Finished spans are pushed
to the Jaeger agent over UDP in thrift-compact ``emitBatch`` datagrams
(``JAEGER_AGENT_HOST``/``JAEGER_AGENT_PORT`` env, the reference's exact
knobs), with per-request probabilistic sampling
(``JAEGER_SAMPLER_TYPE``/``JAEGER_SAMPLER_PARAM``). Spans are also kept
in-process and served in Jaeger HTTP-API JSON shape at the engine's
``/traces`` route; propagation uses the ``uber-trace-id`` header format
so traces stitch across engine → microservice process hops.

Device hooks: ``device_trace`` opens a ``torch.profiler.record_function``
range while a profiler session runs, so the enclosed device work is
named inside a ``torch.profiler`` trace (a shared no-op otherwise);
``start_device_profile``/``stop_device_profile`` run ``torch.profiler``
(CPU and CUDA activity) into a TensorBoard-loadable trace directory, on
the serving batcher's scheduler thread where one runs (a session records
the ranges of the thread that started it only). ``wall_us`` stamps
spans on the profiler's clock (epoch microseconds), so a span and the
range of the same interval line up.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import random
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

TRACE_HEADER = "uber-trace-id"  # trace_id:span_id:parent_span_id:flags
BAGGAGE_PREFIX = "uberctx-"

# Monotonic->wall anchor, sampled ONCE at import: every span/flight-
# recorder timestamp is derived as anchor + monotonic offset, so an NTP
# step mid-flight can never disorder spans within a trace or corrupt
# the intervals between recorder entries. time.time() appears only here
# (the seldon-lint wall-clock rule allows *WALL* anchor assignments).
_WALL_ANCHOR_US = int(time.time() * 1e6)
_MONO_ANCHOR = time.monotonic()


def wall_us(monotonic_t: Optional[float] = None) -> int:
    """Wall-clock microseconds for event timestamps, derived from the
    monotonic clock via the process-lifetime anchor. Pass a stored
    ``time.monotonic()`` reading to place a past event; default is
    now.

    Deliberate tradeoff: a wall-clock step AFTER process start (late
    NTP sync) leaves this process's timestamps offset from other
    hosts' by the step size for the process lifetime — cross-process
    span alignment degrades by that constant, but intra-process span
    ordering and every recorded interval stay exact, which is what
    deadline math and flight-recorder diffing depend on. Run serving
    hosts with time synced before process start (standard fleet
    practice) and the offset is bounded by normal NTP slew."""
    m = time.monotonic() if monotonic_t is None else monotonic_t
    return _WALL_ANCHOR_US + int((m - _MONO_ANCHOR) * 1e6)

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "seldon_torch_span", default=None
)


def _rand_id() -> str:
    return f"{random.getrandbits(64):016x}"


@dataclass
class Span:
    operation: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    start_us: int = 0
    duration_us: int = 0
    tags: Dict[str, Any] = field(default_factory=dict)
    logs: List[Dict[str, Any]] = field(default_factory=list)
    # uber-trace-id flags byte; bit 0 is the SAMPLED bit. Locally created
    # spans only exist when sampled, so 1 is the default — extracted
    # remote stubs carry whatever the upstream hop decided.
    flags: int = 1

    def set_tag(self, key: str, value: Any) -> "Span":
        self.tags[key] = value
        return self

    def log(self, **fields) -> None:
        self.logs.append({"timestamp": wall_us(), "fields": fields})

    def context_header(self) -> str:
        return f"{self.trace_id}:{self.span_id}:{self.parent_id or '0'}:{self.flags:x}"


class Tracer:
    """In-process span collector with contextvar activation and optional
    UDP push to a Jaeger agent."""

    def __init__(self, service_name: str = "seldon-torch", max_spans: int = 4096,
                 enabled: bool = True, exporter: Optional["JaegerUdpExporter"] = None,
                 sample_rate: float = 1.0):
        self.service_name = service_name
        self.enabled = enabled
        self.exporter = exporter
        self.sample_rate = float(sample_rate)
        self._spans: deque = deque(maxlen=max_spans)
        self._pending: List[Span] = []  # awaiting export
        self._lock = threading.Lock()
        self._flusher: Optional[threading.Thread] = None
        self._closed = threading.Event()
        if exporter is not None:
            self._flusher = threading.Thread(
                target=self._flush_loop, daemon=True, name="jaeger-flush"
            )
            self._flusher.start()

    # -- span lifecycle -----------------------------------------------------

    @contextlib.contextmanager
    def span(self, operation: str, tags: Optional[Dict[str, Any]] = None,
             headers: Optional[Dict[str, str]] = None, deferred: bool = False):
        """Open a span as a child of (priority order) the extracted header
        context or the currently active span; activate it for the body.
        ``deferred``: the span outlives the body (a stream's root, whose
        children end as its last chunk goes out) and is recorded by
        :meth:`end_span`; a body that raises records it at once."""
        if not self.enabled:
            yield _NOOP_SPAN
            return
        parent = self.extract(headers) if headers and TRACE_HEADER in headers else _current_span.get()
        if parent is _UNSAMPLED:
            # inside an unsampled request — locally decided OR told so by
            # the upstream hop's flags — children must not re-roll the
            # dice (they would export orphan fragments of dropped traces).
            # Pin the context so nested spans and inject() see the
            # decision even when it arrived via an extracted header.
            token = _current_span.set(_UNSAMPLED)
            try:
                yield _NOOP_SPAN
            finally:
                _current_span.reset(token)
            return
        if parent is None and self.sample_rate < 1.0:
            # per-request head sampling: the ROOT decides; the decision is
            # pinned in the context so every nested span inherits it
            if random.random() >= self.sample_rate:
                token = _current_span.set(_UNSAMPLED)
                try:
                    yield _NOOP_SPAN
                finally:
                    _current_span.reset(token)
                return
        s = Span(
            operation=operation,
            trace_id=parent.trace_id if parent else _rand_id(),
            span_id=_rand_id(),
            parent_id=parent.span_id if parent else None,
            start_us=wall_us(),
            tags=dict(tags or {}),
            # inherit the parent's flags byte so upstream bits beyond
            # SAMPLED (e.g. Jaeger's DEBUG 0x2) survive the hop instead
            # of resetting to the local default at the first child
            flags=parent.flags if parent is not None else 1,
        )
        token = _current_span.set(s)
        t0 = time.perf_counter()
        try:
            yield s
        except Exception as e:
            s.set_tag("error", True)
            s.log(event="error", message=str(e))
            deferred = False
            raise
        finally:
            _current_span.reset(token)
            if not deferred:
                s.duration_us = int((time.perf_counter() - t0) * 1e6)
                self._record(s)

    def end_span(self, s: Span) -> None:
        """Record a span opened with ``deferred=True``, ending now (a no-op
        for a span tracing left unrecorded)."""
        if isinstance(s, _NoopSpan):
            return
        s.duration_us = max(0, wall_us() - s.start_us)
        self._record(s)

    def _record(self, s: Span) -> None:
        with self._lock:
            self._spans.append(s)
            do_flush = False
            if self.exporter is not None:
                self._pending.append(s)
                do_flush = len(self._pending) >= 64
        if do_flush:
            self.flush()

    def flush(self) -> int:
        """Push pending spans to the agent now; returns spans exported."""
        if self.exporter is None:
            return 0
        with self._lock:
            batch, self._pending = self._pending, []
        if batch:
            try:
                self.exporter.emit(self.service_name, batch)
            except OSError:  # agent away: tracing must never break serving
                pass
        return len(batch)

    def _flush_loop(self) -> None:
        while not self._closed.wait(0.5):
            self.flush()

    def close(self) -> None:
        """Stop the flusher thread and export what's left. init_tracer
        closes any replaced tracer, so re-init cannot leak threads."""
        self._closed.set()
        self.flush()
        if self.exporter is not None:
            try:
                self.exporter._sock.close()
            except OSError:
                pass

    def active_span(self) -> Optional[Span]:
        return _current_span.get()

    def record_span(
        self,
        operation: str,
        trace_id: str,
        parent_id: Optional[str],
        start_us: int,
        duration_us: int,
        tags: Optional[Dict[str, Any]] = None,
    ) -> Optional[Span]:
        """Append an already-finished span with explicit timing/parentage.

        The generation scheduler runs on its own thread and learns phase
        boundaries retroactively (a request's queue wait is only known at
        admit, its decode residency at completion), so it cannot use the
        context-manager span() — it records finished spans against the
        trace context captured at submit(). Sampling was already decided
        by that context's root: a request without a sampled parent never
        reaches here (the caller holds no trace ids for it)."""
        if not self.enabled:
            return None
        s = Span(
            operation=operation,
            trace_id=trace_id,
            span_id=_rand_id(),
            parent_id=parent_id,
            start_us=int(start_us),
            duration_us=max(0, int(duration_us)),
            tags=dict(tags or {}),
        )
        self._record(s)
        return s

    # -- propagation --------------------------------------------------------

    def inject(self, headers: Dict[str, str]) -> Dict[str, str]:
        s = _current_span.get()
        if not self.enabled or s is None:
            return headers
        if s is _UNSAMPLED:
            # the root dropped this request: tell the next hop so IT does
            # not re-sample and export orphan fragments of a dead trace.
            # Only the flags byte carries information across the hop, but
            # the ids must still be valid non-zero values — standard
            # jaeger clients treat a zero trace id as a corrupted context
            # and would fall back to starting a fresh sampled root.
            headers[TRACE_HEADER] = f"{_rand_id()}:{_rand_id()}:0:0"
        else:
            headers[TRACE_HEADER] = s.context_header()
        return headers

    @staticmethod
    def extract(headers: Dict[str, str]) -> Optional[Span]:
        """Parse an incoming uber-trace-id into a remote parent stub.

        The flags field's sampled bit is honored: a header whose upstream
        hop decided NOT to sample yields the pinned-unsampled sentinel, so
        this hop's spans no-op instead of re-rolling the sampling dice on
        a request the root already dropped."""
        raw = headers.get(TRACE_HEADER) or headers.get(TRACE_HEADER.title())
        if not raw:
            return None
        parts = raw.split(":")
        if len(parts) != 4:
            return None
        try:
            flags = int(parts[3], 16)
        except ValueError:
            return None
        if not flags & 1:
            return _UNSAMPLED
        return Span(operation="<remote>", trace_id=parts[0], span_id=parts[1],
                    parent_id=None if parts[2] == "0" else parts[2],
                    flags=flags)

    # -- export -------------------------------------------------------------

    def finished_spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()

    def export_jaeger(
        self,
        operation: Optional[str] = None,
        limit: Optional[int] = None,
        since_us: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Jaeger HTTP API JSON shape: {"data": [{traceID, spans, processes}]}.

        Filters (all optional, served as ``/traces`` query params so a
        4096-span buffer is inspectable without dumping it whole):
        ``operation`` keeps spans whose operation name contains the
        substring, ``since_us`` keeps spans starting at/after the epoch
        microsecond, ``limit`` keeps only the N most recent matching
        spans (finish order)."""
        spans = self.finished_spans()
        if operation:
            spans = [s for s in spans if operation in s.operation]
        if since_us is not None:
            spans = [s for s in spans if s.start_us >= since_us]
        if limit is not None and limit >= 0:
            spans = spans[-limit:] if limit else []
        by_trace: Dict[str, List[Span]] = {}
        for s in spans:
            by_trace.setdefault(s.trace_id, []).append(s)
        data = []
        for trace_id, spans in by_trace.items():
            data.append(
                {
                    "traceID": trace_id,
                    "spans": [
                        {
                            "traceID": s.trace_id,
                            "spanID": s.span_id,
                            "operationName": s.operation,
                            "references": (
                                [{"refType": "CHILD_OF", "traceID": s.trace_id,
                                  "spanID": s.parent_id}] if s.parent_id else []
                            ),
                            "startTime": s.start_us,
                            "duration": s.duration_us,
                            "tags": [
                                {"key": k, "type": "string", "value": str(v)}
                                for k, v in s.tags.items()
                            ],
                            "logs": s.logs,
                            "processID": "p1",
                        }
                        for s in spans
                    ],
                    "processes": {"p1": {"serviceName": self.service_name, "tags": []}},
                }
            )
        return {"data": data}


class JaegerUdpExporter:
    """Jaeger agent client: thrift-compact ``Agent.emitBatch`` oneway
    messages over UDP :6831 — the exact wire protocol jaeger-client's
    UDPSender speaks, implemented directly (no thrift dependency in the
    image). Batches are split to fit the agent's 65KB datagram limit."""

    # thrift compact type nibbles
    _T_BOOL_TRUE, _T_BOOL_FALSE = 1, 2
    _T_I32, _T_I64, _T_DOUBLE, _T_STR, _T_LIST, _T_STRUCT = 5, 6, 7, 8, 9, 12

    def __init__(self, host: str, port: int = 6831, max_packet: int = 65000):
        import socket

        self.addr = (host, int(port))
        self.max_packet = max_packet
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    # -- thrift compact primitives ------------------------------------------

    @staticmethod
    def _varint(n: int) -> bytes:
        out = bytearray()
        while True:
            if n < 0x80:
                out.append(n)
                return bytes(out)
            out.append((n & 0x7F) | 0x80)
            n >>= 7

    @classmethod
    def _zigzag(cls, n: int, bits: int = 64) -> bytes:
        return cls._varint(((n << 1) ^ (n >> (bits - 1))) & ((1 << bits) - 1))

    @classmethod
    def _field(cls, out: bytearray, last_id: int, fid: int, ftype: int) -> int:
        delta = fid - last_id
        if 0 < delta <= 15:
            out.append((delta << 4) | ftype)
        else:
            out.append(ftype)
            out += cls._zigzag(fid, 16)
        return fid

    @classmethod
    def _string(cls, s: str) -> bytes:
        b = s.encode("utf-8")
        return cls._varint(len(b)) + b

    @classmethod
    def _list_header(cls, size: int, etype: int) -> bytes:
        if size < 15:
            return bytes([(size << 4) | etype])
        return bytes([0xF0 | etype]) + cls._varint(size)

    @staticmethod
    def _i64_of_hex(h: str) -> int:
        v = int(h, 16) & 0xFFFFFFFFFFFFFFFF
        return v - (1 << 64) if v >= (1 << 63) else v

    # -- jaeger.thrift structs ----------------------------------------------

    def _tag(self, key: str, value: Any) -> bytes:
        out = bytearray()
        last = self._field(out, 0, 1, self._T_STR)          # key
        out += self._string(key)
        last = self._field(out, last, 2, self._T_I32)       # vType = STRING(0)
        out += self._zigzag(0, 32)
        last = self._field(out, last, 3, self._T_STR)       # vStr
        out += self._string(str(value))
        out.append(0)  # stop
        return bytes(out)

    def _span(self, s: Span) -> bytes:
        out = bytearray()
        last = self._field(out, 0, 1, self._T_I64)          # traceIdLow
        out += self._zigzag(self._i64_of_hex(s.trace_id))
        last = self._field(out, last, 2, self._T_I64)       # traceIdHigh
        out += self._zigzag(0)
        last = self._field(out, last, 3, self._T_I64)       # spanId
        out += self._zigzag(self._i64_of_hex(s.span_id))
        last = self._field(out, last, 4, self._T_I64)       # parentSpanId
        out += self._zigzag(self._i64_of_hex(s.parent_id) if s.parent_id else 0)
        last = self._field(out, last, 5, self._T_STR)       # operationName
        out += self._string(s.operation)
        last = self._field(out, last, 7, self._T_I32)       # flags = sampled
        out += self._zigzag(1, 32)
        last = self._field(out, last, 8, self._T_I64)       # startTime us
        out += self._zigzag(s.start_us)
        last = self._field(out, last, 9, self._T_I64)       # duration us
        out += self._zigzag(s.duration_us)
        if s.tags:
            last = self._field(out, last, 10, self._T_LIST)  # tags
            out += self._list_header(len(s.tags), self._T_STRUCT)
            for k, v in s.tags.items():
                out += self._tag(k, v)
        out.append(0)  # stop
        return bytes(out)

    def _batch(self, service_name: str, spans: List[Span]) -> bytes:
        process = bytearray()
        plast = self._field(process, 0, 1, self._T_STR)
        process += self._string(service_name)
        process.append(0)

        batch = bytearray()
        blast = self._field(batch, 0, 1, self._T_STRUCT)    # process
        batch += process
        blast = self._field(batch, blast, 2, self._T_LIST)  # spans
        batch += self._list_header(len(spans), self._T_STRUCT)
        for s in spans:
            batch += self._span(s)
        batch.append(0)

        # message: protocol 0x82, ONEWAY(4)<<5 | version 1, seqid, name,
        # then the args struct {1: Batch}
        msg = bytearray(b"\x82\x81")
        msg += self._varint(0)                               # seqid
        msg += self._string("emitBatch")
        alast = self._field(msg, 0, 1, self._T_STRUCT)
        msg += batch
        msg.append(0)
        return bytes(msg)

    def emit(self, service_name: str, spans: List[Span]) -> None:
        # split so each datagram stays under the agent's packet limit
        chunk: List[Span] = []
        size = 0
        for s in spans:
            est = 128 + len(s.operation) + sum(
                len(str(k)) + len(str(v)) + 16 for k, v in s.tags.items()
            )
            if chunk and size + est > self.max_packet:
                self._sock.sendto(self._batch(service_name, chunk), self.addr)
                chunk, size = [], 0
            chunk.append(s)
            size += est
        if chunk:
            self._sock.sendto(self._batch(service_name, chunk), self.addr)


class _NoopSpan(Span):
    def __init__(self):
        super().__init__("noop", "0", "0")

    def set_tag(self, key, value):
        return self

    def log(self, **fields):
        pass


_NOOP_SPAN = _NoopSpan()
# context marker for "this request lost the sampling coin flip": children
# and injected headers must follow the root's decision, not re-roll
_UNSAMPLED = _NoopSpan()

# -- global tracer (the reference reads JAEGER_* env in both wrapper and
# engine; TRACING=1 gates setup — microservice.py:116-151) ------------------

_GLOBAL: Optional[Tracer] = None


def init_tracer(service_name: Optional[str] = None, enabled: Optional[bool] = None) -> Tracer:
    """Env parity with the reference's jaeger setup (microservice.py:116-151):
    TRACING gates it, JAEGER_AGENT_HOST/PORT select the UDP agent,
    JAEGER_SAMPLER_TYPE const|probabilistic + JAEGER_SAMPLER_PARAM set the
    per-request head-sampling rate."""
    global _GLOBAL
    if _GLOBAL is not None:
        _GLOBAL.close()
    if enabled is None:
        enabled = os.environ.get("TRACING", "0") not in ("0", "false", "")
    exporter = None
    agent_host = os.environ.get("JAEGER_AGENT_HOST", "")
    if enabled and agent_host:
        exporter = JaegerUdpExporter(
            agent_host, int(os.environ.get("JAEGER_AGENT_PORT", "6831"))
        )
    sampler_type = os.environ.get("JAEGER_SAMPLER_TYPE", "const")
    try:
        param = float(os.environ.get("JAEGER_SAMPLER_PARAM", "1"))
    except ValueError:
        param = 1.0
    sample_rate = param if sampler_type == "probabilistic" else (
        1.0 if param else 0.0
    )
    _GLOBAL = Tracer(
        service_name or os.environ.get("JAEGER_SERVICE_NAME", "seldon-torch"),
        enabled=enabled,
        exporter=exporter,
        sample_rate=sample_rate,
    )
    return _GLOBAL


def get_tracer() -> Tracer:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = init_tracer()
    return _GLOBAL


# -- device tracing -----------------------------------------------------

_NULL_RANGE = contextlib.nullcontext()


def device_trace(name: str):
    """A context manager naming the enclosed work inside ``torch.profiler``
    traces (the counterpart of the reference's span around the model
    call): a ``record_function`` range while a profiler session runs in
    the process, else a shared no-op, one attribute check. A session
    records the ranges of the thread that started it only: the batcher's
    ranges reach a trace through :func:`start_device_profile`."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not getattr(prof, "_is_profiler_enabled", True):
        return _NULL_RANGE
    import torch

    return torch.profiler.record_function(name)


class _DeviceProfile:
    """The session :func:`start_device_profile` runs: a ``torch.profiler``
    profile, the directory its trace goes to, and the scheduler whose
    thread started it (None: the caller's thread). The session stops on
    the thread that started it; its trace is written by whoever ends it
    (:func:`stop_device_profile`'s caller), off the scheduler's thread:
    writing takes seconds."""

    def __init__(self, prof, logdir: str, host):
        self.prof = prof
        self.logdir = logdir
        self.host = host
        self.running = False
        self.written = False
        self._lock = threading.Lock()

    def start(self) -> None:
        self.prof.start()
        self.running = True

    def stop(self) -> None:
        if self.running:
            self.running = False
            self.prof.stop()

    def write(self) -> None:
        from torch.profiler import tensorboard_trace_handler

        with self._lock:
            if self.written or self.running:
                return
            self.written = True
        tensorboard_trace_handler(self.logdir)(self.prof)


_PROFILE: Optional[_DeviceProfile] = None
_PROFILE_LOCK = threading.Lock()
# schedulers whose own thread can host the session, newest last: a
# ContinuousBatcher is one while its poll loop runs
_PROFILE_HOSTS: List[Any] = []


def add_profile_host(host) -> None:
    """Offer ``host``'s thread for device profiles. ``host`` has a
    ``call_on_scheduler(fn) -> Future`` that runs ``fn`` on that thread
    between two polls."""
    with _PROFILE_LOCK:
        _PROFILE_HOSTS.append(host)


def release_profile_host(host) -> None:
    """Withdraw ``host`` (on its own thread, as its loop ends): a session
    it started is stopped there, and its trace written."""
    with _PROFILE_LOCK:
        if host in _PROFILE_HOSTS:
            _PROFILE_HOSTS.remove(host)
        sess = _PROFILE if _PROFILE is not None and _PROFILE.host is host else None
    if sess is not None:
        sess.stop()
        sess.write()


def start_device_profile(logdir: str) -> None:
    """Start a ``torch.profiler`` run (CPU and CUDA activity) whose trace
    lands in ``logdir`` (TensorBoard-loadable) when
    :func:`stop_device_profile` ends it.

    With a batcher serving in the process, its scheduler thread starts
    the session between two polls (the batcher started last, where there
    are several: a session records one thread's ranges), so that its
    ``gen.*`` ranges and the device's activity land in one trace on the
    profiler's clock, which :func:`wall_us` agrees with; without one,
    this thread does."""
    global _PROFILE
    import torch
    from torch.profiler import ProfilerActivity, profile

    with _PROFILE_LOCK:
        if _PROFILE is not None:
            raise RuntimeError("a device profile is already running")
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        sess = _DeviceProfile(
            profile(activities=activities), logdir,
            _PROFILE_HOSTS[-1] if _PROFILE_HOSTS else None)
        _PROFILE = sess
    try:
        if sess.host is None:
            sess.start()
        else:
            sess.host.call_on_scheduler(sess.start).result()
    except BaseException:
        with _PROFILE_LOCK:
            _PROFILE = None
        raise


def stop_device_profile() -> Dict[str, float]:
    """End the running session on the thread that started it (a stop
    from another thread while the scheduler replays CUDA graphs can hang
    the process), then write its trace on this thread. Returns the
    seconds of each: ``stop_s`` (what a scheduler's thread spent
    stopping, a pause of its serving that grows with the events traced:
    on an H100 serving a 7B model, 17 s for a 4 s session) and
    ``write_s``."""
    global _PROFILE
    with _PROFILE_LOCK:
        sess, _PROFILE = _PROFILE, None
    if sess is None:
        raise RuntimeError("no device profile is running")
    t0 = time.monotonic()
    if sess.host is None:
        sess.stop()
    else:
        try:
            sess.host.call_on_scheduler(sess.stop).result()
        except Exception:
            # the host's loop ended meanwhile, and stopped the session as
            # it did
            if sess.running:
                raise
    t1 = time.monotonic()
    sess.write()
    return {"stop_s": t1 - t0, "write_s": time.monotonic() - t1}
