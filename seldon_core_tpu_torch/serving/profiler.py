"""Device-time ledger: per-executable attribution for the serving loop.

Counterpart of ``seldon_core_tpu/serving/profiler.py`` with the same
interface (``KINDS``, ``DeviceTimeLedger.measure``/``poll_flush``/
``buckets``/``gauges``/``summary``, the row and summary keys); what
changes is how a dispatch is timed.

Every dispatch the continuous batcher makes -- prefill, chunked prefill
slice, decode burst, fused burst, spec burst, depth-group burst, prefix
splice/insert/extract, replay, swap flip -- is timed and attributed per
``(kind, variant, tenant)``. The bytes each dispatch reads come from a
static cost model (``DecoderLM.dispatch_read_bytes``), so live MBU is a
divide over a sliding window, and the dispatch-floor percentage is the
observed dispatch rate priced at a measured per-dispatch floor.

What a measurement is:

* **On a CUDA device**, ``measure`` records a start and an end
  ``torch.cuda.Event(enable_timing=True)`` on the current stream around
  the enqueue; the event pairs come from a pool and go back to it. A
  record is resolved later, once ``end.query()`` says the stream has
  passed it: by :meth:`DeviceTimeLedger.resolve`, which the scheduler
  calls when it processes a burst, and inside ``poll_flush`` and the
  readers. Nothing waits on the device for it. The seconds recorded are
  ``start.elapsed_time(end)``: STREAM time between the two records. For
  a CUDA-graph replay (every decode burst) that is the replay's device
  time. For an eager dispatch whose host launches are slower than its
  kernels -- a B=1 prefill launches about a thousand small kernels --
  the stream idles between kernels waiting for the host, and stream time
  counts those waits: it then reads close to the host's wall time, not
  the device's busy time (``PERF.md`` gives the measured gap).

  The JAX package times the host call with ``time.perf_counter`` and
  argues that a full pipeline makes each dispatch block. Here it does
  not: a dispatch enqueues a graph replay and returns, and the host
  waits on a burst only when it reads its tokens, pipeline_depth bursts
  later. A host clock around the dispatch would time the enqueue, tens
  of microseconds against milliseconds of device time.
* **No deep mode**, unlike the JAX package: the scheduler's own
  ``gen.*`` ranges name the same dispatches in a ``torch.profiler``
  trace (``tracing.start_device_profile``), and no sample drains the
  stream.
* **During a CUDA-graph capture** nothing is measured: an event recorded
  inside a capture would become part of the graph.
* **On the CPU**, ``measure`` times the call with ``time.perf_counter``,
  as the JAX package's shallow mode does; CPU ops run synchronously, so
  that is their time.

The ledger never touches the dispatched computation: it wraps the call,
never its arguments or results, so profiler on vs off is byte-identical
(greedy and seeded) and captures no graph.

Thread model: ``measure`` runs on the scheduler thread (and, for
``export_prefill``, transport handler threads); ``poll_flush`` and
``resolve`` on the scheduler thread; the readers on serving/metrics
threads. One lock covers the pending records and the accumulation maps,
held for bookkeeping only, never across a dispatch.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["DeviceTimeLedger", "KINDS"]

# the executable-kind vocabulary (tools/flight_report.py renders these)
KINDS = (
    "prefill",        # whole-prompt or suffix prefill (+ first token)
    "chunk_prefill",  # one chunked-prefill slice
    "decode_burst",   # step-at-a-time whole-batch burst
    "fused_burst",    # stop-aware fused multi-step burst (per K)
    "group_burst",    # depth-group sub-burst (plain or fused)
    "spec_burst",     # speculative draft+verify round burst
    "splice",         # prefix donor slab splice into a staging slab
    "insert",         # slab insert into a lane of the cache
    "extract",        # prefix/checkpoint slab extract from the cache
    "replay",         # teacher-forced replay (preempt recompute-resume)
    "swap_cast",      # hot-swap flip: staged weights copied into the served set
)
_KINDS_SET = frozenset(KINDS)


class _Measurement:
    """One measured dispatch, as a context manager."""

    __slots__ = ("_ledger", "kind", "variant", "tenant", "bytes_read",
                 "tokens", "_t0", "_events", "_mono")

    def __init__(self, ledger, kind, variant, tenant, bytes_read, tokens):
        self._ledger = ledger
        self.kind = kind
        self.variant = variant
        self.tenant = tenant
        self.bytes_read = bytes_read
        self.tokens = tokens
        self._t0 = 0.0
        self._events = None
        self._mono = 0.0

    def __enter__(self):
        self._mono = time.monotonic()
        dev = self._ledger.device
        if dev is not None and dev.type == "cuda":
            self._events = self._ledger._take_events()
            self._events[0].record(torch.cuda.current_stream(dev))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        led = self._ledger
        if self._events is not None:
            start, end = self._events
            end.record(torch.cuda.current_stream(led.device))
            if exc_type is None:
                led._enqueue(self, start, end)
            else:
                led._give_events(self._events)
        elif exc_type is None:
            led._record(self.kind, self.variant, self.tenant,
                        time.perf_counter() - self._t0, self.bytes_read,
                        self.tokens, self._mono)
        return False


class _NoopMeasurement:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _NoopMeasurement()


class DeviceTimeLedger:
    """Accumulates measured dispatch time per (kind, variant, tenant).

    Two accumulation levels: a cumulative map (``summary``/metrics
    deltas read it) and a since-last-flush map the scheduler attaches to
    each flight-recorder poll record (``poll_flush``). A bounded window
    of recent records backs the live MBU / dispatch-floor gauges.
    ``device`` selects the clock (CUDA events on a CUDA device, the host
    clock otherwise); the batcher sets it to its own device.
    """

    WINDOW_S = 10.0

    def __init__(
        self,
        enabled: bool = False,
        hbm_gb_s: float = 0.0,
        dispatch_floor_us: float = 0.0,
        device: Optional[torch.device] = None,
    ):
        self.enabled = bool(enabled)
        # MBU / dispatch-floor denominators (0 = unknown: the gauges are
        # omitted rather than published as lies)
        self.hbm_gb_s = float(hbm_gb_s)
        self.dispatch_floor_us = float(dispatch_floor_us)
        self.device = torch.device(device) if device is not None else None
        self._lock = threading.Lock()
        # (kind, variant, tenant) -> [seconds, dispatches, bytes, tokens]
        self._cum: Dict[Tuple[str, str, str], List[float]] = {}
        self._poll: Dict[Tuple[str, str, str], List[float]] = {}
        # (mono_t, seconds, bytes, dispatches, tokens) per record
        self._window: "collections.deque" = collections.deque(maxlen=8192)
        # CUDA: measured dispatches whose end event the stream has not
        # passed yet, oldest first, and the free event pairs
        self._pending: "collections.deque" = collections.deque()
        self._free: List[Tuple[Any, Any]] = []

    # -- hot path -----------------------------------------------------------

    def measure(
        self,
        kind: str,
        variant: str = "",
        tenant: str = "",
        bytes_read: int = 0,
        tokens: int = 0,
    ):
        """Context manager timing one dispatch. Disabled ledgers return a
        shared no-op -- one attribute check and one call, nothing else on
        the hot path."""
        if not self.enabled:
            return _NOOP
        if kind not in _KINDS_SET:
            # the kind vocabulary is a rendering contract (flight_report);
            # a typo'd hook must fail loudly, not mint a series
            raise ValueError(f"unknown ledger kind {kind!r}")
        if (self.device is not None and self.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            return _NOOP
        return _Measurement(self, kind, variant, tenant, bytes_read, tokens)

    def _take_events(self):
        with self._lock:
            if self._free:
                return self._free.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _give_events(self, pair) -> None:
        with self._lock:
            self._free.append(pair)

    def _enqueue(self, m: _Measurement, start, end) -> None:
        with self._lock:
            self._pending.append((m, start, end))

    def resolve(self) -> int:
        """Fold every pending CUDA record whose end event the stream has
        passed into the maps (``end.query()``, never a synchronise);
        returns how many."""
        n = 0
        with self._lock:
            while self._pending:
                m, start, end = self._pending[0]
                if not end.query():
                    break
                self._pending.popleft()
                secs = start.elapsed_time(end) * 1e-3
                self._record_locked(m.kind, m.variant, m.tenant, secs,
                                    m.bytes_read, m.tokens, m._mono)
                self._free.append((start, end))
                n += 1
        return n

    def _record(self, kind, variant, tenant, seconds, bytes_read, tokens, mono) -> None:
        with self._lock:
            self._record_locked(kind, variant, tenant, seconds, bytes_read, tokens, mono)

    def _record_locked(self, kind, variant, tenant, seconds, bytes_read, tokens,
                       mono) -> None:
        key = (kind, variant, tenant)
        for m in (self._cum, self._poll):
            row = m.get(key)
            if row is None:
                row = [0.0, 0.0, 0.0, 0.0]
                m[key] = row
            row[0] += seconds
            row[1] += 1.0
            row[2] += bytes_read
            row[3] += tokens
        self._window.append((mono, seconds, bytes_read, 1.0, tokens))

    # -- flush / export -----------------------------------------------------

    @staticmethod
    def _rows(m: Dict[Tuple[str, str, str], List[float]]) -> List[Dict[str, Any]]:
        out = []
        for (kind, variant, tenant), (s, n, b, t) in sorted(m.items()):
            row = {
                "kind": kind, "variant": variant,
                "s": round(s, 6), "n": int(n),
                "bytes": int(b), "tokens": int(t),
            }
            if tenant:
                row["tenant"] = tenant
            out.append(row)
        return out

    def poll_flush(self) -> Optional[List[Dict[str, Any]]]:
        """Per-(kind,variant,tenant) deltas since the last flush, cleared
        on read -- the scheduler attaches the result to its per-poll
        flight-recorder record. None when nothing was measured. On CUDA a
        dispatch lands in the flush after its end event has passed."""
        if not self.enabled:
            return None
        self.resolve()
        with self._lock:
            if not self._poll:
                return None
            rows = self._rows(self._poll)
            self._poll.clear()
        return rows

    def buckets(self) -> Dict[Tuple[str, str, str], Tuple[float, float, float, float]]:
        """Cumulative (seconds, dispatches, bytes, tokens) per
        (kind, variant, tenant) -- the metrics() exporter window-diffs
        these through CounterDeltas."""
        self.resolve()
        with self._lock:
            return {k: tuple(v) for k, v in self._cum.items()}

    def _window_rates(self) -> Tuple[float, float, float, float]:
        """(span_s, bytes/s, dispatches/s, device_s/s) over the sliding
        window; zeros when the window is empty or degenerate."""
        now = time.monotonic()
        horizon = now - self.WINDOW_S
        with self._lock:
            live = [r for r in self._window if r[0] >= horizon]
        if len(live) < 2:
            return 0.0, 0.0, 0.0, 0.0
        span = max(1e-6, now - live[0][0])
        b = sum(r[2] for r in live)
        n = sum(r[3] for r in live)
        s = sum(r[1] for r in live)
        return span, b / span, n / span, s / span

    def gauges(self) -> Dict[str, float]:
        """Live derived gauges over the sliding window. ``mbu_pct`` needs
        ``hbm_gb_s``; ``dispatch_floor_pct`` needs ``dispatch_floor_us``
        -- each is omitted when its denominator is unknown."""
        self.resolve()
        span, bytes_s, disp_s, busy = self._window_rates()
        out: Dict[str, float] = {}
        if span <= 0.0:
            return out
        out["device_busy_frac"] = round(min(1.0, busy), 4)
        if self.hbm_gb_s > 0:
            out["mbu_pct"] = round(100.0 * bytes_s / (self.hbm_gb_s * 1e9), 2)
        if self.dispatch_floor_us > 0:
            # fraction of wall time the measured per-dispatch floor alone
            # would consume at the observed dispatch rate: near 100 means
            # the workload is dispatch-bound
            out["dispatch_floor_pct"] = round(
                min(100.0, 100.0 * disp_s * self.dispatch_floor_us * 1e-6), 2)
        return out

    def summary(self) -> Dict[str, Any]:
        """Cumulative rollup for /fleet and flight dumps."""
        self.resolve()
        with self._lock:
            rows = self._rows(self._cum)
        total_s = sum(r["s"] for r in rows)
        by_kind: Dict[str, float] = {}
        for r in rows:
            by_kind[r["kind"]] = round(by_kind.get(r["kind"], 0.0) + r["s"], 6)
        out: Dict[str, Any] = {
            "enabled": self.enabled,
            "device_time_s": round(total_s, 6),
            "by_kind": by_kind,
            "buckets": rows,
        }
        out.update(self.gauges())
        return out
