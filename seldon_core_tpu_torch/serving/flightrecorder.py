"""Scheduler flight recorder: a bounded ring of per-poll decision records
(the port's own copy of ``seldon_core_tpu/serving/flightrecorder.py``).

The continuous batcher (serving/continuous.py) makes a scheduling
decision every poll — which requests admit, how live lanes partition
into depth-grouped sub-bursts, whether the cost model merged groups,
which long prompts advanced a prefill chunk, what got shed — and none of
it used to survive the poll. This recorder keeps the last ``capacity``
decisions as plain dicts in a ``collections.deque`` ring so a
tail-latency regression can be attributed after the fact (queue wait vs
prefill interleave vs group re-packing vs eviction) without re-running
traffic under a profiler.

Cost model: recording must be cheap enough to leave ON in production.
One small dict is built per *poll* (device-burst cadence, milliseconds),
never per token; ``deque.append`` with ``maxlen`` drops the oldest entry
under pressure without locking (the scheduler thread writes poll records;
shed records arrive concurrently from submitting threads, and both
``deque.append`` and the ``itertools.count`` sequence stamp are atomic
under the GIL); readers snapshot with ``list(...)`` and never block the
scheduler. ``enabled = False`` short-circuits to a single attribute
check on the hot path.

Consumed by the engine's ``/flightrecorder`` route (graph/service.py)
and ``tools/flight_report.py``, which turns a dump into a human-readable
diagnosis.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Any, Dict, List, Optional

from ..tracing import wall_us


class FlightRecorder:
    """Bounded, drop-oldest ring buffer of scheduler decision records."""

    def __init__(self, capacity: int = 512, enabled: bool = True):
        self.capacity = int(capacity)
        self.enabled = bool(enabled) and self.capacity > 0
        self._ring: deque = deque(maxlen=max(1, self.capacity))
        # monotonically growing record count: next(self._seq) is atomic
        # under the GIL, so concurrent writers (scheduler polls + shed
        # events off submitting threads) never duplicate a seq
        self._seq = itertools.count()

    def record(self, entry: Dict[str, Any]) -> None:
        """Append one record. The caller owns ``entry`` (it is stored, not
        copied); ``seq``/``t_us`` are stamped here so every record is
        orderable and wall-clock attributable."""
        if not self.enabled:
            return
        entry["seq"] = next(self._seq)
        # monotonic-anchored wall stamp: flight_report diffs t_us between
        # records to attribute poll gaps — an NTP step under a raw
        # time.time() would turn those intervals into lies
        entry.setdefault("t_us", wall_us())
        self._ring.append(entry)

    def snapshot(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Most-recent-last copy of the ring (the scheduler keeps writing
        while we read; list() of a deque is safe under the GIL)."""
        entries = list(self._ring)
        if limit is not None and limit >= 0:
            entries = entries[-limit:] if limit else []
        return entries

    def dump(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """JSON-shaped export for the ``/flightrecorder`` route."""
        entries = self.snapshot(limit)
        # total ever recorded = the newest entry's seq + 1 (the counter
        # itself is not readable without consuming it)
        try:
            recorded = self._ring[-1]["seq"] + 1
        except (IndexError, KeyError):
            recorded = 0
        return {
            "capacity": self.capacity,
            "enabled": self.enabled,
            "recorded_total": recorded,
            "dropped": max(0, recorded - len(self._ring)),
            "entries": entries,
        }

    def clear(self) -> None:
        self._ring.clear()
