"""Per-unit circuit breaker (counterpart of
``seldon_core_tpu/resilience/breaker.py``).

The reference leaned on Istio's outlier ejection to stop sending traffic
to a sick upstream (reference: DestinationRule outlierDetection in
seldondeployment_istio.go); the engine's graphs have no sidecar, so the
breaker lives in the engine, wrapping ``UnitClient.call``.

Count-based rolling window (last ``window`` outcomes): CLOSED until the
window's error rate crosses ``error_rate`` with at least ``min_calls``
samples, then OPEN — calls fail fast with :class:`BreakerOpen` (503) and
no work reaches the unit. After ``open_s`` the breaker goes HALF_OPEN and
admits ``half_open_probes`` probe calls: one success closes it (window
reset — the old failures are history), one failure re-opens the clock.

State transitions surface through ``on_transition`` so the engine can
export ``seldon_engine_breaker_transitions{unit=,to=}`` and the
``seldon_engine_breaker_state`` gauge.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# gauge encoding: 0 closed, 0.5 half-open, 1 open
STATE_GAUGE = {CLOSED: 0.0, HALF_OPEN: 0.5, OPEN: 1.0}

ANNOTATION_BREAKER = "seldon.io/breaker"
ANNOTATION_WINDOW = "seldon.io/breaker-window"
ANNOTATION_ERROR_RATE = "seldon.io/breaker-error-rate"
ANNOTATION_MIN_CALLS = "seldon.io/breaker-min-calls"
ANNOTATION_OPEN_MS = "seldon.io/breaker-open-ms"


class BreakerOpen(Exception):
    """Fail-fast rejection while the circuit is open. Deliberately NOT
    retryable (retrying an open breaker just burns the caller's budget)."""

    status = 503


def unit_ann(ann: Dict[str, str], key: str, unit: str, default=None):
    """THE per-unit annotation resolution rule, shared by every policy:
    ``<key>.<unit-name>`` wins over the predictor-wide ``<key>``."""
    return ann.get(f"{key}.{unit}", ann.get(key, default))


class CircuitBreaker:
    def __init__(
        self,
        window: int = 20,
        error_rate: float = 0.5,
        min_calls: int = 5,
        open_s: float = 5.0,
        half_open_probes: int = 1,
        time_fn: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str], None]] = None,
    ):
        self.window = max(1, int(window))
        self.error_rate = float(error_rate)
        self.min_calls = max(1, int(min_calls))
        self.open_s = float(open_s)
        self.half_open_probes = max(1, int(half_open_probes))
        self._time = time_fn
        self._on_transition = on_transition
        self._events: deque = deque(maxlen=self.window)  # True = failure
        self.state = CLOSED
        self._opened_at = 0.0
        self._probes_in_flight = 0

    # -- state machine ------------------------------------------------------

    def _transition(self, to: str) -> None:
        if to == self.state:
            return
        old, self.state = self.state, to
        if self._on_transition is not None:
            self._on_transition(old, to)

    def allow(self) -> bool:
        """True when a call may proceed. In HALF_OPEN this RESERVES a
        probe slot; the caller must report the outcome via
        ``record_success``/``record_failure``."""
        if self.state == OPEN:
            if self._time() - self._opened_at >= self.open_s:
                self._probes_in_flight = 0
                self._transition(HALF_OPEN)
            else:
                return False
        if self.state == HALF_OPEN:
            if self._probes_in_flight >= self.half_open_probes:
                return False
            self._probes_in_flight += 1
            return True
        return True

    def record_success(self) -> None:
        if self.state == HALF_OPEN:
            # probe succeeded: the unit is back; forget the bad window
            self._probes_in_flight = max(0, self._probes_in_flight - 1)
            self._events.clear()
            self._transition(CLOSED)
            return
        self._events.append(False)

    def abandon(self) -> None:
        """A call admitted by ``allow()`` ended with no success/failure
        verdict — cancelled mid-flight (deadline), or an error the breaker
        does not learn from (4xx). Release the half-open probe slot, or a
        wedged probe would leave the breaker in HALF_OPEN rejecting every
        future call with no path back to CLOSED."""
        if self.state == HALF_OPEN:
            self._probes_in_flight = max(0, self._probes_in_flight - 1)

    def record_failure(self) -> None:
        if self.state == HALF_OPEN:
            self._probes_in_flight = max(0, self._probes_in_flight - 1)
            self._opened_at = self._time()
            self._transition(OPEN)
            return
        self._events.append(True)
        if self.state == CLOSED and len(self._events) >= self.min_calls:
            errs = sum(1 for e in self._events if e)
            if errs / len(self._events) >= self.error_rate:
                self._opened_at = self._time()
                self._transition(OPEN)

    # -- config -------------------------------------------------------------

    @classmethod
    def from_annotations(
        cls, ann: Dict[str, str], unit: str, **kwargs
    ) -> Optional["CircuitBreaker"]:
        """Annotation-gated (``seldon.io/breaker: "true"``), with per-unit
        overrides via ``<key>.<unit-name>``. Off by default — the happy
        path must be byte-identical with the subsystem unconfigured."""

        def get(key, default=None):
            return unit_ann(ann, key, unit, default)

        if str(get(ANNOTATION_BREAKER, "false")).lower() != "true":
            return None
        try:
            return cls(
                window=int(get(ANNOTATION_WINDOW, 20)),
                error_rate=float(get(ANNOTATION_ERROR_RATE, 0.5)),
                min_calls=int(get(ANNOTATION_MIN_CALLS, 5)),
                open_s=float(get(ANNOTATION_OPEN_MS, 5000)) / 1000.0,
                **kwargs,
            )
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"bad seldon.io/breaker-* annotation for unit {unit!r}: {e}"
            ) from e
