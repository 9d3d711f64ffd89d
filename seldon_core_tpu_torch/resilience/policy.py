"""Retry, hedging, and shed policies + the client wrapper applying them
(counterpart of ``seldon_core_tpu/resilience/policy.py``).

The reference engine hardcoded 3 connection-level retries per hop
(reference: InternalPredictionService.java:87-91) and left everything
else to Istio route rules. Here the policies are explicit, per-unit
(annotation-gated with ``<key>.<unit-name>`` overrides), and budget-aware:
a retry is never attempted when its backoff would outlive the request's
deadline, and only idempotent predict-path methods retry at all
(``send_feedback`` mutates router state — replaying it would double-count
rewards).

Hedging (remote MODEL units only, annotation-gated): when the first
attempt is slower than the unit's observed p95, fire a second attempt and
take whichever response lands first, cancelling the loser — the classic
tail-latency trade (a few % extra load for a p99 set by the faster of two
draws).
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
from typing import Dict, Optional

from .breaker import BreakerOpen, CircuitBreaker, STATE_GAUGE, unit_ann
from .deadline import Deadline, DeadlineExceeded

ANNOTATION_RETRIES = "seldon.io/retries"
ANNOTATION_RETRY_BACKOFF_MS = "seldon.io/retry-backoff-ms"
ANNOTATION_RETRY_MAX_BACKOFF_MS = "seldon.io/retry-max-backoff-ms"
ANNOTATION_HEDGE = "seldon.io/hedge"
ANNOTATION_HEDGE_DELAY_MS = "seldon.io/hedge-delay-ms"

# methods safe to replay: the predict path is read-only by contract
# (reference components with per-call side effects already opt out of
# micro-batching for the same reason); feedback mutates learner state.
IDEMPOTENT_METHODS = frozenset(
    {"predict", "transform_input", "transform_output", "route", "aggregate"}
)

# statuses that signal a transient transport/overload condition worth
# retrying; 500 is an application error — replaying it is wasted budget
# (mirrors RestClient's do-not-retry-UnitCallError rule).
RETRYABLE_STATUSES = frozenset({408, 425, 429, 502, 503, 504})


class ShedError(RuntimeError):
    """Load shed before work: queue wait would outlive the deadline (or
    an explicit admit-queue cap was hit). Maps to 429 + Retry-After."""

    status = 429

    def __init__(self, info: str, retry_after_s: float = 1.0):
        super().__init__(info)
        self.info = info
        self.retry_after_s = retry_after_s


def is_retryable(exc: BaseException) -> bool:
    if isinstance(exc, (DeadlineExceeded, BreakerOpen, ShedError)):
        # the budget is gone / the unit is known-bad / the queue is too
        # deep — a retry cannot change any of those within this request
        return False
    if isinstance(exc, (asyncio.TimeoutError, ConnectionError, OSError)):
        return True
    status = getattr(exc, "status", None)
    return isinstance(status, int) and status in RETRYABLE_STATUSES


def counts_as_breaker_failure(exc: BaseException) -> bool:
    """Failures the breaker should learn from: transient transport errors
    AND 5xx application errors. BreakerOpen itself made no call, and a
    429 shed is a busy-but-healthy unit applying backpressure — letting
    it open the breaker would turn graceful Retry-After answers into a
    blanket blackout. DeadlineExceeded likewise says the CALLER's budget
    was tight, not that the unit is sick — tight-deadline traffic on a
    healthy-but-slow unit must not blackout everyone else."""
    if isinstance(exc, (BreakerOpen, ShedError, DeadlineExceeded)):
        return False
    if isinstance(exc, (asyncio.TimeoutError, ConnectionError, OSError)):
        return True
    status = getattr(exc, "status", None)
    return isinstance(status, int) and (status >= 500 or status in (408, 425))


# per-unit override resolution shared with the breaker (one rule, one home)
_unit_ann = unit_ann


@dataclasses.dataclass
class RetryPolicy:
    retries: int = 0
    backoff_ms: float = 25.0
    multiplier: float = 2.0
    max_backoff_ms: float = 1000.0
    jitter: float = 0.5  # fraction of each delay that is randomized

    def backoff_s(self, attempt: int, rng: random.Random) -> float:
        base = min(self.backoff_ms * self.multiplier ** attempt, self.max_backoff_ms)
        # decorrelated-ish jitter: delay in [base*(1-jitter), base]
        return base * (1.0 - self.jitter * rng.random()) / 1000.0

    @classmethod
    def from_annotations(cls, ann: Dict[str, str], unit: str) -> Optional["RetryPolicy"]:
        # malformed values FAIL STARTUP (like the breaker's parser): an
        # operator who typo'd "3x" believes retries are on — silently
        # running with zero would only surface in a production incident
        try:
            retries = int(_unit_ann(ann, ANNOTATION_RETRIES, unit, 0))
            backoff = float(_unit_ann(ann, ANNOTATION_RETRY_BACKOFF_MS, unit, 25.0))
            max_backoff = float(
                _unit_ann(ann, ANNOTATION_RETRY_MAX_BACKOFF_MS, unit, 1000.0)
            )
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"bad seldon.io/retries* annotation for unit {unit!r}: {e}"
            ) from e
        if retries <= 0:
            return None
        return cls(retries=retries, backoff_ms=backoff, max_backoff_ms=max_backoff)


@dataclasses.dataclass
class HedgePolicy:
    delay_ms: float = 100.0  # used until enough latency samples exist

    @classmethod
    def from_annotations(
        cls, ann: Dict[str, str], unit: str, transport: str, unit_type
    ) -> Optional["HedgePolicy"]:
        """Remote MODEL units only: hedging an in-process call doubles
        device work for nothing, and non-MODEL hops are structural."""
        if str(_unit_ann(ann, ANNOTATION_HEDGE, unit, "false")).lower() != "true":
            return None
        if (transport or "INPROCESS").upper() not in ("REST", "HTTP", "GRPC"):
            return None
        type_name = getattr(unit_type, "value", unit_type)
        if type_name not in (None, "MODEL"):
            return None
        try:
            delay = float(_unit_ann(ann, ANNOTATION_HEDGE_DELAY_MS, unit, 100.0))
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"bad seldon.io/hedge-delay-ms annotation for unit {unit!r}: {e}"
            ) from e
        return cls(delay_ms=delay)


class ResilientClient:
    """UnitClient wrapper: breaker -> (hedged) attempt -> retry loop, all
    deadline-aware. Only constructed when at least one policy is active,
    so unconfigured graphs keep their exact pre-existing client objects
    (and behavior)."""

    # ring size for the hedge p95 estimate; 64 samples is enough to place
    # the 95th percentile within a bucket or two without unbounded memory
    _LAT_SAMPLES = 64
    _MIN_SAMPLES_FOR_P95 = 8

    def __init__(
        self,
        inner,
        unit: str,
        retry: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        hedge: Optional[HedgePolicy] = None,
        metrics=None,
        seed: int = 0,
    ):
        self.inner = inner
        self.unit = unit
        self.retry = retry
        self.breaker = breaker
        self.hedge = hedge
        self.metrics = metrics
        self._labels = {"unit": unit}
        self._rng = random.Random(f"retry/{seed}/{unit}")
        self._latencies: list = []
        self._lat_ix = 0
        if breaker is not None and breaker._on_transition is None:
            breaker._on_transition = self._on_breaker_transition

    # -- passthroughs -------------------------------------------------------

    @property
    def user_object(self):
        """The engine's streaming front resolves single-node in-process
        graphs through this attribute; keep it visible through the wrap."""
        return getattr(self.inner, "user_object", None)

    async def ready(self) -> bool:
        return await self.inner.ready()

    async def close(self) -> None:
        await self.inner.close()

    # -- metrics ------------------------------------------------------------

    def _count(self, name: str, extra: Optional[Dict[str, str]] = None) -> None:
        if self.metrics is not None:
            self.metrics.counter_inc(name, {**self._labels, **(extra or {})})

    def _on_breaker_transition(self, old: str, new: str) -> None:
        self._count("seldon_engine_breaker_transitions", {"to": new})
        if self.metrics is not None:
            self.metrics.gauge_set(
                "seldon_engine_breaker_state", STATE_GAUGE[new], self._labels
            )

    def _record_latency(self, seconds: float) -> None:
        if self.hedge is None:
            return
        if len(self._latencies) < self._LAT_SAMPLES:
            self._latencies.append(seconds)
        else:
            self._latencies[self._lat_ix] = seconds
            self._lat_ix = (self._lat_ix + 1) % self._LAT_SAMPLES

    def _hedge_delay_s(self) -> float:
        if len(self._latencies) >= self._MIN_SAMPLES_FOR_P95:
            ordered = sorted(self._latencies)
            return ordered[int(0.95 * (len(ordered) - 1))]
        return self.hedge.delay_ms / 1000.0

    # -- call path ----------------------------------------------------------

    async def call(self, method: str, message, deadline: Optional[Deadline] = None):
        retry = self.retry if (self.retry and method in IDEMPOTENT_METHODS) else None
        attempts = 1 + (retry.retries if retry else 0)
        for attempt in range(attempts):
            if self.breaker is not None and not self.breaker.allow():
                raise BreakerOpen(f"circuit open for unit {self.unit}")
            try:
                out = await self._attempt(method, message)
            except BaseException as e:  # classified below; includes cancel
                if self.breaker is not None:
                    if isinstance(e, Exception) and counts_as_breaker_failure(e):
                        self.breaker.record_failure()
                    else:
                        # cancelled (deadline cut the call off) or an error
                        # the breaker doesn't learn from: release the
                        # allow() reservation so a half-open probe slot is
                        # never leaked (a leaked slot wedges the breaker
                        # in HALF_OPEN forever)
                        self.breaker.abandon()
                if not isinstance(e, Exception):
                    raise  # cancellation must propagate untouched
                if attempt + 1 >= attempts or not is_retryable(e):
                    raise
                delay = retry.backoff_s(attempt, self._rng)
                if deadline is not None and deadline.remaining() <= delay:
                    raise  # never retry past the deadline
                self._count("seldon_engine_unit_retries", {"method": method})
                await asyncio.sleep(delay)
                continue
            if self.breaker is not None:
                self.breaker.record_success()
            return out

    async def _attempt(self, method: str, message):
        import time

        if self.hedge is None or method != "predict":
            t0 = time.perf_counter()
            out = await self.inner.call(method, message)
            self._record_latency(time.perf_counter() - t0)
            return out
        return await self._hedged(method, message)

    @staticmethod
    def _reap(task) -> None:
        """Cancel a losing leg and swallow its eventual outcome so an
        abandoned attempt never logs 'exception was never retrieved'."""
        if not task.done():
            task.cancel()
        task.add_done_callback(
            lambda t: None if t.cancelled() else t.exception()
        )

    async def _hedged(self, method: str, message):
        """First attempt; at the unit's observed p95 fire a second; first
        RESPONSE wins (errors wait for the other leg), loser cancelled.
        The finally spans BOTH legs from creation: a caller cancellation
        (deadline) during the initial hedge-delay wait must not orphan
        the in-flight first attempt."""
        import time

        t0 = time.perf_counter()
        first = asyncio.ensure_future(self.inner.call(method, message))
        second = None
        try:
            done, _ = await asyncio.wait({first}, timeout=self._hedge_delay_s())
            if first in done:
                if first.exception() is None:
                    self._record_latency(time.perf_counter() - t0)
                return first.result()
            self._count("seldon_engine_hedged_calls")
            second = asyncio.ensure_future(self.inner.call(method, message))
            pending = {first, second}
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED
                )
                for task in done:
                    if task.exception() is None:
                        if task is second:
                            self._count("seldon_engine_hedge_wins")
                        self._record_latency(time.perf_counter() - t0)
                        return task.result()
            # both legs failed: surface the primary's error
            return first.result()
        finally:
            self._reap(first)
            if second is not None:
                self._reap(second)
