"""Custom-metrics helpers shipped in ``Meta.metrics``, and the engine's
service-time :class:`Ewma`.

Counterpart of ``seldon_core_tpu/metrics.py`` (COUNTER/GAUGE/TIMER dicts
validated, then merged into the response meta by ``seldon_methods``).

The delta contract
------------------

The engine sink **sums** every COUNTER value it receives per response
(``engine_metrics.record_custom``). A component that keeps cumulative
totals (the continuous batcher's scheduler counters) must therefore ship
the *increment since its last export*, never the running total — a total
re-shipped on every scrape would grow the engine series quadratically.
:class:`CounterDeltas` is the one sanctioned way to do that conversion:
one instance per component, ``delta = deltas.counter(key, running_total)``
per export. Rules:

* COUNTER = a delta produced by ``CounterDeltas.counter`` (monotonic
  source total; the first export ships the whole total as its delta);
* GAUGE = a level (cache bytes, occupancy, acceptance rate) — ship the
  current value, the sink overwrites;
* TIMER = one duration sample in **milliseconds** — the sink divides by
  1000 into a seconds histogram (one sample per event, e.g. the generate
  server's per-completion TTFT/TPOT/queue-wait triple).

The generate server's ``metrics()`` hook is the reference implementation
of all three.
"""

from __future__ import annotations

from typing import Dict, List

COUNTER = "COUNTER"
GAUGE = "GAUGE"
TIMER = "TIMER"

_TYPES = (COUNTER, GAUGE, TIMER)


def create_counter(key: str, value: float, tags: Dict[str, str] | None = None) -> Dict:
    m = {"key": key, "type": COUNTER, "value": value}
    if tags:
        m["tags"] = tags
    return m


def create_gauge(key: str, value: float, tags: Dict[str, str] | None = None) -> Dict:
    m = {"key": key, "type": GAUGE, "value": value}
    if tags:
        m["tags"] = tags
    return m


def create_timer(key: str, value: float, tags: Dict[str, str] | None = None) -> Dict:
    m = {"key": key, "type": TIMER, "value": value}
    if tags:
        m["tags"] = tags
    return m


class CounterDeltas:
    """Turn monotonically growing totals into ``Meta.metrics`` COUNTER
    deltas. The engine sink SUMS counter values per response
    (engine_metrics.record_custom), so a component holding cumulative
    stats (e.g. the continuous batcher's scheduler counters) must ship
    the increment since its last export, not the running total — this
    keeps that bookkeeping in one place. Locked: ``metrics()`` hooks run
    per-response from the serving thread pool, and an unlocked
    read-modify-write would double-report (or drop) deltas under
    concurrent exports."""

    def __init__(self):
        import threading

        self._last: Dict[str, float] = {}
        self._lock = threading.Lock()

    def counter(self, key: str, total: float, tags: Dict[str, str] | None = None) -> Dict:
        # the delta ledger is keyed by (key, tags): per-tenant counters
        # share a key and differ only in tags, and folding the tags in
        # keeps each series' running total independent — without this a
        # two-tenant export would see the other tenant's total and
        # clamp every other delta to zero
        ledger_key = key if not tags else key + "|" + ",".join(
            f"{k}={v}" for k, v in sorted(tags.items())
        )
        with self._lock:
            last = self._last.get(ledger_key, 0.0)
            self._last[ledger_key] = float(total)
        return create_counter(key, max(0.0, float(total) - last), tags)


class Ewma:
    """Exponentially weighted moving average of a scalar, thread-safe.

    ``value`` stays 0.0 until the first update; callers treat 0 as "no
    estimate yet". The engine's admission gate feeds it successful
    request durations — the observed-service-time estimate that drives
    deadline-aware load shedding (shed-before-work: reject when the
    expected completion time already exceeds the request's remaining
    budget). The continuous batcher's admit queue sheds on a different
    estimator suited to its shape — a completion-rate window over recent
    finishes (serving/continuous.py observed_rate)."""

    def __init__(self, alpha: float = 0.1):
        import threading

        self.alpha = float(alpha)
        self.value = 0.0
        self._seen = False
        self._lock = threading.Lock()

    def update(self, x: float) -> float:
        with self._lock:
            if not self._seen:
                self.value = float(x)
                self._seen = True
            else:
                self.value += self.alpha * (float(x) - self.value)
            return self.value


def validate_metrics(metrics: List[Dict]) -> bool:
    if not isinstance(metrics, (list, tuple)):
        return False
    for m in metrics:
        if not isinstance(m, dict):
            return False
        if "key" not in m or "value" not in m:
            return False
        if m.get("type", COUNTER) not in _TYPES:
            return False
        try:
            float(m["value"])
        except (TypeError, ValueError):
            return False
    return True
