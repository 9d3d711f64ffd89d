"""Engine-side metrics registry with Prometheus text exposition.

Counterpart of ``seldon_core_tpu/graph/engine_metrics.py``. Parity with
the reference engine's Micrometer setup: auto-timed server/client request
timers with percentile histograms (reference:
engine/src/main/resources/application.properties:4-11,
engine/.../metrics/CustomMetricsManager.java:27-70 for dynamic
counters/gauges/timers fed from ``Meta.metrics``), scraped at
``/prometheus`` (and ``/metrics``). The fleet snapshot/merge of the JAX
package waits for the port's fleet telemetry.
"""

from __future__ import annotations

import math
import threading
from collections import defaultdict
from typing import Dict, List, Tuple

# latency buckets in seconds (log-spaced 100us..10s, like Micrometer SLO defaults)
_BUCKETS = [
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
]

LabelKey = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[LabelKey, float]] = defaultdict(lambda: defaultdict(float))
        self._gauges: Dict[str, Dict[LabelKey, float]] = defaultdict(dict)
        # name -> labels -> [bucket counts..., sum, count]
        self._histograms: Dict[str, Dict[LabelKey, List[float]]] = defaultdict(dict)

    def counter_inc(self, name: str, labels: Dict[str, str] | None = None, value: float = 1.0):
        with self._lock:
            self._counters[name][_labels_key(labels or {})] += value

    def gauge_set(self, name: str, value: float, labels: Dict[str, str] | None = None):
        with self._lock:
            self._gauges[name][_labels_key(labels or {})] = value

    def observe(self, name: str, seconds: float, labels: Dict[str, str] | None = None):
        key = _labels_key(labels or {})
        with self._lock:
            h = self._histograms[name].get(key)
            if h is None:
                h = [0.0] * (len(_BUCKETS) + 2)
                self._histograms[name][key] = h
            for i, b in enumerate(_BUCKETS):
                if seconds <= b:
                    h[i] += 1
            h[-2] += seconds
            h[-1] += 1

    # generate-scheduler step counters additionally export as ONE
    # first-class series with a phase label: prefill vs decode device
    # steps per graph node
    _STEP_PHASES = {
        "gen_prefill_steps": ("seldon_engine_generate_steps", "prefill"),
        "gen_decode_steps": ("seldon_engine_generate_steps", "decode"),
        "gen_prefill_tokens": ("seldon_engine_generate_step_tokens", "prefill"),
    }

    # fault tolerance: supervised batcher restarts land in a first-class
    # series, the scheduler's health in a first-class gauge (1 = serving,
    # 0 = restarting/dead; readiness mirrors it)
    _RECOVERY = {
        "gen_batcher_restarts": "seldon_engine_batcher_restarts",
        # HBM pressure: decode-lane preemptions and their resumes, the
        # admission sheds while the ledger is latched, and the reclaim
        # ladder's prefix evictions (refusals come with disaggregated
        # serving, not ported yet)
        "gen_preemptions": "seldon_engine_preemptions",
        "gen_preempt_resumes": "seldon_engine_preemption_resumes",
        "gen_pressure_sheds": "seldon_engine_pressure_sheds",
        "gen_pressure_refused": "seldon_engine_pressure_refused",
        "gen_pressure_prefix_evictions": "seldon_engine_pressure_prefix_evictions",
    }

    # fused stop-aware decode: device steps run inside fused bursts and
    # the dispatches that carried them; steps / dispatches is the
    # realized burst length
    _FUSED = {
        "gen_fused_steps": "seldon_engine_fused_steps",
        "gen_fused_dispatches": "seldon_engine_fused_dispatches",
    }
    _RECOVERY_GAUGES = {
        "gen_batcher_healthy": "seldon_engine_batcher_healthy",
        # the HBM-pressure ledger: used vs budget, and whether the high
        # watermark is latched (1 = admissions held and shed)
        "gen_pressure_used_bytes": "seldon_engine_pressure_used_bytes",
        "gen_pressure_budget_bytes": "seldon_engine_pressure_budget_bytes",
        "gen_pressure_active": "seldon_engine_pressure_active",
    }

    # generate SLO TIMERs (per completed request, shipped by the generate
    # server's metrics() hook) additionally land in first-class latency
    # histograms per graph node: TTFT, TPOT and admit-queue wait
    _SLO_TIMERS = {
        "gen_ttft_ms": "seldon_engine_generate_ttft_seconds",
        "gen_tpot_ms": "seldon_engine_generate_tpot_seconds",
        "gen_queue_wait_ms": "seldon_engine_generate_queue_wait_seconds",
    }

    def record_custom(self, metrics: List[Dict], labels: Dict[str, str] | None = None):
        """Sink for Meta.metrics emitted by components
        (reference: PredictiveUnitBean.addCustomMetrics:318-344)."""
        for m in metrics or []:
            tags = dict(labels or {})
            tags.update(m.get("tags") or {})
            mtype = m.get("type", "COUNTER")
            key = m.get("key", "custom")
            val = float(m.get("value", 0))
            if mtype == "COUNTER":
                self.counter_inc(f"seldon_custom_{key}", tags, val)
                step = self._STEP_PHASES.get(key)
                if step is not None:
                    name, phase = step
                    self.counter_inc(name, {**tags, "phase": phase}, val)
                recovery = self._RECOVERY.get(key)
                if recovery is not None:
                    self.counter_inc(recovery, tags, val)
                fused = self._FUSED.get(key)
                if fused is not None:
                    self.counter_inc(fused, tags, val)
            elif mtype == "GAUGE":
                self.gauge_set(f"seldon_custom_{key}", val, tags)
                rg = self._RECOVERY_GAUGES.get(key)
                if rg is not None:
                    self.gauge_set(rg, val, tags)
            elif mtype == "TIMER":
                self.observe(f"seldon_custom_{key}", val / 1000.0, tags)
                slo = self._SLO_TIMERS.get(key)
                if slo is not None:
                    self.observe(slo, val / 1000.0, tags)

    # -- label-subset readers ------------------------------------------------
    # A series matches when its labels are a SUPERSET of the given ones, so
    # {"deployment": "canary"} sums over every unit/tag variant of that
    # predictor's series without the caller enumerating them.

    @staticmethod
    def _matches(key: LabelKey, want: Dict[str, str]) -> bool:
        have = dict(key)
        return all(have.get(k) == v for k, v in want.items())

    def counter_total(self, name: str, labels: Dict[str, str] | None = None) -> float:
        want = labels or {}
        with self._lock:
            series = self._counters.get(name)
            if not series:
                return 0.0
            return float(sum(
                v for key, v in series.items() if self._matches(key, want)
            ))

    def histogram_totals(
        self, name: str, labels: Dict[str, str] | None = None
    ) -> Tuple[float, float]:
        """(sum_seconds, count) over every matching histogram series —
        window-diffing two calls gives a mean over exactly that window."""
        want = labels or {}
        total_sum, total_count = 0.0, 0.0
        with self._lock:
            for key, h in self._histograms.get(name, {}).items():
                if self._matches(key, want):
                    total_sum += h[-2]
                    total_count += h[-1]
        return total_sum, total_count

    def quantile(self, name: str, q: float, labels: Dict[str, str] | None = None) -> float:
        """Approximate quantile from histogram buckets (for tests/bench)."""
        key = _labels_key(labels or {})
        with self._lock:
            h = self._histograms.get(name, {}).get(key)
            if not h or h[-1] == 0:
                return math.nan
            target = q * h[-1]
            prev = 0.0
            for i, b in enumerate(_BUCKETS):
                if h[i] >= target:
                    return b
                prev = b
            return prev

    def expose(self) -> str:
        lines: List[str] = []
        with self._lock:
            for name, series in self._counters.items():
                lines.append(f"# TYPE {name} counter")
                for key, v in series.items():
                    lines.append(f"{name}{_fmt_labels(key)} {v}")
            for name, series in self._gauges.items():
                lines.append(f"# TYPE {name} gauge")
                for key, v in series.items():
                    lines.append(f"{name}{_fmt_labels(key)} {v}")
            for name, series in self._histograms.items():
                lines.append(f"# TYPE {name} histogram")
                for key, h in series.items():
                    for i, b in enumerate(_BUCKETS):
                        le = f'le="{b}"'
                        lines.append(f"{name}_bucket{_fmt_labels(key, le)} {h[i]}")
                    inf = 'le="+Inf"'
                    lines.append(f"{name}_bucket{_fmt_labels(key, inf)} {h[-1]}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} {h[-2]}")
                    lines.append(f"{name}_count{_fmt_labels(key)} {h[-1]}")
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()
