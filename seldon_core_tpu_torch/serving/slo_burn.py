"""SLO error budgets + multi-window burn-rate verdicts over the serving
latency feed (the port's own copy of ``seldon_core_tpu/serving/slo_burn.py``).

The batcher already measures TTFT / TPOT / queue-wait per completed
request (``slo_pending`` / ``tenant_slo_pending``); this module turns
those raw samples into the SRE alerting primitive an autoscaler (and,
later, the planner) can act on:

* an **objective** says "``target`` of requests must land under
  ``threshold_s``" — e.g. 99% of TTFTs under 200ms. The error budget is
  ``1 - target``.
* the **burn rate** over a window is
  ``observed_error_rate / error_budget``: 1.0 means the deployment is
  spending budget exactly as fast as the objective allows; 14.4 means a
  30-day budget gone in 50 hours.
* the **multi-window verdict** (Google SRE workbook shape) compares the
  burn over a FAST window (is it happening *now*?) and a SLOW window
  (has it been happening long enough to matter?). Both high → ``page``;
  only slow high → ``warn`` (a real but not raging burn); else ``ok``.
  The two-window AND is what keeps one latency spike from paging and a
  slow leak from hiding.

Verdicts are typed dicts (one per (tenant, slo)) — the same feed is
exported as ``seldon_engine_slo_burn_*`` series, rendered by /fleet,
and consumed by the reconciler's scale signals: a ``page`` verdict
vetoes scale-down and counts toward scale-up pressure.

Thread model: ``observe`` runs on whatever thread drains the batcher's
SLO rings (the /metrics exporter); ``verdicts``/``summary`` on metrics
and fleet threads. One lock, held for ring arithmetic only.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["SloObjective", "SloBurnEngine", "SEVERITIES"]

# severity ladder, worst last; the reconciler compares by index
SEVERITIES = ("ok", "warn", "page")


class SloObjective:
    """One latency objective: ``target`` fraction of requests under
    ``threshold_s`` for the named SLO (``ttft``/``tpot``/``queue_wait``)."""

    __slots__ = ("slo", "threshold_s", "target")

    def __init__(self, slo: str, threshold_s: float, target: float = 0.99):
        if not 0.0 < target < 1.0:
            raise ValueError(
                f"slo target must be in (0, 1), got {target!r} "
                "(1.0 leaves a zero error budget — burn would be "
                "infinite on the first slow request)"
            )
        if threshold_s <= 0.0:
            raise ValueError(f"slo threshold must be > 0s, got {threshold_s!r}")
        self.slo = str(slo)
        self.threshold_s = float(threshold_s)
        self.target = float(target)

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def spec(self) -> Dict[str, Any]:
        return {"slo": self.slo, "threshold_s": self.threshold_s,
                "target": self.target}

    @classmethod
    def parse(cls, spec: Dict[str, Any]) -> "List[SloObjective]":
        """``{"ttft": {"threshold_ms": 200, "target": 0.99}, ...}`` →
        objectives (``threshold_s`` also accepted; ms wins if both)."""
        out = []
        for slo, cfg in spec.items():
            if "threshold_ms" in cfg:
                thr = float(cfg["threshold_ms"]) * 1e-3
            else:
                thr = float(cfg["threshold_s"])
            out.append(cls(slo, thr, float(cfg.get("target", 0.99))))
        return out


class SloBurnEngine:
    """Per-(tenant, slo) sample rings + fast/slow burn-rate verdicts.

    ``fast_window_s``/``slow_window_s`` default to 60s/3600s — scaled
    down from the workbook's 5m/1h to serving-loop reality (a generate
    deployment's traffic shifts in seconds, not hours). ``page_burn``/
    ``warn_burn`` are the burn-rate thresholds for the two rungs.
    """

    def __init__(
        self,
        objectives: List[SloObjective],
        fast_window_s: float = 60.0,
        slow_window_s: float = 3600.0,
        page_burn: float = 14.4,
        warn_burn: float = 3.0,
        max_samples: int = 8192,
    ):
        self.objectives = list(objectives)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.page_burn = float(page_burn)
        self.warn_burn = float(warn_burn)
        self._max_samples = int(max_samples)
        self._lock = threading.Lock()
        self._by_slo = {o.slo: o for o in self.objectives}
        # (tenant, slo) -> list of (mono_t, breached) — pruned to the
        # slow window on every observe/verdict pass, capped at
        # max_samples so a hot tenant cannot grow host memory unbounded
        self._rings: Dict[Tuple[str, str], List[Tuple[float, bool]]] = {}
        # cumulative verdict evaluations per (tenant, slo, severity) —
        # exported as a counter through CounterDeltas, so it must only
        # ever grow
        self._verdict_counts: Dict[Tuple[str, str, str], int] = {}
        self.stats = {"samples": 0, "breaches": 0}

    # -- ingest -------------------------------------------------------------

    def observe(self, slo: str, value_s: Optional[float],
                tenant: str = "") -> None:
        """Record one request's latency sample against its objective.
        Samples for SLOs without an objective are dropped (no ring grows
        for series nobody budgets)."""
        obj = self._by_slo.get(slo)
        if obj is None or value_s is None:
            return
        breached = value_s > obj.threshold_s
        now = time.monotonic()
        key = (tenant or "", slo)
        with self._lock:
            ring = self._rings.setdefault(key, [])
            ring.append((now, breached))
            self.stats["samples"] += 1
            if breached:
                self.stats["breaches"] += 1
            if len(ring) > self._max_samples:
                del ring[: len(ring) - self._max_samples]

    # -- verdicts -----------------------------------------------------------

    def _burn(self, ring: List[Tuple[float, bool]], now: float,
              window_s: float, budget: float) -> Tuple[float, int]:
        """(burn_rate, n_samples) over the trailing window. An empty
        window burns nothing — absence of traffic is not an outage (the
        reconciler has its own idle-scale path)."""
        horizon = now - window_s
        n = bad = 0
        for t, breached in ring:
            if t >= horizon:
                n += 1
                if breached:
                    bad += 1
        if n == 0:
            return 0.0, 0
        return (bad / n) / budget, n

    def verdicts(self) -> List[Dict[str, Any]]:
        """One typed verdict per (tenant, slo) ring with data in the
        slow window — the feed /fleet ships and the reconciler's scale
        signals consume."""
        now = time.monotonic()
        out: List[Dict[str, Any]] = []
        with self._lock:
            horizon = now - self.slow_window_s
            for key in list(self._rings):
                ring = [r for r in self._rings[key] if r[0] >= horizon]
                if not ring:
                    del self._rings[key]  # tenant gone quiet: drop the ring
                    continue
                self._rings[key] = ring
                tenant, slo = key
                obj = self._by_slo[slo]
                fast, n_fast = self._burn(
                    ring, now, self.fast_window_s, obj.budget)
                slow, n_slow = self._burn(
                    ring, now, self.slow_window_s, obj.budget)
                if fast >= self.page_burn and slow >= self.page_burn:
                    severity = "page"
                elif slow >= self.warn_burn:
                    severity = "warn"
                else:
                    severity = "ok"
                # budget left in the slow window, as a fraction: 1.0 =
                # untouched, 0.0 = spent (burn 1.0 across the whole
                # window spends it exactly)
                remaining = max(0.0, 1.0 - slow)
                ck = (tenant, slo, severity)
                self._verdict_counts[ck] = self._verdict_counts.get(ck, 0) + 1
                out.append({
                    "tenant": tenant,
                    "slo": slo,
                    "threshold_s": obj.threshold_s,
                    "target": obj.target,
                    "fast_burn": round(fast, 4),
                    "slow_burn": round(slow, 4),
                    "fast_samples": n_fast,
                    "slow_samples": n_slow,
                    "budget_remaining": round(remaining, 4),
                    "severity": severity,
                })
        out.sort(key=lambda v: (v["tenant"], v["slo"]))
        return out

    def verdict_counts(self) -> Dict[Tuple[str, str, str], int]:
        """Cumulative verdict evaluations per (tenant, slo, severity)
        — counter totals for the CounterDeltas exporter."""
        with self._lock:
            return dict(self._verdict_counts)

    def worst(self) -> str:
        """Worst severity across every live ring (``ok`` when idle) —
        the one-word signal the reconciler's scale loop branches on."""
        worst = 0
        for v in self.verdicts():
            worst = max(worst, SEVERITIES.index(v["severity"]))
        return SEVERITIES[worst]

    def summary(self) -> Dict[str, Any]:
        """Rollup for /fleet and flight dumps."""
        return {
            "objectives": [o.spec() for o in self.objectives],
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "page_burn": self.page_burn,
            "warn_burn": self.warn_burn,
            "samples": self.stats["samples"],
            "breaches": self.stats["breaches"],
            "verdicts": self.verdicts(),
        }
