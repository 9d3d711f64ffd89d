"""Online autonomic planner: burn verdicts + gauges -> knob decisions.

Counterpart of ``seldon_core_tpu/planning/planner.py``.

The InferLine-shaped online half (PAPERS.md, arxiv 1812.01776): every
planner tick consumes the fleet telemetry the reconciler already
scrapes — per-(tenant, slo) burn-rate verdicts, the device-time
ledger's live gauges, the shed/preempt counter plane — walks the SPF1
cost model, and emits ONE typed :class:`Decision`. It never touches an
engine itself: the reconciler actuates decisions exclusively through
existing safe mechanisms (``ContinuousBatcher.retune()`` at a poll
boundary, the autoscaler's clamped replica rewrite), so the planner
can be unit-tested as a pure decision table.

The decision table, in precedence order (first match wins — the order
IS the same-tick conflict resolution, see docs/operate.md §"Autonomic
planning"):

====  ==========================================  =================
rank  condition                                   decision
====  ==========================================  =================
1     any ``page`` burn verdict                   ``scale_up``
2     shed/preempt deltas for ``hot_ticks``       ``scale_up``
      consecutive ticks
3     ``warn`` burn + cost model knows a config   ``retune``
      that meets the objectives (census-pinned)
4     ``warn`` burn, no meeting config            ``scale_up``
5     sheds with quiet burn + watermark headroom  ``retune``
      (raise ``pressure_high``)
6     quiet burn + idle device for                ``scale_down``
      ``scale_down_ticks`` consecutive ticks
7     otherwise                                   ``hold``
====  ==========================================  =================

Hysteresis is structural, and SHARED with the reconciler's autoscaler so the
two controllers cannot fight: ``scale_down_ticks`` is the same
stabilization window the HPA loop uses (the reconciler constructs the
planner with its own value), any non-quiet tick resets the idle
streak, a retune starts a ``retune_cooldown_ticks`` refractory period
(thrash guard — flight ``planner_retune`` records carry the evidence
when it trips), and rank 1 means a paging tick can never emit the
scale-down a quiet streak earned. The reconciler enforces the same
precedence at the actuation site: a burn-verdict page VETOES any
scale-down in the same tick, counted, deterministically.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional

from .artifact import CostModel, ProfileError

logger = logging.getLogger(__name__)

# profile config axes the batcher can actually retune live (subset of
# continuous.RETUNABLE_KNOBS that the SPF1 grid sweeps); slots and
# kv-tier bytes are boot-time — changing those is a scale/redeploy
# decision, never a retune
RETUNABLE_AXES = (
    "fused_steps_per_dispatch",
    "prefill_chunk",
    "depth_groups",
    "depth_group_split_bytes",
)


@dataclasses.dataclass
class Decision:
    """One planner tick's verdict. ``action`` is one of ``hold`` /
    ``retune`` / ``scale_up`` / ``scale_down``; ``knobs`` is non-empty
    only for ``retune`` (the exact kwargs for ``retune()``)."""

    action: str
    reason: str
    knobs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    rank: int = 0


class ServingPlanner:
    """Pure decision table over one predictor's telemetry; all state
    is tick counters (streaks, cooldowns, last counter totals)."""

    def __init__(
        self,
        cost_model: Optional[CostModel] = None,
        ttft_p99_ms: Optional[float] = None,
        tpot_p99_ms: Optional[float] = None,
        scale_down_ticks: int = 3,
        hot_ticks: int = 2,
        retune_cooldown_ticks: int = 3,
        idle_busy_frac: float = 0.10,
        pressure_high_ceiling: float = 0.95,
    ):
        self.cost_model = cost_model
        self.ttft_p99_ms = ttft_p99_ms
        self.tpot_p99_ms = tpot_p99_ms
        self.scale_down_ticks = max(1, int(scale_down_ticks))
        self.hot_ticks = max(1, int(hot_ticks))
        self.retune_cooldown_ticks = max(0, int(retune_cooldown_ticks))
        self.idle_busy_frac = float(idle_busy_frac)
        self.pressure_high_ceiling = float(pressure_high_ceiling)
        self._quiet_streak = 0
        self._hot_streak = 0
        self._cooldown = 0
        self._last_totals: Dict[str, float] = {}
        self.stats = {
            "ticks": 0, "retunes": 0, "scale_ups": 0,
            "scale_downs": 0, "holds": 0,
        }

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _worst(verdicts: List[Dict[str, Any]]) -> str:
        from ..serving.slo_burn import SEVERITIES

        worst = 0
        for v in verdicts or []:
            sev = v.get("severity")
            if sev in SEVERITIES:
                worst = max(worst, SEVERITIES.index(sev))
        return SEVERITIES[worst]

    def _deltas(self, totals: Dict[str, float]) -> Dict[str, float]:
        """Per-tick deltas of cumulative counters (sheds/preempts);
        a counter reset (member restart) clamps at zero."""
        out = {}
        for k, v in (totals or {}).items():
            prev = self._last_totals.get(k, 0.0)
            out[k] = max(0.0, float(v) - prev)
        self._last_totals = dict(totals or {})
        return out

    def _objectives(self, verdicts: List[Dict[str, Any]]):
        """Declared objectives win; else infer from the breached
        verdicts' own thresholds (slo names carry the phase)."""
        ttft, tpot = self.ttft_p99_ms, self.tpot_p99_ms
        for v in verdicts or []:
            if v.get("severity") not in ("warn", "page"):
                continue
            name = str(v.get("slo") or "").lower()
            thr_ms = float(v.get("threshold_s") or 0.0) * 1e3
            if thr_ms <= 0:
                continue
            if "ttft" in name and ttft is None:
                ttft = thr_ms
            elif "tpot" in name and tpot is None:
                tpot = thr_ms
        return ttft, tpot

    def _retune_target(
        self,
        verdicts: List[Dict[str, Any]],
        current_config: Optional[Dict[str, Any]],
        census: Optional[Dict[str, Any]],
    ) -> Optional[Dict[str, Any]]:
        """Knob diff toward the best census-compatible measured config
        meeting the objectives, or None when the profile has nothing
        better (then the breach is a capacity problem, not a tuning
        one). Only RETUNABLE_AXES ever appear in the diff."""
        if self.cost_model is None or not current_config:
            return None
        ttft, tpot = self._objectives(verdicts)
        if ttft is None and tpot is None:
            return None
        require: Dict[str, Any] = {"slots": current_config.get("slots")}
        if census:
            # out-of-census configs would be refused typed by retune();
            # don't even rank them. depth-group variants and the chunk
            # executable only exist when the boot census built them.
            if int(census.get("depth_groups") or 0) <= 1:
                require["depth_groups"] = int(
                    current_config.get("depth_groups") or 0
                )
        try:
            best = self.cost_model.best(
                ttft_p99_ms=ttft, tpot_p99_ms=tpot, require=require,
            )
        except ProfileError:
            return None
        if not best["meets"]:
            return None
        knobs = {}
        for axis in RETUNABLE_AXES:
            want = best["config"].get(axis)
            have = current_config.get(axis)
            if want is None or int(want) == int(have or 0):
                continue
            # an axis the profile never SWEPT carries no evidence: the
            # grid's constant is the sweep caller's choice, not a measured
            # preference over the member's live value (e.g. the
            # batcher's own split-bytes heuristic) — never churn it
            swept = {
                int(e["config"].get(axis) or 0)
                for e in self.cost_model.grid
            }
            if len(swept) <= 1:
                continue
            knobs[axis] = int(want)
        if census and "prefill_chunk" in knobs:
            if knobs["prefill_chunk"] not in (
                0, int(census.get("prefill_chunk") or 0)
            ):
                del knobs["prefill_chunk"]
        return knobs or None

    # -- the decision table --------------------------------------------------

    def tick(
        self,
        verdicts: Optional[List[Dict[str, Any]]] = None,
        gauges: Optional[Dict[str, float]] = None,
        counter_totals: Optional[Dict[str, float]] = None,
        current_config: Optional[Dict[str, Any]] = None,
        census: Optional[Dict[str, Any]] = None,
    ) -> Decision:
        """One pass of the table. ``gauges`` carries the merged live
        gauges (``device_busy_frac``, ``pressure_high``...);
        ``counter_totals`` the cumulative shed/preempt counters this
        planner diffs per tick."""
        verdicts = verdicts or []
        gauges = gauges or {}
        self.stats["ticks"] += 1
        if self._cooldown > 0:
            self._cooldown -= 1
        worst = self._worst(verdicts)
        deltas = self._deltas(counter_totals or {})
        pressure_events = sum(
            deltas.get(k, 0.0) for k in ("sheds", "preemptions")
        )

        decision = self._decide(
            worst, verdicts, gauges, pressure_events,
            current_config, census,
        )
        if decision.action == "retune":
            self._cooldown = self.retune_cooldown_ticks
            self.stats["retunes"] += 1
        elif decision.action == "scale_up":
            self.stats["scale_ups"] += 1
        elif decision.action == "scale_down":
            self.stats["scale_downs"] += 1
        else:
            self.stats["holds"] += 1
        return decision

    def _decide(
        self, worst, verdicts, gauges, pressure_events,
        current_config, census,
    ) -> Decision:
        # rank 1: paging burn — capacity, now. Resets every streak: a
        # page tick can never also bank idle credit toward scale-down.
        if worst == "page":
            self._quiet_streak = 0
            self._hot_streak = 0
            return Decision("scale_up", "paging SLO burn", rank=1)

        # rank 2: sustained shed/preempt pressure — HBM or admission
        # capacity, not a knob the profile can tune away
        if pressure_events > 0 and worst != "ok":
            self._hot_streak += 1
            self._quiet_streak = 0
            if self._hot_streak >= self.hot_ticks:
                self._hot_streak = 0
                return Decision(
                    "scale_up",
                    f"shed/preempt burn for {self.hot_ticks} ticks",
                    rank=2,
                )
            return Decision(
                "hold",
                f"pressure streak {self._hot_streak}/{self.hot_ticks}",
                rank=2,
            )
        self._hot_streak = 0

        # ranks 3/4: warn-level burn — first try to tune it away with a
        # measured, census-compatible config; profile says impossible →
        # it is a capacity signal
        if worst == "warn":
            self._quiet_streak = 0
            if self._cooldown > 0:
                return Decision(
                    "hold", f"retune cooldown ({self._cooldown} ticks left)",
                    rank=3,
                )
            knobs = self._retune_target(verdicts, current_config, census)
            if knobs:
                return Decision(
                    "retune", "warn burn: profile knows a meeting config",
                    knobs=knobs, rank=3,
                )
            return Decision(
                "scale_up", "warn burn and no profile config meets", rank=4,
            )

        # rank 5: sheds while burn is quiet — deadlines are being shed
        # at admission yet tenants aren't burning budget: the watermark
        # is too conservative for this traffic; nudge it (bounded)
        if pressure_events > 0:
            self._quiet_streak = 0
            high = gauges.get("pressure_high")
            if (
                self._cooldown == 0
                and high is not None
                and high + 0.02 < self.pressure_high_ceiling
            ):
                return Decision(
                    "retune", "sheds with quiet burn: raise admit watermark",
                    knobs={
                        "pressure_high": round(
                            min(self.pressure_high_ceiling, high + 0.05), 4
                        ),
                    },
                    rank=5,
                )
            return Decision("hold", "sheds with quiet burn", rank=5)

        # rank 6: quiet burn + idle device — bank a tick toward the
        # shared stabilization window
        busy = gauges.get("device_busy_frac")
        if busy is not None and busy < self.idle_busy_frac:
            self._quiet_streak += 1
            if self._quiet_streak >= self.scale_down_ticks:
                self._quiet_streak = 0
                return Decision(
                    "scale_down",
                    f"idle pools + quiet burn for "
                    f"{self.scale_down_ticks} ticks",
                    rank=6,
                )
            return Decision(
                "hold",
                f"idle streak {self._quiet_streak}/{self.scale_down_ticks}",
                rank=6,
            )
        self._quiet_streak = 0
        return Decision("hold", "objectives met", rank=7)


__all__ = ["Decision", "RETUNABLE_AXES", "ServingPlanner"]
