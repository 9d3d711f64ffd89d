"""RolloutController: the SLO-gated progressive-delivery state machine.

Counterpart of ``seldon_core_tpu/rollout/controller.py``.

Ticked from the deployment reconciler's loop (like the autoscaler), one
state machine per deployment carrying a :class:`~.plan.RolloutPlan`:

* **canary** — the candidate's ``PredictorSpec.traffic`` ramps through
  ``plan.steps`` (baseline gets the complement, so the 100-sum always
  holds); each analysis interval the controller snapshots the engine
  metrics registry per predictor (request/error counters, the TTFT /
  TPOT / queue-wait histograms the engine exports, the request-latency
  histogram) and diffs against the previous snapshot — gates are
  evaluated over the WINDOW, not lifetime totals, so an old incident
  can't poison a later step.
* **shadow** — weights never move; the gates watch the mirror's
  divergence counters instead, for ``len(steps)`` observation windows.

Verdicts: ``promote`` (advance a step; past the last step the rollout is
``promoted``), ``pause`` (not enough candidate samples this window —
stay, re-analyze next interval), ``rollback`` (a gate breached — restore
the traffic weights captured when the rollout began, within the same
tick that detected the breach, i.e. inside one analysis interval).

Observability mirrors the resilience subsystem's idiom: a bounded event
trail per deployment (like breaker transition logs), plus
``seldon_rollout_step{deployment,predictor}`` (current candidate weight)
and ``seldon_rollout_verdicts{deployment,verdict}`` counters next to the
mirror's ``seldon_rollout_divergence``.

Weight updates go through ``store.apply`` — a generation bump the
reconciler consumes like any spec edit. Component names exclude traffic
(resource.spec_hash), so a ramp step re-routes the gateway without
restarting a single engine.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from ..graph.spec import GraphSpecError
from .plan import RolloutPlan, plan_from_deployment

logger = logging.getLogger(__name__)

# metric names read per predictor (labels {"deployment": <predictor name>}
# — EngineApp labels its series with the PredictorSpec name)
REQUESTS = "seldon_api_engine_server_requests"
ERRORS = "seldon_api_engine_server_errors"
TTFT_HIST = "seldon_engine_generate_ttft_seconds"
TPOT_HIST = "seldon_engine_generate_tpot_seconds"
LATENCY_HIST = "seldon_api_engine_server_requests_seconds"
MIRRORS = "seldon_rollout_mirrors"
DIVERGENCE = "seldon_rollout_divergence"
MIRROR_ERRORS = "seldon_rollout_mirror_errors"

PHASE_RAMPING = "ramping"
PHASE_PROMOTED = "promoted"
PHASE_ROLLED_BACK = "rolled_back"
PHASE_FAILED = "failed"  # shadow-mode terminal breach (no weights to restore)

MAX_EVENTS = 256


def plan_signature(plan: RolloutPlan) -> str:
    """Plan identity as a JSON string: comparable after a status-file
    round-trip (tuples don't survive JSON; strings do). Public because
    the reconciler compares it against the status checkpoint when
    deciding whether a shadow rollout is still active."""
    return json.dumps(plan.signature())


@dataclasses.dataclass
class _Totals:
    """Cumulative per-predictor observables at one instant."""

    requests: float = 0.0
    errors: float = 0.0
    ttft: Tuple[float, float] = (0.0, 0.0)  # (sum_s, count)
    tpot: Tuple[float, float] = (0.0, 0.0)
    latency: Tuple[float, float] = (0.0, 0.0)
    mirrors: float = 0.0
    diverged: float = 0.0
    mirror_errors: float = 0.0

    def window(self, prev: "_Totals") -> "_Totals":
        def d2(a, b):
            return (a[0] - b[0], a[1] - b[1])

        return _Totals(
            requests=self.requests - prev.requests,
            errors=self.errors - prev.errors,
            ttft=d2(self.ttft, prev.ttft),
            tpot=d2(self.tpot, prev.tpot),
            latency=d2(self.latency, prev.latency),
            mirrors=self.mirrors - prev.mirrors,
            diverged=self.diverged - prev.diverged,
            mirror_errors=self.mirror_errors - prev.mirror_errors,
        )


@dataclasses.dataclass
class RolloutState:
    plan: RolloutPlan
    plan_sig: str
    phase: str = PHASE_RAMPING
    step_ix: int = 0
    baseline_weights: Dict[str, int] = dataclasses.field(default_factory=dict)
    next_analysis_t: float = 0.0
    started_t: float = 0.0
    last: Dict[str, _Totals] = dataclasses.field(default_factory=dict)
    # last window error rate observed while the baseline still carried
    # traffic: the final analysis window (candidate at 100%) compares
    # against THIS, so a canary that falls over only under full load
    # still rolls back instead of promoting into a vacuously-passed gate
    baseline_error_rate: Optional[float] = None
    # same memory for the TTFT/TPOT/latency means — a latency-only
    # full-load regression must not promote ungated either
    baseline_means: Dict[str, float] = dataclasses.field(default_factory=dict)
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def event(self, kind: str, **fields) -> None:
        from ..tracing import wall_us

        # monotonic-anchored wall stamp: an NTP step mid-rollout must not
        # reorder the event trail the analysis windows are read against
        entry = {"t": wall_us() / 1e6, "event": kind, **fields}
        self.events.append(entry)
        if len(self.events) > MAX_EVENTS:
            del self.events[: len(self.events) - MAX_EVENTS]


class RolloutController:
    """Drives every store deployment's rollout plan; one tick per period."""

    def __init__(self, store, metrics=None, now=time.monotonic):
        if metrics is None:
            from ..graph.engine_metrics import REGISTRY

            metrics = REGISTRY
        self.store = store
        self.metrics = metrics
        self._now = now
        self._states: Dict[str, RolloutState] = {}

    # -- introspection -------------------------------------------------------

    def state(self, key: str) -> Optional[RolloutState]:
        return self._states.get(key)

    def events(self, key: str) -> List[Dict[str, Any]]:
        st = self._states.get(key)
        return list(st.events) if st else []

    def shadow_active(self, dep, plan: RolloutPlan) -> bool:
        """Whether ``plan`` (shadow mode) is still ramping — the
        reconciler keeps mirrors wired only while this holds, so a
        failed-on-divergence or promoted shadow stops receiving a
        duplicate of every request even though the annotations are still
        on the spec. In-memory state is authoritative; before the first
        tick (e.g. right after a control-plane restart) the durable
        status checkpoint carries the same phase."""
        st = self._states.get(dep.key)
        if st is not None:
            return st.phase == PHASE_RAMPING
        snap = getattr(dep.status, "rollout", None)
        if (
            isinstance(snap, dict)
            and snap.get("plan_sig") == plan_signature(plan)
            and snap.get("phase") != PHASE_RAMPING
        ):
            return False
        return True

    def table(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for key, st in self._states.items():
            out[key] = {
                "mode": st.plan.mode,
                "candidate": st.plan.candidate,
                "baseline": st.plan.baseline,
                "phase": st.phase,
                "step_ix": st.step_ix,
                "steps": list(st.plan.steps),
                "events": list(st.events[-16:]),
            }
        return out

    # -- tick ---------------------------------------------------------------

    def tick_all(self) -> Dict[str, str]:
        """One analysis pass over every deployment. Returns the verdicts
        applied this tick ({dep.key: verdict}) for logging/tests."""
        applied: Dict[str, str] = {}
        live_keys = set()
        for dep in self.store.list():
            live_keys.add(dep.key)
            try:
                verdict = self._tick_dep(dep)
            except GraphSpecError as e:
                logger.warning("rollout %s: invalid plan: %s", dep.key, e)
                continue
            except Exception:  # noqa: BLE001 - one bad rollout must not
                # stop driving the others (controller-runtime idiom)
                logger.exception("rollout tick %s failed", dep.key)
                continue
            if verdict:
                applied[dep.key] = verdict
        # deployments deleted (or stripped of their annotations elsewhere)
        # drop their state so a re-created rollout starts fresh
        for key in [k for k in self._states if k not in live_keys]:
            del self._states[key]
        return applied

    def _tick_dep(self, dep) -> Optional[str]:
        plan = plan_from_deployment(dep)
        key = dep.key
        if plan is None:
            self._states.pop(key, None)
            if getattr(dep.status, "rollout", None) is not None:
                dep.status.rollout = None
                self.store.update_status(dep)
            return None
        now = self._now()
        st = self._states.get(key)
        if st is None:
            st = self._rehydrate(key, dep, plan, now)
        if st is None or st.plan_sig != plan_signature(plan):
            # an annotation edit mid-ramp restarts the state machine, but
            # the pre-rollout weights must survive the restart: the
            # CURRENT weights are a mid-ramp split, and "rollback" means
            # the weights from before the rollout ever moved them
            inherited = (
                dict(st.baseline_weights)
                if st is not None and st.phase == PHASE_RAMPING
                else None
            )
            return self._start(key, dep, plan, now, inherited=inherited)
        st.plan = plan
        if st.phase != PHASE_RAMPING:
            return None
        if now < st.next_analysis_t:
            return None
        st.next_analysis_t = now + plan.interval_s
        cur = self._snapshot(plan, key)
        window = {
            name: cur[name].window(st.last.get(name, _Totals()))
            for name in cur
        }
        st.last = cur
        verdict, reasons = self._evaluate(plan, window, st)
        if verdict == "pause":
            st.event("pause", step=plan.steps[st.step_ix], reasons=reasons)
            self._verdict_metric(key, "pause")
            return "pause"
        if verdict == "rollback":
            return self._rollback(key, dep, st, reasons)
        return self._promote(key, dep, st)

    # -- transitions ---------------------------------------------------------

    def _rehydrate(self, key: str, dep, plan: RolloutPlan,
                   now: float) -> Optional["RolloutState"]:
        """Resume a rollout from the deployment-status checkpoint after a
        control-plane restart. Without this, a restart mid-ramp would
        re-start from the annotations and capture the CURRENT (mid-ramp,
        or even promoted) traffic split as the 'pre-rollout'
        baseline_weights — a later auto-rollback would then restore the
        failing candidate's weights. The caller still compares plan_sig:
        an annotation edit while the controller was down restarts the
        machine (inheriting the checkpointed baseline, same as a live
        edit)."""
        snap = getattr(dep.status, "rollout", None)
        if not isinstance(snap, dict) or "plan_sig" not in snap:
            return None
        st = RolloutState(
            plan=plan,
            plan_sig=snap["plan_sig"],
            phase=snap.get("phase", PHASE_RAMPING),
            step_ix=int(snap.get("step_ix", 0)),
            baseline_weights={
                k: int(v)
                for k, v in (snap.get("baseline_weights") or {}).items()
            },
            next_analysis_t=now + plan.interval_s,
            started_t=now,
        )
        ber = snap.get("baseline_error_rate")
        # restored so the final analysis window (baseline at 0% traffic)
        # still has traffic-bearing error/latency baselines to gate
        # against — a restart during the last step must not turn every
        # gate vacuous
        st.baseline_error_rate = float(ber) if ber is not None else None
        st.baseline_means = {
            k: float(v)
            for k, v in (snap.get("baseline_means") or {}).items()
            if v is not None
        }
        if st.phase == PHASE_RAMPING and st.step_ix >= len(plan.steps):
            return None  # torn checkpoint: restart fresh
        st.last = self._snapshot(plan, key)
        self._states[key] = st
        st.event("resume", phase=st.phase, step_ix=st.step_ix)
        if st.phase == PHASE_RAMPING and plan.mode == "canary":
            self._step_metric(key, plan, plan.steps[st.step_ix])
        logger.info(
            "rollout %s: resumed %s of %r at step %d (phase %s)",
            key, plan.mode, plan.candidate, st.step_ix, st.phase,
        )
        return st

    def _checkpoint(self, key: str, dep, st: "RolloutState") -> None:
        """Durably record the resume point in the deployment STATUS (no
        generation bump, so no reconcile retrigger)."""
        dep.status.rollout = {
            "plan_sig": st.plan_sig,
            "phase": st.phase,
            "step_ix": st.step_ix,
            "baseline_weights": dict(st.baseline_weights),
            "baseline_error_rate": st.baseline_error_rate,
            "baseline_means": dict(st.baseline_means),
        }
        self.store.update_status(dep)

    def _start(self, key: str, dep, plan: RolloutPlan, now: float,
               inherited: Optional[Dict[str, int]] = None) -> str:
        st = RolloutState(
            plan=plan,
            plan_sig=plan_signature(plan),
            baseline_weights=(
                inherited if inherited is not None
                else {p.name: p.traffic for p in dep.predictors}
            ),
            next_analysis_t=now + plan.interval_s,
            started_t=now,
        )
        st.last = self._snapshot(plan, key)
        self._states[key] = st
        first = plan.steps[0]
        st.event(
            "start", mode=plan.mode, candidate=plan.candidate,
            baseline=plan.baseline, steps=list(plan.steps),
            interval_s=plan.interval_s,
        )
        if plan.mode == "canary":
            self._apply_weights(dep, plan, first)
            st.event("step", weight=first, step_ix=0)
        self._step_metric(key, plan, first if plan.mode == "canary" else 0)
        self._verdict_metric(key, "start")
        self._checkpoint(key, dep, st)
        logger.info(
            "rollout %s: started %s of %r vs %r (steps %s)",
            key, plan.mode, plan.candidate, plan.baseline, list(plan.steps),
        )
        return "start"

    def _promote(self, key: str, dep, st: RolloutState) -> str:
        plan = st.plan
        st.step_ix += 1
        if st.step_ix >= len(plan.steps):
            st.phase = PHASE_PROMOTED
            st.event("promoted", final_weight=plan.steps[-1])
            self._verdict_metric(key, "promoted")
            self._checkpoint(key, dep, st)
            logger.info("rollout %s: %r promoted", key, plan.candidate)
            return "promoted"
        weight = plan.steps[st.step_ix]
        if plan.mode == "canary":
            self._apply_weights(dep, plan, weight)
            self._step_metric(key, plan, weight)
        st.event("step", weight=weight, step_ix=st.step_ix)
        self._verdict_metric(key, "promote")
        self._checkpoint(key, dep, st)
        logger.info(
            "rollout %s: %r promoted to step %d (weight %d)",
            key, plan.candidate, st.step_ix, weight,
        )
        return "promote"

    def _rollback(self, key: str, dep, st: RolloutState,
                  reasons: List[str]) -> str:
        plan = st.plan
        if plan.mode == "canary":
            self._restore_weights(dep, st.baseline_weights)
            st.phase = PHASE_ROLLED_BACK
            self._step_metric(
                key, plan, st.baseline_weights.get(plan.candidate, 0)
            )
            verdict = "rollback"
        else:
            # shadow mode has no routed traffic to restore — the rollout
            # simply fails, loudly
            st.phase = PHASE_FAILED
            verdict = "fail"
        st.event(verdict, reasons=reasons,
                 restored=dict(st.baseline_weights)
                 if plan.mode == "canary" else None)
        self._verdict_metric(key, verdict)
        self._checkpoint(key, dep, st)
        logger.warning(
            "rollout %s: %s of %r — %s", key, verdict, plan.candidate,
            "; ".join(reasons),
        )
        return verdict

    def _apply_weights(self, dep, plan: RolloutPlan, candidate_weight: int) -> None:
        updated = dep.clone()
        for p in updated.predictors:
            if p.name == plan.candidate:
                p.traffic = int(candidate_weight)
            elif p.name == plan.baseline:
                p.traffic = 100 - int(candidate_weight)
        self.store.apply(updated)

    def _restore_weights(self, dep, weights: Dict[str, int]) -> None:
        updated = dep.clone()
        for p in updated.predictors:
            if p.name in weights:
                p.traffic = int(weights[p.name])
        self.store.apply(updated)

    # -- observation ---------------------------------------------------------

    def _snapshot(self, plan: RolloutPlan, key: str) -> Dict[str, _Totals]:
        out: Dict[str, _Totals] = {}
        m = self.metrics
        for name in (plan.baseline, plan.candidate):
            labels = {"deployment": name}
            # mirror counters carry the deployment KEY (mirror.py) — scope
            # the query so two deployments sharing predictor names (the
            # conventional default/canary pair) can't read each other's
            # divergence. The engine request/latency series are labeled
            # by bare predictor name only; that aliasing is repo-wide.
            mlabels = {"deployment": key, "predictor": name}
            out[name] = _Totals(
                requests=m.counter_total(REQUESTS, labels),
                errors=m.counter_total(ERRORS, labels),
                ttft=m.histogram_totals(TTFT_HIST, labels),
                tpot=m.histogram_totals(TPOT_HIST, labels),
                latency=m.histogram_totals(LATENCY_HIST, labels),
                mirrors=m.counter_total(MIRRORS, mlabels),
                diverged=m.counter_total(DIVERGENCE, mlabels),
                mirror_errors=m.counter_total(MIRROR_ERRORS, mlabels),
            )
        return out

    def _evaluate(self, plan: RolloutPlan, window: Dict[str, _Totals],
                  st: RolloutState) -> Tuple[str, List[str]]:
        cand = window[plan.candidate]
        base = window[plan.baseline]
        breaches: List[str] = []
        if plan.mode == "shadow":
            # a shadow that ERRORS every mirror produces zero "mirrored"
            # samples — counting attempts (mirrors + errors) keeps a
            # broken shadow from pausing forever below min_samples, and
            # the error-delta gate (no routed baseline to diff against,
            # so it reads as an absolute mirror-error budget) fails it
            attempts = cand.mirrors + cand.mirror_errors
            if attempts < plan.min_samples:
                return "pause", [
                    f"only {attempts:.0f} mirrored samples "
                    f"(< {plan.min_samples})"
                ]
            err_frac = cand.mirror_errors / max(attempts, 1.0)
            if err_frac > plan.max_error_delta:
                breaches.append(
                    f"mirror error rate {err_frac:.3f} > "
                    f"{plan.max_error_delta} ({cand.mirror_errors:.0f}/"
                    f"{attempts:.0f} attempts)"
                )
            frac = cand.diverged / max(cand.mirrors, 1.0)
            if frac > plan.max_divergence:
                breaches.append(
                    f"divergence {frac:.3f} > {plan.max_divergence} "
                    f"({cand.diverged:.0f}/{cand.mirrors:.0f} mirrored)"
                )
            return ("rollback", breaches) if breaches else ("promote", [])
        total_c = cand.requests + cand.errors
        if total_c < plan.min_samples:
            return "pause", [
                f"only {total_c:.0f} candidate requests (< {plan.min_samples})"
            ]
        total_b = base.requests + base.errors
        er_c = cand.errors / max(total_c, 1.0)
        # an idle baseline (the final window at step 100, when it carries
        # 0% traffic) is "no data", not "0% error rate" — fall back to
        # the last window in which the baseline still served traffic, so
        # the error gate neither spuriously rolls back a candidate at the
        # service's normal error rate NOR vacuously promotes one that
        # falls over only under full load
        if total_b >= 1:
            er_b = base.errors / total_b
            st.baseline_error_rate = er_b
        else:
            er_b = st.baseline_error_rate
        if er_b is not None and er_c > er_b + plan.max_error_delta:
            breaches.append(
                f"error rate {er_c:.3f} > baseline {er_b:.3f} "
                f"+ {plan.max_error_delta}"
            )

        def mean_gate(name: str, c: Tuple[float, float],
                      b: Tuple[float, float], ratio: Optional[float]) -> None:
            # a graph without TTFT histograms must not trip (or vacuously
            # pass) a generate-only gate: the gate needs a baseline mean
            # from THIS window or a remembered one from the last window in
            # which the baseline still served traffic (the final window at
            # step 100 leaves the baseline idle — a canary whose latency
            # regresses only under full load must still roll back)
            if ratio is None:
                return
            if b[1] >= 1:
                st.baseline_means[name] = b[0] / b[1]
            if c[1] < plan.min_samples:
                return
            mb = st.baseline_means.get(name)
            if mb is None:
                return
            mc = c[0] / c[1]
            if mb > 0 and mc > mb * ratio:
                breaches.append(
                    f"{name} mean {mc * 1e3:.1f}ms > baseline "
                    f"{mb * 1e3:.1f}ms x {ratio}"
                )

        mean_gate("ttft", cand.ttft, base.ttft, plan.max_ttft_ratio)
        mean_gate("tpot", cand.tpot, base.tpot, plan.max_tpot_ratio)
        mean_gate("latency", cand.latency, base.latency, plan.max_latency_ratio)
        return ("rollback", breaches) if breaches else ("promote", [])

    # -- metrics -------------------------------------------------------------

    def _step_metric(self, key: str, plan: RolloutPlan, weight: int) -> None:
        try:
            self.metrics.gauge_set(
                "seldon_rollout_step", float(weight),
                {"deployment": key, "predictor": plan.candidate},
            )
        except Exception:  # noqa: BLE001
            pass

    def _verdict_metric(self, key: str, verdict: str) -> None:
        try:
            self.metrics.counter_inc(
                "seldon_rollout_verdicts",
                {"deployment": key, "verdict": verdict},
            )
        except Exception:  # noqa: BLE001
            pass
