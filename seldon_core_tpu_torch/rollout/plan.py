"""RolloutPlan: the annotation surface of progressive delivery.

Counterpart of ``seldon_core_tpu/rollout/plan.py``.

A deployment opts in by annotating ONE candidate predictor with
``seldon.io/rollout: canary`` (stepwise traffic ramp, SLO-gated) or
``seldon.io/rollout: shadow`` (mirrored traffic only, divergence-gated).
All other knobs ride sibling annotations on the same predictor — the
reference's annotations-as-feature-flags idiom (seldon.io/* on the
predictor, seldondeployment_types.go:35-45):

    seldon.io/rollout                 canary | shadow
    seldon.io/rollout-steps           "5,25,50,100" — candidate traffic %
                                      per analysis step (canary). Shadow
                                      mode counts observation windows
                                      instead (weights never move): a
                                      bare integer ("6" = six windows)
                                      or a list whose length counts
    seldon.io/rollout-interval-s      analysis interval seconds (def 30)
    seldon.io/rollout-min-samples     candidate requests an analysis
                                      window needs before a verdict other
                                      than "pause" (default 5)
    seldon.io/rollout-max-error-delta candidate error rate may exceed the
                                      baseline's by at most this (def 0.05)
    seldon.io/rollout-max-ttft-ratio  candidate mean TTFT <= baseline
                                      mean x ratio (default 1.5; gate
                                      skipped when either side has no
                                      TTFT samples in the window)
    seldon.io/rollout-max-tpot-ratio  same for TPOT (default 1.5)
    seldon.io/rollout-max-latency-ratio
                                      same for the engine request-latency
                                      histogram (default off — set it for
                                      non-generate graphs, which have no
                                      TTFT/TPOT series)
    seldon.io/rollout-max-divergence  shadow mode: mirrored-response
                                      divergence fraction that fails the
                                      rollout (default 0.0 — any
                                      divergence is a failure)

Parsing is strict (``GraphSpecError`` on malformed values) so manifest
typos fail at admission instead of silently disabling a gate.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..graph.spec import GraphSpecError, PredictorSpec

ANNOTATION_ROLLOUT = "seldon.io/rollout"
ANNOTATION_STEPS = "seldon.io/rollout-steps"
ANNOTATION_INTERVAL_S = "seldon.io/rollout-interval-s"
ANNOTATION_MIN_SAMPLES = "seldon.io/rollout-min-samples"
ANNOTATION_MAX_ERROR_DELTA = "seldon.io/rollout-max-error-delta"
ANNOTATION_MAX_TTFT_RATIO = "seldon.io/rollout-max-ttft-ratio"
ANNOTATION_MAX_TPOT_RATIO = "seldon.io/rollout-max-tpot-ratio"
ANNOTATION_MAX_LATENCY_RATIO = "seldon.io/rollout-max-latency-ratio"
ANNOTATION_MAX_DIVERGENCE = "seldon.io/rollout-max-divergence"
ANNOTATION_SHADOW = "seldon.io/shadow"

DEFAULT_STEPS = (5, 25, 50, 100)
DEFAULT_INTERVAL_S = 30.0
DEFAULT_MIN_SAMPLES = 5
DEFAULT_MAX_ERROR_DELTA = 0.05
DEFAULT_MAX_TTFT_RATIO = 1.5
DEFAULT_MAX_TPOT_RATIO = 1.5


def _is_shadow(p: PredictorSpec) -> bool:
    return p.annotations.get(ANNOTATION_SHADOW, "false") == "true"


def _parse_float(ann, key: str, default: Optional[float], who: str,
                 lo: float = 0.0) -> Optional[float]:
    raw = ann.get(key)
    if raw is None:
        return default
    try:
        v = float(raw)
    except (TypeError, ValueError) as e:
        raise GraphSpecError(f"{who}: malformed {key}={raw!r}: {e}") from e
    if v < lo:
        raise GraphSpecError(f"{who}: {key} must be >= {lo}, got {v}")
    return v


@dataclasses.dataclass(frozen=True)
class RolloutPlan:
    """One predictor's parsed progressive-delivery intent."""

    mode: str  # "canary" | "shadow"
    candidate: str  # predictor carrying the annotation
    baseline: str  # the live predictor it is measured against
    steps: Tuple[int, ...]
    interval_s: float
    min_samples: int
    max_error_delta: float
    max_ttft_ratio: Optional[float]
    max_tpot_ratio: Optional[float]
    max_latency_ratio: Optional[float]
    max_divergence: float

    def signature(self) -> Tuple:
        """Identity of this plan: a changed annotation restarts the state
        machine from step 0 (the operator edited the rollout)."""
        return dataclasses.astuple(self)


def plan_from_predictor(p: PredictorSpec, baseline: str) -> RolloutPlan:
    ann = p.annotations or {}
    mode = ann.get(ANNOTATION_ROLLOUT, "").strip().lower()
    who = f"predictor {p.name!r}"
    if mode not in ("canary", "shadow"):
        raise GraphSpecError(
            f"{who}: {ANNOTATION_ROLLOUT} must be 'canary' or 'shadow', "
            f"got {mode!r}"
        )
    raw_steps = ann.get(ANNOTATION_STEPS)
    if raw_steps is None:
        steps: List[int] = list(DEFAULT_STEPS)
    else:
        try:
            steps = [int(x) for x in str(raw_steps).split(",") if x.strip()]
        except ValueError as e:
            raise GraphSpecError(
                f"{who}: malformed {ANNOTATION_STEPS}={raw_steps!r}: {e}"
            ) from e
    if not steps:
        raise GraphSpecError(f"{who}: {ANNOTATION_STEPS} is empty")
    if mode == "shadow":
        # shadows carry no routed traffic, so the annotation is the
        # NUMBER of observation windows: a bare integer ("6" = six
        # windows), or a weight list whose LENGTH counts (canary
        # manifests copy-pasted into shadow mode keep their cadence)
        n = steps[0] if len(steps) == 1 else len(steps)
        if n < 1:
            raise GraphSpecError(
                f"{who}: shadow rollout needs >= 1 observation window, "
                f"got {raw_steps!r}"
            )
        steps = list(range(1, n + 1))
    else:
        if any(not (0 < s <= 100) for s in steps):
            raise GraphSpecError(
                f"{who}: rollout steps must be traffic weights in 1..100, "
                f"got {steps}"
            )
        if any(b <= a for a, b in zip(steps, steps[1:])):
            raise GraphSpecError(
                f"{who}: rollout steps must strictly increase, got {steps}"
            )
        if steps[0] >= 100:
            # a first step of 100 starves the baseline from the first
            # window: no gate could ever evaluate (nothing to compare
            # against), so the "rollout" would promote a fully-failing
            # candidate. That's a blue/green cutover, not a canary.
            raise GraphSpecError(
                f"{who}: the first rollout step must leave the baseline "
                f"traffic to compare against (got {steps[0]}); use a "
                "plain spec edit for an ungated 100% cutover"
            )
    interval_s = _parse_float(ann, ANNOTATION_INTERVAL_S, DEFAULT_INTERVAL_S, who)
    if interval_s <= 0:
        raise GraphSpecError(f"{who}: {ANNOTATION_INTERVAL_S} must be > 0")
    raw_min = ann.get(ANNOTATION_MIN_SAMPLES)
    try:
        min_samples = int(raw_min) if raw_min is not None else DEFAULT_MIN_SAMPLES
    except (TypeError, ValueError) as e:
        raise GraphSpecError(
            f"{who}: malformed {ANNOTATION_MIN_SAMPLES}={raw_min!r}: {e}"
        ) from e
    if min_samples < 1:
        raise GraphSpecError(f"{who}: {ANNOTATION_MIN_SAMPLES} must be >= 1")
    shadow = _is_shadow(p)
    if mode == "shadow" and not shadow:
        raise GraphSpecError(
            f"{who}: rollout mode 'shadow' needs the predictor annotated "
            f"{ANNOTATION_SHADOW}: \"true\" (it receives mirrored traffic, "
            "not routed traffic)"
        )
    if mode == "canary" and shadow:
        raise GraphSpecError(
            f"{who}: a shadow predictor cannot run a 'canary' rollout — "
            "shadows carry no routable traffic to ramp"
        )
    return RolloutPlan(
        mode=mode,
        candidate=p.name,
        baseline=baseline,
        steps=tuple(steps),
        interval_s=float(interval_s),
        min_samples=min_samples,
        max_error_delta=_parse_float(
            ann, ANNOTATION_MAX_ERROR_DELTA, DEFAULT_MAX_ERROR_DELTA, who
        ),
        max_ttft_ratio=_parse_float(
            ann, ANNOTATION_MAX_TTFT_RATIO, DEFAULT_MAX_TTFT_RATIO, who
        ),
        max_tpot_ratio=_parse_float(
            ann, ANNOTATION_MAX_TPOT_RATIO, DEFAULT_MAX_TPOT_RATIO, who
        ),
        max_latency_ratio=_parse_float(
            ann, ANNOTATION_MAX_LATENCY_RATIO, None, who
        ),
        max_divergence=_parse_float(ann, ANNOTATION_MAX_DIVERGENCE, 0.0, who),
    )


def plan_from_predictors(
    predictors: List[PredictorSpec], who: str = "deployment"
) -> Optional[RolloutPlan]:
    """The predictor set's rollout plan, or None when no predictor
    carries the annotation. Exactly one candidate is allowed, and a
    canary needs exactly one live (non-shadow, non-candidate) baseline
    predictor to trade traffic with. Also the admission check
    ``graph.spec.validate_deployment`` runs, so a malformed plan fails
    the apply instead of silently idling at tick time."""
    annotated = [
        p for p in predictors if ANNOTATION_ROLLOUT in (p.annotations or {})
    ]
    if not annotated:
        return None
    if len(annotated) > 1:
        raise GraphSpecError(
            f"{who}: at most one predictor may carry "
            f"{ANNOTATION_ROLLOUT}, got {[p.name for p in annotated]}"
        )
    candidate = annotated[0]
    baselines = [
        p.name
        for p in predictors
        if p.name != candidate.name and not _is_shadow(p)
    ]
    if len(baselines) != 1:
        raise GraphSpecError(
            f"{who}: a rollout needs exactly one live baseline predictor "
            f"besides {candidate.name!r}, got {baselines}"
        )
    return plan_from_predictor(candidate, baseline=baselines[0])


def plan_from_deployment(dep) -> Optional[RolloutPlan]:
    return plan_from_predictors(dep.predictors, who=f"deployment {dep.name!r}")
