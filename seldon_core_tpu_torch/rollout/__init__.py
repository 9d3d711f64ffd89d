"""Progressive delivery: SLO-gated canary rollouts, shadow mirroring with
divergence diffing, and live weight hot-swap.

Counterpart of ``seldon_core_tpu/rollout/__init__.py``.

Seldon's flagship feature was progressive delivery — canary and shadow
predictors driven by Istio/Ambassador weight updates and an external
analysis controller (reference: operator/controllers/ambassador.go
weighted canaries + shadows; the Iter8/Flagger pairing the docs
recommended). The spec layer here already models the *shape* (traffic
weights on ``PredictorSpec``, ``seldon.io/shadow`` exclusion from the
100-sum) but nothing drove it: weights were static, shadows received no
mirrored traffic, and new weights meant a process restart. This package
drives it:

* :mod:`plan` — ``RolloutPlan`` parsed from ``seldon.io/rollout*``
  annotations (mode, step weights, analysis interval, SLO gates).
* :mod:`controller` — ``RolloutController``, ticked from the
  reconciler's loop: ramps ``PredictorSpec.traffic`` stepwise, reads the
  per-predictor SLO histograms (TTFT / TPOT / error rate
  series) and emits promote / pause / auto-rollback verdicts, exported
  as ``seldon_rollout_{step,verdicts}`` metrics plus an event trail.
* :mod:`mirror` — ``ShadowMirror``: fire-and-forget duplicate dispatch
  of live traffic to shadow predictors with bounded concurrency,
  feeding :mod:`differ` and the ``seldon_rollout_divergence`` counter.
  Mirrored traffic never affects the caller's latency or result.
* :mod:`differ` — response divergence diffing: token-level for generate
  responses, numeric-tolerance for predict tensors.

The fourth piece — live weight hot-swap — lives in the serving layer
(``serving/continuous.py`` ``request_weight_swap`` +
``servers/generateserver.py`` ``hot_swap``) because it must interlock
with the decode scheduler's poll boundary.

Everything is off by default: with rollout annotations absent the data
plane and control plane behave byte-identically to before this package
existed.
"""

from .controller import RolloutController  # noqa: F401
from .differ import diff_responses  # noqa: F401
from .mirror import ShadowMirror  # noqa: F401
from .plan import (  # noqa: F401
    ANNOTATION_ROLLOUT,
    RolloutPlan,
    plan_from_deployment,
)
