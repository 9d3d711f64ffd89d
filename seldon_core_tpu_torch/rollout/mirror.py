"""ShadowMirror: bounded fire-and-forget traffic mirroring with diffing.

Counterpart of ``seldon_core_tpu/rollout/mirror.py``.

The gateway has always *selected* shadow handles (ingress.py), but its
mirroring was an unbounded ``ensure_future`` that dropped the response
on the floor. This mirror is the engine-side replacement the rollout
subsystem wires in (reconciler → ``EngineApp.shadow_mirror``):

* **Never on the caller's path.** ``submit()`` schedules a task and
  returns immediately; every exception inside the mirror is swallowed
  and counted. The primary's response was already computed — mirroring
  can only ever ADD device load, never latency or errors.
* **Bounded concurrency.** At most ``max_concurrency`` mirrored calls in
  flight per mirror; excess submissions are dropped and counted
  (``seldon_rollout_mirror_dropped``) — a slow shadow must not queue
  unbounded duplicate work behind itself.
* **Divergence diffing.** Each shadow response is compared to the
  primary's (:mod:`differ`): token-level for generate, numeric-tolerance
  for predict — feeding ``seldon_rollout_divergence{deployment,
  predictor,kind}`` and a bounded ring of recent divergence samples for
  post-hoc inspection.
"""

from __future__ import annotations

import asyncio
import collections
import logging
from typing import Any, Dict, List, Optional, Tuple

from .differ import diff_responses

logger = logging.getLogger(__name__)


async def dispatch_engine(target, message: Dict[str, Any]) -> Dict[str, Any]:
    """One engine-level predict against ``target``, which may be an
    EngineApp-like object (async ``predict``), a ComponentHandle carrying
    one (``.app``), a handle/str with a URL (REST hop via
    graph.client.engine_predict_url), or a plain callable."""
    app = getattr(target, "app", None)
    if app is not None and hasattr(app, "predict"):
        target = app
    if hasattr(target, "predict"):
        out = target.predict(message)
        return await out if asyncio.iscoroutine(out) else out
    url = target if isinstance(target, str) else getattr(target, "url", None)
    if url:
        from ..graph.client import engine_predict_url

        return await engine_predict_url(url, message)
    if callable(target):
        out = target(message)
        return await out if asyncio.iscoroutine(out) else out
    raise TypeError(f"un-dispatchable mirror target {target!r}")


class ShadowMirror:
    """Mirror live requests to shadow predictors and diff the answers."""

    def __init__(
        self,
        targets: List[Tuple[str, Any]],
        deployment: str = "",
        metrics=None,
        max_concurrency: int = 4,
        atol: float = 1e-5,
        rtol: float = 1e-3,
        max_samples: int = 64,
    ):
        self.targets = list(targets)
        self.deployment = deployment
        self.metrics = metrics
        self.max_concurrency = max(1, int(max_concurrency))
        self.atol = float(atol)
        self.rtol = float(rtol)
        self.inflight = 0
        self.counts = {"mirrored": 0, "diverged": 0, "dropped": 0, "errors": 0}
        # most-recent divergence verdicts, for /routes-style inspection
        self.recent: "collections.deque" = collections.deque(maxlen=max_samples)

    # -- submission (primary request path; must never raise) ----------------

    def submit(self, message: Dict[str, Any], primary_response: Dict[str, Any]) -> int:
        """Fire-and-forget mirror of one served request. Returns how many
        shadow dispatches were scheduled (0 when dropped/no loop)."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no event loop on this thread (sync test double): drop, count
            self._count("dropped", len(self.targets))
            return 0
        scheduled = 0
        for name, target in self.targets:
            if self.inflight >= self.max_concurrency:
                self._count("dropped", 1, predictor=name)
                continue
            self.inflight += 1
            # shallow copy: isolates TOP-LEVEL key writes only (nested
            # meta/jsonData stay shared — no dispatch path mutates those
            # in place today; deep-copying every mirrored payload would
            # tax the primary path)
            task = loop.create_task(
                self._mirror_one(name, target, dict(message), primary_response)
            )
            task.add_done_callback(_swallow)
            scheduled += 1
        return scheduled

    async def _mirror_one(self, name: str, target, message, primary_response):
        try:
            shadow_out = await dispatch_engine(target, message)
        except Exception as e:  # noqa: BLE001 - mirror failure is telemetry
            self._count("errors", 1, predictor=name)
            logger.warning("shadow mirror to %s failed: %s", name, e)
            return
        finally:
            self.inflight -= 1
        verdict = diff_responses(
            primary_response, shadow_out, atol=self.atol, rtol=self.rtol
        )
        self._count("mirrored", 1, predictor=name)
        if verdict.get("diverged"):
            self._count(
                "diverged", 1, predictor=name, kind=verdict.get("kind", "opaque")
            )
            from ..tracing import wall_us

            self.recent.append(
                # monotonic-anchored stamp keeps the divergence trail
                # ordered through NTP steps
                {"t": wall_us() / 1e6, "predictor": name, **verdict}
            )

    # -- accounting ----------------------------------------------------------

    _METRIC = {
        "mirrored": "seldon_rollout_mirrors",
        "diverged": "seldon_rollout_divergence",
        "dropped": "seldon_rollout_mirror_dropped",
        "errors": "seldon_rollout_mirror_errors",
    }

    def _count(self, what: str, n: int, predictor: Optional[str] = None,
               kind: Optional[str] = None) -> None:
        self.counts[what] += n
        if self.metrics is None:
            return
        labels = {"deployment": self.deployment}
        if predictor:
            labels["predictor"] = predictor
        if kind:
            labels["kind"] = kind
        try:
            self.metrics.counter_inc(self._METRIC[what], labels, n)
        except Exception:  # noqa: BLE001 - metrics must not break mirroring
            pass

    def summary(self) -> Dict[str, Any]:
        return {
            "targets": [name for name, _ in self.targets],
            "max_concurrency": self.max_concurrency,
            **self.counts,
            "recent_divergences": list(self.recent),
        }


def _swallow(task: "asyncio.Task") -> None:
    if not task.cancelled() and task.exception() is not None:
        logger.warning("shadow mirror task died: %s", task.exception())
