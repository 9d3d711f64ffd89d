"""Deterministic fault injection for graph units (counterpart of
``seldon_core_tpu/resilience/faults.py``).

Wraps any ``UnitClient`` to inject latency, errors, and hangs per
unit+method, driven by config (or the ``SELDON_FAULTS`` env var) and a
seed. Every random draw comes from a per-(unit, method) ``random.Random``
stream seeded from ``(seed, unit, method)``, so a fault schedule is
reproducible regardless of which other units run concurrently — the
property that makes retry/breaker/deadline behavior testable hermetically.
The streams are the JAX package's, draw for draw, so one config gives
both engines the same schedule.

Rule fields (all optional):

  unit          unit name or "*" (default "*")
  method        predict/transform_input/... or "*" (default "*")
  fail_first    fail the first N calls outright (deterministic ramps)
  error_rate    probability of an injected error per call
  error_status  status of injected errors (default 503, a retryable
                transport-style failure; 500 models an app error)
  latency_ms    added latency per call (plus uniform jitter_ms)
  jitter_ms     uniform extra latency in [0, jitter_ms)
  hang_rate     probability of hanging for hang_s (default 3600 — only a
                deadline or transport timeout gets the caller out)

Scheduler faults: a top-level ``scheduler`` section induces poll death
in the continuous batcher's loop (the supervised crash-restart path):
``{"scheduler": {"die_after_polls": 50, "times": 1}}``.

Not ported yet: the KV-transport rule fields (``kv_*``, the
disaggregated path's chaos harness) and the ``pressure`` section (the
HBM ledger); each raises when set.

Env wiring: ``SELDON_FAULTS`` holds the JSON config
(``{"seed": 7, "rules": [{...}], "scheduler": {...}}``) or
``@/path/to/faults.json``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import random
from typing import Dict, List, Optional, Tuple

_KV_FIELDS = (
    "kv_connect_refused_rate", "kv_corrupt_rate", "kv_truncate_rate",
    "kv_drop_rate", "kv_stall_rate", "kv_stall_ms",
)


class InjectedFault(RuntimeError):
    """An injected unit failure; carries a wire status like UnitCallError
    so the resilience layers (and the engine's error mapping) treat it
    exactly like the real failure it models."""

    def __init__(self, status: int, info: str):
        super().__init__(info)
        self.status = status
        self.info = info


@dataclasses.dataclass
class FaultRule:
    unit: str = "*"
    method: str = "*"
    fail_first: int = 0
    error_rate: float = 0.0
    error_status: int = 503
    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    hang_rate: float = 0.0
    hang_s: float = 3600.0

    def matches(self, unit: str, method: str) -> bool:
        return self.unit in ("*", unit) and self.method in ("*", method)


def _rule(r) -> FaultRule:
    if isinstance(r, FaultRule):
        return r
    kv = sorted(k for k in r if k in _KV_FIELDS and r[k])
    if kv:
        raise NotImplementedError(
            f"fault rule fields {kv} (KV-transport faults) are not ported "
            "to seldon_core_tpu_torch yet"
        )
    return FaultRule(**{k: v for k, v in r.items() if k not in _KV_FIELDS})


class FaultInjector:
    def __init__(self, rules, seed: int = 0, scheduler=None, pressure=None):
        if pressure:
            raise NotImplementedError(
                "the fault config's 'pressure' section (HBM-ledger shrink) "
                "is not ported to seldon_core_tpu_torch yet"
            )
        self.seed = int(seed)
        self.rules: List[FaultRule] = [_rule(r) for r in rules]
        # scheduler-level induced poll death: {"die_after_polls": N,
        # "times": M} — wired onto ContinuousBatcher.fault_hook
        self.scheduler = dict(scheduler or {})
        self._rngs: Dict[Tuple[str, str], random.Random] = {}
        self._calls: Dict[Tuple[str, str], int] = {}
        # observability for tests/bench: what actually got injected
        self.injected = {"errors": 0, "hangs": 0, "latency_calls": 0}

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultInjector"]:
        blob = (env or os.environ).get("SELDON_FAULTS")
        if not blob:
            return None
        if blob.startswith("@"):
            with open(blob[1:]) as f:
                blob = f.read()
        cfg = json.loads(blob)
        return cls(
            cfg.get("rules") or [],
            seed=cfg.get("seed", 0),
            scheduler=cfg.get("scheduler"),
            pressure=cfg.get("pressure"),
        )

    def _rng(self, unit: str, method: str) -> random.Random:
        key = (unit, method)
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = random.Random(f"{self.seed}/{unit}/{method}")
        return rng

    def wraps(self, unit: str) -> bool:
        return any(r.unit in ("*", unit) for r in self.rules)

    def wrap(self, client, unit: str):
        """FaultyClient around ``client`` when any rule targets ``unit``,
        else the client unchanged (zero overhead off the fault path)."""
        return FaultyClient(client, unit, self) if self.wraps(unit) else client

    async def perturb(self, unit: str, method: str) -> None:
        """Apply every matching rule before the real call: deterministic
        fail-first ramp, then hang, then latency, then error — each draw
        consumed from the (unit, method) stream in a fixed order so one
        rule's draws never shift another's."""
        # ONE call-count tick per perturb, not per matching rule
        key = (unit, method)
        n = self._calls.get(key, 0)
        self._calls[key] = n + 1
        for rule in self.rules:
            if not rule.matches(unit, method):
                continue
            rng = self._rng(unit, method)
            if n < rule.fail_first:
                self.injected["errors"] += 1
                raise InjectedFault(
                    rule.error_status,
                    f"injected fault: {unit}.{method} call {n} "
                    f"(fail_first={rule.fail_first})",
                )
            if rule.hang_rate and rng.random() < rule.hang_rate:
                self.injected["hangs"] += 1
                await asyncio.sleep(rule.hang_s)
            if rule.latency_ms or rule.jitter_ms:
                self.injected["latency_calls"] += 1
                extra = rule.jitter_ms * rng.random() if rule.jitter_ms else 0.0
                await asyncio.sleep((rule.latency_ms + extra) / 1000.0)
            if rule.error_rate and rng.random() < rule.error_rate:
                self.injected["errors"] += 1
                raise InjectedFault(
                    rule.error_status,
                    f"injected fault: {unit}.{method} "
                    f"(error_rate={rule.error_rate})",
                )

    def scheduler_hook(self):
        """Poll-death hook for ContinuousBatcher.fault_hook, or None
        when no scheduler section is configured. Raises InjectedFault on
        the configured poll count — ``times`` deaths max, spaced
        ``die_after_polls`` polls apart (poll counts are cumulative
        across restarts, so a restarted loop is not instantly re-killed
        mid-warmup)."""
        after = int(self.scheduler.get("die_after_polls", 0))
        if after <= 0:
            return None
        times = int(self.scheduler.get("times", 1))
        state = {"deaths": 0, "last": 0}

        def hook(poll_count: int) -> None:
            if state["deaths"] >= times:
                return
            if poll_count - state["last"] >= after:
                state["deaths"] += 1
                state["last"] = poll_count
                self.injected["errors"] += 1
                raise InjectedFault(
                    503,
                    f"injected scheduler poll death "
                    f"{state['deaths']}/{times} at poll {poll_count}",
                )

        return hook


class FaultyClient:
    """UnitClient wrapper that consults the injector before delegating."""

    def __init__(self, inner, unit: str, injector: FaultInjector):
        self.inner = inner
        self.unit = unit
        self.injector = injector

    @property
    def user_object(self):
        return getattr(self.inner, "user_object", None)

    async def call(self, method: str, message):
        await self.injector.perturb(self.unit, method)
        return await self.inner.call(method, message)

    async def ready(self) -> bool:
        return await self.inner.ready()

    async def close(self) -> None:
        await self.inner.close()
