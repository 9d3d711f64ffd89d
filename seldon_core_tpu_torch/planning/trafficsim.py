"""Seeded million-user traffic simulator: trace-replay load generation.

Counterpart of ``seldon_core_tpu/planning/trafficsim.py``.

The planner's closed loop is only a reproducible claim if the load that
exercises it is reproducible, so this module generates the entire
workload of a serving fleet — arrival times, tenants, prompts,
deadlines — from ONE integer seed and nothing else:

* **Arrivals** are a Markov-modulated Gamma renewal process riding a
  diurnal sinusoid: the base rate swings ``diurnal_amplitude`` over
  ``diurnal_period_s``, a two-state (calm/burst) Markov chain multiplies
  it by ``burst_mult`` during bursts, and inter-arrival gaps draw from
  ``Gamma(shape, 1/(rate*shape))`` — shape < 1 gives the heavy-tailed
  clumping real traffic has; shape = 1 degrades to Poisson.
* **Tenants** follow a Zipf mix (rank ``r`` with weight ``1/r^s``) —
  a few hot tenants and a long tail, the shape multi-tenant SLO
  isolation has to survive.
* **Prompts** come from prefix-sharing families: each family owns a
  seeded shared prefix (the "system prompt" of one app) plus a
  per-request suffix, so prefix-cache hit rates are realistic and
  deterministic. Hot families follow their own Zipf rank.
* **Deadlines** are log-uniform between bounds, so some requests are
  always near the shed boundary.

Everything derives from ``random.Random(seed)`` — the same seed yields
the byte-identical trace on every run (asserted by
tests/test_planning.py), which is what lets modelbench's
``llm_1b_storm`` gate planner convergence instead of anecdotes.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple


@dataclasses.dataclass
class TrafficEvent:
    """One arriving request, fully determined by the trace seed."""

    t: float                       # arrival offset from trace start, seconds
    tenant: str
    family: int                    # prompt-family id (prefix-sharing group)
    prompt: List[int]
    max_new_tokens: int
    deadline_s: Optional[float]
    slo: str = "standard"


class TrafficSim:
    """Seeded trace generator; see module docstring for the processes."""

    def __init__(
        self,
        seed: int,
        duration_s: float = 60.0,
        base_rps: float = 10.0,
        diurnal_amplitude: float = 0.6,
        diurnal_period_s: float = 240.0,
        burst_mult: float = 4.0,
        burst_on_prob: float = 0.05,
        burst_off_prob: float = 0.35,
        gamma_shape: float = 0.7,
        tenants: int = 8,
        zipf_s: float = 1.1,
        prompt_families: int = 12,
        prefix_len: int = 24,
        suffix_len: Tuple[int, int] = (4, 48),
        vocab: int = 32000,
        max_new_tokens: Tuple[int, int] = (8, 64),
        deadline_s: Optional[Tuple[float, float]] = (0.5, 8.0),
        deadline_frac: float = 0.5,
    ):
        if duration_s <= 0 or base_rps <= 0:
            raise ValueError("duration_s and base_rps must be > 0")
        if not (0.0 <= diurnal_amplitude < 1.0):
            raise ValueError("diurnal_amplitude must be in [0, 1)")
        if gamma_shape <= 0:
            raise ValueError("gamma_shape must be > 0")
        if tenants < 1 or prompt_families < 1:
            raise ValueError("need >= 1 tenant and >= 1 prompt family")
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.base_rps = float(base_rps)
        self.diurnal_amplitude = float(diurnal_amplitude)
        self.diurnal_period_s = float(diurnal_period_s)
        self.burst_mult = float(burst_mult)
        self.burst_on_prob = float(burst_on_prob)
        self.burst_off_prob = float(burst_off_prob)
        self.gamma_shape = float(gamma_shape)
        self.n_tenants = int(tenants)
        self.zipf_s = float(zipf_s)
        self.n_families = int(prompt_families)
        self.prefix_len = int(prefix_len)
        self.suffix_len = (int(suffix_len[0]), int(suffix_len[1]))
        self.vocab = int(vocab)
        self.max_new = (int(max_new_tokens[0]), int(max_new_tokens[1]))
        self.deadline_bounds = (
            (float(deadline_s[0]), float(deadline_s[1]))
            if deadline_s is not None else None
        )
        self.deadline_frac = float(deadline_frac)
        # Zipf cumulative weights for tenants and prompt families
        self._tenant_cdf = self._zipf_cdf(self.n_tenants, self.zipf_s)
        self._family_cdf = self._zipf_cdf(self.n_families, self.zipf_s)
        # family prefixes derive from the trace seed alone, not from the
        # arrival stream's rng position — an arrival-knob change must
        # not reshuffle every family's shared prefix
        self._prefixes = [
            [
                random.Random(f"{self.seed}:family:{f}").randrange(
                    1, self.vocab
                )
                for _ in range(self.prefix_len)
            ]
            for f in range(self.n_families)
        ]

    @staticmethod
    def _zipf_cdf(n: int, s: float) -> List[float]:
        weights = [1.0 / (r ** s) for r in range(1, n + 1)]
        total = sum(weights)
        acc, cdf = 0.0, []
        for w in weights:
            acc += w / total
            cdf.append(acc)
        cdf[-1] = 1.0
        return cdf

    @staticmethod
    def _pick(cdf: List[float], u: float) -> int:
        for i, c in enumerate(cdf):
            if u <= c:
                return i
        return len(cdf) - 1

    def rate_at(self, t: float, bursting: bool) -> float:
        """Instantaneous arrival rate: diurnal sinusoid x burst state."""
        diurnal = 1.0 + self.diurnal_amplitude * math.sin(
            2.0 * math.pi * t / self.diurnal_period_s
        )
        rate = self.base_rps * max(1e-6, diurnal)
        return rate * (self.burst_mult if bursting else 1.0)

    def events(self) -> Iterator[TrafficEvent]:
        """The deterministic event stream, in arrival order."""
        rng = random.Random(self.seed)
        t = 0.0
        bursting = False
        while True:
            rate = self.rate_at(t, bursting)
            # Gamma renewal gap with mean 1/rate (shape-scale form)
            gap = rng.gammavariate(self.gamma_shape, 1.0 / (rate * self.gamma_shape))
            t += gap
            if t >= self.duration_s:
                return
            # two-state Markov chain steps once per arrival
            if bursting:
                if rng.random() < self.burst_off_prob:
                    bursting = False
            elif rng.random() < self.burst_on_prob:
                bursting = True
            tenant = self._pick(self._tenant_cdf, rng.random())
            family = self._pick(self._family_cdf, rng.random())
            suffix_n = rng.randint(*self.suffix_len)
            prompt = list(self._prefixes[family]) + [
                rng.randrange(1, self.vocab) for _ in range(suffix_n)
            ]
            deadline = None
            if self.deadline_bounds is not None and rng.random() < self.deadline_frac:
                lo, hi = self.deadline_bounds
                # log-uniform: most deadlines loose, a steady trickle tight
                deadline = math.exp(
                    rng.uniform(math.log(lo), math.log(hi))
                )
            yield TrafficEvent(
                t=round(t, 6),
                tenant=f"tenant-{tenant}",
                family=family,
                prompt=prompt,
                max_new_tokens=rng.randint(*self.max_new),
                deadline_s=round(deadline, 6) if deadline is not None else None,
            )

    def trace(self, max_events: Optional[int] = None) -> List[TrafficEvent]:
        out: List[TrafficEvent] = []
        for ev in self.events():
            out.append(ev)
            if max_events is not None and len(out) >= max_events:
                break
        return out

    def summary(self, trace: Optional[List[TrafficEvent]] = None) -> Dict[str, Any]:
        """Aggregate shape of a trace (modelbench scenario text)."""
        trace = self.trace() if trace is None else trace
        if not trace:
            return {"events": 0}
        per_tenant: Dict[str, int] = {}
        for ev in trace:
            per_tenant[ev.tenant] = per_tenant.get(ev.tenant, 0) + 1
        span = max(ev.t for ev in trace) or 1.0
        return {
            "events": len(trace),
            "span_s": round(span, 3),
            "mean_rps": round(len(trace) / span, 3),
            "tenants": len(per_tenant),
            "hottest_tenant_frac": round(max(per_tenant.values()) / len(trace), 4),
            "prompt_tokens": sum(len(ev.prompt) for ev in trace),
            "deadline_frac": round(
                sum(1 for ev in trace if ev.deadline_s is not None) / len(trace), 4
            ),
        }


def replay(
    trace: List[TrafficEvent],
    submit: Callable[[TrafficEvent], Any],
    time_scale: float = 0.0,
    clock: Optional[Callable[[], float]] = None,
    sleep: Optional[Callable[[float], None]] = None,
) -> List[Any]:
    """Feed a trace into ``submit`` (one handle per event, returned in
    trace order). ``time_scale`` 0 replays as fast as the engine admits
    (offline sweep); > 0 paces arrivals at ``trace_time * time_scale``
    (1.0 = real time) so burst clumps actually contend."""
    handles: List[Any] = []
    if time_scale > 0:
        import time as _time

        clock = clock or _time.monotonic
        sleep = sleep or _time.sleep
        t0 = clock()
        for ev in trace:
            due = t0 + ev.t * time_scale
            delay = due - clock()
            if delay > 0:
                sleep(delay)
            handles.append(submit(ev))
    else:
        for ev in trace:
            handles.append(submit(ev))
    return handles
