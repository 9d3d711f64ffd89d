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

Pressure faults: a top-level ``pressure`` section shrinks the continuous
batcher's HBM ledger budget mid-run, driving the real reclaim ladder
(prefix eviction, lane preemption and recompute-resume, admission
sheds): ``{"pressure": {"shrink_to_bytes": 65536, "after_polls": 20,
"restore_after_polls": 100}}`` -- on the Nth *working* poll (polls with
live lanes or queued work, so the shrink lands relative to traffic) the
budget drops to ``shrink_to_bytes``; ``restore_after_polls`` working
polls later (optional) the boot budget is restored.

KV-transport faults (the disaggregated path's chaos harness): a rule
whose ``unit`` is ``"*"``, ``"kv:*"``, ``"kv:<addr>"`` or ``<addr>`` (a
prefill peer's ``host:port`` or loopback label) perturbs that peer's
transfers: ``kv_connect_refused_rate``, ``kv_stall_rate`` with
``kv_stall_ms`` (before the dial), and ``kv_corrupt_rate``,
``kv_truncate_rate``, ``kv_drop_rate`` (in the raw byte stream, so the
codec's own typed refusal is what recovery sees). Each peer draws from
its own seeded stream, the JAX package's draw for draw.

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
import threading
import time
from typing import Dict, List, Optional, Tuple


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
    # KV-transport faults (see the module docstring)
    kv_connect_refused_rate: float = 0.0
    kv_corrupt_rate: float = 0.0
    kv_truncate_rate: float = 0.0
    kv_drop_rate: float = 0.0
    kv_stall_rate: float = 0.0
    kv_stall_ms: float = 0.0

    KV_FIELDS = (
        "kv_connect_refused_rate", "kv_corrupt_rate", "kv_truncate_rate",
        "kv_drop_rate", "kv_stall_rate",
    )

    def matches(self, unit: str, method: str) -> bool:
        return self.unit in ("*", unit) and self.method in ("*", method)

    def has_kv_faults(self) -> bool:
        return any(getattr(self, f) for f in self.KV_FIELDS)

    def matches_peer(self, addr: str) -> bool:
        return self.unit in ("*", "kv:*", f"kv:{addr}", addr)


class FaultInjector:
    def __init__(self, rules, seed: int = 0, scheduler=None, pressure=None):
        self.seed = int(seed)
        self.rules: List[FaultRule] = [
            r if isinstance(r, FaultRule) else FaultRule(**r) for r in rules
        ]
        # scheduler-level induced poll death: {"die_after_polls": N,
        # "times": M} — wired onto ContinuousBatcher.fault_hook
        self.scheduler = dict(scheduler or {})
        # HBM-ledger shrink window: {"shrink_to_bytes": B, "after_polls":
        # N, "restore_after_polls": M} — wired onto
        # ContinuousBatcher.pressure_hook
        self.pressure = dict(pressure or {})
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

    def kv_faults_for(self, addr: str) -> Optional["KVFaults"]:
        """Per-peer KV-transport fault hook for ``addr`` (``host:port``
        or a loopback label), or None when no kv rule targets it. Each
        peer gets its own seeded stream so a schedule is reproducible
        regardless of which peers a decode pool dials."""
        rules = [r for r in self.rules if r.has_kv_faults() and r.matches_peer(addr)]
        if not rules:
            return None
        return KVFaults(rules, self.seed, addr)

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

    def pressure_hook(self):
        """Ledger re-budget hook for ContinuousBatcher.pressure_hook, or
        None when no pressure section is configured. Returns the new
        budget (``shrink_to_bytes``) on the configured working poll,
        ``-1`` (restore the boot budget) ``restore_after_polls`` polls
        later, and None in between."""
        shrink = int(self.pressure.get("shrink_to_bytes", 0) or 0)
        after = int(self.pressure.get("after_polls", 0) or 0)
        if shrink <= 0 or after <= 0:
            return None
        restore = self.pressure.get("restore_after_polls")
        state = {"fired_at": None, "restored": False}

        def hook(poll_count: int):
            if state["fired_at"] is None:
                if poll_count >= after:
                    state["fired_at"] = poll_count
                    return shrink
                return None
            if (restore is not None and not state["restored"]
                    and poll_count - state["fired_at"] >= int(restore)):
                state["restored"] = True
                return -1
            return None

        return hook


class KVFaults:
    """Deterministic byte-level faults for ONE KV-transport peer.

    The transports call :meth:`before_connect` ahead of dialing (refuse /
    stall live here) and wrap their ``recv``-style reader with
    :meth:`wrap_read`, which draws a per-transfer fault plan (corrupt /
    truncate / drop at a drawn byte offset) from the peer's seeded
    stream. Faults land in the RAW byte stream, so what recovery
    exercises is the genuine codec refusal -- ChecksumError,
    TruncatedStream, a framing-shift DisaggError -- not a synthetic
    exception."""

    def __init__(self, rules: List[FaultRule], seed: int, addr: str):
        self.rules = rules
        self.addr = addr
        self._rng = random.Random(f"{seed}/kv/{addr}")
        self._lock = threading.Lock()
        self.injected = {
            "connect_refused": 0, "corrupt": 0, "truncate": 0,
            "drop": 0, "stalls": 0,
        }

    def _draw(self) -> float:
        with self._lock:
            return self._rng.random()

    def _offset(self, lo: int, hi: int) -> int:
        with self._lock:
            return self._rng.randrange(lo, hi)

    def connectable(self) -> bool:
        """Probe-path view of connect faults: a peer whose connections
        are being refused must also probe unhealthy, or the failover
        layer would readmit it just to eject it again."""
        for r in self.rules:
            if r.kv_connect_refused_rate and self._draw() < r.kv_connect_refused_rate:
                return False
        return True

    def before_connect(self) -> None:
        for r in self.rules:
            if r.kv_connect_refused_rate and self._draw() < r.kv_connect_refused_rate:
                self.injected["connect_refused"] += 1
                raise ConnectionRefusedError(f"injected: kv connect refused ({self.addr})")
            if r.kv_stall_rate and self._draw() < r.kv_stall_rate:
                self.injected["stalls"] += 1
                time.sleep(max(0.0, r.kv_stall_ms) / 1000.0)

    def wrap_read(self, read):
        """Wrap a ``recv``-style reader with this transfer's drawn fault
        plan; returns ``read`` unchanged when no byte fault fires (zero
        overhead off the fault path). Offsets are drawn small enough to
        land inside any real slab stream (the header alone is ~300
        bytes)."""
        corrupt_at = truncate_at = drop_at = None
        for r in self.rules:
            if corrupt_at is None and r.kv_corrupt_rate and self._draw() < r.kv_corrupt_rate:
                corrupt_at = self._offset(32, 2048)
            if truncate_at is None and r.kv_truncate_rate and self._draw() < r.kv_truncate_rate:
                truncate_at = self._offset(32, 4096)
            if drop_at is None and r.kv_drop_rate and self._draw() < r.kv_drop_rate:
                drop_at = self._offset(32, 2048)
        if corrupt_at is None and truncate_at is None and drop_at is None:
            return read
        state = {"seen": 0, "corrupted": False, "dropped": False, "truncated": False}

        def faulty(n: int) -> bytes:
            if truncate_at is not None and state["seen"] >= truncate_at:
                if not state["truncated"]:
                    state["truncated"] = True
                    self.injected["truncate"] += 1
                return b""
            b = read(n)
            if not b:
                return b
            start = state["seen"]
            state["seen"] += len(b)
            if (corrupt_at is not None and not state["corrupted"]
                    and start <= corrupt_at < state["seen"]):
                state["corrupted"] = True
                self.injected["corrupt"] += 1
                buf = bytearray(b)
                buf[corrupt_at - start] ^= 0xFF
                b = bytes(buf)
            if (drop_at is not None and not state["dropped"]
                    and start <= drop_at < state["seen"]):
                # drop up to 64 bytes mid-stream: every later frame
                # misaligns, so the codec refuses on length/CRC
                state["dropped"] = True
                self.injected["drop"] += 1
                at = drop_at - start
                b = b[:at] + b[at + 64:]
                state["seen"] = start + len(b)
            return b

        return faulty


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
