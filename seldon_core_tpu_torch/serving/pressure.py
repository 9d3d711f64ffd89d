"""HBM-pressure management: the unified ledger and its watermark
controller (the port's own copy of ``seldon_core_tpu/serving/pressure.py``;
it imports nothing of the JAX package).

A burst of long generations grows the live decode footprint (deepening
attention buckets), staging slabs pile up behind chunked admissions, and
the radix prefix cache sits on its byte budget. Without a ledger the
only levers are a shed at admission or a wedge. The
:class:`PressureController` tracks one **unified HBM ledger** over the
components the continuous batcher grows at run time:

* ``decode`` -- the *live* decode-cache footprint: each active lane
  priced at its current attention-read bucket times the per-token K/V
  byte cost. The allocation itself never changes, but the bytes every
  burst touches -- and the bytes a reclaim can win back -- follow the
  live prefix, so the ledger prices lanes the way the reclaim ladder can
  free them.
* ``staging`` -- chunked-prefill staging slabs held by pending
  long-prompt admissions.
* ``prefix`` -- the radix prefix cache's published slab bytes.

Two watermarks with hysteresis: crossing ``high`` *latches* pressure
(``active = True``) and the batcher starts the **reclaim ladder**
(evict prefixes -> cancel speculation -> preempt lanes -> shed
admissions -- see ``ContinuousBatcher._reclaim``); dropping back to
``low`` clears it and admissions resume. The gap between the watermarks
is the thrash guard: a resumed lane must fit inside it or it would
re-trip pressure on admission.

``budget_bytes == 0`` disables the whole subsystem -- the scheduler loop
then never consults the controller. The chaos harness shrinks the budget
mid-run (the ``SELDON_FAULTS`` ``pressure`` section) to drive the ladder
under test.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["PressureController", "PressureRefused"]


class PressureRefused(RuntimeError):
    """A decode pool refused a remote admit because its HBM ledger is
    over the high watermark (``ContinuousBatcher.admit_remote`` and the
    decode role's pre-handoff shed check raise it). Typed and carrying ``retry_after_s`` so the refusal
    pushes back to the prefill/caller side like the shed contract: the
    engine maps it to **503 + Retry-After** and clients back off instead
    of re-shipping slabs at a pool that cannot splice them."""

    status = 503

    def __init__(self, info: str, retry_after_s: float = 1.0):
        super().__init__(info)
        self.info = info
        self.retry_after_s = float(retry_after_s)


class PressureController:
    """Unified HBM ledger with high/low watermark hysteresis.

    Host-side bookkeeping only: ``update()`` is a handful of integer
    adds per scheduler poll (and is skipped entirely at ``budget == 0``).
    All fields are plain ints/bools written by the scheduler thread;
    concurrent readers (metrics export, ``_shed_check`` on submitting
    threads) see torn-but-harmless values — a one-poll-stale ``active``
    flag only shifts *when* a shed lands, never correctness.
    """

    def __init__(
        self,
        budget_bytes: int = 0,
        high: float = 0.90,
        low: float = 0.75,
    ):
        high = float(high)
        low = float(low)
        if not (0.0 < high <= 1.0):
            raise ValueError(f"pressure high watermark {high} not in (0, 1]")
        if not (0.0 < low <= high):
            raise ValueError(
                f"pressure low watermark {low} must be in (0, high={high}]"
            )
        self.budget_bytes = max(0, int(budget_bytes))
        # the boot-time budget: the chaos harness restores to this after
        # a shrink window (FaultInjector.pressure_hook's -1 sentinel)
        self.base_budget_bytes = self.budget_bytes
        self.high_frac = high
        self.low_frac = low
        self.used = 0
        self.components: Dict[str, int] = {}
        self.active = False
        # host KV tier occupancy: reported beside the ledger, never
        # counted in it (host RAM is not device memory -- counting it
        # would double-bill every demotion)
        self.host_bytes = 0
        self.stats = {
            "updates": 0,
            "activations": 0,
            "budget_changes": 0,
        }

    # -- watermarks ---------------------------------------------------------

    @property
    def high_bytes(self) -> int:
        return int(self.budget_bytes * self.high_frac)

    @property
    def low_bytes(self) -> int:
        return int(self.budget_bytes * self.low_frac)

    def set_budget(self, budget_bytes: int) -> None:
        """Re-budget the ledger live (the chaos harness's mid-run shrink;
        also an operator lever when a co-tenant needs HBM back). The next
        ``update()`` re-evaluates the watermarks against the new
        budget."""
        self.budget_bytes = max(0, int(budget_bytes))
        self.stats["budget_changes"] += 1

    def restore_budget(self) -> None:
        self.set_budget(self.base_budget_bytes)

    # -- accounting ---------------------------------------------------------

    def update(self, components: Dict[str, int]) -> bool:
        """Refresh the ledger from a fresh component breakdown and
        re-evaluate the watermark latch. Returns the (possibly new)
        ``active`` state."""
        self.components = components
        self.used = sum(components.values())
        self.stats["updates"] += 1
        if self.budget_bytes <= 0:
            self.active = False
        elif self.used >= self.high_bytes:
            if not self.active:
                self.stats["activations"] += 1
            self.active = True
        elif self.used <= self.low_bytes:
            self.active = False
        return self.active

    def overshoot_bytes(self) -> int:
        """Bytes above the LOW watermark — what the reclaim ladder must
        win back before pressure clears (0 when under it)."""
        return max(0, self.used - self.low_bytes)

    def retry_after_s(self) -> float:
        """Backoff hint for pressure sheds/refusals: scale with how far
        over budget the ledger is (bounded — a hint, not a promise)."""
        if self.budget_bytes <= 0 or not self.active:
            return 1.0
        over = self.used / max(1, self.high_bytes)
        return min(10.0, max(1.0, over))

    def summary(self) -> Dict[str, Any]:
        """JSON-shaped snapshot for metrics and diagnostics."""
        return {
            "budget_bytes": self.budget_bytes,
            "used_bytes": self.used,
            "high_bytes": self.high_bytes,
            "low_bytes": self.low_bytes,
            "active": self.active,
            "components": dict(self.components),
            "activations": self.stats["activations"],
            "budget_changes": self.stats["budget_changes"],
            "host_tier_bytes": self.host_bytes,
        }
