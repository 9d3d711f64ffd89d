"""Per-request deadline budgets (counterpart of
``seldon_core_tpu/resilience/deadline.py``).

The reference delegated timeouts to Istio sidecar route rules
(reference: operator/.../seldondeployment_istio.go timeout fields); with
no sidecar, the data plane owns the budget itself. A request carries ONE
deadline (header ``Seldon-Deadline-Ms``, or the predictor-wide
``seldon.io/deadline-ms`` annotation default); every hop is clamped to
what is LEFT of it, so a slow upstream hop cannot spend the whole budget
and leave downstream units doing work nobody will wait for (InferLine,
arxiv 1812.01776: pipeline SLOs are set by the worst hop).

The deadline is stored as an absolute monotonic expiry — "decrementing
across hops" falls out of reading the clock, with no mutation to thread
through the concurrent graph walk. In-process hops additionally see the
remaining budget as a relative ``deadlineMs`` in their message meta
(components like the generate server shed on it); remote hops get the
budget enforced as their clamped call timeout — the wire Meta proto
carries no deadline field.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

# http_server lower-cases header keys at parse time
DEADLINE_HEADER = "seldon-deadline-ms"
ANNOTATION_DEADLINE_MS = "seldon.io/deadline-ms"
# relative remaining-budget key stamped into message meta at each hop
META_DEADLINE_KEY = "deadlineMs"


class DeadlineExceeded(Exception):
    """The request's budget ran out mid-graph. ``status`` lets the
    executor map it onto the wire as a 504 without importing this module
    at its error boundary."""

    status = 504


class Deadline:
    __slots__ = ("expires_at",)

    def __init__(self, budget_s: float, now: Optional[float] = None):
        self.expires_at = (time.monotonic() if now is None else now) + float(budget_s)

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls(float(ms) / 1000.0)

    def remaining(self) -> float:
        """Seconds left, floored at 0."""
        return max(0.0, self.expires_at - time.monotonic())

    def remaining_ms(self) -> int:
        return int(self.remaining() * 1000.0)

    def expired(self) -> bool:
        return time.monotonic() >= self.expires_at


def deadline_from_request(
    headers: Optional[Dict[str, str]],
    annotations: Optional[Dict[str, str]] = None,
) -> Optional[Deadline]:
    """Header wins over the annotation default; junk values are ignored
    (a malformed client header must not fail the request)."""
    for source in (
        (headers or {}).get(DEADLINE_HEADER),
        (annotations or {}).get(ANNOTATION_DEADLINE_MS),
    ):
        if source is None:
            continue
        try:
            ms = float(source)
        except (TypeError, ValueError):
            continue
        if ms > 0:
            return Deadline.after_ms(ms)
    return None


def stamp_meta(message: Dict, deadline: Optional[Deadline]) -> Dict:
    """Shallow-copy ``message`` with the remaining budget in its meta, so
    the deadline propagates through serialization to remote units (and to
    in-process components via their ``meta`` argument)."""
    if deadline is None:
        return message
    out = dict(message)
    meta = dict(out.get("meta") or {})
    meta[META_DEADLINE_KEY] = deadline.remaining_ms()
    out["meta"] = meta
    return out


def deadline_s_from_meta(meta) -> Optional[float]:
    """Remaining budget in seconds from a message meta dict, or None."""
    if not isinstance(meta, dict):
        return None
    try:
        return max(0.0, float(meta[META_DEADLINE_KEY]) / 1000.0)
    except (KeyError, TypeError, ValueError):
        return None
