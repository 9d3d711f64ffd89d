"""The benchmark's arithmetic over client records: percentiles and rates.

``percentile`` is the load tester's nearest-rank rule, frozen here
(``seldon_core_tpu_torch/loadtester.py`` ``aggregate``: the value at
index ``min(n - 1, int(n * p / 100))`` of the sorted sample), so a later
change to the program cannot move the yardstick. A failed request is a
sample at +infinity: it misses every latency limit and is never a fast
sample.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional


def percentile(values: Iterable[float], p: float) -> Optional[float]:
    """Nearest-rank percentile ``p`` (0-100) of ``values``; None if empty."""
    xs: List[float] = sorted(values)
    n = len(xs)
    if not n:
        return None
    return xs[min(n - 1, int(n * p / 100.0))]


def ttfts_ms(records) -> List[float]:
    """Time to first token of every request sent, from when it was due:
    +inf for a request that failed or produced no token."""
    out = []
    for r in records:
        if r.get("error") or not r.get("spans"):
            out.append(math.inf)
        else:
            out.append((r["spans"][0][0] - r["due"]) * 1e3)
    return out


def tpots_ms(records) -> List[float]:
    """Time per output token after the first, (last - first) / (n - 1),
    of every request that asked for two tokens or more: +inf for one that
    failed."""
    out = []
    for r in records:
        if r.get("error"):
            out.append(math.inf)
            continue
        spans = r["spans"]
        n = sum(c for _t, c in spans)
        if n < 2:
            continue
        out.append((spans[-1][0] - spans[0][0]) * 1e3 / (n - 1))
    return out


def tokens_in(records, t0: float, t1: float) -> int:
    """Output tokens that arrived at a client inside [t0, t1]."""
    return sum(c for r in records for t, c in r["spans"] if t0 <= t <= t1)


def answered_in(records, t0: float, t1: float) -> List[dict]:
    """Predict requests answered inside [t0, t1]."""
    return [r for r in records if not r.get("error") and r.get("done") is not None
            and t0 <= r["done"] <= t1]


def latencies_ms(records) -> List[float]:
    """Predict latency of every request sent, from when it was due: +inf
    for one that failed."""
    return [math.inf if r.get("error") or r.get("done") is None
            else (r["done"] - r["due"]) * 1e3 for r in records]
