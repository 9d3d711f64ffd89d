#!/usr/bin/env python3
"""The device's idle time in a ``torch.profiler`` trace of the serving
port, by the scheduler's ``gen.*`` range that was open while it idled.

A trace taken through ``seldon_core_tpu_torch.tracing.start_device_profile``
while a batcher serves holds the device's kernels, copies and fills and
the scheduler thread's ``gen.*`` ranges (the poll's phases) on one
clock. This reads the trace's JSON (the ``.pt.trace.json`` the
TensorBoard handler writes) and prints one JSON object:

* ``window_s``: the first device operation's start to the last one's
  end; ``busy_s``: the union of the device's operations; ``idle_s``:
  the rest;
* ``idle_by_range``: the idle seconds by the innermost ``gen.*`` range
  of the scheduler thread (the thread whose ranges hold ``gen.poll``)
  open while the device idled, ``outside`` for idle time under none;
  ``in_gen_share``: the share of the idle time under some range;
* ``ranges_s``: each range's own seconds (its time less its children's).

    python tools/trace_gaps.py <trace.json, or the directory holding it>

``phases`` reads what the scheduler counts without a trace, from a
``/flightrecorder`` payload (or one unit's dump): by unit, the shares of
the scheduler thread's wall time by poll phase since the batcher started
(``stats["sched_s_<phase>"]``), the first token's hold in the recent
requests (``slo.hold_ms``) and the mean hold and TTFT since start
(``stats["hold_s_sum"]``, ``stats["ttft_s_sum"]``):

    curl -s localhost:8000/flightrecorder > fr.json
    python tools/trace_gaps.py phases fr.json
"""

from __future__ import annotations

import glob
import json
import os
import sys
from collections import defaultdict
from typing import Any, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> Dict[str, Any]:
    """A trace's JSON: the file, or the newest trace in a directory."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.pt.trace.json")), key=os.path.getmtime)
        if not files:
            raise FileNotFoundError(f"no .pt.trace.json under {path}")
        path = files[-1]
    with open(path) as f:
        return json.load(f)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def innermost(ranges: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """The nested ranges of one thread as disjoint segments, each named
    after the innermost range open over it."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []  # (end, name), outermost first
    cur = 0.0
    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            out.append((cur, end, top))
            cur = end
        if stack:
            out.append((cur, s, stack[-1][1]))
            e = min(e, stack[-1][0])
        stack.append((e, name))
        cur = s
    while stack:
        end, top = stack.pop()
        out.append((cur, end, top))
        cur = end
    return [seg for seg in out if seg[1] > seg[0]]


def _overlap(idle, segments) -> Dict[str, float]:
    """Seconds of ``idle`` under each segment's name (both sorted)."""
    by: Dict[str, float] = defaultdict(float)
    j = 0
    for a, b in idle:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s, e, name = segments[k]
            by[name] += max(0.0, min(b, e) - max(a, s))
            k += 1
    return by


def summarize(trace: Dict[str, Any]) -> Dict[str, Any]:
    events = trace["traceEvents"]
    dev, by_tid = [], defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        s = float(e["ts"])
        end = s + float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATS:
            dev.append((s, end))
        elif e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("gen."):
            by_tid[e["tid"]].append((s, end, e["name"]))
    polls = {tid: sum(1 for r in rs if r[2] == "gen.poll") for tid, rs in by_tid.items()}
    sched = max(polls, key=polls.get) if polls and max(polls.values()) else None
    segments = innermost(by_tid[sched]) if sched is not None else []
    own: Dict[str, float] = defaultdict(float)
    for s, e, name in segments:
        own[name] += (e - s) / 1e6
    out: Dict[str, Any] = {"scheduler_tid": sched, "ranges_s": dict(sorted(own.items())),
                           "window_s": None, "busy_s": None, "idle_s": None,
                           "idle_by_range": {}, "in_gen_share": None}
    busy = _union(dev)
    if not busy:
        return out
    idle = [(e0, s1) for (_s0, e0), (s1, _e1) in zip(busy, busy[1:]) if s1 > e0]
    idle_s = sum(b - a for a, b in idle) / 1e6
    by = {k: v / 1e6 for k, v in _overlap(idle, segments).items()}
    under = sum(by.values())
    by["outside"] = max(0.0, idle_s - under)
    out.update(window_s=(busy[-1][1] - busy[0][0]) / 1e6,
               busy_s=sum(b - a for a, b in busy) / 1e6, idle_s=idle_s,
               idle_by_range=dict(sorted(by.items(), key=lambda kv: -kv[1])),
               in_gen_share=under / idle_s if idle_s > 0 else None)
    return out


def phases(dump: Dict[str, Any]) -> Dict[str, Any]:
    """One unit's poll-phase shares and first-token hold."""
    stats = dump.get("stats") or {}
    by = {k[len("sched_s_"):]: v for k, v in stats.items() if k.startswith("sched_s_")}
    total = sum(by.values())
    n = stats.get("slo_samples") or 0
    return {
        "sched_s": total,
        "sched_share": {k: v / total for k, v in sorted(by.items(), key=lambda kv: -kv[1])}
        if total > 0 else {},
        "hold_ms": (dump.get("slo") or {}).get("hold_ms"),
        "mean_hold_ms": stats["hold_s_sum"] / n * 1e3 if n and "hold_s_sum" in stats else None,
        "mean_ttft_ms": stats.get("ttft_s_sum", 0.0) / n * 1e3 if n else None,
        "requests": n,
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "phases":
        with open(argv[1]) as f:
            payload = json.load(f)
        units = payload.get("units") or {"": payload}
        print(json.dumps({name: phases(d) for name, d in units.items() if "stats" in d}))
        return 0
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print(__doc__, file=sys.stderr)
        return 2
    print(json.dumps(summarize(load(argv[0]))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
