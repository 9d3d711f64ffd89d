"""A traced sub-window: ``torch.profiler`` over a few seconds of the run.

Only a run with ``--trace 1`` opens one, in the middle of its measured
window. Its events are read in memory (``kineto_results.events()``),
never written to disk. What it gives the per-layer readers:

* ``window_s``: the sub-window's length on the host clock, and ``t0``,
  ``t1``: its bounds on the monotonic clock the clients stamp with;
* ``busy_s``: the seconds in which a kernel, copy or fill ran on the
  device (the union of their intervals);
* ``kernels``: every launch of the program's flash kernel as ``(name,
  seconds)``;
* ``device_ops``: the ten device operations that took most time;
* ``idle_gaps``: the idle time between device operations, summed by what
  the host was doing when each gap began (the innermost profiler range,
  such as ``gen.prefill`` or ``gen.decode_burst``, open on the host at
  that moment, else the host operation, else ``host: untraced``), the
  ten largest.

On a machine without CUDA the sub-window traces the host only and
``busy_s`` is None: every device reader then finds nothing to read.
The harness reads the program's counters at the sub-window's start and
stop as well (``run.sub_before``, ``run.sub_after``).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple


class SubWindow:
    """``start()`` turns the profiler on and waits for the device to
    finish what was enqueued before; ``edge()`` waits again at the end;
    ``stop()`` turns it off and reads the events between the two waits.
    The program's counters read right after ``start()`` and ``edge()``
    bracket exactly the device work the summary covers.

    Create it before the system under test starts: a first profiler
    session then initialises the profiler alone, so that turning it on in
    the window is quick. Call ``stop()`` only once the system has stopped:
    the profiler's stop can deadlock with another thread launching CUDA
    graphs (seen on the card: the process hung in ``prof.stop()`` while the
    scheduler thread sat in ``CUDAGraph.replay``)."""

    def __init__(self):
        import torch

        self._torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        self.cuda = torch.cuda.is_available()
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts):
            if self.cuda:
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = None

    def _wait(self):
        if self.cuda:
            self._torch.cuda.synchronize()
        return time.monotonic(), time.time_ns()

    def start(self) -> None:
        self.prof.start()
        self.t0, self._a_ns = self._wait()

    def edge(self) -> None:
        self.t1, self._b_ns = self._wait()

    def stop(self) -> Dict[str, Any]:
        self.prof.stop()
        return summarize(self.prof.profiler.kineto_results.events(), self.t0, self.t1,
                         self.cuda, self._a_ns, self._b_ns)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(items, starts, t: int, back: int) -> Optional[str]:
    """The name of the latest-starting ``(start, end, name)`` of ``items``
    (sorted by start) open at ``t``, among the ``back`` latest to start
    at or before it."""
    j = bisect.bisect_right(starts, t)
    for hs, he, name in reversed(items[max(0, j - back):j]):
        if hs <= t < he:
            return name
    return None


def summarize(events, t0: float, t1: float, cuda: bool, a_ns: int, b_ns: int) -> Dict[str, Any]:
    """The events between ``a_ns`` and ``b_ns`` (the profiler's clock is
    the wall clock in ns): device work that started before ``a_ns`` was
    enqueued before the first wait and is left out."""
    device, host = [], []
    for ev in events:
        kind = str(ev.device_type()).split(".")[-1]
        start, dur = int(ev.start_ns()), int(ev.duration_ns())
        if start < a_ns or start > b_ns:
            continue
        if kind == "CUDA":
            # the device-side mirror of a host range is no device work
            if not ev.is_user_annotation():
                device.append((start, dur, ev.name()))
        elif dur > 0:
            host.append((start, start + dur, ev.name(), bool(ev.is_user_annotation())))
    out: Dict[str, Any] = {"t0": t0, "t1": t1, "window_s": t1 - t0, "busy_s": None,
                           "kernels": [], "device_ops": [], "idle_gaps": []}
    if not cuda or not device:
        return out
    spans = _union([(s, s + d) for s, d, _n in device])
    out["busy_s"] = sum(e - s for s, e in spans) / 1e9
    by_name: Dict[str, float] = defaultdict(float)
    for _s, d, name in device:
        by_name[name] += d / 1e9
        if "flash_fwd" in name:
            out["kernels"].append((name, d / 1e9))
    out["device_ops"] = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # each gap between device intervals, labelled by the innermost host
    # range open when it began: a profiler range (gen.prefill ...),
    # else a host operation
    ranges = sorted(h[:3] for h in host if h[3])
    ops = sorted(h[:3] for h in host if not h[3])
    range_starts = [h[0] for h in ranges]
    op_starts = [h[0] for h in ops]
    gaps: Dict[str, float] = defaultdict(float)
    for (_s0, e0), (s1, _e1) in zip(spans, spans[1:]):
        label = (_innermost(ranges, range_starts, e0, 64)
                 or _innermost(ops, op_starts, e0, 16) or "host: untraced")
        gaps[label] += (s1 - e0) / 1e9
    out["idle_gaps"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return out
