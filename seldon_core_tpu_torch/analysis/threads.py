"""``thread-role``: caller-thread entry points must not reach
scheduler-only device mutations through the call graph.

The legal handoff between the two roles is the admit queue
(``self._queue.put`` on the caller side, ``get_nowait`` in the poll
loop) — a data-flow edge the call graph deliberately does not follow.
Any *call-graph* path from a ``@caller_thread`` method to a
``@scheduler_only`` method therefore means caller code can execute a
device mutation on the wrong thread, racing the scheduler over donated
buffers.

The reverse direction is checked too: a ``@scheduler_only`` method
calling a ``@caller_thread`` entry point would have the poll loop block
on its own progress (``start()`` waits on ``_started``, ``generate()``
waits on a future the loop must resolve) — a deadlock, not a race.

Classes with no role declarations are skipped entirely: the rule rides
on declared intent, it does not guess.
"""

from __future__ import annotations

from typing import Iterable, List

from .callgraph import index_classes, reach_path
from .core import Finding, LintContext, SourceFile

__all__ = ["check_thread_roles"]


def _fmt_path(start: str, edges) -> str:
    return " -> ".join([start] + [callee for callee, _ in edges])


def check_thread_roles(
    files: List[SourceFile], ctx: LintContext
) -> Iterable[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if sf.tree is None:
            continue
        for cls in index_classes(sf.tree):
            sched = {n for n, m in cls.methods.items() if m.role == "scheduler"}
            callers = {n for n, m in cls.methods.items() if m.role == "caller"}
            if not sched or not callers:
                continue
            # undecorated methods and same-role methods are legal
            # intermediaries; only reaching the OPPOSITE role violates
            for entry in sorted(callers):
                through = set(cls.methods) - sched
                edges = reach_path(cls, entry, sched, through=through)
                if edges is not None:
                    callee, lineno = edges[-1]
                    findings.append(Finding(
                        "thread-role", sf.rel, lineno, 0,
                        f"caller-thread entry point '{entry}' reaches "
                        f"scheduler-only '{cls.name}.{callee}' via "
                        f"{_fmt_path(entry, edges)}; device state may only "
                        "be touched by the scheduler thread — hand off "
                        "through the admit queue",
                        sf.line_text(lineno),
                    ))
            for entry in sorted(sched):
                edges = reach_path(
                    cls, entry, callers,
                    through=set(cls.methods) - callers,
                )
                if edges is not None:
                    callee, lineno = edges[-1]
                    findings.append(Finding(
                        "thread-role", sf.rel, lineno, 0,
                        f"scheduler-only '{entry}' reaches caller-thread "
                        f"entry point '{cls.name}.{callee}' via "
                        f"{_fmt_path(entry, edges)}; caller entry points "
                        "block on scheduler progress — calling one from "
                        "the poll loop deadlocks it",
                        sf.line_text(lineno),
                    ))
    return findings
