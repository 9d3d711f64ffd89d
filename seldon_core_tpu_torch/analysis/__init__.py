"""seldon-lint for the PyTorch port: invariant-aware static analysis.

This package's own copy of the JAX package's analyzer (same rule ids,
suppression syntax and baseline format), with the device rules aimed at
PyTorch and CUDA graphs. The serving stack's correctness invariants —
device state is touched on the scheduler thread only, nothing blocks
under a lock in the hot loop, deadline math uses monotonic clocks, and
the ``seldon_engine_*`` metric / ``seldon.io/*`` annotation
vocabularies agree across the code that emits them, the registry that
maps them, and the docs that operators read — are machine-checked
contracts here.

Stdlib ``ast`` only — no new dependencies. Entry points:

* ``python -m seldon_core_tpu_torch.analysis <paths>`` — the CLI and
  gate (:mod:`.__main__`), with its baseline at
  ``seldon_core_tpu_torch/analysis/baseline.json``.
* :mod:`.roles` — ``@scheduler_only`` / ``@caller_thread`` thread-role
  decorators, statically verified by the ``thread-role`` rule and
  runtime-asserted under ``SELDON_DEBUG_THREADS=1``.
* :func:`.core.run_lint` — programmatic runner (used by the tests).

Rule catalog (ids are what ``# seldon-lint: disable=<rule>`` takes):

==================== ====================================================
``thread-role``      caller-thread entry points must not reach
                     scheduler-only device mutations through the call
                     graph (the admit queue is the only legal handoff)
``blocking-under-lock`` no sleeps, socket/queue waits, future results or
                     device syncs inside a ``with <lock>:`` body
``lock-order``       the cross-module lock acquisition graph must be
                     acyclic
``host-sync-hot-path`` no implicit host syncs (``.item()``, ``.cpu()``,
                     ``.tolist()``, ``.numpy()``, ``.to("cpu")``,
                     ``torch.cuda.synchronize``, ``int()`` on a forward's
                     result) in poll-loop-reachable code
``retrace-hazard``   no unbounded/unhashable Python values in the keys of
                     the CUDA graph caches (a graph captured per value)
``metric-drift``     ``seldon_engine_*`` series must agree across
                     engine_metrics maps, server emitters and docs
``annotation-drift`` ``seldon.io/*`` annotations parsed by the control
                     plane must match the documented tables
``wall-clock``       ``time.time()`` is reserved for named wall anchors;
                     interval/deadline/ordering math uses monotonic time
``parse-error``      a scanned file failed to parse
==================== ====================================================
"""

from .core import Finding, LintResult, load_baseline, run_lint, write_baseline
from .roles import (
    ThreadRoleViolation,
    caller_thread,
    debug_threads_enabled,
    scheduler_only,
)

__all__ = [
    "Finding",
    "LintResult",
    "ThreadRoleViolation",
    "caller_thread",
    "debug_threads_enabled",
    "load_baseline",
    "run_lint",
    "scheduler_only",
    "write_baseline",
]
