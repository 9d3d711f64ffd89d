"""Thread-role contracts: which thread may run which method.

The continuous batcher's correctness rests on a single ownership rule:
**device decode state (KV cache, lane registers, PRNG streams) is
mutated on the scheduler thread only**; request-worker ("caller")
threads hand work over exclusively through the admit queue (a remote
slab, too, is uploaded by the scheduler thread in this package). The
rule is declared:

* ``@scheduler_only`` — the method mutates scheduler-owned state and
  must run on the batcher's scheduler thread (``self._thread``).
* ``@caller_thread`` — the method is a caller-facing entry point and
  must NEVER run on the scheduler thread (it blocks on scheduler
  progress — running it there deadlocks the loop).

Two enforcement layers consume the declarations:

* The ``thread-role`` static rule (:mod:`.threads`) verifies by
  call-graph reachability that no ``@caller_thread`` entry point reaches
  a ``@scheduler_only`` method — the admit-queue handoff is invisible to
  the call graph, so it is the only legal path.
* With ``SELDON_DEBUG_THREADS=1`` in the environment (read once at
  import — the test run sets it), the
  decorators wrap each method with an executing-thread assertion, so a
  role violation fails loudly in tests instead of corrupting device
  state. Without the env var the decorators only tag the function
  (``__seldon_role__``) and return it unchanged — zero runtime cost on
  the hot path.

The scheduler thread is discovered per instance: ``self._thread`` (the
batcher), falling back to ``self.batcher._thread`` (the generate
server). A method whose object has no live scheduler thread yet — e.g.
``_alloc_device_state`` from the constructor, before ``start()`` — is
exempt: roles constrain *which* thread, not *whether* one exists.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Callable, Optional, TypeVar

F = TypeVar("F", bound=Callable)

__all__ = [
    "ThreadRoleViolation",
    "caller_thread",
    "debug_threads_enabled",
    "scheduler_only",
]


class ThreadRoleViolation(AssertionError):
    """A method executed on a thread its declared role forbids.

    An ``AssertionError`` subclass on purpose: a violation is a
    programming error in the serving stack, never an operational
    condition to retry — tests must fail, not recover.
    """


def _env_enabled() -> bool:
    return os.environ.get("SELDON_DEBUG_THREADS", "").strip().lower() in (
        "1", "true", "yes", "on",
    )


_DEBUG = _env_enabled()


def debug_threads_enabled() -> bool:
    """Whether runtime role assertions are active (decided at import)."""
    return _DEBUG


def _scheduler_thread(obj) -> Optional[threading.Thread]:
    """The scheduler thread governing ``obj``, if one is running."""
    t = getattr(obj, "_thread", None)
    if isinstance(t, threading.Thread):
        return t
    batcher = getattr(obj, "batcher", None)
    if batcher is not None:
        t = getattr(batcher, "_thread", None)
        if isinstance(t, threading.Thread):
            return t
    return None


def _check(obj, role: str, qualname: str) -> None:
    sched = _scheduler_thread(obj)
    if sched is None or not sched.is_alive():
        return  # no scheduler running: init-time / test-harness calls
    cur = threading.current_thread()
    if role == "scheduler" and cur is not sched:
        raise ThreadRoleViolation(
            f"{qualname} is @scheduler_only but ran on {cur.name!r} "
            f"while the scheduler thread {sched.name!r} is alive — "
            "device state may only be mutated by the scheduler; hand "
            "work over through the admit queue"
        )
    if role == "caller" and cur is sched:
        raise ThreadRoleViolation(
            f"{qualname} is @caller_thread but ran on the scheduler "
            f"thread {sched.name!r} — caller entry points block on "
            "scheduler progress and would deadlock the poll loop"
        )


def _role_decorator(role: str) -> Callable[[F], F]:
    def decorate(fn: F) -> F:
        fn.__seldon_role__ = role
        if not _DEBUG:
            return fn

        @functools.wraps(fn)
        def guarded(self, *args, **kwargs):
            _check(self, role, fn.__qualname__)
            return fn(self, *args, **kwargs)

        guarded.__seldon_role__ = role
        return guarded  # type: ignore[return-value]

    return decorate


#: The method mutates scheduler-owned device/lane state: it must run on
#: the batcher's scheduler thread (or before any scheduler exists).
scheduler_only = _role_decorator("scheduler")

#: The method is a caller-facing entry point: it must never run on the
#: scheduler thread.
caller_thread = _role_decorator("caller")
