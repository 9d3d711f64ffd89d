"""Graph-native resilience: deadline budgets, retries, circuit breakers,
hedged calls, load shedding, and deterministic fault injection.

Counterpart of ``seldon_core_tpu/resilience/`` (pure Python, copied so
the port imports nothing of the JAX package). Everything here is
annotation-gated and off by default: an unconfigured graph keeps its
exact clients and byte-identical outputs.

Wiring (see graph/executor.py): per unit,

    base transport client
      -> FaultyClient        (only when SELDON_FAULTS / faults= target it)
      -> ResilientClient     (only when retries/breaker/hedge configured)

with the per-request Deadline carried on RequestCtx and enforced as every
hop's call timeout, and load shedding at the engine's admission gate and
the continuous batcher's admit queue (shed-before-work).
"""

from .breaker import BreakerOpen, CircuitBreaker  # noqa: F401
from .deadline import (  # noqa: F401
    ANNOTATION_DEADLINE_MS,
    DEADLINE_HEADER,
    Deadline,
    DeadlineExceeded,
    deadline_from_request,
    deadline_s_from_meta,
    stamp_meta,
)
from .faults import (  # noqa: F401
    FaultInjector,
    FaultRule,
    FaultyClient,
    InjectedFault,
)
from .policy import (  # noqa: F401
    HedgePolicy,
    IDEMPOTENT_METHODS,
    ResilientClient,
    RetryPolicy,
    ShedError,
    is_retryable,
)
