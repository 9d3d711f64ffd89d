"""Continuous batching for ``generate()`` serving, in PyTorch.

Counterpart of ``seldon_core_tpu/serving/continuous.py``
(``ContinuousBatcher``), core scheduler only:

* A fixed pool of ``slots`` decode lanes over a per-layer KV cache
  ``[slots, KV, max_seq, Dh]`` that decode writes IN PLACE (the JAX
  package donates these buffers to its executables; here the tensors are
  simply mutated).
* New requests are admitted into free slots while older ones are
  mid-decode: prompts are right-padded to a prefill bucket, same-bucket
  admissions share one batched prefill (m in 8/4/1, as the JAX package),
  and each prefill slab ``[L, m, KV, bucket, Dh]`` is copied into its
  lanes.
* Decode runs in bursts of ``steps_per_poll`` (pow2-floored) ragged steps
  per poll; each lane samples with its own threefry key stream
  (``rng.sample_next``), split every step whether the lane is busy or
  not, so seeded tokens match the JAX package's bit for bit.
* The attention read is bounded by an ``attn_bucket`` multiple covering
  the deepest lane (host-tracked, no device sync).
* Bursts are software-pipelined: up to ``pipeline_depth`` bursts are in
  flight before the host reads the oldest one's tokens. On CUDA each
  burst's tokens start an asynchronous copy into pinned host memory
  with an event behind it; the host reads a burst when its event has
  fired, or blocks on the oldest when the pipeline is full.
* eos / ``max_new_tokens`` stop, cancellation, typed refusals
  (``PromptTooLong``, ``BudgetExceeded``, ``BatcherDead``), supervised
  restart after a loop death, and ``warm()`` before listening.
* Shed before work: ``submit`` refuses with ``ShedError`` (429 at the
  engine) when the admit queue is at ``admit_queue_limit`` or its
  expected wait (depth over the observed completion rate) outlives the
  request's ``deadline_s``; a request still queued or decoding past its
  deadline is cancelled and its lane freed.
* Fused stop-aware decode (``fused_steps_per_dispatch``): one dispatch
  runs up to K steps with on-device stop detection and per-lane done
  masks; K is the pow2 floor of the knob, shrunk toward the nearest
  lane's remaining budget but never below the poll burst.
* Depth groups (``depth_groups``): lanes split into sub-bursts by
  attention-read bucket when the modelled KV-read saving beats an extra
  param read (``depth_group_split_bytes`` overrides that price); a group
  gathers its lanes' cache prefix into a slab, decodes over it and
  scatters it back. One group is the whole-batch burst exactly.
* Chunked prefill (``prefill_chunk``): a prompt whose bucket is longer
  than one chunk reserves its lane and is prefilled one chunk per poll
  into a staging slab, interleaved with the decode bursts; the last
  chunk samples the first token and the slab goes through the ordinary
  lane insert.
* On CUDA every decode burst replays CUDA graphs: one graph per phase
  and key (the burst's start, ONE decode step replayed k times, and a
  group's gather and scatter), keyed by step kind, rows, attention
  bucket and sampling. ``warm()`` captures every key the declared
  traffic reaches; a key it missed is captured at first use and counted
  (``graph_captures_inline``, which also counts the spec graphs a
  rung-2 resume captures again over a moved draft cache). Every tensor
  a graph touches is a persistent buffer updated in place. On the CPU
  the same phase functions run eagerly.
* Radix prefix KV cache (``prefix_cache_hbm_bytes``): a finished
  request publishes its prompt's K/V (``[L, 1, KV, bucket, Dh]``, copied
  out of its lane) into a radix index over token IDs under an LRU byte
  budget; an admission whose prompt shares a cached prefix of at least
  ``prefix_cache_min_tokens`` splices the donor slab into its lane and
  prefills only the suffix (``DecoderLM.prefill_with_prefix``). A hit
  whose suffix is longer than one prefill chunk goes to chunking, its
  staging slab seeded with the donor up to the chunk grid.
* HBM pressure (``hbm_ledger_bytes``): a ledger of the live decode
  footprint, the staging slabs and the prefix cache against
  ``pressure_high``/``pressure_low`` watermarks. Over the high one the
  reclaim ladder runs at the poll boundary: evict prefix slabs, then
  preempt lanes (never the last one): a victim's emitted tokens and lane
  key are checkpointed on the host and it is requeued; its resume
  recomputes the prompt's K/V (a prefix hit splices as on admission),
  replays the emitted tokens' K/V teacher-forced through the decode step
  and continues the same sampling stream. While latched, admissions
  hold and submits are shed (``ShedError``, 429 at the engine).
* Speculative decoding (``draft_model``/``draft_params``,
  ``speculate_tokens`` = gamma): each round the draft proposes gamma
  tokens with gamma one-position steps over its own cache, and ONE
  target forward over the window (``decode_chunk_ragged_list``)
  verifies them; greedy lanes accept while the draft's argmax equals the
  target's, temperature lanes use speculative sampling (accept with
  ``min(1, p/q)``, resample the residual on rejection), so the output is
  the target's for any draft. A burst is ``steps_per_poll`` rounds over
  the whole batch (one CUDA graph per attention bucket and sampling
  variant on the card), admissions are single-request, and each lane's
  draft prefix is re-derived from its tokens (never cached or chunked).
  The fused plan degrades to the spec burst. Under HBM pressure, rung 2
  of the reclaim ladder cancels speculation (the draft cache is freed,
  lanes decode with the plain burst graphs) while every lane is greedy,
  holds sampled requests (greedy ones are still admitted), and restores
  it when the draft cache fits back under the high watermark.
* Disaggregated prefill/decode (``serving/disagg.py`` is the wire
  half): :meth:`ContinuousBatcher.export_prefill` runs a prompt's
  prefill (whole-prompt bucketed, or chunked through the staging slab)
  without the scheduler loop and returns the host slab plus the first
  token and lane key; :meth:`ContinuousBatcher.admit_remote` validates a
  shipped slab before any lane state exists and queues it as a remote
  lane insert (a full slab through the ordinary insert, a suffix-only
  slab over the local radix donor), so decode after a remote admit is
  the unified path's. Under pressure a remote admit is refused with
  ``PressureRefused`` (503 + Retry-After).
* Host KV tier (``host_kv_tier_bytes``, ``serving/kvtier.py``): reclaim
  rung 1 demotes prefix slabs to host RAM instead of dropping them, a
  device radix miss promotes a demoted prefix back, an export publishes
  its slab there for peers, and a preempted lane checkpoints its exact
  K/V columns so its resume is a copy-back insert (recompute and replay
  stay the fallback, counted in ``kv_tier_replay_fallbacks``).
* Live weight swap (:meth:`ContinuousBatcher.request_weight_swap`): the
  new params are cast, checked leaf for leaf against the served set
  (``DecoderLM.params_swappable``) and staged on the device next to it,
  the upload overlapping serving. Admissions then hold while in-flight
  lanes finish on the old weights; at the poll boundary where nothing is
  in flight the staged leaves are copied INTO the served tensors (the
  decode-burst CUDA graphs captured those addresses, so the pointers
  never move), ``weight_version`` bumps and the prefix cache and host
  tier purge by version. ``swap_drain_ms`` bounds the wait: past it the
  remaining lanes are checkpointed and resume on the new weights
  (``swap_resume_policy`` ``resume``) or fail typed (``fail``). Refused
  with speculation (an early-exit draft shares the served tensors).
* Graceful drain (:meth:`ContinuousBatcher.drain`, the wire half in
  ``serving/migration.py``): at a poll boundary every live lane is
  checkpointed (emitted tokens and lane key, no K/V), chunked
  admissions, the resume queue and the admit queue are collected, and
  the member refuses new work (``health = "draining"``, 503);
  :meth:`ContinuousBatcher.submit_checkpoint` admits such a checkpoint
  (or a client resume token) on another member through the recompute
  resume, the same stream token for token.
* Tenants (``serving/weightpager.py`` drives them): requests carry a
  tenant and SLO class; the victim policy preempts best-effort lanes
  first and spares a strict tenant's only lane, the SLO samples split
  per tenant, and the ledger bills the resident tenant's weights as its
  ``pager`` component (a staged swap's as ``swap``).
* Prefill, chunk and lane insert run inside ``tracing.device_trace``
  ranges (``gen.prefill``, ``gen.prefill_chunk``, ``gen.lane_insert``),
  decode bursts inside ``gen.decode_burst``, named in ``torch.profiler``
  traces.
* Flight recorder (``flight_recorder_capacity``, default 512, 0 = off,
  ``serving/flightrecorder.py``): one record per working poll (queue,
  lanes, admissions, chunks, the decode plan and the ledger's per-poll
  rows) and a typed record per scheduling event (shed, preemption and
  resume, reclaim, tier demote and promote, export, remote insert,
  swap, drain, retune, restart), in a bounded drop-oldest ring.
* Device-time ledger (``profiler``, a ``serving/profiler.py``
  ``DeviceTimeLedger``): every dispatch -- prefill, chunk, insert,
  splice, extract, decode/fused/group/spec burst, replay step, swap flip
  -- is timed (CUDA event pairs on the card, resolved without a
  synchronise) and attributed per ``(kind, variant, tenant)``, with its
  modelled read bytes (``DecoderLM.dispatch_read_bytes``).
* Live retune (:meth:`ContinuousBatcher.retune`): the knobs in
  ``RETUNABLE_KNOBS`` change at a poll boundary, refused typed
  (:class:`RetuneError`) outside what ``warm()`` prepared
  (:meth:`ContinuousBatcher.retune_census`), so a retune never captures
  a graph. The decode step kind (masked for fused decode, or plain) is
  fixed at construction: a fused member retuned to
  ``fused_steps_per_dispatch=0`` runs ``steps_per_poll``-step bursts of
  its masked step, the same tokens.

The mesh of the JAX batcher is not ported yet: its knobs raise when set
to anything but their off values.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import rng
from ..resilience import ShedError
from ..tracing import device_trace, wall_us
from .disagg import DisaggError, PrefixGone, WeightVersionMismatch, prompt_hash
from .flightrecorder import FlightRecorder
from .kvtier import HostKVTier
from .prefix_cache import RadixPrefixIndex
from .pressure import PressureController, PressureRefused
from .profiler import DeviceTimeLedger

logger = logging.getLogger(__name__)

# Scheduler knobs of the JAX batcher that this port does not implement
# yet, with the value that turns each off; any other value raises. They
# are the mesh (multi-device serving).
NOT_PORTED_KNOBS: Dict[str, Any] = {
    "mesh": None,
    "shard_cache_seq": False,
}


def check_not_ported(knobs: Dict[str, Any], owner: str) -> None:
    """Raise for a knob of an unported feature set to an enabling value,
    and for a knob this package does not know at all."""
    for name, value in knobs.items():
        if name not in NOT_PORTED_KNOBS:
            raise TypeError(f"{owner} got an unknown knob {name!r}")
        off = NOT_PORTED_KNOBS[name]
        if value == off:
            continue
        raise NotImplementedError(
            f"{owner}: {name}={value!r} is not ported to seldon_core_tpu_torch "
            f"yet (only its off value {off!r} is supported)"
        )


class MoEKnobRefused(ValueError):
    """A knob or path that a mixture-of-experts model cannot serve as the
    JAX package serves it. The experts' capacity counts every row of a
    call, so what a row emits depends on the rows beside it: speculation
    (the verify window holds the drafts, whose rows take capacity from
    the lane's real token) is refused for an MoE target or draft."""


class PromptTooLong(ValueError):
    """The request cannot fit the serving cache: the prompt exceeds every
    prefill bucket and ``max_seq``. Carries a 413 wire status."""

    status = 413


class BudgetExceeded(PromptTooLong):
    """``prompt_len + max_new_tokens > max_seq``: the generation would
    outgrow the decode cache. Rejected at submit with the 413 status."""


class RetuneError(ValueError):
    """A :meth:`ContinuousBatcher.retune` named a knob value outside the
    boot census (what ``warm()`` prepared), or an unknown or ill-typed
    knob. Raised on the caller's thread before anything is staged: a
    configuration ``warm()`` did not capture would capture graphs
    mid-traffic."""


class BatcherDead(RuntimeError):
    """The scheduler loop is not serving: it died, exhausted its
    crash-loop budget, or was closed. Carries the 503 wire status plus
    ``retry_after_s``."""

    status = 503

    def __init__(self, info: str, retry_after_s: float = 1.0):
        super().__init__(info)
        self.info = info
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass
class GenRequest:
    tokens: List[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    seed: int = 0
    future: Future = dataclasses.field(default_factory=Future)
    # streaming: called from the scheduler thread with each newly credited
    # span of tokens (must be cheap; exceptions are logged, never raised
    # into the decode loop)
    on_tokens: Optional[object] = None
    # prompt tokens served from the radix prefix cache at admit (0 = a
    # full prefill); responses report it per request
    cache_hit_tokens: int = 0
    # lifecycle timeline (monotonic seconds; 0.0 = not reached)
    submit_t: float = 0.0
    admit_t: float = 0.0
    first_tok_t: float = 0.0
    # wall-clock anchor of submit_t (epoch microseconds); a migrated
    # request keeps its first member's
    submit_wall_us: int = 0
    # absolute deadline (monotonic seconds) when the submit carried a
    # budget: past it the scheduler cancels the request and frees its lane
    # (the preemption victim choice spares such lanes longest)
    deadline_t: Optional[float] = None
    # preemption checkpoint ``{"emitted": [...], "key": [hi, lo]}``, set
    # when the pressure ladder took the lane mid-decode: the emitted
    # tokens and the lane's post-split key; with the host KV tier on,
    # also ``"tier"``: the key of the lane's K/V checkpoint there (else
    # the resume recomputes it). None = never preempted, or preempted
    # before any token was credited (a plain re-admit then reproduces
    # the stream)
    resume: Optional[Dict[str, Any]] = None
    # a remote admit's shipped slab (host tensors) and its first token,
    # lane key, covered prefix length, byte count and weight version:
    # the scheduler splices it instead of prefilling (admit_remote)
    remote: Optional[Dict[str, Any]] = None
    # multi-tenant serving (serving/weightpager.py): the owning tenant
    # (None = single-tenant) and its SLO class ("strict" | "standard" |
    # "best_effort"); the victim policy spares a strict tenant's only
    # lane, and the SLO samples split per tenant
    tenant: Optional[str] = None
    slo: str = "standard"


@dataclasses.dataclass
class _Slot:
    request: GenRequest
    emitted: List[int] = dataclasses.field(default_factory=list)
    # the prefill's first token stays on the device at admit; the next
    # burst's row 0 carries it to the host
    first_pending: bool = True
    # tokens covered by bursts dispatched so far: an eos-less lane whose
    # budget is covered is freed at dispatch (see the pre-free in _loop)
    dispatched: int = 0
    # crediting fence: set once the output is complete, so rows of later
    # in-flight bursts are never appended to a finished request
    credit_done: bool = False


@dataclasses.dataclass
class _ChunkJob:
    """A long-prompt admission mid-chunked-prefill: its lane is reserved
    but not decoding; one chunk advances per poll into a staging slab
    outside the decode cache, inserted into the lane when complete."""

    request: GenRequest
    slot: int
    next_start: int  # position of the next chunk's first token
    slab: Any  # {"k","v"}: [L, 1, KV, bucket, Dh]
    bucket: int
    # a preempted request's resume: (emitted tokens, checkpointed lane
    # key); the last chunk then inserts that state instead of its own
    # sample and replays the emitted tokens' K/V
    resume: Optional[tuple] = None


@dataclasses.dataclass
class _SwapJob:
    """A requested live weight swap: the new params, cast and staged on
    the device next to the served set. The scheduler copies them into
    the served tensors at the poll boundary where no lane, chunked
    admission or burst is in flight; admissions hold until then."""

    params: Any
    version: Any
    future: Future = dataclasses.field(default_factory=Future)
    # lanes in flight when the scheduler first saw the job, and polls
    # spent draining them
    drain_lanes: Optional[int] = None
    waited_polls: int = 0
    # the staged bytes: the ledger's "swap" component until the flip
    nbytes: int = 0
    # when the swap was staged (monotonic): the straggler bound
    # (swap_drain_ms) counts from here
    staged_t: float = 0.0


@dataclasses.dataclass
class _RetuneJob:
    """A validated live retune: the scheduler applies ``knobs`` (the
    canonical target values) at the top of a poll, where no burst is
    being dispatched; a ``prefill_chunk`` change waits until no chunked
    prefill is in flight."""

    knobs: Dict[str, Any]
    origin: str = "planner"
    future: Future = dataclasses.field(default_factory=Future)
    # polls spent waiting for chunked prefills (flight-recorder field)
    waited_polls: int = 0


@dataclasses.dataclass
class _DrainJob:
    """A requested graceful drain: the scheduler checkpoints every live
    lane at the next poll boundary, collects chunked admissions, the
    resume queue and the admit queue, and resolves the future with the
    list of :class:`GenRequest` (each checkpoint in ``resume``)."""

    future: Future = dataclasses.field(default_factory=Future)


class _PinnedPool:
    """Pinned host buffers for the bursts' token copies: a buffer goes
    back to the pool only after the host has read the burst it carried
    (its copy event fired), so an in-flight copy never lands in a buffer
    being read. Starts with ``pipeline_depth + 1``; grows when a poll's
    sub-bursts need more."""

    def __init__(self, numel: int, count: int):
        self.numel = numel
        self._free = [self._new() for _ in range(count)]

    def _new(self) -> torch.Tensor:
        return torch.empty((self.numel,), dtype=torch.long, pin_memory=True)

    def take(self) -> torch.Tensor:
        return self._free.pop() if self._free else self._new()

    def give(self, buf: torch.Tensor) -> None:
        self._free.append(buf)


class _Burst:
    """One dispatched (sub)burst on its way to the host: its tokens
    ``[k + 1, rows]`` (row 0 = the tokens it started from), for a fused
    burst each column's emitted count, and the lane snapshot its columns
    are credited against (``snapshot[slot] = (slot state, start row,
    column)``). A speculation burst (``spec``) carries the packed
    ``[1 + k * (gamma + 2), slots]`` block :meth:`ContinuousBatcher.
    _spec_burst` writes as its tokens."""

    def __init__(self, toks: torch.Tensor, counts: Optional[torch.Tensor],
                 snapshot, k: int, pool: Optional[_PinnedPool], spec: bool = False):
        self.snapshot = snapshot
        self.k = k
        self.spec = spec
        self.fused = counts is not None
        self._pool, self._buf, self.event = pool, None, None
        if toks.device.type != "cuda":
            # the device buffers are reused by the next burst: keep a copy
            self.host = toks.clone()
            self.counts = counts.clone() if self.fused else None
            return
        self._buf = buf = pool.take()
        n = toks.numel()
        self.host = buf[:n].view(toks.shape)
        self.host.copy_(toks, non_blocking=True)
        self.counts = None
        if self.fused:
            self.counts = buf[n:n + counts.numel()]
            self.counts.copy_(counts, non_blocking=True)
        # stream order: the copies run after the burst and before any
        # later burst rewrites the device buffers
        self.event = torch.cuda.Event()
        self.event.record()

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self):
        """``(tokens, counts or None)`` on the host (the burst's one read)."""
        if self.event is not None:
            self.event.synchronize()
        toks = self.host.numpy().copy()
        counts = self.counts.numpy().copy() if self.fused else None
        if self._buf is not None:
            self._pool.give(self._buf)
            self._buf = None
        return toks, counts


@dataclasses.dataclass
class _LaneState:
    """The persistent buffers one decode (sub)burst reads and writes: the
    whole batch's lane registers, or a depth group's gathered copy. CUDA
    graphs capture their addresses, so they are only ever updated in
    place (``copy_``, indexed writes), never rebound."""

    cur: torch.Tensor  # [R] token each row decodes from
    pos: torch.Tensor  # [R] its position
    keys: torch.Tensor  # [R, 2] threefry key
    temps: torch.Tensor  # [R] float32
    act: torch.Tensor  # [R] bool: rows that decode (a group's pads are not)
    stops: torch.Tensor  # [R] stop token, -1 = none
    budget: torch.Tensor  # [R] tokens left after the current one
    done: torch.Tensor  # [R] bool, fused bursts
    counts: torch.Tensor  # [R] tokens emitted this burst, fused bursts
    toks: torch.Tensor  # [K + 1, R] this burst's tokens
    row: torch.Tensor  # [1] next row of toks
    lane_ix: Optional[torch.Tensor] = None  # [R] a group's lanes (pads last)

    @classmethod
    def alloc(cls, rows: int, kmax: int, device, group: bool) -> "_LaneState":
        def z(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(
            cur=z(rows), pos=z(rows), keys=z(rows, 2),
            temps=z(rows, dtype=torch.float32), act=z(rows, dtype=torch.bool),
            stops=torch.full((rows,), -1, dtype=torch.long, device=device),
            budget=z(rows), done=z(rows, dtype=torch.bool), counts=z(rows),
            toks=z(kmax + 1, rows), row=z(1), lane_ix=z(rows) if group else None,
        )


class _StepGraphs:
    """CUDA graphs of the decode-burst phases, one per key, all in one
    memory pool. A phase reads and writes persistent buffers only and
    keeps nothing it allocates, so the graphs can share the pool: they
    replay one at a time on the batcher's stream. Capture runs on a side
    stream that the batcher's stream then waits on."""

    def __init__(self, device, stats: Dict[str, Any]):
        self.device = device
        self.stats = stats
        self.graphs: Dict[tuple, Any] = {}
        self._pool = None
        self._side = None
        self._tls = threading.local()

    def clear(self) -> None:
        self.graphs.clear()
        self._pool = None

    def capture(self, key: tuple, fn, warm_first: bool) -> None:
        """Capture ``fn`` under ``key``. ``warm_first`` runs it eagerly
        once on the capture stream first (library handles and workspaces
        come up outside the capture); only ``warm()`` may, since the
        eager run moves live state."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(self.device)
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        self._side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._side), torch.inference_mode():
            if warm_first:
                fn()
            else:
                self._init_libraries()
            reserved = torch.cuda.memory_reserved(self.device)
            graph.capture_begin(pool=self._pool, capture_error_mode="thread_local")
            try:
                fn()
            finally:
                graph.capture_end()
        cur.wait_stream(self._side)
        self.graphs[key] = graph
        self.stats["graph_pool_bytes"] += torch.cuda.memory_reserved(self.device) - reserved
        self.stats["graphs_captured"] += 1
        self.stats["graph_capture_s"] += time.perf_counter() - t0

    def _init_libraries(self) -> None:
        """cuBLAS makes a handle per thread, and a workspace per handle
        and stream, at the first product it runs; made inside a capture
        that fails (CUBLAS_STATUS_NOT_INITIALIZED). Before an inline
        capture, run one small product of each dtype eagerly on the
        capture stream, once per thread: a decode role's loop thread
        runs no prefill of its own, so its first product may come inside
        a capture. The products touch no live state."""
        if getattr(self._tls, "ready", False):
            return
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.zeros(16, 16, device=self.device, dtype=dtype)
            a @ a
        self._tls.ready = True

    def run(self, key: tuple, fn) -> None:
        graph = self.graphs.get(key)
        if graph is None:
            # a key warm() did not reach: capture it now (the JAX
            # package's inline compile), never run the burst eagerly
            logger.warning("decode-burst graph %s captured after warm()", key)
            self.stats["graph_captures_inline"] += 1
            self.capture(key, fn, warm_first=False)
            graph = self.graphs[key]
        graph.replay()
        self.stats["graph_replays"] += 1


class ContinuousBatcher:
    """Slot-based continuous batching scheduler over a DecoderLM.

    ``submit()`` is thread-safe and returns a Future resolving to the
    prompt plus generated token list. A single scheduler thread owns the
    device loop. The batcher runs on the device its params live on.
    """

    # floor for attn_bucket (kept as the JAX package's value: it changes
    # which cache prefix is read, never what is computed). Tests lower it
    # to exercise depth groups at tiny cache lengths.
    MIN_ATTN_BUCKET = 64

    def __init__(
        self,
        model,
        params,
        slots: int = 8,
        max_seq: Optional[int] = None,
        prefill_buckets: Sequence[int] = (32, 128, 512, 1024, 1792),
        steps_per_poll: int = 8,
        pipeline_depth: int = 3,
        attn_bucket: int = 128,
        fused_steps_per_dispatch: int = 0,
        depth_groups: int = 0,
        depth_group_split_bytes: Optional[int] = None,
        prefill_chunk: int = 0,
        restart_budget: int = 3,
        restart_backoff_s: float = 0.5,
        admit_queue_limit: int = 0,
        prefix_cache_hbm_bytes: int = 0,
        prefix_cache_min_tokens: int = 16,
        hbm_ledger_bytes: int = 0,
        pressure_high: float = 0.90,
        pressure_low: float = 0.75,
        draft_model=None,
        draft_params=None,
        speculate_tokens: int = 4,
        host_kv_tier_bytes: int = 0,
        kv_tier_min_tokens: int = 0,
        kv_tier_promote_min_tokens: int = 0,
        swap_drain_ms: int = 0,
        swap_resume_policy: str = "resume",
        flight_recorder_capacity: int = 512,
        profiler=None,
        cuda_graphs: bool = True,
        **knobs,
    ):
        check_not_ported(knobs, "ContinuousBatcher")
        self.model = model
        # the weights' version: slabs, prefix entries and tier entries
        # are keyed by it; a weight swap bumps it
        self.weight_version: Any = 0
        # live weight swap: request_weight_swap stages a _SwapJob, the
        # loop flips it at a poll boundary once nothing is in flight
        self._swap_lock = threading.Lock()
        self._pending_swap: Optional[_SwapJob] = None
        self._swap_seq = 0
        # the swap's straggler bound (0 = wait for in-flight lanes
        # forever) and what becomes of the lanes it checkpoints: "resume"
        # requeues them to finish on the NEW weights, "fail" refuses them
        # with WeightVersionMismatch (409)
        self.swap_drain_ms = max(0, int(swap_drain_ms))
        if swap_resume_policy not in ("resume", "fail"):
            raise ValueError(
                f"swap_resume_policy must be resume|fail, got {swap_resume_policy!r}")
        self.swap_resume_policy = swap_resume_policy
        # graceful drain: drain() stages a _DrainJob, the loop checkpoints
        # every live lane at the next poll boundary
        self._pending_drain: Optional[_DrainJob] = None
        self._drain_lock = threading.Lock()
        self.slots = int(slots)
        self.max_seq = int(max_seq or model.cfg.max_seq)
        self.steps_per_poll = int(steps_per_poll)
        # burst length actually dispatched: pow2 floor of steps_per_poll
        k = _pow2_floor(max(1, self.steps_per_poll))
        self._k = k
        if k != self.steps_per_poll:
            logger.info(
                "steps_per_poll=%d rounded down to the pow2 burst length %d",
                self.steps_per_poll, k,
            )
        # fused stop-aware decode: up to this many steps per dispatch
        # (pow2-floored; 0 = off, the step-at-a-time burst)
        self.fused_steps_per_dispatch = max(0, int(fused_steps_per_dispatch))
        self._fused_k = _pow2_floor(self.fused_steps_per_dispatch)
        # True while the device's stop/budget registers match the host's
        # view; a membership change clears it and the next fused dispatch
        # uploads them (never per burst)
        self._fused_sync = False
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.attn_bucket = max(type(self).MIN_ATTN_BUCKET, int(attn_bucket))
        # depth groups: at most this many sub-bursts per poll (0/1 = off)
        self.depth_groups = max(0, int(depth_groups))
        # chunked prefill: prompt tokens per chunk (0 = off)
        self.prefill_chunk = max(0, int(prefill_chunk))
        self.prefill_buckets = tuple(
            sorted(b for b in prefill_buckets if b <= self.max_seq)
        ) or (self.max_seq,)
        # speculative decoding: the draft proposes speculate_tokens tokens
        # per round and one target window forward verifies them (0 = off:
        # no draft given)
        self.draft_model = draft_model
        self.speculate_tokens = max(0, int(speculate_tokens)) if draft_model is not None else 0
        if self.speculate_tokens:
            if draft_params is None:
                raise ValueError("draft_model needs draft_params")
            if draft_model.cfg.vocab_size != model.cfg.vocab_size:
                raise ValueError(
                    f"the draft's vocab ({draft_model.cfg.vocab_size}) differs from "
                    f"the target's ({model.cfg.vocab_size})"
                )
            if model.cfg.n_experts > 0 or draft_model.cfg.n_experts > 0:
                raise MoEKnobRefused(
                    "speculative decoding with a mixture-of-experts target or draft: "
                    "the verify window's drafted rows share the experts' capacity "
                    "with each lane's real token, so the emitted tokens would depend "
                    "on the draft"
                )

        self._queue: "queue.Queue[GenRequest]" = queue.Queue()
        # shed before work: an explicit admit-queue cap (0 = none), and
        # recent completion times for the observed service rate
        self.admit_queue_limit = max(0, int(admit_queue_limit))
        self._finish_times: "collections.deque" = collections.deque(maxlen=32)
        self._active: Dict[int, _Slot] = {}
        # chunked-prefill jobs in flight, keyed by reserved slot
        self._chunked: Dict[int, _ChunkJob] = {}
        self._masks_dirty = True
        self._any_stoch = False
        # host mirror of each lane's device position (prompt length at
        # admit, +k per dispatched burst): picks the attention-read bucket
        # without a device sync
        self._pos_host: Dict[int, int] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        self._started = threading.Event()
        # scheduler supervision: "serving" | "restarting" | "dead" | "closed"
        self.health = "serving"
        self.restart_budget = max(0, int(restart_budget))
        self.restart_backoff_s = max(0.0, float(restart_backoff_s))
        self.restart_window_s = 300.0
        self._restarts = 0
        self._last_crash_t = 0.0
        # chaos hook: called at the top of every poll with the poll count;
        # raising kills the loop and exercises the supervision path
        self.fault_hook: Optional[Any] = None
        # multi-tenant hook: called at the top of every poll with the poll
        # count (the TenantScheduler's wake-up: bookkeeping only, it never
        # blocks), and the WeightPager whose resident weights the ledger
        # bills as its "pager" component (None: no such component)
        self.tenant_hook: Optional[Any] = None
        self.tenant_pager: Optional[Any] = None
        # test hook: set to a list and every dispatched decode (sub)burst
        # appends {"lanes", "attn_len", "need", "grouped", "k", "tenant"},
        # the proof that no lane reads past its own group's bucket
        self.trace_groups: Optional[List[Dict[str, Any]]] = None
        self._poll_count = 0
        # polls with work (lanes, chunk jobs, bursts in flight or queued
        # requests): the pressure hook's clock, so a fault-injected
        # shrink lands relative to traffic, not to idle polls
        self._work_poll_count = 0
        self._warm_args: Optional[Dict[str, Any]] = None
        # radix prefix KV cache (0 bytes = off): prompt slabs of finished
        # requests, LRU-evicted at radix-node granularity
        self.prefix_cache_min_tokens = max(1, int(prefix_cache_min_tokens))
        self._prefix_cache_budget = int(prefix_cache_hbm_bytes)
        self._prefix_index = (
            RadixPrefixIndex(self._prefix_cache_budget)
            if self._prefix_cache_budget > 0 else None
        )
        # host KV tier (0 bytes = off): demoted prefix slabs, export
        # publishes and preempted lanes' K/V checkpoints, SKV1-encoded in
        # host RAM. Demote threshold defaults to prefix_cache_min_tokens,
        # the promote threshold to the demote threshold
        self.host_kv_tier_bytes = max(0, int(host_kv_tier_bytes))
        self.kv_tier_min_tokens = int(kv_tier_min_tokens) or self.prefix_cache_min_tokens
        self.kv_tier_promote_min_tokens = (
            int(kv_tier_promote_min_tokens) or self.kv_tier_min_tokens
        )
        self._kv_tier = (
            HostKVTier(self.host_kv_tier_bytes, min_tokens=self.kv_tier_min_tokens,
                       version=self.weight_version)
            if self.host_kv_tier_bytes > 0 else None
        )
        # checkpoint-entry keys: per-batcher sequence numbers
        self._tier_ck_seq = 0
        # the spill widths warm() ran the tier's extract and insert at
        self._warm_tier_widths: List[int] = []
        # export_prefill and the decode role's peer hooks run on caller
        # threads: their stat updates take this lock
        self._export_lock = threading.Lock()
        # HBM pressure: the unified ledger (0 bytes = off: the loop never
        # consults it), the chaos hook (called each working poll; an int
        # re-budgets the ledger, -1 restores the boot budget), and the
        # preempted requests awaiting resume, admitted ahead of the queue
        self._pressure = PressureController(
            hbm_ledger_bytes, high=pressure_high, low=pressure_low
        )
        self.pressure_hook: Optional[Any] = None
        self._resume_queue: "collections.deque" = collections.deque()
        # the reclaim ladder's actions, newest last: {"type":
        # "pressure_reclaim", "action": "evict_prefix" | "cancel_speculation"
        # | "resume_speculation", ...}
        self.pressure_events: "collections.deque" = collections.deque(maxlen=256)
        # burst_reads/burst_read_bytes: modelled device reads of the
        # dispatched decode (sub)bursts, params once per step plus each
        # row's bucketed KV; group_*: real and pad rows of grouped
        # sub-bursts; lane_steps: k x rows summed over (sub)bursts
        self.stats: Dict[str, Any] = {
            "admitted": 0, "finished": 0, "cancelled": 0, "steps": 0,
            "lane_steps": 0, "tokens": 0,
            "prefill_steps": 0, "prefill_tokens": 0, "prefill_chunks": 0,
            "batcher_restarts": 0, "shed": 0,
            # prefix cache: admissions that spliced a cached prefix or
            # missed, slabs evicted (budget or pressure), prompt tokens
            # not prefilled, and the cache's bytes
            "prefix_hits": 0, "prefix_misses": 0, "prefix_evicted": 0,
            "prefix_tokens_saved": 0, "prefix_cache_bytes": 0,
            # HBM pressure: lanes (and chunk jobs) preempted, resumes that
            # landed, emitted tokens replayed into resumed lanes, submits
            # shed while latched, prefix slabs the ladder evicted (a
            # share of prefix_evicted)
            "preemptions": 0, "preempt_resumes": 0, "replayed_tokens": 0,
            "pressure_sheds": 0, "pressure_prefix_evictions": 0,
            # remote admits refused while the ledger is latched
            "pressure_refused": 0,
            # disaggregated serving: slabs/bytes shipped out (prefill
            # role), slabs/bytes admitted in (decode role), the transfer
            # bytes the decode side's radix cache deduplicated away,
            # prefill-peer ejections/readmissions (bumped by the decode
            # server's failover transport) and remote prefills served
            # locally because the whole prefill pool was ejected
            "kv_exports": 0, "kv_export_bytes": 0,
            "kv_imports": 0, "kv_import_bytes": 0,
            "kv_transfer_bytes_saved": 0,
            "peer_ejections": 0, "peer_readmissions": 0,
            "degraded_local_prefill": 0,
            # host KV tier: slabs demoted (prefix demotions, lane
            # checkpoints, export publishes), lookups that found an
            # entry, entries promoted back to the device (prefix match,
            # peer pull, checkpoint copy-back), entries evicted or
            # dropped as corrupt, the tier's bytes, and resumes that
            # expected a checkpoint but recomputed and replayed
            "kv_tier_demotions": 0, "kv_tier_promotions": 0,
            "kv_tier_hits": 0, "kv_tier_evictions": 0,
            "kv_tier_bytes": 0, "kv_tier_replay_fallbacks": 0,
            "burst_reads": 0, "burst_read_bytes": 0,
            "group_bursts": 0, "group_lanes": 0, "group_pad_lanes": 0,
            "fused_steps": 0, "fused_dispatches": 0,
            # speculation: lane-rounds run and tokens they emitted (their
            # ratio is the tokens per round, 1 .. gamma + 1), and the spec
            # graphs re-captured (or set aside and reused: the new draft
            # cache at the old address) when rung 2 gives the draft cache
            # back
            "spec_rounds": 0, "spec_emitted": 0, "spec_graph_recaptures": 0,
            "spec_graph_reuses": 0,
            # decode-burst CUDA graphs: captures, their seconds, the device
            # memory the graph pool reserved while capturing, captures
            # after warm(), and replays
            "graphs_captured": 0, "graph_capture_s": 0.0, "graph_pool_bytes": 0,
            "graph_captures_inline": 0, "graph_replays": 0,
            "steps_per_poll_effective": k,
            "slo_samples": 0, "queue_wait_s_sum": 0.0,
            "ttft_s_sum": 0.0, "tpot_s_sum": 0.0,
            # weight swaps flipped; graceful drains done, checkpoints
            # exported and handed to a peer (the server's drain_to),
            # resumes admitted from a wire checkpoint or resume token, and
            # lanes the swap's straggler bound checkpointed
            "weight_swaps": 0, "drains": 0, "checkpoint_exports": 0,
            "migrations": 0, "migrated_resumes": 0, "swap_preemptions": 0,
            # retunes applied at a poll boundary
            "planner_retunes": 0,
        }
        # flight recorder: one record per working poll and one per
        # scheduling event, bounded and drop-oldest (0 = off)
        self.flight: Optional[FlightRecorder] = (
            FlightRecorder(flight_recorder_capacity)
            if int(flight_recorder_capacity) > 0 else None
        )
        # (queue_wait, ttft, tpot) of completed requests: ``slo_pending``
        # drains into response metrics, ``slo_recent`` is a reservoir for
        # percentiles
        self.slo_pending: "collections.deque" = collections.deque(maxlen=4096)
        self.slo_recent: "collections.deque" = collections.deque(maxlen=2048)
        # the same samples split per tenant, keyed at _resolve time (the
        # single-tenant path allocates nothing): cumulative sums and
        # counts, a drain queue for tenant-tagged TIMERs, and a reservoir
        # the TenantScheduler reads as its TTFT feedback
        self.tenant_slo: Dict[str, Dict[str, float]] = {}
        self.tenant_slo_pending: Dict[str, "collections.deque"] = {}
        self.tenant_slo_recent: Dict[str, "collections.deque"] = {}

        dt = model.dtype
        self.device = params["embed"].device
        model.check_device(self.device)
        # params are stored in the compute dtype: the forward casts at use,
        # so pre-casting is numerically identical and halves the bytes
        # every decode step reads
        self.params = _cast_tree(params, dt)
        self._draft_params = None
        self._draft_kv_key_bytes = 0
        if self.speculate_tokens:
            draft_model.check_device(self.device)
            # an early-exit self-draft shares the target's tensors: leaves
            # already in the draft's dtype are kept as they are
            self._draft_params = _cast_tree(draft_params, draft_model.dtype)
            dcfg = draft_model.cfg
            self._draft_kv_key_bytes = (
                2 * dcfg.n_layers * dcfg.n_kv_heads * dcfg.head_dim
                * torch.empty((), dtype=draft_model.dtype).element_size()
            )
        cfg = model.cfg
        # depth-group cost model: K+V bytes per cached position over all
        # layers, and the param read a separate sub-burst adds per step
        self._kv_key_bytes = (
            2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
            * torch.empty((), dtype=dt).element_size()
        )
        self._param_bytes = _tree_bytes(self.params)
        self._group_split_bytes = (
            int(depth_group_split_bytes)
            if depth_group_split_bytes is not None
            else self._param_bytes
        )
        # device-time ledger: every dispatch runs inside
        # ``self._prof.measure``; a disabled ledger's measure() is a shared
        # no-op, and the hooks never touch what they time, so profiler on
        # vs off is byte-identical and captures no graph
        self._prof = profiler if profiler is not None else DeviceTimeLedger()
        self._prof.device = self.device
        # retune() stages a validated _RetuneJob, the loop applies it at a
        # poll boundary. The census is what warm() prepares from the boot
        # knobs: decode graphs are per step (a burst of K replays one step
        # K times), so every fused K from the poll burst up to the boot K
        # runs on them; group graphs exist only when the member boots with
        # depth groups; chunk steps only at the boot chunk size; the
        # attention buckets cover the boot pipeline depth
        self._retune_lock = threading.Lock()
        self._pending_retune: Optional[_RetuneJob] = None
        census_fks: List[int] = []
        if self._fused_k > 0:
            fk, lo = self._fused_k, min(self._k, self._fused_k)
            while fk >= lo:
                census_fks.append(fk)
                fk //= 2
        self._retune_census: Dict[str, Any] = {
            "fused_ks": tuple(sorted(census_fks)),
            "depth_groups": self.depth_groups,
            "prefill_chunk": self.prefill_chunk,
            "pipeline_depth": self.pipeline_depth,
        }
        # the decode step kind warm() captures, fixed for the batcher's
        # life: masked (fused) or plain. A retune to fused 0 on a fused
        # member keeps the masked step at the poll burst length
        self._masked_steps = self._fused_k > 0 and not self.speculate_tokens
        # decode bursts replay CUDA graphs on the card; ``cuda_graphs=False``
        # keeps them eager (the comparison the on-card smoke run makes)
        self._graphs = (
            _StepGraphs(self.device, self.stats)
            if cuda_graphs and self.device.type == "cuda" else None
        )
        kmax = max(self._k, self._fused_k)
        rows = max(kmax + 2, self._spec_rows())
        self._pinned = (
            _PinnedPool(rows * self.slots, self.pipeline_depth + 1)
            if self.device.type == "cuda" else None
        )
        self._alloc_device_state()

    # -- device state ------------------------------------------------------

    def _alloc_device_state(self) -> None:
        """(Re)allocate everything the loop mutates: the per-layer KV
        cache, the lane registers and burst buffers (the whole batch's,
        and each depth-group size's with one shared gather buffer), and
        the lane key streams (``PRNGKey(lane)``, as the JAX package).
        Graphs captured over the old buffers are dropped."""
        cfg = self.model.cfg
        shape = (self.slots, cfg.n_kv_heads, self.max_seq, cfg.head_dim)
        dt, dev = self.model.dtype, self.device
        self._cache = {
            "k": [torch.zeros(shape, dtype=dt, device=dev) for _ in range(cfg.n_layers)],
            "v": [torch.zeros(shape, dtype=dt, device=dev) for _ in range(cfg.n_layers)],
        }
        kmax = max(self._k, self._fused_k)
        self._whole = _LaneState.alloc(self.slots, kmax, dev, group=False)
        # the teacher-forced replay step's registers: each row's token,
        # position and K/V write position (past the cache = no write)
        self._replay = {
            "cur": torch.zeros((self.slots,), dtype=torch.long, device=dev),
            "pos": torch.zeros((self.slots,), dtype=torch.long, device=dev),
            "wpos": torch.full((self.slots,), self.max_seq, dtype=torch.long, device=dev),
        }
        self._draft_cache = self._draft_buf = None
        # rung 2's suspended spec graphs: (draft buffer address, graphs)
        self._spec_suspended = None
        self._spec_out = None
        if self.speculate_tokens:
            self._draft_cache = self._new_draft_cache()
            # one spec burst's output: the start tokens, then per round
            # each lane's gamma + 1 window tokens, then per round each
            # lane's emitted count
            self._spec_out = torch.zeros((self._spec_rows(), self.slots),
                                         dtype=torch.long, device=dev)
        # reclaim rung 2 cancelled speculation (draft cache freed, plain
        # bursts) until the ledger clears
        self._spec_suppressed = False
        self._groups: Dict[int, _LaneState] = {}
        self._gather_buf = None
        if self.depth_groups > 1:
            for gb in self._warm_group_sizes():
                self._groups[gb] = _LaneState.alloc(gb, kmax, dev, group=True)
            # one flat buffer serves every (group size, bucket): a group's
            # gathered K and V for all layers are contiguous views of it
            # (a buffer per key would cost up to the cache per key)
            self._gather_buf = torch.empty(
                (2 * cfg.n_layers * self.slots * cfg.n_kv_heads * self.max_seq
                 * cfg.head_dim,), dtype=dt, device=dev,
            )
        if self._graphs is not None:
            self._graphs.clear()
        self._reset_lanes()

    def _spec_rows(self) -> int:
        """Rows of a spec burst's packed output: ``1 + k * (gamma + 2)``
        (0 without speculation)."""
        g = self.speculate_tokens
        return 1 + self._k * (g + 2) if g else 0

    def _new_draft_cache(self):
        """A zeroed draft cache: per draft layer ``[slots, KV_d, max_seq,
        Dh_d]``, as the target's, all views of ONE buffer
        (``_draft_buf``), so that rung 2's free and re-allocation is one
        block the caching allocator can hand back at the same address."""
        dcfg = self.draft_model.cfg
        shape = (2, dcfg.n_layers, self.slots, dcfg.n_kv_heads, self.max_seq, dcfg.head_dim)
        self._draft_buf = torch.zeros(shape, dtype=self.draft_model.dtype, device=self.device)
        return {"k": list(self._draft_buf[0]), "v": list(self._draft_buf[1])}

    def _spec_active(self) -> bool:
        """Speculation is configured and rung 2 has not cancelled it."""
        return self.speculate_tokens > 0 and not self._spec_suppressed

    def _upload(self, dst: torch.Tensor, arr) -> None:
        """Host array -> persistent device buffer, in place and without a
        host sync: from pinned memory the copy queues behind the
        in-flight bursts instead of waiting for them."""
        t = torch.as_tensor(arr)
        if self.device.type == "cuda":
            dst.copy_(t.pin_memory(), non_blocking=True)
        else:
            dst.copy_(t)

    def _to_dev(self, arr) -> torch.Tensor:
        """Host array -> new device tensor without a host sync."""
        t = torch.as_tensor(arr)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _reset_lanes(self) -> None:
        w = self._whole
        w.cur.zero_()
        w.pos.zero_()
        w.keys.copy_(rng.prng_key(torch.arange(self.slots), device=self.device))
        w.stops.fill_(-1)
        w.budget.zero_()
        self._fused_sync = False
        self._masks_dirty = True

    # -- device steps (scheduler thread) ------------------------------------

    def _sample_first(self, logits, seeds, temps):
        """Each row's first token from its prefill logits, and its lane
        key: ``PRNGKey(seed)`` split exactly as every later decode step
        splits the lane key (the JAX package's prefill_many; for one row
        its prefill_one draws the same numbers)."""
        keys = self._to_dev(rng.prng_key(np.asarray(seeds, np.int64)))
        temps_t = self._to_dev(np.asarray(temps, np.float32))
        keys, firsts = rng.sample_next(
            keys, logits, temps_t, stochastic=bool(np.any(np.asarray(temps) > 0))
        )
        return firsts, keys

    @torch.no_grad()
    def _prefill(self, prompts: np.ndarray, last: np.ndarray, seeds, temps):
        """Batched prefill of m right-padded prompts ``[m, bucket]`` plus
        each row's first token: ``(firsts [m], slab, lane_keys [m, 2])``."""
        logits, slab = self.model.prefill(
            self.params, self._to_dev(prompts), prompts.shape[1],
            last_index=self._to_dev(last),
        )
        firsts, keys = self._sample_first(logits, seeds, temps)
        return firsts, slab, keys

    @torch.no_grad()
    def _insert(self, slab, slots: Sequence[int], firsts, first_pos, lane_keys) -> None:
        """Copy each slab row i ``[KV, bucket, Dh]`` into lane ``slots[i]``
        of every layer's cache (in place) and arm the lanes' token,
        position and key registers. A bucket never exceeds ``max_seq``
        (buckets are clipped to it), so the copy is in bounds."""
        bucket = slab["k"].shape[3]
        if bucket > self.max_seq:
            raise ValueError(f"slab of {bucket} positions exceeds max_seq {self.max_seq}")
        idx = self._to_dev(np.asarray(slots, np.int64))
        for name in ("k", "v"):
            for l, layer in enumerate(self._cache[name]):
                layer[idx, :, :bucket] = slab[name][l]
        w = self._whole
        w.cur[idx] = firsts
        w.pos[idx] = self._to_dev(np.asarray(first_pos, np.int64))
        w.keys[idx] = lane_keys

    @torch.no_grad()
    def _prefix_prefill(self, slab, suffix: np.ndarray, start: int, last: int,
                        seed: int, temp: float):
        """Suffix-only prefill ``[1, W]`` over a cached prefix slab plus
        the first token, sampled exactly as the whole-prompt prefill
        samples it: ``(first [1], suffix slab [L, 1, KV, W, Dh],
        lane_key [1, 2])``."""
        logits, suffix_slab = self.model.prefill_with_prefix(
            self.params, slab, self._to_dev(suffix), start,
            last_index=self._to_dev(np.asarray([last], np.int64)),
        )
        first, key = self._sample_first(logits, [seed], [temp])
        return first, suffix_slab, key

    @torch.no_grad()
    def _insert_prefix(self, slab, suffix_slab, slot: int, start: int,
                       first, first_pos: int, lane_key) -> None:
        """A prefix hit into lane ``slot`` (in place): the donor slab at
        position 0, then the suffix slab at ``start`` over the donor's
        residue, and the lane's token, position and key registers
        armed as ``_insert`` arms them. Donor positions past the end of
        the suffix lie past the prompt, where decode writes before any
        read."""
        tb, w = slab["k"].shape[3], suffix_slab["k"].shape[3]
        if max(tb, start + w) > self.max_seq:
            raise ValueError(f"prefix splice [0, {max(tb, start + w)}) exceeds "
                             f"max_seq {self.max_seq}")
        for name in ("k", "v"):
            for l, layer in enumerate(self._cache[name]):
                layer[slot, :, :tb] = slab[name][l, 0]
                layer[slot, :, start:start + w] = suffix_slab[name][l, 0]
        ws = self._whole
        ws.cur[slot: slot + 1] = first
        ws.pos[slot].fill_(first_pos)
        ws.keys[slot: slot + 1] = lane_key

    @torch.no_grad()
    def _extract_prefix(self, slot: int, bucket: int):
        """A copy of lane ``slot``'s first ``bucket`` positions as a
        ``{"k","v"}`` slab ``[L, 1, KV, bucket, Dh]``: the unit the prefix
        cache publishes (a copy, so the lane's next occupant cannot
        change it)."""
        return {
            name: torch.stack([layer[slot: slot + 1, :, :bucket] for layer in self._cache[name]])
            for name in ("k", "v")
        }

    def _new_slab(self, bucket: int):
        """A zeroed staging slab ``{"k","v"}`` of ``[L, 1, KV, bucket, Dh]``
        in the layout the lane insert takes."""
        cfg = self.model.cfg
        shape = (cfg.n_layers, 1, cfg.n_kv_heads, bucket, cfg.head_dim)
        dt = self.model.dtype
        return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device)}

    @torch.no_grad()
    def _chunk_step(self, slab, tokens: np.ndarray, start: int, last: int,
                    seed: int, temp: float, attn_len: int, is_last: bool):
        """One prompt chunk ``[1, C]`` into a staging slab; the last chunk
        also samples the first token exactly as the whole-prompt prefill
        does, so chunked and whole-prompt admissions emit the same
        streams. Returns ``(first [1], lane_key [1, 2])`` or None."""
        logits, _ = self.model.prefill_chunk(
            self.params, slab, self._to_dev(tokens), start, attn_len,
            last_index=self._to_dev(np.asarray([last], np.int64)),
            want_logits=is_last,
        )
        if not is_last:
            return None
        return self._sample_first(logits, [seed], [temp])

    def _replay_step(self, attn_len: int) -> None:
        """ONE teacher-forced decode step over the whole batch from the
        replay registers: rows parked at the cache length write nothing,
        the resumed row writes its token's K/V at its position. No
        sampling, and no lane register is touched."""
        r = self._replay
        self.model.decode_step_ragged_list(
            self.params, self._cache["k"], self._cache["v"], r["cur"][:, None],
            r["pos"], attn_len=attn_len, write_pos=r["wpos"],
        )

    @torch.no_grad()
    def _draft_admit_tokens(self, slot: int, tokens: List[int]) -> None:
        """The draft's K/V prefix of ``tokens`` into lane ``slot`` of the
        draft cache: a draft prefill over the tokens right-padded to their
        bucket (the prompt at admission, prompt + generated-so-far when a
        lane resumes or speculation comes back). The draft's K/V is a
        function of the tokens alone, so re-deriving it lands the lane
        where incremental drafting would have left it; it is never cached
        or chunked (the draft is cheap by construction, and the prefix
        cache holds only the target's K/V).

        The rest of the lane's draft row is cleared: a round that accepts
        all gamma drafts leaves the last draft's position unwritten, and
        the next round's draft attends over it. Cleared, that position
        holds what a fresh cache holds, whatever the lane served before
        and however many rounds ran past an earlier request's end (the
        JAX batcher keeps the leftover, so its seeded streams with
        speculation depend on the lane's history)."""
        n = len(tokens)
        bucket = self._bucket(n)
        prompt = np.zeros((1, bucket), np.int64)
        prompt[0, :n] = tokens
        with device_trace("gen.draft_prefill"):
            _logits, slab = self.draft_model.prefill(
                self._draft_params, self._to_dev(prompt), bucket,
                last_index=self._to_dev(np.asarray([n - 1], np.int64)),
            )
            for name in ("k", "v"):
                for l, layer in enumerate(self._draft_cache[name]):
                    layer[slot, :, :bucket] = slab[name][l, 0]
                    layer[slot, :, bucket:].zero_()

    def _spec_round(self, attn_len: int, any_stoch: bool):
        """ONE speculation round over every lane (the JAX package's
        ``spec_round``): gamma draft steps, one target verify over the
        window, acceptance, and the correction or bonus token. Greedy
        lanes take the draft's argmax and accept while it equals the
        target's; temperature lanes draft by sampling ``q`` and accept
        draft i with probability ``min(1, p_i(d_i) / q_i(d_i))``, then
        sample the correction from ``norm(max(p - q, 0))`` (or the bonus
        from ``p`` when all gamma were accepted), so every lane emits the
        target's distribution. ``any_stoch`` False is the greedy-only
        variant: no lane key splits in it, as in the JAX package. Every
        shape is static and nothing reads back to the host, so a burst
        of rounds is one CUDA graph. Updates the lane registers in place
        and returns ``(out [S, gamma + 1], count [S])``."""
        w = self._whole
        g = self.speculate_tokens
        act, temps = w.act, w.temps
        safe_t = torch.clamp(temps, min=1e-6)[:, None]
        stoch = temps > 0
        keys = w.keys
        dks, dvs = self._draft_cache["k"], self._draft_cache["v"]
        dtok, dpos = w.cur, w.pos
        drafts, q_rows = [], []
        for _ in range(g):
            dlogits, _, _ = self.draft_model.decode_step_ragged_list(
                self._draft_params, dks, dvs, dtok[:, None], dpos, attn_len=attn_len)
            greedy = torch.argmax(dlogits, dim=-1)
            if any_stoch:
                pair = rng.split(keys)
                keys, subs = pair[:, 0], pair[:, 1]
                scaled = dlogits / safe_t
                q_rows.append(torch.softmax(scaled, dim=-1))
                dtok = torch.where(stoch, rng.categorical_rows(subs, scaled), greedy)
            else:
                dtok = greedy
            dtok = torch.where(act, dtok, 0)
            drafts.append(dtok)
            dpos = torch.where(act, dpos + 1, dpos)
        drafts_arr = torch.stack(drafts, dim=1)  # [S, g]
        window = torch.cat([w.cur[:, None], drafts_arr], dim=1)
        tlogits, _, _ = self.model.decode_chunk_ragged_list(
            self.params, self._cache["k"], self._cache["v"], window, w.pos, attn_len=attn_len)
        t_greedy = torch.argmax(tlogits, dim=-1)  # [S, g + 1]
        acc = drafts_arr == t_greedy[:, :g]
        if any_stoch:
            q_full = torch.stack(q_rows, dim=1)  # [S, g, V]
            p = torch.softmax(tlogits / safe_t[..., None], dim=-1)
            p_sel = torch.gather(p[:, :g], 2, drafts_arr[..., None])[..., 0]
            q_sel = torch.gather(q_full, 2, drafts_arr[..., None])[..., 0]
            pair = rng.split(keys)
            keys, subs = pair[:, 0], pair[:, 1]
            u = rng.uniform(subs, (g,))  # [S, g]
            acc_stoch = u < torch.clamp(p_sel / torch.clamp(q_sel, min=1e-20), max=1.0)
            acc = torch.where(stoch[:, None], acc_stoch, acc)
        accepted = torch.cumprod(acc.long(), dim=1).sum(dim=1)  # [S]
        correction = torch.gather(t_greedy, 1, accepted[:, None])[:, 0]
        if any_stoch:
            V = p.shape[-1]
            p_at_a = torch.gather(p, 1, accepted[:, None, None].expand(-1, 1, V))[:, 0]
            a_clamp = torch.clamp(accepted, max=g - 1)
            q_at_a = torch.gather(q_full, 1, a_clamp[:, None, None].expand(-1, 1, V))[:, 0]
            resid = torch.clamp(p_at_a - q_at_a, min=0.0)
            # a numerically empty residual (p <= q everywhere) falls back to p
            resid = torch.where(resid.sum(-1, keepdim=True) > 1e-12, resid, p_at_a)
            dist = torch.where((accepted == g)[:, None], p_at_a, resid)
            pair = rng.split(keys)
            keys, subs = pair[:, 0], pair[:, 1]
            sampled = rng.categorical_rows(subs, torch.log(dist + 1e-30))
            correction = torch.where(stoch, sampled, correction)
        cols = torch.arange(g + 1, device=w.cur.device)[None, :]
        out = torch.where(cols < accepted[:, None], torch.nn.functional.pad(drafts_arr, (0, 1)), 0)
        out = torch.where(cols == accepted[:, None], correction[:, None], out)
        out = torch.where(act[:, None], out, 0)
        count = torch.where(act, accepted + 1, 0)
        w.cur.copy_(torch.where(act, correction, w.cur))
        w.pos.copy_(torch.where(act, w.pos + accepted + 1, w.pos))
        if any_stoch:
            w.keys.copy_(keys)
        return out, count

    def _spec_burst(self, attn_len: int, any_stoch: bool) -> None:
        """``k`` speculation rounds (the JAX package's ``spec_burst``) into
        the packed output ``_spec_out``: row 0 the tokens the burst
        started from (a deferred prefill first token rides home with the
        burst's one read), then each round's ``[gamma + 1, slots]``
        window tokens, then each round's per-lane emitted count."""
        g, k = self.speculate_tokens, self._k
        out = self._spec_out
        out[0].copy_(self._whole.cur)
        for r in range(k):
            toks, count = self._spec_round(attn_len, any_stoch)
            out[1 + r * (g + 1): 1 + (r + 1) * (g + 1)].copy_(toks.t())
            out[1 + k * (g + 1) + r].copy_(count)

    # Decode-burst phases. Each reads and writes only persistent buffers
    # (a _LaneState, the cache, the gather buffer), so on the card each
    # is captured once per key and replayed; on the CPU each runs as is.

    def _phase(self, key: tuple, fn) -> None:
        if self._graphs is not None:
            self._graphs.run(key, fn)
        else:
            with torch.inference_mode():
                fn()

    @staticmethod
    def _begin(st: _LaneState, masked: bool) -> None:
        """Row 0 = the tokens the burst starts from (a deferred prefill
        first token rides home with the burst's one read). A fused burst
        also arms its done mask: a lane arrives done when it is idle, its
        budget is spent, or its stop token was emitted by a burst the
        host has not read yet; it then runs zero steps."""
        st.toks[0].copy_(st.cur)
        st.row.fill_(1)
        if masked:
            st.done.copy_(~st.act | (st.budget <= 0) | (st.cur == st.stops))
            st.counts.zero_()

    def _step(self, st: _LaneState, ks, vs, attn_len: Optional[int],
              stochastic: bool, masked: bool, park: int) -> None:
        """ONE ragged decode step over ``st``'s rows. Plain: active rows
        advance, the others emit 0 and stand still. Masked (fused): rows
        alive under the done mask advance exactly as plain ones; a done
        row parks its K/V write at ``park`` (past the cache: nothing is
        written), keeps its token and position, and emits 0; a row that
        emits its stop token or spends its budget becomes done. Every
        row's key splits every step, alive or not, as in the JAX
        package, so seeded streams stay its streams."""
        alive = (st.act & ~st.done) if masked else st.act
        wpos = torch.where(alive, st.pos, park) if masked else None
        logits, _, _ = self.model.decode_step_ragged_list(
            self.params, ks, vs, st.cur[:, None], st.pos, attn_len=attn_len,
            write_pos=wpos,
        )
        keys, nxt = rng.sample_next(st.keys, logits, st.temps, stochastic=stochastic)
        st.keys.copy_(keys)
        step = alive.long()
        if masked:
            st.cur.copy_(torch.where(alive, nxt, st.cur))
            st.budget.sub_(step)
            st.done.logical_or_(alive & ((st.cur == st.stops) | (st.budget <= 0)))
            st.counts.add_(step)
            out = torch.where(alive, st.cur, 0)
        else:
            st.cur.copy_(torch.where(alive, nxt, 0))
            out = st.cur
        st.pos.add_(step)
        st.toks.index_copy_(0, st.row, out[None])
        st.row.add_(1)

    def _group_slabs(self, gb: int, attn_len: int):
        """A group's gathered K and V per layer, ``[gb, KV, attn_len,
        Dh]`` contiguous views of the one gather buffer."""
        cfg = self.model.cfg
        n = gb * cfg.n_kv_heads * attn_len * cfg.head_dim
        shape = (gb, cfg.n_kv_heads, attn_len, cfg.head_dim)
        views = self._gather_buf[: 2 * cfg.n_layers * n].view(2, cfg.n_layers, *shape)
        return list(views[0]), list(views[1])

    def _gather(self, g: _LaneState, attn_len: int, masked: bool) -> None:
        """Gather a group's lane registers and cache prefix ``[0,
        attn_len)``. Pads sit at position ``attn_len``: their K/V writes
        fall past the gathered slab, so their rows round-trip unchanged."""
        w, ix = self._whole, g.lane_ix
        torch.index_select(w.cur, 0, ix, out=g.cur)
        g.pos.copy_(torch.where(g.act, w.pos[ix], attn_len))
        torch.index_select(w.temps, 0, ix, out=g.temps)
        torch.index_select(w.keys, 0, ix, out=g.keys)
        torch.index_select(w.budget, 0, ix, out=g.budget)
        g.stops.copy_(torch.where(g.act, w.stops[ix], -1))
        gks, gvs = self._group_slabs(g.act.shape[0], attn_len)
        for layer, gk in zip(self._cache["k"], gks):
            torch.index_select(layer[:, :, :attn_len], 0, ix, out=gk)
        for layer, gv in zip(self._cache["v"], gvs):
            torch.index_select(layer[:, :, :attn_len], 0, ix, out=gv)
        self._begin(g, masked)

    def _scatter(self, g: _LaneState, attn_len: int, masked: bool) -> None:
        """Scatter a group back: the gathered cache prefix (pads'
        unchanged), and the registers of its real rows only, so a pad's
        burst-local state never leaks into its lane."""
        w, ix = self._whole, g.lane_ix
        gks, gvs = self._group_slabs(g.act.shape[0], attn_len)
        for layer, gk in zip(self._cache["k"], gks):
            layer[:, :, :attn_len].index_copy_(0, ix, gk)
        for layer, gv in zip(self._cache["v"], gvs):
            layer[:, :, :attn_len].index_copy_(0, ix, gv)
        regs = [(w.cur, g.cur), (w.pos, g.pos)] + ([(w.budget, g.budget)] if masked else [])
        for dst, src in regs:
            dst.index_copy_(0, ix, torch.where(g.act, src, dst[ix]))
        w.keys.index_copy_(0, ix, torch.where(g.act[:, None], g.keys, w.keys[ix]))

    def _whole_burst(self, k: int, attn_len: int, stochastic: bool, masked: bool):
        """k steps over every lane: ``(tokens [k+1, slots], counts or
        None)``, device buffers read by the burst's host copy."""
        w = self._whole
        ks, vs = self._cache["k"], self._cache["v"]
        self._phase(("begin", masked), lambda: self._begin(w, masked))
        key = ("step", masked, "whole", attn_len, stochastic)
        for _ in range(k):
            self._phase(key, lambda: self._step(
                w, ks, vs, attn_len, stochastic, masked, self.max_seq))
        return w.toks[: k + 1], (w.counts if masked else None)

    def _group_burst(self, lane_ix: List[int], n_real: int, k: int, attn_len: int,
                     stochastic: bool, masked: bool):
        """k steps over a gathered group (``lane_ix``: its lanes, then
        pads of other lanes up to the pow2 size): ``(tokens [k+1, gb],
        counts or None)``, columns in ``lane_ix`` order."""
        gb = len(lane_ix)
        g = self._groups[gb]
        self._upload(g.lane_ix, np.asarray(lane_ix, np.int64))
        self._upload(g.act, np.arange(gb) < n_real)
        gks, gvs = self._group_slabs(gb, attn_len)
        self._phase(("gather", masked, gb, attn_len),
                    lambda: self._gather(g, attn_len, masked))
        key = ("step", masked, gb, attn_len, stochastic)
        for _ in range(k):
            # the gathered slab is exactly attn_len long: no read bound
            self._phase(key, lambda: self._step(
                g, gks, gvs, None, stochastic, masked, attn_len))
        self._phase(("scatter", masked, gb, attn_len),
                    lambda: self._scatter(g, attn_len, masked))
        return g.toks[: k + 1], (g.counts if masked else None)

    # -- caller side ---------------------------------------------------------

    def _dead_error(self) -> BatcherDead:
        if self.health == "closed":
            return BatcherDead("batcher is closed", retry_after_s=1.0)
        if self.health == "dead":
            return BatcherDead(
                "continuous batcher died and exhausted its crash-loop budget",
                retry_after_s=5.0,
            )
        return BatcherDead("continuous batcher died; see server log", retry_after_s=5.0)

    def _check_alive(self) -> None:
        if self._stop.is_set() or self.health in ("dead", "closed"):
            raise self._dead_error()
        if self.health == "draining":
            # in-flight work is being checkpointed and handed over: new
            # work is refused typed (503 + Retry-After) so the caller
            # retries another member
            raise BatcherDead(
                "batcher is draining for migration; retry another member",
                retry_after_s=1.0,
            )

    def _check_budget(self, prompt_len: int, max_new_tokens) -> None:
        m = int(max_new_tokens)
        if prompt_len + m > self.max_seq:
            raise BudgetExceeded(
                f"prompt of {prompt_len} + max_new_tokens {m} exceeds "
                f"max_seq {self.max_seq}; raise max_seq or lower the "
                "generation budget"
            )

    def submit(
        self,
        tokens: Sequence[int],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        seed: int = 0,
        on_tokens=None,
        deadline_s: Optional[float] = None,
        tenant: Optional[str] = None,
        slo: str = "standard",
    ) -> Future:
        self._check_alive()
        if not len(tokens):
            raise ValueError("empty prompt")
        if len(tokens) >= self.max_seq:
            raise PromptTooLong(
                f"prompt of {len(tokens)} exceeds max_seq {self.max_seq}"
            )
        self._check_budget(len(tokens), max_new_tokens)
        self._shed_check(deadline_s)
        seed = int(seed)
        if not -(1 << 31) <= seed < (1 << 31):
            raise ValueError(f"seed {seed} does not fit in 32 bits")
        req = GenRequest(
            tokens=list(map(int, tokens)),
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            eos_id=eos_id,
            seed=seed,
            on_tokens=on_tokens,
            tenant=tenant,
            slo=slo,
        )
        req.submit_t = time.monotonic()
        req.submit_wall_us = wall_us(req.submit_t)
        if deadline_s is not None:
            req.deadline_t = req.submit_t + float(deadline_s)
        return self._enqueue(req)

    def observed_rate(self) -> Optional[float]:
        """Finished requests per second over the recent completion window
        (None until two completions exist — never shed blind)."""
        times = list(self._finish_times)
        if len(times) < 2:
            return None
        span = times[-1] - times[0]
        if span <= 0:
            return None
        return (len(times) - 1) / span

    def _shed_check(self, deadline_s: Optional[float], remote: bool = False) -> None:
        """Admit-queue shedding, BEFORE the request costs any device work:
        the HBM-pressure watermark (while the ledger is latched over its
        high watermark: the reclaim ladder's last rung), an explicit queue
        cap, and the deadline-aware rule (expected queue wait = depth /
        observed completion rate > remaining budget). ``remote`` selects
        the pressure refusal's type: a local submit sheds with
        ``ShedError`` (429 + Retry-After), a remote admit refuses with
        ``PressureRefused`` (503 + Retry-After), so a decode pool under
        pressure pushes back before a slab crosses the wire."""
        pc = self._pressure
        if pc.budget_bytes > 0 and pc.active and remote:
            self.stats["pressure_refused"] += 1
            self._note_shed("pressure", self._queue.qsize(), None)
            raise PressureRefused(
                f"decode pool over its HBM ledger high watermark ({pc.used} of "
                f"{pc.budget_bytes} bytes); refusing remote admits until reclaim "
                "reaches the low watermark",
                retry_after_s=pc.retry_after_s(),
            )
        if pc.budget_bytes > 0 and pc.active:
            self.stats["shed"] += 1
            self.stats["pressure_sheds"] += 1
            self._note_shed("pressure", self._queue.qsize(), self.observed_rate())
            raise ShedError(
                f"HBM ledger over its high watermark ({pc.used} of "
                f"{pc.budget_bytes} bytes) — admissions shed until the "
                "reclaim ladder reaches the low watermark",
                retry_after_s=pc.retry_after_s(),
            )
        depth = self._queue.qsize()
        if self.admit_queue_limit and depth >= self.admit_queue_limit:
            rate = self.observed_rate()
            self.stats["shed"] += 1
            self._note_shed("queue_full", depth, rate)
            raise ShedError(
                f"admit queue full ({depth} >= {self.admit_queue_limit})",
                retry_after_s=(depth / rate) if rate else 1.0,
            )
        if deadline_s is None or depth == 0:
            return
        rate = self.observed_rate()
        if rate is None:
            return
        est_wait = depth / rate
        if est_wait > deadline_s:
            self.stats["shed"] += 1
            self._note_shed("deadline", depth, rate)
            raise ShedError(
                f"deadline {deadline_s * 1000:.0f}ms below estimated queue "
                f"wait {est_wait * 1000:.0f}ms ({depth} queued at "
                f"{rate:.2f} req/s) — shed before work",
                retry_after_s=est_wait,
            )

    def _note_shed(self, reason: str, depth: int, rate: Optional[float]) -> None:
        """A shed decision's flight record (on the submitting thread)."""
        self._flight({"type": "shed", "reason": reason, "queue": depth,
                      "rate_per_s": round(rate, 3) if rate else None})

    def generate(self, tokens, **kw) -> List[int]:
        """Blocking convenience: submit and wait for the generated ids."""
        return self.submit(tokens, **kw).result()

    def _enqueue(self, req: GenRequest) -> Future:
        """Queue a built request and make sure the loop serves it."""
        req.future.gen_request = req
        self._queue.put(req)
        if self._stop.is_set():
            # the loop died between the entry check and the put: fail the
            # stranded queue here instead of leaving the future unresolved
            self._drain_queue(self._dead_error())
            return req.future
        self.start()
        return req.future

    # -- live-lane migration (graceful drain, checkpoint resume) -------------

    def drain(self, timeout_s: float = 30.0) -> List[GenRequest]:
        """Graceful drain: checkpoint every live lane at the next poll
        boundary (emitted tokens and post-split lane key, not the K/V),
        refuse new work (``health = "draining"``, 503) and return every
        request this batcher still owes an answer: checkpointed lanes
        (``req.resume`` set), chunked admissions (requeued whole), the
        resume queue and the admit queue. Their futures stay pending for
        the caller to settle (``GenerateServer.drain_to``).

        A dead or closed member has nothing to drain: :class:`BatcherDead`
        propagates. A drain that outruns ``timeout_s`` is cancelled: the
        scheduler keeps the work and restores ``health = "serving"``."""
        self._check_alive()
        with self._drain_lock:
            if self._pending_drain is not None:
                raise RuntimeError("a drain is already in progress")
            # re-check under the lock: the supervisor writes the dead
            # latch without it, and "draining" must never overwrite it
            if self._stop.is_set() or self.health in ("dead", "closed"):
                raise self._dead_error()
            # refuse admissions now: a request admitted after this line
            # would miss the checkpoint sweep
            self.health = "draining"
            job = _DrainJob()
            self._pending_drain = job
        self.start()
        try:
            return job.future.result(timeout=timeout_s)
        except FuturesTimeout:
            if not job.future.cancel():
                # the scheduler is resolving it right now: take the result
                return job.future.result(timeout=5.0)
            raise RuntimeError(
                f"drain did not complete within {timeout_s}s; cancelled "
                "— admissions resume on the next poll"
            ) from None

    def submit_checkpoint(self, ck: Dict[str, Any], on_tokens=None) -> Future:
        """Admit a wire checkpoint (an SGC1 dict: a drained peer's lane or
        a client resume token) and continue the generation where it
        stopped, through :meth:`_admit_resume` (prompt K/V recompute and
        teacher-forced replay of the emitted tokens): greedy and seeded
        streams equal an uninterrupted run's, and crediting continues
        after the checkpoint (delivered spans are never re-sent).

        Refusals, before any lane state exists: a checkpoint of another
        ``weight_version`` raises :class:`~.disagg.WeightVersionMismatch`
        (409), over-long prompts and budgets the 413s ``submit`` raises.
        The checkpoint's wait anchor re-bases ``submit_t``, so the
        queue-wait sample spans both members."""
        self._check_alive()
        wv = ck.get("weight_version")
        if wv is not None and wv != self.weight_version:
            raise WeightVersionMismatch(
                f"checkpoint was taken under weight_version {wv!r} but this member "
                f"serves {self.weight_version!r} — its emitted prefix is not "
                "reproducible here"
            )
        tokens = [int(t) for t in ck.get("prompt") or []]
        if not tokens:
            raise ValueError("checkpoint carries no prompt tokens")
        if len(tokens) >= self.max_seq:
            raise PromptTooLong(
                f"checkpoint prompt of {len(tokens)} exceeds max_seq {self.max_seq}")
        mnt = int(ck.get("max_new_tokens", 32))
        self._check_budget(len(tokens), mnt)
        emitted = [int(t) for t in ck.get("emitted") or []]
        if len(emitted) > mnt:
            raise ValueError(
                f"checkpoint emitted {len(emitted)} tokens past its max_new_tokens {mnt}")
        req = GenRequest(
            tokens=tokens,
            max_new_tokens=mnt,
            temperature=float(ck.get("temperature", 0.0)),
            eos_id=ck.get("eos_id"),
            seed=int(ck.get("seed", 0)),
            on_tokens=on_tokens,
        )
        now = time.monotonic()
        # cumulative queue-wait anchor: the source member's wait rides
        # the checkpoint
        req.submit_t = now - max(0.0, float(ck.get("wait_s") or 0.0))
        req.submit_wall_us = int(ck.get("submit_wall_us") or 0) or wall_us(req.submit_t)
        dl = ck.get("deadline_s")
        if dl is not None:
            req.deadline_t = now + max(0.0, float(dl))
        with self._export_lock:
            self.stats["migrated_resumes"] += 1
        self._flight({"type": "migrated_resume", "tokens": len(tokens),
                      "emitted": len(emitted), "weight_version": self.weight_version})
        if emitted and (len(emitted) >= mnt
                        or (req.eos_id is not None and emitted[-1] == req.eos_id)):
            # already complete (a final-state resume token): answer on the
            # host; re-admitted it would append one overshoot token
            req.future.gen_request = req
            req.future.set_result(tokens + emitted)
            return req.future
        if emitted:
            key = ck.get("rng_key")
            if key is None:
                # crash tokens ship keyless: re-derive the lane key from
                # the deterministic split chain
                from .migration import derive_lane_key

                key = derive_lane_key(req.seed, len(emitted))
            req.resume = {"emitted": emitted, "key": [int(k) for k in key]}
        return self._enqueue(req)

    # -- live weight swap ----------------------------------------------------

    def request_weight_swap(self, params, version=None) -> Future:
        """Stage a live weight swap; the Future resolves to the new weight
        version once the scheduler flips.

        Thread-safe, under traffic. The new params are cast to the
        serving dtype, checked leaf for leaf against the served set
        (``params_swappable``: same tree, shapes and dtypes, or refused
        here) and staged on the device next to it (a side stream from
        pinned memory on the card, so the upload overlaps serving). The
        scheduler then holds admissions while every in-flight lane,
        chunked admission and burst finishes on the OLD weights, copies
        the staged leaves into the served tensors at the poll boundary
        where nothing is in flight (the decode-burst CUDA graphs keep
        reading the same addresses), bumps ``weight_version``, purges
        the prefix cache and host tier by version and resumes admissions
        on the new weights. The served tensors are the ones the
        constructor was given (cast where they were float32 and the
        model is not): a caller that keeps a reference to those sees the
        new weights after the flip."""
        from ..models.llm import DecoderLM

        self._check_alive()
        if self.speculate_tokens > 0:
            raise RuntimeError(
                "weight hot-swap is not supported with speculative decoding "
                "(the draft shares or derives from the served params)"
            )
        params = _cast_tree(params, self.model.dtype)
        check = getattr(self.model, "params_swappable", DecoderLM.params_swappable)
        ok, why = check(self.params, params)
        if not ok:
            raise ValueError(f"weight hot-swap rejected: {why}")
        # fail before the upload when the conflict is already known
        self._swap_version(version)
        staged = self._stage_params(params)
        with self._swap_lock:
            auto, version = version is None, self._swap_version(version)
            if auto:
                self._swap_seq = version
            job = _SwapJob(params=staged, version=version, nbytes=_tree_bytes(staged),
                           staged_t=time.monotonic())
            self._pending_swap = job
        # the loop must run to flip, traffic or not
        self.start()
        return job.future

    def _swap_version(self, version):
        """The version a new swap takes (an auto sequence number unless
        given), refusing a second pending swap and the served version
        (version-keyed prefix slabs of the old weights would match)."""
        if self._pending_swap is not None:
            raise RuntimeError("a weight swap is already pending")
        if version is None:
            seq = self._swap_seq + 1
            return seq + 1 if seq == self.weight_version else seq
        if version == self.weight_version:
            raise ValueError(
                f"weight swap version {version!r} is already the served version; "
                "pick a new version id"
            )
        return version

    def _stage_params(self, params):
        """The swap's params on the batcher's device: leaves already there
        are kept, the others uploaded (on the card from pinned memory on a
        side stream, waited for here, on the caller's thread)."""
        dev = self.device

        def up(t):
            return t if t.device == dev else t.pin_memory().to(dev, non_blocking=True)

        if dev.type != "cuda":
            return _map_tree(params, lambda t: t.to(dev))
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            staged = _map_tree(params, up)
        stream.synchronize()
        return staged

    def swap_pending(self) -> bool:
        """Whether a staged weight swap awaits its flip (callers about to
        load a checkpoint can fail fast; the authoritative check stays in
        :meth:`request_weight_swap`)."""
        return self._pending_swap is not None

    def cancel_weight_swap(self) -> bool:
        """Abort a staged swap that has not flipped; admissions resume on
        the next poll. True when one was cancelled."""
        with self._swap_lock:
            swap, self._pending_swap = self._pending_swap, None
        if swap is None:
            return False
        if not swap.future.done():
            swap.future.set_exception(RuntimeError("weight swap cancelled before the flip"))
        return True

    def _fail_pending_swap(self, err: Exception) -> None:
        with self._swap_lock:
            swap, self._pending_swap = self._pending_swap, None
        if swap is not None and not swap.future.done():
            swap.future.set_exception(err)

    def _fail_pending_drain(self, err: Exception) -> None:
        with self._drain_lock:
            job, self._pending_drain = self._pending_drain, None
        if job is not None and not job.future.done():
            job.future.set_exception(err)

    # -- live retune ---------------------------------------------------------

    # knobs retune() accepts; every other knob (slots, steps_per_poll,
    # speculate_tokens, the cache geometry) would need other graphs or
    # other device state and is refused typed
    RETUNABLE_KNOBS = (
        "fused_steps_per_dispatch", "depth_groups",
        "depth_group_split_bytes", "prefill_chunk", "pipeline_depth",
        "admit_queue_limit", "pressure_high", "pressure_low",
    )

    def retune_census(self) -> Dict[str, Any]:
        """The boot census a retune is validated against: the fused Ks
        the captured step graphs serve, whether group-burst graphs exist,
        the one chunk size ``warm()`` ran, and the pipeline depth its
        attention buckets cover."""
        return dict(self._retune_census)

    def serving_config(self) -> Dict[str, Any]:
        """The CURRENT values of the profile-grid knobs (the JAX
        package's ``planning/artifact.py`` CONFIG_KEYS); unlike the
        census they move with every applied retune."""
        return {
            "slots": int(self.slots),
            "prefill_chunk": int(self.prefill_chunk or 0),
            "fused_steps_per_dispatch": int(self.fused_steps_per_dispatch or 0),
            "depth_groups": int(self.depth_groups or 0),
            "depth_group_split_bytes": int(self._group_split_bytes or 0),
            "kv_tier_bytes": int(getattr(self._kv_tier, "budget_bytes", 0) or 0),
        }

    def retune(self, origin: str = "planner", **knobs) -> Future:
        """Stage a live retune of scheduler knobs; the Future resolves to
        ``{knob: [old, new]}`` for the knobs that changed once the
        scheduler applies the job at the top of a poll (a
        ``prefill_chunk`` change once no chunked prefill is in flight).

        Thread-safe, under traffic. Every retunable knob already keeps
        tokens unchanged on vs off (fused decode, depth groups, chunked
        prefill, pressure, admission caps), so a retuned batcher emits
        what one booted with the new values emits. Validation runs here,
        typed (:class:`RetuneError`), before anything is staged: a fused
        K outside the census, depth groups on a member booted without
        group graphs, a chunk size ``warm()`` did not run, or a pipeline
        deeper than its attention buckets cover, so no retune ever
        captures a graph."""
        self._check_alive()
        if not knobs:
            raise RetuneError("retune called with no knobs")
        unknown = set(knobs) - set(self.RETUNABLE_KNOBS)
        if unknown:
            raise RetuneError(
                f"unknown/unretunable knob(s) {sorted(unknown)}; "
                f"retunable: {list(self.RETUNABLE_KNOBS)}"
            )
        census = self._retune_census
        target: Dict[str, Any] = {}

        def _int(name, lo=0):
            try:
                v = int(knobs[name])
            except (TypeError, ValueError):
                raise RetuneError(f"{name} must be an int, got {knobs[name]!r}") from None
            if v < lo:
                raise RetuneError(f"{name} must be >= {lo}, got {v}")
            return v

        if "fused_steps_per_dispatch" in knobs:
            raw = _int("fused_steps_per_dispatch")
            fk = _pow2_floor(raw) if raw > 0 else 0
            if fk > 0 and self.speculate_tokens:
                raise RetuneError(
                    "fused decode cannot be enabled under speculative decoding "
                    "(no fused graphs exist in spec mode)"
                )
            if fk > 0 and fk not in census["fused_ks"]:
                raise RetuneError(
                    f"fused_steps_per_dispatch={raw} (pow2 floor {fk}) is outside the "
                    f"boot census {list(census['fused_ks'])}; only warmed Ks (or 0) "
                    "can be retuned to"
                )
            target["fused_steps_per_dispatch"] = (raw, fk)
        if "depth_groups" in knobs:
            dg = _int("depth_groups")
            if dg > 1 and census["depth_groups"] <= 1:
                raise RetuneError(
                    "depth_groups>1 requires group-burst graphs, which warm() only "
                    "captures when the member boots with depth_groups>1"
                )
            target["depth_groups"] = dg
        if "depth_group_split_bytes" in knobs:
            # a host-side cost-model price: no graph depends on it
            target["depth_group_split_bytes"] = _int("depth_group_split_bytes")
        if "prefill_chunk" in knobs:
            pc = _int("prefill_chunk")
            if pc not in (0, census["prefill_chunk"]):
                raise RetuneError(
                    f"prefill_chunk={pc} was not prepared by warm(); census allows "
                    f"0 or {census['prefill_chunk']}"
                )
            target["prefill_chunk"] = pc
        if "pipeline_depth" in knobs:
            pd = _int("pipeline_depth", lo=1)
            if pd > census["pipeline_depth"]:
                raise RetuneError(
                    f"pipeline_depth={pd} exceeds the warmed depth "
                    f"{census['pipeline_depth']} (warm()'s attention buckets only "
                    "cover the boot depth)"
                )
            target["pipeline_depth"] = pd
        if "admit_queue_limit" in knobs:
            target["admit_queue_limit"] = _int("admit_queue_limit")
        if "pressure_high" in knobs or "pressure_low" in knobs:
            try:
                high = float(knobs.get("pressure_high", self._pressure.high_frac))
                low = float(knobs.get("pressure_low", self._pressure.low_frac))
            except (TypeError, ValueError):
                raise RetuneError("pressure watermarks must be floats") from None
            if not 0.0 < high <= 1.0:
                raise RetuneError(f"pressure_high {high} not in (0, 1]")
            if not 0.0 < low <= high:
                raise RetuneError(f"pressure_low {low} must be in (0, high={high}]")
            target["pressure_high"] = high
            target["pressure_low"] = low
        with self._retune_lock:
            if self._pending_retune is not None:
                raise RetuneError("a retune is already pending")
            job = _RetuneJob(knobs=target, origin=str(origin))
            self._pending_retune = job
        # the loop must run to apply the job, traffic or not
        self.start()
        return job.future

    def _do_retune(self, job: _RetuneJob) -> None:
        """Apply a staged retune (scheduler thread, top of a poll), under
        ``_retune_lock`` so that :meth:`cancel_retune` lands wholly before
        or after. A ``prefill_chunk`` change waits while chunked prefills
        are in flight: their slabs and offsets follow the old size."""
        with self._retune_lock:
            if self._pending_retune is not job:
                return
            new_pc = job.knobs.get("prefill_chunk")
            if new_pc is not None and new_pc != self.prefill_chunk and self._chunked:
                job.waited_polls += 1
                return
            changed: Dict[str, List[Any]] = {}
            attrs = {
                "depth_groups": (self, "depth_groups"),
                "depth_group_split_bytes": (self, "_group_split_bytes"),
                "prefill_chunk": (self, "prefill_chunk"),
                "pipeline_depth": (self, "pipeline_depth"),
                "admit_queue_limit": (self, "admit_queue_limit"),
                "pressure_high": (self._pressure, "high_frac"),
                "pressure_low": (self._pressure, "low_frac"),
            }
            for name, val in job.knobs.items():
                if name == "fused_steps_per_dispatch":
                    raw, fk = val
                    if self._fused_k != fk:
                        changed[name] = [self._fused_k, fk]
                        # the device's stop/budget registers re-upload
                        # before the next fused dispatch
                        self._fused_sync = False
                    self.fused_steps_per_dispatch = raw
                    self._fused_k = fk
                    continue
                obj, attr = attrs[name]
                old = getattr(obj, attr)
                if old != val:
                    changed[name] = [old, val]
                setattr(obj, attr, val)
            self.stats["planner_retunes"] += 1
            self._flight({
                "type": "planner_retune", "origin": job.origin,
                "changed": changed, "waited_polls": job.waited_polls,
            })
            self._pending_retune = None
        if changed:
            logger.info(
                "planner retune (%s): %s (deferred %d polls)", job.origin,
                ", ".join(f"{k} {o!r}->{n!r}" for k, (o, n) in changed.items()),
                job.waited_polls,
            )
        if not job.future.done():
            job.future.set_result(changed)

    def cancel_retune(self) -> bool:
        """Abort a staged retune before its poll boundary. True when one
        was cancelled."""
        with self._retune_lock:
            job, self._pending_retune = self._pending_retune, None
        if job is None:
            return False
        if not job.future.done():
            job.future.set_exception(RetuneError("retune cancelled before the poll boundary"))
        return True

    # -- disaggregated serving (prefill/decode pools, KV-slab handoff) ------

    @property
    def _slab_token_bytes(self) -> int:
        """K+V bytes one prompt position occupies across every layer --
        the unit the transfer-dedup accounting is priced in."""
        return self._kv_key_bytes

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """Device tensor -> contiguous host copy (pinned on CUDA, so the
        pull runs at the copy engine's rate)."""
        if t.device.type != "cuda":
            return t.contiguous()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
        return out

    @torch.no_grad()
    def export_prefill(
        self,
        tokens: Sequence[int],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        seed: int = 0,
        covered_len: int = 0,
    ):
        """PREFILL-side half of disaggregation: run the prompt forward and
        return ``(meta, slab)`` -- the host ``[L, 1, KV, W, Dh]`` K/V
        stack plus what a decode pool needs to splice it as a remote lane
        insert (first sampled token, post-split lane key, weight version,
        sampling params). Never needs the scheduler loop, which a
        prefill-role server does not run.

        With ``prefill_chunk`` set and a bucket longer than one chunk the
        slab is built chunk by chunk in a staging slab exactly as an
        interleaved admission builds it; otherwise the bucketed
        whole-prompt prefill makes it in one forward. The first token is
        sampled here as an admission samples it, so disaggregated streams
        are the unified ones.

        ``covered_len`` > 0 (the decode side's radix cache already holds
        that many leading tokens) slices the transfer down to the suffix
        columns; the K/V is still computed here whole."""
        self._check_alive()
        n = len(tokens)
        if not n:
            raise ValueError("empty prompt")
        if n >= self.max_seq:
            raise PromptTooLong(f"prompt of {n} exceeds max_seq {self.max_seq}")
        self._check_budget(n, max_new_tokens)
        tokens = [int(t) for t in tokens]
        seed = int(seed)
        bucket = self._bucket(n)
        covered = max(0, min(int(covered_len), n - 1))
        C = self.prefill_chunk
        chunks = 0
        if C and bucket > C:
            slab = self._new_slab(bucket)
            start = 0
            while True:
                is_last = start + C >= n
                s0 = max(0, min(start, bucket - C)) if is_last else start
                end = min(s0 + C, n)
                buf = np.zeros((1, C), np.int64)
                buf[0, : end - s0] = tokens[s0:end]
                attn_len = min(bucket, self._attn_need(s0 + C))
                with self._prof.measure("chunk_prefill", variant=f"b{bucket}",
                                        bytes_read=self._rb("chunk_prefill", tokens=C),
                                        tokens=C), device_trace("gen.prefill_chunk"):
                    out = self._chunk_step(slab, buf, s0, n - 1 - s0, seed,
                                           float(temperature), attn_len, is_last)
                chunks += 1
                if is_last:
                    break
                start = end
            first, key = out
        else:
            prompt = np.zeros((1, bucket), np.int64)
            prompt[0, :n] = tokens
            with self._prof.measure("prefill", variant=f"p{bucket}",
                                    bytes_read=self._rb("prefill", tokens=bucket),
                                    tokens=bucket), device_trace("gen.prefill"):
                first, slab, key = self._prefill(
                    prompt, np.asarray([n - 1], np.int64), [seed], [float(temperature)])
        # the host pull IS the export (the slab must cross a transport):
        # the whole slab when the tier publishes it, else only the
        # columns the decode side lacks
        cut = 0 if self._kv_tier is not None else covered
        host = {name: self._to_host(slab[name][:, :, :, cut:]) for name in ("k", "v")}
        if self._kv_tier is not None:
            # the whole prompt slab is host-side already: publishing it
            # costs one SKV1 encode and makes this member's KV port answer
            # peer prefix lookups for the prompt
            if self._kv_tier.put_prefix(tokens, host, self.weight_version):
                self._flight({
                    "type": "kv_demote", "kind": "prefix", "source": "export",
                    "tokens": n, "phash": prompt_hash(tokens)[:8],
                    "bytes": sum(t.numel() * t.element_size() for t in host.values()),
                })
            if covered:
                host = {name: t[:, :, :, covered:] for name, t in host.items()}
        meta = {
            "tokens": tokens,
            "prompt_hash": prompt_hash(tokens),
            "n_tokens": n,
            "bucket": bucket,
            "covered_len": covered,
            "layout": "cache_one",
            "first_token": int(first.reshape(-1)[0]),
            "rng_key": [int(x) for x in key.reshape(-1).tolist()],
            "weight_version": self.weight_version,
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "eos_id": eos_id,
            "seed": seed,
        }
        nbytes = sum(t.numel() * t.element_size() for t in host.values())
        with self._export_lock:
            self.stats["kv_exports"] += 1
            self.stats["kv_export_bytes"] += nbytes
            self.stats["prefill_steps"] += max(1, chunks)
            self.stats["prefill_tokens"] += chunks * C if chunks else bucket
            self.stats["prefill_chunks"] += chunks
            # kv_transfer_bytes_saved is counted on the decode side only
            # (the pool whose radix cache made the dedup decision)
        self._flight({
            "type": "kv_export", "tokens": n, "bucket": bucket,
            "covered_len": covered, "bytes": nbytes, "chunks": chunks,
            "weight_version": self.weight_version,
        })
        return meta, host

    def remote_covered_len(self, tokens: Sequence[int]) -> int:
        """DECODE-side consult before requesting a remote prefill: the
        longest locally cached prefix usable as the transfer-dedup base
        (0 = ask for the full slab), under the same caps as a local
        prefix-cache admit, so a nonzero answer is one admit_remote can
        splice."""
        if self._prefix_index is None:
            return 0
        tokens = [int(t) for t in tokens]
        n = len(tokens)
        m, slab = self._prefix_index.match(tokens)
        m = min(m, n - 1)
        if slab is None or m < self.prefix_cache_min_tokens:
            return 0
        if slab["k"].shape[3] > self._bucket(n):
            return 0  # donor wider than the prompt bucket: not a win
        return m

    def admit_remote(self, slab: Dict[str, Any], meta: Dict[str, Any], on_tokens=None,
                     deadline_s: Optional[float] = None) -> Future:
        """DECODE-side half of disaggregation: validate a shipped slab
        message and queue it as a remote lane insert, spliced by the
        scheduler thread through the same inserts an ordinary admission
        uses (the upload too runs there, from the decoded pinned host
        tensors), so decode after a remote admit is the unified path's.

        Every refusal is typed and happens BEFORE any lane state exists:
        ``WeightVersionMismatch`` (409) for another weight version,
        ``DisaggError`` for a hash, layout, shape, dtype or first-token
        fault, ``PressureRefused`` (503) while the ledger is latched, and
        ``PrefixGone`` for a suffix-only slab without a local donor (at
        insert time too, when the donor was evicted meanwhile; the caller
        re-requests the full slab). Returns the request Future, exactly
        like :meth:`submit`."""
        self._check_alive()
        if self.speculate_tokens > 0:
            raise DisaggError(
                "remote admits are not supported with speculative decoding "
                "(the draft cache has no prefix for the lane)"
            )
        tokens = [int(t) for t in meta.get("tokens") or []]
        if not tokens:
            raise DisaggError("slab meta carries no prompt tokens")
        n = len(tokens)
        if n >= self.max_seq:
            raise DisaggError(f"remote prompt of {n} exceeds max_seq {self.max_seq}")
        self._check_budget(n, meta.get("max_new_tokens", 32))
        if meta.get("prompt_hash") and meta["prompt_hash"] != prompt_hash(tokens):
            raise DisaggError("slab prompt hash mismatch — corrupt meta")
        if meta.get("layout", "cache_one") != "cache_one":
            raise DisaggError(f"unsupported slab layout {meta.get('layout')!r}")
        if meta.get("weight_version") != self.weight_version:
            raise WeightVersionMismatch(
                f"slab prefilled under weight_version {meta.get('weight_version')!r} "
                f"but this decode pool serves {self.weight_version!r}"
            )
        covered = max(0, int(meta.get("covered_len", 0)))
        if covered and self._prefix_index is None:
            raise PrefixGone(
                "suffix-only slab but this decode pool runs no prefix cache — "
                "re-request with covered_len=0"
            )
        self._shed_check(deadline_s, remote=True)
        cfg = self.model.cfg
        k, v = slab["k"], slab["v"]
        bucket = self._bucket(n)
        want = (cfg.n_layers, 1, cfg.n_kv_heads, bucket - covered, cfg.head_dim)
        if tuple(k.shape) != want or tuple(v.shape) != want:
            raise DisaggError(
                f"slab shape {tuple(k.shape)} does not match the serving model's "
                f"{want} (prompt {n} -> bucket {bucket}, covered {covered})"
            )
        if k.dtype != self.model.dtype or v.dtype != self.model.dtype:
            raise DisaggError(
                f"slab dtype {k.dtype} vs serving dtype {self.model.dtype} — "
                "prefill and decode pools must share a dtype"
            )
        if meta.get("first_token") is None:
            raise DisaggError("slab meta carries no first_token")
        # the JAX-format key is two uint32 words; the lane key registers
        # hold each word in an int64, so the conversion is exact
        key = [int(x) for x in meta.get("rng_key", [0, 0])]
        if len(key) != 2 or not all(0 <= x <= 0xFFFFFFFF for x in key):
            raise DisaggError(f"slab rng_key {key!r} is not two uint32 words")
        seed = int(meta.get("seed", 0))
        req = GenRequest(
            tokens=tokens,
            max_new_tokens=int(meta.get("max_new_tokens", 32)),
            temperature=float(meta.get("temperature", 0.0)),
            eos_id=meta.get("eos_id"),
            seed=seed,
            on_tokens=on_tokens,
        )
        req.submit_t = time.monotonic()
        if deadline_s is not None:
            req.deadline_t = req.submit_t + float(deadline_s)
        req.cache_hit_tokens = covered
        req.remote = {
            "slab": {"k": k, "v": v},
            "first": int(meta["first_token"]),
            "key": key,
            "covered": covered,
            "nbytes": k.numel() * k.element_size() + v.numel() * v.element_size(),
            "version": meta.get("weight_version"),
        }
        req.future.gen_request = req
        self._queue.put(req)
        if self._stop.is_set():
            self._drain_queue(self._dead_error())
            return req.future
        self.start()
        return req.future

    @torch.no_grad()
    def _admit_remote_lane(self, slot: int, req: GenRequest) -> None:
        """Splice a shipped prefill slab into ``slot`` (scheduler thread).
        No prefill runs here: the slab carries the prompt K/V and the
        first token. A full slab goes through the ordinary insert, a
        suffix-only slab re-matches the local radix index and goes
        through the prefix splice, so decode state after a remote admit
        is the unified path's."""
        r = req.remote
        n = len(req.tokens)
        req.admit_t = time.monotonic()
        if r["version"] != self.weight_version:
            raise WeightVersionMismatch(
                f"weights changed mid-handoff: slab is {r['version']!r}, "
                f"serving {self.weight_version!r}"
            )
        covered = r["covered"]
        donor = None
        if covered:
            m, donor = self._prefix_index.match(req.tokens)
            if donor is None or m < covered:
                raise PrefixGone(
                    f"cached prefix covers {m} tokens but the slab assumes {covered} "
                    "— donor evicted mid-handoff; re-request with covered_len=0"
                )
        dev = {name: self._to_dev(t) for name, t in r["slab"].items()}
        first = self._to_dev(np.asarray([r["first"]], np.int64))
        key = self._to_dev(np.asarray([r["key"]], np.int64))
        b = self._bucket(n)
        with self._prof.measure("insert", variant=f"px{b}" if covered else f"b{b}",
                                tenant=req.tenant or "",
                                bytes_read=self._rb("insert", tokens=b),
                                tokens=n), device_trace("gen.lane_insert"):
            if covered:
                self._insert_prefix(donor, dev, slot, covered, first, n, key)
            else:
                self._insert(dev, [slot], first, [n], key)
        if covered:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_saved"] += covered
        elif self._prefix_index is not None:
            self.stats["prefix_misses"] += 1
        self._active[slot] = _Slot(request=req)
        self._pos_host[slot] = n
        self._masks_dirty = True
        self.stats["admitted"] += 1
        self.stats["kv_imports"] += 1
        self.stats["kv_import_bytes"] += r["nbytes"]
        if covered:
            self.stats["kv_transfer_bytes_saved"] += covered * self._slab_token_bytes
        self._flight({
            "type": "remote_insert", "lane": slot, "tokens": n,
            "covered_len": covered, "bytes": r["nbytes"],
            "weight_version": self.weight_version,
        })
        # the slab is spliced: drop the host reference (a pinned buffer
        # returns to the host allocator once its copy has run)
        req.remote = None

    def start(self) -> None:
        if self._stop.is_set():
            raise BatcherDead(
                "batcher is closed" if self.health == "closed"
                else "continuous batcher is dead; see server log",
                retry_after_s=5.0,
            )
        with self._thread_lock:
            # two racing submits must not spawn two scheduler threads
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="continuous-batcher", daemon=True
                )
                self._thread.start()
        self._started.wait()

    def slo_summary(self) -> Optional[Dict[str, Any]]:
        """Percentile summary (ms) of the recent completed-request SLO
        reservoir -- queue wait, TTFT, TPOT -- in the JAX package's shape
        (``tools/flight_report.py`` reads it). None until a request
        completes; single-token completions have no TPOT."""
        samples = list(self.slo_recent)
        if not samples:
            return None

        def pct(vals: List[float]) -> Dict[str, float]:
            vals = sorted(vals)
            n = len(vals)
            return {
                "p50_ms": round(vals[n // 2] * 1e3, 3),
                "p99_ms": round(vals[min(n - 1, int(n * 0.99))] * 1e3, 3),
                "mean_ms": round(sum(vals) / n * 1e3, 3),
            }

        tpots = [r[2] for r in samples if r[2] is not None]
        return {
            "samples": len(samples),
            "queue_wait_ms": pct([r[0] for r in samples]),
            "ttft_ms": pct([r[1] for r in samples]),
            "tpot_ms": pct(tpots) if tpots else None,
        }

    def warm(
        self,
        prompt_lens: Sequence[int] = (),
        max_new_tokens: int = 0,
        batch_sizes: Sequence[int] = (1, 4, 8),
    ) -> None:
        """Run every prefill, chunk and insert variant the declared traffic
        shape will use once, and capture every decode-burst phase it can
        reach, before traffic: on CUDA this builds the flash kernel,
        initialises the matmul libraries, grows the memory pool and
        records the decode graphs, so the first admission wave neither
        stalls nor captures. Call before the first submit (the server's
        warmup-before-listen phase). Warm writes into the live cache;
        lanes tolerate residue because every position a lane reads is
        rewritten by its occupant first."""
        self._warm_args = {
            "prompt_lens": tuple(prompt_lens),
            "max_new_tokens": int(max_new_tokens),
            "batch_sizes": tuple(batch_sizes),
        }
        buckets = sorted({self._bucket(min(p, self.max_seq)) for p in prompt_lens})
        if not buckets:
            buckets = [self.prefill_buckets[0]]
        # per-poll advance: a fused dispatch advances up to fused_steps,
        # and its adaptive K shrinks to the poll burst at the least (a
        # configured draft keeps the fused plan off). The boot census's
        # K, so that a rebuild after a retune still prepares every K a
        # retune may return to
        fused_k = 0 if self.speculate_tokens else max(
            self._retune_census["fused_ks"], default=0)
        adv = max(self._k, fused_k)
        least = min(self._k, fused_k) if fused_k else self._k
        attn_lens = self._warm_attn_lens(prompt_lens, max_new_tokens, adv, least)
        lo = min(prompt_lens) if prompt_lens else 1
        for bucket in buckets:
            for m in batch_sizes:
                if m > self.slots:
                    continue  # a wave can never exceed the lane pool
                if m == 8 and not self._chunk8_ok(bucket):
                    continue
                if m > 1 and self.speculate_tokens:
                    continue  # speculation admits one request at a time
                prompts = np.zeros((m, bucket), np.int64)
                last = np.zeros((m,), np.int64)
                firsts, slab, keys = self._prefill(prompts, last, [0] * m, [0.0] * m)
                self._insert(slab, list(range(m)), firsts, last + 1, keys)
                if self.speculate_tokens:
                    self._draft_admit_tokens(0, [0] * bucket)
        C = self.prefill_chunk
        for bucket in buckets:
            if not C or bucket <= C:
                continue
            # one run per (chunk offset, last or not) the declared buckets
            # reach: a shorter prompt of the bucket ends at an earlier offset
            slab = self._new_slab(bucket)
            for start in range(0, bucket, C):
                start = min(start, bucket - C)
                attn_len = min(bucket, self._attn_need(start + C))
                for is_last in (False, True):
                    self._chunk_step(slab, np.zeros((1, C), np.int64), start,
                                     C - 1, 0, 0.0, attn_len, is_last)
        pressure = self._pressure.budget_bytes > 0 or self.pressure_hook is not None
        if self.speculate_tokens:
            # a spec burst reads the bucket of the deepest lane's end of
            # burst, k * (gamma + 1) positions on, whole-batch
            spec_adv = self._k * (self.speculate_tokens + 1)
            self._warm_spec(self._warm_attn_lens(prompt_lens, max_new_tokens,
                                                 spec_adv, spec_adv))
        if not self.speculate_tokens or pressure:
            # with a draft, the plain bursts are what lanes decode with
            # while rung 2 has cancelled speculation
            self._warm_bursts(attn_lens)
        # a resume (a preempted lane, a migrated checkpoint, a resume
        # token, a swap straggler) replays at the bucket of its lane's end
        # position, which can lie at any bucket from the shallowest prompt
        # up: any member may receive one (an MoE lane replays alone,
        # eagerly: see _replay_emitted)
        if not self.model.cfg.n_experts:
            self._warm_replay(sorted(set(attn_lens) | {self._attn_need(lo)}))
        if self._kv_tier is not None:
            # a preemption spills a lane at its attention width and the
            # copy-back inserts a slab of that width: run the extract and
            # the insert once at every width a lane can spill at
            hi = max(attn_lens) if attn_lens else self._attn_need(lo)
            widths = sorted({self._attn_need(p) for p in range(max(1, lo), hi + 1)})
            zero = self._to_dev(np.zeros((1,), np.int64))
            key0 = self._to_dev(np.zeros((1, 2), np.int64))
            for w in widths:
                self._insert(self._extract_prefix(0, w), [0], zero, [w], key0)
            self._warm_tier_widths = widths
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # warm left garbage in the lane registers: reset them
        self._reset_lanes()

    def _warm_attn_lens(self, prompt_lens: Sequence[int], max_new_tokens: int,
                        adv: int, least: int) -> List[int]:
        """Attention buckets a run at these prompt lengths can touch when
        each poll advances a lane by up to ``adv`` positions (at least
        ``least``): from the shallowest lane's first burst (alone, or in
        a depth group of its own) to the deepest end of budget; an eos
        lane outlives its budget until the host reads its stop, up to
        pipeline_depth - 1 bursts of extra ``_pos_host`` advance."""
        lo = min(prompt_lens) if prompt_lens else 1
        hi = (
            (max(prompt_lens) if prompt_lens else 1)
            + int(max_new_tokens)
            + adv * (1 + max(0, self._retune_census["pipeline_depth"] - 1))
        )
        return sorted(
            {self._attn_need(p) for p in range(lo + least, hi + 1, self.attn_bucket)}
            | {self._attn_need(hi)}
        )

    def _warm_spec(self, attn_lens: Sequence[int]) -> None:
        """Capture (on the card) or run once (on the CPU) the spec burst at
        every attention bucket, greedy-only and stochastic: the JAX
        package compiles its stochastic variant at first use, here both
        exist before traffic. Every lane idle."""
        w = self._whole
        w.act.zero_()
        w.temps.zero_()
        for attn_len in attn_lens:
            for stoch in (False, True):
                key = ("spec", attn_len, stoch)
                fn = lambda a=attn_len, st=stoch: self._spec_burst(a, st)  # noqa: E731
                if self._graphs is None:
                    with torch.inference_mode():
                        fn()
                elif key not in self._graphs.graphs:
                    self._graphs.capture(key, fn, warm_first=True)

    def _warm_bursts(self, attn_lens: Sequence[int]) -> None:
        """Every decode-burst phase key reachable at these attention
        buckets: the one step kind this configuration dispatches (masked
        when fused decode is on), greedy and sampled, over the whole
        batch and, with depth groups, every group size. On the card each
        key is run once and captured; on the CPU each phase runs once."""
        masked = self._masked_steps
        w = self._whole
        w.act.zero_()
        w.temps.zero_()
        for g in self._groups.values():
            g.lane_ix.copy_(torch.arange(g.act.shape[0], device=self.device))
            g.act.zero_()
        ks, vs = self._cache["k"], self._cache["v"]
        phases = [(("begin", masked), lambda: self._begin(w, masked))]
        for attn_len in attn_lens:
            for stochastic in (False, True):
                phases.append((
                    ("step", masked, "whole", attn_len, stochastic),
                    lambda a=attn_len, st=stochastic: self._step(
                        w, ks, vs, a, st, masked, self.max_seq),
                ))
                for gb, g in sorted(self._groups.items()):
                    gks, gvs = self._group_slabs(gb, attn_len)
                    if not stochastic:
                        phases += [
                            (("gather", masked, gb, attn_len),
                             lambda g=g, a=attn_len: self._gather(g, a, masked)),
                            (("scatter", masked, gb, attn_len),
                             lambda g=g, a=attn_len: self._scatter(g, a, masked)),
                        ]
                    phases.append((
                        ("step", masked, gb, attn_len, stochastic),
                        lambda g=g, a=attn_len, st=stochastic, gks=gks, gvs=gvs:
                            self._step(g, gks, gvs, None, st, masked, a),
                    ))
        for key, fn in phases:
            # each step phase runs once here: keep its token row in bounds
            for st in [w, *self._groups.values()]:
                st.row.fill_(1)
            if self._graphs is None:
                with torch.inference_mode():
                    fn()
            elif key not in self._graphs.graphs:
                self._graphs.capture(key, fn, warm_first=True)
        logger.info(
            "warm: %d decode-burst phase keys (attn buckets %s, group sizes %s, "
            "%s); %d graphs captured in %.2f s",
            len(phases), list(attn_lens), sorted(self._groups) or [self.slots],
            "fused" if masked else "plain", self.stats["graphs_captured"],
            self.stats["graph_capture_s"],
        )

    def _warm_replay(self, attn_lens: Sequence[int]) -> None:
        """Capture (on the card) or run once (on the CPU) the replay
        step at every attention bucket, with every row parked: nothing
        is written."""
        self._replay["wpos"].fill_(self.max_seq)
        for attn_len in attn_lens:
            key = ("replay", attn_len)
            fn = lambda a=attn_len: self._replay_step(a)  # noqa: E731
            if self._graphs is None:
                with torch.inference_mode():
                    fn()
            elif key not in self._graphs.graphs:
                self._graphs.capture(key, fn, warm_first=True)

    def close(self) -> None:
        if self.health != "dead":
            self.health = "closed"
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._drain_queue(self._dead_error())
        self._fail_pending_swap(self._dead_error())
        self._fail_pending_drain(self._dead_error())
        # chunked admissions still holding a reserved lane
        for job in self._chunked.values():
            if not job.request.future.done():
                job.request.future.set_exception(self._dead_error())
        self._chunked.clear()

    def _drain_queue(self, err: Exception) -> None:
        while self._resume_queue:
            try:
                req = self._resume_queue.popleft()
            except IndexError:  # raced another drainer
                break
            self._release_tier_ckpt(req)
            if not req.future.done():
                req.future.set_exception(err)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if not req.future.done():
                req.future.set_exception(err)

    # -- scheduler loop ------------------------------------------------------

    def _chunk8_ok(self, bucket: int) -> bool:
        """m=8 batched prefill only while its K/V slab stays under 4 GB."""
        cfg = self.model.cfg
        slab = 2 * cfg.n_layers * 8 * cfg.n_kv_heads * bucket * cfg.head_dim * 2
        return slab <= 4 << 30

    def _bucket(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        if n <= self.max_seq:
            return self.max_seq
        raise PromptTooLong(
            f"request of {n} tokens exceeds the largest prefill bucket "
            f"({self.prefill_buckets[-1]}) and max_seq ({self.max_seq}); "
            "raise max_seq or shorten the prompt"
        )

    def _attn_need(self, hi: int) -> int:
        """Smallest attn_bucket multiple covering position ``hi`` (clamped
        to the cache length)."""
        ab = self.attn_bucket
        return min(self.max_seq, -(-hi // ab) * ab)

    def _admit_many(self, slots: List[int], reqs: List[GenRequest], bucket: int) -> None:
        """Admit m same-bucket requests with ONE batched prefill + ONE
        insert. Nothing is read back: the first tokens stay on the device
        and ride home with the next burst."""
        m = len(reqs)
        t_admit = time.monotonic()
        prompts = np.zeros((m, bucket), np.int64)
        last = np.zeros((m,), np.int64)
        for i, req in enumerate(reqs):
            n = len(req.tokens)
            prompts[i, :n] = req.tokens
            last[i] = n - 1
        if m == 1:
            tenant = reqs[0].tenant or ""
            pv, iv, ins_tokens = f"p{bucket}", f"b{bucket}", int(last[0]) + 1
        else:
            # a wave's tenant: the one every request names, else none
            tenants = {r.tenant for r in reqs}
            tenant = (tenants.pop() or "") if len(tenants) == 1 else ""
            pv, iv, ins_tokens = f"m{m}p{bucket}", f"m{m}b{bucket}", m * bucket
        with self._prof.measure("prefill", variant=pv, tenant=tenant,
                                bytes_read=self._rb("prefill", tokens=m * bucket),
                                tokens=m * bucket), device_trace("gen.prefill"):
            firsts, slab, lane_keys = self._prefill(
                prompts, last, [r.seed for r in reqs], [r.temperature for r in reqs]
            )
        with self._prof.measure("insert", variant=iv, tenant=tenant,
                                bytes_read=self._rb("insert", tokens=m * bucket),
                                tokens=ins_tokens), device_trace("gen.lane_insert"):
            self._insert(slab, slots, firsts, last + 1, lane_keys)
        for slot, req in zip(slots, reqs):
            if self._spec_active():
                # the draft's prompt prefix, so its proposals attend over
                # the real context (a rung-2 suppression skips it: the lane
                # gets its prefix when speculation comes back)
                self._draft_admit_tokens(slot, req.tokens)
            req.admit_t = t_admit
            self._active[slot] = _Slot(request=req)
            self._pos_host[slot] = len(req.tokens)
        self._masks_dirty = True
        self.stats["admitted"] += m
        self.stats["prefill_steps"] += 1
        self.stats["prefill_tokens"] += m * bucket
        if self._prefix_index is not None:
            self.stats["prefix_misses"] += m

    def _admit_hit(self, slot: int, req: GenRequest, hit) -> None:
        """Admit one request whose prompt shares a cached prefix ``hit =
        (m, slab)``: splice the donor slab and prefill only the suffix.
        Like every admission, nothing is read back."""
        req.admit_t = time.monotonic()
        self._prompt_into_lane(slot, req, hit)
        if self._spec_active():
            # re-derived from the whole prompt: the radix pool holds only
            # the target's K/V
            self._draft_admit_tokens(slot, req.tokens)
        self._active[slot] = _Slot(request=req)
        self._pos_host[slot] = len(req.tokens)
        self._masks_dirty = True
        self.stats["admitted"] += 1

    def _prompt_into_lane(self, slot: int, req: GenRequest, hit, cont=None) -> None:
        """One request's prompt K/V into lane ``slot``: on a prefix hit
        ``(m, slab)`` the donor spliced and the suffix ``tokens[m:]``
        prefilled at its own bucket, else the whole prompt prefilled
        (m = 1). The lane is armed with the prefill's first token and
        key, or with a resume's continuation ``cont = (token [1], key
        [1, 2], position)``."""
        n = len(req.tokens)
        tenant = req.tenant or ""
        if hit is not None:
            m, slab = hit
            wb = self._bucket(n - m)
            suffix = np.zeros((1, wb), np.int64)
            suffix[0, : n - m] = req.tokens[m:]
            with self._prof.measure("prefill", variant=f"px{wb}", tenant=tenant,
                                    bytes_read=self._rb("prefill", tokens=wb),
                                    tokens=wb), device_trace("gen.prefill"):
                first, suffix_slab, key = self._prefix_prefill(
                    slab, suffix, m, n - 1 - m, req.seed, req.temperature)
            first, key, pos = cont or (first, key, n)
            with self._prof.measure("insert", variant=f"px{wb}", tenant=tenant,
                                    bytes_read=self._rb("insert", tokens=m + wb),
                                    tokens=pos), device_trace("gen.lane_insert"):
                self._insert_prefix(slab, suffix_slab, slot, m, first, pos, key)
            req.cache_hit_tokens = m
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_saved"] += m
            self.stats["prefill_tokens"] += wb
        else:
            bucket = self._bucket(n)
            prompt = np.zeros((1, bucket), np.int64)
            prompt[0, :n] = req.tokens
            with self._prof.measure("prefill", variant=f"p{bucket}", tenant=tenant,
                                    bytes_read=self._rb("prefill", tokens=bucket),
                                    tokens=bucket), device_trace("gen.prefill"):
                first, slab, key = self._prefill(prompt, np.asarray([n - 1], np.int64),
                                                 [req.seed], [req.temperature])
            first, key, pos = cont or (first, key, n)
            with self._prof.measure("insert", variant=f"b{bucket}", tenant=tenant,
                                    bytes_read=self._rb("insert", tokens=bucket),
                                    tokens=pos), device_trace("gen.lane_insert"):
                self._insert(slab, [slot], first, [pos], key)
            if self._prefix_index is not None:
                self.stats["prefix_misses"] += 1
            self.stats["prefill_tokens"] += bucket
        self.stats["prefill_steps"] += 1

    def _resolve(self, s: _Slot) -> None:
        # a trailing eos token is kept in the output. `finished` counts
        # completions, `cancelled` abandonments — disjoint
        s.credit_done = True
        req = s.request
        now = time.monotonic()
        if req.future.cancelled():
            self.stats["cancelled"] += 1
            return
        if req.submit_t:
            n_tok = len(s.emitted)
            first = req.first_tok_t or now
            queue_wait = max(0.0, (req.admit_t or now) - req.submit_t)
            ttft = max(0.0, first - req.submit_t)
            tpot = (now - first) / (n_tok - 1) if n_tok > 1 else None
            self.stats["slo_samples"] += 1
            self.stats["queue_wait_s_sum"] += queue_wait
            self.stats["ttft_s_sum"] += ttft
            if tpot is not None:
                self.stats["tpot_s_sum"] += tpot
            self.slo_pending.append((queue_wait, ttft, tpot))
            self.slo_recent.append((queue_wait, ttft, tpot))
            if req.tenant is not None:
                # the per-tenant split: the TenantScheduler's TTFT
                # feedback and the server's tenant-tagged TIMERs
                sums = self.tenant_slo.setdefault(req.tenant, {
                    "slo_samples": 0.0, "queue_wait_s_sum": 0.0,
                    "ttft_s_sum": 0.0, "tpot_s_sum": 0.0, "finished": 0.0,
                })
                sums["slo_samples"] += 1
                sums["finished"] += 1
                sums["queue_wait_s_sum"] += queue_wait
                sums["ttft_s_sum"] += ttft
                if tpot is not None:
                    sums["tpot_s_sum"] += tpot
                self.tenant_slo_pending.setdefault(
                    req.tenant, collections.deque(maxlen=1024)).append((queue_wait, ttft, tpot))
                self.tenant_slo_recent.setdefault(
                    req.tenant, collections.deque(maxlen=512)).append((queue_wait, ttft, tpot))
        if not req.future.done():
            req.future.set_result(req.tokens + s.emitted)
        self.stats["finished"] += 1
        # completion timestamp feeds the observed service rate that the
        # admit-queue shed uses for its expected-wait estimate
        self._finish_times.append(now)

    def _finish(self, slot: int) -> None:
        s = self._active.pop(slot)
        # publish while the lane still holds this request's prompt K/V:
        # the next occupant's insert is queued after the copy
        self._maybe_publish(slot, s)
        self._pos_host.pop(slot, None)
        self._masks_dirty = True
        self._resolve(s)

    def _check_done(self) -> None:
        now = time.monotonic()
        for slot in list(self._active):
            s = self._active[slot]
            req = s.request
            if req.deadline_t is not None and now >= req.deadline_t:
                req.future.cancel()  # past its budget: nobody is waiting
            if req.future.cancelled():
                # the caller gave up: reclaim the lane
                self._finish(slot)
                continue
            if len(s.emitted) >= req.max_new_tokens or (
                req.eos_id is not None and s.emitted and s.emitted[-1] == req.eos_id
            ):
                self._finish(slot)

    def _credit(self, s: _Slot, tokens) -> bool:
        """Append tokens to a request; True once it is done (budget/eos)."""
        req = s.request
        start = len(s.emitted)
        if start == 0 and len(tokens) and req.first_tok_t == 0.0:
            req.first_tok_t = time.monotonic()
        done = False
        for t in tokens:
            s.emitted.append(int(t))
            self.stats["tokens"] += 1
            if len(s.emitted) >= req.max_new_tokens or (
                req.eos_id is not None and int(t) == req.eos_id
            ):
                done = True
                break
        if req.on_tokens is not None and len(s.emitted) > start:
            try:
                req.on_tokens(list(s.emitted[start:]))
            except Exception:  # noqa: BLE001 - consumer bugs can't stall decode
                logger.exception("on_tokens callback failed")
        return done

    def _process_burst(self, burst: _Burst) -> None:
        """Credit one (sub)burst's tokens to the requests that occupied
        each lane AT DISPATCH TIME; the lane may have been pre-freed and
        re-admitted since. A plain burst's rows past a request's stop are
        overshoot and dropped. A fused burst emitted exactly
        ``counts[col]`` tokens per column before its done mask froze the
        lane, so that span is credited, and the lane's host position
        bound tightens from the k advance to its real one."""
        if burst.spec:
            self._process_spec_burst(burst)
            return
        host_toks, counts = burst.numpy()  # the burst's one host read
        if self._prof.enabled:
            # the stream has passed this burst: fold its measured records
            self._prof.resolve()
        for slot, (s, start, col) in burst.snapshot.items():
            if burst.fused:
                n = int(counts[col])
                if self._active.get(slot) is s and slot in self._pos_host:
                    self._pos_host[slot] -= burst.k - n
                span = host_toks[start: 1 + n, col]
            else:
                span = host_toks[start:, col]
            if s.credit_done or not len(span):
                continue
            if self._credit(s, span):
                if self._active.get(slot) is s:
                    self._finish(slot)
                else:
                    self._resolve(s)  # the lane was pre-freed at dispatch
        self._check_done()

    def _run(self) -> None:
        """Scheduler thread: the supervision shell around the poll loop."""
        self._started.set()
        while not self._stop.is_set():
            if not self._loop():
                return

    def _fail_inflight(self, pending, err: Exception) -> None:
        for slot in list(self._active):
            s = self._active.pop(slot)
            if not s.request.future.done():
                s.request.future.set_exception(err)
        for burst in pending:
            for s, _start, _col in burst.snapshot.values():
                if not s.request.future.done():
                    s.request.future.set_exception(err)
        for job in self._chunked.values():
            if not job.request.future.done():
                job.request.future.set_exception(err)
        self._chunked.clear()

    def _crash_recover(self, pending) -> bool:
        """Supervise one loop death: fail in-flight work with a typed
        BatcherDead, then rebuild the device state and re-warm (True), or
        latch dead once ``restart_budget`` restarts in quick succession
        are spent (False)."""
        while True:
            now = time.monotonic()
            if self._last_crash_t and now - self._last_crash_t > self.restart_window_s:
                self._restarts = 0
            self._last_crash_t = now
            self._restarts += 1
            attempt = self._restarts
            exhausted = attempt > self.restart_budget
            backoff = min(self.restart_backoff_s * (2 ** (attempt - 1)), 30.0)
            if exhausted:
                self.health = "dead"
                err = self._dead_error()
            else:
                self.health = "restarting"
                err = BatcherDead(
                    f"continuous batcher died; restarting "
                    f"(attempt {attempt}/{self.restart_budget})",
                    retry_after_s=max(backoff, 0.5),
                )
            self._fail_inflight(pending, err)
            pending = ()
            self._fail_pending_swap(err)
            # a drain staged when the loop died cannot complete (the
            # health writes below replace its latch: a restart serves)
            self._fail_pending_drain(err)
            self._flight({"type": "batcher_restart", "attempt": attempt,
                          "budget": self.restart_budget, "backoff_s": round(backoff, 3),
                          "outcome": "latched_dead" if exhausted else "restarting"})
            if exhausted:
                logger.error(
                    "continuous batcher crash-loop budget exhausted after %d "
                    "restarts", self.restart_budget,
                )
                self._stop.set()
                self._drain_queue(err)
                return False
            if self._stop.wait(backoff):
                self._drain_queue(self._dead_error())
                return False
            try:
                self._active.clear()
                self._chunked.clear()
                self._pos_host.clear()
                self._masks_dirty = True
                self._alloc_device_state()
                if self._prefix_index is not None:
                    # its slabs were copied out of the dead loop's cache:
                    # start empty (correctness never rests on the cache);
                    # preempted requests in the resume queue survive,
                    # their checkpoints live on the host
                    self._prefix_index = RadixPrefixIndex(self._prefix_cache_budget)
                    self.stats["prefix_cache_bytes"] = 0
                if self._warm_args is not None:
                    self.warm(**self._warm_args)
            except Exception:  # noqa: BLE001 - rebuild on a sick device
                logger.exception("batcher rebuild failed (attempt %d)", attempt)
                continue
            self.stats["batcher_restarts"] += 1
            self.health = "serving"
            logger.warning(
                "continuous batcher restarted (%d/%d)", attempt, self.restart_budget
            )
            return True

    def _admit_wave(self, wave: List[GenRequest]) -> None:
        """Admit queued requests into free lanes. A preempted request
        resumes (:meth:`_admit_resume`). A prompt sharing a cached prefix
        takes the suffix-only admit; one whose remaining prefill (the
        suffix of a hit, else its bucket) is longer than one prefill
        chunk reserves its lane for chunked prefill; the others group by
        bucket and share a batched prefill of m = 8 (where the slab
        fits), 4, or 1 (always 1 with a draft configured)."""
        free_iter = iter(
            i for i in range(self.slots) if i not in self._active and i not in self._chunked
        )
        by_bucket: Dict[int, List[GenRequest]] = {}
        for req in wave:
            if req.resume is not None:
                self._admit_one(self._admit_resume, next(free_iter), req)
                continue
            if req.remote is not None:
                # disaggregated handoff: the prompt K/V came over the
                # wire -- splice it, no local prefill
                self._admit_one(self._admit_remote_lane, next(free_iter), req)
                continue
            n = len(req.tokens)
            hit = self._prefix_match(req.tokens)
            if self._needs_chunks(n, hit):
                self._admit_one(self._start_chunked, next(free_iter), req, hit)
                continue
            if hit is not None:
                self._admit_one(self._admit_hit, next(free_iter), req, hit)
                continue
            by_bucket.setdefault(self._bucket(n), []).append(req)
        for bucket, reqs in by_bucket.items():
            while reqs:
                # speculation admits one request at a time (its draft
                # prefix is a per-request prefill)
                m = 1
                if not self.speculate_tokens:
                    if len(reqs) >= 8 and self._chunk8_ok(bucket):
                        m = 8
                    elif len(reqs) >= 4:
                        m = 4
                chunk, reqs = reqs[:m], reqs[m:]
                slots_ = [next(free_iter) for _ in chunk]
                try:
                    self._admit_many(slots_, chunk, bucket)
                except Exception as e:  # noqa: BLE001 - bad request
                    logger.exception("admit failed")
                    for req in chunk:
                        if not req.future.done():
                            req.future.set_exception(e)

    def _needs_chunks(self, n: int, hit) -> bool:
        """Whether a prompt of ``n`` tokens prefills in chunks: the suffix
        a prefix hit leaves, else the prompt's bucket, is longer than one
        chunk."""
        C = self.prefill_chunk
        return bool(C) and (n - hit[0] > C if hit else self._bucket(n) > C)

    def _admit_one(self, admit, slot: int, req: GenRequest, *args) -> None:
        """``admit(slot, req, *args)``; a failure fails the request alone,
        frees the lane it reserved and releases its tier checkpoint."""
        try:
            admit(slot, req, *args)
        except Exception as e:  # noqa: BLE001 - bad request/device state
            if isinstance(e, (PrefixGone, WeightVersionMismatch)):
                # expected, self-healing refusals (the caller re-requests
                # the full slab / re-prefills): one line, no traceback
                logger.info("remote admit refused: %s", e)
            else:
                logger.exception("admit failed")
            self._chunked.pop(slot, None)
            req.remote = None
            self._release_tier_ckpt(req)
            if not req.future.done():
                req.future.set_exception(e)

    # -- chunked prefill -----------------------------------------------------

    def _start_chunked(self, slot: int, req: GenRequest, hit=None,
                       resume=None) -> None:
        """Reserve ``slot`` and queue the prompt for chunked prefill into a
        fresh staging slab. On a prefix hit ``(m, donor)`` the donor lands
        at the head of the slab and chunking starts at ``m`` rounded DOWN
        to the chunk grid, so every chunk runs at an offset ``warm()``
        reached; the overlap is recomputed over the donor with the same
        tokens at the same positions. ``resume``: see :class:`_ChunkJob`."""
        bucket = self._bucket(len(req.tokens))
        req.admit_t = time.monotonic()
        slab = self._new_slab(bucket)
        start = 0
        if hit is not None:
            # a hit even when the grid leaves nothing to splice (match
            # shorter than one chunk), counted with its real savings
            m, donor = hit
            start = (m // self.prefill_chunk) * self.prefill_chunk
            if start > 0:
                with self._prof.measure("splice", variant=f"b{bucket}",
                                        tenant=req.tenant or "",
                                        bytes_read=self._rb("splice", tokens=start),
                                        tokens=start), torch.no_grad():
                    tb = donor["k"].shape[3]
                    for name in ("k", "v"):
                        slab[name][:, :, :, :tb] = donor[name]
            req.cache_hit_tokens = start
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_saved"] += start
        elif self._prefix_index is not None:
            self.stats["prefix_misses"] += 1
        self._chunked[slot] = _ChunkJob(
            request=req, slot=slot, next_start=start, slab=slab, bucket=bucket,
            resume=resume,
        )

    def _advance_chunks(self) -> None:
        """Run ONE prefill chunk for every pending chunked admission (the
        interleave: a chunk per job per poll). A last chunk that would
        run past the slab slides back inside it, rewriting identical K/V
        at the same positions. The last chunk samples the first token and
        its slab goes through the ordinary lane insert, so from there the
        lane decodes exactly as a whole-prompt admission."""
        C = self.prefill_chunk
        now = time.monotonic()
        for slot in list(self._chunked):
            job = self._chunked[slot]
            req = job.request
            if req.deadline_t is not None and now >= req.deadline_t:
                req.future.cancel()
            if req.future.cancelled():
                del self._chunked[slot]  # the reserved lane is free again
                self.stats["cancelled"] += 1
                continue
            n = len(req.tokens)
            start = job.next_start
            is_last = start + C >= n
            if is_last:
                start = max(0, min(start, job.bucket - C))
            end = min(start + C, n)
            buf = np.zeros((1, C), np.int64)
            buf[0, : end - start] = req.tokens[start:end]
            attn_len = min(job.bucket, self._attn_need(start + C))
            tenant = req.tenant or ""
            try:
                with self._prof.measure("chunk_prefill", variant=f"b{job.bucket}",
                                        tenant=tenant,
                                        bytes_read=self._rb("chunk_prefill", tokens=C),
                                        tokens=C), device_trace("gen.prefill_chunk"):
                    first = self._chunk_step(job.slab, buf, start, n - 1 - start,
                                             req.seed, req.temperature, attn_len, is_last)
                if is_last:
                    first_tok, lane_key, first_pos = first[0], first[1], n
                    if job.resume is not None:
                        # the checkpointed continuation replaces the
                        # chunk's own sample
                        emitted, ckey = job.resume
                        first_tok = self._to_dev(np.asarray([emitted[-1]], np.int64))
                        lane_key = self._to_dev(np.asarray([ckey], np.int64))
                        first_pos = n + len(emitted) - 1
                    with self._prof.measure(
                            "insert", variant=f"b{job.bucket}", tenant=tenant,
                            bytes_read=self._rb("insert", tokens=job.bucket),
                            tokens=first_pos), device_trace("gen.lane_insert"):
                        self._insert(job.slab, [slot], first_tok, [first_pos], lane_key)
            except Exception as e:  # noqa: BLE001 - bad request/device state
                logger.exception("chunked prefill failed")
                del self._chunked[slot]
                if not req.future.done():
                    req.future.set_exception(e)
                continue
            self.stats["prefill_steps"] += 1
            # positions computed, pad and slide-back overlap included (the
            # bucketed whole prefill counts its whole bucket the same way)
            self.stats["prefill_tokens"] += C
            self.stats["prefill_chunks"] += 1
            if is_last:
                del self._chunked[slot]
                if job.resume is not None:
                    self._activate_resumed(slot, req, job.resume[0])
                    continue
                if self._spec_active():
                    self._draft_admit_tokens(slot, req.tokens)
                self._active[slot] = _Slot(request=req)
                self._pos_host[slot] = n
                self._masks_dirty = True
                self.stats["admitted"] += 1
            else:
                job.next_start = end

    # -- prefix cache --------------------------------------------------------

    def _prefix_match(self, tokens: List[int]):
        """Longest usable cached prefix of ``tokens``: ``(m, slab)`` or
        None. Capped at n - 1 (the last prompt token is always computed:
        its logits sample the first new token); declined below
        ``prefix_cache_min_tokens``, when the suffix's bucket would not
        fit past the match, and when the donor's bucket exceeds the
        prompt's (the splice and the suffix attention scale with the
        donor: a short prompt matching into a long cached one would pay
        more than the prefill it skips). Takes a raw token list, so a
        resume splices cached prompt prefixes as an admission does."""
        if self._prefix_index is None:
            return None
        n = len(tokens)
        m, slab = self._prefix_index.match(tokens)
        m = min(m, n - 1)
        if (slab is None or m < self.prefix_cache_min_tokens) and self._kv_tier is not None:
            # device radix miss: a demoted slab in the host tier promotes
            # (upload + re-insert) and serves this admission as a splice
            promoted = self._promote_tier_prefix(tokens)
            if promoted is not None:
                m, slab = promoted
                m = min(m, n - 1)
        if slab is None or m < self.prefix_cache_min_tokens:
            return None
        if m + self._bucket(n - m) > self.max_seq:
            return None
        if slab["k"].shape[3] > self._bucket(n):
            return None
        return m, slab

    def _maybe_publish(self, slot: int, s: _Slot) -> None:
        """Publish a request's prompt K/V into the prefix cache: the
        prompt's positions are written from admission on and decode only
        appends, so the copy is valid at any free point. Skipped for
        prompts below ``prefix_cache_min_tokens`` and when a stored slab
        already covers the whole prompt (each distinct prompt publishes
        once)."""
        idx = self._prefix_index
        if idx is None:
            return
        toks = s.request.tokens
        n = len(toks)
        if n < self.prefix_cache_min_tokens or idx.covered_len(toks) >= n:
            return
        b = self._bucket(n)
        with self._prof.measure("extract", variant=f"b{b}", tenant=s.request.tenant or "",
                                bytes_read=self._rb("extract", tokens=b), tokens=b):
            slab = self._extract_prefix(slot, b)
        nbytes = sum(t.numel() * t.element_size() for t in slab.values())
        self.stats["prefix_evicted"] += idx.insert(toks, slab, nbytes)
        self.stats["prefix_cache_bytes"] = idx.total_bytes

    # -- host KV tier ------------------------------------------------------------

    def sync_kv_tier_stats(self) -> None:
        """Mirror the tier's counters into ``stats`` (plain int copies,
        safe from any thread)."""
        tier = self._kv_tier
        if tier is None:
            return
        t = tier.stats
        self.stats["kv_tier_demotions"] = t["demotions"]
        self.stats["kv_tier_hits"] = t["hits"]
        self.stats["kv_tier_evictions"] = t["evictions"]
        self.stats["kv_tier_bytes"] = tier.total_bytes

    def kv_tier_summary(self) -> Optional[Dict[str, Any]]:
        return self._kv_tier.summary() if self._kv_tier is not None else None

    @property
    def tier_promote_gate(self) -> int:
        """Effective promote threshold: a tier match below
        ``prefix_cache_min_tokens`` could never serve an admission, so
        the gate is the larger of the two knobs."""
        return max(self.kv_tier_promote_min_tokens, self.prefix_cache_min_tokens)

    def _upload_slab(self, host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Host K/V slab -> device, without a host sync (a decoded slab
        is pinned on CUDA already)."""
        return {name: self._to_dev(t) for name, t in host.items()}

    def _demote_prefix_slabs(self, victims) -> None:
        """Demote reclaim-ladder prefix victims to the host tier: pull
        each slab to the host at this poll boundary (the one designed
        sync of the demote path: the copy buys back a re-prefill later),
        SKV1-encode, store keyed by weight version and token path. A
        victim the tier would refuse (too short, already covered) is
        skipped before its pull."""
        tier = self._kv_tier
        for tokens, slab, _nbytes in victims:
            if (len(tokens) < tier.min_tokens
                    or tier.prefix_covered_len(tokens, self.weight_version) >= len(tokens)):
                continue
            host = {name: self._to_host(t) for name, t in slab.items()}
            if tier.put_prefix(tokens, host, self.weight_version):
                self._flight({
                    "type": "kv_demote", "kind": "prefix", "tokens": len(tokens),
                    "phash": prompt_hash(tokens)[:8],
                    "bytes": sum(t.numel() * t.element_size() for t in host.values()),
                })

    def tier_prefix_lookup(self, tokens, min_tokens: Optional[int] = None):
        """The one usable-hit probe of this member's host tier, shared by
        the scheduler's promote-on-miss, the decode role's dedup consult
        and the KV port's peer lookup, so the gate (promote threshold,
        donor-bucket cap, near-max suffix cap) is the same on the side
        that ships a slab and the side that splices it. ``(m, meta,
        host)`` with the host tensors CRC-verified, or None on a miss,
        corruption (entry already dropped) or caps. Host reads only."""
        tier = self._kv_tier
        if tier is None:
            return None
        tokens = [int(t) for t in tokens]
        n = len(tokens)
        try:
            hit = tier.match_prefix(tokens, self.weight_version)
        except DisaggError as e:
            logger.warning("kv tier prefix entry dropped: %s", e)
            return None
        if hit is None:
            return None
        depth, meta, host = hit
        m = min(depth, n - 1)
        if m < max(int(min_tokens or 0), self.tier_promote_gate):
            return None
        if host["k"].shape[3] > self._bucket(n) or m + self._bucket(n - m) > self.max_seq:
            return None
        return m, meta, host

    def _promote_tier_prefix(self, tokens):
        """Tier consult on a device radix miss: upload the longest stored
        host prefix, re-insert it into the device radix index under its
        entry path and return ``(m, device_slab)`` for the ordinary
        splice -- a warm hit that costs a host-to-device copy instead of
        a re-prefill. None on a miss, corruption or caps."""
        if self._prefix_index is None:
            return None
        hit = self.tier_prefix_lookup(tokens)
        if hit is None:
            return None
        m, meta, host = hit
        self._flight({
            "type": "tier_hit", "kind": "prefix", "source": "local", "tokens": m,
            "phash": prompt_hash(meta.get("tokens") or [])[:8],
        })
        self.promote_peer_prefix(meta, host, source="local")
        _depth, slab = self._prefix_index.match(tokens)
        return (m, slab) if slab is not None else None

    def consult_tier_covered_len(self, tokens) -> int:
        """Decode-role dedup consult of this member's OWN host tier: a
        demoted prefix of the prompt promotes into the device radix index
        here (caller thread) and the refreshed ``remote_covered_len`` is
        returned, so the prefill request ships suffix-only. 0 on a miss."""
        if self._prefix_index is None:
            return 0
        hit = self.tier_prefix_lookup(tokens)
        if hit is None:
            return 0
        _m, meta, host = hit
        self.promote_peer_prefix(meta, host, source="local")
        return self.remote_covered_len(tokens)

    def promote_peer_prefix(self, meta: Dict[str, Any], host: Dict[str, Any],
                            source: str = "peer") -> int:
        """Insert a prefix slab pulled from a tier (a peer's, or this
        member's own) into the LOCAL device radix index, so the ordinary
        match/splice machinery and the dedup consult serve it from here
        on. Returns the entry's token count. Any thread: the upload
        queues on the device without a host sync."""
        idx = self._prefix_index
        entry = [int(t) for t in meta.get("tokens") or []]
        if idx is None or not entry:
            return 0
        slab = self._upload_slab(host)
        nbytes = sum(t.numel() * t.element_size() for t in host.values())
        evicted = idx.insert(entry, slab, nbytes)
        with self._export_lock:
            self.stats["prefix_evicted"] += evicted
            self.stats["prefix_cache_bytes"] = idx.total_bytes
            self.stats["kv_tier_promotions"] += 1
        self._flight({
            "type": "kv_promote", "kind": "prefix", "source": source,
            "tokens": len(entry), "bytes": nbytes, "phash": prompt_hash(entry)[:8],
        })
        return len(entry)

    def _checkpoint_kv_to_tier(self, slot: int, req: GenRequest) -> None:
        """Rung 3's spill half: copy the preempted lane's exact cache
        columns ``[0, _attn_need(pos))`` to the host tier (budget
        allowing), so its resume is a copy-back insert instead of a
        prompt recompute and replay. The pipeline is drained already."""
        ck = req.resume
        emitted = ck["emitted"]
        n = len(req.tokens)
        pos = n + len(emitted) - 1
        width = self._attn_need(pos)
        with self._prof.measure("extract", variant="preempt", tenant=req.tenant or "",
                                bytes_read=self._rb("extract", tokens=width), tokens=width):
            slab = self._extract_prefix(slot, width)
        host = {name: self._to_host(t) for name, t in slab.items()}
        self._tier_ck_seq += 1
        key = self._tier_ck_seq
        stored = self._kv_tier.put_ckpt(
            key, {"pos": pos, "width": width, "prompt_tokens": n, "emitted": len(emitted)},
            host, version=self.weight_version,
        )
        if stored:
            ck["tier"] = key
            self._flight({
                "type": "kv_demote", "kind": "ckpt", "lane": slot, "tokens": pos,
                "phash": prompt_hash(req.tokens)[:8],
                "bytes": sum(t.numel() * t.element_size() for t in host.values()),
            })
        else:
            ck.pop("tier", None)

    def _release_tier_ckpt(self, req: GenRequest) -> None:
        """Release a request's tier checkpoint, if any: the request was
        cancelled or failed, so the entry would otherwise pin tier budget
        that prefix demotions can never evict. Any thread; idempotent."""
        ck = req.resume
        if ck is None or self._kv_tier is None:
            return
        key = ck.pop("tier", None)
        if key is not None:
            self._kv_tier.drop_ckpt(key)

    def _resume_from_tier(self, slot: int, req: GenRequest, emitted: List[int],
                          end_pos: int, tier_key) -> bool:
        """Copy-back resume: take the lane's checkpoint (one-shot),
        upload the stored columns and insert them with the checkpointed
        registers. True when the lane is live again; False sends the
        caller down the recompute-and-replay fallback (entry evicted,
        stale, corrupt or at another position)."""
        try:
            ent = self._kv_tier.take_ckpt(tier_key, self.weight_version)
        except DisaggError as e:
            logger.warning("kv tier checkpoint dropped: %s", e)
            return False
        if ent is None:
            return False
        meta, host = ent
        if int(meta.get("pos", -1)) != end_pos:
            # a drifted checkpoint must never splice: registers and cache
            # would disagree on where the lane is
            logger.warning("kv tier checkpoint position %s != lane end %d — replaying",
                           meta.get("pos"), end_pos)
            return False
        slab = self._upload_slab(host)
        first = self._to_dev(np.asarray([emitted[-1]], np.int64))
        key = self._to_dev(np.asarray([req.resume["key"]], np.int64))
        with self._prof.measure("insert", variant="tier", tenant=req.tenant or "",
                                bytes_read=self._rb("insert", tokens=int(meta.get("width", 0))),
                                tokens=end_pos), device_trace("gen.lane_insert"):
            self._insert(slab, [slot], first, [end_pos], key)
        self.stats["kv_tier_promotions"] += 1
        if self.flight is not None and self.flight.enabled:
            phash = prompt_hash(req.tokens)[:8]
            self.flight.record({"type": "tier_hit", "kind": "ckpt", "source": "local",
                                "lane": slot, "tokens": end_pos, "phash": phash})
            self.flight.record({
                "type": "kv_promote", "kind": "ckpt", "source": "local", "lane": slot,
                "tokens": end_pos, "phash": phash,
                "bytes": sum(t.numel() * t.element_size() for t in host.values()),
            })
        self._activate_resumed(slot, req, emitted, replay=False)
        return True

    # -- HBM pressure ----------------------------------------------------------

    def pressure_summary(self) -> Optional[Dict[str, Any]]:
        """The ledger's snapshot for metrics; None while the subsystem is
        off (budget 0, never re-budgeted)."""
        pc = self._pressure
        if pc.budget_bytes <= 0 and not pc.stats["budget_changes"]:
            return None
        return pc.summary()

    def _ledger_components(self) -> Dict[str, int]:
        """The unified HBM ledger, priced the way the reclaim ladder can
        free it: each live lane at its attention-read bucket times the
        K/V bytes per position (the draft cache's included while it is
        resident), the chunked-prefill staging slabs, the prefix cache's
        bytes, a staged swap's weights and the resident tenant's. Host
        arithmetic over at most ``slots`` entries."""
        per_tok = self._lane_kv_bytes()
        swap = self._pending_swap
        pager = self.tenant_pager
        return {
            "decode": sum(self._attn_need(p) for p in self._pos_host.values()) * per_tok,
            "staging": sum(job.bucket for job in self._chunked.values()) * per_tok,
            "prefix": self._prefix_index.total_bytes if self._prefix_index is not None else 0,
            # a staged swap's second weight set, resident until the flip
            "swap": swap.nbytes if swap is not None else 0,
            # the resident tenant's weights (multi-tenant serving): page-ins
            # compete with K/V growth in the same ledger
            "pager": int(pager.resident_hbm_bytes) if pager is not None else 0,
        }

    def _pressure_poll(self, pending) -> None:
        """Per-poll pressure work: apply the chaos hook's re-budget,
        refresh the ledger and, while it is latched over the high
        watermark, run the reclaim ladder."""
        pc = self._pressure
        if self.pressure_hook is not None:
            nb = self.pressure_hook(self._work_poll_count)
            if nb is not None:
                if int(nb) < 0:
                    pc.restore_budget()
                else:
                    pc.set_budget(int(nb))
                if self._kv_tier is not None:
                    pc.host_bytes = self._kv_tier.total_bytes
                self._flight({"type": "pressure_budget", "budget_bytes": pc.budget_bytes,
                              "restored": int(nb) < 0, "host_tier_bytes": pc.host_bytes})
        if pc.budget_bytes <= 0:
            # a restore can land on a zero boot budget (pressure driven by
            # the hook alone): cancelled speculation must still come back
            if self._spec_suppressed:
                self._resume_speculation()
            if pc.active:
                pc.update(self._ledger_components())
            return
        if self._kv_tier is not None:
            # host RAM rides the summary, never the device ledger's math
            pc.host_bytes = self._kv_tier.total_bytes
            self.sync_kv_tier_stats()
        if pc.update(self._ledger_components()):
            self._reclaim(pending, pc)
        elif self._spec_suppressed and pc.used + self._draft_ledger_bytes() < pc.high_bytes:
            # back only when the draft cache fits under the high watermark:
            # otherwise the next poll would cancel it again (the JAX
            # batcher resumes as soon as the latch clears, and oscillates)
            self._resume_speculation()

    def _pressure_event(self, entry: Dict[str, Any]) -> None:
        """A reclaim-ladder action: kept in ``pressure_events`` and
        recorded by the flight recorder."""
        self.pressure_events.append(dict(entry))
        self._flight(entry)

    def _drain_pending(self, pending) -> None:
        """Read every in-flight burst now, oldest first: a checkpoint must
        see its lane's exact host state (emitted tokens, and the device
        position they imply)."""
        while pending:
            self._process_burst(pending.popleft())

    def _reclaim(self, pending, pc: PressureController) -> None:
        """The reclaim ladder, cheapest rung first, until the ledger is
        back under its low watermark:

        1. evict prefix slabs (LRU): pure cache, no work lost; with the
           host tier on, demote them there instead;
        2. cancel speculation: free the draft cache and decode with the
           plain bursts (:meth:`_suppress_speculation`); greedy streams
           are unchanged, since greedy speculation emits the target's
           argmax decode; skipped while any lane samples (a seeded
           stream with speculation differs from one without);
        3. preempt lanes: checkpoint a victim on the host and requeue it
           for resume, freeing its lane at this poll boundary; never the
           last lane, so one lane always progresses and pressure cannot
           livelock;
        4. shed admissions: while latched the loop holds admissions and
           :meth:`_shed_check` refuses submits."""
        idx = self._prefix_index
        if idx is not None and idx.total_bytes > 0:
            # with the host tier on, rung 1 DEMOTES: victims are collected
            # under the index lock, pulled to the host and encoded into
            # the tier out here
            demoted: Optional[List] = [] if self._kv_tier is not None else None
            evicted = idx.evict_to(max(0, idx.total_bytes - pc.overshoot_bytes()),
                                   collect=demoted)
            if evicted:
                self.stats["prefix_evicted"] += evicted
                self.stats["pressure_prefix_evictions"] += evicted
                self.stats["prefix_cache_bytes"] = idx.total_bytes
                if demoted:
                    self._demote_prefix_slabs(demoted)
                self._pressure_event({
                    "type": "pressure_reclaim", "action": "evict_prefix",
                    "evicted": evicted, "demoted": len(demoted or ()),
                    "used_bytes": pc.used})
                pc.update(self._ledger_components())
        if (pc.active and self._spec_active()
                and all(s.request.temperature == 0.0 for s in self._active.values())
                and all(j.request.temperature == 0.0 for j in self._chunked.values())):
            self._drain_pending(pending)
            self._suppress_speculation()
            pc.update(self._ledger_components())
        if pc.active and len(self._active) + len(self._chunked) > 1:
            self._drain_pending(pending)
            # the drain may have finished lanes outright
            pc.update(self._ledger_components())
            while pc.active and len(self._active) + len(self._chunked) > 1:
                victim = self._pick_victim()
                if victim is None:
                    break
                kind, slot = victim
                if kind == "chunked":
                    self._preempt_chunked(slot)
                else:
                    self._preempt_lane(slot)
                pc.update(self._ledger_components())

    def _suppress_speculation(self) -> None:
        """Rung 2: free the draft cache and decode with the plain bursts.
        Every spec graph (tagged ``"spec"``, whether warm() or a dispatch
        captured it) addresses the freed buffer: they are set aside,
        never replayed, until :meth:`_resume_speculation` finds the new
        buffer at the same address (else it captures them again). The
        pipeline has been drained, so no spec burst is in flight."""
        self._spec_suppressed = True
        if self._graphs is not None:
            graphs = self._graphs.graphs
            spec = [key for key in graphs if key[0] == "spec"]
            self._spec_suspended = (self._draft_buf.data_ptr(),
                                    {key: graphs.pop(key) for key in spec})
        self._draft_cache = self._draft_buf = None
        self._masks_dirty = True
        self._pressure_event({"type": "pressure_reclaim", "action": "cancel_speculation"})
        logger.warning("HBM pressure: speculation cancelled (draft cache freed); "
                       "plain decode bursts until the ledger clears")

    def _resume_speculation(self) -> None:
        """The ledger cleared: reallocate the draft cache and re-derive
        every live lane's draft prefix from its prompt and the tokens the
        host has credited (the JAX package's order: before admissions,
        so no lane is admitted into a half-restored draft cache). On the
        card the set-aside spec graphs come back when the new cache lies
        at the old address, else they are captured again over it
        (captured, not run: the lanes are live), each counted as a
        capture after warm()."""
        self._draft_cache = self._new_draft_cache()
        self._spec_suppressed = False
        for slot, s in self._active.items():
            full = s.request.tokens + s.emitted[:-1] if s.emitted else s.request.tokens
            self._draft_admit_tokens(slot, full)
        ptr, graphs = self._spec_suspended or (None, {})
        self._spec_suspended = None
        if self._graphs is not None and ptr == self._draft_buf.data_ptr():
            self._graphs.graphs.update(graphs)
            self.stats["spec_graph_reuses"] += len(graphs)
        elif self._graphs is not None:
            for key in graphs:
                _tag, attn_len, stoch = key
                self._graphs.capture(
                    key, lambda a=attn_len, st=stoch: self._spec_burst(a, st),
                    warm_first=False)
                self.stats["spec_graph_recaptures"] += 1
                self.stats["graph_captures_inline"] += 1
        self._masks_dirty = True
        self._pressure_event({"type": "pressure_reclaim", "action": "resume_speculation",
                              "lanes": len(self._active)})

    def _admit_cost_bytes(self, req: GenRequest) -> int:
        """Ledger footprint of ``req`` at the end of its generation: the
        attention bucket of its last position times the K/V bytes per
        position (the watermark-aware admission's price)."""
        end = min(self.max_seq, len(req.tokens) + req.max_new_tokens)
        return self._attn_need(end) * self._lane_kv_bytes()

    def _draft_ledger_bytes(self) -> int:
        """What the live lanes' draft cache adds to the ledger's decode
        component while speculation is on."""
        return sum(self._attn_need(p) for p in self._pos_host.values()) * self._draft_kv_key_bytes

    def _lane_kv_bytes(self) -> int:
        """K/V bytes a live lane holds per position: the target's, plus
        the draft's while speculation is on (rung 2 frees it)."""
        return self._kv_key_bytes + (self._draft_kv_key_bytes if self._spec_active() else 0)

    def _pick_victim(self):
        """``("chunked", slot)``, ``("lane", slot)`` or None. Chunked
        admissions first (nothing emitted yet: preempting one loses no
        work and frees a staging slab; the largest first), then decode
        lanes: best-effort SLO class before every other, deadline-free
        ones before those with a deadline (a lane that must answer soon
        is spared while anything else can yield; among those, the most
        slack first), and within each the most remaining budget first
        (the lane that would hold its slot longest yields it).

        Tenant guard: while any best-effort lane is live, the ONLY lane
        of a ``strict`` tenant is never chosen. When every candidate is
        protected the guard stands down (pressure relief must stay
        possible)."""
        if self._chunked:
            return "chunked", max(self._chunked, key=lambda s: self._chunked[s].bucket)
        if len(self._active) <= 1:
            return None
        now = time.monotonic()
        lanes_per_tenant = collections.Counter(
            s.request.tenant for s in self._active.values() if s.request.tenant is not None)
        has_best_effort = any(s.request.slo == "best_effort" for s in self._active.values())

        def protected(slot: int) -> bool:
            req = self._active[slot].request
            return (has_best_effort and req.slo == "strict" and req.tenant is not None
                    and lanes_per_tenant[req.tenant] <= 1)

        candidates = [s for s in self._active if not protected(s)] or list(self._active)

        def order(slot: int):
            s = self._active[slot]
            req = s.request
            slack = req.deadline_t - now if req.deadline_t is not None else None
            return (
                # best_effort first; "standard" (the single-tenant
                # default) keeps the order it had before tenants
                0 if req.slo == "best_effort" else 1,
                0 if slack is None else 1,
                -(slack if slack is not None else 0.0),
                -(req.max_new_tokens - len(s.emitted)),
            )

        return "lane", min(candidates, key=order)

    def _preempt_chunked(self, slot: int) -> None:
        """Preempt a chunked admission: drop its staging slab and requeue
        the request whole (a resume's checkpoint rides along on it)."""
        job = self._chunked.pop(slot)
        self.stats["preemptions"] += 1
        self._flight({"type": "preempt", "lane": slot, "kind": "chunked",
                      "prompt_tokens": len(job.request.tokens), "emitted": 0})
        self._resume_queue.append(job.request)

    def _checkpoint_lane(self, slot: int) -> GenRequest:
        """Checkpoint one decode lane on the host and free it: its emitted
        tokens and its post-split lane key in ``req.resume`` (none when
        nothing was credited yet: a plain re-admit gives the same stream),
        NOT its K/V. The caller has drained the pipeline, so ``emitted``
        and the device state agree; the key's 16-byte read is the whole
        cost. Shared by pressure preemption, the swap's straggler bound
        and the graceful drain."""
        s = self._active.pop(slot)
        req = s.request
        self._pos_host.pop(slot, None)
        self._masks_dirty = True
        if s.emitted:
            req.resume = {"emitted": list(s.emitted),
                          "key": self._whole.keys[slot].tolist()}
        return req

    def _preempt_lane(self, slot: int) -> None:
        """Preempt one decode lane (rung 3): :meth:`_checkpoint_lane`,
        then requeue the request for resume. With the host tier on, the
        lane's K/V columns spill there too (budget allowing) for a
        copy-back resume."""
        emitted = len(self._active[slot].emitted)
        req = self._checkpoint_lane(slot)
        if self._kv_tier is not None and req.resume is not None:
            # spill the K/V before anything can reuse the lane's columns
            # (nothing was dispatched since the drain)
            self._checkpoint_kv_to_tier(slot, req)
        self.stats["preemptions"] += 1
        self._flight({"type": "preempt", "lane": slot, "kind": "lane",
                      "prompt_tokens": len(req.tokens), "emitted": emitted,
                      "remaining": req.max_new_tokens - emitted})
        self._resume_queue.append(req)

    def _admit_resume(self, slot: int, req: GenRequest) -> None:
        """Resume a preempted request into ``slot``. With a tier
        checkpoint, copy its K/V back (:meth:`_resume_from_tier`). Else
        recompute: rebuild its
        PROMPT K/V the way an admission would (a prefix hit splicing, a
        long remainder chunking, else a whole prefill), insert the
        checkpointed continuation in place of the prefill's own sample --
        the last emitted token, the position the lane held, the
        checkpointed key -- then replay the emitted tokens' K/V through
        the decode step (:meth:`_replay_emitted`). Decode from there runs
        the uninterrupted lane's computation, so greedy and seeded
        streams continue unchanged."""
        emitted = list(req.resume["emitted"])
        key = req.resume["key"]
        n = len(req.tokens)
        # the tier key is popped whatever happens next: take_ckpt is
        # one-shot, and a later preemption checkpoints under a new key
        tier_key = req.resume.pop("tier", None) if self._kv_tier is not None else None
        if tier_key is not None:
            # copy-back: the lane's exact K/V columns come back from the
            # host, skipping both the prompt recompute and the replay
            if self._resume_from_tier(slot, req, emitted, n + len(emitted) - 1, tier_key):
                return
            # the tier evicted, refused or corrupted the entry
            self.stats["kv_tier_replay_fallbacks"] += 1
        hit = self._prefix_match(req.tokens)
        if self._needs_chunks(n, hit):
            self._start_chunked(slot, req, hit, (emitted, key))
            return
        cont = (self._to_dev(np.asarray([emitted[-1]], np.int64)),
                self._to_dev(np.asarray([key], np.int64)), n + len(emitted) - 1)
        self._prompt_into_lane(slot, req, hit, cont)
        self._activate_resumed(slot, req, emitted)

    def _activate_resumed(self, slot: int, req: GenRequest, emitted: List[int],
                          replay: bool = True) -> None:
        """The resume paths' shared tail: replay the emitted tokens' K/V
        (not after a copy-back, which restored them), then re-activate
        the lane with crediting continuing after the checkpoint (spans
        already streamed are never sent again, and the inserted token --
        ``emitted[-1]`` -- is not credited twice)."""
        n = len(req.tokens)
        if replay:
            self._replay_emitted(slot, n, emitted[:-1])
        if self._spec_active():
            self._draft_admit_tokens(slot, req.tokens + emitted[:-1])
        s = _Slot(request=req, emitted=list(emitted), first_pending=False,
                  dispatched=len(emitted))
        self._active[slot] = s
        self._pos_host[slot] = n + len(emitted) - 1
        self._masks_dirty = True
        req.resume = None
        self.stats["preempt_resumes"] += 1
        self._flight({"type": "preempt_resume", "lane": slot, "prompt_tokens": n,
                      "replayed_tokens": max(0, len(emitted) - 1) if replay else 0,
                      "copyback": not replay, "emitted": len(emitted),
                      "cache_hit_tokens": req.cache_hit_tokens})

    def _replay_emitted(self, slot: int, start_pos: int, toks: List[int]) -> None:
        """Teacher-forced replay: rebuild positions ``[start_pos,
        start_pos + len(toks))`` of lane ``slot``'s cache from the tokens
        it already emitted, one decode step per token -- a prefill over
        prompt and generated tokens would compute those positions with
        other matmul shapes, which can part the streams at bf16. Each
        step runs over the whole batch, the shape the lane decoded in
        (every other row parked: it writes nothing, and no lane register
        moves), at the attention bucket of the replay's end; on the card
        it replays a graph ``warm()`` captured when pressure is on.

        Under MoE the parked rows would take the experts' capacity, so
        the lane replays alone: one row per step over a view of its cache
        rows, the rows the JAX package's ``replay_burst`` runs, eagerly
        (the view's address follows the slot)."""
        if not toks:
            return
        attn_len = self._attn_need(start_pos + len(toks))
        if self.model.cfg.n_experts:
            self._replay_alone(slot, start_pos, toks, attn_len)
            return
        cur = np.zeros((self.slots,), np.int64)
        pos = np.zeros((self.slots,), np.int64)
        wpos = np.full((self.slots,), self.max_seq, np.int64)
        r = self._replay
        for j, tok in enumerate(toks):
            cur[slot], pos[slot], wpos[slot] = tok, start_pos + j, start_pos + j
            self._upload(r["cur"], cur)
            self._upload(r["pos"], pos)
            self._upload(r["wpos"], wpos)
            with self._prof.measure("replay", variant=f"k1b{attn_len}",
                                    bytes_read=self._rb("replay", tokens=1), tokens=1):
                self._phase(("replay", attn_len), lambda: self._replay_step(attn_len))
        self.stats["replayed_tokens"] += len(toks)

    @torch.inference_mode()
    def _replay_alone(self, slot: int, start_pos: int, toks: List[int],
                      attn_len: int) -> None:
        ks = [layer[slot: slot + 1] for layer in self._cache["k"]]
        vs = [layer[slot: slot + 1] for layer in self._cache["v"]]
        for j, tok in enumerate(toks):
            with self._prof.measure("replay", variant=f"k1b{attn_len}",
                                    bytes_read=self._rb("replay", tokens=1), tokens=1):
                self.model.decode_step_ragged_list(
                    self.params, ks, vs, self._to_dev(np.asarray([[tok]], np.int64)),
                    self._to_dev(np.asarray([start_pos + j], np.int64)), attn_len=attn_len)
        self.stats["replayed_tokens"] += len(toks)

    # -- swap and drain at the poll boundary ----------------------------------

    @torch.inference_mode()
    def _do_swap(self, swap: _SwapJob) -> None:
        """Flip a drained swap (scheduler thread, nothing in flight): copy
        the staged leaves into the served tensors on the batcher's stream
        and wait for the copy (the staged set is freed after it), bump
        ``weight_version`` and purge the prefix cache and host tier by
        version. Under ``_swap_lock``, so ``cancel_weight_swap`` lands
        wholly before (the job is gone: skipped) or after (nothing to
        cancel)."""
        from ..convert import sorted_leaves

        with self._swap_lock:
            if self._pending_swap is not swap:
                return  # cancelled since the loop saw it
            old_v = self.weight_version
            with self._prof.measure("swap_cast", variant=str(self.model.dtype).replace("torch.", ""),
                                    bytes_read=self._rb("swap_cast")):
                for (_p, dst), (_q, src) in zip(sorted_leaves(self.params),
                                                sorted_leaves(swap.params)):
                    dst.copy_(src)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            swap.params = None
            self.weight_version = swap.version
            if self._prefix_index is not None:
                # old-weights K/V must never splice into a new prefill
                self.stats["prefix_evicted"] += self._prefix_index.set_version(swap.version)
                self.stats["prefix_cache_bytes"] = self._prefix_index.total_bytes
            if self._kv_tier is not None:
                # the tier's entries are old-weights K/V too (a straggler's
                # checkpoint then replays instead of splicing stale cache)
                self._kv_tier.set_version(swap.version)
            self.stats["weight_swaps"] += 1
            self._flight({"type": "weight_swap", "old_version": old_v,
                          "new_version": swap.version, "drained_lanes": swap.drain_lanes or 0,
                          "waited_polls": swap.waited_polls})
            self._pending_swap = None
        logger.info("weight swap %r -> %r (drained %d lanes over %d polls)",
                    old_v, swap.version, swap.drain_lanes or 0, swap.waited_polls)
        if not swap.future.done():
            swap.future.set_result(swap.version)

    def _swap_preempt_stragglers(self, pending) -> None:
        """The swap's straggler bound: the drain outran ``swap_drain_ms``,
        so every in-flight lane and chunked admission is checkpointed
        instead of holding the flip hostage. Policy ``"resume"`` requeues
        them to resume AFTER the flip, on the new weights; ``"fail"``
        refuses those with emitted tokens (WeightVersionMismatch, 409) and
        requeues the others (no old-weights prefix to betray)."""
        self._drain_pending(pending)
        victims = [self._chunked.pop(slot).request for slot in sorted(self._chunked)]
        victims += [self._checkpoint_lane(slot) for slot in sorted(self._active)]
        if not victims:
            return
        self.stats["swap_preemptions"] += len(victims)
        self._flight({"type": "swap_straggler_preempt", "lanes": len(victims),
                      "policy": self.swap_resume_policy, "swap_drain_ms": self.swap_drain_ms})
        logger.warning("weight swap straggler bound hit after %dms: %d in-flight lane(s) "
                       "checkpointed (policy=%s)", self.swap_drain_ms, len(victims),
                       self.swap_resume_policy)
        for req in victims:
            if self.swap_resume_policy == "fail" and req.resume is not None:
                if not req.future.done():
                    req.future.set_exception(WeightVersionMismatch(
                        f"generation preempted by a weight swap after swap_drain_ms="
                        f"{self.swap_drain_ms} and swap_resume_policy=fail forbids "
                        "resuming its emitted prefix under the new weights; re-submit"))
            else:
                self._resume_queue.append(req)

    def _do_drain(self, job: _DrainJob, pending) -> None:
        """A staged graceful drain at this poll boundary: flush the
        pipeline (checkpoints need exact host state), checkpoint every
        live lane, collect chunked admissions whole, then the resume and
        admit queues. Admissions are already refused (``health`` flipped
        on the caller's thread), so the list is complete. A job its
        caller cancelled (timeout) is dropped before any lane is touched
        and the member serves on."""
        if not job.future.set_running_or_notify_cancel():
            with self._drain_lock:
                if self._pending_drain is job:
                    self._pending_drain = None
            self.health = "serving"
            logger.warning("graceful drain cancelled by its caller before the poll "
                           "boundary; admissions resumed")
            return
        # re-assert the latch: a supervised restart since staging wrote
        # "serving" back
        self.health = "draining"
        try:
            self._drain_pending(pending)
            drained = [self._chunked.pop(slot).request for slot in sorted(self._chunked)]
            n_chunked = len(drained)
            lanes = [self._checkpoint_lane(slot) for slot in sorted(self._active)]
            drained += lanes
            while self._resume_queue:
                drained.append(self._resume_queue.popleft())
            while True:
                try:
                    drained.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            drained = [r for r in drained if not r.future.cancelled()]
            self.stats["drains"] += 1
            self._flight({"type": "drain", "lanes": len(lanes),
                          "checkpoints": sum(r.resume is not None for r in lanes),
                          "chunked": n_chunked, "handed": len(drained)})
            logger.info("graceful drain: %d lane(s) checkpointed (%d with emitted tokens), "
                        "%d chunked, %d requests handed to migration", len(lanes),
                        sum(r.resume is not None for r in lanes), n_chunked, len(drained))
            with self._drain_lock:
                self._pending_drain = None
            if not job.future.done():
                job.future.set_result(drained)
        except Exception as e:  # noqa: BLE001 - the drain's caller must wake
            with self._drain_lock:
                self._pending_drain = None
            if not job.future.done():
                job.future.set_exception(e)

    def _burst_tenant(self) -> str:
        """The tenant of a whole-batch dispatch: the one tenant every live
        lane belongs to, or "" when they mix or have none (the pager
        serves one resident tenant at a time, so bursts are one tenant's
        in practice)."""
        tenants = {s.request.tenant for s in self._active.values()}
        if len(tenants) != 1:
            return ""
        return tenants.pop() or ""

    # -- decode dispatch -----------------------------------------------------

    def _plan_groups(self, adv: int):
        """Partition live lanes into <= depth_groups sub-bursts by
        attention-read bucket: ``([(lanes, bucket)], need)``, groups
        shallow-first; ``need[slot]`` is the lane's own bucket. One
        candidate group per distinct bucket, then adjacent groups merge
        shallow-into-deep, cheapest first, while the modelled per-step
        cost of keeping them split (one more param read) exceeds the KV
        read the split saves (lanes x bucket gap x K+V bytes per
        position), or while there are more groups than the cap."""
        need = {
            slot: self._attn_need(self._pos_host[slot] + adv)
            for slot in self._active
        }
        groups = [
            ([s for s in sorted(need) if need[s] == b], b)
            for b in sorted(set(need.values()))
        ]
        if self.depth_groups <= 1 or len(groups) == 1:
            if len(groups) > 1:
                groups = [(sorted(need), max(need.values()))]
            return groups, need
        while len(groups) > 1:
            best_i, best_delta = None, None
            for i in range(len(groups) - 1):
                lanes_s, b_s = groups[i]
                _, b_d = groups[i + 1]
                delta = (
                    len(lanes_s) * (b_d - b_s) * self._kv_key_bytes
                    - self._group_split_bytes
                )
                if best_delta is None or delta < best_delta:
                    best_i, best_delta = i, delta
            if len(groups) > self.depth_groups or best_delta < 0:
                lanes_s, _ = groups.pop(best_i)
                lanes_d, b_d = groups[best_i]
                groups[best_i] = (sorted(lanes_d + lanes_s), b_d)
            else:
                break
        return groups, need

    def _group_size_bucket(self, n: int) -> int:
        """pow2 group-size bucket (one set of graphs per size)."""
        g = 1
        while g < n:
            g <<= 1
        return min(g, self.slots)

    def _warm_group_sizes(self) -> List[int]:
        """Every pow2 group-size bucket a mixed-depth poll can dispatch,
        plus the whole batch: the one enumeration the group buffers and
        warm()'s captures both follow."""
        gb = 1
        gbs = [self.slots]
        while gb < self.slots:
            gbs.append(gb)
            gb <<= 1
        return sorted(set(gbs))

    def _fused_plan(self, k_max: int):
        """Adaptive K for the stop-aware fused burst: ``(k, reason)``.
        Start from the pow2-floored ``fused_steps_per_dispatch`` and
        shrink to the nearest lane's remaining budget (pow2-floored;
        reason ``"stop_budget"``), never below the ``steps_per_poll``
        burst; while the HBM ledger is latched, to ``steps_per_poll``
        (reason ``"pressure"``: the reclaim ladder runs only between
        dispatches); while a weight swap or a drain is staged, to
        ``steps_per_poll`` (reason ``"poll_boundary"``: both act at a
        poll boundary, which a K-step burst would delay by K steps)."""
        k, reason = k_max, None
        floor = min(self._k, k_max)
        rem = [
            r for r in (
                s.request.max_new_tokens - s.dispatched - (1 if s.first_pending else 0)
                for s in self._active.values()
            ) if r > 0
        ]
        if rem:
            tight = max(_pow2_floor(min(rem)), floor)
            if tight < k:
                k, reason = tight, "stop_budget"
        if self._pressure.budget_bytes > 0 and self._pressure.active and floor < k:
            k, reason = floor, "pressure"
        # unlocked reads: a one-poll-late shrink is harmless
        if (self._pending_swap is not None or self._pending_drain is not None) and floor < k:
            k, reason = floor, "poll_boundary"
        return max(1, min(k, k_max)), reason

    def _sync_masks(self) -> None:
        """Upload the lanes' active mask and temperatures after a
        membership change (never per burst)."""
        temps = np.zeros((self.slots,), np.float32)
        active = np.zeros((self.slots,), bool)
        for i, s in self._active.items():
            temps[i] = s.request.temperature
            active[i] = True
        self._upload(self._whole.act, active)
        self._upload(self._whole.temps, temps)
        self._any_stoch = bool((temps > 0).any())
        self._masks_dirty = False
        self._fused_sync = False

    def _sync_stops(self) -> None:
        """Upload each lane's stop token (-1: none) and remaining budget
        for the fused burst; the device then decrements its own copy."""
        stops = np.full((self.slots,), -1, np.int64)
        budget = np.zeros((self.slots,), np.int64)
        for i, s in self._active.items():
            if s.request.eos_id is not None:
                stops[i] = int(s.request.eos_id)
            budget[i] = (
                s.request.max_new_tokens - s.dispatched - (1 if s.first_pending else 0)
            )
        self._upload(self._whole.stops, stops)
        self._upload(self._whole.budget, budget)
        self._fused_sync = True

    def _rb(self, kind: str, **kw) -> int:
        """Modelled read bytes of one dispatch (the ledger's cost model)
        at the live param and K/V widths."""
        return int(self.model.dispatch_read_bytes(
            kind, param_bytes=self._param_bytes, kv_row_bytes=self._kv_key_bytes, **kw))

    def _dispatch(self, pending) -> Optional[Dict[str, Any]]:
        """Dispatch one poll's decode: a whole-batch burst, or one
        sub-burst per depth group; each queues its tokens for the host.
        Returns the poll's decode plan for the flight recorder (None with
        the recorder off)."""
        if self._masks_dirty:
            self._sync_masks()
        if self._spec_active():
            return self._dispatch_spec(pending)
        # the step kind warm() captured (a configured draft keeps the
        # fused plan off, also while rung 2 suppresses speculation)
        masked = self._masked_steps
        fused_k = self._fused_k  # one snapshot per poll
        use_fused = masked and fused_k > 0
        reason = None
        if masked:
            # fused 0 on a fused member: bursts of the poll length
            k, reason = self._fused_plan(fused_k or self._k)
            if not self._fused_sync:
                self._sync_stops()
        else:
            k = self._k
        groups, need = self._plan_groups(k)
        plan = None
        if self.flight is not None and self.flight.enabled:
            # the depth-group plan and the cost model's verdict: distinct
            # need buckets minus dispatched groups is how many splits it
            # merged away; one record per poll, never per step
            distinct = len(set(need.values()))
            plan = {
                "mode": "fused" if use_fused else "decode", "k": k,
                "groups": [{"lanes": len(lanes), "bucket": b} for lanes, b in groups],
                "distinct_buckets": distinct, "merged": distinct - len(groups),
            }
            if use_fused:
                plan["k_max"] = fused_k
                if reason is not None:
                    plan["shrunk_by"] = reason
        tenant = self._burst_tenant() if self._prof.enabled else ""
        for lanes, g_bucket in groups:
            whole = len(groups) == 1
            # snapshot BEFORE dispatch: this burst's tokens belong to these
            # occupants, whatever the host learns later; a lane's column is
            # its slot in a whole-batch burst, its row in a group's
            snapshot = {}
            for col, slot in enumerate(lanes):
                s = self._active[slot]
                first = s.first_pending
                snapshot[slot] = (s, 0 if first else 1, slot if whole else col)
                s.first_pending = False
                s.dispatched += k + (1 if first else 0)
                self._pos_host[slot] += k
            rows = self.slots if whole else self._group_size_bucket(len(lanes))
            if whole:
                kind = "fused_burst" if use_fused else "decode_burst"
                variant = f"k{k}b{g_bucket}" if use_fused else f"b{g_bucket}"
                n_tok = k * rows
            else:
                kind = "group_burst"
                variant = f"k{k}r{rows}b{g_bucket}" if use_fused else f"r{rows}b{g_bucket}"
                n_tok = k * len(lanes)
            read = self._rb(kind, rows=rows, k=k, bucket=g_bucket)
            with self._prof.measure(kind, variant=variant, tenant=tenant, bytes_read=read,
                                    tokens=n_tok), device_trace("gen.decode_burst"):
                if whole:
                    toks, counts = self._whole_burst(k, g_bucket, self._any_stoch, masked)
                else:
                    pads = [i for i in range(self.slots) if i not in snapshot]
                    toks, counts = self._group_burst(
                        lanes + pads[: rows - len(lanes)], len(lanes), k, g_bucket,
                        self._any_stoch, masked,
                    )
            if not whole:
                self.stats["group_bursts"] += 1
                self.stats["group_lanes"] += len(lanes)
                self.stats["group_pad_lanes"] += rows - len(lanes)
            pending.append(_Burst(toks, counts, snapshot, k, self._pinned))
            self.stats["steps"] += k
            self.stats["lane_steps"] += k * rows
            self.stats["burst_reads"] += 1
            self.stats["burst_read_bytes"] += read
            if use_fused:
                self.stats["fused_dispatches"] += 1
                self.stats["fused_steps"] += k
            if self.trace_groups is not None:
                self.trace_groups.append({
                    "lanes": tuple(lanes), "attn_len": g_bucket,
                    "need": {i: need[i] for i in lanes}, "grouped": not whole,
                    "k": k, "tenant": self._burst_tenant(),
                })
        # PREDICTIVE FREE: an eos-less lane whose budget the dispatched
        # bursts already cover is done; free it now so the next admission
        # queues behind the in-flight bursts instead of waiting for them
        freed = [
            slot for slot, s in self._active.items()
            if s.request.eos_id is None and s.dispatched >= s.request.max_new_tokens
        ]
        for slot in freed:
            # a pre-freed lane never reaches _finish: publish its prompt
            # now, before its next occupant's insert
            self._maybe_publish(slot, self._active.pop(slot))
            self._pos_host.pop(slot, None)
        if freed:
            self._masks_dirty = True
        return plan

    def _dispatch_spec(self, pending) -> Optional[Dict[str, Any]]:
        """Dispatch one spec burst: ``k`` rounds over the whole batch
        (spec bursts stay whole-batch under depth groups: their advance
        is data-dependent and the verify already shares the param read),
        at the attention bucket covering every lane's worst-case end of
        burst, ``k * (gamma + 1)`` positions on. No lane is pre-freed:
        how many tokens a round emits is known only once it is read."""
        k = self._k
        adv = k * (self.speculate_tokens + 1)
        attn_len = self._attn_need(max(self._pos_host[i] for i in self._active) + adv)
        snapshot = {}
        for slot, s in self._active.items():
            first = s.first_pending
            snapshot[slot] = (s, 0 if first else 1, slot)
            s.first_pending = False
            s.dispatched += k + (1 if first else 0)
            self._pos_host[slot] += adv
        stoch = self._any_stoch
        with self._prof.measure(
                "spec_burst", variant=f"g{self.speculate_tokens}b{attn_len}",
                tenant=self._burst_tenant() if self._prof.enabled else "",
                bytes_read=self._rb("spec_burst", rows=self.slots, k=k, bucket=attn_len),
                tokens=k * self.slots), device_trace("gen.decode_burst"):
            self._phase(("spec", attn_len, stoch), lambda: self._spec_burst(attn_len, stoch))
        pending.append(_Burst(self._spec_out, None, snapshot, k, self._pinned, spec=True))
        self.stats["steps"] += k
        self.stats["lane_steps"] += k * self.slots
        if self.flight is not None and self.flight.enabled:
            return {"mode": "spec", "k": k, "attn_len": attn_len,
                    "lanes": len(self._active)}
        return None

    def _process_spec_burst(self, burst: _Burst) -> None:
        """Credit one spec burst: per round a lane emitted ``count`` tokens
        (accepted drafts, then the target's correction or bonus token),
        credited round by round up to its stop; the lane's host position
        bound tightens from the worst case ``k * (gamma + 1)`` to what
        its rounds emitted."""
        host, _ = burst.numpy()  # the burst's one host read
        if self._prof.enabled:
            self._prof.resolve()
        k, g = burst.k, self.speculate_tokens
        start_tok = host[0]
        toks = host[1: 1 + k * (g + 1)].reshape(k, g + 1, -1)
        counts = host[1 + k * (g + 1):]  # [k, slots]
        # acceptance over every lane that ran rounds, whatever the host
        # credits of them
        self.stats["spec_rounds"] += int((counts > 0).sum())
        self.stats["spec_emitted"] += int(counts.sum())
        worst = k * (g + 1)
        for slot, (s, start, _col) in burst.snapshot.items():
            if self._active.get(slot) is not s:
                continue
            if slot in self._pos_host:
                self._pos_host[slot] -= worst - int(counts[:, slot].sum())
            done = False
            if start == 0:
                done = self._credit(s, [int(start_tok[slot])])
            for r in range(k):
                if done:
                    break
                done = self._credit(s, toks[r, : int(counts[r, slot]), slot])
        self._check_done()

    def _flight(self, entry: Dict[str, Any]) -> None:
        """One typed event record, when the recorder is on."""
        if self.flight is not None and self.flight.enabled:
            self.flight.record(entry)

    def _record_poll(self, flight: FlightRecorder, f0, plan, pending) -> None:
        """The poll's record (when it admitted, chunked or dispatched):
        the queue and lanes, the counters' deltas, the decode plan and the
        ledger's rows since the last flush (a quiet poll's rows roll into
        the next record)."""
        admitted = self.stats["admitted"] - f0[0]
        chunks = self.stats["prefill_chunks"] - f0[1]
        if plan is None and not admitted and not chunks:
            return
        entry: Dict[str, Any] = {
            "type": "poll", "queue": self._queue.qsize(), "active": len(self._active),
            "chunked": len(self._chunked), "pending_bursts": len(pending),
        }
        hits = self.stats["prefix_hits"] - f0[2]
        evicted = self.stats["prefix_evicted"] - f0[3]
        for name, n in (("admitted", admitted), ("prefill_chunks", chunks),
                        ("prefix_hits", hits), ("prefix_evicted", evicted)):
            if n:
                entry[name] = n
        if plan is not None:
            entry["plan"] = plan
        if self._prof.enabled:
            rows = self._prof.poll_flush()
            if rows:
                entry["device_time"] = rows
        flight.record(entry)

    def _loop(self) -> bool:
        """One supervised run of the poll loop. False on a clean close(),
        else :meth:`_crash_recover`'s verdict after a loop death."""
        pending: "collections.deque" = collections.deque()
        try:
            while not self._stop.is_set():
                self._poll_count += 1
                if self.fault_hook is not None:
                    self.fault_hook(self._poll_count)
                if self.tenant_hook is not None:
                    # the TenantScheduler's poll clock (its starvation
                    # bound counts scheduler polls)
                    self.tenant_hook(self._poll_count)
                if (self._active or self._chunked or pending or self._resume_queue
                        or not self._queue.empty()):
                    self._work_poll_count += 1
                if self.pressure_hook is not None or self._pressure.budget_bytes > 0:
                    # refresh the ledger; over the high watermark, run the
                    # reclaim ladder at this poll boundary
                    self._pressure_poll(pending)
                # flight recorder: counters at the poll's start, so that
                # the poll record carries what this poll did
                flight = self.flight if self.flight is not None and self.flight.enabled else None
                if flight is not None:
                    f0 = (self.stats["admitted"], self.stats["prefill_chunks"],
                          self.stats["prefix_hits"], self.stats["prefix_evicted"])
                plan = None
                # graceful drain: checkpoint everything at this boundary
                # and hand it to the caller; admissions are refused since
                # drain() latched "draining"
                drain = self._pending_drain
                if drain is not None:
                    self._do_drain(drain, pending)
                    continue
                # live retune: applied here, before this poll reads any
                # knob, so one poll never sees a half-applied configuration
                # (an unlocked read: _do_retune re-checks under the lock)
                retune = self._pending_retune
                if retune is not None:
                    self._do_retune(retune)
                # live weight swap: admissions hold while in-flight lanes,
                # chunked admissions and bursts finish on the old weights;
                # the flip comes when all three are empty, so no burst mixes
                # versions (an unlocked read: _do_swap re-checks the job
                # under the lock)
                swap = self._pending_swap
                if swap is not None:
                    if swap.drain_lanes is None:
                        swap.drain_lanes = len(self._active) + len(self._chunked)
                    if self._active or self._chunked or pending:
                        swap.waited_polls += 1
                        if (self.swap_drain_ms
                                and time.monotonic() - swap.staged_t >= self.swap_drain_ms / 1e3):
                            self._swap_preempt_stragglers(pending)
                    if not self._active and not self._chunked and not pending:
                        self._do_swap(swap)
                        swap = None
                # admissions wait while the ledger is latched
                hold = self._pressure.budget_bytes > 0 and self._pressure.active
                wave: List[GenRequest] = []
                busy = len(self._active) + len(self._chunked)
                wave_cost = 0
                while swap is None and not hold and busy + len(wave) < self.slots:
                    # preempted requests resume ahead of newer work
                    if self._resume_queue:
                        req = self._resume_queue.popleft()
                    else:
                        try:
                            req = self._queue.get_nowait()
                        except queue.Empty:
                            break
                    if req.deadline_t is not None and time.monotonic() >= req.deadline_t:
                        req.future.cancel()  # its budget ran out in the queue
                    if req.future.cancelled():
                        self.stats["cancelled"] += 1
                        # a preempted-then-cancelled request must not leave
                        # its K/V checkpoint pinning tier budget
                        self._release_tier_ckpt(req)
                        continue  # the caller gave up while queued
                    if self._spec_suppressed and req.temperature != 0.0:
                        # while rung 2 keeps speculation off, a sampled
                        # request waits at the head of the line: admitted
                        # now it would switch to speculation mid-stream,
                        # and its stream depends on that (a greedy one
                        # does not)
                        self._resume_queue.appendleft(req)
                        break
                    if self._pressure.budget_bytes > 0:
                        # watermark-aware admission: a request whose end of
                        # generation would trip the high watermark waits at
                        # the head of the line (admitted now it would only
                        # be preempted); alone it always admits
                        cost = self._admit_cost_bytes(req)
                        if (busy + len(wave)) and (
                            self._pressure.used + wave_cost + cost
                            >= self._pressure.high_bytes
                        ):
                            self._resume_queue.appendleft(req)
                            break
                        wave_cost += cost
                    wave.append(req)
                if wave:
                    self._admit_wave(wave)
                if not self._active and not pending and not self._chunked and not (
                        self._resume_queue and not hold):
                    try:
                        req = self._queue.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    self._queue.put(req)
                    continue
                if self._chunked:
                    # the interleave: one prefill chunk per long admission,
                    # then the decode burst, so decode lanes keep their pace
                    self._advance_chunks()
                if self._active:
                    plan = self._dispatch(pending)
                if flight is not None:
                    self._record_poll(flight, f0, plan, pending)
                # read bursts oldest-first: always when the pipeline is
                # full (or nothing is left to dispatch), and early when a
                # burst's copy has already landed
                while pending:
                    if not (len(pending) >= self.pipeline_depth or not self._active):
                        if not pending[0].ready():
                            break
                    self._process_burst(pending.popleft())
        except Exception:  # noqa: BLE001 - every loop death is supervised
            logger.exception("continuous batcher loop died")
            return self._crash_recover(pending)
        return False  # clean stop via close()


def _pow2_floor(n: int) -> int:
    while n & (n - 1):
        n &= n - 1
    return n


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _map_tree(tree, fn):
    """``fn`` over every tensor leaf of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _cast_tree(tree, dt: torch.dtype):
    """Float32 leaves -> ``dt`` (other leaves unchanged), nested dicts."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dt) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32 and dt != torch.float32:
        return tree.to(dt)
    return tree
