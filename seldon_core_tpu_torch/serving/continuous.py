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
  (``graph_captures_inline``). Every tensor a graph touches is a
  persistent buffer updated in place. On the CPU the same phase
  functions run eagerly.
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
* Prefill, chunk and lane insert run inside ``tracing.device_trace``
  ranges (``gen.prefill``, ``gen.prefill_chunk``, ``gen.lane_insert``),
  decode bursts inside ``gen.decode_burst``, named in ``torch.profiler``
  traces.

Every other scheduler feature of the JAX batcher (speculation, the host
KV tier, weight swap, drain, retune, the flight recorder, the
device-time profiler, tenants, the mesh) is not ported yet: its knob
raises when set to anything but its off value.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import rng
from ..resilience import ShedError
from ..tracing import device_trace
from .prefix_cache import RadixPrefixIndex
from .pressure import PressureController

logger = logging.getLogger(__name__)

# Scheduler knobs of the JAX batcher that this port does not implement
# yet, with the value that turns each off; any other value raises. They
# are the mesh (multi-device serving), speculation (a draft model), the
# flight recorder, the host KV tier, weight swap and the device-time
# profiler.
NOT_PORTED_KNOBS: Dict[str, Any] = {
    "mesh": None,
    "shard_cache_seq": False,
    "draft_model": None,
    "draft_params": None,
    "flight_recorder_capacity": 0,
    "host_kv_tier_bytes": 0,
    "swap_drain_ms": 0,
    "profiler": None,
}
# knobs that only act through one of the features above (speculation's
# length, the host tier's thresholds, the swap's resume policy); accepted
# at any value so JAX-package configs carry over
INERT_KNOBS = (
    "speculate_tokens", "kv_tier_min_tokens", "kv_tier_promote_min_tokens",
    "swap_resume_policy",
)


def check_not_ported(knobs: Dict[str, Any], owner: str) -> None:
    """Raise for a knob of an unported feature set to an enabling value,
    and for a knob this package does not know at all."""
    for name, value in knobs.items():
        if name in INERT_KNOBS:
            continue
        if name not in NOT_PORTED_KNOBS:
            raise TypeError(f"{owner} got an unknown knob {name!r}")
        off = NOT_PORTED_KNOBS[name]
        if value == off:
            continue
        raise NotImplementedError(
            f"{owner}: {name}={value!r} is not ported to seldon_core_tpu_torch "
            f"yet (only its off value {off!r} is supported)"
        )


class PromptTooLong(ValueError):
    """The request cannot fit the serving cache: the prompt exceeds every
    prefill bucket and ``max_seq``. Carries a 413 wire status."""

    status = 413


class BudgetExceeded(PromptTooLong):
    """``prompt_len + max_new_tokens > max_seq``: the generation would
    outgrow the decode cache. Rejected at submit with the 413 status."""


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
    # absolute deadline (monotonic seconds) when the submit carried a
    # budget: past it the scheduler cancels the request and frees its lane
    # (the preemption victim choice spares such lanes longest)
    deadline_t: Optional[float] = None
    # preemption checkpoint ``{"emitted": [...], "key": [hi, lo]}``, set
    # when the pressure ladder took the lane mid-decode: the emitted
    # tokens and the lane's post-split key, never its K/V (the resume
    # recomputes it). None = never preempted, or preempted before any
    # token was credited (a plain re-admit then reproduces the stream)
    resume: Optional[Dict[str, Any]] = None


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
    column)``)."""

    def __init__(self, toks: torch.Tensor, counts: Optional[torch.Tensor],
                 snapshot, k: int, pool: Optional[_PinnedPool]):
        self.snapshot = snapshot
        self.k = k
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
        cuda_graphs: bool = True,
        **knobs,
    ):
        check_not_ported(knobs, "ContinuousBatcher")
        self.model = model
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
        # test hook: set to a list and every dispatched decode (sub)burst
        # appends {"lanes", "attn_len", "need", "grouped", "k"}, the
        # proof that no lane reads past its own group's bucket
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
        # HBM pressure: the unified ledger (0 bytes = off: the loop never
        # consults it), the chaos hook (called each working poll; an int
        # re-budgets the ledger, -1 restores the boot budget), and the
        # preempted requests awaiting resume, admitted ahead of the queue
        self._pressure = PressureController(
            hbm_ledger_bytes, high=pressure_high, low=pressure_low
        )
        self.pressure_hook: Optional[Any] = None
        self._resume_queue: "collections.deque" = collections.deque()
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
            "burst_reads": 0, "burst_read_bytes": 0,
            "group_bursts": 0, "group_lanes": 0, "group_pad_lanes": 0,
            "fused_steps": 0, "fused_dispatches": 0,
            # decode-burst CUDA graphs: captures, their seconds, the device
            # memory the graph pool reserved while capturing, captures
            # after warm(), and replays
            "graphs_captured": 0, "graph_capture_s": 0.0, "graph_pool_bytes": 0,
            "graph_captures_inline": 0, "graph_replays": 0,
            "steps_per_poll_effective": k,
            "slo_samples": 0, "queue_wait_s_sum": 0.0,
            "ttft_s_sum": 0.0, "tpot_s_sum": 0.0,
        }
        # (queue_wait, ttft, tpot) of completed requests: ``slo_pending``
        # drains into response metrics, ``slo_recent`` is a reservoir for
        # percentiles
        self.slo_pending: "collections.deque" = collections.deque(maxlen=4096)
        self.slo_recent: "collections.deque" = collections.deque(maxlen=2048)

        dt = model.dtype
        self.device = params["embed"].device
        # params are stored in the compute dtype: the forward casts at use,
        # so pre-casting is numerically identical and halves the bytes
        # every decode step reads
        self.params = _cast_tree(params, dt)
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
        # decode bursts replay CUDA graphs on the card; ``cuda_graphs=False``
        # keeps them eager (the comparison the on-card smoke run makes)
        self._graphs = (
            _StepGraphs(self.device, self.stats)
            if cuda_graphs and self.device.type == "cuda" else None
        )
        kmax = max(self._k, self._fused_k)
        self._pinned = (
            _PinnedPool((kmax + 2) * self.slots, self.pipeline_depth + 1)
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
        )
        req.submit_t = time.monotonic()
        if deadline_s is not None:
            req.deadline_t = req.submit_t + float(deadline_s)
        req.future.gen_request = req
        self._queue.put(req)
        if self._stop.is_set():
            # the loop died between the entry check and the put: fail the
            # stranded queue here instead of leaving the future unresolved
            self._drain_queue(self._dead_error())
            return req.future
        self.start()
        return req.future

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

    def _shed_check(self, deadline_s: Optional[float]) -> None:
        """Admit-queue shedding, BEFORE the request costs any device work:
        the HBM-pressure watermark (while the ledger is latched over its
        high watermark: the reclaim ladder's last rung), an explicit queue
        cap, and the deadline-aware rule (expected queue wait = depth /
        observed completion rate > remaining budget)."""
        pc = self._pressure
        if pc.budget_bytes > 0 and pc.active:
            self.stats["shed"] += 1
            self.stats["pressure_sheds"] += 1
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
            raise ShedError(
                f"deadline {deadline_s * 1000:.0f}ms below estimated queue "
                f"wait {est_wait * 1000:.0f}ms ({depth} queued at "
                f"{rate:.2f} req/s) — shed before work",
                retry_after_s=est_wait,
            )

    def generate(self, tokens, **kw) -> List[int]:
        """Blocking convenience: submit and wait for the generated ids."""
        return self.submit(tokens, **kw).result()

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
        """p50/p99 of queue wait, TTFT and TPOT over the recent reservoir."""
        if not self.slo_recent:
            return None

        def pct(vals: List[float]) -> Dict[str, float]:
            a = np.asarray(vals, np.float64)
            return {"p50": float(np.percentile(a, 50)), "p99": float(np.percentile(a, 99)),
                    "n": int(a.size)}

        rec = list(self.slo_recent)
        out = {
            "queue_wait_s": pct([r[0] for r in rec]),
            "ttft_s": pct([r[1] for r in rec]),
        }
        tpots = [r[2] for r in rec if r[2] is not None]
        if tpots:
            out["tpot_s"] = pct(tpots)
        return out

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
        # and its adaptive K shrinks to the poll burst at the least
        adv = max(self._k, self._fused_k)
        least = min(self._k, self._fused_k) if self._fused_k else self._k
        # attention buckets a run at these prompt lengths can touch, from
        # the shallowest lane's first burst (alone, or in a depth group of
        # its own) to the deepest end of budget; an eos lane outlives its
        # budget until the host reads its stop, up to pipeline_depth - 1
        # bursts of extra _pos_host advance
        lo = min(prompt_lens) if prompt_lens else 1
        hi = (
            (max(prompt_lens) if prompt_lens else 1)
            + max_new_tokens
            + adv * (1 + max(0, self.pipeline_depth - 1))
        )
        attn_lens = sorted(
            {self._attn_need(p) for p in range(lo + least, hi + 1, self.attn_bucket)}
            | {self._attn_need(hi)}
        )
        for bucket in buckets:
            for m in batch_sizes:
                if m > self.slots:
                    continue  # a wave can never exceed the lane pool
                if m == 8 and not self._chunk8_ok(bucket):
                    continue
                prompts = np.zeros((m, bucket), np.int64)
                last = np.zeros((m,), np.int64)
                firsts, slab, keys = self._prefill(prompts, last, [0] * m, [0.0] * m)
                self._insert(slab, list(range(m)), firsts, last + 1, keys)
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
        self._warm_bursts(attn_lens)
        if self._pressure.budget_bytes > 0 or self.pressure_hook is not None:
            # a resume replays at the bucket of its lane's end position,
            # which can lie at any bucket from the shallowest prompt up
            self._warm_replay(sorted(set(attn_lens) | {self._attn_need(lo)}))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # warm left garbage in the lane registers: reset them
        self._reset_lanes()

    def _warm_bursts(self, attn_lens: Sequence[int]) -> None:
        """Every decode-burst phase key reachable at these attention
        buckets: the one step kind this configuration dispatches (masked
        when fused decode is on), greedy and sampled, over the whole
        batch and, with depth groups, every group size. On the card each
        key is run once and captured; on the CPU each phase runs once."""
        masked = self._fused_k > 0
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
        # chunked admissions still holding a reserved lane
        for job in self._chunked.values():
            if not job.request.future.done():
                job.request.future.set_exception(self._dead_error())
        self._chunked.clear()

    def _drain_queue(self, err: Exception) -> None:
        while self._resume_queue:
            req = self._resume_queue.popleft()
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
        with device_trace("gen.prefill"):
            firsts, slab, lane_keys = self._prefill(
                prompts, last, [r.seed for r in reqs], [r.temperature for r in reqs]
            )
        with device_trace("gen.lane_insert"):
            self._insert(slab, slots, firsts, last + 1, lane_keys)
        for slot, req in zip(slots, reqs):
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
        if hit is not None:
            m, slab = hit
            wb = self._bucket(n - m)
            suffix = np.zeros((1, wb), np.int64)
            suffix[0, : n - m] = req.tokens[m:]
            with device_trace("gen.prefill"):
                first, suffix_slab, key = self._prefix_prefill(
                    slab, suffix, m, n - 1 - m, req.seed, req.temperature)
            first, key, pos = cont or (first, key, n)
            with device_trace("gen.lane_insert"):
                self._insert_prefix(slab, suffix_slab, slot, m, first, pos, key)
            req.cache_hit_tokens = m
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_saved"] += m
            self.stats["prefill_tokens"] += wb
        else:
            bucket = self._bucket(n)
            prompt = np.zeros((1, bucket), np.int64)
            prompt[0, :n] = req.tokens
            with device_trace("gen.prefill"):
                first, slab, key = self._prefill(prompt, np.asarray([n - 1], np.int64),
                                                 [req.seed], [req.temperature])
            first, key, pos = cont or (first, key, n)
            with device_trace("gen.lane_insert"):
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
        host_toks, counts = burst.numpy()  # the burst's one host read
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
        fits), 4, or 1."""
        free_iter = iter(
            i for i in range(self.slots) if i not in self._active and i not in self._chunked
        )
        by_bucket: Dict[int, List[GenRequest]] = {}
        for req in wave:
            if req.resume is not None:
                self._admit_one(self._admit_resume, next(free_iter), req)
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
                m = 1
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
        """``admit(slot, req, *args)``; a failure fails the request alone
        and frees the lane it reserved."""
        try:
            admit(slot, req, *args)
        except Exception as e:  # noqa: BLE001 - bad request/device state
            logger.exception("admit failed")
            self._chunked.pop(slot, None)
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
                with torch.no_grad():
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
            try:
                with device_trace("gen.prefill_chunk"):
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
                    with device_trace("gen.lane_insert"):
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
        slab = self._extract_prefix(slot, self._bucket(n))
        nbytes = sum(t.numel() * t.element_size() for t in slab.values())
        self.stats["prefix_evicted"] += idx.insert(toks, slab, nbytes)
        self.stats["prefix_cache_bytes"] = idx.total_bytes

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
        K/V bytes per position, the chunked-prefill staging slabs, and the
        prefix cache's bytes. Host arithmetic over at most ``slots``
        entries."""
        per_tok = self._kv_key_bytes
        return {
            "decode": sum(self._attn_need(p) for p in self._pos_host.values()) * per_tok,
            "staging": sum(job.bucket for job in self._chunked.values()) * per_tok,
            "prefix": self._prefix_index.total_bytes if self._prefix_index is not None else 0,
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
        if pc.budget_bytes <= 0:
            if pc.active:
                pc.update(self._ledger_components())
            return
        if pc.update(self._ledger_components()):
            self._reclaim(pending, pc)

    def _drain_pending(self, pending) -> None:
        """Read every in-flight burst now, oldest first: a checkpoint must
        see its lane's exact host state (emitted tokens, and the device
        position they imply)."""
        while pending:
            self._process_burst(pending.popleft())

    def _reclaim(self, pending, pc: PressureController) -> None:
        """The reclaim ladder, cheapest rung first, until the ledger is
        back under its low watermark:

        1. evict prefix slabs (LRU): pure cache, no work lost;
        2. cancel speculation: nothing to do until speculation is ported;
        3. preempt lanes: checkpoint a victim on the host and requeue it
           for resume, freeing its lane at this poll boundary; never the
           last lane, so one lane always progresses and pressure cannot
           livelock;
        4. shed admissions: while latched the loop holds admissions and
           :meth:`_shed_check` refuses submits."""
        idx = self._prefix_index
        if idx is not None and idx.total_bytes > 0:
            evicted = idx.evict_to(max(0, idx.total_bytes - pc.overshoot_bytes()))
            if evicted:
                self.stats["prefix_evicted"] += evicted
                self.stats["pressure_prefix_evictions"] += evicted
                self.stats["prefix_cache_bytes"] = idx.total_bytes
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

    def _admit_cost_bytes(self, req: GenRequest) -> int:
        """Ledger footprint of ``req`` at the end of its generation: the
        attention bucket of its last position times the K/V bytes per
        position (the watermark-aware admission's price)."""
        end = min(self.max_seq, len(req.tokens) + req.max_new_tokens)
        return self._attn_need(end) * self._kv_key_bytes

    def _pick_victim(self):
        """``("chunked", slot)``, ``("lane", slot)`` or None. Chunked
        admissions first (nothing emitted yet: preempting one loses no
        work and frees a staging slab; the largest first), then decode
        lanes: deadline-free ones before those with a deadline (a lane
        that must answer soon is spared while anything else can yield;
        among those, the most slack first), and within each the most
        remaining budget first (the lane that would hold its slot
        longest yields it)."""
        if self._chunked:
            return "chunked", max(self._chunked, key=lambda s: self._chunked[s].bucket)
        if len(self._active) <= 1:
            return None
        now = time.monotonic()

        def order(slot: int):
            s = self._active[slot]
            req = s.request
            slack = req.deadline_t - now if req.deadline_t is not None else None
            return (
                0 if slack is None else 1,
                -(slack if slack is not None else 0.0),
                -(req.max_new_tokens - len(s.emitted)),
            )

        return "lane", min(self._active, key=order)

    def _preempt_chunked(self, slot: int) -> None:
        """Preempt a chunked admission: drop its staging slab and requeue
        the request whole (a resume's checkpoint rides along on it)."""
        job = self._chunked.pop(slot)
        self.stats["preemptions"] += 1
        self._resume_queue.append(job.request)

    def _preempt_lane(self, slot: int) -> None:
        """Preempt one decode lane (rung 3): checkpoint its emitted tokens
        and its lane key on the host (never its K/V), free the lane and
        requeue the request for resume. The pipeline has been drained, so
        ``emitted`` and the device state agree; the key's one 16-byte read
        is the whole cost."""
        s = self._active.pop(slot)
        req = s.request
        self._pos_host.pop(slot, None)
        self._masks_dirty = True
        if s.emitted:
            req.resume = {"emitted": list(s.emitted),
                          "key": self._whole.keys[slot].tolist()}
        self.stats["preemptions"] += 1
        self._resume_queue.append(req)

    def _admit_resume(self, slot: int, req: GenRequest) -> None:
        """Recompute-resume a preempted request into ``slot``: rebuild its
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
        hit = self._prefix_match(req.tokens)
        if self._needs_chunks(n, hit):
            self._start_chunked(slot, req, hit, (emitted, key))
            return
        cont = (self._to_dev(np.asarray([emitted[-1]], np.int64)),
                self._to_dev(np.asarray([key], np.int64)), n + len(emitted) - 1)
        self._prompt_into_lane(slot, req, hit, cont)
        self._activate_resumed(slot, req, emitted)

    def _activate_resumed(self, slot: int, req: GenRequest, emitted: List[int]) -> None:
        """The resume paths' shared tail: replay the emitted tokens' K/V,
        then re-activate the lane with crediting continuing after the
        checkpoint (spans already streamed are never sent again, and the
        inserted token -- ``emitted[-1]`` -- is not credited twice)."""
        n = len(req.tokens)
        self._replay_emitted(slot, n, emitted[:-1])
        s = _Slot(request=req, emitted=list(emitted), first_pending=False,
                  dispatched=len(emitted))
        self._active[slot] = s
        self._pos_host[slot] = n + len(emitted) - 1
        self._masks_dirty = True
        req.resume = None
        self.stats["preempt_resumes"] += 1

    def _replay_emitted(self, slot: int, start_pos: int, toks: List[int]) -> None:
        """Teacher-forced replay: rebuild positions ``[start_pos,
        start_pos + len(toks))`` of lane ``slot``'s cache from the tokens
        it already emitted, one decode step per token -- a prefill over
        prompt and generated tokens would compute those positions with
        other matmul shapes, which can part the streams at bf16. Each
        step runs over the whole batch, the shape the lane decoded in
        (every other row parked: it writes nothing, and no lane register
        moves), at the attention bucket of the replay's end; on the card
        it replays a graph ``warm()`` captured when pressure is on."""
        if not toks:
            return
        attn_len = self._attn_need(start_pos + len(toks))
        cur = np.zeros((self.slots,), np.int64)
        pos = np.zeros((self.slots,), np.int64)
        wpos = np.full((self.slots,), self.max_seq, np.int64)
        r = self._replay
        for j, tok in enumerate(toks):
            cur[slot], pos[slot], wpos[slot] = tok, start_pos + j, start_pos + j
            self._upload(r["cur"], cur)
            self._upload(r["pos"], pos)
            self._upload(r["wpos"], wpos)
            self._phase(("replay", attn_len), lambda: self._replay_step(attn_len))
        self.stats["replayed_tokens"] += len(toks)

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
        dispatches). The JAX batcher's ``poll_boundary`` reason belongs
        to weight swap and drain, not ported yet."""
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

    def _dispatch(self, pending) -> None:
        """Dispatch one poll's decode: a whole-batch burst, or one
        sub-burst per depth group; each queues its tokens for the host."""
        if self._masks_dirty:
            self._sync_masks()
        masked = self._fused_k > 0
        if masked:
            k, _reason = self._fused_plan(self._fused_k)
            if not self._fused_sync:
                self._sync_stops()
        else:
            k = self._k
        groups, need = self._plan_groups(k)
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
            with device_trace("gen.decode_burst"):
                if whole:
                    rows = self.slots
                    toks, counts = self._whole_burst(k, g_bucket, self._any_stoch, masked)
                else:
                    rows = self._group_size_bucket(len(lanes))
                    pads = [i for i in range(self.slots) if i not in snapshot]
                    toks, counts = self._group_burst(
                        lanes + pads[: rows - len(lanes)], len(lanes), k, g_bucket,
                        self._any_stoch, masked,
                    )
                    self.stats["group_bursts"] += 1
                    self.stats["group_lanes"] += len(lanes)
                    self.stats["group_pad_lanes"] += rows - len(lanes)
                pending.append(_Burst(toks, counts, snapshot, k, self._pinned))
            self.stats["steps"] += k
            self.stats["lane_steps"] += k * rows
            self.stats["burst_reads"] += 1
            self.stats["burst_read_bytes"] += k * (
                self._param_bytes + rows * g_bucket * self._kv_key_bytes
            )
            if masked:
                self.stats["fused_dispatches"] += 1
                self.stats["fused_steps"] += k
            if self.trace_groups is not None:
                self.trace_groups.append({
                    "lanes": tuple(lanes), "attn_len": g_bucket,
                    "need": {i: need[i] for i in lanes}, "grouped": not whole,
                    "k": k,
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

    def _loop(self) -> bool:
        """One supervised run of the poll loop. False on a clean close(),
        else :meth:`_crash_recover`'s verdict after a loop death."""
        pending: "collections.deque" = collections.deque()
        try:
            while not self._stop.is_set():
                self._poll_count += 1
                if self.fault_hook is not None:
                    self.fault_hook(self._poll_count)
                if (self._active or self._chunked or pending or self._resume_queue
                        or not self._queue.empty()):
                    self._work_poll_count += 1
                if self.pressure_hook is not None or self._pressure.budget_bytes > 0:
                    # refresh the ledger; over the high watermark, run the
                    # reclaim ladder at this poll boundary
                    self._pressure_poll(pending)
                hold = self._pressure.budget_bytes > 0 and self._pressure.active
                wave: List[GenRequest] = []
                busy = len(self._active) + len(self._chunked)
                wave_cost = 0
                while not hold and busy + len(wave) < self.slots:
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
                        continue  # the caller gave up while queued
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
                    self._dispatch(pending)
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


def _cast_tree(tree, dt: torch.dtype):
    """Float32 leaves -> ``dt`` (other leaves unchanged), nested dicts."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dt) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32 and dt != torch.float32:
        return tree.to(dt)
    return tree
