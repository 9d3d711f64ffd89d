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
* Prefill and lane insert run inside ``tracing.device_trace`` ranges
  (``gen.prefill``, ``gen.lane_insert``), named in ``torch.profiler``
  traces.

Every other scheduler feature of the JAX batcher (speculation, the
prefix cache, depth groups, chunked prefill, the fused stop-aware burst,
HBM pressure, the host KV tier, weight swap, drain, retune, the flight
recorder, the device-time profiler, the mesh) is not ported yet: its
knob raises when set to anything but its off value.
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

logger = logging.getLogger(__name__)

# Scheduler knobs of the JAX batcher that this port does not implement
# yet, with the value that turns each off. Any other value raises.
NOT_PORTED_KNOBS: Dict[str, Any] = {
    "mesh": None,
    "shard_cache_seq": False,
    "fused_steps_per_dispatch": 0,
    "draft_model": None,
    "draft_params": None,
    "prefix_cache_hbm_bytes": 0,
    "depth_groups": 0,
    "depth_group_split_bytes": None,
    "prefill_chunk": 0,
    "flight_recorder_capacity": 0,
    "hbm_ledger_bytes": 0,
    "host_kv_tier_bytes": 0,
    "swap_drain_ms": 0,
    "profiler": None,
}
# knobs that only act when one of the features above is on; accepted at
# any value so JAX-package configs carry over
INERT_KNOBS = (
    "speculate_tokens", "prefix_cache_min_tokens", "pressure_high",
    "pressure_low", "kv_tier_min_tokens", "kv_tier_promote_min_tokens",
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
        if value == off or (name == "depth_groups" and value in (0, 1)):
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
    # lifecycle timeline (monotonic seconds; 0.0 = not reached)
    submit_t: float = 0.0
    admit_t: float = 0.0
    first_tok_t: float = 0.0
    # absolute deadline (monotonic seconds) when the submit carried a
    # budget: past it the scheduler cancels the request and frees its lane
    deadline_t: Optional[float] = None


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


class _Burst:
    """One dispatched burst's tokens on their way to the host."""

    def __init__(self, toks: torch.Tensor):
        if toks.device.type == "cuda":
            self.host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
            self.host.copy_(toks, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = toks
            self.event = None

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class ContinuousBatcher:
    """Slot-based continuous batching scheduler over a DecoderLM.

    ``submit()`` is thread-safe and returns a Future resolving to the
    prompt plus generated token list. A single scheduler thread owns the
    device loop. The batcher runs on the device its params live on.
    """

    # floor for attn_bucket (kept as the JAX package's value: it changes
    # which cache prefix is read, never what is computed)
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
        restart_budget: int = 3,
        restart_backoff_s: float = 0.5,
        admit_queue_limit: int = 0,
        **knobs,
    ):
        check_not_ported(knobs, "ContinuousBatcher")
        self.model = model
        self.slots = int(slots)
        self.max_seq = int(max_seq or model.cfg.max_seq)
        self.steps_per_poll = int(steps_per_poll)
        # burst length actually dispatched: pow2 floor of steps_per_poll
        k = max(1, self.steps_per_poll)
        while k & (k - 1):
            k &= k - 1
        self._k = k
        if k != self.steps_per_poll:
            logger.info(
                "steps_per_poll=%d rounded down to the pow2 burst length %d",
                self.steps_per_poll, k,
            )
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.attn_bucket = max(type(self).MIN_ATTN_BUCKET, int(attn_bucket))
        self.prefill_buckets = tuple(
            sorted(b for b in prefill_buckets if b <= self.max_seq)
        ) or (self.max_seq,)

        self._queue: "queue.Queue[GenRequest]" = queue.Queue()
        # shed before work: an explicit admit-queue cap (0 = none), and
        # recent completion times for the observed service rate
        self.admit_queue_limit = max(0, int(admit_queue_limit))
        self._finish_times: "collections.deque" = collections.deque(maxlen=32)
        self._active: Dict[int, _Slot] = {}
        self._masks_dirty = True
        self._active_dev = None
        self._temps_dev = None
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
        self._poll_count = 0
        self._warm_args: Optional[Dict[str, Any]] = None
        self.stats: Dict[str, Any] = {
            "admitted": 0, "finished": 0, "cancelled": 0, "steps": 0,
            "lane_steps": 0, "tokens": 0,
            "prefill_steps": 0, "prefill_tokens": 0,
            "batcher_restarts": 0, "shed": 0,
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
        self._alloc_device_state()

    # -- device state ------------------------------------------------------

    def _alloc_device_state(self) -> None:
        """(Re)allocate everything the loop mutates: the per-layer KV
        cache, the lane token/position registers and the lane key
        streams (``PRNGKey(lane)``, as the JAX package)."""
        cfg = self.model.cfg
        shape = (self.slots, cfg.n_kv_heads, self.max_seq, cfg.head_dim)
        dt, dev = self.model.dtype, self.device
        self._cache = {
            "k": [torch.zeros(shape, dtype=dt, device=dev) for _ in range(cfg.n_layers)],
            "v": [torch.zeros(shape, dtype=dt, device=dev) for _ in range(cfg.n_layers)],
        }
        self._reset_lanes()

    def _to_dev(self, arr) -> torch.Tensor:
        """Host array -> device tensor without a host sync: from pinned
        memory the copy queues behind the in-flight bursts instead of
        waiting for them (a pageable copy would synchronise the stream)."""
        t = torch.as_tensor(arr)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _reset_lanes(self) -> None:
        dev = self.device
        self._cur_tok = torch.zeros((self.slots,), dtype=torch.long, device=dev)
        self._pos = torch.zeros((self.slots,), dtype=torch.long, device=dev)
        self._keys = rng.prng_key(torch.arange(self.slots), device=dev)

    # -- device steps (scheduler thread) ------------------------------------

    @torch.no_grad()
    def _prefill(self, prompts: np.ndarray, last: np.ndarray, seeds, temps):
        """Batched prefill of m right-padded prompts ``[m, bucket]`` plus
        each row's first token: ``(firsts [m], slab, lane_keys [m, 2])``.
        The first draw splits ``PRNGKey(seed)`` exactly as every later
        decode step splits the lane key (the JAX package's prefill_many;
        for m = 1 its prefill_one draws the same numbers)."""
        logits, slab = self.model.prefill(
            self.params, self._to_dev(prompts), prompts.shape[1],
            last_index=self._to_dev(last),
        )
        keys = self._to_dev(rng.prng_key(np.asarray(seeds, np.int64)))
        temps_t = self._to_dev(np.asarray(temps, np.float32))
        keys, firsts = rng.sample_next(
            keys, logits, temps_t, stochastic=bool(np.any(np.asarray(temps) > 0))
        )
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
        self._cur_tok[idx] = firsts
        self._pos[idx] = self._to_dev(np.asarray(first_pos, np.int64))
        self._keys[idx] = lane_keys

    @torch.no_grad()
    def _burst(self, active, temps, k: int, attn_len: int, stochastic: bool):
        """k ragged decode steps over every lane; returns ``[k + 1, slots]``
        tokens (row 0 = the tokens the burst started from, so a deferred
        prefill first token reaches the host with the burst's one read)."""
        toks = [self._cur_tok]
        cur, pos, keys = self._cur_tok, self._pos, self._keys
        for _ in range(k):
            logits, _, _ = self.model.decode_step_ragged_list(
                self.params, self._cache["k"], self._cache["v"],
                cur[:, None], pos, attn_len=attn_len,
            )
            keys, nxt = rng.sample_next(keys, logits, temps, stochastic=stochastic)
            cur = torch.where(active, nxt, 0)
            pos = torch.where(active, pos + 1, pos)
            toks.append(cur)
        self._cur_tok, self._pos, self._keys = cur, pos, keys
        return torch.stack(toks)

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
        an explicit queue cap, and the deadline-aware rule (expected queue
        wait = depth / observed completion rate > remaining budget)."""
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
        """Run every prefill/insert/burst variant the declared traffic
        shape will use once, before traffic: on CUDA this builds the flash
        kernel, initialises the matmul libraries and grows the memory
        pool, so the first admission wave does not stall. Call before the
        first submit (the server's warmup-before-listen phase). Warm
        writes into the live cache; lanes tolerate residue because every
        position a lane reads is rewritten by its occupant first."""
        self._warm_args = {
            "prompt_lens": tuple(prompt_lens),
            "max_new_tokens": int(max_new_tokens),
            "batch_sizes": tuple(batch_sizes),
        }
        buckets = sorted({self._bucket(min(p, self.max_seq)) for p in prompt_lens})
        if not buckets:
            buckets = [self.prefill_buckets[0]]
        k = self._k
        lo = min(prompt_lens) if prompt_lens else 1
        hi = (
            (max(prompt_lens) if prompt_lens else 1)
            + max_new_tokens
            + k * (1 + max(0, self.pipeline_depth - 1))
        )
        ab = self.attn_bucket
        attn_lens = sorted(
            {min(self.max_seq, -(-p // ab) * ab) for p in range(lo + k, hi + 1, ab)}
            | {min(self.max_seq, -(-hi // ab) * ab)}
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
        active = torch.zeros((self.slots,), dtype=torch.bool, device=self.device)
        temps = torch.zeros((self.slots,), dtype=torch.float32, device=self.device)
        for attn_len in attn_lens:
            self._burst(active, temps, k, attn_len, stochastic=False)
            # one sampled variant too: temperature lanes draw Gumbel noise
            self._burst(active, temps, 1, attn_len, stochastic=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # warm left garbage in the lane registers: reset them
        self._reset_lanes()

    def close(self) -> None:
        if self.health != "dead":
            self.health = "closed"
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._drain_queue(self._dead_error())

    def _drain_queue(self, err: Exception) -> None:
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

    def _process_burst(self, burst: _Burst, snapshot) -> None:
        """Credit one burst's tokens to the requests that occupied each
        lane AT DISPATCH TIME (``snapshot[slot] = (slot state, start row)``);
        the lane may have been pre-freed and re-admitted since."""
        host_toks = burst.numpy()  # the burst's one host read
        for slot, (s, start) in snapshot.items():
            if s.credit_done:
                continue
            if self._credit(s, host_toks[start:, slot]):
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
        for _burst, snap in pending:
            for s, _start in snap.values():
                if not s.request.future.done():
                    s.request.future.set_exception(err)

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
                self._pos_host.clear()
                self._masks_dirty = True
                self._alloc_device_state()
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
        """Admit queued requests into free lanes: same-bucket requests
        share a batched prefill of m = 8 (where the slab fits), 4, or 1."""
        free_iter = iter(i for i in range(self.slots) if i not in self._active)
        by_bucket: Dict[int, List[GenRequest]] = {}
        for req in wave:
            by_bucket.setdefault(self._bucket(len(req.tokens)), []).append(req)
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

    def _dispatch(self, temps: np.ndarray, pending) -> None:
        """Dispatch one decode burst over every lane and queue its tokens."""
        if self._masks_dirty:
            for i in range(self.slots):
                temps[i] = (
                    self._active[i].request.temperature if i in self._active else 0.0
                )
            active = np.zeros((self.slots,), bool)
            for i in self._active:
                active[i] = True
            self._active_dev = self._to_dev(active)
            self._temps_dev = self._to_dev(temps.copy())
            self._any_stoch = bool((temps > 0).any())
            self._masks_dirty = False
        k = self._k
        # attention-read bucket: the smallest attn_bucket multiple covering
        # every active lane's end-of-burst position
        attn_len = self._attn_need(max(self._pos_host[i] for i in self._active) + k)
        # snapshot BEFORE dispatch: this burst's tokens belong to these
        # occupants, whatever the host learns later
        snapshot = {}
        for slot, s in self._active.items():
            first = s.first_pending
            snapshot[slot] = (s, 0 if first else 1)
            s.first_pending = False
            s.dispatched += k + (1 if first else 0)
            self._pos_host[slot] += k
        toks = self._burst(
            self._active_dev, self._temps_dev, k, attn_len, self._any_stoch
        )
        self.stats["steps"] += k
        self.stats["lane_steps"] += k * self.slots
        pending.append((_Burst(toks), snapshot))
        # PREDICTIVE FREE: an eos-less lane whose budget the dispatched
        # bursts already cover is done; free it now so the next admission
        # queues behind the in-flight bursts instead of waiting for them
        freed = [
            slot for slot, s in self._active.items()
            if s.request.eos_id is None and s.dispatched >= s.request.max_new_tokens
        ]
        for slot in freed:
            self._active.pop(slot)
            self._pos_host.pop(slot, None)
        if freed:
            self._masks_dirty = True

    def _loop(self) -> bool:
        """One supervised run of the poll loop. False on a clean close(),
        else :meth:`_crash_recover`'s verdict after a loop death."""
        temps = np.zeros((self.slots,), np.float32)
        pending: "collections.deque" = collections.deque()
        try:
            while not self._stop.is_set():
                self._poll_count += 1
                if self.fault_hook is not None:
                    self.fault_hook(self._poll_count)
                wave: List[GenRequest] = []
                while len(self._active) + len(wave) < self.slots:
                    try:
                        req = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if req.deadline_t is not None and time.monotonic() >= req.deadline_t:
                        req.future.cancel()  # its budget ran out in the queue
                    if req.future.cancelled():
                        self.stats["cancelled"] += 1
                        continue  # the caller gave up while queued
                    wave.append(req)
                if wave:
                    self._admit_wave(wave)
                if not self._active and not pending:
                    try:
                        req = self._queue.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    self._queue.put(req)
                    continue
                if self._active:
                    self._dispatch(temps, pending)
                # read bursts oldest-first: always when the pipeline is
                # full (or nothing is left to dispatch), and early when a
                # burst's copy has already landed
                while pending:
                    if not (len(pending) >= self.pipeline_depth or not self._active):
                        if not pending[0][0].ready():
                            break
                    burst, snapshot = pending.popleft()
                    self._process_burst(burst, snapshot)
        except Exception:  # noqa: BLE001 - every loop death is supervised
            logger.exception("continuous batcher loop died")
            return self._crash_recover(pending)
        return False  # clean stop via close()


def _cast_tree(tree, dt: torch.dtype):
    """Float32 leaves -> ``dt`` (other leaves unchanged), nested dicts."""
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dt) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32 and dt != torch.float32:
        return tree.to(dt)
    return tree
