"""Multi-tenant serving: the weight pager and the tenant scheduler.

The port's own copy of ``seldon_core_tpu/serving/weightpager.py`` (it
imports nothing of the JAX package). One batcher serves ONE weight set at
a time; this module multiplexes N tenants' checkpoints of one
architecture over it:

* :class:`WeightPager` -- every tenant's params live in host RAM as an
  SWP1-framed, CRC-checked blob (one frame per leaf) under a byte budget
  with LRU eviction and a half-budget refusal (the
  :class:`~.kvtier.HostKVTier` contract). One tenant is resident on the
  device. A page-in decodes and CRC-checks the blob and hands the tree
  to the batcher's ``request_weight_swap`` (upload beside the served
  set, flip at a poll boundary); demotion is bookkeeping only, the host
  copy never left. All tenants share one architecture, so the batcher's
  warmed kernels and captured CUDA graphs serve every tenant: a cold
  start is a page-in, never a recapture.
* :class:`TenantScheduler` -- tags every submission with a tenant and
  SLO class and decides, against the batcher's poll loop, whether to
  keep batching on the resident tenant or switch to a waiting one: a
  switch is worth its drain and page cost once a waiter's SLO-weighted
  wait exceeds it, and a hard bound in polls forces it so no tenant
  starves. The page-in runs on a thread of its own, never on the
  scheduler thread (``request_weight_swap`` waits on it); a per-poll
  hook on the batcher only wakes it.

Tenant weight versions are strings ``"{tenant}@{seq}"``; the version-keyed
purges of the prefix cache and the host tier keep entries of another
namespace, so paging tenant B in leaves tenant A's cached prefixes for
A's return.

SWP1 frames are byte-identical to the JAX package's: leaves in its
``tree_flatten`` order (dict keys sorted), bfloat16 as raw 16-bit
patterns under the dtype name ``"bfloat16"`` (no ``ml_dtypes`` needed).
"""

from __future__ import annotations

import collections
import json
import logging
import struct
import threading
import time
import zlib
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis.roles import caller_thread, scheduler_only
from ..convert import sorted_leaves
from .disagg import ChecksumError, DisaggError, _read_exact
from .prefix_cache import version_namespace

__all__ = [
    "META_TENANT_KEY",
    "PagerEntryCorrupt",
    "PagerRefused",
    "TENANT_HEADER",
    "TenantScheduler",
    "TenantUnknown",
    "WeightPager",
    "parse_tenant_spec",
    "stamp_tenant_meta",
    "tenant_from_meta",
    "version_namespace",
]

logger = logging.getLogger(__name__)

# SWP1 = Seldon Weight Pager v1: SKV1's magic/len/crc discipline,
# leaf-major (a param tree is a list of leaves of any shape)
_MAGIC = b"SWP1"
_END = b"SWPE"

# SLO classes, strictest first; the weights bias the scheduler's score
SLO_CLASSES = ("strict", "standard", "best_effort")
_SLO_WEIGHT = {"strict": 4.0, "standard": 2.0, "best_effort": 1.0}

# engine routing: the HTTP layer lower-cases header keys; the engine
# stamps the value into the message meta under META_TENANT_KEY
TENANT_HEADER = "seldon-tenant"
META_TENANT_KEY = "tenant"


class TenantUnknown(DisaggError):
    """A request named a tenant the pager holds no checkpoint for (never
    registered, or evicted from host staging). 404: the tenant may live
    on another member."""

    status = 404


class PagerRefused(DisaggError):
    """A checkpoint could not enter host staging: over half the budget,
    or no room even after evicting every cold tenant."""

    status = 507


class PagerEntryCorrupt(ChecksumError):
    """A staged checkpoint failed its SWP1 CRC on page-in; the entry is
    already dropped (it could never page again)."""


def parse_tenant_spec(spec: str) -> List[Tuple[str, str, Optional[str]]]:
    """Parse the tenants grammar: comma-separated
    ``name=slo_class[@model_uri]`` entries, e.g.
    ``"acme=strict,globex=best_effort@/models/globex"``. Strict: a typo is
    refused at construction. Returns ``[(name, slo_class, uri or None)]``
    in declaration order (the first tenant boots resident)."""
    out: List[Tuple[str, str, Optional[str]]] = []
    seen = set()
    for raw in str(spec).split(","):
        entry = raw.strip()
        if not entry:
            continue
        name, sep, rest = entry.partition("=")
        name = name.strip()
        if not sep or not name or not rest.strip():
            raise ValueError(f"tenant entry {entry!r} is not name=slo_class[@uri]")
        slo, sep2, uri = rest.partition("@")
        slo = slo.strip()
        uri = uri.strip() if sep2 else ""
        if slo not in SLO_CLASSES:
            raise ValueError(f"tenant {name!r} has unknown SLO class {slo!r} "
                             f"(one of {', '.join(SLO_CLASSES)})")
        if not all(c.isalnum() or c in "-_." for c in name):
            raise ValueError(f"tenant name {name!r} has characters outside [A-Za-z0-9._-]")
        if name in seen:
            raise ValueError(f"tenant {name!r} declared twice")
        seen.add(name)
        out.append((name, slo, uri or None))
    if not out:
        raise ValueError("tenants spec declares no tenants")
    return out


def tenant_from_meta(meta) -> Optional[str]:
    """The tenant id in a message meta dict (stamped by the engine from
    the ``Seldon-Tenant`` header), or None."""
    if not isinstance(meta, dict):
        return None
    t = meta.get(META_TENANT_KEY)
    if t is None:
        return None
    t = str(t).strip()
    return t or None


def stamp_tenant_meta(message: Dict, tenant: Optional[str]) -> Dict:
    """A shallow copy of ``message`` with the tenant id in its meta, so
    the id rides to remote units and to in-process components' ``meta``
    argument. Without a tenant the message comes back untouched."""
    if not tenant:
        return message
    out = dict(message)
    meta = dict(out.get("meta") or {})
    meta[META_TENANT_KEY] = str(tenant)
    out["meta"] = meta
    return out


# -- checkpoint blob codec (SWP1) ----------------------------------------------


def _host_leaf(leaf) -> Tuple[str, np.ndarray]:
    """``(dtype name, contiguous host array)`` of a torch tensor (any
    device; bfloat16 as its raw 16-bit patterns) or a numpy array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, t.numpy()
    a = np.ascontiguousarray(leaf)
    return str(a.dtype), a


def _torch_dtype(name: str) -> torch.dtype:
    if name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(name))).dtype


def _encode_ckpt(meta: Dict[str, Any], leaves: List[Any]) -> bytes:
    """Frame a flattened param tree: header JSON (meta + each leaf's
    shape and dtype), one ``u32 len + u32 crc + payload`` frame per leaf,
    then an end frame with the running total CRC."""
    host = [_host_leaf(leaf) for leaf in leaves]
    header = dict(meta)
    header["leaves"] = [{"shape": list(a.shape), "dtype": name} for name, a in host]
    hdr = json.dumps(header).encode()
    parts: List[Any] = [_MAGIC, struct.pack("<II", len(hdr), zlib.crc32(hdr)), hdr]
    total_crc = 0
    for _name, a in host:
        payload = memoryview(a.reshape(-1).view(np.uint8))
        total_crc = zlib.crc32(payload, total_crc)
        parts.append(struct.pack("<II", len(payload), zlib.crc32(payload)))
        parts.append(payload)
    parts.append(_END + struct.pack("<I", total_crc))
    return b"".join(parts)


def _decode_ckpt(read: Callable[[int], bytes],
                 pin: Optional[bool] = None) -> Tuple[Dict[str, Any], List[torch.Tensor]]:
    """Inverse of :func:`_encode_ckpt`: ``(meta, leaves)``, each leaf a
    CPU tensor of its dtype assembled with one copy (into pinned memory
    when ``pin``; default: when CUDA is available, so the upload is one
    asynchronous copy). Raises :class:`~.disagg.ChecksumError` /
    :class:`~.disagg.TruncatedStream` before returning partial data."""
    magic = _read_exact(read, 4)
    if magic != _MAGIC:
        raise DisaggError(f"bad pager magic {bytes(magic)!r} (want {_MAGIC!r})")
    hdr_len, hdr_crc = struct.unpack("<II", _read_exact(read, 8))
    hdr = _read_exact(read, hdr_len)
    if zlib.crc32(hdr) != hdr_crc:
        raise ChecksumError("pager checkpoint header failed its checksum")
    meta = json.loads(bytes(hdr))
    pin = torch.cuda.is_available() if pin is None else pin
    leaves: List[torch.Tensor] = []
    total_crc = 0
    for spec in meta["leaves"]:
        n, crc = struct.unpack("<II", _read_exact(read, 8))
        payload = _read_exact(read, n)
        if zlib.crc32(payload) != crc:
            raise ChecksumError(f"pager checkpoint leaf {len(leaves)} failed its checksum")
        total_crc = zlib.crc32(payload, total_crc)
        buf = torch.empty((n,), dtype=torch.uint8, pin_memory=pin)
        buf.numpy()[:] = np.frombuffer(payload, np.uint8)
        leaves.append(buf.view(_torch_dtype(spec["dtype"])).view(spec["shape"]))
    tail = _read_exact(read, 8)
    if tail[:4] != _END:
        raise DisaggError(f"missing pager end frame (got {bytes(tail[:4])!r})")
    (want,) = struct.unpack("<I", tail[4:])
    if want != total_crc:
        raise ChecksumError("pager checkpoint total checksum mismatch")
    return meta, leaves


def _unflatten(paths: List[Tuple[str, ...]], leaves: List[Any]) -> Dict[str, Any]:
    """Nested dict from the key paths :func:`~..convert.sorted_leaves` gave."""
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _view_reader(data: bytes) -> Callable[[int], memoryview]:
    """A ``read(n)`` over ``data`` returning zero-copy memoryview slices."""
    mv, pos = memoryview(data), [0]

    def read(n: int) -> memoryview:
        start = pos[0]
        pos[0] = min(len(mv), start + n)
        return mv[start:pos[0]]

    return read


class _PagerEntry:
    __slots__ = ("payload", "nbytes", "version", "paths", "hbm_bytes", "slo", "last_used")

    def __init__(self, payload: bytes, version: str, paths, hbm_bytes: int, slo: str):
        self.payload = payload
        self.nbytes = len(payload)
        self.version = version
        self.paths = paths  # the blob stores leaves only
        self.hbm_bytes = int(hbm_bytes)
        self.slo = slo
        self.last_used = 0


class WeightPager:
    """N tenant checkpoints across host-RAM staging and one device
    residency.

    Public methods take the pager lock; ``promote`` decodes its blob
    outside it (stored payloads are immutable). ``budget_bytes`` bounds
    host staging only; the resident checkpoint is billed by the batcher's
    pressure ledger as its ``pager`` component."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = max(0, int(budget_bytes))
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, _PagerEntry]" = collections.OrderedDict()
        self._seq: Dict[str, int] = {}
        self._resident: Optional[str] = None
        self._clock = 0
        self.stats = {
            "page_ins": 0, "page_outs": 0, "evictions": 0, "refused": 0,
            "corrupt_dropped": 0, "host_bytes": 0,
        }

    def _host_bytes_locked(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _evict_cold_locked(self, need: int) -> None:
        """LRU-evict non-resident entries until ``need`` bytes fit. The
        resident tenant is never a victim: its blob is its only way back
        after a demotion."""
        while self._host_bytes_locked() + need > self.budget_bytes:
            victims = [(e.last_used, t) for t, e in self._entries.items() if t != self._resident]
            if not victims:
                break
            _, cold = min(victims)
            del self._entries[cold]
            self.stats["evictions"] += 1

    @property
    def resident(self) -> Optional[str]:
        return self._resident

    @property
    def resident_hbm_bytes(self) -> int:
        with self._lock:
            e = self._entries.get(self._resident or "")
            return e.hbm_bytes if e is not None else 0

    @property
    def host_bytes(self) -> int:
        with self._lock:
            return self._host_bytes_locked()

    def tenants(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def slo_class(self, tenant: str) -> Optional[str]:
        with self._lock:
            e = self._entries.get(tenant)
            return e.slo if e is not None else None

    def put(self, tenant: str, params, slo: str = "standard") -> str:
        """Stage ``tenant``'s param tree in host RAM (already in the
        serving dtype, so a page-in is decode and upload, no cast).
        Returns the new version ``"{tenant}@{seq}"``; a re-put bumps
        ``seq`` (that tenant's cache entries go stale, nobody else's).
        Raises :class:`PagerRefused` when the blob cannot fit."""
        flat = sorted_leaves(params)
        paths = [p for p, _ in flat]
        hbm_bytes = sum(t.numel() * t.element_size() for _, t in flat)
        with self._lock:
            seq = self._seq.get(tenant, 0) + 1
        version = f"{tenant}@{seq}"
        payload = _encode_ckpt(
            {"kind": "pager_ckpt", "tenant": tenant, "weight_version": version},
            [t for _, t in flat],
        )
        entry = _PagerEntry(payload, version, paths, hbm_bytes, slo)
        with self._lock:
            # a pager that can stage at most one checkpoint cannot page
            if not 0 < entry.nbytes <= self.budget_bytes // 2:
                self.stats["refused"] += 1
                raise PagerRefused(
                    f"tenant {tenant!r} checkpoint ({entry.nbytes} bytes) exceeds half the "
                    f"pager budget ({self.budget_bytes})")
            old = self._entries.pop(tenant, None)
            self._evict_cold_locked(entry.nbytes)
            if self._host_bytes_locked() + entry.nbytes > self.budget_bytes:
                if old is not None:  # a failed re-put keeps the old one
                    self._entries[tenant] = old
                self.stats["refused"] += 1
                raise PagerRefused(
                    f"tenant {tenant!r} checkpoint ({entry.nbytes} bytes) does not fit even "
                    "after evicting every cold tenant")
            self._seq[tenant] = seq
            entry.last_used = self._tick()
            self._entries[tenant] = entry
            self.stats["host_bytes"] = self._host_bytes_locked()
        return version

    def promote(self, tenant: str):
        """Decode ``tenant``'s staged checkpoint for a page-in:
        ``(params, version)`` for ``request_weight_swap``, host tensors.
        Raises :class:`TenantUnknown` or :class:`PagerEntryCorrupt` (the
        entry is dropped first, so it can never page again)."""
        with self._lock:
            entry = self._entries.get(tenant)
            if entry is None:
                raise TenantUnknown(
                    f"tenant {tenant!r} has no staged checkpoint (never registered, or "
                    "evicted from host staging)")
            entry.last_used = self._tick()
            payload, paths, version = entry.payload, entry.paths, entry.version
        # outside the lock: a checkpoint-sized CRC and copy would block
        # every concurrent submit's residency check
        try:
            _meta, leaves = _decode_ckpt(_view_reader(payload))
        except DisaggError as e:
            with self._lock:
                if self._entries.get(tenant) is entry:
                    del self._entries[tenant]
                    self.stats["corrupt_dropped"] += 1
                    self.stats["host_bytes"] = self._host_bytes_locked()
            raise PagerEntryCorrupt(
                f"tenant {tenant!r} staged checkpoint failed its checksum: {e}") from e
        return _unflatten(paths, leaves), version

    def mark_resident(self, tenant: str) -> Optional[str]:
        """Record that the batcher's flip landed: ``tenant`` is resident
        and the previous owner (returned) is demoted to its host blob."""
        with self._lock:
            if tenant not in self._entries:
                raise TenantUnknown(f"tenant {tenant!r} is not staged")
            old, self._resident = self._resident, tenant
            self._entries[tenant].last_used = self._tick()
            self.stats["page_ins"] += 1
            if old is not None and old != tenant:
                self.stats["page_outs"] += 1
            return old if old != tenant else None

    def drop(self, tenant: str) -> bool:
        """Forget a tenant's staged checkpoint (offboarding). Dropping the
        resident one only removes its way back; the served weights stay
        until the next flip."""
        with self._lock:
            if self._entries.pop(tenant, None) is None:
                return False
            if self._resident == tenant:
                self._resident = None
            self.stats["host_bytes"] = self._host_bytes_locked()
            return True

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "host_bytes": self._host_bytes_locked(),
                "tenants": list(self._entries),
                "resident": self._resident,
                "resident_hbm_bytes": (
                    self._entries[self._resident].hbm_bytes
                    if self._resident in self._entries else 0),
                **{k: v for k, v in self.stats.items() if k != "host_bytes"},
            }


class _QueuedGen:
    __slots__ = ("future", "tokens", "kwargs", "enqueued_t")

    def __init__(self, future, tokens, kwargs):
        self.future = future
        self.tokens = tokens
        self.kwargs = kwargs
        self.enqueued_t = time.monotonic()


class TenantScheduler:
    """Routes submissions by tenant and drives page-ins against the
    batcher's poll loop.

    The resident tenant's submissions pass straight to ``batcher.submit``
    (tagged with tenant and SLO class); every other tenant's queue. The
    page-in thread scores the waiters and, when a switch is worth its
    cost, pages the winner in:

    1. passthrough for the outgoing tenant stops (decided under the
       routing lock, so nothing new enters the batcher's admit queue);
    2. it waits for the batcher's admit and resume queues to empty: the
       admitted lanes finish on the old weights during the swap's drain,
       but a queued submit would run under the new ones;
    3. ``promote`` (CRC-checked host decode) and ``request_weight_swap``
       (upload beside the served set, drain, poll-boundary flip);
    4. ``mark_resident`` and the winner's queue flushed.

    Decision rule: switch when the best waiter's SLO-weighted wait
    (raised when its recent TTFT runs over its class target) exceeds the
    observed switch cost (an EWMA of real page-ins), or unconditionally
    once it has waited ``max_wait_polls`` batcher polls (the starvation
    bound). An idle resident always yields."""

    TTFT_TARGET_S = {"strict": 0.5, "standard": 2.0, "best_effort": 8.0}

    def __init__(self, batcher, pager: WeightPager, slo_classes: Dict[str, str],
                 tick_s: float = 0.02, max_wait_polls: int = 256,
                 min_resident_s: float = 0.05, swap_wait_s: float = 120.0):
        self.batcher = batcher
        self.pager = pager
        self._slo = dict(slo_classes)
        if not self._slo:
            raise ValueError("TenantScheduler needs at least one tenant")
        self._default = next(iter(self._slo))
        self.tick_s = max(0.001, float(tick_s))
        self.max_wait_polls = max(1, int(max_wait_polls))
        self.min_resident_s = max(0.0, float(min_resident_s))
        self.swap_wait_s = float(swap_wait_s)
        self._lock = threading.Lock()
        self._queues: Dict[str, "collections.deque[_QueuedGen]"] = {
            t: collections.deque() for t in self._slo}
        # batcher poll count at which each tenant's oldest queued request
        # arrived: the starvation clock
        self._enqueue_poll: Dict[str, Optional[int]] = {t: None for t in self._slo}
        self._switching_to: Optional[str] = None
        self._resident_since = time.monotonic()
        self._switch_cost_s = 0.25  # prior until a real page-in lands
        self._poll_count = 0
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._pager_thread = threading.Thread(target=self._run, name="tenant-pager",
                                              daemon=True)
        self.stats = {
            "switches": 0, "passthrough": 0, "queued_submits": 0,
            "forced_switches": 0, "switch_cost_s_sum": 0.0,
        }
        batcher.tenant_hook = self._on_poll

    def start(self) -> "TenantScheduler":
        self._pager_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._pager_thread.is_alive():
            self._pager_thread.join(timeout=5.0)
        # fail queued work loudly: a dropped future would pin its waiter
        with self._lock:
            for q in self._queues.values():
                while q:
                    q.popleft().future.set_exception(RuntimeError("tenant scheduler stopped"))

    @scheduler_only
    def _on_poll(self, poll_count: int) -> None:
        """The batcher's per-poll hook (scheduler thread): publish the
        poll clock and wake the page-in thread when anyone waits. A
        counter and an event only."""
        self._poll_count = poll_count
        if any(self._queues.values()):
            self._wake.set()

    @caller_thread
    def submit(self, tokens, tenant: Optional[str] = None, **kwargs):
        """The tenant-routing front of ``batcher.submit``: its arguments
        plus ``tenant`` (None routes to the first declared tenant).
        Returns a future; a queued submission resolves once its tenant
        pages in."""
        tenant = tenant or self._default
        slo = self._slo.get(tenant)
        if slo is None or self.pager.slo_class(tenant) is None:
            raise TenantUnknown(
                f"unknown tenant {tenant!r} (declared: {', '.join(sorted(self._slo))})")
        with self._lock:
            if tenant == self.pager.resident and self._switching_to is None:
                # under the routing lock: the page-in thread takes it to flag a
                # switch, so no submit slips in after its ingress wait
                self.stats["passthrough"] += 1
                return self.batcher.submit(tokens, tenant=tenant, slo=slo, **kwargs)
            outer: Future = Future()
            self._queues[tenant].append(_QueuedGen(outer, tokens, kwargs))
            if self._enqueue_poll[tenant] is None:
                self._enqueue_poll[tenant] = self._poll_count
            self.stats["queued_submits"] += 1
        self._wake.set()
        return outer

    @caller_thread
    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.tick_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            target, forced = self._decide()
            if target is None:
                continue
            try:
                self._switch_to(target, forced)
            except Exception as e:  # noqa: BLE001 - fail the queued work typed
                logger.exception("tenant page-in of %r failed", target)
                with self._lock:
                    self._switching_to = None
                    q = self._queues[target]
                    while q:
                        q.popleft().future.set_exception(e)
                    self._enqueue_poll[target] = None

    def _recent_ttft_s(self, tenant: str) -> Optional[float]:
        """Mean TTFT over the batcher's per-tenant SLO reservoir."""
        recent = getattr(self.batcher, "tenant_slo_recent", {}).get(tenant)
        if not recent:
            return None
        ttfts = [s[1] for s in list(recent)[-32:]]
        return sum(ttfts) / len(ttfts) if ttfts else None

    def _decide(self) -> Tuple[Optional[str], bool]:
        """Score the waiters: ``(winner, forced)``, or ``(None, False)`` to
        keep batching on the resident tenant."""
        now = time.monotonic()
        with self._lock:
            if self._switching_to is not None:
                return None, False
            waiters = {t: q for t, q in self._queues.items() if q}
            if not waiters:
                return None, False
            resident = self.pager.resident
            poll = self._poll_count
            best, best_score, forced = None, 0.0, False
            for t, q in waiters.items():
                score = (now - q[0].enqueued_t) * _SLO_WEIGHT.get(self._slo[t], 1.0)
                ttft = self._recent_ttft_s(t)
                target = self.TTFT_TARGET_S.get(self._slo[t], 2.0)
                if ttft is not None and ttft > target:
                    score *= 1.0 + min(4.0, ttft / target - 1.0)
                since = self._enqueue_poll[t]
                if since is not None and poll - since >= self.max_wait_polls:
                    forced = True
                    score = float("inf")
                if score > best_score or best is None:
                    best, best_score = t, score
            # batch deeper while the resident tenant has work and no
            # waiter has outgrown the switch cost
            b = self.batcher
            resident_busy = resident is not None and (
                bool(b._active) or bool(b._chunked) or not b._queue.empty())
            if not forced and resident_busy and (
                    best_score <= self._switch_cost_s
                    or now - self._resident_since < self.min_resident_s):
                return None, False
            self._switching_to = best
        return best, forced

    def _switch_to(self, tenant: str, forced: bool) -> None:
        b = self.batcher
        outgoing = self.pager.resident
        # ingress drain: queued work would run under the new weights
        while not (b._queue.empty() and not b._resume_queue):
            if self._stop.is_set():
                with self._lock:
                    self._switching_to = None
                return
            time.sleep(0.002)
        t0 = time.monotonic()
        params, version = self.pager.promote(tenant)
        b.request_weight_swap(params, version=version).result(timeout=self.swap_wait_s)
        del params
        self.pager.mark_resident(tenant)
        cost_s = time.monotonic() - t0
        # the decision threshold tracks what a switch costs here
        self._switch_cost_s = 0.7 * self._switch_cost_s + 0.3 * cost_s
        if b.flight is not None and b.flight.enabled:
            if outgoing is not None:
                b.flight.record({"type": "weight_page_out", "tenant": outgoing,
                                 "host_bytes": self.pager.host_bytes})
            b.flight.record({"type": "weight_page_in", "tenant": tenant, "version": version,
                             "cost_ms": round(cost_s * 1e3, 3)})
            b.flight.record({"type": "tenant_switch", "from": outgoing, "to": tenant,
                             "forced": forced, "cost_ms": round(cost_s * 1e3, 3),
                             "queued": len(self._queues[tenant])})
        with self._lock:
            self.stats["switches"] += 1
            self.stats["switch_cost_s_sum"] += cost_s
            if forced:
                self.stats["forced_switches"] += 1
            self._resident_since = time.monotonic()
            self._switching_to = None
            self._enqueue_poll[tenant] = None
            slo = self._slo[tenant]
            q = self._queues[tenant]
            # flush under the lock: FIFO between the queue and concurrent
            # passthrough submits holds only if the flush finishes first
            while q:
                item = q.popleft()
                try:
                    inner = b.submit(item.tokens, tenant=tenant, slo=slo, **item.kwargs)
                except Exception as e:  # noqa: BLE001 - typed to the caller
                    item.future.set_exception(e)
                    continue
                self._chain(inner, item.future)  # seldon-lint: disable=blocking-under-lock (registers a done callback; the .result() runs on the resolving thread, never here)

    @staticmethod
    def _chain(inner, outer) -> None:
        """Resolve a queued request's future from the batcher's (result,
        exception, and the ``gen_request`` the server's response reads)."""
        gr = getattr(inner, "gen_request", None)
        if gr is not None:
            outer.gen_request = gr

        def _copy(f):
            if outer.cancelled():
                return
            e = f.exception()
            if e is not None:
                outer.set_exception(e)
            else:
                outer.set_result(f.result())

        inner.add_done_callback(_copy)

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "tenants": dict(self._slo),
                "resident": self.pager.resident,
                "switching_to": self._switching_to,
                "queued": {t: len(q) for t, q in self._queues.items() if q},
                "switch_cost_s": round(self._switch_cost_s, 6),
                **self.stats,
            }
