"""Tiered KV memory: the host-RAM spill tier between device memory and
the wire (the port's own copy of ``seldon_core_tpu/serving/kvtier.py``;
it imports nothing of the JAX package).

The reclaim ladder *destroys* state under device-memory pressure without
it: prefix slabs are evicted outright and preempted lanes drop their
K/V, paying a full prompt recompute + teacher-forced replay on resume.
This module is a host-RAM store with its own byte budget, LRU, and lock
discipline, holding **SKV1-serialized** KV slabs (the CRC-framed wire
codec of ``disagg.py`` -- every entry is already a valid wire message,
so corruption refuses typed and a peer can stream an entry without
re-framing) keyed by ``(weight_version, token-prefix)``.

Two entry kinds share the budget:

* **prefix entries** -- prompt-K/V slabs demoted from the device radix
  cache by the reclaim ladder (``ContinuousBatcher._reclaim`` rung 1
  becomes *demote, not evict*) or published by a prefill-role export
  (the slab is already host-side there -- zero extra device cost). They
  promote back (upload + splice) on a later prefix match, locally or
  from a *peer's* tier over the KV transport: a post-pressure warm hit
  costs a host-to-device copy instead of a re-prefill.
* **checkpoint entries** -- a preempted decode lane's exact cache
  columns (ladder rung 3), stored when budget allows so
  ``_admit_resume`` does a copy-back insert instead of prompt-recompute
  + replay. One-shot: taken on resume. Replay stays the fallback when
  the tier evicted (or refused) the entry.

Internal structure: prefix entries live in a :class:`RadixPrefixIndex`
whose "slabs" are the SKV1 payload *bytes* (the index is deliberately
device-agnostic, so insert/match/split/LRU reuse its machinery and the
version keying reuses its ``set_version`` purge); checkpoint entries
live in an insertion-ordered dict. Eviction policy, cheapest loss first:
LRU prefix entries (pure cache) go before checkpoint entries (paid-for
work), and a checkpoint never evicts a *newer* checkpoint. A single
entry larger than half the budget is refused -- a tier that can hold at
most one such slab would thrash, not cache.

Thread discipline: every public method takes the tier lock. The
scheduler thread demotes/promotes at poll boundaries; disagg transport
handler threads answer peer prefix lookups concurrently. All payloads
are host bytes -- no method ever touches a device (decoded slabs are CPU
tensors; the batcher uploads them).

``budget_bytes == 0`` disables the subsystem (the batcher then never
constructs one).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from .disagg import ChecksumError, DisaggError, buffer_reader, decode_slab, encode_slab
from .prefix_cache import RadixPrefixIndex, version_retains

__all__ = ["HostKVTier", "TierEntryCorrupt"]

# the inner radix index must never evict on its own — the TIER owns the
# byte budget (prefix + checkpoint entries share it)
_UNBOUNDED = 1 << 62


class TierEntryCorrupt(ChecksumError):
    """A stored tier entry failed its SKV1 CRC on read. Raised BEFORE
    any lane state exists (the codec contract); the corrupt entry is
    already dropped from the tier when this surfaces, so callers treat
    it as a miss (prefix promote, checkpoint copy-back falls back to
    replay) and a peer lookup answers a typed error frame."""


class _CkptEntry:
    __slots__ = ("payload", "nbytes", "version")

    def __init__(self, payload: bytes, version: Any):
        self.payload = payload
        self.nbytes = len(payload)
        self.version = version


class HostKVTier:
    """Host-RAM KV store: SKV1-serialized slabs under one byte budget.

    ``min_tokens`` is the demote threshold — prefixes shorter than it
    are not worth a tier slot (mirrors ``prefix_cache_min_tokens``).
    ``stats`` counters are written under the tier lock; readers see
    torn-but-harmless ints (same contract as the batcher's stats).
    """

    def __init__(self, budget_bytes: int, min_tokens: int = 16,
                 version: Any = 0):
        self.budget_bytes = max(0, int(budget_bytes))
        self.min_tokens = max(1, int(min_tokens))
        self.version: Any = version
        self._lock = threading.Lock()
        # prefix entries: radix tree whose "slab" payload is
        # ("tier", entry_tokens, skv1_bytes) — the tokens ride along so
        # a corrupt entry can be removed without decoding its header
        self._index = RadixPrefixIndex(_UNBOUNDED)
        self._index.version = version
        # checkpoint entries, insertion-ordered (oldest evicts first)
        self._ckpts: Dict[Any, _CkptEntry] = {}
        self.stats = {
            "demotions": 0, "hits": 0, "misses": 0, "evictions": 0,
            "refused": 0, "released": 0,
        }

    # -- internals ----------------------------------------------------------

    def _ckpt_bytes(self) -> int:
        # callers hold self._lock (iterating _ckpts unlocked would race
        # cross-thread put/take/drop mutations)
        return sum(e.nbytes for e in self._ckpts.values())

    def _total_bytes_locked(self) -> int:
        return self._index.total_bytes + self._ckpt_bytes()

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes_locked()

    @property
    def entry_count(self) -> int:
        with self._lock:
            return self._index.slab_count + len(self._ckpts)

    @staticmethod
    def _encode(meta: Dict[str, Any], slab: Dict[str, Any]) -> bytes:
        return b"".join(encode_slab(meta, slab))

    @staticmethod
    def _decode(payload: bytes) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        return decode_slab(buffer_reader(payload))

    def _fits(self, nbytes: int) -> bool:
        """A single entry above half the budget is refused: a tier that
        can hold at most one such slab thrashes instead of caching."""
        return 0 < nbytes <= self.budget_bytes // 2

    def _evict_prefixes_locked(self, target_bytes: int) -> None:
        evicted = self._index.evict_to(max(0, target_bytes))
        self.stats["evictions"] += evicted

    # -- prefix entries -----------------------------------------------------

    def put_prefix(self, tokens, slab: Dict[str, Any],
                   version: Any, extra_meta: Optional[Dict] = None) -> bool:
        """Demote one prompt-K/V slab (host ``{"k","v"}`` arrays in the
        stacked cache_one layout) into the tier under its token path.
        Returns False when refused (too short, too large, or a stale
        weight version). May LRU-evict older prefix entries to fit —
        never checkpoints (cache must not displace paid-for work)."""
        tokens = tuple(int(t) for t in tokens)
        if len(tokens) < self.min_tokens:
            self.stats["refused"] += 1
            return False
        with self._lock:
            # pre-checks BEFORE the O(slab-bytes) encode: a stale
            # version, or a stored entry already covering this whole
            # path (it serves any match this one would), makes the
            # encode pure waste — repeat-prefix export traffic must not
            # pay a host memcpy+CRC per request for a no-op
            if version != self.version:
                self.stats["refused"] += 1
                return False
            if self._index.covered_len(tokens) >= len(tokens):
                return False
        meta = {
            "kind": "tier_prefix",
            "tokens": list(tokens),
            "weight_version": version,
            **(extra_meta or {}),
        }
        payload = self._encode(meta, slab)
        with self._lock:
            # re-validate: the encode ran unlocked
            if (
                version != self.version
                or self._index.covered_len(tokens) >= len(tokens)
            ):
                return False
            # prefix entries may never displace checkpoints, so the
            # space prefixes can ever claim is budget - ckpt_bytes: an
            # entry larger than that would only evict ITSELF after
            # insertion — refuse up front instead of counting a
            # demotion for a slab that is already gone
            avail = self.budget_bytes - self._ckpt_bytes()
            if not self._fits(len(payload)) or len(payload) > avail:
                self.stats["refused"] += 1
                return False
            self._index.insert(
                tokens, ("tier", tokens, payload), len(payload)
            )
            # the new entry carries the freshest LRU stamp, so evicting
            # down to `avail` always victimizes older entries first and
            # can never drop the entry just stored
            self._evict_prefixes_locked(avail)
            self.stats["demotions"] += 1
            return True

    def prefix_covered_len(self, tokens, version: Any) -> int:
        """Longest stored prefix of ``tokens`` under ``version`` WITHOUT
        decoding, LRU-touching, or paying anything O(slab): the cheap
        probe a demote path uses to skip the device pull for a slab the
        tier would refuse anyway (already covered)."""
        with self._lock:
            if version != self.version:
                return 0
            return self._index.covered_len([int(t) for t in tokens])

    def match_prefix(
        self, tokens, version: Any
    ) -> Optional[Tuple[int, Dict[str, Any], Dict[str, Any]]]:
        """Longest stored prefix of ``tokens`` under ``version``:
        ``(depth, meta, slab)`` with host arrays decoded (CRC-verified),
        or None. The returned slab covers the ENTRY's full token path
        (``meta["tokens"]``) — valid K/V for every prefix of it, so the
        caller re-inserts it device-side under the entry path and lets
        the ordinary radix match serve ``depth``. Raises
        :class:`TierEntryCorrupt` (typed, entry already dropped) when
        the stored bytes fail their checksum."""
        tokens = [int(t) for t in tokens]
        with self._lock:
            if version != self.version:
                self.stats["misses"] += 1
                return None
            depth, stored = self._index.match(tokens)
            if stored is None or depth < self.min_tokens:
                self.stats["misses"] += 1
                return None
            _tag, entry_tokens, payload = stored
        # decode OUTSIDE the lock (mirror of put_prefix's unlocked
        # encode): the payload bytes are immutable once stored, and an
        # O(slab) memcpy+CRC under the global tier lock would block the
        # scheduler's per-poll occupancy reads behind every peer lookup
        try:
            meta, slab = self._decode(payload)
        except DisaggError as e:
            # drop the corrupt entry NOW so it can never re-hit, then
            # refuse typed — before any lane state, per the SKV1 codec
            # contract
            with self._lock:
                self._index.remove(entry_tokens)
                self.stats["evictions"] += 1
            raise TierEntryCorrupt(
                f"tier prefix entry ({len(entry_tokens)} tokens) "
                f"failed its checksum: {e}"
            ) from e
        with self._lock:
            self.stats["hits"] += 1
        return depth, meta, slab

    # -- checkpoint entries -------------------------------------------------

    def put_ckpt(self, key: Any, meta: Dict[str, Any],
                 slab: Dict[str, Any], version: Any) -> bool:
        """Checkpoint a preempted lane's cache columns under ``key``
        ("when budget allows": LRU prefix entries and OLDER checkpoints
        may be evicted to fit, a larger-than-half-budget slab is
        refused). One-shot — taken by :meth:`take_ckpt` on resume."""
        payload = self._encode(
            {"kind": "tier_ckpt", "weight_version": version, **meta}, slab
        )
        n = len(payload)
        with self._lock:
            if version != self.version or not self._fits(n):
                self.stats["refused"] += 1
                return False
            # cheapest loss first: prefix entries (pure cache), then
            # the oldest checkpoints — never a newer one
            self._evict_prefixes_locked(
                max(0, self.budget_bytes - self._ckpt_bytes() - n)
            )
            while (
                self._ckpts
                and self._total_bytes_locked() + n > self.budget_bytes
            ):
                oldest = next(iter(self._ckpts))
                self.stats["evictions"] += 1
                del self._ckpts[oldest]
            if self._total_bytes_locked() + n > self.budget_bytes:
                self.stats["refused"] += 1
                return False
            self._ckpts[key] = _CkptEntry(payload, version)
            self.stats["demotions"] += 1
            return True

    def take_ckpt(
        self, key: Any, version: Any
    ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """Pop and decode the checkpoint stored under ``key`` —
        ``(meta, slab)``, or None when evicted/never stored/stale
        version (the caller falls back to recompute + replay). Raises
        :class:`TierEntryCorrupt` on a CRC failure (entry already
        popped — replay fallback again)."""
        with self._lock:
            ent = self._ckpts.get(key)
            if ent is None or ent.version != version:
                # version-gated WITHOUT popping: a stale-version lookup
                # must not destroy an entry another tenant's page-back
                # would make valid again (version_retains kept it alive)
                self.stats["misses"] += 1
                return None
            del self._ckpts[key]
        # decode unlocked (the entry is already popped — no other
        # thread can observe or mutate it)
        try:
            meta, slab = self._decode(ent.payload)
        except DisaggError as e:
            with self._lock:
                self.stats["evictions"] += 1
            raise TierEntryCorrupt(
                f"tier checkpoint {key!r} failed its checksum: {e}"
            ) from e
        with self._lock:
            self.stats["hits"] += 1
        return meta, slab

    def drop_ckpt(self, key: Any) -> bool:
        """Release a checkpoint without decoding it — the owner request
        was cancelled, failed, or migrated away, so the entry is dead
        weight that must not keep occupying budget prefix demotions can
        never reclaim (checkpoints outrank prefixes in the eviction
        order precisely because they are normally still owed a
        resume)."""
        with self._lock:
            if self._ckpts.pop(key, None) is None:
                return False
            self.stats["released"] += 1
            return True

    # -- versioning + introspection -----------------------------------------

    def set_version(self, version: Any) -> int:
        """Key the tier to a new weight version, purging every stored
        entry the switch invalidates (K/V computed under replaced
        weights — exactly the radix cache's hot-swap contract).
        Namespace-aware per :func:`~.prefix_cache.version_retains`: a
        tenant page-in (serving/weightpager.py) purges only that
        tenant's stale entries and legacy un-namespaced ones — another
        tenant's prefix slabs and lane checkpoints survive, unreachable
        (every lookup gates on ``version == self.version``) until their
        tenant pages back in. Returns entries purged."""
        with self._lock:
            if version == self.version:
                return 0
            self.version = version
            purged = self._index.set_version(version)
            dead = [
                k for k, e in self._ckpts.items()
                if not version_retains(e.version, version)
            ]
            for k in dead:
                del self._ckpts[k]
            purged += len(dead)
            self.stats["evictions"] += purged
            return purged

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "budget_bytes": self.budget_bytes,
                "used_bytes": self._total_bytes_locked(),
                "prefix_entries": self._index.slab_count,
                "ckpt_entries": len(self._ckpts),
                "version": self.version,
                **{k: v for k, v in self.stats.items()},
            }
