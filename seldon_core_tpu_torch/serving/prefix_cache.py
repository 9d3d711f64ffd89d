"""Radix index for the cross-request prefix KV cache (the port's own
copy of ``seldon_core_tpu/serving/prefix_cache.py``; it imports nothing
of the JAX package).

Generate traffic is dominated by shared prefixes (system prompts,
few-shot templates, graph-injected preambles), and prefill is the
continuous batcher's largest non-decode device cost. This module is the
HOST side of the prefix cache: a radix tree over prompt token IDs whose
slab-bearing nodes reference device-resident K/V blocks published by
completed requests. In the port a slab is a ``{"k", "v"}`` dict of
tensors in the ``cache_one`` layout ``[L, 1, KV, Tb, Dh]``.

The index is device-agnostic -- a "slab" is any opaque object plus a
byte count -- so insert/match/split/evict and the LRU byte budget are
testable with fake slabs. The scheduler thread owns all mutation;
eviction drops the tree's reference and the tensor dies with Python
refcounting (its memory returns to PyTorch's caching allocator), so an
admit that matched a slab moments before an evict keeps it alive for
exactly as long as the splice needs it.

Invariant the batcher relies on: a slab stored for prompt ``t[0:n]``
holds valid K/V for EVERY prefix of ``t`` -- so any match depth
``m <= n`` can be served by splicing the whole slab and overwriting
positions ``>= m`` (the splice target's residue beyond ``m`` is never
readable before being rewritten, the same residue invariant that lets
decode lanes be reused without scrubbing).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple


def version_namespace(version) -> Optional[str]:
    """Tenant namespace of a weight version, or None for the legacy
    single-lineage form. Multi-tenant serving keys versions as the
    STRING ``"{tenant}@{seq}"`` — strings, not tuples, because versions
    ride JSON metas of the wire formats, where a tuple
    round-trips as a list and silently breaks every equality check.
    ``rsplit`` so a tenant name may not, but a future seq scheme may,
    contain ``@``."""
    if isinstance(version, str) and "@" in version:
        return version.rsplit("@", 1)[0]
    return None


def version_retains(entry_version, new_version) -> bool:
    """Whether an entry keyed ``entry_version`` SURVIVES a switch to
    ``new_version`` — the one purge rule the radix index, the host KV
    tier, and any future version-keyed store share:

    * same version — the weights did not change (a tenant paging back
      in): the entry is valid again, keep it;
    * both namespaced, different tenants — the OTHER tenant's weights
      did not change either; keep it (per-entry version checks make it
      unmatchable while its tenant is not resident), so a page-in of
      tenant B never invalidates tenant A's cache;
    * anything else — same tenant's new weights, or a legacy
      un-namespaced lineage on either side: purge (the pre-multi-tenant
      hot-swap contract, unchanged)."""
    if entry_version == new_version:
        return True
    ns_new = version_namespace(new_version)
    ns_old = version_namespace(entry_version)
    return ns_new is not None and ns_old is not None and ns_old != ns_new


@dataclasses.dataclass
class _Node:
    """One radix edge: ``edge`` tokens leading from the parent. A node
    with ``slab`` is an eviction unit: it owns a published K/V block and
    its byte bill; interior nodes created by edge splits carry none."""

    edge: Tuple[int, ...]
    parent: Optional["_Node"] = None
    children: Dict[int, "_Node"] = dataclasses.field(default_factory=dict)
    slab: Any = None
    slab_bytes: int = 0
    slab_tokens: int = 0  # real prompt length the slab covers
    last_used: int = 0
    version: Any = 0  # weight version the slab's K/V was computed under


class RadixPrefixIndex:
    """Longest-prefix match + LRU byte budget over published K/V slabs.

    All methods are plain Python over host token lists; slabs are opaque.
    Public methods take an internal lock: mutation is dominated by the
    scheduler thread, but disaggregated decode pools (not ported yet)
    consult the index from server worker threads before a KV transfer,
    so walks must never see a half-split edge. The lock is
    uncontended in the unified single-writer case; readers of
    ``total_bytes`` / ``node_count`` from other threads still see
    torn-but-harmless ints.
    """

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self.root = _Node(edge=())
        self.total_bytes = 0
        self._clock = 0
        self._lock = threading.Lock()
        # weight-version key: slabs are K/V computed under ONE set of
        # model weights. A live weight swap (not ported yet) bumps this
        # via set_version, purging every stored slab — stale
        # K/V from the old weights can then never splice into a
        # new-weights prefill. match() double-checks per node (belt and
        # braces against any future partial-purge path).
        self.version: Any = 0

    # -- internals ---------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @staticmethod
    def _common(a, b) -> int:
        n = min(len(a), len(b))
        i = 0
        while i < n and a[i] == b[i]:
            i += 1
        return i

    def _slab_node(self, node: _Node) -> Optional[_Node]:
        """Slab-bearing node in ``node``'s subtree with the SMALLEST
        covered prompt (every descendant's slab covers the prefix ending
        at ``node``, so any is correct — but the splice cost scales with
        the donor slab's bucket, so the shortest covering slab is the
        cheapest donor)."""
        best = None
        stack = [node]
        while stack:
            n = stack.pop()
            if (
                n.slab is not None
                and n.version == self.version
                and (best is None or n.slab_tokens < best.slab_tokens)
            ):
                best = n
            stack.extend(n.children.values())
        return best

    def _slab_nodes(self) -> List[_Node]:
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            if n.slab is not None:
                out.append(n)
            stack.extend(n.children.values())
        return out

    def _node_tokens(self, node: _Node) -> Tuple[int, ...]:
        """Full token path of ``node`` (root -> node edge concat)."""
        parts: List[Tuple[int, ...]] = []
        cur: Optional[_Node] = node
        while cur is not None and cur is not self.root:
            parts.append(cur.edge)
            cur = cur.parent
        return tuple(t for edge in reversed(parts) for t in edge)

    def _prune(self, node: _Node) -> None:
        """Remove slab-less leaves up the ancestry (never the root)."""
        while (
            node is not None
            and node is not self.root
            and node.slab is None
            and not node.children
        ):
            parent = node.parent
            if parent is not None:
                parent.children.pop(node.edge[0], None)
            node = parent

    # -- queries -----------------------------------------------------------

    def _walk(self, tokens) -> Tuple[int, Optional[_Node], List[_Node]]:
        """Shared radix descent: ``(depth, carrier, path)`` where
        ``carrier`` is the deepest node whose subtree covers ``depth``
        (possibly entered mid-edge) and ``path`` is every node traversed.
        ``match`` and ``covered_len`` differ only in what they do with
        this — one walker keeps the edge-split/mid-edge subtleties in one
        place."""
        node, depth = self.root, 0
        carrier = None
        path: List[_Node] = []
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                break
            k = self._common(child.edge, tokens[depth:])
            if k == 0:
                break
            depth += k
            carrier = child
            path.append(child)
            if k < len(child.edge):
                break
            node = child
        return depth, carrier, path

    def match(self, tokens) -> Tuple[int, Any]:
        with self._lock:
            return self._match_locked(tokens)

    def _match_locked(self, tokens) -> Tuple[int, Any]:
        """Longest cached prefix of ``tokens``: returns ``(depth, slab)``
        where ``slab`` holds valid K/V for positions ``[0, depth)``, or
        ``(0, None)``. Touches the LRU clock on the serving slab's node
        and its slab-bearing ancestors (their content was used too)."""
        depth, carrier, path = self._walk(tokens)
        if depth == 0 or carrier is None:
            return 0, None
        slab_node = self._slab_node(carrier)
        if slab_node is None:
            return 0, None
        stamp = self._tick()
        slab_node.last_used = stamp
        for n in path:
            if n.slab is not None:
                n.last_used = stamp
        return depth, slab_node.slab

    def covered_len(self, tokens) -> int:
        with self._lock:
            return self._covered_len_locked(tokens)

    def _covered_len_locked(self, tokens) -> int:
        """Longest prefix of ``tokens`` some stored slab covers, WITHOUT
        touching the LRU clock (the publish-dedup probe)."""
        depth, carrier, _path = self._walk(tokens)
        if carrier is None or self._slab_node(carrier) is None:
            return 0
        return depth

    # -- mutation ----------------------------------------------------------

    def insert(self, tokens, slab, nbytes: int) -> int:
        with self._lock:
            return self._insert_locked(tokens, slab, nbytes)

    def _insert_locked(self, tokens, slab, nbytes: int) -> int:
        """Publish ``slab`` (K/V for the whole of ``tokens``) under the
        radix path, splitting edges as needed, then evict LRU slab nodes
        until the byte budget holds. Returns the number of slabs evicted.
        Re-publishing an exact existing path is a no-op (the stored slab
        already holds identical K/V)."""
        tokens = tuple(tokens)
        node, depth = self.root, 0
        while depth < len(tokens):
            child = node.children.get(tokens[depth])
            if child is None:
                new = _Node(edge=tokens[depth:], parent=node)
                node.children[tokens[depth]] = new
                node = new
                depth = len(tokens)
                break
            k = self._common(child.edge, tokens[depth:])
            if k < len(child.edge):
                # split child's edge at k; `mid` ends exactly at depth+k
                mid = _Node(edge=child.edge[:k], parent=node)
                node.children[tokens[depth]] = mid
                child.edge = child.edge[k:]
                child.parent = mid
                mid.children[child.edge[0]] = child
                node = mid
                depth += k
                continue
            node = child
            depth += k
        if node.slab is not None and node.version == self.version:
            node.last_used = self._tick()
            return 0
        if node.slab is not None:
            # stale-version slab at this exact path (defensive; set_version
            # purges these): replace rather than serve old-weights K/V
            self.total_bytes -= node.slab_bytes
        node.slab = slab
        node.slab_bytes = int(nbytes)
        node.slab_tokens = len(tokens)
        node.version = self.version
        node.last_used = self._tick()
        self.total_bytes += node.slab_bytes
        return self._evict_to_budget()

    def _evict_to_budget(self) -> int:
        return self._evict_down_locked(self.budget_bytes)

    def _evict_down_locked(self, target_bytes: int) -> int:
        evicted = 0
        while self.total_bytes > target_bytes:
            nodes = self._slab_nodes()
            if not nodes:
                break
            victim = min(nodes, key=lambda n: n.last_used)
            self.total_bytes -= victim.slab_bytes
            victim.slab = None
            victim.slab_bytes = 0
            victim.slab_tokens = 0
            evicted += 1
            self._prune(victim)
        return evicted

    def evict_to(self, target_bytes: int) -> int:
        """LRU-evict slabs until ``total_bytes <= target_bytes`` (the
        pressure ladder's first rung: the batcher demotes the cache
        below its own budget to reclaim device memory for live lanes).
        Returns the number of slabs evicted. Eviction only drops the
        tree's reference -- an admit that matched a slab moments earlier
        keeps it alive exactly as long as the splice needs it. (The JAX
        package's ``collect`` argument, which hands the victims to the
        host KV tier, comes with that tier.)"""
        with self._lock:
            return self._evict_down_locked(max(0, int(target_bytes)))

    def remove(self, tokens) -> bool:
        """Drop the slab stored at EXACTLY ``tokens`` (no prefix
        semantics). Returns True when an entry was removed. The host KV
        tier uses this to drop a corrupt entry by its recorded path."""
        tokens = tuple(tokens)
        with self._lock:
            for node in self._slab_nodes():
                if (
                    node.slab_tokens == len(tokens)
                    and self._node_tokens(node) == tokens
                ):
                    self.total_bytes -= node.slab_bytes
                    node.slab = None
                    node.slab_bytes = 0
                    node.slab_tokens = 0
                    self._prune(node)
                    return True
        return False

    def set_version(self, version) -> int:
        with self._lock:
            return self._set_version_locked(version)

    def _set_version_locked(self, version) -> int:
        """Key the pool to a new weight version, purging every stored
        slab the switch invalidates (K/V computed under replaced weights
        — serving one into a new-weights prefill would splice
        numerically wrong cache). Namespace-aware per
        :func:`version_retains`: a tenant page-in purges only that
        tenant's stale slabs and legacy un-namespaced ones; other
        tenants' slabs survive, invisible (``_slab_node`` requires
        ``node.version == self.version``) until their tenant pages back.
        Returns the number of slabs purged. No-op when the version is
        unchanged."""
        if version == self.version:
            return 0
        self.version = version
        purged = 0
        for node in self._slab_nodes():
            if version_retains(node.version, version):
                continue
            self.total_bytes -= node.slab_bytes
            node.slab = None
            node.slab_bytes = 0
            node.slab_tokens = 0
            purged += 1
            self._prune(node)
        return purged

    # -- introspection -----------------------------------------------------

    @property
    def node_count(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n - 1  # root is bookkeeping, not content

    @property
    def slab_count(self) -> int:
        return len(self._slab_nodes())
