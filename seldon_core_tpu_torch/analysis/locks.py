"""Lock discipline: ``blocking-under-lock`` and ``lock-order``.

**blocking-under-lock.** The batcher's poll loop and every request
worker share a handful of mutexes (``_swap_lock``, ``_export_lock``,
``_thread_lock``, the prefix index's ``_lock``, the metrics registry's
``_lock``...). The standing convention is that lock bodies are
pointer/bookkeeping work only — the moment a ``time.sleep``, socket
recv, queue wait, ``Future.result`` or device sync (``.item()``,
``.cpu()``, ``.tolist()``, ``.numpy()``, ``.to("cpu")``,
``torch.cuda.synchronize()``, an event's or a stream's
``.synchronize()``: :func:`.hotpath.sync_reason`) runs under one, every thread
needing that lock stalls behind I/O, and at production rates that reads
as a tail-latency cliff (or a deadlock when the blocked-on progress
needs the same lock). The rule flags blocking calls lexically inside
``with <lock>:`` bodies, including one level of indirection through a
same-class helper (``with self._lock: self._helper()`` where the helper
blocks).

**lock-order.** Nested acquisitions define a lock-ordering graph: an
edge ``A -> B`` whenever ``B`` is taken while ``A`` is held (directly
nested ``with``, or a self-call made under ``A`` into a method that
takes ``B``, transitively). A cycle in that graph is a latent deadlock —
two threads entering the cycle from different corners stop forever.
Lock identity is scoped per class/module (``ContinuousBatcher:
self._swap_lock``), which matches how every lock in this repo is owned;
cross-object aliasing is out of scope and documented as such.

A ``with`` context counts as a lock when its expression's trailing name
ends in ``lock`` (``self._lock``, ``self._swap_lock``, ``run_lock``) —
the repo's universal naming convention, checked by fixture tests.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .callgraph import index_classes, iter_functions
from .core import Finding, LintContext, SourceFile
from .hotpath import sync_reason

__all__ = ["check_blocking_under_lock", "check_lock_order"]

# attribute names whose call blocks the calling thread
_BLOCK_ATTRS = {
    "recv", "recv_into", "recvfrom", "accept", "connect", "sendall",
    "result", "join", "wait", "acquire",
}
_QUEUE_ATTRS = {"get", "put"}


def _dotted(node) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _lock_ids(with_node: ast.With, scope: str) -> List[Tuple[str, str]]:
    """``(lock id, display text)`` for each lock-like context item."""
    out = []
    for item in with_node.items:
        expr = item.context_expr
        # `with self._lock.acquire_timeout(...)`-style helpers: look at
        # the called object
        if isinstance(expr, ast.Call):
            expr = expr.func
        text = _dotted(expr)
        if not text:
            continue
        leaf = text.rsplit(".", 1)[-1]
        if leaf.lower().endswith("lock"):
            out.append((f"{scope}:{text}", text))
    return out


def _blocking_reason(call: ast.Call) -> Optional[str]:
    """Why this call blocks, or None."""
    func = call.func
    text = _dotted(func)
    if text == "time.sleep" or text == "sleep":
        return "time.sleep"
    if isinstance(func, ast.Attribute):
        attr = func.attr
        if attr == "join":
            if isinstance(func.value, (ast.Constant, ast.JoinedStr)):
                return None  # str.join
            recv = (_dotted(func.value) or "").lower()
            if recv.rsplit(".", 1)[-1] in ("path", "posixpath", "ntpath"):
                return None  # os.path.join
        if attr in _BLOCK_ATTRS:
            return f".{attr}()"
        if attr in _QUEUE_ATTRS:
            recv = _dotted(func.value) or ""
            leaf = recv.rsplit(".", 1)[-1].lower()
            if "queue" in leaf or leaf in ("q", "_q"):
                return f"queue .{attr}()"
    why = sync_reason(call)
    return f"device sync {why}" if why else None


def _direct_blockers(fn: ast.AST) -> List[Tuple[str, int]]:
    out = []
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call):
            why = _blocking_reason(sub)
            if why:
                out.append((why, sub.lineno))
    return out


def _held_events(fn: ast.AST, scope: str):
    """Yield ``(held locks, statement)`` for statements under >=1 lock, and
    ``(held locks, with_node, new locks)`` acquisition events."""
    acquisitions: List[Tuple[Tuple[Tuple[str, str], ...], ast.With, List[Tuple[str, str]]]] = []
    under: List[Tuple[Tuple[Tuple[str, str], ...], ast.stmt]] = []

    def walk(stmts, held):
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue  # deferred execution: not under this lock
            if isinstance(stmt, ast.With):
                locks = _lock_ids(stmt, scope)
                acquisitions.append((tuple(held), stmt, locks))
                walk(stmt.body, held + list(locks))
                continue
            compound = False
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(stmt, field, None)
                if isinstance(sub, list):
                    compound = True
                    walk(sub, held)
            for handler in getattr(stmt, "handlers", []) or []:
                compound = True
                walk(handler.body, held)
            # only SIMPLE statements become events: compound bodies were
            # recursed above, and a nested def under a lock runs later —
            # its body is not "under the lock"
            if held and not compound:
                under.append((tuple(held), stmt))
            # if/while TESTS and for ITERS evaluate under the lock even
            # though the statement is compound
            if held and compound:
                for field in ("test", "iter"):
                    expr = getattr(stmt, field, None)
                    if expr is not None:
                        under.append((tuple(held), expr))

    walk(getattr(fn, "body", []), [])
    return acquisitions, under


def check_blocking_under_lock(
    files: List[SourceFile], ctx: LintContext
) -> Iterable[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if sf.tree is None:
            continue
        # same-class helpers that block directly (one indirection level)
        class_blockers: Dict[str, Dict[str, Tuple[str, int]]] = {}
        for cls in index_classes(sf.tree):
            blockers: Dict[str, Tuple[str, int]] = {}
            for name, info in cls.methods.items():
                direct = _direct_blockers(info.node)
                if direct:
                    blockers[name] = direct[0]
            class_blockers[cls.name] = blockers

        # one pass: which class owns each directly-enclosed function
        owner: Dict[int, str] = {
            id(item): cls.name
            for cls in index_classes(sf.tree)
            for item in cls.node.body
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        seen: Set[int] = set()
        for fn in iter_functions(sf.tree):
            scope = owner.get(id(fn), sf.rel)
            _, under = _held_events(fn, scope)
            blockers = class_blockers.get(scope, {})
            for held, stmt in under:
                for sub in ast.walk(stmt):
                    if not isinstance(sub, ast.Call) or id(sub) in seen:
                        continue
                    lock_text = held[-1][1]
                    why = _blocking_reason(sub)
                    if why:
                        seen.add(id(sub))
                        findings.append(sf.finding(
                            "blocking-under-lock", sub,
                            f"{why} inside `with {lock_text}:` — lock "
                            "bodies must be pointer/bookkeeping work; "
                            "every thread needing the lock stalls behind "
                            "this call",
                        ))
                        continue
                    # one level of self-call indirection
                    f = sub.func
                    if (
                        isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "self"
                        and f.attr in blockers
                        and f.attr != getattr(fn, "name", None)
                    ):
                        inner_why, inner_line = blockers[f.attr]
                        seen.add(id(sub))
                        findings.append(sf.finding(
                            "blocking-under-lock", sub,
                            f"self.{f.attr}() inside `with {lock_text}:` "
                            f"blocks ({inner_why} at line {inner_line})",
                        ))
    return findings


def check_lock_order(
    files: List[SourceFile], ctx: LintContext
) -> Iterable[Finding]:
    # edge: (from_lock, to_lock) -> (file, with node, description)
    edges: Dict[Tuple[str, str], Tuple[SourceFile, ast.AST, str]] = {}

    for sf in files:
        if sf.tree is None:
            continue
        module_scope = sf.rel
        classes = index_classes(sf.tree)
        # per class: method -> set of locks it (transitively) acquires
        for cls in classes:
            direct: Dict[str, List[Tuple[str, str]]] = {}
            events_by_method = {}
            for name, info in cls.methods.items():
                events_by_method[name] = _held_events(info.node, cls.name)
                direct[name] = [
                    lock
                    for _, _, locks in events_by_method[name][0]
                    for lock in locks
                ]
            # fixpoint: locks acquired transitively through self-calls
            trans: Dict[str, Set[str]] = {
                n: {lid for lid, _ in direct[n]} for n in cls.methods
            }
            changed = True
            while changed:
                changed = False
                for name, info in cls.methods.items():
                    for callee in info.self_calls:
                        if callee in trans and not trans[callee] <= trans[name]:
                            trans[name] |= trans[callee]
                            changed = True
            for name, info in cls.methods.items():
                acqs, under = events_by_method[name]
                for held, node, locks in acqs:
                    for h_id, h_text in held:
                        for l_id, l_text in locks:
                            edges.setdefault((h_id, l_id), (
                                sf, node,
                                f"{cls.name}.{name} takes {l_text} while "
                                f"holding {h_text}",
                            ))
                # calls made while holding a lock pull in the callee's
                # transitive acquisitions — INCLUDING re-acquisition of
                # the held lock itself (h_id == l_id lands on the a == b
                # branch below: threading.Lock is not re-entrant, and
                # unlike lexical with-nesting the deadlock hides behind
                # the call)
                for held, stmt in under:
                    for sub in ast.walk(stmt):
                        if not (
                            isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and isinstance(sub.func.value, ast.Name)
                            and sub.func.value.id == "self"
                        ):
                            continue
                        callee = sub.func.attr
                        for l_id in trans.get(callee, ()):
                            for h_id, h_text in held:
                                edges.setdefault((h_id, l_id), (
                                    sf, sub,
                                    f"{cls.name}.{name} calls "
                                    f"self.{callee}() (which takes "
                                    f"{l_id.split(':', 1)[1]}) while "
                                    f"holding {h_text}",
                                ))
        # module-level functions (rare; scoped by file)
        class_fns = {
            id(item)
            for cls in classes
            for item in cls.node.body
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        for fn in iter_functions(sf.tree):
            if id(fn) in class_fns:
                continue
            acqs, _ = _held_events(fn, module_scope)
            for held, node, locks in acqs:
                for h_id, h_text in held:
                    for l_id, l_text in locks:
                        edges.setdefault((h_id, l_id), (
                            sf, node,
                            f"{getattr(fn, 'name', '?')} takes {l_text} "
                            f"while holding {h_text}",
                        ))

    # immediate self-deadlock: with L: ... with L: (non-reentrant Lock)
    findings: List[Finding] = []
    graph: Dict[str, Set[str]] = {}
    for (a, b), (sf, node, desc) in sorted(edges.items()):
        if a == b:
            findings.append(sf.finding(
                "lock-order", node,
                f"re-acquisition of {a.split(':', 1)[1]} while already "
                f"held ({desc}) — threading.Lock is not re-entrant",
            ))
            continue
        graph.setdefault(a, set()).add(b)

    # cycle detection: DFS with coloring; report each cycle once
    WHITE, GREY, BLACK = 0, 1, 2
    color: Dict[str, int] = {n: WHITE for n in graph}
    reported: Set[frozenset] = set()

    def dfs(node: str, stack: List[str]):
        color[node] = GREY
        stack.append(node)
        for nxt in sorted(graph.get(node, ())):
            if color.get(nxt, WHITE) == GREY:
                cycle = stack[stack.index(nxt):] + [nxt]
                key = frozenset(cycle)
                if key not in reported:
                    reported.add(key)
                    sf, anchor, desc = edges[(node, nxt)]
                    pretty = " -> ".join(c.split(":", 1)[1] for c in cycle)
                    findings.append(sf.finding(
                        "lock-order", anchor,
                        f"lock acquisition cycle {pretty} ({desc}); two "
                        "threads entering from different corners deadlock",
                    ))
            elif color.get(nxt, WHITE) == WHITE:
                dfs(nxt, stack)
        stack.pop()
        color[node] = BLACK

    for n in sorted(graph):
        if color.get(n, WHITE) == WHITE:
            dfs(n, [])
    return findings
