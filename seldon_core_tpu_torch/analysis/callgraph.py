"""Lightweight per-module AST index: classes, methods, ``self.`` edges.

The serving stack's threading and locking invariants are all *intra-
class* properties (the batcher's scheduler contract, per-object lock
ordering), so the call graph deliberately resolves only what it can
resolve soundly:

* ``self.method(...)`` inside a class body → an edge to that class's
  method (if defined). This follows the admit path, the poll loop, the
  swap machinery — everything the thread-role and lock rules need.
* Anything else (cross-object calls, dynamic dispatch) is NOT an edge.
  Under-approximating keeps the rules quiet where they cannot be sure;
  the runtime role assertions (``SELDON_DEBUG_THREADS=1``) cover the
  dynamic remainder.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

__all__ = ["ClassIndex", "MethodInfo", "index_classes", "decorator_names", "reach_path"]


def decorator_names(node) -> Set[str]:
    """Trailing identifiers of each decorator (``@roles.scheduler_only``
    and ``@scheduler_only`` both yield ``scheduler_only``)."""
    out: Set[str] = set()
    for dec in getattr(node, "decorator_list", []):
        target = dec.func if isinstance(dec, ast.Call) else dec
        if isinstance(target, ast.Attribute):
            out.add(target.attr)
        elif isinstance(target, ast.Name):
            out.add(target.id)
    return out


@dataclasses.dataclass
class MethodInfo:
    name: str
    node: ast.AST
    decorators: Set[str]
    # callee method name -> first call-site line number
    self_calls: Dict[str, int]
    role: Optional[str] = None  # "scheduler" | "caller" | None


@dataclasses.dataclass
class ClassIndex:
    name: str
    node: ast.ClassDef
    methods: Dict[str, MethodInfo]


def _index_method(fn: ast.AST) -> MethodInfo:
    decs = decorator_names(fn)
    calls: Dict[str, int] = {}
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            recv = sub.func.value
            if isinstance(recv, ast.Name) and recv.id == "self":
                calls.setdefault(sub.func.attr, sub.lineno)
    role = None
    if "scheduler_only" in decs:
        role = "scheduler"
    elif "caller_thread" in decs:
        role = "caller"
    return MethodInfo(
        name=fn.name, node=fn, decorators=decs, self_calls=calls, role=role
    )


def index_classes(tree: ast.AST) -> List[ClassIndex]:
    out: List[ClassIndex] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        methods: Dict[str, MethodInfo] = {}
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                methods[item.name] = _index_method(item)
        out.append(ClassIndex(node.name, node, methods))
    return out


def reach_path(
    cls: ClassIndex,
    start: str,
    hits: Set[str],
    through: Optional[Set[str]] = None,
) -> Optional[List[Tuple[str, int]]]:
    """Shortest-ish self-call path from ``start`` to any method in
    ``hits``, traversing only methods in ``through`` (None = any method
    not itself in ``hits``). Returns ``[(callee, call lineno), ...]``
    edges, or None when unreachable. BFS so reports stay minimal."""
    from collections import deque

    q = deque([(start, [])])
    seen = {start}
    while q:
        cur, path = q.popleft()
        info = cls.methods.get(cur)
        if info is None:
            continue
        for callee, lineno in sorted(info.self_calls.items()):
            edge = path + [(callee, lineno)]
            if callee in hits:
                return edge
            if callee in seen or callee not in cls.methods:
                continue
            if through is not None and callee not in through:
                continue
            seen.add(callee)
            q.append((callee, edge))
    return None


def reachable_set(cls: ClassIndex, roots: Sequence[str]) -> Set[str]:
    """Every method reachable from ``roots`` via self-calls (inclusive)."""
    out: Set[str] = set()
    stack = [r for r in roots if r in cls.methods]
    while stack:
        cur = stack.pop()
        if cur in out:
            continue
        out.add(cur)
        stack.extend(
            c for c in cls.methods[cur].self_calls if c in cls.methods
        )
    return out


def iter_functions(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node
