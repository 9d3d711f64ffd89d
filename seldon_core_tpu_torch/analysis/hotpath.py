"""Device hot-path hygiene for PyTorch: ``host-sync-hot-path`` and
``retrace-hazard``.

Scope: methods reachable (via same-class calls) from a scheduler hot
root — any ``@scheduler_only`` method, or a method named ``_loop`` /
``_run``. That is the code executing at poll cadence between device
launches, where a stray host sync serializes the software pipeline and
a fresh CUDA graph capture stalls every lane.

**host-sync-hot-path.** Implicit host syncs block the scheduler until
the card catches up:

* ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``, ``.to("cpu")``
  (or ``device="cpu"``), ``torch.cuda.synchronize()`` and an event's or
  a stream's ``.synchronize()`` anywhere in hot-path code — these are
  syncs by definition. The *designed* sync points (reading a finished
  burst's tokens) carry suppressions with justification, which is
  exactly the visibility we want.
* ``bool()`` / ``int()`` / ``float()`` applied to a value bound in the
  same function from a graph replay or a model forward (a call of
  ``.replay()``, of a model's forward methods, or of anything on
  ``self.model`` / ``self.draft_model``). Tracking is intra-function
  assignment-based on purpose: a parameter or attribute could be
  anything, and guessing would bury real findings in noise.

**retrace-hazard.** The PyTorch counterpart of a JAX retrace is a CUDA
graph captured for each distinct value: the batcher keys its captured
decode-burst phases (``self._phase(key, fn)``; ``<graphs>.run(key,
fn)`` / ``<graphs>.capture(key, fn)`` on a graph cache), and a key it
has not seen captures inline (``graph_captures_inline``). So the keys
at those calls are checked:

* ``len(...)`` in a key (unbounded integers; pass a pow2 / bucketized
  size instead),
* float constants or ``float()`` casts (continuous domain — e.g. a
  temperature must be a tensor the graph reads, not a key),
* dict/list/set literals (unhashable: the cache lookup raises, and
  hashable wrappers capture per content).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from .callgraph import ClassIndex, index_classes, reachable_set
from .core import Finding, LintContext, SourceFile

__all__ = ["check_host_sync", "check_retrace"]

_CAST_FNS = {"bool", "int", "float"}
# methods whose call is a host sync by definition
_SYNC_ATTRS = {"item", "cpu", "tolist", "numpy", "synchronize"}
# calls whose result is a device tensor from a forward or a replay
_FORWARD_ATTRS = {
    "replay", "apply", "forward", "prefill", "prefill_chunk", "prefill_with_prefix",
    "decode_step_ragged_list", "decode_chunk_ragged_list", "generate",
}
_MODEL_RECEIVERS = {"model", "draft_model"}
# the graph caches' keyed entry points: self._phase(key, fn) and
# <...graphs>.run / .capture(key, fn)
_CAPTURE_ATTRS = {"run", "capture"}


def _hot_roots(cls: ClassIndex) -> List[str]:
    roots = [n for n, m in cls.methods.items() if m.role == "scheduler"]
    for name in ("_loop", "_run"):
        if name in cls.methods and name not in roots:
            roots.append(name)
    return roots


def _dotted(node) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def _is_to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device("cpu"))``."""
    f = call.func
    if not (isinstance(f, ast.Attribute) and f.attr == "to"):
        return False
    args = list(call.args[:1]) + [kw.value for kw in call.keywords if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and _dotted(a.func) in ("torch.device", "device") and a.args:
            a = a.args[0]
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
    return False


def sync_reason(call: ast.Call) -> Optional[str]:
    """The host sync this call is by definition, or None."""
    f = call.func
    if isinstance(f, ast.Attribute):
        if f.attr in _SYNC_ATTRS:
            if f.attr == "synchronize":
                return "torch.cuda.synchronize()" if _dotted(f) == "torch.cuda.synchronize" \
                    else ".synchronize()"
            return f".{f.attr}()"
        if _is_to_cpu(call):
            return '.to("cpu")'
    return None


def _is_device_call(expr) -> bool:
    if not isinstance(expr, ast.Call) or not isinstance(expr.func, ast.Attribute):
        return False
    if expr.func.attr in _FORWARD_ATTRS:
        return True
    recv = _dotted(expr.func.value) or ""
    return recv.rsplit(".", 1)[-1] in _MODEL_RECEIVERS


def _device_result_names(fn: ast.AST) -> Set[str]:
    """Names bound (directly or via tuple unpack) from a forward or a
    graph replay."""
    names: Set[str] = set()
    for sub in ast.walk(fn):
        if not isinstance(sub, ast.Assign) or not _is_device_call(sub.value):
            continue
        for tgt in sub.targets:
            for leaf in ast.walk(tgt):
                if isinstance(leaf, ast.Name):
                    names.add(leaf.id)
    return names


def check_host_sync(
    files: List[SourceFile], ctx: LintContext
) -> Iterable[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if sf.tree is None:
            continue
        for cls in index_classes(sf.tree):
            roots = _hot_roots(cls)
            if not roots:
                continue
            hot = reachable_set(cls, roots)
            for name in sorted(hot):
                fn = cls.methods[name].node
                traced = _device_result_names(fn)
                for sub in ast.walk(fn):
                    if not isinstance(sub, ast.Call):
                        continue
                    why = sync_reason(sub)
                    if why:
                        findings.append(sf.finding(
                            "host-sync-hot-path", sub,
                            f"{why} in '{cls.name}.{name}' "
                            "(poll-loop-reachable) blocks the scheduler "
                            "on the device; move the read behind the "
                            "pipelined burst boundary",
                        ))
                        continue
                    f = sub.func
                    if not (isinstance(f, ast.Name) and f.id in _CAST_FNS and sub.args):
                        continue
                    target = sub.args[0]
                    # metadata reads (.shape/.dtype/...) never touch the
                    # device: exempt names that only appear under them
                    meta_names = set()
                    for wrap in ast.walk(target):
                        if isinstance(wrap, ast.Attribute) and wrap.attr in (
                            "nbytes", "shape", "ndim", "dtype", "device",
                            "sharding",
                        ):
                            meta_names.update(
                                id(leaf) for leaf in ast.walk(wrap.value)
                                if isinstance(leaf, ast.Name)
                            )
                    hit = any(
                        isinstance(leaf, ast.Name)
                        and leaf.id in traced
                        and id(leaf) not in meta_names
                        for leaf in ast.walk(target)
                    )
                    if hit:
                        findings.append(sf.finding(
                            "host-sync-hot-path", sub,
                            f"{f.id}() on a forward or graph-replay result in "
                            f"'{cls.name}.{name}' (poll-loop-reachable) "
                            "forces an implicit device->host sync",
                        ))
    return findings


def _is_capture_call(call: ast.Call) -> bool:
    f = call.func
    if not isinstance(f, ast.Attribute) or not call.args:
        return False
    if f.attr == "_phase" and isinstance(f.value, ast.Name) and f.value.id == "self":
        return True
    recv = (_dotted(f.value) or "").rsplit(".", 1)[-1].lower()
    return f.attr in _CAPTURE_ATTRS and recv.endswith("graphs")


def _key_hazard(elt) -> Optional[str]:
    if isinstance(elt, ast.Call) and isinstance(elt.func, ast.Name):
        if elt.func.id == "len":
            return ("len(...) in a capture key captures a graph per distinct "
                    "size; key on a bucketized value (pow2 group size, attn bucket)")
        if elt.func.id == "float":
            return ("float(...) in a capture key: a continuous domain captures "
                    "a graph per value; make it a tensor the graph reads")
    if isinstance(elt, ast.Constant) and isinstance(elt.value, float):
        return ("float constant in a capture key: a continuous domain captures "
                "a graph per value; make it a tensor the graph reads")
    if isinstance(elt, (ast.Dict, ast.List, ast.Set)):
        return "unhashable container literal in a CUDA graph capture key"
    return None


def check_retrace(
    files: List[SourceFile], ctx: LintContext
) -> Iterable[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if sf.tree is None:
            continue
        for cls in index_classes(sf.tree):
            roots = _hot_roots(cls)
            if not roots:
                continue
            hot = reachable_set(cls, roots)
            for name in sorted(hot):
                fn = cls.methods[name].node
                for sub in ast.walk(fn):
                    if not isinstance(sub, ast.Call) or not _is_capture_call(sub):
                        continue
                    key = sub.args[0]
                    elts = key.elts if isinstance(key, ast.Tuple) else [key]
                    for pos, elt in enumerate(elts):
                        bad = _key_hazard(elt)
                        if bad:
                            findings.append(sf.finding(
                                "retrace-hazard", elt,
                                f"{_dotted(sub.func)}(...) key element {pos} in "
                                f"'{cls.name}.{name}': {bad}",
                            ))
    return findings
