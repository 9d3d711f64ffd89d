"""Contract drift: ``metric-drift``, ``annotation-drift``, ``wall-clock``.

**metric-drift.** The ``seldon_engine_*`` vocabulary lives in four
places that historically drifted independently: the registry's mapping
tables in ``graph/engine_metrics.py`` (``_STEP_PHASES``,
``_KV_TRANSFER``, ``_RECOVERY``, ``_RECOVERY_GAUGES``, ``_SLO_TIMERS``,
``_FUSED``, ``_DEVICE``, ``_DEVICE_GAUGES``, ``_SLO_BURN``),
the servers that emit the ``gen_*`` keys those tables consume, the
tools that parse the published series (``flight_report``,
``gen_arch_numbers``), and the operator docs. The rule re-derives the
table from source and cross-checks all four:

* every mapped ``gen_*`` input key is actually emitted somewhere,
* every first-class ``seldon_engine_*`` series named in package code is
  documented in ``docs/*.md`` (its *full* name — shorthand like
  ``_bytes`` does not count, because operators copy metric names into
  PromQL),
* every ``seldon_engine_*`` name the docs mention exists in code (a
  rename must update the docs in the same PR),
* a ``seldon_engine_*`` literal in ``tools/`` must exist in the package
  (drift there makes the published numbers lie).

**annotation-drift.** Same pact for ``seldon.io/*`` annotations between
the controlplane/graph parsers and the docs tables, both directions.
Keys ending in ``-`` (e.g. the ``seldon.io/engine-env-`` prefix) match
on the prefix base.

**wall-clock.** ``time.time()`` is reserved for *named wall anchors* —
an assignment whose target contains ``wall`` (``submit_wall_us``,
``_WALL_ANCHOR_US``). Everything else must use ``time.monotonic()``
(intervals, deadlines, backoff, ordering) or the monotonic-anchored
:func:`seldon_core_tpu_torch.tracing.wall_us` (event timestamps): the wall
clock steps under NTP corrections, and at production rates a one-second
step silently corrupts every deadline and every recorded interval in
flight. Genuine wall-time sites (persisted checkpoint stamps,
human-facing event trails) carry inline suppressions with their
justification.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .core import Finding, LintContext, SourceFile

__all__ = [
    "check_annotation_drift",
    "check_metric_drift",
    "check_wall_clock",
]

_MAP_NAMES = {
    "_STEP_PHASES", "_KV_TRANSFER", "_RECOVERY", "_RECOVERY_GAUGES",
    "_SLO_TIMERS", "_FUSED", "_DEVICE", "_DEVICE_GAUGES", "_SLO_BURN",
}
# built by concatenation so these source files never match their own
# scanning patterns
_METRIC_RE = re.compile("seldon_engine" + "_[a-z0-9_]+")
_GEN_KEY_RE = re.compile("gen" + "_[a-z0-9_]+")
_ANNOT_RE = re.compile(r"(?<![a-z0-9.])seldon\.io/[a-z0-9-]+")


def _str_constants(tree: ast.AST) -> Iterable[Tuple[str, int]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.value, node.lineno


def _docs_tokens(ctx: LintContext, pattern: re.Pattern):
    """``name -> (docfile rel-ish path, lineno, line text)`` first sighting."""
    out: Dict[str, Tuple[str, int, str]] = {}
    for path in ctx.docs_files:
        try:
            text = ctx.doc_text(path)
        except OSError:
            continue
        rel = _rel(ctx, path)
        for i, line in enumerate(text.splitlines(), start=1):
            for m in pattern.finditer(line):
                tok = m.group(0)
                # `seldon_engine_kv_transfer_*` / `..._{slabs,bytes}`-style
                # family shorthand is not a name: skip in both directions.
                # (A name followed by a label set — `..._retries{unit=...}`
                # — does NOT end with `_` and still counts.)
                if tok.endswith("_") and line[m.end():m.end() + 1] in ("*", "{"):
                    continue
                out.setdefault(tok.rstrip("_"), (rel, i, line.strip()))
    return out


def _rel(ctx: LintContext, path: str) -> str:
    import os

    try:
        return os.path.relpath(path, ctx.root).replace(os.sep, "/")
    except ValueError:
        return path


def _is_tools_file(sf: SourceFile) -> bool:
    return sf.rel.startswith("tools/") or "/tools/" in sf.rel


def check_metric_drift(
    files: List[SourceFile], ctx: LintContext
) -> Iterable[Finding]:
    findings: List[Finding] = []
    # map entries: (gen key, output name, file, lineno)
    entries: List[Tuple[str, Optional[str], SourceFile, int]] = []
    map_files: Set[str] = set()
    for sf in files:
        if sf.tree is None:
            continue
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Assign) or not isinstance(
                node.value, ast.Dict
            ):
                continue
            names = {
                t.id for t in node.targets if isinstance(t, ast.Name)
            }
            if not names & _MAP_NAMES:
                continue
            map_files.add(sf.rel)
            for k, v in zip(node.value.keys, node.value.values):
                if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                    continue
                out_name = None
                cands = [v] + (list(v.elts) if isinstance(v, ast.Tuple) else [])
                for cand in cands:
                    if (
                        isinstance(cand, ast.Constant)
                        and isinstance(cand.value, str)
                        and _METRIC_RE.fullmatch(cand.value)
                    ):
                        out_name = cand.value
                        break
                entries.append((k.value, out_name, sf, k.lineno))

    # gen_* keys emitted anywhere OUTSIDE the mapping file(s)
    emitted: Set[str] = set()
    # package-defined and tools-referenced seldon_engine_* literals
    defined: Dict[str, Tuple[SourceFile, int]] = {}
    tool_refs: List[Tuple[str, SourceFile, int]] = []
    any_package = False
    for sf in files:
        if sf.tree is None:
            continue
        is_tool = _is_tools_file(sf)
        if not is_tool:
            any_package = True
        for value, lineno in _str_constants(sf.tree):
            if _GEN_KEY_RE.fullmatch(value) and sf.rel not in map_files:
                emitted.add(value)
            if _METRIC_RE.fullmatch(value):
                if is_tool:
                    tool_refs.append((value, sf, lineno))
                else:
                    defined.setdefault(value, (sf, lineno))

    doc_metrics = _docs_tokens(ctx, _METRIC_RE)

    for gen_key, out_name, sf, lineno in entries:
        if gen_key not in emitted:
            findings.append(Finding(
                "metric-drift", sf.rel, lineno, 0,
                f"mapped metric key '{gen_key}' is emitted by no server — "
                "the first-class series it feeds will stay empty "
                "(renamed emitter?)",
                sf.line_text(lineno),
            ))
        if out_name is None:
            findings.append(Finding(
                "metric-drift", sf.rel, lineno, 0,
                f"mapping for '{gen_key}' carries no seldon_engine_* "
                "output name",
                sf.line_text(lineno),
            ))
    if ctx.docs_files:
        for name, (sf, lineno) in sorted(defined.items()):
            if name not in doc_metrics:
                findings.append(Finding(
                    "metric-drift", sf.rel, lineno, 0,
                    f"metric '{name}' is not documented in docs/*.md by "
                    "its full name — operators copy metric names into "
                    "PromQL; shorthand does not scrape",
                    sf.line_text(lineno),
                ))
        if any_package:
            for name, (doc, lineno, text) in sorted(doc_metrics.items()):
                if name not in defined:
                    findings.append(Finding(
                        "metric-drift", doc, lineno, 0,
                        f"docs document metric '{name}' but no package "
                        "code defines it (renamed series?)",
                        text,
                    ))
    if any_package:
        for name, sf, lineno in tool_refs:
            if name not in defined:
                findings.append(Finding(
                    "metric-drift", sf.rel, lineno, 0,
                    f"tool references metric '{name}' that no package "
                    "code defines — published numbers would lie",
                    sf.line_text(lineno),
                ))
    return findings


def _annot_base(key: str) -> str:
    return key.rstrip("-")


def check_annotation_drift(
    files: List[SourceFile], ctx: LintContext
) -> Iterable[Finding]:
    findings: List[Finding] = []
    if not ctx.docs_files:
        return findings
    code_keys: Dict[str, Tuple[SourceFile, int]] = {}
    any_package = False
    for sf in files:
        if sf.tree is None or _is_tools_file(sf):
            continue
        any_package = True
        for value, lineno in _str_constants(sf.tree):
            if _ANNOT_RE.fullmatch(value):
                # trailing-dash keys are prefix families
                # (seldon.io/engine-env-): compare on the dash-stripped base
                code_keys.setdefault(_annot_base(value), (sf, lineno))

    doc_keys = _docs_tokens(ctx, _ANNOT_RE)
    doc_bases = {_annot_base(k) for k in doc_keys}
    # docs may document a prefix family as `seldon.io/engine-env-<NAME>`;
    # count any documented key that starts with a code prefix base
    for base, (sf, lineno) in sorted(code_keys.items()):
        documented = base in doc_bases or any(
            d.startswith(base + "-") or d == base for d in doc_bases
        )
        if not documented:
            findings.append(Finding(
                "annotation-drift", sf.rel, lineno, 0,
                f"annotation '{base}' is parsed by the code but appears "
                "in no docs/*.md table",
                sf.line_text(lineno),
            ))
    if any_package:
        for key, (doc, lineno, text) in sorted(doc_keys.items()):
            base = _annot_base(key)
            known = base in code_keys or any(
                base.startswith(c + "-") for c in code_keys
            )
            if not known:
                findings.append(Finding(
                    "annotation-drift", doc, lineno, 0,
                    f"docs document annotation '{base}' that no code "
                    "parses (renamed?)",
                    text,
                ))
    return findings


def _is_time_time(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "time":
        return isinstance(f.value, ast.Name) and f.value.id == "time"
    return isinstance(f, ast.Name) and f.id == "time"


def check_wall_clock(
    files: List[SourceFile], ctx: LintContext
) -> Iterable[Finding]:
    findings: List[Finding] = []
    for sf in files:
        if sf.tree is None:
            continue
        allowed: Set[int] = set()
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Assign):
                continue
            anchors = False
            for tgt in node.targets:
                text = ""
                t = tgt
                while isinstance(t, ast.Attribute):
                    text = t.attr
                    break
                if isinstance(t, ast.Name):
                    text = t.id
                if "wall" in text.lower():
                    anchors = True
            if anchors:
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Call) and _is_time_time(sub):
                        allowed.add(id(sub))
        for node in ast.walk(sf.tree):
            if (
                isinstance(node, ast.Call)
                and _is_time_time(node)
                and id(node) not in allowed
            ):
                findings.append(sf.finding(
                    "wall-clock", node,
                    "time.time() outside a *wall* anchor assignment: "
                    "interval/deadline/ordering math must use "
                    "time.monotonic(); event timestamps should go "
                    "through the monotonic-anchored tracing.wall_us()",
                ))
    return findings
