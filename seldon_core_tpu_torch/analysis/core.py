"""seldon-lint core: findings, suppressions, baseline, and the runner.

Design constraints, in priority order:

* **Stdlib only.** Everything rides on ``ast`` + ``re`` so the gate runs
  in any environment that can import the repo.
* **Regression gate, not a style cop.** A checked-in baseline file holds
  accepted pre-existing findings; CI fails only on findings NOT covered
  by the baseline, so landing the analyzer never blocks on boiling the
  ocean — while any *new* violation of an encoded invariant fails the
  build the day it is written.
* **Suppressible with provenance.** ``# seldon-lint: disable=<rule>``
  on the flagged line (or alone on the line above) silences exactly that
  rule there; a reader sees the justification comment next to it.

Baseline matching is by ``(rule, path, stripped line text)`` with
counts, not line numbers — unrelated edits that shift a file must not
resurrect accepted findings, while editing the flagged line itself
re-opens the question.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "LintContext",
    "LintResult",
    "SourceFile",
    "collect_files",
    "load_baseline",
    "run_lint",
    "write_baseline",
]

_DIRECTIVE = re.compile(
    r"#\s*seldon-lint:\s*(disable|disable-file)\s*=\s*([A-Za-z0-9_,\- ]+)"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored at ``path:line:col``."""

    rule: str
    path: str  # repo-relative, POSIX separators
    line: int
    col: int
    message: str
    line_text: str = ""  # stripped source line: the baseline key

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.line_text)

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


class SourceFile:
    """A parsed python file plus its suppression directives."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(text)
        except SyntaxError as e:  # surfaced as a parse-error finding
            self.parse_error = e
        # line -> set of disabled rules ({"all"} disables everything)
        self._disabled: Dict[int, set] = {}
        self._file_disabled: set = set()
        for i, line in enumerate(self.lines, start=1):
            m = _DIRECTIVE.search(line)
            if not m:
                continue
            rules = {r.strip() for r in m.group(2).split(",") if r.strip()}
            if m.group(1) == "disable-file":
                self._file_disabled |= rules
            else:
                self._disabled.setdefault(i, set()).update(rules)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, rule: str, lineno: int) -> bool:
        if {"all", rule} & self._file_disabled:
            return True
        for at in (lineno, lineno - 1):
            rules = self._disabled.get(at)
            if rules and ({"all", rule} & rules):
                # a directive on the preceding line only counts when that
                # line is a standalone comment (a trailing directive
                # belongs to ITS line's findings)
                if at == lineno or self.line_text(at).startswith("#"):
                    return True
        return False

    def finding(self, rule: str, node, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule, self.rel, line, col, message, self.line_text(line))


@dataclasses.dataclass
class LintContext:
    """Project-level inputs shared by the rules."""

    root: str
    docs_files: List[str] = dataclasses.field(default_factory=list)

    def doc_text(self, path: str) -> str:
        with open(path, "r", encoding="utf-8") as f:
            return f.read()


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]  # actionable: neither suppressed nor baselined
    baselined: List[Finding]
    suppressed: List[Finding]
    files: int = 0

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0


def collect_files(paths: Sequence[str], root: str) -> List[SourceFile]:
    out: List[SourceFile] = []
    seen = set()
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isfile(ap) and ap.endswith(".py"):
            cands = [ap]
        else:
            cands = []
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                cands.extend(
                    os.path.join(dirpath, f)
                    for f in sorted(filenames)
                    if f.endswith(".py")
                )
        for f in sorted(cands):
            if f in seen:
                continue
            seen.add(f)
            rel = os.path.relpath(f, root).replace(os.sep, "/")
            with open(f, "r", encoding="utf-8") as fh:
                out.append(SourceFile(f, rel, fh.read()))
    return out


def default_docs(root: str) -> List[str]:
    docs_dir = os.path.join(root, "docs")
    if not os.path.isdir(docs_dir):
        return []
    return sorted(
        os.path.join(docs_dir, f)
        for f in os.listdir(docs_dir)
        if f.endswith(".md")
    )


# -- baseline ---------------------------------------------------------------


def load_baseline(path: str) -> Counter:
    """``(rule, path, line_text) -> accepted count``; empty when absent."""
    if not path or not os.path.exists(path):
        return Counter()
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    out: Counter = Counter()
    for entry in data.get("findings", []):
        key = (entry["rule"], entry["path"], entry.get("line_text", ""))
        out[key] += int(entry.get("count", 1))
    return out


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    counts: Counter = Counter(f.key() for f in findings)
    payload = {
        "version": 1,
        "comment": (
            "Accepted pre-existing seldon-lint findings. CI fails only on "
            "findings NOT in this file. Refresh with: "
            "python -m seldon_core_tpu_torch.analysis --write-baseline <paths>"
        ),
        "findings": [
            {"rule": rule, "path": path_, "line_text": text, "count": n}
            for (rule, path_, text), n in sorted(counts.items())
        ],
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=False)
        f.write("\n")


# -- runner -----------------------------------------------------------------


def _all_rules():
    # local import: rule modules import this module for Finding/SourceFile
    from . import contracts, hotpath, locks, threads

    return {
        "thread-role": threads.check_thread_roles,
        "blocking-under-lock": locks.check_blocking_under_lock,
        "lock-order": locks.check_lock_order,
        "host-sync-hot-path": hotpath.check_host_sync,
        "retrace-hazard": hotpath.check_retrace,
        "metric-drift": contracts.check_metric_drift,
        "annotation-drift": contracts.check_annotation_drift,
        "wall-clock": contracts.check_wall_clock,
    }


def run_lint(
    paths: Sequence[str],
    root: Optional[str] = None,
    docs: Optional[Sequence[str]] = None,
    rules: Optional[Sequence[str]] = None,
    baseline: Optional[Counter] = None,
) -> LintResult:
    """Run the rule set over ``paths`` and partition the findings.

    ``rules`` restricts to a subset of rule ids; ``baseline`` consumes
    matching findings up to each accepted count.
    """
    root = os.path.abspath(root or os.getcwd())
    files = collect_files(paths, root)
    ctx = LintContext(
        root=root,
        docs_files=list(docs) if docs is not None else default_docs(root),
    )
    available = _all_rules()
    if rules:
        unknown = set(rules) - set(available)
        if unknown:
            raise ValueError(f"unknown rule(s): {', '.join(sorted(unknown))}")
        selected = {k: v for k, v in available.items() if k in set(rules)}
    else:
        selected = available

    raw: List[Finding] = []
    for sf in files:
        if sf.parse_error is not None:
            raw.append(Finding(
                "parse-error", sf.rel, sf.parse_error.lineno or 1, 0,
                f"syntax error: {sf.parse_error.msg}",
                sf.line_text(sf.parse_error.lineno or 1),
            ))
    for rule_fn in selected.values():
        raw.extend(rule_fn(files, ctx))

    by_file = {sf.rel: sf for sf in files}
    suppressed: List[Finding] = []
    remaining: List[Finding] = []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.col, f.rule)):
        sf = by_file.get(f.path)
        if sf is not None and sf.suppressed(f.rule, f.line):
            suppressed.append(f)
        else:
            remaining.append(f)

    budget = Counter(baseline or ())
    actionable: List[Finding] = []
    baselined: List[Finding] = []
    for f in remaining:
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
            baselined.append(f)
        else:
            actionable.append(f)
    return LintResult(
        findings=actionable,
        baselined=baselined,
        suppressed=suppressed,
        files=len(files),
    )
