"""seldon-lint for the port (seldon_core_tpu_torch/analysis) against the
JAX package's analyzer, and the restored thread roles.

* The JAX analyzer's fixtures (``tests/test_seldon_lint.py``) for the
  framework-neutral rules (thread-role, blocking-under-lock, lock-order,
  metric-drift, annotation-drift, wall-clock, parse-error) and for the
  suppression and baseline semantics run through both runners: the
  port's ``(rule, line)`` findings, suppressions and baselined findings
  equal JAX's, and the JAX test's own assertions then hold for the
  port's result. A fixture's JAX device sync (``block_until_ready``)
  reaches the port spelled as its torch counterpart (``synchronize``).
* Torch fixtures for ``host-sync-hot-path`` and ``retrace-hazard`` (the
  CUDA graph capture keys), each a must-flag and a must-not-flag pair.
* The CLI (``python -m seldon_core_tpu_torch.analysis``): the gate is
  clean over the package, and the ``--write-baseline`` roundtrip.
* Under the tests' ``SELDON_DEBUG_THREADS=1`` a ``@scheduler_only``
  batcher method called from another thread while the scheduler runs
  raises ``ThreadRoleViolation``.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading

import pytest

import test_seldon_lint as jax_fixtures
from seldon_core_tpu.analysis import core as jax_core
from seldon_core_tpu_torch.analysis import core

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NEUTRAL = ("thread-role", "blocking-under-lock", "lock-order", "metric-drift",
           "annotation-drift", "wall-clock", "parse-error")
# the JAX device syncs a fixture uses, as the port's rules know them
TORCH_SPELLING = (("block_until_ready()", "synchronize()"),)

JAX_FIXTURES = [
    "test_thread_role_flags_direct_reach",
    "test_thread_role_flags_indirect_reach",
    "test_thread_role_queue_handoff_is_clean",
    "test_thread_role_scheduler_calling_entry_point_flags",
    "test_blocking_under_lock_flags_sleep",
    "test_blocking_under_lock_flags_queue_and_socket_waits",
    "test_blocking_under_lock_not_flagging_bookkeeping",
    "test_blocking_under_lock_one_level_indirection",
    "test_lock_order_flags_ab_ba_cycle",
    "test_lock_order_flags_cycle_through_call",
    "test_lock_order_flags_reacquisition",
    "test_lock_order_consistent_nesting_is_clean",
    "test_lock_order_flags_reacquisition_through_call",
    "test_metric_drift_clean_when_all_four_agree",
    "test_metric_drift_renamed_metric_not_in_docs",
    "test_metric_drift_unemitted_mapped_key",
    "test_metric_drift_tool_referencing_unknown_metric",
    "test_annotation_drift_both_directions",
    "test_annotation_drift_prefix_family",
    "test_wall_clock_flags_interval_math",
    "test_wall_clock_allows_anchors_and_monotonic",
    "test_wall_clock_flags_event_trail_dict_stamps",
    "test_suppression_same_line_and_line_above",
    "test_suppression_wrong_rule_does_not_silence",
    "test_suppression_code_on_previous_line_does_not_leak",
    "test_baseline_covers_existing_and_catches_new",
    "test_baseline_counts_are_per_occurrence",
    "test_parse_error_is_a_finding",
    "test_acceptance_device_mutation_reachable_from_submit",
    "test_acceptance_sleep_under_lock",
    "test_acceptance_renamed_metric_not_in_docs",
]


def _py_files(paths):
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for root, _d, files in os.walk(p):
                yield from (os.path.join(root, f) for f in files if f.endswith(".py"))


def _keys(findings):
    return sorted((f.rule, f.path, f.line) for f in findings)


class _BothRunners:
    """Stands in for the JAX fixtures' ``core`` module: every run goes
    through both runners, the neutral findings must agree, and the
    port's result goes back to the fixture's assertions."""

    def __init__(self):
        self.runs = 0

    def run_lint(self, paths, root=None, docs=None, rules=None, baseline=None):
        want = jax_core.run_lint(paths, root=root, docs=docs, rules=rules, baseline=baseline)
        originals = {}
        for f in _py_files(paths):
            text = open(f).read()
            spelled = text
            for old, new in TORCH_SPELLING:
                spelled = spelled.replace(old, new)
            if spelled != text:
                originals[f] = text
                open(f, "w").write(spelled)
        try:
            got = core.run_lint(paths, root=root, docs=docs, rules=rules, baseline=baseline)
        finally:
            for f, text in originals.items():
                open(f, "w").write(text)
        assert {f.rule for f in want.findings + want.suppressed + want.baselined} <= set(NEUTRAL)
        assert _keys(got.findings) == _keys(want.findings)
        assert _keys(got.suppressed) == _keys(want.suppressed)
        assert _keys(got.baselined) == _keys(want.baselined)
        assert got.files == want.files and got.exit_code == want.exit_code
        self.runs += 1
        return got

    @staticmethod
    def write_baseline(path, findings):
        core.write_baseline(path, findings)

    @staticmethod
    def load_baseline(path):
        got = core.load_baseline(path)
        assert got == jax_core.load_baseline(path)
        return got


@pytest.mark.parametrize("name", JAX_FIXTURES)
def test_jax_fixture_through_both_runners(name, tmp_path, monkeypatch):
    both = _BothRunners()
    monkeypatch.setattr(jax_fixtures, "core", both)
    getattr(jax_fixtures, name)(tmp_path)
    assert both.runs >= 1


def lint(tmp_path, source, rules):
    p = tmp_path / "mod.py"
    p.write_text(textwrap.dedent(source))
    return core.run_lint([str(p)], root=str(tmp_path), docs=[], rules=rules)


def rules_of(result):
    return [f.rule for f in result.findings]


# -- host-sync-hot-path, aimed at torch --------------------------------------


HOT_SYNCS = """
    import torch

    def scheduler_only(fn):
        return fn

    class B:
        @scheduler_only
        def _process(self, burst):
            n = self.tok.item()
            host = burst.cpu()
            rows = self.toks.tolist()
            arr = self.toks.numpy()
            moved = self.toks.to("cpu")
            torch.cuda.synchronize()
            self._done.synchronize()
            logits = self.model.decode_step_ragged_list(self.params, self.x)
            if bool(logits.isnan().any()):
                pass
            out = self._graph.replay()
            k = int(out)
            return n, host, rows, arr, moved, k
"""


def test_host_sync_flags_torch_syncs_on_the_hot_path(tmp_path):
    res = lint(tmp_path, HOT_SYNCS, rules=["host-sync-hot-path"])
    assert rules_of(res) == ["host-sync-hot-path"] * 9
    msgs = " ".join(f.message for f in res.findings)
    for what in (".item()", ".cpu()", ".tolist()", ".numpy()", '.to("cpu")',
                 "torch.cuda.synchronize()", ".synchronize()", "bool()", "int()"):
        assert what in msgs, what


def test_host_sync_not_flagging_cold_paths_metadata_or_device_moves(tmp_path):
    """The same syncs in a method no hot root reaches, shape/dtype reads
    of a forward's result, ``int()`` of a host value, ``.to(device)``
    and a suppressed designed read: nothing to flag."""
    res = lint(tmp_path, """
    import torch

    def scheduler_only(fn):
        return fn

    class B:
        def stats(self):
            return self.tok.item(), self.toks.tolist()

        @scheduler_only
        def _process(self, burst):
            logits = self.model.apply(self.params, self.x)
            rows = int(logits.shape[0])
            width = int(self.max_seq)
            moved = self.toks.to(self.device)
            cast = self.toks.to(torch.bfloat16)
            host = burst.numpy()  # seldon-lint: disable=host-sync-hot-path (the burst's one read)
            return rows, width, moved, cast, host
    """, rules=["host-sync-hot-path"])
    assert res.findings == [] and len(res.suppressed) == 1


def test_blocking_under_lock_knows_the_torch_syncs(tmp_path):
    res = lint(tmp_path, """
    import torch

    class C:
        def a(self):
            with self._lock:
                torch.cuda.synchronize()
                n = self.t.item()

        def b(self):
            with self._lock:
                self.count += 1
            torch.cuda.synchronize()  # after release: fine
    """, rules=["blocking-under-lock"])
    assert rules_of(res) == ["blocking-under-lock"] * 2


# -- retrace-hazard, aimed at CUDA graph capture keys -------------------------


def test_capture_key_hazards_flagged(tmp_path):
    res = lint(tmp_path, """
    def scheduler_only(fn):
        return fn

    class B:
        @scheduler_only
        def _burst(self, lanes, temp):
            self._phase(("step", len(lanes)), lambda: None)
            self._phase(("temp", float(temp)), lambda: None)
            self._phase(("scale", 0.5), lambda: None)
            self._graphs.run(["step", 1], lambda: None)
            self._graphs.capture(("k", {"a": 1}), lambda: None, warm_first=False)
    """, rules=["retrace-hazard"])
    assert rules_of(res) == ["retrace-hazard"] * 5
    assert "len(...)" in res.findings[0].message


def test_capture_key_bucketized_values_not_flagged(tmp_path):
    """Bucketized sizes, bools and names in a key, a key variable, other
    ``run`` calls and a cold method: nothing to flag."""
    res = lint(tmp_path, """
    def scheduler_only(fn):
        return fn

    class B:
        @scheduler_only
        def _burst(self, lanes, masked):
            gb = self._group_size_bucket(len(lanes))
            self._phase(("gather", masked, gb, self._attn_bucket), lambda: None)
            key = ("begin", masked)
            self._phase(key, lambda: None)
            self.executor.run(len(lanes))

        def warm(self, lanes):
            self._phase(("warm", len(lanes)), lambda: None)
    """, rules=["retrace-hazard"])
    assert res.findings == []


# -- the CLI and the gate ------------------------------------------------------


def _cli(*args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "seldon_core_tpu_torch.analysis", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_port_gate_is_clean():
    """``python -m seldon_core_tpu_torch.analysis seldon_core_tpu_torch``
    exits 0 with its checked-in baseline, and the baseline holds only
    the docs' TPU annotations (the port renders their GPU
    counterparts)."""
    proc = _cli("seldon_core_tpu_torch")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s)" in proc.stderr
    data = json.load(open(os.path.join(REPO, "seldon_core_tpu_torch", "analysis",
                                       "baseline.json")))
    assert {(e["rule"], e["path"]) for e in data["findings"]} == {
        ("annotation-drift", "docs/operate.md")}


def test_cli_write_baseline_roundtrip(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("import time\nT = time.time()\n")
    bl = tmp_path / "bl.json"
    argv = ["--root", str(tmp_path), "--baseline", str(bl), "--rules", "wall-clock", str(mod)]
    assert _cli(*argv).returncode == 1  # a finding, no baseline yet
    assert _cli(*argv, "--write-baseline").returncode == 0
    data = json.loads(bl.read_text())
    assert data["findings"] and data["findings"][0]["rule"] == "wall-clock"
    assert _cli(*argv).returncode == 0  # baselined now
    assert _cli("--rules", "nope", str(mod)).returncode == 2
    assert "host-sync-hot-path" in _cli("--list-rules").stdout


# -- restored thread roles -----------------------------------------------------


def test_roles_restored_on_the_jax_packages_methods():
    """Every method the JAX package marks has its role on the port's
    counterpart (``_admit`` is the port's ``_admit_wave``/``_admit_one``/
    ``_admit_hit``; ``_process_fused_burst`` folds into
    ``_process_burst``; the port has no ``_rebuild``, ``_emit_span``,
    ``_draft_admit`` or ``_prefix_match_tokens`` of its own)."""
    import ast

    def roles(path):
        out = {}
        for c in ast.walk(ast.parse(open(path).read())):
            if isinstance(c, ast.ClassDef):
                for f in c.body:
                    if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        names = {getattr(d, "id", getattr(d, "attr", None))
                                 for d in f.decorator_list}
                        role = ("scheduler" if "scheduler_only" in names else
                                "caller" if "caller_thread" in names else None)
                        out[(c.name, f.name)] = role
        return out

    folded = {"_rebuild", "_emit_span", "_draft_admit", "_prefix_match_tokens", "_admit",
              "_process_fused_burst"}
    counted = 0
    for rel in ("serving/continuous.py", "servers/generateserver.py",
                "serving/weightpager.py"):
        want = roles(os.path.join(REPO, "seldon_core_tpu", rel))
        got = roles(os.path.join(REPO, "seldon_core_tpu_torch", rel))
        for key, role in want.items():
            if role is None or key[1] in folded:
                continue
            assert got.get(key) == role, (rel, key)
            counted += 1
    assert counted == 73
    got = roles(os.path.join(REPO, "seldon_core_tpu_torch", "serving", "continuous.py"))
    for name in ("_admit_wave", "_admit_one", "_admit_hit"):
        assert got[("ContinuousBatcher", name)] == "scheduler"


def test_scheduler_only_method_from_a_caller_thread_raises():
    """The tests' environment arms the runtime role assertions: while a
    batcher's scheduler thread runs, a ``@scheduler_only`` method called
    from this thread raises before it touches any state, and a
    ``@caller_thread`` entry point serves from here as usual."""
    from seldon_core_tpu_torch.analysis import ThreadRoleViolation, debug_threads_enabled
    from seldon_core_tpu_torch.models.llm import DecoderLM
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    assert debug_threads_enabled()
    model = DecoderLM(vocab_size=64, d_model=32, n_layers=1, n_heads=4, n_kv_heads=2,
                      d_ff=32, max_seq=32, dtype="float32")
    params = model.init_params(0, device="cpu")
    b = ContinuousBatcher(model, params, slots=2, max_seq=32, prefill_buckets=(8, 16))
    try:
        b.start()
        assert b._thread is not threading.current_thread() and b._thread.is_alive()
        with pytest.raises(ThreadRoleViolation, match="scheduler_only"):
            b._admit_wave([])
        with pytest.raises(ThreadRoleViolation, match="scheduler_only"):
            b._pressure_poll()
        assert len(b.generate([1, 2, 3], max_new_tokens=3)) == 6  # prompt + 3
    finally:
        b.close()
