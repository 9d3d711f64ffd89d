#!/usr/bin/env python3
"""One cell of the port's benchmark: one run, one result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository's root names the cell's
configuration (``benchmark/configs/<config>.json``) and traffic
(``benchmark/traffic/<traffic>.json``) and the metrics the cell reports
(``benchmark/metrics/<metric>.py``); ``benchmark/cells/<workload>.json``
holds the limits of its correctness check. What a run does:

1. starts the load generator (``loadgen.py``) in a process of its own,
   before this process touches the device, and hands it the traffic;
2. refuses to run (exit 2, no result) without CUDA or with fewer cards
   than the cell asks for;
3. starts the system under test (``systems/<system>.py``): the program's
   server from the seed's weights, warmed for this traffic, behind the
   engine's front on an ephemeral port -- ``setup_s`` ends here;
4. opens the window: the load generator sends the traffic on its
   schedule for ``--seconds``; with ``--trace 1`` a ``torch.profiler``
   sub-window covers its middle; the program's counters are read at the
   window's start and close and once every request has answered;
5. reads the peak device memory, stops the server and frees its state,
   and holds a sample of what the window served against the plain
   reference (``reference/<reference>.py``), at float32;
6. prints each number compared beside its limit as the last lines of
   standard error, and one JSON line as the last of standard output:
   the end-to-end metrics (``--trace 0``) or the per-layer metrics
   (``--trace 1``), ``correct``, ``attempted``, ``failed``, ``device``
   (and ``breakdown`` when traced), the checks last.

It exits non-zero with no result if JAX or the JAX package is loaded in
this process once the window has closed, or if a reader finds nothing
for a metric the cell must report.

Caches stay inside the checkout: the program's kernels build into
``build/kernels/``, and Triton's and PyTorch's extension caches are
pointed at ``build/bench-cache/``; the model directory is a few bytes
under ``TMPDIR``.
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CACHE = os.path.join(ROOT, "build", "bench-cache")
# modules whose presence after the window refuses the run: JAX and the
# JAX package, compared by whole top-level name (the port's package name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "seldon_core_tpu")
# the traced sub-window's length, at the end of the measured window, and
# how long before it the profiler is turned on (its start takes a while)
TRACE_S = 4.0
PROFILER_START_S = 4.0
# how long after the window's close a request may still answer
DRAIN_S = 60.0
# a run past this many seconds has hung (the limit of a run is 360)
WATCHDOG_S = 345


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), else since
    this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _IMPORTED


_IMPORTED = time.monotonic()


def load_json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_by_path(here: str, kind: str, name: str):
    """``<here>/<kind>/<name>.py`` (a name may hold dots)."""
    path = os.path.join(here, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} module for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` with its files and metric names."""

    def __init__(self, manifest: Dict[str, Any], workload: str, root: str = ROOT):
        self.root = root
        self.here = os.path.join(root, "benchmark")
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = cells[workload]
        self.name = workload
        conf = {c["name"]: c for c in manifest["configs"]}[self.entry["config"]]
        self.config = load_json(root, conf["file"])
        self.traffic = load_json(self.here, "traffic", f"{self.entry['traffic']}.json")
        self.limits = load_json(self.here, "cells", f"{workload}.json")
        self.chips = int(self.entry["chips"])

        def mine(m):
            return workload in m.get("workloads", [workload])

        self.end_to_end = [m["name"] for m in manifest["end_to_end"] if mine(m)]
        self.per_layer = [m["name"] for m in manifest["per_layer"] if mine(m)]
        self.units = {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]}


class LoadClient:
    """The load generator's process and its two-message protocol."""

    def __init__(self, here: str, traffic: Dict[str, Any], seed: int, seconds: float,
                 vocab: int, rate: Optional[float]):
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(here, "loadgen.py")], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, env=env)
        self._send({"traffic": traffic, "seed": int(seed), "seconds": float(seconds),
                    "vocab": int(vocab), "rate": rate, "drain_s": DRAIN_S})

    def _send(self, msg) -> None:
        self.proc.stdin.write(json.dumps(msg) + "\n")
        self.proc.stdin.flush()

    def _line(self) -> Dict[str, Any]:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the load generator ended (exit {self.proc.poll()})")
        return json.loads(line)

    def ready(self) -> int:
        return int(self._line()["requests"])

    def go(self, t0: float, port: int) -> None:
        self._send({"go": t0, "host": "127.0.0.1", "port": int(port)})

    def records(self) -> List[Dict[str, Any]]:
        out = self._line()["records"]
        self.proc.wait(30)
        return out

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(30)


class Run:
    """What the metric readers and the check see (``readings.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.5))


def device_info(device: str, chips: int) -> Dict[str, Any]:
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def run_cell(manifest: Dict[str, Any], workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", rate: Optional[float] = None, control: Optional[str] = None,
             fault: Optional[Callable[[Any], None]] = None, root: str = ROOT) -> Dict[str, Any]:
    """One run of ``workload``; returns the result dict (with ``checks``).
    ``device="cpu"`` (tests only) skips the look for a card; ``fault(system)``
    (tests only) breaks the system under test once it has started;
    ``control`` asks the check for the control's readings too (returned
    under ``info``); ``root`` is the directory holding
    ``BENCHMARK.json``'s files (tests point it at a copy)."""
    cell = Cell(manifest, workload, root)
    model = cell.config["model"]
    client = LoadClient(cell.here, cell.traffic, seed, seconds, model["vocab_size"], rate)
    system = None
    try:
        client.ready()
        import torch

        if device != "cpu":
            if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
                raise SystemExit(
                    f"the cell needs {cell.chips} CUDA device(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            torch.cuda.reset_peak_memory_stats()
        gen = load_by_path(cell.here, "generators", cell.traffic["generator"])
        plan = gen.plan(cell.traffic, seed, seconds, model["vocab_size"], rate=rate)
        system = load_by_path(cell.here, "systems", cell.config["system"]).System(
            cell.config, plan, seed, trace, device)
        if trace:
            from benchmark.subwindow import SubWindow

            window = SubWindow()
        t_start = time.monotonic()
        port = system.start()
        start_s = time.monotonic() - t_start
        if fault is not None:
            fault(system)
        setup_s = process_age_s()
        before = system.snapshot()
        t0 = time.monotonic() + 0.05
        client.go(t0, port)
        t1 = t0 + seconds
        sub = sub_before = sub_after = until = None
        if trace:
            # the trace's own cost lands at the window's end: the program's
            # counters of the per-layer metrics are read before it starts
            trace_s = min(TRACE_S, seconds / 4)
            _sleep_until(t1 - trace_s - min(PROFILER_START_S, seconds / 4))
            until = system.snapshot()
            window.start()
            sub_before = system.snapshot()
            _sleep_until(window.t0 + trace_s)
            window.edge()
            sub_after = system.snapshot()
        _sleep_until(t1)
        at_close = system.snapshot()
        records = client.records()
        after = system.snapshot()
        dev = device_info(device, cell.chips)
        system.stop()
        system = None
        if trace:
            sub = window.stop()
            sub["start_s"] = window.t0 - until["t"]
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        run = Run(records=records, plan=plan, model=model, config=cell.config, t0=t0, t1=t1,
                  seconds=float(seconds), setup_s=setup_s, before=before, at_close=at_close,
                  until=until or at_close, after=after, sub=sub, sub_before=sub_before,
                  sub_after=sub_after)
        t_check = time.monotonic()
        checks, info = check(cell, run, seed, device, control)
        info["system_start_s"] = start_s
        info["check_s"] = time.monotonic() - t_check
    finally:
        if system is not None:
            system.stop()
        client.stop()
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name in names:
        value = load_by_path(cell.here, "metrics", name).read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": cell.units[name]}
    if trace and sub is not None and sub.get("busy_s"):
        dev["busy_s"] = sub["busy_s"]
        dev["window_s"] = sub["window_s"]
    failed = sum(1 for r in records if r.get("error"))
    info.update(window_summary(run))
    if sub is not None:
        info["trace"] = {k: sub[k] for k in ("window_s", "busy_s", "start_s")}
        info["trace"].update(flash_launches=len(sub["kernels"]), device_ops=sub["device_ops"][:5],
                             idle_gaps=sub["idle_gaps"][:5])
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(records), "failed": failed, "metrics": metrics, "device": dev}
    if trace and sub is not None and sub.get("busy_s"):
        result["breakdown"] = {"device_ops": [list(x) for x in sub["device_ops"]],
                               "idle_gaps": [list(x) for x in sub["idle_gaps"]]}
    result["missing"] = [n for n in names if n not in metrics]
    result["info"] = info
    result["checks"] = checks
    return result


def _sample(records, k: int, seed: int, longest) -> List[Dict[str, Any]]:
    """``k`` answered records drawn from the seed, the longest among them."""
    import numpy as np

    if not records:
        return []
    top = max(records, key=longest)
    rest = [r for r in records if r is not top]
    rng = np.random.default_rng([int(seed), 4])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [top] + [rest[int(i)] for i in pick]


def check(cell: Cell, run: Run, seed: int, device: str, control: Optional[str]):
    """Every number compared for ``correct``, each with its limit: the
    requests that never answered (limit 0), the answers that say the
    wrong thing in form (limit 0), and the sample's distance from the
    plain reference (the cell's limit). Returns ``(checks, info)``;
    ``info`` holds what the comparison counted (positions or rows) and,
    with ``control``, the control's readings."""
    import torch

    plan, records, limits = run.plan, run.records, cell.limits
    ref = importlib.import_module(f"benchmark.reference.{cell.config['reference']}")
    model = cell.config["model"]
    # a request shed with a 429 came back refused: failed, not wrong
    checks: Dict[str, Dict[str, float]] = {
        "failed_requests": {"value": sum(1 for r in records if r.get("error")
                                         and not r.get("refused")), "limit": 0}}
    ok = [r for r in records if not r.get("error")]
    k = int(limits["sample"])
    dev = torch.device(device if device == "cpu" else "cuda")
    if plan.kind == "generate":
        bad = 0
        for r in ok:
            p = plan.prompt(r["i"])
            toks = r.get("tokens") or []
            served = sum(c for _t, c in r["spans"])
            if (toks[:len(p)] != p or len(toks) != len(p) + int(plan.max_new[r["i"]])
                    or served != int(plan.max_new[r["i"]])
                    or not all(0 <= t < model["vocab_size"] for t in toks)):
                bad += 1
        checks["malformed_answers"] = {"value": bad, "limit": 0}
        sample = [{"prompt": plan.prompt(r["i"]), "served": r["tokens"][len(plan.prompt(r["i"])):]}
                  for r in _sample(ok, k, seed, lambda r: len(r.get("tokens") or []))]
        if not sample:
            checks["sampled"] = {"value": 0, "limit": -1}
            return checks, {}
        w = ref.make_weights(model, seed, dev)
        out = ref.compare(model, w, sample, control=control)
        del w
    else:
        import numpy as np

        bad = sum(1 for r in ok if np.asarray(r["out"]).shape != (plan.n_rows,
                                                                   model["num_classes"])
                  or not np.isfinite(np.asarray(r["out"])).all())
        checks["malformed_answers"] = {"value": bad, "limit": 0}
        sample = _sample([r for r in ok if "out" in r], k, seed,
                         lambda r: int(plan.row_lens[r["i"]].sum()))
        if not sample:
            checks["sampled"] = {"value": 0, "limit": -1}
            return checks, {}
        ids = torch.tensor(np.concatenate([plan.rows(r["i"]) for r in sample]), device=dev)
        served = torch.tensor(np.concatenate([np.asarray(r["out"], np.float32)
                                              for r in sample]), device=dev)
        w = ref.make_weights(model, seed, dev)
        out = ref.compare(model, w, ids, served, control=control)
        del w
    for name, limit in limits["limits"].items():
        checks[name] = {"value": float(out[name]), "limit": float(limit)}
    return checks, {k: v for k, v in out.items() if k not in checks}


def window_summary(run: Run) -> Dict[str, Any]:
    """What the window did, for standard error: requests sent, answered,
    refused and failed, the generator's worst lateness, and for generate
    the tokens delivered and the batcher's work in the window."""
    from benchmark import stats

    recs = run.records
    out: Dict[str, Any] = {
        "sent": len(recs), "refused": sum(1 for r in recs if r.get("refused")),
        "errors": sum(1 for r in recs if r.get("error")),
        "late_ms_max": max((r["sent"] - r["due"]) * 1e3 for r in recs) if recs else 0.0}
    if run.plan.kind == "generate":
        out["tokens_in_window"] = stats.tokens_in(recs, run.t0, run.t1)
        a, b = run.before["stats"], run.at_close["stats"]
        for k in ("steps", "tokens", "admitted", "finished", "prefill_steps", "prefill_tokens",
                  "prefix_hits"):
            out[f"window_{k}"] = b[k] - a[k]
        t = [x for x in stats.ttfts_ms(recs)]
        out["ttft_p50_ms"] = stats.percentile(t, 50)
        out["tpot_p50_ms"] = stats.percentile(stats.tpots_ms(recs), 50)
    else:
        out["answered_in_window"] = len(stats.answered_in(recs, run.t0, run.t1))
        lat = stats.latencies_ms([r for r in recs if not r.get("refused")])
        out["latency_p50_ms"] = stats.percentile(lat, 50)
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None,
                    help="offered requests a second instead of the traffic file's "
                         "(a sweep for the knee; the benchmark's runs never pass it)")
    args = ap.parse_args(argv)
    # a run that has not ended by then has hung: its threads' stacks go to
    # standard error and the process exits non-zero, with no result
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    manifest = load_json(ROOT, "BENCHMARK.json")
    try:
        result = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                          rate=args.rate)
    except SystemExit as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    missing = result.pop("missing")
    for name, value in result.pop("info").items():
        print(f"read {name} {value!r}", file=sys.stderr)
    if missing:
        print(f"benchmark: nothing to read for {', '.join(missing)}; read "
              f"{json.dumps(result['metrics'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    if missing:
        return 4
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
