"""The whole harness driven on the CPU at tiny sizes: sound runs come out
correct, runs with the timed path broken underneath come out not
correct, and a cell, a traffic mix and a metric added as new files are
found by name. The look for a card is skipped (``device="cpu"``);
everything else is a run: the load generator's process, the engine's
fronts, the program's servers, the readers, the reference."""

import json
import os

import pytest
import torch

import bench_cells
from benchmark import run as harness

SEED = 2**31 + 4242


def drive(tmp_path, cell, fault=None, trace=False, seconds=2.5, extra=None):
    root, manifest = bench_cells.tiny_root(tmp_path, cells=[cell])
    if extra:
        extra(root, manifest)
    return harness.run_cell(manifest, cell, SEED, seconds, trace, device="cpu", root=root,
                            fault=fault)


@pytest.mark.parametrize("cell", ["tiny.chat", "tiny.shared", "tiny.docs"])
def test_a_sound_run_is_correct(tmp_path, cell):
    res = drive(tmp_path, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert not res["missing"]
    assert set(res["metrics"]) == set(bench_cells.METRICS[cell][0])
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"


def test_a_traced_run_reports_the_layers(tmp_path):
    res = drive(tmp_path, "tiny.shared", trace=True)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(bench_cells.METRICS["tiny.shared"][1])
    # every request after the documents were primed hits its document
    assert res["metrics"]["prefix_hit_share"]["value"] > 50.0


def _token_altered(system):
    """Each decode step's logits rolled by one: every token after the
    first is another than the model's greedy choice."""
    model = system.server.batcher.model
    orig = model._decode_head
    model._decode_head = lambda params, x: orig(params, x).roll(1, dims=-1)


def _state_unchanged(system):
    """Each decode step leaves the cache as it found it: the K/V of the
    position it decodes are never written."""
    model = system.server.batcher.model
    orig = model._decode_layer

    def layer(p, x, pos, ck, cv, attn_len, write_pos):
        return orig(p, x, pos, ck, cv, attn_len, torch.full_like(write_pos, ck.shape[2]))

    model._decode_layer = layer


def _answer_altered(system):
    orig = system.server._apply

    def apply(params, x):
        out = orig(params, x).clone()
        out[0, 0] += 1.0
        return out

    system.server._apply = apply


def _half_batch(system):
    """Half of the batch left out, the mean of the rest in its place."""
    orig = system.server._apply

    def apply(params, x):
        half = max(1, x.shape[0] // 2)
        out = orig(params, x[:half])
        return torch.cat([out, out.mean(0, keepdim=True).expand(x.shape[0] - half, -1)])

    system.server._apply = apply


@pytest.mark.parametrize("cell,fault", [
    ("tiny.chat", _token_altered),
    ("tiny.chat", _state_unchanged),
    ("tiny.docs", _answer_altered),
    ("tiny.docs", _half_batch),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault):
    res = drive(tmp_path, cell, fault=fault)
    assert not res["correct"], res["checks"]


def test_new_cell_traffic_and_metric_are_found_as_files(tmp_path):
    """What a later PR does: add a traffic mix, a cell and a metric as new
    files and name them in BENCHMARK.json; the harness edits nothing."""

    def extra(root, manifest):
        here = os.path.join(root, "benchmark")
        with open(os.path.join(here, "traffic", "tiny-burst.json"), "w") as f:
            json.dump(dict(bench_cells.TRAFFIC["tiny-chat"], arrivals="uniform",
                           rate_per_s=4.0), f)
        with open(os.path.join(here, "cells", "tiny.burst.json"), "w") as f:
            json.dump({"sample": 2, "limits": {"logit_gap": 1e-3}}, f)
        with open(os.path.join(here, "metrics", "requests_answered.py"), "w") as f:
            f.write("def read(run):\n"
                    "    return sum(1 for r in run.records if not r.get('error'))\n")
        manifest["workloads"].append({"name": "tiny.burst", "config": "tiny-llm",
                                      "traffic": "tiny-burst", "chips": 1, "why": "added"})
        for m in manifest["end_to_end"]:
            if m["name"] in ("ttft_p90_ms", "setup_s"):
                m["workloads"].append("tiny.burst")
        manifest["per_layer"].append({
            "name": "requests_answered", "unit": "requests", "better": "higher",
            "source": "host_clock", "layer": "served path", "moves": "ttft_p90_ms",
            "workloads": ["tiny.burst"]})

    root, manifest = bench_cells.tiny_root(tmp_path, cells=["tiny.chat"])
    extra(root, manifest)
    res = harness.run_cell(manifest, "tiny.burst", SEED, 2.0, True, device="cpu", root=root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["requests_answered"]["value"] == res["attempted"] == 8
    res = harness.run_cell(manifest, "tiny.burst", SEED, 2.0, False, device="cpu", root=root)
    assert set(res["metrics"]) == {"ttft_p90_ms", "setup_s"}


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    """Only BENCHMARK.json and benchmark/: the run fails before a result."""
    import shutil
    import subprocess
    import sys

    shutil.copytree(os.path.join(bench_cells.ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(os.path.join(bench_cells.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mistral7b.chat",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and not p.stdout.strip()
