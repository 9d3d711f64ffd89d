"""Tiny cells for driving the harness on the CPU.

:func:`tiny_root` copies ``benchmark/`` into a temporary directory and
adds, as files, tiny configurations (the same families as the real
cells, float32 so the program and the reference agree to rounding),
tiny traffic mixes and their cells, and a ``BENCHMARK.json`` naming them
beside every metric of the real one: what a later PR does to add a
cell, here on a copy.
"""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_LLM = {"vocab_size": 256, "d_model": 32, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
            "d_ff": 64, "max_seq": 256, "rope_theta": 10000.0, "norm_eps": 1e-5,
            "dtype": "float32"}
TINY_BERT = {"vocab_size": 128, "d_model": 32, "n_layers": 2, "n_heads": 2, "d_ff": 64,
             "max_seq": 64, "type_vocab": 2, "num_classes": 2, "layer_norm_eps": 1e-12,
             "dtype": "float32"}

CONFIGS = {
    "tiny-llm": {"name": "tiny-llm", "source": "tests", "family": "llm",
                 "system": "generate_engine", "reference": "decoder", "model": TINY_LLM,
                 "server": {"slots": 4, "max_seq": 256, "steps_per_poll": 4, "pipeline_depth": 2,
                            "prefix_cache_hbm_bytes": 1 << 24}},
    "tiny-bert": {"name": "tiny-bert", "source": "tests", "family": "bert",
                  "system": "predict_engine", "reference": "bert_encoder", "model": TINY_BERT,
                  "server": {"annotations": {"seldon.io/microbatch": "true",
                                             "seldon.io/microbatch-max-batch": "16",
                                             "seldon.io/microbatch-timeout-ms": "10"}}},
}

TRAFFIC = {
    "tiny-chat": {"generator": "requests", "client": "sse_generate", "kind": "generate",
                  "rate_per_s": 6.0, "arrivals": "poisson",
                  "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.6, "min": 4,
                             "max": 60},
                  "output": {"dist": "uniform", "min": 4, "max": 12}, "temperature": 0.0},
    "tiny-shared": {"generator": "requests", "client": "sse_generate", "kind": "generate",
                    "rate_per_s": 6.0, "arrivals": "poisson",
                    "shared": {"documents": 3, "doc_len": 40, "zipf_s": 1.1,
                               "suffix": {"dist": "uniform", "min": 4, "max": 20}},
                    "output": {"dist": "uniform", "min": 4, "max": 12}, "temperature": 0.0},
    "tiny-docs": {"generator": "requests", "client": "grpc_predict", "kind": "predict",
                  "encoding": "raw", "rate_per_s": 20.0, "arrivals": "poisson", "rows": 4,
                  "row_len": {"dist": "uniform", "min": 4, "max": 64}, "pad_to": 64},
}

CELLS = {
    "tiny.chat": ("tiny-llm", "tiny-chat", {"sample": 3, "limits": {"logit_gap": 1e-3}}),
    "tiny.shared": ("tiny-llm", "tiny-shared", {"sample": 3, "limits": {"logit_gap": 1e-3}}),
    "tiny.docs": ("tiny-bert", "tiny-docs", {"sample": 4, "limits": {"logit_err": 1e-4}}),
}

METRICS = {
    "tiny.chat": (["ttft_p90_ms", "tpot_p90_ms", "setup_s"],
                  ["queue_wait_p50_ms", "prefix_hit_share", "lanes_per_step"]),
    "tiny.shared": (["ttft_p90_ms", "tpot_p90_ms", "setup_s"],
                    ["queue_wait_p50_ms", "prefix_hit_share", "lanes_per_step"]),
    "tiny.docs": (["predict_rows_per_s", "setup_s"], ["answered_p95_ms", "rows_per_flush", "refused_pct"]),
}


# the predict path's metrics, which no cell of BENCHMARK.json reports yet
PREDICT_METRICS = [
    {"name": "predict_rows_per_s", "unit": "rows/s", "better": "higher", "bound": 0.25,
     "source": "host_clock"},
    {"name": "refused_pct", "unit": "%", "better": "lower", "source": "host_clock",
     "layer": "served path", "moves": "predict_rows_per_s"},
    {"name": "answered_p95_ms", "unit": "ms", "better": "lower", "source": "host_clock",
     "layer": "served path", "moves": "predict_rows_per_s"},
    {"name": "rows_per_flush", "unit": "rows", "better": "higher", "source": "program_counter",
     "layer": "micro-batcher", "moves": "predict_rows_per_s"},
]


def load_manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_root(tmp_path, cells=tuple(CELLS)):
    """A copy of the benchmark with the tiny cells added as files; returns
    ``(root, manifest)``."""
    root = str(tmp_path)
    here = os.path.join(root, "benchmark")
    shutil.copytree(os.path.join(ROOT, "benchmark"), here,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, cfg in CONFIGS.items():
        with open(os.path.join(here, "configs", f"{name}.json"), "w") as f:
            json.dump(cfg, f)
    for name, tr in TRAFFIC.items():
        with open(os.path.join(here, "traffic", f"{name}.json"), "w") as f:
            json.dump(tr, f)
    manifest = load_manifest()
    workloads, e2e, per = [], {}, {}
    for cell in cells:
        conf, traffic, limits = CELLS[cell]
        with open(os.path.join(here, "cells", f"{cell}.json"), "w") as f:
            json.dump(limits, f)
        workloads.append({"name": cell, "config": conf, "traffic": traffic, "chips": 1,
                          "why": "a tiny cell of the tests"})
        for name in METRICS[cell][0]:
            e2e.setdefault(name, []).append(cell)
        for name in METRICS[cell][1]:
            per.setdefault(name, []).append(cell)
    units = {m["name"]: m
             for m in manifest["end_to_end"] + manifest["per_layer"] + PREDICT_METRICS}
    tiny = {
        "command": manifest["command"], "paths": manifest["paths"],
        "run_seconds": manifest["run_seconds"],
        "configs": [{"name": n, "source": "tests", "file": f"benchmark/configs/{n}.json",
                     "reduced": [], "why": "tiny"} for n in CONFIGS],
        "workloads": workloads,
        "end_to_end": [dict(units[n], workloads=c) for n, c in e2e.items()],
        "per_layer": [dict(units[n], workloads=c) for n, c in per.items()],
    }
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(tiny, f)
    return root, tiny
