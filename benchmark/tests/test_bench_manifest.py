"""``BENCHMARK.json`` against its contract, and every file it names found
by name."""

import json
import os
import re
import statistics  # noqa: F401  (the spread rule's quartiles come from it)

import pytest

from bench_cells import load_manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}

M = load_manifest()


def test_top_level_keys_and_sizes():
    assert set(M) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)


def test_a_full_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for m in M["end_to_end"] + M["per_layer"]:
        extra = {"bound"} if m in M["end_to_end"] else {"layer", "moves"}
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source"} | extra
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_pairs_of_config_and_traffic_appear_once():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in M["end_to_end"])


def reported(metric, cell):
    return cell in metric.get("workloads", [w["name"] for w in M["workloads"]])


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in M["end_to_end"] if reported(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reported(m, cell) for m in M["per_layer"])


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"]])
def test_each_layer_metric_moves_what_its_cells_report(metric):
    m = next(x for x in M["per_layer"] if x["name"] == metric)
    target = next(x for x in M["end_to_end"] if x["name"] == m["moves"])
    cells = m.get("workloads", [w["name"] for w in M["workloads"]])
    assert all(reported(target, c) for c in cells)
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert 1 <= len(m["layer"]) <= 200


def test_metrics_of_one_layer_spell_it_alike():
    layers = {m["layer"] for m in M["per_layer"]}
    assert {x.lower() for x in layers} == layers  # one spelling per layer
    roof = [m for m in M["per_layer"] if "roofline" in m["name"]]
    for r in roof:
        assert r["unit"] == "%"
        mfu = [m for m in M["per_layer"] if "mfu" in m["name"] and m["moves"] == r["moves"]]
        assert mfu and set(r["workloads"]) <= set(mfu[0]["workloads"])


def test_at_most_a_quarter_of_the_cells_on_four_chips():
    four = sum(1 for w in M["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_file_is_found_by_name(cell):
    w = next(x for x in M["workloads"] if x["name"] == cell)
    conf = next(c for c in M["configs"] if c["name"] == w["config"])
    assert conf["file"].startswith("benchmark/")
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == conf["name"] and cfg["source"] == conf["source"]
    assert sorted(cfg["reduced"]) == sorted(conf["reduced"])
    for kind, name in (("systems", cfg["system"]), ("reference", cfg["reference"])):
        assert os.path.isfile(os.path.join(HERE, kind, f"{name}.py"))
    with open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")) as f:
        tr = json.load(f)
    assert os.path.isfile(os.path.join(HERE, "generators", f"{tr['generator']}.py"))
    assert os.path.isfile(os.path.join(HERE, "clients", f"{tr['client']}.py"))
    with open(os.path.join(HERE, "cells", f"{cell}.json")) as f:
        limits = json.load(f)
    assert limits["sample"] >= 1 and limits["limits"]
    for m in M["end_to_end"] + M["per_layer"]:
        if reported(m, cell):
            assert os.path.isfile(os.path.join(HERE, "metrics", f"{m['name']}.py")), m["name"]


def test_configs_state_no_cut_width():
    widths = re.compile(r"(hidden|intermediate|latent|state|projection)|_dim$|_rank$|head|"
                        r"expansion|experts_per_tok")
    for c in M["configs"]:
        assert not [k for k in c["reduced"] if widths.search(k)], c["name"]
