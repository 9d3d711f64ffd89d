"""The port's load tester (seldon_core_tpu_torch/loadtester.py) held
against the JAX package's on the CPU, driving the port's engine.

Counterpart of tests/test_loadtester.py: the same payloads from the same
arguments, the same aggregation and table from the same latencies, and
load over REST (JSON and binary protobuf) and gRPC against the port's
engine with no failure; failures counted against a dead target; the
command line in a process of its own, as it runs beside a process that
holds the card."""

import json
import os
import subprocess
import sys

import pytest

from _torch_tools import JAX, PKGS, PORT, m, serve_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lt(pkg):
    return m(pkg, "loadtester")


@pytest.fixture(scope="module")
def engine():
    _app, port, gport, stop = serve_engine(
        {"name": "m", "implementation": "SIMPLE_MODEL"}, grpc=True)
    yield port, gport
    stop()


def test_percentiles_equal_jax():
    assert lt(PORT).PERCENTILES == lt(JAX).PERCENTILES


@pytest.mark.parametrize("args", [
    {"ndarray": "[[1.0, 2.0]]"},
    {},
    {"ndarray": '[["a", 1]]'},
])
def test_build_payload_fixed_equals_jax(args):
    assert lt(PORT).build_payload(dict(args)) == lt(JAX).build_payload(dict(args))


def test_build_payload_from_contract_matches_jax_shape(tmp_path):
    contract = {"features": [{"name": "f", "ftype": "continuous", "range": [0, 1],
                              "repeat": 3}], "targets": []}
    path = tmp_path / "contract.json"
    path.write_text(json.dumps(contract))
    got = [lt(pkg).build_payload({"contract": str(path), "batch": 4}) for pkg in PKGS]
    for body in got:
        assert len(body["data"]["ndarray"]) == 4
        assert all(0 <= v <= 1 for row in body["data"]["ndarray"] for v in row)
    assert got[1]["data"]["names"] == got[0]["data"]["names"] == ["f1", "f2", "f3"]


def test_build_payload_from_body_file(tmp_path):
    body = {"data": {"raw": {"dtype": "uint8", "shape": [1, 2], "data": "AAE="}},
            "meta": {"tags": {"k": "v"}}}
    path = tmp_path / "body.json"
    path.write_text(json.dumps(body))
    assert lt(PORT).build_payload({"body_file": str(path), "ndarray": "[[9]]"}) == body


@pytest.mark.parametrize("latencies,fails,elapsed", [
    ([0.01, 0.02, 0.03], 1, 1.0),
    ([0.5], 0, 2.0),
    ([], 3, 0.5),
    ([0.001 * i for i in range(1, 101)], 0, 1.7),
])
def test_aggregate_and_table_equal_jax(latencies, fails, elapsed):
    stats = [lt(pkg).aggregate([(list(latencies), fails)], elapsed=elapsed, name="predict")
             for pkg in PKGS]
    assert stats[1] == stats[0]
    assert lt(PORT).format_table(stats[1]) == lt(JAX).format_table(stats[0])
    lines = lt(PORT).format_table(stats[1]).splitlines()
    assert "# reqs" in lines[0] and "p99%" in lines[2]


@pytest.mark.parametrize("binary", [False, True])
def test_load_against_port_engine(engine, binary):
    port, _ = engine
    stats = lt(PORT).run_load(f"http://127.0.0.1:{port}", workers=2, clients_per_worker=2,
                              seconds=1.0, ndarray="[[1.0, 2.0]]", binary=binary)
    assert stats["requests"] > 0 and stats["failures"] == 0
    assert stats["rps"] > 0 and stats["p99_ms"] >= stats["p50_ms"]
    assert set(stats) == set(lt(JAX).aggregate([([0.1], 0)], 1.0, "predict"))


def test_failures_counted_against_dead_target():
    stats = lt(PORT).run_load("http://127.0.0.1:1", workers=1, clients_per_worker=2,
                              seconds=0.5, timeout=0.3)
    assert stats["requests"] == 0 and stats["failures"] > 0


def _cli(argv):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "seldon_core_tpu_torch.loadtester", *argv],
                          capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_grpc_load_in_a_process_of_its_own(engine):
    """gRPC load forks its workers before any channel exists: from a
    process of its own (a process that already runs gRPC cannot fork
    working gRPC clients)."""
    _, gport = engine
    stats = json.loads(_cli([f"127.0.0.1:{gport}", "--transport", "grpc", "--workers", "2",
                             "--clients-per-worker", "2", "--seconds", "0.7",
                             "--ndarray", "[[1.0, 2.0]]", "--json"]).strip().splitlines()[-1])
    assert stats["requests"] > 0 and stats["failures"] == 0


def test_cli_in_a_process_of_its_own(engine, tmp_path):
    port, _ = engine
    body = tmp_path / "body.json"
    body.write_text(json.dumps({"data": {"ndarray": [[1.0, 2.0]]}}))
    out = {}
    for flag in ("--json", None):
        argv = [f"http://127.0.0.1:{port}", "--workers", "1", "--clients-per-worker", "2",
                "--seconds", "0.7", "--binary", "--body-file", str(body)]
        if flag:
            argv.append(flag)
        out[flag] = _cli(argv)
    stats = json.loads(out["--json"].strip().splitlines()[-1])
    assert stats["requests"] > 0 and stats["failures"] == 0
    table = out[None].splitlines()
    assert "req/s" in table[0] and table[1].split()[2] == "0"
