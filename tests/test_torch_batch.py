"""The port's streaming batch scorer (seldon_core_tpu_torch/batch.py) held
against the JAX package's on the CPU.

Counterpart of tests/test_batch.py: the same records and fused requests
from the same streams; both packages' scorers, pointed at the same port
microservice, write the same output file byte for byte (JSONL and CSV
in, ``--batch-rows`` fusion, JSON and binary protobuf bodies, parse
errors and a dead target recorded per record); against the port's engine
the output keeps input order; a slow stream is scored before it ends."""

import asyncio
import io
import json

import numpy as np
import pytest

from _torch_tools import JAX, PKGS, PORT, m, serve_engine, serve_microservice


def batch(pkg):
    return m(pkg, "batch")


class Scale:
    """Each row times 2, with its row sum appended: rows stay tellable."""

    def predict(self, X, names, meta=None):
        X = np.asarray(X, dtype=float)
        return np.concatenate([2 * X, X.sum(axis=1, keepdims=True)], axis=1)


@pytest.fixture(scope="module")
def micro():
    rest, _g, stop = serve_microservice(Scale(), grpc=False)
    yield rest
    stop()


@pytest.fixture(scope="module")
def engine_port():
    _app, port, _g, stop = serve_engine({"name": "m", "implementation": "SIMPLE_MODEL"})
    yield port
    stop()


JSONL = ('{"data":{"ndarray":[[1,2]]}}\n[3,4]\n\n'
         '{"data":{"names":["a","b"],"ndarray":[[5,6]]}}\n'
         '{"data":{"names":["a","b"],"ndarray":[[7,8]]}}\n'
         '{"strData":"x"}\n{"broken json\n[9,10]\n')
CSV = "1.5,2.5\n3.5,4.5\n\nx,1\n5,6\n"


@pytest.mark.parametrize("text,fmt", [(JSONL, "jsonl"), (CSV, "csv")])
def test_read_records_equals_jax(text, fmt):
    got = [list(batch(pkg).read_records(io.StringIO(text), fmt)) for pkg in PKGS]
    assert got[1] == got[0]


@pytest.mark.parametrize("batch_rows", [1, 2, 3, 8])
def test_fuse_rows_equals_jax(batch_rows):
    recs = list(batch(JAX).read_records(io.StringIO(JSONL), "jsonl"))
    got = [list(batch(pkg).fuse_rows(iter(recs), batch_rows)) for pkg in PKGS]
    assert got[1] == got[0]


def test_fuse_rows_respects_names_boundaries():
    recs = [{"data": {"names": ["a"], "ndarray": [[1]]}},
            {"data": {"names": ["a"], "ndarray": [[2]]}},
            {"data": {"names": ["b"], "ndarray": [[3]]}}]
    fused = list(batch(PORT).fuse_rows(iter(recs), batch_rows=4))
    assert fused[0]["message"]["data"] == {"ndarray": [[1], [2]], "names": ["a"]}
    assert fused[1]["message"]["data"] == {"ndarray": [[3]], "names": ["b"]}


def _split(pkg, *args):
    return batch(pkg).BatchScorer._split_records(*args)


@pytest.mark.parametrize("count,out", [
    (1, {"data": {"ndarray": [[1]]}}),
    (2, {"data": {"names": ["y"], "ndarray": [[1], [2]]}, "meta": {"tags": {"t": 1}}}),
    (3, {"data": {"ndarray": [[1], [2]]}}),
    (2, {"jsonData": {"x": 1}}),
])
def test_split_records_equals_jax(count, out):
    assert _split(PORT, 4, count, out) == _split(JAX, 4, count, out)


def _cli(pkg, tmp_path, target, text, fmt, *extra):
    src = tmp_path / f"in.{fmt}"
    src.write_text(text)
    dst = tmp_path / f"out-{pkg}-{fmt}-{'-'.join(extra)}.jsonl"
    batch(pkg).main([target, "--input", str(src), "--output", str(dst), "--format", fmt,
                     "--path", "/predict", *extra])
    return dst.read_bytes()


@pytest.mark.parametrize("fmt,extra", [
    ("jsonl", ()),
    ("jsonl", ("--batch-rows", "2", "--concurrency", "3")),
    ("jsonl", ("--batch-rows", "4", "--binary")),
    ("csv", ("--batch-rows", "3", "--concurrency", "16")),
])
def test_output_file_byte_for_byte_equal_jax(micro, tmp_path, fmt, extra):
    text = JSONL if fmt == "jsonl" else CSV
    want = _cli(JAX, tmp_path, f"http://{micro}", text, fmt, *extra)
    got = _cli(PORT, tmp_path, f"http://{micro}", text, fmt, *extra)
    assert got == want
    lines = [json.loads(x) for x in got.decode().splitlines()]
    assert [r["index"] for r in lines] == list(range(len(lines)))
    # jsonl: the broken line and the strData record (Scale takes arrays);
    # csv: the row "x,1"
    assert sum("error" in r for r in lines) == (2 if fmt == "jsonl" else 1)


def test_rows_fused_equal_rows_alone_in_order(micro, tmp_path):
    rows = np.random.RandomState(0).uniform(-3, 3, (29, 4)).round(3)
    text = "\n".join(json.dumps(r) for r in rows.tolist())
    alone = _cli(PORT, tmp_path, f"http://{micro}", text, "jsonl", "--concurrency", "1")
    fused = _cli(PORT, tmp_path, f"http://{micro}", text, "jsonl", "--batch-rows", "8",
                 "--concurrency", "16")
    assert fused == alone
    out = [json.loads(x) for x in fused.decode().splitlines()]
    for i, rec in enumerate(out):
        np.testing.assert_allclose(rec["response"]["data"]["ndarray"][0],
                                   np.concatenate([2 * rows[i], [rows[i].sum()]]))


def run_batch(pkg, port, lines, **kw):
    batch_rows = kw.pop("batch_rows", 1)
    scorer = batch(pkg).BatchScorer(f"http://127.0.0.1:{port}", **kw)
    out = io.StringIO()
    stats = asyncio.run(scorer.run(
        batch(pkg).fuse_rows(batch(pkg).read_records(io.StringIO(lines), "jsonl"), batch_rows),
        out))
    return stats, [json.loads(x) for x in out.getvalue().splitlines()]


@pytest.mark.parametrize("batch_rows,requests", [(1, 25), (4, 7)])
def test_engine_scoring_ordered_and_equal_jax(engine_port, batch_rows, requests):
    lines = "\n".join(f"[{i}.0, 1.0]" for i in range(25))
    got = {pkg: run_batch(pkg, engine_port, lines, concurrency=8, batch_rows=batch_rows)
           for pkg in PKGS}
    assert got[PORT][0] == got[JAX][0] == {"requests": requests, "rows": 25, "failures": 0}
    for pkg in PKGS:
        results = got[pkg][1]
        assert [r["index"] for r in results] == list(range(25))
        for r in results:
            assert r["response"]["data"]["ndarray"] == [[0.9, 0.05, 0.05]]


def test_dead_target_records_every_failure():
    got = []
    for pkg in PKGS:
        scorer = batch(pkg).BatchScorer("http://127.0.0.1:1", concurrency=2, timeout_s=0.3)
        out = io.StringIO()
        stats = asyncio.run(scorer.run(batch(pkg).fuse_rows(
            batch(pkg).read_records(io.StringIO("[1.0]\n[2.0]\n[3.0]"), "jsonl"), 2), out))
        results = [json.loads(x) for x in out.getvalue().splitlines()]
        got.append((stats, [r["index"] for r in results], [sorted(r) for r in results]))
    assert got[1] == got[0]
    assert got[1][0]["failures"] == 2 and got[1][1] == [0, 1, 2]


def test_streaming_input_pipelines_before_eof(engine_port):
    """Records arriving slowly still get scored while the stream is open."""
    import queue as q

    feed: "q.Queue" = q.Queue()

    def records():
        while True:
            item = feed.get()
            if item is None:
                return
            yield {"data": {"ndarray": [item]}}

    out = io.StringIO()
    scorer = batch(PORT).BatchScorer(f"http://127.0.0.1:{engine_port}", concurrency=2)

    async def go():
        task = asyncio.ensure_future(scorer.run(batch(PORT).fuse_rows(records(), 1), out))
        feed.put([1.0])
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 10
        while not out.getvalue() and loop.time() < deadline:
            await asyncio.sleep(0.05)
        assert out.getvalue(), "no result written while stream open"
        feed.put([2.0])
        feed.put(None)
        return await task

    stats = asyncio.run(go())
    assert stats["requests"] == 2 and stats["failures"] == 0
