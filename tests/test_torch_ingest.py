"""The port's ingest tier (``seldon_core_tpu_torch/ingest.py``): the JAX
package's own cases (``tests/test_ingest.py``, and
``tests/test_kafka_broker.py`` on its stub cluster) through the port's
engine, then the port against the JAX package: byte-identical queue
files, a queue either package wrote drained by the other's consumer,
and generate results through the port's engine over a CPU
GenerateServer equal to the JAX GenerateServer's, each request alone.

The JAX package's native-engine case waits for the port's operator side
(``ROADMAP.md`` §A.6)."""

import asyncio
import json
import os
import threading
import time

import pytest

from _net import free_port, serve_on_thread
from _torch_engine import GEN_PARAMS, build_app, gen_unit, make_model_dir
from tests.test_kafka_broker import FakeCluster, make_client_classes

import seldon_core_tpu.ingest as jax_ingest
import seldon_core_tpu_torch.ingest as ingest
from seldon_core_tpu_torch.graph.service import EngineApp
from seldon_core_tpu_torch.graph.spec import PredictorSpec, default_predictor
from seldon_core_tpu_torch.ingest import (
    FileQueue,
    IngestConsumer,
    KafkaBroker,
    read_results,
)

SIMPLE = {"name": "m", "implementation": "SIMPLE_MODEL"}


def records(n):
    return [{"id": f"r{i}", "data": [[float(i), 1.0]]} for i in range(n)]


def _serve(app):
    port = free_port()
    return port, serve_on_thread(app.rest_app().serve_forever("127.0.0.1", port), port)


@pytest.fixture
def engine_port():
    spec = default_predictor(PredictorSpec.from_dict({"name": "ing", "graph": SIMPLE}))
    port, stop = _serve(EngineApp(spec))
    yield port
    stop()


# -- the JAX package's cases (tests/test_ingest.py) --------------------------


def test_file_queue_roundtrip_and_rotation(tmp_path, monkeypatch):
    monkeypatch.setattr(ingest, "SEGMENT_MAX_RECORDS", 5)
    q = FileQueue(str(tmp_path / "q"))
    offs = [q.append({"id": f"r{i}"}) for i in range(12)]
    assert offs == list(range(12))
    assert q.end_offset() == 12
    assert len(q._segments()) >= 2
    got = q.poll(0, 100)
    assert [o for o, _ in got] == list(range(12))
    got = q.poll(4, 3)
    assert [o for o, _ in got] == [4, 5, 6]
    q.commit("g1", 7)
    assert q.committed("g1") == 7
    assert q.committed("g2") == 0
    q2 = FileQueue(str(tmp_path / "q"))
    assert q2.committed("g1") == 7
    assert q2.end_offset() == 12


def test_torn_tail_record_is_ignored(tmp_path):
    q = FileQueue(str(tmp_path / "q"))
    q.append({"id": "ok"})
    with open(q._segment_path(0), "a") as f:
        f.write('{"id": "to')
    got = q.poll(0, 10)
    assert [r["id"] for _, r in got] == ["ok"]


def test_drain_scores_everything_exactly_once_observable(tmp_path, engine_port):
    q = FileQueue(str(tmp_path / "q"))
    for r in records(25):
        q.append(r)
    out = str(tmp_path / "results.jsonl")
    consumer = IngestConsumer(q, "127.0.0.1", engine_port, out_path=out, concurrency=4)
    stats = asyncio.run(consumer.run(drain=True))
    assert stats["scored"] == 25
    assert stats["dead_lettered"] == 0
    results = read_results(out)
    assert set(results) == {f"r{i}" for i in range(25)}
    assert results["r3"]["response"]["data"]["ndarray"] == [[0.9, 0.05, 0.05]]
    assert q.committed("default") == 25


def test_kill_and_restart_mid_stream(tmp_path, engine_port):
    N = 40
    q = FileQueue(str(tmp_path / "q"))
    for r in records(N):
        q.append(r)
    out = str(tmp_path / "results.jsonl")

    async def first_life():
        consumer = IngestConsumer(q, "127.0.0.1", engine_port, out_path=out,
                                  concurrency=2, poll_batch=4)
        task = asyncio.ensure_future(consumer.run())
        while consumer.stats["scored"] < 10:
            await asyncio.sleep(0.01)
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass
        return consumer.stats["scored"]

    scored_before = asyncio.run(first_life())
    assert 0 < scored_before < N
    committed = q.committed("default")
    assert committed <= scored_before + 2
    consumer2 = IngestConsumer(q, "127.0.0.1", engine_port, out_path=out, concurrency=4)
    stats2 = asyncio.run(consumer2.run(drain=True))
    results = read_results(out)
    assert set(results) == {f"r{i}" for i in range(N)}
    assert q.committed("default") == N
    assert stats2["scored"] >= N - committed


def test_poison_record_dead_letters_and_does_not_wedge(tmp_path, engine_port):
    q = FileQueue(str(tmp_path / "q"))
    q.append({"id": "good-1", "data": [[1.0, 2.0]]})
    q.append({"id": "bad", "request": {"data": {"raw":
              {"dtype": "no-such-dtype", "shape": [1], "data": ""}}}})
    q.append({"id": "good-2", "data": [[3.0, 4.0]]})
    out = str(tmp_path / "results.jsonl")
    dl = str(tmp_path / "dead.jsonl")
    consumer = IngestConsumer(q, "127.0.0.1", engine_port, out_path=out,
                              dead_letter_path=dl, retries=2, retry_backoff_s=0.01)
    stats = asyncio.run(consumer.run(drain=True))
    assert stats["scored"] == 2
    assert stats["dead_lettered"] == 1
    assert set(read_results(out)) == {"good-1", "good-2"}
    with open(dl) as f:
        rows = [json.loads(x) for x in f]
    assert len(rows) == 1 and rows[0]["record"]["id"] == "bad"
    assert rows[0]["error"]
    assert q.committed("default") == 3


def test_bounded_concurrency_backpressure(tmp_path):
    """A slow engine sees at most ``concurrency`` simultaneous calls."""
    peak, live = [0], [0]
    lock = threading.Lock()

    class SlowModel:
        def predict(self, X, names, meta=None):
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            time.sleep(0.05)
            with lock:
                live[0] -= 1
            return [[1.0]]

    spec = default_predictor(PredictorSpec.from_dict(
        {"name": "slow", "graph": {"name": "m", "type": "MODEL"}}))
    port, stop = _serve(EngineApp(spec, registry={"m": SlowModel()}))
    try:
        q = FileQueue(str(tmp_path / "q"))
        for r in records(12):
            q.append(r)
        consumer = IngestConsumer(q, "127.0.0.1", port, out_path=str(tmp_path / "r.jsonl"),
                                  concurrency=3)
        stats = asyncio.run(consumer.run(drain=True))
    finally:
        stop()
    assert stats["scored"] == 12
    assert peak[0] <= 3


def test_cli_enqueue_and_consume(tmp_path, engine_port, capsys):
    recs = tmp_path / "recs.jsonl"
    recs.write_text("\n".join(json.dumps(r) for r in records(5)) + "\n")
    ingest.main(["enqueue", "--queue-dir", str(tmp_path / "q"), "--file", str(recs)])
    assert "enqueued 5" in capsys.readouterr().out
    ingest.main(["consume", "--queue-dir", str(tmp_path / "q"),
                 "--engine", f"127.0.0.1:{engine_port}",
                 "--out", str(tmp_path / "results.jsonl"), "--drain"])
    assert len(read_results(str(tmp_path / "results.jsonl"))) == 5
    assert '"scored": 5' in capsys.readouterr().out


# -- the JAX package's broker contract (tests/test_kafka_broker.py) ----------


@pytest.fixture
def cluster():
    return FakeCluster()


def kafka_broker(cluster):
    p, c, tp = make_client_classes(cluster)
    return KafkaBroker("t", producer_cls=p, consumer_cls=c, tp_cls=tp)


@pytest.fixture(params=["file", "kafka"])
def make_broker(request, tmp_path, cluster):
    def factory():
        if request.param == "file":
            return FileQueue(str(tmp_path / "q"))
        return kafka_broker(cluster)

    return factory


def test_append_poll_roundtrip_and_offsets(make_broker):
    q = make_broker()
    offs = [q.append({"id": f"r{i}", "v": i}) for i in range(7)]
    assert offs == list(range(7))
    got = q.poll(0, 100)
    assert [o for o, _ in got] == list(range(7))
    assert [r["v"] for _, r in got] == list(range(7))
    assert q.poll(3, 2) == [(3, {"id": "r3", "v": 3}), (4, {"id": "r4", "v": 4})]
    assert q.poll(7, 10) == []


def test_commit_is_durable_per_group_across_restart(make_broker):
    q = make_broker()
    for i in range(5):
        q.append({"id": f"r{i}"})
    assert q.committed("g1") == 0
    q.commit("g1", 3)
    q.commit("g2", 1)
    q2 = make_broker()
    assert q2.committed("g1") == 3
    assert q2.committed("g2") == 1
    assert [o for o, _ in q2.poll(q2.committed("g1"), 10)] == [3, 4]


def test_consumer_drains_and_replays_uncommitted_tail(make_broker, tmp_path, engine_port):
    q = make_broker()
    for i in range(6):
        q.append({"id": f"r{i}", "request": {"data": {"ndarray": [[float(i), 1.0]]}}})
    out = str(tmp_path / "res.jsonl")
    c = IngestConsumer(q, "127.0.0.1", engine_port, group="g", out_path=out, concurrency=2)
    stats = asyncio.run(c.run(drain=True))
    assert stats["scored"] == 6
    assert q.committed("g") == 6
    q.commit("g", 4)
    c2 = IngestConsumer(q, "127.0.0.1", engine_port, group="g", out_path=out, concurrency=2)
    stats2 = asyncio.run(c2.run(drain=True))
    assert stats2["scored"] == 2
    assert stats2["replayed"] == 2
    assert len(read_results(out)) == 6


def test_poison_record_dead_letters_without_wedging(make_broker, tmp_path, engine_port):
    q = make_broker()
    q.append({"id": "ok", "request": {"data": {"ndarray": [[1.0, 2.0]]}}})
    q.append({"id": "poison", "request": {"data": {"raw":
              {"dtype": "no-such-dtype", "shape": [1], "data": ""}}}})
    q.append({"id": "ok2", "request": {"data": {"ndarray": [[3.0, 4.0]]}}})
    out = str(tmp_path / "res.jsonl")
    dl = str(tmp_path / "dead.jsonl")
    c = IngestConsumer(q, "127.0.0.1", engine_port, group="g", out_path=out,
                       dead_letter_path=dl, retries=2, retry_backoff_s=0.01)
    stats = asyncio.run(c.run(drain=True))
    assert stats["scored"] == 2
    assert stats["dead_lettered"] == 1
    assert q.committed("g") == 3
    with open(dl) as f:
        assert json.loads(f.readline())["record"]["id"] == "poison"


def test_kafka_undecodable_payload_surfaces_as_marker(cluster, tmp_path, engine_port):
    q = kafka_broker(cluster)
    q.append({"id": "good", "request": {"data": {"ndarray": [[1.0, 2.0]]}}})
    cluster.log.append(b"\xff\xfenot json")
    q.append({"id": "good2", "request": {"data": {"ndarray": [[3.0, 4.0]]}}})
    got = q.poll(0, 10)
    assert [o for o, _ in got] == [0, 1, 2]
    assert got[1][1]["id"] == "__undecodable-1"
    c = IngestConsumer(q, "127.0.0.1", engine_port, group="g",
                       out_path=str(tmp_path / "res.jsonl"),
                       dead_letter_path=str(tmp_path / "dead.jsonl"), retries=2,
                       retry_backoff_s=0.01)
    stats = asyncio.run(c.run(drain=True))
    assert stats["scored"] == 2
    assert stats["dead_lettered"] == 1
    assert q.committed("g") == 3


def test_append_many_returns_first_offset(make_broker):
    q = make_broker()
    q.append({"id": "r0"})
    assert q.append_many([{"id": "r1"}, {"id": "r2"}, {"id": "r3"}]) == 1
    assert q.append_many([]) == 4


def test_engine_predict_url_one_shot(engine_port):
    """The URL form of the consumer's engine call: one connection per call,
    deadline-bound, the engine's application errors surfaced."""
    from seldon_core_tpu_torch.graph.client import UnitCallError, engine_predict_url

    url = f"http://127.0.0.1:{engine_port}"
    out = asyncio.run(engine_predict_url(url, {"data": {"ndarray": [[1.0, 2.0]]}}))
    assert out["data"]["ndarray"] == [[0.9, 0.05, 0.05]]
    with pytest.raises(UnitCallError) as err:
        asyncio.run(engine_predict_url(url, {"data": {"raw": {
            "dtype": "no-such-dtype", "shape": [1], "data": ""}}}))
    assert err.value.status == 400


def test_kafka_import_gate_without_clients():
    with pytest.raises(ImportError, match="confluent_kafka"):
        KafkaBroker("t")


# -- the port against the JAX package ----------------------------------------


def _fill(q, recs):
    """Single appends, then a batch that crosses a segment boundary."""
    for r in recs[:3]:
        q.append(r)
    q.append_many(recs[3:])


def test_queue_files_byte_identical(tmp_path, monkeypatch):
    monkeypatch.setattr(ingest, "SEGMENT_MAX_RECORDS", 5)
    monkeypatch.setattr(jax_ingest, "SEGMENT_MAX_RECORDS", 5)
    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    recs = records(13) + [{"id": "ü", "request": {"jsonData": {"prompt": "héllo"}}}]
    port_q, jax_q = FileQueue(str(tmp_path / "port")), jax_ingest.FileQueue(str(tmp_path / "jax"))
    _fill(port_q, recs)
    _fill(jax_q, recs)
    port_q.commit("g", 9)
    jax_q.commit("g", 9)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == ["commit-g.json", "segment-000000000000.jsonl",
                     "segment-000000000005.jsonl", "segment-000000000010.jsonl"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert port_q.poll(0, 100) == jax_q.poll(0, 100)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_queue_drains_through_the_other_packages_consumer(writer, tmp_path, engine_port):
    """A queue one package wrote, half committed by that package, drains
    through the other package's consumer from the commit on."""
    write_mod, read_mod = (jax_ingest, ingest) if writer == "jax" else (ingest, jax_ingest)
    wq = write_mod.FileQueue(str(tmp_path / "q"))
    wq.append_many(records(10))
    wq.commit("g", 4)
    rq = read_mod.FileQueue(str(tmp_path / "q"))
    assert rq.committed("g") == 4 and rq.end_offset() == 10
    out = str(tmp_path / "res.jsonl")
    c = read_mod.IngestConsumer(rq, "127.0.0.1", engine_port, group="g", out_path=out,
                                concurrency=3)
    stats = asyncio.run(c.run(drain=True))
    assert stats["scored"] == 6
    assert wq.committed("g") == 10
    results = write_mod.read_results(out)
    assert set(results) == {f"r{i}" for i in range(4, 10)}
    assert results["r7"]["response"]["data"]["ndarray"] == [[0.9, 0.05, 0.05]]


GEN_RECORDS = [
    {"id": "greedy_3", "request": {"jsonData": {"prompt_tokens": [5, 17, 42],
                                                "max_new_tokens": 6}}},
    {"id": "seeded_9", "request": {"jsonData": {"prompt_tokens": [1, 2, 3, 4, 5, 6, 7, 8, 9],
                                                "max_new_tokens": 7, "temperature": 0.8,
                                                "seed": 4}}},
    {"id": "greedy_30", "request": {"jsonData": {"prompt_tokens": list(range(30, 60)),
                                                 "max_new_tokens": 5}}},
    {"id": "seeded_5", "request": {"jsonData": {"prompt_tokens": [9, 9, 9, 9, 1],
                                                "max_new_tokens": 8, "temperature": 1.2,
                                                "seed": 11}}},
    {"id": "text", "request": {"jsonData": {"prompt": "hi there", "max_new_tokens": 4}}},
]


@pytest.fixture(scope="module")
def generate_engine(tmp_path_factory):
    from seldon_core_tpu.servers.generateserver import GenerateServer as JaxGenerateServer

    model_dir = make_model_dir(tmp_path_factory.mktemp("llm"))
    app = build_app("seldon_core_tpu_torch", gen_unit(model_dir))
    port, stop = _serve(app)
    jax_server = JaxGenerateServer(model_uri=model_dir, slots=2, steps_per_poll=2)
    jax_server.load()
    yield port, jax_server
    stop()
    app.executor.root.client.user_object.close()
    jax_server.close()


def test_generate_records_equal_jax_alone(generate_engine, tmp_path):
    """Generate records through the port's engine over a CPU
    GenerateServer (2 slots, so records share the decode batch) give the
    JAX GenerateServer's tokens for each request alone, greedy and
    seeded; a replay after a rewound commit overwrites each result with
    identical tokens."""
    port, jax_server = generate_engine
    assert {"name": "slots", "value": "2", "type": "INT"} in GEN_PARAMS
    q = FileQueue(str(tmp_path / "q"))
    q.append_many(GEN_RECORDS)
    out = str(tmp_path / "res.jsonl")
    c = IngestConsumer(q, "127.0.0.1", port, group="g", out_path=out, concurrency=3,
                       engine_timeout_s=120)
    assert asyncio.run(c.run(drain=True))["scored"] == len(GEN_RECORDS)
    first = read_results(out)
    for rec in GEN_RECORDS:
        want = jax_server.predict(rec["request"]["jsonData"], [])
        assert first[rec["id"]]["response"]["jsonData"] == want, rec["id"]
    q.commit("g", 1)
    c2 = IngestConsumer(q, "127.0.0.1", port, group="g", out_path=out, concurrency=3,
                        engine_timeout_s=120)
    stats = asyncio.run(c2.run(drain=True))
    assert stats["scored"] == stats["replayed"] == len(GEN_RECORDS) - 1
    again = read_results(out)
    assert {k: v["response"]["jsonData"] for k, v in again.items()} == {
        k: v["response"]["jsonData"] for k, v in first.items()}
