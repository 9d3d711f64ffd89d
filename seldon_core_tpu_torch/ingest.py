"""Async ingestion tier: broker-fed scoring with at-least-once delivery.

Counterpart of ``seldon_core_tpu/ingest.py``: records are produced into a
durable queue and a consumer drains them through the engine
asynchronously, decoupling producers from serving capacity.

* **Durable queue** = append-only JSONL segment files of
  ``SEGMENT_MAX_RECORDS`` records + an fsync'd commit file per consumer
  group (``FileQueue``), the same on-disk layout as the JAX package's, so
  a queue either package wrote drains through the other. The same
  ``Broker`` protocol admits a Kafka client where one is installed
  (``KafkaBroker`` is import-gated).
* **At-least-once**: the consumer commits offsets only after the engine
  call (or its dead-lettering) completes, and only CONTIGUOUSLY — a
  crash between scoring and commit replays the tail. The results sink is
  keyed by record id, so replays overwrite identically: exactly-once
  *observable* despite at-least-once delivery.
* **Dead-letter path**: a record that still fails after ``retries``
  engine calls is appended to ``dead_letter.jsonl`` with the error and
  counts as handled (the queue never wedges on a poison record).
* **Backpressure**: bounded in-flight concurrency; the consumer polls
  only while slots are free, so a slow engine slows the drain instead of
  ballooning memory.

CLI::

    python -m seldon_core_tpu_torch.ingest enqueue --queue-dir q --file recs.jsonl
    python -m seldon_core_tpu_torch.ingest consume --queue-dir q \
        --engine 127.0.0.1:8000 --group g1 --out results.jsonl
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

SEGMENT_MAX_RECORDS = 4096


class Broker:
    """Minimal consumer-side broker contract (Kafka-shaped): poll records
    from an offset, commit an offset for a group."""

    def append(self, record: Dict[str, Any]) -> int:
        raise NotImplementedError

    def poll(self, offset: int, max_records: int) -> List[Tuple[int, Dict[str, Any]]]:
        raise NotImplementedError

    def committed(self, group: str) -> int:
        raise NotImplementedError

    def commit(self, group: str, offset: int) -> None:
        raise NotImplementedError


class FileQueue(Broker):
    """Append-only JSONL segments + per-group commit files.

    Offsets are global record indices; segment files are named by their
    base offset (``segment-<base>.jsonl``). Appends fsync the segment;
    commits write-then-rename an offset file (crash-atomic)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- producer -----------------------------------------------------------

    def _segments(self) -> List[int]:
        bases = []
        for f in os.listdir(self.root):
            if f.startswith("segment-") and f.endswith(".jsonl"):
                bases.append(int(f[len("segment-"):-len(".jsonl")]))
        return sorted(bases)

    def _segment_path(self, base: int) -> str:
        return os.path.join(self.root, f"segment-{base:012d}.jsonl")

    def _count(self, base: int) -> int:
        try:
            with open(self._segment_path(base), "rb") as f:
                return sum(1 for _ in f)
        except FileNotFoundError:
            return 0

    def end_offset(self) -> int:
        bases = self._segments()
        if not bases:
            return 0
        return bases[-1] + self._count(bases[-1])

    def append(self, record: Dict[str, Any]) -> int:
        bases = self._segments()
        if not bases:
            base, n = 0, 0
        else:
            base = bases[-1]
            n = self._count(base)
            if n >= SEGMENT_MAX_RECORDS:
                base, n = base + n, 0
        off = base + n
        with open(self._segment_path(base), "a", encoding="utf-8") as f:
            f.write(json.dumps(record, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return off

    def append_many(self, records: List[Dict[str, Any]]) -> int:
        """Batched append, ONE fsync per touched segment; returns the first
        offset. Rotates at SEGMENT_MAX_RECORDS exactly like append() — a
        bulk enqueue must not produce one unbounded segment (poll() scans
        a segment from its base, so oversized segments make the drain
        quadratic)."""
        if not records:
            return self.end_offset()
        bases = self._segments()
        base = bases[-1] if bases else 0
        n = self._count(base) if bases else 0
        first = base + n
        i = 0
        while i < len(records):
            if n >= SEGMENT_MAX_RECORDS:
                base, n = base + n, 0
            take = records[i:i + (SEGMENT_MAX_RECORDS - n)]
            with open(self._segment_path(base), "a", encoding="utf-8") as f:
                for r in take:
                    f.write(json.dumps(r, separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
            n += len(take)
            i += len(take)
        return int(first)

    # -- consumer -----------------------------------------------------------

    def poll(self, offset: int, max_records: int) -> List[Tuple[int, Dict[str, Any]]]:
        out: List[Tuple[int, Dict[str, Any]]] = []
        for base in self._segments():
            if out and len(out) >= max_records:
                break
            count = self._count(base)
            if base + count <= offset:
                continue
            with open(self._segment_path(base), encoding="utf-8") as f:
                for i, line in enumerate(f):
                    off = base + i
                    if off < offset:
                        continue
                    if len(out) >= max_records:
                        break
                    try:
                        out.append((off, json.loads(line)))
                    except json.JSONDecodeError:
                        # torn final line of a crashed producer: stop here,
                        # the record was never fully appended
                        return out
        return out

    def _commit_path(self, group: str) -> str:
        return os.path.join(self.root, f"commit-{group}.json")

    def committed(self, group: str) -> int:
        try:
            with open(self._commit_path(group)) as f:
                return int(json.load(f)["offset"])
        except (FileNotFoundError, ValueError, KeyError):
            return 0

    def commit(self, group: str, offset: int) -> None:
        tmp = self._commit_path(group) + ".tmp"
        with open(tmp, "w") as f:
            # persisted absolute stamp read by humans across process
            # lifetimes — monotonic would be meaningless on disk
            # seldon-lint: disable=wall-clock
            json.dump({"offset": int(offset), "ts": time.time()}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._commit_path(group))


class KafkaBroker(Broker):
    """Adapter for a real Kafka cluster: the ``Broker`` contract over
    confluent-kafka's Producer/Consumer API against a
    single-partition topic (partition 0 — contiguous offsets, matching
    FileQueue's total order; scale-out shards by running one consumer per
    topic, not by partitions).

    Import-gated optional dependency: constructing without
    ``confluent_kafka`` installed (and without injected client classes)
    raises ImportError. The client classes are injectable so that the
    contract suite runs against a stub cluster through the same adapter
    code paths a deployment runs.

    Deploy wiring::

        python -m seldon_core_tpu_torch.ingest consume \\
            --kafka broker-0.kafka:9092 --topic seldon-requests \\
            --engine engine.default.svc:8000 --group scorer --out r.jsonl
    """

    def __init__(self, topic: str, bootstrap: str = "localhost:9092",
                 producer_cls=None, consumer_cls=None, tp_cls=None,
                 poll_timeout_s: float = 1.0):
        if producer_cls is None or consumer_cls is None or tp_cls is None:
            try:
                import confluent_kafka  # type: ignore
            except ImportError as e:  # pragma: no cover - no client in image
                raise ImportError(
                    "confluent_kafka is not available in this image; use "
                    "FileQueue or run the consumer next to a broker with "
                    "the client installed"
                ) from e
            producer_cls = confluent_kafka.Producer      # pragma: no cover
            consumer_cls = confluent_kafka.Consumer      # pragma: no cover
            tp_cls = confluent_kafka.TopicPartition      # pragma: no cover
        self.topic = topic
        self.bootstrap = bootstrap
        self.poll_timeout_s = poll_timeout_s
        self._tp = tp_cls
        self._consumer_cls = consumer_cls
        self._producer = producer_cls({"bootstrap.servers": bootstrap})
        self._reader = None           # offset-addressed poll() consumer
        self._reader_next = None      # offset the reader is positioned at
        self._group_consumers: Dict[str, Any] = {}

    # -- producer side ------------------------------------------------------

    def append(self, record: Dict[str, Any]) -> int:
        return self.append_many([record])

    def append_many(self, records: List[Dict[str, Any]]) -> int:
        """Produce the whole batch, then ONE flush — the durability
        barrier FileQueue gets from fsync, without paying a broker
        round-trip per record. Returns the FIRST offset of the batch
        (FileQueue's contract)."""
        if not records:
            # FileQueue parity: an empty batch returns the end offset
            # (the offset the next record would get) via the broker's
            # high watermark
            c = self._group_consumer("__seldon_tpu_watermark__")
            _lo, hi = c.get_watermark_offsets(self._tp(self.topic, 0))
            return int(hi)
        delivered: List[int] = []
        errors: List[Any] = []

        def on_delivery(err, msg):
            if err is not None:
                errors.append(err)
            else:
                delivered.append(msg.offset())

        for record in records:
            self._producer.produce(
                self.topic,
                json.dumps(record, separators=(",", ":")).encode("utf-8"),
                on_delivery=on_delivery,
            )
        self._producer.flush()
        if errors:
            raise KafkaIngestError(f"produce failed: {errors[0]}")
        if len(delivered) != len(records):
            raise KafkaIngestError(
                f"only {len(delivered)}/{len(records)} produces acknowledged"
            )
        return min(delivered)

    # -- consumer side ------------------------------------------------------

    def poll(self, offset: int, max_records: int
             ) -> List[Tuple[int, Dict[str, Any]]]:
        if max_records <= 0:
            return []
        if self._reader is None:
            self._reader = self._consumer_cls({
                "bootstrap.servers": self.bootstrap,
                # offset-addressed reads: this consumer NEVER commits; the
                # group consumers own commit state
                "group.id": "__seldon_tpu_reader__",
                "enable.auto.commit": False,
            })
        if self._reader_next != offset:
            # position via (re-)assign with an explicit offset: seek()
            # right after assign() raises "Erroneous state" in real
            # confluent-kafka (the fetcher hasn't started); assign-with-
            # offset is always legal
            self._reader.assign([self._tp(self.topic, 0, offset)])
            self._reader_next = offset
        out: List[Tuple[int, Dict[str, Any]]] = []
        for msg in self._reader.consume(max_records, self.poll_timeout_s):
            if msg is None or msg.error():
                continue
            self._reader_next = msg.offset() + 1
            try:
                out.append(
                    (msg.offset(), json.loads(msg.value().decode("utf-8")))
                )
            except (ValueError, UnicodeDecodeError) as e:
                # surface the record instead of skipping it: a silent skip
                # leaves an offset HOLE the consumer's contiguous commit
                # can never cross (it would wedge at this offset forever).
                # Returned as a marker record, it fails scoring, exhausts
                # retries, dead-letters, and the commit advances past it.
                out.append((msg.offset(), {
                    "id": f"__undecodable-{msg.offset()}",
                    "__undecodable__": str(e),
                }))
        return out

    def _group_consumer(self, group: str):
        if group not in self._group_consumers:
            self._group_consumers[group] = self._consumer_cls({
                "bootstrap.servers": self.bootstrap,
                "group.id": group,
                "enable.auto.commit": False,
            })
        return self._group_consumers[group]

    def committed(self, group: str) -> int:
        c = self._group_consumer(group)
        tps = c.committed([self._tp(self.topic, 0)])
        off = tps[0].offset if tps else None
        # confluent uses OFFSET_INVALID (-1001) / -1 for "never committed"
        return off if off is not None and off >= 0 else 0

    def commit(self, group: str, offset: int) -> None:
        c = self._group_consumer(group)
        c.commit(offsets=[self._tp(self.topic, 0, offset)], asynchronous=False)


class KafkaIngestError(RuntimeError):
    """Producer-side delivery failure surfaced synchronously."""


class IngestConsumer:
    """Drain a broker through the engine with bounded concurrency.

    ``run()`` processes until ``stop()`` (or ``drain=True``: until the
    queue is exhausted). Results are appended to ``out_path`` as
    ``{"id", "offset", "response"}`` rows; failures exhaust ``retries``
    then dead-letter. Commit advances only past the contiguous prefix of
    handled offsets."""

    def __init__(
        self,
        broker: Broker,
        engine_host: str,
        engine_port: int,
        group: str = "default",
        out_path: str = "results.jsonl",
        dead_letter_path: Optional[str] = None,
        concurrency: int = 8,
        retries: int = 3,
        poll_batch: int = 64,
        idle_sleep_s: float = 0.05,
        retry_backoff_s: float = 0.05,
        engine_timeout_s: float = 30.0,
    ):
        self.broker = broker
        self.engine_host = engine_host
        self.engine_port = engine_port
        self.group = group
        self.out_path = out_path
        self.dead_letter_path = dead_letter_path or (
            os.path.join(os.path.dirname(out_path) or ".", "dead_letter.jsonl")
        )
        self.concurrency = int(concurrency)
        self.retries = int(retries)
        self.poll_batch = int(poll_batch)
        self.idle_sleep_s = idle_sleep_s
        self.retry_backoff_s = retry_backoff_s
        self.engine_timeout_s = engine_timeout_s
        self._stop = asyncio.Event()
        self.stats = {"scored": 0, "dead_lettered": 0, "replayed": 0}
        self._client = None
        self._prior_ids: set = set()
        self._out_f = None

    def stop(self) -> None:
        self._stop.set()

    # -- engine call --------------------------------------------------------

    async def _score(self, record: Dict[str, Any]) -> Dict[str, Any]:
        from .graph.client import RestClient

        if "__undecodable__" in record:
            # broker surfaced a payload it could not decode (see
            # KafkaBroker.poll): not retryable — straight to dead-letter
            raise ValueError(
                f"undecodable broker payload: {record['__undecodable__']}"
            )
        if self._client is None:
            self._client = RestClient(
                self.engine_host, self.engine_port,
                timeout=self.engine_timeout_s,
            )
        body = record.get("request") or {"data": {"ndarray": record.get("data")}}
        last: Optional[Exception] = None
        for attempt in range(self.retries):
            try:
                return await self._client.engine_predict(body)
            except Exception as e:  # noqa: BLE001 - every failure retries
                last = e
                await asyncio.sleep(self.retry_backoff_s * (attempt + 1))
        raise RuntimeError(f"engine call failed after {self.retries} tries: {last}")

    # -- sink ---------------------------------------------------------------

    def _write_result(self, offset: int, record: Dict[str, Any],
                      response: Dict[str, Any]) -> None:
        rid = record.get("id", f"offset-{offset}")
        if rid in self._prior_ids:
            # a restart re-scored an offset a previous life already sank:
            # at-least-once working as designed, surfaced for operators
            self.stats["replayed"] += 1
        row = {"id": rid, "offset": offset, "response": response}
        if self._out_f is None:
            self._out_f = open(self.out_path, "a", encoding="utf-8")
        self._out_f.write(json.dumps(row, separators=(",", ":")) + "\n")

    def _sync_results(self) -> None:
        # results must be durable BEFORE the commit offset advances past
        # them, or a crash loses sunk rows the replay will never re-score
        if self._out_f is not None:
            self._out_f.flush()
            os.fsync(self._out_f.fileno())

    def _dead_letter(self, offset: int, record: Dict[str, Any], error: str) -> None:
        self.stats["dead_lettered"] += 1
        # seldon-lint: disable=wall-clock (persisted dead-letter stamp, no interval math)
        row = {"offset": offset, "record": record, "error": error, "ts": time.time()}
        with open(self.dead_letter_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(row, separators=(",", ":")) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # -- drain loop ---------------------------------------------------------

    async def run(self, drain: bool = False) -> Dict[str, int]:
        # ids a previous life already sank (fuels the replayed stat)
        self._prior_ids = set(read_results(self.out_path))
        sem = asyncio.Semaphore(self.concurrency)
        handled: Dict[int, bool] = {}
        commit = self.broker.committed(self.group)
        next_poll = commit
        inflight: set = set()

        async def handle(offset: int, record: Dict[str, Any]) -> None:
            async with sem:
                try:
                    resp = await self._score(record)
                    self._write_result(offset, record, resp)
                    self.stats["scored"] += 1
                except Exception as e:  # noqa: BLE001 -> dead letter
                    self._dead_letter(offset, record, str(e))
            handled[offset] = True

        def advance_commit() -> None:
            nonlocal commit
            new = commit
            while handled.get(new):
                del handled[new]
                new += 1
            if new != commit:
                commit = new
                self._sync_results()
                self.broker.commit(self.group, commit)

        empty_polls = 0
        try:
            while not self._stop.is_set():
                # poll only while in-flight slots are free (backpressure)
                free = self.concurrency - (len(inflight))
                batch = (
                    self.broker.poll(next_poll, min(self.poll_batch, max(free, 0)))
                    if free > 0 else []
                )
                if free > 0:
                    # only a poll that actually RAN counts toward the
                    # drain guard — a skipped poll (no free slots) is not
                    # evidence the queue is empty
                    empty_polls = 0 if batch else empty_polls + 1
                for off, rec in batch:
                    t = asyncio.ensure_future(handle(off, rec))
                    inflight.add(t)
                    t.add_done_callback(inflight.discard)
                    next_poll = off + 1
                if not batch:
                    if inflight:
                        await asyncio.wait(
                            list(inflight), return_when=asyncio.FIRST_COMPLETED
                        )
                    elif drain and empty_polls >= 2:
                        # TWO consecutive empty polls: against a real
                        # broker one empty consume() does not mean
                        # exhausted (fetcher warm-up, transient latency) —
                        # a single-poll break would drain 0 records and
                        # report success. FileQueue just pays one extra
                        # (cheap, synchronous) poll.
                        break
                    else:
                        try:
                            await asyncio.wait_for(
                                self._stop.wait(), self.idle_sleep_s
                            )
                        except asyncio.TimeoutError:
                            pass
                advance_commit()
            if inflight:
                await asyncio.gather(*inflight, return_exceptions=True)
            advance_commit()
        finally:
            if self._out_f is not None:
                self._sync_results()
                self._out_f.close()
                self._out_f = None
            if self._client is not None:
                await self._client.close()
                self._client = None
        return dict(self.stats)


def read_results(path: str) -> Dict[str, Dict[str, Any]]:
    """Results keyed by record id — last write wins, which is exactly the
    idempotent-sink property that upgrades at-least-once to
    exactly-once-observable."""
    out: Dict[str, Dict[str, Any]] = {}
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail from a crash mid-write
                out[row["id"]] = row
    except FileNotFoundError:
        pass
    return out


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser("seldon_core_tpu_torch.ingest")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("enqueue", help="append records to the queue")
    pe.add_argument("--queue-dir", default=None,
                    help="file-queue directory (required unless --kafka)")
    pe.add_argument("--file", required=True,
                    help="JSONL of records ({'id', 'request'|'data'})")
    pe.add_argument("--kafka", default=None,
                    help="bootstrap servers — use a Kafka topic instead of "
                    "the file queue (needs confluent_kafka)")
    pe.add_argument("--topic", default="seldon-requests")

    pc = sub.add_parser("consume", help="drain the queue through an engine")
    pc.add_argument("--queue-dir", default=None,
                    help="file-queue directory (required unless --kafka)")
    pc.add_argument("--engine", required=True, help="host:port of the engine")
    pc.add_argument("--group", default="default")
    pc.add_argument("--out", default="results.jsonl")
    pc.add_argument("--dead-letter", default=None)
    pc.add_argument("--concurrency", type=int, default=8)
    pc.add_argument("--drain", action="store_true",
                    help="exit when the queue is exhausted")
    pc.add_argument("--kafka", default=None,
                    help="bootstrap servers — consume a Kafka topic instead "
                    "of the file queue (needs confluent_kafka)")
    pc.add_argument("--topic", default="seldon-requests")

    args = p.parse_args(argv)
    logging.basicConfig(level="INFO")
    if not args.kafka and not args.queue_dir:
        p.error("--queue-dir is required unless --kafka is given")
    q: Broker = (
        KafkaBroker(args.topic, bootstrap=args.kafka)
        if args.kafka else FileQueue(args.queue_dir)
    )
    if args.cmd == "enqueue":
        records = []
        with open(args.file, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    records.append(json.loads(line))
        first = q.append_many(records)
        print(f"enqueued {len(records)} records from offset {first}")
        return
    host, _, port = args.engine.partition(":")
    consumer = IngestConsumer(
        q, host, int(port or 8000), group=args.group, out_path=args.out,
        dead_letter_path=args.dead_letter, concurrency=args.concurrency,
    )
    stats = asyncio.run(consumer.run(drain=args.drain))
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
