"""Streaming batch scorer: pipe a dataset through a deployment.

Counterpart of ``seldon_core_tpu/batch.py`` and of the reference's Kafka
streaming path (reference: kafka/kafka.json + the stream-processing
deployment pattern its docs describe): batch scoring as a
bounded-concurrency PIPELINE — read records from a JSONL/CSV stream
(file or stdin), keep N requests in flight against the engine/gateway
so the device-side micro-batcher always has work, and write one JSONL
result per record in INPUT ORDER. Failures are recorded per-record,
never dropped.

CLI::

    seldon-tpu-torch-batch http://HOST:8000 --input data.jsonl --output out.jsonl \
        [--format jsonl|csv] [--concurrency 16] [--batch-rows 8]
        [--path /api/v0.1/predictions] [--binary]

Input records: JSONL — either a full SeldonMessage dict or a bare list
(one data row); CSV — one row per line. ``--batch-rows`` fuses that many
input rows per request (client-side batching on top of the engine's
micro-batching); rows with different ``names`` never share a request.
"""

from __future__ import annotations

import argparse
import asyncio
import csv
import io
import json
import logging
import sys
from typing import Any, Dict, Iterable, Iterator, List, Optional, TextIO

logger = logging.getLogger(__name__)


PARSE_ERROR = "_parse_error"


def read_records(stream: TextIO, fmt: str) -> Iterator[Dict[str, Any]]:
    """Yield SeldonMessage-shaped dicts from a JSONL or CSV stream. A
    malformed line yields a {PARSE_ERROR: ...} marker instead of aborting
    the whole run — per-record failure is the module's contract."""
    if fmt == "csv":
        for row in csv.reader(stream):
            if not row:
                continue
            try:
                yield {"data": {"ndarray": [[float(x) for x in row]]}}
            except ValueError as e:
                yield {PARSE_ERROR: f"bad csv row {row!r}: {e}"}
        return
    for line in stream:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            yield {PARSE_ERROR: f"bad json line: {e}"}
            continue
        if isinstance(rec, list):
            rec = {"data": {"ndarray": [rec]}}
        yield rec


def fuse_rows(records: Iterable[Dict[str, Any]], batch_rows: int) -> Iterator[Dict[str, Any]]:
    """Fuse consecutive bare-ndarray records into one request of up to
    ``batch_rows`` rows. Records carrying meta/strData/jsonData — or a
    different ``names`` list than the pending batch — pass through / start
    a new batch, so nothing is silently dropped. Yields
    {"message", "count"} where count is the number of INPUT RECORDS fused.
    """
    pending: List[List[Any]] = []
    pending_names: Optional[List[str]] = None

    def flush():
        nonlocal pending, pending_names
        if pending:
            data: Dict[str, Any] = {"ndarray": pending}
            if pending_names:
                data["names"] = pending_names
            out = {"message": {"data": data}, "count": len(pending)}
            pending, pending_names = [], None
            return out
        return None

    for rec in records:
        data = rec.get("data") or {}
        names = data.get("names") or None
        fusable = (
            PARSE_ERROR not in rec
            and set(rec.keys()) <= {"data"}
            and set(data.keys()) <= {"ndarray", "names"}
            and isinstance(data.get("ndarray"), list)
            and len(data["ndarray"]) == 1
        )
        if fusable and batch_rows > 1:
            if pending and names != pending_names:
                yield flush()
            pending.append(data["ndarray"][0])
            pending_names = names
            if len(pending) >= batch_rows:
                yield flush()
        else:
            out = flush()
            if out:
                yield out
            yield {"message": rec, "count": 1}
    out = flush()
    if out:
        yield out


class BatchScorer:
    def __init__(
        self,
        target: str,
        path: str = "/api/v0.1/predictions",
        concurrency: int = 16,
        binary: bool = False,
        timeout_s: float = 60.0,
    ):
        import threading
        from concurrent.futures import ThreadPoolExecutor
        from urllib.parse import urlparse

        self.target = target.rstrip("/")
        self.path = path
        self.concurrency = max(1, int(concurrency))
        self.binary = binary
        self.timeout_s = timeout_s
        self.stats = {"requests": 0, "rows": 0, "failures": 0}
        parsed = urlparse(self.target if "//" in self.target else f"http://{self.target}")
        self._host = parsed.hostname
        self._port = parsed.port or (443 if parsed.scheme == "https" else 80)
        self._tls = parsed.scheme == "https"
        # own pool sized to the requested concurrency (the loop's default
        # executor is cpu+4 threads — it would silently cap parallelism),
        # with one KEEP-ALIVE http connection per worker thread
        self._pool = ThreadPoolExecutor(
            max_workers=self.concurrency, thread_name_prefix="batch-score"
        )
        self._local = threading.local()

    def _connection(self):
        import http.client

        conn = getattr(self._local, "conn", None)
        if conn is None:
            cls = http.client.HTTPSConnection if self._tls else http.client.HTTPConnection
            conn = cls(self._host, self._port, timeout=self.timeout_s)
            self._local.conn = conn
        return conn

    async def _post(self, message: Dict[str, Any]) -> Dict[str, Any]:
        from .payload import json_to_proto, jsonable, proto_to_json
        from .proto import prediction_pb2 as pb

        if self.binary:
            body = json_to_proto(message).SerializeToString()
            headers = {"Content-Type": "application/x-protobuf"}
        else:
            body = json.dumps(jsonable(message)).encode()
            headers = {"Content-Type": "application/json"}

        def send():
            conn = self._connection()
            try:
                conn.request("POST", self.path, body, headers)
                resp = conn.getresponse()
                payload = resp.read()
            except Exception:
                # a broken keep-alive connection must not poison the thread
                conn.close()
                self._local.conn = None
                raise
            if resp.status >= 400:
                raise RuntimeError(f"HTTP {resp.status}: {payload[:200]!r}")
            if (resp.headers.get("Content-Type") or "").startswith("application/x-protobuf"):
                return jsonable(proto_to_json(pb.SeldonMessage.FromString(payload)))
            return json.loads(payload)

        return await asyncio.get_running_loop().run_in_executor(self._pool, send)

    @staticmethod
    def _split_records(first_record: int, count: int, out: Dict[str, Any]) -> List[Dict]:
        """One output line per INPUT RECORD: split a fused response's data
        rows back to the records they came from."""
        if count == 1:
            return [{"index": first_record, "response": out}]
        data = out.get("data") or {}
        rows = data.get("ndarray")
        if isinstance(rows, list) and len(rows) == count:
            records = []
            for i, row in enumerate(rows):
                rec_out = dict(out)
                rec_out["data"] = {**data, "ndarray": [row]}
                records.append({"index": first_record + i, "response": rec_out})
            return records
        # unsplittable response shape: attribute the whole response to
        # every record rather than silently misaligning the output
        return [
            {"index": first_record + i, "response": out, "fused_rows": count}
            for i in range(count)
        ]

    async def run(self, requests: Iterable[Dict[str, Any]], out_stream: TextIO) -> Dict[str, Any]:
        """Bounded-concurrency pipeline; output is ONE JSONL line per input
        record, in input-record order."""
        sem = asyncio.Semaphore(self.concurrency)
        results: Dict[int, List[Dict[str, Any]]] = {}
        next_write = 0
        write_lock = asyncio.Lock()

        async def score(req_idx: int, first_record: int, item: Dict[str, Any]):
            nonlocal next_write
            count = item["count"]
            parse_err = item["message"].get(PARSE_ERROR)
            async with sem:
                if parse_err is not None:
                    records = [{"index": first_record, "error": parse_err}]
                    self.stats["failures"] += 1
                else:
                    try:
                        out = await self._post(item["message"])
                        records = self._split_records(first_record, count, out)
                        self.stats["rows"] += count
                    except Exception as e:  # noqa: BLE001 - record, don't die
                        records = [
                            {"index": first_record + i, "error": f"{type(e).__name__}: {e}"}
                            for i in range(count)
                        ]
                        self.stats["failures"] += 1
                    self.stats["requests"] += 1
            async with write_lock:
                results[req_idx] = records
                while next_write in results:
                    for rec in results.pop(next_write):
                        out_stream.write(json.dumps(rec) + "\n")
                    next_write += 1

        # pull the (possibly blocking: stdin, slow producers) iterator on a
        # reader thread so in-flight requests proceed WHILE records stream in
        loop = asyncio.get_running_loop()
        it = iter(requests)
        _END = object()

        def pull():
            try:
                return next(it)
            except StopIteration:
                return _END

        tasks = []
        record_base = 0
        req_idx = 0
        while True:
            item = await loop.run_in_executor(None, pull)
            if item is _END:
                break
            # backpressure: do not materialise the whole dataset as tasks
            while len(tasks) >= self.concurrency * 4:
                done, pending = await asyncio.wait(
                    tasks, return_when=asyncio.FIRST_COMPLETED
                )
                tasks = list(pending)
            tasks.append(
                asyncio.ensure_future(score(req_idx, record_base, item))
            )
            record_base += item["count"]
            req_idx += 1
        if tasks:
            await asyncio.gather(*tasks)
        out_stream.flush()
        return dict(self.stats)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("seldon-tpu-torch-batch")
    parser.add_argument("target", help="http://host:port of an engine/gateway")
    parser.add_argument("--input", default="-", help="JSONL/CSV file ('-' = stdin)")
    parser.add_argument("--output", default="-", help="JSONL output ('-' = stdout)")
    parser.add_argument("--format", choices=("jsonl", "csv"), default="jsonl")
    parser.add_argument("--path", default="/api/v0.1/predictions")
    parser.add_argument("--concurrency", type=int, default=16)
    parser.add_argument("--batch-rows", type=int, default=1)
    parser.add_argument("--binary", action="store_true",
                        help="binary protobuf bodies (raw tensors, no b64)")
    parser.add_argument("--timeout", type=float, default=60.0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    in_stream = sys.stdin if args.input == "-" else open(args.input)
    out_stream = sys.stdout if args.output == "-" else open(args.output, "w")
    scorer = BatchScorer(
        args.target, path=args.path, concurrency=args.concurrency,
        binary=args.binary, timeout_s=args.timeout,
    )
    try:
        stats = asyncio.run(
            scorer.run(
                fuse_rows(read_records(in_stream, args.format), args.batch_rows),
                out_stream,
            )
        )
    finally:
        if in_stream is not sys.stdin:
            in_stream.close()
        if out_stream is not sys.stdout:
            out_stream.close()
    print(json.dumps(stats), file=sys.stderr)


if __name__ == "__main__":
    main()
