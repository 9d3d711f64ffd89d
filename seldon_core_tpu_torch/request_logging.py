"""Request/response payload logging.

Counterpart of ``seldon_core_tpu/request_logging.py``, in two pieces:

* :class:`CloudEventsSink` posts the engine's request/response pairs as
  CloudEvents (type ``seldon.message.pair``) over HTTP to
  ``SELDON_MESSAGE_LOGGING_SERVICE``. The engine's event loop must never
  block on a slow collector, so the sink is a bounded queue drained by
  one daemon thread that posts with ``urllib``; overflow drops events and
  counts them instead of applying back-pressure to predictions.

* :class:`RequestLoggerApp` is the collector service: it unpacks each
  pair and flattens it per data row, so that every element is an
  indexable document. Documents are held in a bounded ring and exposed
  at ``GET /entries``; an ``index_sink`` callback ships them onwards.

CLI: ``python -m seldon_core_tpu_torch.request_logging --port 2222``.
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
import queue
import threading
import urllib.request
from typing import Any, Callable, Dict, List, Optional

from .http_server import HTTPServer, Request, Response, error_body

logger = logging.getLogger(__name__)

CE_TYPE = "seldon.message.pair"


class CloudEventsSink:
    """Non-blocking CloudEvents poster: ``sink(event)`` enqueues, a daemon
    thread POSTs. Use as the ``RequestLogger`` sink."""

    def __init__(
        self,
        url: str,
        source: str = "seldon-tpu-engine",
        maxsize: int = 1024,
        timeout_s: float = 2.0,
    ):
        self.url = url
        self.source = source
        self.timeout_s = timeout_s
        self._queue: "queue.Queue[Optional[Dict]]" = queue.Queue(maxsize=maxsize)
        self._closing = threading.Event()
        self.stats = {"posted": 0, "dropped": 0, "errors": 0}
        self._thread = threading.Thread(
            target=self._worker, name="cloudevents-sink", daemon=True
        )
        self._thread.start()

    def __call__(self, event: Dict[str, Any]) -> None:
        if self._closing.is_set():
            self.stats["dropped"] += 1
            return
        try:
            self._queue.put_nowait(event)
        except queue.Full:
            # never back-pressure the serving path; count the loss
            self.stats["dropped"] += 1

    def _worker(self) -> None:
        while True:
            try:
                event = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._closing.is_set():
                    return  # backlog fully drained
                continue
            if event is None:
                # close() sentinel: drain the backlog, then exit — queued
                # events are posted, not discarded
                while True:
                    try:
                        event = self._queue.get_nowait()
                    except queue.Empty:
                        return
                    if event is not None:
                        self._post(event)
            else:
                self._post(event)

    def _post(self, event: Dict[str, Any]) -> None:
        try:
            event.setdefault("source", self.source)
            body = json.dumps(event).encode()
            req = urllib.request.Request(
                self.url,
                data=body,
                headers={
                    "Content-Type": "application/cloudevents+json",
                    "ce-specversion": event.get("specversion", "1.0"),
                    "ce-type": event.get("type", CE_TYPE),
                    "ce-id": str(event.get("id", "")),
                    "ce-source": self.source,
                },
            )
            urllib.request.urlopen(req, timeout=self.timeout_s).read()
            self.stats["posted"] += 1
        except Exception as e:  # noqa: BLE001 - logging must never crash
            self.stats["errors"] += 1
            logger.warning("cloudevents post to %s failed: %s", self.url, e)

    def close(self) -> None:
        # never blocks on a full queue: the flag stops intake immediately,
        # the worker drains the backlog (posting, not discarding) and the
        # bounded join returns even if a hung collector delays the drain
        self._closing.set()
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=self.timeout_s + 1.0)


def _rows(message: Dict[str, Any]) -> List[Any]:
    """Decode a message's payload into per-row python values (or [] when
    the message carries no tensor data)."""
    from .payload import PayloadError, json_data_to_array

    data = message.get("data")
    if isinstance(data, dict):
        try:
            arr = json_data_to_array(data)
        except PayloadError:
            return []
        return [row.tolist() if hasattr(row, "tolist") else row for row in arr]
    if "strData" in message:
        return [message["strData"]]
    if "jsonData" in message:
        return [message["jsonData"]]
    return []


def flatten_pair(event: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One document per request row, paired with the matching response
    row, for per-element indexing."""
    data = event.get("data") or {}
    request = data.get("request") or {}
    response = data.get("response") or {}
    req_rows = _rows(request)
    resp_rows = _rows(response)
    req_names = (request.get("data") or {}).get("names") or []
    resp_names = (response.get("data") or {}).get("names") or []
    meta = response.get("meta") or request.get("meta") or {}
    n = max(len(req_rows), len(resp_rows), 1)
    docs = []
    for i in range(n):
        doc: Dict[str, Any] = {
            "ce_id": event.get("id", ""),
            "ce_source": event.get("source", ""),
            "puid": (meta or {}).get("puid", event.get("id", "")),
            "index": i,
        }
        if i < len(req_rows):
            doc["request"] = req_rows[i]
            if req_names:
                doc["request_names"] = req_names
        if i < len(resp_rows):
            doc["response"] = resp_rows[i]
            if resp_names:
                doc["response_names"] = resp_names
        if meta.get("tags"):
            doc["tags"] = meta["tags"]
        if meta.get("requestPath"):
            doc["requestPath"] = meta["requestPath"]
        docs.append(doc)
    return docs


class RequestLoggerApp:
    """Collector service: ingests CloudEvents pairs, keeps flattened docs
    in a bounded ring, optionally forwards each doc to ``index_sink``."""

    def __init__(self, capacity: int = 10000,
                 index_sink: Optional[Callable[[Dict], None]] = None):
        self.entries: "collections.deque[Dict]" = collections.deque(maxlen=capacity)
        self.index_sink = index_sink
        self.stats = {"events": 0, "docs": 0, "bad": 0}

    def ingest(self, event: Dict[str, Any]) -> List[Dict[str, Any]]:
        docs = flatten_pair(event)
        self.stats["events"] += 1
        self.stats["docs"] += len(docs)
        for doc in docs:
            self.entries.append(doc)
            if self.index_sink is not None:
                try:
                    self.index_sink(doc)
                except Exception as e:  # noqa: BLE001
                    logger.warning("index sink failed: %s", e)
        return docs

    def app(self) -> HTTPServer:
        from .http_server import max_body_from_env

        srv = HTTPServer("request-logger", max_body_bytes=max_body_from_env())

        async def index(req: Request) -> Response:
            body = req.json()
            if not isinstance(body, dict):
                self.stats["bad"] += 1
                return Response(error_body(400, "expected a CloudEvent JSON object"), 400)
            # binary content mode: attributes ride in ce-* headers and the
            # body is the bare data payload
            if "data" not in body and "request" in body:
                body = {
                    "id": req.headers.get("ce-id", ""),
                    "source": req.headers.get("ce-source", ""),
                    "type": req.headers.get("ce-type", CE_TYPE),
                    "data": body,
                }
            docs = self.ingest(body)
            return Response({"indexed": len(docs)})

        async def entries(req: Request) -> Response:
            return Response({"entries": list(self.entries), "stats": self.stats})

        async def ping(req: Request) -> Response:
            return Response("pong", content_type="text/plain")

        srv.add_route("/", index)
        srv.add_route("/api/v0.1/index", index)
        srv.add_route("/entries", entries)
        srv.add_route("/ping", ping)
        srv.add_route("/ready", ping)
        return srv


def main(argv=None) -> None:
    import asyncio

    parser = argparse.ArgumentParser("seldon_core_tpu_torch.request_logging")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=2222)
    parser.add_argument("--capacity", type=int, default=10000)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    service = RequestLoggerApp(capacity=args.capacity)
    asyncio.run(service.app().serve_forever(args.host, args.port))


if __name__ == "__main__":
    main()
