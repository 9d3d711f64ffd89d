"""Minimal asyncio HTTP/1.1 server for the microservice front.

A copy of ``seldon_core_tpu/http_server.py`` (the port imports nothing of
the JAX package). Supports:
keep-alive, pipelining (sequential), Content-Length bodies, JSON and
form-encoded (``json=``) request bodies, and query-string ``?json=`` GETs
for reference-client compatibility
(reference: engine/.../service/InternalPredictionService.java:364-453 posts
form-encoded ``json=``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import traceback
from typing import Awaitable, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlsplit

logger = logging.getLogger(__name__)

Handler = Callable[["Request"], Awaitable["Response"]]

_STATUS_TEXT = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    408: "Request Timeout",
    413: "Payload Too Large",
    429: "Too Many Requests",
    500: "Internal Server Error",
    501: "Not Implemented",
    502: "Bad Gateway",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}

# Request bodies are buffered in memory before dispatch, so an unbounded
# Content-Length is an OOM vector; the reference caps engine payloads the
# same way (InternalPredictionService.java:82-91 message-size annotations).
# Overridable per server via ``seldon.io/rest-max-body``.
DEFAULT_MAX_BODY_BYTES = 64 * 1024 * 1024


def max_body_from_env(default: int = DEFAULT_MAX_BODY_BYTES) -> int:
    """``SELDON_REST_MAX_BODY`` for servers with no predictor annotations
    (wrapper, gateway, request logger). Non-positive or junk values fall
    back to the default, matching the native engine's g_max_body_bytes."""
    import os

    try:
        v = int(os.environ["SELDON_REST_MAX_BODY"])
    except (KeyError, ValueError):
        return default
    return v if v > 0 else default


class Request:
    __slots__ = ("method", "path", "query", "headers", "body")

    def __init__(self, method: str, path: str, query: str, headers: Dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.body = body

    def params(self) -> Dict[str, str]:
        """Query string as a flat dict (last value wins per key)."""
        if not self.query:
            return {}
        return {k: v[-1] for k, v in parse_qs(self.query).items()}

    def int_param(self, key: str) -> Optional[int]:
        """One integer query param, or None when absent/malformed."""
        try:
            return int(self.params()[key])
        except (KeyError, TypeError, ValueError):
            return None

    def json(self):
        """Decode the payload: JSON body, form-encoded ``json=``, query
        ``json=``, or multipart/form-data (reference: the engine accepts
        multipart predictions, RestClientController.java:136-206 — parts
        named after SeldonMessage fields: json, jsonData, strData,
        binData)."""
        ctype = self.headers.get("content-type", "")
        if self.body:
            if ctype.startswith("application/x-www-form-urlencoded"):
                form = parse_qs(self.body.decode("utf-8"))
                if "json" in form:
                    return json.loads(form["json"][0])
                raise ValueError("form body missing json field")
            if ctype.startswith("multipart/form-data"):
                return self._multipart_message(ctype)
            return json.loads(self.body)
        if self.query:
            q = parse_qs(self.query)
            if "json" in q:
                return json.loads(q["json"][0])
        return None

    def _multipart_message(self, ctype: str):
        import base64
        import re

        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            raise ValueError("multipart body missing boundary")
        delim = b"\r\n--" + m.group(1).encode()
        parts: Dict[str, bytes] = {}
        # a part's payload ends EXACTLY at the CRLF preceding the next
        # boundary — splitting on that delimiter keeps payloads byte-exact
        # (strip()-style trimming would eat a binData's own trailing \n).
        # Prepending CRLF makes the first boundary match the same pattern.
        for chunk in (b"\r\n" + self.body).split(delim)[1:]:
            if chunk.startswith(b"--"):
                break  # closing boundary
            if chunk.startswith(b"\r\n"):
                chunk = chunk[2:]
            head, sep, payload = chunk.partition(b"\r\n\r\n")
            if not sep:
                continue  # malformed part (no header/body separator)
            # require a preceding separator so `filename="..."` can never
            # satisfy the match when it appears before `name=` (RFC 7578
            # fixes no parameter order) — mirrors the native engine's parser
            nm = re.search(rb'(?:^|[;\s])name="([^"]+)"', head)
            if nm:
                parts[nm.group(1).decode("latin-1")] = payload
        if "json" in parts:  # a whole SeldonMessage as one part
            return json.loads(parts["json"])
        msg: Dict[str, object] = {}
        if "jsonData" in parts:
            msg["jsonData"] = json.loads(parts["jsonData"])
        elif "strData" in parts:
            msg["strData"] = parts["strData"].decode("utf-8")
        elif "binData" in parts:
            msg["binData"] = base64.b64encode(parts["binData"]).decode("ascii")
        elif "data" in parts:
            msg["data"] = json.loads(parts["data"])
        if not msg:
            raise ValueError(
                "multipart body has no json/jsonData/strData/binData/data part"
            )
        if "meta" in parts:
            msg["meta"] = json.loads(parts["meta"])
        return msg


def _json_default(obj):
    """bytes -> base64 string, the proto-JSON convention: interior message
    dicts may carry raw tensor bytes (payload.proto_to_json fast path)."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        import base64

        return base64.b64encode(bytes(obj)).decode("ascii")
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


class Response:
    __slots__ = ("status", "body", "content_type", "headers")

    def __init__(self, body, status: int = 200, content_type: str = "application/json",
                 headers: Optional[Dict[str, str]] = None):
        if isinstance(body, (dict, list)):
            body = json.dumps(body, separators=(",", ":"), default=_json_default).encode()
        elif isinstance(body, str):
            body = body.encode()
        self.body = body or b""
        self.status = status
        self.content_type = content_type
        self.headers = headers

    def encode(self, keep_alive: bool) -> bytes:
        reason = _STATUS_TEXT.get(self.status, "Unknown")
        conn = "keep-alive" if keep_alive else "close"
        extra = ""
        if self.headers:
            extra = "".join(f"{k}: {v}\r\n" for k, v in self.headers.items())
        head = (
            f"HTTP/1.1 {self.status} {reason}\r\n"
            f"Content-Type: {self.content_type}\r\n"
            f"Content-Length: {len(self.body)}\r\n"
            f"{extra}"
            f"Connection: {conn}\r\n\r\n"
        )
        return head.encode() + self.body


class StreamingResponse:
    """Chunked-transfer response driven by a (possibly blocking) iterator
    of byte chunks — the server pulls items on the default executor so a
    queue-backed generator (SSE token streaming) never blocks the event
    loop. The connection closes after the stream (simplest correct
    keep-alive story for a body of unknown length)."""

    __slots__ = ("iterator", "status", "content_type", "on_abort")

    def __init__(self, iterator, status: int = 200,
                 content_type: str = "text/event-stream", on_abort=None):
        self.iterator = iterator
        self.status = status
        self.content_type = content_type
        # called when the client goes away mid-stream (disconnect): gives
        # the producer a chance to cancel upstream work so the iterator
        # can finish (and its finally blocks run) instead of lingering
        self.on_abort = on_abort

    def head(self) -> bytes:
        reason = _STATUS_TEXT.get(self.status, "Unknown")
        return (
            f"HTTP/1.1 {self.status} {reason}\r\n"
            f"Content-Type: {self.content_type}\r\n"
            f"Transfer-Encoding: chunked\r\n"
            f"Connection: close\r\n\r\n"
        ).encode()


class HTTPServer:
    """Exact-path router + asyncio serve loop."""

    def __init__(
        self,
        name: str = "http",
        max_body_bytes: Optional[int] = DEFAULT_MAX_BODY_BYTES,
        read_timeout_s: Optional[float] = None,
    ):
        self.name = name
        self.routes: Dict[str, Handler] = {}
        self.prefix_routes: Dict[str, Handler] = {}
        self.max_body_bytes = max_body_bytes
        # slowloris guard: cap the wall-clock wait for a request's bytes
        # once the first header byte could have arrived
        self.read_timeout_s = read_timeout_s
        # optional admission hook, called with (method, path, headers) BEFORE
        # the body is read: returning a Response answers immediately and the
        # body is chunk-discarded unparsed. An overloaded server must shed
        # load from the headers — receiving + parsing a few-hundred-KB body
        # per rejected retry turns the 429 path itself into the bottleneck.
        self.early_gate: Optional[Any] = None
        self._server: Optional[asyncio.AbstractServer] = None

    def route(self, path: str):
        def deco(fn: Handler) -> Handler:
            self.routes[path] = fn
            return fn

        return deco

    def add_route(self, path: str, fn: Handler) -> None:
        self.routes[path] = fn

    def add_prefix_route(self, prefix: str, fn: Handler) -> None:
        """Route every path under `prefix` (longest prefix wins)."""
        self.prefix_routes[prefix] = fn

    async def _dispatch(self, req: Request) -> Response:
        handler = self.routes.get(req.path)
        if handler is None and self.prefix_routes:
            for prefix in sorted(self.prefix_routes, key=len, reverse=True):
                if req.path.startswith(prefix):
                    handler = self.prefix_routes[prefix]
                    break
        if handler is None:
            return Response({"status": {"info": f"no route {req.path}", "code": 404, "status": "FAILURE"}}, 404)
        try:
            return await handler(req)
        except (ValueError, KeyError) as e:
            return Response(error_body(400, str(e)), 400)
        except Exception as e:  # surface the traceback for debuggability
            logger.error("handler %s failed: %s\n%s", req.path, e, traceback.format_exc())
            return Response(error_body(500, f"{type(e).__name__}: {e}"), 500)

    async def _bail(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, resp: Response):
        """Terminal error response on a connection that will close with
        request bytes possibly still inbound (oversized/stalled body).
        Flush the response, then absorb a bounded amount of the unread
        body — closing with unread data in the kernel buffer RSTs the
        socket and can destroy the response before the client reads it."""
        writer.write(resp.encode(False))
        try:
            await writer.drain()
            loop = asyncio.get_running_loop()
            # wall-clock-bounded (not byte-capped) drain: chunks are
            # discarded so memory is constant, the deadline bounds CPU,
            # and a byte cap would reintroduce the RST for any fast
            # sender past it (a real 64MB upload clears in well under 1s
            # on loopback/datacenter links)
            deadline = loop.time() + 1.0
            while loop.time() < deadline:
                chunk = await asyncio.wait_for(reader.read(65536), 0.5)
                if not chunk:
                    break
        except (asyncio.TimeoutError, ConnectionError, OSError):
            pass

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                try:
                    if self.read_timeout_s:
                        # slowloris guard doubling as the keep-alive idle
                        # reaper: a connection that can't produce a full
                        # header block in time is closed (silently — an
                        # idle keep-alive conn isn't an error)
                        header_blob = await asyncio.wait_for(
                            reader.readuntil(b"\r\n\r\n"), self.read_timeout_s
                        )
                    else:
                        header_blob = await reader.readuntil(b"\r\n\r\n")
                except (asyncio.TimeoutError, asyncio.IncompleteReadError, ConnectionResetError):
                    break
                except asyncio.LimitOverrunError:
                    await self._bail(reader, writer, Response(error_body(400, "headers too large"), 400))
                    break
                lines = header_blob.decode("latin-1").split("\r\n")
                try:
                    method, target, _version = lines[0].split(" ", 2)
                except ValueError:
                    await self._bail(reader, writer, Response(error_body(400, "bad request line"), 400))
                    break
                headers: Dict[str, str] = {}
                for line in lines[1:]:
                    if not line:
                        continue
                    k, _, v = line.partition(":")
                    headers[k.strip().lower()] = v.strip()
                try:
                    length = int(headers.get("content-length", 0))
                except ValueError:
                    length = -1
                if length < 0:
                    await self._bail(reader, writer, Response(error_body(400, "bad Content-Length"), 400))
                    break
                if self.max_body_bytes is not None and length > self.max_body_bytes:
                    # reject before reading: never buffer an oversized body
                    await self._bail(
                        reader,
                        writer,
                        Response(
                            error_body(
                                413,
                                f"body {length} bytes exceeds limit "
                                f"{self.max_body_bytes}",
                            ),
                            413,
                        ),
                    )
                    break
                if self.early_gate is not None:
                    parts0 = urlsplit(target)
                    gate_resp = self.early_gate(
                        method, unquote(parts0.path), headers
                    )
                    if gate_resp is not None:
                        keep = headers.get("connection", "keep-alive").lower() != "close"
                        try:
                            remaining = length
                            # discard, never buffer — under the same
                            # slowloris guard as the real body read (a
                            # trickled body must not hold the fd open)
                            deadline = (
                                asyncio.get_running_loop().time()
                                + (self.read_timeout_s or 30.0)
                            )
                            while remaining > 0:
                                budget = deadline - asyncio.get_running_loop().time()
                                if budget <= 0:
                                    keep = False
                                    break
                                chunk = await asyncio.wait_for(
                                    reader.read(min(65536, remaining)), budget
                                )
                                if not chunk:
                                    keep = False
                                    break
                                remaining -= len(chunk)
                            writer.write(gate_resp.encode(keep))
                            await writer.drain()
                        except (asyncio.TimeoutError, ConnectionError, OSError):
                            break
                        if not keep:
                            break
                        continue
                try:
                    if length and self.read_timeout_s:
                        body = await asyncio.wait_for(
                            reader.readexactly(length), self.read_timeout_s
                        )
                    else:
                        body = await reader.readexactly(length) if length else b""
                except asyncio.TimeoutError:
                    await self._bail(
                        reader, writer, Response(error_body(408, "body read timed out"), 408)
                    )
                    break
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                parts = urlsplit(target)
                req = Request(method, unquote(parts.path), parts.query, headers, body)
                keep = headers.get("connection", "keep-alive").lower() != "close"
                resp = await self._dispatch(req)
                if isinstance(resp, StreamingResponse):
                    loop = asyncio.get_running_loop()
                    it = iter(resp.iterator)
                    sentinel = object()
                    try:
                        writer.write(resp.head())
                        await writer.drain()
                        while True:
                            chunk = await loop.run_in_executor(None, next, it, sentinel)
                            if chunk is sentinel:
                                break
                            if not chunk:
                                continue
                            writer.write(
                                f"{len(chunk):x}\r\n".encode() + bytes(chunk) + b"\r\n"
                            )
                            await writer.drain()
                        writer.write(b"0\r\n\r\n")
                        await writer.drain()
                    except (ConnectionError, OSError, asyncio.CancelledError):
                        # client went away mid-stream: cancel upstream work,
                        # then drain the iterator on the executor so its
                        # finally blocks (in-flight gauges, lane release)
                        # run promptly instead of at GC time
                        if resp.on_abort is not None:
                            try:
                                resp.on_abort()
                            except Exception:  # noqa: BLE001
                                logger.exception("stream abort hook failed")

                        def _drain(iterator=it):
                            # BaseException: a cancelled request surfaces
                            # concurrent.futures.CancelledError (a
                            # BaseException since 3.8) from the iterator
                            try:
                                for _ in iterator:
                                    pass
                            except BaseException:  # noqa: BLE001
                                pass
                            try:
                                iterator.close()
                            except BaseException:  # noqa: BLE001
                                pass

                        loop.run_in_executor(None, _drain)
                    break  # Connection: close after a chunked stream
                writer.write(resp.encode(keep))
                await writer.drain()
                if not keep:
                    break
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def start(self, host: str, port: int, reuse_port: bool = False):
        # reuse_port: multiple worker processes share one listening port
        # (the kernel load-balances accepts — the no-fork multi-worker model)
        self._server = await asyncio.start_server(
            self._handle_conn, host, port, limit=64 * 1024 * 1024,
            reuse_port=reuse_port or None,
        )
        logger.info("%s listening on %s:%d", self.name, host, port)
        return self._server

    async def serve_forever(self, host: str, port: int, reuse_port: bool = False):
        await self.start(host, port, reuse_port=reuse_port)
        await self.serve()

    async def serve(self):
        """Serve on an already-``start()``-ed listener. Callers that must
        guarantee the socket is bound before advertising readiness (the
        component runtime) await ``start()`` first, then run this in a
        task."""
        # no `async with`: its __aexit__ AWAITS wait_closed(), which blows
        # up with "coroutine ignored GeneratorExit" when the coroutine is
        # garbage-collected mid-suspend (event loop stopped under it) —
        # the synchronous close() is all the cleanup needed
        try:
            await self._server.serve_forever()
        finally:
            self._server.close()

    def is_serving(self) -> bool:
        return self._server is not None and self._server.is_serving()

    def close(self):
        if self._server is not None:
            self._server.close()


def error_body(code: int, info: str) -> dict:
    return {"status": {"code": code, "info": info, "status": "FAILURE"}}
