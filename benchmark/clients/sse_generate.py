"""Client of the engine's SSE generate route (``POST /api/v0.1/generate``).

One connection per request, as a streaming client opens it: the JSON
body, then a chunked ``text/event-stream`` of ``data: {"tokens": [...]}``
events and a last ``data: {"done": true, "tokens": [...], ...}``. Each
event's arrival time is recorded on the monotonic clock, which every
process of the machine shares. Standard library only.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Dict

PATH = "/api/v0.1/generate"


def body(plan, i: int, _params: Dict[str, Any]) -> bytes:
    """Request ``i``'s bytes (the load generator builds them all before
    the window)."""
    return json.dumps({"jsonData": {
        "prompt_tokens": plan.prompt(i), "max_new_tokens": int(plan.max_new[i]),
        "temperature": plan.temperature, "seed": 0}}).encode()


async def _read_head(reader):
    status_line = await reader.readline()
    parts = status_line.decode("latin-1").split(" ", 2)
    status = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 0
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers


async def open(host: str, port: int, params: Dict[str, Any]):
    """Nothing is shared between requests: each opens its own stream."""
    return host, port


async def close(_conn) -> None:
    return None


async def send(conn, data: bytes, rec: Dict[str, Any]) -> None:
    """Stream one request (``data``, from :func:`body`) and fill ``rec``: ``spans`` ([time, tokens] per
    token event), ``tokens`` (prompt + generated, from the last event),
    ``hit`` (its ``cache_hit_tokens``), ``done`` (time of the last event),
    or ``error`` (and ``refused`` when the server shed it with a 429)."""
    host, port = conn
    reader, writer = await asyncio.open_connection(host, port, limit=1 << 24)
    try:
        writer.write(
            f"POST {PATH} HTTP/1.1\r\nHost: {host}\r\nContent-Type: application/json\r\n"
            f"Content-Length: {len(data)}\r\nConnection: close\r\n\r\n".encode() + data)
        await writer.drain()
        status, headers = await _read_head(reader)
        if status != 200:
            n = int(headers.get("content-length", "0") or 0)
            text = (await reader.readexactly(n)) if n else await reader.read(2000)
            rec["error"] = f"HTTP {status}: {text[:300].decode('latin-1')}"
            # 429: shed before work, the server's overload answer
            rec["refused"] = status == 429
            return
        spans = rec["spans"]
        buf = b""
        while True:
            size_line = await reader.readline()
            if not size_line:
                break
            size = int(size_line.strip() or b"0", 16)
            if size == 0:
                break
            chunk = (await reader.readexactly(size + 2))[:-2]
            buf += chunk
            while b"\n\n" in buf:
                event, buf = buf.split(b"\n\n", 1)
                if not event.startswith(b"data: "):
                    continue
                now = time.monotonic()
                msg = json.loads(event[len(b"data: "):])
                if msg.get("done"):
                    rec["tokens"] = msg.get("tokens")
                    rec["hit"] = int(msg.get("cache_hit_tokens") or 0)
                    rec["done"] = now
                elif msg.get("tokens"):
                    spans.append([now, len(msg["tokens"])])
        if rec.get("done") is None:
            rec["error"] = "stream ended without its last event"
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass
