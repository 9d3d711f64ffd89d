"""The load generator's process: an open loop of requests on a schedule.

    python3 benchmark/loadgen.py     (started by benchmark/run.py)

It talks to its parent over stdin and stdout, one JSON object a line:

1. reads the job: ``{"traffic": {...}, "seed", "seconds", "vocab",
   "rate", "drain_s"}``, builds the run's plan (the traffic file's
   generator) and every request's bytes, and answers ``{"ready": true}``;
2. reads ``{"go": t0, "host", "port"}`` and sends request ``i`` at
   ``t0 + plan.t[i]`` on the monotonic clock, whether or not earlier
   requests have finished, through the traffic's client module;
3. once every request has answered, or ``drain_s`` after the window's
   close, writes ``{"records": [...]}``: per request its due time, the
   time it went out, and what its client module recorded. A request
   with no answer by then is recorded as failed.

The process imports numpy, the standard library, the generator and the
client module (``grpc`` for a gRPC client): never torch, so it never
touches the device.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` beside this file."""
    from benchmark.run import load_by_path

    return load_by_path(HERE, kind, name)


def make_plan(traffic: Dict[str, Any], seed: int, seconds: float, vocab: int, rate=None):
    gen = load_module("generators", traffic["generator"])
    return gen.plan(traffic, seed, seconds, vocab, rate=rate)


async def drive(plan, bodies, client, traffic: Dict[str, Any], host: str, port: int,
                t0: float, drain_s: float) -> List[Dict[str, Any]]:
    """Send every request of ``plan`` (``bodies[i]``, built beforehand) on
    its schedule and gather the records."""
    conn = await client.open(host, port, traffic)
    records: List[Dict[str, Any]] = []
    tasks: List[asyncio.Task] = []
    order = sorted(range(len(plan)), key=lambda i: plan.t[i])

    async def one(i: int, rec: Dict[str, Any]) -> None:
        try:
            await client.send(conn, bodies[i], rec)
        except (OSError, ValueError, asyncio.IncompleteReadError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"

    try:
        for i in order:
            due = t0 + float(plan.t[i])
            wait = due - time.monotonic()
            if wait > 0:
                await asyncio.sleep(wait)
            rec = {"i": i, "due": due, "sent": time.monotonic(), "spans": []}
            records.append(rec)
            tasks.append(asyncio.create_task(one(i, rec)))
        close_t = t0 + plan.seconds
        left = max(1.0, close_t + drain_s - time.monotonic())
        done, pending = await asyncio.wait(tasks, timeout=left)
        for t in pending:
            t.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
        for t in done:
            t.result()
        for rec in records:
            if rec.get("done") is None and "error" not in rec:
                rec["error"] = f"no answer within {drain_s:.0f} s of the window's close"
    finally:
        await client.close(conn)
    return records


def main() -> int:
    job = json.loads(sys.stdin.readline())
    traffic = job["traffic"]
    plan = make_plan(traffic, job["seed"], job["seconds"], job["vocab"], job.get("rate"))
    client = load_module("clients", traffic["client"])
    bodies = [client.body(plan, i, traffic) for i in range(len(plan))]
    print(json.dumps({"ready": True, "requests": len(plan)}), flush=True)
    line = sys.stdin.readline()
    if not line:
        return 1
    go = json.loads(line)
    records = asyncio.run(drive(plan, bodies, client, traffic, go["host"], int(go["port"]),
                                float(go["go"]), float(job.get("drain_s", 60.0))))
    sys.stdout.write(json.dumps({"records": records}) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
