"""General load tester: multi-process REST/gRPC load against any endpoint.

Counterpart of ``seldon_core_tpu/loadtester.py`` and of the reference's
locust-based load suite (reference:
util/loadtester/scripts/predict_rest_locust.py, mnist_grpc_locust.py +
helm chart seldon-core-loadtesting): worker processes hammer a target
with contract-generated or fixed payloads and the parent aggregates into
the table format the reference published (reference:
doc/source/reference/benchmarking.md:33-64 — #reqs, #fails,
Avg/Min/Max/Median, req/s, percentiles).

Usage::

    python -m seldon_core_tpu_torch.loadtester http://HOST:8000 \
        --workers 4 --clients-per-worker 8 --seconds 10 \
        [--contract contract.json | --ndarray '[[1.0,2.0]]' | --body-file body.json] \
        [--transport grpc] [--path /api/v0.1/predictions] [--binary]

``--body-file`` takes a whole SeldonMessage JSON from a file: a request
too large for one command-line argument (a batch of 224x224 images as a
``raw`` tensor) goes there.

Workers are separate PROCESSES (fork) so the load generator is not
GIL-bound the way a threaded client would be. Each worker runs
``clients_per_worker`` threads of closed-loop requests and reports
(latencies, counts) over a pipe. The workers import neither torch nor
CUDA: fork a process that holds a CUDA context only through a
subprocess of its own (``python -m seldon_core_tpu_torch.loadtester``).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

PERCENTILES = (50, 66, 75, 80, 90, 95, 98, 99, 100)


def build_payload(args_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Request body from a contract (random batch per the contract's
    feature spec), a SeldonMessage JSON file or a fixed ndarray literal."""
    if args_dict.get("body_file"):
        with open(args_dict["body_file"]) as f:
            return json.load(f)
    if args_dict.get("contract"):
        from .tester import feature_names, generate_batch, unfold_contract

        with open(args_dict["contract"]) as f:
            contract = unfold_contract(json.load(f))
        batch = generate_batch(contract, args_dict.get("batch", 1))
        return {
            "data": {
                "names": feature_names(contract),
                "ndarray": batch.tolist(),
            }
        }
    nd = json.loads(args_dict.get("ndarray") or "[[1.0]]")
    return {"data": {"ndarray": nd}}


def _worker_proc(args_dict: Dict[str, Any], conn) -> None:
    """One load worker process: N client threads in a closed loop."""
    target = args_dict["target"]
    seconds = args_dict["seconds"]
    n_threads = args_dict["clients_per_worker"]
    transport = args_dict["transport"]
    path = args_dict["path"]
    body = build_payload(args_dict)

    latencies: List[float] = []
    fails = [0]
    lock = threading.Lock()

    if transport == "grpc":
        import grpc

        from .payload import json_to_proto
        from .proto import prediction_pb2 as pb
        from .proto.services import method_path

        request = json_to_proto(body).SerializeToString()
        host = target.replace("http://", "").replace("https://", "").rstrip("/")

        def make_call():
            channel = grpc.insecure_channel(host)
            rpc = channel.unary_unary(
                method_path("Seldon", "Predict"),
                request_serializer=lambda b: b,
                response_deserializer=pb.SeldonMessage.FromString,
            )

            def call():
                rpc(request, timeout=args_dict["timeout"])

            return call

    else:
        import http.client
        from urllib.parse import urlparse

        parsed = urlparse(target if "//" in target else f"http://{target}")
        tls = parsed.scheme == "https"
        if args_dict.get("binary"):
            from .payload import json_to_proto

            raw_body = json_to_proto(body).SerializeToString()
            headers = {"Content-Type": "application/x-protobuf"}
        else:
            raw_body = json.dumps(body).encode()
            headers = {"Content-Type": "application/json"}

        def make_call():
            conn_cls = http.client.HTTPSConnection if tls else http.client.HTTPConnection
            conn_http = conn_cls(
                parsed.hostname, parsed.port or (443 if tls else 80),
                timeout=args_dict["timeout"],
            )

            def call():
                conn_http.request("POST", path, raw_body, headers)
                resp = conn_http.getresponse()
                resp.read()
                if resp.status >= 400:
                    raise RuntimeError(f"HTTP {resp.status}")

            return call

    stop_at = time.perf_counter() + seconds

    def run():
        try:
            call = make_call()
        except Exception:
            with lock:
                fails[0] += 1
            return
        while time.perf_counter() < stop_at:
            t0 = time.perf_counter()
            try:
                call()
            except Exception:
                with lock:
                    fails[0] += 1
                try:
                    call = make_call()  # reconnect after an error
                except Exception:
                    time.sleep(0.1)
                continue
            with lock:
                latencies.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=run, daemon=True) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + args_dict["timeout"] + 5)
    conn.send((latencies, fails[0]))
    conn.close()


def aggregate(results: List[tuple], elapsed: float, name: str) -> Dict[str, Any]:
    lat: List[float] = []
    fails = 0
    for worker_lat, worker_fails in results:
        lat.extend(worker_lat)
        fails += worker_fails
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    n = len(lat_ms)
    stats: Dict[str, Any] = {
        "name": name,
        "requests": n,
        "failures": fails,
        "rps": round(n / elapsed, 2) if elapsed else 0.0,
        "avg_ms": round(float(lat_ms.mean()), 2) if n else None,
        "min_ms": round(float(lat_ms[0]), 2) if n else None,
        "max_ms": round(float(lat_ms[-1]), 2) if n else None,
        "median_ms": round(float(lat_ms[n // 2]), 2) if n else None,
    }
    for p in PERCENTILES:
        idx = min(n - 1, int(n * p / 100.0)) if n else 0
        stats[f"p{p}_ms"] = round(float(lat_ms[idx]), 2) if n else None
    return stats


def format_table(stats: Dict[str, Any]) -> str:
    """The reference's two benchmark tables (benchmarking.md:33-64)."""
    head = (
        f"{'Name':<10}{'# reqs':>10}{'# fails':>10}{'Avg':>8}{'Min':>8}"
        f"{'Max':>10}{'Median':>8}{'req/s':>10}\n"
        f"{stats['name']:<10}{stats['requests']:>10}{stats['failures']:>10}"
        f"{stats['avg_ms'] or 0:>8.0f}{stats['min_ms'] or 0:>8.0f}"
        f"{stats['max_ms'] or 0:>10.0f}{stats['median_ms'] or 0:>8.0f}"
        f"{stats['rps']:>10.2f}\n"
    )
    pct_head = "".join(f"{'p' + str(p) + '%':>8}" for p in PERCENTILES)
    pct_row = "".join(f"{stats['p' + str(p) + '_ms'] or 0:>8.0f}" for p in PERCENTILES)
    return head + pct_head + "\n" + pct_row


def run_load(
    target: str,
    workers: int = 2,
    clients_per_worker: int = 8,
    seconds: float = 10.0,
    transport: str = "rest",
    path: str = "/api/v0.1/predictions",
    contract: Optional[str] = None,
    ndarray: Optional[str] = None,
    body_file: Optional[str] = None,
    batch: int = 1,
    binary: bool = False,
    timeout: float = 10.0,
    name: str = "predict",
) -> Dict[str, Any]:
    args_dict = dict(
        target=target, seconds=seconds, clients_per_worker=clients_per_worker,
        transport=transport, path=path, contract=contract, ndarray=ndarray,
        body_file=body_file, batch=batch, binary=binary, timeout=timeout,
    )
    ctx = mp.get_context("fork")
    pipes, procs = [], []
    t0 = time.perf_counter()
    for _ in range(workers):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_worker_proc, args=(args_dict, child), daemon=True)
        p.start()
        pipes.append(parent)
        procs.append(p)
    results = []
    for parent, p in zip(pipes, procs):
        if parent.poll(seconds + timeout + 30):
            results.append(parent.recv())
        else:
            results.append(([], clients_per_worker))
        p.join(timeout=5)
    elapsed = time.perf_counter() - t0
    return aggregate(results, elapsed, name)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("seldon-tpu-torch-loadtester")
    parser.add_argument("target", help="http://host:port (REST) or host:port (gRPC)")
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--clients-per-worker", type=int, default=8)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--transport", choices=("rest", "grpc"), default="rest")
    parser.add_argument("--path", default="/api/v0.1/predictions")
    parser.add_argument("--contract", help="contract JSON for generated payloads")
    parser.add_argument("--ndarray", help="fixed JSON ndarray payload")
    parser.add_argument("--body-file",
                        help="fixed SeldonMessage JSON payload read from a file")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--binary", action="store_true",
                        help="REST body as binary protobuf (raw tensors, no b64)")
    parser.add_argument("--timeout", type=float, default=10.0)
    parser.add_argument("--json", action="store_true", help="print JSON, not the table")
    args = parser.parse_args(argv)
    stats = run_load(
        args.target, workers=args.workers,
        clients_per_worker=args.clients_per_worker, seconds=args.seconds,
        transport=args.transport, path=args.path, contract=args.contract,
        ndarray=args.ndarray, body_file=args.body_file, batch=args.batch, binary=args.binary,
        timeout=args.timeout,
    )
    print(json.dumps(stats) if args.json else format_table(stats))


if __name__ == "__main__":
    main()
