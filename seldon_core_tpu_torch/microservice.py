"""Microservice CLI: serve a user component over REST, gRPC, both, or FBS.

Counterpart of ``seldon_core_tpu/microservice.py``::

    python -m seldon_core_tpu_torch.microservice \
        seldon_core_tpu_torch.servers.generateserver.GenerateServer [REST|GRPC|BOTH|FBS]

imports the class, instantiates it with typed parameters from the
``PREDICTIVE_UNIT_PARAMETERS`` env JSON (``[{"name", "value", "type"}]``;
e.g. ``{"name": "device", "value": "cuda", "type": "STRING"}``), calls
``load()`` — which for the generate server warms every executable the
declared traffic needs — and only then opens the ports. ``BOTH`` is the
default, as in the JAX package: gRPC needs ``grpcio`` and the protobuf
runtime, and where they do not import, ``BOTH`` and ``GRPC`` fail at
start with the ImportError (pass ``REST`` to serve without them).
``FBS`` serves the length-prefixed flatbuffers transport (``fbs.py``) on
``--service-port``.

* ``--persistence`` restores the component from ``--persistence-dir`` on
  boot and snapshots it every ``--persistence-frequency`` seconds, and
  once more at shutdown (``persistence.py``).
* ``--workers N`` runs N worker processes sharing the service port via
  SO_REUSEPORT. Each is a fresh ``python -m
  seldon_core_tpu_torch.microservice`` process, never a fork: the parent
  builds no user object, so it never initialises CUDA, and each worker
  boots its own CUDA context and holds its own copy of the model. The
  parent forwards SIGTERM/SIGINT and exits with the first non-zero
  status. ``--workers`` with ``--persistence`` is refused.

A worker (or a single process) ends on SIGTERM through its clean
shutdown: the gRPC server stops, the user object's ``close()`` runs, the
final snapshot is pushed, and the process exits 0.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import logging
import os
import signal
import sys
import threading
from typing import Any, Dict, List

from .wrapper import ServerState, get_grpc_server, get_rest_microservice

logger = logging.getLogger(__name__)

DEFAULT_PORT = int(os.environ.get("PREDICTIVE_UNIT_SERVICE_PORT", 9000))
DEFAULT_GRPC_PORT = int(os.environ.get("PREDICTIVE_UNIT_GRPC_PORT", 9500))

_TYPE_CASTS = {
    "STRING": str,
    "INT": int,
    "FLOAT": float,
    "DOUBLE": float,
    "BOOL": lambda v: v if isinstance(v, bool) else str(v).lower() == "true",
}


def parse_parameters(params: List[Dict[str, Any]]) -> Dict[str, Any]:
    """[{name,value,type}] -> kwargs."""
    out: Dict[str, Any] = {}
    for p in params or []:
        name = p["name"]
        cast = _TYPE_CASTS.get(str(p.get("type", "STRING")).upper())
        if cast is None:
            raise ValueError(f"unknown parameter type {p.get('type')!r} for {name}")
        out[name] = cast(p["value"])
    return out


def load_class(interface_name: str):
    """'pkg.mod.Class' or 'Mod' (class == module name)."""
    if "." in interface_name:
        module_name, cls_name = interface_name.rsplit(".", 1)
    else:
        module_name = cls_name = interface_name
    sys.path.insert(0, os.getcwd())
    module = importlib.import_module(module_name)
    return getattr(module, cls_name)


def resolve_user_class(interface_name: str, parameters_json: str | None = None):
    """(class, parsed-parameter dict): the one boot path of both the plain
    and the --persistence modes."""
    params = json.loads(
        parameters_json or os.environ.get("PREDICTIVE_UNIT_PARAMETERS", "[]")
    )
    return load_class(interface_name), parse_parameters(params)


def build_user_object(interface_name: str, parameters_json: str | None = None):
    cls, params = resolve_user_class(interface_name, parameters_json)
    return cls(**params)


async def serve_rest(user_object, host: str, port: int,
                     state: ServerState | None = None, reuse_port: bool = False):
    app = get_rest_microservice(user_object, state)
    await app.serve_forever(host, port, reuse_port=reuse_port)


def _spawn_workers(n: int, argv: List[str]) -> int:
    """Parent mode for --workers N: spawn N fresh CLI processes (each with
    --workers 1 --reuse-port), forward termination, exit with the first
    non-zero status."""
    import signal
    import subprocess

    # strip "--workers N" / "--workers=N" so children run single-worker
    cleaned: List[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--workers":
            skip = True
            continue
        if a.startswith("--workers="):
            continue
        cleaned.append(a)
    cmd = [sys.executable, "-m", "seldon_core_tpu_torch.microservice", *cleaned,
           "--workers", "1", "--reuse-port"]
    procs = [subprocess.Popen(cmd) for _ in range(n)]
    logger.info("spawned %d workers (SO_REUSEPORT)", n)

    def forward(signum, _frame):
        for p in procs:
            p.send_signal(signum)

    signal.signal(signal.SIGTERM, forward)
    signal.signal(signal.SIGINT, forward)
    code = 0
    for p in procs:
        p.wait()
        code = code or p.returncode
    return code


def _interrupt(_signum, _frame):
    raise KeyboardInterrupt


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("seldon_core_tpu_torch.microservice")
    parser.add_argument("interface_name", help="module.Class of the user component")
    parser.add_argument("api_type", nargs="?", default="BOTH",
                        choices=["REST", "GRPC", "BOTH", "FBS"])
    parser.add_argument("--service-port", type=int, default=DEFAULT_PORT)
    parser.add_argument("--grpc-port", type=int, default=DEFAULT_GRPC_PORT)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--parameters", default=None, help="JSON list of typed parameters")
    parser.add_argument("--no-warmup", action="store_true", help="skip load() before listen")
    parser.add_argument(
        "--log-level", default=os.environ.get("SELDON_LOG_LEVEL", "INFO")
    )
    parser.add_argument(
        "--grpc-max-message-bytes",
        type=int,
        default=int(os.environ.get("GRPC_MAX_MESSAGE_BYTES", 0)) or None,
    )
    parser.add_argument(
        "--persistence",
        action="store_true",
        help="restore component state on boot and snapshot it periodically",
    )
    parser.add_argument(
        "--persistence-dir",
        default=os.environ.get("SELDON_PERSISTENCE_DIR", "/tmp/seldon-state"),
    )
    parser.add_argument(
        "--persistence-frequency",
        type=float,
        default=float(os.environ.get("SELDON_PERSISTENCE_FREQUENCY", 60)),
    )
    parser.add_argument(
        "--workers", type=int,
        default=int(os.environ.get("SELDON_WORKERS", 1)),
        help="worker processes sharing the ports via SO_REUSEPORT "
        "(spawned fresh, never forked; each holds its own copy of the model)",
    )
    parser.add_argument("--reuse-port", action="store_true",
                        help=argparse.SUPPRESS)  # set internally on workers
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if args.workers > 1:
        if args.persistence:
            # N workers restoring from and pushing to ONE state file would
            # clobber each other (last-writer-wins, cross-process tmp race)
            raise SystemExit(
                "--workers > 1 cannot be combined with --persistence: "
                "workers would overwrite each other's snapshots; run one "
                "worker or give each its own service"
            )
        raise SystemExit(_spawn_workers(args.workers, list(argv or sys.argv[1:])))

    from .tracing import init_tracer

    component = args.interface_name.rsplit(".", 1)[-1]
    init_tracer(component)  # enabled iff the TRACING env is set

    persistence_thread = None
    if args.persistence:
        from . import persistence

        cls, params = resolve_user_class(args.interface_name, args.parameters)
        key = persistence.state_key(component)
        user_object = persistence.restore(cls, params, args.persistence_dir, key)
        persistence_thread = persistence.PersistenceThread(
            user_object, args.persistence_dir, key, args.persistence_frequency
        )
        persistence_thread.start()
    else:
        user_object = build_user_object(args.interface_name, args.parameters)
    if not args.no_warmup and hasattr(user_object, "load"):
        logger.info("warmup: load()")
        user_object.load()
    on_main = threading.current_thread() is threading.main_thread()
    if on_main:
        # SIGTERM (a worker's parent, an orchestrator) takes the clean
        # shutdown below, as Ctrl-C does
        prev_sigterm = signal.signal(signal.SIGTERM, _interrupt)
    grpc_server = None
    try:
        if args.api_type in ("GRPC", "BOTH"):
            grpc_server = get_grpc_server(
                user_object, max_message_bytes=args.grpc_max_message_bytes
            )
            grpc_server.add_insecure_port(f"{args.host}:{args.grpc_port}")
            grpc_server.start()
            logger.info("gRPC listening on %s:%d", args.host, args.grpc_port)
        if args.api_type == "FBS":
            from .fbs import FBSServer

            fbs_server = FBSServer(
                user_object, host=args.host, port=args.service_port,
                reuse_port=args.reuse_port,
            ).start()
            logger.info("FBS listening on %s:%d", args.host, args.service_port)
            try:
                threading.Event().wait()
            finally:
                fbs_server.close()
        elif args.api_type in ("REST", "BOTH"):
            asyncio.run(serve_rest(user_object, args.host, args.service_port,
                                   ServerState(), reuse_port=args.reuse_port))
        else:
            grpc_server.wait_for_termination()
    except KeyboardInterrupt:
        pass
    finally:
        if grpc_server is not None:
            grpc_server.stop(grace=5)
        if hasattr(user_object, "close"):
            user_object.close()
        if persistence_thread is not None:
            persistence_thread.stop(final_push=True)
        if on_main:
            signal.signal(signal.SIGTERM, prev_sigterm)


if __name__ == "__main__":
    main()
