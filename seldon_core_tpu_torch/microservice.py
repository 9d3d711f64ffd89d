"""Microservice CLI: serve a user component over REST, gRPC or both.

Counterpart of ``seldon_core_tpu/microservice.py``, one worker::

    python -m seldon_core_tpu_torch.microservice \
        seldon_core_tpu_torch.servers.generateserver.GenerateServer [REST|GRPC|BOTH]

imports the class, instantiates it with typed parameters from the
``PREDICTIVE_UNIT_PARAMETERS`` env JSON (``[{"name", "value", "type"}]``;
e.g. ``{"name": "device", "value": "cuda", "type": "STRING"}``), calls
``load()`` — which for the generate server warms every executable the
declared traffic needs — and only then opens the ports. REST is the
default: gRPC needs ``grpcio`` and the protobuf runtime.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import logging
import os
import sys
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


def build_user_object(interface_name: str, parameters_json: str | None = None):
    params = json.loads(
        parameters_json or os.environ.get("PREDICTIVE_UNIT_PARAMETERS", "[]")
    )
    return load_class(interface_name)(**parse_parameters(params))


async def serve_rest(user_object, host: str, port: int,
                     state: ServerState | None = None):
    app = get_rest_microservice(user_object, state)
    await app.serve_forever(host, port)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("seldon_core_tpu_torch.microservice")
    parser.add_argument("interface_name", help="module.Class of the user component")
    parser.add_argument("api_type", nargs="?", default="REST",
                        choices=["REST", "GRPC", "BOTH"])
    parser.add_argument("--service-port", type=int, default=DEFAULT_PORT)
    parser.add_argument("--grpc-port", type=int, default=DEFAULT_GRPC_PORT)
    parser.add_argument(
        "--grpc-max-message-bytes",
        type=int,
        default=int(os.environ.get("GRPC_MAX_MESSAGE_BYTES", 0)) or None,
    )
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--parameters", default=None, help="JSON list of typed parameters")
    parser.add_argument("--no-warmup", action="store_true", help="skip load() before listen")
    parser.add_argument(
        "--log-level", default=os.environ.get("SELDON_LOG_LEVEL", "INFO")
    )
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    user_object = build_user_object(args.interface_name, args.parameters)
    if not args.no_warmup and hasattr(user_object, "load"):
        logger.info("warmup: load()")
        user_object.load()
    grpc_server = None
    try:
        if args.api_type in ("GRPC", "BOTH"):
            grpc_server = get_grpc_server(
                user_object, max_message_bytes=args.grpc_max_message_bytes
            )
            grpc_server.add_insecure_port(f"{args.host}:{args.grpc_port}")
            grpc_server.start()
            logger.info("gRPC listening on %s:%d", args.host, args.grpc_port)
        if args.api_type in ("REST", "BOTH"):
            asyncio.run(serve_rest(user_object, args.host, args.service_port, ServerState()))
        else:
            grpc_server.wait_for_termination()
    except KeyboardInterrupt:
        pass
    finally:
        if grpc_server is not None:
            grpc_server.stop(grace=5)
        if hasattr(user_object, "close"):
            user_object.close()


if __name__ == "__main__":
    main()
