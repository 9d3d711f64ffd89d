"""Engine CLI: boot a GraphExecutor from a predictor spec and serve.

Counterpart of ``seldon_core_tpu/engine_main.py`` (reference: the engine
Spring Boot app, engine/src/main/java/io/seldon/engine/App.java:39-107)::

    python -m seldon_core_tpu_torch.engine_main --spec graph.json

The graph comes from a ``--spec`` JSON file or the ``ENGINE_PREDICTOR``
env var (base64 JSON PredictorSpec, reference: EnginePredictor.java:58-108);
serves external REST on :8000 and gRPC on :5001 (the reference's
defaults). In-process prepackaged servers run on CUDA unless the unit
passes a ``device`` parameter of ``cpu``. gRPC needs ``grpcio``:
``--no-grpc`` serves REST alone.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os

from .graph.service import EngineApp, RequestLogger
from .graph.spec import PredictorSpec, default_predictor, validate_predictor


def load_spec(path=None) -> PredictorSpec:
    """The defaulted and validated predictor spec from ``path`` or the
    ``ENGINE_PREDICTOR`` env var."""
    if path:
        with open(path) as f:
            spec = PredictorSpec.from_dict(json.load(f))
    elif os.environ.get("ENGINE_PREDICTOR"):
        spec = PredictorSpec.from_env_b64(os.environ["ENGINE_PREDICTOR"])
    else:
        raise SystemExit("no graph: pass --spec or set ENGINE_PREDICTOR")
    spec = default_predictor(spec)
    validate_predictor(spec)
    return spec


def mesh_device(spec: PredictorSpec) -> str:
    """The device type a predictor's serving mesh spans: the ``device``
    parameter its units give (the tests' ``cpu``), else CUDA."""
    stack = [spec.graph]
    while stack:
        unit = stack.pop()
        for p in unit.parameters:
            if p.name == "device" and p.value:
                return str(p.value)
        stack.extend(unit.children)
    return "cuda"


def build_mesh(spec: PredictorSpec):
    """The serving mesh of a predictor's ``tpuMesh`` (None without one):
    a standalone engine process spans its own host's devices."""
    if not spec.tpu_mesh:
        return None
    from .parallel.mesh import make_serving_mesh

    return make_serving_mesh(spec.tpu_mesh, device=mesh_device(spec))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("seldon_core_tpu_torch.engine_main")
    parser.add_argument("--spec", help="path to predictor spec JSON (else ENGINE_PREDICTOR b64 env)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--http-port", type=int, default=int(os.environ.get("ENGINE_SERVER_PORT", 8000)))
    parser.add_argument("--grpc-port", type=int, default=int(os.environ.get("ENGINE_SERVER_GRPC_PORT", 5001)))
    parser.add_argument("--no-grpc", action="store_true")
    parser.add_argument("--log-level", default=os.environ.get("SELDON_LOG_LEVEL", "INFO"))
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )

    from .tracing import init_tracer

    init_tracer("seldon-torch-engine")  # enabled iff TRACING env set
    spec = load_spec(args.spec)
    app = EngineApp(spec, request_logger=RequestLogger.from_env(), mesh=build_mesh(spec))
    try:
        asyncio.run(app.serve(args.host, args.http_port, None if args.no_grpc else args.grpc_port))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
