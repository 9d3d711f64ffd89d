"""Hosting the program's inference-graph engine for one run.

The engine (``seldon_core_tpu_torch.graph.service.EngineApp``) is built
from a one-unit predictor spec, as ``engine_main`` builds it from a spec
file, and its fronts listen on ephemeral ports of 127.0.0.1 (port 0:
the kernel picks a free one). The fronts' asyncio loop runs in a thread
of this process; the load generator is another process.
"""

from __future__ import annotations

import asyncio
import json
import os
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional


def typed_params(params: Dict[str, Any]) -> List[Dict[str, str]]:
    """A unit's parameters as the spec writes them: ints as INT, lists as
    comma-separated STRINGs, the rest as STRING."""
    out = []
    for k, v in params.items():
        if isinstance(v, int):
            out.append({"name": k, "value": str(v), "type": "INT"})
        elif isinstance(v, (list, tuple)):
            out.append({"name": k, "value": ",".join(str(x) for x in v), "type": "STRING"})
        else:
            out.append({"name": k, "value": str(v), "type": "STRING"})
    return out


def model_dir(family: str, model: Dict[str, Any], seed: int) -> str:
    """A model directory the program's servers read (``jax_config.json``
    without a checkpoint: the weights are drawn from ``seed`` on the
    device at load). Under ``TMPDIR``; a few hundred bytes."""
    root = tempfile.mkdtemp(prefix="bench-model-")
    with open(os.path.join(root, "jax_config.json"), "w") as f:
        json.dump({"family": family, "config": {**model, "seed": int(seed)}}, f)
    return root


def user_object(cls: str, model_uri: str, params: Dict[str, Any]):
    """The program's server class built from typed parameters, as the
    microservice builds a unit (``microservice.build_user_object``)."""
    from seldon_core_tpu_torch import microservice

    typed = [{"name": "model_uri", "value": model_uri, "type": "STRING"}] + typed_params(params)
    return microservice.build_user_object(cls, json.dumps(typed))


def engine(unit: Dict[str, Any], obj, annotations: Optional[Dict[str, str]] = None):
    """An EngineApp over one in-process unit ``obj`` (loaded by the
    caller), as ``engine_main`` serves a spec file's graph."""
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
    from seldon_core_tpu_torch.graph.service import EngineApp
    from seldon_core_tpu_torch.graph.spec import (
        PredictorSpec,
        default_predictor,
        validate_predictor,
    )

    spec = default_predictor(PredictorSpec.from_dict(
        {"name": "bench", "graph": unit, "annotations": annotations or {}}))
    validate_predictor(spec)
    return EngineApp(spec, registry={unit["name"]: obj}, metrics=MetricsRegistry())


class Fronts:
    """The engine's REST front (and its gRPC front when asked) on an
    asyncio loop in a daemon thread; :meth:`close` stops them and the
    executor and joins the thread."""

    def __init__(self, app, grpc: bool = False):
        self.app = app
        self.loop = asyncio.new_event_loop()
        self.rest_port: Optional[int] = None
        self.grpc_port: Optional[int] = None
        self._closers: List[Callable] = []
        ready = threading.Event()
        failure: List[BaseException] = []

        async def start():
            rest = app.rest_app()
            server = await rest.start("127.0.0.1", 0)
            self.rest_port = server.sockets[0].getsockname()[1]
            self._closers.append(rest.close)
            if grpc:
                gsrv = app.grpc_server()
                self.grpc_port = gsrv.add_insecure_port("127.0.0.1:0")
                await gsrv.start()
                self._gsrv = gsrv

        def run():
            asyncio.set_event_loop(self.loop)
            try:
                self.loop.run_until_complete(start())
            except Exception as e:  # noqa: BLE001 - handed to the caller
                failure.append(e)
            ready.set()
            if not failure:
                self.loop.run_forever()

        self.thread = threading.Thread(target=run, name="bench-fronts", daemon=True)
        self.thread.start()
        if not ready.wait(120):
            raise RuntimeError("the engine's fronts did not start within 120 s")
        if failure:
            raise RuntimeError(f"the engine's fronts did not start: {failure[0]!r}")

    def close(self) -> None:
        async def stop():
            for c in self._closers:
                c()
            gsrv = getattr(self, "_gsrv", None)
            if gsrv is not None:
                await gsrv.stop(grace=0.5)
            await self.app.executor.close()

        asyncio.run_coroutine_threadsafe(stop(), self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
