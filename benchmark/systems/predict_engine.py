"""System under test: a classifier behind the engine's gRPC ``Predict``.

The path a user's predict request takes: the engine's gRPC front
(``graph/service.py``) -> the micro-batcher (``graph/batching.py``
``MicroBatchingClient``: each request's rows put on the device at
arrival, fused and padded to a power-of-two bucket) -> ``TorchServer``
-> the model (``models/bert.py``).

The configuration's ``model`` keys go to the model directory; its
``server`` section holds the micro-batcher's annotations. The weights
are the server's own random initialisation from the run's seed, on the
device. Set-up warms one forward at every batch the micro-batcher can
hand the model for this mix: the request's rows and each power-of-two
bucket of whole requests up to ``max_batch``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np

from benchmark import serve

CLASS = "seldon_core_tpu_torch.servers.torchserver.TorchServer"


def flush_sizes(rows: int, max_batch: int) -> List[int]:
    """Every batch a flush of whole ``rows``-row requests can hand the
    model: k requests' rows rounded up to a power of two, capped at
    ``max_batch`` (the micro-batcher's bucket rule), up to the first
    multiple of ``rows`` at or past ``max_batch``."""
    sizes, n = set(), rows
    while True:
        sizes.add(min(1 << (n - 1).bit_length(), max(max_batch, n)))
        if n >= max_batch:
            return sorted(sizes)
        n += rows


class System:
    front = "grpc"

    def __init__(self, config: Dict[str, Any], plan, seed: int, trace: bool, device: str):
        self.config = config
        self.plan = plan
        self.seed = int(seed)
        self.trace = trace
        self.device = device
        self.server = self.fronts = self.app = None

    def start(self) -> int:
        """Build, load, warm and listen; returns the gRPC front's port."""
        import torch

        server_cfg = self.config["server"]
        mdir = serve.model_dir(self.config["family"], self.config["model"], self.seed)
        self.server = serve.user_object(CLASS, mdir, {"device": self.device})
        self.server.load()
        max_batch = int(server_cfg["annotations"]["seldon.io/microbatch-max-batch"])
        for b in flush_sizes(self.plan.n_rows, max_batch):
            self.server.predict(np.zeros((b, self.plan.pad_to), np.int32), [])
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.app = serve.engine({"name": "model", "implementation": "JAX_SERVER",
                                 "modelUri": mdir}, self.server, server_cfg["annotations"])
        self.fronts = serve.Fronts(self.app, grpc=True)
        return self.fronts.grpc_port

    def snapshot(self) -> Dict[str, Any]:
        """The micro-batcher's counters now (flushes, real and padded rows)."""
        from seldon_core_tpu_torch.graph.engine_metrics import (
            MICROBATCH_FLUSHES,
            MICROBATCH_PADDED_ROWS,
            MICROBATCH_ROWS,
        )

        m = self.app.metrics
        return {"t": time.monotonic(),
                "flushes": m.counter_total(MICROBATCH_FLUSHES),
                "rows": m.counter_total(MICROBATCH_ROWS),
                "padded_rows": m.counter_total(MICROBATCH_PADDED_ROWS)}

    def stop(self) -> None:
        if self.fronts is not None:
            self.fronts.close()
        self.server = self.fronts = self.app = None
