"""System under test: the generate server behind the engine's SSE route.

The path a user's streaming request takes: the engine's REST front
(``graph/service.py``, ``POST /api/v0.1/generate``) -> ``GenerateServer``
-> ``ContinuousBatcher`` (bucketed prefills through the flash kernel,
graph-replayed decode bursts, the radix prefix cache) -> ``DecoderLM``.

The configuration's ``model`` keys go to the model directory, its
``server`` keys to the server as typed parameters; the weights are the
server's own random initialisation from the run's seed, on the device.
Set-up warms exactly the shapes of this cell's traffic: the server's
warm-up over the mix's prompt lengths and output budget, and, for a mix
of shared documents, one request per document (the cache such traffic
keeps hot) plus one cache hit at each suffix bucket the mix reaches.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

from benchmark import serve

CLASS = "seldon_core_tpu_torch.servers.generateserver.GenerateServer"
DECODE_KINDS = ("decode_burst", "fused_burst", "group_burst")


def warm_lengths(bounds: Dict[str, int]) -> List[int]:
    """Prompt lengths that reach every prefill bucket between the mix's
    shortest and longest prompt (the server warms one per bucket)."""
    lo, hi = bounds["prompt_min"], bounds["prompt_max"]
    return sorted(set(range(lo, hi + 1, 16)) | {lo, hi})


class System:
    front = "rest"

    def __init__(self, config: Dict[str, Any], plan, seed: int, trace: bool, device: str):
        self.config = config
        self.plan = plan
        self.seed = int(seed)
        self.trace = trace
        self.device = device
        self.server = self.fronts = self.app = None

    def start(self) -> int:
        """Build, load, warm and listen; returns the SSE front's port."""
        bounds = self.plan.largest()
        params = dict(self.config["server"])
        params["device"] = self.device
        params["warmup_prompt_lens"] = warm_lengths(bounds)
        params["warmup_max_new_tokens"] = bounds["output_max"]
        if self.trace:
            # the traced run's device-time ledger (decode_step_ms)
            params["profiler"] = 1
        mdir = serve.model_dir("llm", self.config["model"], self.seed)
        self.server = serve.user_object(CLASS, mdir, params)
        self.server.load()
        self.app = serve.engine({"name": "llm", "implementation": "GENERATE_SERVER",
                                 "modelUri": mdir}, self.server)
        self.fronts = serve.Fronts(self.app)
        if self.plan.doc is not None:
            self._prime()
        return self.fronts.rest_port

    def _prime(self) -> None:
        """One request per shared document, then one cache hit at each
        suffix length bucket the mix reaches (in process, before the
        window: the documents are what this traffic keeps cached)."""
        plan = self.plan
        lo = int(plan.own_len.min())
        hi = int(plan.own_len.max())
        for d in range(len(plan.documents)):
            doc = [int(x) for x in plan.documents[d]]
            self.server.predict({"prompt_tokens": doc + [1] * lo, "max_new_tokens": 2,
                                 "temperature": 0.0}, [])
        doc = [int(x) for x in plan.documents[0]]
        for n in sorted({lo, hi, *range(lo, hi + 1, 32)}):
            self.server.predict({"prompt_tokens": doc + [2] * n, "max_new_tokens": 2,
                                 "temperature": 0.0}, [])

    def snapshot(self) -> Dict[str, Any]:
        """The program's counters now: the batcher's stats, its completed
        requests' (queue wait, TTFT, TPOT) samples, and the device-time
        ledger's cumulative buckets when it is on."""
        b = self.server.batcher
        snap = {"t": time.monotonic(), "stats": dict(b.stats), "slo": list(b.slo_recent)}
        prof = self.server.profiler
        if prof is not None and prof.enabled:
            snap["ledger"] = prof.buckets()
        return snap

    def stop(self) -> None:
        """Close the fronts and the server and let go of every tensor."""
        if self.fronts is not None:
            self.fronts.close()
        if self.server is not None:
            self.server.close()
        self.server = self.fronts = self.app = None
