"""Built-in graph units: graphs run with no external microservice.

Counterpart of ``seldon_core_tpu/graph/units.py`` (numpy only).

Behavior parity with the engine's hardcoded units (reference:
engine/.../predictors/SimpleModelUnit.java:33-57 — static 3-class output;
SimpleRouterUnit.java:25-30 — always branch 0;
AverageCombinerUnit.java:30 — element-wise mean;
RandomABTestUnit.java:29-36 — seeded 50/50 split, Random(1337)).

These also serve the same role the reference's did in tests: graph algebra
is exercised in-process without sockets (reference:
engine/src/test/java/.../predictors/SimpleModelUnitTest.java).
"""

from __future__ import annotations

import random
from typing import List

import numpy as np

from ..user_model import SeldonComponent


class SimpleModelUnit(SeldonComponent):
    """Static 3-class prediction, values matching the reference stub."""

    values = [0.9, 0.05, 0.05]
    classes = ["proba_0", "proba_1", "proba_2"]

    def predict(self, X, names, meta=None):
        batch = 1
        arr = np.asarray(X) if not isinstance(X, (bytes, str)) and X is not None else None
        if arr is not None and arr.ndim >= 2:
            batch = arr.shape[0]
        return np.tile(np.asarray(self.values), (batch, 1))

    def class_names(self):
        return self.classes


class SimpleRouterUnit(SeldonComponent):
    """Always routes to child 0 (reference: SimpleRouterUnit.java:25-30)."""

    def route(self, X, names, meta=None) -> int:
        return 0


class AverageCombinerUnit(SeldonComponent):
    """Element-wise mean over children outputs; shapes must agree
    (reference: AverageCombinerUnit.java:30, ojAlgo matrix mean)."""

    def aggregate(self, Xs: List, names, metas=None):
        arrays = [np.asarray(x, dtype=np.float64) for x in Xs]
        shapes = {a.shape for a in arrays}
        if len(shapes) != 1:
            raise ValueError(f"combiner inputs disagree on shape: {sorted(shapes)}")
        return np.mean(arrays, axis=0)

    def fused_aggregate(self, Ys: List):
        """Device mean for the graph-fusion planner (``graph/fusion.py``):
        lets a COMBINER fan-in whose children are in-process TorchComponents
        run inside one fused segment. Computes in float32 on the device
        where the host path computes float64, so bit-identity with
        hop-by-hop holds only when the mean is exact at f32 (identical
        children, or values whose sum is f32-representable), the JAX
        package's caveat too."""
        import torch

        return torch.stack([y.float() for y in Ys]).mean(dim=0)


class RandomABTestUnit(SeldonComponent):
    """Seeded 50/50 (configurable ratio) A/B split.

    Reference uses Java Random(1337) (RandomABTestUnit.java:29-36); we seed a
    local PRNG for the same determinism-in-tests property.
    """

    def __init__(self, ratio_a: float = 0.5, seed: int = 1337):
        self.ratio_a = float(ratio_a)
        self._rng = random.Random(seed)

    def route(self, X, names, meta=None) -> int:
        return 0 if self._rng.random() < self.ratio_a else 1


class RagPromptBuilder(SeldonComponent):
    """Bridge from a retrieval tail to a GENERATE_SERVER unit: takes the
    reranker's winning doc-token tensor ``[B, L]`` and emits the generate
    request body the LLM unit consumes. Host-side by design: the generate
    unit is a batching scheduler that takes host token lists."""

    def __init__(self, max_new_tokens=16, temperature=0.0, seed=0,
                 eos_id=None):
        # graph parameters arrive as strings
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.eos_id = int(eos_id) if eos_id not in (None, "", "none") else None

    def transform_input(self, X, names, meta=None):
        toks = np.asarray(X)
        if toks.ndim != 2:
            raise ValueError(
                f"RAG prompt builder expects [batch, doc_len] token rows, "
                f"got shape {toks.shape}"
            )
        return {
            "prompt_tokens": [[int(t) for t in row] for row in toks],
            "max_new_tokens": self.max_new_tokens,
            "temperature": self.temperature,
            "seed": self.seed,
            "eos_id": self.eos_id,
        }


BUILTIN_IMPLEMENTATIONS = {
    "SIMPLE_MODEL": SimpleModelUnit,
    "SIMPLE_ROUTER": SimpleRouterUnit,
    "AVERAGE_COMBINER": AverageCombinerUnit,
    "RANDOM_ABTEST": RandomABTestUnit,
    "RAG_PROMPT_BUILDER": RagPromptBuilder,
}
