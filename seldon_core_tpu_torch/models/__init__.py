"""Model zoo registry of the port.

Counterpart of ``seldon_core_tpu/models/__init__.py``. Families map to
BASELINE.json's configs: mlp (iris parity), resnet50 (REST image path),
bert (gRPC text path), vit, llm (generate() with dynamic batching), and
the RAG graph's retrieval and reranker. Families are lazy-imported.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

_FAMILIES: Dict[str, str] = {
    "mlp": "seldon_core_tpu_torch.models.mlp.MLP",
    "resnet50": "seldon_core_tpu_torch.models.resnet.ResNet50",
    "bert": "seldon_core_tpu_torch.models.bert.BertClassifier",
    "llm": "seldon_core_tpu_torch.models.llm.DecoderLM",
    "vit": "seldon_core_tpu_torch.models.vit.ViTClassifier",
    "retrieval": "seldon_core_tpu_torch.models.retrieval.RetrievalIndex",
    "reranker": "seldon_core_tpu_torch.models.retrieval.Reranker",
}

# families of the JAX package that this package does not serve yet
NOT_PORTED = ()


def build(family: str, **config) -> Any:
    if family not in _FAMILIES:
        if family in NOT_PORTED:
            raise NotImplementedError(
                f"model family {family!r} is not ported to seldon_core_tpu_torch "
                f"yet; ported: {sorted(_FAMILIES)}"
            )
        raise ValueError(f"unknown model family {family!r}; have {sorted(_FAMILIES)}")
    module_name, cls_name = _FAMILIES[family].rsplit(".", 1)
    cls = getattr(importlib.import_module(module_name), cls_name)
    return cls(**config)
