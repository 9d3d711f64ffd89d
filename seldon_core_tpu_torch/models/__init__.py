"""Model zoo registry of the port.

Counterpart of ``seldon_core_tpu/models/__init__.py``. Only the ``llm``
family (the generate path's DecoderLM) is ported so far; the JAX
package's other families raise a "not ported yet" error that names them.
Families are lazy-imported.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

_FAMILIES: Dict[str, str] = {
    "llm": "seldon_core_tpu_torch.models.llm.DecoderLM",
}

# families of the JAX package that this package does not serve yet
NOT_PORTED = ("mlp", "resnet50", "bert", "vit", "retrieval", "reranker")


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
