"""Served-model protocol: init/apply over a plain parameter dict.

Counterpart of ``seldon_core_tpu/models/base.py``. Every model family
exposes:
  * ``init_params(seed, device) -> params`` (nested dict of tensors)
  * ``apply(params, x) -> y``
  * ``example_input_shape`` (without batch) for warmup

Parameters stay a nested dict of tensors keyed exactly as the JAX
package's pytree, so weights carry across one-to-one (see ``convert``).
The JAX package's sharding hooks (``input_sharding``/``param_sharding``)
belong to multi-device serving, which this package has not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name) -> torch.dtype:
    """A dtype name of the JAX package's configs as a ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(DTYPES)}") from None


class ServedModel:
    example_input_shape: Tuple[int, ...] = ()
    # dtype for activations; params stay in param_dtype until the server
    # casts them
    compute_dtype = "bfloat16"
    param_dtype = "float32"

    def init_params(self, seed: int = 0, device="cuda"):
        raise NotImplementedError

    def apply(self, params, x):
        raise NotImplementedError
