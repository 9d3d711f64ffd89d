"""PyTorch prepackaged server: counterpart of ``servers/jaxserver.py``.

It reads the JAX package's model directory layout, so one directory
serves under both packages::

    <model_uri>/jax_config.json   {"family": "llm",
                                   "config": {...model kwargs...},
                                   "checkpoint": "params.npz"}  # optional
    <model_uri>/params.npz        parameters as ``convert.save_npz`` writes
                                  them (optional; random init from
                                  config["seed"] when absent)

Orbax checkpoint directories stay on the JAX side: convert them with
``convert.params_from_numpy`` + ``convert.save_npz``. Without a
checkpoint the params come from the port's ``init_params(seed)``, whose
numbers differ from the JAX package's (same shapes and scales).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict

from ..storage import Storage
from ..user_model import TorchComponent

logger = logging.getLogger(__name__)


class TorchServer(TorchComponent):
    def __init__(self, model_uri: str, device: str = "cuda"):
        super().__init__(device=device)
        self.model_uri = model_uri
        self._family = None
        self._config: Dict[str, Any] = {}
        self._model = None

    def build(self):
        from .. import models as model_zoo
        from ..convert import load_npz

        model_dir = Storage.download(self.model_uri)
        cfg_path = os.path.join(model_dir, "jax_config.json")
        if not os.path.exists(cfg_path):
            raise RuntimeError(f"no jax_config.json under {self.model_uri}")
        with open(cfg_path) as f:
            cfg = json.load(f)
        self._family = cfg["family"]
        self._config = cfg.get("config", {})
        self._model = model_zoo.build(self._family, **self._config)
        params = None
        ckpt_rel = cfg.get("checkpoint")
        if ckpt_rel:
            ckpt = os.path.join(model_dir, ckpt_rel)
            if os.path.isdir(ckpt):
                raise NotImplementedError(
                    f"checkpoint {ckpt_rel!r} is a directory (an orbax "
                    "checkpoint of the JAX package); this package reads .npz "
                    "checkpoints — convert with convert.save_npz"
                )
            if os.path.isfile(ckpt):
                params = load_npz(ckpt, device=self.device)
                logger.info("torchserver: loaded checkpoint %s", ckpt)
        if params is None:
            seed = int(self._config.get("seed", 0))
            params = self._model.init_params(seed, device=self.device)
            logger.info(
                "torchserver %s: random-initialised params (seed=%d)", self._family, seed
            )
        return self._model.apply, params

    @property
    def warmup_shape(self):
        return self._model.example_input_shape if self._model else None

    @warmup_shape.setter
    def warmup_shape(self, _v):  # TorchComponent sets it as a class attr default
        pass

    def class_names(self):
        names = self._config.get("class_names")
        return list(names) if names else []

    def tags(self):
        return {"family": self._family or "?", "server": "torchserver"}
