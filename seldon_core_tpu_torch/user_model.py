"""User-facing component API.

Counterpart of ``seldon_core_tpu/user_model.py``: the ``SeldonComponent``
hooks (``predict``, ``transform_input``, ``transform_output``, ``route``,
``aggregate``, ``send_feedback``, ``explain`` plus ``metrics``/``tags``/
``class_names``/``load``/``health_status`` and proto-level ``*_raw``
variants) and the ``client_*`` adapters that degrade gracefully when a
hook is missing.

:class:`TorchComponent` takes the place of the JAX package's
``JAXComponent``: a component whose ``predict`` runs a PyTorch function
over device-resident params, on ``device`` (CUDA unless the caller asks
for the CPU). :class:`TorchTransformComponent` (``JAXTransformComponent``)
also serves the transform hooks with that forward.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class SeldonComponent:
    """Base class for graph components. All hooks are optional."""

    def load(self) -> None:
        """Called once per worker before serving (model/params load site)."""

    # --- tensor-level hooks (X is np.ndarray | torch.Tensor | bytes | str | json) ---

    def predict(self, X, names: Iterable[str], meta: Optional[Dict] = None):
        raise NotImplementedError

    def transform_input(self, X, names: Iterable[str], meta: Optional[Dict] = None):
        raise NotImplementedError

    def transform_output(self, X, names: Iterable[str], meta: Optional[Dict] = None):
        raise NotImplementedError

    def route(self, X, names: Iterable[str], meta: Optional[Dict] = None) -> int:
        raise NotImplementedError

    def aggregate(self, Xs: List[Any], names: List[List[str]], metas: Optional[List[Dict]] = None):
        raise NotImplementedError

    def send_feedback(self, X, names: Iterable[str], reward: float, truth, routing: Optional[int] = None):
        raise NotImplementedError

    def explain(self, X, names: Iterable[str], meta: Optional[Dict] = None) -> Dict:
        """Return a JSON-serializable explanation for the batch X
        (feature attributions, anchors, ...). Served at ``/explain``
        (reference: per-predictor alibi explainer deployments,
        operator/controllers/seldondeployment_explainers.go:32-187)."""
        raise NotImplementedError

    # --- proto-level hooks (full SeldonMessage in/out, bypass marshaling) ---

    def predict_raw(self, msg):
        raise NotImplementedError

    def transform_input_raw(self, msg):
        raise NotImplementedError

    def transform_output_raw(self, msg):
        raise NotImplementedError

    def route_raw(self, msg):
        raise NotImplementedError

    def aggregate_raw(self, msgs):
        raise NotImplementedError

    def send_feedback_raw(self, feedback):
        raise NotImplementedError

    # --- metadata hooks ---

    def metrics(self) -> List[Dict]:
        raise NotImplementedError

    def tags(self) -> Dict:
        raise NotImplementedError

    def class_names(self) -> List[str]:
        raise NotImplementedError

    def feature_names(self) -> List[str]:
        raise NotImplementedError

    def health_status(self):
        """Optional liveness probe payload; exceptions mark unhealthy."""
        raise NotImplementedError


def _has_hook(user_model, name: str) -> bool:
    """True if user_model provides `name` (overridden or duck-typed)."""
    hook = getattr(user_model, name, None)
    if hook is None or not callable(hook):
        return False
    if isinstance(user_model, SeldonComponent):
        return getattr(type(user_model), name, None) is not getattr(SeldonComponent, name, None)
    return True


# ---------------------------------------------------------------------------
# client_* adapters: call the hook if present, degrade gracefully otherwise
# (reference: python/seldon_core/user_model.py:134-361)
# ---------------------------------------------------------------------------


class SeldonNotImplementedError(NotImplementedError):
    """Raised by client_* when neither typed nor raw hook exists."""


def client_has_raw(user_model, method: str) -> bool:
    return _has_hook(user_model, method + "_raw")


def client_raw(user_model, method: str, *args):
    return getattr(user_model, method + "_raw")(*args)


def client_predict(user_model, X, names, meta=None):
    if _has_hook(user_model, "predict"):
        try:
            return user_model.predict(X, names, meta)
        except TypeError:
            return user_model.predict(X, names)
    raise SeldonNotImplementedError("predict not implemented")


def client_transform_input(user_model, X, names, meta=None):
    if _has_hook(user_model, "transform_input"):
        try:
            return user_model.transform_input(X, names, meta)
        except TypeError:
            return user_model.transform_input(X, names)
    return X  # identity (reference: user_model.py:239-260)


def client_transform_output(user_model, X, names, meta=None):
    if _has_hook(user_model, "transform_output"):
        try:
            return user_model.transform_output(X, names, meta)
        except TypeError:
            return user_model.transform_output(X, names)
    return X


def client_route(user_model, X, names, meta=None) -> int:
    if _has_hook(user_model, "route"):
        try:
            branch = user_model.route(X, names, meta)
        except TypeError:
            branch = user_model.route(X, names)
        if not isinstance(branch, (int, np.integer)):
            raise ValueError(f"route() must return int, got {type(branch).__name__}")
        return int(branch)
    raise SeldonNotImplementedError("route not implemented")


def client_aggregate(user_model, Xs, names_list, metas=None):
    if _has_hook(user_model, "aggregate"):
        try:
            return user_model.aggregate(Xs, names_list, metas)
        except TypeError:
            return user_model.aggregate(Xs, names_list)
    raise SeldonNotImplementedError("aggregate not implemented")


def client_explain(user_model, X, names, meta=None) -> Dict:
    if _has_hook(user_model, "explain"):
        try:
            out = user_model.explain(X, names, meta)
        except TypeError:
            out = user_model.explain(X, names)
        if not isinstance(out, dict):
            raise ValueError(f"explain() must return a dict, got {type(out).__name__}")
        return out
    raise SeldonNotImplementedError("explain not implemented")


def client_send_feedback(user_model, X, names, reward, truth, routing=None):
    if _has_hook(user_model, "send_feedback"):
        return user_model.send_feedback(X, names, reward, truth, routing=routing)
    return None


def client_custom_metrics(user_model) -> List[Dict]:
    if _has_hook(user_model, "metrics"):
        from .metrics import validate_metrics

        out = user_model.metrics()
        if not validate_metrics(out):
            raise ValueError(f"invalid custom metrics: {out}")
        return out
    return []


def client_custom_tags(user_model) -> Dict:
    if _has_hook(user_model, "tags"):
        return user_model.tags() or {}
    return {}


def client_class_names(user_model, result) -> List[str]:
    if _has_hook(user_model, "class_names"):
        return list(user_model.class_names())
    arr = np.asarray(result) if isinstance(result, (list, tuple)) else result
    if hasattr(arr, "ndim") and getattr(arr, "ndim", 0) > 1:
        return [f"t:{i}" for i in range(arr.shape[-1])]
    return []


def client_health_status(user_model):
    if _has_hook(user_model, "health_status"):
        return user_model.health_status()
    return "ok"


# ---------------------------------------------------------------------------
# PyTorch component
# ---------------------------------------------------------------------------


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device) if hasattr(tree, "to") else tree


def _place_consuming(tree, shardings):
    """``parallel.mesh.place_tree`` that replaces each leaf of ``tree`` by
    its placed form in place, dropping the whole leaf as it goes."""
    from .parallel.mesh import place

    if isinstance(tree, tuple):
        tree = list(tree)
    for k in list(tree.keys() if isinstance(tree, dict) else range(len(tree))):
        if isinstance(tree[k], (dict, list, tuple)):
            tree[k] = _place_consuming(tree[k], shardings[k])
        else:
            tree[k] = place(tree[k], shardings[k])
    return tree


class TorchComponent(SeldonComponent):
    """A component whose forward pass is a PyTorch function.

    Subclasses implement :meth:`build` returning ``(apply_fn, params)``
    where ``apply_fn(params, x) -> y``. ``load()`` places the params on
    ``device`` and, when ``warmup_shape`` is set, runs one warmup batch so
    the first request pays no one-time initialisation. Requests land on
    the device through ``payload.to_device``; outputs stay there until
    serialization. A request that is already a tensor (the micro-batcher's
    fused device batch, under the ``__torch__`` key) goes to the forward
    as it is.

    With a serving ``mesh`` (``parallel/mesh.py`` ``ServingMesh``) the
    params are stored under :meth:`param_sharding` (split blocks over the
    mesh's positions), the compute runs on the mesh's compute device, a
    request batch must tile :meth:`input_sharding` (a ``ValueError``
    otherwise, as ``jax.device_put`` refuses it) and the warmup batch is
    the mesh's ``data`` width.
    """

    # dtype for float inputs on the device
    compute_dtype = "bfloat16"
    # example input shape (without batch) used to warm the forward
    warmup_shape: Optional[tuple] = None
    warmup_dtype = "float32"

    def __init__(self, device="cuda", mesh=None):
        from .device import resolve_device

        self._mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self._apply = None
        self.params = None

    # -- to implement --
    def build(self):
        raise NotImplementedError

    def input_sharding(self, mesh):
        """Sharding of the request batch; replicated by default."""
        from .parallel.mesh import ServingSharding

        return ServingSharding(mesh, ())

    def param_sharding(self, mesh, params):
        """Shardings of ``params``, leaf for leaf; replicated by default."""
        from .models.base import replicated_sharding

        return replicated_sharding(mesh, params)

    # -- SeldonComponent --
    def load(self) -> None:
        import torch

        apply_fn, params = self.build()
        self.params = self.place_params(params)
        self._apply = apply_fn
        if self.warmup_shape is not None:
            # the batch must tile the mesh's data axis
            batch = self._mesh.shape.get("data", 1) if self._mesh is not None else 1
            x = np.zeros((batch, *self.warmup_shape), dtype=self.warmup_dtype)
            with torch.no_grad():
                self._apply(self.params, self._to_dev(x))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        logger.info("TorchComponent %s loaded on %s%s", type(self).__name__, self.device,
                    f" over {self._mesh}" if self._mesh is not None else "")

    def place_params(self, params):
        """``params`` where the forward reads them: on ``device``, or,
        under a mesh, placed leaf by leaf under :meth:`param_sharding`
        (a split leaf's blocks copied to their positions, a replicated
        leaf to the compute device). The tree is consumed: each whole
        leaf is let go as soon as it is placed, so a tree read on the
        host never sits whole on the compute device."""
        if self._mesh is None:
            return _tree_to(params, self.device)
        return _place_consuming(params, self.param_sharding(self._mesh, params))

    def _to_dev(self, X):
        from . import payload

        dtype = (
            self.compute_dtype
            if np.issubdtype(np.asarray(X).dtype, np.floating)
            else None
        )
        if self._mesh is not None:
            # the whole batch goes to the compute device (replicated
            # compute), once it tiles the split axes
            self.input_sharding(self._mesh).check_divides(np.shape(X))
        return payload.to_device(X, self.device, dtype=dtype)

    def fused_stage(self):
        """``(fn, params, compute_dtype)`` for the graph-fusion planner
        (``graph/fusion.py``): ``fn(params, x)`` is the SAME forward
        :meth:`predict` runs, over the same (under a mesh, placed) params,
        so a fused segment computes exactly what the hop-by-hop path
        would, the property its byte-identity rests on."""
        if self._apply is None:
            self.load()
        return self._apply, self.params, self.compute_dtype

    # graph-fusion eligibility marker (graph/fusion.py): a bare
    # TorchComponent backs ONLY ``predict`` with its forward; its
    # transform hooks degrade to identity, so a TRANSFORMER-typed unit
    # must not be fused through ``_apply``. TorchTransformComponent flips
    # this by routing the transform hooks through the same forward.
    fused_transforms = False

    def predict(self, X, names, meta=None):
        import torch

        if self._apply is None:
            self.load()
        if isinstance(X, np.ndarray):
            X = self._to_dev(X)
        with torch.no_grad():
            return self._apply(self.params, X)


class TorchTransformComponent(TorchComponent):
    """A TorchComponent whose forward also serves the transform hooks, for
    TRANSFORMER / OUTPUT_TRANSFORMER graph nodes (a BERT-style input
    transformer computes on the device): the hop path and the fusion
    planner then agree on what the unit computes. A bare TorchComponent on
    such a node degrades to the identity transform (the client_* contract
    above), which is why fusion refuses it."""

    fused_transforms = True

    def transform_input(self, X, names, meta=None):
        return self.predict(X, names, meta)

    def transform_output(self, X, names, meta=None):
        return self.predict(X, names, meta)
