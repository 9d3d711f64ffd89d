"""Model explainer component: answers ``/explain`` for a predictor.

Counterpart of ``seldon_core_tpu/components/explainer.py`` (the
reference's per-predictor alibi-explainer deployment,
operator/controllers/seldondeployment_explainers.go:32-187: a separate
Deployment running ``seldonio/alibiexplainer`` pointed at the predictor
via ``--predictor_host``).

* **White-box** (``model_uri`` set): the explainer loads the model the
  predictor serves through :class:`TorchServer` (the same
  ``jax_config.json`` and ``params.npz``) on ``device`` and computes
  gradient attributions with ``torch.autograd.grad`` with respect to
  the float32 input (the forward casts it to the compute dtype, as the
  JAX forward does). The target is the argmax of the float32 logits;
  a regression head (1-D logits) scores their sum. Saliency is
  ``grad * x``. Integrated gradients are ``delta * sum_k
  grad(baseline + alpha_k * delta) / n_steps`` with ``alpha_k = (k +
  0.5) / n_steps``; the JAX package scans the steps one batched
  forward-backward each, here the alphas are folded into the batch in
  chunks of at most ``MAX_ROWS`` rows, so that the activations kept for
  the backward stay bounded on a card the predictor shares. The
  parameters do not require gradients: no weight gradient is built.
  Loading on CUDA sets ``torch.backends.cudnn.deterministic`` for the
  process (the explainer runs as a deployment of its own), so that the
  same request gives the same attributions: cuDNN's backward-data
  algorithms may accumulate with atomics.
* **Black-box** (``predictor_endpoint`` set): occlusion/ablation
  attributions through the predictor's REST API, all ``B*(F+1)``
  ablated rows in one batched predict call, and the anchors family
  (:mod:`.anchors`): ``anchor_tabular`` needs ``train_data_uri``
  (background data, read through :class:`Storage`), ``anchor_text``
  explains a strData payload. These run on the host; ``device`` is the
  white-box explainers' alone.

Explainer type names accepted: ``integrated_gradients``, ``saliency``
(white-box); ``ablation``, ``anchor_tabular``, ``anchor_text``
(black-box); ``anchor_images`` aliases ``ablation``. With a serving
``mesh`` the white-box model is loaded as the predictor serves it
(``TorchServer(model_uri, mesh=mesh)``: params stored split under the
model's ``param_sharding``, compute on the mesh's compute device), and
the gradients flow through the meshed forward, so the attributions are
the unmeshed explainer's bit for bit.
"""

from __future__ import annotations

import json
import logging
import os
import urllib.request
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..user_model import SeldonComponent

logger = logging.getLogger(__name__)

WHITE_BOX_TYPES = ("integrated_gradients", "saliency")
BLACK_BOX_TYPES = ("ablation", "anchor_tabular", "anchor_text")
# pixel anchors need a segmenter; occlusion is the nearest method for images
ALIAS_TYPES = {
    "anchor_images": "ablation",
}
# rows of one IG forward-backward pass: ResNet-50 at 224 keeps ~1 GiB of
# bf16 activations for the backward at 32 rows
MAX_ROWS = 32


class Explainer(SeldonComponent):
    def __init__(
        self,
        explainer_type: str = "integrated_gradients",
        model_uri: str = "",
        predictor_endpoint: str = "",
        predictor_path: str = "/api/v0.1/predictions",
        n_steps: int = 32,
        mesh=None,
        train_data_uri: str = "",
        feature_names: Optional[List[str]] = None,
        precision_threshold: float = 0.95,
        n_bins: int = 4,
        anchor_seed: int = 0,
        device="cuda",
        **_kw,
    ):
        requested = (explainer_type or "integrated_gradients").lower()
        self.explainer_type = ALIAS_TYPES.get(requested, requested)
        self._requested_type = requested
        if self.explainer_type not in WHITE_BOX_TYPES + BLACK_BOX_TYPES:
            raise ValueError(
                f"unknown explainer type {explainer_type!r}; supported: "
                f"{WHITE_BOX_TYPES + BLACK_BOX_TYPES + tuple(ALIAS_TYPES)}"
            )
        self.device = None
        if self.explainer_type in WHITE_BOX_TYPES:
            from ..device import resolve_device

            self.device = mesh.device if mesh is not None else resolve_device(device)
        self._mesh = mesh
        self.model_uri = model_uri or ""
        self.predictor_endpoint = predictor_endpoint or ""
        self.predictor_path = predictor_path
        self.n_steps = int(n_steps)
        self._apply = None
        self._params = None
        # anchors config
        self.train_data_uri = train_data_uri or ""
        self.feature_names = list(feature_names) if feature_names else None
        self.precision_threshold = float(precision_threshold)
        self.n_bins = int(n_bins)
        self.anchor_seed = int(anchor_seed)
        self._anchor_tabular = None  # built lazily from train data
        if self.explainer_type == "anchor_tabular" and not self.train_data_uri:
            raise ValueError(
                "anchor_tabular needs train_data_uri (background data is the "
                "perturbation distribution and coverage denominator)"
            )

    # -- lifecycle -----------------------------------------------------------

    def load(self) -> None:
        if self.explainer_type in WHITE_BOX_TYPES:
            if not self.model_uri:
                raise ValueError(
                    f"{self.explainer_type} needs model_uri (white-box gradients); "
                    "set seldon.io/explainer-model-uri or use explainer type 'ablation'"
                )
            self._load_model()

    def _load_model(self) -> None:
        import torch

        from ..servers.torchserver import TorchServer

        # parameters made under inference_mode could not be saved for the
        # backward (a convolution keeps its weight for the input gradient)
        with torch.inference_mode(False):
            server = TorchServer(self.model_uri, device=self.device, mesh=self._mesh)
            self._apply, params = server.build()
            # the predictor's layout (TorchComponent.load), split under a mesh
            self._params = server.place_params(params)
        if self.device.type == "cuda":
            torch.backends.cudnn.deterministic = True
        logger.info("explainer %s: model %s loaded on %s",
                    self.explainer_type, self.model_uri, self.device)

    # -- white-box attribution -----------------------------------------------

    def _grad(self, x, target):
        """d(target score)/dx for a float32 batch ``x`` on the device."""
        import torch

        x = x.detach().requires_grad_(True)
        logits = self._apply(self._params, x).float()
        if logits.ndim == 1:  # regression head
            score = logits.sum()
        else:
            score = logits.gather(-1, target[:, None]).sum()
        return torch.autograd.grad(score, x)[0]

    def _white_box(self, x: np.ndarray, baseline: np.ndarray):
        """``(attributions, logits, target)`` as numpy arrays."""
        import torch

        dev = self.device
        # autograd needs tensors made outside inference_mode and no_grad
        with torch.inference_mode(False), torch.enable_grad():
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            with torch.no_grad():
                logits = self._apply(self._params, xt).float()
            b = xt.shape[0]
            if logits.ndim > 1:
                target = torch.argmax(logits, dim=-1)
            else:
                target = torch.zeros(b, dtype=torch.int64, device=dev)
            if self.explainer_type == "saliency":
                attr = self._grad(xt, target) * xt
            else:
                bt = torch.from_numpy(np.ascontiguousarray(baseline)).to(dev)
                delta = xt - bt
                n = self.n_steps
                # float32 alphas, as jnp.arange(n, float32) + 0.5) / n
                alphas = ((torch.arange(n, dtype=torch.float32) + 0.5) / n).to(dev)
                per = max(1, MAX_ROWS // b)
                lead = (-1,) + (1,) * xt.ndim
                total = torch.zeros_like(xt)
                for s in range(0, n, per):
                    a = alphas[s:s + per]
                    k = a.shape[0]
                    pts = bt[None] + a.view(lead) * delta[None]  # [k, B, ...]
                    g = self._grad(pts.reshape(k * b, *xt.shape[1:]), target.repeat(k))
                    total = total + g.reshape(k, *xt.shape).sum(dim=0)
                attr = delta * total / n
        return (attr.detach().cpu().numpy(), logits.cpu().numpy(),
                target.cpu().numpy())

    # -- anchors (components/anchors.py behind the predictor endpoint) -------

    def _load_train_data(self) -> np.ndarray:
        from ..storage import Storage

        path = Storage.download(self.train_data_uri)
        if os.path.isdir(path):
            cands = [
                f for f in sorted(os.listdir(path))
                if f.endswith((".npy", ".csv", ".json"))
            ]
            if not cands:
                raise ValueError(f"no .npy/.csv/.json under {self.train_data_uri}")
            path = os.path.join(path, cands[0])
        if path.endswith(".npy"):
            return np.load(path)
        if path.endswith(".json"):
            with open(path) as f:
                return np.asarray(json.load(f), dtype=np.float64)
        return np.loadtxt(path, delimiter=",", skiprows=0)

    def _anchor_explainer(self):
        if self._anchor_tabular is None:
            from .anchors import AnchorTabular

            self._anchor_tabular = AnchorTabular(
                predict_fn=self._query_predictor,
                train_data=self._load_train_data(),
                feature_names=self.feature_names,
                n_bins=self.n_bins,
                precision_threshold=self.precision_threshold,
                seed=self.anchor_seed,
            )
        return self._anchor_tabular

    def _explain_anchor_tabular(self, x: np.ndarray) -> Dict:
        exp = self._anchor_explainer()
        if self.feature_names is None:
            self.feature_names = exp.feature_names
        anchors = [dict(exp.explain(row)) for row in x]
        return {
            "explainer": "anchor_tabular",
            "anchors": anchors,
            # top-level convenience mirrors single-instance callers
            **{k: anchors[0][k] for k in
               ("anchor", "precision", "coverage", "prediction")},
        }

    def _post_predictor(self, body: Dict) -> np.ndarray:
        req = urllib.request.Request(
            f"http://{self.predictor_endpoint}{self.predictor_path}",
            data=json.dumps(body).encode(),
            headers={"content-type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30.0) as r:
            out = json.loads(r.read())
        data = out.get("data") or {}
        arr = data.get("ndarray", data.get("tensor", {}).get("values"))
        if arr is None:
            raise ValueError(f"predictor response carries no tensor: {out}")
        return np.asarray(arr, dtype=np.float32)

    def _explain_anchor_text(self, text: str) -> Dict:
        from .anchors import AnchorText

        exp = AnchorText(
            predict_fn=lambda texts: self._post_predictor({"data": {"ndarray": list(texts)}}),
            precision_threshold=self.precision_threshold,
            seed=self.anchor_seed,
        )
        out = dict(exp.explain(text))
        out["explainer"] = "anchor_text"
        return out

    # -- black-box attribution (one batched predict round-trip) --------------

    def _query_predictor(self, batch: np.ndarray) -> np.ndarray:
        if not self.predictor_endpoint:
            raise ValueError(
                "ablation explainer needs predictor_endpoint "
                "(host:port of the predictor's engine)"
            )
        return self._post_predictor({"data": {"ndarray": batch.tolist()}})

    def _explain_ablation(self, x: np.ndarray, baseline: np.ndarray):
        """Occlusion: attribution_j = score(x) - score(x with feature j
        swapped for baseline_j). All B*(F+1) rows ride ONE predict call."""
        b, f = x.shape
        rows = [x]
        for j in range(f):
            ablated = x.copy()
            ablated[:, j] = baseline[:, j]
            rows.append(ablated)
        preds = self._query_predictor(np.concatenate(rows, axis=0))
        if preds.ndim == 1:
            preds = preds[:, None]
        preds = preds.reshape(f + 1, b, -1)
        full, ablations = preds[0], preds[1:]
        target = np.argmax(full, axis=-1)
        full_score = np.take_along_axis(full, target[:, None], axis=-1)[:, 0]
        abl_score = np.take_along_axis(
            ablations, target[None, :, None], axis=-1
        )[:, :, 0]  # [F, B]
        attributions = (full_score[None, :] - abl_score).T  # [B, F]
        return attributions, full, target

    # -- SeldonComponent -----------------------------------------------------

    def explain(self, X, names: Iterable[str], meta: Optional[Dict] = None) -> Dict:
        if self.explainer_type == "anchor_text":
            if isinstance(X, (bytes, bytearray)):
                X = bytes(X).decode("utf-8", "replace")
            if not isinstance(X, str):
                raise ValueError("anchor_text explains strData payloads")
            return self._explain_anchor_text(X)
        if self.explainer_type == "anchor_tabular":
            arr = np.asarray(X, dtype=np.float64)
            if arr.ndim == 1:
                arr = arr[None, :]
            # bind request names only when they actually fit: a wrong-width
            # names list must fail THIS request, not poison the explainer
            if (
                self.feature_names is None
                and names
                and len(list(names)) == arr.shape[1]
            ):
                self.feature_names = list(names)
            return self._explain_anchor_tabular(arr)
        x = np.asarray(X, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]  # responses stay batched, like predict
        req_meta = meta or {}
        baseline = np.asarray(
            req_meta.get("tags", {}).get("baseline", np.zeros_like(x)), np.float32
        )
        if baseline.shape != x.shape:
            baseline = np.broadcast_to(baseline, x.shape).astype(np.float32)

        if self.explainer_type in WHITE_BOX_TYPES:
            if self._apply is None:
                self.load()
            attr, prediction, target = self._white_box(x, baseline)
        else:
            # occlusion works on flat feature vectors; images and other
            # >2-D batches are flattened per-row and the attribution map
            # reshaped back (anchor_images alias lands here)
            shape = x.shape
            flat_x = x.reshape(shape[0], -1)
            flat_b = baseline.reshape(shape[0], -1)
            attr, prediction, target = self._explain_ablation(flat_x, flat_b)
            attr = attr.reshape(shape)

        names_list: List[str] = list(names or [])
        out: Dict = {
            "explainer": self.explainer_type,
            "attributions": attr.tolist(),
            "prediction": prediction.tolist(),
            "target": target.tolist(),
        }
        if names_list:
            out["names"] = names_list
        if self._requested_type != self.explainer_type:
            out["requested_type"] = self._requested_type
        return out

    def tags(self) -> Dict:
        return {"explainer": self.explainer_type}
