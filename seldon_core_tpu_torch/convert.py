"""Carry weights between the JAX package and the port.

* :func:`params_from_numpy` turns the JAX package's parameter pytree, with
  numpy leaves (``jax.tree.map(np.asarray, params)``), into the port's
  parameter dict on a device. Keys and shapes are the same on both sides.
* :func:`save_npz` / :func:`load_npz` keep a parameter dict in one ``.npz``
  file with flat ``"blocks/wq"``-style keys — the checkpoint format of
  ``servers/torchserver``. bfloat16 leaves are stored as their raw 16-bit
  patterns under a ``"@bfloat16"`` key suffix (numpy has no bfloat16).

A tree may hold lists as well as dicts (the MLP's layers, ResNet-50's
``stages``): a list index is a path segment (``"stages/2/0/conv1"``), and
a file that holds lists names their paths in one ``"@lists"`` entry, so
they come back as lists while a dict-only tree's keys stay exactly as
they were.

No safetensors and no ml_dtypes: plain numpy reads and writes these files.

Checkpoint export (the JAX package's ``convert.py``): :func:`convert_hf_bert`,
:func:`convert_hf_llama` and :func:`convert_hf_vit` re-lay a ``transformers``
model's weights as the zoo's parameter trees, and :func:`export_model` writes
the ``jax_config.json`` + ``params.npz`` directory that ``TorchServer`` and
``GenerateServer`` load as a model URI. ``transformers`` is imported only by
:func:`convert_hf`, so this module imports where it is not installed.

CLI::

    seldon-tpu-torch-export --hf <name-or-path> --family bert|llama|vit --out DIR
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .device import resolve_device

logger = logging.getLogger(__name__)

_BF16_SUFFIX = "@bfloat16"
_LISTS_KEY = "@lists"


def _leaf_to_tensor(arr, device, dtype=None) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes array handed over by JAX
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dicts and lists of numpy arrays -> the same tree of tensors
    on ``device`` (floating leaves cast to ``dtype`` when given)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf_to_tensor(node, dev, dtype)

    return walk(tree)


def _children(node):
    if isinstance(node, dict):
        return node.items()
    return enumerate(node)


def flatten(params, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts and lists -> ``{"blocks/wq": leaf, "stages/0/0/conv1":
    leaf, ...}`` (a list index is a path segment)."""
    out: Dict[str, Any] = {}
    for k, v in _children(params):
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def list_paths(params, prefix: str = "") -> List[str]:
    """The ``/``-joined paths of the list nodes of a tree (``""`` for a
    root list), the record :func:`unflatten` takes to rebuild them."""
    out: List[str] = []
    if isinstance(params, (list, tuple)):
        out.append(prefix.rstrip("/"))
    for k, v in _children(params):
        if isinstance(v, (dict, list, tuple)):
            out.extend(list_paths(v, f"{prefix}{k}/"))
    return out


def unflatten(flat: Dict[str, Any], lists=()):
    """``{"blocks/wq": leaf}`` -> nested dict; the nodes at the paths in
    ``lists`` (as :func:`list_paths` gives them) come back as lists, in
    index order."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    lists = set(lists)
    if not lists:
        return out

    def rebuild(node, path):
        if not isinstance(node, dict):
            return node
        kids = {k: rebuild(v, f"{path}/{k}" if path else k) for k, v in node.items()}
        if path in lists:
            return [kids[str(i)] for i in range(len(kids))]
        return kids

    return rebuild(out, "")


def sorted_leaves(tree, path=()) -> List[Tuple[Tuple[Any, ...], Any]]:
    """``[(key path, leaf)]`` of a tree in the JAX package's
    ``tree_flatten`` order (dict keys sorted at every level, lists in
    index order, an index an ``int`` in the path): the order its weight
    pager frames leaves in and its swap check reports them."""
    if isinstance(tree, dict):
        out: List[Tuple[Tuple[Any, ...], Any]] = []
        for k in sorted(tree):
            out.extend(sorted_leaves(tree[k], path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(sorted_leaves(v, path + (i,)))
        return out
    return [(path, tree)]


def save_npz(params, path: str) -> None:
    """Write a parameter tree (tensors or numpy arrays) to ``path``."""
    arrays = {}
    lists = list_paths(params)
    if lists:
        arrays[_LISTS_KEY] = np.asarray(lists, dtype=np.str_)
    for key, leaf in flatten(params).items():
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            if t.dtype == torch.bfloat16:
                arrays[key + _BF16_SUFFIX] = t.view(torch.int16).numpy()
                continue
            arrays[key] = t.numpy()
        else:
            a = np.asarray(leaf)
            if a.dtype.name == "bfloat16":
                arrays[key + _BF16_SUFFIX] = a.view(np.int16)
            else:
                arrays[key] = a
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_npz(path: str, device="cuda", dtype=None):
    """Read a parameter tree written by :func:`save_npz` (or by
    ``np.savez`` with flat ``"a/b"`` keys) onto ``device``."""
    dev = resolve_device(device)
    flat = {}
    lists: List[str] = []
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            a = z[key]
            if key == _LISTS_KEY:
                lists = [str(p) for p in a]
                continue
            if key.endswith(_BF16_SUFFIX):
                t = torch.from_numpy(a.astype(np.int16, copy=False)).view(torch.bfloat16)
                key = key[: -len(_BF16_SUFFIX)]
            else:
                t = torch.from_numpy(a)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            flat[key] = t.to(dev)
    return unflatten(flat, lists)


# ---------------------------------------------------------------------------
# transformers checkpoints -> the zoo's parameter trees
# ---------------------------------------------------------------------------


def _t(tensor) -> np.ndarray:
    """A torch tensor as float32 numpy on the host."""
    return np.asarray(tensor.detach().cpu().float().numpy())


def _stack(layers, getter) -> np.ndarray:
    return np.stack([getter(layer) for layer in layers], axis=0)


def _lin_w(linear) -> np.ndarray:
    """torch ``Linear`` stores [out, in]; the zoo's matmuls are x @ W with
    W [in, out]."""
    return _t(linear.weight).T


def convert_hf_bert(model) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """transformers BertForSequenceClassification/BertModel ->
    (jax_config dict, BertClassifier params)."""
    bert = getattr(model, "bert", model)
    hf_cfg = model.config
    # refuse configs the forward cannot reproduce: the contract is logit
    # parity, not an approximation
    act = getattr(hf_cfg, "hidden_act", "gelu")
    if act not in ("gelu", "gelu_python"):
        raise ValueError(
            f"BertClassifier implements exact gelu; checkpoint uses "
            f"hidden_act={act!r} — conversion would serve wrong logits"
        )
    pos_type = getattr(hf_cfg, "position_embedding_type", "absolute")
    if pos_type != "absolute":
        raise ValueError(f"unsupported position_embedding_type {pos_type!r}")
    ln_eps = float(getattr(hf_cfg, "layer_norm_eps", 1e-12))
    if abs(ln_eps - 1e-12) > 1e-15:
        raise ValueError(
            f"BertClassifier uses layer_norm eps 1e-12; checkpoint uses {ln_eps}"
        )
    layers = list(bert.encoder.layer)
    emb = bert.embeddings
    config = {
        "vocab_size": hf_cfg.vocab_size,
        "d_model": hf_cfg.hidden_size,
        "n_layers": hf_cfg.num_hidden_layers,
        "n_heads": hf_cfg.num_attention_heads,
        "d_ff": hf_cfg.intermediate_size,
        "max_seq": hf_cfg.max_position_embeddings,
        "type_vocab": hf_cfg.type_vocab_size,
        "num_classes": getattr(hf_cfg, "num_labels", 2),
    }
    blocks = {
        "wq": _stack(layers, lambda l: _lin_w(l.attention.self.query)),
        "wq_b": _stack(layers, lambda l: _t(l.attention.self.query.bias)),
        "wk": _stack(layers, lambda l: _lin_w(l.attention.self.key)),
        "wk_b": _stack(layers, lambda l: _t(l.attention.self.key.bias)),
        "wv": _stack(layers, lambda l: _lin_w(l.attention.self.value)),
        "wv_b": _stack(layers, lambda l: _t(l.attention.self.value.bias)),
        "wo": _stack(layers, lambda l: _lin_w(l.attention.output.dense)),
        "wo_b": _stack(layers, lambda l: _t(l.attention.output.dense.bias)),
        "ln1_scale": _stack(layers, lambda l: _t(l.attention.output.LayerNorm.weight)),
        "ln1_bias": _stack(layers, lambda l: _t(l.attention.output.LayerNorm.bias)),
        "w1": _stack(layers, lambda l: _lin_w(l.intermediate.dense)),
        "w1_b": _stack(layers, lambda l: _t(l.intermediate.dense.bias)),
        "w2": _stack(layers, lambda l: _lin_w(l.output.dense)),
        "w2_b": _stack(layers, lambda l: _t(l.output.dense.bias)),
        "ln2_scale": _stack(layers, lambda l: _t(l.output.LayerNorm.weight)),
        "ln2_bias": _stack(layers, lambda l: _t(l.output.LayerNorm.bias)),
    }
    params: Dict[str, Any] = {
        "tok_embed": _t(emb.word_embeddings.weight),
        "pos_embed": _t(emb.position_embeddings.weight),
        "type_embed": _t(emb.token_type_embeddings.weight),
        "embed_ln": {"scale": _t(emb.LayerNorm.weight), "bias": _t(emb.LayerNorm.bias)},
        "blocks": blocks,
    }
    D, C = config["d_model"], config["num_classes"]
    pooler = getattr(bert, "pooler", None)
    if pooler is not None:
        params["pooler"] = {"w": _lin_w(pooler.dense), "b": _t(pooler.dense.bias)}
    else:
        params["pooler"] = {"w": np.eye(D, dtype=np.float32), "b": np.zeros(D, np.float32)}
    classifier = getattr(model, "classifier", None)
    if classifier is not None and hasattr(classifier, "weight"):
        params["classifier"] = {"w": _lin_w(classifier), "b": _t(classifier.bias)}
    else:
        params["classifier"] = {"w": np.zeros((D, C), np.float32),
                                "b": np.zeros((C,), np.float32)}
    return config, params


def convert_hf_llama(model) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """transformers LlamaForCausalLM -> (jax_config dict, DecoderLM params).
    HF's rotate-half RoPE is ``models/llm``'s half-split one, the q/k/v
    columns are head-major on both sides, and the SwiGLU gate/up/down map
    to w1/w3/w2: the weights carry over without a permutation."""
    hf_cfg = model.config
    scaling = getattr(hf_cfg, "rope_scaling", None)
    if scaling and (scaling.get("rope_type") or scaling.get("type")) not in (None, "default"):
        raise ValueError(
            f"DecoderLM implements unscaled RoPE; checkpoint uses "
            f"rope_scaling={scaling!r} — conversion would serve wrong logits"
        )
    if getattr(hf_cfg, "attention_bias", False) or getattr(hf_cfg, "mlp_bias", False):
        raise ValueError("DecoderLM has no attention/mlp biases; checkpoint uses them")
    act = getattr(hf_cfg, "hidden_act", "silu")
    if act != "silu":
        raise ValueError(f"DecoderLM implements SwiGLU (silu); checkpoint uses {act!r}")
    inner = model.model
    layers = list(inner.layers)
    config = {
        "vocab_size": hf_cfg.vocab_size,
        "d_model": hf_cfg.hidden_size,
        "n_layers": hf_cfg.num_hidden_layers,
        "n_heads": hf_cfg.num_attention_heads,
        "n_kv_heads": getattr(hf_cfg, "num_key_value_heads", hf_cfg.num_attention_heads),
        "d_ff": hf_cfg.intermediate_size,
        "max_seq": hf_cfg.max_position_embeddings,
        "rope_theta": float(getattr(hf_cfg, "rope_theta", 10000.0)),
        # checkpoint families differ (1e-6 or 1e-5): carried over
        "norm_eps": float(getattr(hf_cfg, "rms_norm_eps", 1e-5)),
    }
    blocks = {
        "ln1": _stack(layers, lambda l: _t(l.input_layernorm.weight)),
        "wq": _stack(layers, lambda l: _lin_w(l.self_attn.q_proj)),
        "wk": _stack(layers, lambda l: _lin_w(l.self_attn.k_proj)),
        "wv": _stack(layers, lambda l: _lin_w(l.self_attn.v_proj)),
        "wo": _stack(layers, lambda l: _lin_w(l.self_attn.o_proj)),
        "ln2": _stack(layers, lambda l: _t(l.post_attention_layernorm.weight)),
        "w1": _stack(layers, lambda l: _lin_w(l.mlp.gate_proj)),
        "w3": _stack(layers, lambda l: _lin_w(l.mlp.up_proj)),
        "w2": _stack(layers, lambda l: _lin_w(l.mlp.down_proj)),
    }
    params = {
        "embed": _t(inner.embed_tokens.weight),
        "blocks": blocks,
        "ln_f": _t(inner.norm.weight),
        "unembed": _lin_w(model.lm_head),
    }
    return config, params


def convert_hf_vit(model) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """transformers ViTForImageClassification/ViTModel ->
    (jax_config dict, ViTClassifier params)."""
    vit = getattr(model, "vit", model)
    hf_cfg = model.config
    act = getattr(hf_cfg, "hidden_act", "gelu")
    if act not in ("gelu", "gelu_python"):  # both are the exact erf gelu
        raise ValueError(
            f"ViTClassifier implements exact gelu; checkpoint uses "
            f"hidden_act={act!r} — conversion would serve wrong logits"
        )
    channels = int(getattr(hf_cfg, "num_channels", 3))
    if channels != 3:
        # the patchify reshape is RGB only
        raise ValueError(
            f"ViTClassifier expects 3 input channels; checkpoint has {channels}"
        )
    if not hasattr(vit, "encoder") or not hasattr(vit, "embeddings"):
        raise ValueError(
            f"unsupported checkpoint structure {type(model).__name__}; "
            "convert a plain ViTForImageClassification (DeiT/Swin/ConvNeXt "
            "layouts differ)"
        )
    layers = list(vit.encoder.layer)
    emb = vit.embeddings
    P = hf_cfg.patch_size
    config = {
        "image_size": hf_cfg.image_size,
        "patch_size": P,
        "d_model": hf_cfg.hidden_size,
        "n_layers": hf_cfg.num_hidden_layers,
        "n_heads": hf_cfg.num_attention_heads,
        "d_ff": hf_cfg.intermediate_size,
        "num_classes": getattr(hf_cfg, "num_labels", 1000),
        "ln_eps": float(getattr(hf_cfg, "layer_norm_eps", 1e-12)),
    }
    # Conv2d patch projection [D, 3, P, P] -> matmul weight [P*P*3, D]: the
    # patch vectors flatten (row, col, channel)
    conv = emb.patch_embeddings.projection
    patch_w = _t(conv.weight).transpose(2, 3, 1, 0).reshape(P * P * 3, -1)

    def attn(l):
        return l.attention.attention if hasattr(l.attention, "attention") else l.attention

    blocks = {
        "ln1_scale": _stack(layers, lambda l: _t(l.layernorm_before.weight)),
        "ln1_bias": _stack(layers, lambda l: _t(l.layernorm_before.bias)),
        "wq": _stack(layers, lambda l: _lin_w(attn(l).query)),
        "wq_b": _stack(layers, lambda l: _t(attn(l).query.bias)),
        "wk": _stack(layers, lambda l: _lin_w(attn(l).key)),
        "wk_b": _stack(layers, lambda l: _t(attn(l).key.bias)),
        "wv": _stack(layers, lambda l: _lin_w(attn(l).value)),
        "wv_b": _stack(layers, lambda l: _t(attn(l).value.bias)),
        "wo": _stack(layers, lambda l: _lin_w(l.attention.output.dense)),
        "wo_b": _stack(layers, lambda l: _t(l.attention.output.dense.bias)),
        "ln2_scale": _stack(layers, lambda l: _t(l.layernorm_after.weight)),
        "ln2_bias": _stack(layers, lambda l: _t(l.layernorm_after.bias)),
        "w1": _stack(layers, lambda l: _lin_w(l.intermediate.dense)),
        "w1_b": _stack(layers, lambda l: _t(l.intermediate.dense.bias)),
        "w2": _stack(layers, lambda l: _lin_w(l.output.dense)),
        "w2_b": _stack(layers, lambda l: _t(l.output.dense.bias)),
    }
    params: Dict[str, Any] = {
        "patch_embed": {"w": patch_w, "b": _t(conv.bias)},
        "cls_token": _t(emb.cls_token),
        "pos_embed": _t(emb.position_embeddings)[0],
        "blocks": blocks,
        "ln_f": {"scale": _t(vit.layernorm.weight), "bias": _t(vit.layernorm.bias)},
    }
    D, C = config["d_model"], config["num_classes"]
    classifier = getattr(model, "classifier", None)
    if classifier is not None and hasattr(classifier, "weight"):
        params["head"] = {"w": _lin_w(classifier), "b": _t(classifier.bias)}
    else:
        params["head"] = {"w": np.zeros((D, C), np.float32), "b": np.zeros((C,), np.float32)}
    return config, params


def export_model(family: str, config: Dict[str, Any], params: Dict[str, Any],
                 out_dir: str) -> str:
    """Write ``<out_dir>/jax_config.json`` and ``<out_dir>/params.npz``
    (:func:`save_npz`): the directory ``TorchServer`` and
    ``GenerateServer`` load as a model URI."""
    os.makedirs(out_dir, exist_ok=True)
    save_npz(params, os.path.join(out_dir, "params.npz"))
    with open(os.path.join(out_dir, "jax_config.json"), "w") as f:
        json.dump({"family": family, "config": config, "checkpoint": "params.npz"}, f, indent=2)
    logger.info("exported %s model to %s", family, out_dir)
    return out_dir


HF_FAMILIES = {
    "bert": convert_hf_bert,
    "llama": convert_hf_llama,
    "vit": convert_hf_vit,
}
# exported family names are the zoo registry's
ZOO_FAMILY = {"bert": "bert", "llama": "llm", "vit": "vit"}


def convert_hf(name_or_path: str, family: str, out_dir: str) -> str:
    """Load a transformers checkpoint (a hub name or a local directory)
    and export it."""
    if family not in HF_FAMILIES:
        raise ValueError(f"unknown family {family!r}; supported: {sorted(HF_FAMILIES)}")
    if family == "bert":
        from transformers import AutoConfig, AutoModelForSequenceClassification

        archs = AutoConfig.from_pretrained(name_or_path).architectures or []
        if not any("ForSequenceClassification" in a for a in archs):
            # such a checkpoint would load with a random classifier head
            raise ValueError(
                f"checkpoint {name_or_path!r} has no classification head "
                f"(architectures={archs}); fine-tune one or convert a "
                "ForSequenceClassification checkpoint"
            )
        model = AutoModelForSequenceClassification.from_pretrained(name_or_path)
    elif family == "vit":
        from transformers import AutoConfig, AutoModelForImageClassification

        archs = AutoConfig.from_pretrained(name_or_path).architectures or []
        if not any(a == "ViTForImageClassification" for a in archs):
            # a backbone would load with a random head; other vision
            # families lay their weights out otherwise
            raise ValueError(
                f"checkpoint {name_or_path!r} is not a plain "
                f"ViTForImageClassification (architectures={archs})"
            )
        model = AutoModelForImageClassification.from_pretrained(name_or_path)
    else:
        from transformers import AutoModelForCausalLM

        model = AutoModelForCausalLM.from_pretrained(name_or_path)
    config, params = HF_FAMILIES[family](model)
    return export_model(ZOO_FAMILY[family], config, params, out_dir)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("seldon-tpu-torch-export")
    parser.add_argument("--hf", required=True, help="transformers model name or local path")
    parser.add_argument("--family", required=True, choices=sorted(HF_FAMILIES))
    parser.add_argument("--out", required=True, help="output model directory (a model URI)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    convert_hf(args.hf, args.family, args.out)
    print(f"exported: {args.out} (serve it as a TorchServer/GenerateServer model_uri)")


if __name__ == "__main__":
    main()
