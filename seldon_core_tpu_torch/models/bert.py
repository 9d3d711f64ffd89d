"""BERT-base text classifier family.

Counterpart of ``seldon_core_tpu/models/bert.py``: a post-LN encoder
(original BERT) with an exact (erf) GELU FFN, learned position
embeddings and type embedding 0, a padding mask from token id 0, a tanh
pooler on [CLS] and a float32 classification head. Layers are stacked on
a leading axis as in the JAX package and run one after another.

Dtypes follow the JAX forward step for step: the embedding sum in
float32, the attention scores, the padding bias (-1e30) and the softmax
in float32 (so a row the micro-batcher padded with token 0, where every
key is masked, gives a uniform softmax and finite logits, where a bf16
bias would round to -inf and give NaN), everything else in the compute
dtype. The attention is dense and non-causal: PyTorch ops, as XLA
lowered it in the JAX package.
Under a serving mesh (``param_sharding``) each layer's weights are
gathered onto the compute device as the forward reaches them
(``ServedModel._layer``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..device import resolve_device
from .base import ServedModel, encoder_param_sharding, layer_norm, torch_dtype

# BERT's canonical LayerNorm eps
_BERT_LN_EPS = 1e-12
NEG_BIAS = -1e30


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 512
    type_vocab: int = 2
    num_classes: int = 2
    dtype: str = "bfloat16"

    @property
    def head_dim(self):
        return self.d_model // self.n_heads


# the stacked per-layer weights the forward casts to the compute dtype
_CAST = ("wq", "wq_b", "wk", "wk_b", "wv", "wv_b", "wo", "wo_b", "w1", "w1_b", "w2", "w2_b")


class BertClassifier(ServedModel):
    def __init__(self, device=None, **config):
        fields = {f.name for f in dataclasses.fields(BertConfig)}
        self.cfg = BertConfig(**{k: v for k, v in config.items() if k in fields})
        self.example_input_shape = (min(64, self.cfg.max_seq),)
        self.compute_dtype = self.cfg.dtype
        self.dtype = torch_dtype(self.cfg.dtype)

    def init_params(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random float32 params with the JAX package's shapes and scales
        (normal times 0.02, zero biases, unit LayerNorm scales) from a
        ``torch.Generator`` seeded with ``seed``: the numbers differ from
        the JAX package's ``init_params(seed)``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        cfg = self.cfg
        D, L, F_, V = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab_size

        def init(shape, scale=0.02):
            return torch.randn(shape, generator=gen, device=dev) * scale

        def zeros(*shape):
            return torch.zeros(shape, device=dev)

        def ones(*shape):
            return torch.ones(shape, device=dev)

        return {
            "tok_embed": init((V, D)),
            "pos_embed": init((cfg.max_seq, D)),
            "type_embed": init((cfg.type_vocab, D)),
            "embed_ln": {"scale": ones(D), "bias": zeros(D)},
            "blocks": {
                "wq": init((L, D, D)), "wq_b": zeros(L, D),
                "wk": init((L, D, D)), "wk_b": zeros(L, D),
                "wv": init((L, D, D)), "wv_b": zeros(L, D),
                "wo": init((L, D, D)), "wo_b": zeros(L, D),
                "ln1_scale": ones(L, D), "ln1_bias": zeros(L, D),
                "w1": init((L, D, F_)), "w1_b": zeros(L, F_),
                "w2": init((L, F_, D)), "w2_b": zeros(L, D),
                "ln2_scale": ones(L, D), "ln2_bias": zeros(L, D),
            },
            "pooler": {"w": init((D, D)), "b": zeros(D)},
            "classifier": {"w": init((D, cfg.num_classes)), "b": zeros(cfg.num_classes)},
        }

    def param_sharding(self, mesh, params):
        """The JAX package's BERT layout: see
        :func:`~seldon_core_tpu_torch.models.base.encoder_param_sharding`."""
        return encoder_param_sharding(mesh, params)

    def prepare(self, params) -> Dict[str, Any]:
        """The matmul weights and biases in the compute dtype (the casts
        the JAX forward makes at each use, made once). A split leaf is
        cast block by block and stays split."""
        dt = self.dtype
        blocks = params["blocks"]
        return {
            "blocks": {k: (blocks[k].to(dt) if k in _CAST else blocks[k]) for k in blocks},
            "pooler": (params["pooler"]["w"].to(dt), params["pooler"]["b"].to(dt)),
        }

    def apply(self, params, tokens):
        """tokens [B, T] integer ids (0 = PAD) -> class logits [B, classes]
        (float32)."""
        cfg = self.cfg
        dt = self.dtype
        p = self.prepared(params)
        tokens = tokens.long()
        B, T = tokens.shape
        H, Dh = cfg.n_heads, cfg.head_dim
        x = (
            params["tok_embed"][tokens].float()
            + params["pos_embed"][None, :T].float()
            + params["type_embed"][0][None, None].float()
        )
        ln = params["embed_ln"]
        x = layer_norm(x.to(dt), ln["scale"], ln["bias"], _BERT_LN_EPS)
        attn_bias = torch.where(
            tokens != 0, 0.0, NEG_BIAS).to(torch.float32)[:, None, None, :]  # [B,1,1,T]
        scale = math.sqrt(Dh)

        def heads(t):
            return t.reshape(B, T, H, Dh).transpose(1, 2)

        blocks = p["blocks"]
        for i in range(cfg.n_layers):
            w = self._layer(blocks, i)
            q = heads(x @ w["wq"] + w["wq_b"])
            k = heads(x @ w["wk"] + w["wk_b"])
            v = heads(x @ w["wv"] + w["wv_b"])
            s = q.float() @ k.float().transpose(-1, -2)
            s = s / scale + attn_bias
            a = torch.softmax(s, dim=-1)
            o = (a @ v.float()).to(dt)
            o = o.transpose(1, 2).reshape(B, T, H * Dh)
            o = o @ w["wo"] + w["wo_b"]
            x = layer_norm(x + o, w["ln1_scale"], w["ln1_bias"], _BERT_LN_EPS)
            # exact (erf) gelu — original BERT and HF checkpoints use it
            f = F.gelu(x @ w["w1"] + w["w1_b"], approximate="none")
            f = f @ w["w2"] + w["w2_b"]
            x = layer_norm(x + f, w["ln2_scale"], w["ln2_bias"], _BERT_LN_EPS)
        pw, pb = p["pooler"]
        pooled = torch.tanh(x[:, 0] @ pw + pb)
        head = params["classifier"]
        return pooled.float() @ head["w"] + head["b"]

    def flops_per_row(self, seq_len: int = None) -> float:
        """Matmul FLOPs for one sequence of ``seq_len`` tokens (default:
        example_input_shape): per token per layer 8*D^2 (qkv+out) + 4*T*D
        (scores + attn*V) + 4*D*F (FFN), plus pooler + classifier head."""
        cfg = self.cfg
        T = int(seq_len or self.example_input_shape[0])
        D, F_ = cfg.d_model, cfg.d_ff
        per_token = cfg.n_layers * (8.0 * D * D + 4.0 * T * D + 4.0 * D * F_)
        return T * per_token + 2.0 * D * D + 2.0 * D * cfg.num_classes
