"""Retrieval + rerank model families: the RAG graph's middle stages.

Counterpart of ``seldon_core_tpu/models/retrieval.py``. The RAG graph
chains ``embed -> retrieve -> rerank -> generate``:

* **retrieval**: :class:`RetrievalIndex`, dense top-k over an embedding
  matrix on the device. Input is a query embedding ``[B, E]`` (a bert
  embedder's logits with ``num_classes = d_embed``); output is the query
  concatenated with the top-k candidate doc indices, ``[B, E+K]``
  float32, so the whole hop stays one tensor and a fused segment keeps
  it on the device.
* **reranker**: :class:`Reranker`, gathers the candidates' embeddings,
  scores each ``concat(query, candidate)`` with an MLP head (the zoo's
  :class:`~seldon_core_tpu_torch.models.mlp.MLP`), picks the winner and
  emits its document's token row ``[B, L]`` int32: the prompt the
  generate unit decodes (``RAG_PROMPT_BUILDER`` bridges the tensor to
  the request body).

Both families derive the corpus (embeddings + doc token rows) from the
same deterministic helper, the JAX package's ``jax.random`` key chain
reproduced by :mod:`seldon_core_tpu_torch.rng`, so two units configured
with the same ``seed``/``corpus_size``/``d_embed``/``doc_len``/
``vocab_size`` serve the SAME corpus without sharing parameters, under
either package (doc rows bit for bit, embeddings within the few float32
ulps of ``rng.normal``).

Precision note: graph hops downcast floating tensors to the component's
compute dtype (bfloat16 by default), so candidate INDICES ride the
rerank hop as bf16 floats. Integers are exact in bf16 only up to 256:
``corpus_size`` is therefore capped at 256 (validated at build), which
keeps fused and hop-by-hop execution byte-identical.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import rng
from ..device import resolve_device
from .base import ServedModel, torch_dtype

# the largest integer bf16 represents exactly (8 mantissa bits): doc
# indices above this would be rounded by the hop downcast
_BF16_EXACT_INT_MAX = 256


def corpus_params(seed: int, corpus_size: int, d_embed: int, doc_len: int,
                  vocab_size: int, device="cuda"):
    """The ONE corpus derivation shared by both families: embeddings
    ``[N, E]`` float32 and doc token rows ``[N, L]`` int32 (ids in
    ``[1, vocab)``; 0 is PAD everywhere in the zoo), drawn on ``device``
    from ``PRNGKey(seed ^ 0x5EED)`` split in two, as the JAX package
    draws them."""
    dev = resolve_device(device)
    ke, kd = rng.split(rng.prng_key(seed ^ 0x5EED, device=dev))
    emb = rng.normal(ke, (corpus_size, d_embed))
    docs = rng.randint(kd, (corpus_size, doc_len), 1, vocab_size)
    return emb, docs


@dataclasses.dataclass
class RetrievalConfig:
    corpus_size: int = 128
    d_embed: int = 32
    top_k: int = 4
    doc_len: int = 8
    vocab_size: int = 256
    seed: int = 0
    dtype: str = "bfloat16"


def _cfg(cls, config):
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in config.items() if k in fields})


def _check_corpus(cfg) -> None:
    if cfg.corpus_size > _BF16_EXACT_INT_MAX:
        raise ValueError(
            f"corpus_size {cfg.corpus_size} > {_BF16_EXACT_INT_MAX}: "
            "candidate indices ride graph hops as bf16 floats and stop "
            "being exact integers past 256"
        )


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k``'s indices: the ``k`` largest scores per row, highest
    first, equal scores in index order (a stable descending sort, the
    same order on the CPU and on CUDA; ``torch.topk`` promises no order
    among ties)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


class RetrievalIndex(ServedModel):
    """Dense top-k retrieval: ``scores = q @ E.T`` as a float32 product of
    the compute-dtype operands, indices by :func:`top_k_indices`."""

    def __init__(self, device=None, **config):
        self.cfg = _cfg(RetrievalConfig, config)
        _check_corpus(self.cfg)
        if self.cfg.top_k > self.cfg.corpus_size:
            raise ValueError(
                f"top_k {self.cfg.top_k} > corpus_size {self.cfg.corpus_size}"
            )
        self.example_input_shape = (self.cfg.d_embed,)
        self.compute_dtype = self.cfg.dtype
        self.dtype = torch_dtype(self.cfg.dtype)

    def init_params(self, seed: int = 0, device="cuda"):
        cfg = self.cfg
        emb, _docs = corpus_params(
            cfg.seed or seed, cfg.corpus_size, cfg.d_embed, cfg.doc_len,
            cfg.vocab_size, device=device,
        )
        return {"emb": emb}

    def apply(self, params, q):
        """q [B, E] -> [B, E+K] float32: the query rows (exact upcast)
        followed by the top-k candidate indices as floats."""
        q = q.to(self.dtype)
        scores = q.float() @ params["emb"].to(self.dtype).float().T  # [B, N]
        idx = top_k_indices(scores, self.cfg.top_k)
        return torch.cat([q.float(), idx.float()], dim=-1)

    def flops_per_row(self, *_a) -> float:
        return 2.0 * self.cfg.corpus_size * self.cfg.d_embed


@dataclasses.dataclass
class RerankConfig(RetrievalConfig):
    hidden: tuple = (32,)


class Reranker(ServedModel):
    """MLP reranker over the retrieval stage's candidates: gather each
    candidate's embedding, score ``concat(query, candidate)`` with an
    MLP head, emit the winning document's token row."""

    def __init__(self, device=None, **config):
        from .mlp import MLP

        self.cfg = _cfg(RerankConfig, config)
        _check_corpus(self.cfg)
        hidden = self.cfg.hidden
        if isinstance(hidden, (int, float)):
            hidden = (int(hidden),)
        self._scorer = MLP(
            in_features=2 * self.cfg.d_embed, hidden=tuple(hidden),
            num_classes=2, dtype=self.cfg.dtype,
        )
        self.example_input_shape = (self.cfg.d_embed + self.cfg.top_k,)
        self.compute_dtype = self.cfg.dtype
        self.dtype = torch_dtype(self.cfg.dtype)

    def init_params(self, seed: int = 0, device="cuda"):
        """The shared corpus, and the scorer from the port's MLP init
        (``torch.Generator``: its numbers differ from the JAX package's)."""
        cfg = self.cfg
        emb, docs = corpus_params(
            cfg.seed or seed, cfg.corpus_size, cfg.d_embed, cfg.doc_len,
            cfg.vocab_size, device=device,
        )
        return {
            "emb": emb,
            "docs": docs,
            "scorer": self._scorer.init_params(cfg.seed or seed, device=device),
        }

    def apply(self, params, x):
        """x [B, E+K] (query ++ candidate indices) -> winning doc token
        rows [B, L] int32."""
        E = self.cfg.d_embed
        x = x.to(self.dtype)
        q = x[:, :E]                                        # [B, E]
        idx = x[:, E:].to(torch.int64)                      # [B, K] (exact <= 256)
        cand = params["emb"][idx].to(self.dtype)            # [B, K, E]
        feats = torch.cat([q[:, None, :].expand_as(cand), cand], dim=-1)  # [B, K, 2E]
        # MLP softmax head: p(class 0) is the relevance score (any
        # strictly monotonic readout works; this one reuses the zoo's
        # smallest family unchanged)
        probs = self._scorer.apply(params["scorer"], feats)  # [B, K, 2]
        best = torch.argmax(probs[..., 0], dim=-1)            # [B], first maximum
        doc_id = torch.gather(idx, 1, best[:, None])[:, 0]
        return params["docs"][doc_id]                         # [B, L] int32

    def flops_per_row(self, *_a) -> float:
        cfg = self.cfg
        dims = (2 * cfg.d_embed, *self._scorer.hidden, 2)
        mlp = sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:]))
        return cfg.top_k * mlp
