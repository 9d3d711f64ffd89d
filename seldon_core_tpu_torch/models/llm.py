"""DecoderLM: Llama-style decoder-only transformer, serving half.

Counterpart of ``seldon_core_tpu/models/llm.py``: RMSNorm, rotary
embeddings, grouped-query attention, SwiGLU FFN, untied unembed. The
parameter dict has the JAX package's keys and shapes (layers stacked on
a leading axis), so weights carry across one-to-one.

Ported: the dense forward (``apply``), batched ``prefill`` (its
attention runs the hand-written CUDA flash kernel on the card), the
ragged one-position decode over a per-layer cache
(``decode_step_ragged_list``, with a separate write position for the
fused stop-aware burst), ``prefill_chunk`` (one chunk of a long prompt
into a staging slab), ``prefill_with_prefix`` (a suffix prefill over a
cached prefix slab), ``generate``, ``init_params`` and the analytic
counts. Not ported yet: MoE, the tp/sp/ep parallel paths,
``decode_chunk_ragged_list`` and the training loss.

Layouts match the JAX package exactly: per-layer caches
``[B, KV, T, Dh]``, the prefill slab ``[L, B, KV, Tb, Dh]``, and q/k/v
``[B, H, T, Dh]`` at the attention call. Where JAX donated a buffer
(the decode cache), this port writes into the tensor in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch

from .. import rng
from ..device import resolve_device
from ..ops.flash_attention import attention as prefill_attention
from .base import ServedModel, torch_dtype

NEG_INF = -1e30


@dataclasses.dataclass
class LLMConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1408
    max_seq: int = 2048
    rope_theta: float = 10000.0
    # MoE: 0 experts = dense SwiGLU everywhere (the only mode ported)
    n_experts: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # scale on the residual-writing projections (wo, w2) at init
    residual_scale: float = 1.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _rms_norm(x, w, eps=1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.reciprocal(torch.sqrt(var + eps))).to(x.dtype) * w


def _rope(x, positions, theta: float):
    """x: [B, H, T, Dh]; positions: [B, T] or [T]."""
    dh = x.shape[-1]
    half = dh // 2
    exponent = torch.arange(half, dtype=torch.float32, device=x.device) / half
    # a Python-scalar base: no host-to-device copy, so the decode step
    # captures into a CUDA graph (same float32 pow as a 0-dim tensor base)
    freqs = 1.0 / torch.pow(float(theta), exponent)
    pos = positions.to(torch.float32)
    if positions.dim() == 1:
        angles = (pos[:, None] * freqs[None, :])[None, None]  # [1,1,T,half]
    else:
        angles = pos[:, None, :, None] * freqs[None, None, None, :]  # [B,1,T,half]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


class DecoderLM(ServedModel):
    def __init__(self, **config):
        cfg_fields = {f.name for f in dataclasses.fields(LLMConfig)}
        extra = {k: v for k, v in config.items() if k not in cfg_fields}
        self.cfg = LLMConfig(**{k: v for k, v in config.items() if k in cfg_fields})
        if self.cfg.n_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts DecoderLM (n_experts > 0) is not ported to "
                "seldon_core_tpu_torch yet"
            )
        self._extra = extra
        self.example_input_shape = (16,)  # token ids
        self.compute_dtype = self.cfg.dtype

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

    # ------------------------------------------------------------------
    # analytic counts
    # ------------------------------------------------------------------

    def flops_per_token(self, context_len: float) -> float:
        """Matmul FLOPs to process ONE token attending over ``context_len``
        keys: q/kv/out projections + scores/attn*V + gated FFN + lm head."""
        cfg = self.cfg
        D, F = cfg.d_model, cfg.d_ff
        kv_dim = cfg.n_kv_heads * cfg.head_dim
        per_layer = (
            2.0 * D * D                  # q proj
            + 2.0 * 2.0 * D * kv_dim     # k,v proj
            + 2.0 * D * D                # out proj
            + 4.0 * context_len * D      # scores + attn*V
            + 6.0 * D * F                # SwiGLU: gate, up, down
        )
        return cfg.n_layers * per_layer + 2.0 * D * cfg.vocab_size

    def n_params(self) -> int:
        """Exact parameter count of ``init_params``' dict (closed form)."""
        cfg = self.cfg
        D, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
        kv = cfg.n_kv_heads * cfg.head_dim
        h = cfg.n_heads * cfg.head_dim
        per_layer = 2 * D + D * h + 2 * D * kv + h * D + 3 * D * F
        return L * per_layer + 2 * V * D + D  # blocks + embed/unembed + ln_f

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------

    def init_params(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random float32 params with the JAX package's shapes and scales
        (normal draws times 1/sqrt(fan-in), residual projections times
        ``residual_scale``, norms at one). The draws come from a
        ``torch.Generator`` seeded with ``seed`` on ``device``, so the
        numbers differ from ``seldon_core_tpu``'s ``init_params(seed)``;
        to serve the JAX package's weights, convert them with
        :func:`seldon_core_tpu_torch.convert.params_from_numpy`."""
        dev = resolve_device(device)
        cfg = self.cfg
        D, H, KV, Dh, F, L, V = (
            cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.n_layers, cfg.vocab_size,
        )
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

        def init(shape, scale):
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * scale

        s = 1.0 / math.sqrt(D)
        rs = float(cfg.residual_scale)
        blocks = {
            "ln1": torch.ones((L, D), dtype=torch.float32, device=dev),
            "wq": init((L, D, H * Dh), s),
            "wk": init((L, D, KV * Dh), s),
            "wv": init((L, D, KV * Dh), s),
            "wo": init((L, H * Dh, D), rs / math.sqrt(H * Dh)),
            "ln2": torch.ones((L, D), dtype=torch.float32, device=dev),
            "w1": init((L, D, F), s),
            "w3": init((L, D, F), s),
            "w2": init((L, F, D), rs / math.sqrt(F)),
        }
        return {
            "embed": init((V, D), 1.0),
            "blocks": blocks,
            "ln_f": torch.ones((D,), dtype=torch.float32, device=dev),
            "unembed": init((D, V), s),
        }

    # ------------------------------------------------------------------
    # forward building blocks
    # ------------------------------------------------------------------

    @staticmethod
    def _layer(blocks, l: int) -> Dict[str, torch.Tensor]:
        return {name: w[l] for name, w in blocks.items()}

    def _qkv(self, p, x, positions):
        """Norm + q/k/v projections + RoPE: q [B,H,T,Dh], k/v [B,KV,T,Dh]."""
        cfg = self.cfg
        dt = x.dtype
        B, T, _ = x.shape
        h = _rms_norm(x, p["ln1"].to(dt), cfg.norm_eps)
        q = h @ p["wq"].to(dt)
        k = h @ p["wk"].to(dt)
        v = h @ p["wv"].to(dt)
        Dh = cfg.head_dim
        q = q.reshape(B, T, -1, Dh).transpose(1, 2)
        k = k.reshape(B, T, -1, Dh).transpose(1, 2)
        v = v.reshape(B, T, -1, Dh).transpose(1, 2)
        return _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta), v

    def _ffn(self, p, x):
        cfg = self.cfg
        dt = x.dtype
        h = _rms_norm(x, p["ln2"].to(dt), cfg.norm_eps)
        a = h @ p["w1"].to(dt)
        g = h @ p["w3"].to(dt)
        return (torch.nn.functional.silu(a) * g) @ p["w2"].to(dt)

    def _merge_heads(self, p, o):
        """[B, H, T, Dh] attention output -> residual update [B, T, D]."""
        B, H, T, Dh = o.shape
        o = o.transpose(1, 2).reshape(B, T, H * Dh)
        return o @ p["wo"].to(o.dtype)

    @staticmethod
    def _cache_attention(q, kc, vc, bound, dt):
        """Attention over the (sliced) KV cache with a ``key_pos <= bound``
        mask, reading the grouped cache without a head-repeated copy: q is
        viewed as [B, KV, rep, T, Dh] and both products batch over
        (B, KV). Scores in f32, masked at -1e30, softmax weights cast to
        the compute dtype before the weighted sum (as the JAX package).
        ``bound``: [B] (one-position decode: every query row masks to its
        own prefix) or [B, T] (a chunk: prefix plus in-window causality)."""
        B, Hl, T, Dh = q.shape
        KVl, Ta = kc.shape[1], kc.shape[2]
        rep = Hl // KVl
        key_pos = torch.arange(Ta, device=q.device)
        if bound.dim() == 2:
            # rows of qg run (rep, T): tile the [B, T] bound rep times
            mask = key_pos[None, None, None, :] <= bound.repeat(1, rep)[:, None, :, None]
        else:
            mask = key_pos[None, None, None, :] <= bound[:, None, None, None]
        # the rep query heads of a group ride the row axis of one product
        qg = q.reshape(B, KVl, rep * T, Dh).float()
        s = torch.matmul(qg, kc.float().transpose(-1, -2)) / math.sqrt(Dh)
        s = torch.where(mask, s, NEG_INF)  # [B, KV, rep*T, Ta]
        w = torch.softmax(s, dim=-1).to(dt)
        o = torch.matmul(w, vc.to(dt))  # [B, KV, rep*T, Dh]
        return o.reshape(B, Hl, T, Dh)

    # ------------------------------------------------------------------
    # single-device serving forward
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def apply(self, params, tokens):
        """tokens [B, T] int -> logits [B, T, V] (float32)."""
        cfg = self.cfg
        dt = self.dtype
        tokens = tokens.long()
        x = params["embed"][tokens].to(dt)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        blocks = params["blocks"]
        for l in range(cfg.n_layers):
            p = self._layer(blocks, l)
            q, k, v = self._qkv(p, x, positions)
            x = x + self._merge_heads(p, prefill_attention(q, k, v, causal=True))
            x = x + self._ffn(p, x)
        x = _rms_norm(x, params["ln_f"].to(dt), cfg.norm_eps)
        return (x @ params["unembed"].to(dt)).float()

    def _decode_head(self, params, x):
        """Final norm + unembed of the last-position residual stream."""
        dt = self.dtype
        x = _rms_norm(x, params["ln_f"].to(dt), self.cfg.norm_eps)
        return (x[:, 0] @ params["unembed"].to(dt)).float()

    def _decode_layer(self, p, x, pos, ck, cv, attn_len, write_pos):
        """One decoder layer with KV-cache attention at per-row positions
        ``pos`` [B]. This step's K/V land in ``ck``/``cv`` [B, KV, T, Dh]
        in place at ``write_pos`` [B]; a row whose write position lies at
        or past the cache length writes nothing (the JAX package's
        out-of-bounds scatter is a no-op), so a parked or finished lane
        never touches its cache."""
        B = x.shape[0]
        T = ck.shape[2]
        q, k, v = self._qkv(p, x, pos[:, None])
        rows = torch.arange(B, device=x.device)
        inb = (write_pos < T)[:, None, None]
        wp = write_pos.clamp(max=T - 1)
        ck[rows, :, wp] = torch.where(inb, k[:, :, 0], ck[rows, :, wp])
        cv[rows, :, wp] = torch.where(inb, v[:, :, 0], cv[rows, :, wp])
        kc, vc = ck, cv
        if attn_len is not None and attn_len < T:
            # read only the prefix the scheduler proved can hold keys; the
            # full cache is still written above
            kc, vc = ck[:, :, :attn_len], cv[:, :, :attn_len]
        o = self._cache_attention(q, kc, vc, pos, x.dtype)
        x = x + self._merge_heads(p, o)
        return x + self._ffn(p, x)

    @torch.inference_mode()
    def decode_step_ragged_list(self, params, ks: List[torch.Tensor],
                                vs: List[torch.Tensor], tokens, pos,
                                attn_len: Optional[int] = None, write_pos=None):
        """Ragged decode step over an UNSTACKED cache: ``ks``/``vs`` are
        per-layer lists of [B, KV, T, Dh] tensors, written in place (the
        JAX package donates them). ``tokens`` [B, 1], ``pos`` [B]: every
        row sits at its own position. ``attn_len`` (int) bounds the
        attention read. ``write_pos`` ([B], optional) is where each row's
        K/V land when that differs from ``pos``: the fused stop-aware
        burst parks finished lanes at the cache length, which writes
        nothing. Returns ``(logits [B, V], ks, vs)``."""
        dt = self.dtype
        pos = pos.long()
        wp = pos if write_pos is None else write_pos.long()
        x = params["embed"][tokens.long()].to(dt)  # [B,1,D]
        blocks = params["blocks"]
        for l in range(len(ks)):
            x = self._decode_layer(self._layer(blocks, l), x, pos, ks[l], vs[l],
                                   attn_len, wp)
        return self._decode_head(params, x), ks, vs

    @torch.inference_mode()
    def prefill(self, params, prompt, max_seq: int, last_index=None):
        """Batched prefill: ONE forward over the whole prompt [B, Tp]; K/V
        for all positions land in a fresh slab of length ``max_seq``.
        Returns ``(last-position logits [B, V], {"k","v"}: [L, B, KV,
        max_seq, Dh])``. ``last_index`` ([B], optional): per-row index of
        the last real prompt token when the batch is right-padded to a
        bucket length; defaults to the final position.

        Attention runs through :func:`ops.attention`: the CUDA flash
        kernel on the card, reading the grouped K/V in place."""
        cfg = self.cfg
        dt = self.dtype
        B, Tp = prompt.shape
        dev = prompt.device
        x = params["embed"][prompt.long()].to(dt)
        positions = torch.arange(Tp, device=dev)
        shape = (cfg.n_layers, B, cfg.n_kv_heads, max_seq, cfg.head_dim)
        slab_k = torch.zeros(shape, dtype=dt, device=dev)
        slab_v = torch.zeros(shape, dtype=dt, device=dev)
        blocks = params["blocks"]
        for l in range(cfg.n_layers):
            p = self._layer(blocks, l)
            q, k, v = self._qkv(p, x, positions)
            o = prefill_attention(q, k, v, causal=True)
            x = x + self._merge_heads(p, o)
            x = x + self._ffn(p, x)
            slab_k[l, :, :, :Tp] = k
            slab_v[l, :, :, :Tp] = v
        if last_index is None:
            x_last = x[:, -1]
        else:
            x_last = x[torch.arange(B, device=dev), last_index.long()]
        x_last = _rms_norm(x_last, params["ln_f"].to(dt), cfg.norm_eps)
        logits = (x_last @ params["unembed"].to(dt)).float()
        return logits, {"k": slab_k, "v": slab_v}

    @torch.inference_mode()
    def prefill_chunk(self, params, slab, tokens, start_pos: int, attn_len: int,
                      last_index=None, want_logits: bool = True):
        """Extend a STAGING prompt slab with one chunk, reading (not
        recomputing) the chunks before it: the model half of the
        batcher's chunked-prefill interleave (the JAX package's
        ``DecoderLM.prefill_chunk``).

        ``slab``: ``{"k","v"}`` of ``[L, B, KV, Tb, Dh]`` (the prefill
        slab layout the lane insert takes), valid for ``[0, start_pos)``
        and written here in place. ``tokens`` ``[B, C]``: token j sits at
        position ``start_pos + j``; ``start_pos + C`` must fit the slab
        (the JAX package's update clamps there; the batcher slides a last
        chunk back instead). Per layer the chunk's K/V land at
        ``start_pos`` and attention reads the slab up to ``attn_len``
        (``>= start_pos + C``) under the ``key_pos <= start_pos + j``
        bound, through the grouped cache attention (no flash kernel, as
        in the JAX package). Returns ``(logits [B, V] at last_index, or
        None when want_logits is False, slab)``: a mid-prompt chunk skips
        the final norm and the unembed."""
        cfg = self.cfg
        dt = self.dtype
        B, C = tokens.shape
        Tb = slab["k"].shape[3]
        start = int(start_pos)
        if start < 0 or start + C > Tb:
            raise ValueError(f"chunk [{start}, {start + C}) does not fit a slab of {Tb}")
        if not start + C <= attn_len <= Tb:
            raise ValueError(f"attn_len {attn_len} outside [{start + C}, {Tb}]")
        dev = tokens.device
        positions = (start + torch.arange(C, device=dev))[None, :].expand(B, C)
        x = params["embed"][tokens.long()].to(dt)
        blocks = params["blocks"]
        for l in range(cfg.n_layers):
            p = self._layer(blocks, l)
            q, k, v = self._qkv(p, x, positions)
            slab["k"][l, :, :, start:start + C] = k
            slab["v"][l, :, :, start:start + C] = v
            o = self._cache_attention(q, slab["k"][l, :, :, :attn_len],
                                      slab["v"][l, :, :, :attn_len], positions, dt)
            x = x + self._merge_heads(p, o)
            x = x + self._ffn(p, x)
        if not want_logits:
            return None, slab
        if last_index is None:
            x_last = x[:, -1]
        else:
            x_last = x[torch.arange(B, device=dev), last_index.long()]
        x_last = _rms_norm(x_last, params["ln_f"].to(dt), cfg.norm_eps)
        return (x_last @ params["unembed"].to(dt)).float(), slab

    @torch.inference_mode()
    def prefill_with_prefix(self, params, prefix_kv, tokens, start_pos: int,
                            last_index=None):
        """Suffix prefill over a CACHED prefix: the model half of the
        batcher's radix prefix cache (the JAX package's
        ``DecoderLM.prefill_with_prefix``).

        ``prefix_kv``: ``{"k","v"}`` of ``[L, 1, KV, Tp, Dh]`` (the
        ``cache_one`` layout) holding valid K/V for positions ``[0,
        start_pos)`` of this sequence; ``start_pos <= Tp``. ``tokens``
        ``[1, W]``: the rest of the prompt padded to a bucket; token j
        sits at absolute position ``start_pos + j``. Per layer the
        window's K/V are spliced into a W-extended copy of the prefix
        slab at ``start_pos`` and attention reads the combined ``Tp + W``
        positions under the ``key_pos <= start_pos + j`` bound, through
        the grouped cache attention (no flash kernel, as in the JAX
        package): the bound covers the cached prefix and in-window
        causality and masks the donor's residue past the match. The
        prefix slab is read, never written. Returns ``(logits [1, V] at
        last_index, suffix slab {"k","v"}: [L, 1, KV, W, Dh])``."""
        cfg = self.cfg
        dt = self.dtype
        B, W = tokens.shape
        Tp = prefix_kv["k"].shape[3]
        start = int(start_pos)
        if not 0 <= start <= Tp:
            raise ValueError(f"start_pos {start} outside a prefix slab of {Tp}")
        dev = tokens.device
        positions = (start + torch.arange(W, device=dev))[None, :].expand(B, W)
        x = params["embed"][tokens.long()].to(dt)
        shape = (cfg.n_layers, B, cfg.n_kv_heads, W, cfg.head_dim)
        suffix = {"k": torch.empty(shape, dtype=dt, device=dev),
                  "v": torch.empty(shape, dtype=dt, device=dev)}
        pad = torch.zeros((B, cfg.n_kv_heads, W, cfg.head_dim), dtype=dt, device=dev)
        blocks = params["blocks"]
        for l in range(cfg.n_layers):
            p = self._layer(blocks, l)
            q, k, v = self._qkv(p, x, positions)
            suffix["k"][l] = k
            suffix["v"][l] = v
            ck = torch.cat([prefix_kv["k"][l].to(dt), pad], dim=2)
            cv = torch.cat([prefix_kv["v"][l].to(dt), pad], dim=2)
            ck[:, :, start:start + W] = k
            cv[:, :, start:start + W] = v
            o = self._cache_attention(q, ck, cv, positions, dt)
            x = x + self._merge_heads(p, o)
            x = x + self._ffn(p, x)
        if last_index is None:
            x_last = x[:, -1]
        else:
            x_last = x[torch.arange(B, device=dev), last_index.long()]
        x_last = _rms_norm(x_last, params["ln_f"].to(dt), cfg.norm_eps)
        return (x_last @ params["unembed"].to(dt)).float(), suffix

    @torch.inference_mode()
    def generate(self, params, prompt, max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0):
        """Greedy/temperature sampling. prompt [B, Tp] -> [B, Tp+N].

        Seeded draws follow the JAX package's key chain (``rng``): the
        first token samples with ``PRNGKey(seed)``, each later one with a
        split of ``PRNGKey(seed + 1)``."""
        B, Tp = prompt.shape
        if max_new_tokens <= 0:
            return prompt
        total = Tp + max_new_tokens
        logits, slab = self.prefill(params, prompt, total)
        ks = [slab["k"][l] for l in range(self.cfg.n_layers)]
        vs = [slab["v"][l] for l in range(self.cfg.n_layers)]
        dev = prompt.device

        def sample(logits, key):
            if temperature <= 0.0:
                return torch.argmax(logits, dim=-1)
            return rng.categorical(key, logits / temperature)

        tok = sample(logits, rng.prng_key(seed, device=dev))
        out = [tok]
        key = rng.prng_key(seed + 1, device=dev)
        for t in range(Tp, total - 1):
            pair = rng.split(key)
            key, sub = pair[0], pair[1]
            pos = torch.full((B,), t, dtype=torch.long, device=dev)
            logits, ks, vs = self.decode_step_ragged_list(params, ks, vs, tok[:, None], pos)
            tok = sample(logits, sub)
            out.append(tok)
        return torch.cat([prompt.long(), torch.stack(out, dim=1)], dim=1)
