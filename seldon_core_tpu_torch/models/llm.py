"""DecoderLM: Llama-style decoder-only transformer, serving half.

Counterpart of ``seldon_core_tpu/models/llm.py``: RMSNorm, rotary
embeddings, grouped-query attention, a SwiGLU FFN or (``n_experts`` > 0)
a top-1 switch mixture of GELU experts, untied unembed. The
parameter dict has the JAX package's keys and shapes (layers stacked on
a leading axis), so weights carry across one-to-one.

Ported: the dense forward (``apply``), batched ``prefill`` (its
attention runs the hand-written CUDA flash kernel on the card), the
ragged one-position decode over a per-layer cache
(``decode_step_ragged_list``, with a separate write position for the
fused stop-aware burst), ``decode_chunk_ragged_list`` (a window of
tokens per row in one forward: speculative decoding's verify step),
``prefill_chunk`` (one chunk of a long prompt into a staging slab),
``prefill_with_prefix`` (a suffix prefill over a cached prefix slab),
``generate``, ``init_params`` and the analytic counts. Under MoE every
one of these runs the experts over the call's ``B*T`` rows
(``parallel/moe.py``).

The training forward sits beside them: ``backbone`` (every layer, with
the tp/sp/ep collectives of ``parallel/`` when given mesh axes) and
``loss_fn`` (next-token cross-entropy plus the MoE aux loss), which
autograd differentiates. It attends in plain PyTorch (``full_attention``,
or ``ring_attention`` over a sequence axis), as the JAX package trains
through XLA's attention and not its kernel; ``apply`` keeps the flash
kernel under ``inference_mode``.

Layouts match the JAX package exactly: per-layer caches
``[B, KV, T, Dh]``, the prefill slab ``[L, B, KV, Tb, Dh]``, and q/k/v
``[B, H, T, Dh]`` at the attention call. Where JAX donated a buffer
(the decode cache), this port writes into the tensor in place.

Sharded serving (``set_serving_mesh``): params and caches stored split
over a serving mesh (``param_sharding``, ``cache_sharding``,
``slab_sharding``) are gathered one layer at a time onto the compute
device by every serving forward, which re-slices what it wrote.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import rng
from ..device import resolve_device
from ..ops.flash_attention import attention as prefill_attention
from ..ops.flash_attention import check_kernel_config
from ..parallel.collectives import psum, pvary
from ..parallel.mesh import ServingSharding, ShardedTensor
from ..parallel.moe import moe_ffn, moe_ffn_ep
from ..parallel.ring import full_attention, ring_attention
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
    # MoE: 0 experts = dense SwiGLU everywhere, else a top-1 switch
    # mixture of GELU experts in every layer
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


def _dtype_name(dt) -> str:
    """``torch.bfloat16`` / ``np.dtype("float32")`` -> ``"bfloat16"`` /
    ``"float32"``."""
    return str(dt).replace("torch.", "")


def _rms_norm(x, w, eps=1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.reciprocal(torch.sqrt(var + eps))).to(x.dtype) * w


def token_ce(logits, targets):
    """Per-token next-token cross-entropy: ``-log_softmax(logits)`` at
    ``targets``, in the logits' dtype (float32)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0]


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
    # the serving mesh a batcher armed (set_serving_mesh), None unmeshed
    _serving_mesh = None
    _serving_shard_seq = False

    def __init__(self, device=None, **config):
        """``config``: the JAX package's model config keys. ``device``
        (optional): where the model will run; on CUDA the config is held
        against the prefill attention kernel here (:meth:`check_device`),
        so a model the card cannot serve is refused before any weight is
        loaded."""
        cfg_fields = {f.name for f in dataclasses.fields(LLMConfig)}
        extra = {k: v for k, v in config.items() if k not in cfg_fields}
        self.cfg = LLMConfig(**{k: v for k, v in config.items() if k in cfg_fields})
        self._extra = extra
        self.example_input_shape = (16,)  # token ids
        self.compute_dtype = self.cfg.dtype
        if device is not None:
            self.check_device(device)

    def check_device(self, device) -> None:
        """Raise ValueError, naming the cause, when this model's prefill
        cannot run on ``device``: on CUDA every prefill goes through the
        flash attention kernel, which takes float32/bfloat16 at head dims
        up to 256. Nothing to check on the CPU."""
        if torch.device(device).type == "cuda":
            check_kernel_config(self.dtype, self.cfg.head_dim)

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.dtype)

    # ------------------------------------------------------------------
    # analytic counts
    # ------------------------------------------------------------------

    def flops_per_token(self, context_len: float) -> float:
        """Matmul FLOPs to process ONE token attending over ``context_len``
        keys: q/kv/out projections + scores/attn*V + gated FFN + lm head.
        The JAX package's formula, kept as it is under MoE too, where it
        counts ``6*D*F`` for the FFN although a routed GELU expert does
        ``4*D*F`` and the router ``2*D*E``."""
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

    def flops_per_row(self, seq_len: Optional[int] = None) -> float:
        """Full-forward FLOPs for one sequence (causal: average context
        T/2)."""
        T = int(seq_len or self.example_input_shape[0])
        return T * self.flops_per_token(T / 2.0)

    def n_params(self) -> int:
        """Exact parameter count of ``init_params``' dict (closed form)."""
        cfg = self.cfg
        D, F, L, V = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab_size
        kv = cfg.n_kv_heads * cfg.head_dim
        h = cfg.n_heads * cfg.head_dim
        per_layer = 2 * D + D * h + 2 * D * kv + h * D  # norms + q,k,v,o
        if cfg.n_experts > 0:
            per_layer += D * cfg.n_experts + cfg.n_experts * 2 * D * F
        else:
            per_layer += 3 * D * F
        return L * per_layer + 2 * V * D + D  # blocks + embed/unembed + ln_f

    def decode_bytes_per_token(self, context_len: float, batch: int = 1,
                               param_bytes: int = 2) -> float:
        """Bytes read per DECODED TOKEN at the given batch size: the params
        once per step, shared by the batch, plus each lane's bf16 K/V read
        over its context. Under MoE the dense dispatch reads every expert
        on every step, so all of ``n_params`` counts."""
        cfg = self.cfg
        kv_bytes_per_tok_layer = 2 * cfg.n_kv_heads * cfg.head_dim * 2  # k+v, bf16
        cache_read = cfg.n_layers * kv_bytes_per_tok_layer * context_len
        return self.n_params() * param_bytes / max(1, batch) + cache_read

    def kv_bytes_per_token(self) -> int:
        """K+V bytes ONE cached position occupies across every layer at
        bf16: the per-(row, position) unit the read model below prices,
        the closed-form twin of the batcher's ``_kv_key_bytes`` (which
        reads the live cache's dtype)."""
        cfg = self.cfg
        return cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2

    def dispatch_read_bytes(
        self,
        kind: str,
        *,
        rows: int = 1,
        k: int = 1,
        bucket: int = 0,
        tokens: int = 0,
        param_bytes: Optional[float] = None,
        kv_row_bytes: Optional[float] = None,
    ) -> float:
        """Modelled device bytes READ by one dispatch of the given ledger
        kind (``serving/profiler.py``): decode-family bursts read the
        params once per step plus each row's bucketed KV columns;
        prefill-family dispatches read the params once and write their
        KV; splice/insert/extract move ``tokens`` cache positions; a swap
        flip touches every param byte once. ``param_bytes`` and
        ``kv_row_bytes`` default to the bf16 closed forms; the batcher
        passes its live values (so a float32 model is priced at float32)."""
        if param_bytes is None:
            param_bytes = self.n_params() * 2.0
        if kv_row_bytes is None:
            kv_row_bytes = float(self.kv_bytes_per_token())
        if kind in ("decode_burst", "fused_burst", "group_burst", "spec_burst"):
            # spec: one verify forward over gamma+1 positions per lane
            return k * (param_bytes + rows * bucket * kv_row_bytes)
        if kind in ("prefill", "chunk_prefill", "replay"):
            return param_bytes + tokens * kv_row_bytes
        if kind in ("splice", "insert", "extract"):
            return tokens * kv_row_bytes
        if kind == "swap_cast":
            return param_bytes
        return 0.0

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
        }
        if cfg.n_experts > 0:
            E = cfg.n_experts
            blocks["router"] = init((L, D, E), s)
            blocks["w1e"] = init((L, E, D, F), s)
            blocks["w2e"] = init((L, E, F, D), rs / math.sqrt(F))
        else:
            blocks["w1"] = init((L, D, F), s)
            blocks["w3"] = init((L, D, F), s)
            blocks["w2"] = init((L, F, D), rs / math.sqrt(F))
        return {
            "embed": init((V, D), 1.0),
            "blocks": blocks,
            "ln_f": torch.ones((D,), dtype=torch.float32, device=dev),
            "unembed": init((D, V), s),
        }

    @staticmethod
    def params_swappable(old, new) -> "Tuple[bool, str]":
        """Whether ``new`` can replace ``old`` under live serving: a hot
        swap copies the new leaves into the served tensors in place (the
        decode bursts' CUDA graphs read those addresses), so both trees
        must match leaf for leaf in structure, shape and dtype. Returns
        ``(ok, reason)``; the reason names the first offender in the JAX
        package's leaf order and wording."""
        from ..convert import sorted_leaves

        old_leaves, new_leaves = sorted_leaves(old), sorted_leaves(new)
        if [p for p, _ in old_leaves] != [p for p, _ in new_leaves]:
            return False, (
                "param tree structure differs (different architecture or "
                "checkpoint family)"
            )
        for (path, a), (_p, b) in zip(old_leaves, new_leaves):
            where = "".join(f"[{k!r}]" for k in path)
            sa, sb = tuple(a.shape), tuple(b.shape)
            if sa != sb:
                return False, f"{where}: shape {sb} != served {sa}"
            da, db = _dtype_name(a.dtype), _dtype_name(b.dtype)
            if da != db:
                return False, f"{where}: dtype {db} != served {da}"
        return True, ""

    # ------------------------------------------------------------------
    # sharded serving: sharded storage, replicated compute
    # ------------------------------------------------------------------

    def input_sharding(self, mesh) -> ServingSharding:
        """A token batch ``[B, T]`` rides ``data`` (the JAX package's
        rule for the LLM under the predict path)."""
        return ServingSharding(mesh, ("data", None) if "data" in mesh.axis_names else ())

    def param_sharding(self, mesh, params) -> Dict[str, Any]:
        """The tensor-parallel storage layout over the ``model`` axis, leaf
        for leaf with ``params``: the JAX package's table (column-split
        ``wq wk wv w1 w3`` on their last dim, row-split ``wo w2`` on the
        one before, the experts' ``w1e`` on F and ``w2e`` on their F
        rows), every other leaf replicated."""
        col = {"wq", "wk", "wv", "w1", "w3"}
        row = {"wo", "w2"}
        has_model = "model" in mesh.axis_names

        def spec_for(name, leaf):
            nd = leaf.ndim
            if not has_model:
                return ServingSharding(mesh, ())
            if name in col:
                return ServingSharding(mesh, (None,) * (nd - 1) + ("model",))
            if name in row:
                return ServingSharding(mesh, (None,) * (nd - 2) + ("model", None))
            if name == "w1e":
                return ServingSharding(mesh, (None, None, None, "model"))
            if name == "w2e":
                return ServingSharding(mesh, (None, None, "model", None))
            return ServingSharding(mesh, ())

        def walk(tree, name):
            if isinstance(tree, dict):
                return {k: walk(v, k) for k, v in tree.items()}
            return spec_for(name, tree)

        return walk(params, None)

    def set_serving_mesh(self, mesh, shard_seq: bool = False) -> None:
        """Arm sharded STORAGE with replicated COMPUTE (the batcher calls
        this when it puts the params under :meth:`param_sharding`), the
        JAX package's serving mode and its reason: tensor parallelism by
        partial sums would sum the row-parallel products and the
        head-split attention in another order than the one-device
        program, and greedy argmax flips at a near-tie, so the 1-vs-N
        byte identity would break.

        Params and the KV cache live split over the mesh
        (:class:`~seldon_core_tpu_torch.parallel.mesh.ShardedTensor`).
        Every forward gathers what one layer reads onto the compute
        device, runs the one-device arithmetic on tensors of the
        unsharded shape, dtype and strides, and re-slices the cache and
        slab positions it wrote back into their blocks: copies only, so
        the numbers are the one-device program's. The JAX executables
        gather whole at entry; here the gather runs one layer at a time,
        into buffers kept across calls (a decode burst's CUDA graph
        captures their addresses), so the compute device holds one
        layer's gathered weights and cache beside its own blocks."""
        self._serving_mesh = mesh
        self._serving_shard_seq = bool(shard_seq)

    def cache_sharding(self, mesh, kv_heads: Optional[int] = None,
                       shard_seq: bool = False) -> ServingSharding:
        """One per-layer cache buffer ``[S, KV, T, Dh]``: KV heads over
        ``model`` (replicated when they do not divide it), T over ``seq``
        under ``shard_seq``, lanes and head dim replicated."""
        kv = self.cfg.n_kv_heads if kv_heads is None else kv_heads
        model_ax = "model" if "model" in mesh.axis_names else None
        if model_ax and kv % mesh.shape["model"] != 0:
            model_ax = None
        seq_ax = None
        if shard_seq and "seq" in mesh.axis_names and mesh.shape["seq"] > 1:
            seq_ax = "seq"
        return ServingSharding(mesh, (None, model_ax, seq_ax, None))

    def slab_sharding(self, mesh, kv_heads: Optional[int] = None) -> ServingSharding:
        """A staging or transfer slab ``[L, 1, KV, T, Dh]``: the KV heads
        split as :meth:`cache_sharding` splits them, the rest replicated.
        Wire and tier bytes always gather first."""
        kv = self.cfg.n_kv_heads if kv_heads is None else kv_heads
        model_ax = "model" if "model" in mesh.axis_names else None
        if model_ax and kv % mesh.shape["model"] != 0:
            model_ax = None
        return ServingSharding(mesh, (None, None, model_ax, None, None))

    def _gather_buffer(self, tag: str, shape, dtype, device) -> torch.Tensor:
        """The buffer a sharded operand of one layer is gathered into,
        one per (tag, shape, dtype, device), kept for the model's life:
        a captured decode burst reads and writes it at a fixed address,
        so it must exist before the capture (:meth:`reserve_gather_buffers`).
        Only the batcher's scheduler thread runs the forwards that use it."""
        bufs = self.__dict__.setdefault("_gather_bufs", {})
        key = (tag, tuple(shape), dtype, device)
        buf = bufs.get(key)
        if buf is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"gather buffer {key} first asked for inside a CUDA graph "
                    "capture: reserve it before capturing")
            buf = bufs[key] = torch.empty(shape, dtype=dtype, device=device)
        return buf

    def reserve_gather_buffers(self, params, cache_shape=None, dtype=None) -> None:
        """Allocate every gather buffer a forward over ``params`` (and,
        given ``cache_shape``, a decode over a per-layer cache of that
        shape) will use, before any CUDA graph captures them. Until then
        (and on a model the batcher does not serve: ``TorchServer``'s
        concurrent predicts) a forward gathers into fresh tensors."""
        for name, w in params["blocks"].items():
            if isinstance(w, ShardedTensor):
                self._gather_buffer(name, w.shape[1:], w.dtype, w.device)
        if cache_shape is not None:
            dev = self._serving_mesh.device
            for tag in ("k", "v"):
                self._gather_buffer(tag, cache_shape, dtype, dev)

    def _take(self, tag: str, w, key) -> torch.Tensor:
        """``w[key]``; from a sharded ``w`` whose buffer is reserved,
        gathered into that buffer (a captured burst reads a fixed
        address), else into a fresh tensor."""
        if isinstance(w, ShardedTensor):
            buf = self.__dict__.get("_gather_bufs", {}).get(
                (tag, tuple(w.shape[len(key):]), w.dtype, w.device))
            if buf is not None:
                w.read_into(buf, key)
                return buf
        return w[key]

    def _kv_in(self, ks, vs, l: int, upto: Optional[int]):
        """Layer ``l`` of a per-layer cache, and its read window
        ``[0, upto)``. A sharded layer is gathered into a buffer of the
        layer's own shape (the window only: nothing past it is read)."""
        ck, cv = ks[l], vs[l]
        if not isinstance(ck, ShardedTensor):
            return ck, cv, None
        T = ck.shape[2]
        region = (slice(None), slice(None), slice(0, upto)) if upto is not None and upto < T else ()
        out = []
        for tag, c in (("k", ck), ("v", cv)):
            buf = self._gather_buffer(tag, c.shape, c.dtype, c.device)
            c.read_into(buf[region], region)
            out.append(buf)
        return out[0], out[1], region

    @staticmethod
    def _kv_out(ks, vs, l: int, ck, cv, region) -> None:
        """Re-slice a gathered layer's window back into its blocks."""
        if region is None:
            return
        ks[l].write_from(ck[region], region)
        vs[l].write_from(cv[region], region)

    # ------------------------------------------------------------------
    # forward building blocks
    # ------------------------------------------------------------------

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
        """Norm + the FFN of one layer over ``x`` [B, T, D]: SwiGLU, or
        under MoE the experts over the ``B*T`` rows of the call (the aux
        loss is dropped: serving has no use for it)."""
        cfg = self.cfg
        dt = x.dtype
        h = _rms_norm(x, p["ln2"].to(dt), cfg.norm_eps)
        if cfg.n_experts > 0:
            B, T, D = h.shape
            out, _aux = moe_ffn(h.reshape(B * T, D), p["router"].to(dt), p["w1e"].to(dt),
                                p["w2e"].to(dt), cfg.capacity_factor)
            return out.reshape(B, T, D)
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
            ck, cv, region = self._kv_in(ks, vs, l, attn_len)
            x = self._decode_layer(self._layer(blocks, l), x, pos, ck, cv, attn_len, wp)
            self._kv_out(ks, vs, l, ck, cv, region)
        return self._decode_head(params, x), ks, vs

    @torch.inference_mode()
    def decode_chunk_ragged_list(self, params, ks: List[torch.Tensor],
                                 vs: List[torch.Tensor], tokens, pos,
                                 attn_len: Optional[int] = None):
        """Decode a WINDOW of tokens per row in ONE forward over the
        unstacked cache (the JAX package's ``decode_chunk_ragged_list``):
        ``tokens`` [B, W], ``pos`` [B] start positions, token j of row b
        at position ``pos[b] + j``. Returns ``(logits [B, W, V] float32,
        ks, vs)``; ``logits[:, j]`` is the next-token distribution after
        ``tokens[:, j]``. Speculative decoding's verify step: the drafted
        tokens and the entry token are scored in one target forward.

        Per layer the window's K/V land in ``ks``/``vs`` in place, then
        attention reads the cache up to ``attn_len`` under the
        ``key_pos <= pos + j`` bound (prefix plus in-window causality)
        through the grouped cache attention. Positions past a row's
        accepted prefix are overwritten by later writes and masked until
        then, so rejected drafts need no rollback. A position at or past
        the cache length writes nothing (the JAX scatter drops it)."""
        cfg = self.cfg
        dt = self.dtype
        B, W = tokens.shape
        dev = tokens.device
        pos = pos.long()
        positions = pos[:, None] + torch.arange(W, device=dev)[None, :]  # [B, W]
        x = params["embed"][tokens.long()].to(dt)
        blocks = params["blocks"]
        T = ks[0].shape[2]
        rows = torch.arange(B, device=dev)
        wp = positions.clamp(max=T - 1)
        # out-of-bounds positions clamp onto T-1; every write aimed there
        # carries what T-1 ends up holding (the window's own token at T-1
        # when it reaches that far, else the old value), so duplicate
        # indices agree and the scatter is deterministic
        at_end = wp == T - 1  # [B, W]
        j_end = (T - 1 - pos).clamp(0, W - 1)
        reaches = (pos <= T - 1) & (pos + W - 1 >= T - 1)
        for l in range(len(ks)):
            p = self._layer(blocks, l)
            q, k, v = self._qkv(p, x, positions)
            # a sharded layer is gathered whole: a window write clamped
            # onto T - 1 reads the cache's last position
            ck, cv, region = self._kv_in(ks, vs, l, None)
            for cache, new in ((ck, k), (cv, v)):
                nt = new.transpose(1, 2)  # [B, W, KV, Dh]
                end = torch.where(reaches[:, None, None], nt[rows, j_end], cache[:, :, T - 1])
                cache[rows[:, None], :, wp] = torch.where(at_end[:, :, None, None],
                                                          end[:, None], nt)
            kc, vc = ck, cv
            if attn_len is not None and attn_len < T:
                kc, vc = kc[:, :, :attn_len], vc[:, :, :attn_len]
            o = self._cache_attention(q, kc, vc, positions, dt)
            self._kv_out(ks, vs, l, ck, cv, region)
            x = x + self._merge_heads(p, o)
            x = x + self._ffn(p, x)
        x = _rms_norm(x, params["ln_f"].to(dt), cfg.norm_eps)
        return (x @ params["unembed"].to(dt)).float(), ks, vs

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
        sharded = isinstance(slab["k"], ShardedTensor)
        for l in range(cfg.n_layers):
            p = self._layer(blocks, l)
            q, k, v = self._qkv(p, x, positions)
            if sharded:
                # layer l's window gathered into a buffer of the layer's
                # shape, the chunk written there and re-sliced
                sk, sv = (self._gather_buffer("slab_" + n, slab[n].shape[1:], dt, slab[n].device)
                          for n in ("k", "v"))
                window = (l, slice(None), slice(None), slice(0, attn_len))
                slab["k"].read_into(sk[:, :, :attn_len], window)
                slab["v"].read_into(sv[:, :, :attn_len], window)
            else:
                sk, sv = slab["k"][l], slab["v"][l]
            sk[:, :, start:start + C] = k
            sv[:, :, start:start + C] = v
            o = self._cache_attention(q, sk[:, :, :attn_len], sv[:, :, :attn_len], positions, dt)
            if sharded:
                at = (l, slice(None), slice(None), slice(start, start + C))
                slab["k"].write_from(sk[:, :, start:start + C], at)
                slab["v"].write_from(sv[:, :, start:start + C], at)
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

    # ------------------------------------------------------------------
    # training forward (axis-parametrised: None => one device)
    # ------------------------------------------------------------------

    def _block(self, p, x, positions, *, tp=None, sp=None, ep=None):
        """One layer of the training forward, the JAX ``_block`` (its
        ``_attention`` prefill branch and ``_ffn``). ``tp``, ``sp``,
        ``ep``: mesh ``Axis`` objects or None. Under ``tp`` the weights are
        this rank's column (``wq``/``wk``/``wv``/``w1``/``w3``) and row
        (``wo``/``w2``) shards: the normed input enters the column products
        through ``pvary`` (its gradient summed over ``tp``) and the row
        products' outputs are ``psum``-ed. Returns ``(x, aux)``."""
        cfg = self.cfg
        dt = x.dtype
        B, T, D = x.shape
        Dh = cfg.head_dim
        h = pvary(_rms_norm(x, p["ln1"].to(dt), cfg.norm_eps), tp)
        q = (h @ p["wq"].to(dt)).reshape(B, T, -1, Dh).transpose(1, 2)
        k = (h @ p["wk"].to(dt)).reshape(B, T, -1, Dh).transpose(1, 2)
        v = (h @ p["wv"].to(dt)).reshape(B, T, -1, Dh).transpose(1, 2)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        rep = q.shape[1] // k.shape[1]
        if rep > 1:  # GQA: repeat the kv groups on this path
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        if sp is not None:
            o = ring_attention(q, k, v, sp, causal=True)
        else:
            o = full_attention(q, k, v, causal=True)
        o = o.transpose(1, 2).reshape(B, T, -1) @ p["wo"].to(dt)
        x = x + psum(o, tp)
        h = _rms_norm(x, p["ln2"].to(dt), cfg.norm_eps)
        if cfg.n_experts > 0:
            out, aux = moe_ffn_ep(h.reshape(B * T, D), p["router"].to(dt), p["w1e"].to(dt),
                                  p["w2e"].to(dt), ep, cfg.capacity_factor)
            return x + out.reshape(B, T, D), aux
        h = pvary(h, tp)
        a = h @ p["w1"].to(dt)
        g = h @ p["w3"].to(dt)
        out = (torch.nn.functional.silu(a) * g) @ p["w2"].to(dt)
        return x + psum(out, tp), torch.zeros((), dtype=torch.float32, device=x.device)

    def backbone(self, blocks, x, positions, *, tp=None, sp=None, ep=None):
        """Every layer of ``blocks`` (leaves stacked on a leading layer
        axis: this rank's layers under a pipeline) over ``x`` [B, T, D] at
        ``positions`` [T]. Returns ``(x, aux)``, the MoE aux loss summed
        over the layers (0 when dense)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        names = list(blocks)
        # unbind, not one index per layer: the backward then stacks the
        # layers' gradients once instead of adding L full-size zero-padded
        # gradients into each stacked leaf
        for ws in zip(*(blocks[n].unbind(0) for n in names)):
            x, aux_l = self._block(dict(zip(names, ws)), x, positions, tp=tp, sp=sp, ep=ep)
            aux = aux + aux_l
        return x, aux

    def loss_fn(self, params, tokens):
        """Next-token cross-entropy on float32 logits (+ the MoE
        load-balancing aux times ``aux_loss_weight``) on one device:
        ``tokens`` [B, T+1]. Differentiable: autograd runs through
        :meth:`backbone`."""
        cfg = self.cfg
        dt = self.dtype
        inputs = tokens[:, :-1].long()
        x = params["embed"][inputs].to(dt)
        positions = torch.arange(inputs.shape[1], device=tokens.device)
        x, aux = self.backbone(params["blocks"], x, positions)
        x = _rms_norm(x, params["ln_f"].to(dt), cfg.norm_eps)
        logits = (x @ params["unembed"].to(dt)).float()
        return token_ce(logits, tokens[:, 1:]).mean() + cfg.aux_loss_weight * aux
