"""Blocked (flash) attention: a CUDA kernel for Hopper, and its plain version.

Counterpart of ``seldon_core_tpu/ops/flash_attention.py``, whose Pallas
kernel (``_flash_kernel``) computes prefill attention on the TPU. Here:

* :func:`attention_plain` — the plain PyTorch version: the math of the
  JAX package's ``parallel/ring.full_attention`` (f32 scores, causal mask,
  optional ``kv_len`` mask, both at ``NEG_INF = -1e30``, softmax, f32
  weighted sum, cast back to q's dtype).
* :func:`flash_attention_cuda` — the wrapper of the hand-written CUDA
  kernel in ``csrc/flash_attention.cu``: it checks its inputs
  (:func:`check_kernel_inputs`), allocates the output, launches on the
  current CUDA stream, raises if the launch failed, and counts its
  launches in :data:`LAUNCHES`.
* :func:`attention` — the entry point, with the JAX package's signature.
  A CPU tensor goes to the plain version; a CUDA tensor goes to the
  kernel, which masks ragged edges and ``kv_len`` itself, so there is no
  shape on the card that falls back to the plain version. What the kernel
  does not take (a head dim other than 64 or 128, another dtype) raises.

Both versions take grouped K/V: ``k``/``v`` may carry ``KV`` heads with
``H % KV == 0``, and q head ``h`` attends with kv head ``h // (H // KV)``
— exactly what ``jnp.repeat(k, H // KV, axis=1)`` feeds the JAX kernel,
without the repeated copy.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

NEG_INF = -1e30

# Launches of the CUDA kernel, counted by its wrapper where it launches
# (and nowhere else). Reset and read by the on-card smoke run to show the
# serving path went through the kernel.
LAUNCHES = {"flash_attention": 0}
_count_lock = threading.Lock()

_SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _check_shapes(q, k, v, kv_len):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("attention expects q/k/v of rank 4 [B, H, T, Dh]")
    b, h, _, dh = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(
            f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)} in batch "
            "or head dim"
        )
    kv = k.shape[1]
    if kv < 1 or h % kv:
        raise ValueError(f"q heads ({h}) must be a multiple of kv heads ({kv})")
    if kv_len is not None and int(kv_len) < 1:
        raise ValueError(f"kv_len must be >= 1, got {kv_len}")


def attention_plain(q, k, v, kv_len: Optional[int] = None, causal: bool = True):
    """Reference attention, q [B,H,Tq,Dh], k/v [B,KV,Tk,Dh] -> [B,H,Tq,Dh].

    f32 scores scaled by 1/sqrt(Dh); causal keeps key j for row i when
    i >= j; ``kv_len`` hides keys j >= kv_len; masked scores are -1e30
    (finite, as in the JAX package); the output takes q's dtype."""
    _check_shapes(q, k, v, kv_len)
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    t_q, t_k = q.shape[2], k.shape[2]
    if causal:
        rows = torch.arange(t_q, device=q.device)[:, None]
        cols = torch.arange(t_k, device=q.device)[None, :]
        s = torch.where((rows >= cols)[None, None], s, NEG_INF)
    if kv_len is not None:
        cols = torch.arange(t_k, device=q.device)
        s = torch.where((cols < int(kv_len))[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def check_kernel_inputs(q, k, v, kv_len: Optional[int] = None) -> None:
    """Raise ValueError unless the CUDA kernel takes these inputs (device
    aside, so CPU and meta tensors can be checked too): q [B,H,Tq,Dh],
    k/v [B,KV,Tk,Dh] with KV dividing H, one dtype (float32 or bfloat16),
    Dh 64 or 128, the head dim contiguous, T >= 1. The bfloat16 kernel
    loads through TMA, which needs every base 16-byte aligned and every
    byte stride a multiple of 16; a view that breaks this raises (no copy
    is made)."""
    _check_shapes(q, k, v, kv_len)
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention kernel takes float32/bfloat16, got {q.dtype}")
    dh = q.shape[3]
    if dh not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dim 64 or 128, got {dh}")
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise ValueError("flash attention kernel needs at least one query and one key")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its head dim")
        if q.dtype != torch.bfloat16:
            continue
        if t.data_ptr() % 16:
            raise ValueError(f"bfloat16 {name} must start 16-byte aligned for TMA")
        for dim in range(3):
            if (t.stride(dim) * t.element_size()) % 16:
                raise ValueError(
                    f"bfloat16 {name} stride {t.stride(dim)} of dim {dim} is not a "
                    "multiple of 16 bytes, as TMA needs"
                )


def choose_block_m(b: int, h: int, t_q: int, sm_count: int) -> int:
    """q rows per block of the bfloat16 kernel: 128 (two consumer
    warpgroups) when that grid still gives every SM a block, else 64."""
    return 128 if b * h * (-(-t_q // 128)) >= sm_count else 64


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library():
    from ._build import load

    lib = load(_SOURCE)
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 9
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (or find cached) and load the kernel library."""
    _library()


def smem_bytes(dtype: torch.dtype, dh: int, block_m: int) -> int:
    """Dynamic shared memory of the kernel launched for these settings."""
    return _library().flash_attention_smem_bytes(_DTYPES[dtype], dh, block_m)


def flash_attention_cuda(q, k, v, kv_len: Optional[int] = None,
                         causal: bool = True, block_m: Optional[int] = None):
    """Launch the CUDA kernel on inputs :func:`check_kernel_inputs` takes,
    all on one CUDA device (other strides are free, so head-transposed
    views pass without a copy). ``block_m`` (64 or 128) sets the bfloat16
    kernel's q rows per block; by default :func:`choose_block_m` picks it.
    Returns a new [B,H,Tq,Dh] tensor in q's dtype, laid out [B,Tq,H,Dh] in
    memory so the caller's merge of the heads is a free reshape."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    check_kernel_inputs(q, k, v, kv_len)
    b, h, t_q, dh = q.shape
    kv, t_k = k.shape[1], k.shape[2]
    if block_m is None:
        block_m = choose_block_m(b, h, t_q, _sm_count(q.device.index or 0))
    if block_m not in (64, 128):
        raise ValueError(f"block_m must be 64 or 128, got {block_m}")
    out = torch.empty((b, t_q, h, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, h, kv, t_q, t_k, dh, int(bool(causal)),
        -1 if kv_len is None else int(kv_len),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        block_m, stream,
    )
    if err < 0:
        raise RuntimeError(f"flash attention tensor map encoding failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA error {err}")
    with _count_lock:
        LAUNCHES["flash_attention"] += 1
    return out


def attention(q, k, v, kv_len: Optional[int] = None, causal: bool = True):
    """Prefill attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Inference only (no autograd)."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, kv_len=kv_len, causal=causal)
    if q.device.type != "cpu":
        raise ValueError(f"attention runs on cuda or cpu tensors, got {q.device}")
    return attention_plain(q, k, v, kv_len=kv_len, causal=causal)
