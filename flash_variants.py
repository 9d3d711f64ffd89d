#!/usr/bin/env python3
"""Where the flash kernel's mma route spends its time, on one NVIDIA H100.

    python3 flash_variants.py

Builds copies of ``seldon_core_tpu_torch/ops/csrc/flash_attention.cu``
with one part of the float32 (3xTF32) arithmetic changed or left out,
into ``build/variants/``, one ``nvcc`` each, all started together; then
times each copy on the same inputs (device time from a CUDA graph of 20
launches, as ``chip_smoke.py`` times the kernel) at the shapes the
serving path gives the route, at both block sizes. The variants that
drop work give wrong numbers on purpose: only ``base`` and ``cvt_split``
must match the plain attention (float32 tolerance 5e-5). Prints one line
per variant and the card's name and power limit; exits 1 when the build
or a check fails, 2 without CUDA.

Variants: ``base`` (the source as it is); ``cvt_split`` (the TF32
rounding by the conversion instruction ``cvt.rna.tf32.f32`` instead of
two integer operations); ``one_pass`` (one TF32 product, hi.hi, no lo
term: the cost of the two extra products and the lo rounding);
``no_split`` (three products of unrounded operands: the cost of the
rounding alone); ``q_raw``, ``k_raw``, ``v_raw`` (one operand's split
left out).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "seldon_core_tpu_torch", "ops", "csrc")
OUT = os.path.join(HERE, "build", "variants")

RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;"
SPLIT = ("  hi = hopper::tf32_rna(x);\n"
         "  lo = hopper::tf32_rna(x - __uint_as_float(hi));")
SMALL = ("  hopper::mma_m16n8k8_tf32(small, al, bh);\n"
         "  hopper::mma_m16n8k8_tf32(small, ah, bl);\n")
Q_SPLIT = "\n".join(
    f"          split_tf32(Qw[{r}], ah[{i}], al[{i}]);"
    for i, r in enumerate(("g * ld + c", "(g + 8) * ld + c", "g * ld + c + 4",
                           "(g + 8) * ld + c + 4")))
K_SPLIT = ("            split_tf32(kr[0], bh[0], bl[0]);\n"
           "            split_tf32(kr[4], bh[1], bl[1]);")
V_SPLIT = ("              split_tf32(vr[col[jj]], bh[0], bl[0]);\n"
           "              split_tf32(vr[col[jj] + ld], bh[1], bl[1]);")


def _raw(split_text):
    """The same lines with hi = lo = the operand's own bits."""
    out = []
    for line in split_text.split("\n"):
        pad, call = line.split("split_tf32(")
        src, hi, lo = call.rstrip(");").rsplit(", ", 2)
        out.append(f"{pad}{hi} = {lo} = __float_as_uint({src});")
    return "\n".join(out)


# name -> [(file, old text, new text)]
VARIANTS = {
    "base": [],
    "cvt_split": [("hopper_ptx.cuh", RNA,
                   '  uint32_t y;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(y) : "f"(x));\n'
                   "  return y;")],
    "one_pass": [("flash_attention.cu", SMALL, ""),
                 ("flash_attention.cu", SPLIT, "  hi = hopper::tf32_rna(x);\n  lo = 0u;")],
    "no_split": [("flash_attention.cu", SPLIT, "  hi = lo = __float_as_uint(x);")],
    "q_raw": [("flash_attention.cu", Q_SPLIT, _raw(Q_SPLIT))],
    "k_raw": [("flash_attention.cu", K_SPLIT, _raw(K_SPLIT))],
    "v_raw": [("flash_attention.cu", V_SPLIT, _raw(V_SPLIT))],
}
EXACT = ("base", "cvt_split")

# (label, B, H, KV, T, Dh): float32 shapes of the serving path and the
# kernels phase; each at block_m 32 and 64
CASES = [
    ("dh256_b1_t512", 1, 8, 4, 512, 256),
    ("dh128_b1_t1024", 1, 16, 8, 1024, 128),
    ("dh128_b2_t1024", 2, 16, 8, 1024, 128),
    ("dh64_b2_t256", 2, 4, 4, 256, 64),
]


def build(name, subs):
    """Write the variant's sources into build/variants/<name>/ and compile
    them as ops/_build.py compiles the kernel; returns the library path."""
    from seldon_core_tpu_torch.ops import _build

    srcs = {f: open(os.path.join(CSRC, f)).read() for f in os.listdir(CSRC)}
    for f, old, new in subs:
        if srcs[f].count(old) != 1:
            raise RuntimeError(f"variant {name}: the text to replace is not in {f} once")
        srcs[f] = srcs[f].replace(old, new)
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f, text in srcs.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    lib = os.path.join(d, "flash_attention.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(d, "flash_attention.cu"), *_build.LINK_FLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}\n{proc.stderr}")
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from seldon_core_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(lambda kv: build(*kv), VARIANTS.items())))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip() or "nvidia-smi unavailable"
    print(card, flush=True)
    failed = False
    for name, path in libs.items():
        lib = fa.bind(ctypes.CDLL(path))
        saved = fa._library
        fa._library = lambda lib=lib: lib
        try:
            cells = []
            for label, b, h, kv, t, dh in CASES:
                gen = torch.Generator(device="cuda")
                gen.manual_seed(0)
                q, k, v = cs._prefill_like(b, h, kv, t, dh, torch.float32, gen)
                ref = fa.attention_plain(q, k, v, causal=True)
                for bm in (32, 64):
                    out = fa.flash_attention_cuda(q, k, v, causal=True, block_m=bm)
                    err = (out - ref).abs().max().item()
                    if name in EXACT and err > cs.TOL["float32"]:
                        failed = True
                    ms = cs.device_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True,
                                                                       block_m=bm))
                    cells.append(f"{label}/block_m={bm} {ms:.4f} ms (err {err:.1e})")
        finally:
            fa._library = saved
        print(f"[variant] {name}: " + "; ".join(cells) + f" [{card}]", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
