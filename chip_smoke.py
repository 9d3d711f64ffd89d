#!/usr/bin/env python3
"""On-card smoke run of seldon_core_tpu_torch (one NVIDIA H100).

    python3 chip_smoke.py

Drives the port's main path on the card and fails (non-zero exit, no
result line) if any phase fails:

1. Device: the card's name and power limit (nvidia-smi) and torch's view.
2. Build: compiles every CUDA kernel of the path from ``ops/csrc``.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   same inputs, at the shapes the serving path gives it (bf16 at both
   block sizes), with times -- per call from the host (``call_ms``) and
   on the device from a CUDA graph of 20 launches (``device_ms``) --
   the PyTorch library call timed both ways as a yardstick, the bound,
   TFLOP/s and the share of the bound.
4. Small model on the card: the continuous batcher's greedy and seeded
   tokens equal ``DecoderLM.generate`` on the same device and weights.
5. Serve: the ``llm-1.26b`` configuration (full width, random weights from
   seed 0) behind the REST microservice on CUDA; concurrent greedy and
   seeded requests across the prefill buckets; checks response shapes,
   repeatability, and that every prefill dispatch went through the flash
   kernel (launch counters reset just before, read just after); prints
   tokens/s, TTFT p50 and peak device memory; then compares full-width
   prefill logits with the kernel against the plain attention.
6. Engine: the same configuration behind the inference-graph engine
   (``EngineApp`` over one in-process GENERATE_SERVER unit), driven with
   the serve phase's waves (same checks and numbers, flash launches
   counted over the whole phase); a greedy request alone must give the
   serve phase's tokens; SSE streams must concatenate to unary; a
   dropped stream must cancel its request and free the lane; a
   RAG_PROMPT_BUILDER -> GENERATE_SERVER graph and a remote REST hop must
   give the single-unit tokens; a 1 ms deadline must be refused (504 or
   429); gRPC Predict and GenerateStream must equal REST when grpcio
   imports (else one line says the gRPC front was not driven); and the
   client-side latency of a 1-token request through the engine against
   a microservice over the same generate server, median of 20, and of
   a SIMPLE_MODEL request (host only), median of 200; then the serve
   waves through the engine and through that microservice alternated
   (ABBA twice), their tokens/s, TTFT and TPOT side by side.
7. Small scheduler (float32, the small model of phase 4): the batcher's
   configurations A-E (as in phase 8, ``MIN_ATTN_BUCKET`` lowered so
   that depth groups split) give the same tokens, greedy and seeded, one
   request at a time and all together; no decode graph is captured after
   ``warm()``.
8. Scheduler (llm-1.26b at full width and depth, bf16, on the engine
   phase's weights; 8 slots, steps_per_poll 16, pipeline_depth 3,
   attn_bucket 128): configurations A (every knob off, CUDA graphs off:
   the eager path, kept as the comparison), B (graphs on), C (fused
   decode K 64), D (C + depth groups 4 with a forced split), E (C +
   prefill_chunk 256) and F (depth groups 4, default cost model), each
   warmed for the serve phase's prompt lengths and driven with the serve
   waves, every wave queued whole so that each run has one batch
   composition; A/B and A/C alternated in one process (ABBA twice), D-F
   twice each; four requests of the mixed wave stop at the token their
   knobs-off run emitted at steps 3, 17, 40 and 63. Fails unless B and C
   equal A token for token, every configuration repeats itself, every
   stop fires where A's does, no graph is captured after ``warm()``,
   every whole-prompt prefill launches the flash kernel, D splits and E
   chunks. Reports per configuration tokens/s, TTFT p50/p99, TPOT p50,
   peak memory, the graph pool's growth, graphs and capture seconds,
   graph launches per decode step, realized K, group bursts and
   occupancy, prefill chunks, and how many of D's, E's and F's streams
   equal A's (bf16 over another read may round otherwise: reported, not
   gated).
9. Model (on the engine phase's copy, after every serving phase: a
   profiler run may slow later launches): full-width prefill time per
   bucket with the flash kernel's device time inside it
   (torch.profiler), a decode step's wall time beside its device-busy
   time and weight-read bound, and a 16-step decode burst through the
   batcher, eager against CUDA-graph replay: wall, device span and busy
   time per step, device operations, host launches and busy share.
10. The ``kernels`` JSON line, then the final ``{"ok": true, ...}`` line.

Exits 2 when CUDA is unavailable, 1 on any failure.
"""

from __future__ import annotations

import asyncio
import collections
import http.client
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12

# llm-1.26b: the flagship generate configuration of the JAX package's
# benchmark (seldon_core_tpu/modelbench.py, "llm-1.26b")
LLM_1_26B = {
    "vocab_size": 32000, "d_model": 2048, "n_layers": 24, "n_heads": 16,
    "n_kv_heads": 8, "d_ff": 5632, "max_seq": 1024, "residual_scale": 0.05,
    "dtype": "bfloat16", "seed": 0,
}

# Tolerances, kernel against its plain version on the same inputs:
#  * float32: the two differ only in summation order and in exp/scale
#    rounding, ~1e-6 relative over up to 1024 keys;
#  * bfloat16: both round an f32 result to bf16 (a different summation
#    order may flip the last bit: one ulp, 2**-6 at |o| < 4), and the
#    kernel feeds the tensor cores bf16 probabilities (relative 2**-9 per
#    weight, as FlashAttention does): two ulps at |o| < 4.
TOL = {"float32": 5e-5, "bfloat16": 2.0 ** -5}
# Full-width prefill logits, kernel vs plain attention in the same bf16
# model: the attention outputs may differ by a bf16 ulp per layer, and
# that noise compounds over 24 layers into unit-scale logits.
LOGITS_TOL = 0.25
TOP1_MIN_AGREEMENT = 0.75


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one call: ``launches`` calls captured once in a CUDA
    graph, the graph replayed ``reps`` times between CUDA events; the
    median replay over ``launches``. The host's launch cost is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[len(times) // 2]


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"
    log(card)  # the card's name and power limit, as nvidia-smi prints them
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device cuda:0 {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # parity phases compare in true float32: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] allow_tf32 matmul=False cudnn=False")
    return card


def phase_build():
    from seldon_core_tpu_torch.ops import _build, flash_attention

    t0 = time.perf_counter()
    flash_attention.build()
    dt = time.perf_counter() - t0
    lib = _build.library_path("flash_attention.cu")
    log(f"[build] flash_attention.cu -> {os.path.relpath(lib, HERE)} in {dt:.2f} s")
    ptxas = lib.with_name(lib.stem + ".ptxas.txt")
    if ptxas.exists():
        for line in _ptxas_summary(ptxas.read_text()):
            log(f"[build] {line}")


def _kernel_name(mangled):
    """flash_fwd_wgmma_kernel<128,2> from a mangled entry-function name."""
    for short in ("flash_fwd_wgmma_kernel", "flash_fwd_f32_kernel"):
        if short in mangled:
            tmpl = mangled.split(short, 1)[1].split("EE", 1)[0]
            return short + "<" + ",".join(tmpl.replace("ILi", "").split("ELi")) + ">"
    return mangled


def _ptxas_summary(text):
    """One line per kernel from ``ptxas -v`` (registers, spills), plus the
    compiler's notes that bear on wgmma: fences it had to inject before a
    product, and any warning (a setmaxnreg it ignored)."""
    out, name, spills = [], None, ""
    injected = collections.Counter()
    for raw in text.splitlines():
        line = raw.strip()
        if "Compiling entry function" in line:
            name, spills = _kernel_name(line.split("'")[1]), ""
        elif "spill stores" in line:
            spills = line
        elif name and line.startswith("ptxas info") and "registers" in line:
            out.append(f"{name}: {line.split('Used', 1)[-1].strip()}; {spills}")
            name = None
        elif "warpgroup.arrive is injected" in line:
            injected[_kernel_name(line.rsplit("'", 2)[-2])] += 1
        elif "setmaxnreg" in line or "warning" in line.lower():
            out.append("warning: " + line[:200])
    out += [f"{n}: ptxas injected {c} warpgroup.arrive fences before wgmma"
            for n, c in injected.items()]
    return out


def _prefill_like(b, h, kv, t, dh, dtype, gen):
    """q/k/v laid out as DecoderLM.prefill hands them to attention():
    head-transposed views of [B, T, heads*Dh] projections."""
    import torch

    q = torch.randn(b, t, h * dh, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, t, kv * dh, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, t, kv * dh, generator=gen, device="cuda").to(dtype)
    return (q.view(b, t, h, dh).transpose(1, 2),
            k.view(b, t, kv, dh).transpose(1, 2),
            v.view(b, t, kv, dh).transpose(1, 2))


def _flops(b, h, t, dh, causal=True, kv_len=None):
    """FLOPs this input needs: q.k and p.v over the visible keys only, 2
    FLOPs per multiply-add."""
    limit = t if kv_len is None else min(t, kv_len)
    keys = sum(min(i + 1, limit) for i in range(t)) if causal else t * limit
    return 4.0 * b * h * dh * keys


def _bound(b, h, kv, t, dh, dtype_name, causal=True, kv_len=None):
    """Least time for the work: max(FLOPs this input needs / peak for its
    type, bytes of q, k, v read once and o written once / HBM rate)."""
    flops = _flops(b, h, t, dh, causal=causal, kv_len=kv_len)
    item = 2 if dtype_name == "bfloat16" else 4
    nbytes = item * dh * t * b * (2 * h + 2 * kv)
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(card):
    import torch
    import torch.nn.functional as F

    from seldon_core_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (label, B, H, KV, T, Dh, dtype, kv_len): the serving path's shapes
    # (llm-1.26b heads, every prefill bucket, batched admissions m = 4
    # and 8), plus ragged T with a key-length mask, head dim 64, and the
    # float32 path
    cases = [
        ("b1_t32", 1, 16, 8, 32, 128, torch.bfloat16, None),
        ("b1_t128", 1, 16, 8, 128, 128, torch.bfloat16, None),
        ("b1_t512", 1, 16, 8, 512, 128, torch.bfloat16, None),
        ("b1_t1024", 1, 16, 8, 1024, 128, torch.bfloat16, None),
        ("b4_t128", 4, 16, 8, 128, 128, torch.bfloat16, None),
        ("b8_t512", 8, 16, 8, 512, 128, torch.bfloat16, None),
        ("b8_t1024", 8, 16, 8, 1024, 128, torch.bfloat16, None),
        ("bf16_ragged_t130_kvlen100", 1, 4, 2, 130, 128, torch.bfloat16, 100),
        ("bf16_b2_t200_dh64", 2, 4, 1, 200, 64, torch.bfloat16, None),
        ("f32_b2_t256_dh64", 2, 4, 4, 256, 64, torch.float32, None),
        ("f32_ragged_t130_kvlen100", 1, 4, 2, 130, 128, torch.float32, 100),
    ]
    results = {}
    for label, b, h, kv, t, dh, dt, kv_len in cases:
        q, k, v = _prefill_like(b, h, kv, t, dh, dt, gen)
        dname = "bfloat16" if dt == torch.bfloat16 else "float32"
        tol = TOL[dname]
        ref = fa.attention_plain(q, k, v, kv_len=kv_len, causal=True)
        # bf16: both block sizes are checked and timed; the wrapper's own
        # choice is what the main path runs
        chosen = fa.choose_block_m(b, h, t, sms) if dt == torch.bfloat16 else 64
        per_bm = {}
        for bm in ((64, 128) if dt == torch.bfloat16 else (64,)):
            out = fa.flash_attention_cuda(q, k, v, kv_len=kv_len, causal=True, block_m=bm)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if err > tol:
                raise AssertionError(f"flash_attention {label} block_m {bm}: "
                                     f"max_abs_err {err} > {tol}")
            per_bm[bm] = (err, device_ms(lambda: fa.flash_attention_cuda(
                q, k, v, kv_len=kv_len, causal=True, block_m=bm)))
        err, dev_ms = per_bm[chosen]
        call_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, kv_len=kv_len, causal=True))
        plain_ms = time_ms(lambda: fa.attention_plain(q, k, v, kv_len=kv_len, causal=True), iters=5)
        library_ms = library_dev_ms = None
        if kv_len is None:
            def sdpa():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
            library_ms = time_ms(sdpa)
            library_dev_ms = device_ms(sdpa)
        bound_ms, bound_by = _bound(b, h, kv, t, dh, dname, kv_len=kv_len)
        flops = _flops(b, h, t, dh, kv_len=kv_len)
        smem = fa.smem_bytes(dt, dh, chosen)
        others = " ".join(f"device_ms[block_m={bm}]={ms:.4f}" for bm, (_e, ms) in per_bm.items())
        log(f"[kernel] flash_attention {label} B={b} H={h} KV={kv} T={t} Dh={dh} {dname} "
            f"kv_len={kv_len} block_m={chosen} smem={smem} max_abs_err={err:.3e} tol={tol:.3e} "
            f"device_ms={dev_ms:.4f} call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={_r(library_ms)} library_device_ms={_r(library_dev_ms)} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) TFLOP/s={flops / dev_ms / 1e9:.1f} "
            f"bound_share={bound_ms / dev_ms:.3f} {others} [{card}] OK")
        results[label] = dict(max_abs_err=err, ms=call_ms, device_ms=dev_ms, plain_ms=plain_ms,
                              library_ms=library_ms, library_device_ms=library_dev_ms,
                              bound_ms=bound_ms, bound_by=bound_by, block_m=chosen)
    log(f"[kernel] flash_attention launches in this phase: {fa.LAUNCHES['flash_attention']}")
    return results


def _r(x):
    return None if x is None else round(x, 4)


def phase_small_model():
    """The batcher's tokens equal DecoderLM.generate on the card (float32,
    Dh 64 so the prefill runs the kernel), greedy and seeded."""
    import torch

    from seldon_core_tpu_torch.models.llm import DecoderLM
    from seldon_core_tpu_torch.ops import flash_attention as fa
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    cfg = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
               d_ff=512, max_seq=128, dtype="float32")
    model = DecoderLM(**cfg)
    params = model.init_params(0, device="cuda")
    before = fa.LAUNCHES["flash_attention"]
    b = ContinuousBatcher(model, params, slots=4, prefill_buckets=(32, 64),
                          steps_per_poll=4)
    try:
        prompts = [[3, 17, 42, 99, 7], list(range(1, 40)), [5] * 12]
        for temp, seed in ((0.0, 0), (0.9, 11)):
            futs = [b.submit(p, max_new_tokens=16, temperature=temp, seed=seed) for p in prompts]
            got = [f.result(timeout=300) for f in futs]
            for p, g in zip(prompts, got):
                ref = model.generate(
                    params, torch.tensor([p], device="cuda"), 16,
                    temperature=temp, seed=seed,
                )[0].tolist()
                if temp == 0.0 and g != ref:
                    raise AssertionError(f"batcher greedy {g} != generate {ref}")
                if len(g) != len(p) + 16 or g[: len(p)] != p:
                    raise AssertionError(f"malformed batcher output {g}")
        again = b.submit(prompts[0], max_new_tokens=16, temperature=0.9, seed=11).result(timeout=300)
        if again != got[0]:
            raise AssertionError("seeded request not reproducible on the card")
    finally:
        b.close()
    launched = fa.LAUNCHES["flash_attention"] - before
    if launched <= 0:
        raise AssertionError("small model prefill did not launch the flash kernel")
    log(f"[small] batcher == generate (greedy), seeded repeat identical; "
        f"flash launches {launched}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(port: int, body: dict, timeout: float = 600.0, path: str = "/predict",
          headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


# the generate server of the serve and engine phases: llm-1.26b at 8
# slots, warmed for the waves' prompt lengths before it listens
SERVE_PARAMS = [
    {"name": "device", "value": "cuda", "type": "STRING"},
    {"name": "slots", "value": "8", "type": "INT"},
    {"name": "steps_per_poll", "value": "16", "type": "INT"},
    {"name": "pipeline_depth", "value": "3", "type": "INT"},
    {"name": "warmup_prompt_lens", "value": "20,128,300,500,900", "type": "STRING"},
    {"name": "warmup_max_new_tokens", "value": "64", "type": "INT"},
]
MAX_NEW = 64


def serve_waves():
    """The traffic of the serve and engine phases: two 20-token requests
    (greedy, seeded) alone, a mixed wave of 8 across every prefill
    bucket, then the first two again."""
    import numpy as np

    rs = np.random.RandomState(0)
    vocab = LLM_1_26B["vocab_size"]

    def prompt(n):
        return rs.randint(0, vocab, n).tolist()

    g20, s20 = prompt(20), prompt(20)
    # the same two requests alone, before and after a mixed wave: in the
    # same batch composition bf16 decode is deterministic, so the repeat
    # must give identical tokens
    probe = [("greedy_20", g20, 0.0, 0), ("seeded_20", s20, 1.0, 3)]
    mixed = [
        ("mixed_greedy_20", g20, 0.0, 0),
        ("greedy_128", prompt(128), 0.0, 0),
        ("seeded_500", prompt(500), 0.8, 7),
        ("greedy_900", prompt(900), 0.0, 0),
        ("mixed_seeded_20", s20, 1.0, 3),
        ("greedy_300", prompt(300), 0.0, 0),
        ("greedy_24", prompt(24), 0.0, 0),
        ("greedy_30", prompt(30), 0.0, 0),
    ]
    return probe, mixed


def _gen_body(toks, temp=0.0, seed=0, max_new=MAX_NEW):
    return {"jsonData": {"prompt_tokens": toks, "max_new_tokens": max_new,
                         "temperature": temp, "seed": seed}}


def fire(post, wave):
    """Send a wave's requests concurrently; ``post(body)`` returns
    ``(status, json)``."""
    out = {}

    def one(item):
        label, toks, temp, seed = item
        out[label] = post(_gen_body(toks, temp, seed))

    threads = [threading.Thread(target=one, args=(it,)) for it in wave]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    return out


def _slo(batcher):
    """TTFT p50/p99 and TPOT p50 (ms) over the batcher's SLO reservoir."""
    import numpy as np

    ttfts = [r[1] for r in batcher.slo_recent]
    tpots = [r[2] for r in batcher.slo_recent if r[2] is not None]
    return {"ttft_p50": float(np.percentile(ttfts, 50)) * 1e3,
            "ttft_p99": float(np.percentile(ttfts, 99)) * 1e3,
            "tpot_p50": float(np.percentile(tpots, 50)) * 1e3}


def run_waves(tag, post, batcher, probe, mixed, card):
    """Drive probe, mixed, probe through ``post`` with the flash kernel's
    launch count and the batcher's SLO reservoir reset just before; check
    every response and the repeats; print the end-to-end numbers. Returns
    the flash launches, the prefill dispatches, and the first probe
    wave's results."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa

    vocab = LLM_1_26B["vocab_size"]
    stats0 = dict(batcher.stats)
    batcher.slo_recent.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES["flash_attention"] = 0  # count this path only
    t_serve = time.perf_counter()
    results = [fire(post, probe), fire(post, mixed), fire(post, probe)]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = fa.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    prefills = batcher.stats["prefill_steps"] - stats0["prefill_steps"]
    n_req = 0
    gen_tokens = 0
    for wave, res in zip((probe, mixed, probe), results):
        for label, toks, _temp, _seed in wave:
            status, body = res[label]
            if status != 200:
                raise AssertionError(f"{label}: HTTP {status} {body}")
            out = body["jsonData"]["tokens"]
            if len(out) != 1 or len(out[0]) != len(toks) + MAX_NEW \
                    or out[0][: len(toks)] != toks \
                    or not all(0 <= t < vocab for t in out[0]):
                raise AssertionError(f"{label}: malformed tokens")
            n_req += 1
            gen_tokens += MAX_NEW
    first, _mix, again = results
    for label in ("greedy_20", "seeded_20"):
        if first[label][1]["jsonData"]["tokens"] != again[label][1]["jsonData"]["tokens"]:
            raise AssertionError(f"{label}: repeated request gave other tokens")
    log(f"[{tag}] {n_req} REST requests OK; repeated greedy and seeded requests identical")
    for label in ("greedy_20", "seeded_20"):
        a = first[label][1]["jsonData"]["tokens"][0][20:]
        m = results[1]["mixed_" + label][1]["jsonData"]["tokens"][0][20:]
        same = next((i for i, (x, y) in enumerate(zip(a, m)) if x != y), len(a))
        log(f"[{tag}] {label} alone vs inside the mixed wave: first {same} of "
            f"{len(a)} tokens equal (bf16 rounding depends on batch composition)")
    layers = LLM_1_26B["n_layers"]
    log(f"[{tag}] prefill dispatches {prefills}, flash kernel launches {launches} "
        f"(need >= {layers} x {prefills})")
    if prefills <= 0 or launches < layers * prefills:
        raise AssertionError("not every prefill went through the flash kernel")
    slo = _slo(batcher)
    log(f"[{tag}] tokens/s {gen_tokens / serve_s:.1f} ({gen_tokens} generated tokens "
        f"in {serve_s:.2f} s, {n_req} requests, 8 slots) [{card}]")
    log(f"[{tag}] TTFT p50 {slo['ttft_p50']:.1f} ms, p99 {slo['ttft_p99']:.1f} ms; "
        f"TPOT p50 {slo['tpot_p50']:.2f} ms [{card}]")
    log(f"[{tag}] peak device memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated) [{card}]")
    return launches, prefills, first


def serve_in_thread(start):
    """Run ``start()`` (a coroutine function that opens the listeners and
    returns an async closer) on an event loop in a daemon thread; returns
    a function that closes the listeners and stops the loop."""
    loop = asyncio.new_event_loop()
    ready = threading.Event()
    closer = {}

    def run():
        asyncio.set_event_loop(loop)
        try:
            closer["fn"] = loop.run_until_complete(start())
        except BaseException as e:  # noqa: BLE001 - reported to the caller
            closer["error"] = e
        ready.set()
        if "fn" in closer:
            loop.run_forever()

    thread = threading.Thread(target=run, name="serve", daemon=True)
    thread.start()
    if not ready.wait(120) or "error" in closer:
        raise AssertionError(f"server did not start: {closer.get('error')}")

    def stop():
        asyncio.run_coroutine_threadsafe(closer["fn"](), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)

    return stop


def phase_serve(card):
    import numpy as np
    import torch

    from seldon_core_tpu_torch import microservice, wrapper
    from seldon_core_tpu_torch.ops import flash_attention as fa

    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as model_dir:
        with open(os.path.join(model_dir, "jax_config.json"), "w") as f:
            json.dump({"family": "llm", "config": LLM_1_26B}, f)
        params = [{"name": "model_uri", "value": model_dir, "type": "STRING"}] + SERVE_PARAMS
        t0 = time.perf_counter()
        user = microservice.build_user_object(
            "seldon_core_tpu_torch.servers.generateserver.GenerateServer", json.dumps(params)
        )
        user.load()  # what the CLI does before it listens: load + warm
        log(f"[serve] llm-1.26b loaded and warmed in {time.perf_counter() - t0:.1f} s "
            f"({user._model.n_params() / 1e9:.3f} B params, bf16)")
        app = wrapper.get_rest_microservice(user)
        port = _free_port()

        async def start():
            await app.start("127.0.0.1", port)

            async def close():
                app.close()
            return close

        stop = serve_in_thread(start)
        try:
            probe, mixed = serve_waves()
            launches, _prefills, _first = run_waves(
                "serve", lambda body: _post(port, body), user.batcher, probe, mixed, card)
            # one greedy request alone: the engine phase must give the
            # same tokens through the engine (same batch composition)
            status, body = _post(port, _gen_body(probe[0][1]))
            if status != 200:
                raise AssertionError(f"greedy_20 alone: HTTP {status} {body}")
            alone = body["jsonData"]["tokens"]
        finally:
            stop()
            app._hook_pool.shutdown(wait=False)
            user.close()

        # full-width prefill: the kernel against the plain attention,
        # called explicitly, in the same model on the same weights
        from seldon_core_tpu_torch.models import llm as llm_mod

        model, params_dev = user._model, user.batcher.params
        rs = np.random.RandomState(1)
        prompts = torch.tensor(rs.randint(0, LLM_1_26B["vocab_size"], (8, 128)), device="cuda")
        logits_k, _ = model.prefill(params_dev, prompts, 128)
        saved = llm_mod.prefill_attention
        llm_mod.prefill_attention = fa.attention_plain
        try:
            logits_p, _ = model.prefill(params_dev, prompts, 128)
        finally:
            llm_mod.prefill_attention = saved
        if not bool(torch.isfinite(logits_k).all()):
            raise AssertionError("non-finite prefill logits")
        diff = (logits_k - logits_p).abs().max().item()
        top1 = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
        log(f"[serve] prefill logits kernel vs plain at full width: max_abs {diff:.4e} "
            f"(tol {LOGITS_TOL}), top-1 agreement {top1:.3f} (min {TOP1_MIN_AGREEMENT}), "
            f"|logits| max {logits_p.abs().max().item():.3f}")
        if diff > LOGITS_TOL or top1 < TOP1_MIN_AGREEMENT:
            raise AssertionError("prefill logits disagree between kernel and plain attention")
        return launches, alone


def _grpc_available() -> bool:
    try:
        import google.protobuf  # noqa: F401
        import grpc  # noqa: F401
    except ImportError:
        return False
    return True


def _sse(port: int, body: dict, timeout: float = 600.0):
    """The events of one SSE stream from /api/v0.1/generate."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/api/v0.1/generate", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"SSE: HTTP {resp.status} {resp.read()[:300]}")
        raw = resp.read().decode()
    finally:
        conn.close()
    return [json.loads(block[len("data: "):])
            for block in raw.split("\n\n") if block.startswith("data: ")]


def _sse_drop_after_first(port: int, body: dict) -> None:
    """Open an SSE stream, wait for its first event, then vanish."""
    data = json.dumps(body).encode()
    sock = socket.create_connection(("127.0.0.1", port), timeout=120)
    try:
        sock.sendall(b"POST /api/v0.1/generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
        got = b""
        while b"data: " not in got:
            chunk = sock.recv(4096)
            if not chunk:
                raise AssertionError(f"stream ended before its first event: {got[:200]}")
            got += chunk
        if not got.startswith(b"HTTP/1.1 200"):
            raise AssertionError(f"stream refused: {got[:200]}")
    finally:
        sock.close()


def _wait_for(cond, what: str, timeout: float = 60.0) -> None:
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def _paired_latency(engine_call, micro_call, n):
    """Client-side seconds of ``n`` calls each, in ABBA order so drift
    falls on both sides alike; every call must answer 200."""
    lat = {"engine": [], "micro": []}
    calls = {"engine": engine_call, "micro": micro_call}
    for i in range(n):
        for name in (("engine", "micro") if i % 2 == 0 else ("micro", "engine")):
            t = time.perf_counter()
            status, out = calls[name]()
            lat[name].append(time.perf_counter() - t)
            if status != 200:
                raise AssertionError(f"request via {name}: HTTP {status} {out}")
    return lat


def _lat_line(lat):
    import numpy as np

    q = {k: np.percentile(v, [25, 50, 75]) * 1e3 for k, v in lat.items()}
    return (f"engine {q['engine'][1]:.2f} ms (p25-p75 {q['engine'][0]:.2f}-"
            f"{q['engine'][2]:.2f}), microservice {q['micro'][1]:.2f} ms (p25-p75 "
            f"{q['micro'][0]:.2f}-{q['micro'][2]:.2f}), engine overhead "
            f"{q['engine'][1] - q['micro'][1]:.2f} ms")


def _host_overhead(card, engine_app):
    """The engine's host cost without device noise: a SIMPLE_MODEL unit
    through the engine against the same unit behind a component
    microservice, median of 200 each (ABBA order)."""
    from seldon_core_tpu_torch import wrapper
    from seldon_core_tpu_torch.graph.units import SimpleModelUnit

    app = engine_app({"name": "m", "implementation": "SIMPLE_MODEL"})
    micro = wrapper.get_rest_microservice(SimpleModelUnit())
    port, micro_port = _free_port(), _free_port()
    rest = app.rest_app()

    async def start():
        await rest.start("127.0.0.1", port)
        await micro.start("127.0.0.1", micro_port)

        async def close():
            rest.close()
            micro.close()
            await app.executor.close()
        return close

    stop = serve_in_thread(start)
    try:
        msg = {"data": {"ndarray": [[1.0, 2.0]]}}
        lat = _paired_latency(
            lambda: _post(port, msg, path="/api/v0.1/predictions"),
            lambda: _post(micro_port, msg), 200)
    finally:
        stop()
        micro._hook_pool.shutdown(wait=False)
    log(f"[engine] SIMPLE_MODEL request, client side, median of 200 (host only): "
        f"{_lat_line(lat)} [{card}]")


def phase_engine(card, alone_ref):
    """The engine path at llm-1.26b full width: an EngineApp over one
    in-process GENERATE_SERVER unit on CUDA, served on REST (and gRPC
    when grpcio imports), driven with the serve phase's waves; then a
    greedy request alone against the serve phase's, SSE streams against
    unary, a dropped stream, a two-unit RAG graph, a remote REST hop, a
    1 ms deadline, and the engine's per-request overhead against a
    component microservice over the same generate server."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch import wrapper
    from seldon_core_tpu_torch.graph.engine_metrics import MetricsRegistry
    from seldon_core_tpu_torch.graph.service import EngineApp
    from seldon_core_tpu_torch.graph.spec import (
        PredictorSpec,
        default_predictor,
        validate_predictor,
    )
    from seldon_core_tpu_torch.ops import flash_attention as fa

    def engine_app(graph, registry=None):
        spec = PredictorSpec.from_dict({
            "name": "llm-1-26b", "graph": graph,
            # generate requests outlive the 5 s default unit-call timeout
            "annotations": {"seldon.io/rest-read-timeout": "600000"}})
        spec = default_predictor(spec)
        validate_predictor(spec)
        return EngineApp(spec, registry=registry, metrics=MetricsRegistry())

    with tempfile.TemporaryDirectory(prefix="chip-smoke-engine-") as model_dir:
        with open(os.path.join(model_dir, "jax_config.json"), "w") as f:
            json.dump({"family": "llm", "config": LLM_1_26B}, f)
        unit = {"name": "llm", "implementation": "GENERATE_SERVER",
                "modelUri": model_dir, "parameters": SERVE_PARAMS}
        t0 = time.perf_counter()
        app = engine_app(unit)  # resolves, loads and warms the generate server
        gen = app.executor.root.client.user_object
        if gen.device.type != "cuda" or gen.batcher.device.type != "cuda":
            raise AssertionError(f"engine generate unit on {gen.device}, not CUDA")
        log(f"[engine] EngineApp over GENERATE_SERVER (llm-1.26b) loaded and warmed in "
            f"{time.perf_counter() - t0:.1f} s on {gen.batcher.device}")
        # the same generate server behind a component microservice: the
        # remote hop's target and the yardstick of the engine's overhead
        micro = wrapper.get_rest_microservice(gen)
        rag = {"name": "rag", "implementation": "RAG_PROMPT_BUILDER", "parameters": [
            {"name": "max_new_tokens", "value": str(MAX_NEW), "type": "INT"},
            {"name": "temperature", "value": "0.0", "type": "FLOAT"},
            {"name": "seed", "value": "0", "type": "INT"}], "children": [dict(unit)]}
        app_rag = engine_app(rag, registry={"llm": gen})
        micro_port = _free_port()
        app_remote = engine_app(dict(unit, endpoint={
            "service_host": "127.0.0.1", "service_port": micro_port, "transport": "REST"}))
        grpc_ok = _grpc_available()
        port, rag_port, remote_port = _free_port(), _free_port(), _free_port()
        grpc_port = _free_port() if grpc_ok else None

        async def start():
            listeners = [app.rest_app(), app_rag.rest_app(), app_remote.rest_app(), micro]
            for http_app, p in zip(listeners, (port, rag_port, remote_port, micro_port)):
                await http_app.start("127.0.0.1", p)
            gsrv = None
            if grpc_ok:
                gsrv = app.grpc_server()
                gsrv.add_insecure_port(f"127.0.0.1:{grpc_port}")
                await gsrv.start()

            async def close():
                for http_app in listeners:
                    http_app.close()
                if gsrv is not None:
                    await gsrv.stop(grace=0.5)
                for a in (app, app_rag, app_remote):
                    await a.executor.close()
            return close

        stop = serve_in_thread(start)
        b = gen.batcher
        try:
            def post(body, headers=None, to=port):
                return _post(to, body, path="/api/v0.1/predictions", headers=headers)

            probe, mixed = serve_waves()
            g20, s20 = probe[0][1], probe[1][1]
            prefill0 = b.stats["prefill_steps"]
            run_waves("engine", post, b, probe, mixed, card)

            # a greedy request alone: the serve phase's tokens
            status, out = post(_gen_body(g20))
            if status != 200:
                raise AssertionError(f"greedy_20 alone: HTTP {status} {out}")
            alone = out["jsonData"]["tokens"]
            if alone != alone_ref:
                raise AssertionError("greedy_20 alone: engine tokens differ from the microservice's")
            status, out = post(_gen_body(s20, 1.0, 3))
            if status != 200:
                raise AssertionError(f"seeded_20 alone: HTTP {status} {out}")
            seeded_alone = out["jsonData"]["tokens"]
            log("[engine] greedy_20 alone: engine tokens == microservice tokens (serve phase)")

            # SSE: spans concatenate to the unary result of the same request
            for label, toks, temp, seed, unary in (
                    ("greedy_20", g20, 0.0, 0, alone[0]),
                    ("seeded_20", s20, 1.0, 3, seeded_alone[0])):
                events = _sse(port, _gen_body(toks, temp, seed))
                streamed = [t for ev in events[:-1] for t in ev["tokens"]]
                if len(events) <= 2 or not events[-1].get("done") \
                        or events[-1]["tokens"] != unary or streamed != unary[len(toks):]:
                    raise AssertionError(f"SSE {label}: {len(events)} events do not "
                                         "concatenate to the unary result")
                log(f"[engine] SSE {label}: {len(events)} events, spans == unary tokens")

            # a dropped stream cancels its request and frees the lane
            cancelled0 = b.stats["cancelled"]
            _sse_drop_after_first(port, _gen_body(g20))
            _wait_for(lambda: b.stats["cancelled"] > cancelled0, "the dropped stream's cancel")
            _wait_for(lambda: not b._active and app.inflight == 0, "the lane to come back")
            status, out = post(_gen_body(g20, max_new=8))
            if status != 200 or len(out["jsonData"]["tokens"][0]) != 28:
                raise AssertionError(f"request after the dropped stream: HTTP {status}")
            log(f"[engine] dropped stream: cancelled {cancelled0} -> {b.stats['cancelled']}, "
                "lane freed, next request admitted")

            # two-unit graph: RAG_PROMPT_BUILDER -> GENERATE_SERVER
            status, out = post({"data": {"ndarray": [g20]}}, to=rag_port)
            if status != 200 or out["jsonData"]["tokens"] != alone:
                raise AssertionError(f"RAG graph: HTTP {status}, tokens differ from the "
                                     "single-unit graph's")
            log(f"[engine] RAG_PROMPT_BUILDER -> GENERATE_SERVER == single unit "
                f"(path {out['meta']['requestPath']})")

            # remote hop: the generate unit behind the component microservice
            status, out = post(_gen_body(g20), to=remote_port)
            if status != 200 or out["jsonData"]["tokens"] != alone:
                raise AssertionError(f"remote REST hop: HTTP {status}, tokens differ")
            log("[engine] remote REST hop to the component microservice == in-process")

            # a 1 ms budget is refused, never served
            counters = ("seldon_engine_deadline_exceeded", "seldon_engine_load_shed")
            before = [app.metrics.counter_total(c) for c in counters]
            status, out = post(_gen_body(g20), headers={"Seldon-Deadline-Ms": "1"})
            after = [app.metrics.counter_total(c) for c in counters]
            if status not in (504, 429) or after == before:
                raise AssertionError(f"1 ms deadline: HTTP {status}, counters {before} -> {after}")
            log(f"[engine] 1 ms deadline: HTTP {status}; deadline_exceeded/load_shed "
                f"{before} -> {after}")

            if grpc_ok:
                import grpc

                from seldon_core_tpu_torch.payload import json_to_proto, proto_to_json
                from seldon_core_tpu_torch.proto import prediction_pb2 as pb

                with grpc.insecure_channel(f"127.0.0.1:{grpc_port}") as ch:
                    unary_rpc = ch.unary_unary(
                        "/seldontpu.Seldon/Predict",
                        request_serializer=lambda m: m.SerializeToString(),
                        response_deserializer=pb.SeldonMessage.FromString)
                    stream_rpc = ch.unary_stream(
                        "/seldontpu.Seldon/GenerateStream",
                        request_serializer=lambda m: m.SerializeToString(),
                        response_deserializer=pb.SeldonMessage.FromString)
                    req = json_to_proto(_gen_body(g20))
                    got = proto_to_json(unary_rpc(req, timeout=600))["jsonData"]["tokens"]
                    chunks = [proto_to_json(m)["jsonData"] for m in stream_rpc(req, timeout=600)]
                streamed = [t for c in chunks[:-1] for t in c["tokens"]]
                if got != alone or chunks[-1]["tokens"] != alone[0] or streamed != alone[0][20:]:
                    raise AssertionError("gRPC Predict/GenerateStream differ from REST")
                log(f"[engine] gRPC Predict == REST; GenerateStream {len(chunks)} messages == REST")
            else:
                log("[engine] gRPC front not driven: grpcio is absent on this machine "
                    "(import grpc, google.protobuf failed); the CPU tests hold it")

            launches = fa.LAUNCHES["flash_attention"]
            prefills = b.stats["prefill_steps"] - prefill0
            layers = LLM_1_26B["n_layers"]
            log(f"[engine] whole engine phase: prefill dispatches {prefills}, flash kernel "
                f"launches {launches} (need >= {layers} x {prefills})")
            if prefills <= 0 or launches < layers * prefills:
                raise AssertionError("not every engine prefill went through the flash kernel")

            # the engine's per-request overhead: one 1-token request through
            # the engine vs the same request to the microservice over the
            # same generate server, median of 20 each (ABBA order)
            one = _gen_body(g20, max_new=1)
            lat = _paired_latency(
                lambda: post(one), lambda: _post(micro_port, one), 20)
            log(f"[engine] 1-token request, client side, median of 20: {_lat_line(lat)} "
                f"[{card}]")

            # the engine's end-to-end cost: the same waves through the
            # engine and through the microservice over the same generate
            # server, in one process, alternated (ABBA twice)
            paths = {"engine": post, "micro": lambda body: _post(micro_port, body)}
            ab = {"engine": [], "micro": []}
            for name in ("engine", "micro", "micro", "engine") * 2:
                b.slo_recent.clear()
                t = time.perf_counter()
                results = [fire(paths[name], wave) for wave in (probe, mixed, probe)]
                wall = time.perf_counter() - t
                if any(st != 200 for res in results for st, _out in res.values()):
                    raise AssertionError(f"A/B waves via {name}: a request failed")
                tok_s = MAX_NEW * (2 * len(probe) + len(mixed)) / wall
                ab[name].append((tok_s, _slo(b)))
            for name, runs in ab.items():
                tok = [r[0] for r in runs]
                tpot = [r[1]["tpot_p50"] for r in runs]
                ttft = [r[1]["ttft_p50"] for r in runs]
                log(f"[engine] A/B waves via {name} (4 runs): tokens/s median "
                    f"{np.median(tok):.1f} {[round(x, 1) for x in tok]}; TPOT p50 median "
                    f"{np.median(tpot):.2f} {[round(x, 2) for x in tpot]} ms; TTFT p50 median "
                    f"{np.median(ttft):.1f} {[round(x, 1) for x in ttft]} ms [{card}]")
        finally:
            stop()
            micro._hook_pool.shutdown(wait=False)
            gen.close()
        _host_overhead(card, engine_app)
        return launches, gen._model, b.params


# the scheduler phase's configurations (llm-1.26b, 8 slots, steps_per_poll
# 16, pipeline_depth 3, attn_bucket 128): A is today's eager path, kept
# behind the batcher's cuda_graphs argument as the comparison
SCHED_BASE = dict(slots=8, steps_per_poll=16, pipeline_depth=3, attn_bucket=128)
SCHED_CONFIGS = {
    "A": ("every knob off, graphs off", dict(cuda_graphs=False)),
    "B": ("every knob off, graphs on", {}),
    "C": ("fused_steps_per_dispatch 64", dict(fused_steps_per_dispatch=64)),
    "D": ("C + depth_groups 4, split forced (depth_group_split_bytes 0)",
          dict(fused_steps_per_dispatch=64, depth_groups=4, depth_group_split_bytes=0)),
    "E": ("C + prefill_chunk 256", dict(fused_steps_per_dispatch=64, prefill_chunk=256)),
    "F": ("depth_groups 4, default cost model", dict(depth_groups=4)),
}
WARM_LENS = (20, 128, 300, 500, 900)
# mid-burst stops: steps of a request's knobs-off run whose token becomes
# its eos_id (see _pick_stops)
STOP_STEPS = (3, 17, 40, 63)


class _Gate:
    """A poll hook that parks the batcher's loop, so that a whole wave is
    queued before the loop takes any of it: the wave is admitted in one
    poll and every run of it has the same batch composition."""

    def __init__(self):
        self.hold, self.parked, self.go = threading.Event(), threading.Event(), threading.Event()

    def __call__(self, _poll):
        if self.hold.is_set():
            self.parked.set()
            self.go.wait(60)

    def submit_together(self, batcher, items):
        self.go.clear()
        self.parked.clear()
        self.hold.set()
        if not self.parked.wait(30):
            raise AssertionError("the batcher loop did not reach its poll hook")
        try:
            return [batcher.submit(toks, max_new_tokens=MAX_NEW, temperature=temp,
                                   seed=seed, eos_id=eos)
                    for toks, temp, seed, eos in items]
        finally:
            self.hold.clear()
            self.go.set()


def _sched_batcher(model, params, cfg_kw, gate=None):
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    b = ContinuousBatcher(model, params, **SCHED_BASE, **cfg_kw)
    b.fault_hook = gate
    return b


def _wave_tokens(gate, batcher, wave, eos=None):
    futs = gate.submit_together(batcher, [
        (toks, temp, seed, (eos or {}).get(label)) for label, toks, temp, seed in wave])
    return {label: f.result(timeout=600) for (label, *_r), f in zip(wave, futs)}


def _sched_run(gate, b, probe, mixed):
    """One run of the serve waves (probe, mixed, probe), each queued
    whole: tokens by label, tokens/s, the SLO percentiles, the flash
    launches, the scheduler counters' deltas and the peak memory."""
    import torch

    from seldon_core_tpu_torch.ops import flash_attention as fa

    b.slo_recent.clear()
    stats0 = dict(b.stats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES["flash_attention"] = 0
    t = time.perf_counter()
    out = {}
    for i, wave in enumerate((probe, mixed, probe)):
        got = _wave_tokens(gate, b, wave)
        out.update({(lab if i < 2 else lab + "#2"): v for lab, v in got.items()})
    wall = time.perf_counter() - t
    delta = {k: v - stats0[k] for k, v in b.stats.items() if isinstance(v, (int, float))}
    return {"tokens": out, "tok_s": MAX_NEW * (2 * len(probe) + len(mixed)) / wall,
            "slo": _slo(b), "launches": fa.LAUNCHES["flash_attention"], "delta": delta,
            "peak": torch.cuda.max_memory_allocated()}


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _check_sched_run(name, run, probe, mixed):
    """Shape, flash-launch and repeat checks of one run."""
    vocab = LLM_1_26B["vocab_size"]
    for key, out in run["tokens"].items():
        toks = _p(key, probe, mixed)
        if len(out) != len(toks) + MAX_NEW or out[: len(toks)] != toks \
                or not all(0 <= x < vocab for x in out):
            raise AssertionError(f"[sched] {name} {key}: malformed tokens")
    for label, *_r in probe:
        if run["tokens"][label] != run["tokens"][label + "#2"]:
            raise AssertionError(f"[sched] {name} {label}: repeated request gave other tokens")
    d = run["delta"]
    whole = d["prefill_steps"] - d["prefill_chunks"]
    layers = LLM_1_26B["n_layers"]
    if whole <= 0 or run["launches"] < layers * whole:
        raise AssertionError(f"[sched] {name}: {whole} whole-prompt prefills but "
                             f"{run['launches']} flash launches (need >= {layers} each)")


def phase_scheduler(card, model, params):
    """The scheduler knobs at llm-1.26b full width (bf16, 8 slots):
    configurations A-F of SCHED_CONFIGS driven with the serve waves, A/B
    and A/C alternated in one process (ABBA twice); the gated checks and
    the reported numbers are in the module docstring."""
    import gc

    import numpy as np
    import torch

    probe, mixed = serve_waves()
    prompts = {label: toks for label, toks, _t, _s in mixed}
    gate = _Gate()
    runs = {name: [] for name in SCHED_CONFIGS}
    info = {}

    def build(name):
        b = _sched_batcher(model, params, SCHED_CONFIGS[name][1], gate)
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
        t = time.perf_counter()
        b.warm(prompt_lens=WARM_LENS, max_new_tokens=MAX_NEW)
        info[name] = {"warm_s": time.perf_counter() - t,
                      "warm_reserved": torch.cuda.memory_reserved() - reserved,
                      "graphs": b.stats["graphs_captured"],
                      "capture_s": b.stats["graph_capture_s"],
                      "pool": b.stats["graph_pool_bytes"]}
        b.start()
        return b

    live = {name: build(name) for name in ("A", "B", "C")}
    for other in ("B", "C"):
        for name in (("A", other, other, "A") * 2):
            runs[name].append(_sched_run(gate, live[name], probe, mixed))
    # the stops ride the mixed wave itself (same batch composition as the
    # knobs-off run they are read from)
    eos, expect = _pick_stops(runs["A"][0]["tokens"], prompts)
    stops = {}
    for name in ("A", "B", "C"):
        stops[name] = _wave_tokens(gate, live[name], mixed, eos)
    inline = {}
    for name in ("A", "B", "C"):
        inline[name] = live[name].stats["graph_captures_inline"]
        live[name].close()
    live.clear()
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("D", "E", "F"):
        b = build(name)
        for _ in range(2):
            runs[name].append(_sched_run(gate, b, probe, mixed))
        stops[name] = _wave_tokens(gate, b, mixed, eos)
        inline[name] = b.stats["graph_captures_inline"]
        b.close()
        del b
        gc.collect()
        torch.cuda.empty_cache()

    a0 = runs["A"][0]["tokens"]
    for name, rs in runs.items():
        for run in rs:
            _check_sched_run(name, run, probe, mixed)
            if run["tokens"] != rs[0]["tokens"]:
                raise AssertionError(f"[sched] {name}: the same waves gave other tokens")
        if name in ("A", "B", "C") and rs[0]["tokens"] != a0:
            bad = [k for k in a0 if rs[0]["tokens"][k] != a0[k]]
            raise AssertionError(f"[sched] {name} != A at full width: {bad}")
        if name != "A" and inline[name]:
            raise AssertionError(f"[sched] {name}: {inline[name]} graphs captured after warm()")
        for label, e in eos.items():
            out = stops[name][label]
            gen = out[len(prompts[label]):]
            if e in gen[:-1] or (gen[-1] != e and len(gen) < MAX_NEW):
                raise AssertionError(f"[sched] {name} {label}: did not stop at its eos {e}")
            if name in ("A", "B", "C") and out != expect[label]:
                raise AssertionError(f"[sched] {name} {label}: stop differs from the "
                                     f"knobs-off run ({len(out)} vs {len(expect[label])} tokens)")
        if name in ("A", "B", "C"):
            rest = [k for k in prompts if k not in eos and stops[name][k] != a0[k]]
            if rest:
                raise AssertionError(f"[sched] {name}: streams beside the stops changed: {rest}")
    d_groups = sum(r["delta"]["group_bursts"] for r in runs["D"])
    if d_groups <= 0:
        raise AssertionError("[sched] D: the forced split dispatched no group burst")
    if sum(r["delta"]["prefill_chunks"] for r in runs["E"]) <= 0:
        raise AssertionError("[sched] E: no prompt was chunked")
    log(f"[sched] B == A and C == A token for token (greedy and seeded, {len(a0)} "
        "streams per run); every configuration repeatable; every stop fired at its "
        "step; no graph captured after warm()")

    for name, (label, _kw) in SCHED_CONFIGS.items():
        rs = runs[name]
        d = {k: sum(r["delta"][k] for r in rs) for k in rs[0]["delta"]}
        same = [k for k in a0 if rs[0]["tokens"][k] == a0[k]]
        diffs = {k: _first_diff(rs[0]["tokens"][k][len(_p(k, probe, mixed)):],
                                a0[k][len(_p(k, probe, mixed)):])
                 for k in a0 if k not in same}
        stop_same = sum(stops[name][lab] == expect[lab] for lab in eos)
        k_real = d["fused_steps"] / d["fused_dispatches"] if d["fused_dispatches"] else None
        occ = (d["group_lanes"] / (d["group_lanes"] + d["group_pad_lanes"])
               if d["group_bursts"] else None)
        launches_step = d["graph_replays"] / d["steps"] if d["steps"] else 0.0
        med = {m: float(np.median([r["slo"][m] for r in rs]))
               for m in ("ttft_p50", "ttft_p99", "tpot_p50")}
        info[name].update(runs=len(rs), launches=[r["launches"] for r in rs])
        log(f"[sched] {name} ({label}), {len(rs)} runs: tokens/s median "
            f"{np.median([r['tok_s'] for r in rs]):.1f} {[round(r['tok_s'], 1) for r in rs]}; "
            f"TTFT p50 {med['ttft_p50']:.1f} p99 {med['ttft_p99']:.1f} ms; TPOT p50 "
            f"{med['tpot_p50']:.2f} ms {[round(r['slo']['tpot_p50'], 2) for r in rs]} "
            f"[{card}]")
        log(f"[sched] {name}: peak device memory {max(r['peak'] for r in rs) / 2**30:.2f} GiB "
            f"(all live batchers); graph pool grew {info[name]['pool'] / 2**20:.1f} MiB over "
            f"{info[name]['graphs']} graphs captured in {info[name]['capture_s']:.2f} s "
            f"(warm {info[name]['warm_s']:.1f} s); host launches per decode step "
            f"{'eager (see [model])' if name == 'A' else f'{launches_step:.3f} graph replays'}; "
            f"realized K {k_real if k_real is None else round(k_real, 2)}; group bursts "
            f"{d['group_bursts']} occupancy {occ if occ is None else round(occ, 3)}; prefill "
            f"chunks {d['prefill_chunks']}; flash launches {info[name]['launches']}")
        log(f"[sched] {name}: {len(same)} of {len(a0)} streams equal A's"
            + (f"; first differing generated step {diffs}" if diffs else "")
            + f"; stops equal to A's {stop_same} of {len(eos)}")
    return {name: info[name]["launches"][0] for name in SCHED_CONFIGS}


def _pick_stops(tokens, prompts):
    """For each of STOP_STEPS, a request of the mixed wave (never the
    deepest, greedy_900, whose lane sets every burst's attention bucket)
    whose knobs-off token at that step is its first occurrence there, so
    the stop can only fire at that step: ``({label: eos}, {label:
    expected stream})``. Where no request qualifies, the next free one
    is taken and its stop fires at the token's first occurrence."""
    eos, expect, notes = {}, {}, []
    free = [lab for lab in prompts if lab != "greedy_900"]
    for step in STOP_STEPS:
        def first_at(lab):
            gen = tokens[lab][len(prompts[lab]):]
            return gen.index(gen[step])

        label = next((lab for lab in free if first_at(lab) == step), free[0])
        free.remove(label)
        n = len(prompts[label])
        eos[label] = tokens[label][n + step]
        fires = first_at(label)
        expect[label] = tokens[label][: n + fires + 1]
        notes.append(f"{label} eos {eos[label]} (its step-{step} token) fires at step {fires}")
    log("[sched] mid-burst stops on the mixed wave: " + "; ".join(notes))
    return eos, expect


def _p(key, probe, mixed):
    label = key.split("#")[0]
    return next(toks for lab, toks, _t, _s in list(probe) + list(mixed) if lab == label)


SMALL_CFG = dict(vocab_size=512, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
                 d_ff=512, max_seq=128, dtype="float32")


def phase_small_scheduler():
    """f32 small model on the card: configurations A-E (the full-width
    phase's knobs at this size, MIN_ATTN_BUCKET lowered to 16 so that
    depth groups really split) give the same tokens, greedy and seeded,
    and no graph is captured after warm()."""
    import numpy as np
    import torch

    from seldon_core_tpu_torch.models.llm import DecoderLM
    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    model = DecoderLM(**SMALL_CFG)
    params = model.init_params(0, device="cuda")
    rs = np.random.RandomState(5)
    lens = (5, 39, 12, 50, 20, 3, 60, 33)
    reqs = [(rs.randint(0, SMALL_CFG["vocab_size"], n).tolist(),
             dict(max_new_tokens=24 + i % 5, **({"temperature": 0.9, "seed": i} if i % 2 else {})))
            for i, n in enumerate(lens)]
    base = dict(slots=4, prefill_buckets=(32, 64), steps_per_poll=4, attn_bucket=16)
    fused = dict(fused_steps_per_dispatch=16)
    configs = {"A": dict(cuda_graphs=False), "B": {}, "C": fused,
               "D": dict(fused, depth_groups=4, depth_group_split_bytes=0),
               "E": dict(fused, prefill_chunk=32)}
    old = ContinuousBatcher.MIN_ATTN_BUCKET
    ContinuousBatcher.MIN_ATTN_BUCKET = 16
    outs, notes = {}, []
    try:
        for name, kw in configs.items():
            b = ContinuousBatcher(model, params, **base, **kw)
            try:
                b.warm(prompt_lens=lens, max_new_tokens=28)
                got = [[b.submit(p, **r).result(timeout=300) for p, r in reqs]]
                futs = [b.submit(p, **r) for p, r in reqs]
                got.append([f.result(timeout=300) for f in futs])
                s = b.stats
                if name != "A" and s["graph_captures_inline"]:
                    raise AssertionError(f"[small-sched] {name}: graphs captured after warm()")
            finally:
                b.close()
            if got[0] != got[1]:
                raise AssertionError(f"[small-sched] {name}: one at a time != together")
            outs[name] = got[0]
            notes.append(f"{name} graphs {s['graphs_captured']} fused {s['fused_dispatches']} "
                         f"group bursts {s['group_bursts']} chunks {s['prefill_chunks']}")
            if name == "D" and not s["group_bursts"]:
                raise AssertionError("[small-sched] D: groups never split")
            if name == "E" and not s["prefill_chunks"]:
                raise AssertionError("[small-sched] E: nothing was chunked")
    finally:
        ContinuousBatcher.MIN_ATTN_BUCKET = old
    for name, got in outs.items():
        if got != outs["A"]:
            bad = [i for i, (x, y) in enumerate(zip(got, outs["A"])) if x != y]
            raise AssertionError(f"[small-sched] {name} != A at f32 (requests {bad})")
    log(f"[small-sched] f32 on the card: A == B == C == D == E token for token, greedy and "
        f"seeded, {len(reqs)} requests one at a time and together; " + "; ".join(notes))


def phase_model(model, params):
    """Model-layer times at full width: prefill per bucket (B=1), and one
    ragged decode step over 8 lanes — its wall time beside the device
    time its kernels take (torch.profiler), whose gap is the host's
    dispatch time, and the step's weight-read bound."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    cfg = model.cfg
    rs = np.random.RandomState(2)
    prompts = {t: torch.tensor(rs.randint(0, cfg.vocab_size, (1, t)), device="cuda")
               for t in (32, 128, 512, 1024)}
    wall = {t: time_ms(lambda: model.prefill(params, toks, t), iters=5, warmup=1)
            for t, toks in prompts.items()}
    # then, under the profiler (after all the wall times: a profiler run
    # can slow later launches), the flash kernel's device time inside a
    # prefill, by its name in the per-kernel sums
    for t, toks in prompts.items():
        n = 3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                model.prefill(params, toks, t)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        busy_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
        flash = [e for e in events if "flash_fwd" in e.key]
        flash_ms = sum(e.self_device_time_total for e in flash) / 1e3 / n
        flash_calls = sum(e.count for e in flash) / n
        log(f"[model] prefill B=1 T={t}: {wall[t]:.2f} ms; device busy {busy_ms:.3f} ms, of "
            f"which the flash kernel {flash_ms:.4f} ms over {flash_calls:.0f} launches "
            f"({100 * flash_ms / busy_ms:.1f}% of the device time)")
    shape = (8, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
    ks = [torch.zeros(shape, dtype=model.dtype, device="cuda") for _ in range(cfg.n_layers)]
    vs = [torch.zeros(shape, dtype=model.dtype, device="cuda") for _ in range(cfg.n_layers)]
    tok = torch.zeros((8, 1), dtype=torch.long, device="cuda")
    weight_ms = model.n_params() * 2 / PEAK_BYTES_S * 1e3
    for attn_len in (128, 1024):
        pos = torch.full((8,), attn_len - 1, dtype=torch.long, device="cuda")

        def step():
            model.decode_step_ragged_list(params, ks, vs, tok, pos, attn_len=attn_len)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        n = 10
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
        device_ms = sum(e.self_device_time_total for e in events) / 1e3 / n
        kernels = sum(e.count for e in events) / n
        log(f"[model] decode step, 8 lanes, attn_len {attn_len}: wall {wall_ms:.2f} ms, "
            f"device busy {device_ms:.2f} ms ({kernels:.0f} device ops), "
            f"weight-read bound {weight_ms:.2f} ms")
    phase_burst(model, params, weight_ms)


def phase_burst(model, params, weight_ms, k=16, n=6):
    """A whole decode burst through the batcher (8 lanes, k steps), eager
    (graphs off) against CUDA-graph replay: per step, the host's wall
    time (uninstrumented, host clock), the device span (CUDA events),
    the device-busy time and device operations (``torch.profiler``), the
    launches the host made (``cudaLaunchKernel`` / ``cudaGraphLaunch``)
    and the busy share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seldon_core_tpu_torch.serving.continuous import ContinuousBatcher

    for graphs in (False, True):
        b = ContinuousBatcher(model, params, **SCHED_BASE, cuda_graphs=graphs)
        try:
            b.warm(prompt_lens=(100, 900), max_new_tokens=0)
            b._whole.act.fill_(True)
            for attn_len in (128, 1024):
                def burst():
                    b._whole_burst(k, attn_len, False, False)
                    b._whole.pos.zero_()

                burst()
                torch.cuda.synchronize()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                for _ in range(n):
                    burst()
                end.record()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / (n * k)
                span = start.elapsed_time(end) / (n * k)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(n):
                        burst()
                    torch.cuda.synchronize()
                events = prof.key_averages()
                dev = [e for e in events if e.device_type.name == "CUDA"]
                busy = sum(e.self_device_time_total for e in dev) / 1e3 / (n * k)
                ops = sum(e.count for e in dev) / (n * k)
                calls = {name: sum(e.count for e in events if e.key == name) / (n * k)
                         for name in ("cudaLaunchKernel", "cudaGraphLaunch")}
                log(f"[burst] {'graph replay' if graphs else 'eager'}, 8 lanes, k {k}, attn_len "
                    f"{attn_len}, per step: wall {wall:.3f} ms, device span {span:.3f} ms, "
                    f"device busy {busy:.3f} ms ({ops:.0f} device ops), host launches "
                    f"cudaLaunchKernel {calls['cudaLaunchKernel']:.1f} cudaGraphLaunch "
                    f"{calls['cudaGraphLaunch']:.2f}, busy share of wall {busy / wall:.3f}; "
                    f"weight-read bound {weight_ms:.2f} ms")
        finally:
            b.close()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import seldon_core_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the seldon_core_tpu_torch package is missing: {e}", file=sys.stderr)
        return 1
    try:
        t0 = time.perf_counter()
        card = phase_device()
        phase_build()
        kern = phase_kernels(card)
        phase_small_model()
        launches, alone = phase_serve(card)
        import gc

        gc.collect()  # the serve phase's copy of the model goes
        torch.cuda.empty_cache()
        engine_launches, model, params = phase_engine(card, alone)
        gc.collect()
        torch.cuda.empty_cache()
        phase_small_scheduler()
        sched_launches = phase_scheduler(card, model, params)
        # the profiler runs last: once it has traced the card, later
        # launches may carry its overhead
        phase_model(model, params)
        head = kern["b1_t1024"]
        worst = max(r["max_abs_err"] for k, r in kern.items() if not k.startswith("f32"))
        log(json.dumps({"kernels": [{
            "name": "flash_attention",
            "route": "cuda",
            "source": "seldon_core_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "seldon_core_tpu/ops/flash_attention.py:138",
            "launches": launches,
            "engine_launches": engine_launches,
            "scheduler_launches": sched_launches,
            "max_abs_err": worst,
            "ms": head["ms"],
            "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library_device_ms": head["library_device_ms"],
        }]}))
        log(f"[done] {time.perf_counter() - t0:.1f} s")
    except Exception:  # noqa: BLE001 - any failed phase fails the run
        traceback.print_exc()
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
