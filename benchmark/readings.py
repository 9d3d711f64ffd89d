"""What the metric readers compute, from one run's records.

Every reader under ``benchmark/metrics/<name>.py`` is a ``read(run)``
that returns a number or None (nothing to read: the harness then leaves
the metric out of the line). ``run`` carries:

* ``records``: the load generator's record of every request (due and
  send times, token events or the answer, errors);
* ``plan``: the traffic's plan (sizes of every request); ``model``: the
  configuration's model keys;
* ``t0``, ``t1``: the measured window on the monotonic clock;
  ``seconds``: its length; ``setup_s``;
* ``before``, ``at_close``, ``after``: the system's counters at the
  window's start, at its close and once every request has answered;
  ``until``: at the end of the part of the window no trace disturbed
  (the traced sub-window's start in a traced run, else the close) --
  the per-layer readers of the program's counters read ``before`` to
  ``until``; ``sub_before``, ``sub_after``: at the sub-window's edges;
* ``sub``: the traced sub-window's summary (``subwindow.py``), or None
  in an untraced run.

Readers of one quantity split by the end-to-end metric it moves share a
function here.
"""

from __future__ import annotations

import math
import re
from typing import Optional

from benchmark import counts, stats

DECODE_KINDS = ("decode_burst", "fused_burst", "group_burst")


def lanes_per_step(run) -> Optional[float]:
    """Decoded tokens per decode step in the window: lanes that did
    useful work in an average step (first tokens, which prefill makes,
    left out)."""
    a, b = run.before["stats"], run.until["stats"]
    steps = b["steps"] - a["steps"]
    if steps <= 0:
        return None
    return ((b["tokens"] - a["tokens"]) - (b["admitted"] - a["admitted"])) / steps


def device_idle_pct(run) -> Optional[float]:
    """Share of the traced sub-window with nothing running on the device."""
    sub = run.sub
    if sub is None or not sub.get("busy_s"):
        return None
    return 100.0 * (1.0 - sub["busy_s"] / sub["window_s"])


# the ledger's variants of a whole-prompt prefill, the dispatches that
# run the flash kernel: "p<bucket>" (one prompt) or "m<m>p<bucket>" (m
# prompts of one bucket); a suffix prefill over a cached prefix ("px")
# and a chunk attend without it
_FLASH_PREFILL = re.compile(r"^(?:m(\d+))?p(\d+)$")


def flash_roofline(run) -> Optional[float]:
    """The flash kernel's launches in the traced sub-window: the least
    time of their work (bf16 peak, HBM rate) over their device time, in %.
    The count and device time of the launches come from the trace; their
    shapes from the prefills the device-time ledger dispatched in the
    sub-window (one launch a layer of [m, heads, bucket, head_dim] with
    the configuration's key/value heads, causal). Where the trace holds a
    launch more or fewer than the ledger's dispatches at its edges, the
    launches are priced at the dispatches' mean."""
    sub = run.sub
    if sub is None or not sub.get("kernels"):
        return None
    a, b = (getattr(run, "sub_before", {}) or {}).get("ledger"), \
        (getattr(run, "sub_after", {}) or {}).get("ledger")
    if a is None or b is None:
        return None
    m = run.model
    H, KV, L = m["n_heads"], m["n_kv_heads"], m["n_layers"]
    dh = m["d_model"] // H
    launches = bound = 0.0
    for key, v in b.items():
        kind, variant = key[0], key[1]
        hit = _FLASH_PREFILL.match(variant)
        if kind != "prefill" or not hit:
            continue
        n = v[1] - a.get(key, (0.0, 0.0))[1]
        rows, t = int(hit.group(1) or 1), int(hit.group(2))
        launches += n * L
        bound += n * L * counts.flash_bound_s(rows, H, KV, t, dh)
    if launches <= 0:
        return None
    spent = sum(secs for _name, secs in sub["kernels"])
    return 100.0 * (bound / launches) * len(sub["kernels"]) / spent


def _gen_flops_in(run, t0: float, t1: float) -> float:
    """Model FLOPs of the tokens clients received inside [t0, t1]: a
    request's prefill (the prompt past its cache hit) when its first
    token came then, and each later token at its context."""
    m, plan = run.model, run.plan
    total = 0.0
    per0 = counts.decoder_flops_per_token(m, 0.0)
    slope = counts.decoder_flops_per_token(m, 1.0) - per0
    for r in run.records:
        spans = r["spans"]
        if not spans:
            continue
        p = int(plan.prompt_len[r["i"]])
        j = 0  # index of the span's first token in the output
        for t, c in spans:
            if t0 <= t <= t1:
                lo = j
                if j == 0:
                    hit = int(r.get("hit") or 0)
                    total += counts.decoder_prefill_flops(m, hit, p - hit)
                    lo = 1
                n = j + c - lo
                if n > 0:
                    # token k (k >= 1) is decoded at context p + k
                    ctx_sum = n * p + (lo + j + c - 1) * n / 2.0
                    total += n * per0 + slope * ctx_sum
            j += c
    return total


def step_mfu(run) -> Optional[float]:
    """Model FLOPs of the work the traced sub-window completed over the
    device's busy seconds in it at the bf16 peak, in %: the whole step's
    share of the chip's peak while it runs."""
    sub = run.sub
    if sub is None or not sub.get("busy_s"):
        return None
    if run.plan.kind == "generate":
        flops = _gen_flops_in(run, sub["t0"], sub["t1"])
    else:
        rows = sum(run.plan.n_rows for _r in stats.answered_in(run.records, sub["t0"],
                                                                  sub["t1"]))
        flops = rows * counts.bert_flops_per_row(run.model, run.plan.pad_to)
    if flops <= 0:
        return None
    return 100.0 * flops / (sub["busy_s"] * counts.PEAK_FLOPS["bfloat16"])


def finite(x: Optional[float]) -> Optional[float]:
    """None for a missing or infinite reading (a tail past the failures)."""
    return None if x is None or math.isinf(x) else x

