"""Offline config-sweep profiler: live engine -> SPF1 cost model.

Counterpart of ``seldon_core_tpu/planning/profiler_sweep.py``.

InferLine-style (PAPERS.md, arxiv 1812.01776) offline stage: drive a
REAL generate engine — not a simulator — through a grid of serving
configs (slots x prefill chunk x fused K x depth-group split x kv-tier
bytes) under one seeded :class:`~.trafficsim.TrafficSim` trace, and
price every config from the telemetry the engine already exports:

* tokens/s from the replay wall clock,
* TTFT/TPOT/queue-wait quantiles from the scheduler's SLO reservoir
  (``slo_summary()`` — the same samples /prometheus exports),
* HBM footprint from the engine's own weight + KV-cache accounting,
* per-kind device-time split from the DeviceTimeLedger,
* a compile census (variant count + wall build/warm seconds) so the
  planner — and the fusion cost gate — can price what a config change
  COSTS, not just what it yields.

The caller owns engine construction (``factory(config) -> batcher``)
because only the caller knows the model family, mesh and runtime tier;
the sweep owns measurement and artifact assembly, so every profile on
disk has the same shape regardless of who drove it. Factories build,
warm and return a live ``ContinuousBatcher`` (or anything matching its
``submit/slo_summary/stats/retune_census/close`` surface); the sweep
closes each instance before building the next so two grid points never
contend for the same device.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from .artifact import CONFIG_KEYS, build_profile, normalize_config
from .trafficsim import TrafficEvent, TrafficSim, replay

logger = logging.getLogger(__name__)


def sweep_grid(
    slots: Sequence[int] = (4, 8),
    prefill_chunk: Sequence[int] = (0,),
    fused_steps: Sequence[int] = (0, 4, 8),
    depth_groups: Sequence[int] = (0,),
    depth_group_split_bytes: Sequence[int] = (0,),
    kv_tier_bytes: Sequence[int] = (0,),
) -> List[Dict[str, int]]:
    """The cartesian config grid, normalized to CONFIG_KEYS. Axes
    default to singletons so callers only pay for what they sweep."""
    out: List[Dict[str, int]] = []
    for s in slots:
        for pc in prefill_chunk:
            for fk in fused_steps:
                for dg in depth_groups:
                    for sb in depth_group_split_bytes:
                        for kt in kv_tier_bytes:
                            out.append(normalize_config({
                                "slots": s,
                                "prefill_chunk": pc,
                                "fused_steps_per_dispatch": fk,
                                "depth_groups": dg,
                                "depth_group_split_bytes": sb,
                                "kv_tier_bytes": kt,
                            }))
    return out


def _quant(slo: Optional[Dict[str, Any]], phase: str, q: str) -> float:
    if not slo:
        return 0.0
    block = slo.get(phase)
    if not block:
        return 0.0
    return float(block.get(q, 0.0) or 0.0)


def _compile_variants(census: Optional[Dict[str, Any]]) -> int:
    """Warmed-executable count implied by a boot census — the same
    vocabulary retune validation speaks (fused K variants x group-burst
    doubling, plus the chunked-prefill executable when enabled)."""
    if not census:
        return 1
    n = max(1, len(census.get("fused_ks") or ()))
    if int(census.get("depth_groups") or 0) > 1:
        n *= 2
    if int(census.get("prefill_chunk") or 0) > 0:
        n += 1
    return n


def measure_config(
    batcher,
    trace: List[TrafficEvent],
    build_s: float = 0.0,
    timeout_s: float = 120.0,
) -> Dict[str, Any]:
    """Replay ``trace`` through one live engine as fast as it admits
    and harvest the prices. Shed/expired requests are expected under
    pressure sweeps — they count as not-generated, never as failure."""
    t0 = time.monotonic()
    done = 0
    tokens = 0
    shed = 0

    def submit(ev: TrafficEvent):
        try:
            return batcher.submit(
                ev.prompt,
                max_new_tokens=ev.max_new_tokens,
                tenant=ev.tenant,
                deadline_s=ev.deadline_s,
            )
        except Exception:  # noqa: BLE001 - admission shed IS a datum
            return None

    handles = replay(trace, submit)
    deadline = t0 + timeout_s
    for h in handles:
        if h is None:
            shed += 1
            continue
        try:
            out = h.result(timeout=max(0.1, deadline - time.monotonic()))
            tokens += len(out)
            done += 1
        except Exception:  # noqa: BLE001 - per-request expiry/preempt
            shed += 1
    elapsed = max(1e-6, time.monotonic() - t0)
    slo = batcher.slo_summary() if hasattr(batcher, "slo_summary") else None
    census = (
        batcher.retune_census() if hasattr(batcher, "retune_census") else None
    )
    prof = getattr(batcher, "_prof", None)
    device = {}
    if prof is not None and getattr(prof, "enabled", False):
        try:
            device = dict(prof.summary().get("by_kind") or {})
        except Exception:  # noqa: BLE001 - telemetry must not fail a sweep
            device = {}
    kv_bytes = int(getattr(batcher, "_kv_key_bytes", 0) or 0)
    hbm = int(
        int(getattr(batcher, "_param_bytes", 0) or 0)
        + int(getattr(batcher, "slots", 0) or 0)
        * int(getattr(batcher, "max_seq", 0) or 0)
        * kv_bytes
    )
    return {
        "tokens_per_s": round(tokens / elapsed, 3),
        "ttft_p50_ms": _quant(slo, "ttft_ms", "p50_ms"),
        "ttft_p99_ms": _quant(slo, "ttft_ms", "p99_ms"),
        "tpot_p50_ms": _quant(slo, "tpot_ms", "p50_ms"),
        "tpot_p99_ms": _quant(slo, "tpot_ms", "p99_ms"),
        "hbm_bytes": hbm,
        "requests": done,
        "shed": shed,
        "compile_census": {
            "variants": _compile_variants(census),
            "compile_s": round(max(0.0, build_s), 3),
        },
        "device_time": device,
    }


def run_sweep(
    factory: Callable[[Dict[str, int]], Any],
    grid: Iterable[Dict[str, Any]],
    sim: TrafficSim,
    model_family: str,
    mesh_shape: Optional[Dict[str, int]] = None,
    max_events: Optional[int] = None,
    created: Optional[str] = None,
) -> Dict[str, Any]:
    """Sweep the grid and return a validated SPF1 profile dict (write
    it with :func:`~.artifact.write_profile`). The SAME seeded trace
    replays against every config — the grid prices configs, not luck.
    A config the factory refuses to build (e.g. slots past the device's
    HBM) is logged and skipped, never silently priced as zero."""
    trace = sim.trace(max_events=max_events)
    if not trace:
        raise ValueError("traffic sim produced an empty trace")
    entries: List[Dict[str, Any]] = []
    skipped = 0
    for config in grid:
        config = normalize_config(config)
        t_build = time.monotonic()
        try:
            batcher = factory(config)
        except Exception as e:  # noqa: BLE001 - unbuildable grid point
            skipped += 1
            logger.warning("sweep: config %s unbuildable: %s", config, e)
            continue
        build_s = time.monotonic() - t_build
        try:
            prices = measure_config(batcher, trace, build_s=build_s)
        finally:
            close = getattr(batcher, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 - teardown best-effort
                    logger.exception("sweep: close failed for %s", config)
        entries.append({"config": config, **prices})
        logger.info(
            "sweep: %s -> %.1f tok/s ttft_p99=%.1fms tpot_p99=%.1fms",
            {k: v for k, v in config.items() if v},
            prices["tokens_per_s"], prices["ttft_p99_ms"],
            prices["tpot_p99_ms"],
        )
    if not entries:
        raise ValueError(
            f"sweep produced no measurable configs ({skipped} skipped)"
        )
    if skipped:
        logger.warning("sweep: %d of %d grid points skipped",
                       skipped, skipped + len(entries))
    return build_profile(
        model_family, entries, mesh_shape=mesh_shape, created=created,
    )


__all__ = [
    "CONFIG_KEYS",
    "measure_config",
    "run_sweep",
    "sweep_grid",
]
