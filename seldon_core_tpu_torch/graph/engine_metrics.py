"""Engine-side metrics registry with Prometheus text exposition.

Counterpart of ``seldon_core_tpu/graph/engine_metrics.py``. Parity with
the reference engine's Micrometer setup: auto-timed server/client request
timers with percentile histograms (reference:
engine/src/main/resources/application.properties:4-11,
engine/.../metrics/CustomMetricsManager.java:27-70 for dynamic
counters/gauges/timers fed from ``Meta.metrics``), scraped at
``/prometheus`` (and ``/metrics``). :meth:`MetricsRegistry.fleet_snapshot`,
:meth:`MetricsRegistry.ingest_fleet` and :func:`diff_fleet_snapshot` are
the fleet plane's mergeable view (the engine's ``/fleet`` route).
"""

from __future__ import annotations

import math
import threading
from collections import defaultdict
from typing import Dict, List, Tuple

# latency buckets in seconds (log-spaced 100us..10s, like Micrometer SLO defaults)
_BUCKETS = [
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
]

LabelKey = Tuple[Tuple[str, str], ...]

# engine-side micro-batching (graph/batching.py), labelled by MODEL unit:
# flushes (one fused downstream call each), the rows they carried, the
# bucket-padding rows added, and the rows waiting (a gauge); the JAX
# engine's series names
MICROBATCH_FLUSHES = "seldon_engine_microbatch_flushes"
MICROBATCH_ROWS = "seldon_engine_microbatch_rows"
MICROBATCH_PADDED_ROWS = "seldon_engine_microbatch_padded_rows"
MICROBATCH_QUEUE_DEPTH = "seldon_engine_microbatch_queue_depth"

# graph fusion (graph/fusion.py), labelled by segment ("a|b|c") or unit:
# fused dispatches served, fallbacks to the hop-by-hop walk by reason,
# and segments the cost gate left unfused (reason="cost"); the JAX
# engine's series names
FUSED_SEGMENTS = "seldon_engine_fused_segments"
FUSION_FALLBACKS = "seldon_engine_fusion_fallbacks"
FUSION_SKIPPED = "seldon_engine_fusion_skipped"


def _labels_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Dict[LabelKey, float]] = defaultdict(lambda: defaultdict(float))
        self._gauges: Dict[str, Dict[LabelKey, float]] = defaultdict(dict)
        # name -> labels -> [bucket counts..., sum, count]
        self._histograms: Dict[str, Dict[LabelKey, List[float]]] = defaultdict(dict)

    def counter_inc(self, name: str, labels: Dict[str, str] | None = None, value: float = 1.0):
        with self._lock:
            self._counters[name][_labels_key(labels or {})] += value

    def gauge_set(self, name: str, value: float, labels: Dict[str, str] | None = None):
        with self._lock:
            self._gauges[name][_labels_key(labels or {})] = value

    def observe(self, name: str, seconds: float, labels: Dict[str, str] | None = None):
        key = _labels_key(labels or {})
        with self._lock:
            h = self._histograms[name].get(key)
            if h is None:
                h = [0.0] * (len(_BUCKETS) + 2)
                self._histograms[name][key] = h
            for i, b in enumerate(_BUCKETS):
                if seconds <= b:
                    h[i] += 1
            h[-2] += seconds
            h[-1] += 1

    # generate-scheduler step counters additionally export as ONE
    # first-class series with a phase label: prefill vs decode device
    # steps per graph node
    _STEP_PHASES = {
        "gen_prefill_steps": ("seldon_engine_generate_steps", "prefill"),
        "gen_decode_steps": ("seldon_engine_generate_steps", "decode"),
        "gen_prefill_tokens": ("seldon_engine_generate_step_tokens", "prefill"),
    }

    # disaggregated serving: KV-slab handoff counters land in first-class
    # seldon_engine_kv_transfer_* series with a direction label (export =
    # a prefill pool shipping slabs out, import = a decode pool splicing
    # them in), plus the transfer-dedup savings counter
    _KV_TRANSFER = {
        "gen_kv_export_slabs": ("seldon_engine_kv_transfer_slabs", "export"),
        "gen_kv_import_slabs": ("seldon_engine_kv_transfer_slabs", "import"),
        "gen_kv_export_bytes": ("seldon_engine_kv_transfer_bytes", "export"),
        "gen_kv_import_bytes": ("seldon_engine_kv_transfer_bytes", "import"),
        "gen_kv_transfer_bytes_saved": ("seldon_engine_kv_transfer_bytes_saved", None),
    }

    # fault tolerance: supervised batcher restarts, prefill-peer
    # ejections/readmissions and local-prefill degradation land in
    # first-class series, the scheduler's health in a first-class gauge
    # (1 = serving, 0 = restarting/dead; readiness mirrors it)
    _RECOVERY = {
        "gen_batcher_restarts": "seldon_engine_batcher_restarts",
        "gen_peer_ejections": "seldon_engine_peer_ejections",
        "gen_peer_readmissions": "seldon_engine_peer_readmissions",
        "gen_degraded_local_prefill": "seldon_engine_degraded_local_prefill",
        # HBM pressure: decode-lane preemptions and their resumes, the
        # admission sheds and remote-admit refusals while the ledger is
        # latched, and the reclaim ladder's prefix evictions
        "gen_preemptions": "seldon_engine_preemptions",
        "gen_preempt_resumes": "seldon_engine_preemption_resumes",
        "gen_pressure_sheds": "seldon_engine_pressure_sheds",
        "gen_pressure_refused": "seldon_engine_pressure_refused",
        "gen_pressure_prefix_evictions": "seldon_engine_pressure_prefix_evictions",
        # host KV tier: slabs demoted to host RAM, lookups that found an
        # entry, entries promoted back to the device (prefix match, peer
        # pull, checkpoint copy-back), entries evicted or dropped as
        # corrupt, and resumes that fell back to recompute + replay
        "gen_kv_tier_demotions": "seldon_engine_kv_tier_demotions",
        "gen_kv_tier_promotions": "seldon_engine_kv_tier_promotions",
        "gen_kv_tier_hits": "seldon_engine_kv_tier_hits",
        "gen_kv_tier_evictions": "seldon_engine_kv_tier_evictions",
        "gen_kv_tier_replay_fallbacks": "seldon_engine_kv_tier_replay_fallbacks",
        # live migration and swap: graceful drains, checkpoints exported
        # and handed to a peer, resumes admitted from wire checkpoints or
        # resume tokens, swap straggler preemptions
        "gen_drains": "seldon_engine_drains_total",
        "gen_checkpoint_exports": "seldon_engine_checkpoint_exports",
        "gen_migrations": "seldon_engine_migrations_total",
        "gen_migrated_resumes": "seldon_engine_migrations_resumed",
        "gen_swap_preemptions": "seldon_engine_swap_preemptions",
        # multi-tenant serving: per-tenant completions (the tenant tag
        # becomes a label), scheduler switches, and the weight pager's
        # page-ins, page-outs, evictions and refusals
        "gen_tenant_requests": "seldon_engine_tenant_requests",
        "gen_tenant_switches": "seldon_engine_tenant_switches",
        "gen_weight_page_ins": "seldon_engine_weight_page_ins",
        "gen_weight_page_outs": "seldon_engine_weight_page_outs",
        "gen_weight_pager_evictions": "seldon_engine_weight_pager_evictions",
        "gen_weight_pager_refused": "seldon_engine_weight_pager_refused",
        # live retune: retunes the scheduler applied at a poll boundary
        # (refused ones never reach the stats)
        "gen_planner_retunes": "seldon_engine_planner_retunes",
    }

    # fused stop-aware decode: device steps run inside fused bursts and
    # the dispatches that carried them; steps / dispatches is the
    # realized burst length
    _FUSED = {
        "gen_fused_steps": "seldon_engine_fused_steps",
        "gen_fused_dispatches": "seldon_engine_fused_dispatches",
    }
    _RECOVERY_GAUGES = {
        "gen_batcher_healthy": "seldon_engine_batcher_healthy",
        # the HBM-pressure ledger: used vs budget, and whether the high
        # watermark is latched (1 = admissions held and shed)
        "gen_pressure_used_bytes": "seldon_engine_pressure_used_bytes",
        "gen_pressure_budget_bytes": "seldon_engine_pressure_budget_bytes",
        "gen_pressure_active": "seldon_engine_pressure_active",
        # host KV tier occupancy: host RAM, deliberately not one of the
        # HBM pressure gauges (the ledger never counts tier bytes)
        "gen_kv_tier_bytes": "seldon_engine_kv_tier_bytes",
        # sharded serving: the mesh a member serves on and one position's
        # footprint (param_shard_bytes under the split layout, against
        # the global param bytes; the ways the KV cache's bytes divide)
        "gen_mesh_devices": "seldon_engine_mesh_devices",
        "gen_mesh_data": "seldon_engine_mesh_data",
        "gen_mesh_model": "seldon_engine_mesh_model",
        "gen_mesh_param_shard_bytes": "seldon_engine_mesh_param_shard_bytes",
        "gen_mesh_kv_shard": "seldon_engine_mesh_kv_shard",
        # the weight pager: host-RAM staging bytes (not an HBM pressure
        # gauge), the resident tenant's weight bytes (the ledger's
        # "pager" component) and the tenants staged
        "gen_weight_pager_host_bytes": "seldon_engine_weight_pager_host_bytes",
        "gen_weight_pager_resident_bytes": "seldon_engine_weight_pager_resident_bytes",
        "gen_tenants_registered": "seldon_engine_tenants_registered",
    }

    # device-time ledger (serving/profiler.py): seconds, dispatches and
    # modelled read bytes per (kind, variant[, tenant]);
    # gen_device_time_ms arrives in ms and lands in seconds
    _DEVICE = {
        "gen_device_time_ms": "seldon_engine_device_time_seconds",
        "gen_device_dispatches": "seldon_engine_device_dispatches",
        "gen_device_bytes": "seldon_engine_device_bytes",
    }

    # SLO burn verdict evaluations per (slo, severity[, tenant])
    _SLO_BURN = {
        "gen_slo_verdicts": "seldon_engine_slo_burn_verdicts",
    }

    # the ledger's live gauges over its sliding window (busy fraction,
    # MBU, dispatch-floor share) and the burn engine's burn rates and
    # remaining error budget
    _DEVICE_GAUGES = {
        "gen_device_busy_frac": "seldon_engine_device_busy_frac",
        "gen_mbu_pct": "seldon_engine_mbu_pct",
        "gen_dispatch_floor_pct": "seldon_engine_dispatch_floor_pct",
        "gen_slo_burn_rate": "seldon_engine_slo_burn_rate",
        "gen_slo_budget_remaining": "seldon_engine_slo_budget_remaining",
    }

    # generate SLO TIMERs (per completed request, shipped by the generate
    # server's metrics() hook) additionally land in first-class latency
    # histograms per graph node: TTFT, TPOT and admit-queue wait
    _SLO_TIMERS = {
        "gen_ttft_ms": "seldon_engine_generate_ttft_seconds",
        "gen_tpot_ms": "seldon_engine_generate_tpot_seconds",
        "gen_queue_wait_ms": "seldon_engine_generate_queue_wait_seconds",
        # the per-tenant split of the same samples, the tenant as a label
        "gen_tenant_ttft_ms": "seldon_engine_tenant_ttft_seconds",
        "gen_tenant_tpot_ms": "seldon_engine_tenant_tpot_seconds",
        "gen_tenant_queue_wait_ms": "seldon_engine_tenant_queue_wait_seconds",
    }

    def record_custom(self, metrics: List[Dict], labels: Dict[str, str] | None = None):
        """Sink for Meta.metrics emitted by components
        (reference: PredictiveUnitBean.addCustomMetrics:318-344)."""
        for m in metrics or []:
            tags = dict(labels or {})
            tags.update(m.get("tags") or {})
            mtype = m.get("type", "COUNTER")
            key = m.get("key", "custom")
            val = float(m.get("value", 0))
            if mtype == "COUNTER":
                self.counter_inc(f"seldon_custom_{key}", tags, val)
                step = self._STEP_PHASES.get(key)
                if step is not None:
                    name, phase = step
                    self.counter_inc(name, {**tags, "phase": phase}, val)
                kv = self._KV_TRANSFER.get(key)
                if kv is not None:
                    name, direction = kv
                    self.counter_inc(
                        name, {**tags, "direction": direction} if direction else tags, val)
                recovery = self._RECOVERY.get(key)
                if recovery is not None:
                    self.counter_inc(recovery, tags, val)
                fused = self._FUSED.get(key)
                if fused is not None:
                    self.counter_inc(fused, tags, val)
                dev = self._DEVICE.get(key)
                if dev is not None:
                    self.counter_inc(
                        dev, tags, val / 1000.0 if key == "gen_device_time_ms" else val)
                burn = self._SLO_BURN.get(key)
                if burn is not None:
                    self.counter_inc(burn, tags, val)
            elif mtype == "GAUGE":
                self.gauge_set(f"seldon_custom_{key}", val, tags)
                rg = self._RECOVERY_GAUGES.get(key)
                if rg is not None:
                    self.gauge_set(rg, val, tags)
                dg = self._DEVICE_GAUGES.get(key)
                if dg is not None:
                    self.gauge_set(dg, val, tags)
            elif mtype == "TIMER":
                self.observe(f"seldon_custom_{key}", val / 1000.0, tags)
                slo = self._SLO_TIMERS.get(key)
                if slo is not None:
                    self.observe(slo, val / 1000.0, tags)

    # -- label-subset readers ------------------------------------------------
    # A series matches when its labels are a SUPERSET of the given ones, so
    # {"deployment": "canary"} sums over every unit/tag variant of that
    # predictor's series without the caller enumerating them.

    @staticmethod
    def _matches(key: LabelKey, want: Dict[str, str]) -> bool:
        have = dict(key)
        return all(have.get(k) == v for k, v in want.items())

    def counter_total(self, name: str, labels: Dict[str, str] | None = None) -> float:
        want = labels or {}
        with self._lock:
            series = self._counters.get(name)
            if not series:
                return 0.0
            return float(sum(
                v for key, v in series.items() if self._matches(key, want)
            ))

    def histogram_totals(
        self, name: str, labels: Dict[str, str] | None = None
    ) -> Tuple[float, float]:
        """(sum_seconds, count) over every matching histogram series —
        window-diffing two calls gives a mean over exactly that window."""
        want = labels or {}
        total_sum, total_count = 0.0, 0.0
        with self._lock:
            for key, h in self._histograms.get(name, {}).items():
                if self._matches(key, want):
                    total_sum += h[-2]
                    total_count += h[-1]
        return total_sum, total_count

    def quantile(self, name: str, q: float, labels: Dict[str, str] | None = None) -> float:
        """Approximate quantile from histogram buckets (for tests/bench)."""
        key = _labels_key(labels or {})
        with self._lock:
            h = self._histograms.get(name, {}).get(key)
            if not h or h[-1] == 0:
                return math.nan
            target = q * h[-1]
            prev = 0.0
            for i, b in enumerate(_BUCKETS):
                if h[i] >= target:
                    return b
                prev = b
            return prev

    # -- fleet plane (cross-member aggregation) ---------------------------

    def fleet_snapshot(self) -> Dict[str, Dict]:
        """JSON-safe dump of every series -- counters and gauges with their
        label sets, histograms with their whole bucket arrays -- that
        ``/fleet`` ships, so a scraper merges members instead of deriving
        quantiles from quantiles (bucket counts add; p99s do not)."""
        def pack(series):
            return [{"labels": dict(key), "value": v} for key, v in series.items()]

        with self._lock:
            return {
                "counters": {n: pack(s) for n, s in self._counters.items()},
                "gauges": {n: pack(s) for n, s in self._gauges.items()},
                "histograms": {
                    n: [{"labels": dict(key), "h": list(h)} for key, h in s.items()]
                    for n, s in self._histograms.items()
                },
                "buckets": list(_BUCKETS),
            }

    def ingest_fleet(self, snapshot: Dict[str, Dict],
                     extra_labels: Dict[str, str] | None = None) -> None:
        """Merge one member's :meth:`fleet_snapshot` (diffed by the caller
        between scrapes: see :func:`diff_fleet_snapshot`) into this
        registry: counters and histogram buckets add, gauges overwrite
        per label set. ``extra_labels`` keeps members apart after the
        merge; a member on another histogram grid has its histograms
        skipped, never misbinned."""
        extra = extra_labels or {}
        snap_buckets = snapshot.get("buckets")
        if snap_buckets is not None and list(snap_buckets) != list(_BUCKETS):
            snapshot = {**snapshot, "histograms": {}}
        for name, series in (snapshot.get("counters") or {}).items():
            for ent in series:
                self.counter_inc(name, {**ent["labels"], **extra}, float(ent["value"]))
        for name, series in (snapshot.get("gauges") or {}).items():
            for ent in series:
                self.gauge_set(name, float(ent["value"]), {**ent["labels"], **extra})
        with self._lock:
            for name, series in (snapshot.get("histograms") or {}).items():
                for ent in series:
                    key = _labels_key({**ent["labels"], **extra})
                    src = [float(x) for x in ent["h"]]
                    if len(src) != len(_BUCKETS) + 2:
                        continue
                    h = self._histograms[name].get(key)
                    if h is None:
                        self._histograms[name][key] = src
                    else:
                        for i, x in enumerate(src):
                            h[i] += x

    def expose(self) -> str:
        lines: List[str] = []
        with self._lock:
            for name, series in self._counters.items():
                lines.append(f"# TYPE {name} counter")
                for key, v in series.items():
                    lines.append(f"{name}{_fmt_labels(key)} {v}")
            for name, series in self._gauges.items():
                lines.append(f"# TYPE {name} gauge")
                for key, v in series.items():
                    lines.append(f"{name}{_fmt_labels(key)} {v}")
            for name, series in self._histograms.items():
                lines.append(f"# TYPE {name} histogram")
                for key, h in series.items():
                    for i, b in enumerate(_BUCKETS):
                        le = f'le="{b}"'
                        lines.append(f"{name}_bucket{_fmt_labels(key, le)} {h[i]}")
                    inf = 'le="+Inf"'
                    lines.append(f"{name}_bucket{_fmt_labels(key, inf)} {h[-1]}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} {h[-2]}")
                    lines.append(f"{name}_count{_fmt_labels(key)} {h[-1]}")
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()


def diff_fleet_snapshot(prev: Dict | None, cur: Dict) -> Dict:
    """Per-member delta between two :meth:`MetricsRegistry.fleet_snapshot`
    captures, what :meth:`MetricsRegistry.ingest_fleet` takes. Counters
    and histogram buckets diff elementwise; a negative delta (the member
    restarted, its totals reset) falls back to the current total. Gauges
    are levels and pass through."""
    if not prev:
        return cur

    def key(ent):
        return tuple(sorted(ent["labels"].items()))

    out: Dict[str, Dict] = {
        "counters": {},
        "gauges": cur.get("gauges") or {},
        "histograms": {},
        "buckets": cur.get("buckets"),
    }
    for name, series in (cur.get("counters") or {}).items():
        pmap = {key(e): float(e["value"]) for e in (prev.get("counters") or {}).get(name, [])}
        ents = []
        for e in series:
            d = float(e["value"]) - pmap.get(key(e), 0.0)
            if d < 0:
                d = float(e["value"])
            if d:
                ents.append({"labels": e["labels"], "value": d})
        if ents:
            out["counters"][name] = ents
    for name, series in (cur.get("histograms") or {}).items():
        pmap = {key(e): e["h"] for e in (prev.get("histograms") or {}).get(name, [])}
        ents = []
        for e in series:
            h = [float(x) for x in e["h"]]
            ph = pmap.get(key(e))
            if ph is not None and len(ph) == len(h):
                dh = [a - float(b) for a, b in zip(h, ph)]
                if any(x < 0 for x in dh):
                    dh = h
            else:
                dh = h
            if any(dh):
                ents.append({"labels": e["labels"], "h": dh})
        if ents:
            out["histograms"][name] = ents
    return out
