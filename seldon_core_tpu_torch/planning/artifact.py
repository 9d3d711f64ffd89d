"""Serving profile artifact (SPF1) + the cost model the planner walks.

Counterpart of ``seldon_core_tpu/planning/artifact.py``.

The offline profiler (``profiler_sweep.py``) sweeps a live generate
engine through a config grid and prices every config as measured
(tokens/s, TTFT/TPOT quantiles, HBM footprint, compile census,
device-time split). That grid persists as ONE versioned, CRC-framed
artifact — ``SPF1``, a sibling of the KV-slab (SKV1), generate
checkpoint (SGC1) and weight-pager (SWP1) frames, with the same typed
refusals: short frame → :class:`~..serving.disagg.TruncatedStream`,
bit flip → :class:`~..serving.disagg.ChecksumError`, wrong magic /
version / malformed grid → :class:`ProfileError`. A corrupt profile
must refuse BEFORE the planner acts on it — a half-read cost model
steering live retunes is strictly worse than no planner at all.

:class:`CostModel` answers the two questions the online planner asks:

* ``price(config)`` — the measured entry for a swept config (exact
  match only; the planner never extrapolates a retune target it has
  no measurement for).
* ``predict(config)`` — an InferLine-style analytic fit for ranking
  between measured points: per-token time is modeled as
  ``t_step + floor / max(1, fused_k)`` (a per-dispatch floor amortized
  over the fused burst), HBM as ``base + slots * per_slot_bytes``.
  Both fits are clamped non-negative, which makes the two planner-load
  monotonicities structural: predicted tokens/s never decreases in
  fused K, predicted HBM never decreases in slots
  (tests/test_planning.py asserts both).

``best(...)`` walks the measured grid under TTFT/TPOT p99 objectives
and an optional HBM budget and returns the highest-throughput config
that meets them — or, when nothing does, the one with the smallest
worst breach ratio, flagged ``meets=False`` so the planner can treat
it as a scale signal instead of a retune.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..serving.disagg import ChecksumError, DisaggError, TruncatedStream

MAGIC = b"SPF1"
PROFILE_VERSION = 1

# the knobs a profile grid entry is keyed on — the sweep axes. Order is
# the canonical config identity (``config_key``); every grid entry must
# carry every key so two profiles are always comparable.
CONFIG_KEYS = (
    "slots",
    "prefill_chunk",
    "fused_steps_per_dispatch",
    "depth_groups",
    "depth_group_split_bytes",
    "kv_tier_bytes",
)

# the measured prices every grid entry must carry
PRICE_KEYS = (
    "tokens_per_s",
    "ttft_p50_ms",
    "ttft_p99_ms",
    "tpot_p50_ms",
    "tpot_p99_ms",
    "hbm_bytes",
)


class ProfileError(DisaggError):
    """A profile frame parsed but is not a usable SPF1 artifact (bad
    magic, wrong version, malformed grid). Typed so callers can tell
    "corrupt file" from "wire truncation" from "bit flip"."""


def config_key(config: Dict[str, Any]) -> Tuple:
    """Canonical identity of one swept config (CONFIG_KEYS order)."""
    return tuple(config.get(k) for k in CONFIG_KEYS)


def normalize_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Fill every CONFIG_KEYS slot (missing -> 0) and drop extras, so
    sweep grids written by different callers stay comparable."""
    return {k: int(config.get(k) or 0) for k in CONFIG_KEYS}


def validate_profile(profile: Dict[str, Any]) -> Dict[str, Any]:
    """Structural validation shared by encode and decode — a profile
    that cannot steer the planner refuses here, typed, on BOTH sides
    (writing a bad artifact is as much a bug as reading one)."""
    if not isinstance(profile, dict):
        raise ProfileError(f"profile must be a dict, got {type(profile).__name__}")
    if profile.get("v") != PROFILE_VERSION:
        raise ProfileError(f"unsupported profile version {profile.get('v')!r}")
    fam = profile.get("model_family")
    if not fam or not isinstance(fam, str):
        raise ProfileError(f"profile needs a model_family, got {fam!r}")
    mesh = profile.get("mesh_shape")
    if mesh is not None and not isinstance(mesh, dict):
        raise ProfileError(f"mesh_shape must be a dict or null, got {mesh!r}")
    grid = profile.get("grid")
    if not isinstance(grid, list) or not grid:
        raise ProfileError("profile grid is empty — nothing to plan over")
    seen = set()
    for i, entry in enumerate(grid):
        if not isinstance(entry, dict):
            raise ProfileError(f"grid[{i}] is not a dict")
        cfg = entry.get("config")
        if not isinstance(cfg, dict):
            raise ProfileError(f"grid[{i}] has no config dict")
        for k in CONFIG_KEYS:
            v = cfg.get(k)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ProfileError(
                    f"grid[{i}].config[{k!r}] must be an int >= 0, got {v!r}"
                )
        key = config_key(cfg)
        if key in seen:
            raise ProfileError(f"grid[{i}] duplicates config {dict(cfg)}")
        seen.add(key)
        for k in PRICE_KEYS:
            v = entry.get(k)
            if not isinstance(v, (int, float)) or isinstance(v, bool) or v < 0:
                raise ProfileError(
                    f"grid[{i}].{k} must be a number >= 0, got {v!r}"
                )
    return profile


def encode_profile(profile: Dict[str, Any]) -> bytes:
    """One SPF1 frame: magic | length | CRC | JSON payload."""
    validate_profile(profile)
    payload = json.dumps(profile, separators=(",", ":"), sort_keys=True).encode()
    return MAGIC + struct.pack("<II", len(payload), zlib.crc32(payload)) + payload


def decode_profile(data: bytes) -> Dict[str, Any]:
    """Decode + validate one SPF1 frame. Typed refusals BEFORE the
    planner can act: short buffer → :class:`~..serving.disagg.TruncatedStream`,
    CRC mismatch → :class:`~..serving.disagg.ChecksumError`, bad
    magic / version / grid → :class:`ProfileError`."""
    if len(data) < 12:
        raise TruncatedStream(f"profile frame is {len(data)} bytes, need >= 12")
    if data[:4] != MAGIC:
        raise ProfileError(f"bad profile magic {data[:4]!r} (want {MAGIC!r})")
    n, crc = struct.unpack("<II", data[4:12])
    payload = data[12:12 + n]
    if len(payload) < n:
        raise TruncatedStream(f"profile payload is {len(payload)} of {n} bytes")
    if zlib.crc32(payload) != crc:
        raise ChecksumError("profile frame failed its checksum")
    try:
        profile = json.loads(payload)
    except ValueError as e:
        raise ProfileError(f"profile payload is not JSON: {e}") from e
    return validate_profile(profile)


def write_profile(path: str, profile: Dict[str, Any]) -> None:
    with open(path, "wb") as f:
        f.write(encode_profile(profile))


def read_profile(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return decode_profile(f.read())


class CostModel:
    """Measured grid + clamped analytic fit over one decoded profile."""

    def __init__(self, profile: Dict[str, Any]):
        self.profile = validate_profile(profile)
        self.grid: List[Dict[str, Any]] = list(profile["grid"])
        self._by_key = {config_key(e["config"]): e for e in self.grid}
        self._fit_throughput()
        self._fit_hbm()

    # -- fits ---------------------------------------------------------------

    def _fit_throughput(self) -> None:
        # least squares of 1/tps = t_step + floor * (1/k_eff) over the
        # measured grid; k_eff = max(1, fused K). Clamping both
        # coefficients at >= 0 is what makes predict() monotone in K.
        pts = []
        for e in self.grid:
            tps = float(e["tokens_per_s"])
            if tps <= 0:
                continue
            k_eff = max(1, int(e["config"]["fused_steps_per_dispatch"]))
            pts.append((1.0 / k_eff, 1.0 / tps))
        if not pts:
            self._t_step, self._floor = 1e-3, 0.0
            return
        n = len(pts)
        mx = sum(x for x, _ in pts) / n
        my = sum(y for _, y in pts) / n
        sxx = sum((x - mx) ** 2 for x, _ in pts)
        sxy = sum((x - mx) * (y - my) for x, y in pts)
        floor = (sxy / sxx) if sxx > 0 else 0.0
        floor = max(0.0, floor)
        t_step = max(1e-9, my - floor * mx)
        self._t_step, self._floor = t_step, floor

    def _fit_hbm(self) -> None:
        # hbm = base + slots * per_slot, per_slot clamped >= 0 so
        # predicted footprint is monotone in slots.
        pts = [(int(e["config"]["slots"]), float(e["hbm_bytes"])) for e in self.grid]
        n = len(pts)
        mx = sum(x for x, _ in pts) / n
        my = sum(y for _, y in pts) / n
        sxx = sum((x - mx) ** 2 for x, _ in pts)
        sxy = sum((x - mx) * (y - my) for x, y in pts)
        per_slot = (sxy / sxx) if sxx > 0 else 0.0
        per_slot = max(0.0, per_slot)
        self._hbm_base = max(0.0, my - per_slot * mx)
        self._hbm_per_slot = per_slot

    # -- queries ------------------------------------------------------------

    def price(self, config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The measured grid entry for ``config`` (exact match), or
        None — the planner only retunes toward measured points."""
        return self._by_key.get(config_key(normalize_config(config)))

    def predict(self, config: Dict[str, Any]) -> Dict[str, float]:
        """Analytic prices for an unswept config (ranking only — never
        a retune target by itself)."""
        cfg = normalize_config(config)
        k_eff = max(1, cfg["fused_steps_per_dispatch"])
        per_token_s = self._t_step + self._floor / k_eff
        return {
            "tokens_per_s": 1.0 / per_token_s,
            "hbm_bytes": self._hbm_base + self._hbm_per_slot * cfg["slots"],
        }

    def best(
        self,
        ttft_p99_ms: Optional[float] = None,
        tpot_p99_ms: Optional[float] = None,
        hbm_budget_bytes: Optional[int] = None,
        require: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """Highest-throughput measured config meeting the objectives
        (``meets=True``), else the smallest-worst-breach one
        (``meets=False`` — a scale signal, not a retune target).
        ``require`` pins config keys (e.g. the boot census only admits
        one prefill_chunk value — out-of-census retunes are refused by
        the batcher anyway, so don't even rank them)."""
        candidates = []
        for e in self.grid:
            cfg = e["config"]
            if require and any(
                cfg.get(k) != v for k, v in require.items() if v is not None
            ):
                continue
            if hbm_budget_bytes is not None and e["hbm_bytes"] > hbm_budget_bytes:
                continue
            breach = 0.0
            if ttft_p99_ms is not None and ttft_p99_ms > 0:
                breach = max(breach, e["ttft_p99_ms"] / ttft_p99_ms)
            if tpot_p99_ms is not None and tpot_p99_ms > 0:
                breach = max(breach, e["tpot_p99_ms"] / tpot_p99_ms)
            candidates.append((breach, e))
        if not candidates:
            raise ProfileError(
                "no profile entry satisfies the hard constraints "
                f"(require={require!r}, hbm_budget={hbm_budget_bytes!r})"
            )
        meeting = [e for breach, e in candidates if breach <= 1.0]
        if meeting:
            # deterministic: max tokens/s, ties broken by fewer slots
            # then the canonical config key
            win = max(
                meeting,
                key=lambda e: (
                    e["tokens_per_s"],
                    -e["config"]["slots"],
                    tuple(-(v or 0) for v in config_key(e["config"])),
                ),
            )
            return {"meets": True, "entry": win, "config": dict(win["config"])}
        breach, win = min(candidates, key=lambda be: (be[0], config_key(be[1]["config"])))
        return {
            "meets": False,
            "entry": win,
            "config": dict(win["config"]),
            "worst_breach": round(breach, 4),
        }

    # -- fusion cost gate ----------------------------------------------------

    def fusion_gate(self, expected_dispatches: int = 100_000) -> Dict[str, float]:
        """The compile-cost-vs-dispatch-savings gate the graph fusion
        planner consumes (graph/fusion.py): the profile's dispatch
        floor (fitted above, us per dispatch) and the measured compile
        census cost per executable variant, amortized over the
        expected dispatch count."""
        census_s = []
        for e in self.grid:
            cc = e.get("compile_census") or {}
            v, t = cc.get("variants"), cc.get("compile_s")
            if v and t is not None and v > 0:
                census_s.append(float(t) / float(v))
        per_variant_s = (sum(census_s) / len(census_s)) if census_s else 0.0
        return {
            "dispatch_floor_us": self._floor * 1e6,
            "compile_cost_s": per_variant_s,
            "expected_dispatches": int(expected_dispatches),
        }


def build_profile(
    model_family: str,
    grid: Sequence[Dict[str, Any]],
    mesh_shape: Optional[Dict[str, int]] = None,
    created: Optional[str] = None,
) -> Dict[str, Any]:
    """Assemble + validate a profile dict from sweep measurements."""
    return validate_profile({
        "v": PROFILE_VERSION,
        "model_family": str(model_family),
        "mesh_shape": dict(mesh_shape) if mesh_shape else None,
        "created": created,
        "grid": list(grid),
    })
