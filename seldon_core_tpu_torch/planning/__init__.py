"""Autonomic serving planner: offline profile sweep -> SPF1 cost model
-> online decision table -> safe actuation (retune / scale), plus the
seeded traffic simulator that makes the closed loop a reproducible
bench scenario (docs/operate.md §"Autonomic planning").

Counterpart of ``seldon_core_tpu/planning/__init__.py``.
"""

from .artifact import (
    CONFIG_KEYS,
    CostModel,
    ProfileError,
    build_profile,
    decode_profile,
    encode_profile,
    read_profile,
    write_profile,
)
from .planner import Decision, RETUNABLE_AXES, ServingPlanner
from .profiler_sweep import measure_config, run_sweep, sweep_grid
from .trafficsim import TrafficEvent, TrafficSim, replay

__all__ = [
    "CONFIG_KEYS",
    "CostModel",
    "Decision",
    "ProfileError",
    "RETUNABLE_AXES",
    "ServingPlanner",
    "TrafficEvent",
    "TrafficSim",
    "build_profile",
    "decode_profile",
    "encode_profile",
    "measure_config",
    "read_profile",
    "replay",
    "run_sweep",
    "sweep_grid",
    "write_profile",
]
