"""Inference-graph engine: spec, executor, units, clients, service.

Counterpart of ``seldon_core_tpu/graph/`` (reference: the Java engine —
graph bootstrap EnginePredictor.java, recursive async walk
PredictiveUnitBean.java, internal RPC InternalPredictionService.java).
"""

from .spec import PredictiveUnit, PredictorSpec, UnitType, GraphSpecError  # noqa: F401
from .executor import GraphExecutor  # noqa: F401
