"""Generated wire-contract bindings (a copy of ``seldon_core_tpu/proto``).

``prediction_pb2`` is protoc's output for ``seldon_core_tpu/protos/
prediction.proto``: the same ``seldontpu`` messages, so both packages
speak one wire contract. Importing it needs the protobuf runtime; the
port's REST JSON path never does (``payload`` loads it lazily).
"""

from . import prediction_pb2  # noqa: F401
from . import services  # noqa: F401

__all__ = ["prediction_pb2", "services"]
