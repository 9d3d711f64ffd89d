"""Canonical gRPC method table for the seven component services.

The image has no ``grpc_tools``, so instead of generated ``*_pb2_grpc.py``
stubs we register handlers through ``grpc.method_handlers_generic_handler``
and build client callables with ``channel.unary_unary``. This table is the
single source of truth for method names and their request/response types,
mirroring the service contracts in ``protos/prediction.proto``
(feature parity with reference: proto/prediction.proto:94-128).
"""

from . import prediction_pb2 as pb

# service name -> {method name -> (request class, response class)}
SERVICES = {
    "Generic": {
        "TransformInput": (pb.SeldonMessage, pb.SeldonMessage),
        "TransformOutput": (pb.SeldonMessage, pb.SeldonMessage),
        "Route": (pb.SeldonMessage, pb.SeldonMessage),
        "Aggregate": (pb.SeldonMessageList, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
    "Model": {
        "Predict": (pb.SeldonMessage, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
    "Router": {
        "Route": (pb.SeldonMessage, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
    "Transformer": {
        "TransformInput": (pb.SeldonMessage, pb.SeldonMessage),
    },
    "OutputTransformer": {
        "TransformOutput": (pb.SeldonMessage, pb.SeldonMessage),
    },
    "Combiner": {
        "Aggregate": (pb.SeldonMessageList, pb.SeldonMessage),
    },
    "Seldon": {
        "Predict": (pb.SeldonMessage, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
}

# server-streaming methods (engine-level; NOT in SERVICES because the
# wrapper's generic unary handler builder iterates that table)
STREAMING = {
    "Seldon": {
        "GenerateStream": (pb.SeldonMessage, pb.SeldonMessage),
    },
}

PACKAGE = "seldontpu"


def full_service_name(service: str) -> str:
    return f"{PACKAGE}.{service}"


def method_path(service: str, method: str) -> str:
    return f"/{PACKAGE}.{service}/{method}"
