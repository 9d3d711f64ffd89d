"""Continuous-batching generate serving of the port."""

from .continuous import BatcherDead, ContinuousBatcher, GenRequest  # noqa: F401
