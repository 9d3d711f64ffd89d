"""Decoded tokens per decode step in the window (the batcher's stats):
how many lanes an average step did useful work for."""

from benchmark.readings import lanes_per_step as read  # noqa: F401
