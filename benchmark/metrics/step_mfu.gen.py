"""Model FLOPs of the work completed in the traced sub-window over the
device's busy seconds there at the bf16 peak: the whole step's share of
the chip's peak."""

from benchmark.readings import step_mfu as read  # noqa: F401
