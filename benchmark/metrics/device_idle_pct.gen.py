"""Share of the traced sub-window in which nothing ran on the device."""

from benchmark.readings import device_idle_pct as read  # noqa: F401
