"""The flash kernel's share of its roofline in the traced sub-window:
the launches' least times (bf16 peak, HBM rate) over their device times."""

from benchmark.readings import flash_roofline as read  # noqa: F401
