"""Device resolution for the port's entry points.

Every entry point takes ``device="cuda"`` by default and runs there. On a
machine without CUDA that default raises instead of dropping quietly to
the CPU: a CPU run must be asked for (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (a string or ``torch.device``) as a ``torch.device``;
    raises ``RuntimeError`` when it names CUDA and CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; use 'cuda' or 'cpu'")
    return dev
