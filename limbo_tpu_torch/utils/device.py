"""Device resolution for the port's entry points.

The port runs on the card: every constructor and entry point takes a
``device`` argument that defaults to ``"cuda"``.  Asking for CUDA on a host
without a card is an error, never a silent fall back to the CPU; the CPU is
used only when the caller names it (as the tests do).
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` (str or torch.device) -> torch.device, raising when it
    names CUDA and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
