"""Device policy for the port's entry points.

Every entry point that places tensors (topology construction and the
generators, ``init_state``, the engines, the bridge) takes ``device``.
``None`` means the card: the port is written for it, and a run that
quietly lands on the CPU would report CPU behaviour as the system's. So
``None`` without CUDA raises; the CPU is used only when a caller names it
(as the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no card is visible); anything
    else is taken as given. A CUDA device without an index gets the
    current one, so it compares equal to its tensors' ``.device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available and no device was given; "
                "pass device='cpu' to run on the CPU explicitly")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
