"""The device an entry point runs on."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there.

    The models' entry points default to ``device="cuda"``: without a card
    they raise here rather than carry on on the CPU, which a caller asks
    for with ``device="cpu"``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but no CUDA device is "
            "available (torch.cuda.is_available() is false); pass "
            "device='cpu' to run on the CPU")
    return device
