"""The device an entry point runs on."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "resolve_impl"]


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


def resolve_impl(impl: str, device: torch.device, impls, *,
                 cpu_auto: str) -> str:
    """A solve's ``impl`` on ``device``: one of ``impls``; ``'auto'`` is
    ``'kernel'`` on a CUDA device and ``cpu_auto`` elsewhere; ``'kernel'``
    needs a CUDA device. Raises ``ValueError`` otherwise."""
    if impl not in impls:
        raise ValueError(f"unknown impl {impl!r}; use one of {impls}")
    if impl == "auto":
        return "kernel" if device.type == "cuda" else cpu_auto
    if impl == "kernel" and device.type != "cuda":
        raise ValueError(f"impl='kernel' needs a CUDA device, got {device}")
    return impl
