"""Entry points for a quick check of the port: one backup step, and the
multi-rank dry run (counterpart of the JAX package's ``__graft_entry__.py``).

* :func:`entry` — one fused Bellman backup (interpolate J_{k+1} at f(x,u),
  add the stage cost, min and first-minimum argmin over the actions) on the
  Kirk ch.3 golden grid, with its example input.
* :func:`dryrun_multichip` — every multi-rank engine once, each held to its
  one-device solve (:mod:`ocdp_tpu_torch.parallel.dryrun`).
"""

from __future__ import annotations

import torch

from .models import kirk
from .parallel.dryrun import dryrun_multichip
from .utils.device import resolve_device

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    """Return ``(step, (v0,))``: ``step(values) -> (values, argmin)`` is one
    backup on ``KirkConfig.golden()`` (35 x 35 states, 100 controls) and
    ``v0`` the zero terminal table.

    The backup is :func:`kirk.affine_backup`, the one :func:`kirk.solve`
    builds (the fused backup's affine-query mode, separable stage cost):
    its CUDA kernel on a CUDA device (the default; raises without a card),
    its plain PyTorch version on ``device="cpu"``. ``step.backup`` is that
    backup.
    """
    device = resolve_device(device)
    cfg = kirk.KirkConfig.golden()
    backup = kirk.affine_backup(cfg, device)

    def step(values: torch.Tensor):
        res = backup(values)
        return res.values, res.argmin

    step.backup = backup
    v0 = torch.zeros((cfg.dx, cfg.dx), dtype=torch.float32, device=device)
    return step, (v0,)
