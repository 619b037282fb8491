"""ocdp_tpu_torch — the PyTorch + CUDA port of ``ocdp_tpu``.

Backward Bellman value iteration over discretized state x action grids, with
the same grids, interpolation plans, backups and engines as the JAX package,
on PyTorch tensors. The hot backups run as CUDA kernels written for Hopper
(``ops/fused_backup2d.py`` for Kirk, ``ops/rowlane.py`` for pos-att,
``ops/backup6d.py`` for the 6-D attitude solve; sources in ``csrc/``) on a
CUDA device and as plain PyTorch on the CPU. The models' entry points run on
the card unless the caller asks for ``device="cpu"``. This package imports
torch and numpy, never jax; the JAX package stays the reference it is
tested against.
"""

from . import convert, diagnostics, dynamics, engine, grids, io, models, utils
from .engine import (
    SolveResult,
    value_iteration_converged,
    value_iteration_finite,
    value_iteration_segmented,
)
from .grids import Grid, linspace_axis, sym_linspace_exact, sym_linspace_inclusive
from .ops.backup import BackupResult, bellman_backup
from .ops.backup6d import Backup6D
from .ops.fused_backup2d import FusedBackup2D
from .ops.rowlane import RowLaneBackup
from .ops.interp import (
    InterpPlan,
    axis_locate,
    build_plan,
    interp_apply,
    interp_eval,
)

__all__ = [
    "Grid",
    "linspace_axis",
    "sym_linspace_exact",
    "sym_linspace_inclusive",
    "InterpPlan",
    "axis_locate",
    "build_plan",
    "interp_apply",
    "interp_eval",
    "BackupResult",
    "bellman_backup",
    "Backup6D",
    "FusedBackup2D",
    "RowLaneBackup",
    "SolveResult",
    "value_iteration_finite",
    "value_iteration_converged",
    "value_iteration_segmented",
]
