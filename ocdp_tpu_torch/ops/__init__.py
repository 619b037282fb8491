from .backup import BackupResult, bellman_backup
from .backup6d import Backup6D
from .band_backup2d import BandBackup2D
from .fused_backup2d import FusedBackup2D
from .interp import InterpPlan, axis_locate, build_plan, interp_apply, interp_eval
from .rowband import RowBandBackup2D, RowBandStructureError
from .rowlane import RowLaneBackup
from .stencil import StencilTaps, stencil_taps

__all__ = [
    "Backup6D",
    "BandBackup2D",
    "BackupResult",
    "bellman_backup",
    "FusedBackup2D",
    "InterpPlan",
    "axis_locate",
    "build_plan",
    "interp_apply",
    "interp_eval",
    "RowBandBackup2D",
    "RowBandStructureError",
    "RowLaneBackup",
    "StencilTaps",
    "stencil_taps",
]
