from .backup import BackupResult, bellman_backup
from .backup6d import Backup6D
from .fused_backup2d import FusedBackup2D
from .interp import InterpPlan, axis_locate, build_plan, interp_apply, interp_eval
from .rowlane import RowLaneBackup

__all__ = [
    "Backup6D",
    "BackupResult",
    "bellman_backup",
    "FusedBackup2D",
    "InterpPlan",
    "axis_locate",
    "build_plan",
    "interp_apply",
    "interp_eval",
    "RowLaneBackup",
]
