"""Kernel B.2's share of its roofline: the least time the H100 could take
for the solves' channel sweeps (FP32 operations over 67 TFLOP/s or bytes
over 3.35 TB/s, whichever is larger, counted by ``benchmark/rooflines``
from the configuration's taps), over the device time of the kernels named
below in the profiled solves."""

from benchmark.rooflines import peaks, rowlane

LAYER = "kernel B.2: ops/rowlane.py, csrc/rowlane_backup.cu"
UNIT = "%"
MOVES = "solve_s"
KERNELS = ("rowlane_tiles",)


def read(t):
    dev = sum(s for n, s in t.kernels.items() if any(k in n for k in KERNELS))
    if dev <= 0:
        return None
    bound = 0.0
    for ctx in t.context:
        bound += peaks.bound_s(*rowlane.pos_att_sweep(t.config, ctx["sweeps"]))
    return 100.0 * bound / dev
