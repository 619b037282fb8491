"""Kernel B.3's share of its roofline: the least time the H100 could take
for the solves' 6-D sweeps (FP32 operations over 67 TFLOP/s or bytes over
3.35 TB/s, whichever is larger, counted by ``benchmark/rooflines`` from
the configuration's taps), over the device time of the kernels named below
in the profiled solves."""

from benchmark.rooflines import backup6d, peaks

LAYER = "kernel B.3: ops/backup6d.py, csrc/backup6d.cu"
UNIT = "%"
MOVES = "solve_s"
KERNELS = ("backup6d_sweep", "backup6d_wide")


def read(t):
    dev = sum(s for n, s in t.kernels.items() if any(k in n for k in KERNELS))
    if dev <= 0:
        return None
    one = peaks.bound_s(*backup6d.attitude_sweep(t.config))
    return 100.0 * one * sum(ctx["sweeps"] for ctx in t.context) / dev
