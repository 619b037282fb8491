"""Kernel B.1's share of its roofline: the least time the H100 could take
for the solves' sweeps through the fused 2-D backup's affine-query mode
(FP32 operations over 67 TFLOP/s or bytes over 3.35 TB/s, whichever is
larger, counted by ``benchmark/rooflines/affine2d.py`` from the
configuration), over the device time of the ``affine_sweep`` kernels in
the profiled solves."""

from benchmark.rooflines import affine2d, peaks

LAYER = "kernel B.1: ops/fused_backup2d.py, csrc/fused_backup2d.cu"
UNIT = "%"
MOVES = "solve_s"
KERNELS = ("affine_sweep",)


def read(t):
    dev = sum(s for n, s in t.kernels.items() if any(k in n for k in KERNELS))
    if dev <= 0:
        return None
    one = peaks.bound_s(*affine2d.kirk_sweep(t.config))
    return 100.0 * one * sum(ctx["sweeps"] for ctx in t.context) / dev
