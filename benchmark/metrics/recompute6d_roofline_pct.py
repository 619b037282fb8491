"""Kernel B.5's share of its roofline: the least time the H100 could take
for the solves' 6-D sweeps with the Euler lanes recomputed in the kernel
(FP32 operations over 67 TFLOP/s or bytes over 3.35 TB/s, whichever is
larger, counted by ``benchmark/rooflines/recompute6d.py`` from the
configuration), over the device time of the ``backup6d_sweep`` kernels
(B.5 is ``backup6d_sweep<uint8_t, true, true>``; B.3's cube body is not
counted) in the profiled solves."""

from benchmark.rooflines import peaks, recompute6d

LAYER = "kernel B.5: ops/backup6d.py, csrc/backup6d.cu"
UNIT = "%"
MOVES = "solve_s"
KERNELS = ("backup6d_sweep", "backup6d_wide")
NOT = "backup6d_sweep_cube"


def read(t):
    dev = sum(s for n, s in t.kernels.items()
              if any(k in n for k in KERNELS) and NOT not in n)
    if dev <= 0:
        return None
    one = peaks.bound_s(*recompute6d.attitude_sweep(t.config))
    return 100.0 * one * sum(ctx["sweeps"] for ctx in t.context) / dev
