"""Sweep timing hooks (counterpart of ``ocdp_tpu/profiling.py``).

The reference wraps every backup stage in ``tic``/``toc`` prints
(Dynamic_Solver.m:87,101; Solver_pos_att.m:271,278). :class:`SweepTimer`
prints the reference's per-stage line shape from the engines' callbacks.
The engines synchronize a CUDA device before each per-sweep callback, so
the times it prints are those of completed sweeps. :func:`cuda_time_ms`
times device work with CUDA events.
"""

from __future__ import annotations

import statistics
import time

import torch

__all__ = ["SweepTimer", "sweep_callback", "cuda_time_ms"]


class SweepTimer:
    """Sweeps/s + per-check error printer.

    >>> t = SweepTimer(verbose=True)
    >>> value_iteration_finite(..., on_sweep=t.on_sweep)
    >>> t.sweeps_per_s
    """

    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self.t0 = time.perf_counter()
        self.last_t = self.t0
        self.last_sweep = 0
        self.total_sweeps = 0

    def on_segment(self, sweep_index: int, values) -> None:
        """Segmented-engine callback: 'sweep %d - %f seconds - %f sweeps/s'
        per segment. It synchronizes a CUDA device first, so the time is
        that of completed sweeps."""
        if values.is_cuda:
            torch.cuda.synchronize(values.device)
        now = time.perf_counter()
        done = sweep_index - self.last_sweep
        if self.verbose and done:
            rate = done / max(now - self.last_t, 1e-9)
            print(f"sweep {sweep_index} - {now - self.last_t:.3f} seconds "
                  f"- {rate:.1f} sweeps/s")
        self.last_t = now
        self.last_sweep = sweep_index
        self.total_sweeps = sweep_index

    def on_check(self, k_s, err_f, err_u) -> None:
        """Converged-engine check callback: the reference's
        'stage %d - %f seconds - errorF %f - errorU %f' line
        (Solver_pos_att.m:278)."""
        now = time.perf_counter()
        if self.verbose:
            print(f"stage {int(k_s)} - {now - self.last_t:.6f} seconds - "
                  f"errorF {float(err_f):.6f} - errorU {float(err_u):.6f}")
        self.last_t = now

    def on_sweep(self, i) -> None:
        """Finite-engine per-sweep callback: the reference's per-stage
        'step %d - %f seconds' print (test/Dynamic_Solver.m:87,101)."""
        now = time.perf_counter()
        if self.verbose:
            print(f"step {int(i) + 1} - {now - self.last_t:.6f} seconds")
        self.last_t = now
        self.total_sweeps = int(i) + 1

    @property
    def sweeps_per_s(self) -> float:
        dt = max(self.last_t - self.t0, 1e-9)
        return self.total_sweeps / dt


def sweep_callback(verbose: bool, kind: str = "sweep"):
    """``None`` unless ``verbose``, else a fresh :class:`SweepTimer`'s
    per-sweep (``kind='sweep'``: finite engines) or per-check
    (``kind='check'``: converged engines) callback."""
    if not verbose:
        return None
    t = SweepTimer(verbose=True)
    return t.on_check if kind == "check" else t.on_sweep


def cuda_time_ms(fn, inner: int = 1, repeats: int = 10) -> float:
    """Median milliseconds per call of ``fn()`` on the current CUDA device:
    one warm-up call, then ``repeats`` timings of ``inner`` back-to-back
    calls between two CUDA events. Back-to-back calls keep a call's host
    overhead out of the device time wherever the device is the slower side.
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)
