"""Multilinear gridded interpolation with MATLAB ``griddedInterpolant`` parity.

Counterpart of ``ocdp_tpu/ops/interp.py``. The reference evaluates
``J_{k+1}(f(x,u))`` with a prebuilt linear ``griddedInterpolant``
(test/Dynamic_Solver.m:83,207). Two semantics are load-bearing:

* **linear extrapolation** outside the grid — MATLAB's default for 'linear'
  interpolants; the reference never clamps. It is reproduced by clamping the
  *cell index* to ``[0, n-2]`` while leaving the fractional weight unclamped
  (weights < 0 or > 1 extrapolate the edge cell linearly).
* evaluation on **rectilinear** (not necessarily uniform) axes.

The query points are fixed across stages (every reference problem is
time-invariant), so locating each query in the grid is done ONCE, into an
interpolation plan; the per-stage work is a gather plus a weighted sum.

Plans hold one ``(lo, frac)`` pair per state axis as broadcast-shaped tensors
on the plan's device. ``lo`` is int32, as in the JAX package, and is widened
to int64 only where it indexes.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "axis_locate",
    "InterpPlan",
    "build_plan",
    "interp_apply",
    "interp_eval",
]


def axis_locate(axis_vals, queries, dtype=torch.float32):
    """Locate queries on one strictly-ascending 1-D axis.

    Returns ``(lo, frac)``: the cell index clipped to ``[0, n-2]`` (int32)
    and the unclamped fractional position in that cell (``dtype``), both on
    the queries' device. ``frac`` outside ``[0, 1]`` encodes linear
    extrapolation, matching MATLAB ``griddedInterpolant(..., 'linear')``.
    """
    q = torch.as_tensor(queries, dtype=dtype)
    g = torch.as_tensor(np.asarray(axis_vals), dtype=dtype, device=q.device)
    n = g.shape[0]
    lo = (torch.searchsorted(g, q.reshape(-1).contiguous(), right=True) - 1)
    lo = lo.clamp_(0, n - 2).reshape(q.shape)
    frac = (q - g[lo]) / (g[lo + 1] - g[lo])
    return lo.to(torch.int32), frac


@dataclasses.dataclass(frozen=True)
class InterpPlan:
    """Precomputed interpolation stencil for a fixed set of query points.

    ``lo[k]`` / ``frac[k]`` are broadcast-compatible with the full query
    shape (typically ``(*state_shape, n_actions)``); ``grid_shape`` is the
    shape of the value table being interpolated.
    """

    lo: tuple[torch.Tensor, ...]
    frac: tuple[torch.Tensor, ...]
    grid_shape: tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.grid_shape)

    @property
    def query_shape(self) -> tuple[int, ...]:
        return tuple(torch.broadcast_shapes(*(x.shape for x in self.lo),
                                            *(x.shape for x in self.frac)))

    @property
    def device(self) -> torch.device:
        return self.lo[0].device


def build_plan(axes: Sequence[np.ndarray], queries: Sequence, dtype=torch.float32,
               edge: str = "extrapolate") -> InterpPlan:
    """Build an :class:`InterpPlan` for per-axis query coordinate tensors.

    ``queries[k]`` holds the coordinate of every query point along state axis
    ``k``; tensors may be broadcast-shaped. The plan lives on the queries'
    device.

    ``edge`` — value-table behavior for out-of-grid queries:

    * ``"extrapolate"`` (default): MATLAB ``griddedInterpolant`` parity —
      fracs outside [0,1] extrapolate the edge cell linearly, exactly as the
      reference's backups do (test/Dynamic_Solver.m:207).
    * ``"clamp"``: project out-of-grid queries onto the grid boundary (fracs
      clipped to [0,1]), so every backup is non-expansive.
    """
    if len(axes) != len(queries):
        raise ValueError(f"got {len(axes)} axes but {len(queries)} query arrays")
    if edge not in ("extrapolate", "clamp"):
        raise ValueError(f"unknown edge policy {edge!r}")
    lo, frac = [], []
    for ax, q in zip(axes, queries):
        l, f = axis_locate(ax, q, dtype=dtype)
        if edge == "clamp":
            f = f.clamp(0.0, 1.0)
        lo.append(l)
        frac.append(f)
    return InterpPlan(tuple(lo), tuple(frac),
                      tuple(int(np.asarray(a).size) for a in axes))


def interp_apply(values: torch.Tensor, plan: InterpPlan) -> torch.Tensor:
    """Evaluate the multilinear interpolant of ``values`` at the plan's queries.

    ``values`` has shape ``plan.grid_shape``; the result has the broadcast
    query shape. ``2**d`` corner gathers from the flattened table, corners in
    C order ``(0,..,0), (0,..,1), ...``; each corner's weight is the product
    of its per-axis factors taken left to right, times the corner value, and
    the corner terms are summed left to right (the order the fused kernel
    and the JAX package's oracle keep).
    """
    d = plan.ndim
    if tuple(values.shape) != tuple(plan.grid_shape):
        raise ValueError(f"values shape {tuple(values.shape)} != grid shape "
                         f"{plan.grid_shape}")
    strides = np.ones(d, dtype=np.int64)
    for k in range(d - 2, -1, -1):
        strides[k] = strides[k + 1] * plan.grid_shape[k + 1]
    flat = values.reshape(-1)

    out = None
    for corner in itertools.product((0, 1), repeat=d):
        idx = None
        w = None
        for k in range(d):
            ik = plan.lo[k] + corner[k] if corner[k] else plan.lo[k]
            term = ik * int(strides[k]) if strides[k] != 1 else ik
            idx = term if idx is None else idx + term
            fk = plan.frac[k] if corner[k] else (1.0 - plan.frac[k])
            w = fk if w is None else w * fk
        contrib = w * flat[idx.long()]
        out = contrib if out is None else out + contrib
    return out


def interp_eval(values, axes: Sequence[np.ndarray], points, dtype=torch.float32):
    """One-shot interpolation: locate + apply (for rollouts / policy lookup).

    ``points``: sequence of per-axis coordinate tensors (broadcastable), on
    the device of ``values``.
    """
    plan = build_plan(axes, points, dtype=dtype)
    return interp_apply(torch.as_tensor(values, dtype=dtype), plan)
