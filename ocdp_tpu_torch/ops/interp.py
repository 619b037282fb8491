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

Rollouts read their policies through MATLAB ``'nearest'`` lookups:
:func:`nearest_eval` (searchsorted) and its affine twin
:func:`nearest_cell_index` over :class:`AffineAxes`, for the piecewise-uniform
axes every reference grid has.

Plans hold one ``(lo, frac)`` pair per state axis as broadcast-shaped tensors
on the plan's device. ``lo`` is int32, as in the JAX package, and is widened
to int64 only where it indexes.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple, Sequence

import numpy as np
import torch

__all__ = [
    "axis_locate",
    "AffineAxes",
    "affine_axes",
    "nearest_cell_index",
    "InterpPlan",
    "PlanShape",
    "build_plan",
    "interp_apply",
    "interp_eval",
    "nearest_eval",
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


@dataclasses.dataclass(frozen=True)
class PlanShape:
    """Shape-only stand-in for a plan (``ocdp_tpu/ops/interp.py:99``).

    Engines driven by an explicit ``backup`` read the plan only for
    ``grid_shape``, ``query_shape`` and ``device``; passing this instead
    lets a solve drop a multi-GB flat plan once the backup holds what it
    needs.
    """

    grid_shape: tuple
    query_shape: tuple
    device: torch.device

    @property
    def ndim(self) -> int:
        return len(self.grid_shape)

    @classmethod
    def of(cls, plan) -> "PlanShape":
        return cls(tuple(plan.grid_shape), tuple(plan.query_shape),
                   plan.device)


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


def nearest_eval(values: torch.Tensor, axes: Sequence[np.ndarray], points,
                 dtype=torch.float32) -> torch.Tensor:
    """Nearest-neighbor table lookup, MATLAB ``'nearest'`` interpolant parity.

    The reference wraps its policies in 'nearest' griddedInterpolants for
    rollout (Solver_pos_att.m:851-861). Outside the grid the nearest edge
    point is used. A query exactly halfway between two grid points snaps to
    the LOWER neighbor (strict ``>`` toward the upper), the rule the JAX
    package pins. ``points``: per-axis coordinates (broadcastable), moved to
    the device of ``values``.
    """
    dev = values.device
    idx = []
    for ax, q in zip(axes, points):
        q = torch.as_tensor(q, dtype=dtype).to(dev)
        g = torch.as_tensor(np.asarray(ax), dtype=dtype, device=dev)
        lo = torch.searchsorted(g, q.reshape(-1).contiguous(), right=True) - 1
        lo = lo.clamp_(0, g.shape[0] - 2).reshape(q.shape)
        pick_hi = (q - g[lo]) > (g[lo + 1] - q)
        idx.append(torch.where(pick_hi, lo + 1, lo))
    shape = tuple(int(np.shape(a)[0]) for a in axes)
    strides = np.ones(len(axes), dtype=np.int64)
    for k in range(len(axes) - 2, -1, -1):
        strides[k] = strides[k + 1] * shape[k + 1]
    lin = idx[0] * int(strides[0])
    for k in range(1, len(axes)):
        lin = lin + idx[k] * int(strides[k])
    return values.reshape(-1)[lin]


class AffineAxes(NamedTuple):
    """Arithmetic locate metadata for piecewise-uniform axes.

    Every reference grid is ``linspace`` (one uniform piece) or
    ``sym_linspace`` (two uniform pieces meeting at zero); on such axes the
    ``searchsorted`` of :func:`nearest_eval` is replaceable by a two-piece
    affine ``floor((q - lo) / dx)``. Fields are tensors over a trailing
    axis-index dimension K (optionally with leading batch dims, e.g. one row
    per channel):

    * ``a0``/``brk``: first grid point and the piece breakpoint value,
    * ``d_left``/``d_right``: uniform spacing of each piece,
    * ``z``: float index where the right piece starts (0 for uniform axes),
    * ``n``: float point count (for the cell clip),
    * ``axmat``: the axis values padded to a common length; the midpoint
      comparison uses the true grid values, so the lower-snap tie rule of
      :func:`nearest_eval` holds exactly.
    """

    a0: torch.Tensor
    brk: torch.Tensor
    d_left: torch.Tensor
    d_right: torch.Tensor
    z: torch.Tensor
    n: torch.Tensor
    axmat: torch.Tensor


# largest deviation of a grid point from its piece's affine fit, in units
# of that piece's spacing (the adjacent-spacing test's rtol)
_AFFINE_RTOL = 1e-4


def affine_axes(axes: Sequence[np.ndarray], *, device,
                dtype=torch.float32) -> AffineAxes:
    """Build :class:`AffineAxes` for axes with at most two uniform pieces.

    Raises ``ValueError`` for an axis that is not piecewise-uniform with a
    single breakpoint: adjacent spacings that change at more than one
    point, or any grid point farther than ``1e-4`` of its piece's spacing
    from the piece's affine fit. The second test catches an axis whose
    spacing drifts slowly, which passes the adjacent-spacing test and would
    make the affine locate pick wrong cells.
    """
    a0, brk, dl, dr, z, n, mats = [], [], [], [], [], [], []
    max_n = max(np.asarray(a).size for a in axes)
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    for ax in axes:
        a = np.asarray(ax, np.float64)
        if a.size < 2:
            raise ValueError("axis needs >= 2 points")
        d = np.diff(a)
        changes = np.nonzero(~np.isclose(d[1:], d[:-1],
                                         rtol=_AFFINE_RTOL))[0]
        if changes.size == 0:
            zi = 0
            d_l = d_r = float(d.mean())
        elif changes.size == 1:
            zi = int(changes[0]) + 1          # cell zi-1 is the last left cell
            d_l = float(d[:zi].mean())
            d_r = float(d[zi:].mean())
        else:
            raise ValueError(
                "axis is not piecewise-uniform with <= 2 pieces; use "
                "nearest_eval instead")
        i = np.arange(a.size, dtype=np.float64)
        fit = np.where(i <= zi, a[0] + i * d_l, a[zi] + (i - zi) * d_r)
        step = np.where(i <= zi, d_l, d_r)
        dev = np.abs(a - fit) / step
        if dev.max() > _AFFINE_RTOL:
            raise ValueError(
                f"axis drifts {dev.max():.3g} spacings from its piecewise-"
                f"affine fit at point {int(dev.argmax())}; use nearest_eval "
                "instead")
        a0.append(a[0])
        brk.append(a[zi])
        dl.append(d_l)
        dr.append(d_r)
        z.append(float(zi))
        n.append(float(a.size))
        mats.append(np.pad(a.astype(np_dtype), (0, max_n - a.size),
                           mode="edge"))

    def cast(v):
        return torch.as_tensor(np.asarray(v, np_dtype), device=device)

    return AffineAxes(cast(a0), cast(brk), cast(dl), cast(dr), cast(z),
                      cast(n), cast(np.stack(mats)))


def nearest_cell_index(aff: AffineAxes, q: torch.Tensor) -> torch.Tensor:
    """Per-axis nearest grid indices (int32) for coordinates ``q[..., K]``.

    :func:`nearest_eval`'s index math (same edge clamp, same midpoint
    comparison against the true grid values) with the ``searchsorted``
    replaced by the two-piece affine locate. A NaN coordinate yields some
    in-range index, never an out-of-range read.
    """
    lo_f = torch.where(
        q < aff.brk,
        torch.floor((q - aff.a0) / aff.d_left),
        aff.z + torch.floor((q - aff.brk) / aff.d_right))
    lo = torch.clamp(lo_f, min=torch.zeros_like(aff.n), max=aff.n - 2.0)
    # the int clamp bounds what a NaN converts to
    lo = torch.minimum(lo.to(torch.int32).clamp_(min=0),
                       (aff.n - 2.0).to(torch.int32))
    max_n = aff.axmat.shape[-1]
    row_base = (torch.arange(aff.axmat.numel() // max_n, dtype=torch.int32,
                             device=q.device)
                .reshape(aff.axmat.shape[:-1]) * max_n)
    flat = aff.axmat.reshape(-1)
    g_lo = flat[(row_base + lo).long()]
    g_hi = flat[(row_base + lo + 1).long()]
    pick_hi = (q - g_lo) > (g_hi - q)
    return lo + pick_hi.to(torch.int32)
