"""Row-band Bellman backup for separable 2-D problems (attitude axes).

Counterpart of ``ocdp_tpu/ops/rowband.py``, in plain PyTorch with the same
slices and concatenations. It is the JAX package's auto path for the
simplified attitude solve (not a Pallas kernel); here it is an impl beside
the banded kernel, timed against it on the card.

The simplified attitude problem (attitude-control/Solver_attitude.m:236-247)
has a query geometry that factors into row bands:

* axis 0 (omega): ``w' = w + h*u/J`` on a uniform axis, so the cell index is
  ``clip(row + s_a, 0, N1-2)`` with a per-action integer shift ``s_a``: per
  action the interpolation is two shifted row slabs (plus replicated edge
  rows where the clamp saturates);
* axis 1 (theta): ``t' = t + h*w*c``, whose lane shift ``d_r`` depends only
  on the row, so rows fall into a few contiguous bands, each a pair of
  shifted lane slices.

It interpolates with the plan's own fracs, associated ``(1-f)*lo + f*hi``
per axis, then takes the first minimum over actions. Results match the
other backups to float32 rounding (an argmin may flip at an exact tie).

Raises :class:`RowBandStructureError` when the plan does not have this
geometry.
"""

from __future__ import annotations

import numpy as np
import torch

from .backup import BackupResult
from .interp import InterpPlan

__all__ = ["RowBandBackup2D", "RowBandStructureError", "build_rowband_backup"]


class RowBandStructureError(ValueError):
    """The plan's query geometry doesn't factor into row bands."""


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class RowBandBackup2D:
    """Callable backup op ``values -> BackupResult`` (see module docstring),
    on the plan's device."""

    def __init__(self, plan: InterpPlan, stage_cost):
        if plan.ndim != 2:
            raise RowBandStructureError("row-band backup is 2-D only")
        N1, N2 = plan.grid_shape
        qshape = plan.query_shape
        if qshape[:2] != (N1, N2):
            raise RowBandStructureError(
                f"query shape {qshape} doesn't cover the {plan.grid_shape} grid")
        A = qshape[-1]

        lo0, fr0 = _numpy(plan.lo[0]), _numpy(plan.frac[0])
        lo1, fr1 = _numpy(plan.lo[1]), _numpy(plan.frac[1])
        # axis-0 queries independent of the lane axis, axis-1 queries
        # independent of the action axis
        if lo0.shape[1] != 1 or fr0.shape[1] != 1:
            raise RowBandStructureError(
                f"axis-0 queries vary along axis 1 (lo shape {lo0.shape})")
        if lo1.shape[-1] != 1 or fr1.shape[-1] != 1:
            raise RowBandStructureError(
                f"axis-1 queries vary with the action (lo shape {lo1.shape})")
        lo0 = np.broadcast_to(lo0.reshape(lo0.shape[0], -1), (N1, A))
        fr0 = np.broadcast_to(fr0.reshape(fr0.shape[0], -1), (N1, A))
        lo1 = np.broadcast_to(lo1.reshape(-1, N2), (N1, N2))
        fr1 = np.broadcast_to(fr1.reshape(-1, N2), (N1, N2))

        rows = np.arange(N1)
        mid = N1 // 2
        self.shifts = []
        for a in range(A):
            s_a = int(lo0[mid, a]) - mid
            if not np.array_equal(lo0[:, a], np.clip(rows + s_a, 0, N1 - 2)):
                raise RowBandStructureError(
                    f"action {a}: axis-0 indices are not a clamped "
                    f"constant shift")
            self.shifts.append(s_a)

        lanes = np.arange(N2)
        # per-row shift = modal lo1 - lane (robust to a clamped middle
        # lane), then the clamped-shift identity must hold exactly: float32
        # rounding at cell boundaries can break it on coarse grids
        diff = lo1 - lanes[None, :]
        d = np.empty(N1, np.int64)
        for r in range(N1):
            vals, counts = np.unique(diff[r], return_counts=True)
            d[r] = vals[np.argmax(counts)]
        if not np.array_equal(lo1, np.clip(lanes[None, :] + d[:, None],
                                           0, N2 - 2)):
            raise RowBandStructureError(
                "axis-1 indices are not a clamped per-row shift")
        # contiguous runs of constant lane shift
        cut = np.flatnonzero(np.diff(d)) + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [N1]])
        self.bands = [(int(r0), int(r1), int(d[r0]))
                      for r0, r1 in zip(starts, ends)]
        self.pad_lo = max(0, -int(d.min()))
        self.pad_hi = max(0, int(d.max()))

        dev = plan.device
        self.grid_shape = (N1, N2)
        self.n_actions = A
        self.fr0 = torch.tensor(np.ascontiguousarray(fr0), dtype=torch.float32,
                                device=dev)                   # (N1, A)
        self.fr1 = torch.tensor(np.ascontiguousarray(fr1), dtype=torch.float32,
                                device=dev)                   # (N1, N2)

        terms = (list(stage_cost) if isinstance(stage_cost, (tuple, list))
                 else [stage_cost])
        cost = np.zeros(qshape, np.float32)
        for t in terms:
            cost = cost + _numpy(t).astype(np.float32)
        self.cost = torch.tensor(np.ascontiguousarray(np.moveaxis(cost, -1, 0)),
                                 device=dev)                  # (A, N1, N2)

    def _axis0(self, v, a):
        """Per-action omega interpolation: (N1, N2) -> (N1, N2)."""
        N1, _ = self.grid_shape
        s = self.shifts[a]
        f = self.fr0[:, a][:, None]                           # (N1, 1)
        k0 = max(0, -s)              # rows clamped at the low edge
        k1 = max(0, s + 1)           # rows clamped at the high edge
        parts = []
        if k0:
            parts.append((1.0 - f[:k0]) * v[0:1] + f[:k0] * v[1:2])
        m0, m1 = k0, N1 - k1         # interior rows: lo = row + s unclamped
        if m1 > m0:
            parts.append((1.0 - f[m0:m1]) * v[m0 + s:m1 + s]
                         + f[m0:m1] * v[m0 + s + 1:m1 + s + 1])
        if k1:
            parts.append((1.0 - f[m1:]) * v[N1 - 2:N1 - 1]
                         + f[m1:] * v[N1 - 1:N1])
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    def _axis1(self, w):
        """Theta interpolation of an omega-interpolated table. Clamped edge
        lanes are served exactly by edge-replicated column padding: the lo
        corner reads ``w[:, clip(l+t, 0, N2-2)]`` and the hi corner
        ``w[:, clip(l+t+1, 1, N2-1)]``, so two padded views turn every
        clamped read into the interior's shifted slice."""
        N1, N2 = self.grid_shape
        PL, PH = self.pad_lo, self.pad_hi

        def padded(first_col, body, last_col):
            parts = []
            if PL:
                parts.append(first_col.expand(N1, PL))
            parts.append(body)
            parts.append(last_col.expand(N1, PH + 1))
            return torch.cat(parts, dim=1)            # (N1, N2 + PL + PH)

        wp_lo = padded(w[:, 0:1], w[:, 0:N2 - 1], w[:, N2 - 2:N2 - 1])
        wp_hi = padded(w[:, 1:2], w[:, 1:N2], w[:, N2 - 1:N2])
        parts = []
        for r0, r1, t in self.bands:
            sl = wp_lo[r0:r1, PL + t:PL + t + N2]
            sh = wp_hi[r0:r1, PL + t:PL + t + N2]
            f = self.fr1[r0:r1]
            parts.append((1.0 - f) * sl + f * sh)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    def __call__(self, values: torch.Tensor) -> BackupResult:
        best_v = best_a = None
        for a in range(self.n_actions):
            total = self._axis1(self._axis0(values, a)) + self.cost[a]
            if best_v is None:
                best_v = total
                best_a = torch.zeros(self.grid_shape, dtype=torch.int32,
                                     device=values.device)
            else:
                better = total < best_v  # strict: first minimum wins ties
                best_v = torch.where(better, total, best_v)
                best_a = torch.where(better, a, best_a)
        return BackupResult(best_v, best_a)


def build_rowband_backup(plan: InterpPlan, stage_cost) -> RowBandBackup2D:
    return RowBandBackup2D(plan, stage_cost)
