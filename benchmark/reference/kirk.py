"""Kirk's ch.3 regulator by backward dynamic programming, from the
configuration alone: the upstream project's ``test/Dynamic_Solver.m``,
its constructor's constants (:47-64), ``run`` (:66-105), ``a_D_M``
(:184-188), ``g_D`` (:196-200) and the backup ``J_state_M`` (:202-220).

State ``(x1, x2)`` on a ``dx x dx`` grid over ``[x_min, x_max]^2``,
``du`` controls over ``[u_min, u_max]``. ``N - 1`` sweeps from
``J_N = 0``; each one

1. forms the next states ``x' = A x + B u`` over the (x1, x2, u) grid,
   each component ``a_i1 x1 + a_i2 x2 + b_i u`` (``a_D_M``);
2. reads ``J_{k+1}`` there by bilinear interpolation, with linear
   extrapolation past the grid's edge (``griddedInterpolant``'s
   'linear' method and its default extrapolation): the cell clipped to
   the grid, the fraction in it not;
3. adds the stage cost ``(Q1 x1^2 + Q2 x2^2) + R u^2`` (``g_D``);
4. takes the least value over the controls and the first control that
   reaches it (``min(..., [], 3)``).

Sweep ``k`` (1-based) is the source's stage ``N - k``: it writes
``J_star(:, :, N - k)`` and ``u_star(:, :, N - k)``.

Departures from the source:

* precision: the source computes in single. Here every sweep is
  computed in ``dtype`` (float64 for the check) from the single grids
  (``single(linspace(...))``, :69), and the table, the interpolation
  fractions and the two cost parts are kept in ``store`` between sweeps
  (the control keeps them in bfloat16 and computes in float32);
* the controls are taken in blocks of at most ``BLOCK_CELLS``
  evaluations, so that a sweep fits: the least over the blocks in order,
  an earlier block keeping a tie, which is the source's first minimum
  over the whole control axis;
* the next states are formed once, outside the stage loop, as the source
  forms them (:81), but kept as the located cells and fractions;
* what is returned: the last sweep's table and its action values (the
  whole stage cost in them, as the source adds it before the minimum),
  every sweep's first best control as an index into the controls (the
  source's ``u_star`` holds the control's value), every sweep's table
  when asked (the source's ``J_star``) and, given a stack of policies to
  judge, each sweep's gap.

Matrix products run with TF32 off (``dp._no_tf32``), though a sweep makes
none.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from .dp import Solution, _no_tf32

__all__ = ["Reference", "grids", "solve"]

# an unreadable gap (a policy outside the controls, a stack of another
# shape): the largest float, which fails every limit and stays valid JSON
INF = sys.float_info.max
# evaluations a block of controls holds at most
BLOCK_CELLS = 2_500_000


class Reference(NamedTuple):
    """``solution``: the last sweep in :class:`~.dp.Solution`'s layout
    (one channel, rows x1 and lanes x2, ``q (1, dx, du, dx)``);
    ``policies (N - 1, dx, dx)``: each sweep's first best control, in
    sweep order; ``policy_gap``: the largest over the sweeps of the
    judged stack's extra cost over that sweep's median ``|J|``, None when
    no stack was judged; ``tables (N - 1, dx, dx)``: each sweep's table in
    sweep order, when asked, else None."""

    solution: Solution
    policies: torch.Tensor
    policy_gap: Optional[float]
    tables: Optional[torch.Tensor] = None


def grids(cfg: dict):
    """The state axis (both state components) and the controls, single as
    the source makes them."""
    x = np.linspace(cfg["x_min"], cfg["x_max"], cfg["dx"]).astype(np.float32)
    u = np.linspace(cfg["u_min"], cfg["u_max"], cfg["du"]).astype(np.float32)
    return x, u


def _locate(axis: torch.Tensor, q: torch.Tensor):
    """Cell index clipped to ``[0, n-2]`` and the unclipped fraction."""
    n = axis.shape[0]
    lo = torch.searchsorted(axis, q.reshape(-1).contiguous(), right=True) - 1
    lo = lo.clamp(0, n - 2).reshape(q.shape)
    return lo, (q - axis[lo]) / (axis[lo + 1] - axis[lo])


def solve(cfg: dict, device, *, dtype=torch.float64, store=None,
          policies: Optional[torch.Tensor] = None,
          tables: bool = False) -> Reference:
    """The ``N - 1`` sweeps of ``cfg`` (a configuration's plain parameters)
    on ``device``. ``policies``: a stack ``(N - 1, dx, dx)`` of control
    indices in sweep order to judge, each sweep's choice against that
    sweep's action values; ``tables``: keep every sweep's table."""
    with _no_tf32():
        return _solve(cfg, device, dtype, store or dtype, policies, tables)


def _solve(cfg, device, dtype, store, policies, tables):
    x_np, u_np = grids(cfg)
    n, n_u, n_sweeps = cfg["dx"], cfg["du"], cfg["N"] - 1
    block = max(1, BLOCK_CELLS // (n * n))
    (a11, a12), (a21, a22) = cfg["A"]
    b1, b2 = cfg["B"]
    q1, q2 = cfg["Q"]
    x = torch.as_tensor(x_np, device=device).to(dtype)
    u = torch.as_tensor(u_np, device=device).to(dtype)
    x1, x2 = x[:, None, None], x[None, None, :]
    c_state = (q1 * x1 ** 2 + q2 * x2 ** 2).to(store)          # (dx, 1, dx)
    c_act = (cfg["R"] * u ** 2).to(store)                       # (du,)

    # each block of controls: its bounds, flat corner index, fractions
    blocks = []
    for lo_u in range(0, n_u, block):
        ub = u[lo_u:lo_u + block][None, :, None]
        lo0, f0 = _locate(x, a11 * x1 + a12 * x2 + b1 * ub)
        lo1, f1 = _locate(x, a21 * x1 + a22 * x2 + b2 * ub)
        blocks.append((lo_u, lo_u + ub.shape[1], lo0 * n + lo1,
                       f0.to(store), f1.to(store)))

    judged = policies is not None
    if judged:
        policies = policies.to(device).long()
        gap = 0.0 if tuple(policies.shape) == (n_sweeps, n, n) else INF
        if gap == 0.0 and bool(((policies < 0) | (policies >= n_u)).any()):
            gap = INF
    else:
        gap = None
    chosen = torch.zeros((n, n), dtype=dtype, device=device)
    gaps = torch.zeros(n_sweeps, dtype=torch.float64, device=device)
    out_pol = torch.empty((n_sweeps, n, n), dtype=torch.int32, device=device)
    v = torch.zeros((n, n), dtype=store, device=device)
    kept = torch.empty((n_sweeps, n, n), dtype=store, device=device) \
        if tables else None
    q_last = []
    for k in range(n_sweeps):
        last = k == n_sweeps - 1
        table = v.to(dtype).reshape(-1)
        best = arg = None
        a = policies[k] if judged and gap != INF else None
        cs = c_state.to(dtype)
        for lo_u, hi_u, idx, f0, f1 in blocks:
            f0, f1 = f0.to(dtype), f1.to(dtype)
            lower = table[idx] * (1 - f0) + table[idx + n] * f0
            upper = table[idx + 1] * (1 - f0) + table[idx + n + 1] * f0
            qb = (lower * (1 - f1) + upper * f1) \
                + (cs + c_act[lo_u:hi_u].to(dtype)[None, :, None])
            m, i = qb.min(dim=1)
            if best is None:
                best, arg = m, i
            else:
                take = m < best
                best = torch.where(take, m, best)
                arg = torch.where(take, i + lo_u, arg)
            if a is not None:
                inside = (a >= lo_u) & (a < hi_u)
                at = (a - lo_u).clamp(0, hi_u - lo_u - 1)
                chosen = torch.where(inside, qb.gather(1, at[:, None])[:, 0],
                                     chosen)
            if last:
                q_last.append(qb)
        out_pol[k] = arg
        if a is not None:
            gaps[k] = (chosen - best).max() / best.abs().median()
        v = best.to(store)
        if kept is not None:
            kept[k] = v
    if gap == 0.0:
        gap = float(torch.nan_to_num(gaps, nan=INF, posinf=INF).max())
    sol = Solution(values=v[None], argmin=out_pol[-1][None],
                   q=torch.cat(q_last, 1)[None], q_min=best[None],
                   sweeps=[n_sweeps])
    return Reference(sol, out_pol, gap, kept)
