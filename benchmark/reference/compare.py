"""The numbers that decide ``correct``: how far the port's outputs lie from
the reference's. Each channel's numbers are over its median magnitude
``m = median |V|`` of the reference's table.

* ``value_err``: the largest gap ``g`` between the port's value table and
  the reference's, read as ``g / (g + m)``: ``g / m`` for small gaps, and
  1 for a table that is not finite (the bfloat16 control's at the
  pos-att size), so that every table reads a number.
* ``policy_gap``: the largest amount by which the action the port chose
  costs more, in the reference's action values of the same sweep, than
  the reference's best, over ``m``. An exact tie costs 0, so two
  first-minimum rules that break near-ties apart do not count.
* ``sweeps_diff``: sweeps the port ran that the reference did not, or the
  other way round (the stop rule), summed over the channels.
* flights: ``start_err`` (the first state against the fleet's starts,
  exactly), ``step_err`` (each stage against one float64 RK4 stage from
  the port's own state and forces, per state component over that
  component's largest magnitude in the fleet), ``drift_err`` (every state
  against the float64 flight of the same forces from the same starts,
  :func:`.flight.replay`, alike) and ``flight_policy_gap``
  (the forces flown, as an action of each channel's table, at the cell
  the state looks up, against the reference's best there, over ``m``; a
  query within ``amb`` of a cell's midpoint may take either cell).

Where the reference cannot fix a cell's value to float32 precision
itself, nothing a float32 program computes there can be held to it: with
``sound`` (:func:`sound_cells`: the cells where the reference's float32
and float64 solves agree, in the channels where they agree at the median
cell), the other cells are left out of the value and policy numbers. A
channel with no sound cell is held only to what any sound solve gives:
every value finite and every action one of its own.
"""

from __future__ import annotations

import itertools
import sys

import torch

from . import flight

__all__ = ["sound_cells", "solve_numbers", "flight_numbers"]

# an unreadable number (NaN, a force outside the table): the largest float,
# which fails every limit and stays valid JSON
INF = sys.float_info.max


def _finite_max(t: torch.Tensor) -> float:
    t = torch.nan_to_num(t.double(), nan=INF, posinf=INF)
    return float(t.max()) if t.numel() else 0.0


def sound_cells(v64, v32, tol: float):
    """``(C, NW, NE)``: the cells where the float32 solve lies within
    ``tol`` of each channel's median magnitude ``m`` of the float64 one,
    in the channels where the two part by at most ``tol * m`` at the
    median cell; none of a channel whose float32 solves scatter."""
    m = v64.double().abs().flatten(1).median(1).values
    gap = (v32.double() - v64.double()).abs()
    ok = gap <= tol * m[:, None, None]
    fixed = gap.flatten(1).median(1).values <= tol * m
    return ok & fixed[:, None, None]


def _scale(sol, c) -> float:
    return float(sol.values[c].double().abs().median())


def solve_numbers(values, argmin, sol, n_actions, sweeps=None,
                  sound=None) -> dict:
    """``values``/``argmin``: the port's ``(C, NW, NE)`` tables in the
    reference's layout; ``sol``: the reference's :class:`~.dp.Solution`;
    ``n_actions``: each channel's action count; ``sweeps``: the port's
    sweeps per channel (compared when given); ``sound``: the cells to
    compare (all when None)."""
    value_err = policy_gap = 0.0
    for c, n_a in enumerate(n_actions):
        keep = None if sound is None else sound[c]
        if keep is not None and not bool(keep.any()):
            a = argmin[c].long()
            if not bool(torch.isfinite(values[c]).all()):
                value_err = 1.0
            if bool(((a < 0) | (a >= n_a)).any()):
                policy_gap = INF
            continue
        scale = _scale(sol, c)
        vp = values[c].to(sol.values.device).double()
        err = (vp - sol.values[c].double()).abs()
        a = argmin[c].to(sol.values.device).long()
        bad = (a < 0) | (a >= n_a)
        q = sol.q[c].double().gather(1, a.clamp(0, n_a - 1)[:, None])[:, 0]
        gap = torch.where(bad, INF, q - sol.q_min[c].double())
        if keep is not None:
            err, gap = err[keep], gap[keep]
        g = _finite_max(err)
        value_err = max(value_err, g / (g + scale) if g < INF else 1.0)
        policy_gap = max(policy_gap, _finite_max(gap) / scale)
    out = {"value_err": value_err, "policy_gap": policy_gap}
    if sweeps is not None:
        out["sweeps_diff"] = float(sum(abs(int(a) - int(b)) for a, b
                                       in zip(sweeps, sol.sweeps)))
    return out


def _nearest(axis: torch.Tensor, q: torch.Tensor, amb: float):
    """Nearest grid index (a tie to the lower) and the other candidate when
    ``q`` lies within ``amb`` of the two points' midpoint, else the same."""
    n = axis.numel()
    lo = (torch.searchsorted(axis, q.contiguous(), right=True) - 1) \
        .clamp(0, n - 2)
    d_lo = q - axis[lo]
    d_hi = axis[lo + 1] - q
    near = lo + (d_lo > d_hi).long()
    other = torch.where((d_lo - d_hi).abs() <= amb * (axis[lo + 1] - axis[lo]),
                        2 * lo + 1 - near, near)
    return near, other


def flight_numbers(cfg: dict, X, F, x0s, sol, axes, forces, *, sound=None,
                   amb: float = 1e-4, block: int = 32) -> dict:
    """``X (B, N, 13)``, ``F (B, N-1, 12)``: the port's fleet; ``x0s``: the
    starts it was given; ``sol``: the reference's solve (channels x, y, z
    first); ``axes``/``forces``: each channel's (x, v, theta, omega) axes
    and force table; ``sound``: as in :func:`solve_numbers` (an unsound
    cell costs nothing)."""
    dev = sol.values.device
    X = X.to(dev)
    F = F.to(dev)
    start_err = _finite_max((X[:, 0].double() - torch.as_tensor(
        x0s, device=dev).double()).abs())
    n_st = X.shape[1] - 1
    t0 = torch.arange(n_st, dtype=torch.float64, device=dev) * cfg["h"]
    errs, scale = [], torch.zeros(13, dtype=torch.float64, device=dev)
    gap = 0.0
    ax = [[torch.as_tensor(a, device=dev).double() for a in ch] for ch in axes]
    tables = [torch.as_tensor(f, device=dev) for f in forces]
    for b0 in range(0, X.shape[0], block):
        y = X[b0:b0 + block].double()
        f = F[b0:b0 + block].to(torch.float32)
        per = torch.stack([f[..., [0, 1, 6, 7]], f[..., [2, 3, 8, 9]],
                           f[..., [4, 5, 10, 11]]], -2)     # (b, n, 3, 4)
        nxt = flight.rk4_step(cfg, y[:, :-1], per.double(), t0[None, :])
        errs.append((y[:, 1:] - nxt).abs().amax(dim=(0, 1)))
        scale = torch.maximum(scale, nxt.abs().amax(dim=(0, 1)))
        qs = flight.channel_queries(y[:, :-1])               # (b, n, 3, 4)
        for c in range(3):
            tab = tables[c]
            hit = (per[..., c, None, :] == tab).all(-1)       # (b, n, A)
            known = hit.any(-1)
            a = hit.int().argmax(-1)
            n_v, n_w = ax[c][1].numel(), ax[c][3].numel()
            n_t = ax[c][2].numel()
            cand = [_nearest(ax[c][k], qs[..., c, k], amb) for k in range(4)]
            best = None
            for pick in itertools.product((0, 1), repeat=4):
                ix, iv, it, iw = (cand[k][p] for k, p in enumerate(pick))
                row, lane = iv * n_w + iw, ix * n_t + it
                g = sol.q[c][row, a, lane].double() \
                    - sol.q_min[c][row, lane].double()
                if sound is not None:
                    g = torch.where(sound[c][row, lane], g, 0.0)
                best = g if best is None else torch.minimum(best, g)
            best = torch.where(known, best, INF)
            gap = max(gap, _finite_max(best) / _scale(sol, c))
    step = torch.stack(errs).amax(0) / scale.clamp_min(1e-30)
    ref = flight.replay(cfg, x0s, F)
    drift = (X.double() - ref).abs().amax(dim=(0, 1)) \
        / ref.abs().amax(dim=(0, 1)).clamp_min(1e-30)
    return {"start_err": start_err, "step_err": _finite_max(step),
            "drift_err": _finite_max(drift), "flight_policy_gap": gap}
