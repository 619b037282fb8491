"""FP32 operations and bytes of one sweep of the 6-D attitude backup
(kernel B.3), as its plain version does them: per cell the lane tap and
joint lane-combo weights and the lane-interpolated rows ``A_j``; the
action phase factorized digit by digit where the torques factor (the
reference's 27 = 3^3), else a sum over the row combos per action; the
costs, the compares and the row and lane costs. Bytes: the table, the row
plan (24 B a row-action), the lane plan (24 B a cell), the costs, the
values and an int32 argmin, each once."""

from __future__ import annotations

import numpy as np

from ..reference import attitude as ref
from . import taps

__all__ = ["sweep", "attitude_structure", "attitude_sweep"]


def sweep(nw, ne, n_act, row_combos, lane_combos, w_taps, digits,
          n_act_cost, argmin_bytes: int = 4):
    """``(flops, bytes)`` of one sweep over the whole table."""
    n_row, n_lane = len(row_combos), len(lane_combos)
    e_taps = [len({c[k] for c in lane_combos}) for k in range(3)]
    per_cell = (2 * sum(e_taps) + 2 * n_lane + n_row * (2 * n_lane - 1))
    per_row = n_act * 2 * sum(len(t) for t in w_taps)
    if digits:
        m = digits
        combos = set(row_combos)
        pairs = sorted({c[:2] for c in combos})
        t0s = sorted({c[0] for c in combos})
        per_cell += sum(m * (2 * sum((p + (t,)) in combos
                                     for t in w_taps[2]) - 1) for p in pairs)
        per_cell += sum(m * m * (2 * sum((t0, t) in pairs
                                         for t in w_taps[1]) - 1)
                        for t0 in t0s)
        per_cell += n_act * (2 * len(t0s) - 1)
    else:
        per_cell += n_act * (2 * n_row - 1)
        per_row += n_act * 2 * n_row
    per_cell += n_act_cost + (n_act - 1) + 3
    nbytes = (4 * nw * ne + 24 * nw * n_act + 24 * nw * ne + 4 * (nw + ne)
              + (4 + argmin_bytes) * nw * ne)
    return float(per_cell * nw * ne + per_row * nw), float(nbytes)


def attitude_structure(cfg: dict):
    """``(nw, ne, n_act, row_combos, lane_combos, w_taps, digits,
    n_act_cost)`` of the 6-D problem, derived from the configuration."""
    rows, lanes, _, _, u = ref.located(cfg, "cpu")
    n, m = cfg["n_mesh_w"], cfg["n_mesh_q"]
    n_act = u.shape[0]
    w_off, w_frac = [], []
    for k, (lo, fr) in enumerate(rows):
        own = np.arange(n).reshape([-1 if i == k else 1 for i in range(4)])
        w_off.append((lo.numpy() - own).reshape(n ** 3, n_act))
        w_frac.append(fr.numpy().reshape(n ** 3, n_act))
    w_taps, row_combos = taps.live_sets(w_off, w_frac)
    e_off, e_frac = [], []
    for k, (lo, fr) in enumerate(lanes):
        own = np.arange(m).reshape([-1 if i == k else 1 for i in range(3)])
        e_off.append(lo.numpy().reshape(n ** 3, m, m, m) - own[None])
        e_frac.append(fr.numpy().reshape(n ** 3, m, m, m))
    _, lane_combos = taps.live_sets(e_off, e_frac)
    costs = sum(cfg["R"][k] * u[:, k].double() ** 2 for k in range(3))
    return (n ** 3, m ** 3, n_act, row_combos, lane_combos, w_taps,
            taps.action_digits(w_off, w_frac), int((costs != 0).sum()))


def attitude_sweep(cfg: dict):
    return sweep(*attitude_structure(cfg))
