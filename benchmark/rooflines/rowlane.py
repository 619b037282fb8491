"""FP32 operations and bytes of one sweep of a pos-att channel through the
row/lane backup (kernel B.2), as its plain version does them: per cell the
lane tap weights, one lerp pass a lane axis for each live row combo, the
sum over the row combos for each action, the action costs, the compares
and the row and lane costs; per row the joint row weights. Bytes: each
input read once (the table, the row and lane plans, the costs) and the
values and argmin written once."""

from __future__ import annotations

import numpy as np

from ..reference import pos_att as ref
from . import taps

__all__ = ["sweep", "pos_att_channel", "pos_att_sweep"]


def sweep(row_shape, lane_shape, n_act, row_combos, lane_taps, n_act_cost,
          rowact: bool = False, rowlane: bool = False):
    """``(flops, bytes)`` of one sweep of one channel."""
    nw, ne = int(np.prod(row_shape)), int(np.prod(lane_shape))
    nc, nr = len(row_combos), len(row_shape)
    n_taps = [len(t) for t in lane_taps]
    per_cell = (2 * sum(n_taps)
                + nc * sum(2 * t - 1 for t in n_taps)
                + n_act * (2 * nc - 1)
                + n_act_cost
                + (n_act if rowact else 0)
                + (n_act - 1)
                + 3)
    w_taps = [len({c[k] for c in row_combos}) for k in range(nr)]
    per_row = n_act * (2 * sum(w_taps) + (nr - 1) * nc)
    nbytes = (4 * nw * ne + 8 * nr * nw * n_act
              + sum(8 * nw * n for n in lane_shape) + 4 * (nw + ne)
              + (4 * nw * n_act if rowact else 0)
              + (4 * nw * ne if rowlane else 0)
              + 8 * nw * ne)
    return float(per_cell * nw * ne + per_row * nw), float(nbytes)


def pos_att_channel(cfg: dict, axis: int, failure: bool):
    """The tap structure of one channel, derived from the configuration:
    ``(row_shape, lane_shape, n_act, row_combos, lane_taps, n_act_cost)``
    with rows (v, omega) and lanes (x, theta)."""
    (lv, lw), (lx, lt), (s_x, s_v, s_t, s_w), f = ref.located(
        cfg, axis, failure, "cpu")
    nv, nw, nx, nt = (a.numel() for a in (s_v, s_w, s_x, s_t))
    n_act = f.shape[0]

    def off(lo_fr, own_axis, shape):
        lo, fr = (t.numpy() for t in lo_fr)
        own = np.arange(lo.shape[own_axis]).reshape(
            [-1 if i == own_axis else 1 for i in range(lo.ndim)])
        return (lo - own).reshape(shape), fr.reshape(shape)

    rv = off(lv, 0, (nv, 1, n_act))
    rw = off(lw, 0, (1, nw, n_act))
    _, row_combos = taps.live_sets((rv[0], rw[0]), (rv[1], rw[1]))
    ex = off(lx, 1, (nv, 1, nx, 1))
    et = off(lt, 1, (1, nw, 1, nt))
    lane_taps, _ = taps.live_sets((ex[0], et[0]), (ex[1], et[1]))
    costs = cfg["R"] * (f.double() ** 2).sum(1)
    return ((nv, nw), (nx, nt), n_act, row_combos, lane_taps,
            int((costs != 0).sum()))


def pos_att_sweep(cfg: dict, sweeps: dict):
    """``(flops, bytes)`` of the channel sweeps ``sweeps`` (channel name
    -> sweeps run) of a pos-att solve."""
    flops = nbytes = 0.0
    for name, axis, failure in ref.CHANNELS:
        if sweeps.get(name):
            f, b = sweep(*pos_att_channel(cfg, axis, failure))
            flops += f * sweeps[name]
            nbytes += b * sweeps[name]
    return flops, nbytes
