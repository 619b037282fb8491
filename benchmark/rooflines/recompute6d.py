"""FP32 operations and bytes of one sweep of the 6-D attitude backup with
the Euler lanes recomputed inside the kernel (kernel B.5), as its plain
version does them: B.3's count (:mod:`.backup6d`) over the same row and
lane taps, plus each cell's recompute (:data:`OPS_PER_CELL`). Bytes: the
table, the row plan, the rows' omegas (12 B a row) and the lanes' kirk-q
(16 B a lane) in place of the lane plan's 24 B a cell, the costs, the
values and a uint8 argmin, each once. A lane combo counts where a cell's
next state falls in the cell it names, both corners admitted whatever the
fraction, as the kernel's own analysis of a recompute plan admits them.
The taps are derived from the configuration a block of rows at a time
(:mod:`benchmark.reference.attitude_envelope`), never from the port's
objects."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import attitude_envelope as env
from . import backup6d, taps

__all__ = ["OPS_PER_CELL", "sweep", "attitude_structure", "attitude_sweep"]

# one cell's lane recompute: the quaternion step 28 (4 x (3 products, 2
# sums, the step's product and sum)), the norm 8, 4 divisions, the
# readback's arguments 28, two atan2 at 25, the asin's own 6 and its atan2
# 25, three locates at 6
OPS_PER_CELL = 28 + 8 + 4 + 28 + 2 * 25 + 6 + 25 + 3 * 6
# cells a block of the lane analysis locates at once
_BLOCK_CELLS = 4_000_000


def sweep(nw, ne, n_act, row_combos, lane_combos, w_taps, digits,
          n_act_cost):
    """``(flops, bytes)`` of one B.5 sweep over the whole table."""
    flops, nbytes = backup6d.sweep(nw, ne, n_act, row_combos, lane_combos,
                                   w_taps, digits, n_act_cost,
                                   argmin_bytes=1)
    return (flops + float(OPS_PER_CELL * nw * ne),
            nbytes - 24.0 * nw * ne + 12.0 * nw + 16.0 * ne)


def _lane_offsets(cfg: dict, device) -> set:
    """Every (yaw, pitch, roll) offset of a cell's next state from the cell,
    over all cells."""
    n, m = cfg["n_mesh_w"], cfg["n_mesh_q"]
    nw, ne = n ** 3, m ** 3
    parts = env.lane_parts(cfg, device)
    c = torch.arange(ne, device=device)
    own = (c // (m * m), (c // m) % m, c % m)
    step = max(1, _BLOCK_CELLS // ne)
    span = 2 * m + 1                 # an offset lies in [-m, m]
    codes = set()
    for r0 in range(0, nw, step):
        code = 0
        for (lo, _), o in zip(env.lanes(cfg, parts, r0, min(r0 + step, nw)),
                              own):
            code = code * span + (lo - o[None] + m)
        codes.update(torch.unique(code).tolist())
    return {(c // (span * span) - m, (c // span) % span - m, c % span - m)
            for c in codes}


def attitude_structure(cfg: dict):
    """``(nw, ne, n_act, row_combos, lane_combos, w_taps, digits,
    n_act_cost)`` of the 6-D problem on the recompute plan, derived from
    the configuration (on the card when there is one)."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    located, _, u = env.rows(cfg, device)
    n, m = cfg["n_mesh_w"], cfg["n_mesh_q"]
    n_act = u.shape[0]
    w_off, w_frac = [], []
    for k, (lo, fr) in enumerate(located):
        own = np.arange(n).reshape([-1 if i == k else 1 for i in range(4)])
        w_off.append((lo.cpu().numpy() - own).reshape(n ** 3, n_act))
        w_frac.append(fr.cpu().numpy().reshape(n ** 3, n_act))
    w_taps, row_combos = taps.live_sets(w_off, w_frac)
    offs = sorted(_lane_offsets(cfg, device))
    _, lane_combos = taps.live_sets(
        [np.array([o[k] for o in offs]) for k in range(3)],
        [np.float32(0.5)] * 3)
    costs = sum(cfg["R"][k] * u[:, k].double() ** 2 for k in range(3))
    return (n ** 3, m ** 3, n_act, row_combos, lane_combos, w_taps,
            taps.action_digits(w_off, w_frac), int((costs != 0).sum()))


def attitude_sweep(cfg: dict):
    return sweep(*attitude_structure(cfg))
