"""The row/lane kernel's tile planner (``ops/rowlane.py::plan_tiles``): the
index map every CUDA launch of ``csrc/rowlane_backup.cu`` takes.

A block owns R rows x L lanes of one channel and stages in shared memory the
table rows its cells read, over a lane window of the lane reach around its
lanes; every table read then comes from the stage. Checked here, on the CPU,
with the planner's own numbers:

* every read ``(r + D_j, c + t0 * n_l1 + t1)`` of a tile's cells finds in
  its stage exactly that table entry, 0.0 where it lies outside the table,
  as the plain version reads it; the stage and weights fit the planner's
  budget; the grid covers each channel's cells; the lane weight slots
  cover the tile's lane coordinates;
* a sweep whose lane phase gathers the table through the planner's stages
  equals ``rowlane_backup_plain`` bitwise, values and argmin, for the
  four pos-att channels batched (x_failure's 6 actions among 9), for a
  simplified attitude axis (5 row combos, lane taps (0,) and (-1, 0, 1)),
  for a fine omega grid (``n_mesh_w=120``: 35, 35 and 31 row combos, the
  TPU kernel's envelope past the first 32), for a fine simplified omega
  grid (``n_mesh_w=1400``: 37 row combos) and for a fine theta grid
  (``n_mesh_t=1000``: lane taps -7..7, a lane reach of 8 each side);
* the kernel kind: the (-1, 0, 1)-tap kernels for the pos-att channels
  (the 40-combo one past 20 combos), the any-tap ones otherwise (the
  40-combo one past 32); past 40 combos the analysis refuses and names
  the gather backup.

The kernel itself runs only on a card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.models import pos_att as tpa
from ocdp_tpu_torch.ops import rowlane as rl
from ocdp_tpu_torch.ops.rowlane import _tap_weight

torch.set_num_threads(2)

SMEM_BLOCK_MAX = 232_448          # 227 KB: the most an H100 block may ask
CHANNELS = [("x", False), ("y", False), ("z", False), ("x", True)]
SMALL = dict(n_mesh_x=7, n_mesh_v=7, n_mesh_t=6, n_mesh_w=5, T_final=0.25)
MID = dict(n_mesh_x=12, n_mesh_v=12, n_mesh_t=8, n_mesh_w=7, T_final=0.25)
# a fine omega grid: 35 row combos in x and z, 31 in x_failure, 41 in y
WIDE = dict(n_mesh_x=6, n_mesh_v=6, n_mesh_t=10, n_mesh_w=120)


def _pos_att(size, channels=CHANNELS):
    cfg = tpa.PosAttConfig(**size)
    return [tpa.build_channel_rowlane_backup(
        cfg, tpa.build_channel(cfg, ch, failure=f, with_cost=False,
                               device="cpu")) for ch, f in channels]


def _wide():
    return _pos_att(WIDE, [("x", False), ("z", False), ("x", True)])


def _simplified(n_mesh_w=120):
    cfg = tatt.AttitudeConfig(n_mesh_w=n_mesh_w, n_mesh_t=40)
    _, plan, terms = tatt.build_simplified_axis(cfg, 2, device="cpu")
    return [rl.RowLaneBackup(plan, terms, perm=(0, 1), row_axes=1)]


# a fine simplified omega grid: 37 row combos, lane taps (0,), (-1, 0, 1)
def _wide_simplified():
    return _simplified(1400)


# a fine theta grid: lane taps (0,), (-7..7), 15 lane combos
def _fine_theta():
    cfg = tatt.AttitudeConfig(n_mesh_w=40, n_mesh_t=1000)
    _, plan, terms = tatt.build_simplified_axis(cfg, 1, device="cpu")
    bk = rl.RowLaneBackup(plan, terms, perm=(0, 1), row_axes=1)
    assert bk.e_taps[1] == tuple(range(-7, 8))
    return [bk]


CASES = {"small": lambda: _pos_att(SMALL), "mid": lambda: _pos_att(MID),
         "simplified": _simplified, "wide_omega": _wide,
         "wide_simplified": _wide_simplified, "fine_theta": _fine_theta}


def _plan(bks):
    return rl.plan_tiles([rl._plan_key(b.args) for b in bks], SMEM_BLOCK_MAX)


def _stage(plan, ch, table, i, j):
    """Block (i, j)'s stage of channel ``ch`` as the kernel fills it:
    (staged rows, width), 0.0 outside the table."""
    nw, ne = table.shape
    rows = torch.from_numpy(plan.stage_rows(ch, i))
    lanes = j * plan.lanes - plan.reach_lo + torch.arange(plan.width)
    ok = ((rows >= 0) & (rows < nw))[:, None] & ((lanes >= 0)
                                                & (lanes < ne))[None, :]
    vals = table[rows.clamp(0, nw - 1)][:, lanes.clamp(0, ne - 1)]
    return torch.where(ok, vals, torch.zeros_like(vals))


def _gathered(plan, ch, bk, table):
    """G[k][(t0, t1)]: the (NW, NE) values each cell reads for row combo k
    and lane shift (t0, t1), taken from its block's stage at the planner's
    stage row and column."""
    a = bk.args
    nw, ne = table.shape
    n_l1 = a.lane_shape[1]
    out = [{(t0, t1): torch.zeros((nw, ne))
            for t0 in a.lane_taps[0] for t1 in a.lane_taps[1]}
           for _ in a.row_combos]
    for i in range(-(-nw // plan.rows)):
        for j in range(-(-ne // plan.lanes)):
            st = _stage(plan, ch, table, i, j)
            r = torch.arange(i * plan.rows, min((i + 1) * plan.rows, nw))
            c = torch.arange(j * plan.lanes, min((j + 1) * plan.lanes, ne))
            if not len(r) or not len(c):
                continue
            rr = (r - i * plan.rows)[:, None]
            col = (c - j * plan.lanes + plan.reach_lo)[None, :]
            for k in range(len(a.row_combos)):
                for (t0, t1), g in out[k].items():
                    g[r[:, None], c[None, :]] = st[
                        plan.slots[ch][k] + rr, col + t0 * n_l1 + t1]
    return out


def _sweep_through_stages(plan, ch, bk, table):
    """One sweep in ``rowlane_backup_plain``'s order of operations whose
    table reads come from the planner's stages."""
    a = bk.args
    nw, ne = table.shape
    n_l0, n_l1 = a.lane_shape
    lane = torch.arange(ne)
    i0, i1 = lane // n_l1, lane % n_l1
    w0 = {t: _tap_weight(a.lane_off[0][:, i0], a.lane_frac[0][:, i0], t)
          for t in a.lane_taps[0]}
    w1 = {t: _tap_weight(a.lane_off[1][:, i1], a.lane_frac[1][:, i1], t)
          for t in a.lane_taps[1]}
    gathered = _gathered(plan, ch, bk, table)
    shifted = []
    for g in gathered:
        acc = None
        for t0 in a.lane_taps[0]:
            b = None
            for t1 in a.lane_taps[1]:
                term = w1[t1] * g[(t0, t1)]
                b = term if b is None else b + term
            inside = ((i0 + t0 >= 0) & (i0 + t0 < n_l0))[None, :]
            b = torch.where(inside, b, torch.zeros_like(b))
            term = w0[t0] * b
            acc = term if acc is None else acc + term
        shifted.append(acc)
    row_w = [{t: _tap_weight(a.row_off[k], a.row_frac[k], t)
              for t in sorted({c[k] for c in a.row_combos})}
             for k in range(2)]
    best = arg = None
    for act in range(a.n_actions):
        tot = None
        for j, combo in enumerate(a.row_combos):
            w = (row_w[0][combo[0]][:, act:act + 1]
                 * row_w[1][combo[1]][:, act:act + 1])
            term = w * shifted[j]
            tot = term if tot is None else tot + term
        if a.c_act[act]:
            tot = tot + a.c_act[act]
        if a.c_rowact is not None:
            tot = tot + a.c_rowact[:, act:act + 1]
        if best is None:
            best, arg = tot, torch.zeros((nw, ne), dtype=torch.int32)
        else:
            better = tot < best
            best = torch.where(better, tot, best)
            arg = torch.where(better, act, arg)
    out = best + a.c_row[:, None] + a.c_lane[None, :]
    out = out + (a.c_rowlane if a.c_rowlane is not None else 0.0)
    return out, arg


@pytest.mark.parametrize("case", list(CASES))
def test_every_read_lies_in_its_stage(case):
    bks = CASES[case]()
    plan = _plan(bks)
    assert plan.smem_bytes <= rl.SMEM_PER_SM // rl.BLOCKS_PER_SM
    keys = [rl._plan_key(b.args) for b in bks]
    assert plan.lanes % rl.lane_step(keys) == 0 and plan.width == (
        plan.lanes + plan.reach_lo + plan.reach_hi)
    if rl.KIND_TAPS3[plan.kind]:   # lane pairs (c, c + n_l1): runs of 2 n_l1
        assert all(plan.lanes % (2 * b.args.lane_shape[1]) == 0
                   for b in bks)
    assert plan.reach_lo % 4 == 0 and plan.reach_hi % 4 == 0
    rng = np.random.default_rng(31)
    for ch, bk in enumerate(bks):
        a = bk.args
        nw, ne = bk.NW, bk.NE
        assert plan.grid[0] * plan.rows >= nw
        assert plan.grid[1] * plan.lanes >= ne
        table = torch.from_numpy(rng.uniform(1.0, 2.0, (nw, ne))
                                 .astype(np.float32))
        n_l1 = a.lane_shape[1]
        deltas = [t0 * a.row_shape[1] + t1 for t0, t1 in a.row_combos]
        shifts = [t0 * n_l1 + t1 for t0 in a.lane_taps[0]
                  for t1 in a.lane_taps[1]]
        assert -min(shifts) <= plan.reach_lo and max(shifts) <= plan.reach_hi
        tab = table.numpy()
        sh = np.asarray(shifts)[None, :, None]
        for i in range(plan.grid[0]):
            rr = np.arange(plan.rows)
            rr = rr[i * plan.rows + rr < nw]
            r = (i * plan.rows + rr)[:, None, None]
            for j in range(plan.grid[1]):
                st = _stage(plan, ch, table, i, j).numpy()
                c = j * plan.lanes + np.arange(plan.lanes)
                c = c[c < ne][None, None, :]
                tc = c + sh                              # (1, shifts, L)
                for k, d in enumerate(deltas):
                    # every tile row's reads of combo k at every shift
                    tr = r + d
                    want = np.where(
                        (tr >= 0) & (tr < nw) & (tc >= 0) & (tc < ne),
                        tab[np.clip(tr, 0, nw - 1), np.clip(tc, 0, ne - 1)],
                        0.0)
                    got = st[plan.slots[ch][k] + rr[:, None, None],
                             c - j * plan.lanes + plan.reach_lo + sh]
                    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_through_the_stages_equals_plain(case):
    bks = CASES[case]()
    plan = _plan(bks)
    rng = np.random.default_rng(32)
    for ch, bk in enumerate(bks):
        table = torch.from_numpy(rng.uniform(0.0, 5.0, (bk.NW, bk.NE))
                                 .astype(np.float32))
        got_v, got_a = _sweep_through_stages(plan, ch, bk, table)
        want = rl.rowlane_backup_plain(table, bk.args)
        assert torch.equal(got_v, want.values)
        assert torch.equal(got_a, want.argmin)


def test_lane_weight_slots_cover_each_tile():
    for lane_shape, lanes in (((30, 20), 320), ((60, 40), 192),
                              ((1, 300), 64), ((7, 6), 64)):
        n_x0, n_x1 = rl._lane_slots(lane_shape, lanes)
        n_l0, n_l1 = lane_shape
        ne = n_l0 * n_l1
        for c0 in range(0, ne, lanes):
            c = np.arange(c0, min(c0 + lanes, ne))
            assert (c // n_l1 - c0 // n_l1).max() < n_x0
            if n_x1 != n_l1:
                assert n_x1 == lanes and len(c) <= n_x1


def test_kinds_and_refusals():
    small = _pos_att(SMALL)
    assert _plan(small).kind == 0
    assert _plan(_simplified()).kind == 2
    with pytest.raises(ValueError, match="channels in one launch"):
        _plan(small + small[:1])
    # the planner's own ints are the kernel's layout
    plan, ints, c_act, tile = rl._tiles(
        tuple(rl._plan_key(b.args) for b in small), SMEM_BLOCK_MAX)
    assert ints.shape == (4, rl.CHAN_INTS) and c_act.shape == (4, 64)
    assert list(ints[:, 4]) == [9, 9, 9, 6]
    assert tuple(tile[:5]) == (plan.rows, plan.lanes, plan.reach_lo,
                               plan.reach_hi, plan.width)


def test_wide_omega_takes_the_40_combo_kind():
    """Past 20 row combos the (-1, 0, 1)-tap channels take kind 3 (up to
    40, the TPU kernel's max_flat_taps); the planner finds a stage within
    the 57,344 B a block of four an SM may have; the y channel's 41 combos
    are refused, naming the way round."""
    wide = _wide()
    assert [len(b.row_combos) for b in wide] == [35, 35, 31]
    for bks in ([wide[0]], wide):
        plan = _plan(bks)
        assert plan.kind == 3 and rl.KIND_COMBOS[3] == 40
        assert plan.smem_bytes <= rl.SMEM_PER_SM // rl.BLOCKS_PER_SM \
            - rl.SMEM_RESERVED
    with pytest.raises(ValueError, match="41 row combos.*impl='gather'"):
        _pos_att(WIDE, [("y", False)])


def test_wide_simplified_axis_takes_the_any_tap_40_combo_kind():
    """Past 32 row combos a plan whose lane taps are not (-1, 0, 1) on both
    axes takes kind 4 (any taps, up to 40); up to 32 it keeps kind 2. The
    planner finds a stage within a block's budget."""
    wide = _wide_simplified()
    assert len(wide[0].row_combos) == 37
    plan = _plan(wide)
    assert plan.kind == 4 and rl.KIND_COMBOS[4] == 40
    assert not rl.KIND_TAPS3[4] and rl.KIND_COMBOS[2] == 32
    assert plan.smem_bytes <= rl.SMEM_PER_SM // rl.BLOCKS_PER_SM \
        - rl.SMEM_RESERVED
    narrow = _simplified(1000)
    assert len(narrow[0].row_combos) == 27 and _plan(narrow).kind == 2
