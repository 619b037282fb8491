"""The 6-D kernel's tile planner (``ops/backup6d.py::plan_tiles``): the index
map every CUDA launch of ``csrc/backup6d.cu`` takes.

A block owns R output rows x L lanes and stages in shared memory the table
rows its cells read, over a lane window of the lane reach around its lanes;
each read then comes from the stage. Checked here, on the CPU, with the
planner's own numbers:

* every read ``(r + table_row0 + D_j, c + dl_e)`` of a tile's cells finds
  in its stage exactly that table row and lane, which the stage holds as
  0.0 where it lies outside the table, as the plain version reads it;
* the stage fits the 227 KB a block may ask for, the grid covers each
  output cell once, and offsets past 2**31 cells are planned and accepted;
* a sweep whose lane phase gathers the table through the planner's stages
  (numpy) equals ``backup6d_plain`` bitwise, values and argmin;
* a tap structure past 3 taps an axis (row taps (-1, 0, 1, 2) x (-1, 0, 1)
  x (-1, 0, 1), 36 combos) plans ``backup6d_wide``'s tiles: up to 40 row
  groups, its stage slots by combo, 9 row weights a combo;
* a tracking sweep of the whole table over every action at the full
  (-1, 0, 1) tap cube at digit base 3 plans the cube body's tiles, whose
  thread takes ``CUBE_CELLS`` consecutive rows of a tile at one lane and
  reads each row group's stage rows once for all of them, whether its lanes
  are stored (``backup6d_sweep_cube``) or recomputed
  (``backup6d_sweep_recompute_cube``); every other launch and structure
  keeps its kernel (the planner's choice from the args, through the one
  launcher with a stand-in library).

The kernel itself runs only on a card (tests/test_torch_cuda.py).
"""

import itertools
import types

import numpy as np
import pytest
import torch

from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.ops import backup6d as b6
from ocdp_tpu_torch.ops.interp import InterpPlan

torch.set_num_threads(2)

SMEM_BLOCK_MAX = 232_448          # 227 KB: the most an H100 block may ask
CUBE = tuple(itertools.product((-1, 0, 1), repeat=3))


def _synthetic(n_w: int, n_q: int, rows=None, halo=(0, 0), actions=None):
    """Kernel inputs of an ``n_w^3 x n_q^3`` grid with every row and lane
    combo of the 3 x 3 x 3 tap cube live (the attitude plans' structure);
    the planner reads only the taps, shapes and halo, so the per-cell
    tensors are zero-stride views."""
    nw = rows or n_w**3
    return b6.Backup6DArgs(
        row_shape=(n_w,) * 3, lane_shape=(n_q,) * 3,
        row_off=torch.zeros((), dtype=torch.int32).expand(3, nw, 27),
        row_frac=None, lane_off=(), lane_frac=(), row_combos=CUBE,
        lane_combos=CUBE, w_taps=((-1, 0, 1),) * 3, action_digits=3,
        c_row=None, c_lane=None, c_act=(0.0,) * 27, c_rowact=None,
        c_rowlane=None, halo=halo, actions=actions)


# a lighter roll axis and an asymmetric rate range: 36 live row combos
WIDE = dict(h=0.02, w_min_deg=-50.0, w_max_deg=30.0,
            inertia_diag=(0.0225, 0.028317, 0.0245))


def _backup(case="extrapolate", n_w=5, n_q=4, **kw):
    edge = "clamp" if case == "clamp" else "extrapolate"
    _, plan, cost = tatt.build_full(
        tatt.AttitudeConfig(n_mesh_w=n_w, n_mesh_q=n_q,
                            **(WIDE if case == "wide" else {})),
        edge=edge, device="cpu", **kw)
    cost = list(cost)
    if case == "generic":
        perm = torch.from_numpy(np.random.default_rng(5).permutation(27))
        plan = InterpPlan(
            tuple(x[..., perm] if x.shape[-1] > 1 else x for x in plan.lo),
            tuple(x[..., perm] if x.shape[-1] > 1 else x for x in plan.frac),
            plan.grid_shape)
        cost[2] = cost[2][..., perm]
    return b6.Backup6D(plan, cost)


def _block(bk, r0, r1):
    """B.7b's inputs for output rows [r0, r1) of ``bk`` and their local
    table's row count (both halos)."""
    lo, hi = bk.row_reach()
    return b6.block_args(bk.args, r0, r1, lo, hi), lo + (r1 - r0) + hi


def _table_rows(args) -> int:
    return args.n_rows + sum(args.halo)


def _plan(args):
    return b6.plan_tiles(args, _table_rows(args), SMEM_BLOCK_MAX)


# (label, args) of the shapes the main paths run, and the edge cases
SHAPES = {
    "11x10": lambda: _synthetic(11, 10),
    "19x14": lambda: _synthetic(19, 14),
    "30x16": lambda: _synthetic(30, 16),
    "50x20": lambda: _synthetic(50, 20),
    # B.7b: rank 0 of 2 at 11^3 x 10^3, 666 rows of a 932-row local table
    "b7b-666": lambda: _synthetic(11, 10, rows=666, halo=(133, 133)),
    # B.7a: one digit slice (9 of 27 actions) over the same rows
    "b7a-slice": lambda: _synthetic(11, 10, rows=666, halo=(133, 133),
                                    actions=(9, 18)),
    "5x4": lambda: _backup().args,
    "7x5": lambda: _backup(n_w=7, n_q=5).args,
    "clamp": lambda: _backup("clamp").args,
    "generic": lambda: _backup("generic").args,
    "b7b-row0": lambda: _block(_backup(), 40, 90)[0],
    # backup6d_wide: 36 row combos at 15^3 x 3^3 and 15^3 x 10^3, a row
    # block of the first with its halos
    "wide-15x3": lambda: _backup("wide", 15, 3).args,
    "wide-15x10": lambda: _backup("wide", 15, 10).args,
    "wide-b7b": lambda: _block(_backup("wide", 15, 3), 1000, 1200)[0],
}


def args_wide(args) -> bool:
    """More than 3 live taps on some row or lane axis."""
    return max(len({c[k] for c in combos}) for combos in
               (args.row_combos, args.lane_combos) for k in range(3)) > 3


def _tiles_to_check(plan):
    """Every tile of a small grid; the corner, edge and middle tiles of a
    large one."""
    gi, gj = plan.grid
    if gi * gj <= 64:
        return list(itertools.product(range(gi), range(gj)))
    ii = sorted({0, 1, gi // 2, gi - 2, gi - 1})
    jj = sorted({0, gj // 2, gj - 1})
    return list(itertools.product(ii, jj))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_every_read_lies_in_its_stage(shape):
    args = SHAPES[shape]()
    plan = _plan(args)
    R, L, ne = plan.rows, plan.lanes, plan.n_lanes
    assert plan.smem_bytes <= SMEM_BLOCK_MAX
    assert plan.wide == args_wide(args)
    assert len(plan.groups) <= (b6.MAX_COMBOS if plan.wide
                                else b6.MAX_GROUPS)
    assert plan.width == L + plan.reach_lo + plan.reach_hi
    assert L % 32 == 0 and plan.threads in (256, 512)
    assert plan.table_row0 == args.halo[0]
    row_d, lane_d = args.row_deltas(), args.lane_deltas()
    for i, j in _tiles_to_check(plan):
        r0, c0 = i * R, j * L
        srows = plan.stage_rows(i)
        assert len(srows) == plan.n_staged
        scols = c0 - plan.reach_lo + np.arange(plan.width)
        r = r0 + np.arange(R)[:, None]
        c = c0 + np.arange(L)[None, :]
        live = (r < args.n_rows) & (c < ne)
        rr, cl = np.broadcast_arrays(r - r0, c - c0)
        rr, cl = rr[live], cl[live]
        for slot, d in zip(plan.slots, row_d):
            srow = slot + rr
            assert srow.min() >= 0 and srow.max() < plan.n_staged
            # the stage row holds the table row this combo reads
            np.testing.assert_array_equal(
                srows[srow], (r0 + rr) + plan.table_row0 + d)
        for dl in lane_d:
            scol = cl + plan.reach_lo + dl
            assert scol.min() >= 0 and scol.max() < plan.width
            np.testing.assert_array_equal(scols[scol], c0 + cl + dl)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_grid_covers_each_output_cell_once(shape):
    args = SHAPES[shape]()
    plan = _plan(args)
    gi, gj = plan.grid
    nw, ne = args.n_rows, plan.n_lanes
    assert (gi - 1) * plan.rows < nw <= gi * plan.rows
    assert (gj - 1) * plan.lanes < ne <= gj * plan.lanes
    if nw * ne <= 10**6:
        count = np.zeros((gi * plan.rows, gj * plan.lanes), np.int32)
        for i, j in itertools.product(range(gi), range(gj)):
            count[i * plan.rows:(i + 1) * plan.rows,
                  j * plan.lanes:(j + 1) * plan.lanes] += 1
        assert (count[:nw, :ne] == 1).all()


def test_lane_count_not_a_multiple_of_the_tile():
    plan = _plan(SHAPES["11x10"]())
    assert plan.n_lanes % plan.lanes != 0     # the last lane tile is cut
    assert plan.n_rows % plan.rows != 0       # and the last row tile


def test_ints_are_the_kernels_layout():
    args = _backup("generic").args
    plan = _plan(args)
    ints = plan.ints()
    assert ints.shape == (b6.TILE_INTS,) and ints.dtype == np.int32
    g = len(plan.groups)
    assert tuple(ints[:9]) == (plan.rows, plan.lanes, plan.reach_lo,
                               plan.reach_hi, plan.width, plan.n_staged, g,
                               b6.ROW_WEIGHTS, 0)
    assert tuple(ints[-4:]) == (*plan.grid, plan.smem_bytes, plan.threads)
    at = 9 + 3 * b6.MAX_COMBOS
    cube = ints[at:at + 27]
    assert sorted(int(s) for s in cube if s >= 0) == sorted(plan.slots)
    assert (ints[at + 27:at + b6.MAX_COMBOS] == -1).all()
    # backup6d_wide's: the stage slots by combo, 9 row weights a combo
    wide = _plan(_backup("wide", 15, 3).args)
    wints = wide.ints()
    assert wide.wide and len(wide.slots) == 36
    assert tuple(wints[7:9]) == (9 * 36, 1)
    assert tuple(wints[at:at + 36]) == wide.slots
    assert wide.smem_bytes == 4 * (wide.n_staged * wide.width
                                   + wide.rows * 9 * 36)
    # the cube body's: kind 2, the cube slots and row weights of
    # backup6d_sweep, CUBE_THREADS threads, rows a multiple of CUBE_CELLS
    cplan = b6.plan_tiles(_backup().args, 125, SMEM_BLOCK_MAX)
    cints = cplan.ints()
    assert cplan.cube_body and not cplan.wide
    assert tuple(cints[:9]) == (cplan.rows, cplan.lanes, cplan.reach_lo,
                                cplan.reach_hi, cplan.width, cplan.n_staged,
                                len(cplan.groups), b6.ROW_WEIGHTS,
                                b6.CUBE_KIND)
    assert tuple(cints[at:at + 27]) == cplan.cube == cplan.slots
    assert (cints[at + 27:at + b6.MAX_COMBOS] == -1).all()
    assert tuple(cints[-4:]) == (*cplan.grid, cplan.smem_bytes,
                                 b6.CUBE_THREADS)
    assert cplan.rows % b6.CUBE_CELLS == 0
    # with the lanes recomputed: the same kind and ints
    rargs = _backup(lane_mode="recompute").args
    rplan = b6.plan_tiles(rargs, 125, SMEM_BLOCK_MAX)
    assert rplan.cube_body and rplan.kind == b6.CUBE_KIND == 2
    np.testing.assert_array_equal(rplan.ints(), cints)


def test_row_groups_merge_where_runs_meet():
    # 5 rows a step of the last row axis: with R = 4 rows and taps -1..1
    # the runs [b - 1, b + 5) of the t1 steps b, b + 5, b + 10 overlap and
    # merge, one group per t0
    assert b6._row_groups(CUBE, (5, 5, 5), 4) == ((-31, 16), (-6, 16),
                                                  (19, 16))
    # 11 rows a step: nine runs of R + 2 rows
    groups = b6._row_groups(CUBE, (11, 11, 11), 4)
    assert len(groups) == 9 and all(n == 6 for _, n in groups)


def _tiled_lane_phase(plan_of):
    """``_lane_phase`` with every table read taken from the stage the
    planner gives the read's tile: the stage gathered with numpy, 0.0 where
    it leaves the table; the joint weights and the sums in ``_lane_phase``'s
    order (every product and sum a separately rounded float32 op)."""

    def lane_phase(values, args):
        plan = plan_of(args, values.shape[0])
        v = values.numpy()
        nw, ne = args.n_rows, v.shape[1]
        e_taps = [sorted({c[k] for c in args.lane_combos}) for k in range(3)]
        ew = [{t: b6._tap_weight(args.lane_off[k], args.lane_frac[k], t)
               for t in e_taps[k]} for k in range(3)]
        joint = []
        for combo in args.lane_combos:
            w = None
            for k, t in enumerate(combo):
                w = ew[k][t] if w is None else w * ew[k][t]
            joint.append(w.numpy())
        lane_d = args.lane_deltas()
        out = [np.zeros((nw, ne), np.float32) for _ in args.row_combos]
        gi, gj = plan.grid
        for i in range(gi):
            srows = plan.stage_rows(i)
            rin = (srows >= 0) & (srows < plan.n_table_rows)
            for j in range(gj):
                c0 = j * plan.lanes
                scols = c0 - plan.reach_lo + np.arange(plan.width)
                cin = (scols >= 0) & (scols < ne)
                stage = np.zeros((plan.n_staged, plan.width), np.float32)
                stage[np.ix_(rin, cin)] = v[np.ix_(srows[rin], scols[cin])]
                r = np.arange(i * plan.rows, min((i + 1) * plan.rows, nw))
                c = np.arange(c0, min(c0 + plan.lanes, ne))
                rr = (r - i * plan.rows)[:, None]
                cl = (c - c0)[None, :]
                for k, slot in enumerate(plan.slots):
                    acc = None
                    for w, dl in zip(joint, lane_d):
                        term = w[np.ix_(r, c)] * stage[slot + rr,
                                                       cl + plan.reach_lo + dl]
                        acc = term if acc is None else acc + term
                    out[k][np.ix_(r, c)] = acc
        return [torch.from_numpy(o) for o in out]

    return lane_phase


@pytest.mark.parametrize("case", ["5x4", "7x5", "clamp", "generic",
                                  "b7b-row0", "b7a-slice-row0", "wide"])
def test_sweep_through_the_stages_equals_plain(case, monkeypatch):
    rng = np.random.default_rng(17)
    if case.startswith("b7"):
        bk = _backup()
        args, n_table = _block(bk, 40, 90)
        if case == "b7a-slice-row0":
            args = b6.slice_args(args, 9, 18)
    elif case == "wide":
        bk = _backup("wide", 15, 3)
        args, n_table = bk.args, bk.NW
    else:
        bk = _backup(case if case in ("clamp", "generic") else "extrapolate",
                     *((7, 5) if case == "7x5" else (5, 4)))
        args, n_table = bk.args, bk.NW
    v = torch.from_numpy(rng.uniform(0.0, 50.0, (n_table, bk.NE))
                         .astype(np.float32))
    want = b6.backup6d_plain(v, args)
    plans = []

    def plan_of(a, n):
        plans.append(b6.plan_tiles(a, n, SMEM_BLOCK_MAX))
        return plans[-1]

    monkeypatch.setattr(b6, "_lane_phase", _tiled_lane_phase(plan_of))
    got = b6.backup6d_plain(v, args)
    assert plans and plans[0].grid[0] * plans[0].grid[1] >= 2
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.argmin, want.argmin)


def test_offsets_past_2_31_cells_are_planned_and_accepted():
    """60^3 x 22^3 (2.30B cells): the last tiles start past 2**31 cells,
    and the input check takes the shape (meta tensors: the check stops only
    at the device, after every shape)."""
    n_w, n_q = 60, 22
    nw, ne = n_w**3, n_q**3
    assert nw * ne > 2**31
    args = _synthetic(n_w, n_q)
    plan = _plan(args)
    gi, gj = plan.grid
    assert plan.cell_offset(gi - 1, gj - 1) > 2**31
    assert plan.cell_offset(gi - 1, gj - 1) < nw * ne < 2**63
    assert plan.smem_bytes <= SMEM_BLOCK_MAX

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    full = args._replace(
        row_off=meta((3, nw, 27), torch.int32), row_frac=meta((3, nw, 27)),
        lane_off=tuple(meta((nw, ne), torch.int32) for _ in range(3)),
        lane_frac=tuple(meta((nw, ne)) for _ in range(3)),
        c_row=meta((nw,)), c_lane=meta((ne,)))
    with pytest.raises(ValueError, match="must be on the CUDA device"):
        b6._check_cuda_inputs(meta((nw, ne)), full)


# backup6d_sweep_cube: B.3's launch of the full (-1, 0, 1) tap cube. 11^3
# rows are odd (the last chunk's second cell lies past the table) and 10^3
# lanes are no multiple of the tile; 12^3 rows and 30^3 x 16^3 take other
# tiles.
CUBE_SHAPES = {
    "5x4": lambda: _backup().args,
    "7x5": lambda: _backup(n_w=7, n_q=5).args,
    "clamp": lambda: _backup("clamp").args,
    "11x10": lambda: _synthetic(11, 10),
    "12x10": lambda: _synthetic(12, 10),
    "19x14": lambda: _synthetic(19, 14),
    "30x16": lambda: _synthetic(30, 16),
}


def _cube_plan(args):
    plan = b6.plan_tiles(args, _table_rows(args), SMEM_BLOCK_MAX)
    assert plan.cube_body and plan.kind == b6.CUBE_KIND and not plan.wide
    assert plan.rows % b6.CUBE_CELLS == 0
    assert plan.threads == b6.CUBE_THREADS
    # two blocks an SM
    assert plan.smem_bytes <= b6.SMEM_PER_SM // 2 - b6.SMEM_RESERVED
    return plan


def _cube_chunks(plan, i, j, n_rows):
    """The chunks ``(q, cl)`` of tile ``(i, j)`` whose first cell lies in
    the table (the kernel skips the others)."""
    q = np.arange(plan.rows // b6.CUBE_CELLS)[:, None]
    cl = np.arange(plan.lanes)[None, :]
    live = (i * plan.rows + q * b6.CUBE_CELLS < n_rows) & \
        (j * plan.lanes + cl < plan.n_lanes)
    q, cl = np.broadcast_arrays(q, cl)
    return q[live], cl[live]


@pytest.mark.parametrize("shape", list(CUBE_SHAPES))
def test_cube_reads_lie_in_their_stage(shape):
    """Cell k of a chunk (tile rows rr0 + k, rr0 = q CUBE_CELLS) reads row
    combo (g, i2) at stage row cube[3 g] + rr0 + k + i2 and lane combo
    (e01, t2) at column cl + reach_lo + dl(e01, t2=0) + t2: each row
    group's three t2 rows are consecutive stage rows, each lane pair's three
    t2 lanes consecutive columns, and every read of every chunk (past the
    table's last row too) lies in the stage and finds there the table row
    and lane the plain version reads."""
    args = CUBE_SHAPES[shape]()
    plan = _cube_plan(args)
    C, R, L = b6.CUBE_CELLS, plan.rows, plan.lanes
    cube = np.asarray(plan.cube).reshape(9, 3)
    np.testing.assert_array_equal(cube - cube[:, :1], [[0, 1, 2]] * 9)
    row_d = np.asarray(args.row_deltas()).reshape(9, 3)
    lane_d = np.asarray(args.lane_deltas()).reshape(9, 3)
    np.testing.assert_array_equal(lane_d - lane_d[:, 1:2], [[-1, 0, 1]] * 9)
    for i, j in _tiles_to_check(plan):
        srows = plan.stage_rows(i)
        scols = j * L - plan.reach_lo + np.arange(plan.width)
        q, cl = _cube_chunks(plan, i, j, args.n_rows)
        for k in range(C):
            rr = q * C + k
            for g, i2 in itertools.product(range(9), range(3)):
                srow = cube[g, 0] + q * C + k + i2
                assert srow.min() >= 0 and srow.max() < plan.n_staged
                np.testing.assert_array_equal(
                    srows[srow], i * R + rr + plan.table_row0 + row_d[g, i2])
        for e01, t2 in itertools.product(range(9), range(3)):
            scol = cl + plan.reach_lo + lane_d[e01, 1] + t2 - 1
            assert scol.min() >= 0 and scol.max() < plan.width
            np.testing.assert_array_equal(scols[scol],
                                          j * L + cl + lane_d[e01, t2])


@pytest.mark.parametrize("shape", list(CUBE_SHAPES))
def test_cube_grid_covers_each_output_cell_once(shape):
    """The chunks of every tile cover each output cell once; no chunk
    straddles two tiles (rows a multiple of CUBE_CELLS)."""
    args = CUBE_SHAPES[shape]()
    plan = _cube_plan(args)
    C, R, L = b6.CUBE_CELLS, plan.rows, plan.lanes
    gi, gj = plan.grid
    nw, ne = args.n_rows, plan.n_lanes
    assert (gi - 1) * R < nw <= gi * R and (gj - 1) * L < ne <= gj * L
    if nw * ne > 10**6:
        return
    count = np.zeros((gi * R, gj * L), np.int32)
    for i, j in itertools.product(range(gi), range(gj)):
        q, cl = _cube_chunks(plan, i, j, nw)
        for k in range(C):
            np.add.at(count, (i * R + q * C + k, j * L + cl), 1)
    assert (count[:nw, :ne] == 1).all()
    assert (count[nw:] <= 1).all() and (count[:, ne:] == 0).all()


def test_cube_plan_edges():
    """At 11^3 x 10^3 the cube plan's row tiles are clipped at both table
    edges, the last lane tile is cut, and the last chunk's second cell lies
    past the table."""
    args = _synthetic(11, 10)
    plan = _cube_plan(args)
    nw = args.n_rows
    assert plan.stage_rows(0).min() < 0
    assert plan.stage_rows(plan.grid[0] - 1).max() >= nw
    assert plan.n_lanes % plan.lanes != 0
    assert nw % b6.CUBE_CELLS != 0 and nw % plan.rows != 0


def _cube_lane_phase(plan_of):
    """``_lane_phase`` read as the cube body reads it: each chunk's cells
    from the stage of its tile, row combo (g, i2) of
    cell k at group g's first stage row + rr0 + k + i2, lane combo (e01, t2)
    at lane pair e01's middle column + t2 - 1; the joint weights and the
    sums in ``_lane_phase``'s order."""

    def lane_phase(values, args):
        plan = plan_of(args, values.shape[0])
        assert plan.kind == b6.CUBE_KIND
        C = b6.CUBE_CELLS
        v = values.numpy()
        nw, ne = args.n_rows, v.shape[1]
        ew = [{t: b6._tap_weight(args.lane_off[k], args.lane_frac[k], t)
               for t in b6.CUBE_TAPS} for k in range(3)]
        joint = [((ew[0][t0] * ew[1][t1]) * ew[2][t2]).numpy()
                 for t0, t1, t2 in args.lane_combos]
        lane_d = np.asarray(args.lane_deltas()).reshape(9, 3)
        cube = np.asarray(plan.cube).reshape(9, 3)
        out = [np.zeros((nw, ne), np.float32) for _ in range(27)]
        gi, gj = plan.grid
        for i, j in itertools.product(range(gi), range(gj)):
            srows = plan.stage_rows(i)
            rin = (srows >= 0) & (srows < plan.n_table_rows)
            c0 = j * plan.lanes
            scols = c0 - plan.reach_lo + np.arange(plan.width)
            cin = (scols >= 0) & (scols < ne)
            stage = np.zeros((plan.n_staged, plan.width), np.float32)
            stage[np.ix_(rin, cin)] = v[np.ix_(srows[rin], scols[cin])]
            q, cl = _cube_chunks(plan, i, j, nw)
            for k in range(C):
                rr0 = q * C
                r = i * plan.rows + rr0 + k
                keep = r < nw
                r, c, rr0, cl_k = r[keep], c0 + cl[keep], rr0[keep], cl[keep]
                for g, i2 in itertools.product(range(9), range(3)):
                    acc = None
                    for e in range(27):
                        e01, t2 = divmod(e, 3)
                        term = joint[e][r, c] * stage[
                            cube[g, 0] + rr0 + k + i2,
                            cl_k + plan.reach_lo + lane_d[e01, 1] + t2 - 1]
                        acc = term if acc is None else acc + term
                    out[g * 3 + i2][r, c] = acc
        return [torch.from_numpy(o) for o in out]

    return lane_phase


@pytest.mark.parametrize("case", ["5x4", "7x5", "clamp"])
def test_cube_sweep_through_the_stages_equals_plain(case, monkeypatch):
    """A sweep whose lane phase gathers the table as ``backup6d_sweep_cube``
    reads it, through the cube plan's stages, equals ``backup6d_plain``
    bitwise, values and argmin."""
    rng = np.random.default_rng(23)
    bk = _backup(case if case == "clamp" else "extrapolate",
                 *((7, 5) if case == "7x5" else (5, 4)))
    assert b6.cube_body(bk.args)
    v = torch.from_numpy(rng.uniform(0.0, 50.0, (bk.NW, bk.NE))
                         .astype(np.float32))
    want = b6.backup6d_plain(v, bk.args)
    plans = []

    def plan_of(a, n):
        plans.append(b6.plan_tiles(a, n, SMEM_BLOCK_MAX))
        return plans[-1]

    monkeypatch.setattr(b6, "_lane_phase", _cube_lane_phase(plan_of))
    got = b6.backup6d_plain(v, bk.args)
    assert plans and plans[0].grid[0] * plans[0].grid[1] >= 2
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.argmin, want.argmin)


@pytest.mark.parametrize("case", ["5x4", "clamp", "7x5"])
def test_recompute_cube_sweep_through_the_stages_equals_plain(case,
                                                              monkeypatch):
    """B.5's sweep of the full tap cube, its lane phase gathered as
    ``backup6d_sweep_recompute_cube`` reads it through its plan's stages
    with the plain recompute's (off, frac), equals ``backup6d_plain``
    bitwise, values and argmin. 5^3 and 7^3 rows are odd: the last chunk's
    second cell lies past the table."""
    rng = np.random.default_rng(31)
    bk = _backup(case if case == "clamp" else "extrapolate",
                 *((7, 5) if case == "7x5" else (5, 4)),
                 lane_mode="recompute")
    assert bk.recompute and b6.cube_body(bk.args)
    assert bk.NW % b6.CUBE_CELLS == 1
    v = torch.from_numpy(rng.uniform(0.0, 50.0, (bk.NW, bk.NE))
                         .astype(np.float32))
    want = b6.backup6d_plain(v, bk.args)
    plans = []

    def plan_of(a, n):
        plans.append(b6.plan_tiles(a, n, SMEM_BLOCK_MAX))
        return plans[-1]

    monkeypatch.setattr(b6, "_lane_phase", _cube_lane_phase(plan_of))
    got = b6.backup6d_plain(v, bk.args)
    assert plans and plans[0].grid[0] * plans[0].grid[1] >= 2
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.argmin, want.argmin)


# a stand-in lane recompute: the planner reads only whether it is there
_LANES = b6.LaneRecompute(0.0, (), (), (), (), (), "extrapolate")


@pytest.mark.parametrize("shape", list(CUBE_SHAPES))
def test_recompute_cube_plan_is_the_cube_plan(shape):
    """A tracking sweep of the full tap cube with the lanes recomputed
    plans the stored plan's cube tiles (so each of its reads lies in its
    stage and its chunks cover each cell once, as above), and so does a
    uint8 argmin; a min-only sweep plans ``backup6d_sweep``'s."""
    args = CUBE_SHAPES[shape]()._replace(lanes=_LANES)
    plan = b6.plan_tiles(args, _table_rows(args), SMEM_BLOCK_MAX)
    assert plan == _cube_plan(args._replace(lanes=None))
    assert b6.plan_tiles(args._replace(argmin_dtype=torch.uint8),
                         _table_rows(args), SMEM_BLOCK_MAX) == plan
    min_only = b6.plan_tiles(args._replace(track_argmin=False),
                             _table_rows(args), SMEM_BLOCK_MAX)
    assert min_only.kind == b6.SWEEP_KIND


# the launches of the reference structure at 5^3 x 4^3: (args, the kernel
# the planner picks for them)
PICKS = {
    "stored": (lambda: _backup().args, b6.CUBE_KIND),
    "recompute": (lambda: _backup(lane_mode="recompute").args, b6.CUBE_KIND),
    "min-only": (lambda: _backup().args._replace(track_argmin=False),
                 b6.SWEEP_KIND),
    "block-halos": (lambda: _block(_backup(), 40, 90)[0], b6.SWEEP_KIND),
    # a block with no halo rows sweeps a table of its own
    "block-no-halos": (lambda: b6.block_args(_backup().args, 40, 90, 0, 0),
                       b6.CUBE_KIND),
    "digit-slice": (lambda: b6.slice_args(_backup().args, 9, 18),
                    b6.SWEEP_KIND),
}


@pytest.mark.parametrize("case", list(PICKS))
def test_the_planner_picks_the_body_from_the_args(case):
    """The planner runs the cube body for a tracking sweep of the whole
    table (no halo rows) over every action at the full tap cube, stored or
    recomputed lanes alike; a min-only sweep, a row block with its halos
    and a digit slice of the same structure plan ``backup6d_sweep``'s
    tiles."""
    make, kind = PICKS[case]
    args = make()
    plan = b6.plan_tiles(args, _table_rows(args), SMEM_BLOCK_MAX)
    assert plan.kind == kind and plan.ints()[8] == kind
    assert b6.cube_body(args) == plan.cube_body == (kind == b6.CUBE_KIND)


class _StandInLibrary:
    """The kernel library's entries, each returning 0 (success) unrun."""

    def __getattr__(self, name):
        return lambda *args: 0


def _synthetic_taps(w_taps, row_combos, digits=3, n_act=27, base=None):
    nw = 5**3
    return (base or _synthetic(5, 4))._replace(
        row_off=torch.zeros((), dtype=torch.int32).expand(3, nw, n_act),
        row_combos=tuple(row_combos), w_taps=tuple(w_taps),
        action_digits=digits, c_act=(0.0,) * n_act)


# the tap structures besides the full cube at digit base 3
OTHER_TAPS = {
    "tap2": (((-1, 0), (-1, 0, 1), (-1, 0, 1)),
             tuple(itertools.product((-1, 0), (-1, 0, 1), (-1, 0, 1))), 3,
             27),
    "dead-combo": (((-1, 0, 1),) * 3, CUBE[:-1], 3, 27),
    "m2": (((-1, 0, 1),) * 3, CUBE, 2, 8),
}


def _launch_case(case):
    """``(values, args)`` of one launch, as the engines (through
    :class:`Backup6D`) or B.7 hand them to the launcher."""
    if case in OTHER_TAPS:
        args = _synthetic_taps(*OTHER_TAPS[case])
        return torch.zeros((args.n_rows, 64)), args
    if case.startswith("recompute"):
        bk = b6.Backup6D(*tatt.build_full(
            tatt.AttitudeConfig(n_mesh_w=5, n_mesh_q=4), device="cpu",
            lane_mode="recompute")[1:],
            argmin_dtype=torch.uint8 if case == "recompute-uint8"
            else torch.int32, track_argmin=case != "recompute-min-only")
        args, values = bk.args, torch.zeros((bk.NW, bk.NE))
        if case == "recompute-block-halos":
            args, n = _block(bk, 40, 90)
            return torch.zeros((n, bk.NE)), args
        if case in ("recompute-tap2", "recompute-m2"):
            args = _synthetic_taps(*OTHER_TAPS[case[10:]], base=args)
        return values, args
    if case in ("flat", "uint8"):
        kw = {"flat": dict(flat=True), "uint8": {}}[case]
        _, plan, cost = tatt.build_full(
            tatt.AttitudeConfig(n_mesh_w=5, n_mesh_q=4), device="cpu", **kw)
        bk = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8
                         if case == "uint8" else torch.int32)
        return torch.zeros((bk.NW, bk.NE)), bk.args
    if case in ("block-halos", "digit-slice"):
        args, n = _block(_backup(), 40, 90)
        if case == "digit-slice":
            return torch.zeros((n, 64)), b6.slice_args(args, 9, 18)
        return torch.zeros((n, 64)), args
    bk = {"reference": lambda: _backup(), "generic": lambda: _backup(
        "generic"), "wide-36": lambda: _backup("wide", 15, 3)}[case]()
    return torch.zeros((bk.NW, bk.NE)), bk.args


@pytest.mark.parametrize("case,kind", [
    ("reference", b6.CUBE_KIND), ("tap2", b6.SWEEP_KIND),
    ("dead-combo", b6.SWEEP_KIND), ("m2", b6.SWEEP_KIND),
    ("generic", b6.SWEEP_KIND), ("wide-36", b6.WIDE_KIND),
    ("flat", b6.CUBE_KIND), ("uint8", b6.CUBE_KIND),
    ("recompute", b6.CUBE_KIND), ("recompute-uint8", b6.CUBE_KIND),
    ("recompute-min-only", b6.SWEEP_KIND),
    ("recompute-tap2", b6.SWEEP_KIND), ("recompute-m2", b6.SWEEP_KIND),
    ("recompute-block-halos", b6.SWEEP_KIND),
    ("block-halos", b6.SWEEP_KIND), ("digit-slice", b6.SWEEP_KIND)])
def test_host_picks_the_cube_body(case, kind, monkeypatch):
    """The host picks the cube body for every tracking sweep of the whole
    table over every action at the full (-1, 0, 1) tap cube at digit base
    3 (the attitude reference's structure): a broadcast or flat stored
    plan, an int32 or uint8 argmin, stored or recomputed lanes; a 2-tap
    axis, a dead row combo, digit base 2, the generic phase, a 36-combo
    structure, a min-only sweep, a row block with its halos (stored or
    recompute plan) and a digit slice keep their kernel. Every launch
    counts in ``backup6d_cuda.launches``, the cube body's in
    ``backup6d_cuda.cube_launches``. Run through the one launcher with a
    stand-in library: the plan each launch hands the kernel."""
    from ocdp_tpu_torch import _build

    seen = []
    real = b6._tiles_for

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(out[0])
        return out

    monkeypatch.setattr(b6, "_tiles_for", spy)
    monkeypatch.setattr(b6, "_check_cuda_inputs", lambda *a: None)
    monkeypatch.setattr(b6, "_smem_limit", lambda lib, dev: SMEM_BLOCK_MAX)
    monkeypatch.setattr(_build, "load", lambda: _StandInLibrary())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    values, args = _launch_case(case)
    launches = b6.backup6d_cuda.launches
    cube = b6.backup6d_cuda.cube_launches
    b6.backup6d_cuda(values, args)
    assert len(seen) == 1 and seen[0].kind == kind
    assert seen[0].cube_body == (kind == b6.CUBE_KIND) == b6.cube_body(args)
    assert b6.backup6d_cuda.launches == launches + 1
    assert b6.backup6d_cuda.cube_launches == cube + (kind == b6.CUBE_KIND)
