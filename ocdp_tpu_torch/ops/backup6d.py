"""6-D coupled-lane Bellman backup: the CUDA kernel, its plain version, its
wrapper.

Replaces the TPU kernel ``ocdp_tpu/ops/pallas_backup6.py::PallasBackup6D``
in its coupled-lane mode (``_kernel``'s joint lane-combo branch, then
``_action_phase_factorized`` or ``_action_phase_generic``) on the full 6-D
attitude path. One launcher, :func:`backup6d_cuda`, runs every mode, read
from its :class:`Backup6DArgs`:

* B.3, non-flat plans (the broadcast layout);
* B.4, flat plans and the envelope modes (``(NW, 1, A)`` row and
  ``(NW, NE, 1)`` lane plan arrays, uint8 or int32 argmin, min-only sweeps,
  sweeps into buffers the engine allocated once);
* B.5, lane recompute (:class:`RecomputePlan`, ``args.lanes``: no lane plan
  exists; the kernel regenerates each cell's Euler (lo, frac) from per-row
  omegas and per-lane kirk-q components);
* B.7, the row-sharded engines' modes (``parallel/halo6.py``), on any of
  the three plan kinds: one rank's row block swept from a local table that
  holds its halo rows (:func:`block_args`, ``args.halo``), and that block
  over one contiguous action range, a fixed-d0 digit slice when the actions
  factor (:func:`slice_args`, ``args.actions``).

The kernel source, with the note on its arithmetic, tie order and what
bounds it, is ``csrc/backup6d.cu``. It holds two kernels for every mode:
``backup6d_sweep`` takes at most 3 live taps an axis, ``backup6d_wide`` any
taps up to 40 live row and 40 live lane combos, the TPU kernel's
``max_flat_taps`` (a 4 x 3 x 3 row structure: 36 combos). Besides, a
tracking sweep of the whole table over every action at the attitude solve's
own structure, the full (-1, 0, 1) tap cube at action digit base 3
(:func:`cube_body`), runs the cube body, compiled for that structure:
``backup6d_sweep_cube`` on a stored lane plan,
``backup6d_sweep_recompute_cube`` with the Euler lanes recomputed in its
prologue. The tile planner picks the kernel from the args alone
(:attr:`TilePlan.kind`).

The state axes split into 3 ROW axes, whose next states depend on the action
(attitude: omega1..3), and 3 LANE axes, whose next states do not but may
depend on every row and lane coordinate together (attitude: the Euler
angles, coupled by the quaternion step). The value table is a ``(NW, NE)``
matrix, and one sweep is, per cell (row r, lane c):

1. lane tap weights ``(off == t ? 1-f : 0) + (off == t-1 ? f : 0)`` on each
   lane axis, and per live lane combo e the joint weight
   ``W_e = (w0[t0] * w1[t1]) * w2[t2]``;
2. for each live row combo j (flat row shift D_j),
   ``A_j = sum_e W_e * V[r + D_j][c + dl_e]`` over the lane combos in their
   sorted order, each sum starting from its first term;
3. the action phase: digit by digit when row axis k's queries depend only on
   digit k of the C-order action index (``action_digits``; the attitude
   torques), else per action over every row combo; then ``+ c_act[a]``
   where it is not 0 and ``+ c_rowact[r, a]``, with the strict-``<`` first
   minimum from action 0 (a min-only sweep keeps the same running minimum
   and an all-zero argmin);
4. ``best + c_row[r] + c_lane[c] (+ c_rowlane[r, c])``.

A read that leaves the table (a row outside ``[0, NW)`` or a lane outside
``[0, NE)``) reads 0.0 and always carries an exactly zero weight; it is
summed all the same.

In B.7's row-block mode the output rows are a block ``[r0, r1)`` and the
table is local: ``lo + (r1 - r0) + hi`` rows starting ``lo`` rows above
``r0`` (``Backup6DArgs.halo``), so output row r reads table row ``r + lo +
D_j``; the halo rows of an edge rank are zeros, the value the one-device
sweep reads outside ``[0, NW)``. In its action-slice mode the minimum runs
over ``Backup6DArgs.actions = (a_lo, a_hi)`` and the argmin is the global
action index; the factorized phase runs for whole fixed-d0 slices, the
generic phase otherwise. Either way each action's total is the one-device
sweep's, bit for bit.

* :func:`backup6d_cuda` launches the kernel; it counts its launches in
  ``.launches`` and those of the cube body in ``.cube_launches``. Every
  launch takes its tiles from :func:`plan_tiles`: the rows x lanes a block
  owns and the table rows and lanes it stages in shared memory, the index
  map the CPU tests check (``tests/test_torch_backup6d_tiles.py``).
* :func:`backup6d_plain` is the same function in plain PyTorch on the same
  inputs, in the same order of operations (the recompute through
  :meth:`LaneRecompute.lane_block`). On a CUDA device the two agree
  bitwise.
* :class:`Backup6D` analyses a plan once (live taps, action digits, the
  cost split) and is the engines' ``values -> BackupResult`` callable, with
  :meth:`Backup6D.sweep_into` for the engines' carry mode: the kernel on a
  CUDA tensor, the plain version on a CPU tensor. Non-flat plans are
  analysed on the host, flat and recompute plans where they lie: only bin
  counts of the lane taps, a few KB, come to the host.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..profiling import span
from .backup import BackupResult
from .interp import InterpPlan
from .kernelmath import asin_f32, atan2_f32, quat_step_readback
from .rowlane import (_as_numpy, _corner_live_sets, _decode_live, _row_plan,
                      _shift_lanes, _split_cost, _tap_weight, _upload)

__all__ = ["Backup6DArgs", "Backup6D", "LaneRecompute", "RecomputePlan",
           "affine_locate", "plan_is_flat", "backup6d_cuda", "backup6d_plain",
           "block_args", "slice_args", "digit_path", "backup6d_block",
           "TilePlan", "plan_tiles", "tile_occupancy", "cube_body"]

# the kernels' fixed capacities (csrc/backup6d.cu): backup6d_sweep takes
# at most MAX_TAPS live taps per row or lane axis (kMaxTaps; so at most 27
# row and 27 lane combos), backup6d_wide any taps up to MAX_COMBOS live row
# and MAX_COMBOS live lane combos (kWideCombos; the TPU kernel's
# max_flat_taps, ocdp_tpu/ops/pallas_backup6.py:478); both take MAX_ACTIONS
# actions and the factorized phase's digit base up to MAX_DIGITS
MAX_TAPS = 3
MAX_COMBOS = 40
MAX_ACTIONS = 64
MAX_DIGITS = 3
# past this many (row, lane) elements the tap-liveness encode runs over row
# blocks of about half of it (ocdp_tpu/ops/pallas_backup6.py:320-350)
_LIVE_BLOCK_ELEMS = 200_000_000


def affine_locate(coord: torch.Tensor, start: float, inv_step: float, n: int,
                  edge: str):
    """Uniform-axis locate (``pallas_backup6.py:78``): ``t = (coord -
    start) * inv_step``, ``lo = clip(floor(t), 0, n - 2)``, ``frac = t -
    lo`` (clipped to [0, 1] under ``edge='clamp'``). ``start`` and
    ``inv_step`` are float32 values, the ones the kernel is given. Returns
    ``(lo, frac)``, int32 and float32."""
    t = (coord - start) * inv_step
    lo = torch.clamp(torch.floor(t), 0.0, float(n - 2))
    frac = t - lo
    if edge == "clamp":
        frac = torch.clamp(frac, 0.0, 1.0)
    return lo.to(torch.int32), frac


class LaneRecompute(NamedTuple):
    """Generators of the attitude Euler lanes, in place of a stored lane
    plan (``pallas_backup6.py:102``; 24 B/cell of plan becomes 12 B/row +
    16 B/lane).

    ``row_feats``: the rows' omegas ``(w1, w2, w3)``, each ``(NW,)``
    float32; ``lane_feats``: the lanes' kirk-q components ``(q1, q2, q3,
    q4)``, each ``(NE,)``; ``h`` the time step. A cell's Euler next state is
    :func:`~ocdp_tpu_torch.ops.kernelmath.quat_step_readback` with the
    kernelmath ``atan2_f32``/``asin_f32``, located on each uniform Euler
    axis by :func:`affine_locate` with ``axis_starts``/``axis_inv_steps``
    (float32 values, computed once on the host) over ``axis_sizes`` points.
    The B.5 kernel runs this function op by op.
    """

    h: float
    row_feats: tuple
    lane_feats: tuple
    axis_starts: tuple
    axis_inv_steps: tuple
    axis_sizes: tuple
    edge: str

    def lane_block(self, r0: int, rows: int):
        """``(offs, fracs)`` of the three lane axes for rows ``r0 ..
        r0 + rows``, each ``(rows, NE)``: the located cell minus the lane's
        own index on the axis (int32), and the frac."""
        w = [x[r0:r0 + rows, None] for x in self.row_feats]
        q = [x[None, :] for x in self.lane_feats]
        coords = quat_step_readback(self.h, q, *w, atan2=atan2_f32,
                                    asin=asin_f32)
        own = _lane_own_index(self.axis_sizes, q[0].device)
        offs, fracs = [], []
        for k, coord in enumerate(coords):
            lo, fr = affine_locate(coord, self.axis_starts[k],
                                   self.axis_inv_steps[k], self.axis_sizes[k],
                                   self.edge)
            offs.append(lo - own[k])
            fracs.append(fr)
        return offs, fracs


def _lane_own_index(sizes, device) -> list:
    """Each lane axis's own index as a function of the flat lane, (NE,)
    int32 each."""
    lane = torch.arange(int(np.prod(sizes)), dtype=torch.int32, device=device)
    return [(lane // int(np.prod(sizes[k + 1:]))) % sizes[k]
            for k in range(len(sizes))]


@dataclasses.dataclass(frozen=True, eq=False)
class RecomputePlan:
    """Flat plan whose lane queries live as a :class:`LaneRecompute` spec
    (``pallas_backup6.py:158``): ``lo``/``frac`` carry only the 3 row axes,
    ``(NW, 1, A)`` each; ``spec`` generates the lane axes. Has the
    ``InterpPlan`` surface the engines read."""

    lo: tuple
    frac: tuple
    spec: LaneRecompute
    grid_shape: tuple

    def __post_init__(self):
        if len(self.lo) != 3 or len(self.frac) != 3 or \
                len(self.spec.axis_sizes) != len(self.grid_shape) - 3:
            raise ValueError("a RecomputePlan carries the 3 row axes of a "
                             "6-D grid and a spec of its 3 lane axes")

    @property
    def ndim(self) -> int:
        return len(self.grid_shape)

    @property
    def query_shape(self) -> tuple:
        nw = int(np.prod(self.grid_shape[:3]))
        ne = int(np.prod(self.grid_shape[3:]))
        return (nw, ne, self.lo[0].shape[-1])

    @property
    def device(self) -> torch.device:
        return self.lo[0].device


def plan_is_flat(plan) -> bool:
    """True for plans in the flat (rows, lanes, actions) layout (and
    :class:`RecomputePlan`s) rather than the d-D broadcast layout."""
    return len(plan.query_shape) != plan.ndim + 1


class Backup6DArgs(NamedTuple):
    """The kernel's inputs for one plan, on one device.

    ``row_off``/``row_frac``: ``(3, NW, A)``, the row axes' cell offsets
    (lo minus the row's own index, int32) and fracs. ``lane_off[k]`` /
    ``lane_frac[k]``: ``(NW, NE)``, lane axis k's offsets and fracs.
    ``row_combos`` and ``lane_combos`` (host tuples of per-axis taps,
    sorted) and ``w_taps`` (per row axis, ascending) are the live tap
    structure; ``action_digits`` the digit base m when the actions factor
    as ``A = m**3`` digit by digit, else None. Costs: ``c_row`` (NW,),
    ``c_lane`` (NE,), ``c_act`` (host floats, one per action), optional
    ``c_rowact`` (NW, A) and ``c_rowlane`` (NW, NE). ``argmin_dtype``:
    torch.int32 or torch.uint8; ``track_argmin`` False: a min-only sweep.
    ``lanes``: a :class:`LaneRecompute` (then ``lane_off``/``lane_frac``
    are empty), else None.

    B.7: ``halo = (lo, hi)``, the table rows above and below the output
    rows (then every per-row input holds only the output rows, a block of
    the ``row_shape`` grid); ``actions = (a_lo, a_hi)``, the action range of
    the minimum (None: every action).
    """

    row_shape: tuple
    lane_shape: tuple
    row_off: torch.Tensor
    row_frac: torch.Tensor
    lane_off: tuple
    lane_frac: tuple
    row_combos: tuple
    lane_combos: tuple
    w_taps: tuple
    action_digits: Optional[int]
    c_row: torch.Tensor
    c_lane: torch.Tensor
    c_act: tuple
    c_rowact: Optional[torch.Tensor]
    c_rowlane: Optional[torch.Tensor]
    argmin_dtype: torch.dtype = torch.int32
    track_argmin: bool = True
    lanes: Optional[LaneRecompute] = None
    halo: tuple = (0, 0)
    actions: Optional[tuple] = None

    @property
    def n_actions(self) -> int:
        return self.row_off.shape[-1]

    @property
    def n_rows(self) -> int:
        """Output rows: ``NW``, or the block's rows."""
        return self.row_off.shape[1]

    @property
    def action_range(self) -> tuple:
        return self.actions if self.actions is not None \
            else (0, self.n_actions)

    def row_deltas(self) -> list:
        return _flat_shifts(self.row_combos, self.row_shape)

    def lane_deltas(self) -> list:
        return _flat_shifts(self.lane_combos, self.lane_shape)


def _flat_shifts(combos, shape) -> list:
    strides = [int(np.prod(shape[k + 1:])) for k in range(len(shape))]
    return [sum(t * s for t, s in zip(c, strides)) for c in combos]


def _lane_phase(values: torch.Tensor, args: Backup6DArgs) -> list:
    """``A_j`` of every row combo, ``(rows, NE)`` each; output row r reads
    table row ``r + halo[0] + D_j``."""
    nw, base = args.n_rows, args.halo[0]
    e_taps = [sorted({c[k] for c in args.lane_combos}) for k in range(3)]
    ew = [{t: _tap_weight(args.lane_off[k], args.lane_frac[k], t)
           for t in e_taps[k]} for k in range(3)]
    joint = []
    for combo in args.lane_combos:
        w = None
        for k, t in enumerate(combo):
            w = ew[k][t] if w is None else w * ew[k][t]
        joint.append(w)
    lane_deltas = args.lane_deltas()
    row_deltas = args.row_deltas()
    pad = max(abs(d) for d in row_deltas)
    vp = torch.nn.functional.pad(values, (0, 0, pad, pad))   # zero rows
    out = []
    for d in row_deltas:
        rows = vp[pad + base + d:pad + base + d + nw]
        acc = None
        for w, dl in zip(joint, lane_deltas):
            term = w * _shift_lanes(rows, dl)
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def _action_totals_factorized(A, ww, args: Backup6DArgs):
    """Per-action totals, contracted one action digit at a time
    (``pallas_backup6.py:1269``); yields ``(a, tot_a)`` in action order over
    ``args.action_range`` (whole fixed-d0 slices)."""
    m = args.action_digits
    jidx = {c: j for j, c in enumerate(args.row_combos)}
    t0s = sorted({c[0] for c in args.row_combos})
    t01s = sorted({c[:2] for c in args.row_combos})

    def col(k, t, digit):
        a = digit * m ** (2 - k)          # canonical action with digit k
        return ww[k][t][:, a:a + 1]

    part_b = {}
    for (t0, t1) in t01s:
        for d2 in range(m):
            acc = None
            for t2 in args.w_taps[2]:
                j = jidx.get((t0, t1, t2))
                if j is None:
                    continue
                term = col(2, t2, d2) * A[j]
                acc = term if acc is None else acc + term
            part_b[(t0, t1, d2)] = acc
    part_c = {}
    for t0 in t0s:
        for d1 in range(m):
            for d2 in range(m):
                acc = None
                for t1 in args.w_taps[1]:
                    b = part_b.get((t0, t1, d2))
                    if b is None:
                        continue
                    term = col(1, t1, d1) * b
                    acc = term if acc is None else acc + term
                part_c[(t0, d1, d2)] = acc
    for a in range(*args.action_range):
        d0, rem = divmod(a, m * m)
        d1, d2 = divmod(rem, m)
        tot = None
        for t0 in t0s:
            term = col(0, t0, d0) * part_c[(t0, d1, d2)]
            tot = term if tot is None else tot + term
        yield a, tot


def _action_totals_generic(A, ww, args: Backup6DArgs):
    """Per-action totals over every row combo (``pallas_backup6.py:1215``);
    yields ``(a, tot_a)`` in action order over ``args.action_range``."""
    for a in range(*args.action_range):
        tot = None
        for j, combo in enumerate(args.row_combos):
            w = None
            for k, t in enumerate(combo):
                col = ww[k][t][:, a:a + 1]
                w = col if w is None else w * col
            term = w * A[j]
            tot = term if tot is None else tot + term
        yield a, tot


def backup6d_plain(values: torch.Tensor, args: Backup6DArgs) -> BackupResult:
    """The kernel's function in plain PyTorch, on the kernel's inputs.

    ``values``: the ``(NW, NE)`` table, or in B.7's row-block mode the
    local ``(lo + rows + hi, NE)`` one. Every product and sum is one
    separately rounded PyTorch op, in the kernel's order. With
    ``args.lanes`` the lane (off, frac) are recomputed first
    (:meth:`LaneRecompute.lane_block`), as the B.5 kernel does per cell.
    Returns the ``(rows, NE)`` output rows; the argmin is a global action
    index.
    """
    nw, ne = args.n_rows, values.shape[1]
    if args.lanes is not None:
        offs, fracs = args.lanes.lane_block(0, nw)
        args = args._replace(lane_off=tuple(offs), lane_frac=tuple(fracs))
    A = _lane_phase(values, args)
    ww = [{t: _tap_weight(args.row_off[k], args.row_frac[k], t)
           for t in args.w_taps[k]} for k in range(3)]
    totals = (_action_totals_factorized(A, ww, args) if args.action_digits
              else _action_totals_generic(A, ww, args))
    best = arg = None
    for a, tot in totals:
        if args.c_act[a]:
            tot = tot + args.c_act[a]
        if args.c_rowact is not None:
            tot = tot + args.c_rowact[:, a:a + 1]
        if best is None:
            best = tot
            arg = torch.full((nw, ne), a if args.track_argmin else 0,
                             dtype=torch.int32, device=values.device)
        elif not args.track_argmin:
            # min-only: the same where-min, not torch.minimum (which would
            # let a NaN win)
            best = torch.where(tot < best, tot, best)
        else:
            better = tot < best            # strict: the first minimum wins
            best = torch.where(better, tot, best)
            arg = torch.where(better, a, arg)
    out = best + args.c_row[:, None] + args.c_lane[None, :]
    out = out + (args.c_rowlane if args.c_rowlane is not None else 0.0)
    return BackupResult(out, arg.to(args.argmin_dtype))


def _check_cuda_inputs(values, args: Backup6DArgs) -> None:
    """Every input's shape and dtype, then every input's device and layout.
    Cells are addressed with 64-bit offsets: a grid may pass 2**31
    cells."""
    nw, ne = args.n_rows, int(np.prod(args.lane_shape))
    lo, hi = args.halo
    if nw > int(np.prod(args.row_shape)) or min(lo, hi) < 0:
        raise ValueError(f"{nw} output rows and halo {args.halo} do not fit "
                         f"the row grid {args.row_shape}")
    n_act = args.n_actions
    a_lo, a_hi = args.action_range
    if not 0 <= a_lo < a_hi <= n_act:
        raise ValueError(f"action range {args.actions} leaves [0, {n_act})")
    m = args.action_digits
    if m and (a_lo % (m * m) or a_hi % (m * m)):
        raise ValueError(f"action range {args.actions} is not whole digit "
                         f"slices of {m * m} actions; use the generic phase "
                         "(action_digits None)")
    want = {"values": ((lo + nw + hi, ne), torch.float32, values),
            "row_off": ((3, nw, n_act), torch.int32, args.row_off),
            "row_frac": ((3, nw, n_act), torch.float32, args.row_frac),
            "c_row": ((nw,), torch.float32, args.c_row),
            "c_lane": ((ne,), torch.float32, args.c_lane)}
    if args.lanes is None:
        for k in range(3):
            want[f"lane_off[{k}]"] = ((nw, ne), torch.int32,
                                      args.lane_off[k])
            want[f"lane_frac[{k}]"] = ((nw, ne), torch.float32,
                                       args.lane_frac[k])
    else:
        for k, t in enumerate(args.lanes.row_feats):
            want[f"lanes.row_feats[{k}]"] = ((nw,), torch.float32, t)
        for k, t in enumerate(args.lanes.lane_feats):
            want[f"lanes.lane_feats[{k}]"] = ((ne,), torch.float32, t)
    if args.c_rowact is not None:
        want["c_rowact"] = ((nw, n_act), torch.float32, args.c_rowact)
    if args.c_rowlane is not None:
        want["c_rowlane"] = ((nw, ne), torch.float32, args.c_rowlane)
    for name, (shape, dtype, t) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, (_, _, t) in want.items():
        if t.device != values.device or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}; every input must be "
                             f"on the CUDA device of values ({values.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# The tile planner (csrc/backup6d.cu's Tiles and TilesW): a block owns R
# output rows x L lanes and stages in shared memory the table rows they
# read. A stage is sized for two blocks of 256 threads an SM, or, where the
# lane reach is too wide for that, one block of 512: 16 warps an SM either
# way, at most 128 registers a thread.
TILE_INTS = 9 + 4 * MAX_COMBOS + 4   # kTileInts
MAX_GROUPS = MAX_TAPS * MAX_TAPS  # kMaxGroups: live (t0, t1) pairs
# kRowWeights: the factorized phase's row tap weights a tile row stages in
# backup6d_sweep; backup6d_wide stages COMBO_WEIGHTS a row combo
# (kComboWeights: w_k of its tap k and digit d)
ROW_WEIGHTS = 3 * MAX_TAPS * MAX_DIGITS
COMBO_WEIGHTS = 3 * MAX_DIGITS
MAX_TILE_ROWS = 16
MAX_TILE_LANES = 2048
SM_THREADS = 512
# the cube body (kCubeCells, kCubeThreads): the cells a thread takes,
# consecutive tile rows at one lane, and its block, two an SM; the kernels'
# plan kinds at TilePlan.ints()[8] (kSweepKind, kWideKind, kCubeKind)
CUBE_CELLS = 2
CUBE_THREADS = 256
SWEEP_KIND, WIDE_KIND, CUBE_KIND = 0, 1, 2
# the tap structure the cube body is compiled for
CUBE_TAPS = (-1, 0, 1)
FULL_CUBE = tuple(itertools.product(CUBE_TAPS, repeat=3))
# an H100 SM's shared memory and what the card reserves of it per block
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1_024
# the cost model, in stage reads: one staged value (a copy from L2 or
# device memory), and the factor on a plan of one block an SM, whose copies
# no other block's arithmetic overlaps (fitted to tile sweeps of B.5 at
# 30^3 x 16^3 on an H100; PERF.md §6)
STAGE_COST = 6
ONE_BLOCK_COST = 1.2
# the cube body's plans count whole rounds of the card's resident
# blocks (two on each of an H100's SM_COUNT SMs), and each staged row as a
# loop trip of every thread at STAGE_ROW_COST (fitted to tile sweeps of the
# cube body at 7^3 x 5^3, 11^3 x 10^3 and 13^3 x 12^3 on an H100; PERF.md
# §6)
SM_COUNT = 132
STAGE_ROW_COST = 10


class TilePlan(NamedTuple):
    """One sweep's tiles: output rows ``[i * rows, (i + 1) * rows)`` x lanes
    ``[j * lanes, (j + 1) * lanes)`` for block ``(i, j)`` of ``grid``.

    The block's stage row ``s`` (counted over ``groups`` in order) of group
    ``(delta, n)`` holds table row ``i * rows + table_row0 + delta + (s -
    the group's first stage row)`` over the table lanes ``[j * lanes -
    reach_lo, j * lanes - reach_lo + width)``, 0.0 outside the table.
    Output cell ``(r, c)`` reads row combo k at stage row ``slots[k] + r -
    i * rows`` and lane combo e at stage column ``c - j * lanes + reach_lo
    + dl_e``. After the table rows the block keeps each tile row's
    ``row_weights`` row tap weights of the factorized phase. ``wide``: the
    plan of ``backup6d_wide`` (a tap structure past ``backup6d_sweep``'s 3
    taps an axis), whose stage slots go by row combo; else ``cube`` is
    ``slots`` by cube slot p = (i0 * 3 + i1) * 3 + i2 (-1: not live).
    ``cube_body``: the plan of the cube body (:func:`cube_body`), whose
    thread takes ``CUBE_CELLS`` consecutive rows of a tile at one lane
    (``rows`` is a multiple of ``CUBE_CELLS``, ``threads`` is
    ``CUBE_THREADS``).
    """

    rows: int
    lanes: int
    reach_lo: int
    reach_hi: int
    groups: tuple           # ((delta, n_rows), ...) in stage order
    slots: tuple            # per row combo (args.row_combos order)
    cube: tuple
    threads: int
    n_rows: int             # output rows
    n_lanes: int
    n_table_rows: int
    table_row0: int
    wide: bool
    cube_body: bool = False

    @property
    def kind(self) -> int:
        """The plan's kernel, as the kernel's array holds it."""
        return WIDE_KIND if self.wide else (CUBE_KIND if self.cube_body
                                            else SWEEP_KIND)

    @property
    def row_weights(self) -> int:
        """The factorized phase's row weights a tile row keeps."""
        return COMBO_WEIGHTS * len(self.slots) if self.wide else ROW_WEIGHTS

    @property
    def width(self) -> int:
        return self.lanes + self.reach_lo + self.reach_hi

    @property
    def n_staged(self) -> int:
        return sum(n for _, n in self.groups)

    @property
    def smem_bytes(self) -> int:
        """The table rows' stage and each tile row's row tap weights."""
        return 4 * (self.n_staged * self.width
                    + self.rows * self.row_weights)

    @property
    def grid(self) -> tuple:
        return (-(-self.n_rows // self.rows), -(-self.n_lanes // self.lanes))

    def stage_rows(self, i: int) -> np.ndarray:
        """The table row of each stage row of row tile ``i`` (int64; outside
        ``[0, n_table_rows)`` the stage row is zeros)."""
        return np.concatenate([
            i * self.rows + self.table_row0 + d + np.arange(n, dtype=np.int64)
            for d, n in self.groups])

    def cell_offset(self, i: int, j: int) -> int:
        """The flat output offset of block ``(i, j)``'s first cell."""
        return i * self.rows * self.n_lanes + j * self.lanes

    def ints(self) -> np.ndarray:
        """The kernel's int32 array (``read_tiles`` in csrc/backup6d.cu):
        9 ints (the last :attr:`kind`), the groups' deltas, rows and first
        stage rows (MAX_COMBOS each), the stage slots (by combo when
        ``wide``, else by cube slot; -1 past them), 4 ints."""
        out = np.zeros(TILE_INTS, np.int32)
        out[:9] = (self.rows, self.lanes, self.reach_lo, self.reach_hi,
                   self.width, self.n_staged, len(self.groups),
                   self.row_weights, self.kind)
        first = 0
        for g, (d, n) in enumerate(self.groups):
            out[[9 + g, 9 + MAX_COMBOS + g, 9 + 2 * MAX_COMBOS + g]] = \
                d, n, first
            first += n
        slots = self.slots if self.wide else self.cube
        at = 9 + 3 * MAX_COMBOS
        out[at:at + MAX_COMBOS] = -1
        out[at:at + len(slots)] = slots
        out[-4:] = (*self.grid, self.smem_bytes, self.threads)
        return out


def _row_groups(row_combos, row_shape, rows: int) -> tuple:
    """The stage's row groups for ``rows`` output rows: per live (t0, t1)
    the run of table rows its t2 taps read, merged where runs meet."""
    n1, n2 = row_shape[1], row_shape[2]
    t2s = {}
    for t0, t1, t2 in row_combos:
        t2s.setdefault((t0, t1), []).append(t2)
    spans = sorted(((t0 * n1 + t1) * n2 + min(v),
                    (t0 * n1 + t1) * n2 + max(v) + rows)
                   for (t0, t1), v in t2s.items())
    merged = []
    for lo, hi in spans:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return tuple((lo, hi - lo) for lo, hi in merged)


def _lane_reach(lane_combos, lane_shape) -> tuple:
    """The lanes a stage keeps before and after a tile's: the reach of the
    live lane combos, rounded up to 4 lanes so that the kernel can copy
    4-lane-aligned chunks."""
    dl = _flat_shifts(lane_combos, lane_shape)
    return (-(-max(-min(dl), 0) // 4) * 4, -(-max(max(dl), 0) // 4) * 4)


def plan_tiles(args: Backup6DArgs, n_table_rows: int,
               smem_limit: int) -> TilePlan:
    """The tiles of one sweep of ``args`` over a table of ``n_table_rows``
    rows, on a card that lets a block ask for ``smem_limit`` bytes of shared
    memory: the R x L tile (R <= MAX_TILE_ROWS, L a multiple of 32 up to
    MAX_TILE_LANES) whose stage fits half an SM (two blocks of 256 threads)
    or, failing that, one SM (one block of 512), with the least modelled
    cost: ``STAGE_COST`` a staged value plus one a stage read, over the
    padded cells, times ``ONE_BLOCK_COST`` for one block an SM (the cube
    body: over whole rounds of resident blocks, with ``STAGE_ROW_COST``
    a thread and staged row). The plan
    is ``backup6d_wide``'s (:attr:`TilePlan.wide`) when an axis has more
    than ``MAX_TAPS`` live taps; where :func:`cube_body` holds, the cube
    body's (:attr:`TilePlan.cube_body`: rows a multiple of ``CUBE_CELLS``,
    two blocks of ``CUBE_THREADS`` an SM), or, where no such tile fits,
    ``backup6d_sweep``'s. Raises ``ValueError`` when no tile fits."""
    return _tiles(_plan_key(args), n_table_rows, smem_limit)[0]


def cube_body(args: Backup6DArgs) -> bool:
    """Whether ``args`` are what the cube body is compiled for: 3 live taps
    (-1, 0, 1) on every row and lane axis, all 27 row and 27 lane combos
    live, action digit base 3; a tracking sweep of the whole table (no
    halo) over every action. The lanes may be stored or recomputed
    (``backup6d_sweep_cube`` or ``backup6d_sweep_recompute_cube``), the
    argmin int32 or uint8. Every other launch, and every other structure,
    runs ``backup6d_sweep`` or ``backup6d_wide``."""
    return (args.track_argmin and args.action_digits == 3
            and tuple(args.halo) == (0, 0) and args.actions is None
            and _full_cube(args.w_taps, args.row_combos, args.lane_combos))


@functools.lru_cache(maxsize=64)
def _full_cube(w_taps, row_combos, lane_combos) -> bool:
    """The tap structure half of :func:`cube_body`, once per structure (a
    launch pays a lookup)."""
    def canon(combos):
        return tuple(tuple(int(t) for t in c) for c in combos)

    return (canon(w_taps) == (CUBE_TAPS,) * 3
            and canon(row_combos) == FULL_CUBE
            and canon(lane_combos) == FULL_CUBE)


def _plan_key(args: Backup6DArgs) -> tuple:
    """What the planner reads of ``args``: the tap structure, the shapes,
    the output rows and the halo, and whether the cube body runs
    (:func:`cube_body`)."""
    return (args.row_combos, args.lane_combos, args.w_taps,
            tuple(args.row_shape), tuple(args.lane_shape), args.n_rows,
            tuple(args.halo), cube_body(args))


@functools.lru_cache(maxsize=256)
def _tiles(key, n_table_rows: int, smem_limit: int) -> tuple:
    """``(plan, plan.ints())`` of :func:`plan_tiles`, once per key."""
    (row_combos, lane_combos, w_taps, row_shape, lane_shape, n_rows, halo,
     body) = key
    if n_table_rows != halo[0] + n_rows + halo[1]:
        raise ValueError(f"a table of {n_table_rows} rows for {n_rows} "
                         f"output rows and halo {halo}")
    ne = int(np.prod(lane_shape))
    reach_lo, reach_hi = _lane_reach(lane_combos, lane_shape)
    wide = _wide(w_taps, lane_combos)
    row_weights = COMBO_WEIGHTS * len(row_combos) if wide else ROW_WEIGHTS
    # a work item: one cell, or a cube thread's CUBE_CELLS cells, whose
    # reads its row groups share
    step = CUBE_CELLS if body else 1
    reads = (3 * 9 * 9 * (CUBE_CELLS + 2) if body
             else len(row_combos) * len(lane_combos))
    best = None
    for blocks in ((2,) if body else (2, 1)):
        budget = min(smem_limit, SMEM_PER_SM // blocks - SMEM_RESERVED)
        threads = CUBE_THREADS if body else SM_THREADS // blocks
        for lanes in range(32, min(-(-ne // 32) * 32, MAX_TILE_LANES) + 1,
                           32):
            width = lanes + reach_lo + reach_hi
            for rows in range(step, MAX_TILE_ROWS + 1, step):
                staged = sum(n for _, n in _row_groups(row_combos, row_shape,
                                                       rows))
                if 4 * (staged * width + rows * row_weights) > budget:
                    break
                tiles = -(-n_rows // rows) * -(-ne // lanes)
                passes = -(-(rows // step) * lanes // threads)
                if body:
                    cost = -(-tiles // (2 * SM_COUNT)) * (
                        STAGE_COST * staged * width
                        + STAGE_ROW_COST * staged * threads
                        + reads * passes * threads)
                else:
                    cost = tiles * (STAGE_COST * staged * width
                                    + reads * passes * threads)
                    cost *= 1.0 if blocks == 2 else ONE_BLOCK_COST
                if best is None or cost < best[0]:
                    best = (cost, rows, lanes, threads)
    if best is None and body:
        return _tiles(key[:-1] + (False,), n_table_rows, smem_limit)
    if best is None:
        raise ValueError(f"no tile's stage of a {ne}-lane table with lane "
                         f"reach ({reach_lo}, {reach_hi}) fits {smem_limit} "
                         "bytes of shared memory")
    _, rows, lanes, threads = best
    groups = _row_groups(row_combos, row_shape, rows)
    if len(groups) > (MAX_COMBOS if wide else MAX_GROUPS):
        raise ValueError(f"{len(groups)} row groups exceed the kernel's "
                         f"{MAX_COMBOS if wide else MAX_GROUPS}")
    starts = np.cumsum([0] + [n for _, n in groups])
    slots = []
    for d in _flat_shifts(row_combos, row_shape):
        g = next(g for g, (gd, n) in enumerate(groups)
                 if gd <= d and d + rows <= gd + n)
        slots.append(int(starts[g] + d - groups[g][0]))
    cube = [-1] * 27
    if not wide:
        for combo, slot in zip(row_combos, slots):
            p = 0
            for k, t in enumerate(combo):
                p = p * 3 + list(w_taps[k]).index(t)
            cube[p] = slot
    plan = TilePlan(rows=rows, lanes=lanes, reach_lo=reach_lo,
                    reach_hi=reach_hi, groups=groups, slots=tuple(slots),
                    cube=tuple(cube), threads=threads, n_rows=n_rows,
                    n_lanes=ne, n_table_rows=n_table_rows,
                    table_row0=halo[0], wide=wide, cube_body=body)
    ints = plan.ints()
    ints.flags.writeable = False
    return plan, ints


def _wide(w_taps, lane_combos) -> bool:
    """Whether a tap structure runs ``backup6d_wide``: some row or lane axis
    has more than ``MAX_TAPS`` live taps."""
    e_taps = [{c[k] for c in lane_combos} for k in range(3)]
    return max(len(t) for t in (*w_taps, *e_taps)) > MAX_TAPS


_SMEM_LIMIT = {}


def _smem_limit(lib, device: torch.device) -> int:
    """The shared memory a block may ask for on ``device`` (read once)."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    if dev not in _SMEM_LIMIT:
        with torch.cuda.device(dev):
            _SMEM_LIMIT[dev] = int(lib.backup6d_smem_limit())
    return _SMEM_LIMIT[dev]


def _tiles_for(lib, values: torch.Tensor, args: Backup6DArgs) -> tuple:
    """``(plan, plan.ints())`` for one launch on ``values``'s device."""
    return _tiles(_plan_key(args), values.shape[0],
                  _smem_limit(lib, values.device))


def tile_occupancy(values: torch.Tensor, args: Backup6DArgs) -> tuple:
    """``(plan, blocks)``: the :class:`TilePlan` a launch of the kernel on
    the CUDA tensor ``values`` takes, and how many of its blocks an SM of
    that card holds (the CUDA occupancy query for the launch's kernel,
    mode, block size and stage)."""
    from .. import _build

    lib = _build.load()
    plan = _tiles_for(lib, values, args)[0]
    adt, track = _mode_ints(args)
    with torch.cuda.device(values.device):
        blocks = lib.backup6d_blocks_per_sm(adt, track,
                                            int(args.lanes is not None),
                                            plan.kind, plan.threads,
                                            plan.smem_bytes)
    return plan, blocks


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and \
        b0 < a0 + a.numel() * a.element_size()


def _outputs(values, args: Backup6DArgs, out_v, out_a):
    """The sweep's output buffers: new ones, or the caller's, checked."""
    nw, ne = args.n_rows, values.shape[1]
    if out_v is None:
        out_v = torch.empty((nw, ne), dtype=torch.float32,
                            device=values.device)
    if out_a is None:
        out_a = torch.empty((nw, ne), dtype=args.argmin_dtype,
                            device=values.device)
    for name, t, dtype in (("out_v", out_v, torch.float32),
                           ("out_a", out_a, args.argmin_dtype)):
        if tuple(t.shape) != (nw, ne) or t.dtype != dtype or \
                t.device != values.device or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous {dtype} {(nw, ne)} "
                             f"tensor on {values.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if _overlap(out_v, values):
        raise ValueError("out_v must not overlap the input table (a sweep "
                         "reads every row window of it)")
    return out_v, out_a


def _tap_arrays(args: Backup6DArgs):
    """The host arrays of the tap structure the C entries take, made once
    per structure and costs (a launch pays a lookup: the eager 6-D loop's
    host work a launch is about the cube body's device time)."""
    return _tap_arrays_of(args.w_taps, args.row_combos, args.lane_combos,
                          args.c_act)


@functools.lru_cache(maxsize=64)
def _tap_arrays_of(w_taps_in, row_combos, lane_combos, c_act):
    w_taps = np.zeros((3, MAX_COMBOS), np.int32)
    n_taps = np.zeros(3, np.int32)
    for k, taps in enumerate(w_taps_in):
        w_taps[k, :len(taps)] = taps
        n_taps[k] = len(taps)
    out = (w_taps, n_taps,
           np.ascontiguousarray(row_combos, dtype=np.int32),
           np.ascontiguousarray(lane_combos, dtype=np.int32),
           np.ascontiguousarray(c_act, dtype=np.float32))
    for a in out:
        a.flags.writeable = False
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.backup6d_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _mode_ints(args: Backup6DArgs) -> tuple:
    return (1 if args.argmin_dtype == torch.uint8 else 4,
            int(bool(args.track_argmin)))


@functools.lru_cache(maxsize=64)
def _rec_consts(starts, inv_steps, h):
    """B.5's host constants (``rec_consts``: each Euler axis's float32 first
    point and inverse step, then ``h / 2``), made once per lane
    recompute."""
    out = np.asarray([*starts, *inv_steps, h * 0.5], np.float32)
    out.flags.writeable = False
    return out


def backup6d_cuda(values: torch.Tensor, args: Backup6DArgs,
                  out_v: Optional[torch.Tensor] = None,
                  out_a: Optional[torch.Tensor] = None) -> BackupResult:
    """Launch the CUDA kernel for one sweep on PyTorch's current stream, in
    the mode ``args`` say: a stored lane plan or ``args.lanes`` (B.5), an
    int32 or uint8 argmin, tracking or min-only (all-zero argmin), the
    whole table or a row block with ``args.halo`` (B.7b: ``values`` is the
    local ``(lo + rows + hi, NE)`` table), every action or
    ``args.actions`` (B.7a; global action indices out). ``out_v``/
    ``out_a``: the ``(rows, NE)`` buffers to write (the engines' carry
    mode; views into a larger buffer are fine; ``out_v`` must not overlap
    ``values``), else new ones. Raises on inputs it does not take and on a
    launch the device refuses. The tap structure must fit the kernels'
    capacities, which :class:`Backup6D` checks when it is built; the tile
    plan picks the kernel from ``args``: the cube body where
    :func:`cube_body` holds, else ``backup6d_sweep`` or ``backup6d_wide``
    (:attr:`TilePlan.wide`). Counts every launch in ``.launches`` and
    those of the cube body in ``.cube_launches``."""
    from .. import _build

    rec = args.lanes
    if rec is not None and tuple(rec.axis_sizes) != tuple(args.lane_shape):
        raise ValueError(f"lane axes {rec.axis_sizes} != lane shape "
                         f"{args.lane_shape}")
    _check_cuda_inputs(values, args)
    lib = _build.load()
    out_v, out_a = _outputs(values, args, out_v, out_a)
    w_taps, n_taps, row_combos, lane_combos, c_act = _tap_arrays(args)
    plan, ints = _tiles_for(lib, values, args)
    if rec is None:
        lane_ptrs = [_ptr(t) for pair in zip(args.lane_off, args.lane_frac)
                     for t in pair]
        rec_ptrs = [None] * 8
    else:
        lane_ptrs = [None] * 6
        consts = _rec_consts(tuple(rec.axis_starts),
                             tuple(rec.axis_inv_steps), rec.h)
        rec_ptrs = [*(_ptr(t) for t in rec.row_feats),
                    *(_ptr(t) for t in rec.lane_feats), consts.ctypes.data]
    lo, hi = args.halo
    a_lo, a_hi = args.action_range
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.backup6d_f32(
        _ptr(values), _ptr(args.row_off), _ptr(args.row_frac), *lane_ptrs,
        _ptr(args.c_row), _ptr(args.c_lane), _ptr(args.c_rowact),
        _ptr(args.c_rowlane), _ptr(out_v), _ptr(out_a), *rec_ptrs,
        w_taps.ctypes.data, n_taps.ctypes.data, row_combos.ctypes.data,
        lane_combos.ctypes.data, c_act.ctypes.data, ints.ctypes.data,
        *args.row_shape[1:], *args.lane_shape, args.n_actions,
        len(row_combos), len(lane_combos), args.action_digits or 0,
        *_mode_ints(args), int(rec is not None),
        int(rec is not None and rec.edge == "clamp"), args.n_rows, lo,
        lo + args.n_rows + hi, a_lo, a_hi, stream)
    _raise_on(lib, err, "backup6d")
    backup6d_cuda.launches += 1
    backup6d_cuda.cube_launches += plan.cube_body
    return BackupResult(out_v, out_a)


backup6d_cuda.launches = 0
backup6d_cuda.cube_launches = 0


def block_args(args: Backup6DArgs, r0: int, r1: int, lo: int,
               hi: int) -> Backup6DArgs:
    """B.7's row-block inputs: output rows ``[r0, r1)`` of the full
    analysis ``args``, swept from a local table of ``lo + (r1 - r0) + hi``
    rows starting ``lo`` rows above ``r0``. Per-row inputs become the
    block's rows (views where they are contiguous); the live taps, combos
    and action digits stay the full plan's, so the block's sums keep every
    term of the one-device sweep."""
    if args.halo != (0, 0) or not 0 <= r0 < r1 <= args.n_rows:
        raise ValueError(f"rows [{r0}, {r1}) of a {args.n_rows}-row full "
                         "analysis")
    if min(lo, hi) < 0:
        raise ValueError(f"halo widths ({lo}, {hi}) must be >= 0")

    def rows(t):
        return None if t is None else t[r0:r1].contiguous()

    lanes = args.lanes
    if lanes is not None:
        lanes = lanes._replace(row_feats=tuple(rows(t)
                                               for t in lanes.row_feats))
    return args._replace(
        row_off=args.row_off[:, r0:r1].contiguous(),
        row_frac=args.row_frac[:, r0:r1].contiguous(),
        lane_off=tuple(rows(t) for t in args.lane_off),
        lane_frac=tuple(rows(t) for t in args.lane_frac),
        c_row=rows(args.c_row), c_rowact=rows(args.c_rowact),
        c_rowlane=rows(args.c_rowlane), lanes=lanes, halo=(lo, hi))


def digit_path(args: Backup6DArgs, a_lo: int, a_hi: int) -> bool:
    """Whether actions ``[a_lo, a_hi)`` run the factorized phase: the full
    set factors (``action_digits``) and the range is whole fixed-d0 slices
    (the JAX package's ``digit_slice`` mode, ``pallas_backup6.py:696-724``;
    its host checks, axis 0 constant within a slice and axes 1-2 digit by
    digit, hold for every slice of a set that factors)."""
    m = args.action_digits
    return bool(m) and a_lo % (m * m) == 0 and a_hi % (m * m) == 0


def slice_args(args: Backup6DArgs, a_lo: int, a_hi: int) -> Backup6DArgs:
    """B.7's action-slice inputs: the minimum over actions ``[a_lo, a_hi)``
    of the full-width plan and costs, with global action indices; the
    factorized phase when :func:`digit_path` holds, else the generic
    phase."""
    if not 0 <= a_lo < a_hi <= args.n_actions:
        raise ValueError(f"actions [{a_lo}, {a_hi}) of {args.n_actions}")
    return args._replace(
        actions=(a_lo, a_hi),
        action_digits=args.action_digits if digit_path(args, a_lo, a_hi)
        else None)


def backup6d_block(values: torch.Tensor, args: Backup6DArgs,
                   out_v: torch.Tensor, out_a: torch.Tensor) -> None:
    """One B.7 sweep into ``out_v``/``out_a``: the kernel on a CUDA tensor
    (:func:`backup6d_cuda`), the plain version on a CPU tensor."""
    if values.is_cuda:
        backup6d_cuda(values, args, out_v=out_v, out_a=out_a)
    elif values.device.type == "cpu":
        res = backup6d_plain(values, args)
        out_v.copy_(res.values)
        out_a.copy_(res.argmin)
    else:
        raise ValueError(f"no 6-D backup for device {values.device}")


def _detect_action_digits(w_off, w_frac, nr: int) -> Optional[int]:
    """The digit base m when ``A = m**nr`` and row axis k's (off, frac)
    columns depend only on digit k of the C-order action index, else None
    (``pallas_backup6.py:950-965``)."""
    n_act = w_off[0].shape[1]
    m = round(n_act ** (1.0 / nr))
    if m**nr != n_act or m < 2:
        return None
    for k in range(nr):
        stride = m ** (nr - 1 - k)
        for a in range(n_act):
            rep = (a // stride) % m * stride   # canonical column per digit
            if not (np.array_equal(w_off[k][:, a], w_off[k][:, rep])
                    and np.array_equal(w_frac[k][:, a], w_frac[k][:, rep])):
                return None
    return m


def _encode_count(offs, fracs, base, span, both_corners: bool):
    """Bin counts of the per-element tap encode (``pallas_backup6.py:
    307-318``): the offsets in mixed radix ``span`` from ``base``, then 2
    liveness bits per axis (bit 0: the lo corner has weight, bit 1: the hi
    corner), or both bits set under ``both_corners``."""
    k = len(offs)
    enc = None
    for o, b, s in zip(offs, base, span):
        t = o.to(torch.int64) - b
        enc = t if enc is None else enc * s + t
    if both_corners:
        enc = (enc << (2 * k)) | ((1 << (2 * k)) - 1)
    else:
        for fr in fracs:
            bits = (fr != 1.0).to(torch.int64) | ((fr != 0.0).to(torch.int64)
                                                  << 1)
            enc = (enc << 2) | bits
    nbins = int(np.prod(span)) << (2 * k)
    return torch.bincount(enc.reshape(-1), minlength=nbins)


def _encode_layout(mins, maxs, k: int):
    base = [int(v) for v in mins]
    span = [int(hi) - b + 1 for hi, b in zip(maxs, base)]
    bits = int(np.sum(np.ceil(np.log2(np.maximum(span, 2))))) + 2 * k
    nbins = int(np.prod(span)) << (2 * k)
    if bits >= 31 or nbins > (1 << 24):
        raise ValueError(
            f"lane tap encode needs {bits} bits / {nbins} bins: offsets reach "
            "too far for the 6-D kernel; use the gather backup")
    return base, span


def _row_blocks(nw: int, ne: int) -> tuple:
    """Row blocks of the liveness passes: one block up to
    ``_LIVE_BLOCK_ELEMS`` elements, else blocks of about half of it, the
    last one overlapping backward (counted twice: only which bins are
    nonzero is decoded)."""
    if nw * ne <= _LIVE_BLOCK_ELEMS:
        return nw, [0]
    rows = max(1, (_LIVE_BLOCK_ELEMS // 2) // ne)
    r0s = list(range(0, nw - rows + 1, rows))
    if r0s[-1] + rows < nw:
        r0s.append(nw - rows)
    return rows, r0s


def _lane_live_device(offs, fracs):
    """Live lane taps of a stored flat lane plan, ``(NW, NE)`` offsets and
    fracs on their device (``pallas_backup6.py:286``): the encode and its
    bincount run there, and only the bin counts come to the host."""
    k = len(offs)
    mins = torch.stack([o.min() for o in offs]).cpu().tolist()
    maxs = torch.stack([o.max() for o in offs]).cpu().tolist()
    base, span = _encode_layout(mins, maxs, k)
    nw, ne = offs[0].shape
    rows, r0s = _row_blocks(nw, ne)
    counts = None
    for r0 in r0s:
        c = _encode_count([o[r0:r0 + rows] for o in offs],
                          [f[r0:r0 + rows] for f in fracs], base, span,
                          both_corners=False)
        counts = c if counts is None else counts + c
    vals = torch.nonzero(counts).flatten().cpu().tolist()
    return _decode_live(vals, base, span, k)


def _lane_live_recompute(rec: LaneRecompute, nw: int, ne: int):
    """Live lane taps of a recompute plan (``pallas_backup6.py:355``): the
    encode of :func:`_lane_live_device`, with the lanes regenerated one row
    block at a time by :meth:`LaneRecompute.lane_block` (the function the
    plain B.5 version calls) and both corners of every touched cell
    admitted, so nothing table-sized is kept."""
    k = len(rec.axis_sizes)
    rows = max(1, min(nw, (_LIVE_BLOCK_ELEMS // 2) // max(ne, 1)))
    r0s = [min(r0, nw - rows) for r0 in range(0, nw, rows)]
    mins = maxs = None
    for r0 in r0s:
        offs, _ = rec.lane_block(r0, rows)
        lo_ = torch.stack([o.min() for o in offs])
        hi_ = torch.stack([o.max() for o in offs])
        mins = lo_ if mins is None else torch.minimum(mins, lo_)
        maxs = hi_ if maxs is None else torch.maximum(maxs, hi_)
    base, span = _encode_layout(mins.cpu().tolist(), maxs.cpu().tolist(), k)
    counts = None
    for r0 in r0s:
        offs, _ = rec.lane_block(r0, rows)
        c = _encode_count(offs, None, base, span, both_corners=True)
        counts = c if counts is None else counts + c
    vals = torch.nonzero(counts).flatten().cpu().tolist()
    return _decode_live(vals, base, span, k)


def _broadcast_term(t, shape, nr: int) -> np.ndarray:
    """A flat cost term ``(NW|1, NE|1, A|1)`` in the broadcast layout
    ``(*row_shape|1s, *lane_shape|1s, A|1)`` that ``_split_cost`` takes."""
    t = _as_numpy(t).astype(np.float32, copy=False)
    t = t.reshape((1,) * (3 - t.ndim) + t.shape)
    rows = shape[:nr] if t.shape[0] > 1 else (1,) * nr
    lanes = shape[nr:] if t.shape[1] > 1 else (1,) * (len(shape) - nr)
    return t.reshape(rows + lanes + t.shape[2:])


ARGMIN_DTYPES = (torch.int32, torch.uint8)


class Backup6D:
    """Callable ``values -> BackupResult`` over one 6-D plan and stage cost:
    the first 3 state axes are the rows, the last 3 the lanes.

    ``plan``: an :class:`InterpPlan` in the broadcast layout (queries
    ``(*state_shape, n_actions)``), a flat one (``(NW, 1, A)`` row and
    ``(NW, NE, 1)`` lane arrays), or a :class:`RecomputePlan`.
    ``cost_terms``: broadcast-shaped terms (tensors or arrays; flat plans:
    ``(NW|1, NE|1, A|1)``) summing to the stage cost, split once into row,
    lane, action, row x action and row x lane parts.

    ``argmin_dtype``: torch.int32 or torch.uint8 (the envelope's narrow
    argmin). ``track_argmin=False``: min-only sweeps (the values of a
    tracking sweep, an all-zero argmin); the engines do not use them.
    ``carry_padded``: the engines' carry mode (the JAX package's name;
    nothing is padded here): they call :meth:`sweep_into` with two ``(NW,
    NE)`` tables and one argmin buffer allocated once, and keep flat
    results flat. ``consume_plan``: a flat plan's lane ``lo`` arrays become
    the kernel's offsets in place (the plan's own buffers; the caller's
    plan is invalid afterwards) and its fracs are used as views, so no
    second copy of the 24 B/cell lane plan exists.

    Non-flat plans are analysed on the host, flat and recompute plans on
    their device. Raises ``ValueError`` for a
    plan that is not 6-D or in neither layout, a row axis whose query
    varies along the lanes, a lane axis whose query varies with the action,
    a cost term coupling lanes and actions, and a tap structure beyond the
    kernels' capacities: more than ``MAX_COMBOS`` = 40 live row or lane
    combos (the TPU kernel's ``max_flat_taps``, which refuses the same
    plans), 64 actions or digit base 3. The kernel (:func:`backup6d_cuda`,
    whose tile plan picks the body from the args) runs on a CUDA tensor,
    the plain version on a CPU tensor; there is no other device and no
    fallback from one to the other.
    """

    ROW_AXES = 3

    def __init__(self, plan, cost_terms, *, argmin_dtype=torch.int32,
                 track_argmin: bool = True, carry_padded: bool = False,
                 consume_plan: bool = False):
        if argmin_dtype not in ARGMIN_DTYPES:
            raise ValueError(f"argmin_dtype {argmin_dtype}: use one of "
                             f"{ARGMIN_DTYPES}")
        if plan.query_shape[-1] > torch.iinfo(argmin_dtype).max + 1:
            raise ValueError(f"argmin_dtype {argmin_dtype} cannot index "
                             f"{plan.query_shape[-1]} actions")
        self.argmin_dtype = argmin_dtype
        self.track_argmin = bool(track_argmin)
        self.carry_padded = bool(carry_padded)
        self.flat = plan_is_flat(plan)
        self.recompute = isinstance(plan, RecomputePlan)
        with span("ocdp.backup6d.analyse"):
            if self.flat:
                self.args = self._analyse_flat(plan, cost_terms, consume_plan)
            else:
                self.args = self._analyse(plan, cost_terms)
        n_act = self.args.n_actions
        if max(len(self.row_combos), len(self.lane_combos)) > MAX_COMBOS:
            raise ValueError(
                f"{len(self.row_combos)} row x {len(self.lane_combos)} lane "
                f"flat taps (row taps {self.w_taps}) exceed the kernel's "
                f"max_flat_taps={MAX_COMBOS} live combos, the TPU kernel's "
                "too; use impl='gather'")
        if n_act > MAX_ACTIONS or (self.action_digits or 0) > MAX_DIGITS:
            raise ValueError(
                f"{n_act} actions and digit base {self.action_digits} "
                f"exceed the kernel's {MAX_ACTIONS} actions and digit base "
                f"{MAX_DIGITS}; use impl='gather'")

    def _analyse(self, plan: InterpPlan, cost_terms) -> Backup6DArgs:
        """A non-flat plan, analysed on the host."""
        d, nr = plan.ndim, self.ROW_AXES
        q_shape = plan.query_shape
        if d != 6 or len(q_shape) != d + 1:
            raise ValueError(
                f"Backup6D takes a 6-D plan with (*state_shape, actions) "
                f"queries; got grid {plan.grid_shape}, queries {q_shape}")
        shape = tuple(q_shape[:-1])
        n_act = q_shape[-1]
        self.state_shape = shape
        self.NW = int(np.prod(shape[:nr]))
        self.NE = int(np.prod(shape[nr:]))

        def full_rank(a, dtype):
            a = _as_numpy(a).astype(dtype, copy=False)
            return a.reshape((1,) * (d + 1 - a.ndim) + a.shape)

        with span("ocdp.backup6d.read"):
            lo = [full_rank(x, np.int32) for x in plan.lo]
            fr = [full_rank(x, np.float32) for x in plan.frac]
        w_off, w_frac = _row_plan(lo, fr, shape, nr, n_act)

        # lane axes: offsets and fracs as broadcast views over the state
        # grid (the joint combos need them per cell)
        e_off, e_frac = [], []
        for k in range(nr, d):
            if lo[k].shape[-1] > 1 or fr[k].shape[-1] > 1:
                raise ValueError(
                    f"lane axis {k} query varies with the action — "
                    "not row/lane separable; use the gather backup")
            iota = np.arange(shape[k], dtype=np.int32).reshape(
                (1,) * k + (-1,) + (1,) * (d - 1 - k))
            e_off.append(lo[k][..., 0] - iota)
            e_frac.append(fr[k][..., 0])

        w_taps, row_combos = _corner_live_sets(w_off, w_frac)
        e_taps, lane_combos = _corner_live_sets(e_off, e_frac)
        self._set_taps(w_taps, row_combos, e_taps, lane_combos,
                       _detect_action_digits(w_off, w_frac, nr))

        terms = (list(cost_terms) if isinstance(cost_terms, (tuple, list))
                 else [cost_terms])
        c_row, c_lane, c_act, c_rowact, c_rowlane = _split_cost(
            [full_rank(t, np.float32) for t in terms], shape, nr, n_act)
        self.c_row, self.c_lane, self.c_act = c_row, c_lane, c_act

        def up(a, dtype):
            return _upload(a, dtype, plan.device)

        def lane_table(a, dtype):
            return up(np.broadcast_to(a, shape).reshape(self.NW, self.NE),
                      dtype)

        return Backup6DArgs(
            row_shape=shape[:nr], lane_shape=shape[nr:],
            row_off=up(np.stack(w_off), torch.int32),
            row_frac=up(np.stack(w_frac), torch.float32),
            lane_off=tuple(lane_table(a, torch.int32) for a in e_off),
            lane_frac=tuple(lane_table(a, torch.float32) for a in e_frac),
            row_combos=self.row_combos, lane_combos=self.lane_combos,
            w_taps=self.w_taps, action_digits=self.action_digits,
            c_row=up(c_row, torch.float32), c_lane=up(c_lane, torch.float32),
            c_act=tuple(float(x) for x in c_act),
            c_rowact=up(c_rowact, torch.float32),
            c_rowlane=up(c_rowlane, torch.float32),
            argmin_dtype=self.argmin_dtype, track_argmin=self.track_argmin)

    def _analyse_flat(self, plan, cost_terms, consume: bool) -> Backup6DArgs:
        """A flat or recompute plan, analysed on its device
        (``pallas_backup6.py:488-531, 564-646, 797-819, 856-894``)."""
        nr = self.ROW_AXES
        shape = tuple(plan.grid_shape)
        q_shape = tuple(plan.query_shape)
        if len(shape) != 6 or len(q_shape) != 3:
            raise ValueError(
                f"flat plans are 6-D with (rows, lanes, actions) arrays; got "
                f"grid {shape}, queries {q_shape}")
        self.state_shape = shape
        nw = self.NW = int(np.prod(shape[:nr]))
        ne = self.NE = int(np.prod(shape[nr:]))
        n_act = q_shape[-1]
        if q_shape[:2] != (nw, ne):
            raise ValueError(f"flat plan rows/lanes {q_shape[:2]} do not "
                             f"match the 3 + 3 split of grid {shape}")
        dev = plan.device

        # row plan: (NW, 1, A) arrays, minus each row's own index
        row_own = _lane_own_index(shape[:nr], dev)
        w_off, w_frac = [], []
        for k in range(nr):
            lo, fr = plan.lo[k], plan.frac[k]
            if lo.shape[1] > 1 or fr.shape[1] > 1:
                raise ValueError(
                    f"row axis {k} query varies along lane axes — "
                    "not row/lane separable; use the gather backup")
            w_off.append((lo[:, 0, :].to(torch.int32) - row_own[k][:, None])
                         .expand(nw, n_act))
            w_frac.append(fr[:, 0, :].to(torch.float32).expand(nw, n_act))
        row_off = torch.stack(w_off).contiguous()
        row_frac = torch.stack(w_frac).contiguous()
        # the row analysis is (3, NW, A): small, on the host
        with span("ocdp.backup6d.read"):
            w_off_h, w_frac_h = list(row_off.cpu().numpy()), \
                list(row_frac.cpu().numpy())
        w_taps, row_combos = _corner_live_sets(w_off_h, w_frac_h)
        digits = _detect_action_digits(w_off_h, w_frac_h, nr)

        lanes = None
        lane_off, lane_frac = (), ()
        if self.recompute:
            lanes = plan.spec
            if tuple(lanes.axis_sizes) != shape[nr:] or \
                    len(lanes.row_feats) != 3 or len(lanes.lane_feats) != 4:
                raise ValueError("the lane recompute spec does not match the "
                                 f"grid {shape}")
            e_taps, lane_combos = _lane_live_recompute(lanes, nw, ne)
        else:
            own = _lane_own_index(shape[nr:], dev)
            for k in range(nr, 6):
                lo, fr = plan.lo[k], plan.frac[k]
                if lo.shape[-1] > 1 or fr.shape[-1] > 1:
                    raise ValueError(
                        f"lane axis {k} query varies with the action — "
                        "not row/lane separable; use the gather backup")
                if consume and lo.dtype == torch.int32 and \
                        tuple(lo.shape) == (nw, ne, 1) and lo.is_contiguous():
                    off = lo.view(nw, ne)
                    off.sub_(own[k - nr])       # in place: the plan's buffer
                else:
                    off = (lo[..., 0].to(torch.int32) - own[k - nr]) \
                        .expand(nw, ne).contiguous()
                lane_off += (off,)
                lane_frac += (fr[..., 0].to(torch.float32).expand(nw, ne)
                              .contiguous(),)
            e_taps, lane_combos = _lane_live_device(lane_off, lane_frac)
        self._set_taps(w_taps, row_combos, e_taps, lane_combos, digits)

        terms = (list(cost_terms) if isinstance(cost_terms, (tuple, list))
                 else [cost_terms])
        c_row, c_lane, c_act, c_rowact, c_rowlane = _split_cost(
            [_broadcast_term(t, shape, nr) for t in terms], shape, nr, n_act)
        self.c_row, self.c_lane, self.c_act = c_row, c_lane, c_act
        return Backup6DArgs(
            row_shape=shape[:nr], lane_shape=shape[nr:], row_off=row_off,
            row_frac=row_frac, lane_off=lane_off, lane_frac=lane_frac,
            row_combos=self.row_combos, lane_combos=self.lane_combos,
            w_taps=self.w_taps, action_digits=self.action_digits,
            c_row=_upload(c_row, torch.float32, dev),
            c_lane=_upload(c_lane, torch.float32, dev),
            c_act=tuple(float(x) for x in c_act),
            c_rowact=_upload(c_rowact, torch.float32, dev),
            c_rowlane=_upload(c_rowlane, torch.float32, dev),
            argmin_dtype=self.argmin_dtype, track_argmin=self.track_argmin,
            lanes=lanes)

    def _set_taps(self, w_taps, row_combos, e_taps, lane_combos, digits):
        self.w_taps = tuple(tuple(t) for t in w_taps)
        self.e_taps = tuple(tuple(t) for t in e_taps)
        self.row_combos = tuple(row_combos)
        self.lane_combos = tuple(lane_combos)
        self.action_digits = digits

    def row_reach(self) -> tuple:
        """``(lo, hi)``: the table rows above and below its own that a
        sweep reads, the exact reach of the live row combos (B.7's halo
        widths)."""
        d = self.args.row_deltas()
        return max(-min(d), 0), max(max(d), 0)

    def _run(self, fn, values: torch.Tensor) -> BackupResult:
        res = fn(values.reshape(self.NW, self.NE).contiguous(), self.args)
        return BackupResult(res.values.reshape(self.state_shape),
                            res.argmin.reshape(self.state_shape))

    def __call__(self, values: torch.Tensor) -> BackupResult:
        if values.is_cuda:
            return self._run(backup6d_cuda, values)
        if values.device.type == "cpu":
            return self._run(backup6d_plain, values)
        raise ValueError(f"no 6-D backup for device {values.device}")

    def plain(self, values: torch.Tensor) -> BackupResult:
        """The plain PyTorch version on any device (the ``'plain'`` impl of
        the attitude solves)."""
        return self._run(backup6d_plain, values)

    def sweep_into(self, v_in: torch.Tensor, v_out: torch.Tensor,
                   a_out: torch.Tensor) -> None:
        """Carry mode: one sweep of the ``(NW, NE)`` table ``v_in`` into
        ``v_out`` (float32) and ``a_out`` (``argmin_dtype``), buffers the
        caller allocated once (the counterpart of ``sweep_carry``,
        ``pallas_backup6.py:1475``). The kernel on CUDA tensors, the plain
        version on CPU tensors."""
        if not self.carry_padded:
            raise ValueError("backup was not built with carry_padded=True")
        if v_in.is_cuda:
            backup6d_cuda(v_in, self.args, out_v=v_out, out_a=a_out)
        elif v_in.device.type == "cpu":
            res = backup6d_plain(v_in, self.args)
            v_out.copy_(res.values)
            a_out.copy_(res.argmin)
        else:
            raise ValueError(f"no 6-D backup for device {v_in.device}")
