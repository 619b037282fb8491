"""Row/lane Bellman backup: the CUDA kernel, its plain version, its wrapper.

Replaces the TPU kernel ``ocdp_tpu/ops/pallas_backup6.py::PallasBackup6D``
in its lane-separable mode (``_kernel``'s separable branch followed by
``_action_phase_generic``), behind ``PermutedRowLaneBackup``, on the pos-att
main path. The kernel source, with the note on its arithmetic, tie order and
what bounds it, is ``csrc/rowlane_backup.cu``.

The state axes are split, after a permutation, into ROW axes, whose next
states depend on the action (pos-att: v, omega), and LANE axes, whose next
states do not and each depend only on the rows and their own coordinate
(pos-att: x' = x + h v, theta' = theta + h omega). The value table is then a
``(NW, NE)`` matrix, and one sweep is, per cell (row r, lane c):

1. for each live row combo j (flat row shift D_j), the lane interpolation
   A_j of table row r + D_j: one lerp pass per lane axis, innermost first,
   each the sum over that axis's live taps t of ``we(r, c) * cur[c + t*s]``;
2. per action a: ``tot_a = sum_j (prod_k ww_k(r, a)) * A_j`` + the action
   cost, with the strict-``<`` first-minimum chain from action 0;
3. ``best + c_row[r] + c_lane[c] (+ c_rowlane[r, c])``.

Tap weights are ``(off == t ? 1-f : 0) + (off == t-1 ? f : 0)``. A read that
leaves the table (a row outside ``[0, NW)`` or a lane outside ``[0, NE)``)
reads 0.0 and always carries an exactly zero weight.

* :func:`rowlane_backup_cuda` launches the kernel;
  ``rowlane_backup_cuda.launches`` counts its launches.
* :func:`rowlane_backup_plain` is the same function in plain PyTorch on the
  same inputs, in the same order of operations. On a CUDA device the two
  agree bitwise.
* :class:`RowLaneBackup` analyses a plan once where it lies (live taps
  through :func:`~.liveness.live_sets`, the cost split) and is the engines'
  ``values -> BackupResult`` callable: the kernel on a CUDA tensor, the
  plain version on a CPU tensor.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..profiling import span
from .backup import BackupResult
from .interp import InterpPlan
from .liveness import live_sets, to_host

__all__ = ["RowLaneArgs", "RowLaneBackup", "RowLaneBatch", "RowLaneTiles",
           "plan_tiles", "rowlane_backup_cuda", "rowlane_backup_plain"]

# the kernel's fixed capacities (kMaxLaneTaps, kMaxRowCombos, kMaxActions in
# csrc/rowlane_backup.cu): 40 live row combos and 40 live lane combos is the
# TPU kernel's max_flat_taps (ocdp_tpu/ops/pallas_backup6.py:478, checked
# at :732-736), so a lane axis has at most 40 live taps; the high-res y
# channel has 17 row combos, a simplified attitude axis at n_mesh_t=1500
# 21 lane taps
MAX_LANE_TAPS = 40
MAX_ROW_COMBOS = 40
MAX_LANE_COMBOS = 40
MAX_ACTIONS = 64


class RowLaneArgs(NamedTuple):
    """The kernel's inputs for one plan, on one device.

    ``row_off``/``row_frac``: ``(nr, NW, A)``, the row axes' cell offsets
    (lo minus the row's own index, int32) and fracs. ``lane_off[k]`` /
    ``lane_frac[k]``: ``(NW, n_k)``, lane axis k's offsets and fracs as a
    function of the row and the lane's own coordinate on axis k.
    ``row_combos`` (host tuples of per-row-axis taps, sorted) and
    ``lane_taps`` (per lane axis, ascending) are the live tap structure.
    Costs: ``c_row`` (NW,), ``c_lane`` (NE,), ``c_act`` (host floats, one
    per action), optional ``c_rowact`` (NW, A) and ``c_rowlane`` (NW, NE).
    """

    row_shape: tuple
    lane_shape: tuple
    row_off: torch.Tensor
    row_frac: torch.Tensor
    lane_off: tuple
    lane_frac: tuple
    row_combos: tuple
    lane_taps: tuple
    c_row: torch.Tensor
    c_lane: torch.Tensor
    c_act: tuple
    c_rowact: Optional[torch.Tensor]
    c_rowlane: Optional[torch.Tensor]

    @property
    def n_actions(self) -> int:
        return self.row_off.shape[-1]

    def row_deltas(self) -> list:
        strides = [int(np.prod(self.row_shape[k + 1:]))
                   for k in range(len(self.row_shape))]
        return [sum(t * s for t, s in zip(c, strides))
                for c in self.row_combos]

    def lane_strides(self) -> list:
        return [int(np.prod(self.lane_shape[k + 1:]))
                for k in range(len(self.lane_shape))]


def _tap_weight(off, frac, t):
    """(off == t ? 1 - frac : 0) + (off == t - 1 ? frac : 0)."""
    return torch.where(off == t, 1.0 - frac, 0.0) \
        + torch.where(off == t - 1, frac, 0.0)


def _shift_lanes(cur, s: int):
    """``out[:, c] = cur[:, c + s]``, 0.0 where ``c + s`` leaves the row."""
    if s == 0:
        return cur
    out = torch.zeros_like(cur)
    ne = cur.shape[1]
    if abs(s) < ne:
        if s > 0:
            out[:, :ne - s] = cur[:, s:]
        else:
            out[:, -s:] = cur[:, :ne + s]
    return out


def rowlane_backup_plain(values: torch.Tensor,
                         args: RowLaneArgs) -> BackupResult:
    """The kernel's function in plain PyTorch, on the kernel's inputs.

    ``values``: the ``(NW, NE)`` table. Every product and sum is one
    separately rounded PyTorch op, in the kernel's order.
    """
    nw, ne = values.shape
    n_lane = len(args.lane_shape)
    strides = args.lane_strides()
    lane_idx = torch.arange(ne, device=values.device)
    lane_w = []
    for k, (n_k, s_k) in enumerate(zip(args.lane_shape, strides)):
        own = (lane_idx // s_k) % n_k
        off, fr = args.lane_off[k][:, own], args.lane_frac[k][:, own]
        lane_w.append({t: _tap_weight(off, fr, t) for t in args.lane_taps[k]})
    deltas = args.row_deltas()
    pad = max(abs(d) for d in deltas)
    vp = torch.nn.functional.pad(values, (0, 0, pad, pad))   # zero rows
    shifted = []
    for d in deltas:
        cur = vp[pad + d:pad + d + nw]
        for k in range(n_lane - 1, -1, -1):            # innermost first
            acc = None
            for t in args.lane_taps[k]:
                term = lane_w[k][t] * _shift_lanes(cur, t * strides[k])
                acc = term if acc is None else acc + term
            cur = acc
        shifted.append(cur)

    row_w = [{t: _tap_weight(args.row_off[k], args.row_frac[k], t)
              for t in sorted({c[k] for c in args.row_combos})}
             for k in range(len(args.row_shape))]
    best = arg = None
    for a in range(args.n_actions):
        tot = None
        for j, combo in enumerate(args.row_combos):
            w = None
            for k, t in enumerate(combo):
                col = row_w[k][t][:, a:a + 1]
                w = col if w is None else w * col
            term = w * shifted[j]
            tot = term if tot is None else tot + term
        if args.c_act[a]:
            tot = tot + args.c_act[a]
        if args.c_rowact is not None:
            tot = tot + args.c_rowact[:, a:a + 1]
        if best is None:
            best = tot
            arg = torch.zeros((nw, ne), dtype=torch.int32,
                              device=values.device)
        else:
            better = tot < best            # strict: the first minimum wins
            best = torch.where(better, tot, best)
            arg = torch.where(better, a, arg)
    out = best + args.c_row[:, None] + args.c_lane[None, :]
    out = out + (args.c_rowlane if args.c_rowlane is not None else 0.0)
    return BackupResult(out, arg)


def _check_args(args: RowLaneArgs) -> None:
    """Shapes, types, device and layout of a plan's fixed inputs; checked
    once, when :class:`RowLaneBackup` builds them."""
    if len(args.row_shape) != 2 or len(args.lane_shape) != 2:
        raise ValueError(
            f"the rowlane kernel takes 2 row and 2 lane axes, got rows "
            f"{args.row_shape} and lanes {args.lane_shape}")
    nw, ne = int(np.prod(args.row_shape)), int(np.prod(args.lane_shape))
    if nw * ne >= 2**31:
        raise ValueError(f"{nw}x{ne} cells exceed the kernel's int32 index")
    n_act = args.n_actions
    want = {"row_off": ((2, nw, n_act), torch.int32, args.row_off),
            "row_frac": ((2, nw, n_act), torch.float32, args.row_frac),
            "c_row": ((nw,), torch.float32, args.c_row),
            "c_lane": ((ne,), torch.float32, args.c_lane)}
    for k, n_k in enumerate(args.lane_shape):
        want[f"lane_off[{k}]"] = ((nw, n_k), torch.int32, args.lane_off[k])
        want[f"lane_frac[{k}]"] = ((nw, n_k), torch.float32,
                                   args.lane_frac[k])
    if args.c_rowact is not None:
        want["c_rowact"] = ((nw, n_act), torch.float32, args.c_rowact)
    if args.c_rowlane is not None:
        want["c_rowlane"] = ((nw, ne), torch.float32, args.c_rowlane)
    dev = args.row_off.device
    for name, (shape, dtype, t) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the row plan on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# the kernel's layout of one launch (csrc/rowlane_backup.cu): channels,
# stage row groups, ints a channel (Chan), ints of the tile (Batch)
MAX_BATCH = 4
MAX_GROUPS = 8
CHAN_INTS = 12 + 3 * MAX_GROUPS + 3 * MAX_ROW_COMBOS + 2 * MAX_LANE_TAPS
TILE_INTS = 12
THREADS = 256
# the instantiations (kernel_of in csrc/rowlane_backup.cu): kinds 0, 1 and
# 3 take lane taps of exactly TAPS3 on both axes and at most 12, 20 or 40
# row combos, kinds 2 and 4 any taps and at most 32 or 40 combos
TAPS3 = (-1, 0, 1)
KIND_COMBOS = (12, 20, 32, MAX_ROW_COMBOS, MAX_ROW_COMBOS)
KIND_TAPS3 = (True, True, False, True, False)
# the planner's budget: four blocks of 256 threads an SM (of its 228 KB,
# 1 KB reserved a block) on the 132 SMs of an H100. Its cost model (fitted
# to tile sweeps of the four pos-att channels at both sizes on an H100,
# PERF.md §6): the rounds of BLOCKS_PER_SM blocks the busiest SM runs,
# each the time of one block's cells (1 a cell), its stage (STAGE_COST a
# staged value) and its row and lane weights (WEIGHT_COST each)
SMEM_PER_SM = 233_472
SMEM_RESERVED = 1024
BLOCKS_PER_SM = 4
SM_COUNT = 132
MAX_TILE_ROWS = 8
MAX_TILE_LANES = 1024
STAGE_COST = 0.1
WEIGHT_COST = 1.0


class RowLaneTiles(NamedTuple):
    """One launch's tiles: block ``(i, j, ch)`` owns rows ``[i * rows, (i +
    1) * rows)`` x lanes ``[j * lanes, (j + 1) * lanes)`` of channel ``ch``.

    Channel ``ch``'s stage row ``s`` of its group ``(delta, n)`` (its
    ``groups[ch]``, in stage order) holds table row ``i * rows + delta + (s
    - the group's first stage row)`` over the table lanes ``[j * lanes -
    reach_lo, j * lanes - reach_lo + width)``, 0.0 outside the table. Cell
    ``(r, c)`` reads row combo k at stage row ``slots[ch][k] + r - i *
    rows`` and lane shift s at stage column ``c - j * lanes + reach_lo +
    s``. After the stages (``rw_at`` floats) each tile row's joint row
    weights ``[action][combo, padded to 4]``, and from ``lw_at`` its lane
    tap weights ``[tap][slot]`` of the tile's lane coordinates
    (:func:`_lane_slots`), lane axis 0 then 1.
    """

    rows: int
    lanes: int
    reach_lo: int
    reach_hi: int
    groups: tuple        # per channel: ((delta, n_rows), ...)
    slots: tuple         # per channel: one stage row per row combo
    rw_at: int
    lw_at: int
    smem_bytes: int
    grid: tuple          # (row tiles, lane tiles, channels)
    kind: int

    @property
    def width(self) -> int:
        return self.lanes + self.reach_lo + self.reach_hi

    @property
    def n_staged(self) -> int:
        return max(sum(n for _, n in g) for g in self.groups)

    @property
    def threads(self) -> int:
        return THREADS

    def stage_rows(self, ch: int, i: int) -> np.ndarray:
        """The table row of each stage row of channel ``ch``'s row tile
        ``i`` (outside ``[0, NW)`` the stage row is zeros)."""
        return np.concatenate([i * self.rows + d + np.arange(n)
                               for d, n in self.groups[ch]])


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _lane_slots(lane_shape, lanes: int) -> tuple:
    """The lane coordinates a tile of ``lanes`` lanes keeps tap weights of:
    on axis 0 the at most ``(lanes - 1) // n_l1 + 2`` its lanes span, on
    axis 1 all ``n_l1`` when a tile spans a whole run of them, else one a
    tile lane."""
    n_l0, n_l1 = lane_shape
    return (min(n_l0, (lanes - 1) // n_l1 + 2),
            n_l1 if lanes >= n_l1 else lanes)


def _row_deltas(combos, row_shape) -> list:
    return [t0 * row_shape[1] + t1 for t0, t1 in combos]


def _lane_shifts(lane_taps, lane_shape) -> list:
    return [t0 * lane_shape[1] + t1 for t0 in lane_taps[0]
            for t1 in lane_taps[1]]


def _row_groups(combos, row_shape, rows: int) -> tuple:
    """The stage's row groups for ``rows`` tile rows: per live row-axis-0
    tap the run of table rows its row-axis-1 taps read, merged where runs
    meet."""
    t1s = {}
    for t0, t1 in combos:
        t1s.setdefault(t0, []).append(t1)
    spans = sorted((t0 * row_shape[1] + min(v), t0 * row_shape[1] + max(v)
                    + rows) for t0, v in t1s.items())
    merged = []
    for lo, hi in spans:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return tuple((lo, hi - lo) for lo, hi in merged)


def _plan_key(args: RowLaneArgs) -> tuple:
    """What the planner and the launch's ints read of one channel's
    ``args``: its shapes, actions, tap structure and action costs."""
    return (tuple(args.row_shape), tuple(args.lane_shape), args.n_actions,
            tuple(args.row_combos), tuple(tuple(t) for t in args.lane_taps),
            tuple(float(c) for c in args.c_act))


def _kind(keys) -> int:
    """The kernel instantiation a launch over the channels ``keys`` takes
    (``kernel_of`` in csrc/rowlane_backup.cu)."""
    combos = max(len(k[3]) for k in keys)
    taps3 = all(tuple(k[4]) == (TAPS3, TAPS3)
                and 2 * k[1][1] <= MAX_TILE_LANES for k in keys)
    return next(kind for kind in ((0, 1, 3) if taps3 else (2, 4))
                if combos <= KIND_COMBOS[kind])


def plan_tiles(keys, smem_limit: int) -> RowLaneTiles:
    """The tiles of one launch over the channels ``keys`` (:func:`_plan_key`
    of each), on a card that lets a block ask for ``smem_limit`` bytes of
    shared memory: the R x L tile (R <= MAX_TILE_ROWS, L up to
    MAX_TILE_LANES, a multiple of :func:`lane_step`) whose stage fits
    ``BLOCKS_PER_SM`` blocks an SM, with the least modelled time: the
    rounds of ``BLOCKS_PER_SM`` blocks the busiest SM runs, each a block's
    padded cells, ``STAGE_COST`` a staged value and ``WEIGHT_COST`` a row or
    lane weight. Raises ``ValueError`` when no tile fits."""
    return _tiles(tuple(keys), smem_limit)[0]


def lane_step(keys) -> int:
    """What a tile's lane count is a multiple of. A thread takes two cells
    of a tile row: in the (-1, 0, 1)-tap kernels lanes c and c + n_l1,
    whose axis-1 passes overlap (so a tile holds whole runs of 2 n_l1
    lanes, and 8 for the 16-byte stage copies), else lanes l and l + L/2
    (64)."""
    if not KIND_TAPS3[_kind(keys)]:
        return 64
    return math.lcm(8, *(2 * k[1][1] for k in keys))


@functools.lru_cache(maxsize=64)
def _tiles(keys: tuple, smem_limit: int) -> tuple:
    """``(plan, chan_ints, c_act, tile_ints)`` of :func:`plan_tiles`, once
    per key."""
    if not 1 <= len(keys) <= MAX_BATCH:
        raise ValueError(f"{len(keys)} channels in one launch; the kernel "
                         f"takes 1 to {MAX_BATCH}")
    nw = max(int(np.prod(k[0])) for k in keys)
    ne = max(int(np.prod(k[1])) for k in keys)
    shifts = [s for k in keys for s in _lane_shifts(k[4], k[1])]
    reach_lo = _round4(max(-min(shifts), 0))
    reach_hi = _round4(max(max(shifts), 0))
    budget = min(smem_limit, SMEM_PER_SM // BLOCKS_PER_SM - SMEM_RESERVED)

    def layout(rows, lanes):
        groups = [_row_groups(k[3], k[0], rows) for k in keys]
        staged = max(sum(n for _, n in g) for g in groups)
        rw_at = staged * (lanes + reach_lo + reach_hi)
        lw_at = rw_at + _round4(rows * max(k[2] * _round4(len(k[3]))
                                           for k in keys))
        end = lw_at + rows * max(
            len(k[4][0]) * n0 + len(k[4][1]) * n1
            for k in keys for n0, n1 in [_lane_slots(k[1], lanes)])
        return groups, rw_at, lw_at, 4 * _round4(end), staged, end - rw_at

    best = None
    step = lane_step(keys)
    for lanes in range(step, min(-(-ne // step) * step, MAX_TILE_LANES) + 1,
                       step):
        width = lanes + reach_lo + reach_hi
        for rows in range(1, MAX_TILE_ROWS + 1):
            *_, smem, staged, weights = layout(rows, lanes)
            if smem > budget:
                break
            blocks = -(-nw // rows) * -(-ne // lanes) * len(keys)
            rounds = -(-(-(-blocks // SM_COUNT)) // BLOCKS_PER_SM)
            cost = rounds * (rows * lanes + STAGE_COST * staged * width
                             + WEIGHT_COST * weights)
            if best is None or cost < best[0]:
                best = (cost, rows, lanes)
    if best is None:
        raise ValueError(f"no tile's stage of a {ne}-lane table with lane "
                         f"reach ({reach_lo}, {reach_hi}) fits {budget} "
                         "bytes of shared memory")
    _, rows, lanes = best
    width = lanes + reach_lo + reach_hi
    groups, rw_at, lw_at, smem, _, _ = layout(rows, lanes)
    if max(len(g) for g in groups) > MAX_GROUPS:
        raise ValueError(f"more than {MAX_GROUPS} stage row groups")
    slots = []
    for k, g in zip(keys, groups):
        starts = np.cumsum([0] + [n for _, n in g])
        slot = []
        for d in _row_deltas(k[3], k[0]):
            i = next(i for i, (gd, n) in enumerate(g)
                     if gd <= d and d + rows <= gd + n)
            slot.append(int(starts[i] + d - g[i][0]))
        slots.append(tuple(slot))
    plan = RowLaneTiles(
        rows=rows, lanes=lanes, reach_lo=reach_lo, reach_hi=reach_hi,
        groups=tuple(groups), slots=tuple(slots), rw_at=rw_at, lw_at=lw_at,
        smem_bytes=smem, grid=(-(-nw // rows), -(-ne // lanes), len(keys)),
        kind=_kind(keys))
    ints = np.zeros((len(keys), CHAN_INTS), np.int32)
    c_act = np.zeros((len(keys), MAX_ACTIONS), np.float32)
    for ch, (k, g, sl) in enumerate(zip(keys, groups, slots)):
        (n_r0, n_r1), (n_l0, n_l1), n_act, combos, taps, costs = k
        row = ints[ch]
        row[:12] = (n_r0, n_r1, n_l0, n_l1, n_act, len(combos), len(taps[0]),
                    len(taps[1]), _round4(len(combos)), len(g),
                    *_lane_slots((n_l0, n_l1), lanes))
        at = 12
        for i, (d, n) in enumerate(g):
            row[at + i] = d
            row[at + MAX_GROUPS + i] = n
            row[at + 2 * MAX_GROUPS + i] = int(sum(m for _, m in g[:i]))
        at += 3 * MAX_GROUPS
        for j, (t0, t1) in enumerate(combos):
            row[at + j] = t0
            row[at + MAX_ROW_COMBOS + j] = t1
            row[at + 2 * MAX_ROW_COMBOS + j] = sl[j]
        at += 3 * MAX_ROW_COMBOS
        row[at:at + len(taps[0])] = taps[0]
        row[at + MAX_LANE_TAPS:at + MAX_LANE_TAPS + len(taps[1])] = taps[1]
        c_act[ch, :n_act] = costs
    tile = np.zeros(TILE_INTS, np.int32)
    tile[:11] = (rows, lanes, reach_lo, reach_hi, width, rw_at, lw_at, smem,
                 plan.grid[0], plan.grid[1], plan.kind)
    for a in (ints, c_act, tile):
        a.flags.writeable = False
    return plan, ints, c_act, tile


_CONFIGURED = {}


def _smem_limit(lib, device: torch.device) -> int:
    from .backup6d import _smem_limit as limit

    return limit(lib, device)


def configure(lib, device: torch.device, plan: RowLaneTiles) -> None:
    """Raise the dynamic shared memory limit of ``plan``'s kernel on
    ``device`` to its stage, once: before a launch and before a CUDA graph
    captures one (a capture then sets no attribute)."""
    dev = device.index if device.index is not None \
        else torch.cuda.current_device()
    if _CONFIGURED.get((dev, plan.kind), -1) >= plan.smem_bytes:
        return
    with torch.cuda.device(dev):
        err = lib.rowlane_backup_configure(plan.kind, plan.smem_bytes)
    if err != 0:
        msg = lib.rowlane_backup_error_string(err).decode()
        raise RuntimeError(
            f"rowlane_backup: {plan.smem_bytes} B of shared memory refused: "
            f"CUDA error {err} ({msg})")
    _CONFIGURED[(dev, plan.kind)] = plan.smem_bytes


def launch_plan(values: torch.Tensor, args) -> RowLaneTiles:
    """The :class:`RowLaneTiles` a launch over the channels ``args`` takes
    on ``values``' CUDA device, with that device's kernel configured for
    it."""
    from .. import _build

    lib = _build.load()
    plan = _tiles(tuple(_plan_key(a) for a in args),
                  _smem_limit(lib, values.device))[0]
    configure(lib, values.device, plan)
    return plan


def tile_occupancy(values: torch.Tensor, args) -> tuple:
    """``(plan, blocks)``: the :class:`RowLaneTiles` a launch over the
    channels ``args`` on the CUDA tensor ``values`` takes, and how many of
    its blocks an SM of that card holds (the CUDA occupancy query)."""
    from .. import _build

    plan = launch_plan(values, args)
    with torch.cuda.device(values.device):
        blocks = _build.load().rowlane_backup_blocks_per_sm(plan.kind,
                                                            plan.smem_bytes)
    return plan, blocks


def _check_table(name, t, shape, dtype, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} is on {t.device}; every table must be on "
                         f"the CUDA device of the plan ({device})")
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def rowlane_backup_cuda(values, args, out_v=None, out_a=None):
    """Launch the CUDA kernel for one sweep on PyTorch's current stream.

    One channel: ``values`` an ``(NW, NE)`` table, ``args`` its
    :class:`RowLaneArgs`; returns a :class:`BackupResult` in new tensors or
    in the caller's ``out_v``/``out_a``. A batch (one launch): sequences of
    up to ``MAX_BATCH`` tables, of their args and of the caller's output
    tables, which the launch fills; returns ``BackupResult(out_v, out_a)``.
    An output may not be its input table. Per call only the tables are
    checked (the args were checked when :class:`RowLaneBackup` built them);
    raises on tables it does not take and on a launch the device refuses.
    Given its outputs the launch allocates nothing, and it sets no function
    attribute (:func:`launch_plan` does, first), so a CUDA graph may capture
    it. ``rowlane_backup_cuda.launches`` counts launches and
    ``.channel_sweeps`` the channels they swept."""
    from .. import _build

    single = isinstance(values, torch.Tensor)
    if single:
        values, args = (values,), (args,)
        nw, ne = int(np.prod(args[0].row_shape)), int(np.prod(
            args[0].lane_shape))
        dev = args[0].row_off.device
        out_v = (torch.empty((nw, ne), dtype=torch.float32, device=dev)
                 if out_v is None else out_v,)
        out_a = (torch.empty((nw, ne), dtype=torch.int32, device=dev)
                 if out_a is None else out_a,)
    values, args = tuple(values), tuple(args)
    if not (len(values) == len(args) == len(out_v) == len(out_a)):
        raise ValueError("give one table, args and output pair a channel")
    for i, (v, a, ov, oa) in enumerate(zip(values, args, out_v, out_a)):
        shape = (int(np.prod(a.row_shape)), int(np.prod(a.lane_shape)))
        dev = a.row_off.device
        _check_table(f"values[{i}]", v, shape, torch.float32, dev)
        _check_table(f"out_v[{i}]", ov, shape, torch.float32, dev)
        _check_table(f"out_a[{i}]", oa, shape, torch.int32, dev)
        if ov.data_ptr() == v.data_ptr():
            raise ValueError(f"out_v[{i}] is its input table")
    lib = _build.load()
    dev = values[0].device
    plan, ints, c_act, tile = _tiles(tuple(_plan_key(a) for a in args),
                                     _smem_limit(lib, dev))
    configure(lib, dev, plan)
    ptrs = np.array([
        p for v, a, ov, oa in zip(values, args, out_v, out_a)
        for p in (v.data_ptr(), ov.data_ptr(), oa.data_ptr(),
                  a.row_off.data_ptr(), a.row_frac.data_ptr(),
                  a.lane_off[0].data_ptr(), a.lane_frac[0].data_ptr(),
                  a.lane_off[1].data_ptr(), a.lane_frac[1].data_ptr(),
                  a.c_row.data_ptr(), a.c_lane.data_ptr(), _ptr(a.c_rowact),
                  _ptr(a.c_rowlane))], dtype=np.int64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rowlane_backup_f32(len(values), ptrs.ctypes.data,
                                 ints.ctypes.data, c_act.ctypes.data,
                                 tile.ctypes.data, stream)
    if err != 0:
        msg = lib.rowlane_backup_error_string(err).decode()
        raise RuntimeError(f"rowlane_backup launch failed: CUDA error {err} "
                           f"({msg})")
    rowlane_backup_cuda.launches += 1
    rowlane_backup_cuda.channel_sweeps += len(values)
    if single:
        return BackupResult(out_v[0], out_a[0])
    return BackupResult(tuple(out_v), tuple(out_a))


rowlane_backup_cuda.launches = 0
rowlane_backup_cuda.channel_sweeps = 0


def _row_plan(lo, fr, shape, nr, n_act):
    """Per-(row, action) offsets (lo minus the row's own index) and fracs of
    the ``nr`` row axes, ``(nr, NW, n_act)`` tensors on the plan's device,
    from ``(d+1)``-dim broadcast tensors ``lo``/``fr`` over ``(*shape,
    n_act)``. Raises for a row axis whose query varies along the lanes."""
    d = len(shape)
    nw = int(np.prod(shape[:nr]))
    target = shape[:nr] + (1,) * (d - nr) + (n_act,)
    w_off, w_frac = [], []
    for k in range(nr):
        if any(s > 1 for s in lo[k].shape[nr:d]) or \
           any(s > 1 for s in fr[k].shape[nr:d]):
            raise ValueError(
                f"row axis {k} query varies along lane axes — "
                "not row/lane separable; use the gather backup")
        idx = torch.arange(shape[k], dtype=torch.int32,
                           device=lo[k].device).reshape(
            (1,) * k + (-1,) + (1,) * (d - k))
        w_off.append((lo[k] - idx).expand(target))
        w_frac.append(fr[k].expand(target))
    return (torch.stack(w_off).reshape(nr, nw, n_act),
            torch.stack(w_frac).reshape(nr, nw, n_act))


def _listed(cost_terms) -> list:
    return (list(cost_terms) if isinstance(cost_terms, (tuple, list))
            else [cost_terms])


def _split_cost(terms, shape, nr, n_act):
    """Split broadcast-shaped ``(d+1)``-dim cost terms (tensors or arrays,
    in the row/lane axis order) into float32 row ``(NW,)``, lane ``(NE,)``,
    action ``(A,)``, row x action ``(NW, A)`` and row x lane ``(NW, NE)``
    parts (the last two None when no term has them), each accumulated in
    term order as ``ocdp_tpu/ops/pallas_backup6.py:840-902`` does, on the
    device of the terms that are not on the host (the host when none is).
    Raises for a term that couples lanes and actions."""
    d = len(shape)
    nc = d - nr
    nw, ne = int(np.prod(shape[:nr])), int(np.prod(shape[nr:]))
    terms = [torch.as_tensor(t) for t in terms]
    dev = next((t.device for t in terms if t.device.type != "cpu"),
               torch.device("cpu"))
    c_row = torch.zeros(nw, dtype=torch.float32, device=dev)
    c_lane = torch.zeros(ne, dtype=torch.float32, device=dev)
    c_act = torch.zeros(n_act, dtype=torch.float32, device=dev)
    c_rowact = c_rowlane = None
    for t in terms:
        t = t.to(dev, torch.float32)
        if t.dim() != d + 1:
            t = t.reshape((1,) * (d + 1 - t.dim()) + tuple(t.shape))
        row_dep = any(s > 1 for s in t.shape[:nr])
        lane_dep = any(s > 1 for s in t.shape[nr:d])
        act_dep = t.shape[-1] > 1
        if lane_dep and act_dep:
            raise ValueError(
                "cost term couples the lane and action groups — "
                "not factorizable for the row/lane kernels")
        if act_dep and row_dep:
            add = t.expand(shape[:nr] + (1,) * nc + (n_act,)) \
                .reshape(nw, n_act)
            c_rowact = add.clone() if c_rowact is None else c_rowact + add
        elif row_dep and lane_dep:
            add = t[..., 0].expand(shape).reshape(nw, ne)
            c_rowlane = add.clone() if c_rowlane is None \
                else c_rowlane + add
        elif act_dep:
            c_act += t.expand((1,) * d + (n_act,)).reshape(n_act)
        elif lane_dep:
            c_lane += t.expand((1,) * nr + shape[nr:] + (1,)).reshape(ne)
        else:
            c_row += t.expand(shape[:nr] + (1,) * (nc + 1)).reshape(nw)
    return c_row, c_lane, c_act, c_rowact, c_rowlane


# a part's offset in a packed copy, in floats (256 B, a fresh allocation's
# alignment)
_PACK_ALIGN = 64


def _to_device(parts, device) -> list:
    """The tensors ``parts`` (None kept) contiguous on ``device``: those on
    another device moved in one packed copy, each at a 256-byte aligned
    offset of it."""
    move = [i for i, p in enumerate(parts)
            if p is not None and p.device != device]
    out = [None if p is None else p.contiguous() for p in parts]
    if not move:
        return out
    sizes = [-(-parts[i].numel() // _PACK_ALIGN) * _PACK_ALIGN for i in move]
    buf = torch.zeros(sum(sizes), dtype=torch.float32,
                      device=parts[move[0]].device)
    at = 0
    for i, n in zip(move, sizes):
        buf[at:at + parts[i].numel()] = parts[i].reshape(-1)
        at += n
    buf = buf.to(device)
    at = 0
    for i, n in zip(move, sizes):
        out[i] = buf[at:at + parts[i].numel()].view(parts[i].shape)
        at += n
    return out


def _cost_parts(terms, shape, nr, n_act, device) -> tuple:
    """:func:`_split_cost`'s parts as the kernels take them: ``c_row``,
    ``c_lane``, ``c_rowact``, ``c_rowlane`` contiguous on ``device`` (one
    packed copy where they were split on the host) and ``c_act`` as host
    floats (one read where they were split on the device)."""
    c_row, c_lane, c_act, c_rowact, c_rowlane = _split_cost(
        terms, shape, nr, n_act)
    c_act = tuple(float(x) for x in to_host(c_act))
    return (*_to_device([c_row, c_lane, c_rowact, c_rowlane], device),
            c_act)


def _with_unit_axis(lo, fr, terms, shape, p):
    """Insert a size-1 state axis at position ``p`` into the permuted plan
    tensors, the cost terms and the shape; the new axis's queries stay on
    its one point (lo 0, frac 0)."""
    unit = (1,) * (len(shape) + 2)
    dev = lo[0].device
    lo = [a.unsqueeze(p) for a in lo]
    fr = [a.unsqueeze(p) for a in fr]
    lo.insert(p, torch.zeros(unit, dtype=torch.int32, device=dev))
    fr.insert(p, torch.zeros(unit, dtype=torch.float32, device=dev))
    terms = [t.unsqueeze(p) for t in terms]
    return lo, fr, terms, shape[:p] + (1,) + shape[p:]


class RowLaneBackup:
    """Callable ``values -> BackupResult`` over one plan and stage cost,
    computed on the state axes permuted by ``perm`` with the first
    ``row_axes`` of them as rows (pos-att: ``perm=(1, 3, 0, 2)``,
    ``row_axes=2``: rows (v, omega), lanes (x, theta); the simplified
    attitude axes: ``perm=(0, 1)``, ``row_axes=1``). The kernel takes two
    row and two lane axes, so a group of one axis gets a unit axis in front
    of it, whose tap weight is exactly 1.

    ``plan``: an :class:`InterpPlan` whose queries broadcast to
    ``(*state_shape, n_actions)``. ``cost_terms``: broadcast-shaped terms
    (tensors or arrays) summing to the stage cost, split once into row,
    lane, action, row x action and row x lane parts, each accumulated in
    term order as ``ocdp_tpu/ops/pallas_backup6.py:840-902`` does.

    Raises ``ValueError`` for a row axis whose query varies along the
    lanes, a lane axis whose query varies with the action, lane axes whose
    queries couple (the joint-combo mode: :class:`~ocdp_tpu_torch.ops.
    backup6d.Backup6D`), a cost term coupling lanes and actions, and a tap
    structure beyond the kernel's capacities: more than 40 live row combos
    or 40 live lane combos (counted as the TPU kernel's build counts them,
    which refuses the same plans) or 64 actions. Values come in and go out
    in the natural (unpermuted) state order.
    """

    def __init__(self, plan: InterpPlan, cost_terms, perm, *, row_axes: int):
        with span("ocdp.rowlane.analyse"):
            self._analyse(plan, cost_terms, perm, row_axes)

    def _analyse(self, plan: InterpPlan, cost_terms, perm, row_axes: int):
        """The analysis of the taps, the cost split and the kernel's
        arguments (``self.args``), on the plan's device: only the live sets'
        bounds and codes come to the host."""
        d = plan.ndim
        if sorted(perm) != list(range(d)):
            raise ValueError(f"perm {perm} is not a permutation of 0..{d-1}")
        self.perm = tuple(perm)
        self.inv = tuple(self.perm.index(k) for k in range(d))
        ap = self.perm + (d,)          # the action axis stays last

        def permuted(a):
            a = torch.as_tensor(a)
            if a.dim() != d + 1:
                a = a.reshape((1,) * (d + 1 - a.dim()) + tuple(a.shape))
            return a.permute(ap)

        lo = [permuted(plan.lo[k]).to(torch.int32) for k in self.perm]
        fr = [permuted(plan.frac[k]).to(torch.float32) for k in self.perm]
        terms = [permuted(t) for t in _listed(cost_terms)]
        shape = tuple(plan.grid_shape[k] for k in self.perm)
        self.state_shape = shape
        n_act = plan.query_shape[-1]
        nr = row_axes
        nw, ne = int(np.prod(shape[:nr])), int(np.prod(shape[nr:]))
        self.NW, self.NE = nw, ne
        if nr == 1:
            lo, fr, terms, shape = _with_unit_axis(lo, fr, terms, shape, 0)
            nr = 2
        if len(shape) - nr == 1:
            lo, fr, terms, shape = _with_unit_axis(lo, fr, terms, shape, nr)
        d = len(shape)

        w_off, w_frac = _row_plan(lo, fr, shape, nr, n_act)

        # lane axes: offsets and fracs as broadcast views over (rows, own
        # coordinate), and their (NW, n_k) form for the kernel
        e_off, e_frac, lane_off, lane_frac = [], [], [], []
        for k in range(nr, d):
            if lo[k].shape[-1] > 1 or fr[k].shape[-1] > 1:
                raise ValueError(
                    f"lane axis {k} query varies with the action — "
                    "not row/lane separable; use the gather backup")
            for j in range(nr, d):
                if j != k and (lo[k].shape[j] > 1 or fr[k].shape[j] > 1):
                    raise ValueError(
                        f"lane axis {k} query varies with lane axis {j}: the "
                        "lanes couple, and the rowlane kernel takes "
                        "separable lanes only; use ops.backup6d.Backup6D or "
                        "the gather backup")
            iota = torch.arange(shape[k], dtype=torch.int32,
                                device=lo[k].device).reshape(
                (1,) * k + (-1,) + (1,) * (d - 1 - k))
            e_off.append(lo[k][..., 0] - iota)
            e_frac.append(fr[k][..., 0])
            own = shape[:nr] + tuple(shape[k] if j == k else 1
                                     for j in range(nr, d))
            lane_off.append(e_off[-1].expand(own).reshape(nw, shape[k])
                            .contiguous())
            lane_frac.append(e_frac[-1].expand(own).reshape(nw, shape[k])
                             .contiguous())

        (w_taps, row_combos), (e_taps, lane_combos) = live_sets(
            (list(w_off), list(w_frac)), (e_off, e_frac))
        self.w_taps = tuple(tuple(t) for t in w_taps)
        self.row_combos = tuple(row_combos)
        self.e_taps = tuple(tuple(t) for t in e_taps)
        # the live lane pairs, as the TPU kernel counts them; the kernel
        # sums each lane axis's taps in turn
        self.lane_combos = tuple(lane_combos)
        if len(self.row_combos) > MAX_ROW_COMBOS or \
                len(self.lane_combos) > MAX_LANE_COMBOS or \
                n_act > MAX_ACTIONS:
            raise ValueError(
                f"{len(self.row_combos)} row combos, "
                f"{len(self.lane_combos)} lane combos (lane taps "
                f"{self.e_taps}) and {n_act} actions exceed the "
                f"max_flat_taps={MAX_ROW_COMBOS} combos the TPU kernel takes "
                f"too and the kernel's {MAX_ACTIONS} actions; use "
                "impl='gather'")

        # the factorized stage cost
        c_row, c_lane, c_rowact, c_rowlane, c_act = _cost_parts(
            terms, shape, nr, n_act, plan.device)
        self.c_row, self.c_lane = c_row, c_lane
        self.c_act = np.asarray(c_act, np.float32)
        self.args = RowLaneArgs(
            row_shape=shape[:nr], lane_shape=shape[nr:],
            row_off=w_off, row_frac=w_frac, lane_off=tuple(lane_off),
            lane_frac=tuple(lane_frac), row_combos=self.row_combos,
            lane_taps=self.e_taps,
            c_row=c_row, c_lane=c_lane, c_act=c_act, c_rowact=c_rowact,
            c_rowlane=c_rowlane)
        _check_args(self.args)

    def to_table(self, values: torch.Tensor) -> torch.Tensor:
        """Natural-order values as the kernel's contiguous ``(NW, NE)``
        table."""
        return values.permute(self.perm).reshape(self.NW, self.NE) \
            .contiguous()

    def to_natural(self, table: torch.Tensor) -> torch.Tensor:
        """A kernel-layout ``(NW, NE)`` table (or argmin) as a contiguous
        tensor in the natural state order."""
        return table.reshape(self.state_shape).permute(self.inv).contiguous()

    def _run(self, fn, values: torch.Tensor) -> BackupResult:
        res = fn(self.to_table(values), self.args)
        return BackupResult(self.to_natural(res.values),
                            self.to_natural(res.argmin))

    def __call__(self, values: torch.Tensor) -> BackupResult:
        if values.is_cuda:
            return self._run(rowlane_backup_cuda, values)
        if values.device.type == "cpu":
            return self._run(rowlane_backup_plain, values)
        raise ValueError(f"no rowlane backup for device {values.device}")

    def plain(self, values: torch.Tensor) -> BackupResult:
        """The plain PyTorch version on any device (the ``'rowlane'`` impl
        of the pos-att solves)."""
        return self._run(rowlane_backup_plain, values)


class RowLaneBatch:
    """Channels of one grid shape swept together: on a CUDA device one
    kernel launch a sweep over the active channels, each with its own plan,
    tap structure, action count and costs; on the CPU, or with ``plain``
    on any device, each channel's plain version in turn. The tables stay
    in the kernel's ``(NW, NE)`` layout; :meth:`to_natural` gives a
    channel's table in the natural state order.

    ``backups``: the channels' :class:`RowLaneBackup` objects, at most
    ``MAX_BATCH``, of one ``(NW, NE)`` shape.
    """

    def __init__(self, backups, *, plain: bool = False):
        self.backups = tuple(backups)
        if not 1 <= len(self.backups) <= MAX_BATCH:
            raise ValueError(f"{len(self.backups)} channels; a batch takes "
                             f"1 to {MAX_BATCH}")
        shapes = {(b.NW, b.NE) for b in self.backups}
        if len(shapes) != 1:
            raise ValueError(f"channels of different shapes {shapes}")
        self.NW, self.NE = shapes.pop()
        self.device = self.backups[0].args.row_off.device
        self.kernel = self.device.type == "cuda" and not plain
        self.launcher = rowlane_backup_cuda if self.kernel else None

    def __len__(self) -> int:
        return len(self.backups)

    def buffers(self, init_values=None) -> tuple:
        """``(cur, nxt, argmin)``: the ping-pong tables and the argmin,
        ``(C, NW, NE)`` each, allocated once; ``cur`` holds each channel's
        ``init_values`` (natural order; zeros when None)."""
        shape = (len(self), self.NW, self.NE)
        cur = torch.zeros(shape, dtype=torch.float32, device=self.device)
        if init_values is not None:
            for c, b in enumerate(self.backups):
                cur[c] = b.to_table(torch.as_tensor(
                    init_values[c], dtype=torch.float32, device=self.device))
        return (cur, torch.empty_like(cur),
                torch.zeros(shape, dtype=torch.int32, device=self.device))

    def prepare(self, active) -> None:
        """Build and configure the kernel for a launch over ``active``
        before a CUDA graph captures one."""
        if self.kernel:
            launch_plan(torch.empty(0, device=self.device),
                        [self.backups[c].args for c in active])

    def sweep(self, cur, nxt, argmin, active) -> None:
        """One sweep of the ``active`` channels from ``cur`` into ``nxt``
        and ``argmin``."""
        if self.kernel:
            rowlane_backup_cuda([cur[c] for c in active],
                                [self.backups[c].args for c in active],
                                [nxt[c] for c in active],
                                [argmin[c] for c in active])
            return
        for c in active:
            res = rowlane_backup_plain(cur[c], self.backups[c].args)
            nxt[c].copy_(res.values)
            argmin[c].copy_(res.argmin)

    def to_natural(self, c: int, table: torch.Tensor) -> torch.Tensor:
        return self.backups[c].to_natural(table)
