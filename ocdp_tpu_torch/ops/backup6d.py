"""6-D coupled-lane Bellman backup: the CUDA kernel, its plain version, its
wrapper.

Replaces the TPU kernel ``ocdp_tpu/ops/pallas_backup6.py::PallasBackup6D``
in its coupled-lane mode on non-flat plans (``_kernel``'s joint lane-combo
branch, then ``_action_phase_factorized`` or ``_action_phase_generic``), on
the full 6-D attitude path. The kernel source, with the note on its
arithmetic, tie order and what bounds it, is ``csrc/backup6d.cu``.

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
   minimum from action 0;
4. ``best + c_row[r] + c_lane[c] (+ c_rowlane[r, c])``.

A read that leaves the table (a row outside ``[0, NW)`` or a lane outside
``[0, NE)``) reads 0.0 and always carries an exactly zero weight; it is
summed all the same.

* :func:`backup6d_cuda` launches the kernel; ``backup6d_cuda.launches``
  counts its launches.
* :func:`backup6d_plain` is the same function in plain PyTorch on the same
  inputs, in the same order of operations. On a CUDA device the two agree
  bitwise.
* :class:`Backup6D` analyses a plan once on the host (live taps, action
  digits, the cost split) and is the engines' ``values -> BackupResult``
  callable: the kernel on a CUDA tensor, the plain version on a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .backup import BackupResult
from .interp import InterpPlan
from .rowlane import (_as_numpy, _corner_live_sets, _row_plan, _shift_lanes,
                      _split_cost, _tap_weight, _upload)

__all__ = ["Backup6DArgs", "Backup6D", "backup6d_cuda", "backup6d_plain"]

# the kernel's fixed capacities (kMaxTaps, kMaxActions, kMaxDigits in
# csrc/backup6d.cu): live taps per row or lane axis (so at most 27 row and
# 27 lane combos), actions, and the digit base of the factorized phase
MAX_TAPS = 3
MAX_ACTIONS = 64
MAX_DIGITS = 3


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
    ``c_rowact`` (NW, A) and ``c_rowlane`` (NW, NE).
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

    @property
    def n_actions(self) -> int:
        return self.row_off.shape[-1]

    def row_deltas(self) -> list:
        return _flat_shifts(self.row_combos, self.row_shape)

    def lane_deltas(self) -> list:
        return _flat_shifts(self.lane_combos, self.lane_shape)


def _flat_shifts(combos, shape) -> list:
    strides = [int(np.prod(shape[k + 1:])) for k in range(len(shape))]
    return [sum(t * s for t, s in zip(c, strides)) for c in combos]


def _lane_phase(values: torch.Tensor, args: Backup6DArgs) -> list:
    """``A_j`` of every row combo, ``(NW, NE)`` each."""
    nw = values.shape[0]
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
        rows = vp[pad + d:pad + d + nw]
        acc = None
        for w, dl in zip(joint, lane_deltas):
            term = w * _shift_lanes(rows, dl)
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def _action_totals_factorized(A, ww, args: Backup6DArgs):
    """Per-action totals, contracted one action digit at a time
    (``pallas_backup6.py:1269``); yields ``(a, tot_a)`` in action order."""
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
    for a in range(args.n_actions):
        d0, rem = divmod(a, m * m)
        d1, d2 = divmod(rem, m)
        tot = None
        for t0 in t0s:
            term = col(0, t0, d0) * part_c[(t0, d1, d2)]
            tot = term if tot is None else tot + term
        yield a, tot


def _action_totals_generic(A, ww, args: Backup6DArgs):
    """Per-action totals over every row combo (``pallas_backup6.py:1215``);
    yields ``(a, tot_a)`` in action order."""
    for a in range(args.n_actions):
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

    ``values``: the ``(NW, NE)`` table. Every product and sum is one
    separately rounded PyTorch op, in the kernel's order.
    """
    nw, ne = values.shape
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
            arg = torch.zeros((nw, ne), dtype=torch.int32,
                              device=values.device)
        else:
            better = tot < best            # strict: the first minimum wins
            best = torch.where(better, tot, best)
            arg = torch.where(better, a, arg)
    out = best + args.c_row[:, None] + args.c_lane[None, :]
    out = out + (args.c_rowlane if args.c_rowlane is not None else 0.0)
    return BackupResult(out, arg)


def _check_cuda_inputs(values, args: Backup6DArgs) -> None:
    nw, ne = int(np.prod(args.row_shape)), int(np.prod(args.lane_shape))
    if nw * ne >= 2**31:
        raise ValueError(f"{nw}x{ne} cells exceed the kernel's int32 index")
    n_act = args.n_actions
    want = {"values": ((nw, ne), torch.float32, values),
            "row_off": ((3, nw, n_act), torch.int32, args.row_off),
            "row_frac": ((3, nw, n_act), torch.float32, args.row_frac),
            "c_row": ((nw,), torch.float32, args.c_row),
            "c_lane": ((ne,), torch.float32, args.c_lane)}
    for k in range(3):
        want[f"lane_off[{k}]"] = ((nw, ne), torch.int32, args.lane_off[k])
        want[f"lane_frac[{k}]"] = ((nw, ne), torch.float32,
                                   args.lane_frac[k])
    if args.c_rowact is not None:
        want["c_rowact"] = ((nw, n_act), torch.float32, args.c_rowact)
    if args.c_rowlane is not None:
        want["c_rowlane"] = ((nw, ne), torch.float32, args.c_rowlane)
    for name, (shape, dtype, t) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != values.device or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}; every input must be "
                             f"on the CUDA device of values ({values.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def backup6d_cuda(values: torch.Tensor, args: Backup6DArgs) -> BackupResult:
    """Launch the CUDA kernel for one sweep of the ``(NW, NE)`` table on
    PyTorch's current stream. Raises on inputs it does not take and on a
    launch the device refuses. The tap structure must fit the kernel's
    capacities, which :class:`Backup6D` checks when it is built."""
    from .. import _build

    _check_cuda_inputs(values, args)
    lib = _build.load()
    nw, ne = values.shape
    out_v = torch.empty((nw, ne), dtype=torch.float32, device=values.device)
    out_a = torch.empty((nw, ne), dtype=torch.int32, device=values.device)
    w_taps = np.zeros((3, MAX_TAPS), np.int32)
    n_taps = np.zeros(3, np.int32)
    for k, taps in enumerate(args.w_taps):
        w_taps[k, :len(taps)] = taps
        n_taps[k] = len(taps)
    row_combos = np.ascontiguousarray(args.row_combos, dtype=np.int32)
    lane_combos = np.ascontiguousarray(args.lane_combos, dtype=np.int32)
    c_act = np.ascontiguousarray(args.c_act, dtype=np.float32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.backup6d_f32(
        ptr(values), ptr(args.row_off), ptr(args.row_frac),
        *(ptr(t) for pair in zip(args.lane_off, args.lane_frac)
          for t in pair),
        ptr(args.c_row), ptr(args.c_lane), ptr(args.c_rowact),
        ptr(args.c_rowlane), ptr(out_v), ptr(out_a),
        w_taps.ctypes.data, n_taps.ctypes.data, row_combos.ctypes.data,
        lane_combos.ctypes.data, c_act.ctypes.data,
        *args.row_shape, *args.lane_shape, args.n_actions, len(row_combos),
        len(lane_combos), args.action_digits or 0, stream)
    if err != 0:
        msg = lib.backup6d_error_string(err).decode()
        raise RuntimeError(f"backup6d launch failed: CUDA error {err} ({msg})")
    backup6d_cuda.launches += 1
    return BackupResult(out_v, out_a)


backup6d_cuda.launches = 0


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


class Backup6D:
    """Callable ``values -> BackupResult`` over one non-flat 6-D plan and
    stage cost: the first 3 state axes are the rows, the last 3 the lanes.

    ``plan``: an :class:`InterpPlan` whose queries broadcast to
    ``(*state_shape, n_actions)``. ``cost_terms``: broadcast-shaped terms
    (tensors or arrays) summing to the stage cost, split once into row,
    lane, action, row x action and row x lane parts.

    Raises ``ValueError`` for a plan that is not 6-D or not in the broadcast
    layout, a row axis whose query varies along the lanes, a lane axis whose
    query varies with the action, a cost term coupling lanes and actions,
    and a tap structure beyond the kernel's capacities (3 live taps per row
    or lane axis, 64 actions, digit base 3). The kernel runs on a CUDA
    tensor, the plain version on a CPU tensor; there is no other device and
    no fallback from one to the other.
    """

    ROW_AXES = 3

    def __init__(self, plan: InterpPlan, cost_terms):
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
        self.w_taps = tuple(tuple(t) for t in w_taps)
        self.e_taps = tuple(tuple(t) for t in e_taps)
        self.row_combos = tuple(row_combos)
        self.lane_combos = tuple(lane_combos)
        self.action_digits = _detect_action_digits(w_off, w_frac, nr)
        if max(len(t) for t in self.w_taps + self.e_taps) > MAX_TAPS or \
                n_act > MAX_ACTIONS or (self.action_digits or 0) > MAX_DIGITS:
            raise ValueError(
                f"row taps {self.w_taps}, lane taps {self.e_taps}, {n_act} "
                f"actions and digit base {self.action_digits} exceed the "
                f"kernel's {MAX_TAPS} taps per axis, {MAX_ACTIONS} actions "
                f"and digit base {MAX_DIGITS}")

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

        self.args = Backup6DArgs(
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
            c_rowlane=up(c_rowlane, torch.float32))

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
