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
* :class:`RowLaneBackup` analyses a plan once on the host (live taps, the
  cost split) and is the engines' ``values -> BackupResult`` callable: the
  kernel on a CUDA tensor, the plain version on a CPU tensor.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .backup import BackupResult
from .interp import InterpPlan

__all__ = ["RowLaneArgs", "RowLaneBackup", "rowlane_backup_cuda",
           "rowlane_backup_plain"]

# the kernel's fixed capacities (kMaxLaneTaps, kMaxRowCombos, kMaxActions in
# csrc/rowlane_backup.cu); the high-res y channel has 17 row combos
MAX_LANE_TAPS = 8
MAX_ROW_COMBOS = 32
MAX_ACTIONS = 64


def _corner_live_sets(axis_offs, axis_fracs):
    """Exact jointly-live tap combinations across a group of axes.

    A combo (t_0..t_{k-1}) is live iff some query element's multilinear
    corner reaches it with nonzero weight on EVERY axis (weight 1-frac at
    the lo corner, frac at the hi corner). One encode pass + one
    ``np.unique`` over the elements. Returns ``(per_axis_taps, combos)``,
    both sorted, as ``ocdp_tpu/ops/pallas_backup6.py:225`` does.
    """
    k = len(axis_offs)
    base = [int(o.min()) for o in axis_offs]
    span = [int(o.max()) - b + 1 for o, b in zip(axis_offs, base)]
    bits_needed = int(np.sum(np.ceil(np.log2(np.maximum(span, 2))))) + 2 * k
    dtype = np.int32 if bits_needed < 31 else np.int64
    enc = np.zeros(np.broadcast_shapes(*(a.shape for a in
                                         (*axis_offs, *axis_fracs))), dtype)
    for o, b, s in zip(axis_offs, base, span):
        np.multiply(enc, s, out=enc)
        enc += o
        enc -= b
    # 2 liveness bits per axis: bit0 = lo corner has weight, bit1 = hi
    for fr in axis_fracs:
        np.left_shift(enc, 2, out=enc)
        enc |= np.not_equal(fr, np.float32(1.0))
        hi = np.not_equal(fr, np.float32(0.0)).astype(np.int8)
        np.left_shift(hi, 1, out=hi)
        enc |= hi
    return _decode_live(np.unique(enc).tolist(), base, span, k)


def _decode_live(enc_values, base, span, k):
    """Expand present encode values into the live corner-combo set."""
    combos = set()
    for e in enc_values:
        bits = [(e >> (2 * (k - 1 - i))) & 3 for i in range(k)]
        rest = e >> (2 * k)
        offs = []
        for s in reversed(span):
            rest, o = divmod(rest, s)
            offs.append(o)
        offs = offs[::-1]
        for corner in itertools.product((0, 1), repeat=k):
            if all((b >> c) & 1 for c, b in zip(corner, bits)):
                combos.add(tuple(o + b + c for o, b, c
                                 in zip(offs, base, corner)))
    combos = sorted(combos)
    taps = [sorted({c[i] for c in combos}) for i in range(k)]
    return taps, combos


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


def _check_cuda_inputs(values, args: RowLaneArgs) -> None:
    if len(args.row_shape) != 2 or len(args.lane_shape) != 2:
        raise ValueError(
            f"the rowlane kernel takes 2 row and 2 lane axes, got rows "
            f"{args.row_shape} and lanes {args.lane_shape}")
    nw, ne = int(np.prod(args.row_shape)), int(np.prod(args.lane_shape))
    if nw * ne >= 2**31:
        raise ValueError(f"{nw}x{ne} cells exceed the kernel's int32 index")
    n_act = args.n_actions
    want = {"values": ((nw, ne), torch.float32, values),
            "row_off": ((2, nw, n_act), torch.int32, args.row_off),
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
    for name, (shape, dtype, t) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != values.device or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}; every input must be "
                             f"on the CUDA device of values ({values.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rowlane_backup_cuda(values: torch.Tensor,
                        args: RowLaneArgs) -> BackupResult:
    """Launch the CUDA kernel for one sweep of the ``(NW, NE)`` table on
    PyTorch's current stream. Raises on inputs it does not take and on a
    launch the device refuses. The tap structure must fit the kernel's
    capacities, which :class:`RowLaneBackup` checks when it is built."""
    from .. import _build

    _check_cuda_inputs(values, args)
    lib = _build.load()
    nw, ne = values.shape
    out_v = torch.empty((nw, ne), dtype=torch.float32, device=values.device)
    out_a = torch.empty((nw, ne), dtype=torch.int32, device=values.device)
    combos = np.ascontiguousarray(args.row_combos, dtype=np.int32)
    taps0 = np.ascontiguousarray(args.lane_taps[0], dtype=np.int32)
    taps1 = np.ascontiguousarray(args.lane_taps[1], dtype=np.int32)
    c_act = np.ascontiguousarray(args.c_act, dtype=np.float32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.rowlane_backup_f32(
        ptr(values), ptr(args.row_off), ptr(args.row_frac),
        ptr(args.lane_off[0]), ptr(args.lane_frac[0]),
        ptr(args.lane_off[1]), ptr(args.lane_frac[1]),
        ptr(args.c_row), ptr(args.c_lane), ptr(args.c_rowact),
        ptr(args.c_rowlane), ptr(out_v), ptr(out_a),
        combos.ctypes.data, taps0.ctypes.data, taps1.ctypes.data,
        c_act.ctypes.data,
        *args.row_shape, *args.lane_shape, args.n_actions, len(combos),
        len(taps0), len(taps1), stream)
    if err != 0:
        msg = lib.rowlane_backup_error_string(err).decode()
        raise RuntimeError(f"rowlane_backup launch failed: CUDA error {err} "
                           f"({msg})")
    rowlane_backup_cuda.launches += 1
    return BackupResult(out_v, out_a)


rowlane_backup_cuda.launches = 0


def _as_numpy(a, dtype=None):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _row_plan(lo, fr, shape, nr, n_act):
    """Per-(row, action) offsets (lo minus the row's own index) and fracs of
    the ``nr`` row axes, each ``(NW, n_act)``, from ``(d+1)``-dim broadcast
    arrays ``lo``/``fr`` over ``(*shape, n_act)``. Raises for a row axis
    whose query varies along the lanes."""
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
        idx = np.arange(shape[k], dtype=np.int32).reshape(
            (1,) * k + (-1,) + (1,) * (d - k))
        w_off.append(np.broadcast_to(lo[k] - idx, target).reshape(nw, n_act))
        w_frac.append(np.broadcast_to(fr[k], target).reshape(nw, n_act))
    return w_off, w_frac


def _split_cost(terms, shape, nr, n_act):
    """Split broadcast-shaped ``(d+1)``-dim cost terms (numpy, in the row/lane
    axis order) into row ``(NW,)``, lane ``(NE,)``, action ``(A,)``, row x
    action ``(NW, A)`` and row x lane ``(NW, NE)`` parts (the last two None
    when no term has them), each accumulated in term order as
    ``ocdp_tpu/ops/pallas_backup6.py:840-902`` does. Raises for a term that
    couples lanes and actions."""
    d = len(shape)
    nc = d - nr
    nw, ne = int(np.prod(shape[:nr])), int(np.prod(shape[nr:]))
    c_row = np.zeros(nw, np.float32)
    c_lane = np.zeros(ne, np.float32)
    c_act = np.zeros(n_act, np.float32)
    c_rowact = c_rowlane = None
    for t in terms:
        t = np.asarray(t, np.float32)
        if t.ndim != d + 1:
            t = t.reshape((1,) * (d + 1 - t.ndim) + t.shape)
        row_dep = any(s > 1 for s in t.shape[:nr])
        lane_dep = any(s > 1 for s in t.shape[nr:d])
        act_dep = t.shape[-1] > 1
        if lane_dep and act_dep:
            raise ValueError(
                "cost term couples the lane and action groups — "
                "not factorizable for the row/lane kernels")
        if act_dep and row_dep:
            add = np.broadcast_to(
                t, shape[:nr] + (1,) * nc + (n_act,)).reshape(nw, n_act)
            c_rowact = add.copy() if c_rowact is None else c_rowact + add
        elif row_dep and lane_dep:
            add = np.broadcast_to(t[..., 0], shape).reshape(nw, ne)
            c_rowlane = add.copy() if c_rowlane is None else c_rowlane + add
        elif act_dep:
            c_act += np.broadcast_to(t, (1,) * d + (n_act,)).reshape(n_act)
        elif lane_dep:
            c_lane += np.broadcast_to(
                t, (1,) * nr + shape[nr:] + (1,)).reshape(ne)
        else:
            c_row += np.broadcast_to(
                t, shape[:nr] + (1,) * (nc + 1)).reshape(nw)
    return c_row, c_lane, c_act, c_rowact, c_rowlane


def _with_unit_axis(lo, fr, terms, shape, p):
    """Insert a size-1 state axis at position ``p`` into the permuted plan
    arrays, the cost terms and the shape; the new axis's queries stay on its
    one point (lo 0, frac 0)."""
    unit = (1,) * (len(shape) + 2)
    lo = [np.expand_dims(a, p) for a in lo]
    fr = [np.expand_dims(a, p) for a in fr]
    lo.insert(p, np.zeros(unit, np.int32))
    fr.insert(p, np.zeros(unit, np.float32))
    terms = [np.expand_dims(t, p) for t in terms]
    return lo, fr, terms, shape[:p] + (1,) + shape[p:]


def _upload(a, dtype, device):
    return None if a is None else torch.tensor(
        np.ascontiguousarray(a), dtype=dtype, device=device)


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
    backup6d.Backup6D`), a cost term coupling lanes and actions, and a tap structure beyond the
    kernel's capacities. Values come in and go out in the natural
    (unpermuted) state order.
    """

    def __init__(self, plan: InterpPlan, cost_terms, perm, *, row_axes: int):
        d = plan.ndim
        if sorted(perm) != list(range(d)):
            raise ValueError(f"perm {perm} is not a permutation of 0..{d-1}")
        self.perm = tuple(perm)
        self.inv = tuple(self.perm.index(k) for k in range(d))
        ap = self.perm + (d,)          # the action axis stays last

        def permuted(a):
            a = _as_numpy(a)
            if a.ndim != d + 1:
                a = a.reshape((1,) * (d + 1 - a.ndim) + a.shape)
            return np.transpose(a, ap)

        lo = [permuted(plan.lo[k]).astype(np.int32) for k in self.perm]
        fr = [permuted(plan.frac[k]).astype(np.float32) for k in self.perm]
        terms = [permuted(t) for t in
                 (cost_terms if isinstance(cost_terms, (tuple, list))
                  else [cost_terms])]
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
            iota = np.arange(shape[k], dtype=np.int32).reshape(
                (1,) * k + (-1,) + (1,) * (d - 1 - k))
            e_off.append(lo[k][..., 0] - iota)
            e_frac.append(fr[k][..., 0])
            own = shape[:nr] + tuple(shape[k] if j == k else 1
                                     for j in range(nr, d))
            lane_off.append(np.broadcast_to(e_off[-1], own)
                            .reshape(nw, shape[k]))
            lane_frac.append(np.broadcast_to(e_frac[-1], own)
                             .reshape(nw, shape[k]))

        w_taps, row_combos = _corner_live_sets(w_off, w_frac)
        e_taps, _ = _corner_live_sets(e_off, e_frac)
        self.w_taps = tuple(tuple(t) for t in w_taps)
        self.row_combos = tuple(row_combos)
        self.e_taps = tuple(tuple(t) for t in e_taps)
        if len(self.row_combos) > MAX_ROW_COMBOS or \
                max(len(t) for t in self.e_taps) > MAX_LANE_TAPS or \
                n_act > MAX_ACTIONS:
            raise ValueError(
                f"{len(self.row_combos)} row combos, lane taps "
                f"{self.e_taps} and {n_act} actions exceed the kernel's "
                f"{MAX_ROW_COMBOS} combos, {MAX_LANE_TAPS} taps per lane axis"
                f" and {MAX_ACTIONS} actions")

        # the factorized stage cost
        c_row, c_lane, c_act, c_rowact, c_rowlane = _split_cost(
            terms, shape, nr, n_act)
        self.c_row, self.c_lane, self.c_act = c_row, c_lane, c_act

        def up(a, dtype):
            return _upload(a, dtype, plan.device)

        self.args = RowLaneArgs(
            row_shape=shape[:nr], lane_shape=shape[nr:],
            row_off=up(np.stack(w_off), torch.int32),
            row_frac=up(np.stack(w_frac), torch.float32),
            lane_off=tuple(up(a, torch.int32) for a in lane_off),
            lane_frac=tuple(up(a, torch.float32) for a in lane_frac),
            row_combos=self.row_combos, lane_taps=self.e_taps,
            c_row=up(c_row, torch.float32), c_lane=up(c_lane, torch.float32),
            c_act=tuple(float(x) for x in c_act),
            c_rowact=up(c_rowact, torch.float32),
            c_rowlane=up(c_rowlane, torch.float32))

    def _run(self, fn, values: torch.Tensor) -> BackupResult:
        v2 = values.permute(self.perm).reshape(self.NW, self.NE).contiguous()
        res = fn(v2, self.args)

        def back(a):
            return a.reshape(self.state_shape).permute(self.inv).contiguous()

        return BackupResult(back(res.values), back(res.argmin))

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
