"""The tap analysis of the row/lane and 6-D backups done on the host, in
numpy: the oracle of ``ocdp_tpu_torch/ops/liveness.py`` and of the
argument tensors that ``RowLaneBackup`` and ``Backup6D`` form where the
plan lies.

The backups analysed their plans this way before the analysis moved to the
plan's device: every plan array copied to the host, the live combos found by
one encode and ``np.unique`` over it, the row and lane tables formed there.
Each function returns the kernel's arguments as numpy arrays and host
tuples, under the field names of ``RowLaneArgs``/``Backup6DArgs``.
"""

import itertools

import numpy as np
import torch


def as_numpy(a, dtype=None):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def corner_live_sets(axis_offs, axis_fracs):
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
    return decode_live(np.unique(enc).tolist(), base, span, k)


def decode_live(enc_values, base, span, k):
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


def detect_action_digits(w_off, w_frac, nr):
    """The digit base m when ``A = m**nr`` and row axis k's (off, frac)
    columns depend only on digit k of the C-order action index, else
    None."""
    n_act = w_off[0].shape[1]
    m = round(n_act ** (1.0 / nr))
    if m**nr != n_act or m < 2:
        return None
    for k in range(nr):
        stride = m ** (nr - 1 - k)
        for a in range(n_act):
            rep = (a // stride) % m * stride
            if not (np.array_equal(w_off[k][:, a], w_off[k][:, rep])
                    and np.array_equal(w_frac[k][:, a], w_frac[k][:, rep])):
                return None
    return m


def row_plan(lo, fr, shape, nr, n_act):
    d = len(shape)
    nw = int(np.prod(shape[:nr]))
    target = shape[:nr] + (1,) * (d - nr) + (n_act,)
    w_off, w_frac = [], []
    for k in range(nr):
        idx = np.arange(shape[k], dtype=np.int32).reshape(
            (1,) * k + (-1,) + (1,) * (d - k))
        w_off.append(np.broadcast_to(lo[k] - idx, target).reshape(nw, n_act))
        w_frac.append(np.broadcast_to(fr[k], target).reshape(nw, n_act))
    return w_off, w_frac


def split_cost(terms, shape, nr, n_act):
    """Row, lane, action, row x action and row x lane parts, each
    accumulated in term order."""
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
    return dict(c_row=c_row, c_lane=c_lane, c_act=tuple(float(x)
                                                         for x in c_act),
                c_rowact=c_rowact, c_rowlane=c_rowlane)


def _with_unit_axis(lo, fr, terms, shape, p):
    unit = (1,) * (len(shape) + 2)
    lo = [np.expand_dims(a, p) for a in lo]
    fr = [np.expand_dims(a, p) for a in fr]
    lo.insert(p, np.zeros(unit, np.int32))
    fr.insert(p, np.zeros(unit, np.float32))
    terms = [np.expand_dims(t, p) for t in terms]
    return lo, fr, terms, shape[:p] + (1,) + shape[p:]


def _listed(cost_terms):
    return (list(cost_terms) if isinstance(cost_terms, (tuple, list))
            else [cost_terms])


def rowlane_args(plan, cost_terms, perm, row_axes):
    """``RowLaneBackup(plan, cost_terms, perm, row_axes=row_axes).args`` as
    the host analysis formed them, and its ``w_taps`` and ``lane_combos``."""
    d = plan.ndim
    ap = tuple(perm) + (d,)

    def permuted(a):
        a = as_numpy(a)
        if a.ndim != d + 1:
            a = a.reshape((1,) * (d + 1 - a.ndim) + a.shape)
        return np.transpose(a, ap)

    lo = [permuted(plan.lo[k]).astype(np.int32) for k in perm]
    fr = [permuted(plan.frac[k]).astype(np.float32) for k in perm]
    terms = [permuted(t) for t in _listed(cost_terms)]
    shape = tuple(plan.grid_shape[k] for k in perm)
    n_act = plan.query_shape[-1]
    nr = row_axes
    nw = int(np.prod(shape[:nr]))
    if nr == 1:
        lo, fr, terms, shape = _with_unit_axis(lo, fr, terms, shape, 0)
        nr = 2
    if len(shape) - nr == 1:
        lo, fr, terms, shape = _with_unit_axis(lo, fr, terms, shape, nr)
    d = len(shape)
    w_off, w_frac = row_plan(lo, fr, shape, nr, n_act)
    e_off, e_frac, lane_off, lane_frac = [], [], [], []
    for k in range(nr, d):
        iota = np.arange(shape[k], dtype=np.int32).reshape(
            (1,) * k + (-1,) + (1,) * (d - 1 - k))
        e_off.append(lo[k][..., 0] - iota)
        e_frac.append(fr[k][..., 0])
        own = shape[:nr] + tuple(shape[k] if j == k else 1
                                 for j in range(nr, d))
        lane_off.append(np.broadcast_to(e_off[-1], own).reshape(nw, shape[k]))
        lane_frac.append(np.broadcast_to(e_frac[-1], own)
                         .reshape(nw, shape[k]))
    w_taps, row_combos = corner_live_sets(w_off, w_frac)
    e_taps, lane_combos = corner_live_sets(e_off, e_frac)
    return dict(row_shape=shape[:nr], lane_shape=shape[nr:],
                row_off=np.stack(w_off), row_frac=np.stack(w_frac),
                lane_off=tuple(lane_off), lane_frac=tuple(lane_frac),
                row_combos=tuple(row_combos),
                lane_taps=tuple(tuple(t) for t in e_taps),
                **split_cost(terms, shape, nr, n_act)), \
        dict(w_taps=tuple(tuple(t) for t in w_taps),
             lane_combos=tuple(lane_combos))


def backup6d_args(plan, cost_terms):
    """``Backup6D(plan, cost_terms).args`` for a broadcast-layout plan, as
    the host analysis formed them."""
    d, nr = plan.ndim, 3
    q_shape = plan.query_shape
    shape = tuple(q_shape[:-1])
    n_act = q_shape[-1]
    nw, ne = int(np.prod(shape[:nr])), int(np.prod(shape[nr:]))

    def full_rank(a, dtype):
        a = as_numpy(a).astype(dtype, copy=False)
        return a.reshape((1,) * (d + 1 - a.ndim) + a.shape)

    lo = [full_rank(x, np.int32) for x in plan.lo]
    fr = [full_rank(x, np.float32) for x in plan.frac]
    w_off, w_frac = row_plan(lo, fr, shape, nr, n_act)
    e_off, e_frac = [], []
    for k in range(nr, d):
        iota = np.arange(shape[k], dtype=np.int32).reshape(
            (1,) * k + (-1,) + (1,) * (d - 1 - k))
        e_off.append(lo[k][..., 0] - iota)
        e_frac.append(fr[k][..., 0])
    w_taps, row_combos = corner_live_sets(w_off, w_frac)
    _, lane_combos = corner_live_sets(e_off, e_frac)

    def lane_table(a):
        return np.broadcast_to(a, shape).reshape(nw, ne)

    return dict(row_shape=shape[:nr], lane_shape=shape[nr:],
                row_off=np.stack(w_off), row_frac=np.stack(w_frac),
                lane_off=tuple(lane_table(a) for a in e_off),
                lane_frac=tuple(lane_table(a) for a in e_frac),
                row_combos=tuple(row_combos), lane_combos=tuple(lane_combos),
                w_taps=tuple(tuple(t) for t in w_taps),
                action_digits=detect_action_digits(w_off, w_frac, nr),
                **split_cost([full_rank(t, np.float32)
                              for t in _listed(cost_terms)], shape, nr,
                             n_act))


def backup6d_flat_args(plan, cost_terms):
    """``Backup6D(plan, cost_terms).args`` for a flat plan (a stored lane
    plan, or a recompute plan whose lanes are generated whole on the host
    and admitted at both corners), as the host analysis formed them."""
    nr = 3
    shape = tuple(plan.grid_shape)
    nw, ne = int(np.prod(shape[:nr])), int(np.prod(shape[nr:]))
    n_act = plan.query_shape[-1]

    def own_index(sizes):
        i = np.arange(int(np.prod(sizes)), dtype=np.int32)
        return [(i // int(np.prod(sizes[k + 1:]))) % sizes[k]
                for k in range(len(sizes))]

    row_own = own_index(shape[:nr])
    w_off = [np.broadcast_to(as_numpy(plan.lo[k])[:, 0, :].astype(np.int32)
                             - row_own[k][:, None], (nw, n_act))
             for k in range(nr)]
    w_frac = [np.broadcast_to(as_numpy(plan.frac[k])[:, 0, :], (nw, n_act))
              .astype(np.float32) for k in range(nr)]
    w_taps, row_combos = corner_live_sets(w_off, w_frac)
    out = dict(row_shape=shape[:nr], lane_shape=shape[nr:],
               row_off=np.stack(w_off), row_frac=np.stack(w_frac),
               row_combos=tuple(row_combos),
               w_taps=tuple(tuple(t) for t in w_taps),
               action_digits=detect_action_digits(w_off, w_frac, nr))
    if hasattr(plan, "spec"):
        offs = [as_numpy(o) for o in plan.spec.lane_block(0, nw)[0]]
        fracs = [np.full((1, 1), 0.5, np.float32)] * 3
        out.update(lane_off=(), lane_frac=())
    else:
        own = own_index(shape[nr:])
        offs = [np.broadcast_to(as_numpy(plan.lo[k])[..., 0].astype(np.int32)
                                - own[k - nr], (nw, ne)) for k in range(nr, 6)]
        fracs = [np.broadcast_to(as_numpy(plan.frac[k])[..., 0], (nw, ne))
                 .astype(np.float32) for k in range(nr, 6)]
        out.update(lane_off=tuple(offs), lane_frac=tuple(fracs))
    out["lane_combos"] = tuple(corner_live_sets(offs, fracs)[1])

    def broadcast_term(t):
        t = as_numpy(t).astype(np.float32, copy=False)
        t = t.reshape((1,) * (3 - t.ndim) + t.shape)
        rows = shape[:nr] if t.shape[0] > 1 else (1,) * nr
        lanes = shape[nr:] if t.shape[1] > 1 else (1,) * (len(shape) - nr)
        return t.reshape(rows + lanes + t.shape[2:])

    out.update(split_cost([broadcast_term(t) for t in _listed(cost_terms)],
                          shape, nr, n_act))
    return out
