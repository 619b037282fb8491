"""Live interpolation taps of a group of axes, and whether the actions
factor digit by digit.

A tap combo (t_0..t_{k-1}), each the offset of a multilinear corner from
the cell's own index on one axis, is live when some query reaches it with
a nonzero weight on every axis (``1 - frac`` at the low corner, ``frac``
at the high one). The work of a sweep is counted over the live combos.
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = ["live_sets", "action_digits"]


def live_sets(offs, fracs):
    """``(per-axis taps, combos)``, both sorted, of broadcast numpy arrays of
    per-axis offsets (``lo`` minus the cell's own index) and fractions."""
    k = len(offs)
    base = [int(np.min(o)) for o in offs]
    span = [int(np.max(o)) - b + 1 for o, b in zip(offs, base)]
    shape = np.broadcast_shapes(*(np.shape(a) for a in (*offs, *fracs)))
    enc = np.zeros(shape, np.int64)
    for o, b, s in zip(offs, base, span):
        enc = enc * s + (np.asarray(o, np.int64) - b)
    for fr in fracs:
        fr = np.asarray(fr, np.float32)
        enc = (enc << 2) | (fr != np.float32(1.0)) \
            | ((fr != np.float32(0.0)).astype(np.int64) << 1)
    combos = set()
    for e in np.unique(enc).tolist():
        bits = [(e >> (2 * (k - 1 - i))) & 3 for i in range(k)]
        rest = e >> (2 * k)
        o = []
        for s in reversed(span):
            rest, r = divmod(rest, s)
            o.append(r)
        o = o[::-1]
        for corner in itertools.product((0, 1), repeat=k):
            if all((b >> c) & 1 for c, b in zip(corner, bits)):
                combos.add(tuple(x + b + c for x, b, c in zip(o, base, corner)))
    combos = sorted(combos)
    return [sorted({c[i] for c in combos}) for i in range(k)], combos


def action_digits(offs, fracs):
    """The digit base m when there are ``m**k`` actions (last axis of each
    ``(NW, A)`` array) and row axis k's next state depends on digit k of
    the C-order action index alone, else None."""
    k = len(offs)
    n_act = offs[0].shape[-1]
    m = round(n_act ** (1.0 / k))
    if m ** k != n_act or m < 2:
        return None
    for i in range(k):
        stride = m ** (k - 1 - i)
        for a in range(n_act):
            rep = (a // stride) % m * stride
            if not (np.array_equal(offs[i][:, a], offs[i][:, rep])
                    and np.array_equal(fracs[i][:, a], fracs[i][:, rep])):
                return None
    return m
