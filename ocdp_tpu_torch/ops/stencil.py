"""The banded-stencil tap analysis of a plan.

Counterpart of the analysis half of ``ocdp_tpu/ops/stencil.py::
build_stencil_backup`` (:458-673) for one state block, one action chunk,
on-the-fly weights, not rolled, no edge split. The stencil's execution modes
(unrolled, rolled-flat, clamp-split, precomputed weights, state blocking)
exist for XLA on a TPU and are not ported; what is kept is the geometry they
share, which the plain version of the banded 2-D backup
(:func:`~ocdp_tpu_torch.ops.band_backup2d.band_backup2d_plain`) sweeps.

Per state axis k a query's cell offset is ``lo[k] - i_k`` (its own index
along k). One integer base, the midpoint of the offsets' range, is taken out;
the residual offsets then span the tap band ``(t_lo, t_hi)``, and tap t reads
``V[i + base + t]``. A tap is live when some query gives it a nonzero
weight, ``[off == t](1 - frac) + [off == t - 1] frac``. The table is padded
with zeros so that every tap of the band reads inside it.

Host numpy, once per plan.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .interp import InterpPlan

__all__ = ["StencilTaps", "stencil_taps"]


class StencilTaps(NamedTuple):
    """The tap geometry of a plan, per state axis.

    ``taps[k]``: the residual band ``(t_lo, t_hi)``; the sweep visits taps
    ``t_lo .. t_hi + 1``. ``valid_taps[k]``: the live ones, ascending.
    ``pad[k]``: zero rows ``(before, after)`` of the padded table.
    ``base[k]``: the padded index of tap ``t_lo``'s read at cell 0, so tap t
    reads padded index ``i + base[k] + t - t_lo``. ``off_res[k]`` (int32):
    each query's residual offset, in the plan's broadcast shapes.
    """

    taps: tuple
    valid_taps: tuple
    pad: tuple
    base: tuple
    off_res: tuple


def _numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def stencil_taps(plan: InterpPlan) -> StencilTaps:
    """Analyse ``plan``'s tap geometry (``build_stencil_backup`` with one
    block and one chunk over all actions). Unlike the JAX analysis it puts
    no cap on the band: the plain tap loop that consumes it only grows
    slower with it."""
    d = plan.ndim
    state_shape = tuple(plan.query_shape[:-1])
    taps, valid, pads, bases, offs = [], [], [], [], []
    for k in range(d):
        lo = _numpy(plan.lo[k]).astype(np.int64)
        fr = _numpy(plan.frac[k]).astype(np.float32)
        idx_shape = [1] * lo.ndim
        idx_shape[k] = lo.shape[k]
        # a plan that does not vary along its own axis k measures its
        # offsets from cell 0
        idx = (np.zeros(idx_shape, np.int64) if lo.shape[k] == 1
               else np.arange(lo.shape[k], dtype=np.int64).reshape(idx_shape))
        off = lo - idx
        base_k = (int(off.min()) + int(off.max())) // 2 if off.size > 1 \
            else 0
        res = off - base_k
        t_lo, t_hi = int(res.min()), int(res.max())
        glob_min = min(int(off.min()), base_k + t_lo)
        glob_max = int(off.max())
        pad = [-min(glob_min, 0), max(glob_max, 0) + 1]
        # the band's window (block + span from the base) must stay inside
        # the padded table
        span = t_hi + 1 - t_lo
        need = pad[0] + base_k + t_lo + state_shape[k] + span
        dim = plan.grid_shape[k] + pad[0] + pad[1]
        if need > dim:
            pad[1] += need - dim
        res_b, fr_b = np.broadcast_arrays(res, fr)
        live = tuple(
            t for t in range(t_lo, t_hi + 2)
            if np.any((res_b == t) & (1.0 - fr_b != 0.0))
            or np.any((res_b == t - 1) & (fr_b != 0.0)))
        taps.append((t_lo, t_hi))
        valid.append(live)
        pads.append(tuple(pad))
        bases.append(pad[0] + base_k + t_lo)
        offs.append(res.astype(np.int32))
    return StencilTaps(tuple(taps), tuple(valid), tuple(pads), tuple(bases),
                       tuple(offs))
