"""Banded 2-D Bellman backup: the CUDA kernel, its plain version, its wrapper.

Replaces the TPU kernel ``ocdp_tpu/ops/pallas_backup.py::PallasBackup2D``
(``_kernel``) on the simplified attitude and position main paths. The kernel
source, with the argument that its four-corner sum equals the tap loop bit
for bit, its tie order and what bounds it, is ``csrc/band_backup2d.cu``.

* :func:`band_backup2d_cuda` launches the kernel on PyTorch's current
  stream; ``band_backup2d_cuda.launches`` counts its launches.
* :func:`band_backup2d_plain` is B.6's algorithm in plain PyTorch: the tap
  band, live taps and pad of :func:`~ocdp_tpu_torch.ops.stencil.
  stencil_taps` (analysed only for the plain version), a loop over the
  live taps of the zero-padded table with the
  weight ``[off==t](1-f) + [off==t-1]f``, the association
  ``(w1 * w2) * leaf`` and the t2-outer / t1-inner order of
  ``pallas_backup.py:116-142``. On a CUDA device the two agree bitwise.
* :class:`BandBackup2D` binds a plan and a cost into the engines'
  ``values -> BackupResult`` callable: the kernel on a CUDA tensor, the
  plain version on a CPU tensor; it never swaps one for the other.

The port adds a leading batch axis C to B.6: a 3-D plan is taken as C
independent 2-D problems when each query of axis 0 lands on its own
channel's grid point (position's channels, whose queries never move) and
axes 1-2's ``(lo, frac)`` do not vary along axis 0. Values are then
``(C, n1, n2)`` and the cost ``(C, A, n1, n2)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .backup import BackupResult
from .interp import InterpPlan
from .rowlane import _tap_weight
from .stencil import StencilTaps, stencil_taps

__all__ = ["BandArgs", "BandBackup2D", "band_backup2d_cuda",
           "band_backup2d_plain", "band_taps"]


class BandArgs(NamedTuple):
    """The kernel's inputs for one plan, on one device.

    ``lo``/``frac``: per axis one contiguous int32 / float32 pair in a
    common shape broadcastable to ``(n1, n2, A)`` (the kernel reads them
    through broadcast strides), ``lo`` in ``[0, n - 2]``. ``cost``: the
    dense ``(C, A, n1, n2)`` float32 stage cost.
    """

    lo: tuple
    frac: tuple
    cost: torch.Tensor

    @property
    def n_actions(self) -> int:
        return self.cost.shape[1]


def band_taps(args: BandArgs) -> StencilTaps:
    """The plain version's tap geometry for ``args``: the host analysis of
    :func:`~ocdp_tpu_torch.ops.stencil.stencil_taps`, with ``off_res`` as
    int32 tensors on ``args``' device. The kernel needs none of it."""
    grid2 = tuple(args.cost.shape[2:])
    st = stencil_taps(InterpPlan(tuple(args.lo), tuple(args.frac), grid2))
    dev = args.cost.device
    return st._replace(off_res=tuple(
        torch.from_numpy(np.ascontiguousarray(o)).to(dev) for o in st.off_res))


def _action(t: torch.Tensor, a: int) -> torch.Tensor:
    """``(n1|1, n2|1, A|1)`` -> the ``(n1|1, n2|1)`` slice of action a."""
    return t[..., a if t.shape[-1] > 1 else 0]


def band_backup2d_plain(values: torch.Tensor, args: BandArgs,
                        taps: StencilTaps | None = None) -> BackupResult:
    """B.6's function in plain PyTorch, on the kernel's inputs.

    ``values``: the ``(C, n1, n2)`` tables. ``taps``: :func:`band_taps` of
    ``args``, analysed here when not given. Every product and sum is one
    separately rounded PyTorch op, in the TPU kernel's order."""
    st = band_taps(args) if taps is None else taps
    n_c, n1, n2 = values.shape
    (p1lo, p1hi), (p2lo, p2hi) = st.pad
    vp = torch.nn.functional.pad(values, (p2lo, p2hi, p1lo, p1hi))
    (t1_lo, _), (t2_lo, _) = st.taps
    b1, b2 = st.base
    taps1, taps2 = st.valid_taps
    leaves = {}
    for t1 in taps1:
        r0 = b1 + t1 - t1_lo
        for t2 in taps2:
            c0 = b2 + t2 - t2_lo
            leaves[(t1, t2)] = vp[:, r0:r0 + n1, c0:c0 + n2]
    best = arg = None
    for a in range(args.n_actions):
        off1, fr1 = _action(st.off_res[0], a), _action(args.frac[0], a)
        off2, fr2 = _action(st.off_res[1], a), _action(args.frac[1], a)
        w1s = {t1: _tap_weight(off1, fr1, t1) for t1 in taps1}
        acc = torch.zeros((n_c, n1, n2), dtype=torch.float32,
                          device=values.device)
        for t2 in taps2:
            w2 = _tap_weight(off2, fr2, t2)
            for t1 in taps1:
                acc = acc + w1s[t1] * w2 * leaves[(t1, t2)]
        total = acc + args.cost[:, a]
        if best is None:
            best = total
            arg = torch.zeros((n_c, n1, n2), dtype=torch.int32,
                              device=values.device)
        else:
            better = total < best          # strict: the first minimum wins
            best = torch.where(better, total, best)
            arg = torch.where(better, a, arg)
    return BackupResult(best, arg)


def _strides(t: torch.Tensor) -> tuple:
    """Element strides of a contiguous ``(n1|1, n2|1, A|1)`` array over
    (row, lane, action), 0 on a broadcast axis."""
    s_r, s_l, s_a = t.shape
    return (s_l * s_a if s_r > 1 else 0, s_a if s_l > 1 else 0,
            1 if s_a > 1 else 0)


def _check_args(args: BandArgs) -> None:
    """Shapes, types, device and layout of a plan's fixed inputs; checked
    once, when :class:`BandBackup2D` builds them."""
    n_c, n_act, n1, n2 = args.cost.shape
    if max(n_c, n_act) * n1 * n2 >= 2**31:
        raise ValueError(f"{n_c}x{n1}x{n2} cells with {n_act} actions exceed "
                         "the kernel's int32 index")
    want = {"cost": ((n_c, n_act, n1, n2), torch.float32, args.cost)}
    for k in range(2):
        shape = tuple(args.lo[k].shape)
        if len(shape) != 3 or any(s not in (1, n) for s, n in
                                  zip(shape, (n1, n2, n_act))):
            raise ValueError(f"lo[{k}] shape {shape} does not broadcast to "
                             f"{(n1, n2, n_act)}")
        want[f"lo[{k}]"] = (shape, torch.int32, args.lo[k])
        want[f"frac[{k}]"] = (shape, torch.float32, args.frac[k])
    for name, (shape, dtype, t) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != args.cost.device:
            raise ValueError(f"{name} is on {t.device}, the cost on "
                             f"{args.cost.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def band_backup2d_cuda(values: torch.Tensor, args: BandArgs) -> BackupResult:
    """Launch the CUDA kernel for one sweep of the ``(C, n1, n2)`` tables.
    Raises on tables it does not take and on a launch the device refuses.
    ``args`` are those a :class:`BandBackup2D` built and checked once
    (shapes, types, layout, ``lo`` in ``[0, n-2]``); per call only the
    tables are checked against them."""
    from .. import _build

    n_c, n_act, n1, n2 = args.cost.shape
    if (tuple(values.shape) != (n_c, n1, n2)
            or values.dtype != torch.float32):
        raise ValueError(f"values: want torch.float32 {(n_c, n1, n2)}, got "
                         f"{values.dtype} {tuple(values.shape)}")
    if not values.is_cuda or values.device != args.cost.device:
        raise ValueError(f"values on {values.device}, the plan on "
                         f"{args.cost.device}: both must be on one CUDA "
                         "device")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    lib = _build.load()
    out_v = torch.empty((n_c, n1, n2), dtype=torch.float32,
                        device=values.device)
    out_a = torch.empty((n_c, n1, n2), dtype=torch.int32,
                        device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.band_backup2d_f32(
        values.data_ptr(), args.lo[0].data_ptr(), args.frac[0].data_ptr(),
        args.lo[1].data_ptr(), args.frac[1].data_ptr(), args.cost.data_ptr(),
        out_v.data_ptr(), out_a.data_ptr(), n_c, n1, n2, n_act,
        *_strides(args.lo[0]), *_strides(args.lo[1]), stream)
    if err != 0:
        msg = lib.band_backup2d_error_string(err).decode()
        raise RuntimeError(f"band_backup2d launch failed: CUDA error {err} "
                           f"({msg})")
    band_backup2d_cuda.launches += 1
    return BackupResult(out_v, out_a)


band_backup2d_cuda.launches = 0


def _as3(t: torch.Tensor) -> torch.Tensor:
    return t.reshape((1,) * (3 - t.ndim) + tuple(t.shape))


def _channel_axis(plan: InterpPlan) -> None:
    """Raise unless every query of a 3-D plan's axis 0 lands on its own
    channel's grid point (``lo + frac`` is the channel index, ``frac`` 0,
    or 1 where ``build_plan`` clamps ``lo`` to ``n - 2`` at the last
    channel) and axes 1-2's ``(lo, frac)`` do not vary along axis 0."""
    qs = plan.query_shape
    lo0 = plan.lo[0].expand(qs).to(torch.int64)
    f0 = plan.frac[0].expand(qs)
    idx = torch.arange(qs[0], device=lo0.device).reshape(-1, 1, 1, 1)
    own = ((lo0 == idx) & (f0 == 0.0)) | ((lo0 == idx - 1) & (f0 == 1.0))
    if not bool(own.all()):
        raise ValueError(
            "BandBackup2D takes a 3-D plan only as a batch of 2-D problems: "
            "its axis-0 queries must stay on their own grid point (this "
            "plan's leading axis moves); use the gather backup")
    for k in (1, 2):
        for name, t in (("lo", plan.lo[k]), ("frac", plan.frac[k])):
            if t.shape[0] > 1 and not bool((t == t[:1]).all()):
                raise ValueError(
                    f"{name}[{k}] varies along the batch axis 0; "
                    "BandBackup2D needs one 2-D plan for every channel")


class BandBackup2D:
    """Callable ``values -> BackupResult`` over one plan and stage cost, the
    counterpart of ``PallasBackup2D``.

    ``plan``: an :class:`InterpPlan` with queries ``(n1, n2, A)``, or a
    3-D one ``(C, n1, n2, A)`` whose axis 0 is a batch of channels (see the
    module docstring; another 3-D plan raises ``ValueError``).
    ``stage_cost``: one array or a sequence of broadcast-shaped terms
    (tensors or arrays), summed on the host in term order into the dense
    float32 cost, as ``pallas_backup.py:83-88`` does.
    """

    def __init__(self, plan: InterpPlan, stage_cost):
        if plan.ndim == 3:
            _channel_axis(plan)
            lo = [plan.lo[k][0] for k in (1, 2)]
            fr = [plan.frac[k][0] for k in (1, 2)]
        elif plan.ndim == 2:
            lo, fr = list(plan.lo), list(plan.frac)
        else:
            raise ValueError(
                "BandBackup2D supports 2-D state grids, and 3-D ones whose "
                f"axis 0 is a batch of channels; got {plan.ndim}-D")
        self.batched = plan.ndim == 3
        grid2 = tuple(plan.grid_shape[-2:])
        for k in range(2):
            if lo[k].numel() and (int(lo[k].min()) < 0 or
                                  int(lo[k].max()) > grid2[k] - 2):
                raise ValueError(f"plan.lo[{k}] leaves [0, n-2]")
            lo[k], fr[k] = torch.broadcast_tensors(_as3(lo[k]), _as3(fr[k]))
            lo[k] = lo[k].to(torch.int32).contiguous()
            fr[k] = fr[k].to(torch.float32).contiguous()
        qs = plan.query_shape
        terms = (list(stage_cost) if isinstance(stage_cost, (tuple, list))
                 else [stage_cost])
        cost = np.zeros(qs, np.float32)
        for t in terms:
            if isinstance(t, torch.Tensor):
                t = t.detach().cpu().numpy()
            cost = cost + np.asarray(t, np.float32)
        cost = np.moveaxis(cost, -1, -3)
        if not self.batched:
            cost = cost[None]
        dev = plan.device
        self.args = BandArgs(
            lo=tuple(lo), frac=tuple(fr),
            cost=torch.from_numpy(np.ascontiguousarray(cost)).to(dev))
        _check_args(self.args)
        self._taps = None

    @property
    def taps(self) -> StencilTaps:
        """The plain version's tap geometry (:func:`band_taps`), analysed
        at its first use: the kernel does not need it."""
        if self._taps is None:
            self._taps = band_taps(self.args)
        return self._taps

    def _run(self, fn, values: torch.Tensor) -> BackupResult:
        v = values if self.batched else values[None]
        res = fn(v.contiguous())
        if self.batched:
            return res
        return BackupResult(res.values[0], res.argmin[0])

    def __call__(self, values: torch.Tensor) -> BackupResult:
        if values.is_cuda:
            return self._run(
                lambda v: band_backup2d_cuda(v, self.args), values)
        if values.device.type == "cpu":
            return self.plain(values)
        raise ValueError(f"no band_backup2d for device {values.device}")

    def plain(self, values: torch.Tensor) -> BackupResult:
        """The plain PyTorch version on any device (``impl='plain'``)."""
        return self._run(
            lambda v: band_backup2d_plain(v, self.args, self.taps), values)
