"""Banded 2-D Bellman backup: the CUDA kernel, its plain version, its wrapper.

Replaces the TPU kernel ``ocdp_tpu/ops/pallas_backup.py::PallasBackup2D``
(``_kernel``) on the simplified attitude and position main paths. The kernel
source, with the argument that its four-corner sum equals the tap loop bit
for bit, its tie order and what bounds it, is ``csrc/band_backup2d.cu``.

* :func:`band_backup2d_cuda` launches the kernel on PyTorch's current
  stream; ``band_backup2d_cuda.launches`` counts its launches and
  ``band_backup2d_cuda.channel_sweeps`` the channels they swept.
* :func:`band_backup2d_plain` is B.6's algorithm in plain PyTorch: the tap
  band, live taps and pad of :func:`~ocdp_tpu_torch.ops.stencil.
  stencil_taps` (analysed only for the plain version), a loop over the
  live taps of the zero-padded table with the
  weight ``[off==t](1-f) + [off==t-1]f``, the association
  ``(w1 * w2) * leaf`` and the t2-outer / t1-inner order of
  ``pallas_backup.py:116-142``. On a CUDA device the two agree bitwise.
* :class:`BandBackup2D` binds a plan and a cost into the engines'
  ``values -> BackupResult`` callable: the kernel on a CUDA tensor, the
  plain version on a CPU tensor; it never swaps one for the other. It is
  graph-safe (``graph_safe``): :meth:`BandBackup2D.sweep_into` writes a
  sweep into the caller's buffers, which the finite engine replays as CUDA
  graphs.

The port adds a leading batch axis C to B.6. A 3-D plan is taken as C
independent 2-D problems when each query of axis 0 lands on its own
channel's grid point (position's channels, whose queries never move);
:meth:`BandBackup2D.stack` batches separate 2-D problems of one shape, each
with its own plan (the three simplified attitude axes). Values are then
``(C, n1, n2)``; the plan arrays are ``(C|1, n1|1, n2|1, A|1)``, read with a
channel stride of 0 where the channels share them.

The stage cost is factorized: up to ``MAX_TERMS`` broadcast-shaped terms,
each read through its own strides over (channel, row, lane, action) and
summed from +0 in term order, the order and rounding in which the dense
cost was summed before (``pallas_backup.py:83-88``). A dense cost is one
term.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .backup import BackupResult
from .interp import InterpPlan
from .rowlane import _tap_weight
from .stencil import StencilTaps, stencil_taps

__all__ = ["BandArgs", "BandBackup2D", "MAX_TERMS", "band_backup2d_cuda",
           "band_backup2d_plain", "band_taps"]

MAX_TERMS = 4          # kMaxTerms in csrc/band_backup2d.cu


class BandArgs(NamedTuple):
    """The kernel's inputs for one batch of 2-D problems, on one device.

    ``lo``/``frac``: per axis one contiguous int32 / float32 pair in a
    common shape broadcastable to ``(C, n1, n2, A)``, ``lo`` in
    ``[0, n - 2]``. ``terms``: up to ``MAX_TERMS`` contiguous float32 cost
    terms, each broadcastable to ``(C, n1, n2, A)``, whose sum from +0 in
    order is the stage cost. ``shape``: ``(C, n1, n2, A)``.
    """

    lo: tuple
    frac: tuple
    terms: tuple
    shape: tuple

    @property
    def n_actions(self) -> int:
        return self.shape[3]

    @property
    def shared_plan(self) -> bool:
        """Whether every channel reads one plan (a channel stride of 0)."""
        return all(t.shape[0] == 1 for t in self.lo + self.frac)

    def dense_cost(self) -> torch.Tensor:
        """The ``(C, A, n1, n2)`` stage cost the kernel sums, summed the
        same way (from +0 in term order)."""
        n_c, n1, n2, n_act = self.shape
        cost = torch.zeros((n_c, n1, n2, n_act), dtype=torch.float32,
                           device=self.lo[0].device)
        for t in self.terms:
            cost = cost + t
        return cost.permute(0, 3, 1, 2)

    def channel(self, c: int) -> "BandArgs":
        """Channel ``c`` alone, as a batch of one."""
        def pick(t):
            return t[c:c + 1] if t.shape[0] > 1 else t
        return BandArgs(tuple(pick(t) for t in self.lo),
                        tuple(pick(t) for t in self.frac),
                        tuple(pick(t) for t in self.terms),
                        (1,) + tuple(self.shape[1:]))


def band_taps(args: BandArgs) -> tuple:
    """The plain version's tap geometry for ``args``, one
    :class:`~ocdp_tpu_torch.ops.stencil.StencilTaps` per plan: one for a
    shared plan, else one a channel. The host analysis of
    :func:`~ocdp_tpu_torch.ops.stencil.stencil_taps`, with ``off_res`` as
    int32 tensors on ``args``' device. The kernel needs none of it."""
    grid2 = tuple(args.shape[1:3])
    dev = args.lo[0].device
    plans = ([args] if args.shared_plan
             else [args.channel(c) for c in range(args.shape[0])])
    out = []
    for a in plans:
        st = stencil_taps(InterpPlan(tuple(t[0] for t in a.lo),
                                     tuple(t[0] for t in a.frac), grid2))
        out.append(st._replace(off_res=tuple(
            torch.from_numpy(np.ascontiguousarray(o)).to(dev)
            for o in st.off_res)))
    return tuple(out)


def _action(t: torch.Tensor, a: int) -> torch.Tensor:
    """``(..., n1|1, n2|1, A|1)`` -> the ``(..., n1|1, n2|1)`` slice of
    action a."""
    return t[..., a if t.shape[-1] > 1 else 0]


def _plain_group(values, fracs, terms, st: StencilTaps, n_actions):
    """The tap loop over ``values`` ``(Cg, n1, n2)`` whose channels read one
    plan (``st`` and ``fracs``, its fracs per axis, ``(n1|1, n2|1, A|1)``) and
    the cost ``terms`` ``(Cg|1, n1|1, n2|1, A|1)``."""
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
    for a in range(n_actions):
        off1, fr1 = _action(st.off_res[0], a), _action(fracs[0], a)
        off2, fr2 = _action(st.off_res[1], a), _action(fracs[1], a)
        w1s = {t1: _tap_weight(off1, fr1, t1) for t1 in taps1}
        acc = torch.zeros((n_c, n1, n2), dtype=torch.float32,
                          device=values.device)
        for t2 in taps2:
            w2 = _tap_weight(off2, fr2, t2)
            for t1 in taps1:
                acc = acc + w1s[t1] * w2 * leaves[(t1, t2)]
        cost = torch.zeros((n_c, n1, n2), dtype=torch.float32,
                           device=values.device)
        for t in terms:
            cost = cost + _action(t, a)
        total = acc + cost
        if best is None:
            best = total
            arg = torch.zeros((n_c, n1, n2), dtype=torch.int32,
                              device=values.device)
        else:
            better = total < best          # strict: the first minimum wins
            best = torch.where(better, total, best)
            arg = torch.where(better, a, arg)
    return best, arg


def band_backup2d_plain(values: torch.Tensor, args: BandArgs,
                        taps: tuple | None = None) -> BackupResult:
    """B.6's function in plain PyTorch, on the kernel's inputs.

    ``values``: the ``(C, n1, n2)`` tables. ``taps``: :func:`band_taps` of
    ``args``, analysed here when not given. Every product and sum is one
    separately rounded PyTorch op, in the TPU kernel's order; the cost is
    summed from +0 in term order, as the kernel sums it."""
    st = band_taps(args) if taps is None else taps
    if args.shared_plan:
        best, arg = _plain_group(values, tuple(t[0] for t in args.frac),
                                 args.terms, st[0], args.n_actions)
        return BackupResult(best, arg)
    vals, args_out = [], []
    for c in range(args.shape[0]):
        a = args.channel(c)
        best, arg = _plain_group(values[c:c + 1],
                                 tuple(t[0] for t in a.frac), a.terms,
                                 st[c], args.n_actions)
        vals.append(best)
        args_out.append(arg)
    return BackupResult(torch.cat(vals), torch.cat(args_out))


def _strides(t: torch.Tensor) -> tuple:
    """Element strides of a contiguous ``(C|1, n1|1, n2|1, A|1)`` array over
    (channel, row, lane, action), 0 on a broadcast axis."""
    return tuple(s if n > 1 else 0 for s, n in zip(t.stride(), t.shape))


def _check_args(args: BandArgs) -> None:
    """Shapes, types, device and layout of the fixed inputs; checked once,
    when :class:`BandBackup2D` builds them."""
    n_c, n1, n2, n_act = args.shape
    if n_c * n_act * n1 * n2 >= 2**31:
        raise ValueError(f"{n_c}x{n1}x{n2} cells with {n_act} actions exceed "
                         "the kernel's int32 index")
    if not 1 <= len(args.terms) <= MAX_TERMS:
        raise ValueError(f"{len(args.terms)} cost terms; the kernel takes 1 "
                         f"to {MAX_TERMS}")
    dev = args.lo[0].device
    want = {}
    for k in range(2):
        want[f"lo[{k}]"] = (torch.int32, args.lo[k])
        want[f"frac[{k}]"] = (torch.float32, args.frac[k])
        if args.lo[k].shape != args.frac[k].shape:
            raise ValueError(f"lo[{k}] and frac[{k}] differ in shape")
    for i, t in enumerate(args.terms):
        want[f"terms[{i}]"] = (torch.float32, t)
    for name, (dtype, t) in want.items():
        shape = tuple(t.shape)
        if len(shape) != 4 or any(s not in (1, n) for s, n in
                                  zip(shape, args.shape)):
            raise ValueError(f"{name} shape {shape} does not broadcast to "
                             f"{tuple(args.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the plan on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_table(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype:
        raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} on {t.device}, the plan on {device}: both "
                         "must be on one CUDA device")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def band_backup2d_cuda(values: torch.Tensor, args: BandArgs, *,
                       out_v: torch.Tensor | None = None,
                       out_a: torch.Tensor | None = None) -> BackupResult:
    """Launch the CUDA kernel for one sweep of the ``(C, n1, n2)`` tables,
    into new outputs or the caller's ``out_v``/``out_a`` (float32 and int32
    ``(C, n1, n2)``, not overlapping ``values``). Raises on tables it does
    not take and on a launch the device refuses. ``args`` are those a
    :class:`BandBackup2D` built and checked once (shapes, types, layout,
    ``lo`` in ``[0, n-2]``); per call only the tables are checked. The
    launch allocates nothing when given its outputs and sets no function
    attribute, so a CUDA graph may capture it."""
    from .. import _build

    n_c, n1, n2, n_act = args.shape
    dev = args.lo[0].device
    _check_table("values", values, (n_c, n1, n2), torch.float32, dev)
    if out_v is None:
        out_v = torch.empty((n_c, n1, n2), dtype=torch.float32, device=dev)
    if out_a is None:
        out_a = torch.empty((n_c, n1, n2), dtype=torch.int32, device=dev)
    _check_table("out_v", out_v, (n_c, n1, n2), torch.float32, dev)
    _check_table("out_a", out_a, (n_c, n1, n2), torch.int32, dev)
    if out_v.data_ptr() == values.data_ptr():
        raise ValueError("out_v must not be the input table")
    lib = _build.load()
    ptrs = np.zeros(7 + MAX_TERMS, np.int64)
    ptrs[:7] = (values.data_ptr(), out_v.data_ptr(), out_a.data_ptr(),
                args.lo[0].data_ptr(), args.frac[0].data_ptr(),
                args.lo[1].data_ptr(), args.frac[1].data_ptr())
    ptrs[7:7 + len(args.terms)] = [t.data_ptr() for t in args.terms]
    ints = np.zeros(5 + 4 * (2 + MAX_TERMS), np.int32)
    ints[:5] = (n_c, n1, n2, n_act, len(args.terms))
    for k, t in enumerate((args.lo[0], args.lo[1], *args.terms)):
        ints[5 + 4 * k:9 + 4 * k] = _strides(t)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.band_backup2d_f32(ptrs.ctypes.data, ints.ctypes.data, stream)
    if err != 0:
        msg = lib.band_backup2d_error_string(err).decode()
        raise RuntimeError(f"band_backup2d launch failed: CUDA error {err} "
                           f"({msg})")
    band_backup2d_cuda.launches += 1
    band_backup2d_cuda.channel_sweeps += n_c
    return BackupResult(out_v, out_a)


band_backup2d_cuda.launches = 0
band_backup2d_cuda.channel_sweeps = 0


def _channel_axis(plan: InterpPlan) -> None:
    """Raise unless every query of a 3-D plan's axis 0 lands on its own
    channel's grid point (``lo + frac`` is the channel index, ``frac`` 0,
    or 1 where ``build_plan`` clamps ``lo`` to ``n - 2`` at the last
    channel)."""
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


def _as4(t: torch.Tensor) -> torch.Tensor:
    return t.reshape((1,) * (4 - t.ndim) + tuple(t.shape))


def _terms(stage_cost) -> list:
    """The cost terms as float32 tensors: at most ``MAX_TERMS``, the first
    of them the sum from +0 of any excess leading terms."""
    terms = (list(stage_cost) if isinstance(stage_cost, (tuple, list))
             else [stage_cost])
    terms = [torch.as_tensor(np.asarray(t, np.float32))
             if not isinstance(t, torch.Tensor) else t.to(torch.float32)
             for t in terms]
    if len(terms) > MAX_TERMS:
        head = len(terms) - MAX_TERMS + 1
        folded = torch.zeros((), dtype=torch.float32,
                             device=terms[0].device)
        for t in terms[:head]:
            folded = folded + t.to(terms[0].device)
        terms = [folded] + terms[head:]
    return terms


class BandBackup2D:
    """Callable ``values -> BackupResult`` over one plan and stage cost, the
    counterpart of ``PallasBackup2D``.

    ``plan``: an :class:`InterpPlan` with queries ``(n1, n2, A)``, or a
    3-D one ``(C, n1, n2, A)`` whose axis 0 is a batch of channels (see the
    module docstring; another 3-D plan raises ``ValueError``).
    ``stage_cost``: one array or a sequence of broadcast-shaped terms
    (tensors or arrays), kept as the kernel's factorized cost (at most
    ``MAX_TERMS``; excess leading terms are summed first, from +0).
    :meth:`stack` batches separate 2-D problems.
    """

    graph_safe = True

    def __init__(self, plan: InterpPlan, stage_cost):
        if plan.ndim == 3:
            _channel_axis(plan)
            lo = [plan.lo[k] for k in (1, 2)]
            fr = [plan.frac[k] for k in (1, 2)]
            n_c = plan.grid_shape[0]
        elif plan.ndim == 2:
            lo, fr = list(plan.lo), list(plan.frac)
            n_c = 1
        else:
            raise ValueError(
                "BandBackup2D supports 2-D state grids, and 3-D ones whose "
                f"axis 0 is a batch of channels; got {plan.ndim}-D")
        self.batched = plan.ndim == 3
        grid2 = tuple(plan.grid_shape[-2:])
        n_act = plan.query_shape[-1]
        self._build(lo, fr, _terms(stage_cost),
                    (n_c,) + grid2 + (n_act,), plan.device)

    @classmethod
    def stack(cls, plans, stage_costs) -> "BandBackup2D":
        """One backup over C separate 2-D problems of one grid shape and
        action count, each with its own plan and cost terms (the same
        number of terms each), as a batch: values ``(C, n1, n2)``. Each
        channel's sweep is the one its own :class:`BandBackup2D` makes,
        bitwise."""
        plans = list(plans)
        if any(p.ndim != 2 for p in plans) or \
                len({(tuple(p.grid_shape), p.query_shape[-1])
                     for p in plans}) != 1:
            raise ValueError("stack takes 2-D plans of one grid shape and "
                             "action count")
        costs = [_terms(c) for c in stage_costs]
        if len(costs) != len(plans) or len({len(c) for c in costs}) != 1:
            raise ValueError("give one cost of as many terms per plan")

        def stacked(parts):
            parts = [_as4(t)[0] for t in parts]
            shape = torch.broadcast_shapes(*(t.shape for t in parts))
            return torch.stack([t.to(plans[0].device).expand(shape)
                                for t in parts])

        self = cls.__new__(cls)
        self.batched = True
        grid2 = tuple(plans[0].grid_shape)
        lo = [stacked([p.lo[k] for p in plans]) for k in range(2)]
        fr = [stacked([p.frac[k] for p in plans]) for k in range(2)]
        terms = [stacked([c[i] for c in costs]) for i in range(len(costs[0]))]
        self._build(lo, fr, terms,
                    (len(plans),) + grid2 + (plans[0].query_shape[-1],),
                    plans[0].device)
        return self

    def _build(self, lo, fr, terms, shape, dev) -> None:
        n1, n2 = shape[1:3]
        for k in range(2):
            if lo[k].numel() and (int(lo[k].min()) < 0 or
                                  int(lo[k].max()) > (n1, n2)[k] - 2):
                raise ValueError(f"plan.lo[{k}] leaves [0, n-2]")
            lo[k], fr[k] = torch.broadcast_tensors(_as4(lo[k]), _as4(fr[k]))
            lo[k] = lo[k].to(device=dev, dtype=torch.int32).contiguous()
            fr[k] = fr[k].to(device=dev, dtype=torch.float32).contiguous()
        self.args = BandArgs(
            lo=tuple(lo), frac=tuple(fr),
            terms=tuple(_as4(t).to(dev).contiguous() for t in terms),
            shape=tuple(int(s) for s in shape))
        _check_args(self.args)
        self._taps = None

    @property
    def channel_taps(self) -> tuple:
        """The plain version's tap geometry (:func:`band_taps`), one per
        plan, analysed at its first use: the kernel does not need it."""
        if self._taps is None:
            self._taps = band_taps(self.args)
        return self._taps

    @property
    def taps(self) -> StencilTaps:
        """The tap geometry of a backup whose channels share one plan."""
        if not self.args.shared_plan:
            raise ValueError("each channel has its own plan: use "
                             "channel_taps")
        return self.channel_taps[0]

    def _batch(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.batched else t[None]

    def _run(self, fn, values: torch.Tensor) -> BackupResult:
        res = fn(self._batch(values).contiguous())
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
            lambda v: band_backup2d_plain(v, self.args, self.channel_taps),
            values)

    def prepare(self) -> None:
        """Build the kernel before a CUDA graph captures a launch."""
        if self.args.lo[0].is_cuda:
            from .. import _build

            _build.load()

    def sweep_into(self, values: torch.Tensor, out_v: torch.Tensor,
                   out_a: torch.Tensor) -> None:
        """One sweep of ``values`` into the caller's ``out_v`` / ``out_a``
        (int32), each in the values' shape: the kernel on a CUDA tensor (no
        allocation, so a CUDA graph may capture it), the plain version on a
        CPU tensor."""
        if values.is_cuda:
            band_backup2d_cuda(self._batch(values), self.args,
                               out_v=self._batch(out_v),
                               out_a=self._batch(out_a))
            return
        res = self(values)
        out_v.copy_(res.values)
        out_a.copy_(res.argmin)

    launcher = staticmethod(band_backup2d_cuda)
