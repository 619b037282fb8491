"""Fused 2-D Bellman backup: the CUDA kernel, its plain version, its wrapper.

Replaces the TPU kernel ``ocdp_tpu/ops/pallas_shear.py::PallasShearBackup``
(``_kernel_impl``, with its ``_kernel`` / ``_kernel_sep`` entry points) on
the Kirk main path. The kernel source, with the note on its arithmetic, tie
order, NaN rule and what bounds it, is ``csrc/fused_backup2d.cu``.

* :func:`fused_backup2d_cuda` launches the kernel on PyTorch's current
  stream; ``fused_backup2d_cuda.launches`` counts its launches.
* :func:`fused_backup2d_plain` is the same function in plain PyTorch on the
  same inputs, through :func:`~ocdp_tpu_torch.ops.interp.interp_apply` (the
  gather oracle's arithmetic). On a CUDA device the two agree bitwise.
* :class:`FusedBackup2D` binds a plan and a cost into the engines'
  ``values -> BackupResult`` callable. It runs the kernel on a CUDA tensor
  and the plain version on a CPU tensor; it never swaps one for the other.

Inputs are action-major, ``(A, S)`` with ``S = n0 * n1``: ``lo0``/``lo1``
int32, ``f0``/``f1`` float32, and either a full ``cost`` ``(A, S)`` or a
separable ``state_cost`` ``(S,)`` + ``action_cost`` ``(A,)``.

The affine-query mode (Kirk's main path) forms the next-state queries of
affine dynamics ``x' = A x + B u`` inside the kernel instead of streaming a
plan, in one launch a sweep:

* :func:`fused_backup2d_affine_cuda` launches it (``.launches`` and
  ``.channel_sweeps`` count), into new outputs or the caller's, with the
  argmin as uint8, int16 or int32;
* :func:`fused_backup2d_affine_plain` forms the queries with the torch ops
  of ``models/kirk.py::build`` and ``build_plan`` and calls
  :func:`fused_backup2d_plain`; on a CUDA device the two agree bitwise;
* :func:`plan_rows` is the host planner of the table rows each block
  stages; what a block stages at all (:data:`STAGE_ALL`,
  :data:`STAGE_CHUNKS` or :data:`TABLE_GLOBAL`) is chosen on the host from
  the configuration, before any launch, so every configuration runs;
* :class:`AffineBackup2D` is the engines' callable, graph-safe
  (``sweep_into``, ``prepare``, ``launcher``), whose ``sweep_into`` also
  writes an argmin straight into a narrow policy slot.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from .backup import BackupResult
from .interp import InterpPlan, axis_locate, interp_apply

__all__ = ["AffineArgs", "AffineBackup2D", "FusedBackup2D", "affine_plan",
           "fused_backup2d_affine_cuda",
           "fused_backup2d_affine_plain", "fused_backup2d_cuda",
           "fused_backup2d_plain", "plan_rows", "SMEM_LIMIT_BYTES",
           "STAGE_ALL", "STAGE_CHUNKS", "TABLE_GLOBAL"]

# the most dynamic shared memory one block may opt into on Hopper; the
# plan-streamed mode stages the whole value table there, the affine mode a
# block's planned rows
SMEM_LIMIT_BYTES = 232_448
_THREADS = 256                  # kThreads in the CUDA source
_MIN_ACTIONS_PER_SPLIT = 16


def fused_backup2d_plain(values, lo0, lo1, f0, f1, cost=None,
                         state_cost=None, action_cost=None) -> BackupResult:
    """The kernel's function in plain PyTorch, on the kernel's inputs."""
    plan = InterpPlan((lo0, lo1), (f0, f1), tuple(values.shape))
    total = interp_apply(values, plan)                        # (A, S)
    if cost is None:
        cost = state_cost.reshape(1, -1) + action_cost.reshape(-1, 1)
    best, arg = torch.min(total + cost, dim=0)
    return BackupResult(best.reshape(values.shape),
                        arg.to(torch.int32).reshape(values.shape))


def _check_cuda_inputs(values, lo0, lo1, f0, f1, cost, state_cost,
                       action_cost) -> None:
    if values.ndim != 2:
        raise ValueError(f"values must be 2-D, got shape {tuple(values.shape)}")
    n0, n1 = values.shape
    if n0 < 2 or n1 < 2:
        raise ValueError("each grid axis needs >= 2 points")
    if n0 * n1 * 4 > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"a {n0}x{n1} value table needs {n0 * n1 * 4} B of shared memory; "
            f"the kernel stages it whole and a block holds {SMEM_LIMIT_BYTES} B")
    n_actions = lo0.shape[0] if lo0.ndim == 2 else -1
    want = {"values": ((n0, n1), torch.float32, values),
            "lo0": ((n_actions, n0 * n1), torch.int32, lo0),
            "lo1": ((n_actions, n0 * n1), torch.int32, lo1),
            "f0": ((n_actions, n0 * n1), torch.float32, f0),
            "f1": ((n_actions, n0 * n1), torch.float32, f1)}
    if cost is not None:
        want["cost"] = ((n_actions, n0 * n1), torch.float32, cost)
    elif state_cost is not None and action_cost is not None:
        want["state_cost"] = ((n0 * n1,), torch.float32, state_cost)
        want["action_cost"] = ((n_actions,), torch.float32, action_cost)
    else:
        raise ValueError("give either cost or state_cost and action_cost")
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


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _actions_per_split(device, n_cells: int, n_actions: int) -> int:
    """Split the action axis so that about four blocks per SM are in flight
    (full Kirk has only 10^4 cells: 40 blocks of 256 threads)."""
    sms = _sm_count(device)
    x_blocks = math.ceil(n_cells / _THREADS)
    n_splits = max(1, math.ceil(4 * sms / x_blocks))
    per = max(_MIN_ACTIONS_PER_SPLIT, math.ceil(n_actions / n_splits))
    return min(per, n_actions)


def fused_backup2d_cuda(values, lo0, lo1, f0, f1, cost=None,
                        state_cost=None, action_cost=None) -> BackupResult:
    """Launch the CUDA kernel for one sweep. Raises on inputs it does not take
    and on a launch the device refuses. ``lo0``/``lo1`` must lie in
    ``[0, n-2]`` (the kernel reads the table at ``lo`` and ``lo + 1``);
    :class:`FusedBackup2D` checks that once when it is built, not per call.
    """
    from .. import _build

    _check_cuda_inputs(values, lo0, lo1, f0, f1, cost, state_cost,
                       action_cost)
    lib = _build.load()
    n0, n1 = values.shape
    n_actions, n_cells = lo0.shape
    per = _actions_per_split(values.device, n_cells, n_actions)
    n_splits = math.ceil(n_actions / per)
    out_v = torch.empty((n0, n1), dtype=torch.float32, device=values.device)
    out_a = torch.empty((n0, n1), dtype=torch.int32, device=values.device)
    if n_splits > 1:
        part_v = torch.empty((n_splits, n_cells), dtype=torch.float32,
                             device=values.device)
        part_a = torch.empty((n_splits, n_cells), dtype=torch.int32,
                             device=values.device)
    else:
        part_v, part_a = out_v, out_a

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.fused_backup2d_f32(
        ptr(values), ptr(lo0), ptr(lo1), ptr(f0), ptr(f1), ptr(cost),
        ptr(state_cost), ptr(action_cost), ptr(part_v), ptr(part_a),
        ptr(out_v), ptr(out_a), n0, n1, n_actions, per, stream)
    if err != 0:
        msg = lib.fused_backup2d_error_string(err).decode()
        raise RuntimeError(f"fused_backup2d launch failed: CUDA error {err} "
                           f"({msg})")
    fused_backup2d_cuda.launches += 1
    return BackupResult(out_v, out_a)


fused_backup2d_cuda.launches = 0

# the affine mode's launch shape: a block owns CELLS_PER_BLOCK consecutive
# cells (row-major) and SPLITS action ranges of each, a thread one cell and
# one range (kAffineMaxThreads in the CUDA source bounds their product)
CELLS_PER_BLOCK = 16
SPLITS = 32
_AFFINE_MAX_THREADS = 512
# argmin dtypes the affine kernel writes, and their widths
_ARGMIN_BYTES = {torch.uint8: 1, torch.int16: 2, torch.int32: 4}
# what an affine block keeps in shared memory (AffineStage in the CUDA
# source), the first of these that fits: the planned table rows, the axes
# and every action's (B_0 u, B_1 u, cost) record; the same rows and axes
# with the records staged a chunk of each split's actions at a time; the
# records in chunks, the table and the axes read from global memory
STAGE_ALL, STAGE_CHUNKS, TABLE_GLOBAL = 0, 1, 2
CHUNK_ACTIONS = 32              # actions a split stages at a time (chunked)


def _affine_query(x0, x1, u, a_row, b):
    """One next-state coordinate, ``a_row[0] * x0 + a_row[1] * x1 + b * u``
    with Python-float coefficients: the torch ops, and so the rounding, of
    ``models/kirk.py::build`` (the kernel pins each step); on numpy float32
    arrays the same float32 steps."""
    return a_row[0] * x0 + a_row[1] * x1 + b * u


class _AffineParams(ctypes.Structure):
    """``AffineParams`` of the CUDA source, field for field."""
    _fields_ = ([(k, ctypes.c_void_p) for k in (
        "g0", "g1", "u", "state_cost", "action_cost", "row0", "n_rows")]
        + [(k, ctypes.c_int) for k in (
            "n0", "n1", "n_actions", "cells_per_block", "n_splits",
            "actions_per_split", "max_rows", "n_blocks", "stage", "chunk")]
        + [(k, ctypes.c_float) for k in (
            "a00", "a01", "a10", "a11", "b0", "b1")])


@dataclasses.dataclass(eq=False)
class AffineArgs:
    """What the affine kernel reads, built and checked once
    (:class:`AffineBackup2D`). ``axes``/``u``: the host float32 axes
    and controls; ``A``/``B``: Python floats; the tensors live on the
    backup's device: the axes, controls and the separable cost, and the
    row plan (:func:`plan_rows`). ``stage``: what a block keeps in shared
    memory (:data:`STAGE_ALL`, :data:`STAGE_CHUNKS`, :data:`TABLE_GLOBAL`),
    ``chunk`` the actions of a split it stages at a time when chunked."""

    axes: tuple
    u: np.ndarray
    A: tuple
    B: tuple
    g0: torch.Tensor
    g1: torch.Tensor
    u_t: torch.Tensor
    state_cost: torch.Tensor        # (n0 * n1,)
    action_cost: torch.Tensor       # (n_actions,)
    row0: torch.Tensor              # (n_blocks,) int32
    n_rows: torch.Tensor            # (n_blocks,) int32
    cells_per_block: int
    n_splits: int
    actions_per_split: int
    max_rows: int
    stage: int = STAGE_ALL
    chunk: int = 0
    _launch: tuple | None = None    # (lib, params address, params), once

    @property
    def grid_shape(self) -> tuple:
        return (len(self.axes[0]), len(self.axes[1]))

    @property
    def n_actions(self) -> int:
        return len(self.u)

    @property
    def device(self) -> torch.device:
        return self.state_cost.device

    @property
    def threads(self) -> int:
        return self.cells_per_block * self.n_splits

    @property
    def smem_bytes(self) -> int:
        """``affine_smem_bytes`` of the CUDA source."""
        return _smem_bytes(self.grid_shape, self.n_actions, self.max_rows,
                           self.cells_per_block, self.n_splits, self.stage,
                           self.chunk)


def _smem_bytes(grid_shape, n_actions, max_rows, cells_per_block, n_splits,
                stage, chunk) -> int:
    """An affine block's dynamic shared memory: the staged table rows and
    the axes (unless :data:`TABLE_GLOBAL`), the action records (16 B each:
    every action's, or ``chunk`` of each split's), the split minima."""
    n0, n1 = grid_shape
    rows = 0 if stage == TABLE_GLOBAL else -(-max_rows * n1 // 4) * 4
    axes = 0 if stage == TABLE_GLOBAL else n0 + n1
    records = n_actions if stage == STAGE_ALL else n_splits * chunk
    return 4 * (rows + axes) + 16 * records + 8 * cells_per_block * n_splits


def _stage(grid_shape, n_actions, max_rows, cells_per_block, n_splits,
           per) -> tuple:
    """``(stage, chunk)``: the first stage whose shared memory fits a
    block, with ``chunk`` (chunked) the fewer of :data:`CHUNK_ACTIONS` and
    a split's actions, cut further where :data:`TABLE_GLOBAL`'s records
    alone would not fit; that stage always fits."""
    chunk = min(CHUNK_ACTIONS, per)
    shape = (grid_shape, n_actions, max_rows, cells_per_block, n_splits)
    for stage in (STAGE_ALL, STAGE_CHUNKS):
        if _smem_bytes(*shape, stage, chunk) <= SMEM_LIMIT_BYTES:
            return stage, chunk if stage == STAGE_CHUNKS else 0
    minima = 8 * cells_per_block * n_splits
    chunk = min(chunk, (SMEM_LIMIT_BYTES - minima) // (16 * n_splits))
    return TABLE_GLOBAL, chunk


def plan_rows(axes, u, A, B, cells_per_block: int):
    """The table rows each block of the affine kernel stages: ``(row0,
    n_rows)``, int64 ``(n_blocks,)``, block ``b`` owning cells
    ``[b * cells_per_block, (b + 1) * cells_per_block)`` of the row-major
    grid. A cell's axis-0 query is monotone in the control (each rounded
    step is), so its cell indices over all actions run between those at
    ``min(u)`` and ``max(u)``: the planner forms those two queries per
    cell in float32, step for step as the plain version does, and locates
    them as ``interp.axis_locate`` does, and a block stages rows ``row0 ..
    row0 + n_rows - 1``, the least and the greatest ``lo`` of its cells
    and the row after the greatest. It runs in numpy, on one host thread:
    torch's CPU ``searchsorted`` spreads even these few queries over the
    intra-op threads, whose wake-ups on a busy host made a solve's set-up
    take up to tens of milliseconds."""
    g0 = np.asarray(axes[0], np.float32)
    g1 = np.asarray(axes[1], np.float32)
    ut = np.asarray(u, np.float32)
    ends = np.stack([ut.min(), ut.max()])
    q = _affine_query(g0[:, None, None], g1[None, :, None],
                      ends[None, None, :], A[0], B[0])
    lo = np.searchsorted(g0, q.reshape(-1), side="right") - 1
    lo = np.clip(lo, 0, g0.size - 2).astype(np.int64).reshape(-1, 2)
    first = np.minimum(lo[:, 0], lo[:, 1])
    last = np.maximum(lo[:, 0], lo[:, 1])
    n_blocks = math.ceil(first.size / cells_per_block)
    pad = n_blocks * cells_per_block - first.size
    # the last block's missing cells repeat its last cell
    first = np.concatenate([first, np.repeat(first[-1:], pad)])
    last = np.concatenate([last, np.repeat(last[-1:], pad)])
    row0 = first.reshape(n_blocks, cells_per_block).min(1)
    n_rows = last.reshape(n_blocks, cells_per_block).max(1) + 2 - row0
    return torch.from_numpy(row0), torch.from_numpy(n_rows)


def _axis(name, a) -> np.ndarray:
    a = np.asarray(a, dtype=np.float32)
    if a.ndim != 1 or a.size < 2:
        raise ValueError(f"{name} must be 1-D with >= 2 points")
    if not np.isfinite(a).all() or not (np.diff(a) > 0).all():
        raise ValueError(f"{name} must be finite and strictly ascending")
    return a


def _affine_args(axes, u, A, B, state_cost, action_cost, cells_per_block,
                 splits) -> AffineArgs:
    if len(axes) != 2:
        raise ValueError("the affine mode takes 2-D state grids only")
    axes = (_axis("axes[0]", axes[0]), _axis("axes[1]", axes[1]))
    u = np.asarray(u, dtype=np.float32)
    if u.ndim != 1 or u.size < 1 or not np.isfinite(u).all():
        raise ValueError("u must be 1-D, non-empty and finite")
    A = tuple(tuple(float(x) for x in row) for row in A)
    B = tuple(float(x) for x in B)
    if len(A) != 2 or any(len(r) != 2 for r in A) or len(B) != 2:
        raise ValueError("A must be 2 x 2 and B of length 2")
    with np.errstate(over="ignore"):
        if not np.isfinite(np.float32([*A[0], *A[1], *B])).all():
            raise ValueError("A and B must be finite in f32")
    # the kernel's walk assumes no query is NaN: bound |q| well inside f32
    top = [float(np.abs(x).max()) for x in (*axes, u)]
    reach = [abs(a[0]) * top[0] + abs(a[1]) * top[1] + abs(b) * top[2]
             for a, b in zip(A, B)]
    if max(reach) >= 1e37:
        raise ValueError(f"queries up to {max(reach):.3g} could overflow f32")
    n0, n1 = len(axes[0]), len(axes[1])
    if n0 * n1 >= 2**31 or u.size >= 2**31:
        raise ValueError("the affine kernel indexes cells and actions in "
                         "int32")
    if not (isinstance(state_cost, torch.Tensor)
            and isinstance(action_cost, torch.Tensor)):
        raise ValueError("state_cost and action_cost must be tensors (on "
                         "the backup's device)")
    dev = state_cost.device
    if action_cost.device != dev or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"state_cost on {dev}, action_cost on "
                         f"{action_cost.device}: both on one CPU or CUDA "
                         "device")
    if tuple(state_cost.shape) not in ((n0, n1), (n0 * n1,)) \
            or tuple(action_cost.shape) != (u.size,):
        raise ValueError(f"cost shapes must be ({n0}, {n1}) and "
                         f"({u.size},), got {tuple(state_cost.shape)} and "
                         f"{tuple(action_cost.shape)}")
    if cells_per_block < 1 or splits < 1:
        raise ValueError("cells_per_block and splits must be >= 1")
    per = math.ceil(u.size / min(splits, u.size))
    n_splits = math.ceil(u.size / per)
    if cells_per_block * n_splits > _AFFINE_MAX_THREADS:
        raise ValueError(f"{cells_per_block} cells x {n_splits} splits "
                         f"exceed {_AFFINE_MAX_THREADS} threads a block")
    row0, n_rows = plan_rows(axes, u, A, B, cells_per_block)

    def f32(t):
        return torch.as_tensor(t, dtype=torch.float32, device=dev) \
            .contiguous()

    def i32(t):
        return t.to(device=dev, dtype=torch.int32).contiguous()

    max_rows = int(n_rows.max())
    stage, chunk = _stage((n0, n1), u.size, max_rows, cells_per_block,
                          n_splits, per)
    return AffineArgs(
        axes=axes, u=u, A=A, B=B, g0=f32(axes[0]), g1=f32(axes[1]),
        u_t=f32(u), state_cost=f32(state_cost).reshape(n0 * n1),
        action_cost=f32(action_cost), row0=i32(row0), n_rows=i32(n_rows),
        cells_per_block=int(cells_per_block), n_splits=n_splits,
        actions_per_split=per, max_rows=max_rows, stage=stage, chunk=chunk)


def affine_plan(args: AffineArgs, device) -> tuple:
    """The plan the affine kernel forms, action-major on ``device``: ``(lo0,
    lo1, f0, f1)``, each ``(A, S)``, the queries formed with the torch ops
    of ``models/kirk.py::build`` and located with ``interp.axis_locate``, as
    ``build_plan`` locates them (what the plan-streamed mode would stream)."""
    g0 = torch.as_tensor(args.axes[0], device=device)[None, :, None]
    g1 = torch.as_tensor(args.axes[1], device=device)[None, None, :]
    u = torch.as_tensor(args.u, device=device)[:, None, None]
    lo, frac = zip(*(axis_locate(args.axes[k],
                                 _affine_query(g0, g1, u, args.A[k],
                                               args.B[k]))
                     for k in range(2)))
    return tuple(t.reshape(args.n_actions, -1) for t in (*lo, *frac))


def fused_backup2d_affine_plain(values, args: AffineArgs) -> BackupResult:
    """The affine kernel's function in plain PyTorch on ``values``'s device:
    :func:`affine_plan`, then :func:`fused_backup2d_plain` with the
    separable cost."""
    dev = values.device
    return fused_backup2d_plain(values, *affine_plan(args, dev),
                                state_cost=args.state_cost.to(dev),
                                action_cost=args.action_cost.to(dev))


def _affine_launch(args: AffineArgs) -> tuple:
    """``(lib, params address)``: the library loaded, the kernel's parameter
    block built and the launch shape configured, once per ``args`` (it sets
    function attributes, so never during a CUDA graph capture)."""
    if args._launch is None:
        from .. import _build

        lib = _build.load()
        if lib.fused_backup2d_affine_params_size() != \
                ctypes.sizeof(_AffineParams):
            raise RuntimeError("AffineParams differs between the CUDA "
                               "source and ops/fused_backup2d.py")
        n0, n1 = args.grid_shape
        params = _AffineParams(
            args.g0.data_ptr(), args.g1.data_ptr(), args.u_t.data_ptr(),
            args.state_cost.data_ptr(), args.action_cost.data_ptr(),
            args.row0.data_ptr(), args.n_rows.data_ptr(),
            n0, n1, args.n_actions, args.cells_per_block, args.n_splits,
            args.actions_per_split, args.max_rows, args.row0.numel(),
            args.stage, args.chunk, *args.A[0], *args.A[1], *args.B)
        addr = ctypes.addressof(params)
        _raise_on(lib, lib.fused_backup2d_affine_configure(addr),
                  "configure")
        args._launch = (lib, addr, params)
    return args._launch[:2]


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.fused_backup2d_error_string(err).decode()
        raise RuntimeError(f"fused_backup2d affine {what} failed: CUDA error "
                           f"{err} ({msg})")


def _check_table(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.shape != shape or t.dtype != dtype:
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, the backup on {device}: "
                         "both must be on one CUDA device")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_backup2d_affine_cuda(values: torch.Tensor, args: AffineArgs,
                               out_v: torch.Tensor | None = None,
                               out_a: torch.Tensor | None = None
                               ) -> BackupResult:
    """Launch the affine kernel for one sweep of ``values`` (float32, the
    grid's shape), into new outputs or the caller's ``out_v`` (float32, not
    ``values``) and ``out_a`` (uint8, int16 or int32), each in the grid's
    shape. ``args`` were checked when they were built; per call only the
    three tables are. Raises on what it does not take and on a launch the
    device refuses; with its outputs given it allocates nothing and sets
    no function attribute, so a CUDA graph may capture it (after
    :meth:`AffineBackup2D.prepare`)."""
    dev = args.device
    if not values.is_cuda or dev.type != "cuda":
        raise ValueError(f"values on {values.device}, the backup on {dev}: "
                         "the kernel needs both on one CUDA device")
    shape = torch.Size(args.grid_shape)
    _check_table("values", values, shape, torch.float32, dev)
    if out_v is None:
        out_v = torch.empty(shape, dtype=torch.float32, device=dev)
    if out_a is None:
        out_a = torch.empty(shape, dtype=torch.int32, device=dev)
    _check_table("out_v", out_v, shape, torch.float32, dev)
    width = _ARGMIN_BYTES.get(out_a.dtype)
    if width is None:
        raise ValueError(f"out_a: the kernel writes {list(_ARGMIN_BYTES)}, "
                         f"got {out_a.dtype}")
    _check_table("out_a", out_a, shape, out_a.dtype, dev)
    if torch.iinfo(out_a.dtype).max < args.n_actions - 1:
        raise ValueError(f"out_a: {out_a.dtype} cannot hold "
                         f"{args.n_actions} actions")
    if out_v.data_ptr() == values.data_ptr():
        raise ValueError("out_v must not be the input table")
    lib, params = _affine_launch(args)
    err = lib.fused_backup2d_affine_f32(
        params, values.data_ptr(), out_v.data_ptr(), out_a.data_ptr(), width,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "launch")
    fused_backup2d_affine_cuda.launches += 1
    fused_backup2d_affine_cuda.channel_sweeps += 1
    return BackupResult(out_v, out_a)


fused_backup2d_affine_cuda.launches = 0
fused_backup2d_affine_cuda.channel_sweeps = 0


class FusedBackup2D:
    """Callable ``values -> BackupResult`` over one 2-D plan and stage cost.

    ``plan`` queries are shaped ``(n0, n1, n_actions)`` (action last, as
    :func:`~ocdp_tpu_torch.ops.backup.bellman_backup` takes them); they are
    copied once into the kernel's action-major layout. ``cost_terms``: an
    optional ``(state_cost (n0, n1), action_cost (n_actions,))`` split of
    ``stage_cost``; the kernel then re-adds the two parts instead of reading
    the full cost stack, and the split is checked at build to recompose
    ``stage_cost`` bitwise.
    """

    def __init__(self, plan: InterpPlan, stage_cost: torch.Tensor, *,
                 cost_terms=None):
        if plan.ndim != 2:
            raise ValueError("fused_backup2d supports 2-D state grids only")
        n0, n1 = plan.grid_shape
        qs = plan.query_shape
        if len(qs) != 3 or qs[:2] != (n0, n1):
            raise ValueError(f"plan queries must be shaped (n0, n1, actions) "
                             f"= ({n0}, {n1}, A), got {qs}")
        n_actions, n_cells = qs[2], n0 * n1

        def action_major(t):
            return t.expand(qs).permute(2, 0, 1).reshape(n_actions, n_cells) \
                .contiguous()

        for k, lo in enumerate(plan.lo):
            if lo.numel() and (int(lo.min()) < 0
                               or int(lo.max()) > plan.grid_shape[k] - 2):
                raise ValueError(f"plan.lo[{k}] leaves [0, n-2]")
        self.lo0, self.lo1 = (action_major(t).to(torch.int32) for t in plan.lo)
        self.f0, self.f1 = (action_major(t).to(torch.float32)
                            for t in plan.frac)
        self.cost = self.state_cost = self.action_cost = None
        if cost_terms is None:
            self.cost = action_major(stage_cost.to(torch.float32))
            return
        s_c = cost_terms[0].to(torch.float32)
        a_c = cost_terms[1].to(torch.float32)
        if tuple(s_c.shape) != (n0, n1) or tuple(a_c.shape) != (n_actions,):
            raise ValueError("cost_terms shapes must be (n0, n1), (n_actions,)")
        recomposed = s_c[:, :, None] + a_c[None, None, :]
        if not torch.equal(recomposed, stage_cost.expand(qs)):
            raise ValueError("cost_terms do not recompose stage_cost bitwise")
        self.state_cost = s_c.reshape(n_cells).contiguous()
        self.action_cost = a_c.contiguous()

    def __call__(self, values: torch.Tensor) -> BackupResult:
        args = (values, self.lo0, self.lo1, self.f0, self.f1, self.cost,
                self.state_cost, self.action_cost)
        if values.is_cuda:
            return fused_backup2d_cuda(*args)
        if values.device.type == "cpu":
            return fused_backup2d_plain(*args)
        raise ValueError(f"no fused_backup2d for device {values.device}")


class AffineBackup2D:
    """Callable ``values -> BackupResult``: B.1's affine-query mode for
    dynamics ``x' = A x + B u`` on the grid ``axes`` (two strictly ascending
    1-D axes) with controls ``u`` (1-D) and the separable cost
    ``state_cost`` ``(n0, n1)`` + ``action_cost`` ``(n_actions,)``, on the
    costs' device: the kernel on a CUDA device, the plain version on the
    CPU; it never swaps one for the other. ``A`` (2 x 2) and ``B`` (2,) are
    taken as Python floats, as ``models/kirk.py::build`` uses them. The
    launch shape is ``CELLS_PER_BLOCK`` x ``SPLITS``; what a block stages
    (``args.stage``) follows from the configuration, and none is refused
    for want of shared memory. Raises on inputs it cannot take.

    Graph-safe: :meth:`sweep_into` writes into the caller's buffers (an
    argmin of any ``argmin_dtypes`` dtype, e.g. a slot of a narrow policy
    stack) and allocates nothing, after :meth:`prepare`.
    """

    graph_safe = True
    argmin_dtypes = tuple(_ARGMIN_BYTES)
    launcher = staticmethod(fused_backup2d_affine_cuda)

    def __init__(self, axes, u, A, B, state_cost: torch.Tensor,
                 action_cost: torch.Tensor):
        self.args = _affine_args(axes, u, A, B, state_cost, action_cost,
                                 CELLS_PER_BLOCK, SPLITS)

    def __call__(self, values: torch.Tensor) -> BackupResult:
        if values.is_cuda:
            return fused_backup2d_affine_cuda(values, self.args)
        if values.device.type == "cpu":
            return fused_backup2d_affine_plain(values, self.args)
        raise ValueError(f"no fused_backup2d for device {values.device}")

    def prepare(self) -> None:
        """Build and configure the kernel before a CUDA graph captures a
        launch."""
        if self.args.device.type == "cuda":
            _affine_launch(self.args)

    def sweep_into(self, values: torch.Tensor, out_v: torch.Tensor,
                   out_a: torch.Tensor) -> None:
        """One sweep of ``values`` into the caller's ``out_v`` and ``out_a``,
        each in the grid's shape: the kernel on a CUDA tensor (no
        allocation, so a CUDA graph may capture it), the plain version on a
        CPU tensor."""
        if values.is_cuda:
            fused_backup2d_affine_cuda(values, self.args, out_v, out_a)
            return
        res = self(values)
        out_v.copy_(res.values)
        out_a.copy_(res.argmin)
