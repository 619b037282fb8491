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
"""

from __future__ import annotations

import math

import torch

from .backup import BackupResult
from .interp import InterpPlan, interp_apply

__all__ = ["FusedBackup2D", "fused_backup2d_cuda", "fused_backup2d_plain",
           "SMEM_LIMIT_BYTES"]

# the most dynamic shared memory one block may opt into on Hopper; the whole
# value table is staged there
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


def _actions_per_split(device, n_cells: int, n_actions: int) -> int:
    """Split the action axis so that about four blocks per SM are in flight
    (full Kirk has only 10^4 cells: 40 blocks of 256 threads)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
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
