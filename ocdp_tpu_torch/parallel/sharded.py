"""Replicated-table engines: state-block and action-axis sharding
(counterpart of ``ocdp_tpu/parallel/sharded.py``).

* **State sharding.** The query tensors ``f(x, u)`` and the stage cost are
  split in blocks along one state axis; the value table, which every block
  reads (dynamics can carry a next state anywhere), stays replicated. Each
  sweep every rank backs up its own block and the new table is put together
  with one ``all_gather`` over the state axis.
* **Action sharding** (for large action sets): each rank reduces its
  contiguous action block, and the ranks of a state block combine with the
  first minimum in ascending rank order, i.e. ascending action offset
  (MATLAB ``min``'s first-minimum tie order, test/Dynamic_Solver.m:209).

Axis sizes that do not divide the mesh are padded, as in the JAX package:
the state axis by repeating its edge block (those rows are computed and
sliced off after the gather), the action axis with ``+inf`` stage cost so a
padded action never wins the argmin.

The backup is the gather oracle (``ops/backup.py``), as the JAX engine uses
the generic XLA backup; its arithmetic per query point is the one-device
solve's, so results are bitwise equal.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..engine import SolveResult, convergence_stop, policy_dtype_for
from ..ops.interp import InterpPlan, interp_apply
from .mesh import Mesh, first_min

__all__ = [
    "ShardedPlan",
    "shard_backup_inputs",
    "sharded_bellman_sweeps",
    "value_iteration_finite_sharded",
    "value_iteration_converged_sharded",
    "converged_loop",
]


def _pad_axis(t: torch.Tensor, axis: int, target: int,
              mode: str) -> torch.Tensor:
    """Pad ``t`` along ``axis`` up to ``target`` (edge-repeat or +inf)."""
    n = t.shape[axis]
    if n == target:
        return t
    idx = [slice(None)] * t.ndim
    idx[axis] = slice(n - 1, n)
    reps = [1] * t.ndim
    reps[axis] = target - n
    fill = t[tuple(idx)].repeat(reps)
    if mode == "inf":
        fill = torch.full_like(fill, float("inf"))
    return torch.cat([t, fill], dim=axis)


def _take(t: torch.Tensor, axis: int, i: int, n: int) -> torch.Tensor:
    """Block ``i`` of ``n`` along ``axis`` (a size-1 axis is shared)."""
    if t.shape[axis] == 1:
        return t
    b = t.shape[axis] // n
    return t.narrow(axis, i * b, b)


class ShardedPlan:
    """The padded plan and cost terms and how they block over the mesh.

    ``plan``/``cost``: padded (state axis ``shard_axis`` to a multiple of the
    state mesh axis by edge repeat; the action axis to a multiple of the
    action mesh axis, the cost with +inf); ``state_size``/``action_size``
    the unpadded sizes. :meth:`local` cuts one rank's block.
    """

    def __init__(self, plan, cost, state_size, action_size, shard_axis,
                 state_axis_name, action_axis_name, n_state, n_action):
        self.plan = plan
        self.cost = cost
        self.state_size = state_size
        self.action_size = action_size
        self.shard_axis = shard_axis
        self.state_axis_name = state_axis_name
        self.action_axis_name = action_axis_name
        self.n_state = n_state
        self.n_action = n_action

    @property
    def action_block(self) -> int:
        return self.plan.query_shape[-1] // self.n_action

    def local(self, s: int, a: int):
        """``(plan, cost terms)`` of state block ``s``, action block ``a``."""
        sa = self.shard_axis

        def cut(t):
            t = _take(t, sa, s, self.n_state)
            return _take(t, t.ndim - 1, a, self.n_action)

        plan = InterpPlan(tuple(cut(x) for x in self.plan.lo),
                          tuple(cut(x) for x in self.plan.frac),
                          self.plan.grid_shape)
        return plan, [cut(t) for t in self.cost]


def shard_backup_inputs(
    plan: InterpPlan,
    stage_cost,
    mesh: Mesh,
    *,
    shard_axis: int = 0,
    state_axis_name: str = "s",
    action_axis_name: Optional[str] = None,
) -> ShardedPlan:
    """Pad the backup inputs for blocking over ``mesh``: ``shard_axis``
    picks the state axis of the query layout blocked over
    ``state_axis_name``; the trailing action axis is blocked over
    ``action_axis_name`` when given. ``stage_cost``: one tensor or a
    sequence of broadcast-shaped terms (summed in order, as
    :func:`~ocdp_tpu_torch.ops.backup.bellman_backup` sums them); the last
    term carries the +inf of the padded actions."""
    q_shape = plan.query_shape
    ndim = len(q_shape)
    action_axis = ndim - 1
    if shard_axis >= action_axis:
        raise ValueError("shard_axis must be a state axis (not the action "
                         "axis)")
    n_s = mesh.shape[state_axis_name]
    n_a = mesh.shape[action_axis_name] if action_axis_name else 1
    s_pad = -(-q_shape[shard_axis] // n_s) * n_s
    a_pad = -(-q_shape[action_axis] // n_a) * n_a

    def full_rank(t):
        t = torch.as_tensor(t, device=plan.device)
        return t.reshape((1,) * (ndim - t.ndim) + tuple(t.shape))

    def prep(t, inf=False):
        t = full_rank(t)
        if t.shape[shard_axis] > 1:
            t = _pad_axis(t, shard_axis, s_pad, "edge")
        if t.shape[action_axis] > 1:
            t = _pad_axis(t, action_axis, a_pad, "inf" if inf else "edge")
        return t

    terms = (list(stage_cost) if isinstance(stage_cost, (tuple, list))
             else [stage_cost])
    terms = [full_rank(t) for t in terms]
    if a_pad != q_shape[action_axis] and terms[-1].shape[action_axis] == 1:
        # materialize the action axis of the last term so +inf can be
        # written on the padded actions
        shape = list(terms[-1].shape)
        shape[action_axis] = q_shape[action_axis]
        terms[-1] = terms[-1].expand(shape)
    cost = [prep(t, inf=i == len(terms) - 1) for i, t in enumerate(terms)]
    padded = InterpPlan(tuple(prep(x) for x in plan.lo),
                        tuple(prep(x) for x in plan.frac), plan.grid_shape)
    return ShardedPlan(padded, cost, q_shape[shard_axis],
                       q_shape[action_axis], shard_axis, state_axis_name,
                       action_axis_name, n_s, n_a)


def _local_backup(v, plan, cost, sp: ShardedPlan, a_idx: int):
    """One rank's backup over its (state block x action block) queries: the
    block's first minimum and its GLOBAL flat action index."""
    total = interp_apply(v, plan)
    for t in cost:
        total = total + t
    total = total.expand(torch.broadcast_shapes(total.shape,
                                                plan.query_shape))
    vals, args = torch.min(total, dim=-1)
    return vals, args.to(torch.int32) + a_idx * sp.action_block


class _Sweeper:
    """The local ranks of a replicated-table solve: each one's block of the
    padded plan and cost, the whole table ``v`` and each local rank's last
    block argmin ``args``; a sweep is the blocks' backups, the first-minimum
    combine over the action axis and the ``all_gather`` over the state
    axis."""

    def __init__(self, sp: ShardedPlan, mesh: Mesh, init_values):
        if not mesh.is_member:
            raise ValueError("this process holds no rank of the mesh")
        self.sp, self.mesh = sp, mesh
        s_ax = mesh.axis(sp.state_axis_name)
        a_ax = mesh.axis(sp.action_axis_name) if sp.action_axis_name \
            else None
        self.coords = [(c[s_ax], c[a_ax] if a_ax is not None else 0)
                       for c in mesh.local_coords]
        self.local = [sp.local(s, a) for s, a in self.coords]
        shape = sp.plan.grid_shape
        self.v = (torch.zeros(shape, dtype=torch.float32, device=mesh.device)
                  if init_values is None else
                  torch.as_tensor(init_values, dtype=torch.float32,
                                  device=mesh.device).reshape(shape))
        self.args = None

    def sweep(self) -> None:
        sp, mesh = self.sp, self.mesh
        vals, args = [], []
        for (_, a), (plan, cost) in zip(self.coords, self.local):
            vb, ab = _local_backup(self.v, plan, cost, sp, a)
            vals.append(vb)
            args.append(ab)
        if sp.action_axis_name:
            gv = mesh.all_gather(vals, sp.action_axis_name)
            ga = mesh.all_gather(args, sp.action_axis_name)
            comb = [first_min(x, y, sp.plan.query_shape[-1])
                    for x, y in zip(gv, ga)]
            vals, args = [c[0] for c in comb], [c[1] for c in comb]
        self.v, self.args = self.gather(vals), args

    def gather(self, blocks: list) -> torch.Tensor:
        """The unpadded whole table along the shard axis."""
        sp = self.sp
        line = self.mesh.all_gather(blocks, sp.state_axis_name)[0]
        return torch.cat(line, dim=sp.shard_axis).narrow(
            sp.shard_axis, 0, sp.state_size)

    def argmin(self) -> torch.Tensor:
        if self.args is None:
            return torch.zeros(self.sp.plan.grid_shape, dtype=torch.int32,
                               device=self.mesh.device)
        return self.gather(self.args)

    def checksums(self) -> tuple:
        """``(Σ V, Σ argmin)``: the whole table's sum, identical on every
        rank, and each block's real rows (not padded state rows) summed,
        then the blocks in rank order."""
        sp, us = self.sp, []
        for (s, _), a in zip(self.coords, self.args):
            b = a.shape[sp.shard_axis]
            rows = s * b + torch.arange(b, device=a.device)
            shape = [1] * a.ndim
            shape[sp.shard_axis] = b
            real = (rows < sp.state_size).reshape(shape)
            us.append(torch.where(real, a, 0).sum(dtype=torch.float32))
        return (self.v.sum(dtype=torch.float32).cpu(),
                self.mesh.sum(us, sp.state_axis_name)[0].cpu())


def converged_loop(sweep, checksums, mesh: Mesh, max_sweeps: int,
                   check_every: int, tol: float, tol_mode: str, on_check):
    """The reference's periodic-checksum stop (pos-att/Solver_pos_att.m:
    268-286) as :func:`~ocdp_tpu_torch.engine.value_iteration_converged`
    runs it, for the multi-rank engines: ``sweep()`` runs one sweep of every
    local rank, ``checksums()`` returns ``(Σ V, Σ argmin)`` as float32
    scalars equal on every rank (so every rank stops at the same sweep).
    ``on_check(k_s, errorF, errorU)`` fires once per check, on the process
    of rank 0. Returns ``(sweeps run, converged, check log)``, the log's
    rows ``[k_s, errorF, errorU]`` on the mesh's device."""
    convergence_stop(0.0, 0.0, tol, tol_mode)     # validate tol_mode
    checks = torch.zeros((max(max_sweeps // check_every, 1), 3),
                         dtype=torch.float32)
    fsum_prev = usum_prev = torch.zeros((), dtype=torch.float32)
    c_idx, k_s, converged = 0, max_sweeps, False
    while k_s >= 1 and not converged:
        sweep()
        if k_s % check_every == 0:
            fsum, usum = checksums()
            err_f, err_u = fsum - fsum_prev, usum - usum_prev
            converged = convergence_stop(float(err_f), float(fsum), tol,
                                         tol_mode)
            checks[c_idx] = torch.stack(
                [torch.tensor(float(k_s)), err_f, err_u])
            if on_check is not None and mesh.is_leader:
                on_check(k_s, float(err_f), float(err_u))
            c_idx += 1
            fsum_prev, usum_prev = fsum, usum
        k_s -= 1
    return max_sweeps - k_s, converged, checks.to(mesh.device)


def sharded_bellman_sweeps(
    sp: ShardedPlan,
    mesh: Mesh,
    num_sweeps: int,
    *,
    init_values: Optional[torch.Tensor] = None,
    store_policies: bool = False,
):
    """Run ``num_sweeps`` backups over ``mesh``; returns ``(values, argmin,
    policies)`` as whole (unpadded) tensors on every process: the final
    table, the last sweep's int32 argmin and, when asked, the per-sweep
    policies ``(num_sweeps, *state_shape)`` in the narrow policy dtype."""
    sw = _Sweeper(sp, mesh, init_values)
    pdt = policy_dtype_for(sp.action_size)
    pols = []
    for _ in range(num_sweeps):
        sw.sweep()
        if store_policies:
            pols.append([a.to(pdt) for a in sw.args])
    policies = None
    if store_policies:
        policies = torch.stack([sw.gather(p) for p in pols]) if pols else \
            torch.empty((0,) + tuple(sp.plan.grid_shape), dtype=pdt,
                        device=mesh.device)
    return sw.v, sw.argmin(), policies


def value_iteration_finite_sharded(
    plan: InterpPlan,
    stage_cost,
    num_sweeps: int,
    mesh: Mesh,
    *,
    shard_axis: int = 0,
    state_axis_name: str = "s",
    action_axis_name: Optional[str] = None,
    init_values: Optional[torch.Tensor] = None,
    store_policies: bool = False,
) -> SolveResult:
    """Mesh-sharded twin of :func:`ocdp_tpu_torch.engine.
    value_iteration_finite` (gather backup): bitwise the one-device results;
    sharding only re-tiles the queries, and the first-minimum combine keeps
    the tie order."""
    sp = shard_backup_inputs(plan, stage_cost, mesh, shard_axis=shard_axis,
                             state_axis_name=state_axis_name,
                             action_axis_name=action_axis_name)
    values, argmin, policies = sharded_bellman_sweeps(
        sp, mesh, num_sweeps, init_values=init_values,
        store_policies=store_policies)
    return SolveResult(values=values, argmin=argmin, policies=policies,
                       num_sweeps=num_sweeps, converged=False)


def value_iteration_converged_sharded(
    plan: InterpPlan,
    stage_cost,
    max_sweeps: int,
    mesh: Mesh,
    *,
    check_every: int = 50,
    tol: float = 1e-2,
    tol_mode: str = "abs",
    shard_axis: int = 0,
    state_axis_name: str = "s",
    action_axis_name: Optional[str] = None,
    init_values: Optional[torch.Tensor] = None,
    on_check=None,
) -> SolveResult:
    """Mesh-sharded twin of :func:`ocdp_tpu_torch.engine.
    value_iteration_converged`. After each sweep's gather every rank holds
    the whole table, so ``errorF = Δ Σ V`` is the one-device sum; ``errorU
    = Δ Σ argmin`` sums each block's real rows and then the blocks in rank
    order (integers, exact in float32 below 2**24). Results, the stop sweep
    and the check log equal the one-device engine's. ``on_check(k_s,
    errorF, errorU)`` fires once per check, on the process of rank 0."""
    sp = shard_backup_inputs(plan, stage_cost, mesh, shard_axis=shard_axis,
                             state_axis_name=state_axis_name,
                             action_axis_name=action_axis_name)
    sw = _Sweeper(sp, mesh, init_values)
    n_done, converged, checks = converged_loop(
        sw.sweep, sw.checksums, mesh, max_sweeps, check_every, tol,
        tol_mode, on_check)
    return SolveResult(values=sw.v, argmin=sw.argmin(), policies=None,
                       num_sweeps=n_done, converged=converged, checks=checks)
