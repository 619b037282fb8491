"""Halo-exchange value iteration with the value table itself sharded
(counterpart of ``ocdp_tpu/parallel/halo.py``).

The replicated-table engines (``parallel/sharded.py``) gather the whole
table every sweep. Here each rank keeps only its block of the state grid's
axis 0, plus the rows of its neighbors its queries read:

* rank s owns rows ``[r0, r1)`` of :func:`~ocdp_tpu_torch.parallel.mesh.
  row_blocks` and keeps a local table of ``lo + (r1 - r0) + hi`` rows;
* ``lo``/``hi`` are the plan's exact axis-0 reach: a query of row r reads
  rows ``lo[0]`` and ``lo[0] + 1`` (``plan.lo[0]`` lies in ``[0, n - 2]``),
  so ``lo = max(r - plan.lo[0])`` and ``hi = max(plan.lo[0] + 1 - r)``;
* each sweep every rank takes its neighbors' boundary rows
  (:meth:`~ocdp_tpu_torch.parallel.mesh.Mesh.halo_exchange`), nothing else
  moves.

The JAX engines run the XLA stencil backup (``build_stencil_backup``), which
the port does not have; here the backup is an argument:

* ``'gather'``: the gather oracle (``ops/backup.py``) on the block's queries,
  with ``plan.lo[0]`` shifted into the local table's frame, on any plan;
* ``'band'``: kernel B.6 (:class:`~ocdp_tpu_torch.ops.band_backup2d.
  BandBackup2D`) on a 2-D plan. Each rank's backup is B.6 over its local
  table as a problem of ``lo + (r1 - r0) + hi`` rows: the block's rows carry
  the block's queries with ``lo`` shifted by the block's first row minus the
  halo width, the halo rows a dead query on their own grid point (frac 0, no
  cost) whose results are dropped. The kernel does not change.

``action_axis_name``: a second mesh axis over the actions, in contiguous
groups that must divide them; each group's first minimum combines by the
ascending-offset first minimum. Either backup computes each query's total
on its own, so the results are bitwise the same backup's on one device
(the reference holds its stencil halo only to an ulp, because separate XLA
compilations contract FMAs differently; nothing here does).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..engine import SolveResult, policy_dtype_for
from ..ops.backup import bellman_backup
from ..ops.band_backup2d import BandBackup2D
from ..ops.interp import InterpPlan
from .mesh import Mesh, first_min, row_blocks
from .sharded import converged_loop

__all__ = ["value_iteration_finite_halo", "value_iteration_converged_halo",
           "axis0_reach"]

BACKUPS = ("gather", "band")


def axis0_reach(plan: InterpPlan) -> tuple:
    """``(lo, hi)``: the rows above and below its own that a query of the
    plan reads on axis 0 (its two corners ``lo[0]`` and ``lo[0] + 1``)."""
    n = plan.grid_shape[0]
    lo0 = plan.lo[0].reshape((1,) * (len(plan.query_shape) - plan.lo[0].ndim)
                             + tuple(plan.lo[0].shape))
    own = torch.arange(n, device=lo0.device).reshape(
        (-1,) + (1,) * (lo0.ndim - 1))
    d = lo0.to(torch.int64) - own
    return max(-int(d.min()), 0), max(int(d.max()) + 1, 0)


def _full_rank(t, ndim, device):
    t = torch.as_tensor(t, device=device)
    return t.reshape((1,) * (ndim - t.ndim) + tuple(t.shape))


class _Block:
    """One local rank's backup: its rows ``[r0, r1)`` and actions
    ``[a0, a1)``, swept from its local table."""

    def __init__(self, plan, terms, kind, r0, r1, a0, a1, lo, hi):
        self.r0, self.r1, self.a0, self.lo = r0, r1, a0, lo
        nd = len(plan.query_shape)
        shift = r0 - lo
        n_loc = lo + (r1 - r0) + hi

        def cut(t):
            t = _full_rank(t, nd, plan.device)
            if t.shape[0] > 1:
                t = t[r0:r1]
            if t.shape[-1] > 1:
                t = t[..., a0:a1]
            return t

        lo0 = cut(plan.lo[0])
        rows = (r1 - r0,) + tuple(lo0.shape[1:])
        los = [lo0.expand(rows) - shift] + [cut(x) for x in plan.lo[1:]]
        fracs = [cut(x) for x in plan.frac]
        costs = [cut(t) for t in terms]
        local_grid = (n_loc,) + tuple(plan.grid_shape[1:])
        if kind == "gather":
            self.plan = InterpPlan(tuple(los), tuple(fracs), local_grid)
            self.cost = costs
            self.band = None
            return
        # B.6 over the local table as a problem of n_loc rows: the halo
        # rows get a dead query (their own row, frac 0, no cost), dropped
        if len(local_grid) != 2:
            raise ValueError("the 'band' backup takes 2-D plans; use "
                             "'gather'")
        dev, b = plan.device, r1 - r0
        own = torch.arange(n_loc, device=dev, dtype=torch.int32).clamp(
            max=n_loc - 2).reshape(-1, 1, 1)

        def with_halo(t, top, bot):
            t = t.expand((b,) + tuple(t.shape[1:]))
            rest = tuple(t.shape[1:])
            return torch.cat([top.to(t.dtype).expand((lo,) + rest), t,
                              bot.to(t.dtype).expand((hi,) + rest)])

        zero = torch.zeros((1, 1, 1), device=dev)
        plan_l = InterpPlan(
            (with_halo(los[0], own[:lo], own[lo + b:]),
             with_halo(los[1], zero, zero)),
            tuple(with_halo(f, zero, zero) for f in fracs), local_grid)
        # the block's dense cost, summed in term order as BandBackup2D sums
        # the whole plan's
        q = tuple(torch.broadcast_shapes(*(x.shape for x in los + fracs)))
        dense = np.zeros(q, np.float32)
        for t in costs:
            dense = dense + t.detach().cpu().numpy().astype(np.float32)
        halo = [np.zeros((n,) + q[1:], np.float32) for n in (lo, hi)]
        self.band = BandBackup2D(plan_l,
                                 np.concatenate([halo[0], dense, halo[1]]))

    def __call__(self, v_local: torch.Tensor):
        """``(values, global argmin)`` of the block's rows."""
        if self.band is None:
            res = bellman_backup(v_local, self.plan, self.cost)
            vals, args = res.values, res.argmin
        else:
            res = self.band(v_local)
            b = self.r1 - self.r0
            vals = res.values[self.lo:self.lo + b]
            args = res.argmin[self.lo:self.lo + b]
        return vals, args + self.a0 if self.a0 else args


class _HaloRanks:
    """The local ranks of a halo solve: backups, ping-pong local tables
    (the halos of an edge rank stay zero) and the combine over the action
    axis."""

    def __init__(self, plan, stage_cost, mesh: Mesh, axis_name: str,
                 action_axis_name: Optional[str], backup: str, init_values):
        if backup not in BACKUPS:
            raise ValueError(f"unknown backup {backup!r}; use one of "
                             f"{BACKUPS}")
        if not mesh.is_member:
            raise ValueError("this process holds no rank of the mesh")
        if mesh.device != plan.device:
            raise ValueError(f"the plan is on {plan.device}, the mesh on "
                             f"{mesh.device}")
        self.mesh, self.axis_name = mesh, axis_name
        self.action_axis_name = action_axis_name
        s_ax = mesh.axis(axis_name)
        n_s = mesh.axis_sizes[s_ax]
        n_act = plan.query_shape[-1]
        self.n_actions = n_act
        n_a = mesh.shape[action_axis_name] if action_axis_name else 1
        if n_act % n_a:
            raise ValueError(f"{n_act} actions do not divide across the "
                             f"{n_a}-rank action mesh axis")
        k = n_act // n_a
        self.lo, self.hi = axis0_reach(plan)
        self.blocks = row_blocks(plan.grid_shape[0], n_s)
        b_min = min(r1 - r0 for r0, r1 in self.blocks)
        if max(self.lo, self.hi) > b_min:
            raise ValueError(
                f"halo widths ({self.lo}, {self.hi}) exceed the per-rank "
                f"block height {b_min}; use fewer ranks or the replicated "
                "engine")
        terms = (list(stage_cost) if isinstance(stage_cost, (tuple, list))
                 else [stage_cost])
        self.grid_shape = tuple(plan.grid_shape)
        rest = self.grid_shape[1:]
        v0 = None if init_values is None else torch.as_tensor(
            init_values, dtype=torch.float32,
            device=mesh.device).reshape(self.grid_shape)
        self.backups, self.cur, self.nxt, self.my_rows = [], [], [], []
        for coord in mesh.local_coords:
            r0, r1 = self.blocks[coord[s_ax]]
            g = coord[mesh.axis(action_axis_name)] if action_axis_name else 0
            self.backups.append(_Block(plan, terms, backup, r0, r1, g * k,
                                       (g + 1) * k, self.lo, self.hi))
            cur = torch.zeros((self.lo + r1 - r0 + self.hi,) + rest,
                              dtype=torch.float32, device=mesh.device)
            if v0 is not None:
                cur[self.lo:self.lo + r1 - r0].copy_(v0[r0:r1])
            self.cur.append(cur)
            self.nxt.append(torch.zeros_like(cur))
            self.my_rows.append((r0, r1))
        self.args = [None] * len(self.cur)

    @property
    def rows(self) -> list:
        return [r1 - r0 for r0, r1 in self.blocks]

    def interior(self, i: int, t: torch.Tensor) -> torch.Tensor:
        r0, r1 = self.my_rows[i]
        return t[self.lo:self.lo + r1 - r0]

    def sweep(self) -> None:
        self.mesh.halo_exchange(self.cur, self.axis_name, self.rows,
                                self.lo, self.hi)
        out = [bk(t) for bk, t in zip(self.backups, self.cur)]
        vals, args = [o[0] for o in out], [o[1] for o in out]
        if self.action_axis_name:
            gv = self.mesh.all_gather(vals, self.action_axis_name)
            ga = self.mesh.all_gather(args, self.action_axis_name)
            comb = [first_min(x, y, self.n_actions)
                    for x, y in zip(gv, ga)]
            vals, args = [c[0] for c in comb], [c[1] for c in comb]
        for i, v in enumerate(vals):
            self.interior(i, self.nxt[i]).copy_(v)
        self.args = args
        self.cur, self.nxt = self.nxt, self.cur

    def gather(self, blocks: list) -> torch.Tensor:
        return self.mesh.gather_rows(blocks, self.axis_name, self.blocks)

    def checksums(self) -> tuple:
        """``(Σ V, Σ argmin)``: each block summed in float32, then the
        blocks in rank order."""
        fs = [self.interior(i, t).sum(dtype=torch.float32)
              for i, t in enumerate(self.cur)]
        us = [a.sum(dtype=torch.float32) for a in self.args]
        return (self.mesh.sum(fs, self.axis_name)[0].cpu(),
                self.mesh.sum(us, self.axis_name)[0].cpu())

    def values(self) -> torch.Tensor:
        return self.gather([self.interior(i, t)
                            for i, t in enumerate(self.cur)])

    def argmin(self) -> torch.Tensor:
        if self.args[0] is None:
            return torch.zeros(self.grid_shape, dtype=torch.int32,
                               device=self.mesh.device)
        return self.gather(self.args).to(torch.int32)


def value_iteration_finite_halo(
    plan: InterpPlan,
    stage_cost,
    num_sweeps: int,
    mesh: Mesh,
    *,
    axis_name: str = "s",
    action_axis_name: Optional[str] = None,
    backup: str = "gather",
    init_values: Optional[torch.Tensor] = None,
    store_policies: bool = False,
) -> SolveResult:
    """Finite-horizon value iteration with the table sharded on axis 0 over
    ``mesh[axis_name]`` and a halo exchange per sweep (the actions split
    over ``mesh[action_axis_name]`` when given). ``backup``: ``'gather'``
    or ``'band'`` (see the module docstring). Returns the whole tables on
    every process; bitwise the same backup run on one device."""
    st = _HaloRanks(plan, stage_cost, mesh, axis_name, action_axis_name,
                    backup, init_values)
    pdt = policy_dtype_for(st.n_actions)
    pols = [] if store_policies else None
    for _ in range(num_sweeps):
        st.sweep()
        if pols is not None:
            pols.append([a.to(pdt) for a in st.args])
    policies = None
    if store_policies:
        policies = torch.stack([st.gather(p) for p in pols]) if pols else \
            torch.empty((0,) + st.grid_shape, dtype=pdt, device=mesh.device)
    return SolveResult(values=st.values(), argmin=st.argmin(),
                       policies=policies, num_sweeps=num_sweeps,
                       converged=False)


def value_iteration_converged_halo(
    plan: InterpPlan,
    stage_cost,
    max_sweeps: int,
    mesh: Mesh,
    *,
    check_every: int = 50,
    tol: float = 1e-2,
    tol_mode: str = "abs",
    axis_name: str = "s",
    action_axis_name: Optional[str] = None,
    backup: str = "gather",
    init_values: Optional[torch.Tensor] = None,
    on_check=None,
) -> SolveResult:
    """Early-stopping twin of :func:`value_iteration_finite_halo`: the
    reference's periodic-checksum stop (pos-att/Solver_pos_att.m:268-286),
    with ``errorF``/``errorU`` summed over each block and then over the row
    ranks in order, so every rank stops at the same sweep. Values and argmin
    are bitwise the one-device converged solve's with the same backup; the
    checksums can differ from its one-table sums by an ulp, so a tolerance
    sitting exactly on an ``errorF`` could stop one check apart.
    ``on_check(k_s, errorF, errorU)`` fires once per check, on the process
    of rank 0."""
    st = _HaloRanks(plan, stage_cost, mesh, axis_name, action_axis_name,
                    backup, init_values)
    n_done, converged, checks = converged_loop(
        st.sweep, st.checksums, mesh, max_sweeps, check_every, tol,
        tol_mode, on_check)
    return SolveResult(values=st.values(), argmin=st.argmin(), policies=None,
                       num_sweeps=n_done, converged=converged, checks=checks)
