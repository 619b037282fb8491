"""Row-sharded 6-D attitude value iteration: halo exchange + kernel B.7
(counterpart of ``ocdp_tpu/parallel/halo6.py``).

Scales the full-attitude solve (attitude-control/Solver_attitude.m:261-300)
past one device: the ``(NW, NE)`` value table's ROW axis (the flat omega
index) is split over the mesh axis ``axis_name``, and each sweep exchanges
only the kernel's row reach with the neighbors:

* rank s owns rows ``[r0, r1)`` of :func:`~ocdp_tpu_torch.parallel.mesh.
  row_blocks` (heights differ by at most one; nothing is padded) and keeps a
  local table of ``lo + (r1 - r0) + hi`` rows, ping-ponged with a second
  one;
* ``lo``/``hi`` are the exact reach of the live row combos
  (:meth:`~ocdp_tpu_torch.ops.backup6d.Backup6D.row_reach`): the bottom
  ``lo`` rows of rank s - 1 and the top ``hi`` rows of rank s + 1; the edge
  ranks' halos stay zero, the value the one-device sweep reads outside the
  table;
* each rank sweeps its block with B.7 (:func:`~ocdp_tpu_torch.ops.backup6d.
  backup6d_block`) straight into the interior of its other table.

The plan is analysed once, on the whole grid (:class:`~ocdp_tpu_torch.ops.
backup6d.Backup6D`), and every rank and action group gets slices of that
analysis: the full plan's live row taps, row combos and lane combos. A block
re-analysed alone could drop ``0 * A`` terms from its sums, flipping the
sign of an exact zero (or dropping a ``0 * inf`` NaN); the JAX package gets
the same effect from its one global kernel and its union live sets.

``action_axis_name`` adds a second mesh axis over the 27-action contraction:
the actions split into contiguous ascending groups, each rank of a row
computes its group's first minimum over its block, and the groups combine
by the ascending-offset first minimum (:func:`~ocdp_tpu_torch.parallel.
mesh.first_min`). When the actions factor digit by digit (A = m^3) and each
group is one fixed-d0 slice of m^2 actions, the groups run the factorized
phase (B.7's digit-slice mode) and every action's total, hence the result,
is bitwise the one-device sweep's; otherwise every group runs the generic
phase, within an ulp. The result's ``digit_path`` says which ran.

Results are bitwise the one-device :class:`~ocdp_tpu_torch.ops.backup6d.
Backup6D` through the engines of ``engine.py``; the converged engines'
checksums sum each block and then the blocks in rank order, which can
differ from the one-device sum by an ulp.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..engine import SolveResult, policy_dtype_for
from ..ops.backup6d import (Backup6D, backup6d_block, block_args, digit_path,
                            slice_args)
from .mesh import Mesh, first_min, row_blocks
from .sharded import converged_loop

__all__ = ["value_iteration_finite_halo6", "value_iteration_converged_halo6"]


class Halo6Backup:
    """One plan's B.7 inputs for every local rank of a mesh.

    ``backup``: the :class:`Backup6D` of the whole plan; ``blocks``: each
    row rank's ``(r0, r1)``; ``lo``/``hi``: the halo widths;
    ``group_size``: the actions of a group (A without an action axis);
    ``digit_path``: whether the groups run the factorized phase (None
    without an action axis); ``args``: the B.7 inputs of each local rank,
    in ``mesh.local_coords`` order. ``kernel_kw``: :class:`Backup6D`'s
    options (``carry_padded`` raises).
    """

    def __init__(self, plan, cost_terms, mesh: Mesh, *, axis_name: str = "s",
                 action_axis_name: Optional[str] = None, **kernel_kw):
        if kernel_kw.get("carry_padded"):
            raise ValueError("carry_padded is a single-device engine mode; "
                             "the halo engines manage their own tables")
        if not mesh.is_member:
            raise ValueError("this process holds no rank of the mesh")
        if mesh.device != plan.device:
            raise ValueError(f"the plan is on {plan.device}, the mesh on "
                             f"{mesh.device}")
        self.mesh = mesh
        self.s_ax = mesh.axis(axis_name)
        self.axis_name = axis_name
        self.action_axis_name = action_axis_name
        n_s = mesh.axis_sizes[self.s_ax]
        n_a = mesh.shape[action_axis_name] if action_axis_name else 1
        bk = self.backup = Backup6D(plan, cost_terms, **kernel_kw)
        n_act = bk.args.n_actions
        if n_act % n_a:
            raise ValueError(f"{n_act} actions do not split over {n_a} "
                             "action-mesh ranks")
        self.lo, self.hi = bk.row_reach()
        self.blocks = row_blocks(bk.NW, n_s)
        b_min = min(r1 - r0 for r0, r1 in self.blocks)
        if max(self.lo, self.hi) > b_min:
            raise ValueError(
                f"halo widths ({self.lo}, {self.hi}) exceed the per-rank "
                f"block height {b_min}; use fewer ranks")
        self.group_size = n_act // n_a
        self.n_actions = n_act
        self.digit_path = None
        if action_axis_name:
            self.digit_path = all(
                digit_path(bk.args, g * self.group_size,
                           (g + 1) * self.group_size) for g in range(n_a))
        self.args = []
        for coord in mesh.local_coords:
            r0, r1 = self.blocks[coord[self.s_ax]]
            a = block_args(bk.args, r0, r1, self.lo, self.hi)
            if action_axis_name:
                g = coord[mesh.axis(action_axis_name)]
                a = slice_args(a, g * self.group_size,
                               (g + 1) * self.group_size)
            self.args.append(a)

    @property
    def rows(self) -> list:
        return [r1 - r0 for r0, r1 in self.blocks]

    def block_of(self, i: int) -> tuple:
        """``(r0, r1)`` of local rank ``i``."""
        return self.blocks[self.mesh.local_coords[i][self.s_ax]]


class _Ranks:
    """The local ranks' tables: two ``(lo + rows + hi, NE)`` float32 tables
    each (ping-pong; the halos of an edge rank stay zero) and an argmin
    block, in the kernel's argmin dtype (with an action axis: in the policy
    dtype, and each group's own minimum and argmin beside it)."""

    def __init__(self, hb: Halo6Backup, init_values):
        bk, dev = hb.backup, hb.mesh.device
        ne, lo, hi = bk.NE, hb.lo, hb.hi
        self.hb = hb
        self.pdt = policy_dtype_for(hb.n_actions)
        v0 = None
        if init_values is not None:
            v0 = torch.as_tensor(init_values, dtype=torch.float32,
                                 device=dev).reshape(bk.NW, ne)
        self.cur, self.nxt, self.argm, self.vals_g, self.argm_g = \
            [], [], [], [], []
        for i in range(len(hb.mesh.local_coords)):
            r0, r1 = hb.block_of(i)
            b = r1 - r0
            cur = torch.zeros((lo + b + hi, ne), dtype=torch.float32,
                              device=dev)
            if v0 is not None:
                cur[lo:lo + b].copy_(v0[r0:r1])
            self.cur.append(cur)
            self.nxt.append(torch.zeros_like(cur))
            self.argm.append(torch.zeros(
                (b, ne), dtype=self.pdt if hb.action_axis_name
                else hb.args[i].argmin_dtype, device=dev))
            if hb.action_axis_name:
                self.vals_g.append(torch.empty((b, ne), dtype=torch.float32,
                                               device=dev))
                self.argm_g.append(torch.empty(
                    (b, ne), dtype=hb.args[i].argmin_dtype, device=dev))

    def interior(self, i: int, t: torch.Tensor) -> torch.Tensor:
        b = t.shape[0] - self.hb.lo - self.hb.hi
        return t[self.hb.lo:self.hb.lo + b]

    def sweep(self) -> None:
        """One sweep of every local rank: halo exchange, B.7, and with an
        action axis the first-minimum combine; then swap the tables."""
        hb, mesh = self.hb, self.hb.mesh
        mesh.halo_exchange(self.cur, hb.axis_name, hb.rows, hb.lo, hb.hi)
        if not hb.action_axis_name:
            for i, args in enumerate(hb.args):
                backup6d_block(self.cur[i], args,
                               self.interior(i, self.nxt[i]), self.argm[i])
        else:
            for i, args in enumerate(hb.args):
                backup6d_block(self.cur[i], args, self.vals_g[i],
                               self.argm_g[i])
            vals = mesh.all_gather(self.vals_g, hb.action_axis_name)
            args = mesh.all_gather(self.argm_g, hb.action_axis_name)
            for i in range(len(hb.args)):
                # B.7 returns global action indices: no offsets to add
                vmin, arg = first_min(vals[i], args[i], hb.n_actions)
                self.interior(i, self.nxt[i]).copy_(vmin)
                self.argm[i].copy_(arg)
        self.cur, self.nxt = self.nxt, self.cur

    def gather(self, blocks: list) -> torch.Tensor:
        return self.hb.mesh.gather_rows(blocks, self.hb.axis_name,
                                        self.hb.blocks)

    def checksums(self) -> tuple:
        """``(Σ V, Σ argmin)`` over the real cells: each block summed in
        float32, then the blocks in rank order."""
        hb = self.hb
        fs = [self.interior(i, t).sum(dtype=torch.float32)
              for i, t in enumerate(self.cur)]
        us = [a.sum(dtype=torch.float32) for a in self.argm]
        fsum = hb.mesh.sum(fs, hb.axis_name)[0].cpu()
        usum = hb.mesh.sum(us, hb.axis_name)[0].cpu()
        return fsum, usum


def value_iteration_finite_halo6(
    plan,
    cost_terms,
    num_sweeps: int,
    mesh: Mesh,
    *,
    axis_name: str = "s",
    action_axis_name: Optional[str] = None,
    init_values: Optional[torch.Tensor] = None,
    store_policies: bool = False,
    **kernel_kw,
) -> SolveResult:
    """Finite-horizon value iteration with the ``(NW, NE)`` table
    row-sharded over ``mesh[axis_name]`` (and the actions over
    ``mesh[action_axis_name]`` when given). Returns the whole tables on
    every process, in the state grid's shape, int32 argmin; policies
    ``(num_sweeps, *state_shape)`` in the narrow policy dtype. Bitwise the
    one-device :class:`Backup6D` solve (see the module docstring for the
    generic-phase exception; ``digit_path`` on the result says which
    phase the action groups ran). ``kernel_kw``: :class:`Backup6D`'s
    options."""
    hb = Halo6Backup(plan, cost_terms, mesh, axis_name=axis_name,
                     action_axis_name=action_axis_name, **kernel_kw)
    st = _Ranks(hb, init_values)
    pols = ([torch.empty((num_sweeps,) + tuple(a.shape), dtype=st.pdt,
                         device=a.device) for a in st.argm]
            if store_policies else None)
    for k in range(num_sweeps):
        st.sweep()
        if pols is not None:
            for p, a in zip(pols, st.argm):
                p[k].copy_(a)
    return _result(hb, st, num_sweeps, False, None, pols)


def _result(hb: Halo6Backup, st: _Ranks, n_sweeps: int, converged: bool,
            checks, pols) -> SolveResult:
    shape = hb.backup.state_shape
    values = st.gather([st.interior(i, t) for i, t in enumerate(st.cur)])
    argmin = st.gather(st.argm).to(torch.int32)
    policies = None
    if pols is not None:
        policies = st.gather([p.transpose(0, 1) for p in pols]) \
            .transpose(0, 1).reshape((n_sweeps,) + tuple(shape))
    return SolveResult(values=values.reshape(shape),
                       argmin=argmin.reshape(shape), policies=policies,
                       num_sweeps=n_sweeps, converged=converged,
                       checks=checks, digit_path=hb.digit_path)


def value_iteration_converged_halo6(
    plan,
    cost_terms,
    max_sweeps: int,
    mesh: Mesh,
    *,
    check_every: int = 50,
    tol: float = 1e-2,
    tol_mode: str = "abs",
    axis_name: str = "s",
    action_axis_name: Optional[str] = None,
    init_values: Optional[torch.Tensor] = None,
    on_check=None,
    **kernel_kw,
) -> SolveResult:
    """Early-stopping twin of :func:`value_iteration_finite_halo6`: the
    reference's periodic-checksum stop (pos-att/Solver_pos_att.m:268-286)
    as :func:`~ocdp_tpu_torch.engine.value_iteration_converged` runs it,
    with ``errorF = Δ Σ V`` and ``errorU = Δ Σ argmin`` summed over the real
    cells of each block and then over the row ranks in order (so every rank
    makes the same stop decision; with an action axis the row axis only, as
    the combined tables are the same on every group). The check log
    ``[k_s, errorF, errorU]`` comes back in ``checks``; ``on_check(k_s,
    errorF, errorU)`` fires once per check, on the process of rank 0.
    Values and argmin are bitwise the one-device converged solve's; the
    checksums can differ from its one-table sums by an ulp."""
    hb = Halo6Backup(plan, cost_terms, mesh, axis_name=axis_name,
                     action_axis_name=action_axis_name, **kernel_kw)
    st = _Ranks(hb, init_values)
    n_done, converged, checks = converged_loop(
        st.sweep, st.checksums, mesh, max_sweeps, check_every, tol,
        tol_mode, on_check)
    return _result(hb, st, n_done, converged, checks, None)
