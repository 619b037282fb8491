"""Every multi-rank engine once, each held to its one-device solve
(counterpart of ``dryrun_multichip`` in the JAX package's
``__graft_entry__.py:35-219``).

    from ocdp_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(8, device="cuda")

Runs on whichever communicator :func:`~ocdp_tpu_torch.parallel.make_mesh`
gives: an in-process mesh on ``device`` when no process group is running,
else the process group (every process calls this with the same
arguments; each case runs on the first ranks it needs, and a process
outside them only takes part in building the mesh). Small shapes; every
comparison is bitwise, including the 2-D meshes that the JAX package holds
only to an ulp. Raises ``AssertionError`` on a mismatch; returns the
names of the cases it ran.
"""

from __future__ import annotations

import torch

__all__ = ["dryrun_multichip"]


def _equal(res, ref, what: str, with_policies: bool = False) -> None:
    for field in ("values", "argmin") + (("policies",) if with_policies
                                         else ()):
        got, want = getattr(res, field), getattr(ref, field)
        if not torch.equal(got.to(want.dtype).reshape(want.shape), want):
            raise AssertionError(f"{what}: sharded {field} != one-device")


def dryrun_multichip(n_ranks: int, *, device="cuda") -> list:
    """One solve per engine over meshes of at most ``n_ranks`` ranks, each
    asserted equal to its one-device solve (see the module docstring)."""
    from ..engine import value_iteration_converged, value_iteration_finite
    from ..models import attitude, kirk, pos_att
    from ..ops.backup6d import Backup6D
    from ..ops.band_backup2d import BandBackup2D
    from ..utils.device import resolve_device
    from . import (initialize_distributed, make_mesh,
                   value_iteration_converged_halo6,
                   value_iteration_converged_sharded,
                   value_iteration_finite_halo, value_iteration_finite_halo6,
                   value_iteration_finite_sharded)

    import torch.distributed as dist

    # the one-process bootstrap is a no-op
    initialize_distributed(num_processes=1, process_id=0)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_ranks > world:
            raise ValueError(f"{n_ranks} ranks in a group of {world}")
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        if device == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    device = resolve_device(device)
    ran = []

    def mesh_of(names, sizes):
        return make_mesh(names, sizes, device=device)

    # replicated table, state (x action) sharded: Kirk
    two_d = n_ranks % 2 == 0 and n_ranks > 1
    names, sizes = ((("s", "a"), (n_ranks // 2, 2)) if two_d
                    else (("s",), (n_ranks,)))
    act = "a" if two_d else None
    problem = kirk.build(kirk.KirkConfig(N=4, dx=2 * max(1, n_ranks // 2)
                                         + 1, du=11), device=device)
    mesh = mesh_of(names, sizes)
    if mesh.is_member:
        ref = value_iteration_finite(problem.plan, problem.stage_cost, 3,
                                     store_policies=True)
        res = value_iteration_finite_sharded(
            problem.plan, problem.stage_cost, 3, mesh,
            action_axis_name=act, store_policies=True)
        _equal(res, ref, "replicated-sharded finite", with_policies=True)
        ref3 = value_iteration_converged(problem.plan, problem.stage_cost,
                                         4, check_every=2, tol=0.0)
        res3 = value_iteration_converged_sharded(
            problem.plan, problem.stage_cost, 4, mesh, check_every=2,
            tol=0.0, action_axis_name=act)
        if res3.num_sweeps != 4 or not torch.equal(res3.checks, ref3.checks):
            raise AssertionError("replicated-sharded converged: sweeps or "
                                 "check log != one-device")
        _equal(res3, ref3, "replicated-sharded converged")
        ran += ["sharded finite", "sharded converged"]

    # halo exchange with the gather backup, 1-D and rows x actions
    problem2 = kirk.build(kirk.KirkConfig(N=4, dx=8 * n_ranks, du=12),
                          device=device)
    mesh = mesh_of(("s",), (n_ranks,))
    if mesh.is_member:
        ref2 = value_iteration_finite(problem2.plan, problem2.stage_cost, 3,
                                      store_policies=True)
        res2 = value_iteration_finite_halo(
            problem2.plan, problem2.stage_cost, 3, mesh, store_policies=True)
        _equal(res2, ref2, "halo finite", with_policies=True)
        ran.append("halo finite")
    if two_d:
        problem2d = kirk.build(kirk.KirkConfig(N=4, dx=8 * (n_ranks // 2),
                                               du=12), device=device)
        mesh = mesh_of(("s", "a"), (n_ranks // 2, 2))
        if mesh.is_member:
            ref2d = value_iteration_finite(
                problem2d.plan, problem2d.stage_cost, 3, store_policies=True)
            res2d = value_iteration_finite_halo(
                problem2d.plan, problem2d.stage_cost, 3, mesh,
                action_axis_name="a", store_policies=True)
            _equal(res2d, ref2d, "halo 2-D (s, a) mesh finite",
                   with_policies=True)
            ran.append("halo 2-D finite")

    # halo exchange with kernel B.6 on a simplified attitude axis
    if n_ranks >= 2:
        acfg = attitude.AttitudeConfig(n_mesh_w=20, n_mesh_t=12)
        _, splan, sterms = attitude.build_simplified_axis(acfg, 0,
                                                          device=device)
        mesh = mesh_of(("s",), (2,))
        if mesh.is_member:
            sref = value_iteration_finite(splan, sterms, 3,
                                          backup=BandBackup2D(splan, sterms))
            sres = value_iteration_finite_halo(splan, sterms, 3, mesh,
                                               backup="band")
            _equal(sres, sref, "halo finite, band backup")
            ran.append("halo band finite")

    # row-sharded 6-D attitude (B.7), finite and converged
    if n_ranks >= 2:
        acfg = attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4)
        _, aplan, acost = attitude.build_full(acfg, device=device)
        abk = Backup6D(aplan, acost)
        aref = value_iteration_finite(aplan, acost, 2, backup=abk)
        mesh = mesh_of(("s",), (2,))
        if mesh.is_member:
            res6 = value_iteration_finite_halo6(aplan, acost, 2, mesh)
            _equal(res6, aref, "halo6 finite")
            aref6c = value_iteration_converged(aplan, acost, 4,
                                               check_every=2, tol=0.0,
                                               backup=abk)
            res6c = value_iteration_converged_halo6(aplan, acost, 4, mesh,
                                                    check_every=2, tol=0.0)
            if res6c.num_sweeps != 4:
                raise AssertionError("halo6 converged stopped early")
            _equal(res6c, aref6c, "halo6 converged")
            ran += ["halo6 finite", "halo6 converged"]
        # rows x digit slices: the 27 actions over 3 ranks
        if n_ranks >= 6:
            mesh = mesh_of(("s", "a"), (2, 3))
            if mesh.is_member:
                res6d = value_iteration_finite_halo6(
                    aplan, acost, 2, mesh, action_axis_name="a")
                if res6d.digit_path is not True:
                    raise AssertionError("halo6 2-D: the digit slices did "
                                         "not take the factorized phase")
                _equal(res6d, aref, "halo6 2-D (s, a) mesh finite")
                ran.append("halo6 2-D finite")

    # channel expert parallelism: one pos-att channel per rank
    if n_ranks >= 4:
        cfg_ep = pos_att.PosAttConfig(n_mesh_x=4, n_mesh_v=4, n_mesh_t=3,
                                      n_mesh_w=3)
        mesh = mesh_of(("c",), (4,))
        if mesh.is_member:
            sol = pos_att.solve_ep(cfg_ep, mesh, max_sweeps=3)
            for name in ("x", "y", "z", "x_failure"):
                ctrl, _ = pos_att.solve_channel(
                    cfg_ep, name.replace("_failure", ""),
                    failure="failure" in name, max_sweeps=3, device=device)
                got = sol.controllers[name]
                if not (torch.equal(got.values, ctrl.values)
                        and torch.equal(got.argmin, ctrl.argmin)):
                    raise AssertionError(f"EP channel {name} != serial "
                                         "solve")
            ran.append("solve_ep")
    return ran
