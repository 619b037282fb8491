"""Coupled position+attitude control per body axis (the flagship problem).

Counterpart of ``ocdp_tpu/models/pos_att.py``: ``pos-att/Solver_pos_att.m``.
Per channel a 4-D state (x, v, theta, omega) is driven by 4 on/off thrusters
whose pruned combinations (9 healthy, 6 with a failed thruster) form the
action set; each channel solve runs value iteration with the reference's
periodic-checksum early stop; controllers persist to npz; the closed-loop
13-state simulation (translation + quaternion attitude + full-inertia Euler
equations) steps a batch of flights at once.

Channel wiring (Solver_pos_att.m:217-240, 404-449): x-translation couples to
pitch about the body y-axis (inertia J2), y to yaw about z (J3), z to roll
about x (J1). A thruster-0 failure variant of the x channel is solved too
(:236-240).

Reference parity:
* ``sym_linspace`` exact-n grids (:906-918), Euler steps (:330-402), stage
  cost (:784-802);
* early stop: every 50 sweeps |sum(V) - prev| < 1e-2 (:268-286);
* policy lookup on nearest-neighbor per-thruster force tables (:849-884),
  the state transformed RSW->ECI->body with the *initial* target state
  vector (:404-415, a reference quirk);
* the body-frame accelerations sum(f)/Mass (m/s^2) feed the km-based CW
  equations unscaled (:804-823 + :699-707): ``accel_scale=1.0``.

The builds and solves run on the card unless the caller asks for
``device="cpu"``; without a card they raise. The channels, each with its own
action set (6 actions for x_failure), run in lockstep as one batch through
the batched converged engine (one row/lane kernel launch a sweep on the
card), each with its own checks and stop; a one-channel solve is the batch
of one. The rollouts run on the solution's device, or on the device a
caller names.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..dynamics.orbital import target_orbit_R0V0
from ..dynamics.relmotion import cw_relative_rates, target_states
from ..engine import (SolveResult, value_iteration_converged,
                      value_iteration_converged_batch)
from ..grids import Grid, sym_linspace_exact
from ..io import ChannelController, save_channel_controller
from ..ops.interp import (AffineAxes, InterpPlan, affine_axes, build_plan,
                          nearest_cell_index)
from ..ops.rowlane import RowLaneBackup, RowLaneBatch
from ..profiling import solve_span, span, sweep_callback
from ..utils.frames import cross, matvec, rsw_to_eci_matrix
from ..utils.device import resolve_device, resolve_impl
from ..utils.integrators import integrator_kwargs
from ..utils.quaternions import (euler_zyx_to_quat, quat_kinematics,
                                 quat_to_dcm, small_angles_from_quat)
from .thrusters import (SPHERES_MOMENT_ARM, SPHERES_THRUSTER_FORCE,
                        thruster_combinations)

__all__ = [
    "PosAttConfig",
    "CHANNELS",
    "ChannelProblem",
    "build_channel",
    "build_channel_rowlane_backup",
    "solve_channel",
    "solve",
    "solve_channel_sharded",
    "solve_ep",
    "PosAttSolution",
    "default_x0",
    "get_optimal_path",
    "rollout_batch",
    "receding_horizon",
]

CHANNELS = ("x", "y", "z")
IMPLS = ("auto", "kernel", "rowlane", "gather")


@dataclasses.dataclass(frozen=True)
class PosAttConfig:
    # translational grid (Solver_pos_att.m:100-106)
    x_min: float = -0.2
    x_max: float = 0.2
    n_mesh_x: int = 30
    v_min: float = -0.1
    v_max: float = 0.1
    n_mesh_v: int = 30
    # attitude grid (:108-119); per-channel theta ranges in degrees
    w_min_deg: float = -2.0
    w_max_deg: float = 2.0
    n_mesh_w: int = 15
    theta_ranges_deg: tuple = ((-5.0, 5.0), (-6.0, 6.0), (-7.0, 7.0))
    n_mesh_t: int = 20
    # plant (:121-131, :171-192)
    mass: float = 4.16
    inertia_diag: tuple = (0.02836 + 0.00016, 0.026817 + 0.00150,
                           0.023 + 0.00150)
    inertia_offdiag: tuple = (-0.0000837, 0.000014, -0.00029)  # Ixy, Ixz, Iyz
    thruster_force: float = SPHERES_THRUSTER_FORCE
    moment_arm: float = SPHERES_MOMENT_ARM
    # cost (:138-151)
    Qx: float = 6.0
    Qv: float = 6.0
    Qt: float = 0.5
    Qw: float = 0.5
    R: float = 0.1
    # horizon (:155-156)
    T_final: float = 10.0
    h: float = 0.005
    # early stop (:269-284)
    check_every: int = 50
    tol: float = 1e-2
    # rollout parity knob (module docstring)
    accel_scale: float = 1.0

    def __post_init__(self):
        # the reference warns (and takes the ceiling) when T_final/h is not
        # an integer stage count (Solver_pos_att.m:161-165)
        if self.h <= 0:
            return
        n = self.T_final / self.h
        if abs(n - round(n)) > 1e-9:
            warnings.warn(
                f"T_final/h = {n!r} is not an integer; using "
                f"ceil = {self.n_stage} stages", stacklevel=3)

    @property
    def n_stage(self) -> int:
        return int(np.ceil(self.T_final / self.h))

    @staticmethod
    def high_res() -> "PosAttConfig":
        """The high-resolution coupled grid: 60x60x40x30 = 4.32M cells x 9
        combos per channel, 16x the reference parameterization
        (Solver_pos_att.m:100-119)."""
        return PosAttConfig(n_mesh_x=60, n_mesh_v=60, n_mesh_t=40,
                            n_mesh_w=30)

    @property
    def inertia_matrix(self) -> np.ndarray:
        d = self.inertia_diag
        o = self.inertia_offdiag
        return np.array([[d[0], o[0], o[1]],
                         [o[0], d[1], o[2]],
                         [o[1], o[2], d[2]]])

    def channel_inertia(self, channel: str) -> float:
        """x -> J2 (pitch about y), y -> J3, z -> J1 (:217-233)."""
        d = self.inertia_diag
        return {"x": d[1], "y": d[2], "z": d[0]}[channel]

    def thruster_value_sets(self, channel: str, failure: bool = False):
        """Per-thruster admissible force values, (f0, f1, f6, f7) order;
        ``failure=True`` disables the channel's first thruster (:236-240)."""
        F = self.thruster_force
        pos = np.array([0.0, F])
        neg = np.array([0.0, -F])
        f0 = np.array([0.0]) if failure else pos
        return (f0, pos, neg, neg)


class ChannelProblem(NamedTuple):
    config: PosAttConfig
    channel: str
    failure: bool
    grid: Grid
    forces: np.ndarray                  # (n_comb, 4) pruned combinations
    plan: InterpPlan                    # queries (nx, nv, nt, nw, n_comb)
    stage_cost: Optional[torch.Tensor]  # None when built with_cost=False


def _channel_axes(cfg: PosAttConfig, channel: str):
    i = CHANNELS.index(channel)
    t_lo, t_hi = cfg.theta_ranges_deg[i]
    s_x = sym_linspace_exact(cfg.x_min, cfg.x_max, cfg.n_mesh_x)
    s_v = sym_linspace_exact(cfg.v_min, cfg.v_max, cfg.n_mesh_v)
    s_t = sym_linspace_exact(np.deg2rad(t_lo), np.deg2rad(t_hi), cfg.n_mesh_t)
    s_w = sym_linspace_exact(np.deg2rad(cfg.w_min_deg),
                             np.deg2rad(cfg.w_max_deg), cfg.n_mesh_w)
    return s_x, s_v, s_t, s_w


def build_channel(cfg: PosAttConfig, channel: str, *, failure: bool = False,
                  with_cost: bool = True, device="cuda") -> ChannelProblem:
    """Grids, Euler-step next states and stage cost of one channel
    (:244-265), on ``device``.

    The next states keep the JAX package's operation order and float32
    rounding, so the plan is bitwise equal to its plan. The two divisions
    divide by float32 tensors on the device: PyTorch on a CUDA device would
    multiply by the reciprocal of a Python-scalar divisor instead.
    ``with_cost=False`` skips the dense (S, A) stage cost (``stage_cost``
    None), which only ``impl='gather'`` reads.
    """
    with span("ocdp.build"):
        device = resolve_device(device)
        s_x, s_v, s_t, s_w = _channel_axes(cfg, channel)
        grid = Grid((s_x, s_v, s_t, s_w))
        forces = thruster_combinations(
            *cfg.thruster_value_sets(channel, failure))
        h = cfg.h

        def col(a, k):
            shape = [1] * 5
            shape[k] = -1
            return torch.as_tensor(a, device=device).reshape(shape)

        x, v, t, w = (col(a, k) for k, a in enumerate((s_x, s_v, s_t, s_w)))
        f = torch.as_tensor(forces, device=device)
        fsum = col(f[:, 0] + f[:, 1] + f[:, 2] + f[:, 3], 4)
        # moment = (f0 - f1 + f6 - f7) * T_dist (wdynamics, :396-401)
        fmom = col(f[:, 0] - f[:, 1] + f[:, 2] - f[:, 3], 4)

        def scalar(value):
            return torch.tensor(value, dtype=torch.float32, device=device)

        x_next = x + h * v
        v_next = v + h * fsum / scalar(cfg.mass)
        t_next = t + h * w
        w_next = w + h * fmom * cfg.moment_arm / scalar(
            cfg.channel_inertia(channel))
        plan = build_plan(grid.axes, (x_next, v_next, t_next, w_next))

        cost = None
        if with_cost:
            fsq = col(f[:, 0] ** 2 + f[:, 1] ** 2 + f[:, 2] ** 2
                      + f[:, 3] ** 2, 4)
            cost = (cfg.Qx * x**2 + cfg.Qv * v**2 + cfg.Qt * t**2
                    + cfg.Qw * w**2 + cfg.R * fsq)
        return ChannelProblem(cfg, channel, failure, grid, forces, plan, cost)


def build_channel_rowlane_backup(cfg: PosAttConfig,
                                 problem: ChannelProblem) -> RowLaneBackup:
    """The row/lane backup of one channel under the (v, w, x, t)
    permutation: rows are the action-coupled axes (v' depends on (v, u), w'
    on (w, u)), lanes the drift axes (x' = x + h v, t' = t + h w). The
    factorized cost terms reproduce :func:`build_channel`'s stage cost term
    by term (:784-802)."""
    ax = [torch.as_tensor(a) for a in problem.grid.axes]
    fsq = (problem.forces ** 2).sum(axis=1).astype(np.float32)
    terms = [cfg.Qx * ax[0].reshape(-1, 1, 1, 1, 1) ** 2,
             cfg.Qv * ax[1].reshape(1, -1, 1, 1, 1) ** 2,
             cfg.Qt * ax[2].reshape(1, 1, -1, 1, 1) ** 2,
             cfg.Qw * ax[3].reshape(1, 1, 1, -1, 1) ** 2,
             cfg.R * torch.as_tensor(fsq).reshape(1, 1, 1, 1, -1)]
    return RowLaneBackup(problem.plan, terms, perm=(1, 3, 0, 2), row_axes=2)


def solve_channel(
    cfg: PosAttConfig,
    channel: str,
    *,
    device="cuda",
    failure: bool = False,
    impl: str = "auto",
    max_sweeps: Optional[int] = None,
    tol_mode: str = "abs",
    verbose: bool = False,
) -> tuple[ChannelController, SolveResult]:
    """Early-stopping value iteration for one channel (:268-289) on
    ``device``: :func:`solve`'s batch of one.

    ``impl``: ``'kernel'`` (the rowlane CUDA kernel; CUDA devices only),
    ``'rowlane'`` (its plain PyTorch version, any device), ``'gather'``
    (the gather oracle with the dense stage cost), or ``'auto'``: the kernel
    on a CUDA device, the plain rowlane version otherwise. ``tol_mode``:
    'abs' is the reference stop rule, 'rel' the scale-free variant.
    ``verbose`` prints the reference's per-check 'stage %d ... errorF %f -
    errorU %f' lines (Solver_pos_att.m:272-279).
    """
    name = channel + ("_failure" if failure else "")
    sol = _solve_jobs(cfg, [(name, channel, failure)], device=device,
                      impl=impl, max_sweeps=max_sweeps, tol_mode=tol_mode,
                      verbose=verbose)
    return sol.controllers[name], sol.results[name]


def _solve_jobs(cfg, jobs, *, device, impl, max_sweeps, tol_mode, verbose):
    """The channels ``jobs`` (``(name, channel, failure)``) solved on
    ``device``: with ``impl='gather'`` one after another through the
    converged engine, else as one batch of row/lane backups (the kernel or
    its plain version) through the batched converged engine."""
    with solve_span():
        device = resolve_device(device)
        impl = resolve_impl(impl, device, IMPLS, cpu_auto="rowlane")
        sweeps = (cfg.n_stage - 1) if max_sweeps is None else max_sweeps
        problems = [build_channel(cfg, ch, failure=failure,
                                  with_cost=impl == "gather", device=device)
                    for _, ch, failure in jobs]
        # the timers start after the builds, so the first lines report sweeps
        on_check = [sweep_callback(verbose, kind="check") for _ in jobs]
        if impl == "gather":
            results = [value_iteration_converged(
                p.plan, p.stage_cost, sweeps, check_every=cfg.check_every,
                tol=cfg.tol, tol_mode=tol_mode, on_check=cb)
                for p, cb in zip(problems, on_check)]
        else:
            batch = RowLaneBatch([build_channel_rowlane_backup(cfg, p)
                                  for p in problems], plain=impl == "rowlane")
            results = value_iteration_converged_batch(
                batch, sweeps, check_every=cfg.check_every, tol=cfg.tol,
                tol_mode=tol_mode, on_check=on_check)
        controllers = {
            name: ChannelController(axes=tuple(p.grid.axes), values=r.values,
                                    argmin=r.argmin, forces=p.forces)
            for (name, _, _), p, r in zip(jobs, problems, results)}
        return PosAttSolution(
            cfg, controllers,
            {name: r for (name, _, _), r in zip(jobs, results)})


class PosAttSolution(NamedTuple):
    config: PosAttConfig
    controllers: dict   # channel -> ChannelController (+ "x_failure")
    # channel -> SolveResult of the solve that made it (None when loaded)
    results: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return next(iter(self.controllers.values())).values.device


def solve(
    cfg: PosAttConfig = PosAttConfig(),
    *,
    device="cuda",
    include_failure: bool = True,
    impl: str = "auto",
    save_dir: Optional[str] = None,
    max_sweeps: Optional[int] = None,
    tol_mode: str = "abs",
    verbose: bool = False,
) -> PosAttSolution:
    """Solve all channels (+ x-failure), the reference's ``simplified_run``
    (Solver_pos_att.m:217-240): x, y, z and x_failure in lockstep, one
    batch (``impl`` as in :func:`solve_channel`), each channel's result
    equal to its own :func:`solve_channel`. ``save_dir`` writes each
    controller as ``channel_<name>_controller_1.npz``."""
    jobs = [(ch, ch, False) for ch in CHANNELS]
    if include_failure:
        jobs.append(("x_failure", "x", True))
    sol = _solve_jobs(cfg, jobs, device=device, impl=impl,
                      max_sweeps=max_sweeps, tol_mode=tol_mode,
                      verbose=verbose)
    if save_dir is not None:
        for name, ctrl in sol.controllers.items():
            save_channel_controller(
                os.path.join(save_dir, f"channel_{name}_controller_1.npz"),
                ctrl)
    return sol


def solve_channel_sharded(
    cfg: PosAttConfig,
    channel: str,
    mesh,
    *,
    failure: bool = False,
    max_sweeps: Optional[int] = None,
    axis_name: str = "s",
    engine: str = "halo",
    tol_mode: str = "abs",
) -> tuple[ChannelController, SolveResult]:
    """One channel's early-stopping solve sharded over ``mesh`` (a
    :func:`~ocdp_tpu_torch.parallel.make_mesh` mesh; its device is the
    solve's), the scaling path for :meth:`PosAttConfig.high_res` grids
    (``pos_att.py:524-567`` of the JAX package).

    ``engine='halo'`` keeps the value table sharded on the x axis and
    exchanges the interpolation's boundary rows each sweep
    (:func:`~ocdp_tpu_torch.parallel.halo.value_iteration_converged_halo`
    with the gather backup); ``'replicated'`` gathers the whole table each
    sweep (:func:`~ocdp_tpu_torch.parallel.sharded.
    value_iteration_converged_sharded`). Both run the gather oracle, so
    values and argmin equal ``solve_channel(impl='gather')`` bitwise when
    they stop at the same sweep.
    """
    from ..parallel.halo import value_iteration_converged_halo
    from ..parallel.sharded import value_iteration_converged_sharded

    if engine not in ("halo", "replicated"):
        raise ValueError(f"unknown engine {engine!r}; use 'halo' or "
                         "'replicated'")
    problem = build_channel(cfg, channel, failure=failure,
                            device=mesh.device)
    sweeps = (cfg.n_stage - 1) if max_sweeps is None else max_sweeps
    if engine == "halo":
        result = value_iteration_converged_halo(
            problem.plan, problem.stage_cost, sweeps, mesh,
            check_every=cfg.check_every, tol=cfg.tol, tol_mode=tol_mode,
            axis_name=axis_name)
    else:
        result = value_iteration_converged_sharded(
            problem.plan, problem.stage_cost, sweeps, mesh,
            check_every=cfg.check_every, tol=cfg.tol, tol_mode=tol_mode,
            state_axis_name=axis_name)
    ctrl = ChannelController(axes=tuple(problem.grid.axes),
                             values=result.values, argmin=result.argmin,
                             forces=problem.forces)
    return ctrl, result


def solve_ep(
    cfg: PosAttConfig = PosAttConfig(),
    mesh=None,
    *,
    include_failure: bool = True,
    axis_name: str = "c",
    max_sweeps: Optional[int] = None,
    tol_mode: str = "abs",
    return_results: bool = False,
    device="cuda",
):
    """Every channel solved at once, one channel per rank of ``mesh``'s
    ``axis_name`` axis: channel-level expert parallelism (``pos_att.py:570``
    of the JAX package). ``mesh`` defaults to an in-process mesh of one rank
    per channel on ``device`` (the card unless the caller asks for the
    CPU).

    Each rank builds its own channel's row/lane backup (B.2; no union tap
    rebuild, which exists in the JAX package only to give the stacked
    channels one program) and runs :func:`~ocdp_tpu_torch.engine.
    value_iteration_converged`, the serial solve's engine, so each channel
    stops on its own checks and its values and argmin equal the serial
    :func:`solve_channel` bitwise. The results come to every process.
    Returns :class:`PosAttSolution` (with its ``results``), and with
    ``return_results`` also a per-channel dict of ``num_sweeps``,
    ``converged`` and ``checks``.
    """
    from ..parallel.multihost import make_mesh

    jobs = [(ch, ch, False) for ch in CHANNELS]
    if include_failure:
        jobs.append(("x_failure", "x", True))
    if mesh is None:
        mesh = make_mesh((axis_name,), (len(jobs),), device=device)
    if mesh.shape[axis_name] != len(jobs):
        raise ValueError(f"mesh axis {axis_name!r} has "
                         f"{mesh.shape[axis_name]} ranks but {len(jobs)} "
                         "channels")
    if not mesh.is_member:
        raise ValueError("this process holds no rank of the mesh")
    sweeps = (cfg.n_stage - 1) if max_sweeps is None else max_sweeps
    ax = mesh.axis(axis_name)
    packed = {"values": [], "argmin": [], "checks": [], "stop": []}
    for coord in mesh.local_coords:
        _, ch, failure = jobs[coord[ax]]
        problem = build_channel(cfg, ch, failure=failure, with_cost=False,
                                device=mesh.device)
        res = value_iteration_converged(
            problem.plan, None, sweeps, check_every=cfg.check_every,
            tol=cfg.tol, tol_mode=tol_mode,
            backup=build_channel_rowlane_backup(cfg, problem))
        packed["values"].append(res.values)
        packed["argmin"].append(res.argmin)
        packed["checks"].append(res.checks)
        packed["stop"].append(torch.tensor(
            [res.num_sweeps, int(res.converged)], dtype=torch.int32,
            device=mesh.device))
    line = {k: mesh.all_gather(v, axis_name)[0] for k, v in packed.items()}
    controllers, results, summary = {}, {}, {}
    for i, (name, ch, failure) in enumerate(jobs):
        n_done, conv = (int(x) for x in line["stop"][i].cpu())
        forces = thruster_combinations(*cfg.thruster_value_sets(ch, failure))
        controllers[name] = ChannelController(
            axes=tuple(Grid(_channel_axes(cfg, ch)).axes),
            values=line["values"][i], argmin=line["argmin"][i],
            forces=forces)
        results[name] = SolveResult(
            values=line["values"][i], argmin=line["argmin"][i],
            policies=None, num_sweeps=n_done, converged=bool(conv),
            checks=line["checks"][i])
        summary[name] = {"num_sweeps": n_done, "converged": bool(conv),
                         "checks": line["checks"][i]}
    sol = PosAttSolution(cfg, controllers, results)
    return (sol, summary) if return_results else sol


def default_x0(pitch_deg: float = 3.0) -> np.ndarray:
    """X0 = [dr; dv; q; w] with dr = [-0.1, 0, 0] km and a 3 deg pitch
    (:458-466), float32 numpy. The quaternion is TRUE scalar-last [x y z w];
    for this pitch-only default it coincides with the reference's stored
    order. Build a general initial attitude with ``euler_zyx_to_quat``."""
    q0 = euler_zyx_to_quat(0.0, torch.deg2rad(torch.tensor(pitch_deg)), 0.0)
    return np.concatenate([
        np.array([-0.1, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32),
        q0.numpy().astype(np.float32),
        np.zeros(3, np.float32),
    ])


class _PolicyLookup(NamedTuple):
    """Nearest-neighbor policy lookup state for the 3 channels: one affine
    locate and one 16-byte row gather per channel replace the reference's
    12 'nearest' griddedInterpolant calls per step (Solver_pos_att.m:
    432-447). All channels share a grid shape, so their locates batch."""

    tables: torch.Tensor   # (3, n_cells, 4) per-cell thruster forces
    aff: AffineAxes        # fields with a leading channel dim (3, ...)
    strides: torch.Tensor  # (4,) int64 C-order strides of the state grid


def _build_policy_lookup(ctrls, device) -> _PolicyLookup:
    shape = tuple(ctrls[0].argmin.shape)
    strides = [int(np.prod(shape[k + 1:])) for k in range(len(shape))]
    tables = torch.stack([
        torch.as_tensor(c.forces, dtype=torch.float32, device=device)[
            c.argmin.to(device).reshape(-1).long()] for c in ctrls])
    affs = [affine_axes(c.axes, device=device) for c in ctrls]
    aff = AffineAxes(*(torch.stack(f) for f in zip(*affs)))
    return _PolicyLookup(tables, aff,
                         torch.tensor(strides, dtype=torch.int64,
                                      device=device))


# channel -> attitude index: x couples to pitch (t[1]), y to yaw (t[2]),
# z to roll (t[0]) (Solver_pos_att.m:217-233)
_ATT_IDX = (1, 2, 0)


def _lookup_forces(lk: _PolicyLookup, xb, vb, t_ang, w):
    """(..., 3, 4) per-thruster forces of all channels at 13-states whose
    body-frame position/velocity, small angles and rates are ``xb``, ``vb``,
    ``t_ang``, ``w`` (each ``(..., 3)``)."""
    att = list(_ATT_IDX)
    q = torch.stack([xb, vb, t_ang[..., att], w[..., att]], dim=-1)
    idx = nearest_cell_index(lk.aff, q)                      # (..., 3, 4)
    lin = (idx.long() * lk.strides).sum(dim=-1)              # (..., 3)
    return lk.tables[torch.arange(3, device=lin.device), lin]


def _closed_loop(lookup, y0, R0, V0, inertia, inertia_inv, *, n, h, arm,
                 mass, accel_scale, integrator, ode_tol):
    """The 13-state closed loop of a batch ``y0`` (B, 13) over ``n``
    stages: per stage the policy lookup, the moments and accelerations, and
    one integrator span of the plant (Solver_pos_att.m:452-730). The target
    orbit is propagated once per integrator step for all its stage times
    (``target_states``), elementwise the same as once per stage."""
    adaptive, kw = integrator_kwargs(integrator, ode_tol)
    dev = y0.device
    m_rsw = rsw_to_eci_matrix(R0, V0)
    mass_t = torch.tensor(mass, dtype=torch.float32, device=dev)

    def target(times):
        return target_states(R0, V0, times)

    def rates(a_rsw, U_M):
        def f(tt, yy, rv):
            trans = cw_relative_rates(tt, yy[..., 0:6], a_rsw, R0, V0, rv)
            wb = yy[..., 10:13]
            qdot = quat_kinematics(yy[..., 6:10], wb)
            wdot = matvec(inertia_inv, U_M - cross(wb, matvec(inertia, wb)))
            return torch.cat([trans, qdot, wdot], dim=-1)
        return f

    y = y0
    X, F_th, FM = [y], [], []
    for k in range(n - 1):
        dr, dv, q, w = y[..., 0:3], y[..., 3:6], y[..., 6:10], y[..., 10:13]
        t_ang = small_angles_from_quat(q)
        dcm = quat_to_dcm(q)
        xb = matvec(dcm, matvec(m_rsw, dr))
        vb = matvec(dcm, matvec(m_rsw, dv))
        forces = _lookup_forces(lookup, xb, vb, t_ang, w)     # (B, 3, 4)
        fx, fy, fz = forces.unbind(-2)

        def moment(f4):
            return (f4[..., 0] - f4[..., 1] + f4[..., 2] - f4[..., 3]) * arm

        def total(f4):
            return f4[..., 0] + f4[..., 1] + f4[..., 2] + f4[..., 3]

        # moments (to_Moments_Forces, :804-813): about x, y, z
        U_M = torch.stack([moment(fz), moment(fx), moment(fy)], dim=-1)
        a_body = torch.stack([total(fx), total(fy), total(fz)], dim=-1) \
            / mass_t
        a_rsw = matvec(m_rsw.T, matvec(dcm.transpose(-1, -2), a_body)) \
            * accel_scale
        t0 = torch.tensor(float(k), dtype=torch.float32, device=dev) * h
        y = adaptive(rates(a_rsw, U_M), t0, t0 + h, y, prepare=target,
                     **kw)
        X.append(y)
        F_th.append(torch.cat([fx[..., :2], fy[..., :2], fz[..., :2],
                               fx[..., 2:], fy[..., 2:], fz[..., 2:]], -1))
        FM.append(torch.cat([a_rsw, U_M], dim=-1))
    T = torch.arange(n, dtype=torch.float32, device=dev) * h
    return T, torch.stack(X, 1), torch.stack(F_th, 1), torch.stack(FM, 1)


def _rollout(sol, y0s, t_final, use_x_failure, ode_tol, integrator, device):
    cfg = sol.config
    h = cfg.h
    n = cfg.n_stage if t_final is None else int(np.ceil(t_final / h))
    dev = sol.device if device is None else torch.device(device)
    ctrls = [sol.controllers["x_failure" if ch == "x" and use_x_failure
                             else ch] for ch in CHANNELS]
    R0, V0 = (torch.tensor(a, device=dev) for a in target_orbit_R0V0())

    def mat(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return _closed_loop(
        _build_policy_lookup(ctrls, dev),
        torch.tensor(y0s, dtype=torch.float32, device=dev), R0, V0,
        mat(cfg.inertia_matrix), mat(np.linalg.inv(cfg.inertia_matrix)),
        n=n, h=h, arm=cfg.moment_arm, mass=cfg.mass,
        accel_scale=cfg.accel_scale, integrator=integrator, ode_tol=ode_tol)


def get_optimal_path(
    sol: PosAttSolution,
    x0=None,
    *,
    t_final: Optional[float] = None,
    use_x_failure: bool = False,
    ode_tol: Optional[float] = None,
    integrator: str = "ode45",
    device=None,
):
    """Closed-loop 13-state rollout of one flight (:452-730), on the
    solution's device or on ``device``.

    ``integrator``: 'ode45' (Dormand-Prince, the reference's integrator,
    Solver_pos_att.m:504), 'rkf45' (Curtis/Fehlberg), or 'rk4' (ONE fixed
    4th-order step per 5 ms stage: the serving mode). ``ode_tol=None`` keeps
    each adaptive pair's reference defaults.

    Returns (T, X, F_th, FM): times (N,), states (N, 13), thruster forces
    (N-1, 12), and the force/moment log (N-1, 6) = [a_rsw (3), U_M (3)].
    It is :func:`rollout_batch` of a batch of one, so a fleet member equals
    the same flight alone.
    """
    y0 = default_x0() if x0 is None else np.asarray(x0, np.float32)
    T, X, F_th, FM = _rollout(sol, y0[None], t_final, use_x_failure,
                              ode_tol, integrator, device)
    return T, X[0], F_th[0], FM[0]


def rollout_batch(
    sol: PosAttSolution,
    x0s,
    *,
    t_final: Optional[float] = None,
    use_x_failure: bool = False,
    ode_tol: Optional[float] = None,
    integrator: str = "rk4",
    device=None,
):
    """A fleet of closed-loop rollouts stepped together, the serving shape.

    ``x0s``: (B, 13) initial states; every stage is one batched lookup and
    one batched integrator span, so the per-stage launches amortize across
    the fleet. The adaptive pairs step each member with its own step size
    until every member reaches the stage end.

    Returns (T, X, F_th, FM): T (N,), X (B, N, 13), F_th (B, N-1, 12),
    FM (B, N-1, 6).
    """
    y0s = np.asarray(x0s, np.float32)
    if y0s.ndim != 2 or y0s.shape[-1] != 13:
        raise ValueError(f"x0s must be (B, 13), got {y0s.shape}")
    return _rollout(sol, y0s, t_final, use_x_failure, ode_tol, integrator,
                    device)


def receding_horizon(
    x0,
    cfg: Optional[PosAttConfig] = None,
    *,
    sol: Optional[PosAttSolution] = None,
    t_final: Optional[float] = None,
    impl: str = "auto",
    include_failure: bool = False,
    device=None,
):
    """High-resolution coupled solve + closed-loop rollout from an arbitrary
    x0. ``include_failure`` solves the thruster-0 failure x controller AND
    flies the rollout on it. For this stationary problem the converged
    channel policies ARE the receding-horizon controller: the optimal
    action is re-queried from the current 13-state at every step. Pass
    ``sol`` to reuse solved controllers across initial conditions; without
    it ``device`` is required.

    Returns ``(sol, (T, X, F_th, FM))``.
    """
    if sol is None:
        if device is None:
            raise ValueError("give the device to solve on, or a solution")
        sol = solve(PosAttConfig.high_res() if cfg is None else cfg,
                    device=device, include_failure=include_failure,
                    impl=impl)
    traj = get_optimal_path(sol, np.asarray(x0, np.float32), t_final=t_final,
                            use_x_failure=include_failure, device=device)
    return sol, traj
