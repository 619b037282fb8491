"""Translational position control: 3 decoupled double-integrator channels.

Counterpart of ``ocdp_tpu/models/position.py`` (position-control/
Solver_position.m). Each body axis is an independent (x, v) problem with
on/off/reverse thrust; the reference solves the three channels one after
another (:109-141). Here they are one leading channel axis of the state
grid whose queries never move, and each sweep runs the three channels as a
batch of 2-D problems through
:class:`~ocdp_tpu_torch.ops.band_backup2d.BandBackup2D`, a CUDA kernel on
the card.

Reference semantics kept:

* ``sym_linspace`` grids with an exact 0 point, 200 -> 201 points
  (Solver_position.m:363-371);
* per-step next states (:152-187): v' = v + h*u/M exactly; x' = x + h*v*c_h
  with c_h = 1 + h/2 + h^2/6 + h^3/24, the reference's RK4_x quirk, when
  ``rk4_x_parity=True`` (default), x' = x + h*v otherwise;
* stage cost Qx*x^2 + Qv*v^2 + R*u^2 (:113-121);
* 6000-stage value iteration (5999 sweeps), the final argmin wrapped as a
  'nearest' policy (:131-146);
* the closed-loop rollout against relative orbital motion about an
  eccentric target (:189-311) with RKF45 between stages; the policy's
  thrust force (N) is added to the km-based CW accelerations unscaled, the
  reference's unit quirk, behind ``accel_scale`` (1.0).

The build and the solve run on the card unless the caller asks for
``device="cpu"``; without a card they raise. The rollout runs on the
solution's device, or on the device a caller names.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..dynamics.orbital import target_orbit_R0V0
from ..dynamics.relmotion import cw_relative_rates, target_states
from ..engine import SolveResult, value_iteration_finite
from ..grids import Grid, sym_linspace_inclusive
from ..ops.band_backup2d import BandBackup2D
from ..ops.interp import InterpPlan, affine_axes, build_plan, nearest_cell_index
from ..profiling import solve_span, sweep_callback
from ..utils.device import resolve_device, resolve_impl
from ..utils.integrators import rkf45_integrate

__all__ = ["PositionConfig", "PositionProblem", "PositionSolution", "build",
           "solve", "get_optimal_path"]

IMPLS = ("auto", "kernel", "plain", "gather")


@dataclasses.dataclass(frozen=True)
class PositionConfig:
    # grid (Solver_position.m:49-56)
    x_min: float = -0.5
    x_max: float = 0.5
    v_min: float = -0.5
    v_max: float = 0.5
    n_mesh_x: int = 200
    n_mesh_v: int = 200
    # plant (:58, :84)
    mass: float = 4.16
    thrust: float = 0.26
    # cost, per channel (:61-69)
    Qx: tuple = (6.0, 6.0, 6.0)
    Qv: tuple = (6.0, 6.0, 6.0)
    R: tuple = (0.1, 0.1, 0.1)
    # horizon (:71-72)
    T_final: float = 30.0
    h: float = 0.005
    # parity knobs (module docstring)
    rk4_x_parity: bool = True
    accel_scale: float = 1.0

    def __post_init__(self):
        # the reference warns (and takes the ceiling) when T_final/h is not
        # an integer stage count (Solver_position.m:77-81)
        if self.h <= 0:   # degenerate (frozen-dynamics test configs)
            return
        n = self.T_final / self.h
        if abs(n - round(n)) > 1e-9:
            warnings.warn(
                f"T_final/h = {n!r} is not an integer; using "
                f"ceil = {self.n_stage} stages", stacklevel=3)

    @property
    def n_stage(self) -> int:
        return int(np.ceil(self.T_final / self.h))

    @property
    def u_vector(self) -> np.ndarray:
        return np.array([-self.thrust, 0.0, self.thrust], np.float32)

    @property
    def n_channels(self) -> int:
        return len(self.Qx)


class PositionProblem(NamedTuple):
    config: PositionConfig
    grid: Grid                  # (channel, x, v) axes
    plan: InterpPlan            # queries (C, nx, nv, nu)
    stage_cost: torch.Tensor    # (C, nx, nv, nu)
    # (Qx x^2, Qv v^2, R u^2), each (C, ., ., .), whose sum in that order
    # is stage_cost: the banded backup's factorized cost
    cost_terms: tuple = ()


class PositionSolution(NamedTuple):
    problem: PositionProblem
    result: SolveResult

    @property
    def u_tables(self) -> torch.Tensor:
        """(C, nx, nv) optimal thrust force per channel (the steady-state
        policy), on the solution's device."""
        argmin = self.result.argmin
        u = torch.as_tensor(self.problem.config.u_vector, device=argmin.device)
        return u[argmin.long()]

    @property
    def device(self) -> torch.device:
        return self.result.values.device


def _x_step_coeff(h: float, parity: bool) -> float:
    if not parity:
        return 1.0
    return 1.0 + h / 2 + h**2 / 6 + h**3 / 24


def build(config: PositionConfig = PositionConfig(), *,
          device="cuda") -> PositionProblem:
    """Grids, next states (a plan over (channel, x, v) whose channel
    queries never move), the stage cost's terms and their dense sum, on
    ``device``. The next
    states keep the JAX package's operation order and float32 rounding;
    the thrust divides by a float32 tensor (PyTorch on a CUDA device would
    multiply by the reciprocal of a Python-scalar divisor)."""
    cfg = config
    device = resolve_device(device)
    s_x = sym_linspace_inclusive(cfg.x_min, cfg.x_max, cfg.n_mesh_x)
    s_v = sym_linspace_inclusive(cfg.v_min, cfg.v_max, cfg.n_mesh_v)
    chan = np.arange(cfg.n_channels, dtype=np.float32)
    grid = Grid((chan, s_x, s_v))

    def col(a, k):
        shape = [1] * 4
        shape[k] = -1
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=device).reshape(shape)

    c, x, v, u = (col(a, k) for k, a in
                  enumerate((chan, s_x, s_v, cfg.u_vector)))
    mass = torch.tensor(cfg.mass, dtype=torch.float32, device=device)
    x_next = x + cfg.h * v * _x_step_coeff(cfg.h, cfg.rk4_x_parity)
    v_next = v + cfg.h * u / mass
    plan = build_plan(grid.axes, (c, x_next, v_next))
    terms = (col(cfg.Qx, 0) * x**2, col(cfg.Qv, 0) * v**2,
             col(cfg.R, 0) * u**2)
    stage_cost = terms[0] + terms[1] + terms[2]
    return PositionProblem(cfg, grid, plan, stage_cost, terms)


def solve(
    config: PositionConfig = PositionConfig(),
    *,
    num_sweeps: Optional[int] = None,
    impl: str = "auto",
    verbose: bool = False,
    device="cuda",
) -> PositionSolution:
    """All channels' value iteration in one sweep loop (:131-141), on
    ``device``: the card unless the caller asks for ``"cpu"``; raises
    without a card. ``num_sweeps`` defaults to ``n_stage - 1``.

    ``impl``: ``'auto'`` (the banded backup with the channels as its batch
    and the factorized cost: the CUDA kernel on a CUDA device, its sweeps
    replayed as CUDA graphs, its plain version on the CPU),
    ``'kernel'`` (CUDA devices only), ``'plain'`` (any device) or
    ``'gather'`` (the gather oracle on the 3-D plan). The JAX package's XLA
    stencil is not ported. ``verbose`` prints the reference's per-stage
    timing lines.
    """
    with solve_span():
        device = resolve_device(device)
        impl = resolve_impl(impl, device, IMPLS, cpu_auto="plain")
        problem = build(config, device=device)
        sweeps = (config.n_stage - 1) if num_sweeps is None else num_sweeps
        backup = None
        if impl != "gather":
            bk = BandBackup2D(problem.plan, problem.cost_terms)
            backup = bk if impl == "kernel" else bk.plain
        result = value_iteration_finite(problem.plan, problem.stage_cost,
                                        sweeps, backup=backup,
                                        on_sweep=sweep_callback(verbose))
        return PositionSolution(problem, result)


def get_optimal_path(
    sol: PositionSolution,
    y0=(-1.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    *,
    t_final: Optional[float] = None,
    ode_tol: float = 1e-8,
    device=None,
):
    """Closed-loop rollout against the eccentric-target relative-motion
    plant (Solver_position.m:210-225), on the solution's device or on
    ``device``: per stage a 'nearest' policy lookup per channel (lower snap
    at midpoints), then RKF45 integration of the CW equations with the
    target propagated by universal-variable Kepler.

    The target orbit is propagated once per RKF45 step for all six stage
    times (``target_states``), elementwise the same as once per stage.

    Returns (T, X, U): times (N,), states (N, 6), controls (N-1, 3).
    """
    cfg = sol.problem.config
    dev = sol.device if device is None else torch.device(device)
    axes = tuple(np.asarray(a) for a in sol.problem.grid.axes[1:])  # (x, v)
    h = cfg.h
    n = cfg.n_stage if t_final is None else int(np.ceil(t_final / h))
    R0, V0 = (torch.tensor(a, device=dev) for a in target_orbit_R0V0())
    n_c = cfg.n_channels
    tables = sol.u_tables.to(dev).reshape(n_c, -1)
    aff = affine_axes(axes, device=dev)
    n_v = len(axes[1])
    ch = torch.arange(n_c, device=dev)

    def policy(y):
        q = torch.stack([y[0, 0:n_c], y[0, 3:3 + n_c]], dim=-1)
        idx = nearest_cell_index(aff, q).long()               # (C, 2)
        return tables[ch, idx[:, 0] * n_v + idx[:, 1]] * cfg.accel_scale

    def target(times):
        return target_states(R0, V0, times)

    y = torch.as_tensor(np.asarray(y0, np.float32), device=dev)[None]
    X, U = [y[0]], []
    for k in range(n - 1):
        accel = policy(y)
        t = torch.tensor(float(k), dtype=torch.float32, device=dev) * h

        def f(tt, yy, rv, accel=accel):
            return cw_relative_rates(tt, yy, accel, R0, V0, rv)

        y = rkf45_integrate(f, t, t + h, y, tol=ode_tol, prepare=target)
        X.append(y[0])
        U.append(accel)
    T = torch.arange(n, dtype=torch.float32, device=dev) * h
    return T, torch.stack(X), torch.stack(U)
