"""Kirk ch.3 discrete LQ regulator solved by DP (the golden parity problem).

Counterpart of ``ocdp_tpu/models/kirk.py``: ``test/Dynamic_Solver.m`` with
the state x action grid as a ``(dx, dx, du)`` broadcast, the backup as the
fused interp+cost+argmin sweep, and the stage loop and the rollout as
Python loops on the problem's device.

Reference constants (test/Dynamic_Solver.m:47-64):
  A = [0.9974 0.0539; -0.1078 1.1591], B = [0.0013; 0.0539],
  Q = diag(0.25, 0.05), R = 0.05, N = 200 stages,
  100x100 state grid on [-2.5, 3]^2, 1000 controls on [-40, 10].
The golden run recorded in test/obj_1.txt uses N=130, dx=35, du=100.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..engine import SolveResult, value_iteration_finite
from ..grids import Grid, linspace_axis
from ..ops.fused_backup2d import AffineBackup2D
from ..ops.interp import InterpPlan, PlanShape, build_plan, interp_eval
from ..profiling import solve_span, span, sweep_callback
from ..utils.device import resolve_device

__all__ = ["KirkConfig", "KirkProblem", "KirkSolution", "affine_backup",
           "build", "solve", "optimal_path"]


@dataclasses.dataclass(frozen=True)
class KirkConfig:
    A: tuple = ((0.9974, 0.0539), (-0.1078, 1.1591))
    B: tuple = (0.0013, 0.0539)
    Q: tuple = (0.25, 0.05)   # diagonal of Q (test/Dynamic_Solver.m:49)
    R: float = 0.05
    N: int = 200              # stages
    dx: int = 100             # state grid points per axis
    du: int = 1000            # control grid points
    x_min: float = -2.5
    x_max: float = 3.0
    u_min: float = -40.0
    u_max: float = 10.0

    @staticmethod
    def golden() -> "KirkConfig":
        """The saved golden-run configuration (test/obj_1.txt:1-17)."""
        return KirkConfig(N=130, dx=35, du=100)


class KirkProblem(NamedTuple):
    config: KirkConfig
    grid: Grid
    u_mesh: np.ndarray          # (du,) control values
    # queries shaped (dx, dx, du) and the (dx, dx, du) f32 stage cost; a
    # solution the affine kernel made holds a PlanShape (shapes and device
    # only) and no stage cost: that path builds no plan
    plan: InterpPlan | PlanShape
    stage_cost: torch.Tensor | None


class KirkSolution(NamedTuple):
    problem: KirkProblem
    result: SolveResult

    @property
    def u_star(self) -> torch.Tensor:
        """Per-stage optimal-control tables, reference layout.

        ``u_star[k]`` is the table for forward stage ``k`` (0-based,
        k = 0..N-2), i.e. the reference's ``u_star(:,:,k+1)``
        (test/Dynamic_Solver.m:100: sweep k writes slot N-k).
        """
        policies = self.result.policies
        u = torch.as_tensor(self.problem.u_mesh, dtype=torch.float32,
                            device=policies.device)
        return u[policies.long()].flip(0)


def build(config: KirkConfig = KirkConfig(), *,
          device="cuda") -> KirkProblem:
    """Grid + next-state plan + stage cost, built once on ``device`` (the
    card unless the caller asks for ``"cpu"``; raises without a card).

    Next states mirror ``a_D_M`` (test/Dynamic_Solver.m:184-188):
    ``x' = A x + B u`` broadcast over the (x1, x2, u) grid, in the JAX
    package's eager op order. The stage cost mirrors ``g_D`` (:196-200) and
    is recomposed from :func:`_separable_cost_terms`, so the fused kernel's
    in-kernel state + action re-add is bitwise equal by construction.
    """
    device = resolve_device(device)
    s_r, u_mesh = _meshes(config)
    grid = Grid((s_r, s_r))

    axis = torch.as_tensor(s_r, device=device)
    x1 = axis[:, None, None]
    x2 = axis[None, :, None]
    u = torch.as_tensor(u_mesh, device=device)[None, None, :]
    (a11, a12), (a21, a22) = config.A
    b1, b2 = config.B
    x1n = a11 * x1 + a12 * x2 + b1 * u
    x2n = a21 * x1 + a22 * x2 + b2 * u
    plan = build_plan(grid.axes, (x1n, x2n))
    s_c, a_c = _separable_cost_terms(config, device=device)
    stage_cost = s_c[:, :, None] + a_c[None, None, :]
    return KirkProblem(config, grid, u_mesh, plan, stage_cost)


def _meshes(config: KirkConfig):
    """The state axis (both state dimensions) and the control mesh, f32."""
    return (linspace_axis(config.x_min, config.x_max, config.dx),
            linspace_axis(config.u_min, config.u_max, config.du))


def affine_backup(problem_or_config, device=None) -> AffineBackup2D:
    """Kirk's backup in the fused kernel's affine-query mode
    (:class:`~ocdp_tpu_torch.ops.fused_backup2d.AffineBackup2D`): the
    next states ``x' = A x + B u`` formed in the kernel, no plan, with the
    separable stage cost. Takes a :class:`KirkConfig` (on ``device``, the
    card unless the caller asks for ``"cpu"``; raises without a card) or a
    :class:`KirkProblem` (on its own device). On a CUDA device it launches
    the kernel, on the CPU it runs the plain version; its sweep equals
    :func:`build`'s plan through the gather oracle bitwise on one device.
    """
    if isinstance(problem_or_config, KirkProblem):
        config = problem_or_config.config
        axes = problem_or_config.grid.axes
        u_mesh = problem_or_config.u_mesh
        device = problem_or_config.plan.device if device is None else device
    else:
        config = problem_or_config
        s_r, u_mesh = _meshes(config)
        axes = (s_r, s_r)
    device = resolve_device("cuda" if device is None else device)
    s_c, a_c = _separable_cost_terms(config, device=device)
    return AffineBackup2D(axes, u_mesh, config.A, config.B, s_c, a_c)


def _separable_cost_terms(config: KirkConfig, *, device):
    """(state, action) split of the stage cost — the single source of the
    cost expressions; :func:`build` recomposes ``stage_cost`` from it
    (g_D associates as (Q1 x1^2 + Q2 x2^2) + R u^2,
    test/Dynamic_Solver.m:196-200)."""
    s_r, u = (torch.as_tensor(m, device=device) for m in _meshes(config))
    x1 = s_r[:, None]
    x2 = s_r[None, :]
    q1, q2 = config.Q
    return (q1 * x1**2 + q2 * x2**2).to(torch.float32), \
        (config.R * u**2).to(torch.float32)


def solve(
    config: KirkConfig = KirkConfig(),
    *,
    device="cuda",
    impl: str = "auto",
    store_policies: bool = True,
    verbose: bool = False,
) -> KirkSolution:
    """Run the N-1 backward sweeps (test/Dynamic_Solver.m:86-102) on
    ``device``: the card unless the caller asks for ``"cpu"``; raises
    without a card.

    ``impl``: ``"kernel"`` (the fused CUDA backup in its affine-query
    mode, :func:`affine_backup`: no plan is built, so the solution's
    ``problem.plan`` is a :class:`~ocdp_tpu_torch.ops.interp.PlanShape` and
    its ``stage_cost`` None; CUDA devices only), ``"gather"`` (the plain
    gather oracle, any device), or ``"auto"``: the kernel on a CUDA device,
    the gather oracle otherwise. The two agree bitwise on a CUDA device.
    The kernel writes each sweep's argmin straight into its policy slot.
    The set-up before the sweeps (meshes, cost, plan or kernel arguments)
    runs in an ``ocdp.build`` span.

    ``verbose``: per-stage 'step %d - %f seconds' prints (the reference's
    default console output) via :class:`~ocdp_tpu_torch.profiling.SweepTimer`.
    """
    with solve_span():
        device = resolve_device(device)
        if impl == "auto":
            impl = "kernel" if device.type == "cuda" else "gather"
        if impl not in ("kernel", "gather"):
            raise ValueError(f"unknown impl {impl!r}; use 'auto', 'kernel' or "
                             "'gather'")
        if impl == "kernel" and device.type != "cuda":
            raise ValueError(
                f"impl='kernel' needs a CUDA device, got {device}")
        with span("ocdp.build"):
            if impl == "kernel":
                s_r, u_mesh = _meshes(config)
                shape = PlanShape((config.dx, config.dx),
                                  (config.dx, config.dx, config.du), device)
                problem = KirkProblem(config, Grid((s_r, s_r)), u_mesh,
                                      shape, None)
                backup = affine_backup(problem)
            else:
                problem = build(config, device=device)
                backup = None
        result = value_iteration_finite(
            problem.plan, problem.stage_cost, config.N - 1,
            store_policies=store_policies, backup=backup,
            on_sweep=sweep_callback(verbose))
        return KirkSolution(problem, result)


def optimal_path(
    sol: KirkSolution,
    x0=(2.0, 1.0),
    *,
    mode: str = "Nssu",
    ssu_num: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward rollout (test/Dynamic_Solver.m:108-181) on the solution's device.

    Per stage: linear-interpolate the stage's u* table at the current state,
    then take the exact LTI step ``x' = A x + B u``. ``mode='ssu'`` replays
    the fixed stage-``ssu_num`` policy table at every step (the reference's
    steady-state-u experiment, :127-131).

    Returns (X, U): X is (N, 2) states, U is (N-1,) controls.
    """
    if mode not in ("Nssu", "ssu"):
        raise ValueError(f"unknown mode {mode!r}; use 'Nssu' or 'ssu'")
    cfg = sol.problem.config
    axes = sol.problem.grid.axes
    u_star = sol.u_star                                 # (N-1, dx, dx)
    device = u_star.device
    A = torch.tensor(cfg.A, dtype=torch.float32, device=device)
    B = torch.tensor(cfg.B, dtype=torch.float32, device=device)
    tables = u_star[ssu_num].expand_as(u_star) if mode == "ssu" else u_star

    x = torch.tensor(x0, dtype=torch.float32, device=device)
    X, U = [], []
    for table in tables:
        u = interp_eval(table, axes, (x[0], x[1]))
        X.append(x)
        U.append(u)
        x = A @ x + B * u
    X.append(x)
    return torch.stack(X), torch.stack(U)
