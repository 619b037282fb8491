"""Rigid-body attitude control: the per-axis simplified solve, the full
coupled 6-D solve, their rollouts and the PD baseline.

Counterpart of ``ocdp_tpu/models/attitude.py``.

The simplified solve (Solver_attitude.m:196-259) is 3 independent
(omega_i, theta_i) 2-D problems with diagonal-inertia torque dynamics, which
the reference solves one after another. The reference's RK4_t feeds omega
back through the theta derivative, giving theta' = theta + h*omega*(1 + h/2
+ h^2/6 + h^3/24) (``rk4_t_parity``). The three axes run as one batch
through :class:`~ocdp_tpu_torch.ops.band_backup2d.BandBackup2D`, one CUDA
kernel launch a sweep on the card. Its rollouts fly the three per-axis
torque tables on the simplified plant, on the full nonlinear rigid body,
and the quaternion PD baseline (:835-925, :508-591).

The full 6-D part (attitude-control/Solver_attitude.m:261-506, 744-833):
the state grid is (omega1, omega2, omega3, yaw, pitch, roll) with the 27
torque combinations u in {-u_max, 0, u_max}^3 as one flat C-order action
axis (u1 slowest), so
one flat first-minimum argmin is the reference's chained 3-axis argmin
(:400-409). Dynamics per sweep: an Euler step of omega with the gyroscopic
cross terms, an Euler step of the quaternion built from the Euler
half-angles, renormalization, and the readback to Euler angles (:413-506).

Quaternions are in the reference's "Kirk" component order [x4 x5 x6 x7]
(Solver_attitude.m:322-340): kirk q1 = z, q2 = y, q3 = x, q4 = w of the
scalar-last [x, y, z, w], so the Euler readback is ``quat_to_euler_zyx``
under that permutation.

The omega next states depend on (omega, u) and the Euler next states on
(omega, Euler) only, so the plan splits into rows (the omega cells) and
lanes (the Euler cells), and the stage cost into row, lane and action
parts: :class:`~ocdp_tpu_torch.ops.backup6d.Backup6D` runs the sweep, as a
CUDA kernel on the card. The grid sizes are configuration; the reference's
historical run is ``AttitudeConfig(n_mesh_w=11, n_mesh_q=10)``, 11^3 x 10^3
cells over a 5999-sweep horizon. The builds and solves run on the card
unless the caller asks for ``device="cpu"``; without a card they raise.
The rollout runs on the solution's device.

Past ``FLAT_MIN_CELLS`` cells the solve takes the envelope path
(``ocdp_tpu/models/attitude.py:379-419, 840-895``): a flat ``(rows, lanes)``
plan, the engines' carry mode and a uint8 argmin, with flat ``(NW, NE)``
result tables; past ``RECOMPUTE_MIN_CELLS`` the Euler lanes are recomputed
inside the kernel (B.5) instead of stored (24 B/cell), and a flat stored
plan past ``CHUNKED_MIN_CELLS`` is built in row blocks. The rules read the
cell count only; ``flat``, ``lane_mode``, ``chunked`` and ``carry_padded``
force each mode at any size.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine import (SolveResult, value_iteration_finite,
                      value_iteration_segmented)
from ..grids import Grid, linspace_axis
from ..ops.backup6d import (Backup6D, LaneRecompute, RecomputePlan,
                            plan_is_flat)
from ..ops.band_backup2d import BandBackup2D
from ..ops.interp import (AffineAxes, InterpPlan, PlanShape, affine_axes,
                          axis_locate, build_plan, interp_apply,
                          nearest_cell_index)
from ..ops.kernelmath import quat_step_readback
from ..ops.rowband import RowBandBackup2D
from ..ops.rowlane import RowLaneBackup
from ..profiling import SweepTimer, solve_span, span, sweep_callback
from ..utils.device import resolve_device, resolve_impl
from ..utils.frames import cross, matvec
from ..utils.integrators import integrator_kwargs, rk4_step
from ..utils.quaternions import kirk_quat_from_euler, quat_to_euler_zyx

__all__ = [
    "AttitudeConfig",
    "SimplifiedSolution",
    "build_simplified_axis",
    "solve_simplified",
    "rollout_simplified_plant",
    "rollout_simplified_real_dynamics",
    "linear_control_response",
    "FullSolution",
    "decode_torque_digits",
    "build_full",
    "plan_is_flat",
    "solve_full",
    "attitude_rates_kirk",
    "euler_from_kirk_quat",
    "rollout_full",
]

IMPLS = ("auto", "kernel", "plain", "gather")
SIMPLIFIED_IMPLS = ("auto", "kernel", "plain", "rowband", "rowlane", "gather")
LANE_MODES = ("auto", "plan", "recompute")
_DEG = np.pi / 180.0

# the envelope path's auto rules, by cell count (ocdp_tpu/models/
# attitude.py:379-400, 867-884): past FLAT_MIN_CELLS a flat plan, the
# engines' carry mode and a uint8 argmin; past RECOMPUTE_MIN_CELLS the
# Euler lanes recomputed in the kernel; a flat stored plan past
# CHUNKED_MIN_CELLS built in row blocks
FLAT_MIN_CELLS = 8_000_000
RECOMPUTE_MIN_CELLS = 60_000_000
CHUNKED_MIN_CELLS = 60_000_000


@dataclasses.dataclass(frozen=True)
class AttitudeConfig:
    # omega grid (Solver_attitude.m:106-108)
    w_min_deg: float = -50.0
    w_max_deg: float = 50.0
    n_mesh_w: int = 1000
    # Euler-angle grids (:109-116)
    yaw_range_deg: tuple = (-30.0, 30.0)
    pitch_range_deg: tuple = (-20.0, 20.0)
    roll_range_deg: tuple = (-35.0, 35.0)
    n_mesh_q: int = 10     # per Euler axis, full solver
    n_mesh_t: int = 300    # per theta axis, simplified solver
    # inertia (:118-126), the same SPHERES satellite as pos-att
    inertia_diag: tuple = (0.02836 + 0.00016, 0.026817 + 0.00150,
                           0.023 + 0.00150)
    inertia_offdiag: tuple = (-0.0000837, 0.000014, -0.00029)
    # cost (:128-141)
    Qw: tuple = (6.0, 6.0, 6.0)
    Qq: tuple = (6.0, 6.0, 6.0)
    R: tuple = (4.0, 4.0, 4.0)
    # horizon (:143-144)
    T_final: float = 30.0
    h: float = 0.005
    # torques (:174)
    u_max: float = 0.11
    # simplified solver's RK4_t parity knob
    rk4_t_parity: bool = True

    def __post_init__(self):
        # the reference warns (and takes the ceiling) when T_final/h is not
        # an integer stage count (Solver_attitude.m:151-155)
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
        return np.array([-self.u_max, 0.0, self.u_max], np.float32)

    @property
    def inertia_matrix(self) -> np.ndarray:
        d, o = self.inertia_diag, self.inertia_offdiag
        return np.array([[d[0], o[0], o[1]],
                         [o[0], d[1], o[2]],
                         [o[1], o[2], d[2]]])

    @property
    def euler_ranges(self):
        return (tuple(np.asarray(self.yaw_range_deg) * _DEG),
                tuple(np.asarray(self.pitch_range_deg) * _DEG),
                tuple(np.asarray(self.roll_range_deg) * _DEG))

    @staticmethod
    def default_x0() -> np.ndarray:
        """[w; kirk-q] with q = angle2quat(5, 10, -9 deg) (:160-163),
        float32 numpy."""
        kirk = kirk_quat_from_euler(
            *(torch.tensor(a * _DEG, dtype=torch.float32)
              for a in (5.0, 10.0, -9.0)))
        return np.concatenate([np.zeros(3, np.float32),
                               kirk.numpy()]).astype(np.float32)


def decode_torque_digits(a, u_vec):
    """Flat 27-action argmin -> (u1, u2, u3) per-axis torques: the 3-digit
    C-order decode behind the reference's nested-index composition
    U3(U2(U1)), U2(U1) (Solver_attitude.m:290-292). numpy in, numpy out;
    tensors in, tensors out."""
    nu = len(u_vec)
    i1, rem = a // (nu * nu), a % (nu * nu)
    return u_vec[i1], u_vec[rem // nu], u_vec[rem % nu]


# ---------------------------------------------------------------- simplified

def _quirk(h: float, on: bool) -> float:
    return (1.0 + h / 2 + h * h / 6 + h**3 / 24) if on else 1.0


class SimplifiedSolution(NamedTuple):
    config: AttitudeConfig
    axes: tuple       # per axis: (s_w, s_t), host numpy
    u_tables: tuple   # per axis: (n_mesh_w, n_mesh_t) torque table
    values: tuple
    # the out-of-grid value policy the solve used: the default 'clamp'
    # deviates from reference parity (MATLAB extrapolates) at edge cells,
    # so parity comparisons read this field
    edge: str = "clamp"

    @property
    def device(self) -> torch.device:
        return self.values[0].device


def build_simplified_axis(cfg: AttitudeConfig, axis: int, *,
                          edge: str = "clamp", device="cuda"):
    """Grid, Euler-step plan and stage-cost terms of simplified axis
    ``axis`` (:231-242), on ``device``. Returns ``(grid, plan, terms)``:
    the plan's queries are ``(n_w, 1, 3)`` on the omega axis (RK4_w: the
    k's are equal, :631-645) and ``(n_w, n_t, 1)`` on the theta axis (the
    RK4_t quirk, :647-661); the terms are ``Qw w^2``, ``Qq t^2`` and
    ``R u^2``, whose sum in that order is the stage cost.

    The next states keep the JAX package's operation order and float32
    rounding; the torque divides by a float32 tensor (PyTorch on a CUDA
    device would multiply by the reciprocal of a Python-scalar divisor).
    """
    device = resolve_device(device)
    t_lo, t_hi = cfg.euler_ranges[axis]
    s_w = linspace_axis(cfg.w_min_deg * _DEG, cfg.w_max_deg * _DEG,
                        cfg.n_mesh_w)
    s_t = linspace_axis(t_lo, t_hi, cfg.n_mesh_t)
    grid = Grid((s_w, s_t))
    w = torch.as_tensor(s_w, device=device).reshape(-1, 1, 1)
    t = torch.as_tensor(s_t, device=device).reshape(1, -1, 1)
    u = torch.as_tensor(cfg.u_vector, device=device).reshape(1, 1, -1)
    J = torch.tensor(cfg.inertia_diag[axis], dtype=torch.float32,
                     device=device)
    w_next = w + cfg.h * u / J
    t_next = t + cfg.h * w * _quirk(cfg.h, cfg.rk4_t_parity)
    plan = build_plan(grid.axes, (w_next, t_next), edge=edge)
    terms = (cfg.Qw[axis] * w**2, cfg.Qq[axis] * t**2, cfg.R[axis] * u**2)
    return grid, plan, terms


def solve_simplified(
    cfg: AttitudeConfig = AttitudeConfig(),
    *,
    num_sweeps: Optional[int] = None,
    impl: str = "auto",
    edge: str = "clamp",
    verbose: bool = False,
    device="cuda",
) -> SimplifiedSolution:
    """3 decoupled (omega, theta) solves (:196-259) on ``device``: the card
    unless the caller asks for ``"cpu"``; raises without a card.
    ``num_sweeps`` defaults to ``n_stage - 1``.

    ``impl``: ``'auto'`` (the banded 2-D backup of
    :class:`~ocdp_tpu_torch.ops.band_backup2d.BandBackup2D` over the three
    axes as one batch: its CUDA kernel on a CUDA device, one launch a
    sweep, the sweeps replayed as CUDA graphs; its plain version on the
    CPU), ``'kernel'`` (the same, CUDA devices only), ``'plain'`` (the
    plain version of the same batch, any device), ``'rowband'`` (the
    row-band backup, the JAX package's auto path), ``'rowlane'`` (the
    row/lane backup: kernel B.2 on a CUDA device, its plain version on the
    CPU) or ``'gather'`` (the gather oracle with the dense cost); the last
    three solve the axes one after another. Each axis's result is its own
    solve's, bitwise. The JAX package's XLA stencil is not ported.

    ``edge='clamp'`` (default) projects out-of-grid next states onto the
    grid boundary, which keeps value iteration stable; ``'extrapolate'`` is
    strict reference parity, whose edge cells diverge over the full
    5999-sweep horizon (the reference's own behaviour; see the JAX
    package's docstring). ``verbose`` prints the reference's per-stage
    timing lines.
    """
    with solve_span():
        device = resolve_device(device)
        impl = resolve_impl(impl, device, SIMPLIFIED_IMPLS, cpu_auto="plain")
        sweeps = (cfg.n_stage - 1) if num_sweeps is None else num_sweeps
        on_sweep = sweep_callback(verbose)
        u_vec = torch.as_tensor(cfg.u_vector, device=device)
        built = [build_simplified_axis(cfg, i, edge=edge, device=device)
                 for i in range(3)]
        axes_out = [grid.axes for grid, _, _ in built]
        if impl in ("kernel", "plain"):
            bk = BandBackup2D.stack([p for _, p, _ in built],
                                    [t for _, _, t in built])
            n1, n2 = built[0][1].grid_shape
            shape = PlanShape((3, n1, n2), (3, n1, n2, len(cfg.u_vector)),
                              device)
            res = value_iteration_finite(
                shape, None, sweeps,
                backup=bk if impl == "kernel" else bk.plain,
                on_sweep=on_sweep)
            tables = [u_vec[res.argmin[i].long()] for i in range(3)]
            values = [res.values[i] for i in range(3)]
            return SimplifiedSolution(cfg, tuple(axes_out), tuple(tables),
                                      tuple(values), edge)
        tables, values = [], []
        for _, plan, terms in built:
            cost = backup = None
            if impl == "rowband":
                backup = RowBandBackup2D(plan, terms)
            elif impl == "rowlane":
                # (omega, theta) is row/lane separable as it stands: omega'
                # depends on (omega, u), theta' on (theta, omega)
                backup = RowLaneBackup(plan, terms, perm=(0, 1), row_axes=1)
            else:
                cost = terms[0] + terms[1] + terms[2]
            res = value_iteration_finite(plan, cost, sweeps, backup=backup,
                                         on_sweep=on_sweep)
            tables.append(u_vec[res.argmin.long()])
            values.append(res.values)
        return SimplifiedSolution(cfg, tuple(axes_out), tuple(tables),
                                  tuple(values), edge)


def _simplified_lookup(sol: SimplifiedSolution, device):
    """``(omega (3,), theta (3,)) -> torques (3,)``: the three axes' nearest
    policy lookups (MATLAB 'nearest', lower snap at midpoints) as one affine
    locate and one gather."""
    tables = torch.stack([t.to(device).reshape(-1) for t in sol.u_tables])
    affs = [affine_axes(ax, device=device) for ax in sol.axes]
    aff = AffineAxes(*(torch.stack(f) for f in zip(*affs)))
    n_t = len(sol.axes[0][1])
    ch = torch.arange(3, device=device)

    def lookup(w, t):
        idx = nearest_cell_index(aff, torch.stack([w, t], dim=-1)).long()
        return tables[ch, idx[:, 0] * n_t + idx[:, 1]]

    return lookup


def _default_axis_x0() -> torch.Tensor:
    """(3, 2) per-axis (omega, theta) start: zero rates and the angles of
    the standard X0, theta_i = 2 asin(kirk q_i)."""
    q = torch.as_tensor(AttitudeConfig.default_x0()[3:7])
    theta = 2.0 * torch.arcsin(torch.clamp(q[:3], -1.0, 1.0))
    return torch.stack([torch.zeros(3), theta], dim=1)


def rollout_simplified_plant(sol: SimplifiedSolution, x0=None, *,
                             num_stages: Optional[int] = None, device=None):
    """Policy on the SIMPLIFIED plant: 3 decoupled (omega_i, theta_i)
    double integrators stepped with the training dynamics, the first half
    of the reference's train-on-simplified / validate-on-real check
    (attitude-control/test/test_simplified.m:121-264), on the solution's
    device or on ``device``.

    ``x0``: (3, 2) per-axis (omega, theta) initial states (default: zero
    rates and the angles of the standard X0). Returns (X, U) with X
    (N, 3, 2) and U (N-1, 3).
    """
    cfg = sol.config
    n = num_stages or cfg.n_stage
    dev = sol.device if device is None else torch.device(device)
    c_h = _quirk(cfg.h, cfg.rk4_t_parity)
    lookup = _simplified_lookup(sol, dev)
    J = torch.tensor(cfg.inertia_diag, dtype=torch.float32, device=dev)
    X = (_default_axis_x0() if x0 is None
         else torch.as_tensor(np.asarray(x0, np.float32))).to(dev)
    Xs, Us = [X], []
    for _ in range(n - 1):
        U = lookup(X[:, 0], X[:, 1])
        w_next = X[:, 0] + cfg.h * U / J
        t_next = X[:, 1] + cfg.h * X[:, 0] * c_h
        X = torch.stack([w_next, t_next], dim=1)
        Xs.append(X)
        Us.append(U)
    return torch.stack(Xs), torch.stack(Us)


def rollout_simplified_real_dynamics(
    sol: SimplifiedSolution,
    x0=None,
    *,
    num_stages: Optional[int] = None,
    ode_tol: Optional[float] = None,
    integrator: str = "ode45",
    device=None,
):
    """Train on simplified, validate on real (:835-925), on the solution's
    device or on ``device``: per-axis policies looked up at (omega_i,
    2 asin(kirk q_i)); the plant is the full nonlinear rigid body with the
    complete inertia matrix, integrated per stage with ``integrator``:
    'ode45' (default; the reference uses MATLAB ode45 here,
    Solver_attitude.m:851,885), 'rkf45' (Fehlberg) or 'rk4' (one fixed step
    per stage, the serving mode). ``ode_tol=None`` keeps each pair's
    reference defaults; a value sets rkf45's tol, or ode45's RelTol with
    AbsTol at MATLAB's 1e-3 ratio.

    Returns (X, U): states (N, 7), torques (N-1, 3).
    """
    cfg = sol.config
    n = num_stages or cfg.n_stage
    dev = sol.device if device is None else torch.device(device)
    adaptive, kw = integrator_kwargs(integrator, ode_tol)
    lookup = _simplified_lookup(sol, dev)

    def mat(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    inertia = mat(cfg.inertia_matrix)
    inertia_inv = mat(np.linalg.inv(cfg.inertia_matrix))
    X = torch.as_tensor(AttitudeConfig.default_x0() if x0 is None
                        else np.asarray(x0, np.float32), device=dev)[None]
    Xs, Us = [X[0]], []
    for k in range(n - 1):
        theta = 2.0 * torch.arcsin(torch.clamp(X[0, 3:6], -1.0, 1.0))
        U = lookup(X[0, 0:3], theta)

        def f(_t, y, U=U):
            return attitude_rates_kirk(y, U, inertia, inertia_inv)

        t0 = torch.tensor(float(k), dtype=torch.float32, device=dev) * cfg.h
        X = _renorm_q(adaptive(f, t0, t0 + cfg.h, X, **kw))
        Xs.append(X[0])
        Us.append(U)
    return torch.stack(Xs), torch.stack(Us)


def linear_control_response(
    cfg: AttitudeConfig = AttitudeConfig(),
    x0=None,
    *,
    T_final: Optional[float] = None,
    dt: Optional[float] = None,
    K: float = 0.2,
    C: float = 1.0,
    device="cuda",
):
    """Quaternion PD baseline (:508-591) on ``device``: U = -K q_vec - C w,
    RK4 steps of the diagonal-inertia 7-state dynamics with quaternion
    renormalization.

    Returns (X, U, drift): states (n+1, 7), torques (n, 3) and
    |(|q| at T_final) - 1|, the reference's integration-error metric
    (:543-548).
    """
    device = resolve_device(device)
    h = dt or cfg.h
    n = int(np.ceil((T_final or cfg.T_final) / h))

    def mat(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    inertia_d = mat(np.diag(cfg.inertia_diag))
    inertia_d_inv = mat(np.diag(1.0 / np.asarray(cfg.inertia_diag)))
    X = torch.as_tensor(AttitudeConfig.default_x0() if x0 is None
                        else np.asarray(x0, np.float32), device=device)
    Xs, Us = [X], []
    for _ in range(n):
        U = -K * X[3:6] - C * X[0:3]

        def f(_t, y, U=U):
            return attitude_rates_kirk(y, U, inertia_d, inertia_d_inv)

        X = _renorm_q(rk4_step(f, 0.0, X, h))
        Xs.append(X)
        Us.append(U)
    drift = torch.abs(torch.linalg.vector_norm(X[3:7]) - 1.0)
    return torch.stack(Xs), torch.stack(Us), drift


# ----------------------------------------------------------------- full 6-D

class FullSolution(NamedTuple):
    config: AttitudeConfig
    grid: Grid
    result: SolveResult

    @property
    def is_flat(self) -> bool:
        """True when the result tables are in the flat ``(NW, NE)`` layout
        (envelope solves: flat plan and carry mode)."""
        return self.result.argmin.ndim != self.grid.ndim

    @property
    def u_tables(self):
        """(3, *state_shape) optimal torque per axis from the flat argmin:
        on the solution's device, or, for a flat solution, as host numpy
        (three float32 tables are 12 B/cell; :func:`rollout_full` reads a
        flat argmin directly)."""
        if self.is_flat:
            return np.stack(decode_torque_digits(
                self.argmin_6d().astype(np.int64),
                np.asarray(self.config.u_vector)))
        a = self.result.argmin.reshape(self.grid.shape).long()
        u = torch.as_tensor(self.config.u_vector, device=a.device)
        return torch.stack(decode_torque_digits(a, u))

    def values_6d(self) -> np.ndarray:
        """Host numpy view of the values in the state shape."""
        return self.result.values.cpu().numpy().reshape(self.grid.shape)

    def argmin_6d(self) -> np.ndarray:
        """Host numpy view of the flat-action argmin in the state shape."""
        return self.result.argmin.cpu().numpy().reshape(self.grid.shape)


def build_full(cfg: AttitudeConfig, *, flat: Optional[bool] = None,
               edge: str = "extrapolate", chunked: Optional[bool] = None,
               block_rows: Optional[int] = None, lane_mode: str = "auto",
               device="cuda"):
    """6-D grid, Euler-step next states and factorized quaternion cost
    (:261-506), on ``device``. Returns ``(grid, plan, cost_terms)``.

    The plan's layout:

    * broadcast (``flat=False``): queries ``(*state_shape, 27)`` for the
      omega axes and ``(*state_shape, 1)`` for the Euler axes, the cost as
      its row, lane and action terms;
    * flat (``flat=True``; auto past ``FLAT_MIN_CELLS`` cells):
      ``(NW, 1, 27)`` omega and ``(NW, NE, 1)`` Euler arrays, costs
      ``(NW, 1, 1)``, ``(1, NE, 1)``, ``(1, 1, 27)``; ``chunked`` (auto on
      a flat stored plan past ``CHUNKED_MIN_CELLS``) fills the Euler arrays
      in row blocks of ``block_rows`` rows, bitwise the one-shot build;
    * ``lane_mode='recompute'`` (auto past ``RECOMPUTE_MIN_CELLS``): a
      :class:`~ocdp_tpu_torch.ops.backup6d.RecomputePlan`, flat omega
      arrays and the Euler lanes' generators; ``'plan'`` stores them.

    ``edge``: 'extrapolate' (strict reference parity, the default) or
    'clamp' (boundary projection); see
    :func:`~ocdp_tpu_torch.ops.interp.build_plan`.
    """
    with span("ocdp.build"):
        device = resolve_device(device)
        if edge not in ("extrapolate", "clamp"):
            raise ValueError(f"unknown edge policy {edge!r}")
        if lane_mode not in LANE_MODES:
            raise ValueError(f"unknown lane_mode {lane_mode!r}; use one of "
                             f"{LANE_MODES}")
        s_w = linspace_axis(cfg.w_min_deg * _DEG, cfg.w_max_deg * _DEG,
                            cfg.n_mesh_w)
        (y_lo, y_hi), (p_lo, p_hi), (r_lo, r_hi) = cfg.euler_ranges
        s_yaw = linspace_axis(y_lo, y_hi, cfg.n_mesh_q)
        s_pitch = linspace_axis(p_lo, p_hi, cfg.n_mesh_q)
        s_roll = linspace_axis(r_lo, r_hi, cfg.n_mesh_q)
        grid = Grid((s_w, s_w, s_w, s_yaw, s_pitch, s_roll))
        cells = int(np.prod(grid.shape))
        if lane_mode == "auto":
            lane_mode = "recompute" if cells > RECOMPUTE_MIN_CELLS else "plan"
        if lane_mode == "recompute":
            if flat is False:
                raise ValueError("lane_mode='recompute' builds a flat plan")
            plan, cost_terms = _plan_and_cost_flat_recompute(
                cfg, grid, edge=edge, device=device)
            return grid, plan, cost_terms
        if flat is None:
            flat = cells > FLAT_MIN_CELLS
        if chunked is None:
            chunked = flat and cells > CHUNKED_MIN_CELLS
        if chunked:
            if not flat:
                raise ValueError("the chunked build makes the flat layout")
            plan, cost_terms = _plan_and_cost_flat_chunked(
                cfg, grid, edge=edge, block_rows=block_rows, device=device)
        else:
            plan, cost_terms = _plan_and_cost(cfg, grid, s_w, s_yaw, s_pitch,
                                              s_roll, edge=edge, device=device,
                                              flat=flat)
        return grid, plan, cost_terms


def _kirk_q_from_half_angles(cy, sy, cp, sp, cr, sr):
    """kirk-q components from Euler half-angle cos/sin (:449-467);
    broadcast-shaped. Shared by every plan build: the chunked build's bit
    identity with the one-shot build rests on it."""
    q1 = sy * cp * cr - cy * sp * sr
    q2 = cy * sp * cr + sy * cp * sr
    q3 = cy * cp * sr - sy * sp * cr
    q4 = torch.sqrt(torch.clamp(1.0 - (q1**2 + q2**2 + q3**2), min=0.0))
    return q1, q2, q3, q4


def _omega_euler_step(cfg, w1, w2, w3, u1, u2, u3):
    """Euler-step omega with gyroscopic cross terms (:423-425). The torque
    divisions divide by float32 tensors: PyTorch on a CUDA device would
    multiply by the reciprocal of a Python-scalar divisor instead."""
    J1, J2, J3 = cfg.inertia_diag
    h = cfg.h

    def scalar(value):
        return torch.tensor(value, dtype=torch.float32, device=w1.device)

    return (w1 + h * ((J2 - J3) / J1 * w2 * w3 + u1 / scalar(J1)),
            w2 + h * ((J3 - J1) / J2 * w3 * w1 + u2 / scalar(J2)),
            w3 + h * ((J1 - J2) / J3 * w1 * w2 + u3 / scalar(J3)))


def _quat_step_readback(cfg, q, w1, w2, w3):
    """Euler-step kirk-q kinematics (:525-556), renormalize (:477-483),
    Euler-angle readback (:485-489) with ``torch.atan2``/``torch.asin``;
    broadcast-shaped (:func:`~ocdp_tpu_torch.ops.kernelmath.
    quat_step_readback`)."""
    return quat_step_readback(cfg.h, q, w1, w2, w3)


def _half_angles(s, shape, device):
    """cos and sin of half the angles of axis ``s`` (float32 numpy, as the
    one-shot build computes them), as tensors of ``shape``."""
    return (torch.as_tensor(np.cos(s / 2), device=device).reshape(shape),
            torch.as_tensor(np.sin(s / 2), device=device).reshape(shape))


def _plan_and_cost(cfg: AttitudeConfig, grid, s_w, s_yaw, s_pitch, s_roll,
                   *, edge, device, flat: bool = False):
    nu = len(cfg.u_vector)

    # broadcast layout: (w1, w2, w3, yaw, pitch, roll, u1, u2, u3)
    def bshape(arr, axis):
        sh = [1] * 9
        sh[axis] = -1
        return torch.as_tensor(np.asarray(arr), device=device).reshape(sh)

    w1, w2, w3 = (bshape(s_w, i) for i in range(3))
    cy, sy = _half_angles(s_yaw, (1, 1, 1, -1, 1, 1, 1, 1, 1), device)
    cp, sp = _half_angles(s_pitch, (1, 1, 1, 1, -1, 1, 1, 1, 1), device)
    cr, sr = _half_angles(s_roll, (1, 1, 1, 1, 1, -1, 1, 1, 1), device)
    u1, u2, u3 = (bshape(cfg.u_vector, 6 + i) for i in range(3))

    q1, q2, q3, q4 = _kirk_q_from_half_angles(cy, sy, cp, sp, cr, sr)
    w1n, w2n, w3n = _omega_euler_step(cfg, w1, w2, w3, u1, u2, u3)
    yaw_n, pitch_n, roll_n = _quat_step_readback(cfg, (q1, q2, q3, q4),
                                                 w1, w2, w3)

    # stage cost (:315-342): Qw w^2 + Qq q_vec^2 + R u^2, kept as its row,
    # lane and action terms; the dense S x A cost never exists here
    cost_terms = (
        cfg.Qw[0] * w1**2 + cfg.Qw[1] * w2**2 + cfg.Qw[2] * w3**2,
        cfg.Qq[0] * q1**2 + cfg.Qq[1] * q2**2 + cfg.Qq[2] * q3**2,
        cfg.R[0] * u1**2 + cfg.R[1] * u2**2 + cfg.R[2] * u3**2,
    )

    if flat:
        # (rows, lanes, actions): rows the flat omega cells, lanes the flat
        # Euler cells, actions the flat C-order torque index
        nmw, nmq = cfg.n_mesh_w, cfg.n_mesh_q
        nw, ne, n_act = nmw**3, nmq**3, nu**3

        def flat_shape(arr, full, out):
            return arr.expand(full).reshape(out)

        w_full, e_full = (nmw,) * 3 + (1,) * 3 + (nu,) * 3, \
            (nmw,) * 3 + (nmq,) * 3 + (1,) * 3
        queries = tuple(flat_shape(q, w_full, (nw, 1, n_act))
                        for q in (w1n, w2n, w3n)) + \
            tuple(flat_shape(q, e_full, (nw, ne, 1))
                  for q in (yaw_n, pitch_n, roll_n))
        plan = build_plan(grid.axes, queries, edge=edge)
        cost_flat = (
            flat_shape(cost_terms[0], (nmw,) * 3 + (1,) * 6, (nw, 1, 1)),
            flat_shape(cost_terms[1], (1,) * 3 + (nmq,) * 3 + (1,) * 3,
                       (1, ne, 1)),
            flat_shape(cost_terms[2], (1,) * 6 + (nu,) * 3, (1, 1, n_act)))
        return plan, cost_flat

    def flat_actions(arr):
        """The 3 trailing action axes as one (C order: u1 slowest, u3
        fastest, the reference's chained-min order)."""
        if arr.shape[6:] == (1, 1, 1):
            return arr.reshape(arr.shape[:6] + (1,))
        return arr.expand(arr.shape[:6] + (nu, nu, nu)) \
            .reshape(arr.shape[:6] + (nu**3,))

    queries = tuple(flat_actions(q) for q in
                    (w1n, w2n, w3n, yaw_n, pitch_n, roll_n))
    plan = build_plan(grid.axes, queries, edge=edge)
    return plan, tuple(flat_actions(t) for t in cost_terms)


class _FlatParts(NamedTuple):
    """What the chunked and the recompute builds share: the omega next
    states ``(NW, 1, A)``, the lanes' kirk-q ``(NE,)``, the rows' omegas
    ``(NW,)`` and the flat cost terms."""

    w_next: tuple
    q_lane: tuple
    w_rows: tuple
    cost: tuple


def _flat_parts(cfg: AttitudeConfig, grid, device) -> _FlatParts:
    """The small pieces of a flat plan (``ocdp_tpu/models/attitude.py:
    603-634, 733-780``), with the one-shot build's arithmetic."""
    s_w, s_yaw, s_pitch, s_roll = (grid.axes[k] for k in (0, 3, 4, 5))
    nu = len(cfg.u_vector)
    nmw = cfg.n_mesh_w
    nw, ne, n_act = nmw**3, cfg.n_mesh_q**3, nu**3

    def axis6(arr, axis):
        sh = [1] * 6
        sh[axis] = -1
        return torch.as_tensor(np.asarray(arr), device=device).reshape(sh)

    w1, w2, w3 = (axis6(s_w, i) for i in range(3))
    u1, u2, u3 = (axis6(cfg.u_vector, 3 + i) for i in range(3))
    w_next = tuple(q.expand((nmw,) * 3 + (nu,) * 3).reshape(nw, 1, n_act)
                   for q in _omega_euler_step(cfg, w1, w2, w3, u1, u2, u3))
    cy, sy = _half_angles(s_yaw, (-1, 1, 1), device)
    cp, sp = _half_angles(s_pitch, (1, -1, 1), device)
    cr, sr = _half_angles(s_roll, (1, 1, -1), device)
    q1, q2, q3, q4 = (q.reshape(ne) for q in
                      _kirk_q_from_half_angles(cy, sy, cp, sp, cr, sr))
    sw = torch.as_tensor(np.asarray(s_w, np.float32), device=device)
    rows = torch.arange(nw, device=device)
    w_rows = (sw[rows // (nmw * nmw)], sw[(rows // nmw) % nmw],
              sw[rows % nmw])
    c_row = cfg.Qw[0] * w1**2 + cfg.Qw[1] * w2**2 + cfg.Qw[2] * w3**2
    c_lane = cfg.Qq[0] * q1**2 + cfg.Qq[1] * q2**2 + cfg.Qq[2] * q3**2
    c_act = cfg.R[0] * u1**2 + cfg.R[1] * u2**2 + cfg.R[2] * u3**2
    cost = (c_row.expand((nmw,) * 3 + (1,) * 3).reshape(nw, 1, 1),
            c_lane.reshape(1, ne, 1),
            c_act.expand((1,) * 3 + (nu,) * 3).reshape(1, 1, n_act))
    return _FlatParts(w_next, (q1, q2, q3, q4), w_rows, cost)


def _row_plan_arrays(grid, w_next, edge):
    """Locate the omega next states on the omega axes: the row axes' flat
    ``(NW, 1, A)`` lo/frac arrays."""
    los, frs = [], []
    for k, wn in enumerate(w_next):
        lo, fr = axis_locate(grid.axes[k], wn)
        if edge == "clamp":
            fr = fr.clamp(0.0, 1.0)
        los.append(lo)
        frs.append(fr)
    return los, frs


def _plan_and_cost_flat_chunked(cfg: AttitudeConfig, grid, *, edge,
                                block_rows: Optional[int], device):
    """Flat stored plan built in row blocks (``ocdp_tpu/models/
    attitude.py:574-702``): the Euler lo/frac arrays are allocated once in
    their final ``(NW, NE, 1)`` shape and filled ``block_rows`` rows at a
    time (default: a multiple of n_mesh_w^2 rows with about 0.5 GB of
    transients), the last block overlapping backward (an idempotent
    rewrite) when it does not divide NW. The arithmetic is the one-shot
    flat build's, op by op, so the two are equal bitwise."""
    parts = _flat_parts(cfg, grid, device)
    nmw = cfg.n_mesh_w
    nw, ne = nmw**3, cfg.n_mesh_q**3
    if block_rows is None:
        per_row = ne * 4 * 12
        g = max(1, min(nmw, int(500e6 / (nmw**2 * per_row)) or 1))
        block_rows = g * nmw**2
    rows = min(int(block_rows), nw)
    r0s = list(range(0, nw - rows + 1, rows))
    if r0s[-1] + rows < nw:
        r0s.append(nw - rows)           # overlapping idempotent tail block
    lo_bufs = [torch.empty((nw, ne, 1), dtype=torch.int32, device=device)
               for _ in range(3)]
    fr_bufs = [torch.empty((nw, ne, 1), dtype=torch.float32, device=device)
               for _ in range(3)]
    q = tuple(x[None, :] for x in parts.q_lane)
    for r0 in r0s:
        w = [x[r0:r0 + rows, None] for x in parts.w_rows]
        for k, coord in enumerate(_quat_step_readback(cfg, q, *w)):
            lo, fr = axis_locate(grid.axes[3 + k], coord)
            if edge == "clamp":
                fr = fr.clamp(0.0, 1.0)
            lo_bufs[k][r0:r0 + rows, :, 0] = lo
            fr_bufs[k][r0:r0 + rows, :, 0] = fr
    los, frs = _row_plan_arrays(grid, parts.w_next, edge)
    plan = InterpPlan(tuple(los + lo_bufs), tuple(frs + fr_bufs),
                      tuple(grid.shape))
    return plan, parts.cost


def _plan_and_cost_flat_recompute(cfg: AttitudeConfig, grid, *, edge,
                                  device):
    """The envelope plan with the Euler lanes as generators
    (``ocdp_tpu/models/attitude.py:705-791``): the rows' omegas (12 B/row)
    and the lanes' kirk-q (16 B/lane) in a
    :class:`~ocdp_tpu_torch.ops.backup6d.LaneRecompute`, which the B.5
    kernel turns into each cell's (lo, frac) with the kernelmath trig and
    the affine locate. Values agree with the stored plan to float32
    transcendental tolerance, not bitwise."""
    parts = _flat_parts(cfg, grid, device)
    axes = [grid.axes[k] for k in (3, 4, 5)]
    starts = [float(np.float32(a[0])) for a in axes]
    # the JAX package's float32 spacing, then 1/step rounded to float32
    steps = [float(np.float32(np.float32(a[-1]) - np.float32(a[0]))
                   / np.float32(len(a) - 1)) for a in axes]
    spec = LaneRecompute(
        h=cfg.h, row_feats=parts.w_rows, lane_feats=parts.q_lane,
        axis_starts=tuple(starts),
        axis_inv_steps=tuple(float(np.float32(1.0 / s)) for s in steps),
        axis_sizes=tuple(len(a) for a in axes), edge=edge)
    los, frs = _row_plan_arrays(grid, parts.w_next, edge)
    plan = RecomputePlan(tuple(los), tuple(frs), spec, tuple(grid.shape))
    return plan, parts.cost


def solve_full(
    cfg: AttitudeConfig,
    *,
    device="cuda",
    num_sweeps: Optional[int] = None,
    impl: str = "auto",
    edge: str = "extrapolate",
    lane_mode: str = "auto",
    flat: Optional[bool] = None,
    carry_padded: Optional[bool] = None,
    verbose: bool = False,
    segment_size: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    start_sweep: int = 0,
    init_values=None,
    prev_f: Optional[float] = None,
    tol: Optional[float] = None,
    tol_mode: str = "abs",
) -> FullSolution:
    """The 6-D finite-horizon solve (:261-300) on ``device``: the card
    unless the caller asks for ``"cpu"``; raises without a card.
    ``num_sweeps`` defaults to the reference's ``n_stage - 1``.

    ``impl``: ``'auto'`` (the 6-D backup of
    :class:`~ocdp_tpu_torch.ops.backup6d.Backup6D`: its CUDA kernel on a
    CUDA device, its plain version on the CPU), ``'kernel'`` (the same, CUDA
    devices only), ``'plain'`` (the plain version through the allocating
    engine path, any device) or ``'gather'`` (the gather oracle over the
    cost terms; broadcast plans only).

    The envelope path (:func:`build_full`'s ``flat`` and ``lane_mode``):
    past ``FLAT_MIN_CELLS`` cells the plan is flat, the backup's argmin
    uint8 and the engines run in carry mode (``carry_padded``, default on
    there), so the result tables stay flat ``(NW, NE)``
    (:attr:`FullSolution.is_flat`; :meth:`FullSolution.values_6d` and
    :meth:`FullSolution.argmin_6d` give host 6-D views). A flat plan's
    arrays go to the backup, and the engines see only its shape.

    ``segment_size``: run through
    :func:`~ocdp_tpu_torch.engine.value_iteration_segmented`, with a
    checkpoint per segment at ``checkpoint_path`` (a flat solve's holds the
    flat table and the 1-D axes), resume from
    ``init_values``/``start_sweep``/``prev_f`` (what
    :func:`~ocdp_tpu_torch.io.load_values` returns), and the converged
    engine's stop rule with ``check_every=segment_size`` when ``tol`` is
    given; a flat solve's argmin stays uint8. ``verbose`` prints the
    reference's per-stage timing lines, per sweep, or per segment when
    segmented.
    """
    with solve_span():
        device = resolve_device(device)
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; use one of {IMPLS}")
        if impl == "kernel" and device.type != "cuda":
            raise ValueError(
                f"impl='kernel' needs a CUDA device, got {device}")
        grid, plan, cost = build_full(cfg, flat=flat, edge=edge,
                                      lane_mode=lane_mode, device=device)
        flat_solve = plan_is_flat(plan)
        if flat_solve and impl == "gather":
            raise ValueError("flat plans are consumed by the 6-D backup only; "
                             "use impl='auto', 'kernel' or 'plain'")
        sweeps = (cfg.n_stage - 1) if num_sweeps is None else num_sweeps
        big = int(np.prod(grid.shape)) > FLAT_MIN_CELLS
        backup = None
        if impl != "gather":
            bk = Backup6D(plan, cost,
                          argmin_dtype=torch.uint8 if big else torch.int32,
                          carry_padded=big if carry_padded is None
                          else carry_padded,
                          consume_plan=flat_solve)
            backup = bk.plain if impl == "plain" else bk
        if flat_solve:
            # the backup holds what it needs of the plan: drop the rest
            plan, cost = PlanShape.of(plan), None
        if segment_size is not None:
            res = value_iteration_segmented(
                plan, cost, sweeps, segment_size=segment_size, backup=backup,
                checkpoint_path=checkpoint_path, checkpoint_axes=grid.axes,
                init_values=init_values, start_sweep=start_sweep,
                prev_f=prev_f, tol=tol, tol_mode=tol_mode,
                narrow_argmin_result=flat_solve,
                on_segment=SweepTimer(verbose=True).on_segment if verbose
                else None)
            return FullSolution(cfg, grid, res)
        res = value_iteration_finite(plan, cost, sweeps,
                                     init_values=init_values, backup=backup,
                                     on_sweep=sweep_callback(verbose))
        return FullSolution(cfg, grid, res)


def attitude_rates_kirk(X, U, inertia, inertia_inv=None):
    """7-state derivative [w(3), kirk-q(4)] (spacecraft_dynamics_list
    :600-622 for diagonal inertia; pass the full (3, 3) inertia for the
    ode45 variant :849-872). States and torques on the last axis."""
    w = X[..., 0:3]
    q1, q2, q3, q4 = X[..., 3:7].unbind(-1)
    if inertia_inv is None:
        inertia_inv = torch.linalg.inv(inertia)
    w_dot = matvec(inertia_inv, U - cross(w, matvec(inertia, w)))
    w1, w2, w3 = w.unbind(-1)
    q_dot = 0.5 * torch.stack([
        w3 * q2 - w2 * q3 + w1 * q4,
        -w3 * q1 + w1 * q3 + w2 * q4,
        w2 * q1 - w1 * q2 + w3 * q4,
        -w1 * q1 - w2 * q2 - w3 * q3,
    ], dim=-1)
    return torch.cat([w_dot, q_dot], dim=-1)


def _renorm_q(X):
    q = X[..., 3:7]
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.cat([X[..., 0:3], q / n], dim=-1)


def euler_from_kirk_quat(q_kirk):
    """(yaw, pitch, roll) from a kirk-ordered quaternion (last axis): the
    reference's ``quat2angle([X7 X6 X5 X4])`` call pattern (:757)."""
    return quat_to_euler_zyx(q_kirk[..., [2, 1, 0, 3]])


def rollout_full(sol: FullSolution, x0=None, *, method: str = "nearest",
                 num_stages: Optional[int] = None):
    """Full-policy rollout with Euler (taylor) steps (:744-833), on the
    solution's device.

    Per stage: read the Euler angles back from the quaternion, look the
    torques up in the three torque tables at (omega, Euler) — the nearest
    cell (``method='nearest'``, the reference's policy interpolant, with
    the lower-snap midpoint rule) or multilinear (``'interp'``) — then one
    Euler step of the rates and a quaternion renormalization.

    A flat solution (:attr:`FullSolution.is_flat`) flies without torque
    tables (``ocdp_tpu/models/attitude.py:993-1014``): the affine nearest
    locate, the row and lane index composed from its digits, one scalar
    gather from the flat argmin, then the torque decode; ``'nearest'``
    only.

    Returns (X, U, ANGLES): states (N, 7), torques (N-1, 3), Euler angles
    (N-1, 3).
    """
    if method not in ("nearest", "interp"):
        raise ValueError(f"unknown method {method!r}; use 'nearest' or "
                         "'interp'")
    if sol.is_flat and method != "nearest":
        raise ValueError("flat-layout solutions support method='nearest' "
                         "only (6-D torque tables would have to be built)")
    cfg = sol.config
    n = num_stages or cfg.n_stage
    axes = sol.grid.axes
    dev = sol.result.argmin.device

    def mat(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    inertia = mat(np.diag(cfg.inertia_diag))
    inertia_inv = mat(np.diag(1.0 / np.asarray(cfg.inertia_diag)))
    shape = sol.grid.shape
    if sol.is_flat:
        aff = affine_axes(axes, device=dev)
        argmin = sol.result.argmin
        u = torch.as_tensor(cfg.u_vector, device=dev)
        row_mul = torch.tensor([shape[1] * shape[2], shape[2], 1, 0, 0, 0],
                               dtype=torch.int64, device=dev)
        lane_mul = torch.tensor([0, 0, 0, shape[4] * shape[5], shape[5], 1],
                                dtype=torch.int64, device=dev)

        def lookup(pt):
            idx = nearest_cell_index(aff, pt).long()
            a = argmin[(idx * row_mul).sum(), (idx * lane_mul).sum()].long()
            return torch.stack(decode_torque_digits(a, u))
    elif method == "nearest":
        tables = sol.u_tables                              # (3, *shape)
        aff = affine_axes(axes, device=dev)
        strides = torch.tensor([int(np.prod(shape[k + 1:]))
                                for k in range(len(shape))],
                               dtype=torch.int64, device=dev)
        flat = tables.reshape(3, -1)

        def lookup(pt):
            idx = nearest_cell_index(aff, pt)
            return flat[:, (idx.long() * strides).sum()]
    else:
        tables = sol.u_tables

        def lookup(pt):
            plan = build_plan(axes, pt.unbind(0))
            return torch.stack([interp_apply(tables[i], plan)
                                for i in range(3)])

    X = torch.as_tensor(AttitudeConfig.default_x0() if x0 is None
                        else np.asarray(x0, np.float32), device=dev)
    Xs, Us, angles = [], [], []
    for _ in range(n - 1):
        yaw, pitch, roll = euler_from_kirk_quat(X[3:7])
        U = lookup(torch.stack([X[0], X[1], X[2], yaw, pitch, roll]))
        Xs.append(X)
        Us.append(U)
        angles.append(torch.stack([yaw, pitch, roll]))
        X = _renorm_q(X + cfg.h * attitude_rates_kirk(X, U, inertia,
                                                      inertia_inv))
    Xs.append(X)
    return torch.stack(Xs), torch.stack(Us), torch.stack(angles)
