"""Rigid-body attitude control: the full coupled 6-D solve and its rollout.

Counterpart of the full 6-D part of ``ocdp_tpu/models/attitude.py``
(attitude-control/Solver_attitude.m:261-506, 744-833). The state grid is
(omega1, omega2, omega3, yaw, pitch, roll) with the 27 torque combinations
u in {-u_max, 0, u_max}^3 as one flat C-order action axis (u1 slowest), so
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

The simplified per-axis solver's configuration fields are kept in
:class:`AttitudeConfig`; its solver is not in this module.
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
from ..ops.backup6d import Backup6D
from ..ops.interp import (affine_axes, build_plan, interp_apply,
                          nearest_cell_index)
from ..profiling import SweepTimer, sweep_callback
from ..utils.device import resolve_device
from ..utils.frames import cross, matvec
from ..utils.quaternions import kirk_quat_from_euler, quat_to_euler_zyx

__all__ = [
    "AttitudeConfig",
    "FullSolution",
    "decode_torque_digits",
    "build_full",
    "solve_full",
    "attitude_rates_kirk",
    "euler_from_kirk_quat",
    "rollout_full",
]

IMPLS = ("auto", "kernel", "plain", "gather")
_DEG = np.pi / 180.0


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


class FullSolution(NamedTuple):
    config: AttitudeConfig
    grid: Grid
    result: SolveResult

    @property
    def u_tables(self) -> torch.Tensor:
        """(3, *state_shape) optimal torque per axis from the flat argmin,
        on the solution's device."""
        a = self.result.argmin.reshape(self.grid.shape).long()
        u = torch.as_tensor(self.config.u_vector, device=a.device)
        return torch.stack(decode_torque_digits(a, u))

    def values_6d(self) -> np.ndarray:
        """Host numpy view of the values in the state shape."""
        return self.result.values.cpu().numpy().reshape(self.grid.shape)

    def argmin_6d(self) -> np.ndarray:
        """Host numpy view of the flat-action argmin in the state shape."""
        return self.result.argmin.cpu().numpy().reshape(self.grid.shape)


def build_full(cfg: AttitudeConfig, *, edge: str = "extrapolate",
               device="cuda"):
    """6-D grid, Euler-step next states and factorized quaternion cost
    (:261-506), on ``device``. Returns ``(grid, plan, cost_terms)``: the plan
    in the broadcast layout, queries ``(*state_shape, 27)`` for the omega
    axes and ``(*state_shape, 1)`` for the Euler axes, and the stage cost as
    its row, lane and action terms.

    ``edge``: 'extrapolate' (strict reference parity, the default) or
    'clamp' (boundary projection); see
    :func:`~ocdp_tpu_torch.ops.interp.build_plan`.
    """
    device = resolve_device(device)
    s_w = linspace_axis(cfg.w_min_deg * _DEG, cfg.w_max_deg * _DEG,
                        cfg.n_mesh_w)
    (y_lo, y_hi), (p_lo, p_hi), (r_lo, r_hi) = cfg.euler_ranges
    s_yaw = linspace_axis(y_lo, y_hi, cfg.n_mesh_q)
    s_pitch = linspace_axis(p_lo, p_hi, cfg.n_mesh_q)
    s_roll = linspace_axis(r_lo, r_hi, cfg.n_mesh_q)
    grid = Grid((s_w, s_w, s_w, s_yaw, s_pitch, s_roll))
    plan, cost_terms = _plan_and_cost(cfg, grid, s_w, s_yaw, s_pitch, s_roll,
                                      edge=edge, device=device)
    return grid, plan, cost_terms


def _kirk_q_from_half_angles(cy, sy, cp, sp, cr, sr):
    """kirk-q components from Euler half-angle cos/sin (:449-467);
    broadcast-shaped."""
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
    Euler-angle readback (:485-489); broadcast-shaped."""
    q1, q2, q3, q4 = q
    h = cfg.h
    q1n = q1 + h * 0.5 * (w3 * q2 - w2 * q3 + w1 * q4)
    q2n = q2 + h * 0.5 * (-w3 * q1 + w1 * q3 + w2 * q4)
    q3n = q3 + h * 0.5 * (w2 * q1 - w1 * q2 + w3 * q4)
    q4n = q4 + h * 0.5 * (-w1 * q1 - w2 * q2 - w3 * q3)
    norm = torch.sqrt(q1n**2 + q2n**2 + q3n**2 + q4n**2)
    q1n, q2n, q3n, q4n = q1n / norm, q2n / norm, q3n / norm, q4n / norm
    yaw_n = torch.atan2(2 * (q3n * q2n + q4n * q1n),
                        q4n**2 + q3n**2 - q2n**2 - q1n**2)
    pitch_n = torch.asin(torch.clamp(-2 * (q3n * q1n - q4n * q2n), -1.0, 1.0))
    roll_n = torch.atan2(2 * (q2n * q1n + q4n * q3n),
                         q4n**2 - q3n**2 - q2n**2 + q1n**2)
    return yaw_n, pitch_n, roll_n


def _plan_and_cost(cfg: AttitudeConfig, grid, s_w, s_yaw, s_pitch, s_roll,
                   *, edge, device):
    nu = len(cfg.u_vector)

    # broadcast layout: (w1, w2, w3, yaw, pitch, roll, u1, u2, u3)
    def bshape(arr, axis):
        sh = [1] * 9
        sh[axis] = -1
        return torch.as_tensor(np.asarray(arr), device=device).reshape(sh)

    w1, w2, w3 = (bshape(s_w, i) for i in range(3))
    cy, sy = bshape(np.cos(s_yaw / 2), 3), bshape(np.sin(s_yaw / 2), 3)
    cp, sp = bshape(np.cos(s_pitch / 2), 4), bshape(np.sin(s_pitch / 2), 4)
    cr, sr = bshape(np.cos(s_roll / 2), 5), bshape(np.sin(s_roll / 2), 5)
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


def solve_full(
    cfg: AttitudeConfig,
    *,
    device="cuda",
    num_sweeps: Optional[int] = None,
    impl: str = "auto",
    edge: str = "extrapolate",
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

    ``impl``: ``'kernel'`` (the 6-D CUDA kernel through
    :class:`~ocdp_tpu_torch.ops.backup6d.Backup6D`; CUDA devices only),
    ``'plain'`` (its plain PyTorch version, any device), ``'gather'`` (the
    gather oracle over the cost terms), or ``'auto'``: the kernel on a CUDA
    device, the plain version on the CPU.

    ``segment_size``: run through
    :func:`~ocdp_tpu_torch.engine.value_iteration_segmented`, with a
    checkpoint per segment at ``checkpoint_path``, resume from
    ``init_values``/``start_sweep``/``prev_f`` (what
    :func:`~ocdp_tpu_torch.io.load_values` returns), and the converged
    engine's stop rule with ``check_every=segment_size`` when ``tol`` is
    given. ``verbose`` prints the reference's per-stage timing lines, per
    sweep, or per segment when segmented.
    """
    device = resolve_device(device)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; use one of {IMPLS}")
    if impl == "auto":
        impl = "kernel" if device.type == "cuda" else "plain"
    if impl == "kernel" and device.type != "cuda":
        raise ValueError(f"impl='kernel' needs a CUDA device, got {device}")
    grid, plan, cost = build_full(cfg, edge=edge, device=device)
    sweeps = (cfg.n_stage - 1) if num_sweeps is None else num_sweeps
    backup = None
    if impl != "gather":
        bk = Backup6D(plan, cost)
        backup = bk if impl == "kernel" else bk.plain
    if segment_size is not None:
        res = value_iteration_segmented(
            plan, cost, sweeps, segment_size=segment_size, backup=backup,
            checkpoint_path=checkpoint_path, checkpoint_axes=grid.axes,
            init_values=init_values, start_sweep=start_sweep, prev_f=prev_f,
            tol=tol, tol_mode=tol_mode,
            on_segment=SweepTimer(verbose=True).on_segment if verbose
            else None)
        return FullSolution(cfg, grid, res)
    res = value_iteration_finite(plan, cost, sweeps, init_values=init_values,
                                 backup=backup,
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

    Returns (X, U, ANGLES): states (N, 7), torques (N-1, 3), Euler angles
    (N-1, 3).
    """
    if method not in ("nearest", "interp"):
        raise ValueError(f"unknown method {method!r}; use 'nearest' or "
                         "'interp'")
    cfg = sol.config
    n = num_stages or cfg.n_stage
    axes = sol.grid.axes
    tables = sol.u_tables                                  # (3, *shape)
    dev = tables.device

    def mat(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    inertia = mat(np.diag(cfg.inertia_diag))
    inertia_inv = mat(np.diag(1.0 / np.asarray(cfg.inertia_diag)))
    if method == "nearest":
        aff = affine_axes(axes, device=dev)
        shape = sol.grid.shape
        strides = torch.tensor([int(np.prod(shape[k + 1:]))
                                for k in range(len(shape))],
                               dtype=torch.int64, device=dev)
        flat = tables.reshape(3, -1)

        def lookup(pt):
            idx = nearest_cell_index(aff, pt)
            return flat[:, (idx.long() * strides).sum()]
    else:
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
