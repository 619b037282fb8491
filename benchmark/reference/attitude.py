"""The full 6-D attitude problem as a row/lane problem, from the
configuration alone (Solver_attitude.m:261-506).

State (omega1, omega2, omega3, yaw, pitch, roll) on ``n_mesh_w^3 x
n_mesh_q^3`` cells; 27 torques ``u in {-u_max, 0, u_max}^3``, u1 slowest.
An Euler step of the rates with the gyroscopic terms (rows: they depend on
the torque), an Euler step of the quaternion built from the Euler
half-angles, its renormalization and the readback to Euler angles (lanes:
they depend on the rates and the angles). Stage cost ``Qw w^2 + Qq
q_vec^2 + R u^2``, the quaternion in the reference's component order
(Solver_attitude.m:315-342, 449-467).
"""

from __future__ import annotations

import numpy as np
import torch

from .dp import RowLaneProblem, corners, locate

__all__ = ["axes", "located", "problem", "torques"]

_DEG = np.pi / 180.0


def axes(cfg: dict):
    """The omega axis (radians) and the yaw, pitch and roll axes, float32."""
    s_w = np.linspace(cfg["w_min_deg"] * _DEG, cfg["w_max_deg"] * _DEG,
                      cfg["n_mesh_w"]).astype(np.float32)
    eul = [np.linspace(lo * _DEG, hi * _DEG, cfg["n_mesh_q"]).astype(np.float32)
           for lo, hi in (cfg["yaw_range_deg"], cfg["pitch_range_deg"],
                          cfg["roll_range_deg"])]
    return s_w, eul


def torques(cfg: dict) -> np.ndarray:
    """(27, 3) torques, the first axis slowest."""
    u = np.array([-cfg["u_max"], 0.0, cfg["u_max"]], np.float32)
    g = np.meshgrid(u, u, u, indexing="ij")
    return np.stack([a.ravel() for a in g], 1)


def _quat(cy, sy, cp, sp, cr, sr):
    q1 = sy * cp * cr - cy * sp * sr
    q2 = cy * sp * cr + sy * cp * sr
    q3 = cy * cp * sr - sy * sp * cr
    q4 = torch.sqrt(torch.clamp(1.0 - (q1 * q1 + q2 * q2 + q3 * q3), min=0.0))
    return q1, q2, q3, q4


def located(cfg: dict, device):
    """The next states located on the axes (float32): per omega axis
    ``(n, n, n, A)`` over (omega1, omega2, omega3, torque), per Euler axis
    ``(NW, NE)`` over (omega cell, Euler cell), each ``(lo, frac)``; and
    the pieces the costs take: the rows' omegas ``(NW, 1)`` each, the
    lanes' quaternion ``(1, NE)`` each, the torques ``(A, 3)``."""
    h = cfg["h"]
    J1, J2, J3 = cfg["inertia_diag"]
    s_w_np, eul_np = axes(cfg)
    s_w = torch.as_tensor(s_w_np, device=device)
    n = s_w.numel()
    u = torch.as_tensor(torques(cfg), device=device)          # (A, 3)
    w1 = s_w[:, None, None, None]
    w2 = s_w[None, :, None, None]
    w3 = s_w[None, None, :, None]
    u1, u2, u3 = (u[:, k][None, None, None, :] for k in range(3))
    w1n = w1 + h * ((J2 - J3) / J1 * w2 * w3 + u1 / J1)
    w2n = w2 + h * ((J3 - J1) / J2 * w3 * w1 + u2 / J2)
    w3n = w3 + h * ((J1 - J2) / J3 * w1 * w2 + u3 / J3)
    shape = (n, n, n, u.shape[0])
    rows = [locate(s_w, x.expand(shape)) for x in (w1n, w2n, w3n)]

    e = [torch.as_tensor(a, device=device) for a in eul_np]
    m = e[0].numel()
    yaw = e[0][:, None, None]
    pitch = e[1][None, :, None]
    roll = e[2][None, None, :]
    half = [(torch.cos(a / 2), torch.sin(a / 2)) for a in (yaw, pitch, roll)]
    q1, q2, q3, q4 = (t.expand(m, m, m).reshape(1, -1)
                      for t in _quat(*half[0], *half[1], *half[2]))
    rw = [a.expand(n, n, n).reshape(-1, 1) for a in
          (s_w[:, None, None], s_w[None, :, None], s_w[None, None, :])]
    a1, a2, a3 = rw
    p1 = q1 + h * 0.5 * (a3 * q2 - a2 * q3 + a1 * q4)
    p2 = q2 + h * 0.5 * (-a3 * q1 + a1 * q3 + a2 * q4)
    p3 = q3 + h * 0.5 * (a2 * q1 - a1 * q2 + a3 * q4)
    p4 = q4 + h * 0.5 * (-a1 * q1 - a2 * q2 - a3 * q3)
    norm = torch.sqrt(p1 * p1 + p2 * p2 + p3 * p3 + p4 * p4)
    p1, p2, p3, p4 = p1 / norm, p2 / norm, p3 / norm, p4 / norm
    yaw_n = torch.atan2(2 * (p3 * p2 + p4 * p1),
                        p4 * p4 + p3 * p3 - p2 * p2 - p1 * p1)
    pitch_n = torch.asin(torch.clamp(-2 * (p3 * p1 - p4 * p2), -1.0, 1.0))
    roll_n = torch.atan2(2 * (p2 * p1 + p4 * p3),
                         p4 * p4 - p3 * p3 - p2 * p2 + p1 * p1)
    lanes = [locate(ax, x) for ax, x in zip(e, (yaw_n, pitch_n, roll_n))]
    return rows, lanes, rw, (q1, q2, q3), u


def problem(cfg: dict, device) -> RowLaneProblem:
    """One channel: rows the omega cells, lanes the Euler cells."""
    rows, lanes, rw, q, u = located(cfg, device)
    n = cfg["n_mesh_w"]
    m = cfg["n_mesh_q"]
    n_a = u.shape[0]
    los, frs = zip(*rows)
    r_idx, r_w = corners(los, frs, (n, n, n))
    r_idx = r_idx.reshape(n ** 3, n_a, 8)
    r_w = r_w.reshape(n ** 3, n_a, 8)
    los, frs = zip(*lanes)
    l_idx, l_w = corners(los, frs, (m, m, m))               # (NW, NE, 8)
    c_row = (cfg["Qw"][0] * rw[0] ** 2 + cfg["Qw"][1] * rw[1] ** 2
             + cfg["Qw"][2] * rw[2] ** 2).reshape(-1)
    c_lane = (cfg["Qq"][0] * q[0] ** 2 + cfg["Qq"][1] * q[1] ** 2
              + cfg["Qq"][2] * q[2] ** 2).reshape(-1)
    c_act = (cfg["R"][0] * u[:, 0] ** 2 + cfg["R"][1] * u[:, 1] ** 2
             + cfg["R"][2] * u[:, 2] ** 2)
    return RowLaneProblem(r_idx[None], r_w[None], l_idx[None], l_w[None],
                          c_row[None], c_lane[None], c_act[None])
