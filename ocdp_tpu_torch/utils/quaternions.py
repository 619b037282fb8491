"""Quaternion algebra with the reference's conventions, on tensors.

Counterpart of ``ocdp_tpu/utils/quaternions.py``. The reference stores
quaternions SCALAR-LAST, q = [q1 q2 q3 q4] with q4 the scalar part
(pos-att/Solver_pos_att.m:462-463). Every function takes its vectors on the
LAST axis, so a leading batch axis (a fleet of rollouts) passes through, and
writes each sum out element by element in the JAX package's order.
"""

from __future__ import annotations

import torch

__all__ = [
    "quat_normalize",
    "quat_to_dcm",
    "quat_kinematics",
    "euler_zyx_to_quat",
    "kirk_quat_from_euler",
    "quat_to_euler_zyx",
    "small_angles_from_quat",
]


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_dcm(q):
    """ECI->body direction-cosine matrix (``..., 3, 3``) from a scalar-last
    quaternion; ``ECI2body`` (pos-att/Solver_pos_att.m:825-829)."""
    q1, q2, q3, q4 = q.unbind(-1)
    rows = [
        [1 - 2 * (q2 * q2 + q3 * q3), 2 * (q1 * q2 + q3 * q4),
         2 * (q1 * q3 - q2 * q4)],
        [2 * (q2 * q1 - q3 * q4), 1 - 2 * (q1 * q1 + q3 * q3),
         2 * (q2 * q3 + q1 * q4)],
        [2 * (q3 * q1 + q2 * q4), 2 * (q3 * q2 - q1 * q4),
         1 - 2 * (q1 * q1 + q2 * q2)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_kinematics(q, w):
    """dq/dt for body rates ``w``, scalar-last: the component form of the
    reference's 13-state plant (pos-att/Solver_pos_att.m:712-716)."""
    q1, q2, q3, q4 = q.unbind(-1)
    w1, w2, w3 = w.unbind(-1)
    return 0.5 * torch.stack([
        w3 * q2 - w2 * q3 + w1 * q4,
        -w3 * q1 + w1 * q3 + w2 * q4,
        w2 * q1 - w1 * q2 + w3 * q4,
        -w1 * q1 - w2 * q2 - w3 * q3,
    ], dim=-1)


def euler_zyx_to_quat(yaw, pitch, roll):
    """ZYX (yaw-pitch-roll) Euler angles -> TRUE scalar-last quaternion
    [x y z w] (the rotation of MATLAB ``angle2quat(yaw, pitch, roll)``, which
    is scalar-first). This is not the reference's stored component order
    (see :func:`kirk_quat_from_euler`); the two coincide for pitch-only
    rotations, e.g. the reference's default pos-att x0."""
    yaw, pitch, roll = (torch.as_tensor(a, dtype=torch.float32)
                        for a in (yaw, pitch, roll))
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    w = cy * cp * cr + sy * sp * sr
    x = cy * cp * sr - sy * sp * cr
    y = cy * sp * cr + sy * cp * sr
    z = sy * cp * cr - cy * sp * sr
    return torch.stack([x, y, z, w], dim=-1)


def kirk_quat_from_euler(yaw, pitch, roll):
    """ZYX Euler angles -> quaternion in the REFERENCE's component order
    [z y x w] (``angle2quat(...); q0(end:-1:1)``, Solver_pos_att.m:462-463;
    Solver_attitude.m:322-340)."""
    q = euler_zyx_to_quat(yaw, pitch, roll)
    return q[..., [2, 1, 0, 3]]


def quat_to_euler_zyx(q):
    """Scalar-last quaternion -> (yaw, pitch, roll), ZYX; MATLAB
    ``quat2angle`` on the scalar-first reversal (Solver_attitude.m:540)."""
    x, y, z, w = q.unbind(-1)
    yaw = torch.atan2(2 * (x * y + w * z), w * w + x * x - y * y - z * z)
    pitch = torch.asin(torch.clamp(-2 * (x * z - w * y), -1.0, 1.0))
    roll = torch.atan2(2 * (y * z + w * x), w * w - x * x - y * y + z * z)
    return yaw, pitch, roll


def small_angles_from_quat(q):
    """Per-axis rotation angles t_i = 2*asin(q_i), the reference's readback
    for policy lookup (Solver_pos_att.m:490-492)."""
    return 2.0 * torch.asin(torch.clamp(q[..., :3], -1.0, 1.0))
