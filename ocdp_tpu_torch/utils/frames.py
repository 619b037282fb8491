"""Reference-frame transforms: RSW (target co-moving) <-> ECI <-> body.

Counterpart of ``ocdp_tpu/utils/frames.py``: ``RSW2ECI``
(pos-att/Solver_pos_att.m:831-847) and the body transforms of the policy
lookup (:404-415) and the force mapping (:804-823). Vectors sit on the last
axis. Products of a 3x3 matrix and a vector are written out as three
products summed left to right (:func:`matvec`), so a batch of vectors gives
each member the same rounding as that vector alone.
"""

from __future__ import annotations

import torch

from .quaternions import quat_to_dcm

__all__ = ["matvec", "cross", "norm3", "rsw_to_eci_matrix", "rsw_to_body",
           "body_to_rsw"]


def matvec(m, v):
    """``m @ v`` over the last axes: ``m`` (..., 3, 3), ``v`` (..., 3)."""
    v = v[..., None, :]
    return (m[..., 0] * v[..., 0] + m[..., 1] * v[..., 1]) \
        + m[..., 2] * v[..., 2]


def cross(a, b):
    """Cross product over the last axis."""
    a1, a2, a3 = a.unbind(-1)
    b1, b2, b3 = b.unbind(-1)
    return torch.stack([a2 * b3 - a3 * b2, a3 * b1 - a1 * b3,
                        a1 * b2 - a2 * b1], dim=-1)


def norm3(a):
    """Euclidean norm of 3-vectors on the last axis."""
    a1, a2, a3 = a.unbind(-1)
    return torch.sqrt((a1 * a1 + a2 * a2) + a3 * a3)


def rsw_to_eci_matrix(pos, vel):
    """Rotation matrix M with ECI_vec = M @ RSW_vec (Solver_pos_att.m:831-847)."""
    R = pos / norm3(pos)[..., None]
    W = cross(pos, vel)
    W = W / norm3(W)[..., None]
    S = cross(W, R)
    return torch.stack([R, S, W], dim=-1)


def rsw_to_body(vec, q, R_target, V_target):
    """RSW -> ECI -> body (policy-lookup path, Solver_pos_att.m:411-415)."""
    m = rsw_to_eci_matrix(R_target, V_target)
    return matvec(quat_to_dcm(q), matvec(m, vec))


def body_to_rsw(vec, q, R_target, V_target):
    """body -> ECI -> RSW (force mapping, Solver_pos_att.m:815-823); rotation
    inverses are transposes."""
    m = rsw_to_eci_matrix(R_target, V_target)
    return matvec(m.transpose(-1, -2),
                  matvec(quat_to_dcm(q).transpose(-1, -2), vec))
