"""Relative orbital motion of a chaser about an elliptical target.

Counterpart of ``ocdp_tpu/dynamics/relmotion.py``: the reference's rollout
plant (``rates``, pos-att/Solver_pos_att.m:675-729), Curtis eq. 7.36 in the
target's co-moving RSW frame with the full time-varying radius; the target
state is propagated with the universal-variable Kepler solver at every
evaluation time, as the reference does inside its ODE callback.
"""

from __future__ import annotations

import torch

from ..utils.frames import cross, norm3
from .orbital import MU_EARTH, propagate_kepler

__all__ = ["cw_relative_rates", "target_states"]


def target_states(R0, V0, times, *, mu=MU_EARTH):
    """The target's ``(R, V)`` at each of ``times`` (a list of equally
    shaped time tensors) from one batched Kepler solve: the integrators'
    ``prepare`` hook for :func:`cw_relative_rates`'s ``target``. Each entry
    equals ``propagate_kepler(R0, V0, times[i])`` elementwise."""
    R, V = propagate_kepler(R0, V0, torch.stack(
        [torch.as_tensor(t, dtype=R0.dtype, device=R0.device)
         for t in times]), mu=mu)
    return list(zip(R.unbind(0), V.unbind(0)))


def cw_relative_rates(t, y, accel, R0, V0, target=None, *, mu=MU_EARTH):
    """d/dt of [dr (3), dv (3)] (on ``y``'s last axis) with control
    acceleration ``accel`` (km/s^2). ``target``: the target's ``(R, V)`` at
    ``t`` when already propagated (:func:`target_states`).

    Curtis eq. 7.36 with time-varying R (Solver_position.m:296-306):
      ddx = (2mu/R^3 + H^2/R^4) dx - 2 (R.V) H/R^4 dy + 2H/R^2 dvy + a_x
      ddy = -(mu/R^3 - H^2/R^4) dy + 2 (R.V) H/R^4 dx - 2H/R^2 dvx + a_y
      ddz = -mu/R^3 dz + a_z
    ``t`` may be one time for the whole batch or one per batch member.
    """
    R, V = (propagate_kepler(R0, V0, t, mu=mu) if target is None
            else target)
    nR = norm3(R)
    R1, R2, R3 = R.unbind(-1)
    V1, V2, V3 = V.unbind(-1)
    RdotV = R1 * V1 + R2 * V2 + R3 * V3
    H = norm3(cross(R, V))

    dx, dy, dz, dvx, dvy, dvz = y.unbind(-1)
    mu_t = torch.tensor(mu, dtype=nR.dtype, device=nR.device)
    nR2 = nR * nR
    nR3 = nR * nR2
    nR4 = nR2 * nR2
    dax = (2 * mu_t / nR3 + H * H / nR4) * dx - 2 * RdotV / nR4 * H * dy \
        + 2 * H / nR2 * dvy + accel[..., 0]
    day = -(mu_t / nR3 - H * H / nR4) * dy + 2 * RdotV / nR4 * H * dx \
        - 2 * H / nR2 * dvx + accel[..., 1]
    daz = -mu_t / nR3 * dz + accel[..., 2]
    return torch.stack([dvx, dvy, dvz, dax, day, daz], dim=-1)
