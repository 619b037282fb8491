"""Universal-variable Keplerian propagation (Curtis algorithms) on tensors.

Counterpart of ``ocdp_tpu/dynamics/orbital.py``: the reference's
``private/`` orbital library (stumpC, stumpS, kepler_U, f_and_g,
fDot_and_gDot, sv_from_coe) with the same branchless Stumpff functions (a
series near z = 0) and ``mu`` as an argument. Everything is float32, as in
the JAX package. Constants that divide or are divided by a tensor are made
tensors on that tensor's device first: PyTorch computes ``scalar / t`` as
``scalar * (1 / t)``, which rounds differently.

:func:`kepler_universal` iterates Newton per element with a mask: an element
whose step met the tolerance no longer changes, which is what ``jax.vmap``
of the JAX package's ``while_loop`` does, so a batch element equals the same
solve alone. The host reads the "any element still active" flag once every
:data:`NEWTON_CHECK_EVERY` iterations.

The tolerance (1e-8 on the Newton step) is below float32 resolution for
|x| near 1, so the loop ends only when a step comes out exactly 0. With the
card's cos/sin/cosh/sinh the iterates can instead settle on a fixed point or
alternate between two neighbouring floats, and the reference loop then runs
to its ``max_iter`` cap. Each iterate is a function of the one before, so
such a cycle repeats exactly: the solve detects it and jumps to the iterate
the capped loop ends on, the same value, without the remaining iterations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.frames import norm3

__all__ = [
    "MU_EARTH",
    "stumpff_C",
    "stumpff_S",
    "kepler_universal",
    "lagrange_f_g",
    "lagrange_fdot_gdot",
    "propagate_kepler",
    "sv_from_coe",
    "target_orbit_R0V0",
]

MU_EARTH = 398600.0  # km^3/s^2 (position-control/Solver_position.m:192)
_R_EARTH = 6378.0    # km (Solver_position.m:315)
# masked Newton iterations between two host reads of the active flag; the
# reference orbit's solves converge in 1-3 iterations
NEWTON_CHECK_EVERY = 3


def _c(value, like):
    """``value`` as a 0-dim tensor of ``like``'s dtype and device."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _stumpff_parts(z):
    small = torch.abs(z) < 1e-4
    zs = torch.where(small, torch.ones_like(z), z)
    return small, torch.abs(zs), torch.sqrt(torch.abs(zs))


def _stumpff_C(z, small, az, sz):
    pos = (1.0 - torch.cos(sz)) / az
    neg = (torch.cosh(sz) - 1.0) / az
    series = 0.5 - z / 24.0 + z * z / 720.0
    return torch.where(small, series, torch.where(z > 0, pos, neg))


def _stumpff_S(z, small, sz):
    sz3 = sz * (sz * sz)
    pos = (sz - torch.sin(sz)) / sz3
    neg = (torch.sinh(sz) - sz) / sz3
    series = 1.0 / 6.0 - z / 120.0 + z * z / 5040.0
    return torch.where(small, series, torch.where(z > 0, pos, neg))


def _stumpff_CS(z):
    """C(z) and S(z) sharing their common terms."""
    small, az, sz = _stumpff_parts(z)
    return _stumpff_C(z, small, az, sz), _stumpff_S(z, small, sz)


def stumpff_C(z):
    """Stumpff C(z) (Curtis eq. 3.53; stumpC.m:11-17), branchless."""
    small, az, sz = _stumpff_parts(z)
    return _stumpff_C(z, small, az, sz)


def stumpff_S(z):
    """Stumpff S(z) (Curtis eq. 3.52; stumpS.m:11-17), branchless."""
    small, _, sz = _stumpff_parts(z)
    return _stumpff_S(z, small, sz)


def kepler_universal(dt, r0, vr0, alpha, *, mu=MU_EARTH, tol=1e-8,
                     max_iter=1000):
    """Newton solve of the universal Kepler equation for the anomaly x.

    Same iteration as kepler_U.m:20-36: x0 = sqrt(mu)*|alpha|*dt, step F/F'
    until |step| < tol, at most ``max_iter + 1`` steps per element.
    """
    dt = torch.as_tensor(dt, dtype=alpha.dtype, device=alpha.device)
    smu = torch.sqrt(_c(mu, alpha))
    x = smu * torch.abs(alpha) * dt
    shape = torch.broadcast_shapes(x.shape, r0.shape, vr0.shape)
    x = x.expand(shape).clone()
    x_before = torch.full_like(x, float("nan"))   # the iterate before x
    ratio = torch.ones_like(x)
    n = torch.zeros(shape, dtype=torch.int32, device=x.device)
    c1 = r0 * vr0 / smu
    c2 = 1 - alpha * r0
    while True:
        for _ in range(NEWTON_CHECK_EVERY):
            active = (torch.abs(ratio) > tol) & (n <= max_iter)
            z = alpha * x * x
            C, S = _stumpff_CS(z)
            F = c1 * x * x * C + c2 * (x * (x * x)) * S + r0 * x - smu * dt
            dFdx = c1 * x * (1 - z * S) + c2 * x * x * C + r0
            step = F / dFdx
            x_new = x - step
            # a cycle: the capped loop ends on x_new after an even number
            # of further steps and on x after an odd number
            fixed = active & (x_new == x)
            pair = active & (x_new == x_before)
            odd_left = (max_iter - n) % 2 == 1
            x_new = torch.where(pair & odd_left, x, x_new)
            x_before = torch.where(active, x, x_before)
            x = torch.where(active, x_new, x)
            ratio = torch.where(active, step, ratio)
            n = torch.where(fixed | pair, max_iter + 1,
                            n + active.to(torch.int32))
        if not bool(((torch.abs(ratio) > tol) & (n <= max_iter)).any()):
            return x


def lagrange_f_g(x, t, r0, alpha, *, mu=MU_EARTH):
    """Lagrange f, g (Curtis eq. 3.69a/b; f_and_g.m:13-16)."""
    z = alpha * x * x
    f = 1.0 - x * x / r0 * stumpff_C(z)
    g = t - (x * (x * x)) * stumpff_S(z) / torch.sqrt(_c(mu, x))
    return f, g


def lagrange_fdot_gdot(x, r, r0, alpha, *, mu=MU_EARTH):
    """Lagrange fdot, gdot (Curtis eq. 3.69c/d; fDot_and_gDot.m:14-17)."""
    z = alpha * x * x
    fdot = torch.sqrt(_c(mu, x)) / (r * r0) * (z * stumpff_S(z) - 1.0) * x
    gdot = 1.0 - x * x / r * stumpff_C(z)
    return fdot, gdot


def propagate_kepler(R0, V0, t, *, mu=MU_EARTH):
    """Propagate a two-body state vector by ``t`` seconds (Curtis alg. 3.4);
    the reference's ``update_RV_target`` (Solver_pos_att.m:754-782).

    ``R0``/``V0``: (3,) tensors; ``t``: a tensor of any shape. Returns
    ``(R, V)`` shaped ``(*t.shape, 3)``.
    """
    r0 = norm3(R0)
    v0 = norm3(V0)
    vr0 = (R0[0] * V0[0] + R0[1] * V0[1] + R0[2] * V0[2]) / r0
    alpha = 2.0 / r0 - v0 * v0 / _c(mu, v0)
    t = torch.as_tensor(t, dtype=R0.dtype, device=R0.device)
    x = kepler_universal(t, r0, vr0, alpha, mu=mu)
    f, g = lagrange_f_g(x, t, r0, alpha, mu=mu)
    R = f[..., None] * R0 + g[..., None] * V0
    r = norm3(R)
    fdot, gdot = lagrange_fdot_gdot(x, r, r0, alpha, mu=mu)
    V = fdot[..., None] * R0 + gdot[..., None] * V0
    return R, V


def sv_from_coe(h, e, RA, incl, w, TA, *, mu=MU_EARTH):
    """State vector from classical orbital elements (Curtis alg. 4.5), in
    sv_from_coe.m:25-31's order: angular momentum h, eccentricity e, right
    ascension RA, inclination incl, argument of perigee w, true anomaly TA
    (radians; float32 tensors). Returns (r, v) in the geocentric equatorial
    frame."""
    h, RA, incl, w, TA = (torch.as_tensor(a, dtype=torch.float32)
                          for a in (h, RA, incl, w, TA))
    cT, sT = torch.cos(TA), torch.sin(TA)
    zero = torch.zeros_like(cT)
    rp = (h * h / mu) / (1.0 + e * cT) * torch.stack([cT, sT, zero])
    vp = (_c(mu, h) / h) * torch.stack([-sT, e + cT, zero])

    def rot3(a):
        c, s = torch.cos(a), torch.sin(a)
        z, o = torch.zeros_like(c), torch.ones_like(c)
        return torch.stack([torch.stack([c, s, z]), torch.stack([-s, c, z]),
                            torch.stack([z, z, o])])

    ci, si = torch.cos(incl), torch.sin(incl)
    z, o = torch.zeros_like(ci), torch.ones_like(ci)
    R1_i = torch.stack([torch.stack([o, z, z]), torch.stack([z, ci, si]),
                        torch.stack([z, -si, ci])])
    Q_pX = (rot3(w) @ R1_i @ rot3(RA)).T
    return Q_pX @ rp, Q_pX @ vp


def target_orbit_R0V0(*, perigee_alt=300.0, e=0.1, mu=MU_EARTH):
    """The reference target orbit: 300-km-perigee, e = 0.1, equatorial
    (get_target_R0V0, Solver_pos_att.m:734-752). Returns float32 numpy
    ``(R0, V0)``, computed on the CPU."""
    rp = _R_EARTH + perigee_alt
    ra = rp * (1 + e) / (1 - e)
    h = torch.sqrt(torch.tensor(2 * mu * rp * ra / (ra + rp),
                                dtype=torch.float32))
    zero = torch.tensor(0.0)
    R0, V0 = sv_from_coe(h, e, zero, zero, zero, zero, mu=mu)
    return R0.numpy().astype(np.float32), V0.numpy().astype(np.float32)

