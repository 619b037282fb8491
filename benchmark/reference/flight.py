"""The pos-att closed loop's plant and policy lookup, in float64.

The 13-state plant of Solver_pos_att.m:452-730: the chaser's position and
velocity relative to the target in the target's RSW frame (km, km/s; the
relative-motion equations of Curtis eq. 7.36 with the target's radius
varying in time), a scalar-last attitude quaternion and the body rates,
with the thrusters' forces applied as a body-frame acceleration (N/kg,
unscaled, as the reference does) and moments. The target flies the
reference's orbit (300 km perigee, e = 0.1, equatorial), propagated here
by Kepler's equation. Each 5 ms stage is one classical RK4 step with the
controls held. The policy lookup maps a state to each channel's
(x, v, theta, omega) through the target's initial RSW frame and the body
attitude (:404-447).

The reference judges the port's flights two ways: stage by stage, each
step from the port's own state and forces (teacher forcing), and whole,
by flying the forces the port flew from its starts in float64
(:func:`replay`), independent of every state the port computed.
"""

from __future__ import annotations

import math

import torch

__all__ = ["target_orbit", "target_states", "rk4_step", "replay",
           "controls", "channel_queries", "nearest", "fly"]

MU = 398600.0
R_EARTH = 6378.0


def target_orbit(perigee_alt: float = 300.0, e: float = 0.1):
    """Perigee radius, eccentricity and the state at perigee (t = 0)."""
    rp = R_EARTH + perigee_alt
    ra = rp * (1 + e) / (1 - e)
    h = math.sqrt(2 * MU * rp * ra / (ra + rp))
    return rp, e, (rp, 0.0, 0.0), (0.0, MU / h * (1 + e), 0.0)


def target_states(t: torch.Tensor, perigee_alt: float = 300.0,
                  e: float = 0.1):
    """Target position and velocity (``(*t.shape, 3)``, km, km/s) ``t``
    seconds after perigee: Kepler's equation by Newton in float64."""
    rp, e, _, _ = target_orbit(perigee_alt, e)
    a = rp / (1 - e)
    n = math.sqrt(MU / a ** 3)
    M = n * t.double()
    E = M.clone()
    for _ in range(30):
        E = E - (E - e * torch.sin(E) - M) / (1 - e * torch.cos(E))
    b = a * math.sqrt(1 - e * e)
    r = a * (1 - e * torch.cos(E))
    R = torch.stack([a * (torch.cos(E) - e), b * torch.sin(E),
                     torch.zeros_like(E)], -1)
    k = math.sqrt(MU * a) / r
    V = torch.stack([-k * torch.sin(E), k * math.sqrt(1 - e * e)
                     * torch.cos(E), torch.zeros_like(E)], -1)
    return R, V


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def rsw_matrix(R, V):
    """Columns: the radial, along-track and orbit-normal unit vectors."""
    r = R / R.norm(dim=-1, keepdim=True)
    w = _cross(R, V)
    w = w / w.norm(dim=-1, keepdim=True)
    return torch.stack([r, _cross(w, r), w], -1)


def dcm(q):
    """ECI to body, from a scalar-last quaternion."""
    q1, q2, q3, q4 = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (q2 * q2 + q3 * q3), 2 * (q1 * q2 + q3 * q4),
                     2 * (q1 * q3 - q2 * q4)], -1),
        torch.stack([2 * (q2 * q1 - q3 * q4), 1 - 2 * (q1 * q1 + q3 * q3),
                     2 * (q2 * q3 + q1 * q4)], -1),
        torch.stack([2 * (q3 * q1 + q2 * q4), 2 * (q3 * q2 - q1 * q4),
                     1 - 2 * (q1 * q1 + q2 * q2)], -1)], -2)


def _mv(m, v):
    return (m @ v[..., None])[..., 0]


def controls(cfg: dict, y, forces, m_rsw):
    """The RSW acceleration and the body moments of the channels' forces
    ``forces (..., 3, 4)`` (x, y, z; each (f0, f1, f6, f7)) at states
    ``y``: x's thrusters push along body x and turn about y, y's along y
    about z, z's along z about x."""
    arm, mass = cfg["moment_arm"], cfg["mass"]
    total = forces.sum(-1)                                   # (..., 3)
    mom = (forces[..., 0] - forces[..., 1] + forces[..., 2]
           - forces[..., 3]) * arm
    u_m = torch.stack([mom[..., 2], mom[..., 0], mom[..., 1]], -1)
    a_body = total / mass
    a_rsw = _mv(m_rsw.transpose(-1, -2),
                _mv(dcm(y[..., 6:10]).transpose(-1, -2), a_body))
    return a_rsw * cfg["accel_scale"], u_m


def rates(cfg: dict, y, a_rsw, u_m, R, V):
    J64 = torch.tensor(_inertia(cfg), dtype=torch.float64, device=y.device)
    J, Jinv = J64.to(y.dtype), torch.linalg.inv(J64).to(y.dtype)
    R, V = R.to(y.dtype), V.to(y.dtype)
    nR = R.norm(dim=-1)
    H = _cross(R, V).norm(dim=-1)
    RdV = (R * V).sum(-1)
    dx, dy, dz, dvx, dvy, dvz = y[..., :6].unbind(-1)
    dax = (2 * MU / nR ** 3 + H * H / nR ** 4) * dx \
        - 2 * RdV / nR ** 4 * H * dy + 2 * H / nR ** 2 * dvy + a_rsw[..., 0]
    day = -(MU / nR ** 3 - H * H / nR ** 4) * dy \
        + 2 * RdV / nR ** 4 * H * dx - 2 * H / nR ** 2 * dvx + a_rsw[..., 1]
    daz = -MU / nR ** 3 * dz + a_rsw[..., 2]
    q1, q2, q3, q4 = y[..., 6:10].unbind(-1)
    w = y[..., 10:13]
    w1, w2, w3 = w.unbind(-1)
    qdot = 0.5 * torch.stack([w3 * q2 - w2 * q3 + w1 * q4,
                              -w3 * q1 + w1 * q3 + w2 * q4,
                              w2 * q1 - w1 * q2 + w3 * q4,
                              -w1 * q1 - w2 * q2 - w3 * q3], -1)
    wdot = _mv(Jinv, u_m - _cross(w, _mv(J, w)))
    return torch.cat([torch.stack([dvx, dvy, dvz, dax, day, daz], -1),
                      qdot, wdot], -1)


def _inertia(cfg: dict):
    d, o = cfg["inertia_diag"], cfg["inertia_offdiag"]
    return [[d[0], o[0], o[1]], [o[0], d[1], o[2]], [o[1], o[2], d[2]]]


def _rsw0(y):
    R0, V0 = (torch.tensor(v, dtype=y.dtype, device=y.device)
              for v in target_orbit()[2:])
    return rsw_matrix(R0, V0)


def rk4_step(cfg: dict, y, forces, t0, target=None):
    """One RK4 stage from states ``y (..., 13)`` at times ``t0`` (broadcast
    to ``y``'s batch) under the held controls of ``forces``; ``target``:
    the target's states at ``t0``, ``t0 + h/2`` and ``t0 + h`` when known."""
    h = cfg["h"]
    a_rsw, u_m = controls(cfg, y, forces, _rsw0(y))
    (Ra, Va), (Rb, Vb), (Rc, Vc) = target or (
        target_states(t0), target_states(t0 + h / 2), target_states(t0 + h))
    k1 = rates(cfg, y, a_rsw, u_m, Ra, Va)
    k2 = rates(cfg, y + h / 2 * k1, a_rsw, u_m, Rb, Vb)
    k3 = rates(cfg, y + h / 2 * k2, a_rsw, u_m, Rb, Vb)
    k4 = rates(cfg, y + h * k3, a_rsw, u_m, Rc, Vc)
    return y + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def replay(cfg: dict, x0s, F):
    """The flights of ``F (B, N-1, 12)`` (forces in the port's layout) from
    the starts ``x0s (B, 13)``, in float64: ``X (B, N, 13)``."""
    y = torch.as_tensor(x0s, device=F.device).double()
    per = torch.stack([F[..., [0, 1, 6, 7]], F[..., [2, 3, 8, 9]],
                       F[..., [4, 5, 10, 11]]], -2).double()  # (B, n, 3, 4)
    h, n = cfg["h"], F.shape[1]
    t = torch.arange(n, dtype=torch.float64, device=F.device) * h
    R, V = target_states(torch.stack([t, t + h / 2, t + h], 1))  # (n, 3, 3)
    X = [y]
    for k in range(n):
        tk = [(R[k, j], V[k, j]) for j in range(3)]
        y = rk4_step(cfg, y, per[:, k], None, tk)
        X.append(y)
    return torch.stack(X, 1)


def channel_queries(y):
    """Per channel x, y, z the (x, v, theta, omega) its policy is looked
    up at: ``(..., 3, 4)``."""
    m = _rsw0(y)
    c = dcm(y[..., 6:10])
    xb = _mv(c, _mv(m, y[..., 0:3]))
    vb = _mv(c, _mv(m, y[..., 3:6]))
    ang = 2.0 * torch.asin(torch.clamp(y[..., 6:9], -1.0, 1.0))
    w = y[..., 10:13]
    att = [1, 2, 0]
    return torch.stack([xb, vb, ang[..., att], w[..., att]], -1)


def nearest(axis: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Nearest grid index; a query halfway between two points takes the
    lower (MATLAB's 'nearest'); past an edge, the edge."""
    n = axis.numel()
    lo = (torch.searchsorted(axis, q.contiguous(), right=True) - 1) \
        .clamp(0, n - 2)
    return lo + ((q - axis[lo]) > (axis[lo + 1] - q)).long()


def fly(cfg: dict, argmin, axes, forces, x0s, n_stages: int, dtype,
        store=None):
    """Closed-loop flights of a controller: ``argmin`` per channel x, y, z
    in the row/lane layout ``(v omega, x theta)``, their axes and force
    tables; every stage looks the forces up at the nearest cell and takes
    one RK4 stage, computed in ``dtype``, the states kept in ``store``
    (``dtype`` when None). Returns ``X (B, N, 13)`` and the forces ``F
    (B, N-1, 12)`` in the port's layout (x, y, z's first two thrusters,
    then their last two)."""
    dev = argmin.device
    store = store or dtype
    y = torch.as_tensor(x0s, device=dev).to(store).to(dtype)
    ax = [[torch.as_tensor(a, device=dev).to(dtype) for a in ch] for ch in axes]
    tab = [torch.as_tensor(f, device=dev).to(dtype) for f in forces]
    X, F = [y], []
    for k in range(n_stages - 1):
        qs = channel_queries(y)
        per = []
        for c in range(3):
            ix, iv, it, iw = (nearest(ax[c][j], qs[..., c, j]) for j in range(4))
            n_w, n_t = ax[c][3].numel(), ax[c][2].numel()
            a = argmin[c][iv * n_w + iw, ix * n_t + it].long()
            per.append(tab[c][a])
        per = torch.stack(per, -2)                           # (B, 3, 4)
        t0 = torch.full(y.shape[:-1], k * cfg["h"], dtype=torch.float64,
                        device=dev)
        y = rk4_step(cfg, y, per, t0).to(store).to(dtype)
        X.append(y)
        F.append(torch.cat([per[..., :, :2].reshape(*y.shape[:-1], 6),
                            per[..., :, 2:].reshape(*y.shape[:-1], 6)], -1))
    return torch.stack(X, 1), torch.stack(F, 1)
