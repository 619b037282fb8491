"""ODE integrators of the rollouts, on tensors.

Counterpart of ``ocdp_tpu/utils/integrators.py``: fixed-step RK4, the Curtis
RKF4(5) (position-control/private/rkf45.m) and the Dormand-Prince 5(4) pair
inside MATLAB ``ode45`` (pos-att/Solver_pos_att.m:504), with the same
tableaux, step-control laws, MATLAB RelTol/AbsTol defaults, FSAL, and NaN
poisoning of an integration cut by its step budget.

States carry a leading batch axis: ``y`` is ``(B, n)`` and the times
``t0``/``t1`` are scalars or ``(B,)``. The adaptive loops are Python loops
with per-member masks: a member that has reached ``t1`` (or its step budget)
no longer changes while the others step on, which is what ``jax.vmap`` of
the JAX package's ``while_loop`` does, so a member of a batch equals the
same flight alone. The host reads one "any member still stepping" flag per
step.

``prepare``: an optional callable that every integrator calls once per
step with the step's stage times (a list; the stage times do not depend on
the state), before the first stage. It returns one entry per stage, and
stage i then calls ``f(t_i, y_i, aux[i])`` instead of ``f(t_i, y_i)``. The
rollouts use it to propagate the target orbit at all stage times in one
batched Kepler solve, elementwise the same as one solve per stage.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["rk4_step", "rkf45_integrate", "ode45_integrate",
           "adaptive_integrator", "integrator_kwargs"]


def _stages(f, prepare, times):
    """``stage(i, y)``: the derivative at stage time ``times[i]``, with the
    stage's entry of ``prepare(times)`` when ``prepare`` is given."""
    if prepare is None:
        return lambda i, y: f(times[i], y)
    aux = prepare(times)
    return lambda i, y: f(times[i], y, aux[i])


def rk4_step(f, t, y, h, *, prepare=None):
    """One classical RK4 step of ``dy/dt = f(t, y)``."""
    stage = _stages(f, prepare, [t, t + h / 2, t + h / 2, t + h])
    k1 = stage(0, y)
    k2 = stage(1, y + (h / 2) * k1)
    k3 = stage(2, y + (h / 2) * k2)
    k4 = stage(3, y + h * k3)
    return y + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)


# Fehlberg coefficients (Curtis, Orbital Mechanics; rkf45.m:27-47)
_A = np.array([0, 1 / 4, 3 / 8, 12 / 13, 1, 1 / 2])
_B = np.array([
    [0, 0, 0, 0, 0],
    [1 / 4, 0, 0, 0, 0],
    [3 / 32, 9 / 32, 0, 0, 0],
    [1932 / 2197, -7200 / 2197, 7296 / 2197, 0, 0],
    [439 / 216, -8, 3680 / 513, -845 / 4104, 0],
    [-8 / 27, 2, -3544 / 2565, 1859 / 4104, -11 / 40],
])
_C4 = np.array([25 / 216, 0, 1408 / 2565, 2197 / 4104, -1 / 5, 0])
_C5 = np.array([16 / 135, 0, 6656 / 12825, 28561 / 56430, -9 / 50, 2 / 55])

# Dormand-Prince 5(4) tableau, the pair inside MATLAB ode45
_DP_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])
_DP_A = np.array([
    [0, 0, 0, 0, 0, 0],
    [1 / 5, 0, 0, 0, 0, 0],
    [3 / 40, 9 / 40, 0, 0, 0, 0],
    [44 / 45, -56 / 15, 32 / 9, 0, 0, 0],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0, 0],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656, 0],
    [35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84],
])
# 5th-order solution weights (row 7 of A: FSAL, k7 = f(t+h, y5))
_DP_B5 = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784,
                   11 / 84, 0])
# error weights b5 - b4 (MATLAB ode45's E vector)
_DP_E = np.array([71 / 57600, 0, -71 / 16695, 71 / 1920, -17253 / 339200,
                  22 / 525, -1 / 40])


def _weighted(coeffs, ks):
    """sum_i coeffs[i] * ks[i], float32 coefficients, summed in order."""
    acc = None
    for c, k in zip(coeffs, ks):
        term = float(np.float32(c)) * k
        acc = term if acc is None else acc + term
    return acc


def _times(t0, t1, y0):
    batch = y0.shape[:-1]
    t0 = torch.as_tensor(t0, dtype=y0.dtype, device=y0.device).expand(batch)
    t1 = torch.as_tensor(t1, dtype=y0.dtype, device=y0.device).expand(batch)
    return t0, t1


def _poison_truncated(t, t1, y):
    # MATLAB's integrators warn when the tolerances cannot be met within the
    # step budget; a truncated integration returns NaN, not y(t < t1)
    nan = torch.full_like(t, float("nan"))
    return torch.where(t < t1, nan, torch.ones_like(t))[..., None] * y


def rkf45_integrate(f, t0, t1, y0, *, tol=1e-8, max_steps=10_000,
                    prepare=None):
    """Adaptive RKF4(5) from ``t0`` to ``t1``; returns ``y(t1)``.

    The reference's step control (rkf45.m:73-113): initial step
    ``(t1-t0)/100``; truncation error ``te = h*(C4-C5).k`` against
    ``tol*max(|y|, 1)``; accepted steps advance with the 5th-order
    combination; ``h_new = h*min((te_allowed/te_max)^(1/5), 4)``.
    """
    t, t1 = _times(t0, t1, y0)
    y = y0
    h = (t1 - t) / 100.0
    steps = torch.zeros_like(t, dtype=torch.int32)
    while True:
        live = (t < t1) & (steps < max_steps)
        if not bool(live.any()):
            return _poison_truncated(t, t1, y)
        h = torch.minimum(h, t1 - t)
        stage = _stages(f, prepare, [t + float(np.float32(_A[i])) * h
                                     for i in range(6)])
        ks = []
        for i in range(6):
            yi = y
            for j in range(i):
                if _B[i, j] != 0.0:
                    yi = yi + (h * float(np.float32(_B[i, j])))[..., None] \
                        * ks[j]
            ks.append(stage(i, yi))
        te = h[..., None] * _weighted(_C4 - _C5, ks)
        y5 = y + h[..., None] * _weighted(_C5, ks)

        ymax = torch.clamp(torch.amax(torch.abs(y), dim=-1), min=1.0)
        te_allowed = tol * ymax
        te_max = torch.amax(torch.abs(te), dim=-1)
        delta = (te_allowed / (te_max + 1e-30)) ** 0.2

        accept = live & (te_max <= te_allowed)
        t = torch.where(accept, t + h, t)
        y = torch.where(accept[..., None], y5, y)
        h = torch.where(live, h * torch.clamp(delta, max=4.0), h)
        steps = steps + live.to(torch.int32)


def ode45_integrate(f, t0, t1, y0, *, rtol=1e-3, atol=1e-6,
                    max_steps=10_000, prepare=None):
    """Adaptive Dormand-Prince 5(4) from ``t0`` to ``t1``; returns ``y(t1)``.

    MATLAB ``ode45``'s defaults (RelTol=1e-3, AbsTol=1e-6):

    * error ``err = h * max|E.k / max(max(|y|,|y5|), thr)|``,
      ``thr = atol/rtol``; accept when ``err <= rtol``;
    * initial step ``min(hmax, t1-t0)`` shrunk to ``1/rh``,
      ``rh = max|f0/max(|y0|,thr)| / (0.8 rtol^{1/5})``,
      ``hmax = 0.1 (t1-t0)``;
    * accepted steps grow at most 5x (``h /= max(1.25 (err/rtol)^{1/5},
      0.2)``); the first rejection shrinks by ``max(0.1, 0.8
      (rtol/err)^{1/5})``, repeat rejections halve;
    * FSAL: the 7th stage of an accepted step is the next step's ``k1``.
    """
    t, t1 = _times(t0, t1, y0)
    y = y0
    thr = atol / rtol
    hmax = 0.1 * (t1 - t)

    k1 = _stages(f, prepare, [t])(0, y)
    rh = torch.amax(torch.abs(k1) / torch.clamp(torch.abs(y), min=thr),
                    dim=-1) / (0.8 * rtol ** 0.2)
    h = torch.minimum(hmax, t1 - t)
    h = torch.where(h * rh > 1.0, 1.0 / rh, h)
    rejected = torch.zeros_like(t, dtype=torch.bool)
    steps = torch.zeros_like(t, dtype=torch.int32)
    while True:
        live = (t < t1) & (steps < max_steps)
        if not bool(live.any()):
            return _poison_truncated(t, t1, y)
        h = torch.minimum(h, t1 - t)
        stage = _stages(f, prepare, [t + float(np.float32(_DP_C[i])) * h
                                     for i in range(1, 7)])
        ks = [k1]
        for i in range(1, 7):
            yi = y
            for j in range(i):
                if _DP_A[i, j] != 0.0:
                    yi = yi + (h * float(np.float32(_DP_A[i, j])))[..., None] \
                        * ks[j]
            ks.append(stage(i - 1, yi))
        y5 = y + h[..., None] * _weighted(_DP_B5, ks)
        ek = _weighted(_DP_E, ks)
        denom = torch.clamp(torch.maximum(torch.abs(y), torch.abs(y5)),
                            min=thr)
        err = h * torch.amax(torch.abs(ek / denom), dim=-1)

        accept = err <= rtol
        grow = h / torch.clamp(1.25 * (err / rtol + 1e-30) ** 0.2, min=0.2)
        shrink1 = h * torch.clamp(
            0.8 * (torch.full_like(err, rtol) / (err + 1e-30)) ** 0.2,
            min=0.1)
        shrink = torch.where(rejected, 0.5 * h, shrink1)
        h_new = torch.minimum(torch.where(accept, grow, shrink), hmax)

        step = live & accept
        t = torch.where(step, t + h, t)
        y = torch.where(step[..., None], y5, y)
        k1 = torch.where(step[..., None], ks[6], k1)
        h = torch.where(live, h_new, h)
        rejected = torch.where(live, ~accept, rejected)
        steps = steps + live.to(torch.int32)


_ADAPTIVE = {"rkf45": rkf45_integrate, "ode45": ode45_integrate}


def adaptive_integrator(name: str):
    """Resolve an adaptive-integrator name: 'rkf45' (Curtis/Fehlberg) or
    'ode45' (Dormand-Prince, MATLAB ode45 defaults)."""
    try:
        return _ADAPTIVE[name]
    except KeyError:
        raise ValueError(
            f"unknown integrator {name!r}; choose from {sorted(_ADAPTIVE)}"
        ) from None


def _rk4_span(f, t0, t1, y0, *, prepare=None):
    """Fixed-step bridge: ONE classical RK4 step across [t0, t1]."""
    return rk4_step(f, t0, y0, t1 - t0, prepare=prepare)


def integrator_kwargs(name: str, tol=None):
    """Resolve ``(integrator_fn, tolerance_kwargs)`` for the rollouts.

    'ode45' / 'rkf45' are the adaptive pairs; 'rk4' takes ONE classical RK4
    step per stage interval (the serving mode). ``tol=None`` keeps each
    pair's reference defaults (rkf45: 1e-8; ode45: RelTol=1e-3 /
    AbsTol=1e-6); an explicit ``tol`` sets rkf45's ``tol``, or ode45's
    RelTol with AbsTol at MATLAB's default 1e-3 ratio. 'rk4' rejects one.
    """
    if name == "rk4":
        if tol is not None:
            raise ValueError("'rk4' is fixed-step; ode_tol does not apply")
        return _rk4_span, {}
    fn = adaptive_integrator(name)
    if tol is None:
        return fn, ({"tol": 1e-8} if name == "rkf45" else {})
    if name == "rkf45":
        return fn, {"tol": tol}
    return fn, {"rtol": tol, "atol": 1e-3 * tol}
