"""Arctangent, arcsine and the attitude lanes' quaternion step, op by op.

Counterpart of ``ocdp_tpu/ops/kernelmath.py``: the Cephes ``atanf`` kernel
(range reduction at tan(pi/8) and tan(3pi/8), then a degree-9 odd minimax
polynomial), with quadrant fixes for ``atan2`` and
``asin(x) = atan2(x, sqrt(1 - x^2))``. The 6-D kernel's lane-recompute mode
(``csrc/backup6d.cu``, B.5) evaluates the Euler readback of the attitude
quaternion step inside the kernel with ``__device__`` twins of these
functions, and the plain version and the tap-liveness pass evaluate them
here. Every operation is one separately rounded PyTorch op in the order the
``__device__`` twin runs it; every division divides a tensor by a tensor
(PyTorch on a CUDA device multiplies by the reciprocal of a Python-scalar
divisor), and every constant is a float32 value. So on a CUDA device the
two sides agree bitwise.

Accuracy against float64 (``tests/test_torch_kernelmath.py``): about 4e-7
rad for ``atan2_f32`` over all quadrants, 1e-6 for ``asin_f32`` on
[-0.9999, 0.9999].
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["atan_f32", "atan2_f32", "asin_f32", "quat_step_readback"]


def _f32(x: float) -> float:
    """The float32 value of ``x``, as a Python float (exact in any op)."""
    return float(np.float32(x))


_PI = _f32(3.14159265358979323846)
_PI_2 = _f32(3.14159265358979323846 / 2.0)
_PI_4 = _f32(3.14159265358979323846 / 4.0)
_TAN_3PI_8 = _f32(2.414213562373095)
_TAN_PI_8 = _f32(0.4142135623730950)
_TINY = _f32(1e-30)
_P = (_f32(8.05374449538e-2), _f32(1.38776856032e-1), _f32(1.99777106478e-1),
      _f32(3.33329491539e-1))


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(like, value)


def _atan_core(z: torch.Tensor) -> torch.Tensor:
    """Minimax odd polynomial for atan on |z| <= tan(pi/8)."""
    z2 = z * z
    p = ((z2 * _P[0] - _P[1]) * z2 + _P[2]) * z2 - _P[3]
    return p * z2 * z + z


def atan_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 arctangent by Cephes range reduction."""
    x = torch.as_tensor(x, dtype=torch.float32)
    sign = torch.where(x < 0, _full(x, -1.0), _full(x, 1.0))
    ax = torch.abs(x)
    big = ax > _TAN_3PI_8
    mid = ax > _TAN_PI_8
    # the 1/ax and (ax-1)/(ax+1) reductions, guarded against ax == 0
    safe = torch.maximum(ax, _full(ax, _TINY))
    z = torch.where(big, _full(safe, -1.0) / safe,
                    torch.where(mid, (ax - 1.0) / (ax + 1.0), ax))
    y0 = torch.where(big, _full(x, _PI_2),
                     torch.where(mid, _full(x, _PI_4), _full(x, 0.0)))
    return sign * (y0 + _atan_core(z))


def atan2_f32(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 four-quadrant arctangent, with ``torch.atan2``'s conventions
    on finite inputs: atan2(0, +x) = 0, atan2(0, -x) = pi (-pi for y = -0
    is not kept: the sign of y carries only for y < 0), atan2(+-y, 0) =
    +-pi/2, atan2(0, 0) = 0."""
    y = torch.as_tensor(y, dtype=torch.float32)
    x = torch.as_tensor(x, dtype=torch.float32)
    safe_x = torch.where(x == 0, _full(x, 1.0), x)
    base = atan_f32(y / safe_x)
    ysign = torch.where(y < 0, _full(y, -1.0), _full(y, 1.0))
    out = torch.where(x > 0, base, base + ysign * _PI)
    out_x0 = torch.where(y == 0, _full(y, 0.0), ysign * _PI_2)
    return torch.where(x == 0, out_x0, out)


def asin_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 arcsine on [-1, 1]; inputs are clamped to [-1, 1]."""
    x = torch.clamp(torch.as_tensor(x, dtype=torch.float32), -1.0, 1.0)
    return atan2_f32(x, torch.sqrt(torch.clamp(1.0 - x * x, min=0.0)))


def quat_step_readback(h: float, q, w1, w2, w3, atan2=torch.atan2,
                       asin=torch.asin):
    """One Euler step of the kirk-q kinematics under body rates (w1, w2,
    w3), renormalization, and the Euler-angle readback
    (attitude-control/Solver_attitude.m:477-489, 525-556); broadcast-shaped.

    ``atan2``/``asin``: ``torch.atan2``/``torch.asin`` for the stored plan,
    :func:`atan2_f32`/:func:`asin_f32` for the lane recompute, whose CUDA
    twin runs these operations in this order. Squares are products and the
    renormalization divides tensor by tensor."""
    q1, q2, q3, q4 = q
    q1n = q1 + h * 0.5 * (w3 * q2 - w2 * q3 + w1 * q4)
    q2n = q2 + h * 0.5 * (-w3 * q1 + w1 * q3 + w2 * q4)
    q3n = q3 + h * 0.5 * (w2 * q1 - w1 * q2 + w3 * q4)
    q4n = q4 + h * 0.5 * (-w1 * q1 - w2 * q2 - w3 * q3)
    norm = torch.sqrt(q1n * q1n + q2n * q2n + q3n * q3n + q4n * q4n)
    q1n, q2n, q3n, q4n = q1n / norm, q2n / norm, q3n / norm, q4n / norm
    yaw = atan2(2 * (q3n * q2n + q4n * q1n),
                q4n * q4n + q3n * q3n - q2n * q2n - q1n * q1n)
    pitch = asin(torch.clamp(-2 * (q3n * q1n - q4n * q2n), -1.0, 1.0))
    roll = atan2(2 * (q2n * q1n + q4n * q3n),
                 q4n * q4n - q3n * q3n - q2n * q2n + q1n * q1n)
    return yaw, pitch, roll
