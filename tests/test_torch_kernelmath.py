"""Port kernelmath (ocdp_tpu_torch/ops/kernelmath.py) and the lane recompute's
locate (ops/backup6d.py::affine_locate) vs the JAX package and float64, on
the CPU.

* ``atan_f32``, ``atan2_f32``, ``asin_f32`` against the JAX package's twins
  within 2 ulp (asin given the same sqrt; with its own, 4 ulp: PyTorch's
  CPU sqrt is not always correctly rounded), and against numpy float64
  within tests/test_kernelmath.py's
  bounds (5e-7 rad for atan and atan2 over all quadrants, 1.5e-6 for asin on
  [-0.9999, 0.9999]), axis and quadrant cases included.
* The recompute's Euler coordinates (``quat_step_readback`` with the
  kernelmath trig) against JAX's ``_AttitudeLaneFn`` within 2e-6 rad, and
  the affine locate against JAX's ``_affine_locate``: ``lo`` equal, ``frac``
  within 1 ulp of 1.
* The stored plan's readback is unchanged by writing squares as products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu.models import attitude as jatt
from ocdp_tpu.ops import kernelmath as jkm
from ocdp_tpu.ops import pallas_backup6 as jpb
from ocdp_tpu_torch.ops import kernelmath as tkm
from ocdp_tpu_torch.ops.backup6d import affine_locate

torch.set_num_threads(2)

ULP = np.float32(2.0**-23)


def _ulps(got, want):
    """|got - want| in units of the last place of want (float32)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    spacing = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    return np.abs(got - want) / np.maximum(spacing, np.spacing(np.float32(0)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


ATAN_X = np.concatenate([
    np.linspace(-50, 50, 20001), np.logspace(-8, 2, 1000),
    -np.logspace(-8, 2, 1000),
    [0.0, 0.4142135623730950, -0.4142135623730950, 2.414213562373095]
]).astype(np.float32)


def test_atan_matches_jax_and_float64():
    got = tkm.atan_f32(_t(ATAN_X)).numpy()
    assert _ulps(got, np.asarray(jkm.atan_f32(jnp.asarray(ATAN_X)))).max() \
        <= 2
    assert np.abs(got - np.arctan(ATAN_X.astype(np.float64))).max() < 5e-7


def test_atan2_all_quadrants():
    rng = np.random.default_rng(0)
    y = rng.uniform(-3, 3, 200_000).astype(np.float32)
    x = rng.uniform(-3, 3, 200_000).astype(np.float32)
    got = tkm.atan2_f32(_t(y), _t(x)).numpy()
    want = np.asarray(jkm.atan2_f32(jnp.asarray(y), jnp.asarray(x)))
    assert _ulps(got, want).max() <= 2
    ref = np.arctan2(y.astype(np.float64), x.astype(np.float64))
    assert np.abs(got - ref).max() < 5e-7


@pytest.mark.parametrize("yy,xx", [(0.0, 1.0), (0.0, -1.0), (-0.0, -1.0),
                                   (1.0, 0.0), (-1.0, 0.0), (0.0, 0.0),
                                   (-2.0, -3.0), (2.0, -3.0), (-2.0, 3.0)])
def test_atan2_axes_and_quadrants(yy, xx):
    got = float(tkm.atan2_f32(_t([yy]), _t([xx]))[0])
    want = float(jkm.atan2_f32(jnp.float32(yy), jnp.float32(xx)))
    assert got == want
    ref = float(np.arctan2(np.float32(yy), np.float32(xx)))
    # -0.0: the y < 0 select cannot see its sign, and +-pi are one ray
    assert abs(got - ref) < 1e-6 or abs(abs(got) - np.pi) < 1e-6


def test_asin_matches_jax_and_float64():
    x = np.linspace(-0.9999, 0.9999, 100001).astype(np.float32)
    got = tkm.asin_f32(_t(x)).numpy()
    # PyTorch's float32 sqrt on the CPU is not always correctly rounded
    # (XLA's and the CUDA kernel's are), and near |x| = 1 an ulp of
    # sqrt(1 - x^2) is a few ulp of asin; so JAX's atan2_f32 is given the
    # same sqrt here, and the whole function is held to float64
    s = torch.sqrt(torch.clamp(1.0 - _t(x) * _t(x), min=0.0)).numpy()
    want = np.asarray(jkm.atan2_f32(jnp.asarray(x), jnp.asarray(s)))
    assert _ulps(got, want).max() <= 2
    assert _ulps(got, np.asarray(jkm.asin_f32(jnp.asarray(x)))).max() <= 4
    assert np.abs(got - np.arcsin(x.astype(np.float64))).max() < 1.5e-6
    ends = tkm.asin_f32(_t([1.0, -1.0, 1.5, -1.5])).numpy()
    np.testing.assert_allclose(ends, [np.pi / 2, -np.pi / 2, np.pi / 2,
                                      -np.pi / 2], rtol=0, atol=1e-6)


def _lane_inputs(nw=7, nq=5, n=4000, seed=1):
    """Rows' omegas and lanes' kirk-q of a small attitude grid, sampled."""
    rng = np.random.default_rng(seed)
    cfg = jatt.AttitudeConfig(n_mesh_w=nw, n_mesh_q=nq)
    w = rng.uniform(cfg.w_min_deg, cfg.w_max_deg, (3, n)) * np.pi / 180
    ang = [rng.uniform(lo, hi, n) for lo, hi in cfg.euler_ranges]
    half = [(np.cos(a / 2), np.sin(a / 2)) for a in ang]
    (cy, sy), (cp, sp), (cr, sr) = half
    q1 = sy * cp * cr - cy * sp * sr
    q2 = cy * sp * cr + sy * cp * sr
    q3 = cy * cp * sr - sy * sp * cr
    q4 = np.sqrt(np.maximum(1 - (q1**2 + q2**2 + q3**2), 0))
    return cfg, w.astype(np.float32), \
        np.stack([q1, q2, q3, q4]).astype(np.float32)


def test_recompute_coords_match_jax_lane_fn():
    cfg, w, q = _lane_inputs()
    got = tkm.quat_step_readback(cfg.h, [_t(x) for x in q],
                                 *[_t(x) for x in w], atan2=tkm.atan2_f32,
                                 asin=tkm.asin_f32)
    want = jatt._AttitudeLaneFn(cfg.h)([jnp.asarray(x) for x in w],
                                       [jnp.asarray(x) for x in q])
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=2e-6)
    # against the stored plan's torch.atan2/torch.asin readback: the
    # kernelmath trig's own error
    plain = tkm.quat_step_readback(cfg.h, [_t(x) for x in q],
                                   *[_t(x) for x in w])
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0, atol=2e-6)


@pytest.mark.parametrize("edge", ["extrapolate", "clamp"])
def test_affine_locate_matches_jax(edge):
    rng = np.random.default_rng(2)
    axis = np.linspace(-0.6, 0.6, 9).astype(np.float32)
    coord = rng.uniform(-0.75, 0.75, 50_000).astype(np.float32)
    start = float(np.float32(axis[0]))
    step = float(np.float32(np.float32(axis[-1]) - np.float32(axis[0]))
                 / np.float32(len(axis) - 1))
    lo, fr = affine_locate(_t(coord), start, float(np.float32(1.0 / step)),
                           len(axis), edge)
    jlo, jfr = jpb._affine_locate(jnp.asarray(coord), start, step,
                                  len(axis), edge)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    assert lo.dtype == torch.int32
    np.testing.assert_allclose(fr.numpy(), np.asarray(jfr), rtol=0, atol=ULP)
    if edge == "clamp":
        assert float(fr.min()) >= 0.0 and float(fr.max()) <= 1.0
    else:
        assert float(fr.min()) < 0.0 and float(fr.max()) > 1.0


def test_squares_as_products_leave_the_readback_unchanged():
    """The stored plan's readback writes q**2 as q * q: PyTorch's
    pow(x, 2) is x * x, so the stored plan is the same either way."""
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=100_003))
    assert torch.equal(x**2, x * x)
