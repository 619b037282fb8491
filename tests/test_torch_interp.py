"""Port interpolation (ocdp_tpu_torch/ops/interp.py) vs the JAX package's.

Plans are bitwise: the same ``lo`` and bitwise-equal ``frac`` (the locate is
a search plus one subtract and one divide, rounded the same way by both).
``interp_apply`` is held to |d| <= 2e-6 * max(|V|, 1): XLA:CPU may fuse and
contract the weight algebra where PyTorch rounds every op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu.models import kirk as jkirk
from ocdp_tpu.ops import interp as ji
from ocdp_tpu_torch import convert
from ocdp_tpu_torch.grids import linspace_axis, sym_linspace_exact
from ocdp_tpu_torch.models import kirk as tkirk
from ocdp_tpu_torch.ops import interp as ti

torch.set_num_threads(2)

AXES = {
    "uniform": linspace_axis(-2.5, 3.0, 35),
    "rectilinear": sym_linspace_exact(-3.0, 5.0, 20),
}


def _close(got, want, scale):
    np.testing.assert_array_less(
        np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)),
        2e-6 * max(float(np.max(np.abs(scale))), 1.0) + 1e-30)


@pytest.mark.parametrize("name", sorted(AXES))
def test_axis_locate_bitwise(name):
    ax = AXES[name]
    rng = np.random.default_rng(1)
    span = ax[-1] - ax[0]
    # queries inside, outside on both sides, and exactly on grid points
    q = np.concatenate([rng.uniform(ax[0] - span, ax[-1] + span, 500),
                        ax]).astype(np.float32)
    lo_j, fr_j = ji.axis_locate(ax, q)
    lo_t, fr_t = ti.axis_locate(ax, torch.from_numpy(q))
    assert lo_t.dtype == torch.int32 and fr_t.dtype == torch.float32
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(fr_t.numpy(), np.asarray(fr_j))
    assert (fr_t < 0).any() and (fr_t > 1).any()      # extrapolating fracs


@pytest.mark.parametrize("edge", ["extrapolate", "clamp"])
def test_build_plan_bitwise(edge):
    rng = np.random.default_rng(2)
    axes = (AXES["uniform"], AXES["rectilinear"])
    q0 = rng.uniform(-4.0, 4.5, (6, 1, 5)).astype(np.float32)
    q1 = rng.uniform(-5.0, 7.0, (1, 4, 5)).astype(np.float32)
    pj = ji.build_plan(axes, (q0, q1), edge=edge)
    pt = ti.build_plan(axes, (torch.from_numpy(q0), torch.from_numpy(q1)),
                       edge=edge)
    assert pt.grid_shape == pj.grid_shape == (35, 20)
    assert pt.query_shape == tuple(pj.query_shape) == (6, 4, 5)
    for a, b in zip(pt.lo + pt.frac, pj.lo + pj.frac):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if edge == "clamp":
        assert all(float(f.min()) >= 0.0 and float(f.max()) <= 1.0
                   for f in pt.frac)


def test_build_plan_rejects_bad_arguments():
    ax = AXES["uniform"]
    with pytest.raises(ValueError, match="axes"):
        ti.build_plan((ax, ax), (torch.zeros(3),))
    with pytest.raises(ValueError, match="edge"):
        ti.build_plan((ax,), (torch.zeros(3),), edge="wrap")


@pytest.mark.parametrize("cfg", [tkirk.KirkConfig.golden(),
                                 tkirk.KirkConfig(N=4, dx=23, du=57)],
                         ids=["golden", "small"])
def test_kirk_plan_and_cost_bitwise(cfg):
    """The port's Kirk build reproduces the JAX build's plan and stage cost
    bitwise (same eager op order)."""
    pj = jkirk.build(jkirk.KirkConfig(N=cfg.N, dx=cfg.dx, du=cfg.du))
    pt = tkirk.build(cfg, device="cpu")
    for a, b in zip(pt.plan.lo + pt.plan.frac, pj.plan.lo + pj.plan.frac):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(pt.stage_cost.numpy(),
                                  np.asarray(pj.stage_cost))
    np.testing.assert_array_equal(pt.u_mesh, pj.u_mesh)


@pytest.mark.parametrize("shape", [(9,), (7, 6), (5, 4, 6)])
def test_interp_apply_matches_jax(shape):
    """One plan fed to both packages (through convert.plan_from_numpy)."""
    rng = np.random.default_rng(len(shape))
    axes = [np.sort(rng.uniform(-3, 3, n)).astype(np.float32) for n in shape]
    queries = [rng.uniform(-4, 4, (11, 3)).astype(np.float32) for _ in shape]
    pj = ji.build_plan(axes, queries)
    pt = convert.plan_from_numpy([np.asarray(x) for x in pj.lo],
                                 [np.asarray(x) for x in pj.frac],
                                 pj.grid_shape, device="cpu")
    vals = rng.uniform(-100, 100, shape).astype(np.float32)
    want = np.asarray(ji.interp_apply(jnp.asarray(vals), pj))
    got = ti.interp_apply(torch.from_numpy(vals), pt).numpy()
    assert got.shape == want.shape == (11, 3)
    _close(got, want, vals)


def test_interp_apply_rejects_wrong_table():
    p = ti.build_plan((AXES["uniform"],), (torch.zeros(3),))
    with pytest.raises(ValueError, match="grid shape"):
        ti.interp_apply(torch.zeros(34), p)


def test_interp_eval_scalar_points_match_jax():
    rng = np.random.default_rng(5)
    axes = (AXES["uniform"], AXES["uniform"])
    table = rng.uniform(-40, 10, (35, 35)).astype(np.float32)
    for x0, x1 in rng.uniform(-3.5, 4.0, (20, 2)).astype(np.float32):
        want = float(ji.interp_eval(table, axes, (x0, x1)))
        got = ti.interp_eval(torch.from_numpy(table), axes,
                             (torch.tensor(x0), torch.tensor(x1)))
        assert got.shape == ()
        _close(float(got), want, table)


def test_interp_reproduces_affine_functions():
    """Multilinear interpolation (and its linear extrapolation) is exact
    on an affine table, up to f32 rounding."""
    axes = (AXES["uniform"], AXES["rectilinear"])
    g0, g1 = np.meshgrid(*axes, indexing="ij")
    table = torch.from_numpy((2.0 * g0 - 3.0 * g1 + 1.0).astype(np.float32))
    q0 = torch.tensor([-3.0, 0.1, 2.9, 4.0])
    q1 = torch.tensor([-4.0, 0.2, 4.9, 6.0])
    got = ti.interp_eval(table, axes, (q0, q1))
    np.testing.assert_allclose(got.numpy(), (2 * q0 - 3 * q1 + 1).numpy(),
                               atol=1e-4)


def _nearest_queries(ax, rng):
    """Random, out-of-grid, on-grid and exact-midpoint coordinates."""
    span = float(ax[-1] - ax[0])
    mid = ((ax[:-1].astype(np.float64) + ax[1:]) / 2).astype(np.float32)
    exact = mid[(mid - ax[:-1]) == (ax[1:] - mid)]   # f32-exact midpoints
    return np.concatenate([rng.uniform(ax[0] - span, ax[-1] + span, 300),
                           ax, exact]).astype(np.float32), len(exact)


@pytest.mark.parametrize("name", sorted(AXES))
def test_nearest_eval_bitwise(name):
    ax = AXES[name]
    rng = np.random.default_rng(9)
    q, n_exact = _nearest_queries(ax, rng)
    assert n_exact > 0
    table = rng.uniform(-1, 1, ax.size).astype(np.float32)
    want = np.asarray(ji.nearest_eval(jnp.asarray(table), [ax], (q,)))
    got = ti.nearest_eval(torch.from_numpy(table), [ax], (torch.from_numpy(q),))
    np.testing.assert_array_equal(got.numpy(), want)
    # exact midpoints snap to the LOWER neighbor
    mids = q[-n_exact:]
    low = np.searchsorted(ax, mids, side="right") - 1
    np.testing.assert_array_equal(got.numpy()[-n_exact:], table[low])


def test_nearest_cell_index_bitwise():
    axes = (AXES["uniform"], AXES["rectilinear"],
            sym_linspace_exact(-0.2, 0.2, 30), linspace_axis(-1.0, 1.0, 7))
    rng = np.random.default_rng(10)
    cols = [_nearest_queries(ax, rng)[0][:250] for ax in axes]
    q = np.stack(cols, axis=-1)
    aff_j = ji.affine_axes(axes)
    aff_t = ti.affine_axes(axes, device="cpu")
    for a, b in zip(aff_t, aff_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = ti.nearest_cell_index(aff_t, torch.from_numpy(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        ji.nearest_cell_index(aff_j, jnp.asarray(q))))
    # the same indices nearest_eval picks through searchsorted
    for k, ax in enumerate(axes):
        idx = ti.nearest_eval(torch.arange(ax.size, dtype=torch.float32),
                              [ax], (torch.from_numpy(q[:, k]),))
        np.testing.assert_array_equal(got.numpy()[:, k], idx.numpy())


def test_affine_axes_rejects_drifting_axes():
    """The reference checks only adjacent spacings (ocdp_tpu/ops/interp.py
    :283), which a slow drift passes; the port checks each grid point's
    distance from its piece's affine fit."""
    d = 1.0 + 5e-5 * np.arange(40)           # adjacent ratios within 1e-4
    drift = np.concatenate([[0.0], np.cumsum(d)]).astype(np.float32)
    ji.affine_axes((drift,))                  # the reference accepts it
    with pytest.raises(ValueError, match="drifts"):
        ti.affine_axes((drift,), device="cpu")
    with pytest.raises(ValueError, match="piecewise-uniform"):
        ti.affine_axes((np.array([0.0, 1.0, 3.0, 7.0], np.float32),),
                       device="cpu")
    ti.affine_axes((sym_linspace_exact(-0.1, 0.1, 30),), device="cpu")
