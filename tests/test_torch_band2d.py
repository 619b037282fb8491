"""The banded 2-D backup (ocdp_tpu_torch/ops/band_backup2d.py, the port of
kernel B.6) and its tap analysis (ops/stencil.py) vs the JAX package, on
the CPU.

* ``stencil_taps`` on JAX's own plans (carried in with
  ``convert.plan_from_numpy``) equals ``build_stencil_backup``'s ``taps``,
  ``valid_taps``, ``pad`` and ``base`` exactly: both edge policies, at
  tests/test_pallas_backup.py's sizes, on a full-size simplified attitude
  axis (the 25- and 27-tap omega bands) and on position's 3-D plan.
* One sweep of ``band_backup2d_plain`` against JAX's
  ``build_pallas_backup_2d`` (interpret mode) and against the gather
  oracle: rtol 3e-6, atol 3e-6, equal argmin
  (``test_pallas_matches_gather``'s bounds).
* Six engine sweeps against the JAX engine's gather solve: rtol 1e-5, atol
  1e-5, over 99.9% equal argmins (``test_pallas_in_engine``'s bounds).
* The batch axis: position's C = 3 sweep equals three C = 1 sweeps
  bitwise; a 3-D plan whose leading axis moves raises ``ValueError``
  (the counterpart of ``test_pallas_rejects_3d``).
* A band wider than the JAX stencil's 64-tap cap: building the backup runs
  no tap analysis (the kernel reads only ``lo``/``frac``), and the plain
  tap loop still meets the gather oracles with the bounds above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu.engine import value_iteration_finite as jvalue_iteration
from ocdp_tpu.grids import Grid, linspace_axis
from ocdp_tpu.models import position as jpos
from ocdp_tpu.ops.backup import bellman_backup as jbellman_backup
from ocdp_tpu.ops.interp import build_plan as jbuild_plan
from ocdp_tpu.ops.pallas_backup import build_pallas_backup_2d
from ocdp_tpu.ops.stencil import build_stencil_backup
from ocdp_tpu_torch import convert
from ocdp_tpu_torch.engine import value_iteration_finite
from ocdp_tpu_torch.models import position as tpos
from ocdp_tpu_torch.ops.backup import bellman_backup
from ocdp_tpu_torch.ops import band_backup2d as bb
from ocdp_tpu_torch.ops.band_backup2d import BandBackup2D
from ocdp_tpu_torch.ops.interp import InterpPlan
from ocdp_tpu_torch.ops.stencil import stencil_taps

torch.set_num_threads(2)

DEG = np.pi / 180


def make_problem(n1, n2, edge="extrapolate", J=0.0285, u_max=0.11, h=0.005,
                 c_h=1.0, t_range=(-30.0, 30.0)):
    """tests/test_pallas_backup.py's problem (an attitude axis) in the JAX
    package, with an edge policy and the RK4_t factor ``c_h``."""
    s_w = linspace_axis(-50 * DEG, 50 * DEG, n1)
    s_t = linspace_axis(t_range[0] * DEG, t_range[1] * DEG, n2)
    grid = Grid((s_w, s_t))
    w = jnp.asarray(s_w)[:, None, None]
    t = jnp.asarray(s_t)[None, :, None]
    u = jnp.asarray(np.array([-u_max, 0, u_max], np.float32))[None, None, :]
    plan = jbuild_plan(grid.axes, (w + h * u / J, t + h * w * c_h),
                       edge=edge)
    cost = 6 * w**2 + 6 * t**2 + 4 * u**2
    return grid, plan, cost


def to_port(plan):
    return convert.plan_from_numpy([np.asarray(x) for x in plan.lo],
                                   [np.asarray(x) for x in plan.frac],
                                   plan.grid_shape, device="cpu")


def cost_tensor(cost):
    return torch.from_numpy(np.array(cost, np.float32))


def assert_taps_equal(port_plan, jax_stencil):
    st = stencil_taps(port_plan)
    assert st.taps == jax_stencil.taps
    assert st.valid_taps == jax_stencil.valid_taps
    assert st.pad == jax_stencil.pad
    assert st.base == tuple(int(b) for b in np.asarray(jax_stencil.base[0, 0]))
    return st


@pytest.mark.parametrize("edge", ["extrapolate", "clamp"])
@pytest.mark.parametrize("n1,n2", [(64, 128), (17, 40)])
def test_stencil_taps_match_jax(n1, n2, edge):
    _, plan, cost = make_problem(n1, n2, edge)
    assert_taps_equal(to_port(plan), build_stencil_backup(plan, cost))


@pytest.mark.parametrize("edge", ["extrapolate", "clamp"])
def test_stencil_taps_match_jax_full_attitude_axis(edge):
    """The roll axis at AttitudeConfig()'s 1000 x 300 grid (J3, +-35 deg):
    every omega offset from -12 to 13 of the clamped rows is live."""
    c_h = 1 + 0.005 / 2 + 0.005**2 / 6 + 0.005**3 / 24
    _, plan, cost = make_problem(1000, 300, edge, J=0.023 + 0.00150,
                                 c_h=c_h, t_range=(-35.0, 35.0))
    st = assert_taps_equal(to_port(plan), build_stencil_backup(plan, cost))
    assert st.taps == ((-12, 13), (-1, 2))
    assert [len(t) for t in st.valid_taps] == [27, 5]


def test_stencil_taps_match_jax_position_plan():
    jp = jpos.build(jpos.PositionConfig(n_mesh_x=16, n_mesh_v=16))
    st = assert_taps_equal(to_port(jp.plan),
                           build_stencil_backup(jp.plan, jp.stage_cost))
    assert st.valid_taps[0] == (1,)     # each channel reads itself


@pytest.mark.parametrize("edge", ["extrapolate", "clamp"])
@pytest.mark.parametrize("n1,n2", [(64, 128), (17, 40)])
def test_plain_sweep_matches_jax_pallas_and_gather(n1, n2, edge):
    grid, plan, cost = make_problem(n1, n2, edge)
    v = np.random.default_rng(0).normal(size=grid.shape).astype(np.float32)
    want = build_pallas_backup_2d(plan, cost)(jnp.asarray(v))
    tp = to_port(plan)
    bk = BandBackup2D(tp, cost_tensor(cost))
    got = bk(torch.from_numpy(v))                  # a CPU tensor: plain
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=3e-6, atol=3e-6)
    np.testing.assert_array_equal(got.argmin.numpy(),
                                  np.asarray(want.argmin))
    gather = bellman_backup(torch.from_numpy(v), tp, cost_tensor(cost))
    np.testing.assert_allclose(got.values.numpy(), gather.values.numpy(),
                               rtol=3e-6, atol=3e-6)
    assert torch.equal(got.argmin, gather.argmin)
    assert torch.equal(bk.plain(torch.from_numpy(v)).values, got.values)


def test_six_engine_sweeps_match_jax_gather():
    _, plan, cost = make_problem(16, 24)
    ref = jvalue_iteration(plan, cost, 6)
    tp = to_port(plan)
    got = value_iteration_finite(tp, None, 6,
                                 backup=BandBackup2D(tp, cost_tensor(cost)))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(ref.values),
                               rtol=1e-5, atol=1e-5)
    assert (got.argmin.numpy() == np.asarray(ref.argmin)).mean() > 0.999


def test_cost_terms_sum_like_one_array():
    grid, plan, _ = make_problem(17, 40)
    s_w, s_t = (torch.from_numpy(a) for a in grid.axes)
    u = torch.tensor([-0.11, 0.0, 0.11])
    terms = [6 * s_w.reshape(-1, 1, 1)**2, 6 * s_t.reshape(1, -1, 1)**2,
             4 * u.reshape(1, 1, -1)**2]
    tp = to_port(plan)
    split = BandBackup2D(tp, terms)
    dense = BandBackup2D(tp, (terms[0] + terms[1]) + terms[2])
    assert torch.equal(split.args.dense_cost(), dense.args.dense_cost())
    assert split.args.dense_cost().shape == (1, 3, 17, 40)
    # the factorized cost is kept as its three terms, and a sweep through
    # it equals the sweep through the dense sum bitwise
    assert [tuple(t.shape) for t in split.args.terms] == \
        [(1, 17, 1, 1), (1, 1, 40, 1), (1, 1, 1, 3)]
    v = torch.from_numpy(np.random.default_rng(4).normal(
        size=grid.shape).astype(np.float32))
    got, want = split(v), dense(v)
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.argmin, want.argmin)


def test_channel_batch_equals_single_channels():
    p = tpos.build(tpos.PositionConfig(n_mesh_x=24, n_mesh_v=24),
                   device="cpu")
    bk = BandBackup2D(p.plan, p.stage_cost)
    assert bk.batched and bk.args.dense_cost().shape == (3, 3, 25, 25)
    v = torch.from_numpy(np.random.default_rng(1).uniform(
        0.0, 50.0, p.plan.grid_shape).astype(np.float32))
    got = bk(v)
    for c in range(3):
        plan_c = InterpPlan((p.plan.lo[1][0], p.plan.lo[2][0]),
                            (p.plan.frac[1][0], p.plan.frac[2][0]),
                            p.plan.grid_shape[1:])
        one = BandBackup2D(plan_c, p.stage_cost[c])(v[c])
        assert torch.equal(got.values[c], one.values)
        assert torch.equal(got.argmin[c], one.argmin)


def test_rejects_a_moving_leading_axis():
    p = tpos.build(tpos.PositionConfig(n_mesh_x=8, n_mesh_v=8), device="cpu")
    chan = p.grid.axes[0]
    moved = InterpPlan(
        (p.plan.lo[0], *p.plan.lo[1:]),
        (torch.full_like(p.plan.frac[0], 0.25), *p.plan.frac[1:]),
        p.plan.grid_shape)
    assert len(chan) == 3
    with pytest.raises(ValueError, match="leading axis moves"):
        BandBackup2D(moved, p.stage_cost)
    flat = InterpPlan(p.plan.lo[:1], p.plan.frac[:1], p.plan.grid_shape[:1])
    with pytest.raises(ValueError, match="2-D"):
        BandBackup2D(flat, p.stage_cost)


def test_wide_band_needs_no_tap_analysis(monkeypatch):
    """h = 0.09 shifts omega by about 40 cells a sweep: an 83-tap band on
    axis 0, past the 64 taps the JAX stencil analysis accepts. Building the
    backup must not analyse taps; the plain loop then meets the port's and
    the JAX package's gather backups (``test_pallas_matches_gather``'s
    bounds)."""
    grid, plan, cost = make_problem(200, 40, "clamp", h=0.09)
    tp = to_port(plan)

    def refuse(*_):
        raise AssertionError("tap analysis run while building the backup")

    with monkeypatch.context() as m:
        m.setattr(bb, "stencil_taps", refuse)
        bk = BandBackup2D(tp, cost_tensor(cost))
    t_lo, t_hi = bk.taps.taps[0]
    assert t_hi - t_lo + 2 > 64
    v = np.random.default_rng(3).normal(size=grid.shape).astype(np.float32)
    got = bk(torch.from_numpy(v))
    for want in (bellman_backup(torch.from_numpy(v), tp, cost_tensor(cost)),
                 jbellman_backup(jnp.asarray(v), plan, cost)):
        np.testing.assert_allclose(got.values.numpy(),
                                   np.asarray(want.values),
                                   rtol=3e-6, atol=3e-6)
        np.testing.assert_array_equal(got.argmin.numpy(),
                                      np.asarray(want.argmin))
