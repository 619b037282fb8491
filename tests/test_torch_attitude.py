"""Port full 6-D attitude solve (ocdp_tpu_torch/models/attitude.py) vs the
JAX package's ``ocdp_tpu.models.attitude`` and the numpy oracle, on the CPU.

* ``build_full``: the plan equals the JAX plan, ``lo`` exactly except where
  the JAX frac lies within 2e-6 of 0 or 1 (there the two may pick the
  neighbouring cell: ``atan2``/``asin`` differ by an ulp between XLA:CPU and
  PyTorch), ``frac`` within 2e-6; the cost terms bitwise.
* A 5-sweep ``impl='plain'`` solve against JAX ``solve_full(impl='pallas')``:
  rtol 1e-5, atol 1e-4, argmins all equal (tests/test_pallas_backup6.py:
  44-53's bounds).
* 2 sweeps at 4^3 x 3^3 against tests/oracle.py (tests/test_attitude.py:
  46-73's bounds).
* The torque decode, the dynamics (within 1e-6), and a 300-stage rollout of
  one policy in both packages (the JAX policy carried over by
  ``convert.full_solution_from_numpy``): torques equal at every stage,
  states within 1e-5.
* The rejections, and the entry points' default device: the card, so
  without one they raise.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from ocdp_tpu.models import attitude as jatt
from ocdp_tpu_torch import convert
from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.models import kirk as tkirk
from ocdp_tpu_torch.models import pos_att as tpa

torch.set_num_threads(2)

SMALL = dict(n_mesh_w=5, n_mesh_q=4)
TINY = dict(n_mesh_w=4, n_mesh_q=3, w_min_deg=-20.0, w_max_deg=20.0,
            T_final=0.25)


@pytest.mark.parametrize("size", [SMALL, TINY], ids=["5x4", "4x3"])
def test_plan_and_cost_match_jax(size):
    _, jp, jcost = jatt.build_full(jatt.AttitudeConfig(**size))
    grid, tp, tcost = tatt.build_full(tatt.AttitudeConfig(**size),
                                      device="cpu")
    assert tp.grid_shape == tuple(grid.shape) == jp.grid_shape
    for k in range(6):
        jl, jf = np.asarray(jp.lo[k]), np.asarray(jp.frac[k])
        tl, tf = tp.lo[k].numpy(), tp.frac[k].numpy()
        assert tl.shape == jl.shape and tf.shape == jf.shape
        same = tl == jl
        np.testing.assert_allclose(tf[same], jf[same], rtol=0, atol=2e-6)
        # a cell boundary within rounding: the neighbouring cell, at the
        # same point
        edge = np.minimum(np.abs(jf), np.abs(1.0 - jf)) <= 2e-6
        assert np.all(edge[~same]) and np.all(np.abs(tl - jl) <= 1)
        np.testing.assert_allclose((tl + tf)[~same], (jl + jf)[~same],
                                   rtol=0, atol=4e-6)
    for t, j in zip(tcost, jcost):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.fixture(scope="module")
def jax_sol5():
    cfg = jatt.AttitudeConfig(**SMALL)
    return jatt.solve_full(cfg, num_sweeps=5, impl="pallas")


def test_five_sweeps_match_jax_kernel(jax_sol5):
    got = tatt.solve_full(tatt.AttitudeConfig(**SMALL), num_sweeps=5,
                          device="cpu")        # 'auto': the plain version
    assert got.result.num_sweeps == 5
    jv, ja = np.asarray(jax_sol5.result.values), \
        np.asarray(jax_sol5.result.argmin)
    np.testing.assert_allclose(got.values_6d(), jv, rtol=1e-5, atol=1e-4)
    assert (got.argmin_6d() == ja).mean() == 1.0
    gather = tatt.solve_full(tatt.AttitudeConfig(**SMALL), num_sweeps=5,
                             impl="gather", device="cpu")
    np.testing.assert_allclose(got.values_6d(), gather.values_6d(),
                               rtol=1e-5, atol=1e-4)


def test_two_sweeps_match_numpy_oracle():
    cfg = tatt.AttitudeConfig(**TINY)
    grid, plan, cost = tatt.build_full(cfg, device="cpu")
    sol = tatt.solve_full(cfg, num_sweeps=2, impl="plain", device="cpu")
    # the oracle's queries rebuilt from (lo, frac) on the axes
    qs = []
    for k in range(6):
        lo, fr = plan.lo[k].numpy(), plan.frac[k].numpy()
        g = grid.axes[k].astype(np.float64)
        q = g[lo] + fr * (g[np.minimum(lo + 1, len(g) - 1)] - g[lo])
        qs.append(np.broadcast_to(q, plan.query_shape))
    nxt = np.stack(qs, axis=-1)
    cost_np = np.zeros(plan.query_shape)
    for term in cost:
        cost_np = cost_np + term.numpy().astype(np.float64)
    vv = np.zeros(grid.shape)
    for _ in range(2):
        vv, aa = oracle.bellman_backup(vv, grid.axes, nxt, cost_np)
    np.testing.assert_allclose(sol.values_6d(), vv, rtol=1e-4, atol=1e-4)
    assert (sol.argmin_6d() == aa).mean() > 0.995


def test_u_tables_decode_like_jax():
    cfg = tatt.AttitudeConfig(**SMALL)
    rng = np.random.default_rng(4)
    a = rng.integers(0, 27, (5, 5, 5, 4, 4, 4)).astype(np.int32)
    grid, _, _ = tatt.build_full(cfg, device="cpu")
    res = convert.result_from_numpy(np.zeros(a.shape, np.float32), a,
                                    num_sweeps=1, device="cpu")
    u = tatt.FullSolution(cfg, grid, res).u_tables
    want = np.stack(jatt.decode_torque_digits(
        jnp.asarray(a), jnp.asarray(jatt.AttitudeConfig().u_vector)))
    np.testing.assert_array_equal(u.numpy(), want)
    assert u.shape == (3,) + grid.shape
    np.testing.assert_array_equal(
        np.stack(tatt.decode_torque_digits(a, cfg.u_vector)), want)


def test_dynamics_match_jax():
    rng = np.random.default_rng(5)
    cfg = tatt.AttitudeConfig()
    inertia = np.asarray(cfg.inertia_matrix, np.float32)
    for _ in range(8):
        X = rng.normal(0, 0.3, 7).astype(np.float32)
        X[3:7] /= np.linalg.norm(X[3:7])
        U = rng.uniform(-0.11, 0.11, 3).astype(np.float32)
        want = jatt.attitude_rates_kirk(jnp.asarray(X), jnp.asarray(U),
                                        jnp.asarray(inertia))
        got = tatt.attitude_rates_kirk(torch.from_numpy(X),
                                       torch.from_numpy(U),
                                       torch.from_numpy(inertia))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
        got_e = tatt.euler_from_kirk_quat(torch.from_numpy(X[3:7]))
        want_e = jatt.euler_from_kirk_quat(jnp.asarray(X[3:7]))
        for g, w in zip(got_e, want_e):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)
    np.testing.assert_allclose(tatt.AttitudeConfig.default_x0(),
                               np.asarray(jatt.AttitudeConfig.default_x0()),
                               rtol=0, atol=1e-7)


def test_rollout_flies_the_jax_policy_like_jax(jax_sol5):
    sol = convert.full_solution_from_numpy(jax_sol5, device="cpu")
    np.testing.assert_array_equal(sol.argmin_6d(),
                                  np.asarray(jax_sol5.result.argmin))
    x0 = np.asarray([0.3, -0.2, 0.25, 0.05, 0.08, -0.06, 0.99], np.float32)
    jX, jU, jA = jatt.rollout_full(jax_sol5, jnp.asarray(x0), num_stages=300)
    X, U, A = tatt.rollout_full(sol, x0, num_stages=300)
    assert X.shape == (300, 7) and U.shape == A.shape == (299, 3)
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-5)
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=0, atol=1e-5)
    jX, jU, _ = jatt.rollout_full(jax_sol5, jnp.asarray(x0),
                                  method="interp", num_stages=20)
    X, U, _ = tatt.rollout_full(sol, x0, method="interp", num_stages=20)
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), rtol=0, atol=1e-6)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-5)


def test_rejections():
    cfg = tatt.AttitudeConfig(**TINY)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.solve_full(cfg, num_sweeps=1, impl="kernel", device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        tatt.solve_full(cfg, num_sweeps=1, impl="stencil", device="cpu")
    sol = tatt.solve_full(cfg, num_sweeps=1, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        tatt.rollout_full(sol, method="linear", num_stages=3)


def test_non_integer_stage_count_warns():
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        tatt.AttitudeConfig()
        assert not w
        cfg = tatt.AttitudeConfig(T_final=30.0, h=0.007)
        assert len(w) == 1 and "not an integer" in str(w[0].message)
        assert cfg.n_stage == 4286


def test_entry_points_default_to_the_card():
    """Without a card, a call that does not ask for the CPU raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    calls = [
        lambda: tkirk.build(tkirk.KirkConfig.golden()),
        lambda: tkirk.solve(tkirk.KirkConfig.golden()),
        lambda: tpa.build_channel(tpa.PosAttConfig(), "x"),
        lambda: tpa.solve_channel(tpa.PosAttConfig(), "x"),
        lambda: tpa.solve(tpa.PosAttConfig()),
        lambda: tatt.build_full(tatt.AttitudeConfig(**TINY)),
        lambda: tatt.solve_full(tatt.AttitudeConfig(**TINY), num_sweeps=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
