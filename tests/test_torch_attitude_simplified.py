"""Port simplified attitude solve and its rollouts
(ocdp_tpu_torch/models/attitude.py) vs the JAX package's
``ocdp_tpu.models.attitude`` and the numpy oracle, on the CPU.

* ``build_simplified_axis``: plan and cost bitwise equal to the JAX
  package's (``attitude.py:231-242``), both edge policies.
* ``solve_simplified(device="cpu")`` for ``plain``, ``rowband``,
  ``rowlane`` and ``gather`` at both edges against tests/oracle.py
  (tests/test_attitude.py's bounds: rtol 1e-4, atol 1e-5, equal torque
  tables; the oracle sees the clamped queries under ``edge='clamp'``) and
  against JAX's ``solve_simplified`` of the corresponding impl
  (``pallas``, ``rowband``, ``rowlane``, ``gather``): rtol 1e-5, atol
  1e-5 (values pass through 0 at the origin), torque tables equal.
* The rollouts of one JAX policy carried over by
  ``convert.simplified_solution_from_numpy``, against JAX's rollouts over
  200 stages: torques equal at every stage, states within 1e-5 (measured
  1.6e-7 or less).
* tests/test_attitude.py's behavioural checks at its sizes; the real-
  dynamics flight of 2000 stages takes one fixed RK4 step a stage (ode45
  keeps at least 10 steps a stage, ~20 ms a stage on the CPU, and is
  checked against JAX above).
* The rejections, and the default device: the card, so without one the
  entry points raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from ocdp_tpu.grids import Grid, linspace_axis
from ocdp_tpu.models import attitude as jatt
from ocdp_tpu.ops.interp import build_plan as jbuild_plan
from ocdp_tpu_torch import convert
from ocdp_tpu_torch.models import attitude as tatt

torch.set_num_threads(2)

DEG = np.pi / 180.0
SMALL = dict(n_mesh_w=9, n_mesh_t=11, n_mesh_q=5, T_final=0.25,
             w_min_deg=-50.0, w_max_deg=50.0)
SERVE = dict(n_mesh_w=31, n_mesh_t=31, n_mesh_q=5, T_final=30.0)
JAX_IMPL = {"plain": "pallas", "rowband": "rowband", "rowlane": "rowlane",
            "gather": "gather"}


def jax_axis(cfg, i, edge):
    """The JAX package's per-axis plan and cost (attitude.py:231-242)."""
    t_lo, t_hi = cfg.euler_ranges[i]
    s_w = linspace_axis(cfg.w_min_deg * DEG, cfg.w_max_deg * DEG,
                        cfg.n_mesh_w)
    s_t = linspace_axis(t_lo, t_hi, cfg.n_mesh_t)
    J = cfg.inertia_diag[i]
    w = jnp.asarray(s_w)[:, None, None]
    t = jnp.asarray(s_t)[None, :, None]
    u = jnp.asarray(cfg.u_vector)[None, None, :]
    c_h = jatt._quirk(cfg.h, cfg.rk4_t_parity)
    plan = jbuild_plan(Grid((s_w, s_t)).axes,
                       (w + cfg.h * u / J, t + cfg.h * w * c_h), edge=edge)
    cost = cfg.Qw[i] * w**2 + cfg.Qq[i] * t**2 + cfg.R[i] * u**2
    return plan, cost


@pytest.mark.parametrize("edge", ["clamp", "extrapolate"])
def test_axis_plan_and_cost_match_jax(edge):
    jcfg, tcfg = jatt.AttitudeConfig(**SMALL), tatt.AttitudeConfig(**SMALL)
    for i in range(3):
        jp, jcost = jax_axis(jcfg, i, edge)
        _, tp, terms = tatt.build_simplified_axis(tcfg, i, edge=edge,
                                                  device="cpu")
        for a, b in zip(tp.lo + tp.frac, jp.lo + jp.frac):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(
            ((terms[0] + terms[1]) + terms[2]).numpy(), np.asarray(jcost))


def oracle_axis(cfg, i, edge, sweeps):
    """tests/test_attitude.py's float64 oracle of axis i; under 'clamp' the
    next states are clipped onto the grid first."""
    s_w = linspace_axis(cfg.w_min_deg * DEG, cfg.w_max_deg * DEG,
                        cfg.n_mesh_w)
    s_t = linspace_axis(*cfg.euler_ranges[i], cfg.n_mesh_t)
    c_h = 1 + cfg.h / 2 + cfg.h**2 / 6 + cfg.h**3 / 24
    J = cfg.inertia_diag[i]
    w = s_w.astype(np.float64)[:, None, None]
    t = s_t.astype(np.float64)[None, :, None]
    u = cfg.u_vector.astype(np.float64)[None, None, :]
    wn, tn = np.broadcast_arrays(w + cfg.h * u / J, t + cfg.h * w * c_h)
    if edge == "clamp":
        wn = np.clip(wn, s_w[0], s_w[-1])
        tn = np.clip(tn, s_t[0], s_t[-1])
    nxt = np.stack([wn, tn], axis=-1)
    cost = np.broadcast_to(cfg.Qw[i] * w**2 + cfg.Qq[i] * t**2
                           + cfg.R[i] * u**2, nxt.shape[:-1])
    vv = np.zeros(nxt.shape[:-2])
    for _ in range(sweeps):
        vv, aa = oracle.bellman_backup(vv, (s_w, s_t), nxt, cost)
    return vv, aa


@pytest.mark.parametrize("edge", ["clamp", "extrapolate"])
@pytest.mark.parametrize("impl", ["plain", "rowband", "rowlane", "gather"])
def test_solve_matches_oracle_and_jax(impl, edge):
    tcfg = tatt.AttitudeConfig(**SMALL)
    sol = tatt.solve_simplified(tcfg, num_sweeps=6, impl=impl, edge=edge,
                                device="cpu")
    assert sol.edge == edge and sol.device.type == "cpu"
    js = jatt.solve_simplified(jatt.AttitudeConfig(**SMALL), num_sweeps=6,
                               impl=JAX_IMPL[impl], edge=edge)
    for i in range(3):
        np.testing.assert_array_equal(sol.axes[i][0], np.asarray(js.axes[i][0]))
        np.testing.assert_array_equal(sol.axes[i][1], np.asarray(js.axes[i][1]))
        vv, aa = oracle_axis(tcfg, i, edge, 6)
        np.testing.assert_allclose(sol.values[i].numpy(), vv, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(sol.u_tables[i].numpy(),
                                   tcfg.u_vector[aa], atol=1e-6)
        np.testing.assert_allclose(sol.values[i].numpy(),
                                   np.asarray(js.values[i]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(sol.u_tables[i].numpy(),
                                      np.asarray(js.u_tables[i]))


@pytest.fixture(scope="module")
def carried():
    """A 31x31 JAX policy (800 sweeps) and its carried-over port twin."""
    js = jatt.solve_simplified(jatt.AttitudeConfig(**SERVE), num_sweeps=800)
    return js, convert.simplified_solution_from_numpy(js, device="cpu")


def test_carried_solution(carried):
    js, ts = carried
    assert ts.config == tatt.AttitudeConfig(**SERVE) and ts.edge == js.edge
    for i in range(3):
        np.testing.assert_array_equal(ts.u_tables[i].numpy(),
                                      np.asarray(js.u_tables[i]))
        np.testing.assert_array_equal(ts.values[i].numpy(),
                                      np.asarray(js.values[i]))


def test_plant_rollout_matches_jax(carried):
    js, ts = carried
    jX, jU = jatt.rollout_simplified_plant(js, num_stages=200)
    X, U = tatt.rollout_simplified_plant(ts, num_stages=200)
    assert X.shape == (200, 3, 2) and U.shape == (199, 3)
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-5)


@pytest.mark.parametrize("integrator", ["ode45", "rk4"])
def test_real_dynamics_rollout_matches_jax(carried, integrator):
    js, ts = carried
    jX, jU = jatt.rollout_simplified_real_dynamics(js, num_stages=200,
                                                   integrator=integrator)
    X, U = tatt.rollout_simplified_real_dynamics(ts, num_stages=200,
                                                 integrator=integrator)
    assert X.shape == (200, 7) and U.shape == (199, 3)
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-5)


def test_linear_control_response_matches_jax():
    jX, jU, jd = jatt.linear_control_response(jatt.AttitudeConfig(**SERVE),
                                              T_final=1.0)
    X, U, d = tatt.linear_control_response(tatt.AttitudeConfig(**SERVE),
                                           T_final=1.0, device="cpu")
    assert X.shape == (201, 7) and U.shape == (200, 3)
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), rtol=0, atol=1e-6)
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-5)
    assert abs(float(d) - float(jd)) < 1e-6


@pytest.fixture(scope="module")
def served():
    """tests/test_attitude.py's serving policy, solved by the port."""
    return tatt.solve_simplified(tatt.AttitudeConfig(**SERVE), num_sweeps=800,
                                 device="cpu")


def test_rollout_on_real_dynamics(served):
    X, _ = tatt.rollout_simplified_real_dynamics(served, num_stages=2000,
                                                 integrator="rk4")
    X = X.numpy()
    assert np.all(np.isfinite(X))
    np.testing.assert_allclose(np.linalg.norm(X[:, 3:7], axis=1), 1.0,
                               atol=1e-4)
    # the kirk q-vec (attitude error) shrinks
    assert np.linalg.norm(X[-1, 3:6]) < 0.5 * np.linalg.norm(X[0, 3:6])


def test_rollout_plant_tracks_training_dynamics(served):
    X, U = tatt.rollout_simplified_plant(served, num_stages=2000)
    X = X.numpy()
    assert X.shape[1:] == (3, 2) and np.all(np.isfinite(X))
    # angles shrink on the plant the policy was trained on
    assert np.all(np.abs(X[-1, :, 1])
                  < 0.5 * np.maximum(np.abs(X[0, :, 1]), 0.05))
    assert np.isin(np.round(np.abs(U.numpy()).astype(np.float64), 4),
                   [0.0, 0.11]).all()


def test_linear_control_response_baseline():
    X, _, drift = tatt.linear_control_response(tatt.AttitudeConfig(**SMALL),
                                               T_final=30.0, device="cpu")
    X = X.numpy()
    assert float(drift) < 1e-5
    assert np.linalg.norm(X[-1, 3:6]) < 0.05 * np.linalg.norm(X[0, 3:6])
    assert np.linalg.norm(X[-1, 0:3]) < 1e-2


def test_rejections():
    cfg = tatt.AttitudeConfig(**SMALL)
    with pytest.raises(ValueError, match="CUDA device"):
        tatt.solve_simplified(cfg, num_sweeps=1, impl="kernel", device="cpu")
    for impl in ("stencil", "pallas"):
        with pytest.raises(ValueError, match="unknown impl.*rowband"):
            tatt.solve_simplified(cfg, num_sweeps=1, impl=impl, device="cpu")
    with pytest.raises(ValueError, match="edge"):
        tatt.solve_simplified(cfg, num_sweeps=1, edge="wrap", device="cpu")


def test_entry_points_default_to_the_card():
    """Without a card, a call that does not ask for the CPU raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    cfg = tatt.AttitudeConfig(**SMALL)
    for call in (lambda: tatt.solve_simplified(cfg, num_sweeps=1),
                 lambda: tatt.build_simplified_axis(cfg, 0),
                 lambda: tatt.linear_control_response(cfg, T_final=0.01)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
