"""Port position solve and rollout (ocdp_tpu_torch/models/position.py) vs
the JAX package's ``ocdp_tpu.models.position``, the numpy oracle and the
stored golden, on the CPU.

* ``build``: the 3-D (channel, x, v) plan and the stage cost bitwise equal
  to the JAX package's.
* The three channels of ``impl='plain'`` (the banded backup with the
  channels as its batch) and ``'gather'`` against the per-channel numpy
  oracle (tests/test_position.py's bounds: rtol 1e-4, atol 1e-5, equal
  thrust tables), and against JAX's ``solve(impl='stencil')``: rtol 1e-5,
  atol 1e-5, equal thrust tables.
* tests/golden/position_golden.npz (made by the JAX stencil, 300 sweeps at
  ``PositionConfig()``): the banded backup sums ``(w_x w_v) leaf`` where
  the stencil nests ``sum_x w_x (sum_v w_v leaf)``, so the port cannot
  meet the golden's own 1e-6. Held to rtol 1e-4: the JAX package's own
  gather solve needs 6.5e-5 there (max |dV| 0.0853 of 1453), the port's
  7.4e-5 (0.0903); over 99.95% equal argmins (both 0.999975).
* A 2 s flight (400 stages) of a 40x40 policy: every control equals a
  numpy nearest lookup of the thrust tables at the rolled state, and |x|
  shrinks from 0.4 to under 0.2 (tests/test_position.py's check, reached by
  2 s); a JAX policy carried over by ``convert.position_solution_from_
  numpy`` flies like JAX's flight over 100 stages (controls equal, states
  within 1e-5).
"""

import os

import numpy as np
import pytest
import torch

from oracle import bellman_backup as oracle_backup
from ocdp_tpu.models import position as jpos
from ocdp_tpu_torch import convert
from ocdp_tpu_torch.models import position as tpos

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "position_golden.npz")


def small_cfg(mod, **kw):
    base = dict(n_mesh_x=12, n_mesh_v=12, T_final=0.1, h=0.005,
                Qx=(6.0, 5.0, 4.0), Qv=(6.0, 6.0, 6.0), R=(0.1, 0.2, 0.3))
    base.update(kw)
    return mod.PositionConfig(**base)


def test_build_matches_jax():
    jp = jpos.build(small_cfg(jpos))
    tp = tpos.build(small_cfg(tpos), device="cpu")
    for a, b in zip(tp.grid.axes, jp.grid.axes):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tp.plan.lo + tp.plan.frac, jp.plan.lo + jp.plan.frac):
        assert tuple(a.shape) == np.shape(b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tp.stage_cost.numpy(),
                                  np.asarray(jp.stage_cost))


def test_sym_grid_has_exact_zero():
    prob = tpos.build(small_cfg(tpos), device="cpu")
    for ax in prob.grid.axes[1:]:
        assert (ax == 0.0).sum() == 1
        assert len(ax) == 13  # 12 -> 2*ceil(12/2)+1


@pytest.mark.parametrize("impl", ["plain", "gather"])
def test_channels_match_oracle_and_jax_stencil(impl):
    cfg = small_cfg(tpos)
    sol = tpos.solve(cfg, num_sweeps=8, impl=impl, device="cpu")
    got_v = sol.result.values.numpy()
    got_u = sol.u_tables.numpy()
    s_x, s_v = sol.problem.grid.axes[1], sol.problem.grid.axes[2]
    c_h = 1 + cfg.h / 2 + cfg.h**2 / 6 + cfg.h**3 / 24
    u_vec = cfg.u_vector
    for c in range(3):
        x = s_x.astype(np.float64)[:, None, None]
        v = s_v.astype(np.float64)[None, :, None]
        u = u_vec.astype(np.float64)[None, None, :]
        nxt = np.stack(np.broadcast_arrays(x + cfg.h * v * c_h,
                                           v + cfg.h * u / cfg.mass), axis=-1)
        cost = np.broadcast_to(cfg.Qx[c] * x**2 + cfg.Qv[c] * v**2
                               + cfg.R[c] * u**2, nxt.shape[:-1])
        vv = np.zeros((len(s_x), len(s_v)))
        for _ in range(8):
            vv, aa = oracle_backup(vv, (s_x, s_v), nxt, cost)
        np.testing.assert_allclose(got_v[c], vv, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_u[c], u_vec[aa], atol=1e-6)
    js = jpos.solve(small_cfg(jpos), num_sweeps=8, impl="stencil")
    np.testing.assert_allclose(got_v, np.asarray(js.result.values),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_u, np.asarray(js.u_tables))


def test_matches_golden_within_the_jax_gather_distance():
    with np.load(GOLDEN) as z:
        g = {k: z[k] for k in z.files}
    sweeps = int(g["sweeps"])
    sol = tpos.solve(tpos.PositionConfig(), num_sweeps=sweeps, device="cpu")
    js = jpos.solve(jpos.PositionConfig(), num_sweeps=sweeps, impl="gather")
    for values, argmin in ((sol.result.values.numpy(),
                            sol.result.argmin.numpy()),
                           (np.asarray(js.result.values),
                            np.asarray(js.result.argmin))):
        np.testing.assert_allclose(values, g["values"], rtol=1e-4, atol=1e-6)
        assert (argmin == g["argmin"]).mean() > 0.9995


@pytest.fixture(scope="module")
def flight():
    cfg = tpos.PositionConfig(n_mesh_x=40, n_mesh_v=40, T_final=30.0)
    sol = tpos.solve(cfg, num_sweeps=400, device="cpu")
    T, X, U = tpos.get_optimal_path(sol, (-0.4, 0.1, 0.05, 0.0, 0.0, 0.0),
                                    t_final=2.0)
    return sol, T, X, U


def nearest(ax, q):
    lo = int(np.clip(np.searchsorted(ax, q, side="right") - 1, 0,
                     len(ax) - 2))
    return lo + 1 if (q - ax[lo]) > (ax[lo + 1] - q) else lo


def test_rollout_controls_match_policy_lookup(flight):
    sol, T, X, U = flight
    assert T.shape == (400,) and X.shape == (400, 6) and U.shape == (399, 3)
    X, U = X.numpy().astype(np.float64), U.numpy().astype(np.float64)
    tables = sol.u_tables.numpy().astype(np.float64)
    axes = [np.asarray(a, np.float64) for a in sol.problem.grid.axes[1:]]
    for k in range(U.shape[0]):
        for c in range(3):
            i = nearest(axes[0], X[k, c])
            j = nearest(axes[1], X[k, 3 + c])
            assert U[k, c] == tables[c, i, j]


def test_rollout_regulates_toward_origin(flight):
    _, _, X, U = flight
    X, U = X.numpy(), U.numpy()
    assert np.all(np.isfinite(X))
    assert np.isin(np.round(U.astype(np.float64), 4),
                   [-0.26, 0.0, 0.26]).all()
    assert np.abs(X[-1, 0]) < 0.2


def test_carried_solution_flies_like_jax():
    cfg = dict(n_mesh_x=24, n_mesh_v=24, T_final=30.0)
    js = jpos.solve(jpos.PositionConfig(**cfg), num_sweeps=200)
    ts = convert.position_solution_from_numpy(js, device="cpu")
    np.testing.assert_array_equal(ts.u_tables.numpy(), np.asarray(js.u_tables))
    y0 = (-0.3, 0.05, 0.02, 0.0, 0.0, 0.0)
    jT, jX, jU = jpos.get_optimal_path(js, y0, t_final=0.5)
    T, X, U = tpos.get_optimal_path(ts, y0, t_final=0.5)
    np.testing.assert_array_equal(T.numpy(), np.asarray(jT))
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-5)


def test_rejections_and_default_device():
    cfg = small_cfg(tpos)
    with pytest.raises(ValueError, match="CUDA device"):
        tpos.solve(cfg, num_sweeps=1, impl="kernel", device="cpu")
    with pytest.raises(ValueError, match="unknown impl.*plain"):
        tpos.solve(cfg, num_sweeps=1, impl="stencil", device="cpu")
    if torch.cuda.is_available():
        return
    for call in (lambda: tpos.build(cfg), lambda: tpos.solve(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
