"""Port pos-att (ocdp_tpu_torch/models/pos_att.py) vs the JAX package.

* Solves through the plain rowlane version against JAX ``impl='pallas'``
  (interpret mode on the CPU): values rtol 1e-5 / atol 1e-5, argmin >= 99.9%
  equal, ``num_sweeps``/``converged`` equal, the zero-cost early stop at
  exactly 50 sweeps.
* The golden ``pos_att_channel_golden.npz`` was made by the JAX stencil
  backup, whose interpolation sums its 16 corners in another order than the
  row/lane lerps: after 200 sweeps the JAX pallas kernel and this port are
  both about 1e-3 from it (measured: port 1.30e-3 max, 5.9e-5 relative,
  argmin 99.93% equal). They are held to the JAX package's own
  pallas-vs-stencil bounds (tests/test_pos_att.py:165-182): rtol 1e-5 +
  atol 2e-3, at most 0.1% argmin flips.
* Rollouts of one controller set (a JAX solution carried over with
  ``convert.solution_from_numpy``): thruster forces equal, states within
  ``X_ATOL`` (float32 rounding of two implementations over the flight;
  measured at most 9e-8 for ode45 over 1 s).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu import io as jio
from ocdp_tpu.models import pos_att as jpa
from ocdp_tpu_torch import convert
from ocdp_tpu_torch import io as tio
from ocdp_tpu_torch.models import pos_att as tpa

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)
SMALL = dict(n_mesh_x=7, n_mesh_v=7, n_mesh_t=6, n_mesh_w=5, T_final=0.25)
MID = dict(n_mesh_x=12, n_mesh_v=12, n_mesh_t=8, n_mesh_w=7, T_final=10.0)
CHANNELS = [("x", False), ("y", False), ("z", False), ("x", True)]
X_ATOL = 1e-6


def _agree(t_ctrl_or_values, j_values, t_argmin=None, j_argmin=None):
    np.testing.assert_allclose(t_ctrl_or_values, j_values, rtol=1e-5,
                               atol=1e-5)
    if t_argmin is not None:
        assert (np.asarray(t_argmin) == np.asarray(j_argmin)).mean() >= 0.999


def test_config_matches_jax():
    for t, j in ((tpa.PosAttConfig(), jpa.PosAttConfig()),
                 (tpa.PosAttConfig.high_res(), jpa.PosAttConfig.high_res())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.n_stage == j.n_stage
        np.testing.assert_array_equal(t.inertia_matrix, j.inertia_matrix)
        for ch in tpa.CHANNELS:
            assert t.channel_inertia(ch) == j.channel_inertia(ch)
            for fail in (False, True):
                for a, b in zip(t.thruster_value_sets(ch, fail),
                                j.thruster_value_sets(ch, fail)):
                    np.testing.assert_array_equal(a, b)
    assert tpa.CHANNELS == jpa.CHANNELS


def test_default_x0_matches_jax():
    for pitch in (3.0, -1.5):
        np.testing.assert_allclose(tpa.default_x0(pitch),
                                   jpa.default_x0(pitch), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("channel,failure", CHANNELS)
def test_solve_channel_matches_jax_pallas(channel, failure):
    jc, tc = jpa.PosAttConfig(**SMALL), tpa.PosAttConfig(**SMALL)
    jctrl, jres = jpa.solve_channel(jc, channel, failure=failure,
                                    impl="pallas", max_sweeps=5)
    tctrl, tres = tpa.solve_channel(tc, channel, failure=failure,
                                    device="cpu", max_sweeps=5)
    _agree(tres.values.numpy(), jres.values, tres.argmin.numpy(),
           jres.argmin)
    assert tres.num_sweeps == int(jres.num_sweeps) == 5
    assert tres.converged == bool(jres.converged)
    np.testing.assert_array_equal(tctrl.forces, jctrl.forces)
    assert tctrl.values is tres.values


def test_solve_matches_jax_pallas():
    jc, tc = jpa.PosAttConfig(**SMALL), tpa.PosAttConfig(**SMALL)
    jsol = jpa.solve(jc, include_failure=True, impl="pallas")
    tsol = tpa.solve(tc, include_failure=True, device="cpu")
    assert list(tsol.controllers) == list(jsol.controllers) \
        == ["x", "y", "z", "x_failure"]
    for name, jctrl in jsol.controllers.items():
        tctrl = tsol.controllers[name]
        _agree(tctrl.values.numpy(), jctrl.values, tctrl.argmin.numpy(),
               jctrl.argmin)
        _, jres = jpa.solve_channel(jc, name[0], failure=name != name[0],
                                    impl="pallas")
        assert tsol.results[name].num_sweeps == int(jres.num_sweeps)
        assert tsol.results[name].converged == bool(jres.converged)
    assert tsol.controllers["x_failure"].forces.shape == (6, 4)


def test_early_stop_at_exactly_50_sweeps():
    """Zero stage cost keeps V identically 0, so the first 50-sweep checksum
    delta is 0 and the loop stops at sweep 50 (Solver_pos_att.m:268-286)."""
    zero = dict(SMALL, T_final=10.0, Qx=0.0, Qv=0.0, Qt=0.0, Qw=0.0, R=0.0)
    _, jres = jpa.solve_channel(jpa.PosAttConfig(**zero), "y", impl="pallas")
    _, tres = tpa.solve_channel(tpa.PosAttConfig(**zero), "y", device="cpu")
    assert tres.converged and bool(jres.converged)
    assert tres.num_sweeps == int(jres.num_sweeps) == 50


def test_reference_stop_rule_runs_to_cap_like_jax():
    cfg = dict(SMALL, T_final=1.0)
    _, jres = jpa.solve_channel(jpa.PosAttConfig(**cfg), "y", impl="pallas")
    _, tres = tpa.solve_channel(tpa.PosAttConfig(**cfg), "y", device="cpu")
    assert tres.num_sweeps == int(jres.num_sweeps) == 199
    assert not tres.converged and not bool(jres.converged)
    _agree(tres.values.numpy(), jres.values, tres.argmin.numpy(),
           jres.argmin)
    np.testing.assert_allclose(tres.checks.numpy(), np.asarray(jres.checks),
                               rtol=1e-5, atol=1e-3)


def test_impls_agree():
    cfg = tpa.PosAttConfig(**SMALL)
    _, rg = tpa.solve_channel(cfg, "z", device="cpu", impl="gather",
                              max_sweeps=20)
    _, rr = tpa.solve_channel(cfg, "z", device="cpu", impl="rowlane",
                              max_sweeps=20)
    _agree(rr.values.numpy(), rg.values.numpy(), rr.argmin.numpy(),
           rg.argmin.numpy())
    with pytest.raises(ValueError, match="needs a CUDA device"):
        tpa.solve_channel(cfg, "z", device="cpu", impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        tpa.solve_channel(cfg, "z", device="cpu", impl="stencil")


def test_reference_channel_matches_golden():
    with np.load(os.path.join(HERE, "golden",
                              "pos_att_channel_golden.npz")) as z:
        g = {k: z[k] for k in z.files}
    _, res = tpa.solve_channel(tpa.PosAttConfig(), "x", device="cpu",
                               max_sweeps=int(g["sweeps"]))
    np.testing.assert_allclose(res.values.numpy(), g["values"], rtol=1e-5,
                               atol=2e-3)
    assert (res.argmin.numpy() != g["argmin"]).mean() < 1e-3


def test_controllers_load_in_either_package(tmp_path):
    cfg = tpa.PosAttConfig(**SMALL)
    tsol = tpa.solve(cfg, device="cpu", include_failure=False, max_sweeps=3,
                     save_dir=str(tmp_path))
    pts = [(0.05, -0.02, 0.01, 0.001), (0.3, 0.2, -0.2, -0.05)]
    for name, tctrl in tsol.controllers.items():
        path = str(tmp_path / f"channel_{name}_controller_1.npz")
        jctrl = jio.load_channel_controller(path)
        np.testing.assert_array_equal(jctrl.values, tctrl.values.numpy())
        np.testing.assert_array_equal(jctrl.argmin, tctrl.argmin.numpy())
        np.testing.assert_array_equal(jctrl.forces, tctrl.forces)
        for p in pts:
            np.testing.assert_array_equal(
                tctrl.thruster_forces(p).numpy(),
                np.asarray(jctrl.thruster_forces(p)))
        # and back: a controller saved by the JAX package
        jpath = str(tmp_path / f"jax_{name}.npz")
        jio.save_channel_controller(jpath, jctrl)
        back = tio.load_channel_controller(jpath, device="cpu")
        assert torch.equal(back.values, tctrl.values)
        assert torch.equal(back.argmin, tctrl.argmin)
        for a, b in zip(back.axes, tctrl.axes):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jsol_mid():
    return jpa.solve(jpa.PosAttConfig(**MID), include_failure=True)


@pytest.fixture(scope="module")
def tsol_mid(jsol_mid):
    return convert.solution_from_numpy(jsol_mid, device="cpu")


def test_solution_round_trip(jsol_mid, tsol_mid):
    back = convert.to_numpy(tsol_mid)
    assert dataclasses.asdict(back.config) == \
        dataclasses.asdict(jsol_mid.config)
    for name, jc in jsol_mid.controllers.items():
        np.testing.assert_array_equal(back.controllers[name].values,
                                      jc.values)
        np.testing.assert_array_equal(back.controllers[name].argmin,
                                      jc.argmin)


def test_lookup_forces_match_jax(jsol_mid, tsol_mid):
    jctrls = [jsol_mid.controllers[ch] for ch in jpa.CHANNELS]
    tctrls = [tsol_mid.controllers[ch] for ch in tpa.CHANNELS]
    jlk = jpa._build_policy_lookup(jctrls)
    tlk = tpa._build_policy_lookup(tctrls, torch.device("cpu"))
    rng = np.random.default_rng(3)
    for _ in range(50):
        s = [rng.uniform(-lim, lim, 3).astype(np.float32)
             for lim in (0.3, 0.15, 0.1, 0.05)]
        got = tpa._lookup_forces(tlk, *map(torch.from_numpy, s))
        want = jpa._lookup_forces(jlk, *map(jnp.asarray, s))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for i, att in enumerate(tpa._ATT_IDX):
            pt = (s[0][i], s[1][i], s[2][att], s[3][att])
            np.testing.assert_array_equal(
                got[i].numpy(), tctrls[i].thruster_forces(pt).numpy())


@pytest.mark.parametrize("integrator,t_final", [("rk4", 2.0), ("ode45", 1.0)])
def test_rollout_matches_jax(jsol_mid, tsol_mid, integrator, t_final):
    jT, jX, jF, jFM = jpa.get_optimal_path(jsol_mid, t_final=t_final,
                                           integrator=integrator,
                                           device="cpu")
    T, X, F, FM = tpa.get_optimal_path(tsol_mid, t_final=t_final,
                                       integrator=integrator)
    assert X.shape == jX.shape and F.shape == jF.shape == (len(jT) - 1, 12)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), rtol=1e-7)
    np.testing.assert_array_equal(F.numpy(), np.asarray(jF))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0,
                               atol=X_ATOL)
    np.testing.assert_allclose(FM.numpy(), np.asarray(jFM), rtol=1e-5,
                               atol=1e-9)
    assert np.isin(np.round(np.abs(F.numpy()).astype(np.float64), 4),
                   [0.0, 0.13]).all()
    assert abs(float(X[-1, 0])) < abs(float(X[0, 0]))


def test_rollout_batch_equals_single_flights(tsol_mid):
    x0s = []
    for dx, pitch in ((-0.05, 2.0), (0.08, -1.5), (0.02, 0.5)):
        x0 = tpa.default_x0(pitch_deg=pitch)
        x0[0] = dx
        x0s.append(x0)
    T_b, X_b, F_b, FM_b = tpa.rollout_batch(tsol_mid, np.stack(x0s),
                                            t_final=2.0)
    assert X_b.shape == (3, 400, 13) and F_b.shape == (3, 399, 12)
    for b, x0 in enumerate(x0s):
        T, X, F, FM = tpa.get_optimal_path(tsol_mid, x0, t_final=2.0,
                                           integrator="rk4")
        assert torch.equal(X_b[b], X)
        assert torch.equal(F_b[b], F)
        assert torch.equal(FM_b[b], FM)
    with pytest.raises(ValueError, match=r"\(B, 13\)"):
        tpa.rollout_batch(tsol_mid, np.zeros(13))


def test_failure_controller_never_fires_thruster0(tsol_mid):
    _, X, F, _ = tpa.get_optimal_path(tsol_mid, t_final=1.0,
                                      use_x_failure=True, integrator="rk4")
    assert torch.isfinite(X).all()
    assert bool((F[:, 0] == 0.0).all())


def test_receding_horizon_reuses_a_solution(tsol_mid):
    x0 = tpa.default_x0(pitch_deg=-1.5)
    x0[0] = 0.08
    sol, (T, X, F, FM) = tpa.receding_horizon(x0, sol=tsol_mid, t_final=0.2)
    assert sol is tsol_mid
    assert abs(float(X[-1, 0])) < abs(float(x0[0]))
    with pytest.raises(ValueError, match="device"):
        tpa.receding_horizon(x0)
