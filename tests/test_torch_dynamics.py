"""Port rollout physics (ocdp_tpu_torch utils/ and dynamics/, the thruster
model) vs the JAX package, on the same seeded inputs.

Tolerances: float32 closed forms (quaternions, frames, Stumpff functions,
Kepler propagation, CW rates) agree to rtol 2e-6 (XLA:CPU fuses and
contracts where PyTorch rounds every op, and the transcendental functions
may differ by an ulp); the integrators on a test ODE agree to 1e-6 absolute
(each step's rounding compounds over the steps); the thruster combinations
are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu.dynamics import orbital as jorb
from ocdp_tpu.dynamics import relmotion as jrel
from ocdp_tpu.models import thrusters as jthr
from ocdp_tpu.utils import frames as jfr
from ocdp_tpu.utils import integrators as jint
from ocdp_tpu.utils import quaternions as jq
from ocdp_tpu_torch.dynamics import orbital as torb
from ocdp_tpu_torch.dynamics import relmotion as trel
from ocdp_tpu_torch.models import thrusters as tthr
from ocdp_tpu_torch.utils import frames as tfr
from ocdp_tpu_torch.utils import integrators as tint
from ocdp_tpu_torch.utils import quaternions as tq

torch.set_num_threads(2)

RTOL = 2e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _quats(n, seed=0):
    q = _rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _close(got, want, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


QUAT_CASES = {
    "quat_normalize": lambda m, q, w: m.quat_normalize(q),
    "quat_to_dcm": lambda m, q, w: m.quat_to_dcm(q),
    "quat_kinematics": lambda m, q, w: m.quat_kinematics(q, w),
    "small_angles_from_quat": lambda m, q, w: m.small_angles_from_quat(q),
    "quat_to_euler_zyx": lambda m, q, w: m.quat_to_euler_zyx(q),
    "euler_zyx_to_quat": lambda m, q, w: m.euler_zyx_to_quat(q[0], q[1],
                                                             q[2]),
    "kirk_quat_from_euler": lambda m, q, w: m.kirk_quat_from_euler(
        q[0], q[1], q[2]),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quaternions_match_jax(name):
    fn = QUAT_CASES[name]
    for i, (q, w) in enumerate(zip(_quats(20), _rng(1).normal(
            size=(20, 3)).astype(np.float32))):
        got = fn(tq, torch.from_numpy(q), torch.from_numpy(w))
        want = fn(jq, jnp.asarray(q), jnp.asarray(w))
        if isinstance(got, tuple):
            got, want = torch.stack(got), np.stack(want)
        _close(got, want)


def test_quaternion_functions_take_a_batch():
    q = _quats(5, seed=2)
    w = _rng(3).normal(size=(5, 3)).astype(np.float32)
    batch = tq.quat_kinematics(torch.from_numpy(q), torch.from_numpy(w))
    for i in range(5):
        one = tq.quat_kinematics(torch.from_numpy(q[i]), torch.from_numpy(w[i]))
        assert torch.equal(batch[i], one)
    dcm = tq.quat_to_dcm(torch.from_numpy(q))
    assert dcm.shape == (5, 3, 3)
    assert torch.equal(dcm[3], tq.quat_to_dcm(torch.from_numpy(q[3])))


@pytest.mark.parametrize("name", ["rsw_to_eci_matrix", "rsw_to_body",
                                  "body_to_rsw"])
def test_frames_match_jax(name):
    rng = _rng(4)
    R0, V0 = torb.target_orbit_R0V0()
    for q in _quats(10, seed=5):
        vec = rng.normal(size=3).astype(np.float32)
        pos = (R0 + rng.normal(size=3) * 100).astype(np.float32)
        vel = (V0 + rng.normal(size=3)).astype(np.float32)
        if name == "rsw_to_eci_matrix":
            got = tfr.rsw_to_eci_matrix(torch.from_numpy(pos),
                                        torch.from_numpy(vel))
            want = jfr.rsw_to_eci_matrix(jnp.asarray(pos), jnp.asarray(vel))
        else:
            args = (vec, q, pos, vel)
            got = getattr(tfr, name)(*map(torch.from_numpy, args))
            want = getattr(jfr, name)(*map(jnp.asarray, args))
        _close(got, want, atol=1e-6)


def test_thruster_combinations_match_jax():
    F = tthr.SPHERES_THRUSTER_FORCE
    assert F == jthr.SPHERES_THRUSTER_FORCE
    assert tthr.SPHERES_MOMENT_ARM == jthr.SPHERES_MOMENT_ARM
    for f0 in ([0.0, F], [0.0]):
        sets = (f0, [0, F], [0, -F], [0, -F])
        got = tthr.thruster_combinations(*sets)
        want = jthr.thruster_combinations(*sets)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert tthr.thruster_combinations([0, F], [0, F], [0, -F],
                                      [0, -F]).shape == (9, 4)


@pytest.mark.parametrize("fn", ["stumpff_C", "stumpff_S"])
def test_stumpff_match_jax(fn):
    """Outside the series region both closed forms cancel: an ulp of
    cos/sin/cosh/sinh (about 6e-8 relative) becomes about 6e-8/|z| of C or
    S. Measured: up to 4 such ulps apart near |z| = 1e-4, so the bound is
    10 on top of RTOL."""
    z = np.concatenate([_rng(6).uniform(-30, 30, 200),
                        _rng(7).uniform(-2e-4, 2e-4, 50),
                        [0.0, 1e-4, -1e-4]]).astype(np.float32)
    got = getattr(torb, fn)(torch.from_numpy(z)).numpy().astype(np.float64)
    want = np.asarray(getattr(jorb, fn)(jnp.asarray(z)), np.float64)
    bound = RTOL * np.abs(want) + 6e-7 / np.maximum(np.abs(z), 1e-4)
    assert np.all(np.abs(got - want) <= bound)


def test_target_orbit_and_kepler_propagation_match_jax():
    R0, V0 = torb.target_orbit_R0V0()
    jR0, jV0 = jorb.target_orbit_R0V0()
    assert R0.dtype == np.float32 and V0.dtype == np.float32
    _close(R0, jR0)
    _close(V0, jV0)
    ts = np.array([0.0, 0.0025, 0.005, 1.0, 5.0, 9.995, 600.0], np.float32)
    R, V = torb.propagate_kepler(torch.from_numpy(R0), torch.from_numpy(V0),
                                 torch.from_numpy(ts))
    assert R.shape == (len(ts), 3)
    for i, t in enumerate(ts):
        jR, jV = jorb.propagate_kepler(jnp.asarray(R0), jnp.asarray(V0),
                                       jnp.float32(t))
        _close(R[i], jR, atol=1e-3)
        _close(V[i], jV, atol=1e-6)
        # a batch element equals the same time alone
        Ri, Vi = torb.propagate_kepler(torch.from_numpy(R0),
                                       torch.from_numpy(V0),
                                       torch.tensor(float(t)))
        assert torch.equal(R[i], Ri) and torch.equal(V[i], Vi)


def test_cw_relative_rates_match_jax():
    R0, V0 = torb.target_orbit_R0V0()
    rng = _rng(8)
    for t in (0.0, 0.003, 2.5, 9.99):
        y = (rng.normal(size=6) * [0.1, 0.1, 0.1, 1e-3, 1e-3, 1e-3]) \
            .astype(np.float32)
        a = (rng.normal(size=3) * 0.05).astype(np.float32)
        got = trel.cw_relative_rates(torch.tensor(t), torch.from_numpy(y),
                                     torch.from_numpy(a),
                                     torch.from_numpy(R0),
                                     torch.from_numpy(V0))
        want = jrel.cw_relative_rates(jnp.float32(t), jnp.asarray(y),
                                      jnp.asarray(a), jnp.asarray(R0),
                                      jnp.asarray(V0))
        _close(got, want, atol=1e-8)


def _ode(lib):
    """A damped oscillator plus a time-forced decay, 3 states."""
    def f(t, y):
        y0, y1, y2 = y[..., 0], y[..., 1], y[..., 2]
        stack = torch.stack if lib is torch else jnp.stack
        sin = torch.sin if lib is torch else jnp.sin
        return stack([y1, -4.0 * y0 - 0.3 * y1, -0.5 * y2 + sin(3.0 * t)],
                     -1)
    return f


Y0 = np.array([1.0, -0.5, 0.25], np.float32)


@pytest.mark.parametrize("name", ["rk4", "rkf45", "ode45"])
def test_integrators_match_jax(name):
    fn_t, kw = tint.integrator_kwargs(name)
    fn_j, kw_j = jint.integrator_kwargs(name)
    assert kw == kw_j
    y_t, y_j = torch.from_numpy(Y0)[None], jnp.asarray(Y0)
    for k in range(20):       # 20 spans of 0.05 s, as a rollout steps
        t0 = np.float32(k) * np.float32(0.05)
        y_t = fn_t(_ode(torch), torch.tensor(t0), torch.tensor(t0) + 0.05,
                   y_t, **kw)
        y_j = fn_j(_ode(jnp), jnp.float32(t0), jnp.float32(t0) + 0.05,
                   y_j, **kw_j)
    assert torch.isfinite(y_t).all()
    _close(y_t[0], y_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["rkf45", "ode45"])
def test_adaptive_batch_member_equals_single(name):
    fn, kw = tint.integrator_kwargs(name)
    y0 = np.stack([Y0, 3 * Y0, -Y0]).astype(np.float32)
    batch = fn(_ode(torch), torch.tensor(0.0), torch.tensor(1.0),
               torch.from_numpy(y0), **kw)
    for i in range(3):
        one = fn(_ode(torch), torch.tensor(0.0), torch.tensor(1.0),
                 torch.from_numpy(y0[i:i + 1]), **kw)
        assert torch.equal(batch[i], one[0])


@pytest.mark.parametrize("name", ["rkf45", "ode45"])
def test_truncated_integration_is_nan(name):
    fn = tint.adaptive_integrator(name)
    out = fn(_ode(torch), torch.tensor(0.0), torch.tensor(5.0),
             torch.from_numpy(Y0)[None], max_steps=3)
    assert torch.isnan(out).all()
    jout = getattr(jint, f"{name}_integrate")(
        _ode(jnp), jnp.float32(0.0), jnp.float32(5.0), jnp.asarray(Y0),
        max_steps=3)
    assert np.isnan(np.asarray(jout)).all()


def test_integrator_kwargs_rules():
    fn, kw = tint.integrator_kwargs("ode45", 1e-4)
    assert fn is tint.ode45_integrate
    assert kw == {"rtol": 1e-4, "atol": 1e-3 * 1e-4}
    assert tint.integrator_kwargs("rkf45", 1e-6)[1] == {"tol": 1e-6}
    with pytest.raises(ValueError, match="fixed-step"):
        tint.integrator_kwargs("rk4", 1e-3)
    with pytest.raises(ValueError, match="unknown integrator"):
        tint.integrator_kwargs("euler")


def _kepler_loop(dt, r0, vr0, alpha, tol, max_iter):
    """The reference iteration for one element, step by step."""
    mu = torch.tensor(torb.MU_EARTH)
    smu = torch.sqrt(mu)
    x, ratio, n = smu * torch.abs(alpha) * dt, torch.tensor(1.0), 0
    while abs(float(ratio)) > tol and n <= max_iter:
        z = alpha * x * x
        C, S = torb.stumpff_C(z), torb.stumpff_S(z)
        F = r0 * vr0 / smu * x * x * C \
            + (1 - alpha * r0) * (x * (x * x)) * S + r0 * x - smu * dt
        dF = r0 * vr0 / smu * x * (1 - z * S) \
            + (1 - alpha * r0) * x * x * C + r0
        ratio = F / dF
        x, n = x - ratio, n + 1
    return x


@pytest.mark.parametrize("max_iter", [30, 31, 1000])
def test_kepler_cycles_end_where_the_capped_loop_ends(max_iter):
    """Times at which float32 Newton iterates alternate between two floats
    (found on the CPU) and times where they converge: the solve's cycle
    shortcut lands on the iterate the uncut loop ends on."""
    R0, V0 = (torch.from_numpy(a) for a in torb.target_orbit_R0V0())
    r0 = tfr.norm3(R0)
    vr0 = (R0 * V0).sum() / r0
    alpha = 2.0 / r0 - tfr.norm3(V0) ** 2 / torch.tensor(torb.MU_EARTH)
    dt = torch.tensor([201.51345825195312, 745.6996459960938,
                       1618.7203369140625, 0.0, 2.5, 9.995])
    got = torb.kepler_universal(dt, r0, vr0, alpha, max_iter=max_iter)
    want = torch.stack([_kepler_loop(d, r0, vr0, alpha, 1e-8, max_iter)
                        for d in dt])
    assert torch.equal(got, want)
    if max_iter == 1000:
        jx = [jorb.kepler_universal(jnp.float32(d), jnp.float32(r0),
                                    jnp.float32(vr0), jnp.float32(alpha))
              for d in dt.tolist()]
        _close(got, np.asarray(jx), rtol=1e-6)


@pytest.mark.parametrize("name", ["rk4", "rkf45", "ode45"])
def test_batched_target_equals_one_propagation_per_stage(name):
    """The integrators' ``prepare`` hook with ``target_states`` (one batched
    Kepler solve per step for all stage times, as the rollouts run it)
    gives the same span as propagating the target inside every stage:
    bitwise, for a batch of three chasers over 20 spans."""
    R0, V0 = (torch.from_numpy(a) for a in torb.target_orbit_R0V0())
    fn, kw = tint.integrator_kwargs(name)
    y = torch.from_numpy(_rng(5).normal(0.0, 0.05, (3, 6))
                         .astype(np.float32))
    accel = torch.tensor([0.01, -0.02, 0.0])
    h = 0.005

    def per_stage(t, yy):
        return trel.cw_relative_rates(t, yy, accel, R0, V0)

    def batched(t, yy, rv):
        return trel.cw_relative_rates(t, yy, accel, R0, V0, rv)

    def prepare(times):
        return trel.target_states(R0, V0, times)

    ya = yb = y
    for k in range(20):
        t0 = torch.tensor(float(k), dtype=torch.float32) * h
        ya = fn(per_stage, t0, t0 + h, ya, **kw)
        yb = fn(batched, t0, t0 + h, yb, prepare=prepare, **kw)
        assert torch.equal(ya, yb)
    for t in (torch.tensor(0.3), torch.tensor([0.1, 0.2])):
        R, V = torb.propagate_kepler(R0, V0, t)
        (Rb, Vb), = trel.target_states(R0, V0, [t])
        assert torch.equal(R, Rb) and torch.equal(V, Vb)
