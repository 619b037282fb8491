"""Port Kirk ch.3 (ocdp_tpu_torch/models/kirk.py) vs MATLAB truth, the
stored golden solve, and the JAX package, on the golden configuration.

Tolerances are tests/test_golden.py's for the goldens; against the JAX
package: values |dV| <= 2e-6 * max(|V|, 1), policies >= 99.9% equal, and
rollouts X atol 1e-4 / U atol 1e-3.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu import engine as jengine
from ocdp_tpu.models import kirk as jkirk
from ocdp_tpu_torch import convert
from ocdp_tpu_torch.engine import SolveResult, value_iteration_finite
from ocdp_tpu_torch.models import kirk as tkirk

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)
GOLDEN = tkirk.KirkConfig.golden()


def _load(name):
    with np.load(os.path.join(HERE, "golden", name)) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def golden():
    return _load("kirk_golden.npz")


@pytest.fixture(scope="module")
def ref_golden():
    return _load("obj1_reference.npz")


@pytest.fixture(scope="module")
def sol_t():
    return tkirk.solve(GOLDEN, device="cpu")


@pytest.fixture(scope="module")
def sol_j():
    return jkirk.solve(jkirk.KirkConfig.golden(), impl="gather")


def test_config_matches_jax():
    assert tkirk.KirkConfig().__dict__ == jkirk.KirkConfig().__dict__
    assert GOLDEN.__dict__ == jkirk.KirkConfig.golden().__dict__


def test_final_values_match_reference_mat(ref_golden, sol_t):
    np.testing.assert_allclose(sol_t.result.values.numpy(),
                               ref_golden["J_star"][:, :, 0],
                               rtol=1e-4, atol=1e-2)


def test_per_stage_values_match_reference_mat(ref_golden):
    p = tkirk.build(GOLDEN, device="cpu")
    res = value_iteration_finite(p.plan, p.stage_cost, GOLDEN.N - 1,
                                 probe_window=((0, 35), (0, 35)))
    ref_stack = np.moveaxis(ref_golden["J_star"][:, :, :GOLDEN.N - 1],
                            2, 0)[::-1]
    np.testing.assert_allclose(res.probes.numpy(), ref_stack,
                               rtol=1e-4, atol=1e-2)


def test_policy_stack_matches_reference_mat(ref_golden, sol_t):
    ours = sol_t.u_star.numpy()
    ref = np.moveaxis(ref_golden["u_star"][:, :, :129], 2, 0)
    diff = np.abs(ours - ref)
    u_step = (ref_golden["u_max"] - ref_golden["u_min"]) / \
        (ref_golden["du"] - 1)
    assert (diff < 1e-4).mean() > 0.999
    assert diff.max() < 1.5 * u_step


def test_solve_matches_golden(golden, sol_t):
    np.testing.assert_allclose(sol_t.result.values.numpy(), golden["values"],
                               rtol=1e-6, atol=1e-5)
    assert (sol_t.result.argmin.numpy() == golden["argmin"]).mean() > 0.999


def test_rollout_matches_golden_trajectory(golden, sol_t):
    X, U = tkirk.optimal_path(sol_t, (2.0, 1.0))
    assert X.shape == (GOLDEN.N, 2) and U.shape == (GOLDEN.N - 1,)
    np.testing.assert_allclose(X.numpy(), golden["X"], atol=1e-4)
    np.testing.assert_allclose(U.numpy(), golden["U"], atol=1e-3)


def test_solve_matches_jax(sol_t, sol_j):
    vt, vj = sol_t.result.values.numpy(), np.asarray(sol_j.result.values)
    assert np.abs(vt.astype(np.float64) - vj).max() <= \
        2e-6 * np.abs(vj).max()
    pt, pj = sol_t.result.policies.numpy(), np.asarray(sol_j.result.policies)
    assert pt.shape == pj.shape == (GOLDEN.N - 1, 35, 35)
    assert (pt == pj).mean() >= 0.999
    assert sol_t.result.num_sweeps == int(sol_j.result.num_sweeps)
    np.testing.assert_array_equal(sol_t.u_star[0].numpy(),
                                  sol_t.problem.u_mesh[pt[-1]])


def _jax_solution_in_port(sol_j):
    r = sol_j.result
    res = convert.result_from_numpy(
        np.asarray(r.values), np.asarray(r.argmin), np.asarray(r.policies),
        num_sweeps=int(r.num_sweeps), device="cpu")
    return tkirk.KirkSolution(tkirk.build(GOLDEN, device="cpu"), res)


def _port_solution_in_jax(sol_t):
    r = convert.to_numpy(sol_t.result)
    res = jengine.SolveResult(
        jnp.asarray(r.values), jnp.asarray(r.argmin),
        jnp.asarray(r.policies), jnp.asarray(r.num_sweeps, jnp.int32),
        jnp.asarray(r.converged))
    return jkirk.KirkSolution(jkirk.build(jkirk.KirkConfig.golden()), res)


@pytest.mark.parametrize("mode,ssu_num", [("Nssu", 0), ("ssu", 0),
                                          ("ssu", 60)])
@pytest.mark.parametrize("solved_by", ["jax", "port"])
def test_optimal_path_matches_jax(sol_t, sol_j, mode, ssu_num, solved_by):
    """One controller, rolled out by both packages."""
    if solved_by == "jax":
        st, sj = _jax_solution_in_port(sol_j), sol_j
    else:
        st, sj = sol_t, _port_solution_in_jax(sol_t)
    Xt, Ut = tkirk.optimal_path(st, (2.0, 1.0), mode=mode, ssu_num=ssu_num)
    Xj, Uj = jkirk.optimal_path(sj, (2.0, 1.0), mode=mode, ssu_num=ssu_num)
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), atol=1e-4)
    np.testing.assert_allclose(Ut.numpy(), np.asarray(Uj), atol=1e-3)


def test_convert_round_trip(sol_t):
    plan = sol_t.problem.plan
    back = convert.plan_from_numpy(*convert.to_numpy(plan), device="cpu")
    assert back.grid_shape == plan.grid_shape
    for a, b in zip(back.lo + back.frac, plan.lo + plan.frac):
        assert a.dtype == b.dtype and torch.equal(a, b)
    r = sol_t.result
    r2 = convert.result_from_numpy(**convert.to_numpy(r)._asdict(),
                                   device="cpu")
    assert isinstance(r2, SolveResult)
    for name in ("values", "argmin", "policies"):
        a, b = getattr(r2, name), getattr(r, name)
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert (r2.num_sweeps, r2.converged, r2.probes, r2.checks) == \
        (r.num_sweeps, r.converged, None, None)
    with pytest.raises(TypeError):
        convert.to_numpy([1, 2])
    with pytest.raises(ValueError, match="num_sweeps"):
        convert.result_from_numpy(np.zeros(2), np.zeros(2), device="cpu")
    with pytest.raises(ValueError, match="one entry per axis"):
        convert.plan_from_numpy([np.zeros(2)], [], (4,), device="cpu")


def test_solve_rejects_bad_impl():
    small = tkirk.KirkConfig(N=2, dx=5, du=4)
    with pytest.raises(ValueError, match="CUDA"):
        tkirk.solve(small, device="cpu", impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        tkirk.solve(small, device="cpu", impl="pallas")
    sol = tkirk.solve(small, device="cpu", impl="gather")
    with pytest.raises(ValueError, match="mode"):
        tkirk.optimal_path(sol, mode="steady")


def test_verbose_prints_per_stage(capsys):
    small = tkirk.KirkConfig(N=4, dx=5, du=4)
    sol = tkirk.solve(small, device="cpu", verbose=True,
                      store_policies=False)
    assert sol.result.policies is None
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" - ")[0] for ln in lines] == ["step 1", "step 2",
                                                    "step 3"]
