"""Port engines (ocdp_tpu_torch/engine.py) vs the JAX package's, golden Kirk.

Values |dV| <= 2e-6 * max(|V|, 1), policies >= 99.9% equal, and the same
num_sweeps and stop decision: XLA:CPU fuses and contracts the backup's
weight algebra where PyTorch rounds every op, so single sweeps differ at the
ulp level (relative 7.5e-7 after the full golden solve).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu import diagnostics as jdiag
from ocdp_tpu import engine as jengine
from ocdp_tpu.models import kirk as jkirk
from ocdp_tpu_torch import diagnostics as tdiag
from ocdp_tpu_torch import engine as tengine
from ocdp_tpu_torch.models import kirk as tkirk
from ocdp_tpu_torch.ops.fused_backup2d import FusedBackup2D
from ocdp_tpu_torch.profiling import SweepTimer, sweep_callback

torch.set_num_threads(2)

GOLDEN = tkirk.KirkConfig.golden()
SWEEPS = GOLDEN.N - 1
WINDOW = ((3, 10), (5, 12))


@pytest.fixture(scope="module")
def problems():
    return (tkirk.build(GOLDEN, device="cpu"),
            jkirk.build(jkirk.KirkConfig.golden()))


def _close(got, want, frac=2e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= frac * max(np.abs(want).max(), 1.0)


@pytest.fixture(scope="module")
def finite_pair(problems):
    pt, pj = problems
    rt = tengine.value_iteration_finite(pt.plan, pt.stage_cost, SWEEPS,
                                        store_policies=True,
                                        probe_window=WINDOW)
    rj = jengine.value_iteration_finite(pj.plan, pj.stage_cost, SWEEPS,
                                        store_policies=True,
                                        probe_window=WINDOW)
    return rt, rj


def test_finite_matches_jax(finite_pair):
    rt, rj = finite_pair
    assert rt.num_sweeps == int(rj.num_sweeps) == SWEEPS
    assert rt.converged is False
    _close(rt.values, rj.values)
    assert rt.policies.dtype == torch.uint8
    assert rt.policies.shape == (SWEEPS, 35, 35)
    assert (rt.policies.numpy() == np.asarray(rj.policies)).mean() >= 0.999
    assert rt.argmin.dtype == torch.int32
    assert torch.equal(rt.argmin, rt.policies[-1].to(torch.int32))


def test_probes_match_jax(finite_pair):
    rt, rj = finite_pair
    assert rt.probes.shape == (SWEEPS, 10, 12)
    _close(rt.probes, rj.probes)
    assert torch.equal(rt.probes[-1], rt.values[3:13, 5:17])
    assert tdiag.compare_stage_probes(rt.probes, np.asarray(rj.probes),
                                      atol=1e-3)


def test_finite_options(problems):
    pt, _ = problems
    base = tengine.value_iteration_finite(pt.plan, pt.stage_cost, 4)
    assert base.policies is None and base.probes is None
    narrow = tengine.value_iteration_finite(pt.plan, pt.stage_cost, 4,
                                            narrow_argmin_result=True)
    assert narrow.argmin.dtype == torch.uint8
    assert torch.equal(narrow.argmin.to(torch.int32), base.argmin)
    wide = tengine.value_iteration_finite(pt.plan, pt.stage_cost, 4,
                                          store_policies=True,
                                          policy_dtype=torch.int32)
    assert wide.policies.dtype == torch.int32
    wide_problem = tkirk.build(tkirk.KirkConfig(N=2, dx=6, du=300),
                               device="cpu")
    with pytest.raises(ValueError, match="cannot hold"):
        tengine.value_iteration_finite(wide_problem.plan,
                                       wide_problem.stage_cost, 1,
                                       store_policies=True,
                                       policy_dtype=torch.uint8)
    with pytest.raises(ValueError, match="leaves the grid"):
        tengine.value_iteration_finite(pt.plan, pt.stage_cost, 1,
                                       probe_window=((30, 10), (0, 2)))
    # two sweeps from zero == one sweep from the one-sweep table
    one = tengine.value_iteration_finite(pt.plan, pt.stage_cost, 1)
    resumed = tengine.value_iteration_finite(pt.plan, pt.stage_cost, 1,
                                             init_values=one.values)
    two = tengine.value_iteration_finite(pt.plan, pt.stage_cost, 2)
    assert torch.equal(resumed.values, two.values)


def test_backup_argument_runs_the_given_backup(problems):
    """``backup=`` replaces the gather oracle; the fused backup's plain
    version gives the same solve bitwise on the CPU."""
    pt, _ = problems
    calls = []
    bk = FusedBackup2D(pt.plan, pt.stage_cost)

    def counting(v):
        calls.append(1)
        return bk(v)

    ref = tengine.value_iteration_finite(pt.plan, pt.stage_cost, 6,
                                         store_policies=True)
    got = tengine.value_iteration_finite(pt.plan, pt.stage_cost, 6,
                                         store_policies=True,
                                         backup=counting)
    assert len(calls) == 6
    assert torch.equal(got.values, ref.values)
    assert torch.equal(got.policies, ref.policies)


def test_converged_to_cap_matches_jax(problems):
    """tol=0 never stops; the check log and the tables follow JAX."""
    pt, pj = problems
    rt = tengine.value_iteration_converged(pt.plan, pt.stage_cost, 40,
                                           check_every=2, tol=0.0)
    rj = jengine.value_iteration_converged(pj.plan, pj.stage_cost, 40,
                                           check_every=2, tol=0.0)
    assert (rt.num_sweeps, rt.converged) == (int(rj.num_sweeps),
                                            bool(rj.converged)) == (40, False)
    _close(rt.values, rj.values)
    assert (rt.argmin.numpy() == np.asarray(rj.argmin)).mean() >= 0.999
    ct, cj = rt.checks.numpy(), np.asarray(rj.checks)
    assert ct.shape == cj.shape == (20, 3)
    np.testing.assert_array_equal(ct[:, 0], cj[:, 0])          # k_s column
    np.testing.assert_array_equal(ct[:, 0], np.arange(40, 0, -2))
    # errorF: differences of float32 sums of ~1e5 -> compare to the sums
    assert np.abs(ct[:, 1] - cj[:, 1]).max() <= 2e-6 * 35 * 35 * \
        float(np.abs(np.asarray(rj.values)).max())
    # errorU: differences of argmin-id sums (integers) differ only where a
    # tie flips, one action step apiece
    assert np.abs(ct[:, 2] - cj[:, 2]).max() <= 0.001 * 35 * 35 * 100
    # the finite engine gives the same table
    rf = tengine.value_iteration_finite(pt.plan, pt.stage_cost, 40)
    assert torch.equal(rf.values, rt.values)
    assert torch.equal(rf.argmin, rt.argmin)


def test_converged_rel_stop_matches_jax(problems):
    """A relative stop that fires: both packages stop at the same check."""
    pt, pj = problems
    kw = dict(check_every=2, tol=2e-3, tol_mode="rel")
    seen = []
    rt = tengine.value_iteration_converged(
        pt.plan, pt.stage_cost, 200,
        on_check=lambda k, ef, eu: seen.append((k, ef, eu)), **kw)
    rj = jengine.value_iteration_converged(pj.plan, pj.stage_cost, 200, **kw)
    assert rt.converged is True and bool(rj.converged)
    assert rt.num_sweeps == int(rj.num_sweeps)
    assert 2 < rt.num_sweeps < 200
    n = (rt.num_sweeps + 1) // 2      # checks after sweeps 1, 3, 5, ...
    assert len(seen) == n
    assert [k for k, _, _ in seen] == list(range(200, 200 - 2 * n, -2))
    assert np.all(rt.checks.numpy()[n:] == 0.0)
    np.testing.assert_allclose(rt.checks.numpy()[:n, 1],
                               [ef for _, ef, _ in seen], rtol=1e-6)
    _close(rt.values, rj.values)
    assert rt.argmin.dtype == torch.int32


def test_converged_options(problems):
    pt, _ = problems
    huge = tengine.value_iteration_converged(pt.plan, pt.stage_cost, 20,
                                             check_every=5, tol=1e12)
    assert huge.converged and huge.num_sweeps == 1
    assert float(huge.checks[0, 0]) == 20.0
    narrow = tengine.value_iteration_converged(
        pt.plan, pt.stage_cost, 3, check_every=3, tol=0.0,
        narrow_argmin_result=True)
    assert narrow.argmin.dtype == torch.uint8
    with pytest.raises(ValueError, match="tol_mode"):
        tengine.value_iteration_converged(pt.plan, pt.stage_cost, 2,
                                          tol_mode="max")


@pytest.mark.parametrize("err,fsum,tol,mode", [
    (0.5, 10.0, 1.0, "abs"), (1.5, 10.0, 1.0, "abs"),
    (0.5, 1e6, 1e-6, "rel"), (2.0, 1e6, 1e-6, "rel"),
    (0.5, 0.1, 1.0, "rel"), (-3.0, 0.0, 0.0, "abs")])
def test_convergence_stop_matches_jax(err, fsum, tol, mode):
    assert tengine.convergence_stop(err, fsum, tol, mode) == \
        bool(jengine.convergence_stop(jnp.float32(err), jnp.float32(fsum),
                                      tol, mode))


@pytest.mark.parametrize("n", [1, 100, 256, 257, 1000, 32768, 32769])
def test_policy_dtype_for_matches_jax(n):
    assert str(tengine.policy_dtype_for(n)).removeprefix("torch.") == \
        np.dtype(jengine.policy_dtype_for(n)).name


def test_sweep_callbacks(problems, capsys):
    pt, _ = problems
    t = SweepTimer(verbose=True)
    tengine.value_iteration_finite(pt.plan, pt.stage_cost, 3,
                                   on_sweep=t.on_sweep)
    assert t.total_sweeps == 3 and t.sweeps_per_s > 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(" - ")[0] for ln in out] == ["step 1", "step 2",
                                                  "step 3"]
    assert sweep_callback(False) is None
    on_check = sweep_callback(True, kind="check")
    tengine.value_iteration_converged(pt.plan, pt.stage_cost, 4,
                                      check_every=2, tol=0.0,
                                      on_check=on_check)
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(" - ")[0] for ln in out] == ["stage 4", "stage 2"]
    assert "errorF" in out[0] and "errorU" in out[0]


def test_compare_solutions_matches_jax(finite_pair):
    rt, rj = finite_pair
    for atol in (0.0, 1e-4, 1e-2):
        got = tdiag.compare_solutions(rt, rj, atol=atol)
        want = jdiag.compare_solutions(
            tengine.SolveResult(rt.values.numpy(), rt.argmin.numpy(),
                                None, 0, False), rj, atol=atol)
        assert tuple(got) == tuple(want)
    assert tdiag.compare_solutions(rt, rt)
    with pytest.raises(ValueError, match="shape"):
        tdiag.compare_solutions(rt, tengine.SolveResult(
            rt.values[:3], rt.argmin, None, 0, False))
