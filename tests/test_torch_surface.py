"""The port's surface modules: ``graft_entry.entry`` against the JAX
package's ``__graft_entry__.entry``, ``profiling.trace``, and the import
boundary of the five surface modules (none imports jax, the JAX package,
the root ``bench.py`` or ``__graft_entry__.py``).

``entry``: values to f32 rounding, |dV| <= 2e-6 * max(|V|, 1), and argmin
equal except where the two chosen actions' totals lie within that
tolerance (exact ties); measured on these inputs: bitwise, no argmin
differs.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from ocdp_tpu_torch import graft_entry, profiling
from ocdp_tpu_torch.models import kirk
from ocdp_tpu_torch.ops.interp import interp_apply
from ocdp_tpu_torch.parallel import dryrun

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
V_RTOL = 2e-6


@pytest.fixture(scope="module")
def steps():
    return jentry.entry(), graft_entry.entry(device="cpu")


@pytest.mark.parametrize("seed", [None, 0, 1])
def test_entry_step_matches_jax(steps, seed):
    (jstep, (jv0,)), (tstep, (tv0,)) = steps
    assert tuple(tv0.shape) == tuple(jv0.shape)
    assert tv0.dtype == torch.float32 and not bool(tv0.any())
    v = (np.zeros(tv0.shape, np.float32) if seed is None else
         np.random.default_rng(seed).uniform(0, 400, tv0.shape)
         .astype(np.float32))
    jvals, jarg = (np.asarray(x) for x in jstep(jnp.asarray(v)))
    tvals, targ = (x.numpy() for x in tstep(torch.from_numpy(v)))
    tol = V_RTOL * max(float(np.abs(jvals).max()), 1.0)
    np.testing.assert_allclose(tvals, jvals, rtol=0, atol=tol)
    problem = kirk.build(kirk.KirkConfig.golden(), device="cpu")
    totals = (interp_apply(torch.from_numpy(v), problem.plan)
              + problem.stage_cost).numpy()
    diff = np.nonzero(jarg != targ)
    gap = np.abs(totals[diff + (jarg[diff],)] - totals[diff + (targ[diff],)])
    assert bool((gap <= tol).all()), f"argmin differs beyond ties: {gap}"


def test_entry_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_entry_reexports_the_dryrun():
    assert graft_entry.dryrun_multichip is dryrun.dryrun_multichip


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "traces"
    with profiling.trace(log_dir) as t:
        sol = kirk.solve(kirk.KirkConfig(N=4, dx=12, du=10), device="cpu")
        assert t.path is None
    assert bool(torch.isfinite(sol.result.values).all())
    assert t.path is not None and t.path.parent == log_dir
    events = json.loads(t.path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "cpu_op"}
    assert any("gather" in n or "index" in n for n in names), sorted(names)
    assert len(t.profile.key_averages()) > 0


GUARD = ("import sys, {imp}; "
         "bad = sorted(m for m in sys.modules if m in "
         "('jax', 'ocdp_tpu', 'bench', '__graft_entry__') "
         "or m.startswith(('jax.', 'ocdp_tpu.'))); "
         "print(bad); sys.exit(1 if bad else 0)")


@pytest.mark.parametrize("module", ["bench", "__main__", "viz",
                                    "graft_entry", "profiling"])
def test_surface_module_imports_no_jax(module):
    code = GUARD.format(imp=f"ocdp_tpu_torch.{module}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_run_imports_no_jax():
    """``python -m ocdp_tpu_torch solve position`` from the repository root,
    run to its end, leaves jax and the JAX package out."""
    run = ("import runpy; sys.argv = ['ocdp_tpu_torch', 'solve', 'position', "
           "'--sweeps', '1', '--device', 'cpu', '--quiet']; "
           "runpy.run_module('ocdp_tpu_torch', run_name='__main__')")
    code = GUARD.format(imp="torch").replace("; bad", f"; {run}; bad", 1)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"problem": "position"' in proc.stdout
