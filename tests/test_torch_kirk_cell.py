"""Kirk's benchmark cell ``kirk-solve`` on the CPU: the plain reference
(``benchmark/reference/kirk.py``) against MATLAB's own solve at the golden
configuration, stage by stage; the port (the gather solve, and the finite
engine through B.1's plain affine version) against the reference at a
small size, over cost weights drawn as the cell's mix draws them; the
cell's check passing the port and failing the control; B.1's roofline
count held to ``chip_smoke.py``'s; and one ``ocdp.build`` span a
``kirk.solve`` in either branch. This file imports no jax."""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import control, harness, traffic
from benchmark.entries.common import as_config
from benchmark.reference import compare
from benchmark.reference import kirk as ref
from benchmark.rooflines import affine2d
from ocdp_tpu_torch.engine import SolveResult, value_iteration_finite
from ocdp_tpu_torch.models import kirk
from ocdp_tpu_torch.ops import fused_backup2d as fb
from ocdp_tpu_torch.ops.interp import PlanShape

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)
CELL = "kirk-solve"
GOLDEN = kirk.KirkConfig.golden()
SMALL = {"dx": 21, "du": 16, "N": 100}
MIX = {"warmup": {"count": 1}, "trace": {"requests": 1}}


def _params(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _cell():
    return harness.load_cell(CELL, device="cpu", config_overrides=SMALL,
                             mix_overrides=MIX)


@pytest.fixture(scope="module")
def matlab():
    with np.load(os.path.join(HERE, "golden", "obj1_reference.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def golden_ref():
    return ref.solve(_params(GOLDEN), "cpu", tables=True)


def test_the_configuration_is_kirk_as_published():
    conf = json.loads((harness.ROOT / "benchmark" / "configs"
                       / "kirk-ref.json").read_text())
    assert conf["class"] == "ocdp_tpu_torch.models.kirk.KirkConfig"
    assert as_config(kirk.KirkConfig, conf["params"]) == kirk.KirkConfig()
    assert set(conf["params"]) == set(_params(kirk.KirkConfig()))
    assert conf["reduced"] == conf["assumed"] == [] and conf["chips"] == 1


def test_reference_values_match_matlab_every_stage(matlab, golden_ref):
    want = np.moveaxis(matlab["J_star"][:, :, :GOLDEN.N - 1], 2, 0)[::-1]
    got = golden_ref.tables.numpy()
    assert got.shape == want.shape == (GOLDEN.N - 1, 35, 35)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(golden_ref.solution.values[0].numpy(),
                               matlab["J_star"][:, :, 0], rtol=1e-4,
                               atol=1e-2)


def test_reference_policies_match_matlab_every_stage(matlab, golden_ref):
    u = ref.grids(_params(GOLDEN))[1]
    got = u[golden_ref.policies.numpy()]
    want = np.moveaxis(matlab["u_star"][:, :, :GOLDEN.N - 1], 2, 0)[::-1]
    step = (GOLDEN.u_max - GOLDEN.u_min) / (GOLDEN.du - 1)
    assert np.abs(got - want).max() <= step * (1 + 1e-6)
    assert golden_ref.solution.sweeps == [GOLDEN.N - 1]


def _drawn(seed):
    cell = _cell()
    params = traffic.Generator(cell.mix, cell.config, seed).next()
    return cell, {**cell.config, **params}


def _affine_finite(cfg):
    p = kirk.build(cfg, device="cpu")
    return value_iteration_finite(p.plan, p.stage_cost, cfg.N - 1,
                                  store_policies=True,
                                  backup=kirk.affine_backup(p, device="cpu"))


@pytest.mark.parametrize("path", ["gather", "affine"])
@pytest.mark.parametrize("seed", [11, 12, 2147483647 + 12])
def test_port_matches_the_reference(seed, path):
    cell, drawn = _drawn(seed)
    cfg = as_config(kirk.KirkConfig, drawn)
    assert cfg.Q != kirk.KirkConfig().Q and cfg.R != kirk.KirkConfig().R
    res = kirk.solve(cfg, device="cpu").result if path == "gather" \
        else _affine_finite(cfg)
    n = cfg.dx
    assert res.policies.shape == (cfg.N - 1, n, n)
    r = ref.solve(drawn, "cpu", policies=res.policies)
    got = compare.solve_numbers(res.values.reshape(1, n, n),
                                res.argmin.reshape(1, n, n), r.solution,
                                [cfg.du])
    limits = cell.mix["check"]["limits"]
    assert got["value_err"] <= min(limits["value_err"], 1e-4)
    assert max(got["policy_gap"], r.policy_gap) <= limits["policy_gap"]
    assert res.num_sweeps == r.solution.sweeps[0] == cfg.N - 1


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_check_passes_the_port_and_fails_the_control(seed):
    cell = _cell()
    limits = cell.mix["check"]["limits"]
    assert control.fails(control.program_numbers(cell, [seed])[0],
                         limits) == []
    assert "value_err" in control.fails(control.control_numbers(cell, seed),
                                        limits)


@pytest.mark.parametrize("kw", [{}, {"du": 20000}, {"dx": 900}],
                         ids=["published", "du20000", "dx900"])
def test_affine2d_counts_are_chip_smokes(kw):
    import chip_smoke

    cfg = kirk.KirkConfig(**kw)
    args = kirk.affine_backup(cfg, device="cpu").args
    want = chip_smoke.affine_bound(args)
    assert affine2d.kirk_sweep(_params(cfg)) == (want["flops"],
                                                 want["bytes"])
    assert affine2d.launch_shape(_params(cfg)) == (
        args.row0.numel(), args.n_splits, args.stage == fb.TABLE_GLOBAL)


def test_the_row_planner_computes_on_one_host_thread():
    """B.1's host row planner runs no torch operator: torch's CPU
    ``searchsorted`` spread its 20,000 queries over the intra-op threads,
    and their wake-ups made the published solve's set-up swing from 1 to
    tens of milliseconds on the card's host."""
    cfg = kirk.KirkConfig()
    s_r, u = kirk._meshes(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        row0, n_rows = fb.plan_rows((s_r, s_r), u, cfg.A, cfg.B,
                                    fb.CELLS_PER_BLOCK)
    ops = {e.name for e in prof.events()} - {"aten::lift_fresh"}
    assert not ops, ops
    assert row0.dtype == n_rows.dtype == torch.int64
    assert row0.shape == n_rows.shape == (625,)


def _spans(fn) -> list:
    """The port's span names ``fn()`` records, in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = sorted((e.time_range.start, -e.time_range.end, e.name)
                    for e in prof.events() if e.name.startswith("ocdp."))
    return [(n, s, -e) for s, e, n in events]


def _one_build_inside_the_solve(spans):
    names = [n for n, _, _ in spans]
    assert names.count("ocdp.build") == 1
    assert names.count("ocdp.solve") == 1
    (_, s0, e0), = [s for s in spans if s[0] == "ocdp.solve"]
    (_, s1, e1), = [s for s in spans if s[0] == "ocdp.build"]
    assert s0 <= s1 and e1 <= e0
    for name, s, _ in spans:
        if name.startswith("ocdp.engine."):
            assert s >= e1


def test_one_build_span_a_gather_solve():
    cfg = kirk.KirkConfig(N=5, dx=11, du=7)
    _one_build_inside_the_solve(_spans(lambda: kirk.solve(cfg,
                                                          device="cpu")))


def test_one_build_span_a_kernel_solve(monkeypatch):
    """The kernel branch's set-up on the CPU: the device reads as a CUDA
    device, the affine backup is built on the CPU and the engine is
    stood in for."""
    cfg = kirk.KirkConfig(N=5, dx=11, du=7)
    card = SimpleNamespace(type="cuda")
    real = kirk.affine_backup
    seen = {}

    def engine(plan, stage_cost, n, **kw):
        seen.update(plan=plan, backup=kw["backup"], n=n)
        return SolveResult(torch.zeros(11, 11), torch.zeros(11, 11),
                           None, n, False, None)

    resolve = kirk.resolve_device
    monkeypatch.setattr(kirk, "resolve_device",
                        lambda d: card if d == "cuda" else resolve(d))
    monkeypatch.setattr(kirk, "affine_backup",
                        lambda p: real(p.config, device="cpu"))
    monkeypatch.setattr(kirk, "value_iteration_finite", engine)
    spans = _spans(lambda: kirk.solve(cfg, device="cuda"))
    _one_build_inside_the_solve(spans)
    assert isinstance(seen["plan"], PlanShape) and seen["n"] == 4
    assert isinstance(seen["backup"], fb.AffineBackup2D)
