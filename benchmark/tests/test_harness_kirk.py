"""Kirk's cell ``kirk-solve``: a sound CPU run of the cell is correct, and
the control and each fault below are not; its two metrics read what they
name, and nothing without it. The cell's small size and its faults are
data here: on the CPU at 21 x 21 states, 16 controls, 99 sweeps."""

import time
from collections import Counter

import pytest
import torch

from benchmark import control, harness, tracing
from benchmark.rooflines import affine2d, peaks

CELL = "kirk-solve"
OVER = {"dx": 21, "du": 16, "N": 100}
MIX = {"warmup": {"count": 1}, "trace": {"requests": 2}}
B1 = "void (anonymous namespace)::affine_sweep<short, 0>"


def _run(seed=2147483931, trace=False):
    return harness.run_cell(CELL, seed, 0.2, trace, t0=time.perf_counter(),
                            device="cpu", config_overrides=OVER,
                            mix_overrides=MIX)


def _table(sol):
    """One value of the last table 1% off."""
    flat = sol.result.values.view(-1)
    i = int(flat.abs().argmax())
    flat[i] = flat[i] * 1.01
    return sol


def _policies_off_by_one(sol):
    """Every stage's policy one control up (down at the last control)."""
    p = sol.result.policies
    top = OVER["du"] - 1
    p.copy_(torch.where(p < top, p + 1, p - 1))
    return sol


def _one_stage_dropped(sol):
    """The policy stack one stage short."""
    r = sol.result
    return sol._replace(result=r._replace(policies=r.policies[1:]))


def _fewer_sweeps(sol):
    r = sol.result
    return sol._replace(result=r._replace(num_sweeps=r.num_sweeps - 1))


# each fault of the timed path, and the number it must fail
FAULTS = {
    "table": (_table, "value_err"),
    "policies_off_by_one": (_policies_off_by_one, "policy_gap"),
    "one_stage_dropped": (_one_stage_dropped, "policy_gap"),
    "fewer_sweeps": (_fewer_sweeps, "sweeps_diff"),
}


def test_a_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"value_err", "policy_gap", "sweeps_diff"}
    assert r["attempted"] >= 1 and r["failed"] == 0


def test_a_traced_cpu_run_is_correct():
    r = _run(trace=True)
    assert r["correct"], r["checks"]
    # no runtime calls or kernels on the CPU: the new metrics read nothing
    assert not {"affine2d_roofline_pct", "sweeps_idle_ms"} & set(r["metrics"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    from ocdp_tpu_torch.models import kirk

    real = kirk.solve
    alter, number = FAULTS[fault]
    monkeypatch.setattr(kirk, "solve", lambda *a, **kw: alter(real(*a, **kw)))
    r = _run()
    assert not r["correct"], r["checks"]
    c = r["checks"][number]
    assert c["value"] > c["limit"], r["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3, 2147483931])
def test_the_control_is_not_correct(seed):
    c = harness.load_cell(CELL, device="cpu", config_overrides=OVER,
                          mix_overrides=MIX)
    nums = control.control_numbers(c, seed)
    assert "value_err" in control.fails(nums, c.mix["check"]["limits"]), nums


def _trace(idle=(), in_span=(), kernels=(), sweeps=(199, 199), config=None):
    return tracing.Trace({}, {}, 0, len(sweeps), 1.0, 0.5, dict(kernels),
                         Counter(), Counter(dict(in_span)), dict(idle),
                         [{"sweeps": s} for s in sweeps], config or {})


def _read(name, t):
    return harness.load_module("metrics", name).read(t)


def test_affine2d_roofline_reads_b1_alone():
    cfg = harness.load_cell(CELL, device="cpu").config
    one = peaks.bound_s(*affine2d.kirk_sweep(cfg))
    t = _trace(kernels={B1 + "(AffineParams, float const*)": 0.016,
                        "elementwise_kernel": 1.0}, config=cfg)
    assert _read("affine2d_roofline_pct", t) == pytest.approx(
        100.0 * one * 398 / 0.016)
    assert _read("affine2d_roofline_pct",
                 _trace(kernels={"elementwise_kernel": 1.0},
                        config=cfg)) is None


def test_the_published_sweep_is_bound_by_operations():
    cfg = harness.load_cell(CELL, device="cpu").config
    flops, nbytes = affine2d.kirk_sweep(cfg)
    assert affine2d.launch_shape(cfg) == (625, 32, False)
    assert flops / peaks.FP32_FLOP_PER_S > nbytes / peaks.HBM_BYTES_PER_S
    assert peaks.bound_s(flops, nbytes) == pytest.approx(3.88e-6, rel=0.01)


def test_sweeps_idle_reads_the_sweeps_span():
    name = "ocdp.engine.sweeps"
    t = _trace({name: 0.3, "ocdp.build": 0.1},
               {(name, "cudaLaunchKernel"): 398,
                ("ocdp.solve", "cudaLaunchKernel"): 420})
    assert _read("sweeps_idle_ms", t) == pytest.approx(150.0)
    none = _trace({"ocdp.solve": 1.3},
                  {("ocdp.solve", "cudaLaunchKernel"): 200})
    assert _read("sweeps_idle_ms", none) == 0.0
    assert _read("sweeps_idle_ms", _trace(sweeps=())) is None
    assert _read("sweeps_idle_ms", t._replace(busy_s=0.0)) is None


def test_every_cell_of_sweeps_idle_collects_the_port_spans():
    """The metric reads the spans ``idle_unspanned_pct`` collects."""
    from benchmark import ocdp

    cells = {m["name"]: set(m["workloads"]) for m in harness.load_cell(
        CELL, device="cpu").per_layer}
    assert cells["sweeps_idle_ms"] <= cells["idle_unspanned_pct"]
    mod = harness.load_module("metrics", "idle_unspanned_pct")
    assert "benchmark.ocdp:engine.sweeps" in mod.SPANS == ocdp.TARGETS
