"""The envelope cell ``attitude6d-envelope-solve``: B.5's roofline count
held to ``chip_smoke.py``'s for the same plan; a sound CPU run of the cell
is correct and the control, a wrong checkpoint and a wrong table are not;
the checkpoint span opens once a segment; its two metrics read what they
name, and nothing without it. On the CPU at 5^3 x 4^3, 9 sweeps in
segments of 4."""

import dataclasses
import time
from collections import Counter

import pytest
import torch

from benchmark import control, harness, tracing
from benchmark.rooflines import backup6d, peaks, recompute6d

CELL = "attitude6d-envelope-solve"
OVER = {"n_mesh_w": 5, "n_mesh_q": 4, "T_final": 0.05}
MIX = {"fixed": {"segment_size": 4}, "warmup": {"count": 1},
       "trace": {"requests": 1}}
B5 = "void (anonymous namespace)::backup6d_sweep<unsigned char, true, true>"
CUBE = "void (anonymous namespace)::backup6d_sweep_cube<false>"


def _params(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("kw", [dict(n_mesh_w=5, n_mesh_q=4),
                                dict(n_mesh_w=6, n_mesh_q=5, h=0.01),
                                dict(n_mesh_w=9, n_mesh_q=6, T_final=0.5)])
def test_recompute6d_counts(kw):
    import chip_smoke
    from ocdp_tpu_torch.models import attitude
    from ocdp_tpu_torch.ops.backup6d import Backup6D

    cfg = attitude.AttitudeConfig(**kw)
    _, plan, cost = attitude.build_full(cfg, lane_mode="recompute",
                                        device="cpu")
    bk = Backup6D(plan, cost, argmin_dtype=torch.uint8, carry_padded=True,
                  consume_plan=True)
    want = chip_smoke.backup6d_args_bound(bk.args, bk.NE)
    got = recompute6d.attitude_sweep(_params(cfg))
    assert got == (want["flops"], want["bytes"])
    s = recompute6d.attitude_structure(_params(cfg))
    assert tuple(s[3]) == tuple(bk.row_combos)
    assert tuple(s[4]) == tuple(bk.lane_combos)
    assert s[6] == bk.action_digits


def test_recompute6d_is_b3_with_the_lanes_recomputed():
    """Against B.3's count of the same structure: the recompute's
    operations a cell added; 24 B a cell of lane plan and 3 B a cell of
    argmin taken off, 12 B a row and 16 B a lane added."""
    s = backup6d.attitude_structure(dict(
        harness.load_cell(CELL, device="cpu", config_overrides=OVER).config))
    nw, ne = s[0], s[1]
    f3, b3 = backup6d.sweep(*s)
    f5, b5 = recompute6d.sweep(*s)
    assert f5 - f3 == recompute6d.OPS_PER_CELL * nw * ne == 167 * nw * ne
    assert b5 - b3 == -27 * nw * ne + 12 * nw + 16 * ne


def _run(seed=2147483921, trace=False):
    return harness.run_cell(CELL, seed, 0.2, trace, t0=time.perf_counter(),
                            device="cpu", config_overrides=OVER,
                            mix_overrides=MIX)


def test_a_sound_run_is_correct():
    r = _run()
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"value_err", "policy_gap", "sweeps_diff",
                                "checkpoint_err"}
    assert r["checks"]["checkpoint_err"]["value"] == 0.0


def test_a_traced_cpu_run_is_correct():
    r = _run(trace=True)
    assert r["correct"], r["checks"]
    # no runtime calls or kernels on the CPU: the new metrics read nothing
    assert not {"checkpoint_idle_ms", "recompute6d_roofline_pct"} \
        & set(r["metrics"])


def test_the_control_is_not_correct():
    c = harness.load_cell(CELL, device="cpu", config_overrides=OVER,
                          mix_overrides=MIX)
    for seed in (1, 2, 3):
        nums = control.control_numbers(c, seed)
        assert "value_err" in control.fails(nums, c.mix["check"]["limits"])


def test_a_checkpoint_that_is_not_the_table_is_not_correct(monkeypatch):
    from ocdp_tpu_torch import engine

    real = engine.save_values

    def save(path, values, sweep, axes, **kw):
        values = values.clone()
        values.view(-1)[3] += 1.0
        real(path, values, sweep, axes, **kw)

    monkeypatch.setattr(engine, "save_values", save)
    r = _run()
    assert not r["correct"]
    assert r["checks"]["checkpoint_err"]["value"] > 0.0


def test_an_altered_table_is_not_correct(monkeypatch):
    from ocdp_tpu_torch.models import attitude

    real = attitude.solve_full

    def solve(*a, **kw):
        sol = real(*a, **kw)
        flat = sol.result.values.view(-1)
        i = int(flat.abs().argmax())
        flat[i] = flat[i] * 1.1
        return sol

    monkeypatch.setattr(attitude, "solve_full", solve)
    r = _run()
    assert not r["correct"], r["checks"]
    assert r["checks"]["value_err"]["value"] > 0.01


def _trace(idle=(), in_span=(), kernels=(), sweeps=(99, 99), config=None):
    return tracing.Trace({}, {}, 0, len(sweeps), 1.0, 0.5, dict(kernels),
                         Counter(), Counter(dict(in_span)), dict(idle),
                         [{"sweeps": s} for s in sweeps], config or {})


def _read(name, t):
    return harness.load_module("metrics", name).read(t)


def test_checkpoint_idle_reads_the_checkpoint_span():
    name = "engine.save_values"
    t = _trace({name: 1.2, "ocdp.engine.check": 0.1},
               {(name, "cudaMemcpy"): 4,
                ("ocdp.solve", "cudaLaunchKernel"): 200})
    assert _read("checkpoint_idle_ms", t) == pytest.approx(600.0)
    none = _trace({"ocdp.solve": 1.3},
                  {("ocdp.solve", "cudaLaunchKernel"): 200})
    assert _read("checkpoint_idle_ms", none) is None
    mod = harness.load_module("metrics", "checkpoint_idle_ms")
    assert [tracing.span_name(x) for x in mod.SPANS] == [name]


def _spans(kw):
    """The names of the host events a profiled CPU solve of the cell's
    configuration records with the metric's span wrapped in."""
    from ocdp_tpu_torch.models import attitude

    mod = harness.load_module("metrics", "checkpoint_idle_ms")
    cfg = attitude.AttitudeConfig(**OVER)
    with tracing.wrapped(mod.SPANS, tracing.spanner):
        with torch.profiler.profile() as prof:
            attitude.solve_full(cfg, device="cpu", **kw)
    return [e.name for e in prof.events()]


def test_the_checkpoint_span_opens_once_a_segment(tmp_path):
    from ocdp_tpu_torch import engine

    real = engine.save_values
    seg = dict(lane_mode="recompute", flat=True, carry_padded=True,
               segment_size=4, tol=1e-6, tol_mode="rel")
    got = _spans(dict(seg, checkpoint_path=str(tmp_path / "c.npz")))
    assert got.count("engine.save_values") == 3      # segments 4, 4, 1
    assert "engine.save_values" not in _spans(seg)
    assert engine.save_values is real


def test_recompute6d_roofline_reads_b5_alone():
    cfg = harness.load_cell(CELL, device="cpu", config_overrides=OVER).config
    one = peaks.bound_s(*recompute6d.attitude_sweep(cfg))
    t = _trace(kernels={B5 + "(float const*, int)": 0.5, CUBE: 7.0,
                        "elementwise_kernel": 1.0}, sweeps=(9, 9),
               config=cfg)
    assert _read("recompute6d_roofline_pct", t) == pytest.approx(
        100.0 * one * 18 / 0.5)
    assert _read("recompute6d_roofline_pct",
                 _trace(kernels={CUBE: 7.0}, config=cfg)) is None
