"""The check that decides ``correct``: a sound run of the port passes it,
and it fails the control (the reference in bfloat16 in the port's place)
and runs whose timed path is broken underneath: a sweep or a stage that
returns its state unchanged, half of the batch left out, an answer
altered where it is produced. All on the CPU at small sizes, with the
limits of the cells; the harness's look for a card is skipped. (The
cells run on one card, so no exchange between chips can be left out.)"""

import contextlib
import importlib
import time

import pytest
import torch

from benchmark import control, harness
from benchmark.reference import compare
from benchmark.tests.conftest import ALL, CELLS, SMALL


def _run(cell, seed=21):
    over, mix = SMALL[cell]
    return harness.run_cell(cell, seed, 0.2, False, t0=time.perf_counter(),
                            device="cpu", config_overrides=over,
                            mix_overrides=mix, bench=ALL)


@contextlib.contextmanager
def patched(target, make):
    module, attr = target.split(":")
    obj = importlib.import_module(module)
    *path, last = attr.split(".")
    for p in path:
        obj = getattr(obj, p)
    orig = getattr(obj, last)
    setattr(obj, last, make(orig))
    try:
        yield
    finally:
        setattr(obj, last, orig)


def _bump_max(v):
    """One answer altered: the largest value raised by a tenth."""
    flat = v.view(-1)
    i = int(flat.abs().argmax())
    flat[i] = flat[i] * 1.1


# ---- faults of the timed paths, each (target, make) ----

def _batch_unchanged(orig):
    def sweep(self, cur, nxt, argmin, active):
        for c in active:
            nxt[c].copy_(cur[c])
    return sweep


def _batch_half(orig):
    def sweep(self, cur, nxt, argmin, active):
        half = tuple(active[:max(1, len(active) // 2)])
        orig(self, cur, nxt, argmin, half)
        for c in active:
            if c not in half:
                nxt[c].copy_(cur[c])
    return sweep


def _converged_altered(orig):
    def run(*args, **kwargs):
        res = orig(*args, **kwargs)
        _bump_max(res[0].values)
        return res
    return run


def _b6_unchanged(orig):
    def call(self, values):
        from ocdp_tpu_torch.ops.backup import BackupResult
        return BackupResult(values.clone(), torch.zeros_like(
            values, dtype=torch.int32))
    return call


def _b6_half(orig):
    def call(self, values):
        res = orig(self, values)
        v = res.values.reshape(self.NW, self.NE)
        v[self.NW // 2:] = values.reshape(self.NW, self.NE)[self.NW // 2:]
        return res
    return call


def _finite_altered(orig):
    def run(*args, **kwargs):
        res = orig(*args, **kwargs)
        _bump_max(res.values)
        return res
    return run


def _rk4_unchanged(orig):
    def span(f, t0, t1, y0, **kw):
        return y0.clone()
    return span


def _rk4_half(orig):
    def span(f, t0, t1, y0, **kw):
        y = orig(f, t0, t1, y0, **kw).clone()
        y[y.shape[0] // 2:] = y0[y.shape[0] // 2:]
        return y
    return span


def _rk4_altered(orig):
    def span(f, t0, t1, y0, **kw):
        y = orig(f, t0, t1, y0, **kw)
        if abs(float(t0) - 0.01) < 1e-6:       # the stage at t = 10 ms
            y = y.clone()
            y[0, 0] = y[0, 0] + 1e-3
        return y
    return span


def _rk4_drift(orig):
    """A slow drift: every stage's x position off by 7e-5 of its largest
    magnitude, under ``step_err``'s limit, as a target orbit a little off
    would be."""
    def span(f, t0, t1, y0, **kw):
        y = orig(f, t0, t1, y0, **kw).clone()
        y[:, 0] = y[:, 0] + 7e-5 * y[:, 0].abs().max()
        return y
    return span


FAULTS = {
    "pos_att-solve": {
        "unchanged": ("ocdp_tpu_torch.ops.rowlane:RowLaneBatch.sweep",
                      _batch_unchanged),
        "half": ("ocdp_tpu_torch.ops.rowlane:RowLaneBatch.sweep", _batch_half),
        "altered": ("ocdp_tpu_torch.models.pos_att:"
                    "value_iteration_converged_batch", _converged_altered),
    },
    "attitude6d-solve": {
        "unchanged": ("ocdp_tpu_torch.ops.backup6d:Backup6D.__call__",
                      _b6_unchanged),
        "half": ("ocdp_tpu_torch.ops.backup6d:Backup6D.__call__", _b6_half),
        "altered": ("ocdp_tpu_torch.models.attitude:value_iteration_finite",
                    _finite_altered),
    },
    "pos_att-fleet": {
        "unchanged": ("ocdp_tpu_torch.utils.integrators:_rk4_span",
                      _rk4_unchanged),
        "half": ("ocdp_tpu_torch.utils.integrators:_rk4_span", _rk4_half),
        "altered": ("ocdp_tpu_torch.utils.integrators:_rk4_span",
                    _rk4_altered),
    },
}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    with patched(*FAULTS[cell][fault]):
        r = _run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    over, mix = SMALL[cell]
    c = harness.load_cell(cell, device="cpu", config_overrides=over,
                          mix_overrides=mix, bench=ALL)
    for seed in (1, 2, 3):
        nums = control.control_numbers(c, seed)
        assert control.fails(nums, c.mix["check"]["limits"]), nums


def test_a_slow_drift_is_not_correct():
    """A fault that stays under ``step_err``'s limit at every stage fails
    ``drift_err`` over a flight of 800 stages."""
    over, mix = SMALL["pos_att-fleet"]
    mix = harness.merged(mix, {"fixed": {"t_final": 4.0}})
    with patched("ocdp_tpu_torch.utils.integrators:_rk4_span", _rk4_drift):
        r = harness.run_cell("pos_att-fleet", 21, 0.2, False,
                             t0=time.perf_counter(), device="cpu",
                             config_overrides=over, mix_overrides=mix,
                             bench=ALL)
    checks = r["checks"]
    assert checks["step_err"]["value"] <= checks["step_err"]["limit"]
    assert checks["drift_err"]["value"] > checks["drift_err"]["limit"]
    assert not r["correct"]


def test_a_scattered_channel_is_held_to_its_actions_and_finite_values():
    """A channel whose float32 and float64 reference solves part at the
    median cell (pos-att's x_failure at the published horizon) has no
    sound cell; it still fails on an action outside its own or a value
    that is not finite."""
    g = torch.Generator().manual_seed(3)
    v64 = torch.rand(2, 6, 5, generator=g, dtype=torch.float64) + 1.0
    v32 = v64.clone()
    v32[1] = v32[1] * (1.0 + torch.rand(6, 5, generator=g,
                                        dtype=torch.float64))
    v32[1, 0, 0] = v64[1, 0, 0]                 # one cell agrees by chance
    v32[0, 0, 0] += 0.5                         # one cell x cannot fix
    sound = compare.sound_cells(v64, v32, 1e-3)
    assert not bool(sound[1].any())
    assert int((~sound[0]).sum()) == 1
    q = v64[:, :, None, :].expand(2, 6, 3, 5).clone()
    sol = type("Sol", (), {})()
    sol.values, sol.q, sol.q_min = v64, q, v64
    sol.argmin = torch.zeros(2, 6, 5, dtype=torch.long)
    vals, acts = v32.clone(), torch.zeros(2, 6, 5, dtype=torch.long)
    vals[0] = v64[0]
    ok = compare.solve_numbers(vals, acts, sol, [3, 2], sound=sound)
    assert ok == {"value_err": 0.0, "policy_gap": 0.0}
    bad = acts.clone()
    bad[1, 2, 3] = 2                            # an action channel 1 lacks
    assert compare.solve_numbers(vals, bad, sol, [3, 2],
                                 sound=sound)["policy_gap"] > 1.0
    nan = vals.clone()
    nan[1, 4, 4] = float("nan")
    assert compare.solve_numbers(nan, acts, sol, [3, 2],
                                 sound=sound)["value_err"] == 1.0
