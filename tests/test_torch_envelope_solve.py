"""Port 6-D envelope solves (ocdp_tpu_torch/engine.py's carry mode,
models/attitude.py's auto rules, flat solutions and the flat rollout,
convert.py, io.py), on the CPU.

* Carry mode (two ``(NW, NE)`` tables ping-ponged, one narrow argmin
  buffer) equals the allocating path bitwise, in the finite engine and in
  the segmented engine, killed at a checkpoint and resumed; a flat plan's
  results and checkpoints hold the flat table and the 1-D axes, which the
  JAX package's ``io.load_values`` reads; ``probe_window`` and a policy
  store are refused there, as in the JAX package.
* ``solve_full`` forced flat with carry equals the non-flat solve bitwise;
  its segmented form killed and resumed equals the one-shot solve.
* A flat solution flies a 300-stage rollout bitwise equal to the non-flat
  one's (tests/test_attitude.py:162-187), ``'interp'`` raises on it; its
  ``u_tables`` is host numpy equal to the non-flat decode.
* ``convert.full_solution_from_numpy`` takes a JAX flat result ((NW, NE)
  values, uint8 argmin) and the port flies it as the JAX package does.
* The auto rules pick flat/carry/uint8, recompute and the chunked build by
  cell count (thresholds lowered so that small grids cross them).
* The rejections.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu import engine as jeng
from ocdp_tpu import io as jio
from ocdp_tpu.models import attitude as jatt
from ocdp_tpu_torch import convert
from ocdp_tpu_torch import io as tio
from ocdp_tpu_torch.engine import (value_iteration_finite,
                                   value_iteration_segmented)
from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.ops import backup6d as b6
from ocdp_tpu_torch.ops.interp import PlanShape

torch.set_num_threads(2)

SMALL = dict(n_mesh_w=5, n_mesh_q=4)
X0 = np.asarray([0.3, -0.2, 0.25, 0.05, 0.08, -0.06, 0.99], np.float32)


class Killed(Exception):
    pass


def _build(lane_mode="plan", **kw):
    kw = dict(flat=True, **kw) if lane_mode == "plan" else \
        dict(lane_mode=lane_mode, **kw)
    return tatt.build_full(tatt.AttitudeConfig(**SMALL), device="cpu", **kw)


@pytest.mark.parametrize("lane_mode", ["plan", "recompute"])
def test_carry_finite_equals_allocating(lane_mode):
    grid, plan, cost = _build(lane_mode)
    carry = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8,
                        carry_padded=True)
    alloc = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8)
    shape = PlanShape.of(plan)
    v0 = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 10, (carry.NW, carry.NE)).astype(np.float32))
    before = v0.clone()
    rc = value_iteration_finite(shape, None, 6, backup=carry, init_values=v0)
    ra = value_iteration_finite(shape, None, 6, backup=alloc,
                                init_values=v0.reshape(grid.shape))
    assert torch.equal(v0, before)           # the caller's table untouched
    assert rc.values.shape == (carry.NW, carry.NE) == rc.argmin.shape
    assert rc.argmin.dtype == torch.int32 == ra.argmin.dtype
    assert torch.equal(rc.values, ra.values.reshape(rc.values.shape))
    assert torch.equal(rc.argmin, ra.argmin.reshape(rc.argmin.shape))
    narrow = value_iteration_finite(shape, None, 6, backup=carry,
                                    init_values=v0, narrow_argmin_result=True)
    assert narrow.argmin.dtype == torch.uint8
    assert torch.equal(narrow.argmin.int(), rc.argmin)


def test_carry_on_a_broadcast_plan_keeps_the_state_shape():
    grid, plan, cost = tatt.build_full(tatt.AttitudeConfig(**SMALL),
                                       device="cpu")
    carry = b6.Backup6D(plan, cost, carry_padded=True)
    rc = value_iteration_finite(plan, cost, 3, backup=carry)
    ra = value_iteration_finite(plan, cost, 3, backup=b6.Backup6D(plan, cost))
    assert rc.values.shape == grid.shape
    assert torch.equal(rc.values, ra.values)
    assert torch.equal(rc.argmin, ra.argmin)


def test_carry_refusals():
    _, plan, cost = _build()
    carry = b6.Backup6D(plan, cost, carry_padded=True)
    with pytest.raises(ValueError, match="probe_window"):
        value_iteration_finite(PlanShape.of(plan), None, 2, backup=carry,
                               probe_window=((0, 1),) * 6)
    with pytest.raises(ValueError, match="store_policies"):
        value_iteration_segmented(PlanShape.of(plan), None, 4,
                                  segment_size=2, backup=carry,
                                  store_policies=True)
    alloc = b6.Backup6D(plan, cost)
    v = torch.zeros((alloc.NW, alloc.NE))
    with pytest.raises(ValueError, match="carry_padded"):
        alloc.sweep_into(v, torch.empty_like(v),
                         torch.empty(v.shape, dtype=torch.int32))


def test_segmented_carry_kill_and_resume(tmp_path):
    grid, plan, cost = _build("recompute")
    carry = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8,
                        carry_padded=True)
    shape = PlanShape.of(plan)
    ref = value_iteration_finite(shape, None, 9, backup=carry,
                                 narrow_argmin_result=True)
    seg = value_iteration_segmented(shape, None, 9, segment_size=4,
                                    backup=carry, narrow_argmin_result=True)
    assert torch.equal(seg.values, ref.values)
    assert torch.equal(seg.argmin, ref.argmin)
    assert seg.argmin.dtype == torch.uint8
    wide = value_iteration_segmented(shape, None, 9, segment_size=4,
                                     backup=carry)
    assert wide.argmin.dtype == torch.int32
    assert torch.equal(wide.argmin, ref.argmin.int())

    ckpt = str(tmp_path / "flat.npz")

    def kill(k, _v):
        if k >= 4:
            raise Killed

    with pytest.raises(Killed):
        value_iteration_segmented(shape, None, 9, segment_size=4,
                                  backup=carry, checkpoint_path=ckpt,
                                  checkpoint_axes=grid.axes, on_segment=kill)
    ck = tio.load_values(ckpt)
    assert ck.sweep_index == 4 and ck.values.shape == (carry.NW, carry.NE)
    assert [a.shape for a in ck.axes] == [(5,)] * 3 + [(4,)] * 3
    jv, js, _ = jio.load_values(ckpt)           # the JAX package reads it
    assert js == 4 and np.array_equal(np.asarray(jv), ck.values.numpy())
    got = value_iteration_segmented(shape, None, 9, segment_size=4,
                                    backup=carry, init_values=ck.values,
                                    start_sweep=ck.sweep_index,
                                    narrow_argmin_result=True)
    assert got.num_sweeps == 5
    assert torch.equal(got.values, ref.values)
    assert torch.equal(got.argmin, ref.argmin)


@pytest.mark.parametrize("flat", [True, False])
def test_segmented_carry_allocates_its_tables_once(flat):
    """Every segment of a carry-mode segmented solve sweeps between the
    same two tables: no table is copied or allocated per segment. A
    broadcast plan's segments still see the state grid's shape."""
    grid, plan, cost = tatt.build_full(tatt.AttitudeConfig(**SMALL),
                                       device="cpu", flat=flat)
    carry = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8,
                        carry_padded=True)
    shape = PlanShape.of(plan)
    tables = []
    seg = value_iteration_segmented(
        shape, None, 7, segment_size=2, backup=carry,
        on_segment=lambda k, v: tables.append((v.data_ptr(), v.shape)),
        narrow_argmin_result=True)
    want = (carry.NW, carry.NE) if flat else grid.shape
    assert len(tables) == 4 and {s for _, s in tables} == {want}
    assert len({p for p, _ in tables}) == 2
    assert seg.values.data_ptr() == tables[-1][0]
    ref = value_iteration_finite(shape, None, 7, backup=carry,
                                 narrow_argmin_result=True)
    assert torch.equal(seg.values, ref.values)
    assert torch.equal(seg.argmin, ref.argmin)


@pytest.fixture(scope="module")
def solutions():
    """50 sweeps at 5^3 x 4^3, non-flat and forced flat with carry."""
    cfg = tatt.AttitudeConfig(**SMALL)
    nf = tatt.solve_full(cfg, num_sweeps=50, device="cpu")
    fl = tatt.solve_full(cfg, num_sweeps=50, device="cpu", flat=True,
                         carry_padded=True)
    return nf, fl


def test_forced_flat_solve_equals_non_flat(solutions):
    nf, fl = solutions
    assert not nf.is_flat and fl.is_flat
    assert fl.result.values.shape == (125, 64)
    np.testing.assert_array_equal(fl.values_6d(), nf.values_6d())
    np.testing.assert_array_equal(fl.argmin_6d(), nf.argmin_6d())
    assert fl.values_6d().shape == fl.argmin_6d().shape == nf.grid.shape
    u = fl.u_tables
    assert isinstance(u, np.ndarray) and u.shape == (3,) + nf.grid.shape
    np.testing.assert_array_equal(u, nf.u_tables.numpy())


def test_flat_rollout_equals_non_flat(solutions):
    nf, fl = solutions
    Xn, Un, An = tatt.rollout_full(nf, X0, num_stages=300)
    Xf, Uf, Af = tatt.rollout_full(fl, X0, num_stages=300)
    assert torch.equal(Uf, Un) and torch.equal(Xf, Xn)
    assert torch.equal(Af, An)
    with pytest.raises(ValueError, match="nearest"):
        tatt.rollout_full(fl, X0, method="interp", num_stages=10)


def test_solve_full_flat_segmented_kill_and_resume(tmp_path):
    cfg = tatt.AttitudeConfig(**SMALL)
    ref = tatt.solve_full(cfg, num_sweeps=8, device="cpu", flat=True,
                          carry_padded=True)
    ckpt = str(tmp_path / "att6.npz")
    tatt.solve_full(cfg, num_sweeps=5, device="cpu", flat=True,
                    carry_padded=True, segment_size=3, checkpoint_path=ckpt)
    ck = tio.load_values(ckpt)
    assert ck.sweep_index == 5 and ck.values.shape == (125, 64)
    got = tatt.solve_full(cfg, num_sweeps=8, device="cpu", flat=True,
                          carry_padded=True, segment_size=3,
                          init_values=ck.values, start_sweep=ck.sweep_index)
    assert got.is_flat and got.result.argmin.dtype == torch.int32
    np.testing.assert_array_equal(got.values_6d(), ref.values_6d())
    np.testing.assert_array_equal(got.argmin_6d(), ref.argmin_6d())


def test_convert_flies_a_jax_flat_result():
    """A JAX envelope-layout result ((NW, NE) values, uint8 argmin) carried
    over keeps its layout, and the port flies its policy as JAX does."""
    cfg = jatt.AttitudeConfig(**SMALL)
    grid, _, _ = jatt.build_full(cfg)
    rng = np.random.default_rng(5)
    values = rng.uniform(0, 50, (125, 64)).astype(np.float32)
    argmin = rng.integers(0, 27, (125, 64)).astype(np.uint8)
    jsol = jatt.FullSolution(cfg, grid, jeng.SolveResult(
        jnp.asarray(values), jnp.asarray(argmin), None,
        jnp.asarray(7, jnp.int32), jnp.asarray(False)))
    assert jsol.is_flat
    sol = convert.full_solution_from_numpy(jsol, device="cpu")
    assert sol.is_flat and sol.result.argmin.dtype == torch.uint8
    assert sol.result.num_sweeps == 7
    np.testing.assert_array_equal(sol.result.values.numpy(), values)
    np.testing.assert_array_equal(sol.argmin_6d(), jsol.argmin_6d())
    np.testing.assert_array_equal(sol.u_tables, jsol.u_tables)
    back = convert.to_numpy(sol.result)
    np.testing.assert_array_equal(back.argmin, argmin)
    jX, jU, _ = jatt.rollout_full(jsol, jnp.asarray(X0), num_stages=100)
    X, U, _ = tatt.rollout_full(sol, X0, num_stages=100)
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-5)


def test_auto_rules_by_cell_count(monkeypatch):
    """4^3 x 3^3 = 1728 cells and 5^3 x 4^3 = 8000 cells against lowered
    thresholds: flat, chunked and recompute as the cell count crosses
    each."""
    monkeypatch.setattr(tatt, "FLAT_MIN_CELLS", 1000)
    monkeypatch.setattr(tatt, "CHUNKED_MIN_CELLS", 1500)
    monkeypatch.setattr(tatt, "RECOMPUTE_MIN_CELLS", 5000)
    chunked = []
    real = tatt._plan_and_cost_flat_chunked

    def spy(*a, **kw):
        chunked.append(True)
        return real(*a, **kw)

    monkeypatch.setattr(tatt, "_plan_and_cost_flat_chunked", spy)
    tiny = tatt.AttitudeConfig(n_mesh_w=4, n_mesh_q=3)
    _, plan, _ = tatt.build_full(tiny, device="cpu")
    assert tatt.plan_is_flat(plan) and not isinstance(plan, b6.RecomputePlan)
    assert chunked == [True]
    _, plan, _ = tatt.build_full(tiny, device="cpu", chunked=False)
    assert tatt.plan_is_flat(plan) and chunked == [True]
    _, plan, _ = tatt.build_full(tiny, device="cpu", flat=False)
    assert not tatt.plan_is_flat(plan)
    _, plan, _ = tatt.build_full(tatt.AttitudeConfig(**SMALL), device="cpu")
    assert isinstance(plan, b6.RecomputePlan)
    sol = tatt.solve_full(tiny, num_sweeps=2, device="cpu")
    assert sol.is_flat and sol.result.argmin.dtype == torch.int32
    seg = tatt.solve_full(tiny, num_sweeps=2, device="cpu", segment_size=1)
    assert seg.is_flat and seg.result.argmin.dtype == torch.uint8
    monkeypatch.setattr(tatt, "FLAT_MIN_CELLS", 8_000_000)
    assert not tatt.solve_full(tiny, num_sweeps=1, device="cpu").is_flat


def test_rejections():
    cfg = tatt.AttitudeConfig(**SMALL)
    with pytest.raises(ValueError, match="lane_mode"):
        tatt.build_full(cfg, device="cpu", lane_mode="stored")
    with pytest.raises(ValueError, match="flat plan"):
        tatt.build_full(cfg, device="cpu", lane_mode="recompute", flat=False)
    with pytest.raises(ValueError, match="flat layout"):
        tatt.build_full(cfg, device="cpu", flat=False, chunked=True)
    with pytest.raises(ValueError, match="edge"):
        tatt.build_full(cfg, device="cpu", flat=True, chunked=True,
                        edge="wrap")
    with pytest.raises(ValueError, match="6-D backup"):
        tatt.solve_full(cfg, num_sweeps=1, device="cpu", flat=True,
                        impl="gather")
    _, plan, cost = _build()
    with pytest.raises(ValueError, match="argmin_dtype"):
        b6.Backup6D(plan, cost, argmin_dtype=torch.int16)
    rbk = b6.Backup6D(*_build("recompute")[1:], argmin_dtype=torch.uint8)
    lanes = rbk.args.lanes._replace(axis_sizes=(4, 4, 5))
    with pytest.raises(ValueError, match="lane axes"):
        b6.backup6d_cuda(torch.zeros((rbk.NW, rbk.NE)),
                         rbk.args._replace(lanes=lanes))
    shape = PlanShape.of(plan)
    assert shape.grid_shape == plan.grid_shape and shape.ndim == 6
    assert shape.query_shape == (125, 64, 27) and shape.device == plan.device
