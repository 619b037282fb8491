"""Port row/lane backup (ocdp_tpu_torch/ops/rowlane.py) vs the JAX package's
``PermutedRowLaneBackup`` (run in interpret mode, as the JAX tests run it on
the CPU) and the float64 oracle.

* The pos-att channel plans are bitwise equal to the JAX package's, and the
  tap analysis and cost split are equal to its ``PermutedRowLaneBackup``'s.
* One sweep of ``rowlane_backup_plain`` against the JAX kernel: values to
  rtol 1e-6 (measured: at most 1.9e-7 of max |V| on the four small
  channels; XLA:CPU contracts products into FMAs where PyTorch rounds every
  op), argmin at least 99.9% equal (measured: 100%).
* Against the float64 oracle on the JAX fuzz suite's separable random
  problems: |dV| <= 2e-6 * max(|V|, 1), argmin > 99% equal, its own bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from ocdp_tpu.models import pos_att as jpa
from ocdp_tpu.ops.pallas_backup6 import PermutedRowLaneBackup
from ocdp_tpu_torch import convert
from ocdp_tpu_torch.models import pos_att as tpa
from ocdp_tpu_torch.ops import rowlane as rl
from ocdp_tpu_torch.ops.interp import InterpPlan
from test_fuzz_rowlane_4d import _random_4d_problem

torch.set_num_threads(2)

CHANNELS = [("x", False), ("y", False), ("z", False), ("x", True)]
SMALL = dict(n_mesh_x=7, n_mesh_v=7, n_mesh_t=6, n_mesh_w=5, T_final=0.25)
MID = dict(n_mesh_x=12, n_mesh_v=12, n_mesh_t=8, n_mesh_w=7, T_final=0.25)


def _pair(size, channel, failure):
    jc, tc = jpa.PosAttConfig(**size), tpa.PosAttConfig(**size)
    jp = jpa.build_channel(jc, channel, failure=failure)
    tp = tpa.build_channel(tc, channel, failure=failure, device="cpu")
    return jc, jp, tc, tp


@pytest.mark.parametrize("size", [SMALL, MID], ids=["7x7x6x5", "12x12x8x7"])
@pytest.mark.parametrize("channel,failure", CHANNELS)
def test_channel_plan_and_cost_bitwise(size, channel, failure):
    _, jp, _, tp = _pair(size, channel, failure)
    np.testing.assert_array_equal(tp.forces, jp.forces)
    for k in range(4):
        np.testing.assert_array_equal(tp.plan.lo[k].numpy(),
                                      np.asarray(jp.plan.lo[k]))
        np.testing.assert_array_equal(tp.plan.frac[k].numpy(),
                                      np.asarray(jp.plan.frac[k]))
    np.testing.assert_array_equal(tp.stage_cost.numpy(),
                                  np.asarray(jp.stage_cost))


@pytest.mark.parametrize("size", [SMALL, MID], ids=["7x7x6x5", "12x12x8x7"])
@pytest.mark.parametrize("channel,failure", CHANNELS)
def test_taps_and_cost_split_equal_jax(size, channel, failure):
    jc, jp, tc, tp = _pair(size, channel, failure)
    jb = jpa.build_channel_rowlane_backup(jc, jp, analyze_only=True).bk
    tb = tpa.build_channel_rowlane_backup(tc, tp)
    assert tb.w_taps == jb.w_taps
    assert tb.row_combos == jb.row_combos
    assert tb.e_taps == jb.e_taps
    full = jpa.build_channel_rowlane_backup(jc, jp).bk
    np.testing.assert_array_equal(tb.c_row,
                                  np.asarray(full.c_row_j)[:full.NW, 0])
    np.testing.assert_array_equal(tb.c_lane,
                                  np.asarray(full.c_lane_j)[0, :full.NE])
    assert tuple(float(x) for x in tb.c_act) == full.c_act
    assert tb.args.c_rowact is None and tb.args.c_rowlane is None


@pytest.mark.parametrize("channel,failure", CHANNELS)
def test_one_sweep_matches_jax_kernel(channel, failure):
    jc, jp, tc, tp = _pair(SMALL, channel, failure)
    rng = np.random.default_rng(11)
    v = rng.uniform(0.0, 5.0, tp.plan.grid_shape).astype(np.float32)
    want = jpa.build_channel_rowlane_backup(jc, jp)(jnp.asarray(v))
    got = tpa.build_channel_rowlane_backup(tc, tp)(torch.from_numpy(v))
    wv = np.asarray(want.values)
    np.testing.assert_allclose(got.values.numpy(), wv, rtol=0,
                               atol=1e-6 * np.abs(wv).max())
    assert (got.argmin.numpy() == np.asarray(want.argmin)).mean() >= 0.999
    assert got.argmin.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_separable_problem_vs_float64_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    grid, plan, terms, nexts, cost64 = _random_4d_problem(rng, False)
    v = rng.uniform(0.0, 5.0, plan.grid_shape).astype(np.float32)
    ref_v, ref_a = oracle.bellman_backup(
        np.asarray(v, np.float64), [np.asarray(a, np.float64)
                                    for a in grid.axes], nexts, cost64)
    scale = max(1.0, float(np.abs(ref_v).max()))
    tplan = convert.plan_from_numpy(
        [np.asarray(x) for x in plan.lo], [np.asarray(x) for x in plan.frac],
        plan.grid_shape, device="cpu")
    bk = rl.RowLaneBackup(tplan, [np.asarray(t) for t in terms],
                          perm=(1, 3, 0, 2), row_axes=2)
    out = bk(torch.from_numpy(v))
    np.testing.assert_allclose(out.values.numpy(), ref_v, atol=2e-6 * scale)
    assert (out.argmin.numpy() == ref_a).mean() > 0.99
    # the JAX kernel on the same problem builds the same tap structure
    jb = PermutedRowLaneBackup(plan, terms, perm=(1, 3, 0, 2), row_axes=2)
    assert (bk.w_taps, bk.row_combos, bk.e_taps) == \
        (jb.bk.w_taps, jb.bk.row_combos, jb.bk.e_taps)


def test_coupled_lanes_raise():
    rng = np.random.default_rng(1000)
    _, plan, terms, _, _ = _random_4d_problem(rng, True)
    tplan = convert.plan_from_numpy(
        [np.asarray(x) for x in plan.lo], [np.asarray(x) for x in plan.frac],
        plan.grid_shape, device="cpu")
    with pytest.raises(ValueError, match="lanes couple"):
        rl.RowLaneBackup(tplan, [np.asarray(t) for t in terms],
                         perm=(1, 3, 0, 2), row_axes=2)


def test_non_separable_plans_raise():
    cfg = tpa.PosAttConfig(**SMALL)
    p = tpa.build_channel(cfg, "x", device="cpu")
    lo, frac = list(p.plan.lo), list(p.plan.frac)
    # the v row axis made to vary along the x lane axis
    bad = InterpPlan(tuple([lo[0], lo[1].expand(7, 7, 1, 1, 9)] + lo[2:]),
                     tuple(frac), p.plan.grid_shape)
    with pytest.raises(ValueError, match="row axis 0 query varies along"):
        rl.RowLaneBackup(bad, [p.stage_cost], perm=(1, 3, 0, 2), row_axes=2)
    # the x lane axis made to vary with the action
    bad = InterpPlan(tuple([lo[0].expand(7, 7, 1, 1, 9)] + lo[1:]),
                     tuple(frac), p.plan.grid_shape)
    with pytest.raises(ValueError, match="varies with the action"):
        rl.RowLaneBackup(bad, [p.stage_cost], perm=(1, 3, 0, 2), row_axes=2)
    # a dense cost couples lanes and actions
    with pytest.raises(ValueError, match="couples the lane and action"):
        rl.RowLaneBackup(p.plan, [p.stage_cost], perm=(1, 3, 0, 2),
                         row_axes=2)


def test_cuda_wrapper_refuses_cpu_tensors():
    cfg = tpa.PosAttConfig(**SMALL)
    p = tpa.build_channel(cfg, "y", with_cost=False, device="cpu")
    bk = tpa.build_channel_rowlane_backup(cfg, p)
    before = rl.rowlane_backup_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        rl.rowlane_backup_cuda(torch.zeros((bk.NW, bk.NE)), bk.args)
    assert rl.rowlane_backup_cuda.launches == before


def test_exact_ties_take_the_first_action():
    cfg = tpa.PosAttConfig(**SMALL)
    p = tpa.build_channel(cfg, "x", with_cost=False, device="cpu")

    def twice(a):
        return torch.cat([a, a], dim=-1) if a.shape[-1] > 1 else a

    plan = InterpPlan(tuple(twice(a) for a in p.plan.lo),
                      tuple(twice(a) for a in p.plan.frac), p.plan.grid_shape)
    bk = tpa.build_channel_rowlane_backup(
        cfg, p._replace(plan=plan, forces=np.concatenate([p.forces,
                                                          p.forces])))
    v = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 5, p.plan.grid_shape).astype(np.float32))
    once = tpa.build_channel_rowlane_backup(cfg, p)(v)
    res = bk(v)
    assert int(res.argmin.max()) < 9
    assert torch.equal(res.values, once.values)
    assert torch.equal(res.argmin, once.argmin)
