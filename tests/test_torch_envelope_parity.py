"""The port's kernels take the configurations the JAX package's take.

Every configuration a JAX kernel (or, for Kirk, the JAX ``solve``) takes,
the port's kernel host takes too, and where the JAX build refuses, the
port refuses with it. Checked on the CPU with each host's own analysis:

* Kirk (B.1, ``ops/fused_backup2d.py``): the JAX shear kernel's build
  (``PallasShearBackup``) takes each configuration here, and so does the
  port's affine kernel: the configurations that once needed more than
  232,448 B of shared memory now plan a stage that fits (``du=14500`` and
  ``du=20000``: the action records in chunks; ``dx=300, B=(2.0,
  0.0539)``: the table read from global memory; the JAX stencil, the CPU's
  ``auto``, refuses that one: 599 taps), the default keeps its stage and
  launch shape (24,096 B, 16 cells x 32 splits); the plain version and the
  solve against the JAX package's gather sweep and solve on the CPU,
  |dV| <= 2e-6 * max(|V|, 1) (XLA:CPU contracts and fuses, so the last bit
  may differ), argmins equal except where the two actions' totals tie
  within that tolerance (20,000 controls put many near ties side by
  side);
* pos-att (B.2, ``ops/rowlane.py``): ``RowLaneBackup`` and the tile
  planner against ``PermutedRowLaneBackup``'s ``max_flat_taps=40`` over
  ``n_mesh_w`` in {30, 60, 100, 120, 200} at small x/v/t sizes, each
  channel; at ``n_mesh_w=120`` (35 row combos) the port's plain solve
  against JAX's gather solve within rtol 2e-5 (the pos-att parity tests'
  tolerance: the two sum the interpolation in different orders) after 20 sweeps, argmins
  equal except where the two actions' totals tie within that tolerance;
* B.2 on a simplified attitude axis (its rowlane route, ``row_axes=1``):
  ``RowLaneBackup`` and its tile planner against
  ``build_pallas_backup_6d(..., row_axes=1)`` over ``n_mesh_t`` in {300,
  600, 1000, 1500}, ``(n_mesh_w=300, h=0.02)`` and ``h=0.01`` (47-53 row
  combos: both refuse): equal row and lane combos, lane axes of 5-21
  taps; at ``AttitudeConfig(n_mesh_w=200, n_mesh_t=1000)`` (7 x 9-15
  combos) the port's plain rowlane solve against JAX's gather solve after
  20 sweeps, within rtol 2e-5, argmins equal except where the two
  actions' totals tie within that tolerance;
* the 6-D kernel (B.3, ``ops/backup6d.py``): ``Backup6D`` and its tile
  planner against ``build_pallas_backup_6d`` over ``AttitudeConfig(
  n_mesh_w, n_mesh_q=4, h)``: both take 27 combos and refuse together
  past 40; a lighter roll axis or an asymmetric rate range gives row taps
  (-1, 0, 1, 2) x (-1, 0, 1) x (-1, 0, 1) (36 and 31 combos, both take
  them, the port through ``backup6d_wide``) or 45 combos (both refuse);
  at 36 combos the port's plain solve against JAX's gather solve after 3
  sweeps, within rtol 2e-5, argmins as above.

The kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu.models import attitude as jatt
from ocdp_tpu.models import kirk as jkirk
from ocdp_tpu.models import pos_att as jpa
from ocdp_tpu.ops.backup import bellman_backup as jax_bellman_backup
from ocdp_tpu.ops.interp import InterpPlan as JaxPlan
from ocdp_tpu.ops.pallas_backup6 import build_pallas_backup_6d
from ocdp_tpu.ops.pallas_shear import build_pallas_shear_backup
from ocdp_tpu_torch.engine import value_iteration_finite
from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.models import kirk
from ocdp_tpu_torch.models import pos_att as tpa
from ocdp_tpu_torch.ops import backup6d as b6
from ocdp_tpu_torch.ops import fused_backup2d as fb
from ocdp_tpu_torch.ops import rowlane as rl
from ocdp_tpu_torch.ops.interp import PlanShape, interp_apply

torch.set_num_threads(2)

SMEM_BLOCK_MAX = 232_448          # 227 KB: the most an H100 block may ask
C1_CHUNKED = kirk.KirkConfig(du=20000, dx=20, N=3)


def _jax_close(got, want_v, want_a, totals=None):
    """The port's float32 result against the JAX package's on the CPU:
    values within 2e-6 * max(|V|, 1); argmins equal, or, given the sweep's
    ``totals`` ``(..., actions)``, equal where the two actions' totals do
    not tie within that tolerance."""
    want_v = np.asarray(want_v)
    tol = 2e-6 * max(float(np.abs(want_v).max()), 1.0)
    dv = np.abs(got.values.numpy().astype(np.float64) - want_v)
    assert dv.max() <= tol
    ta, ja = got.argmin.numpy(), np.asarray(want_a)
    if totals is None:
        np.testing.assert_array_equal(ta, ja)
        return
    at = np.take_along_axis(totals, ta[..., None].astype(np.int64), -1)
    aj = np.take_along_axis(totals, ja[..., None].astype(np.int64), -1)
    assert np.abs(at - aj).max() <= tol


def _kirk_totals(cfg, values):
    """One Kirk sweep's totals of every action from ``values``, through the
    port's gather pieces: ``(dx, dx, du)``."""
    p = kirk.build(cfg, device="cpu")
    return (interp_apply(values, p.plan) + p.stage_cost).numpy()


# --- Kirk, B.1 -----------------------------------------------------------------

@pytest.mark.parametrize("name,cfg,stage", [
    ("default", kirk.KirkConfig(), fb.STAGE_ALL),
    ("du14000", kirk.KirkConfig(du=14000), fb.STAGE_ALL),
    ("du14500", kirk.KirkConfig(du=14500), fb.STAGE_CHUNKS),
    ("du20000", kirk.KirkConfig(du=20000), fb.STAGE_CHUNKS),
    ("dx242", kirk.KirkConfig(dx=242), fb.STAGE_ALL),
    ("dx300_wide_B", kirk.KirkConfig(dx=300, B=(2.0, 0.0539)),
     fb.TABLE_GLOBAL),
])
def test_kirk_configurations_plan_within_shared_memory(name, cfg, stage):
    args = kirk.affine_backup(cfg, "cpu").args
    assert args.stage == stage
    assert args.smem_bytes <= SMEM_BLOCK_MAX
    assert (args.cells_per_block, args.n_splits) == (16, 32)
    if stage != fb.STAGE_ALL:
        assert args.chunk == 32
    if name == "default":
        # the default keeps its stage and launch shape
        assert args.smem_bytes == 24_096 and args.row0.numel() == 625
    if stage == fb.TABLE_GLOBAL:
        assert args.max_rows == cfg.dx      # every row: no stage would fit


@pytest.mark.parametrize("cfg", [
    kirk.KirkConfig(du=14500, dx=16, N=2),
    kirk.KirkConfig(du=20000, dx=20, N=2),
    kirk.KirkConfig(dx=300, du=10, B=(2.0, 0.0539), N=2),
], ids=["du14500", "du20000", "dx300_wide_B"])
def test_kirk_envelope_matches_jax_solve(cfg):
    """Where the JAX shear kernel's build takes a configuration, the
    port's affine kernel plans its stage, and its plain version gives the
    JAX gather solve's one sweep."""
    jcfg = jkirk.KirkConfig(**dataclasses.asdict(cfg))
    jp = jkirk.build(jcfg)
    jkirk._build_shear_walkdown(
        build_pallas_shear_backup, jp, cfg.du, start=50,
        cost_terms=jkirk._separable_cost_terms(jcfg))
    args = kirk.affine_backup(cfg, "cpu").args
    assert args.smem_bytes <= SMEM_BLOCK_MAX
    jsol = jkirk.solve(jcfg, impl="gather")
    got = fb.fused_backup2d_affine_plain(torch.zeros(cfg.dx, cfg.dx), args)
    _jax_close(got, jsol.result.values, jsol.result.argmin)


def test_chunked_plain_equals_jax_sweep():
    """A configuration the kernel runs with its records in chunks: the
    affine plain version against the JAX package's gather sweep of its own
    ``build`` plan, on a seeded table."""
    args = kirk.affine_backup(C1_CHUNKED, "cpu").args
    assert args.stage == fb.STAGE_CHUNKS
    v = np.random.default_rng(21).uniform(
        0.0, 400.0, (C1_CHUNKED.dx,) * 2).astype(np.float32)
    jp = jkirk.build(jkirk.KirkConfig(**dataclasses.asdict(C1_CHUNKED)))
    want = jax_bellman_backup(jnp.asarray(v), jp.plan, jp.stage_cost)
    _jax_close(fb.fused_backup2d_affine_plain(torch.from_numpy(v), args),
               want.values, want.argmin,
               _kirk_totals(C1_CHUNKED, torch.from_numpy(v)))


def test_chunked_solve_equals_jax_solve():
    """``KirkConfig(du=20000, dx=20, N=3)`` solved on the CPU: the port's
    gather solve against the JAX ``solve`` (the stencil there), the sum of
    V 704.0369 as measured when the configuration was first probed; the
    affine plain version through the engine equals the gather solve
    bitwise, policies included."""
    jsol = jkirk.solve(jkirk.KirkConfig(**dataclasses.asdict(C1_CHUNKED)))
    tsol = kirk.solve(C1_CHUNKED, device="cpu")
    first = kirk.solve(dataclasses.replace(C1_CHUNKED, N=2), device="cpu")
    _jax_close(tsol.result, jsol.result.values, jsol.result.argmin,
               _kirk_totals(C1_CHUNKED, first.result.values))
    assert abs(float(tsol.result.values.double().sum()) - 704.0369) < 5e-4
    shape = PlanShape((C1_CHUNKED.dx,) * 2,
                      (C1_CHUNKED.dx,) * 2 + (C1_CHUNKED.du,),
                      torch.device("cpu"))
    aff = value_iteration_finite(shape, None, C1_CHUNKED.N - 1,
                                 store_policies=True,
                                 backup=kirk.affine_backup(C1_CHUNKED, "cpu"))
    assert torch.equal(aff.values, tsol.result.values)
    assert torch.equal(aff.policies.long(), tsol.result.policies.long())


# --- pos-att, B.2 --------------------------------------------------------------

POS_ATT_SMALL = dict(n_mesh_x=6, n_mesh_v=6, n_mesh_t=10)
CHANNELS = [("x", False), ("y", False), ("z", False), ("x", True)]


def _port_rowlane(kw, channel, failure):
    """The port's kernel host on one channel: its analysis and its tile
    plan; ``(row combos, kind)``."""
    cfg = tpa.PosAttConfig(**kw)
    bk = tpa.build_channel_rowlane_backup(cfg, tpa.build_channel(
        cfg, channel, failure=failure, with_cost=False, device="cpu"))
    plan = rl.plan_tiles([rl._plan_key(bk.args)], SMEM_BLOCK_MAX)
    return bk.row_combos, plan.kind


@pytest.mark.parametrize("channel,failure", CHANNELS,
                         ids=[c + ("_failure" if f else "")
                              for c, f in CHANNELS])
@pytest.mark.parametrize("n_mesh_w", [30, 60, 100, 120, 200])
def test_pos_att_envelope_matches_jax(n_mesh_w, channel, failure):
    kw = dict(POS_ATT_SMALL, n_mesh_w=n_mesh_w)
    jcfg = jpa.PosAttConfig(**kw)
    try:
        jbk = jpa.build_channel_rowlane_backup(
            jcfg, jpa.build_channel(jcfg, channel, failure=failure)).bk
    except ValueError as err:
        assert "max_flat_taps" in str(err)
        with pytest.raises(ValueError, match="impl='gather'"):
            _port_rowlane(kw, channel, failure)
        return
    combos, kind = _port_rowlane(kw, channel, failure)
    assert combos == tuple(jbk.row_combos)
    assert len(combos) <= rl.KIND_COMBOS[kind]


def test_wide_omega_solve_matches_jax_gather():
    """35 row combos (kind 3 on a card): the port's plain rowlane solve of
    the x channel against JAX's gather solve, 20 sweeps. Values within
    rtol 2e-5; where the argmins differ, the port's totals of the two
    actions (one sweep of the 19-sweep table through the port's gather
    backup) tie within that tolerance."""
    kw = dict(POS_ATT_SMALL, n_mesh_w=120)
    _, jres = jpa.solve_channel(jpa.PosAttConfig(**kw), "x", impl="gather",
                                max_sweeps=20)
    cfg = tpa.PosAttConfig(**kw)
    _, tres = tpa.solve_channel(cfg, "x", device="cpu", max_sweeps=20)
    np.testing.assert_allclose(tres.values.numpy(), np.asarray(jres.values),
                               rtol=2e-5)
    ja, ta = np.asarray(jres.argmin), tres.argmin.numpy()
    differ = ja != ta
    assert differ.mean() <= 1e-3
    if differ.any():
        _, prev = tpa.solve_channel(cfg, "x", device="cpu", max_sweeps=19)
        p = tpa.build_channel(cfg, "x", device="cpu")
        tot = (interp_apply(prev.values, p.plan) + p.stage_cost).numpy()
        at = np.take_along_axis(tot, ta[..., None], -1)[..., 0]
        aj = np.take_along_axis(tot, ja[..., None], -1)[..., 0]
        np.testing.assert_allclose(aj[differ], at[differ], rtol=2e-5)


# --- the 6-D kernel, B.3 ------------------------------------------------------

@pytest.mark.parametrize("h", [0.005, 0.01, 0.02, 0.05])
@pytest.mark.parametrize("n_mesh_w", [11, 21, 31, 41])
def test_attitude_6d_envelope_matches_jax(n_mesh_w, h):
    _, plan, cost = tatt.build_full(
        tatt.AttitudeConfig(n_mesh_w=n_mesh_w, n_mesh_q=4, h=h),
        device="cpu")
    jplan = JaxPlan(tuple(jnp.asarray(x.numpy()) for x in plan.lo),
                    tuple(jnp.asarray(x.numpy()) for x in plan.frac),
                    plan.grid_shape)
    try:
        jbk = build_pallas_backup_6d(
            jplan, [jnp.asarray(t.numpy()) for t in cost], interpret=True)
    except ValueError as err:
        assert "max_flat_taps" in str(err)
        with pytest.raises(ValueError, match="taps"):
            b6.Backup6D(plan, cost)
        return
    bk = b6.Backup6D(plan, cost)
    assert (bk.row_combos, bk.lane_combos) == (jbk.row_combos,
                                               jbk.lane_combos)
    assert len(bk.row_combos) == 27
    b6.plan_tiles(bk.args, bk.NW, SMEM_BLOCK_MAX)
    jax.clear_caches()


WIDE_6D = dict(n_mesh_w=15, h=0.02, w_min_deg=-50.0, w_max_deg=30.0,
               inertia_diag=(0.0225, 0.028317, 0.0245))


def _jax_plan(plan):
    return JaxPlan(tuple(jnp.asarray(x.numpy()) for x in plan.lo),
                   tuple(jnp.asarray(x.numpy()) for x in plan.frac),
                   plan.grid_shape)


@pytest.mark.parametrize("kw,combos", [
    (WIDE_6D, 36),
    (dict(n_mesh_w=11, h=0.025, w_min_deg=-35.0, w_max_deg=50.0,
          inertia_diag=(0.019, 0.028317, 0.0245)), 31),
    (dict(WIDE_6D, inertia_diag=(0.02, 0.028317, 0.0245)), 45),
], ids=["36", "31", "45-refused"])
def test_attitude_6d_wide_taps_match_jax(kw, combos):
    """Row taps past 3 an axis: the TPU kernel's build and ``Backup6D``
    take the same plans, with the same combos and action digits, and
    refuse past 40 live combos together; the port runs such a plan on
    ``backup6d_wide``, whose stage fits."""
    _, plan, cost = tatt.build_full(tatt.AttitudeConfig(**kw, n_mesh_q=4),
                                    device="cpu")
    try:
        jbk = build_pallas_backup_6d(
            _jax_plan(plan), [jnp.asarray(t.numpy()) for t in cost],
            interpret=True)
    except ValueError as err:
        assert "max_flat_taps" in str(err) and combos > 40
        with pytest.raises(ValueError, match="impl='gather'"):
            b6.Backup6D(plan, cost)
        return
    bk = b6.Backup6D(plan, cost)
    assert len(bk.row_combos) == combos
    assert (bk.row_combos, bk.lane_combos) == (jbk.row_combos,
                                               jbk.lane_combos)
    assert [len(t) for t in bk.w_taps] == [4, 3, 3]
    assert bk.action_digits == jbk.action_digits == 3
    tiles = b6.plan_tiles(bk.args, bk.NW, SMEM_BLOCK_MAX)
    assert tiles.wide and tiles.smem_bytes <= SMEM_BLOCK_MAX
    jax.clear_caches()


def _tie_close(got_v, got_a, want_v, want_a, totals):
    """Values within rtol 2e-5 of JAX's; where the argmins differ, the two
    actions' totals (``totals``, the port's last sweep of every action)
    tie within that tolerance."""
    np.testing.assert_allclose(got_v, want_v, rtol=2e-5)
    differ = got_a != want_a
    if differ.any():
        at = np.take_along_axis(totals, got_a[..., None], -1)[..., 0]
        aj = np.take_along_axis(totals, want_a[..., None], -1)[..., 0]
        np.testing.assert_allclose(aj[differ], at[differ], rtol=2e-5)


def test_attitude_6d_wide_solve_matches_jax_gather():
    """36 row combos (backup6d_wide on a card): the port's plain 6-D solve
    against the JAX package's gather solve, 3 sweeps."""
    cfg = dict(WIDE_6D, n_mesh_q=4)
    jsol = jatt.solve_full(jatt.AttitudeConfig(**cfg), num_sweeps=3,
                           impl="gather")
    tsol = tatt.solve_full(tatt.AttitudeConfig(**cfg), num_sweeps=3,
                           device="cpu")
    prev = tatt.solve_full(tatt.AttitudeConfig(**cfg), num_sweeps=2,
                           device="cpu")
    _, plan, cost = tatt.build_full(tatt.AttitudeConfig(**cfg), device="cpu")
    totals = (interp_apply(prev.result.values, plan)
              + cost[0] + cost[1] + cost[2]).numpy()
    _tie_close(tsol.result.values.numpy(), tsol.result.argmin.numpy(),
               np.asarray(jsol.result.values),
               np.asarray(jsol.result.argmin), totals)
    jax.clear_caches()


SIMPLIFIED = {
    "t300": dict(n_mesh_t=300), "t600": dict(n_mesh_t=600),
    "t1000": dict(n_mesh_t=1000), "t1500": dict(n_mesh_t=1500),
    "w300-h002": dict(n_mesh_w=300, h=0.02),
    "h001-refused": dict(h=0.01),
}


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("name", list(SIMPLIFIED))
def test_simplified_rowlane_envelope_matches_jax(name, axis):
    """A simplified attitude axis on its rowlane route: the TPU kernel's
    build at ``row_axes=1`` and ``RowLaneBackup`` accept together, with the
    same live row and lane combos (the port's unit axis in front of each
    group), and refuse together past 40 (the port's error names
    ``impl='gather'``); an accepted plan's tiles fit."""
    cfg = tatt.AttitudeConfig(**SIMPLIFIED[name])
    _, plan, terms = tatt.build_simplified_axis(cfg, axis, device="cpu")
    try:
        jbk = build_pallas_backup_6d(
            _jax_plan(plan), [jnp.asarray(t.numpy()) for t in terms],
            row_axes=1, interpret=True)
    except ValueError as err:
        assert "max_flat_taps" in str(err) and name.endswith("refused")
        with pytest.raises(ValueError, match="impl='gather'"):
            rl.RowLaneBackup(plan, terms, perm=(0, 1), row_axes=1)
        return
    assert not name.endswith("refused")
    bk = rl.RowLaneBackup(plan, terms, perm=(0, 1), row_axes=1)
    assert [c[1:] for c in bk.row_combos] == list(jbk.row_combos)
    assert [c[1:] for c in bk.lane_combos] == list(jbk.lane_combos)
    assert all(c[0] == 0 for c in bk.row_combos + bk.lane_combos)
    assert len(bk.lane_combos) <= rl.MAX_LANE_COMBOS
    tiles = rl.plan_tiles([rl._plan_key(bk.args)], SMEM_BLOCK_MAX)
    assert len(bk.row_combos) <= rl.KIND_COMBOS[tiles.kind]
    assert tiles.smem_bytes <= SMEM_BLOCK_MAX // rl.BLOCKS_PER_SM


def test_simplified_wide_lane_solve_matches_jax_gather():
    """``AttitudeConfig(n_mesh_w=200, n_mesh_t=1000)`` (7 row combos, lane
    axes of 11, 15 and 9 taps): the port's plain rowlane solve against the
    JAX package's gather solve, 20 sweeps, each axis."""
    kw = dict(n_mesh_w=200, n_mesh_t=1000)
    jsol = jatt.solve_simplified(jatt.AttitudeConfig(**kw), num_sweeps=20,
                                 impl="gather")
    cfg = tatt.AttitudeConfig(**kw)
    tsol = tatt.solve_simplified(cfg, num_sweeps=20, impl="rowlane",
                                 device="cpu")
    prev = tatt.solve_simplified(cfg, num_sweeps=19, impl="rowlane",
                                 device="cpu")
    for axis in range(3):
        _, plan, terms = tatt.build_simplified_axis(cfg, axis, device="cpu")
        totals = (interp_apply(prev.values[axis], plan)
                  + terms[0] + terms[1] + terms[2]).numpy()
        got_a = torch.bucketize(tsol.u_tables[axis],
                                torch.tensor([-0.05, 0.05])).numpy()
        want_a = np.searchsorted([-0.05, 0.05],
                                 np.asarray(jsol.u_tables[axis]))
        _tie_close(tsol.values[axis].numpy(), got_a,
                   np.asarray(jsol.values[axis]), want_a, totals)
    jax.clear_caches()
