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
* the 6-D kernel (B.3, ``ops/backup6d.py``): ``Backup6D`` and its tile
  planner against ``build_pallas_backup_6d`` over ``AttitudeConfig(
  n_mesh_w, n_mesh_q=4, h)``: both take 27 combos and refuse together past
  (-1, 0, 1) taps an axis.

The kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
