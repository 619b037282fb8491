"""The batched engines and their sweep schedules on the CPU: the channel
batch of the row/lane backup (ops/rowlane.py::RowLaneBatch) through the
batched converged engine (engine.py::value_iteration_converged_batch), the
banded backup's factorized cost and channel batch (ops/band_backup2d.py),
and the finite engine's graph schedule (engine.py::_finite_graphed), whose
eager twin runs here with the schedule the CUDA graphs replay on a card.

* A batch sweep of the four pos-att channels (x_failure's 6 actions among
  9-action channels) equals each channel's own plain sweep bitwise.
* The batched converged engine equals ``value_iteration_converged`` of each
  channel alone bitwise (values, argmin, ``num_sweeps``, ``converged``,
  ``checks``) when the channels stop at different checks, and
  ``pos_att.solve`` at that configuration meets the JAX package's
  ``solve_channel(impl='pallas')`` (interpret mode): values rtol 2e-5 /
  atol 1e-5 (``JAX_RTOL``: 75-199 sweeps of rounding differences),
  argmin >= 99.9% equal, the same stop sweeps.
* The schedules: the converged engine's runs between checks and its tail;
  the finite engine's runs of ``GRAPH_SWEEPS`` and its remainder; the
  eager twin of the graph engine equals the allocating engine bitwise.
* B.6: the factorized cost equals the dense one bitwise and the JAX
  ``PallasBackup2D`` (interpret mode) within ``test_pallas_matches_gather``'s
  3e-6; the three simplified axes as one batch equal three per-axis solves
  bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu.models import attitude as jatt
from ocdp_tpu.models import pos_att as jpa
from ocdp_tpu.ops.pallas_backup import build_pallas_backup_2d
from ocdp_tpu_torch import engine as eng
from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.models import pos_att as tpa
from ocdp_tpu_torch.models import position as tpos
from ocdp_tpu_torch.ops import band_backup2d as bb
from ocdp_tpu_torch.ops import rowlane as rl
from ocdp_tpu_torch.ops.interp import PlanShape
from test_torch_attitude_simplified import jax_axis

torch.set_num_threads(2)

CHANNELS = [("x", False), ("y", False), ("z", False), ("x", True)]
SMALL = dict(n_mesh_x=7, n_mesh_v=7, n_mesh_t=6, n_mesh_w=5, T_final=0.25)
# 199 sweeps, a check every 25: with this tol ('abs') x stops at the third
# check, y at the fourth, z at the sixth, x_failure runs to the cap
STOPS = dict(SMALL, T_final=1.0, check_every=25, tol=4960.0)
STOP_SWEEPS = {"x": 75, "y": 100, "z": 150, "x_failure": 199}
# the port rounds every product and sum, XLA:CPU contracts the JAX kernel's
# into FMAs: 1.9e-7 of max |V| after one sweep (tests/test_torch_rowlane.py),
# measured 1.25e-5 relative after these 75-199 sweeps
JAX_RTOL = 2e-5


def _backups(size):
    cfg = tpa.PosAttConfig(**size)
    out = []
    for ch, failure in CHANNELS:
        p = tpa.build_channel(cfg, ch, failure=failure, with_cost=False,
                              device="cpu")
        out.append((p, tpa.build_channel_rowlane_backup(cfg, p)))
    return cfg, out


def test_batch_sweep_equals_each_channel_alone():
    _, pairs = _backups(SMALL)
    bks = [bk for _, bk in pairs]
    assert [bk.args.n_actions for bk in bks] == [9, 9, 9, 6]
    batch = rl.RowLaneBatch(bks)
    rng = np.random.default_rng(21)
    init = [torch.from_numpy(rng.uniform(0.0, 5.0, p.plan.grid_shape)
                             .astype(np.float32)) for p, _ in pairs]
    cur, nxt, arg = batch.buffers(init)
    batch.sweep(cur, nxt, arg, (0, 1, 2, 3))
    for c, (bk, v) in enumerate(zip(bks, init)):
        want = bk(v)
        assert torch.equal(batch.to_natural(c, nxt[c]), want.values)
        assert torch.equal(batch.to_natural(c, arg[c]), want.argmin)
    # a sweep over a subset leaves the other channels' outputs alone
    before = nxt[1].clone()
    batch.sweep(nxt, cur, arg, (0, 3))
    assert torch.equal(nxt[1], before)
    assert torch.equal(batch.to_natural(3, cur[3]),
                       bks[3](bks[3].to_natural(nxt[3])).values)


def test_batch_refuses_mixed_shapes_and_too_many_channels():
    _, pairs = _backups(SMALL)
    cfg2 = tpa.PosAttConfig(**dict(SMALL, n_mesh_x=9))
    p2 = tpa.build_channel(cfg2, "x", with_cost=False, device="cpu")
    with pytest.raises(ValueError, match="different shapes"):
        rl.RowLaneBatch([pairs[0][1],
                         tpa.build_channel_rowlane_backup(cfg2, p2)])
    with pytest.raises(ValueError, match="a batch takes"):
        rl.RowLaneBatch([bk for _, bk in pairs] + [pairs[0][1]])


def test_converged_batch_equals_each_channel_alone():
    cfg, pairs = _backups(STOPS)
    sweeps = cfg.n_stage - 1
    got = eng.value_iteration_converged_batch(
        rl.RowLaneBatch([bk for _, bk in pairs]), sweeps,
        check_every=cfg.check_every, tol=cfg.tol)
    for (ch, failure), (p, bk), res in zip(CHANNELS, pairs, got):
        want = eng.value_iteration_converged(
            p.plan, None, sweeps, check_every=cfg.check_every, tol=cfg.tol,
            backup=bk)
        name = ch + ("_failure" if failure else "")
        assert res.num_sweeps == want.num_sweeps == STOP_SWEEPS[name]
        assert res.converged == want.converged == (name != "x_failure")
        assert torch.equal(res.values, want.values)
        assert torch.equal(res.argmin, want.argmin)
        assert torch.equal(res.checks, want.checks)


def test_pos_att_solve_matches_jax_with_staggered_stops():
    tsol = tpa.solve(tpa.PosAttConfig(**STOPS), device="cpu")
    for ch, failure in CHANNELS:
        name = ch + ("_failure" if failure else "")
        jctrl, jres = jpa.solve_channel(jpa.PosAttConfig(**STOPS), ch,
                                        failure=failure, impl="pallas")
        tctrl = tsol.controllers[name]
        np.testing.assert_allclose(tctrl.values.numpy(), jctrl.values,
                                   rtol=JAX_RTOL, atol=1e-5)
        assert (tctrl.argmin.numpy() == np.asarray(jctrl.argmin)).mean() \
            >= 0.999
        assert tsol.results[name].num_sweeps == int(jres.num_sweeps) \
            == STOP_SWEEPS[name]
        assert tsol.results[name].converged == bool(jres.converged)


@pytest.mark.parametrize("max_sweeps,check_every,want", [
    (1999, 50, [(50, 1950 - 50 * i, True) for i in range(39)]
     + [(49, 1, False)]),
    (199, 25, [(25, 175 - 25 * i, True) for i in range(7)]
     + [(24, 1, False)]),
    (120, 50, [(21, 100, True), (50, 50, True), (49, 1, False)]),
    (50, 50, [(1, 50, True), (49, 1, False)]),
    (30, 50, [(30, 1, False)]),
    (0, 50, []),
])
def test_converged_schedule(max_sweeps, check_every, want):
    runs = eng.converged_schedule(max_sweeps, check_every)
    assert runs == want
    assert sum(n for n, _, _ in runs) == max_sweeps
    # each check falls where the one-channel engine checks: k_s % every == 0
    assert all((k % check_every == 0) == check for _, k, check in runs)


@pytest.mark.parametrize("n,k,want", [(5999, 100, [100] * 59 + [99]),
                                      (300, 100, [100] * 3),
                                      (50, 100, [50]), (0, 100, [])])
def test_finite_schedule(n, k, want):
    assert eng.finite_schedule(n, k) == want


def test_ping_pong_ends_in_the_first_buffer():
    for n in range(5):
        cur, nxt = torch.zeros(3), torch.zeros(3)

        def step(src, dst):
            dst.copy_(src + 1)

        eng.ping_pong(step, cur, nxt, n)
        assert torch.equal(cur, torch.full((3,), float(n)))


def test_graph_schedule_eager_twin_equals_the_allocating_engine(monkeypatch):
    """The finite engine's graph path on the CPU runs the graphs' schedule
    eagerly (runs of GRAPH_SWEEPS through ping-pong buffers, then the
    remainder): shrunk to runs of 4 sweeps, 11 sweeps of position's batch
    equal the allocating loop's bitwise."""
    monkeypatch.setattr(eng, "GRAPH_SWEEPS", 4)
    p = tpos.build(tpos.PositionConfig(n_mesh_x=24, n_mesh_v=24),
                   device="cpu")
    bk = bb.BandBackup2D(p.plan, p.cost_terms)
    assert bk.graph_safe
    seen = []
    real = bk.sweep_into

    def counted(v, ov, oa):
        seen.append(1)
        real(v, ov, oa)

    bk.sweep_into = counted
    assert eng.finite_schedule(11, eng.GRAPH_SWEEPS) == [4, 4, 3]
    got = eng.value_iteration_finite(p.plan, None, 11, backup=bk)
    assert len(seen) == 11
    want = eng.value_iteration_finite(p.plan, None, 11, backup=bk.plain)
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.argmin, want.argmin)
    assert got.num_sweeps == 11 and not got.converged


def _axis_problem(n1, n2, axis, edge):
    cfg = tatt.AttitudeConfig(n_mesh_w=n1, n_mesh_t=n2)
    return tatt.build_simplified_axis(cfg, axis, edge=edge, device="cpu")


@pytest.mark.parametrize("edge", ["extrapolate", "clamp"])
def test_factorized_cost_equals_dense_and_jax_pallas(edge):
    grid, plan, terms = _axis_problem(17, 40, 1, edge)
    rng = np.random.default_rng(22)
    v = rng.normal(size=grid.shape).astype(np.float32)
    split = bb.BandBackup2D(plan, terms)
    dense = bb.BandBackup2D(plan, (terms[0] + terms[1]) + terms[2])
    assert len(split.args.terms) == 3 and len(dense.args.terms) == 1
    got = split(torch.from_numpy(v))
    want = dense(torch.from_numpy(v))
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.argmin, want.argmin)
    jplan, jcost = jax_axis(jatt.AttitudeConfig(n_mesh_w=17, n_mesh_t=40), 1,
                            edge)
    jres = build_pallas_backup_2d(jplan, jcost)(jnp.asarray(v))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(jres.values),
                               rtol=3e-6, atol=3e-6)
    np.testing.assert_array_equal(got.argmin.numpy(),
                                  np.asarray(jres.argmin))


def test_terms_past_the_kernel_cap_fold_in_order():
    grid, plan, terms = _axis_problem(17, 40, 0, "clamp")
    extra = [terms[0], terms[1], 0.5 * terms[0], terms[2], 0.25 * terms[1]]
    bk = bb.BandBackup2D(plan, extra)
    assert len(bk.args.terms) == bb.MAX_TERMS
    want = torch.zeros(plan.query_shape)
    for t in extra:
        want = want + t
    assert torch.equal(bk.args.dense_cost()[0], want.permute(2, 0, 1))


def test_stack_equals_each_axis_alone():
    cfg = tatt.AttitudeConfig(n_mesh_w=31, n_mesh_t=20)
    built = [tatt.build_simplified_axis(cfg, i, device="cpu")
             for i in range(3)]
    bk = bb.BandBackup2D.stack([p for _, p, _ in built],
                               [t for _, _, t in built])
    assert bk.args.shape == (3, 31, 20, 3) and not bk.args.shared_plan
    assert len(bk.channel_taps) == 3
    with pytest.raises(ValueError, match="channel_taps"):
        bk.taps
    v = torch.from_numpy(np.random.default_rng(23).uniform(
        0.0, 50.0, (3, 31, 20)).astype(np.float32))
    got = bk(v)
    for i, (_, plan, terms) in enumerate(built):
        one = bb.BandBackup2D(plan, terms)(v[i])
        assert torch.equal(got.values[i], one.values)
        assert torch.equal(got.argmin[i], one.argmin)
    with pytest.raises(ValueError, match="one grid shape"):
        bb.BandBackup2D.stack(
            [built[0][1], _axis_problem(30, 20, 0, "clamp")[1]],
            [built[0][2], built[0][2]])


@pytest.mark.parametrize("edge", ["clamp", "extrapolate"])
def test_batched_solve_simplified_equals_per_axis_solves(edge):
    cfg = tatt.AttitudeConfig(n_mesh_w=31, n_mesh_t=20)
    sol = tatt.solve_simplified(cfg, num_sweeps=12, edge=edge, device="cpu")
    u_vec = torch.as_tensor(cfg.u_vector)
    for i in range(3):
        _, plan, terms = tatt.build_simplified_axis(cfg, i, edge=edge,
                                                    device="cpu")
        res = eng.value_iteration_finite(plan, None, 12,
                                         backup=bb.BandBackup2D(plan, terms))
        assert torch.equal(sol.values[i], res.values)
        assert torch.equal(sol.u_tables[i], u_vec[res.argmin.long()])
    # the batch through the finite engine's graph schedule (eager here)
    built = [tatt.build_simplified_axis(cfg, i, edge=edge, device="cpu")
             for i in range(3)]
    bk = bb.BandBackup2D.stack([p for _, p, _ in built],
                               [t for _, _, t in built])
    shape = PlanShape((3, 31, 20), (3, 31, 20, 3), torch.device("cpu"))
    res = eng.value_iteration_finite(shape, None, 12, backup=bk)
    assert torch.equal(res.values, torch.stack(sol.values))


def test_position_cost_terms_sum_to_the_stage_cost():
    p = tpos.build(tpos.PositionConfig(n_mesh_x=16, n_mesh_v=16),
                   device="cpu")
    assert len(p.cost_terms) == 3
    assert torch.equal((p.cost_terms[0] + p.cost_terms[1])
                       + p.cost_terms[2], p.stage_cost)
    split = bb.BandBackup2D(p.plan, p.cost_terms)
    dense = bb.BandBackup2D(p.plan, p.stage_cost)
    v = torch.from_numpy(np.random.default_rng(24).uniform(
        0.0, 50.0, p.plan.grid_shape).astype(np.float32))
    a, b = split(v), dense(v)
    assert torch.equal(a.values, b.values) and torch.equal(a.argmin,
                                                           b.argmin)
