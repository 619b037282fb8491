"""The CUDA kernels (fused 2-D backup in its plan-streamed and affine-query
modes, the affine one in CUDA graphs and the finite engine and in each of
its three stages: every action record staged, the records staged in
chunks, the table read from global memory; row/lane backup with its
channel batch, tile map, CUDA graph replay, 40-combo kind and lane axes of
up to 21 taps, 6-D coupled-lane
backup with its envelope modes: flat plans, uint8 argmin, min-only sweeps,
carry mode, lane recompute; its row-block and digit-slice modes (B.7), the
edges of its shared-memory tiles and a grid past 2**31 cells, each mode
also through its kernel for more than 3 taps an axis (``backup6d_wide``,
36 row combos); the cube body for the full (-1, 0, 1) tap cube on a
stored lane plan (``backup6d_sweep_cube``: the reference shape, exact ties,
row-action and row-lane costs, a uint8 argmin, its tile edges) and with the
lanes recomputed (``backup6d_sweep_recompute_cube``: uint8 and int32 argmin,
exact ties, ``edge='clamp'``, its tile edges, and against B.4 on a lane
plan filled from the plain recompute); the
row-sharded engines over an in-process mesh; the banded 2-D backup with its
channel batch, factorized cost and CUDA graph replay) vs their plain
PyTorch versions, on a card; the surface's step through B.1
(``graft_entry.entry``) and its trace (``profiling.trace``); and the
segmented envelope solve's checkpoints, staged in a pinned buffer.

Each kernel and its plain version round every multiply and add separately
and take the first minimum, so on one device they must agree bitwise:
values and argmin. Every test
here needs a CUDA device and skips without one. This file imports no jax,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from ocdp_tpu_torch.models import attitude, kirk, pos_att, position
from ocdp_tpu_torch.ops import backup6d as b6
from ocdp_tpu_torch.ops import band_backup2d as bb
from ocdp_tpu_torch.ops import fused_backup2d as fb
from ocdp_tpu_torch.ops import rowlane as rl
from ocdp_tpu_torch.ops.interp import InterpPlan, PlanShape, build_plan
from ocdp_tpu_torch.profiling import cuda_time_ms

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bitwise(a, b):
    assert torch.equal(a.values, b.values)
    assert torch.equal(a.argmin, b.argmin)


def _kernel_vs_plain(bk, v):
    args = (v, bk.lo0, bk.lo1, bk.f0, bk.f1, bk.cost, bk.state_cost,
            bk.action_cost)
    before = fb.fused_backup2d_cuda.launches
    got = bk(v)
    torch.cuda.synchronize()
    assert fb.fused_backup2d_cuda.launches == before + 1
    _bitwise(got, fb.fused_backup2d_plain(*args))


@pytest.mark.parametrize("cfg", [kirk.KirkConfig.golden(),
                                 kirk.KirkConfig(N=3)],
                         ids=["golden", "full"])
@pytest.mark.parametrize("separable", [True, False])
def test_one_sweep_bitwise(device, cfg, separable):
    p = kirk.build(cfg, device=device)
    terms = kirk._separable_cost_terms(cfg, device=device) if separable \
        else None
    bk = fb.FusedBackup2D(p.plan, p.stage_cost, cost_terms=terms)
    rng = np.random.default_rng(cfg.dx)
    v = torch.from_numpy(rng.uniform(0, 400, (cfg.dx, cfg.dx))
                         .astype(np.float32)).to(device)
    _kernel_vs_plain(bk, v)


def test_exact_ties_take_the_first_action(device):
    axis = np.linspace(-1.0, 1.0, 6).astype(np.float32)
    rng = np.random.default_rng(6)
    base = rng.uniform(-1.2, 1.2, (2, 6, 6, 40)).astype(np.float32)
    q = np.concatenate([base, base], axis=-1)      # actions 40..79 = 0..39
    plan = build_plan((axis, axis),
                      tuple(torch.from_numpy(x).to(device) for x in q))
    bk = fb.FusedBackup2D(plan, torch.zeros((6, 6, 80), device=device))
    zero = torch.zeros((6, 6), device=device)
    assert torch.equal(bk(zero).argmin, torch.zeros_like(zero, dtype=torch.int32))
    _kernel_vs_plain(bk, torch.rand((6, 6), device=device))


def test_solve_kernel_equals_gather(device):
    """impl='kernel' is B.1's affine mode, one launch a sweep; the
    plan-streamed mode through the same engine, one launch a sweep too;
    both equal the gather solve."""
    from ocdp_tpu_torch.engine import value_iteration_finite

    cfg = kirk.KirkConfig(N=20, dx=40, du=300)
    before = (fb.fused_backup2d_affine_cuda.launches,
              fb.fused_backup2d_cuda.launches)
    sk = kirk.solve(cfg, device=device, impl="kernel").result
    assert fb.fused_backup2d_affine_cuda.launches == before[0] + cfg.N - 1
    assert fb.fused_backup2d_cuda.launches == before[1]
    p = kirk.build(cfg, device=device)
    ss = value_iteration_finite(
        p.plan, p.stage_cost, cfg.N - 1, store_policies=True,
        backup=fb.FusedBackup2D(
            p.plan, p.stage_cost,
            cost_terms=kirk._separable_cost_terms(cfg, device=device)))
    assert fb.fused_backup2d_cuda.launches == before[1] + cfg.N - 1
    sg = kirk.solve(cfg, device=device, impl="gather").result
    for r in (sk, ss):
        assert torch.equal(r.values, sg.values)
        assert torch.equal(r.policies, sg.policies)
    assert sk.policies.dtype == torch.int16


AFFINE_CONFIGS = {
    "golden": kirk.KirkConfig.golden(),
    "full": kirk.KirkConfig(N=3),
    "negative_B": kirk.KirkConfig(N=3, B=(-0.0013, -0.0539)),
    "zero_B": kirk.KirkConfig(N=3, dx=60, du=500, B=(0.0, 0.0539),
                              A=((-0.9974, 0.0539), (0.1078, -1.1591))),
}


def _affine_vs(aff, v, streamed=None):
    """The affine kernel, one launch, == its plain version and the
    plan-streamed kernel (on ``streamed``'s plan, on the affine mode's own
    when None, not at all when False: it stages the whole table, at most
    241 x 241), bitwise, the argmin also as int16 (and uint8 where it
    fits)."""
    args = aff.args
    before = fb.fused_backup2d_affine_cuda.launches
    got = aff(v)
    torch.cuda.synchronize()
    assert fb.fused_backup2d_affine_cuda.launches == before + 1
    want = fb.fused_backup2d_affine_plain(v, args)
    _bitwise(got, want)
    if streamed is False:
        pass
    elif streamed is None:
        _bitwise(got, fb.fused_backup2d_cuda(
            v, *fb.affine_plan(args, v.device),
            state_cost=args.state_cost, action_cost=args.action_cost))
    else:
        _bitwise(got, streamed(v))
    for dt in [torch.int16] + ([torch.uint8] if args.n_actions <= 256
                               else []):
        ov, oa = torch.empty_like(v), torch.empty(v.shape, dtype=dt,
                                                  device=v.device)
        aff.sweep_into(v, ov, oa)
        assert torch.equal(ov, want.values)
        assert torch.equal(oa.to(torch.int32), want.argmin)
    return got


@pytest.mark.parametrize("name", list(AFFINE_CONFIGS))
def test_affine_sweep_bitwise(device, name):
    cfg = AFFINE_CONFIGS[name]
    p = kirk.build(cfg, device=device)
    streamed = fb.FusedBackup2D(
        p.plan, p.stage_cost,
        cost_terms=kirk._separable_cost_terms(cfg, device=device))
    v = torch.from_numpy(np.random.default_rng(cfg.dx).uniform(
        0, 400, (cfg.dx, cfg.dx)).astype(np.float32)).to(device)
    _affine_vs(kirk.affine_backup(cfg, device), v, streamed)


def _whole_table(args):
    """Affine arguments whose blocks each stage the whole table."""
    import dataclasses

    n0 = args.grid_shape[0]
    return dataclasses.replace(args, row0=torch.zeros_like(args.row0),
                               n_rows=torch.full_like(args.n_rows, n0),
                               max_rows=n0, _launch=None)


@pytest.mark.parametrize("shape", [(16, 32), (8, 32), (1, 8), (33, 15)])
def test_affine_launch_shapes_bitwise(device, shape, monkeypatch):
    cfg = AFFINE_CONFIGS["negative_B"]
    s_r, u = kirk._meshes(cfg)
    s_c, a_c = kirk._separable_cost_terms(cfg, device=device)
    monkeypatch.setattr(fb, "CELLS_PER_BLOCK", shape[0])
    monkeypatch.setattr(fb, "SPLITS", shape[1])
    aff = fb.AffineBackup2D((s_r, s_r), u, cfg.A, cfg.B, s_c, a_c)
    v = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 400, (cfg.dx, cfg.dx)).astype(np.float32)).to(device)
    _affine_vs(aff, v)
    whole = fb.fused_backup2d_affine_cuda(v, _whole_table(aff.args))
    _bitwise(whole, fb.fused_backup2d_affine_plain(v, aff.args))


def test_affine_shapes_configured_in_any_order(device):
    """The shared memory limit is the kernel's, not a backup's: arguments
    that need more (the whole table staged) configured first, a backup
    that needs less next, the first still launches."""
    cfg = AFFINE_CONFIGS["full"]
    small = kirk.affine_backup(cfg, device)
    big = _whole_table(small.args)
    assert big.smem_bytes > small.args.smem_bytes
    fb._affine_launch(big)
    small.prepare()
    v = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 400, (cfg.dx, cfg.dx)).astype(np.float32)).to(device)
    _bitwise(fb.fused_backup2d_affine_cuda(v, big), small(v))


def test_affine_exact_ties_on_unsorted_controls(device):
    """The golden controls forwards then backwards: every query repeats, so
    every minimum ties and the first copy wins; the walk turns back."""
    cfg = kirk.KirkConfig.golden()
    s_r, u = kirk._meshes(cfg)
    s_c, a_c = kirk._separable_cost_terms(cfg, device=device)
    aff = fb.AffineBackup2D(
        (s_r, s_r), np.concatenate([u, u[::-1]]), cfg.A, cfg.B, s_c,
        torch.cat([a_c, a_c.flip(0)]))
    v = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 400, (cfg.dx, cfg.dx)).astype(np.float32)).to(device)
    assert int(_affine_vs(aff, v).argmin.max()) < cfg.du


STAGES = {"all": fb.STAGE_ALL, "chunks": fb.STAGE_CHUNKS,
          "global": fb.TABLE_GLOBAL}


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("name", ["golden", "negative_B", "zero_B"])
def test_affine_stages_bitwise(device, name, stage, monkeypatch):
    """Each stage's instantiation, forced by a shared memory limit of
    exactly its need, with 4 splits and chunks of 3 actions (the last
    chunk of a split ragged): == the plain version and the streamed kernel
    bitwise."""
    cfg = AFFINE_CONFIGS[name]
    s_r, u = kirk._meshes(cfg)
    s_c, a_c = kirk._separable_cost_terms(cfg, device=device)
    with monkeypatch.context() as m:
        m.setattr(fb, "SPLITS", 4)
        m.setattr(fb, "CHUNK_ACTIONS", 3)
        a = fb.AffineBackup2D((s_r, s_r), u, cfg.A, cfg.B, s_c, a_c).args
        m.setattr(fb, "SMEM_LIMIT_BYTES", fb._smem_bytes(
            a.grid_shape, a.n_actions, a.max_rows, a.cells_per_block,
            a.n_splits, STAGES[stage], 3))
        aff = fb.AffineBackup2D((s_r, s_r), u, cfg.A, cfg.B, s_c, a_c)
    assert aff.args.stage == STAGES[stage]
    v = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 400, (cfg.dx, cfg.dx)).astype(np.float32)).to(device)
    _affine_vs(aff, v)


C1_CONFIGS = {
    "du20000": (kirk.KirkConfig(du=20000, N=4), fb.STAGE_CHUNKS),
    "dx300_wide_B": (kirk.KirkConfig(dx=300, B=(2.0, 0.0539), N=4),
                     fb.TABLE_GLOBAL),
}


@pytest.mark.parametrize("name", list(C1_CONFIGS))
def test_affine_c1_configurations_bitwise(device, name):
    """The configurations that once needed more shared memory than a block
    has: one sweep == the plain version (and the streamed kernel where it
    takes the table) bitwise."""
    cfg, stage = C1_CONFIGS[name]
    aff = kirk.affine_backup(cfg, device)
    assert aff.args.stage == stage
    v = torch.from_numpy(np.random.default_rng(10).uniform(
        0, 400, (cfg.dx, cfg.dx)).astype(np.float32)).to(device)
    _affine_vs(aff, v, None if cfg.dx <= 241 else False)


@pytest.mark.parametrize("name", list(C1_CONFIGS))
def test_kirk_solve_auto_runs_b1_at_every_configuration(device, name):
    """kirk.solve's auto is B.1 on a card at these configurations too: N-1
    launches and no other backup kernel, values and policies equal to the
    plain version through the same engine."""
    from ocdp_tpu_torch.engine import value_iteration_finite

    cfg, _ = C1_CONFIGS[name]
    before = (fb.fused_backup2d_affine_cuda.launches,
              fb.fused_backup2d_cuda.launches)
    sol = kirk.solve(cfg, device=device).result
    torch.cuda.synchronize()
    assert fb.fused_backup2d_affine_cuda.launches == before[0] + cfg.N - 1
    assert fb.fused_backup2d_cuda.launches == before[1]
    args = kirk.affine_backup(cfg, device).args
    shape = PlanShape((cfg.dx,) * 2, (cfg.dx,) * 2 + (cfg.du,), device)
    want = value_iteration_finite(
        shape, None, cfg.N - 1, store_policies=True,
        backup=lambda v: fb.fused_backup2d_affine_plain(v, args))
    assert torch.equal(sol.values, want.values)
    assert torch.equal(sol.policies.long(), want.policies.long())


def test_affine_graph_replay_equals_eager(device):
    """A CUDA graph of 10 affine sweeps (ping-pong buffers) equals the same
    sweeps launched eagerly, and its replay counts its 10 launches."""
    from ocdp_tpu_torch.engine import SweepGraph, ping_pong

    cfg = AFFINE_CONFIGS["negative_B"]
    aff = kirk.affine_backup(cfg, device)
    aff.prepare()
    v0 = torch.from_numpy(np.random.default_rng(7).uniform(
        0, 400, (cfg.dx, cfg.dx)).astype(np.float32)).to(device)
    out = []
    for graphed in (True, False):
        cur, nxt = v0.clone(), torch.empty_like(v0)
        arg = torch.empty(v0.shape, dtype=torch.int32, device=device)

        def step(src, dst):
            aff.sweep_into(src, dst, arg)

        if graphed:
            g = SweepGraph(step, cur, nxt, 10, (aff.launcher,))
            before = fb.fused_backup2d_affine_cuda.launches
            g.replay()
            assert fb.fused_backup2d_affine_cuda.launches == before + 10
        else:
            ping_pong(step, cur, nxt, 10)
        torch.cuda.synchronize()
        out.append((cur, arg))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_affine_finite_engine_replays_its_graphs(device):
    """Without stored policies the finite engine runs the affine sweeps as
    one CUDA graph of 100 and 31 eager launches, in each of two solves with
    one backup; both equal the gather solve bitwise."""
    from ocdp_tpu_torch import engine

    cfg = kirk.KirkConfig(N=132, dx=50, du=200)
    aff = kirk.affine_backup(cfg, device)
    shape = PlanShape((cfg.dx,) * 2, (cfg.dx,) * 2 + (cfg.du,), device)
    want = kirk.solve(cfg, device=device, impl="gather",
                      store_policies=False).result
    results = []
    for _ in range(2):
        before = fb.fused_backup2d_affine_cuda.launches
        results.append(engine.value_iteration_finite(shape, None, cfg.N - 1,
                                                     backup=aff))
        assert fb.fused_backup2d_affine_cuda.launches == before + cfg.N - 1
    for r in results:
        assert torch.equal(r.values, want.values)
        assert torch.equal(r.argmin, want.argmin)
    assert results[0].values.data_ptr() != results[1].values.data_ptr()


def test_affine_wrapper_refuses_on_the_card(device):
    cfg = kirk.KirkConfig.golden()
    aff = kirk.affine_backup(cfg, device)
    cpu_args = kirk.affine_backup(cfg, "cpu").args
    v = torch.zeros((cfg.dx, cfg.dx), device=device)
    before = fb.fused_backup2d_affine_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        fb.fused_backup2d_affine_cuda(v, cpu_args)
    with pytest.raises(ValueError, match="out_a"):
        fb.fused_backup2d_affine_cuda(
            v, aff.args, torch.empty_like(v),
            torch.empty(v.shape, dtype=torch.int64, device=device))
    with pytest.raises(ValueError, match="input table"):
        fb.fused_backup2d_affine_cuda(
            v, aff.args, v,
            torch.empty(v.shape, dtype=torch.int32, device=device))
    with pytest.raises(ValueError, match="values"):
        fb.fused_backup2d_affine_cuda(torch.zeros((34, 35), device=device),
                                      aff.args)
    assert fb.fused_backup2d_affine_cuda.launches == before


def test_wrapper_refuses_mixed_devices(device):
    p = kirk.build(kirk.KirkConfig.golden(), device="cpu")
    bk = fb.FusedBackup2D(p.plan, p.stage_cost)
    with pytest.raises(ValueError, match="CUDA device"):
        bk(torch.zeros((35, 35), device=device))


def test_cuda_time_ms(device):
    ms = cuda_time_ms(lambda: torch.ones(1 << 20, device=device).sum(),
                      inner=3, repeats=3)
    assert 0.0 < ms < 1000.0


def _rowlane_vs_plain(bk, v):
    before = rl.rowlane_backup_cuda.launches
    got = bk(v)
    torch.cuda.synchronize()
    assert rl.rowlane_backup_cuda.launches == before + 1
    _bitwise(got, bk.plain(v))
    return got


@pytest.mark.parametrize("channel,failure", [("x", False), ("y", False),
                                             ("z", False), ("x", True)])
@pytest.mark.parametrize("size", ["reference", "high_res"])
def test_rowlane_one_sweep_bitwise(device, channel, failure, size):
    cfg = pos_att.PosAttConfig() if size == "reference" \
        else pos_att.PosAttConfig.high_res()
    p = pos_att.build_channel(cfg, channel, failure=failure, with_cost=False,
                              device=device)
    bk = pos_att.build_channel_rowlane_backup(cfg, p)
    rng = np.random.default_rng(7)
    v = torch.from_numpy(rng.uniform(0, 50, p.plan.grid_shape)
                         .astype(np.float32)).to(device)
    _rowlane_vs_plain(bk, v)


def _tied_backup(cfg, device):
    """The x channel with every action listed twice (actions 9..17 repeat
    0..8), so every minimum is an exact tie."""
    p = pos_att.build_channel(cfg, "x", with_cost=False, device=device)

    def twice(a):
        return torch.cat([a, a], dim=-1) if a.shape[-1] > 1 else a

    plan = InterpPlan(tuple(twice(a) for a in p.plan.lo),
                      tuple(twice(a) for a in p.plan.frac),
                      p.plan.grid_shape)
    forces = np.concatenate([p.forces, p.forces])
    return pos_att.build_channel_rowlane_backup(
        cfg, p._replace(plan=plan, forces=forces))


def test_rowlane_exact_ties_take_the_first_action(device):
    cfg = pos_att.PosAttConfig()
    bk = _tied_backup(cfg, device)
    v = torch.from_numpy(np.random.default_rng(8).uniform(
        0, 50, bk.state_shape).astype(np.float32)).to(device)
    got = _rowlane_vs_plain(bk, v.permute(bk.inv).contiguous())
    assert int(got.argmin.max()) < 9


def test_channel_plan_on_card_equals_cpu(device):
    cfg = pos_att.PosAttConfig()
    for ch in pos_att.CHANNELS:
        pc = pos_att.build_channel(cfg, ch, device="cpu")
        pg = pos_att.build_channel(cfg, ch, device=device)
        for a, b in zip(pc.plan.lo + pc.plan.frac, pg.plan.lo + pg.plan.frac):
            assert torch.equal(a, b.cpu())
        assert torch.equal(pc.stage_cost, pg.stage_cost.cpu())


def test_pos_att_solve_launches_and_equals_plain(device):
    """The four channels run in lockstep, one launch a sweep (the sweeps
    between two checks replayed as a CUDA graph): launches = the longest
    channel's sweeps, channel-sweeps = their sum."""
    cfg = pos_att.PosAttConfig(n_mesh_x=12, n_mesh_v=12, n_mesh_t=8,
                               n_mesh_w=7, T_final=2.0)
    before = rl.rowlane_backup_cuda.launches
    before_ch = rl.rowlane_backup_cuda.channel_sweeps
    sk = pos_att.solve(cfg, device=device, impl="kernel")
    n = [r.num_sweeps for r in sk.results.values()]
    assert rl.rowlane_backup_cuda.launches == before + max(n)
    assert rl.rowlane_backup_cuda.channel_sweeps == before_ch + sum(n)
    sp = pos_att.solve(cfg, device=device, impl="rowlane")
    assert rl.rowlane_backup_cuda.launches == before + max(n)
    for name, ck in sk.controllers.items():
        assert torch.equal(ck.values, sp.controllers[name].values)
        assert torch.equal(ck.argmin, sp.controllers[name].argmin)
        assert sk.results[name].num_sweeps == sp.results[name].num_sweeps
        assert torch.equal(sk.results[name].checks, sp.results[name].checks)


def test_fleet_member_equals_single_flight(device):
    cfg = pos_att.PosAttConfig(n_mesh_x=12, n_mesh_v=12, n_mesh_t=8,
                               n_mesh_w=7, T_final=2.0)
    sol = pos_att.solve(cfg, device=device, include_failure=False)
    x0s = np.stack([pos_att.default_x0(p) for p in (2.0, -1.5)])
    x0s[:, 0] = (-0.05, 0.08)
    for integrator, t_final in (("rk4", 0.5), ("ode45", 0.1)):
        _, Xb, Fb, _ = pos_att.rollout_batch(sol, x0s, t_final=t_final,
                                             integrator=integrator)
        for b in range(2):
            _, X, F, _ = pos_att.get_optimal_path(
                sol, x0s[b], t_final=t_final, integrator=integrator)
            assert torch.equal(Xb[b], X)
            assert torch.equal(Fb[b], F)


def _attitude_backup(device, case, **kw):
    """The 6-D backup of ``build_full``'s plan; ``case`` 'tie' zeroes the
    cost (with ``h=0`` every action ties), 'permuted' reorders the actions
    so that the generic action phase runs, 'twice' lists every action
    twice (54 actions: the generic phase, each action tied exactly with its
    copy)."""
    _, plan, cost = attitude.build_full(attitude.AttitudeConfig(**kw),
                                        device=device)
    cost = list(cost)
    if case == "tie":
        cost = [torch.zeros_like(t) for t in cost]
    elif case in ("permuted", "twice"):
        idx = torch.arange(27).repeat(2) if case == "twice" else \
            torch.from_numpy(np.random.default_rng(3).permutation(27))
        idx = idx.to(device)
        plan = InterpPlan(
            tuple(x[..., idx] if x.shape[-1] > 1 else x for x in plan.lo),
            tuple(x[..., idx] if x.shape[-1] > 1 else x for x in plan.frac),
            plan.grid_shape)
        cost[2] = cost[2][..., idx]
    return b6.Backup6D(plan, cost)


# the 6-D configurations past 3 taps an axis (backup6d_wide): a lighter
# roll axis and an asymmetric rate range give row taps (-1, 0, 1, 2) x
# (-1, 0, 1) x (-1, 0, 1), 36 and 31 live combos, 27 lane combos
WIDE_6D = dict(n_mesh_w=15, h=0.02, w_min_deg=-50.0, w_max_deg=30.0,
               inertia_diag=(0.0225, 0.028317, 0.0245))
WIDE_6D_31 = dict(n_mesh_w=11, h=0.025, w_min_deg=-35.0, w_max_deg=50.0,
                  inertia_diag=(0.019, 0.028317, 0.0245))


@pytest.mark.parametrize("case,kw", [
    ("extrapolate", dict(n_mesh_w=5, n_mesh_q=4)),
    ("extrapolate", dict(n_mesh_w=11, n_mesh_q=10)),
    ("tie", dict(n_mesh_w=5, n_mesh_q=4, h=0.0)),
    ("permuted", dict(n_mesh_w=5, n_mesh_q=4)),
    ("extrapolate", dict(WIDE_6D, n_mesh_q=10)),
    ("extrapolate", dict(WIDE_6D_31, n_mesh_q=4)),
    ("permuted", dict(WIDE_6D, n_mesh_q=4)),
    ("twice", dict(WIDE_6D, n_mesh_q=4)),
], ids=["5x4", "11x10", "tie", "generic", "wide-36-15x10", "wide-31-11x4",
        "wide-36-generic", "wide-36-ties"])
def test_backup6d_one_sweep_bitwise(device, case, kw):
    """One sweep of B.3 equal to the plain version bitwise:
    ``backup6d_sweep_cube`` on the full (-1, 0, 1) tap cube at digit base
    3, ``backup6d_sweep`` on other structures of at most 3 taps an axis,
    ``backup6d_wide`` past them (the tile plan says which), in the
    factorized phase and in the generic one; exact ties take the first
    action."""
    bk = _attitude_backup(device, case, **kw)
    assert (bk.action_digits is None) == (case in ("permuted", "twice"))
    v = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 50, bk.state_shape).astype(np.float32)).to(device)
    plan, blocks = b6.tile_occupancy(v.reshape(bk.NW, bk.NE), bk.args)
    assert plan.wide == ("w_min_deg" in kw) and blocks >= 1
    assert plan.cube_body == (case == "extrapolate" and "w_min_deg" not in kw)
    before = b6.backup6d_cuda.launches
    cube_before = b6.backup6d_cuda.cube_launches
    got = bk(v)
    torch.cuda.synchronize()
    assert b6.backup6d_cuda.launches == before + 1
    assert b6.backup6d_cuda.cube_launches == cube_before + plan.cube_body
    _bitwise(got, bk.plain(v))
    if case == "tie":
        assert int(got.argmin.max()) == 0
    if case == "twice":
        assert int(got.argmin.max()) < 27


@pytest.mark.parametrize("case", ["edges", "lanes-cut", "both-halos",
                                  "ties"])
def test_backup6d_tiles_bitwise(device, case):
    """The shared-memory tiles' edges vs the plain version: a block with no
    halo rows, whose tiles each read past both table edges; an 11^3 x 10^3
    sweep, whose 1000 lanes the tile does not divide; a block with halo rows
    of the table on both sides; the exact-tie grid."""
    kw = dict(n_mesh_w=5, n_mesh_q=4, h=0.0) if case == "ties" else \
        dict(n_mesh_w=11, n_mesh_q=10)
    bk = _attitude_backup(device, "tie" if case == "ties" else "extrapolate",
                          **kw)
    v = torch.from_numpy(np.random.default_rng(13).uniform(
        0, 50, (bk.NW, bk.NE)).astype(np.float32)).to(device)
    lo, hi = bk.row_reach()
    if case == "edges":
        args, t = b6.block_args(bk.args, 600, 610, 0, 0), v[600:610]
    elif case == "both-halos":
        args = b6.block_args(bk.args, 400, 900, lo, hi)
        t = v[400 - lo:900 + hi]
    else:
        args, t = bk.args, v
    t = t.contiguous()
    plan, blocks = b6.tile_occupancy(t, args)
    # a block of no halo rows is a table of its own: the cube body
    assert plan.cube_body == (case in ("edges", "lanes-cut"))
    assert plan.smem_bytes > 0 and blocks >= 1
    if case == "edges":
        assert plan.stage_rows(0).min() < 0 and plan.stage_rows(0).max() >= 10
    if case == "lanes-cut":
        assert bk.NE % plan.lanes != 0
    got = b6.backup6d_cuda(t, args)
    torch.cuda.synchronize()
    _bitwise(got, b6.backup6d_plain(t, args))
    if case == "ties":
        assert int(got.argmin.max()) == 0


def test_backup6d_past_2_31_cells_is_not_refused(device):
    """The wrapper takes a grid past 2**31 cells (64-bit offsets): its input
    check passes such shapes (meta tensors stop it only at the device)."""
    nw, ne = 60**3, 22**3
    _, plan, cost = attitude.build_full(
        attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4), device=device)
    a = b6.Backup6D(plan, cost).args

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    big = a._replace(
        row_shape=(60,) * 3, lane_shape=(22,) * 3,
        row_off=meta((3, nw, 27), torch.int32), row_frac=meta((3, nw, 27)),
        lane_off=tuple(meta((nw, ne), torch.int32) for _ in range(3)),
        lane_frac=tuple(meta((nw, ne)) for _ in range(3)),
        c_row=meta((nw,)), c_lane=meta((ne,)))
    with pytest.raises(ValueError, match="must be on the CUDA device"):
        b6._check_cuda_inputs(meta((nw, ne)), big)


@pytest.mark.parametrize("kw", [dict(n_mesh_w=7, n_mesh_q=5),
                                dict(WIDE_6D, n_mesh_q=4)],
                         ids=["7x5", "wide-36"])
def test_solve_full_kernel_equals_plain(device, kw):
    """``solve_full`` (auto) through B.3, one launch a sweep
    (``backup6d_sweep_cube`` at the full tap cube, counted in
    ``cube_launches``; ``backup6d_wide`` at 36 combos, not counted there),
    equals ``impl='plain'``."""
    cfg = attitude.AttitudeConfig(**kw)
    before = b6.backup6d_cuda.launches
    cube_before = b6.backup6d_cuda.cube_launches
    sk = attitude.solve_full(cfg, num_sweeps=20)      # the card, the kernel
    assert b6.backup6d_cuda.launches == before + 20
    cube = 0 if "w_min_deg" in kw else 20
    assert b6.backup6d_cuda.cube_launches == cube_before + cube
    sp = attitude.solve_full(cfg, num_sweeps=20, impl="plain", device=device)
    assert b6.backup6d_cuda.launches == before + 20
    assert b6.backup6d_cuda.cube_launches == cube_before + cube
    assert sk.result.values.is_cuda
    _bitwise(sk.result, sp.result)


def _twin_actions(args):
    """``args`` with the row plan of digit 2 made that of digit 0 on each
    axis, and each action's cost that of its twin: every action with a
    digit 2 ties exactly with the one that has 0 there, which comes first.
    The declared tap structure stays the full cube."""
    twin = [int("".join("0" if d == "2" else d for d in np.base_repr(a, 3)
                        .zfill(3)), 3) for a in range(27)]
    cols = [[a - 2 * 3 ** (2 - k) if (a // 3 ** (2 - k)) % 3 == 2 else a
             for a in range(27)] for k in range(3)]

    def per_axis(t):
        return torch.stack([t[k][:, cols[k]] for k in range(3)]).contiguous()

    return args._replace(row_off=per_axis(args.row_off),
                         row_frac=per_axis(args.row_frac),
                         c_act=tuple(args.c_act[twin[a]] for a in range(27)))


@pytest.mark.parametrize("case", ["11x10", "7x5", "twins", "rowact-rowlane",
                                  "tile-edges", "uint8"])
def test_backup6d_cube_body_bitwise(device, case):
    """``backup6d_sweep_cube``, the cube body on a stored lane plan for the
    full (-1, 0, 1) tap cube at digit base 3, equal to ``backup6d_plain``
    bit for bit: the reference shape; 7^3 x 5^3; exact ties (every action
    with a digit 2 has a twin, digit 0 there, with the same total: the
    argmin never holds a 2); row-action and row-lane costs present; the
    tile edges at 11^3 x 10^3 (row tiles clipped at both table edges, a cut
    lane tile, an odd row count: the last chunk's second cell past the
    table); a uint8 argmin (B.4's)."""
    kw = dict(n_mesh_w=7, n_mesh_q=5) if case == "7x5" else \
        dict(n_mesh_w=11, n_mesh_q=10)
    bk = _attitude_backup(device, "extrapolate", **kw)
    rng = np.random.default_rng(29)
    v = torch.from_numpy(rng.uniform(0, 50, (bk.NW, bk.NE))
                         .astype(np.float32)).to(device)
    args = bk.args
    if case == "twins":
        args = _twin_actions(args)
    elif case == "rowact-rowlane":
        args = args._replace(
            c_rowact=torch.from_numpy(rng.uniform(-1, 1, (bk.NW, 27))
                                      .astype(np.float32)).to(device),
            c_rowlane=torch.from_numpy(rng.uniform(-1, 1, (bk.NW, bk.NE))
                                       .astype(np.float32)).to(device))
    elif case == "uint8":
        args = args._replace(argmin_dtype=torch.uint8)
    assert b6.cube_body(args)
    plan, blocks = b6.tile_occupancy(v, args)
    assert plan.cube_body and blocks >= 1
    if case == "tile-edges":
        assert plan.stage_rows(0).min() < 0
        assert plan.stage_rows(plan.grid[0] - 1).max() >= bk.NW
        assert bk.NE % plan.lanes != 0 and bk.NW % b6.CUBE_CELLS != 0
    before = b6.backup6d_cuda.cube_launches
    got = b6.backup6d_cuda(v, args)
    torch.cuda.synchronize()
    assert b6.backup6d_cuda.cube_launches == before + 1
    assert got.argmin.dtype == args.argmin_dtype
    _bitwise(got, b6.backup6d_plain(v, args))
    if case == "twins":
        a = got.argmin
        assert not bool(((a // 9 == 2) | (a // 3 % 3 == 2) | (a % 3 == 2))
                        .any())


def _recompute_backup(device, n_w=7, n_q=5, edge="extrapolate",
                      argmin_dtype=torch.uint8):
    _, plan, cost = attitude.build_full(
        attitude.AttitudeConfig(n_mesh_w=n_w, n_mesh_q=n_q), edge=edge,
        lane_mode="recompute", device=device)
    return b6.Backup6D(plan, cost, argmin_dtype=argmin_dtype)


@pytest.mark.parametrize("case", ["uint8", "int32", "twins", "clamp",
                                  "tile-edges", "rowact-rowlane"])
def test_backup6d_recompute_cube_body_bitwise(device, case):
    """``backup6d_sweep_recompute_cube``, the cube body with the lanes
    recomputed (B.5) for the full (-1, 0, 1) tap cube at digit base 3,
    equal to ``backup6d_plain`` with the plain
    recompute bit for bit: uint8 and int32 argmin at 7^3 x 5^3 (an odd row
    count: the last chunk's second cell past the table); exact ties (every
    action with a digit 2 has a twin, digit 0 there, with the same total:
    the argmin never holds a 2); ``edge='clamp'``; 11^3 x 10^3 (row tiles
    clipped at both table edges, 1000 lanes the tile does not divide, an
    odd row count); row-action and row-lane costs present."""
    bk = _recompute_backup(
        device, *((11, 10) if case == "tile-edges" else (7, 5)),
        edge="clamp" if case == "clamp" else "extrapolate",
        argmin_dtype=torch.int32 if case == "int32" else torch.uint8)
    rng = np.random.default_rng(37)
    v = torch.from_numpy(rng.uniform(0, 50, (bk.NW, bk.NE))
                         .astype(np.float32)).to(device)
    args = bk.args
    if case == "twins":
        args = _twin_actions(args)
    elif case == "rowact-rowlane":
        args = args._replace(
            c_rowact=torch.from_numpy(rng.uniform(-1, 1, (bk.NW, 27))
                                      .astype(np.float32)).to(device),
            c_rowlane=torch.from_numpy(rng.uniform(-1, 1, (bk.NW, bk.NE))
                                       .astype(np.float32)).to(device))
    assert b6.cube_body(args) and bk.NW % b6.CUBE_CELLS == 1
    plan, blocks = b6.tile_occupancy(v, args)
    assert plan.cube_body and blocks >= 1
    if case == "tile-edges":
        assert plan.stage_rows(0).min() < 0
        assert plan.stage_rows(plan.grid[0] - 1).max() >= bk.NW
        assert bk.NE % plan.lanes != 0
    before = b6.backup6d_cuda.launches
    cube_before = b6.backup6d_cuda.cube_launches
    got = b6.backup6d_cuda(v, args)
    torch.cuda.synchronize()
    assert b6.backup6d_cuda.launches == before + 1
    assert b6.backup6d_cuda.cube_launches == cube_before + 1
    assert got.argmin.dtype == args.argmin_dtype
    _bitwise(got, b6.backup6d_plain(v, args))
    if case == "twins":
        a = got.argmin.int()
        assert not bool(((a // 9 == 2) | (a // 3 % 3 == 2) | (a % 3 == 2))
                        .any())


def test_backup6d_recompute_cube_equals_b4_on_filled_plan(device):
    """B.5 through ``backup6d_sweep_recompute_cube`` equals one B.4 sweep
    of the same table on a lane plan filled from the plain recompute, at
    11^3 x 10^3, through ``backup6d_sweep_cube`` and through
    ``backup6d_sweep`` (the same sweep as a range of every action):
    bitwise, values and argmin."""
    bk = _recompute_backup(device, 11, 10)
    a5 = bk.args
    offs, fracs = a5.lanes.lane_block(0, bk.NW)
    a4 = a5._replace(lane_off=tuple(o.contiguous() for o in offs),
                     lane_frac=tuple(f.contiguous() for f in fracs),
                     lanes=None)
    v = torch.from_numpy(np.random.default_rng(41).uniform(
        0, 50, (bk.NW, bk.NE)).astype(np.float32)).to(device)
    a4s = b6.slice_args(a4, 0, 27)
    assert b6.tile_occupancy(v, a4)[0].cube_body
    assert b6.tile_occupancy(v, a4s)[0].kind == b6.SWEEP_KIND
    assert b6.tile_occupancy(v, a5)[0].cube_body
    cube_before = b6.backup6d_cuda.cube_launches
    got4 = b6.backup6d_cuda(v, a4)
    got4s = b6.backup6d_cuda(v, a4s)
    got5 = b6.backup6d_cuda(v, a5)
    torch.cuda.synchronize()
    assert b6.backup6d_cuda.cube_launches == cube_before + 2
    _bitwise(got5, got4)
    _bitwise(got5, got4s)


ENVELOPE_MODES = [
    ("plan", torch.int32, True), ("plan", torch.uint8, True),
    ("plan", torch.uint8, False), ("recompute", torch.uint8, True),
    ("recompute", torch.int32, False)]


@pytest.mark.parametrize("lane_mode,adt,track", ENVELOPE_MODES,
                         ids=["b4-int32", "b4-uint8", "b4-min-only",
                              "b5-uint8", "b5-int32-min-only"])
@pytest.mark.parametrize("edge", ["extrapolate", "clamp"])
@pytest.mark.parametrize("size", [dict(n_mesh_w=7), WIDE_6D],
                         ids=["7x5", "wide-36"])
def test_envelope_one_sweep_bitwise(device, lane_mode, adt, track, edge,
                                    size):
    """B.4 (flat stored plan) and B.5 (lane recompute) vs their plain
    versions, one sweep: values and argmin bitwise, through the cube body
    (the tracking sweeps of the full tap cube: ``backup6d_sweep_cube`` or
    ``backup6d_sweep_recompute_cube``), ``backup6d_sweep`` (the min-only
    ones) and, at 36 row combos, ``backup6d_wide``."""
    kw = dict(flat=True) if lane_mode == "plan" else dict(lane_mode=lane_mode)
    _, plan, cost = attitude.build_full(
        attitude.AttitudeConfig(**size, n_mesh_q=5), edge=edge, **kw)
    bk = b6.Backup6D(plan, cost, argmin_dtype=adt, track_argmin=track)
    v = torch.from_numpy(np.random.default_rng(11).uniform(
        0, 50, (bk.NW, bk.NE)).astype(np.float32)).to(device)
    cube = b6.tile_occupancy(v, bk.args)[0].cube_body
    assert cube == (track and "w_min_deg" not in size)
    before = b6.backup6d_cuda.launches
    cube_before = b6.backup6d_cuda.cube_launches
    got = b6.backup6d_cuda(v, bk.args)
    torch.cuda.synchronize()
    assert b6.backup6d_cuda.launches == before + 1
    assert b6.backup6d_cuda.cube_launches == cube_before + cube
    assert got.argmin.dtype == adt
    _bitwise(got, b6.backup6d_plain(v, bk.args))
    if not track:
        assert int(got.argmin.max()) == 0


@pytest.mark.parametrize("lane_mode", ["plan", "recompute"])
def test_envelope_carry_solve_equals_plain(device, lane_mode):
    """A forced flat, carry-mode solve through B.4 or B.5 (the cube body,
    one launch a sweep) equals the plain version's solve; its tables stay
    flat."""
    cfg = attitude.AttitudeConfig(n_mesh_w=7, n_mesh_q=5)
    before = b6.backup6d_cuda.launches
    cube_before = b6.backup6d_cuda.cube_launches
    sk = attitude.solve_full(cfg, num_sweeps=10, flat=True,
                             carry_padded=True, lane_mode=lane_mode)
    assert b6.backup6d_cuda.launches == before + 10 and sk.is_flat
    assert b6.backup6d_cuda.cube_launches == cube_before + 10
    sp = attitude.solve_full(cfg, num_sweeps=10, flat=True,
                             lane_mode=lane_mode, impl="plain",
                             device=device)
    assert torch.equal(sk.result.values.reshape(sp.result.values.shape),
                       sp.result.values)
    assert torch.equal(sk.result.argmin.reshape(sp.result.argmin.shape),
                       sp.result.argmin)


def _band_vs_plain(bk, v):
    before = bb.band_backup2d_cuda.launches
    got = bk(v)
    torch.cuda.synchronize()
    assert bb.band_backup2d_cuda.launches == before + 1
    _bitwise(got, bk.plain(v))
    return got


def _seeded(shape, device, seed=12):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0.0, 100.0, shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("edge", ["clamp", "extrapolate"])
@pytest.mark.parametrize("size,axis", [((17, 40), 0), ((1000, 300), 0),
                                       ((1000, 300), 2)],
                         ids=["17x40", "full-yaw", "full-roll"])
def test_band_one_sweep_bitwise(device, size, axis, edge):
    """B.6 vs its plain version, one sweep: at (17, 40) and on full
    simplified axes (25 and 27 live omega taps), both edge policies."""
    cfg = attitude.AttitudeConfig(n_mesh_w=size[0], n_mesh_t=size[1])
    _, plan, terms = attitude.build_simplified_axis(cfg, axis, edge=edge,
                                                    device=device)
    _band_vs_plain(bb.BandBackup2D(plan, terms), _seeded(size, device))


def test_band_wide_band_runs_the_kernel(device):
    """The roll axis at n_mesh_w=2500 needs a 67-tap omega band, past the
    JAX stencil's 64-tap cap: the kernel reads only lo/frac, so the auto
    solve runs it, and one sweep equals the plain tap loop bitwise."""
    cfg = attitude.AttitudeConfig(n_mesh_w=2500, n_mesh_t=300)
    _, plan, terms = attitude.build_simplified_axis(cfg, 2, device=device)
    bk = bb.BandBackup2D(plan, terms)
    _band_vs_plain(bk, _seeded((2500, 300), device))
    t_lo, t_hi = bk.taps.taps[0]
    assert t_hi - t_lo + 2 > 64
    before = bb.band_backup2d_cuda.launches
    before_ch = bb.band_backup2d_cuda.channel_sweeps
    sol = attitude.solve_simplified(cfg, num_sweeps=3)
    assert bb.band_backup2d_cuda.launches == before + 3
    assert bb.band_backup2d_cuda.channel_sweeps == before_ch + 9
    assert all(bool(torch.isfinite(v).all()) for v in sol.values)


def test_band_channel_batch_bitwise(device):
    """Position's C = 3 batch at PositionConfig(): the kernel equals the
    plain version, and each channel equals its own C = 1 sweep."""
    p = position.build(position.PositionConfig(), device=device)
    bk = bb.BandBackup2D(p.plan, p.stage_cost)
    v = _seeded(p.plan.grid_shape, device)
    got = _band_vs_plain(bk, v)
    for c in range(3):
        plan_c = InterpPlan((p.plan.lo[1][0], p.plan.lo[2][0]),
                            (p.plan.frac[1][0], p.plan.frac[2][0]),
                            p.plan.grid_shape[1:])
        one = bb.BandBackup2D(plan_c, p.stage_cost[c])(v[c])
        assert torch.equal(one.values, got.values[c])
        assert torch.equal(one.argmin, got.argmin[c])


def _tied_band_backup(device):
    """A simplified axis with h = 0 (every query on a grid point), no cost
    and each action listed twice: every minimum is an exact tie."""
    cfg = attitude.AttitudeConfig(n_mesh_w=50, n_mesh_t=30, h=0.0)
    _, plan, _ = attitude.build_simplified_axis(cfg, 0, device=device)

    def twice(a):
        return torch.cat([a, a], dim=-1) if a.shape[-1] > 1 else a

    plan = InterpPlan(tuple(twice(a) for a in plan.lo),
                      tuple(twice(a) for a in plan.frac), plan.grid_shape)
    return bb.BandBackup2D(plan, torch.zeros((50, 30, 6), device=device))


def test_band_exact_ties_take_the_first_action(device):
    bk = _tied_band_backup(device)
    got = _band_vs_plain(bk, _seeded((50, 30), device))
    assert int(got.argmin.max()) == 0


def test_solve_simplified_kernel_equals_plain(device):
    """The three axes in one launch a sweep, 220 sweeps: two CUDA graph
    replays of GRAPH_SWEEPS and 20 eager launches."""
    cfg = attitude.AttitudeConfig(n_mesh_w=101, n_mesh_t=40)
    before = bb.band_backup2d_cuda.launches
    before_ch = bb.band_backup2d_cuda.channel_sweeps
    sk = attitude.solve_simplified(cfg, num_sweeps=220)    # the card, B.6
    assert bb.band_backup2d_cuda.launches == before + 220
    assert bb.band_backup2d_cuda.channel_sweeps == before_ch + 660
    sp = attitude.solve_simplified(cfg, num_sweeps=220, impl="plain",
                                   device=device)
    assert bb.band_backup2d_cuda.launches == before + 220
    for i in range(3):
        assert sk.values[i].is_cuda
        assert torch.equal(sk.values[i], sp.values[i])
        assert torch.equal(sk.u_tables[i], sp.u_tables[i])


def test_solve_simplified_rowlane_runs_kernel_b2(device):
    """impl='rowlane' on the card: one axis as rows (omega,) and lanes
    (theta,), each with a unit axis in front, through the B.2 kernel."""
    cfg = attitude.AttitudeConfig(n_mesh_w=101, n_mesh_t=40)
    before = rl.rowlane_backup_cuda.launches
    sk = attitude.solve_simplified(cfg, num_sweeps=10, impl="rowlane")
    assert rl.rowlane_backup_cuda.launches == before + 30
    _, plan, terms = attitude.build_simplified_axis(cfg, 1, device=device)
    bk = rl.RowLaneBackup(plan, terms, perm=(0, 1), row_axes=1)
    assert bk.args.row_shape == (1, 101) and bk.args.lane_shape == (1, 40)
    _rowlane_vs_plain(bk, _seeded((101, 40), device))
    assert all(bool(torch.isfinite(v).all()) for v in sk.values)


def test_position_solve_kernel_equals_plain(device):
    cfg = position.PositionConfig(n_mesh_x=60, n_mesh_v=60)
    before = bb.band_backup2d_cuda.launches
    sk = position.solve(cfg, num_sweeps=20)
    assert bb.band_backup2d_cuda.launches == before + 20
    sp = position.solve(cfg, num_sweeps=20, impl="plain", device=device)
    _bitwise(sk.result, sp.result)


def _pos_att_batch(cfg, device):
    bks = []
    for ch, failure in (("x", False), ("y", False), ("z", False),
                        ("x", True)):
        p = pos_att.build_channel(cfg, ch, failure=failure, with_cost=False,
                                  device=device)
        bks.append(pos_att.build_channel_rowlane_backup(cfg, p))
    vs = [_seeded(b.state_shape, device, seed=13 + i).permute(b.inv)
          .contiguous() for i, b in enumerate(bks)]
    return bks, vs


@pytest.mark.parametrize("size", ["reference", "high_res"])
def test_rowlane_batch_equals_per_channel_launches(device, size):
    """The four channels (x_failure's 6 actions among 9) in one launch
    equal four one-channel launches and the plain version bitwise."""
    cfg = pos_att.PosAttConfig() if size == "reference" \
        else pos_att.PosAttConfig.high_res()
    bks, vs = _pos_att_batch(cfg, device)
    tabs = [b.to_table(v) for b, v in zip(bks, vs)]
    ov = [torch.empty_like(t) for t in tabs]
    oa = [torch.empty(t.shape, dtype=torch.int32, device=device)
          for t in tabs]
    before = rl.rowlane_backup_cuda.launches
    rl.rowlane_backup_cuda(tabs, [b.args for b in bks], ov, oa)
    assert rl.rowlane_backup_cuda.launches == before + 1
    for b, t, v, a in zip(bks, tabs, ov, oa):
        one = rl.rowlane_backup_cuda(t, b.args)
        torch.cuda.synchronize()
        assert torch.equal(v, one.values) and torch.equal(a, one.argmin)
        want = rl.rowlane_backup_plain(t, b.args)
        assert torch.equal(v, want.values) and torch.equal(a, want.argmin)


def test_rowlane_graph_replay_equals_eager(device):
    """50 sweeps of the four channels captured as one CUDA graph and
    replayed equal 50 eager launches bitwise; the replay counts its 50
    launches and 200 channel-sweeps, the capture none."""
    from ocdp_tpu_torch.engine import SweepGraph, ping_pong

    bks, vs = _pos_att_batch(pos_att.PosAttConfig(), device)
    batch = rl.RowLaneBatch(bks)
    active = (0, 1, 2, 3)
    out = []
    for graphed in (False, True):
        cur, nxt, arg = batch.buffers(vs)

        def step(src, dst):
            batch.sweep(src, dst, arg, active)

        if graphed:
            batch.prepare(active)
            before = (rl.rowlane_backup_cuda.launches,
                      rl.rowlane_backup_cuda.channel_sweeps)
            g = SweepGraph(step, cur, nxt, 50, (batch.launcher,))
            assert (rl.rowlane_backup_cuda.launches,
                    rl.rowlane_backup_cuda.channel_sweeps) == before
            g.replay()
            assert rl.rowlane_backup_cuda.launches == before[0] + 50
            assert rl.rowlane_backup_cuda.channel_sweeps == before[1] + 200
        else:
            ping_pong(step, cur, nxt, 50)
        torch.cuda.synchronize()
        out.append((cur, arg))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_band_graph_replay_equals_eager(device):
    """GRAPH_SWEEPS sweeps of the three simplified axes as one CUDA graph
    equal eager launches bitwise, and the finite engine's graph path equals
    its allocating loop (the plain version's solve)."""
    from ocdp_tpu_torch.engine import GRAPH_SWEEPS, SweepGraph, ping_pong

    cfg = attitude.AttitudeConfig(n_mesh_w=101, n_mesh_t=40)
    built = [attitude.build_simplified_axis(cfg, i, device=device)
             for i in range(3)]
    bk = bb.BandBackup2D.stack([p for _, p, _ in built],
                               [t for _, _, t in built])
    v = _seeded((3, 101, 40), device)
    out = []
    for graphed in (False, True):
        cur, nxt = v.clone(), torch.empty_like(v)
        arg = torch.zeros(v.shape, dtype=torch.int32, device=device)

        def step(src, dst):
            bk.sweep_into(src, dst, arg)

        if graphed:
            bk.prepare()
            g = SweepGraph(step, cur, nxt, GRAPH_SWEEPS, (bk.launcher,))
            g.replay()
        else:
            ping_pong(step, cur, nxt, GRAPH_SWEEPS)
        torch.cuda.synchronize()
        out.append((cur, arg))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_band_stack_equals_per_axis_launches(device):
    cfg = attitude.AttitudeConfig()
    built = [attitude.build_simplified_axis(cfg, i, device=device)
             for i in range(3)]
    bk = bb.BandBackup2D.stack([p for _, p, _ in built],
                               [t for _, _, t in built])
    v = _seeded((3, 1000, 300), device)
    got = _band_vs_plain(bk, v)
    for i, (_, plan, terms) in enumerate(built):
        one = bb.BandBackup2D(plan, terms)(v[i].contiguous())
        assert torch.equal(one.values, got.values[i])
        assert torch.equal(one.argmin, got.argmin[i])


def test_rowlane_40_combo_kind_bitwise(device):
    """Past 20 row combos B.2 runs kind 3 (up to 40): the x channel of
    ``PosAttConfig(n_mesh_w=120)`` (35 combos) alone, and the four channels
    of ``n_mesh_w=100`` (33, 35, 33 and 30) in one launch, each equal to
    its own launch and to the plain version bitwise; 20 sweeps of the four
    replayed as a CUDA graph equal eager launches."""
    from ocdp_tpu_torch.engine import SweepGraph, ping_pong

    cfg = pos_att.PosAttConfig(n_mesh_w=120)
    p = pos_att.build_channel(cfg, "x", with_cost=False, device=device)
    bk = pos_att.build_channel_rowlane_backup(cfg, p)
    assert len(bk.row_combos) == 35
    v = _seeded(bk.state_shape, device, seed=17).permute(bk.inv).contiguous()
    assert rl.launch_plan(v, [bk.args]).kind == 3
    _rowlane_vs_plain(bk, v)
    bks, vs = _pos_att_batch(pos_att.PosAttConfig(n_mesh_w=100), device)
    assert [len(b.row_combos) for b in bks] == [33, 35, 33, 30]
    tabs = [b.to_table(v) for b, v in zip(bks, vs)]
    args = [b.args for b in bks]
    assert rl.launch_plan(tabs[0], args).kind == 3
    ov = [torch.empty_like(t) for t in tabs]
    oa = [torch.empty(t.shape, dtype=torch.int32, device=device)
          for t in tabs]
    rl.rowlane_backup_cuda(tabs, args, ov, oa)
    for b, t, v, a in zip(bks, tabs, ov, oa):
        one = rl.rowlane_backup_cuda(t, b.args)
        want = rl.rowlane_backup_plain(t, b.args)
        torch.cuda.synchronize()
        assert torch.equal(v, one.values) and torch.equal(a, one.argmin)
        assert torch.equal(v, want.values) and torch.equal(a, want.argmin)
    batch = rl.RowLaneBatch(bks)
    out = []
    for graphed in (False, True):
        cur, nxt, arg = batch.buffers(vs)

        def step(src, dst):
            batch.sweep(src, dst, arg, (0, 1, 2, 3))

        if graphed:
            batch.prepare((0, 1, 2, 3))
            SweepGraph(step, cur, nxt, 20, (batch.launcher,)).replay()
        else:
            ping_pong(step, cur, nxt, 20)
        torch.cuda.synchronize()
        out.append((cur, arg))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


# simplified attitude axes: the default theta grid (lane taps -2..2) at
# n_mesh_w 1000 (kind 2) and 1400 (33 row combos: kind 4); finer theta grids,
# whose lane axes have 9-21 taps (the TPU kernel takes up to 40 lane combos)
ANY_TAP_AXES = {
    "w1000": (dict(n_mesh_w=1000), 0, 25, 5, 2),
    "w1400": (dict(n_mesh_w=1400), 0, 33, 5, 4),
    "t1000-yaw": (dict(n_mesh_t=1000), 0, 25, 11, 2),
    "t1000-pitch": (dict(n_mesh_t=1000), 1, 25, 15, 2),
    "t1000-roll": (dict(n_mesh_t=1000), 2, 27, 9, 2),
    "t1500-pitch": (dict(n_mesh_t=1500), 1, 25, 21, 2),
    "w300-h002-roll": (dict(n_mesh_w=300, h=0.02), 2, 33, 11, 4),
}


@pytest.mark.parametrize("name", list(ANY_TAP_AXES))
def test_rowlane_any_tap_kinds_bitwise(device, name):
    """A simplified attitude axis runs the any-tap kinds: kind 2 up to 32
    row combos, kind 4 past it (up to 40), on lane axes of 5-21 taps; one
    sweep equal to the plain version bitwise, and 5 sweeps of
    ``solve_simplified(impl='rowlane')`` there through the kernel only."""
    kw, axis, combos, taps, kind = ANY_TAP_AXES[name]
    cfg = attitude.AttitudeConfig(**kw)
    _, plan, terms = attitude.build_simplified_axis(cfg, axis, device=device)
    bk = rl.RowLaneBackup(plan, terms, perm=(0, 1), row_axes=1)
    assert (len(bk.row_combos), len(bk.lane_combos)) == (combos, taps)
    v = _seeded(plan.grid_shape, device, seed=23)
    assert rl.launch_plan(bk.to_table(v), [bk.args]).kind == kind
    _rowlane_vs_plain(bk, v)
    before = rl.rowlane_backup_cuda.launches
    sk = attitude.solve_simplified(cfg, num_sweeps=5, impl="rowlane")
    assert rl.rowlane_backup_cuda.launches == before + 15
    assert all(bool(torch.isfinite(t).all()) for t in sk.values)


@pytest.mark.parametrize("fault", ["slot", "reach"])
def test_rowlane_kernel_refuses_a_plan_that_misses_a_read(device, fault,
                                                          monkeypatch):
    """A tile map whose combo slot is one stage row off, or whose lane
    window is 4 lanes short, misses a read: the launch refuses it
    (cudaErrorInvalidValue) and counts nothing."""
    from ocdp_tpu_torch import _build

    bks, vs = _pos_att_batch(pos_att.PosAttConfig(), device)
    t = bks[0].to_table(vs[0])
    keys = (rl._plan_key(bks[0].args),)
    plan, ints, c_act, tile = rl._tiles(
        keys, rl._smem_limit(_build.load(), device))
    ints, tile = ints.copy(), tile.copy()
    if fault == "slot":
        ints[0, 12 + 3 * rl.MAX_GROUPS + 2 * rl.MAX_ROW_COMBOS] += 1
    else:
        tile[2] -= 4          # reach_lo
        tile[4] -= 4          # width
    monkeypatch.setattr(rl, "_tiles", lambda *_: (plan, ints, c_act, tile))
    before = rl.rowlane_backup_cuda.launches
    with pytest.raises(RuntimeError, match="invalid argument"):
        rl.rowlane_backup_cuda(t, bks[0].args)
    assert rl.rowlane_backup_cuda.launches == before


@pytest.mark.parametrize("kind", ["broadcast", "flat", "recompute"])
def test_backup6d_wide_block_and_slices_bitwise(device, kind):
    """backup6d_wide in B.7's modes: row blocks of the 36-combo
    configuration (its halo rows reach 2 t0 steps down) and their digit
    slices equal the plain version bitwise, and the slices combined by the
    first minimum equal the block's sweep."""
    from ocdp_tpu_torch.parallel.mesh import first_min

    extra = {"broadcast": {}, "flat": {"flat": True},
             "recompute": {"lane_mode": "recompute"}}[kind]
    _, plan, cost = attitude.build_full(
        attitude.AttitudeConfig(**WIDE_6D, n_mesh_q=4), **extra)
    bk = b6.Backup6D(plan, cost)
    v = _seeded((bk.NW, bk.NE), device, seed=41)
    lo, hi = bk.row_reach()
    assert (lo, hi) == (241, 466)
    vp = torch.nn.functional.pad(v, (0, 0, lo, hi))
    for r0, r1 in ((0, 1688), (1688, 3375), (1000, 1200)):
        args = b6.block_args(bk.args, r0, r1, lo, hi)
        local = vp[r0:r1 + lo + hi].contiguous()
        assert b6.tile_occupancy(local, args)[0].wide
        whole = b6.backup6d_cuda(local, args)
        _bitwise(whole, b6.backup6d_plain(local, args))
        vals, argm = [], []
        for g in range(3):
            sa = b6.slice_args(args, 9 * g, 9 * g + 9)
            got = b6.backup6d_cuda(local, sa)
            _bitwise(got, b6.backup6d_plain(local, sa))
            vals.append(got.values)
            argm.append(got.argmin)
        vmin, arg = first_min(vals, argm, 27)
        assert torch.equal(vmin, whole.values)
        assert torch.equal(arg, whole.argmin.to(torch.int32))


B7_KINDS = {"broadcast": {}, "flat": {"flat": True},
            "recompute": {"lane_mode": "recompute"}}


@pytest.mark.parametrize("mode", [(torch.int32, True), (torch.uint8, True),
                                  (torch.uint8, False)],
                         ids=["int32", "uint8", "min-only"])
@pytest.mark.parametrize("kind", list(B7_KINDS))
def test_b7_block_and_slices_bitwise(device, kind, mode):
    """B.7's row blocks (2 and 3 ranks) and digit slices vs their plain
    versions, and the slices combined by the first minimum vs one sweep."""
    from ocdp_tpu_torch.parallel.mesh import first_min

    _, plan, cost = attitude.build_full(
        attitude.AttitudeConfig(n_mesh_w=7, n_mesh_q=5), device=device,
        **B7_KINDS[kind])
    bk = b6.Backup6D(plan, cost, argmin_dtype=mode[0], track_argmin=mode[1])
    v = _seeded((bk.NW, bk.NE), device)
    lo, hi = bk.row_reach()
    vp = torch.nn.functional.pad(v, (0, 0, lo, hi))
    before = b6.backup6d_cuda.launches
    cube_before = b6.backup6d_cuda.cube_launches
    for r0, r1 in ((0, 172), (172, 343), (100, 200)):
        args = b6.block_args(bk.args, r0, r1, lo, hi)
        local = vp[r0:r1 + lo + hi].contiguous()
        whole = b6.backup6d_cuda(local, args)
        _bitwise(whole, b6.backup6d_plain(local, args))
        # the block's digit slices, as a rows x 3 mesh runs them
        vals, argm = [], []
        for g in range(3):
            sa = b6.slice_args(args, 9 * g, 9 * g + 9)
            assert sa.action_digits == 3
            got = b6.backup6d_cuda(local, sa)
            _bitwise(got, b6.backup6d_plain(local, sa))
            vals.append(got.values)
            argm.append(got.argmin)
        vmin, arg = first_min(vals, argm, 27)
        assert torch.equal(vmin, whole.values)
        if mode[1]:
            assert torch.equal(arg, whole.argmin.to(torch.int32))
    # 3 blocks and their 9 slices, none through the cube body
    assert b6.backup6d_cuda.launches == before + 12
    assert b6.backup6d_cuda.cube_launches == cube_before
    full = b6.backup6d_plain(v, bk.args)
    vals, argm = [], []
    for g in range(3):
        sa = b6.slice_args(bk.args, 9 * g, 9 * g + 9)
        got = b6.backup6d_cuda(v, sa)
        _bitwise(got, b6.backup6d_plain(v, sa))
        vals.append(got.values)
        argm.append(got.argmin)
    vmin, arg = first_min(vals, argm, 27)
    assert torch.equal(vmin, full.values)
    if mode[1]:
        assert torch.equal(arg, full.argmin.to(torch.int32))


def test_b7_output_may_not_overlap_the_table(device):
    _, plan, cost = attitude.build_full(
        attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4), device=device)
    bk = b6.Backup6D(plan, cost)
    lo, hi = bk.row_reach()
    t = torch.zeros((lo + 60 + hi, bk.NE), device=device)
    args = b6.block_args(bk.args, 0, 60, lo, hi)
    with pytest.raises(ValueError, match="overlap"):
        b6.backup6d_cuda(t, args, out_v=t[lo:lo + 60])


@pytest.mark.parametrize("sizes", [(2,), (4,), (2, 3)],
                         ids=["2", "4", "2x3"])
def test_halo6_on_the_card_equals_one_device(device, sizes):
    from ocdp_tpu_torch.engine import value_iteration_finite
    from ocdp_tpu_torch.parallel import (LocalMesh,
                                         value_iteration_finite_halo6)

    _, plan, cost = attitude.build_full(
        attitude.AttitudeConfig(n_mesh_w=9, n_mesh_q=6), device=device)
    ref = value_iteration_finite(plan, cost, 30, backup=b6.Backup6D(plan,
                                                                    cost))
    mesh = LocalMesh(("s", "a")[:len(sizes)], sizes)
    before = (b6.backup6d_cuda.launches, b6.backup6d_cuda.cube_launches)
    got = value_iteration_finite_halo6(
        plan, cost, 30, mesh,
        action_axis_name="a" if len(sizes) == 2 else None)
    # a B.7 launch a rank (and action group) a sweep; rank blocks and digit
    # slices never take the cube body
    n = 30 * int(np.prod(sizes))
    assert (b6.backup6d_cuda.launches,
            b6.backup6d_cuda.cube_launches) == (before[0] + n, before[1])
    _bitwise(got, ref)


def test_dryrun_on_the_card(device):
    from ocdp_tpu_torch.parallel.dryrun import dryrun_multichip

    assert len(dryrun_multichip(8)) == 9


def test_entry_step_is_one_b1_launch_equal_to_plain(device):
    from ocdp_tpu_torch import graft_entry

    step, (v0,) = graft_entry.entry()
    assert v0.is_cuda
    bk = step.backup
    v = torch.from_numpy(np.random.default_rng(3).uniform(
        0.0, 400.0, tuple(v0.shape)).astype(np.float32)).to(device)
    before = fb.fused_backup2d_affine_cuda.launches
    vals, arg = step(v)
    assert fb.fused_backup2d_affine_cuda.launches == before + 1
    want = fb.fused_backup2d_affine_plain(v, bk.args)
    assert torch.equal(vals, want.values)
    assert torch.equal(arg, want.argmin)


def test_trace_holds_each_b1_launch(device, tmp_path):
    import json

    from ocdp_tpu_torch import profiling

    cfg = kirk.KirkConfig.golden()
    before = fb.fused_backup2d_affine_cuda.launches
    with profiling.trace(tmp_path) as t:
        kirk.solve(cfg, device=device)
        torch.cuda.synchronize()
    launches = fb.fused_backup2d_affine_cuda.launches - before
    events = json.loads(t.path.read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    affine = [n for n in names if "affine_sweep" in n]
    assert launches == cfg.N - 1 == len(affine)
    assert not any("combine_splits" in n or "backup_partial" in n
                   for n in names)


def test_segmented_checkpoints_through_a_pinned_buffer(device, tmp_path,
                                                       monkeypatch):
    """The envelope path (flat recompute plan, uint8 argmin, carry mode)
    at 11^3 x 10^3 in segments of 4: the checkpoints are staged in one
    pinned buffer and written on the writer's thread while the next
    segment sweeps; each is bitwise its segment's table; the resume from
    the first is bitwise the uninterrupted solve; a warm solve allocates
    no pinned memory and copies the table into pinned memory."""
    from ocdp_tpu_torch import engine
    from ocdp_tpu_torch import io as tio
    from ocdp_tpu_torch.engine import (value_iteration_finite,
                                       value_iteration_segmented)

    grid, plan, cost = attitude.build_full(
        attitude.AttitudeConfig(n_mesh_w=11, n_mesh_q=10), device=device,
        lane_mode="recompute")
    carry = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8,
                        carry_padded=True)
    shape = PlanShape.of(plan)
    staged, written = [], []
    real_save, real_write = engine.save_values, tio._write_npz

    def save(*a, **kw):
        real_save(*a, **kw)
        h = kw["writer"]._host
        staged.append((h.is_pinned(), h.data_ptr()))

    def write(path, values, arrays):
        written.append((int(arrays["sweep_index"]), values.copy()))
        real_write(path, values, arrays)
        if len(written) == 1:
            real_write(str(tmp_path / "first.npz"), values, arrays)

    monkeypatch.setattr(engine, "save_values", save)
    monkeypatch.setattr(tio, "_write_npz", write)

    def solve(**kw):
        return value_iteration_segmented(
            shape, None, 9, segment_size=4, backup=carry,
            checkpoint_path=str(tmp_path / "c.npz"),
            checkpoint_axes=grid.axes, narrow_argmin_result=True, **kw)

    got = solve()
    assert [s for s, _ in written] == [4, 8, 9]
    assert [p for p, _ in staged] == [True] * 3
    assert len({ptr for _, ptr in staged}) == 1     # one buffer, reused
    for sweep, values in written:
        ref = value_iteration_finite(shape, None, sweep, backup=carry,
                                     narrow_argmin_result=True)
        assert np.array_equal(values, ref.values.cpu().numpy())
    assert torch.equal(got.values, ref.values)
    ck = tio.load_values(str(tmp_path / "first.npz"), device=device)
    assert ck.sweep_index == 4
    resumed = solve(init_values=ck.values, start_sweep=ck.sweep_index)
    assert resumed.num_sweeps == 5
    _bitwise(resumed, ref)

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        warm = solve()
        torch.cuda.synchronize()
    _bitwise(warm, ref)
    names = {e.name for e in prof.events()}
    assert any(n.startswith("cuda") for n in names)     # runtime calls seen
    assert not names & {"cudaHostAlloc", "cudaMallocHost", "cudaHostRegister"}
    assert any("DtoH" in n and "Pinned" in n for n in names), sorted(names)


def _plan_on(plan, dev):
    return InterpPlan(tuple(t.to(dev) for t in plan.lo),
                      tuple(t.to(dev) for t in plan.frac), plan.grid_shape)


def _args_bitwise(got, want):
    """Two backups' argument tensors equal bit for bit (floats as their
    bits), their host fields equal."""
    for field, g in got._asdict().items():
        w = getattr(want, field)
        pairs = list(zip(g, w)) if field in ("lane_off", "lane_frac") \
            else [(g, w)]
        for gi, wi in pairs:
            if isinstance(gi, torch.Tensor):
                gi, wi = gi.cpu(), wi.cpu()
                if gi.dtype == torch.float32:
                    gi, wi = gi.view(torch.int32), wi.view(torch.int32)
                assert gi.dtype == wi.dtype and torch.equal(gi, wi), field
            else:
                assert gi == wi, field


@pytest.mark.parametrize("case", ["attitude6d", "flat", "pos_att"])
def test_tap_analysis_on_the_card(device, case):
    """A plan on the card is analysed there: its argument tensors are the
    analysis of the same plan on the host, bit for bit, and the analysis
    reads back under 64 KB (the 11^3 x 10^3 plan's lane arrays alone are
    32 MB)."""
    from ocdp_tpu_torch.ops import liveness

    if case == "pos_att":
        cfg = pos_att.PosAttConfig()
        p = pos_att.build_channel(cfg, "x", with_cost=False, device=device)

        def analyse(dev):
            q = p._replace(plan=_plan_on(p.plan, dev))
            return pos_att.build_channel_rowlane_backup(cfg, q)
    else:
        cfg = (attitude.AttitudeConfig(n_mesh_w=11, n_mesh_q=10)
               if case == "attitude6d"
               else attitude.AttitudeConfig(n_mesh_w=7, n_mesh_q=5))
        _, plan, cost = attitude.build_full(cfg, flat=case == "flat",
                                            device=device)

        def analyse(dev):
            return b6.Backup6D(_plan_on(plan, dev),
                               [t.to(dev) for t in cost])
    calls, read = liveness.live_sets.calls, liveness.live_sets.read_bytes
    got = analyse(device)
    torch.cuda.synchronize()
    assert liveness.live_sets.calls == calls + 1
    assert liveness.live_sets.read_bytes - read < 64 * 1024
    assert all(t.is_cuda for t in (got.args.row_off, got.args.c_row,
                                   *got.args.lane_off))
    _args_bitwise(got.args, analyse(torch.device("cpu")).args)
