"""The fused 2-D backup's affine-query mode (ops/fused_backup2d.py,
``AffineBackup2D``; kernel in csrc/fused_backup2d.cu) on the CPU.

* The plain version forms the queries itself; it must equal the plan-streamed
  plain version on ``kirk.build``'s plan and the gather oracle **bitwise**
  (values and argmin) at the golden size, with extrapolating queries, and
  with negative and zero ``B`` entries.
* Against the TPU kernel it replaces (``PallasShearBackup``, interpret mode,
  action_chunk=10): |dV| <= 2e-6 * max(|V|, 1), argmin >= 99.9% equal, the
  tolerance tests/test_torch_backup.py uses (XLA:CPU fuses and contracts).
* The kernel's algorithm, written out in numpy float32 (its binary search,
  the walk of ``lo`` from action to action, the action splits and their
  combine, the table rows the planner stages, the action records staged a
  chunk of each split at a time): every located cell equals
  ``searchsorted`` over whole action ranges, every read lies in the staged
  rows (or, with the table read from global memory, in the table), every
  chunk slot a thread reads holds its own action's record, and the result
  equals the plain version bitwise, in each of the three stages.
* The engines through the graph-safe protocol (the graph schedule's eager
  twin on the CPU) and the policy store through ``sweep_into``: bitwise the
  gather solve.

The kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocdp_tpu.models import kirk as jkirk
from ocdp_tpu.ops.pallas_shear import build_pallas_shear_backup
from ocdp_tpu_torch.engine import value_iteration_finite
from ocdp_tpu_torch.models import kirk
from ocdp_tpu_torch.ops import fused_backup2d as fb
from ocdp_tpu_torch.ops.backup import bellman_backup
from ocdp_tpu_torch.ops.interp import PlanShape

torch.set_num_threads(2)

GOLDEN = kirk.KirkConfig.golden()
SMALL = kirk.KirkConfig(N=3, dx=12, du=40)
CONFIGS = {
    "golden": GOLDEN,
    # controls 8x past the reference's reach: queries far off the grid
    "extrapolating": dataclasses.replace(SMALL, u_min=-400.0, u_max=300.0),
    "negative_B": dataclasses.replace(SMALL, B=(-0.02, -0.3)),
    "zero_B0": dataclasses.replace(SMALL, B=(0.0, -0.3)),
    "zero_B1": dataclasses.replace(SMALL, B=(-0.02, 0.0),
                                   A=((-0.9, 0.3), (0.2, -1.1))),
}


def _values(seed, n):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0.0, 400.0, (n, n)).astype(np.float32))


def _bitwise(a, b):
    assert torch.equal(a.values, b.values)
    assert torch.equal(a.argmin, b.argmin)


def _streamed(cfg, problem):
    return fb.FusedBackup2D(
        problem.plan, problem.stage_cost,
        cost_terms=kirk._separable_cost_terms(cfg, device="cpu"))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_affine_plain_equals_streamed_and_gather_bitwise(name, seed):
    cfg = CONFIGS[name]
    p = kirk.build(cfg, device="cpu")
    v = _values(seed, cfg.dx)
    got = kirk.affine_backup(cfg, "cpu")(v)
    _bitwise(got, _streamed(cfg, p)(v))
    _bitwise(got, bellman_backup(v, p.plan, p.stage_cost))
    assert got.argmin.dtype == torch.int32


def test_extrapolating_configs_reach_past_the_grid():
    """The configs above do what their names say: fracs outside [0, 1] on
    both axes, and queries that move down the grid as u grows."""
    p = kirk.build(CONFIGS["extrapolating"], device="cpu")
    for f in p.plan.frac:
        assert float(f.min()) < -1.0 and float(f.max()) > 2.0
    lo = kirk.build(CONFIGS["negative_B"], device="cpu").plan.lo[1]
    assert bool((lo[..., -1] <= lo[..., 0]).all())
    assert bool((lo[..., -1] < lo[..., 0]).any())


def test_affine_plain_matches_pallas_shear_interpret():
    """The affine mode (CPU tensor -> its plain version) vs the TPU kernel
    it replaces, in interpret mode, separable cost on both sides."""
    pj = jkirk.build(jkirk.KirkConfig.golden())
    bk_j = build_pallas_shear_backup(
        pj.plan, pj.stage_cost, action_chunk=10,
        cost_terms=jkirk._separable_cost_terms(jkirk.KirkConfig.golden()))
    v = _values(3, GOLDEN.dx)
    want = jax.jit(lambda b, v_: b(v_))(bk_j, jnp.asarray(v.numpy()))
    got = kirk.affine_backup(GOLDEN, "cpu")(v)
    dv = np.abs(got.values.numpy().astype(np.float64)
                - np.asarray(want.values))
    assert dv.max() <= 2e-6 * max(float(np.abs(want.values).max()), 1.0)
    assert (got.argmin.numpy() == np.asarray(want.argmin)).mean() >= 0.999


def test_affine_query_is_kirk_builds_arithmetic():
    """The query helper, action-major, equals kirk.build's next states."""
    cfg = CONFIGS["zero_B1"]
    p = kirk.build(cfg, device="cpu")
    args = kirk.affine_backup(cfg, "cpu").args
    g0 = torch.from_numpy(args.axes[0])[None, :, None]
    g1 = torch.from_numpy(args.axes[1])[None, None, :]
    u = torch.from_numpy(args.u)[:, None, None]
    s_r = torch.from_numpy(args.axes[0])
    for k in range(2):
        q = fb._affine_query(g0, g1, u, cfg.A[k], cfg.B[k])
        want = (cfg.A[k][0] * s_r[:, None, None] + cfg.A[k][1]
                * s_r[None, :, None] + cfg.B[k] * u.permute(1, 2, 0))
        assert torch.equal(q.permute(1, 2, 0), want)
    lo0 = p.plan.lo[0].expand(p.plan.query_shape).permute(2, 0, 1)
    assert lo0.shape == (cfg.du, cfg.dx, cfg.dx)


# --- the kernel's algorithm in numpy float32 --------------------------------

def _search(g, q):
    """The kernel's locate(): binary search for the count of !(g > q)."""
    n = len(g)
    lo = np.zeros(q.shape, np.int64)
    hi = np.full(q.shape, n, np.int64)
    while (lo < hi).any():
        act = lo < hi
        mid = (lo + hi) >> 1
        right = act & ~(g[np.minimum(mid, n - 1)] > q)
        lo = np.where(right, mid + 1, lo)
        hi = np.where(act & ~right, mid, hi)
    return np.clip(lo - 1, 0, n - 2)


def _walk(g, lo, q):
    """The kernel's walk(): move each lo up, then down, to q's cell."""
    n = len(g)
    while True:
        up = (lo < n - 2) & ~(g[np.minimum(lo + 1, n - 1)] > q)
        if not up.any():
            break
        lo = lo + up
    while True:
        down = (lo > 0) & (g[lo] > q)
        if not down.any():
            break
        lo = lo - down
    return lo


def _chunk_slots(args, k):
    """The action each slot of chunk ``k``'s shared records holds, as the
    chunked kernels stage them (-1: a slot no action fills)."""
    per, chunk = args.actions_per_split, args.chunk
    slots = np.full(args.n_splits * chunk, -1, np.int64)
    for i in range(args.n_splits * chunk):
        sp = i // chunk
        j = k * chunk + i - sp * chunk
        a = sp * per + j
        if j < per and a < args.n_actions:
            slots[i] = a
    return slots


def _kernel_model(values, args):
    """affine_sweep of csrc/fused_backup2d.cu, all cells at once: each split
    binary-searches its first query, walks lo from action to action, reads
    the four corners in its block's staged rows (or in the table) and keeps
    the first strict minimum; the splits combine in order. Asserts every
    located cell against searchsorted, every read against the staged rows
    and, when the records are staged in chunks, every record slot read
    against its action. Returns (values, argmin, number of walk steps)."""
    g = [np.asarray(a, np.float32) for a in args.axes]
    n0, n1 = len(g[0]), len(g[1])
    a_m = np.float32(args.A)
    b_v = np.float32(args.B)
    u = args.u
    s_cost = args.state_cost.numpy()
    a_cost = args.action_cost.numpy()
    tab = values.numpy().reshape(-1)
    cell = np.arange(n0 * n1)
    x0, x1 = g[0][cell // n1], g[1][cell % n1]
    base = [a_m[k, 0] * x0 + a_m[k, 1] * x1 for k in range(2)]
    blk = cell // args.cells_per_block
    row0 = args.row0.numpy()[blk]
    last_row = row0 + args.n_rows.numpy()[blk] - 1
    best_v = np.full(cell.shape, np.inf, np.float32)
    best_a = np.zeros(cell.shape, np.int64)
    steps = 0
    chunked = args.stage != fb.STAGE_ALL
    slots = {}
    for s in range(args.n_splits):
        a0 = s * args.actions_per_split
        a1 = min(a0 + args.actions_per_split, args.n_actions)
        sv = np.full(cell.shape, np.inf, np.float32)
        sa = np.full(cell.shape, a0, np.int64)
        lo = [None, None]
        for a in range(a0, a1):
            if chunked:        # the record this thread reads: its chunk slot
                k, j = divmod(a - a0, args.chunk)
                if k not in slots:
                    slots[k] = _chunk_slots(args, k)
                assert slots[k][s * args.chunk + j] == a
            q = [base[k] + b_v[k] * u[a] for k in range(2)]
            for k in range(2):
                if a == a0:
                    lo[k] = _search(g[k], q[k])
                else:
                    new = _walk(g[k], lo[k], q[k])
                    steps += int(np.abs(new - lo[k]).sum())
                    lo[k] = new
                want = np.clip(np.searchsorted(g[k], q[k], side="right") - 1,
                               0, len(g[k]) - 2)
                np.testing.assert_array_equal(lo[k], want)
            if args.stage != fb.TABLE_GLOBAL:
                assert (lo[0] >= row0).all() and \
                    (lo[0] + 1 <= last_row).all()
            f = [(q[k] - g[k][lo[k]]) / (g[k][lo[k] + 1] - g[k][lo[k]])
                 for k in range(2)]
            h = [np.float32(1.0) - f[k] for k in range(2)]
            c = lo[0] * n1 + lo[1]
            t = (h[0] * h[1]) * tab[c]
            t = t + (h[0] * f[1]) * tab[c + 1]
            t = t + (f[0] * h[1]) * tab[c + n1]
            t = t + (f[0] * f[1]) * tab[c + n1 + 1]
            t = t + (s_cost + a_cost[a])
            better = t < sv
            sv = np.where(better, t, sv)
            sa = np.where(better, a, sa)
        take = sv < best_v
        best_v = np.where(take, sv, best_v)
        best_a = np.where(take, sa, best_a)
    return best_v.reshape(n0, n1), best_a.reshape(n0, n1), steps


@pytest.mark.parametrize("shape", [(16, 16), (7, 5), (1, 40)],
                         ids=["default", "ragged", "one_cell_blocks"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_algorithm_equals_plain(name, shape, monkeypatch):
    cfg = CONFIGS[name]
    s_c, a_c = kirk._separable_cost_terms(cfg, device="cpu")
    s_r, u = kirk._meshes(cfg)
    monkeypatch.setattr(fb, "CELLS_PER_BLOCK", shape[0])
    monkeypatch.setattr(fb, "SPLITS", shape[1])
    bk = fb.AffineBackup2D((s_r, s_r), u, cfg.A, cfg.B, s_c, a_c)
    v = _values(7, cfg.dx)
    mv, ma, steps = _kernel_model(v, bk.args)
    want = fb.fused_backup2d_affine_plain(v, bk.args)
    assert np.array_equal(mv, want.values.numpy())
    assert np.array_equal(ma, want.argmin.numpy())
    assert steps > 0 or bk.args.actions_per_split == 1


def test_kernel_algorithm_on_unsorted_controls_with_exact_ties(monkeypatch):
    """Controls listed forwards then backwards: every query repeats, so
    every minimum ties exactly and the first copy must win; the walk jumps
    back across the grid at the turn."""
    cfg = CONFIGS["extrapolating"]
    s_c, a_c = kirk._separable_cost_terms(cfg, device="cpu")
    s_r, u = kirk._meshes(cfg)
    u2 = np.concatenate([u, u[::-1]])
    a_c2 = torch.cat([a_c, a_c.flip(0)])
    for splits in (3, 32):
        monkeypatch.setattr(fb, "SPLITS", splits)
        bk = fb.AffineBackup2D((s_r, s_r), u2, cfg.A, cfg.B, s_c, a_c2)
        v = _values(8, cfg.dx)
        mv, ma, _ = _kernel_model(v, bk.args)
        want = bk(v)
        assert np.array_equal(mv, want.values.numpy())
        assert np.array_equal(ma, want.argmin.numpy())
        assert int(want.argmin.max()) < len(u)


def _forced_stage(cfg, stage, cells, splits, monkeypatch):
    """``cfg``'s affine backup of ``cells`` x ``splits`` with chunks of 3
    actions, under a shared memory limit of exactly ``stage``'s need, so
    that it takes that stage (each stage needs less than the one before)."""
    monkeypatch.setattr(fb, "CELLS_PER_BLOCK", cells)
    monkeypatch.setattr(fb, "SPLITS", splits)
    monkeypatch.setattr(fb, "CHUNK_ACTIONS", 3)
    s_c, a_c = kirk._separable_cost_terms(cfg, device="cpu")
    s_r, u = kirk._meshes(cfg)

    def backup():
        return fb.AffineBackup2D((s_r, s_r), u, cfg.A, cfg.B, s_c, a_c)

    a = backup().args
    need = fb._smem_bytes(a.grid_shape, a.n_actions, a.max_rows, cells,
                          a.n_splits, stage, min(3, a.actions_per_split))
    monkeypatch.setattr(fb, "SMEM_LIMIT_BYTES", need)
    return backup().args


@pytest.mark.parametrize("stage", ["all", "chunks", "global"])
@pytest.mark.parametrize("name", ["extrapolating", "negative_B", "zero_B1"])
def test_kernel_algorithm_in_each_stage(name, stage, monkeypatch):
    """The three stages of the kernel (every record staged; records staged
    in chunks, here of 3 actions of 10 a split, the last chunk ragged; the
    table read from global memory) run one algorithm: the same sweep as the
    plain version, bitwise, and every action's record staged exactly once
    over the chunks."""
    want_stage = {"all": fb.STAGE_ALL, "chunks": fb.STAGE_CHUNKS,
                  "global": fb.TABLE_GLOBAL}[stage]
    cfg = CONFIGS[name]
    args = _forced_stage(cfg, want_stage, 16, 4, monkeypatch)
    assert args.stage == want_stage
    assert args.smem_bytes <= fb.SMEM_LIMIT_BYTES
    assert args.actions_per_split == 10
    if want_stage != fb.STAGE_ALL:
        assert args.chunk == 3
        staged = np.concatenate([_chunk_slots(args, k) for k in range(4)])
        assert sorted(staged[staged >= 0]) == list(range(cfg.du))
    v = _values(12, cfg.dx)
    mv, ma, _ = _kernel_model(v, args)
    want = fb.fused_backup2d_affine_plain(v, args)
    assert np.array_equal(mv, want.values.numpy())
    assert np.array_equal(ma, want.argmin.numpy())


def test_stage_needs_shrink_and_global_always_fits(monkeypatch):
    """Each stage asks for less shared memory than the one before it; the
    table-from-global stage cuts its chunk until the records fit beside
    the split minima, so even 512 one-action splits of one cell fit."""
    cfg = CONFIGS["negative_B"]
    needs = []
    for stage in (fb.STAGE_ALL, fb.STAGE_CHUNKS, fb.TABLE_GLOBAL):
        args = _forced_stage(cfg, stage, 16, 4, monkeypatch)
        assert args.stage == stage
        needs.append(args.smem_bytes)
    assert needs[0] > needs[1] > needs[2]
    monkeypatch.setattr(fb, "SMEM_LIMIT_BYTES", 232_448)
    monkeypatch.setattr(fb, "CHUNK_ACTIONS", 32)
    monkeypatch.setattr(fb, "CELLS_PER_BLOCK", 1)
    monkeypatch.setattr(fb, "SPLITS", 512)
    big = np.linspace(-1.0, 1.0, 300).astype(np.float32)
    u = np.linspace(-40.0, 10.0, 512 * 40).astype(np.float32)
    args = fb.AffineBackup2D(
        (big, big), u, cfg.A, (2.0, 0.0539), torch.zeros(300, 300),
        torch.zeros(u.size)).args
    assert args.stage == fb.TABLE_GLOBAL and args.n_splits == 512
    assert 1 <= args.chunk < 32 and args.smem_bytes <= 232_448
    assert fb._smem_bytes(args.grid_shape, args.n_actions, args.max_rows, 1,
                          512, fb.TABLE_GLOBAL, args.chunk + 1) > 232_448


@pytest.mark.parametrize("cells", [1, 16, 33])
@pytest.mark.parametrize("name", ["golden", "extrapolating", "negative_B"])
def test_planned_rows_are_the_rows_read(name, cells):
    """plan_rows, from the controls' extremes, equals the least and the
    greatest axis-0 cell (plus one) that kirk.build's full plan reads in
    each block: it covers every read and stages nothing more."""
    cfg = CONFIGS[name]
    s_r, u = kirk._meshes(cfg)
    row0, n_rows = fb.plan_rows((s_r, s_r), u, cfg.A, cfg.B, cells)
    lo0 = kirk.build(cfg, device="cpu").plan.lo[0] \
        .expand(cfg.dx, cfg.dx, cfg.du).reshape(cfg.dx * cfg.dx, cfg.du) \
        .to(torch.int64)
    n_blocks = -(-cfg.dx * cfg.dx // cells)
    assert row0.shape == n_rows.shape == (n_blocks,)
    for b in range(n_blocks):
        blk = lo0[b * cells:(b + 1) * cells]
        assert int(row0[b]) == int(blk.min())
        assert int(row0[b] + n_rows[b]) == int(blk.max()) + 2


def test_whole_table_staging_is_the_same_sweep():
    """The kernel reads the table only through its block's row plan: with
    every block staging the whole table the algorithm gives the same
    sweep."""
    cfg = CONFIGS["negative_B"]
    args = kirk.affine_backup(cfg, "cpu").args
    whole = dataclasses.replace(args, row0=torch.zeros_like(args.row0),
                                n_rows=torch.full_like(args.n_rows, cfg.dx),
                                max_rows=cfg.dx)
    v = _values(9, cfg.dx)
    want = fb.fused_backup2d_affine_plain(v, args)
    for a in (args, whole):
        mv, ma, _ = _kernel_model(v, a)
        assert np.array_equal(mv, want.values.numpy())
        assert np.array_equal(ma, want.argmin.numpy())


# --- the engines --------------------------------------------------------------

@pytest.fixture(scope="module")
def gather_golden():
    return kirk.solve(GOLDEN, device="cpu", impl="gather").result


def test_policy_store_through_sweep_into_equals_gather(gather_golden):
    """store_policies: each sweep's argmin written straight into its uint8
    policy slot (golden has 100 actions), values ping-ponged."""
    bk = kirk.affine_backup(GOLDEN, "cpu")
    shape = PlanShape((GOLDEN.dx,) * 2, (GOLDEN.dx,) * 2 + (GOLDEN.du,),
                      torch.device("cpu"))
    seen = []
    res = value_iteration_finite(shape, None, GOLDEN.N - 1,
                                 store_policies=True, backup=bk,
                                 on_sweep=seen.append)
    assert res.policies.dtype == torch.uint8
    assert torch.equal(res.values, gather_golden.values)
    assert torch.equal(res.policies, gather_golden.policies)
    assert torch.equal(res.argmin, gather_golden.argmin)
    assert res.argmin.dtype == torch.int32
    assert seen == list(range(GOLDEN.N - 1))


def test_graph_schedule_eager_twin_equals_gather(gather_golden):
    """store_policies=False with a graph-safe backup takes the graph
    engine's schedule (100 sweeps, then 28), run eagerly on the CPU."""
    bk = kirk.affine_backup(GOLDEN, "cpu")
    assert bk.graph_safe and bk.launcher is fb.fused_backup2d_affine_cuda
    shape = PlanShape((GOLDEN.dx,) * 2, (GOLDEN.dx,) * 2 + (GOLDEN.du,),
                      torch.device("cpu"))
    init = torch.zeros((GOLDEN.dx,) * 2)
    res = value_iteration_finite(shape, None, GOLDEN.N - 1, backup=bk,
                                 init_values=init,
                                 narrow_argmin_result=True)
    assert not bool(init.any())
    assert torch.equal(res.values, gather_golden.values)
    assert torch.equal(res.argmin, gather_golden.argmin.to(torch.uint8))


def test_probes_and_int32_policies_through_sweep_into():
    cfg = CONFIGS["negative_B"]
    p = kirk.build(cfg, device="cpu")
    bk = kirk.affine_backup(cfg, "cpu")
    init = _values(10, cfg.dx)
    kw = dict(init_values=init, store_policies=True,
              policy_dtype=torch.int32, probe_window=((2, 3), (4, 5)))
    got = value_iteration_finite(p.plan, p.stage_cost, 5, backup=bk, **kw)
    want = value_iteration_finite(p.plan, p.stage_cost, 5, **kw)
    assert torch.equal(init, _values(10, cfg.dx))       # never written
    for a, b in zip((got.values, got.policies, got.probes, got.argmin),
                    (want.values, want.policies, want.probes, want.argmin)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_kirk_solve_routes_and_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        kirk.solve(SMALL, device="cpu", impl="kernel")
    for impl in ("streamed", "plan"):
        with pytest.raises(ValueError, match="unknown impl"):
            kirk.solve(SMALL, device="cpu", impl=impl)


def test_affine_backup_from_a_problem_or_a_config():
    cfg = CONFIGS["zero_B0"]
    p = kirk.build(cfg, device="cpu")
    a, b = (kirk.affine_backup(x, "cpu").args for x in (p, cfg))
    assert a.A == b.A == cfg.A and a.B == b.B == cfg.B
    for x, y in ((a.g0, b.g0), (a.u_t, b.u_t), (a.state_cost, b.state_cost),
                 (a.action_cost, b.action_cost), (a.row0, b.row0)):
        assert torch.equal(x, y)
    assert kirk.affine_backup(p).args.device.type == "cpu"


# --- what the affine mode refuses ---------------------------------------------

def _affine_kw(**over):
    cfg = SMALL
    s_c, a_c = kirk._separable_cost_terms(cfg, device="cpu")
    s_r, u = kirk._meshes(cfg)
    kw = dict(axes=(s_r, s_r), u=u, A=cfg.A, B=cfg.B, state_cost=s_c,
              action_cost=a_c)
    kw.update(over)
    return kw


@pytest.mark.parametrize("over,match", [
    (dict(axes=(np.zeros(12, np.float32),) * 2), "ascending"),
    (dict(axes=(np.linspace(0, 1, 12),)), "2-D"),
    (dict(u=np.full(40, np.nan, np.float32)), "finite"),
    (dict(A=((1.0, 0.0),)), "2 x 2"),
    (dict(B=(1e39, 0.0)), "finite in f32"),
    (dict(state_cost=torch.zeros(11, 12)), "cost shapes"),
    (dict(action_cost=torch.zeros(39)), "cost shapes"),
    (dict(state_cost=np.zeros((12, 12), np.float32)), "tensors"),
    (dict(CELLS_PER_BLOCK=64, SPLITS=40), "threads"),
    (dict(CELLS_PER_BLOCK=0), ">= 1"),
    (dict(A=((1e37, 0.0), (0.0, 1.0))), "overflow"),
    (dict(u=np.zeros((2, 20), np.float32)), "1-D"),
], ids=["flat_axis", "one_axis", "nan_controls", "A_shape", "B_overflow",
        "state_cost", "action_cost", "numpy_cost", "threads", "empty_block",
        "query_overflow", "controls_2d"])
def test_affine_rejects_what_it_cannot_take(over, match, monkeypatch):
    over = dict(over)
    for name in ("CELLS_PER_BLOCK", "SPLITS"):
        if name in over:
            monkeypatch.setattr(fb, name, over.pop(name))
    with pytest.raises(ValueError, match=match):
        fb.AffineBackup2D(**_affine_kw(**over))


def test_affine_rejects_a_table_past_shared_memory():
    """300-point rows: a block whose queries reach 3 rows stages them; one
    whose controls sweep axis 0 end to end (all 300 rows, 360 KB) is no
    longer refused: its blocks read the table from global memory, and the
    kernel's algorithm gives the plain version's sweep."""
    big = np.linspace(-1.0, 1.0, 300).astype(np.float32)
    u = np.linspace(-1.0, 1.0, 3).astype(np.float32)
    kw = dict(axes=(big, big), u=u, A=((1.0, 0.0), (0.0, 1.0)),
              state_cost=torch.zeros(300, 300), action_cost=torch.zeros(3))
    near = fb.AffineBackup2D(**kw, B=(0.0, 0.0)).args
    assert near.max_rows == 3 and near.stage == fb.STAGE_ALL
    far = fb.AffineBackup2D(**kw, B=(2.0, 0.0)).args
    assert far.max_rows == 300 and far.stage == fb.TABLE_GLOBAL
    assert far.smem_bytes <= fb.SMEM_LIMIT_BYTES
    v = _values(13, 300)
    mv, ma, _ = _kernel_model(v, far)
    want = fb.fused_backup2d_affine_plain(v, far)
    assert np.array_equal(mv, want.values.numpy())
    assert np.array_equal(ma, want.argmin.numpy())


def test_affine_wrapper_never_computes_on_the_cpu():
    bk = kirk.affine_backup(SMALL, "cpu")
    v = _values(11, SMALL.dx)
    before = fb.fused_backup2d_affine_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_backup2d_affine_cuda(v, bk.args)
    with pytest.raises(ValueError, match="CUDA"):
        fb.fused_backup2d_affine_cuda(v, bk.args, torch.empty_like(v),
                                      torch.empty(v.shape, dtype=torch.int16))
    assert fb.fused_backup2d_affine_cuda.launches == before
    bk.prepare()                                   # nothing to build here
    streamed = _streamed(SMALL, kirk.build(SMALL, device="cpu"))
    assert not getattr(streamed, "graph_safe", False)
    assert not hasattr(streamed, "sweep_into")
