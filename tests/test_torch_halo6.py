"""Port row-sharded 6-D engines (ocdp_tpu_torch/parallel/halo6.py) and the
plain version of kernel B.7 (ops/backup6d.py), on the CPU.

* B.7's row-block mode, on a local table of ``lo + rows + hi`` rows, equals
  the one-device sweep's rows bitwise on every plan kind (broadcast, flat,
  recompute) and argmin mode; its digit slices, combined by the first
  minimum, equal the one-device sweep bitwise; 3-action groups (the generic
  phase) agree within rtol 1e-6 / atol 1e-4 (an ulp of the totals).
* The engines over an in-process mesh and over a 3-rank gloo group equal
  the one-device :class:`Backup6D` solve bitwise (values, argmin, policies),
  converged ones with the same stop sweep and check logs within rtol 1e-6
  (the blocks' float32 sums add in another order).
* 27 actions over 3 groups take the digit path, visibly (the JAX engine
  falls back to the generic order without a word, ``halo6.py:120-137``);
  9 groups do not.
* A 2-rank solve at 5^3 x 4^3 against the JAX single-device solve
  (``impl='gather'``, whose XLA compile is half the Pallas interpret
  mode's): rtol 1e-5, atol 1e-4, argmins equal (tests/test_torch_attitude.
  py:76's bounds, which it also holds between the port and the gather).
* The guards: halo width, carry mode, indivisible actions.
"""

import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ocdp_tpu_torch.engine import (value_iteration_converged,
                                   value_iteration_finite)
from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.ops import backup6d as b6
from ocdp_tpu_torch.parallel import (LocalMesh, halo_bytes, mesh_halo_bytes,
                                     value_iteration_converged_halo6,
                                     value_iteration_finite_halo6)
from ocdp_tpu_torch.parallel.halo6 import Halo6Backup
from ocdp_tpu_torch.parallel.mesh import first_min

torch.set_num_threads(2)

SMALL = dict(n_mesh_w=5, n_mesh_q=4)
KINDS = {"broadcast": {}, "flat": {"flat": True},
         "recompute": {"lane_mode": "recompute"}}
MODES = {"int32": (torch.int32, True), "uint8": (torch.uint8, True),
         "min-only": (torch.uint8, False)}


def _problem(kind="broadcast", **cfg):
    cfg = dict(SMALL, **cfg)
    return tatt.build_full(tatt.AttitudeConfig(**cfg), device="cpu",
                           **KINDS[kind])


@pytest.fixture(scope="module")
def small():
    _, plan, cost = _problem()
    bk = b6.Backup6D(plan, cost)
    return plan, cost, bk


def _table(bk, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.0, 100.0, (bk.NW, bk.NE))
                            .astype(np.float32))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", list(KINDS))
def test_block_plain_equals_full_sweep(kind, mode):
    _, plan, cost = _problem(kind)
    dt, track = MODES[mode]
    bk = b6.Backup6D(plan, cost, argmin_dtype=dt, track_argmin=track)
    v = _table(bk)
    full = b6.backup6d_plain(v, bk.args)
    lo, hi = bk.row_reach()
    assert (lo, hi) == (31, 31)          # 5^2 + 5 + 1 rows each way
    vp = torch.nn.functional.pad(v, (0, 0, lo, hi))
    for r0, r1 in ((0, 63), (63, 125), (40, 80)):
        args = b6.block_args(bk.args, r0, r1, lo, hi)
        got = b6.backup6d_plain(vp[r0:r1 + lo + hi], args)
        assert torch.equal(got.values, full.values[r0:r1])
        assert torch.equal(got.argmin, full.argmin[r0:r1])


@pytest.mark.parametrize("kind", list(KINDS))
def test_digit_slices_combine_to_full_sweep(kind):
    _, plan, cost = _problem(kind)
    bk = b6.Backup6D(plan, cost)
    assert bk.action_digits == 3
    v = _table(bk, 1)
    full = b6.backup6d_plain(v, bk.args)
    vals, args = [], []
    for g in range(3):
        assert b6.digit_path(bk.args, 9 * g, 9 * g + 9)
        sa = b6.slice_args(bk.args, 9 * g, 9 * g + 9)
        assert sa.action_digits == 3
        res = b6.backup6d_plain(v, sa)
        assert int(res.argmin.min()) >= 9 * g and \
            int(res.argmin.max()) < 9 * g + 9
        vals.append(res.values)
        args.append(res.argmin)
    vmin, arg = first_min(vals, args, 27)
    assert torch.equal(vmin, full.values)
    assert torch.equal(arg, full.argmin)


@pytest.mark.parametrize("kind", list(KINDS))
def test_block_digit_slices_combine_to_the_block(kind):
    """Each rank of a rows x 3 mesh: its block's 3 digit slices, combined
    by the first minimum, equal the block's whole sweep bitwise."""
    _, plan, cost = _problem(kind)
    bk = b6.Backup6D(plan, cost)
    v = _table(bk, 4)
    full = b6.backup6d_plain(v, bk.args)
    lo, hi = bk.row_reach()
    vp = torch.nn.functional.pad(v, (0, 0, lo, hi))
    for r0, r1 in ((0, 63), (63, 125)):
        args = b6.block_args(bk.args, r0, r1, lo, hi)
        local = vp[r0:r1 + lo + hi]
        vals, argm = [], []
        for g in range(3):
            sa = b6.slice_args(args, 9 * g, 9 * g + 9)
            assert sa.action_digits == 3 and sa.halo == (lo, hi)
            res = b6.backup6d_plain(local, sa)
            vals.append(res.values)
            argm.append(res.argmin)
        vmin, arg = first_min(vals, argm, 27)
        assert torch.equal(vmin, full.values[r0:r1])
        assert torch.equal(arg, full.argmin[r0:r1])


def test_generic_groups_agree_within_an_ulp(small):
    _, _, bk = small
    v = _table(bk, 2)
    full = b6.backup6d_plain(v, bk.args)
    vals, args = [], []
    for g in range(9):
        assert not b6.digit_path(bk.args, 3 * g, 3 * g + 3)
        sa = b6.slice_args(bk.args, 3 * g, 3 * g + 3)
        assert sa.action_digits is None
        res = b6.backup6d_plain(v, sa)
        vals.append(res.values)
        args.append(res.argmin)
    vmin, arg = first_min(vals, args, 27)
    np.testing.assert_allclose(vmin.numpy(), full.values.numpy(), rtol=1e-6,
                               atol=1e-4)
    assert (arg == full.argmin).float().mean() >= 0.999


def test_exact_ties_take_the_first_action():
    _, plan, cost = _problem(h=0.0)
    bk = b6.Backup6D(plan, [torch.zeros_like(t) for t in cost])
    v = _table(bk, 3)
    vals, args = [], []
    for g in range(3):
        res = b6.backup6d_plain(v, b6.slice_args(bk.args, 9 * g, 9 * g + 9))
        assert torch.equal(res.argmin, torch.full_like(res.argmin, 9 * g))
        vals.append(res.values)
        args.append(res.argmin)
    _, arg = first_min(vals, args, 27)
    assert int(arg.max()) == 0


def test_slice_args_refuse_a_bad_range(small):
    _, _, bk = small
    with pytest.raises(ValueError, match="actions"):
        b6.slice_args(bk.args, 9, 9)
    with pytest.raises(ValueError, match="rows"):
        b6.block_args(bk.args, 10, 200, 31, 31)


@pytest.mark.parametrize("sizes", [(2,), (3,), (4,), (2, 3)],
                         ids=["2", "3", "4", "2x3"])
def test_local_mesh_finite_bitwise(small, sizes):
    plan, cost, bk = small
    ref = value_iteration_finite(plan, cost, 4, backup=bk,
                                 store_policies=True)
    names = ("s", "a")[:len(sizes)]
    mesh = LocalMesh(names, sizes, device="cpu")
    got = value_iteration_finite_halo6(
        plan, cost, 4, mesh, store_policies=True,
        action_axis_name="a" if len(sizes) == 2 else None)
    assert torch.equal(got.values, ref.values)
    assert torch.equal(got.argmin, ref.argmin)
    assert got.argmin.dtype == torch.int32
    assert got.policies.dtype == torch.uint8      # 27 actions -> narrow
    assert torch.equal(got.policies, ref.policies)


@pytest.mark.parametrize("kind", ["flat", "recompute"])
def test_flat_and_recompute_plans_bitwise(kind):
    _, plan, cost = _problem(kind)
    bk = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8)
    ref = value_iteration_finite(plan, cost, 3, backup=bk)
    mesh = LocalMesh(("s",), (2,), device="cpu")
    got = value_iteration_finite_halo6(plan, cost, 3, mesh,
                                       argmin_dtype=torch.uint8)
    assert torch.equal(got.values.reshape(-1), ref.values.reshape(-1))
    assert torch.equal(got.argmin.reshape(-1),
                       ref.argmin.to(torch.int32).reshape(-1))


def test_init_values_carry_over(small):
    plan, cost, bk = small
    v0 = _table(bk, 4).reshape(bk.state_shape)
    ref = value_iteration_finite(plan, cost, 2, backup=bk, init_values=v0)
    got = value_iteration_finite_halo6(plan, cost, 2,
                                       LocalMesh(("s",), (2,), device="cpu"),
                                       init_values=v0)
    assert torch.equal(got.values, ref.values)


@pytest.mark.parametrize("sizes", [(2,), (2, 3)], ids=["2", "2x3"])
def test_converged_matches_single_device(small, sizes):
    plan, cost, bk = small
    ref = value_iteration_converged(plan, cost, 12, check_every=3, tol=1e12,
                                    backup=bk)
    calls = []
    mesh = LocalMesh(("s", "a")[:len(sizes)], sizes, device="cpu")
    got = value_iteration_converged_halo6(
        plan, cost, 12, mesh, check_every=3, tol=1e12,
        action_axis_name="a" if len(sizes) == 2 else None,
        on_check=lambda *a: calls.append(a))
    # a huge tol stops both at the first check (k_s = 12, after 1 sweep)
    assert ref.converged and got.converged
    assert got.num_sweeps == ref.num_sweeps == 1
    assert len(calls) == 1 and calls[0][0] == 12
    assert torch.equal(got.values, ref.values)
    assert torch.equal(got.argmin, ref.argmin)
    np.testing.assert_allclose(got.checks.numpy(), ref.checks.numpy(),
                               rtol=1e-6)


def test_converged_runs_to_cap_without_stop(small):
    plan, cost, _ = small
    mesh = LocalMesh(("s",), (2,), device="cpu")
    fin = value_iteration_finite_halo6(plan, cost, 6, mesh)
    calls = []
    got = value_iteration_converged_halo6(plan, cost, 6, mesh, check_every=2,
                                          tol=0.0,
                                          on_check=lambda *a: calls.append(a))
    assert not got.converged and got.num_sweeps == 6
    assert [c[0] for c in calls] == [6, 4, 2]       # once per check
    assert torch.equal(got.values, fin.values)
    assert torch.equal(got.argmin, fin.argmin)


def test_digit_path_taken_at_27_actions_over_3_groups(small):
    plan, cost, bk = small
    mesh = LocalMesh(("s", "a"), (2, 3), device="cpu")
    hb = Halo6Backup(plan, cost, mesh, action_axis_name="a")
    assert hb.digit_path is True
    assert all(a.action_digits == 3 for a in hb.args)
    ref = value_iteration_finite(plan, cost, 3, backup=bk)
    got = value_iteration_finite_halo6(plan, cost, 3, mesh,
                                       action_axis_name="a")
    assert got.digit_path is True
    # the generic phase would be an ulp off (test above): bitwise means
    # the factorized phase ran
    assert torch.equal(got.values, ref.values)
    mesh9 = LocalMesh(("s", "a"), (1, 9), device="cpu")
    hb9 = Halo6Backup(plan, cost, mesh9, action_axis_name="a")
    assert hb9.digit_path is False
    assert all(a.action_digits is None for a in hb9.args)
    got9 = value_iteration_finite_halo6(plan, cost, 1, mesh9,
                                        action_axis_name="a")
    assert got9.digit_path is False
    assert value_iteration_finite_halo6(plan, cost, 1, mesh).digit_path \
        is None


def test_width_guard(small):
    """A reach past the immediate neighbor raises instead of corrupting."""
    plan, cost, _ = small
    with pytest.raises(ValueError, match="halo widths"):
        value_iteration_finite_halo6(plan, cost, 2,
                                     LocalMesh(("s",), (5,), device="cpu"))


def test_action_axis_indivisible_rejected(small):
    plan, cost, _ = small
    mesh = LocalMesh(("s", "a"), (2, 4), device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        value_iteration_finite_halo6(plan, cost, 2, mesh,
                                     action_axis_name="a")


def test_rejects_carry_padded(small):
    plan, cost, _ = small
    with pytest.raises(ValueError, match="carry_padded"):
        value_iteration_finite_halo6(plan, cost, 2,
                                     LocalMesh(("s",), (2,), device="cpu"),
                                     carry_padded=True)


def test_rank_residency_below_the_whole_table():
    """The reason for the engine: each of 4 ranks holds its block, two halo
    slabs and two tables, less than the one-device table pair at 9^3 x
    7^3 (the halo is ~10% of a block here; at envelope heights ~1%)."""
    _, plan, cost = _problem(n_mesh_w=9, n_mesh_q=7)
    mesh = LocalMesh(("s",), (4,), device="cpu")
    hb = Halo6Backup(plan, cost, mesh)
    nw, ne = hb.backup.NW, hb.backup.NE
    per_rank = max((hb.lo + (r1 - r0) + hb.hi) * ne * 4 * 2
                   for r0, r1 in hb.blocks)
    assert per_rank < 0.6 * nw * ne * 4 * 2


def test_halo_bytes_counted_equal_analytic(small):
    plan, cost, bk = small
    mesh = LocalMesh(("s",), (4,), device="cpu")
    value_iteration_finite_halo6(plan, cost, 3, mesh)
    lo, hi = bk.row_reach()
    assert mesh.halo_bytes == 3 * mesh_halo_bytes(4, lo, hi, bk.NE)
    assert mesh_halo_bytes(4, lo, hi, bk.NE) == 3 * halo_bytes(lo, hi,
                                                               bk.NE)


def test_two_ranks_match_jax_single_device():
    from ocdp_tpu.models import attitude as jatt

    jsol = jatt.solve_full(jatt.AttitudeConfig(**SMALL), num_sweeps=5,
                           impl="gather")
    _, plan, cost = _problem()
    got = value_iteration_finite_halo6(plan, cost, 5,
                                       LocalMesh(("s",), (2,), device="cpu"))
    np.testing.assert_allclose(got.values.numpy(),
                               np.asarray(jsol.result.values), rtol=1e-5,
                               atol=1e-4)
    assert (got.argmin.numpy() == np.asarray(jsol.result.argmin)).mean() \
        == 1.0


def test_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalMesh(("s",), (2,))


# ---- a 3-rank gloo group, spawned once for this file ----------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    from ocdp_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(f"localhost:{port}", world, rank, backend="gloo")
    _, plan, cost = _problem()
    out = {}
    mesh3 = make_mesh(("s",), device="cpu")             # all 3 ranks
    res = value_iteration_finite_halo6(plan, cost, 4, mesh3,
                                       store_policies=True)
    out["1d-3"] = (res.values, res.argmin, res.policies)
    out["halo_bytes"] = mesh3.halo_bytes
    mesh2 = make_mesh(("s",), (2,), device="cpu")       # ranks 0 and 1
    out["member2"] = mesh2.is_member
    if mesh2.is_member:
        res = value_iteration_finite_halo6(plan, cost, 4, mesh2)
        out["1d-2"] = (res.values, res.argmin)
    mesh13 = make_mesh(("s", "a"), (1, 3), device="cpu")
    res = value_iteration_finite_halo6(plan, cost, 4, mesh13,
                                       action_axis_name="a")
    out["digit_path"] = res.digit_path
    out["2d-1x3"] = (res.values, res.argmin)
    calls = []
    res = value_iteration_converged_halo6(plan, cost, 6, mesh3,
                                          check_every=2, tol=0.0,
                                          on_check=lambda *a: calls.append(a))
    out["converged"] = (res.values, res.argmin, res.checks, res.num_sweeps)
    out["calls"] = calls
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gloo_halo6"))
    mp.spawn(_gloo_worker, args=(3, _free_port(), out), nprocs=3, join=True)
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(3)]


@pytest.mark.parametrize("case", ["1d-3", "1d-2", "2d-1x3"])
def test_gloo_finite_bitwise(gloo, small, case):
    plan, cost, bk = small
    ref = value_iteration_finite(plan, cost, 4, backup=bk,
                                 store_policies=True)
    ranks = [0, 1] if case == "1d-2" else [0, 1, 2]
    for r in ranks:
        got = gloo[r][case]
        assert torch.equal(got[0], ref.values)
        assert torch.equal(got[1], ref.argmin)
        if case == "1d-3":
            assert torch.equal(got[2], ref.policies)
    assert gloo[2]["member2"] is False and "1d-2" not in gloo[2]
    assert all(g["digit_path"] is True for g in gloo)


def test_gloo_converged_and_checks(gloo, small):
    plan, cost, bk = small
    ref = value_iteration_converged(plan, cost, 6, check_every=2, tol=0.0,
                                    backup=bk)
    local = value_iteration_converged_halo6(
        plan, cost, 6, LocalMesh(("s",), (3,), device="cpu"),
        check_every=2, tol=0.0)
    for g in gloo:
        values, argmin, checks, n = g["converged"]
        assert n == 6
        assert torch.equal(values, ref.values)
        assert torch.equal(argmin, ref.argmin)
        # both communicators add the block sums in rank order: same bits
        assert torch.equal(checks, local.checks)
        np.testing.assert_allclose(checks.numpy(), ref.checks.numpy(),
                                   rtol=1e-6)
    # on_check fires on rank 0 only, once per check
    assert [c[0] for c in gloo[0]["calls"]] == [6, 4, 2]
    assert gloo[1]["calls"] == [] and gloo[2]["calls"] == []


def test_gloo_halo_bytes_equal_local_mesh(gloo, small):
    plan, cost, bk = small
    mesh = LocalMesh(("s",), (3,), device="cpu")
    value_iteration_finite_halo6(plan, cost, 4, mesh)
    lo, hi = bk.row_reach()
    per_rank = [g["halo_bytes"] for g in gloo]
    assert sum(per_rank) == mesh.halo_bytes == \
        4 * mesh_halo_bytes(3, lo, hi, bk.NE)
    assert per_rank[1] == 4 * halo_bytes(lo, hi, bk.NE)   # both neighbors
