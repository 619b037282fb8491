"""Port replicated-table engines (ocdp_tpu_torch/parallel/sharded.py), the
mesh helpers (parallel/mesh.py, parallel/multihost.py) and the dryrun twin
(parallel/dryrun.py), on the CPU.

* State and state x action sharding over an in-process mesh and over a
  2-rank gloo group equal the one-device gather solve bitwise (values,
  argmin, policies), including the padding paths (17 rows over 8 ranks,
  13 actions over 2 action ranks) and the converged engine's stop sweep
  and check log.
* Ties split across action ranks resolve to the first action.
* A Kirk solve over 4 ranks against the JAX single-device solve: rtol
  1e-5, atol 1e-5, argmins equal (the port's gather is held to JAX's so in
  tests/test_torch_kirk.py).
* Mesh layout (row-major, last axis fastest), the one-process bootstrap,
  and the default device: the card, so without one ``make_mesh`` raises.
"""

import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ocdp_tpu_torch.engine import (value_iteration_converged,
                                   value_iteration_finite)
from ocdp_tpu_torch.models import kirk as tkirk
from ocdp_tpu_torch.ops.interp import build_plan
from ocdp_tpu_torch.parallel import (LocalMesh, initialize_distributed,
                                     make_mesh, shard_backup_inputs,
                                     sharded_bellman_sweeps,
                                     value_iteration_converged_sharded,
                                     value_iteration_finite_sharded)
from ocdp_tpu_torch.parallel.mesh import first_min, row_blocks

torch.set_num_threads(2)


def small_problem(dx=16, du=12):
    return tkirk.build(tkirk.KirkConfig(N=12, dx=dx, du=du), device="cpu")


@pytest.mark.parametrize("dx,du", [(16, 12), (17, 13)])   # 17/13: padding
@pytest.mark.parametrize("store", [False, True])
def test_state_sharding_matches_one_device(dx, du, store):
    p = small_problem(dx, du)
    ref = value_iteration_finite(p.plan, p.stage_cost, 11,
                                 store_policies=store)
    got = value_iteration_finite_sharded(
        p.plan, p.stage_cost, 11, LocalMesh(("s",), (8,), device="cpu"),
        store_policies=store)
    assert torch.equal(got.values, ref.values)
    assert torch.equal(got.argmin, ref.argmin)
    if store:
        assert torch.equal(got.policies, ref.policies)


@pytest.mark.parametrize("dx,du", [(16, 12), (18, 13)])
def test_state_plus_action_sharding_matches_one_device(dx, du):
    p = small_problem(dx, du)
    ref = value_iteration_finite(p.plan, p.stage_cost, 9, store_policies=True)
    got = value_iteration_finite_sharded(
        p.plan, p.stage_cost, 9, LocalMesh(("s", "a"), (4, 2), device="cpu"),
        action_axis_name="a", store_policies=True)
    assert torch.equal(got.values, ref.values)
    assert torch.equal(got.argmin, ref.argmin)
    assert torch.equal(got.policies, ref.policies)


def test_action_tie_break_across_shards():
    """Every action ties; the first flat index must win across shards."""
    axes = (np.linspace(-1, 1, 9, dtype=np.float32),)
    plan = build_plan(axes, (torch.zeros((9, 8)),))
    cost = torch.zeros((9, 8))
    got = value_iteration_finite_sharded(
        plan, cost, 3, LocalMesh(("s", "a"), (1, 8), device="cpu"),
        action_axis_name="a")
    assert int(got.argmin.max()) == 0


def test_padded_actions_never_win():
    """5 actions over 4 action ranks pad to 8 with +inf cost."""
    p = tkirk.build(tkirk.KirkConfig(N=6, dx=10, du=5), device="cpu")
    sp = shard_backup_inputs(p.plan, p.stage_cost,
                             LocalMesh(("s", "a"), (2, 4), device="cpu"),
                             action_axis_name="a")
    assert sp.plan.query_shape[-1] == 8 and sp.action_size == 5
    assert bool(torch.isinf(sp.cost[-1][..., 5:]).all())
    ref = value_iteration_finite(p.plan, p.stage_cost, 5)
    got = value_iteration_finite_sharded(
        p.plan, p.stage_cost, 5, LocalMesh(("s", "a"), (2, 4), device="cpu"),
        action_axis_name="a")
    assert torch.equal(got.values, ref.values)
    assert int(got.argmin.max()) < 5


def test_cost_terms_sum_in_order():
    p = small_problem()
    s = torch.as_tensor(p.grid.axes[0])
    terms = [s.reshape(-1, 1, 1) ** 2, s.reshape(1, -1, 1) ** 2,
             torch.as_tensor(p.u_mesh).reshape(1, 1, -1) ** 2]
    ref = value_iteration_finite(p.plan, terms, 5)
    got = value_iteration_finite_sharded(
        p.plan, terms, 5, LocalMesh(("s", "a"), (2, 4), device="cpu"),
        action_axis_name="a")
    assert torch.equal(got.values, ref.values)
    assert torch.equal(got.argmin, ref.argmin)


def test_sharded_bellman_sweeps_returns_whole_tables():
    p = small_problem(17, 13)
    mesh = LocalMesh(("s",), (4,), device="cpu")
    sp = shard_backup_inputs(p.plan, p.stage_cost, mesh)
    assert sp.plan.query_shape[0] == 20 and sp.state_size == 17
    v, a, pol = sharded_bellman_sweeps(sp, mesh, 3, store_policies=True)
    assert tuple(v.shape) == tuple(a.shape) == (17, 17)
    assert tuple(pol.shape) == (3, 17, 17) and pol.dtype == torch.uint8


@pytest.mark.parametrize("sizes", [(8,), (4, 2)], ids=["8", "4x2"])
def test_converged_matches_one_device_with_checks(sizes):
    p = small_problem(17, 13)
    ref = value_iteration_converged(p.plan, p.stage_cost, 20, check_every=3,
                                    tol=0.0)
    calls = []
    got = value_iteration_converged_sharded(
        p.plan, p.stage_cost, 20, LocalMesh(("s", "a")[:len(sizes)], sizes,
                                            device="cpu"),
        check_every=3, tol=0.0, on_check=lambda *a: calls.append(a),
        action_axis_name="a" if len(sizes) == 2 else None)
    assert got.num_sweeps == ref.num_sweeps == 20
    assert torch.equal(got.values, ref.values)
    assert torch.equal(got.argmin, ref.argmin)
    assert torch.equal(got.checks, ref.checks)
    assert [c[0] for c in calls] == [18, 15, 12, 9, 6, 3]


def test_converged_stops_where_one_device_stops():
    p = small_problem()
    ref = value_iteration_converged(p.plan, p.stage_cost, 30, check_every=5,
                                    tol=1e12)
    got = value_iteration_converged_sharded(
        p.plan, p.stage_cost, 30, LocalMesh(("s",), (4,), device="cpu"),
        check_every=5, tol=1e12)
    assert ref.converged and got.converged
    assert got.num_sweeps == ref.num_sweeps == 1
    assert torch.equal(got.values, ref.values)


def test_four_ranks_match_jax_single_device():
    from ocdp_tpu import value_iteration_finite as jfinite
    from ocdp_tpu.models import kirk as jkirk

    jp = jkirk.build(jkirk.KirkConfig(N=12, dx=16, du=12))
    jres = jfinite(jp.plan, jp.stage_cost, 11)
    p = small_problem()
    got = value_iteration_finite_sharded(
        p.plan, p.stage_cost, 11, LocalMesh(("s",), (4,), device="cpu"))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(jres.values),
                               rtol=1e-5, atol=1e-5)
    assert (got.argmin.numpy() == np.asarray(jres.argmin)).mean() == 1.0


def test_first_min_keeps_the_first_group_on_ties():
    v = [torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 1.0, 4.0]),
         torch.tensor([0.5, 1.0, 3.0])]
    a = [torch.tensor([2, 0, 1]), torch.tensor([3, 4, 5]),
         torch.tensor([7, 7, 6])]
    vmin, arg = first_min(v, a, 9)
    assert vmin.tolist() == [0.5, 1.0, 3.0]
    assert arg.tolist() == [7, 4, 1]


def test_row_blocks():
    assert row_blocks(1331, 2) == [(0, 666), (666, 1331)]
    assert row_blocks(1331, 4) == [(0, 333), (333, 666), (666, 999),
                                   (999, 1331)]
    assert row_blocks(5, 4) == [(0, 2), (2, 3), (3, 4), (4, 5)]
    with pytest.raises(ValueError, match="do not split"):
        row_blocks(3, 4)


def test_make_mesh_local_and_2d():
    mesh = make_mesh(("s",), (8,), device="cpu")
    assert isinstance(mesh, LocalMesh) and mesh.shape == {"s": 8}
    assert mesh.local_coords == [(i,) for i in range(8)]
    mesh2 = make_mesh(("s", "a"), (4, 2), device="cpu")
    assert mesh2.shape == {"s": 4, "a": 2}


def test_mesh_order_contract():
    """Row-major like the JAX package's device order: the last axis varies
    fastest, so a state axis placed last holds consecutive ranks."""
    mesh = make_mesh(("h", "s"), (2, 4), device="cpu")
    assert [mesh.rank_of(c) for c in mesh.local_coords] == list(range(8))
    assert mesh.coord_of(5) == (1, 1)
    assert [mesh.rank_of((1, s)) - mesh.rank_of((0, s))
            for s in range(4)] == [4, 4, 4, 4]


def test_mesh_refuses_bad_axes():
    with pytest.raises(ValueError, match="do not match"):
        LocalMesh(("s", "s"), (2, 2), device="cpu")
    with pytest.raises(ValueError, match="no mesh axis"):
        LocalMesh(("s",), (2,), device="cpu").axis("a")


def test_initialize_distributed_one_process_is_a_no_op():
    import torch.distributed as dist

    initialize_distributed(num_processes=1, process_id=0)
    initialize_distributed()
    assert not dist.is_initialized()


def test_make_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(("s",), (2,))


def test_dryrun_on_an_in_process_mesh():
    from ocdp_tpu_torch.parallel.dryrun import dryrun_multichip

    ran = dryrun_multichip(8, device="cpu")
    assert ran == ["sharded finite", "sharded converged", "halo finite",
                   "halo 2-D finite", "halo band finite", "halo6 finite",
                   "halo6 converged", "halo6 2-D finite", "solve_ep"]


# ---- a 2-rank gloo group, spawned once for this file ----------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    from ocdp_tpu_torch.parallel.dryrun import dryrun_multichip

    initialize_distributed(f"localhost:{port}", world, rank, backend="gloo")
    out = {}
    for dx, du in ((16, 12), (17, 13)):
        p = small_problem(dx, du)
        mesh = make_mesh(("s",), device="cpu")
        r = value_iteration_finite_sharded(p.plan, p.stage_cost, 11, mesh,
                                           store_policies=True)
        out[f"state-{dx}"] = (r.values, r.argmin, r.policies)
        mesh = make_mesh(("s", "a"), (1, 2), device="cpu")
        r = value_iteration_finite_sharded(p.plan, p.stage_cost, 11, mesh,
                                           action_axis_name="a")
        out[f"action-{dx}"] = (r.values, r.argmin)
    p = small_problem(17, 13)
    calls = []
    r = value_iteration_converged_sharded(
        p.plan, p.stage_cost, 20, make_mesh(("s",), device="cpu"),
        check_every=3, tol=0.0, on_check=lambda *a: calls.append(a))
    out["converged"] = (r.values, r.argmin, r.checks, r.num_sweeps)
    out["calls"] = calls
    out["dryrun"] = dryrun_multichip(2)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gloo_sharded"))
    mp.spawn(_gloo_worker, args=(2, _free_port(), out), nprocs=2, join=True)
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(2)]


@pytest.mark.parametrize("case", ["state-16", "state-17", "action-16",
                                  "action-17"])
def test_gloo_finite_bitwise(gloo, case):
    dx = int(case.split("-")[1])
    p = small_problem(dx, 12 if dx == 16 else 13)
    ref = value_iteration_finite(p.plan, p.stage_cost, 11,
                                 store_policies=True)
    for g in gloo:
        got = g[case]
        assert torch.equal(got[0], ref.values)
        assert torch.equal(got[1], ref.argmin)
        if case.startswith("state"):
            assert torch.equal(got[2], ref.policies)


def test_gloo_converged_and_checks(gloo):
    p = small_problem(17, 13)
    ref = value_iteration_converged(p.plan, p.stage_cost, 20, check_every=3,
                                    tol=0.0)
    for g in gloo:
        values, argmin, checks, n = g["converged"]
        assert n == 20
        assert torch.equal(values, ref.values)
        assert torch.equal(argmin, ref.argmin)
        assert torch.equal(checks, ref.checks)
    assert [c[0] for c in gloo[0]["calls"]] == [18, 15, 12, 9, 6, 3]
    assert gloo[1]["calls"] == []


def test_gloo_dryrun(gloo):
    want = ["sharded finite", "sharded converged", "halo finite",
            "halo 2-D finite", "halo band finite", "halo6 finite",
            "halo6 converged"]
    assert all(g["dryrun"] == want for g in gloo)
