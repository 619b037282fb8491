"""Port halo-exchange engines (ocdp_tpu_torch/parallel/halo.py), on the CPU.

* The gather backup on Kirk over 8 ranks and over 4 x 2 (rows x actions),
  and kernel B.6's plain version (``backup='band'``) on a simplified
  attitude axis over 2 and 3 ranks and 2 x 3, each bitwise equal to the same
  backup on one device, policies included; the JAX package holds its 2-D
  stencil halo only to an ulp (tests/test_halo.py:79-83), the port exactly.
* The converged engine: the same stop sweep, bitwise values, check logs
  within rtol 1e-6 (block sums added in rank order).
* The same engines over a 2-rank gloo group.
* A Kirk halo solve against the JAX single-device solve: rtol 1e-5, atol
  1e-5, argmins equal.
* The guards: halo width, indivisible actions, ``'band'`` on a plan that is
  not 2-D.
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
from ocdp_tpu_torch.models import kirk as tkirk
from ocdp_tpu_torch.ops.band_backup2d import BandBackup2D
from ocdp_tpu_torch.ops.interp import build_plan
from ocdp_tpu_torch.parallel import (LocalMesh, initialize_distributed,
                                     make_mesh,
                                     value_iteration_converged_halo,
                                     value_iteration_finite_halo)
from ocdp_tpu_torch.parallel.halo import axis0_reach

torch.set_num_threads(2)

AXIS = dict(n_mesh_w=60, n_mesh_t=30)


def kirk_problem():
    return tkirk.build(tkirk.KirkConfig(N=10, dx=24, du=20), device="cpu")


def axis_problem(axis=0, edge="clamp"):
    _, plan, terms = tatt.build_simplified_axis(tatt.AttitudeConfig(**AXIS),
                                                axis, edge=edge,
                                                device="cpu")
    return plan, terms


@pytest.mark.parametrize("store", [False, True])
def test_gather_halo_matches_one_device(store):
    p = kirk_problem()
    ref = value_iteration_finite(p.plan, p.stage_cost, 9,
                                 store_policies=store)
    got = value_iteration_finite_halo(p.plan, p.stage_cost, 9,
                                      LocalMesh(("s",), (8,), device="cpu"),
                                      store_policies=store)
    assert torch.equal(got.values, ref.values)
    assert torch.equal(got.argmin, ref.argmin)
    if store:
        assert torch.equal(got.policies, ref.policies)


@pytest.mark.parametrize("store", [False, True])
def test_state_action_mesh_matches_one_device(store):
    p = kirk_problem()
    ref = value_iteration_finite(p.plan, p.stage_cost, 9,
                                 store_policies=store)
    got = value_iteration_finite_halo(
        p.plan, p.stage_cost, 9, LocalMesh(("s", "a"), (4, 2), device="cpu"),
        action_axis_name="a", store_policies=store)
    assert torch.equal(got.values, ref.values)
    assert torch.equal(got.argmin, ref.argmin)
    if store:
        assert torch.equal(got.policies, ref.policies)


@pytest.mark.parametrize("axis,edge", [(0, "clamp"), (1, "extrapolate"),
                                       (2, "clamp")])
@pytest.mark.parametrize("sizes", [(2,), (3,), (2, 3)],
                         ids=["2", "3", "2x3"])
def test_band_halo_matches_one_device(axis, edge, sizes):
    plan, terms = axis_problem(axis, edge)
    ref = value_iteration_finite(plan, terms, 7, store_policies=True,
                                 backup=BandBackup2D(plan, terms))
    got = value_iteration_finite_halo(
        plan, terms, 7, LocalMesh(("s", "a")[:len(sizes)], sizes,
                                  device="cpu"),
        backup="band", store_policies=True,
        action_axis_name="a" if len(sizes) == 2 else None)
    assert torch.equal(got.values, ref.values)
    assert torch.equal(got.argmin, ref.argmin)
    assert torch.equal(got.policies, ref.policies)


@pytest.mark.parametrize("backup", ["gather", "band"])
def test_converged_matches_one_device(backup):
    plan, terms = axis_problem()
    bk = BandBackup2D(plan, terms) if backup == "band" else None
    ref = value_iteration_converged(plan, terms, 40, check_every=10,
                                    tol=0.0, backup=bk)
    calls = []
    got = value_iteration_converged_halo(
        plan, terms, 40, LocalMesh(("s",), (3,), device="cpu"),
        check_every=10, tol=0.0, backup=backup,
        on_check=lambda *a: calls.append(a))
    assert got.num_sweeps == ref.num_sweeps == 40
    assert torch.equal(got.values, ref.values)
    assert torch.equal(got.argmin, ref.argmin)
    np.testing.assert_allclose(got.checks.numpy(), ref.checks.numpy(),
                               rtol=1e-6)
    assert [c[0] for c in calls] == [40, 30, 20, 10]


def test_converged_stops_where_one_device_stops():
    p = kirk_problem()
    ref = value_iteration_converged(p.plan, p.stage_cost, 30, check_every=5,
                                    tol=1e12)
    got = value_iteration_converged_halo(
        p.plan, p.stage_cost, 30, LocalMesh(("s",), (4,), device="cpu"),
        check_every=5, tol=1e12)
    assert got.converged and got.num_sweeps == ref.num_sweeps == 1
    assert torch.equal(got.values, ref.values)


def test_reach_is_the_exact_row_span():
    plan, _ = axis_problem(0)
    lo, hi = axis0_reach(plan)
    own = torch.arange(plan.grid_shape[0]).reshape(-1, 1, 1)
    d = plan.lo[0].to(torch.int64) - own
    assert (lo, hi) == (max(-int(d.min()), 0), int(d.max()) + 1)


def test_rejects_indivisible_actions():
    p = tkirk.build(tkirk.KirkConfig(N=6, dx=16, du=9), device="cpu")
    with pytest.raises(ValueError, match="do not divide"):
        value_iteration_finite_halo(p.plan, p.stage_cost, 3,
                                    LocalMesh(("s", "a"), (2, 2),
                                              device="cpu"),
                                    action_axis_name="a")


def test_rejects_too_wide_halo():
    # axis-0 reach of 8 cells > per-rank block height of 2
    axes = (np.linspace(0, 1, 16, dtype=np.float32),)
    q = (np.linspace(0, 1, 16, dtype=np.float32) + 0.5)[:, None]
    plan = build_plan(axes, (torch.from_numpy(np.broadcast_to(q, (16, 3))
                                              .copy()),))
    cost = torch.zeros((16, 3))
    with pytest.raises(ValueError, match="halo widths"):
        value_iteration_finite_halo(plan, cost, 3,
                                    LocalMesh(("s",), (8,), device="cpu"))


def test_band_refuses_a_plan_that_is_not_2d():
    p = kirk_problem()
    with pytest.raises(ValueError, match="unknown backup"):
        value_iteration_finite_halo(p.plan, p.stage_cost, 2,
                                    LocalMesh(("s",), (2,), device="cpu"),
                                    backup="stencil")
    from ocdp_tpu_torch.models import pos_att as tpa

    prob = tpa.build_channel(tpa.PosAttConfig(n_mesh_x=8, n_mesh_v=4,
                                              n_mesh_t=3, n_mesh_w=3), "x",
                             device="cpu")
    with pytest.raises(ValueError, match="2-D plans"):
        value_iteration_finite_halo(prob.plan, prob.stage_cost, 2,
                                    LocalMesh(("s",), (2,), device="cpu"),
                                    backup="band")


def test_halo_matches_jax_single_device():
    from ocdp_tpu import value_iteration_finite as jfinite
    from ocdp_tpu.models import kirk as jkirk

    jp = jkirk.build(jkirk.KirkConfig(N=10, dx=24, du=20))
    jres = jfinite(jp.plan, jp.stage_cost, 9)
    p = kirk_problem()
    got = value_iteration_finite_halo(p.plan, p.stage_cost, 9,
                                      LocalMesh(("s",), (4,), device="cpu"))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(jres.values),
                               rtol=1e-5, atol=1e-5)
    assert (got.argmin.numpy() == np.asarray(jres.argmin)).mean() == 1.0


# ---- a 2-rank gloo group, spawned once for this file ----------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, backend="gloo")
    out = {}
    p = kirk_problem()
    mesh = make_mesh(("s",), device="cpu")
    r = value_iteration_finite_halo(p.plan, p.stage_cost, 9, mesh,
                                    store_policies=True)
    out["gather"] = (r.values, r.argmin, r.policies)
    r = value_iteration_finite_halo(p.plan, p.stage_cost, 9,
                                    make_mesh(("s", "a"), (1, 2),
                                              device="cpu"),
                                    action_axis_name="a")
    out["gather-1x2"] = (r.values, r.argmin)
    plan, terms = axis_problem()
    r = value_iteration_finite_halo(plan, terms, 7, mesh, backup="band")
    out["band"] = (r.values, r.argmin)
    r = value_iteration_converged_halo(plan, terms, 40, mesh, check_every=10,
                                       tol=0.0, backup="band")
    out["converged"] = (r.values, r.argmin, r.checks)
    out["halo_bytes"] = mesh.halo_bytes
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gloo_halo"))
    mp.spawn(_gloo_worker, args=(2, _free_port(), out), nprocs=2, join=True)
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(2)]


@pytest.mark.parametrize("case", ["gather", "gather-1x2", "band"])
def test_gloo_finite_bitwise(gloo, case):
    if case == "band":
        plan, terms = axis_problem()
        ref = value_iteration_finite(plan, terms, 7,
                                     backup=BandBackup2D(plan, terms))
    else:
        p = kirk_problem()
        ref = value_iteration_finite(p.plan, p.stage_cost, 9,
                                     store_policies=True)
    for g in gloo:
        got = g[case]
        assert torch.equal(got[0], ref.values)
        assert torch.equal(got[1], ref.argmin)
        if case == "gather":
            assert torch.equal(got[2], ref.policies)


def test_gloo_converged_equals_in_process_mesh(gloo):
    plan, terms = axis_problem()
    mesh = LocalMesh(("s",), (2,), device="cpu")
    local = value_iteration_converged_halo(plan, terms, 40, mesh,
                                           check_every=10, tol=0.0,
                                           backup="band")
    for g in gloo:
        values, argmin, checks = g["converged"]
        assert torch.equal(values, local.values)
        assert torch.equal(argmin, local.argmin)
        assert torch.equal(checks, local.checks)
