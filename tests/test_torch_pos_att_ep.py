"""Port pos-att multi-rank entry points (ocdp_tpu_torch/models/pos_att.py::
solve_ep, solve_channel_sharded) and the halo byte accounting
(parallel/comms.py), on the CPU.

* ``solve_ep``, one channel per rank of an in-process mesh and of a 4-rank
  gloo group, equals the serial ``solve_channel`` bitwise per channel, with
  each channel's own stop sweep; the failure channel's 6 actions are never
  exceeded.
* ``solve_channel_sharded`` (engines ``'halo'`` and ``'replicated'``, both
  on the gather backup) equals ``solve_channel(impl='gather')`` bitwise.
* ``solve_ep``'s x and x_failure channels against the JAX serial solve
  (``impl='gather'``): values rtol 1e-5 / atol 1e-5, >= 99.9% equal
  argmins (tests/test_torch_pos_att.py's bounds).
* The halo bytes each communicator counts equal the analytic
  ``(lo + hi) x NE x 4 B`` per rank with two neighbors.
"""

import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ocdp_tpu_torch.models import attitude as tatt
from ocdp_tpu_torch.models import pos_att as tpa
from ocdp_tpu_torch.parallel import (LocalMesh, halo_bytes,
                                     initialize_distributed, make_mesh,
                                     measure_halo6_comms, mesh_halo_bytes,
                                     value_iteration_finite_halo6)

torch.set_num_threads(2)

SMALL = dict(n_mesh_x=4, n_mesh_v=4, n_mesh_t=3, n_mesh_w=3)
SHARDED = dict(n_mesh_x=16, n_mesh_v=8, n_mesh_t=6, n_mesh_w=5)
NAMES = ("x", "y", "z", "x_failure")


def small_cfg(**kw):
    return tpa.PosAttConfig(**dict(SMALL, **kw))


def serial(cfg, name, **kw):
    return tpa.solve_channel(cfg, name.replace("_failure", ""),
                             failure="failure" in name, device="cpu", **kw)


@pytest.mark.parametrize("include_failure", [True, False])
def test_ep_matches_serial(include_failure):
    cfg = small_cfg()
    sol = tpa.solve_ep(cfg, max_sweeps=10, include_failure=include_failure,
                       device="cpu")
    names = NAMES if include_failure else NAMES[:3]
    assert tuple(sol.controllers) == names
    for name in names:
        ctrl, res = serial(cfg, name, max_sweeps=10)
        got = sol.controllers[name]
        assert torch.equal(got.values, ctrl.values)
        assert torch.equal(got.argmin, ctrl.argmin)
        np.testing.assert_array_equal(got.forces, ctrl.forces)
        assert sol.results[name].num_sweeps == res.num_sweeps


def test_ep_per_channel_early_stop():
    """A huge tolerance stops every channel at its first check, each rank on
    its own channel's checks."""
    cfg = small_cfg(tol=1e12, check_every=5)
    sol, results = tpa.solve_ep(cfg, max_sweeps=20, return_results=True,
                                device="cpu")
    for name in NAMES:
        ctrl, res = serial(cfg, name, max_sweeps=20)
        assert res.converged and results[name]["converged"]
        assert results[name]["num_sweeps"] == res.num_sweeps
        assert torch.equal(results[name]["checks"], res.checks)
        assert torch.equal(sol.controllers[name].values, ctrl.values)
        assert torch.equal(sol.controllers[name].argmin, ctrl.argmin)


def test_ep_failure_channel_actions():
    sol = tpa.solve_ep(small_cfg(), max_sweeps=10, device="cpu")
    assert sol.controllers["x_failure"].forces.shape[0] == 6
    assert int(sol.controllers["x_failure"].argmin.max()) < 6


def test_ep_mesh_must_have_one_rank_per_channel():
    with pytest.raises(ValueError, match="channels"):
        tpa.solve_ep(small_cfg(), LocalMesh(("c",), (3,), device="cpu"),
                     max_sweeps=2)


def test_ep_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpa.solve_ep(small_cfg(), max_sweeps=2)


@pytest.mark.parametrize("engine", ["halo", "replicated"])
def test_sharded_channel_solve_matches_serial(engine):
    cfg = tpa.PosAttConfig(**SHARDED)
    ref_ctrl, ref_res = tpa.solve_channel(cfg, "x", max_sweeps=30,
                                          impl="gather", device="cpu")
    ctrl, res = tpa.solve_channel_sharded(
        cfg, "x", LocalMesh(("s",), (8,), device="cpu"), max_sweeps=30,
        engine=engine)
    assert res.num_sweeps == ref_res.num_sweeps
    assert torch.equal(ctrl.values, ref_ctrl.values)
    assert torch.equal(ctrl.argmin, ref_ctrl.argmin)


def test_sharded_channel_solve_refuses_an_unknown_engine():
    with pytest.raises(ValueError, match="unknown engine"):
        tpa.solve_channel_sharded(small_cfg(), "x",
                                  LocalMesh(("s",), (2,), device="cpu"),
                                  engine="stencil")


def test_ep_close_to_jax_serial_solve():
    from ocdp_tpu.models import pos_att as jpa

    cfg = dict(SMALL, n_mesh_x=7, n_mesh_v=7, n_mesh_t=6, n_mesh_w=5)
    sol = tpa.solve_ep(tpa.PosAttConfig(**cfg), max_sweeps=30, device="cpu")
    for name in ("x", "x_failure"):
        jctrl, _ = jpa.solve_channel(jpa.PosAttConfig(**cfg),
                                     name.replace("_failure", ""),
                                     failure="failure" in name,
                                     impl="gather", max_sweeps=30)
        got = sol.controllers[name]
        np.testing.assert_allclose(got.values.numpy(),
                                   np.asarray(jctrl.values), rtol=1e-5,
                                   atol=1e-5)
        assert (got.argmin.numpy() == np.asarray(jctrl.argmin)).mean() \
            >= 0.999


def test_halo_bytes_analytic():
    assert halo_bytes(31, 31, 64) == 62 * 64 * 4
    assert mesh_halo_bytes(1, 31, 31, 64) == 0
    assert mesh_halo_bytes(4, 31, 31, 64) == 3 * 62 * 64 * 4


def test_measure_halo6_comms_counts_what_it_moves():
    got = measure_halo6_comms(tatt.AttitudeConfig(n_mesh_w=5, n_mesh_q=4),
                              3, device="cpu")
    assert got["halo_rows"] == (31, 31) and got["NE"] == 64
    assert got["halo_bytes_per_sweep_counted"] == \
        got["halo_bytes_per_sweep_analytic"] == 2 * 62 * 64 * 4
    assert got["halo_bytes_per_rank_sweep_analytic"] == 62 * 64 * 4
    assert got["flops_per_sweep_analytic"] > got["cells"] * 27 * 2


# ---- a 4-rank gloo group, spawned once for this file ----------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gloo_worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, backend="gloo")
    out = {}
    mesh = make_mesh(("c",), device="cpu")
    sol, results = tpa.solve_ep(small_cfg(), mesh, max_sweeps=10,
                                return_results=True)
    out["ep"] = {n: (c.values, c.argmin, results[n]["num_sweeps"])
                 for n, c in sol.controllers.items()}
    cfg = tpa.PosAttConfig(**SHARDED)
    smesh = make_mesh(("s",), device="cpu")
    for engine in ("halo", "replicated"):
        ctrl, res = tpa.solve_channel_sharded(cfg, "x", smesh, max_sweeps=30,
                                              engine=engine)
        out[engine] = (ctrl.values, ctrl.argmin, res.num_sweeps)
    _, plan, cost = tatt.build_full(tatt.AttitudeConfig(n_mesh_w=5,
                                                        n_mesh_q=4),
                                    device="cpu")
    m3 = make_mesh(("s",), (3,), device="cpu")
    if m3.is_member:
        value_iteration_finite_halo6(plan, cost, 2, m3)
    out["halo_bytes"] = m3.halo_bytes
    out["halo_bytes_channel"] = smesh.halo_bytes
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gloo_ep"))
    mp.spawn(_gloo_worker, args=(4, _free_port(), out), nprocs=4, join=True)
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(4)]


def test_gloo_ep_matches_serial(gloo):
    cfg = small_cfg()
    for name in NAMES:
        ctrl, res = serial(cfg, name, max_sweeps=10)
        for g in gloo:
            values, argmin, n = g["ep"][name]
            assert torch.equal(values, ctrl.values)
            assert torch.equal(argmin, ctrl.argmin)
            assert n == res.num_sweeps


@pytest.mark.parametrize("engine", ["halo", "replicated"])
def test_gloo_sharded_channel_solve(gloo, engine):
    cfg = tpa.PosAttConfig(**SHARDED)
    ref_ctrl, ref_res = tpa.solve_channel(cfg, "x", max_sweeps=30,
                                          impl="gather", device="cpu")
    for g in gloo:
        values, argmin, n = g[engine]
        assert n == ref_res.num_sweeps
        assert torch.equal(values, ref_ctrl.values)
        assert torch.equal(argmin, ref_ctrl.argmin)


def test_gloo_halo_bytes_equal_analytic(gloo):
    # the 6-D halo (2 sweeps on ranks 0-2), then the channel halo solve
    six = [g["halo_bytes"] for g in gloo]
    assert six[1] == 2 * halo_bytes(31, 31, 64)
    assert sum(six) == 2 * mesh_halo_bytes(3, 31, 31, 64)
    assert six[3] == 0
    mesh = LocalMesh(("s",), (4,), device="cpu")
    tpa.solve_channel_sharded(tpa.PosAttConfig(**SHARDED), "x", mesh,
                              max_sweeps=30, engine="halo")
    assert sum(g["halo_bytes_channel"] for g in gloo) == mesh.halo_bytes > 0
