#!/usr/bin/env python3
"""Time the 6-D backup kernel's five modes and the solves that run them, on
one CUDA device, for one tree of the repository.

    python3 scripts/torch_backup6d_compare.py [--tree DIR] [--label NAME]
                                              [--skip-solves]

Imports ``ocdp_tpu_torch`` from ``DIR`` (default: this checkout) and builds
that tree's kernels, so two trees (for instance this one and a ``git
archive`` of its parent under the gitignored ``build/``) are timed by the
same code: run parent, change, change, parent, one process each, in one
call on one card. Prints the card's name and power limit, then one line
``RESULT <json>`` per run.

Timed, at the shapes the main paths run (kernels: CUDA events, warm,
median of 10 back-to-back calls; solves: host clock around work that ends
in a synchronize, the build included):

* ``nvcc`` on the tree's ``csrc/backup6d.cu`` alone, after the library's
  build (``nvcc_backup6d_s``);
* B.3, one sweep of a seeded 11^3 x 10^3 table (the full tap cube:
  ``backup6d_sweep_cube`` where the tree has it); for it and for B.7a and
  B.7b besides, the device time of a launch (``*_device_ms``:
  ``torch.profiler``'s kernel time over 50 back-to-back launches), which
  the wrapper's host work does not hide;
* B.4 (uint8, tracking, carry buffers) and B.5 at 30^3 x 16^3 (median of
  5), and B.5 at the envelope cell's 48^3 x 10^3 (the full tap cube:
  ``backup6d_sweep_recompute_cube`` where the tree has it);
* B.7b, rank 0 of 2 at 11^3 x 10^3 (666 rows of a 932-row local table),
  and B.7a, its first digit slice (rank (0, 0) of 2 x 3).

Each mode runs through the tree's launcher of it: ``backup6d_cuda``, or
the mode's own wrapper in a tree that has one (``backup6d_flat_cuda``,
``backup6d_recompute_cuda``, ``backup6d_block_cuda``,
``backup6d_slice_cuda``, each with its own counters);
* ``attitude.solve_full(AttitudeConfig(n_mesh_w=11, n_mesh_q=10))`` (5999
  sweeps);
* the README's envelope run, ``solve_full(AttitudeConfig(n_mesh_w=30,
  n_mesh_q=16), num_sweeps=100, segment_size=50, checkpoint_path=...,
  tol=1e-6, tol_mode='rel')``;
* ``value_iteration_finite_halo6`` at 11^3 x 10^3 over 5999 sweeps on an
  in-process mesh of 2 ranks and of 2 x 3 (rows x digit slices).

Then each of the three 11^3 x 10^3 solves again under ``torch.profiler``
(the one-device solve over its 5999 sweeps, the meshes over 1000): the
device busy share (the device time of every kernel over the wall time,
the build included) and the device time of one 6-D kernel launch, which
the back-to-back wrapper timing above cannot separate from the wrapper's
host work where that is the longer.

Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--skip-solves", action="store_true",
                    help="time the five kernel modes only")
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.tree).resolve()))

    import numpy as np
    import torch

    from ocdp_tpu_torch import _build
    from ocdp_tpu_torch.models import attitude
    from ocdp_tpu_torch.ops import backup6d as b6
    from ocdp_tpu_torch.parallel import (make_mesh,
                                         value_iteration_finite_halo6)
    from ocdp_tpu_torch.profiling import cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{opts.label}: {b6.__file__} on [{smi}]", flush=True)
    dev = torch.device("cuda")
    out = {"label": opts.label, "card": smi}

    def launcher(name):
        """The tree's launcher of one mode (see the head of this file)."""
        return getattr(b6, name, b6.backup6d_cuda)

    b4 = launcher("backup6d_flat_cuda")
    b5 = launcher("backup6d_recompute_cuda")
    b7b = launcher("backup6d_block_cuda")
    b7a = launcher("backup6d_slice_cuda")

    def device_ms(fn, n=50):
        fn()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and ("backup6d_sweep" in e.key or "backup6d_wide" in e.key)]
        return (sum(e.self_device_time_total for e in rows)
                / max(sum(e.count for e in rows), 1) / 1e3)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    t0 = time.perf_counter()
    _build.load()
    out["build_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                        str(Path(tmp) / "backup6d.o"),
                        str(Path(_build.CSRC) / "backup6d.cu")],
                       check=True, capture_output=True, timeout=600)
        out["nvcc_backup6d_s"] = time.perf_counter() - t0

    # B.3, B.7b, B.7a at 11^3 x 10^3
    cfg = attitude.AttitudeConfig(n_mesh_w=11, n_mesh_q=10)
    _, plan, cost = attitude.build_full(cfg, device=dev)
    bk = b6.Backup6D(plan, cost)
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.uniform(0.0, 100.0, (bk.NW, bk.NE))
                         .astype(np.float32)).to(dev)
    cube0 = getattr(b6.backup6d_cuda, "cube_launches", None)
    out["b3_ms"] = cuda_time_ms(lambda: b6.backup6d_cuda(v, bk.args),
                                inner=5)
    if cube0 is not None:
        out["b3_cube_launches"] = b6.backup6d_cuda.cube_launches - cube0
    out["b3_device_ms"] = device_ms(lambda: b6.backup6d_cuda(v, bk.args))
    lo, hi = bk.row_reach()
    r1 = (bk.NW + 1) // 2
    blk = b6.block_args(bk.args, 0, r1, lo, hi)
    local = torch.nn.functional.pad(v, (0, 0, lo, 0))[:r1 + lo + hi] \
        .contiguous()
    sl = b6.slice_args(blk, 0, 9)
    out["b7b_ms"] = cuda_time_ms(lambda: b7b(local, blk), inner=5)
    out["b7a_ms"] = cuda_time_ms(lambda: b7a(local, sl), inner=5)
    out["b7b_device_ms"] = device_ms(lambda: b7b(local, blk))
    out["b7a_device_ms"] = device_ms(lambda: b7a(local, sl))
    del bk, v, local

    # B.4 and B.5 at 30^3 x 16^3
    env = attitude.AttitudeConfig(n_mesh_w=30, n_mesh_q=16)
    _, rplan, rcost = attitude.build_full(env, device=dev)
    bk5 = b6.Backup6D(rplan, rcost, argmin_dtype=torch.uint8,
                      carry_padded=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    v = torch.rand((bk5.NW, bk5.NE), generator=gen, device=dev).mul_(100.0)
    ov = torch.empty_like(v)
    oa = torch.empty(v.shape, dtype=torch.uint8, device=dev)
    out["b5_ms"] = cuda_time_ms(lambda: b5(
        v, bk5.args, out_v=ov, out_a=oa), repeats=5)
    del bk5, rplan, rcost
    torch.cuda.empty_cache()
    cell = attitude.AttitudeConfig(n_mesh_w=48, n_mesh_q=10)
    _, cplan, ccost = attitude.build_full(cell, device=dev)
    bkc = b6.Backup6D(cplan, ccost, argmin_dtype=torch.uint8,
                      carry_padded=True)
    del cplan, ccost
    vc = torch.rand((bkc.NW, bkc.NE), generator=gen, device=dev).mul_(100.0)
    ovc = torch.empty_like(vc)
    oac = torch.empty(vc.shape, dtype=torch.uint8, device=dev)
    cube0 = getattr(b5, "cube_launches", None)
    out["b5_48x10_ms"] = cuda_time_ms(lambda: b5(
        vc, bkc.args, out_v=ovc, out_a=oac), repeats=5)
    if cube0 is not None:
        out["b5_48x10_cube_launches"] = b5.cube_launches - cube0
    del bkc, vc, ovc, oac
    torch.cuda.empty_cache()
    _, fplan, fcost = attitude.build_full(env, device=dev, lane_mode="plan")
    bk4 = b6.Backup6D(fplan, fcost, argmin_dtype=torch.uint8,
                      carry_padded=True, consume_plan=True)
    del fplan, fcost
    cube0 = getattr(b4, "cube_launches", 0)
    out["b4_ms"] = cuda_time_ms(lambda: b4(
        v, bk4.args, out_v=ov, out_a=oa), repeats=5)
    out["b4_cube_launches"] = getattr(b4, "cube_launches", 0) - cube0
    del bk4, v, ov, oa
    torch.cuda.empty_cache()
    print(f"{opts.label}: kernels {json.dumps(out)}", flush=True)

    if not opts.skip_solves:
        _, out["solve_11x10_s"] = wall(lambda: attitude.solve_full(cfg))
        with tempfile.TemporaryDirectory() as tmp:
            _, out["envelope_100_s"] = wall(lambda: attitude.solve_full(
                env, num_sweeps=100, segment_size=50,
                checkpoint_path=str(Path(tmp) / "envelope.npz"), tol=1e-6,
                tol_mode="rel"))
        torch.cuda.empty_cache()
        sweeps = cfg.n_stage - 1
        mesh2 = make_mesh(("s",), (2,))
        mesh23 = make_mesh(("s", "a"), (2, 3))
        _, out["halo6_2_s"] = wall(lambda: value_iteration_finite_halo6(
            plan, cost, sweeps, mesh2))
        _, out["halo6_2x3_s"] = wall(lambda: value_iteration_finite_halo6(
            plan, cost, sweeps, mesh23, action_axis_name="a"))

        def traced(key, fn):
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                _, s_ = wall(fn)
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in rows)
            k6 = [e for e in rows if "backup6d_sweep" in e.key]
            k_us = sum(e.self_device_time_total for e in k6)
            n = sum(e.count for e in k6)
            out[f"{key}_traced_s"] = s_
            out[f"{key}_busy_share"] = busy / (s_ * 1e6)
            out[f"{key}_kernel_ms"] = k_us / max(n, 1) / 1e3
            out[f"{key}_kernel_launches"] = n

        traced("solve_11x10", lambda: attitude.solve_full(cfg))
        traced("halo6_2", lambda: value_iteration_finite_halo6(
            plan, cost, 1000, mesh2))
        traced("halo6_2x3", lambda: value_iteration_finite_halo6(
            plan, cost, 1000, mesh23, action_axis_name="a"))
    print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
