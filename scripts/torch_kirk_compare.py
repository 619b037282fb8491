#!/usr/bin/env python3
"""Time the Kirk main path's kernel (B.1) and the Kirk solves on one CUDA
device, for one tree of the repository.

    python3 scripts/torch_kirk_compare.py [--tree DIR] [--label NAME]

Imports ``ocdp_tpu_torch`` from ``DIR`` (default: this checkout) and builds
that tree's kernels, so two trees (for instance this one and a ``git
archive`` of its parent under the gitignored ``build/``) are timed by the
same code: run parent, change, change, parent, one process each, in one
call on one card. Prints the card's name and power limit, then one line
``RESULT <json>`` per run. Works on trees with B.1's plan-streamed mode
only and on trees that also have its affine-query mode.

Timed at ``KirkConfig()`` (100 x 100 states, 1000 controls, 199 sweeps):

* B.1 through its wrapper, back to back (CUDA events, warm, median of
  10): the plan-streamed mode (``streamed_ms``) and, where the tree has
  it, the affine mode (``affine_ms``, outputs given);
* B.1's device time a sweep under ``torch.profiler`` over 20 wrapper calls
  of the mode ``kirk.solve`` runs (``sweep_device_ms``: every B.1 kernel a
  sweep launches, the streamed mode's partial pass and its combine pass);
* the bench twin's ``kirk`` family (``ocdp_tpu_torch.bench.bench_kirk``:
  199 sweeps without policies, warm wall, evals/s, launches);
* ``kirk.solve(KirkConfig())`` (policies stored, builds included): host
  clock around calls that end in a synchronize, three calls (the first
  cold), then one under ``torch.profiler``: the device busy share, the
  kernel events a sweep by name, and B.1's device time in it;
* where the tree's affine mode has stages (``fb.STAGE_CHUNKS``): B.1 at
  ``KirkConfig()`` in each stage the tree has, the stage set on the
  parameter block (``stage_ms``: CUDA events, three rounds interleaved
  over the stages; ``stage_device_ms``: the device time a launch over 20
  calls, two rounds; ``stages_bitwise``: every stage's sweep equals the
  one ``_stage`` picks), and B.1 at ``KirkConfig(dx=900)``, whose planned
  rows outgrow shared memory (``dx900_ms``, ``dx900_stage``).

Needs a CUDA device.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="this tree")
    opts = ap.parse_args()
    sys.path.insert(0, str(Path(opts.tree).resolve()))

    import numpy as np
    import torch

    from ocdp_tpu_torch import _build
    from ocdp_tpu_torch import bench as tbench
    from ocdp_tpu_torch.models import kirk
    from ocdp_tpu_torch.ops import fused_backup2d as fb
    from ocdp_tpu_torch.profiling import cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{opts.label}: {fb.__file__} on [{smi}]", flush=True)
    dev = torch.device("cuda")
    out = {"label": opts.label, "card": smi}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    affine = hasattr(fb, "fused_backup2d_affine_cuda")
    b1_names = ("affine_sweep",) if affine else ("backup_partial",
                                                 "combine_splits")

    def device_rows(prof):
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    def b1_time(rows):
        return sum(e.self_device_time_total for e in rows
                   if any(n in e.key for n in b1_names))

    t0 = time.perf_counter()
    _build.load()
    out["build_s"] = time.perf_counter() - t0

    cfg = kirk.KirkConfig()
    sweeps = cfg.N - 1
    p = kirk.build(cfg, device=dev)
    streamed = fb.FusedBackup2D(
        p.plan, p.stage_cost,
        cost_terms=kirk._separable_cost_terms(cfg, device=dev))
    v = torch.from_numpy(np.random.default_rng(0).uniform(
        0.0, 400.0, (cfg.dx, cfg.dx)).astype(np.float32)).to(dev)
    out["streamed_ms"] = cuda_time_ms(lambda: streamed(v), inner=20)
    solve_sweep = lambda: streamed(v)  # noqa: E731  (the parent's solve)
    if affine:
        args = kirk.affine_backup(cfg, dev).args
        ov = torch.empty_like(v)
        oa = torch.empty(v.shape, dtype=torch.int32, device=dev)

        def solve_sweep():
            fb.fused_backup2d_affine_cuda(v, args, ov, oa)

        out["affine_ms"] = cuda_time_ms(solve_sweep, inner=20)
    solve_sweep()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            solve_sweep()
        torch.cuda.synchronize()
    out["sweep_device_ms"] = b1_time(device_rows(prof)) / 20 / 1e3
    del p, streamed

    fam = tbench.bench_kirk(dev)
    out["bench_kirk"] = {k: fam[k] for k in ("wall_s", "evals_per_s",
                                              "compile_s", "launches",
                                              "impl", "alternatives")}

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kirk.solve(cfg, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["solve_s"] = walls
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kirk.solve(cfg, device=dev)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    rows = device_rows(prof)
    out["solve_traced_s"] = traced
    out["solve_busy_share"] = sum(e.self_device_time_total
                                  for e in rows) / (traced * 1e6)
    out["solve_b1_ms_a_sweep"] = b1_time(rows) / sweeps / 1e3
    names = Counter()
    for e in rows:
        names[e.key.replace("(anonymous namespace)::", "")
              .split("(")[0][-40:]] += e.count
    out["solve_kernel_events"] = dict(names.most_common(6))
    if hasattr(fb, "STAGE_CHUNKS"):
        stage_times(fb, kirk, cfg, v, dev, out, device_rows, acts)
    print("RESULT " + json.dumps(out), flush=True)


def stage_times(fb, kirk, cfg, v, dev, out, device_rows, acts) -> None:
    """B.1 at ``cfg`` in each stage the tree has, and at
    ``KirkConfig(dx=900)`` in the stage it takes; into ``out``."""
    import numpy as np
    import torch

    from ocdp_tpu_torch.profiling import cuda_time_ms

    base = kirk.affine_backup(cfg, dev).args
    chunk = min(fb.CHUNK_ACTIONS, base.actions_per_split)
    stages = {}
    for name in ("STAGE_ALL", "STAGE_CHUNKS", "TABLE_GLOBAL"):
        if hasattr(fb, name):
            stage = getattr(fb, name)
            stages[name] = dataclasses.replace(
                base, stage=stage, _launch=None,
                chunk=0 if name == "STAGE_ALL" else chunk)
    out["default_stage"] = base.stage
    out["stage_smem"] = {k: a.smem_bytes for k, a in stages.items()}
    ov = torch.empty_like(v)
    oa = torch.empty(v.shape, dtype=torch.int16, device=dev)
    want = fb.fused_backup2d_affine_cuda(v, base)
    same = {}
    for name, a in stages.items():
        fb.fused_backup2d_affine_cuda(v, a, ov, oa)
        same[name] = (torch.equal(ov, want.values)
                      and torch.equal(oa.int(), want.argmin))
    out["stages_bitwise"] = same
    out["stage_ms"] = {k: [] for k in stages}
    out["stage_device_ms"] = {k: [] for k in stages}
    for r in range(3):
        for name, a in stages.items():
            def sweep(a=a):
                fb.fused_backup2d_affine_cuda(v, a, ov, oa)
            out["stage_ms"][name].append(cuda_time_ms(sweep, inner=20))
            if r == 2:
                continue
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(20):
                    sweep()
                torch.cuda.synchronize()
            out["stage_device_ms"][name].append(
                sum(e.self_device_time_total for e in device_rows(prof)
                    if "affine_sweep" in e.key) / 20 / 1e3)
    big = kirk.KirkConfig(dx=900)
    args = kirk.affine_backup(big, dev).args
    bv = torch.from_numpy(np.random.default_rng(1).uniform(
        0.0, 400.0, (big.dx, big.dx)).astype(np.float32)).to(dev)
    bov = torch.empty_like(bv)
    boa = torch.empty(bv.shape, dtype=torch.int16, device=dev)
    out["dx900_stage"] = args.stage
    out["dx900_smem"] = args.smem_bytes
    out["dx900_ms"] = cuda_time_ms(
        lambda: fb.fused_backup2d_affine_cuda(bv, args, bov, boa), inner=5)


if __name__ == "__main__":
    main()
