#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA device and
the CUDA toolkit (nvcc). Phases, each of which raises on failure:

1. check the device and print its name and power limit (nvidia-smi);
2. build the CUDA kernels from ``ocdp_tpu_torch/csrc`` (timed), and time
   ``nvcc`` on ``csrc/backup6d.cu`` alone;

Kirk ch.3 (kernel ``fused_backup2d``, B.1, in two modes: plan-streamed, and
affine-query, the main path's, which forms ``x' = A x + B u`` in the
kernel, one launch a sweep):

3. one sweep of each mode vs its plain PyTorch version on the same inputs,
   and the affine kernel vs the streamed kernel on ``kirk.build``'s plan, at
   the golden and the full Kirk size, at a full size with negative ``B``
   and one with a zero ``B`` entry and negated ``A``, on a crafted
   exact-tie plan (streamed) and on the golden controls listed twice
   (affine): values and argmin bitwise, the affine argmin also as int16 and
   uint8; then the affine kernel's other two stages at the configurations
   that need them: ``KirkConfig(du=20000)`` (the action records staged in
   chunks; also against the streamed kernel), ``KirkConfig(dx=900)`` and
   ``KirkConfig(dx=300, B=(2.0, 0.0539))`` (the table read from global
   memory), against the plain version bitwise;
4. the full solve, ``kirk.solve(KirkConfig(), device='cuda')`` (100x100
   states, 1000 controls, 199 sweeps, policies stored): the affine kernel
   launches exactly 199 times and no other backup kernel runs, and values
   and every stored policy equal ``impl='gather'`` bitwise; then the
   plan-streamed mode through the same engine the same way (199 launches);
   then ``kirk.solve`` (auto) at the three configurations above: 199
   launches of the affine kernel each and no other backup kernel, no NaN
   in the values, and, sweep by sweep, values and policies equal to its
   plain version through the same engine bitwise over every sweep whose
   values are finite (printed: each version's first sweep with a
   non-finite value and the first sweep that differs; du=20000 stays
   finite, the other two overflow f32 in both versions);
5. the golden solve on the card against MATLAB truth
   (tests/golden/obj1_reference.npz, tests/test_golden.py's tolerances) and
   the stored golden solve and rollout (tests/golden/kirk_golden.npz);
6. timing with CUDA events, warm, median of 10: one full-size sweep of each
   mode and of its plain version (back-to-back calls), the affine launch
   replayed as a CUDA graph, the 199-sweep loops (policies stored; and the
   affine one without policies, through CUDA graphs), and the full solves
   with their builds; one sweep of the chunked and the table-from-global
   stages at their configurations beside their bounds, with each stage's
   shared memory, occupancy and ptxas lines.

Coupled position+attitude (kernel ``rowlane_backup``):

7. one sweep of the row/lane kernel vs its plain version for the four
   channels (x, y, z, x_failure) at ``PosAttConfig()`` and ``high_res()``,
   each alone and the four in one launch (x_failure's 6 actions among
   9-action channels), each channel of the batch also against its own
   launch; 50 sweeps of the four channels replayed as one CUDA graph
   against the same sweeps as eager launches; an exact-tie case (every
   action listed twice); past 20 row combos, the 40-combo kernel (kind 3):
   the x, z and x_failure channels of ``PosAttConfig(n_mesh_w=120)`` (35,
   35 and 31 combos; y's 41 exceed the TPU kernel's 40 too) each alone,
   and the four channels of ``n_mesh_w=100`` (30-35 combos) alone and in
   one launch; past 32 row combos with other lane taps, the any-tap
   40-combo kernel (kind 4): simplified attitude axis 0 at
   ``AttitudeConfig(n_mesh_w=1400)`` (33 combos, lane taps -2..2): bitwise
   equal;
8. the main path, ``pos_att.solve(PosAttConfig(), device='cuda')`` (the
   four channels in lockstep, one launch a sweep, the 50 sweeps between
   two checks one CUDA graph): the kernel launches exactly 1999 times for
   7996 channel-sweeps (the channels' summed sweeps) and no other backup
   kernel runs; values, argmin, sweeps, stop flags and check logs equal
   ``impl='rowlane'`` (the plain version through the same engine)
   bitwise, and the x channel at 200 sweeps meets
   tests/golden/pos_att_channel_golden.npz;
9. serving: the 10 s rk4 flight, a fleet of 256 seeded flights (lanes equal
   their single flights bitwise), a 1 s ode45 flight; forces in {0, +-0.13}
   and |x| shrinking;
10. the high-resolution solve (``PosAttConfig.high_res()``, 3 channels)
    through the kernel, timed, its launches and channel-sweeps counted;
    ``pos_att.solve(PosAttConfig(n_mesh_w=100))`` through the 40-combo
    kernel, its launches and channel-sweeps counted, and its first 50
    sweeps equal to ``impl='rowlane'`` bitwise;
11. timing with CUDA events, warm, median of 10: the four channels' sweep
    in one launch, the kernel alone (20 launches replayed as a CUDA graph)
    and through the wrapper, the x channel alone, and the plain version, at
    the reference size, ``high_res()`` and ``n_mesh_w=100`` (the 40-combo
    kernel; its x channel alone at ``n_mesh_w=120`` too; the any-tap
    40-combo kernel on phase 7's simplified axis), with the tile
    plan's dynamic shared memory, the occupancy and each instantiation's
    ptxas line; the full reference solve, a 1 s rk4 flight and the fleet's
    flight-seconds per second.

Full 6-D attitude (kernel ``backup6d``), at the reference's historical
``AttitudeConfig(n_mesh_w=11, n_mesh_q=10)`` (11^3 x 10^3 cells, 27
torques, 5999 sweeps):

12. one sweep of the 6-D kernel vs its plain version: a seeded random table
    and the table after 50 sweeps at 11^3 x 10^3, 5^3 x 4^3, an exact-tie
    case (h = 0, no cost), ``edge='clamp'``, a permuted action order (the
    generic action phase), and the shared-memory tiles' edges: the
    11^3 x 10^3 sweep's first and last row tiles, clipped at the table's
    top and bottom, and its 1000 lanes, not a multiple of the tile's; a
    10-row block with no halo rows, whose tiles are each clipped at both
    edges: values and argmin bitwise equal;
13. the main path, ``attitude.solve_full(AttitudeConfig(n_mesh_w=11,
    n_mesh_q=10))`` on the default device over the full 5999 sweeps: the
    kernel's launch count goes up by exactly 5999, the values are finite;
    a 50-sweep solve through the kernel equals ``impl='plain'`` bitwise;
14. the segmented solve with the stop rule (``segment_size=50,
    tol=1e-2``) against ``value_iteration_converged(check_every=50,
    tol=1e-2)``: same sweep count and stop flag, bitwise values; a solve
    killed after its checkpoint at sweep 100 and resumed from
    ``load_values`` equals the uninterrupted one bitwise;
15. serving: the 11^3 x 7^3 policy (1000 sweeps) damps the (5, 10, -9) deg
    start over 4000 stages (mean |Euler angle| of the last 200 < 4 deg,
    mean |omega| < 6 deg/s); the 5999-stage nearest rollout of the main
    path's solution, timed; one 'interp' rollout;
16. timing: the kernel and plain sweeps at 11^3 x 10^3 (CUDA events, warm,
    median of 10), the solves' wall times, the rollout time per stage, peak
    device memory, the kernel's registers, static shared memory and spills
    from the build log, and beside them the dynamic shared memory a launch
    asks for (the tile planner), its tile and its occupancy.

The 6-D envelope (kernels ``backup6d_flat``, B.4, and
``backup6d_recompute``, B.5), past 8M cells:

17. one sweep of B.4 and B.5 vs their plain versions at 19^3 x 14^3
    (18.8M cells): int32 and uint8 argmin, min-only (values of the tracking
    sweep, all-zero argmin), lane recompute, ``edge='clamp'``; six
    carry-mode sweeps vs six allocating ones: bitwise; at 11^3 x 10^3 a
    forced ``flat=True, carry_padded=True`` 50-sweep solve equals the
    non-flat (B.3) solve bitwise;
18. the main path, ``attitude.solve_full(AttitudeConfig(n_mesh_w=30,
    n_mesh_q=16), num_sweeps=100, segment_size=50, checkpoint_path=...,
    tol=1e-6, tol_mode='rel')`` (the README's envelope quick start, 110.6M
    cells, 100 of its 5999 sweeps): auto picks the recompute plan, flat
    carry-mode tables and a uint8 argmin, and B.5 launches 100 times, each
    through ``backup6d_sweep_recompute_cube`` (the full tap cube); a solve
    killed after its first checkpoint past sweep 50 and resumed equals it
    bitwise; the same solve with ``lane_mode='plan'`` (the chunked build,
    B.4, 100 launches) agrees to 1e-4 x max|V| with >= 99.9% equal argmins;
    the chunked build equals the one-shot flat build bitwise; a lane plan
    filled from the plain recompute, swept once by B.4 (``backup6d_sweep``),
    equals one B.5 sweep of the same table (``backup6d_sweep_recompute_
    cube``) bitwise (the kernel's recomputed lanes are the plain version's
    on every cell), and its live taps lie in B.5's admitted ones;
19. serving: a 1000-stage flat-argmin rollout of that solution;
20. past 2^31 cells: ``solve_full(AttitudeConfig(n_mesh_w=60,
    n_mesh_q=22), num_sweeps=1, init_values=...)`` (2.30B cells, B.5) from
    a seeded table: build seconds, seconds per sweep, peak device memory;
    its last output rows, at flat offsets past 2^31, equal the plain
    version of their row block (``block_args``) on those rows' local
    table, bitwise;
21. timing with CUDA events, warm, median of 10: B.4 (uint8, tracking) and
    B.5 at 30^3 x 16^3 beside their bounds and B.3's ns per cell, with
    each mode's registers, shared memory and occupancy; B.5 at the
    envelope cell's 48^3 x 10^3 (median of 5) beside its bound, every
    launch through ``backup6d_sweep_recompute_cube``; that timed sweep's
    first, a middle and its last 97 rows equal the plain version of their
    row blocks bitwise, and a lane plan filled from the plain recompute,
    swept once by B.4, equals one B.5 sweep of the same table bitwise on
    every cell (as in phase 18).

Simplified attitude and position (kernel ``band_backup2d``, B.6):

22. one sweep of the banded kernel vs its plain version: the three
    simplified axes at ``AttitudeConfig()`` (1000 x 300) with
    ``edge='clamp'`` and ``'extrapolate'``, position's C = 3 channel batch
    at ``PositionConfig()`` (201 x 201), each on a seeded random table and
    on the table after 50 sweeps, and an exact-tie case (h = 0, no cost,
    each action listed twice); the three axes in one launch (each axis
    also against its own launch), position's factorized cost (three
    terms) against its dense one, and 100 sweeps of the three axes
    replayed as one CUDA graph against eager launches: values and argmin
    bitwise equal;
23. the main path, ``attitude.solve_simplified(AttitudeConfig())`` on the
    default device (the three axes as one batch, 5999 sweeps, replayed
    100 at a time as CUDA graphs): exactly 5999 launches for 17,997
    channel-sweeps and no other backup kernel launches, the values are
    finite, a 250-sweep solve equals ``impl='plain'`` bitwise, and the
    300-sweep ``edge='extrapolate'`` solve meets
    tests/golden/attitude_axis_golden.npz within the JAX package's own
    gather distance;
24. serving on that policy: the simplified-plant rollout and the rk4 real-
    dynamics rollout over the full horizon, a 200-stage ode45 flight and
    the PD baseline, each timed per stage;
25. ``position.solve(PositionConfig())`` (factorized cost, graphs):
    5999 sweeps, 5999 launches for 17,997 channel-sweeps, a 250-sweep
    solve equal to ``impl='plain'`` bitwise, the 300-sweep golden
    (tests/golden/position_golden.npz), and a 1 s RKF45 flight whose
    controls equal a nearest lookup at every stage, timed;
26. timing with CUDA events, warm, median of 10: the banded kernel alone
    (20 launches replayed as a CUDA graph) and through the wrapper, and
    its plain version, for the three axes in one launch, one axis and 3 x
    201 x 201, beside the bound, the ported row-band backup and the
    row/lane kernel (B.2) on the same simplified axis, the two main
    solves' wall times, and the kernel's ptxas lines.

The multi-rank engines (kernel ``backup6d`` in its B.7 modes, wrappers
``backup6d_block`` and ``backup6d_slice``) on in-process meshes of ranks on
the one card (NCCL across cards is not exercised here):

27. B.7 vs its plain version: the row blocks of 2 and 4 ranks at 11^3 x
    10^3 (random table and the table after 50 sweeps; int32, uint8 and
    min-only), of 2 ranks at 19^3 x 14^3 on the flat (B.4) and recompute
    (B.5) plans, each of the 3 digit slices of the whole table and of each
    2-rank block (the 2 x 3 main path's shapes), a block with halo rows of
    the table on both sides, and an exact-tie case: bitwise; the 3 slices
    combined by the first minimum equal one B.3 sweep (whole table) or the
    block's B.7 sweep (each block) bitwise;
28. the main path, ``value_iteration_finite_halo6`` at 11^3 x 10^3 on 2
    ranks over the full 5999 sweeps: ``backup6d_block`` launches exactly 2 x
    5999 times and no other backup kernel runs; values and argmin equal
    phase 13's one-device solve bitwise; the halo bytes moved equal the
    analytic count;
29. the 2 x 3 mesh (rows x digit slices) over 5999 sweeps, with the digit
    path asserted and ``backup6d_slice`` launched 6 x 5999 times, bitwise
    equal to phase 13; the 1-D and 2-D converged engines against phase
    14's (``check_every=50, tol=1e-2``): same sweep count and stop flag,
    bitwise tables; 4 ranks over 200 sweeps with uint8 policies;
30. the envelope over the mesh: 30^3 x 16^3 on the recompute plan, 2 ranks,
    10 sweeps, bitwise equal to one-device B.5; the width guard raising on
    11 ranks;
31. the replicated-table engine (Kirk, 2 x 2), the halo engine with B.6 (a
    simplified axis, 2 ranks), ``pos_att.solve_channel_sharded`` (both
    engines) and ``pos_att.solve_ep`` against their one-device solves, and
    the dryrun twin ``dryrun_multichip(8)``;
32. timing with CUDA events, warm, median of 10: one B.7 block call and one
    slice call beside their plain versions and bounds, with their shared
    memory and occupancy, and one halo6 sweep on 2 ranks and on 2 x 3.

The surface (``profiling.trace``, ``graft_entry``, the CLI, the bench):

33. ``profiling.trace`` around the full Kirk solve: the Chrome trace holds
    as many ``affine_sweep`` kernel events (B.1's affine mode) as its launch
    counter counts, 199, and no ``combine_splits`` event;
34. ``graft_entry.entry()`` on the card: its step launches B.1's affine
    mode once a call and equals the plain version on the same inputs
    bitwise (the zero table and a seeded one);
35. the CLI in subprocesses: ``solve kirk`` prints the in-process solve's
    ``values_sum``; ``solve attitude-full --n-mesh-w 11 --n-mesh-q 10
    --segment-size 50 --checkpoint ...`` stopped after its first segment
    (``--sweeps 50``) and resumed with ``--sweeps 100 --resume`` equals the
    straight 100-sweep run bitwise; ``--resume`` without ``--checkpoint``
    exits non-zero;
36. ``python -m ocdp_tpu_torch.bench`` over six families (all but the two
    with long flights), run beside phase 35's processes (its times are
    not measurements here): exit 0, the last line parses with the
    contract's keys, no family holds an ``error`` and each family's kernel
    launched (``kirk``: the affine mode, 199 launches);
37. the Kirk rollout ``kirk.optimal_path`` from (2, 1) timed on the card
    (warm, median of 5), golden and full configurations.

Past the default kernels' tap capacities, the structures the TPU kernel
takes up to its 40 live row and 40 live lane combos (B.2's any-tap kinds on
wide lane axes; the 6-D kernel's ``backup6d_wide``):

38. one sweep vs the plain version, bitwise: the three simplified axes of
    ``AttitudeConfig(n_mesh_t=1000)`` (1000 x 1000, lane taps -5..5, -7..7,
    -4..4) through B.2's kind 2; the 36-combo 6-D configuration (row taps
    (-1, 0, 1, 2) x (-1, 0, 1) x (-1, 0, 1), 15^3 x 10^3) through
    ``backup6d_wide`` by B.3's wrapper, B.4's (a flat plan, uint8 argmin),
    B.5's (the recompute plan) and B.7's (the 2 ranks' row blocks and
    their digit slices);
39. the main paths, ``attitude.solve_simplified(AttitudeConfig(
    n_mesh_t=1000), impl='rowlane')`` (3 x 5999 sweeps, one B.2 launch an
    axis a sweep: exactly 17,997 launches and no other backup kernel), held
    to the same configuration's ``auto`` (B.6) solve within rtol 2e-5 and
    an absolute 2e-5 x max |V| (the two sum orders part by up to 1.2e-4 of
    the value at cells of small |V| over 5999 sweeps), with over 99.95%
    equal torque tables; and
    ``attitude.solve_full`` of the 36-combo configuration (1499 sweeps:
    exactly 1499 launches of ``backup6d_wide`` through B.3's wrapper and no
    other backup kernel, finite values; 5 sweeps equal ``impl='plain'``
    bitwise), then a 1000-stage rollout of it;
40. timing: each axis's B.2 launch (a CUDA graph of 20) and ``backup6d_wide``
    (CUDA events) beside their bounds and plain versions, their ptxas lines,
    shared memory and occupancy, and the two solves' wall times.

The line before the last is a JSON object describing each kernel, with its
time beside its bound: the larger of its FP32 operations over 67 TFLOP/s
and its bytes (each input read once, each output written once) over
3.35 TB/s, the H100 SXM's published peaks, counted from this run's inputs.
The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the package beside this script, it exits non-zero and prints no
result.
"""

import contextlib
import dataclasses
import io as _io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ocdp_tpu_torch import _build, graft_entry, io, profiling
from ocdp_tpu_torch.engine import (GRAPH_SWEEPS, SweepGraph, ping_pong,
                                   value_iteration_converged,
                                   value_iteration_finite,
                                   value_iteration_segmented)
from ocdp_tpu_torch.models import attitude, kirk, pos_att, position
from ocdp_tpu_torch.ops import backup6d as b6
from ocdp_tpu_torch.ops import band_backup2d as bb
from ocdp_tpu_torch.ops import fused_backup2d as fb
from ocdp_tpu_torch.ops import rowlane as rl
from ocdp_tpu_torch.ops.rowband import RowBandBackup2D
from ocdp_tpu_torch.ops.interp import InterpPlan, PlanShape, build_plan
from ocdp_tpu_torch.profiling import cuda_time_ms

ROOT = Path(__file__).resolve().parent
GOLDEN_DIR = ROOT / "tests" / "golden"
SEED = 0
# the H100 SXM's published peaks: FP32 outside the tensor cores, HBM3
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
SM_MAX_THREADS = 2048          # resident threads an H100 SM holds


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take for the work: the larger of the
    operations over the FP32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


def kernel_args(bk, v):
    return (v, bk.lo0, bk.lo1, bk.f0, bk.f1, bk.cost, bk.state_cost,
            bk.action_cost)


def separable_backup(problem, cfg, device):
    return fb.FusedBackup2D(
        problem.plan, problem.stage_cost,
        cost_terms=kirk._separable_cost_terms(cfg, device=device))


def kernel_vs_plain(bk, v, label: str) -> float:
    """One sweep through the kernel and through the plain version on the
    same inputs; both must agree bitwise. Returns max |dV|."""
    got = fb.fused_backup2d_cuda(*kernel_args(bk, v))
    want = fb.fused_backup2d_plain(*kernel_args(bk, v))
    torch.cuda.synchronize()
    err = float((got.values - want.values).abs().max())
    same_v = torch.equal(got.values, want.values)
    same_a = torch.equal(got.argmin, want.argmin)
    print(f"{label}: values bitwise {same_v}, argmin identical {same_a}, "
          f"max |dV| {err}")
    check(bool(torch.isfinite(got.values).all()), f"{label}: non-finite")
    check(same_v and same_a, f"{label}: kernel != plain version")
    return err


def graph_time_ms(fn, n: int = 20, repeats: int = 10) -> float:
    """Device milliseconds a call of ``fn`` with the host out of the way:
    ``n`` calls captured into one CUDA graph, its replays timed with CUDA
    events (median of ``repeats``), over ``n``. ``fn`` must allocate
    nothing and set no function attribute (call it once first)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return cuda_time_ms(g.replay, inner=1, repeats=repeats) / n


def ptxas_lines(name: str) -> list:
    """The ptxas line of every instantiation of kernel ``name``."""
    log = _build.library_path().with_suffix(".log").read_text()
    out = []
    for b in log.split("Compiling entry function")[1:]:
        head = b.split("\n", 1)[0]
        if name not in head:
            continue
        regs = re.search(r"Used (\d+) registers", b)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", b)
        stack = re.search(r"(\d+) bytes stack frame", b)
        inst = re.search(r"(ILb[01]ELi\d+|I[a-z]?Li\d+)", head)
        out.append(f"{name}{'<' + inst.group(1) + '>' if inst else ''}: "
                   f"{regs.group(1)} registers, "
                   f"{stack.group(1) if stack else 0} B stack frame, "
                   f"{spill.group(1)} B spill stores, {spill.group(2)} B "
                   "spill loads")
    if not out:
        raise RuntimeError(f"chip_smoke: {name} not in the build log")
    return out


def main() -> None:
    phase("1. device")
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device "
                           "(torch.cuda.is_available() is false)")
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")

    phase("2. build")
    t0 = time.perf_counter()
    _build.load()
    print(f"built {_build.library_path().name} in "
          f"{time.perf_counter() - t0:.3f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                        str(Path(tmp) / "backup6d.o"),
                        str(_build.CSRC / "backup6d.cu")],
                       check=True, capture_output=True, timeout=900)
        print(f"nvcc on csrc/backup6d.cu alone: "
              f"{time.perf_counter() - t0:.3f} s")

    kernels = [*kirk_phases(device), *pos_att_phases(device)]
    b3 = attitude_phases(device)
    kernels += [b3, *envelope_phases(device, b3)]
    free_cuda()
    kernels.append(band_phases(device))
    free_cuda()
    kernels += multirank_phases(device)
    free_cuda()
    surface_phases(device)
    free_cuda()
    kernels += wide_tap_phases(device)
    for k in kernels:
        print(f"{k['name']}: {k['ms']:.4f} ms per sweep vs bound "
              f"{k['bound_ms']:.4f} ms ({k['bound_by']}: {k.pop('flops'):.4e} "
              f"FP32 operations, {k.pop('bytes'):.4e} bytes), plain "
              f"{k['plain_ms']:.4f} ms, {k['launches']} launches on the main "
              "path")
    print(f"chip_smoke: all phases in {time.perf_counter() - _START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


LAUNCHERS = {"fused_backup2d": fb.fused_backup2d_cuda,
             "fused_backup2d_affine": fb.fused_backup2d_affine_cuda,
             "rowlane_backup": rl.rowlane_backup_cuda,
             "backup6d": b6.backup6d_cuda,
             "band_backup2d": bb.band_backup2d_cuda}


def reset_launch_counts() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0
        for counter in ("channel_sweeps", "cube_launches"):
            if hasattr(fn, counter):
                setattr(fn, counter, 0)


def launch_counts() -> dict:
    """Each launcher's launches, and the 6-D launches of the cube body."""
    return {**{name: fn.launches for name, fn in LAUNCHERS.items()},
            "backup6d_cube": b6.backup6d_cuda.cube_launches}


STAGE_NAMES = {fb.STAGE_ALL: "every record staged",
               fb.STAGE_CHUNKS: "records in chunks",
               fb.TABLE_GLOBAL: "table from global memory"}


def affine_vs(aff, bk, v, label: str) -> float:
    """One sweep of the affine kernel (B.1's affine-query mode) against its
    plain version and against the plan-streamed kernel on the same inputs:
    ``bk``'s plan (``kirk.build``'s), or, with ``bk`` None, the plan the
    affine mode forms (``fb.affine_plan``), or, with ``bk`` False, none (it
    stages the whole table, at most 241 x 241). Values and argmin bitwise,
    the argmin also in each narrower width the kernel writes. Returns max
    |dV| against the plain version."""
    args = aff.args
    got = fb.fused_backup2d_affine_cuda(v, args)
    want = fb.fused_backup2d_affine_plain(v, args)
    if bk is False:
        streamed = want
    elif bk is None:
        streamed = fb.fused_backup2d_cuda(
            v, *fb.affine_plan(args, v.device),
            state_cost=args.state_cost, action_cost=args.action_cost)
    else:
        streamed = fb.fused_backup2d_cuda(*kernel_args(bk, v))
    narrow = [torch.int16] + ([torch.uint8] if args.n_actions <= 256 else [])
    same_narrow = True
    for dt in narrow:
        ov = torch.empty_like(v)
        oa = torch.empty(v.shape, dtype=dt, device=v.device)
        fb.fused_backup2d_affine_cuda(v, args, ov, oa)
        same_narrow &= (torch.equal(ov, want.values)
                        and torch.equal(oa.to(torch.int32), want.argmin))
    torch.cuda.synchronize()
    err = float((got.values - want.values).abs().max())
    same = (torch.equal(got.values, want.values)
            and torch.equal(got.argmin, want.argmin))
    same_s = (torch.equal(got.values, streamed.values)
              and torch.equal(got.argmin, streamed.argmin))
    print(f"{label}, affine mode ({args.row0.numel()} blocks of "
          f"{args.threads} threads, {STAGE_NAMES[args.stage]}, "
          f"{args.smem_bytes} B of shared memory, up to {args.max_rows} "
          f"table rows): == plain bitwise {same}, == streamed kernel "
          f"bitwise {same_s if bk is not False else 'not compared'}, argmin "
          f"as {[str(d) for d in narrow]} too {same_narrow}, max |dV| {err}")
    check(bool(torch.isfinite(got.values).all()), f"{label}: non-finite")
    check(same and same_s and same_narrow,
          f"{label}: affine kernel != plain version or streamed kernel")
    return err


def affine_bound(args) -> dict:
    """The affine sweep's least time from its shapes. Operations: 26 an
    evaluation (the two queries' sums 2; the walk's edge compares 4; two
    numerators and two divides 4; the complements 2; four weights, four
    weighted corners and three sums 11; the cost's two sums 2; the compare
    1), 6 a cell for its two P_k and its splits' compares, and the 2 * A
    products b_k * u of each block. Bytes: the table, the axes, the
    controls, the two cost parts and the row plan read once; the values and
    the int32 argmin written."""
    n0, n1 = args.grid_shape
    s, a, blocks = n0 * n1, args.n_actions, args.row0.numel()
    flops = 26.0 * s * a + (6 + args.n_splits - 1) * s + 2.0 * a * blocks
    row_plan = 8 * blocks if args.stage != fb.TABLE_GLOBAL else 0
    nbytes = 4 * (s + n0 + n1 + a + s + a) + row_plan + 8 * s
    return bound(flops, nbytes)


# the configurations past the default stage's shared memory, each with the
# stage it takes: the action records staged in chunks (du=20000), the table
# read from global memory (dx=900, whose planned rows outgrow shared
# memory; dx=300 with B=(2.0, 0.0539)). Each kirk.solve is held to its plain
# version through the same engine, sweep by sweep, bitwise over every sweep
# whose values are finite. Both table-from-global configurations overflow
# f32 in either version: dx=300's queries reach far off its grid (B_0 u
# spans 100 units of a 5.5-unit axis), and dx=900's edge cells extrapolate
# over a grid step 9 times finer than the default's, so their weights run
# to thousands. At the sweep whose values first overflow, a candidate turns
# NaN (inf - inf) and the kernel's NaN rule (a NaN never wins) and
# PyTorch's (a NaN propagates) part. The first of each stage is its
# kernels-line entry.
C1_CONFIGS = (("du=20000", kirk.KirkConfig(du=20000), fb.STAGE_CHUNKS),
              ("dx=900", kirk.KirkConfig(dx=900), fb.TABLE_GLOBAL),
              ("dx=300, B=(2.0, 0.0539)",
               kirk.KirkConfig(dx=300, B=(2.0, 0.0539)), fb.TABLE_GLOBAL))


def sweep_readings(got, want) -> tuple:
    """``(kernel's first non-finite, plain's first non-finite, first
    differing)``: the 1-based sweeps at which each chain's values first
    hold a non-finite entry, and at which the two chains' values or
    argmins first differ (NaN equal to NaN); None where there is none."""
    pk, pp = got.probes, want.probes
    same = (((pk == pp) | (pk.isnan() & pp.isnan())).flatten(1).all(1)
            & (got.policies.long() == want.policies.long())
            .flatten(1).all(1))

    def first(ok):
        bad = torch.nonzero(~ok)
        return int(bad[0]) + 1 if bad.numel() else None

    return (first(torch.isfinite(pk).flatten(1).all(1)),
            first(torch.isfinite(pp).flatten(1).all(1)), first(same))


def kirk_phases(device) -> list:
    """Phases 3-6; returns the kernels line's entries of B.1's two modes,
    the plan-streamed one and the affine one (the main path's)."""
    phase("3. B.1 vs plain, one sweep: the plan-streamed and affine modes")
    rng = np.random.default_rng(SEED)
    max_err = aff_err = 0.0
    full_cfg = kirk.KirkConfig()
    for label, cfg in (
            ("golden 35x35x100", kirk.KirkConfig.golden()),
            ("full 100x100x1000", full_cfg),
            ("full, negative B", dataclasses.replace(full_cfg,
                                                     B=(-0.0013, -0.0539))),
            ("full, zero B0 and negative A", dataclasses.replace(
                full_cfg, A=((-0.9974, 0.0539), (0.1078, -1.1591)),
                B=(0.0, 0.0539)))):
        p = kirk.build(cfg, device=device)
        v = torch.from_numpy(rng.uniform(0.0, 400.0, (cfg.dx, cfg.dx))
                             .astype(np.float32)).to(device)
        bk = separable_backup(p, cfg, device)
        f0, f1 = bk.f0, bk.f1
        print(f"{label}: fracs in [{float(torch.minimum(f0.min(), f1.min()))}"
              f", {float(torch.maximum(f0.max(), f1.max()))}]")
        max_err = max(max_err, kernel_vs_plain(bk, v, label))
        max_err = max(max_err, kernel_vs_plain(
            fb.FusedBackup2D(p.plan, p.stage_cost), v, label + " full cost"))
        aff_err = max(aff_err, affine_vs(kirk.affine_backup(cfg, device), bk,
                                         v, label))
        del p, bk
    # exact ties: actions 40..79 duplicate 0..39, so every minimum is tied
    axis = np.linspace(-1.0, 1.0, 6).astype(np.float32)
    base = rng.uniform(-1.2, 1.2, (2, 6, 6, 40)).astype(np.float32)
    q = np.concatenate([base, base], axis=-1)
    tie_plan = build_plan((axis, axis),
                          tuple(torch.from_numpy(x).to(device) for x in q))
    tie_bk = fb.FusedBackup2D(tie_plan, torch.zeros((6, 6, 80), device=device))
    tie_v = torch.from_numpy(rng.uniform(0, 1, (6, 6)).astype(np.float32)) \
        .to(device)
    max_err = max(max_err, kernel_vs_plain(tie_bk, tie_v, "exact ties"))
    tie_arg = fb.fused_backup2d_cuda(*kernel_args(tie_bk, tie_v)).argmin
    check(int(tie_arg.max()) < 40, "exact ties: a duplicate action won")
    # the affine exact ties: the golden controls listed forwards, then
    # backwards, so every query repeats and the walk turns back
    gcfg = kirk.KirkConfig.golden()
    s_r, u = kirk._meshes(gcfg)
    s_c, a_c = kirk._separable_cost_terms(gcfg, device=device)
    tie_aff = fb.AffineBackup2D(
        (s_r, s_r), np.concatenate([u, u[::-1]]), gcfg.A, gcfg.B, s_c,
        torch.cat([a_c, a_c.flip(0)]))
    tie_v = torch.from_numpy(rng.uniform(0.0, 400.0, (gcfg.dx, gcfg.dx))
                             .astype(np.float32)).to(device)
    aff_err = max(aff_err, affine_vs(tie_aff, None, tie_v,
                                     "affine exact ties"))
    tie_arg = fb.fused_backup2d_affine_cuda(tie_v, tie_aff.args).argmin
    check(int(tie_arg.max()) < gcfg.du,
          "affine exact ties: a duplicate action won")
    # the other two stages, at the configurations that take them
    c1 = {}
    for label, cfg, stage in C1_CONFIGS:
        aff = kirk.affine_backup(cfg, device)
        check(aff.args.stage == stage, f"{label}: stage {aff.args.stage}, "
              f"want {stage}")
        v = torch.from_numpy(rng.uniform(0.0, 400.0, (cfg.dx, cfg.dx))
                             .astype(np.float32)).to(device)
        aff_err = max(aff_err, affine_vs(aff, None if cfg.dx <= 241
                                         else False, v, label))
        c1[label] = {"aff": aff, "v": v}
        free_cuda()

    phase("4. full solve through the kernel (main path), and the streamed "
          "mode's solve")
    reset_launch_counts()
    t0 = time.perf_counter()
    sol = kirk.solve(full_cfg, device=device)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts.pop("fused_backup2d_affine")
    print(f"kirk.solve(KirkConfig()): {solve_s:.3f} s cold, {launches} "
          f"affine-mode launches, others {counts}")
    check(launches == full_cfg.N - 1,
          f"affine kernel launched {launches} times, want {full_cfg.N - 1}")
    check(not any(counts.values()), "another backup kernel launched")
    res = sol.result
    n = full_cfg.dx
    check(tuple(res.values.shape) == (n, n)
          and tuple(res.policies.shape) == (full_cfg.N - 1, n, n)
          and bool(torch.isfinite(res.values).all()),
          "full solve: wrong shape or non-finite values")
    ref = kirk.solve(full_cfg, device=device, impl="gather").result
    same_v = torch.equal(res.values, ref.values)
    same_p = torch.equal(res.policies, ref.policies)
    print(f"kernel solve vs gather solve: values bitwise {same_v}, "
          f"all {full_cfg.N - 1} policies identical {same_p}")
    check(same_v and same_p, "full solve: kernel != gather")
    max_err = max(max_err, float((res.values - ref.values).abs().max()))
    p = kirk.build(full_cfg, device=device)
    bk = separable_backup(p, full_cfg, device)
    reset_launch_counts()
    st = value_iteration_finite(p.plan, p.stage_cost, full_cfg.N - 1,
                                store_policies=True, backup=bk)
    torch.cuda.synchronize()
    counts = launch_counts()
    streamed_launches = counts.pop("fused_backup2d")
    same = (torch.equal(st.values, ref.values)
            and torch.equal(st.policies, ref.policies))
    print(f"plan-streamed solve: {streamed_launches} launches, others "
          f"{counts}; == gather bitwise {same}")
    check(streamed_launches == full_cfg.N - 1 and not any(counts.values())
          and same, "streamed solve: launches or values")
    del st, ref, p, bk
    for label, cfg, _ in C1_CONFIGS:
        reset_launch_counts()
        t0 = time.perf_counter()
        csol = kirk.solve(cfg, device=device).result
        torch.cuda.synchronize()
        c_s = time.perf_counter() - t0
        counts = launch_counts()
        n = counts.pop("fused_backup2d_affine")
        check(n == cfg.N - 1 and not any(counts.values()),
              f"{label}: affine launches {n} or another kernel launched")
        check(not bool(torch.isnan(csol.values).any()),
              f"{label}: a NaN won a minimum")
        c1[label]["launches"] = n
        aff = c1[label]["aff"]
        shape = PlanShape((cfg.dx,) * 2, (cfg.dx,) * 2 + (cfg.du,), device)
        full = ((0, cfg.dx), (0, cfg.dx))
        got = value_iteration_finite(shape, None, cfg.N - 1,
                                     store_policies=True, backup=aff,
                                     probe_window=full)
        check(torch.equal(got.values, csol.values)
              and torch.equal(got.policies, csol.policies),
              f"{label}: kirk.solve != the kernel through the engine")
        del csol
        want = value_iteration_finite(
            shape, None, cfg.N - 1, store_policies=True, probe_window=full,
            backup=lambda t, a=aff.args: fb.fused_backup2d_affine_plain(t, a))
        inf_k, inf_p, differ = sweep_readings(got, want)
        finite = min(x for x in (inf_k, inf_p, cfg.N) if x is not None) - 1
        print(f"kirk.solve(KirkConfig({label})): {c_s:.3f} s cold, {n} "
              f"affine-mode launches ({STAGE_NAMES[aff.args.stage]}), others "
              f"{counts}; against its plain version through the engine, "
              f"sweep by sweep (of {cfg.N - 1}): first sweep with a "
              f"non-finite value, kernel {inf_k}, plain {inf_p}; first sweep "
              f"that differs {differ}; max |V| of the last finite sweep "
              f"{float(want.probes[finite - 1].abs().max()):.4g}")
        check(differ is None or differ > finite,
              f"{label}: kernel solve != plain solve on a finite sweep")
        del got, want
        free_cuda()

    phase("5. golden solve vs MATLAB truth and the stored golden")
    gsol = kirk.solve(gcfg, device=device)
    with np.load(GOLDEN_DIR / "obj1_reference.npz") as z:
        mat = {k: z[k] for k in z.files}
    with np.load(GOLDEN_DIR / "kirk_golden.npz") as z:
        gold = {k: z[k] for k in z.files}
    vals = gsol.result.values.cpu().numpy()
    np.testing.assert_allclose(vals, mat["J_star"][:, :, 0],
                               rtol=1e-4, atol=1e-2)
    probes = value_iteration_finite(
        gsol.problem.plan, None, gcfg.N - 1,
        backup=kirk.affine_backup(gcfg, device),
        probe_window=((0, gcfg.dx), (0, gcfg.dx))).probes.cpu().numpy()
    np.testing.assert_allclose(
        probes, np.moveaxis(mat["J_star"][:, :, :gcfg.N - 1], 2, 0)[::-1],
        rtol=1e-4, atol=1e-2)
    diff = np.abs(gsol.u_star.cpu().numpy()
                  - np.moveaxis(mat["u_star"][:, :, :gcfg.N - 1], 2, 0))
    u_step = (mat["u_max"] - mat["u_min"]) / (mat["du"] - 1)
    exact = float((diff < 1e-4).mean())
    print(f"vs MATLAB: max |dV| "
          f"{float(np.abs(vals - mat['J_star'][:, :, 0]).max())}, "
          f"u* exact share {exact}, max |du*| {float(diff.max())}")
    check(exact > 0.999 and diff.max() < 1.5 * u_step, "u* vs MATLAB")
    np.testing.assert_allclose(vals, gold["values"], rtol=1e-5, atol=1e-4)
    agree = float((gsol.result.argmin.cpu().numpy() == gold["argmin"]).mean())
    print(f"vs kirk_golden: argmin agreement {agree}")
    check(agree >= 0.995, "argmin vs kirk_golden")
    X, U = kirk.optimal_path(gsol, (2.0, 1.0))
    X, U = X.cpu().numpy(), U.cpu().numpy()
    print(f"rollout from (2, 1): U[:3] = {U[:3].tolist()}, "
          f"max |X[-1]| = {float(np.abs(X[-1]).max())}")
    check(X.shape == gold["X"].shape and U.shape == gold["U"].shape,
          "rollout shape")
    np.testing.assert_allclose(X, gold["X"], atol=1e-3)
    np.testing.assert_allclose(U, gold["U"], atol=1e-2)

    phase("6. timing (CUDA events, warm, median of 10)")
    torch.cuda.reset_peak_memory_stats()
    p = kirk.build(full_cfg, device=device)
    bk = separable_backup(p, full_cfg, device)
    aff = kirk.affine_backup(full_cfg, device)
    args = aff.args
    v = res.values.contiguous()
    ov, oa = torch.empty_like(v), torch.empty(v.shape, dtype=torch.int32,
                                              device=device)
    evals = full_cfg.dx * full_cfg.dx * full_cfg.du
    kernel_ms = cuda_time_ms(
        lambda: fb.fused_backup2d_cuda(*kernel_args(bk, v)), inner=20)
    plain_ms = cuda_time_ms(
        lambda: fb.fused_backup2d_plain(*kernel_args(bk, v)), inner=5)
    aff_ms = cuda_time_ms(
        lambda: fb.fused_backup2d_affine_cuda(v, args, ov, oa), inner=20)
    aff_plain_ms = cuda_time_ms(
        lambda: fb.fused_backup2d_affine_plain(v, args), inner=5)
    aff_graph_ms = graph_time_ms(
        lambda: fb.fused_backup2d_affine_cuda(v, args, ov, oa))
    print(f"full sweep, back to back: plan-streamed {kernel_ms:.4f} ms "
          f"({evals / kernel_ms * 1e3:.4e} evals/s), its plain version "
          f"{plain_ms:.4f} ms; affine {aff_ms:.4f} ms "
          f"({evals / aff_ms * 1e3:.4e} evals/s; {aff_graph_ms:.4f} ms a "
          f"launch replayed as a CUDA graph), its plain version "
          f"{aff_plain_ms:.4f} ms")
    lib, params = fb._affine_launch(args)
    print(f"affine launch: {args.row0.numel()} blocks of {args.threads} "
          f"threads, {args.smem_bytes} B dynamic shared memory, "
          f"{lib.fused_backup2d_affine_blocks_per_sm(params)} blocks an SM")
    for line in ptxas_lines("affine_sweep"):
        print(line)
    shape = PlanShape((full_cfg.dx,) * 2, (full_cfg.dx,) * 2 + (full_cfg.du,),
                      device)
    sweeps = full_cfg.N - 1
    loop_ms = cuda_time_ms(lambda: value_iteration_finite(
        shape, None, sweeps, store_policies=True, backup=aff))
    graphed_ms = cuda_time_ms(lambda: value_iteration_finite(
        shape, None, sweeps, backup=aff))
    streamed_loop_ms = cuda_time_ms(lambda: value_iteration_finite(
        p.plan, p.stage_cost, sweeps, store_policies=True, backup=bk))
    solve_ms = cuda_time_ms(lambda: kirk.solve(full_cfg, device=device))

    def streamed_solve():
        q = kirk.build(full_cfg, device=device)
        return value_iteration_finite(
            q.plan, q.stage_cost, sweeps, store_policies=True,
            backup=separable_backup(q, full_cfg, device))

    solve_st_ms = cuda_time_ms(streamed_solve)
    print(f"{sweeps} sweeps, policies stored: affine {loop_ms:.3f} ms, "
          f"streamed {streamed_loop_ms:.3f} ms (plans built); affine without "
          f"policies, through CUDA graphs: {graphed_ms:.3f} ms; "
          f"the full solve incl. builds: kirk.solve(KirkConfig()) (affine) "
          f"{solve_ms:.3f} ms, kirk.build + the plan-streamed mode "
          f"{solve_st_ms:.3f} ms")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          " MiB")
    stage_entries = []
    for label, cfg, _ in C1_CONFIGS:
        caff, cv = c1[label]["aff"], c1[label]["v"]
        cargs = caff.args
        cov, coa = torch.empty_like(cv), torch.empty(
            cv.shape, dtype=torch.int32, device=device)
        c_ms = cuda_time_ms(
            lambda: fb.fused_backup2d_affine_cuda(cv, cargs, cov, coa),
            inner=5)
        c_graph_ms = graph_time_ms(
            lambda: fb.fused_backup2d_affine_cuda(cv, cargs, cov, coa), n=5)
        c_plain_ms = cuda_time_ms(
            lambda: fb.fused_backup2d_affine_plain(cv, cargs), inner=1,
            repeats=3)
        cb = affine_bound(cargs)
        c_evals = cfg.dx * cfg.dx * cfg.du
        _, cparams = fb._affine_launch(cargs)
        print(f"KirkConfig({label}), {STAGE_NAMES[cargs.stage]}: a sweep "
              f"{c_ms:.4f} ms back to back ({c_evals / c_ms * 1e3:.4e} "
              f"evals/s), {c_graph_ms:.4f} ms a launch replayed as a CUDA "
              f"graph, bound {cb['bound_ms']:.4f} ms ({cb['bound_by']}); "
              f"plain {c_plain_ms:.4f} ms; {cargs.row0.numel()} blocks of "
              f"{cargs.threads} threads, {cargs.smem_bytes} B dynamic shared "
              f"memory, {lib.fused_backup2d_affine_blocks_per_sm(cparams)} "
              "blocks an SM")
        name = "fused_backup2d_affine_" + (
            "chunks" if cargs.stage == fb.STAGE_CHUNKS else "global")
        if any(e["name"] == name for e in stage_entries):
            continue
        stage_entries.append(
            {"name": name,
             "launches": c1[label]["launches"], "max_abs_err": aff_err,
             "ms": c_ms, "plain_ms": c_plain_ms, **cb})
    del c1
    free_cuda()

    # streamed, per eval: 4 corners, each weight (1 - f where needed: 4
    # subtractions in all) a product of 2 factors, times its corner value,
    # summed (3 adds); the state + action cost (2 adds) and one compare: 18
    # operations. Bytes: the table, the action-major plan (2 int32 + 2 f32
    # per eval), the two cost parts, the values and argmin written.
    n_cells, n_act = bk.lo0.shape[1], bk.lo0.shape[0]
    nbytes = 4 * n_cells + 16 * n_cells * n_act + 4 * (n_cells + n_act) \
        + 8 * n_cells
    common = {"route": "cuda", "source": "ocdp_tpu_torch/csrc/fused_backup2d.cu",
              "replaces": "ocdp_tpu/ops/pallas_shear.py:237",
              "library_ms": None}
    return [
        {"name": "fused_backup2d", **common, "launches": streamed_launches,
         "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
         **bound(18.0 * n_cells * n_act, nbytes)},
        {"name": "fused_backup2d_affine", **common, "launches": launches,
         "max_abs_err": aff_err, "ms": aff_ms, "plain_ms": aff_plain_ms,
         **affine_bound(args)},
        *({**common, **e} for e in stage_entries),
    ]


POS_ATT_CHANNELS = (("x", False), ("y", False), ("z", False), ("x", True))
FLEET = 256            # flights in the serving fleet
TIMED_FLIGHT_S = 0.5   # simulated seconds of each timed repeat of a flight


def rowlane_vs_plain(bk, v, label: str) -> float:
    """One sweep through the row/lane kernel and through its plain version
    on the same inputs; both must agree bitwise. Returns max |dV|."""
    got = bk(v)
    want = bk.plain(v)
    torch.cuda.synchronize()
    err = float((got.values - want.values).abs().max())
    same_v = torch.equal(got.values, want.values)
    same_a = torch.equal(got.argmin, want.argmin)
    print(f"{label}: values bitwise {same_v}, argmin identical {same_a}, "
          f"max |dV| {err}")
    check(bool(torch.isfinite(got.values).all()), f"{label}: non-finite")
    check(same_v and same_a, f"{label}: kernel != plain version")
    return err


def tied_rowlane_backup(cfg, device):
    """The x channel with every action listed twice (actions 9..17 repeat
    0..8), so every minimum is an exact tie."""
    p = pos_att.build_channel(cfg, "x", with_cost=False, device=device)

    def twice(a):
        return torch.cat([a, a], dim=-1) if a.shape[-1] > 1 else a

    plan = InterpPlan(tuple(twice(a) for a in p.plan.lo),
                      tuple(twice(a) for a in p.plan.frac),
                      p.plan.grid_shape)
    return pos_att.build_channel_rowlane_backup(
        cfg, p._replace(plan=plan, forces=np.concatenate([p.forces,
                                                          p.forces])))


def fleet_x0s(rng, n: int) -> np.ndarray:
    """Seeded initial states: |x| in [0.04, 0.1] km either side, pitch in
    +-3 deg; flight 0 is the reference's default x0."""
    x0s = np.stack([pos_att.default_x0(p) for p in rng.uniform(-3, 3, n)])
    x0s[:, 0] = rng.choice([-1.0, 1.0], n) * rng.uniform(0.04, 0.1, n)
    x0s[0] = pos_att.default_x0()
    return x0s


def check_flights(label: str, X, F) -> None:
    """Finite states, every force 0 or +-0.13 N, |x| shrinking."""
    Xn, Fn = X.cpu().numpy(), F.cpu().numpy()
    check(bool(np.isfinite(Xn).all()), f"{label}: non-finite states")
    check(bool(np.isin(np.round(np.abs(Fn).astype(np.float64), 4),
                       [0.0, 0.13]).all()), f"{label}: forces off the set")
    x0, x1 = np.abs(Xn[..., 0, 0]), np.abs(Xn[..., -1, 0])
    print(f"{label}: |x| {float(x0.max())} -> {float(x1.max())} km "
          f"(max over flights), shrinking in {float((x1 < x0).mean())} of "
          "flights")
    check(bool((x1 < x0).all()), f"{label}: |x| does not shrink")


# past 20 row combos (the 40-combo kernel): the x channel of n_mesh_w=120
# has 35, the four channels of n_mesh_w=100 30-35; past 32 with lane taps
# -2..2 (the any-tap 40-combo kernel): simplified attitude axis 0 at
# n_mesh_w=1400, 33
WIDE_CFG = pos_att.PosAttConfig(n_mesh_w=120)
FOUR_WIDE_CFG = pos_att.PosAttConfig(n_mesh_w=100)
WIDE_SIMPLIFIED_CFG = attitude.AttitudeConfig(n_mesh_w=1400)


def pos_att_phases(device) -> list:
    """Phases 7-11; returns the row/lane kernel's entries of the kernels
    line: the reference channels' kernel and the 40-combo one."""
    rng = np.random.default_rng(SEED + 1)
    ref_cfg = pos_att.PosAttConfig()
    hr_cfg = pos_att.PosAttConfig.high_res()

    phase("7. row/lane kernel vs plain, one sweep: single, batched, graph")
    max_err = 0.0
    timed = {}
    for size, cfg in (("reference", ref_cfg), ("high_res", hr_cfg)):
        bks, vs = [], []
        for ch, failure in POS_ATT_CHANNELS:
            p = pos_att.build_channel(cfg, ch, failure=failure,
                                      with_cost=False, device=device)
            bk = pos_att.build_channel_rowlane_backup(cfg, p)
            v = torch.from_numpy(rng.uniform(0.0, 80.0, p.plan.grid_shape)
                                 .astype(np.float32)).to(device)
            name = ch + ("_failure" if failure else "")
            label = (f"{size} {name} ({bk.NW}x{bk.NE}, {bk.args.n_actions} "
                     f"actions, {len(bk.row_combos)} row combos, lane taps "
                     f"{bk.e_taps})")
            max_err = max(max_err, rowlane_vs_plain(bk, v, label))
            bks.append(bk)
            vs.append(v)
        max_err = max(max_err, rowlane_batch_vs_plain(bks, vs, size))
        timed[size] = (bks, vs)
    max_err = max(max_err, rowlane_graph_vs_eager(*timed["reference"],
                                                  ref_cfg.check_every))
    tie_bk = tied_rowlane_backup(ref_cfg, device)
    tie_v = torch.from_numpy(rng.uniform(0.0, 80.0, state_shape(ref_cfg))
                             .astype(np.float32)).to(device)
    max_err = max(max_err, rowlane_vs_plain(tie_bk, tie_v, "exact ties"))
    check(int(tie_bk(tie_v).argmin.max()) < 9,
          "exact ties: a duplicate action won")
    # past 20 row combos: the 40-combo kernel
    wide_err = 0.0
    wide_x = None
    for size, cfg, channels in (
            ("n_mesh_w=120", WIDE_CFG, [("x", False), ("z", False),
                                        ("x", True)]),
            ("n_mesh_w=100", FOUR_WIDE_CFG, POS_ATT_CHANNELS)):
        bks, vs = [], []
        for ch, failure in channels:
            p = pos_att.build_channel(cfg, ch, failure=failure,
                                      with_cost=False, device=device)
            bk = pos_att.build_channel_rowlane_backup(cfg, p)
            v = torch.from_numpy(rng.uniform(0.0, 80.0, p.plan.grid_shape)
                                 .astype(np.float32)).to(device)
            kind = rl.launch_plan(bk.to_table(v), [bk.args]).kind
            name = ch + ("_failure" if failure else "")
            check(kind == 3, f"{size} {name}: kernel kind {kind}, want 3")
            wide_err = max(wide_err, rowlane_vs_plain(
                bk, v, f"{size} {name} ({bk.NW}x{bk.NE}, "
                f"{len(bk.row_combos)} row combos, kernel kind {kind})"))
            bks.append(bk)
            vs.append(v)
            del p
        if size == "n_mesh_w=120":
            wide_x = (bks[:1], vs[:1])
        else:
            wide_err = max(wide_err, rowlane_batch_vs_plain(bks, vs, size))
            timed[size] = (bks, vs)
    _, splan, sterms = attitude.build_simplified_axis(WIDE_SIMPLIFIED_CFG, 0,
                                                      device=device)
    sbk = rl.RowLaneBackup(splan, sterms, perm=(0, 1), row_axes=1)
    sv = torch.from_numpy(rng.uniform(0.0, 100.0, splan.grid_shape)
                          .astype(np.float32)).to(device)
    kind = rl.launch_plan(sbk.to_table(sv), [sbk.args]).kind
    check(kind == 4, f"simplified n_mesh_w=1400: kernel kind {kind}, want 4")
    wide_err = max(wide_err, rowlane_vs_plain(
        sbk, sv, f"simplified axis 0, n_mesh_w=1400 ({sbk.NW}x{sbk.NE}, "
        f"{len(sbk.row_combos)} row combos, lane taps {sbk.e_taps}, kernel "
        f"kind {kind})"))
    wide_simplified = ([sbk], [sv])
    max_err = max(max_err, wide_err)
    free_cuda()

    phase("8. main path: pos_att.solve(PosAttConfig(), device='cuda')")
    reset_launch_counts()
    t0 = time.perf_counter()
    sol = pos_att.solve(ref_cfg, device=device)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts.pop("rowlane_backup")
    channel_sweeps = rl.rowlane_backup_cuda.channel_sweeps
    sweeps = {name: r.num_sweeps for name, r in sol.results.items()}
    print(f"pos_att.solve(PosAttConfig()): {solve_s:.3f} s cold; sweeps per "
          f"channel {sweeps}; {launches} rowlane launches for "
          f"{channel_sweeps} channel-sweeps (the four channels in one launch "
          f"a sweep, {launches // ref_cfg.check_every} CUDA graph replays of "
          f"{ref_cfg.check_every}); other kernels {counts}")
    check(launches == max(sweeps.values()),
          f"rowlane kernel launched {launches} times, want "
          f"{max(sweeps.values())}")
    check(channel_sweeps == sum(sweeps.values()),
          f"rowlane channel-sweeps {channel_sweeps}, want "
          f"{sum(sweeps.values())}")
    check(not any(counts.values()), "another backup kernel launched")
    check(all(n == ref_cfg.n_stage - 1 for n in sweeps.values()),
          "a reference channel stopped before the sweep cap")
    ref = pos_att.solve(ref_cfg, device=device, impl="rowlane")
    for name, ctrl in sol.controllers.items():
        rc = ref.controllers[name]
        rr, kr = ref.results[name], sol.results[name]
        same_v = torch.equal(ctrl.values, rc.values)
        same_a = torch.equal(ctrl.argmin, rc.argmin)
        same_c = torch.equal(kr.checks, rr.checks)
        print(f"{name}: kernel solve vs plain solve: values bitwise "
              f"{same_v}, argmin identical {same_a}, checks identical "
              f"{same_c}, sweeps {rr.num_sweeps}, converged {rr.converged}")
        check(bool(torch.isfinite(ctrl.values).all())
              and tuple(ctrl.values.shape) == state_shape(ref_cfg),
              f"{name}: wrong shape or non-finite values")
        check(same_v and same_a and same_c,
              f"{name}: kernel solve != plain solve")
        check(rr.num_sweeps == sweeps[name] and
              rr.converged == kr.converged,
              f"{name}: plain solve stopped elsewhere")
    with np.load(GOLDEN_DIR / "pos_att_channel_golden.npz") as z:
        gold = {k: z[k] for k in z.files}
    _, gres = pos_att.solve_channel(ref_cfg, "x", device=device,
                                    max_sweeps=int(gold["sweeps"]))
    gv, ga = gres.values.cpu().numpy(), gres.argmin.cpu().numpy()
    flips = float((ga != gold["argmin"]).mean())
    print(f"x channel, {int(gold['sweeps'])} sweeps vs "
          f"pos_att_channel_golden: max |dV| "
          f"{float(np.abs(gv - gold['values']).max())}, argmin flips "
          f"{flips}")
    np.testing.assert_allclose(gv, gold["values"], rtol=1e-5, atol=2e-3)
    check(flips < 1e-3, "argmin vs pos_att_channel_golden")

    phase("9. serving: rk4 flight, fleet, ode45 flight")
    t0 = time.perf_counter()
    _, X, F, _ = pos_att.get_optimal_path(sol, integrator="rk4")
    torch.cuda.synchronize()
    rk4_s = time.perf_counter() - t0
    print(f"rk4 flight, {ref_cfg.T_final} s simulated: {rk4_s:.3f} s")
    check(tuple(X.shape) == (ref_cfg.n_stage, 13), "rk4 flight shape")
    check_flights("rk4 flight", X, F)
    x0s = fleet_x0s(rng, FLEET)
    t0 = time.perf_counter()
    _, Xb, Fb, _ = pos_att.rollout_batch(sol, x0s)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    print(f"fleet of {FLEET} rk4 flights, {ref_cfg.T_final} s simulated: "
          f"{fleet_s:.3f} s, {FLEET * ref_cfg.T_final / fleet_s:.2f} "
          "flight-seconds per second")
    check(tuple(Xb.shape) == (FLEET, ref_cfg.n_stage, 13), "fleet shape")
    check_flights("fleet", Xb, Fb)
    lane = int(rng.integers(1, FLEET))
    _, X1, F1, _ = pos_att.get_optimal_path(sol, x0s[lane], integrator="rk4")
    for b, (Xs, Fs) in ((0, (X, F)), (lane, (X1, F1))):
        same = torch.equal(Xb[b], Xs) and torch.equal(Fb[b], Fs)
        print(f"fleet lane {b} vs its single flight: identical {same}")
        check(same, f"fleet lane {b} != its single flight")
    t0 = time.perf_counter()
    _, Xo, Fo, _ = pos_att.get_optimal_path(sol, integrator="ode45",
                                            t_final=1.0)
    torch.cuda.synchronize()
    ode_s = time.perf_counter() - t0
    print(f"ode45 flight, 1.0 s simulated: {ode_s:.3f} s; max "
          f"|X_ode45 - X_rk4| over it "
          f"{float((Xo - X[:len(Xo)]).abs().max())}")
    check_flights("ode45 flight", Xo, Fo)

    phase("10. high-resolution solve through the kernel")
    reset_launch_counts()
    t0 = time.perf_counter()
    hsol = pos_att.solve(hr_cfg, include_failure=False, device=device)
    torch.cuda.synchronize()
    hr_s = time.perf_counter() - t0
    hsweeps = {name: r.num_sweeps for name, r in hsol.results.items()}
    print(f"pos_att.solve(PosAttConfig.high_res(), include_failure=False): "
          f"{hr_s:.3f} s; sweeps per channel {hsweeps}; "
          f"{rl.rowlane_backup_cuda.launches} launches, "
          f"{rl.rowlane_backup_cuda.channel_sweeps} channel-sweeps")
    check(rl.rowlane_backup_cuda.launches == max(hsweeps.values())
          and rl.rowlane_backup_cuda.channel_sweeps
          == sum(hsweeps.values()),
          "high-res solve: launches != sweeps")
    check(all(bool(torch.isfinite(c.values).all())
              for c in hsol.controllers.values()), "high-res: non-finite")
    del hsol
    reset_launch_counts()
    t0 = time.perf_counter()
    wsol = pos_att.solve(FOUR_WIDE_CFG, device=device)
    torch.cuda.synchronize()
    w_s = time.perf_counter() - t0
    wsweeps = {name: r.num_sweeps for name, r in wsol.results.items()}
    counts = launch_counts()
    wide_launches = counts.pop("rowlane_backup")
    print(f"pos_att.solve(PosAttConfig(n_mesh_w=100)): {w_s:.3f} s; sweeps "
          f"per channel {wsweeps}; {wide_launches} launches of the 40-combo "
          f"kernel, {rl.rowlane_backup_cuda.channel_sweeps} channel-sweeps; "
          f"other kernels {counts}")
    check(wide_launches == max(wsweeps.values())
          and rl.rowlane_backup_cuda.channel_sweeps == sum(wsweeps.values())
          and not any(counts.values()), "n_mesh_w=100: launches != sweeps")
    check(all(bool(torch.isfinite(c.values).all())
              for c in wsol.controllers.values()), "n_mesh_w=100: non-finite")
    del wsol
    k50 = pos_att.solve(FOUR_WIDE_CFG, device=device, max_sweeps=50)
    p50 = pos_att.solve(FOUR_WIDE_CFG, device=device, max_sweeps=50,
                        impl="rowlane")
    same = all(torch.equal(c.values, p50.controllers[n].values)
               and torch.equal(c.argmin, p50.controllers[n].argmin)
               and torch.equal(k50.results[n].checks, p50.results[n].checks)
               for n, c in k50.controllers.items())
    print(f"n_mesh_w=100, 50 sweeps: kernel solve == plain solve bitwise "
          f"{same}")
    check(same, "n_mesh_w=100: kernel solve != plain solve")
    del k50, p50
    free_cuda()

    phase("11. timing (CUDA events, warm, median of 10)")
    ms = {}
    timed["n_mesh_w=120, x"] = wide_x
    timed["simplified n_mesh_w=1400, axis 0"] = wide_simplified
    for size, (bks, vs) in timed.items():
        tabs = [b.to_table(v) for b, v in zip(bks, vs)]
        args = [b.args for b in bks]
        ov = [torch.empty_like(t) for t in tabs]
        oa = [torch.empty(t.shape, dtype=torch.int32, device=device)
              for t in tabs]
        evals = sum(b.NW * b.NE * b.args.n_actions for b in bks)

        def batch():
            rl.rowlane_backup_cuda(tabs, args, ov, oa)

        k_ms = graph_time_ms(batch)
        w_ms = cuda_time_ms(batch, inner=20)
        one_ms = graph_time_ms(lambda: rl.rowlane_backup_cuda(
            tabs[0], args[0], ov[0], oa[0]))
        wide = size.startswith(("n_mesh_w", "simplified"))
        p_ms = cuda_time_ms(lambda: [rl.rowlane_backup_plain(t, a)
                                     for t, a in zip(tabs, args)],
                            inner=1 if wide else 2, repeats=3 if wide else 10)
        ms[size] = (k_ms, p_ms)
        plan, blocks = rl.tile_occupancy(tabs[0], args)
        rb = rowlane_bound(bks)
        print(f"{size}, the {len(bks)} channel(s) in one launch: kernel "
              f"alone {k_ms:.4f} ms ({evals / k_ms * 1e3:.4e} evals/s; bound "
              f"{rb['bound_ms']:.4f} ms, {rb['bound_by']}), through the "
              f"wrapper back to back {w_ms:.4f} ms; the x channel alone "
              f"{one_ms:.4f} ms; plain {p_ms:.4f} ms "
              f"({evals / p_ms * 1e3:.4e} evals/s)")
        print(f"  {plan.smem_bytes} B dynamic shared memory a block (tile "
              f"{plan.rows} rows x {plan.lanes} lanes, stage {plan.n_staged} "
              f"rows x {plan.width} lanes, {plan.threads} threads, kernel "
              f"kind {plan.kind}, grid {plan.grid}), {blocks} blocks an SM: "
              f"occupancy {blocks * plan.threads / SM_MAX_THREADS:.0%}")
    for line in ptxas_lines("rowlane_tiles"):
        print(line)
    solve_ms = cuda_time_ms(lambda: pos_att.solve(ref_cfg, device=device))
    print(f"pos_att.solve(PosAttConfig()) incl. builds, "
          f"{sum(sweeps.values())} sweeps: {solve_ms:.3f} ms")
    x0 = pos_att.default_x0()
    fl_ms = cuda_time_ms(lambda: pos_att.get_optimal_path(
        sol, x0, integrator="rk4", t_final=TIMED_FLIGHT_S))
    fleet_ms = cuda_time_ms(lambda: pos_att.rollout_batch(
        sol, x0s, t_final=TIMED_FLIGHT_S))
    print(f"rk4 flight of {TIMED_FLIGHT_S} s: {fl_ms:.3f} ms "
          f"({fl_ms / TIMED_FLIGHT_S:.1f} ms per simulated second); fleet of "
          f"{FLEET}: {fleet_ms:.3f} ms, "
          f"{FLEET * TIMED_FLIGHT_S / fleet_ms * 1e3:.2f} flight-seconds per "
          "second")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          " MiB")
    common = {"route": "cuda",
              "source": "ocdp_tpu_torch/csrc/rowlane_backup.cu",
              "replaces": "ocdp_tpu/ops/pallas_backup6.py:973",
              "library_ms": None}
    return [
        {"name": "rowlane_backup", **common, "launches": launches,
         "max_abs_err": max_err, "ms": ms["reference"][0],
         "plain_ms": ms["reference"][1],
         **rowlane_bound(timed["reference"][0])},
        {"name": "rowlane_backup_40", **common, "launches": wide_launches,
         "max_abs_err": wide_err, "ms": ms["n_mesh_w=100"][0],
         "plain_ms": ms["n_mesh_w=100"][1],
         **rowlane_bound(timed["n_mesh_w=100"][0])},
    ]


def rowlane_batch_vs_plain(bks, vs, size: str) -> float:
    """The channels in one launch against each channel's plain version and
    its own one-channel launch: bitwise. Returns max |dV|."""
    tabs = [b.to_table(v) for b, v in zip(bks, vs)]
    ov = [torch.empty_like(t) for t in tabs]
    oa = [torch.empty(t.shape, dtype=torch.int32, device=t.device)
          for t in tabs]
    rl.rowlane_backup_cuda(tabs, [b.args for b in bks], ov, oa)
    err = 0.0
    for b, t, v, a in zip(bks, tabs, ov, oa):
        want = rl.rowlane_backup_plain(t, b.args)
        one = rl.rowlane_backup_cuda(t, b.args)
        torch.cuda.synchronize()
        err = max(err, float((v - want.values).abs().max()))
        check(torch.equal(v, want.values) and torch.equal(a, want.argmin),
              f"{size}: a channel of the batch != its plain version")
        check(torch.equal(v, one.values) and torch.equal(a, one.argmin),
              f"{size}: a channel of the batch != its own launch")
    print(f"{size}, {len(bks)} channels in one launch "
          f"({[b.args.n_actions for b in bks]} actions): each channel equals "
          f"its plain version and its own launch bitwise, max |dV| {err}")
    return err


def rowlane_graph_vs_eager(bks, vs, n: int) -> float:
    """``n`` sweeps of the batch replayed as one CUDA graph against the same
    sweeps as eager launches: bitwise, and the replay's launches
    counted."""
    batch = rl.RowLaneBatch(bks)
    active = tuple(range(len(bks)))
    runs = []
    for graphed in (False, True):
        cur, nxt, arg = batch.buffers(vs)

        def step(src, dst):
            batch.sweep(src, dst, arg, active)

        if graphed:
            batch.prepare(active)
            before = rl.rowlane_backup_cuda.launches
            g = SweepGraph(step, cur, nxt, n, (batch.launcher,))
            check(rl.rowlane_backup_cuda.launches == before,
                  "a capture counted launches")
            g.replay()
            check(rl.rowlane_backup_cuda.launches == before + n,
                  "a replay did not count its launches")
        else:
            ping_pong(step, cur, nxt, n)
        torch.cuda.synchronize()
        runs.append((cur, arg))
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"{n} sweeps of the batch, one CUDA graph vs eager launches: "
          f"values and argmin identical {same}")
    check(same, "graph replay != eager launches")
    return float((runs[0][0] - runs[1][0]).abs().max())


def rowlane_bound(bks) -> dict:
    """FP32 operations and bytes of one sweep of the channels ``bks`` (one
    backup or a list), as the plain version does them
    (``rowlane_backup_plain``), from each plan's tap structure."""
    if isinstance(bks, (list, tuple)):
        parts = [rowlane_bound(b) for b in bks]
        return bound(sum(p["flops"] for p in parts),
                     sum(p["bytes"] for p in parts))
    bk = bks
    a = bk.args
    nw, ne, n_act = bk.NW, bk.NE, a.n_actions
    nc, nr = len(a.row_combos), len(a.row_shape)
    n_taps = [len(t) for t in a.lane_taps]
    per_cell = (2 * sum(n_taps)                    # lane tap weights
                + nc * sum(2 * t - 1 for t in n_taps)   # lane lerps
                + n_act * (2 * nc - 1)             # sum over row combos
                + sum(1 for c in a.c_act if c)     # action costs
                + (n_act if a.c_rowact is not None else 0)
                + (n_act - 1)                      # compares
                + 3)                               # row, lane, rowlane adds
    w_taps = [len({c[k] for c in a.row_combos}) for k in range(nr)]
    per_row = n_act * (2 * sum(w_taps) + (nr - 1) * nc)   # row weights
    nbytes = (4 * nw * ne + 8 * nr * nw * n_act
              + sum(8 * nw * n for n in a.lane_shape) + 4 * (nw + ne)
              + (4 * nw * n_act if a.c_rowact is not None else 0)
              + (4 * nw * ne if a.c_rowlane is not None else 0)
              + 8 * nw * ne)
    return bound(float(per_cell * nw * ne + per_row * nw), nbytes)


ATT_FULL = dict(n_mesh_w=11, n_mesh_q=10)
# phase 13's and 14's one-device solves, which phases 28-29 are held to
REF_6D = {}
# the mangled names of the 6-D kernels: the cube body's entries, no
# c_rowact (B.3's backup6d_sweep_cube with an int32 argmin, B.4's with a
# uint8 one, B.5's backup6d_sweep_recompute_cube with a uint8 one), then
# backup6d_sweep's instantiations <ArgT, kTrack, kRecompute>: int32
# tracking (B.3 on any other tap structure, and B.7), B.5 with a uint8
# argmin (on any other structure)
B3_KERNEL = "backup6d_sweep_cubeIiLb0E"
B4_KERNEL = "backup6d_sweep_cubeIhLb0E"
B5_CUBE_KERNEL = "backup6d_sweep_recompute_cubeIhLb0E"
SWEEP_KERNEL = "backup6d_sweepIiLb1ELb0E"
B5_KERNEL = "backup6d_sweepIhLb1ELb1E"
ATT_SERVE = dict(n_mesh_w=11, n_mesh_q=7)
DEG = np.pi / 180.0


def attitude_backup(device, case="extrapolate", **kw):
    """The 6-D backup of ``build_full``'s plan. ``case``: 'clamp' builds
    with ``edge='clamp'``; 'tie' zeroes the cost (with ``h=0`` all actions
    then tie exactly); 'permuted' reorders the actions, so that they no
    longer factor digit by digit and the generic action phase runs."""
    _, plan, cost = attitude.build_full(
        attitude.AttitudeConfig(**kw), device=device,
        edge="clamp" if case == "clamp" else "extrapolate")
    cost = list(cost)
    if case == "tie":
        cost = [torch.zeros_like(t) for t in cost]
    elif case == "permuted":
        perm = torch.from_numpy(np.random.default_rng(SEED).permutation(27)) \
            .to(device)
        plan = InterpPlan(
            tuple(x[..., perm] if x.shape[-1] > 1 else x for x in plan.lo),
            tuple(x[..., perm] if x.shape[-1] > 1 else x for x in plan.frac),
            plan.grid_shape)
        cost[2] = cost[2][..., perm]
    return plan, cost, b6.Backup6D(plan, cost)


def backup6d_vs_plain(bk, v, label: str) -> float:
    """One sweep through the 6-D kernel and through its plain version on the
    same inputs; both must agree bitwise. Returns max |dV|."""
    got = bk(v)
    want = bk.plain(v)
    torch.cuda.synchronize()
    err = float((got.values - want.values).abs().max())
    same_v = torch.equal(got.values, want.values)
    same_a = torch.equal(got.argmin, want.argmin)
    print(f"{label} ({bk.NW}x{bk.NE}, {len(bk.row_combos)} row x "
          f"{len(bk.lane_combos)} lane combos, action digits "
          f"{bk.action_digits}): values bitwise {same_v}, argmin identical "
          f"{same_a}, max |dV| {err}")
    check(bool(torch.isfinite(got.values).all()), f"{label}: non-finite")
    check(same_v and same_a, f"{label}: kernel != plain version")
    return err


def backup6d_bound(bk) -> dict:
    """FP32 operations and bytes of one 6-D sweep, as its plain version does
    them (``backup6d_plain``), from this plan's tap structure."""
    return backup6d_args_bound(bk.args, bk.NE)


def backup6d_args_bound(a, ne: int) -> dict:
    """The bound of one sweep of the kernel's inputs ``a`` over its output
    rows (a B.7 block reads its halo rows too) and its action range (a B.7
    slice: the actions of the range; the full-width row plan is read)."""
    nw, n_all = a.n_rows, a.n_actions
    a_lo, a_hi = a.action_range
    n_act = a_hi - a_lo
    n_row, n_lane = len(a.row_combos), len(a.lane_combos)
    e_taps = [len({c[k] for c in a.lane_combos}) for k in range(3)]
    per_cell = (2 * sum(e_taps)              # lane tap weights
                + 2 * n_lane                 # joint lane-combo weights
                + n_row * (2 * n_lane - 1))  # A_j
    per_row = n_act * 2 * sum(len(t) for t in a.w_taps)   # row weights
    if a.action_digits:
        m = a.action_digits
        combos = set(a.row_combos)
        pairs = sorted({c[:2] for c in combos})
        t0s = sorted({c[0] for c in combos})
        per_cell += sum(m * (2 * sum((p + (t,)) in combos
                                     for t in a.w_taps[2]) - 1)
                        for p in pairs)                       # B
        per_cell += sum(m * m * (2 * sum((t0, t) in pairs
                                         for t in a.w_taps[1]) - 1)
                        for t0 in t0s)                        # C
        per_cell += n_act * (2 * len(t0s) - 1)                # totals
    else:
        per_cell += n_act * (2 * n_row - 1)
        per_row += n_act * 2 * n_row            # row-combo weight products
    per_cell += (sum(1 for c in a.c_act[a_lo:a_hi] if c)
                 + (n_act if a.c_rowact is not None else 0)
                 + (n_act - 1) + 3)             # costs, compares, final adds
    # table in (with a block's halo rows); the lane plan (24 B/cell) or,
    # recomputed, the rows' omegas and the lanes' kirk-q; values and argmin
    # out
    table_rows = nw + sum(a.halo)
    lane_bytes = 24 * nw * ne if a.lanes is None else 12 * nw + 16 * ne
    nbytes = (4 * table_rows * ne + 24 * nw * n_all + lane_bytes
              + 4 * (nw + ne)
              + (4 * nw * n_all if a.c_rowact is not None else 0)
              + (4 * nw * ne if a.c_rowlane is not None else 0)
              + (4 + a.argmin_dtype.itemsize) * nw * ne)
    if a.lanes is not None:
        per_cell += RECOMPUTE_OPS_PER_CELL
    return bound(float(per_cell * nw * ne + per_row * nw), nbytes)


# FP32 operations of one cell's lane recompute (B.5), counted from
# ops/kernelmath.py: the quaternion step 28 (4 x (3 products, 2 sums, the
# step product and sum)), the norm 8, 4 divisions, the readback arguments
# 28 (yaw 11, roll 11, pitch 6 with its clamp), two atan2 at 25 each (the
# division, |x|, 2 compares, the guard max, the reduction's 3 operations,
# 9 of the polynomial, 3 of the sign and offset, 3 of the quadrant fix),
# the asin's own 6 and its atan2 25, and 3 locates at 6 (2 with
# edge='clamp')
RECOMPUTE_OPS_PER_CELL = 28 + 8 + 4 + 28 + 2 * 25 + 6 + 25 + 3 * 6


def kernel_registers(name: str) -> str:
    """The ptxas line (registers, static shared memory, spills) of kernel
    ``name`` (a substring of its mangled name) in the build log that
    ``_build`` writes beside the library."""
    log = _build.library_path().with_suffix(".log").read_text()
    blocks = log.split("Compiling entry function")
    for b in blocks:
        if name in b.split("\n", 1)[0]:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", b)
            regs = re.search(r"Used (\d+) registers", b)
            smem = re.search(r"(\d+) bytes smem", b)
            return (f"{regs.group(1)} registers, "
                    f"{smem.group(1) if smem else 0} B static shared memory, "
                    f"{spill.group(1)} B spill stores, {spill.group(2)} B "
                    "spill loads")
    raise RuntimeError(f"chip_smoke: {name} not in the build log")


def tile_line(values, args) -> str:
    """The dynamic shared memory a 6-D launch on ``values`` asks for (the
    tile planner's stage), its tile and its occupancy (the card's
    query)."""
    plan, blocks = b6.tile_occupancy(values, args)
    return (f"{plan.smem_bytes} B dynamic shared memory a launch (tile "
            f"{plan.rows} rows x {plan.lanes} lanes, stage {plan.n_staged} "
            f"rows x {plan.width} lanes, {plan.threads} threads a block, "
            f"{blocks} blocks an SM: occupancy "
            f"{blocks * plan.threads / SM_MAX_THREADS:.0%})")


def tile_edge_cases(bk, v) -> float:
    """The shared-memory tiles' edges of B.3, bitwise against the plain
    version: the sweep of ``v`` (already compared) has row tiles clipped at
    the table's top and bottom and lanes that the tile does not divide; a
    10-row block with no halo rows puts every row tile past both edges
    (0.0 there, as the plain version reads). Returns max |dV|."""
    v2 = v.reshape(bk.NW, bk.NE).contiguous()
    plan, _ = b6.tile_occupancy(v2, bk.args)
    top = int(plan.stage_rows(0).min())
    bottom = int(plan.stage_rows(plan.grid[0] - 1).max())
    print(f"{bk.NW}x{bk.NE} tiles {plan.rows} x {plan.lanes}: first row tile "
          f"stages table row {top}, last {bottom} ({bk.NW} rows), lanes "
          f"{bk.NE} % {plan.lanes} = {bk.NE % plan.lanes}")
    check(top < 0 and bottom >= bk.NW and bk.NE % plan.lanes != 0,
          "the 11^3x10^3 tiles do not reach both edges and a cut lane tile")
    args = b6.block_args(bk.args, 600, 610, 0, 0)
    local = v2[600:610].contiguous()
    plan10, _ = b6.tile_occupancy(local, args)
    check(all(plan10.stage_rows(i).min() < 0
              and plan10.stage_rows(i).max() >= 10
              for i in range(plan10.grid[0])),
          "the 10-row block's tiles are not clipped at both edges")
    check(plan10.cube_body, "the 10-row block with no halo rows did not "
          "plan the cube body")
    return b7_vs_plain(local, args,
                       f"a 10-row block with no halo rows (the cube body): "
                       f"{plan10.grid[0]} row tiles, each clipped at both "
                       "table edges")


def attitude_phases(device) -> dict:
    """Phases 12-16; returns the 6-D kernel's entry of the kernels line."""
    rng = np.random.default_rng(SEED + 2)
    full_cfg = attitude.AttitudeConfig(**ATT_FULL)

    phase("12. 6-D kernel vs plain, one sweep")
    plan, cost, bk = attitude_backup(device, **ATT_FULL)
    v = torch.from_numpy(rng.uniform(0.0, 100.0, bk.state_shape)
                         .astype(np.float32)).to(device)
    max_err = backup6d_vs_plain(bk, v, "11^3x10^3 random table")
    v50 = attitude.solve_full(full_cfg, num_sweeps=50).result.values
    max_err = max(max_err, backup6d_vs_plain(bk, v50,
                                             "11^3x10^3 after 50 sweeps"))
    for label, case, kw in (
            ("5^3x4^3", "extrapolate", dict(n_mesh_w=5, n_mesh_q=4)),
            ("exact ties (h=0, no cost)", "tie",
             dict(n_mesh_w=5, n_mesh_q=4, h=0.0)),
            ("edge='clamp'", "clamp", ATT_FULL),
            ("permuted actions (generic phase)", "permuted", ATT_FULL)):
        _, _, cbk = attitude_backup(device, case, **kw)
        cv = torch.from_numpy(rng.uniform(0.0, 100.0, cbk.state_shape)
                              .astype(np.float32)).to(device)
        max_err = max(max_err, backup6d_vs_plain(cbk, cv, label))
        check((cbk.action_digits is None) == (case == "permuted"),
              f"{label}: wrong action phase")
        if case == "tie":
            check(int(cbk(cv).argmin.max()) == 0,
                  "exact ties: a later action won")
    max_err = max(max_err, tile_edge_cases(bk, v))

    phase("13. main path: attitude.solve_full(AttitudeConfig(n_mesh_w=11, "
          "n_mesh_q=10))")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    sol = attitude.solve_full(full_cfg)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["backup6d"]
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    sweeps = full_cfg.n_stage - 1
    print(f"attitude.solve_full(AttitudeConfig(n_mesh_w=11, n_mesh_q=10)): "
          f"{solve_s:.3f} s for {sweeps} sweeps incl. the build; launches "
          f"{counts}; peak device memory {peak_mib:.1f} MiB")
    check(launches == sweeps and counts["backup6d_cube"] == sweeps,
          f"backup6d launched {launches} times, {counts['backup6d_cube']} "
          f"of them backup6d_sweep_cube, want {sweeps}")
    res = sol.result
    REF_6D["finite"] = res
    check(res.values.is_cuda and tuple(res.values.shape) == bk.state_shape
          and bool(torch.isfinite(res.values).all()),
          "main path: wrong device, shape or non-finite values")
    print(f"V range [{float(res.values.min())}, {float(res.values.max())}]")
    k50 = attitude.solve_full(full_cfg, num_sweeps=50, impl="kernel")
    p50 = attitude.solve_full(full_cfg, num_sweeps=50, impl="plain")
    same_v = torch.equal(k50.result.values, p50.result.values)
    same_a = torch.equal(k50.result.argmin, p50.result.argmin)
    print(f"50 sweeps, kernel vs plain: values bitwise {same_v}, argmin "
          f"identical {same_a}")
    check(same_v and same_a, "50-sweep solve: kernel != plain")

    phase("14. segmented with the stop rule vs the converged engine; kill "
          "and resume")
    t0 = time.perf_counter()
    seg = attitude.solve_full(full_cfg, segment_size=50, tol=1e-2).result
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    conv = value_iteration_converged(plan, cost, sweeps, check_every=50,
                                     tol=1e-2, backup=bk)
    torch.cuda.synchronize()
    conv_s = time.perf_counter() - t0
    print(f"segmented: {seg.num_sweeps} sweeps, converged {seg.converged}, "
          f"{seg_s:.3f} s; converged engine: {conv.num_sweeps} sweeps, "
          f"converged {conv.converged}, {conv_s:.3f} s")
    REF_6D["converged"] = conv
    check(seg.num_sweeps == conv.num_sweeps
          and seg.converged == conv.converged,
          "segmented and converged engines stopped differently")
    check(torch.equal(seg.values, conv.values)
          and torch.equal(seg.argmin, conv.argmin),
          "segmented != converged engine")

    class Killed(Exception):
        pass

    def kill_at_100(k, _v):
        if k >= 100:
            raise Killed

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "attitude_6d.npz")
        try:
            value_iteration_segmented(plan, cost, sweeps, segment_size=50,
                                      tol=1e-2, backup=bk,
                                      checkpoint_path=ckpt,
                                      on_segment=kill_at_100)
        except Killed:
            pass
        ck = io.load_values(ckpt, device=device)
    check(ck.sweep_index == 100 and ck.prev_f is not None,
          f"checkpoint at sweep {ck.sweep_index}, prev_f {ck.prev_f}")
    resumed = attitude.solve_full(
        full_cfg, segment_size=50, tol=1e-2, init_values=ck.values,
        start_sweep=ck.sweep_index, prev_f=ck.prev_f).result
    same = (torch.equal(resumed.values, seg.values)
            and torch.equal(resumed.argmin, seg.argmin)
            and resumed.converged == seg.converged
            and ck.sweep_index + resumed.num_sweeps == seg.num_sweeps)
    print(f"killed at sweep {ck.sweep_index}, resumed for "
          f"{resumed.num_sweeps} sweeps: equals the uninterrupted solve "
          f"(values, argmin, stop) {same}")
    check(same, "resumed solve != uninterrupted solve")

    phase("15. serving: damping, the full-horizon rollout, an interp "
          "rollout")
    serve_cfg = attitude.AttitudeConfig(**ATT_SERVE)
    ssol = attitude.solve_full(serve_cfg, num_sweeps=1000)
    X, U, ang = attitude.rollout_full(ssol, num_stages=4000)
    X, U, ang = X.cpu().numpy(), U.cpu().numpy(), ang.cpu().numpy()
    a_end = np.abs(ang[-200:]).mean(axis=0) / DEG
    w_end = np.abs(X[-200:, :3]).mean(axis=0) / DEG
    print(f"11^3x7^3, 1000 sweeps, 4000-stage rollout from (5, 10, -9) deg: "
          f"mean |Euler| of the last 200 stages {a_end.tolist()} deg, mean "
          f"|omega| {w_end.tolist()} deg/s")
    check(bool(np.isfinite(X).all()), "damping rollout: non-finite states")
    check(bool((a_end < 4.0).all() and (w_end < 6.0).all()),
          "the 11^3x7^3 policy does not damp the start")
    check(bool(np.isin(np.round(U.astype(np.float64), 4),
                       [-0.11, 0.0, 0.11]).all()), "torques off the set")
    t0 = time.perf_counter()
    Xf, _, _ = attitude.rollout_full(sol)
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    n_roll = full_cfg.n_stage - 1
    check(tuple(Xf.shape) == (full_cfg.n_stage, 7)
          and bool(torch.isfinite(Xf).all()), "full rollout")
    print(f"5999-stage nearest rollout of the main-path policy: "
          f"{roll_s:.3f} s, {roll_s / n_roll * 1e3:.3f} ms per stage; final "
          f"|q_vec| {float(Xf[-1, 3:6].norm())}")
    t0 = time.perf_counter()
    Xi, Ui, _ = attitude.rollout_full(sol, method="interp", num_stages=200)
    torch.cuda.synchronize()
    interp_s = time.perf_counter() - t0
    check(bool(torch.isfinite(Xi).all())
          and float(Ui.abs().max()) <= full_cfg.u_max * (1 + 1e-6),
          "interp rollout")
    print(f"200-stage interp rollout: {interp_s:.3f} s, "
          f"{interp_s / 199 * 1e3:.3f} ms per stage")

    phase("16. timing (CUDA events, warm, median of 10)")
    v2 = v.reshape(bk.NW, bk.NE).contiguous()
    evals = bk.NW * bk.NE * bk.args.n_actions
    k_ms = cuda_time_ms(lambda: b6.backup6d_cuda(v2, bk.args), inner=5)
    # backup6d_sweep on the same inputs (the same sweep as a range of every
    # action): the body every other structure and mode runs
    every = b6.slice_args(bk.args, 0, bk.args.n_actions)
    s_ms = cuda_time_ms(lambda: b6.backup6d_cuda(v2, every), inner=5)
    p_ms = cuda_time_ms(lambda: b6.backup6d_plain(v2, bk.args))
    b3_bound = backup6d_bound(bk)
    print(f"11^3x10^3 sweep, back to back: kernel {k_ms:.4f} ms "
          f"({evals / k_ms * 1e3:.4e} evals/s; bound {b3_bound['bound_ms']:.4f} "
          f"ms, {b3_bound['bound_ms'] / k_ms:.1%} of it), backup6d_sweep on "
          f"the same inputs {s_ms:.4f} ms, plain {p_ms:.4f} ms "
          f"({evals / p_ms * 1e3:.4e} evals/s)")
    print(f"full solve (5999 sweeps, incl. build) {solve_s:.3f} s, "
          f"{solve_s / sweeps * 1e3:.4f} ms per sweep; segmented with the "
          f"stop rule {seg_s:.3f} s; converged engine {conv_s:.3f} s; "
          f"rollout {roll_s / n_roll * 1e3:.3f} ms per stage; peak device "
          f"memory of the main path {peak_mib:.1f} MiB")
    print(f"backup6d_sweep_cube<int32> (B.3): "
          f"{kernel_registers(B3_KERNEL)}; {tile_line(v2, bk.args)}")
    print(f"backup6d_sweep<int32, tracking>: "
          f"{kernel_registers(SWEEP_KERNEL)}; {tile_line(v2, every)}")
    return {
        "name": "backup6d",
        "route": "cuda",
        "source": "ocdp_tpu_torch/csrc/backup6d.cu",
        "replaces": "ocdp_tpu/ops/pallas_backup6.py:973",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        **backup6d_bound(bk),
        "library_ms": None,
    }


ENV_CHECK = dict(n_mesh_w=19, n_mesh_q=14)   # 18.8M cells: the plain fits
ENV_MAIN = dict(n_mesh_w=30, n_mesh_q=16)    # 110.6M cells (README)
ENV_MAX = dict(n_mesh_w=60, n_mesh_q=22)     # 2.30B cells, past 2^31
ENV_CELL = dict(n_mesh_w=48, n_mesh_q=10)    # 110.6M cells (the cell's)
ENV_SWEEPS = 100                             # of the main path's 5999
ENV_TOL = dict(tol=1e-6, tol_mode="rel")


def seeded_table(rng, bk) -> torch.Tensor:
    return torch.from_numpy(rng.uniform(0.0, 100.0, (bk.NW, bk.NE))
                            .astype(np.float32)).to("cuda")


def envelope_vs_plain(bk, v, label: str) -> float:
    """One sweep of a flat or recompute backup through its kernel and
    through the plain version; bitwise. Returns max |dV|."""
    want = b6.backup6d_plain(v, bk.args)
    got = b6.backup6d_cuda(v, bk.args)
    torch.cuda.synchronize()
    err = float((got.values - want.values).abs().max())
    same_v = torch.equal(got.values, want.values)
    same_a = torch.equal(got.argmin, want.argmin)
    print(f"{label} ({bk.NW}x{bk.NE}, {len(bk.row_combos)} row x "
          f"{len(bk.lane_combos)} lane combos, lane taps {bk.e_taps}, "
          f"argmin {bk.argmin_dtype}, tracking {bk.track_argmin}): values "
          f"bitwise {same_v}, argmin identical {same_a}, max |dV| {err}")
    check(bool(torch.isfinite(got.values).all()), f"{label}: non-finite")
    check(same_v and same_a, f"{label}: kernel != plain version")
    return err


def carry_vs_allocating(plan, cost, label: str) -> None:
    """Six carry-mode sweeps (two tables and one argmin buffer) against six
    allocating sweeps of the same plan: bitwise."""
    carry = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8,
                        carry_padded=True)
    alloc = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8)
    rc = value_iteration_finite(PlanShape.of(plan), None, 6, backup=carry,
                                narrow_argmin_result=True)
    ra = value_iteration_finite(PlanShape.of(plan), None, 6, backup=alloc,
                                narrow_argmin_result=True)
    same = (torch.equal(rc.values, ra.values.reshape(rc.values.shape))
            and torch.equal(rc.argmin, ra.argmin.reshape(rc.argmin.shape)))
    print(f"{label}: 6 carry-mode sweeps ({tuple(rc.values.shape)} tables, "
          f"{rc.argmin.dtype} argmin) vs 6 allocating: identical {same}")
    check(same and rc.argmin.dtype == torch.uint8,
          f"{label}: carry mode != allocating sweeps")


def free_cuda() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def recompute_vs_filled_plan(bk5, v) -> None:
    """B.5's in-kernel lane (lo, frac) against the plain recompute's on
    every cell of the grid: a stored ``(NW, NE)`` lane plan is filled from
    :meth:`LaneRecompute.lane_block` in row blocks, B.4 sweeps ``v`` once on
    it with B.5's tap structure, and B.5 sweeps the same table once (at
    the full tap cube through the cube body's two entries,
    ``backup6d_sweep_cube`` and ``backup6d_sweep_recompute_cube``); values
    and argmin must be bitwise equal. The filled plan's live lane taps
    (the stored-plan liveness pass) must lie in B.5's admitted combos."""
    a5 = bk5.args
    nw, ne = bk5.NW, bk5.NE
    offs = [torch.empty((nw, ne), dtype=torch.int32, device=v.device)
            for _ in range(3)]
    fracs = [torch.empty((nw, ne), dtype=torch.float32, device=v.device)
             for _ in range(3)]
    rows = max(1, 50_000_000 // ne)
    t0 = time.perf_counter()
    for r0 in range(0, nw, rows):
        n = min(rows, nw - r0)
        o, f = a5.lanes.lane_block(r0, n)
        for k in range(3):
            offs[k][r0:r0 + n] = o[k]
            fracs[k][r0:r0 + n] = f[k]
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    _, live = b6._lane_live_device(offs, fracs)
    outside = sorted(set(live) - set(bk5.lane_combos))
    a4 = a5._replace(lane_off=tuple(offs), lane_frac=tuple(fracs), lanes=None)
    cube0 = b6.backup6d_cuda.cube_launches
    got4 = b6.backup6d_cuda(v, a4)
    cube4 = b6.backup6d_cuda.cube_launches - cube0
    got5 = b6.backup6d_cuda(v, a5)
    torch.cuda.synchronize()
    body5 = ("backup6d_sweep_recompute_cube"
             if b6.backup6d_cuda.cube_launches - cube0 > cube4
             else "backup6d_sweep")
    cube = b6.cube_body(a5)
    same_v = torch.equal(got4.values, got5.values)
    same_a = torch.equal(got4.argmin, got5.argmin)
    print(f"{nw}x{ne} lane plan filled from the plain recompute in "
          f"{fill_s:.3f} s: its {len(live)} live lane combos outside B.5's "
          f"{len(bk5.lane_combos)} admitted: {len(outside)}; one B.4 sweep "
          f"on it ({'backup6d_sweep_cube' if cube4 else 'backup6d_sweep'}) "
          f"vs one B.5 sweep ({body5}): values bitwise {same_v}, "
          f"argmin identical {same_a}")
    check(not outside, f"plain recompute taps outside the admitted combos: "
          f"{outside[:5]}")
    check(same_v and same_a, "B.5's recomputed lanes != the plain "
          "recompute's")
    check((body5 == "backup6d_sweep_recompute_cube") == cube == bool(cube4),
          f"B.5 ran {body5}, B.4 {cube4} cube launches, on a structure the "
          f"cube body {'fits' if cube else 'does not fit'}")


def recompute_rows_vs_plain(bk5, v, got, blocks) -> None:
    """B.5's output rows ``got`` of one sweep of the ``(NW, NE)`` table
    ``v`` against :func:`backup6d_plain` with the plain recompute, on each
    row block ``(r0, r1)`` of ``blocks``: the block's local table holds its
    halo rows, 0.0 past the table's edges; values and argmin bitwise."""
    lo, hi = bk5.row_reach()
    nw = bk5.NW
    for r0, r1 in blocks:
        local = torch.nn.functional.pad(
            v[max(r0 - lo, 0):min(r1 + hi, nw)],
            (0, 0, max(lo - r0, 0), max(r1 + hi - nw, 0))).contiguous()
        want = b6.backup6d_plain(local, b6.block_args(bk5.args, r0, r1, lo,
                                                      hi))
        same_v = torch.equal(got.values[r0:r1], want.values)
        same_a = torch.equal(got.argmin[r0:r1], want.argmin)
        print(f"rows [{r0}, {r1}) of {nw} vs backup6d_plain on their block: "
              f"values bitwise {same_v}, argmin identical {same_a}")
        check(same_v and same_a, f"B.5's rows [{r0}, {r1}) != the plain "
              "version")


def envelope_phases(device, b3) -> list:
    """Phases 17-21; returns the entries of B.4 and B.5 in the kernels
    line. ``b3``: B.3's entry (phase 16), for its ns per cell."""
    rng = np.random.default_rng(SEED + 3)
    chk_cfg = attitude.AttitudeConfig(**ENV_CHECK)

    phase("17. B.4 and B.5 vs their plain versions, one sweep, bitwise")
    _, plan, cost = attitude.build_full(chk_cfg)
    _, rplan, rcost = attitude.build_full(chk_cfg, lane_mode="recompute")
    check(attitude.plan_is_flat(plan)
          and isinstance(rplan, b6.RecomputePlan),
          "19^3x14^3: not a flat stored plan and a recompute plan")
    err4 = err5 = 0.0
    bk32 = b6.Backup6D(plan, cost)
    v = seeded_table(rng, bk32)
    err4 = max(err4, envelope_vs_plain(bk32, v, "B.4 int32"))
    bk8 = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8)
    err4 = max(err4, envelope_vs_plain(bk8, v, "B.4 uint8"))
    same = torch.equal(bk8(v).argmin.int(), bk32(v).argmin)
    print(f"B.4 uint8 argmin == int32 argmin: {same}")
    check(same, "uint8 argmin != int32 argmin")
    bkm = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8,
                      track_argmin=False)
    err4 = max(err4, envelope_vs_plain(bkm, v, "B.4 min-only"))
    rm = bkm(v)
    same = torch.equal(rm.values, bk8(v).values) and \
        int(rm.argmin.max()) == 0
    print(f"B.4 min-only: values == tracking values and argmin all zero "
          f"{same}")
    check(same, "min-only sweep")
    bk5 = b6.Backup6D(rplan, rcost, argmin_dtype=torch.uint8)
    err5 = max(err5, envelope_vs_plain(bk5, v, "B.5 recompute"))
    bk5m = b6.Backup6D(rplan, rcost, argmin_dtype=torch.uint8,
                       track_argmin=False)
    err5 = max(err5, envelope_vs_plain(bk5m, v, "B.5 min-only"))
    plain_ms4 = cuda_time_ms(lambda: b6.backup6d_plain(v, bk8.args),
                             repeats=3)
    plain_ms5 = cuda_time_ms(lambda: b6.backup6d_plain(v, bk5.args),
                             repeats=3)
    print(f"plain versions at 19^3x14^3 (CUDA events, warm, median of 3): "
          f"B.4 {plain_ms4:.4f} ms, B.5 {plain_ms5:.4f} ms")
    for edge_plan, label in (
            (attitude.build_full(chk_cfg, edge="clamp"), "B.4 edge='clamp'"),
            (attitude.build_full(chk_cfg, edge="clamp",
                                 lane_mode="recompute"),
             "B.5 edge='clamp'")):
        _, p, c = edge_plan
        cbk = b6.Backup6D(p, c, argmin_dtype=torch.uint8)
        e = envelope_vs_plain(cbk, v, label)
        if cbk.recompute:
            err5 = max(err5, e)
        else:
            err4 = max(err4, e)
    carry_vs_allocating(plan, cost, "B.4")
    carry_vs_allocating(rplan, rcost, "B.5")
    del plan, cost, rplan, rcost, bk32, bk8, bkm, bk5, bk5m, v, cbk
    free_cuda()
    full_cfg = attitude.AttitudeConfig(**ATT_FULL)
    reset_launch_counts()
    nf = attitude.solve_full(full_cfg, num_sweeps=50)
    fl = attitude.solve_full(full_cfg, num_sweeps=50, flat=True,
                             carry_padded=True)
    counts = launch_counts()
    same = (fl.is_flat and torch.equal(fl.result.values.reshape(
        nf.result.values.shape), nf.result.values)
        and torch.equal(fl.result.argmin.reshape(nf.result.argmin.shape),
                        nf.result.argmin))
    print(f"11^3x10^3, 50 sweeps: flat carry-mode solve (B.4) vs non-flat "
          f"solve (B.3): values and argmin identical {same}; launches "
          f"{counts}")
    check(same and counts["backup6d"] == 100
          and counts["backup6d_cube"] == 100,
          "forced flat solve != B.3 solve, or not 100 cube-body launches")

    phase("18. main path: attitude.solve_full(AttitudeConfig(n_mesh_w=30, "
          "n_mesh_q=16), num_sweeps=100, segment_size=50, tol=1e-6, "
          "tol_mode='rel')")
    main_cfg = attitude.AttitudeConfig(**ENV_MAIN)
    cells = main_cfg.n_mesh_w**3 * main_cfg.n_mesh_q**3
    tmp = tempfile.TemporaryDirectory()
    ckpt = str(Path(tmp.name) / "envelope.npz")
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    sol = attitude.solve_full(main_cfg, num_sweeps=ENV_SWEEPS,
                              segment_size=50, checkpoint_path=ckpt,
                              **ENV_TOL)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = launch_counts()
    peak_main = torch.cuda.max_memory_allocated() / 2**30
    res = sol.result
    print(f"{cells} cells, {res.num_sweeps} of the horizon's "
          f"{main_cfg.n_stage - 1} sweeps: {main_s:.3f} s incl. the build "
          f"({main_s / ENV_SWEEPS * 1e3:.1f} ms a sweep; the 5999 sweeps "
          f"would take about {main_s / ENV_SWEEPS * 5999 / 60:.1f} min); "
          f"flat result {sol.is_flat} {tuple(res.values.shape)}, argmin "
          f"{res.argmin.dtype}; launches {counts}; peak device memory "
          f"{peak_main:.3f} GiB; converged {res.converged}")
    check(sol.is_flat and res.argmin.dtype == torch.uint8
          and res.num_sweeps == ENV_SWEEPS
          and counts["backup6d"] == ENV_SWEEPS,
          "main path: not the flat, uint8, carry-mode envelope")
    check(counts["backup6d_cube"] == ENV_SWEEPS,
          f"main path: {counts['backup6d_cube']} of {ENV_SWEEPS} launches "
          "through the cube body")
    check(bool(torch.isfinite(res.values).all()), "main path: non-finite")
    print(f"V range [{float(res.values.min())}, {float(res.values.max())}]")
    main_launches = counts["backup6d"]

    class Killed(Exception):
        pass

    def kill_past_50(k, _v):
        if k >= 50:
            raise Killed

    t0 = time.perf_counter()
    grid, rplan, rcost = attitude.build_full(main_cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rbk = b6.Backup6D(rplan, rcost, argmin_dtype=torch.uint8,
                      carry_padded=True)
    torch.cuda.synchronize()
    print(f"recompute plan build {t1 - t0:.3f} s, Backup6D (row plan, lane "
          f"liveness, cost split) {time.perf_counter() - t1:.3f} s")
    check(rbk.recompute, "main path: the auto plan is not the recompute "
          "plan (B.5)")
    recompute_vs_filled_plan(rbk, res.values)
    free_cuda()
    ckpt2 = str(Path(tmp.name) / "killed.npz")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        value_iteration_segmented(
            PlanShape.of(rplan), None, ENV_SWEEPS, segment_size=50,
            backup=rbk, checkpoint_path=ckpt2, checkpoint_axes=grid.axes,
            narrow_argmin_result=True, on_segment=kill_past_50, **ENV_TOL)
    except Killed:
        pass
    engine_b = torch.cuda.max_memory_allocated() - base
    print(f"the segmented carry-mode engine's own peak over its first two "
          f"segments and checkpoints: {engine_b / 2**30:.3f} GiB "
          f"({engine_b / cells:.2f} B per cell)")
    del rbk, rplan
    ck = io.load_values(ckpt2, device=device)
    resumed = attitude.solve_full(
        main_cfg, num_sweeps=ENV_SWEEPS, segment_size=50,
        init_values=ck.values, start_sweep=ck.sweep_index, prev_f=ck.prev_f,
        **ENV_TOL).result
    same = (torch.equal(resumed.values, res.values)
            and torch.equal(resumed.argmin, res.argmin)
            and ck.sweep_index + resumed.num_sweeps == res.num_sweeps)
    print(f"killed after the checkpoint at sweep {ck.sweep_index} "
          f"({tuple(ck.values.shape)} table), resumed for "
          f"{resumed.num_sweeps} sweeps: equals the uninterrupted solve "
          f"{same}")
    check(ck.sweep_index >= 50 and same, "resumed != uninterrupted")
    del resumed, ck
    free_cuda()
    reset_launch_counts()
    t0 = time.perf_counter()
    psol = attitude.solve_full(main_cfg, num_sweeps=ENV_SWEEPS,
                               segment_size=50, lane_mode="plan", **ENV_TOL)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    counts = launch_counts()
    plan_launches = counts["backup6d"]
    scale = float(res.values.abs().max())
    dv = float((psol.result.values - res.values).abs().max())
    agree = float((psol.result.argmin == res.argmin).float().mean())
    print(f"lane_mode='plan' (chunked build, B.4): {plan_s:.3f} s; launches "
          f"{counts}; vs recompute max |dV| {dv} ({dv / scale:.3e} of "
          f"max|V| {scale}), argmin agreement {agree}")
    check(plan_launches == ENV_SWEEPS
          and counts["backup6d_cube"] == ENV_SWEEPS,
          "lane_mode='plan' did not run B.4 through the cube body")
    check(dv <= 1e-4 * scale and agree >= 0.999,
          "stored plan and recompute disagree")
    del psol
    free_cuda()
    t0 = time.perf_counter()
    _, p1, c1 = attitude.build_full(main_cfg, lane_mode="plan")
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, p2, c2 = attitude.build_full(main_cfg, lane_mode="plan",
                                    chunked=False)
    torch.cuda.synchronize()
    oneshot_s = time.perf_counter() - t0
    oneshot_gib = torch.cuda.max_memory_allocated() / 2**30
    same = all(torch.equal(a, b) for a, b in
               zip(p1.lo + p1.frac + c1, p2.lo + p2.frac + c2))
    print(f"chunked build {chunk_s:.3f} s, one-shot flat build "
          f"{oneshot_s:.3f} s (peak device memory with both plans "
          f"{oneshot_gib:.3f} GiB): equal bitwise {same}")
    check(same, "chunked build != one-shot build")
    del p1, c1, p2, c2
    free_cuda()

    phase("19. serving: a 1000-stage flat-argmin rollout")
    t0 = time.perf_counter()
    X, U, _ = attitude.rollout_full(sol, num_stages=1000)
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    Un = U.cpu().numpy()
    check(bool(torch.isfinite(X).all()) and bool(np.isin(
        np.round(Un.astype(np.float64), 4), [-0.11, 0.0, 0.11]).all()),
        "flat rollout: non-finite states or torques off the set")
    print(f"1000-stage rollout of the 30^3x16^3 policy: {roll_s:.3f} s, "
          f"{roll_s / 999 * 1e3:.3f} ms per stage")

    phase("20. past 2^31 cells: solve_full(AttitudeConfig(n_mesh_w=60, "
          "n_mesh_q=22), num_sweeps=1) from a seeded table")
    v_main = res.values
    del X, U, res
    free_cuda()
    max_cfg = attitude.AttitudeConfig(**ENV_MAX)
    big_cells = max_cfg.n_mesh_w**3 * max_cfg.n_mesh_q**3
    big_nw, big_ne = max_cfg.n_mesh_w**3, max_cfg.n_mesh_q**3
    check(big_cells > 2**31, f"{big_cells} cells do not pass 2^31")
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    v_big = torch.rand((big_nw, big_ne), generator=gen, device=device)
    v_big.mul_(100.0)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    log = _io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        big = attitude.solve_full(max_cfg, num_sweeps=1, init_values=v_big,
                                  verbose=True)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    print(log.getvalue(), end="")
    sweep_s = [float(x) for x in re.findall(r"step \d+ - ([\d.]+) seconds",
                                            log.getvalue())]
    peak_big = (torch.cuda.max_memory_allocated() - base) / 2**30
    check(len(sweep_s) == 1 and big.is_flat
          and bool(torch.isfinite(big.result.values).all()),
          "2.30B-cell solve")
    print(f"{big_cells} cells: {big_s:.3f} s, of which the build "
          f"{big_s - sum(sweep_s):.3f} s and the sweep {sweep_s[0]} s "
          f"({sweep_s[0] / big_cells * 1e9:.3f} ns per cell); peak device "
          f"memory of the solve {peak_big:.3f} GiB "
          f"({peak_big * 2**30 / big_cells:.2f} B per cell) beside the "
          "seeded table")
    got = big.result
    del big
    free_cuda()
    # the last rows against the plain version of their row block, on the
    # local table of those rows and their halos (zeros below the table)
    _, rplan, rcost = attitude.build_full(max_cfg)
    rbk = b6.Backup6D(rplan, rcost, argmin_dtype=torch.uint8)
    del rplan
    lo, hi = rbk.row_reach()
    k = 2
    args = b6.block_args(rbk.args, big_nw - k, big_nw, lo, hi)
    local = torch.cat([v_big[big_nw - k - lo:],
                       torch.zeros((hi, big_ne), device=device)])
    want = b6.backup6d_plain(local, args)
    torch.cuda.synchronize()
    first = (big_nw - k) * big_ne
    same_v = torch.equal(got.values[big_nw - k:], want.values)
    same_a = torch.equal(got.argmin[big_nw - k:], want.argmin)
    print(f"the last {k} rows (flat offsets {first} to {big_cells - 1}, past "
          f"2^31 = {2**31}) vs the plain version of their block: values "
          f"bitwise {same_v}, argmin identical {same_a}")
    check(first > 2**31 and same_v and same_a,
          "the rows past 2^31 cells != the plain version")
    del got, rbk, args, local, want, v_big
    free_cuda()

    phase("21. timing (CUDA events, warm, median of 10)")
    _, plan, cost = attitude.build_full(main_cfg, lane_mode="plan")
    bk4 = b6.Backup6D(plan, cost, argmin_dtype=torch.uint8,
                      carry_padded=True, consume_plan=True)
    del plan, cost
    out_v = torch.empty_like(v_main)
    out_a = torch.empty(v_main.shape, dtype=torch.uint8, device=device)
    ms4 = cuda_time_ms(lambda: b6.backup6d_cuda(
        v_main, bk4.args, out_v=out_v, out_a=out_a))
    bound4 = backup6d_bound(bk4)
    line4 = (f"B.4 (uint8, tracking), backup6d_sweep_cube: "
             f"{kernel_registers(B4_KERNEL)}; {tile_line(v_main, bk4.args)}")
    del bk4
    free_cuda()
    _, rplan, rcost = attitude.build_full(main_cfg)
    bk5 = b6.Backup6D(rplan, rcost, argmin_dtype=torch.uint8,
                      carry_padded=True)
    ms5 = cuda_time_ms(lambda: b6.backup6d_cuda(
        v_main, bk5.args, out_v=out_v, out_a=out_a))
    bound5 = backup6d_bound(bk5)
    b3_ns = b3["ms"] * 1e6 / 1331000
    print(f"30^3x16^3 sweep: B.4 (uint8, tracking) {ms4:.4f} ms "
          f"({ms4 * 1e6 / cells:.3f} ns per cell, bound {bound4['bound_ms']:.4f}"
          f" ms by {bound4['bound_by']}), B.5 {ms5:.4f} ms "
          f"({ms5 * 1e6 / cells:.3f} ns per cell, bound "
          f"{bound5['bound_ms']:.4f} ms by {bound5['bound_by']}); B.3 at "
          f"11^3x10^3 {b3_ns:.3f} ns per cell")
    print(line4)
    print(f"B.5 (uint8, tracking), backup6d_sweep_recompute_cube: "
          f"{kernel_registers(B5_CUBE_KERNEL)}; "
          f"{tile_line(v_main, bk5.args)}")
    print(f"backup6d_sweep<uint8, tracking, recompute> (B.5 on any other "
          f"structure, and min-only): {kernel_registers(B5_KERNEL)}")
    del bk5, rplan, rcost
    free_cuda()
    # the envelope cell's configuration, 48^3 x 10^3
    _, rplan, rcost = attitude.build_full(
        attitude.AttitudeConfig(**ENV_CELL))
    bk5c = b6.Backup6D(rplan, rcost, argmin_dtype=torch.uint8,
                       carry_padded=True)
    del rplan, rcost
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    v_cell = torch.rand((bk5c.NW, bk5c.NE), generator=gen, device=device)
    v_cell.mul_(100.0)
    out_vc = torch.empty_like(v_cell)
    out_ac = torch.empty(v_cell.shape, dtype=torch.uint8, device=device)
    cube0 = b6.backup6d_cuda.cube_launches
    ms5c = cuda_time_ms(lambda: b6.backup6d_cuda(
        v_cell, bk5c.args, out_v=out_vc, out_a=out_ac), repeats=5)
    bound5c = backup6d_bound(bk5c)
    print(f"48^3x10^3 sweep (the envelope cell's): B.5 {ms5c:.4f} ms "
          f"({ms5c * 1e6 / (bk5c.NW * bk5c.NE):.3f} ns per cell) vs bound "
          f"{bound5c['bound_ms']:.4f} ms by {bound5c['bound_by']} "
          f"({bound5c['bound_ms'] / ms5c:.1%} of it); "
          f"{b6.backup6d_cuda.cube_launches - cube0} of its "
          f"launches through backup6d_sweep_recompute_cube; "
          f"{tile_line(v_cell, bk5c.args)}")
    check(b6.backup6d_cuda.cube_launches - cube0 == 6,
          "the 48^3x10^3 sweeps did not run backup6d_sweep_recompute_cube")
    # the timed body at the cell's shape, bitwise: its first, a middle and
    # its last rows (ragged against the 2-row chunks) against the plain
    # version, then every cell against B.4 on a lane plan filled from the
    # plain recompute
    nw5 = bk5c.NW
    recompute_rows_vs_plain(
        bk5c, v_cell, b6.BackupResult(out_vc, out_ac),
        [(0, 97), (nw5 // 2 - 51, nw5 // 2 + 46), (nw5 - 97, nw5)])
    recompute_vs_filled_plan(bk5c, v_cell)
    del bk5c, v_cell, out_vc, out_ac
    free_cuda()
    print("plain_ms of B.4 and B.5 are at 19^3x14^3 (phase 17); ms and "
          "bound_ms at 30^3x16^3")
    tmp.cleanup()
    common = {"route": "cuda", "source": "ocdp_tpu_torch/csrc/backup6d.cu",
              "library_ms": None}
    return [
        {"name": "backup6d_flat",
         "replaces": "ocdp_tpu/ops/pallas_backup6.py:973 (flat plan, uint8 "
                     "argmin, min-only, padded carry)",
         "launches": plan_launches, "max_abs_err": err4, "ms": ms4,
         "plain_ms": plain_ms4, **bound4, **common},
        {"name": "backup6d_recompute",
         "replaces": "ocdp_tpu/ops/pallas_backup6.py:973 (lane recompute, "
                     ":1003-1036)",
         "launches": main_launches, "max_abs_err": err5, "ms": ms5,
         "plain_ms": plain_ms5, **bound5, **common},
    ]


def band_vs_plain(bk, v, label: str) -> float:
    """One sweep of a banded backup through its kernel and through its
    plain version on the same inputs; bitwise. Returns max |dV|."""
    got = bk(v)
    want = bk.plain(v)
    torch.cuda.synchronize()
    err = float((got.values - want.values).abs().max())
    same_v = torch.equal(got.values, want.values)
    same_a = torch.equal(got.argmin, want.argmin)
    taps = [(st.taps, [len(t) for t in st.valid_taps])
            for st in bk.channel_taps]
    print(f"{label} ({tuple(v.shape)}, {bk.args.n_actions} actions, "
          f"{len(bk.args.terms)} cost terms, taps and live taps a plan "
          f"{taps}): values bitwise {same_v}, argmin identical {same_a}, "
          f"max |dV| {err}")
    check(bool(torch.isfinite(got.values).all()), f"{label}: non-finite")
    check(same_v and same_a, f"{label}: kernel != plain version")
    return err


def tied_band_backup(device):
    """A simplified axis with h = 0 (every query on a grid point), no cost
    and each action listed twice: every minimum is an exact tie."""
    cfg = attitude.AttitudeConfig(n_mesh_w=1000, n_mesh_t=300, h=0.0)
    _, plan, _ = attitude.build_simplified_axis(cfg, 0, device=device)

    def twice(a):
        return torch.cat([a, a], dim=-1) if a.shape[-1] > 1 else a

    plan = InterpPlan(tuple(twice(a) for a in plan.lo),
                      tuple(twice(a) for a in plan.frac), plan.grid_shape)
    return bb.BandBackup2D(plan, torch.zeros((1000, 300, 6), device=device))


def band_bound(bk) -> dict:
    """The four-corner evaluation's FP32 operations (16 per cell and
    action: two complements, four weight and four value products, four
    sums, the cost add and the compare, and one add a cost term) and its
    bytes: the table, the plan and each cost term at their broadcast
    shapes, values and argmin out."""
    n_c, n1, n2, n_act = bk.args.shape
    n_cells = n_c * n1 * n2
    plan_bytes = sum(8 * lo.numel() for lo in bk.args.lo)
    term_bytes = sum(4 * t.numel() for t in bk.args.terms)
    nbytes = 4 * n_cells + plan_bytes + term_bytes + 8 * n_cells
    ops = (16.0 + len(bk.args.terms)) * n_cells * n_act
    return bound(ops, nbytes)


def band_tap_loop_ops(bk) -> float:
    """FP32 operations of the plain tap loop on the same inputs, per cell
    and action (of the first plan): 3 per live tap pair, 5 per live tap's
    weight, the cost adds and the compare."""
    n1, n2 = (len(t) for t in bk.channel_taps[0].valid_taps)
    return 3.0 * n1 * n2 + 5.0 * (n1 + n2) + 1.0 + len(bk.args.terms)


def band_batch_checks(cfg, pp, device, rng) -> float:
    """The batched and factorized modes against the plain version and the
    one-axis launches, and a graph replay against eager launches; bitwise.
    Returns max |dV|."""
    err = 0.0
    for edge in ("clamp", "extrapolate"):
        built = [attitude.build_simplified_axis(cfg, i, edge=edge,
                                                device=device)
                 for i in range(3)]
        bk = bb.BandBackup2D.stack([p for _, p, _ in built],
                                   [t for _, _, t in built])
        v = torch.from_numpy(rng.uniform(0.0, 100.0, (3,) + tuple(
            built[0][1].grid_shape)).astype(np.float32)).to(device)
        err = max(err, band_vs_plain(bk, v, f"the three axes in one launch, "
                                     f"edge={edge!r}"))
        got = bk(v)
        for i, (_, plan, terms) in enumerate(built):
            one = bb.BandBackup2D(plan, terms)(v[i].contiguous())
            check(torch.equal(one.values, got.values[i])
                  and torch.equal(one.argmin, got.argmin[i]),
                  f"axis {i} of the batch != its own launch")
        print(f"edge={edge!r}: each axis of the batch equals its own launch "
              "bitwise")
    dense = bb.BandBackup2D(pp.plan, pp.stage_cost)
    split = bb.BandBackup2D(pp.plan, pp.cost_terms)
    pv = torch.from_numpy(rng.uniform(0.0, 100.0, pp.plan.grid_shape)
                          .astype(np.float32)).to(device)
    a, b = split(pv), dense(pv)
    check(torch.equal(a.values, b.values) and torch.equal(a.argmin, b.argmin),
          "position: the factorized cost != the dense one")
    err = max(err, band_vs_plain(split, pv, "position C=3, factorized cost "
                                 f"({len(split.args.terms)} terms)"))
    print("position C=3: factorized (3 terms) and dense cost bitwise equal")
    # GRAPH_SWEEPS sweeps of the three axes: one graph replay vs eager
    runs = []
    for graphed in (False, True):
        cur = v.clone()
        nxt = torch.empty_like(cur)
        arg = torch.zeros(cur.shape, dtype=torch.int32, device=device)

        def step(src, dst):
            bk.sweep_into(src, dst, arg)

        if graphed:
            bk.prepare()
            before = bb.band_backup2d_cuda.launches
            g = SweepGraph(step, cur, nxt, GRAPH_SWEEPS, (bk.launcher,))
            g.replay()
            check(bb.band_backup2d_cuda.launches == before + GRAPH_SWEEPS,
                  "a replay did not count its launches")
        else:
            ping_pong(step, cur, nxt, GRAPH_SWEEPS)
        torch.cuda.synchronize()
        runs.append((cur, arg))
    same = all(torch.equal(x, y) for x, y in zip(*runs))
    print(f"{GRAPH_SWEEPS} sweeps of the three axes, one CUDA graph vs eager "
          f"launches: values and argmin identical {same}")
    check(same, "B.6 graph replay != eager launches")
    return err


def nearest_index(ax: np.ndarray, q: float) -> int:
    """MATLAB 'nearest' on an ascending axis, lower snap at midpoints."""
    lo = int(np.clip(np.searchsorted(ax, q, side="right") - 1, 0,
                     len(ax) - 2))
    return lo + 1 if (q - ax[lo]) > (ax[lo + 1] - q) else lo


ATT_GOLDEN_RTOL = 2e-5   # the JAX package's gather solve needs 1.38e-5
POS_GOLDEN_RTOL = 1e-4   # the JAX package's gather solve needs 6.46e-5


def golden_check(label, values, policy, gold_v, gold_p, rtol) -> None:
    """Values within ``rtol`` (atol 1e-6) of a golden made by the JAX
    stencil, and over 99.95% equal policies: the stencil nests its tap sums,
    B.6 sums (w1 w2) leaf flat, so the goldens' own 1e-6 holds for neither
    the port nor the JAX package's gather solve (tests/test_torch_
    position.py)."""
    d = np.abs(values - gold_v)
    need = float(((d - 1e-6) / np.maximum(np.abs(gold_v), 1e-30)).max())
    agree = float((policy == gold_p).mean())
    print(f"{label}: max |dV| {float(d.max())} (max |V| "
          f"{float(np.abs(gold_v).max())}), needs rtol {need:.4e} (bound "
          f"{rtol}), policy agreement {agree}")
    np.testing.assert_allclose(values, gold_v, rtol=rtol, atol=1e-6)
    check(agree > 0.9995, f"{label}: policy agreement {agree}")


def band_phases(device) -> dict:
    """Phases 22-26; returns B.6's entry of the kernels line."""
    rng = np.random.default_rng(SEED + 4)
    cfg = attitude.AttitudeConfig()
    pcfg = position.PositionConfig()

    phase("22. B.6 vs plain, one sweep, bitwise")
    max_err = 0.0
    for edge in ("clamp", "extrapolate"):
        for i in range(3):
            _, plan, terms = attitude.build_simplified_axis(
                cfg, i, edge=edge, device=device)
            bk = bb.BandBackup2D(plan, terms)
            v = torch.from_numpy(rng.uniform(0.0, 100.0, plan.grid_shape)
                                 .astype(np.float32)).to(device)
            label = f"axis {i}, edge={edge!r}"
            max_err = max(max_err, band_vs_plain(bk, v, label + ", random"))
            v50 = value_iteration_finite(plan, None, 50, backup=bk).values
            max_err = max(max_err, band_vs_plain(bk, v50,
                                                 label + ", after 50 sweeps"))
    pp = position.build(pcfg, device=device)
    pbk = bb.BandBackup2D(pp.plan, pp.stage_cost)
    pv = torch.from_numpy(rng.uniform(0.0, 100.0, pp.plan.grid_shape)
                          .astype(np.float32)).to(device)
    max_err = max(max_err, band_vs_plain(pbk, pv, "position C=3, random"))
    pv50 = value_iteration_finite(pp.plan, None, 50, backup=pbk).values
    max_err = max(max_err, band_vs_plain(pbk, pv50,
                                         "position C=3, after 50 sweeps"))
    tie = tied_band_backup(device)
    tv = torch.from_numpy(rng.uniform(0.0, 100.0, (1000, 300))
                          .astype(np.float32)).to(device)
    max_err = max(max_err, band_vs_plain(tie, tv, "exact ties"))
    check(int(tie(tv).argmin.max()) == 0, "exact ties: a later action won")
    max_err = max(max_err, band_batch_checks(cfg, pp, device, rng))

    phase("23. main path: attitude.solve_simplified(AttitudeConfig())")
    sweeps = cfg.n_stage - 1
    reset_launch_counts()
    t0 = time.perf_counter()
    sol = attitude.solve_simplified(cfg)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts.pop("band_backup2d")
    chs = bb.band_backup2d_cuda.channel_sweeps
    print(f"attitude.solve_simplified(AttitudeConfig()): {solve_s:.3f} s for "
          f"3 x {sweeps} sweeps incl. the builds "
          f"({solve_s / sweeps * 1e3:.4f} ms a batched sweep); band_backup2d "
          f"launches {launches} for {chs} channel-sweeps (the three axes in "
          f"one launch, {sweeps // GRAPH_SWEEPS} CUDA graph replays of "
          f"{GRAPH_SWEEPS}), others {counts}")
    check(launches == sweeps and chs == 3 * sweeps,
          f"band_backup2d launched {launches} times for {chs} channel-"
          f"sweeps, want {sweeps} for {3 * sweeps}")
    check(not any(counts.values()), "another backup kernel launched")
    check(all(v.is_cuda and tuple(v.shape) == (cfg.n_mesh_w, cfg.n_mesh_t)
              and bool(torch.isfinite(v).all()) for v in sol.values),
          "main path: wrong device, shape or non-finite values")
    print(f"V ranges {[(float(v.min()), float(v.max())) for v in sol.values]}")
    k50 = attitude.solve_simplified(cfg, num_sweeps=250, impl="kernel")
    p50 = attitude.solve_simplified(cfg, num_sweeps=250, impl="plain",
                                    device=device)
    same = all(torch.equal(a, b) for a, b in
               zip(k50.values + k50.u_tables, p50.values + p50.u_tables))
    print(f"250 sweeps (2 graph replays and 50 eager launches), kernel vs "
          f"plain: values and torque tables identical {same}")
    check(same, "250-sweep solve: kernel != plain")
    with np.load(GOLDEN_DIR / "attitude_axis_golden.npz") as z:
        gold = {k: z[k] for k in z.files}
    gsol = attitude.solve_simplified(cfg, num_sweeps=int(gold["sweeps"]),
                                     edge="extrapolate")
    golden_check(f"{int(gold['sweeps'])} sweeps, edge='extrapolate', vs "
                 "attitude_axis_golden",
                 np.stack([v.cpu().numpy() for v in gsol.values]),
                 np.stack([t.cpu().numpy() for t in gsol.u_tables]),
                 gold["values"], gold["u_tables"], ATT_GOLDEN_RTOL)

    phase("24. serving on the simplified policy")
    t0 = time.perf_counter()
    X, U = attitude.rollout_simplified_plant(sol)
    torch.cuda.synchronize()
    plant_s = time.perf_counter() - t0
    Xn, Un = X.cpu().numpy(), U.cpu().numpy()
    check(bool(np.isfinite(Xn).all()) and Xn.shape == (cfg.n_stage, 3, 2),
          "plant rollout: shape or non-finite")
    check(bool(np.all(np.abs(Xn[-1, :, 1])
                      < 0.5 * np.maximum(np.abs(Xn[0, :, 1]), 0.05))),
          "plant rollout: the angles do not shrink")
    check(bool(np.isin(np.round(np.abs(Un).astype(np.float64), 4),
                       [0.0, 0.11]).all()), "plant rollout: torques off the set")
    print(f"plant rollout, {cfg.n_stage - 1} stages: {plant_s:.3f} s, "
          f"{plant_s / (cfg.n_stage - 1) * 1e3:.3f} ms a stage; angles "
          f"{Xn[0, :, 1].tolist()} -> {Xn[-1, :, 1].tolist()} rad")

    def real_flight(label, **kw):
        t0 = time.perf_counter()
        X, _ = attitude.rollout_simplified_real_dynamics(sol, **kw)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        Xn = X.cpu().numpy()
        qn = np.linalg.norm(Xn[:, 3:7], axis=1)
        e0, e1 = (float(np.linalg.norm(Xn[k, 3:6])) for k in (0, -1))
        print(f"{label}, {len(Xn) - 1} stages: {s:.3f} s, "
              f"{s / (len(Xn) - 1) * 1e3:.3f} ms a stage; max ||q| - 1| "
              f"{float(np.abs(qn - 1).max())}; |q_vec| {e0} -> {e1}")
        check(bool(np.isfinite(Xn).all()), f"{label}: non-finite")
        check(bool(np.abs(qn - 1).max() < 1e-4), f"{label}: |q| != 1")
        return X, e0, e1

    Xr, e0, e1 = real_flight("real dynamics, rk4", integrator="rk4")
    check(e1 < 0.5 * e0, "rk4 flight: the attitude error does not shrink")
    Xo, e0, e1 = real_flight("real dynamics, ode45", integrator="ode45",
                             num_stages=200)
    check(e1 < e0, "ode45 flight: the attitude error does not shrink")
    print(f"max |X_ode45 - X_rk4| over those 200 stages "
          f"{float((Xo - Xr[:len(Xo)]).abs().max())}")
    t0 = time.perf_counter()
    Xl, _, drift = attitude.linear_control_response(cfg)
    torch.cuda.synchronize()
    lin_s = time.perf_counter() - t0
    print(f"PD baseline, {len(Xl) - 1} stages: {lin_s:.3f} s, "
          f"{lin_s / (len(Xl) - 1) * 1e3:.3f} ms a stage; |q| drift "
          f"{float(drift)}")
    check(float(drift) < 1e-5, "PD baseline: |q| drift")

    phase("25. position: solve, golden, a 1 s RKF45 flight")
    reset_launch_counts()
    t0 = time.perf_counter()
    psol = position.solve(pcfg)
    torch.cuda.synchronize()
    psolve_s = time.perf_counter() - t0
    counts = launch_counts()
    plaunches = counts.pop("band_backup2d")
    pchs = bb.band_backup2d_cuda.channel_sweeps
    psweeps = pcfg.n_stage - 1
    print(f"position.solve(PositionConfig()): {psolve_s:.3f} s for {psweeps} "
          f"sweeps of 3 channels incl. the build "
          f"({psolve_s / psweeps * 1e3:.4f} ms a sweep); band_backup2d "
          f"launches {plaunches} for {pchs} channel-sweeps, others {counts}")
    check(plaunches == psweeps and pchs == 3 * psweeps
          and not any(counts.values()),
          f"position: {plaunches} launches, want {psweeps}")
    check(bool(torch.isfinite(psol.result.values).all()), "position: "
          "non-finite")
    k50 = position.solve(pcfg, num_sweeps=250)
    p50 = position.solve(pcfg, num_sweeps=250, impl="plain", device=device)
    same = (torch.equal(k50.result.values, p50.result.values)
            and torch.equal(k50.result.argmin, p50.result.argmin))
    print(f"250 sweeps, kernel vs plain: values and argmin identical {same}")
    check(same, "position 250-sweep solve: kernel != plain")
    with np.load(GOLDEN_DIR / "position_golden.npz") as z:
        gold = {k: z[k] for k in z.files}
    gres = position.solve(pcfg, num_sweeps=int(gold["sweeps"])).result
    golden_check(f"{int(gold['sweeps'])} sweeps vs position_golden",
                 gres.values.cpu().numpy(), gres.argmin.cpu().numpy(),
                 gold["values"], gold["argmin"], POS_GOLDEN_RTOL)
    t0 = time.perf_counter()
    T, X, U = position.get_optimal_path(psol, t_final=1.0)
    torch.cuda.synchronize()
    flight_s = time.perf_counter() - t0
    Xn = X.cpu().numpy().astype(np.float64)
    Un = U.cpu().numpy().astype(np.float64)
    tables = psol.u_tables.cpu().numpy().astype(np.float64)
    axes = [np.asarray(a, np.float64) for a in psol.problem.grid.axes[1:]]
    wrong = sum(Un[k, c] != tables[c, nearest_index(axes[0], Xn[k, c]),
                                   nearest_index(axes[1], Xn[k, 3 + c])]
                for k in range(len(Un)) for c in range(3))
    print(f"RKF45 flight, 1 s ({len(Un)} stages): {flight_s:.3f} s, "
          f"{flight_s / len(Un) * 1e3:.3f} ms a stage; controls off the "
          f"nearest lookup: {wrong}; x {Xn[0, :3].tolist()} -> "
          f"{Xn[-1, :3].tolist()}")
    check(bool(np.isfinite(Xn).all()) and wrong == 0,
          "position flight: non-finite or a control off the lookup")

    phase("26. timing (CUDA events, warm, median of 10)")
    built = [attitude.build_simplified_axis(cfg, i, device=device)
             for i in range(3)]
    bk3 = bb.BandBackup2D.stack([p for _, p, _ in built],
                                [t for _, _, t in built])
    v3 = torch.stack(sol.values).contiguous()
    o3 = torch.empty_like(v3)
    a3 = torch.empty(v3.shape, dtype=torch.int32, device=device)
    k_ms = graph_time_ms(lambda: bb.band_backup2d_cuda(
        v3, bk3.args, out_v=o3, out_a=a3))
    w_ms = cuda_time_ms(lambda: bb.band_backup2d_cuda(v3, bk3.args),
                        inner=20)
    p_ms = cuda_time_ms(lambda: bb.band_backup2d_plain(v3, bk3.args,
                                                       bk3.channel_taps))
    _, plan, terms = built[0]
    bk = bb.BandBackup2D(plan, terms)
    v = sol.values[0].contiguous()
    v1 = v[None]
    o1, a1 = torch.empty_like(v1), torch.empty(v1.shape, dtype=torch.int32,
                                               device=device)
    one_ms = graph_time_ms(lambda: bb.band_backup2d_cuda(
        v1, bk.args, out_v=o1, out_a=a1))
    pbk = bb.BandBackup2D(pp.plan, pp.cost_terms)
    pv3 = psol.result.values.contiguous()
    po, pa = torch.empty_like(pv3), torch.empty(pv3.shape, dtype=torch.int32,
                                                device=device)
    pk_ms = graph_time_ms(lambda: bb.band_backup2d_cuda(
        pv3, pbk.args, out_v=po, out_a=pa))
    pw_ms = cuda_time_ms(lambda: bb.band_backup2d_cuda(pv3, pbk.args),
                         inner=20)
    pp_ms = cuda_time_ms(lambda: bb.band_backup2d_plain(pv3, pbk.args,
                                                        pbk.channel_taps))
    rb = RowBandBackup2D(plan, terms)
    rb_ms = cuda_time_ms(lambda: rb(v), inner=5)
    rlb = rl.RowLaneBackup(plan, terms, perm=(0, 1), row_axes=1)
    v2 = v.reshape(rlb.NW, rlb.NE)
    rl_ms = graph_time_ms(lambda: rl.rowlane_backup_cuda(v2, rlb.args))
    rl_err = rowlane_vs_plain(rlb, v, "B.2 on simplified axis 0 "
                              f"({len(rlb.row_combos)} row combos, lane taps "
                              f"{rlb.e_taps})")
    ref = bk(v)
    print(f"row-band and B.2 vs B.6 on that sweep: max |dV| "
          f"{float((rb(v).values - ref.values).abs().max())} and "
          f"{float((rlb(v).values - ref.values).abs().max())}; B.2 vs its "
          f"plain version max |dV| {rl_err}")
    solve_ms = cuda_time_ms(lambda: attitude.solve_simplified(cfg),
                            repeats=3)
    psolve_ms = cuda_time_ms(lambda: position.solve(pcfg), repeats=3)
    bnd = band_bound(bk3)
    bnd1 = band_bound(bk)
    pbnd = band_bound(pbk)
    print(f"3 x 1000 x 300 in one launch (the main path's): kernel alone "
          f"{k_ms:.5f} ms, through the wrapper back to back {w_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, bound {bnd['bound_ms']:.5f} ms "
          f"({bnd['bound_by']}: {bnd['flops']:.4e} operations, "
          f"{bnd['bytes']:.4e} bytes; the plain tap loop does "
          f"{band_tap_loop_ops(bk3) / (16 + len(bk3.args.terms)):.1f}x the "
          f"four-corner operations)")
    print(f"one 1000 x 300 axis: kernel alone {one_ms:.5f} ms, bound "
          f"{bnd1['bound_ms']:.5f} ms; row-band {rb_ms:.4f} ms; B.2 "
          f"(rowlane) kernel alone {rl_ms:.4f} ms")
    print(f"3x201x201 (factorized cost): kernel alone {pk_ms:.5f} ms, "
          f"through the wrapper {pw_ms:.4f} ms, plain {pp_ms:.4f} ms, bound "
          f"{pbnd['bound_ms']:.5f} ms ({pbnd['bound_by']}: "
          f"{pbnd['flops']:.4e} operations, {pbnd['bytes']:.4e} bytes); "
          f"position launches on its main path {plaunches}")
    print(f"solve_simplified(AttitudeConfig()) {solve_ms / 1e3:.3f} s warm "
          f"({solve_s:.3f} s cold), {solve_ms / sweeps:.4f} ms a sweep of "
          f"the three axes; position.solve(PositionConfig()) "
          f"{psolve_ms / 1e3:.3f} s warm ({psolve_s:.3f} s cold), "
          f"{psolve_ms / psweeps:.4f} ms a sweep")
    for line in ptxas_lines("band_sweep"):
        print(line)
    blocks = _build.load().band_backup2d_blocks_per_sm(bk3.args.n_actions)
    print(f"band_sweep<3>: no dynamic shared memory, 256 threads a block, "
          f"{blocks} blocks an SM: occupancy "
          f"{blocks * 256 / SM_MAX_THREADS:.0%}")
    return {
        "name": "band_backup2d",
        "route": "cuda",
        "source": "ocdp_tpu_torch/csrc/band_backup2d.cu",
        "replaces": "ocdp_tpu/ops/pallas_backup.py:90",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        **bnd,
        "library_ms": None,
    }


# past the default kernels' tap capacities (C.4): the fine-theta simplified
# solve, whose lane axes have 11, 15 and 9 taps (B.2's any-tap kind 2 took 8
# before), and a lighter roll axis with an asymmetric rate range, whose row
# taps (-1, 0, 1, 2) x (-1, 0, 1) x (-1, 0, 1) give 36 live combos
# (backup6d_wide; backup6d_sweep takes 3 taps an axis)
FINE_THETA = dict(n_mesh_t=1000)
WIDE_6D = dict(n_mesh_w=15, n_mesh_q=10, h=0.02, w_min_deg=-50.0,
               w_max_deg=30.0, inertia_diag=(0.0225, 0.028317, 0.0245))
# backup6d_wide's mangled names: <int32, tracking> (B.3's wrapper, the main
# path), <uint8, tracking> (B.4's), <uint8, tracking, recompute> (B.5's)
B3W_KERNEL = "backup6d_wideIiLb1ELb0E"
B4W_KERNEL = "backup6d_wideIhLb1ELb0E"
B5W_KERNEL = "backup6d_wideIhLb1ELb1E"
# B.2 vs B.6 over a whole solve: rtol 2e-5 with an absolute floor of 2e-5 x
# max |V|. The two sum the interpolation in different orders, and over 5999
# sweeps the difference reaches 5e-5 to 1.2e-4 of the value at cells whose
# |V| is 0.2-1% of max |V| (at the default configuration too, where B.2's
# kind 2 ran before), while |dV| stays below 2e-6 x max |V| everywhere;
# B.6 and the gather solve agree to 1.2e-6 per cell
# (scripts/torch_simplified_routes.py)
WIDE_RTOL = 2e-5


def wide_tap_phases(device) -> list:
    """Phases 38-40: B.2 and B.3 on the tap structures past the default
    kernels' capacities that the TPU kernel takes; returns their entries of
    the kernels line."""
    rng = np.random.default_rng(SEED + 7)
    cfg_t = attitude.AttitudeConfig(**FINE_THETA)
    cfg6 = attitude.AttitudeConfig(**WIDE_6D)

    phase("38. B.2 on lane axes of 9-15 taps, backup6d_wide on 36 row "
          "combos: each wrapper vs plain, one sweep, bitwise")
    axes, rl_err = [], 0.0
    for axis in range(3):
        _, plan, terms = attitude.build_simplified_axis(cfg_t, axis,
                                                        device=device)
        bk = rl.RowLaneBackup(plan, terms, perm=(0, 1), row_axes=1)
        v = torch.from_numpy(rng.uniform(0.0, 100.0, plan.grid_shape)
                             .astype(np.float32)).to(device)
        kind = rl.launch_plan(bk.to_table(v), [bk.args]).kind
        taps = bk.e_taps[1]
        rl_err = max(rl_err, rowlane_vs_plain(
            bk, v, f"n_mesh_t=1000 axis {axis} ({len(bk.row_combos)} row x "
            f"{len(bk.lane_combos)} lane combos, lane taps {taps[0]}.."
            f"{taps[-1]}, kind {kind})"))
        check(kind == 2 and len(taps) > 8, f"axis {axis}: kind {kind}, "
              f"{len(taps)} lane taps")
        axes.append((bk, v))
    _, plan6, cost6 = attitude.build_full(cfg6, device=device)
    bk6 = b6.Backup6D(plan6, cost6)
    v6 = seeded_table(rng, bk6)
    plan, _ = b6.tile_occupancy(v6, bk6.args)
    check(len(bk6.row_combos) == 36 and plan.wide,
          f"{len(bk6.row_combos)} row combos, wide plan {plan.wide}")
    b3_err = backup6d_vs_plain(bk6, v6.reshape(bk6.state_shape),
                               "backup6d_wide in B.3's mode")
    _, fplan, fcost = attitude.build_full(cfg6, flat=True, device=device)
    b3_err = max(b3_err, envelope_vs_plain(
        b6.Backup6D(fplan, fcost, argmin_dtype=torch.uint8), v6,
        "backup6d_wide in B.4's (flat) mode"))
    del fplan, fcost
    _, rplan, rcost = attitude.build_full(cfg6, lane_mode="recompute",
                                          device=device)
    b3_err = max(b3_err, envelope_vs_plain(
        b6.Backup6D(rplan, rcost, argmin_dtype=torch.uint8), v6,
        "backup6d_wide in B.5's (recompute) mode"))
    del rplan, rcost
    b3_err = max(b3_err, *b7_blocks_vs_plain(
        bk6, v6, 2, "backup6d_wide in B.7's modes", slices=True))
    free_cuda()

    phase("39. main paths: attitude.solve_simplified(AttitudeConfig("
          "n_mesh_t=1000), impl='rowlane') and attitude.solve_full(the "
          "36-combo AttitudeConfig), the rollout")
    sweeps_t = cfg_t.n_stage - 1
    reset_launch_counts()
    t0 = time.perf_counter()
    sol_t = attitude.solve_simplified(cfg_t, impl="rowlane")
    torch.cuda.synchronize()
    rl_solve_s = time.perf_counter() - t0
    counts = launch_counts()
    rl_launches = counts.pop("rowlane_backup")
    print(f"solve_simplified(AttitudeConfig(n_mesh_t=1000), impl='rowlane'): "
          f"{rl_solve_s:.3f} s for 3 x {sweeps_t} sweeps incl. the builds; "
          f"rowlane_backup launches {rl_launches}, others {counts}")
    check(rl_launches == 3 * sweeps_t,
          f"rowlane_backup launched {rl_launches} times, want "
          f"{3 * sweeps_t}")
    check(not any(counts.values()), "another backup kernel launched")
    t0 = time.perf_counter()
    ref_t = attitude.solve_simplified(cfg_t)             # B.6, auto
    torch.cuda.synchronize()
    band_solve_s = time.perf_counter() - t0
    for axis, (a, b, ua, ub) in enumerate(zip(sol_t.values, ref_t.values,
                                              sol_t.u_tables,
                                              ref_t.u_tables)):
        check(a.is_cuda and tuple(a.shape) == (cfg_t.n_mesh_w, 1000)
              and bool(torch.isfinite(a).all()), f"axis {axis}: values")
        d = (a - b).abs()
        rel = float((d / b.abs().clamp_min(1e-30)).max())
        scale = float(b.abs().max())
        same = float((ua == ub).double().mean())
        print(f"axis {axis}: B.2 (rowlane) vs B.6 (auto, {band_solve_s:.3f} "
              f"s): max |dV| / max |V| {float(d.max()) / scale:.3e}, max "
              f"relative |dV| {rel:.3e} (rtol {WIDE_RTOL}, atol {WIDE_RTOL} "
              f"x max |V| = {WIDE_RTOL * scale:.4e}), torque tables equal "
              f"on {same:.6f} of the cells")
        check(torch.allclose(a, b, rtol=WIDE_RTOL, atol=WIDE_RTOL * scale)
              and same > 0.9995,
              f"axis {axis}: rowlane solve != auto solve within tolerance")
    sweeps6 = cfg6.n_stage - 1
    reset_launch_counts()
    t0 = time.perf_counter()
    sol6 = attitude.solve_full(cfg6)
    torch.cuda.synchronize()
    b3w_solve_s = time.perf_counter() - t0
    counts = launch_counts()
    b3w_launches = counts.pop("backup6d")
    print(f"solve_full(the 36-combo AttitudeConfig, 15^3 x 10^3): "
          f"{b3w_solve_s:.3f} s for {sweeps6} sweeps incl. the build; "
          f"backup6d launches {b3w_launches} (backup6d_wide), others "
          f"{counts}")
    check(b3w_launches == sweeps6,
          f"backup6d launched {b3w_launches} times, want {sweeps6}")
    check(not any(counts.values()), "another backup kernel launched")
    res6 = sol6.result
    check(res6.values.is_cuda and tuple(res6.values.shape) == bk6.state_shape
          and bool(torch.isfinite(res6.values).all()),
          "36-combo main path: wrong device, shape or non-finite values")
    print(f"V range [{float(res6.values.min())}, "
          f"{float(res6.values.max())}]")
    k5 = attitude.solve_full(cfg6, num_sweeps=5, impl="kernel")
    p5 = attitude.solve_full(cfg6, num_sweeps=5, impl="plain", device=device)
    same = (torch.equal(k5.result.values, p5.result.values)
            and torch.equal(k5.result.argmin, p5.result.argmin))
    print(f"5 sweeps, kernel vs plain: values and argmin identical {same}")
    check(same, "36-combo solve: kernel != plain")
    t0 = time.perf_counter()
    X, U, _ = attitude.rollout_full(sol6, num_stages=1000)
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    check(bool(torch.isfinite(X).all()) and bool(np.isin(np.round(
        U.cpu().numpy().astype(np.float64), 4), [-0.11, 0.0, 0.11]).all()),
          "36-combo rollout: non-finite states or torques off the set")
    print(f"1000-stage nearest rollout: {roll_s:.3f} s, final |q_vec| "
          f"{float(X[-1, 3:6].norm())}")
    del sol6, k5, p5, ref_t
    free_cuda()

    phase("40. timing (CUDA events, warm, median of 10)")
    rl_ms = []
    for axis, (bk, v) in enumerate(axes):
        tab = bk.to_table(v)
        ov, oa = torch.empty_like(tab), torch.empty(
            tab.shape, dtype=torch.int32, device=device)
        k_ms = graph_time_ms(lambda: rl.rowlane_backup_cuda(tab, bk.args, ov,
                                                            oa))
        p_ms = cuda_time_ms(lambda: rl.rowlane_backup_plain(tab, bk.args),
                            repeats=3)
        rb = rowlane_bound(bk)
        plan, blocks = rl.tile_occupancy(tab, [bk.args])
        rl_ms.append((k_ms, p_ms, rb))
        print(f"n_mesh_t=1000 axis {axis} ({bk.NW} x {bk.NE}, "
              f"{len(bk.lane_combos)} lane taps): kernel alone {k_ms:.4f} ms "
              f"(bound {rb['bound_ms']:.5f} ms, {rb['bound_by']}), plain "
              f"{p_ms:.4f} ms; {plan.smem_bytes} B dynamic shared memory "
              f"(tile {plan.rows} x {plan.lanes}, stage {plan.n_staged} x "
              f"{plan.width}, kind {plan.kind}), {blocks} blocks an SM: "
              f"occupancy {blocks * plan.threads / SM_MAX_THREADS:.0%}")
    for line in ptxas_lines("rowlane_tiles"):
        if "Lb0ELi32" in line:
            print(line)
    print(f"solve_simplified(n_mesh_t=1000): rowlane {rl_solve_s:.3f} s "
          f"cold, {rl_solve_s / (3 * sweeps_t) * 1e3:.4f} ms a channel-"
          f"sweep; auto (B.6) {band_solve_s:.3f} s")
    v2 = v6.reshape(bk6.NW, bk6.NE).contiguous()
    w_ms = cuda_time_ms(lambda: b6.backup6d_cuda(v2, bk6.args), inner=5)
    wp_ms = cuda_time_ms(lambda: b6.backup6d_plain(v2, bk6.args), repeats=3)
    wb = backup6d_bound(bk6)
    evals = bk6.NW * bk6.NE * bk6.args.n_actions
    print(f"backup6d_wide, 15^3 x 10^3, 36 x 27 combos: kernel {w_ms:.4f} "
          f"ms ({evals / w_ms * 1e3:.4e} evals/s; bound {wb['bound_ms']:.4f} "
          f"ms, {wb['bound_by']}), plain {wp_ms:.4f} ms; solve_full "
          f"{b3w_solve_s:.3f} s for {sweeps6} sweeps incl. the build "
          f"({b3w_solve_s / sweeps6 * 1e3:.4f} ms a sweep)")
    for label, name in (("<int32, tracking> (B.3, B.7)", B3W_KERNEL),
                        ("<uint8, tracking> (B.4)", B4W_KERNEL),
                        ("<uint8, tracking, recompute> (B.5)", B5W_KERNEL)):
        print(f"backup6d_wide{label}: {kernel_registers(name)}")
    print(f"backup6d_wide's launch: {tile_line(v2, bk6.args)}")
    k_ms, p_ms, rb = rl_ms[1]
    return [
        {"name": "rowlane_backup_wide_lanes", "route": "cuda",
         "source": "ocdp_tpu_torch/csrc/rowlane_backup.cu",
         "replaces": "ocdp_tpu/ops/pallas_backup6.py:973",
         "launches": rl_launches, "max_abs_err": rl_err, "ms": k_ms,
         "plain_ms": p_ms, **rb, "library_ms": None},
        {"name": "backup6d_wide", "route": "cuda",
         "source": "ocdp_tpu_torch/csrc/backup6d.cu",
         "replaces": "ocdp_tpu/ops/pallas_backup6.py:973",
         "launches": b3w_launches, "max_abs_err": b3_err, "ms": w_ms,
         "plain_ms": wp_ms, **wb, "library_ms": None},
    ]


def b7_vs_plain(v, args, label: str) -> float:
    """One B.7 launch and its plain version on the same inputs; bitwise.
    Returns max |dV|."""
    got = b6.backup6d_cuda(v, args)
    want = b6.backup6d_plain(v, args)
    torch.cuda.synchronize()
    err = float((got.values - want.values).abs().max())
    same_v = torch.equal(got.values, want.values)
    same_a = torch.equal(got.argmin, want.argmin)
    print(f"{label}: values bitwise {same_v}, argmin identical {same_a}, "
          f"max |dV| {err}")
    check(bool(torch.isfinite(got.values).all()), f"{label}: non-finite")
    check(same_v and same_a, f"{label}: B.7 != plain version")
    return err


def b7_blocks_vs_plain(bk, v, n: int, label: str,
                       slices: bool = False) -> tuple:
    """Every rank's block of an ``n``-rank row split, from the local table
    the halo exchange would give it (zero halos at the edges), through B.7
    and its plain version. With ``slices``, each block's 3 digit slices
    too (the shapes of a rows x 3 mesh), each against its plain version,
    and combined by the first minimum against the block's B.7 result.
    Returns max |dV| of the block calls and of the slice calls."""
    from ocdp_tpu_torch.parallel.mesh import first_min, row_blocks

    lo, hi = bk.row_reach()
    vp = torch.nn.functional.pad(v.reshape(bk.NW, bk.NE), (0, 0, lo, hi))
    err_b = err_s = 0.0
    for s, (r0, r1) in enumerate(row_blocks(bk.NW, n)):
        args = b6.block_args(bk.args, r0, r1, lo, hi)
        local = vp[r0:r1 + lo + hi].contiguous()
        where = f"{label}, block {s}/{n} rows [{r0}, {r1}) + halo ({lo}, {hi})"
        err_b = max(err_b, b7_vs_plain(local, args, where))
        if not slices:
            continue
        vals, argm = [], []
        for g in range(3):
            sa = b6.slice_args(args, 9 * g, 9 * g + 9)
            check(sa.action_digits == 3, f"{where}: slice {g} left the "
                  "digit path")
            err_s = max(err_s, b7_vs_plain(local, sa,
                                           f"{where}, digit slice {g}"))
            res = b6.backup6d_cuda(local, sa)
            vals.append(res.values)
            argm.append(res.argmin)
        vmin, arg = first_min(vals, argm, 27)
        whole = b6.backup6d_cuda(local, args)
        torch.cuda.synchronize()
        same = (torch.equal(vmin, whole.values)
                and torch.equal(arg, whole.argmin.to(arg.dtype)))
        print(f"{where}: 3 slices combined by the first minimum equal the "
              f"block's B.7 sweep (values, argmin) {same}")
        check(same, f"{where}: combined slices != the block's sweep")
    return err_b, err_s


def b7_slices_vs_one_sweep(bk, v, label: str) -> float:
    """The 3 digit slices through B.7 and their plain versions; combined by
    the first minimum they must equal one B.3 sweep bitwise."""
    from ocdp_tpu_torch.parallel.mesh import first_min

    v2 = v.reshape(bk.NW, bk.NE).contiguous()
    err, vals, args = 0.0, [], []
    for g in range(3):
        sa = b6.slice_args(bk.args, 9 * g, 9 * g + 9)
        check(sa.action_digits == 3, f"{label}: slice {g} left the digit "
              "path")
        err = max(err, b7_vs_plain(v2, sa, f"{label}, digit slice {g}"))
        res = b6.backup6d_cuda(v2, sa)
        vals.append(res.values)
        args.append(res.argmin)
    vmin, arg = first_min(vals, args, 27)
    one = b6.backup6d_cuda(v2, bk.args)
    torch.cuda.synchronize()
    same = torch.equal(vmin, one.values) and torch.equal(arg, one.argmin)
    print(f"{label}: 3 slices combined by the first minimum equal one B.3 "
          f"sweep (values, argmin) {same}")
    check(same, f"{label}: combined slices != one B.3 sweep")
    return err


def same_result(got, want, label: str) -> None:
    same_v = torch.equal(got.values.reshape(want.values.shape), want.values)
    same_a = torch.equal(got.argmin.reshape(want.argmin.shape),
                         want.argmin.to(got.argmin.dtype))
    print(f"{label}: values bitwise {same_v}, argmin identical {same_a}")
    check(same_v and same_a, f"{label}: != the one-device solve")


def multirank_phases(device) -> list:
    """Phases 27-32: B.7 and the multi-rank engines on in-process meshes
    on the one card; returns B.7's two entries of the kernels line."""
    from ocdp_tpu_torch.parallel import (make_mesh, measure_halo6_comms,
                                         value_iteration_converged_halo6,
                                         value_iteration_finite_halo,
                                         value_iteration_finite_halo6,
                                         value_iteration_finite_sharded)
    from ocdp_tpu_torch.parallel.dryrun import dryrun_multichip
    from ocdp_tpu_torch.parallel.halo6 import Halo6Backup, _Ranks

    rng = np.random.default_rng(SEED + 6)
    full_cfg = attitude.AttitudeConfig(**ATT_FULL)
    sweeps = full_cfg.n_stage - 1

    phase("27. B.7 vs plain: row blocks, digit slices, bitwise")
    plan, cost, bk = attitude_backup(device, **ATT_FULL)
    v_rand = torch.from_numpy(rng.uniform(0.0, 100.0, (bk.NW, bk.NE))
                              .astype(np.float32)).to(device)
    v50 = attitude.solve_full(full_cfg, num_sweeps=50).result.values
    err_b = err_s = 0.0
    for label, v in (("random table", v_rand), ("after 50 sweeps", v50)):
        for n in (2, 4):
            eb, es = b7_blocks_vs_plain(bk, v, n, f"11^3x10^3 {label}",
                                        slices=n == 2)
            err_b, err_s = max(err_b, eb), max(err_s, es)
        err_s = max(err_s, b7_slices_vs_one_sweep(bk, v,
                                                  f"11^3x10^3 {label}"))
    for dt, track, mode in ((torch.uint8, True, "uint8"),
                            (torch.uint8, False, "min-only")):
        mbk = b6.Backup6D(plan, cost, argmin_dtype=dt, track_argmin=track)
        err_b = max(err_b, b7_blocks_vs_plain(mbk, v_rand, 2,
                                              f"11^3x10^3 {mode}")[0])
    lo, hi = bk.row_reach()
    r0, r1 = 400, 900
    check(r0 - lo >= 0 and r1 + hi <= bk.NW, "the block's halos leave the "
          "table")
    err_b = max(err_b, b7_vs_plain(
        v50.reshape(bk.NW, bk.NE)[r0 - lo:r1 + hi].contiguous(),
        b6.block_args(bk.args, r0, r1, lo, hi),
        f"11^3x10^3 after 50 sweeps, block rows [{r0}, {r1}) with both "
        f"halos ({lo}, {hi}) from the table"))
    _, _, tbk = attitude_backup(device, "tie", n_mesh_w=5, n_mesh_q=4,
                                h=0.0)
    v_tie = torch.from_numpy(rng.uniform(0.0, 100.0, (tbk.NW, tbk.NE))
                             .astype(np.float32)).to(device)
    eb, es = b7_blocks_vs_plain(tbk, v_tie, 2, "exact ties", slices=True)
    err_b, err_s = max(err_b, eb), max(err_s, es)
    err_s = max(err_s, b7_slices_vs_one_sweep(tbk, v_tie, "exact ties"))
    for g in range(3):
        res = b6.backup6d_cuda(v_tie, b6.slice_args(tbk.args, 9 * g,
                                                    9 * g + 9))
        check(bool((res.argmin == 9 * g).all()),
              "exact ties: a later action of the slice won")
    env_cfg = attitude.AttitudeConfig(**ENV_CHECK)
    for kind, kw in (("flat (B.4)", dict(flat=True, lane_mode="plan")),
                     ("recompute (B.5)", dict(lane_mode="recompute"))):
        _, eplan, ecost = attitude.build_full(env_cfg, **kw)
        ebk = b6.Backup6D(eplan, ecost, argmin_dtype=torch.uint8)
        del eplan
        ev = seeded_table(rng, ebk)
        err_b = max(err_b, b7_blocks_vs_plain(ebk, ev, 2,
                                              f"19^3x14^3 {kind}")[0])
        del ebk, ev
        free_cuda()

    phase("28. main path: value_iteration_finite_halo6 at 11^3x10^3 on 2 "
          "ranks, 5999 sweeps")
    mesh2 = make_mesh(("s",), (2,))
    reset_launch_counts()
    t0 = time.perf_counter()
    res2 = value_iteration_finite_halo6(plan, cost, sweeps, mesh2)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = launch_counts()
    block_launches = counts["backup6d"]
    print(f"2 ranks, {sweeps} sweeps incl. the build: {main_s:.3f} s; "
          f"launches {counts}; halo bytes moved {mesh2.halo_bytes}")
    check(block_launches == 2 * sweeps,
          f"backup6d (B.7 blocks) launched {block_launches} times, want "
          f"{2 * sweeps}")
    check(all(n == 0 for k, n in counts.items() if k != "backup6d"),
          "another backup kernel, or the cube body, ran on the halo6 main "
          "path")
    same_result(res2, REF_6D["finite"], "halo6 on 2 ranks vs phase 13's "
                "one-device solve")
    comms = measure_halo6_comms(full_cfg, 2)
    print(f"halo per sweep: {comms}")
    check(mesh2.halo_bytes == sweeps
          * comms["halo_bytes_per_sweep_analytic"]
          and comms["halo_bytes_per_sweep_counted"]
          == comms["halo_bytes_per_sweep_analytic"],
          "halo bytes moved != analytic count")

    phase("29. the 2 x 3 mesh (rows x digit slices), the converged engines, "
          "4 ranks with policies")
    mesh23 = make_mesh(("s", "a"), (2, 3))
    reset_launch_counts()
    t0 = time.perf_counter()
    res23 = value_iteration_finite_halo6(plan, cost, sweeps, mesh23,
                                         action_axis_name="a")
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    counts = launch_counts()
    check(res23.digit_path is True, "2 x 3 mesh: the digit slices did not "
          "take the factorized phase")
    slice_launches = counts["backup6d"]
    print(f"2 x 3 mesh, {sweeps} sweeps: {mesh_s:.3f} s; launches {counts}")
    check(slice_launches == 6 * sweeps and counts["backup6d_cube"] == 0,
          f"backup6d (B.7 slices) launched {slice_launches} times, "
          f"{counts['backup6d_cube']} of them the cube body, want "
          f"{6 * sweeps} and 0")
    same_result(res23, REF_6D["finite"], "halo6 on 2 x 3 vs phase 13")
    conv = REF_6D["converged"]
    for label, m, act in (("2 ranks", mesh2, None),
                          ("2 x 3", mesh23, "a")):
        t0 = time.perf_counter()
        got = value_iteration_converged_halo6(
            plan, cost, sweeps, m, check_every=50, tol=1e-2,
            action_axis_name=act)
        torch.cuda.synchronize()
        print(f"converged halo6 on {label}: {got.num_sweeps} sweeps, "
              f"converged {got.converged}, {time.perf_counter() - t0:.3f} s;"
              f" one device: {conv.num_sweeps}, {conv.converged}; check log "
              f"max |d| {float((got.checks - conv.checks).abs().max())}")
        check(got.num_sweeps == conv.num_sweeps
              and got.converged == conv.converged,
              f"converged halo6 on {label} stopped elsewhere")
        same_result(got, conv, f"converged halo6 on {label} vs phase 14")
    ref200 = value_iteration_finite(plan, cost, 200, backup=bk,
                                    store_policies=True)
    got = value_iteration_finite_halo6(plan, cost, 200,
                                       make_mesh(("s",), (4,)),
                                       store_policies=True)
    check(got.policies.dtype == torch.uint8
          and torch.equal(got.policies, ref200.policies),
          "4 ranks: policies != one device")
    same_result(got, ref200, "halo6 on 4 ranks, 200 sweeps, uint8 "
                "policies")

    phase("30. the envelope over the mesh: 30^3x16^3 recompute plan, 2 "
          "ranks, 10 sweeps; the width guard")
    _, rplan, rcost = attitude.build_full(attitude.AttitudeConfig(
        **ENV_MAIN))
    rbk = b6.Backup6D(rplan, rcost, argmin_dtype=torch.uint8,
                      carry_padded=True)
    one = value_iteration_finite(PlanShape.of(rplan), None, 10, backup=rbk,
                                 narrow_argmin_result=True)
    del rbk
    free_cuda()
    t0 = time.perf_counter()
    got = value_iteration_finite_halo6(rplan, rcost, 10, mesh2,
                                       argmin_dtype=torch.uint8)
    torch.cuda.synchronize()
    print(f"30^3x16^3 recompute on 2 ranks, 10 sweeps incl. the build: "
          f"{time.perf_counter() - t0:.3f} s")
    same_v = torch.equal(got.values.reshape(-1), one.values.reshape(-1))
    same_a = torch.equal(got.argmin.reshape(-1),
                         one.argmin.to(torch.int32).reshape(-1))
    print(f"vs one-device B.5: values bitwise {same_v}, argmin identical "
          f"{same_a}")
    check(same_v and same_a, "envelope halo6 != one-device B.5")
    del got, one, rplan, rcost
    free_cuda()
    try:
        value_iteration_finite_halo6(plan, cost, 2, make_mesh(("s",), (11,)))
        raise RuntimeError("chip_smoke: the width guard did not raise")
    except ValueError as e:
        print(f"11 ranks at 11^3x10^3 (133-row reach, 121-row blocks): {e}")

    phase("31. the other engines and the dryrun twin")
    kp = kirk.build(kirk.KirkConfig())
    kref = value_iteration_finite(kp.plan, kp.stage_cost, 199,
                                  store_policies=True)
    kgot = value_iteration_finite_sharded(
        kp.plan, kp.stage_cost, 199, make_mesh(("s", "a"), (2, 2)),
        action_axis_name="a", store_policies=True)
    same_result(kgot, kref, "replicated-table engine, Kirk 2 x 2, 199 "
                "sweeps (gather)")
    check(torch.equal(kgot.policies, kref.policies), "Kirk policies")
    scfg = attitude.AttitudeConfig()
    _, splan, sterms = attitude.build_simplified_axis(scfg, 0)
    sref = value_iteration_finite(splan, sterms, 300,
                                  backup=bb.BandBackup2D(splan, sterms))
    reset_launch_counts()
    sgot = value_iteration_finite_halo(splan, sterms, 300,
                                       make_mesh(("s",), (2,)),
                                       backup="band")
    check(launch_counts()["band_backup2d"] == 600, "band halo launches")
    same_result(sgot, sref, "halo engine, B.6 on simplified axis 0 "
                "(1000x300), 2 ranks, 300 sweeps")
    pcfg = pos_att.PosAttConfig()
    for engine in ("halo", "replicated"):
        ctrl, pres = pos_att.solve_channel_sharded(
            pcfg, "x", make_mesh(("s",), (2,)), max_sweeps=300,
            engine=engine)
        rctrl, rres = pos_att.solve_channel(pcfg, "x", impl="gather",
                                            max_sweeps=300)
        check(pres.num_sweeps == rres.num_sweeps, f"{engine}: stop sweep")
        same_result(pres, rres, f"solve_channel_sharded('{engine}'), x "
                    "channel, 300 sweeps vs impl='gather'")
    reset_launch_counts()
    t0 = time.perf_counter()
    ep = pos_att.solve_ep(pcfg)
    torch.cuda.synchronize()
    ep_s = time.perf_counter() - t0
    ser = pos_att.solve(pcfg)
    for name, c in ser.controllers.items():
        check(torch.equal(ep.controllers[name].values, c.values)
              and torch.equal(ep.controllers[name].argmin, c.argmin)
              and ep.results[name].num_sweeps
              == ser.results[name].num_sweeps,
              f"solve_ep channel {name} != serial pos_att.solve")
    print(f"solve_ep(PosAttConfig()) on 4 ranks: {ep_s:.3f} s, equals the "
          f"serial pos_att.solve bitwise per channel (sweeps "
          f"{[r.num_sweeps for r in ep.results.values()]})")
    print(f"dryrun_multichip(8): {dryrun_multichip(8)}")

    phase("32. timing (CUDA events, warm, median of 10)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    hb2 = Halo6Backup(plan, cost, mesh2)
    st2 = _Ranks(hb2, v50)
    blk_args = hb2.args[0]
    t_blk = st2.cur[0]
    out_v = torch.empty((blk_args.n_rows, bk.NE), device=device)
    out_a = torch.empty((blk_args.n_rows, bk.NE), dtype=torch.int32,
                        device=device)
    blk_ms = cuda_time_ms(lambda: b6.backup6d_cuda(
        t_blk, blk_args, out_v=out_v, out_a=out_a), inner=5)
    blk_plain_ms = cuda_time_ms(lambda: b6.backup6d_plain(t_blk, blk_args))
    hb23 = Halo6Backup(plan, cost, mesh23, action_axis_name="a")
    st23 = _Ranks(hb23, v50)
    sl_args = hb23.args[0]
    t_sl = st23.cur[0]
    sl_ms = cuda_time_ms(lambda: b6.backup6d_cuda(
        t_sl, sl_args, out_v=out_v, out_a=out_a), inner=5)
    sl_plain_ms = cuda_time_ms(lambda: b6.backup6d_plain(t_sl, sl_args))
    sweep2_ms = cuda_time_ms(st2.sweep, inner=5)
    sweep23_ms = cuda_time_ms(st23.sweep, inner=5)
    v2 = v50.reshape(bk.NW, bk.NE).contiguous()
    one_ms = cuda_time_ms(lambda: b6.backup6d_cuda(v2, bk.args), inner=5)
    bnd_blk = backup6d_args_bound(blk_args, bk.NE)
    bnd_sl = backup6d_args_bound(sl_args, bk.NE)
    print(f"[{smi}] 11^3x10^3: one B.7 block (rank 0 of 2, "
          f"{blk_args.n_rows} rows + halo {blk_args.halo}) {blk_ms:.4f} ms, "
          f"plain {blk_plain_ms:.4f} ms, bound {bnd_blk['bound_ms']:.5f} ms "
          f"({bnd_blk['bound_by']}); one digit slice (rank (0, 0) of 2 x 3) "
          f"{sl_ms:.4f} ms, plain {sl_plain_ms:.4f} ms, bound "
          f"{bnd_sl['bound_ms']:.5f} ms ({bnd_sl['bound_by']}); one B.3 "
          f"sweep of the whole table {one_ms:.4f} ms")
    print(f"B.7b block: {tile_line(t_blk, blk_args)}; B.7a slice: "
          f"{tile_line(t_sl, sl_args)}")
    print(f"[{smi}] halo6 sweep (exchange, kernels, combine): 2 ranks "
          f"{sweep2_ms:.4f} ms, 2 x 3 {sweep23_ms:.4f} ms; the 5999-sweep "
          f"solves {main_s:.3f} s and {mesh_s:.3f} s")
    common = {"route": "cuda", "source": "ocdp_tpu_torch/csrc/backup6d.cu",
              "library_ms": None}
    return [
        {"name": "backup6d_slice",
         "replaces": "ocdp_tpu/ops/pallas_backup6.py:696 (digit_slice)",
         "launches": slice_launches, "max_abs_err": err_s, "ms": sl_ms,
         "plain_ms": sl_plain_ms, **bnd_sl, **common},
        {"name": "backup6d_block",
         "replaces": "ocdp_tpu/ops/pallas_backup6.py:1390 (row-block "
                     "layout: row_pad_to, pad_top/pad_bot)",
         "launches": block_launches, "max_abs_err": err_b, "ms": blk_ms,
         "plain_ms": blk_plain_ms, **bnd_blk, **common},
    ]


def state_shape(cfg) -> tuple:
    return (cfg.n_mesh_x, cfg.n_mesh_v, cfg.n_mesh_t, cfg.n_mesh_w)


BENCH_FAMILIES = ("kirk,attitude_axis,position,pos_att_channel,attitude_6d,"
                  "attitude_6d_converged")
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "workload", "wall_s",
              "baseline_evals_per_s", "families", "device", "build_s"}


def cli(*argvs) -> list:
    """``python -m ocdp_tpu_torch <argv>`` from the repository root, one
    process for each ``argv``, all at once: ``(returncode, stdout,
    stderr)`` for each. Every process is waited for, or killed."""
    procs = [subprocess.Popen([sys.executable, "-m", "ocdp_tpu_torch", *a],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for a in argvs]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            results.append((p.returncode, out, err))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def cli_json(result, argv) -> dict:
    rc, out, err = result
    check(rc == 0, f"CLI {' '.join(argv)} exited {rc}:\n{err}")
    return json.loads(out.strip().splitlines()[-1])


def surface_phases(device) -> None:
    """Phases 33-37: the trace, the entry point, the CLI, the bench and the
    Kirk rollout's time. Phase 36's bench process starts before phase 35's
    CLI processes and runs beside them, so its times are not measurements;
    phase 37 starts after it has ended."""
    sol = trace_phase(device)
    entry_phase(device)
    bench = subprocess.Popen(
        [sys.executable, "-m", "ocdp_tpu_torch.bench"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "BENCH_FAMILIES": BENCH_FAMILIES})
    try:
        cli_phase(sol)
        bench_phase(bench)
    finally:
        if bench.poll() is None:
            bench.kill()
            bench.wait()
    kirk_rollout_phase(device, sol)


def trace_phase(device):
    """Phase 33; returns the traced full Kirk solve."""
    phase("33. profiling.trace around the full Kirk solve")
    cfg = kirk.KirkConfig()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as t:
            sol = kirk.solve(cfg, device=device)
            torch.cuda.synchronize()
        events = json.loads(t.path.read_text())["traceEvents"]
    launches = fb.fused_backup2d_affine_cuda.launches
    kernel_events = Counter(e.get("name", "") for e in events
                            if e.get("cat") == "kernel")
    n_affine, n_split = (sum(n for name, n in kernel_events.items()
                             if key in name)
                         for key in ("affine_sweep", "combine_splits"))
    top = [(name.replace("(anonymous namespace)::", "").split("(")[0][-48:],
            n) for name, n in kernel_events.most_common(4)]
    print(f"trace: {len(events)} events, {sum(kernel_events.values())} "
          f"kernel events; affine_sweep {n_affine}, combine_splits "
          f"{n_split}, launch counter {launches}; top kernels {top}")
    check(launches == cfg.N - 1 and n_affine == launches and n_split == 0,
          f"trace holds {n_affine} B.1 affine events and {n_split} combine "
          f"events for {launches} launches")
    return sol


def entry_phase(device) -> None:
    """Phase 34."""
    phase("34. graft_entry.entry() on the card")
    step, (v0,) = graft_entry.entry()
    check(v0.is_cuda and not bool(v0.any()), "entry: v0 not a zero CUDA table")
    v1 = torch.from_numpy(np.random.default_rng(SEED).uniform(
        0.0, 400.0, tuple(v0.shape)).astype(np.float32)).to(device)
    reset_launch_counts()
    for label, v in (("zero table", v0), ("seeded table", v1)):
        vals, arg = step(v)
        want = fb.fused_backup2d_affine_plain(v, step.backup.args)
        same = (torch.equal(vals, want.values)
                and torch.equal(arg, want.argmin))
        print(f"entry step, {label}: kernel == plain bitwise {same}")
        check(same, f"entry step ({label}) != plain version")
    counts = launch_counts()
    check(counts.pop("fused_backup2d_affine") == 2
          and not any(counts.values()),
          f"entry: B.1 launched {launch_counts()} for 2 steps")


def cli_phase(sol) -> None:
    """Phase 35, against phase 33's in-process Kirk solve ``sol``."""
    phase("35. the CLI in subprocesses: solve kirk, attitude-full resume")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ck, straight = str(Path(tmp, "ck.npz")), str(Path(tmp, "st.npz"))
        common = ("--n-mesh-w", "11", "--n-mesh-q", "10", "--segment-size",
                  "50", "--quiet")
        argvs = [("solve", "kirk", "--quiet"),
                 ("solve", "attitude-full", "--sweeps", "50", "--checkpoint",
                  ck, *common),
                 ("solve", "attitude-full", "--sweeps", "100",
                  "--checkpoint", straight, *common),
                 ("solve", "attitude-full", "--resume", "--quiet")]
        res = cli(*argvs)
        out, first, whole = (cli_json(r, a) for r, a in zip(res, argvs[:3]))
        resume = ("solve", "attitude-full", "--sweeps", "100",
                  "--checkpoint", ck, "--resume", *common)
        resumed = cli_json(cli(resume)[0], resume)
        got, want = io.load_values(ck), io.load_values(straight)
    want_sum = float(sol.result.values.cpu().numpy().sum())
    print(f"solve kirk: values_sum {out['values_sum']} (in process "
          f"{want_sum})")
    check(out["values_sum"] == want_sum, "CLI solve kirk != in-process solve")
    same = torch.equal(got.values, want.values)
    print(f"attitude-full: first segment {first}; resumed {resumed}; "
          f"straight {whole}; checkpoints at sweep {got.sweep_index} / "
          f"{want.sweep_index}, bitwise {same}")
    check(first["sweep_index"] == 50 and resumed["sweeps"] == 50
          and resumed["sweep_index"] == whole["sweep_index"] == 100
          and got.sweep_index == want.sweep_index == 100,
          "attitude-full resume: sweep counts")
    check(same and resumed["values_sum"] == whole["values_sum"],
          "attitude-full: resumed run != straight run")
    bad_rc, _, bad_err = res[3]
    print(f"--resume without --checkpoint: exit {bad_rc}, "
          f"{bad_err.strip().splitlines()[-1:]}")
    check(bad_rc != 0 and "--checkpoint" in bad_err,
          "--resume without --checkpoint did not fail")
    print(f"phase 35 in {time.perf_counter() - t0:.1f} s")


def bench_phase(bench: subprocess.Popen) -> None:
    """Phase 36: waits for the bench process and reads its last line."""
    phase("36. python -m ocdp_tpu_torch.bench (six families)")
    t0 = time.perf_counter()
    stdout, stderr = bench.communicate(timeout=600)
    lines = stdout.strip().splitlines()
    print(lines[-1] if lines else "(no output)")
    check(bench.returncode == 0,
          f"bench exited {bench.returncode}:\n{stderr[-3000:]}")
    line = json.loads(lines[-1])
    check(BENCH_KEYS <= set(line), f"bench line lacks {BENCH_KEYS - set(line)}")
    fams = line["families"]
    check(list(fams) == BENCH_FAMILIES.split(","), "bench families")
    for name, f in fams.items():
        check("error" not in f, f"bench {name}: {f.get('error')}")
        check(f["launches"] > 0, f"bench {name}: its kernel never launched")
        print(f"bench {name}: {f['launches']} launches, {f['impl']}")
    kirk_f = fams["kirk"]
    print(f"bench kirk: {kirk_f['wall_s']} s warm, alternatives "
          f"{kirk_f['alternatives']}")
    check(kirk_f["impl"] == "fused_backup2d_affine"
          and kirk_f["launches"] == kirk.KirkConfig().N - 1,
          "bench kirk: not the affine mode, one launch a sweep")
    print(f"bench: device {line['device']}; waited "
          f"{time.perf_counter() - t0:.1f} s")


def kirk_rollout_phase(device, sol) -> None:
    """Phase 37, on phase 33's full solve ``sol`` and a golden one."""
    phase("37. the Kirk rollout on the card (warm, median of 5)")
    for label, ksol in (("golden", None), ("full", sol)):
        ksol = ksol or kirk.solve(kirk.KirkConfig.golden(), device=device)
        X, U = kirk.optimal_path(ksol, (2.0, 1.0))     # warm-up
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            X, U = kirk.optimal_path(ksol, (2.0, 1.0))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        stages = int(U.shape[0])
        print(f"kirk.optimal_path ({label}, {stages} stages): {dt * 1e3:.3f} "
              f"ms, {dt / stages * 1e3:.4f} ms a stage; max |X[-1]| "
              f"{float(X[-1].abs().max())}")
        check(bool(torch.isfinite(X).all()) and bool(torch.isfinite(U).all()),
              f"kirk rollout ({label}): non-finite")

if __name__ == "__main__":
    main()
    sys.exit(0)
