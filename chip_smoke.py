#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's Kirk ch.3 main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA device and
the CUDA toolkit (nvcc). Phases, each of which raises on failure:

1. check the device and print its name and power limit (nvidia-smi);
2. build the CUDA kernels from ``ocdp_tpu_torch/csrc`` (timed);
3. one sweep of the fused kernel vs its plain PyTorch version on the same
   inputs, at the golden and the full Kirk size and on a crafted exact-tie
   case: values and argmin bitwise equal;
4. the full solve, ``kirk.solve(KirkConfig(), device='cuda')`` (100x100
   states, 1000 controls, 199 sweeps): the kernel's launch count goes up by
   exactly 199, and values and every stored policy equal ``impl='gather'``
   bitwise;
5. the golden solve on the card against MATLAB truth
   (tests/golden/obj1_reference.npz, tests/test_golden.py's tolerances) and
   the stored golden solve and rollout (tests/golden/kirk_golden.npz);
6. timing with CUDA events, warm, median of 10: one full-size sweep of the
   kernel and of the plain version (back-to-back calls), the 199-sweep
   loop, and the full solve.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the package beside this script, it exits non-zero and prints no
result.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ocdp_tpu_torch import _build
from ocdp_tpu_torch.engine import value_iteration_finite
from ocdp_tpu_torch.models import kirk
from ocdp_tpu_torch.ops import fused_backup2d as fb
from ocdp_tpu_torch.ops.interp import build_plan
from ocdp_tpu_torch.profiling import cuda_time_ms

ROOT = Path(__file__).resolve().parent
GOLDEN_DIR = ROOT / "tests" / "golden"
SEED = 0


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


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

    phase("3. kernel vs plain, one sweep")
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    full_cfg = kirk.KirkConfig()
    for label, cfg in (("golden 35x35x100", kirk.KirkConfig.golden()),
                       ("full 100x100x1000", full_cfg)):
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

    phase("4. full solve through the kernel (main path)")
    fb.fused_backup2d_cuda.launches = 0
    t0 = time.perf_counter()
    sol = kirk.solve(full_cfg, device=device)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = fb.fused_backup2d_cuda.launches
    print(f"kirk.solve(KirkConfig()): {solve_s:.3f} s cold, "
          f"{launches} kernel launches")
    check(launches == full_cfg.N - 1,
          f"kernel launched {launches} times, want {full_cfg.N - 1}")
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

    phase("5. golden solve vs MATLAB truth and the stored golden")
    gcfg = kirk.KirkConfig.golden()
    gsol = kirk.solve(gcfg, device=device)
    with np.load(GOLDEN_DIR / "obj1_reference.npz") as z:
        mat = {k: z[k] for k in z.files}
    with np.load(GOLDEN_DIR / "kirk_golden.npz") as z:
        gold = {k: z[k] for k in z.files}
    vals = gsol.result.values.cpu().numpy()
    np.testing.assert_allclose(vals, mat["J_star"][:, :, 0],
                               rtol=1e-4, atol=1e-2)
    gp = kirk.build(gcfg, device=device)
    probes = value_iteration_finite(
        gp.plan, gp.stage_cost, gcfg.N - 1,
        backup=separable_backup(gp, gcfg, device),
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
    p = kirk.build(full_cfg, device=device)
    bk = separable_backup(p, full_cfg, device)
    v = res.values.contiguous()
    evals = full_cfg.dx * full_cfg.dx * full_cfg.du
    kernel_ms = cuda_time_ms(
        lambda: fb.fused_backup2d_cuda(*kernel_args(bk, v)), inner=20)
    plain_ms = cuda_time_ms(
        lambda: fb.fused_backup2d_plain(*kernel_args(bk, v)), inner=5)
    print(f"full sweep, back to back: kernel {kernel_ms:.4f} ms "
          f"({evals / kernel_ms * 1e3:.4e} evals/s), plain "
          f"{plain_ms:.4f} ms ({evals / plain_ms * 1e3:.4e} evals/s)")
    sweeps_ms = cuda_time_ms(lambda: value_iteration_finite(
        p.plan, p.stage_cost, full_cfg.N - 1, store_policies=True,
        backup=bk))
    solve_ms = cuda_time_ms(lambda: kirk.solve(full_cfg, device=device))
    print(f"{full_cfg.N - 1}-sweep loop (plan built): {sweeps_ms:.3f} ms; "
          f"kirk.solve(KirkConfig()) incl. build: {solve_ms:.3f} ms")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          " MiB")

    print(json.dumps({"kernels": [{
        "name": "fused_backup2d",
        "route": "cuda",
        "source": "ocdp_tpu_torch/csrc/fused_backup2d.cu",
        "replaces": "ocdp_tpu/ops/pallas_shear.py:237",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
