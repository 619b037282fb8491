#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA device and
the CUDA toolkit (nvcc). Phases, each of which raises on failure:

1. check the device and print its name and power limit (nvidia-smi);
2. build the CUDA kernels from ``ocdp_tpu_torch/csrc`` (timed);

Kirk ch.3 (kernel ``fused_backup2d``):

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

Coupled position+attitude (kernel ``rowlane_backup``):

7. one sweep of the row/lane kernel vs its plain version for the four
   channels (x, y, z, x_failure) at ``PosAttConfig()`` and ``high_res()``,
   and on an exact-tie case (every action listed twice): bitwise equal;
8. the main path, ``pos_att.solve(PosAttConfig(), device='cuda')``: the
   kernel's launch count goes up by exactly the channels' summed sweeps
   (4 x 1999), values and argmin equal ``impl='rowlane'`` bitwise, and the
   x channel at 200 sweeps meets tests/golden/pos_att_channel_golden.npz;
9. serving: the 10 s rk4 flight, a fleet of 256 seeded flights (lanes equal
   their single flights bitwise), a 1 s ode45 flight; forces in {0, +-0.13}
   and |x| shrinking;
10. the high-resolution solve (``PosAttConfig.high_res()``, 3 channels)
    through the kernel, timed;
11. timing with CUDA events, warm, median of 10: one sweep of the kernel and
    of the plain version at both sizes, the full reference solve, a 1 s rk4
    flight and the fleet's flight-seconds per second.

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
from ocdp_tpu_torch.models import kirk, pos_att
from ocdp_tpu_torch.ops import fused_backup2d as fb
from ocdp_tpu_torch.ops import rowlane as rl
from ocdp_tpu_torch.ops.interp import InterpPlan, build_plan
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

    kernels = [kirk_phases(device), pos_att_phases(device)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def reset_launch_counts() -> None:
    fb.fused_backup2d_cuda.launches = 0
    rl.rowlane_backup_cuda.launches = 0


def kirk_phases(device) -> dict:
    """Phases 3-6; returns the fused kernel's entry of the kernels line."""
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
    reset_launch_counts()
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

    return {
        "name": "fused_backup2d",
        "route": "cuda",
        "source": "ocdp_tpu_torch/csrc/fused_backup2d.cu",
        "replaces": "ocdp_tpu/ops/pallas_shear.py:237",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }


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


def pos_att_phases(device) -> dict:
    """Phases 7-11; returns the row/lane kernel's entry of the kernels
    line."""
    rng = np.random.default_rng(SEED + 1)
    ref_cfg = pos_att.PosAttConfig()
    hr_cfg = pos_att.PosAttConfig.high_res()

    phase("7. row/lane kernel vs plain, one sweep")
    max_err = 0.0
    timed = {}
    for size, cfg in (("reference", ref_cfg), ("high_res", hr_cfg)):
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
            if name == "x":
                timed[size] = (bk, v)
    tie_bk = tied_rowlane_backup(ref_cfg, device)
    tie_v = torch.from_numpy(rng.uniform(0.0, 80.0, state_shape(ref_cfg))
                             .astype(np.float32)).to(device)
    max_err = max(max_err, rowlane_vs_plain(tie_bk, tie_v, "exact ties"))
    check(int(tie_bk(tie_v).argmin.max()) < 9,
          "exact ties: a duplicate action won")

    phase("8. main path: pos_att.solve(PosAttConfig(), device='cuda')")
    reset_launch_counts()
    t0 = time.perf_counter()
    sol = pos_att.solve(ref_cfg, device=device)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = rl.rowlane_backup_cuda.launches
    sweeps = {name: r.num_sweeps for name, r in sol.results.items()}
    print(f"pos_att.solve(PosAttConfig()): {solve_s:.3f} s cold; sweeps per "
          f"channel {sweeps}; {launches} rowlane launches, "
          f"{fb.fused_backup2d_cuda.launches} fused_backup2d launches")
    check(launches == sum(sweeps.values()),
          f"rowlane kernel launched {launches} times, want "
          f"{sum(sweeps.values())}")
    check(all(n == ref_cfg.n_stage - 1 for n in sweeps.values()),
          "a reference channel stopped before the sweep cap")
    ref = pos_att.solve(ref_cfg, device=device, impl="rowlane")
    for name, ctrl in sol.controllers.items():
        rc = ref.controllers[name]
        same_v = torch.equal(ctrl.values, rc.values)
        same_a = torch.equal(ctrl.argmin, rc.argmin)
        print(f"{name}: kernel solve vs plain solve: values bitwise "
              f"{same_v}, argmin identical {same_a}, sweeps "
              f"{ref.results[name].num_sweeps}")
        check(bool(torch.isfinite(ctrl.values).all())
              and tuple(ctrl.values.shape) == state_shape(ref_cfg),
              f"{name}: wrong shape or non-finite values")
        check(same_v and same_a, f"{name}: kernel solve != plain solve")
        check(ref.results[name].num_sweeps == sweeps[name],
              f"{name}: plain solve ran another number of sweeps")
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
    print(f"ode45 flight, 1.0 s simulated: {ode_s:.3f} s; max |X_ode45 - "
          f"X_rk4| over it {float((Xo - X[:len(Xo)]).abs().max())}")
    check_flights("ode45 flight", Xo, Fo)

    phase("10. high-resolution solve through the kernel")
    before = rl.rowlane_backup_cuda.launches
    t0 = time.perf_counter()
    hsol = pos_att.solve(hr_cfg, include_failure=False, device=device)
    torch.cuda.synchronize()
    hr_s = time.perf_counter() - t0
    hsweeps = {name: r.num_sweeps for name, r in hsol.results.items()}
    print(f"pos_att.solve(PosAttConfig.high_res(), include_failure=False): "
          f"{hr_s:.3f} s; sweeps per channel {hsweeps}")
    check(rl.rowlane_backup_cuda.launches - before == sum(hsweeps.values()),
          "high-res solve: launches != sweeps")
    check(all(bool(torch.isfinite(c.values).all())
              for c in hsol.controllers.values()), "high-res: non-finite")

    phase("11. timing (CUDA events, warm, median of 10)")
    ms = {}
    for size, (bk, v) in timed.items():
        v2 = v.permute(bk.perm).reshape(bk.NW, bk.NE).contiguous()
        evals = bk.NW * bk.NE * bk.args.n_actions
        k_ms = cuda_time_ms(lambda: rl.rowlane_backup_cuda(v2, bk.args),
                            inner=20)
        p_ms = cuda_time_ms(lambda: rl.rowlane_backup_plain(v2, bk.args),
                            inner=5)
        ms[size] = (k_ms, p_ms)
        print(f"{size} x-channel sweep, back to back: kernel {k_ms:.4f} ms "
              f"({evals / k_ms * 1e3:.4e} evals/s), plain {p_ms:.4f} ms "
              f"({evals / p_ms * 1e3:.4e} evals/s)")
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
    return {
        "name": "rowlane_backup",
        "route": "cuda",
        "source": "ocdp_tpu_torch/csrc/rowlane_backup.cu",
        "replaces": "ocdp_tpu/ops/pallas_backup6.py:973",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms["reference"][0],
        "plain_ms": ms["reference"][1],
    }


def state_shape(cfg) -> tuple:
    return (cfg.n_mesh_x, cfg.n_mesh_v, cfg.n_mesh_t, cfg.n_mesh_w)


if __name__ == "__main__":
    main()
    sys.exit(0)
