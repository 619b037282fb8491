"""Benchmark: Bellman backups (state-action evals)/s on one CUDA card, on
the reference's north-star workloads (the port's counterpart of the
repository's root ``bench.py``, with the same eight families).

    python -m ocdp_tpu_torch.bench            # all eight families
    BENCH_FAMILIES=kirk,position python -m ocdp_tpu_torch.bench

Prints ONE JSON line, last: ``metric`` (``bellman_backups_per_s_per_chip``)
and ``value`` are the Kirk ch.3 full workload (100x100 states x 1000
controls x 199 sweeps ~= 2e9 state-action evaluations,
test/Dynamic_Solver.m:49-63); ``families`` carries every family:

* ``kirk``            — full finite-horizon solve through kernel B.1
                        (``fused_backup2d``); alternative: the gather oracle
* ``attitude_axis``   — one clamped simplified yaw axis, 1000x300x3 x 5999
                        sweeps (Solver_attitude.m:108,116,143-144), kernel
                        B.6 (``band_backup2d``); alternative: ``rowband``
* ``position``        — 3 channels x 201x201x3 x 5999 sweeps, B.6's channel
                        batch with the factorized cost (``position.solve``)
* ``pos_att_channel`` — one 30x30x20x15 x 9-combo channel, early-stop loop
                        incl. the periodic checks (Solver_pos_att.m:268-286),
                        kernel B.2 (``rowlane_backup``), and the 'rel' stop
* ``pos_att_serving`` — reference grid, the serving path: the 4-channel
                        solve (one B.2 launch a sweep) + 'rk4' closed-loop
                        rollouts, single flight and a fleet of 256
* ``attitude_6d``     — full coupled 6-D attitude at 11^3 x 10^3
                        (Solver_attitude.asv:95-103), kernel B.3
                        (``backup6d``), 50 sweeps
* ``attitude_6d_converged`` — the same grid to the full 5999-sweep horizon
                        under the converged engine
* ``pos_att_highres`` — 60x60x40x30 = 4.32M cells x 9: converged channel
                        solve, 3-channel solve, receding-horizon (ode45) and
                        'rk4' flights of 10 s, a fleet of 256

Every family's headline runs the port's kernel path; the plain versions
appear only as ``alternatives``. ``launches`` counts the kernel launches of
the headline's last timed call (a CUDA graph replay adds the launches it
captured), so a fallback shows as 0.

Timing: host clock around calls that end in ``torch.cuda.synchronize()``.
The kernels are built once (``_build.load()``) before any family, reported
as ``build_s``. ``wall_s`` is the best warm call; ``compile_s`` is the
first (cold) call minus the best warm one: what only a first call pays
(first use of the kernels in this process, their tile planners' caches
and launch configuration, the allocator's growth). The engines keep no
CUDA graph between calls, so every warm call captures its graphs again:
capture is inside ``wall_s``. Plans, tap analyses and backups are built
outside the timed calls, as the root ``bench.py`` builds them outside its
jitted calls; ``pos_att_serving``'s and ``pos_att_highres``'s
``solve_all_channels_s`` are whole ``pos_att.solve`` calls, builds
included.

``vs_baseline``: the reference publishes no timings, so the baseline is a
measured stand-in, a fully vectorized numpy implementation of the same
Kirk backup (prebuilt interpolation indices + corner gathers + min) on
this host's CPU, the min seconds/stage over 5 trials; vs_baseline is the
headline's evals/s over the stand-in's. ``device`` is the card's name and
power limit as ``nvidia-smi`` reports them.

Without a CUDA device :func:`main` raises (there is no CPU fallback). A
family that raises is recorded as ``{"error": ...}`` in the line, and
:func:`main` then exits non-zero after printing it. The family functions
take ``device`` and a config (defaults: the card and the bench's own
config), so tests can run them small on the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from . import _build
from .engine import (value_iteration_converged,
                     value_iteration_converged_batch, value_iteration_finite)
from .models import attitude, kirk, pos_att, position
from .ops.backup6d import Backup6D, backup6d_cuda
from .ops.band_backup2d import BandBackup2D, band_backup2d_cuda
from .ops.fused_backup2d import FusedBackup2D, fused_backup2d_cuda
from .ops.rowband import RowBandBackup2D
from .ops.rowlane import RowLaneBatch, rowlane_backup_cuda
from .utils.device import resolve_device

__all__ = ["FAMILIES", "main", "numpy_baseline_stage_seconds"]

FAMILIES = ("kirk", "attitude_axis", "position", "pos_att_channel",
            "pos_att_serving", "attitude_6d", "attitude_6d_converged",
            "pos_att_highres")
FLEET = 256              # flights in the serving fleets


def numpy_baseline_stage_seconds(cfg, n_trials=5):
    """Vectorized numpy Bellman backup on the Kirk grid, min seconds/stage."""
    s_r = np.linspace(cfg.x_min, cfg.x_max, cfg.dx).astype(np.float32)
    u = np.linspace(cfg.u_min, cfg.u_max, cfg.du).astype(np.float32)
    x1 = s_r[:, None, None]
    x2 = s_r[None, :, None]
    uu = u[None, None, :]
    (a11, a12), (a21, a22) = cfg.A
    b1, b2 = cfg.B
    q1n = (a11 * x1 + a12 * x2 + b1 * uu).astype(np.float32)
    q2n = (a21 * x1 + a22 * x2 + b2 * uu).astype(np.float32)
    cost = (cfg.Q[0] * x1**2 + cfg.Q[1] * x2**2 + cfg.R * uu**2).astype(np.float32)
    cost = np.broadcast_to(cost, (cfg.dx, cfg.dx, cfg.du))

    def locate(g, q):
        lo = np.clip(np.searchsorted(g, q, side="right") - 1, 0, len(g) - 2)
        frac = (q - g[lo]) / (g[lo + 1] - g[lo])
        return lo.astype(np.int64), frac.astype(np.float32)

    lo1, f1 = locate(s_r, np.broadcast_to(q1n, cost.shape))
    lo2, f2 = locate(s_r, np.broadcast_to(q2n, cost.shape))
    flat00 = lo1 * cfg.dx + lo2
    v = np.zeros((cfg.dx, cfg.dx), np.float32)
    w00 = (1 - f1) * (1 - f2)
    w01 = (1 - f1) * f2
    w10 = f1 * (1 - f2)
    w11 = f1 * f2

    def stage(v):
        fv = v.ravel()
        tot = (w00 * fv[flat00] + w01 * fv[flat00 + 1]
               + w10 * fv[flat00 + cfg.dx] + w11 * fv[flat00 + cfg.dx + 1]
               + cost)
        return tot.min(axis=-1)

    v = stage(v)  # warm
    best = np.inf
    for _ in range(n_trials):
        t0 = time.perf_counter()
        v = stage(v)
        best = min(best, time.perf_counter() - t0)
    return best


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device: torch.device):
    """``(seconds, result)`` of one call of ``fn``, ended by a synchronize."""
    t0 = time.perf_counter()
    res = fn()
    _sync(device)
    return time.perf_counter() - t0, res


def _time_cold_warm(fn, device, *, trials=2, launcher=None):
    """A cold call, then ``trials`` warm ones: ``(best warm s, compile_s,
    result, launches)``, ``compile_s`` the cold call minus the best warm
    one, ``launches`` those ``launcher`` counted in the last warm call."""
    first_s, res = _timed(fn, device)
    best = np.inf
    launches = 0
    for _ in range(trials):
        before = launcher.launches if launcher is not None else 0
        dt, res = _timed(fn, device)
        best = min(best, dt)
        launches = (launcher.launches - before) if launcher is not None else 0
    return best, max(first_s - best, 0.0), res, launches


def _impl(kernel: str, device: torch.device) -> str:
    """What a headline ran: the kernel on a card, its plain version on the
    CPU (the tests' small runs)."""
    return kernel if device.type == "cuda" else f"{kernel} plain (cpu)"


def bench_kirk(device="cuda", cfg=None):
    device = resolve_device(device)
    cfg = kirk.KirkConfig() if cfg is None else cfg   # dx=100, du=1000, N=200
    p = kirk.build(cfg, device=device)
    sweeps = cfg.N - 1
    evals = cfg.dx * cfg.dx * cfg.du * sweeps
    # the backup kirk.solve(impl='kernel') builds; the engine call timed
    # without stored policies, as the root bench.py times it
    bk = FusedBackup2D(p.plan, p.stage_cost,
                       cost_terms=kirk._separable_cost_terms(cfg,
                                                             device=device))

    def run(backup):
        return lambda: value_iteration_finite(
            p.plan, p.stage_cost, sweeps, store_policies=False, backup=backup)

    dt, compile_s, _, launches = _time_cold_warm(
        run(bk), device, launcher=fused_backup2d_cuda)
    dt_g, _, _, _ = _time_cold_warm(run(None), device)
    return {
        "evals_per_s": round(evals / dt, 1),
        "wall_s": round(dt, 6),
        "compile_s": round(compile_s, 6),
        "impl": _impl("fused_backup2d", device),
        "launches": launches,
        "alternatives": {"fused_backup2d": round(dt, 6),
                         "gather": round(dt_g, 6)},
        "workload": f"kirk dx={cfg.dx} du={cfg.du} N={cfg.N} "
                    f"({evals:.3g} evals)",
    }


def bench_attitude_axis(device="cuda", cfg=None):
    device = resolve_device(device)
    cfg = attitude.AttitudeConfig() if cfg is None else cfg  # 1000 x 300 x 3
    sweeps = cfg.n_stage - 1
    # the yaw axis on the clamped plan, the shipping edge policy
    _, plan, terms = attitude.build_simplified_axis(cfg, 0, edge="clamp",
                                                    device=device)

    def run(backup):
        return lambda: value_iteration_finite(
            plan, None, sweeps, store_policies=False, backup=backup)

    dt, compile_s, _, launches = _time_cold_warm(
        run(BandBackup2D(plan, terms)), device, launcher=band_backup2d_cuda)
    dt_rb, _, _, _ = _time_cold_warm(run(RowBandBackup2D(plan, terms)),
                                     device)
    evals = cfg.n_mesh_w * cfg.n_mesh_t * len(cfg.u_vector) * sweeps
    return {
        "evals_per_s": round(evals / dt, 1),
        "wall_s": round(dt, 6),
        "compile_s": round(compile_s, 6),
        "impl": _impl("band_backup2d", device),
        "launches": launches,
        "alternatives": {"band_backup2d": round(dt, 6),
                         "rowband": round(dt_rb, 6)},
        "workload": f"attitude simplified yaw axis ({cfg.n_mesh_w}x"
                    f"{cfg.n_mesh_t}x{len(cfg.u_vector)}) x {sweeps} sweeps",
    }


def bench_position(device="cuda", cfg=None):
    device = resolve_device(device)
    cfg = position.PositionConfig() if cfg is None else cfg  # 3 x 201x201x3
    sweeps = cfg.n_stage - 1
    problem = position.build(cfg, device=device)
    # the channel batch with the factorized cost, as position.solve builds it
    bk = BandBackup2D(problem.plan, problem.cost_terms)
    dt, compile_s, _, launches = _time_cold_warm(
        lambda: value_iteration_finite(problem.plan, problem.stage_cost,
                                       sweeps, store_policies=False,
                                       backup=bk),
        device, launcher=band_backup2d_cuda)
    n_x, n_v = problem.plan.grid_shape[1:]
    n_u = len(cfg.u_vector)
    evals = cfg.n_channels * n_x * n_v * n_u * sweeps
    return {
        "evals_per_s": round(evals / dt, 1),
        "wall_s": round(dt, 6),
        "compile_s": round(compile_s, 6),
        "impl": _impl("band_backup2d", device),
        "launches": launches,
        "workload": f"position {cfg.n_channels} channels ({n_x}x{n_v}x{n_u}) "
                    f"x {sweeps} sweeps",
    }


def _channel_solver(cfg, device):
    """The x channel's early-stop solve as ``solve_channel`` runs it (a
    batch of one through the batched converged engine), the backup built
    once: ``run(tol, tol_mode) -> SolveResult``."""
    problem = pos_att.build_channel(cfg, "x", with_cost=False, device=device)
    batch = RowLaneBatch([pos_att.build_channel_rowlane_backup(cfg, problem)])

    def run(tol, tol_mode="abs"):
        return lambda: value_iteration_converged_batch(
            batch, cfg.n_stage - 1, check_every=cfg.check_every, tol=tol,
            tol_mode=tol_mode)[0]

    return run


def _cells(cfg) -> int:
    return cfg.n_mesh_x * cfg.n_mesh_v * cfg.n_mesh_t * cfg.n_mesh_w


def bench_pos_att_channel(device="cuda", cfg=None):
    device = resolve_device(device)
    cfg = pos_att.PosAttConfig() if cfg is None else cfg  # 30x30x20x15 x 9
    max_sweeps = cfg.n_stage - 1
    run = _channel_solver(cfg, device)
    dt, compile_s, res, launches = _time_cold_warm(
        run(cfg.tol), device, launcher=rowlane_backup_cuda)
    sweeps = int(res.num_sweeps)
    cells = _cells(cfg)
    evals = cells * 9 * sweeps
    # the scale-free 'rel' rule at 1e-3 ("sum V stable to 0.1% per check
    # window"), which fires inside the cap where the reference's absolute
    # tol=1e-2 never does
    dt_rel, _, res_rel, _ = _time_cold_warm(run(1e-3, "rel"), device)
    return {
        "evals_per_s": round(evals / dt, 1),
        "wall_s": round(dt, 6),
        "compile_s": round(compile_s, 6),
        "sweeps": sweeps,
        "converged": bool(res.converged),
        "rel_stop": {
            "tol_mode": "rel", "tol": 1e-3,
            "wall_s": round(dt_rel, 6),
            "sweeps": int(res_rel.num_sweeps),
            "converged": bool(res_rel.converged),
        },
        "impl": _impl("rowlane_backup", device),
        "launches": launches,
        "workload": f"pos-att x channel {cells}x9, early-stop loop "
                    f"(cap {max_sweeps})",
    }


def _fleet_x0s(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    x0s = np.tile(np.asarray(pos_att.default_x0()), (n, 1))
    x0s += rng.normal(0, 0.01, x0s.shape).astype(np.float32)
    return x0s


def bench_pos_att_serving(device="cuda", cfg=None):
    """Serving on the reference grid (Solver_pos_att.m:100-119): the
    all-channel solve (x, y, z, x-failure, one B.2 launch a sweep) and the
    'rk4' closed-loop serving rollout, one flight and a fleet of 256 (a
    batch of initial conditions stepped together, :452-506)."""
    device = resolve_device(device)
    cfg = pos_att.PosAttConfig() if cfg is None else cfg

    def solve():
        return pos_att.solve(cfg, device=device)

    solve_all_s, _ = _timed(solve, device)
    before = rowlane_backup_cuda.launches
    solve_all_warm_s, sol = _timed(solve, device)
    launches = rowlane_backup_cuda.launches - before

    x0 = np.array(pos_att.default_x0(pitch_deg=2.0))
    x0[0] = -0.08
    rk4_cold_s, (T, X, _, _) = _timed(
        lambda: pos_att.get_optimal_path(sol, x0, integrator="rk4"), device)
    x0[0] = 0.06
    rk4_warm_s, _ = _timed(
        lambda: pos_att.get_optimal_path(sol, x0, integrator="rk4"), device)
    flight_s = float(T[-1])

    x0s = _fleet_x0s(FLEET)
    _timed(lambda: pos_att.rollout_batch(sol, x0s), device)
    batch_warm_s, _ = _timed(lambda: pos_att.rollout_batch(sol, x0s), device)
    return {
        "solve_all_channels_s": round(solve_all_s, 6),
        "solve_all_channels_warm_s": round(solve_all_warm_s, 6),
        "rollout_rk4_cold_s": round(rk4_cold_s, 6),
        "rollout_rk4_warm_s": round(rk4_warm_s, 6),
        "realtime_factor": round(flight_s / rk4_warm_s, 3),
        "batch": FLEET,
        "batch_warm_s": round(batch_warm_s, 6),
        "batch_flight_s_per_s": round(FLEET * flight_s / batch_warm_s, 3),
        "impl": _impl("rowlane_backup", device) + " + rk4 rollouts",
        "launches": launches,
        "workload": "pos-att reference grid: 4-channel solve + "
                    f"{flight_s:.0f} s closed-loop serving rollouts",
    }


def bench_pos_att_highres(device="cuda", cfg=None):
    """The high-res coupled grid (60x60x40x30 = 4.32M cells x 9 combos a
    channel): converged x-channel solve, the 3-channel solve, and
    closed-loop flights of ``cfg.T_final`` (10 s) re-querying the policies
    from the 13-state every step (Solver_pos_att.m:484-506): two
    receding-horizon ('ode45') flights, two 'rk4' flights and a fleet of
    256."""
    device = resolve_device(device)
    cfg = pos_att.PosAttConfig.high_res() if cfg is None else cfg
    max_sweeps = cfg.n_stage - 1
    t_final = cfg.T_final
    run = _channel_solver(cfg, device)
    dt, compile_s, res, launches = _time_cold_warm(
        run(cfg.tol), device, trials=1, launcher=rowlane_backup_cuda)
    sweeps = int(res.num_sweeps)
    cells = _cells(cfg)
    evals = cells * 9 * sweeps

    solve_all_s, sol = _timed(
        lambda: pos_att.solve(cfg, include_failure=False, device=device),
        device)
    x0 = np.array(pos_att.default_x0(pitch_deg=2.0))
    x0[0] = -0.08
    rollout_cold_s, (_, (T, X, _, _)) = _timed(
        lambda: pos_att.receding_horizon(x0, sol=sol, t_final=t_final),
        device)
    x_err = float(X[-1, 0].abs())
    x0[0] = 0.06
    rollout_warm_s, _ = _timed(
        lambda: pos_att.receding_horizon(x0, sol=sol, t_final=t_final),
        device)
    rk4_cold_s, _ = _timed(lambda: pos_att.get_optimal_path(
        sol, x0, t_final=t_final, integrator="rk4"), device)
    x0[0] = -0.05
    rk4_warm_s, _ = _timed(lambda: pos_att.get_optimal_path(
        sol, x0, t_final=t_final, integrator="rk4"), device)

    # the fleet on the high-res tables (207 MB of policy)
    x0s = _fleet_x0s(FLEET)
    _timed(lambda: pos_att.rollout_batch(sol, x0s, t_final=t_final), device)
    batch_warm_s, (Tb, _, _, _) = _timed(
        lambda: pos_att.rollout_batch(sol, x0s, t_final=t_final), device)
    return {
        "evals_per_s": round(evals / dt, 1),
        "wall_s": round(dt, 6),
        "compile_s": round(compile_s, 6),
        "sweeps": sweeps,
        "converged": bool(res.converged),
        "solve_all_channels_s": round(solve_all_s, 6),
        "receding_horizon_cold_s": round(rollout_cold_s, 6),
        "receding_horizon_warm_s": round(rollout_warm_s, 6),
        "receding_horizon_rk4_cold_s": round(rk4_cold_s, 6),
        "receding_horizon_rk4_warm_s": round(rk4_warm_s, 6),
        "batch": FLEET,
        "batch_warm_s": round(batch_warm_s, 6),
        "batch_flight_s_per_s": round(FLEET * float(Tb[-1]) / batch_warm_s,
                                      3),
        "final_x_error_m": round(x_err, 6),
        "impl": _impl("rowlane_backup", device),
        "launches": launches,
        "workload": f"pos-att high-res x channel {cells}x9 converged loop "
                    f"(cap {max_sweeps}) + {t_final:g} s receding-horizon "
                    "rollout",
    }


def _attitude_6d(device, cfg):
    """``(plan, cost terms, Backup6D)`` of the 6-D solve, as
    ``attitude.solve_full`` builds them below the flat-plan size."""
    _, plan, cost = attitude.build_full(cfg, device=device)
    return plan, cost, Backup6D(plan, cost)


def bench_attitude_6d(device="cuda", cfg=None):
    device = resolve_device(device)
    cfg = attitude.AttitudeConfig(n_mesh_w=11, n_mesh_q=10) if cfg is None \
        else cfg
    sweeps = 50                       # envelope point, not a full solve
    cells = cfg.n_mesh_w**3 * cfg.n_mesh_q**3
    evals = cells * 27 * sweeps
    plan, cost, bk = _attitude_6d(device, cfg)
    dt, compile_s, _, launches = _time_cold_warm(
        lambda: value_iteration_finite(plan, cost, sweeps,
                                       store_policies=False, backup=bk),
        device, trials=1, launcher=backup6d_cuda)
    return {
        "evals_per_s": round(evals / dt, 1),
        "wall_s": round(dt, 6),
        "compile_s": round(compile_s, 6),
        "sweeps": sweeps,
        "impl": _impl("backup6d", device),
        "launches": launches,
        "workload": f"attitude full {cfg.n_mesh_w}^3x{cfg.n_mesh_q}^3 "
                    f"({cells / 1e6:.3g}M cells) x 27 actions",
    }


def bench_attitude_6d_converged(device="cuda", cfg=None):
    """The full coupled 6-D attitude value iteration at 11^3 x 10^3
    (Solver_attitude.asv:95-103) to the reference's full 5999-sweep horizon
    (Solver_attitude.m:261-300) under the periodic-checksum converged
    engine (Solver_pos_att.m:268-286)."""
    device = resolve_device(device)
    cfg = attitude.AttitudeConfig(n_mesh_w=11, n_mesh_q=10) if cfg is None \
        else cfg
    max_sweeps = cfg.n_stage - 1        # 5999: the reference's full horizon
    cells = cfg.n_mesh_w**3 * cfg.n_mesh_q**3
    plan, cost, bk = _attitude_6d(device, cfg)
    dt, compile_s, res, launches = _time_cold_warm(
        lambda: value_iteration_converged(plan, cost, max_sweeps,
                                          check_every=50, tol=1e-2,
                                          backup=bk),
        device, trials=1, launcher=backup6d_cuda)
    sweeps = int(res.num_sweeps)
    evals = cells * 27 * sweeps
    return {
        "evals_per_s": round(evals / dt, 1),
        "wall_s": round(dt, 6),
        "compile_s": round(compile_s, 6),
        "sweeps": sweeps,
        "converged": bool(res.converged),
        "impl": _impl("backup6d", device),
        "launches": launches,
        "workload": f"attitude full {cfg.n_mesh_w}^3x{cfg.n_mesh_q}^3 x 27, "
                    f"full-horizon converged engine (cap {max_sweeps})",
    }


RUNNERS = {
    "kirk": bench_kirk,
    "attitude_axis": bench_attitude_axis,
    "position": bench_position,
    "pos_att_channel": bench_pos_att_channel,
    "pos_att_serving": bench_pos_att_serving,
    "attitude_6d": bench_attitude_6d,
    "attitude_6d_converged": bench_attitude_6d_converged,
    "pos_att_highres": bench_pos_att_highres,
}


def card_description() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return (f"{torch.cuda.get_device_name(0)}, power limit not read "
                "(nvidia-smi failed)")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ocdp_tpu_torch.bench measures a CUDA card and found none "
            "(torch.cuda.is_available() is false); it has no CPU fallback")
    which = [n.strip() for n in
             os.environ.get("BENCH_FAMILIES", ",".join(FAMILIES)).split(",")]
    unknown = [n for n in which if n not in RUNNERS]
    if unknown:
        raise SystemExit(f"unknown BENCH_FAMILIES entries: {unknown}; "
                         f"choose from {sorted(RUNNERS)}")
    device = torch.device("cuda")
    t0 = time.perf_counter()
    _build.load()                     # nvcc once, before any family
    build_s = time.perf_counter() - t0

    families = {}
    for name in which:
        try:
            families[name] = RUNNERS[name](device)
        except Exception as e:  # record, don't kill the headline
            traceback.print_exc()
            families[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
        torch.cuda.empty_cache()

    kcfg = kirk.KirkConfig()
    if "kirk" in families:
        base_stage = numpy_baseline_stage_seconds(kcfg)
        base_evals_per_s = kcfg.dx**2 * kcfg.du / base_stage
    else:  # baseline is a Kirk stand-in; skip its cost when kirk is excluded
        base_evals_per_s = 0.0

    head = families.get("kirk", {})
    value = head.get("evals_per_s", 0.0)
    print(json.dumps({
        "metric": "bellman_backups_per_s_per_chip",
        "value": value,
        "unit": "state-action evals/s",
        "vs_baseline": (round(value / base_evals_per_s, 2)
                        if value and base_evals_per_s else 0.0),
        "workload": head.get("workload", ""),
        "wall_s": head.get("wall_s", 0.0),
        "baseline_evals_per_s": round(base_evals_per_s, 1),
        "build_s": round(build_s, 3),
        "families": families,
        "device": card_description(),
    }), flush=True)
    failed = [n for n, f in families.items() if "error" in f]
    if failed:
        print(f"bench: families failed: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
