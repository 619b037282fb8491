"""Command-line interface: ``python -m ocdp_tpu_torch <command> ...``
(counterpart of ``python -m ocdp_tpu``).

The reference has no CLI ("editing the file IS the config system"); this
exposes the four problem families with their reference defaults as named
configs. Everything runs on ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch versions).

Commands:
  solve    {kirk|position|attitude|attitude-full|pos-att} [--out DIR] [...]
           attitude-full also takes --segment-size/--checkpoint/--resume/
           --tol (the segmented envelope form: a checkpoint per segment,
           the converged stop rule at segment ends); --resume continues
           from --checkpoint (values, sweep index and the stop rule's last
           checksum) and needs it
  rollout  {kirk|position|attitude|attitude-full|pos-att} [--plot DIR] [...]
           (--plot needs matplotlib)
  bench    the eight-family benchmark (``python -m ocdp_tpu_torch.bench``)

Each command prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

IMPL_CHOICES = ("auto", "kernel", "plain", "gather", "rowlane", "rowband")


def _add_common(p):
    p.add_argument("problem", choices=["kirk", "position", "attitude",
                                       "attitude-full", "pos-att"])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; 'cpu' runs "
                        "the plain PyTorch versions)")
    p.add_argument("--sweeps", type=int, default=None,
                   help="override number of sweeps")
    p.add_argument("--impl", default="auto", choices=IMPL_CHOICES,
                   help="backup implementation; each problem takes the ones "
                        "in its model's IMPLS and raises for the others")
    p.add_argument("--edge", default=None,
                   choices=["extrapolate", "clamp"],
                   help="out-of-grid value policy for the attitude solvers "
                        "(default: clamp for the simplified axes, "
                        "extrapolate for the 6-D solve; see "
                        "ops.interp.build_plan)")
    p.add_argument("--tol-mode", default="abs", choices=["abs", "rel"],
                   dest="tol_mode",
                   help="convergence stop rule (pos-att, attitude-full "
                        "--tol): 'abs' is the reference's |dSumV| < tol "
                        "(never fires at its own pos-att defaults), 'rel' "
                        "the scale-free variant (engine.convergence_stop)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the reference-parity per-stage progress "
                        "prints ('step %%d - %%f seconds' / per-check "
                        "errorF/errorU lines); each synchronizes the card")


def _total(t) -> float:
    """Sum of a result table on the host, in float32 (as the JAX CLI sums
    its arrays)."""
    return float(t.detach().cpu().numpy().sum())


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _solve_attitude_full_kwargs(args, device) -> dict:
    """The segmented / checkpoint / resume keywords of ``solve
    attitude-full``."""
    kw = {}
    if args.checkpoint:
        # the envelope form: segmented solve + per-segment checkpoint,
        # resumable with --resume; --tol adds the converged stop rule at
        # segment ends
        kw["segment_size"] = args.segment_size or 50
        kw["checkpoint_path"] = args.checkpoint
        if args.resume:
            from .io import load_values

            ck = load_values(args.checkpoint, device=device)
            kw["init_values"] = ck.values
            kw["start_sweep"] = ck.sweep_index
            kw["prev_f"] = ck.prev_f
    elif args.segment_size:
        kw["segment_size"] = args.segment_size
    if "segment_size" in kw:
        kw["tol"] = args.tol
        kw["tol_mode"] = args.tol_mode
    return kw


def cmd_solve(args):
    t0 = time.time()
    if args.problem != "attitude-full":
        # loud rejection, not silent ignoring
        for flag in ("segment_size", "checkpoint", "resume", "tol"):
            if getattr(args, flag, None):
                raise SystemExit(
                    f"--{flag.replace('_', '-')} applies to "
                    f"'solve attitude-full' only (got {args.problem!r})")
    elif args.resume and not args.checkpoint:
        raise SystemExit("--resume needs --checkpoint PATH: the checkpoint "
                         "to resume from")
    device = args.device
    verbose = not args.quiet
    if args.problem == "kirk":
        import dataclasses

        from .models import kirk

        # Kirk's horizon is the config's stage count N (N-1 backward
        # sweeps, test/Dynamic_Solver.m:86): --sweeps S solves with N = S+1.
        cfg = kirk.KirkConfig() if args.sweeps is None \
            else dataclasses.replace(kirk.KirkConfig(), N=args.sweeps + 1)
        sol = kirk.solve(cfg, device=device, impl=args.impl, verbose=verbose)
        out = {"values_sum": _total(sol.result.values)}
    elif args.problem == "position":
        from .models import position

        sol = position.solve(position.PositionConfig(),
                             num_sweeps=args.sweeps, impl=args.impl,
                             verbose=verbose, device=device)
        out = {"values_sum": _total(sol.result.values)}
    elif args.problem == "attitude":
        from .models import attitude

        kw = {"edge": args.edge} if args.edge else {}
        sol = attitude.solve_simplified(attitude.AttitudeConfig(),
                                        num_sweeps=args.sweeps,
                                        impl=args.impl, verbose=verbose,
                                        device=device, **kw)
        out = {"values_sum": float(sum(_total(v) for v in sol.values))}
    elif args.problem == "attitude-full":
        from .models import attitude

        cfg = attitude.AttitudeConfig(n_mesh_w=args.n_mesh_w,
                                      n_mesh_q=args.n_mesh_q)
        kw = {"edge": args.edge} if args.edge else {}
        kw.update(_solve_attitude_full_kwargs(args, device))
        sol = attitude.solve_full(cfg, num_sweeps=args.sweeps,
                                  impl=args.impl, verbose=verbose,
                                  device=device, **kw)
        start = kw.get("start_sweep", 0)
        out = {"values_sum": _total(sol.result.values),
               "sweeps": int(sol.result.num_sweeps),
               "sweep_index": start + int(sol.result.num_sweeps),
               "converged": bool(sol.result.converged)}
    else:
        from .models import pos_att

        # --sweeps caps the early-stop loop (reference cap: n_stage - 1);
        # --tol-mode selects the stop rule
        sol = pos_att.solve(pos_att.PosAttConfig(), impl=args.impl,
                            save_dir=args.out, max_sweeps=args.sweeps,
                            tol_mode=args.tol_mode, verbose=verbose,
                            device=device)
        out = {ch: _total(c.values) for ch, c in sol.controllers.items()}
    out["wall_s"] = round(time.time() - t0, 2)
    out["problem"] = args.problem
    print(json.dumps(out))


def cmd_rollout(args):
    t0 = time.time()
    viz = None
    if args.plot:
        # matplotlib is needed only here: without it this raises, before
        # the solve
        from . import viz
    device = args.device
    verbose = not args.quiet
    if args.problem == "kirk":
        from .models import kirk

        sol = kirk.solve(kirk.KirkConfig.golden(), device=device,
                         impl=args.impl)
        X, U = kirk.optimal_path(sol, (2.0, 1.0))
        out = {"x_final": _host(X)[-1].tolist()}
        if viz is not None:
            viz.plot_rollout(np.arange(X.shape[0]), X, U,
                             path=f"{args.plot}/kirk_rollout.png")
    elif args.problem == "position":
        from .models import position

        sol = position.solve(position.PositionConfig(),
                             num_sweeps=args.sweeps, impl=args.impl,
                             verbose=verbose, device=device)
        T, X, U = position.get_optimal_path(sol)
        out = {"x_final": _host(X)[-1, :3].tolist()}
        if viz is not None:
            viz.plot_rollout(T, X, U, path=f"{args.plot}/position_rollout.png")
    elif args.problem == "attitude":
        # train-on-simplified / validate-on-real (Solver_attitude
        # get_optimal_path_simplified_testode45, :835-925)
        from .models import attitude

        kw = {"edge": args.edge} if args.edge else {}
        sol = attitude.solve_simplified(attitude.AttitudeConfig(),
                                        num_sweeps=args.sweeps,
                                        impl=args.impl, verbose=verbose,
                                        device=device, **kw)
        X, U = attitude.rollout_simplified_real_dynamics(
            sol, integrator=args.integrator)
        x_last = _host(X)[-1]
        theta = 2.0 * np.arcsin(np.clip(x_last[3:6], -1, 1))
        out = {"angles_final_deg": (theta * 180 / np.pi).tolist(),
               "w_final": x_last[:3].tolist()}
    elif args.problem == "attitude-full":
        from .models import attitude

        cfg = attitude.AttitudeConfig(n_mesh_w=args.n_mesh_w,
                                      n_mesh_q=args.n_mesh_q)
        kw = {"edge": args.edge} if args.edge else {}
        sol = attitude.solve_full(cfg, num_sweeps=args.sweeps,
                                  impl=args.impl, verbose=verbose,
                                  device=device, **kw)
        X, U, ang = attitude.rollout_full(sol)
        out = {"angles_final_deg": (np.abs(_host(ang)[-100:]).mean(axis=0)
                                    * 180 / np.pi).tolist()}
    else:
        from .models import pos_att

        sol = pos_att.solve(pos_att.PosAttConfig(), include_failure=False,
                            impl=args.impl, max_sweeps=args.sweeps,
                            tol_mode=args.tol_mode, verbose=verbose,
                            device=device)
        T, X, F_th, FM = pos_att.get_optimal_path(
            sol, integrator=args.integrator)
        out = {"x_final": _host(X)[-1, :3].tolist()}
        if viz is not None:
            viz.plot_thruster_dashboard(T, F_th,
                                        path=f"{args.plot}/thrusters.png")
            viz.plot_forces_moments(T, FM, path=f"{args.plot}/forces.png")
    out["wall_s"] = round(time.time() - t0, 2)
    out["problem"] = args.problem
    print(json.dumps(out))


def cmd_bench(args):
    from .bench import main as bench_main

    bench_main()


def main(argv=None):
    p = argparse.ArgumentParser(prog="ocdp_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="run a value-iteration solve")
    _add_common(ps)
    ps.add_argument("--out", default=None, help="controller save dir (pos-att)")
    ps.add_argument("--n-mesh-w", type=int, default=15, dest="n_mesh_w")
    ps.add_argument("--n-mesh-q", type=int, default=9, dest="n_mesh_q")
    ps.add_argument("--segment-size", type=int, default=None,
                    dest="segment_size",
                    help="attitude-full: run segmented (host-visible "
                         "boundaries; enables --checkpoint/--tol)")
    ps.add_argument("--checkpoint", default=None,
                    help="attitude-full: npz path written after every "
                         "segment (implies --segment-size 50 if unset)")
    ps.add_argument("--resume", action="store_true",
                    help="attitude-full: resume from --checkpoint (needs it)")
    ps.add_argument("--tol", type=float, default=None,
                    help="attitude-full segmented: converged stop rule "
                         "tolerance at segment ends (with --tol-mode)")
    ps.set_defaults(fn=cmd_solve)

    pr = sub.add_parser("rollout", help="solve + closed-loop rollout")
    _add_common(pr)
    pr.add_argument("--integrator", default="ode45",
                    choices=["ode45", "rkf45", "rk4"],
                    help="integrator for the nonlinear-plant rollouts "
                         "(attitude / pos-att)")
    pr.add_argument("--plot", default=None,
                    help="directory for plots (needs matplotlib)")
    pr.add_argument("--n-mesh-w", type=int, default=11, dest="n_mesh_w")
    pr.add_argument("--n-mesh-q", type=int, default=7, dest="n_mesh_q")
    pr.set_defaults(fn=cmd_rollout)

    pb = sub.add_parser("bench", help="the eight-family benchmark "
                                      "(BENCH_FAMILIES selects)")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
