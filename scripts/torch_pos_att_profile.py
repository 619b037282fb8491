#!/usr/bin/env python3
"""Where the time of the port's pos-att solve and rollout goes, on one CUDA
device.

    python3 scripts/torch_pos_att_profile.py [--out DIR]

On ``PosAttConfig()`` (30x30x20x15 per channel) it traces, with
``torch.profiler``:

* 200 sweeps of the x channel's converged engine loop through the row/lane
  kernel (the ``RowLaneBackup`` wrapper's permute copies included);
* a 0.1 s rk4 flight on the solved controllers.

For each it prints the wall time, the device busy share of it and the
device time by kernel name, and writes the Chrome traces to ``<out>/``.
Needs a CUDA device; prints the card's name and power limit first.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ocdp_tpu_torch.engine import value_iteration_converged  # noqa: E402
from ocdp_tpu_torch.models import pos_att  # noqa: E402


def traced(label: str, fn, out: Path) -> None:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side entries only: a CPU op's own row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"{label}: wall {wall_us:.1f} us, device busy {busy_us:.1f} us "
          f"({busy_us / wall_us:.3f} of wall)")
    for e in rows[:12]:
        print(f"  {e.self_device_time_total:10.1f} us  {e.count:6d} x  "
              f"{e.key[:90]}")
    if not rows:
        print("  the profiler recorded no device time")
    prof.export_chrome_trace(str(out / f"torch_pos_att_{label}.json"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile",
                    help="directory for the Chrome traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    device = torch.device("cuda")
    cfg = pos_att.PosAttConfig()
    p = pos_att.build_channel(cfg, "x", with_cost=False, device=device)
    bk = pos_att.build_channel_rowlane_backup(cfg, p)
    traced("solve_200_sweeps", lambda: value_iteration_converged(
        p.plan, None, 200, check_every=cfg.check_every, tol=cfg.tol,
        backup=bk), out)
    sol = pos_att.solve(cfg, device=device, include_failure=False)
    traced("rk4_flight_0.1s", lambda: pos_att.get_optimal_path(
        sol, integrator="rk4", t_final=0.1), out)


if __name__ == "__main__":
    main()
