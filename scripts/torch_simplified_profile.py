#!/usr/bin/env python3
"""Where the time of the port's simplified attitude and position solves
goes, on one CUDA device.

    python3 scripts/torch_simplified_profile.py [--sweeps N] [--out DIR]

Builds one simplified attitude axis at ``AttitudeConfig()`` (1000 x 300, 3
torques) and position's three channels at ``PositionConfig()`` (3 x 201 x
201, 3 thrusts) on the card, times one call of the banded kernel's wrapper
(CUDA events, warm, median of 10, 20 calls back to back) and an N-sweep
engine loop of each, then traces each loop with ``torch.profiler``: the
device time by kernel name, the device busy share of the loop's wall time
and the host time a sweep. Writes the Chrome traces to ``<out>/``. Needs a
CUDA device; prints the card's name and power limit first.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ocdp_tpu_torch.engine import value_iteration_finite  # noqa: E402
from ocdp_tpu_torch.models import attitude, position  # noqa: E402
from ocdp_tpu_torch.ops import band_backup2d as bb  # noqa: E402
from ocdp_tpu_torch.profiling import cuda_time_ms  # noqa: E402


def trace(label, loop, sweeps, out: Path) -> None:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side entries only: a CPU op's own row repeats the time of the
    # kernels it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"{label}, traced {sweeps}-sweep loop: wall {wall_us:.1f} us "
          f"({wall_us / sweeps:.2f} us a sweep), device busy {busy_us:.1f} us "
          f"({busy_us / wall_us:.3f} of wall)")
    for e in rows:
        print(f"  {e.self_device_time_total:10.1f} us  {e.count:6d} x  "
              f"{e.key[:90]}")
    if not rows:
        print("  the profiler recorded no device time")
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"torch_{label}_trace.json"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweeps", type=int, default=300)
    ap.add_argument("--out", default="build/profile",
                    help="directory for the Chrome traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    device = torch.device("cuda")
    n = args.sweeps
    _, plan, terms = attitude.build_simplified_axis(attitude.AttitudeConfig(),
                                                    0, device=device)
    p = position.build(position.PositionConfig(), device=device)
    for label, plan, cost in (("simplified_axis", plan, terms),
                              ("position", p.plan, p.stage_cost)):
        bk = bb.BandBackup2D(plan, cost)

        def loop(plan=plan, bk=bk):
            return value_iteration_finite(plan, None, n, backup=bk)

        v = loop().values
        v3 = v if bk.batched else v[None]
        wrapper_ms = cuda_time_ms(lambda: bb.band_backup2d_cuda(v3, bk.args),
                                  inner=20)
        loop_ms = cuda_time_ms(loop)
        print(f"{label}: wrapper call, back to back {wrapper_ms:.4f} ms; "
              f"{n}-sweep loop {loop_ms:.3f} ms ({loop_ms / n:.4f} ms a "
              "sweep)")
        trace(label, loop, n, Path(args.out))


if __name__ == "__main__":
    main()
