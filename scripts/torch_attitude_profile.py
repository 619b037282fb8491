#!/usr/bin/env python3
"""Where the time of the port's 6-D attitude envelope solve goes, on one CUDA
device.

    python3 scripts/torch_attitude_profile.py [--mesh-w 30] [--mesh-q 16]
                                              [--out DIR]

At ``AttitudeConfig(n_mesh_w=30, n_mesh_q=16)`` (110.6M cells; the
README's envelope quick start) it times, host clock around work that ends
in a synchronize:

* the build of the recompute plan (``build_full``) and of its backup
  (``Backup6D``: the row plan, the lane-tap liveness, the cost split);
* one sweep of the B.5 kernel (CUDA events, warm, median of 10);
* one checkpoint of the flat table as ``io.save_values`` writes it
  (uncompressed) and as the JAX package's compressed npz;

then traces 10 sweeps of the finite engine in carry mode with
``torch.profiler``: wall time, device busy share, device time by kernel.
The Chrome trace goes to ``<out>/``. Needs a CUDA device; prints the card's
name and power limit first.
"""

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ocdp_tpu_torch import io  # noqa: E402
from ocdp_tpu_torch.engine import value_iteration_finite  # noqa: E402
from ocdp_tpu_torch.models import attitude  # noqa: E402
from ocdp_tpu_torch.ops import backup6d as b6  # noqa: E402
from ocdp_tpu_torch.ops.interp import PlanShape  # noqa: E402
from ocdp_tpu_torch.profiling import cuda_time_ms  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def traced(label: str, fn, out: Path) -> None:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
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
    for e in rows[:8]:
        print(f"  {e.self_device_time_total:12.1f} us  {e.count:6d} x  "
              f"{e.key[:90]}")
    if not rows:
        print("  the profiler recorded no device time")
    prof.export_chrome_trace(str(out / f"torch_attitude_{label}.json"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh-w", type=int, default=30)
    ap.add_argument("--mesh-q", type=int, default=16)
    ap.add_argument("--out", default="build/profile",
                    help="directory for the Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cfg = attitude.AttitudeConfig(n_mesh_w=args.mesh_w, n_mesh_q=args.mesh_q)
    cells = args.mesh_w**3 * args.mesh_q**3
    attitude.build_full(attitude.AttitudeConfig(n_mesh_w=5, n_mesh_q=4))
    (grid, plan, cost), build_s = timed(lambda: attitude.build_full(cfg))
    bk, backup_s = timed(lambda: b6.Backup6D(
        plan, cost, argmin_dtype=torch.uint8, carry_padded=True))
    print(f"{cells} cells: build_full {build_s:.3f} s ({type(plan).__name__}"
          f"), Backup6D {backup_s:.3f} s ({len(bk.lane_combos)} lane combos)")
    v = torch.zeros((bk.NW, bk.NE), dtype=torch.float32, device="cuda")
    res = value_iteration_finite(PlanShape.of(plan), None, 3, backup=bk,
                                 init_values=v, narrow_argmin_result=True)
    v = res.values
    out_v, out_a = torch.empty_like(v), torch.empty_like(res.argmin)
    ms = cuda_time_ms(lambda: b6.backup6d_cuda(
        v, bk.args, out_v=out_v, out_a=out_a))
    print(f"B.5 sweep {ms:.4f} ms ({ms * 1e6 / cells:.3f} ns per cell)")
    with tempfile.TemporaryDirectory() as tmp:
        _, save_s = timed(lambda: io.save_values(
            str(Path(tmp) / "a.npz"), v, 3, grid.axes))
        host = v.cpu().numpy()
        t0 = time.perf_counter()
        np.savez_compressed(str(Path(tmp) / "b.npz"), values=host)
        zip_s = time.perf_counter() - t0
    print(f"checkpoint of the {host.nbytes / 2**20:.1f} MiB table: "
          f"io.save_values (uncompressed) {save_s:.3f} s; compressed npz "
          f"{zip_s:.3f} s")
    traced("carry_10_sweeps", lambda: value_iteration_finite(
        PlanShape.of(plan), None, 10, backup=bk, init_values=v,
        narrow_argmin_result=True), out)


if __name__ == "__main__":
    main()
