#!/usr/bin/env python3
"""Where the time of the port's full Kirk solve goes, on one CUDA device.

    python3 scripts/torch_kirk_profile.py [--out DIR]

Builds ``KirkConfig()`` (100x100 states, 1000 controls, 199 sweeps) on the
card and times, with CUDA events (warm, median of 10):

* one call of the fused kernel's wrapper in its affine-query mode (the
  one ``kirk.solve`` runs), back to back (20 per timing);
* the 199-sweep engine loop through the kernel, policies stored;
* one plain-PyTorch sweep on the same inputs.

Then it traces one 199-sweep loop with ``torch.profiler`` and prints the
device time by kernel name, the device busy share of the loop's wall time,
and writes the Chrome trace to ``<out>/torch_kirk_trace.json``. Needs a CUDA
device; prints the card's name and power limit first.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ocdp_tpu_torch.engine import value_iteration_finite  # noqa: E402
from ocdp_tpu_torch.models import kirk  # noqa: E402
from ocdp_tpu_torch.ops import fused_backup2d as fb  # noqa: E402
from ocdp_tpu_torch.ops.interp import PlanShape  # noqa: E402
from ocdp_tpu_torch.profiling import cuda_time_ms  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile",
                    help="directory for the Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    device = torch.device("cuda")
    cfg = kirk.KirkConfig()
    bk = kirk.affine_backup(cfg, device)
    shape = PlanShape((cfg.dx, cfg.dx), (cfg.dx, cfg.dx, cfg.du), device)
    sweeps = cfg.N - 1
    evals = cfg.dx * cfg.dx * cfg.du
    v = value_iteration_finite(shape, None, sweeps, backup=bk).values
    ov = torch.empty_like(v)
    oa = torch.empty(v.shape, dtype=torch.int32, device=device)

    def loop():
        return value_iteration_finite(shape, None, sweeps,
                                      store_policies=True, backup=bk)

    wrapper_ms = cuda_time_ms(
        lambda: fb.fused_backup2d_affine_cuda(v, bk.args, ov, oa),
        inner=20)
    loop_ms = cuda_time_ms(loop, inner=1)
    plain_ms = cuda_time_ms(
        lambda: fb.fused_backup2d_affine_plain(v, bk.args), inner=5)
    print(f"wrapper call, back to back: {wrapper_ms:.4f} ms "
          f"({evals / wrapper_ms * 1e3:.4e} evals/s)")
    print(f"{sweeps}-sweep loop: {loop_ms:.3f} ms "
          f"({loop_ms / sweeps:.4f} ms per sweep)")
    print(f"plain sweep: {plain_ms:.4f} ms ({evals / plain_ms * 1e3:.4e} "
          "evals/s)")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side entries only (kernels, memcpy/memset): a CPU op's own row
    # repeats the time of the kernels it launched
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in rows)
    print(f"traced loop: wall {wall_us:.1f} us, device busy {busy_us:.1f} us "
          f"({busy_us / wall_us:.3f} of wall)")
    for e in rows:
        print(f"  {e.self_device_time_total:10.1f} us  {e.count:5d} x  "
              f"{e.key[:90]}")
    if not rows:
        print("  the profiler recorded no device time")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "torch_kirk_trace.json"))


if __name__ == "__main__":
    main()
