#!/usr/bin/env python3
"""Time the row/lane (B.2) and banded 2-D (B.6) backup kernels and the three
solves that run them, on one CUDA device, for one tree of the repository.

    python3 scripts/torch_rowlane_band_compare.py [--tree DIR] [--label NAME]

Imports ``ocdp_tpu_torch`` from ``DIR`` (default: this checkout) and builds
that tree's kernels, so two trees (for instance this one and a ``git
archive`` of its parent under the gitignored ``build/``) are timed by the
same code: run parent, change, change, parent, one process each, in one
call on one card. Prints the card's name and power limit, then one line
``RESULT <json>`` per run. Works on trees whose wrappers take one channel
a call (before the batched launches) and on this one.

Timed, at the shapes the main paths run:

* B.2 at ``PosAttConfig()``: one channel's sweep (x, 450 x 600) through
  the wrapper, back to back (CUDA events, warm, median of 10), and, where
  the tree has it, the four channels' sweep in one launch;
* B.6: one simplified axis (1000 x 300) and position's 3 x 201 x 201
  through the wrapper, and, where the tree has it, the three simplified
  axes in one launch;
* for each, the kernel alone: its device time a launch under
  ``torch.profiler`` over 20 wrapper calls;
* B.2 at the shape ``attitude.solve_simplified(impl='rowlane')`` gives it
  (simplified axis 0, 25 row combos, 5 lane taps: the any-tap kind 2);
* where the tree takes more than 32 row combos: B.2 at
  ``PosAttConfig(n_mesh_w=100)``'s four channels in one launch and at
  ``PosAttConfig(n_mesh_w=120)``'s x channel, in the kind the tree picks and
  in each other kind that takes them (``rl._kind`` set for the run), each
  checked bitwise against the picked kind;
* ``pos_att.solve(PosAttConfig())``, ``attitude.solve_simplified(
  AttitudeConfig())`` and ``position.solve(PositionConfig())``: host clock
  around work that ends in a synchronize, builds included, twice;
* each solve once more under ``torch.profiler``: the device busy share
  (the device time of every kernel over the wall time) and the device time
  a launch of its backup kernel.

Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
import time
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
    from ocdp_tpu_torch.models import attitude, pos_att, position
    from ocdp_tpu_torch.ops import band_backup2d as bb
    from ocdp_tpu_torch.ops import rowlane as rl
    from ocdp_tpu_torch.profiling import cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{opts.label}: {rl.__file__} on [{smi}]", flush=True)
    dev = torch.device("cuda")
    out = {"label": opts.label, "card": smi}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def device_rows(prof):
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    def kernel_ms(key, fn, name, calls=20):
        """The device time a launch of kernel ``name`` over ``calls``
        calls of ``fn``."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in device_rows(prof) if name in e.key]
        n = sum(e.count for e in rows)
        out[key] = sum(e.self_device_time_total for e in rows) / max(n, 1) \
            / 1e3
        out[key + "_launches"] = n

    def traced(key, fn, name):
        with torch.profiler.profile(activities=acts) as prof:
            _, s_ = wall(fn)
        rows = device_rows(prof)
        busy = sum(e.self_device_time_total for e in rows)
        k = [e for e in rows if name in e.key]
        n = sum(e.count for e in k)
        out[f"{key}_traced_s"] = s_
        out[f"{key}_busy_share"] = busy / (s_ * 1e6)
        out[f"{key}_kernel_ms"] = sum(e.self_device_time_total
                                      for e in k) / max(n, 1) / 1e3
        out[f"{key}_kernel_launches"] = n

    t0 = time.perf_counter()
    _build.load()
    out["build_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    batched = hasattr(rl, "RowLaneBatch")

    # B.2 at PosAttConfig()
    cfg = pos_att.PosAttConfig()
    bks = []
    for ch, failure in (("x", False), ("y", False), ("z", False),
                        ("x", True)):
        p = pos_att.build_channel(cfg, ch, failure=failure, with_cost=False,
                                  device=dev)
        bks.append(pos_att.build_channel_rowlane_backup(cfg, p))
    tabs = [torch.from_numpy(rng.uniform(0.0, 80.0, (b.NW, b.NE))
                             .astype(np.float32)).to(dev) for b in bks]
    one = lambda: rl.rowlane_backup_cuda(tabs[0], bks[0].args)  # noqa: E731
    out["b2_one_ms"] = cuda_time_ms(one, inner=20)
    kernel_ms("b2_one_kernel_ms", one, "rowlane")
    if batched:
        ov = [torch.empty_like(t) for t in tabs]
        oa = [torch.empty(t.shape, dtype=torch.int32, device=dev)
              for t in tabs]

        def four():
            rl.rowlane_backup_cuda(tabs, [b.args for b in bks], ov, oa)

        out["b2_four_ms"] = cuda_time_ms(four, inner=20)
        kernel_ms("b2_four_kernel_ms", four, "rowlane")
    else:
        def four():
            for t, b in zip(tabs, bks):
                rl.rowlane_backup_cuda(t, b.args)

        out["b2_four_ms"] = cuda_time_ms(four, inner=5)

    # B.6: a simplified axis, the three axes, position's channels
    acfg = attitude.AttitudeConfig()
    built = [attitude.build_simplified_axis(acfg, i, device=dev)
             for i in range(3)]
    v3 = torch.from_numpy(rng.uniform(0.0, 100.0, (3, 1000, 300))
                          .astype(np.float32)).to(dev)
    bk0 = bb.BandBackup2D(built[0][1], built[0][2])
    v1 = v3[:1].contiguous()
    ax = lambda: bb.band_backup2d_cuda(v1, bk0.args)  # noqa: E731
    out["b6_axis_ms"] = cuda_time_ms(ax, inner=20)
    kernel_ms("b6_axis_kernel_ms", ax, "band_sweep")
    if hasattr(bb.BandBackup2D, "stack"):
        bk3 = bb.BandBackup2D.stack([p for _, p, _ in built],
                                    [t for _, _, t in built])
        three = lambda: bb.band_backup2d_cuda(v3, bk3.args)  # noqa: E731
        out["b6_three_ms"] = cuda_time_ms(three, inner=20)
        kernel_ms("b6_three_kernel_ms", three, "band_sweep")
    pcfg = position.PositionConfig()
    pp = position.build(pcfg, device=dev)
    pbk = bb.BandBackup2D(pp.plan, getattr(pp, "cost_terms", None)
                          or pp.stage_cost)
    pv = torch.from_numpy(rng.uniform(0.0, 100.0, pp.plan.grid_shape)
                          .astype(np.float32)).to(dev)
    pos = lambda: bb.band_backup2d_cuda(pv, pbk.args)  # noqa: E731
    out["b6_position_ms"] = cuda_time_ms(pos, inner=20)
    kernel_ms("b6_position_kernel_ms", pos, "band_sweep")
    sbk = rl.RowLaneBackup(built[0][1], built[0][2], perm=(0, 1),
                           row_axes=1)
    st = torch.from_numpy(rng.uniform(0.0, 100.0, (sbk.NW, sbk.NE))
                          .astype(np.float32)).to(dev)
    out["b2_simplified_kind"] = rl._kind((rl._plan_key(sbk.args),))
    simp = lambda: rl.rowlane_backup_cuda(st, sbk.args)  # noqa: E731
    out["b2_simplified_ms"] = cuda_time_ms(simp, inner=20)
    kernel_ms("b2_simplified_kernel_ms", simp, "rowlane")
    if rl.MAX_ROW_COMBOS >= 40:
        wide_kinds(rl, pos_att, dev, rng, out, kernel_ms)
    print(f"{opts.label}: kernels {json.dumps(out)}", flush=True)

    solves = {
        "pos_att": (lambda: pos_att.solve(cfg, device=dev), "rowlane"),
        "simplified": (lambda: attitude.solve_simplified(acfg), "band_sweep"),
        "position": (lambda: position.solve(pcfg), "band_sweep"),
    }
    for key, (fn, name) in solves.items():
        _, out[f"{key}_s"] = wall(fn)
        _, out[f"{key}_s_again"] = wall(fn)
        traced(key, fn, name)
    print("RESULT " + json.dumps(out), flush=True)


def wide_kinds(rl, pos_att, dev, rng, out, kernel_ms) -> None:
    """B.2 past 32 row combos in each kind that takes the channels."""
    import numpy as np
    import torch

    from ocdp_tpu_torch import _build
    from ocdp_tpu_torch.profiling import cuda_time_ms

    cases = {"w100_four": (100, (("x", False), ("y", False), ("z", False),
                                 ("x", True))),
             "w120_x": (120, (("x", False),))}
    picked = rl._kind
    for key, (n_w, chans) in cases.items():
        cfg = pos_att.PosAttConfig(n_mesh_w=n_w)
        bks = [pos_att.build_channel_rowlane_backup(cfg, pos_att.build_channel(
            cfg, ch, failure=f, with_cost=False, device=dev))
            for ch, f in chans]
        args = [b.args for b in bks]
        keys = tuple(rl._plan_key(a) for a in args)
        tabs = [torch.from_numpy(rng.uniform(0.0, 80.0, (b.NW, b.NE))
                                 .astype(np.float32)).to(dev) for b in bks]
        ov = [torch.empty_like(t) for t in tabs]
        oa = [torch.empty(t.shape, dtype=torch.int32, device=dev)
              for t in tabs]
        auto = picked(keys)
        combos = max(len(k[3]) for k in keys)
        kinds = [auto] + [k for k in range(len(rl.KIND_COMBOS))
                          if k != auto and combos <= rl.KIND_COMBOS[k]
                          and (not rl.KIND_TAPS3[k] or rl.KIND_TAPS3[auto])]
        out[f"{key}_combos"] = combos
        want = None
        for kind in kinds:
            rl._kind = lambda keys, kind=kind: kind
            rl._tiles.cache_clear()
            try:
                def sweep():
                    rl.rowlane_backup_cuda(tabs, args, ov, oa)

                sweep()
                got = [t.clone() for t in ov + oa]
                if want is None:
                    want = got
                out[f"{key}_kind{kind}_bitwise"] = all(
                    torch.equal(a, b) for a, b in zip(got, want))
                out[f"{key}_kind{kind}_smem"] = rl.plan_tiles(
                    keys, rl._smem_limit(_build.load(), dev)).smem_bytes
                out[f"{key}_kind{kind}_ms"] = cuda_time_ms(sweep, inner=20)
                kernel_ms(f"{key}_kind{kind}_kernel_ms", sweep, "rowlane")
            finally:
                rl._kind = picked
                rl._tiles.cache_clear()
        out[f"{key}_picked_kind"] = auto


if __name__ == "__main__":
    main()
