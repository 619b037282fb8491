"""One run of one cell: set-up, the measured window, the traced passes,
the check against the reference, and the result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the configuration (``configs/<config>.json``), the
traffic mix (``traffic/<traffic>.json``, read by :mod:`.traffic`), the
entry the mix drives (``entries/<entry>.py``), each end-to-end metric
(``end_to_end/<name>.py``) and each per-layer metric
(``metrics/<name>.py``). Adding a cell, a mix or a metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from . import traffic, tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ocdp_tpu")


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    safe = "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(
        f"benchmark._{kind}_{safe}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merged(base: dict, over: dict) -> dict:
    """``base`` with ``over`` laid on it, dict into dict."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def load_cell(workload: str, *, device: str = "cuda", config_overrides=None,
              mix_overrides=None, bench=None):
    """The cell's definition: its entry in ``bench`` (``BENCHMARK.json``
    when None), its configuration, its mix and the metrics it reports."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    params = dict(config["params"], **(config_overrides or {}))
    mix = merged(json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                            .read_text()), mix_overrides or {})

    def reports(m):
        return workload in m.get("workloads", [workload])

    return SimpleNamespace(
        name=workload, chips=w["chips"], config=params, mix=mix,
        device=device,
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)])


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device: str):
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _card():
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout.split()
        out["power_limit_w"] = float(smi[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return out


class Reservoir:
    """A uniform sample, drawn from the seed, of ``k`` of the requests."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed, 2])
        self.items = []
        self.seen = 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.items[j] = item


def _window(cell, entry, state, gen, seconds: float, keep: Reservoir):
    """Closed-loop requests until ``seconds`` have passed; the request in
    flight then is finished and counted."""
    lat, units, failed = [], [], 0
    _sync(cell.device)
    start = time.perf_counter()
    while True:
        params = gen.next()
        t = time.perf_counter()
        try:
            out = entry.request(state, params)
            _sync(cell.device)
        except Exception:                     # a failed request is counted
            traceback.print_exc()
            failed += 1
            out = None
        lat.append(time.perf_counter() - t)
        if out is not None:
            units.append(entry.units(state, out))
            keep.offer(entry.keep(state, out, params))
            del out
        if time.perf_counter() - start >= seconds:
            break
    return SimpleNamespace(elapsed=time.perf_counter() - start,
                           latencies=lat, units=units, failed=failed)


def _traced(cell, entry, state, gen, metrics):
    """The timing pass and the profile pass over the mix's traced
    requests."""
    import torch

    timed_targets = [t for m in metrics for t in getattr(m, "TIMED", ())]
    span_targets = [t for m in metrics for t in getattr(m, "SPANS", ())]
    reqs = gen.traced()
    totals, calls = {}, Counter()
    with tracing.wrapped(timed_targets, tracing.timer(
            totals, calls, lambda: _sync(cell.device))):
        for p in reqs:
            entry.request(state, p)
            _sync(cell.device)
    context = []
    with tracing.wrapped(span_targets, tracing.spanner):
        with tracing.profiled() as prof:
            for p in reqs:
                with torch.profiler.record_function(tracing.REQUEST):
                    with torch.profiler.record_function(tracing.CALL):
                        out = entry.request(state, p)
                    _sync(cell.device)
                context.append(entry.trace_context(state, out))
                del out
    return tracing.reduce_profile(
        prof, [tracing.span_name(t) for t in span_targets], context,
        cell.config, totals, calls, len(reqs))


def _breakdown(tr) -> dict:
    ops = sorted(tr.kernels.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(tr.idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t0: float, device: str = "cuda", config_overrides=None,
             mix_overrides=None, bench=None) -> dict:
    """One run; returns the result line's object (``checks`` last). Raises
    ``RuntimeError`` when a forbidden module was loaded."""
    cell = load_cell(workload, device=device,
                     config_overrides=config_overrides,
                     mix_overrides=mix_overrides, bench=bench)
    import torch

    entry = load_module("entries", cell.mix["entry"])
    gen = traffic.Generator(cell.mix, cell.config, seed)
    state = entry.setup(cell)
    for p in gen.warmups():
        entry.request(state, p)
        _sync(device)
    setup_s = time.perf_counter() - t0

    metrics, tr = {}, None
    if trace:
        mods = {m["name"]: load_module("metrics", m["name"])
                for m in cell.per_layer}
        tr = _traced(cell, entry, state, gen, list(mods.values()))
        for m in cell.per_layer:
            v = mods[m["name"]].read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    keep = Reservoir(cell.mix["check"]["sample"], seed)
    win = _window(cell, entry, state, gen, seconds, keep)
    win.setup_s = setup_s
    if not trace:
        for m in cell.end_to_end:
            v = load_module("end_to_end", m["name"]).read(win)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    dev = _card() if device.startswith("cuda") else {
        "platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if device.startswith("cuda") else 0)
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"forbidden modules loaded: {bad}")

    # the port's state is freed before the reference runs
    del state
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    limits = cell.mix["check"]["limits"]
    lat = sorted(win.latencies)
    log(f"window {win.elapsed:.3f} s, {len(lat)} requests, "
        f"{win.failed} failed; latency min {lat[0]:.4f} median "
        f"{lat[len(lat) // 2]:.4f} max {lat[-1]:.4f} s; setup {setup_s:.3f} "
        f"s; judging {len(keep.items)}")
    t_check = time.perf_counter()
    try:
        numbers = entry.check(cell, keep.items)
    except Exception:
        traceback.print_exc()
        numbers = {}
    log(f"check {time.perf_counter() - t_check:.3f} s")
    checks = {k: {"value": numbers.get(k, sys.float_info.max), "limit": lim}
              for k, lim in limits.items()}
    correct = (win.failed == 0 and bool(keep.items)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": correct, "attempted": len(win.latencies),
           "failed": win.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        out["breakdown"] = _breakdown(tr)
    out["checks"] = checks
    return out


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as exc:
        print(f"benchmark: torch is missing ({exc})", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import ocdp_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"benchmark: the port ocdp_tpu_torch is missing ({exc})",
              file=sys.stderr)
        return 2
    try:
        res = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), t0=t0)
    except RuntimeError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
