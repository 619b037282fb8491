"""Requests of ``ocdp_tpu_torch.models.attitude.solve_full`` on the 6-D
envelope path: the whole horizon in segments of ``segment_size`` sweeps
with the stop rule (``tol``, ``tol_mode``) and a checkpoint after each
segment, builds included, nothing kept between requests. ``impl``,
``lane_mode``, ``flat`` and ``carry_padded`` stay on their defaults, so the
port's own thresholds choose the plan, the kernel and the argmin's dtype.
Each request's stage-cost weights come from the mix; its segments and stop
rule are the mix's fixed parameters.

The checkpoint file lies in a directory the set-up makes (under the
process's temporary directory) and removes at exit. A kept request's last
checkpoint is moved aside under a name of its own, and removed when the
sample drops the request; the check reads it back through
``ocdp_tpu_torch.io.load_values`` and holds it to the returned table,
bit for bit (``checkpoint_err``)."""

from __future__ import annotations

import atexit
import itertools
import os
import shutil
import sys
import tempfile
import time
import weakref
from types import SimpleNamespace

import torch

from benchmark.entries.common import DTYPES, as_config, n_stage
from benchmark.reference import attitude_envelope as env
from benchmark.reference import compare


def setup(cell):
    from ocdp_tpu_torch.models import attitude

    home = tempfile.mkdtemp(prefix="ocdp-envelope-")
    atexit.register(shutil.rmtree, home, True)
    return SimpleNamespace(mod=attitude, cell=cell, home=home,
                           checkpoint=os.path.join(home, "solve.npz"),
                           kept=itertools.count())


def request(state, params):
    cfg = as_config(state.mod.AttitudeConfig, {**state.cell.config, **params})
    return state.mod.solve_full(
        cfg, device=state.cell.device, segment_size=params["segment_size"],
        tol=params["tol"], tol_mode=params["tol_mode"],
        checkpoint_path=state.checkpoint)


def units(state, out) -> float:
    return 1.0


def _shape(cfg):
    return cfg["n_mesh_w"] ** 3, cfg["n_mesh_q"] ** 3


def _remove(path):
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


class Checkpoint:
    """A kept request's last checkpoint file, removed with the item that
    holds it."""

    def __init__(self, path: str):
        self.path = path
        weakref.finalize(self, _remove, path)


def keep(state, out, params) -> dict:
    nw, ne = _shape(state.cell.config)
    path = os.path.join(state.home, f"kept-{next(state.kept)}.npz")
    os.replace(state.checkpoint, path)
    return {"params": params,
            "values": out.result.values.reshape(nw, ne),
            "argmin": out.result.argmin.reshape(nw, ne),
            "sweeps": out.result.num_sweeps,
            "checkpoint": Checkpoint(path)}


def trace_context(state, out) -> dict:
    return {"sweeps": out.result.num_sweeps}


def reference(cell, params, dtype, store=None):
    """The blocked reference's problem and solve of one request."""
    cfg = {**cell.config, **params}
    prob = env.problem(cfg, cell.device)
    sol = env.solve(prob, n_stage(cfg) - 1, dtype=dtype, store=store,
                    check_every=params["segment_size"], tol=params["tol"],
                    tol_mode=params["tol_mode"])
    return prob, sol


def judge(item, prob, sol, dtype) -> dict:
    """:func:`compare.solve_numbers`'s ``value_err``, ``policy_gap`` and
    ``sweeps_diff``, the action values read a block of rows at a time."""
    ref_v = sol.values.double()
    scale = float(ref_v.abs().median())
    g = compare._finite_max(
        (item["values"].to(ref_v.device).double() - ref_v).abs())
    del ref_v
    n_a = prob.c_act.numel()
    argmin = item["argmin"].to(sol.values.device).long()
    gap = 0.0
    for r0, r1, q, q_min in env.last_sweep(prob, sol, dtype=dtype):
        a = argmin[r0:r1]
        bad = (a < 0) | (a >= n_a)
        got = q.double().gather(1, a.clamp(0, n_a - 1)[:, None])[:, 0]
        gap = max(gap, compare._finite_max(
            torch.where(bad, compare.INF, got - q_min.double())))
    return {"value_err": g / (g + scale) if g < compare.INF else 1.0,
            "policy_gap": gap / scale,
            "sweeps_diff": float(abs(item["sweeps"] - sol.sweeps))}


def checkpoint_err(item) -> float:
    """The share of the returned table's cells whose bits the request's
    last checkpoint does not hold; the largest float when the file is not
    that table's, or not at the solve's last sweep."""
    from ocdp_tpu_torch import io

    ck = io.load_values(item["checkpoint"].path)
    values = item["values"].cpu().reshape(-1)
    if ck.values.numel() != values.numel() or \
            ck.values.dtype != values.dtype or \
            ck.sweep_index != item["sweeps"]:
        return compare.INF
    bits = ck.values.reshape(-1).view(torch.int32)
    return float((bits != values.view(torch.int32)).sum()) / values.numel()


def check(cell, kept) -> dict:
    dtype = DTYPES[cell.mix["check"]["dtype"]]
    out = {}
    for item in kept:
        card = cell.device.startswith("cuda")
        if card:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if card else 0
        t = time.perf_counter()
        prob, sol = reference(cell, item["params"], dtype)
        got = judge(item, prob, sol, dtype)
        del prob, sol
        peak = torch.cuda.max_memory_allocated() - base if card else 0
        print(f"benchmark: reference and judge {time.perf_counter() - t:.3f}"
              f" s, device peak {peak} B over what was held",
              file=sys.stderr, flush=True)
        if item.get("checkpoint") is not None:
            got["checkpoint_err"] = checkpoint_err(item)
        out = {k: max(v, out.get(k, v)) for k, v in got.items()}
    return out


def control(cell, params, store) -> dict:
    """The blocked reference with its tables kept in ``store`` (computed in
    float32) in the port's place: a kept request, which writes no
    checkpoint."""
    _, sol = reference(cell, params, torch.float32, store)
    return {"params": params, "values": sol.values.float(),
            "argmin": sol.argmin, "sweeps": sol.sweeps, "checkpoint": None}
