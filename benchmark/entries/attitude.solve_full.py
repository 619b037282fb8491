"""Requests of ``ocdp_tpu_torch.models.attitude.solve_full``: the 6-D
attitude solve over the whole horizon, builds included, nothing kept
between requests. Each request's stage-cost weights come from the mix."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark.entries.common import DTYPES, as_config, n_stage
from benchmark.reference import attitude as ref
from benchmark.reference import compare, dp


def setup(cell):
    from ocdp_tpu_torch.models import attitude

    return SimpleNamespace(mod=attitude, cell=cell)


def request(state, params):
    cfg = as_config(state.mod.AttitudeConfig, {**state.cell.config, **params})
    return state.mod.solve_full(cfg, device=state.cell.device)


def units(state, out) -> float:
    return 1.0


def _shape(cfg):
    return cfg["n_mesh_w"] ** 3, cfg["n_mesh_q"] ** 3


def keep(state, out, params) -> dict:
    nw, ne = _shape(state.cell.config)
    return {"params": params,
            "values": out.result.values.reshape(1, nw, ne),
            "argmin": out.result.argmin.reshape(1, nw, ne),
            "sweeps": [out.result.num_sweeps]}


def trace_context(state, out) -> dict:
    return {"sweeps": out.result.num_sweeps}


def reference(cell, params, dtype, store=None) -> dp.Solution:
    cfg = {**cell.config, **params}
    return dp.solve(ref.problem(cfg, cell.device), n_stage(cfg) - 1,
                    dtype=dtype, store=store)


def judge(cell, item, sol) -> dict:
    out = compare.solve_numbers(item["values"], item["argmin"], sol,
                                [len(ref.torques(cell.config))])
    out["sweeps_diff"] = float(abs(item["sweeps"][0] - sol.sweeps[0]))
    return out


def check(cell, kept) -> dict:
    dtype = DTYPES[cell.mix["check"]["dtype"]]
    out = {}
    for item in kept:
        got = judge(cell, item, reference(cell, item["params"], dtype))
        out = {k: max(v, out.get(k, v)) for k, v in got.items()}
    return out


def control(cell, params, store) -> dict:
    """The reference with its tables kept in ``store`` (computed in
    float32) in the port's place: a kept request."""
    sol = reference(cell, params, torch.float32, store)
    return {"params": params, "values": sol.values.float(),
            "argmin": sol.argmin, "sweeps": list(sol.sweeps)}
