"""Requests of ``ocdp_tpu_torch.models.kirk.solve``: Kirk's regulator over
the whole horizon, every stage's policy stored, nothing kept between
requests. Each request's cost weights Q and R come from the mix."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark.entries.common import DTYPES, as_config
from benchmark.reference import compare
from benchmark.reference import kirk as ref


def setup(cell):
    from ocdp_tpu_torch.models import kirk

    return SimpleNamespace(mod=kirk, cell=cell)


def request(state, params):
    cfg = as_config(state.mod.KirkConfig, {**state.cell.config, **params})
    return state.mod.solve(cfg, device=state.cell.device)


def units(state, out) -> float:
    return 1.0


def keep(state, out, params) -> dict:
    n = state.cell.config["dx"]
    return {"params": params,
            "values": out.result.values.reshape(1, n, n),
            "argmin": out.result.argmin.reshape(1, n, n),
            "policies": out.result.policies,
            "sweeps": [out.result.num_sweeps]}


def trace_context(state, out) -> dict:
    return {"sweeps": out.result.num_sweeps}


def reference(cell, params, dtype, store=None, policies=None):
    return ref.solve({**cell.config, **params}, cell.device, dtype=dtype,
                     store=store, policies=policies)


def judge(cell, item, r) -> dict:
    """The last table and argmin against the reference's last sweep, and
    every stage's policy against that stage's action values."""
    out = compare.solve_numbers(item["values"], item["argmin"], r.solution,
                                [cell.config["du"]])
    out["policy_gap"] = max(out["policy_gap"], r.policy_gap)
    out["sweeps_diff"] = float(abs(item["sweeps"][0]
                                   - r.solution.sweeps[0]))
    return out


def check(cell, kept) -> dict:
    dtype = DTYPES[cell.mix["check"]["dtype"]]
    out = {}
    for item in kept:
        policies = item["policies"]
        if policies is None:
            policies = torch.empty(0, dtype=torch.int64)
        got = judge(cell, item, reference(cell, item["params"], dtype,
                                          policies=policies))
        out = {k: max(v, out.get(k, v)) for k, v in got.items()}
    return out


def control(cell, params, store) -> dict:
    """The reference with its tables kept in ``store`` (computed in
    float32) in the port's place: a kept request."""
    r = reference(cell, params, torch.float32, store)
    return {"params": params, "values": r.solution.values.float(),
            "argmin": r.solution.argmin, "policies": r.policies,
            "sweeps": list(r.solution.sweeps)}
