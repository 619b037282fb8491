"""Requests of ``ocdp_tpu_torch.models.pos_att.solve``: the four channels
(x, y, z, x_failure) solved in one batch, builds included, nothing kept
between requests. Each request's stage-cost weights come from the mix."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from benchmark.entries import pos_att_check as pc
from benchmark.entries.common import as_config


def setup(cell):
    from ocdp_tpu_torch.models import pos_att

    return SimpleNamespace(mod=pos_att, cell=cell)


def request(state, params):
    cfg = as_config(state.mod.PosAttConfig, {**state.cell.config, **params})
    return state.mod.solve(cfg, device=state.cell.device)


def units(state, out) -> float:
    return 1.0


def keep(state, out, params) -> dict:
    return {"params": params, **pc.port_solved(out)}


def trace_context(state, out) -> dict:
    return {"sweeps": {n: r.num_sweeps for n, r in out.results.items()}}


def check(cell, kept) -> dict:
    out = {}
    for item in kept:
        cfg = {**cell.config, **item["params"]}
        sol, sound = pc.judged(cfg, cell.device, cell.mix["check"])
        got = pc.solve_numbers(cfg, item, sol, sound)
        out = {k: max(v, out.get(k, v)) for k, v in got.items()}
    return out


def control(cell, params, store) -> dict:
    """The reference with its tables kept in ``store`` (computed in
    float32) in the port's place: a kept request."""
    cfg = {**cell.config, **params}
    sol = pc.reference(cfg, cell.device, torch.float32, store)
    return {"params": params, **pc.as_solved(cfg, sol)}
