"""Requests of ``ocdp_tpu_torch.models.pos_att.rollout_batch``: fleets of
closed-loop flights of the controller that set-up solved once
(``pos_att.solve`` at the configuration's own weights), each fleet's
starts from the mix."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from benchmark.entries import pos_att_check as pc
from benchmark.entries.common import as_config
from benchmark.reference import compare, flight
from benchmark.reference import pos_att as ref


def setup(cell):
    from ocdp_tpu_torch.models import pos_att

    sol = pos_att.solve(as_config(pos_att.PosAttConfig, cell.config),
                        device=cell.device)
    return SimpleNamespace(mod=pos_att, cell=cell, sol=sol,
                           solved=pc.port_solved(sol))


def request(state, params):
    return state.mod.rollout_batch(
        state.sol, params["x0s"], t_final=params["t_final"],
        integrator=params["integrator"], device=state.cell.device)


def units(state, out) -> float:
    """Flight seconds: flights times stages flown times ``h``."""
    X = out[1]
    return X.shape[0] * (X.shape[1] - 1) * state.cell.config["h"]


def keep(state, out, params) -> dict:
    return {"x0s": params["x0s"], "X": out[1], "F": out[2],
            "solved": state.solved}


def trace_context(state, out) -> dict:
    return {"stages": out[1].shape[1] - 1}


def _axes_forces(cfg):
    axes = [ref.channel_axes(cfg, a) for _, a, _ in ref.CHANNELS[:3]]
    forces = [ref.channel_forces(cfg, f) for _, _, f in ref.CHANNELS[:3]]
    return axes, forces


def check(cell, kept) -> dict:
    """The set-up solve against the reference's, and each kept fleet stage
    by stage."""
    sol, sound = pc.judged(cell.config, cell.device, cell.mix["check"])
    out = {"solve_" + k: v for k, v in pc.solve_numbers(
        cell.config, kept[0]["solved"], sol, sound).items()}
    axes, forces = _axes_forces(cell.config)
    for item in kept:
        got = compare.flight_numbers(cell.config, item["X"], item["F"],
                                     item["x0s"], sol, axes, forces,
                                     sound=sound)
        out = {k: max(v, out.get(k, v)) for k, v in {**out, **got}.items()}
    return out


def control(cell, params, store) -> dict:
    """The reference with its tables and states kept in ``store``
    (computed in float32) in the port's place: its own solve and its own
    closed-loop fleet, as a kept request."""
    sol = pc.reference(cell.config, cell.device, torch.float32, store)
    axes, forces = _axes_forces(cell.config)
    n = int(np.ceil(params["t_final"] / cell.config["h"]))
    X, F = flight.fly(cell.config, sol.argmin, axes, forces, params["x0s"],
                      n, torch.float32, store)
    return {"x0s": params["x0s"], "X": X.float(), "F": F.float(),
            "solved": pc.as_solved(cell.config, sol)}
