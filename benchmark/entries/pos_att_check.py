"""What the pos-att entries share: the reference's solve of the four
channels, the cells it fixes, and the port's tables judged against it."""

from __future__ import annotations

import sys

import torch

from benchmark.entries.common import DTYPES, n_stage
from benchmark.reference import compare, dp
from benchmark.reference import pos_att as ref


def reference(cfg: dict, device, dtype, store=None) -> dp.Solution:
    return dp.solve(ref.problem(cfg, device), n_stage(cfg) - 1, dtype=dtype,
                    store=store, check_every=cfg["check_every"],
                    tol=cfg["tol"])


def judged(cfg: dict, device, chk: dict):
    """The reference's solve and the cells it fixes (``compare.
    sound_cells``: its ``chk['dtype']`` and ``chk['sound_dtype']`` solves
    agree to ``chk['sound_tol']``)."""
    sol = reference(cfg, device, DTYPES[chk["dtype"]])
    other = reference(cfg, device, DTYPES[chk["sound_dtype"]])
    sound = compare.sound_cells(sol.values, other.values, chk["sound_tol"])
    left = [round(1.0 - float(s.double().mean()), 6) for s in sound]
    print(f"benchmark: cells left out, by channel: {left}", file=sys.stderr,
          flush=True)
    return sol, sound


def solve_numbers(cfg: dict, solved: dict, sol, sound) -> dict:
    """``solved``: the port's tables of the four channels (natural order)
    and sweeps."""
    values = torch.stack([ref.natural_to_rowlane(v) for v in solved["values"]])
    argmin = torch.stack([ref.natural_to_rowlane(a) for a in solved["argmin"]])
    n_act = [len(ref.channel_forces(cfg, f)) for _, _, f in ref.CHANNELS]
    return compare.solve_numbers(values, argmin, sol, n_act,
                                 solved["sweeps"], sound)


def as_solved(cfg: dict, sol) -> dict:
    """The reference's solve as the port's tables: a control's outputs."""
    shape = (cfg["n_mesh_x"], cfg["n_mesh_v"], cfg["n_mesh_t"],
             cfg["n_mesh_w"])
    n = len(ref.CHANNELS)
    return {"values": [ref.rowlane_to_natural(sol.values[c].float(), shape)
                       for c in range(n)],
            "argmin": [ref.rowlane_to_natural(sol.argmin[c], shape)
                       for c in range(n)],
            "sweeps": list(sol.sweeps)}


def port_solved(sol) -> dict:
    """A port's ``PosAttSolution`` as tables of the four channels."""
    names = [n for n, _, _ in ref.CHANNELS]
    return {"values": [sol.controllers[n].values for n in names],
            "argmin": [sol.controllers[n].argmin for n in names],
            "sweeps": [sol.results[n].num_sweeps for n in names]}
