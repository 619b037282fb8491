"""Carry plans, solve results and solutions across the two packages.

The JAX package (``ocdp_tpu``) and this port share no array type. These
helpers turn the numpy form of an ``InterpPlan``, a ``SolveResult``, a
pos-att ``PosAttSolution`` or a 6-D attitude ``FullSolution`` (what
``np.asarray`` gives for either package's arrays) into this package's
tensors on a chosen device, and back. The tests
use them to feed one plan to both packages and to fly a controller solved by
one package with the other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .engine import SolveResult
from .grids import Grid
from .io import ChannelController
from .models.attitude import AttitudeConfig, FullSolution, SimplifiedSolution
from .models.pos_att import PosAttConfig, PosAttSolution
from .models.position import PositionConfig, PositionProblem, PositionSolution
from .ops.interp import InterpPlan

__all__ = ["plan_from_numpy", "result_from_numpy", "solution_from_numpy",
           "full_solution_from_numpy", "simplified_solution_from_numpy",
           "position_solution_from_numpy", "to_numpy"]


def _tensor(a, dtype, device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def plan_from_numpy(lo: Sequence, frac: Sequence, grid_shape, *,
                    device) -> InterpPlan:
    """An :class:`InterpPlan` from per-axis numpy ``lo`` (int32) and
    ``frac`` (float32) arrays, on ``device``, in either layout: broadcast
    to ``(*grid_shape, A)``, or flat (the 6-D envelope's ``(NW, 1, A)``
    row and ``(NW, NE, 1)`` lane arrays)."""
    if len(lo) != len(frac) or len(lo) != len(grid_shape):
        raise ValueError("lo, frac and grid_shape need one entry per axis")
    return InterpPlan(tuple(_tensor(x, torch.int32, device) for x in lo),
                      tuple(_tensor(x, torch.float32, device) for x in frac),
                      tuple(int(n) for n in grid_shape))


def result_from_numpy(values, argmin, policies=None, *, num_sweeps=None,
                      converged: bool = False, probes=None, checks=None,
                      digit_path=None, device) -> SolveResult:
    """A :class:`SolveResult` from numpy arrays, on ``device``.

    Integer arrays keep their dtype (policies may be uint8 or int16);
    ``num_sweeps`` defaults to the number of stored policies."""
    if num_sweeps is None:
        if policies is None:
            raise ValueError("give num_sweeps when there are no policies")
        num_sweeps = len(policies)

    def ints(a):
        return None if a is None else torch.tensor(np.asarray(a),
                                                   device=device)

    return SolveResult(
        values=_tensor(values, torch.float32, device),
        argmin=ints(argmin),
        policies=ints(policies),
        num_sweeps=int(num_sweeps),
        converged=bool(converged),
        probes=_tensor(probes, torch.float32, device),
        checks=_tensor(checks, torch.float32, device),
        digit_path=digit_path,
    )


def solution_from_numpy(sol, *, device) -> PosAttSolution:
    """A pos-att :class:`PosAttSolution` on ``device`` from one whose
    controllers hold numpy arrays: the JAX package's ``PosAttSolution``, or
    what :func:`to_numpy` gives. Each controller's ``axes``, ``values``,
    ``argmin`` and ``forces`` are carried over; the configuration is rebuilt
    from its fields."""
    ctrls = {
        name: ChannelController(
            axes=tuple(np.asarray(a) for a in c.axes),
            values=_tensor(c.values, torch.float32, device),
            argmin=_tensor(c.argmin, torch.int32, device),
            forces=np.asarray(c.forces, np.float32))
        for name, c in sol.controllers.items()}
    return PosAttSolution(PosAttConfig(**dataclasses.asdict(sol.config)),
                          ctrls)


def full_solution_from_numpy(sol, *, device) -> FullSolution:
    """A 6-D attitude :class:`FullSolution` on ``device`` from one whose
    result holds numpy-convertible arrays (the JAX package's
    ``FullSolution``, in either of its layouts): the grid axes, the values
    and the flat-action argmin, the sweep count and the stop flag; the
    configuration is rebuilt from its fields. A state-shaped result gives
    an int32 argmin in the state shape; a flat one (``(NW, NE)`` values
    and, from an envelope solve, a uint8 argmin) keeps its layout and its
    argmin dtype."""
    grid = Grid(tuple(np.asarray(a) for a in sol.grid.axes))
    res = sol.result
    values, argmin = np.asarray(res.values), np.asarray(res.argmin)
    if argmin.ndim == len(grid.shape):
        values = values.reshape(grid.shape)
        argmin = argmin.astype(np.int32).reshape(grid.shape)
    return FullSolution(
        AttitudeConfig(**dataclasses.asdict(sol.config)), grid,
        result_from_numpy(
            values, argmin, num_sweeps=int(np.asarray(res.num_sweeps)),
            converged=bool(np.asarray(res.converged)), device=device))


def simplified_solution_from_numpy(sol, *, device) -> SimplifiedSolution:
    """A simplified attitude :class:`SimplifiedSolution` on ``device`` from
    one whose tables hold numpy-convertible arrays (the JAX package's
    ``SimplifiedSolution``): each axis's ``(s_w, s_t)``, values and torque
    table, and the edge policy; the configuration is rebuilt from its
    fields."""
    return SimplifiedSolution(
        AttitudeConfig(**dataclasses.asdict(sol.config)),
        tuple(tuple(np.asarray(a) for a in ax) for ax in sol.axes),
        tuple(_tensor(t, torch.float32, device) for t in sol.u_tables),
        tuple(_tensor(v, torch.float32, device) for v in sol.values),
        sol.edge)


def position_solution_from_numpy(sol, *, device) -> PositionSolution:
    """A :class:`PositionSolution` on ``device`` from one whose problem and
    result hold numpy-convertible arrays (the JAX package's
    ``PositionSolution``): the (channel, x, v) axes, the plan, the stage
    cost, the values and the argmin (``u_tables`` follows from it); the
    configuration is rebuilt from its fields."""
    prob, res = sol.problem, sol.result
    grid = Grid(tuple(np.asarray(a) for a in prob.grid.axes))
    lo, frac = ([np.asarray(x) for x in arrs]
                for arrs in (prob.plan.lo, prob.plan.frac))
    problem = PositionProblem(
        PositionConfig(**dataclasses.asdict(prob.config)), grid,
        plan_from_numpy(lo, frac, grid.shape, device=device),
        _tensor(prob.stage_cost, torch.float32, device))
    result = result_from_numpy(
        res.values, np.asarray(res.argmin).astype(np.int32),
        num_sweeps=int(np.asarray(res.num_sweeps)),
        converged=bool(np.asarray(res.converged)), device=device)
    return PositionSolution(problem, result)


def to_numpy(x):
    """The inverse: a tensor to numpy; an :class:`InterpPlan` to
    ``(lo, frac, grid_shape)`` (the arguments of :func:`plan_from_numpy`); a
    :class:`SolveResult` to one whose tensors are numpy arrays (its
    ``_asdict()`` is the keyword form of :func:`result_from_numpy`); a
    :class:`PosAttSolution` to one whose controllers hold numpy arrays (the
    fields of the JAX package's ``ChannelController``), without results."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, PosAttSolution):
        return PosAttSolution(x.config, {
            name: ChannelController(c.axes, to_numpy(c.values),
                                    to_numpy(c.argmin), c.forces)
            for name, c in x.controllers.items()})
    if isinstance(x, InterpPlan):
        return (tuple(to_numpy(t) for t in x.lo),
                tuple(to_numpy(t) for t in x.frac), tuple(x.grid_shape))
    if isinstance(x, SolveResult):
        return SolveResult(*(to_numpy(v) if isinstance(v, torch.Tensor)
                             else v for v in x))
    raise TypeError(f"to_numpy takes a tensor, InterpPlan, SolveResult or "
                    f"PosAttSolution, not {type(x).__name__}")
