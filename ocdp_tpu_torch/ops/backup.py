"""The Bellman backup: interpolate + stage-cost add + argmin sweep.

Counterpart of ``ocdp_tpu/ops/backup.py``: the plain gather oracle, the
equivalent of the reference's

    J_F_next = F(X_next_M1, X_next_M2)
    [F.Values, u_star_idx] = min(J_F_next + J_current_state, [], 3)

(test/Dynamic_Solver.m:207-210). Semantics matched:

* tie-break = FIRST minimum along the action axis (MATLAB ``min``);
  ``torch.min(dim=...)`` returns the first minimal index.
* multi-axis action grids are flattened to one trailing action axis in
  C order, so one flat first-min reproduces the reference's chained ``min``.
* accumulation in float32 (the reference computes in MATLAB ``single``).

NaN: ``torch.min`` PROPAGATES NaN (a NaN in a cell's action row poisons the
cell), as the JAX oracle does; MATLAB ``min`` ignores NaN. No reference
workload produces NaN. The fused kernel (``ops/fused_backup2d.py``) follows
MATLAB's rule; the two agree on finite inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .interp import InterpPlan, interp_apply

__all__ = ["BackupResult", "bellman_backup"]


class BackupResult(NamedTuple):
    values: torch.Tensor  # new value table, shape = state grid shape
    argmin: torch.Tensor  # int32 flat action index per state cell


def bellman_backup(values: torch.Tensor, plan: InterpPlan, stage_cost) -> BackupResult:
    """One backward value-iteration sweep.

    Args:
      values: current value table ``V_{k+1}``, shape ``plan.grid_shape``.
      plan: interpolation plan whose queries are the next states ``f(x, u)``
        for every state cell x action, broadcastable to
        ``(*state_shape, n_actions)`` (action axis LAST, flattened).
      stage_cost: ``g(x, u)`` broadcastable to the same query shape — either
        one tensor or a sequence of broadcast-shaped terms summed in order.

    Returns:
      ``BackupResult(values=V_k, argmin=u*_index)`` with state-grid shape.
    """
    total = interp_apply(values, plan)
    if isinstance(stage_cost, (tuple, list)):
        for term in stage_cost:
            total = total + term
    else:
        total = total + stage_cost
    total = total.expand(torch.broadcast_shapes(total.shape, plan.query_shape))
    new_values, argmin = torch.min(total, dim=-1)
    return BackupResult(new_values, argmin.to(torch.int32))
