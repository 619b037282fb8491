"""Thruster-pair combination model of the pos-att channels.

Counterpart of ``ocdp_tpu/models/thrusters.py`` (numpy only). Each pos-att
channel is driven by 4 on/off thrusters, two pushing + at one moment arm and
two pushing - at the opposite arm. The admissible action set is every on/off
combination with *opposing-pair* firings pruned out (``vectors_allcomb``,
pos-att/Solver_pos_att.m:886-904): 16 -> 9 for a healthy channel.

Enumeration order matches MATLAB ``ndgrid`` + column-major flatten (the first
argument varies fastest), so argmin indices are comparable to the reference.
"""

from __future__ import annotations

import numpy as np

__all__ = ["thruster_combinations", "SPHERES_THRUSTER_FORCE",
           "SPHERES_MOMENT_ARM"]

SPHERES_THRUSTER_FORCE = 0.13  # N  (Solver_pos_att.m:171)
SPHERES_MOMENT_ARM = 9.65e-2   # m  (Solver_pos_att.m:172)


def thruster_combinations(f0, f1, f6, f7) -> np.ndarray:
    """All admissible (f0, f1, f6, f7) rows, opposing pairs pruned.

    Each argument is the value set of one thruster (e.g. ``[0, 0.13]``, or
    ``[0]`` for a failed thruster, Solver_pos_att.m:236-240). Returns an
    (n_comb, 4) float32 matrix.
    """
    g = np.meshgrid(np.asarray(f0, np.float64), np.asarray(f1, np.float64),
                    np.asarray(f6, np.float64), np.asarray(f7, np.float64),
                    indexing="ij")
    combos = np.stack([a.ravel(order="F") for a in g], axis=1)
    keep = ~(((combos[:, 0] > 0) & (combos[:, 2] < 0))
             | ((combos[:, 1] > 0) & (combos[:, 3] < 0)))
    return combos[keep].astype(np.float32)
