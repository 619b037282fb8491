"""Verification / diagnostics (counterpart of ``ocdp_tpu/diagnostics.py``).

* ``compare_solutions`` — regression by equality on saved solves, the
  ``compare_data(obj1, obj2)`` check (test/Dynamic_Solver.m:266-280): exact
  by default, tolerance-based on request.
* ``compare_stage_probes`` — the ``compare_stages`` diagnostic (:222-238)
  on per-sweep probe windows captured by the engine (``probe_window=``).

Both work in numpy on host copies, so either side may be a torch tensor on
any device, a numpy array, or a JAX result converted with ``np.asarray``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["CompareReport", "compare_solutions", "compare_stage_probes"]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CompareReport(NamedTuple):
    equal: bool
    max_value_diff: float
    policy_mismatch_frac: float

    def __bool__(self):
        return self.equal


def compare_solutions(a, b, *, atol: float = 0.0,
                      verbose: bool = False) -> CompareReport:
    """Compare two SolveResults (or anything with .values / .argmin).

    ``atol=0`` demands bitwise equality like the reference's ``isequal``;
    a small ``atol`` tolerates value differences. ``verbose`` prints the
    reference's console verdict ("Data is equal" / "Data is NOT equal",
    test/Dynamic_Solver.m:273-277) plus the diff summary.
    """
    va, vb = _host(a.values), _host(b.values)
    if va.shape != vb.shape:
        raise ValueError(f"shape mismatch {va.shape} vs {vb.shape}")
    dv = float(np.max(np.abs(va - vb))) if va.size else 0.0
    pa, pb = _host(a.argmin), _host(b.argmin)
    pm = float((pa != pb).mean()) if pa.size else 0.0
    equal = dv <= atol and (pm == 0.0 if atol == 0.0 else True)
    if verbose:
        print("Data is equal" if equal else
              f"Data is NOT equal: max |dV| = {dv:.3e}, "
              f"policy mismatch = {pm:.2%}")
    return CompareReport(equal, dv, pm)


def compare_stage_probes(probes_a, probes_b, *, atol: float = 0.0,
                         verbose: bool = False) -> bool:
    """Stage-by-stage probe-window comparison (compare_stages semantics).

    ``probes_*``: (num_sweeps, *window) arrays from the engine's
    ``probe_window`` capture. Prints differing stages when ``verbose``.
    """
    pa, pb = _host(probes_a), _host(probes_b)
    if pa.shape != pb.shape:
        raise ValueError(f"probe shape mismatch {pa.shape} vs {pb.shape}")
    ok = True
    for k in range(pa.shape[0]):
        d = float(np.max(np.abs(pa[k] - pb[k])))
        if d > atol:
            ok = False
            if verbose:
                print(f"stage {k}: max |diff| = {d:.3e}")
    return ok
