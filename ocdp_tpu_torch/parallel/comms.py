"""Communication accounting for the halo engines (counterpart of
``ocdp_tpu/parallel/comms.py``).

The JAX package compiles a sharded sweep and counts the bytes of every
``collective-permute`` in the optimized HLO. There is no compiled program
to read here: the halo exchange is a Python loop of copies (in-process
mesh) or of point-to-point sends (process group). So the count is analytic,
and both communicators count the bytes they actually move
(``Mesh.halo_bytes``), which the tests hold equal to it.
"""

from __future__ import annotations

__all__ = ["halo_bytes", "mesh_halo_bytes", "measure_halo6_comms"]


def halo_bytes(lo: int, hi: int, row_elems: int, itemsize: int = 4) -> int:
    """Bytes one rank with both neighbors receives per sweep: its ``lo``
    rows from above and ``hi`` rows from below, ``row_elems`` elements of
    ``itemsize`` bytes each; ``(lo + hi) x NE x 4 B`` for the 6-D table."""
    return (lo + hi) * row_elems * itemsize


def mesh_halo_bytes(n_ranks: int, lo: int, hi: int, row_elems: int,
                    itemsize: int = 4) -> int:
    """Bytes all ``n_ranks`` ranks of one row line receive per sweep: the
    edge ranks have one neighbor each."""
    if n_ranks < 2:
        return 0
    return (n_ranks - 1) * (lo + hi) * row_elems * itemsize


def measure_halo6_comms(cfg, n_ranks: int, *, device="cuda",
                        **kernel_kw) -> dict:
    """One row-sharded 6-D sweep of ``AttitudeConfig`` ``cfg`` over an
    in-process mesh of ``n_ranks`` ranks on ``device``: the halo bytes the
    mesh moved beside the analytic count, and the sweep's FP32 operation
    count as the JAX package states it (``cells x A x 2 + cells x taps x
    2``)."""
    import numpy as np

    from ..models import attitude
    from .halo6 import Halo6Backup, _Ranks
    from .mesh import LocalMesh

    mesh = LocalMesh(("s",), (n_ranks,), device=device)
    grid, plan, cost = attitude.build_full(cfg, device=mesh.device)
    hb = Halo6Backup(plan, cost, mesh, **kernel_kw)
    _Ranks(hb, None).sweep()
    bk = hb.backup
    cells = int(np.prod(grid.shape))
    taps = len(bk.row_combos) * max(len(bk.lane_combos), 1)
    return {
        "cells": cells,
        "n_ranks": n_ranks,
        "halo_rows": (hb.lo, hb.hi),
        "NE": bk.NE,
        "halo_bytes_per_sweep_counted": mesh.halo_bytes,
        "halo_bytes_per_sweep_analytic": mesh_halo_bytes(
            n_ranks, hb.lo, hb.hi, bk.NE),
        "halo_bytes_per_rank_sweep_analytic": halo_bytes(hb.lo, hb.hi,
                                                         bk.NE),
        "flops_per_sweep_analytic": cells * bk.args.n_actions * 2
        + cells * taps * 2,
    }
