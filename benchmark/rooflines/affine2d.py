"""FP32 operations and bytes of one sweep of Kirk's regulator through the
fused 2-D backup's affine-query mode (kernel B.1), counted from the
configuration. Operations: 26 an evaluation (the two queries' sums 2; the
walk's edge compares 4; two numerators and two divides 4; the
complements 2; four weights, four weighted corners and three sums 11; the
cost's two sums 2; the compare 1), 6 a cell for its two next-state parts
and its splits' compares, and the ``2 * A`` products ``b_k * u`` of each
block. Bytes: the table, the axes, the controls, the two cost parts and,
where a block stages table rows, the row plan read once; the values and a
4-byte argmin written.

The launch shape (16 cells a block, the controls in at most 32 splits)
and what a block stages are the kernel's, as its host planner derives
them from the configuration: the rows a block stages run from the least
to the greatest axis-0 cell its cells' next states reach at the least
and the greatest control, and the table is read from global memory when
those rows, the axes, every control's 16-byte record (or 32 of each
split's) and the split minima outgrow a block's 232,448 B of shared
memory."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["kirk_sweep", "launch_shape"]

CELLS_PER_BLOCK = 16
SPLITS = 32
CHUNK_ACTIONS = 32
SMEM_BYTES = 232_448


def _rows(x: np.ndarray, u: np.ndarray, a_row, b: float) -> int:
    """The most table rows a block stages: per cell the axis-0 cells of
    its next states at the least and the greatest control, the least and
    the greatest over a block's cells and the row after."""
    g0 = torch.as_tensor(x)
    ut = torch.as_tensor(u)
    ends = torch.stack([ut.min(), ut.max()])
    q = a_row[0] * g0[:, None, None] + a_row[1] * g0[None, :, None] \
        + b * ends[None, None, :]
    n = g0.shape[0]
    lo = (torch.searchsorted(g0, q.reshape(-1).contiguous(), right=True) - 1)
    lo = lo.clamp(0, n - 2).reshape(-1, 2)
    blocks = math.ceil(lo.shape[0] / CELLS_PER_BLOCK)
    pad = blocks * CELLS_PER_BLOCK - lo.shape[0]
    first = torch.cat([lo.min(1).values, lo.min(1).values[-1:].expand(pad)])
    last = torch.cat([lo.max(1).values, lo.max(1).values[-1:].expand(pad)])
    rows = last.reshape(blocks, CELLS_PER_BLOCK).max(1).values + 2 \
        - first.reshape(blocks, CELLS_PER_BLOCK).min(1).values
    return int(rows.max())


def launch_shape(cfg: dict) -> tuple:
    """``(blocks, splits, table_global)`` of one sweep of ``cfg``."""
    n, a = cfg["dx"], cfg["du"]
    per = math.ceil(a / min(SPLITS, a))
    splits = math.ceil(a / per)
    blocks = math.ceil(n * n / CELLS_PER_BLOCK)
    x = np.linspace(cfg["x_min"], cfg["x_max"], n).astype(np.float32)
    u = np.linspace(cfg["u_min"], cfg["u_max"], a).astype(np.float32)
    a_row = tuple(float(v) for v in cfg["A"][0])
    rows = _rows(x, u, a_row, float(cfg["B"][0]))
    minima = 8 * CELLS_PER_BLOCK * splits
    staged = 4 * (-(-rows * n // 4) * 4 + 2 * n)
    chunk = min(CHUNK_ACTIONS, per)
    fits = min(16 * a, 16 * splits * chunk) + staged + minima <= SMEM_BYTES
    return blocks, splits, not fits


def kirk_sweep(cfg: dict):
    """``(flops, bytes)`` of one sweep of the configuration ``cfg``."""
    n, a = cfg["dx"], cfg["du"]
    blocks, splits, table_global = launch_shape(cfg)
    s = n * n
    flops = 26.0 * s * a + (6 + splits - 1) * s + 2.0 * a * blocks
    row_plan = 0 if table_global else 8 * blocks
    nbytes = 4 * (s + 2 * n + a + s + a) + row_plan + 8 * s
    return flops, float(nbytes)
