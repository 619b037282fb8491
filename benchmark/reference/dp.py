"""Value iteration over a row/lane problem in plain PyTorch.

A problem's state cells form a ``(NW, NE)`` table: rows are the cells of
the axes whose next state depends on the action, lanes the cells of the
other axes, whose next state depends on the row and the lane alone. A
sweep interpolates the table at every (cell, action)'s next state
(multilinear, with linear extrapolation past the grid's edge), adds the
stage cost and takes the least over the actions. Here that is:

1. the table's rows at each distinct row shift S of a row corner, lane
   interpolated at every cell's lane corners: ``A[r, s, c]``;
2. ``Q[r, a, c] = sum_s W[r, a, s] A[r, s, c] + c_act[a]``, one batched
   matrix product, where ``W`` holds each (row, action)'s corner weights
   by shift;
3. ``V'[r, c] = min_a Q + c_row[r] + c_lane[c]``.

Channels (independent problems of one shape) run side by side. Matrix
products run with TF32 off. ``dtype`` is the precision every sweep is
computed in; ``store``, where given, the one the value table and the
plan's weights and costs are kept in between sweeps (the control keeps
them in bfloat16 and computes in float32, as bfloat16 tables are used on
the card).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

__all__ = ["RowLaneProblem", "Solution", "corners", "solve"]


class RowLaneProblem(NamedTuple):
    """``C`` channels of one shape. Corner tensors: ``row_idx``/``row_w``
    ``(C, NW, A, KR)`` (the row each row corner reads, its weight),
    ``lane_idx``/``lane_w`` ``(C, NW, NE, KL)``; costs ``c_row (C, NW)``,
    ``c_lane (C, NE)``, ``c_act (C, A)`` (``inf`` for an action a channel
    lacks)."""

    row_idx: torch.Tensor
    row_w: torch.Tensor
    lane_idx: torch.Tensor
    lane_w: torch.Tensor
    c_row: torch.Tensor
    c_lane: torch.Tensor
    c_act: torch.Tensor


class Solution(NamedTuple):
    """Per channel: the last table ``values (C, NW, NE)``, the first best
    action ``argmin``, the action values ``q (C, NW, A, NE)`` of the last
    sweep (costs of the row and lane left out: they do not depend on the
    action) and its least ``q_min (C, NW, NE)``; ``sweeps`` run by each
    channel."""

    values: torch.Tensor
    argmin: torch.Tensor
    q: torch.Tensor
    q_min: torch.Tensor
    sweeps: list


def locate(axis: torch.Tensor, q: torch.Tensor):
    """Cell index clipped to ``[0, n-2]`` and the unclipped fraction in it
    (linear extrapolation past either edge)."""
    n = axis.shape[0]
    lo = torch.searchsorted(axis, q.reshape(-1).contiguous(), right=True) - 1
    lo = lo.clamp(0, n - 2).reshape(q.shape)
    frac = (q - axis[lo]) / (axis[lo + 1] - axis[lo])
    return lo, frac


def corners(los, fracs, sizes):
    """The ``2**k`` multilinear corners of queries located on ``k`` axes of
    ``sizes`` (C order): flat cell index and weight, stacked last."""
    idx, wts = [], []
    k = len(los)
    for c in range(2 ** k):
        bits = [(c >> (k - 1 - i)) & 1 for i in range(k)]
        flat, w = 0, 1.0
        for i, b in enumerate(bits):
            stride = 1
            for s in sizes[i + 1:]:
                stride *= s
            flat = flat + (los[i] + b) * stride
            w = w * (fracs[i] if b else 1.0 - fracs[i])
        idx.append(flat)
        wts.append(w)
    shape = torch.broadcast_shapes(*(t.shape for t in (*idx, *wts)
                                     if isinstance(t, torch.Tensor)))
    return (torch.stack([t.expand(shape) for t in idx], -1),
            torch.stack([t.expand(shape) for t in wts], -1))


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def solve(p: RowLaneProblem, max_sweeps: int, *, dtype=torch.float32,
          store=None, check_every: Optional[int] = None,
          tol: float = 0.0) -> Solution:
    """``max_sweeps`` sweeps from a zero table. With ``check_every``, the
    pos-att stop rule per channel: after the sweep whose countdown
    ``k_s`` (``max_sweeps`` down to 1) is a multiple of ``check_every``,
    stop when ``|sum V - sum V at the last check| < tol`` (the sums in
    float32, the first against 0)."""
    with _no_tf32():
        return _solve(p, max_sweeps, dtype, store or dtype, check_every, tol)


def _solve(p, max_sweeps, dtype, store, check_every, tol):
    n_ch, nw, n_act, _ = p.row_idx.shape
    ne = p.lane_idx.shape[2]
    dev = p.row_idx.device
    rows = torch.arange(nw, device=dev)
    shift = p.row_idx - rows[None, :, None, None]
    shifts = torch.unique(shift)
    slot = torch.searchsorted(shifts, shift.reshape(-1)).reshape(shift.shape)
    W = torch.zeros((n_ch, nw, n_act, shifts.numel()), dtype=dtype,
                    device=dev)
    W.scatter_add_(3, slot, p.row_w.to(store).to(dtype))
    src = (rows[:, None] + shifts[None, :]).clamp(0, nw - 1)
    src = src[None] + nw * torch.arange(n_ch, device=dev)[:, None, None]
    n_s = shifts.numel()
    k_l = p.lane_idx.shape[-1]
    lane_idx = p.lane_idx.reshape(n_ch, nw, 1, ne * k_l)
    lane_w = p.lane_w.to(store).to(dtype)[:, :, None]
    c_act = p.c_act.to(store).to(dtype)[:, None, :, None]
    c_cell = (p.c_row[:, :, None] + p.c_lane[:, None, :]).to(store).to(dtype)

    v = torch.zeros((n_ch, nw, ne), dtype=store, device=dev)
    active = torch.ones(n_ch, dtype=torch.bool, device=dev)
    running = list(range(n_ch))
    sweeps = [max_sweeps] * n_ch
    prev = [torch.zeros((), dtype=torch.float32)] * n_ch
    keep_q = [None] * n_ch

    def sweep(v):
        vsh = v.reshape(n_ch * nw, ne)[src].to(dtype)       # (C, NW, S, NE)
        g = torch.gather(vsh, 3, lane_idx.expand(n_ch, nw, n_s, ne * k_l))
        a = (g.view(n_ch, nw, n_s, ne, k_l) * lane_w).sum(-1)
        q = torch.matmul(W, a) + c_act                     # (C, NW, A, NE)
        q_min, arg = q.min(dim=2)
        return q, q_min, arg

    for k_s in range(max_sweeps, 0, -1):
        q, q_min, arg = sweep(v)
        new = (q_min + c_cell).to(store)
        v = torch.where(active[:, None, None], new, v)
        if check_every and k_s % check_every == 0:
            sums = new.float().sum(dim=(1, 2)).cpu()
            stopped = []
            for c in running:
                err = sums[c] - prev[c]
                prev[c] = sums[c]
                if abs(float(err)) < tol:
                    stopped.append(c)
            for c in stopped:
                sweeps[c] = max_sweeps - k_s + 1
                keep_q[c] = (q[c].clone(), q_min[c].clone(), arg[c].clone())
                active[c] = False
                running.remove(c)
            if not running:
                break
    for c in range(n_ch):
        if keep_q[c] is None:
            keep_q[c] = (q[c], q_min[c], arg[c])
    return Solution(values=v, argmin=torch.stack([k[2] for k in keep_q]),
                    q=torch.stack([k[0] for k in keep_q]),
                    q_min=torch.stack([k[1] for k in keep_q]),
                    sweeps=sweeps)
