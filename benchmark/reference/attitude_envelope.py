"""The full 6-D attitude problem of :mod:`.attitude` at the envelope's
scale, swept in blocks of rows.

At 48^3 x 10^3 = 110.6M cells :func:`.dp.solve`'s one-shot sweep would
gather a ``(NW, S, NE, 8)`` tensor, about 96 GB. Here the rows' corners
are built once (``(NW, A, 8)``, small), the Euler next states are located
once and kept per axis (``lo`` in uint8 and ``frac`` in float32, 15 B a
cell), and each sweep runs :func:`.dp.solve`'s steps on ``block_rows``
rows at a time: the table's rows at each row shift, interpolated at the
block's lane corners, the product with the rows' weights, the action
costs, the least action, the row and lane costs. Each step is dp's, op for
op, on the block's rows; the next states are :func:`.attitude.located`'s
formulas, computed a block of rows at a time.

The stop rule is the segmented engine's in ``rel`` mode, evaluated after
the converged engine's check sweeps: after the sweep whose countdown k_s
(``max_sweeps`` down to 1) is a multiple of ``check_every``, stop when
``|sum V - sum V at the last check| < tol * max(|sum V|, 1)``, the sums in
float32, the first against 0.

:func:`last_sweep` gives the last sweep's action values block by block,
recomputed from the table that sweep read, so that nothing of size ``(NW,
A, NE)`` is kept. Plain PyTorch, matrix products with TF32 off; nothing of
the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import attitude as ref
from .dp import _no_tf32, corners, locate

__all__ = ["Problem", "Solution", "rows", "lane_parts", "lanes", "problem",
           "solve", "last_sweep", "default_block_rows"]

# bytes of a block's transients a sweep may take (the gather and its
# weighted copy dominate: 72 B a cell and row shift)
BLOCK_BYTES = 4e9


class Problem(NamedTuple):
    """One 6-D problem: ``row_idx``/``row_w`` ``(NW, A, 8)`` (the row each
    row corner reads, its weight), the Euler next states ``lane_lo`` (three
    uint8 ``(NW, NE)``) and ``lane_frac`` (three float32 ``(NW, NE)``),
    costs ``c_row (NW,)``, ``c_lane (NE,)``, ``c_act (A,)``; ``m`` the
    Euler points an axis."""

    row_idx: torch.Tensor
    row_w: torch.Tensor
    lane_lo: tuple
    lane_frac: tuple
    c_row: torch.Tensor
    c_lane: torch.Tensor
    c_act: torch.Tensor
    m: int


class Solution(NamedTuple):
    """The last table ``values (NW, NE)`` (in the stored precision), the
    first best action ``argmin`` (uint8) of the last sweep, the table that
    sweep read (``before``) and the sweeps run."""

    values: torch.Tensor
    argmin: torch.Tensor
    before: torch.Tensor
    sweeps: int


def rows(cfg: dict, device):
    """The omega next states located on the omega axis, per axis ``(n, n,
    n, A)`` ``(lo, frac)``; the rows' omegas, three ``(NW,)``; the torques
    ``(A, 3)``. :func:`.attitude.located`'s row part."""
    h = cfg["h"]
    J1, J2, J3 = cfg["inertia_diag"]
    s_w = torch.as_tensor(ref.axes(cfg)[0], device=device)
    n = s_w.numel()
    u = torch.as_tensor(ref.torques(cfg), device=device)
    w1 = s_w[:, None, None, None]
    w2 = s_w[None, :, None, None]
    w3 = s_w[None, None, :, None]
    u1, u2, u3 = (u[:, k][None, None, None, :] for k in range(3))
    w1n = w1 + h * ((J2 - J3) / J1 * w2 * w3 + u1 / J1)
    w2n = w2 + h * ((J3 - J1) / J2 * w3 * w1 + u2 / J2)
    w3n = w3 + h * ((J1 - J2) / J3 * w1 * w2 + u3 / J3)
    shape = (n, n, n, u.shape[0])
    located = [locate(s_w, x.expand(shape)) for x in (w1n, w2n, w3n)]
    rw = [a.expand(n, n, n).reshape(-1) for a in
          (s_w[:, None, None], s_w[None, :, None], s_w[None, None, :])]
    return located, rw, u


def lane_parts(cfg: dict, device):
    """What every block's Euler step takes: the omega axis, the three Euler
    axes and the lanes' quaternion, four ``(1, NE)``."""
    s_w_np, eul_np = ref.axes(cfg)
    e = [torch.as_tensor(a, device=device) for a in eul_np]
    m = e[0].numel()
    yaw = e[0][:, None, None]
    pitch = e[1][None, :, None]
    roll = e[2][None, None, :]
    half = [(torch.cos(a / 2), torch.sin(a / 2)) for a in (yaw, pitch, roll)]
    q = tuple(t.expand(m, m, m).reshape(1, -1)
              for t in ref._quat(*half[0], *half[1], *half[2]))
    return torch.as_tensor(s_w_np, device=device), e, q


def lanes(cfg: dict, parts, r0: int, r1: int):
    """The Euler next states of rows ``[r0, r1)`` located on the Euler
    axes: per axis ``(lo, frac)``, ``(r1 - r0, NE)``."""
    h = cfg["h"]
    s_w, e, (q1, q2, q3, q4) = parts
    n = s_w.numel()
    r = torch.arange(r0, r1, device=s_w.device)
    a1 = s_w[r // (n * n)][:, None]
    a2 = s_w[(r // n) % n][:, None]
    a3 = s_w[r % n][:, None]
    p1 = q1 + h * 0.5 * (a3 * q2 - a2 * q3 + a1 * q4)
    p2 = q2 + h * 0.5 * (-a3 * q1 + a1 * q3 + a2 * q4)
    p3 = q3 + h * 0.5 * (a2 * q1 - a1 * q2 + a3 * q4)
    p4 = q4 + h * 0.5 * (-a1 * q1 - a2 * q2 - a3 * q3)
    norm = torch.sqrt(p1 * p1 + p2 * p2 + p3 * p3 + p4 * p4)
    p1, p2, p3, p4 = p1 / norm, p2 / norm, p3 / norm, p4 / norm
    yaw_n = torch.atan2(2 * (p3 * p2 + p4 * p1),
                        p4 * p4 + p3 * p3 - p2 * p2 - p1 * p1)
    pitch_n = torch.asin(torch.clamp(-2 * (p3 * p1 - p4 * p2), -1.0, 1.0))
    roll_n = torch.atan2(2 * (p2 * p1 + p4 * p3),
                         p4 * p4 - p3 * p3 - p2 * p2 + p1 * p1)
    return [locate(ax, x) for ax, x in zip(e, (yaw_n, pitch_n, roll_n))]


def default_block_rows(ne: int, n_shifts: int, n_act: int) -> int:
    """Rows a block takes within :data:`BLOCK_BYTES` of transients."""
    per_row = ne * (72 * n_shifts + 8 * n_act)
    return max(1, int(BLOCK_BYTES // per_row))


def problem(cfg: dict, device, block_rows: Optional[int] = None
            ) -> Problem:
    """The problem of :func:`.attitude.problem`, its Euler next states
    located ``block_rows`` rows at a time."""
    n, m = cfg["n_mesh_w"], cfg["n_mesh_q"]
    nw, ne = n ** 3, m ** 3
    located, rw, u = rows(cfg, device)
    n_a = u.shape[0]
    los, frs = zip(*located)
    r_idx, r_w = corners(los, frs, (n, n, n))
    parts = lane_parts(cfg, device)
    lo = [torch.empty((nw, ne), dtype=torch.uint8, device=device)
          for _ in range(3)]
    fr = [torch.empty((nw, ne), dtype=torch.float32, device=device)
          for _ in range(3)]
    step = block_rows or default_block_rows(ne, 27, n_a)
    for r0 in range(0, nw, step):
        r1 = min(r0 + step, nw)
        for k, (l, f) in enumerate(lanes(cfg, parts, r0, r1)):
            lo[k][r0:r1] = l
            fr[k][r0:r1] = f
    q = parts[2]
    c_row = (cfg["Qw"][0] * rw[0] ** 2 + cfg["Qw"][1] * rw[1] ** 2
             + cfg["Qw"][2] * rw[2] ** 2)
    c_lane = (cfg["Qq"][0] * q[0] ** 2 + cfg["Qq"][1] * q[1] ** 2
              + cfg["Qq"][2] * q[2] ** 2).reshape(-1)
    c_act = (cfg["R"][0] * u[:, 0] ** 2 + cfg["R"][1] * u[:, 1] ** 2
             + cfg["R"][2] * u[:, 2] ** 2)
    return Problem(r_idx.reshape(nw, n_a, 8), r_w.reshape(nw, n_a, 8),
                   tuple(lo), tuple(fr), c_row, c_lane, c_act, m)


class _Sweep:
    """:func:`.dp.solve`'s sweep of one channel, a block of rows at a
    time."""

    def __init__(self, p: Problem, dtype, store, block_rows):
        nw, n_act, _ = p.row_idx.shape
        dev = p.row_idx.device
        self.p, self.dtype, self.store = p, dtype, store
        r = torch.arange(nw, device=dev)
        shift = p.row_idx - r[:, None, None]
        shifts = torch.unique(shift)
        slot = torch.searchsorted(shifts, shift.reshape(-1)) \
            .reshape(shift.shape)
        self.W = torch.zeros((nw, n_act, shifts.numel()), dtype=dtype,
                             device=dev)
        self.W.scatter_add_(2, slot, p.row_w.to(store).to(dtype))
        self.src = (r[:, None] + shifts[None, :]).clamp(0, nw - 1)
        self.c_act = p.c_act.to(store).to(dtype)[None, :, None]
        ne = p.c_lane.numel()
        self.step = block_rows or default_block_rows(ne, shifts.numel(),
                                                     n_act)
        self.nw, self.ne = nw, ne

    def blocks(self):
        return [(r0, min(r0 + self.step, self.nw))
                for r0 in range(0, self.nw, self.step)]

    def q(self, v: torch.Tensor, r0: int, r1: int):
        """The block's action values ``(B, A, NE)`` and their least."""
        p, dtype, store = self.p, self.dtype, self.store
        b, ne = r1 - r0, self.ne
        los = [lo[r0:r1].long() for lo in p.lane_lo]
        frs = [fr[r0:r1] for fr in p.lane_frac]
        idx, w = corners(los, frs, (p.m, p.m, p.m))        # (B, NE, 8)
        n_s = self.src.shape[1]
        vsh = v[self.src[r0:r1]].to(dtype)                  # (B, S, NE)
        g = torch.gather(vsh, 2, idx.reshape(b, 1, ne * 8)
                         .expand(b, n_s, ne * 8))
        a = (g.view(b, n_s, ne, 8) * w.to(store).to(dtype)[:, None]).sum(-1)
        q = torch.matmul(self.W[r0:r1], a) + self.c_act     # (B, A, NE)
        return q, q.min(dim=1)

    def __call__(self, v: torch.Tensor, out: torch.Tensor,
                 arg: torch.Tensor) -> None:
        p, dtype, store = self.p, self.dtype, self.store
        for r0, r1 in self.blocks():
            _, (q_min, a) = self.q(v, r0, r1)
            c_cell = (p.c_row[r0:r1, None] + p.c_lane[None, :]) \
                .to(store).to(dtype)
            out[r0:r1] = (q_min + c_cell).to(store)
            arg[r0:r1] = a.to(torch.uint8)


def solve(p: Problem, max_sweeps: int, *, dtype=torch.float32, store=None,
          check_every: Optional[int] = None, tol: Optional[float] = None,
          tol_mode: str = "rel", block_rows: Optional[int] = None
          ) -> Solution:
    """``max_sweeps`` sweeps from a zero table, with the stop rule when
    ``check_every`` and ``tol`` are given (``tol_mode`` 'rel' alone).
    ``store``: the precision the table and the weights and costs are kept
    in between sweeps (``dtype`` when None)."""
    store = store or dtype
    if tol_mode != "rel":
        raise ValueError(f"the reference has the 'rel' stop rule alone, "
                         f"not {tol_mode!r}")
    with _no_tf32():
        sweep = _Sweep(p, dtype, store, block_rows)
        dev = p.row_idx.device
        v = torch.zeros((sweep.nw, sweep.ne), dtype=store, device=dev)
        arg = torch.zeros((sweep.nw, sweep.ne), dtype=torch.uint8,
                          device=dev)
        prev = torch.zeros((), dtype=torch.float32)
        before, done = v, 0
        for k_s in range(max_sweeps, 0, -1):
            before, v = v, torch.empty_like(v)
            sweep(before, v, arg)
            done += 1
            if check_every and tol is not None and k_s % check_every == 0:
                fsum = v.float().sum().cpu()
                err = float(fsum - prev)
                prev = fsum
                if abs(err) < tol * max(abs(float(fsum)), 1.0):
                    break
    return Solution(values=v, argmin=arg, before=before, sweeps=done)


def last_sweep(p: Problem, sol: Solution, *, dtype=torch.float32,
               store=None, block_rows: Optional[int] = None):
    """The last sweep's action values, block by block: ``(r0, r1, q,
    q_min)`` with ``q (r1 - r0, A, NE)`` (the row and lane costs left out,
    as in :class:`.dp.Solution`), recomputed from ``sol.before``."""
    store = store or dtype
    with _no_tf32():
        sweep = _Sweep(p, dtype, store, block_rows)
        for r0, r1 in sweep.blocks():
            q, (q_min, _) = sweep.q(sol.before, r0, r1)
            yield r0, r1, q, q_min
