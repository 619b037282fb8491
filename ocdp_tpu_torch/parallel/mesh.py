"""How ranks talk: the communicator interface of the multi-rank engines.

The JAX package shards over a ``jax.sharding.Mesh`` and moves data with XLA
collectives inside ``shard_map`` (``ppermute`` halos, ``all_gather``,
``psum``/``pmin``). Here a mesh is a named grid of ranks (row-major: the
last axis varies fastest, as ``make_mesh`` lays devices out), and the
engines run the per-rank code of every rank this process holds, in
``local_coords`` order, against four collectives:

* :meth:`Mesh.halo_exchange`: fill each local table's halo rows from its
  neighbors along one axis (the counterpart of ``halo6.py::_make_halo_pad``
  and ``halo.py::_halo_pad_axis0``). Edge halos are left as they are: the
  engines allocate them zero, which is what the one-device sweep reads
  outside the table.
* :meth:`Mesh.all_gather`: each rank's tensor from every rank along one
  axis, in axis order.
* :meth:`Mesh.sum`: a float32 sum in axis order, identical on every rank.
* :func:`first_min`: the ascending-offset first minimum of per-group
  minima (``halo6.py::_combine_first_min``), on what ``all_gather`` gives.

Two implementations:

* :class:`LocalMesh`, ``n`` ranks in one process on one device: it runs each
  rank's block in turn and moves halos by slicing. It is the counterpart of
  the JAX tests' 8 virtual CPU devices and how one card runs the engines.
* :class:`ProcessGroupMesh`, one rank per process over ``torch.distributed``:
  gloo for CPU tensors, NCCL for CUDA tensors with one GPU per process. A
  CUDA tensor on a non-NCCL group (or a CPU tensor on an NCCL group) raises;
  nothing is staged through the host.

Both count the halo bytes they move into the tables of their ranks
(``halo_bytes``), so the analytic count of ``parallel/comms.py`` can be held
against them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["Mesh", "LocalMesh", "ProcessGroupMesh", "first_min",
           "row_blocks"]


def row_blocks(n_rows: int, n_ranks: int) -> list:
    """``[(r0, r1), ...]``: ``n_rows`` rows over ``n_ranks`` ranks in
    contiguous ascending blocks whose heights differ by at most one (the
    earlier blocks are the taller). No rank gets an empty block."""
    if n_ranks < 1 or n_rows < n_ranks:
        raise ValueError(f"{n_rows} rows do not split over {n_ranks} ranks")
    base, extra = divmod(n_rows, n_ranks)
    bounds, r0 = [], 0
    for s in range(n_ranks):
        r1 = r0 + base + (1 if s < extra else 0)
        bounds.append((r0, r1))
        r0 = r1
    return bounds


def first_min(vals: Sequence[torch.Tensor], args: Sequence[torch.Tensor],
              n_act: int):
    """Combine per-group minima (group g's values and GLOBAL action indices,
    groups of contiguous actions in ascending order) into the elementwise
    minimum and the smallest action index reaching it: the one-device first
    minimum (``halo6.py:164-174``). Returns ``(values, int32 argmin)``."""
    vmin = vals[0]
    for v in vals[1:]:
        vmin = torch.minimum(vmin, v)
    arg = None
    for v, a in zip(vals, args):
        cand = torch.where(v == vmin, a.to(torch.int32), n_act)
        arg = cand if arg is None else torch.minimum(arg, cand)
    return vmin, arg


def _ordered_sum(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


class Mesh:
    """A named grid of ranks; see the module docstring. ``shape`` maps each
    axis name to its size; ``local_coords`` are the coordinates this process
    runs; ``is_member`` is False on a process outside a sub-mesh (it must
    not run the engines); ``is_leader`` marks the process that owns rank 0
    (``on_check`` callbacks fire there only)."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int],
                 device: torch.device):
        if len(axis_names) != len(axis_sizes) or \
                len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names {tuple(axis_names)} and sizes "
                             f"{tuple(axis_sizes)} do not match")
        if any(int(n) < 1 for n in axis_sizes):
            raise ValueError(f"axis sizes {tuple(axis_sizes)} must be >= 1")
        self.axis_names = tuple(axis_names)
        self.axis_sizes = tuple(int(n) for n in axis_sizes)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.halo_bytes = 0

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))

    def axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"no mesh axis {name!r} in {self.axis_names}")
        return self.axis_names.index(name)

    def rank_of(self, coord) -> int:
        return int(np.ravel_multi_index(tuple(coord), self.axis_sizes))

    def coord_of(self, rank: int) -> tuple:
        return tuple(int(i) for i in np.unravel_index(rank, self.axis_sizes))

    is_member = True
    is_leader = True

    def _check_tensor(self, t: torch.Tensor) -> None:
        if t.device.type != self.device.type:
            raise ValueError(f"a tensor on {t.device} on a mesh of "
                             f"{self.device} ranks")

    def halo_exchange(self, tables: list, axis: str, rows: Sequence[int],
                      lo: int, hi: int) -> None:
        raise NotImplementedError

    def all_gather(self, xs: list, axis: str) -> list:
        raise NotImplementedError

    def gather_rows(self, blocks: list, axis: str,
                    bounds: Sequence[tuple]) -> torch.Tensor:
        """The whole table along dim 0 from each local rank's block along
        ``axis`` (rows ``bounds[i] = (r0, r1)`` of rank i of the axis; the
        blocks are padded to one height for the collective)."""
        height = max(r1 - r0 for r0, r1 in bounds)
        padded = [blk if blk.shape[0] == height else torch.cat(
            [blk, blk.new_zeros((height - blk.shape[0],)
                                + tuple(blk.shape[1:]))]) for blk in blocks]
        line = self.all_gather(padded, axis)[0]
        return torch.cat([p[:r1 - r0] for p, (r0, r1) in zip(line, bounds)])

    def sum(self, xs: list, axis: str) -> list:
        """For each local rank, the float32 sum of ``xs`` over its line of
        ranks along ``axis``, added left to right in axis order (so every
        rank, and both implementations, get the same bits)."""
        return [_ordered_sum(line) for line in self.all_gather(xs, axis)]


class LocalMesh(Mesh):
    """Every rank of the mesh in this process, on one ``device`` (the card
    unless the caller asks for the CPU; raises without a card)."""

    def __init__(self, axis_names: Sequence[str] = ("s",),
                 axis_sizes: Optional[Sequence[int]] = None, *,
                 device="cuda"):
        if axis_sizes is None:
            axis_sizes = [1] * len(axis_names)
        super().__init__(axis_names, axis_sizes, resolve_device(device))
        self.local_coords = [self.coord_of(r) for r in range(self.size)]

    def _line(self, coord, ax: int) -> list:
        """Local indices of the ranks along axis ``ax`` through ``coord``."""
        out = []
        for i in range(self.axis_sizes[ax]):
            c = list(coord)
            c[ax] = i
            out.append(self.rank_of(c))
        return out

    def halo_exchange(self, tables, axis, rows, lo, hi) -> None:
        ax = self.axis(axis)
        n = self.axis_sizes[ax]
        for t, coord in zip(tables, self.local_coords):
            self._check_tensor(t)
            s = coord[ax]
            line = self._line(coord, ax)
            b = rows[s]
            row_bytes = t[0].numel() * t.element_size()
            if lo and s > 0:
                src, bp = tables[line[s - 1]], rows[s - 1]
                t[:lo].copy_(src[bp:lo + bp])      # its bottom lo rows
                self.halo_bytes += lo * row_bytes
            if hi and s < n - 1:
                src = tables[line[s + 1]]
                t[lo + b:lo + b + hi].copy_(src[lo:lo + hi])   # its top rows
                self.halo_bytes += hi * row_bytes

    def all_gather(self, xs, axis) -> list:
        ax = self.axis(axis)
        for x in xs:
            self._check_tensor(x)
        return [[xs[i] for i in self._line(c, ax)] for c in self.local_coords]


class ProcessGroupMesh(Mesh):
    """One rank per process of the initialized ``torch.distributed`` group.

    ``ranks``: the group ranks that form the mesh, in mesh order (default
    the first ``prod(axis_sizes)``). Building one is collective: every
    process of the job calls it with the same arguments (each line of the
    mesh gets its own subgroup), also the processes outside ``ranks``, which
    get ``is_member`` False. ``device``: ``'cpu'`` on a gloo group, a CUDA
    device (one per process) on an NCCL group; anything else raises.
    """

    def __init__(self, axis_names: Sequence[str] = ("s",),
                 axis_sizes: Optional[Sequence[int]] = None, *,
                 device="cuda", ranks: Optional[Sequence[int]] = None):
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized; call "
                               "initialize_distributed first")
        world = dist.get_world_size()
        if axis_sizes is None:
            axis_sizes = [world] + [1] * (len(axis_names) - 1)
        device = resolve_device(device)
        self.backend = dist.get_backend()
        if (device.type == "cuda") != (self.backend == "nccl"):
            raise ValueError(
                f"a mesh of {device} tensors on a {self.backend!r} group: "
                "CUDA tensors need NCCL and CPU tensors gloo (nothing is "
                "staged through the host)")
        super().__init__(axis_names, axis_sizes, device)
        self.ranks = list(range(self.size)) if ranks is None else list(ranks)
        if len(self.ranks) != self.size or max(self.ranks) >= world:
            raise ValueError(f"{self.size} mesh ranks from {self.ranks} in a "
                             f"world of {world}")
        me = dist.get_rank()
        self.is_member = me in self.ranks
        self.mesh_rank = self.ranks.index(me) if self.is_member else None
        self.is_leader = self.mesh_rank == 0
        self.local_coords = ([self.coord_of(self.mesh_rank)]
                             if self.is_member else [])
        # one subgroup per line of ranks along each axis, created in the
        # same order on every process
        self._groups = {}
        for ax in range(len(self.axis_sizes)):
            for r in range(self.size):
                c = self.coord_of(r)
                if c[ax] != 0:
                    continue
                line = []
                for i in range(self.axis_sizes[ax]):
                    cc = list(c)
                    cc[ax] = i
                    line.append(self.ranks[self.rank_of(cc)])
                g = dist.new_group(ranks=line)
                if self.is_member and me in line:
                    self._groups[ax] = g

    def _check_tensor(self, t):
        if t.is_cuda != (self.backend == "nccl"):
            raise ValueError(f"a tensor on {t.device} on a {self.backend!r} "
                             "group: CUDA tensors need NCCL, CPU tensors "
                             "gloo")

    def _peer(self, coord, ax: int, step: int) -> int:
        c = list(coord)
        c[ax] += step
        return self.ranks[self.rank_of(c)]

    def halo_exchange(self, tables, axis, rows, lo, hi) -> None:
        import torch.distributed as dist

        ax = self.axis(axis)
        n = self.axis_sizes[ax]
        (t,), (coord,) = tables, self.local_coords
        self._check_tensor(t)
        s, b = coord[ax], rows[coord[ax]]
        row_bytes = t[0].numel() * t.element_size()
        reqs = []
        if lo:   # my bottom lo rows go down; the rows above come from s - 1
            if s < n - 1:
                reqs.append(dist.isend(t[b:lo + b], self._peer(coord, ax, 1),
                                       tag=1))
            if s > 0:
                reqs.append(dist.irecv(t[:lo], self._peer(coord, ax, -1),
                                       tag=1))
                self.halo_bytes += lo * row_bytes
        if hi:   # my top hi rows go up; the rows below come from s + 1
            if s > 0:
                reqs.append(dist.isend(t[lo:lo + hi],
                                       self._peer(coord, ax, -1), tag=2))
            if s < n - 1:
                reqs.append(dist.irecv(t[lo + b:lo + b + hi],
                                       self._peer(coord, ax, 1), tag=2))
                self.halo_bytes += hi * row_bytes
        for r in reqs:
            r.wait()

    def all_gather(self, xs, axis) -> list:
        import torch.distributed as dist

        ax = self.axis(axis)
        (x,) = xs
        self._check_tensor(x)
        x = x.contiguous()
        if self.axis_sizes[ax] == 1:
            return [[x]]
        out = [torch.empty_like(x) for _ in range(self.axis_sizes[ax])]
        dist.all_gather(out, x, group=self._groups[ax])
        return [out]
