"""Controller and mid-solve persistence (counterpart of ``ocdp_tpu/io.py``).

The reference saves each channel controller to a ``.mat`` file
(pos-att/Solver_pos_att.m:289) and reloads it with ``set_controller``
(:849-884), which rebuilds 'nearest' interpolants of the per-thruster force
tables. Here a controller is a compressed npz holding the grid axes, value
table, argmin table and the pruned thruster-combination force matrix, in the
JAX package's format: a controller saved by either package loads in the
other.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .ops.interp import nearest_eval

__all__ = ["ChannelController", "save_channel_controller",
           "load_channel_controller", "Checkpoint", "CheckpointWriter",
           "save_values", "load_values"]


@dataclasses.dataclass(frozen=True, eq=False)
class ChannelController:
    """A solved per-channel thruster policy (the ``set_controller`` object).

    ``axes`` (host numpy) and ``forces`` (numpy ``(n_comb, n_thrusters)``
    float32, the pruned combinations) are problem metadata; ``values``
    (float32) and ``argmin`` (int32, indexing ``forces`` per state cell) are
    tensors on the device the controller was solved or loaded on.
    """

    axes: tuple
    values: torch.Tensor
    argmin: torch.Tensor
    forces: np.ndarray

    @property
    def force_tables(self) -> torch.Tensor:
        """(n_thrusters, *state_shape) per-thruster optimal force tables."""
        f = torch.as_tensor(self.forces, dtype=torch.float32,
                            device=self.argmin.device)
        return torch.movedim(f[self.argmin.long()], -1, 0)

    def thruster_forces(self, point) -> torch.Tensor:
        """Nearest-neighbor per-thruster forces at a state point: the
        reference's 4 ``'nearest'`` interpolants ``Opt_F_Thr*``
        (Solver_pos_att.m:432-447)."""
        tables = self.force_tables
        return torch.stack([nearest_eval(tables[i], self.axes, point)
                            for i in range(tables.shape[0])])


def save_channel_controller(path: str, ctrl: ChannelController) -> None:
    np.savez_compressed(
        path,
        n_axes=len(ctrl.axes),
        **{f"axis{i}": np.asarray(a) for i, a in enumerate(ctrl.axes)},
        values=ctrl.values.detach().cpu().numpy(),
        argmin=ctrl.argmin.detach().cpu().numpy(),
        forces=np.asarray(ctrl.forces),
    )


def load_channel_controller(path: str, *, device) -> ChannelController:
    with np.load(path) as z:
        n = int(z["n_axes"])
        return ChannelController(
            axes=tuple(z[f"axis{i}"] for i in range(n)),
            values=torch.tensor(z["values"], device=device),
            argmin=torch.tensor(z["argmin"], device=device),
            forces=z["forces"],
        )


class Checkpoint(NamedTuple):
    """A mid-solve checkpoint, as :func:`load_values` returns it."""

    values: torch.Tensor
    sweep_index: int
    axes: tuple
    prev_f: Optional[float]   # the last stop-rule checksum; None: no check


def save_values(path: str, values, sweep_index: int,
                axes: Sequence[np.ndarray], *,
                prev_f: Optional[float] = None,
                writer: Optional["CheckpointWriter"] = None,
                wait: bool = True) -> None:
    """Write a mid-solve checkpoint: value table, sweep count, grid axes and,
    when given, the stop rule's last checksum ``prev_f``. The npz is not
    compressed (the JAX package's is; ``np.load`` reads both): zlib over a
    table of the 6-D envelope's size takes longer than the sweeps of a
    segment (``scripts/torch_attitude_profile.py`` times both). The file is
    written under a temporary name beside ``path`` and renamed onto it, so
    the path holds the previous checkpoint until the new one is complete;
    like ``np.savez``, a path without ``.npz`` gets it appended.

    With a :class:`CheckpointWriter`, the table is copied into the writer's
    staging buffer (pinned, and ordered on the current stream, for a CUDA
    table) and the file is written on the writer's thread; with ``wait``
    the call returns once the file is complete, else at once, and the
    writer's next checkpoint (or :meth:`CheckpointWriter.close`) waits for
    it. Without a writer the call writes the file itself."""
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    arrays = {"sweep_index": np.asarray(sweep_index), "n_axes": len(axes),
              **{f"axis{i}": np.asarray(a) for i, a in enumerate(axes)}}
    if prev_f is not None:
        arrays["prev_f"] = np.float64(prev_f)
    if writer is not None:
        writer.submit(path, values, arrays, wait=wait)
        return
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    _write_npz(path, np.asarray(values), arrays)


# files handed to a writer's thread; of those, the ones complete when the
# writer next waited for them (after the device's work enqueued since);
# the seconds it waited for them
save_values.writes = 0
save_values.hidden = 0
save_values.wait_s = 0.0


def _write_npz(path: str, values: np.ndarray, arrays: dict) -> None:
    """``np.savez`` of ``values`` and ``arrays`` to a temporary file beside
    ``path``, renamed onto ``path`` once complete."""
    tmp = f"{path}.{os.getpid()}-{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, values=values, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


class CheckpointWriter:
    """Writes :func:`save_values`' files of one solve's table on a host
    thread, one at a time and in order, from one staging buffer it reuses:
    pinned host memory for a CUDA table (from PyTorch's caching host
    allocator, so a solve after the first allocates none), plain host
    memory otherwise (a CPU table's ``.numpy()`` would share the caller's
    buffer, which the next sweeps overwrite). A CUDA table's copy is
    enqueued on the current stream with an event after it, which the
    thread waits for, so the copy reads the table as the work enqueued
    before it leaves it and the work enqueued after it runs meanwhile.

    Use it as a context manager: leaving the block waits for the write in
    flight and joins its thread; a write's error is raised there, or by the
    next checkpoint, unless another error is already on its way out."""

    def __init__(self):
        self._host: Optional[torch.Tensor] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def __enter__(self) -> "CheckpointWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self.close()
        except BaseException:
            if exc_type is None:
                raise

    def submit(self, path: str, values: torch.Tensor, arrays: dict, *,
               wait: bool) -> None:
        """Wait for the device's work so far and then for the previous
        write, stage ``values`` and start writing ``path``; with ``wait``,
        return once it is complete."""
        if self._thread is not None and values.is_cuda:
            # what the write in flight hides behind: without this wait the
            # host, far ahead of the device, would find it unfinished
            torch.cuda.current_stream(values.device).synchronize()
        self.close()
        if self._host is None:
            self._host = torch.empty(values.shape, dtype=values.dtype,
                                     pin_memory=values.is_cuda)
        self._host.copy_(values, non_blocking=values.is_cuda)
        event = None
        if values.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(values.device))
        self._thread = threading.Thread(
            target=self._write, args=(path, self._host, arrays, event),
            name="ocdp.checkpoint", daemon=True)
        self._thread.start()
        save_values.writes += 1
        if wait:
            self._join()

    def close(self) -> None:
        """Wait for the write in flight, if any, counting it hidden when it
        is already complete; raise its error."""
        if self._thread is not None and not self._thread.is_alive():
            save_values.hidden += 1
        self._join()

    def _write(self, path, host, arrays, event) -> None:
        try:
            if event is not None:
                event.synchronize()
            _write_npz(path, host.numpy(), arrays)
        except BaseException as e:      # raised on the caller's thread
            self._error = e

    def _join(self) -> None:
        t = self._thread
        if t is None:
            return
        t0 = time.perf_counter()
        t.join()
        save_values.wait_s += time.perf_counter() - t0
        self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err


def load_values(path: str, *, device="cpu") -> Checkpoint:
    """Read a checkpoint written by :func:`save_values` (or by the JAX
    package's), its values on ``device``."""
    with np.load(path) as z:
        n = int(z["n_axes"])
        return Checkpoint(
            values=torch.tensor(z["values"], device=device),
            sweep_index=int(z["sweep_index"]),
            axes=tuple(z[f"axis{i}"] for i in range(n)),
            prev_f=float(z["prev_f"]) if "prev_f" in z.files else None)
