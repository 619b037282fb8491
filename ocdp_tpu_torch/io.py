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
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .ops.interp import nearest_eval

__all__ = ["ChannelController", "save_channel_controller",
           "load_channel_controller", "Checkpoint", "save_values",
           "load_values"]


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
                prev_f: Optional[float] = None) -> None:
    """Write a mid-solve checkpoint: value table, sweep count, grid axes and,
    when given, the stop rule's last checksum ``prev_f``. The npz is not
    compressed (the JAX package's is; ``np.load`` reads both): zlib over a
    table of the 6-D envelope's size takes longer than the sweeps of a
    segment (``scripts/torch_attitude_profile.py`` times both)."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    extra = {} if prev_f is None else {"prev_f": np.float64(prev_f)}
    np.savez(
        path,
        values=np.asarray(values),
        sweep_index=np.asarray(sweep_index),
        n_axes=len(axes),
        **{f"axis{i}": np.asarray(a) for i, a in enumerate(axes)},
        **extra,
    )


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
