"""Process-group bootstrap and mesh construction (counterpart of
``ocdp_tpu/parallel/multihost.py``).

The JAX package bootstraps with ``jax.distributed`` and builds a
``jax.sharding.Mesh`` over every global device. Here
:func:`initialize_distributed` starts the ``torch.distributed`` group (a
no-op for one process) and :func:`make_mesh` returns the engines' mesh: a
:class:`~ocdp_tpu_torch.parallel.mesh.ProcessGroupMesh` over the group when
one with more than one process is running, else a
:class:`~ocdp_tpu_torch.parallel.mesh.LocalMesh` whose ranks all run in this
process on one device. Nothing here tells a program of a cluster: the
caller gives the address, the world size and the rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .mesh import LocalMesh, Mesh, ProcessGroupMesh

__all__ = ["initialize_distributed", "make_mesh"]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "nccl",
) -> None:
    """Start the process group of ``num_processes`` processes, this one
    being ``process_id``, rendezvousing at ``coordinator_address``
    (``'host:port'`` or a full ``init_method`` URL such as
    ``'tcp://localhost:29500'``). ``backend``: ``'nccl'`` (CUDA tensors, one
    GPU per process) or ``'gloo'`` (CPU tensors). A no-op for a single
    process (``num_processes`` None or <= 1)."""
    if num_processes is None or num_processes <= 1:
        return
    import torch.distributed as dist

    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process group needs coordinator_address "
                         "and process_id")
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def make_mesh(
    axis_names: Sequence[str] = ("s",),
    axis_sizes: Optional[Sequence[int]] = None,
    *,
    device="cuda",
    ranks: Optional[Sequence[int]] = None,
) -> Mesh:
    """A mesh with ``axis_names`` of ``axis_sizes`` ranks, row-major (the
    last axis varies fastest, as the JAX package's device order).

    With a running process group of more than one process: a
    :class:`ProcessGroupMesh` over ``ranks`` (default the first
    ``prod(axis_sizes)`` processes; ``axis_sizes`` defaults to the whole
    group on the first axis); every process must call this. Otherwise: a
    :class:`LocalMesh` of ``axis_sizes`` ranks (default 1 each) on
    ``device``, the card unless the caller asks for the CPU."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        return ProcessGroupMesh(axis_names, axis_sizes, device=device,
                                ranks=ranks)
    if ranks is not None:
        raise ValueError("ranks name processes of a process group; none is "
                         "running")
    return LocalMesh(axis_names, axis_sizes, device=device)
