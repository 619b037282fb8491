"""Multi-rank execution: state-grid and action-axis sharding over a mesh of
ranks (counterpart of ``ocdp_tpu/parallel``).

The reference is one MATLAB process with no parallelism (SURVEY.md §2.5).
The JAX package shards the backup over ``jax.sharding.Mesh`` axes with XLA
collectives; here the engines run against a small communicator interface
(``parallel/mesh.py``): a ``torch.distributed`` process group (gloo for CPU
tensors, NCCL for CUDA tensors with one GPU per process), or an in-process
mesh whose ranks all run on one device.
"""

from .comms import halo_bytes, measure_halo6_comms, mesh_halo_bytes
from .halo import value_iteration_converged_halo, value_iteration_finite_halo
from .halo6 import value_iteration_converged_halo6, value_iteration_finite_halo6
from .mesh import LocalMesh, Mesh, ProcessGroupMesh
from .multihost import initialize_distributed, make_mesh
from .sharded import (
    ShardedPlan,
    shard_backup_inputs,
    sharded_bellman_sweeps,
    value_iteration_converged_sharded,
    value_iteration_finite_sharded,
)

__all__ = [
    "ShardedPlan",
    "shard_backup_inputs",
    "sharded_bellman_sweeps",
    "value_iteration_finite_sharded",
    "value_iteration_converged_sharded",
    "value_iteration_finite_halo",
    "value_iteration_finite_halo6",
    "value_iteration_converged_halo",
    "value_iteration_converged_halo6",
    "initialize_distributed",
    "make_mesh",
    "Mesh",
    "LocalMesh",
    "ProcessGroupMesh",
    "halo_bytes",
    "mesh_halo_bytes",
    "measure_halo6_comms",
]
