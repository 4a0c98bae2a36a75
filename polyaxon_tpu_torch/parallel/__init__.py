"""Mesh and sharding layer of the port — counterpart of
``polyaxon_tpu/parallel``: the ``PLX_*`` rendezvous into
``torch.distributed`` (one process per GPU), the process mesh over the JAX
package's axes with its logical sharding rules, the fsdp param view and
the collectives of the sharded step, and the GPipe trunk over the
``stage`` axis (``pipeline.py``). Every axis of the JAX package runs:
``data``, ``fsdp``, ``model``, ``context``, ``stage`` and ``expert``."""

from .distributed import (
    ENV_COORDINATOR,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    ProcessInfo,
    initialize,
    local_rank,
    process_info_from_env,
    rendezvous_env,
    shutdown,
)
from .mesh import (
    DEFAULT_RULES,
    MESH_AXES,
    Mesh,
    PartitionSpec,
    ShardingRules,
    build_mesh,
    device_slice_ids,
    mesh_axis_size,
    normalize_axis_sizes,
)

__all__ = [
    "MESH_AXES",
    "DEFAULT_RULES",
    "Mesh",
    "PartitionSpec",
    "ShardingRules",
    "build_mesh",
    "device_slice_ids",
    "mesh_axis_size",
    "normalize_axis_sizes",
    "ENV_COORDINATOR",
    "ENV_NUM_PROCESSES",
    "ENV_PROCESS_ID",
    "ProcessInfo",
    "initialize",
    "local_rank",
    "process_info_from_env",
    "rendezvous_env",
    "shutdown",
]
