"""The parallel stack on ``torch.distributed``, counterpart of
``torchdistx_tpu/parallel``: process groups (``multihost``), meshes of
ranks with one process group per axis (``mesh``), collectives over mesh
axes (``collectives``), gradient comm hooks (``comm_hooks``) and the
FSDP-style sharded train step (``fsdp``).

NCCL on the card, ``gloo`` when the caller asks for the CPU.  Tensor,
pipeline and planned parallelism, resharding, GossipGraD and SlowMo are
not ported yet.
"""

from . import collectives
from .comm_hooks import DefaultState, HookContext, allreduce_hook, noop_hook
from .fsdp import ShardedTrainStep, fsdp_partition_spec, fsdp_shard_rule
from .mesh import Mesh, NamedSharding, create_mesh, hierarchical_mesh, mesh_sharding, replicated
from .multihost import init_multihost, is_multihost, process_count, process_index

__all__ = [
    "collectives",
    "DefaultState",
    "HookContext",
    "allreduce_hook",
    "noop_hook",
    "ShardedTrainStep",
    "fsdp_partition_spec",
    "fsdp_shard_rule",
    "Mesh",
    "NamedSharding",
    "create_mesh",
    "hierarchical_mesh",
    "mesh_sharding",
    "replicated",
    "init_multihost",
    "is_multihost",
    "process_index",
    "process_count",
]
