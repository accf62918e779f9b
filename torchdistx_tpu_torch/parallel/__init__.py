"""The parallel stack on ``torch.distributed``, counterpart of
``torchdistx_tpu/parallel``: process groups (``multihost``), meshes of
ranks with one process group per axis (``mesh``), collectives over mesh
axes (``collectives``), gradient comm hooks (``comm_hooks``, and
GossipGraD's in ``gossip_grad``; SlowMo's is in ``torchdistx_tpu_torch.
slowmo``) and the FSDP-style sharded train step (``fsdp``, with divergent
replicas).

NCCL on the card, ``gloo`` when the caller asks for the CPU (or for
several ranks on one card).  Tensor, pipeline and planned parallelism and
resharding are not ported yet.
"""

from . import collectives
from .comm_hooks import DefaultState, HookContext, allreduce_hook, noop_hook
from .fsdp import ShardedTrainStep, fsdp_partition_spec, fsdp_shard_rule
from .gossip_grad import (
    INVALID_PEER,
    GossipGraDState,
    Topology,
    get_num_modules,
    gossip_grad_hook,
)
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
    "Topology",
    "GossipGraDState",
    "gossip_grad_hook",
    "get_num_modules",
    "INVALID_PEER",
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
