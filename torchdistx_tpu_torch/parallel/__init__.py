"""The parallel stack on ``torch.distributed``, counterpart of
``torchdistx_tpu/parallel``: process groups (``multihost``), meshes of
ranks with one process group per axis (``mesh``), collectives over mesh
axes (``collectives``), gradient comm hooks (``comm_hooks``, and
GossipGraD's in ``gossip_grad``; SlowMo's is in ``torchdistx_tpu_torch.
slowmo``), the FSDP-style sharded train step (``fsdp``, with divergent
replicas), sharding plans with ZeRO-2 (``plan``), tensor and expert
parallelism (``tp``), pipeline parallelism (``pp``) and moving live state
between meshes (``reshard``, behind ``Trainer.reshard``).

NCCL on the card, ``gloo`` when the caller asks for the CPU (or for
several ranks on one card).
"""

from . import collectives
from .comm_hooks import DefaultState, HookContext, allreduce_hook, noop_hook
from .fsdp import (
    ShardedTrainStep,
    donated_carry_shardings,
    fsdp_partition_spec,
    fsdp_shard_rule,
    optimizer_state_shardings,
)
from .gossip_grad import (
    INVALID_PEER,
    GossipGraDState,
    Topology,
    get_num_modules,
    gossip_grad_hook,
)
from .mesh import (
    AbstractMesh,
    Mesh,
    NamedSharding,
    create_mesh,
    hierarchical_mesh,
    mesh_sharding,
    replicated,
)
from .multihost import init_multihost, is_multihost, process_count, process_index
from .plan import PlanError, ShardingPlan, derive_optimizer_state_shardings, tree_path_str
from .pp import pipeline_apply, pipeline_train_step, split_microbatches, stack_pipeline_stages
from .reshard import (
    can_reshard_live,
    devices_hold_full_copy,
    plan_reshard,
    plan_transition_wire_bytes,
    reshard,
    reshard_to_plan,
    reshard_via_checkpoint,
    reshard_wire_bytes,
    split_counts,
)
from .tp import GSPMDTrainStep, llama_tp_plan, llama_tp_rule, shard_params, tp_shard_rule

__all__ = [
    "collectives",
    "DefaultState",
    "HookContext",
    "allreduce_hook",
    "noop_hook",
    "ShardedTrainStep",
    "fsdp_partition_spec",
    "fsdp_shard_rule",
    "donated_carry_shardings",
    "optimizer_state_shardings",
    "PlanError",
    "ShardingPlan",
    "derive_optimizer_state_shardings",
    "tree_path_str",
    "GSPMDTrainStep",
    "tp_shard_rule",
    "llama_tp_plan",
    "llama_tp_rule",
    "shard_params",
    "Topology",
    "GossipGraDState",
    "gossip_grad_hook",
    "get_num_modules",
    "INVALID_PEER",
    "AbstractMesh",
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
    "stack_pipeline_stages",
    "split_microbatches",
    "pipeline_apply",
    "pipeline_train_step",
    "plan_reshard",
    "plan_transition_wire_bytes",
    "split_counts",
    "reshard",
    "reshard_to_plan",
    "reshard_wire_bytes",
    "devices_hold_full_copy",
    "can_reshard_live",
    "reshard_via_checkpoint",
]
