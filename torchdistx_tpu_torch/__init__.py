"""torchdistx_tpu_torch — the PyTorch/CUDA port of ``torchdistx_tpu``.

It grows slice by slice beside the JAX package, which stays the reference
the port is held against.  It imports ``torch`` and never JAX or the JAX
package.  The kernels that the JAX package wrote in Pallas for the TPU are
hand-written CUDA for Hopper here (``csrc/``), built with ``nvcc`` at their
first launch, never at import.  Entry points run on ``"cuda"`` unless the
caller asks for the CPU, where every kernel's plain PyTorch version runs.

Serving: ``Llama.from_name`` -> ``ServeEngine(model, ...)`` ->
``engine.run(requests)``; ``serve.ServeFleet([engines...])`` routes over
replicas (prefix affinity, drain and scale events, prefill/decode
disaggregation), ``serve.AutoscaleController`` scales it, and
``serve.generate(serve.scenario(name))`` makes open-loop traffic.
``obs`` holds the tracer, the Prometheus registry, the cost cards and the
capacity plan the engine admits against.  Training: ``deferred_init(Llama.from_name,
"llama_1b", device="cuda")`` -> ``materialize_module(model)`` ->
``Trainer(TrainStep(model, AnyPrecisionAdamW(...), loss_fn)).fit(batches,
n)``; GPT-2 the same way through ``examples.train_gpt2.main`` (param
groups, the token loader, and with ``fused_ce=True`` the fused LM-head
loss ``ops.fused_ce.fused_linear_cross_entropy``); T5 through
``utils.benchmarks.build_t5_train_workload`` (its relative-position bias
inside the flash kernels, materialized or as the bucket table).  Mistral
(``Llama.from_name("mistral_7b")``) runs its sliding window through the
windowed flash kernels; ``models.Mixtral`` puts ``nn.MoE`` in the FFN
slot, and ``nn.quantize_module`` stores weights as int8 for serving.

Parallel: ``parallel.init_multihost()`` (NCCL on the card, ``gloo`` when
asked for the CPU), ``parallel.create_mesh({"fsdp": ..., "sp": ...})``,
``materialize_module(model, sharding_rule=parallel.fsdp_shard_rule(mesh))``
and ``parallel.ShardedTrainStep``; Llama with ``sp_axis="sp"`` trains
sequence-parallel through the flash ring (``ops.attention.
ring_flash_attention``).  ``ShardedTrainStep(divergent_replicas=True)``
trains with ``parallel.gossip_grad_hook`` (GossipGraD) or
``slowmo.slowmo_hook`` and ``slowmo.SlowMomentumOptimizer`` (SlowMo).
"""

__version__ = "0.7.0.dev0"

from . import (
    data,
    examples,
    generation,
    interop,
    models,
    nn,
    obs,
    ops,
    optimizers,
    parallel,
    serve,
    slowmo,
)
from .deferred_init import (
    can_materialize,
    deferred_init,
    is_deferred,
    materialize_module,
    materialize_tensor,
)
from .fake import fake_mode, is_fake
from .generation import generate
from .optimizers import AnyPrecisionAdamW
from .trainer import Trainer, TrainStep
from .utils.rng import manual_seed

__all__ = [
    "__version__",
    "data",
    "examples",
    "generation",
    "interop",
    "models",
    "nn",
    "obs",
    "ops",
    "optimizers",
    "parallel",
    "serve",
    "slowmo",
    "generate",
    "manual_seed",
    "fake_mode",
    "is_fake",
    "deferred_init",
    "is_deferred",
    "can_materialize",
    "materialize_tensor",
    "materialize_module",
    "Trainer",
    "TrainStep",
    "AnyPrecisionAdamW",
]
