"""torchdistx_tpu_torch — the PyTorch/CUDA port of ``torchdistx_tpu``.

It grows slice by slice beside the JAX package, which stays the reference
the port is held against.  It imports ``torch`` and never JAX or the JAX
package.  The kernels that the JAX package wrote in Pallas for the TPU are
hand-written CUDA for Hopper here (``csrc/``), built with ``nvcc`` at their
first launch, never at import.  Entry points run on ``"cuda"`` unless the
caller asks for the CPU, where every kernel's plain PyTorch version runs.

Serving: ``Llama.from_name`` -> ``ServeEngine(model, ...)`` ->
``engine.run(requests)``.  Training: ``deferred_init(Llama.from_name,
"llama_1b", device="cuda")`` -> ``materialize_module(model)`` ->
``Trainer(TrainStep(model, AnyPrecisionAdamW(...), loss_fn)).fit(batches,
n)``; GPT-2 the same way through ``examples.train_gpt2.main`` (param
groups, the token loader, and with ``fused_ce=True`` the fused LM-head
loss ``ops.fused_ce.fused_linear_cross_entropy``).
"""

__version__ = "0.5.0.dev0"

from . import data, examples, generation, interop, models, nn, ops, optimizers, serve
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
    "ops",
    "optimizers",
    "serve",
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
