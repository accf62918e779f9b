"""torchdistx_tpu_torch — the PyTorch/CUDA port of ``torchdistx_tpu``.

It grows slice by slice beside the JAX package, which stays the reference
the port is held against.  It imports ``torch`` and never JAX or the JAX
package.  The kernels that the JAX package wrote in Pallas for the TPU are
hand-written CUDA for Hopper here (``csrc/``), built with ``nvcc`` at their
first launch, never at import.  Entry points run on ``"cuda"`` unless the
caller asks for the CPU, where every kernel's plain PyTorch version runs.

This slice serves Llama through ``serve.ServeEngine``: ``Llama.from_name``
-> ``ServeEngine(model, ...)`` -> ``engine.run(requests)``.
"""

__version__ = "0.5.0.dev0"

from . import generation, interop, models, nn, ops, serve
from .generation import generate
from .utils.rng import manual_seed

__all__ = [
    "__version__",
    "generation",
    "interop",
    "models",
    "nn",
    "ops",
    "serve",
    "generate",
    "manual_seed",
]
