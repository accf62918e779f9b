"""Deferred-init a model, quantize its weights to int8 and generate with a
KV cache: the port's counterpart of ``examples/quantized_inference.py``.
Decode reads every weight once a token, so int8 weights halve the bytes
bf16 moves.  The LM head stays in full precision (the last layer's logits
are the most sensitive to quantization).

On the card: ``python -m torchdistx_tpu_torch.examples.quantized_inference``
(bf16, ``TDX_GEN_MODEL`` default ``llama_1b``); on the CPU:
``TDX_PLATFORM=cpu TDX_GEN_MODEL=tiny python -m
torchdistx_tpu_torch.examples.quantized_inference`` (f32).  From Python:
``main(name, device=)``.
"""

from __future__ import annotations

import os
import time
from typing import Mapping, Optional

import numpy as np
import torch

__all__ = ["main", "param_bytes"]


def param_bytes(m: torch.nn.Module) -> int:
    """Bytes of the module's parameters and buffers (int8 codes and their
    scales included)."""
    return sum(t.numel() * t.element_size()
               for t in list(m.parameters()) + list(m.buffers()))


def _keep_head(path, mod):
    return "lm_head" not in path


def main(name: str = "llama_1b", *, device="cuda", dtype: Optional[torch.dtype] = None,
         prompt_len: int = 32, max_new_tokens: int = 64,
         params: Optional[Mapping[str, np.ndarray]] = None, log_fn=print) -> dict:
    """Materialize ``name`` on ``device`` (``dtype``: bf16 on the card, f32
    elsewhere; ``params``: start weights by name, numpy arrays such as the
    JAX package's, loaded over the seeded init), quantize every ``Linear``
    but ``lm_head`` to int8, and
    greedily generate ``max_new_tokens`` after a ``prompt_len``-token prompt
    (``RandomState(0)`` below 256, as the JAX example draws it).  Returns
    ``{"n_params", "bytes_before", "bytes_after", "n_quantized", "tokens",
    "generate_s", "model"}``."""
    from .. import deferred_init, manual_seed, materialize_module
    from ..generation import generate
    from ..interop import load_jax_params
    from ..models import Llama
    from ..nn import QuantizedLinear, quantize_module

    device = torch.device(device)
    if dtype is None:
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32

    # 1. storage-less construction, then materialization on the device
    manual_seed(0)
    model = deferred_init(Llama.from_name, name, dtype=dtype, device=device)
    materialize_module(model)
    if params is not None:
        load_jax_params(model, params)
    model.requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    before = param_bytes(model)
    log_fn(f"{name}: {n_params:,} params, {before / 1e9:.2f} GB")

    # 2. weight-only int8, the head kept in full precision
    quantize_module(model, filter_fn=_keep_head)
    n_q = sum(isinstance(mod, QuantizedLinear) for _, mod in model.named_modules())
    after = param_bytes(model)
    log_fn(f"quantized {n_q} Linear layers -> {after / 1e9:.2f} GB")

    # 3. generate
    prompt = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (1, prompt_len))).to(device)
    t0 = time.perf_counter()
    out = generate(model, prompt, max_new_tokens=max_new_tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    generate_s = time.perf_counter() - t0
    tokens = out[0, -max_new_tokens:].tolist()
    log_fn(f"generated: {tokens[:16]} ...")
    return {"n_params": int(n_params), "bytes_before": int(before), "bytes_after": int(after),
            "n_quantized": int(n_q), "tokens": tokens, "generate_s": generate_s,
            "model": model}


if __name__ == "__main__":
    main(os.environ.get("TDX_GEN_MODEL", "llama_1b"),
         device="cpu" if os.environ.get("TDX_PLATFORM") == "cpu" else "cuda")
