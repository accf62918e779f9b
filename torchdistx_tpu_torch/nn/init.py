"""Parameter initializers (the subset Llama needs), counterpart of
``torchdistx_tpu/nn/init.py``.  Each random draw takes the next generator
of the counter-keyed stream (``utils/rng.py``) and fills the tensor on its
own device, so an 8B model is initialized where it will run."""

from __future__ import annotations

import torch

from ..utils.rng import next_generator

__all__ = ["ones", "normal"]


def ones(shape, dtype=torch.float32, device="cuda"):
    return torch.ones(shape, dtype=dtype, device=device)


def normal(shape, std=1.0, mean=0.0, dtype=torch.float32, device="cuda"):
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(mean, std, generator=next_generator(device))
