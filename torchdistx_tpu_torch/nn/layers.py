"""Core layers (the subset Llama and GPT-2 need), counterpart of
``torchdistx_tpu/nn/layers.py``: ``torch.nn.Module``s whose parameters keep
the JAX package's names and layouts (``Linear.weight`` is (out, in)).

An initializer is ``fn(shape, dtype, device)``: the models pass their own
scheme (``weight_init``, ``bias_init``); without one, ``Linear`` takes the
JAX package's default (kaiming-uniform weight, uniform bias in
+-1/sqrt(in_features))."""

from __future__ import annotations

import torch
from torch import nn

from . import functional as F
from . import init

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm"]


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 *, weight_init=None, bias_init=None, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        if weight_init is None:
            weight_init = lambda s, d, dev: init.kaiming_uniform(  # noqa: E731
                s, dtype=d, device=dev)
        self.weight = nn.Parameter(
            weight_init((out_features, in_features), dtype, device)
        )
        if bias:
            if bias_init is None:
                bound = init.linear_bias_bound(in_features)
                bias_init = lambda s, d, dev: init.uniform(  # noqa: E731
                    s, -bound, bound, d, dev)
            self.bias = nn.Parameter(bias_init((out_features,), dtype, device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings: int, features: int, *, weight_init,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.weight = nn.Parameter(
            weight_init((num_embeddings, features), dtype, device)
        )

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class LayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(init.ones((features,), dtype, device))
        self.bias = nn.Parameter(init.zeros((features,), dtype, device))

    def forward(self, x):
        return F.layer_norm(x, self.weight, self.bias, self.eps)


class RMSNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-6, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(init.ones((features,), dtype, device))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.eps)
