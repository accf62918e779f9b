"""Core layers, counterpart of ``torchdistx_tpu/nn/layers.py``:
``torch.nn.Module``s whose parameters and buffers keep the JAX package's
names and layouts (``Linear.weight`` is (out, in), ``Conv2d.weight`` OIHW).

An initializer is ``fn(shape, dtype, device)``: the models pass their own
scheme (``weight_init``, ``bias_init``); without one, ``Linear`` takes the
JAX package's default (kaiming-uniform weight, uniform bias in
+-1/sqrt(in_features)), and ``Embedding`` its N(0, 1).

``Sequential``, ``ModuleList``, ``ReLU`` and ``SiLU`` are ``torch.nn``'s:
the same child names ("0", "1", ...) and the same function.  ``GELU`` is
the JAX package's, the tanh approximation.  ``BatchNorm2d`` keeps the JAX
semantics, not ``torch.nn.BatchNorm2d``'s: see its docstring."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import ModuleList, ReLU, Sequential, SiLU

from . import functional as F
from . import init

__all__ = ["Linear", "Embedding", "LayerNorm", "RMSNorm", "Dropout", "Sequential",
           "ModuleList", "Conv2d", "BatchNorm2d", "ReLU", "GELU", "SiLU"]


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
    def __init__(self, num_embeddings: int, features: int, *, weight_init=None,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        if weight_init is None:
            weight_init = lambda s, d, dev: init.normal(s, std=1.0, dtype=d,  # noqa: E731
                                                        device=dev)
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


class Dropout(nn.Module):
    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return F.dropout(x, self.rate, generator, training=self.training)


class Conv2d(nn.Module):
    """OIHW weight drawn kaiming-uniform; bias uniform in +-1/sqrt(fan_in),
    ``fan_in = (in_channels / groups) * kh * kw``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, dilation=1, groups: int = 1, bias: bool = True, *,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        kernel_size = F._pair(kernel_size)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups
        shape = (out_channels, in_channels // groups, *kernel_size)
        self.weight = nn.Parameter(init.kaiming_uniform(shape, dtype=dtype, device=device))
        if bias:
            bound = init.linear_bias_bound((in_channels // groups) * math.prod(kernel_size))
            self.bias = nn.Parameter(init.uniform((out_channels,), -bound, bound, dtype, device))
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation, groups=self.groups)


class BatchNorm2d(nn.Module):
    """Batch normalization over NCHW with the JAX package's semantics.

    In training mode it normalizes with the batch's mean and biased
    variance over (N, H, W), taken in f32 and rounded to x's dtype, and
    never updates ``running_mean`` / ``running_var``: ``momentum`` is kept
    and unused (the JAX module leaves the running statistics to the
    trainer).  In eval mode it uses the two buffers.  Then ``inv =
    rsqrt(var + eps) * weight`` and ``(x - mean) * inv + bias``, each op
    rounded to x's dtype."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1,
                 dtype=torch.float32, device="cuda"):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(init.ones((features,), dtype, device))
        self.bias = nn.Parameter(init.zeros((features,), dtype, device))
        self.register_buffer("running_mean", init.zeros((features,), dtype, device))
        self.register_buffer("running_var", init.ones((features,), dtype, device))

    def forward(self, x):
        if self.training:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = (xf - mean.reshape(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
            mean, var = mean.to(x.dtype), var.to(x.dtype)
        else:
            mean, var = self.running_mean, self.running_var
        # the root in f32, rounded once (the CPU's bf16 rsqrt rounds twice)
        inv = torch.rsqrt((var + self.eps).float()).to(x.dtype) * self.weight
        return ((x - mean.reshape(1, -1, 1, 1)) * inv.reshape(1, -1, 1, 1)
                + self.bias.reshape(1, -1, 1, 1))


class GELU(nn.Module):
    """The JAX package's ``GELU``: the tanh approximation."""

    def forward(self, x):
        return F.gelu(x)
