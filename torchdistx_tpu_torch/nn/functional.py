"""Functional ops for module forwards (the subset Llama needs), counterpart
of ``torchdistx_tpu/nn/functional.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as _F

__all__ = ["silu", "rms_norm", "embedding", "linear", "cross_entropy"]


def silu(x):
    return _F.silu(x)


def rms_norm(x, weight=None, eps: float = 1e-6):
    """The statistic in f32, cast back to the input dtype, THEN the weight
    multiply in that dtype — the JAX package's order.  (``torch.nn.RMSNorm``
    multiplies before the cast, which rounds differently in bf16.)"""
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    y = y.to(dt)
    if weight is not None:
        y = y * weight
    return y


def embedding(ids, table):
    return _F.embedding(ids, table)


def linear(x, weight, bias=None):
    # weight layout (out_features, in_features), as in the JAX package
    return _F.linear(x, weight, bias)


def cross_entropy(logits, labels, dim: int = -1):
    """Mean token cross-entropy: f32 log-softmax over ``dim``, then the mean
    negative log-likelihood of the integer ``labels``."""
    logp = torch.log_softmax(logits.float(), dim=dim)
    nll = -torch.gather(logp, dim, labels.long().unsqueeze(dim)).squeeze(dim)
    return nll.mean()
