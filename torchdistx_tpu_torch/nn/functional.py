"""Functional ops for module forwards (the subset Llama, GPT-2 and T5 need),
counterpart of ``torchdistx_tpu/nn/functional.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as _F

__all__ = ["relu", "gelu", "silu", "layer_norm", "rms_norm", "embedding", "linear", "cross_entropy"]


def relu(x):
    return _F.relu(x)


def gelu(x, approximate: bool = True):
    """The JAX default is the tanh approximation (``jax.nn.gelu``);
    torch's default is erf, so the mode is always named."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x):
    return _F.silu(x)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """The JAX package's arithmetic: mean and (biased) variance taken in f32
    and rounded to x's dtype (``jnp.mean``/``jnp.var`` upcast bf16), then
    ``(x - mean) * rsqrt(var + eps)``, weight and bias in x's dtype.
    (``torch.nn.functional.layer_norm`` normalizes in f32 and rounds once,
    which differs in bf16.)"""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean.to(dt)) * torch.rsqrt(var.to(dt) + eps)
    if weight is not None:
        y = y * weight
    if bias is not None:
        y = y + bias
    return y


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
