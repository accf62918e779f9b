"""Functional ops for module forwards, counterpart of
``torchdistx_tpu/nn/functional.py``.  Convolutions are NCHW with OIHW
weights, as in the JAX package; ``dropout`` takes a ``torch.Generator``
where the JAX function takes a key."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as _F

__all__ = ["relu", "gelu", "silu", "softmax", "log_softmax", "dropout", "layer_norm",
           "rms_norm", "embedding", "linear", "conv2d", "max_pool2d", "avg_pool2d",
           "cross_entropy"]


def relu(x):
    return _F.relu(x)


def gelu(x, approximate: bool = True):
    """The JAX default is the tanh approximation (``jax.nn.gelu``);
    torch's default is erf, so the mode is always named."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def silu(x):
    return _F.silu(x)


def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


def dropout(x, rate: float, generator: Optional[torch.Generator] = None,
            training: bool = True):
    """Each element kept with probability ``1 - rate`` and scaled by its
    inverse, else 0.  With no generator, a rate of 0 or ``training=False``
    the input comes back unchanged (the JAX function with no key)."""
    if not training or rate <= 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


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


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _spatial_pads(padding, leading: int = 0):
    """``((top, bottom), (left, right))`` of an int, an ``(h, w)`` pair or
    per-side pairs; ``leading`` more pairs may come first (the pools' N and
    C), and must be zero."""
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    padding = tuple(padding)
    if len(padding) == 2 and all(isinstance(p, int) for p in padding):
        return (padding[0], padding[0]), (padding[1], padding[1])
    pads = tuple(tuple(p) for p in padding)
    if len(pads) not in (2, 2 + leading) or any(p != (0, 0) for p in pads[:-2]):
        raise ValueError(f"padding {padding!r}: an int, (h, w), or (lo, hi) pairs "
                         "of the two spatial dims")
    return pads[-2], pads[-1]


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups: int = 1):
    """NCHW x OIHW convolution.  ``padding``: an int, an ``(h, w)`` pair or
    ``((top, bottom), (left, right))``; an asymmetric one is applied with
    ``F.pad`` before a convolution without padding (``F.conv2d`` pads both
    sides alike).  The bias is added after the convolution, as in the JAX
    package."""
    (top, bottom), (left, right) = _spatial_pads(padding)
    if top == bottom and left == right:
        pad = (top, left)
    else:
        x = _F.pad(x, (left, right, top, bottom))
        pad = 0
    y = _F.conv2d(x, weight, None, _pair(stride), pad, _pair(dilation), groups)
    if bias is not None:
        y = y + bias.reshape(1, -1, 1, 1)
    return y


def _pool2d(x, window, stride, padding, pad_value, pool):
    window = _pair(window)
    stride = window if stride is None else _pair(stride)
    (top, bottom), (left, right) = _spatial_pads(padding, leading=2)
    if top or bottom or left or right:
        x = _F.pad(x, (left, right, top, bottom), value=pad_value)
    return pool(x, window, stride)


def max_pool2d(x, window, stride=None, padding=0):
    """Max over each window; the padding is -inf."""
    return _pool2d(x, window, stride, padding, float("-inf"), _F.max_pool2d)


def avg_pool2d(x, window, stride=None, padding=0):
    """Sum over each window divided by the window's size, at the edges too:
    the padding is zeros and counts (``count_include_pad``)."""
    return _pool2d(x, window, stride, padding, 0.0, _F.avg_pool2d)


def cross_entropy(logits, labels, dim: int = -1):
    """Mean token cross-entropy: f32 log-softmax over ``dim``, then the mean
    negative log-likelihood of the integer ``labels``."""
    logp = torch.log_softmax(logits.float(), dim=dim)
    nll = -torch.gather(logp, dim, labels.long().unsqueeze(dim)).squeeze(dim)
    return nll.mean()
