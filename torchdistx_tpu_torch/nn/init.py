"""Parameter initializers, counterpart of ``torchdistx_tpu/nn/init.py``.

Each random draw takes the next generator of the counter-keyed stream
(``utils/rng.py``) and fills the tensor on its own device, so a model is
initialized where it will run; under ``deferred_init`` the same calls are
recorded and replayed there.  The Kaiming/Xavier math is the JAX
package's (torch's ``(out, in, *receptive)`` fan convention)."""

from __future__ import annotations

import math

import torch

from ..utils.rng import next_generator

__all__ = [
    "zeros",
    "ones",
    "constant",
    "normal",
    "uniform",
    "xavier_uniform",
    "xavier_normal",
    "kaiming_uniform",
    "kaiming_normal",
    "truncated_normal",
    "linear_bias_bound",
]


def zeros(shape, dtype=torch.float32, device="cuda"):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones(shape, dtype=torch.float32, device="cuda"):
    return torch.ones(shape, dtype=dtype, device=device)


def constant(shape, value, dtype=torch.float32, device="cuda"):
    return torch.full(shape, value, dtype=dtype, device=device)


def normal(shape, std=1.0, mean=0.0, dtype=torch.float32, device="cuda"):
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.normal_(mean, std, generator=next_generator(device))


def uniform(shape, low=0.0, high=1.0, dtype=torch.float32, device="cuda"):
    out = torch.empty(shape, dtype=dtype, device=device)
    return out.uniform_(low, high, generator=next_generator(device))


def _fan(shape) -> tuple:
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def xavier_uniform(shape, gain=1.0, dtype=torch.float32, device="cuda"):
    fan_in, fan_out = _fan(shape)
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(shape, -bound, bound, dtype, device)


def xavier_normal(shape, gain=1.0, dtype=torch.float32, device="cuda"):
    fan_in, fan_out = _fan(shape)
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return normal(shape, std=std, dtype=dtype, device=device)


def kaiming_uniform(shape, a=math.sqrt(5), dtype=torch.float32, device="cuda"):
    fan_in, _ = _fan(shape)
    bound = math.sqrt(2.0 / (1 + a * a)) * math.sqrt(3.0 / fan_in)
    return uniform(shape, -bound, bound, dtype, device)


def kaiming_normal(shape, a=0.0, dtype=torch.float32, device="cuda"):
    fan_in, _ = _fan(shape)
    std = math.sqrt(2.0 / (1 + a * a)) / math.sqrt(fan_in)
    return normal(shape, std=std, dtype=dtype, device=device)


def truncated_normal(shape, std=1.0, dtype=torch.float32, device="cuda"):
    """N(0, 1) cut to [-2, 2], then scaled by ``std`` (the JAX package's
    order)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                generator=next_generator(device))
    return out.mul_(std) if std != 1.0 else out


def linear_bias_bound(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
