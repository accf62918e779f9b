"""The slow-momentum optimizer wrapper (arXiv:1910.00643), counterpart of
``torchdistx_tpu/slowmo/slowmo_optimizer.py``.

The JAX module is an optax transformation with its state in a pytree;
here it wraps a ``torch.optim`` optimizer and updates the parameters in
place.  ``step()`` runs the base optimizer's step, then every
``slowmo_freq`` steps the slow update of JAX's ``slow_branch``, in its
order of operations and the parameters' dtype:

    avg  = average_fn(params)
    v    = slowmo_factor * v + (prev - avg) / base_lr
    prev = prev - slowmo_lr * base_lr * v
    params := prev

as ``torch._foreach_*`` ops over all parameters at once.  ``prev`` and
``v`` are born at the first step (``prev`` the parameters before it, ``v``
zeros), in the parameters' dtype, so a ``ShardedTrainStep`` made after the
optimizer, which cuts the parameters to their shards, and
``stack_replicas`` are seen.  The JAX step applies the result as ``p +
(new - p)``; the port copies it, so the two agree to rounding, not bit for
bit.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional

import torch

from ..parallel import collectives

__all__ = ["slow_momentum", "SlowMomentumOptimizer", "replica_mean"]


def replica_mean(tensors: list, axis: str = "node") -> list:
    """The mean of ``tensors`` over the divergent step's replica axis of the
    active mesh (``"node"``, as ``hierarchical_mesh`` names it); raises
    with no mesh bound."""
    return collectives.all_mean(tensors, axis)


class SlowMomentumOptimizer:
    """``base_optimizer`` with slow momentum.  ``base_lr`` is the base
    optimizer's learning rate, which the slow update's ``(prev - avg) /
    base_lr`` rescales by.  Has ``param_groups``, ``zero_grad`` and
    ``step`` for :class:`~torchdistx_tpu_torch.Trainer` and
    ``ShardedTrainStep``, and ``state_dict`` / ``load_state_dict``."""

    def __init__(
        self,
        base_optimizer: torch.optim.Optimizer,
        *,
        slowmo_freq: int = 48,
        slowmo_factor: float = 0.5,
        slowmo_lr: float = 1.0,
        base_lr: float = 1e-3,
        average_fn: Callable[[list], list] = replica_mean,
    ) -> None:
        self.base_optimizer = base_optimizer
        self.average_fn = average_fn
        self._configure(slowmo_freq, slowmo_factor, slowmo_lr, base_lr)
        self.count = 0
        self.prev_params: Optional[list] = None
        self.slow_momentum: Optional[list] = None

    def _configure(self, freq: int, factor: float, lr: float, base_lr: float) -> None:
        if freq < 1:
            raise ValueError("slowmo_freq must be at least 1")
        self.slowmo_freq = freq
        self.slowmo_factor = factor
        self.slowmo_lr = lr
        self.base_lr = base_lr

    @property
    def param_groups(self) -> list:
        return self.base_optimizer.param_groups

    def _params(self) -> list:
        return [p for group in self.param_groups for p in group["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.base_optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, closure=None):
        params = self._params()
        if self.prev_params is None:
            self.prev_params = [p.detach().clone() for p in params]
            self.slow_momentum = [torch.zeros_like(p) for p in params]
        loss = self.base_optimizer.step(closure)
        self.count += 1
        if self.count % self.slowmo_freq == 0:
            self._slow_update(params)
        return loss

    def _slow_update(self, params: list) -> None:
        prev, mom = self.prev_params, self.slow_momentum
        avg = self.average_fn(params)
        drift = torch._foreach_sub(prev, avg)
        torch._foreach_div_(drift, self.base_lr)
        torch._foreach_mul_(mom, self.slowmo_factor)
        torch._foreach_add_(mom, drift)
        torch._foreach_sub_(prev, torch._foreach_mul(mom, self.slowmo_lr * self.base_lr))
        torch._foreach_copy_(params, prev)

    def state_dict(self) -> dict:
        """A snapshot: the tensors are copies, the base optimizer's too."""

        def copies(ts):
            return None if ts is None else [t.clone() for t in ts]

        return {
            "slowmo_freq": self.slowmo_freq,
            "slowmo_factor": self.slowmo_factor,
            "slowmo_lr": self.slowmo_lr,
            "base_lr": self.base_lr,
            "state": {
                "count": self.count,
                "base_state": copy.deepcopy(self.base_optimizer.state_dict()),
                "prev_params": copies(self.prev_params),
                "slow_momentum": copies(self.slow_momentum),
            },
        }

    def load_state_dict(self, sd: dict) -> None:
        self._configure(sd["slowmo_freq"], sd["slowmo_factor"], sd["slowmo_lr"],
                        sd["base_lr"])
        st = sd["state"]
        self.count = int(st["count"])
        self.base_optimizer.load_state_dict(st["base_state"])
        params = self._params()

        def placed(ts):
            if ts is None:
                return None
            return [t.detach().to(device=p.device, dtype=p.dtype, copy=True)
                    for t, p in zip(ts, params)]

        self.prev_params = placed(st["prev_params"])
        self.slow_momentum = placed(st["slow_momentum"])


def slow_momentum(base_optimizer: torch.optim.Optimizer, **kwargs: Any) -> SlowMomentumOptimizer:
    """``SlowMomentumOptimizer(base_optimizer, **kwargs)``: the JAX package's
    factory name (there an optax transformation)."""
    return SlowMomentumOptimizer(base_optimizer, **kwargs)
