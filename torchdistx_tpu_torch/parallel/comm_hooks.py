"""Gradient communication hooks, counterpart of
``torchdistx_tpu/parallel/comm_hooks.py``.

The reference plugs into FSDP's ``register_comm_hook(state, hook)``; here
the hook point is the port's own :class:`~.fsdp.ShardedTrainStep`: after
the local gradients are reduce-scattered over the shard axis, the hook
decides how they are synchronized across the data-parallel axes.

A hook is ``hook(state, grads, ctx) -> grads``: ``state`` its state object
(an iteration counter, a topology), ``grads`` a dict of this rank's
gradient shards, ``ctx`` a :class:`HookContext` naming the mesh axes it
may reduce over.  PyTorch runs eagerly, so the state lives on the host and
the step calls ``state.advance()`` once per step, as the JAX trainer does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from . import collectives

__all__ = ["HookContext", "DefaultState", "allreduce_hook", "noop_hook"]


@dataclasses.dataclass(frozen=True)
class HookContext:
    """Axes available to a hook inside the sharded step."""

    replica_axes: tuple  # axes over which grads must be synced
    step: Any = None  # per-step values from state.step_args()


class DefaultState:
    """Base hook state: a host-side iteration counter (FSDP
    ``default.DefaultState`` as the reference extends it)."""

    def __init__(self) -> None:
        self.iteration = 0

    def advance(self) -> None:
        self.iteration += 1

    def step_args(self) -> Any:
        """Per-step values handed to the hook in ``HookContext.step``."""
        return None


def allreduce_hook(state: DefaultState, grads: Any, ctx: HookContext) -> Any:
    """Mean of the gradients over every replica axis (FSDP's default
    ``allreduce_hook``)."""
    for axis in ctx.replica_axes:
        grads = collectives.all_mean(grads, axis)
    return grads


def noop_hook(state: DefaultState, grads: Any, ctx: HookContext) -> Any:
    """No synchronization (local SGD between averaging steps)."""
    return grads


Hook = Callable[[Any, Any, HookContext], Any]
