"""FSDP-style sharded training with a gradient comm-hook point, counterpart
of ``torchdistx_tpu/parallel/fsdp.py`` (``fsdp_partition_spec``,
``fsdp_shard_rule``, ``ShardedTrainStep``).

Each rank holds its shard of every parameter as the module's own
``nn.Parameter`` (what ``materialize_module(sharding_rule=
fsdp_shard_rule(mesh))`` produces, or ``ShardedTrainStep`` cuts in place
from full parameters).  A step mirrors the JAX ``shard_map`` step:

1. slice this rank's piece of the global batch by ``batch_spec`` (the
   ``in_specs`` of ``shard_map``);
2. all-gather every sharded parameter over ``shard_axis`` through an
   autograd function whose backward is the reduce-scatter of the gradient
   divided by the shard count (a replicated parameter's backward is the
   mean over ``shard_axis``), and run ``loss_fn`` on the full parameters
   through ``torch.func.functional_call``;
3. take the mean of the gradient shards over every batch axis that is
   neither a replica axis (the hook's) nor the shard axis: under sequence
   parallelism the gradient of a parameter is the mean over ``sp`` of the
   per-shard gradients;
4. hand the shards to the comm hook (``allreduce_hook``: the mean over the
   replica axes);
5. step the torch optimizer on the shards, so its state is born sharded.

The loss returned is the mean over every mesh axis.  ``accum_steps``
splits the local batch into microbatches whose gradients add up in the
shards' ``.grad``; the parameters are gathered once per microbatch, not
once per step as in the JAX step.

``divergent_replicas=True`` is for hooks whose replicas' parameters
legitimately differ between synchronizations (GossipGraD, SlowMo).  The
JAX step gives each parameter a leading per-replica dimension sharded over
the (single) replica axis; here each rank already owns its own
parameters, so a rank's parameters are its node's replica and nothing is
stacked.  ``stack_replicas()`` broadcasts every parameter (or shard) from
node index 0 over the replica axis, so all replicas start from the same
weights; ``consensus()`` returns every parameter gathered over the shard
axis and averaged over the replica axis.  Not ported yet: the numerics
taps, the declarative ``plan``, and the donated-carry and optimizer-state
sharding helpers, which have no eager counterpart.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn

from ..trainer import TrainStep
from . import collectives
from .comm_hooks import DefaultState, HookContext, allreduce_hook
from .mesh import Mesh, NamedSharding, mark_sharded, sharding_of

__all__ = ["fsdp_partition_spec", "fsdp_shard_rule", "ShardedTrainStep"]


def fsdp_partition_spec(shape: Sequence[int], mesh: Mesh, axis: str,
                        min_shard_elems: int = 1024) -> tuple:
    """Shard the first dim divisible by the axis size; else replicate.
    Tensors under ``min_shard_elems`` elements stay replicated."""
    n = mesh.shape[axis]
    size = math.prod(shape) if len(shape) else 0
    if size >= min_shard_elems:
        for d, s in enumerate(shape):
            if s % n == 0 and s >= n:
                spec = [None] * len(shape)
                spec[d] = axis
                return tuple(spec)
    return ()


def fsdp_shard_rule(mesh: Mesh, axis: str = "fsdp",
                    min_shard_elems: int = 1024) -> Callable[[str, Any], NamedSharding]:
    """A ``materialize_module`` sharding rule: parameters are born FSDP
    sharded."""

    def rule(path: str, like: Any) -> NamedSharding:
        return NamedSharding(mesh, fsdp_partition_spec(tuple(like.shape), mesh, axis,
                                                       min_shard_elems))

    return rule


class _GatherShard(torch.autograd.Function):
    """All-gather along ``dim``; backward: reduce-scatter / shard count."""

    @staticmethod
    def forward(ctx, shard, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return collectives._gather(shard, ax, dim)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        if ax.size == 1:
            return g, None, None
        return collectives._reduce_scatter(g, ax, ctx.dim) / ax.size, None, None


class _MeanGrad(torch.autograd.Function):
    """Identity; backward: the mean over the shard axis (a replicated
    parameter's gradient, ``lax.pmean`` in the JAX step)."""

    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x

    @staticmethod
    def backward(ctx, g):
        return collectives.all_mean(g, ctx.ax), None


class _Loss(nn.Module):
    def __init__(self, model, loss_fn):
        super().__init__()
        self.model = model
        self.loss_fn = loss_fn

    def forward(self, batch):
        return self.loss_fn(self.model, batch)


def _spec_axes(spec) -> list:
    axes = []
    for entry in spec:
        if entry:
            axes.extend(entry if isinstance(entry, tuple) else (entry,))
    return axes


class ShardedTrainStep(TrainStep):
    """``step(model, optimizer, batch) -> (model, optimizer, loss)`` over a
    mesh.  ``loss_fn(model, batch)`` as for :class:`TrainStep`; ``batch``
    is the global batch, the same on every rank.

    Args as the JAX dataclass's: ``shard_axis`` (None: replicated
    parameters), ``replica_axes`` (the hook's), ``comm_hook`` and
    ``hook_state``, ``batch_axes`` (default ``replica_axes + (shard_axis,)``,
    sharding dim 0 of every batch tensor) or a full ``batch_spec`` such as
    ``(None, "sp")`` for tokens sharded over the sequence, and
    ``accum_steps``, and ``divergent_replicas`` (exactly one replica axis;
    see :meth:`stack_replicas` and :meth:`consensus`).  Full parameters in
    ``model`` are cut to their shards in place (``param.data``), so an
    optimizer made before keeps them."""

    def __init__(self, model: nn.Module, optimizer, loss_fn: Callable, mesh: Mesh, *,
                 shard_axis: Optional[str] = "fsdp", replica_axes: tuple = (),
                 comm_hook: Callable = allreduce_hook,
                 hook_state: Optional[DefaultState] = None,
                 batch_axes: Optional[tuple] = None, batch_spec: Optional[tuple] = None,
                 accum_steps: int = 1, divergent_replicas: bool = False):
        super().__init__(model, optimizer, loss_fn)
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if divergent_replicas and len(replica_axes) != 1:
            raise ValueError("divergent_replicas requires exactly one replica axis")
        self.divergent_replicas = divergent_replicas
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.replica_axes = tuple(replica_axes)
        self.comm_hook = comm_hook
        self.hook_state = hook_state if hook_state is not None else DefaultState()
        if batch_axes is None:
            batch_axes = self.replica_axes + ((shard_axis,) if shard_axis else ())
        self.batch_axes = tuple(batch_axes)
        if batch_spec is None:
            batch_spec = (self.batch_axes,)
        self.batch_spec = tuple(e if e else None for e in batch_spec)
        self.accum_steps = int(accum_steps)
        self.grad_reduce_axes = tuple(dict.fromkeys(
            ax for ax in _spec_axes(self.batch_spec)
            if ax not in self.replica_axes and ax != shard_axis))
        self._wrapper = _Loss(model, loss_fn)
        self._params = self.shard_params()

    def param_spec(self, shape) -> tuple:
        if self.shard_axis is None:
            return ()
        return fsdp_partition_spec(tuple(shape), self.mesh, self.shard_axis)

    def shard_params(self) -> list:
        """Cut every full parameter of the model to this rank's shard (in
        place); check that every sharded one has this step's spec.
        Returns ``[(name, param, sharded dim or None)]``."""
        out = []
        for name, p in self.model.named_parameters():
            found = sharding_of(p)
            shape = found[1] if found else tuple(p.shape)
            spec = self.param_spec(shape)
            if found is None:
                sharding = NamedSharding(self.mesh, spec)
                with torch.no_grad():
                    p.data = p.data[sharding.shard_slices(shape)].clone()
                mark_sharded(p, sharding, shape)
            elif tuple(found[0].spec) != spec or found[0].mesh is not self.mesh:
                raise ValueError(f"{name} is sharded {found[0].spec}, this step wants {spec}")
            dim = spec.index(self.shard_axis) if self.shard_axis in spec else None
            out.append((name, p, dim))
        return out

    def local_batch(self, batch: Any) -> Any:
        """This rank's piece of the global batch, by ``batch_spec``."""
        sharding = NamedSharding(self.mesh, self.batch_spec)
        return collectives._map(lambda x: x[sharding.shard_slices(x.shape)], batch)

    def full_params(self) -> dict:
        """Every parameter gathered to its full shape (detached)."""
        with torch.no_grad():
            return {name: self._full(p, dim) for name, p, dim in self._params}

    def stack_replicas(self) -> nn.Module:
        """Every parameter (or shard) of node index 0 broadcast over the
        replica axis, in place: all replicas start from the same weights.
        Without ``divergent_replicas`` nothing changes.  Returns the
        model."""
        if self.divergent_replicas:
            with self.mesh, torch.no_grad():
                for _, p, _ in self._params:
                    p.copy_(collectives.broadcast(p.detach(), self.replica_axes[0]))
        return self.model

    def consensus(self) -> dict:
        """``{name: full tensor}``: every parameter gathered over the shard
        axis and averaged over the replica axis (the model is not
        written).  Without ``divergent_replicas``, a copy of
        :meth:`full_params`."""
        with self.mesh:
            full = self.full_params()
            if self.divergent_replicas:
                full = collectives.all_mean(full, self.replica_axes[0])
        # a parameter neither gathered nor averaged comes back as itself
        return {name: t.detach().clone() for name, t in full.items()}

    def _full(self, p, dim):
        if dim is not None:
            return _GatherShard.apply(p, self.mesh.axes[self.shard_axis], dim)
        if self.shard_axis is not None and p.requires_grad:
            return _MeanGrad.apply(p, self.mesh.axes[self.shard_axis])
        return p

    def __call__(self, params, opt_state, batch):
        opt_state.zero_grad(set_to_none=True)
        local = self.local_batch(batch)
        n = self.accum_steps
        micro = [collectives._map(lambda x, i=i: _chunks(x, n)[i], local) for i in range(n)]
        total = 0.0
        with self.mesh:
            for mb in micro:
                full = {f"model.{name}": self._full(p, dim) for name, p, dim in self._params}
                loss = torch.func.functional_call(self._wrapper, full, (mb,))
                (loss / self.accum_steps).backward()
                total = total + loss.detach() / self.accum_steps
            grads = {name: p.grad for name, p, _ in self._params if p.grad is not None}
            if self.grad_reduce_axes:
                grads = collectives.all_mean(grads, self.grad_reduce_axes)
            ctx = HookContext(replica_axes=self.replica_axes,
                              step=self.hook_state.step_args())
            grads = self.comm_hook(self.hook_state, grads, ctx)
            for name, p, _ in self._params:
                if name in grads:
                    p.grad = grads[name]
            opt_state.step()
            self.hook_state.advance()
            loss = collectives.all_mean(total, tuple(self.mesh.axes.values()))
        self.losses.append(loss)
        return params, opt_state, loss


def _chunks(x, n):
    if x.shape[0] % n:
        raise ValueError(f"batch leading dim {x.shape[0]} not divisible by accum_steps={n}")
    return x.chunk(n, 0)
