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
   mean over ``shard_axis``), and run ``loss_fn`` with the full parameters
   in the model's place (``swapped_parameters``, through the backward, so
   a rematerialized block recomputes from them too);
3. take the mean of the gradient shards over every batch axis that is
   neither a replica axis (the hook's) nor the shard axis: under sequence
   parallelism the gradient of a parameter is the mean over ``sp`` of the
   per-shard gradients;
4. hand the shards to the comm hook (``allreduce_hook``: the mean over the
   replica axes);
5. step the torch optimizer on the shards, so its state is born sharded.
   The 8-bit AdamW is placed (``AdamW8bit.place``) when the step is made:
   each rank holds its pieces of JAX's ``adam8bit_state_shardings``
   layout, over the whole parameter's blocks, and its update equals
   JAX's global-view update (``optimizers.quantized``).
   :meth:`ShardedTrainStep.init_optimizer` makes the state before the
   first step.

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
axis and averaged over the replica axis.

The JAX module's helpers of the compiled steps, in their eager form:
``accumulate_grads`` (microbatch gradients summed in f32) with
``strided_split`` and ``contiguous_split`` (the step's own microbatches);
``optimizer_state_shardings`` (each slot of a torch optimizer's state
that mirrors its parameter inherits the parameter's sharding; see
``parallel.plan``); ``donated_carry_shardings``, which in JAX pins a
donated jit carry to the layouts it arrived with.  Nothing is donated or
re-placed by an eager step, so here it only reports each tensor's
``sharding_of`` (or None, for a tensor no sharding marks).

``numerics=True`` (None: ``TDX_NUMERICS``) takes the JAX step's digests
(``obs.numerics``) into ``last_digests``: ``params/<group>`` and
``grads/<group>`` of the whole tensors (each rank digests the pieces it is
the first holder of and the partials are folded over the mesh:
``obs.numerics.mesh_group_digest``), ``act/<site>`` of the model's taps
over the rank's batch folded over the batch axes by
``obs.numerics.allreduce_digests`` (booked into the comm audit as the JAX
step books it: a ``psum`` of count 2 and a ``pmax``), and ``loss``.  The
integer fields are the same at any world size.

The comm audit (``obs.comm``) sees what the JAX step books when it traces:
per sharded parameter one ``all_gather`` and one ``reduce_scatter`` over
the shard axis (payload the full parameter's bytes), a ``pmean`` of each
replicated parameter's gradient over it, a ``pmean`` of the whole
gradient over each batch axis the step reduces, the hook's collectives
and a ``pmean`` of the loss over every mesh axis.  The step's own
collectives run muted, and it books a batch signature's first call only
(the JAX step's cached program records nothing); the later calls run
under ``obs.comm.muted``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn

from ..obs.comm import muted, record_collective
from ..obs.numerics import (
    allreduce_digests,
    array_digest,
    mesh_group_digest,
    numerics_tape,
)
from ..trainer import TrainStep
from . import collectives
from .comm_hooks import DefaultState, HookContext, allreduce_hook
from .mesh import Mesh, NamedSharding, mark_sharded, sharding_of

__all__ = [
    "fsdp_partition_spec",
    "fsdp_shard_rule",
    "donated_carry_shardings",
    "optimizer_state_shardings",
    "accumulate_grads",
    "strided_split",
    "contiguous_split",
    "ShardedTrainStep",
]


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


def donated_carry_shardings(*trees: Any) -> tuple:
    """Per tree, each tensor's :func:`~.mesh.sharding_of` sharding (None
    where no sharding marks it), in the tree's structure.  The JAX
    function pins a donated jit carry to its arrival layouts; an eager step
    donates nothing and never re-places a tensor, so this only reports
    them."""

    def one(t):
        found = sharding_of(t)
        return found[0] if found else None

    return tuple(collectives._map(one, tree) for tree in trees)


def optimizer_state_shardings(state: Any, params: Any, mesh: Mesh) -> dict:
    """Shardings of a torch optimizer's state: each slot tensor shaped
    like its parameter's piece inherits the parameter's
    :func:`~.mesh.sharding_of` sharding; every other leaf (step counts,
    differently shaped slots) is replicated.  ``state`` is the optimizer
    or its state keyed by parameter name, ``params`` a module or
    ``{name: tensor}``; the result is ``{name: {slot: NamedSharding}}``.
    The torch optimizer makes its state from the rank's pieces, so this
    describes a layout that already holds (``ShardingPlan.
    optimizer_state_shardings`` derives the same from a plan's rules)."""
    from .plan import derive_optimizer_state_shardings

    repl = NamedSharding(mesh, ())

    def param_sharding(_path: str, p) -> NamedSharding:
        found = sharding_of(p)
        return found[0] if found else repl

    return derive_optimizer_state_shardings(state, params, mesh, param_sharding)


def strided_split(x, accum: int) -> list:
    """Microbatch i takes rows ``i::accum``, so each keeps the whole
    data-parallel extent of a batch sharded over its leading dim."""
    return [x[i::accum] for i in range(accum)]


def contiguous_split(x, lead: int, accum: int):
    """``(lead, ...) -> (accum, lead / accum, ...)``: microbatch i is rows
    ``[i * lead / accum, (i + 1) * lead / accum)`` of a rank's local
    batch."""
    return x.reshape(accum, lead // accum, *x.shape[1:])


def _split_batch(batch: Any, accum: int, split: Callable) -> list:
    leads = set()
    collectives._map(lambda x: leads.add(tuple(x.shape[:1])), batch)
    if len(leads) != 1 or leads == {()}:
        raise ValueError(
            "gradient accumulation requires every batch leaf to share one "
            f"batch-major leading dim; got leading dims {sorted(leads)}")
    (lead,) = leads.pop()
    if lead % accum:
        raise ValueError(f"batch leading dim {lead} not divisible by accum_steps={accum}")
    pieces = []
    collectives._map(lambda x: pieces.append(split(x, accum)), batch)
    its = [iter(p) for p in zip(*pieces)]
    return [collectives._map(lambda _, it=it: next(it), batch) for it in its]


def accumulate_grads(loss_fn: Callable, params: Sequence[torch.Tensor], batch: Any,
                     accum: int, split: Callable = strided_split):
    """``(mean loss, grads)`` of ``loss_fn(microbatch)`` over ``accum``
    microbatches of ``batch`` (cut by ``split``): each microbatch's
    gradients with respect to ``params`` are summed in f32, the sum divided
    by ``accum`` and cast to each parameter's dtype, and the losses' f32
    mean returned detached; the JAX function's arithmetic.  With
    ``accum`` 1 the gradients come straight from autograd, in the
    parameters' dtypes.  A parameter the loss does not reach gets zeros."""
    params = list(params)

    def grads_of(loss):
        gs = torch.autograd.grad(loss, params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]

    if accum == 1:
        loss = loss_fn(batch)
        return loss.detach().float(), grads_of(loss)
    total, acc = None, None
    for mb in _split_batch(batch, accum, split):
        loss = loss_fn(mb)
        gs = grads_of(loss)
        loss = loss.detach().float()
        total = loss if total is None else total + loss
        if acc is None:
            acc = [g.float() for g in gs]
        else:
            for a, g in zip(acc, gs):
                a.add_(g.float())
    return total / accum, [(a / accum).to(p.dtype) for a, p in zip(acc, params)]


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
        with muted():  # booked by the step as a pmean
            return collectives.all_mean(g, ctx.ax), None


@contextlib.contextmanager
def swapped_parameters(model: nn.Module):
    """Yields ``swap(param, tensor)``, which puts ``tensor`` wherever the
    model holds ``param`` (a gathered or reduced stand-in, part of the
    autograd graph); every parameter goes back on exit.  A step keeps it
    open through the backward: a rematerialized block recomputes from what
    its modules hold then."""
    owners = {}
    for mod in model.modules():
        for name, p in mod._parameters.items():
            if p is not None:
                owners.setdefault(id(p), []).append((mod, name, p))

    def swap(p, t) -> None:
        for mod, name, _ in owners[id(p)]:
            mod._parameters[name] = t

    try:
        yield swap
    finally:
        for entries in owners.values():
            for mod, name, p in entries:
                mod._parameters[name] = p


def _spec_axes(spec) -> list:
    axes = []
    for entry in spec:
        if entry:
            axes.extend(entry if isinstance(entry, tuple) else (entry,))
    return axes


def init_optimizer_state(opt):
    """Make ``opt``'s per-parameter state before the first step, for the
    tensors its ``param_groups`` hold (a sharded step's pieces): the 8-bit
    AdamW's placed codes and scales, AnyPrecisionAdamW's and
    ``torch.optim.Adam`` / ``AdamW``'s slots as zeros shaped like the
    piece.  Another optimizer makes its state at its first step.  State
    already there is kept.  Returns ``opt``."""
    from ..optimizers import AdamW8bit, AnyPrecisionAdamW

    for group in opt.param_groups:
        for p in group["params"]:
            if opt.state.get(p):
                continue
            if isinstance(opt, AdamW8bit):
                opt._init_state(p)
            elif isinstance(opt, AnyPrecisionAdamW):
                opt._init_state(p, group)
            elif isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
                opt.state[p].update(step=torch.tensor(0.0),
                                    exp_avg=torch.zeros_like(p),
                                    exp_avg_sq=torch.zeros_like(p))
    return opt


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
                 accum_steps: int = 1, divergent_replicas: bool = False,
                 numerics: Optional[bool] = None):
        super().__init__(model, optimizer, loss_fn, numerics=numerics)
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
        self._params = self.shard_params()
        self._booked: set = set()  # batch signatures whose step was booked
        if shard_axis is not None and not divergent_replicas and hasattr(optimizer, "place"):
            optimizer.place(mesh, shard_axis)  # the 8-bit state in JAX's ZeRO layout

    def param_spec(self, shape, mesh: Optional[Mesh] = None) -> tuple:
        if self.shard_axis is None:
            return ()
        return fsdp_partition_spec(tuple(shape), mesh or self.mesh, self.shard_axis)

    def param_sharding(self, tree: Any) -> Any:
        """A ``NamedSharding`` of :meth:`param_spec` for every tensor of
        ``tree``, by its whole shape."""

        def one(t):
            found = sharding_of(t)
            return NamedSharding(self.mesh, self.param_spec(found[1] if found else t.shape))

        return collectives._map(one, tree)

    def init_optimizer(self):
        """Make this step's optimizer's state on each rank in its placement
        before the first step, as JAX's ``init_optimizer`` places it: the
        8-bit AdamW's as the rank's pieces of ``adam8bit_state_shardings``;
        the others' as :func:`init_optimizer_state` makes them.  Returns the
        optimizer."""
        return init_optimizer_state(self.optimizer)

    def placement_on(self, mesh: Mesh) -> Callable[[str, Any], NamedSharding]:
        """``(name, param) -> NamedSharding``: where this step would place a
        parameter on ``mesh`` (``Trainer.reshard``'s targets)."""

        def rule(name: str, p) -> NamedSharding:
            found = sharding_of(p)
            return NamedSharding(mesh, self.param_spec(found[1] if found else p.shape, mesh))

        return rule

    def state_placement_on(self, mesh: Mesh) -> Optional[Callable]:
        """``(name, slot, leaf) -> NamedSharding or None``: where a placed
        8-bit AdamW's blockwise array goes on ``mesh`` (the
        ``adam8bit_state_shardings`` rule over the shard axis there, by the
        array's whole shape); None for every other slot, which follows its
        parameter (``Trainer.reshard``'s slot targets).  None without such
        an optimizer."""
        from ..optimizers.quantized import _SLOTS, _state_spec

        if self.shard_axis is None or self.divergent_replicas or not hasattr(
                self.optimizer, "place"):
            return None
        n, axis = mesh.shape[self.shard_axis], self.shard_axis

        def rule(name: str, slot: str, leaf) -> Optional[NamedSharding]:
            if slot not in _SLOTS:
                return None
            found = sharding_of(leaf)
            shape = found[1] if found else tuple(leaf.shape)
            return NamedSharding(mesh, _state_spec(shape, n, axis))

        return rule

    def with_mesh(self, mesh: Mesh) -> "ShardedTrainStep":
        """This step's model, optimizer, loss, hook and settings over
        ``mesh``; the parameters must already be placed there as
        :meth:`placement_on` says (``Trainer.reshard`` places them)."""
        step = type(self)(self.model, self.optimizer, self.loss_fn, mesh,
                          shard_axis=self.shard_axis, replica_axes=self.replica_axes,
                          comm_hook=self.comm_hook, hook_state=self.hook_state,
                          batch_axes=self.batch_axes, batch_spec=self.batch_spec,
                          accum_steps=self.accum_steps,
                          divergent_replicas=self.divergent_replicas,
                          numerics=self.numerics)
        step.losses = self.losses
        return step

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

    def _book_grad_sync(self) -> None:
        """The JAX step's gradient-side rows (module docstring)."""
        trained = [(p, dim) for _, p, dim in self._params if p.requires_grad]
        full = [(_full_bytes(p), dim) for p, dim in trained]
        for ax in self.grad_reduce_axes:
            record_collective("pmean", ax, payload_bytes=sum(b for b, _ in full),
                              axis_size=self.mesh.shape[ax])
        sa = self.shard_axis
        if sa is None:
            return
        n = self.mesh.shape[sa]
        for b, dim in full:
            record_collective("reduce_scatter" if dim is not None else "pmean", sa,
                              payload_bytes=b, axis_size=n)

    def __call__(self, params, opt_state, batch):
        leaves = []
        collectives._map(leaves.append, batch)
        sig = tuple((tuple(x.shape), str(x.dtype)) for x in leaves)
        fresh = sig not in self._booked
        self._booked.add(sig)
        with contextlib.nullcontext() if fresh else muted():
            return self._step(params, opt_state, batch)

    def _step(self, params, opt_state, batch):
        opt_state.zero_grad(set_to_none=True)
        local = self.local_batch(batch)
        n = self.accum_steps
        micro = [collectives._map(lambda x, i=i: _chunks(x, n)[i], local) for i in range(n)]
        total = 0.0
        sa = self.shard_axis
        for _, p, dim in self._params:
            if dim is not None:
                record_collective("all_gather", sa, payload_bytes=_full_bytes(p),
                                  axis_size=self.mesh.shape[sa])
        num_on = self.numerics_on
        with self.mesh:
            if num_on:
                digs = mesh_group_digest(self._pieces(), "params/", tuple(self.mesh.axes))
            with swapped_parameters(self.model) as swap, \
                    numerics_tape() if num_on else contextlib.nullcontext() as tape:
                for mb in micro:
                    for _, p, dim in self._params:
                        swap(p, self._full(p, dim))
                    loss = self.loss_fn(self.model, mb)
                    (loss / self.accum_steps).backward()
                    total = total + loss.detach() / self.accum_steps
            if num_on:
                # partial over the rank's batch: the sum over the batch axes
                # counts each (row, token) once
                acts = allreduce_digests(tape.digests(),
                                         tuple(dict.fromkeys(_spec_axes(self.batch_spec))),
                                         self.mesh.shape)
                digs.update({f"act/{site}": d for site, d in acts.items()})
            self._book_grad_sync()
            grads = {name: p.grad for name, p, _ in self._params if p.grad is not None}
            if self.grad_reduce_axes:
                with muted():
                    grads = collectives.all_mean(grads, self.grad_reduce_axes)
            ctx = HookContext(replica_axes=self.replica_axes,
                              step=self.hook_state.step_args())
            grads = self.comm_hook(self.hook_state, grads, ctx)
            for name, p, _ in self._params:
                if name in grads:
                    p.grad = grads[name]
            opt_state.step()
            self.hook_state.advance()
            axes = tuple(self.mesh.axes.values())
            for ax in axes:
                record_collective("pmean", ax, total)
            with muted():
                loss = collectives.all_mean(total, axes)
            if num_on:
                digs["loss"] = array_digest(loss)
                digs.update(mesh_group_digest(self._pieces(grads=True), "grads/",
                                              tuple(self.mesh.axes)))
                self.last_digests = digs
        self.losses.append(loss)
        return params, opt_state, loss

    def _pieces(self, grads: bool = False):
        """``(path, piece, cut axes)`` of every parameter (or its gradient)
        for ``obs.numerics.mesh_group_digest``: the pieces differ over the
        shard axis when the parameter is sharded, and over the replica axis
        when the replicas diverge."""
        rep = tuple(self.replica_axes) if self.divergent_replicas else ()
        for name, p, dim in self._params:
            cut = ((self.shard_axis,) if dim is not None else ()) + rep
            yield name, p.grad if grads else p, cut


def _full_bytes(p: torch.Tensor) -> int:
    """Bytes of the whole parameter of which ``p`` is this rank's piece."""
    found = sharding_of(p)
    shape = found[1] if found else tuple(p.shape)
    return math.prod(shape) * p.element_size()


def _chunks(x, n):
    if x.shape[0] % n:
        raise ValueError(f"batch leading dim {x.shape[0]} not divisible by accum_steps={n}")
    return contiguous_split(x, x.shape[0], n)
