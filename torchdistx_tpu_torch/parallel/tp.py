"""Tensor parallelism, counterpart of ``torchdistx_tpu/parallel/tp.py``.

The JAX module annotates parameter shardings (Megatron column / row
splits) and leaves the collectives to XLA's SPMD partitioner.  There is no
partitioner here, so :class:`GSPMDTrainStep` places them itself, from each
parameter's sharding (``parallel.mesh.sharding_of``, set by
``materialize_module(sharding_rule=)`` or ``ShardingPlan.apply``):

- **Megatron compute, where a module's layout allows it**: the plan's
  ``tp_groups`` (:class:`TPGroup`) name a model's sub-layers, each a
  module whose column-parallel projections shard their output features
  over a ``tp`` axis and whose row-parallel one shards its input
  features over it (``llama_tp_plan``: attention ``wq`` / ``wk`` / ``wv``
  then ``wo``, MLP ``w_gate`` / ``w_up`` then ``w_down``).  Such a module
  runs on the rank's heads and FFN columns: its input enters once through
  ``copy_psum_grad`` (Megatron's ``f``), the row-parallel product leaves
  through ``allreduce_linear`` (``g``), one reduce a sub-layer each way.
  Llama's attention takes its head counts from the local projections,
  ``n_heads / tp`` and ``n_kv_heads / tp``; the group's check raises
  unless ``tp`` divides both.  An embedding sharded over
  its vocabulary looks up the rank's rows (others masked to zero) and
  all-reduces (``allreduce_linear``).  Another linear layer sharded over
  its output features (the LM head) computes its slice and all-gathers it
  before the loss; the gather's backward keeps the rank's slice, since
  every rank computes the same loss.  One sharded over its input features
  alone cuts its input to the rank's part.  An MoE whose expert weights
  are sharded over an axis computes its local experts (``nn.moe``).  These
  paths save memory and work.
- **Anything else is gathered at use**: the other dimension of a 2-D TP x
  FSDP plan, and any spec no local path knows (a norm sharded over ``tp``,
  an axis the batch is also sharded over).  The parameter is all-gathered
  before the forward; the gradient's backward reduce-scatters and divides
  by the axis size over an axis the batch is sharded over (the mean of the
  ranks' batches), and keeps the rank's slice over any other (its ranks
  computed the same gradient).  Correct for every plan, no saving.

With a ``ShardingPlan(zero2=True)`` the step is ZeRO-2 (arXiv:1910.02054):
the parameters the plan replicates stay replicated, their gradients are
mean-reduced over ``dp`` as in the replicated step, and each rank updates
only its ``dp`` slice of each (``plan.zero2_sharding``), with its slice of
the optimizer's slots; the updated slices are all-gathered over ``dp``
and written back into the parameters in place.  ``torch.optim`` keys its
state by tensor, so the optimizer is handed the rank's slice tensors in
place of those parameters (each slice an ``nn.Parameter`` marked with its
``dp`` sharding and its parameter's path, ``_tdx_path``).  The update is
elementwise, so the parameters are bit-equal to the replicated step's.
The 8-bit AdamW's blockwise state does not slice along a parameter's
rows; its parameters keep whole updates, as the JAX plan leaves that
optimizer's flat code lists replicated.

:class:`TPLayout` holds the local forwards and the gathered-at-use
tensors of one model over one mesh; the train step installs it for a
step, and ``serve.ServeEngine(mesh=, plan=)`` for each dispatch, on its own
placed copy of the parameters (an inference forward needs no gradient, so
there ``copy_psum_grad`` costs nothing and the row-parallel and vocabulary
all-reduces and the head's all-gather are its collectives).

The comm audit (``obs.comm``) sees what the JAX step books: nothing of the
collectives XLA places, and with a ZeRO-2 plan the plan's closed form
(``plan.price_step``) at each dispatch, so that a k-step audit is k times
the plan's price.  The step's own collectives run muted.

The batch is sharded by ``batch_spec``; the gradient of a parameter is then
the mean over each batch axis its own spec does not name, and the loss the
mean over the batch axes.  The loss is each rank's ``loss_fn`` on its
piece, so a loss that is not a mean over the batch's rows (the MoE aux
loss) equals the unsharded one only with the batch replicated.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn

from ..nn import functional as F
from ..obs.comm import muted
from ..obs.numerics import (
    array_digest,
    fold_digests,
    mesh_group_digest,
    numerics_tape,
)
from ..trainer import TrainStep
from . import collectives
from .fsdp import _GatherShard, accumulate_grads, strided_split, swapped_parameters
from .mesh import Mesh, NamedSharding, mark_sharded, sharding_of
from .fsdp import _spec_axes
from .plan import ShardingPlan, equivalent, gather_full, place_params

__all__ = [
    "TPGroup",
    "tp_shard_rule",
    "llama_tp_plan",
    "llama_tp_rule",
    "shard_params",
    "TPLayout",
    "GSPMDTrainStep",
]


def tp_shard_rule(mesh: Mesh, patterns: Sequence[tuple], *,
                  default_axis: Optional[str] = None) -> Callable[[str, Any], NamedSharding]:
    """A ``sharding_rule(path, like) -> NamedSharding`` from ``(regex,
    spec)`` pairs (first match wins); unmatched parameters are replicated,
    or FSDP-sharded over ``default_axis``.  The rule projection of
    ``ShardingPlan(mesh, rules=patterns, default_axis=...)``."""
    return ShardingPlan(mesh, rules=tuple(patterns), default_axis=default_axis).as_rule()


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """One Megatron sub-layer of a model's TP plan: a module holding the
    column-parallel ``columns`` (output features over the axis), which all
    read the module forward's first argument, and the row-parallel ``rows``
    (input features over it) that close the sub-layer.
    ``check(module, axis, size)`` raises where the module cannot run on
    ``size`` shards."""

    columns: tuple
    rows: tuple
    check: Optional[Callable[[nn.Module, str, int], None]] = None


def _whole_heads(mod: nn.Module, axis: str, n: int) -> None:
    cfg = mod.cfg
    if cfg.n_heads % n or cfg.n_kv_heads % n:
        raise ValueError(
            f"tensor parallelism over {axis!r} ({n}) needs n_heads ({cfg.n_heads}) and "
            f"n_kv_heads ({cfg.n_kv_heads}) divisible by {n}")


LLAMA_TP_GROUPS = (TPGroup(("wq", "wk", "wv"), ("wo",), _whole_heads),
                   TPGroup(("w_gate", "w_up"), ("w_down",)))


def llama_tp_plan(mesh: Mesh, tp_axis: str = "tp", fsdp_axis: Optional[str] = None,
                  **plan_kwargs: Any) -> ShardingPlan:
    """Megatron-style TP plan for :class:`~torchdistx_tpu_torch.models.Llama`:
    column-parallel (output features over ``tp_axis``) ``wq`` / ``wk`` /
    ``wv`` and ``w_gate`` / ``w_up``, row-parallel (input features) ``wo`` and
    ``w_down``, embedding and head over the vocabulary.  With
    ``fsdp_axis`` the other matrix dim is FSDP-sharded as well (2-D TP x
    FSDP).  The ``kv_cache`` pseudo-path gives the serve KV pool's layout:
    heads (dim 2 of (slots, pages, heads, head_dim)) over ``tp_axis``.  Its
    ``tp_groups`` are the attention and the MLP (``LLAMA_TP_GROUPS``)."""
    f = fsdp_axis
    rules = (
        (r"\.(wq|wk|wv)\.weight$", (tp_axis, f)),
        (r"\.wo\.weight$", (f, tp_axis)),
        (r"\.(w_gate|w_up)\.weight$", (tp_axis, f)),
        (r"\.w_down\.weight$", (f, tp_axis)),
        (r"tok_emb\.weight$", (tp_axis, f)),
        (r"lm_head\.weight$", (tp_axis, f)),
        (r"^kv_cache$", (None, None, tp_axis, None)),
    )
    plan_kwargs.setdefault("tp_groups", LLAMA_TP_GROUPS)
    return ShardingPlan(mesh, rules=rules, **plan_kwargs)


def llama_tp_rule(mesh: Mesh, tp_axis: str = "tp", fsdp_axis: Optional[str] = None
                  ) -> Callable[[str, Any], NamedSharding]:
    """:func:`llama_tp_plan`'s rule projection, for
    ``materialize_module(sharding_rule=)``."""
    return llama_tp_plan(mesh, tp_axis, fsdp_axis).as_rule()


def shard_params(params: Any, rule: Callable[[str, Any], NamedSharding]) -> Any:
    """Place already-materialized parameters by ``rule(path, like)``
    (``plan.place_params``): each becomes this rank's piece, marked, unless
    it is already placed so.  A ``{name: tensor}`` dict gives a new dict; a
    module is placed in place.  The post-hoc sibling of
    ``materialize_module(sharding_rule=)``."""
    return place_params(params, rule)


class _GatherKeep(torch.autograd.Function):
    """All-gather along ``dim``; backward: this rank's slice of the
    gradient, which every rank of the axis computed alike."""

    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return collectives._gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        ax, dim = ctx.ax, ctx.dim
        if ax.size == 1:
            return g, None, None
        return g.chunk(ax.size, dim)[ax.index].contiguous(), None, None


# -- the local (Megatron) forwards, installed on modules for a step ---------


def _entered(mod, x, *args, ax, **kwargs):
    """A TP group's module: its input enters the sub-layer once (``f``)."""
    return type(mod).forward(mod, collectives.copy_psum_grad(x, ax), *args, **kwargs)


def _column(mod, x, ax, alone):
    """Column-parallel: the rank's output features.  ``alone`` (not in a
    group): the input enters here and the output is gathered."""
    if not alone:
        return F.linear(x, mod.weight, mod.bias)
    y = F.linear(collectives.copy_psum_grad(x, ax), mod.weight, mod.bias)
    return _GatherKeep.apply(y, ax, y.ndim - 1)


def _row(mod, x, ax, cut):
    k = mod.weight.shape[1]
    if cut:  # a replicated input: this rank's columns of it
        x = collectives.copy_psum_grad(x, ax)[..., ax.index * k:(ax.index + 1) * k]
    y = collectives.allreduce_linear(F.linear(x, mod.weight), ax)
    return y if mod.bias is None else y + mod.bias


def _vocab(mod, ids, ax):
    w = mod.weight
    n = w.shape[0]
    local = ids - ax.index * n
    mine = (local >= 0) & (local < n)
    out = F.embedding(local.clamp(0, n - 1), w) * mine[..., None].to(w.dtype)
    return collectives.allreduce_linear(out, ax)


def _single(entry) -> Optional[str]:
    """The axis of a spec entry that names exactly one."""
    if isinstance(entry, tuple):
        return entry[0] if len(entry) == 1 else None
    return entry


class _Param:
    """One parameter in the step: its sharding, global shape, and the axis
    (with its dim) a local forward computes on (None: gathered whole)."""

    def __init__(self, name, p, sharding, shape):
        self.name, self.p, self.sharding, self.shape = name, p, sharding, shape
        self.keep = None  # (dim, axis name)

    def spec(self) -> tuple:
        return tuple(self.sharding.spec) + (None,) * (len(self.shape) - len(self.sharding.spec))


class TPLayout:
    """The Megatron local forwards of one model over one mesh (module
    docstring), shared by :class:`GSPMDTrainStep` and the tensor-parallel
    serving engine.

    ``params``: ``{name: tensor}``, the rank's pieces, each marked with its
    sharding (``parallel.mesh.sharding_of``; unmarked: replicated), by the
    names of ``model.named_parameters()``; default the model's own
    parameters.  ``groups``: the plan's ``tp_groups``.  ``batch_axes``:
    axes the batch is sharded over; a parameter sharded over one of them
    is gathered at use (the train step's FSDP dimension).  :meth:`use`
    gives what the forward sees for a parameter, :meth:`installed` puts the
    forwards and those tensors in the model for a region."""

    def __init__(self, model: nn.Module, mesh: Mesh, *, params: Optional[dict] = None,
                 groups: Sequence[TPGroup] = (), batch_axes: Sequence[str] = ()):
        self.model, self.mesh = model, mesh
        self.groups = tuple(groups)
        self.batch_axes = tuple(batch_axes)
        named = dict(model.named_parameters())
        params = named if params is None else params
        self._module_tensor = named
        self.params = []
        for name in named:
            p = params[name]
            found = sharding_of(p)
            if found is None:
                found = (NamedSharding(mesh, ()), tuple(p.shape))
                mark_sharded(p, *found)
            if found[0].mesh is not mesh:
                raise ValueError(f"{name} is sharded over another mesh")
            self.params.append(_Param(name, p, *found))
        self._by_module_tensor = {id(named[q.name]): q for q in self.params}
        self.forwards = self._local_forwards()

    def _local_forwards(self) -> dict:
        """``{module: forward}`` of the modules that compute on their local
        pieces, marking each such parameter's kept (dim, axis)."""
        from ..nn.layers import Embedding, Linear
        from ..nn.moe import MoE

        by_id = self._by_module_tensor
        batch = set(self.batch_axes)

        def info(mod, attr="weight"):
            t = mod._parameters.get(attr)
            return by_id.get(id(t)) if isinstance(t, torch.Tensor) else None

        def col(mod):  # output features over one non-batch axis, bias alike
            q = info(mod)
            if not isinstance(mod, Linear) or q is None:
                return None
            ax = _single(q.spec()[0])
            b = info(mod, "bias")
            if ax is None or ax in batch or (b is not None and _single(b.spec()[0]) != ax):
                return None
            return ax

        def row(mod):
            q = info(mod)
            if not isinstance(mod, Linear) or q is None:
                return None
            ax = _single(q.spec()[1])
            b = info(mod, "bias")
            if ax is None or ax in batch or (b is not None and _spec_axes(b.spec())):
                return None
            return ax

        def keep(mod, dim, ax):
            info(mod).keep = (dim, ax)
            if dim == 0 and info(mod, "bias") is not None:
                info(mod, "bias").keep = (0, ax)
            return self.mesh.axes[ax]

        # the plan's Megatron sub-layers: its input entered once, the
        # column-parallel projections, then the row-parallel one
        groups = self.groups
        out = {}
        for mod in self.model.modules():
            for g in groups:
                subs = [getattr(mod, n, None) for n in g.columns + g.rows]
                if not all(isinstance(s, Linear) for s in subs) or any(s in out for s in subs):
                    continue
                cols, rows = subs[:len(g.columns)], subs[len(g.columns):]
                axes = {col(s) for s in cols} | {row(s) for s in rows}
                if len(axes) != 1 or None in axes:
                    continue
                (name,) = axes
                if g.check is not None:
                    g.check(mod, name, self.mesh.shape[name])
                out[mod] = functools.partial(_entered, mod, ax=self.mesh.axes[name])
                for s in cols:
                    out[s] = functools.partial(_column, s, ax=keep(s, 0, name), alone=False)
                for s in rows:
                    out[s] = functools.partial(_row, s, ax=keep(s, 1, name), cut=False)
        for mod in self.model.modules():
            if mod in out:
                continue
            if isinstance(mod, Linear):
                if col(mod):
                    out[mod] = functools.partial(_column, mod, ax=keep(mod, 0, col(mod)),
                                                 alone=True)
                elif row(mod):
                    out[mod] = functools.partial(_row, mod, ax=keep(mod, 1, row(mod)), cut=True)
            elif isinstance(mod, Embedding) and info(mod) is not None:
                ax = _single(info(mod).spec()[0])
                if ax is not None and ax not in batch:
                    out[mod] = functools.partial(_vocab, mod, ax=keep(mod, 0, ax))
            elif isinstance(mod, MoE):  # it computes on expert shards itself
                qs = [info(mod, n) for n in ("w_gate", "w_up", "w_down")]
                axes = {_single(q.spec()[0]) if q is not None else None for q in qs}
                if len(axes) == 1 and None not in axes and not axes & batch:
                    (ax,) = axes
                    for q in qs:
                        q.keep = (0, ax)
        return out

    def use(self, q: _Param) -> torch.Tensor:
        """What the forward sees for ``q``: gathered over every axis but the
        kept one (marked with what stays sharded), or the parameter."""
        t, kept = q.p, q.keep
        for d, entry in enumerate(q.spec()):
            names = entry if isinstance(entry, tuple) else (entry,) if entry else ()
            for name in reversed(names):
                if kept == (d, name):
                    continue
                ax = self.mesh.axes[name]
                fn = _GatherShard if name in self.batch_axes else _GatherKeep
                t = fn.apply(t, ax, d)
        if t is not q.p and kept is not None:
            spec = [None] * len(q.shape)
            spec[kept[0]] = kept[1]
            mark_sharded(t, NamedSharding(self.mesh, tuple(spec)), q.shape)
        return t

    @contextlib.contextmanager
    def installed(self):
        """The local forwards on their modules, and ``swap(q, tensor)``,
        which puts ``tensor`` wherever the model holds ``q``'s parameter,
        for the forward and the backward (remat recomputes under them).
        Every parameter and forward goes back on exit."""
        for mod, fwd in self.forwards.items():
            mod.forward = fwd
        try:
            with swapped_parameters(self.model) as swap:
                yield lambda q, t: swap(self._module_tensor[q.name], t)
        finally:
            for mod in self.forwards:
                del mod.forward

    def swap_all(self, swap) -> None:
        """Every parameter's :meth:`use` into the model (``swap`` of
        :meth:`installed`)."""
        for q in self.params:
            swap(q, self.use(q))


class GSPMDTrainStep(TrainStep):
    """``step(model, optimizer, batch) -> (model, optimizer, loss)`` on
    parameters that keep their shardings from step to step (TP, 2-D TP x
    FSDP, EP, anything a ``NamedSharding`` expresses), equal to an
    unsharded step's loss and update.  ``loss_fn(model, batch)``; the
    loss must take the logits from the model's forward (a loss that reads
    a sharded weight itself sees the rank's piece).

    Args: ``mesh``; ``batch_spec``, the batch's sharding (``("dp",)``: dim 0
    over ``dp``; default replicated); ``accum_steps``, microbatches of the
    batch (``strided_split``) whose gradients add up in f32
    (``fsdp.accumulate_grads``); ``plan``, a :class:`~.plan.ShardingPlan`
    applied to the model first (full parameters cut, others re-cut where
    they differ), so the parameters take and keep its shardings.  Without
    a plan each parameter keeps its own (unmarked: replicated).  A plan
    with ``zero2=True`` makes the step ZeRO-2 (module docstring): build the
    optimizer over the model's parameters, and the step hands it the
    rank's slices.

    The batch is the global batch, the same on every rank, and each rank
    takes its piece; a batch tensor that carries a sharding
    (``mark_sharded``, as ``DataLoader(sharding=)`` gives) is taken as the
    rank's piece as it is if that sharding is ``batch_spec``, else gathered
    and cut again, with a warning once per layout.

    ``numerics=True`` (None: ``TDX_NUMERICS``) leaves the JAX step's digests
    on ``last_digests``, of the whole tensors as the JAX step takes them on
    its global arrays: ``params/`` and ``grads/`` folded from the pieces
    over the mesh (``obs.numerics.mesh_group_digest``), ``act/`` from the
    rank's batch folded over the batch axes, ``loss``; nothing is booked
    into the comm audit for them, as the JAX step books nothing."""

    def __init__(self, model: nn.Module, optimizer, loss_fn: Callable, mesh: Mesh, *,
                 batch_spec: Sequence = (), accum_steps: int = 1,
                 plan: Optional[ShardingPlan] = None, numerics: Optional[bool] = None):
        super().__init__(model, optimizer, loss_fn, numerics=numerics)
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        if plan is not None and plan.mesh is not mesh:
            raise ValueError("the plan's mesh is not the step's")
        self.mesh = mesh
        self.plan = plan
        self.batch_spec = tuple(batch_spec)
        self.batch_axes = tuple(dict.fromkeys(_spec_axes(self.batch_spec)))
        for ax in self.batch_axes:
            if ax not in mesh.axis_names:
                raise ValueError(f"batch_spec {self.batch_spec} names {ax!r}, not a mesh axis")
        self.accum_steps = int(accum_steps)
        self._warned: set = set()
        if plan is not None:
            plan.apply(model)
        self._layout = TPLayout(model, mesh, groups=plan.tp_groups if plan is not None else (),
                                batch_axes=self.batch_axes)
        self._params = self._layout.params
        self._zero2 = self._zero2_slices() if plan is not None and plan.zero2 else {}
        # the ZeRO-2 gather's closed form, booked at each dispatch
        self._step_rows = (tuple(plan.price_step(model))
                           if plan is not None and plan.zero2 else ())

    def with_mesh(self, mesh: Mesh) -> "GSPMDTrainStep":
        """This step's model, optimizer, loss and settings over ``mesh``
        (the plan's rules over it, ``plan.with_mesh``): the elastic
        rebuild of ``Trainer.reshard``.  The parameters must already be
        placed on ``mesh`` as the new plan places them."""
        plan = self.plan.with_mesh(mesh) if self.plan is not None else None
        step = type(self)(self.model, self.optimizer, self.loss_fn, mesh,
                          batch_spec=self.batch_spec, accum_steps=self.accum_steps, plan=plan,
                          numerics=self.numerics)
        step.losses = self.losses
        return step

    def init_optimizer(self):
        """Make the optimizer's state before the first step, in each
        parameter's placement (JAX's ``init_optimizer`` places it by the
        plan's ``optimizer_state_shardings``): the slots of the tensors the
        optimizer holds, which are the plan's pieces, and under ZeRO-2 the
        ``dp`` slices (``fsdp.init_optimizer_state``).  Returns the
        optimizer."""
        from .fsdp import init_optimizer_state

        return init_optimizer_state(self.optimizer)

    def placement_on(self, mesh: Mesh) -> Callable[[str, Any], NamedSharding]:
        """``(name, param) -> NamedSharding``: the plan's placement over
        ``mesh`` (``plan.with_mesh``), or each parameter's own spec there
        without a plan (``Trainer.reshard``'s targets)."""
        if self.plan is not None:
            return self.plan.with_mesh(mesh).sharding_for
        specs = {q.name: q.sharding.spec for q in self._params}
        return lambda name, p: NamedSharding(mesh, specs[name])

    def state_placement_on(self, mesh: Mesh) -> Optional[Callable]:
        """``(name, slot, leaf) -> NamedSharding or None``: under ZeRO-2, a
        sliced parameter's slot shaped like it goes to its ``dp`` slice of
        the plan over ``mesh`` (``plan.with_mesh(mesh).zero2_sharding``, or
        replicated where that cuts nothing); None for every other slot
        (``Trainer.reshard``'s slot targets).  None without ZeRO-2."""
        if not self._zero2:
            return None
        plan = self.plan.with_mesh(mesh)
        sliced = {q.name: q for q in self._zero2}

        def rule(name: str, slot: str, leaf) -> Optional[NamedSharding]:
            q = sliced.get(name)
            found = sharding_of(leaf)
            if q is None or found is None or tuple(found[1]) != tuple(q.shape):
                return None
            return plan.zero2_sharding(name, q.p) or NamedSharding(mesh, ())

        return rule

    def release_zero2_slices(self) -> None:
        """Hand the optimizer its parameters back in place of the ZeRO-2
        slices, each with the slice's state as it stands (a reshard has
        already cut it for the next mesh, whose step slices again)."""
        opt = self.optimizer
        for q, (piece, _, _) in self._zero2.items():
            for group in opt.param_groups:
                group["params"] = [q.p if t is piece else t for t in group["params"]]
            if piece in opt.state:
                opt.state[q.p] = opt.state.pop(piece)
        self._zero2 = {}

    # -- ZeRO-2 --------------------------------------------------------------

    def _zero2_slices(self) -> dict:
        """``{_Param: (slice, its slices, its sharding)}``: each replicated
        parameter whose update the plan shards gets a slice tensor (this
        rank's ``dp`` piece), which replaces the parameter in the optimizer
        (its state, if any, cut alike).  Empty for the 8-bit AdamW (module
        docstring)."""
        from ..optimizers.quantized import AdamW8bit

        opt = self.optimizer
        if isinstance(opt, AdamW8bit):
            return {}
        out = {}
        for q in self._params:
            sh = self.plan.zero2_sharding(q.name, q.p) if q.p.requires_grad else None
            if sh is None:
                continue
            cut = sh.shard_slices(q.shape)
            piece = nn.Parameter(q.p.detach()[cut].clone())
            mark_sharded(piece, sh, q.shape)
            piece._tdx_path = q.name
            for group in opt.param_groups:
                group["params"] = [piece if t is q.p else t for t in group["params"]]
            if q.p in opt.state:
                opt.state[piece] = {k: v[cut].clone() if isinstance(v, torch.Tensor)
                                    and v.shape == q.p.shape else v
                                    for k, v in opt.state.pop(q.p).items()}
            out[q] = (piece, cut, sh)
        return out

    def _zero2_gather(self) -> None:
        """The updated slices all-gathered over ``dp`` into the parameters."""
        with torch.no_grad():
            for q, (piece, _, sh) in self._zero2.items():
                q.p.copy_(gather_full(piece, sh))

    # -- the batch ---------------------------------------------------------

    def local_batch(self, batch: Any) -> Any:
        """This rank's piece of the batch, by ``batch_spec``."""
        target = NamedSharding(self.mesh, self.batch_spec)

        def one(x):
            found = sharding_of(x)
            if found is None:
                return x[target.shard_slices(x.shape)]
            sh, shape = found
            if equivalent(sh, target, len(shape)):
                return x
            sig = (tuple(sh.spec), tuple(shape))
            if sig not in self._warned:
                self._warned.add(sig)
                warnings.warn(
                    f"GSPMDTrainStep: batch leaf {tuple(shape)} arrives with sharding "
                    f"{sh.spec}, not the step's batch_spec {self.batch_spec}; it is "
                    "gathered and cut again at every step. Align the DataLoader's "
                    "sharding with batch_spec to silence this.", stacklevel=4)
            return gather_full(x, sh)[target.shard_slices(shape)]

        return collectives._map(one, batch)

    def full_params(self) -> dict:
        """Every parameter gathered to its full shape (detached; every rank
        takes part)."""
        return {q.name: gather_full(q.p, q.sharding) for q in self._params}

    def __call__(self, params, opt_state, batch):
        from ..obs.comm import record_collective

        for r in self._step_rows:
            record_collective(r["kind"], r["axis"], payload_bytes=r["payload_bytes"],
                              count=r["count"], axis_size=r["axis_size"])
        with muted():
            return self._step(params, opt_state, batch)

    def _step(self, params, opt_state, batch):
        opt_state.zero_grad(set_to_none=True)
        local = self.local_batch(batch)
        trained = [q for q in self._params if q.p.requires_grad]
        num_on = self.numerics_on
        mesh_axes = tuple(self.mesh.axis_names)
        with self.mesh, self._layout.installed() as swap:
            if num_on:
                digs = mesh_group_digest(((q.name, q.p, _spec_axes(q.spec()))
                                          for q in self._params), "params/", mesh_axes)

            def loss_of(mb):
                self._layout.swap_all(swap)
                return self.loss_fn(self.model, mb)

            with numerics_tape() if num_on else contextlib.nullcontext() as tape:
                loss, grads = accumulate_grads(loss_of, [q.p for q in trained], local,
                                               self.accum_steps, strided_split)
            if num_on:
                acts = fold_digests(tape.digests(), self.batch_axes)
                digs.update({f"act/{site}": d for site, d in acts.items()})
            for q, g in zip(trained, grads):
                axes = tuple(ax for ax in self.batch_axes if ax not in _spec_axes(q.spec()))
                q.p.grad = collectives.all_mean(g, axes) if axes else g
                if q in self._zero2:
                    piece, cut, _ = self._zero2[q]
                    piece.grad = q.p.grad[cut].contiguous()
            if num_on:
                grad_digs = mesh_group_digest(((q.name, q.p.grad, _spec_axes(q.spec()))
                                               for q in self._params), "grads/", mesh_axes)
            opt_state.step()
            self._zero2_gather()
            if self.batch_axes:
                loss = collectives.all_mean(loss, self.batch_axes)
            if num_on:
                digs["loss"] = array_digest(loss)
                digs.update(grad_digs)
                self.last_digests = digs
        self.losses.append(loss)
        return params, opt_state, loss
