"""Pipeline parallelism over a ``pp`` mesh axis, counterpart of
``torchdistx_tpu/parallel/pp.py``.

The JAX module runs every stage as one SPMD program over the axis (the
stage weights stacked with a leading stage dimension sharded over it,
bubble ticks computing on zeros that are masked out).  Here each rank of
the axis is its own stage: the stacked tree of :func:`stack_pipeline_stages`
has a leading dimension of 1 on each rank (its stage, marked as the piece
of the ``(n_stages, ...)`` whole), a rank computes only in the ticks its
stage has a microbatch, and activations and input gradients move to the
neighbouring stage by point-to-point sends (``collectives._permute``: a
send to the next stage and a receive from the previous one a tick, each
made only when the tick carries a microbatch, so every send meets its
receive; CUDA tensors on a ``gloo`` group go through pinned host
buffers).  The bytes a rank sends are counted in
``collectives.payload_bytes["pipe"]``.  The results equal the JAX
schedules':

- :func:`pipeline_apply`: the GPipe forward, ``n_micro + n_stages - 1``
  ticks; the last stage's outputs are broadcast over the axis, so they end
  up on every rank.  Differentiable: its backward is the reverse GPipe
  schedule, each stage recomputing from the inputs it stashed (all of its
  microbatches: O(n_micro) activations a stage, like JAX's autodiff
  backward through the scan), seeded by the last stage's own cotangent.
  The outputs are replicated, so every rank must compute the same loss
  from them.
- :func:`pipeline_train_step`: 1F1B, ``n_micro + 2 * (n_stages - 1)``
  ticks, each running one forward and one backward micro-op a stage.  The
  backward recomputes the stage from the stashed input (a stash of
  ``2 * n_stages - 1`` inputs), seeds the last stage from ``loss_fn``
  (which runs only there) and sends the input gradient down the pipe;
  parameter gradients are summed over the microbatches in the
  parameters' dtype and divided by ``n_micro``, then averaged over
  ``dp_axis``; the loss is broadcast from the last stage, so it is
  replicated.

``dp_axis``: the microbatches' batch dimension (dim 1) is sharded over it;
the microbatches and targets given are the global ones, the same on every
rank, and each rank takes its piece (a tensor marked with that sharding
is taken as the piece).  ``param_specs``: per leaf the spec of the stacked
leaf, its first entry ``axis``; the other entries cut the stage's weights
over further axes (the tensor-parallel composition hook: ``stage_fn``
then carries the ``tp`` collectives itself, ``collectives.copy_psum_grad``
where the replicated activation enters and ``allreduce_linear`` after the
row-parallel product).  Gradients come back in the parameters' layout.

The comm audit (``obs.comm``) books the JAX schedules' closed forms at
each call: ``ticks`` exchanges of one microbatch activation (``2 * ticks``
for 1F1B) over the axis, its ``n_stages - 1`` links sending, and the
all-reduce that replicates the result (the outputs; 1F1B's f32 loss),
plus with ``dp_axis`` a ``pmean`` of the gradients and one of the loss.
The schedules' own sends, broadcasts and means run muted.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from ..obs.comm import muted, record_collective
from . import collectives
from .mesh import Mesh, NamedSharding, mark_sharded, sharding_of
from .plan import _norm_spec, equivalent, place

__all__ = [
    "stack_pipeline_stages",
    "split_microbatches",
    "pipeline_apply",
    "pipeline_train_step",
]


def stack_pipeline_stages(stage_params: Sequence[Any], mesh: Mesh, axis: str = "pp") -> Any:
    """This rank's stage of ``stage_params`` (one tree a stage, identical
    structures; e.g. each from ``deferred_init`` + ``materialize_module``
    of a stage module), each leaf a ``(1, ...)`` view of the stage's tensor
    marked as the rank's piece of the ``(n_stages, ...)`` stack over
    ``axis``."""
    n = mesh.shape[axis]
    if len(stage_params) != n:
        raise ValueError(f"{len(stage_params)} stages for a {n}-way {axis!r} axis")
    mine = stage_params[mesh.axes[axis].index]
    leaves, unflatten = collectives.tree_flatten(mine)
    sharding = NamedSharding(mesh, (axis,))
    return unflatten([mark_sharded(t.detach()[None], sharding, (n, *t.shape)) for t in leaves])


def split_microbatches(batch: Any, n_micro: int) -> Any:
    """Reshape every leaf ``(B, ...) -> (n_micro, B // n_micro, ...)``."""

    def split(x):
        if x.shape[0] % n_micro:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by n_micro={n_micro}")
        return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))

    return collectives._map(split, batch)


def _local_stage(stage_params, mesh, axis, param_specs) -> tuple:
    """``(leaves, unflatten, shardings)``: the rank's stacked leaves, cut to
    ``param_specs`` where given (a leaf already placed so is kept)."""
    leaves, unflatten = collectives.tree_flatten(stage_params)
    specs = ([None] * len(leaves) if param_specs is None else collectives.tree_flatten(
        param_specs, is_leaf=lambda x: isinstance(x, tuple)
        and all(e is None or isinstance(e, (str, tuple)) for e in x))[0])
    if len(specs) != len(leaves):
        raise ValueError(f"param_specs has {len(specs)} leaves for {len(leaves)} parameters")
    out, shardings = [], []
    for t, spec in zip(leaves, specs):
        found = sharding_of(t)
        if found is None:
            raise ValueError("stage parameters must come from stack_pipeline_stages")
        target = found[0] if spec is None else NamedSharding(mesh, _norm_spec(spec))
        if target.spec[:1] != (axis,):
            raise ValueError(f"a stage parameter's spec must lead with {axis!r}, "
                             f"got {target.spec}")
        if not equivalent(found[0], target, len(found[1])):
            piece, shape = place(t, target)
            t = mark_sharded(piece, target, shape)
        out.append(t)
        shardings.append((target, found[1]))
    return out, unflatten, shardings


def _local_micro(tree: Any, mesh: Mesh, dp_axis: Optional[str]) -> Any:
    """This rank's piece of global microbatches (dim 1 over ``dp_axis``)."""
    if dp_axis is None:
        return tree
    target = NamedSharding(mesh, (None, dp_axis))

    def one(x):
        found = sharding_of(x)
        if found is not None and equivalent(found[0], target, len(found[1])):
            return x
        return x[target.shard_slices(x.shape)]

    return collectives._map(one, tree)


def _send_recv(ax, x, dst: bool, src: bool, forward: bool, like) -> Optional[torch.Tensor]:
    """Send ``x`` to the next stage (``forward``) or the previous one, and
    receive from the other side, each only when asked; returns what came
    in, else None."""
    if not (dst or src):
        return None
    step = 1 if forward else -1
    template = x if x is not None else like
    out = collectives._permute([template], ax, ax.index + step if dst else -1,
                               ax.index - step if src else -1, "zero")[0]
    if dst:
        collectives.payload_bytes["pipe"] += x.numel() * x.element_size()
    return out if src else None


def _param_views(leaves) -> list:
    return [t.detach()[0].requires_grad_() for t in leaves]


def _stacked(grads, shardings) -> list:
    return [mark_sharded(g[None], sh, shape) for g, (sh, shape) in zip(grads, shardings)]


class _PipeApply(torch.autograd.Function):
    """The GPipe forward; backward: the reverse GPipe schedule (module
    docstring)."""

    @staticmethod
    def forward(ctx, info, mb, *leaves):
        ax, stage_fn, unflatten = info
        n_stages, s, n_micro = ax.size, ax.index, mb.shape[0]
        act = mb.numel() * mb.element_size() // n_micro
        record_collective("exchange", ax, payload_bytes=act, count=n_micro + n_stages - 1,
                          axis_size=n_stages, senders=n_stages - 1)
        record_collective("all_reduce", ax, payload_bytes=act * n_micro, axis_size=n_stages)
        p = unflatten([t.detach()[0] for t in leaves])
        stash, outputs, prev = [None] * n_micro, torch.zeros_like(mb), None
        for t in range(n_micro + n_stages - 1):
            i = t - s
            valid = 0 <= i < n_micro
            recv = _send_recv(ax, prev, s < n_stages - 1 and 0 <= i - 1 < n_micro,
                              s > 0 and valid, True, mb[0])
            prev = None
            if valid:
                x = mb[i] if s == 0 else recv
                stash[i] = x
                y = stage_fn(p, x)
                if s == n_stages - 1:
                    outputs[i] = y
                else:
                    prev = y
        with muted():
            outputs = collectives.broadcast(outputs, ax, n_stages - 1)
        ctx.info = info
        ctx.save_for_backward(*[x for x in stash if x is not None], *leaves)
        ctx.n_stash = sum(x is not None for x in stash)
        ctx.mb_like = (mb.shape, mb.dtype, mb.device, mb.requires_grad)
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        ax, stage_fn, unflatten = ctx.info
        saved = ctx.saved_tensors
        stash, leaves = saved[:ctx.n_stash], saved[ctx.n_stash:]
        n_stages, s = ax.size, ax.index
        shape, dtype, device, mb_grad = ctx.mb_like
        n_micro = shape[0]
        params = _param_views(leaves)
        p = unflatten(params)
        acc = [torch.zeros_like(q) for q in params]
        d_mb = torch.zeros(shape, dtype=dtype, device=device) if mb_grad and s == 0 else None
        prev = None
        for r in range(n_micro + n_stages - 1):
            i = r - (n_stages - 1 - s)
            valid = 0 <= i < n_micro
            recv = _send_recv(ax, prev, s > 0 and 0 <= i - 1 < n_micro,
                              s < n_stages - 1 and valid, False, g_out[0])
            prev = None
            if not valid:
                continue
            g_in = g_out[i] if s == n_stages - 1 else recv
            with torch.enable_grad():
                x = stash[i].detach().requires_grad_(s > 0 or d_mb is not None)
                y = stage_fn(p, x)
                wrt = params + ([x] if x.requires_grad else [])
                gs = torch.autograd.grad(y, wrt, g_in, allow_unused=True)
            for a, g in zip(acc, gs[:len(params)]):
                if g is not None:
                    a.add_(g)
            if s > 0:
                prev = gs[-1]
            elif d_mb is not None:
                d_mb[i] = gs[-1]
        return (None, d_mb, *[a[None] for a in acc])


def pipeline_apply(stage_params: Any, microbatches: torch.Tensor, *, mesh: Mesh,
                   stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], axis: str = "pp",
                   dp_axis: Optional[str] = None, param_specs: Optional[Any] = None
                   ) -> torch.Tensor:
    """Run ``microbatches`` (n_micro, *mb_shape) through the pipeline, the
    GPipe forward (module docstring).  ``stage_params``: this rank's stage
    from :func:`stack_pipeline_stages`; ``stage_fn(params_of_stage, x) ->
    y`` applies one stage (the leaves without their stage dimension),
    keeping the microbatch shape.  Returns the (n_micro, *mb_shape) outputs
    of the last stage on every rank (with ``dp_axis``, the rank's piece of
    dim 1, marked)."""
    leaves, unflatten, _ = _local_stage(stage_params, mesh, axis, param_specs)
    mb = _local_micro(microbatches, mesh, dp_axis)
    with mesh:
        out = _PipeApply.apply((mesh.axes[axis], stage_fn, unflatten), mb, *leaves)
    if dp_axis is not None:
        mark_sharded(out, NamedSharding(mesh, (None, dp_axis)), microbatches.shape)
    return out


def pipeline_train_step(stage_params: Any, microbatches: torch.Tensor, targets: Any, *,
                        mesh: Mesh, stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                        loss_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                        axis: str = "pp", dp_axis: Optional[str] = None,
                        param_specs: Optional[Any] = None) -> tuple:
    """One pipelined forward and backward, the 1F1B schedule (module
    docstring): returns ``(loss, grads)``.  Per tick ``t`` stage ``s`` runs
    the forward of microbatch ``t - s`` (stashing its input) and the
    backward of microbatch ``t - 2 * (n_stages - 1) + s``.
    ``loss_fn(y, target) -> scalar``, the mean over its microbatch, runs on
    the last stage; ``targets``' leading dims match the microbatches'.
    ``loss`` is replicated; ``grads`` has ``stage_params``' structure and
    layout (each leaf the rank's ``(1, ...)`` piece, marked), averaged over
    the microbatches and over ``dp_axis``."""
    ax = mesh.axes[axis]
    n_stages, s = ax.size, ax.index
    leaves, unflatten, shardings = _local_stage(stage_params, mesh, axis, param_specs)
    mb = _local_micro(microbatches, mesh, dp_axis)
    tgt = _local_micro(targets, mesh, dp_axis)
    n_micro = mb.shape[0]
    depth = 2 * n_stages - 1
    last = s == n_stages - 1
    params = _param_views(leaves)
    p = unflatten(params)
    acc = [torch.zeros_like(q) for q in params]
    loss_acc = torch.zeros((), dtype=torch.float32, device=mb.device)
    stash = [None] * depth
    prev_f = prev_b = None
    ticks = n_micro + 2 * (n_stages - 1)
    record_collective("exchange", ax, payload_bytes=mb.numel() * mb.element_size() // n_micro,
                      count=2 * ticks, axis_size=n_stages, senders=n_stages - 1)
    record_collective("all_reduce", ax, payload_bytes=4, axis_size=n_stages)
    with mesh:
        for t in range(ticks):
            i_f = t - s
            i_b = t - 2 * (n_stages - 1) + s
            valid_f, valid_b = 0 <= i_f < n_micro, 0 <= i_b < n_micro
            recv_f = _send_recv(ax, prev_f, not last and 0 <= i_f - 1 < n_micro,
                                s > 0 and valid_f, True, mb[0])
            recv_b = _send_recv(ax, prev_b, s > 0 and 0 <= i_b - 1 < n_micro,
                                not last and valid_b, False, mb[0])
            prev_f = prev_b = None
            if valid_f:  # the forward micro-op (the last stage's is its backward's)
                x_in = mb[i_f] if s == 0 else recv_f
                stash[i_f % depth] = x_in
                if not last:
                    with torch.no_grad():
                        prev_f = stage_fn(p, x_in)
            if valid_b:  # the backward micro-op, recomputed from the stash
                with torch.enable_grad():
                    x = stash[i_b % depth].detach().requires_grad_(s > 0)
                    y = stage_fn(p, x)
                    wrt = params + ([x] if s > 0 else [])
                    if last:
                        loss = loss_fn(y, collectives._map(lambda a: a[i_b], tgt))
                        gs = torch.autograd.grad(loss, wrt, allow_unused=True)
                        loss_acc += loss.detach().float()
                    else:
                        gs = torch.autograd.grad(y, wrt, recv_b, allow_unused=True)
                for a, g in zip(acc, gs[:len(params)]):
                    if g is not None:
                        a.add_(g)
                if s > 0:
                    prev_b = gs[-1]
        with muted():
            loss = collectives.broadcast(loss_acc, ax, n_stages - 1) / n_micro
        grads = [a / n_micro for a in acc]
        if dp_axis is not None:
            n_dp = mesh.shape[dp_axis]
            record_collective("pmean", dp_axis, grads, axis_size=n_dp)
            record_collective("pmean", dp_axis, loss, axis_size=n_dp)
            with muted():
                loss = collectives.all_mean(loss, dp_axis)
                grads = collectives.all_mean(grads, dp_axis)
    return loss, unflatten(_stacked(grads, shardings))
