"""Collectives over mesh axes, counterpart of
``torchdistx_tpu/parallel/collectives.py``.

The JAX functions are XLA collectives inside ``shard_map``; these are
``torch.distributed`` calls on the process group of a mesh axis, and run
wherever the axis is bound (an active :class:`~.mesh.Mesh`).  ``axis`` is
an axis name or a resolved :class:`~.mesh.Axis`; the reductions also take
a tuple of names, reduced one after another.  Each function takes a
tensor, or a list, tuple or dict of them, and returns new tensors (the
inputs are never written).  Over an axis of size 1 every collective is the
identity: a ring of one block, a sum over one rank.

Differentiable, as the ring and the sharded step need them: ``shift``
(backward: the opposite shift), ``allreduce_linear`` (Megatron's ``g``:
all-reduce forward, identity backward) and ``copy_psum_grad`` (Megatron's
``f``: identity forward, all-reduce backward).  The others carry no
gradient.

NCCL refuses a send to one's own rank, so ``exchange`` and ``shift`` keep
a self-edge local (a copy).

``gloo`` takes CUDA tensors for its reductions, broadcasts and gathers,
but its point-to-point transport writes the tensor's raw address to a
socket, and a device address fails there ("Bad address").  So on a
``gloo`` group the sends and receives of CUDA tensors (``exchange``,
``shift``) go through pinned host buffers: decided from the group's
backend and the tensor's device before anything is sent, and counted in
``_permute.staged_bytes`` (bytes sent plus bytes received through the
host).  One card can hold a multi-rank world only on ``gloo`` (NCCL
refuses two ranks on one device); on NCCL nothing is staged.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from .mesh import Axis, resolve_axis

__all__ = [
    "all_reduce",
    "all_mean",
    "broadcast",
    "exchange",
    "shift",
    "all_gather",
    "reduce_scatter",
    "allreduce_linear",
    "copy_psum_grad",
    "axis_index",
    "axis_size",
]


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    raise TypeError(f"collectives take tensors, lists, tuples and dicts, not {type(tree)}")


def _axes(axis) -> list:
    names = axis if isinstance(axis, tuple) and not isinstance(axis, Axis) else (axis,)
    return [resolve_axis(a) for a in names]


def _psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    if ax.size == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, group=ax.group)
    return out


def all_reduce(tree: Any, axis) -> Any:
    """Sum over the axis (or axes)."""
    axes = _axes(axis)

    def one(x):
        for ax in axes:
            x = _psum(x, ax)
        return x

    return _map(one, tree)


def all_mean(tree: Any, axis) -> Any:
    """Mean over the axis (or axes): the reference's default allreduce hook
    divides the sum by the world size."""
    axes = _axes(axis)

    def one(x):
        for ax in axes:
            x = _psum(x, ax) / ax.size if ax.size > 1 else x
        return x

    return _map(one, tree)


def broadcast(tree: Any, axis, source: int = 0) -> Any:
    """``source``'s value (an index along the axis) to every member."""
    ax = resolve_axis(axis)

    def one(x):
        if ax.size == 1:
            return x
        out = x.clone().contiguous()
        dist.broadcast(out, src=ax.rank_of(source), group=ax.group)
        return out

    return _map(one, tree)


def _staged(x: torch.Tensor, ax: Axis) -> bool:
    """Whether point-to-point traffic of ``x`` over ``ax`` goes through the
    host: a CUDA tensor on a ``gloo`` group."""
    return x.is_cuda and dist.get_backend(ax.group) == "gloo"


def _pinned(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)


def _permute(xs, ax: Axis, dst: int, src: int, fill: str) -> list:
    """Send each of ``xs`` to member ``dst`` and receive from member ``src``
    (-1: none), all in one batch; a self-edge is a local copy."""
    xs = [x.contiguous() for x in xs]
    keep = src == ax.index or (src < 0 and fill == "self")
    outs = [x.clone() if keep else torch.zeros_like(x) for x in xs]
    send = dst >= 0 and dst != ax.index
    recv = src >= 0 and src != ax.index
    if not xs or not (send or recv):
        return outs
    staged = _staged(xs[0], ax)
    wire_in = [_pinned(x).copy_(x) for x in xs] if staged and send else xs
    wire_out = [_pinned(o) for o in outs] if staged and recv else outs
    ops = []
    if send:
        ops += [dist.P2POp(dist.isend, x, ax.rank_of(dst), ax.group) for x in wire_in]
    if recv:
        ops += [dist.P2POp(dist.irecv, o, ax.rank_of(src), ax.group) for o in wire_out]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        if recv:
            for o, w in zip(outs, wire_out):
                o.copy_(w)
        _permute.staged_bytes += sum(x.numel() * x.element_size() for x in xs) * (send + recv)
    return outs


_permute.staged_bytes = 0


def exchange(tree: Any, axis, send_to: Sequence[int], recv_from: Sequence[int], *,
             fill: str = "self") -> Any:
    """Point-to-point exchange: member i sends its value to ``send_to[i]``
    (-1: to nobody) and receives from ``recv_from[i]``, which must agree
    with ``send_to``.  A member nobody sends to keeps its own value
    (``fill="self"``) or gets zeros (``fill="zero"``).  Every tensor of the
    tree goes in one batch of sends and receives."""
    if fill not in ("self", "zero"):
        raise ValueError(f"fill must be 'self' or 'zero', got {fill!r}")
    ax = resolve_axis(axis)
    if len(send_to) != ax.size:
        raise ValueError(f"send_to has {len(send_to)} entries for an axis of {ax.size}")
    implied = {int(d): i for i, d in enumerate(send_to) if int(d) >= 0}
    if recv_from is not None:
        for i, src in enumerate(recv_from):
            if int(src) >= 0 and implied.get(i) != int(src):
                raise ValueError(
                    f"inconsistent peer lists: member {i} expects to receive "
                    f"from {src} but the send permutation delivers {implied.get(i)}")
    dst, src = int(send_to[ax.index]), implied.get(ax.index, -1)
    leaves = []
    _map(leaves.append, tree)
    it = iter(_permute(leaves, ax, dst, src, fill))
    return _map(lambda _: next(it), tree)


class _Shift(torch.autograd.Function):
    """Every leaf in one batch of sends and receives; the backward shifts
    the other way, zeros standing in for an unused output, so that every
    rank sends and receives the same messages in the same order."""

    @staticmethod
    def forward(ctx, ax, offset, *xs):
        ctx.ax, ctx.offset = ax, offset
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(_permute(xs, ax, (ax.index + offset) % ax.size,
                              (ax.index - offset) % ax.size, "zero"))

    @staticmethod
    def backward(ctx, *gs):
        ax, off = ctx.ax, ctx.offset
        gs = [torch.zeros(shape, dtype=dt, device=dev) if g is None else g
              for g, (shape, dt, dev) in zip(gs, ctx.like)]
        return (None, None, *_permute(gs, ax, (ax.index - off) % ax.size,
                                      (ax.index + off) % ax.size, "zero"))


def shift(tree: Any, axis, offset: int = 1) -> Any:
    """Ring shift: member i's value goes to member (i + offset) mod n, every
    tensor of the tree in one batch of sends and receives.  At axis size 1
    the identity (a copy)."""
    ax = resolve_axis(axis)
    leaves = []
    _map(leaves.append, tree)
    it = iter(_Shift.apply(ax, offset, *leaves))
    return _map(lambda _: next(it), tree)


def _gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    if ax.size == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((ax.size * x.shape[0], *x.shape[1:]))
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, x, group=ax.group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    if ax.size == 1:
        return x
    if x.shape[dim] % ax.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {ax.size}")
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // ax.size, *x.shape[1:]))
    rs = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
    rs(out, x, group=ax.group)
    return out.movedim(0, dim)


def all_gather(tree: Any, axis, tiled_axis: int = 0) -> Any:
    """Concatenate every member's value along ``tiled_axis``, in axis order
    (``lax.all_gather(tiled=True)``)."""
    ax = resolve_axis(axis)
    return _map(lambda x: _gather(x, ax, tiled_axis), tree)


def reduce_scatter(tree: Any, axis, scatter_axis: int = 0) -> Any:
    """Sum over the axis, then keep this member's slice of ``scatter_axis``
    (``lax.psum_scatter(tiled=True)``)."""
    ax = resolve_axis(axis)
    return _map(lambda x: _reduce_scatter(x, ax, scatter_axis), tree)


def _all_to_all(x: torch.Tensor, ax: Axis, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: split ``split_axis`` into n chunks,
    send chunk r to member r, and concatenate what arrives along
    ``concat_axis`` in member order."""
    if ax.size == 1:
        return x
    n = ax.size
    chunks = x.chunk(n, dim=split_axis)
    inp = torch.stack(chunks, 0).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=ax.group)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, split_axis, concat_axis):
        ctx.args = ax, split_axis, concat_axis
        return _all_to_all(x, ax, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        ax, split_axis, concat_axis = ctx.args
        return _all_to_all(g, ax, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, axis, split_axis: int, concat_axis: int) -> torch.Tensor:
    """The differentiable tiled all-to-all of Ulysses attention (not among
    the JAX module's names, which calls ``lax.all_to_all`` in place)."""
    return _AllToAll.apply(x, resolve_axis(axis), split_axis, concat_axis)


class _AllreduceLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        for ax in axes:
            x = _psum(x, ax)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyPsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return x

    @staticmethod
    def backward(ctx, g):
        for ax in ctx.axes:
            g = _psum(g, ax)
        return g, None


def allreduce_linear(tree: Any, axis) -> Any:
    """All-reduce whose backward is the identity (Megatron's ``g``, after a
    row-parallel product): the cotangent arriving is already replicated."""
    axes = _axes(axis)
    return _map(lambda x: _AllreduceLinear.apply(x, axes), tree)


def copy_psum_grad(tree: Any, axis) -> Any:
    """Identity whose backward is an all-reduce (Megatron's ``f``, where a
    replicated activation enters a tensor-parallel region)."""
    axes = _axes(axis)
    return _map(lambda x: _CopyPsumGrad.apply(x, axes), tree)


def axis_index(axis) -> int:
    return resolve_axis(axis).index


def axis_size(axis) -> int:
    return resolve_axis(axis).size
