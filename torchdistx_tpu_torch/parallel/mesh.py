"""Device meshes over the ranks of ``torch.distributed``, counterpart of
``torchdistx_tpu/parallel/mesh.py``.

A JAX mesh names axes over devices; here it names axes over ranks (one
process per card), and each axis gets one process group per line of the
mesh along it, made when the mesh is made (every rank makes every group,
in the same order, as ``torch.distributed.new_group`` requires).  An axis
of size 1 has no group: every collective over it is the identity.  With
no process group initialized the world is one rank, so a mesh of size-1
axes works without one.

A ``Mesh`` is a context manager, as a JAX ``Mesh`` is: collectives
(``parallel.collectives``) resolve an axis name through the innermost
active mesh that has it.  The stack of active meshes is the process's,
not the thread's, because autograd runs a CUDA backward on threads of its
own.  A "sharding" is ``NamedSharding(mesh, spec)``, ``spec`` the
per-dimension axis names (None, a name, or a tuple of names), as a
``PartitionSpec``; ``shard_slices`` cuts a tensor's shape to this rank's
piece of it.

Axis conventions: ``dp`` data parallel, ``fsdp`` parameter and optimizer
sharding, ``tp`` tensor parallel, ``sp`` sequence parallel, ``node`` and
``local`` the two-level hierarchy of GossipGraD and SlowMo.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch.distributed as dist

from .multihost import process_count, process_index

__all__ = [
    "Mesh",
    "NamedSharding",
    "create_mesh",
    "hierarchical_mesh",
    "mesh_sharding",
    "replicated",
    "local_mesh_size",
    "shard_tensor",
    "mark_sharded",
    "sharding_of",
]

_ACTIVE: list = []


class Axis(NamedTuple):
    """One mesh axis as this rank sees it: its size, this rank's index
    along it, the global ranks of its line (in axis order) and their
    process group (None at size 1)."""

    name: str
    size: int
    index: int
    ranks: tuple
    group: Optional[object]

    def rank_of(self, index: int) -> int:
        return self.ranks[index]


class Mesh:
    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=np.int64)
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of rank {devices.ndim} for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.size = int(devices.size)
        rank = process_index()
        self.axes = {}
        for i, name in enumerate(self.axis_names):
            lines = np.moveaxis(devices, i, -1).reshape(-1, devices.shape[i])
            for line in lines:
                ranks = tuple(int(r) for r in line)
                group = dist.new_group(list(ranks)) if len(ranks) > 1 else None
                if rank in ranks:
                    self.axes[name] = Axis(name, len(ranks), ranks.index(rank), ranks, group)
        if len(self.axes) != len(self.axis_names):
            raise ValueError(f"rank {rank} is not in the mesh {devices.tolist()}")

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.pop()


def resolve_axis(axis) -> Axis:
    """The :class:`Axis` named ``axis`` in the innermost active mesh that has
    it (an ``Axis`` passes through)."""
    if isinstance(axis, Axis):
        return axis
    for mesh in reversed(_ACTIVE):
        if axis in mesh.axes:
            return mesh.axes[axis]
    raise NameError(f"unbound axis name: {axis!r} (enter a Mesh that has it)")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``mesh`` and ``spec``: per dimension None (replicated), an axis name,
    or a tuple of names (the dimension split over their product, the first
    name major), as ``jax.sharding.NamedSharding``."""

    mesh: Mesh
    spec: tuple = ()

    def _split(self, entry):
        names = entry if isinstance(entry, tuple) else (entry,)
        n, idx = 1, 0
        for name in names:
            ax = self.mesh.axes[name]
            n, idx = n * ax.size, idx * ax.size + ax.index
        return n, idx

    def shard_slices(self, shape) -> tuple:
        """This rank's piece of a tensor of ``shape``, as slices."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} is longer than shape {tuple(shape)}")
        out = []
        for d, size in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            if entry is None:
                out.append(slice(None))
                continue
            n, idx = self._split(entry)
            if n == 1:
                out.append(slice(None))
                continue
            if size % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide over {entry} ({n})")
            step = size // n
            out.append(slice(idx * step, (idx + 1) * step))
        return tuple(out)


def create_mesh(axis_sizes: dict, *, devices: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh from ``{axis_name: size}`` over ``devices`` (ranks; default
    every rank of the world).  One size of -1 takes the ranks left over,
    like a reshape wildcard: ``create_mesh({"dp": -1, "sp": 4})``."""
    devs = list(devices) if devices is not None else list(range(process_count()))
    names, sizes = list(axis_sizes), list(axis_sizes.values())
    n = len(devs)
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes product {known}")
        sizes[sizes.index(-1)] = n // known
    total = math.prod(sizes)
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} wants {total} devices, have {n}")
    return Mesh(np.array(devs).reshape(sizes), names)


def hierarchical_mesh(num_nodes: int, *, devices: Optional[Sequence[int]] = None) -> Mesh:
    """The GossipGraD / SlowMo two-level topology ``("node", "local")``."""
    devs = list(devices) if devices is not None else list(range(process_count()))
    if len(devs) % num_nodes != 0:
        raise ValueError(f"{len(devs)} devices not divisible into {num_nodes} nodes")
    return create_mesh({"node": num_nodes, "local": len(devs) // num_nodes}, devices=devs)


def mesh_sharding(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def local_mesh_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def shard_tensor(full, sharding: Optional[NamedSharding]):
    """This rank's piece of ``full`` under ``sharding`` (a copy when the
    sharding cuts it; ``full`` itself when it does not), marked with the
    sharding and the global shape for :func:`sharding_of`."""
    if sharding is None:
        return full
    slices = sharding.shard_slices(full.shape)
    cut = any(s != slice(None) for s in slices)
    piece = full[slices].clone() if cut else full
    return mark_sharded(piece, sharding, full.shape)


def mark_sharded(t, sharding: NamedSharding, global_shape):
    """Record on ``t`` (a tensor or ``nn.Parameter``) that it is this rank's
    piece of a ``global_shape`` tensor under ``sharding``."""
    t._tdx_sharding = sharding
    t._tdx_global_shape = tuple(global_shape)
    return t


def sharding_of(t) -> Optional[tuple]:
    """``(sharding, global_shape)`` of a tensor made by :func:`shard_tensor`
    (or a sharded ``materialize_module``), else None."""
    sh = getattr(t, "_tdx_sharding", None)
    return None if sh is None else (sh, t._tdx_global_shape)
