"""Moving live state from one mesh to another, counterpart of
``torchdistx_tpu/parallel/reshard.py``: the elastic half of the parallel
stack (a lost rank shrinks the mesh, ``Trainer.reshard``).

A tree here is a dict, list or tuple of tensors, each the rank's piece of
a whole tensor as ``parallel.mesh.sharding_of`` marks it (an unmarked
tensor is whole, on every rank); a target is a ``NamedSharding`` for
every leaf or a tree of them.  The closed forms are pure arithmetic over
shapes and shardings (an :class:`~.mesh.AbstractMesh` will do), held to
the JAX module's numbers (arXiv:2112.01075's redistribution model): per
leaf of ``S`` bytes, with the source and target split counts per
dimension, ``keep = prod_d gcd(src_d, tgt_d)`` and ``g = n_src / keep``;
each group of ``g`` source pieces is gathered into a target piece, a ring
all-gather of ``S * (g - 1) / g`` wire bytes, and ``g == 1`` (the same
layout, a replicated source, a pure re-slice) moves nothing.

Two paths, chosen by :func:`can_reshard_live`:

- live (:func:`reshard`): the target mesh's ranks hold every piece.  A
  survivor whose held piece contains its target piece cuts it locally;
  otherwise the old mesh's ranks all-gather the leaf (every one of them
  takes part, the simulated lost ranks included) and the survivors cut.
- checkpoint bounce (:func:`reshard_via_checkpoint`): some pieces lived
  only on lost ranks.  Every rank of the old mesh takes part in the save
  (each sharded tensor is gathered and saved whole; the world's rank 0
  writes), a barrier over the world follows, and the target mesh's ranks
  restore straight into their pieces (``restore_checkpoint(shardings=)``).
  A real loss would restore the latest health-gated checkpoint instead.

Both return the new tree on the target mesh's ranks, None on a rank
outside it.  :func:`optimizer_state_tree` and :func:`write_back` turn a
module and a torch optimizer into such a tree and back (each slot shaped
like the tensor the optimizer holds takes that tensor's sharding, the
rest are replicated); :func:`reshard_to_plan` moves both onto a plan's
placements.  A migration books its closed form into the active comm
audit (``obs.comm``), as the JAX module does: the live path one
``all_gather`` of each moving leaf's bytes over a group of ``g``, filed
under the source's axes; the bounce one ``broadcast`` of each leaf over
the target mesh.  ``collectives.payload_bytes`` counts the gathers it
actually runs.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..obs.comm import record_collective
from . import collectives
from .mesh import AbstractMesh, NamedSharding, mark_sharded, sharding_of, shard_tensor
from .multihost import process_index
from .plan import gather_full

__all__ = [
    "plan_reshard",
    "plan_transition_wire_bytes",
    "split_counts",
    "reshard",
    "reshard_to_plan",
    "reshard_wire_bytes",
    "devices_hold_full_copy",
    "can_reshard_live",
    "reshard_via_checkpoint",
    "optimizer_state_tree",
    "state_targets",
    "write_back",
]


def _is_sharding(x: Any) -> bool:
    return isinstance(x, NamedSharding)


def _leaves(tree: Any) -> list:
    return collectives.tree_flatten(tree, is_leaf=_is_sharding)[0]


def _source(leaf: torch.Tensor) -> tuple:
    """``(sharding or None, global shape)`` of a leaf."""
    found = sharding_of(leaf)
    return found if found is not None else (None, tuple(leaf.shape))


def _leaf_bytes(leaf: torch.Tensor) -> int:
    return int(math.prod(_source(leaf)[1])) * leaf.element_size()


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def split_counts(shape, sharding: Optional[NamedSharding]) -> tuple:
    """Per-dimension split counts of ``sharding`` over ``shape`` (all 1s for
    a replicated or unmarked placement)."""
    if sharding is None:
        return tuple(1 for _ in shape)
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    return tuple(math.prod(int(sharding.mesh.shape[a]) for a in _entry_axes(e))
                 for e in spec[:len(shape)])


def _axis_label(sharding: Optional[NamedSharding]) -> str:
    names = [a for e in (sharding.spec if sharding is not None else ()) for a in _entry_axes(e)]
    return "+".join(names) if names else "reshard"


def _targets(tree: Any, shardings: Any) -> list:
    leaves = _leaves(tree)
    targets = [shardings] * len(leaves) if _is_sharding(shardings) else _leaves(shardings)
    if len(leaves) != len(targets):
        raise ValueError(f"shardings tree has {len(targets)} leaves for a state tree "
                         f"of {len(leaves)} tensors")
    return list(zip(leaves, targets))


def plan_reshard(tree: Any, shardings: Any) -> list:
    """The per-leaf redistribution plan (module docstring): one ``{"axis",
    "nbytes", "gather_group", "wire_bytes"}`` dict per leaf that must move
    data over the wire (``g > 1``); host arithmetic only."""
    plan = []
    for leaf, target in _targets(tree, shardings):
        if not isinstance(leaf, torch.Tensor):
            continue
        src_sh, shape = _source(leaf)
        src, tgt = split_counts(shape, src_sh), split_counts(shape, target)
        n_src = math.prod(src)
        keep = math.prod(math.gcd(a, b) for a, b in zip(src, tgt))
        if n_src <= keep:
            continue  # a replicated source or a preserved layout: a local slice
        g = n_src // keep
        nbytes = _leaf_bytes(leaf)
        plan.append({"axis": _axis_label(src_sh), "nbytes": nbytes, "gather_group": g,
                     "wire_bytes": nbytes * (g - 1) // g})
    return plan


def reshard_wire_bytes(tree: Any, shardings: Any) -> int:
    """The closed-form wire bytes of moving ``tree`` into ``shardings``."""
    return sum(p["wire_bytes"] for p in plan_reshard(tree, shardings))


def _block(sharding: Optional[NamedSharding], shape, rank: int) -> Optional[tuple]:
    """The global ``(start, stop)`` per dimension of ``rank``'s piece under
    ``sharding`` (None when ``rank`` is not in its mesh)."""
    if sharding is None:
        return tuple((0, s) for s in shape)
    mesh = sharding.mesh
    where = np.argwhere(mesh.devices == rank)
    if not len(where):
        return None
    coord = dict(zip(mesh.axis_names, (int(c) for c in where[0])))
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    out = []
    for size, entry in zip(shape, spec):
        n, idx = 1, 0
        for a in _entry_axes(entry):
            n, idx = n * int(mesh.shape[a]), idx * int(mesh.shape[a]) + coord[a]
        step = size // n
        out.append((idx * step, (idx + 1) * step))
    return tuple(out)


def _ranks(mesh) -> set:
    return {int(r) for r in np.asarray(mesh.devices).flat}


def devices_hold_full_copy(leaf: torch.Tensor, devices: Iterable[int]) -> bool:
    """Whether the ranks ``devices`` together hold every piece of ``leaf``:
    the per-leaf test behind :func:`can_reshard_live`.  An unmarked leaf
    is whole on every rank."""
    sh, shape = _source(leaf)
    if sh is None:
        return True
    devices = set(devices)
    blocks = {r: _block(sh, shape, r) for r in _ranks(sh.mesh)}
    return {b for r, b in blocks.items() if r in devices} == set(blocks.values())


def can_reshard_live(tree: Any, target: Any) -> bool:
    """Can every leaf of ``tree`` be rebuilt from the ranks of ``target``
    (a mesh, a ``NamedSharding`` or a tree of them) alone?  False: some
    piece lived only on lost ranks, and the state takes the checkpoint
    bounce."""
    if isinstance(target, AbstractMesh):
        devices = _ranks(target)
    else:
        devices = set()
        for sh in _leaves(target):
            devices |= _ranks(sh.mesh)
    return all(devices_hold_full_copy(leaf, devices) for leaf in _leaves(tree)
               if isinstance(leaf, torch.Tensor))


def _local_ok(src_sh, target, shape) -> bool:
    """Whether every rank of the target mesh holds its target piece in its
    source piece (decided alike on every rank, from the layouts alone)."""
    for r in _ranks(target.mesh):
        held, want = _block(src_sh, shape, r), _block(target, shape, r)
        if held is None or any(w0 < h0 or w1 > h1 for (h0, h1), (w0, w1) in zip(held, want)):
            return False
    return True


def reshard(tree: Any, shardings: Any) -> Any:
    """Move a live tree into ``shardings`` (one for every leaf, or a tree of
    them) on their mesh: the live path (module docstring), each moving
    leaf's gather booked into the active comm audit.  Every rank of the
    source and target meshes calls it; returns the new tree on the target
    mesh's ranks, None elsewhere."""
    for p in plan_reshard(tree, shardings):
        record_collective("all_gather", p["axis"], payload_bytes=p["nbytes"],
                          axis_size=p["gather_group"])
    unflatten = collectives.tree_flatten(tree)[1]
    pairs = _targets(tree, shardings)
    member = pairs[0][1].mesh.is_member if pairs else True
    out = []
    for leaf, target in pairs:
        src_sh, shape = _source(leaf)
        if _local_ok(src_sh, target, shape):
            if member:  # the target piece out of the held one: no wire bytes
                held = _block(src_sh, shape, process_index())
                want = _block(target, shape, process_index())
                piece = leaf[tuple(slice(w0 - h0, w1 - h0)
                                   for (h0, _), (w0, w1) in zip(held, want))]
                if piece.shape != leaf.shape:
                    piece = piece.clone()
                out.append(mark_sharded(piece, target, shape))
            continue
        full = gather_full(leaf, src_sh)
        if member:
            out.append(shard_tensor(full, target))
    return unflatten(out) if member else None


def reshard_via_checkpoint(tree: Any, path: str, shardings: Any) -> Any:
    """The bounce path (module docstring): save ``tree`` on its mesh (every
    rank of it calls this), then restore it into ``shardings`` on the
    target mesh's ranks; None elsewhere.  Books one broadcast of each leaf
    over the target mesh's ranks (``(n - 1) / n`` of its bytes)."""
    from ..utils.checkpoint import restore_checkpoint, save_checkpoint

    for leaf, target in _targets(tree, shardings):
        n = target.mesh.size
        if isinstance(leaf, torch.Tensor) and n > 1:
            record_collective("broadcast", _axis_label(target),
                              payload_bytes=_leaf_bytes(leaf), axis_size=n)

    save_checkpoint(path, tree)
    if dist.is_initialized():
        collectives.barrier()
    first = shardings if _is_sharding(shardings) else _leaves(shardings)[0]
    if not first.mesh.is_member:
        return None
    device = next((t.device for t in _leaves(tree) if isinstance(t, torch.Tensor)), "cpu")
    return restore_checkpoint(path, map_location=device, shardings=shardings)


# -- modules and torch optimizers as trees ---------------------------------------


def _named(params: Any) -> dict:
    return dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)


def _held_name(opt, named: dict) -> dict:
    """``{id(held tensor): parameter name}`` of a torch optimizer."""
    name_of = {id(p): n for n, p in named.items()}
    out = {}
    for group in opt.param_groups:
        for t in group["params"]:
            out[id(t)] = getattr(t, "_tdx_path", None) or name_of.get(id(t))
    return out


def optimizer_state_tree(opt, params: Any) -> dict:
    """``{name: {slot: tensor}}`` of a torch optimizer's state tensors, each
    marked (in place) with the placement it has: the optimizer's own
    (``opt.state_sharding(held, slot)``: a placed 8-bit AdamW's pieces of
    its blockwise arrays), else its held tensor's when shaped like it, else
    replicated on that tensor's mesh."""
    named = _named(params)
    names = _held_name(opt, named)
    placed = getattr(opt, "state_sharding", None)
    out = {}
    for held, slots in opt.state.items():
        found = sharding_of(held)
        row = {}
        for slot, t in slots.items():
            if not isinstance(t, torch.Tensor):
                continue
            own = placed(held, slot) if placed is not None else None
            if own is not None:
                mark_sharded(t, *own)
            elif found is not None:
                if t.shape == held.shape:
                    mark_sharded(t, *found)
                else:
                    mark_sharded(t, NamedSharding(found[0].mesh, ()), t.shape)
            row[slot] = t
        out[names[id(held)]] = row
    return out


def write_back(params: Any, opt, new: dict) -> None:
    """Put a moved ``{"params": {name: piece}, "opt_state": {name: {slot:
    piece}}}`` into the live module (``param.data``, so the optimizer keeps
    its keys) and optimizer, in place."""
    named = _named(params)
    with torch.no_grad():
        for name, piece in new.get("params", {}).items():
            p = named[name]
            if piece is not p:
                p.data = piece.detach()
            mark_sharded(p, *sharding_of(piece))
    if opt is None or "opt_state" not in new:
        return
    names = _held_name(opt, named)
    for held, slots in opt.state.items():
        for slot, piece in new["opt_state"].get(names[id(held)], {}).items():
            slots[slot] = piece


def state_targets(tree: dict, param_target, slot_target=None) -> dict:
    """Targets of a ``{"params", "opt_state"}`` tree: each parameter's
    ``param_target(name, p)``; each slot ``slot_target(name, slot, leaf)``
    where that gives one (a step's ``state_placement_on``: the 8-bit
    AdamW's blockwise arrays, ZeRO-2's ``dp`` slices), else its
    parameter's when shaped like the parameter's piece (``param`` or a
    held slice), else replicated on that target's mesh."""
    out = {"params": {n: param_target(n, p) for n, p in tree["params"].items()}}
    if "opt_state" in tree:
        rows = {}
        for name, slots in tree["opt_state"].items():
            tgt = out["params"][name]
            shape = _source(tree["params"][name])[1]
            rows[name] = {}
            for slot, t in slots.items():
                own = slot_target(name, slot, t) if slot_target is not None else None
                if own is not None:
                    rows[name][slot] = own
                    continue
                same = tuple(_source(t)[1]) == tuple(shape)
                rows[name][slot] = tgt if same else NamedSharding(tgt.mesh, ())
        out["opt_state"] = rows
    return out


def plan_transition_wire_bytes(params: Any, target_plan: Any, *,
                               optimizer_state: Any = None) -> int:
    """The closed-form wire bytes of moving the parameters (and the
    optimizer's state) from where they sit into ``target_plan``'s
    placements: what :func:`reshard_to_plan` moves."""
    tree, targets = _plan_tree(params, target_plan, optimizer_state)
    return reshard_wire_bytes(tree, targets)


def _plan_tree(params, target_plan, opt) -> tuple:
    tree = {"params": _named(params)}
    if opt is not None:
        tree["opt_state"] = optimizer_state_tree(opt, params)
    return tree, state_targets(tree, target_plan.sharding_for)


def reshard_to_plan(params: Any, target_plan: Any, *, optimizer_state: Any = None):
    """Move a module's parameters (and its torch optimizer's state) into
    ``target_plan``'s placements (typically ``old_plan.with_mesh(new)``),
    in place, by the live path, each leaf's gather booked as
    :func:`reshard` books it.  Returns ``params`` (or ``(params,
    optimizer_state)``)."""
    tree, targets = _plan_tree(params, target_plan, optimizer_state)
    new = reshard(tree, targets)
    if new is not None:
        write_back(params, optimizer_state, new)
    return params if optimizer_state is None else (params, optimizer_state)
