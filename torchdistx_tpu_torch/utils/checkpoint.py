"""Checkpoint / resume, counterpart of ``torchdistx_tpu/utils/checkpoint.py``.

The reference ships no checkpoint subsystem of its own: its components
implement ``state_dict`` / ``load_state_dict`` and are exercised end to end
with ``torch.save`` / ``torch.load`` and a device ``map_location``
(reference tests/python/test_comm_hooks_fsdp.py:262-331).  That protocol
is the port's format: a checkpoint is a directory holding one
``state.pt``.  The write is atomic: the file goes into a temporary
directory beside the target, which is then renamed onto it, so a reader
sees the old checkpoint or the new one, never a torn one.

State is a dict whose values are modules or optimizers (anything with
``state_dict``: saved as its state dict), tensors, or plain Python
values.  ``restore_checkpoint(path, like=state)`` loads each entry into
the live object of the same key (``load_state_dict``, on the object's own
device) and returns the dict with the live objects in place.

Sharded state (``parallel``: a tensor marked as this rank's piece by
``parallel.mesh.sharding_of``, a module's marked parameters, an
optimizer's slots shaped like its marked tensors) is saved whole: every
rank of the mesh calls ``save_checkpoint``, each sharded tensor is
all-gathered, and in a world of several ranks only rank 0 writes (a
reader on another rank syncs with it first).  A checkpoint is therefore
the same file whatever mesh wrote it, and a restore cuts each rank's
piece straight into the layout it is given: ``shardings=`` (one
``NamedSharding`` for every tensor, or a tree of them like the saved
state's), ``shardings_from=`` (a tree whose tensors carry the target
marks), or, by default with ``like``, the live objects' own placements.
A checkpoint written on mesh A restores onto mesh B bit for bit.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "save_module", "load_module"]

_FILE = "state.pt"


def _whole(t: torch.Tensor, found=None) -> torch.Tensor:
    """``t`` gathered to its whole tensor when a sharding marks it (or
    ``found`` is given), else ``t``; detached."""
    from ..parallel.mesh import sharding_of
    from ..parallel.plan import gather_full

    found = found if found is not None else sharding_of(t)
    return gather_full(t, found[0]) if found is not None else t.detach()


def _held(opt) -> list:
    return [p for g in opt.param_groups for p in g["params"]]


def _optimizer_whole(opt) -> dict:
    """An optimizer's state dict with each slot shaped like its marked held
    tensor gathered whole."""
    from ..parallel.mesh import sharding_of

    sd = opt.state_dict()
    held = _held(opt)
    for i, st in sd["state"].items():
        found = sharding_of(held[i])
        if found is None:
            continue
        sd["state"][i] = {k: _whole(v, found) if isinstance(v, torch.Tensor)
                          and v.shape == held[i].shape else v for k, v in st.items()}
    return sd


def _as_saved(v: Any) -> Any:
    if isinstance(v, torch.nn.Module):
        return {k: _whole(t) for k, t in v.state_dict(keep_vars=True).items()}
    if isinstance(v, torch.optim.Optimizer):
        return _optimizer_whole(v)
    if hasattr(v, "state_dict") and callable(v.state_dict):
        return v.state_dict()
    if isinstance(v, dict):
        return {k: _as_saved(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_as_saved(x) for x in v)
    if isinstance(v, torch.Tensor):
        return _whole(v)
    return v


def save_checkpoint(path: str, state: Any) -> None:
    """Write ``state`` (a dict; modules and optimizers as their state
    dicts, sharded tensors whole) to the directory ``path``, atomically.
    Every rank of a sharded tensor's mesh must call it; in a world of
    several ranks only rank 0 writes."""
    import torch.distributed as dist

    saved = _as_saved(state)
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.", dir=parent)
    try:
        torch.save(saved, os.path.join(tmp, _FILE))
        if os.path.exists(path):
            old = f"{tmp}.old"
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _device_of(v: Any) -> Optional[torch.device]:
    if isinstance(v, torch.Tensor):
        return v.device
    if isinstance(v, torch.nn.Module):
        t = next(v.parameters(), None)
        return t.device if t is not None else None
    if isinstance(v, torch.optim.Optimizer):
        for g in v.param_groups:
            for p in g["params"]:
                return p.device
    if isinstance(v, dict):
        for x in v.values():
            d = _device_of(x)
            if d is not None:
                return d
    return None


def _piece(full: Any, found) -> Any:
    """This rank's piece of a saved whole tensor under ``found`` =
    ``(sharding, global shape)`` (``full`` itself without one)."""
    from ..parallel.mesh import shard_tensor

    if found is None or not isinstance(full, torch.Tensor):
        return full
    if tuple(full.shape) != tuple(found[1]):
        raise ValueError(f"a saved {tuple(full.shape)} tensor for a {tuple(found[1])} placement")
    return shard_tensor(full, found[0])


def _into(template: Any, saved: Any, where: str) -> Any:
    from ..parallel.mesh import sharding_of

    if isinstance(template, torch.nn.Module):
        live = template.state_dict(keep_vars=True)
        template.load_state_dict({k: _piece(v, sharding_of(live[k])) if k in live else v
                                  for k, v in saved.items()})
        return template
    if isinstance(template, torch.optim.Optimizer):
        held = _held(template)
        state = {}
        for i, st in saved["state"].items():
            found = sharding_of(held[i])
            state[i] = {k: _piece(v, found) if found is not None and isinstance(v, torch.Tensor)
                        and tuple(v.shape) == tuple(found[1]) else v for k, v in st.items()}
        template.load_state_dict({**saved, "state": state})
        return template
    if hasattr(template, "load_state_dict") and callable(template.load_state_dict):
        template.load_state_dict(saved)
        return template
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(template) != set(saved):
            raise ValueError(
                f"checkpoint keys at {where} "
                f"({sorted(saved) if isinstance(saved, dict) else type(saved).__name__})"
                f" do not match `like` keys {sorted(template)}")
        return {k: _into(template[k], saved[k], f"{where}[{k!r}]") for k in template}
    if isinstance(template, torch.Tensor):
        found = sharding_of(template)
        if isinstance(saved, torch.Tensor) and found is not None:
            saved = _piece(saved, found)
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape:
            raise ValueError(f"checkpoint entry at {where} does not match `like`'s shape")
        return saved.to(device=template.device, dtype=template.dtype)
    return saved


def _cut_tree(saved: Any, targets: Any) -> Any:
    """Each saved tensor cut to its target (a ``NamedSharding``, or None:
    whole), ``targets`` one sharding for all or a tree like ``saved``."""
    from ..parallel.mesh import NamedSharding

    if isinstance(targets, NamedSharding) or targets is None:
        if isinstance(saved, dict):
            return {k: _cut_tree(v, targets) for k, v in saved.items()}
        if isinstance(saved, (list, tuple)):
            return type(saved)(_cut_tree(v, targets) for v in saved)
        if isinstance(saved, torch.Tensor) and targets is not None:
            return _piece(saved, (targets, tuple(saved.shape)))
        return saved
    if isinstance(saved, dict):
        return {k: _cut_tree(v, targets[k]) for k, v in saved.items()}
    if isinstance(saved, (list, tuple)):
        return type(saved)(_cut_tree(v, t) for v, t in zip(saved, targets))
    raise ValueError(f"shardings {targets!r} for a saved {type(saved).__name__}")


def _marks(tree: Any) -> Any:
    """The ``NamedSharding`` of each tensor of a live tree (None: whole)."""
    from ..parallel.mesh import sharding_of

    if isinstance(tree, dict):
        return {k: _marks(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_marks(v) for v in tree)
    found = sharding_of(tree) if isinstance(tree, torch.Tensor) else None
    return found[0] if found is not None else None


def restore_checkpoint(path: str, *, like: Any = None, map_location: Any = None,
                       shardings: Any = None, shardings_from: Any = None) -> Any:
    """Read a checkpoint.  With ``like`` (the live state dict), each entry
    loads into ``like``'s object of the same key on that object's device
    (a sharded tensor, parameter or slot as the live one is placed), and
    the result is ``like``'s structure with those objects; without it, the
    saved dict, its tensors on ``map_location`` (default: the CPU), each
    cut to this rank's piece under ``shardings`` (a ``NamedSharding`` for
    every tensor, or a tree like the saved state's with None for whole) or
    as the tensors of ``shardings_from`` are placed."""
    if map_location is None:
        map_location = _device_of(like) if like is not None else "cpu"
    saved = torch.load(os.path.join(os.path.abspath(path), _FILE),
                       map_location=map_location, weights_only=False)
    if shardings_from is not None:
        shardings = _marks(shardings_from)
    if shardings is not None:
        saved = _cut_tree(saved, shardings)
    return saved if like is None else _into(like, saved, "<root>")


def save_module(path: str, module: torch.nn.Module) -> None:
    """Save a module's parameters and buffers (its state dict)."""
    save_checkpoint(path, dict(module.state_dict()))


def load_module(path: str, module: torch.nn.Module, *, strict: bool = True) -> torch.nn.Module:
    """Restore a module's state in place, on its own device; ``strict``
    follows ``Module.load_state_dict``."""
    state = restore_checkpoint(path, map_location=_device_of(module) or "cpu")
    module.load_state_dict(state, strict=strict)
    return module
