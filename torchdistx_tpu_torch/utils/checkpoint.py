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
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "save_module", "load_module"]

_FILE = "state.pt"


def _as_saved(v: Any) -> Any:
    if hasattr(v, "state_dict") and callable(v.state_dict):
        return v.state_dict()
    if isinstance(v, dict):
        return {k: _as_saved(x) for k, x in v.items()}
    return v


def save_checkpoint(path: str, state: Any) -> None:
    """Write ``state`` (a dict; modules and optimizers as their state
    dicts) to the directory ``path``, atomically."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.", dir=parent)
    try:
        torch.save(_as_saved(state), os.path.join(tmp, _FILE))
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


def _into(template: Any, saved: Any, where: str) -> Any:
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
        if not isinstance(saved, torch.Tensor) or saved.shape != template.shape:
            raise ValueError(f"checkpoint entry at {where} does not match `like`'s shape")
        return saved.to(device=template.device, dtype=template.dtype)
    return saved


def restore_checkpoint(path: str, *, like: Any = None, map_location: Any = None) -> Any:
    """Read a checkpoint.  With ``like`` (the live state dict), each entry
    loads into ``like``'s object of the same key on that object's device,
    and the result is ``like``'s structure with those objects; without it,
    the saved dict, its tensors on ``map_location`` (default: the CPU)."""
    if map_location is None:
        map_location = _device_of(like) if like is not None else "cpu"
    saved = torch.load(os.path.join(os.path.abspath(path), _FILE),
                       map_location=map_location, weights_only=False)
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
