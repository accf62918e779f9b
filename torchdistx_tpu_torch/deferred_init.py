"""Deferred module initialization: record construction, materialize later
on the device that will run the model.

Counterpart of ``torchdistx_tpu/deferred_init.py`` (``deferred_init``,
``is_deferred``, ``can_materialize``, ``materialize_tensor``,
``materialize_module``) and of the reference's API of the same names.
``deferred_init(Llama.from_name, "llama_1b", device="cuda")`` builds the
module with fake parameters that claim ``cuda:0`` and own no storage;
``materialize_module(model)`` replays the recorded init ops on the card,
children first, so every parameter is born there, bit-identical to an
eager construction from the same ``manual_seed``.

A second ``materialize_module`` is a no-op, as in the JAX package (the
reference raises).  With a ``sharding_rule`` (``parallel.fsdp_shard_rule``)
each rank keeps only its piece of every tensor the rule shards.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn

from ._graph import RecordingSession, _norm
from .fake import FakeTensor, _deferred

__all__ = [
    "deferred_init",
    "is_deferred",
    "can_materialize",
    "materialize_tensor",
    "materialize_module",
]


def deferred_init(module_fn: Callable[..., Any], *args: Any, **kwargs: Any):
    """Call ``module_fn(*args, **kwargs)`` with tensor creation deferred:
    it returns what ``module_fn`` returns, typically a module whose
    parameters and buffers are fake tensors with a record.  Nesting
    raises."""
    with _deferred(RecordingSession()):
        return module_fn(*args, **kwargs)


def is_deferred(obj: Any) -> bool:
    """True for a fake tensor with a record, or a module holding one."""
    if isinstance(obj, FakeTensor):
        return obj.is_deferred
    if isinstance(obj, nn.Module):
        return any(isinstance(t, FakeTensor) and t.is_deferred
                   for t in (*obj.parameters(), *obj.buffers()))
    return False


def can_materialize(x: Any) -> bool:
    """True if ``x`` is a fake tensor recorded under ``deferred_init``."""
    return isinstance(x, FakeTensor) and x.is_deferred


def _resolve_claim(fake: FakeTensor) -> torch.device:
    dev = fake.device
    if dev.type == "cuda" and (not torch.cuda.is_available()
                               or (dev.index or 0) >= torch.cuda.device_count()):
        raise RuntimeError(
            f"fake tensor claims device {dev}, which does not exist on this "
            "host; pass device= to materialize it elsewhere"
        )
    return dev


def materialize_tensor(x: Any, *, device: Optional[Any] = None):
    """The real tensor of a fake one; a real tensor passes through.  The
    same fake always gives back the same tensor."""
    if not isinstance(x, FakeTensor):
        return x
    if not x.is_deferred:
        raise RuntimeError(
            "this fake tensor was made under fake_mode() outside "
            "deferred_init and cannot be materialized"
        )
    session, node, idx = x._ref
    dev = device if device is not None else _resolve_claim(x)
    return session.materialize_many([(node, idx)], dev)[0]


def materialize_module(
    module: nn.Module,
    *,
    sharding_rule: Optional[Callable] = None,
    buffers_only: bool = False,
    check_fn: Optional[Callable[[nn.Module], bool]] = None,
    device: Optional[Any] = None,
) -> nn.Module:
    """Materialize a module tree in place, children first (``check_fn``
    skips a module's own tensors, ``buffers_only`` skips parameters).  The
    tensors of one record session and one device replay in one pass, which
    runs only the recorded ops those tensors need: materializing one block
    of a deferred model allocates that block's tensors alone, bit-identical
    to a whole-model materialize.  A parameter the caller later drops (as
    ``quantize_module`` drops a ``Linear``'s weight) is released at the
    next materialize of the session, so a model too large for the device
    in full precision can be materialized and quantized block by block.
    Tied parameters stay one ``nn.Parameter``.

    ``sharding_rule(path, fake) -> NamedSharding`` (or None: unsharded)
    names each tensor's sharding over a ``parallel.Mesh``; each rank keeps
    its piece of it (``parallel.mesh.sharding_of`` reads the sharding and
    the global shape back).  The tensors replay one at a time, each full
    tensor dropped once its piece is cut, so the device holds the pieces
    and one full tensor at most, never the whole model.  A piece is
    bit-identical to the same slice of an eager construction."""
    entries = []
    _collect(module, "", buffers_only, check_fn, entries)
    for _, store, name, fake, _ in entries:
        if not fake.is_deferred:
            raise RuntimeError(
                f"{name!r} is fake but was made outside deferred_init and "
                "cannot be materialized"
            )
    if sharding_rule is not None:
        _materialize_sharded(entries, sharding_rule, device)
        return module
    groups = {}
    for _, store, name, fake, is_param in entries:
        dev = _norm(device if device is not None else _resolve_claim(fake))
        key = (id(fake._ref[0]), dev)
        groups.setdefault(key, (fake._ref[0], dev, []))[2].append(
            (store, name, fake, is_param))
    for session, dev, items in groups.values():
        refs = [(f._ref[1], f._ref[2]) for _, _, f, _ in items]
        reals = session.materialize_many(refs, dev)
        for (store, name, fake, is_param), ref, real in zip(items, refs, reals):
            store[name] = (session.parameter(ref, dev, fake.requires_grad)
                           if is_param else real)
    return module


def _materialize_sharded(entries, rule, device) -> None:
    from .parallel.mesh import mark_sharded, shard_tensor

    made = {}
    for path, store, name, fake, is_param in entries:
        session, node, idx = fake._ref
        key = (id(session), node, idx)
        if key not in made:
            dev = _norm(device if device is not None else _resolve_claim(fake))
            sharding = rule(path, fake)
            full = session.materialize_many([(node, idx)], dev)[0]
            piece = shard_tensor(full, sharding)
            if piece is full:
                t = session.parameter((node, idx), dev, fake.requires_grad) if is_param else full
            else:
                session.forget([(node, idx)], dev)
                t = nn.Parameter(piece, requires_grad=fake.requires_grad) if is_param else piece
            del full, piece
            made[key] = mark_sharded(t, sharding, fake.shape) if sharding is not None else t
        store[name] = made[key]


def _collect(module, prefix, buffers_only, check_fn, entries) -> None:
    for cname, child in module.named_children():
        _collect(child, f"{prefix}{cname}.", buffers_only, check_fn, entries)
    if check_fn is not None and not check_fn(module):
        return
    stores = [(module._buffers, False)]
    if not buffers_only:
        stores.insert(0, (module._parameters, True))
    for store, is_param in stores:
        for name, value in store.items():
            if isinstance(value, FakeTensor):
                entries.append((prefix + name, store, name, value, is_param))
