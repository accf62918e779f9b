"""Fake tensors and ``fake_mode``: tensors with a shape, a dtype, strides
and a *claimed* device, but no storage anywhere.

Counterpart of ``torchdistx_tpu/fake.py`` (``fake_mode``, ``FakeArray``,
``is_fake``, ``meta_like``) and of the reference's fake tensors.  A
:class:`FakeTensor` is a ``__torch_dispatch__`` wrapper subclass whose data
is a ``meta`` tensor: every aten op on it runs on the meta tensors for
shape inference, and its result is a new fake that claims the same device.
Under ``fake_mode()`` a ``TorchDispatchMode`` also catches the creation
ops (``torch.empty``, ``torch.zeros``, ...), so a model of any size is
built without allocating.  Ops on real tensors alone run for real.

Inside ``deferred_init`` every op that makes or touches a fake is also
recorded (``_graph.RecordingSession``), so the fake can be materialized
later.  A fake made under plain ``fake_mode()`` has no record and never
materializes.

``fake_mode(fake_cuda=True)`` lets creation ops claim ``cuda:0`` on a host
without a card (the JAX package's ``fake_tpu``, the reference's
``fake_cuda``): ``device="cuda"`` is accepted without initialising CUDA.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

__all__ = ["FakeTensor", "fake_mode", "is_fake", "meta_like"]

_LIFT = (torch.ops.aten.lift_fresh.default, torch.ops.aten.lift_fresh_copy.default)


class _TLS(threading.local):
    def __init__(self) -> None:
        self.level = 0
        self.fake_cuda = False
        self.session: Any = None  # RecordingSession during deferred_init


_tls = _TLS()


def fake_cuda_active() -> bool:
    return _tls.level > 0 and _tls.fake_cuda


class FakeTensor(torch.Tensor):
    """A storage-less tensor.  ``_meta`` holds its shape and strides (and
    shares a meta storage with its views); ``_ref`` is ``(session, node,
    out_idx)`` when the op that made it was recorded, else ``None``."""

    _meta: torch.Tensor
    _ref: Any

    @staticmethod
    def __new__(cls, meta: torch.Tensor, device, ref=None):
        t = torch.Tensor._make_wrapper_subclass(
            cls, meta.shape, strides=meta.stride(),
            storage_offset=meta.storage_offset(), dtype=meta.dtype,
            device=device, requires_grad=False,
        )
        t._meta = meta
        t._ref = ref
        return t

    __torch_function__ = torch._C._disabled_torch_function_impl

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        return _fake_op(func, args, kwargs or {})

    @property
    def is_deferred(self) -> bool:
        return self._ref is not None

    def __repr__(self) -> str:
        return (f"FakeTensor(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"device={self.device}, fake=True)")

    __str__ = __repr__


class _FakeMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return _fake_op(func, args, kwargs or {})


@contextlib.contextmanager
def _cuda_init_skipped(active: bool):
    """Let ``device="cuda"`` through PyTorch's argument parsing on a host
    without a card: the parser initialises CUDA before any dispatch."""
    if not active:
        yield
        return
    import torch.cuda

    orig = torch.cuda._lazy_init
    torch.cuda._lazy_init = lambda: None
    try:
        yield
    finally:
        torch.cuda._lazy_init = orig


@contextlib.contextmanager
def fake_mode(*, fake_cuda: bool = False):
    """Under this context creation ops return fake tensors.  Re-entrant."""
    prev_fake_cuda = _tls.fake_cuda
    outer = _tls.level == 0
    _tls.level += 1
    _tls.fake_cuda = prev_fake_cuda or fake_cuda
    patch = _tls.fake_cuda and not prev_fake_cuda and not torch.cuda.is_available()
    try:
        with _cuda_init_skipped(patch):
            if outer:
                with _FakeMode():
                    yield
            else:
                yield
    finally:
        _tls.level -= 1
        _tls.fake_cuda = prev_fake_cuda


@contextlib.contextmanager
def _deferred(session):
    if _tls.session is not None:
        raise RuntimeError("deferred_init contexts cannot be nested")
    _tls.session = session
    try:
        with fake_mode():
            yield
    finally:
        _tls.session = None


def is_fake(x: Any) -> bool:
    return isinstance(x, FakeTensor)


def meta_like(x: torch.Tensor) -> torch.Tensor:
    """A ``meta`` tensor with the shape, strides and dtype of ``x`` (fake
    or real)."""
    if isinstance(x, FakeTensor):
        return x._meta
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device="meta")


def _claim(fakes, kwargs) -> torch.device:
    if fakes:
        return fakes[0].device
    dev = kwargs.get("device")
    dev = torch.get_default_device() if dev is None else torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if torch.cuda.is_available() else 0)
    return dev


def _session_of(fakes):
    if not fakes:
        return _tls.session
    refs = [f._ref for f in fakes]
    if any(r is None for r in refs):
        return None  # a plain fake joined in: the result cannot materialize
    sessions = {id(r[0]): r[0] for r in refs}
    if len(sessions) > 1 or (_tls.session is not None
                             and id(_tls.session) not in sessions):
        raise RuntimeError(
            "an op mixes fake tensors of a different deferred-init session"
        )
    return refs[0][0]


def _to_meta(x):
    if isinstance(x, FakeTensor):
        return x._meta
    if isinstance(x, torch.Tensor):
        return meta_like(x)
    if isinstance(x, torch.Generator):
        return None  # shape inference draws nothing
    if isinstance(x, torch.device):
        return torch.device("meta")
    return x


def _needs_data(func, args, kwargs, fakes):
    """An op whose result depends on values (``item()``, ``equal``):
    materialize deferred fakes and run it for real."""
    if not all(f.is_deferred for f in fakes):
        raise RuntimeError(
            f"{func} needs tensor data, but a fake tensor has no storage and "
            "no deferred-init record (it was made under plain fake_mode()); "
            "construct it under deferred_init() or use real tensors"
        )
    from .deferred_init import materialize_tensor

    flat, spec = tree_flatten((args, kwargs))
    real = [materialize_tensor(x) if isinstance(x, FakeTensor) else x for x in flat]
    a, k = tree_unflatten(real, spec)
    return func(*a, **k)


def _fake_op(func, args, kwargs):
    flat, spec = tree_flatten((args, kwargs))
    fakes = [x for x in flat if isinstance(x, FakeTensor)]
    if not fakes and func not in _LIFT and any(
        isinstance(x, torch.Tensor) for x in flat
    ):
        return func(*args, **kwargs)  # real tensors only: run for real
    margs, mkwargs = tree_unflatten([_to_meta(x) for x in flat], spec)
    try:
        out = func(*margs, **mkwargs)
    except (NotImplementedError, RuntimeError):
        if fakes:
            return _needs_data(func, args, kwargs, fakes)
        raise
    session = _session_of(fakes)
    device = _claim(fakes, kwargs)
    outs, out_spec = tree_flatten(out)
    by_meta = {id(f._meta): f for f in fakes}
    result, new = [], []
    for i, o in enumerate(outs):
        if isinstance(o, torch.Tensor):
            f = by_meta.get(id(o))  # in-place / out=: the argument itself
            if f is None:
                f = FakeTensor(o, device)
                new.append((i, f))
            result.append(f)
        else:
            result.append(o)
    if session is not None:
        node = session.record(func, flat, spec, outs)
        for i, f in new:
            f._ref = (session, node, i)
    return tree_unflatten(result, out_spec)
