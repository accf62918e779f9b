"""Program watcher: count and attribute the port's "compiles".

Counterpart of ``torchdistx_tpu/obs/recompile.py``.  PyTorch runs eagerly,
so there is no backend compile to listen for.  The port's counterpart of
a compile is the FIRST dispatch of a new program shape (a prefill bucket,
cold or warm; the decode step of a ``decode_chunk``; the persistent loop)
or the capture of a CUDA graph: the points where work is set up once and
reused after.  The serve engine reports each one with :func:`note_compile`
under the current :func:`recompile_scope`; every installed
:class:`RecompileWatcher` counts it there, everything outside a scope
under ``"unattributed"``.  ``utils.profiling.timed_annotation`` enters a
scope named after its region, so the engine's ``serve/prefill`` /
``serve/decode`` dispatches are attributed without further plumbing.

The invariant the tests pin is the JAX package's: after warm-up the count
is STABLE, so no late admission sets up a new program.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional

__all__ = [
    "RecompileWatcher",
    "recompile_scope",
    "current_scope",
    "note_compile",
    "track_jit_cache",
    "jit_cache_collector",
]

_tls = threading.local()
_lock = threading.Lock()
_watchers: List["RecompileWatcher"] = []


def _scope_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_scope() -> Optional[str]:
    st = _scope_stack()
    return st[-1] if st else None


@contextlib.contextmanager
def recompile_scope(label: str) -> Iterator[None]:
    """Attribute any program set up inside the body to ``label``
    (innermost scope wins).  Safe to nest; near-free when no watcher is
    active."""
    st = _scope_stack()
    st.append(label)
    try:
        yield
    finally:
        st.pop()


def note_compile(seconds: float = 0.0) -> None:
    """Report one new program (a first dispatch or a graph capture) that
    took ``seconds`` to set up, to every installed watcher, under the
    current scope."""
    label = current_scope() or "unattributed"
    with _lock:
        for w in _watchers:
            w._record(label, seconds)


_tracked: Dict[str, object] = {}


def track_jit_cache(name: str, obj: object) -> None:
    """Register an object whose program count shows up as
    ``tdx_jit_cache_size{fn="<name>"}`` in :func:`jit_cache_collector`:
    an engine (its ``num_compiled_programs()``) or a zero-argument
    callable returning a count.  Held by weakref when the object allows
    it, so tracking never pins an engine; a later registration under the
    same name replaces the earlier one."""
    import weakref

    try:
        ref = weakref.ref(obj)
    except TypeError:
        ref = lambda _obj=obj: _obj  # non-weakrefable: hold it
    with _lock:
        _tracked[str(name)] = ref


def _count_of(obj) -> Optional[int]:
    fn = getattr(obj, "num_compiled_programs", None)
    n = fn() if fn is not None else obj()
    return None if n is None else int(n)


def jit_cache_collector(prefix: str = "tdx_jit"):
    """An ``obs.metrics`` collector over every tracked program count."""
    from .metrics import MetricFamily

    def collect():
        with _lock:
            tracked = dict(_tracked)
        fam = MetricFamily(
            f"{prefix}_cache_size",
            "gauge",
            "programs set up behind tracked engines",
        )
        dead = []
        for name, ref in tracked.items():
            obj = ref()
            if obj is None:
                dead.append(name)
                continue
            size = _count_of(obj)
            if size is not None:
                fam.add(size, fn=name)
        if dead:
            with _lock:
                for name in dead:
                    if _tracked.get(name) is tracked[name]:
                        del _tracked[name]
        return [fam] if fam.samples else []

    return collect


class RecompileWatcher:
    """Count new programs per attribution label; read ``counts`` /
    ``seconds``.  ``install()`` is idempotent; ``uninstall()`` stops this
    watcher without touching others.  ``available`` is always True: the
    engine reports every new program itself."""

    def __init__(self, install: bool = True):
        self.counts: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}
        self.available = False
        if install:
            self.install()

    def install(self) -> "RecompileWatcher":
        self.available = True
        with _lock:
            if self not in _watchers:
                _watchers.append(self)
        return self

    def uninstall(self) -> None:
        with _lock:
            if self in _watchers:
                _watchers.remove(self)

    def __enter__(self) -> "RecompileWatcher":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # called under the module lock
    def _record(self, label: str, dur: float) -> None:
        self.counts[label] = self.counts.get(label, 0) + 1
        self.seconds[label] = self.seconds.get(label, 0.0) + float(dur)

    scope = staticmethod(recompile_scope)

    @property
    def total(self) -> int:
        with _lock:
            return sum(self.counts.values())

    @property
    def total_seconds(self) -> float:
        with _lock:
            return sum(self.seconds.values())

    def reset(self) -> None:
        with _lock:
            self.counts.clear()
            self.seconds.clear()

    def snapshot(self) -> dict:
        """JSON-able record: total programs + seconds, per-label split."""
        with _lock:
            return {
                "available": self.available,
                "compiles_total": sum(self.counts.values()),
                "compile_seconds_total": round(
                    sum(self.seconds.values()), 4
                ),
                "by_scope": {
                    k: {
                        "compiles": self.counts[k],
                        "seconds": round(self.seconds[k], 4),
                    }
                    for k in sorted(self.counts)
                },
            }

    def collector(self, prefix: str = "tdx_jit"):
        """A :mod:`~torchdistx_tpu_torch.obs.metrics` collector exposing
        ``<prefix>_compiles_total{fn=...}`` and
        ``<prefix>_compile_seconds_total{fn=...}``."""
        from .metrics import MetricFamily

        def collect():
            with _lock:
                counts = dict(self.counts)
                seconds = dict(self.seconds)
            c = MetricFamily(
                f"{prefix}_compiles_total",
                "counter",
                "programs set up (first dispatches and graph captures), "
                "attributed by recompile_scope",
            )
            s = MetricFamily(
                f"{prefix}_compile_seconds_total",
                "counter",
                "Seconds spent setting those programs up",
            )
            for k in sorted(counts):
                c.add(counts[k], fn=k)
                s.add(seconds[k], fn=k)
            if not counts:
                c.add(0.0)
                s.add(0.0)
            return [c, s]

        return collect
