"""A device-resident loop, the port's counterpart of ``lax.while_loop`` in
the JAX package's persistent decode: one iteration captured in a CUDA graph
and replayed by the host.

The iteration is a Python callable that reads and writes a fixed set of
device tensors in place (the loop state) and launches no host sync.  It
must be guarded on the device: past its fixpoint, or with the ``cursor``
parked at ``capacity``, it changes no loop state that a later iteration
reads, except ``done``, where it writes whether the loop has ended.

On CUDA, the first :meth:`GraphLoop.run` warms the iteration up on a side
stream (the first-use ``nvcc`` build of ``ops/_build.py``, lazily loaded
kernels, the cuBLAS handle and workspace of that stream), then captures ONE
iteration with ``torch.cuda.graph``; both with the cursor parked, so
neither advances the loop.  A failed capture raises: there is no eager
fallback on CUDA.  Each later step is ``graph.replay()``.  On the CPU the
same iteration runs eagerly: no graph, the same semantics.

**Launch counters.**  The kernel wrappers count launches in Python
(``ops.decode_attention``, ``ops.flash_attention``, ``ops.fused_ce``:
every ``*launches`` attribute of their functions), which a replay does not
run.  The loop snapshots the counters around warm-up and capture, undoes
their ticks (warm-up is set-up, like the build; capture launches nothing)
and adds the captured deltas at every replay, so the counters count the
kernels the replays launch.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

__all__ = ["GraphLoop", "launch_counters"]

#: eager iterations on the capture stream before the capture
WARMUP_ITERATIONS = 2

#: one capture stream per device, shared by every loop: cuBLAS keeps a
#: workspace (tens of MiB, from the caching allocator, for the process's
#: life) for each stream it has run on, so a stream per loop would leave one
#: behind per persistent engine
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def launch_counters() -> List[Tuple[object, str]]:
    """Every ``(wrapper, attribute)`` launch counter of the kernel modules."""
    from ..ops import decode_attention, flash_attention, fused_ce

    found: Dict[Tuple[int, str], Tuple[object, str]] = {}
    for module in (decode_attention, flash_attention, fused_ce):
        for fn in vars(module).values():
            if not callable(fn):
                continue
            for name, value in getattr(fn, "__dict__", {}).items():
                if name.endswith("launches") and isinstance(value, int):
                    found[(id(fn), name)] = (fn, name)
    return list(found.values())


def _read(counters) -> List[int]:
    return [getattr(fn, name) for fn, name in counters]


class GraphLoop:
    """Run a body (one guarded iteration, in place over static tensors) a
    number of times the host bounds.

    ``cursor`` is the loop's (1,) int64 iteration cursor and ``capacity``
    its bound: the body must change no state a later iteration reads while
    ``cursor >= capacity``.  ``done`` is a (1,) bool tensor the caller sets
    before a run and every iteration rewrites.  The loop keeps no reference
    to the body (the owner of the state passes it to each run), so an
    owner that holds the loop forms no cycle and frees the graph and the
    state with itself."""

    #: CUDA graphs captured by every loop of the process
    captures_total = 0

    def __init__(self, *, cursor: torch.Tensor, capacity: int,
                 done: torch.Tensor):
        self.cursor = cursor
        self.capacity = int(capacity)
        self.done = done
        self.cuda = cursor.device.type == "cuda"
        self.graph = None
        self._deltas: List[Tuple[object, str, int]] = []
        self.replays = 0  # iterations launched over the loop's life
        self.captures = 0  # CUDA graphs captured (at most one)

    def run(self, body: Callable[[], None], fewest: int, most: int) -> int:
        """Launch between ``fewest`` and ``most`` iterations of ``body`` (on
        CUDA: of the graph captured from it at the first run): the first
        ``fewest`` without reading anything back, then one at a time while
        ``done`` reads False.  On CUDA ``done`` is read through a pinned
        copy queued behind the last replay, so no iteration is launched past
        the fixpoint.  Returns the iterations launched."""
        if self.cuda and self.graph is None:
            self.capture(body)
        n = 0
        while n < most:
            if n >= fewest and self._read_done():
                break
            if self.cuda:
                self.graph.replay()
                for fn, name, d in self._deltas:
                    setattr(fn, name, getattr(fn, name) + d)
            else:
                body()
            n += 1
        self.replays += n
        return n

    def _read_done(self) -> bool:
        if not self.cuda:
            return bool(self.done[0])
        self._flag.copy_(self.done, non_blocking=True)
        self._flag_ready.record()
        self._flag_ready.synchronize()
        return bool(self._flag[0])

    def capture(self, body: Callable[[], None]) -> None:
        """Warm ``body`` up and capture one iteration of it (CUDA only;
        :meth:`run` calls this at its first run)."""
        counters = launch_counters()
        before = _read(counters)
        saved_cursor, saved_done = self.cursor.clone(), self.done.clone()
        self.cursor.fill_(self.capacity)  # parked: the body advances nothing
        main = torch.cuda.current_stream(self.cursor.device)
        side = _capture_stream(self.cursor.device)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side):
                for _ in range(WARMUP_ITERATIONS):
                    body()
            main.wait_stream(side)
            warm = _read(counters)
            with torch.cuda.graph(graph, stream=side):
                body()
            captured = _read(counters)
        finally:
            for (fn, name), n in zip(counters, before):
                setattr(fn, name, n)
            self.cursor.copy_(saved_cursor)
            self.done.copy_(saved_done)
        self._deltas = [(fn, name, c - w) for (fn, name), w, c
                        in zip(counters, warm, captured) if c != w]
        self._flag = torch.zeros(1, dtype=torch.bool, pin_memory=True)
        self._flag_ready = torch.cuda.Event()
        self.graph = graph
        self.captures += 1
        GraphLoop.captures_total += 1
