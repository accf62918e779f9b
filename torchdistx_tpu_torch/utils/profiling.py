"""Profiler annotations and device memory stats.

Counterpart of ``torchdistx_tpu/utils/profiling.py``.  A region of
:func:`timed_annotation` lands on the ``torch.profiler`` timeline (a
``record_function`` range), on the host Perfetto trace (an ``obs.trace``
span), in a metrics histogram (the ``sink``) and in a program-attribution
scope (``obs.recompile``), so the serve engine's ``serve/prefill`` /
``serve/decode`` dispatch regions mean the same thing in every view.
:func:`device_memory_stats` reads the CUDA caching allocator's counters
and the card's totals.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator, Optional

import torch

from ..obs.recompile import recompile_scope
from ..obs.trace import get_tracer

__all__ = [
    "annotate",
    "timed_annotation",
    "device_memory_stats",
]


def annotate(name: str):
    """Named region that shows up on the ``torch.profiler`` timeline."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed_annotation(name: str, sink: Optional[Any] = None) -> Iterator[dict]:
    """:func:`annotate` plus wall-clock timing.  Yields a dict that gains
    ``{"seconds": ...}`` on exit; ``sink(seconds)`` is called if given
    (e.g. a ``serve.metrics.Histogram.record``).  The region is also a
    host tracer span (no-op unless tracing is enabled) and a
    program-attribution scope: a new program reported inside it
    (``obs.recompile.note_compile``) counts under ``name``."""
    out: dict = {}
    t0 = time.perf_counter()
    with annotate(name), recompile_scope(name), get_tracer().span(
        name, cat="dispatch"
    ):
        yield out
    out["seconds"] = time.perf_counter() - t0
    if sink is not None:
        sink(out["seconds"])


def _cuda_stats(dev: torch.device) -> dict:
    free, total = torch.cuda.mem_get_info(dev)
    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
        "bytes_reserved": int(torch.cuda.memory_reserved(dev)),
        "bytes_free": int(free),
        "bytes_limit": int(total),
    }


def device_memory_stats(device: Optional[Any] = None) -> dict:
    """Per-device memory counters: ``{device_str: stats}`` with
    ``bytes_in_use`` / ``peak_bytes_in_use`` (the caching allocator's
    allocated and peak-allocated bytes), ``bytes_reserved``, and the
    card's ``bytes_free`` / ``bytes_limit`` (``torch.cuda.mem_get_info``).
    A CPU device reports an empty dict, as the JAX package's CPU devices
    do.  ``device=None`` covers every visible card, else the CPU."""
    if device is not None:
        devices = [torch.device(device)]
    elif torch.cuda.is_available():
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    out = {}
    for d in devices:
        if d.type == "cuda":
            d = torch.device("cuda", d.index if d.index is not None
                             else torch.cuda.current_device())
            out[str(d)] = _cuda_stats(d)
        else:
            out[str(d)] = {}
    return out
