"""Profiler traces, annotations, cost summaries and device memory stats.

Counterpart of ``torchdistx_tpu/utils/profiling.py``.  :func:`trace`
writes a ``torch.profiler`` trace (the JAX package's XLA trace).  A region of
:func:`timed_annotation` lands on the ``torch.profiler`` timeline (a
``record_function`` range), on the host Perfetto trace (an ``obs.trace``
span), in a metrics histogram (the ``sink``) and in a program-attribution
scope (``obs.recompile``), so the serve engine's ``serve/prefill`` /
``serve/decode`` dispatch regions mean the same thing in every view.
:func:`device_memory_stats` reads the CUDA caching allocator's counters
and the card's totals, :func:`format_memory_stats` prints them, and
:func:`cost_summary` projects a counted cost card (``obs.cost``).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Any, Iterator, Optional

import torch

from ..obs.recompile import recompile_scope
from ..obs.trace import get_tracer

__all__ = [
    "trace",
    "annotate",
    "timed_annotation",
    "device_memory_stats",
    "format_memory_stats",
    "cost_summary",
]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Any]:
    """Capture a ``torch.profiler`` trace of the body (the CPU, and the
    card when there is one) into ``log_dir`` as a Chrome trace
    (``<host>.<pid>.<ms>.pt.trace.json``, the name TensorBoard's profiler
    plugin reads).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    name = f"{socket.gethostname()}.{os.getpid()}.{int(time.time() * 1e3)}.pt.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


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


def format_memory_stats(stats: Optional[dict] = None) -> str:
    """One line a device of :func:`device_memory_stats` (default: every
    device's), as the JAX function prints them."""
    stats = stats if stats is not None else device_memory_stats()
    lines = []
    for dev, s in stats.items():
        if not s:
            lines.append(f"{dev}: (no memory stats)")
            continue
        in_use = s.get("bytes_in_use", 0) / 1e9
        peak = s.get("peak_bytes_in_use", 0) / 1e9
        limit = s.get("bytes_limit", 0) / 1e9
        lines.append(f"{dev}: {in_use:.2f} GB in use (peak {peak:.2f} GB, "
                     f"limit {limit:.2f} GB)")
    return "\n".join(lines)


def cost_summary(fn: Any, *args: Any, peak_flops: Optional[float] = None,
                 **kwargs: Any) -> dict:
    """The counted cost of ``fn(*args)``, a projection of
    ``obs.cost.compute_cost_card`` with the JAX function's keys:
    ``{"flops", "bytes_accessed", "arithmetic_intensity", "output_bytes",
    "transcendentals"}`` and, with ``peak_flops``, the ``compute_bound_s``
    floor.  Unlike the JAX function, which compiles only, this EXECUTES
    ``fn`` once; nothing counts bytes or transcendentals, which read 0.0
    (and the intensity None)."""
    from ..obs.cost import compute_cost_card

    card = compute_cost_card(fn, *args, name="cost_summary", **kwargs)
    flops = card.flops or 0.0
    byts = card.bytes_accessed or 0.0
    out = {
        "flops": flops,
        "bytes_accessed": byts,
        "arithmetic_intensity": flops / byts if byts else None,
        "output_bytes": card.output_bytes_accessed or 0.0,
        "transcendentals": card.transcendentals or 0.0,
    }
    if peak_flops:
        out["compute_bound_s"] = flops / peak_flops
    return out
