"""Device memory: the watermark, the card's budget and the live capacity
plan the serve engine admits against.

Counterpart of ``torchdistx_tpu/obs/memory.py``:

- :func:`tree_device_bytes` — the bytes of the tensors of a module, a
  dict, a list or tuple, or a tensor: the weights and KV components of a
  :func:`capacity_plan`.  Without a mesh every tensor is whole on its
  device, so per-device bytes are the tensor's own.
- :func:`hbm_watermark` — the CUDA caching allocator's peak via
  ``utils.profiling.device_memory_stats``, degrading to the host
  ``ru_maxrss`` watermark where no card reports stats (the CPU) — the
  source is always named, never guessed.
- :func:`device_hbm_budget` — the card's total memory
  (``torch.cuda.mem_get_info``), or None on the CPU.
- :func:`capacity_plan` — roll named components (weights, KV pool, the
  per-program temp bytes of the cost cards) into a per-device budget
  report with headroom and a ``fits`` verdict (``tdx-capacity-v1``, the
  JAX package's schema).

The sharding audit (``sharding_report``) waits for tensor-parallel
serving, where a cache or a weight can be cut across cards.
"""

from __future__ import annotations

import resource
from typing import Any, Optional

import torch

__all__ = [
    "hbm_watermark",
    "capacity_plan",
    "device_hbm_budget",
    "tree_device_bytes",
]


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif hasattr(tree, "named_parameters"):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tree_device_bytes(tree: Any) -> int:
    """Bytes of every tensor in ``tree`` (a module's parameters and
    buffers, or the tensors of nested dicts / lists / tuples), each
    storage counted once: tied weights are one tensor."""
    seen = set()
    total = 0
    for t in _tensors(tree):
        key = (t.data_ptr(), t.numel(), t.dtype)
        if t.numel() and key in seen:
            continue
        seen.add(key)
        total += t.numel() * t.element_size()
    return total


def hbm_watermark(device: Optional[Any] = None) -> dict:
    """Device memory watermark: ``{"source": "cuda_allocator", "devices":
    {dev: {bytes_in_use, peak_bytes_in_use, bytes_limit}}, "peak_bytes":
    max}`` or, where no card reports stats (the CPU), the host fallback
    ``{"source": "host_rusage", "peak_bytes": ru_maxrss}``."""
    from ..utils.profiling import device_memory_stats

    stats = device_memory_stats(device)
    devices = {
        d: {
            k: s[k]
            for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
            if k in s
        }
        for d, s in stats.items()
        if s
    }
    if devices:
        return {
            "source": "cuda_allocator",
            "devices": devices,
            "peak_bytes": max(
                s.get("peak_bytes_in_use", s.get("bytes_in_use", 0))
                for s in devices.values()
            ),
        }
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return {
        "source": "host_rusage",
        # ru_maxrss is KiB on Linux
        "peak_bytes": int(ru) * 1024,
    }


def device_hbm_budget(device: Optional[Any] = None) -> Optional[int]:
    """The card's real memory capacity (``torch.cuda.mem_get_info``'s
    total; the least over the visible cards when ``device`` is None), or
    None on the CPU — the honest default budget for :func:`capacity_plan`
    consumers that were not given an explicit one."""
    from ..utils.profiling import device_memory_stats

    limits = [
        s["bytes_limit"]
        for s in device_memory_stats(device).values()
        if isinstance(s.get("bytes_limit"), int) and s["bytes_limit"] > 0
    ]
    return min(limits) if limits else None


def capacity_plan(
    components: dict,
    *,
    budget_bytes: Optional[int] = None,
    device: Optional[Any] = None,
) -> dict:
    """The live capacity planner (``tdx-capacity-v1``): roll named
    per-device byte components into one budget report.
    ``projected_peak_bytes`` is their sum (the KV cache and the weights
    are both live while a dispatch's temps peak).  With a budget
    (explicit, or falling back to :func:`device_hbm_budget` of
    ``device``) the report carries headroom and a ``fits`` verdict —
    what ``ServeEngine``'s admission gate refuses on.  Budget-less hosts
    (the CPU with no explicit budget) report ``fits: None``: unknown,
    never "yes"."""
    comps = {
        k: int(v)
        for k, v in (components or {}).items()
        if isinstance(v, (int, float)) and not isinstance(v, bool)
    }
    total = sum(comps.values())
    if budget_bytes is None:
        budget_bytes = device_hbm_budget(device)
        budget_source = "cuda_mem_get_info" if budget_bytes else None
    else:
        budget_bytes = int(budget_bytes)
        budget_source = "explicit"
    return {
        "schema": "tdx-capacity-v1",
        "components": comps,
        "projected_peak_bytes": total,
        "budget_bytes": budget_bytes,
        "budget_source": budget_source,
        "headroom_bytes": (
            None if budget_bytes is None else budget_bytes - total
        ),
        "fits": None if budget_bytes is None else total <= budget_bytes,
    }
