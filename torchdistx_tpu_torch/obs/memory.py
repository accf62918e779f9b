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
- :func:`sharding_report` — the post-materialization sharding audit
  (``tdx-sharding-v1``): per entry the whole tensor's bytes, the bytes a
  rank holds and the spec; flags for a large tensor left replicated over
  a mesh of more than one rank (``accidental_replication``), a placement
  other than an intended rule's (``sharding_mismatch``), an optimizer slot
  held whole while its parameter is sharded (``unsharded_optimizer_state``)
  and, with a budget, a rank's footprint over it (``over_budget``).  Where
  the JAX package counts ``jax.devices()`` and an array's largest
  addressable shard, the port counts the ranks of the tensor's mesh and a
  rank's local piece (``parallel.mesh.sharding_of``).
- :func:`memory_report` — the watermark plus the audit's summary.
- :func:`record_materialize` / :func:`last_materialize_report` — the
  totals and watermark of the latest ``materialize_module``.
"""

from __future__ import annotations

import math
import resource
from typing import Any, Callable, Optional

import torch

__all__ = [
    "sharding_report",
    "hbm_watermark",
    "memory_report",
    "capacity_plan",
    "device_hbm_budget",
    "tree_device_bytes",
    "record_materialize",
    "last_materialize_report",
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


def _spec_str(spec: tuple) -> str:
    """A spec as the JAX package prints a ``PartitionSpec``."""
    return "PartitionSpec(" + ", ".join(repr(e) for e in spec) + ")"


def _named_entries(target: Any, prefix: str = ""):
    """``(path, leaf)`` of a module (parameters, then buffers), a flat
    ``{name: tensor}`` dict (its keys as they are, the paths a sharding
    rule sees) or a nested dict / list / tuple (dotted paths); a torch
    optimizer gives ``"<param path>.<slot>"`` per state slot."""
    if hasattr(target, "named_parameters"):
        yield from target.named_parameters()
        yield from target.named_buffers()
        return
    if hasattr(target, "state") and hasattr(target, "param_groups"):
        from ..parallel.plan import _state_tree

        for name, (_, slots) in _state_tree(target, {}).items():
            for slot, leaf in slots.items():
                yield f"{name}.{slot}", leaf
        return
    items = (target.items() if isinstance(target, dict)
             else enumerate(target) if isinstance(target, (list, tuple)) else ())
    for k, v in items:
        path = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            yield from _named_entries(v, path + ".")
        else:
            yield path, v


def _placed(t: torch.Tensor):
    """``(sharding or None, global shape)`` of a rank's tensor."""
    from ..parallel.mesh import sharding_of

    found = sharding_of(t)
    return (found[0], tuple(found[1])) if found else (None, tuple(t.shape))


def _real(t: Any) -> bool:
    from ..fake import is_fake

    return isinstance(t, torch.Tensor) and not is_fake(t) and t.device.type != "meta"


def sharding_report(
    target: Any,
    *,
    intended_rule: Optional[Callable[[str, Any], Any]] = None,
    optimizer_state: Any = None,
    min_shard_elems: int = 1024,
    budget_bytes_per_device: Optional[int] = None,
) -> dict:
    """Post-materialization sharding audit (module docstring).

    ``target``: a module, or a ``{name: tensor}`` dict / nested tree of a
    rank's tensors.  ``intended_rule(path, tensor) -> NamedSharding`` (a
    ``materialize_module`` sharding rule, ``ShardingPlan.as_rule()``) marks
    entries placed otherwise; replication it asks for is not flagged.
    ``optimizer_state`` (a torch optimizer, or ``{name: {slot: tensor}}``)
    is checked for slots shaped like their sharded parameter's whole
    tensor: an optimizer made over a rank's pieces holds pieces.
    ``budget_bytes_per_device`` adds the ``shard_budget`` section (a rank's
    parameter, buffer and optimizer bytes against it) and an
    ``over_budget`` flag.  ``report["flags"]`` empty: the plan holds."""
    from ..parallel.mesh import NamedSharding
    from ..parallel.multihost import process_count
    from ..parallel.plan import _effective, equivalent

    entries: list = []
    flags: list = []
    total_bytes = device_bytes = 0
    sharded: dict = {}  # path -> (local shape, global shape)

    for path, t in _named_entries(target):
        if not _real(t):
            entries.append({"path": path, "status": "unmaterialized",
                            "type": type(t).__name__})
            continue
        sh, shape = _placed(t)
        item = t.element_size()
        g = math.prod(shape) * item
        d = t.numel() * item
        total_bytes += g
        device_bytes += d
        spec = tuple(sh.spec) if sh is not None else ()
        replicated = sh is None or not any(_effective(sh, len(shape)))
        n_ranks = sh.mesh.size if sh is not None else 1
        entry = {"path": path, "shape": list(shape), "dtype": str(t.dtype).replace("torch.", ""),
                 "bytes": g, "bytes_per_device": d, "sharding": _spec_str(spec),
                 "replicated": replicated}
        if not replicated:
            sharded[path] = (tuple(t.shape), shape)
        planned = False  # replication the intended rule asked for
        if intended_rule is not None:
            try:
                want = intended_rule(path, t)
            except Exception as e:  # a partial rule must not kill the audit
                want = None
                entry["intended_error"] = str(e)[:120]
            if want is not None:
                planned = True
                actual = sh if sh is not None else NamedSharding(want.mesh, ())
                if not equivalent(actual, want, len(shape)):
                    entry["flag"] = "sharding_mismatch"
                    entry["intended"] = _spec_str(tuple(want.spec))
                    flags.append({"kind": "sharding_mismatch", "path": path,
                                  "actual": entry["sharding"],
                                  "intended": entry["intended"]})
        if replicated and not planned and n_ranks > 1 and math.prod(shape) >= min_shard_elems:
            entry["flag"] = "accidental_replication"
            flags.append({"kind": "accidental_replication", "path": path, "bytes": g,
                          "detail": f"{math.prod(shape)} elems fully replicated over "
                                    f"{n_ranks} devices"})
        entries.append(entry)

    opt_entries = opt_bytes = opt_device_bytes = 0
    if optimizer_state is not None:
        for path, leaf in _named_entries(optimizer_state):
            if not _real(leaf):
                continue
            opt_entries += 1
            sh, shape = _placed(leaf)
            local = tuple(leaf.shape)
            owner = next((p for p, (loc, glob) in sharded.items()
                          if p in path and local in (loc, glob)), None)
            if owner is not None and sh is None and local == sharded[owner][0]:
                shape = sharded[owner][1]  # a slot of the rank's piece
            item = leaf.element_size()
            opt_bytes += math.prod(shape) * item
            opt_device_bytes += leaf.numel() * item
            if owner is None:
                continue
            whole = local == sharded[owner][1] and (
                sh is None or not any(_effective(sh, len(local))))
            if whole and leaf.numel() >= min_shard_elems:
                flags.append({
                    "kind": "unsharded_optimizer_state", "path": path, "param": owner,
                    "bytes": math.prod(shape) * item,
                    "detail": "param is sharded but this state slot is fully "
                              "replicated — derive the slot shardings from the plan "
                              "(ShardingPlan.optimizer_state_shardings, parallel/plan.py) "
                              "and build the optimizer over the rank's pieces"})

    n_devices = process_count()
    report = {
        "schema": "tdx-sharding-v1",
        "n_devices": n_devices,
        "n_entries": len(entries),
        "n_optimizer_entries": opt_entries,
        "total_bytes": total_bytes,
        "bytes_per_device": device_bytes,
        "optimizer_bytes": opt_bytes,
        "optimizer_bytes_per_device": opt_device_bytes,
        "replication_factor": (round(device_bytes * n_devices / total_bytes, 3)
                               if total_bytes else None),
        "entries": entries,
        "flags": flags,
    }
    if budget_bytes_per_device is not None:
        shard_total = device_bytes + opt_device_bytes
        budget = int(budget_bytes_per_device)
        report["shard_budget"] = {
            "budget_bytes": budget,
            "bytes_per_device": shard_total,
            "headroom_bytes": budget - shard_total,
            "utilization": round(shard_total / budget, 4) if budget else None,
        }
        if shard_total > budget:
            flags.append({"kind": "over_budget", "path": None, "bytes": shard_total,
                          "detail": f"per-device footprint {shard_total} exceeds the "
                                    f"per-shard HBM budget {budget}"})
    return report


def memory_report(
    target: Any = None,
    *,
    intended_rule: Optional[Callable[[str, Any], Any]] = None,
    optimizer_state: Any = None,
    include_entries: bool = False,
) -> dict:
    """The watermark and, for a ``target``, the sharding audit's summary
    (its entry list only with ``include_entries``)."""
    out: dict = {"watermark": hbm_watermark()}
    if target is not None:
        rep = sharding_report(target, intended_rule=intended_rule,
                              optimizer_state=optimizer_state)
        if not include_entries:
            rep = {k: v for k, v in rep.items() if k != "entries"}
        out["sharding"] = rep
    return out


_LAST_MATERIALIZE: Optional[dict] = None


def record_materialize(n_tensors: int, total_bytes: int) -> dict:
    """Called by ``materialize_module`` after each replay: the number of
    tensors, their whole bytes and the watermark, for a caller to read
    back without walking the module (:func:`last_materialize_report`)."""
    global _LAST_MATERIALIZE
    _LAST_MATERIALIZE = {
        "n_tensors": int(n_tensors),
        "total_bytes": int(total_bytes),
        "watermark": hbm_watermark(),
    }
    from .trace import get_tracer

    get_tracer().counter("materialize_bytes", total=float(total_bytes))
    return _LAST_MATERIALIZE


def last_materialize_report() -> Optional[dict]:
    return _LAST_MATERIALIZE
