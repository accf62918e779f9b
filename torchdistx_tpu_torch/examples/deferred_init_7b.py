"""The north-star demo (BASELINE config 5): the port's counterpart of
``examples/deferred_init_7b.py``.  Llama-2-7B is looked at in fake mode
(zero bytes held), constructed with zero storage by ``deferred_init``, then
materialized onto the card, FSDP-sharded over every rank of the world
(``fsdp_shard_rule``) when the world has more than one rank.

On the card, one rank::

    from torchdistx_tpu_torch.examples.deferred_init_7b import main
    out = main()

Two ranks (each process calls ``init_multihost`` first, then ``main``):
each materializes its half of every parameter.  On the CPU, at a tiny
size: ``main("tiny", device="cpu")``.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

__all__ = ["main"]


def _held_bytes(module: torch.nn.Module) -> int:
    """Bytes of real (not fake, not meta) storage the module's tensors hold."""
    from .. import is_fake

    seen, total = set(), 0
    for t in list(module.parameters()) + list(module.buffers()):
        if is_fake(t) or t.device.type == "meta":
            continue
        storage = t.untyped_storage()
        if storage.data_ptr() not in seen:
            seen.add(storage.data_ptr())
            total += storage.nbytes()
    return total


def main(name: str = "llama2_7b", *, device="cuda", seed: int = 0, mesh=None,
         log_fn=print) -> dict:
    """Inspect Llama-2-7B in fake mode, deferred-init ``name`` and
    materialize it on ``device`` (sharded over ``mesh``, default an
    ``{"fsdp": world}`` mesh when the world has more than one rank).
    Returns ``{"fake_params", "fake_bytes_held", "n_params",
    "deferred_init_s", "materialize_s", "host_rss_before_gb",
    "host_rss_peak_gb", "card_bytes", "sharded", "model"}`` (the card's
    bytes: what the materialize left allocated; 0 on the CPU)."""
    from .. import deferred_init, fake_mode, manual_seed, materialize_module
    from ..models import Llama
    from ..parallel import create_mesh, fsdp_shard_rule, process_count
    from ..utils.benchmarks import _PeakRss

    device = torch.device(device)
    out = {}
    # 1. the real thing without allocating it
    with fake_mode():
        big = Llama.from_name("llama2_7b", device=device)
    out["fake_params"] = sum(p.numel() for p in big.parameters())
    out["fake_bytes_held"] = _held_bytes(big)
    del big
    log_fn(f"llama2_7b in fake mode: {out['fake_params'] / 1e9:.2f}B params "
           f"({out['fake_bytes_held']} bytes held)")

    # 2. zero storage, then materialized on the device, sharded across ranks
    if mesh is None and process_count() > 1:
        mesh = create_mesh({"fsdp": process_count()})
    rule = fsdp_shard_rule(mesh) if mesh is not None else None

    def card_bytes():
        return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0

    manual_seed(seed)
    before = card_bytes()
    with _PeakRss() as rss:
        t0 = time.perf_counter()
        model = deferred_init(Llama.from_name, name, device=device)
        t1 = time.perf_counter()
        materialize_module(model, sharding_rule=rule)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
    out.update(n_params=sum(p.numel() for p in model.parameters()) if rule is None else None,
               deferred_init_s=t1 - t0, materialize_s=t2 - t1,
               host_rss_before_gb=rss.before, host_rss_peak_gb=rss.peak,
               card_bytes=card_bytes() - before, sharded=rule is not None, model=model)
    if rule is not None:
        from ..parallel.mesh import sharding_of

        out["n_params"] = sum(
            torch.Size(sharding_of(p)[1]).numel() if sharding_of(p) else p.numel()
            for p in model.parameters())
    where = f"{mesh.size} ranks" if rule is not None else "1 device"
    log_fn(f"deferred_init: {out['deferred_init_s']:.1f}s | materialize onto {where}: "
           f"{out['materialize_s']:.1f}s | host RSS {rss.before:.2f} -> {rss.peak:.2f} GB | "
           f"{out['card_bytes'] / 1e9:.2f} GB on the card")
    return out
