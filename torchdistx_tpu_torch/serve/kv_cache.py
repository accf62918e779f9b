"""Slot-based, fixed-geometry KV cache for continuous batching, counterpart
of ``torchdistx_tpu/serve/kv_cache.py`` (the contiguous slab layout; the
paged pools and int8 quantization are later slices).

:class:`SlotKVCache` holds per layer ``(k, v)`` tensors of shape
``(num_slots, max_len, heads, head_dim)`` — the model's own
``init_cache(num_slots, max_len)`` — on the model's device, plus host
numpy bookkeeping (per-slot positions and active bits).  Admitting or
retiring a request changes only that bookkeeping, never a device shape.

Stale-row safety: a retired slot's rows are not zeroed.  A query attends
rows ``j <= pos`` only, prefill overwrites the rows it claims, and each
decode step writes row ``pos`` before ``pos`` advances to make it visible,
so every visible row was written by the request that owns the slot.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

__all__ = ["SlotKVCache", "write_slot"]


def write_slot(kv: List[tuple], slab: List[tuple], slot: int) -> List[tuple]:
    """Write one request's prefilled cache slab (per layer ``(k, v)`` of
    shape (1, bucket, H, D)) into slot row ``slot`` of the engine cache.

    The write is an in-place ``copy_`` into the engine's slab.  The JAX
    package writes with a functional ``dynamic_update_slice`` inside a
    program that donates the slab, so XLA aliases it in place; here the
    in-place write is explicit.  Returns ``kv`` itself."""
    for (ck, cv), (sk, sv) in zip(kv, slab):
        n = sk.shape[1]
        ck[slot, :n].copy_(sk[0].to(ck.dtype))
        cv[slot, :n].copy_(sv[0].to(cv.dtype))
    return kv


class _HostBookkeeping:
    """The pos/active arrays: ``pos[slot]`` is the number of tokens cached
    for the slot (the row its NEXT token is written to); ``active[slot]``
    marks slots owned by a running request."""

    num_slots: int
    max_len: int

    def _init_host(self, num_slots: int, max_len: int) -> None:
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.pos = np.zeros(self.num_slots, np.int32)
        self.active = np.zeros(self.num_slots, bool)

    def admit(self, slot: int, true_len: int) -> None:
        """Claim ``slot`` for a freshly prefilled request of ``true_len``
        prompt tokens."""
        if self.active[slot]:
            raise ValueError(f"slot {slot} is already active")
        if not 0 < true_len <= self.max_len:
            raise ValueError(
                f"prompt length {true_len} outside (0, {self.max_len}]"
            )
        self.pos[slot] = true_len
        self.active[slot] = True

    def advance_slot(self, slot: int) -> None:
        """One slot cached one more token (per slot: a finished slot stays
        where the device froze it)."""
        self.pos[slot] += 1

    def retire(self, slot: int) -> None:
        self.active[slot] = False

    def full(self, slot: int) -> bool:
        """No room to decode another token into this slot."""
        return int(self.pos[slot]) >= self.max_len

    def positions(self) -> np.ndarray:
        """Per-slot write positions for decode, clamped into range for
        inactive slots (their rows are dead weight either way)."""
        return np.clip(self.pos, 0, self.max_len - 1).astype(np.int32)

    @property
    def active_count(self) -> int:
        return int(self.active.sum())

    @property
    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for pair in self.kv for a in pair)


class SlotKVCache(_HostBookkeeping):
    """Host bookkeeping around the contiguous per-slot device cache."""

    def __init__(self, model: Any, num_slots: int, max_len: int):
        self._init_host(num_slots, max_len)
        self.kv = model.init_cache(self.num_slots, self.max_len)
        self.device: torch.device = self.kv[0][0].device
