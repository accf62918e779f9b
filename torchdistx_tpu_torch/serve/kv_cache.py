"""Slot- and page-based, fixed-geometry KV caches for continuous batching,
counterpart of ``torchdistx_tpu/serve/kv_cache.py``.

Two device layouts behind one host-bookkeeping contract:

- :class:`SlotKVCache` -- per layer ``(k, v)`` tensors of shape
  ``(num_slots, max_len, heads, head_dim)`` (the model's own
  ``init_cache(num_slots, max_len)``).
- :class:`PagedKVCache` -- per layer ``(k, v)`` **page pools** of shape
  ``(num_pages, page_size, heads, head_dim)`` plus host-side per-slot page
  tables of ``max_len / page_size`` entries.  A slot's logical cache is the
  concatenation of the pages its table row names; page-aligned shared
  prefixes are handed over by table rewrite (two tables naming the same
  page), never by copying KV.

``kv_dtype="int8"`` stores each layer as ``(k, v, k_scale, v_scale)``: int8
data plus f32 per-row per-head scales of shape ``(lead, rows, Hkv, 1)``.
The scales are powers of two (``2^ceil(log2(amax / 127))`` through
``frexp``/``ldexp``), so ``dequantize(quantize(x))`` requantizes to the same
values bit for bit -- what keeps untouched prefix rows stable across the
dequantize -> forward -> requantize trip of a paged prefill.

Tensor-parallel serving splits every cache tensor over the KV heads
(``sharding=``, a ``parallel.mesh.NamedSharding`` whose spec cuts dim 2,
the ``kv_cache`` rule of ``parallel.tp.llama_tp_plan``): a rank holds
``Hkv / tp`` heads of the data and of the int8 scales alike, each tensor
marked with its sharding and its whole shape (``parallel.mesh.
sharding_of``).  ``nbytes`` counts the whole cache, as the JAX package's
does; a rank holds ``nbytes / tp``.

Admitting or retiring a request changes only host bookkeeping (positions,
a table row, an active bit), never a device shape.  The JAX package writes
with functional updates inside programs that donate the cache; here every
write is in place into the tensors the engine holds, and each function
returns what it was given.

Stale-row safety: freed pages and retired slots are not zeroed.  A query
attends rows ``j <= pos`` only, prefill overwrites the rows it claims, each
decode step writes row ``pos`` before ``pos`` advances to make it visible,
and a retired slot's table names the scratch page.  Speculative verify
writes ``S`` rows per slot but ``pos`` advances only by the accepted count;
the rejected rows sit beyond the live depth and are rewritten before the
mask reaches them.  Rows past ``max_len`` are DROPPED, never clamped onto
the last row and never wrapped into the next slot.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from ..obs.numerics import tap, tap_made
from .prefix_cache import SCRATCH_PAGE

__all__ = [
    "init_kv",
    "SlotKVCache",
    "PagedKVCache",
    "write_slot",
    "paged_view",
    "paged_scatter_rows",
    "scatter_slot_tokens",
    "paged_scatter_tokens",
    "quantize_kv",
    "dequantize_kv",
    "quantize_cache",
    "dequantize_cache",
    "canonicalize_kv_dtype",
]

_KV_DTYPES = {
    "int8": torch.int8,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


def canonicalize_kv_dtype(kv_dtype: Any) -> Optional[str]:
    """``None`` -> model-default cache dtype; otherwise a canonical dtype
    name from the supported set (``int8`` quantized; ``bfloat16`` /
    ``float16`` / ``float32`` plain casts).  A ``torch.dtype`` or a numpy
    dtype is taken by its name."""
    if kv_dtype is None:
        return None
    if isinstance(kv_dtype, str):
        name = kv_dtype
    elif isinstance(kv_dtype, torch.dtype):
        name = str(kv_dtype).replace("torch.", "")
    else:
        name = np.dtype(kv_dtype).name
    if name not in _KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {sorted(_KV_DTYPES)} or None "
            f"(model default), got {kv_dtype!r}"
        )
    return name


def init_kv(model: Any, lead: int, rows: int, sharding: Any = None) -> List[tuple]:
    """Per-layer zero ``(k, v)`` of ``(lead, rows, Hkv, D)`` in the model's
    dtype (``model.init_cache``), or with ``sharding`` this rank's piece of
    each, marked: the head-split cache of tensor-parallel serving."""
    if sharding is None:
        return model.init_cache(lead, rows)
    from ..parallel.mesh import mark_sharded

    cfg = model.cfg
    heads = getattr(cfg, "n_kv_heads", None) or cfg.n_heads
    shape = (lead, rows, heads, cfg.dim // cfg.n_heads)
    local = torch.empty(shape, device="meta")[sharding.shard_slices(shape)].shape
    n_layers = getattr(cfg, "n_layers", None) or cfg.n_layer
    return [tuple(mark_sharded(torch.zeros(local, dtype=cfg.dtype, device=model.device),
                               sharding, shape) for _ in range(2))
            for _ in range(n_layers)]


def _whole_bytes(t: torch.Tensor) -> int:
    from ..parallel.mesh import sharding_of

    found = sharding_of(t)
    return (int(np.prod(found[1])) if found else t.numel()) * t.element_size()


def _mark_like(entry: tuple, sharding: Any) -> tuple:
    """Mark each tensor of a layer's entry as its rank's piece under
    ``sharding`` (the whole shape: the local one times the split counts)."""
    from ..parallel.mesh import mark_sharded
    from ..parallel.reshard import split_counts

    for t in entry:
        counts = split_counts(t.shape, sharding)
        mark_sharded(t, sharding, tuple(n * c for n, c in zip(t.shape, counts)))
    return entry


def quantize_kv(x: torch.Tensor):
    """Quantize K or V rows to ``(int8 data, f32 power-of-two scales)``.

    ``x``: (..., H, D).  Returns ``q`` of ``x.shape`` int8 and ``scale`` of
    ``x.shape[:-1] + (1,)`` f32 with ``scale = 2^ceil(log2(amax/127))`` per
    (row, head) (all-zero rows get 0.5); ``q = clip(round(x / scale), -127,
    127)``, rounding half to even as ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    m, e = torch.frexp(amax / 127.0)
    # frexp: v = m * 2^e, m in [0.5, 1) -- ceil(log2 v) is e except at exact
    # powers of two (m == 0.5), where it is e - 1
    scale = torch.ldexp(torch.ones_like(m), e - (m <= 0.5).to(e.dtype))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Exact inverse read of :func:`quantize_kv`: f32 ``q * scale``."""
    return q.float() * scale


def _dequant_err(orig: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return orig.float() - dequantize_kv(q, scale)


def _tap_quant(orig: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    """Numerics-observatory probe at a quantize-on-write site: the digest of
    the dequantization error ``orig - q * scale`` and of the scale rows
    (``max_abs`` of the scales is the ``s`` of the round-to-nearest bound
    ``|err| <= s / 2``), as (rows, D) and (rows, 1) pieces that a decode
    step's deferring tape concatenates over its writes.  Nothing without an
    active tape."""
    d = orig.shape[-1]
    tap_made("kv_quant_err", _dequant_err, orig.reshape(-1, d), q.reshape(-1, d),
             scale.reshape(-1, 1))
    tap("kv_quant_scale", scale)


def quantize_cache(kv: Any) -> List[tuple]:
    """Pairs -> per-layer ``(k, v, k_scale, v_scale)`` 4-tuples."""
    out: List[tuple] = []
    for k, v in kv:
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        out.append((qk, qv, sk, sv))
    return out


def dequantize_cache(kv: Any) -> List[tuple]:
    """4-tuples (or pass-through pairs) -> f32 ``(k, v)`` pairs."""
    out: List[tuple] = []
    for entry in kv:
        if len(entry) == 4:
            k, v, sk, sv = entry
            out.append((dequantize_kv(k, sk), dequantize_kv(v, sv)))
        else:
            out.append(tuple(entry))
    return out


def write_slot(kv: List[tuple], slab: List[tuple], slot: int) -> List[tuple]:
    """Write one request's prefilled cache slab (per layer ``(k, v)`` of
    shape (1, bucket, H, D)) into slot row ``slot`` of the engine cache, in
    place; quantized 4-tuple caches quantize the slab on write.  Returns
    ``kv`` itself."""
    for entry, (sk, sv) in zip(kv, slab):
        n = sk.shape[1]
        if len(entry) == 4:
            ck, cv, cks, cvs = entry
            for data, scales, x in ((ck, cks, sk), (cv, cvs, sv)):
                qx, sx = quantize_kv(x[0])
                _tap_quant(x[0], qx, sx)
                data[slot, :n].copy_(qx)
                scales[slot, :n].copy_(sx)
            continue
        ck, cv = entry
        ck[slot, :n].copy_(sk[0].to(ck.dtype))
        cv[slot, :n].copy_(sv[0].to(cv.dtype))
    return kv


def _flat(t: torch.Tensor) -> torch.Tensor:
    """(lead, rows, ...) -> (lead * rows, ...), a view."""
    return t.view(-1, *t.shape[2:])


def paged_view(kv: Any, table_row: torch.Tensor, page_size: int) -> List[tuple]:
    """Gather one slot's logical cache from the page pools: per layer
    ``(k, v)`` of shape (1, pages_per_slot * page_size, H, D).  Entries of
    ``table_row`` past the slot's chain name the scratch page (garbage rows
    beyond the visibility mask).  Quantized 4-tuple pools dequantize in the
    gather: the view is always a pair (f32 for int8, exact)."""
    table_row = table_row.to(kv[0][0].device).long()
    rows = (table_row[:, None] * page_size
            + torch.arange(page_size, device=table_row.device)[None, :]).reshape(-1)
    out: List[tuple] = []
    for entry in kv:
        fk, fv = _flat(entry[0])[rows], _flat(entry[1])[rows]
        if len(entry) == 4:
            fk = dequantize_kv(fk, _flat(entry[2])[rows])
            fv = dequantize_kv(fv, _flat(entry[3])[rows])
        out.append((fk[None], fv[None]))
    return out


def paged_scatter_rows(kv: Any, view: Any, table_row: torch.Tensor,
                       page_size: int, start: int, length: int) -> List[tuple]:
    """Write ``length`` rows of an updated slot view, from row ``start``,
    back into the page pools through the slot's table row, in place.  Only
    that span moves: shared prefix pages before ``start`` are never
    rewritten; rows past the slot's allocated pages follow the table to the
    scratch page.  ``start`` clamps into the view as XLA's
    ``dynamic_slice`` clamps it.  Quantized pools quantize on write."""
    table_row = table_row.to(kv[0][0].device).long()
    start = min(max(int(start), 0), view[0][0].shape[1] - length)
    offs = start + torch.arange(length, device=table_row.device)
    rows = table_row[offs // page_size] * page_size + offs % page_size
    for entry, (wk, wv) in zip(kv, view):
        seg_k, seg_v = wk[0, start:start + length], wv[0, start:start + length]
        if len(entry) == 4:
            for data, scales, seg in ((entry[0], entry[2], seg_k),
                                      (entry[1], entry[3], seg_v)):
                qx, sx = quantize_kv(seg)
                _tap_quant(seg, qx, sx)
                _flat(data)[rows] = qx
                _flat(scales)[rows] = sx
            continue
        _flat(entry[0])[rows] = seg_k.to(entry[0].dtype)
        _flat(entry[1])[rows] = seg_v.to(entry[1].dtype)
    return list(kv)


def _token_rows(positions: torch.Tensor, s: int, limit: int):
    """Targets of an ``S``-row write at per-slot depths ``positions``:
    logical rows ``positions[b] + i``, with rows at or past ``limit``
    dropped.  Without a host sync the drop is a rewrite: a dropped row
    writes the slot's last row ``limit - 1`` with the very value its own
    in-range token writes there (the one at ``i = limit - 1 - positions``,
    present whenever anything drops), and a slot whose depth is itself out
    of range rewrites that row with its old value.  Duplicate indices
    therefore carry identical values.  Returns ``(rows, src, keep)``: the
    (B, S) clamped rows, the (B, S) token index each row takes its value
    from, and the (B, 1) mask of slots whose depth is in range."""
    pos = positions.long()[:, None]
    rows = (pos + torch.arange(s, device=pos.device)[None, :]).clamp(max=limit - 1)
    src = (rows - pos).clamp(0, s - 1)
    return rows, src, pos < limit


def _write_tokens(flat: torch.Tensor, flat_rows: torch.Tensor,
                  x_new: torch.Tensor, src: torch.Tensor, keep: torch.Tensor):
    b = x_new.shape[0]
    vals = x_new[torch.arange(b, device=src.device)[:, None], src].to(flat.dtype)
    keep = keep.view(b, 1, *([1] * (vals.dim() - 2)))
    flat[flat_rows] = torch.where(keep, vals, flat[flat_rows])


def scatter_slot_tokens(cache: torch.Tensor, x_new: torch.Tensor,
                        positions: torch.Tensor) -> torch.Tensor:
    """Write ``S`` consecutive rows per slot into the slab, in place: slot
    ``b``'s rows land at ``positions[b] + [0..S)`` of ``cache`` (num_slots,
    max_len, H, D); rows past ``max_len`` are dropped (see
    :func:`_token_rows`).  ``x_new``: (B, S, H, D).  Returns ``cache``."""
    b, max_len = cache.shape[0], cache.shape[1]
    rows, src, keep = _token_rows(positions.to(cache.device), x_new.shape[1],
                                  max_len)
    flat_rows = torch.arange(b, device=cache.device)[:, None] * max_len + rows
    _write_tokens(_flat(cache), flat_rows, x_new, src, keep)
    return cache


def paged_scatter_tokens(pool: torch.Tensor, x_new: torch.Tensor,
                         page_tables: torch.Tensor, positions: torch.Tensor,
                         page_size: int) -> torch.Tensor:
    """Paged sibling of :func:`scatter_slot_tokens`: each slot's ``S`` rows
    go through its page-table row into ``pool`` (num_pages, page_size, H, D),
    in place.  Logical rows past ``pages_per_slot * page_size`` are dropped;
    rows inside it but past the slot's allocated chain follow the table to
    the scratch page.  Returns ``pool``."""
    tables = page_tables.to(pool.device).long()
    rows, src, keep = _token_rows(positions.to(pool.device), x_new.shape[1],
                                  tables.shape[1] * page_size)
    page = torch.gather(tables, 1, rows // page_size)
    _write_tokens(_flat(pool), page * page_size + rows % page_size, x_new,
                  src, keep)
    return pool


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
        """Bytes of the whole cache (every rank's heads)."""
        return sum(_whole_bytes(a) for entry in self.kv for a in entry)

    @property
    def kv_data_nbytes(self) -> int:
        """Bytes of the K/V data tensors alone (scales excluded) -- the
        quantity that halves exactly under ``kv_dtype="int8"``."""
        return sum(_whole_bytes(a) for entry in self.kv for a in entry[:2])

    @property
    def kv_scale_nbytes(self) -> int:
        """Bytes of the f32 scale tensors (0 for unquantized caches)."""
        return sum(_whole_bytes(a) for entry in self.kv for a in entry[2:])

    def _apply_kv_dtype(self, base: Any, kv_dtype: Any, sharding: Any = None) -> List[tuple]:
        """Canonicalize and record ``kv_dtype`` and turn the freshly
        initialized model-dtype pairs into the stored representation
        (each tensor marked with ``sharding``, if any)."""
        self.kv_dtype = canonicalize_kv_dtype(kv_dtype)
        self.quantized = self.kv_dtype == "int8"
        if self.quantized:
            out = quantize_cache(base)
        elif self.kv_dtype is not None:
            dt = _KV_DTYPES[self.kv_dtype]
            out = [(k.to(dt), v.to(dt)) for k, v in base]
        else:
            out = list(base)
        if sharding is not None:
            out = [_mark_like(e, sharding) for e in out]
        return out


class SlotKVCache(_HostBookkeeping):
    """Host bookkeeping around the contiguous per-slot device cache."""

    def __init__(self, model: Any, num_slots: int, max_len: int,
                 kv_dtype: Optional[str] = None, sharding: Any = None):
        self._init_host(num_slots, max_len)
        self.kv = self._apply_kv_dtype(
            init_kv(model, self.num_slots, self.max_len, sharding), kv_dtype, sharding
        )
        self.device: torch.device = self.kv[0][0].device


class PagedKVCache(_HostBookkeeping):
    """Host bookkeeping around the page-pool device cache: per-layer pools
    of shape ``(num_pages, page_size, Hkv, D)`` and the host int32
    ``page_tables`` (num_slots, max_len / page_size), unassigned entries
    naming the scratch page."""

    def __init__(self, model: Any, num_slots: int, max_len: int,
                 page_size: int, num_pages: int,
                 kv_dtype: Optional[str] = None, sharding: Any = None):
        self._init_host(num_slots, max_len)
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size != 0:
            raise ValueError(
                f"max_len {max_len} must be a multiple of page_size "
                f"{page_size}"
            )
        if num_pages < 2:
            raise ValueError(
                f"num_pages must be >= 2 (scratch + one usable), got "
                f"{num_pages}"
            )
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.pages_per_slot = self.max_len // self.page_size
        self.kv = self._apply_kv_dtype(
            init_kv(model, self.num_pages, self.page_size, sharding), kv_dtype, sharding
        )
        self.device: torch.device = self.kv[0][0].device
        self.page_tables = np.full(
            (self.num_slots, self.pages_per_slot), SCRATCH_PAGE, np.int32
        )

    def set_table(self, slot: int, pages: List[int]) -> None:
        """Point ``slot`` at its page chain (prefix order); entries past the
        chain name the scratch page."""
        if len(pages) > self.pages_per_slot:
            raise ValueError(
                f"{len(pages)} pages exceed pages_per_slot "
                f"{self.pages_per_slot}"
            )
        self.page_tables[slot, :] = SCRATCH_PAGE
        self.page_tables[slot, : len(pages)] = pages

    def retire(self, slot: int) -> None:
        """Free the slot AND rewire its table to the scratch page: a fused
        chunk keeps rewriting a finished slot's frozen row, and after its
        pages are freed (and possibly reallocated) those writes must land
        where no live request reads."""
        super().retire(slot)
        self.page_tables[slot, :] = SCRATCH_PAGE
