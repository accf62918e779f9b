"""Attention ops, counterpart of ``torchdistx_tpu/ops/attention.py`` (the
single-device and serving paths; the sequence-parallel ring/Ulysses paths
are a later slice).

Shapes follow (batch, seq, heads, head_dim) throughout.  GQA is supported
by passing fewer KV heads; they are broadcast over query-head groups.

The caches are updated IN PLACE: the JAX package returns a new cache from a
functional ``dynamic_update_slice`` and relies on buffer donation to avoid
the copy; here the write is a ``copy_``/index assignment into the cache the
caller passed, which is also returned.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "multihead_attention",
    "cached_attention",
    "slot_cached_attention",
]


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _promoted(a, b):
    """Both operands in their promoted dtype, as ``jnp.einsum`` promotes a
    bf16 query against a dequantized f32 cache."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _einsum_logits(q, k, scale):
    # the product runs in the input dtype (as XLA's einsum does), the
    # logits are then widened to f32 and scaled
    return torch.einsum("bqhd,bkhd->bhqk", *_promoted(q, k)).float() * scale


def _einsum_out(probs, v, dtype):
    """P.V in the promoted dtype, returned in ``dtype`` (the query's)."""
    return torch.einsum("bhqk,bkhd->bqhd", *_promoted(probs, v)).to(dtype)


def _write_rows(cache, x, start: int):
    """``dynamic_update_slice`` along the sequence axis, in place.  The
    start clamps into range exactly as XLA clamps it."""
    s = x.shape[1]
    start = min(max(int(start), 0), cache.shape[1] - s)
    cache[:, start:start + s].copy_(x.to(cache.dtype))


def cached_attention(
    q, k_new, v_new, cache: tuple, cache_pos, *,
    scale: Optional[float] = None,
    bias=None,
    use_flash: Optional[bool] = None,
    window: Optional[int] = None,
):
    """Incremental attention against a static-shape KV cache.

    ``q``/``k_new``/``v_new``: (B, S, H, D); ``cache`` is ``(k, v)`` of shape
    (B, max_seq, Hkv, D), written in place at ``cache_pos``; slot ``j`` is
    visible to query ``i`` iff ``j <= cache_pos + i``.  Returns
    (out, (ck, cv)).

    **Flash prefill**: the from-empty prefill (``cache_pos`` the int 0,
    S > 1, no bias) is ordinary causal attention over the new keys alone,
    within the sliding ``window`` when one is set, so it goes to
    ``flash_attention`` when ``use_flash`` resolves on (auto: CUDA
    tensors).  The CUDA kernel masks ragged tiles itself, so the JAX path's
    padding of S to a multiple of 128 is not needed.  Windowed decode stays
    plain, as in the JAX package.
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    b, s, hq, d = q.shape
    ck, cv = cache
    pos_is_int = isinstance(cache_pos, int) and not isinstance(cache_pos, bool)
    cache_pos_i = int(cache_pos)
    _write_rows(ck, k_new, cache_pos_i)
    _write_rows(cv, v_new, cache_pos_i)
    from .flash_attention import flash_attention, resolve_use_flash

    if (
        bias is None
        and s > 1
        and pos_is_int
        and cache_pos_i == 0
        and resolve_use_flash(use_flash, q.device)
    ):
        out = flash_attention(q, k_new, v_new, causal=True, scale=scale,
                              window=window)
        return out, (ck, cv)
    max_seq, hkv = ck.shape[1], ck.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if window is not None and bias is None and s == 1 and window < max_seq:
        # windowed single-token decode: attend a W-slice of the cache
        start = min(max(cache_pos_i + s - window, 0), max_seq - window)
        kw = _repeat_kv(ck[:, start:start + window], hq // hkv)
        vw = _repeat_kv(cv[:, start:start + window], hq // hkv)
        logits = _einsum_logits(q, kw, scale)
        pos = start + torch.arange(window, device=q.device)
        visible = pos[None, :] <= cache_pos_i
        logits = logits.masked_fill(~visible[None, None], float("-inf"))
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return _einsum_out(probs, vw, q.dtype), (ck, cv)
    kk = _repeat_kv(ck, hq // hkv)
    vv = _repeat_kv(cv, hq // hkv)
    logits = _einsum_logits(q, kk, scale)
    if bias is not None:
        logits = logits + bias[None].float()
    cols = torch.arange(max_seq, device=q.device)[None, :]
    rows = cache_pos_i + torch.arange(s, device=q.device)[:, None]
    visible = cols <= rows
    if window is not None:
        visible = visible & (cols > rows - window)
    logits = logits.masked_fill(~visible[None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _einsum_out(probs, vv, q.dtype), (ck, cv)


def _slot_attend(q, ck, cv, positions, scale: Optional[float],
                 window: Optional[int]):
    """The plain per-slot attend shared by the contiguous and paged decode
    paths (``ck``/``cv`` the slab or a page-table gather of it): row ``b``
    attends rows ``j <= positions[b]`` (within the trailing ``window`` when
    set).  Returns ``q.dtype``: the JAX package's plain path promotes a
    bf16 query over a dequantized f32 cache to an f32 output, the port
    returns the query's dtype, as every kernel does (identical for f32)."""
    b, s, hq, d = q.shape
    max_seq, hkv = ck.shape[1], ck.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kk = _repeat_kv(ck, hq // hkv)
    vv = _repeat_kv(cv, hq // hkv)
    logits = _einsum_logits(q, kk, scale)
    slots = torch.arange(max_seq, device=q.device)[None, :]
    pos = positions.to(q.device).long()[:, None]
    visible = slots <= pos
    if window is not None:
        visible = visible & (slots > pos - window)
    logits = logits.masked_fill(~visible[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _einsum_out(probs, vv, q.dtype)


def _slot_attend_block(q, ck, cv, positions, scale: Optional[float]):
    """Multi-token sibling of :func:`_slot_attend` for the speculative
    verify block: ``q`` is (B, S, Hq, D) and query row ``i`` of slot ``b``
    attends cache rows ``j <= positions[b] + i``.  Same op chain; every op
    is row-independent, so row 0 is the S == 1 result."""
    b, s, hq, d = q.shape
    max_seq, hkv = ck.shape[1], ck.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kk = _repeat_kv(ck, hq // hkv)
    vv = _repeat_kv(cv, hq // hkv)
    logits = _einsum_logits(q, kk, scale)
    slots = torch.arange(max_seq, device=q.device)[None, None, :]
    depths = (positions.to(q.device).long()[:, None]
              + torch.arange(s, device=q.device)[None, :])  # (B, S)
    visible = slots <= depths[:, :, None]  # (B, S, max_seq)
    logits = logits.masked_fill(~visible[:, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return _einsum_out(probs, vv, q.dtype)


def slot_cached_attention(
    q, k_new, v_new, cache: tuple, positions, *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    use_flash: Optional[bool] = None,
    page_tables=None,
):
    """Batched decode where each batch row (serving slot) sits at its own
    cache depth: row ``b``'s ``S`` new K/V rows are written in place at
    ``positions[b] + [0..S)`` and its query row ``i`` attends rows
    ``j <= positions[b] + i``.  ``S == 1`` is the decode step; ``S > 1`` the
    speculative verify block (``ServeEngine(speculate=K)``, ``S = K + 1``),
    whose rows past the cache end are dropped, never clamped.

    ``cache`` is the slab ``(k, v)`` of shape (B, max_seq, Hkv, D), or with
    ``page_tables`` (B, pages_per_slot) int32 the per-layer page pools
    (num_pages, page_size, Hkv, D): row ``b``'s logical cache is the chain
    of pages ``page_tables[b]`` names.  A quantized cache is the 4-tuple
    ``(k, v, k_scale, v_scale)`` (``kv_dtype="int8"``): new rows quantize on
    write and are read dequantized.  ``positions`` is (B,) integer on the
    cache's device.  Returns ``(out, cache)`` with the cache in the form it
    was given.

    **Kernel decode**: when ``use_flash`` resolves on (auto: CUDA tensors)
    and no ``window`` is set, the attend goes to one of the four decode
    kernels (``ops.decode_attention``): slab or paged, one token or a block,
    bf16 or int8, any ``page_size``.  Otherwise it runs the plain math over
    the slab, a page-table gather of the pools, or their dequantized view."""
    b, s, hq, d = q.shape
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if s != 1 and window is not None:
        raise ValueError(
            f"multi-token slot decode does not support window "
            f"(got S={s}, window={window})"
        )
    from ..serve.kv_cache import (
        dequantize_kv,
        paged_scatter_tokens,
        quantize_kv,
        scatter_slot_tokens,
    )
    from .flash_attention import resolve_use_flash

    quantized = len(cache) == 4
    if quantized:
        ck, cv, cks, cvs = cache
        (wk, sk), (wv, sv) = quantize_kv(k_new), quantize_kv(v_new)
        writes = ((ck, wk), (cv, wv), (cks, sk), (cvs, sv))
    else:
        ck, cv = cache
        cks = cvs = None
        writes = ((ck, k_new), (cv, v_new))
    kernel = window is None and resolve_use_flash(use_flash, q.device)
    if page_tables is not None:
        ps = ck.shape[1]
        for dst, x in writes:
            paged_scatter_tokens(dst, x, page_tables, positions, ps)
        if kernel:
            from . import decode_attention as da

            fn = da.paged_decode_attention if s == 1 else da.paged_decode_attention_block
            out = fn(q, ck, cv, page_tables, positions, scale=scale,
                     k_scale=cks, v_scale=cvs)
            return out, cache
        view = lambda t: _paged_gather(t, page_tables)  # noqa: E731
        vk, vv = view(ck), view(cv)
        if quantized:
            vk, vv = dequantize_kv(vk, view(cks)), dequantize_kv(vv, view(cvs))
    else:
        if s == 1:
            rows = torch.arange(b, device=ck.device)
            pos = positions.to(ck.device).long().clamp(0, ck.shape[1] - 1)
            for dst, x in writes:
                dst[rows, pos] = x[:, 0].to(dst.dtype)
        else:
            for dst, x in writes:
                scatter_slot_tokens(dst, x, positions)
        if kernel:
            from . import decode_attention as da

            fn = da.decode_attention if s == 1 else da.decode_attention_block
            out = fn(q, ck, cv, positions, scale=scale, k_scale=cks,
                     v_scale=cvs)
            return out, cache
        vk, vv = ck, cv
        if quantized:
            vk, vv = dequantize_kv(ck, cks), dequantize_kv(cv, cvs)
    if s == 1:
        return _slot_attend(q, vk, vv, positions, scale, window), cache
    return _slot_attend_block(q, vk, vv, positions, scale), cache


def _paged_gather(pool, page_tables):
    """The logical (B, pages_per_slot * page_size, ...) view of ``pool``
    through ``page_tables``: a gather, bit-identical to the slab's rows."""
    ps = pool.shape[1]
    tables = page_tables.to(pool.device).long()
    rows = (tables[:, :, None] * ps
            + torch.arange(ps, device=pool.device)[None, None, :])
    return pool.reshape(-1, *pool.shape[2:])[rows.reshape(tables.shape[0], -1)]


def _causal_mask(sq: int, skv: int, causal: bool, window: Optional[int], device):
    """The (Sq, Skv) bool visibility of the end-aligned causal mask (query
    ``i`` sees keys ``j <= i + Skv - Sq``) and, with a ``window``, its band
    ``j > i + Skv - Sq - window``; None when every pair is seen."""
    if not causal:
        return None
    ones = torch.ones((sq, skv), dtype=torch.bool, device=device)
    mask = torch.tril(ones, diagonal=skv - sq)
    if window is not None:
        mask = mask & torch.triu(ones, diagonal=skv - sq - (window - 1))
    return mask


def multihead_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None,
                        window: Optional[int] = None):
    """(B, Sq, Hq, D) x (B, Skv, Hkv, D)^2 -> (B, Sq, Hq, D); f32 softmax,
    end-aligned causal mask, optional sliding ``window``."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq != hkv:
        k = _repeat_kv(k, hq // hkv)
        v = _repeat_kv(v, hq // hkv)
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = _einsum_logits(q, k, scale)
    mask = _causal_mask(sq, skv, causal, window, q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
