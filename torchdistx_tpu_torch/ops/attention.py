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


def _einsum_logits(q, k, scale):
    # the product runs in the input dtype (as XLA's einsum does), the
    # logits are then widened to f32 and scaled
    return torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale


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
    so it goes to ``flash_attention`` when ``use_flash`` resolves on (auto:
    CUDA tensors).  The CUDA kernel masks ragged tiles itself, so the JAX
    path's padding of S to a multiple of 128 is not needed.
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
        if window is not None:
            raise NotImplementedError(
                "sliding-window flash prefill is not ported yet"
            )
        out = flash_attention(q, k_new, v_new, causal=True, scale=scale)
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
        return torch.einsum("bhqk,bkhd->bqhd", probs, vw), (ck, cv)
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
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv), (ck, cv)


def _slot_attend(q, ck, cv, positions, scale: Optional[float],
                 window: Optional[int]):
    """The plain per-slot attend: row ``b`` attends rows ``j <=
    positions[b]`` (within the trailing ``window`` when set)."""
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
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv)


def slot_cached_attention(
    q, k_new, v_new, cache: tuple, positions, *,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    use_flash: Optional[bool] = None,
    page_tables=None,
):
    """Single-token batched decode where each batch row (serving slot) sits
    at its own cache depth: row ``b``'s new K/V are written in place at
    ``positions[b]`` and its query attends slots ``j <= positions[b]``.
    ``cache`` is the slab ``(k, v)`` of shape (B, max_seq, Hkv, D);
    ``positions`` is (B,) integer on the cache's device.  Returns
    (out, (ck, cv)).

    **Kernel decode**: when ``use_flash`` resolves on (auto: CUDA tensors)
    and no ``window`` is set, the attend goes to ``decode_attention``;
    windowed decode stays on the plain path.  The paged, quantized and
    multi-token (speculative) variants are not ported yet and raise."""
    b, s, hq, d = q.shape
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if page_tables is not None:
        raise NotImplementedError("paged KV cache is not ported yet")
    if len(cache) != 2:
        raise NotImplementedError("quantized KV cache is not ported yet")
    if s != 1:
        raise NotImplementedError(
            "multi-token slot decode (speculative verify) is not ported yet"
        )
    ck, cv = cache
    rows = torch.arange(b, device=ck.device)
    pos = positions.to(ck.device).long().clamp(0, ck.shape[1] - 1)
    ck[rows, pos] = k_new[:, 0].to(ck.dtype)
    cv[rows, pos] = v_new[:, 0].to(cv.dtype)
    from .flash_attention import resolve_use_flash

    if window is None and resolve_use_flash(use_flash, q.device):
        from .decode_attention import decode_attention

        return decode_attention(q, ck, cv, positions, scale=scale), (ck, cv)
    return _slot_attend(q, ck, cv, positions, scale, window), (ck, cv)


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
    if causal:
        ones = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        mask = torch.tril(ones, diagonal=skv - sq)
        if window is not None:
            mask = mask & torch.triu(ones, diagonal=skv - sq - (window - 1))
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
