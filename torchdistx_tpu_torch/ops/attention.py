"""Attention ops, counterpart of ``torchdistx_tpu/ops/attention.py``: the
single-device and serving paths, and the sequence-parallel ones (the ring,
flash-backed or plain, and Ulysses) over a mesh axis of
``parallel.collectives``.

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
    "ring_attention",
    "ring_flash_attention",
    "ring_flash_fwd_block",
    "ring_bwd_block",
    "ulysses_attention",
    "sp_attention",
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
        _tap_quant,
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
        _tap_quant(k_new, wk, sk)
        _tap_quant(v_new, wv, sv)
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


# -- sequence parallelism ----------------------------------------------------------
#
# Inside a mesh with the sequence dim sharded over ``axis``, each rank holds
# its block of queries and keys.  The ring passes K/V blocks from rank i to
# rank i + 1 (``collectives.shift``); after ``t`` hops rank ``idx`` holds
# block ``j = (idx - t) mod n``.  Causal: blocks ``j < idx`` are fully
# visible, ``j == idx`` takes the local causal mask, ``j > idx`` is
# skipped.  K/V travel at hkv heads.


_NEG_INF = -1e30  # the TPU kernels' finite mask value


def _ring_bias_block(bias, j, skv):
    """The held block's bias columns: shard j's keys are global columns
    [j * skv, (j + 1) * skv)."""
    return None if bias is None else bias[:, :, j * skv:(j + 1) * skv]


def _validate_ring_bias(name, bias, hq, sq, n, skv):
    if bias is not None and tuple(bias.shape) != (hq, sq, n * skv):
        raise ValueError(
            f"{name} bias shape {tuple(bias.shape)} != (H, sq_local, "
            f"S_global) = {(hq, sq, n * skv)} — keep the key dim of the "
            "bias UNsharded (in_specs P(None, axis, None))"
        )


def _record_ring_pass(ax, blocks) -> None:
    """Book one ring pass into the comm audit as the JAX ring does: ``n``
    ``ppermute`` hops of each rotating tensor (its scan's home-coming hop
    included) and of the 4-byte block index (None in ``blocks``).  The
    ring's own ``shift`` calls run muted: they are these rows."""
    from ..obs.comm import record_collective

    for blk in blocks:
        if blk is None:
            record_collective("ppermute", ax, payload_bytes=4, count=ax.size,
                              axis_size=ax.size)
        else:
            record_collective("ppermute", ax, blk, count=ax.size, axis_size=ax.size)


def _hops(n, idx, causal):
    """(hop, held block j, whether block j is computed, its causal mask)."""
    for t in range(n):
        j = (idx - t) % n
        yield t, j, not (causal and j > idx), causal and j == idx


def ring_attention(q, k, v, *, axis, causal: bool = True,
                   scale: Optional[float] = None, bias=None):
    """Ring attention over sequence shards, the plain path (the JAX ``jnp``
    ring): each hop attends the local queries to the held K/V block with
    an f32 online softmax, then passes the block on.  Differentiable by
    autograd (the shift's backward is the opposite shift).  ``bias``:
    (H, sq_local, S_global), this shard's query rows against every key."""
    from ..obs.comm import muted
    from ..parallel.collectives import shift
    from ..parallel.mesh import resolve_axis

    ax = resolve_axis(axis)
    n, idx = ax.size, ax.index
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    _validate_ring_bias("ring_attention", bias, hq, sq, n, skv)
    _record_ring_pass(ax, (k, v, None))
    n_rep = hq // hkv
    scale_ = scale if scale is not None else 1.0 / math.sqrt(d)
    local_mask = torch.tril(torch.ones((sq, skv), dtype=torch.bool, device=q.device))
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    row_max = torch.full((b, hq, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    row_sum = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
    kb, vb = k, v
    for t, j, _, diag in _hops(n, idx, causal):
        # every hop computes, the blocks after this shard's masked whole, as
        # the JAX ring does: each rank's autograd graph then holds every
        # shift, and the backward's shifts pair up across the ranks
        logits = _einsum_logits(q, _repeat_kv(kb, n_rep), scale_)
        if bias is not None:
            logits = logits + _ring_bias_block(bias, j, skv)[None].float()
        if causal and j > idx:
            logits = torch.full_like(logits, _NEG_INF)
        elif diag:
            logits = logits.masked_fill(~local_mask, _NEG_INF)
        new_max = torch.maximum(row_max, logits.amax(-1))
        correction = torch.exp(row_max - new_max)
        probs = torch.exp(logits - new_max[..., None])
        row_sum = row_sum * correction + probs.sum(-1)
        acc = acc * correction[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", probs, _repeat_kv(vb, n_rep).float())
        row_max = new_max
        if t < n - 1:
            with muted():
                kb, vb = shift((kb, vb), ax)
    out = acc / row_sum.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def _ring_combine(acc, m, l, raw_j, m_j, l_j):
    """Two-level online-softmax merge, in f32: fold one block's raw
    accumulator ``raw_j`` (B, Sq, Hq, D) and its (m_j, l_j) (B, Hq, Sq)
    into the running ``acc`` (B, Hq, Sq, D) and (m, l)."""
    new_m = torch.maximum(m, m_j)
    alpha = torch.exp(m - new_m)
    beta = torch.exp(m_j - new_m)
    acc = acc * alpha[..., None] + raw_j.transpose(1, 2) * beta[..., None]
    return acc, new_m, l * alpha + l_j * beta


def ring_flash_fwd_block(q, kb, vb, acc, m, l, *, causal: bool,
                         scale: Optional[float] = None, bias=None):
    """One hop of the flash ring's forward: the residuals kernel on the
    held block (``causal`` on the diagonal block; ``bias`` its column
    slice), merged into (acc, m, l) by ``_ring_combine``."""
    from .flash_attention import flash_attention_residuals

    return _ring_combine(acc, m, l, *flash_attention_residuals(
        q, kb, vb, causal=causal, scale=scale, bias=bias))


def ring_bwd_block(q, kb, vb, o, lse, do, bias=None, *, causal: bool,
                   scale: Optional[float] = None, delta=None):
    """One hop of the flash ring's backward: the dK/dV and dQ kernels on the
    held block, seeded with the GLOBAL row lse (so each block's partial
    probabilities are exact) and the global output ``o``, writing f32
    partials; with ``bias`` (the block's column slice) the dbias kernel
    too.  ``delta``: ``flash_bwd_delta(o, do)``, the same at every hop
    (computed here unless given).  Returns f32 (dq, dk, dv, dbias or
    None); the GQA groups of dk and dv are summed in the kernel."""
    from .flash_attention import flash_backward

    grads = flash_backward(q, kb, vb, o, lse, do, causal=causal, scale=scale, bias=bias,
                           dq_dtype=torch.float32, part_dtype=torch.float32, delta=delta)
    return (*grads[:3], grads[3].float() if bias is not None else None)



class _RingFlash(torch.autograd.Function):
    """The flash ring with the JAX whole-ring VJP: the forward's per-hop
    residuals merged in f32, the global lse saved; the backward a second
    ring in which the f32 dK/dV accumulators travel with their blocks and
    land home after n hops, and dbias is written by column slice (each
    block visits once)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, ax, causal, scale):
        from ..obs.comm import muted
        from ..parallel.collectives import shift

        _record_ring_pass(ax, (k, v, None))
        n, idx = ax.size, ax.index
        b, sq, hq, d = q.shape
        skv = k.shape[1]
        acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, hq, sq), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hq, sq), dtype=torch.float32, device=q.device)
        kb, vb = k, v
        for t, j, compute, diag in _hops(n, idx, causal):
            if compute:
                acc, m, l = ring_flash_fwd_block(q, kb, vb, acc, m, l, causal=diag, scale=scale,
                                                 bias=_ring_bias_block(bias, j, skv))
            if t < n - 1:
                with muted():
                    kb, vb = shift((kb, vb), ax)
        safe_l = l.clamp_min(1e-30)
        out = (acc / safe_l[..., None]).transpose(1, 2).to(q.dtype)
        lse = m + torch.log(safe_l)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.ax, ctx.causal, ctx.scale = ax, causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        from ..obs.comm import muted
        from ..parallel.collectives import shift
        from .flash_attention import flash_bwd_delta

        q, k, v, bias, out, lse = ctx.saved_tensors
        ax, causal, scale = ctx.ax, ctx.causal, ctx.scale
        n, idx = ax.size, ax.index
        skv = k.shape[1]
        g = g.contiguous()
        delta = flash_bwd_delta(out, g)  # o and dO are the same at every hop
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        db = (torch.zeros(bias.shape, dtype=torch.float32, device=q.device)
              if bias is not None else None)
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        # five tensors rotate: the K/V blocks, their f32 accumulators, the index
        _record_ring_pass(ax, (k, v, dkb, dvb, None))
        kb, vb = k, v
        for t, j, compute, diag in _hops(n, idx, causal):
            if compute:
                dq_c, dk_c, dv_c, db_c = ring_bwd_block(
                    q, kb, vb, out, lse, g, _ring_bias_block(bias, j, skv),
                    causal=diag, scale=scale, delta=delta)
                dq += dq_c
                dkb += dk_c
                dvb += dv_c
                if db_c is not None:
                    db[:, :, j * skv:(j + 1) * skv] = db_c
            with muted():
                if t < n - 1:
                    kb, vb = shift((kb, vb), ax)
                dkb, dvb = shift((dkb, dvb), ax)
        dbias = db.to(bias.dtype) if bias is not None else None
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), dbias,
                None, None, None)


def ring_flash_attention(q, k, v, *, axis, causal: bool = True,
                         scale: Optional[float] = None, bias=None):
    """Ring attention with the flash kernels per hop: the same schedule and
    exact result as :func:`ring_attention`, without an (sq x skv) logits
    matrix per hop.  The forward merges the residuals kernel's raw f32
    blocks; the backward is a second ring through the dK/dV and dQ kernels'
    f32 variants (the plain versions on CPU tensors).  Differentiable in
    q, k, v and ``bias`` (H, sq_local, S_global)."""
    from ..parallel.mesh import resolve_axis

    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            "causal ring attention requires equal per-shard query and key "
            f"lengths, got {q.shape[1]} vs {k.shape[1]}"
        )
    ax = resolve_axis(axis)
    if bias is not None:
        _validate_ring_bias("ring_flash_attention", bias, q.shape[2], q.shape[1],
                            ax.size, k.shape[1])
    return _RingFlash.apply(q, k, v, bias, ax, causal, scale)


def ulysses_attention(q, k, v, *, axis, causal: bool = True,
                      scale: Optional[float] = None, use_flash: Optional[bool] = None):
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism: one all-to-all
    reshards (seq-sharded, all heads) to (full seq, heads / n), attention
    runs locally (the flash kernels when ``use_flash`` resolves on), and a
    second all-to-all reshards back.  Needs query and kv head counts
    divisible by the axis size."""
    from ..parallel.collectives import all_to_all
    from ..parallel.mesh import resolve_axis
    from .flash_attention import flash_attention, resolve_use_flash

    ax = resolve_axis(axis)
    n = ax.size
    hq, hkv = q.shape[2], k.shape[2]
    if hq % n != 0 or hkv % n != 0:
        raise ValueError(
            f"ulysses_attention needs head counts divisible by the axis "
            f"size: hq={hq}, hkv={hkv}, |{ax.name}|={n} — use ring attention "
            "for non-dividing head counts"
        )
    qg, kg, vg = (all_to_all(t, ax, 2, 1) for t in (q, k, v))
    if resolve_use_flash(use_flash, q.device):
        out = flash_attention(qg, kg, vg, causal=causal, scale=scale)
    else:
        out = multihead_attention(qg, kg, vg, causal=causal, scale=scale)
    return all_to_all(out, ax, 1, 2)


def sp_attention(q, k, v, *, axis, mode: str = "ring", causal: bool = True,
                 scale: Optional[float] = None, bias=None,
                 use_flash: Optional[bool] = None):
    """The sequence-parallel dispatch the models share: "ring" takes the
    flash ring when ``use_flash`` resolves on (auto: CUDA tensors) and the
    plain ring otherwise; "ulysses" the all-to-all strategy (no bias)."""
    from .flash_attention import resolve_use_flash

    if mode == "ulysses":
        if bias is not None:
            raise ValueError(
                "ulysses sequence parallelism does not support an additive "
                "bias; use mode='ring'"
            )
        return ulysses_attention(q, k, v, axis=axis, causal=causal, scale=scale,
                                 use_flash=use_flash)
    if mode != "ring":
        raise ValueError(f"sp mode must be 'ring' or 'ulysses', got {mode!r}")
    if resolve_use_flash(use_flash, q.device):
        return ring_flash_attention(q, k, v, axis=axis, causal=causal, scale=scale,
                                    bias=bias)
    return ring_attention(q, k, v, axis=axis, causal=causal, scale=scale, bias=bias)
