"""Slot decode attention: the hand-written CUDA kernels, their plain PyTorch
versions, and the dispatchers between them.

Counterpart of ``torchdistx_tpu/ops/decode_attention.py``.  One CUDA source
(``csrc/decode_attention.cu``) replaces its four Pallas kernels, each in
bf16 and with the int8 cache:

- ``decode_attention`` (``_decode_kernel``): one generated token per serving
  slot, each slot at its own depth, read in place from the
  (B, max_len, Hkv, D) slab;
- ``decode_attention_block`` (``_decode_block_kernel``): the speculative
  verify, ``S`` query tokens per slot, row ``i`` masked to depth
  ``positions[b] + i``;
- ``paged_decode_attention`` / ``paged_decode_attention_block``
  (``_paged_decode_kernel`` / ``_paged_decode_block_kernel``): the same
  math over page pools (num_pages, page_size, Hkv, D) read through the
  per-slot page tables, any ``page_size >= 1``.

The int8 cache passes f32 power-of-two scales ``k_scale``/``v_scale`` of
the data's leading dims plus a trailing 1; the kernels dequantize as they
read (``q * scale``, exact).  All are bounded by bytes on an H100; the
source file says what the design does about that.

A CUDA tensor launches a kernel or raises; the plain versions (the JAX
package's ``_slot_attend`` / ``_slot_attend_block`` over the slab, the
page-table gather, or their dequantized view) run only for CPU tensors.
Each ``*_cuda`` wrapper counts its launches in ``.launches`` and, of those,
the int8 ones in ``.int8_launches``.

Every variant, one token or a verify block, runs one kernel that splits
each slot's key range over blocks at the fixed boundaries of
:func:`block_splits` and merges the splits in split order;
:func:`decode_attention_block_split_reference` (and its paged twin) is the
plain version of that algorithm, in f32, for any S (one token: S = 1).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .attention import _paged_gather, _slot_attend, _slot_attend_block

__all__ = [
    "decode_attention",
    "decode_attention_block",
    "paged_decode_attention",
    "paged_decode_attention_block",
    "decode_attention_reference",
    "decode_attention_block_reference",
    "paged_decode_attention_reference",
    "paged_decode_attention_block_reference",
    "decode_attention_block_split_reference",
    "paged_decode_attention_block_split_reference",
    "block_splits",
    "decode_attention_cuda",
    "decode_attention_block_cuda",
    "paged_decode_attention_cuda",
    "paged_decode_attention_block_cuda",
]

_LIB = "decode_attention"
#: query rows (S * n_rep) of a slot and kv head the kernel takes at most
MAX_BLOCK_ROWS = 64
#: keys of one split of the kernel's key range (a multiple of its 64-key
#: tile)
SPLIT_KEYS = 256
_NEG_INF = -1e30  # the TPU kernels' finite mask value


def block_splits(last: int, split_keys: int = SPLIT_KEYS):
    """The key ranges ``[start, end)`` the kernel's splits cover for a
    slot whose deepest visible key is ``last``: split ``i``
    holds keys ``[i * split_keys, (i + 1) * split_keys)``, cut at
    ``last + 1``.  The boundaries depend on the key index alone, never on
    the cache's layout or length, so the slab and the pages split alike."""
    return [(s, min(s + split_keys, last + 1)) for s in range(0, last + 1, split_keys)]


def _check_kv_scales(k_scale, v_scale, ck) -> bool:
    """Validate the optional int8 scale operands; returns ``quantized``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    if k_scale is None:
        return False
    want = tuple(ck.shape[:3]) + (1,)
    if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
        raise ValueError(
            f"kv scale shapes {tuple(k_scale.shape)}/{tuple(v_scale.shape)} "
            f"!= cache rows + trailing 1 {want}"
        )
    return True


def _dequant(ck, cv, k_scale, v_scale):
    if k_scale is None:
        return ck, cv
    from ..serve.kv_cache import dequantize_kv

    return dequantize_kv(ck, k_scale), dequantize_kv(cv, v_scale)


# -- plain versions (CPU tensors, and the kernels' yardstick on the card) --


def decode_attention_reference(q, ck, cv, positions, *, scale=None,
                               k_scale=None, v_scale=None):
    """The plain version: ``_slot_attend`` (``_repeat_kv``, f32 logits and
    softmax over rows ``j <= positions[b]``, probabilities cast to
    ``q.dtype`` before P.V) over the slab or its dequantized view."""
    _check_kv_scales(k_scale, v_scale, ck)
    kk, vv = _dequant(ck, cv, k_scale, v_scale)
    return _slot_attend(q, kk, vv, positions, scale, None)


def decode_attention_block_reference(q, ck, cv, positions, *, scale=None,
                                     k_scale=None, v_scale=None):
    """``_slot_attend_block`` over the slab or its dequantized view."""
    _check_kv_scales(k_scale, v_scale, ck)
    kk, vv = _dequant(ck, cv, k_scale, v_scale)
    return _slot_attend_block(q, kk, vv, positions, scale)


def _paged_views(ck, cv, page_tables, k_scale, v_scale):
    view = lambda t: None if t is None else _paged_gather(t, page_tables)  # noqa: E731
    return _dequant(view(ck), view(cv), view(k_scale), view(v_scale))


def paged_decode_attention_reference(q, ck, cv, page_tables, positions, *,
                                     scale=None, k_scale=None, v_scale=None):
    """``_slot_attend`` over the page-table gather of the pools."""
    _check_kv_scales(k_scale, v_scale, ck)
    kk, vv = _paged_views(ck, cv, page_tables, k_scale, v_scale)
    return _slot_attend(q, kk, vv, positions, scale, None)


def paged_decode_attention_block_reference(q, ck, cv, page_tables, positions,
                                           *, scale=None, k_scale=None,
                                           v_scale=None):
    """``_slot_attend_block`` over the page-table gather of the pools."""
    _check_kv_scales(k_scale, v_scale, ck)
    kk, vv = _paged_views(ck, cv, page_tables, k_scale, v_scale)
    return _slot_attend_block(q, kk, vv, positions, scale)


def _split_attend_block(q, kk, vv, positions, scale, split_keys):
    """The split-and-combine of the kernel in f32 over the (B, max_len,
    Hkv, D) view ``kk``/``vv``: per slot, each split of
    :func:`block_splits` gives its rows' max ``m``, sum ``l`` and raw
    accumulator over its keys (masked keys -1e30 in the max, 0 in P), and
    the splits merge in split order."""
    b, s, hq, d = q.shape
    max_len, hkv = kk.shape[1], kk.shape[2]
    n_rep = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kf = kk.float().repeat_interleave(n_rep, 2)
    vf = vv.float().repeat_interleave(n_rep, 2)
    logits = torch.einsum("bshd,bkhd->bhsk", q.float(), kf) * scale
    pos = positions.long().clamp(0, max_len - 1)
    depth = (pos[:, None] + torch.arange(s)[None, :]).clamp_max(max_len - 1)
    visible = torch.arange(max_len)[None, None, :] <= depth[:, :, None]  # (B, S, K)
    out = torch.empty((b, s, hq, d), dtype=torch.float32)
    for i in range(b):
        big_m = big_l = big_o = None
        for lo, hi in block_splits(int(depth[i, -1]), split_keys):
            vis = visible[i, None, :, lo:hi]
            x = logits[i, :, :, lo:hi].masked_fill(~vis, _NEG_INF)
            m = x.amax(-1)
            p = torch.exp(x - m[..., None]).masked_fill(~vis, 0.0)
            l = p.sum(-1)
            acc = torch.einsum("hsk,khd->hsd", p, vf[i, lo:hi])
            if big_m is None:
                big_m, big_l, big_o = m, l, acc
                continue
            new_m = torch.maximum(big_m, m)
            a, w = torch.exp(big_m - new_m), torch.exp(m - new_m)
            big_l = big_l * a + l * w
            big_o = big_o * a[..., None] + acc * w[..., None]
            big_m = new_m
        out[i] = (big_o / big_l.clamp_min(1e-30)[..., None]).transpose(0, 1)
    return out.to(q.dtype)


def decode_attention_block_split_reference(q, ck, cv, positions, *, scale=None,
                                           k_scale=None, v_scale=None,
                                           split_keys: int = SPLIT_KEYS):
    """The plain version of the kernel's algorithm over the slab, for any
    S (one token: S = 1): :func:`block_splits`' splits, each one's (m, l,
    acc) in f32, merged in split order (CPU tensors)."""
    _check_kv_scales(k_scale, v_scale, ck)
    kk, vv = _dequant(ck, cv, k_scale, v_scale)
    return _split_attend_block(q, kk, vv, positions, scale, split_keys)


def paged_decode_attention_block_split_reference(q, ck, cv, page_tables, positions, *,
                                                 scale=None, k_scale=None, v_scale=None,
                                                 split_keys: int = SPLIT_KEYS):
    """:func:`decode_attention_block_split_reference` over the page-table
    gather of the pools."""
    _check_kv_scales(k_scale, v_scale, ck)
    kk, vv = _paged_views(ck, cv, page_tables, k_scale, v_scale)
    return _split_attend_block(q, kk, vv, positions, scale, split_keys)


# -- the kernels -----------------------------------------------------------


def _lib():
    lib = _build.load(_LIB)
    fn = lib.tdx_decode_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _launch(name, q, ck, cv, positions, page_tables, k_scale, v_scale, scale):
    """Check the operands and launch ``tdx_decode_attention`` on the
    current stream.  Returns the (B, S, Hq, D) output and whether the cache
    was int8."""
    b, s, hq, d = q.shape
    paged = page_tables is not None
    named = [("q", q), ("ck", ck), ("cv", cv), ("positions", positions)]
    if paged:
        named.append(("page_tables", page_tables))
    quant = _check_kv_scales(k_scale, v_scale, ck)
    if quant:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for n, t in named:
        if not t.is_cuda:
            raise ValueError(f"{name}: {n} is not a CUDA tensor")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes a bf16 query, got {q.dtype}")
    want = torch.int8 if quant else torch.bfloat16
    if ck.dtype != want or cv.dtype != want:
        raise TypeError(f"{name} takes a {want} cache here, got {ck.dtype}/{cv.dtype}")
    if quant and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
        raise TypeError(f"{name} takes f32 scales")
    if ck.shape != cv.shape or ck.shape[3] != d:
        raise ValueError(f"cache shapes {tuple(ck.shape)}/{tuple(cv.shape)} do not match q {tuple(q.shape)}")
    if not paged and ck.shape[0] != b:
        raise ValueError(f"slab slots {ck.shape[0]} != batch {b}")
    if paged and page_tables.shape[0] != b:
        raise ValueError(f"page_tables rows {page_tables.shape[0]} != batch {b}")
    for n, t in named[1:3] + (named[-2:] if quant else []):
        if not t.is_contiguous():
            raise ValueError(f"{name} reads {n} in place: it must be contiguous")
    hkv = ck.shape[2]
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    n_rep = hq // hkv
    if s * n_rep > MAX_BLOCK_ROWS:
        raise ValueError(f"{name} takes S * Hq/Hkv <= {MAX_BLOCK_ROWS}, got {s} * {n_rep}")
    if d not in (64, 128):
        raise ValueError(f"{name} takes head_dim 64 or 128, got {d}")
    if paged:
        ps, pp = ck.shape[1], page_tables.shape[1]
        max_len = pp * ps
        tables = page_tables.to(torch.int32).contiguous()
    else:
        ps, pp, max_len = 1, 0, ck.shape[1]
        tables = None
    q = q.contiguous()
    pos = positions.to(torch.int32).contiguous()
    scale_ = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    # the per-split (acc, m, l) of every row, f32: the splits of the
    # deepest slot the cache holds
    nsplit = -(-max_len // SPLIT_KEYS)
    part = torch.empty(b * hkv * nsplit * s * n_rep * (d + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        err = _lib()(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), ptr(k_scale),
            ptr(v_scale), pos.data_ptr(), ptr(tables), out.data_ptr(), part.data_ptr(),
            b, s, max_len, hq, hkv, d, ps, pp, int(paged), int(quant),
            SPLIT_KEYS, nsplit, scale_, stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out, quant


def _count(fn, quant):
    fn.launches += 1
    fn.int8_launches += int(quant)


def decode_attention_cuda(q, ck, cv, positions, *, scale=None, k_scale=None,
                          v_scale=None):
    """Launch the kernel for one token per slot (its key range split over
    blocks, then the splits merged in order): ``q`` (B, 1, Hq, D) bf16,
    slab ``ck``/``cv`` (B, max_len, Hkv, D) bf16, or int8 with f32
    ``k_scale``/``v_scale`` (B, max_len, Hkv, 1), contiguous;
    ``positions`` (B,).  Hq / Hkv <= 64, D in {64, 128}."""
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention takes one token per slot, got S={q.shape[1]}")
    out, quant = _launch("decode_attention", q, ck, cv, positions, None,
                         k_scale, v_scale, scale)
    _count(decode_attention_cuda, quant)
    return out


def decode_attention_block_cuda(q, ck, cv, positions, *, scale=None,
                                k_scale=None, v_scale=None):
    """Launch the kernel for S tokens per slot (the speculative verify):
    ``q`` (B, S, Hq, D) bf16, S * Hq / Hkv <= 64; the slab as for
    :func:`decode_attention_cuda`."""
    out, quant = _launch("decode_attention_block", q, ck, cv, positions, None,
                         k_scale, v_scale, scale)
    _count(decode_attention_block_cuda, quant)
    return out


def paged_decode_attention_cuda(q, ck, cv, page_tables, positions, *,
                                scale=None, k_scale=None, v_scale=None):
    """Launch the kernel for one token per slot over pools ``ck``/``cv``
    (num_pages, page_size, Hkv, D) bf16, or int8 with scales (num_pages,
    page_size, Hkv, 1); ``page_tables`` (B, pages_per_slot) integer."""
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention takes one token per slot, got S={q.shape[1]}")
    out, quant = _launch("paged_decode_attention", q, ck, cv, positions,
                         page_tables, k_scale, v_scale, scale)
    _count(paged_decode_attention_cuda, quant)
    return out


def paged_decode_attention_block_cuda(q, ck, cv, page_tables, positions, *,
                                      scale=None, k_scale=None, v_scale=None):
    """Launch the kernel for S tokens per slot over page pools."""
    out, quant = _launch("paged_decode_attention_block", q, ck, cv, positions,
                         page_tables, k_scale, v_scale, scale)
    _count(paged_decode_attention_block_cuda, quant)
    return out


for _fn in (decode_attention_cuda, decode_attention_block_cuda,
            paged_decode_attention_cuda, paged_decode_attention_block_cuda):
    _fn.launches = 0
    _fn.int8_launches = 0


# -- dispatchers -------------------------------------------------------------


def decode_attention(q, ck, cv, positions, *, scale: Optional[float] = None,
                     k_scale=None, v_scale=None):
    """Slot decode attention (post-write): slot ``b`` attends cache rows
    ``j <= positions[b]``.  Returns (B, 1, Hq, D) in ``q.dtype``.  CUDA
    tensors go through the kernel; CPU tensors through the plain version."""
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention takes one token per slot, got S={q.shape[1]}")
    fn = decode_attention_cuda if q.is_cuda else decode_attention_reference
    return fn(q, ck, cv, positions, scale=scale, k_scale=k_scale, v_scale=v_scale)


def decode_attention_block(q, ck, cv, positions, *,
                           scale: Optional[float] = None, k_scale=None,
                           v_scale=None):
    """Multi-token slot decode attention (post-write), the speculative
    verify block: query ``(b, i)`` attends cache rows ``j <= positions[b] +
    i``.  Returns (B, S, Hq, D)."""
    fn = decode_attention_block_cuda if q.is_cuda else decode_attention_block_reference
    return fn(q, ck, cv, positions, scale=scale, k_scale=k_scale, v_scale=v_scale)


def paged_decode_attention(q, ck, cv, page_tables, positions, *,
                           scale: Optional[float] = None, k_scale=None,
                           v_scale=None):
    """Paged one-token decode attention (post-write): slot ``b``'s logical
    cache is the concatenation of the pool pages ``page_tables[b]`` names."""
    if q.shape[1] != 1:
        raise ValueError(f"paged_decode_attention takes one token per slot, got S={q.shape[1]}")
    fn = paged_decode_attention_cuda if q.is_cuda else paged_decode_attention_reference
    return fn(q, ck, cv, page_tables, positions, scale=scale, k_scale=k_scale,
              v_scale=v_scale)


def paged_decode_attention_block(q, ck, cv, page_tables, positions, *,
                                 scale: Optional[float] = None, k_scale=None,
                                 v_scale=None):
    """Paged multi-token decode attention (the speculative verify over the
    page pools)."""
    fn = (paged_decode_attention_block_cuda if q.is_cuda
          else paged_decode_attention_block_reference)
    return fn(q, ck, cv, page_tables, positions, scale=scale, k_scale=k_scale,
              v_scale=v_scale)
