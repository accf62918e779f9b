"""Flash attention: the hand-written CUDA kernels, their plain PyTorch
versions, the dispatcher between them, and its gradient.

Counterpart of ``torchdistx_tpu/ops/flash_attention.py``.  Five kernels
replace the Pallas ones, in every variant, from two sources:

- ``csrc/flash_fwd.cu`` replaces ``_kernel`` (launched by
  ``_flash_forward``): plain output for the serving engine's prefill,
  with the row log-sum-exp (``emit_lse``) for the training forward, or
  the ``(m, l)`` residuals (``emit_residuals``: the raw f32 accumulator
  and each row's running max and sum) for ring attention's per-hop block,
  which merges the blocks of its hops in f32; causal or not; with no
  bias, an additive (Hq, Sq, Skv) ``bias`` shared across the batch, or
  T5's in-kernel bucket bias from an (Hq, buckets) ``rel_bias_table``;
  or with Mistral's sliding ``window`` (causal, no bias: query i sees
  keys (i + diag - window, i + diag]), whose pruned tiles make the work
  grow with S * window;
- ``csrc/flash_bwd.cu`` replaces ``_bwd_dkv_kernel`` (dK, dV) and
  ``_bwd_dq_kernel`` (dQ), launched by ``_flash_backward_core``, in the
  same variants, writing bf16 gradients or, for the ring's per-hop
  partials, f32 ones (the JAX ``dq_dtype`` / ``part_dtype``), and
  ``_bwd_dbias_kernel`` (launched by ``_flash_dbias``) and
  ``_bwd_dtable_kernel`` (launched by ``_flash_dtable``), the gradients of
  the additive bias and of the bucket table (one kernel, two epilogues);
  all four read ``delta = rowsum(dO * O)`` from a pre-pass that writes it
  once per row (``flash_bwd_delta_cuda``; the TPU kernels compute it in
  their bodies), which one backward runs once for all.

The sources say what bounds each on an H100 and what their designs do
about it.  All are Hopper designs (TMA, ``wgmma``, accumulators in
registers; ``csrc/hopper.cuh``) that read q, k, v, o and dO in place.

``flash_attention`` keeps the JAX layout, (B, S, H, D).  When autograd
needs it (grad mode on and an input that requires a gradient) it runs
through ``_FlashAttention``, a ``torch.autograd.Function`` whose forward
saves ``(q, k, v, o, lse)`` and whose backward launches the backward
kernels, as the JAX ``custom_vjp`` does.  Otherwise the serving call is
unchanged.  A CUDA tensor launches the kernels or raises; the plain
versions (``flash_attention_reference``, ``flash_attention_lse_reference``,
``flash_attention_residuals_reference``, ``flash_bwd_reference``,
``flash_bias_grad_reference``) run only for tensors on the CPU.

Bucket ids.  T5's bucket of a distance takes an f32 ``log``; one ulp of
difference flips a bucket at its edge.  So the ids are never recomputed
on the card: ``rel_bucket_ids`` evaluates ``rel_pos_bucket`` once per
(Sq, Skv, buckets, max_dist, bidirectional) on the CPU (where a test pins
it equal to JAX's), caches the int32 ids of every distance on the device,
and the kernels, the plain versions and T5's materialized bias all read
those.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build
from .attention import _NEG_INF, _causal_mask, _repeat_kv, multihead_attention

__all__ = [
    "resolve_use_flash",
    "rel_pos_bucket",
    "rel_bucket_ids",
    "rel_bucket_matrix",
    "flash_attention",
    "flash_attention_reference",
    "flash_attention_lse_reference",
    "flash_attention_residuals_reference",
    "flash_attention_residuals",
    "flash_bwd_reference",
    "flash_bwd_delta_reference",
    "flash_bwd_delta",
    "flash_bias_grad_reference",
    "flash_fwd_cuda",
    "flash_bwd_delta_cuda",
    "flash_bwd_dkv_cuda",
    "flash_bwd_dq_cuda",
    "flash_bwd_dbias_cuda",
    "flash_bwd_dtable_cuda",
]

# dtable's fold and its reduction run one thread a bucket in one block
MAX_BUCKETS = 256


def resolve_use_flash(setting: Optional[bool], device) -> bool:
    """``None`` means auto: the kernels on CUDA tensors, the plain path on
    the CPU (the JAX package's auto is "on for TPU")."""
    if setting is not None:
        return bool(setting)
    return torch.device(device).type == "cuda"


def rel_pos_bucket(rel_pos, *, bidirectional: bool, buckets: int, max_dist: int):
    """T5's relative-position bucketing (log-spaced beyond buckets/2) of an
    integer tensor, the JAX function's arithmetic: every float step in f32,
    ``log(max_dist / max_exact)`` included (JAX takes it of a weakly typed
    Python float, so in f32), truncation toward zero."""
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        buckets = buckets // 2
        ret = torch.where(n < 0, buckets, 0).to(rel_pos.dtype)
        n = n.abs()
    else:
        n = n.clamp_min(0)
    max_exact = buckets // 2
    is_small = n < max_exact
    denom = torch.log(torch.tensor(max_dist / max_exact, dtype=torch.float32))
    log_big = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / denom * (buckets - max_exact)
    ).to(torch.int32)
    log_big = log_big.clamp_max(buckets - 1)
    return ret + torch.where(is_small, n, log_big.to(n.dtype))


@functools.lru_cache(maxsize=64)
def _bucket_ids_cached(sq, skv, bidirectional, buckets, max_dist, device):
    rel = torch.arange(-(sq - 1), skv, dtype=torch.int32)
    ids = rel_pos_bucket(rel, bidirectional=bidirectional, buckets=buckets,
                         max_dist=max_dist)
    return ids.to(torch.int32).to(device)


def rel_bucket_ids(sq: int, skv: int, *, bidirectional: bool, buckets: int,
                   max_dist: int, device="cpu"):
    """int32 (Sq + Skv - 1,) bucket ids of every distance ``col - row``,
    at index ``col - row + Sq - 1``; computed on the CPU, cached on
    ``device``."""
    return _bucket_ids_cached(int(sq), int(skv), bool(bidirectional),
                              int(buckets), int(max_dist), torch.device(device))


def rel_bucket_matrix(sq: int, skv: int, bucket_cfg, device="cpu"):
    """(Sq, Skv) int64 bucket id of each (row, col), start-aligned, from
    ``rel_bucket_ids``; ``bucket_cfg = (buckets, max_dist,
    bidirectional)``."""
    buckets, max_dist, bidirectional = bucket_cfg
    ids = rel_bucket_ids(sq, skv, bidirectional=bidirectional, buckets=buckets,
                         max_dist=max_dist, device=device)
    rel = (torch.arange(skv, device=device)[None, :]
           - torch.arange(sq, device=device)[:, None] + (sq - 1))
    return ids.long()[rel]


def _scale(scale, d):
    return scale if scale is not None else 1.0 / math.sqrt(d)


def _dense_bias(q, k, bias, table, bucket_cfg):
    """The (Hq, Sq, Skv) bias: ``bias`` itself, or the one a bucket table
    stands for."""
    if table is not None:
        return table[:, rel_bucket_matrix(q.shape[1], k.shape[1], bucket_cfg, table.device)]
    return bias


def _f32_logits(q, k, causal, scale, bias=None, window=None):
    """(B, Hq, Sq, Skv) f32 scaled logits from f32 copies of the inputs,
    plus the f32 bias, masked with -inf outside the end-aligned causal
    mask (and the window's band), and the mask."""
    sq, skv, hq, hkv = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    kk = _repeat_kv(k.float(), hq // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * _scale(scale, q.shape[-1])
    if bias is not None:
        logits = logits + bias.float()[None]
    mask = _causal_mask(sq, skv, causal, window, q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return logits, mask


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              scale: Optional[float] = None, bias=None,
                              table=None, bucket_cfg=None, window=None):
    """The plain version: ``multihead_attention``'s math (``_repeat_kv``,
    logits of the input-dtype product widened to f32, f32 softmax,
    probabilities cast to ``q.dtype`` before P.V), the bias (or the
    table's) added to the f32 logits as the JAX jnp path adds it, the
    ``window``'s band masked as ``multihead_attention`` masks it."""
    bias = _dense_bias(q, k, bias, table, bucket_cfg)
    if bias is None:
        return multihead_attention(q, k, v, causal=causal, scale=scale, window=window)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kk, vv = _repeat_kv(k, hq // hkv), _repeat_kv(v, hq // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * _scale(scale, d)
    logits = logits + bias.float()[None]
    mask = _causal_mask(sq, skv, causal, None, q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vv)


def flash_attention_lse_reference(q, k, v, *, causal: bool = True,
                                  scale: Optional[float] = None, bias=None,
                                  table=None, bucket_cfg=None, window=None):
    """The plain version of the ``emit_lse`` forward: the output of
    ``flash_attention_reference`` and the f32 row log-sum-exp of the scaled
    (and biased) logits over the visible keys, (B, Hq, Sq)."""
    bias = _dense_bias(q, k, bias, table, bucket_cfg)
    out = flash_attention_reference(q, k, v, causal=causal, scale=scale, bias=bias,
                                    window=window)
    logits, _ = _f32_logits(q, k, causal, scale, bias, window)
    return out, torch.logsumexp(logits, dim=-1)


def flash_attention_residuals_reference(q, k, v, *, causal: bool = True,
                                        scale: Optional[float] = None, bias=None):
    """The plain version of the ``emit_residuals`` forward, in f32: the raw
    accumulator ``sum_j exp(s_ij - m_i) v_j`` (B, Sq, Hq, D), the row max
    ``m`` and the row sum ``l = sum_j exp(s_ij - m_i)`` (B, Hq, Sq) of the
    scaled (and biased) logits, masked pairs at the kernels' finite -1e30
    as the TPU kernel masks them."""
    logits, mask = _f32_logits(q, k, causal, scale, bias)
    if mask is not None:
        logits = logits.masked_fill(~mask, _NEG_INF)
    m = logits.amax(-1)
    p = torch.exp(logits - m[..., None])
    acc = torch.einsum("bhqk,bkhd->bqhd", p,
                       _repeat_kv(v.float(), q.shape[2] // k.shape[2]))
    return acc, m, p.sum(-1)


def _bwd_probs(q, k, v, o, lse, do, causal, scale, dense, window=None, delta=None):
    """The backward's f32 recompute from the saved ``o`` and ``lse``: the
    probabilities ``p`` (0 where masked) and the logit gradient
    ``p * (dp - delta)``, both (B, Hq, Sq, Skv); ``delta`` (B, Hq, Sq)
    computed from ``o`` and ``do`` unless given."""
    logits, mask = _f32_logits(q, k, causal, scale, dense, window)
    p = torch.exp(logits - lse.float()[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    vv = _repeat_kv(v.float(), q.shape[2] // k.shape[2])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vv)
    if delta is None:
        delta = flash_bwd_delta_reference(o, do)
    return p, p * (dp - delta.float()[..., None])


def flash_bwd_delta_reference(o, do):
    """The plain version of the delta pre-pass: ``rowsum(dO * O)`` in f32,
    (B, Hq, S) from (B, S, Hq, D) ``o`` and ``do``."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2)


def _bias_grad(dlogits, bias, table, bucket_cfg):
    """dbias = the batch sum of the logit gradient (the bias enters the
    logits unscaled) in the bias's dtype, or dtable = that sum added up
    per bucket id in the table's."""
    if bias is not None:
        return dlogits.sum(0).to(bias.dtype)
    sq, skv = dlogits.shape[2], dlogits.shape[3]
    ids = rel_bucket_matrix(sq, skv, bucket_cfg, dlogits.device).flatten()
    dt = torch.zeros(table.shape, dtype=torch.float32, device=dlogits.device)
    dt.index_add_(1, ids, dlogits.sum(0).flatten(1))
    return dt.to(table.dtype)


def flash_bwd_reference(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None, bias=None, table=None,
                        bucket_cfg=None, window=None, dq_dtype=None,
                        part_dtype=None, delta=None):
    """The plain backward, in f32 from the saved ``o`` and ``lse``: the
    FA2 formulas of the JAX ``_bwd_recompute``, masked by the causal mask
    and the ``window``'s band.  GQA partials are summed over each group.
    ``delta`` is the pre-pass's ``rowsum(dO * O)``, computed here unless
    given.  Returns (dq, dk, dv) in the inputs' dtypes, or ``dq_dtype`` and
    ``part_dtype`` (dk, dv) when given, and with a ``bias`` or ``table``
    also its gradient (``flash_bias_grad_reference``)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    dense = _dense_bias(q, k, bias, table, bucket_cfg)
    p, dlogits = _bwd_probs(q, k, v, o, lse, do, causal, scale, dense, window, delta)
    ds = dlogits * _scale(scale, d)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _repeat_kv(k.float(), n_rep))
    skv = k.shape[1]
    dk = dk.reshape(b, skv, hkv, n_rep, d).sum(3)
    dv = dv.reshape(b, skv, hkv, n_rep, d).sum(3)
    grads = (dq.to(dq_dtype or q.dtype), dk.to(part_dtype or k.dtype),
             dv.to(part_dtype or v.dtype))
    if bias is None and table is None:
        return grads
    return grads + (_bias_grad(dlogits, bias, table, bucket_cfg),)


def flash_bias_grad_reference(q, k, v, o, lse, do, *, causal: bool = True,
                              scale: Optional[float] = None, bias=None,
                              table=None, bucket_cfg=None):
    """The plain version of the dbias and dtable kernels alone: with a
    ``bias``, the batch sum of ``p * (dp - delta)`` in the bias's dtype;
    with a ``table``, that sum added up per bucket id, in the table's."""
    if (bias is None) == (table is None):
        raise ValueError("flash_bias_grad_reference takes one of bias and table")
    dense = _dense_bias(q, k, bias, table, bucket_cfg)
    _, dlogits = _bwd_probs(q, k, v, o, lse, do, causal, scale, dense)
    return _bias_grad(dlogits, bias, table, bucket_cfg)


# -- the kernels ---------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn(lib: str, name: str, argtypes):
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


# the bias arguments every kernel takes after its tensors: bias, table,
# bucket ids (each null when unused), buckets
_BIAS_ARGS = [_P, _P, _P, _I]


def _check(fn_name, tensors, d):
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{fn_name}: {name} is not a CUDA tensor")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{fn_name} takes bf16, got {name}.dtype={t.dtype}")
    if d not in (64, 128):
        raise ValueError(f"{fn_name} takes head_dim 64 or 128, got {d}")


def _tma_strides(fn_name, name, t):
    """The (batch, seq, head) element strides of a (B, S, H, D) bf16
    tensor that the TMA kernels read in place: D contiguous, a 16-byte
    aligned base and the other strides multiples of 16 bytes, else a
    ValueError (no copy is made).  The stride of a dimension of size 1 is
    never used; it is reported as the packed one."""
    st = t.stride()
    if st[3] != 1 or t.data_ptr() % 16 or any((x * t.element_size()) % 16 for x in st[:3]):
        raise ValueError(
            f"{fn_name}: {name} must have a contiguous last dimension, a 16-byte "
            f"aligned base and strides that are multiples of 16 bytes for TMA "
            f"(strides {tuple(st)}, base {t.data_ptr():#x})")
    b, s, h, d = t.shape
    sh = st[2] if h > 1 else d
    ss = st[1] if s > 1 else h * sh
    return (st[0] if b > 1 else s * ss), ss, sh


def _stride_args(fn_name, tensors):
    """The C array of the TMA strides of ``tensors`` ((name, tensor)s)."""
    vals = [x for name, t in tensors for x in _tma_strides(fn_name, name, t)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _bias_args(fn_name, q, k, bias, table, bucket_cfg):
    """Checked kernel arguments (bias, table, ids, buckets) and the
    tensors they point into (kept alive until the launch returns)."""
    if table is not None and bucket_cfg is None:
        raise ValueError(f"{fn_name}: a bucket table needs its bucket_cfg")
    _check_shapes(q, k, False, bias, table, bucket_cfg)
    if bias is not None:
        _check(fn_name, (("bias", bias),), q.shape[-1])
        bias = bias.contiguous()
        return (bias.data_ptr(), None, None, 0), (bias,)
    if table is not None:
        _check(fn_name, (("table", table),), q.shape[-1])
        buckets, max_dist, bidirectional = bucket_cfg
        if buckets > MAX_BUCKETS:
            raise ValueError(f"{fn_name} takes at most {MAX_BUCKETS} buckets, got {buckets}")
        table = table.contiguous()
        ids = rel_bucket_ids(q.shape[1], k.shape[1], bidirectional=bidirectional,
                             buckets=buckets, max_dist=max_dist, device=q.device)
        return (None, table.data_ptr(), ids.data_ptr(), buckets), (table, ids)
    return (None, None, None, 0), ()


def _count(fn, bias, table, window):
    if bias is not None:
        fn.bias_launches += 1
    elif table is not None:
        fn.bucket_launches += 1
    elif window is not None:
        fn.window_launches += 1


def _check_window(causal, window, bias, table):
    """The JAX ``flash_attention`` window checks."""
    if window is None:
        return
    if not causal:
        raise ValueError("window requires causal=True")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if bias is not None or table is not None:
        raise ValueError("window is mutually exclusive with bias/rel_bias_table")


def _check_residuals(window, table):
    """The ring takes the residuals with no bias or an additive one: the JAX
    package refuses ``sp_axis`` with a window or the bucket table."""
    if window is not None or table is not None:
        raise ValueError("the (m, l) residuals take no window and no bucket table")


def flash_fwd_cuda(q, k, v, *, causal: bool = True,
                   scale: Optional[float] = None, return_lse: bool = False,
                   return_residuals: bool = False, bias=None, table=None,
                   bucket_cfg=None, window=None):
    """Launch the forward kernel on CUDA tensors (bf16, D in {64, 128},
    (B, S, H, D)).  With ``return_lse`` it also writes the f32 row
    log-sum-exp (B, Hq, Sq) and returns ``(out, lse)``; with
    ``return_residuals`` it returns ``(acc, m, l)`` instead: the raw f32
    accumulator (B, Sq, Hq, D) and each row's f32 max and sum (B, Hq, Sq),
    no bias or ``bias`` only.  ``bias``: bf16 (Hq, Sq, Skv); ``table``:
    bf16 (Hq, buckets) with ``bucket_cfg = (buckets, max_dist,
    bidirectional)``, Sq == Skv; ``window``: the sliding window (causal, no
    bias).  q, k and v are read in place (strides TMA takes, else a
    ValueError); the outputs are contiguous.  Adds one to
    ``flash_fwd_cuda.launches`` (plain output),
    ``.lse_launches`` or ``.residual_launches``, and to ``.bias_launches``,
    ``.bucket_launches`` or ``.window_launches`` for those variants."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if return_residuals:
        if return_lse:
            raise ValueError("return_lse and return_residuals are exclusive")
        _check_residuals(window, table)
    _check("flash_fwd_cuda", (("q", q), ("k", k), ("v", v)), d)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if causal and sq > skv:
        raise ValueError(f"causal attention requires Sq ({sq}) <= Skv ({skv})")
    _check_window(causal, window, bias, table)
    bargs, keep = _bias_args("flash_fwd_cuda", q, k, bias, table, bucket_cfg)
    strides = _stride_args("flash_fwd_cuda", (("q", q), ("k", k), ("v", v)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if return_residuals:
        acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m, l = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
                for _ in range(2))
        fn = _fn("flash_fwd", "tdx_flash_fwd_residuals_bf16",
                 [_P] * 7 + [_I] * 6 + [_F, _I, _P, _P])
        with torch.cuda.device(q.device):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
                     m.data_ptr(), l.data_ptr(), bargs[0], b, sq, skv, hq, hkv, d,
                     _scale(scale, d), int(causal), strides, stream)
        outs = (acc, m, l)
    else:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
               if return_lse else None)
        fn = _fn("flash_fwd", "tdx_flash_fwd_bf16",
                 [_P] * 5 + _BIAS_ARGS + [_I] * 6 + [_F, _I, _I, _P, _P])
        with torch.cuda.device(q.device):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     lse.data_ptr() if return_lse else None, *bargs,
                     b, sq, skv, hq, hkv, d, _scale(scale, d), int(causal),
                     int(window or 0), strides, stream)
        outs = (out, lse) if return_lse else out
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    _count(flash_fwd_cuda, bias, table, window)
    if return_residuals:
        flash_fwd_cuda.residual_launches += 1
    elif return_lse:
        flash_fwd_cuda.lse_launches += 1
    else:
        flash_fwd_cuda.launches += 1
    return outs


flash_fwd_cuda.launches = 0
flash_fwd_cuda.lse_launches = 0
flash_fwd_cuda.residual_launches = 0
flash_fwd_cuda.bias_launches = 0
flash_fwd_cuda.bucket_launches = 0
flash_fwd_cuda.window_launches = 0


def _check_bwd(fn_name, q, k, v, o, lse, do):
    b, sq, hq, d = q.shape
    _check(fn_name, (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)), d)
    if k.shape != v.shape or k.shape[:2] != (b, sq) or k.shape[3] != d:
        raise ValueError(f"{fn_name} takes Sq == Skv; k/v {tuple(k.shape)}, q {tuple(q.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{fn_name}: o/do shapes must equal q's {tuple(q.shape)}")
    if hq % k.shape[2] != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {k.shape[2]}")
    if not lse.is_cuda or lse.dtype != torch.float32 or lse.shape != (b, hq, sq):
        raise ValueError(f"{fn_name}: lse must be f32 CUDA (B, Hq, Sq)")


def _launch_tma_bwd(symbol, fn_name, q, k, v, o, lse, do, delta, outs, causal, scale, bias,
                    table, bucket_cfg, window):
    """Check and launch the Hopper backward kernel ``symbol`` (dK/dV, dQ,
    dbias or dtable): q, k, v and do read in place, lse, ``delta`` (the pre-pass's, run
    here when None), ``outs``' pointers, the bias arguments, then (B, S,
    Hq, Hkv, D, causal, window, scale) and the TMA strides."""
    _check_bwd(fn_name, q, k, v, o, lse, do)
    lse = lse.contiguous()
    _check_window(causal, window, bias, table)
    bargs, keep = _bias_args(fn_name, q, k, bias, table, bucket_cfg)
    strides = _stride_args(fn_name, (("q", q), ("k", k), ("v", v), ("do", do)))
    b, s, hq, d = q.shape
    if delta is None:
        delta = flash_bwd_delta_cuda(o, do)
    elif not delta.is_cuda or delta.dtype != torch.float32 or delta.shape != (b, hq, s):
        raise ValueError(f"{fn_name}: delta must be f32 CUDA (B, Hq, S)")
    delta = delta.contiguous()
    fn = _fn("flash_bwd", symbol, [_P] * (6 + len(outs)) + _BIAS_ARGS + [_I] * 7 + [_F, _P, _P])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 delta.data_ptr(), *(t.data_ptr() for t in outs), *bargs, b, s, hq,
                 k.shape[2], d, int(causal), int(window or 0), _scale(scale, d), strides,
                 stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")


def _out_dtype(fn_name, dtype):
    """The output variant: None or bf16 the bf16 kernels, f32 the f32 ones."""
    if dtype in (None, torch.bfloat16):
        return torch.bfloat16, "bf16"
    if dtype == torch.float32:
        return torch.float32, "f32"
    raise TypeError(f"{fn_name} writes bf16 or float32, not {dtype}")


def flash_bwd_delta_cuda(o, do):
    """Launch the delta pre-pass of the dK/dV and dQ kernels:
    ``rowsum(dO * O)``, (B, Hq, S) f32, once per row (the TPU kernels
    recompute it in every tile).  ``o`` and ``do`` bf16 (B, S, Hq, D) with
    strides TMA takes.  Adds one to ``flash_bwd_delta_cuda.launches``."""
    name = "flash_bwd_delta_cuda"
    _check(name, (("o", o), ("do", do)), o.shape[-1])
    if do.shape != o.shape:
        raise ValueError(f"{name}: do shape {tuple(do.shape)} != o shape {tuple(o.shape)}")
    b, s, h, d = o.shape
    strides = _stride_args(name, (("o", o), ("do", do)))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=o.device)
    fn = _fn("flash_bwd", "tdx_flash_bwd_delta", [_P] * 3 + [_I] * 4 + [_P, _P])
    with torch.cuda.device(o.device):
        err = fn(o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, s, h, d, strides,
                 torch.cuda.current_stream(o.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    flash_bwd_delta_cuda.launches += 1
    return delta


flash_bwd_delta_cuda.launches = 0


def flash_bwd_delta(o, do):
    """``rowsum(dO * O)``, (B, Hq, S) f32: the pre-pass kernel on CUDA
    tensors, the plain version on the CPU."""
    return flash_bwd_delta_cuda(o, do) if o.is_cuda else flash_bwd_delta_reference(o, do)


def flash_bwd_dkv_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                       scale: Optional[float] = None, bias=None, table=None,
                       bucket_cfg=None, window=None, part_dtype=None, delta=None):
    """Launch the K/V-stationary backward kernel: (dk, dv), GQA groups
    summed in the kernel, in bf16 or with ``part_dtype=torch.float32`` in
    f32 (the ring's per-hop partials).  ``delta``: the pre-pass's (B, Hq,
    S) f32 ``rowsum(dO * O)``; without it the pre-pass runs first.  q, k,
    v, o and do are read in place (strides TMA takes, else a ValueError).
    Bias and window arguments as ``flash_fwd_cuda``'s.  Adds one to
    ``flash_bwd_dkv_cuda.launches`` (and ``.f32_launches``,
    ``.bias_launches``, ``.bucket_launches`` or ``.window_launches``)."""
    name = "flash_bwd_dkv_cuda"
    dt, tag = _out_dtype(name, part_dtype)
    dk = torch.empty(k.shape, dtype=dt, device=k.device)
    dv = torch.empty(v.shape, dtype=dt, device=v.device)
    _launch_tma_bwd(f"tdx_flash_bwd_dkv_{tag}", name, q, k, v, o, lse, do, delta, (dk, dv),
                    causal, scale, bias, table, bucket_cfg, window)
    flash_bwd_dkv_cuda.launches += 1
    flash_bwd_dkv_cuda.f32_launches += tag == "f32"
    _count(flash_bwd_dkv_cuda, bias, table, window)
    return dk, dv


def flash_bwd_dq_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                      scale: Optional[float] = None, bias=None, table=None,
                      bucket_cfg=None, window=None, dq_dtype=None, delta=None):
    """Launch the Q-stationary backward kernel: dq, in bf16 or with
    ``dq_dtype=torch.float32`` in f32.  ``delta`` and the in-place inputs
    as ``flash_bwd_dkv_cuda``'s (``o`` is read only by the pre-pass).  Adds
    one to ``flash_bwd_dq_cuda.launches`` (and ``.f32_launches``,
    ``.bias_launches``, ``.bucket_launches`` or ``.window_launches``)."""
    name = "flash_bwd_dq_cuda"
    dt, tag = _out_dtype(name, dq_dtype)
    dq = torch.empty(q.shape, dtype=dt, device=q.device)
    _launch_tma_bwd(f"tdx_flash_bwd_dq_{tag}", name, q, k, v, o, lse, do, delta, (dq,),
                    causal, scale, bias, table, bucket_cfg, window)
    flash_bwd_dq_cuda.launches += 1
    flash_bwd_dq_cuda.f32_launches += tag == "f32"
    _count(flash_bwd_dq_cuda, bias, table, window)
    return dq


for _f in (flash_bwd_dkv_cuda, flash_bwd_dq_cuda):
    _f.launches = _f.bias_launches = _f.bucket_launches = _f.window_launches = 0
    _f.f32_launches = 0


def flash_bwd_dbias_cuda(q, k, v, o, lse, do, bias, *, causal: bool = True,
                         scale: Optional[float] = None, delta=None):
    """Launch the dbias kernel: the (Hq, Sq, Skv) batch sum of
    ``p * (dp - delta)`` in bf16, reduced over the batch inside each block
    (deterministic, no atomics).  ``delta`` and the in-place inputs as
    ``flash_bwd_dkv_cuda``'s: without ``delta`` the pre-pass runs first.
    Adds one to ``flash_bwd_dbias_cuda.launches``."""
    if bias is None:
        raise ValueError("flash_bwd_dbias_cuda needs the bias")
    dbias = torch.empty(bias.shape, dtype=torch.bfloat16, device=q.device)
    _launch_tma_bwd("tdx_flash_bwd_dbias_bf16", "flash_bwd_dbias_cuda", q, k, v, o, lse, do,
                    delta, (dbias,), causal, scale, bias, None, None, None)
    flash_bwd_dbias_cuda.launches += 1
    return dbias


def flash_bwd_dtable_cuda(q, k, v, o, lse, do, table, bucket_cfg, *,
                          causal: bool = True, scale: Optional[float] = None, delta=None):
    """Launch the dtable kernel: ``p * (dp - delta)`` summed over the batch
    and per bucket id, (Hq, buckets) in bf16.  Per (128 x 64, head) tile
    into an (Hq, tiles, buckets) f32 scratch, then summed in tile order by a
    second kernel: no atomics, the same bits on every launch.  ``delta``
    and the in-place inputs as ``flash_bwd_dkv_cuda``'s: without ``delta``
    the pre-pass runs first.  Adds one to ``flash_bwd_dtable_cuda.launches``
    per call."""
    name = "flash_bwd_dtable_cuda"
    if table is None:
        raise ValueError(f"{name} needs the table")
    _check_bwd(name, q, k, v, o, lse, do)
    hq, buckets = table.shape
    tiles = _fn("flash_bwd", "tdx_flash_bwd_dtable_tiles", [_I])(q.shape[1])
    part = torch.empty((hq, tiles, buckets), dtype=torch.float32, device=q.device)
    dtable = torch.empty(table.shape, dtype=torch.bfloat16, device=q.device)
    _launch_tma_bwd("tdx_flash_bwd_dtable_bf16", name, q, k, v, o, lse, do, delta,
                    (part, dtable), causal, scale, None, table, bucket_cfg, None)
    flash_bwd_dtable_cuda.launches += 1
    return dtable


flash_bwd_dbias_cuda.launches = 0
flash_bwd_dtable_cuda.launches = 0


# -- dispatch and gradient -------------------------------------------------------


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None, bias=None, table=None,
                        bucket_cfg=None, window=None):
    """(out, lse): the kernel on CUDA tensors, the plain version on the CPU."""
    kw = dict(causal=causal, scale=scale, bias=bias, table=table, bucket_cfg=bucket_cfg,
              window=window)
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, return_lse=True, **kw)
    return flash_attention_lse_reference(q, k, v, **kw)


def flash_attention_residuals(q, k, v, *, causal: bool = True,
                              scale: Optional[float] = None, bias=None):
    """(acc, m, l), the ``(m, l)`` residuals forward: the kernel on CUDA
    tensors, the plain version on the CPU.  Not differentiable: ring
    attention's backward is a ring of its own."""
    _check_shapes(q, k, causal, bias, None, None)
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, causal=causal, scale=scale, bias=bias,
                              return_residuals=True)
    return flash_attention_residuals_reference(q, k, v, causal=causal, scale=scale,
                                               bias=bias)


def flash_backward(q, k, v, o, lse, do, *, causal: bool = True,
                   scale: Optional[float] = None, bias=None, table=None,
                   bucket_cfg=None, bias_grad: bool = True, window=None,
                   dq_dtype=None, part_dtype=None, delta=None):
    """(dq, dk, dv), in the inputs' dtypes or ``dq_dtype`` / ``part_dtype``,
    and with a bias or table its gradient (None when ``bias_grad`` is off):
    the kernels on CUDA tensors, the plain version on the CPU.  ``delta``
    (``flash_bwd_delta(o, do)``) is computed once here unless given, and
    the dK/dV, dQ and dbias or dtable kernels read it."""
    kw = dict(causal=causal, scale=scale)
    bkw = dict(bias=bias, table=table, bucket_cfg=bucket_cfg)
    has_bias = bias is not None or table is not None
    if not q.is_cuda:
        grads = flash_bwd_reference(q, k, v, o, lse, do, **kw, **bkw, window=window,
                                    dq_dtype=dq_dtype, part_dtype=part_dtype, delta=delta)
        if has_bias and not bias_grad:
            grads = grads[:3] + (None,)
        return grads
    if delta is None:
        delta = flash_bwd_delta_cuda(o, do)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, o, lse, do, **kw, **bkw, window=window,
                                part_dtype=part_dtype, delta=delta)
    dq = flash_bwd_dq_cuda(q, k, v, o, lse, do, **kw, **bkw, window=window,
                           dq_dtype=dq_dtype, delta=delta)
    if not has_bias:
        return dq, dk, dv
    if not bias_grad:
        return dq, dk, dv, None
    if bias is not None:
        return dq, dk, dv, flash_bwd_dbias_cuda(q, k, v, o, lse, do, bias, **kw, delta=delta)
    return dq, dk, dv, flash_bwd_dtable_cuda(q, k, v, o, lse, do, table, bucket_cfg, **kw,
                                             delta=delta)


class _FlashAttention(torch.autograd.Function):
    """The JAX ``custom_vjp``: forward with ``lse`` saved, backward by the
    FA2 kernels (no recompute of the forward), and with a bias or table a
    further kernel for its gradient, as ``_flash_bwd_rule``."""

    @staticmethod
    def forward(ctx, q, k, v, bias, table, causal, scale, bucket_cfg, window):
        out, lse = flash_attention_lse(q, k, v, causal=causal, scale=scale,
                                       bias=bias, table=table, bucket_cfg=bucket_cfg,
                                       window=window)
        ctx.save_for_backward(q, k, v, out, lse, bias, table)
        ctx.causal, ctx.scale, ctx.bucket_cfg = causal, scale, bucket_cfg
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, bias, table = ctx.saved_tensors
        bias_grad = ctx.needs_input_grad[3] or ctx.needs_input_grad[4]
        grads = flash_backward(q, k, v, out, lse, do.contiguous(), causal=ctx.causal,
                               scale=ctx.scale, bias=bias, table=table,
                               bucket_cfg=ctx.bucket_cfg, bias_grad=bias_grad,
                               window=ctx.window)
        dbias = grads[3] if bias is not None else None
        dtable = grads[3] if table is not None else None
        return grads[0], grads[1], grads[2], dbias, dtable, None, None, None, None


def flash_attention(q, k, v, *, bias=None, causal: bool = True,
                    scale: Optional[float] = None, rel_bias_table=None,
                    rel_bias_buckets: int = 32, rel_bias_max_dist: int = 128,
                    rel_bias_bidirectional: bool = False,
                    window: Optional[int] = None):
    """(B, Sq, Hq, D) x (B, Skv, Hkv, D)^2 -> (B, Sq, Hq, D), end-aligned
    causal mask.  CUDA tensors go through the kernels; CPU tensors through
    the plain versions.  Differentiable, in the bias and table too.

    ``bias``: additive logit bias (Hq, Sq, Skv) shared across the batch
    (T5's relative-position bias).  ``rel_bias_table``: the (Hq, buckets)
    bucket table instead, each (row, col) biased by
    ``table[h, rel_pos_bucket(col - row)]`` without an (Hq, S, S) bias in
    memory; requires Sq == Skv.  ``window``: the sliding window of Mistral
    and Mixtral, query ``i`` sees keys ``(i + diag - window, i + diag]``
    (``diag = Skv - Sq``); requires ``causal=True`` and no bias, and the
    kernels skip the tiles outside the band, so the work grows with
    ``S * window``."""
    _check_window(causal, window, bias, rel_bias_table)
    bucket_cfg = None
    if rel_bias_table is not None:
        bucket_cfg = (int(rel_bias_buckets), int(rel_bias_max_dist),
                      bool(rel_bias_bidirectional))
    _check_shapes(q, k, causal, bias, rel_bias_table, bucket_cfg)
    needs = (q, k, v, bias, rel_bias_table)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in needs):
        return _FlashAttention.apply(q, k, v, bias, rel_bias_table, causal, scale,
                                     bucket_cfg, window)
    kw = dict(causal=causal, scale=scale, bias=bias, table=rel_bias_table,
              bucket_cfg=bucket_cfg, window=window)
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, **kw)
    return flash_attention_reference(q, k, v, **kw)


def _check_shapes(q, k, causal, bias, table, bucket_cfg):
    """The JAX ``flash_attention`` / ``_flash_forward`` argument checks, on
    either device."""
    _, sq, hq, _ = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if bias is not None and table is not None:
        raise ValueError("pass bias OR rel_bias_table, not both")
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if causal and sq > skv:
        raise ValueError(f"causal attention requires Sq ({sq}) <= Skv ({skv})")
    if table is not None:
        if sq != skv:
            raise ValueError(f"in-kernel bucket bias requires Sq == Skv (got {sq} vs {skv})")
        if tuple(table.shape) != (hq, bucket_cfg[0]):
            raise ValueError(f"bucket-bias table shape {tuple(table.shape)} != "
                             f"(Hq, buckets) = {(hq, bucket_cfg[0])}")
    elif bias is not None and tuple(bias.shape) != (hq, sq, skv):
        raise ValueError(f"bias shape {tuple(bias.shape)} != (Hq, Sq, Skv) = {(hq, sq, skv)}")
