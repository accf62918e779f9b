"""Flash attention: the hand-written CUDA kernels, their plain PyTorch
versions, the dispatcher between them, and its gradient.

Counterpart of ``torchdistx_tpu/ops/flash_attention.py``.  Three kernels
replace the Pallas ones in their causal, no-bias, no-window variants:

- ``csrc/flash_fwd.cu`` replaces ``_kernel`` (launched by
  ``_flash_forward``): plain output for the serving engine's prefill, or
  with the row log-sum-exp (``emit_lse``) for the training forward;
- ``csrc/flash_bwd.cu`` replaces ``_bwd_dkv_kernel`` (dK, dV) and
  ``_bwd_dq_kernel`` (dQ), launched by ``_flash_backward_core``.

All three are bounded by operations on an H100; the sources say what
their designs do about that.

``flash_attention`` keeps the JAX layout, (B, S, H, D).  When autograd
needs it (grad mode on and an input that requires a gradient) it runs
through ``_FlashAttention``, a ``torch.autograd.Function`` whose forward
saves ``(q, k, v, o, lse)`` and whose backward launches the two backward
kernels, as the JAX ``custom_vjp`` does.  Otherwise the serving call is
unchanged.  A CUDA tensor launches the kernels or raises; the plain
versions (``flash_attention_reference``, ``flash_attention_lse_reference``,
``flash_bwd_reference``) run only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .attention import _repeat_kv, multihead_attention

__all__ = [
    "resolve_use_flash",
    "flash_attention",
    "flash_attention_reference",
    "flash_attention_lse_reference",
    "flash_bwd_reference",
    "flash_fwd_cuda",
    "flash_bwd_dkv_cuda",
    "flash_bwd_dq_cuda",
]


def resolve_use_flash(setting: Optional[bool], device) -> bool:
    """``None`` means auto: the kernels on CUDA tensors, the plain path on
    the CPU (the JAX package's auto is "on for TPU")."""
    if setting is not None:
        return bool(setting)
    return torch.device(device).type == "cuda"


def _scale(scale, d):
    return scale if scale is not None else 1.0 / math.sqrt(d)


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              scale: Optional[float] = None):
    """The plain version: ``multihead_attention``'s math (``_repeat_kv``,
    f32 logits and softmax, probabilities cast to ``q.dtype`` before P.V)."""
    return multihead_attention(q, k, v, causal=causal, scale=scale)


def _f32_logits(q, k, causal, scale):
    """(B, Hq, Sq, Skv) f32 scaled logits from f32 copies of the inputs,
    masked with -inf above the end-aligned diagonal, and the mask."""
    sq, skv, hq, hkv = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    kk = _repeat_kv(k.float(), hq // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * _scale(scale, q.shape[-1])
    mask = None
    if causal:
        ones = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        mask = torch.tril(ones, diagonal=skv - sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    return logits, mask


def flash_attention_lse_reference(q, k, v, *, causal: bool = True,
                                  scale: Optional[float] = None):
    """The plain version of the ``emit_lse`` forward: the output of
    ``flash_attention_reference`` and the f32 row log-sum-exp of the scaled
    logits, (B, Hq, Sq)."""
    out = flash_attention_reference(q, k, v, causal=causal, scale=scale)
    logits, _ = _f32_logits(q, k, causal, scale)
    return out, torch.logsumexp(logits, dim=-1)


def flash_bwd_reference(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None):
    """The plain backward, in f32 from the saved ``o`` and ``lse``: the
    FA2 formulas of the JAX ``_bwd_recompute``.  GQA partials are summed
    over each group.  Returns (dq, dk, dv) in the inputs' dtypes."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    n_rep = hq // hkv
    s = _scale(scale, d)
    logits, mask = _f32_logits(q, k, causal, scale)
    p = torch.exp(logits - lse.float()[..., None])
    if mask is not None:
        p = p.masked_fill(~mask, 0.0)
    dof, of = do.float(), o.float()
    kk = _repeat_kv(k.float(), n_rep)
    vv = _repeat_kv(v.float(), n_rep)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vv)
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]  # (B, Hq, Sq, 1)
    ds = p * (dp - delta) * s
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kk)
    skv = k.shape[1]
    dk = dk.reshape(b, skv, hkv, n_rep, d).sum(3)
    dv = dv.reshape(b, skv, hkv, n_rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fwd_fn():
    fn = _build.load("flash_fwd").tdx_flash_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn(name: str, n_ptrs: int):
    fn = getattr(_build.load("flash_bwd"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _check(fn_name, tensors, d):
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{fn_name}: {name} is not a CUDA tensor")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{fn_name} takes bf16, got {name}.dtype={t.dtype}")
    if d not in (64, 128):
        raise ValueError(f"{fn_name} takes head_dim 64 or 128, got {d}")


def flash_fwd_cuda(q, k, v, *, causal: bool = True,
                   scale: Optional[float] = None, return_lse: bool = False):
    """Launch the forward kernel on CUDA tensors (bf16, D in {64, 128},
    (B, S, H, D)).  With ``return_lse`` it also writes the f32 row
    log-sum-exp (B, Hq, Sq) and returns ``(out, lse)``.  Adds one to
    ``flash_fwd_cuda.launches`` (plain) or ``flash_fwd_cuda.lse_launches``."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    _check("flash_fwd_cuda", (("q", q), ("k", k), ("v", v)), d)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if causal and sq > skv:
        raise ValueError(f"causal attention requires Sq ({sq}) <= Skv ({skv})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _fwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            b, sq, skv, hq, hkv, d, _scale(scale, d), int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    if return_lse:
        flash_fwd_cuda.lse_launches += 1
        return out, lse
    flash_fwd_cuda.launches += 1
    return out


flash_fwd_cuda.launches = 0
flash_fwd_cuda.lse_launches = 0


def _check_bwd(fn_name, q, k, v, o, lse, do, causal):
    b, sq, hq, d = q.shape
    _check(fn_name, (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)), d)
    if not causal:
        raise ValueError(f"{fn_name} takes causal attention only")
    if k.shape != v.shape or k.shape[:2] != (b, sq) or k.shape[3] != d:
        raise ValueError(f"{fn_name} takes Sq == Skv; k/v {tuple(k.shape)}, q {tuple(q.shape)}")
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{fn_name}: o/do shapes must equal q's {tuple(q.shape)}")
    if hq % k.shape[2] != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {k.shape[2]}")
    if not lse.is_cuda or lse.dtype != torch.float32 or lse.shape != (b, hq, sq):
        raise ValueError(f"{fn_name}: lse must be f32 CUDA (B, Hq, Sq)")
    return [t.contiguous() for t in (q, k, v, o, lse, do)]


def flash_bwd_dkv_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                       scale: Optional[float] = None):
    """Launch the K/V-stationary backward kernel: (dk, dv), GQA groups
    summed in the kernel.  Adds one to ``flash_bwd_dkv_cuda.launches``."""
    q, k, v, o, lse, do = _check_bwd("flash_bwd_dkv_cuda", q, k, v, o, lse, do, causal)
    b, s, hq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _bwd_fn("tdx_flash_bwd_dkv_bf16", 8)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, hq, k.shape[2], d, _scale(scale, d), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: CUDA error {err}")
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_bwd_dkv_cuda.launches = 0


def flash_bwd_dq_cuda(q, k, v, o, lse, do, *, causal: bool = True,
                      scale: Optional[float] = None):
    """Launch the Q-stationary backward kernel: dq.  Adds one to
    ``flash_bwd_dq_cuda.launches``."""
    q, k, v, o, lse, do = _check_bwd("flash_bwd_dq_cuda", q, k, v, o, lse, do, causal)
    b, s, hq, d = q.shape
    dq = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _bwd_fn("tdx_flash_bwd_dq_bf16", 7)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(),
            b, s, hq, k.shape[2], d, _scale(scale, d), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: CUDA error {err}")
    flash_bwd_dq_cuda.launches += 1
    return dq


flash_bwd_dq_cuda.launches = 0


def flash_attention_lse(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None):
    """(out, lse): the kernel on CUDA tensors, the plain version on the CPU."""
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, causal=causal, scale=scale, return_lse=True)
    return flash_attention_lse_reference(q, k, v, causal=causal, scale=scale)


def flash_backward(q, k, v, o, lse, do, *, causal: bool = True,
                   scale: Optional[float] = None):
    """(dq, dk, dv): the two kernels on CUDA tensors, the plain version on
    the CPU."""
    if q.is_cuda:
        dk, dv = flash_bwd_dkv_cuda(q, k, v, o, lse, do, causal=causal, scale=scale)
        dq = flash_bwd_dq_cuda(q, k, v, o, lse, do, causal=causal, scale=scale)
        return dq, dk, dv
    return flash_bwd_reference(q, k, v, o, lse, do, causal=causal, scale=scale)


class _FlashAttention(torch.autograd.Function):
    """The JAX ``custom_vjp``: forward with ``lse`` saved, backward by the
    two FA2 kernels (no recompute of the forward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_lse(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, do.contiguous(),
                                    causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """(B, Sq, Hq, D) x (B, Skv, Hkv, D)^2 -> (B, Sq, Hq, D), end-aligned
    causal mask.  CUDA tensors go through the kernels; CPU tensors through
    the plain versions.  Differentiable."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale)
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, causal=causal, scale=scale)
    return flash_attention_reference(q, k, v, causal=causal, scale=scale)
