"""Slot decode attention: the hand-written CUDA kernel, its plain PyTorch
version, and the dispatcher between them.

Counterpart of ``torchdistx_tpu/ops/decode_attention.py``.  The kernel
(``csrc/decode_attention.cu``) replaces the Pallas ``_decode_kernel``
launched by ``decode_attention``, unquantized: one generated token per
serving slot, each slot at its own depth, read in place from the
(B, max_len, Hkv, D) slab.  It is bounded by bytes on an H100; the source
file says what its design does about that.

A CUDA tensor launches the kernel or raises; the plain version
(``decode_attention_reference``, the JAX package's ``_slot_attend``) runs
only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .attention import _slot_attend

__all__ = [
    "decode_attention",
    "decode_attention_reference",
    "decode_attention_cuda",
]

_LIB = "decode_attention"


def decode_attention_reference(q, ck, cv, positions, *,
                               scale: Optional[float] = None):
    """The plain version: ``_slot_attend`` (``_repeat_kv``, f32 logits and
    softmax over rows ``j <= positions[b]``, probabilities cast to
    ``q.dtype`` before P.V)."""
    return _slot_attend(q, ck, cv, positions, scale, None)


def _lib():
    lib = _build.load(_LIB)
    fn = lib.tdx_decode_attention_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q, ck, cv, positions, *,
                          scale: Optional[float] = None):
    """Launch the CUDA kernel: ``q`` (B, 1, Hq, D) bf16, slab ``ck``/``cv``
    (B, max_len, Hkv, D) bf16 contiguous, ``positions`` (B,) integer.
    Hq / Hkv in {1, 2, 4, 8}, D in {64, 128}.  Adds one to
    ``decode_attention_cuda.launches``."""
    b, s, hq, d = q.shape
    if s != 1:
        raise ValueError(f"decode_attention takes one token per slot, got S={s}")
    for name, t in (("q", q), ("ck", ck), ("cv", cv), ("positions", positions)):
        if not t.is_cuda:
            raise ValueError(f"decode_attention_cuda: {name} is not a CUDA tensor")
    for name, t in (("q", q), ("ck", ck), ("cv", cv)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention_cuda takes bf16, got {name}.dtype={t.dtype}")
    if ck.shape != cv.shape or ck.shape[0] != b or ck.shape[3] != d:
        raise ValueError(f"slab shapes {tuple(ck.shape)}/{tuple(cv.shape)} do not match q {tuple(q.shape)}")
    if not (ck.is_contiguous() and cv.is_contiguous()):
        raise ValueError("decode_attention_cuda reads the slab in place: it must be contiguous")
    max_len, hkv = ck.shape[1], ck.shape[2]
    if hq % hkv != 0 or hq // hkv not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention_cuda takes Hq/Hkv in (1, 2, 4, 8), got {hq}/{hkv}")
    if d not in (64, 128):
        raise ValueError(f"decode_attention_cuda takes head_dim 64 or 128, got {d}")
    q = q.contiguous()
    pos = positions.to(torch.int32).contiguous()
    scale_ = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib()(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, max_len, hq, hkv, d, scale_, stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error {err}")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def decode_attention(q, ck, cv, positions, *, scale: Optional[float] = None):
    """Slot decode attention (post-write): slot ``b`` attends cache rows
    ``j <= positions[b]``.  Returns (B, 1, Hq, D) in ``q.dtype``.  CUDA
    tensors go through the kernel; CPU tensors through the plain version."""
    if q.is_cuda:
        return decode_attention_cuda(q, ck, cv, positions, scale=scale)
    return decode_attention_reference(q, ck, cv, positions, scale=scale)
