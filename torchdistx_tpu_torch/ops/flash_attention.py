"""Flash-attention forward: the hand-written CUDA kernel, its plain PyTorch
version, and the dispatcher between them.

Counterpart of ``torchdistx_tpu/ops/flash_attention.py``.  The kernel
(``csrc/flash_fwd.cu``) replaces the Pallas ``_kernel`` launched by
``_flash_forward`` in its causal, no-bias, no-window, plain-output variant:
the serving engine's cold prefill.  It is bounded by operations on an
H100; the source file says what its design does about that.

``flash_attention`` keeps the JAX layout, (B, S, H, D).  A CUDA tensor
launches the kernel or raises; the plain version
(``flash_attention_reference``) runs only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .attention import multihead_attention

__all__ = [
    "resolve_use_flash",
    "flash_attention",
    "flash_attention_reference",
    "flash_fwd_cuda",
]

_NEG_INF = -1e30
_LIB = "flash_fwd"


def resolve_use_flash(setting: Optional[bool], device) -> bool:
    """``None`` means auto: the kernels on CUDA tensors, the plain path on
    the CPU (the JAX package's auto is "on for TPU")."""
    if setting is not None:
        return bool(setting)
    return torch.device(device).type == "cuda"


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              scale: Optional[float] = None):
    """The plain version: ``multihead_attention``'s math (``_repeat_kv``,
    f32 logits and softmax, probabilities cast to ``q.dtype`` before P.V)."""
    return multihead_attention(q, k, v, causal=causal, scale=scale)


def _lib():
    lib = _build.load(_LIB)
    fn = lib.tdx_flash_fwd_bf16
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def flash_fwd_cuda(q, k, v, *, causal: bool = True,
                   scale: Optional[float] = None):
    """Launch the CUDA kernel on CUDA tensors (bf16, D in {64, 128},
    contiguous (B, S, H, D)).  Adds one to ``flash_fwd_cuda.launches``."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_fwd_cuda: {name} is not a CUDA tensor")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_fwd_cuda takes bf16, got {name}.dtype={t.dtype}")
    if d not in (64, 128):
        raise ValueError(f"flash_fwd_cuda takes head_dim 64 or 128, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if hq % hkv != 0:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    if causal and sq > skv:
        raise ValueError(f"causal attention requires Sq ({sq}) <= Skv ({skv})")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale_ = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, skv, hq, hkv, d, scale_, int(causal), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_fwd_cuda.launches += 1
    return out


flash_fwd_cuda.launches = 0


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None):
    """(B, Sq, Hq, D) x (B, Skv, Hkv, D)^2 -> (B, Sq, Hq, D), end-aligned
    causal mask.  CUDA tensors go through the kernel; CPU tensors through
    the plain version."""
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, causal=causal, scale=scale)
    return flash_attention_reference(q, k, v, causal=causal, scale=scale)
