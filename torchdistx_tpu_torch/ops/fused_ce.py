"""Fused LM-head cross-entropy: the hand-written CUDA kernels, their plain
PyTorch versions, and the differentiable ``fused_linear_cross_entropy``.

Counterpart of ``torchdistx_tpu/ops/fused_ce.py``.  The mean token
cross-entropy of ``logits = x @ w.T`` needs only per-token ``(lse,
z_label)`` forward and the products ``dX = dP W``, ``dW = dP^T X``
backward, where each dP tile is a recompute from the saved ``lse``: the
(N, V) logits never reach device memory.  Three kernels in
``csrc/fused_ce.cu`` replace the Pallas ones:

- ``fused_ce_fwd_cuda`` (``_fwd_kernel``): per-token loss and f32 ``lse``;
- ``fused_ce_dx_cuda`` (``_dx_kernel``): dX, scaled by 1/N and the
  cotangent on the device;
- ``fused_ce_dw_cuda`` (``_dw_kernel``): dW, the same.

The kernels choose their own tiles (the TPU knobs ``block_t``, ``block_v``
and ``interpret`` are not carried over) and mask the ragged vocab and token
edges in-kernel: nothing is padded in memory.  A CUDA tensor launches the
kernels or raises; the plain versions (``fused_ce_fwd_reference``,
``fused_ce_dx_reference``, ``fused_ce_dw_reference``) run only for tensors
on the CPU.  ``fused_linear_cross_entropy_reference`` is the unfused
function they all compute.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "fused_linear_cross_entropy",
    "fused_linear_cross_entropy_reference",
    "fused_ce_fwd_reference",
    "fused_ce_dx_reference",
    "fused_ce_dw_reference",
    "fused_ce_fwd_cuda",
    "fused_ce_dx_cuda",
    "fused_ce_dw_cuda",
]


def fused_linear_cross_entropy_reference(x, w, labels):
    """``cross_entropy(x.float() @ w.float().T, labels)``: the unfused f32
    function, differentiable by autograd.  x (N, D), w (V, D), labels (N,)."""
    logits = x.float() @ w.float().T
    return torch.nn.functional.cross_entropy(logits, labels.long())


def fused_ce_fwd_reference(x, w, labels):
    """Plain forward: per-token loss ``lse - z_label`` and the f32 ``lse``,
    both (N,), from f32 copies of the inputs."""
    logits = x.float() @ w.float().T
    lse = torch.logsumexp(logits, dim=-1)
    zy = logits.gather(1, labels.long()[:, None])[:, 0]
    return lse - zy, lse


def _dlogits(x, w, labels, lse, g):
    """(softmax - onehot) * g / N in f32, recomputed from ``lse``."""
    n = x.shape[0]
    p = torch.exp(x.float() @ w.float().T - lse.float()[:, None])
    p[torch.arange(n, device=p.device), labels.long()] -= 1.0
    return p * (g.float().reshape(()) / n)


def fused_ce_dx_reference(x, w, labels, lse, g):
    """Plain dX = dP W in x's dtype."""
    return (_dlogits(x, w, labels, lse, g) @ w.float()).to(x.dtype)


def fused_ce_dw_reference(x, w, labels, lse, g):
    """Plain dW = dP^T X in w's dtype."""
    return (_dlogits(x, w, labels, lse, g).T @ x.float()).to(w.dtype)


def _lib():
    lib = _build.load("fused_ce")
    if lib.tdx_fused_ce_fwd_bf16.argtypes is None:
        lib.tdx_fused_ce_fwd_cols.argtypes = []
        lib.tdx_fused_ce_fwd_cols.restype = ctypes.c_int
        lib.tdx_fused_ce_fwd_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.tdx_fused_ce_fwd_bf16.restype = ctypes.c_int
        for name in ("tdx_fused_ce_dx_bf16", "tdx_fused_ce_dw_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(fn_name, x, w, labels, lse=None, g=None):
    """Device, dtype and shape checks; returns contiguous 16-byte aligned
    (x, w, int32 labels)."""
    tensors = [("x", x), ("w", w), ("labels", labels)]
    tensors += [(n, t) for n, t in (("lse", lse), ("g", g)) if t is not None]
    for name, t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{fn_name}: {name} is not a CUDA tensor")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{fn_name} takes bf16, got {name}.dtype={t.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{fn_name}: x must be (N, D) and w (V, D), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, d = x.shape
    if d % 8 != 0 or n < 1 or w.shape[0] < 1:
        raise ValueError(f"{fn_name} takes D % 8 == 0 and N, V >= 1, got "
                         f"N={n} D={d} V={w.shape[0]}")
    if labels.shape != (n,) or labels.dtype.is_floating_point:
        raise ValueError(f"{fn_name}: labels must be integer (N,)={n}, got "
                         f"{tuple(labels.shape)} {labels.dtype}")
    if lse is not None and (lse.dtype != torch.float32 or lse.shape != (n,)):
        raise ValueError(f"{fn_name}: lse must be f32 (N,)")
    if g is not None and (g.dtype != torch.float32 or g.numel() != 1):
        raise ValueError(f"{fn_name}: g must be one f32 value")
    return _aligned(x), _aligned(w), labels.to(torch.int32).contiguous()


def fused_ce_fwd_cuda(x, w, labels):
    """Launch the forward kernel: (loss (N,), lse (N,)), both f32.  Adds one
    to ``fused_ce_fwd_cuda.launches``."""
    x, w, labels = _check("fused_ce_fwd_cuda", x, w, labels)
    n, d = x.shape
    v = w.shape[0]
    lib = _lib()
    n_split = -(-v // lib.tdx_fused_ce_fwd_cols())
    part = torch.empty((3, n_split, n), dtype=torch.float32, device=x.device)
    loss = torch.empty(n, dtype=torch.float32, device=x.device)
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.tdx_fused_ce_fwd_bf16(
            x.data_ptr(), w.data_ptr(), labels.data_ptr(), part.data_ptr(),
            loss.data_ptr(), lse.data_ptr(), n, v, d, stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_fwd kernel launch failed: CUDA error {err}")
    fused_ce_fwd_cuda.launches += 1
    return loss, lse


fused_ce_fwd_cuda.launches = 0


def _grad(fn_name, entry, x, w, labels, lse, g, rows):
    x, w, labels = _check(fn_name, x, w, labels, lse, g)
    n, d = x.shape
    v = w.shape[0]
    stat = n if rows == "x" else v
    ws = torch.zeros((stat, d), dtype=torch.float32, device=x.device)
    out = torch.empty((stat, d), dtype=torch.bfloat16, device=x.device)
    lse, g = lse.contiguous(), g.reshape(1).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = getattr(_lib(), entry)(
            x.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
            ws.data_ptr(), out.data_ptr(), n, v, d, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")
    return out


def fused_ce_dx_cuda(x, w, labels, lse, g):
    """Launch the dX kernel: bf16 (N, D) = (softmax - onehot) W * g / N,
    ``g`` a one-element f32 CUDA tensor.  Adds one to
    ``fused_ce_dx_cuda.launches``."""
    out = _grad("fused_ce_dx", "tdx_fused_ce_dx_bf16", x, w, labels, lse, g, "x")
    fused_ce_dx_cuda.launches += 1
    return out


fused_ce_dx_cuda.launches = 0


def fused_ce_dw_cuda(x, w, labels, lse, g):
    """Launch the dW kernel: bf16 (V, D) = (softmax - onehot)^T X * g / N.
    Adds one to ``fused_ce_dw_cuda.launches``."""
    out = _grad("fused_ce_dw", "tdx_fused_ce_dw_bf16", x, w, labels, lse, g, "w")
    fused_ce_dw_cuda.launches += 1
    return out


fused_ce_dw_cuda.launches = 0


class _FusedCE(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward saves the per-token f32 ``lse``;
    the backward launches the dX and dW kernels, which recompute the
    logits tiles and scale by the cotangent on the device."""

    @staticmethod
    def forward(ctx, x, w, labels):
        if x.is_cuda:
            loss_rows, lse = fused_ce_fwd_cuda(x, w, labels)
        else:
            loss_rows, lse = fused_ce_fwd_reference(x, w, labels)
        ctx.save_for_backward(x, w, labels, lse)
        return loss_rows.mean()

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        g = g.float()
        dx = dw = None
        if x.is_cuda:
            if ctx.needs_input_grad[0]:
                dx = fused_ce_dx_cuda(x, w, labels, lse, g)
            if ctx.needs_input_grad[1]:
                dw = fused_ce_dw_cuda(x, w, labels, lse, g)
        else:
            if ctx.needs_input_grad[0]:
                dx = fused_ce_dx_reference(x, w, labels, lse, g)
            if ctx.needs_input_grad[1]:
                dw = fused_ce_dw_reference(x, w, labels, lse, g)
        return dx, dw, None


def fused_linear_cross_entropy(x, w, labels):
    """Mean token cross-entropy of the LM head ``logits = x @ w.T`` without
    materializing the logits, as an f32 scalar.

    x: (..., N, D) hidden states (leading dims flattened); w: (V, D), the
    ``nn.Linear`` layout (GPT-2: the tied ``tok_emb.weight``); labels:
    integers of x's leading shape.  Equals ``cross_entropy(x @ w.T,
    labels)`` up to f32 summation order; differentiable in ``x`` and
    ``w``.  CUDA tensors go through the kernels (bf16 only), CPU tensors
    through the plain versions."""
    d = x.shape[-1]
    if w.dim() != 2 or w.shape[1] != d:
        raise ValueError(f"w must be (V, {d}), got {tuple(w.shape)}")
    xf = x.reshape(-1, d)
    lf = labels.reshape(-1)
    if lf.shape[0] != xf.shape[0]:
        raise ValueError(
            f"labels {tuple(labels.shape)} do not match tokens {tuple(x.shape[:-1])}")
    return _FusedCE.apply(xf, w, lf)
