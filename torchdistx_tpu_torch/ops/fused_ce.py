"""Fused LM-head cross-entropy: the hand-written CUDA kernels, their plain
PyTorch versions, and the differentiable ``fused_linear_cross_entropy``.

Counterpart of ``torchdistx_tpu/ops/fused_ce.py``.  The mean token
cross-entropy of ``logits = x @ w.T`` needs only per-token ``(lse,
z_label)`` forward and the products ``dX = dP W``, ``dW = dP^T X``
backward, where dP is a recompute from the saved ``lse``: the (N, V)
logits never reach device memory.  ``csrc/fused_ce.cu`` replaces the
Pallas kernels:

- ``fused_ce_fwd_cuda`` (``_fwd_kernel``): per-token loss and f32 ``lse``;
- ``fused_ce_bwd_cuda`` (``_dx_kernel`` and ``_dw_kernel``): dX and dW in
  one backward, scaled by 1/N and the cotangent on the device.  Per chunk
  of :func:`bwd_chunk` vocab columns it writes the chunk's bf16 dP panel
  once and takes both products from it, with no atomics: two launches give
  the same bits.

The kernels choose their own tiles (the TPU knobs ``block_t``, ``block_v``
and ``interpret`` are not carried over) and mask the ragged vocab and token
edges in-kernel: nothing is padded in memory.  A CUDA tensor launches the
kernels or raises; the plain versions (``fused_ce_fwd_reference``,
``fused_ce_bwd_reference``) run only for tensors on the CPU.
``fused_linear_cross_entropy_reference`` is the unfused function they all
compute.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, _cost

__all__ = [
    "fused_linear_cross_entropy",
    "fused_linear_cross_entropy_reference",
    "fused_ce_fwd_reference",
    "fused_ce_bwd_reference",
    "fused_ce_fwd_cuda",
    "fused_ce_bwd_cuda",
    "bwd_chunk",
]

#: the backward's bf16 (N, chunk) dP panel holds at most this many bytes
PANEL_BYTES = 256 << 20
#: a chunk is a whole number of the backward kernels' 256-wide tiles
_CHUNK_ALIGN = 256


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


def bwd_chunk(n: int, v: int) -> int:
    """Vocab columns per chunk of the backward: the fewest chunks whose
    bf16 (N, chunk) dP panel fits ``PANEL_BYTES``, each rounded up to a
    multiple of 256 columns (the last one holds the rest)."""
    chunks = -(-(2 * n * v) // PANEL_BYTES)
    return -(-v // (chunks * _CHUNK_ALIGN)) * _CHUNK_ALIGN


def fused_ce_bwd_reference(x, w, labels, lse, g, chunk=None):
    """The plain version of the backward's algorithm, in f32: for each
    chunk of ``chunk`` vocab columns (default :func:`bwd_chunk`), in order,
    dP = exp(X W_c^T - lse) - onehot, dW_c = dP^T X and dX += dP W_c; both
    times g / N.  Returns (dX, dW) in x's and w's dtypes."""
    n, v = x.shape[0], w.shape[0]
    chunk = chunk or bwd_chunk(n, v)
    xf, wf, lab = x.float(), w.float(), labels.long()
    rows = torch.arange(n, device=x.device)
    dx = torch.zeros_like(xf)
    dw = torch.empty_like(wf)
    for v0 in range(0, v, chunk):
        wc = wf[v0:v0 + chunk]
        dp = torch.exp(xf @ wc.T - lse.float()[:, None])
        hit = (lab >= v0) & (lab < v0 + wc.shape[0])
        dp[rows[hit], lab[hit] - v0] -= 1.0
        dw[v0:v0 + chunk] = dp.T @ xf
        dx += dp @ wc
    scale = g.float().reshape(()) / n
    return (dx * scale).to(x.dtype), (dw * scale).to(w.dtype)


def _lib():
    lib = _build.load("fused_ce")
    if lib.tdx_fused_ce_fwd_bf16.argtypes is None:
        lib.tdx_fused_ce_fwd_cols.argtypes = []
        lib.tdx_fused_ce_fwd_cols.restype = ctypes.c_int
        lib.tdx_fused_ce_fwd_bf16.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.tdx_fused_ce_fwd_bf16.restype = ctypes.c_int
        lib.tdx_fused_ce_bwd_bf16.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.tdx_fused_ce_bwd_bf16.restype = ctypes.c_int
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
    _cost.book("fused_ce_fwd_cuda", _cost.fused_ce_fwd(n, d, v))
    return loss, lse


fused_ce_fwd_cuda.launches = 0


def fused_ce_bwd_cuda(x, w, labels, lse, g):
    """Launch the backward: (dX (N, D), dW (V, D)) bf16 = (softmax -
    onehot) W and its transpose times X, times ``g`` / N, ``g`` a
    one-element f32 CUDA tensor.  Scratch: the bf16 (N, chunk) dP panel
    and, when the vocab takes more than one chunk, an f32 (N, D) sum for
    dX.  Adds one to ``fused_ce_bwd_cuda.launches``."""
    x, w, labels = _check("fused_ce_bwd_cuda", x, w, labels, lse, g)
    n, d = x.shape
    v = w.shape[0]
    chunk = bwd_chunk(n, v)
    panel = torch.empty((n, chunk), dtype=torch.bfloat16, device=x.device)
    ws = torch.empty((n, d), dtype=torch.float32, device=x.device) if chunk < v else None
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    lse, g = lse.contiguous(), g.reshape(1).contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().tdx_fused_ce_bwd_bf16(
            x.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
            panel.data_ptr(), None if ws is None else ws.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), n, v, d, chunk, stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_bwd kernel launch failed: CUDA error {err}")
    fused_ce_bwd_cuda.launches += 1
    _cost.book("fused_ce_bwd_cuda", _cost.fused_ce_bwd(n, d, v))
    return dx, dw


fused_ce_bwd_cuda.launches = 0


class _FusedCE(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward saves the per-token f32 ``lse``;
    the backward recomputes the logits once for dX and dW and scales by
    the cotangent on the device."""

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
        bwd = fused_ce_bwd_cuda if x.is_cuda else fused_ce_bwd_reference
        dx, dw = bwd(x, w, labels, lse, g.float())
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None)


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
