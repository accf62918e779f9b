"""The port's differentiable flash attention against the JAX package's, on
the CPU.

The same numpy inputs (from a seed) go through ``jax.grad`` of the JAX
``flash_attention`` (the Pallas forward and FA2 backward kernels in
interpret mode, blocks of 16) and through ``torch.autograd`` of the port's
``flash_attention``, whose ``autograd.Function`` takes the plain forward
with ``lse`` and the plain backward for CPU tensors.  f32 throughout;
tolerance atol = rtol = 2e-4, as ``tests/test_flash_attention.py`` uses
for the JAX kernels' gradients: the same FA2 formulas with sums over
blocks taken in another order than one-shot einsums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

from torchdistx_tpu.ops.flash_attention import _flash_forward as j_flash_fwd
from torchdistx_tpu.ops.flash_attention import flash_attention as j_flash
from torchdistx_tpu_torch.ops import flash_attention as tflash
from torchdistx_tpu_torch.ops.attention import multihead_attention

TOL = dict(atol=2e-4, rtol=2e-4)
CASES = [(2, 2, 64), (8, 2, 64), (4, 4, 37)]  # (hq, hkv, s): MHA, GQA, ragged
D = 16


def _inputs(hq, hkv, s, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(2, s, hq, D).astype(np.float32)
    k = rs.randn(2, s, hkv, D).astype(np.float32)
    v = rs.randn(2, s, hkv, D).astype(np.float32)
    do = rs.randn(2, s, hq, D).astype(np.float32)
    return q, k, v, do


def _torch_grads(fn, q, k, v, do):
    ts = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("hq,hkv,s", CASES)
def test_flash_grads_match_jax_kernels(hq, hkv, s):
    q, k, v, do = _inputs(hq, hkv, s, seed=hq * 100 + s)

    def jf(q_, k_, v_):
        return j_flash(q_, k_, v_, causal=True, block_q=16, block_k=16,
                       interpret=True)

    jout, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tflash.flash_bwd_dkv_cuda.launches = tflash.flash_bwd_dq_cuda.launches = 0
    out, grads = _torch_grads(tflash.flash_attention, q, k, v, do)
    np.testing.assert_allclose(out, np.asarray(jout), **TOL)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g, np.asarray(jg), err_msg=f"d{name}", **TOL)
    # CPU tensors take the plain versions: no kernel was launched
    assert tflash.flash_bwd_dkv_cuda.launches == tflash.flash_bwd_dq_cuda.launches == 0


@pytest.mark.parametrize("hq,hkv,s", CASES)
def test_lse_matches_jax_emit_lse(hq, hkv, s):
    q, k, v, _ = _inputs(hq, hkv, s, seed=s)
    jout, jlse = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, block_q=16, block_k=16,
                             interpret=True, return_lse=True)
    out, lse = tflash.flash_attention_lse_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert tuple(lse.shape) == (2, hq, s)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("hq,hkv,s", CASES + [(4, 1, 9)])
def test_bwd_reference_matches_autograd_of_plain_attention(hq, hkv, s):
    """The FA2 formulas from the saved (o, lse) give autograd's gradients
    of the one-shot attention; f32, 1e-5 (the same math, in one pass)."""
    q, k, v, do = _inputs(hq, hkv, s, seed=7 * s + hkv)
    _, ref = _torch_grads(multihead_attention, q, k, v, do)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tflash.flash_attention_lse_reference(tq, tk, tv)
    grads = tflash.flash_bwd_reference(tq, tk, tv, o, lse, tdo)
    for name, g, r in zip("qkv", grads, ref):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")


def test_no_grad_keeps_the_serving_call():
    """Without autograd the call is the serving forward: no lse, and a
    tensor that needs no gradient gets no graph."""
    q, k, v, _ = _inputs(2, 2, 8, seed=1)
    tq = torch.from_numpy(q).requires_grad_()
    with torch.no_grad():
        out = tflash.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v))
    assert out.grad_fn is None
    out = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v))
    assert out.grad_fn is None
    out = tflash.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v))
    assert type(out.grad_fn).__name__.startswith("_FlashAttention")


def test_backward_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_bwd_dkv_cuda(x, x, x, x, lse, x)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_bwd_dq_cuda(x, x, x, x, lse, x)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_fwd_cuda(x, x, x, return_lse=True)
