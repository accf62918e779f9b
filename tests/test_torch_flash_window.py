"""The port's sliding-window flash attention against the JAX package's, on
the CPU.

The same numpy inputs (from a seed) go through the JAX ``flash_attention``
with ``window=`` (the Pallas forward and FA2 backward kernels in interpret
mode, blocks of 8: the band cuts tiles as on the chip) and through the
port's, whose ``autograd.Function`` takes the plain versions for CPU
tensors.  Windows of 1, below the tile, equal to it, not a multiple of it
and at least S; MHA and GQA; Sq < Skv for the forward.  f32 throughout;
tolerance atol = rtol = 2e-4, as ``tests/test_torch_flash_bwd.py``: the
same FA2 formulas with sums over blocks in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

from torchdistx_tpu.ops.attention import cached_attention as j_cached
from torchdistx_tpu.ops.flash_attention import _flash_forward as j_flash_fwd
from torchdistx_tpu.ops.flash_attention import flash_attention as j_flash
from torchdistx_tpu_torch.ops import attention as tattn
from torchdistx_tpu_torch.ops import flash_attention as tflash

TOL = dict(atol=2e-4, rtol=2e-4)
BLOCK = dict(block_q=8, block_k=8, interpret=True)
D = 16
# (hq, hkv, s, window)
CASES = [
    (4, 4, 64, 1),    # one key a row: the diagonal tile only
    (8, 2, 64, 5),    # below the tile, GQA
    (2, 2, 48, 8),    # equal to the tile
    (4, 2, 40, 12),   # not a multiple of the tile: tiles partly in the band
    (4, 4, 40, 64),   # at least S: plain causal attention
]
IDS = ["w1", "w5-gqa", "w8", "w12-gqa", "w64-geS"]


def _inputs(hq, hkv, s, seed, sq=None):
    rs = np.random.RandomState(seed)
    sq = s if sq is None else sq
    q = rs.randn(2, sq, hq, D).astype(np.float32)
    k = rs.randn(2, s, hkv, D).astype(np.float32)
    v = rs.randn(2, s, hkv, D).astype(np.float32)
    do = rs.randn(2, sq, hq, D).astype(np.float32)
    return q, k, v, do


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("hq,hkv,s,window", CASES, ids=IDS)
def test_window_forward_and_grads_match_jax_kernels(hq, hkv, s, window):
    q, k, v, do = _inputs(hq, hkv, s, seed=window * 10 + s)

    def jf(q_, k_, v_):
        return j_flash(q_, k_, v_, causal=True, window=window, **BLOCK)

    jout, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    for fn in (tflash.flash_fwd_cuda, tflash.flash_bwd_dkv_cuda, tflash.flash_bwd_dq_cuda):
        fn.window_launches = 0
    ts = [_t(x).requires_grad_() for x in (q, k, v)]
    out = tflash.flash_attention(*ts, causal=True, window=window)
    out.backward(_t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for name, t, jg in zip("qkv", ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), err_msg=f"d{name}", **TOL)
    # CPU tensors take the plain versions: no kernel was launched
    assert (tflash.flash_fwd_cuda.window_launches == tflash.flash_bwd_dkv_cuda.window_launches
            == tflash.flash_bwd_dq_cuda.window_launches == 0)


@pytest.mark.parametrize("hq,hkv,s,window", CASES, ids=IDS)
def test_window_lse_matches_jax_emit_lse(hq, hkv, s, window):
    q, k, v, _ = _inputs(hq, hkv, s, seed=s + window)
    jout, jlse = j_flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                             return_lse=True, window=window, **BLOCK)
    out, lse = tflash.flash_attention_lse_reference(_t(q), _t(k), _t(v), window=window)
    assert tuple(lse.shape) == (2, hq, s)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("sq,skv,window", [(16, 48, 12), (8, 40, 5), (24, 24, 3)])
def test_window_forward_with_fewer_queries_matches_jax(sq, skv, window):
    """End-aligned band: query i sees keys (i + Skv - Sq - window, i + Skv - Sq]."""
    q, k, v, _ = _inputs(4, 2, skv, seed=sq * 7 + window, sq=sq)
    jout = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                   window=window, **BLOCK)
    with torch.no_grad():
        out = tflash.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("hq,hkv,s,window", CASES[1:4], ids=IDS[1:4])
def test_window_bwd_reference_matches_autograd_of_plain_attention(hq, hkv, s, window):
    """The plain backward from the saved (o, lse) equals autograd through
    the windowed ``multihead_attention``."""
    q, k, v, do = _inputs(hq, hkv, s, seed=3 * s + window)
    ts = [_t(x).requires_grad_() for x in (q, k, v)]
    out = tattn.multihead_attention(*ts, causal=True, window=window)
    out.backward(_t(do))
    o, lse = tflash.flash_attention_lse_reference(_t(q), _t(k), _t(v), window=window)
    grads = tflash.flash_bwd_reference(_t(q), _t(k), _t(v), o, lse, _t(do), window=window)
    for name, g, t in zip("qkv", grads, ts):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("s", [40, 48])
def test_windowed_flash_prefill_matches_jax(s):
    """``cached_attention``'s from-empty prefill with a window: the port's
    flash path (plain on the CPU) against the JAX flash prefill in interpret
    mode."""
    rs = np.random.RandomState(s)
    q, k, v = (rs.randn(1, s, 2, 8).astype(np.float32) for _ in range(3))
    cache = np.zeros((1, 64, 2, 8), np.float32)
    jout, _ = j_cached(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       (jnp.asarray(cache), jnp.asarray(cache)), 0, use_flash=True, window=12)
    tout, (ck, _) = tattn.cached_attention(_t(q), _t(k), _t(v), (_t(cache), _t(cache)), 0,
                                           use_flash=True, window=12)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_array_equal(ck[:, :s].numpy(), k)


@pytest.mark.parametrize("kw,match", [
    (dict(window=0), "window must be"),
    (dict(window=-3), "window must be"),
    (dict(window=4, causal=False), "window requires causal"),
    (dict(window=4, bias="bias"), "mutually exclusive"),
    (dict(window=4, rel_bias_table="table"), "mutually exclusive"),
], ids=["zero", "negative", "not-causal", "with-bias", "with-table"])
def test_window_argument_checks_raise_where_jax_raises(kw, match):
    q = np.zeros((1, 8, 2, 16), np.float32)
    extra = {"bias": np.zeros((2, 8, 8), np.float32), "table": np.zeros((2, 32), np.float32)}
    jkw = {key: (jnp.asarray(extra[val]) if isinstance(val, str) else val)
           for key, val in kw.items()}
    tkw = {key: (_t(extra[val]) if isinstance(val, str) else val) for key, val in kw.items()}
    with pytest.raises(ValueError, match=match):
        j_flash(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), interpret=True, **jkw)
    with pytest.raises(ValueError, match=match):
        tflash.flash_attention(_t(q), _t(q), _t(q), **tkw)


def test_window_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_fwd_cuda(x, x, x, window=4)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_bwd_dkv_cuda(x, x, x, x, lse, x, window=4)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_bwd_dq_cuda(x, x, x, x, lse, x, window=4)
