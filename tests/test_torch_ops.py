"""The port's attention ops against the JAX package's, on the CPU.

The same numpy inputs (from a seed) go through the JAX function — the
Pallas kernels in interpret mode, or the jnp path — and through the port,
whose kernel wrappers take their plain PyTorch version for CPU tensors.
f32 throughout; tolerance atol = rtol = 2e-5: the same math with sums taken
in another order (online softmax vs one-shot softmax, blocked vs batched
contractions), a few f32 ulps on outputs of O(1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

from torchdistx_tpu.ops import attention as jattn
from torchdistx_tpu.ops.decode_attention import decode_attention as j_decode
from torchdistx_tpu.ops.flash_attention import flash_attention as j_flash
from torchdistx_tpu_torch.ops import attention as tattn
from torchdistx_tpu_torch.ops import decode_attention as tdec
from torchdistx_tpu_torch.ops import flash_attention as tflash

TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize(
    "b,s,hq,hkv,d", [(1, 32, 4, 4, 16), (2, 48, 4, 2, 32), (1, 64, 8, 2, 16)]
)
def test_flash_plain_matches_jax_flash_interpret(b, s, hq, hkv, d):
    rs = np.random.RandomState(s + hq)
    q, k, v = _rand(rs, b, s, hq, d), _rand(rs, b, s, hkv, d), _rand(rs, b, s, hkv, d)
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, block_q=16, block_k=16, interpret=True))
    out = tflash.flash_attention(_t(q), _t(k), _t(v), causal=True).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("sq,skv,hq,hkv,d", [(37, 37, 4, 2, 16), (13, 13, 8, 2, 32),
                                             (5, 13, 4, 1, 16)])
def test_flash_plain_matches_jax_multihead(sq, skv, hq, hkv, d):
    rs = np.random.RandomState(sq * skv)
    q, k, v = _rand(rs, 2, sq, hq, d), _rand(rs, 2, skv, hkv, d), _rand(rs, 2, skv, hkv, d)
    ref = np.asarray(jattn.multihead_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    out = tflash.flash_attention_reference(_t(q), _t(k), _t(v), causal=True).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("d", [16, 32])
def test_decode_plain_matches_jax(hq, hkv, d):
    rs = np.random.RandomState(hq * 10 + hkv + d)
    b, max_len = 3, 40
    q = _rand(rs, b, 1, hq, d)
    ck, cv = _rand(rs, b, max_len, hkv, d), _rand(rs, b, max_len, hkv, d)
    pos = np.array([0, max_len - 1, 17], np.int32)
    jargs = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos))
    # block_k=8: five K blocks, so the kernel's online-softmax merge runs
    ref_kernel = np.asarray(j_decode(*jargs, block_k=8, interpret=True))
    ref_jnp = np.asarray(jattn._slot_attend(*jargs, None, None))
    out = tdec.decode_attention(_t(q), _t(ck), _t(cv), _t(pos)).numpy()
    np.testing.assert_allclose(out, ref_kernel, **TOL)
    np.testing.assert_allclose(out, ref_jnp, **TOL)


@pytest.mark.parametrize("use_flash", [None, True])
def test_cached_attention_prefill_then_decode(use_flash):
    """Prefill at the int 0 (the flash route when use_flash=True), then a
    decode step at position 9 (the plain band), caches included."""
    rs = np.random.RandomState(5)
    b, s, hq, hkv, d, max_seq = 2, 9, 4, 2, 16, 24
    q, k, v = _rand(rs, b, s, hq, d), _rand(rs, b, s, hkv, d), _rand(rs, b, s, hkv, d)
    jc = (jnp.zeros((b, max_seq, hkv, d)), jnp.zeros((b, max_seq, hkv, d)))
    jout, jc = jattn.cached_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jc, 0, use_flash=use_flash)
    tc = (torch.zeros(b, max_seq, hkv, d), torch.zeros(b, max_seq, hkv, d))
    tout, tc = tattn.cached_attention(_t(q), _t(k), _t(v), tc, 0, use_flash=use_flash)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for a, bb in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(bb))
    q1, k1, v1 = _rand(rs, b, 1, hq, d), _rand(rs, b, 1, hkv, d), _rand(rs, b, 1, hkv, d)
    jout, jc = jattn.cached_attention(jnp.asarray(q1), jnp.asarray(k1), jnp.asarray(v1),
                                      jc, s, use_flash=use_flash)
    tout, tc = tattn.cached_attention(_t(q1), _t(k1), _t(v1), tc, s, use_flash=use_flash)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for a, bb in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(bb))


def test_cached_attention_bias_keeps_prefill_off_flash():
    """A bias sends even the from-empty prefill to the plain band, on both
    sides: with use_flash=True the flash route would drop the bias."""
    rs = np.random.RandomState(9)
    b, s, h, d, max_seq = 1, 6, 2, 16, 10
    q, k, v = _rand(rs, b, s, h, d), _rand(rs, b, s, h, d), _rand(rs, b, s, h, d)
    bias = _rand(rs, h, s, max_seq)
    jout, _ = jattn.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        (jnp.zeros((b, max_seq, h, d)), jnp.zeros((b, max_seq, h, d))), 0,
        bias=jnp.asarray(bias), use_flash=True)
    tout, _ = tattn.cached_attention(
        _t(q), _t(k), _t(v), (torch.zeros(b, max_seq, h, d), torch.zeros(b, max_seq, h, d)),
        0, bias=_t(bias), use_flash=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_cached_attention_windowed_decode_matches_jax():
    rs = np.random.RandomState(6)
    b, hq, hkv, d, max_seq = 2, 4, 2, 16, 24
    ck, cv = _rand(rs, b, max_seq, hkv, d), _rand(rs, b, max_seq, hkv, d)
    q, k, v = _rand(rs, b, 1, hq, d), _rand(rs, b, 1, hkv, d), _rand(rs, b, 1, hkv, d)
    jout, _ = jattn.cached_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     (jnp.asarray(ck), jnp.asarray(cv)), 11, window=5)
    tout, _ = tattn.cached_attention(_t(q), _t(k), _t(v), (_t(ck), _t(cv)), 11, window=5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("use_flash", [None, True])
def test_slot_cached_attention_matches_jax(use_flash):
    rs = np.random.RandomState(7)
    b, hq, hkv, d, max_seq = 3, 8, 2, 16, 32
    ck, cv = _rand(rs, b, max_seq, hkv, d), _rand(rs, b, max_seq, hkv, d)
    q, k, v = _rand(rs, b, 1, hq, d), _rand(rs, b, 1, hkv, d), _rand(rs, b, 1, hkv, d)
    pos = np.array([0, 31, 12], np.int32)
    jout, jc = jattn.slot_cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        (jnp.asarray(ck), jnp.asarray(cv)), jnp.asarray(pos), use_flash=use_flash)
    tout, tc = tattn.slot_cached_attention(
        _t(q), _t(k), _t(v), (_t(ck), _t(cv)), _t(pos), use_flash=use_flash)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    for a, bb in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(bb))


def test_cpu_wrappers_leave_launch_counters_at_zero():
    tflash.flash_fwd_cuda.launches = 0
    tdec.decode_attention_cuda.launches = 0
    rs = np.random.RandomState(8)
    q, k = _t(_rand(rs, 1, 8, 2, 16)), _t(_rand(rs, 1, 8, 2, 16))
    tflash.flash_attention(q, k, k)
    tdec.decode_attention(q[:, :1], k, k, torch.tensor([3]))
    assert tflash.flash_fwd_cuda.launches == 0
    assert tdec.decode_attention_cuda.launches == 0


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back: given CPU tensors they raise."""
    x = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_fwd_cuda(x, x, x)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tdec.decode_attention_cuda(x[:, :1], x, x, torch.zeros(1, dtype=torch.int32))


def test_resolve_use_flash():
    assert tflash.resolve_use_flash(None, "cuda") is True
    assert tflash.resolve_use_flash(None, "cpu") is False
    assert tflash.resolve_use_flash(False, "cuda") is False
    assert tflash.resolve_use_flash(True, "cpu") is True


def test_unported_slot_variants_raise():
    x = torch.zeros(2, 1, 2, 8)
    cache = (torch.zeros(2, 4, 2, 8), torch.zeros(2, 4, 2, 8))
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="paged"):
        tattn.slot_cached_attention(x, x, x, cache, pos, page_tables=pos[:, None])
    with pytest.raises(NotImplementedError, match="quantized"):
        tattn.slot_cached_attention(x, x, x, cache + cache, pos)
    x2 = torch.zeros(2, 2, 2, 8)
    with pytest.raises(NotImplementedError, match="multi-token"):
        tattn.slot_cached_attention(x2, x2, x2, cache, pos)
