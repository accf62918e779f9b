"""The port's biased flash attention against the JAX package's, on the CPU.

The same numpy inputs (from a seed) go through the JAX ``flash_attention``
with ``bias=`` or ``rel_bias_table=`` (the Pallas forward, FA2 backward,
dbias and dtable kernels in interpret mode, blocks of 8) and through the
port's, whose ``autograd.Function`` takes the plain versions for CPU
tensors.  f32 throughout.  Tolerances: forward 1e-5 (the same math in one
pass against blocks of 8); gradients, dbias and dtable included, rtol 3e-4
and atol 3e-5, as ``tests/test_flash_attention.py``'s ``TestBias`` and
``TestBucketBias`` hold the JAX kernels (sums over blocks in another
order).  The port's ``rel_pos_bucket`` must equal JAX's exactly: the
kernels' bucket ids come from it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

from torchdistx_tpu.ops.flash_attention import flash_attention as j_flash
from torchdistx_tpu.ops.flash_attention import rel_pos_bucket as j_bucket
from torchdistx_tpu_torch.ops import flash_attention as tflash

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
BUCKETS, MAX_DIST = 32, 128
# (hq, hkv, s): MHA, GQA, three tiles of 8
CASES = [(4, 4, 32), (4, 2, 16), (2, 2, 24)]
D = 16


def _inputs(hq, hkv, s, seed, buckets=BUCKETS):
    rs = np.random.RandomState(seed)
    q = rs.randn(2, s, hq, D).astype(np.float32)
    k = rs.randn(2, s, hkv, D).astype(np.float32)
    v = rs.randn(2, s, hkv, D).astype(np.float32)
    do = rs.randn(2, s, hq, D).astype(np.float32)
    bias = rs.randn(hq, s, s).astype(np.float32)
    table = (0.5 * rs.randn(hq, buckets)).astype(np.float32)
    return q, k, v, do, bias, table


def _jax_vjp(fn, args, do):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _torch_vjp(fn, args, do):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _compare(jres, tres):
    (jout, jgrads), (tout, tgrads) = jres, tres
    np.testing.assert_allclose(tout, jout, **FWD_TOL)
    for name, g, jg in zip(("dq", "dk", "dv", "dbias"), tgrads, jgrads):
        np.testing.assert_allclose(g, jg, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv,s", CASES)
def test_bias_forward_and_grads_match_jax(hq, hkv, s, causal):
    q, k, v, do, bias, _ = _inputs(hq, hkv, s, seed=s + hkv)

    def jf(q_, k_, v_, b_):
        return j_flash(q_, k_, v_, bias=b_, causal=causal, block_q=8, block_k=8,
                       interpret=True)

    def tf(q_, k_, v_, b_):
        return tflash.flash_attention(q_, k_, v_, bias=b_, causal=causal)

    before = tflash.flash_bwd_dbias_cuda.launches
    _compare(_jax_vjp(jf, (q, k, v, bias), do), _torch_vjp(tf, (q, k, v, bias), do))
    # CPU tensors take the plain versions: no kernel was launched
    assert tflash.flash_bwd_dbias_cuda.launches == before


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv,s", CASES)
def test_backward_with_delta_given_matches_jax_dbias(hq, hkv, s, causal):
    """``flash_backward`` handed the pre-pass's ``delta`` (as the backward
    hands it to the dK/dV, dQ and dbias kernels) gives the same dbias, bit
    for bit, as computing delta itself, and both hold against the Pallas
    ``_flash_dbias`` (through ``jax.vjp``, interpret mode) at the gradient
    tolerance."""
    q, k, v, do, bias, _ = _inputs(hq, hkv, s, seed=3 * s + hq)

    def jf(q_, k_, v_, b_):
        return j_flash(q_, k_, v_, bias=b_, causal=causal, block_q=8, block_k=8,
                       interpret=True)

    jdbias = _jax_vjp(jf, (q, k, v, bias), do)[1][3]
    tq, tk, tv, tdo, tb = (torch.from_numpy(x) for x in (q, k, v, do, bias))
    o, lse = tflash.flash_attention_lse_reference(tq, tk, tv, causal=causal, bias=tb)
    own = tflash.flash_backward(tq, tk, tv, o, lse, tdo, causal=causal, bias=tb)[3]
    given = tflash.flash_backward(tq, tk, tv, o, lse, tdo, causal=causal, bias=tb,
                                  delta=tflash.flash_bwd_delta(o, tdo))[3]
    assert torch.equal(own, given)
    np.testing.assert_allclose(given.numpy(), jdbias, **GRAD_TOL)


@pytest.mark.parametrize("bidir", [True, False], ids=["bidirectional", "unidirectional"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hq,hkv,s", CASES)
def test_bucket_forward_and_grads_match_jax(hq, hkv, s, causal, bidir):
    q, k, v, do, _, table = _inputs(hq, hkv, s, seed=2 * s + hq)
    kw = dict(causal=causal, rel_bias_buckets=BUCKETS, rel_bias_max_dist=MAX_DIST,
              rel_bias_bidirectional=bidir)

    def jf(q_, k_, v_, t_):
        return j_flash(q_, k_, v_, rel_bias_table=t_, block_q=8, block_k=8,
                       interpret=True, **kw)

    def tf(q_, k_, v_, t_):
        return tflash.flash_attention(q_, k_, v_, rel_bias_table=t_, **kw)

    before = tflash.flash_bwd_dtable_cuda.launches
    _compare(_jax_vjp(jf, (q, k, v, table), do), _torch_vjp(tf, (q, k, v, table), do))
    assert tflash.flash_bwd_dtable_cuda.launches == before


def test_long_distances_reach_the_far_buckets():
    """S = 256 > max_dist 128: the log-spaced and the clamped last bucket
    carry gradient too (a table gradient per bucket, vs JAX)."""
    q, k, v, do, _, table = _inputs(2, 2, 256, seed=3)
    kw = dict(causal=False, rel_bias_buckets=BUCKETS, rel_bias_max_dist=MAX_DIST,
              rel_bias_bidirectional=True)

    def jf(q_, k_, v_, t_):
        return j_flash(q_, k_, v_, rel_bias_table=t_, block_q=64, block_k=64,
                       interpret=True, **kw)

    def tf(q_, k_, v_, t_):
        return tflash.flash_attention(q_, k_, v_, rel_bias_table=t_, **kw)

    jres, tres = _jax_vjp(jf, (q, k, v, table), do), _torch_vjp(tf, (q, k, v, table), do)
    _compare(jres, tres)
    assert np.all(tres[1][3][:, [15, 31]] != 0)


@pytest.mark.parametrize("bidir", [True, False])
@pytest.mark.parametrize("buckets,max_dist", [(32, 128), (8, 20), (64, 512)])
def test_rel_pos_bucket_equals_jax_exactly(bidir, buckets, max_dist):
    rel = np.arange(-4096, 4097, dtype=np.int32)
    want = np.asarray(j_bucket(jnp.asarray(rel), bidirectional=bidir, buckets=buckets,
                               max_dist=max_dist))
    got = tflash.rel_pos_bucket(torch.from_numpy(rel), bidirectional=bidir,
                                buckets=buckets, max_dist=max_dist)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the cached ids the kernels read: distance j - i at index j - i + S - 1
    ids = tflash.rel_bucket_ids(4097, 4097, bidirectional=bidir, buckets=buckets,
                                max_dist=max_dist)
    np.testing.assert_array_equal(ids.numpy(), want)
    mat = tflash.rel_bucket_matrix(5, 7, (buckets, max_dist, bidir))
    rows, cols = np.meshgrid(np.arange(5), np.arange(7), indexing="ij")
    np.testing.assert_array_equal(mat.numpy(), want[4096 + cols - rows])


def test_lse_includes_the_bias():
    """The saved lse is the log-sum-exp of the biased logits, as the JAX
    ``emit_lse`` forward gives it."""
    from torchdistx_tpu.ops.flash_attention import _flash_forward as j_fwd

    q, k, v, _, bias, table = _inputs(4, 2, 16, seed=11)
    jout, jlse = j_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(bias),
                       causal=False, block_q=8, block_k=8, interpret=True, return_lse=True)
    out, lse = tflash.flash_attention_lse_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=False, bias=torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    cfg = (BUCKETS, MAX_DIST, False)
    jout, jlse = j_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       bias=jnp.asarray(table), causal=True, block_q=8, block_k=8,
                       interpret=True, return_lse=True, bucket_cfg=cfg)
    out, lse = tflash.flash_attention_lse_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        table=torch.from_numpy(table), bucket_cfg=cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)


def _raises_on_both(exc, match, jkw, tkw=None, q_len=None):
    q, k, v, _, bias, table = (jnp.asarray(x) for x in _inputs(4, 2, 16, seed=0))
    if q_len is not None:
        q = q[:, :q_len]
    kw = {key: (bias if val == "bias" else table if val == "table" else val)
          for key, val in jkw.items()}
    with pytest.raises(exc, match=match):
        j_flash(q, k, v, interpret=True, **kw)
    tq, tk, tv = (torch.from_numpy(np.array(x)) for x in (q, k, v))
    tkw = {key: (torch.from_numpy(np.array(val)) if isinstance(val, jax.Array) else val)
           for key, val in (kw if tkw is None else tkw).items()}
    with pytest.raises(exc, match=match):
        tflash.flash_attention(tq, tk, tv, **tkw)


@pytest.mark.parametrize("jkw,match,q_len", [
    (dict(bias="bias", rel_bias_table="table"), "not both", None),
    (dict(rel_bias_table="table", causal=True), "Sq == Skv", 8),
    (dict(rel_bias_table="table", rel_bias_buckets=16), "table shape", None),
    (dict(bias="bias", causal=True), "bias shape", 8),
    (dict(window=4, causal=False), "window requires causal", None),
    (dict(window=0), "window must be", None),
    (dict(window=4, bias="bias"), "mutually exclusive", None),
], ids=["bias-and-table", "bucket-cross", "table-shape", "bias-shape", "window-causal",
        "window-zero", "window-bias"])
def test_argument_checks_raise_where_jax_raises(jkw, match, q_len):
    _raises_on_both(ValueError, match, jkw, q_len=q_len)


def test_window_is_not_ported():
    """The name dates from when ``window=`` raised.  The window is ported
    now (``tests/test_torch_flash_window.py`` holds it against the JAX
    kernels): on the CPU the windowed call is the windowed plain
    attention."""
    from torchdistx_tpu_torch.ops.attention import multihead_attention

    q = torch.from_numpy(np.random.RandomState(0).randn(1, 8, 2, 16).astype(np.float32))
    out = tflash.flash_attention(q, q, q, window=4)
    torch.testing.assert_close(out, multihead_attention(q, q, q, window=4), **FWD_TOL)


def test_bias_gradient_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_bwd_dbias_cuda(x, x, x, x, lse, x, torch.zeros(2, 8, 8))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_bwd_dtable_cuda(x, x, x, x, lse, x, torch.zeros(2, 32), (32, 128, True))
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_fwd_cuda(x, x, x, bias=torch.zeros(2, 8, 8, dtype=torch.bfloat16))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("mode", ["bias", "table"])
def test_bias_grad_reference_is_the_backward_bias_gradient(mode, causal):
    """The plain version of the dbias / dtable kernels alone equals the
    bias gradient of the whole plain backward, bit for bit."""
    q, k, v, do, bias, table = (torch.from_numpy(x) for x in _inputs(4, 2, 16, seed=12))
    kw = dict(causal=causal, scale=1.0)
    if mode == "bias":
        kw["bias"] = bias
    else:
        kw.update(table=table, bucket_cfg=(BUCKETS, MAX_DIST, not causal))
    o, lse = tflash.flash_attention_lse_reference(q, k, v, **kw)
    want = tflash.flash_bwd_reference(q, k, v, o, lse, do, **kw)[3]
    assert torch.equal(tflash.flash_bias_grad_reference(q, k, v, o, lse, do, **kw), want)
    with pytest.raises(ValueError, match="one of bias and table"):
        tflash.flash_bias_grad_reference(q, k, v, o, lse, do, causal=causal)
