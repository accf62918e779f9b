"""The port's fused LM-head cross-entropy against the JAX package's, on the
CPU.

The same numpy inputs (from a seed) go through the JAX
``fused_linear_cross_entropy`` (its Pallas kernels in interpret mode) and
the port's (its ``autograd.Function`` with the plain forward, dX and dW),
for the cases of ``tests/test_fused_ce.py``.  Tolerances: f32 1e-5 (the
same f32 math, summed in another order); bf16 2e-2 (both upcast the bf16
inputs and compute in f32, then round dX/dW to bf16, at other places);
gradients are compared scaled by the JAX gradient's max, as the JAX test
does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

from torchdistx_tpu.ops.fused_ce import fused_linear_cross_entropy as jfused
import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch.models import GPT2, Llama
from torchdistx_tpu_torch.nn import functional as tF
from torchdistx_tpu_torch.ops import fused_ce as tfc

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _mk(n, d, v, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, d).astype(np.float32)
    w = (0.1 * rs.randn(v, d)).astype(np.float32)
    y = rs.randint(0, v, n).astype(np.int32)
    return x, w, y


def _jax(x, w, y, jdt, scale=1.0, **kw):
    xj, wj, yj = jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(y)

    def f(a, b):
        return scale * jfused(a, b, yj, **kw)

    loss, (gx, gw) = jax.value_and_grad(f, argnums=(0, 1))(xj, wj)
    return (float(loss / scale), np.asarray(gx, np.float32), np.asarray(gw, np.float32))


def _port(x, w, y, tdt, scale=1.0):
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    loss = tfc.fused_linear_cross_entropy(xt, wt, torch.from_numpy(y).long())
    assert loss.dtype == torch.float32 and loss.dim() == 0
    (scale * loss).backward()
    assert xt.grad.dtype == tdt and wt.grad.dtype == tdt
    return float(loss.detach()), xt.grad.float().numpy(), wt.grad.float().numpy()


def _assert_match(port, ref, tol):
    np.testing.assert_allclose(port[0], ref[0], rtol=tol, atol=tol)
    for a, b in zip(port[1:], ref[1:]):
        assert a.shape == b.shape
        scale = np.max(np.abs(b)) + 1e-8
        np.testing.assert_allclose(a / scale, b / scale, atol=tol)


@pytest.mark.parametrize("n,d,v,dt", [
    (256, 128, 512, "f32"),
    (256, 128, 512, "bf16"),
    (384, 64, 1000, "f32"),
    (64, 256, 2048, "bf16"),
])
def test_loss_and_grads_match_jax(n, d, v, dt):
    jdt, tdt, tol = DTYPES[dt]
    x, w, y = _mk(n, d, v, seed=n + d)
    _assert_match(_port(x, w, y, tdt), _jax(x, w, y, jdt), tol)


@pytest.mark.parametrize("n,d,v,labels", [
    (64, 32, 50257, [0, 50256, 50255]),  # GPT-2's vocab: no tile divisor
    (509, 32, 512, []),                  # prime token count
    (3, 32, 512, []),                    # fewer tokens than any tile
])
def test_ragged_shapes_match_jax(n, d, v, labels):
    x, w, y = _mk(n, d, v, seed=n)
    y[: len(labels)] = labels
    _assert_match(_port(x, w, y, torch.float32), _jax(x, w, y, jnp.float32), 1e-5)


def test_labels_at_tile_edges():
    x, w, _ = _mk(8, 32, 512, seed=2)
    y = np.asarray([0, 1, 127, 128, 255, 256, 510, 511], np.int32)
    _assert_match(_port(x, w, y, torch.float32),
                  _jax(x, w, y, jnp.float32, block_v=128), 1e-5)


def test_leading_dims_flattened():
    x, w, y = _mk(128, 64, 256, seed=1)
    x3, y3 = x.reshape(4, 32, 64), y.reshape(4, 32)
    flat = tfc.fused_linear_cross_entropy(torch.from_numpy(x), torch.from_numpy(w),
                                          torch.from_numpy(y))
    xt = torch.from_numpy(x3).requires_grad_()
    three = tfc.fused_linear_cross_entropy(xt, torch.from_numpy(w), torch.from_numpy(y3))
    three.backward()
    assert xt.grad.shape == (4, 32, 64)
    np.testing.assert_allclose(float(three.detach()), float(flat), rtol=1e-6)
    ref = float(jfused(jnp.asarray(x3), jnp.asarray(w), jnp.asarray(y3)))
    np.testing.assert_allclose(float(three.detach()), ref, rtol=1e-5)


def test_cotangent_scaling():
    x, w, y = _mk(64, 32, 128, seed=3)
    two = _port(x, w, y, torch.float32, scale=2.0)
    one = _port(x, w, y, torch.float32)
    np.testing.assert_allclose(two[1], 2.0 * one[1], rtol=1e-5)
    np.testing.assert_allclose(two[2], 2.0 * one[2], rtol=1e-5)
    _assert_match(two, _jax(x, w, y, jnp.float32, scale=2.0), 1e-5)


def test_shape_validation():
    x, w, y = (torch.from_numpy(a) for a in _mk(64, 32, 128))
    with pytest.raises(ValueError, match="w must be"):
        tfc.fused_linear_cross_entropy(x, w.T, y)
    with pytest.raises(ValueError, match="labels"):
        tfc.fused_linear_cross_entropy(x, w, y[:-1])


def test_plain_pieces_match_the_unfused_reference():
    """The plain forward and backward (the kernels' CPU stand-ins; the
    backward in one chunk and in 128-column chunks) against autograd of
    ``fused_linear_cross_entropy_reference``, with a cotangent of 3 (f32,
    1e-5)."""
    x, w, y = (torch.from_numpy(a) for a in _mk(96, 48, 300, seed=4))
    g = torch.tensor([3.0])
    loss_rows, lse = tfc.fused_ce_fwd_reference(x, w, y)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref = tfc.fused_linear_cross_entropy_reference(xr, wr, y)
    (3.0 * ref).backward()
    torch.testing.assert_close(loss_rows.mean(), ref.detach(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, torch.logsumexp(x @ w.T, -1), atol=1e-5, rtol=1e-5)
    for chunk in (None, 128):
        dx, dw = tfc.fused_ce_bwd_reference(x, w, y, lse, g, chunk=chunk)
        torch.testing.assert_close(dx, xr.grad, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dw, wr.grad, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n,d,v,chunk", [
    (37, 32, 300, 128),   # 3 chunks, the last of 44 columns
    (129, 16, 700, 256),  # 3 chunks, the last of 188
    (3, 32, 129, 128),    # fewer tokens than any tile; a last chunk of one column
])
def test_chunked_backward_matches_jax(n, d, v, chunk):
    """``fused_ce_bwd_reference``, the backward kernel's algorithm (per
    vocab chunk, in order: dP, dW of the chunk, dX += dP W) with chunks
    smaller than V, against ``jax.vjp`` of the JAX fused loss (its Pallas
    kernels in interpret mode): an odd N, V not a multiple of the chunk,
    labels on the chunk edges, cotangent 2.5.  f32 within 1e-5 of each
    gradient's max: the chunks only reorder the f32 sums."""
    x, w, y = _mk(n, d, v, seed=v + chunk)
    edges = [e for e in (0, chunk - 1, chunk, 2 * chunk - 1, 2 * chunk, v - 1) if e < v]
    y[: min(n, len(edges))] = edges[:n]
    xj, wj, yj = jnp.asarray(x), jnp.asarray(w), jnp.asarray(y)
    loss, vjp = jax.vjp(lambda a, b: jfused(a, b, yj), xj, wj)
    gx, gw = (np.asarray(t) for t in vjp(jnp.float32(2.5)))
    xt, wt, yt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y)
    _, lse = tfc.fused_ce_fwd_reference(xt, wt, yt)
    dx, dw = tfc.fused_ce_bwd_reference(xt, wt, yt, lse, torch.tensor(2.5), chunk=chunk)
    assert tfc.bwd_chunk(n, v) >= v  # a real run of this size takes one chunk
    _assert_match((float(loss), dx.numpy(), dw.numpy()), (float(loss), gx, gw), 1e-5)


def test_bwd_chunk_keeps_the_panel_in_its_budget():
    """The backward's vocab chunks: whole 256-column tiles, as few as keep
    the bf16 (N, chunk) dP panel within ``PANEL_BYTES``, covering V; four
    at GPT-2-large's loss shape, one at llama_1b's."""
    for n, v in [(8192, 50257), (4096, 32000), (509, 50257), (3, 32000), (65536, 128256)]:
        chunk = tfc.bwd_chunk(n, v)
        chunks = -(-v // chunk)
        assert chunk % 256 == 0 and 2 * n * chunk <= tfc.PANEL_BYTES + 2 * n * 256
        assert chunks == -(-(2 * n * v) // tfc.PANEL_BYTES)
    assert tfc.bwd_chunk(8192, 50257) == 12800 and tfc.bwd_chunk(4096, 32000) == 32000


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_model_hidden_path_matches_logits(family):
    """``return_hidden`` + the fused loss on the model's head equals
    ``cross_entropy`` of the model's logits (f32, 1e-5), in value and in
    every parameter's gradient; GPT-2's tied ``tok_emb.weight`` takes the
    head's dW and the embedding gather's gradient in one sum."""
    tt.manual_seed(0)
    if family == "gpt2":
        m = GPT2.from_name("tiny", device="cpu")
        head = lambda: m.tok_emb.weight  # noqa: E731
    else:
        m = Llama.from_name("tiny", device="cpu")
        head = lambda: m.lm_head.weight  # noqa: E731
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 32)))
    labels = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 32)))
    fused = tfc.fused_linear_cross_entropy(m(toks, return_hidden=True), head(), labels)
    fused.backward()
    g_fused = {k: p.grad.clone() for k, p in m.named_parameters()}
    m.zero_grad()
    ref = tF.cross_entropy(m(toks), labels)
    ref.backward()
    torch.testing.assert_close(fused, ref, atol=1e-5, rtol=1e-5)
    for k, p in m.named_parameters():
        torch.testing.assert_close(g_fused[k], p.grad, atol=1e-5, rtol=1e-5)
