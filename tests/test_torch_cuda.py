"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: without an NVIDIA GPU every test here skips.  On a
machine with one, run them with

    python -m pytest tests/test_torch_cuda.py -m cuda

Tolerance atol = rtol = 2e-2 in bf16 (outputs of O(1)): bf16 rounding of
the output and of the probabilities, which the kernels and the plain
versions round at different places (``chip_smoke.py`` states the same).
"""

import pytest
import torch

from torchdistx_tpu_torch.ops import decode_attention as tdec
from torchdistx_tpu_torch.ops import flash_attention as tflash
from torchdistx_tpu_torch.ops import fused_ce as tfc

pytestmark = pytest.mark.cuda
TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(g, shape, dev):
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("b,s,hq,hkv,d", [(1, 37, 8, 2, 128), (2, 130, 4, 4, 64),
                                          (1, 16, 32, 8, 128)])
def test_flash_kernel_matches_plain(cuda, b, s, hq, hkv, d):
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (_rand(g, (b, s, h, d), cuda) for h in (hq, hkv, hkv))
    before = tflash.flash_fwd_cuda.launches
    out = tflash.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tflash.flash_fwd_cuda.launches == before + 1
    torch.testing.assert_close(out, tflash.flash_attention_reference(q, k, v), **TOL)


@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (8, 8, 64), (16, 2, 128)])
def test_decode_kernel_matches_plain(cuda, hq, hkv, d):
    g = torch.Generator(device=cuda).manual_seed(hq + d)
    b, max_len = 4, 300
    q = _rand(g, (b, 1, hq, d), cuda)
    ck, cv = _rand(g, (b, max_len, hkv, d), cuda), _rand(g, (b, max_len, hkv, d), cuda)
    pos = torch.tensor([0, 299, 128, 17], dtype=torch.int32, device=cuda)
    before = tdec.decode_attention_cuda.launches
    out = tdec.decode_attention(q, ck, cv, pos)
    torch.cuda.synchronize()
    assert tdec.decode_attention_cuda.launches == before + 1
    torch.testing.assert_close(out, tdec.decode_attention_reference(q, ck, cv, pos), **TOL)


@pytest.mark.parametrize("b,s,hq,hkv,d", [(1, 37, 4, 4, 128), (2, 130, 8, 2, 64),
                                          (1, 200, 16, 16, 128)])
def test_flash_bwd_kernels_match_plain(cuda, b, s, hq, hkv, d):
    """The lse forward and both backward kernels against the plain f32
    versions from the same saved o and lse (lse to 1e-3: f32 sums of the
    same products in another order)."""
    g = torch.Generator(device=cuda).manual_seed(s + hq)
    q, k, v, do = (_rand(g, (b, s, h, d), cuda) for h in (hq, hkv, hkv, hq))
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True)
    dk, dv = tflash.flash_bwd_dkv_cuda(q, k, v, o, lse, do)
    dq = tflash.flash_bwd_dq_cuda(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    _, lse_ref = tflash.flash_attention_lse_reference(q, k, v)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    for out, ref in zip((dq, dk, dv), tflash.flash_bwd_reference(q, k, v, o, lse, do)):
        torch.testing.assert_close(out, ref, **TOL)


def test_training_forward_goes_through_the_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (_rand(g, (1, 64, 4, 64), cuda).requires_grad_() for _ in range(3))
    counts = (tflash.flash_fwd_cuda.lse_launches, tflash.flash_bwd_dkv_cuda.launches,
              tflash.flash_bwd_dq_cuda.launches)
    tflash.flash_attention(q, k, v).float().sum().backward()
    torch.cuda.synchronize()
    after = (tflash.flash_fwd_cuda.lse_launches, tflash.flash_bwd_dkv_cuda.launches,
             tflash.flash_bwd_dq_cuda.launches)
    assert after == tuple(c + 1 for c in counts)
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_fwd_cuda(x, x, x)
    with pytest.raises(TypeError, match="bf16"):
        tflash.flash_fwd_cuda(x.float(), x.float(), x.float())
    y = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="causal"):
        tflash.flash_bwd_dq_cuda(y, y, y, y, lse, y, causal=False)
    with pytest.raises(ValueError, match="Sq == Skv"):
        tflash.flash_bwd_dkv_cuda(y, y[:, :4], y[:, :4], y, lse, y)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_bwd_dkv_cuda(y.cpu(), y, y, y, lse, y)


def _ce_inputs(cuda, n, d, v, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = _rand(g, (n, d), cuda)
    w = (torch.randn((v, d), generator=g, device=cuda) * 0.1).to(torch.bfloat16)
    labels = torch.randint(0, v, (n,), generator=g, device=cuda)
    labels[:3] = torch.tensor([v - 1, 0, v - 2], device=cuda)
    return x, w, labels


def _scaled(out, ref):
    return float((out.float() - ref.float()).abs().max() / ref.float().abs().max())


@pytest.mark.parametrize("d", [64, 128])
def test_fused_ce_kernels_match_plain(cuda, d):
    """N 509 (prime), V 1000 (no tile divisor): loss to 1e-3 relative, lse
    to 1e-3 absolute, dX and dW (bf16 dP, cotangent 2) within 2e-2 of their
    max, as ``chip_smoke.py`` holds them."""
    x, w, labels = _ce_inputs(cuda, 509, d, 1000, d)
    g2 = torch.full((1,), 2.0, device=cuda)
    before = [f.launches for f in (tfc.fused_ce_fwd_cuda, tfc.fused_ce_dx_cuda,
                                   tfc.fused_ce_dw_cuda)]
    loss, lse = tfc.fused_ce_fwd_cuda(x, w, labels)
    dx = tfc.fused_ce_dx_cuda(x, w, labels, lse, g2)
    dw = tfc.fused_ce_dw_cuda(x, w, labels, lse, g2)
    torch.cuda.synchronize()
    after = [f.launches for f in (tfc.fused_ce_fwd_cuda, tfc.fused_ce_dx_cuda,
                                  tfc.fused_ce_dw_cuda)]
    assert after == [b + 1 for b in before]
    r_loss, r_lse = tfc.fused_ce_fwd_reference(x, w, labels)
    torch.testing.assert_close(lse, r_lse, atol=1e-3, rtol=0)
    torch.testing.assert_close(loss.mean(), r_loss.mean(), atol=0, rtol=1e-3)
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert _scaled(dx, tfc.fused_ce_dx_reference(x, w, labels, r_lse, g2)) <= 2e-2
    assert _scaled(dw, tfc.fused_ce_dw_reference(x, w, labels, r_lse, g2)) <= 2e-2


def test_fused_loss_autograd_goes_through_the_kernels(cuda):
    x, w, labels = _ce_inputs(cuda, 64, 64, 300, 1)
    x.requires_grad_()
    w.requires_grad_()
    counts = [f.launches for f in (tfc.fused_ce_fwd_cuda, tfc.fused_ce_dx_cuda,
                                   tfc.fused_ce_dw_cuda)]
    tfc.fused_linear_cross_entropy(x.view(4, 16, 64), w, labels.view(4, 16)).backward()
    torch.cuda.synchronize()
    assert [f.launches for f in (tfc.fused_ce_fwd_cuda, tfc.fused_ce_dx_cuda,
                                 tfc.fused_ce_dw_cuda)] == [c + 1 for c in counts]
    assert x.grad.shape == (64, 64) and w.grad.shape == (300, 64)
    assert torch.isfinite(x.grad.float()).all() and torch.isfinite(w.grad.float()).all()


def test_fused_ce_kernels_refuse_what_they_do_not_take(cuda):
    """A CUDA f32 or mis-shaped input raises; no plain fallback runs."""
    x, w, labels = _ce_inputs(cuda, 16, 64, 100, 2)
    lse = torch.zeros(16, device=cuda)
    one = torch.ones(1, device=cuda)
    counts = [f.launches for f in (tfc.fused_ce_fwd_cuda, tfc.fused_ce_dx_cuda,
                                   tfc.fused_ce_dw_cuda)]
    with pytest.raises(TypeError, match="bf16"):
        tfc.fused_ce_fwd_cuda(x.float(), w.float(), labels)
    with pytest.raises(TypeError, match="bf16"):
        tfc.fused_linear_cross_entropy(x.float(), w.float(), labels)
    with pytest.raises(ValueError, match=r"\(V, D\)"):
        tfc.fused_ce_dx_cuda(x, w[:, :32], labels, lse, one)
    with pytest.raises(ValueError, match="D % 8"):
        tfc.fused_ce_dw_cuda(x[:, :60], w[:, :60], labels, lse, one)
    with pytest.raises(ValueError, match="labels"):
        tfc.fused_ce_fwd_cuda(x, w, labels[:-1])
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tfc.fused_ce_dw_cuda(x, w, labels, lse.cpu(), one)
    assert [f.launches for f in (tfc.fused_ce_fwd_cuda, tfc.fused_ce_dx_cuda,
                                 tfc.fused_ce_dw_cuda)] == counts
