"""The host side of the port's Hopper flash kernels, on the CPU.

- ``flash_bwd_delta_reference``, the plain version of the dK/dV kernel's
  delta pre-pass, against ``rowsum(dO * O)`` taken in float64 by numpy
  from the same numpy inputs: f32 sums of D products of bf16 values, so
  within 1e-5 of values of O(1).
- ``_tma_strides``, the check the TMA kernels' wrappers run before a
  launch: a contiguous tensor and the strided slices of a packed
  projection (GPT-2's q, k, v) pass with their strides; a misaligned base,
  a non-contiguous last dimension or a stride that is not a multiple of 16
  bytes raise, with no copy.  The stride of a dimension of size 1 is
  reported as the packed one (TMA never reads it).
"""

import numpy as np
import pytest
import torch

from torchdistx_tpu_torch.ops import flash_attention as tflash


@pytest.mark.parametrize("b,s,h,d", [(1, 1, 1, 64), (2, 37, 4, 64), (1, 129, 8, 128),
                                     (3, 300, 2, 128)])
def test_delta_plain_version_is_rowsum_in_float64(b, s, h, d):
    rs = np.random.RandomState(s + d)
    o = rs.randn(b, s, h, d).astype(np.float32)
    do = rs.randn(b, s, h, d).astype(np.float32)
    ot, dot = (torch.from_numpy(x).to(torch.bfloat16) for x in (o, do))
    got = tflash.flash_bwd_delta_reference(ot, dot)
    want = (dot.double().numpy() * ot.double().numpy()).sum(-1).transpose(0, 2, 1)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, s)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_delta_plain_version_feeds_the_plain_backward():
    """``flash_bwd_reference`` takes its delta from the same function."""
    rs = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rs.randn(1, 20, 2, 16).astype(np.float32))
                   for _ in range(4))
    o, lse = tflash.flash_attention_lse_reference(q, k, v)
    dq, dk, dv = tflash.flash_bwd_reference(q, k, v, o, lse, do)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
                      + torch.full((20, 20), float("-inf")).triu(1), -1)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - tflash.flash_bwd_delta_reference(o, do)[..., None]) / 4.0
    torch.testing.assert_close(dk, torch.einsum("bhqk,bqhd->bkhd", ds, q),
                               atol=1e-5, rtol=1e-5)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("shape", [(2, 300, 4, 64), (1, 8, 32, 128), (3, 1, 1, 128)])
def test_tma_strides_of_a_packed_tensor(shape):
    b, s, h, d = shape
    sb, ss, sh = tflash._tma_strides("f", "q", _bf16(*shape))
    assert (sh, ss, sb) == (d, h * d, s * h * d)


def test_tma_strides_of_gpt2_slices():
    qkv = _bf16(2, 300, 3, 20, 64)
    for i in range(3):
        assert tflash._tma_strides("f", "q", qkv[:, :, i]) == (300 * 3 * 20 * 64,
                                                              3 * 20 * 64, 64)


def test_tma_strides_of_size_one_dimensions_are_the_packed_ones():
    x = _bf16(1, 16, 1, 64).expand(1, 16, 1, 64)
    wide = _bf16(16, 4, 64)[:, :1].unsqueeze(0)  # (1, 16, 1, 64), head stride 64
    assert tflash._tma_strides("f", "q", x) == (16 * 64, 64, 64)
    assert tflash._tma_strides("f", "q", wide) == (16 * 4 * 64, 4 * 64, 64)


@pytest.mark.parametrize("bad", ["misaligned", "last_dim", "head_stride", "seq_stride"])
def test_tma_strides_refuse(bad):
    if bad == "misaligned":
        t = _bf16(1 + 2 * 8 * 64)[1:].view(1, 8, 2, 64)
    elif bad == "last_dim":
        t = _bf16(1, 8, 64, 2).transpose(2, 3)
    elif bad == "head_stride":
        t = _bf16(1, 8, 2, 68)[..., :64]
    else:
        t = _bf16(1, 8, 1, 68)[..., :64]
    with pytest.raises(ValueError, match="TMA"):
        tflash._tma_strides("flash_fwd_cuda", "q", t)
