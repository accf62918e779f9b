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


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tflash.flash_fwd_cuda(x, x, x)
    with pytest.raises(TypeError, match="bf16"):
        tflash.flash_fwd_cuda(x.float(), x.float(), x.float())
