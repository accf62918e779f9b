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

import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch.ops import decode_attention as tdec
from torchdistx_tpu_torch.ops import flash_attention as tflash
from torchdistx_tpu_torch.ops import fused_ce as tfc
from torchdistx_tpu_torch.models import T5

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
    with pytest.raises(ValueError, match="bias shape"):
        tflash.flash_bwd_dq_cuda(y, y, y, y, lse, y, causal=False,
                                 bias=torch.zeros(2, 8, 4, dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError, match="Sq == Skv"):
        tflash.flash_bwd_dkv_cuda(y, y[:, :4], y[:, :4], y, lse, y)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tflash.flash_bwd_dkv_cuda(y.cpu(), y, y, y, lse, y)



def _scaled_err(out, ref):
    ref = ref.float()
    return float((out.float() - ref).abs().max() / (ref.abs().max() + 1e-30))


@pytest.mark.parametrize("scale", [None, 1.0], ids=["default-scale", "t5-scale"])
@pytest.mark.parametrize("mode", ["bias", "bucket"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("b,s,hq,hkv,d", [(2, 114, 4, 4, 128), (1, 200, 8, 2, 64)])
def test_biased_kernels_match_plain(cuda, mode, causal, b, s, hq, hkv, d, scale):
    """The bias and bucket variants of the forward (plain and lse) and of
    both backward kernels, and the dbias / dtable kernels, against the plain
    versions from the same saved o and lse; dbias and dtable scaled by
    their max within 2e-2 (bf16 outputs of f32 sums taken in another order
    than the plain versions').  At the default scale 1/sqrt(D) and at T5's 1.0, whose
    q carries the 1/sqrt(D) instead (as T5's initialization folds it in)."""
    g = torch.Generator(device=cuda).manual_seed(s + hq)
    q, k, v, do = (_rand(g, (b, s, h, d), cuda) for h in (hq, hkv, hkv, hq))
    if scale is not None:
        q = (q.float() * d ** -0.5).to(torch.bfloat16)
    cfg = (32, 128, not causal)
    table = _rand(g, (hq, 32), cuda)
    kw = dict(causal=causal, scale=scale, bucket_cfg=cfg)
    if mode == "bias":
        kw["bias"] = table[:, tflash.rel_bucket_matrix(s, s, cfg, cuda)].contiguous()
    else:
        kw["table"] = table
    out = tflash.flash_fwd_cuda(q, k, v, **kw)
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True, **kw)
    dk, dv = tflash.flash_bwd_dkv_cuda(q, k, v, o, lse, do, **kw)
    dq = tflash.flash_bwd_dq_cuda(q, k, v, o, lse, do, **kw)
    if mode == "bias":
        dbias = tflash.flash_bwd_dbias_cuda(q, k, v, o, lse, do, kw["bias"], causal=causal,
                                            scale=scale)
    else:
        dbias = tflash.flash_bwd_dtable_cuda(q, k, v, o, lse, do, table, cfg, causal=causal,
                                             scale=scale)
    torch.cuda.synchronize()
    ref_o, ref_lse = tflash.flash_attention_lse_reference(q, k, v, **kw)
    torch.testing.assert_close(out, ref_o, **TOL)
    torch.testing.assert_close(o, ref_o, **TOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0)
    ref = list(tflash.flash_bwd_reference(q, k, v, o, lse, do, **kw))
    if scale is not None:
        # dq of the folded q is sqrt(D) times the gradient of the q before
        # the fold: held as the latter, the quantity the default scale holds
        dq, ref[0] = (x.float() * d ** -0.5 for x in (dq, ref[0]))
    for got, want in zip((dq, dk, dv), ref[:3]):
        torch.testing.assert_close(got, want, **TOL)
    assert _scaled_err(dbias, ref[3]) <= 2e-2


@pytest.mark.parametrize("bucket", [False, True], ids=["bias", "bucket"])
def test_t5_training_goes_through_the_kernels(cuda, bucket):
    """One backward step of a 2-layer T5 (head_dim 64) on the card: every
    self-attention forward and backward, and the bias gradient, through
    the kernels; the gradients finite, and the norm of their distance from
    the f32 plain path's gradients within twice the bf16 plain path's
    (``chip_smoke.py``'s ``LOGITS_FACTOR``: both share every bf16
    projection, only the attention arithmetic differs; a norm, since a max
    over so small a model is one bf16 rounding): over all parameters, over
    the self-attention projections alone, and over the ``rel_bias`` tables
    alone, whose gradients come only from the dbias or dtable kernel."""
    tt.manual_seed(0)
    torch.manual_seed(0)
    m = T5.from_name("tiny", device=cuda, dtype=torch.bfloat16, d_kv=64,
                     flash_bucket_bias=bucket)
    ref = T5.from_name("tiny", device=cuda, dtype=torch.float32, d_kv=64, use_flash=False)
    ref.load_state_dict(m.state_dict())
    src = torch.randint(0, 256, (2, 40), device=cuda)
    tgt = torch.randint(0, 256, (2, 33), device=cuda)
    labels = torch.randint(0, 256, (2, 33), device=cuda)

    def grads(model):
        model.zero_grad(set_to_none=True)
        torch.nn.functional.cross_entropy(model(src, tgt).float().flatten(0, 1),
                                          labels.flatten()).backward()
        return {n: p.grad.float().flatten() for n, p in model.named_parameters()}

    for fn in (tflash.flash_fwd_cuda, tflash.flash_bwd_dkv_cuda, tflash.flash_bwd_dq_cuda):
        fn.bias_launches = fn.bucket_launches = 0
    tflash.flash_bwd_dbias_cuda.launches = tflash.flash_bwd_dtable_cuda.launches = 0
    kern = grads(m)
    torch.cuda.synchronize()
    key = "bucket_launches" if bucket else "bias_launches"
    for fn in (tflash.flash_fwd_cuda, tflash.flash_bwd_dkv_cuda, tflash.flash_bwd_dq_cuda):
        assert getattr(fn, key) == 4, fn.__name__
    assert tflash.flash_bwd_dtable_cuda.launches == (4 if bucket else 0)
    assert tflash.flash_bwd_dbias_cuda.launches == (0 if bucket else 4)
    want = grads(ref)
    m.cfg.use_flash = False
    plain = grads(m)
    groups = {"all": lambda n: True, "rel_bias": lambda n: "rel_bias" in n,
              "self_attn": lambda n: "self_attn." in n and "rel_bias" not in n}
    for group, keep in groups.items():
        part = [n for n in kern if keep(n)]
        k_, w_, p_ = (torch.cat([g[n] for n in part]) for g in (kern, want, plain))
        assert torch.isfinite(k_).all(), group
        assert (k_ - w_).norm() <= 2.0 * (p_ - w_).norm(), group


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name,s", [("decode_attention", 1), ("decode_attention_block", 5),
                                    ("paged_decode_attention", 1),
                                    ("paged_decode_attention_block", 5)])
@pytest.mark.parametrize("hq,hkv,d,ps", [(32, 8, 128, 16), (8, 8, 64, 5), (16, 2, 128, 1)])
def test_decode_variant_matches_plain(cuda, name, s, quant, hq, hkv, d, ps):
    """Each decode kernel variant against its plain version: slot depths at
    0, a page boundary and the end (S = 5 rows past it dropped); the pools
    under shuffled tables whose slots share a first page; any page size.
    A paged output equals the slab kernel's on the gathered rows bit for
    bit."""
    from torchdistx_tpu_torch.ops.attention import _paged_gather
    from torchdistx_tpu_torch.serve.kv_cache import quantize_kv

    g = torch.Generator(device=cuda).manual_seed(hq + d + ps)
    b, pp = 4, 260 // ps
    num_pages = b * pp + 1
    q = _rand(g, (b, s, hq, d), cuda)
    pools = [_rand(g, (num_pages, ps, hkv, d), cuda) for _ in range(2)]
    tables = (torch.randperm(num_pages - 1, generator=g, device=cuda)[: b * pp] + 1)
    tables = tables.view(b, pp).to(torch.int32)
    tables[1:, 0] = tables[0, 0]
    kw = {}
    if quant:
        (kq, ks), (vq, vs) = (quantize_kv(p) for p in pools)
        pools, kw = [kq, vq], dict(k_scale=ks, v_scale=vs)
    pos = torch.tensor([0, ps, pp * ps - 3, pp * ps - 1], dtype=torch.int32, device=cuda)
    paged = name.startswith("paged")
    if paged:
        args = (*pools, tables, pos)
    else:
        args = (*(_paged_gather(p, tables).contiguous() for p in pools), pos)
        kw = {k: _paged_gather(v, tables).contiguous() for k, v in kw.items()}
    kernel = getattr(tdec, f"{name}_cuda")
    before = (kernel.launches, kernel.int8_launches)
    out = getattr(tdec, name)(q, *args, **kw)
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.int8_launches) == (before[0] + 1, before[1] + int(quant))
    ref = getattr(tdec, f"{name}_reference")(q, *args, **kw)
    torch.testing.assert_close(out, ref, **TOL)
    # per (slot, query row): a dropped key tile or an off-by-one at depth
    # moves the row by far more than its bf16 rounding
    diff = (out.float() - ref.float()).flatten(2).norm(dim=-1)
    assert bool((diff <= 1e-2 * ref.float().flatten(2).norm(dim=-1)).all())
    if paged:
        slab = [_paged_gather(p, tables).contiguous() for p in pools]
        skw = {k: _paged_gather(v, tables).contiguous() for k, v in kw.items()}
        slab_fn = tdec.decode_attention if s == 1 else tdec.decode_attention_block
        assert torch.equal(out, slab_fn(q, *slab, pos, **skw))


def test_decode_variants_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(2, 5, 8, 128, dtype=torch.bfloat16, device=cuda)
    c = torch.zeros(2, 16, 2, 128, dtype=torch.bfloat16, device=cuda)
    pos = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one token"):
        tdec.decode_attention_cuda(q, c, c, pos)
    # one token takes S * Hq/Hkv <= 64 rows, as the verify block does
    with pytest.raises(ValueError, match="S \\* Hq/Hkv"):
        tdec.decode_attention_cuda(torch.zeros(2, 1, 130, 128, dtype=torch.bfloat16,
                                               device=cuda), c, c, pos)
    with pytest.raises(TypeError, match="int8"):
        tdec.decode_attention_block_cuda(q, c, c, pos, k_scale=c[..., :1].float(),
                                         v_scale=c[..., :1].float())
    with pytest.raises(ValueError, match="S \\* Hq/Hkv"):
        tdec.decode_attention_block_cuda(torch.zeros(2, 20, 8, 128, dtype=torch.bfloat16,
                                                     device=cuda), c, c, pos)
    with pytest.raises(ValueError, match="page_tables rows"):
        tdec.paged_decode_attention_block_cuda(q, c, c, torch.zeros(3, 4, dtype=torch.int32,
                                                                    device=cuda), pos)


# (hq, hkv): n_rep 1, 2, 4 (llama3_8b's 32 / 8) and 8 in one m-tile; 32
# and 64 in two and four (more than the old one-token kernel's 8)
ONE_TOKEN_HEADS = [(8, 8), (8, 4), (32, 8), (16, 2), (64, 2), (64, 1)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", ONE_TOKEN_HEADS)
def test_one_token_decode_matches_plain(cuda, hq, hkv, d, quant):
    """One token a slot through the split kernel, slab and paged (page size
    16), at depths on a split edge (SPLIT_KEYS keys) -1, 0, +1, the first
    key and the cache's end: against the plain version (also per (slot,
    row) within 1e-2 of the row's norm), two launches bit-identical, the
    paged output equal to the slab one bit for bit."""
    from torchdistx_tpu_torch.ops.attention import _paged_gather
    from torchdistx_tpu_torch.serve.kv_cache import quantize_kv

    split, ps = tdec.SPLIT_KEYS, 16
    g = torch.Generator(device=cuda).manual_seed(hq * d + hkv)
    pp = -(-(2 * split + 100) // ps)
    max_len = pp * ps
    lasts = [0, split - 1, split, split + 1, 2 * split, max_len - 1]
    b = len(lasts)
    pos = torch.tensor(lasts, dtype=torch.int32, device=cuda)
    num_pages = b * pp + 1
    q = _rand(g, (b, 1, hq, d), cuda)
    pools = [_rand(g, (num_pages, ps, hkv, d), cuda) for _ in range(2)]
    tables = (torch.randperm(num_pages - 1, generator=g, device=cuda)[: b * pp] + 1)
    tables = tables.view(b, pp).to(torch.int32)
    kw = {}
    if quant:
        (kq, ks), (vq, vs) = (quantize_kv(x) for x in pools)
        pools, kw = [kq, vq], dict(k_scale=ks, v_scale=vs)
    slab = [_paged_gather(x, tables).contiguous() for x in pools]
    skw = {k: _paged_gather(x, tables).contiguous() for k, x in kw.items()}
    out = tdec.decode_attention_cuda(q, *slab, pos, **skw)
    again = tdec.decode_attention_cuda(q, *slab, pos, **skw)
    paged = tdec.paged_decode_attention_cuda(q, *pools, tables, pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out, paged)
    ref = tdec.decode_attention_reference(q, *slab, pos, **skw)
    torch.testing.assert_close(out, ref, **TOL)
    diff = (out.float() - ref.float()).flatten(2).norm(dim=-1)
    assert bool((diff <= 1e-2 * ref.float().flatten(2).norm(dim=-1)).all())


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
    to 1e-3 absolute, dX and dW of the one backward (bf16 dP, cotangent 2)
    within 2e-2 of their max, as ``chip_smoke.py`` holds them."""
    x, w, labels = _ce_inputs(cuda, 509, d, 1000, d)
    g2 = torch.full((1,), 2.0, device=cuda)
    before = [f.launches for f in (tfc.fused_ce_fwd_cuda, tfc.fused_ce_bwd_cuda)]
    loss, lse = tfc.fused_ce_fwd_cuda(x, w, labels)
    dx, dw = tfc.fused_ce_bwd_cuda(x, w, labels, lse, g2)
    torch.cuda.synchronize()
    after = [f.launches for f in (tfc.fused_ce_fwd_cuda, tfc.fused_ce_bwd_cuda)]
    assert after == [b + 1 for b in before]
    r_loss, r_lse = tfc.fused_ce_fwd_reference(x, w, labels)
    torch.testing.assert_close(lse, r_lse, atol=1e-3, rtol=0)
    torch.testing.assert_close(loss.mean(), r_loss.mean(), atol=0, rtol=1e-3)
    assert dx.dtype == dw.dtype == torch.bfloat16
    r_dx, r_dw = tfc.fused_ce_bwd_reference(x, w, labels, r_lse, g2)
    assert _scaled(dx, r_dx) <= 2e-2
    assert _scaled(dw, r_dw) <= 2e-2


@pytest.mark.parametrize("n,d,v,chunk", [(509, 64, 1000, 256), (130, 128, 1777, 512),
                                         (3, 64, 600, 256)])
def test_fused_ce_backward_chunks_are_bit_identical(cuda, monkeypatch, n, d, v, chunk):
    """The backward with the vocab in several chunks (``PANEL_BYTES`` cut
    so that a chunk is ``chunk`` columns; the last one ragged): against
    the plain chunked algorithm at the same chunk within 2e-2 of each
    gradient's max, and two launches bit-identical (no atomics, sums in a
    fixed order)."""
    monkeypatch.setattr(tfc, "PANEL_BYTES", 2 * n * chunk)
    assert tfc.bwd_chunk(n, v) == chunk
    x, w, labels = _ce_inputs(cuda, n, d, v, n + v)
    labels[:3] = torch.tensor([chunk - 1, chunk, v - 1], device=cuda)[:n]
    g = torch.full((1,), 0.5, device=cuda)
    _, lse = tfc.fused_ce_fwd_cuda(x, w, labels)
    dx, dw = tfc.fused_ce_bwd_cuda(x, w, labels, lse, g)
    dx2, dw2 = tfc.fused_ce_bwd_cuda(x, w, labels, lse, g)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    r_dx, r_dw = tfc.fused_ce_bwd_reference(x, w, labels, lse, g, chunk=chunk)
    assert _scaled(dx, r_dx) <= 2e-2
    assert _scaled(dw, r_dw) <= 2e-2


# (n, v): the last 256-column tile holds one column (V = 256 k + 1), the
# last 2048-column range of a forward block holds one (V = 8 * 256 + 1), and
# a second range of 512 columns; N 3 and the prime 509
@pytest.mark.parametrize("v", [769, 2049, 2560])
@pytest.mark.parametrize("n", [3, 509])
def test_fused_ce_forward_at_tile_and_range_edges(cuda, n, v):
    """The forward against its plain version with labels at V - 1, 0 and
    the first column of the second range (of the second tile when there is
    one range): lse within 1e-3, each row's loss within 1e-3 relative (the
    constants of ``test_fused_ce_kernels_match_plain``)."""
    x, w, labels = _ce_inputs(cuda, n, 128, v, n + v)
    labels[:3] = torch.tensor([v - 1, 0, 2048 if v > 2048 else 256], device=cuda)[:n]
    loss, lse = tfc.fused_ce_fwd_cuda(x, w, labels)
    torch.cuda.synchronize()
    r_loss, r_lse = tfc.fused_ce_fwd_reference(x, w, labels)
    torch.testing.assert_close(lse, r_lse, atol=1e-3, rtol=0)
    torch.testing.assert_close(loss, r_loss, atol=0, rtol=1e-3)


def test_fused_ce_forward_is_bit_identical_across_launches(cuda):
    """No atomics: each block owns its rows' partials of its vocab range,
    and the combine merges the ranges in order."""
    x, w, labels = _ce_inputs(cuda, 509, 128, 5000, 7)
    first = tfc.fused_ce_fwd_cuda(x, w, labels)
    second = tfc.fused_ce_fwd_cuda(x, w, labels)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_fused_loss_autograd_goes_through_the_kernels(cuda):
    x, w, labels = _ce_inputs(cuda, 64, 64, 300, 1)
    x.requires_grad_()
    w.requires_grad_()
    counts = [f.launches for f in (tfc.fused_ce_fwd_cuda, tfc.fused_ce_bwd_cuda)]
    tfc.fused_linear_cross_entropy(x.view(4, 16, 64), w, labels.view(4, 16)).backward()
    torch.cuda.synchronize()
    assert [f.launches for f in (tfc.fused_ce_fwd_cuda, tfc.fused_ce_bwd_cuda)] == [
        c + 1 for c in counts]
    assert x.grad.shape == (64, 64) and w.grad.shape == (300, 64)
    assert torch.isfinite(x.grad.float()).all() and torch.isfinite(w.grad.float()).all()


def test_fused_ce_kernels_refuse_what_they_do_not_take(cuda):
    """A CUDA f32 or mis-shaped input raises; no plain fallback runs."""
    x, w, labels = _ce_inputs(cuda, 16, 64, 100, 2)
    lse = torch.zeros(16, device=cuda)
    one = torch.ones(1, device=cuda)
    counts = [f.launches for f in (tfc.fused_ce_fwd_cuda, tfc.fused_ce_bwd_cuda)]
    with pytest.raises(TypeError, match="bf16"):
        tfc.fused_ce_fwd_cuda(x.float(), w.float(), labels)
    with pytest.raises(TypeError, match="bf16"):
        tfc.fused_linear_cross_entropy(x.float(), w.float(), labels)
    with pytest.raises(TypeError, match="bf16"):
        tfc.fused_ce_bwd_cuda(x, w.float(), labels, lse, one)
    with pytest.raises(ValueError, match=r"\(V, D\)"):
        tfc.fused_ce_bwd_cuda(x, w[:, :32], labels, lse, one)
    with pytest.raises(ValueError, match="D % 8"):
        tfc.fused_ce_bwd_cuda(x[:, :60], w[:, :60], labels, lse, one)
    with pytest.raises(ValueError, match="labels"):
        tfc.fused_ce_fwd_cuda(x, w, labels[:-1])
    with pytest.raises(ValueError, match="lse"):
        tfc.fused_ce_bwd_cuda(x, w, labels, lse[:-1], one)
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        tfc.fused_ce_bwd_cuda(x, w, labels, lse.cpu(), one)
    assert [f.launches for f in (tfc.fused_ce_fwd_cuda, tfc.fused_ce_bwd_cuda)] == counts


# -- the sliding-window variants ------------------------------------------------

# (b, sq, skv, hq, hkv, d, window): below the tile, not a multiple of it,
# one key a row, at least S, Sq < Skv, head_dim 64, and a band of 1000 keys
# (rows of O(0.03), where only the row check tells a lost tile)
WINDOW_CASES = [(1, 200, 200, 8, 2, 128, 37), (2, 130, 130, 4, 4, 64, 64),
                (1, 77, 77, 4, 2, 128, 1), (1, 100, 100, 8, 8, 128, 300),
                (1, 40, 150, 8, 2, 128, 70), (1, 300, 300, 8, 2, 128, 100),
                (1, 2100, 2100, 4, 2, 128, 1000)]


def _assert_head_rows_close(out, ref):
    """Per (row, head) of a (B, S, H, D) tensor, the norm of the difference
    from the plain version in f32 within 1e-2 of the reference row's norm,
    or of 1e-2 where that norm is smaller (dq of a row that sees one key,
    and dq and dk at window 1, are zero up to f32 rounding): a key of the
    band dropped or added moves a row by far more than its bf16 rounding,
    even where ATOL is as large as a typical element.  (The bf16 plain
    forward rounds its logits to bf16 and is itself up to 2e-2 of a row
    away from f32.)"""
    o, r = out.float(), ref.float()
    assert bool(((o - r).norm(dim=-1) <= 1e-2 * r.norm(dim=-1).clamp_min(1e-2)).all())


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window", WINDOW_CASES)
def test_window_forward_kernel_matches_plain(cuda, b, sq, skv, hq, hkv, d, window):
    g = torch.Generator(device=cuda).manual_seed(sq + window)
    q = _rand(g, (b, sq, hq, d), cuda)
    k, v = (_rand(g, (b, skv, hkv, d), cuda) for _ in range(2))
    before = tflash.flash_fwd_cuda.window_launches
    out = tflash.flash_attention(q, k, v, window=window)
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True, window=window)
    torch.cuda.synchronize()
    assert tflash.flash_fwd_cuda.window_launches == before + 2
    ref, lse_ref = tflash.flash_attention_lse_reference(q, k, v, window=window)
    ref32 = tflash.flash_attention_reference(q.float(), k.float(), v.float(), window=window)
    for x in (out, o):
        torch.testing.assert_close(x, ref, **TOL)
        _assert_head_rows_close(x, ref32)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,window",
                         [c for c in WINDOW_CASES if c[1] == c[2]])
def test_window_bwd_kernels_match_plain(cuda, b, sq, skv, hq, hkv, d, window):
    g = torch.Generator(device=cuda).manual_seed(sq * window)
    q, k, v, do = (_rand(g, (b, sq, h, d), cuda) for h in (hq, hkv, hkv, hq))
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True, window=window)
    dk, dv = tflash.flash_bwd_dkv_cuda(q, k, v, o, lse, do, window=window)
    dq = tflash.flash_bwd_dq_cuda(q, k, v, o, lse, do, window=window)
    torch.cuda.synchronize()
    refs = tflash.flash_bwd_reference(q, k, v, o, lse, do, window=window)
    refs32 = tflash.flash_bwd_reference(*(x.float() for x in (q, k, v, o)), lse,
                                        do.float(), window=window)
    for out, ref, ref32 in zip((dq, dk, dv), refs, refs32):
        torch.testing.assert_close(out, ref, **TOL)
        _assert_head_rows_close(out, ref32)


def test_window_training_goes_through_the_window_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (_rand(g, (1, 192, 4, 128), cuda).requires_grad_() for _ in range(3))
    fns = (tflash.flash_fwd_cuda, tflash.flash_bwd_dkv_cuda, tflash.flash_bwd_dq_cuda)
    counts = [f.window_launches for f in fns]
    tflash.flash_attention(q, k, v, window=50).float().sum().backward()
    torch.cuda.synchronize()
    assert [f.window_launches for f in fns] == [c + 1 for c in counts]
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


def test_window_kernels_refuse_a_bias(cuda):
    x = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros(1, 2, 8, device=cuda)
    bias = torch.zeros(2, 8, 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tflash.flash_fwd_cuda(x, x, x, window=4, bias=bias)
    with pytest.raises(ValueError, match="causal"):
        tflash.flash_bwd_dq_cuda(x, x, x, x, lse, x, window=4, causal=False)


def test_int8_mixtral_block_matches_plain(cuda):
    """One full-width Mixtral block (dim 4096, 8 experts of 14336) in int8
    against its bf16 self: the MoE fidelity metric of the JAX package's
    tests as they apply it, on 16-token prompts (99th percentile of |int8 -
    bf16| / max|bf16| below 0.05, argmax agreement above 0.9); the LM head
    stays bf16, as the smoke serves it."""
    from torchdistx_tpu_torch.models import Mixtral
    from torchdistx_tpu_torch.nn import QuantizedMoE, quantize_module

    tt.manual_seed(0)
    m = tt.deferred_init(Mixtral.from_name, "mixtral_8x7b", device="cuda", n_layers=1)
    tt.materialize_module(m)
    toks = torch.randint(0, 32000, (32, 16), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
    with torch.no_grad():
        ref = m(toks).float()
        quantize_module(m, filter_fn=lambda path, mod: "lm_head" not in path)
        assert isinstance(m.blocks[0].mlp, QuantizedMoE)
        out = m(toks).float()
    rel = ((out - ref).abs() / ref.abs().max()).flatten()
    assert torch.quantile(rel[:1 << 20], 0.99) < 0.05
    assert (out.argmax(-1) == ref.argmax(-1)).float().mean() > 0.9


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,bias", [
    (1, 200, 200, 8, 2, 128, True, False), (2, 130, 130, 4, 4, 64, False, False),
    (1, 96, 160, 4, 4, 128, True, False), (2, 128, 128, 4, 4, 128, False, True)])
def test_residuals_kernel_matches_plain(cuda, b, sq, skv, hq, hkv, d, causal, bias):
    """The (m, l) residuals: the raw f32 accumulator per (row, head) within
    1e-2 of its norm (the kernel's P.V takes bf16 P), m to 1e-5 absolute and
    l to 1e-5 relative, against the plain version on f32-widened inputs."""
    g = torch.Generator(device=cuda).manual_seed(sq + d)
    q = _rand(g, (b, sq, hq, d), cuda)
    k, v = _rand(g, (b, skv, hkv, d), cuda), _rand(g, (b, skv, hkv, d), cuda)
    bi = _rand(g, (hq, sq, skv), cuda) if bias else None
    before = tflash.flash_fwd_cuda.residual_launches
    acc, m, l = tflash.flash_fwd_cuda(q, k, v, causal=causal, bias=bi, return_residuals=True)
    torch.cuda.synchronize()
    assert tflash.flash_fwd_cuda.residual_launches == before + 1
    ra, rm, rl = tflash.flash_attention_residuals_reference(
        q.float(), k.float(), v.float(), causal=causal, bias=None if bi is None else bi.float())
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    rows = (acc - ra).norm(dim=-1) / ra.norm(dim=-1).clamp_min(1e-30)
    assert float(rows.max()) < 1e-2
    assert float((m - rm).abs().max()) < 1e-5
    assert float(((l - rl).abs() / rl).max()) < 1e-5


@pytest.mark.parametrize("b,s,hq,hkv,d,causal", [(1, 200, 8, 2, 128, True),
                                                 (2, 130, 4, 4, 64, False)])
def test_f32_output_backward_kernels_match_plain(cuda, b, s, hq, hkv, d, causal):
    g = torch.Generator(device=cuda).manual_seed(s)
    q, do = _rand(g, (b, s, hq, d), cuda), _rand(g, (b, s, hq, d), cuda)
    k, v = _rand(g, (b, s, hkv, d), cuda), _rand(g, (b, s, hkv, d), cuda)
    o, lse = tflash.flash_fwd_cuda(q, k, v, causal=causal, return_lse=True)
    before = (tflash.flash_bwd_dkv_cuda.f32_launches, tflash.flash_bwd_dq_cuda.f32_launches)
    dk, dv = tflash.flash_bwd_dkv_cuda(q, k, v, o, lse, do, causal=causal,
                                       part_dtype=torch.float32)
    dq = tflash.flash_bwd_dq_cuda(q, k, v, o, lse, do, causal=causal, dq_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (tflash.flash_bwd_dkv_cuda.f32_launches, tflash.flash_bwd_dq_cuda.f32_launches) == (
        before[0] + 1, before[1] + 1)
    ref = tflash.flash_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                     dq_dtype=torch.float32, part_dtype=torch.float32)
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == want.dtype == torch.float32
        torch.testing.assert_close(got, want, **TOL)
    # the bf16 kernels write the same sums rounded
    torch.testing.assert_close(tflash.flash_bwd_dq_cuda(q, k, v, o, lse, do, causal=causal),
                               dq.to(torch.bfloat16), rtol=1e-2, atol=1e-2)


def test_ring_of_one_block_is_flash(cuda):
    """At world size 1 the flash ring is one diagonal block: its output and
    gradients equal flash attention's within bf16 rounding, through the
    residuals and f32-output kernels."""
    from torchdistx_tpu_torch.ops.attention import ring_flash_attention
    from torchdistx_tpu_torch.parallel import create_mesh

    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (_rand(g, (1, 256, h, 128), cuda).requires_grad_() for h in (8, 2, 2))
    with create_mesh({"sp": 1}):
        out = ring_flash_attention(q, k, v, axis="sp")
        grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    ref = tflash.flash_attention(q, k, v)
    rgrads = torch.autograd.grad(ref.float().sum(), (q, k, v))
    torch.testing.assert_close(out, ref, **TOL)
    for a, r in zip(grads, rgrads):
        torch.testing.assert_close(a, r, **TOL)


# -- the Hopper flash forward and dK/dV: 128-row tiles, TMA, wgmma ----------------

# (b, sq, skv, hq, hkv, d): S below, at and just past the 128-row tile, a
# ragged S, Sq < Skv (end-aligned), head_dim 64 and 128, n_rep 1, 4 and 8
TILE_CASES = [(1, 127, 127, 8, 8, 128), (2, 128, 128, 8, 2, 64), (1, 129, 129, 8, 1, 128),
              (1, 777, 777, 8, 2, 128), (1, 100, 300, 4, 4, 64), (1, 129, 257, 8, 1, 128)]
# the variants of each: (name, causal, window); bias and bucket need Sq == Skv
FWD_VARIANTS = [("plain", True, None), ("lse", False, None), ("residuals", True, None),
                ("residuals", False, None), ("bias", True, None), ("bucket", False, None),
                ("window", True, 300), ("window", True, 100)]


def _tile_cases():
    for case in TILE_CASES:
        for name, causal, window in FWD_VARIANTS:
            if name in ("bias", "bucket") and case[1] != case[2]:
                continue
            yield pytest.param(*case, name, causal, window,
                               id=f"{name}-{'causal' if causal else 'full'}-w{window}-"
                                  + "-".join(map(str, case)))


def _bias_kw(g, name, hq, sq, skv, causal, dev):
    if name == "bias":
        return dict(bias=_rand(g, (hq, sq, skv), dev))
    if name == "bucket":
        return dict(table=_rand(g, (hq, 32), dev), bucket_cfg=(32, 128, not causal))
    return {}


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,name,causal,window", list(_tile_cases()))
def test_flash_forward_tile_geometry(cuda, b, sq, skv, hq, hkv, d, name, causal, window):
    """Every forward variant at S around the 128-row tile, a ragged S,
    Sq < Skv, D 64 / 128 and n_rep 1 / 4 / 8 against the plain versions,
    with the tolerances of the tests above."""
    g = torch.Generator(device=cuda).manual_seed(sq * 7 + skv + d)
    q = _rand(g, (b, sq, hq, d), cuda)
    k, v = _rand(g, (b, skv, hkv, d), cuda), _rand(g, (b, skv, hkv, d), cuda)
    kw = dict(causal=causal, window=window, **_bias_kw(g, name, hq, sq, skv, causal, cuda))
    if name == "residuals":
        acc, m, l = tflash.flash_fwd_cuda(q, k, v, causal=causal, return_residuals=True)
        torch.cuda.synchronize()
        ra, rm, rl = tflash.flash_attention_residuals_reference(
            q.float(), k.float(), v.float(), causal=causal)
        assert float(((acc - ra).norm(dim=-1) / ra.norm(dim=-1)).max()) < 1e-2
        assert float((m - rm).abs().max()) < 1e-5
        assert float(((l - rl).abs() / rl).max()) < 1e-5
        return
    out = tflash.flash_fwd_cuda(q, k, v, **kw)
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    ref, lse_ref = tflash.flash_attention_lse_reference(q, k, v, **kw)
    for x in (out, o):
        torch.testing.assert_close(x, ref, **TOL)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    if window is not None:
        ref32 = tflash.flash_attention_reference(q.float(), k.float(), v.float(),
                                                 window=window)
        _assert_head_rows_close(o, ref32)


# the backward's variants: (name, causal, window, part_dtype)
BWD_VARIANTS = [("plain", True, None, None), ("plain", False, None, torch.float32),
                ("bias", False, None, None), ("bucket", True, None, None),
                ("window", True, 300, None), ("window", True, 100, torch.float32)]


@pytest.mark.parametrize("name,causal,window,part", BWD_VARIANTS,
                         ids=[f"{v[0]}-{'causal' if v[1] else 'full'}-w{v[2]}-"
                              f"{'f32' if v[3] else 'bf16'}" for v in BWD_VARIANTS])
@pytest.mark.parametrize("b,s,hq,hkv,d", [c[:2] + c[3:] for c in TILE_CASES if c[1] == c[2]],
                         ids=lambda x: str(x))
def test_flash_dkv_tile_geometry(cuda, b, s, hq, hkv, d, name, causal, window, part):
    """dK/dV (and its delta pre-pass) in every variant at the same
    geometry, from the kernel forward's o and lse, against the plain
    backward (bf16 or f32 outputs, the tolerance of the tests above)."""
    g = torch.Generator(device=cuda).manual_seed(s * 3 + d + hkv)
    q, do = _rand(g, (b, s, hq, d), cuda), _rand(g, (b, s, hq, d), cuda)
    k, v = _rand(g, (b, s, hkv, d), cuda), _rand(g, (b, s, hkv, d), cuda)
    kw = dict(causal=causal, window=window, **_bias_kw(g, name, hq, s, s, causal, cuda))
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True, **kw)
    before = tflash.flash_bwd_delta_cuda.launches
    dk, dv = tflash.flash_bwd_dkv_cuda(q, k, v, o, lse, do, part_dtype=part, **kw)
    delta = tflash.flash_bwd_delta_cuda(o, do)
    torch.cuda.synchronize()
    assert tflash.flash_bwd_delta_cuda.launches == before + 2
    torch.testing.assert_close(delta, tflash.flash_bwd_delta_reference(o, do),
                               atol=1e-4, rtol=0)
    _, rk, rv = tflash.flash_bwd_reference(q, k, v, o, lse, do, part_dtype=part, **kw)[:3]
    for got, want in ((dk, rk), (dv, rv)):
        assert got.dtype == want.dtype == (part or torch.bfloat16)
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("name,causal,window,part", BWD_VARIANTS,
                         ids=[f"{v[0]}-{'causal' if v[1] else 'full'}-w{v[2]}-"
                              f"{'f32' if v[3] else 'bf16'}" for v in BWD_VARIANTS])
@pytest.mark.parametrize("b,s,hq,hkv,d", [c[:2] + c[3:] for c in TILE_CASES if c[1] == c[2]],
                         ids=lambda x: str(x))
def test_flash_dq_tile_geometry(cuda, b, s, hq, hkv, d, name, causal, window, part):
    """dQ in every variant at the dK/dV geometry (S around the 128-row block
    and the 64-key tile, ragged S, D 64 / 128, n_rep 1 / 4 / 8; no bias, the
    additive bias, the bucket table, windows 100 / 300; bf16 or f32 output),
    from the kernel forward's o and lse and the pre-pass's delta, against
    the plain backward (the tolerance of the tests above)."""
    g = torch.Generator(device=cuda).manual_seed(s * 5 + d + hkv)
    q, do = _rand(g, (b, s, hq, d), cuda), _rand(g, (b, s, hq, d), cuda)
    k, v = _rand(g, (b, s, hkv, d), cuda), _rand(g, (b, s, hkv, d), cuda)
    kw = dict(causal=causal, window=window, **_bias_kw(g, name, hq, s, s, causal, cuda))
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True, **kw)
    delta = tflash.flash_bwd_delta_cuda(o, do)
    before = tflash.flash_bwd_delta_cuda.launches
    dq = tflash.flash_bwd_dq_cuda(q, k, v, o, lse, do, dq_dtype=part, delta=delta, **kw)
    torch.cuda.synchronize()
    assert tflash.flash_bwd_delta_cuda.launches == before  # the given delta is read
    rq = tflash.flash_bwd_reference(q, k, v, o, lse, do, dq_dtype=part, **kw)[0]
    assert dq.dtype == rq.dtype == (part or torch.bfloat16)
    torch.testing.assert_close(dq, rq, **TOL)


def test_flash_dq_is_bit_identical_across_launches(cuda):
    """No atomics: each block owns its query rows and adds its key tiles up
    in one order."""
    for d in (64, 128):
        g = torch.Generator(device=cuda).manual_seed(d + 1)
        q, do = _rand(g, (2, 777, 8, d), cuda), _rand(g, (2, 777, 8, d), cuda)
        k, v = _rand(g, (2, 777, 1, d), cuda), _rand(g, (2, 777, 1, d), cuda)
        o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True)
        first = tflash.flash_bwd_dq_cuda(q, k, v, o, lse, do, dq_dtype=torch.float32)
        second = tflash.flash_bwd_dq_cuda(q, k, v, o, lse, do, dq_dtype=torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_flash_backward_runs_one_delta_for_both_kernels(cuda):
    """``flash_backward`` launches the pre-pass once and hands its delta to
    dK/dV and dQ: the same bits as each kernel computing its own."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, do = _rand(g, (1, 300, 8, 128), cuda), _rand(g, (1, 300, 8, 128), cuda)
    k, v = _rand(g, (1, 300, 2, 128), cuda), _rand(g, (1, 300, 2, 128), cuda)
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True)
    before = tflash.flash_bwd_delta_cuda.launches
    dq, dk, dv = tflash.flash_backward(q, k, v, o, lse, do)
    assert tflash.flash_bwd_delta_cuda.launches == before + 1
    dk2, dv2 = tflash.flash_bwd_dkv_cuda(q, k, v, o, lse, do)
    dq2 = tflash.flash_bwd_dq_cuda(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert tflash.flash_bwd_delta_cuda.launches == before + 3
    for a, b in ((dq, dq2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


# (b, s, hq, hkv, d): one batch row, five, a ragged odd S (bf16 pairs of a
# dbias row not 4-byte aligned), GQA, head_dim 64
DBIAS_CASES = [(1, 200, 8, 2, 128), (5, 130, 4, 4, 64), (2, 777, 8, 1, 128),
               (3, 64, 4, 2, 64)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("b,s,hq,hkv,d", DBIAS_CASES)
def test_flash_dbias_matches_plain_and_repeats_bit_for_bit(cuda, b, s, hq, hkv, d, causal):
    """The dbias kernel against ``flash_bias_grad_reference`` scaled by its
    max within 2e-2 (``test_biased_kernels_match_plain``'s bound); two
    launches the same bits (no atomics, the batch summed in order); with the
    pre-pass's ``delta`` given the same bits as without it."""
    g = torch.Generator(device=cuda).manual_seed(b * s + hq + d)
    q, do = _rand(g, (b, s, hq, d), cuda), _rand(g, (b, s, hq, d), cuda)
    k, v = _rand(g, (b, s, hkv, d), cuda), _rand(g, (b, s, hkv, d), cuda)
    bias = _rand(g, (hq, s, s), cuda)
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True, causal=causal, bias=bias)
    delta = tflash.flash_bwd_delta_cuda(o, do)
    first = tflash.flash_bwd_dbias_cuda(q, k, v, o, lse, do, bias, causal=causal)
    second = tflash.flash_bwd_dbias_cuda(q, k, v, o, lse, do, bias, causal=causal)
    given = tflash.flash_bwd_dbias_cuda(q, k, v, o, lse, do, bias, causal=causal,
                                        delta=delta)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, given)
    ref = tflash.flash_bias_grad_reference(q, k, v, o, lse, do, causal=causal, bias=bias)
    assert first.dtype == torch.bfloat16 and first.shape == bias.shape
    assert _scaled_err(first, ref) <= 2e-2


def test_flash_backward_with_a_bias_runs_one_delta(cuda):
    """``flash_backward`` with a bias launches the pre-pass once and hands
    its delta to dK/dV, dQ and dbias."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q, do = _rand(g, (2, 130, 4, 128), cuda), _rand(g, (2, 130, 4, 128), cuda)
    k, v = _rand(g, (2, 130, 4, 128), cuda), _rand(g, (2, 130, 4, 128), cuda)
    bias = _rand(g, (4, 130, 130), cuda)
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True, causal=False, bias=bias)
    before = [tflash.flash_bwd_delta_cuda.launches, tflash.flash_bwd_dbias_cuda.launches]
    dbias = tflash.flash_backward(q, k, v, o, lse, do, causal=False, bias=bias)[3]
    torch.cuda.synchronize()
    assert [tflash.flash_bwd_delta_cuda.launches,
            tflash.flash_bwd_dbias_cuda.launches] == [before[0] + 1, before[1] + 1]
    assert torch.equal(dbias, tflash.flash_bwd_dbias_cuda(q, k, v, o, lse, do, bias,
                                                          causal=False))


# (b, s, hq, hkv, d, buckets): DBIAS_CASES at T5's 32 buckets, T5's ragged
# target length, and a bucket count at MAX_BUCKETS
DTABLE_CASES = [c + (32,) for c in DBIAS_CASES] + [(4, 114, 4, 4, 128, 32),
                                                  (2, 777, 4, 2, 64, 256)]


@pytest.mark.parametrize("bidir", [True, False], ids=["bidirectional", "unidirectional"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("b,s,hq,hkv,d,buckets", DTABLE_CASES)
def test_flash_dtable_matches_plain_and_repeats_bit_for_bit(cuda, b, s, hq, hkv, d, buckets,
                                                             causal, bidir):
    """The dtable kernel against ``flash_bias_grad_reference`` scaled by its
    max within 2e-2 (``test_biased_kernels_match_plain``'s bound); two
    launches the same bits (per-tile partials summed in tile order, no
    atomics); with the pre-pass's ``delta`` given the same bits as without
    it."""
    g = torch.Generator(device=cuda).manual_seed(b * s + hq + d + buckets)
    q, do = _rand(g, (b, s, hq, d), cuda), _rand(g, (b, s, hq, d), cuda)
    k, v = _rand(g, (b, s, hkv, d), cuda), _rand(g, (b, s, hkv, d), cuda)
    table = _rand(g, (hq, buckets), cuda)
    cfg = (buckets, 4 * buckets, bidir)
    kw = dict(causal=causal, table=table, bucket_cfg=cfg)
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True, **kw)
    delta = tflash.flash_bwd_delta_cuda(o, do)
    before = tflash.flash_bwd_dtable_cuda.launches
    first = tflash.flash_bwd_dtable_cuda(q, k, v, o, lse, do, table, cfg, causal=causal)
    second = tflash.flash_bwd_dtable_cuda(q, k, v, o, lse, do, table, cfg, causal=causal)
    given = tflash.flash_bwd_dtable_cuda(q, k, v, o, lse, do, table, cfg, causal=causal,
                                         delta=delta)
    torch.cuda.synchronize()
    assert tflash.flash_bwd_dtable_cuda.launches == before + 3
    assert torch.equal(first, second)
    assert torch.equal(first, given)
    ref = tflash.flash_bias_grad_reference(q, k, v, o, lse, do, **kw)
    assert first.dtype == torch.bfloat16 and first.shape == table.shape
    assert _scaled_err(first, ref) <= 2e-2


def test_flash_backward_with_a_table_runs_one_delta(cuda):
    """``flash_backward`` with a bucket table launches the pre-pass once and
    hands its delta to dK/dV, dQ and dtable."""
    g = torch.Generator(device=cuda).manual_seed(13)
    q, do = _rand(g, (2, 130, 4, 128), cuda), _rand(g, (2, 130, 4, 128), cuda)
    k, v = _rand(g, (2, 130, 4, 128), cuda), _rand(g, (2, 130, 4, 128), cuda)
    table, cfg = _rand(g, (4, 32), cuda), (32, 128, True)
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True, causal=False, table=table,
                                   bucket_cfg=cfg)
    before = [tflash.flash_bwd_delta_cuda.launches, tflash.flash_bwd_dtable_cuda.launches]
    dtable = tflash.flash_backward(q, k, v, o, lse, do, causal=False, table=table,
                                   bucket_cfg=cfg)[3]
    torch.cuda.synchronize()
    assert [tflash.flash_bwd_delta_cuda.launches,
            tflash.flash_bwd_dtable_cuda.launches] == [before[0] + 1, before[1] + 1]
    assert torch.equal(dtable, tflash.flash_bwd_dtable_cuda(q, k, v, o, lse, do, table, cfg,
                                                            causal=False))


@pytest.mark.parametrize("d", [64, 128])
def test_flash_dkv_is_bit_identical_across_launches(cuda, d):
    """No atomics: the GQA group sum and every tile add up in one order."""
    g = torch.Generator(device=cuda).manual_seed(d)
    q, do = _rand(g, (2, 777, 8, d), cuda), _rand(g, (2, 777, 8, d), cuda)
    k, v = _rand(g, (2, 777, 1, d), cuda), _rand(g, (2, 777, 1, d), cuda)
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True)
    first = tflash.flash_bwd_dkv_cuda(q, k, v, o, lse, do, part_dtype=torch.float32)
    second = tflash.flash_bwd_dkv_cuda(q, k, v, o, lse, do, part_dtype=torch.float32)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_kernels_read_strided_inputs_in_place(cuda):
    """q, k and v sliced from one packed (B, S, 3, H, D) projection (GPT-2's
    layout) go to the TMA kernels with their strides: the same bits as
    contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = _rand(g, (2, 300, 3, 4, 64), cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = _rand(g, (2, 300, 4, 64), cuda)
    assert not q.is_contiguous()
    o, lse = tflash.flash_fwd_cuda(q, k, v, return_lse=True)
    oc, lsec = tflash.flash_fwd_cuda(*(x.contiguous() for x in (q, k, v)), return_lse=True)
    dk, dv = tflash.flash_bwd_dkv_cuda(q, k, v, o, lse, do)
    dkc, dvc = tflash.flash_bwd_dkv_cuda(*(x.contiguous() for x in (q, k, v)), oc, lsec, do)
    dq = tflash.flash_bwd_dq_cuda(q, k, v, o, lse, do)
    dqc = tflash.flash_bwd_dq_cuda(*(x.contiguous() for x in (q, k, v)), oc, lsec, do)
    torch.cuda.synchronize()
    for a, b in ((o, oc), (lse, lsec), (dk, dkc), (dv, dvc), (dq, dqc)):
        assert torch.equal(a, b)


def test_tma_kernels_refuse_misaligned_or_strided_inputs(cuda):
    x = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros(1, 2, 64, device=cuda)
    misaligned = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(x.shape)
    not_inner = torch.zeros(1, 64, 64, 2, dtype=torch.bfloat16, device=cuda).transpose(2, 3)
    odd_heads = torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16, device=cuda)[..., :64]
    for bad in (misaligned, not_inner, odd_heads):
        with pytest.raises(ValueError, match="TMA"):
            tflash.flash_fwd_cuda(bad, x, x)
        with pytest.raises(ValueError, match="TMA"):
            tflash.flash_fwd_cuda(x, x, bad, return_residuals=True)
        with pytest.raises(ValueError, match="TMA"):
            tflash.flash_bwd_dkv_cuda(x, bad, x, x, lse, x)
        with pytest.raises(ValueError, match="TMA"):
            tflash.flash_bwd_dkv_cuda(x, x, x, x, lse, bad)


# -- the verify-block decode kernel: split key range, tensor cores ---------------

# (hq, hkv, s, page_size): llama3_8b's 32 / 8 heads at S 5 (20 rows), and
# S * n_rep = 64, the most the kernel takes (4 m-tiles, 8 warps)
SPLIT_CASES = [(32, 8, 5, 16), (32, 2, 4, 16), (16, 4, 2, 5)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hq,hkv,s,ps", SPLIT_CASES)
def test_block_decode_splits_at_their_edges(cuda, hq, hkv, s, ps, quant):
    """Slots whose deepest row is a split boundary (SPLIT_KEYS keys) -1, 0
    and +1, one slot deep, one at the cache's end (max_len not a multiple of
    a split): the kernel against the plain split-and-combine and the plain
    version, two launches bit-identical, the paged kernel equal to the slab
    kernel bit for bit."""
    from torchdistx_tpu_torch.ops.attention import _paged_gather
    from torchdistx_tpu_torch.serve.kv_cache import quantize_kv

    split = tdec.SPLIT_KEYS
    g = torch.Generator(device=cuda).manual_seed(hq * s + ps)
    pp = -(-(2 * split + 200) // ps)
    max_len = pp * ps
    lasts = [split - 2, split - 1, split, 2 * split - 1, 2 * split, max_len - 1]
    b = len(lasts)
    pos = torch.tensor([max(x - s + 1, 0) for x in lasts], dtype=torch.int32, device=cuda)
    num_pages = b * pp + 1
    q = _rand(g, (b, s, hq, 128), cuda)
    pools = [_rand(g, (num_pages, ps, hkv, 128), cuda) for _ in range(2)]
    tables = (torch.randperm(num_pages - 1, generator=g, device=cuda)[: b * pp] + 1)
    tables = tables.view(b, pp).to(torch.int32)
    kw = {}
    if quant:
        (kq, ks), (vq, vs) = (quantize_kv(x) for x in pools)
        pools, kw = [kq, vq], dict(k_scale=ks, v_scale=vs)
    slab = [_paged_gather(x, tables).contiguous() for x in pools]
    skw = {k: _paged_gather(x, tables).contiguous() for k, x in kw.items()}
    out = tdec.decode_attention_block_cuda(q, *slab, pos, **skw)
    again = tdec.decode_attention_block_cuda(q, *slab, pos, **skw)
    paged = tdec.paged_decode_attention_block_cuda(q, *pools, tables, pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out, paged)
    cpu = [x.cpu() for x in slab]
    ckw = {k: x.cpu() for k, x in skw.items()}
    split_ref = tdec.decode_attention_block_split_reference(q.cpu(), *cpu, pos.cpu(), **ckw)
    torch.testing.assert_close(out.cpu(), split_ref, **TOL)
    ref = tdec.decode_attention_block_reference(q, *slab, pos, **skw)
    torch.testing.assert_close(out, ref, **TOL)
    diff = (out.float() - ref.float()).flatten(2).norm(dim=-1)
    assert bool((diff <= 1e-2 * ref.float().flatten(2).norm(dim=-1)).all())


# -- persistent decode: the loop as a CUDA graph --------------------------------


def _graph_llama(cuda):
    """A small Llama the decode kernels take (head_dim 64), bf16 on the card."""
    tt.manual_seed(3)
    return tt.models.Llama.from_name("tiny", dim=256, n_heads=4, n_kv_heads=2,
                                     dtype=torch.bfloat16, device=cuda)


def _graph_requests(n_new=12):
    import numpy as np

    rs = np.random.RandomState(11)
    return [{"prompt": rs.randint(0, 256, n).astype(np.int32), "max_new_tokens": n_new,
             "temperature": 0.0 if i % 2 else 0.9, "seed": 40 + i}
            for i, n in enumerate((5, 17, 9, 30, 12, 3))]


def test_noise_bits_equal_on_cpu_and_cuda(cuda):
    from torchdistx_tpu_torch.generation import _noise_bits

    seeds = torch.tensor([0, 7, 2**31 - 1, 123456789])
    steps = torch.tensor([0, 1, 2**32 - 1, 77])
    cpu = _noise_bits(seeds, steps, 50257)
    dev = _noise_bits(seeds.to(cuda), steps.to(cuda), 50257)
    assert torch.equal(cpu, dev.cpu())


@pytest.mark.parametrize("kw", [{}, dict(page_size=8), dict(speculate=2),
                                dict(page_size=8, speculate=2, kv_dtype="int8"),
                                dict(eos_token=7, ring_capacity=4)],
                         ids=["slab", "paged", "spec", "paged-spec-int8", "eos-ring4"])
def test_persistent_streams_equal_chunked_on_the_card(cuda, kw):
    from torchdistx_tpu_torch.serve import ServeEngine

    model = _graph_llama(cuda)
    common = dict(num_slots=3, max_len=64, prefill_buckets=(32,), **kw)
    ring = common.pop("ring_capacity", None)
    base = ServeEngine(model, **common).run(_graph_requests())
    engine = ServeEngine(model, decode_mode="persistent", ring_capacity=ring, **common)
    out = engine.run(_graph_requests())
    for a, b in zip(base, out):
        assert b.tokens.tolist() == a.tokens.tolist()
        assert b.finish_reason == a.finish_reason
    c = engine.metrics.counters
    assert engine._decode.loop.graph is not None
    assert c["host_syncs"] == c["ring_drains"]
    assert engine.loop_replays == c["loop_iterations"] == c["decode_steps"]


def test_launch_counters_count_replays(cuda):
    from torchdistx_tpu_torch.serve import ServeEngine

    model = _graph_llama(cuda)
    engine = ServeEngine(model, num_slots=3, max_len=64, prefill_buckets=(32,),
                         decode_mode="persistent")
    engine.run(_graph_requests(4))  # captures the graph
    before = tdec.decode_attention_cuda.launches, tflash.flash_fwd_cuda.launches
    steps, prefills = (engine.metrics.counters[k] for k in ("decode_steps", "prefill_calls"))
    engine.run(_graph_requests())
    torch.cuda.synchronize()
    steps = engine.metrics.counters["decode_steps"] - steps
    prefills = engine.metrics.counters["prefill_calls"] - prefills
    n = model.cfg.n_layers
    assert steps > 0
    assert tdec.decode_attention_cuda.launches - before[0] == n * steps
    assert tflash.flash_fwd_cuda.launches - before[1] == n * prefills


def test_a_body_that_syncs_fails_to_capture(cuda):
    """Capture of an iteration that reads back (``.item()``) raises, and
    nothing runs in its place: no replay, the state as it was."""
    from torchdistx_tpu_torch.serve.graph_loop import GraphLoop

    cursor = torch.zeros(1, dtype=torch.int64, device=cuda)
    done = torch.zeros(1, dtype=torch.bool, device=cuda)
    x = torch.zeros(4, device=cuda)

    def body():
        x.add_((cursor < 8).float())
        cursor.add_((cursor < 8).long())
        done.fill_(x.sum().item() > 100)

    loop = GraphLoop(cursor=cursor, capacity=8, done=done)
    before = tdec.decode_attention_cuda.launches
    with pytest.raises(RuntimeError):
        loop.run(body, 3, 3)
    torch.cuda.synchronize()
    assert loop.graph is None and loop.replays == 0
    assert int(cursor.item()) == 0 and not bool(done.item())
    assert torch.equal(x, torch.zeros_like(x))
    assert tdec.decode_attention_cuda.launches == before


def test_exchange_over_gloo_stages_cuda_tensors_through_the_host(cuda, tmp_path):
    """Two ranks on one card over ``gloo``, whose sends take no device
    address: ``exchange``, ``shift`` and GossipGraD's hook stage CUDA
    tensors through pinned host buffers and give the peer's values on the
    card, bf16 kept; the staged bytes are those sent plus received."""
    import numpy as np

    from _torch_dist_worker import gossip_grads, spawn_world

    res = [r["staged_on_the_card"]
           for r in spawn_world("gossip", tmp_path, {"part": "cuda"}, world=2)]
    for r in res:
        assert "error" not in r, r["error"]
    grads = gossip_grads("cube_2x2", 2)
    for rank, r in enumerate(res):
        peer = 1 - rank
        assert r["devices"] == ["cuda:0"] and r["dtype_c"] == "torch.bfloat16"
        assert r["staged"] == 2 * r["tree_bytes"]
        for k in ("a", "b"):
            np.testing.assert_array_equal(r["out"][k], grads[k][peer])
            np.testing.assert_allclose(r["hooked"][k], (grads[k][rank] + grads[k][peer]) * 0.5,
                                       rtol=1e-6)
        np.testing.assert_array_equal(r["out"]["c"].astype(np.float32), np.full(5, peer + 1.0))
        np.testing.assert_array_equal(r["shifted"], grads["a"][peer])
