"""The port's four decode-attention wrappers against the JAX package's Pallas
kernels, on the CPU.

On CPU tensors the wrappers run their plain versions (``_slot_attend`` /
``_slot_attend_block`` over the slab, the page-table gather, or the
dequantized view); the JAX side runs ``decode_attention``,
``decode_attention_block``, ``paged_decode_attention`` and
``paged_decode_attention_block`` in interpret mode, bf16 and int8 (the
same int8 data and scales fed to both).  The inputs come from numpy with a
seed.

Tolerance: f32 1e-5 absolute (the kernels' online softmax sums in another
order, a few f32 ulps); bf16 2e-2 (bf16 rounding of the probabilities and
the output at different places).

The kernel's algorithm for one token and for the verify block (its key
range split at ``block_splits``' boundaries, each split's (m, l, acc)
merged in split order) has a plain version of its own, held here against
the same JAX kernels at depths on the split edges and one key either
side.
"""

import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import jax.numpy as jnp
from torchdistx_tpu.ops import decode_attention as jda
from torchdistx_tpu_torch.ops import decode_attention as da

TOL = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _quantize_np(x):
    """The int8 cache both sides read: JAX's ``quantize_kv`` of ``x``."""
    from torchdistx_tpu.serve.kv_cache import quantize_kv

    q, s = quantize_kv(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


def _operands(seed, q_shape, kv_shape, dtype, quant):
    """numpy q and K/V (or int8 K/V plus scales), and both sides' views."""
    rs = np.random.RandomState(seed)
    _, jdt, tdt = DTYPES[dtype]
    q = rs.standard_normal(q_shape).astype(np.float32)
    k = rs.standard_normal(kv_shape).astype(np.float32)
    v = rs.standard_normal(kv_shape).astype(np.float32)
    jq, tq = jnp.asarray(q, jdt), torch.tensor(q).to(tdt)
    if quant:
        (kq, ks), (vq, vs) = _quantize_np(k), _quantize_np(v)
        jkv = [jnp.asarray(a) for a in (kq, vq)]
        tkv = [torch.tensor(a) for a in (kq, vq)]
        jsc = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tsc = dict(k_scale=torch.tensor(ks), v_scale=torch.tensor(vs))
    else:
        jkv = [jnp.asarray(a, jdt) for a in (k, v)]
        tkv = [torch.tensor(a).to(tdt) for a in (k, v)]
        jsc, tsc = {}, {}
    return (jq, jkv, jsc), (tq, tkv, tsc)


def _tables(seed, b, pp, num_pages):
    """Shuffled page tables over pages 1..num_pages-1; slot 1 shares slot
    0's first page (a common prefix)."""
    rs = np.random.RandomState(seed + 1)
    t = (rs.permutation(num_pages - 1)[: b * pp] + 1).reshape(b, pp)
    if b > 1:
        t[1, 0] = t[0, 0]
    return t.astype(np.int32)


def _check(out, ref, dtype):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,max_len,block_k",
                         [(4, 4, 64, 512), (4, 2, 64, 16), (8, 2, 48, 512),
                          (16, 1, 32, 8)])
def test_decode_attention(hq, hkv, max_len, block_k, dtype, quant):
    b, d = 3, 16
    pos = np.array([0, max_len // 2, max_len - 1], np.int32)
    (jq, jkv, jsc), (tq, tkv, tsc) = _operands(
        hq * max_len, (b, 1, hq, d), (b, max_len, hkv, d), dtype, quant)
    ref = jda.decode_attention(jq, *jkv, jnp.asarray(pos), block_k=block_k,
                               interpret=True, **jsc)
    out = da.decode_attention(tq, *tkv, torch.tensor(pos), **tsc)
    assert out.dtype == tq.dtype and out.shape == (b, 1, hq, d)
    _check(out, ref, dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hq,hkv,max_len,block_k",
                         [(2, 4, 2, 32, 512), (5, 4, 2, 64, 16),
                          (5, 8, 2, 48, 512), (3, 4, 4, 32, 8)])
def test_decode_attention_block(s, hq, hkv, max_len, block_k, dtype, quant):
    b, d = 3, 16
    # the last slot's rows run past max_len: dropped, not attended
    pos = np.array([0, max_len // 2 - 1, max_len - 2], np.int32)
    (jq, jkv, jsc), (tq, tkv, tsc) = _operands(
        s * hq + max_len, (b, s, hq, d), (b, max_len, hkv, d), dtype, quant)
    ref = jda.decode_attention_block(jq, *jkv, jnp.asarray(pos),
                                     block_k=block_k, interpret=True, **jsc)
    out = da.decode_attention_block(tq, *tkv, torch.tensor(pos), **tsc)
    assert out.shape == (b, s, hq, d)
    _check(out, ref, dtype)


def test_block_row_zero_is_the_one_token_call():
    """Row 0 of the verify block is the one-token call, to f32 rounding:
    the CPU matrix product sums in another order for another batch shape."""
    (_, _, _), (tq, tkv, _) = _operands(3, (2, 4, 8, 16), (2, 32, 2, 16),
                                        "float32", False)
    pos = torch.tensor([5, 31])
    block = da.decode_attention_block(tq, *tkv, pos)
    one = da.decode_attention(tq[:, :1], *tkv, pos)
    torch.testing.assert_close(block[:, :1], one, atol=1e-6, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,pp,ps", [(4, 2, 4, 16), (8, 2, 8, 4),
                                          (4, 4, 2, 8), (16, 1, 1, 16)])
def test_paged_decode_attention(hq, hkv, pp, ps, dtype, quant):
    b, d = 3, 16
    num_pages = b * pp + 2
    pos = np.array([0, ps, pp * ps - 1], np.int32)  # a page boundary, the end
    (jq, jkv, jsc), (tq, tkv, tsc) = _operands(
        hq * ps + pp, (b, 1, hq, d), (num_pages, ps, hkv, d), dtype, quant)
    tables = _tables(ps, b, pp, num_pages)
    ref = jda.paged_decode_attention(jq, *jkv, jnp.asarray(tables),
                                     jnp.asarray(pos), interpret=True, **jsc)
    out = da.paged_decode_attention(tq, *tkv, torch.tensor(tables),
                                    torch.tensor(pos), **tsc)
    assert out.shape == (b, 1, hq, d)
    _check(out, ref, dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hq,hkv,pp,ps", [(5, 4, 2, 4, 16), (2, 8, 2, 8, 4),
                                            (5, 4, 4, 2, 8)])
def test_paged_decode_attention_block(s, hq, hkv, pp, ps, dtype, quant):
    b, d = 3, 16
    num_pages = b * pp + 2
    # slot 2's rows run past pages_per_slot * page_size
    pos = np.array([0, ps - 1, pp * ps - 2], np.int32)
    (jq, jkv, jsc), (tq, tkv, tsc) = _operands(
        s * ps + pp, (b, s, hq, d), (num_pages, ps, hkv, d), dtype, quant)
    tables = _tables(s + ps, b, pp, num_pages)
    ref = jda.paged_decode_attention_block(jq, *jkv, jnp.asarray(tables),
                                           jnp.asarray(pos), interpret=True,
                                           **jsc)
    out = da.paged_decode_attention_block(tq, *tkv, torch.tensor(tables),
                                          torch.tensor(pos), **tsc)
    assert out.shape == (b, s, hq, d)
    _check(out, ref, dtype)


def test_paged_equals_slab_on_the_gathered_rows():
    """The paged plain version over a page table gives the slab version's
    output on the gathered rows bit for bit (one body, only the address of
    a key row differs)."""
    b, s, hq, hkv, d, pp, ps = 2, 5, 4, 2, 16, 4, 8
    (_, _, _), (tq, tkv, _) = _operands(11, (b, s, hq, d), (b * pp + 1, ps, hkv, d),
                                        "float32", False)
    tables = torch.tensor(_tables(4, b, pp, b * pp + 1))
    pos = torch.tensor([3, 29])
    from torchdistx_tpu_torch.ops.attention import _paged_gather

    slab = [_paged_gather(t, tables) for t in tkv]
    torch.testing.assert_close(
        da.paged_decode_attention_block(tq, *tkv, tables, pos),
        da.decode_attention_block(tq, *slab, pos), atol=0, rtol=0)
    torch.testing.assert_close(
        da.paged_decode_attention(tq[:, :1], *tkv, tables, pos),
        da.decode_attention(tq[:, :1], *slab, pos), atol=0, rtol=0)


def test_wrappers_check_scales():
    (_, _, _), (tq, tkv, _) = _operands(0, (1, 1, 4, 16), (1, 8, 2, 16),
                                        "float32", False)
    pos = torch.tensor([3])
    with pytest.raises(ValueError, match="together"):
        da.decode_attention(tq, *tkv, pos, k_scale=torch.ones(1, 8, 2, 1))
    with pytest.raises(ValueError, match="scale shapes"):
        da.decode_attention(tq, *tkv, pos, k_scale=torch.ones(1, 8, 2, 16),
                            v_scale=torch.ones(1, 8, 2, 16))
    with pytest.raises(ValueError, match="one token"):
        da.decode_attention(torch.zeros(1, 2, 4, 16), *tkv, pos)


# (s, hq, hkv, max_len, split): splits of 16 keys over 64- and 72-row caches
# (the last split short), and the kernel's own SPLIT_KEYS over 600 rows
SPLIT_CASES = [(5, 4, 2, 64, 16), (2, 8, 2, 72, 16), (3, 4, 4, 600, da.SPLIT_KEYS)]


def _edge_positions(s, split, max_len):
    """Base depths putting a slot's deepest row (pos + s - 1) one before, on
    and one past a split's first key, and the last row at max_len - 1."""
    lasts = [split - 1, split, split + 1, 2 * split - 1, max_len - 1]
    return np.array([max(x - s + 1, 0) for x in lasts], np.int32)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hq,hkv,max_len,split", SPLIT_CASES)
def test_block_split_reference_matches_jax(s, hq, hkv, max_len, split, dtype, quant):
    """The plain split-and-combine against ``decode_attention_block`` in
    interpret mode, at the module's tolerances: in f32 1e-5, since merging
    the splits' (m, l, acc) only reorders the softmax's f32 sums; in bf16
    2e-2, the output's and the probabilities' bf16 rounding (the JAX kernel
    rounds P before P.V, the plain version keeps it f32)."""
    d = 16
    pos = _edge_positions(s, split, max_len)
    b = len(pos)
    (jq, jkv, jsc), (tq, tkv, tsc) = _operands(
        split + max_len + s, (b, s, hq, d), (b, max_len, hkv, d), dtype, quant)
    ref = jda.decode_attention_block(jq, *jkv, jnp.asarray(pos), block_k=16,
                                     interpret=True, **jsc)
    out = da.decode_attention_block_split_reference(tq, *tkv, torch.tensor(pos),
                                                    split_keys=split, **tsc)
    assert out.dtype == tq.dtype and out.shape == (b, s, hq, d)
    _check(out, ref, dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,hq,hkv,pp,ps,split", [(5, 4, 2, 8, 8, 16), (4, 8, 2, 9, 4, 8)])
def test_paged_block_split_reference_matches_jax(s, hq, hkv, pp, ps, split, dtype, quant):
    """The paged plain split-and-combine against
    ``paged_decode_attention_block`` in interpret mode, split edges +-1."""
    d = 16
    pos = _edge_positions(s, split, pp * ps)
    b = len(pos)
    num_pages = b * pp + 2
    (jq, jkv, jsc), (tq, tkv, tsc) = _operands(
        split * ps + s, (b, s, hq, d), (num_pages, ps, hkv, d), dtype, quant)
    tables = _tables(split + pp, b, pp, num_pages)
    ref = jda.paged_decode_attention_block(jq, *jkv, jnp.asarray(tables),
                                           jnp.asarray(pos), interpret=True, **jsc)
    out = da.paged_decode_attention_block_split_reference(
        tq, *tkv, torch.tensor(tables), torch.tensor(pos), split_keys=split, **tsc)
    assert out.shape == (b, s, hq, d)
    _check(out, ref, dtype)


# (hq, hkv, max_len, split): one token a slot through the kernel's split
# algorithm; n_rep 2, 8 and 16 (more than the 8 the one-token kernel took
# before it shared the verify's body)
ONE_TOKEN_SPLIT_CASES = [(4, 2, 64, 16), (8, 1, 72, 16), (16, 1, 40, 8)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,max_len,split", ONE_TOKEN_SPLIT_CASES)
def test_one_token_split_reference_matches_jax(hq, hkv, max_len, split, dtype, quant):
    """The plain split-and-combine at S = 1, the one-token decode's
    algorithm since it runs the verify block's kernel, against
    ``decode_attention`` in interpret mode at depths on a split edge and
    one key either side and at the cache's end, at the module's
    tolerances (in bf16 the JAX kernel rounds P before P.V, the plain
    version keeps it f32)."""
    d = 16
    pos = _edge_positions(1, split, max_len)
    b = len(pos)
    (jq, jkv, jsc), (tq, tkv, tsc) = _operands(
        split + max_len + hq, (b, 1, hq, d), (b, max_len, hkv, d), dtype, quant)
    ref = jda.decode_attention(jq, *jkv, jnp.asarray(pos), block_k=16, interpret=True,
                               **jsc)
    out = da.decode_attention_block_split_reference(tq, *tkv, torch.tensor(pos),
                                                    split_keys=split, **tsc)
    assert out.dtype == tq.dtype and out.shape == (b, 1, hq, d)
    _check(out, ref, dtype)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16cache", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,pp,ps,split", [(4, 2, 8, 8, 16), (8, 2, 9, 4, 8)])
def test_paged_one_token_split_reference_matches_jax(hq, hkv, pp, ps, split, dtype, quant):
    """The paged plain split-and-combine at S = 1 against
    ``paged_decode_attention`` in interpret mode, split edges +-1."""
    d = 16
    pos = _edge_positions(1, split, pp * ps)
    b = len(pos)
    num_pages = b * pp + 2
    (jq, jkv, jsc), (tq, tkv, tsc) = _operands(
        split * ps + hq, (b, 1, hq, d), (num_pages, ps, hkv, d), dtype, quant)
    tables = _tables(split + ps, b, pp, num_pages)
    ref = jda.paged_decode_attention(jq, *jkv, jnp.asarray(tables), jnp.asarray(pos),
                                     interpret=True, **jsc)
    out = da.paged_decode_attention_block_split_reference(
        tq, *tkv, torch.tensor(tables), torch.tensor(pos), split_keys=split, **tsc)
    assert out.shape == (b, 1, hq, d)
    _check(out, ref, dtype)


@pytest.mark.parametrize("split", [64, da.SPLIT_KEYS])
def test_block_splits_cover_every_visible_key_once(split):
    """Each slot depth's splits tile keys 0..last in order, without a gap
    or an overlap, in whole 64-key tiles but the last, and depend on the
    key index alone: a slot's splits are the same whatever the cache's
    length, so the slab and any page layout over it split alike."""
    for last in [0, 1, 63, 64, split - 1, split, split + 1, 3 * split + 7, 2047]:
        splits = da.block_splits(last, split)
        assert splits[0][0] == 0 and splits[-1][1] == last + 1
        assert all(a[1] == b[0] for a, b in zip(splits, splits[1:]))
        assert all(lo % 64 == 0 and lo % split == 0 for lo, _ in splits)
        assert all(hi - lo == split for lo, hi in splits[:-1])
        keys = [j for lo, hi in splits for j in range(lo, hi)]
        assert keys == list(range(last + 1))
        # a deeper slot's splits start with the same boundaries
        assert da.block_splits(last + split, split)[: len(splits) - 1] == splits[:-1]
    # the kernel's grid: every split of the deepest slot of a cache
    for max_len in (1, 256, 257, 2048, 8192):
        assert len(da.block_splits(max_len - 1)) == -(-max_len // da.SPLIT_KEYS)


@pytest.mark.parametrize("ps", [1, 8, 16])
def test_paged_split_reference_equals_slab(ps):
    """Over page tables the split plain version gives the slab one's output
    on the gathered rows bit for bit, at split edges +-1."""
    from torchdistx_tpu_torch.ops.attention import _paged_gather

    b, s, hq, hkv, d, pp, split = 5, 5, 4, 2, 16, 96 // ps, 32
    pos = torch.tensor(_edge_positions(s, split, pp * ps))
    (_, _, _), (tq, tkv, _) = _operands(ps, (b, s, hq, d), (b * pp + 1, ps, hkv, d),
                                        "float32", False)
    tables = torch.tensor(_tables(ps, b, pp, b * pp + 1))
    slab = [_paged_gather(t, tables) for t in tkv]
    torch.testing.assert_close(
        da.paged_decode_attention_block_split_reference(tq, *tkv, tables, pos,
                                                        split_keys=split),
        da.decode_attention_block_split_reference(tq, *slab, pos, split_keys=split),
        atol=0, rtol=0)
