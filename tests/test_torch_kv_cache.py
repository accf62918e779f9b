"""The port's KV-cache helpers against the JAX package's, on the CPU.

``quantize_kv`` must equal JAX's bit for bit (int8 data and power-of-two
scales), zero rows and exact powers of two included.  The multi-token
scatters and the paged gathers and scatters must give the same arrays,
rows past the cache end dropped (never clamped onto the last row, never
wrapped into the next slot).  The port writes in place, so it is handed a
copy.
"""

import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import jax.numpy as jnp
import torchdistx_tpu as tdx
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.serve import kv_cache as jkc
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.serve import kv_cache as tkc


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _rows(seed, shape):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal(shape).astype(np.float32) * rs.choice([1e-3, 1.0, 40.0], shape[:-1])[..., None]
    x[0, 0, 0] = 0.0  # an all-zero row: scale 0.5
    x[0, 1, 0] = 0.0
    x[0, 1, 0, 3] = 127.0 * 2.0 ** -3  # amax / 127 an exact power of two
    x[0, 2, 0] = 2.0 ** np.arange(x.shape[-1]) / 2.0 ** 6  # powers of two
    x[0, 2, 1, :2] = [0.5, -0.5]  # ties under the rounding
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_identical(dtype):
    x = _rows(0, (2, 6, 3, 16))
    jq, js = jkc.quantize_kv(jnp.asarray(x, getattr(jnp, dtype)))
    tq, ts = tkc.quantize_kv(torch.tensor(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (2, 6, 3, 1)
    _eq(tq, jq)
    _eq(ts, js)
    assert float(ts[0, 0, 0, 0]) == 0.5
    _eq(tkc.dequantize_kv(tq, ts), jkc.dequantize_kv(jq, js))


def test_requantize_is_idempotent():
    q, s = tkc.quantize_kv(torch.tensor(_rows(1, (1, 8, 2, 16))))
    deq = tkc.dequantize_kv(q, s)
    q2, s2 = tkc.quantize_kv(deq)
    torch.testing.assert_close(tkc.dequantize_kv(q2, s2), deq, atol=0, rtol=0)


def test_canonicalize_kv_dtype():
    assert tkc.canonicalize_kv_dtype(None) is None
    for name in ("int8", "bfloat16", "float16", "float32"):
        assert tkc.canonicalize_kv_dtype(name) == jkc.canonicalize_kv_dtype(name)
    assert tkc.canonicalize_kv_dtype(torch.bfloat16) == "bfloat16"
    assert tkc.canonicalize_kv_dtype(np.float32) == "float32"
    with pytest.raises(ValueError, match="kv_dtype"):
        tkc.canonicalize_kv_dtype("int4")


@pytest.mark.parametrize("s,positions", [(1, (0, 7, 15)), (5, (0, 9, 14)),
                                         (4, (15, 12, 3))])
def test_scatter_slot_tokens_drops_past_max_len(s, positions):
    rs = np.random.RandomState(s)
    cache = rs.standard_normal((3, 16, 2, 4)).astype(np.float32)
    x = rs.standard_normal((3, s, 2, 4)).astype(np.float32)
    pos = np.array(positions, np.int32)
    ref = jkc.scatter_slot_tokens(jnp.asarray(cache), jnp.asarray(x), jnp.asarray(pos))
    out = tkc.scatter_slot_tokens(torch.tensor(cache), torch.tensor(x), torch.tensor(pos))
    _eq(out, ref)
    # int8 data and f32 scales ride the same rows
    (qx, sx), (qc, sc) = tkc.quantize_kv(torch.tensor(x)), tkc.quantize_kv(torch.tensor(cache))
    for c, v in ((qc, qx), (sc, sx)):
        ref = jkc.scatter_slot_tokens(jnp.asarray(c.numpy()), jnp.asarray(v.numpy()),
                                      jnp.asarray(pos))
        _eq(tkc.scatter_slot_tokens(c.clone(), v, torch.tensor(pos)), ref)


def test_scatter_out_of_range_depth_writes_nothing():
    cache = torch.arange(2 * 8 * 1 * 2, dtype=torch.float32).view(2, 8, 1, 2)
    out = tkc.scatter_slot_tokens(cache.clone(), torch.full((2, 3, 1, 2), -1.0),
                                  torch.tensor([8, 6]))
    torch.testing.assert_close(out[0], cache[0], atol=0, rtol=0)
    assert (out[1, 6:] == -1).all() and torch.equal(out[1, :6], cache[1, :6])


def _pools_and_tables(seed, num_pages=12, ps=4, b=3, pp=3):
    rs = np.random.RandomState(seed)
    pool = rs.standard_normal((num_pages, ps, 2, 4)).astype(np.float32)
    # distinct pages per slot, shuffled; entries past a chain name page 0
    tables = (rs.permutation(num_pages - 1)[: b * pp] + 1).reshape(b, pp).astype(np.int32)
    return pool, tables


@pytest.mark.parametrize("s,positions", [(1, (0, 4, 11)), (5, (0, 7, 10)),
                                         (3, (11, 9, 2))])
def test_paged_scatter_tokens_drops_past_the_table(s, positions):
    pool, tables = _pools_and_tables(s)
    x = np.random.RandomState(s + 9).standard_normal((3, s, 2, 4)).astype(np.float32)
    pos = np.array(positions, np.int32)
    ref = jkc.paged_scatter_tokens(jnp.asarray(pool), jnp.asarray(x),
                                   jnp.asarray(tables), jnp.asarray(pos), 4)
    out = tkc.paged_scatter_tokens(torch.tensor(pool), torch.tensor(x),
                                   torch.tensor(tables), torch.tensor(pos), 4)
    _eq(out, ref)


def _quant_pools(pool):
    q, s = tkc.quantize_kv(torch.tensor(pool))
    q2, s2 = tkc.quantize_kv(torch.tensor(pool) * 0.5)
    return [(q, q2, s, s2)]


@pytest.mark.parametrize("quant", [False, True])
def test_paged_view_and_scatter_rows(quant):
    pool, tables = _pools_and_tables(3)
    if quant:
        tkv = _quant_pools(pool)
    else:
        tkv = [(torch.tensor(pool), torch.tensor(pool) * 0.5)]
    jkv = [tuple(jnp.asarray(t.numpy()) for t in e) for e in tkv]
    row = tables[1].copy()
    row[2] = 0  # an unassigned entry names the scratch page
    tview = tkc.paged_view(tkv, torch.tensor(row), 4)
    jview = jkc.paged_view(jkv, jnp.asarray(row), 4)
    for (tk, tv), (jk, jv) in zip(tview, jview):
        assert tk.shape == (1, 12, 2, 4)
        _eq(tk, jk)
        _eq(tv, jv)
    # an updated view: rows [start, start + length) go back through the table
    upd = [(k + 1.0, v - 1.0) for k, v in tview]
    jupd = [(jnp.asarray(k.numpy()), jnp.asarray(v.numpy())) for k, v in upd]
    for start, length in ((4, 8), (0, 4), (2, 6)):
        tout = tkc.paged_scatter_rows([tuple(t.clone() for t in e) for e in tkv],
                                      upd, torch.tensor(row), 4, start, length)
        jout = jkc.paged_scatter_rows(jkv, jupd, jnp.asarray(row), 4, start, length)
        for te, je in zip(tout, jout):
            for t, j in zip(te, je):
                _eq(t, j)


def test_write_slot_quantizes_into_the_slot():
    rs = np.random.RandomState(4)
    slab = [(rs.standard_normal((1, 6, 2, 4)).astype(np.float32),
             rs.standard_normal((1, 6, 2, 4)).astype(np.float32))]
    base = [(np.zeros((3, 8, 2, 4), np.float32),) * 2]
    tkv = tkc.quantize_cache([tuple(torch.tensor(a) for a in e) for e in base])
    jkv = jkc.quantize_cache([tuple(jnp.asarray(a) for a in e) for e in base])
    tout = tkc.write_slot(tkv, [tuple(torch.tensor(a) for a in e) for e in slab], 2)
    jout = jkc.write_slot(jkv, [tuple(jnp.asarray(a) for a in e) for e in slab], 2)
    for t, j in zip(tout[0], jout[0]):
        _eq(t, j)
    for t, j in zip(tkc.dequantize_cache(tout)[0], jkc.dequantize_cache(jout)[0]):
        _eq(t, j)


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(0)
    jm = JLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64)
    tm = TLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64, device="cpu")
    return jm, tm


@pytest.mark.parametrize("kv_dtype", [None, "int8", "bfloat16"])
def test_cache_bytes_equal_jax(models, kv_dtype):
    jm, tm = models
    j = jkc.PagedKVCache(jm, 2, 32, 8, 9, kv_dtype=kv_dtype)
    t = tkc.PagedKVCache(tm, 2, 32, 8, 9, kv_dtype=kv_dtype)
    assert (t.nbytes, t.kv_data_nbytes, t.kv_scale_nbytes) == (
        j.nbytes, j.kv_data_nbytes, j.kv_scale_nbytes)
    js, ts = jkc.SlotKVCache(jm, 2, 32, kv_dtype=kv_dtype), tkc.SlotKVCache(tm, 2, 32, kv_dtype=kv_dtype)
    assert (ts.nbytes, ts.quantized) == (js.nbytes, js.quantized)


def test_int8_cache_halves_the_data(models):
    _, tm = models
    full = tkc.SlotKVCache(tm, 2, 32, kv_dtype="bfloat16")
    q = tkc.SlotKVCache(tm, 2, 32, kv_dtype="int8")
    assert q.kv_data_nbytes * 2 == full.kv_data_nbytes
    # the scales add 4 bytes per D bytes of int8 data: at D = 128 the whole
    # cache is 0.5 * (1 + 4 / 128) = 0.516 of the bf16 one
    assert q.kv_scale_nbytes * tm.cfg.head_dim == 4 * q.kv_data_nbytes
    assert q.nbytes == q.kv_data_nbytes + q.kv_scale_nbytes


def test_paged_cache_tables(models):
    _, tm = models
    c = tkc.PagedKVCache(tm, 2, 32, 8, 9)
    assert c.page_tables.shape == (2, 4) and (c.page_tables == 0).all()
    c.set_table(1, [3, 5])
    assert list(c.page_tables[1]) == [3, 5, 0, 0]
    c.admit(1, 10)
    c.retire(1)
    assert not c.active[1] and (c.page_tables[1] == 0).all()
    with pytest.raises(ValueError, match="pages_per_slot"):
        c.set_table(0, [1] * 5)
    with pytest.raises(ValueError, match="multiple of page_size"):
        tkc.PagedKVCache(tm, 2, 30, 8, 9)
    with pytest.raises(ValueError, match="num_pages"):
        tkc.PagedKVCache(tm, 2, 32, 8, 1)
