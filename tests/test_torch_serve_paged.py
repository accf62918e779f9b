"""The port's ``ServeEngine`` with the paged cache, the prefix cache,
self-speculative decode and the int8 cache, against the JAX package's
engine on the CPU.

Tiny f32 Llama (GQA), the JAX model's weights carried into the port.
Greedy token streams and finish reasons must be EQUAL to the JAX engine's,
and so must the counters the features move: ``prefix_hit_tokens``,
``pages_evicted``, ``tokens_prefilled``, ``decode_steps`` and the draft
economy.  Chunked decode here; the persistent mode's paged, speculative
and int8 runs are held in ``tests/test_torch_serve_persistent.py``.  The
JAX engine's own failures of this tree are in tests whose EOS premise no
stream here depends on.
"""

import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.serve import ServeEngine as JServeEngine
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.serve import ServeEngine

EOS = 78
COUNTERS = ("prefix_hit_tokens", "pages_evicted", "tokens_prefilled",
            "decode_steps", "prefill_calls", "tokens_generated",
            "draft_tokens_proposed", "draft_tokens_accepted",
            "spec_rejected_lane_steps", "admissions_rejected_pages",
            "masked_slot_steps")


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(0)
    jm = JLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64)
    tm = TLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64, device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


def _shared_prefix_requests(seed, tails=(3, 7, 2, 9, 5, 12), max_new=8):
    """One system prompt of 13 tokens plus a different tail per request."""
    rs = np.random.RandomState(seed)
    system = rs.randint(0, 256, 13)
    return [{"prompt": np.concatenate([system, rs.randint(0, 256, n)]).astype(np.int32),
             "max_new_tokens": max_new} for n in tails]


def _cyclic_requests(max_new=24):
    """Prompts whose greedy continuations enter short cycles: the repetition
    prompt-lookup drafting feeds on."""
    prompts = ([3, 1, 2, 3, 1, 2, 3], [9, 9, 9, 9], [5, 7, 5, 7, 5])
    return [{"prompt": np.array(p, np.int32), "max_new_tokens": max_new}
            for p in prompts]


def _both(models, reqs, passes=1, **kw):
    """Run ``reqs`` ``passes`` times through one engine of each side."""
    jm, tm = models
    kw = dict(dict(num_slots=2, max_len=64, prefill_buckets=(16, 32),
                   eos_token=EOS), **kw)
    je, te = JServeEngine(jm, **kw), ServeEngine(tm, **kw)
    ref = [r for _ in range(passes) for r in je.run(reqs)]
    out = [r for _ in range(passes) for r in te.run(reqs)]
    return je, te, ref, out


def _assert_same(je, te, ref, out):
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.tokens, r.tokens)
        assert o.finish_reason == r.finish_reason
    jc, tc = je.metrics.counters, te.metrics.counters
    assert {k: tc[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}


@pytest.mark.parametrize("page_size,decode_chunk", [(4, 1), (8, 3)])
def test_paged_prefix_warm_pass(models, page_size, decode_chunk):
    reqs = _shared_prefix_requests(page_size)
    je, te, ref, out = _both(models, reqs, passes=2, page_size=page_size,
                             decode_chunk=decode_chunk)
    _assert_same(je, te, ref, out)
    c = te.metrics.counters
    assert c["prefix_hit_tokens"] > 0
    assert te.pool.in_use == je.pool.in_use and len(te.prefix_index) == len(je.prefix_index)


def test_paged_streams_equal_slab_streams(models):
    _, tm = models
    reqs = _shared_prefix_requests(5)
    kw = dict(num_slots=3, max_len=64, prefill_buckets=(16, 32), eos_token=EOS)
    slab = ServeEngine(tm, **kw).run(reqs)
    paged = ServeEngine(tm, page_size=8, prefix_cache=False, **kw).run(reqs)
    for a, b in zip(slab, paged):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_eviction_under_pool_pressure(models):
    reqs = _shared_prefix_requests(3, tails=(3, 18, 2, 9, 14, 5, 11), max_new=10)
    je, te, ref, out = _both(models, reqs, passes=2, page_size=8, num_pages=10)
    _assert_same(je, te, ref, out)
    assert te.metrics.counters["pages_evicted"] > 0
    assert te.metrics.counters["admissions_rejected_pages"] > 0


@pytest.mark.parametrize("speculate,decode_chunk", [(2, 1), (4, 2)])
def test_speculative(models, speculate, decode_chunk):
    reqs = _cyclic_requests() + _shared_prefix_requests(7, tails=(2, 6))
    je, te, ref, out = _both(models, reqs, speculate=speculate,
                             decode_chunk=decode_chunk)
    _assert_same(je, te, ref, out)
    c = te.metrics.counters
    assert c["draft_tokens_accepted"] > 0
    assert c["tokens_generated"] > c["decode_steps"]  # > 1 token per verify
    # greedy speculation is lossless: the speculate=0 engine's streams
    _, tm = models
    base = ServeEngine(tm, num_slots=2, max_len=64, prefill_buckets=(16, 32),
                       eos_token=EOS).run(reqs)
    for a, b in zip(base, out):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_speculative_sampled_rows_keep_one_token_per_iteration(models):
    _, tm = models
    reqs = [dict(r, temperature=0.9, seed=5 + i) for i, r in enumerate(_cyclic_requests())]
    kw = dict(num_slots=3, max_len=64, prefill_buckets=(16,))
    base = ServeEngine(tm, **kw).run(reqs)
    spec = ServeEngine(tm, speculate=3, **kw)
    out = spec.run(reqs)
    for a, b in zip(base, out):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert spec.metrics.counters["draft_tokens_accepted"] == 0


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"),
                                dict(kv_dtype="int8", page_size=8),
                                dict(page_size=4, speculate=4, kv_dtype="int8")],
                         ids=["slab-int8", "paged-int8", "paged-spec-int8"])
def test_int8_cache(models, kw):
    reqs = _cyclic_requests() + _shared_prefix_requests(9, tails=(3, 8, 5))
    je, te, ref, out = _both(models, reqs, passes=2, **kw)
    _assert_same(je, te, ref, out)
    assert te.kv_quantized and te.cache.kv_data_nbytes == je.cache.kv_data_nbytes
    assert te.metrics.to_json()["gauges"]["kv_cache_bytes"] == te.cache.nbytes


def test_paged_submit_rejects_unservable_footprint(models):
    _, tm = models
    engine = ServeEngine(tm, num_slots=1, max_len=64, page_size=8, num_pages=4)
    with pytest.raises(ValueError, match="allocatable pages"):
        engine.submit(np.arange(20), max_new_tokens=8)
    with pytest.raises(ValueError, match="num_pages requires page_size"):
        ServeEngine(tm, max_len=64, num_pages=4)


def test_finished_requests_release_their_pages(models):
    _, tm = models
    engine = ServeEngine(tm, num_slots=2, max_len=64, page_size=8,
                         prefill_buckets=(16, 32))
    engine.run(_shared_prefix_requests(2, tails=(3, 9, 4)))
    # only the prefix index still holds pages: every table names scratch
    assert engine.pool.in_use == len(engine.prefix_index)
    assert (engine.cache.page_tables == 0).all()
    assert engine.metrics.to_json()["gauges"]["pages_in_use"] == engine.pool.in_use


def test_decode_dispatch_carries_no_host_sync_per_token(models):
    """One host sync per dispatch, whatever the features: speculation
    multiplies the tokens per sync, it never adds one."""
    _, tm = models
    engine = ServeEngine(tm, num_slots=2, max_len=64, prefill_buckets=(16,),
                         page_size=4, speculate=3, decode_chunk=2)
    engine.run(_cyclic_requests(max_new=20))
    c = engine.metrics.counters
    assert c["host_syncs"] == c["prefill_calls"] + c["decode_dispatches"]
    assert (c["draft_tokens_accepted"] + c["spec_rejected_lane_steps"]
            == c["draft_tokens_proposed"])
    assert torch.is_tensor(engine.cache.kv[0][0])
