"""The port's chunked prefill and HBM admission gate against the JAX
package's engine on the CPU.

Tiny f32 Llama, the JAX model's weights carried into the port.  The
scenario is the JAX suite's (``tests/test_serve.py::TestChunkedPrefill``):
two short requests decoding, then a 40-token prompt chunked at 16 with
decode dispatches interleaved.  Token streams, finish reasons, the
counters and the long request's prefill lifecycle events must be EQUAL to
the JAX engine's (integers: no tolerance), and the chunked streams equal
to the same port engine without chunking.  On the CPU both the first
chunk and the mid-cache chunks run the plain path, so the JAX
bit-identity contract holds here as written.
"""

import numpy as np
import pytest
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.serve import ServeEngine as JServeEngine
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.serve import ServeEngine

COUNTERS = ("chunked_prefills", "prefill_chunks", "prefill_interleaved_dispatches",
            "tokens_prefilled", "tokens_generated", "decode_steps",
            "decode_dispatches", "host_syncs", "masked_slot_steps",
            "prefill_calls", "prefix_hit_tokens", "loop_iterations",
            "ring_drains", "draft_tokens_accepted", "admissions_rejected_hbm",
            "admissions_rejected_pages")


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(0)
    jm = JLlama.from_name("tiny", max_seq_len=64)
    tm = TLlama.from_name("tiny", max_seq_len=64, device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


def _prompts(seed, lengths):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (n,)).astype(np.int32) for n in lengths]


def _scenario(engine):
    shorts = [engine.submit(p, max_new_tokens=20) for p in _prompts(41, (5, 9))]
    engine.step()
    engine.step()
    long_h = engine.submit(_prompts(42, (40,))[0], max_new_tokens=6)
    while engine.step():
        pass
    return [h.result() for h in shorts] + [long_h.result()]


def _geometry(**kw):
    base = dict(num_slots=3, max_len=64, prefill_buckets=(16, 64), decode_chunk=2)
    if kw.get("decode_mode") == "persistent":
        base.pop("decode_chunk")
    base.update(kw)
    return base


def _prefill_events(result):
    return [(n, d) for n, _, d in result.events if n in ("prefill", "prefill_chunk")]


CASES = {
    "slab": {},
    "paged": dict(page_size=16),
    "slab-int8": dict(kv_dtype="int8"),
    "paged-spec": dict(page_size=8, speculate=2),
    # a 4-row ring: the short requests still run when the long one lands
    "persistent-slab": dict(decode_mode="persistent", ring_capacity=4),
    "persistent-paged-int8": dict(decode_mode="persistent", ring_capacity=4,
                                  page_size=8, kv_dtype="int8"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_streams_and_counters_equal_jax(models, case):
    jm, tm = models
    kw = _geometry(chunked_prefill=16, **CASES[case])
    je = JServeEngine(jm, cost_cards=False, **kw)
    te = ServeEngine(tm, **kw)
    ref, out = _scenario(je), _scenario(te)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.tokens, r.tokens)
        assert o.finish_reason == r.finish_reason
    assert _prefill_events(out[2]) == _prefill_events(ref[2])
    jc, tc = je.metrics.counters, te.metrics.counters
    assert {k: tc[k] for k in COUNTERS} == {k: jc[k] for k in COUNTERS}
    # 40 tokens at threshold 16: chunks of 16 + 16 + 8, two interleaved
    # dispatches, the two later chunks mid-cache (the plain path)
    assert tc["chunked_prefills"] == 1 and tc["prefill_chunks"] == 3
    assert tc["prefill_interleaved_dispatches"] == 2
    assert te.plain_prefill_chunks == 2
    # chunking changes WHEN, never WHAT: the unchunked port engine
    plain = _scenario(ServeEngine(tm, **_geometry(**CASES[case])))
    for a, b in zip(plain, out):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_decode_slots_emit_between_chunks(models):
    _, tm = models
    out = _scenario(ServeEngine(tm, **_geometry(chunked_prefill=16)))
    long_r = out[2]
    t0 = next(ts for n, ts, _ in long_r.events if n == "prefill")
    t1 = next(ts for n, ts, _ in long_r.events if n == "first_token")
    assert any(t0 < ts < t1 for r in out[:2] for n, ts, _ in r.events
               if n == "decode_chunk")


def test_program_count_equals_jax_and_is_stable(models):
    """One program per bucket and family used, one decode program: the
    JAX engine's count on the CPU, and no late admission adds one."""
    jm, tm = models
    tdx.manual_seed(3)
    fresh_j = JLlama.from_name("tiny", max_seq_len=64)
    fresh_t = TLlama.from_name("tiny", max_seq_len=64, device="cpu")
    load_jax_params(fresh_t, {k: np.asarray(v) for k, v in fresh_j.named_parameters()})
    kw = _geometry(chunked_prefill=16, page_size=8)
    je = JServeEngine(fresh_j, cost_cards=False, **kw)
    te = ServeEngine(fresh_t, **kw)
    _scenario(je)
    _scenario(te)
    assert te.num_compiled_programs() == je.num_compiled_programs()
    warm = te.num_compiled_programs()
    _scenario(te)
    assert te.num_compiled_programs() == warm
    # an engine of another geometry on the same model counts apart
    other = ServeEngine(fresh_t, **_geometry(num_slots=2))
    assert other.num_compiled_programs() == 0


def test_chunked_prefill_must_be_a_bucket(models):
    _, tm = models
    with pytest.raises(ValueError, match="must be one of"):
        ServeEngine(tm, num_slots=1, max_len=64, prefill_buckets=(16, 64),
                    chunked_prefill=12)
    engine = ServeEngine(tm, num_slots=1, max_len=64, prefill_buckets=(16, 64),
                         chunked_prefill=16)
    r = engine.run([{"prompt": _prompts(43, (10,))[0], "max_new_tokens": 4}])[0]
    assert r.finish_reason == "length"
    assert engine.metrics.counters["chunked_prefills"] == 0


def test_hbm_gate_refuses_by_name_then_admits(models):
    """A budget below the footprint refuses with ``why == "hbm_budget"``
    and counts it; raising the budget admits on the next step.  The plan's
    components equal the JAX engine's (its cards off: the CPU port takes
    none, so neither side charges ``program_temp``)."""
    jm, tm = models
    kw = _geometry(page_size=8)
    je = JServeEngine(jm, cost_cards=False, **kw)
    te = ServeEngine(tm, **kw)
    plan, ref = te.memory_plan(), je.memory_plan()
    assert plan["components"] == ref["components"]
    assert "program_temp" not in plan["components"]
    assert plan["fits"] is None and plan["budget_source"] is None
    assert plan["kv_cache_dtype"] == ref["kv_cache_dtype"] == "float32"
    assert plan["components"]["kv_cache"] == te.cache.kv_data_nbytes
    footprint = plan["projected_peak_bytes"]
    outs = []
    for engine in (je, te):
        engine.hbm_budget = footprint - 1
        h = engine.submit(_prompts(44, (7,))[0], max_new_tokens=3)
        engine.step()
        gated = [d for n, _, d in h._request.events if n == "gated"]
        assert gated and gated[-1]["why"] == "hbm_budget"
        assert engine.metrics.counters["admissions_rejected_hbm"] == 1
        assert engine.memory_plan()["fits"] is False
        engine.hbm_budget = footprint
        while engine.step():
            pass
        outs.append(h.result().tokens)
    np.testing.assert_array_equal(outs[1], outs[0])
    assert te.memory_plan()["budget_source"] == "explicit"


def test_int8_plan_prices_scales_apart(models):
    jm, tm = models
    kw = _geometry(kv_dtype="int8")
    plan = ServeEngine(tm, **kw).memory_plan()
    ref = JServeEngine(jm, cost_cards=False, **kw).memory_plan()
    assert plan["components"] == ref["components"]
    assert plan["components"]["kv_scales"] > 0
    assert plan["kv_cache_dtype"] == "int8"


def test_stall_watchdog_and_cost_cards_off_the_card(models, tmp_path):
    """``stall_timeout_s`` arms the watchdog around each dispatch (it never
    fires on a healthy run); on the CPU no cost card is taken, so no
    probe can fail."""
    _, tm = models
    engine = ServeEngine(tm, stall_timeout_s=60.0, **_geometry())
    engine.run([{"prompt": p, "max_new_tokens": 3} for p in _prompts(45, (5, 9))])
    assert engine.watchdog.stalls_total == 0
    assert engine.watchdog.last_program == "serve/decode/k2"
    assert len(engine.cost_book) == 0 and engine.cost_card_errors == 0
    # the black box is ported: a recording engine runs and folds a drain
    # at every host sync
    rec = ServeEngine(tm, record=True, **_geometry())
    rec.run([{"prompt": p, "max_new_tokens": 3} for p in _prompts(45, (5, 9))])
    assert rec.recorder.drains == rec.metrics.counters["host_syncs"] > 0
