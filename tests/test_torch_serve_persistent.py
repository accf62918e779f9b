"""The port's persistent decode (``ServeEngine(decode_mode="persistent")``)
against the JAX package's persistent engine and against the port's own
chunked engine, on the CPU, where the loop runs its iteration eagerly (on
the card it is one CUDA graph replayed: ``tests/test_torch_cuda.py``).

Tiny f32 Llama (GQA), the JAX model's weights carried into the port.
Greedy token streams, finish reasons and the loop counters
(``loop_iterations``, ``ring_drains``, ``ring_full_drains``,
``ring_occupancy_hwm``, ``host_syncs``) must be EQUAL to the JAX persistent
engine's.  Sampled streams cannot match ``jax.random``'s bits; they must
equal the port's chunked streams bit for bit, since both modes run the same
decode body and sampler.  The tests of the JAX package's
``TestPersistentDecode`` and ``TestSpecEngineIdentity`` are carried over
(the ``persistent_stream`` ones are not: the streamed tail is not ported),
each EOS a token the stream emits, first at the index the test asserts.
"""

import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.serve import ServeEngine as JServeEngine
from torchdistx_tpu_torch.generation import (
    _make_slot_sampler,
    _noise_bits,
    generate,
    threefry2x32,
)
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.serve import ServeEngine

LOOP_COUNTERS = ("loop_iterations", "ring_drains", "ring_full_drains",
                 "host_syncs", "decode_steps", "masked_slot_steps",
                 "tokens_generated", "prefix_hit_tokens",
                 "draft_tokens_accepted")
BASE = dict(num_slots=3, max_len=64, prefill_buckets=(16,))
CYCLIC = ([3, 1, 2, 3, 1, 2, 3], [9, 9, 9, 9], [5, 7, 5, 7, 5])


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(0)
    jm = JLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64)
    tm = TLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64, device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


def _prompts(seed, lengths):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (n,)).astype(np.int32) for n in lengths]


def _requests(lengths, temperature=0.0, n_new=8, seed=21):
    return [{"prompt": p, "max_new_tokens": n_new, "temperature": temperature,
             "seed": i} for i, p in enumerate(_prompts(seed, lengths))]


def _shared_prefix_requests():
    rs = np.random.RandomState(17)
    shared = rs.randint(0, 256, (20,)).astype(np.int32)
    return [{"prompt": np.concatenate([shared, rs.randint(0, 256, (n,)).astype(np.int32)]),
             "max_new_tokens": 8, "temperature": 0.0, "seed": i}
            for i, n in enumerate((5, 9, 12))]


def _cyclic_requests(max_new=24, temps=None):
    reqs = [{"prompt": np.array(p, np.int32), "max_new_tokens": max_new}
            for p in CYCLIC]
    for r, t in zip(reqs, temps or ()):
        r.update(temperature=t, seed=7)
    return reqs


def _streams(results):
    return [(list(map(int, r.tokens)), r.finish_reason) for r in results]


def _greedy_stream(tm, prompt, n):
    out = generate(tm, np.asarray(prompt)[None], n, device="cpu")
    return out[0, len(prompt):].tolist()


def _loop_state(engine):
    snap = engine.metrics.to_json()
    out = {k: snap["counters"][k] for k in LOOP_COUNTERS}
    out["ring_occupancy_hwm"] = snap["gauges"]["ring_occupancy_hwm"]
    return out


# -- the sampler -------------------------------------------------------------


def test_threefry_block_equals_jax():
    """The port's Threefry-2x32 is the block ``jax.random`` is built on:
    the same words for the same key and counter."""
    from jax._src import prng

    rs = np.random.RandomState(0)
    for _ in range(4):
        k = rs.randint(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
        count = rs.randint(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
        ref = np.asarray(prng.threefry_2x32((k[0], k[1]), count))
        y0, y1 = threefry2x32(torch.tensor(int(k[0])), torch.tensor(int(k[1])),
                              torch.from_numpy(count[:32].astype(np.int64)),
                              torch.from_numpy(count[32:].astype(np.int64)))
        np.testing.assert_array_equal(torch.cat([y0, y1]).numpy(), ref.astype(np.int64))


def test_noise_bits_depend_on_seed_and_step_only():
    """Row ``b``'s noise is a function of ``(seeds[b], steps[b])`` and the
    vocab index alone: moving the row to another slot, changing its
    batch-mates or the vocabulary's cut leaves its bits as they were."""
    seeds = torch.tensor([7, 1234, 7, 2**31 - 1])
    steps = torch.tensor([3, 3, 4, 0])
    bits = _noise_bits(seeds, steps, 101)
    assert bits.dtype == torch.int64 and bits.min() >= 0 and bits.max() < 2**32
    alone = _noise_bits(seeds[1:2], steps[1:2], 101)
    np.testing.assert_array_equal(alone[0].numpy(), bits[1].numpy())
    moved = _noise_bits(seeds.flip(0), steps.flip(0), 101)
    np.testing.assert_array_equal(moved.flip(0).numpy(), bits.numpy())
    np.testing.assert_array_equal(_noise_bits(seeds, steps, 64).numpy(),
                                  bits[:, :64].numpy())
    assert not torch.equal(bits[0], bits[2])  # the step moves the key
    assert not torch.equal(bits[0], bits[1])  # so does the seed
    # 32 uniform bits a lane: about half of them set
    assert abs(float(torch.stack([(bits >> i) & 1 for i in range(32)]).float().mean()) - 0.5) < 0.02


def test_sampler_rows_pick_greedy_or_drawn():
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    sample = _make_slot_sampler()
    temps = torch.tensor([0.0, 1.0, 0.0, 1.0])
    seeds, steps = torch.tensor([5, 5, 6, 6]), torch.tensor([2, 2, 9, 9])
    out = sample(logits, temps, seeds, steps)
    assert out[0] == logits[0].argmax() and out[2] == logits[2].argmax()
    # a sampled row is its own draw whatever the other rows are
    for r in (1, 3):
        alone = sample(logits[r:r + 1], temps[r:r + 1], seeds[r:r + 1], steps[r:r + 1])
        assert alone[0] == out[r]


def test_sampled_stream_independent_of_slot_batch_and_chunking(models):
    _, tm = models
    reqs = _requests((6, 11, 9, 4, 13), temperature=0.9)
    kw = dict(BASE, eos_token=78)
    batch = ServeEngine(tm, **kw).run(reqs)
    chunked = ServeEngine(tm, decode_chunk=3, **kw).run(reqs)
    pers = ServeEngine(tm, decode_mode="persistent", **kw).run(reqs)
    assert _streams(chunked) == _streams(batch) == _streams(pers)
    for i in (0, 3):
        alone = ServeEngine(tm, **kw).run([reqs[i]])[0]
        np.testing.assert_array_equal(alone.tokens, batch[i].tokens)


# -- against the JAX persistent engine ----------------------------------------

JAX_CASES = {
    "slab": (dict(eos_token=78), lambda: _requests((6, 11, 9, 4, 13))),
    "paged_prefix": (dict(page_size=8, prefill_buckets=(16, 32)),
                     _shared_prefix_requests),
    "ring3_wraparound": (dict(ring_capacity=3), lambda: _requests((6, 11, 9))),
    "budget_bound_exit": (dict(num_slots=1, ring_capacity=4),
                          lambda: _requests((6,), n_new=12)),
    "eos_first_token": (dict(num_slots=1, eos_token=74),
                        lambda: [{"prompt": _prompts(3, (5,))[0], "max_new_tokens": 8}]),
    "one_token_budget": (dict(num_slots=2),
                         lambda: [{"prompt": _prompts(3, (5,))[0], "max_new_tokens": 1},
                                  {"prompt": _prompts(4, (9,))[0], "max_new_tokens": 6}]),
    "speculate2": (dict(num_slots=2, speculate=2, eos_token=78),
                   _cyclic_requests),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_greedy_streams_and_loop_counters_equal_jax(models, case):
    jm, tm = models
    kw, make = JAX_CASES[case]
    kw = dict(BASE, decode_mode="persistent", **kw)
    reqs = make()
    passes = 2 if "page_size" in kw else 1  # paged: a cold and a warm pass
    je, te = JServeEngine(jm, **kw), ServeEngine(tm, **kw)
    ref = [r for _ in range(passes) for r in je.run([dict(r) for r in reqs])]
    out = [r for _ in range(passes) for r in te.run([dict(r) for r in reqs])]
    assert _streams(out) == _streams(ref)
    assert _loop_state(te) == _loop_state(je)
    c = te.metrics.counters
    assert c["host_syncs"] == c["ring_drains"]
    assert c["loop_iterations"] == c["decode_steps"] == te.loop_replays


def test_eos_first_token_premise(models):
    """The EOS of the ``eos_first_token`` case is the prompt's first greedy
    token, so the slot must freeze before iteration 0."""
    _, tm = models
    assert _greedy_stream(tm, _prompts(3, (5,))[0], 1) == [74]
    res = ServeEngine(tm, **dict(BASE, num_slots=1, decode_mode="persistent",
                                 eos_token=74)).run(JAX_CASES["eos_first_token"][1]())
    assert _streams(res) == [([74], "stop")]


# -- against the port's chunked engine (TestPersistentDecode) -----------------


def _assert_identical(tm, reqs, *, ring=None, page_size=None, chunk=4, **kw):
    kw = dict(BASE, page_size=page_size, **kw)
    base = ServeEngine(tm, decode_chunk=chunk, **kw).run([dict(r) for r in reqs])
    engine = ServeEngine(tm, decode_mode="persistent", ring_capacity=ring, **kw)
    pers = engine.run([dict(r) for r in reqs])
    assert _streams(pers) == _streams(base)
    return engine


@pytest.mark.parametrize("ring", [None, 3])
@pytest.mark.parametrize("page_size", [None, 8])
@pytest.mark.parametrize("lengths", [(6, 11, 9, 4, 13), (7,)])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_full_grid_equals_chunked(models, ring, page_size, lengths, temperature):
    _assert_identical(models[1], _requests(lengths, temperature),
                      ring=ring, page_size=page_size)


@pytest.mark.parametrize("kw", [dict(kv_dtype="int8"), dict(speculate=2),
                                dict(page_size=8, speculate=2, kv_dtype="int8"),
                                dict(eos_token=78, top_k=20, top_p=0.9)])
def test_sampled_streams_equal_chunked(models, kw):
    reqs = _requests((6, 11, 9, 4), temperature=0.8) + _requests((8, 5), seed=22)
    _assert_identical(models[1], reqs, **kw)


def test_greedy_syncs_collapse_to_drains(models):
    engine = _assert_identical(models[1], _requests((6, 11, 9, 4, 13)))
    snap = engine.metrics.snapshot()
    assert snap["host_syncs"] == snap["ring_drains"]
    assert snap["loop_iterations"] == snap["decode_steps"]
    assert snap["syncs_per_token"] < 0.11
    assert snap["ring_occupancy_hwm"] >= 7
    assert snap["ring_full_drains"] == 0


def test_ring_wraparound_spans_drains(models):
    engine = _assert_identical(models[1], _requests((6, 11, 9)), ring=3)
    snap = engine.metrics.snapshot()
    assert snap["ring_capacity"] == 3 and snap["ring_occupancy_hwm"] == 3
    assert snap["ring_drains"] >= 3 and snap["ring_full_drains"] >= 2
    assert snap["host_syncs"] == snap["ring_drains"]


def test_budget_bound_exit_resumes(models):
    _, tm = models
    engine = ServeEngine(tm, num_slots=1, max_len=64, prefill_buckets=(16,),
                         decode_mode="persistent", ring_capacity=4)
    prompt = _prompts(21, (6,))[0]
    h = engine.submit(prompt, max_new_tokens=12)
    engine.step()
    assert not h.done()
    assert len(h._request.generated) == 1 + 4  # the first token + one ring
    assert engine.metrics.counters["ring_full_drains"] == 1
    while engine.step():
        pass
    assert h.result().finish_reason == "length"
    assert h.result().tokens.tolist() == _greedy_stream(tm, prompt, 12)


def test_eos_first_token_and_one_token_budget(models):
    _, tm = models
    prompt = _prompts(3, (5,))[0]
    first = _greedy_stream(tm, prompt, 1)[0]
    r = ServeEngine(tm, num_slots=1, max_len=64, prefill_buckets=(16,),
                    decode_mode="persistent", eos_token=first).run(
        [{"prompt": prompt, "max_new_tokens": 8}])[0]
    assert r.finish_reason == "stop" and not r.truncated
    assert r.tokens.tolist() == [first]
    r2 = ServeEngine(tm, num_slots=2, max_len=64, prefill_buckets=(16,),
                     decode_mode="persistent").run(
        [{"prompt": prompt, "max_new_tokens": 1}])[0]
    assert r2.finish_reason == "length" and len(r2.tokens) == 1


def test_frozen_slot_rows_stay_untouched(models):
    """A slot finishing mid-loop freezes: the iterations its batch-mate
    keeps running rewrite its frozen row only, so rows past it stay
    zeros.  The EOS, 78, is first emitted at index 4 of the stream."""
    _, tm = models
    prompt = np.array(CYCLIC[0], np.int32)
    stream = _greedy_stream(tm, prompt, 20)
    assert stream.index(78) == 4
    engine = ServeEngine(tm, num_slots=2, max_len=64, prefill_buckets=(8,),
                         decode_mode="persistent", eos_token=78)
    results = engine.run([
        {"prompt": prompt, "max_new_tokens": 20},
        {"prompt": _prompts(32, (6,))[0], "max_new_tokens": 20,
         "temperature": 0.9, "seed": 5},
    ])
    assert results[0].finish_reason == "stop"
    assert results[0].tokens.tolist() == stream[:5]
    frozen = prompt.size + len(results[0].tokens) - 1
    k0 = engine.cache.kv[0][0]  # layer 0 K
    assert torch.count_nonzero(k0[0, frozen]) > 0
    assert torch.count_nonzero(k0[0, frozen + 1:]) == 0
    assert engine.metrics.counters["masked_slot_steps"] > 0


def test_loop_built_once_and_holds_the_cache(models):
    _, tm = models
    engine = _assert_identical(tm, _requests((6, 9)))
    loop = engine._decode.loop
    engine.run(_requests((5, 12, 8)))
    assert engine._decode.loop is loop
    engine.cache.kv = [tuple(t.clone() for t in e) for e in engine.cache.kv]
    engine.submit(_prompts(5, (6,))[0], max_new_tokens=4)
    with pytest.raises(ValueError, match="rebound"):
        engine.step()


def test_engine_frees_its_loop_without_a_collection(models):
    """No reference cycle holds the loop state (on the card: the graph and
    its pool) once the engine is dropped."""
    import gc
    import weakref

    _, tm = models
    engine = ServeEngine(tm, decode_mode="persistent", **BASE)
    engine.run(_requests((6, 9), n_new=4))
    state = weakref.ref(engine._decode)
    gc.disable()
    try:
        del engine
        assert state() is None
    finally:
        gc.enable()


def test_validation(models):
    _, tm = models
    with pytest.raises(ValueError, match="decode_mode"):
        ServeEngine(tm, max_len=32, decode_mode="turbo")
    with pytest.raises(ValueError, match="ring_capacity"):
        ServeEngine(tm, max_len=32, ring_capacity=8)
    with pytest.raises(ValueError, match="ring_capacity"):
        ServeEngine(tm, max_len=32, decode_mode="persistent", ring_capacity=0)
    with pytest.raises(NotImplementedError, match="persistent_stream"):
        ServeEngine(tm, max_len=32, decode_mode="persistent", persistent_stream=True)


def test_ring_gauges_only_when_persistent(models):
    _, tm = models
    engine = ServeEngine(tm, max_len=32, prefill_buckets=(16,),
                         decode_mode="persistent", ring_capacity=16)
    engine.run(_requests((6, 9), n_new=5))
    j = engine.metrics.to_json()
    assert j["gauges"]["ring_capacity"] == 16
    assert j["gauges"]["ring_occupancy_hwm"] == 4
    assert j["counters"]["ring_drains"] >= 1
    assert "ring_capacity" not in ServeEngine(tm, max_len=32).metrics.to_json()["gauges"]


# -- speculation (TestSpecEngineIdentity, persistent) -------------------------


def _spec_run(tm, max_new=24, temps=None, **kw):
    kw = dict(dict(num_slots=2, max_len=64, decode_mode="persistent"), **kw)
    engine = ServeEngine(tm, **kw)
    return _streams(engine.run(_cyclic_requests(max_new, temps))), engine


def test_spec_slab_identity(models):
    base, eng0 = _spec_run(models[1])
    spec, eng = _spec_run(models[1], speculate=2)
    assert spec == base
    c = eng.metrics.counters
    assert c["draft_tokens_accepted"] > 0
    assert c["host_syncs"] == eng0.metrics.counters["host_syncs"] == c["ring_drains"]


def test_spec_fewer_loop_iterations(models):
    _, eng0 = _spec_run(models[1])
    _, eng = _spec_run(models[1], speculate=4)
    assert eng.metrics.counters["loop_iterations"] < eng0.metrics.counters["loop_iterations"]
    assert eng.metrics.to_json()["derived"]["accepted_tokens_per_iteration"] > 1.0


def test_spec_paged_identity(models):
    base, _ = _spec_run(models[1])
    spec, _ = _spec_run(models[1], speculate=2, page_size=8)
    assert spec == base


def test_spec_sampled_identical_at_accept_zero(models):
    temps = [0.9, 0.0, 1.4]
    base, _ = _spec_run(models[1], temps=temps)
    spec, eng = _spec_run(models[1], speculate=2, temps=temps)
    assert spec == base
    assert eng.metrics.counters["draft_tokens_proposed"] > 0


@pytest.mark.parametrize("eos,first", [(78, 4), (207, 13)])
def test_spec_eos_stop_identical(models, eos, first):
    """The EOS is emitted by the first prompt's stream, first at index
    ``first``: speculation must stop there as the one-token loop does."""
    _, tm = models
    assert _greedy_stream(tm, CYCLIC[0], 24).index(eos) == first
    base, _ = _spec_run(tm, eos_token=eos)
    spec, _ = _spec_run(tm, eos_token=eos, speculate=4)
    assert spec == base
    assert base[0] == (_greedy_stream(tm, CYCLIC[0], 24)[:first + 1], "stop")
