"""The port's ``ServeEngine`` against the JAX package's, on the CPU.

Tiny f32 Llama (GQA variant), the JAX model's weights carried into the
port.  Greedy token streams must be EQUAL to the JAX engine's: the logits
agree to f32 rounding and the argmax takes no near-tie on these inputs.
Sampled streams cannot match ``jax.random``'s bits; they are held to
reproducibility by seed instead.
"""

import inspect

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

EOS = 78  # sampled by some requests below: the stop rule is exercised


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(0)
    jm = JLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64)
    tm = TLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64, device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


def _requests(seed, lengths, max_new=8, temperature=0.0):
    rs = np.random.RandomState(seed)
    return [
        {"prompt": rs.randint(0, 256, (n,)).astype(np.int32),
         "max_new_tokens": max_new, "temperature": temperature, "seed": 100 + i}
        for i, n in enumerate(lengths)
    ]


LENGTHS = (6, 11, 9, 4, 13, 3, 15)  # more requests than slots, staggered


@pytest.mark.parametrize("num_slots,decode_chunk", [(2, 1), (4, 3)])
def test_greedy_streams_equal_jax_engine(models, num_slots, decode_chunk):
    jm, tm = models
    reqs = _requests(0, LENGTHS)
    kw = dict(num_slots=num_slots, max_len=64, prefill_buckets=(16,),
              eos_token=EOS, decode_chunk=decode_chunk)
    ref = JServeEngine(jm, **kw).run(reqs)
    out = ServeEngine(tm, **kw).run(reqs)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.tokens, r.tokens)
        assert o.finish_reason == r.finish_reason
    assert "stop" in {r.finish_reason for r in ref}


def test_decode_chunk_does_not_change_streams(models):
    _, tm = models
    reqs = _requests(1, LENGTHS) + _requests(2, (5, 8), temperature=0.9)
    kw = dict(num_slots=3, max_len=64, prefill_buckets=(16,), eos_token=EOS)
    one = ServeEngine(tm, decode_chunk=1, **kw).run(reqs)
    four = ServeEngine(tm, decode_chunk=4, **kw).run(reqs)
    for a, b in zip(one, four):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.finish_reason == b.finish_reason


def test_request_alone_equals_request_in_batch(models):
    _, tm = models
    reqs = _requests(3, LENGTHS) + _requests(4, (7,), temperature=0.8)
    kw = dict(num_slots=3, max_len=64, prefill_buckets=(16,))
    batch = ServeEngine(tm, **kw).run(reqs)
    for i in (4, len(reqs) - 1):  # a greedy and a sampled request
        alone = ServeEngine(tm, **kw).run([reqs[i]])[0]
        np.testing.assert_array_equal(alone.tokens, batch[i].tokens)


def test_sampled_streams_reproducible_by_seed(models):
    _, tm = models
    reqs = _requests(5, (6, 9, 12), max_new=10, temperature=1.0)
    kw = dict(num_slots=2, max_len=64, prefill_buckets=(16,), top_k=50, top_p=0.9)
    a = ServeEngine(tm, **kw).run(reqs)
    b = ServeEngine(tm, **kw).run(reqs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.tokens, y.tokens)
    reseeded = [dict(r, seed=r["seed"] + 1000) for r in reqs]
    c = ServeEngine(tm, **kw).run(reseeded)
    assert any(not np.array_equal(x.tokens, z.tokens) for x, z in zip(a, c))


def test_metrics_and_finish_bookkeeping(models):
    _, tm = models
    reqs = _requests(6, (5, 9, 3), max_new=6)
    engine = ServeEngine(tm, num_slots=2, max_len=64, prefill_buckets=(16,),
                         decode_chunk=2)
    res = engine.run(reqs)
    c = engine.metrics.counters
    assert c["prefill_calls"] == 3 and c["requests_completed"] == 3
    assert c["tokens_generated"] == sum(len(r.tokens) for r in res) == 18
    assert c["host_syncs"] == c["prefill_calls"] + c["decode_dispatches"]
    assert c["decode_steps"] == 2 * c["decode_dispatches"]
    assert len(engine.finished_requests()) == 3
    assert all(r.finish_reason == "length" and not r.truncated for r in res)


def test_submit_validation(models):
    _, tm = models
    engine = ServeEngine(tm, num_slots=2, max_len=32, prefill_buckets=(8,))
    with pytest.raises(ValueError, match="exceeds the slot cache"):
        engine.submit(np.arange(30), max_new_tokens=8)
    with pytest.raises(ValueError, match="largest prefill bucket"):
        engine.submit(np.arange(10), max_new_tokens=4)


# arguments the port has taken since: each is accepted with a valid value
_PORTED_SINCE = {"page_size": 8, "num_pages": None, "kv_dtype": "int8",
                 "prefix_cache": False, "spec_ngram": 3, "ring_capacity": 8,
                 "persistent_stream": True, "record": True, "params": None, "mesh": None,
                 "plan": None, "tp_rule": None, "tp_axis": None, "numerics": True}
_TP_ARGS = ("params", "mesh", "plan", "tp_rule", "tp_axis")


@pytest.mark.parametrize("name", tuple(_PORTED_SINCE))
def test_unported_argument_raises(models, name):
    _, tm = models
    if name == "ring_capacity":
        # persistent mode's: refused without it, taken with it
        with pytest.raises(ValueError, match="requires decode_mode='persistent'"):
            ServeEngine(tm, max_len=32, ring_capacity=8)
        engine = ServeEngine(tm, max_len=32, decode_mode="persistent",
                             ring_capacity=8)
        assert engine.ring_capacity == 8
        return
    if name == "persistent_stream":
        # persistent mode's: refused in chunked mode, taken and run in it
        with pytest.raises(ValueError, match="requires decode_mode='persistent'"):
            ServeEngine(tm, max_len=32, persistent_stream=True)
        engine = ServeEngine(tm, max_len=32, decode_mode="persistent", persistent_stream=True)
        engine.run(_requests(3, (5, 7), max_new=4))
        assert engine.metrics.counters["stream_callbacks"] == \
            engine.metrics.counters["loop_iterations"] > 0
        return
    if name == "record":
        engine = ServeEngine(tm, max_len=32, record=True)
        engine.run(_requests(3, (5,), max_new=3))
        assert [e["kind"] for e in engine.recorder.events][:3] == [
            "session_header", "geometry", "submit"]
        return
    if name in _TP_ARGS:
        # tensor-parallel serving's arguments, ported: taken over a one-rank
        # mesh (tests/test_torch_serve_tp.py serves over two), and the same
        # greedy streams as the plain engine's
        from torchdistx_tpu_torch.parallel import create_mesh, llama_tp_plan, llama_tp_rule

        mesh = create_mesh({"tp": 1})
        kw = {"params": dict(params={k: v.detach().clone() for k, v in tm.named_parameters()}),
              "mesh": dict(mesh=mesh), "plan": dict(mesh=mesh, plan=llama_tp_plan(mesh)),
              "tp_rule": dict(mesh=mesh, tp_rule=llama_tp_rule(mesh)),
              "tp_axis": dict(mesh=create_mesh({"model": 1}), tp_axis="model")}[name]
        reqs = _requests(3, (5, 7), max_new=4)
        want = [r.tokens for r in ServeEngine(tm, max_len=32).run(reqs)]
        if name == "tp_rule":
            with pytest.warns(DeprecationWarning, match="tp_rule"):
                engine = ServeEngine(tm, max_len=32, **kw)
        else:
            engine = ServeEngine(tm, max_len=32, **kw)
        for got, ref in zip(engine.run(reqs), want):
            np.testing.assert_array_equal(got.tokens, ref)
        return
    if name == "numerics":
        # the observatory, ported: a book of the declared sites
        engine = ServeEngine(tm, max_len=32, numerics=True)
        engine.run(_requests(3, (5,), max_new=3))
        assert engine.numerics_book.digest("logits").count > 0
        return
    ServeEngine(tm, max_len=32, **{name: _PORTED_SINCE[name]})
    # every JAX argument is ported: an unknown one is Python's TypeError
    with pytest.raises(TypeError, match="unexpected keyword"):
        ServeEngine(tm, max_len=32, **{f"not_{name}": None})


@pytest.mark.parametrize("kw", [dict(decode_mode="persistent"),
                                dict(speculate=2, decode_mode="persistent")])
def test_unported_modes_raise(models, kw):
    """Both persistent modes, once unported, construct and run: streams
    equal to the chunked engine's."""
    _, tm = models
    reqs = _requests(7, (6, 9, 4), max_new=6) + _requests(8, (5,), max_new=6,
                                                          temperature=0.9)
    common = dict(num_slots=2, max_len=32, prefill_buckets=(16,), eos_token=EOS)
    chunked = ServeEngine(tm, **dict(kw, decode_mode="chunked"), **common).run(reqs)
    engine = ServeEngine(tm, **kw, **common)
    assert engine.decode_mode == "persistent" and engine.ring_capacity == 32
    out = engine.run(reqs)
    for a, b in zip(chunked, out):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.finish_reason == a.finish_reason
    # the streamed tail, ported: the one-token loop takes it and streams
    # the same tokens; the speculative one refuses it, as JAX's does
    assert "persistent_stream" in inspect.signature(ServeEngine).parameters
    if kw.get("speculate"):
        with pytest.raises(ValueError, match="speculate is not supported"):
            ServeEngine(tm, persistent_stream=True, **kw, **common)
    else:
        streamed = ServeEngine(tm, persistent_stream=True, **kw, **common).run(reqs)
        for a, b in zip(out, streamed):
            np.testing.assert_array_equal(b.tokens, a.tokens)


def test_engine_device_must_match_model(models):
    _, tm = models
    with pytest.raises(ValueError, match="device"):
        ServeEngine(tm, max_len=32, device="meta")
    assert ServeEngine(tm, max_len=32, device="cpu").device == torch.device("cpu")
