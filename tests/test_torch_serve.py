"""The port's ``ServeEngine`` against the JAX package's, on the CPU.

Tiny f32 Llama (GQA variant), the JAX model's weights carried into the
port.  Greedy token streams must be EQUAL to the JAX engine's: the logits
agree to f32 rounding and the argmax takes no near-tie on these inputs.
Sampled streams cannot match ``jax.random``'s bits; they are held to
reproducibility by seed instead.
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
from torchdistx_tpu_torch.serve.engine import _UNPORTED

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


@pytest.mark.parametrize("name", _UNPORTED)
def test_unported_argument_raises(models, name):
    _, tm = models
    with pytest.raises(NotImplementedError, match=name):
        ServeEngine(tm, max_len=32, **{name: None})


@pytest.mark.parametrize("kw", [dict(decode_mode="persistent"), dict(speculate=2)])
def test_unported_modes_raise(models, kw):
    _, tm = models
    with pytest.raises(NotImplementedError):
        ServeEngine(tm, max_len=32, **kw)


def test_engine_device_must_match_model(models):
    _, tm = models
    with pytest.raises(ValueError, match="device"):
        ServeEngine(tm, max_len=32, device="meta")
    assert ServeEngine(tm, max_len=32, device="cpu").device == torch.device("cpu")
