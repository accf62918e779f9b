"""The persistent engine's streamed tail (``persistent_stream=True``), on the
CPU, where the push is a plain call per loop iteration (on the card it is a
host node of the captured iteration: ``tests/test_torch_cuda.py``).

Tiny f32 Llama with the JAX model's weights.  Pinned: one push per loop
iteration (``stream_callbacks == loop_iterations``); the tokens the stream
marks live, slot by slot, are exactly the tokens the ring drain gave each
request; the streams equal the JAX engine's (and the port's without the
stream); the first-token stamps come before their drain; streaming adds
no host sync; and the engine refuses the stream where JAX's refuses it
(chunked mode, ``speculate``).
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

EOS = 78
GEOMETRY = dict(num_slots=3, max_len=64, prefill_buckets=(16,), eos_token=EOS,
                decode_mode="persistent")


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(0)
    jm = JLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64)
    tm = TLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64, device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


def _requests(seed, lengths=(6, 11, 9, 4, 13, 3, 15), max_new=8):
    rs = np.random.RandomState(seed)
    return [{"prompt": rs.randint(0, 256, (n,)).astype(np.int32), "max_new_tokens": max_new,
             "temperature": 0.9 if i == 3 else 0.0, "seed": 100 + i}
            for i, n in enumerate(lengths)]


def _slot(req):
    return next(d["slot"] for name, _, d in req.events if name == "admitted")


def _drive(engine, requests):
    """Submit everything and step to the end; after each step check the
    dispatch's pushes against what its drain gave each request."""
    handles = [engine.submit(**r) for r in requests]
    reqs = [h._request for h in handles]
    dispatches = 0
    while True:
        before = {id(r): len(r.generated) for r in reqs}
        iters = engine.metrics.counters["loop_iterations"]
        left = engine.step()
        events = engine.stream_events
        n_it = engine.metrics.counters["loop_iterations"] - iters
        assert len(events) == n_it
        assert [ev[3] for ev in events] == list(range(n_it))  # the cursor
        for req in reqs:
            drained = [ev for name, ts, ev in req.events if name == "decode_chunk"]
            got = req.generated[before[id(req)]:]
            if not got or not drained:
                continue
            taken = drained[-1]["tokens"]
            ring = got[len(got) - taken:]
            slot = _slot(req)
            streamed = [int(toks[slot]) for _, toks, live, _ in events if live[slot]]
            assert streamed[:len(ring)] == ring
            assert len(streamed) == len(ring) or req.finish_reason is None
        if n_it:
            dispatches += 1
        if not left:
            break
    return handles, dispatches


def test_pushes_equal_iterations_and_tokens_equal_the_drain(models):
    jm, tm = models
    reqs = _requests(0)
    engine = ServeEngine(tm, persistent_stream=True, **GEOMETRY)
    assert engine.stream_supported == "host_call" and engine.persistent_stream
    handles, dispatches = _drive(engine, reqs)
    c = engine.metrics.counters
    assert c["stream_callbacks"] == c["loop_iterations"] == engine.loop_replays > 0
    assert dispatches == c["ring_drains"]
    ref = JServeEngine(jm, **GEOMETRY).run(reqs)
    plain = ServeEngine(tm, **GEOMETRY)
    out = plain.run(reqs)
    for h, r, o in zip(handles, ref, out):
        res = h.result()
        if r is ref[3]:
            np.testing.assert_array_equal(res.tokens, o.tokens)  # sampled: the port's own
        else:
            np.testing.assert_array_equal(res.tokens, r.tokens)
        assert res.finish_reason == o.finish_reason
    # the stream adds no host sync: every counter but its own is the plain run's
    streamed = dict(c)
    assert streamed.pop("stream_callbacks") > 0 and plain.metrics.counters["stream_callbacks"] == 0
    assert streamed == {k: v for k, v in plain.metrics.counters.items() if k != "stream_callbacks"}


def test_first_token_stamps_come_before_their_drain(models):
    _, tm = models
    engine = ServeEngine(tm, persistent_stream=True, **GEOMETRY)
    handles = [engine.submit(**r) for r in _requests(1, lengths=(5, 7, 9))]
    while engine.step():
        pass
    for h in handles:
        req = h._request
        first = next(ts for name, ts, _ in req.events if name == "first_token")
        drain = next(ts for name, ts, _ in req.events if name == "decode_chunk")
        assert first < drain
        assert req.first_token_at == first


def test_ring_full_spans_drains(models):
    """A ring shorter than the requests: the loop exits with live slots,
    each dispatch pushes its own iterations, and the streams still equal
    the unstreamed engine's."""
    _, tm = models
    kw = dict(GEOMETRY, ring_capacity=3)
    reqs = _requests(2, lengths=(4, 8), max_new=10)
    engine = ServeEngine(tm, persistent_stream=True, **kw)
    handles, dispatches = _drive(engine, reqs)
    assert dispatches > 2 and engine.metrics.counters["ring_full_drains"] > 0
    for h, o in zip(handles, ServeEngine(tm, **kw).run(reqs)):
        np.testing.assert_array_equal(h.result().tokens, o.tokens)


def test_paged_persistent_stream(models):
    _, tm = models
    kw = dict(GEOMETRY, page_size=8)
    reqs = _requests(3)
    engine = ServeEngine(tm, persistent_stream=True, **kw)
    handles, _ = _drive(engine, reqs)
    c = engine.metrics.counters
    assert c["stream_callbacks"] == c["loop_iterations"]
    for h, o in zip(handles, ServeEngine(tm, **kw).run(reqs)):
        np.testing.assert_array_equal(h.result().tokens, o.tokens)


@pytest.mark.parametrize("kw,match", [
    (dict(decode_mode="chunked"), "requires decode_mode='persistent'"),
    (dict(speculate=2), "speculate is not supported with persistent_stream"),
])
def test_refused_as_jax_refuses(models, kw, match):
    jm, tm = models
    geometry = dict(GEOMETRY, **kw)
    for engine_cls, model in ((JServeEngine, jm), (ServeEngine, tm)):
        with pytest.raises(ValueError, match=match):
            engine_cls(model, persistent_stream=True, **geometry)
    assert ServeEngine(tm, **GEOMETRY).stream_supported is None
