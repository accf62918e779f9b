"""The port's ``drain`` / ``migrate_to`` / ``handoff_to`` against the JAX
package's engine on the CPU: the cases of ``tests/test_serve_elastic.py``
that need no mesh.

Tiny f32 Llama, the JAX model's weights carried into the port.  A run is
suspended mid-stream, drained and migrated into a differently shaped
engine; token streams, finish reasons, the summary dicts and the
migration counters must be EQUAL to the JAX engine's (integers and token
ids: no tolerance), and equal to an undrained run.  Without a mesh the
gather group of every KV move is 1, so both sides book zero wire.
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

MIGRATION_COUNTERS = ("requests_migrated_out", "requests_migrated_in",
                      "migration_wire_bytes", "tokens_generated",
                      "submits_rejected_draining")


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


def _kw(slots, paged=False, **kw):
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_buckets", (16,))
    if kw.get("decode_mode") != "persistent":
        kw.setdefault("decode_chunk", 2)
    if paged:
        kw.setdefault("page_size", 8)
        kw.setdefault("num_pages", 32)
    return dict(num_slots=slots, **kw)


def _elastic(cls, model, src_kw, dst_kw, steps_before=2):
    """The JAX suite's scenario: four requests on the source, suspended
    after ``steps_before`` steps, drained and migrated; the target runs
    them to the end.  Returns (tokens, reasons, summary, src, dst)."""
    prompts = _prompts(7, (6, 9, 5, 11))
    mnt = [8, 10, 12, 6]
    src, dst = cls(model, **src_kw), cls(model, **dst_kw)
    handles = [src.submit(p, max_new_tokens=m) for p, m in zip(prompts, mnt)]
    for _ in range(steps_before):
        src.step()
    src.drain()
    summary = src.migrate_to(dst)
    while dst.step():
        pass
    assert all(h.done() for h in handles)
    return ([h.result().tokens for h in handles],
            [h.result().finish_reason for h in handles], summary, src, dst)


def _undrained(model, kw):
    prompts = _prompts(7, (6, 9, 5, 11))
    mnt = [8, 10, 12, 6]
    return [r.tokens for r in ServeEngine(model, **kw).run(
        [dict(prompt=p, max_new_tokens=m) for p, m in zip(prompts, mnt)])]


MIGRATIONS = {
    "slab-2-to-3": (_kw(2), _kw(3)),
    "slab-3-to-4": (_kw(3), _kw(4)),
    "paged-3-to-4": (_kw(3, paged=True), _kw(4, paged=True)),
    "paged-3-to-3-prefix-off": (_kw(3, paged=True, prefix_cache=False),
                                _kw(3, paged=True, prefix_cache=False)),
    "slab-int8": (_kw(3, kv_dtype="int8"), _kw(4, kv_dtype="int8")),
    "paged-spec": (_kw(3, paged=True, speculate=2), _kw(4, paged=True, speculate=2)),
    "into-persistent": (_kw(3), _kw(4, decode_mode="persistent")),
    "paged-into-persistent-int8": (_kw(3, paged=True, kv_dtype="int8"),
                                   _kw(4, paged=True, kv_dtype="int8",
                                       decode_mode="persistent")),
    "from-persistent": (_kw(3, decode_mode="persistent", ring_capacity=3), _kw(4)),
}


@pytest.mark.parametrize("case", sorted(MIGRATIONS))
def test_migration_equals_jax(models, case):
    jm, tm = models
    src_kw, dst_kw = MIGRATIONS[case]
    ref = _elastic(JServeEngine, jm, dict(src_kw, cost_cards=False),
                   dict(dst_kw, cost_cards=False))
    out = _elastic(ServeEngine, tm, src_kw, dst_kw)
    for a, b in zip(out[0], ref[0]):
        np.testing.assert_array_equal(a, b)
    assert out[1] == ref[1]
    assert out[2] == ref[2]  # the summary dict, zeros from the closed form
    assert out[2]["wire_bytes"] == 0 == out[2]["collectives"]
    assert out[2]["migrated_running"] >= 2
    for o, r in ((out[3], ref[3]), (out[4], ref[4])):
        assert ({k: o.metrics.counters[k] for k in MIGRATION_COUNTERS}
                == {k: r.metrics.counters[k] for k in MIGRATION_COUNTERS})
    for a, b in zip(_undrained(tm, src_kw), out[0]):
        np.testing.assert_array_equal(a, b)
    src = out[3]
    assert not src.scheduler.has_work()
    if src.paged:
        assert src.pool.in_use == 0
    with pytest.raises(RuntimeError, match="draining"):
        src.submit(np.ones(4, np.int32), max_new_tokens=1)


def test_migration_to_fewer_slots_after_completing_some(models):
    """``drain(complete=True)`` finishes the running slots, so the queue
    alone moves into an engine with fewer slots."""
    jm, tm = models
    outs = []
    for cls, model, extra in ((JServeEngine, jm, dict(cost_cards=False)),
                              (ServeEngine, tm, {})):
        src, dst = cls(model, **_kw(3, **extra)), cls(model, **_kw(1, **extra))
        hs = [src.submit(p, max_new_tokens=5) for p in _prompts(8, (6, 7, 8, 9))]
        src.step()
        src.drain(complete=True)
        summary = src.migrate_to(dst)
        while dst.step():
            pass
        outs.append(([h.result().tokens for h in hs], summary))
    for a, b in zip(outs[1][0], outs[0][0]):
        np.testing.assert_array_equal(a, b)
    assert outs[1][1] == outs[0][1]
    assert outs[1][1]["migrated_running"] == 0 and outs[1][1]["migrated_queued"] == 1


def test_handoff_equals_jax(models):
    """One prefilled request handed from a live engine to another: the
    summary and the stream equal the JAX engine's."""
    jm, tm = models
    outs = []
    for cls, model, extra in ((JServeEngine, jm, dict(cost_cards=False)),
                              (ServeEngine, tm, {})):
        pre = cls(model, **_kw(2, paged=True, **extra))
        dec = cls(model, **_kw(2, paged=True, **extra))
        h = pre.submit(_prompts(9, (12,))[0], max_new_tokens=7)
        pre.step_prefill()
        info = pre.handoff_to(dec, h._request)
        while dec.step():
            pass
        outs.append((h.result().tokens, info, pre.metrics.counters["handoff_pages_moved"],
                     dec.metrics.counters["requests_handed_in"]))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    assert outs[1][1:] == outs[0][1:]
    assert outs[1][1]["pages_moved"] > 0 and outs[1][1]["wire_bytes"] == 0


class TestDrain:
    def test_submit_refused_with_named_reason(self, models):
        _, tm = models
        eng = ServeEngine(tm, **_kw(2))
        eng.drain()
        with pytest.raises(RuntimeError, match="draining"):
            eng.submit(_prompts(0, (5,))[0], max_new_tokens=2)
        assert eng.metrics.counters["submits_rejected_draining"] == 1

    def test_queued_head_gets_draining_gate_event(self, models):
        _, tm = models
        eng = ServeEngine(tm, **_kw(1))
        p = _prompts(1, (5, 6))
        eng.submit(p[0], max_new_tokens=4)
        eng.submit(p[1], max_new_tokens=4)
        eng.step()
        assert eng.drain() == 2
        head = eng.scheduler.queued[0]
        gated = [e for e in head.events if e[0] == "gated"]
        assert gated and gated[-1][2]["why"] == "draining"
        eng.step()  # keeps decoding, admits nothing
        assert eng.scheduler.queue_depth == 1

    def test_drain_wins_over_page_gate_and_reserves_nothing(self, models):
        _, tm = models
        eng = ServeEngine(tm, **_kw(2, paged=True, num_pages=5))
        p = _prompts(2, (8, 8))
        eng.submit(p[0], max_new_tokens=8)
        eng.submit(p[1], max_new_tokens=8)
        eng.step()
        in_use = eng.pool.in_use
        eng.drain()
        eng.step()
        assert eng.pool.in_use == in_use
        for head in eng.scheduler.queued[:1]:
            gated = [e for e in head.events if e[0] == "gated"]
            assert gated[-1][2]["why"] == "draining"

    def test_drain_flushes_persistent_pending_first_tokens(self, models):
        """A persistent engine's prefill leaves its first token on the
        device until the next drain of the ring; ``drain()`` fetches it so
        the suspended state is complete."""
        _, tm = models
        eng = ServeEngine(tm, **_kw(2, decode_mode="persistent"))
        h = eng.submit(_prompts(3, (6,))[0], max_new_tokens=4)
        eng._admit_tick(0.0)  # admit + prefill, no decode dispatch
        assert eng._pending_first
        eng.drain()
        assert not eng._pending_first
        assert len(h._request.generated) == 1


class TestMigrateValidation:
    def test_rejects_self_and_shape_mismatches(self, models):
        _, tm = models
        a = ServeEngine(tm, **_kw(2))
        with pytest.raises(ValueError, match="itself"):
            a.migrate_to(a)
        with pytest.raises(RuntimeError, match="slab and paged"):
            a.migrate_to(ServeEngine(tm, **_kw(2, paged=True)))
        with pytest.raises(RuntimeError, match="max_len"):
            a.migrate_to(ServeEngine(tm, **_kw(2, max_len=32)))
        with pytest.raises(RuntimeError, match="dtype"):
            a.migrate_to(ServeEngine(tm, **_kw(2, kv_dtype="int8")))
        d = ServeEngine(tm, **_kw(2))
        d.drain()
        with pytest.raises(RuntimeError, match="target is itself"):
            ServeEngine(tm, **_kw(2)).migrate_to(d)

    def test_capacity_validation_moves_nothing(self, models):
        _, tm = models
        src, dst = ServeEngine(tm, **_kw(3)), ServeEngine(tm, **_kw(1))
        for p in _prompts(9, (5, 6, 7)):
            src.submit(p, max_new_tokens=8)
        src.step()
        src.drain()
        with pytest.raises(RuntimeError, match="free"):
            src.migrate_to(dst)
        assert len(src.scheduler.running) == 3
        assert not dst.scheduler.has_work()
        assert dst.scheduler.free_slot_count == 1
