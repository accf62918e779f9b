"""The port's ``ServeFleet`` against the JAX package's fleet on the CPU:
the routing, stream, remove, add and disaggregation cases of
``tests/test_fleet.py`` that need no mesh.

Tiny f32 Llama, the JAX model's weights carried into the port; every
engine of a fleet serves the one model.  The routed replica ids and each
``routed`` event's candidate scoring (``match_len``, the headroom key,
the named skip reason) must be EQUAL to the JAX fleet's on the same
requests, and so must the token streams, which also equal one engine's.
All compared values are integers or token ids: no tolerance.
"""

import numpy as np
import pytest
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.serve import ServeEngine as JServeEngine
from torchdistx_tpu.serve import ServeFleet as JServeFleet
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.obs.metrics import MetricsRegistry
from torchdistx_tpu_torch.serve import (
    RoundRobinPolicy,
    ServeEngine,
    ServeFleet,
)
from torchdistx_tpu_torch.serve.fleet import _load_key

SIDES = ("jax", "torch")


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(0)
    jm = JLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64)
    tm = TLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64, device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return {"jax": jm, "torch": tm}


def _engine(models, side, slots, paged=False, **kw):
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_buckets", (32,))
    if kw.get("decode_mode") != "persistent":
        kw.setdefault("decode_chunk", 2)
    if paged:
        kw.setdefault("page_size", 8)
        kw.setdefault("num_pages", 32)
    if side == "jax":
        return JServeEngine(models["jax"], num_slots=slots, cost_cards=False, **kw)
    return ServeEngine(models["torch"], num_slots=slots, **kw)


def _fleet(side, engines, **kw):
    return (JServeFleet if side == "jax" else ServeFleet)(engines, **kw)


def _shared_prefix_prompts(seed, n, prefix_len=16, tail_len=4):
    rs = np.random.RandomState(seed)
    prefix = rs.randint(0, 256, (prefix_len,)).astype(np.int32)
    return [np.concatenate([prefix, rs.randint(0, 256, (tail_len,)).astype(np.int32)])
            for _ in range(n)]


def _workload(seed=7, n=6):
    prompts = _shared_prefix_prompts(seed, n)
    mnt = [6, 8, 10, 6, 8, 10][:n]
    return [dict(prompt=p, max_new_tokens=m) for p, m in zip(prompts, mnt)]


def _routing(fleet):
    """Every routed event without its timestamp: replica, policy, tick
    and the candidate scoring."""
    return [(d["rid"], d["replica"], d["policy"], d["tick"], d["candidates"])
            for name, _, d in fleet.events if name == "routed"]


@pytest.mark.parametrize("policy", ["affinity", "least-loaded", "round-robin"])
def test_three_replica_fleet_equals_jax_and_one_engine(models, policy):
    reqs = _workload()
    out = {}
    for side in SIDES:
        fleet = _fleet(side, [_engine(models, side, 2, paged=True) for _ in range(3)],
                       policy=policy)
        out[side] = (fleet.run(reqs), _routing(fleet), fleet.metrics_json())
    assert out["torch"][1] == out["jax"][1]
    for r, o in zip(out["jax"][0], out["torch"][0]):
        np.testing.assert_array_equal(o.tokens, r.tokens)
        assert o.finish_reason == r.finish_reason
    single = _engine(models, "torch", 6, paged=True).run(reqs)
    for r, o in zip(single, out["torch"][0]):
        np.testing.assert_array_equal(o.tokens, r.tokens)
    jt, tt = out["jax"][2], out["torch"][2]
    assert tt["gauges"] == jt["gauges"]
    assert tt["fleet"] == jt["fleet"]
    assert {k: tt["counters"][k] for k in jt["counters"]} == jt["counters"]


def test_affinity_routes_to_warm_replica_and_scores_equal_jax(models):
    routed = {}
    for side in SIDES:
        engines = [_engine(models, side, 2, paged=True) for _ in range(3)]
        prompts = _shared_prefix_prompts(3, 3)
        engines[1].run([dict(prompt=prompts[0], max_new_tokens=2)])
        fleet = _fleet(side, engines, policy="affinity")
        h = fleet.submit(prompts[1], max_new_tokens=2)
        name, _, data = h._request.events[-1]
        assert name == "routed" and data["replica"] == fleet.replicas[1].rid
        by_rid = {c["replica"]: c for c in data["candidates"]}
        assert by_rid[fleet.replicas[1].rid]["match_len"] == 16
        while fleet.step():
            pass
        routed[side] = _routing(fleet)
    assert routed["torch"] == routed["jax"]


def test_headroom_beats_warmth_and_skip_is_named(models):
    routed = {}
    for side in SIDES:
        warm = _engine(models, side, 2, paged=True, num_pages=4)  # 3 allocatable
        cold = _engine(models, side, 2, paged=True, num_pages=32)
        prompts = _shared_prefix_prompts(4, 2, prefix_len=8, tail_len=8)
        warm.run([dict(prompt=prompts[0][:9], max_new_tokens=2)])
        fleet = _fleet(side, [warm, cold], policy="affinity")
        h = fleet.submit(prompts[1], max_new_tokens=16)
        (skip,) = [e for e in h._request.events if e[0] == "route_skipped"]
        assert skip[2] == {"rid": fleet.replicas[0].rid, "why": "pages", "tick": 0}
        assert cold.scheduler.queue_depth == 1 and warm.scheduler.queue_depth == 0
        routed[side] = _routing(fleet)
    assert routed["torch"] == routed["jax"]


def test_rejection_tiebreak_is_windowed(models):
    fleet = ServeFleet([_engine(models, "torch", 2), _engine(models, "torch", 2)],
                       policy="least-loaded")
    a, b = fleet.replicas
    assert _load_key(a) > _load_key(b)
    a.engine.metrics.count("admissions_rejected_pages", 3)
    assert _load_key(a) < _load_key(b)
    fleet.step()
    assert a.recent_rejections() == 0 and _load_key(a) > _load_key(b)


def test_round_robin_and_policy_objects(models):
    engines = [_engine(models, "torch", 2) for _ in range(2)]
    fleet = ServeFleet(engines, policy=RoundRobinPolicy())
    for p in _shared_prefix_prompts(5, 4):
        fleet.submit(p, max_new_tokens=2)
    assert [e.scheduler.queue_depth for e in engines] == [2, 2]
    with pytest.raises(ValueError, match="unknown policy"):
        ServeFleet(engines, policy="warmest")
    with pytest.raises(TypeError, match="route"):
        ServeFleet(engines, policy=object())
    # the black box is ported: the fleet records its composition and
    # each replica its geometry
    fleet = ServeFleet([_engine(models, "torch", 2) for _ in range(2)], record=True)
    kinds = [e["kind"] for e in fleet.recorder.events]
    assert kinds == ["session_header", "fleet", "geometry", "geometry"]


def test_remove_mid_workload_drops_nothing_and_equals_jax(models):
    reqs = _workload(seed=9)
    out = {}
    for side in SIDES:
        fleet = _fleet(side, [_engine(models, side, 3) for _ in range(3)],
                       policy="round-robin")
        handles = [fleet.submit(**r) for r in reqs]
        fleet.step()
        victim = fleet.replicas[0]
        assert victim.engine.scheduler.running
        summary = fleet.remove(victim.rid)
        while fleet.step():
            pass
        assert all(h.done() for h in handles)
        j = fleet.metrics_json()
        assert j["counters"]["requests_migrated_out"] == j["counters"]["requests_migrated_in"] >= 1
        out[side] = ([h.result().tokens for h in handles],
                     {k: v for k, v in summary.items()}, j["counters"]["requests_submitted"])
    for a, b in zip(out["torch"][0], out["jax"][0]):
        np.testing.assert_array_equal(a, b)
    assert out["torch"][1:] == out["jax"][1:]
    single = _engine(models, "torch", 6).run(reqs)
    for r, o in zip(single, out["torch"][0]):
        np.testing.assert_array_equal(o, r.tokens)


def test_scatter_failure_readopts_every_unplaced_request(models):
    victim = _engine(models, "torch", 2, paged=True, num_pages=32)
    small = _engine(models, "torch", 2, paged=True, num_pages=4)
    fleet = ServeFleet([victim, small], policy="round-robin")
    fits, big = np.arange(8, dtype=np.int32), np.arange(16, dtype=np.int32)
    h_a = victim.submit(fits, max_new_tokens=8)
    h_b = victim.submit(big, max_new_tokens=16)
    h_c = victim.submit(fits + 1, max_new_tokens=8)
    with pytest.raises(RuntimeError, match="could absorb"):
        fleet.remove(fleet.replicas[0].rid)
    assert victim._draining and len(fleet.replicas) == 2
    assert [r.rid for r in victim.scheduler.queued] == [h_b.rid, h_c.rid]
    assert [r.rid for r in small.scheduler.queued] == [h_a.rid]
    for _ in range(12):
        fleet.step()
    assert h_a.done() and not h_b.done() and not h_c.done()


@pytest.mark.parametrize("decode_mode", ["chunked", "persistent"])
def test_add_warms_into_rotation_with_a_stable_program_count(models, decode_mode):
    """A warmed replica's program count does not move under routed traffic
    (its warm-up set every program up), and its metrics start clean."""
    fleet = ServeFleet([_engine(models, "torch", 2, paged=True)], policy="round-robin")
    new = _engine(models, "torch", 2, paged=True, decode_mode=decode_mode)
    rid = fleet.add(new)
    add = [d for name, _, d in fleet.events if name == "add"][-1]
    assert add["warm"]["requests"] == 2 and add["replica"] == rid
    assert new.metrics.counters["requests_submitted"] == 0
    assert len(new.prefix_index) == 0 and not new.finished_requests()
    programs = new.num_compiled_programs()
    assert programs == add["warm"]["programs_after"]
    for p in _shared_prefix_prompts(11, 4):
        fleet.submit(p, max_new_tokens=3)
    while fleet.step():
        pass
    assert new.metrics.counters["requests_completed"] == 2
    assert new.num_compiled_programs() == programs
    with pytest.raises(RuntimeError, match="last"):
        fleet.remove(rid), fleet.remove(0)


@pytest.mark.parametrize("paged", [False, True])
def test_disaggregated_handoffs_equal_jax(models, paged):
    reqs = [dict(prompt=p, max_new_tokens=m)
            for p, m in zip(_shared_prefix_prompts(13, 4), [6, 8, 6, 8])]
    out = {}
    for side in SIDES:
        pre = _engine(models, side, 4, paged=paged)
        dec = _engine(models, side, 4, paged=paged)
        fleet = _fleet(side, [pre, dec], disaggregate=True, roles=["prefill", "decode"])
        res = fleet.run(reqs)
        # trace ids come from each package's process-wide stream
        handoffs = [{k: v for k, v in d.items() if k != "trace_id"}
                    for name, _, d in fleet.events if name == "handoff"]
        out[side] = ([r.tokens for r in res], handoffs, _routing(fleet),
                     dict(pre.metrics.counters), dict(dec.metrics.counters))
        assert pre.metrics.counters["decode_dispatches"] == 0
        assert dec.metrics.counters["prefill_calls"] == 0
        assert pre.metrics.counters["requests_handed_off"] == len(reqs)
    for a, b in zip(out["torch"][0], out["jax"][0]):
        np.testing.assert_array_equal(a, b)
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2] == out["jax"][2]
    for i in (3, 4):
        assert {k: out["torch"][i][k] for k in out["jax"][i]} == out["jax"][i]
    assert all(h["wire_bytes"] == 0 for h in out["torch"][1])
    if paged:
        assert all(h["pages_moved"] > 0 for h in out["torch"][1])


def test_disaggregated_into_a_persistent_decode_engine(models):
    """The decode role may run the persistent loop: handed-off slots join
    it mid-stream (KV and history written in place), streams equal one
    engine's."""
    reqs = [dict(prompt=p, max_new_tokens=m)
            for p, m in zip(_shared_prefix_prompts(21, 3), [5, 7, 9])]
    pre = _engine(models, "torch", 3, paged=True)
    dec = _engine(models, "torch", 3, paged=True, decode_mode="persistent",
                  speculate=2)
    fleet = ServeFleet([pre, dec], disaggregate=True)
    out = fleet.run(reqs)
    single = _engine(models, "torch", 3, paged=True).run(reqs)
    for r, o in zip(single, out):
        np.testing.assert_array_equal(o.tokens, r.tokens)
    assert dec.metrics.counters["requests_handed_in"] == 3


def test_backpressure_and_never_fitting_handoff(models):
    reqs = [dict(prompt=p, max_new_tokens=4) for p in _shared_prefix_prompts(19, 2)]
    pre, dec = _engine(models, "torch", 2), _engine(models, "torch", 1)
    fleet = ServeFleet([pre, dec], disaggregate=True)
    out = fleet.run(reqs)
    for r, o in zip(_engine(models, "torch", 2).run(reqs), out):
        np.testing.assert_array_equal(o.tokens, r.tokens)
    handoffs = [e for e in fleet.events if e[0] == "handoff"]
    assert len(handoffs) == 2 and handoffs[0][2]["tick"] < handoffs[1][2]["tick"]
    pre = _engine(models, "torch", 2, paged=True, num_pages=32)
    dec = _engine(models, "torch", 2, paged=True, num_pages=4)
    fleet = ServeFleet([pre, dec], disaggregate=True)
    fleet.submit(np.arange(24, dtype=np.int32), max_new_tokens=8)
    with pytest.raises(RuntimeError, match="can never be handed"):
        fleet.step()


def test_disagg_validation(models):
    with pytest.raises(ValueError, match="at least two"):
        ServeFleet([_engine(models, "torch", 2)], disaggregate=True)
    with pytest.raises(ValueError, match="chunked-mode"):
        ServeFleet([_engine(models, "torch", 2, decode_mode="persistent"),
                    _engine(models, "torch", 2)], disaggregate=True)
    with pytest.raises(ValueError, match="incompatible"):
        ServeFleet([_engine(models, "torch", 2), _engine(models, "torch", 2, max_len=32)],
                   disaggregate=True)
    with pytest.raises(ValueError, match="require disaggregate"):
        ServeFleet([_engine(models, "torch", 2)], roles=["prefill"])
    with pytest.raises(RuntimeError, match="step_prefill requires"):
        _engine(models, "torch", 2, decode_mode="persistent").step_prefill()


def test_collector_text_equals_jax(models):
    """The fleet's Prometheus exposition: the same families, labels and
    integer samples as the JAX fleet's on the same run (the latency
    summaries are wall-clock and compared by presence)."""
    from torchdistx_tpu.obs.metrics import MetricsRegistry as JRegistry
    from torchdistx_tpu.obs.metrics import parse_prometheus as jparse
    from torchdistx_tpu_torch.obs.metrics import parse_prometheus

    reqs = _workload(seed=23, n=4)
    parsed = {}
    for side, reg_cls, parse in (("jax", JRegistry, jparse),
                                 ("torch", MetricsRegistry, parse_prometheus)):
        fleet = _fleet(side, [_engine(models, side, 2, paged=True) for _ in range(2)])
        fleet.run(reqs)
        reg = reg_cls()
        reg.register_collector(fleet.collector(), obj=fleet)
        parsed[side] = parse(reg.render())
    j, t = parsed["jax"], parsed["torch"]
    assert t["types"] == j["types"]
    assert set(t["samples"]) == set(j["samples"])
    timed = ("tdx_fleet_ttft_s", "tdx_fleet_tpot_s", "tdx_fleet_e2e_latency_s")
    for key, v in j["samples"].items():
        if not key[0].startswith(timed) or key[0].endswith("_count"):
            assert t["samples"][key] == v, key
