"""The port's observability layer (``torchdistx_tpu_torch.obs``, the
``utils.profiling`` helpers and the engine's program count) against the
JAX package's on the CPU.

Every comparison is on identical inputs built on both sides: the same
capacity components, the same cost cards, the same request histories
with fixed timestamps.  The outputs must be EQUAL (dicts, rendered
Prometheus text, trace-event JSON, SLO reports): the modules were copied
or hold the same arithmetic, so no tolerance applies.
"""

import json

import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

from torchdistx_tpu.obs import cost as jcost
from torchdistx_tpu.obs import memory as jmemory
from torchdistx_tpu.obs import metrics as jmetrics
from torchdistx_tpu.obs import slo as jslo
from torchdistx_tpu.obs import trace as jtrace
from torchdistx_tpu.serve.metrics import ServeMetrics as JServeMetrics
from torchdistx_tpu.serve.scheduler import Request as JRequest
from torchdistx_tpu_torch.obs import cost, memory, metrics, slo, trace
from torchdistx_tpu_torch.obs.flight import FlightRecorder, validate_flight_jsonl
from torchdistx_tpu_torch.obs.recompile import (
    RecompileWatcher,
    jit_cache_collector,
    note_compile,
    recompile_scope,
    track_jit_cache,
)
from torchdistx_tpu_torch.obs.watchdog import DispatchWatchdog
from torchdistx_tpu_torch.serve.metrics import ServeMetrics
from torchdistx_tpu_torch.serve.scheduler import Request
from torchdistx_tpu_torch.utils import profiling


@pytest.mark.parametrize("budget", [None, 999, 1000, 10**9])
def test_capacity_plan_equals_jax(budget):
    comps = {"weights": 600, "kv_cache": 300, "program_temp": 100,
             "label": "ignored", "flag": True}
    assert (memory.capacity_plan(comps, budget_bytes=budget)
            == jmemory.capacity_plan(comps, budget_bytes=budget))


def test_tree_device_bytes_counts_each_storage_once():
    a = torch.zeros(3, 4)
    b = torch.zeros(5, dtype=torch.bfloat16)
    lin = torch.nn.Linear(4, 2)
    assert memory.tree_device_bytes([a, (b, {"x": a[:0]})]) == 48 + 10
    assert memory.tree_device_bytes(lin) == (8 + 2) * 4
    assert memory.tree_device_bytes({"w": a, "tied": a}) == 48


def test_device_memory_off_the_card():
    stats = profiling.device_memory_stats("cpu")
    assert stats == {"cpu": {}}
    assert memory.device_hbm_budget("cpu") is None
    wm = memory.hbm_watermark("cpu")
    assert wm["source"] == "host_rusage" and wm["peak_bytes"] > 0


def _cards(mod):
    a = mod.CostCard(program="serve/decode/k4", temp_bytes=4096, peak_bytes=9000,
                     peak_source="cuda_allocator", flops=None, scope="serve/decode")
    b = mod.CostCard(program="serve/prefill/b16", flops=2.0e9, bytes_accessed=1.0e6,
                     temp_bytes=1024, peak_bytes=5000, peak_source="xla_peak")
    return a, b


def test_cost_book_equals_jax():
    """The same cards through both books: queries, JSON and the
    Prometheus text agree; only the port accepts null FLOPs on an
    allocator card (nothing in the port counts them)."""
    book, jbook = cost.CostBook(), jcost.CostBook()
    for c in _cards(cost):
        book.record(c)
    for c in _cards(jcost):
        jbook.record(c)
    assert book.max_temp_bytes() == jbook.max_temp_bytes() == 4096
    assert book.max_peak_bytes() == 9000 and jbook.max_peak_bytes() == 5000
    out, ref = book.to_json(), jbook.to_json()
    assert out == ref
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    reg.register_collector(book.collector(), obj=book)
    jreg.register_collector(jbook.collector(), obj=jbook)
    # the families' help strings differ; the samples are the same
    assert (metrics.parse_prometheus(reg.render())["samples"]
            == jmetrics.parse_prometheus(jreg.render())["samples"])
    assert cost.validate_cost_card(ref["serve/prefill/b16"]) == []
    assert jcost.validate_cost_card(ref["serve/prefill/b16"]) == []
    assert cost.validate_cost_card(ref["serve/decode/k4"]) == []
    assert jcost.validate_cost_card(ref["serve/decode/k4"]) != []
    bad = dict(ref["serve/prefill/b16"], peak_source="unavailable")
    assert cost.validate_cost_card(bad) == jcost.validate_cost_card(bad)
    assert (cost.roofline(_cards(cost)[1], peak_flops=1e12, hbm_bw=1e9)
            == jcost.roofline(_cards(jcost)[1], peak_flops=1e12, hbm_bw=1e9))


def test_cost_cards_kill_switch(monkeypatch):
    monkeypatch.setenv("TDX_COST_CARDS", "0")
    assert cost.force_disabled() and jcost.force_disabled()
    monkeypatch.setenv("TDX_COST_CARDS", "1")
    assert cost.cards_enabled() and not cost.force_disabled()


def test_serve_metrics_collector_text_equals_jax():
    out, ref = ServeMetrics(4, num_pages=9), JServeMetrics(4, num_pages=9)
    for m in (out, ref):
        m.count("tokens_generated", 7)
        m.count("host_syncs", 3)
        m.observe_gauges(2, 3)
        m.observe_pages(5)
        for v in (0.25, 0.5, 0.125):
            m.ttft_s.record(v)
        m.started_at = 100.0
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    reg.register_collector(out.collector(), obj=out)
    jreg.register_collector(ref.collector(), obj=ref)
    derived = ("_per_s", "uptime")
    text = [line for line in reg.render().splitlines() if not any(d in line for d in derived)]
    jtext = [line for line in jreg.render().splitlines()
             if not any(d in line for d in derived)]
    assert text == jtext


def _requests(cls):
    """Three finished requests with fixed timestamps and events: one
    routed and handed off, one migrated mid-decode, one expired queued."""
    reqs = []
    a = cls(rid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=4, trace_id=11)
    a.submitted_at, a.admitted_at, a.first_token_at, a.finished_at = 1.0, 1.5, 2.0, 4.0
    a.generated, a.finish_reason = [1, 2, 3, 4], "length"
    a.events = [("submit", 1.0, None), ("routed", 1.25, {"replica": 0}),
                ("admitted", 1.5, {"slot": 0}), ("first_token", 2.0, None),
                ("handoff", 2.5, {"from_slot": 0, "to_slot": 1}),
                ("finish", 4.0, {"reason": "length"})]
    b = cls(rid=1, prompt=np.arange(3, dtype=np.int32), max_new_tokens=3, trace_id=12)
    b.submitted_at, b.admitted_at, b.first_token_at, b.finished_at = 1.1, 1.2, 1.4, 3.0
    b.generated, b.finish_reason = [5, 6, 7], "length"
    b.events = [("submit", 1.1, None), ("admitted", 1.2, {"slot": 1}),
                ("first_token", 1.4, None), ("migrated", 2.2, {"from_slot": 1, "to_slot": 0}),
                ("finish", 3.0, {"reason": "length"})]
    c = cls(rid=2, prompt=np.arange(4, dtype=np.int32), max_new_tokens=2, trace_id=13,
            deadline_s=0.5)
    c.submitted_at, c.finished_at, c.finish_reason = 1.3, 1.8, "deadline"
    c.events = [("submit", 1.3, None), ("expire", 1.8, {"where": "queued"})]
    reqs += [a, b, c]
    return reqs


def test_trace_events_equal_jax():
    for fn in ("request_trace_events",):
        assert (getattr(trace, fn)(_requests(Request))
                == getattr(jtrace, fn)(_requests(JRequest)))
    fin = [(0, "decode", r) for r in _requests(Request)]
    jfin = [(0, "decode", r) for r in _requests(JRequest)]
    roles = {0: "decode", 1: "prefill"}
    out = trace.fleet_request_trace_events(fin, roles=roles)
    assert out == jtrace.fleet_request_trace_events(jfin, roles=roles)
    assert json.loads(json.dumps(out)) == out
    for r, jr in zip(_requests(Request), _requests(JRequest)):
        assert trace.fleet_request_spans(r) == jtrace.fleet_request_spans(jr)
    events = [("scale", 12.5, {"tick": 3, "action": "scale_up", "mode": "add",
                                "replica": 2, "reason": "burn",
                                "signal": {"state": "warn"}}),
              ("add", 12.6, {"replica": 2, "role": "serve", "tick": 3, "warm": {}}),
              ("routed", 12.7, {})]
    assert trace.fleet_scale_trace_events(events) == jtrace.fleet_scale_trace_events(events)


def test_tracer_export_round_trips(tmp_path):
    tracer = trace.Tracer(enabled=True)
    with tracer.span("serve/decode", cat="dispatch", k=2):
        pass
    tracer.instant("mark")
    path = tracer.export(str(tmp_path / "t.json"),
                         extra_events=trace.request_trace_events(_requests(Request)))
    doc = json.loads(open(path).read())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"serve/decode", "mark", "queued", "prefill", "decode"} <= names


@pytest.mark.parametrize("spec_kw", [
    dict(name="ttft", ttft_p95_s=0.6, attainment_target=0.5, windows_s=(1.0, 5.0)),
    dict(name="deadline", deadline_s=2.5, e2e_p50_s=2.0, windows_s=(2.0,)),
])
def test_evaluate_slo_equals_jax(spec_kw):
    out = slo.evaluate_slo(slo.SloSpec(**spec_kw), _requests(Request), now=4.5,
                           policy="affinity", flight=False)
    ref = jslo.evaluate_slo(jslo.SloSpec(**spec_kw), _requests(JRequest), now=4.5,
                            policy="affinity", flight=False)
    assert out == ref
    assert slo.validate_slo_report(out) == [] == jslo.validate_slo_report(ref)
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    reg.register_collector(slo.slo_collector(slo.SloSpec(**spec_kw),
                                             lambda: _requests(Request)))
    jreg.register_collector(jslo.slo_collector(jslo.SloSpec(**spec_kw),
                                               lambda: _requests(JRequest)))
    parsed = metrics.parse_prometheus(reg.render())
    jparsed = jmetrics.parse_prometheus(jreg.render())
    assert parsed["types"] == jparsed["types"]
    assert set(parsed["samples"]) == set(jparsed["samples"])


def test_program_watcher_scopes_and_tracked_counts():
    with RecompileWatcher() as w:
        with recompile_scope("fleet/add_warmup"):
            note_compile(0.5)
            with recompile_scope("serve/prefill"):
                note_compile()
        note_compile()
        snap = w.snapshot()
    assert snap["compiles_total"] == 3 and snap["available"]
    assert snap["by_scope"]["fleet/add_warmup"]["compiles"] == 1
    assert set(snap["by_scope"]) == {"fleet/add_warmup", "serve/prefill", "unattributed"}
    note_compile()  # an uninstalled watcher counts nothing more
    assert w.total == 3

    class Counted:
        def num_compiled_programs(self):
            return 4

    obj = Counted()
    track_jit_cache("engine0", obj)
    fams = jit_cache_collector()()
    assert ("", {"fn": "engine0"}, 4) in fams[0].samples


def test_watchdog_fires_on_a_fake_timer_and_dumps(tmp_path):
    timers = []

    class FakeTimer:
        def __init__(self, interval, fn):
            self.fn = fn
            timers.append(self)

        def start(self):
            pass

        def cancel(self):
            pass

    rec = FlightRecorder(dump_dir=str(tmp_path))
    book = cost.CostBook()
    book.record(_cards(cost)[0])
    dog = DispatchWatchdog(1.0, flight=rec, book=book, timer=FakeTimer)
    with dog.arm("serve/decode/k4"):
        timers[-1].fn()  # the deadline passes inside the region
    assert dog.stalls_total == 1
    assert validate_flight_jsonl(dog.last_dump_path) == []
    lines = [json.loads(x) for x in open(dog.last_dump_path)]
    stall = [x for x in lines if x["kind"] == "stall"][0]
    assert stall["program"] == "serve/decode/k4"
    assert stall["cost_card"]["temp_bytes"] == 4096
