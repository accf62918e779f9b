"""The port's session black box against the JAX package's, on the CPU.

Tiny f32 Llama (GQA variant), the JAX model's weights carried into the
port.  A session recorded by the port's engine must:

- pass both validators, the port's ``validate_session_jsonl`` and JAX's;
- equal, event for event and field for field, a recording of the JAX
  engine on the same weights and requests, leaving out the wall-clock
  stamps (``t``) and the environment stamp of the header; that includes
  every drain's counter delta and per-request tokens, so the digest
  chains are equal too.  No folded counter differs between the engines in
  the modes below (chunked, persistent, paged with the prefix cache,
  speculative, int8, chunked prefill), so none is left out;
- replay to ``"match"``; a tampered copy names the first divergent drain,
  the counters that differ and the affected requests.

Fleet and ``Trainer`` sessions round-trip, and ``TDX_SESSION_RECORD=0``
turns every implicit recorder off.  Recording moves no engine counter:
``host_syncs`` with recording on equals the count with it off.
"""

import numpy as np
import pytest
import torch
import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)

import torchdistx_tpu as tdx
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.obs import blackbox as jbb
from torchdistx_tpu.serve import ServeEngine as JServeEngine
from torchdistx_tpu.serve import ServeFleet as JServeFleet
import torchdistx_tpu_torch as tt
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.obs.blackbox import (
    SessionRecorder,
    geometry_kwargs,
    load_session,
    rechain,
    replay_session,
    resolve_record,
    validate_session_jsonl,
)
from torchdistx_tpu_torch.serve import (
    AutoscaleController,
    ScalingPolicy,
    ServeEngine,
    ServeFleet,
    replay_signal,
)


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(7)
    jm = JLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64)
    tm = TLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64, device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


BASE = dict(num_slots=2, max_len=32, prefill_buckets=(16,))
MODES = {
    "chunked": dict(decode_chunk=4),
    "persistent": dict(decode_mode="persistent"),
    "paged_prefix": dict(page_size=8, decode_chunk=2),
    "speculative": dict(speculate=2, decode_chunk=2),
    "int8_persistent": dict(kv_dtype="int8", decode_mode="persistent"),
    "chunked_prefill": dict(chunked_prefill=8, prefill_buckets=(8, 16), decode_chunk=2),
}


def _work(n=4, seed=0, max_new=4, temperature=0.0):
    rs = np.random.RandomState(seed)
    return [{"prompt": rs.randint(0, 256, (int(m),)).astype(np.int32),
             "max_new_tokens": max_new, "temperature": temperature, "seed": i}
            for i, m in enumerate(rs.randint(2, 12, n))]


def _record(engine_cls, recorder_cls, model, path=None, **kw):
    rec = recorder_cls(path, enabled=True)
    engine = engine_cls(model, record=rec, **{**BASE, **kw})
    results = engine.run([dict(w) for w in _work()])
    rec.close()
    return rec, engine, results


def _factory(model, **extra):
    def build(rep_rec, geom):
        return ServeEngine(model, record=rep_rec, **{**geometry_kwargs(geom), **extra})
    return build


def _comparable(events):
    """Every event without its wall-clock stamp; the header without the
    environment stamp (pid, sha, versions, device)."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k != "t"}
        if e["kind"] == "session_header":
            e = {k: e[k] for k in ("kind", "schema", "snapshot_every")}
        out.append(e)
    return out


@pytest.mark.parametrize("mode", list(MODES))
def test_recording_equals_jax_field_for_field(models, mode, tmp_path):
    jm, tm = models
    path = str(tmp_path / "port.jsonl")
    rec, _, out = _record(ServeEngine, SessionRecorder, tm, path, **MODES[mode])
    jrec, _, ref = _record(JServeEngine, jbb.SessionRecorder, jm, **MODES[mode])
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert validate_session_jsonl(path) == []
    assert jbb.validate_session_jsonl(path) == []  # JAX's reader takes it
    events, notes = load_session(path)
    assert notes == [] and events[0]["schema"] == "tdx-session-v1"
    assert _comparable(events) == _comparable(jrec.events)
    drains = [e for e in events if e["kind"] == "drain"]
    assert drains and any(e["tokens"] for e in drains)
    assert rec.chain == jrec.chain


def test_env_stamp_names_torch_not_jax(models):
    _, tm = models
    rec, _, _ = _record(ServeEngine, SessionRecorder, tm)
    head = rec.events[0]
    assert head["torch_version"] == torch.__version__
    assert "jax_version" not in head and "device_name" in head


@pytest.mark.parametrize("mode", ["chunked", "persistent", "paged_prefix"])
def test_record_then_replay_matches(models, mode, tmp_path):
    _, tm = models
    path = str(tmp_path / "s.jsonl")
    rec, _, _ = _record(ServeEngine, SessionRecorder, tm, path, **MODES[mode])
    v = replay_session(path, engine_factory=_factory(tm))
    assert v["verdict"] == "match" and v["match"], v
    assert v["chain_replayed"] == v["chain_recorded"] == rec.chain
    v2 = replay_session(path, model_factory=lambda: tm)
    assert v2["verdict"] == "match"


def _perturb(events, mutate):
    out = [dict(e) for e in events]
    for e in out:
        if e.get("kind") == "drain" and mutate(e):
            return rechain(out), e
    raise AssertionError("no drain took the perturbation")


def test_tampered_counter_names_drain_and_counter(models, tmp_path):
    _, tm = models
    path = str(tmp_path / "s.jsonl")
    _record(ServeEngine, SessionRecorder, tm, path, **MODES["chunked"])
    events, _ = load_session(path)

    def bump(e):
        if e["seq"] < 2 or "host_syncs" not in (e.get("delta") or {}):
            return False
        e["delta"] = dict(e["delta"], host_syncs=e["delta"]["host_syncs"] + 1)
        return True

    pert, target = _perturb(events, bump)
    assert validate_session_jsonl(pert) == []  # rechained: self-consistent
    v = replay_session(pert, engine_factory=_factory(tm))
    assert v["verdict"] == "divergent" and not v["match"]
    d = v["first_divergence"]
    assert (d["seq"], d["tick"]) == (target["seq"], target["tick"])
    assert d["counters"] == ["host_syncs"] and d["rids"] == []


def test_tampered_token_names_request(models, tmp_path):
    _, tm = models
    path = str(tmp_path / "s.jsonl")
    _record(ServeEngine, SessionRecorder, tm, path, **MODES["persistent"])
    events, _ = load_session(path)

    def flip(e):
        toks = e.get("tokens") or {}
        if not toks:
            return False
        rid = sorted(toks)[0]
        vals = list(toks[rid])
        vals[0] = (vals[0] + 1) % 256
        e["tokens"] = dict(toks, **{rid: vals})
        return True

    pert, target = _perturb(events, flip)
    rid = int(sorted(target["tokens"])[0])
    v = replay_session(pert, engine_factory=_factory(tm))
    d = v["first_divergence"]
    assert v["verdict"] == "divergent" and d["seq"] == target["seq"]
    assert d["counters"] == [] and d["rids"] == [rid]
    # an unrechained edit breaks the chain, and the validator says where
    raw = [dict(e) for e in events]
    raw[events.index(next(e for e in events if e.get("seq") == target["seq"]))] = target
    assert any(f"seq {target['seq']}" in err for err in validate_session_jsonl(raw))


def test_geometry_mismatch_names_fields(models, tmp_path):
    _, tm = models
    path = str(tmp_path / "s.jsonl")
    _record(ServeEngine, SessionRecorder, tm, path)
    v = replay_session(path, engine_factory=_factory(tm, num_slots=3))
    assert v["verdict"] == "geometry_mismatch" and v["geometry_fields"] == ["num_slots"]


def test_recording_adds_no_host_sync(models):
    _, tm = models
    for kw in (MODES["chunked"], MODES["persistent"]):
        plain = ServeEngine(tm, **{**BASE, **kw})
        plain.run([dict(w) for w in _work()])
        _, rec_engine, _ = _record(ServeEngine, SessionRecorder, tm, **kw)
        assert rec_engine.metrics.counters == plain.metrics.counters
        assert rec_engine.recorder.drains == rec_engine.metrics.counters["host_syncs"]


def test_fleet_session_round_trips_and_equals_jax(models, tmp_path):
    jm, tm = models
    path = str(tmp_path / "fleet.jsonl")
    chains = {}
    for side, engine_cls, fleet_cls, rec_cls, model in (
            ("torch", ServeEngine, ServeFleet, SessionRecorder, tm),
            ("jax", JServeEngine, JServeFleet, jbb.SessionRecorder, jm)):
        rec = rec_cls(path if side == "torch" else None, enabled=True)
        fleet = fleet_cls([engine_cls(model, decode_chunk=2, **BASE) for _ in range(3)],
                          record=rec)
        for w in _work(n=6, seed=3):
            fleet.submit(**w)
        while fleet.step():
            pass
        rec.close()
        chains[side] = (rec.chain, _comparable(rec.events))
    assert chains["torch"] == chains["jax"]
    assert validate_session_jsonl(path) == [] and jbb.validate_session_jsonl(path) == []
    events, _ = load_session(path)
    assert [e["kind"] for e in events[:5]] == ["session_header", "fleet", "geometry",
                                               "geometry", "geometry"]
    assert {e["source"] for e in events if e["kind"] == "drain"} <= {"r0", "r1", "r2"}
    v = replay_session(path, engine_factory=lambda r, g: ServeEngine(
        tm, **geometry_kwargs(g)))
    assert v["verdict"] == "match", v


def test_autoscaled_fleet_replays_its_decisions(models, tmp_path):
    _, tm = models
    path = str(tmp_path / "auto.jsonl")
    rec = SessionRecorder(path, enabled=True)
    make = lambda role="serve": ServeEngine(tm, decode_chunk=2, **BASE)  # noqa: E731
    fleet = ServeFleet([make()], record=rec)
    vectors = [{"state": "warn"}] * 3 + [{"state": "ok"}] * 9
    ctrl = AutoscaleController(
        fleet, ScalingPolicy(min_replicas=1, max_replicas=2, windows=(2, 6), up_sustain=2,
                             down_sustain=4, up_cooldown=2, down_cooldown=4),
        engine_factory=make, signal_fn=replay_signal(vectors), flight=False)
    for w in _work(n=3):
        fleet.submit(**w)
    for _ in vectors:
        fleet.step()
        ctrl.tick()
    while fleet.step():
        pass
    rec.close()
    assert validate_session_jsonl(path) == []
    events, _ = load_session(path)
    actions = [e["action"] for e in events if e["kind"] == "ctrl_tick"]
    assert len(actions) == len(vectors) and "scale_up" in actions
    v = replay_session(path, engine_factory=lambda r, g: ServeEngine(tm, **geometry_kwargs(g)))
    assert v["verdict"] == "match", v
    assert v["autoscale"] == {"ticks": len(vectors), "match": True}


def test_trainer_session_round_trips(tmp_path):
    from torchdistx_tpu_torch.trainer import TrainStep, Trainer, batch_digest

    def run(path):
        tt.manual_seed(0)
        model = TLlama.from_name("tiny", device="cpu")
        opt = torch.optim.SGD(model.parameters(), lr=1e-2)
        step = TrainStep(model, opt, lambda m, b: m(b[:, :-1]).logsumexp(-1).mean())
        rs = np.random.RandomState(1)
        batches = [torch.from_numpy(rs.randint(0, 256, (2, 9))) for _ in range(3)]
        trainer = Trainer(step, record=path, log_every=1, log_fn=lambda m: None)
        trainer.fit(iter(batches), 3)
        trainer.recorder.close()
        return trainer, batches

    path = str(tmp_path / "train.jsonl")
    trainer, batches = run(path)
    assert validate_session_jsonl(path) == []
    events, _ = load_session(path)
    head = next(e for e in events if e["kind"] == "trainer")
    assert head["step_type"] == "TrainStep"
    steps = [e for e in events if e["kind"] == "train_step"]
    assert [e["step"] for e in steps] == [0, 1, 2]
    assert [e["batch"] for e in steps] == [batch_digest(b) for b in batches]
    again = [e["batch"] for e in load_session(run(str(tmp_path / "b.jsonl"))[0].recorder.path)[0]
             if e["kind"] == "train_step"]
    assert again == [e["batch"] for e in steps]
    assert batch_digest(batches[0]) != batch_digest(batches[1])


def test_kill_switch_turns_recording_off(models, monkeypatch, tmp_path):
    _, tm = models
    monkeypatch.setenv("TDX_SESSION_RECORD", "0")
    path = tmp_path / "off.jsonl"
    engine = ServeEngine(tm, record=str(path), **BASE)
    engine.run([dict(w) for w in _work(n=2)])
    assert not engine.recorder.enabled and engine.recorder.events == []
    assert not path.exists()
    # an explicit recorder (the replay harness's own) still records
    assert resolve_record(SessionRecorder(None, enabled=True)).enabled
    monkeypatch.setenv("TDX_SESSION_RECORD", "1")
    assert resolve_record(True).enabled
    with pytest.raises(TypeError):
        resolve_record(3.14)


def test_replay_script_prints_verdict_and_first_divergence(tmp_path, capsys):
    """``scripts/torch_replay_session.py`` rebuilds the model from the
    recording's ``model_spec`` and replays on the device it is given."""
    import importlib.util
    import json
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "torch_replay_session",
        Path(__file__).resolve().parent.parent / "scripts" / "torch_replay_session.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    tt.manual_seed(5)
    model = TLlama.from_name("tiny", device="cpu", dtype=torch.float32).requires_grad_(False)
    path = str(tmp_path / "s.jsonl")
    rec = SessionRecorder(path, enabled=True)
    rec.record("model_spec", family="llama", name="tiny", seed=5, dtype="float32",
               overrides={})
    ServeEngine(model, record=rec, **BASE).run([dict(w) for w in _work()])
    rec.close()
    assert script.main([path, "--device", "cpu", "--strict"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("REPLAY MATCH") and json.loads(lines[-1])["verdict"] == "match"
    events, _ = load_session(path)
    pert, target = _perturb(events, lambda e: bool(e.get("tokens")) and e.update(
        tokens={r: [t + 1 for t in v] for r, v in e["tokens"].items()}) is None)
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write("\n".join(json.dumps(e) for e in pert) + "\n")
    assert script.main([bad, "--device", "cpu", "--strict"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith(f"REPLAY DIVERGENT at drain seq={target['seq']} ")
    assert json.loads(lines[-1])["first_divergence"]["seq"] == target["seq"]
