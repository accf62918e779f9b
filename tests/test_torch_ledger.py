"""The port's ledger and perf gate (``torchdistx_tpu_torch.obs.ledger``,
``obs.gate``, ``scripts/torch_perf_gate.py``) against the JAX package's on
the CPU.

Every committed artifact (the bench, serving, multichip and kernel
acceptance records) is ingested by both ledgers with the same fixed
``git_sha`` and ``ts``: the rows must be EQUAL, each passes the other
package's validator, and the gate gives the same verdict on every committed
``expectations/serve_cpu_*.json``.  A port ``ServeEngine`` record of a tiny
CPU workload gives the JAX engine's counter rows, numerics digests
included (the ``cost_*`` rows apart: the port's cost cards count no FLOPs
or bytes yet).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _jax_isolation  # noqa: F401  (adapts jax.monitoring listeners)
import torchdistx_tpu as tdx
from torchdistx_tpu.models import Llama as JLlama
from torchdistx_tpu.obs import gate as jgate
from torchdistx_tpu.obs import ledger as jledger
from torchdistx_tpu.serve import ServeEngine as JServeEngine
from torchdistx_tpu_torch.interop import load_jax_params
from torchdistx_tpu_torch.models import Llama as TLlama
from torchdistx_tpu_torch.obs import gate, ledger
from torchdistx_tpu_torch.serve import ServeEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = sorted(
    os.path.basename(p) for pattern in ("BENCH_r0*.json", "BENCH_SERVE_CPU*.json",
                                        "MULTICHIP_r0*.json", "KERNEL_ACCEPT_SMOKE.json")
    for p in glob.glob(os.path.join(ROOT, pattern)))
EXPECTATIONS = sorted(os.path.basename(p) for p in
                      glob.glob(os.path.join(ROOT, "expectations", "serve_cpu_*.json")))
FIXED = dict(git_sha="0123456789ab", ts=1754300000.0)


def _rows(mod, name):
    return mod.ingest_artifact(os.path.join(ROOT, name), **FIXED)


def test_the_artifacts_are_there():
    assert len(ARTIFACTS) >= 15 and "KERNEL_ACCEPT_SMOKE.json" in ARTIFACTS
    assert len(EXPECTATIONS) >= 6


@pytest.mark.parametrize("name", ARTIFACTS)
def test_ingest_artifact_rows_equal_jax(name):
    got, want = _rows(ledger, name), _rows(jledger, name)
    assert want, name
    assert got == want


@pytest.mark.parametrize("name", ARTIFACTS)
def test_rows_pass_both_validators(name):
    for row in _rows(ledger, name):
        assert jledger.validate_ledger_row(row) == []
    for row in _rows(jledger, name):
        assert ledger.validate_ledger_row(row) == []


def test_validator_refuses_what_jax_refuses():
    row = _rows(ledger, "BENCH_SERVE_CPU.json")[0]
    for bad in (dict(row, schema="v0"), dict(row, metric_class="gauge"),
                dict(row, quality="partial"), {k: v for k, v in row.items() if k != "value"},
                dict(row, value=float("nan"))):
        assert ledger.validate_ledger_row(bad) == jledger.validate_ledger_row(bad)
        assert ledger.validate_ledger_row(bad)


@pytest.mark.parametrize("exp", EXPECTATIONS)
def test_gate_verdicts_equal_jax(exp):
    with open(os.path.join(ROOT, "expectations", exp)) as f:
        doc = json.load(f)
    assert gate.validate_expectations(doc) == jgate.validate_expectations(doc) == []
    history = [r for name in ARTIFACTS for r in _rows(jledger, name)]
    for name in ARTIFACTS:
        if not name.startswith("BENCH_SERVE_CPU"):
            continue
        rows = _rows(ledger, name)
        got = gate.gate_rows(rows, doc, history)
        want = jgate.gate_rows(rows, doc, history)
        assert got == want, (exp, name)
        assert gate.render_gate_markdown(got) == jgate.render_gate_markdown(want)


def test_build_expectations_equal_jax():
    rows = _rows(ledger, "BENCH_SERVE_CPU.json")
    got = gate.build_expectations(rows, description="pinned")
    assert got == jgate.build_expectations(rows, description="pinned")
    assert gate.gate_rows(rows, got, [])["ok"]
    for metric in ("host_syncs", "tokens_per_sec", "decode_s_p50"):
        assert gate.timing_direction(metric) == jgate.timing_direction(metric)


def test_ledger_file_round_trip_and_default_path(tmp_path, monkeypatch):
    rows = _rows(ledger, "MULTICHIP_r01.json")
    path = str(tmp_path / "ledger.jsonl")
    assert ledger.append_rows(path, rows) == len(rows)
    assert ledger.read_ledger(path) == jledger.read_ledger(path) == rows
    assert ledger.validate_ledger_file(path) == jledger.validate_ledger_file(path) == []
    # the port's rows never go to the JAX package's LEDGER.jsonl
    monkeypatch.delenv("TDX_LEDGER_PATH", raising=False)
    assert os.path.basename(ledger.default_ledger_path()) == "LEDGER_TORCH.jsonl"
    monkeypatch.setenv("TDX_LEDGER_PATH", path)
    assert ledger.default_ledger_path() == path


def test_fingerprint_and_stamp_equal_jax(monkeypatch):
    wl = {"phase": "k4", "model": "tiny", "decode_chunk": 4, "mesh": 1}
    assert ledger.fingerprint(wl) == jledger.fingerprint(wl)
    monkeypatch.setenv("TDX_GIT_SHA", "feedbeef")
    assert ledger.record_stamp() == jledger.record_stamp()
    assert ledger.git_sha() == "feedbeef"


def test_blackbox_takes_git_sha_from_the_ledger():
    from torchdistx_tpu_torch.obs import blackbox

    assert blackbox.git_sha is ledger.git_sha


def test_torch_perf_gate_cli(tmp_path):
    """``scripts/torch_perf_gate.py``: the JAX CLI's verdict on the same
    record and expectations, as its last stdout line."""
    def run(script, *args):
        out = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", script), *args],
                             capture_output=True, text=True, timeout=300, cwd=ROOT,
                             env=dict(os.environ, PYTHONPATH=ROOT, TDX_GIT_SHA="0123"))
        assert out.returncode == 0, out.stderr
        return json.loads(out.stdout.strip().splitlines()[-1])

    args = ("BENCH_SERVE_CPU_KVQUANT.json", "--expectations",
            "expectations/serve_cpu_kv_quant.json", "--strict")
    got = run("torch_perf_gate.py", *args, "--ledger", str(tmp_path / "t.jsonl"))
    want = run("perf_gate.py", *args, "--ledger", str(tmp_path / "j.jsonl"))
    assert got == want and got["ok"]
    pinned = tmp_path / "pins.json"
    out = subprocess.run([sys.executable, "scripts/torch_perf_gate.py",
                          "BENCH_SERVE_CPU.json", "--update-expectations", str(pinned)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert gate.validate_expectations(json.loads(pinned.read_text())) == []


# -- a serving record of each engine ------------------------------------------


@pytest.fixture(scope="module")
def models():
    tdx.manual_seed(0)
    jm = JLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64)
    tm = TLlama.from_name("tiny", n_kv_heads=2, max_seq_len=64, device="cpu")
    load_jax_params(tm, {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


def _record(engine, phase):
    return {"bench": "serve", "phases": {phase: {
        "platform": "cpu", "model": "tiny", "requests": 5, "max_new_tokens": 6,
        "num_slots": engine.num_slots, "max_len": engine.max_len,
        "decode_mode": engine.decode_mode, "decode_chunk": engine.decode_chunk,
        "page_size": engine.page_size, "kv_dtype": engine.kv_dtype, "numerics": True,
        "metrics": engine.metrics.to_json(),
        "numerics_book": engine.numerics_book.to_json()}}}


@pytest.mark.parametrize("kw", [{}, dict(decode_mode="persistent"),
                                dict(page_size=8, kv_dtype="int8", decode_chunk=2)],
                         ids=["chunked", "persistent", "paged-int8"])
def test_engine_record_counter_rows_equal_jax(models, kw):
    jm, tm = models
    rs = np.random.RandomState(3)
    reqs = [{"prompt": rs.randint(0, 256, (n,)).astype(np.int32), "max_new_tokens": 6,
             "temperature": 0.0, "seed": i} for i, n in enumerate((5, 9, 12, 7, 3))]
    common = dict(num_slots=2, max_len=64, prefill_buckets=(16,), numerics=True, **kw)
    je, te = JServeEngine(jm, **common), ServeEngine(tm, **common)
    je.run(reqs)
    te.run(reqs)

    def counters(mod, engine):
        rows = mod.ingest_serve_record(_record(engine, "p"), run_id="r", **FIXED)
        return {(r["fingerprint"], r["metric"]): r["value"] for r in rows
                if r["metric_class"] == "counter" and not r["metric"].startswith("cost_")}

    got, want = counters(ledger, te), counters(jledger, je)
    assert got == want
    assert sum(1 for fp, m in got if m.startswith("numerics_")) == 3 * 4
    for row in ledger.ingest_serve_record(_record(te, "p"), run_id="r", **FIXED):
        assert jledger.validate_ledger_row(row) == []
    # the JAX engine's record gates the port's exactly
    doc = jgate.build_expectations(jledger.ingest_serve_record(_record(je, "p"), **FIXED))
    verdict = gate.gate_rows(ledger.ingest_serve_record(_record(te, "p"), **FIXED), doc, [])
    assert verdict["ok"] and verdict["checked_counters"] > 0
