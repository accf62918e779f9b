"""The port's ledger scripts against the JAX package's, on the committed
artifacts: ``scripts/torch_perf_report.py`` (trend and ``--ab``) over the
committed ``LEDGER.jsonl`` prints what ``scripts/perf_report.py`` prints,
and ``scripts/torch_backfill_ledger.py`` writes from the committed
``BENCH_*.json`` / ``MULTICHIP_*.json`` / ``KERNEL_ACCEPT*.json`` the
ledger ``scripts/backfill_ledger.py`` writes, row for row, with the same
per-artifact report.  Each script runs in its own interpreter, as a user
runs it.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("TDX_LEDGER_PATH", None)
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / script), *args], cwd=cwd,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.mark.parametrize("args", [
    (),
    ("--metric", "host_syncs", "--platform", "cpu"),
    ("--source", "bench_serve", "--class", "counter", "--max-rows", "3"),
    ("--ab", "BENCH_r01", "BENCH_r03_local"),
    ("--ab", "BENCH_r01", "no_such_run"),
], ids=["trend", "metric", "source_class", "ab", "ab_missing"])
def test_perf_report_prints_what_the_jax_script_prints(args):
    ledger = ("--ledger", str(ROOT / "LEDGER.jsonl"))
    got = _run("torch_perf_report.py", *ledger, *args)
    want = _run("perf_report.py", *ledger, *args)
    assert got == want
    assert got.startswith("# A/B" if "--ab" in args else "# Perf trend report")


def test_backfill_writes_what_the_jax_script_writes(tmp_path):
    got_path, want_path = tmp_path / "torch.jsonl", tmp_path / "jax.jsonl"
    got = _run("torch_backfill_ledger.py", "--out", str(got_path))
    want = _run("backfill_ledger.py", "--out", str(want_path))
    assert got_path.read_bytes() == want_path.read_bytes()
    assert got_path.stat().st_size > 0
    strip = lambda text, name, path: text.replace(name, "").replace(str(path), "")  # noqa: E731
    assert (strip(got, "torch_backfill_ledger", got_path)
            == strip(want, "backfill_ledger", want_path))
    # append-only: an existing ledger is refused without --force
    env = dict(os.environ)
    again = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_backfill_ledger.py"),
                            "--out", str(got_path)], env=env, capture_output=True, text=True,
                           timeout=300)
    assert again.returncode != 0 and "append-only" in again.stderr
