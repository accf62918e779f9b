"""Expectations-driven perf regression gate (``tdx-expect-v1`` in,
``tdx-gate-v1`` out), counterpart of ``torchdistx_tpu/obs/gate.py``,
copied (stdlib only): its verdicts on the same rows are the JAX module's.

The CI-enforceable consequence of the ledger's counter/timing split
(:mod:`~torchdistx_tpu_torch.obs.ledger`):

- **counter** metrics are deterministic on a fixed platform, so they
  compare EXACTLY against a committed expectations file — a single
  extra host sync or decode dispatch fails the gate the way a wrong
  answer fails a correctness test (the consistency-by-construction
  argument of arXiv:2509.07003, applied to perf);
- **timing** metrics are noisy, so they get direction-aware tolerance
  bands against the *best prior* ledger row of the same platform +
  workload fingerprint — ``degraded`` rows never serve as the
  baseline, and improvements always pass.

Serve fingerprints carry a ``mesh=`` tag (the TP degree; 1 when
single-chip) so TP-serve counter rows gate against their own pins —
a 2-device mesh run dispatches the same programs but its fingerprint,
and therefore its expectations entry, is distinct
(``expectations/serve_cpu_mesh2.json`` vs ``serve_cpu_smoke.json``).

Expectations file shape (committed, machine-written by
``scripts/perf_gate.py --update-expectations``; the port's CLI is
``scripts/torch_perf_gate.py``)::

    {"schema": "tdx-expect-v1",
     "description": "...",
     "source": "bench_serve",
     "platform": "cpu",
     "timing_tolerance": 0.25,
     "counters": {"<workload fingerprint>": {"host_syncs": 70, ...}}}

Gate verdict shape::

    {"schema": "tdx-gate-v1", "ok": bool,
     "checked_counters": int, "checked_timings": int,
     "failures": [{"kind", "metric", "fingerprint", ...}],
     "skipped":  [...], "uncovered": [...]}

``render_gate_markdown`` turns the verdict into the human half of the
report; ``scripts/torch_perf_gate.py`` is the CLI that exits nonzero under
``--strict`` when ``ok`` is false.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from .ledger import fingerprint  # noqa: F401  (re-exported for callers)

EXPECT_SCHEMA = "tdx-expect-v1"
GATE_SCHEMA = "tdx-gate-v1"

#: default fractional tolerance for timing bands (CPU CI boxes are
#: noisy; on-chip campaigns can commit a tighter file)
DEFAULT_TIMING_TOLERANCE = 0.25

#: counters excluded from machine-written expectations: deterministic
#: per environment but not across jax versions/machines (warm-up compile
#: counts depend on the jit cache internals of the installed jax; the
#: cost cards' buffer-assignment sizes — arg/out/temp/peak — depend on
#: the installed XLA's layout and allocator choices, unlike the
#: HLO-analysis flop/byte counts, which stay pinned)
DEFAULT_COUNTER_EXCLUDE = frozenset(
    {
        "recompile_warmup_compiles",
        "compiled_programs",
        "cost_arg_bytes",
        "cost_out_bytes",
        "cost_temp_bytes",
        "cost_peak_bytes",
    }
)

#: suffix/name patterns whose timing metrics are better when HIGHER;
#: everything else (seconds, RSS, latency quantiles) is lower-is-better
_HIGHER_IS_BETTER = (
    "_per_sec",
    "mfu",
    "goodput",
    "vs_baseline",
    "_rate",
    "_reduction",
)


def timing_direction(metric: str) -> str:
    """``"higher"`` or ``"lower"`` — which way is better for *metric*."""
    m = metric.lower()
    return (
        "higher"
        if any(m.endswith(s) or m == s.strip("_") for s in _HIGHER_IS_BETTER)
        else "lower"
    )


def build_expectations(
    rows: List[dict],
    *,
    description: str = "",
    timing_tolerance: float = DEFAULT_TIMING_TOLERANCE,
    exclude: frozenset = DEFAULT_COUNTER_EXCLUDE,
) -> dict:
    """Pin every deterministic counter of *rows* (one ingested run) into
    an expectations document.  Refusing degraded rows keeps a wedged run
    from ever becoming the pin."""
    counters: Dict[str, Dict[str, float]] = {}
    source = platform = None
    for r in rows:
        if r.get("metric_class") != "counter" or r.get("metric") in exclude:
            continue
        if r.get("quality") != "complete":
            raise ValueError(
                "refusing to pin expectations from a degraded run "
                f"(row {r.get('metric')})"
            )
        source = source or r.get("source")
        platform = platform or r.get("platform")
        counters.setdefault(r["fingerprint"], {})[r["metric"]] = r["value"]
    if not counters:
        raise ValueError("no complete counter rows to pin")
    return {
        "schema": EXPECT_SCHEMA,
        "description": description,
        "source": source,
        "platform": platform,
        "timing_tolerance": timing_tolerance,
        "counters": counters,
    }


def validate_expectations(doc) -> List[str]:
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["expectations is not an object"]
    if doc.get("schema") != EXPECT_SCHEMA:
        errs.append(f"bad expectations schema {doc.get('schema')!r}")
    counters = doc.get("counters")
    if not isinstance(counters, dict) or not counters:
        errs.append("expectations carry no counters")
        return errs
    for fp, metrics in counters.items():
        if not isinstance(metrics, dict) or not metrics:
            errs.append(f"fingerprint {fp!r}: no metrics")
            continue
        for m, v in metrics.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                errs.append(f"{fp}/{m}: non-numeric expectation {v!r}")
    return errs


def _best_baseline(
    ledger_rows: List[dict],
    *,
    metric: str,
    fp: str,
    platform: Optional[str],
    direction: str,
    exclude_ids: frozenset,
) -> Optional[dict]:
    """The best prior COMPLETE row with the same platform + fingerprint
    + metric — the honesty rule in executable form: degraded rows are
    recorded in the ledger but never compared against.

    ``exclude_ids`` is the gated run's own identity set of ``(run_id,
    ts)`` pairs: a run must never baseline ITSELF, but a prior run that
    happens to share the run_id (the same artifact basename gated night
    after night) is exactly the baseline the gate exists for — hence
    identity is the pair, not the name."""
    best = None
    for r in ledger_rows:
        if (
            r.get("metric") != metric
            or r.get("fingerprint") != fp
            or r.get("platform") != platform
            or r.get("quality") != "complete"
            or r.get("metric_class") != "timing"
            or (r.get("run_id"), r.get("ts")) in exclude_ids
        ):
            continue
        v = r.get("value")
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        if (
            best is None
            or (direction == "higher" and v > best["value"])
            or (direction == "lower" and v < best["value"])
        ):
            best = r
    return best


def gate_rows(
    new_rows: List[dict],
    expectations: Optional[dict] = None,
    ledger_rows: Optional[List[dict]] = None,
) -> dict:
    """Gate one freshly-ingested run against the committed counter
    expectations and the ledger's timing baselines."""
    failures: List[dict] = []
    skipped: List[dict] = []
    uncovered: List[str] = []
    checked_counters = checked_timings = 0
    run_id = new_rows[0]["run_id"] if new_rows else None
    own_ids = frozenset(
        (r.get("run_id"), r.get("ts")) for r in new_rows
    )

    degraded = sorted(
        {r["metric"] for r in new_rows if r.get("quality") != "complete"}
    )
    if not new_rows:
        failures.append(
            {"kind": "empty_run", "metric": None,
             "detail": "record produced no ledger rows"}
        )
    elif degraded:
        failures.append(
            {
                "kind": "degraded_input",
                "metric": degraded[0],
                "detail": "run is degraded (wedged/partial) — "
                f"{len(degraded)} metric(s) carry quality=degraded and "
                "cannot be gated as evidence",
            }
        )

    by_key = {}
    for r in new_rows:
        by_key.setdefault((r["fingerprint"], r["metric"]), r)

    # -------- counters: exact compare against the committed pins --------
    if expectations:
        errs = validate_expectations(expectations)
        if errs:
            failures.extend(
                {"kind": "bad_expectations", "metric": None, "detail": e}
                for e in errs
            )
        for fp, metrics in (expectations.get("counters") or {}).items():
            if not isinstance(metrics, dict):
                continue
            for metric, expected in metrics.items():
                checked_counters += 1
                row = by_key.get((fp, metric))
                if row is None:
                    failures.append(
                        {
                            "kind": "missing_counter",
                            "metric": metric,
                            "fingerprint": fp,
                            "expected": expected,
                            "detail": "expected counter row absent from "
                            "the record",
                        }
                    )
                    continue
                actual = row["value"]
                if not _num_eq(actual, expected):
                    failures.append(
                        {
                            "kind": "counter_mismatch",
                            "metric": metric,
                            "fingerprint": fp,
                            "expected": expected,
                            "actual": actual,
                            "detail": f"{metric} expected {expected} got "
                            f"{actual} (exact counter gate)",
                        }
                    )
        pinned = {
            (fp, m)
            for fp, ms in (expectations.get("counters") or {}).items()
            if isinstance(ms, dict)
            for m in ms
        }
        uncovered = sorted(
            {
                f"{r['metric']} @ {r['fingerprint']}"
                for r in new_rows
                if r.get("metric_class") == "counter"
                and r["metric"] not in DEFAULT_COUNTER_EXCLUDE
                and (r["fingerprint"], r["metric"]) not in pinned
            }
        )

    # -------- timings: tolerance band vs best prior ledger row --------
    tol = (expectations or {}).get(
        "timing_tolerance", DEFAULT_TIMING_TOLERANCE
    )
    for r in new_rows:
        if r.get("metric_class") != "timing":
            continue
        direction = timing_direction(r["metric"])
        base = _best_baseline(
            ledger_rows or [],
            metric=r["metric"],
            fp=r["fingerprint"],
            platform=r.get("platform"),
            direction=direction,
            exclude_ids=own_ids,
        )
        if base is None:
            skipped.append(
                {
                    "kind": "no_baseline",
                    "metric": r["metric"],
                    "fingerprint": r["fingerprint"],
                }
            )
            continue
        checked_timings += 1
        v, b = r["value"], base["value"]
        if direction == "higher":
            bound = b * (1.0 - tol)
            bad = v < bound
        else:
            bound = b * (1.0 + tol)
            bad = v > bound
        if bad and r.get("quality") == "complete":
            failures.append(
                {
                    "kind": "timing_regression",
                    "metric": r["metric"],
                    "fingerprint": r["fingerprint"],
                    "actual": v,
                    "baseline": b,
                    "baseline_run": base.get("run_id"),
                    "bound": bound,
                    "direction": direction,
                    "detail": f"{r['metric']} {v:.6g} vs best prior "
                    f"{b:.6g} ({base.get('run_id')}), "
                    f"{direction}-is-better band {bound:.6g} at "
                    f"tol {tol:g}",
                }
            )
    return {
        "schema": GATE_SCHEMA,
        "ok": not failures,
        "run_id": run_id,
        "checked_counters": checked_counters,
        "checked_timings": checked_timings,
        "failures": failures,
        "skipped": skipped,
        "uncovered": uncovered,
    }


def _num_eq(a, b) -> bool:
    """Exact numeric equality for the counter gate.  Integers compare as
    integers; floats (counter-derived exact ratios like syncs_per_token)
    must round-trip bit-equal through JSON, which `==` on the parsed
    doubles is."""
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    if not isinstance(a, (int, float)) or not isinstance(b, (int, float)):
        return False
    if isinstance(a, float) or isinstance(b, float):
        return (
            math.isfinite(a) and math.isfinite(b) and float(a) == float(b)
        )
    return a == b


def render_gate_markdown(verdict: dict) -> str:
    """The human half of the gate's report."""
    lines = [
        "# Perf gate — "
        + ("PASS" if verdict.get("ok") else "**FAIL**"),
        "",
        f"- run: `{verdict.get('run_id')}`",
        f"- exact counters checked: {verdict.get('checked_counters', 0)}",
        f"- timing bands checked: {verdict.get('checked_timings', 0)} "
        f"({len(verdict.get('skipped') or [])} without a baseline)",
        "",
    ]
    failures = verdict.get("failures") or []
    if failures:
        lines += [
            "## Failures",
            "",
            "| kind | metric | detail |",
            "| --- | --- | --- |",
        ]
        for f in failures:
            lines.append(
                f"| {f.get('kind')} | `{f.get('metric')}` "
                f"| {f.get('detail', '')} |"
            )
        lines.append("")
    uncovered = verdict.get("uncovered") or []
    if uncovered:
        lines += [
            "## Uncovered counters (not pinned — refresh expectations "
            "with `--update-expectations` to cover)",
            "",
        ]
        lines += [f"- `{u}`" for u in uncovered[:20]]
        if len(uncovered) > 20:
            lines.append(f"- … and {len(uncovered) - 20} more")
        lines.append("")
    return "\n".join(lines)
