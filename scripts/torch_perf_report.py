"""Trend and differential analytics over a benchmark ledger (schema
``tdx-ledger-v1``) for the PyTorch/CUDA port: the counterpart of
``scripts/perf_report.py`` over ``torchdistx_tpu_torch.obs.ledger`` and
``torchdistx_tpu_torch.obs.gate`` (no JAX imported).  The ledger defaults
to the port's (``TDX_LEDGER_PATH``, else ``<repo>/LEDGER_TORCH.jsonl``);
``--ledger LEDGER.jsonl`` reads the JAX package's, and prints what its
script prints.

Two modes, both rendering markdown to stdout:

- **trend** (default): one time-series table per (platform, metric,
  fingerprint) group, rows ordered by timestamp — run id, git sha,
  quality, value, and the delta vs the previous COMPLETE row.  Degraded
  rows are shown (the trajectory never hides a wedged round) but never
  used as the delta base.
- **A/B** (``--ab RUN_A RUN_B``): a differential table of every metric
  the two runs share (matched by fingerprint + metric), with the delta
  signed by the metric's direction (``obs.gate.timing_direction``) so
  "better"/"worse" reads correctly for tok/s and for seconds alike.

Usage:
  python scripts/torch_perf_report.py                   # full trend
  python scripts/torch_perf_report.py --metric host_syncs --platform cpu
  python scripts/torch_perf_report.py --source bench_serve --class counter
  python scripts/torch_perf_report.py --ledger LEDGER.jsonl --ab BENCH_r01 BENCH_r03_local
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torchdistx_tpu_torch.obs.gate import timing_direction  # noqa: E402
from torchdistx_tpu_torch.obs.ledger import (  # noqa: E402
    default_ledger_path,
    read_ledger,
)


def _parse_args():
    ap = argparse.ArgumentParser(description="ledger trend/A/B report")
    ap.add_argument("--ledger", default=None,
                    help="default TDX_LEDGER_PATH, else <repo>/LEDGER_TORCH.jsonl")
    ap.add_argument("--metric", action="append", default=None,
                    help="restrict to metric name(s); repeatable")
    ap.add_argument("--platform", default=None, help="cpu|tpu filter")
    ap.add_argument("--source", default=None,
                    help="artifact family filter (bench, bench_serve, ...)")
    ap.add_argument("--class", dest="metric_class", default=None,
                    choices=["counter", "timing"],
                    help="restrict to one metric class")
    ap.add_argument("--ab", nargs=2, metavar=("RUN_A", "RUN_B"),
                    default=None, help="differential between two run ids")
    ap.add_argument("--max-rows", type=int, default=40,
                    help="per-series row cap in the trend tables")
    return ap.parse_args()


def _fmt(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _filter(rows, args):
    out = []
    for r in rows:
        if args.metric and r.get("metric") not in args.metric:
            continue
        if args.platform and r.get("platform") != args.platform:
            continue
        if args.source and r.get("source") != args.source:
            continue
        if args.metric_class and r.get("metric_class") != args.metric_class:
            continue
        out.append(r)
    return out


def _series_key(r):
    return (
        r.get("source") or "",
        r.get("platform") or "",
        r.get("metric") or "",
        r.get("fingerprint") or "",
    )


def trend_report(rows, max_rows: int) -> str:
    series = defaultdict(list)
    for r in rows:
        series[_series_key(r)].append(r)
    lines = ["# Perf trend report", "",
             f"{len(rows)} row(s), {len(series)} series", ""]
    for key in sorted(series):
        source, platform, metric, fp = key
        pts = sorted(series[key], key=lambda r: (r.get("ts") or 0,
                                                 r.get("run_id") or ""))
        if len(pts) > max_rows:
            dropped = len(pts) - max_rows
            pts = pts[-max_rows:]
        else:
            dropped = 0
        head = f"## `{metric}` — {source} / {platform or '?'}"
        lines += [head, "", f"fingerprint: `{fp or '(none)'}`", ""]
        if dropped:
            lines.append(f"_{dropped} older row(s) elided_\n")
        lines += ["| run | git sha | quality | value | Δ vs prev complete |",
                  "| --- | --- | --- | --- | --- |"]
        prev = None
        for p in pts:
            v = p.get("value")
            delta = "—"
            if prev is not None and isinstance(v, (int, float)):
                d = v - prev
                pct = f" ({d / prev * 100:+.1f}%)" if prev else ""
                delta = f"{d:+.6g}{pct}"
            lines.append(
                f"| {p.get('run_id')} | {p.get('git_sha') or '—'} "
                f"| {p.get('quality')} | {_fmt(v)} | {delta} |"
            )
            if p.get("quality") == "complete" and isinstance(
                v, (int, float)
            ):
                prev = v
        lines.append("")
    return "\n".join(lines)


def ab_report(rows, run_a: str, run_b: str) -> str:
    def index(run_id):
        out = {}
        for r in rows:
            if r.get("run_id") == run_id:
                out[(r.get("fingerprint"), r.get("metric"))] = r
        return out

    a, b = index(run_a), index(run_b)
    if not a or not b:
        missing = [rid for rid, idx in ((run_a, a), (run_b, b)) if not idx]
        return (
            f"# A/B report\n\nno ledger rows for run id(s): "
            f"{', '.join(missing)}\n"
        )
    shared = sorted(set(a) & set(b), key=lambda k: (k[1], k[0]))
    lines = [
        f"# A/B: `{run_a}` vs `{run_b}`",
        "",
        f"{len(shared)} shared metric(s) "
        f"({len(a)} in A, {len(b)} in B)",
        "",
        "| metric | fingerprint | A | B | Δ | verdict |",
        "| --- | --- | --- | --- | --- | --- |",
    ]
    for fp, metric in shared:
        ra, rb = a[(fp, metric)], b[(fp, metric)]
        va, vb = ra.get("value"), rb.get("value")
        if not isinstance(va, (int, float)) or not isinstance(
            vb, (int, float)
        ):
            continue
        d = vb - va
        pct = f" ({d / va * 100:+.1f}%)" if va else ""
        if ra.get("metric_class") == "counter":
            verdict = "same" if d == 0 else "**changed**"
        else:
            better_high = timing_direction(metric) == "higher"
            if d == 0:
                verdict = "same"
            elif (d > 0) == better_high:
                verdict = "better"
            else:
                verdict = "worse"
        degraded = "degraded" in (ra.get("quality"), rb.get("quality"))
        if degraded:
            verdict += " (degraded)"
        short_fp = fp if len(fp) <= 48 else fp[:45] + "..."
        # the fingerprint separator is '|' — escape it or it splits the
        # markdown table cells
        short_fp = short_fp.replace("|", "\\|")
        lines.append(
            f"| `{metric}` | `{short_fp}` | {_fmt(va)} | {_fmt(vb)} "
            f"| {d:+.6g}{pct} | {verdict} |"
        )
    lines.append("")
    return "\n".join(lines)


def main() -> None:
    args = _parse_args()
    path = args.ledger or default_ledger_path()
    rows = read_ledger(path)
    if not rows:
        raise SystemExit(f"torch_perf_report: no valid ledger rows in {path}")
    rows = _filter(rows, args)
    if args.ab:
        print(ab_report(rows, args.ab[0], args.ab[1]))
    else:
        print(trend_report(rows, args.max_rows))


if __name__ == "__main__":
    main()
