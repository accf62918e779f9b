"""Backfill a ledger from every committed bench artifact: the PyTorch/CUDA
port's counterpart of ``scripts/backfill_ledger.py`` over
``torchdistx_tpu_torch.obs.ledger`` (no JAX imported).  It writes the
port's ledger, ``<repo>/LEDGER_TORCH.jsonl``, by default; the rows of an
artifact are the JAX script's, row for row.

Normalizes the whole committed evidence trail — ``BENCH_r01..r05``,
``BENCH_r03_local``, ``BENCH_SERVE_<CPU|TPU>.json``,
``MULTICHIP_r01..r05``, ``CAMPAIGN.json``, ``KERNEL_ACCEPT*.json`` —
into ``tdx-ledger-v1`` rows, attributed to the commit that landed each
artifact (``git log -1`` sha + author time, since the old records carry
no stamp of their own) and ordered by that time, so the perf trajectory
is populated from PR 1 onward.  Degraded rounds (the r02 crash, the r03
timeout, the r04/r05 wedged-relay runs) land with ``quality: degraded``
— recorded, never a baseline.

The live ledger is append-only; this script is the one sanctioned
rewrite (regenerating history from the artifacts it is derived from),
so it refuses to touch an existing file without ``--force``.

Usage:
  python scripts/torch_backfill_ledger.py         # writes <repo>/LEDGER_TORCH.jsonl
  python scripts/torch_backfill_ledger.py --force # regenerate in place
  python scripts/torch_backfill_ledger.py --out ledger.jsonl
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torchdistx_tpu_torch.obs import ledger as ledger_mod  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARTIFACT_GLOBS = (
    "BENCH_r*.json",
    "BENCH_SERVE_*.json",
    "MULTICHIP_r*.json",
    "CAMPAIGN.json",
    "KERNEL_ACCEPT.json",
    "KERNEL_ACCEPT_SMOKE.json",
)


def collect_rows(repo: str = REPO) -> tuple:
    rows, report = [], []
    for pattern in ARTIFACT_GLOBS:
        for path in sorted(glob.glob(os.path.join(repo, pattern))):
            try:
                got = ledger_mod.ingest_artifact(path)
            except (OSError, ValueError) as e:
                report.append((os.path.basename(path), f"SKIPPED: {e}"))
                continue
            rows.extend(got)
            quals = sorted({r["quality"] for r in got})
            report.append(
                (os.path.basename(path),
                 f"{len(got)} row(s), quality={','.join(quals) or 'n/a'}")
            )
    rows.sort(key=lambda r: (r.get("ts") or 0, r["run_id"], r["metric"]))
    return rows, report


def main() -> None:
    ap = argparse.ArgumentParser(description="regenerate the ledger from "
                                 "committed artifacts")
    ap.add_argument("--out", default=os.path.join(REPO,
                                                  ledger_mod.LEDGER_BASENAME))
    ap.add_argument("--force", action="store_true",
                    help="overwrite an existing ledger")
    args = ap.parse_args()
    if os.path.exists(args.out) and not args.force:
        raise SystemExit(
            f"{args.out} exists — the ledger is append-only; pass --force "
            "to regenerate it from the committed artifacts"
        )
    rows, report = collect_rows()
    for name, line in report:
        print(f"  {name}: {line}")
    if not rows:
        raise SystemExit("torch_backfill_ledger: no artifacts ingested")
    if os.path.exists(args.out):
        os.remove(args.out)
    n = ledger_mod.append_rows(args.out, rows)
    errs = ledger_mod.validate_ledger_file(args.out)
    if errs:
        raise SystemExit("backfill produced an invalid ledger: "
                         + "; ".join(errs[:5]))
    print(f"torch_backfill_ledger: {n} row(s) from {len(report)} artifact(s) "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
