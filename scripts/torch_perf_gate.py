"""Perf regression gate CLI of the PyTorch/CUDA port, counterpart of
``scripts/perf_gate.py`` over ``torchdistx_tpu_torch.obs.ledger`` and
``torchdistx_tpu_torch.obs.gate`` (no JAX imported).

Ingests one bench artifact (any family ``obs.ledger`` knows:
``BENCH_SERVE_*.json``, a ``bench.py`` record, ``MULTICHIP_r*.json``,
``CAMPAIGN.json``, ...), then:

- compares every **counter** metric EXACTLY against the committed
  expectations file (deterministic counters regress like correctness
  bugs — an extra host sync fails CI);
- checks every **timing** metric against a direction-aware tolerance
  band around the best prior complete ledger row of the same platform +
  workload fingerprint (degraded rows never baseline; improvements
  always pass);
- prints a markdown verdict, then the full JSON verdict as the LAST
  stdout line (the repo's consumers-parse-the-last-line contract);
- exits nonzero under ``--strict`` when the verdict is not ok.

Usage:
  python scripts/torch_perf_gate.py BENCH_SERVE_CPU.json \
      --expectations expectations/serve_cpu_smoke.json \
      --ledger LEDGER_TORCH.jsonl --strict

Refreshing the pins after an INTENDED counter change (new decode path,
different sync discipline — anything that legitimately moves a
deterministic counter):
  python scripts/torch_perf_gate.py <fresh record> \
      --update-expectations expectations/serve_cpu_smoke.json

``--append`` adds the ingested rows to the ledger AFTER gating (so a
run is never its own baseline); the bench emitters already append on
emission, so CI normally gates without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torchdistx_tpu_torch.obs import gate as gate_mod  # noqa: E402
from torchdistx_tpu_torch.obs import ledger as ledger_mod  # noqa: E402


def _parse_args():
    ap = argparse.ArgumentParser(
        description="exact-counter + timing-band perf gate"
    )
    ap.add_argument("record", help="bench artifact to gate (any family)")
    ap.add_argument(
        "--expectations",
        default=None,
        help="committed tdx-expect-v1 file of exact counter pins",
    )
    ap.add_argument(
        "--ledger",
        default=None,
        help="tdx-ledger-v1 JSONL of prior runs (timing baselines); "
        "default TDX_LEDGER_PATH, else <repo>/LEDGER_TORCH.jsonl",
    )
    ap.add_argument(
        "--strict",
        action="store_true",
        help="exit nonzero when the gate fails (CI mode)",
    )
    ap.add_argument(
        "--append",
        action="store_true",
        help="append the ingested rows to the ledger after gating",
    )
    ap.add_argument(
        "--run-id", default=None, help="override the run id (default: "
        "artifact basename)"
    )
    ap.add_argument(
        "--update-expectations",
        metavar="PATH",
        default=None,
        help="(re)write the expectations file from this record's counter "
        "rows instead of gating — the refresh workflow after an "
        "intended counter change",
    )
    ap.add_argument(
        "--json-out",
        default=None,
        help="also write the JSON verdict to this path",
    )
    return ap.parse_args()


def main() -> None:
    args = _parse_args()
    rows = ledger_mod.ingest_artifact(args.record, run_id=args.run_id)

    if args.update_expectations:
        doc = gate_mod.build_expectations(
            rows,
            description=f"pinned from {os.path.basename(args.record)} "
            f"@ {rows[0].get('git_sha') if rows else None}",
        )
        with open(args.update_expectations, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        n = sum(len(m) for m in doc["counters"].values())
        print(
            f"torch_perf_gate: pinned {n} counter(s) across "
            f"{len(doc['counters'])} fingerprint(s) into "
            f"{args.update_expectations}"
        )
        return

    expectations = None
    if args.expectations:
        with open(args.expectations) as f:
            expectations = json.load(f)
    ledger_path = args.ledger or ledger_mod.default_ledger_path()
    ledger_rows = ledger_mod.read_ledger(ledger_path)

    verdict = gate_mod.gate_rows(rows, expectations, ledger_rows)
    print(gate_mod.render_gate_markdown(verdict))
    for f in verdict["failures"]:
        print(
            f"FAIL: {f.get('kind')}: {f.get('metric')}: "
            f"{f.get('detail', '')}",
            file=sys.stderr,
        )
    if args.append:
        n = ledger_mod.append_rows(ledger_path, rows)
        print(f"torch_perf_gate: appended {n} row(s) to {ledger_path}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(verdict, f, indent=1)
            f.write("\n")
    # the consumer contract: full JSON verdict as the last stdout line
    print(json.dumps(verdict))
    if args.strict and not verdict["ok"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
