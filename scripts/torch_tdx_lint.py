"""tdx-lint CLI of the port — AST invariant checker gated by an
exact-findings baseline, counterpart of ``scripts/tdx_lint.py``.

Runs the ``torchdistx_tpu_torch.analysis`` rule pack (TDX102..TDX106,
plus TDX100 malformed-suppression; TDX101 has no torch counterpart) over
the port's lint scope (``torchdistx_tpu_torch/``, ``chip_smoke.py``,
``scripts/torch_*.py``) and compares the
findings EXACTLY against the committed baseline, perf-gate style:

- a **new** finding fails CI naming the rule and ``file:line`` — fix it
  or suppress it on the line with a justification
  (``# tdx-lint: disable=TDXnnn -- why``);
- a **fixed** finding (in the baseline, no longer found) also fails,
  so the baseline only shrinks via an explicit ``--update-baseline``
  refresh that reviewers see in the diff.

Prints per-finding lines and a markdown verdict, then the full JSON
verdict as the LAST stdout line (the repo's consumers-parse-the-last-
line contract); exits 1 under ``--strict`` when not ok, 2 on usage
errors.

Usage:
  python scripts/torch_tdx_lint.py --strict
  python scripts/torch_tdx_lint.py --update-baseline   # after an intended change
  python scripts/torch_tdx_lint.py path/to/file.py --no-baseline   # ad-hoc scan

Neither torch nor jax is imported: the analysis package is loaded without
``torchdistx_tpu_torch/__init__``.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_analysis():
    """Import torchdistx_tpu_torch.analysis WITHOUT the parent package.

    The analysis package is pure stdlib, but ``torchdistx_tpu_torch/__init__``
    imports torch — which a lint container need not have.
    """
    pkg_dir = os.path.join(REPO_ROOT, "torchdistx_tpu_torch", "analysis")
    spec = importlib.util.spec_from_file_location(
        "_tdx_torch_analysis",
        os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir],
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules["_tdx_torch_analysis"] = mod
    spec.loader.exec_module(mod)
    return mod


_analysis = _load_analysis()
RULE_CATALOG = _analysis.RULE_CATALOG
compare_to_baseline = _analysis.compare_to_baseline
default_rules = _analysis.default_rules
run_lint = _analysis.run_lint

#: the committed lint scope — the port, its smoke and its scripts.
DEFAULT_BASELINE = "expectations/static_analysis_baseline_torch.json"


def default_paths(root: str = REPO_ROOT) -> list:
    """``torchdistx_tpu_torch``, ``chip_smoke.py`` and ``scripts/torch_*.py``
    under ``root``, relative to it."""
    scripts = sorted(
        os.path.relpath(p, root)
        for p in glob.glob(os.path.join(root, "scripts", "torch_*.py"))
    )
    return ["torchdistx_tpu_torch", "chip_smoke.py"] + scripts


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="AST invariant checker (exact-findings baseline gate)"
    )
    ap.add_argument(
        "paths",
        nargs="*",
        default=[],
        help="files/dirs to scan (default: the committed lint scope)",
    )
    ap.add_argument(
        "--root",
        default=REPO_ROOT,
        help="tree to scan (default: this checkout); paths, the default "
        "scope and the default baseline are taken under it",
    )
    ap.add_argument(
        "--baseline",
        default=None,
        help="committed tdx-lint-v1 baseline (default: ROOT/%s)" % DEFAULT_BASELINE,
    )
    ap.add_argument(
        "--no-baseline",
        action="store_true",
        help="skip the baseline compare (ad-hoc scans of arbitrary paths)",
    )
    ap.add_argument(
        "--strict",
        action="store_true",
        help="exit nonzero when the verdict is not ok (CI mode)",
    )
    ap.add_argument(
        "--update-baseline",
        action="store_true",
        help="rewrite the baseline from this scan instead of gating — the "
        "refresh workflow after an intended fix or accepted finding",
    )
    ap.add_argument(
        "--json-out",
        default=None,
        help="also write the JSON verdict to this path",
    )
    ap.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule catalog and exit",
    )
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv)
    if args.list_rules:
        for rid in sorted(RULE_CATALOG):
            sev, summary = RULE_CATALOG[rid]
            print("%s  %-7s %s" % (rid, sev, summary))
        return 0

    root = os.path.abspath(args.root)
    if args.baseline is None:
        args.baseline = os.path.join(root, DEFAULT_BASELINE)
    paths = args.paths or default_paths(root)
    report = run_lint(paths, default_rules(), root=root)

    for f in report["findings"]:
        print(
            "%s %s:%d:%d %s"
            % (f["rule"], f["path"], f["line"], f["col"], f["message"])
        )

    if args.update_baseline:
        doc = dict(report)
        doc["description"] = (
            "exact-findings lint baseline of the port; refresh ONLY via "
            "scripts/torch_tdx_lint.py --update-baseline after an intended change"
        )
        os.makedirs(os.path.dirname(args.baseline), exist_ok=True)
        with open(args.baseline, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(
            "tdx_lint: pinned %d finding(s) across %d file(s) into %s"
            % (len(report["findings"]), report["files_scanned"], args.baseline)
        )
        return 0

    verdict = {
        "schema": "tdx-lint-verdict-v1",
        "ok": True,
        "files_scanned": report["files_scanned"],
        "findings": len(report["findings"]),
        "suppressions": len(report["suppressions"]),
        "new": [],
        "fixed": [],
    }
    if args.no_baseline:
        verdict["ok"] = not report["findings"]
        verdict["new"] = list(report["findings"])
    else:
        if not os.path.exists(args.baseline):
            print(
                "tdx_lint: baseline %s not found (run --update-baseline "
                "to create it)" % args.baseline,
                file=sys.stderr,
            )
            return 2
        with open(args.baseline) as fh:
            baseline = json.load(fh)
        diff = compare_to_baseline(report, baseline)
        verdict["new"] = diff["new"]
        verdict["fixed"] = diff["fixed"]
        verdict["ok"] = not diff["new"] and not diff["fixed"]

    print("## tdx-lint verdict")
    print(
        "- scanned %d file(s): %d finding(s), %d suppression(s)"
        % (
            verdict["files_scanned"],
            verdict["findings"],
            verdict["suppressions"],
        )
    )
    status = "OK" if verdict["ok"] else "FAIL"
    print("- status: **%s**" % status)
    for f in verdict["new"]:
        print(
            "FAIL: new finding %s at %s:%d — %s"
            % (f["rule"], f["path"], f["line"], f["message"]),
            file=sys.stderr,
        )
    for f in verdict["fixed"]:
        print(
            "FAIL: baseline finding %s at %s:%d no longer present — "
            "refresh with --update-baseline" % (f["rule"], f["path"], f["line"]),
            file=sys.stderr,
        )

    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(verdict, fh, indent=1)
            fh.write("\n")
    # the consumer contract: full JSON verdict as the last stdout line
    print(json.dumps(verdict))
    return 1 if (args.strict and not verdict["ok"]) else 0


if __name__ == "__main__":
    sys.exit(main())
