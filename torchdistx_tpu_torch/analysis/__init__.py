"""tdx-lint of the port: AST-level static analysis for the invariants of
its torch code, counterpart of ``torchdistx_tpu/analysis``.

The port's correctness story rests on conventions no generic linter
enforces (initializers draw from the ``utils/rng.py`` counter stream,
collectives route through ``parallel/collectives.py`` so the comm audit
stays complete, bodies captured into a CUDA graph never host-sync, metrics
follow the registry contract, counter ledger rows stay deterministic).
This package encodes them as checkable rules over stdlib ``ast`` — no
third-party dependency, not even torch.  The rule ids and the
``tdx-lint-v1`` report are the JAX package's; TDX101 has no torch
counterpart (``RULE_CATALOG`` says why).

Public surface::

    from torchdistx_tpu_torch.analysis import run_lint, default_rules
    report = run_lint(paths, default_rules())   # tdx-lint-v1 dict
    diff = compare_to_baseline(report, baseline)
    errors = validate_lint_report(report)

CLI: ``python scripts/torch_tdx_lint.py --strict`` (exact-findings
baseline gate, perf-gate style).
"""

from .core import (
    LINT_SCHEMA,
    Finding,
    LintContext,
    Rule,
    Suppression,
    compare_to_baseline,
    finding_key,
    lint_source,
    parse_suppressions,
    run_lint,
    validate_lint_report,
)
from .rules import RULE_CATALOG, default_rules

__all__ = [
    "LINT_SCHEMA",
    "Finding",
    "LintContext",
    "Rule",
    "Suppression",
    "RULE_CATALOG",
    "compare_to_baseline",
    "default_rules",
    "finding_key",
    "lint_source",
    "parse_suppressions",
    "run_lint",
    "validate_lint_report",
]
