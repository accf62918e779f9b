"""Visitor core for tdx-lint, counterpart of ``torchdistx_tpu/analysis/core.py``
(a copy: stdlib only, the same ``tdx-lint-v1`` schema, so each package's
validator takes the other's report).

Design (mirrors the perf-gate contract in ``scripts/torch_perf_gate.py``):

* A **rule** is an object with ``rule_id``, ``severity``, an optional
  cross-file ``collect(ctx)`` pass and a mandatory ``check(ctx)`` pass.
  Two passes let a rule see the whole scan set (e.g. TDX105 matches
  emitted metric names against every registration site) while staying a
  single-process, stdlib-only tool.
* A **finding** is identified by ``(rule, path, line)`` — the key the
  exact baseline gate compares on.  Column and message are advisory
  (messages may improve without invalidating the baseline).
* **Suppressions** are trailing comments on the flagged line::

      foo()  # tdx-lint: disable=TDX102 -- sampler key, not param init

  The justification after ``--`` is REQUIRED: a bare ``disable=`` both
  fails to suppress and raises a TDX100 malformed-suppression finding,
  so silencing the linter always leaves a reviewable sentence behind.
"""

from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LINT_SCHEMA = "tdx-lint-v1"

_SEVERITIES = ("error", "warning")

_SUPPRESS_RE = re.compile(
    r"#\s*tdx-lint:\s*disable=(?P<rules>[A-Z0-9, ]+?)"
    r"(?:\s+--\s+(?P<why>.+?))?\s*$"
)


@dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str

    def key(self) -> Tuple[str, str, int]:
        return (self.rule, self.path, self.line)

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
        }


@dataclass(frozen=True)
class Suppression:
    """A parsed ``# tdx-lint: disable=...`` comment."""

    path: str
    line: int
    rules: Tuple[str, ...]
    justification: str  # "" when missing (malformed)

    @property
    def valid(self) -> bool:
        return bool(self.justification.strip())

    def to_dict(self) -> Dict[str, object]:
        return {
            "path": self.path,
            "line": self.line,
            "rules": list(self.rules),
            "justification": self.justification,
        }


class Rule:
    """Base class: subclasses set ``rule_id``/``severity``, implement hooks."""

    rule_id = "TDX000"
    severity = "error"
    #: one-line summary used by the CLI's --list-rules and the docs table
    summary = ""

    def collect(self, ctx: "LintContext") -> None:  # cross-file pass 1
        """Gather cross-file facts for every scanned file (optional)."""

    def check(self, ctx: "LintContext") -> List[Finding]:  # pass 2
        raise NotImplementedError

    # helper for subclasses
    def finding(
        self, ctx: "LintContext", node: ast.AST, message: str
    ) -> Finding:
        return Finding(
            rule=self.rule_id,
            severity=self.severity,
            path=ctx.rel_path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message,
        )


@dataclass
class LintContext:
    """Per-file state handed to rules, plus a shared cross-file scratchpad."""

    rel_path: str
    source: str
    tree: ast.Module
    #: shared across all files in one run_lint call; rules namespace their
    #: keys by rule id (e.g. shared["TDX105.registered"]).
    shared: Dict[str, object] = field(default_factory=dict)
    #: parent map so rules can walk lexically outward from a node.
    parents: Dict[ast.AST, ast.AST] = field(default_factory=dict)

    @classmethod
    def parse(
        cls, rel_path: str, source: str, shared: Dict[str, object]
    ) -> "LintContext":
        tree = ast.parse(source, filename=rel_path)
        parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                parents[child] = parent
        return cls(
            rel_path=rel_path,
            source=source,
            tree=tree,
            shared=shared,
            parents=parents,
        )

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        """Lexically enclosing def/lambda chain, innermost first."""
        out: List[ast.AST] = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                out.append(cur)
            cur = self.parents.get(cur)
        return out


def parse_suppressions(rel_path: str, source: str) -> List[Suppression]:
    """Extract every tdx-lint suppression comment via tokenize.

    tokenize (not a line regex) so that ``#`` inside string literals can
    never be misread as a comment.
    """
    out: List[Suppression] = []
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = tuple(
                r.strip() for r in m.group("rules").split(",") if r.strip()
            )
            out.append(
                Suppression(
                    path=rel_path,
                    line=tok.start[0],
                    rules=rules,
                    justification=(m.group("why") or "").strip(),
                )
            )
    except tokenize.TokenError:
        pass
    return out


def _apply_suppressions(
    findings: List[Finding], sups: List[Suppression]
) -> Tuple[List[Finding], List[Suppression]]:
    """Drop findings covered by a *valid* suppression on the same line.

    Malformed suppressions (no justification) suppress nothing and are
    themselves reported as TDX100 findings by the caller.
    """
    by_loc: Dict[Tuple[str, int], List[Suppression]] = {}
    for s in sups:
        by_loc.setdefault((s.path, s.line), []).append(s)

    kept: List[Finding] = []
    used: List[Suppression] = []
    for f in findings:
        covering = [
            s
            for s in by_loc.get((f.path, f.line), [])
            if s.valid and f.rule in s.rules
        ]
        if covering:
            used.extend(c for c in covering if c not in used)
            continue
        kept.append(f)
    return kept, used


def _malformed_suppression_findings(
    sups: Iterable[Suppression],
) -> List[Finding]:
    out = []
    for s in sups:
        if s.valid:
            continue
        out.append(
            Finding(
                rule="TDX100",
                severity="error",
                path=s.path,
                line=s.line,
                col=0,
                message=(
                    "suppression without justification: write "
                    "'# tdx-lint: disable=%s -- <why this is safe>'"
                    % ",".join(s.rules)
                ),
            )
        )
    return out


def lint_source(
    rel_path: str,
    source: str,
    rules: Sequence[Rule],
    shared: Optional[Dict[str, object]] = None,
) -> Tuple[List[Finding], List[Suppression]]:
    """Lint one in-memory file (test seam; run_lint is the batch entry point)."""
    shared = shared if shared is not None else {}
    ctx = LintContext.parse(rel_path, source, shared)
    for rule in rules:
        rule.collect(ctx)
    findings: List[Finding] = []
    for rule in rules:
        findings.extend(rule.check(ctx))
    sups = parse_suppressions(rel_path, source)
    findings, used = _apply_suppressions(findings, sups)
    findings.extend(_malformed_suppression_findings(sups))
    return findings, used


def _iter_py_files(paths: Sequence[str], root: Path) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        path = (root / p) if not Path(p).is_absolute() else Path(p)
        if path.is_dir():
            files.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py" and path.exists():
            files.append(path)
    # dedupe, stable order
    seen = set()
    out = []
    for f in files:
        if f in seen:
            continue
        seen.add(f)
        out.append(f)
    return out


def run_lint(
    paths: Sequence[str],
    rules: Sequence[Rule],
    root: Optional[str] = None,
) -> Dict[str, object]:
    """Scan ``paths`` (files or directories) and build a tdx-lint-v1 report.

    Two passes over the whole file set: collect (cross-file facts), then
    check.  Findings are sorted by (path, line, rule) so the report — and
    therefore the committed baseline — is byte-stable across runs.
    """
    root_path = Path(root) if root else Path.cwd()
    files = _iter_py_files(paths, root_path)

    shared: Dict[str, object] = {}
    contexts: List[LintContext] = []
    parse_failures: List[Finding] = []
    for f in files:
        rel = f.relative_to(root_path).as_posix() if f.is_relative_to(
            root_path
        ) else f.as_posix()
        try:
            src = f.read_text()
            ctx = LintContext.parse(rel, src, shared)
        except (SyntaxError, UnicodeDecodeError) as e:
            parse_failures.append(
                Finding(
                    rule="TDX000",
                    severity="error",
                    path=rel,
                    line=getattr(e, "lineno", 0) or 0,
                    col=0,
                    message="unparseable: %s" % e,
                )
            )
            continue
        contexts.append(ctx)

    for rule in rules:
        for ctx in contexts:
            rule.collect(ctx)

    findings: List[Finding] = list(parse_failures)
    suppressions: List[Suppression] = []
    for ctx in contexts:
        file_findings: List[Finding] = []
        for rule in rules:
            file_findings.extend(rule.check(ctx))
        sups = parse_suppressions(ctx.rel_path, ctx.source)
        file_findings, used = _apply_suppressions(file_findings, sups)
        file_findings.extend(_malformed_suppression_findings(sups))
        findings.extend(file_findings)
        suppressions.extend(used)

    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.col))
    suppressions.sort(key=lambda s: (s.path, s.line))
    return {
        "schema": LINT_SCHEMA,
        "files_scanned": len(files),
        "rules": sorted({r.rule_id for r in rules} | {"TDX100"}),
        "findings": [f.to_dict() for f in findings],
        "suppressions": [s.to_dict() for s in suppressions],
    }


def finding_key(d: Dict[str, object]) -> Tuple[str, str, int]:
    """Baseline identity of a finding dict: (rule, path, line)."""
    return (str(d["rule"]), str(d["path"]), int(d["line"]))  # type: ignore[arg-type]


def compare_to_baseline(
    report: Dict[str, object], baseline: Dict[str, object]
) -> Dict[str, List[Dict[str, object]]]:
    """Exact set-compare, perf-gate style.

    * ``new``: in the report but not the baseline → CI failure (fix or
      suppress with justification — never silently accumulate).
    * ``fixed``: in the baseline but no longer found → CI failure too,
      so the baseline can only shrink via an explicit
      ``--update-baseline`` refresh that the diff shows to reviewers.
    """
    cur = {finding_key(f): f for f in report.get("findings", [])}  # type: ignore[union-attr]
    base = {finding_key(f): f for f in baseline.get("findings", [])}  # type: ignore[union-attr]
    new = [cur[k] for k in sorted(cur.keys() - base.keys())]
    fixed = [base[k] for k in sorted(base.keys() - cur.keys())]
    return {"new": new, "fixed": fixed}


def validate_lint_report(doc: object) -> List[str]:
    """Schema check for tdx-lint-v1 (consumed by check_obs_artifacts --lint)."""
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["report is not a JSON object"]
    if doc.get("schema") != LINT_SCHEMA:
        errors.append(
            "schema: expected %r, got %r" % (LINT_SCHEMA, doc.get("schema"))
        )
    if not isinstance(doc.get("files_scanned"), int) or isinstance(
        doc.get("files_scanned"), bool
    ):
        errors.append("files_scanned: missing or not an int")
    if not isinstance(doc.get("rules"), list) or not all(
        isinstance(r, str) and re.fullmatch(r"TDX\d{3}", r)
        for r in doc.get("rules", [])
    ):
        errors.append("rules: must be a list of TDXnnn ids")
    findings = doc.get("findings")
    if not isinstance(findings, list):
        errors.append("findings: missing or not a list")
        findings = []
    for i, f in enumerate(findings):
        if not isinstance(f, dict):
            errors.append("findings[%d]: not an object" % i)
            continue
        for key, typ in (
            ("rule", str),
            ("severity", str),
            ("path", str),
            ("line", int),
            ("col", int),
            ("message", str),
        ):
            v = f.get(key)
            if not isinstance(v, typ) or isinstance(v, bool):
                errors.append("findings[%d].%s: missing or not %s" % (i, key, typ.__name__))
        if isinstance(f.get("severity"), str) and f["severity"] not in _SEVERITIES:
            errors.append(
                "findings[%d].severity: %r not in %s"
                % (i, f["severity"], list(_SEVERITIES))
            )
        if isinstance(f.get("rule"), str) and not re.fullmatch(
            r"TDX\d{3}", f["rule"]
        ):
            errors.append("findings[%d].rule: %r is not TDXnnn" % (i, f["rule"]))
    sups = doc.get("suppressions")
    if not isinstance(sups, list):
        errors.append("suppressions: missing or not a list")
        sups = []
    for i, s in enumerate(sups):
        if not isinstance(s, dict):
            errors.append("suppressions[%d]: not an object" % i)
            continue
        if not isinstance(s.get("path"), str):
            errors.append("suppressions[%d].path: missing or not str" % i)
        if not isinstance(s.get("line"), int) or isinstance(s.get("line"), bool):
            errors.append("suppressions[%d].line: missing or not int" % i)
        if not isinstance(s.get("rules"), list):
            errors.append("suppressions[%d].rules: missing or not list" % i)
        if not (
            isinstance(s.get("justification"), str)
            and s["justification"].strip()
        ):
            errors.append(
                "suppressions[%d].justification: required non-empty text" % i
            )
    return errors


def load_json(path: str) -> Dict[str, object]:
    with open(path) as fh:
        return json.load(fh)
