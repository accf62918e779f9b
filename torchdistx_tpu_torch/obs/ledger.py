"""Unified benchmark ledger (``tdx-ledger-v1``), counterpart of
``torchdistx_tpu/obs/ledger.py``: the same rows, validator and adapters,
copied (the module is stdlib only), so the two packages' rows compare and
gate against each other.

Every bench emitter writes parseable JSON records (the bench and serving
benchmarks, the campaign driver, the multichip harvest, the kernel
acceptance sweep, flight dumps); this module turns each artifact family
into one append-only JSONL trajectory of per-metric rows, which the perf
gate (:mod:`~torchdistx_tpu_torch.obs.gate`,
``scripts/torch_perf_gate.py``) reads.

One ledger **row** is one metric observation::

    {"schema": "tdx-ledger-v1",
     "run_id":  "BENCH_SERVE_CPU",          # the producing run
     "source":  "bench_serve",              # artifact family
     "artifact": "BENCH_SERVE_CPU.json",    # provenance (optional)
     "ts":      1754300000.0,               # unix seconds (optional)
     "git_sha": "6a7d849...",               # commit attribution (or null)
     "platform": "cpu",
     "workload": {"phase": "k4", "model": "tiny", ...},
     "fingerprint": "decode_chunk=4|decode_mode=chunked|...",
     "metric": "host_syncs",
     "value": 70,
     "unit": null,
     "metric_class": "counter",             # or "timing"
     "quality": "complete"}                 # or "degraded"

``counter`` rows are deterministic on a fixed platform (host syncs,
dispatches, loop iterations, wire bytes, the numerics digests' integer
fields) and gate exactly; ``timing`` rows are noisy and only get
direction-aware tolerance bands against the best prior complete row of the
same platform and fingerprint.  ``degraded`` runs are recorded but never
become the comparison baseline.

**Where rows go.**  The JAX package appends to ``LEDGER.jsonl`` at the
repo root; the port never writes that file.  :func:`default_ledger_path`
is ``TDX_LEDGER_PATH`` when set, else ``LEDGER_TORCH.jsonl`` at the repo
root, a file of the port's own.

``git_sha`` lives here (the session black box, ``obs.blackbox``, imports
it).  Stdlib only, like the JAX module.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import time
from typing import Iterable, List, Optional

LEDGER_SCHEMA = "tdx-ledger-v1"
#: stamped into every bench emitter's record (satellite: records were
#: previously unattributable to commits)
RECORD_SCHEMA = "tdx-record-v1"
#: the port's default ledger, at the repo root; the JAX package's
#: ``LEDGER.jsonl`` beside it is never written by the port
LEDGER_BASENAME = "LEDGER_TORCH.jsonl"

_SOURCES = (
    "bench",
    "bench_serve",
    "multichip",
    "campaign",
    "kernel_accept",
    "flight",
)
_CLASSES = ("counter", "timing")
_QUALITIES = ("complete", "degraded")

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def default_ledger_path() -> str:
    """Where the port's emitters append: ``TDX_LEDGER_PATH`` when set, else
    ``<repo>/LEDGER_TORCH.jsonl`` (never the JAX package's ``LEDGER.jsonl``)."""
    return os.environ.get(
        "TDX_LEDGER_PATH", os.path.join(_REPO_ROOT, LEDGER_BASENAME)
    )


_SHA_CACHE: dict = {}


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """The current commit's short sha, or None when git is unavailable
    (installed-wheel runs, CI tarballs).  ``TDX_GIT_SHA`` overrides —
    the driver can stamp records from outside the checkout.  The
    subprocess result is cached per cwd: the sha cannot change mid-run,
    and emitters stamp every row of a sweep."""
    env_sha = os.environ.get("TDX_GIT_SHA")
    if env_sha:
        return env_sha
    key = cwd or _REPO_ROOT
    if key in _SHA_CACHE:
        return _SHA_CACHE[key]
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            capture_output=True,
            text=True,
            timeout=10,
            cwd=key,
        )
        sha = (out.stdout or "").strip()
        sha = sha if out.returncode == 0 and sha else None
    except (OSError, subprocess.TimeoutExpired):
        sha = None
    _SHA_CACHE[key] = sha
    return sha


def record_stamp() -> dict:
    """The attribution header every bench emitter now merges into its
    record: schema version + producing commit."""
    return {"record_schema": RECORD_SCHEMA, "git_sha": git_sha()}


def fingerprint(workload: dict) -> str:
    """Canonical workload fingerprint: sorted ``k=v`` fields joined with
    ``|``.  Same workload dict ⇒ same string, independent of insertion
    order — the join key for cross-run comparison."""
    parts = []
    for k in sorted(workload or {}):
        v = workload[k]
        if isinstance(v, float) and v == int(v):
            v = int(v)  # 4.0 and 4 must fingerprint identically
        parts.append(f"{k}={v}")
    return "|".join(parts)


def make_row(
    *,
    run_id: str,
    source: str,
    metric: str,
    value,
    metric_class: str,
    quality: str,
    workload: Optional[dict] = None,
    platform: Optional[str] = None,
    git_sha: Optional[str] = None,
    ts: Optional[float] = None,
    unit: Optional[str] = None,
    artifact: Optional[str] = None,
) -> dict:
    row = {
        "schema": LEDGER_SCHEMA,
        "run_id": run_id,
        "source": source,
        "ts": ts,
        "git_sha": git_sha,
        "platform": platform,
        "workload": dict(workload or {}),
        "fingerprint": fingerprint(workload or {}),
        "metric": metric,
        "value": value,
        "unit": unit,
        "metric_class": metric_class,
        "quality": quality,
    }
    if artifact:
        row["artifact"] = artifact
    return row


def validate_ledger_row(row) -> List[str]:
    """Schema errors for one row (empty list == valid)."""
    errs: List[str] = []
    if not isinstance(row, dict):
        return [f"row is not an object: {row!r:.80}"]
    if row.get("schema") != LEDGER_SCHEMA:
        errs.append(f"bad schema {row.get('schema')!r}")
    for key in ("run_id", "metric"):
        if not row.get(key) or not isinstance(row.get(key), str):
            errs.append(f"missing/non-string {key}")
    if row.get("source") not in _SOURCES:
        errs.append(f"unknown source {row.get('source')!r}")
    if row.get("metric_class") not in _CLASSES:
        errs.append(f"unknown metric_class {row.get('metric_class')!r}")
    if row.get("quality") not in _QUALITIES:
        errs.append(f"unknown quality {row.get('quality')!r}")
    v = row.get("value")
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        errs.append(f"non-numeric value {v!r}")
    elif isinstance(v, float) and not math.isfinite(v):
        errs.append(f"non-finite value {v!r}")
    if not isinstance(row.get("workload"), dict):
        errs.append("workload is not an object")
    elif row.get("fingerprint") != fingerprint(row["workload"]):
        errs.append(
            f"fingerprint {row.get('fingerprint')!r} does not match workload"
        )
    return [f"{row.get('run_id')}/{row.get('metric')}: {e}" for e in errs]


def append_rows(path: str, rows: Iterable[dict]) -> int:
    """Append validated rows to the JSONL ledger (append-only — history
    is never rewritten).  Raises ``ValueError`` on an invalid row rather
    than corrupting the file."""
    rows = list(rows)
    errs = [e for r in rows for e in validate_ledger_row(r)]
    if errs:
        raise ValueError("invalid ledger row(s): " + "; ".join(errs[:5]))
    if not rows:
        return 0
    with open(path, "a") as f:
        for r in rows:
            f.write(json.dumps(r, sort_keys=True) + "\n")
    return len(rows)


def read_ledger(path: str) -> List[dict]:
    """Parse the JSONL ledger; unreadable/invalid lines are SKIPPED (a
    half-written tail from a killed run must not poison the history —
    use :func:`validate_ledger_file` for the strict CI check)."""
    rows: List[dict] = []
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return rows
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        try:
            row = json.loads(ln)
        except ValueError:
            continue
        if not validate_ledger_row(row):
            rows.append(row)
    return rows


def validate_ledger_file(path: str) -> List[str]:
    """Strict schema validation for CI (``check_obs_artifacts.py
    --ledger``): every line must parse and every row must validate."""
    errs: List[str] = []
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as e:
        return [f"{path}: unreadable: {e}"]
    n_valid = 0
    for i, ln in enumerate(lines):
        ln = ln.strip()
        if not ln:
            continue
        try:
            row = json.loads(ln)
        except ValueError as e:
            errs.append(f"{path}:{i + 1}: not JSON: {e}")
            continue
        row_errs = [f"{path}:{i + 1}: {e}" for e in validate_ledger_row(row)]
        errs.extend(row_errs)
        if not row_errs:
            n_valid += 1
    if n_valid == 0:
        # a truncated-to-whitespace ledger must not pass as "OK"
        errs.append(f"{path}: no valid ledger rows")
    return errs


# --------------------------------------------------------------------------
# ingest adapters — one per artifact family, each returning ledger rows
# --------------------------------------------------------------------------

#: timing metrics lifted from each serve phase's embedded histograms
_SERVE_HIST_TIMINGS = ("ttft_s", "e2e_latency_s", "decode_token_s", "tpot_s")
#: serve-phase fields that define the workload fingerprint.  ``mesh``
#: (the TP degree, 1 for single-chip) keeps TP-serve counter rows from
#: colliding with single-chip pins; ``chunked_prefill`` likewise splits
#: the chunked-prefill A/B phases, whose dispatch counters differ;
#: ``mesh_to`` (the migrate phase's target TP degree) keeps each
#: source->target shape pair's migration wire-byte pins distinct;
#: ``fleet``/``disaggregate`` fingerprint the fleet phases' replica
#: count and prefill/decode split the same way;
#: ``scenario``/``autoscale`` split the open-loop autoscale phases per
#: traffic scenario and per policy, so an autoscale-on run's scale-event
#: pins can never collide with autoscale-off rows of the same scenario;
#: ``plan`` names the declarative sharding plan (parallel/plan.py) a
#: phase served under, keeping plan-driven rows distinct from the
#: default TP wiring (None-filtered, so pre-plan fingerprints are
#: byte-stable).
_SERVE_WORKLOAD_KEYS = (
    "model",
    "requests",
    "max_new_tokens",
    "num_slots",
    "decode_chunk",
    "decode_mode",
    "ring_capacity",
    "page_size",
    "max_len",
    "mesh",
    "mesh_to",
    "chunked_prefill",
    "speculate",
    "kv_dtype",
    "fleet",
    "disaggregate",
    "scenario",
    "autoscale",
    "plan",
    # the numerics A/B phase's on-leg (obs/numerics.py): True only in
    # that phase's record, so digest-era rows can never collide with
    # default-run pins (None-filtered like ``plan``)
    "numerics",
)


def _meta(record: dict, kw: dict) -> dict:
    """Shared provenance resolution: explicit kwargs beat the record's
    own stamp beats nothing."""
    return {
        "run_id": kw.get("run_id") or "unnamed-run",
        "git_sha": kw.get("git_sha") or record.get("git_sha"),
        "ts": kw.get("ts"),
        "artifact": kw.get("artifact"),
    }


def ingest_serve_record(record: dict, **kw) -> List[dict]:
    """``scripts/bench_serve.py`` records (``BENCH_SERVE_<CPU|TPU>.json``
    or any emitted line): one row per deterministic engine counter per
    phase, plus the headline timings.  Run quality is ``degraded`` when
    ANY phase errored or the plan was cut short — partial sweeps are
    recorded but can never become the baseline."""
    meta = _meta(record, kw)
    phases = record.get("phases") or {}
    degraded = (not phases) or any(
        not isinstance(p, dict) or "error" in p for p in phases.values()
    )
    quality = "degraded" if degraded else "complete"
    rows: List[dict] = []
    for phase_name, phase in phases.items():
        if not isinstance(phase, dict):
            continue
        platform = phase.get("platform")
        workload = {"phase": phase_name}
        workload.update(
            {
                k: phase[k]
                for k in _SERVE_WORKLOAD_KEYS
                if phase.get(k) is not None
            }
        )

        def row(metric, value, cls, unit=None):
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                return
            if isinstance(value, float) and not math.isfinite(value):
                return
            rows.append(
                make_row(
                    source="bench_serve",
                    metric=metric,
                    value=value,
                    metric_class=cls,
                    quality=quality,
                    workload=workload,
                    platform=platform,
                    unit=unit,
                    **meta,
                )
            )

        m = phase.get("metrics") or {}
        for name, v in (m.get("counters") or {}).items():
            row(name, v, "counter")
        # the autoscale A/B's own block (kept OUT of ``metrics`` so the
        # exposition-projection gate stays exact): controller decision
        # counters, the scenario's workload shape, and both sides'
        # tick-space attainment/cost axes — all integers, exact pins
        am = phase.get("autoscale_metrics") or {}
        for name, v in (am.get("counters") or {}).items():
            row(name, v, "counter")
        # numerics observatory (obs/numerics.py): the embedded digest
        # book's exact integer fields — nonfinite / zeros / count /
        # hist_hash per tap site.  Reduction-order-invariant element
        # counts, so they gate bit-identically like dispatch counters;
        # the site joins the workload (its own fingerprint family)
        nb = phase.get("numerics_book") or {}
        for site, d in sorted((nb.get("sites") or {}).items()):
            site_workload = dict(workload, numerics_site=site)
            for field in ("nonfinite", "zeros", "count", "hist_hash"):
                v = d.get(field)
                if not isinstance(v, int) or isinstance(v, bool):
                    continue
                rows.append(
                    make_row(
                        source="bench_serve",
                        metric=f"numerics_{field}",
                        value=v,
                        metric_class="counter",
                        quality=quality,
                        workload=site_workload,
                        platform=platform,
                        **meta,
                    )
                )
        derived = m.get("derived") or {}
        # counter-derived exact ratios (host_syncs / tokens etc.): same
        # counters ⇒ same double, so they gate exactly too
        row("syncs_per_token", derived.get("syncs_per_token"), "counter")
        row("prefix_hit_rate", derived.get("prefix_hit_rate"), "counter")
        row("accept_rate", derived.get("accept_rate"), "counter")
        row(
            "accepted_tokens_per_iteration",
            derived.get("accepted_tokens_per_iteration"),
            "counter",
        )
        row(
            "decode_tokens_per_sec",
            derived.get("decode_tokens_per_sec"),
            "timing",
            unit="tok/s",
        )
        row(
            "wall_tokens_per_sec",
            derived.get("wall_tokens_per_sec"),
            "timing",
            unit="tok/s",
        )
        row("drain_wall_s", phase.get("drain_wall_s"), "timing", unit="s")
        hists = m.get("histograms") or {}
        for hname in _SERVE_HIST_TIMINGS:
            h = hists.get(hname) or {}
            row(f"{hname}_p50", h.get("p50"), "timing", unit="s")
            row(f"{hname}_p95", h.get("p95"), "timing", unit="s")
        # compile accounting: the measured window's count is a
        # deterministic claim (expected zero); warm-up compiles are
        # jax-version-dependent, recorded for trend but not for the
        # default expectations (see gate.DEFAULT_COUNTER_EXCLUDE)
        for scope_key, metric in (
            ("recompile_measure", "recompile_measure_compiles"),
            ("recompile_warmup", "recompile_warmup_compiles"),
        ):
            snap = phase.get(scope_key) or {}
            if snap.get("available"):
                row(metric, snap.get("compiles_total"), "counter")
        row("compiled_programs", phase.get("compiled_programs"), "counter")
        # the prefix-share phase's headline counters live at top level
        for k in (
            "tokens_prefilled_cold",
            "tokens_prefilled_warm",
            "prefill_calls_cold",
            "prefill_calls_warm",
        ):
            row(k, phase.get(k), "counter")
        # SLO observatory (obs.slo): the deterministic half of the
        # tdx-slo-v1 block gates exactly — attainment COUNTS are integer
        # counts of deterministic predicates (truncation/deadline splits
        # on a deterministic workload), and overall attainment is their
        # exact ratio, like prefix_hit_rate.  Measured percentiles,
        # goodput rates, and burn rates are wall-clock and stay out.
        slo = phase.get("slo") or {}
        for rep_key, rep in (
            [("", slo)]
            if "counters" in slo
            else [(f"{k}_", v) for k, v in sorted(slo.items())
                  if isinstance(v, dict) and "counters" in v]
        ):
            for name, v in (rep.get("counters") or {}).items():
                row(f"slo_{rep_key}{name}", v, "counter")
            att = (rep.get("attainment") or {}).get("overall")
            row(f"slo_{rep_key}attainment", att, "counter")
        # cost observatory (obs.cost): one counter row per deterministic
        # card field per program — XLA flop/byte counts are exact on a
        # fixed platform, so the gate pins them like host_syncs.  The
        # card's own counter_fields() already excluded anything
        # load-dependent (watermark-sourced peaks).
        rows.extend(
            _cost_card_rows(
                phase.get("cost_cards"), workload, platform, quality,
                meta, source="bench_serve",
            )
        )
    return rows


def _cost_card_rows(
    cards, workload: dict, platform, quality: str, meta: dict, *, source: str
) -> List[dict]:
    """Ledger rows for one record's embedded ``cost_cards`` object
    (``{program: CostCard.to_json()}``): each deterministic ``cost_*``
    field becomes a counter row whose workload gains the program name
    (a distinct fingerprint per program, so pins never collide across
    programs of one phase)."""
    rows: List[dict] = []
    if not isinstance(cards, dict):
        return rows
    for program, card in sorted(cards.items()):
        if not isinstance(card, dict):
            continue
        cw = dict(workload, program=program)
        fields = {
            f"cost_{k}": card.get(k)
            for k in (
                "flops",
                "bytes_accessed",
                "transcendentals",
                "arg_bytes",
                "out_bytes",
                "temp_bytes",
            )
        }
        if card.get("peak_source") in ("xla_peak", "arg+out+temp"):
            fields["cost_peak_bytes"] = card.get("peak_bytes")
        for metric, v in fields.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            if isinstance(v, float) and not math.isfinite(v):
                continue
            rows.append(
                make_row(
                    source=source,
                    metric=metric,
                    value=v,
                    metric_class="counter",
                    quality=quality,
                    workload=cw,
                    platform=platform,
                    unit="bytes" if metric.endswith("_bytes") else None,
                    **meta,
                )
            )
    return rows


_BENCH_TIMINGS = (
    # (record path is handled in the adapter; these are extra.* keys)
    ("deferred_init_s", "s"),
    ("materialize_s", "s"),
    ("peak_host_rss_gb", "gb"),
    ("train_window_s", "s"),
)


def _platform_of_device(device) -> Optional[str]:
    s = str(device or "")
    if not s:
        return None
    return "cpu" if "CPU" in s.upper() else "tpu"


def ingest_bench_record(record: dict, **kw) -> List[dict]:
    """``bench.py`` final records (the ``deferred_init_materialize...``
    line).  Quality: ``complete`` only when the record says so
    (``extra.progress`` == complete, or pre-progress-field records whose
    headline value landed); anything wedged/partial/skipped is
    ``degraded``."""
    meta = _meta(record, kw)
    extra = record.get("extra") or {}
    progress = extra.get("progress")
    complete = (
        progress == "complete"
        if progress is not None
        else record.get("value") is not None
    )
    quality = "complete" if complete else "degraded"
    platform = _platform_of_device(extra.get("device"))
    rows: List[dict] = []

    def row(metric, value, cls, workload, unit=None):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        if isinstance(value, float) and not math.isfinite(value):
            return
        rows.append(
            make_row(
                source="bench",
                metric=metric,
                value=value,
                metric_class=cls,
                quality=quality,
                workload=workload,
                platform=platform,
                unit=unit,
                **meta,
            )
        )

    mat = {"phase": "materialize_7b", "replay_mode": "eager"}
    row("materialize_total_s", record.get("value"), "timing", mat, unit="s")
    row("vs_baseline", record.get("vs_baseline"), "timing", mat)
    for k, unit in _BENCH_TIMINGS[:3]:
        row(k, extra.get(k), "timing", mat, unit=unit)
    row("params", extra.get("params"), "counter", mat)
    chunked = extra.get("materialize_chunked") or {}
    if isinstance(chunked, dict):
        cw = {"phase": "materialize_7b", "replay_mode": "chunked"}
        row("materialize_total_s", chunked.get("total_s"), "timing", cw,
            unit="s")
        row("materialize_s", chunked.get("materialize_s"), "timing", cw,
            unit="s")

    train = {
        "phase": "train",
        "model": extra.get("train_model"),
        "batch": extra.get("train_batch"),
        "seq": extra.get("train_seq"),
        "remat": extra.get("remat"),
        "optimizer": extra.get("optimizer"),
        "fused_ce": extra.get("fused_ce"),
    }
    # plan=/zero2= keys join the fingerprint only when the run actually
    # used them, so pre-plan records' fingerprints stay byte-stable
    if extra.get("zero2"):
        train["zero2"] = True
    if extra.get("plan") is not None:
        train["plan"] = extra["plan"]
    train = {k: v for k, v in train.items() if v is not None}
    row("tokens_per_sec", record.get("tokens_per_sec"), "timing", train,
        unit="tok/s")
    row("mfu", record.get("mfu"), "timing", train)
    row("goodput", record.get("goodput"), "timing", train)
    row("train_window_s", extra.get("train_window_s"), "timing", train,
        unit="s")
    rec = extra.get("train_recompile") or {}
    if rec.get("available"):
        by_scope = rec.get("by_scope") or {}
        window = (by_scope.get("timed_window") or {}).get("compiles")
        row("train_window_compiles", window, "counter", train)
    # cost observatory: the train step program's card (exact compiler
    # counts) + the per-span roofline/MFU attribution numbers
    card = extra.get("train_cost_card")
    if isinstance(card, dict):
        rows.extend(
            _cost_card_rows(
                {"train/step": card}, train, platform, quality, meta,
                source="bench",
            )
        )
        row(
            "train_flop_attribution",
            card.get("flop_attribution"),
            "counter",
            train,
        )
    row("mfu_xla", extra.get("mfu_xla"), "timing", train)
    # ZeRO-2 train A/B leg (extra.train_zero2): the update-sharding
    # arm's deterministic byte counters pin EXACTLY (a silently
    # un-sharded optimizer state regresses like a correctness bug);
    # workload keys zero2=/plan= keep its rows from ever colliding with
    # the replicated arm's
    tz = extra.get("train_zero2") or {}
    if isinstance(tz, dict) and tz.get("zero2"):
        zw = {
            "phase": "train",
            "model": tz.get("train_model") or extra.get("train_model"),
            "zero2": True,
            "plan": tz.get("plan"),
        }
        zw = {k: v for k, v in zw.items() if v is not None}
        row("tokens_per_sec", tz.get("tokens_per_sec"), "timing", zw,
            unit="tok/s")
        row("mfu", tz.get("mfu"), "timing", zw)
        for k in ("optimizer_bytes", "optimizer_bytes_per_device",
                  "zero2_participating_bytes", "zero2_step_wire_bytes"):
            row(k, tz.get(k), "counter", zw, unit="B")
    # always at least one row, so even an all-null wedged-relay record
    # leaves a (degraded) mark in the trajectory
    row("bench_complete", int(complete), "counter", {"phase": "driver"})
    return rows


def ingest_bench_wrapper(record: dict, **kw) -> List[dict]:
    """The driver's ``BENCH_r0N.json`` wrappers: ``{"n", "cmd", "rc",
    "tail", "parsed"}``.  The inner bench record (``parsed``, or the last
    JSON line of ``tail``) is ingested when present; the wrapper itself
    always yields a ``bench_rc`` row so even an rc=124 empty-tail round
    (r03) lands in the trajectory."""
    meta = _meta(record, kw)
    rc = record.get("rc")
    inner = record.get("parsed")
    if not isinstance(inner, dict):
        inner = None
        for ln in reversed((record.get("tail") or "").splitlines()):
            ln = ln.strip()
            if ln.startswith("{"):
                try:
                    inner = json.loads(ln)
                except ValueError:
                    continue
                break
    rows: List[dict] = []
    if isinstance(inner, dict):
        inner_kw = dict(kw)
        if rc not in (0, None):
            # a nonzero driver rc overrules whatever the inner record
            # claims about itself
            inner = dict(inner)
            inner.setdefault("extra", {})
            if isinstance(inner["extra"], dict):
                inner["extra"] = dict(inner["extra"], progress="driver-failed")
        rows.extend(ingest_bench_record(inner, **inner_kw))
    if isinstance(rc, int):
        rows.append(
            make_row(
                source="bench",
                metric="bench_rc",
                value=rc,
                metric_class="counter",
                quality=(
                    "complete"
                    if rc == 0
                    and rows
                    and all(r["quality"] == "complete" for r in rows)
                    else "degraded"
                ),
                workload={"phase": "driver"},
                platform=None,
                **meta,
            )
        )
    return rows


def ingest_multichip_record(record: dict, **kw) -> List[dict]:
    """``MULTICHIP_r0N.json``: rc/ok plus the leg count parsed from the
    harvested stdout tail — the number of asserting dryrun legs that ran
    is a deterministic counter (9 since PR 5)."""
    meta = _meta(record, kw)
    rc, ok = record.get("rc"), record.get("ok")
    quality = (
        "complete" if rc == 0 and ok and not record.get("skipped")
        else "degraded"
    )
    workload = {"n_devices": record.get("n_devices")}
    workload = {k: v for k, v in workload.items() if v is not None}
    legs = sum(
        1
        for ln in (record.get("tail") or "").splitlines()
        if ln.startswith("dryrun_multichip(")
    )
    rows: List[dict] = []
    for metric, value in (
        ("dryrun_rc", rc if isinstance(rc, int) else None),
        ("dryrun_ok", int(bool(ok)) if ok is not None else None),
        ("dryrun_legs", legs),
    ):
        if value is None:
            continue
        rows.append(
            make_row(
                source="multichip",
                metric=metric,
                value=value,
                metric_class="counter",
                quality=quality,
                workload=workload,
                platform="cpu",  # the dryrun runs on the 8-device CPU mesh
                **meta,
            )
        )
    # PR 5+ rounds harvest MULTICHIP_LEG {json} lines: per-leg comm
    # traffic is analytically pinned, so ops/bytes are exact counters
    for ln in (record.get("tail") or "").splitlines():
        if not ln.startswith("MULTICHIP_LEG "):
            continue
        try:
            leg = json.loads(ln[len("MULTICHIP_LEG "):])
        except ValueError:
            continue
        leg_name = leg.get("leg")
        if not leg_name:
            continue
        lw = dict(workload, leg=leg_name)
        by_axis = leg.get("comm_bytes_by_axis")
        if isinstance(by_axis, dict) and "comm_bytes" not in leg:
            leg = dict(
                leg,
                comm_bytes=sum(
                    v for v in by_axis.values() if isinstance(v, (int, float))
                ),
            )
        for metric, cls in (
            ("comm_ops", "counter"),
            ("comm_bytes", "counter"),
            ("compiles", "counter"),
            ("seconds", "timing"),
        ):
            v = leg.get(metric)
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            rows.append(
                make_row(
                    source="multichip",
                    metric=f"leg_{metric}",
                    value=v,
                    metric_class=cls,
                    quality=quality,
                    workload=lw,
                    platform="cpu",
                    unit="s" if metric == "seconds" else None,
                    **meta,
                )
            )
    return rows


def ingest_kernel_accept_record(record: dict, **kw) -> List[dict]:
    """``KERNEL_ACCEPT[_SMOKE].json``: the sweep's case counters plus
    per-case compile+run timings."""
    meta = _meta(record, kw)
    quality = (
        "complete" if record.get("progress") == "complete" else "degraded"
    )
    platform = (record.get("preflight") or {}).get("platform") or (
        "cpu" if "smoke" in str(record.get("mode", "")) else "tpu"
    )
    workload = {"mode": record.get("mode") or "compiled"}
    rows: List[dict] = []
    for metric in ("cases_total_defined", "cases_run", "cases_ok"):
        v = record.get(metric)
        if isinstance(v, int):
            rows.append(
                make_row(
                    source="kernel_accept",
                    metric=metric,
                    value=v,
                    metric_class="counter",
                    quality=quality,
                    workload=workload,
                    platform=platform,
                    **meta,
                )
            )
    for case in record.get("cases") or []:
        if not isinstance(case, dict) or not case.get("case"):
            continue
        cw = dict(workload, case=case["case"])
        for key in ("fwd_compile_run_s", "bwd_compile_run_s"):
            v = case.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                rows.append(
                    make_row(
                        source="kernel_accept",
                        metric=key,
                        value=v,
                        metric_class="timing",
                        quality=quality,
                        workload=cw,
                        platform=platform,
                        unit="s",
                        **meta,
                    )
                )
    return rows


def ingest_flight_dump(path: str, **kw) -> List[dict]:
    """Flight-recorder JSONL dumps (``tdx-flight-v1``): the black box's
    aggregate counters — record count, ring drops, failures, rollbacks."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    records = []
    for ln in lines:
        try:
            records.append(json.loads(ln))
        except ValueError:
            pass
    header = next(
        (r for r in records if r.get("kind") == "flight_header"), {}
    )
    meta = _meta(header, kw)
    counts = {
        "flight_records": len(records),
        "flight_dropped": header.get("dropped") or 0,
        "flight_failures": sum(
            1 for r in records if r.get("kind") == "failure"
        ),
        "flight_rollbacks": sum(
            1 for r in records if r.get("kind") == "rollback"
        ),
    }
    workload = {"reason": header.get("reason")} if header.get("reason") else {}
    return [
        make_row(
            source="flight",
            metric=metric,
            value=value,
            metric_class="counter",
            quality="complete" if header else "degraded",
            workload=workload,
            platform=kw.get("platform"),
            **meta,
        )
        for metric, value in counts.items()
        if isinstance(value, int)
    ]


def ingest_campaign_record(
    record: dict, step_records: str = "all", **kw
) -> List[dict]:
    """``CAMPAIGN.json``: per-step rc/wall rows, plus each step's
    harvested tail records delegated to the family adapters (bench_serve
    records to the serve adapter, bench records to the bench adapter;
    ad-hoc per-script rows — bench_generate, bench_t5_train,
    bench_flash_attention, bench_fused_ce — have no ledger family and
    surface only as their step's rc/wall rows).

    ``step_records`` controls the delegation: ``"all"`` (backfill — the
    committed campaign file is the only channel) or ``"failed"`` (the
    live campaign's own ledger append: gracefully-exited sub-benches
    already appended their rows in-process, so only killed/timed-out
    steps — whose harvest tail is the sole surviving evidence — are
    delegated, keeping the ledger duplicate-free)."""
    meta = _meta(record, kw)
    status = record.get("status")
    rows: List[dict] = []
    for step, res in (record.get("steps") or {}).items():
        if not isinstance(res, dict):
            continue
        workload = {"step": step}
        degraded = (
            "skipped" in res
            or res.get("rc") not in (0,)
            or status in ("wedged", "started", "running")
        )
        quality = "degraded" if degraded else "complete"
        if isinstance(res.get("rc"), int):
            rows.append(
                make_row(
                    source="campaign",
                    metric="step_rc",
                    value=res["rc"],
                    metric_class="counter",
                    quality=quality,
                    workload=workload,
                    **meta,
                )
            )
        if isinstance(res.get("wall_s"), (int, float)):
            rows.append(
                make_row(
                    source="campaign",
                    metric="step_wall_s",
                    value=res["wall_s"],
                    metric_class="timing",
                    quality=quality,
                    workload=workload,
                    unit="s",
                    **meta,
                )
            )
        recs = [r for r in res.get("records") or [] if isinstance(r, dict)]
        if recs and (step_records == "all" or res.get("rc") != 0):
            last = recs[-1]  # the emit-after-every-phase contract: last wins
            sub_kw = dict(kw, run_id=f"{meta['run_id']}/{step}")
            sub_kw.setdefault("git_sha", meta.get("git_sha"))
            sub_kw.setdefault("ts", meta.get("ts"))
            if last.get("bench") == "serve":
                sub = ingest_serve_record(last, **sub_kw)
            elif "metric" in last and "extra" in last:
                sub = ingest_bench_record(last, **sub_kw)
            else:
                sub = []
            if res.get("rc") != 0:
                # a killed/timed-out step's record can look clean up to
                # the kill point — the step verdict overrules it
                for r in sub:
                    r["quality"] = "degraded"
            rows.extend(sub)
    return rows


def _artifact_git_meta(path: str) -> dict:
    """Commit attribution for a COMMITTED artifact: the sha and author
    time of the commit that last touched it — what lets the backfilled
    trajectory be ordered and attributed even though the old records
    carried no stamp.  A working-tree-modified (or untracked) artifact
    is a FRESH run, not the committed one: it gets its file mtime as
    ``ts`` and no commit sha (the record's own stamp, if any, supplies
    it), so a just-rewritten ``BENCH_SERVE_CPU.json`` is a different
    run identity than the backfilled rows of the committed version —
    the distinction the gate's never-your-own-baseline rule keys on."""
    cwd = os.path.dirname(os.path.abspath(path)) or "."
    try:
        dirty = subprocess.run(
            ["git", "status", "--porcelain", "--", path],
            capture_output=True, text=True, timeout=10, cwd=cwd,
        )
        clean = dirty.returncode == 0 and not (dirty.stdout or "").strip()
        if clean:
            out = subprocess.run(
                ["git", "log", "-1", "--format=%h %ct", "--", path],
                capture_output=True, text=True, timeout=10, cwd=cwd,
            )
            parts = (out.stdout or "").split()
            if out.returncode == 0 and len(parts) == 2:
                return {"git_sha": parts[0], "ts": float(parts[1])}
    except (OSError, subprocess.TimeoutExpired, ValueError):
        pass
    try:
        return {"git_sha": None, "ts": os.path.getmtime(path)}
    except OSError:
        return {"git_sha": None, "ts": None}


def ingest_artifact(path: str, **kw) -> List[dict]:
    """Dispatch one artifact file to its family adapter by name pattern
    and shape sniff.  ``run_id`` defaults to the basename; ``git_sha``/
    ``ts`` default to the committing commit's (see
    :func:`_artifact_git_meta`).  Unknown families raise ``ValueError``
    — silently ingesting nothing would fake coverage."""
    base = os.path.basename(path)
    name = base[:-len(".json")] if base.endswith(".json") else base
    meta = {"run_id": name, "artifact": base, **_artifact_git_meta(path)}
    meta.update({k: v for k, v in kw.items() if v is not None})
    if base.endswith(".jsonl"):
        return ingest_flight_dump(path, **meta)
    with open(path) as f:
        record = json.load(f)
    # the record's own stamp (post-sentinel emitters) beats the
    # committing commit's sha — it names the commit that PRODUCED the
    # run — but an EXPLICIT caller-passed sha beats both (the _meta
    # precedence contract)
    if (
        isinstance(record, dict)
        and record.get("git_sha")
        and kw.get("git_sha") is None
    ):
        meta["git_sha"] = record["git_sha"]
    if record.get("bench") == "serve":
        return ingest_serve_record(record, **meta)
    if "tail" in record and "n_devices" in record:
        return ingest_multichip_record(record, **meta)
    if "tail" in record and "rc" in record:
        return ingest_bench_wrapper(record, **meta)
    if "steps" in record and "status" in record:
        return ingest_campaign_record(record, **meta)
    if "cases" in record or str(record.get("metric", "")).startswith(
        "flash_kernel"
    ):
        return ingest_kernel_accept_record(record, **meta)
    if "metric" in record and "extra" in record:
        return ingest_bench_record(record, **meta)
    raise ValueError(f"{path}: unrecognized artifact family")


def append_record_rows(
    record: dict,
    *,
    source: str,
    run_id: Optional[str] = None,
    path: Optional[str] = None,
) -> int:
    """The emitter-side hook: normalize a just-emitted record and append
    its rows to the ledger.  NEVER raises (a ledger hiccup must not fail
    a bench) and is disabled by ``TDX_LEDGER=0``.  Returns the number of
    rows appended (0 on any failure)."""
    if os.environ.get("TDX_LEDGER") == "0":
        return 0
    try:
        sha = record.get("git_sha") or git_sha()
        rid = run_id or "{}-{}-{}".format(
            source, sha or "nogit", int(time.time())
        )
        kw = {"run_id": rid, "git_sha": sha, "ts": time.time()}
        if source == "bench_serve":
            rows = ingest_serve_record(record, **kw)
        elif source == "bench":
            rows = ingest_bench_record(record, **kw)
        elif source == "campaign":
            # sub-benches that exited gracefully already appended their
            # own rows; only killed steps' harvested tails are delegated
            rows = ingest_campaign_record(record, step_records="failed", **kw)
        else:
            return 0
        return append_rows(path or default_ledger_path(), rows)
    except Exception:
        return 0
