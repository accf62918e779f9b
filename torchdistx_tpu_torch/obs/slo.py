"""SLO observatory: declarative latency objectives over request histories.

Counterpart of ``torchdistx_tpu/obs/slo.py``, copied: it reads host
request histories only.  The serving stack records per-request
TTFT/TPOT/e2e latencies (``Request.events`` + the ``ServeMetrics``
histograms); this module judges them against a *target*: a declarative :class:`SloSpec` (percentile targets on
TTFT/TPOT/e2e, a per-request deadline budget, an attainment target with
multi-window burn-rate alerting) evaluated over the engines' existing
per-request histories (``ServeEngine.finished_requests()`` /
``ServeFleet.finished_requests()``) into a ``tdx-slo-v1`` report.

Design constraints, in the house style:

- **Deterministic where it gates.**  The report splits cleanly into
  counters (requests total / attained / violated / truncated — exact
  integers, pinnable as exact counters when the
  spec carries no wall-clock budget) and timing-derived figures
  (measured percentiles, goodput rates, burn rates) that never gate
  bit-identically.
- **An SLO burn is a named flight event, like a stall**: a breached
  evaluation records ``slo_burn`` into the distributed flight recorder
  (``obs/flight.py``), so the post-mortem artifact names the objective
  that was missed alongside the stalls and collective logs.
- **One scrape surface**: :func:`slo_collector` projects the live
  evaluation into the Prometheus registry (attainment, goodput,
  per-window burn rate/alert gauges) next to the fleet gauges.

Burn-rate semantics follow the multi-window SRE convention: each window
``w`` looks at requests that *finished* within the last ``w`` seconds,
its burn rate is ``violation_rate / error_budget`` (budget = ``1 -
attainment_target``), and the alert ``state`` escalates from ``ok`` to
``warn`` (some window burning) to ``page`` (every window burning — a
fast burn confirmed by the slow window, not a blip).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "SLO_SCHEMA",
    "SloSpec",
    "evaluate_slo",
    "slo_collector",
    "validate_slo_report",
]

SLO_SCHEMA = "tdx-slo-v1"

# percentile-target axes: spec field -> (request attribute, quantile)
_PERCENTILE_AXES = {
    "ttft_p50_s": ("ttft_s", 0.50),
    "ttft_p95_s": ("ttft_s", 0.95),
    "tpot_p50_s": ("tpot_s", 0.50),
    "tpot_p95_s": ("tpot_s", 0.95),
    "e2e_p50_s": ("e2e_s", 0.50),
    "e2e_p95_s": ("e2e_s", 0.95),
}

_BURN_STATES = ("ok", "warn", "page")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One declarative serving objective.

    ``*_p50_s``/``*_p95_s`` are percentile targets in seconds (None =
    axis not part of the objective); ``deadline_s`` is a per-request e2e
    budget — a request ATTAINS the SLO iff it finished untruncated (its
    own ``deadline_s``/cache limits included) and, when set, within this
    budget.  ``attainment_target`` is the minimum attaining fraction;
    ``windows_s`` (ascending) are the burn-rate lookback windows and
    ``burn_threshold`` the rate above which a window counts as burning.
    """

    name: str = "default"
    ttft_p50_s: Optional[float] = None
    ttft_p95_s: Optional[float] = None
    tpot_p50_s: Optional[float] = None
    tpot_p95_s: Optional[float] = None
    e2e_p50_s: Optional[float] = None
    e2e_p95_s: Optional[float] = None
    deadline_s: Optional[float] = None
    attainment_target: float = 1.0
    windows_s: Tuple[float, ...] = (60.0, 300.0)
    burn_threshold: float = 1.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("an SloSpec needs a non-empty name")
        for field in _PERCENTILE_AXES:
            v = getattr(self, field)
            if v is not None and not v > 0:
                raise ValueError(f"{field} must be > 0, got {v}")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(
                f"deadline_s must be > 0, got {self.deadline_s}"
            )
        if not 0.0 <= self.attainment_target <= 1.0:
            raise ValueError(
                "attainment_target must be in [0, 1], got "
                f"{self.attainment_target}"
            )
        windows = tuple(float(w) for w in self.windows_s)
        if not windows:
            raise ValueError("windows_s must name at least one window")
        if any(w <= 0 for w in windows):
            raise ValueError(f"windows_s must be > 0, got {windows}")
        if list(windows) != sorted(windows) or len(set(windows)) != len(
            windows
        ):
            raise ValueError(
                f"windows_s must be strictly ascending, got {windows}"
            )
        object.__setattr__(self, "windows_s", windows)
        if not self.burn_threshold > 0:
            raise ValueError(
                f"burn_threshold must be > 0, got {self.burn_threshold}"
            )

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["windows_s"] = list(self.windows_s)
        return d

    @classmethod
    def from_json(cls, obj) -> "SloSpec":
        """Build from a dict or a path to a JSON spec file — the
        committed-spec entry point."""
        if isinstance(obj, str):
            with open(obj) as f:
                obj = json.load(f)
        if not isinstance(obj, dict):
            raise TypeError(f"SLO spec must be a dict, got {type(obj)}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(
                f"unknown SLO spec field(s) {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        if "windows_s" in obj:
            obj = {**obj, "windows_s": tuple(obj["windows_s"])}
        return cls(**obj)


def _quantile(xs: Sequence[float], q: float) -> Optional[float]:
    """The same nearest-rank estimator ``serve.metrics.Histogram`` uses,
    so a spec target reads identically against the report and against
    the Prometheus summary quantiles."""
    if not xs:
        return None
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))]


def _request_view(req) -> dict:
    """Normalize one finished ``Request`` into the fields the evaluation
    reads (latencies via ``result()`` — the identical derivations the
    ``ServeMetrics`` aggregates were fed)."""
    res = req.result()
    return {
        "ttft_s": res.ttft_s,
        "tpot_s": res.tpot_s,
        "e2e_s": res.latency_s,
        "tokens": int(len(res.tokens)),
        "truncated": bool(res.truncated),
        "finish_reason": res.finish_reason,
        "submitted_at": req.submitted_at,
        "finished_at": req.finished_at,
    }


def evaluate_slo(
    spec: SloSpec,
    requests,
    *,
    now: Optional[float] = None,
    policy: Optional[str] = None,
    flight: Any = None,
) -> dict:
    """Evaluate ``spec`` over finished requests into a ``tdx-slo-v1``
    report dict (validated by :func:`validate_slo_report`).

    ``requests`` are finished ``serve.scheduler.Request`` objects
    (``engine.finished_requests()`` or ``fleet.finished_requests()``).
    ``now`` anchors the burn windows (default: ``time.monotonic()``).
    ``policy`` labels the report (the A/B axis).  ``flight`` routes the
    breach event: None uses the global ``obs.flight`` recorder, False
    suppresses it (per-scrape collector evaluations), anything else
    must expose ``record(kind, **fields)``.
    """
    if now is None:
        now = time.monotonic()
    views = [_request_view(r) for r in requests]

    total = len(views)
    attained = violated = 0
    trunc_deadline = trunc_cache = 0
    tokens_attained = 0
    for v in views:
        ok = not v["truncated"] and (
            spec.deadline_s is None or v["e2e_s"] <= spec.deadline_s
        )
        if ok:
            attained += 1
            tokens_attained += v["tokens"]
        else:
            violated += 1
        if v["finish_reason"] == "deadline":
            trunc_deadline += 1
        elif v["finish_reason"] == "cache_full":
            trunc_cache += 1
    counters = {
        "requests_total": total,
        "requests_attained": attained,
        "requests_violated": violated,
        "requests_truncated_deadline": trunc_deadline,
        "requests_truncated_cache_full": trunc_cache,
        "tokens_attained": tokens_attained,
    }

    overall = attained / total if total else None
    attainment = {
        "overall": overall,
        "target": spec.attainment_target,
        "ok": None if overall is None else overall >= spec.attainment_target,
    }

    percentiles: Dict[str, dict] = {}
    series = {
        axis: [
            v[axis] for v in views if v[axis] is not None
        ]
        for axis in ("ttft_s", "tpot_s", "e2e_s")
    }
    breached_axes: List[str] = []
    for field, (axis, q) in _PERCENTILE_AXES.items():
        target = getattr(spec, field)
        measured = _quantile(series[axis], q)
        if target is None and measured is None:
            continue
        ok = (
            None
            if target is None or measured is None
            else measured <= target
        )
        percentiles[field] = {
            "target": target,
            "measured": measured,
            "ok": ok,
        }
        if ok is False:
            breached_axes.append(field)

    span_s = None
    goodput: Dict[str, Optional[float]] = {
        "span_s": None,
        "requests_attained_per_s": None,
        "tokens_attained_per_s": None,
    }
    finished_ts = [
        v["finished_at"] for v in views if v["finished_at"] is not None
    ]
    if views and finished_ts:
        t0 = min(v["submitted_at"] for v in views)
        span_s = max(finished_ts) - t0
        goodput["span_s"] = span_s
        if span_s > 0:
            goodput["requests_attained_per_s"] = attained / span_s
            goodput["tokens_attained_per_s"] = tokens_attained / span_s

    budget = 1.0 - spec.attainment_target
    windows = []
    burning_flags = []
    for w in spec.windows_s:
        in_win = [
            v
            for v in views
            if v["finished_at"] is not None
            and now - w <= v["finished_at"] <= now
        ]
        n = len(in_win)
        viol = sum(
            1
            for v in in_win
            if v["truncated"]
            or (
                spec.deadline_s is not None
                and v["e2e_s"] > spec.deadline_s
            )
        )
        rate = viol / n if n else None
        if rate is None:
            burn = None
            burning = False
        elif budget > 0:
            burn = rate / budget
            burning = burn > spec.burn_threshold
        else:
            # 100% target: any violation is an instant burn; the rate
            # itself is unbounded, reported as None
            burn = None
            burning = viol > 0
        windows.append(
            {
                "window_s": w,
                "requests": n,
                "violations": viol,
                "violation_rate": rate,
                "burn_rate": burn,
                "burning": burning,
            }
        )
        burning_flags.append(burning)
    if all(burning_flags) and burning_flags:
        state = "page"
    elif any(burning_flags):
        state = "warn"
    else:
        state = "ok"

    breached = bool(attainment["ok"] is False or breached_axes)
    report = {
        "schema": SLO_SCHEMA,
        "spec": spec.to_json(),
        "policy": policy,
        "counters": counters,
        "attainment": attainment,
        "percentiles": percentiles,
        "goodput": goodput,
        "burn": {
            "threshold": spec.burn_threshold,
            "windows": windows,
            "state": state,
        },
        "breached": breached,
        "breached_axes": breached_axes,
    }

    if (breached or state != "ok") and flight is not False:
        if flight is None:
            from .flight import get_flight_recorder

            flight = get_flight_recorder()
        flight.record(
            "slo_burn",
            slo=spec.name,
            policy=policy,
            state=state,
            attainment=overall,
            target=spec.attainment_target,
            breached_axes=list(breached_axes),
            requests_violated=violated,
            requests_total=total,
        )
    return report


def slo_collector(
    spec: SloSpec,
    source,
    prefix: str = "tdx_slo",
    policy: Optional[str] = None,
):
    """An ``obs.metrics`` collector projecting the live SLO evaluation
    into the Prometheus registry — register with
    ``registry.register_collector(slo_collector(spec, fleet),
    obj=fleet)``.  ``source`` is anything with ``finished_requests()``
    (engine or fleet), held by weakref like every other collector.
    Scrape-time evaluations never re-record flight events (the breach
    event belongs to the explicit evaluation that found it, not to
    every scrape that still sees it)."""
    import weakref

    from .metrics import MetricFamily

    ref = weakref.ref(source)

    def collect():
        src = ref()
        if src is None:
            return []
        rep = evaluate_slo(
            spec, src.finished_requests(), policy=policy, flight=False
        )
        slo = spec.name
        fams = []
        for cname, v in rep["counters"].items():
            fams.append(
                MetricFamily(f"{prefix}_{cname}", "counter").add(
                    v, slo=slo
                )
            )
        fams.append(
            MetricFamily(f"{prefix}_attainment", "gauge").add(
                rep["attainment"]["overall"], slo=slo
            )
        )
        fams.append(
            MetricFamily(f"{prefix}_attainment_target", "gauge").add(
                rep["attainment"]["target"], slo=slo
            )
        )
        fams.append(
            MetricFamily(f"{prefix}_breached", "gauge").add(
                int(bool(rep["breached"])), slo=slo
            )
        )
        for gname in ("requests_attained_per_s", "tokens_attained_per_s"):
            fams.append(
                MetricFamily(f"{prefix}_goodput_{gname}", "gauge").add(
                    rep["goodput"][gname], slo=slo
                )
            )
        burn_fam = MetricFamily(f"{prefix}_burn_rate", "gauge")
        burning_fam = MetricFamily(f"{prefix}_burning", "gauge")
        for w in rep["burn"]["windows"]:
            label = str(w["window_s"])
            burn_fam.add(w["burn_rate"], slo=slo, window=label)
            burning_fam.add(int(w["burning"]), slo=slo, window=label)
        fams.extend([burn_fam, burning_fam])
        fams.append(
            MetricFamily(f"{prefix}_burn_state", "gauge").add(
                _BURN_STATES.index(rep["burn"]["state"]), slo=slo
            )
        )
        return fams

    return collect


def validate_slo_report(report) -> List[str]:
    """Schema-validate one ``tdx-slo-v1`` report; returns error strings
    (empty = valid).  The library half of ``check_obs_artifacts.py
    --slo``: spec echoed, attainment in [0, 1], counters consistent,
    burn windows present, ordered, and matching the echoed spec."""
    errors: List[str] = []
    if not isinstance(report, dict):
        return [f"slo report must be a dict, got {type(report)}"]
    if report.get("schema") != SLO_SCHEMA:
        errors.append(
            f"schema must be {SLO_SCHEMA!r}, got {report.get('schema')!r}"
        )
    spec = report.get("spec")
    if not isinstance(spec, dict) or not spec.get("name"):
        errors.append("spec must be echoed as a dict with a name")
        spec = {}
    if spec:
        try:
            SloSpec.from_json(dict(spec))
        except (ValueError, TypeError) as e:
            errors.append(f"echoed spec does not parse: {e}")
    att = report.get("attainment")
    if not isinstance(att, dict):
        errors.append("attainment block missing")
        att = {}
    for key in ("overall", "target"):
        v = att.get(key) if key in att else None
        if key == "target" and v is None:
            errors.append("attainment.target missing")
        if v is not None and not (
            isinstance(v, (int, float)) and 0.0 <= v <= 1.0
        ):
            errors.append(f"attainment.{key} must be in [0, 1], got {v!r}")
    c = report.get("counters")
    if not isinstance(c, dict):
        errors.append("counters block missing")
    else:
        for name in (
            "requests_total",
            "requests_attained",
            "requests_violated",
        ):
            v = c.get(name)
            if not isinstance(v, int) or v < 0:
                errors.append(f"counters.{name} must be an int >= 0")
        if (
            isinstance(c.get("requests_total"), int)
            and isinstance(c.get("requests_attained"), int)
            and isinstance(c.get("requests_violated"), int)
            and c["requests_attained"] + c["requests_violated"]
            != c["requests_total"]
        ):
            errors.append(
                "counters must satisfy attained + violated == total"
            )
    burn = report.get("burn")
    if not isinstance(burn, dict) or not isinstance(
        burn.get("windows"), list
    ):
        errors.append("burn.windows must be a list")
    else:
        ws = [w.get("window_s") for w in burn["windows"]]
        if any(not isinstance(w, (int, float)) or w <= 0 for w in ws):
            errors.append(f"burn window sizes must be > 0, got {ws}")
        elif ws != sorted(ws) or len(set(ws)) != len(ws):
            errors.append(
                f"burn windows must be strictly ascending, got {ws}"
            )
        if spec.get("windows_s") and ws != list(spec["windows_s"]):
            errors.append(
                f"burn windows {ws} do not match the echoed spec's "
                f"{spec['windows_s']}"
            )
        if burn.get("state") not in _BURN_STATES:
            errors.append(
                f"burn.state must be one of {_BURN_STATES}, got "
                f"{burn.get('state')!r}"
            )
    if not isinstance(report.get("breached"), bool):
        errors.append("breached must be a bool")
    return errors
