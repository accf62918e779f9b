"""Tracing and telemetry of the port, counterpart of ``torchdistx_tpu/obs``.

The layers the serving engine and the fleet need, each touching no JAX:

- :mod:`.trace` — host span tracer with Chrome-trace (Perfetto) export,
  per-request and cross-replica request tracks.
- :mod:`.metrics` — metrics registry with Prometheus text exposition.
- :mod:`.recompile` — counts the programs the engine sets up (first
  dispatches of a new shape, CUDA-graph captures), per scope.
- :mod:`.memory` — the allocator watermark, the card's budget, the live
  capacity plan the engine admits against, and the sharding audit.
- :mod:`.comm` — the collective-traffic audit (``tdx-comm-v1``): op counts
  and analytic bytes per mesh axis from every collective choke point.
- :mod:`.cost` — per-program cost cards from the CUDA caching allocator,
  and counted cards (FLOPs of the aten products and the kernels' formulas).
- :mod:`.flight` / :mod:`.watchdog` — the bounded flight recorder and the
  dispatch-stall watchdog that dumps it.
- :mod:`.slo` — declarative latency objectives over request histories.
- :mod:`.blackbox` — the session black box: a replayable ``tdx-session-v1``
  recording of a serve session or a training run, and its replay.
- :mod:`.numerics` — the numerics observatory (``tdx-numerics-v1``): value
  digests on the device (exact nonfinite / zero counts and exponent
  histograms, max-abs and rms gauges) at the serving and training tap
  sites, harvested at existing syncs into a :class:`NumericsBook`.
- :mod:`.ledger` / :mod:`.gate` — the ``tdx-ledger-v1`` rows with every
  artifact family's adapter, and the expectations gate over them
  (``scripts/torch_perf_gate.py``).
"""

from .blackbox import (
    SESSION_SCHEMA,
    SessionRecorder,
    load_session,
    replay_session,
    resolve_record,
    validate_session_jsonl,
)
from .comm import CommProfile, comm_audit, record_collective
from .cost import CostBook, CostCard, compute_cost_card, validate_cost_card
from .flight import FlightRecorder, get_flight_recorder
from .gate import (
    build_expectations,
    gate_rows,
    render_gate_markdown,
    timing_direction,
)
from .ledger import (
    append_record_rows,
    append_rows,
    ingest_artifact,
    make_row,
    read_ledger,
    record_stamp,
    validate_ledger_file,
    validate_ledger_row,
)
from .memory import (
    capacity_plan,
    device_hbm_budget,
    hbm_watermark,
    last_materialize_report,
    memory_report,
    record_materialize,
    sharding_report,
)
from .metrics import (
    Counter,
    Gauge,
    MetricFamily,
    MetricsRegistry,
    Summary,
    default_registry,
    parse_prometheus,
    render_prometheus,
    start_metrics_server,
)
from .numerics import (
    NUMERICS_SCHEMA,
    HostDigest,
    NumericsBook,
    array_digest,
    numerics_enabled,
    numerics_tape,
    tap,
    tap_error,
    tree_digest,
)
from .recompile import RecompileWatcher, recompile_scope, track_jit_cache
from .slo import (
    SLO_SCHEMA,
    SloSpec,
    evaluate_slo,
    slo_collector,
    validate_slo_report,
)
from .trace import (
    Tracer,
    disable_tracing,
    enable_tracing,
    fleet_request_spans,
    fleet_request_trace_events,
    get_tracer,
    request_trace_events,
)
from .watchdog import DispatchWatchdog

__all__ = [
    "Tracer",
    "get_tracer",
    "enable_tracing",
    "disable_tracing",
    "request_trace_events",
    "fleet_request_spans",
    "fleet_request_trace_events",
    "SLO_SCHEMA",
    "SloSpec",
    "evaluate_slo",
    "slo_collector",
    "validate_slo_report",
    "MetricFamily",
    "Counter",
    "Gauge",
    "Summary",
    "MetricsRegistry",
    "default_registry",
    "render_prometheus",
    "parse_prometheus",
    "start_metrics_server",
    "RecompileWatcher",
    "recompile_scope",
    "track_jit_cache",
    "CommProfile",
    "comm_audit",
    "record_collective",
    "FlightRecorder",
    "get_flight_recorder",
    "sharding_report",
    "hbm_watermark",
    "memory_report",
    "record_materialize",
    "last_materialize_report",
    "capacity_plan",
    "device_hbm_budget",
    "CostBook",
    "CostCard",
    "compute_cost_card",
    "validate_cost_card",
    "DispatchWatchdog",
    "SESSION_SCHEMA",
    "SessionRecorder",
    "load_session",
    "replay_session",
    "resolve_record",
    "validate_session_jsonl",
    "NUMERICS_SCHEMA",
    "HostDigest",
    "NumericsBook",
    "array_digest",
    "numerics_enabled",
    "numerics_tape",
    "tap",
    "tap_error",
    "tree_digest",
    "make_row",
    "append_rows",
    "append_record_rows",
    "read_ledger",
    "record_stamp",
    "ingest_artifact",
    "validate_ledger_row",
    "validate_ledger_file",
    "build_expectations",
    "gate_rows",
    "render_gate_markdown",
    "timing_direction",
]
