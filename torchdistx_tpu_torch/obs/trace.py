"""Host-side span tracer with Chrome-trace (Perfetto) export + JSONL sink.

Counterpart of ``torchdistx_tpu/obs/trace.py``, copied: the module
touches no device.  ``torch.profiler`` shows the kernels; this tracer
records the HOST control flow around them (the engine's dispatch loop,
the scheduler, the fleet router) with ``time.monotonic`` timestamps (the
same clock the serving ``Request`` lifecycle uses, so per-request spans
and ``ServeMetrics`` histograms derive from identical numbers) and
exports a valid catapult ``traceEvents`` JSON that Perfetto /
``chrome://tracing`` opens directly, beside a ``torch.profiler`` trace.

Zero-dependency and near-zero-cost when disabled: the module-level
tracer starts disabled, ``span()`` on a disabled tracer is a no-op
context manager, and nothing here ever touches the device.  Enable with
:func:`enable_tracing` (optionally with a JSONL structured-event sink
for post-hoc analysis — one JSON object per line, written as events
complete) or the ``TDX_TRACE_DIR`` environment variable.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "Tracer",
    "get_tracer",
    "enable_tracing",
    "disable_tracing",
    "request_trace_events",
    "fleet_request_spans",
    "fleet_request_trace_events",
    "fleet_scale_trace_events",
]


class Tracer:
    """Append-only span/instant/counter recorder.

    Events are stored with absolute ``time.monotonic`` second timestamps
    and converted to the chrome-trace microsecond timebase (relative to
    the tracer's origin) only at :meth:`export` — so events built from
    OTHER monotonic timestamps (the serve engine's per-request lifecycle)
    land on the same timeline without clock translation.
    """

    def __init__(self, enabled: bool = False, max_events: int = 200_000):
        self.enabled = enabled
        self._max_events = int(max_events)
        self._events: List[Dict[str, Any]] = []
        self._dropped = 0
        self._lock = threading.Lock()
        self._origin = time.monotonic()
        self._jsonl = None
        self._jsonl_path: Optional[str] = None

    # -- recording -------------------------------------------------------

    @property
    def origin(self) -> float:
        return self._origin

    def _add(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) >= self._max_events:
                # never let an unbounded serve run eat the host: drop,
                # but COUNT the drop so export can say the trace is
                # truncated instead of silently looking complete
                self._dropped += 1
                return
            self._events.append(ev)
            if self._jsonl is not None:
                self._jsonl.write(json.dumps(ev) + "\n")
                # flush per event: the sink exists for post-hoc analysis
                # of runs that may die mid-flight (a hung dispatch, a
                # killed process) and for live tail -f; host spans are
                # ms-scale, so a per-line flush is noise
                self._jsonl.flush()

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host", **args: Any) -> Iterator[None]:
        """Record a complete ("X") event around the body.  No-op (and
        allocation-free on the hot path) when the tracer is disabled."""
        if not self.enabled:
            yield
            return
        t0 = time.monotonic()
        try:
            yield
        finally:
            t1 = time.monotonic()
            self._add(
                {
                    "ph": "X",
                    "name": name,
                    "cat": cat,
                    "ts": t0,
                    "dur": t1 - t0,
                    "tid": threading.get_ident() & 0x7FFFFFFF,
                    **({"args": args} if args else {}),
                }
            )

    def instant(self, name: str, cat: str = "host", **args: Any) -> None:
        if not self.enabled:
            return
        self._add(
            {
                "ph": "i",
                "name": name,
                "cat": cat,
                "ts": time.monotonic(),
                "s": "t",
                "tid": threading.get_ident() & 0x7FFFFFFF,
                **({"args": args} if args else {}),
            }
        )

    def counter(self, name: str, **values: float) -> None:
        """Chrome-trace counter track (stacked series per key)."""
        if not self.enabled:
            return
        self._add(
            {
                "ph": "C",
                "name": name,
                "cat": "counter",
                "ts": time.monotonic(),
                "tid": 0,
                "args": dict(values),
            }
        )

    # -- sinks / export --------------------------------------------------

    def open_jsonl(self, path: str) -> str:
        """Stream every subsequent event as one JSON line to ``path``
        (the post-hoc analysis sink — absolute monotonic timestamps, so
        lines from several components interleave consistently)."""
        self.close_jsonl()
        self._jsonl = open(path, "w")
        self._jsonl_path = path
        return path

    def close_jsonl(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._dropped = 0

    def export(
        self, path: str, extra_events: Optional[List[dict]] = None
    ) -> str:
        """Write a catapult/Perfetto ``{"traceEvents": [...]}`` JSON.

        ``extra_events`` are pre-built chrome-format events whose ``ts``
        (and ``dur``) are still in absolute monotonic SECONDS — e.g.
        :func:`request_trace_events` — converted here with the same
        origin as the tracer's own spans."""
        us = 1e6
        out = []
        for ev in self.events() + list(extra_events or []):
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = round((ev["ts"] - self._origin) * us, 3)
            if "dur" in ev:
                ev["dur"] = round(ev["dur"] * us, 3)
            ev.setdefault("pid", 1)
            ev.setdefault("tid", 0)
            out.append(ev)
        doc: Dict[str, Any] = {
            "traceEvents": out,
            "displayTimeUnit": "ms",
        }
        if self._dropped:
            doc["metadata"] = {"dropped_events": self._dropped}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The module-level tracer every instrumented component records into.
    Disabled by default; ``TDX_TRACE_DIR`` (checked once, at first use
    after import) or :func:`enable_tracing` turns it on."""
    return _TRACER


def enable_tracing(jsonl_path: Optional[str] = None) -> Tracer:
    _TRACER.enabled = True
    if jsonl_path:
        _TRACER.open_jsonl(jsonl_path)
    return _TRACER


def disable_tracing() -> Tracer:
    _TRACER.enabled = False
    _TRACER.close_jsonl()
    return _TRACER


# honor the env knob at import: scripts that fork phase subprocesses
# can turn tracing on for every child without plumbing
if os.environ.get("TDX_TRACE_DIR"):
    _dir = os.environ["TDX_TRACE_DIR"]
    try:
        os.makedirs(_dir, exist_ok=True)
        enable_tracing(
            os.path.join(_dir, f"events_{os.getpid()}.jsonl")
        )
    except OSError:
        _TRACER.enabled = True  # tracing on, sink unavailable


_REQUEST_PID = 2  # chrome-trace process id grouping the request tracks


def request_trace_events(requests, name_prefix: str = "req") -> List[dict]:
    """Per-request lifecycle spans, one chrome-trace thread row per
    request: ``queued`` (submit -> admitted), ``prefill`` (admitted ->
    first token), ``decode`` (first token -> finish), plus an instant
    per recorded lifecycle event.  Built from the very same ``Request``
    timestamps that feed the ``ServeMetrics`` histograms, so the spans
    and the aggregates provably agree.

    Timestamps stay in absolute monotonic seconds — pass the result to
    :meth:`Tracer.export` as ``extra_events``.
    """
    out: List[dict] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": _REQUEST_PID,
            "tid": 0,
            "args": {"name": "serve requests"},
        }
    ]
    for req in requests:
        tid = int(req.rid) + 1  # tid 0 is the metadata row
        out.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": _REQUEST_PID,
                "tid": tid,
                "args": {"name": f"{name_prefix} {req.rid}"},
            }
        )
        phases = []
        if req.admitted_at is not None:
            phases.append(("queued", req.submitted_at, req.admitted_at))
            if req.first_token_at is not None:
                phases.append(
                    ("prefill", req.admitted_at, req.first_token_at)
                )
                if req.finished_at is not None:
                    phases.append(
                        ("decode", req.first_token_at, req.finished_at)
                    )
        elif req.finished_at is not None:  # expired while queued
            phases.append(("queued", req.submitted_at, req.finished_at))
        for name, t0, t1 in phases:
            out.append(
                {
                    "ph": "X",
                    "name": name,
                    "cat": "request",
                    "pid": _REQUEST_PID,
                    "tid": tid,
                    "ts": t0,
                    "dur": max(0.0, t1 - t0),
                    "args": {"rid": int(req.rid)},
                }
            )
        for name, ts, data in getattr(req, "events", ()):
            out.append(
                {
                    "ph": "i",
                    "name": name,
                    "cat": "lifecycle",
                    "pid": _REQUEST_PID,
                    "tid": tid,
                    "ts": ts,
                    "s": "t",
                    **({"args": data} if data else {}),
                }
            )
    return out


# -- fleet (cross-replica) request tracing --------------------------------
#
# A fleet request's life spans MACHINES: router decision -> prefill
# replica -> KV handoff -> decode replica -> (maybe) migration.  The
# functions below generalize the single-engine lifecycle rows above: one
# chrome-trace PROCESS per replica, one thread row per request keyed on
# the process-unique ``Request.trace_id`` (rids collide across replicas),
# and Perfetto FLOW events (ph s/t/f sharing ``id=trace_id``) stitching
# the spans into one causal chain per request across replica tracks.

_FLEET_PID_BASE = 10  # replica rid r renders as chrome pid 10 + r


def fleet_request_spans(req, routed_ts: Optional[float] = None):
    """The request's telescoping cross-replica span chain:
    ``(name, t0, t1)`` triples in absolute monotonic seconds.

    This is THE exactness primitive of the fleet tracing contract:
    consecutive spans share their boundary
    timestamp VERBATIM (span ``i`` ends on the exact float span ``i+1``
    starts on), the first span starts on ``submitted_at`` and the last
    ends on ``finished_at`` — so the chain tiles ``[submitted_at,
    finished_at]`` with no gap and no overlap, and the span durations
    sum *exactly* (as reals — pin it with ``fractions.Fraction`` over
    the float boundaries, which represent their values exactly) to the
    ``latency_s`` e2e aggregate, handoff gap included.  IEEE float
    addition of the per-span ``t1 - t0`` differences would reintroduce
    rounding; the identity lives in the shared boundaries.

    Boundaries, in order (absent stages collapse out):

    - ``route``: ``submitted_at`` -> the ``routed`` event's ts (router
      decision latency; only requests submitted through a fleet have it)
    - ``queued``: -> ``admitted_at`` (or ``finished_at`` for a request
      that expired while queued — then the chain ends here)
    - ``prefill``: -> ``first_token_at``
    - ``handoff``: -> each disaggregated ``handoff`` event's ts (the
      parked-for-a-decode-slot gap plus the wire move)
    - ``decode``: -> ``finished_at``, segmented at any mid-decode
      ``migrated`` event ts (each segment is its own ``decode`` span, so
      a migration never breaks the tiling)
    """
    if routed_ts is None:
        for name, ts, _ in getattr(req, "events", ()):
            if name == "routed":
                routed_ts = ts
                break
    spans = []
    cursor = req.submitted_at
    if routed_ts is not None:
        spans.append(("route", cursor, routed_ts))
        cursor = routed_ts
    if req.admitted_at is None:
        if req.finished_at is not None:  # expired while queued
            spans.append(("queued", cursor, req.finished_at))
        return spans
    spans.append(("queued", cursor, req.admitted_at))
    cursor = req.admitted_at
    if req.first_token_at is None:
        if req.finished_at is not None:  # expired before first token
            spans.append(("prefill", cursor, req.finished_at))
        return spans
    spans.append(("prefill", cursor, req.first_token_at))
    cursor = req.first_token_at
    if req.finished_at is None:
        return spans
    # post-first-token boundaries: handoffs (disaggregation) and
    # mid-decode migrations, in event order, clamped to the decode window
    for name, ts, data in getattr(req, "events", ()):
        if name == "handoff" and cursor <= ts <= req.finished_at:
            spans.append(("handoff", cursor, ts))
            cursor = ts
        elif (
            name == "migrated"
            and not (data or {}).get("queued")
            and cursor <= ts <= req.finished_at
        ):
            spans.append(("decode", cursor, ts))
            cursor = ts
    spans.append(("decode", cursor, req.finished_at))
    return spans


def fleet_request_trace_events(
    finished, roles=None, name_prefix: str = "req"
) -> List[dict]:
    """Merged multi-replica request rows + flow events for
    ``ServeFleet.dump_trace``.

    ``finished`` is an iterable of ``(replica_rid, role, request)`` —
    the replica each request FINISHED on (live rotation plus replicas
    already retired by ``fleet.remove``).  ``roles`` optionally maps
    additional replica rids (e.g. the prefill replica a disaggregated
    request was ROUTED to, which never holds the finished request) to
    their role string for the process-name metadata rows.

    Span placement: everything up to the last cross-engine boundary
    (the final ``handoff``/``migrated`` event) renders on the replica
    the request was ROUTED to (from its ``routed`` lifecycle event);
    the remainder on the replica it finished on.  Each request is one
    flow: ``ph:"s"`` opens the chain on its first span, a ``ph:"t"``
    step rides every intermediate span, ``ph:"f"`` (``bp:"e"``) closes
    it on the last — all sharing ``id=trace_id``, so every flow id
    resolves end to end.  Timestamps stay absolute monotonic seconds;
    pass the result to :meth:`Tracer.export` as ``extra_events``.
    """
    finished = list(finished)
    role_of = dict(roles or {})
    for rid, role, _req in finished:
        role_of.setdefault(rid, role)

    # deterministic request order (trace_id is process-unique); guard
    # against the same request arriving via two paths
    seen = set()
    entries = []
    for rid, role, req in finished:
        key = id(req)
        if key in seen:
            continue
        seen.add(key)
        entries.append((rid, req))
    entries.sort(
        key=lambda e: (
            e[1].trace_id if e[1].trace_id is not None else int(e[1].rid),
        )
    )

    out: List[dict] = []
    pids_named = set()

    def ensure_pid(rid: int) -> int:
        pid = _FLEET_PID_BASE + int(rid)
        if rid not in pids_named:
            pids_named.add(rid)
            role = role_of.get(rid)
            label = f"replica {rid}" + (f" ({role})" if role else "")
            out.append(
                {
                    "ph": "M",
                    "name": "process_name",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": label},
                }
            )
        return pid

    for finish_rid, req in entries:
        trace_id = (
            int(req.trace_id)
            if req.trace_id is not None
            else int(req.rid) + 1
        )
        tid = trace_id  # unique per request across the whole process
        routed_rid = finish_rid
        for name, _ts, data in getattr(req, "events", ()):
            if name == "routed" and data and "replica" in data:
                routed_rid = int(data["replica"])
                break
        spans = fleet_request_spans(req)
        if not spans:
            continue
        # spans strictly before the last cross-engine boundary happened
        # on the routed replica; the rest on the finishing one.  The
        # boundary index is the last span that ENDS on a handoff or
        # mid-decode migration event.
        cut = 0
        boundary_ts = {
            ts
            for name, ts, data in getattr(req, "events", ())
            if name == "handoff"
            or (name == "migrated" and not (data or {}).get("queued"))
        }
        for i, (_name, _t0, t1) in enumerate(spans):
            if t1 in boundary_ts:
                cut = i + 1
        pid_of_span = [
            ensure_pid(routed_rid if i < cut else finish_rid)
            for i in range(len(spans))
        ]
        for pid in sorted(set(pid_of_span)):
            out.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": f"{name_prefix} {trace_id}"},
                }
            )
        for i, (name, t0, t1) in enumerate(spans):
            out.append(
                {
                    "ph": "X",
                    "name": name,
                    "cat": "request",
                    "pid": pid_of_span[i],
                    "tid": tid,
                    "ts": t0,
                    "dur": max(0.0, t1 - t0),
                    "args": {
                        "rid": int(req.rid),
                        "trace_id": trace_id,
                        "replica": pid_of_span[i] - _FLEET_PID_BASE,
                    },
                }
            )
        # the flow: s on the first span, t steps between, f on the last
        for i, (name, t0, t1) in enumerate(spans):
            ph = (
                "s"
                if i == 0
                else ("f" if i == len(spans) - 1 else "t")
            )
            if len(spans) == 1:
                # a one-span chain still needs both endpoints so every
                # flow id resolves: open AND close on the same slice
                out.append(
                    {
                        "ph": "s",
                        "name": f"{name_prefix}_flow",
                        "cat": "req_flow",
                        "id": trace_id,
                        "pid": pid_of_span[i],
                        "tid": tid,
                        "ts": t0,
                    }
                )
                ph = "f"
            ev = {
                "ph": ph,
                "name": f"{name_prefix}_flow",
                "cat": "req_flow",
                "id": trace_id,
                "pid": pid_of_span[i],
                "tid": tid,
                "ts": t0,
            }
            if ph == "f":
                ev["bp"] = "e"
            out.append(ev)
        # lifecycle instants ride the span that contains them (fall back
        # to the finishing replica's track for out-of-window timestamps)
        for name, ts, data in getattr(req, "events", ()):
            pid = ensure_pid(finish_rid)
            for i, (_n, t0, t1) in enumerate(spans):
                if t0 <= ts <= t1:
                    pid = pid_of_span[i]
                    break
            out.append(
                {
                    "ph": "i",
                    "name": name,
                    "cat": "lifecycle",
                    "pid": pid,
                    "tid": tid,
                    "ts": ts,
                    "s": "t",
                    **({"args": data} if data else {}),
                }
            )
    return out


_FLEET_TRACK_PID = _FLEET_PID_BASE - 1  # the fleet-wide control track


def fleet_scale_trace_events(events) -> List[dict]:
    """Fleet control-plane instants for ``ServeFleet.dump_trace``: every
    scale/role/add/remove entry of ``fleet.events`` as a Perfetto
    instant on a dedicated "fleet" process track, so a trace answers
    "what did the autoscaler do, and when, relative to the request
    chains" on one timeline.  Autoscale decisions render as
    ``scale:<action>`` with a COMPACT arg set (tick, action, replica,
    burn state, reason) — the full signal vector stays in
    ``fleet.events`` and the flight record, where schema checks read
    it.  Timestamps stay absolute monotonic seconds; pass the result to
    :meth:`Tracer.export` as ``extra_events``."""
    picked = [
        (name, ts, data)
        for name, ts, data in events
        if name in ("scale", "role", "add", "remove")
    ]
    if not picked:
        return []
    out: List[dict] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": _FLEET_TRACK_PID,
            "tid": 0,
            "args": {"name": "fleet"},
        }
    ]
    for name, ts, data in picked:
        data = data or {}
        if name == "scale":
            label = f"scale:{data.get('action', '?')}"
            args = {
                "tick": data.get("tick"),
                "action": data.get("action"),
                "mode": data.get("mode"),
                "replica": data.get("replica"),
                "state": (data.get("signal") or {}).get("state"),
                "reason": data.get("reason"),
            }
        else:
            label = name
            args = {
                k: v
                for k, v in data.items()
                if isinstance(v, (int, float, str, bool, type(None)))
            }
        out.append(
            {
                "ph": "i",
                "name": label,
                "cat": "fleet",
                "pid": _FLEET_TRACK_PID,
                "tid": 0,
                "ts": ts,
                "s": "p",
                "args": args,
            }
        )
    return out
