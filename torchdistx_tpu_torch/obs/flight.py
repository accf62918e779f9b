"""Flight recorder: a bounded ring of structured per-step records that is
dumped atomically on failure, counterpart of ``torchdistx_tpu/obs/
flight.py`` (copied: it touches no device).

A hung dispatch, a memory overcommit or a NaN share one property: by the
time anyone looks, the process state that explained it is gone.  The
recorder
keeps the last ``capacity`` structured events (loss, step timings,
compile counts, comm digests, rng counter, checkpoint paths) in memory
at near-zero cost, and two escape hatches get them out:

- **streaming sink** (``TDX_FLIGHT_DIR`` or ``FlightRecorder(path=)``)
  appends each record as one JSON line, flushed per event — the same
  survive-``kill -9`` contract as the ``obs.trace`` JSONL sink;
- **crash dump** (:meth:`dump`) writes the whole ring atomically
  (tmp + ``os.replace``) with a header record naming the reason — what
  the dispatch watchdog (``obs.watchdog``) calls when a region stalls.

Record shape (validated by :func:`validate_flight_jsonl`): every line is one JSON object
with at least ``kind`` (str) and ``t`` (unix seconds, float).  A dump's
first line has ``kind == "flight_header"`` carrying
``schema: "tdx-flight-v1"``, the reason, pid, and drop count.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "FlightRecorder",
    "get_flight_recorder",
    "validate_flight_jsonl",
]


class FlightRecorder:
    """Bounded structured-event ring with per-event-flush streaming and
    atomic dumps.  Thread-safe; recording is a deque append + optional
    line write."""

    def __init__(
        self,
        capacity: int = 512,
        path: Optional[str] = None,
        dump_dir: Optional[str] = None,
    ) -> None:
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.dumps_total = 0
        self.last_dump_path: Optional[str] = None
        # the path of a recording paired with this run, when a
        # caller sets one: embedded in every dump header, so an incident
        # artifact names its recording
        self.session_path: Optional[str] = None
        self._ring: deque = deque(maxlen=self.capacity)
        self._recorded = 0  # lifetime count (ring overwrites drop old)
        self._lock = threading.Lock()
        self._stream = None
        self._stream_path: Optional[str] = None
        if path:
            self.open_stream(path)

    # -- recording ---------------------------------------------------------

    def record(self, kind: str, **fields: Any) -> dict:
        ev: Dict[str, Any] = {
            "kind": str(kind),
            "t": time.time(),
            **fields,
        }
        with self._lock:
            self._ring.append(ev)
            self._recorded += 1
            if self._stream is not None:
                try:
                    self._stream.write(json.dumps(ev) + "\n")
                    # flush per event: the stream exists precisely for
                    # runs that die without unwinding (kill -9, a hung
                    # dispatch) — an unflushed buffer is a lost black box
                    self._stream.flush()
                except (OSError, ValueError):
                    self._stream = None  # disk gone; keep the ring alive
        return ev

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def recorded_total(self) -> int:
        with self._lock:
            return self._recorded

    def records(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    # -- sinks -------------------------------------------------------------

    def open_stream(self, path: str) -> str:
        """Append every subsequent record to ``path``, one flushed JSON
        line each (the kill-proof sink)."""
        new = open(path, "a")
        with self._lock:  # swap under the same lock record() writes under
            old, self._stream = self._stream, new
            self._stream_path = path
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        return path

    def close_stream(self) -> None:
        with self._lock:
            if self._stream is not None:
                try:
                    self._stream.close()
                except OSError:
                    pass
                self._stream = None

    def dump(
        self, path: Optional[str] = None, reason: str = "manual"
    ) -> str:
        """Atomically write header + the current ring as JSONL.  Returns
        the path (default: ``flight_<pid>_<n>.jsonl`` in ``dump_dir`` /
        ``TDX_FLIGHT_DIR`` / the system temp dir)."""
        with self._lock:
            ring = list(self._ring)
            dropped = self._recorded - len(ring)
            self.dumps_total += 1
            seq = self.dumps_total
        if path is None:
            d = self.dump_dir or os.environ.get("TDX_FLIGHT_DIR")
            if d:
                os.makedirs(d, exist_ok=True)
            else:
                d = tempfile.gettempdir()
            path = os.path.join(
                d, f"flight_{os.getpid()}_{seq}.jsonl"
            )
        header = {
            "kind": "flight_header",
            "t": time.time(),
            "schema": "tdx-flight-v1",
            "reason": reason,
            "pid": os.getpid(),
            "events": len(ring),
            "dropped": dropped,
        }
        if self.session_path:
            header["session"] = self.session_path
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(json.dumps(header) + "\n")
            for ev in ring:
                f.write(json.dumps(ev) + "\n")
        os.replace(tmp, path)  # readers never see a torn dump
        self.last_dump_path = path
        return path

    # -- metrics -----------------------------------------------------------

    def collector(self, prefix: str = "tdx_flight"):
        """An ``obs.metrics`` collector: ring depth/capacity gauges and a
        dumps counter — the satellite gauges the default registry serves
        from ``/metrics``."""
        import weakref

        from .metrics import MetricFamily

        ref = weakref.ref(self)

        def collect():
            rec = ref()
            if rec is None:
                return []
            return [
                MetricFamily(f"{prefix}_depth", "gauge").add(rec.depth),
                MetricFamily(f"{prefix}_capacity", "gauge").add(
                    rec.capacity
                ),
                MetricFamily(f"{prefix}_events_total", "counter").add(
                    rec.recorded_total
                ),
                MetricFamily(f"{prefix}_dumps_total", "counter").add(
                    rec.dumps_total
                ),
            ]

        return collect


_GLOBAL: Optional[FlightRecorder] = None
_GLOBAL_LOCK = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """Process-wide recorder (created on first use).  ``TDX_FLIGHT_DIR``
    turns on the per-event streaming sink (``flight_<pid>.jsonl`` there)
    and routes dumps to the same directory; without it the ring is
    memory-only until someone dumps."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            d = os.environ.get("TDX_FLIGHT_DIR")
            path = None
            if d:
                try:
                    os.makedirs(d, exist_ok=True)
                    path = os.path.join(d, f"flight_{os.getpid()}.jsonl")
                except OSError:
                    d, path = None, None
            _GLOBAL = FlightRecorder(path=path, dump_dir=d)
        return _GLOBAL


def validate_flight_jsonl(path: str) -> list:
    """Schema check for a flight JSONL (streamed sink or dump).  Returns
    error strings (empty = valid)."""
    errors: list = []
    try:
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
    except OSError as e:
        return [f"{path}: unreadable: {e}"]
    if not lines:
        return [f"{path}: empty flight record"]
    for i, ln in enumerate(lines):
        try:
            ev = json.loads(ln)
        except ValueError as e:
            errors.append(f"{path}:{i + 1}: not JSON: {e}")
            continue
        if not isinstance(ev, dict):
            errors.append(f"{path}:{i + 1}: not an object")
            continue
        if not isinstance(ev.get("kind"), str):
            errors.append(f"{path}:{i + 1}: missing str 'kind'")
        if not isinstance(ev.get("t"), (int, float)):
            errors.append(f"{path}:{i + 1}: missing numeric 't'")
        if ev.get("kind") == "flight_header" and ev.get("schema") != (
            "tdx-flight-v1"
        ):
            errors.append(
                f"{path}:{i + 1}: bad header schema {ev.get('schema')!r}"
            )
    return errors
