"""Metrics registry with Prometheus text exposition — stdlib only.
Counterpart of ``torchdistx_tpu/obs/metrics.py``, copied: it touches no
device, and the text it renders is the JAX package's byte for byte.

Three owned primitives (:class:`Counter`, :class:`Gauge`,
:class:`Summary`, all label-aware) plus a **collector** protocol for
components that already keep their own state: a collector is any
zero-arg callable returning an iterable of :class:`MetricFamily`, read
live at render time.  ``ServeMetrics.collector()`` and
the fleet and autoscaler collectors re-register the existing serving
metrics through this layer WITHOUT changing their own ``snapshot()`` /
``to_json()`` schemas — the exposition is a projection of the same
state, never a second source of truth.

Exposition is the Prometheus text format (``0.0.4``): rendered by
:meth:`MetricsRegistry.render`, round-trippable by the stdlib-only
:func:`parse_prometheus` (what the tests use),
and optionally served from a ``http.server`` ``/metrics`` endpoint
(:func:`start_metrics_server` — no pip installs).

Reservoir histograms (``serve.metrics.Histogram``) map onto Prometheus
**summaries**: ``{quantile="0.5"|"0.95"}`` samples come from the
most-recent-window reservoir while ``_sum``/``_count`` are exact over
the lifetime — the ``window_count`` gauge says how many samples back
the quantiles actually look (see the Histogram docstring).
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "MetricFamily",
    "Counter",
    "Gauge",
    "Summary",
    "MetricsRegistry",
    "default_registry",
    "render_prometheus",
    "parse_prometheus",
    "start_metrics_server",
]

_TYPES = ("counter", "gauge", "summary", "untyped")


def _escape_label(v: str) -> str:
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


@dataclass
class MetricFamily:
    """One exposition family: ``samples`` are ``(suffix, labels, value)``
    where ``suffix`` ("", "_sum", "_count", ...) is appended to ``name``.
    """

    name: str
    mtype: str  # one of _TYPES
    help: str = ""
    samples: List[Tuple[str, Dict[str, str], float]] = field(
        default_factory=list
    )

    def add(
        self, value: float, suffix: str = "", **labels: str
    ) -> "MetricFamily":
        self.samples.append((suffix, labels, value))
        return self


class _Labeled:
    """Shared label-series storage for the owned primitives."""

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._series: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(labels: Dict[str, str]):
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def value(self, **labels: str) -> float:
        return self._series.get(self._key(labels), 0.0)


class Counter(_Labeled):
    """Monotonically increasing value; rendered with the ``_total``
    suffix convention left to the caller's naming."""

    def inc(self, n: float = 1.0, **labels: str) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    def family(self) -> MetricFamily:
        fam = MetricFamily(self.name, "counter", self.help)
        for key, v in sorted(self._series.items()):
            fam.add(v, **dict(key))
        if not self._series:
            fam.add(0.0)
        return fam


class Gauge(_Labeled):
    def set(self, v: float, **labels: str) -> None:
        with self._lock:
            self._series[self._key(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    def family(self) -> MetricFamily:
        fam = MetricFamily(self.name, "gauge", self.help)
        for key, v in sorted(self._series.items()):
            fam.add(v, **dict(key))
        if not self._series:
            fam.add(0.0)
        return fam


class Summary(_Labeled):
    """count/sum summary (no quantiles — components with reservoirs
    expose quantiles through their own collector instead)."""

    def __init__(self, name: str, help: str):
        super().__init__(name, help)
        self._count: Dict[Tuple[Tuple[str, str], ...], int] = {}

    def observe(self, v: float, **labels: str) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + float(v)
            self._count[key] = self._count.get(key, 0) + 1

    def family(self) -> MetricFamily:
        fam = MetricFamily(self.name, "summary", self.help)
        for key in sorted(self._series):
            labels = dict(key)
            fam.add(self._series[key], "_sum", **labels)
            fam.add(self._count[key], "_count", **labels)
        return fam


class MetricsRegistry:
    """Named metrics + live collectors, rendered to exposition text.

    Collectors registered with an owning object (``obj=``) are held by
    weakref and silently dropped once the owner is collected — a caller
    that rebinds ``engine.metrics`` between passes cannot leak stale
    families into the exposition.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._collectors: List[Callable[[], Iterable[MetricFamily]]] = []
        self._lock = threading.Lock()

    def _register(self, name: str, metric):
        with self._lock:
            if name in self._metrics:
                raise ValueError(f"metric {name!r} already registered")
            self._metrics[name] = metric
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(name, Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(name, Gauge(name, help))

    def summary(self, name: str, help: str = "") -> Summary:
        return self._register(name, Summary(name, help))

    def register_collector(
        self,
        fn: Callable[[], Iterable[MetricFamily]],
        obj: Optional[object] = None,
    ) -> None:
        """Add a live collector.  With ``obj``, the registration lives
        exactly as long as ``obj`` does: a bound method OF ``obj`` is
        held through ``weakref.WeakMethod`` (a strong reference to the
        bound method would itself pin the owner), anything else through
        a liveness check on ``obj``.  Note a plain closure over the
        owner still pins it — collectors meant to expire with their
        owner must close over a weakref themselves, as
        ``ServeFleet.collector`` / ``CostBook.collector`` do."""
        if obj is not None:
            if getattr(fn, "__self__", None) is obj:
                wm = weakref.WeakMethod(fn)

                def weak_fn(_wm=wm):
                    m = _wm()
                    return [] if m is None else m()

            else:
                ref = weakref.ref(obj)

                def weak_fn(_fn=fn, _ref=ref):
                    return [] if _ref() is None else _fn()

            fn = weak_fn
        with self._lock:
            self._collectors.append(fn)

    def collect(self) -> List[MetricFamily]:
        fams: List[MetricFamily] = []
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors)
        for m in metrics:
            fams.append(m.family())
        for fn in collectors:
            fams.extend(fn())
        return fams

    def render(self) -> str:
        return render_prometheus(self.collect())


def render_prometheus(families: Iterable[MetricFamily]) -> str:
    """Prometheus text exposition (format version 0.0.4)."""
    lines: List[str] = []
    seen: set = set()
    for fam in families:
        if fam.mtype not in _TYPES:
            raise ValueError(f"unknown metric type {fam.mtype!r}")
        if fam.name in seen:
            raise ValueError(f"duplicate metric family {fam.name!r}")
        seen.add(fam.name)
        if fam.help:
            esc = fam.help.replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {fam.name} {esc}")
        lines.append(f"# TYPE {fam.name} {fam.mtype}")
        for suffix, labels, value in fam.samples:
            if value is None:
                continue  # empty-reservoir quantiles have no sample
            lines.append(
                f"{fam.name}{suffix}{_fmt_labels(labels)} "
                f"{_fmt_value(float(value))}"
            )
    return "\n".join(lines) + "\n"


def _fmt_value(v: float) -> str:
    """Prometheus sample rendering, non-finite literals included — a
    NaN loss gauge must render as ``NaN``, not crash every scrape."""
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return str(int(v)) if v == int(v) else repr(v)


def parse_prometheus(text: str) -> dict:
    """Stdlib-only line parser for the text exposition — the round-trip
    check of :func:`render_prometheus` output.  Returns
    ``{"types": {family: type}, "samples": {(name, ((k, v), ...)): float}}``
    where ``name`` includes any ``_sum``/``_count`` suffix."""
    types: Dict[str, str] = {}
    samples: Dict[Tuple[str, tuple], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                if parts[2] in types:
                    raise ValueError(f"duplicate TYPE for {parts[2]}")
                types[parts[2]] = parts[3] if len(parts) > 3 else ""
            continue
        # name{labels} value  |  name value
        if "{" in line:
            name, rest = line.split("{", 1)
            labels_str, value_str = rest.rsplit("}", 1)
            labels = []
            for item in _split_labels(labels_str):
                k, v = item.split("=", 1)
                v = v.strip()[1:-1]  # strip quotes
                v = (
                    v.replace("\\n", "\n")
                    .replace('\\"', '"')
                    .replace("\\\\", "\\")
                )
                labels.append((k.strip(), v))
            key = (name.strip(), tuple(sorted(labels)))
            value = float(value_str.strip().split()[0])
        else:
            parts = line.split()
            if len(parts) < 2:
                raise ValueError(f"unparseable exposition line: {line!r}")
            key = (parts[0], ())
            value = float(parts[1])
        if key in samples:
            raise ValueError(f"duplicate sample {key}")
        samples[key] = value
    return {"types": types, "samples": samples}


def _split_labels(s: str) -> List[str]:
    """Split ``k1="v1",k2="v2"`` honoring escaped quotes inside values."""
    out, cur, in_quotes, escaped = [], [], False, False
    for ch in s:
        if escaped:
            cur.append(ch)
            escaped = False
            continue
        if ch == "\\":
            cur.append(ch)
            escaped = True
            continue
        if ch == '"':
            in_quotes = not in_quotes
            cur.append(ch)
            continue
        if ch == "," and not in_quotes:
            out.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    if cur:
        out.append("".join(cur))
    return [x for x in (y.strip() for y in out) if x]


_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """Process-wide registry (created on first use): what the ``/metrics``
    endpoint and the recompile watcher register into unless told
    otherwise.  Runtime collectors install themselves on creation:
    ``tdx_jit_cache_size{fn=...}`` for jits registered via
    ``obs.recompile.track_jit_cache`` and the flight recorder's
    depth/capacity/dump gauges (``obs.flight``)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
        try:
            from .flight import get_flight_recorder
            from .recompile import jit_cache_collector

            _DEFAULT.register_collector(jit_cache_collector())
            rec = get_flight_recorder()
            _DEFAULT.register_collector(rec.collector(), obj=rec)
        except Exception:
            pass  # registry must exist even if a runtime collector can't
    return _DEFAULT


def start_metrics_server(
    registry: Optional[MetricsRegistry] = None,
    host: str = "127.0.0.1",
    port: int = 0,
):
    """Serve ``GET /metrics`` from a daemon-thread stdlib HTTP server.

    Returns the server; read the bound port from
    ``server.server_address[1]`` (``port=0`` picks a free one) and stop
    it with ``server.shutdown()``.  This is a scrape endpoint for one
    process — run it next to the engine, never in front of it.
    """
    import http.server

    reg = registry if registry is not None else default_registry()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_error(404)
                return
            try:
                body = reg.render().encode()
            except Exception as e:  # a broken collector must not kill the server
                self.send_error(500, str(e)[:200])
                return
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # silence per-scrape stderr lines
            pass

    server = http.server.ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server
