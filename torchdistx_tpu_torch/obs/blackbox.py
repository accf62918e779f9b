"""The session black box, counterpart of ``torchdistx_tpu/obs/
blackbox.py`` (copied: it touches no device), same ``tdx-session-v1``
format.

A live serve session consumes a nondeterminism surface from the outside
world (what was submitted, and when the caller stepped); everything else
is deterministic by construction (the seed-keyed sampler, the engines'
exact counters).  The black box records that surface and a digest of what
came out, and :func:`replay_session` re-executes it.

One ``tdx-session-v1`` JSONL file holds two things:

- **The event log**: every boundary crossing into the session: engine
  and fleet geometry (slots, pages, ring, KV dtype), every ``submit()``
  (prompt token ids, sampling parameters, deadline), every ``step()`` and
  fleet tick, every autoscale controller tick with its live signal vector,
  plus an environment stamp (git sha, the torch and CUDA versions, the
  card's name, read without touching the card).  Written and flushed
  event by event, so a killed run's recording survives up to its last
  completed event.

- **The drain digest chain**: a rolling SHA-256 folded at every drain
  boundary (the sites that count ``host_syncs``) over the engine's integer
  counters and the tokens emitted at that drain.  Every value hashed is
  already on the host at the hook site, so recording adds ZERO host
  syncs.  Every ``snapshot_every`` drains a full counter snapshot rides
  along as a bisection waypoint.

:func:`replay_session` rebuilds the engine or the fleet from the recorded
geometry through the caller's factories (on the device their model is on:
the card, unless the caller builds it on the CPU), re-drives the exact
event stream and compares the digest chains: equality is the verdict.  On
a mismatch it bisects, the snapshots bracketing the window and the drains
inside it compared one by one, to name the **first divergent drain** (seq
and tick), the **counters that differ** and the **affected request ids**.

Request identity: engine ``rid``\\ s are per scheduler, so the recorder
gives every request a session-local id at submit time, keyed on the
process-unique ``trace_id`` that rides handoffs and migrations.  Record
and replay register submits in the same order, so session ids align.

``TDX_SESSION_RECORD=0`` is the kill switch (the ``TDX_COST_CARDS``
pattern): every implicitly built recorder is a no-op object: no file, no
events, no digest work.  An explicit ``SessionRecorder(enabled=True)``
(the replay harness's own recorder) still records.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Union

from .ledger import git_sha

__all__ = [
    "SESSION_SCHEMA",
    "git_sha",
    "SessionRecorder",
    "recording_enabled",
    "session_force_disabled",
    "resolve_record",
    "geometry_kwargs",
    "load_session",
    "validate_session_jsonl",
    "replay_session",
    "rechain",
    "signals_from_session",
]

SESSION_SCHEMA = "tdx-session-v1"

#: TDX_SESSION_RECORD spellings that mean OFF — one list, same as the
#: obs.cost kill switch, so the switch can never half-engage
_OFF_VALUES = ("0", "false", "")


def _env_state() -> Optional[bool]:
    """``TDX_SESSION_RECORD`` as a tri-state: None (unset), True (on),
    False (any off spelling, case-insensitive)."""
    v = os.environ.get("TDX_SESSION_RECORD")
    if v is None:
        return None
    return v.strip().lower() not in _OFF_VALUES


def recording_enabled(default: bool = True) -> bool:
    """Whether implicitly-constructed session recorders record."""
    state = _env_state()
    return default if state is None else state


def session_force_disabled() -> bool:
    """True when ``TDX_SESSION_RECORD`` is explicitly an off spelling —
    the kill switch that turns every implicit recorder into a no-op
    object (engines/fleets/trainers built with ``record=`` included)."""
    return _env_state() is False


def _env_stamp() -> dict:
    """Environment attribution for the session header: enough to judge
    whether a replay can expect bit-identity (the same sha, torch and card
    give the same chain; a CPU replay of a card recording may diverge,
    which is evidence about the devices, not the code).  The card's name
    comes from ``torch.cuda.get_device_properties`` only when CUDA is
    already initialized in this process: the stamp never initializes the
    device."""
    stamp: dict = {"pid": os.getpid(), "git_sha": git_sha()}
    try:
        import torch

        stamp["torch_version"] = torch.__version__
        stamp["cuda_version"] = torch.version.cuda
        stamp["device_name"] = (torch.cuda.get_device_properties(torch.cuda.current_device()).name
                                if torch.cuda.is_initialized() else None)
    except Exception:
        stamp.setdefault("torch_version", None)
        stamp.setdefault("cuda_version", None)
        stamp["device_name"] = None
    return stamp


def _canon(obj: Any) -> str:
    """Canonical JSON for hashing: sorted keys, no whitespace — the one
    spelling record and replay both fold into the chain."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _fold(chain: str, payload: dict) -> str:
    """One link of the digest chain: SHA-256 of the previous link and the
    payload's canonical JSON."""
    return hashlib.sha256((chain + _canon(payload)).encode()).hexdigest()


#: drain-event fields that participate in the chain payload (everything
#: except the wall-clock timestamp and the chain value itself)
_DRAIN_PAYLOAD_FIELDS = ("seq", "tick", "source", "delta", "tokens")


class SessionRecorder:
    """Streaming ``tdx-session-v1`` recorder + drain digest chain.

    ``path=None`` keeps the recording in memory only (``self.events``)
    — the replay harness's mode.  With a path, every event is written
    and flushed as it happens (flight-sink discipline): a SIGKILL'd
    run's file ends at its last completed event and
    :func:`replay_session` replays the complete prefix.

    ``enabled=None`` defers to the ``TDX_SESSION_RECORD`` kill switch;
    an explicit ``enabled=True`` records regardless (the replay
    harness must work even while production recording is switched
    off)."""

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        snapshot_every: int = 8,
        enabled: Optional[bool] = None,
        stamp: bool = True,
    ):
        if enabled is None:
            enabled = recording_enabled()
        self.enabled = bool(enabled)
        self.path = path if self.enabled else None
        self.snapshot_every = max(0, int(snapshot_every))
        self.events: List[dict] = []
        self._lock = threading.Lock()
        self._stream = None
        #: the current fleet tick (the fleet sets it at the top of every
        #: ``step``); single-engine callers bump it per ``step()`` —
        #: every drain event carries it, so a divergence names the tick
        self.tick = 0
        self._chain = hashlib.sha256(SESSION_SCHEMA.encode()).hexdigest()
        self._drains = 0
        self._closed = False
        # per-source (replica) last-counter state for drain deltas
        self._last: Dict[str, Dict[str, int]] = {}
        # trace_id -> session-local request id (submit order)
        self._rid_map: Dict[int, int] = {}
        self._next_rid = 0
        if not self.enabled:
            return
        if self.path:
            try:
                # "w", never "a": a recording is ONE session — appending
                # to a leftover file from an earlier (crashed) run would
                # produce a two-header recording whose replay fails with
                # an unhelpful empty-fields geometry_mismatch
                self._stream = open(self.path, "w")
            except OSError:
                self._stream = None
        header = {
            "kind": "session_header",
            "t": time.time(),
            "schema": SESSION_SCHEMA,
            "snapshot_every": self.snapshot_every,
        }
        if stamp:
            header.update(_env_stamp())
        self._emit(header)

    # -- sink -------------------------------------------------------------

    def _emit(self, event: dict) -> None:
        with self._lock:
            self.events.append(event)
            if self._stream is not None:
                try:
                    self._stream.write(json.dumps(event) + "\n")
                    self._stream.flush()
                except (OSError, ValueError):
                    # a full/revoked disk must never take the session
                    # down; the in-memory record survives (flight.py
                    # discipline)
                    self._stream = None

    def record(self, kind: str, **fields) -> None:
        """Append one generic event (the event log side).  No-op when
        disabled — callers never need to guard."""
        if not self.enabled or self._closed:
            return
        self._emit({"kind": kind, "t": time.time(), **fields})

    # -- request identity -------------------------------------------------

    def register_request(self, trace_id: int) -> int:
        """Session-local id for one submitted request (submit order).
        Keyed on the process-unique ``trace_id`` so the id survives
        handoffs/migrations and never depends on per-scheduler rid
        bases or on how many requests ran before recording started."""
        sid = self._rid_map.get(trace_id)
        if sid is None:
            sid = self._next_rid
            self._next_rid += 1
            self._rid_map[trace_id] = sid
        return sid

    def session_rid(self, trace_id: Optional[int]) -> Optional[int]:
        if trace_id is None:
            return None
        return self._rid_map.get(trace_id)

    def record_submit(self, source: str, req: Any, **extra) -> None:
        """One ``submit`` event: the request's full outside-world
        identity (token ids, sampling params, deadline) plus its
        session id."""
        if not self.enabled or self._closed:
            return
        sid = self.register_request(req.trace_id)
        self.record(
            "submit",
            source=source,
            rid=sid,
            tick=self.tick,
            prompt=[int(t) for t in req.prompt],
            max_new_tokens=int(req.max_new_tokens),
            temperature=float(req.temperature),
            seed=int(req.seed),
            deadline_s=req.deadline_s,
            **extra,
        )

    # -- digest chain -----------------------------------------------------

    def drain(
        self,
        source: str,
        counters: Dict[str, int],
        tokens: Dict[int, List[int]],
    ) -> None:
        """Fold one drain boundary into the chain.  ``counters`` is the
        engine's live integer counter dict (read, never copied until
        here — all values are already host-side); ``tokens`` maps
        session rid -> tokens emitted at this drain.  Called at exactly
        the sites that count ``host_syncs``, AFTER the drain walk, so
        the delta covers everything that sync materialized."""
        if not self.enabled or self._closed:
            return
        last = self._last.get(source, {})
        delta = {}
        for k, v in counters.items():
            if not isinstance(v, int):
                continue  # derived floats are not in the digest domain
            d = v - last.get(k, 0)
            if d:
                delta[k] = d
        self._last[source] = {
            k: v for k, v in counters.items() if isinstance(v, int)
        }
        seq = self._drains
        self._drains += 1
        payload = {
            "seq": seq,
            "tick": self.tick,
            "source": source,
            "delta": delta,
            "tokens": {str(r): t for r, t in sorted(tokens.items())},
        }
        self._chain = _fold(self._chain, payload)
        self._emit(
            {"kind": "drain", "t": time.time(), **payload,
             "chain": self._chain}
        )
        if self.snapshot_every and self._drains % self.snapshot_every == 0:
            self._snapshot()

    def _snapshot(self) -> None:
        self._emit(
            {
                "kind": "snapshot",
                "t": time.time(),
                "seq": self._drains - 1,
                "tick": self.tick,
                "chain": self._chain,
                "counters": {
                    s: dict(c) for s, c in sorted(self._last.items())
                },
            }
        )

    @property
    def chain(self) -> str:
        return self._chain

    @property
    def drains(self) -> int:
        return self._drains

    def close(self, **fields) -> None:
        """Write the ``session_end`` verdict anchor (final chain, drain
        count, full final counters) and release the file handle.  A
        recording without it is, by definition, truncated."""
        if not self.enabled or self._closed:
            return
        self._emit(
            {
                "kind": "session_end",
                "t": time.time(),
                "drains": self._drains,
                "chain": self._chain,
                "counters": {
                    s: dict(c) for s, c in sorted(self._last.items())
                },
                **fields,
            }
        )
        self._closed = True
        with self._lock:
            if self._stream is not None:
                try:
                    self._stream.close()
                except OSError:
                    pass
                self._stream = None


def resolve_record(record: Any) -> Optional[SessionRecorder]:
    """The one ``record=`` kwarg resolution for ``ServeEngine``,
    ``ServeFleet``, and ``Trainer``: None stays None, a recorder passes
    through, a path string builds a streaming recorder, ``True`` builds
    an in-memory one.  The kill switch turns every implicitly-built
    recorder into a no-op object (``enabled`` defaulting rules in
    :class:`SessionRecorder`)."""
    if record is None:
        return None
    if isinstance(record, SessionRecorder):
        return record
    if record is True:
        return SessionRecorder(None)
    if isinstance(record, (str, os.PathLike)):
        return SessionRecorder(os.fspath(record))
    raise TypeError(
        f"record= must be None, True, a path, or a SessionRecorder — "
        f"got {type(record).__name__}"
    )


# -- loading / validation -------------------------------------------------


def load_session(
    recording: Union[str, List[dict]]
) -> Tuple[List[dict], List[str]]:
    """Read a recording (path or already-loaded event list).  A torn
    final line — the SIGKILL case — is dropped with a note, never an
    error: the complete prefix is exactly what replay needs."""
    if not isinstance(recording, (str, os.PathLike)):
        return list(recording), []
    notes: List[str] = []
    events: List[dict] = []
    with open(recording) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                notes.append(
                    f"line {i + 1}: torn final event dropped (killed "
                    "mid-write); replaying the complete prefix"
                )
                break
            raise ValueError(
                f"{recording}:{i + 1}: unparseable mid-file event"
            )
        events.append(ev)
    return events, notes


def validate_session_jsonl(
    path: Union[str, List[dict]], *, allow_truncated: bool = False
) -> List[str]:
    """Schema + digest-chain integrity for one recording.  Returns
    error strings (empty = valid): header first and schema-stamped,
    every event an object with a kind, drain seqs dense from 0, the
    chain recomputable from the drain payloads, every snapshot's chain
    anchored to its drain and its counters equal to the accumulated
    deltas, and a ``session_end`` present (unless ``allow_truncated``)
    whose chain/drain count match."""
    errors: List[str] = []
    name = path if isinstance(path, (str, os.PathLike)) else "<events>"
    try:
        events, notes = load_session(path)
    except (OSError, ValueError) as e:
        return [f"{name}: {e}"]
    for n in notes:
        if not allow_truncated:
            errors.append(f"{name}: {n}")
    if not events:
        return [f"{name}: empty recording"]
    head = events[0]
    if head.get("kind") != "session_header":
        errors.append(f"{name}: first event is not a session_header")
    elif head.get("schema") != SESSION_SCHEMA:
        errors.append(
            f"{name}: schema {head.get('schema')!r} != {SESSION_SCHEMA}"
        )
    n_heads = sum(
        1 for e in events if e.get("kind") == "session_header"
    )
    if n_heads > 1:
        errors.append(
            f"{name}: {n_heads} session_header events — two recordings "
            "concatenated into one file (one session, one file)"
        )
    chain = hashlib.sha256(SESSION_SCHEMA.encode()).hexdigest()
    acc: Dict[str, Dict[str, int]] = {}
    seq = 0
    end = None
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "kind" not in ev:
            errors.append(f"{name}: event {i} has no kind")
            continue
        kind = ev["kind"]
        if kind == "drain":
            if ev.get("seq") != seq:
                errors.append(
                    f"{name}: drain seq {ev.get('seq')} out of order "
                    f"(expected {seq})"
                )
            payload = {k: ev.get(k) for k in _DRAIN_PAYLOAD_FIELDS}
            chain = _fold(chain, payload)
            if ev.get("chain") != chain:
                errors.append(
                    f"{name}: digest chain broken at drain seq {seq} "
                    f"(recorded {str(ev.get('chain'))[:16]}..., "
                    f"recomputed {chain[:16]}...)"
                )
                chain = ev.get("chain") or chain  # localize, don't cascade
            src = acc.setdefault(str(ev.get("source")), {})
            for k, d in (ev.get("delta") or {}).items():
                src[k] = src.get(k, 0) + int(d)
            seq += 1
        elif kind == "snapshot":
            if ev.get("chain") != chain:
                errors.append(
                    f"{name}: snapshot at seq {ev.get('seq')} chain "
                    "does not anchor to its drain"
                )
            for s, counters in (ev.get("counters") or {}).items():
                got = acc.get(s, {})
                bad = [
                    k
                    for k, v in counters.items()
                    if isinstance(v, int) and got.get(k, 0) != v
                ]
                if bad:
                    errors.append(
                        f"{name}: snapshot at seq {ev.get('seq')} "
                        f"source {s}: counters {sorted(bad)} do not "
                        "equal the accumulated drain deltas"
                    )
        elif kind == "session_end":
            end = ev
    if end is None:
        if not allow_truncated:
            errors.append(
                f"{name}: truncated recording — no session_end after "
                f"{seq} drains (killed run?)"
            )
    else:
        if end.get("drains") != seq:
            errors.append(
                f"{name}: session_end drains {end.get('drains')} != "
                f"{seq} drain events"
            )
        if end.get("chain") != chain:
            errors.append(f"{name}: session_end chain mismatch")
    return errors


# -- replay ---------------------------------------------------------------

#: geometry fields that must agree between the recording and the
#: replay-built engine for the verdict to even be attempted.  The
#: resolved storage dtype (``kv_dtype_name``) is deliberately absent:
#: a CPU replay of a bf16 card recording is legitimate — the digest
#: chain, not the geometry gate, is what judges it.
_GEOMETRY_MATCH_FIELDS = (
    "num_slots",
    "max_len",
    "eos_token",
    "top_k",
    "top_p",
    "prefill_buckets",
    "decode_chunk",
    "decode_mode",
    "ring_capacity",
    "page_size",
    "num_pages",
    "kv_dtype",
    "chunked_prefill",
    "speculate",
    "spec_ngram",
    "prefix_cache",
    "role",
)

#: recorded-geometry fields that map straight back onto ``ServeEngine``
#: constructor kwargs (the default reconstruction path when no
#: ``engine_factory`` is given)
_GEOMETRY_CTOR_FIELDS = (
    "num_slots",
    "max_len",
    "eos_token",
    "top_k",
    "top_p",
    "decode_chunk",
    "decode_mode",
    "page_size",
    "num_pages",
    "kv_dtype",
    "chunked_prefill",
    "speculate",
    "spec_ngram",
    "prefix_cache",
)


def geometry_kwargs(geom: dict) -> dict:
    """``ServeEngine`` constructor kwargs from one recorded geometry
    event — the reconstruction half of the black box."""
    kw = {k: geom[k] for k in _GEOMETRY_CTOR_FIELDS if geom.get(k) is not None}
    if geom.get("prefill_buckets"):
        kw["prefill_buckets"] = tuple(geom["prefill_buckets"])
    if geom.get("decode_mode") == "persistent" and geom.get("ring_capacity"):
        kw["ring_capacity"] = geom["ring_capacity"]
    if "prefix_cache" in geom:
        kw["prefix_cache"] = bool(geom["prefix_cache"])
    return kw


def signals_from_session(events: List[dict]) -> List[dict]:
    """The recorded live autoscale signal vectors, in controller-tick
    order — feed them to ``serve.autoscale.replay_signal`` and the
    decision stream replays bit-identically (the signal is the
    controller's entire outside world)."""
    return [
        dict(e["signal"])
        for e in events
        if e.get("kind") == "ctrl_tick" and e.get("signal") is not None
    ]


def rechain(events: List[dict]) -> List[dict]:
    """Recompute the digest chain (and snapshot anchors/counters) from
    the drain payloads — the fault-injection helper: perturb a counter
    delta or a token stream in a copied recording, ``rechain`` it, and
    the result is exactly the internally-consistent recording a live
    run that actually diverged there would have written."""
    out = []
    chain = hashlib.sha256(SESSION_SCHEMA.encode()).hexdigest()
    acc: Dict[str, Dict[str, int]] = {}
    for ev in events:
        ev = dict(ev)
        if ev.get("kind") == "drain":
            chain = _fold(chain, _drain_key(ev))
            ev["chain"] = chain
            src = acc.setdefault(str(ev.get("source")), {})
            for k, d in (ev.get("delta") or {}).items():
                src[k] = src.get(k, 0) + int(d)
        elif ev.get("kind") == "snapshot":
            ev["chain"] = chain
            ev["counters"] = {s: dict(c) for s, c in sorted(acc.items())}
        elif ev.get("kind") == "session_end":
            ev["chain"] = chain
            ev["counters"] = {s: dict(c) for s, c in sorted(acc.items())}
        out.append(ev)
    return out


def _strip_geometry(ev: dict) -> dict:
    return {k: ev.get(k) for k in _GEOMETRY_MATCH_FIELDS}


def _drain_key(ev: dict) -> dict:
    return {k: ev.get(k) for k in _DRAIN_PAYLOAD_FIELDS}


def _divergence_detail(a: dict, b: dict) -> dict:
    """Name exactly what differs between one recorded and one replayed
    drain: the counters, the request ids, the tick."""
    da, db = a.get("delta") or {}, b.get("delta") or {}
    ta, tb = a.get("tokens") or {}, b.get("tokens") or {}
    counters = sorted(
        k for k in set(da) | set(db) if da.get(k) != db.get(k)
    )
    rids = sorted(
        int(r) for r in set(ta) | set(tb) if ta.get(r) != tb.get(r)
    )
    return {
        "seq": a.get("seq"),
        "tick": a.get("tick"),
        "source": a.get("source"),
        "counters": counters,
        "rids": rids,
        "recorded_delta": da,
        "replayed_delta": db,
        "recorded_tokens": {r: ta[r] for r in map(str, rids) if r in ta},
        "replayed_tokens": {r: tb[r] for r in map(str, rids) if r in tb},
    }


def _bisect_divergence(
    rec_events: List[dict], rep_events: List[dict]
) -> Optional[dict]:
    """First divergent drain, located via the periodic snapshots: the
    snapshot chains bracket the window (everything up to the last
    matching snapshot is proven equal without touching its drains),
    then the drains inside the bracket are compared event-by-event."""
    rec_drains = [e for e in rec_events if e.get("kind") == "drain"]
    rep_drains = [e for e in rep_events if e.get("kind") == "drain"]
    rec_snaps = {
        e["seq"]: e for e in rec_events if e.get("kind") == "snapshot"
    }
    rep_snaps = {
        e["seq"]: e for e in rep_events if e.get("kind") == "snapshot"
    }
    n = min(len(rec_drains), len(rep_drains))
    lo = 0
    for seq in sorted(set(rec_snaps) & set(rep_snaps)):
        if seq >= n:
            break
        if rec_snaps[seq].get("chain") == rep_snaps[seq].get("chain"):
            lo = seq + 1  # proven-equal prefix: skip its drains
        else:
            break
    for i in range(lo, n):
        a, b = rec_drains[i], rep_drains[i]
        if a.get("chain") != b.get("chain") or _drain_key(a) != _drain_key(b):
            return _divergence_detail(a, b)
    return None


def replay_session(
    recording: Union[str, List[dict]],
    *,
    engine_factory=None,
    fleet_factory=None,
    model_factory=None,
) -> dict:
    """Re-drive one recording and return the verdict.

    Reconstruction: a fleet recording needs ``fleet_factory(recorder)``
    (returning ``(fleet, controller_engine_factory)`` or just the
    fleet) or ``engine_factory(recorder, geom)`` per replica; a
    single-engine recording takes ``engine_factory(recorder, geom)``
    or, with neither, ``model_factory()`` + the recorded geometry
    through :func:`geometry_kwargs`.  Replay runs on the device the
    factories' model is on (the port's models default to the card; the
    tests build theirs on the CPU), and the verdict reports, in order
    of severity: ``geometry_mismatch`` (the rebuilt engines do not
    match the recorded geometry; fields named), ``divergent`` (chains
    split; first drain seq, tick, counters, and request ids named),
    ``truncated_match`` / ``match``."""
    from ..serve.engine import ServeEngine  # deferred: obs <-> serve

    events, notes = load_session(recording)
    truncated = not any(e.get("kind") == "session_end" for e in events)
    head = next(
        (e for e in events if e.get("kind") == "session_header"), {}
    )
    geoms = [e for e in events if e.get("kind") == "geometry"]
    fleet_ev = next((e for e in events if e.get("kind") == "fleet"), None)
    auto_ev = next(
        (e for e in events if e.get("kind") == "autoscale"), None
    )
    rep_rec = SessionRecorder(
        None,
        snapshot_every=int(head.get("snapshot_every", 8)),
        enabled=True,
        stamp=False,
    )
    fleet = None
    engine = None
    ctrl = None
    if fleet_ev is not None:
        if fleet_factory is not None:
            built = fleet_factory(rep_rec)
            fleet, ctrl_engine_factory = (
                built if isinstance(built, tuple) else (built, None)
            )
        elif engine_factory is not None:
            from ..serve.fleet import ServeFleet

            roles = list(fleet_ev.get("roles") or [])
            # the initially-built replicas only: autoscale-added ones
            # are rebuilt live by the replayed controller
            first = [g for g in geoms if not g.get("added")]
            engines = [
                engine_factory(None, g) for g in first[: len(roles)]
            ]
            fleet = ServeFleet(
                engines,
                policy=fleet_ev.get("policy", "affinity"),
                disaggregate=bool(fleet_ev.get("disaggregate")),
                roles=roles or None,
                record=rep_rec,
            )
            ctrl_engine_factory = lambda role="serve": engine_factory(  # noqa: E731
                None, dict(first[0], role=role)
            )
        else:
            raise ValueError(
                "a fleet recording needs fleet_factory= or "
                "engine_factory= to reconstruct its replicas"
            )
        if auto_ev is not None:
            from ..serve.autoscale import (
                AutoscaleController,
                ScalingPolicy,
                replay_signal,
            )

            pol = ScalingPolicy.from_json(auto_ev.get("policy") or "default")
            ctrl = AutoscaleController(
                fleet,
                pol,
                engine_factory=ctrl_engine_factory,
                signal_fn=replay_signal(signals_from_session(events)),
                flight=False,
            )
    else:
        geom = geoms[0] if geoms else {}
        if engine_factory is not None:
            engine = engine_factory(rep_rec, geom)
            if getattr(engine, "recorder", None) is not rep_rec:
                engine.attach_recorder(rep_rec)
        elif model_factory is not None:
            engine = ServeEngine(
                model_factory(), record=rep_rec, **geometry_kwargs(geom)
            )
        else:
            raise ValueError(
                "replay needs engine_factory= or model_factory= to "
                "reconstruct the engine"
            )

    verdict: dict = {
        "schema": "tdx-session-verdict-v1",
        "truncated": truncated,
        "notes": notes,
    }
    # geometry gate: the rebuilt engines must BE what was recorded —
    # a mismatch here is its own named verdict, never a digest diff
    rec_geo = [_strip_geometry(g) for g in geoms if not g.get("added")]
    rep_geo = [
        _strip_geometry(g)
        for g in rep_rec.events
        if g.get("kind") == "geometry"
    ]
    if rec_geo and rep_geo[: len(rec_geo)] != rec_geo:
        fields = []
        for a, b in zip(rec_geo, rep_geo):
            fields += [
                k for k in _GEOMETRY_MATCH_FIELDS if a.get(k) != b.get(k)
            ]
        verdict.update(
            match=False,
            verdict="geometry_mismatch",
            geometry_fields=sorted(set(fields)),
            drains_recorded=sum(
                1 for e in events if e.get("kind") == "drain"
            ),
            drains_replayed=0,
        )
        return verdict

    # re-drive the exact stream
    import numpy as np

    target = fleet if fleet is not None else engine
    for ev in events:
        kind = ev.get("kind")
        if kind == "submit":
            target.submit(
                np.asarray(ev["prompt"], np.int32),
                max_new_tokens=int(ev["max_new_tokens"]),
                temperature=float(ev.get("temperature", 0.0)),
                seed=int(ev.get("seed", 0)),
                deadline_s=ev.get("deadline_s"),
            )
        elif kind == "step":
            engine.step()
        elif kind == "step_prefill":
            engine.step_prefill()
        elif kind == "tick":
            fleet.step()
        elif kind == "ctrl_tick" and ctrl is not None:
            ctrl.tick()
        elif kind == "engine_drain":
            engine.drain(complete=bool(ev.get("complete")))

    rec_drains = [e for e in events if e.get("kind") == "drain"]
    rep_drains = [
        e for e in rep_rec.events if e.get("kind") == "drain"
    ]
    verdict["drains_recorded"] = len(rec_drains)
    verdict["drains_replayed"] = len(rep_drains)
    verdict["chain_recorded"] = (
        rec_drains[-1]["chain"] if rec_drains else None
    )
    verdict["chain_replayed"] = (
        rep_drains[-1]["chain"] if rep_drains else None
    )
    div = _bisect_divergence(events, rep_rec.events)
    if div is None and not truncated and len(rep_drains) != len(rec_drains):
        # chains agree on the common prefix but one side kept going —
        # a complete recording must match drain-for-drain
        div = {
            "seq": min(len(rec_drains), len(rep_drains)),
            "tick": None,
            "source": None,
            "counters": [],
            "rids": [],
            "recorded_delta": None,
            "replayed_delta": None,
        }
    if div is not None:
        verdict.update(
            match=False,
            verdict="divergent",
            first_divergence=div,
        )
    elif truncated:
        verdict.update(
            match=True,
            verdict="truncated_match",
            truncation={
                "seq": len(rec_drains),
                "drains_beyond_recording": max(
                    0, len(rep_drains) - len(rec_drains)
                ),
            },
        )
    else:
        verdict.update(match=True, verdict="match")

    # autoscale decision stream: recorded vs replayed (tick, action,
    # replica) — the satellite-2 bridge's pin
    rec_ct = [
        (e.get("tick"), e.get("action"), e.get("replica"))
        for e in events
        if e.get("kind") == "ctrl_tick"
    ]
    if rec_ct:
        rep_ct = [
            (e.get("tick"), e.get("action"), e.get("replica"))
            for e in rep_rec.events
            if e.get("kind") == "ctrl_tick"
        ]
        verdict["autoscale"] = {
            "ticks": len(rec_ct),
            "match": rep_ct[: len(rec_ct)] == rec_ct,
        }
        if not verdict["autoscale"]["match"]:
            verdict["match"] = False
            verdict["verdict"] = "divergent"
            if "first_divergence" not in verdict:
                bad = next(
                    i
                    for i, (a, b) in enumerate(zip(rec_ct, rep_ct))
                    if a != b
                )
                verdict["first_divergence"] = {
                    "seq": None,
                    "tick": rec_ct[bad][0],
                    "source": "autoscale",
                    "counters": [],
                    "rids": [],
                    "recorded_delta": {"action": rec_ct[bad][1]},
                    "replayed_delta": {"action": rep_ct[bad][1]},
                }
    return verdict
