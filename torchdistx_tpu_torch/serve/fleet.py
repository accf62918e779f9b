"""Serving fleet: N ``ServeEngine`` replicas behind a prefix-aware router,
counterpart of ``torchdistx_tpu/serve/fleet.py`` (copied: the fleet is
host code over the port's engines).

One engine is one failure domain and one cache.  :class:`ServeFleet` is
the inter-engine layer: a host-side router that decides WHERE each
request runs, never what it computes, so greedy streams through the
fleet stay bit-identical to a single engine of the same geometry serving
the same requests.

Routing (:class:`AffinityPolicy`, the default) is radix-trie prefix
affinity: every replica's :class:`~.prefix_cache.RadixPrefixIndex` is
probed with the read-only ``match_len`` API (no incref, no LRU
perturbation — the losers' eviction state stays untouched) and the
request goes where the cache is warmest: shared-prefix workloads
cluster.  Ties break on live load signals the
stack already emits: ``slots_free``/``pages_free`` occupancy gauges,
queue depth, the ``capacity_plan`` fit verdict, and the
``admissions_rejected_hbm`` / ``admissions_rejected_pages`` rejection
counters as per-tick windowed deltas (one early gating never biases
ties for the rest of the process).  A warm replica that is page- or HBM-gated is skipped — cache
affinity must never route a request into an admission stall when a cold
replica has headroom.  :class:`LeastLoadedPolicy` and
:class:`RoundRobinPolicy` make the A/B testable; any object with ``route(prompt, max_new_tokens, replicas)``
plugs in.

Drain and scale are first-class fleet events: ``fleet.remove(rid)``
drains the replica and hands every unfinished request to a survivor via
``ServeEngine.migrate_to`` (zero drops, handles stay valid);
``fleet.add(engine)`` warms a new replica into rotation.

Disaggregation (``ServeFleet(disaggregate=True)``) dedicates replicas to
prefill vs decode roles: prefill engines run ``step_prefill`` ticks
(admission + prefill dispatches, never a decode), and each finished
prefill's KV pages are handed to a decode engine via
``ServeEngine.handoff_to`` (on one card a device-to-device copy, priced
by the ring model's closed form at zero wire).  Prefill load can then
never block decode latency ACROSS engines, the way chunked prefill
prevents it within one.

Observability: ``fleet.collector()`` registers the whole fleet through
the existing ``obs.metrics`` Prometheus registry — one scrape surface:
aggregated engine counters as ``tdx_serve_*_total`` (continuous with a
single-engine deployment) plus ``tdx_fleet_*`` gauges labeled by
replica.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Iterable, List, Optional, Sequence, Union

from ..obs.blackbox import resolve_record as _resolve_record
from .engine import ServeEngine
from .scheduler import Request, RequestHandle, RequestResult

__all__ = [
    "ServeFleet",
    "AffinityPolicy",
    "LeastLoadedPolicy",
    "RoundRobinPolicy",
    "replica_signals",
]

_ROLES = ("serve", "prefill", "decode")


def replica_signals(engine: ServeEngine) -> dict:
    """One replica's live router-facing load signals, read straight off
    the engine (every field also reaches the metrics surface:
    ``slots_free``/``pages_free`` are first-class ``ServeMetrics``
    gauges, the rejection counts are counters).  ``pages_free`` is None
    for slab engines; ``hbm_fits`` is None when no ``hbm_budget`` is
    configured (the plan then gates nothing)."""
    sig = {
        "slots_free": engine.scheduler.free_slot_count,
        "queue_depth": engine.scheduler.queue_depth,
        "active_slots": len(engine.scheduler.running),
        "pages_free": engine.pool.free_count if engine.paged else None,
        "hbm_fits": (
            engine.memory_plan()["fits"]
            if engine.hbm_budget is not None
            else None
        ),
        "rejected_hbm": engine.metrics.counters["admissions_rejected_hbm"],
        "rejected_pages": engine.metrics.counters[
            "admissions_rejected_pages"
        ],
        "draining": engine._draining,
    }
    return sig


def _load_key(rep: "_Replica") -> tuple:
    """Headroom ordering (higher = roomier), deterministic: capacity-plan
    fit first (a gated replica only wins when everyone is gated), then
    free slots net of queue, free pages, fewest recent rejections
    (``_Replica.recent_rejections`` — gate refusals since the last
    fleet tick, a rolling window, NOT the lifetime
    ``admissions_rejected_*`` totals), and finally lowest replica id so
    ties never flap."""
    s = replica_signals(rep.engine)
    pages = s["pages_free"] if s["pages_free"] is not None else float("inf")
    return (
        0 if s["hbm_fits"] is False else 1,
        s["slots_free"] - s["queue_depth"],
        pages,
        -rep.recent_rejections(),
        -rep.rid,
    )


def _skip_reason(rep: "_Replica", prompt, max_new_tokens: int):
    """Why this replica's admission gate would plausibly stall the
    request, or None when it would take it.  A router-side heuristic
    mirroring the engine's gate order (the gate itself stays the
    enforcement), with the refusal NAMED the way the engine's gate names
    its lifecycle events: ``"draining"`` (will never admit again),
    ``"hbm_budget"`` (capacity plan already over budget), or ``"pages"``
    (not enough free pages for the footprint net of the prefix hit).
    The name lands verbatim in the request's ``route_skipped`` lifecycle
    events, so a trace answers "why NOT replica 2" as well as "why
    replica 1"."""
    e = rep.engine
    if e._draining:
        return "draining"
    if e.hbm_budget is not None and e.memory_plan()["fits"] is False:
        return "hbm_budget"
    if e.paged and prompt is not None:
        ps = e.page_size
        need = -(-(len(prompt) + int(max_new_tokens)) // ps)
        if e.prefix_index is not None:
            need -= e.prefix_index.match_len(prompt) // ps
        if need > e.pool.free_count:
            return "pages"
    return None


def _admittable(rep: "_Replica", prompt, max_new_tokens: int) -> bool:
    """Would this replica's admission gate plausibly take the request
    without stalling?  (``_skip_reason`` with the reason discarded.)"""
    return _skip_reason(rep, prompt, max_new_tokens) is None


def _json_key(key: tuple) -> list:
    """``_load_key`` as JSON-able event data: the slab engines'
    ``float("inf")`` pages sentinel becomes None (JSON has no Inf)."""
    return [
        None
        if isinstance(k, float) and (k != k or abs(k) == float("inf"))
        else k
        for k in key
    ]


class RoundRobinPolicy:
    """Cycle over replicas in id order — the affinity A/B's baseline
    (and the degenerate-but-fair fallback for cache-free workloads)."""

    name = "round-robin"

    def __init__(self):
        self._next = 0

    def route(self, prompt, max_new_tokens, replicas):
        rep = replicas[self._next % len(replicas)]
        self._next += 1
        return rep


class LeastLoadedPolicy:
    """Send every request to the roomiest replica (``_load_key``):
    capacity-plan fit, then free slots net of queue, free pages, and
    recent gate rejections."""

    name = "least-loaded"

    def route(self, prompt, max_new_tokens, replicas):
        return max(replicas, key=_load_key)


class AffinityPolicy:
    """Prefix-affinity routing: probe every replica's radix index with
    the read-only ``match_len`` and send the request where the cached
    prefix is longest, tie-broken by ``_load_key`` headroom.  Replicas
    whose admission gate would stall the request (page/HBM pressure)
    are excluded first — warmth never beats admissibility — falling
    back to pure least-loaded when every replica is gated."""

    name = "affinity"

    def route(self, prompt, max_new_tokens, replicas):
        open_reps = [
            r for r in replicas if _admittable(r, prompt, max_new_tokens)
        ]
        if not open_reps:
            return max(replicas, key=_load_key)

        def warmth(rep):
            idx = rep.engine.prefix_index
            return idx.match_len(prompt) if idx is not None else 0

        return max(open_reps, key=lambda r: (warmth(r),) + _load_key(r))


class _Replica:
    __slots__ = ("rid", "engine", "role", "routed", "_rej_seen")

    def __init__(self, rid: int, engine: ServeEngine, role: str):
        self.rid = rid
        self.engine = engine
        self.role = role
        self.routed = 0  # requests this router sent here
        # rejection-counter snapshot for the windowed tie-break: taken
        # at construction (an engine's pre-fleet history never biases
        # routing) and rolled forward at every fleet tick
        self._rej_seen = self._rej_total()

    def _rej_total(self) -> int:
        c = self.engine.metrics.counters
        return (
            c["admissions_rejected_hbm"] + c["admissions_rejected_pages"]
        )

    def recent_rejections(self) -> int:
        """Gate rejections since the last fleet tick — the windowed
        delta ``_load_key`` ties break on.  Lifetime totals would let
        one early gating disadvantage a replica in routing ties for
        the rest of the process."""
        return self._rej_total() - self._rej_seen

    def snapshot_rejections(self) -> None:
        self._rej_seen = self._rej_total()


class ServeFleet:
    """N replicas, one router, one metrics surface (module docstring).

    ``engines`` all serve the same model/params — the fleet only decides
    placement, so identical params are what make fleet streams
    bit-identical to a single engine's.  ``policy`` is ``"affinity"``
    (default), ``"least-loaded"``, ``"round-robin"``, or any object with
    ``route(prompt, max_new_tokens, replicas)``.  With
    ``disaggregate=True``, ``roles`` assigns ``"prefill"``/``"decode"``
    per engine (default: first half prefill) — prefill engines must be
    chunked-mode (``step_prefill``) and KV-compatible with every decode
    engine (same paged-ness, ``max_len``, ``page_size``); decode engines
    may run the persistent mode.  ``record=`` wires the session black box
    (:meth:`attach_recorder`)."""

    def __init__(
        self,
        engines: Sequence[ServeEngine],
        *,
        policy: Union[str, Any] = "affinity",
        disaggregate: bool = False,
        roles: Optional[Sequence[str]] = None,
        record: Any = None,
    ):
        engines = list(engines)
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        self.disaggregate = bool(disaggregate)
        if roles is None:
            if self.disaggregate:
                if len(engines) < 2:
                    raise ValueError(
                        "disaggregate=True needs at least two engines "
                        "(one prefill + one decode)"
                    )
                n_p = max(1, len(engines) // 2)
                roles = ["prefill"] * n_p + ["decode"] * (
                    len(engines) - n_p
                )
            else:
                roles = ["serve"] * len(engines)
        roles = [str(r) for r in roles]
        if len(roles) != len(engines):
            raise ValueError(
                f"{len(roles)} roles for {len(engines)} engines"
            )
        bad = set(roles) - set(_ROLES)
        if bad:
            raise ValueError(f"unknown roles {sorted(bad)}; use {_ROLES}")
        if self.disaggregate:
            if "prefill" not in roles or "decode" not in roles:
                raise ValueError(
                    "disaggregate=True needs at least one 'prefill' and "
                    "one 'decode' role"
                )
            if "serve" in roles:
                raise ValueError(
                    "disaggregate=True engines must be 'prefill' or "
                    "'decode'"
                )
        elif set(roles) != {"serve"}:
            raise ValueError(
                "prefill/decode roles require disaggregate=True"
            )
        self._rids = itertools.count()
        self._replicas: List[_Replica] = [
            _Replica(next(self._rids), e, role)
            for e, role in zip(engines, roles)
        ]
        if self.disaggregate:
            for rep in self._by_role("prefill"):
                self._check_compat(rep)
        self.policy = self._resolve_policy(policy)
        #: fleet-level lifecycle event log: (name, monotonic_ts, data) —
        #: routed/handoff/remove/add/role/scale, the fleet analog of the
        #: request event log
        self.events: List[tuple] = []
        #: monotonic tick counter: incremented at the START of every
        #: :meth:`step`, threaded into every fleet/request event's data
        #: (``"tick"``) so an event correlates to the exact tick whose
        #: windowed state (rejection tie-breaks, autoscale sustain runs)
        #: it was decided under.  Submissions between step N and N+1
        #: carry tick N; tick 0 is "before the first step".
        self.tick: int = 0
        # counters of replicas removed from rotation: a Prometheus
        # counter must never decrease, so a retired replica's totals
        # (its migrations out included) stay in the fleet aggregate
        self._retired_counters: dict = {}
        # finished requests of removed replicas, as (replica_rid, role,
        # request): remove() drops the _Replica (and with it the
        # engine's _finished history), but a merged fleet trace must
        # still show requests that FINISHED on a replica later scaled
        # away — dump_trace() merges these like any live replica's
        self._retired_finished: List[tuple] = []
        # the session black box: the FLEET is the caller of record: it records
        # submits and ticks; replicas add their geometry and their drain
        # folds under their replica name
        self.recorder = None
        self._bb_on = False
        rec = _resolve_record(record)
        if rec is not None:
            self.attach_recorder(rec)

    def attach_recorder(self, recorder) -> None:
        """Wire a :class:`~torchdistx_tpu_torch.obs.blackbox.SessionRecorder`
        across the fleet: one fleet-composition event, one geometry event
        per replica, and every replica folding its drains under its
        ``r<rid>`` source into the one session chain (replicas step one
        after another, so the fold order is deterministic)."""
        self.recorder = recorder
        self._bb_on = bool(getattr(recorder, "enabled", False))
        recorder.record(
            "fleet",
            replicas=[r.rid for r in self._replicas],
            roles=[r.role for r in self._replicas],
            policy=getattr(self.policy, "name", "custom"),
            disaggregate=self.disaggregate,
        )
        for rep in self._replicas:
            rep.engine.attach_recorder(recorder, source=f"r{rep.rid}", driver=False,
                                       geometry_extra={"role": rep.role})

    # -- rotation ---------------------------------------------------------

    @property
    def replicas(self) -> List[_Replica]:
        """Live rotation snapshot (stable ``rid`` per replica — ids are
        never reused after ``remove``)."""
        return list(self._replicas)

    def _by_role(self, role: str) -> List[_Replica]:
        return [r for r in self._replicas if r.role == role]

    def _get(self, rid: int) -> _Replica:
        for rep in self._replicas:
            if rep.rid == rid:
                return rep
        raise KeyError(f"no replica {rid} in the fleet")

    @staticmethod
    def _resolve_policy(policy):
        if isinstance(policy, str):
            named = {
                "affinity": AffinityPolicy,
                "least-loaded": LeastLoadedPolicy,
                "round-robin": RoundRobinPolicy,
            }
            if policy not in named:
                raise ValueError(
                    f"unknown policy {policy!r}; use {sorted(named)} or "
                    "pass a policy object"
                )
            return named[policy]()
        if not callable(getattr(policy, "route", None)):
            raise TypeError(
                "a policy object must expose route(prompt, "
                "max_new_tokens, replicas)"
            )
        return policy

    def _check_compat(self, prefill_rep: _Replica) -> None:
        """Constructor/add-time validation of a prefill replica against
        every decode replica: the per-request ``handoff_to`` checks
        again, but a fleet that can never hand off should fail at build
        time, not mid-workload."""
        e = prefill_rep.engine
        if e.decode_mode != "chunked":
            raise ValueError(
                f"prefill replica {prefill_rep.rid} must be chunked-mode "
                "(step_prefill contract)"
            )
        for dec in self._by_role("decode"):
            d = dec.engine
            if e.paged != d.paged or e.max_len != d.max_len or (
                e.paged and e.page_size != d.page_size
            ):
                raise ValueError(
                    f"prefill replica {prefill_rep.rid} KV geometry "
                    f"(paged={e.paged}, max_len={e.max_len}, page_size="
                    f"{e.page_size}) is incompatible with decode replica "
                    f"{dec.rid} (paged={d.paged}, max_len={d.max_len}, "
                    f"page_size={d.page_size})"
                )

    # -- routing ----------------------------------------------------------

    def _route_candidates(self) -> List[_Replica]:
        role = "prefill" if self.disaggregate else "serve"
        cands = [
            r for r in self._by_role(role) if not r.engine._draining
        ]
        if not cands:
            raise RuntimeError(
                f"no live {role} replica to route to — the fleet has "
                "drained out"
            )
        return cands

    def submit(
        self,
        prompt,
        *,
        max_new_tokens: int,
        temperature: float = 0.0,
        seed: int = 0,
        deadline_s: Optional[float] = None,
    ) -> RequestHandle:
        """Route one request (policy decides the replica) and submit it
        there; the returned handle is engine-agnostic and stays valid
        across handoffs and ``remove`` migrations.

        The decision is never discarded: the full candidate scoring —
        per-replica ``match_len``, the ``_load_key`` headroom tie-break
        values, named skip reasons — is recorded BEFORE routing (probing
        is read-only, so scoring first keeps the policy's view and the
        record identical), then lands in the request's own lifecycle
        events as one ``("routed", ...)`` with the scores plus a
        ``("route_skipped", ...)`` per gated replica, and in
        ``fleet.events``.  Scoring covers every role replica — draining
        ones included, so the record answers "why not replica 2" even
        for replicas the policy never sees — while the policy still
        routes over the live candidates only."""
        cands = self._route_candidates()
        scored, skipped = [], []
        for r in self._by_role("prefill" if self.disaggregate else "serve"):
            why = _skip_reason(r, prompt, max_new_tokens)
            idx = r.engine.prefix_index
            scored.append(
                {
                    "replica": r.rid,
                    "match_len": (
                        int(idx.match_len(prompt)) if idx is not None else 0
                    ),
                    "headroom": _json_key(_load_key(r)),
                    "skip": why,
                }
            )
            if why is not None:
                skipped.append((r.rid, why))
        rep = self.policy.route(prompt, max_new_tokens, cands)
        handle = rep.engine.submit(
            prompt,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            seed=seed,
            deadline_s=deadline_s,
        )
        rep.routed += 1
        now = time.monotonic()
        req = handle._request
        policy = getattr(self.policy, "name", "custom")
        for rid_skipped, why in skipped:
            req.record_event(
                "route_skipped", ts=now, rid=rid_skipped, why=why,
                tick=self.tick,
            )
        req.record_event(
            "routed", ts=now, replica=rep.rid, policy=policy,
            candidates=scored, tick=self.tick,
        )
        self.events.append(
            ("routed", now,
             {"rid": handle.rid, "trace_id": handle.trace_id,
              "replica": rep.rid, "policy": policy, "tick": self.tick,
              "candidates": scored})
        )
        if self._bb_on:
            # a fleet-level event: replay submits here and routes again;
            # the routed replica is attribution, never replayed
            self.recorder.record_submit("fleet", req, routed=rep.rid)
        return handle

    # -- stepping ---------------------------------------------------------

    def step(self) -> int:
        """One fleet tick.  Aggregated mode: every replica takes one
        engine ``step()``.  Disaggregated: prefill replicas take a
        ``step_prefill`` tick, finished prefills hand their KV to decode
        replicas (``handoff_to``; a request that cannot be placed this
        tick stays parked and retries next tick — back-pressure, never a
        drop — but one that could NEVER be placed raises instead of
        spinning, see ``_check_ever_placeable``), then decode replicas
        take their decode ``step()``.  Returns total unfinished
        requests across the fleet."""
        self.tick += 1
        if self._bb_on:
            self.recorder.tick = self.tick
            self.recorder.record("tick", tick=self.tick)
        for rep in self._replicas:
            rep.snapshot_rejections()  # roll the tie-break window
        unfinished = 0
        if self.disaggregate:
            for rep in self._by_role("prefill"):
                rep.engine.step_prefill()
            self._dispatch_handoffs()
            for rep in self._by_role("decode"):
                unfinished += rep.engine.step()
            for rep in self._by_role("prefill"):
                sch = rep.engine.scheduler
                unfinished += sch.queue_depth + len(sch.running)
        else:
            for rep in self._replicas:
                unfinished += rep.engine.step()
        return unfinished

    def _dispatch_handoffs(self) -> None:
        decodes = self._by_role("decode")
        for rep in self._by_role("prefill"):
            parked = sorted(
                rep.engine.scheduler.running,
                key=lambda r: (r.admitted_at or 0.0, r.rid),
            )
            for req in parked:
                tgt = self._pick_decode_target(req, decodes)
                if tgt is None:
                    # transient pressure (busy slots/pages) parks and
                    # retries; a request no decode replica could EVER
                    # hold must fail loudly instead
                    self._check_ever_placeable(req, decodes)
                    continue  # no decode headroom: retry next tick
                info = rep.engine.handoff_to(tgt.engine, req)
                self.events.append(
                    ("handoff", time.monotonic(),
                     {"rid": req.rid, "trace_id": req.trace_id,
                      "from": rep.rid, "to": tgt.rid,
                      "tick": self.tick, **info})
                )

    @staticmethod
    def _pick_decode_target(
        req: Request, decodes: List[_Replica]
    ) -> Optional[_Replica]:
        ok = [
            d
            for d in decodes
            if not d.engine._draining
            and d.engine.scheduler.free_slot_count > 0
            and (
                not d.engine.paged
                or len(req.pages or ()) <= d.engine.pool.free_count
            )
        ]
        return max(ok, key=_load_key) if ok else None

    @staticmethod
    def _check_ever_placeable(
        req: Request, decodes: List[_Replica]
    ) -> None:
        """Parking is for transient pressure only.  ``_check_compat``
        pins KV geometry at build time but not pool capacity, so a
        prefilled request whose page chain exceeds every decode pool's
        TOTAL capacity — or a fleet whose decode replicas are all
        draining — would otherwise park forever and spin ``run()``'s
        ``while step()`` loop with no error.  Raises on never-fits;
        returns silently when some live decode replica could hold the
        request once its slots/pages free up."""
        live = [
            d
            for d in decodes
            if not d.engine._draining and d.engine.num_slots > 0
        ]
        if not live:
            raise RuntimeError(
                f"prefilled request {req.rid} can never be handed off: "
                "every decode replica is draining — add a decode "
                "replica before draining the last one"
            )
        need = len(req.pages or ())
        if all(
            d.engine.paged and need > d.engine.pool.capacity
            for d in live
        ):
            cap = max(d.engine.pool.capacity for d in live)
            raise RuntimeError(
                f"prefilled request {req.rid} holds {need} KV page(s) "
                f"but the largest decode pool allocates only {cap} — "
                "it can never be handed off; size decode pools for the "
                "prefill role's admission footprint"
            )

    def run(
        self,
        requests: Iterable[Union[dict, Any]],
        *,
        max_new_tokens: int = 32,
    ) -> List[RequestResult]:
        """Batch-offline mode, mirroring ``ServeEngine.run``: route and
        submit everything, step the fleet until drained, return results
        in submission order."""
        handles = []
        for r in requests:
            if isinstance(r, dict):
                handles.append(self.submit(**r))
            else:
                handles.append(
                    self.submit(r, max_new_tokens=max_new_tokens)
                )
        while self.step():
            pass
        return [h.result() for h in handles]

    # -- scale events ------------------------------------------------------

    def remove(self, rid: int) -> dict:
        """Drain replica ``rid``, move every unfinished request it holds
        into same-role survivors with zero drops (handles stay valid),
        and drop it from rotation.  Fast path: a whole-engine
        ``migrate_to`` into the roomiest single survivor that passes its
        up-front validation.  When NO single survivor can absorb the
        victim (not enough free slots/pages anywhere alone), the
        requests scatter one at a time across all survivors instead —
        same KV move, same ``migration_*`` counters.  Returns the migration summary plus ``{"replica",
        "to"}`` (``to`` is one rid, or the list of rids a scatter
        landed on)."""
        rep = self._get(rid)
        pool = (
            self._by_role(rep.role)
            if self.disaggregate
            else list(self._replicas)
        )
        survivors = [r for r in pool if r is not rep]
        if not survivors:
            raise RuntimeError(
                f"cannot remove replica {rid}: it is the last "
                f"{rep.role!r} replica in the fleet"
            )
        rep.engine.drain()
        last_err: Optional[Exception] = None
        summary = None
        to: Any = None
        for cand in sorted(survivors, key=_load_key, reverse=True):
            try:
                summary = rep.engine.migrate_to(cand.engine)
                to = cand.rid
                break
            except RuntimeError as e:  # validated refusal: try the next
                last_err = e
        if summary is None:
            try:
                summary, to = self._scatter_migrate(rep, survivors)
            except RuntimeError as e:
                raise RuntimeError(
                    f"no survivor (alone or together) could absorb "
                    f"replica {rid}'s requests: {e}"
                ) from last_err
        for k, v in rep.engine.metrics.counters.items():
            self._retired_counters[k] = self._retired_counters.get(k, 0) + v
        self._retired_finished.extend(
            (rep.rid, rep.role, req)
            for req in rep.engine.finished_requests()
        )
        self._replicas.remove(rep)
        rep.engine._bb_on = False  # out of rotation: no more chain folds
        out = {**summary, "replica": rep.rid, "to": to, "tick": self.tick}
        self.events.append(("remove", time.monotonic(), out))
        return out

    def _scatter_migrate(self, rep: _Replica, survivors: List[_Replica]):
        """Per-request fallback for :meth:`remove`: distribute the
        drained replica's running requests (KV + host state via the
        engines' shared ``_move_running`` mechanics, roomiest compatible
        survivor first) and then its queue (rid-intact, FCFS order, to
        the roomiest survivor that can ever admit each request).  Books
        the same ``migration_*`` counters as a whole-engine
        ``migrate_to``.  Raises mid-way if some request
        fits nowhere — already-moved requests stay safely on their new
        engines, and EVERY un-placed request (the failing one plus the
        whole drained tail behind it) goes back into the (still
        drained, still in rotation) victim's queue, FCFS intact;
        nothing is ever dropped."""
        src = rep.engine
        now = time.monotonic()
        wire = n_coll = pages_moved = 0
        dest_rids: List[int] = []

        def compatible(s: _Replica) -> bool:
            e = s.engine
            return (
                not e._draining
                and e.paged == src.paged
                and e.max_len == src.max_len
                and (not src.paged or e.page_size == src.page_size)
            )

        running = sorted(
            src.scheduler.running,
            key=lambda r: (r.admitted_at or 0.0, r.rid),
        )
        n_running = len(running)
        for req in running:
            cands = [
                s
                for s in survivors
                if compatible(s)
                and s.engine.scheduler.free_slot_count > 0
                and (
                    not src.paged
                    or len(req.pages or ())
                    <= s.engine.pool.free_count
                )
            ]
            if not cands:
                raise RuntimeError(
                    f"running request {req.rid} fits no survivor "
                    "(slots/pages exhausted everywhere)"
                )
            dst = max(cands, key=_load_key)
            s_a, s_b, w, c, moved = src._move_running(dst.engine, req)
            req.record_event(
                "migrated", ts=now, from_slot=s_a, to_slot=s_b
            )
            src.metrics.count("requests_migrated_out")
            dst.engine.metrics.count("requests_migrated_in")
            # booked per move (not once at the end) so the counters stay
            # exact even when the queue loop below raises after some KV
            # has already moved
            src.metrics.count("migration_wire_bytes", w)
            wire += w
            n_coll += c
            pages_moved += moved
            dest_rids.append(dst.rid)
        queued = src.scheduler.drain_queue()
        for i, req in enumerate(queued):
            cands = [
                s
                for s in survivors
                if compatible(s)
                and req.prompt.size <= s.engine.prefill_buckets[-1]
                and (
                    not src.paged
                    or -(-req.cost // s.engine.page_size)
                    <= s.engine.pool.capacity
                )
            ]
            if not cands:
                # zero-drop failure path: the failing request AND the
                # whole un-placed tail behind it go back to the
                # victim's queue (FCFS intact) — only queued[:i] was
                # re-homed, so re-adopting queued[i:] loses nothing
                for back in queued[i:]:
                    src.scheduler.adopt_queued(back)
                raise RuntimeError(
                    f"queued request {req.rid} fits no survivor "
                    "(bucket/page capacity)"
                )
            dst = max(cands, key=_load_key)
            req.record_event("migrated", ts=now, queued=True)
            dst.engine.scheduler.adopt_queued(req)
            src.metrics.count("requests_migrated_out")
            dst.engine.metrics.count("requests_migrated_in")
            dest_rids.append(dst.rid)
        if src.paged and src.prefix_index is not None:
            src.prefix_index.evict(src.pool, src.pool.capacity)
        summary = {
            "migrated_running": n_running,
            "migrated_queued": len(queued),
            "pages_moved": pages_moved,
            "wire_bytes": int(wire),
            "collectives": int(n_coll),
            "tp_from": src.tp,
            "tp_to": None,
            "slots_from": src.num_slots,
            "slots_to": None,
            "scattered": True,
        }
        return summary, sorted(set(dest_rids))

    def add(
        self,
        engine: ServeEngine,
        *,
        role: Optional[str] = None,
        warm: bool = True,
    ) -> int:
        """Warm a new replica into rotation; returns its stable rid.
        ``role`` defaults to ``"serve"`` (aggregated) / ``"decode"``
        (disaggregated); disaggregated adds are KV-compat-validated the
        same way the constructor validates.

        ``warm=True`` (the default) runs throwaway requests through the
        engine's reachable programs BEFORE it enters rotation — every
        prefill bucket plus the decode path, each twice, so the
        warm-prefix paged program and (persistent mode, on the card) the
        captured CUDA graph are behind it — then evicts the warm-up's
        prefix-index entries, clears its finished history, and resets its
        metrics.  A scale-up therefore never serves its first routed
        request through a set-up stall, and ``num_compiled_programs``
        stays flat under routed traffic after the warm-up.  Engines that
        already hold work or history are never warmed (the elastic re-add
        path)."""
        if role is None:
            role = "decode" if self.disaggregate else "serve"
        if role not in _ROLES:
            raise ValueError(f"unknown role {role!r}; use {_ROLES}")
        if self.disaggregate and role == "serve":
            raise ValueError(
                "disaggregate=True replicas must be 'prefill' or 'decode'"
            )
        if not self.disaggregate and role != "serve":
            raise ValueError(
                "prefill/decode roles require disaggregate=True"
            )
        rep = _Replica(next(self._rids), engine, role)
        self._replicas.append(rep)
        if self.disaggregate:
            try:
                for pre in self._by_role("prefill"):
                    self._check_compat(pre)
            except ValueError:
                self._replicas.remove(rep)
                raise
        warm_info = self._warm_engine(engine) if warm else None
        rep.snapshot_rejections()  # warm-up gatings never bias routing
        if self.recorder is not None:
            # attached AFTER the warm-up, whose metrics reset would fold
            # negative deltas into the chain; ``added`` keeps replay's
            # initial build to the constructor's replicas (scale-ups are
            # rebuilt by the replayed controller)
            engine.attach_recorder(self.recorder, source=f"r{rep.rid}", driver=False,
                                   geometry_extra={"role": role, "added": True})
        self.events.append(
            ("add", time.monotonic(),
             {"replica": rep.rid, "role": role, "tick": self.tick,
              "warm": warm_info})
        )
        return rep.rid

    @staticmethod
    def _warm_engine(engine: ServeEngine) -> dict:
        """Warm a fresh engine (see :meth:`add`): two identical throwaway
        generations per prefill bucket — the second pass hits the
        warm-prefix program on paged engines — attributed to
        ``fleet/add_warmup`` in the program watcher, then every trace of
        the warm-up is scrubbed (prefix pages evicted, finished history
        cleared, metrics reset) so routed traffic sees a clean replica
        whose programs are already set up."""
        import numpy as np

        from ..obs.recompile import recompile_scope

        if engine.scheduler.has_work() or engine.finished_requests():
            return {"skipped": "engine has prior work/history"}
        before = engine.num_compiled_programs()
        new_tokens = max(1, min(2, engine.max_len - 1))
        prompts = [
            np.zeros(
                (max(1, min(bucket, engine.max_len - new_tokens)),),
                dtype=np.int32,
            )
            for bucket in engine.prefill_buckets
        ]
        with recompile_scope("fleet/add_warmup"):
            for _ in range(2):
                engine.run(
                    [
                        {
                            "prompt": p.copy(),
                            "max_new_tokens": new_tokens,
                        }
                        for p in prompts
                    ]
                )
        if engine.paged and engine.prefix_index is not None:
            engine.prefix_index.evict(engine.pool, engine.pool.capacity)
        engine._finished.clear()
        engine.reset_metrics()
        return {
            "programs_before": before,
            "programs_after": engine.num_compiled_programs(),
            "requests": 2 * len(prompts),
        }

    def reassign_role(self, rid: int, role: str) -> dict:
        """Re-roling: flip an IDLE replica between ``prefill`` and
        ``decode`` without rebuilding its engine — the autoscaler's cheap
        scale-up when the prefill side has headroom.  Requires a
        disaggregated fleet, an idle replica (no queued or running
        work), and that the flip leaves at least one replica in the old
        role; a flip INTO prefill re-validates KV compatibility the way
        the constructor does.  Emits a ``("role", ...)`` fleet event and
        returns its data."""
        if not self.disaggregate:
            raise RuntimeError(
                "reassign_role requires a disaggregated fleet"
            )
        if role not in ("prefill", "decode"):
            raise ValueError(
                f"unknown role {role!r}; use ('prefill', 'decode')"
            )
        rep = self._get(rid)
        if rep.role == role:
            raise ValueError(f"replica {rid} already has role {role!r}")
        if rep.engine.scheduler.has_work():
            raise RuntimeError(
                f"replica {rid} holds work — a re-role would strand its "
                "requests; drain first or pick an idle replica"
            )
        if len(self._by_role(rep.role)) <= 1:
            raise RuntimeError(
                f"cannot re-role replica {rid}: it is the last "
                f"{rep.role!r} replica in the fleet"
            )
        old = rep.role
        rep.role = role
        try:
            for pre in self._by_role("prefill"):
                self._check_compat(pre)
        except ValueError:
            rep.role = old
            raise
        data = {
            "replica": rep.rid,
            "from": old,
            "to": role,
            "tick": self.tick,
        }
        self.events.append(("role", time.monotonic(), data))
        return data

    # -- observability -----------------------------------------------------

    def finished_requests(self) -> List[Request]:
        """Every finished request across the fleet — live replicas plus
        replicas already retired by :meth:`remove` — in trace-id order.
        The per-request history surface the SLO engine (``obs/slo.py``)
        evaluates."""
        entries = [
            req
            for rep in self._replicas
            for req in rep.engine.finished_requests()
        ]
        entries.extend(req for _rid, _role, req in self._retired_finished)
        entries.sort(
            key=lambda r: (
                r.trace_id if r.trace_id is not None else int(r.rid)
            )
        )
        return entries

    def dump_trace(self, path: str) -> str:
        """Export ONE merged Perfetto trace for the whole fleet: the
        global tracer's host spans plus every replica's finished
        requests — live rotation and replicas since retired by
        :meth:`remove` — as per-replica process tracks on the shared
        monotonic timebase, each request one flow-linked causal chain
        (``route -> queued -> prefill -> handoff -> decode``) keyed on
        its process-unique ``trace_id`` (``obs.trace.
        fleet_request_trace_events``).  Open in ui.perfetto.dev; gate
        with ``scripts/check_obs_artifacts.py --slo``.  Fleet-level
        control-plane events — autoscale decisions, role flips, adds,
        removes — render as instants on a dedicated "fleet" track
        (``obs.trace.fleet_scale_trace_events``), correlated by the
        shared timebase and the ``tick`` each instant carries."""
        from ..obs.trace import (
            fleet_request_trace_events,
            fleet_scale_trace_events,
            get_tracer,
        )

        finished = []
        roles = {}
        for rep in self._replicas:
            roles[rep.rid] = rep.role
            for req in rep.engine.finished_requests():
                finished.append((rep.rid, rep.role, req))
        for rid, role, req in self._retired_finished:
            roles.setdefault(rid, role)
            finished.append((rid, role, req))
        return get_tracer().export(
            path,
            extra_events=fleet_request_trace_events(finished, roles=roles)
            + fleet_scale_trace_events(self.events),
        )

    # -- metrics ----------------------------------------------------------

    def metrics_json(self) -> dict:
        """The fleet's one structured snapshot, schema-shaped like
        ``ServeMetrics.to_json()`` (``counters``/``gauges``/
        ``histograms``/``derived`` — so one parser reads both) plus a ``fleet`` section: counters are summed
        across replicas, gauges aggregate the occupancy signals, and
        ``fleet.replicas`` carries the per-replica breakdown the
        Prometheus collector labels by ``replica``.  Counters include
        replicas already retired by :meth:`remove` — the aggregate is
        monotonic, like any honest Prometheus counter."""
        counters: dict = dict(self._retired_counters)
        per_replica = []
        paged_any = False
        for rep in self._replicas:
            for k, v in rep.engine.metrics.counters.items():
                counters[k] = counters.get(k, 0) + v
            sig = replica_signals(rep.engine)
            paged_any = paged_any or sig["pages_free"] is not None
            per_replica.append(
                {
                    "replica": rep.rid,
                    "role": rep.role,
                    "requests_routed": rep.routed,
                    **sig,
                }
            )
        gauges: dict = {
            "replicas": len(self._replicas),
            "slots_free": sum(r["slots_free"] for r in per_replica),
            "queue_depth": sum(r["queue_depth"] for r in per_replica),
            "active_slots": sum(r["active_slots"] for r in per_replica),
        }
        if paged_any:
            gauges["pages_free"] = sum(
                r["pages_free"] or 0 for r in per_replica
            )
        lookups = counters.get("prefix_lookup_tokens", 0)
        tokens = counters.get("tokens_generated", 0)
        derived = {
            "prefix_hit_rate": (
                counters.get("prefix_hit_tokens", 0) / lookups
                if lookups > 0
                else None
            ),
            "syncs_per_token": (
                counters.get("host_syncs", 0) / tokens
                if tokens > 0
                else None
            ),
        }
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {},
            "derived": derived,
            "fleet": {
                "policy": getattr(self.policy, "name", "custom"),
                "disaggregate": self.disaggregate,
                "replicas": per_replica,
            },
        }

    def collector(
        self, prefix: str = "tdx_fleet", serve_prefix: str = "tdx_serve"
    ):
        """An ``obs.metrics`` collector for the whole fleet — register
        with ``registry.register_collector(fleet.collector(),
        obj=fleet)``.  One scrape surface: the replica-summed engine
        counters render as ``{serve_prefix}_<name>_total`` (a fleet of
        one is indistinguishable from a bare engine's exposition), and
        the per-replica occupancy/routing breakdown renders as
        ``{prefix}_*`` gauges labeled ``replica="<rid>"``, with each
        replica's TTFT/TPOT/e2e latency histograms as per-replica
        quantile summaries (``{prefix}_ttft_s{replica=,quantile=}``
        plus ``_sum``/``_count``) — so "which replica is slow" is
        answerable from the scrape surface alone, no artifact
        digging."""
        import weakref

        from ..obs.metrics import MetricFamily

        ref = weakref.ref(self)

        def collect():
            fleet = ref()
            if fleet is None:
                return []
            j = fleet.metrics_json()
            fams = []
            for name, v in j["counters"].items():
                fams.append(
                    MetricFamily(
                        f"{serve_prefix}_{name}_total", "counter"
                    ).add(v)
                )
            fams.append(
                MetricFamily(f"{prefix}_replicas", "gauge").add(
                    j["gauges"]["replicas"]
                )
            )
            per_gauge = {
                "slots_free": "gauge",
                "pages_free": "gauge",
                "queue_depth": "gauge",
                "active_slots": "gauge",
            }
            for gname, gtype in per_gauge.items():
                fam = MetricFamily(f"{prefix}_{gname}", gtype)
                any_sample = False
                for r in j["fleet"]["replicas"]:
                    if r.get(gname) is None:
                        continue
                    fam.add(r[gname], replica=str(r["replica"]))
                    any_sample = True
                if any_sample:
                    fams.append(fam)
            fam = MetricFamily(
                f"{prefix}_requests_routed_total", "counter"
            )
            for r in j["fleet"]["replicas"]:
                fam.add(r["requests_routed"], replica=str(r["replica"]))
            fams.append(fam)
            # per-replica latency summaries: the same windowed-quantile
            # rendering ServeMetrics.collector uses, labeled by replica
            for hname in ("ttft_s", "tpot_s", "e2e_latency_s"):
                fam = MetricFamily(f"{prefix}_{hname}", "summary")
                any_sample = False
                for rep in fleet._replicas:
                    hist = getattr(rep.engine.metrics, hname)
                    if hist.count == 0:
                        continue
                    rlabel = str(rep.rid)
                    fam.add(
                        hist.quantile(0.5), quantile="0.5", replica=rlabel
                    )
                    fam.add(
                        hist.quantile(0.95), quantile="0.95",
                        replica=rlabel,
                    )
                    fam.add(hist.total, "_sum", replica=rlabel)
                    fam.add(hist.count, "_count", replica=rlabel)
                    any_sample = True
                if any_sample:
                    fams.append(fam)
            return fams

        return collect
