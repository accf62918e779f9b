"""Serving metrics: counters, gauges, and histograms with a plain-dict
snapshot.

A copy of ``torchdistx_tpu/serve/metrics.py`` (host-only bookkeeping for
``serve.engine.ServeEngine``): recording a value never touches the device.
:meth:`ServeMetrics.collector` projects it through the port's
``obs.metrics`` registry.

``snapshot()`` returns one flat JSON-serializable dict (counters verbatim,
gauges verbatim, ``<hist>_mean/_p50/_p95/_max/_count`` per histogram, plus
derived throughput rates).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

__all__ = ["Histogram", "ServeMetrics"]


class Histogram:
    """Bounded-reservoir histogram of float observations.

    **Window semantics** (read this before putting a quantile on a
    dashboard): ``count`` and ``total`` (hence ``mean``) are exact over
    the histogram's full LIFETIME, but the reservoir keeps only the most
    recent samples — after an overflow compaction it holds between
    ``maxlen // 2`` and ``maxlen`` of them — so ``p50``/``p95``/``max``
    describe a recent window, not all time.  ``window_count`` in
    :meth:`snapshot` says how many samples the quantiles actually saw:
    ``window_count < count`` means the reservoir has wrapped and a p95
    labeled "all-time" would be a misread.  (Serving runs are unbounded;
    all-time exact quantiles are not worth unbounded memory.)
    """

    def __init__(self, maxlen: int = 4096):
        self._maxlen = int(maxlen)
        self._samples: List[float] = []
        self.count = 0
        self.total = 0.0

    def record(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self._samples.append(value)
        if len(self._samples) > self._maxlen:
            # drop the oldest half in one slice instead of popping per call
            self._samples = self._samples[self._maxlen // 2 :]

    @property
    def window_count(self) -> int:
        """Samples currently in the quantile window (<= ``count``)."""
        return len(self._samples)

    def _quantile(self, q: float) -> Optional[float]:
        if not self._samples:
            return None
        xs = sorted(self._samples)
        idx = min(len(xs) - 1, int(q * (len(xs) - 1) + 0.5))
        return xs[idx]

    def quantile(self, q: float) -> Optional[float]:
        """Windowed quantile (see the class docstring for the window
        semantics) — the public read the SLO engine (``obs/slo.py``)
        and the fleet's per-replica latency summaries evaluate.  None
        while the window is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        return self._quantile(float(q))

    def snapshot(self) -> Dict[str, Optional[float]]:
        return {
            "count": self.count,
            "mean": self.total / self.count if self.count else None,
            # window stats (see class docstring): quantiles and max look
            # at the last window_count samples only
            "window_count": self.window_count,
            "p50": self._quantile(0.50),
            "p95": self._quantile(0.95),
            "max": max(self._samples) if self._samples else None,
        }


class ServeMetrics:
    """The ``ServeEngine`` metric set.

    Counters: ``requests_submitted/admitted/completed/truncated``,
    ``tokens_prefilled`` (padded-bucket tokens, the compute actually
    spent), ``tokens_generated`` (every sampled token, the prefill's
    first token included), ``tokens_decoded`` (decode-dispatch tokens
    only — the numerator matching ``decode_s`` time), ``prefill_calls``,
    ``decode_steps`` (on-device decode iterations: ``decode_chunk`` per
    dispatch), ``decode_dispatches`` (compiled-program launches),
    ``host_syncs`` (device->host materializations: one per prefill and
    one per decode dispatch — with ``decode_chunk=K`` roughly 1/K per
    token, THE number the fused decode loop exists to shrink),
    ``masked_slot_steps`` (slot-steps the on-device finish mask threw
    away because a request finished mid-chunk: the wasted-work side of
    the host-sync tradeoff), the speculative-decoding set —
    ``draft_tokens_proposed`` (n-gram draft tokens offered to the
    verifier: ``speculate`` per live slot-iteration),
    ``draft_tokens_accepted`` (drafts that matched the verified greedy
    target and were emitted; ``accepted / proposed`` is the derived
    ``accept_rate``) and ``spec_rejected_lane_steps`` (verify lanes
    discarded by rejection — the speculative twin of
    ``masked_slot_steps``; per live slot-iteration emitting ``e`` tokens
    the identities are exact: ``accepted = e - 1``, ``rejected_lanes =
    speculate + 1 - e``, so ``accepted + rejected_lanes = speculate``) —
    the chunked-prefill set —
    ``chunked_prefills`` (long-prompt admissions split into chunks),
    ``prefill_chunks`` (chunk dispatches those admissions made) and
    ``prefill_interleaved_dispatches`` (decode dispatches interleaved
    between chunks so active slots keep emitting during a long
    admission) — the persistent-loop set —
    ``loop_iterations`` (on-device while_loop iterations across all
    persistent dispatches — equals ``decode_steps`` in persistent mode),
    ``ring_drains`` (loop exits whose output ring the host drained; in
    persistent mode every drain is also exactly one ``host_syncs``
    increment, which is what keeps ``syncs_per_token`` honest),
    ``ring_full_drains`` (drains where the ring filled before every
    slot finished — at least one request spans into the next loop), and
    ``stream_callbacks`` (streamed-tail host callbacks, opt-in) — and
    the prefix-cache set —
    ``prefix_lookup_tokens`` / ``prefix_hit_tokens`` (prompt tokens
    looked up in the radix index vs served from it; their ratio is the
    derived ``prefix_hit_rate``) and ``pages_evicted`` (LRU evictions
    from the prefix index under pool pressure) — and
    ``admissions_rejected_hbm`` (admission ticks the HBM capacity
    planner refused because the projected peak exceeded
    ``ServeEngine(hbm_budget=...)``; the page gate alone would have
    admitted) and ``admissions_rejected_pages`` (ticks the page gate
    refused the FCFS head even after LRU eviction — the page-pressure
    rejection signal the fleet router reads) — and the disaggregation
    set (``ServeEngine.handoff_to``) —
    ``requests_handed_off`` / ``requests_handed_in`` (prefill->decode
    per-request KV handoffs, source/target side),
    ``handoff_pages_moved``, and ``handoff_wire_bytes`` /
    ``handoff_collectives`` (the ring-model cost of those moves, exact
    against the comm audit like ``migration_wire_bytes``).
    Gauges: ``queue_depth``, ``active_slots``, ``slots_free``
    (``num_slots - active_slots``, published first-class for the fleet
    router); paged engines add
    ``pages_in_use`` / ``pages_in_use_hwm`` (current and high-water
    allocated pages), ``num_pages``, and ``pages_free`` (allocatable
    headroom, scratch page excluded); persistent engines add
    ``ring_capacity`` and ``ring_occupancy_hwm`` (high-water loop
    iterations a single dispatch used — at the capacity it means rings
    are filling and requests span drains); speculative engines add the
    ``speculate`` config gauge (drafts per iteration, K); engines that
    know their KV pool footprint add ``kv_cache_bytes`` (total resident
    KV bytes, quantization scales included) and ``kv_bytes_per_token``
    (pool bytes per cache token-row — int8 caches publish roughly half
    the bf16 figure); quantized (int8) engines additionally publish
    ``kv_quant_err_max`` / ``kv_quant_err_rms`` (observed KV dequant
    error from the numerics-observatory digests; the max is pinned
    ``<= s/2`` by the power-of-two quantizer's round-to-nearest bound).
    All config gauges survive ``reset_metrics()``: the engine re-passes
    them when it rebuilds this object.
    Histograms: ``ttft_s`` (submit -> first token on host),
    ``e2e_latency_s``, ``queue_wait_s``, ``tpot_s`` (per finished
    request: decode seconds per token after the first — the
    time-per-output-token figure, derived from the request's OWN
    lifecycle timestamps so the aggregate and ``RequestResult.tpot_s``
    provably agree), ``slot_occupancy`` (active / total slots, sampled
    per decode dispatch), ``prefill_s`` / ``decode_s`` (per-dispatch
    wall times, fetch included), and ``decode_token_s`` (decode dispatch
    wall time / tokens it emitted — the per-token latency a consumer
    actually experiences, amortized over the chunk).

    """

    _HISTOGRAMS = (
        "ttft_s",
        "e2e_latency_s",
        "queue_wait_s",
        "tpot_s",
        "slot_occupancy",
        "prefill_s",
        "decode_s",
        "decode_token_s",
    )

    def __init__(
        self,
        num_slots: int,
        num_pages: Optional[int] = None,
        ring_capacity: Optional[int] = None,
        speculate: Optional[int] = None,
        kv_cache_bytes: Optional[int] = None,
        kv_bytes_per_token: Optional[int] = None,
        kv_quant_err_max: Optional[float] = None,
        kv_quant_err_rms: Optional[float] = None,
    ):
        self.num_slots = int(num_slots)
        self.num_pages = num_pages if num_pages is None else int(num_pages)
        self.ring_capacity = (
            ring_capacity if ring_capacity is None else int(ring_capacity)
        )
        self.speculate = speculate if speculate is None else int(speculate)
        # KV-footprint gauges (quantization-aware): total resident KV pool
        # bytes (data + scales) and the per-token-row cost — int8 caches
        # publish roughly half the bf16 figure, so dashboards can attribute
        # capacity headroom to kv_dtype without re-deriving cache geometry.
        self.kv_cache_bytes = (
            kv_cache_bytes if kv_cache_bytes is None else int(kv_cache_bytes)
        )
        self.kv_bytes_per_token = (
            kv_bytes_per_token
            if kv_bytes_per_token is None
            else int(kv_bytes_per_token)
        )
        # KV dequantization-error gauges (int8 pools only; ISSUE 19):
        # observed max |orig - deq| and its RMS across every
        # quantize-on-write site, harvested from the numerics-observatory
        # digests at existing sync points.  Bounded by s/2 (power-of-two
        # scales, round-to-nearest) — tests/test_kv_quant.py pins the
        # bound.  Like the footprint gauges these survive
        # ``reset_metrics()``: the engine re-passes the current values.
        self.kv_quant_err_max = (
            kv_quant_err_max
            if kv_quant_err_max is None
            else float(kv_quant_err_max)
        )
        self.kv_quant_err_rms = (
            kv_quant_err_rms
            if kv_quant_err_rms is None
            else float(kv_quant_err_rms)
        )
        self.started_at = time.monotonic()
        self.counters: Dict[str, int] = {
            "requests_submitted": 0,
            "requests_admitted": 0,
            "requests_completed": 0,
            "requests_truncated": 0,
            "tokens_prefilled": 0,
            "tokens_generated": 0,
            "tokens_decoded": 0,
            "prefill_calls": 0,
            "chunked_prefills": 0,
            "prefill_chunks": 0,
            "prefill_interleaved_dispatches": 0,
            "decode_steps": 0,
            "decode_dispatches": 0,
            "host_syncs": 0,
            "masked_slot_steps": 0,
            "draft_tokens_proposed": 0,
            "draft_tokens_accepted": 0,
            "spec_rejected_lane_steps": 0,
            "loop_iterations": 0,
            "ring_drains": 0,
            "ring_full_drains": 0,
            "stream_callbacks": 0,
            "prefix_lookup_tokens": 0,
            "prefix_hit_tokens": 0,
            "pages_evicted": 0,
            "admissions_rejected_hbm": 0,
            "submits_rejected_draining": 0,
            "admissions_rejected_pages": 0,
            "requests_migrated_out": 0,
            "requests_migrated_in": 0,
            "migration_wire_bytes": 0,
            "requests_handed_off": 0,
            "requests_handed_in": 0,
            "handoff_pages_moved": 0,
            "handoff_wire_bytes": 0,
            "handoff_collectives": 0,
        }
        self.queue_depth = 0
        self.active_slots = 0
        self.pages_in_use = 0
        self.pages_in_use_hwm = 0
        self.ring_occupancy_hwm = 0
        self.ttft_s = Histogram()
        self.e2e_latency_s = Histogram()
        self.queue_wait_s = Histogram()
        self.tpot_s = Histogram()
        self.slot_occupancy = Histogram()
        self.prefill_s = Histogram()
        self.decode_s = Histogram()
        self.decode_token_s = Histogram()

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def observe_gauges(self, queue_depth: int, active_slots: int) -> None:
        self.queue_depth = queue_depth
        self.active_slots = active_slots
        self.slot_occupancy.record(active_slots / max(1, self.num_slots))

    def observe_pages(self, in_use: int) -> None:
        """Paged engines only: current allocated pages.  The high-water
        mark accumulates HERE, over this metrics object's lifetime — so
        a reset (e.g. between bench passes) starts a fresh peak instead
        of inheriting the pool's engine-lifetime one."""
        self.pages_in_use = in_use
        self.pages_in_use_hwm = max(self.pages_in_use_hwm, in_use)

    def observe_ring(self, iterations: int) -> None:
        """Persistent engines only: loop iterations one dispatch used.
        Same reset rationale as :meth:`observe_pages` — the high-water
        mark lives on this metrics object, not the engine."""
        self.ring_occupancy_hwm = max(self.ring_occupancy_hwm, iterations)

    def observe_kv_quant(self, err_max: float, err_rms: float) -> None:
        """Quantized engines only: fold one numerics-harvest window's KV
        dequant error into the gauges — running max for the bound check,
        latest-window RMS for the trend line."""
        prev = self.kv_quant_err_max
        self.kv_quant_err_max = (
            float(err_max) if prev is None else max(prev, float(err_max))
        )
        self.kv_quant_err_rms = float(err_rms)

    def to_json(self) -> dict:
        """The one structured, JSON-serializable schema tests, bench, and
        CI all parse: ``{"counters", "gauges", "histograms", "derived"}``
        — counters and gauges verbatim, one summary dict per histogram
        (``count/mean/p50/p95/max``), and the derived rates.
        ``scripts/bench_serve.py`` embeds this whole object per phase
        instead of hand-picking fields."""
        gauges: dict = {
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "num_slots": self.num_slots,
            # first-class headroom gauge (additive): the fleet router's
            # load signal, published instead of making every consumer
            # derive num_slots - active_slots
            "slots_free": self.num_slots - self.active_slots,
        }
        if self.num_pages is not None:
            gauges["num_pages"] = self.num_pages
            gauges["pages_in_use"] = self.pages_in_use
            gauges["pages_in_use_hwm"] = self.pages_in_use_hwm
            # allocatable headroom: capacity excludes the reserved
            # scratch page (prefix_cache.PagePool.capacity)
            gauges["pages_free"] = (self.num_pages - 1) - self.pages_in_use
        if self.ring_capacity is not None:
            gauges["ring_capacity"] = self.ring_capacity
            gauges["ring_occupancy_hwm"] = self.ring_occupancy_hwm
        if self.speculate is not None:
            gauges["speculate"] = self.speculate
        if self.kv_cache_bytes is not None:
            gauges["kv_cache_bytes"] = self.kv_cache_bytes
        if self.kv_bytes_per_token is not None:
            gauges["kv_bytes_per_token"] = self.kv_bytes_per_token
        if self.kv_quant_err_max is not None:
            gauges["kv_quant_err_max"] = self.kv_quant_err_max
        if self.kv_quant_err_rms is not None:
            gauges["kv_quant_err_rms"] = self.kv_quant_err_rms
        wall = time.monotonic() - self.started_at
        # decode-only tokens over decode-only time: prefill's sampled
        # token rides a prefill dispatch, so counting it here would
        # inflate short-generation throughput
        decode_time = self.decode_s.total
        tokens = self.counters["tokens_generated"]
        lookups = self.counters["prefix_lookup_tokens"]
        proposed = self.counters["draft_tokens_proposed"]
        derived = {
            "wall_s": wall,
            "decode_tokens_per_sec": (
                self.counters["tokens_decoded"] / decode_time
                if decode_time > 0
                else None
            ),
            "wall_tokens_per_sec": tokens / wall if wall > 0 else None,
            # the fused-decode headline: device->host round trips per
            # emitted token (1 + 1/max_new at K=1, ~1/K once chunking
            # amortizes them)
            "syncs_per_token": (
                self.counters["host_syncs"] / tokens if tokens > 0 else None
            ),
            # the prefix-cache headline: prompt tokens served from cached
            # pages instead of recomputed
            "prefix_hit_rate": (
                self.counters["prefix_hit_tokens"] / lookups
                if lookups > 0
                else None
            ),
            # the speculative-decode headlines: both EXACT ratios of
            # deterministic counters (so the perf gate can pin them
            # bit-identically), not timings.  proposed = speculate per
            # live slot-iteration, so proposed / speculate is the live
            # slot-iteration count and tokens-per-iteration is
            # 1 + accepted / iterations.
            "accept_rate": (
                self.counters["draft_tokens_accepted"] / proposed
                if proposed > 0
                else None
            ),
            "accepted_tokens_per_iteration": (
                1.0
                + self.counters["draft_tokens_accepted"]
                * self.speculate
                / proposed
                if proposed > 0 and self.speculate
                else None
            ),
        }
        return {
            "counters": dict(self.counters),
            "gauges": gauges,
            "histograms": {
                name: getattr(self, name).snapshot()
                for name in self._HISTOGRAMS
            },
            "derived": derived,
        }

    def snapshot(self) -> dict:
        """``to_json`` flattened to one dict (counters and gauges
        verbatim, ``<hist>_<stat>`` per histogram entry, derived rates) —
        the legacy record shape, kept as a strict projection of
        ``to_json`` so the two can never disagree."""
        j = self.to_json()
        out: dict = dict(j["counters"])
        out.update(j["gauges"])
        for name, summary in j["histograms"].items():
            for k, v in summary.items():
                out[f"{name}_{k}"] = v
        out.update(j["derived"])
        return out

    def collector(self, prefix: str = "tdx_serve"):
        """An ``obs.metrics`` collector over THIS object's live state —
        register with ``registry.register_collector(m.collector(),
        obj=m)`` so a rebound ``engine.metrics`` drops out of the
        exposition when the old object is collected.  Rendering reads
        :meth:`to_json`, so the exposition can never drift from the
        JSON/snapshot schema."""
        import weakref

        from ..obs.metrics import MetricFamily

        # close over a weakref, not self: a registered collector must
        # not pin a rebound engine.metrics object in the exposition
        ref = weakref.ref(self)

        def collect():
            self = ref()
            if self is None:
                return []
            j = self.to_json()
            fams = []
            for name, v in j["counters"].items():
                fams.append(
                    MetricFamily(
                        f"{prefix}_{name}_total", "counter"
                    ).add(v)
                )
            for name, v in j["gauges"].items():
                fams.append(
                    MetricFamily(f"{prefix}_{name}", "gauge").add(v)
                )
            for name, s in j["histograms"].items():
                base = name[:-2] + "_seconds" if name.endswith("_s") else name
                fam = MetricFamily(f"{prefix}_{base}", "summary")
                fam.add(s["p50"], quantile="0.5")
                fam.add(s["p95"], quantile="0.95")
                hist = getattr(self, name)
                fam.add(hist.total, "_sum")
                fam.add(hist.count, "_count")
                fams.append(fam)
                # quantile-window size (Histogram window semantics)
                fams.append(
                    MetricFamily(
                        f"{prefix}_{base}_window_count", "gauge"
                    ).add(s["window_count"])
                )
            return fams

        return collect
