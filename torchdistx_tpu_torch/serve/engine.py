"""``ServeEngine``: continuous-batching inference over a slot KV cache,
counterpart of ``torchdistx_tpu/serve/engine.py`` on a single device, in
its chunked and persistent decode modes: the contiguous slab or the paged
pools with the radix prefix cache, self-speculative decode, and the
model-dtype, plain-cast or int8 cache.

The public surface is the JAX engine's: ``submit(prompt, ...) ->
RequestHandle``, ``step()``, ``run(requests)``, ``finished_requests()``.
Device work comes in two kinds of dispatch:

1. **Prefill**: one request's prompt, padded up to its bucket, runs through
   ``forward_cached`` against a fresh single-request cache from position 0
   (the flash-prefill path: the ``flash_fwd`` CUDA kernel on the card); the
   first token is sampled at the last REAL prompt position and the slab is
   copied into the request's slot row (``kv_cache.write_slot``).  One host
   sync fetches the token; in persistent mode none: the token stays on
   the card until the next ring drain.
   Paged engines prefill only the suffix past the page-aligned prefix the
   radix index already holds: a cold prefill (no hit) is the slab's, a warm
   one runs the suffix at the prefix length over the slot's gathered pages
   on the plain path, and only the bucket's rows are scattered into the
   pools.
2. **Decode**: ``decode_chunk`` batched ``forward_decode`` steps over ALL
   slots, each row at its own depth (the decode-attention CUDA kernels on
   the card: slab or paged, bf16 or int8), with the on-device finish mask
   of ``generation._make_decode_body``; ONE host sync fetches the (K, B)
   token block, which the host walks with the same finish rules.  With
   ``speculate=K`` each step is a draft / verify / accept iteration
   (``generation._make_spec_decode_body``) through the multi-token kernels.
   With ``decode_mode="persistent"`` one dispatch runs the same body until
   every slot has finished or the ``ring_capacity``-row output ring is full
   (``generation._make_persistent_decode``): on the card one iteration
   captured in a CUDA graph and replayed (``serve.graph_loop``), then ONE
   host sync drains the ring, the cursor and the pending first tokens.

PyTorch runs eagerly, so there are no compiled programs to count and no
buffers to donate: the slab is updated in place.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..generation import (
    _check_sampling_args,
    _make_fused_decode,
    _make_fused_spec_decode,
    _make_persistent_decode,
    _make_persistent_spec_decode,
    _make_slot_sampler,
)
from .kv_cache import (
    PagedKVCache,
    SlotKVCache,
    canonicalize_kv_dtype,
    paged_scatter_rows,
    paged_view,
    write_slot,
)
from .metrics import ServeMetrics
from .prefix_cache import PagePool, RadixPrefixIndex
from .scheduler import Request, RequestHandle, RequestResult, Scheduler

__all__ = ["ServeEngine"]

#: the JAX engine's constructor arguments this port does not carry yet;
#: passing any of them raises instead of being ignored
_UNPORTED = (
    "persistent_stream", "params", "cost_cards", "numerics",
    "hbm_budget", "stall_timeout_s", "mesh", "plan", "tp_rule", "tp_axis",
    "chunked_prefill", "record",
)


def _default_buckets(max_len: int) -> tuple:
    """Powers of two from 16 up to (and covering) ``max_len``."""
    buckets = []
    b = 16
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


class ServeEngine:
    """Continuous-batching serving engine over a slot-based KV cache.

    Args (the JAX engine's, where ported):
      model: a decoder-only model exposing ``init_cache``,
        ``forward_cached`` and ``forward_decode`` (``models.Llama``).
      num_slots: concurrent request capacity (the decode batch).
      max_len: per-slot cache length; defaults to the model's maximum
        sequence length.  ``prompt + max_new_tokens <= max_len`` is
        enforced at submit.
      eos_token: generation stops when a slot samples this id.
      top_k / top_p: engine-level sampling filters; per-request
        ``temperature`` (0 = greedy) and ``seed`` are dynamic.
      prefill_buckets: padded prompt lengths (default: powers of two up to
        ``max_len``); the largest caps the admissible prompt.
      max_tokens_in_flight: admission budget over running requests'
        ``prompt + max_new_tokens``.
      decode_chunk: decode steps per dispatch (``K``): one host sync per
        ``K`` steps.
      decode_mode: ``"chunked"`` (``decode_chunk`` steps per dispatch) or
        ``"persistent"``: each dispatch decodes until every slot has
        finished or the output ring is full, then the host drains the ring
        once (one sync per wave); prefill defers its first-token fetch to
        that drain.  On the card the loop is a CUDA graph of one
        iteration, captured at the first dispatch (a failed capture
        raises), replayed from a device-resident loop state.  Streams are
        the chunked mode's token for token.
      ring_capacity: persistent mode's output ring depth (max loop
        iterations per dispatch); default ``max_len``.
      page_size: switch the KV cache to the PAGED layout with pages of this
        many tokens (must divide ``max_len``); ``None`` keeps the slab.
        Greedy paged streams are bit-identical to the slab engine's.
      num_pages: pool size in paged mode; default the slab's footprint plus
        the scratch page, ``num_slots * max_len / page_size + 1``.
      kv_dtype: ``None`` (the model's dtype), ``"int8"`` (quantized, f32
        power-of-two scales per row and head) or a plain cast
        (``"bfloat16"``, ``"float16"``, ``"float32"``).
      prefix_cache: in paged mode, keep the radix prefix index: page-aligned
        shared prompt prefixes are handed over by page-table rewrite and
        prefill computes only the uncached suffix.
      speculate: draft this many tokens per slot per decode iteration by
        prompt lookup in the slot's own history and verify them in one
        batched call; 0 disables.  Greedy streams equal ``speculate=0``'s
        wherever the (B, K+1) verify rounds as the (B, 1) step does.
      spec_ngram: trailing-token match length of the draft lookup.
      finished_history: finished requests kept for ``finished_requests()``.
      device: where the engine runs; defaults to the model's device (the
        model's own default is ``"cuda"``), and must equal it.

    Every other argument of the JAX engine raises ``NotImplementedError``.
    """

    def __init__(
        self,
        model: Any,
        *,
        num_slots: int = 4,
        max_len: Optional[int] = None,
        eos_token: Optional[int] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        prefill_buckets: Optional[Sequence[int]] = None,
        max_tokens_in_flight: Optional[int] = None,
        decode_chunk: int = 1,
        decode_mode: str = "chunked",
        ring_capacity: Optional[int] = None,
        page_size: Optional[int] = None,
        num_pages: Optional[int] = None,
        kv_dtype: Optional[str] = None,
        prefix_cache: bool = True,
        speculate: int = 0,
        spec_ngram: int = 2,
        finished_history: int = 1024,
        device=None,
        **unported,
    ):
        named = sorted(k for k in unported if k in _UNPORTED)
        if named:
            raise NotImplementedError(
                f"ServeEngine argument(s) {named} are not ported to "
                "torchdistx_tpu_torch yet"
            )
        if unported:
            raise TypeError(
                f"unexpected ServeEngine argument(s) {sorted(unported)}"
            )
        if decode_mode not in ("chunked", "persistent"):
            raise ValueError(
                f"decode_mode must be 'chunked' or 'persistent', got "
                f"{decode_mode!r}"
            )
        if speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {speculate}")
        self.speculate = int(speculate)
        self.spec_ngram = int(spec_ngram)
        if self.speculate and self.spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {spec_ngram}")
        _check_sampling_args(top_k, top_p)
        if device is not None and torch.device(device) != model.device:
            raise ValueError(
                f"device {device} differs from the model's device "
                f"{model.device}: move the model first"
            )
        self.device = model.device
        limit = model.cfg.max_seq_len
        if max_len is None:
            max_len = limit
        if max_len > limit:
            raise ValueError(
                f"max_len {max_len} exceeds the model's maximum sequence "
                f"length {limit}"
            )
        self.model = model
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.eos_token = eos_token
        self.top_k = top_k
        self.top_p = top_p
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        self.decode_chunk = int(decode_chunk)
        self.decode_mode = decode_mode
        self._persistent = decode_mode == "persistent"
        if self._persistent:
            if ring_capacity is None:
                ring_capacity = self.max_len
            if ring_capacity < 1:
                raise ValueError(
                    f"ring_capacity must be >= 1, got {ring_capacity}"
                )
            self.ring_capacity: Optional[int] = int(ring_capacity)
        else:
            if ring_capacity is not None:
                raise ValueError(
                    "ring_capacity requires decode_mode='persistent'"
                )
            self.ring_capacity = None
        if prefill_buckets is None:
            buckets = _default_buckets(self.max_len)
        else:
            buckets = tuple(sorted(int(b) for b in prefill_buckets))
            if not buckets or buckets[0] < 1:
                raise ValueError(f"invalid prefill_buckets {prefill_buckets}")
            if buckets[-1] > self.max_len:
                raise ValueError(
                    f"bucket {buckets[-1]} exceeds max_len {self.max_len}"
                )
        self.prefill_buckets = buckets
        self.kv_dtype = canonicalize_kv_dtype(kv_dtype)
        self.page_size = None if page_size is None else int(page_size)
        self.paged = self.page_size is not None
        if self.paged:
            if num_pages is None:
                # the slab's footprint plus the reserved scratch page
                num_pages = self.num_slots * (self.max_len // self.page_size) + 1
            self.num_pages = int(num_pages)
            self.pool = PagePool(self.num_pages)
            self.prefix_index = (
                RadixPrefixIndex(self.page_size) if prefix_cache else None
            )
            self.cache = PagedKVCache(
                model, self.num_slots, self.max_len, self.page_size,
                self.num_pages, kv_dtype=self.kv_dtype,
            )
        else:
            if num_pages is not None:
                raise ValueError("num_pages requires page_size")
            self.num_pages = None
            self.pool = None
            self.prefix_index = None
            self.cache = SlotKVCache(model, self.num_slots, self.max_len,
                                     kv_dtype=self.kv_dtype)
        self.kv_quantized = self.cache.quantized
        self.kv_dtype_name = str(self.cache.kv[0][0].dtype).replace("torch.", "")
        self.scheduler = Scheduler(self.num_slots, max_tokens_in_flight)
        kv_rows = (self.num_pages * self.page_size if self.paged
                   else self.num_slots * self.max_len)
        self.metrics = ServeMetrics(
            self.num_slots,
            num_pages=self.num_pages,
            ring_capacity=self.ring_capacity,
            speculate=self.speculate or None,
            kv_cache_bytes=self.cache.nbytes,
            kv_bytes_per_token=self.cache.nbytes // kv_rows,
            kv_quant_err_max=0.0 if self.kv_quantized else None,
            kv_quant_err_rms=0.0 if self.kv_quantized else None,
        )
        self._sampler = _make_slot_sampler(top_k, top_p)
        if self._persistent and self.speculate:
            self._decode = _make_persistent_spec_decode(
                model, self._sampler, eos_token=eos_token,
                max_len=self.max_len, ring_capacity=self.ring_capacity,
                speculate=self.speculate, ngram=self.spec_ngram,
            )
        elif self._persistent:
            self._decode = _make_persistent_decode(
                model, self._sampler, eos_token=eos_token,
                max_len=self.max_len, ring_capacity=self.ring_capacity,
            )
        elif self.speculate:
            self._decode = _make_fused_spec_decode(
                model, self._sampler, eos_token=eos_token,
                max_len=self.max_len, decode_chunk=self.decode_chunk,
                speculate=self.speculate, ngram=self.spec_ngram,
            )
        else:
            self._decode = _make_fused_decode(
                model, self._sampler, eos_token=eos_token,
                max_len=self.max_len, decode_chunk=self.decode_chunk,
            )
        self._last_tok = np.zeros(self.num_slots, np.int64)
        self._temps = np.zeros(self.num_slots, np.float32)
        self._seeds = np.zeros(self.num_slots, np.int64)
        self._ntok = np.zeros(self.num_slots, np.int64)  # tokens sampled
        self._budget = np.zeros(self.num_slots, np.int64)  # max_new_tokens
        # persistent mode: slot -> the prefill's (1,) first token, left on
        # the card until the next ring drain fetches it
        self._pending_first: dict = {}
        # speculative drafting history on the card: each slot's token stream
        # (prompt + everything generated), carried from dispatch to dispatch
        # (persistent mode: updated in place, never rebound)
        self._hist = (torch.zeros((self.num_slots, self.max_len), dtype=torch.int64,
                                  device=self.device) if self.speculate else None)
        self._finished: deque = deque(maxlen=int(finished_history))

    # -- public API ------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: int, temperature: float = 0.0,
               seed: int = 0, deadline_s: Optional[float] = None,
               trace_id: Optional[int] = None) -> RequestHandle:
        """Enqueue one request; returns immediately.  ``step()`` (or
        ``run``) drives it to completion."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the slot cache length "
                f"{self.max_len} — the prompt may be at most "
                f"{self.max_len - max_new_tokens} tokens for this budget"
            )
        if prompt.size > self.prefill_buckets[-1]:
            raise ValueError(
                f"prompt ({prompt.size}) exceeds the largest prefill "
                f"bucket ({self.prefill_buckets[-1]})"
            )
        if self.paged:
            need = -(-(prompt.size + max_new_tokens) // self.page_size)
            if need > self.pool.capacity:
                # no admission order can ever free enough pages
                raise ValueError(
                    f"prompt ({prompt.size}) + max_new_tokens "
                    f"({max_new_tokens}) needs {need} pages of "
                    f"{self.page_size} tokens, but the "
                    f"{self.kv_dtype_name} cache pool holds only "
                    f"{self.pool.capacity} allocatable pages — raise "
                    "num_pages or shrink the request"
                )
        req = Request(
            rid=-1,
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            temperature=float(temperature),
            seed=int(seed) & 0x7FFFFFFF,
            deadline_s=deadline_s,
            trace_id=None if trace_id is None else int(trace_id),
        )
        self.scheduler.submit(req)
        self.metrics.count("requests_submitted")
        return RequestHandle(req)

    @torch.no_grad()
    def step(self) -> int:
        """One scheduler tick: expire deadlines, admit new requests into
        free slots (one prefill dispatch each), then ONE decode dispatch of
        ``decode_chunk`` steps over every slot.  Returns the number of
        unfinished requests (queued + running)."""
        now = time.monotonic()
        for req in self.scheduler.expire_queued(now):
            self._count_finish(req)
        for req in list(self.scheduler.running):
            if req.expired(now):
                self._finish(req, "deadline", now)
        gate = self._page_gate if self.paged else None
        for req, slot in self.scheduler.admit(now, gate=gate):
            self._prefill_request(req, slot)
        if self.scheduler.running:
            self._decode_step()
        self.metrics.observe_gauges(
            self.scheduler.queue_depth, self.cache.active_count
        )
        if self.paged:
            self.metrics.observe_pages(self.pool.in_use)
        return self.scheduler.queue_depth + len(self.scheduler.running)

    def run(self, requests: Iterable[Union[dict, Any]], *,
            max_new_tokens: int = 32) -> List[RequestResult]:
        """Batch-offline mode: submit everything, step until drained,
        return results in submission order."""
        handles = []
        for r in requests:
            if isinstance(r, dict):
                handles.append(self.submit(**r))
            else:
                handles.append(self.submit(r, max_new_tokens=max_new_tokens))
        while self.step():
            pass
        return [h.result() for h in handles]

    def finished_requests(self) -> List[Request]:
        """The bounded finished-request history (newest last)."""
        return list(self._finished)

    @property
    def loop_replays(self) -> int:
        """Persistent mode: loop iterations launched (CUDA graph replays
        on the card); equal to ``loop_iterations``, since the host never
        launches one past the loop's end.  0 in chunked mode."""
        return self._decode.replays if self._persistent else 0

    # -- internals -------------------------------------------------------

    def _bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(
            f"prompt length {length} exceeds the largest prefill bucket "
            f"({self.prefill_buckets[-1]})"
        )

    def _sample_first(self, logits, true_len: int, temp: float, seed: int):
        """Sampler step 0 at the last real prompt position."""
        dev = logits.device
        return self._sampler(logits[:, true_len - 1, :],
                             torch.tensor([temp], dtype=torch.float32, device=dev),
                             torch.tensor([seed], dtype=torch.int64, device=dev),
                             torch.zeros(1, dtype=torch.int64, device=dev))

    def _prefill(self, tokens, pfx: int, true_len: int, slot: int,
                 temp: float, seed: int) -> torch.Tensor:
        """The JAX engine's prefill programs: the padded (suffix) bucket
        through ``forward_cached`` from ``pfx``, sampled at ``true_len - 1``
        (sampler step 0), its rows written into the slot.  A cold prefill
        (``pfx == 0``, every slab prefill) runs into a fresh (1, bucket)
        cache (the flash path); a warm paged one runs at the page-aligned
        prefix length over the slot's pages below ``pfx + bucket`` (the
        plain path), gathered and, for int8, dequantized into the model's
        dtype, which holds every ``int8 * 2^k`` exactly.  The slab takes the
        rows with ``write_slot``; the pools take only the bucket's rows
        (shared prefix pages are never rewritten; padding rows past the
        chain land on the scratch page).  Returns the (1,) token."""
        model, bucket = self.model, tokens.shape[1]
        if self.paged:
            n_pages = -(-(pfx + bucket) // self.page_size)
            table_row = torch.as_tensor(self.cache.page_tables[slot, :n_pages],
                                        device=self.device)
        if pfx == 0:
            view = model.init_cache(1, bucket)
        else:
            dt = model.cfg.dtype
            view = [(k.to(dt), v.to(dt))
                    for k, v in paged_view(self.cache.kv, table_row, self.page_size)]
        logits, view = model.forward_cached(tokens, view, pfx)
        tok = self._sample_first(logits, true_len, temp, seed)
        if self.paged:
            paged_scatter_rows(self.cache.kv, view, table_row, self.page_size,
                               pfx, bucket)
        else:
            write_slot(self.cache.kv, view, slot)
        return tok

    def _page_gate(self, req: Request) -> bool:
        """Paged admission gate (run by ``Scheduler.admit`` on the FCFS
        head): match the prompt against the prefix index, reserve the shared
        pages (incref) plus fresh pages for the rest of the request's
        page-aligned footprint, evicting LRU unreferenced prefixes under
        pressure.  False (pages short even after eviction) blocks the line
        until running requests retire; the reservation is stashed on the
        request for ``_prefill_request``."""
        ps = self.page_size
        hit: list = []
        if self.prefix_index is not None:
            hit = self.prefix_index.match(req.prompt)
            # the suffix prefill writes view rows [P, P + bucket): shrink
            # the hit until that span fits the slot geometry
            while hit and (
                len(hit) * ps + self._bucket_for(req.prompt.size - len(hit) * ps)
                > self.max_len
            ):
                hit.pop()
        need_total = -(-(req.prompt.size + req.max_new_tokens) // ps)
        need_new = need_total - len(hit)
        self.pool.incref(hit)  # pin before eviction can consider them
        if self.pool.free_count < need_new and self.prefix_index is not None:
            self.metrics.count(
                "pages_evicted",
                self.prefix_index.evict(self.pool, need_new - self.pool.free_count),
            )
        if self.pool.free_count < need_new:
            self.pool.decref(hit)
            self.metrics.count("admissions_rejected_pages")
            return False
        req.pages = hit + self.pool.alloc(need_new)
        req.prefix_len = len(hit) * ps
        return True

    def _adopt_prefix(self, req: Request) -> None:
        """Post-prefill prefix bookkeeping: hit-rate counters, and the
        request's full-prompt page-aligned pages handed to the radix index."""
        if self.prefix_index is None:
            return
        ps = self.page_size
        self.metrics.count("prefix_lookup_tokens", int(req.prompt.size))
        self.metrics.count("prefix_hit_tokens", req.prefix_len)
        n_full = req.prompt.size // ps
        self.prefix_index.insert(req.prompt[: n_full * ps], req.pages[:n_full],
                                 self.pool)

    def _prefill_request(self, req: Request, slot: int) -> None:
        pfx = req.prefix_len if self.paged else 0
        suffix = req.prompt[pfx:]
        bucket = self._bucket_for(suffix.size)
        if self.paged:
            req.record_event("prefill", bucket=bucket, cold=pfx == 0,
                             prefix_hit_tokens=pfx)
            self.cache.set_table(slot, req.pages)
        else:
            req.record_event("prefill", bucket=bucket, cold=True)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, : suffix.size] = suffix
        tokens = torch.as_tensor(padded, device=self.device)
        t0 = time.perf_counter()
        tok = self._prefill(tokens, pfx, suffix.size, slot, req.temperature,
                            req.seed)
        if not self._persistent:
            tok = int(tok[0].item())  # host sync: the first token exists
        self.metrics.prefill_s.record(time.perf_counter() - t0)
        # only the suffix bucket was computed: the prefix hit is the
        # prefill the cache saved
        self.metrics.count("tokens_prefilled", bucket)
        if self.paged:
            self._adopt_prefix(req)
        self.cache.admit(slot, req.prompt.size)
        self._temps[slot] = req.temperature
        self._seeds[slot] = req.seed
        self._ntok[slot] = 1
        self._budget[slot] = req.max_new_tokens
        if self.speculate:
            # seed the slot's draft history with the prompt; the decode body
            # writes every later token at its stream index on the card
            self._hist[slot].zero_()
            self._hist[slot, : req.prompt.size] = torch.as_tensor(
                req.prompt, device=self.device)
        now = time.monotonic()
        self.metrics.count("prefill_calls")
        self.metrics.count("requests_admitted")
        self.metrics.queue_wait_s.record(
            (req.admitted_at or now) - req.submitted_at
        )
        if self._persistent:
            # no host sync: the loop splices the token in on the card and
            # computes its finish bit there; the drain records it
            self._pending_first[slot] = tok
            return
        self.metrics.count("host_syncs")
        self._record_first(req, tok, now)
        self._check_finished(req, tok, now)

    def _record_first(self, req: Request, tok: int, now: float) -> None:
        self._last_tok[req.slot] = tok
        req.first_token_at = now
        req.record_event("first_token", ts=now)
        req.generated.append(tok)
        self.metrics.count("tokens_generated")
        self.metrics.ttft_s.record(req.first_token_at - req.submitted_at)

    def _decode_args(self):
        """The chunked dispatch's device inputs after the cache, plus the
        page tables of a paged cache as the trailing extra input."""
        dev = self.device
        state = [torch.as_tensor(self._last_tok, device=dev),
                 torch.as_tensor(self.cache.positions(), device=dev).long()]
        if self.speculate:
            state.append(self._hist)
        state += [torch.as_tensor(a, device=dev) for a in
                  (self._temps, self._seeds, self._ntok, self._budget,
                   ~self.cache.active)]
        if self.paged:
            state.append(torch.as_tensor(self.cache.page_tables, device=dev))
        return state

    def _decode_step(self) -> None:
        """One decode dispatch: ``K = decode_chunk`` steps (speculative
        iterations with ``speculate``), ONE host sync for the token block,
        then the host walk with the finish rules the device mask applied
        (``_check_finished``).  Persistent mode: ``_persistent_step``."""
        if self._persistent:
            return self._persistent_step()
        running = self.scheduler.running
        k_steps = self.decode_chunk
        t0 = time.perf_counter()
        out = self._decode(self.cache.kv, *self._decode_args())
        self.cache.kv = out[0]
        if self.speculate:
            self._hist = out[3]
            ys, cs = (t.cpu().numpy() for t in out[1:3])  # ONE host sync
        else:
            block = out[1].cpu().numpy()  # ONE host sync per K slot-steps
        seconds = time.perf_counter() - t0
        self.metrics.decode_s.record(seconds)
        self.metrics.count("host_syncs")
        self.metrics.count("decode_dispatches")
        self.metrics.count("decode_steps", k_steps)
        now = time.monotonic()
        emitted = 0
        for req in running:
            slot = req.slot
            took = 0
            for j in range(k_steps):
                if self.speculate:
                    c = int(cs[j, slot])
                    if c == 0:
                        break  # frozen from here on
                    n, finished = self._consume_spec_block(req, ys[j, slot], c, now)
                else:
                    n, finished = self._consume_token(req, int(block[j, slot]), now)
                emitted += n
                took = j + 1
                if finished:
                    # the device froze this slot for the rest of the chunk
                    self.metrics.count("masked_slot_steps", k_steps - 1 - j)
                    break
            ev = ("decode_chunk", now, {"tokens": took})
            if req.events and req.events[-1][0] == "finish":
                req.events.insert(-1, ev)
            else:
                req.events.append(ev)
        self.metrics.count("tokens_generated", emitted)
        self.metrics.count("tokens_decoded", emitted)
        if emitted:
            self.metrics.decode_token_s.record(seconds / emitted)

    def _persistent_step(self) -> None:
        """One persistent dispatch: the loop runs on the card until every
        slot's finish bit is set or the ring is full, then ONE host sync
        drains the ring, its valid mask (speculation: the count ring), the
        cursor and every pending first token together.  The walk applies
        the finish rules the device mask applied, bounded by the mask (True
        exactly on the rows a live slot sampled, the finishing token
        included), so host bookkeeping and device carries agree iteration
        for iteration.  A request the ring cut off stays running and
        continues from its frozen carry at the next dispatch.  Shared by the
        one-token and the speculative loop, as the chunked walk is."""
        running = self.scheduler.running
        cache, dev = self.cache, self.device
        pending = self._pending_first
        t0 = time.perf_counter()
        args = [self._last_tok, cache.positions(), self._hist, self._temps,
                self._seeds, self._ntok, self._budget,
                # the cache-full rule from the UNCLAMPED host positions
                cache.active & (cache.pos < self.max_len)]
        if self.paged:
            args.append(cache.page_tables)
        _, ring, marks, it = self._decode(cache.kv, *args, firsts=pending)
        slots = list(pending)
        firsts = (torch.cat([pending[s] for s in slots]) if slots
                  else torch.zeros(0, dtype=torch.int64, device=dev))
        # ONE host sync: the ring, its marks, the cursor, the first tokens
        flat = torch.cat([ring.reshape(-1), marks.reshape(-1).long(), it,
                          firsts.long()]).cpu().numpy()
        seconds = time.perf_counter() - t0
        n_ring, n_marks = ring.numel(), marks.numel()
        block = flat[:n_ring].reshape(ring.shape)
        marks = flat[n_ring:n_ring + n_marks].reshape(marks.shape)
        n_it = int(flat[n_ring + n_marks])
        firsts = dict(zip(slots, flat[n_ring + n_marks + 1:].tolist()))
        pending.clear()
        self.metrics.decode_s.record(seconds)
        self.metrics.count("host_syncs")  # the drain IS the sync
        self.metrics.count("ring_drains")
        self.metrics.count("decode_dispatches")
        self.metrics.count("decode_steps", n_it)
        self.metrics.count("loop_iterations", n_it)
        self.metrics.observe_ring(n_it)
        now = time.monotonic()
        emitted = 0
        any_cut = False
        for req in running:
            slot = req.slot
            taken = 0
            finished = False
            if slot in firsts:
                tok = firsts[slot]
                self._record_first(req, tok, now)
                # fin0 froze an EOS first token or a spent one-token budget
                # before iteration 0: the slot idled the whole loop
                finished = self._check_finished(req, tok, now)
            j = 0
            while not finished and j < n_it and marks[j, slot]:
                if self.speculate:
                    n, finished = self._consume_spec_block(
                        req, block[j, slot], int(marks[j, slot]), now)
                else:
                    n, finished = self._consume_token(req, int(block[j, slot]), now)
                emitted += n
                j += 1
                taken = j
            if finished:
                # iterations the loop ran past this slot's finish
                self.metrics.count("masked_slot_steps", n_it - taken)
            else:
                any_cut = True  # the ring filled before this request's end
            ev = ("decode_chunk", now, {"tokens": taken})
            if req.events and req.events[-1][0] == "finish":
                req.events.insert(-1, ev)
            else:
                req.events.append(ev)
        if any_cut:
            self.metrics.count("ring_full_drains")
        self.metrics.count("tokens_generated", emitted)
        self.metrics.count("tokens_decoded", emitted)
        if emitted:
            self.metrics.decode_token_s.record(seconds / emitted)

    def _consume_token(self, req: Request, tok: int, now: float) -> tuple:
        """One decoded token of one request.  Returns ``(1, finished)``."""
        slot = req.slot
        self._ntok[slot] += 1
        self.cache.advance_slot(slot)
        self._last_tok[slot] = tok
        req.generated.append(tok)
        return 1, self._check_finished(req, tok, now)

    def _consume_spec_block(self, req: Request, ys_row, c: int,
                            now: float) -> tuple:
        """One verified block (``c`` accepted tokens of a ``(speculate +
        1,)`` row) of one request: the one-token bookkeeping per token and
        the draft-economy counters.  The device's truncation lands any
        finish on the block's last emitted token.  Returns ``(emitted,
        finished)``."""
        k = self.speculate
        # per live slot-iteration: K lanes drafted, c - 1 of them accepted
        self.metrics.count("draft_tokens_proposed", k)
        self.metrics.count("draft_tokens_accepted", c - 1)
        self.metrics.count("spec_rejected_lane_steps", (k + 1) - c)
        emitted = 0
        finished = False
        for i in range(c):
            _, finished = self._consume_token(req, int(ys_row[i]), now)
            emitted += 1
            if finished:
                break
        return emitted, finished

    def _check_finished(self, req: Request, tok: int, now: float) -> bool:
        if self.eos_token is not None and tok == self.eos_token:
            self._finish(req, "stop", now)
        elif len(req.generated) >= req.max_new_tokens:
            self._finish(req, "length", now)
        elif self.cache.full(req.slot):
            self._finish(req, "cache_full", now)
        else:
            return False
        return True

    def _finish(self, req: Request, reason: str, now: float) -> None:
        slot = req.slot
        pending = self._pending_first.pop(slot, None)
        if pending is not None:
            # a finish before the first drain (a deadline): the prefill did
            # sample a token; fetch it, at the cost of one sync
            self.metrics.count("host_syncs")
            self._record_first(req, int(pending[0].item()), now)
        self.scheduler.retire(req)
        self.cache.retire(slot)  # paged: also rewires the table to scratch
        if self.paged and req.pages is not None:
            # drop the request's references; pages the prefix index adopted
            # live on under its own refcount until LRU eviction
            self.pool.decref(req.pages)
            req.pages = None
        self._temps[slot] = 0.0
        req.finish_reason = reason
        req.finished_at = now
        req.record_event("finish", ts=now, reason=reason)
        self._count_finish(req)

    def _count_finish(self, req: Request) -> None:
        self.metrics.count("requests_completed")
        result = req.result()
        if result.truncated:
            self.metrics.count("requests_truncated")
        self.metrics.e2e_latency_s.record(result.latency_s)
        if result.tpot_s is not None:
            self.metrics.tpot_s.record(result.tpot_s)
        self._finished.append(req)
