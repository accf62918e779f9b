"""``ServeEngine``: continuous-batching inference over a slot KV cache,
counterpart of ``torchdistx_tpu/serve/engine.py`` in its default mode
(``decode_mode="chunked"``, contiguous slab, no speculation, model-dtype
cache, single device).

The public surface is the JAX engine's: ``submit(prompt, ...) ->
RequestHandle``, ``step()``, ``run(requests)``, ``finished_requests()``.
Device work comes in two kinds of dispatch:

1. **Prefill**: one request's prompt, padded up to its bucket, runs through
   ``forward_cached`` against a fresh single-request cache from position 0
   (the flash-prefill path: the ``flash_fwd`` CUDA kernel on the card); the
   first token is sampled at the last REAL prompt position and the slab is
   copied into the request's slot row (``kv_cache.write_slot``).  One host
   sync fetches the token.
2. **Decode**: ``decode_chunk`` batched ``forward_decode`` steps over ALL
   slots, each row at its own depth (the ``decode_attention`` CUDA kernel
   on the card), with the on-device finish mask of
   ``generation._make_decode_body``; ONE host sync fetches the (K, B) token
   block, which the host walks with the same finish rules.

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
    _make_slot_sampler,
)
from .kv_cache import SlotKVCache, write_slot
from .metrics import ServeMetrics
from .scheduler import Request, RequestHandle, RequestResult, Scheduler

__all__ = ["ServeEngine"]

#: the JAX engine's constructor arguments this port does not carry yet;
#: passing any of them raises instead of being ignored
_UNPORTED = (
    "ring_capacity", "persistent_stream", "page_size", "num_pages",
    "kv_dtype", "prefix_cache", "params", "cost_cards", "numerics",
    "hbm_budget", "stall_timeout_s", "mesh", "plan", "tp_rule", "tp_axis",
    "chunked_prefill", "spec_ngram", "record",
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
      decode_mode: only ``"chunked"`` is ported; ``speculate`` only 0.
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
        speculate: int = 0,
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
        if decode_mode != "chunked":
            if decode_mode == "persistent":
                raise NotImplementedError(
                    "decode_mode='persistent' is not ported yet"
                )
            raise ValueError(
                f"decode_mode must be 'chunked' or 'persistent', got "
                f"{decode_mode!r}"
            )
        if speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {speculate}")
        if speculate > 0:
            raise NotImplementedError("speculate > 0 is not ported yet")
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
        self.cache = SlotKVCache(model, self.num_slots, self.max_len)
        self.scheduler = Scheduler(self.num_slots, max_tokens_in_flight)
        self.metrics = ServeMetrics(
            self.num_slots,
            kv_cache_bytes=self.cache.nbytes,
            kv_bytes_per_token=self.cache.nbytes
            // (self.num_slots * self.max_len),
        )
        self._sampler = _make_slot_sampler(top_k, top_p)
        self._decode = _make_fused_decode(
            model, self._sampler, eos_token=eos_token, max_len=self.max_len,
            decode_chunk=self.decode_chunk,
        )
        self._last_tok = np.zeros(self.num_slots, np.int64)
        self._temps = np.zeros(self.num_slots, np.float32)
        self._seeds = np.zeros(self.num_slots, np.int64)
        self._ntok = np.zeros(self.num_slots, np.int64)  # tokens sampled
        self._budget = np.zeros(self.num_slots, np.int64)  # max_new_tokens
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
        for req, slot in self.scheduler.admit(now):
            self._prefill_request(req, slot)
        if self.scheduler.running:
            self._decode_step()
        self.metrics.observe_gauges(
            self.scheduler.queue_depth, self.cache.active_count
        )
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

    # -- internals -------------------------------------------------------

    def _bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(
            f"prompt length {length} exceeds the largest prefill bucket "
            f"({self.prefill_buckets[-1]})"
        )

    def _prefill(self, tokens, true_len: int, slot: int, temp: float,
                 seed: int) -> torch.Tensor:
        """The JAX engine's prefill program: the padded bucket through
        ``forward_cached`` from 0, sample at ``true_len - 1`` (sampler step
        0), write the slab into the slot row.  Returns the (1,) token."""
        model = self.model
        slab = model.init_cache(1, tokens.shape[1])
        logits, slab = model.forward_cached(tokens, slab, 0)
        last = logits[:, true_len - 1, :]
        tok = self._sampler(last, np.array([temp], np.float32),
                            np.array([seed], np.int64), np.zeros(1, np.int64))
        write_slot(self.cache.kv, slab, slot)
        return tok

    def _prefill_request(self, req: Request, slot: int) -> None:
        bucket = self._bucket_for(req.prompt.size)
        req.record_event("prefill", bucket=bucket, cold=True)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, : req.prompt.size] = req.prompt
        t0 = time.perf_counter()
        tok = self._prefill(
            torch.as_tensor(padded, device=self.device), req.prompt.size,
            slot, req.temperature, req.seed,
        )
        tok = int(tok[0].item())  # host sync: the first token exists
        self.metrics.prefill_s.record(time.perf_counter() - t0)
        self.metrics.count("tokens_prefilled", bucket)
        self.cache.admit(slot, req.prompt.size)
        self._temps[slot] = req.temperature
        self._seeds[slot] = req.seed
        self._ntok[slot] = 1
        self._budget[slot] = req.max_new_tokens
        now = time.monotonic()
        self.metrics.count("prefill_calls")
        self.metrics.count("requests_admitted")
        self.metrics.queue_wait_s.record(
            (req.admitted_at or now) - req.submitted_at
        )
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

    def _decode_step(self) -> None:
        """One decode dispatch: ``K = decode_chunk`` steps, ONE host sync
        for the (K, num_slots) token block, then the host walk with the
        finish rules the device mask applied (``_check_finished``)."""
        running = self.scheduler.running
        k_steps = self.decode_chunk
        dev = self.device
        t0 = time.perf_counter()
        kv, block = self._decode(
            self.cache.kv,
            torch.as_tensor(self._last_tok, device=dev),
            torch.as_tensor(self.cache.positions(), device=dev),
            self._temps,
            self._seeds,
            self._ntok,
            torch.as_tensor(self._budget, device=dev),
            torch.as_tensor(~self.cache.active, device=dev),
        )
        self.cache.kv = kv
        block = block.cpu().numpy()  # ONE host sync per K slot-steps
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
                tok = int(block[j, slot])
                self._ntok[slot] += 1
                self.cache.advance_slot(slot)
                self._last_tok[slot] = tok
                req.generated.append(tok)
                emitted += 1
                took = j + 1
                if self._check_finished(req, tok, now):
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
        self.scheduler.retire(req)
        self.cache.retire(slot)
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
