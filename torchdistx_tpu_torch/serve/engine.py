"""``ServeEngine``: continuous-batching inference over a slot KV cache,
counterpart of ``torchdistx_tpu/serve/engine.py`` on a single device, in
its chunked and persistent decode modes: the contiguous slab or the paged
pools with the radix prefix cache, self-speculative decode, the
model-dtype, plain-cast or int8 cache, chunked prefill, the HBM admission
gate, and the elastic surface a fleet drives (drain, migration, handoff).

The public surface is the JAX engine's: ``submit(prompt, ...) ->
RequestHandle``, ``step()``, ``step_prefill()``, ``run(requests)``,
``drain()``, ``migrate_to(engine)``, ``handoff_to(engine, request)``,
``memory_plan()``, ``num_compiled_programs()``, ``reset_metrics()``,
``dump_trace(path)``, ``finished_requests()``, ``attach_recorder`` and
``session_geometry`` (the session black box, ``obs.blackbox``) and
``poll_stream()`` (the persistent loop's streamed tail, ``serve.stream``).  Device work comes in two
kinds of dispatch:

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
   pools.  With ``chunked_prefill=C`` a longer prompt lands in chunks of at
   most ``C`` tokens with one decode dispatch between consecutive chunks:
   the first chunk of a cold prompt is a cold prefill (flash), the later
   chunks are mid-cache and run on the plain path over the slot's rows
   (the JAX package keeps mid-cache chunks on its jnp path the same way).
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

**Programs.**  PyTorch runs eagerly, so the port's counterpart of a
compiled program is a program SHAPE, set up at its first dispatch: the
JAX engine's program keys (a prefill bucket, cold or warm; a decode
``decode_chunk``; the persistent ring) plus the engine's static geometry.
They are kept on the model, as the JAX jit store is, so engines of equal
geometry share them; a CUDA graph captured by a persistent engine is its
own and counts once per capturing engine, in the count of every engine of
equal geometry.  ``num_compiled_programs()`` reads that registry; each new
entry is reported to ``obs.recompile``'s watchers under the current scope.
The slab and the pools are updated in place: there are no buffers to
donate, and a KV move into a persistent engine keeps the addresses its
captured graph holds.

**Tensor parallelism.**  ``mesh=`` (a ``parallel.Mesh`` with a
``tp_axis``) and ``plan=`` (default ``parallel.tp.llama_tp_plan(mesh,
tp_axis)``) serve Megatron-style over the mesh's ranks: every rank runs
its own engine over the same requests, the parameters placed by the plan
into the engine's own ``{name: piece}`` dict (the model's own parameters
are left whole), and every dispatch runs with the plan's local forwards
(``parallel.tp.TPLayout``) and those pieces in the model: column-parallel
``wq`` / ``wk`` / ``wv`` and ``w_gate`` / ``w_up``, row-parallel ``wo`` and
``w_down`` leaving through an all-reduce, the vocabulary-sharded embedding,
and the head's logits all-gathered before the sampler, so every rank
samples the same tokens from the same seeds and keeps the same host
schedule.  Each rank's attention runs its ``n_heads / tp`` query and
``n_kv_heads / tp`` KV heads through the flash and decode kernels, and the
slab and the pools hold its ``n_kv_heads / tp`` heads (the plan's
``kv_cache`` rule; int8 scales split alike).  The comm audit
(``obs.comm``) gets the JAX engine's closed form at each dispatch: 2 * L
all-reduces of ``n_tokens x dim`` activations (the row-parallel
projections), the activation's own element size; the embedding's
all-reduce and the head's gather, which the JAX engine leaves out, run
muted, as do the row-parallel all-reduces themselves
(``collectives.payload_bytes`` still counts every byte the transport
carried).  On the card a persistent engine over a ``gloo`` group is
refused: a CUDA graph cannot capture a ``gloo`` collective, and NCCL
refuses two ranks on one card.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import time
import weakref
from collections import deque
from typing import Any, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..generation import (
    _NUMERICS_SITES,
    _check_sampling_args,
    _make_fused_decode,
    _make_fused_spec_decode,
    _make_persistent_decode,
    _make_persistent_spec_decode,
    _make_slot_sampler,
    max_positions,
)
from ..obs import memory as obs_memory
from ..obs.blackbox import resolve_record
from ..obs.comm import muted, record_collective
from ..obs.cost import (
    CostBook,
    begin_allocator_card,
    finish_allocator_card,
    force_disabled as _cost_force_disabled,
)
from ..obs.numerics import (
    NumericsBook,
    StagedDigests,
    numerics_enabled,
    numerics_tape,
    tap,
)
from ..obs.recompile import note_compile
from ..obs.trace import get_tracer, request_trace_events
from ..utils.profiling import timed_annotation
from .kv_cache import (
    PagedKVCache,
    SlotKVCache,
    canonicalize_kv_dtype,
    dequantize_kv,
    init_kv,
    paged_scatter_rows,
    paged_view,
    write_slot,
)
from .metrics import ServeMetrics
from .prefix_cache import PagePool, RadixPrefixIndex
from .scheduler import Request, RequestHandle, RequestResult, Scheduler

__all__ = ["ServeEngine"]

#: the sites a tensor-parallel harvest folds over ``tp``: each rank digests
#: its heads of the KV cache's writes
_TP_FOLDED_SITES = ("kv_quant_err", "kv_quant_scale")


#: engine serials: a CUDA graph is keyed on the engine that captured it
_SERIALS = itertools.count()


def _default_buckets(max_len: int) -> tuple:
    """Powers of two from 16 up to (and covering) ``max_len``."""
    buckets = []
    b = 16
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def _split_counts(t: torch.Tensor) -> tuple:
    """Per-dimension split counts of a tensor's placement (all 1s for a
    tensor whole on its device, as every cache tensor is without a
    mesh)."""
    from ..parallel.mesh import sharding_of
    from ..parallel.reshard import split_counts

    marked = sharding_of(t)
    return split_counts(t.shape, None if marked is None else marked[0])


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
      persistent_stream: persistent mode's streamed tail
        (:mod:`~torchdistx_tpu_torch.serve.stream`): each loop iteration
        also pushes its ``(tokens, live mask, cursor)`` to a host ring with
        a clock stamp (on the card a host node of the captured iteration,
        C code built from ``csrc/stream_ring.cu``; on the CPU a plain call),
        so first tokens are stamped when they exist, before the drain.
        The ring drain still decides every token.  ``stream_supported``
        reads ``"host_node"`` on the card, ``"host_call"`` on the CPU;
        ``stream_events`` holds the last dispatch's pushes and the
        ``stream_callbacks`` counter counts them.  Needs
        ``decode_mode="persistent"`` and no ``speculate``.
      record: the session black box (:mod:`~torchdistx_tpu_torch.obs.
        blackbox`): a :class:`SessionRecorder`, a path (a streaming
        recorder), ``True`` (in memory) or None.  The engine records its
        geometry, every submit, step and drain, and folds a digest of its
        integer counters and emitted tokens at every drain, from values
        already on the host: recording adds no host sync.
        ``TDX_SESSION_RECORD=0`` turns every implicit recorder off.
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
      finished_history: finished requests kept for ``finished_requests()``
        and ``dump_trace``.
      cost_cards: take a :class:`~torchdistx_tpu_torch.obs.cost.CostCard`
        of every program at its first dispatch on the card (from the CUDA
        caching allocator: temp and peak bytes), kept in
        ``engine.cost_book``; ``memory_plan()`` charges the worst temp.
        A probe resets the allocator's peak statistics.  Probes that fail
        are counted in ``cost_card_errors`` and never fail a dispatch.
        No card is taken on the CPU.  ``TDX_COST_CARDS=0`` force-disables.
      hbm_budget: device memory budget in BYTES for the second admission
        gate: before admitting, the engine projects its footprint (weights
        + KV cache + the worst program temp on record, ``memory_plan()``)
        and refuses admission while it exceeds the budget, recording
        ``("gated", why="hbm_budget")`` in the request's lifecycle events
        and counting ``admissions_rejected_hbm``.  Mutable at runtime
        (raise it and the next ``step()`` admits); None disables the gate.
      stall_timeout_s: arm a dispatch-stall watchdog
        (:class:`~torchdistx_tpu_torch.obs.watchdog.DispatchWatchdog`)
        around every dispatch and its host sync: a region that overruns
        this many seconds dumps the flight recorder naming the program and
        its cost card.  None disables.
      chunked_prefill: prefill-chunk threshold in tokens.  A prompt (or
        paged uncached suffix) LONGER than this is prefilled in chunks of
        at most this many tokens, with one decode dispatch interleaved
        between consecutive chunks, so a long prompt does not stall every
        decoding slot for its whole prefill.  Must be one of
        ``prefill_buckets``.  None disables.
      speculate: draft this many tokens per slot per decode iteration by
        prompt lookup in the slot's own history and verify them in one
        batched call; 0 disables.  Greedy streams equal ``speculate=0``'s
        wherever the (B, K+1) verify rounds as the (B, 1) step does.
      spec_ngram: trailing-token match length of the draft lookup.
      params: ``{name: tensor}`` served in place of the model's own
        parameters (FSDP-materialized weights, say); with a mesh, placed by
        the plan.
      mesh: a ``parallel.Mesh`` to serve tensor-parallel over (module
        docstring); every rank of it runs an engine over the same requests.
        ``n_kv_heads`` must divide over ``tp_axis``.
      plan: the :class:`~torchdistx_tpu_torch.parallel.plan.ShardingPlan`
        that places the parameters and the KV pool (its ``kv_cache``
        rule); default ``llama_tp_plan(mesh, tp_axis)``.  Requires a mesh.
      tp_rule: deprecated: a bare ``sharding_rule(path, like)`` in place of
        the plan (``DeprecationWarning``; ``plan`` stays None).
      tp_axis: the mesh axis to tensor-shard over (default ``"tp"``).
      numerics: the numerics observatory (``obs.numerics``); None reads
        ``TDX_NUMERICS``.  Every dispatch digests its sampled logits (the
        last prompt row of a prefill; all B rows of each decode step, the
        whole (B, K+1) block of a verify) and, on an int8 cache, the
        dequantization error and the scales of every quantize-on-write,
        on the card and inside the captured persistent iteration.  The
        digests are read only at the syncs the engine already counts
        (``host_syncs``, ``decode_dispatches`` and every other counter are
        unchanged) and folded into ``numerics_book``; a KV error above
        half the largest scale records one ``kv_quant_err`` flight anomaly.
        With a tensor-parallel mesh (tp > 1) the book is the JAX engine's
        global one on every rank: each harvest folds the ranks' head-split
        KV digests over ``tp`` (``obs.numerics.fold_host_digests``: the
        host copies the harvest already read, three all-reduces that book
        nothing in the comm audit), and takes the logits digest as it is
        (the gathered logits are the same on every rank).  That fold needs
        a ``gloo`` tp group: over NCCL ``numerics=True`` is refused.
      device: where the engine runs; defaults to the model's device (the
        model's own default is ``"cuda"``), and must equal it.
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
        finished_history: int = 1024,
        cost_cards: bool = True,
        hbm_budget: Optional[int] = None,
        stall_timeout_s: Optional[float] = None,
        chunked_prefill: Optional[int] = None,
        speculate: int = 0,
        spec_ngram: int = 2,
        persistent_stream: bool = False,
        record: Any = None,
        params: Optional[dict] = None,
        mesh: Any = None,
        plan: Any = None,
        tp_rule: Any = None,
        tp_axis: str = "tp",
        numerics: Optional[bool] = None,
        device=None,
    ):
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
        if persistent_stream and decode_mode != "persistent":
            raise ValueError("persistent_stream requires decode_mode='persistent'")
        if persistent_stream and self.speculate:
            raise ValueError(
                "speculate is not supported with persistent_stream: the "
                "streamed tail pushes one token per iteration, but a "
                "speculative iteration emits a variable-length block only "
                "the drain walk can consume")
        _check_sampling_args(top_k, top_p)
        if device is not None and torch.device(device) != model.device:
            raise ValueError(
                f"device {device} differs from the model's device "
                f"{model.device}: move the model first"
            )
        self.device = model.device
        # the JAX engine's reading: max_seq_len, else n_positions (GPT-2)
        limit = max_positions(model.cfg)
        if max_len is None:
            max_len = limit
        if max_len > limit:
            raise ValueError(
                f"max_len {max_len} exceeds the model's maximum sequence "
                f"length {limit}"
            )
        self.model = model
        self._setup_tp(model, params, mesh, plan, tp_rule, tp_axis, decode_mode)
        self._serial = next(_SERIALS)
        # the numerics observatory: digests ride each dispatch and are read
        # at its existing sync (the JAX engine's zero-overhead contract)
        self.numerics = numerics_enabled() if numerics is None else bool(numerics)
        if self.numerics and self.tp > 1:
            import torch.distributed as dist

            if dist.get_backend(self.mesh.axes[self.tp_axis].group) != "gloo":
                raise RuntimeError(
                    "numerics=True with tensor parallelism folds the ranks' host "
                    "digests over the tp group, which needs a gloo group; serve "
                    "with numerics=False over NCCL")
        self.numerics_book = NumericsBook()
        self._pending_digests: list = []
        self._kv_quant_alarmed = False
        self.numerics_harvest_errors = 0
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
        if chunked_prefill is not None:
            chunked_prefill = int(chunked_prefill)
            if chunked_prefill not in self.prefill_buckets:
                raise ValueError(
                    f"chunked_prefill ({chunked_prefill}) must be one of "
                    f"prefill_buckets {self.prefill_buckets} — every full "
                    "chunk is dispatched through that bucket's program"
                )
        self.chunked_prefill = chunked_prefill
        self.kv_dtype = canonicalize_kv_dtype(kv_dtype)
        self._prefix_cache_flag = bool(prefix_cache)
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
                sharding=self._kv_sharding,
            )
        else:
            if num_pages is not None:
                raise ValueError("num_pages requires page_size")
            self.num_pages = None
            self.pool = None
            self.prefix_index = None
            self.cache = SlotKVCache(model, self.num_slots, self.max_len,
                                     kv_dtype=self.kv_dtype, sharding=self._kv_sharding)
        heads = self.cache.kv[0][0].shape[2] * self.tp
        if self.kv_heads is not None and heads != self.kv_heads:
            raise ValueError(
                f"the model's cache holds {heads} KV heads, its config "
                f"{self.kv_heads}"
            )
        self.kv_quantized = self.cache.quantized
        self.kv_dtype_name = str(self.cache.kv[0][0].dtype).replace("torch.", "")
        self.scheduler = Scheduler(self.num_slots, max_tokens_in_flight)
        self.metrics = self._new_metrics(
            0.0 if self.kv_quantized else None,
            0.0 if self.kv_quantized else None,
        )
        self._sampler = _make_slot_sampler(top_k, top_p)
        if self._persistent and self.speculate:
            self._decode = _make_persistent_spec_decode(
                model, self._sampler, eos_token=eos_token,
                max_len=self.max_len, ring_capacity=self.ring_capacity,
                speculate=self.speculate, ngram=self.spec_ngram,
                numerics=self.numerics,
            )
        elif self._persistent:
            self._decode = _make_persistent_decode(
                model, self._sampler, eos_token=eos_token,
                max_len=self.max_len, ring_capacity=self.ring_capacity,
                stream=persistent_stream, numerics=self.numerics,
            )
        elif self.speculate:
            self._decode = _make_fused_spec_decode(
                model, self._sampler, eos_token=eos_token,
                max_len=self.max_len, decode_chunk=self.decode_chunk,
                speculate=self.speculate, ngram=self.spec_ngram,
                numerics=self.numerics,
            )
        else:
            self._decode = _make_fused_decode(
                model, self._sampler, eos_token=eos_token,
                max_len=self.max_len, decode_chunk=self.decode_chunk,
                numerics=self.numerics,
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
        # mid-cache prefill chunks run on the plain path (module docstring)
        self.plain_prefill_chunks = 0
        # cost observatory: one card per program, at its first dispatch on
        # the card; a probe that fails is counted, never raised
        self.cost_book = CostBook()
        self._cards_on = (bool(cost_cards) and not _cost_force_disabled()
                          and self.device.type == "cuda")
        self._carded: set = set()
        self.cost_card_errors = 0
        # the HBM gate (mutable); the static plan components (weights,
        # kv) are computed once, at first use
        self.hbm_budget = hbm_budget
        self._static_footprint: Optional[dict] = None
        self._gate = self._make_admission_gate()
        # drain state: a draining engine refuses new submissions and
        # admits nothing, but keeps stepping its running slots
        self._draining = False
        self.watchdog = None
        if stall_timeout_s is not None:
            from ..obs.watchdog import DispatchWatchdog

            self.watchdog = DispatchWatchdog(stall_timeout_s, book=self.cost_book)
        # the streamed tail: the last dispatch's pushes, (stamp, tokens,
        # live, cursor) per loop iteration, read at step() and the drain
        self.persistent_stream = bool(persistent_stream)
        self.stream_supported: Optional[str] = None
        if self.persistent_stream:
            self.stream_supported = "host_node" if self.device.type == "cuda" else "host_call"
        self.stream_events: list = []
        # the session black box: the recorder takes geometry and outside
        # events and folds the digest chain at every drain boundary; under
        # TDX_SESSION_RECORD=0 resolve_record gives a disabled recorder and
        # every hook is dead
        self.recorder = None
        self._bb_on = False
        self._bb_driver = True
        self._bb_source = "engine"
        self._bb_in_drain = False
        self._bb_finished_pending: list = []
        rec = resolve_record(record)
        if rec is not None:
            self.attach_recorder(rec)

    def _setup_tp(self, model, params, mesh, plan, tp_rule, tp_axis, decode_mode) -> None:
        """The JAX engine's ``params`` / ``mesh`` / ``plan`` / ``tp_rule`` /
        ``tp_axis`` (module docstring): the served parameters, the TP layout
        and the KV cache's sharding."""
        import warnings

        import torch.distributed as dist

        from ..parallel.mesh import NamedSharding
        from ..parallel.plan import place_params
        from ..parallel.tp import LLAMA_TP_GROUPS, TPLayout, llama_tp_plan

        cfg = model.cfg
        # the JAX engine's reading of the KV head count: n_kv_heads, else
        # n_heads (GPT-2: plain multi-head attention, group size 1)
        self.kv_heads = getattr(cfg, "n_kv_heads", None) or getattr(cfg, "n_heads", None)
        self.mesh = mesh
        self.tp_axis = str(tp_axis)
        self._kv_sharding = None
        self._layout = None
        named = dict(model.named_parameters())
        if params is not None and set(params) != set(named):
            raise ValueError(
                f"params must name the model's parameters: missing "
                f"{sorted(set(named) - set(params))[:4]}, unknown "
                f"{sorted(set(params) - set(named))[:4]}")
        self._own_params = params is not None or mesh is not None
        # the closed form's block geometry; a model that hides it serves
        # unaudited, as in the JAX engine
        layers = getattr(cfg, "n_layers", None) or getattr(cfg, "n_layer", None)
        dim = getattr(cfg, "dim", None) or getattr(cfg, "n_embd", None)
        self._tp_geom = (int(layers), int(dim)) if layers and dim else None
        self._act_itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        if mesh is None:
            if tp_rule is not None:
                raise ValueError("tp_rule requires mesh=")
            if plan is not None:
                raise ValueError("plan requires mesh=")
            self.tp = 1  # no mesh: every tensor is whole on the one device
            self.plan = None
            self.params = dict(params) if params is not None else named
            return
        if self.tp_axis not in mesh.axis_names:
            raise ValueError(
                f"mesh has no '{self.tp_axis}' axis (axes: "
                f"{tuple(mesh.axis_names)}) — pass tp_axis=")
        self.tp = int(mesh.shape[self.tp_axis])
        if plan is not None and tp_rule is not None:
            raise ValueError("pass plan= or tp_rule=, not both")
        if tp_rule is not None:
            # a bare rule places parameters but cannot validate or price
            warnings.warn(
                "ServeEngine(tp_rule=) is deprecated: pass the declarative plan "
                "instead — ServeEngine(plan=llama_tp_plan(mesh, tp_axis)) or any "
                "ShardingPlan (parallel/plan.py)", DeprecationWarning, stacklevel=3)
            rule, groups = tp_rule, LLAMA_TP_GROUPS
        else:
            if plan is None:
                plan = llama_tp_plan(mesh, self.tp_axis)
            if plan.mesh is not mesh:
                raise ValueError("plan.mesh is not the engine's mesh — build the plan "
                                 "on the serving mesh (plan.with_mesh)")
            rule, groups = plan.as_rule(), plan.tp_groups
        self.plan = plan
        if self.kv_heads is None:
            raise ValueError(
                "cannot head-shard the KV cache: the model's config exposes no KV "
                "head count (n_kv_heads / n_heads) — pass mesh=None to serve it whole")
        if self.kv_heads % self.tp:
            raise ValueError(
                f"KV cache head axis (n_kv_heads={self.kv_heads}) does not divide over "
                f"the '{self.tp_axis}' mesh axis ({self.tp} ranks): {self.kv_heads} % "
                f"{self.tp} != 0.  Pick a tp degree that divides n_kv_heads")
        spec = (plan.maybe_spec_for("kv_cache", (0, 0, self.kv_heads, 0))
                if plan is not None else None)
        self._kv_sharding = NamedSharding(mesh, spec if spec is not None
                                          else (None, None, self.tp_axis, None))
        if (self.tp > 1 and decode_mode == "persistent" and model.device.type == "cuda"
                and dist.get_backend(mesh.axes[self.tp_axis].group) == "gloo"):
            raise RuntimeError(
                "decode_mode='persistent' with tensor parallelism over a gloo group "
                "cannot run on the card: the persistent loop is one CUDA graph, and a "
                "CUDA graph cannot capture a gloo collective.  Serve it with "
                "decode_mode='chunked', or with the ranks on distinct cards over an "
                "NCCL group (NCCL refuses two ranks on one card)")
        self.params = place_params(dict(params if params is not None else named), rule)
        self._layout = TPLayout(model, mesh, params=self.params, groups=groups)

    @contextlib.contextmanager
    def _model_region(self):
        """The model as one dispatch runs it: with a mesh the plan's local
        forwards and this engine's pieces, the collectives muted (the
        dispatch books the JAX engine's closed form); with ``params=``
        those parameters; else the model as it is."""
        if self._layout is not None:
            with self.mesh, muted(), self._layout.installed() as swap:
                self._layout.swap_all(swap)
                yield
        elif self._own_params:
            from ..parallel.fsdp import swapped_parameters

            named = dict(self.model.named_parameters())
            with swapped_parameters(self.model) as swap:
                for name, t in self.params.items():
                    swap(named[name], t)
                yield
        else:
            yield

    def _record_tp_collectives(self, n_tokens: int, steps: int = 1) -> None:
        """The JAX engine's closed form at dispatch: one all-reduce of the
        ``(n_tokens, dim)`` activation per row-parallel projection (``wo``
        and ``w_down``, 2 a block) per step, at the activation's element
        size.  The head's gather and the embedding's all-reduce are left
        out, as the JAX engine leaves them (module docstring).  Nothing
        without a mesh, at tp 1, or for a model hiding its geometry."""
        if self.tp <= 1 or self._tp_geom is None:
            return
        n_layers, dim = self._tp_geom
        record_collective("all_reduce", self.tp_axis,
                          payload_bytes=int(n_tokens) * dim * self._act_itemsize,
                          count=2 * n_layers * int(steps), axis_size=self.tp)

    def _new_metrics(self, err_max, err_rms) -> ServeMetrics:
        kv_rows = (self.num_pages * self.page_size if self.paged
                   else self.num_slots * self.max_len)
        return ServeMetrics(
            self.num_slots,
            num_pages=self.num_pages,
            ring_capacity=self.ring_capacity,
            speculate=self.speculate or None,
            kv_cache_bytes=self.cache.nbytes,
            kv_bytes_per_token=self.cache.nbytes // kv_rows,
            kv_quant_err_max=err_max,
            kv_quant_err_rms=err_rms,
        )

    # -- public API ------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: int, temperature: float = 0.0,
               seed: int = 0, deadline_s: Optional[float] = None,
               trace_id: Optional[int] = None) -> RequestHandle:
        """Enqueue one request; returns immediately.  ``step()`` (or
        ``run``) drives it to completion.  ``trace_id`` propagates a
        fleet-scoped trace context; left None, the scheduler mints a
        process-unique one, which rides the request through
        ``handoff_to`` / ``migrate_to``."""
        if self._draining:
            # a named refusal: a draining engine never admits again
            self.metrics.count("submits_rejected_draining")
            raise RuntimeError(
                "engine is draining: new submissions are refused — "
                "submit to the migration target engine instead"
            )
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
        if self._bb_on:
            if self._bb_driver:
                self.recorder.record_submit(self._bb_source, req)
            else:
                # a fleet replica: the fleet recorded the submit; register
                # the identity so this engine's drain tokens key on it
                self.recorder.register_request(req.trace_id)
        return RequestHandle(req)

    def _admit_tick(self, now: float) -> None:
        """Expire deadlines, then admit and prefill into free slots."""
        for req in self.scheduler.expire_queued(now):
            self._count_finish(req)
        for req in list(self.scheduler.running):
            if req.expired(now):
                self._finish(req, "deadline", now)
        gate = (self._gate
                if (self._draining or self.paged or self.hbm_budget is not None)
                else None)
        for req, slot in self.scheduler.admit(now, gate=gate):
            self._prefill_request(req, slot)

    def _tick_end(self) -> int:
        self.metrics.observe_gauges(
            self.scheduler.queue_depth, self.cache.active_count
        )
        if self.paged:
            self.metrics.observe_pages(self.pool.in_use)
        return self.scheduler.queue_depth + len(self.scheduler.running)

    @torch.no_grad()
    def step(self) -> int:
        """One scheduler tick: expire deadlines, admit new requests into
        free slots (one prefill dispatch each, or chunks), then ONE decode
        dispatch of ``decode_chunk`` steps over every slot.  Returns the
        number of unfinished requests (queued + running)."""
        self._record_tick("step")
        self.poll_stream()
        self._admit_tick(time.monotonic())
        if self.scheduler.running:
            self._decode_step()
        return self._tick_end()

    @torch.no_grad()
    def step_prefill(self) -> int:
        """The disaggregated prefill role's tick: expire deadlines and
        admit + prefill into free slots exactly like :meth:`step`, but
        NEVER run a decode dispatch — a prefilled request parks in its slot
        (first token sampled and recorded) until ``handoff_to`` moves its
        KV to a decode engine.  Chunked mode only: the persistent loop's
        deferred first-token fetch would ride a decode drain this role
        never performs.  Returns unfinished requests (queued + parked)."""
        if self._persistent:
            raise RuntimeError(
                "step_prefill requires decode_mode='chunked' — the "
                "persistent loop defers first-token fetches to a decode "
                "drain a prefill-role engine never runs"
            )
        self._record_tick("step_prefill")
        self._admit_tick(time.monotonic())
        return self._tick_end()

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

    # -- the streamed tail -------------------------------------------------

    def poll_stream(self) -> int:
        """Read the streamed tail's new pushes into ``stream_events`` and
        count them in ``stream_callbacks``; host memory only, no sync.
        Returns the number read (0 without ``persistent_stream``)."""
        ring = getattr(self._decode, "stream", None)
        if ring is None:
            return 0
        new = ring.take()
        self.stream_events.extend(new)
        if new:
            self.metrics.count("stream_callbacks", len(new))
        return len(new)

    # -- the session black box (obs/blackbox.py) ---------------------------

    def attach_recorder(self, recorder, *, source: str = "engine",
                        driver: bool = True,
                        geometry_extra: Optional[dict] = None) -> None:
        """Wire a :class:`~torchdistx_tpu_torch.obs.blackbox.SessionRecorder`
        into this engine.  ``driver=True`` (a standalone engine): submits
        and steps are recorded as outside events.  ``driver=False`` (a fleet
        replica): the fleet owns the event log, and this engine adds only
        its geometry and its drain folds, under ``source`` (the replica's
        name)."""
        self.recorder = recorder
        self._bb_source = str(source)
        self._bb_driver = bool(driver)
        self._bb_on = bool(getattr(recorder, "enabled", False))
        self._bb_finished_pending = []
        if not self._bb_on:
            return
        recorder.record("geometry", source=self._bb_source,
                        **self.session_geometry(), **(geometry_extra or {}))
        if recorder.path:
            # every flight or watchdog dump names the recording it pairs with
            from ..obs.flight import get_flight_recorder

            get_flight_recorder().session_path = recorder.path

    def session_geometry(self) -> dict:
        """Everything :func:`~torchdistx_tpu_torch.obs.blackbox.
        replay_session` needs to rebuild this engine, plus attribution (the
        model class, the resolved storage dtype)."""
        return {
            "model": type(self.model).__name__,
            "num_slots": self.num_slots,
            "max_len": self.max_len,
            "eos_token": self.eos_token,
            "top_k": self.top_k,
            "top_p": self.top_p,
            "prefill_buckets": list(self.prefill_buckets),
            "decode_chunk": self.decode_chunk,
            "decode_mode": self.decode_mode,
            "ring_capacity": self.ring_capacity,
            "page_size": self.page_size,
            "num_pages": self.num_pages,
            "kv_dtype": self.kv_dtype,
            "kv_dtype_name": self.kv_dtype_name,
            "chunked_prefill": self.chunked_prefill,
            "speculate": self.speculate,
            "spec_ngram": self.spec_ngram,
            "prefix_cache": self._prefix_cache_flag,
            "tp": self.tp,
            "plan": (None if self.plan is None
                     else getattr(self.plan, "name", type(self.plan).__name__)),
        }

    def _record_tick(self, kind: str) -> None:
        if self._bb_on and self._bb_driver and not self._bb_in_drain:
            self.recorder.tick += 1
            self.recorder.record(kind, tick=self.recorder.tick)

    def _record_drain(self) -> None:
        """Fold one drain boundary into the session digest chain: the
        integer counters' delta and every token this drain's walk appended,
        keyed by session request id.  Called at the end of each walk that
        counted ``host_syncs``; it reads only values already on the host,
        so recording adds no host sync."""
        if not self._bb_on:
            return
        rec = self.recorder
        toks: dict = {}
        pend, self._bb_finished_pending = self._bb_finished_pending, []
        for req in list(self.scheduler.running) + pend:
            sid = rec.session_rid(req.trace_id)
            if sid is None:
                continue  # submitted before the recorder was attached
            done = getattr(req, "_bb_emitted", 0)
            tail = req.generated[done:]
            if tail:
                toks[sid] = [int(t) for t in tail]
                req._bb_emitted = len(req.generated)
        rec.drain(self._bb_source, self.metrics.counters, toks)

    # -- elastic drain / live migration ----------------------------------

    @torch.no_grad()
    def drain(self, *, complete: bool = False) -> int:
        """Stop admission so the engine can be resized or retired.

        Queued requests stay queued — the FCFS head gets a ``("gated",
        {"why": "draining"})`` lifecycle event — and new :meth:`submit`
        calls raise.  Running slots keep their KV state; with
        ``complete=True`` the engine steps until every running request
        finishes (queued ones wait for :meth:`migrate_to`), otherwise they
        stay suspended at the current chunk boundary with positions, host
        sampling state and cache rows intact.  Persistent mode's pending
        first tokens are fetched (one host sync) so the suspended state is
        complete.  Returns the number of unfinished requests."""
        if self._bb_on and self._bb_driver and not self._bb_in_drain:
            # the intent, recorded before it runs: a kill mid-drain leaves
            # the event, and replay re-enters the same drain (its inner
            # steps are the drain's own, not outside events)
            self.recorder.record("engine_drain", complete=bool(complete))
        self._bb_in_drain = True
        try:
            return self._drain_impl(complete)
        finally:
            self._bb_in_drain = False

    def _drain_impl(self, complete: bool) -> int:
        self._draining = True
        now = time.monotonic()
        # the queued head learns WHY it stopped moving right away
        if self.scheduler.queue_depth:
            Scheduler._record_gated(self.scheduler.queued[0], now, "draining")
        by_slot = {r.slot: r for r in self.scheduler.running}
        for slot, pending in list(self._pending_first.items()):
            del self._pending_first[slot]
            req = by_slot.get(slot)
            if req is None:
                continue
            tok = int(pending[0].item())
            self.metrics.count("host_syncs")
            self._harvest_numerics()
            self._record_first(req, tok, now)
            self._check_finished(req, tok, now)
        self._record_drain()  # the flush above was a drain boundary
        if complete:
            while self.scheduler.running:
                self.step()
        return self.scheduler.queue_depth + len(self.scheduler.running)

    def _check_kv_compatible(self, target: "ServeEngine", what: str) -> None:
        if self.paged != target.paged:
            raise RuntimeError(
                f"cannot {what} between slab and paged engines — KV "
                "layouts are not interconvertible in place"
            )
        if self.max_len != target.max_len:
            raise RuntimeError(
                f"KV geometry mismatch: source max_len {self.max_len} "
                f"!= target max_len {target.max_len}"
            )
        if self.paged and self.page_size != target.page_size:
            raise RuntimeError(
                f"page-size mismatch: source {self.page_size} != "
                f"target {target.page_size}"
            )
        if self.kv_dtype_name != target.kv_dtype_name:
            raise RuntimeError(
                f"KV dtype mismatch: source {self.kv_dtype_name} cache "
                f"!= target {target.kv_dtype_name} — KV moves never "
                "requantize"
            )

    @torch.no_grad()
    def migrate_to(self, target: "ServeEngine") -> dict:
        """Hand every unfinished request to ``target`` — a differently
        shaped engine (other slot count, other decode mode) over the same
        model — without dropping any of them.

        Suspended running slots move WITH their KV state (slab rows or
        page chains, int8 data with its scales), their speculative history
        and their host sampling state (seed, step, temperature, budget),
        and each request resumes mid-stream.  Queued requests transfer
        rid-intact, so every outstanding :class:`RequestHandle` stays
        valid.  Validation happens before any state moves (a failed
        migration leaves both engines untouched).  Every KV write into the
        target is in place, so a persistent target's captured graph stays
        valid.  Returns the JAX engine's summary dict.  Between engines
        whose KV heads split differently (``tp`` 2 -> 1) the rows are
        gathered over ``tp_axis`` and booked as ``all_gather``s of group
        ``g`` (``_kv_migration_group``); an equal split (or no mesh) is
        ``g = 1``: no wire, nothing booked."""
        if target is self:
            raise ValueError("cannot migrate an engine into itself")
        if target._draining:
            raise RuntimeError(
                "migration target is itself draining — migrate to a "
                "live engine"
            )
        if not self._draining:
            self.drain()
        now = time.monotonic()
        running = sorted(self.scheduler.running,
                         key=lambda r: (r.admitted_at or 0.0, r.rid))
        queued = self.scheduler.queued
        # -- validate everything before moving anything ------------------
        self._check_kv_compatible(target, "migrate")
        free_b = target.scheduler.free_slot_count
        if len(running) > free_b:
            raise RuntimeError(
                f"{len(running)} suspended request(s) need slots but the "
                f"target has only {free_b} free — drain(complete=True) "
                "further, or migrate to a larger engine"
            )
        if self.paged:
            need = sum(len(r.pages or ()) for r in running)
            if need > target.pool.free_count:
                raise RuntimeError(
                    f"suspended requests hold {need} KV page(s) but the "
                    f"target pool has only {target.pool.free_count} free"
                )
        for q in queued:
            if q.prompt.size > target.prefill_buckets[-1]:
                raise RuntimeError(
                    f"queued request {q.rid}: prompt ({q.prompt.size}) "
                    "exceeds the target's largest prefill bucket "
                    f"({target.prefill_buckets[-1]})"
                )
            if target.paged:
                need = -(-(q.cost) // target.page_size)
                if need > target.pool.capacity:
                    raise RuntimeError(
                        f"queued request {q.rid} needs {need} pages but "
                        f"the target pool holds only "
                        f"{target.pool.capacity}"
                    )
        # -- move suspended slots (KV + host sampling state) -------------
        wire = n_coll = pages_moved = 0
        for req in running:
            s_a, s_b, w, c, moved = self._move_running(target, req)
            wire += w
            n_coll += c
            pages_moved += moved
            req.record_event("migrated", ts=now, from_slot=s_a, to_slot=s_b)
            self.metrics.count("requests_migrated_out")
            target.metrics.count("requests_migrated_in")
        # -- move the queue (rid-intact, FCFS order preserved) -----------
        for req in self.scheduler.drain_queue():
            req.record_event("migrated", ts=now, queued=True)
            target.scheduler.adopt_queued(req)
            self.metrics.count("requests_migrated_out")
            target.metrics.count("requests_migrated_in")
        if self.paged and self.prefix_index is not None:
            # the source cache is decommissioned: release every page the
            # radix index kept for future hits
            self.prefix_index.evict(self.pool, self.pool.capacity)
        self.metrics.count("migration_wire_bytes", wire)
        return {
            "migrated_running": len(running),
            "migrated_queued": len(queued),
            "pages_moved": pages_moved,
            "wire_bytes": int(wire),
            "collectives": int(n_coll),
            "tp_from": self.tp,
            "tp_to": target.tp,
            "slots_from": self.num_slots,
            "slots_to": target.num_slots,
        }

    def _move_running(self, target: "ServeEngine", req: Request):
        """Move ONE running request's slot — KV state (slab row or page
        chain), speculative history and host sampling state — into
        ``target``.  The shared mechanics of :meth:`migrate_to` and
        :meth:`handoff_to`; the caller has validated capacity.  Returns
        ``(src_slot, dst_slot, wire_bytes, collectives, pages_moved)``."""
        s_a = req.slot
        pos_a = int(self.cache.pos[s_a])
        pages_a = list(req.pages) if (self.paged and req.pages) else None
        s_b = target.scheduler.adopt_running(req)  # sets req.slot
        if self.paged:
            new_pages = target.pool.alloc(len(pages_a))
            w, c = self._copy_kv_pages(target, pages_a, new_pages)
            target.cache.set_table(s_b, new_pages)
        else:
            w, c = self._copy_kv_slot(target, s_a, s_b)
        # detach from the source AFTER the copy; retire validates the
        # slot mapping, so point it at the source slot for the call
        req.slot = s_a
        self.scheduler.retire(req)
        req.slot = s_b
        self.cache.retire(s_a)
        if pages_a is not None:
            self.pool.decref(pages_a)
            req.pages = new_pages  # prefix-shared pages become private
        target.cache.admit(s_b, pos_a)
        for arr_a, arr_b in (
            (self._last_tok, target._last_tok),
            (self._temps, target._temps),
            (self._seeds, target._seeds),
            (self._ntok, target._ntok),
            (self._budget, target._budget),
        ):
            arr_b[s_b] = arr_a[s_a]
        if target._hist is not None:
            # in place: a persistent target holds its history by address
            if self._hist is not None:
                target._hist[s_b].copy_(self._hist[s_a])
            else:
                # the source keeps no history; it is the request's stream
                stream = np.concatenate([req.prompt, req.generated]).astype(np.int64)
                row = torch.zeros(target.max_len, dtype=torch.int64)
                n = min(stream.size, target.max_len)
                row[:n] = torch.as_tensor(stream[:n])
                target._hist[s_b].copy_(row)
        return s_a, s_b, w, c, len(pages_a) if pages_a is not None else 0

    @torch.no_grad()
    def handoff_to(self, target: "ServeEngine", req: Request) -> dict:
        """Hand ONE prefilled running request — KV pages (or slab row),
        speculative history and host sampling state — to ``target``: the
        prefill -> decode disaggregation step.  Unlike :meth:`migrate_to`
        this moves a single request between two LIVE engines: the source
        keeps admitting and prefilling, the target keeps decoding.  The
        greedy stream continues bit-identically on the target.  Returns
        ``{"from_slot", "to_slot", "wire_bytes", "collectives",
        "pages_moved"}`` (without a mesh the wire and the collectives are
        0, from the JAX engine's closed form)."""
        if target is self:
            raise ValueError("cannot hand a request off to its own engine")
        if target._draining:
            raise RuntimeError(
                "handoff target is draining — hand off to a live engine"
            )
        if req.slot is None or not any(r is req for r in self.scheduler.running):
            raise ValueError(f"request {req.rid} is not running on this engine")
        self._check_kv_compatible(target, "hand off")
        if target.scheduler.free_slot_count < 1:
            raise RuntimeError(
                f"handoff target has no free slot for request {req.rid}"
            )
        if self.paged and len(req.pages or ()) > target.pool.free_count:
            raise RuntimeError(
                f"request {req.rid} holds {len(req.pages or ())} KV "
                f"page(s) but the target pool has only "
                f"{target.pool.free_count} free"
            )
        now = time.monotonic()
        s_a, s_b, wire, n_coll, pages_moved = self._move_running(target, req)
        req.record_event("handoff", ts=now, from_slot=s_a, to_slot=s_b,
                         wire_bytes=wire)
        self.metrics.count("requests_handed_off")
        self.metrics.count("handoff_pages_moved", pages_moved)
        self.metrics.count("handoff_wire_bytes", wire)
        self.metrics.count("handoff_collectives", n_coll)
        target.metrics.count("requests_handed_in")
        return {
            "from_slot": s_a,
            "to_slot": s_b,
            "wire_bytes": int(wire),
            "collectives": int(n_coll),
            "pages_moved": int(pages_moved),
        }

    @staticmethod
    def _kv_migration_group(src: torch.Tensor, dst: torch.Tensor) -> int:
        """Ring gather group for moving one slot row / page chain between
        two KV arrays (the JAX engine's formula over the placements' split
        counts; dim 0, the slot / page index, is never split): 2 from a
        tp=2 cache into a whole one, 1 between equal splits."""
        src_c = _split_counts(src)[1:]
        tgt_c = _split_counts(dst)[1:]
        n_src = int(np.prod(src_c)) if src_c else 1
        keep = 1
        for a, b in zip(src_c, tgt_c):
            keep *= math.gcd(int(a), int(b))
        return max(1, n_src // max(1, keep))

    def _wire(self, src: torch.Tensor, dst: torch.Tensor, n: int):
        """The closed-form wire bytes and collectives of moving ``n`` units
        (slot rows or pages) of ``src`` into ``dst``, booked into the comm
        audit: a ring all-gather of group ``g`` moves ``unit * (g - 1) /
        g`` per unit (``unit``: one whole row or page, every rank's heads,
        at the array's own element size), none at g = 1."""
        from ..parallel.mesh import sharding_of

        g = self._kv_migration_group(src, dst)
        found = sharding_of(src)
        unit = int(np.prod((found[1] if found else src.shape)[1:])) * src.element_size()
        if g > 1 and n:
            record_collective("all_gather", self.tp_axis, payload_bytes=unit, count=n,
                              axis_size=g)
            return (unit * (g - 1) // g) * n, 1
        return 0, 0

    @staticmethod
    def _relayout(rows: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """Rows taken from ``src`` (its dim 0 selected) laid out as ``dst``
        holds them: gathered over the axes that split ``src``'s other
        dims, then cut to ``dst``'s piece (every rank of the mesh takes
        part in the gather)."""
        from ..parallel.mesh import sharding_of
        from ..parallel.plan import equivalent, gather_full

        s_found, d_found = sharding_of(src), sharding_of(dst)
        if s_found is None and d_found is None:
            return rows
        if s_found and d_found and equivalent(s_found[0], d_found[0], rows.ndim):
            return rows
        if s_found is not None:
            rows = gather_full(rows, s_found[0])
        if d_found is not None:
            shape = (rows.shape[0],) + tuple(d_found[1][1:])
            rows = rows[d_found[0].shard_slices(shape)]
        return rows

    def _copy_kv_slot(self, target, s_a: int, s_b: int):
        """Copy slab slot ``s_a``'s rows into ``target`` slot ``s_b``, in
        place, over each layer's FULL entry — ``(k, v)`` or the quantized
        ``(k, v, k_scale, v_scale)`` — so int8 data and its scales move
        together.  Returns (wire_bytes, collectives)."""
        wire = n_coll = 0
        for entry_a, entry_b in zip(self.cache.kv, target.cache.kv):
            for src, dst in zip(entry_a, entry_b):
                w, c = self._wire(src, dst, 1)
                wire += w
                n_coll += c
                dst[s_b].copy_(self._relayout(src[s_a:s_a + 1], src, dst)[0])
        return wire, n_coll

    def _copy_kv_pages(self, target, pages_a: List[int], pages_b: List[int]):
        """Copy a page chain between paged pools, in place (one gather and
        one ``index_copy_`` per layer and array, scales included).  Returns
        (wire_bytes, collectives)."""
        dev_a, dev_b = self.cache.kv[0][0].device, target.cache.kv[0][0].device
        idx_a = torch.as_tensor(pages_a, dtype=torch.long, device=dev_a)
        idx_b = torch.as_tensor(pages_b, dtype=torch.long, device=dev_b)
        wire = n_coll = 0
        for entry_a, entry_b in zip(self.cache.kv, target.cache.kv):
            for src, dst in zip(entry_a, entry_b):
                w, c = self._wire(src, dst, len(pages_a))
                wire += w
                n_coll += c
                rows = self._relayout(src.index_select(0, idx_a), src, dst)
                dst.index_copy_(0, idx_b, rows.to(dst.device))
        return wire, n_coll

    def finished_requests(self) -> List[Request]:
        """The bounded finished-request history (newest last)."""
        return list(self._finished)

    def dump_trace(self, path: str) -> str:
        """Export the host trace as a catapult/Perfetto ``traceEvents``
        JSON: the global tracer's spans (engine dispatches, anything else
        instrumented in-process) plus one thread row per finished request
        (queued/prefill/decode spans + lifecycle instants).  Request rows
        are exported even when tracing was disabled; enable tracing
        (``obs.trace.enable_tracing``) to get the dispatch spans too."""
        return get_tracer().export(
            path, extra_events=request_trace_events(self._finished)
        )

    def num_compiled_programs(self) -> int:
        """Programs behind THIS engine's geometry (module docstring): one
        per prefill bucket and family used, one per decode program used,
        and, on the card, one per CUDA graph a persistent engine of this
        geometry captured.  The contract is the JAX engine's: the count is
        STABLE after warm-up — a late admission never sets up a program."""
        static = self._static_key()
        programs = self.model.__dict__.get("_serve_programs", ())
        return sum(1 for key in programs if key[-len(static):] == static)

    def reset_metrics(self) -> ServeMetrics:
        """Rebind ``self.metrics`` to a fresh :class:`ServeMetrics` of THIS
        engine's geometry (slots, pages, ring, speculate); the KV gauges
        carry over."""
        self.metrics = self._new_metrics(self.metrics.kv_quant_err_max,
                                         self.metrics.kv_quant_err_rms)
        return self.metrics

    @property
    def loop_replays(self) -> int:
        """Persistent mode: loop iterations launched (CUDA graph replays
        on the card); equal to ``loop_iterations``, since the host never
        launches one past the loop's end.  0 in chunked mode."""
        return self._decode.replays if self._persistent else 0

    # -- programs, cost cards, the stall watchdog ------------------------

    def _static_key(self) -> tuple:
        """The engine's static geometry: programs of engines with equal
        keys are shared, as the JAX engine's jit store shares them."""
        # numerics keys the observatory: a digesting program has one more
        # output and never shares with the plain one (the JAX engine's key)
        return (self.num_slots, self.max_len, self.top_k, self.top_p,
                self.page_size, self.kv_dtype, self.numerics)

    def _note_program(self, key: tuple) -> bool:
        """Register ``key`` + the static key on the model; True when new."""
        programs = self.model.__dict__.setdefault("_serve_programs", set())
        full = tuple(key) + self._static_key()
        if full in programs:
            return False
        programs.add(full)
        return True

    def _card_begin(self, name: str):
        if not self._cards_on or name in self._carded:
            return None
        self._carded.add(name)
        try:
            return begin_allocator_card(name, self.device)
        except Exception:
            self.cost_card_errors += 1
            return None

    def _card_finish(self, card) -> None:
        if card is None:
            return
        try:
            finish_allocator_card(card, self.device, book=self.cost_book)
        except Exception:
            self.cost_card_errors += 1

    @contextlib.contextmanager
    def _dispatch(self, name: str, key: tuple, region: str, sink):
        """One device dispatch and its host sync: the ``timed_annotation``
        region (profiler range, tracer span, attribution scope, ``sink``),
        the stall watchdog, the program registry (a new program is
        reported to ``obs.recompile``'s watchers) and, at the program's
        first dispatch on the card, its cost card.  Yields the timing
        dict."""
        new = self._note_program(key)
        card = self._card_begin(name)
        t0 = time.perf_counter()
        with timed_annotation(region, sink) as timing, self._watch(name), \
                self._model_region():
            yield timing
            if new:
                note_compile(time.perf_counter() - t0)
        self._card_finish(card)

    def _watch(self, name: str):
        """The stall-watchdog guard for one dispatch+sync region (a no-op
        context when no watchdog is configured)."""
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.arm(name)

    # -- the admission gate and the memory plan --------------------------

    def _make_admission_gate(self):
        """The composed admission predicate ``Scheduler.admit`` runs on the
        FCFS head: draining first (a draining refusal reserves nothing a
        migration would unwind), then the HBM budget (a request the device
        cannot hold must not grab pages), then the paged engine's free
        pages.  The closure names its refusal in ``why``, which the
        scheduler writes into the request's lifecycle log.  It holds the
        engine by weakref: the engine holds the gate, and a cycle would
        keep a discarded engine (its cache, its captured graph) alive
        until a collection."""
        ref = weakref.ref(self)

        def gate(req: Request) -> bool:
            eng = ref()
            gate.why = "gate"
            if eng._draining:
                gate.why = "draining"
                return False
            if eng.hbm_budget is not None:
                if eng.memory_plan()["fits"] is False:
                    gate.why = "hbm_budget"
                    eng.metrics.count("admissions_rejected_hbm")
                    return False
            if eng.paged:
                return eng._page_gate(req)
            return True

        gate.why = "gate"
        return gate

    def memory_plan(self, budget_bytes: Optional[int] = None) -> dict:
        """The live capacity plan (``obs.memory.capacity_plan``): the
        weights + the KV slab or pools (+ the int8 scales as
        ``kv_scales``) + the worst per-program temp bytes the cost cards
        hold (``program_temp``, absent where no card has temp bytes: on the
        CPU, or with cards off), against ``budget_bytes`` /
        ``self.hbm_budget`` / the card's total (in that order).  What the
        admission gate refuses on.  The weights and KV components are
        computed once, then cached."""
        if self._static_footprint is None:
            self._static_footprint = {
                "weights": obs_memory.tree_device_bytes(self.params),
                "kv_cache": obs_memory.tree_device_bytes(
                    [e[:2] for e in self.cache.kv]),
            }
            if self.kv_quantized:
                self._static_footprint["kv_scales"] = (
                    obs_memory.tree_device_bytes([e[2:] for e in self.cache.kv]))
        components = dict(self._static_footprint)
        temp = self.cost_book.max_temp_bytes()
        if temp:
            components["program_temp"] = temp
        if budget_bytes is None:
            budget_bytes = self.hbm_budget
        plan = obs_memory.capacity_plan(components, budget_bytes=budget_bytes,
                                        device=self.device)
        plan["kv_cache_dtype"] = self.kv_dtype_name
        return plan

    # -- internals -------------------------------------------------------

    def _bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(
            f"prompt length {length} exceeds the largest prefill bucket "
            f"({self.prefill_buckets[-1]})"
        )

    def _prefill_chunks(self, start0: int, total: int) -> list:
        """Split ``total`` prefill tokens starting at cache position
        ``start0`` into ``(start, length)`` chunks of at most
        ``chunked_prefill`` tokens.  Every non-final chunk is exactly the
        threshold (a real bucket) and fits: ``start + C <= start0 + total
        <= max_len``.  A final chunk whose padded bucket would overrun
        ``max_len`` is folded into its predecessor, ending — at worst — at
        the one-chunk split, whose fit admission guaranteed."""
        c = self.chunked_prefill
        chunks = []
        s = 0
        while s < total:
            ln = min(c, total - s)
            chunks.append((start0 + s, ln))
            s += ln
        while len(chunks) > 1:
            st, ln = chunks[-1]
            if st + self._bucket_for(ln) <= self.max_len:
                break
            pst, pln = chunks[-2]
            chunks[-2:] = [(pst, pln + ln)]
        return chunks

    def _interleave_decode(self, req: Request) -> None:
        """One decode dispatch between two prefill chunks, skipping the
        half-prefilled request: active slots emit tokens while the long
        prompt is still landing.  Skipped when this request is the only
        one running.  The half-prefilled slot is not cache-admitted yet,
        so the dispatch's per-call ``active`` / ``finished`` staging
        freezes it (in persistent mode a staged input of the captured
        graph: no re-capture)."""
        if len(self.scheduler.running) > 1:
            self.metrics.count("prefill_interleaved_dispatches")
            self._decode_step(skip=req)

    def _sample_first(self, logits, true_len: int, temp: float, seed: int):
        """Sampler step 0 at the last real prompt position."""
        dev = logits.device
        return self._sampler(tap("logits", logits[:, true_len - 1, :]),
                             torch.tensor([temp], dtype=torch.float32, device=dev),
                             torch.tensor([seed], dtype=torch.int64, device=dev),
                             torch.zeros(1, dtype=torch.int64, device=dev))

    def _prefill(self, tokens, pfx: int, true_len: int, slot: int,
                 temp: float, seed: int) -> torch.Tensor:
        """The JAX engine's prefill programs: the padded bucket through
        ``forward_cached`` from cache position ``pfx``, sampled at
        ``true_len - 1`` (sampler step 0), its rows written into the slot.

        - ``pfx == 0`` (a cold prefill, or the first chunk of a cold
          prompt): a fresh (1, bucket) cache, the flash path; the slab
          takes the rows with ``write_slot``, the pools the bucket's rows.
        - ``pfx > 0``, paged (a prefix hit, or a later chunk): the slot's
          pages below ``pfx + bucket`` gathered (int8 dequantized into the
          model's dtype, which holds every ``int8 * 2^k`` exactly) and run
          at ``pfx`` on the plain path; only the bucket's rows are
          scattered back (shared prefix pages are never rewritten; padding
          rows past the chain land on the scratch page).
        - ``pfx > 0``, slab (a later chunk): the slot's row read as a view
          of the model's dtype, run at ``pfx`` on the plain path, and
          written back with ``write_slot`` (an unquantized row of the
          model's dtype is written in place already; int8 rows requantize
          bit-stably: power-of-two scales).

        Returns the (1,) token."""
        model, bucket = self.model, tokens.shape[1]
        dt = model.cfg.dtype
        if self.paged:
            n_pages = -(-(pfx + bucket) // self.page_size)
            table_row = torch.as_tensor(self.cache.page_tables[slot, :n_pages],
                                        device=self.device)
        if pfx == 0:
            view = init_kv(model, 1, bucket, self._kv_sharding)
        elif self.paged:
            view = [(k.to(dt), v.to(dt))
                    for k, v in paged_view(self.cache.kv, table_row, self.page_size)]
        else:
            view = []
            for e in self.cache.kv:
                if len(e) == 4:
                    k = dequantize_kv(e[0][slot:slot + 1], e[2][slot:slot + 1])
                    v = dequantize_kv(e[1][slot:slot + 1], e[3][slot:slot + 1])
                else:
                    k, v = e[0][slot:slot + 1], e[1][slot:slot + 1]
                view.append((k.to(dt), v.to(dt)))
        if pfx > 0:
            # mid-cache: the plain path, as the JAX package routes it
            self.plain_prefill_chunks += 1
        logits, view = model.forward_cached(tokens, view, pfx)
        tok = self._sample_first(logits, true_len, temp, seed)
        if self.paged:
            paged_scatter_rows(self.cache.kv, view, table_row, self.page_size,
                               pfx, bucket)
        else:
            write_slot(self.cache.kv, view, slot)
        return tok

    def _prefill_dispatch(self, req: Request, slot: int, start: int, ln: int,
                          final: bool):
        """One prefill program dispatch of ``req.prompt[start:start+ln]``
        at cache position ``start``; the token comes back as an int (one
        host sync) when ``final`` and not in persistent mode, else as the
        (1,) device tensor."""
        bucket = self._bucket_for(ln)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :ln] = req.prompt[start:start + ln]
        if self.paged:
            warm = start > 0
            name = "serve/prefill/{}/b{}".format("warm" if warm else "cold", bucket)
            key = ("serve_prefill_paged", bucket, warm)
        elif start > 0:
            name, key = f"serve/prefill/warm/b{bucket}", ("serve_prefill_warm", bucket)
        else:
            name, key = f"serve/prefill/b{bucket}", ("serve_prefill", bucket)
        with self._dispatch(name, key, "serve/prefill", self.metrics.prefill_s.record):
            tokens = torch.as_tensor(padded, device=self.device)
            # digested as tapped, not deferred: a prefill's KV error tensors
            # run to hundreds of MB at full width
            with (numerics_tape(sites=_NUMERICS_SITES, device=self.device)
                  if self.numerics else contextlib.nullcontext()) as tape:
                tok = self._prefill(tokens, start, ln, slot, req.temperature, req.seed)
            if tape is not None:
                self._stage_numerics(tape.digests())
            if final and not self._persistent:
                tok = int(tok[0].item())  # host sync: the first token exists
        self.metrics.count("tokens_prefilled", bucket)
        self._record_tp_collectives(bucket)
        return tok

    def _dispatch_prefill(self, req: Request, slot: int):
        """Prefill the request's prompt (paged: its uncached suffix) into
        ``slot``, in chunks when it is longer than ``chunked_prefill``.

        While chunks land the slot is PARKED at row ``max_len - 1``: every
        interleaved decode dispatch rewrites each slot's current row,
        inactive slots included, and a stale position could land that
        write inside an already-written chunk.  Row ``max_len - 1`` is
        safe: prefill never claims it (``prompt <= max_len - max_new <
        max_len``), a slab row is private to its slot, a paged slot's last
        table entry is the scratch page or the request's own tail page
        (never a shared prefix page), and the slot's own decode write
        replaces the row in the dispatch that first makes it visible.
        ``cache.admit`` restores the true position after the last chunk."""
        pfx = req.prefix_len if self.paged else 0
        total = req.prompt.size - pfx
        chunked = self.chunked_prefill is not None and total > self.chunked_prefill
        chunks = (self._prefill_chunks(pfx, total) if chunked
                  else [(pfx, total)])
        info = dict(bucket=self._bucket_for(chunks[0][1]), cold=pfx == 0)
        if self.paged:
            info["prefix_hit_tokens"] = pfx
            self.cache.set_table(slot, req.pages)
        if chunked:
            info["chunks"] = len(chunks)
        req.record_event("prefill", **info)
        if chunked:
            self.cache.pos[slot] = self.max_len - 1  # park (docstring)
            self.metrics.count("chunked_prefills")
        tok = None
        for i, (start, ln) in enumerate(chunks):
            if i > 0:
                self._interleave_decode(req)
            if chunked:
                req.record_event("prefill_chunk", start=start,
                                 bucket=self._bucket_for(ln))
            tok = self._prefill_dispatch(req, slot, start, ln,
                                         final=i == len(chunks) - 1)
            if chunked:
                self.metrics.count("prefill_chunks")
        if self.paged:
            self._adopt_prefix(req)
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
        tok = self._dispatch_prefill(req, slot)
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
        self._harvest_numerics()
        self._record_first(req, tok, now)
        self._check_finished(req, tok, now)
        self._record_drain()

    def _stage_numerics(self, digests) -> None:
        """Park one dispatch's digests with their copy to the host already
        queued (:class:`StagedDigests`), before the dispatch's own sync."""
        try:
            self._pending_digests.append(StagedDigests([digests]))
        except Exception:  # telemetry must not kill serving
            self.numerics_harvest_errors += 1

    def _harvest_numerics(self) -> None:
        """Fold every parked dispatch digest into ``numerics_book``: called
        only right after a counted ``host_syncs``, which the copies queued
        at staging came before, so reading them copies nothing and waits
        on nothing (no sync of its own, counted or not).  A KV dequantization
        error above the round-to-nearest bound ``s / 2`` (``s`` the largest
        scale seen) records ONE ``kv_quant_err`` flight anomaly per
        engine.  A failed harvest loses a window, never the run."""
        if not self._pending_digests:
            return
        pend, self._pending_digests = self._pending_digests, []
        trees = None
        try:
            trees = [tree for staged in pend for tree in staged.read()]
        except Exception:  # telemetry must not kill serving
            self.numerics_harvest_errors += 1
        if self.tp > 1:
            # outside the try: every rank folds at every harvest, in the
            # same order, or its peers wait in the fold for ever
            trees = self._fold_tp_digests(trees, len(pend))
        if trees is None:
            return
        try:
            for tree in trees:
                self.numerics_book.update_tree(tree)
            book = self.numerics_book
            err = book.digest("kv_quant_err")
            if err is not None and err.count:
                self.metrics.observe_kv_quant(err.max_abs, err.rms)
                sc = book.digest("kv_quant_scale")
                bound = 0.5 * sc.max_abs if sc is not None else None
                if (bound and err.max_abs > bound * (1.0 + 1e-6)
                        and not self._kv_quant_alarmed):
                    self._kv_quant_alarmed = True
                    from ..obs.flight import get_flight_recorder

                    get_flight_recorder().record(
                        "anomaly", anomaly="kv_quant_err",
                        err_max=float(err.max_abs), bound=float(bound))
            book.emit_counter_tracks(get_tracer())
        except Exception:  # telemetry must not kill serving
            self.numerics_harvest_errors += 1

    def _fold_tp_digests(self, trees, n: int):
        """The harvest's ``n`` digest trees (None: this rank's read failed,
        and it folds zeros) with the KV sites summed over ``tp`` into the
        whole cache's, as the JAX engine digests its global arrays: the
        host copies as they are, over the ``gloo`` group."""
        from ..obs.numerics import fold_host_digests

        with self.mesh:
            folded = fold_host_digests(trees if trees is not None else [{}] * n,
                                       _TP_FOLDED_SITES, (self.tp_axis,))
        return folded if trees is not None else None

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

    def _decode_step(self, skip: Optional[Request] = None) -> None:
        """One decode dispatch: ``K = decode_chunk`` steps (speculative
        iterations with ``speculate``), ONE host sync for the token block,
        then the host walk with the finish rules the device mask applied
        (``_check_finished``).  ``skip`` is a half-prefilled request (an
        interleaved dispatch of chunked prefill): it and every slot not
        cache-admitted yet are frozen on the device and left out of the
        walk.  Persistent mode: ``_persistent_step``."""
        if self._persistent:
            return self._persistent_step(skip)
        running = self.scheduler.running
        k_steps = self.decode_chunk
        if self.speculate:
            name = f"serve/decode/spec{self.speculate}/k{k_steps}"
            key = ("serve_decode_spec", k_steps, self.eos_token, self.speculate,
                   self.spec_ngram)
        else:
            name = f"serve/decode/k{k_steps}"
            key = ("serve_decode", k_steps, self.eos_token)
        with self._dispatch(name, key, "serve/decode",
                            self.metrics.decode_s.record) as timing:
            out = self._decode(self.cache.kv, *self._decode_args())
            self.cache.kv = out[0]
            if self.numerics:
                self._stage_numerics(out[-1])
            if self.speculate:
                self._hist = out[3]
                ys, cs = (t.cpu().numpy() for t in out[1:3])  # ONE host sync
            else:
                block = out[1].cpu().numpy()  # ONE host sync per K slot-steps
        self.metrics.count("host_syncs")
        self._harvest_numerics()
        self.metrics.count("decode_dispatches")
        self.metrics.count("decode_steps", k_steps)
        self._record_tp_collectives(self.num_slots * (self.speculate + 1), k_steps)
        now = time.monotonic()
        emitted = 0
        for req in running:
            if req is skip or not self.cache.active[req.slot]:
                # not cache-admitted yet: the half-prefilled request or a
                # same-batch admit this dispatch ran ahead of
                continue
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
            self.metrics.decode_token_s.record(timing["seconds"] / emitted)
        self._record_drain()

    def _persistent_step(self, skip: Optional[Request] = None) -> None:
        """One persistent dispatch: the loop runs on the card until every
        slot's finish bit is set or the ring is full, then ONE host sync
        drains the ring, its valid mask (speculation: the count ring), the
        cursor and every pending first token together.  The walk applies
        the finish rules the device mask applied, bounded by the mask (True
        exactly on the rows a live slot sampled, the finishing token
        included), so host bookkeeping and device carries agree iteration
        for iteration.  A request the ring cut off stays running and
        continues from its frozen carry at the next dispatch.  ``skip``
        (a half-prefilled request) is not cache-admitted, so the staged
        ``active`` input freezes it; the walk leaves it out.  Shared by
        the one-token and the speculative loop, as the chunked walk is."""
        running = self.scheduler.running
        cache, dev = self.cache, self.device
        pending = self._pending_first
        args = [self._last_tok, cache.positions(), self._hist, self._temps,
                self._seeds, self._ntok, self._budget,
                # the cache-full rule from the UNCLAMPED host positions
                cache.active & (cache.pos < self.max_len)]
        if self.paged:
            args.append(cache.page_tables)
        if self.speculate:
            name = (f"serve/decode/persistent/spec{self.speculate}"
                    f"/r{self.ring_capacity}")
            key = ("serve_decode_persistent_spec", self.ring_capacity,
                   self.eos_token, self.speculate, self.spec_ngram)
        else:
            name = f"serve/decode/persistent/r{self.ring_capacity}"
            key = ("serve_decode_persistent", self.ring_capacity, self.eos_token)
        captured = self._graph_captures()
        with self._dispatch(name, key, "serve/decode",
                            self.metrics.decode_s.record) as timing:
            out = self._decode(cache.kv, *args, firsts=pending)
            _, ring, marks, it = out[:4]
            if self.numerics:
                self._stage_numerics(out[4])
            if self._graph_captures() > captured:
                # this engine's own CUDA graph: a program of its own
                self._note_program(("graph", self._serial))
                note_compile()
            slots = list(pending)
            firsts = (torch.cat([pending[s] for s in slots]) if slots
                      else torch.zeros(0, dtype=torch.int64, device=dev))
            # ONE host sync: the ring, its marks, the cursor, the first tokens
            flat = torch.cat([ring.reshape(-1), marks.reshape(-1).long(), it,
                              firsts.long()]).cpu().numpy()
        n_ring, n_marks = ring.numel(), marks.numel()
        block = flat[:n_ring].reshape(ring.shape)
        marks = flat[n_ring:n_ring + n_marks].reshape(marks.shape)
        n_it = int(flat[n_ring + n_marks])
        firsts = dict(zip(slots, flat[n_ring + n_marks + 1:].tolist()))
        pending.clear()
        self.stream_events = []
        self.poll_stream()
        self.metrics.count("host_syncs")  # the drain IS the sync
        self._harvest_numerics()
        self.metrics.count("ring_drains")
        self.metrics.count("decode_dispatches")
        self.metrics.count("decode_steps", n_it)
        self.metrics.count("loop_iterations", n_it)
        self._record_tp_collectives(self.num_slots * (self.speculate + 1), n_it)
        self.metrics.observe_ring(n_it)
        now = time.monotonic()
        # the streamed tail: iteration 0's stamp is when the wave's first
        # tokens existed on the host, earlier than the drain
        first_ts = min(now, self.stream_events[0][0]) if self.stream_events else now
        emitted = 0
        any_cut = False
        for req in running:
            if req is skip:
                continue  # half-prefilled: frozen by the staged active mask
            slot = req.slot
            taken = 0
            finished = False
            if slot in firsts:
                tok = firsts[slot]
                self._record_first(req, tok, first_ts)
                # fin0 froze an EOS first token or a spent one-token budget
                # before iteration 0: the slot idled the whole loop
                finished = self._check_finished(req, tok, first_ts)
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
            self.metrics.decode_token_s.record(timing["seconds"] / emitted)
        self._record_drain()

    def _graph_captures(self) -> int:
        loop = getattr(self._decode, "loop", None)
        return 0 if loop is None else loop.captures

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
            self._harvest_numerics()
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
        if self._bb_on:
            # retired from scheduler.running before the walk's drain fold:
            # kept here so the fold still sees its last tokens
            self._bb_finished_pending.append(req)
