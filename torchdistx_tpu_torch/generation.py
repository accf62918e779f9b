"""Autoregressive generation with a static-shape KV cache, counterpart of
``torchdistx_tpu/generation.py`` (the decoder-only paths the serving engine
uses; encoder-decoder generation, ``generate_encdec``, is not ported yet
and raises).

PyTorch runs eagerly, so the JAX package's ``lax.scan`` loops are Python
loops here; the caches are updated in place.  Its ``lax.while_loop`` (the
persistent decode) is one guarded iteration over a device-resident loop
state, captured in a CUDA graph and replayed (``serve.graph_loop``); on the
CPU the same iteration runs eagerly.

**Sampling.**  Greedy rows take the argmax, exactly as the JAX package does,
so greedy token ids agree with it wherever the logits do.  A sampled row
takes the argmax of the tempered, filtered logits plus Gumbel noise whose
bits come from a counter-based hash of ``(seed, step, vocab index)``:
Threefry-2x32 (20 rounds) written in integer tensor ops, so the CPU and
CUDA give the same bits.  Every row computes its noise and ``torch.where``
picks the drawn or the greedy token: the sampler reads nothing back and
can be captured.  A request's sampled stream depends only on its seed and
token index, never on its slot, its batch-mates or the decode chunking; it
does not reproduce ``jax.random``'s bits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


__all__ = ["generate", "generate_encdec"]


def _apply_top_k(logits, top_k: int):
    top_k = min(int(top_k), logits.shape[-1])  # clamp to vocab
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def _apply_top_p(logits, top_p: float):
    """Nucleus filtering: keep the smallest prefix of the sorted
    distribution whose mass reaches ``top_p`` (always at least top-1)."""
    sorted_l, sort_idx = torch.sort(logits, dim=-1, descending=True)
    probs = torch.softmax(sorted_l, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p
    keep[..., 0] = True
    masked = sorted_l.masked_fill(~keep, float("-inf"))
    return torch.empty_like(masked).scatter_(-1, sort_idx, masked)


def _check_sampling_args(top_k, top_p) -> None:
    if top_k is not None and top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


_MASK32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA


def _rotl32(x, r: int):
    return ((x << r) & _MASK32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 block cipher, 20 rounds (Salmon et al., SC'11; the
    block ``jax.random`` is built on), on 32-bit lanes held in int64
    tensors: add, xor, shift and mask only, and no product, so the CPU and
    CUDA give the same bits.  Key ``(k0, k1)``, counter ``(x0, x1)``, all
    in ``[0, 2^32)`` and broadcast together; returns the two output
    words."""
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = (x0 + k0) & _MASK32
    x1 = (x1 + k1) & _MASK32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x0, x1


def _noise_bits(seeds, steps, vocab: int):
    """(B, vocab) int64 random words in ``[0, 2^32)``: lanes ``2j`` and
    ``2j + 1`` of row ``b`` are the two words of the Threefry block keyed
    on ``(seeds[b], steps[b])`` at counter ``(j, 0)``.  A lane's bits
    depend on its row's seed and step and its own index alone."""
    k0 = (seeds.long() & _MASK32)[:, None]
    k1 = (steps.long() & _MASK32)[:, None]
    j = torch.arange((vocab + 1) // 2, dtype=torch.int64, device=seeds.device)[None, :]
    y0, y1 = threefry2x32(k0, k1, j, torch.zeros_like(j))
    return torch.stack((y0, y1), dim=-1).reshape(seeds.shape[0], -1)[:, :vocab]


def _gumbel_noise(seeds, steps, vocab: int):
    """(B, vocab) f32 Gumbel noise ``-log(-log(u))`` from the top 23 bits
    of :func:`_noise_bits`: ``u = (m + 1/2) / 2^23`` lies strictly inside
    (0, 1) and is exact in f32."""
    u = ((_noise_bits(seeds, steps, vocab) >> 9).float() + 0.5) * 2.0 ** -23
    return -torch.log(-torch.log(u))


def _make_slot_sampler(top_k: Optional[int] = None,
                       top_p: Optional[float] = None):
    """Per-row sampler: ``sample(logits, temps, seeds, steps)`` with
    ``logits`` (B, V) and ``temps`` (f32), ``seeds``, ``steps`` (integer)
    (B,) tensors on ``logits.device``.  Rows with ``temps[b] <= 0`` take the
    argmax; the rest take the argmax of their tempered, filtered logits
    plus Gumbel noise keyed on ``(seeds[b], steps[b])``.  Every row computes
    both; nothing is read back to the host.  Returns (B,) int64 token ids."""

    def sample(logits, temps, seeds, steps):
        greedy = torch.argmax(logits, dim=-1)
        scaled = logits.float() / temps.float().clamp_min(1e-6)[:, None]
        if top_k is not None:
            scaled = _apply_top_k(scaled, top_k)
        if top_p is not None:
            scaled = _apply_top_p(scaled, top_p)
        noise = _gumbel_noise(seeds, steps, scaled.shape[-1])
        drawn = torch.argmax(scaled + noise, dim=-1)
        return torch.where(temps > 0.0, drawn, greedy)

    return sample


def _make_decode_body(model, sampler, *, eos_token: Optional[int],
                      max_len: int):
    """The ONE decode iteration both decode modes share: one batched
    ``forward_decode`` + slot-sampler step over the carry ``(kv, tok, pos,
    stp, fin)`` (device tensors, the cache updated in place), with the
    on-device finish rules: EOS, budget, and ``pos + 1 >= max_len``; a
    finished slot freezes (token, position and step held, position clamped
    like ``SlotKVCache.positions()``).  The sampler keys on the carried
    step ``stp``.  ``temps``, ``seeds`` and ``budgets`` are (B,) device
    tensors; ``extra`` is forwarded to ``forward_decode``: the page tables
    of a paged cache."""

    def step(carry, *, temps, seeds, budgets, extra=()):
        kv, tok, pos, stp, fin = carry
        logits, kv = model.forward_decode(tok[:, None], kv, pos, *extra)
        sampled = sampler(logits[:, -1, :], temps, seeds, stp)
        new_tok = torch.where(fin, tok, sampled)
        new_stp = torch.where(fin, stp, stp + 1)
        if eos_token is not None:
            hit_eos = sampled == eos_token
        else:
            hit_eos = torch.zeros_like(fin)
        hit_len = new_stp >= budgets
        hit_full = pos + 1 >= max_len
        new_fin = fin | hit_eos | hit_len | hit_full
        new_pos = torch.where(fin, pos, torch.clamp(pos + 1, 0, max_len - 1))
        return (kv, new_tok, new_pos, new_stp, new_fin)

    return step


def _make_fused_decode(model, sampler, *, eos_token: Optional[int],
                       max_len: int, decode_chunk: int):
    """``decode_chunk`` decode iterations in a Python loop with no host sync
    inside it.  Returns ``run(kv, toks, positions, temps, seeds, steps,
    budgets, finished, *extra) -> (kv, (K, B) token block)``, every input
    a device tensor.  ``extra`` is empty for the slab; the paged engine
    passes its device page tables there, invariant over the chunk (a
    request's whole footprint is allocated at admission)."""
    step = _make_decode_body(model, sampler, eos_token=eos_token,
                             max_len=max_len)

    @torch.no_grad()
    def run(kv, toks, positions, temps, seeds, steps, budgets, finished,
            *extra):
        carry = (kv, toks, positions, steps, finished)
        block = []
        for _ in range(decode_chunk):
            carry = step(carry, temps=temps, seeds=seeds, budgets=budgets,
                         extra=extra)
            block.append(carry[1])
        return carry[0], torch.stack(block)

    return run


def _make_spec_decode_body(model, sampler, *, eos_token: Optional[int],
                           max_len: int, speculate: int, ngram: int = 2):
    """Self-speculative draft / verify / accept iteration, the
    variable-advance sibling of ``_make_decode_body``, with no host sync:

    1. DRAFT ``speculate`` tokens per slot by prompt lookup: the most recent
       earlier occurrence of the slot's trailing ``ngram`` tokens in its own
       (B, max_len) token history ``hist``, and the tokens that followed it
       (garbage where nothing matches: it just verifies to accept length 0).
    2. VERIFY the pending token plus the drafts in ONE (B, K+1)
       ``forward_decode``, query row ``i`` masked to its own depth
       ``pos + i``.
    3. ACCEPT the longest draft prefix equal to the greedy targets of the
       previous row: ``e = accepted + 1`` tokens.  Sampled rows force
       accept length 0, so their ``(seed, step)`` keys are untouched.  ``e``
       is truncated by the host walk's finish rules (first EOS in the
       block, remaining budget, cache end), so a slot finishes only at the
       last token of an iteration.

    ``step(carry, *, temps, seeds, budgets, extra)`` takes the carry
    ``(kv, tok, pos, stp, fin, hist)`` and returns ``(carry, y_block,
    cnt)``: the (B, K+1) verified tokens and the per-slot emitted count (0
    for frozen slots).  The sampler keys on the carried step ``stp``: a
    live sampled row advances exactly one token per iteration."""
    if speculate < 1:
        raise ValueError(f"speculate must be >= 1, got {speculate}")
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")

    def step(carry, *, temps, seeds, budgets, extra=()):
        kv, tok, pos, stp, fin, hist = carry
        b = tok.shape[0]
        dev = tok.device
        rows = torch.arange(b, device=dev)
        # the pending token enters the history at its own stream index
        hist = hist.clone()
        hist[rows, pos.clamp(0, max_len - 1)] = tok

        # -- draft: most recent earlier occurrence of the trailing n-gram
        idx = torch.arange(max_len, device=dev)[None, :]
        match = (idx >= ngram - 1) & (idx < pos[:, None])
        for d in range(ngram):
            shifted = hist if d == 0 else torch.nn.functional.pad(hist, (d, 0))[:, :max_len]
            tgt = torch.gather(hist, 1, (pos - d).clamp(0, max_len - 1)[:, None])
            match = match & (shifted == tgt)
        j_best = torch.where(match, idx, torch.full_like(idx, -1)).amax(dim=1)
        ahead = torch.arange(speculate, device=dev)[None, :]
        draft = torch.gather(
            hist, 1, (j_best[:, None] + 1 + ahead).clamp(0, max_len - 1))

        # -- verify: one (B, K+1) forward through slot_cached_attention
        qtok = torch.cat([tok[:, None], draft.to(tok.dtype)], dim=1)
        logits, kv = model.forward_decode(qtok, kv, pos, *extra)
        y1 = sampler(logits[:, 0, :], temps, seeds, stp)
        gre = torch.argmax(logits, dim=-1).to(tok.dtype)
        y_block = torch.cat([y1.to(tok.dtype)[:, None], gre[:, 1:]], dim=1)

        # -- accept: longest draft prefix matching the greedy targets
        m = (qtok[:, 1:] == y_block[:, :speculate]) & (temps <= 0.0)[:, None]
        acc = torch.cumprod(m.long(), dim=1).sum(dim=1)
        e = acc + 1
        jj = torch.arange(1, speculate + 2, device=dev)[None, :]
        if eos_token is not None:
            first_eos = torch.where(y_block == eos_token, jj,
                                    torch.full_like(jj, speculate + 2)).amin(dim=1)
            e = torch.minimum(e, first_eos)
        e = torch.minimum(e, budgets - stp)
        e = torch.minimum(e, max_len - pos)
        e = e.clamp(min=1)
        last = torch.gather(y_block, 1, (e - 1)[:, None])[:, 0]

        # emitted tokens extend the history at pos + 1 .. pos + e; rejected
        # lanes, frozen slots and rows past max_len leave it as it was
        offs = idx - pos[:, None] - 1  # (B, max_len): lane of each column
        emitted = (offs >= 0) & (offs < e[:, None]) & (~fin)[:, None]
        lanes = torch.gather(y_block, 1, offs.clamp(0, speculate))
        hist = torch.where(emitted, lanes.to(hist.dtype), hist)

        new_tok = torch.where(fin, tok, last)
        new_stp = torch.where(fin, stp, stp + e)
        if eos_token is not None:
            hit_eos = last == eos_token
        else:
            hit_eos = torch.zeros_like(fin)
        hit_len = new_stp >= budgets
        hit_full = pos + e >= max_len
        new_fin = fin | hit_eos | hit_len | hit_full
        new_pos = torch.where(fin, pos, (pos + e).clamp(0, max_len - 1))
        cnt = torch.where(fin, torch.zeros_like(e), e)
        return (kv, new_tok, new_pos, new_stp, new_fin, hist), y_block, cnt

    return step


def _make_fused_spec_decode(model, sampler, *, eos_token: Optional[int],
                            max_len: int, decode_chunk: int, speculate: int,
                            ngram: int = 2):
    """``decode_chunk`` speculative iterations (``_make_spec_decode_body``)
    with no host sync inside.  Returns ``run(kv, toks, positions, hist,
    temps, seeds, steps, budgets, finished, *extra) -> (kv, (chunk, B, K+1)
    token blocks, (chunk, B) counts, hist)``, every input a device tensor:
    ``hist`` the (B, max_len) history with every emitted token in place, the
    next dispatch's input."""
    step = _make_spec_decode_body(model, sampler, eos_token=eos_token,
                                  max_len=max_len, speculate=speculate,
                                  ngram=ngram)

    @torch.no_grad()
    def run(kv, toks, positions, hist, temps, seeds, steps, budgets,
            finished, *extra):
        carry = (kv, toks, positions, steps, finished, hist)
        ys, cs = [], []
        for _ in range(decode_chunk):
            carry, y_block, cnt = step(carry, temps=temps, seeds=seeds,
                                       budgets=budgets, extra=extra)
            ys.append(y_block)
            cs.append(cnt)
        return carry[0], torch.stack(ys), torch.stack(cs), carry[5]

    return run


class _PersistentDecode:
    """The persistent decode of ``_make_persistent_decode`` /
    ``_make_persistent_spec_decode``: the SAME decode body the chunked mode
    runs, iterated until every slot has finished or the output ring is
    full, over a loop state that lives on the device at fixed addresses.

    Loop state: the carry (``tok``, ``pos``, ``stp``, ``fin``, and the
    caller's ``hist`` for speculation), the ring (``(ring_capacity, B)``
    tokens and a ``valid`` mask, True where the slot was live when the
    iteration sampled, the finishing token included; speculation keeps a
    ``(ring_capacity, B, K+1)`` block ring and a ``(ring_capacity, B)``
    count ring, ``cnts > 0`` being the valid mask), the cursor ``it`` and
    the static inputs (``temps``, ``seeds``, ``budgets``, page tables).
    One iteration is guarded by ``go = ~all(fin) & (it < ring_capacity)``:
    an iteration past the fixpoint changes no carry, ring row or cursor (it
    only rewrites each slot's next row of the cache with what the next live
    iteration writes there, as the chunked engine's frozen steps do), so
    the iteration count equals the JAX ``while_loop``'s.  The ring is
    linear per call: a request outliving it continues from its carry at the
    next call.

    ``serve.graph_loop.GraphLoop`` runs the iteration: on CUDA one
    iteration captured in a CUDA graph and replayed, on the CPU the same
    iteration eagerly.  A call takes the host arrays of the JAX program's
    inputs (``hist`` a device tensor or None), stages them into the static
    state, splices ``firsts`` (slot -> (1,) device token: the prefill's
    first tokens the host has not fetched) into ``tok``, and computes the
    initial finish mask ON DEVICE, ``~active | steps >= budgets | tok ==
    eos``; ``active`` must carry the cache-full rule from the unclamped host
    positions.  It returns ``(kv, ring, valid, iterations)`` device tensors,
    the rings cut to the host's bound on the iterations (the rows past the
    cursor are zeros).  The cache tensors and ``hist`` are held by address:
    passing others after the first call raises."""

    def __init__(self, step, *, eos_token: Optional[int], max_len: int,
                 ring_capacity: int, speculate: int = 0):
        if ring_capacity < 1:
            raise ValueError(f"ring_capacity must be >= 1, got {ring_capacity}")
        self.step = step
        self.eos_token = eos_token
        self.max_len = int(max_len)
        self.ring_capacity = int(ring_capacity)
        self.speculate = int(speculate)
        self.loop = None  # serve.graph_loop.GraphLoop, at the first call

    @property
    def replays(self) -> int:
        """Iterations launched so far (CUDA graph replays on the card)."""
        return 0 if self.loop is None else self.loop.replays

    def _allocate(self, kv, hist, b: int, tables, device) -> None:
        from .serve.graph_loop import GraphLoop

        cuda = device.type == "cuda"
        ring_shape = (self.ring_capacity, b)
        if self.speculate:
            ring_shape += (self.speculate + 1,)
        # host staging: tok, pos, stp, budgets, seeds, active in one pinned
        # buffer, one copy per call
        self._host_ints = torch.zeros((6, b), dtype=torch.int64, pin_memory=cuda)
        self._host_temps = torch.zeros(b, dtype=torch.float32, pin_memory=cuda)
        self._ints = torch.zeros((6, b), dtype=torch.int64, device=device)
        self.tok, self.pos, self.stp, self.budgets, self.seeds, self.active = self._ints
        self.temps = torch.zeros(b, dtype=torch.float32, device=device)
        self.fin = torch.zeros(b, dtype=torch.bool, device=device)
        self.ring = torch.zeros(ring_shape, dtype=torch.int64, device=device)
        self.valid = torch.zeros(ring_shape[:2],
                                 dtype=torch.int64 if self.speculate else torch.bool,
                                 device=device)
        self.it = torch.zeros(1, dtype=torch.int64, device=device)
        self.done = torch.zeros(1, dtype=torch.bool, device=device)
        self.tables = self._host_tables = None
        if tables is not None:
            tables = np.asarray(tables)
            self._host_tables = torch.zeros(tables.shape, dtype=torch.int32,
                                            pin_memory=cuda)
            self.tables = torch.zeros(tables.shape, dtype=torch.int32, device=device)
        self.kv, self.hist = kv, hist
        self._held = self._addresses(kv, hist)
        self.loop = GraphLoop(cursor=self.it, capacity=self.ring_capacity,
                              done=self.done)

    @staticmethod
    def _addresses(kv, hist):
        ptrs = [t.data_ptr() for entry in kv for t in entry]
        return ptrs + ([] if hist is None else [hist.data_ptr()])

    def _iteration(self) -> None:
        """One guarded iteration over the static state, in place."""
        fin, it, cap = self.fin, self.it, self.ring_capacity
        go = ~fin.all() & (it[0] < cap)
        extra = () if self.tables is None else (self.tables,)
        carry = (self.kv, self.tok, self.pos, self.stp, fin)
        if self.speculate:
            carry, row, mark = self.step(carry + (self.hist,), temps=self.temps,
                                         seeds=self.seeds, budgets=self.budgets,
                                         extra=extra)
        else:
            live = ~fin
            carry = self.step(carry, temps=self.temps, seeds=self.seeds,
                              budgets=self.budgets, extra=extra)
            row, mark = carry[1], live
        at = it.clamp(max=cap - 1)
        for ring, new in ((self.ring, row), (self.valid, mark)):
            ring.index_copy_(0, at, torch.where(go, new[None], ring.index_select(0, at)))
        state = (self.tok, self.pos, self.stp, fin)
        if self.speculate:
            state += (self.hist,)
        for dst, new in zip(state, carry[1:]):
            dst.copy_(torch.where(go, new, dst))
        it.add_(go.long())
        self.done.copy_(fin.all() | (it >= cap))

    def _bounds(self, positions, steps, budgets, active, pending):
        """(fewest, most) iterations this call can take, from the host
        arrays: a live slot finishes within ``min(budget - steps, max_len -
        pos)`` iterations and, advancing at most ``speculate + 1`` tokens an
        iteration, takes at least that over ``speculate + 1``; an EOS can
        end any slot at its next iteration, so with one only a live slot
        whose last token the host knows guarantees one iteration."""
        live = active & (steps < budgets)
        if not live.any():
            return 0, 0
        left = np.minimum(budgets - steps, self.max_len - positions)[live]
        most = min(self.ring_capacity, int(left.max()))
        if self.eos_token is not None:
            known = live.copy()
            known[list(pending)] = False
            return int(known.any()), most
        fewest = -(-left // (self.speculate + 1))
        return min(most, int(fewest.max())), most

    @torch.no_grad()
    def __call__(self, kv, toks, positions, hist, temps, seeds, steps, budgets,
                 active, *extra, firsts=None):
        firsts = firsts or {}
        device = kv[0][0].device
        tables = extra[0] if extra else None
        if self.loop is None:
            self._allocate(kv, hist, len(toks), tables, device)
        elif self._addresses(kv, hist) != self._held:
            raise ValueError(
                "the cache or the history was rebound: the persistent loop "
                "holds the tensors of its first call by address"
            )
        positions = np.asarray(positions, np.int64)
        steps = np.asarray(steps, np.int64)
        budgets = np.asarray(budgets, np.int64)
        active = np.asarray(active, bool)
        staged = self._host_ints.numpy()
        for i, a in enumerate((toks, positions, steps, budgets, seeds, active)):
            staged[i] = a
        self._host_temps.numpy()[:] = temps
        self._ints.copy_(self._host_ints, non_blocking=True)
        self.temps.copy_(self._host_temps, non_blocking=True)
        if tables is not None:
            self._host_tables.numpy()[:] = tables
            self.tables.copy_(self._host_tables, non_blocking=True)
        for slot, tok in firsts.items():
            self.tok[slot:slot + 1].copy_(tok)
        fin = (self.active == 0) | (self.stp >= self.budgets)
        if self.eos_token is not None:
            fin |= self.tok == self.eos_token
        self.fin.copy_(fin)
        self.ring.zero_()
        self.valid.zero_()
        self.it.zero_()
        self.done.copy_(self.fin.all())
        fewest, most = self._bounds(positions, steps, budgets, active, firsts)
        self.loop.run(self._iteration, fewest, most)
        return kv, self.ring[:most], self.valid[:most], self.it


def _make_persistent_decode(model, sampler, *, eos_token: Optional[int],
                            max_len: int, ring_capacity: int):
    """The persistent decode program (JAX: ``lax.while_loop`` over
    ``_make_decode_body``): ``run(kv, toks, positions, None, temps, seeds,
    steps, budgets, active, *extra, firsts=) -> (kv, ring, valid,
    iterations)``; see :class:`_PersistentDecode`."""
    step = _make_decode_body(model, sampler, eos_token=eos_token,
                             max_len=max_len)
    return _PersistentDecode(step, eos_token=eos_token, max_len=max_len,
                             ring_capacity=ring_capacity)


def _make_persistent_spec_decode(model, sampler, *, eos_token: Optional[int],
                                 max_len: int, ring_capacity: int,
                                 speculate: int, ngram: int = 2):
    """The persistent speculative decode (``_make_spec_decode_body`` under
    the same loop): ``run(kv, toks, positions, hist, temps, seeds, steps,
    budgets, active, *extra, firsts=) -> (kv, ring, cnts, iterations)``,
    one ring row per ITERATION (up to ``speculate + 1`` tokens each)."""
    step = _make_spec_decode_body(model, sampler, eos_token=eos_token,
                                  max_len=max_len, speculate=speculate,
                                  ngram=ngram)
    return _PersistentDecode(step, eos_token=eos_token, max_len=max_len,
                             ring_capacity=ring_capacity, speculate=speculate)


@torch.no_grad()
def generate(model, prompt, max_new_tokens: int, *, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             seed: int = 0, device=None):
    """Generate ``max_new_tokens`` continuations of ``prompt`` (B, S).
    ``temperature == 0`` is greedy; otherwise token ``i`` of every row is
    sampled with noise keyed on ``(seed, i)``.  ``device`` defaults to the
    model's.  Returns (B, S + max_new_tokens) int64 on that device."""
    _check_sampling_args(top_k, top_p)
    device = torch.device(device) if device is not None else model.device
    prompt = torch.as_tensor(np.asarray(prompt), device=device).long()
    b, s = prompt.shape
    if max_new_tokens <= 0:
        return prompt
    limit = model.cfg.max_seq_len
    if s + max_new_tokens > limit:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"model's maximum sequence length {limit}"
        )
    sample = _make_slot_sampler(top_k, top_p)
    temps = torch.full((b,), temperature, dtype=torch.float32, device=device)
    seeds = torch.full((b,), seed, dtype=torch.int64, device=device)
    cache = model.init_cache(b, s + max_new_tokens)
    logits, cache = model.forward_cached(prompt, cache, 0)
    toks = []
    for i in range(max_new_tokens):
        tok = sample(logits[:, -1], temps, seeds, torch.full_like(seeds, i))
        toks.append(tok)
        if i + 1 < max_new_tokens:
            logits, cache = model.forward_cached(tok[:, None], cache, s + i)
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)


def generate_encdec(model, enc_tokens, max_new_tokens: int, **kwargs):
    """Encoder-decoder (T5) generation: not ported yet (T5 serves through
    ``T5.init_decoder_cache`` / ``decode_step``, which raise too)."""
    raise NotImplementedError("generate_encdec (T5 generation) is not ported yet")
