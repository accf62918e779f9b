"""Autoregressive generation with a static-shape KV cache, counterpart of
``torchdistx_tpu/generation.py`` (the decoder-only paths the serving engine
uses; encoder-decoder generation, ``generate_encdec``, is not ported yet
and raises).

PyTorch runs eagerly, so the JAX package's ``lax.scan`` loops are Python
loops here; the caches are updated in place.

**Sampling.**  Greedy rows take the argmax, exactly as the JAX package does,
so greedy token ids agree with it wherever the logits do.  A sampled row
draws Gumbel noise from a ``torch.Generator`` keyed on ``(seed, step)``
(``utils.rng.derive_seed``) and takes the argmax of the tempered, filtered
logits plus that noise.  A request's sampled stream therefore depends only
on its seed and token index, never on its slot, its batch-mates or the
decode chunking — but it cannot reproduce ``jax.random``'s bits, and CPU
and CUDA generators give different streams from the same key.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .utils.rng import derive_seed

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


def _gumbel(n: int, seed: int, step: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, step))
    u = torch.rand(n, generator=g, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u))


def _make_slot_sampler(top_k: Optional[int] = None,
                       top_p: Optional[float] = None):
    """Per-row sampler: ``sample(logits, temps, seeds, steps)`` with
    ``logits`` (B, V) and host arrays ``temps``/``seeds``/``steps`` (B,).
    Rows with ``temps[b] <= 0`` are greedy; the rest sample at their own
    temperature with noise keyed on ``(seeds[b], steps[b])``.  Returns
    (B,) int64 token ids on ``logits.device``."""

    def sample(logits, temps, seeds, steps):
        greedy = torch.argmax(logits, dim=-1)
        temps = np.asarray(temps, np.float32)
        rows = np.nonzero(temps > 0.0)[0]
        if rows.size == 0:
            return greedy
        t = torch.as_tensor(np.maximum(temps, 1e-6), device=logits.device)
        scaled = logits.float() / t[:, None]
        if top_k is not None:
            scaled = _apply_top_k(scaled, top_k)
        if top_p is not None:
            scaled = _apply_top_p(scaled, top_p)
        noise = torch.zeros_like(scaled)
        for r in rows:
            noise[r] = _gumbel(scaled.shape[-1], int(seeds[r]), int(steps[r]),
                               logits.device)
        drawn = torch.argmax(scaled + noise, dim=-1)
        sampled = torch.as_tensor(temps > 0.0, device=logits.device)
        return torch.where(sampled, drawn, greedy)

    return sample


def _make_decode_body(model, sampler, *, eos_token: Optional[int],
                      max_len: int):
    """One batched ``forward_decode`` + slot-sampler iteration over the
    carry ``(kv, tok, pos, stp, fin)`` (device tensors, the cache updated in
    place), with the on-device finish rules: EOS, budget, and
    ``pos + 1 >= max_len``; a finished slot freezes (token, position and
    step held, position clamped like ``SlotKVCache.positions()``).
    ``key_steps`` are the host-side sampler steps of this iteration: for
    every live row they equal ``stp`` (a row that froze stays frozen).
    ``extra`` is forwarded to ``forward_decode``: the page tables of a paged
    cache."""

    def step(carry, *, temps, seeds, key_steps, budgets, extra=()):
        kv, tok, pos, stp, fin = carry
        logits, kv = model.forward_decode(tok[:, None], kv, pos, *extra)
        sampled = sampler(logits[:, -1, :], temps, seeds, key_steps)
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
    budgets, finished, *extra) -> (kv, (K, B) token block)``; ``toks``,
    ``positions``, ``budgets`` and ``finished`` are device tensors,
    ``temps``/``seeds``/``steps`` host arrays.  ``extra`` is empty for the
    slab; the paged engine passes its device page tables there, invariant
    over the chunk (a request's whole footprint is allocated at admission)."""
    step = _make_decode_body(model, sampler, eos_token=eos_token,
                             max_len=max_len)

    @torch.no_grad()
    def run(kv, toks, positions, temps, seeds, steps, budgets, finished,
            *extra):
        steps = np.asarray(steps, np.int64)
        stp = torch.as_tensor(steps, device=toks.device)
        carry = (kv, toks, positions, stp, finished)
        block = []
        for j in range(decode_chunk):
            carry = step(carry, temps=temps, seeds=seeds,
                         key_steps=steps + j, budgets=budgets, extra=extra)
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

    ``step(carry, *, temps, seeds, key_steps, budgets, extra)`` takes the
    carry ``(kv, tok, pos, stp, fin, hist)`` and returns ``(carry, y_block,
    cnt)``: the (B, K+1) verified tokens and the per-slot emitted count (0
    for frozen slots).  ``key_steps`` are the host sampler steps: a live
    sampled row advances exactly one token per iteration, so they are the
    dispatch's steps plus the iteration index."""
    if speculate < 1:
        raise ValueError(f"speculate must be >= 1, got {speculate}")
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")

    def step(carry, *, temps, seeds, key_steps, budgets, extra=()):
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
        y1 = sampler(logits[:, 0, :], temps, seeds, key_steps)
        gre = torch.argmax(logits, dim=-1).to(tok.dtype)
        y_block = torch.cat([y1.to(tok.dtype)[:, None], gre[:, 1:]], dim=1)

        # -- accept: longest draft prefix matching the greedy targets
        greedy = torch.as_tensor(np.asarray(temps) <= 0.0, device=dev)
        m = (qtok[:, 1:] == y_block[:, :speculate]) & greedy[:, None]
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
    token blocks, (chunk, B) counts, hist)``: ``hist`` the (B, max_len)
    device history with every emitted token in place, the next dispatch's
    input."""
    step = _make_spec_decode_body(model, sampler, eos_token=eos_token,
                                  max_len=max_len, speculate=speculate,
                                  ngram=ngram)

    @torch.no_grad()
    def run(kv, toks, positions, hist, temps, seeds, steps, budgets,
            finished, *extra):
        steps = np.asarray(steps, np.int64)
        stp = torch.as_tensor(steps, device=toks.device)
        carry = (kv, toks, positions, stp, finished, hist)
        ys, cs = [], []
        for j in range(decode_chunk):
            carry, y_block, cnt = step(carry, temps=temps, seeds=seeds,
                                       key_steps=steps + j, budgets=budgets,
                                       extra=extra)
            ys.append(y_block)
            cs.append(cnt)
        return carry[0], torch.stack(ys), torch.stack(cs), carry[5]

    return run


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
    temps = np.full(b, temperature, np.float32)
    seeds = np.full(b, seed, np.int64)
    cache = model.init_cache(b, s + max_new_tokens)
    logits, cache = model.forward_cached(prompt, cache, 0)
    toks = []
    for i in range(max_new_tokens):
        tok = sample(logits[:, -1], temps, seeds, np.full(b, i, np.int64))
        toks.append(tok)
        if i + 1 < max_new_tokens:
            logits, cache = model.forward_cached(tok[:, None], cache, s + i)
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)


def generate_encdec(model, enc_tokens, max_new_tokens: int, **kwargs):
    """Encoder-decoder (T5) generation: not ported yet (T5 serves through
    ``T5.init_decoder_cache`` / ``decode_step``, which raise too)."""
    raise NotImplementedError("generate_encdec (T5 generation) is not ported yet")
