"""Chip smoke test of the PyTorch/CUDA port (``torchdistx_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N] [--report PATH]

Phases, each fatal:

1. build the port's CUDA kernels from ``torchdistx_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together);
2. hold each kernel against its plain PyTorch version on the card, in bf16
   at llama3_8b shapes (Hq 32, Hkv 8, D 128), and time kernel, plain
   version and the PyTorch library call that computes the same function
   (``scaled_dot_product_attention``, a yardstick the port never calls);
3. serve 16 requests through ``ServeEngine`` on a full-width llama3_8b with
   random weights drawn from the seed, check the results, the slot
   independence of a greedy stream, and that every prefill and decode step
   went through the kernels (launch counters reset just before the run);
4. hold the flash backward kernels (``flash_bwd_dkv``, ``flash_bwd_dq``) and
   the forward's ``lse`` variant against their plain versions, and time
   them beside the SDPA backward (a yardstick the port never calls);
5. one backward step of a 4-layer, full-width llama_1b through the kernels
   and through the plain path, each held against the f32 plain path;
6. train llama_1b at full width and depth: ``deferred_init`` on the card
   allocates nothing, ``materialize_module`` is bit-identical to an eager
   construction, then ``Trainer.fit`` takes 10 AnyPrecisionAdamW steps
   (batch 2 x 2048) with every attention forward and backward through the
   kernels (launch counters reset just before the fit); then the same 10
   steps with the fused LM-head loss (``fused_ce=True``), every loss
   forward and backward through the three ``fused_ce`` kernels;
7. hold the fused LM-head cross-entropy kernels (``fused_ce_fwd``,
   ``fused_ce_dx``, ``fused_ce_dw``) against their plain versions at the
   llama_1b and gpt2_large loss shapes, a prime and a tiny token count,
   and time them beside the unfused bf16 path (``F.linear`` then f32
   ``cross_entropy``, a yardstick the port never calls);
8. one backward step of a 4-layer, full-width gpt2_large through the
   kernels (flash at head_dim 64, fused loss on the tied head) and through
   the plain path, each held against the f32 plain path;
9. train gpt2_large at full width and depth (36 layers, bf16, batch 8 x
   1024) through ``examples.train_gpt2.main`` with the fused loss: one
   warm-up step, then 10 steps with the launch counters reset just before;
10. ``torch.profiler`` over two more gpt2_large steps: device time per
   step by kernel and kernel class against the step's host-clock time.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero and prints
no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# kernel vs plain version: bf16 outputs of O(1).  The tolerance covers the
# bf16 rounding of the output and of the probabilities (the kernels feed
# unnormalised bf16 P to the tensor cores or keep f32 P, the plain path
# casts normalised P to bf16), plus f32 sums taken in another order.
ATOL = 2e-2
RTOL = 2e-2
# whole-model check at full width, depth cut to CHECK_LAYERS: the bf16
# kernel path may be at most this many times further from the f32 plain
# path than the bf16 plain path is (both share every bf16 projection; only
# the attention arithmetic differs, and the kernels keep more of it in f32)
LOGITS_FACTOR = 2.0
CHECK_LAYERS = 4

H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12

FLASH_CASES = [(b, s) for b in (1, 2) for s in (16, 37, 128, 1000, 2048)]
FLASH_REPORTED = (1, 2048)  # the largest prefill bucket of the serve run
DECODE_POSITIONS = [0, 511, 512, 1500, 2047, 37, 1023, 1800]
# (B, S, Hq, Hkv, D) for the backward kernels; timed at the llama_1b
# training shape (D 128) and the gpt2_large one (D 64)
BWD_CASES = [(1, 37, 4, 4, 128), (1, 1000, 32, 8, 128), (2, 2048, 16, 16, 128),
             (1, 2048, 32, 8, 128), (1, 130, 8, 8, 64), (8, 1024, 20, 20, 64)]
BWD_REPORTED = (2, 2048, 16, 16, 128)
BWD_REPORTED_D64 = (8, 1024, 20, 20, 64)
# kernel lse vs the plain f32 log-sum-exp: both take f32 sums of exact
# products of the same bf16 inputs, in another order; lse is O(10)
LSE_ATOL = 1e-3
TRAIN_STEPS = 10
# (N, D, V) of the fused LM-head loss: llama_1b (2 x 2048 tokens), gpt2_large
# (8 x 1024 tokens, vocab 50257 with no tile divisor), a prime and a tiny N
CE_CASES = [(4096, 2048, 32000), (8192, 1280, 50257), (509, 1280, 50257), (3, 2048, 32000)]
CE_REPORTED = (8192, 1280, 50257)
# kernel vs plain f32 version: the kernels take f32 sums of the same exact
# bf16 products in another order (lse to 1e-3 absolute, loss to 1e-3
# relative); dX and dW are fed through a bf16 dP (p - onehot, relative
# rounding 2^-9) and rounded to bf16, so they are held, scaled by their
# max, within 2e-2
CE_LOSS_RTOL = 1e-3
CE_GRAD_TOL = 2e-2


def _fail(msg: str, code: int = 1):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


def time_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds per call on the card, by CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _close(torch, out, ref):
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= ATOL + RTOL * ref.float().abs()).all())
    return ok, float(diff.max())


def flash_bound(b, sq, skv, hq, hkv, d):
    """Least time (ms) for causal flash forward: operations over the bf16
    tensor-core peak vs bytes (q, k, v read once, o written once) over the
    memory rate.  Causal pairs counted exactly (end-aligned mask)."""
    diag = skv - sq
    pairs = sum(min(skv, i + diag + 1) for i in range(sq))
    flops = 4.0 * d * pairs * b * hq  # Q.K^T and P.V, 2 flops per MAC
    nbytes = 2.0 * (2 * b * sq * hq * d + 2 * b * skv * hkv * d)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def decode_bound(b, hq, hkv, d, positions):
    """Least time (ms) for slot decode: the visible K/V rows (this run's
    positions) plus q and o over the memory rate vs operations over the
    bf16 peak."""
    rows = sum(int(p) + 1 for p in positions)
    nbytes = 2.0 * (2 * b * hq * d) + 2.0 * 2 * rows * hkv * d + 4 * b
    flops = 4.0 * d * hq * rows
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _sdpa_gqa(torch, q, k, v, **kw):
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **kw)


def check_flash(torch, device, hq=32, hkv=8, d=128, cases=FLASH_CASES, iters=10):
    from torchdistx_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(1)
    rows, failures = [], []
    for b, s in cases:
        def rnd(h):
            return torch.randn((b, s, h, d), generator=g, device=device,
                               dtype=torch.float32).to(torch.bfloat16)

        q, k, v = rnd(hq), rnd(hkv), rnd(hkv)
        out = fa.flash_attention(q, k, v, causal=True)
        ref = fa.flash_attention_reference(q, k, v, causal=True)
        ok, err = _close(torch, out, ref)
        if not ok:
            failures.append(f"flash B={b} S={s}: max|d|={err}")
        row = {"B": b, "S": s, "max_abs_err": err, "ok": ok}
        if device.type == "cuda":
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v), iters)
            row["plain_ms"] = time_ms(
                torch, lambda: fa.flash_attention_reference(q, k, v), iters)
            row["library_ms"] = time_ms(
                torch, lambda: _sdpa_gqa(torch, qt, kt, vt, is_causal=True), iters)
        row["bound_ms"], row["bound_by"] = flash_bound(b, s, s, hq, hkv, d)
        rows.append(row)
        print("flash", json.dumps(row))
    return rows, failures


def check_decode(torch, device, b=8, max_len=2048, hq=32, hkv=8, d=128,
                 positions=DECODE_POSITIONS, iters=50):
    from torchdistx_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=device).manual_seed(2)

    def rnd(shape):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    q = rnd((b, 1, hq, d))
    ck, cv = rnd((b, max_len, hkv, d)), rnd((b, max_len, hkv, d))
    pos = torch.tensor(positions[:b], dtype=torch.int32, device=device)
    out = da.decode_attention(q, ck, cv, pos)
    ref = da.decode_attention_reference(q, ck, cv, pos)
    ok, err = _close(torch, out, ref)
    failures = [] if ok else [f"decode: max|d|={err}"]
    row = {"B": b, "max_len": max_len, "positions": positions[:b],
           "max_abs_err": err, "ok": ok}
    if device.type == "cuda":
        qt = q.transpose(1, 2)
        kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
        mask = (torch.arange(max_len, device=device)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        row["ms"] = time_ms(torch, lambda: da.decode_attention(q, ck, cv, pos), iters)
        row["plain_ms"] = time_ms(
            torch, lambda: da.decode_attention_reference(q, ck, cv, pos), iters)
        row["library_ms"] = time_ms(
            torch, lambda: _sdpa_gqa(torch, qt, kt, vt, attn_mask=mask), iters)
    row["bound_ms"], row["bound_by"] = decode_bound(b, hq, hkv, d, positions[:b])
    print("decode", json.dumps(row))
    return row, failures


def _logit_trace(torch, model, prompt, toks, use_flash):
    """Last-position f32 logits of a prefill and of one decode step per
    token of ``toks`` (forced, so every path sees the same inputs)."""
    saved = model.cfg.use_flash
    model.cfg.use_flash = use_flash
    try:
        s = prompt.shape[1]
        cache = model.init_cache(1, s + len(toks) + 1)
        logits, cache = model.forward_cached(prompt, cache, 0)
        seq = [logits[:, -1].float()]
        for i, tok in enumerate(toks):
            pos = torch.tensor([s + i], device=prompt.device)
            logits, cache = model.forward_decode(tok.view(1, 1), cache, pos)
            seq.append(logits[:, -1].float())
        return torch.stack(seq)
    finally:
        model.cfg.use_flash = saved


def check_logits(torch, model, ref_model, prompt_len=37, decode_steps=3):
    """The bf16 model through the kernels and through the plain path, each
    held against the f32 plain path of the same weights (``ref_model``):
    prefill of one short prompt, then a few decode steps on the tokens the
    f32 reference picks.  The kernel path must be finite, of the expected
    shape, and no further from the f32 reference than LOGITS_FACTOR times
    the plain bf16 path is."""
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, prompt_len),
                           generator=g, device=dev)
    ref = _logit_trace(torch, ref_model, prompt, [], False)
    toks = []
    for _ in range(decode_steps):
        toks.append(torch.argmax(ref[-1], dim=-1))
        ref = _logit_trace(torch, ref_model, prompt, toks, False)
    kern = _logit_trace(torch, model, prompt, toks, None)
    plain = _logit_trace(torch, model, prompt, toks, False)
    err_k = float((kern - ref).abs().max())
    err_p = float((plain - ref).abs().max())
    finite = bool(torch.isfinite(kern).all())
    shape_ok = list(kern.shape) == [decode_steps + 1, 1, model.cfg.vocab_size]
    ok = finite and shape_ok and err_k <= LOGITS_FACTOR * err_p
    return ok, {"kernel_vs_f32": err_k, "plain_vs_f32": err_p,
                "f32_max_abs": float(ref.abs().max()), "finite": finite,
                "shape": list(kern.shape), "layers": model.cfg.n_layers}


def make_requests(rng, vocab, n=16, n_greedy=12, max_new=64, lo=16, hi=1536):
    lengths = rng.randint(lo, hi + 1, size=n)
    reqs = []
    for i, n_tok in enumerate(lengths):
        reqs.append({
            "prompt": rng.randint(0, vocab, size=int(n_tok)).astype("int32"),
            "max_new_tokens": max_new,
            "temperature": 0.0 if i < n_greedy else 0.8,
            "seed": 1000 + i,
        })
    return reqs


def serve(torch, model, requests, num_slots, max_len, expect_kernels=True):
    """The main path: ``ServeEngine(model, ...).run(requests)``, with the
    launch counters set to 0 just before and read just after."""
    import numpy as np
    from torchdistx_tpu_torch.ops import decode_attention as da
    from torchdistx_tpu_torch.ops import flash_attention as fa
    from torchdistx_tpu_torch.serve import ServeEngine

    failures = []
    engine = ServeEngine(model, num_slots=num_slots, max_len=max_len)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd_cuda.launches = 0
    da.decode_attention_cuda.launches = 0
    t0 = time.perf_counter()
    results = engine.run(requests)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fa.flash_fwd_cuda.launches,
                "decode_attention": da.decode_attention_cuda.launches}
    m = engine.metrics.to_json()
    n_layers = model.cfg.n_layers
    prefills = m["counters"]["prefill_calls"]
    steps = m["counters"]["decode_steps"]
    vocab = model.cfg.vocab_size
    for i, (req, r) in enumerate(zip(requests, results)):
        toks = np.asarray(r.tokens)
        if r.finish_reason != "length" or toks.size != req["max_new_tokens"]:
            failures.append(f"request {i}: {r.finish_reason}, {toks.size} tokens")
        if toks.size and (toks.min() < 0 or toks.max() >= vocab):
            failures.append(f"request {i}: token out of [0, {vocab})")
    if expect_kernels:
        if launches["flash_fwd"] != n_layers * prefills:
            failures.append(f"flash launches {launches['flash_fwd']} != "
                            f"{n_layers} x {prefills} prefills")
        if launches["decode_attention"] != n_layers * steps:
            failures.append(f"decode launches {launches['decode_attention']} != "
                            f"{n_layers} x {steps} decode steps")
    summary = {
        "requests": len(requests), "prefills": prefills, "decode_steps": steps,
        "launches": launches, "wall_s": wall,
        "ttft_p50_s": m["histograms"]["ttft_s"]["p50"],
        "decode_tokens_per_sec": m["derived"]["decode_tokens_per_sec"],
        "tokens_generated": m["counters"]["tokens_generated"],
    }
    if model.device.type == "cuda":
        summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del engine
    return results, summary, failures


def slot_independence(torch, model, requests, results, num_slots, max_len):
    """A greedy request served alone gives the stream it gave in the batch."""
    import numpy as np
    from torchdistx_tpu_torch.serve import ServeEngine

    idx = max(i for i, r in enumerate(requests) if r["temperature"] == 0.0)
    alone = ServeEngine(model, num_slots=num_slots, max_len=max_len).run(
        [requests[idx]])[0]
    same = np.array_equal(np.asarray(alone.tokens), np.asarray(results[idx].tokens))
    return same, idx


def _causal_pairs(s):
    return s * (s + 1) // 2


def bwd_bound(b, s, hq, hkv, d, products, outputs):
    """Least time (ms) for one backward kernel: ``products`` matrix
    products of 2 * D flops per causal pair and query head, over the bf16
    peak, vs bytes (q, o, dO, k, v and lse read once, ``outputs`` written
    once: "q" for dq, "kv" for dk and dv) over the memory rate."""
    flops = 2.0 * products * d * _causal_pairs(s) * b * hq
    nbytes = 2.0 * (3 * b * s * hq * d + 2 * b * s * hkv * d) + 4.0 * b * hq * s
    nbytes += 2.0 * (b * s * hq * d if outputs == "q" else 2 * b * s * hkv * d)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_flash_bwd(torch, device, cases=BWD_CASES, iters=10):
    """The backward kernels and the forward's lse variant against their
    plain versions, from the same saved ``o`` and ``lse`` (bf16 grads of
    O(1): ATOL/RTOL as for the forward, for the bf16 rounding of P, dS and
    the outputs, and f32 sums in another order)."""
    from torchdistx_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(4)
    rows, failures = [], []
    for b, s, hq, hkv, d in cases:
        def rnd(h):
            return torch.randn((b, s, h, d), generator=g, device=device,
                               dtype=torch.float32).to(torch.bfloat16)

        q, k, v, do = rnd(hq), rnd(hkv), rnd(hkv), rnd(hq)
        o, lse = fa.flash_fwd_cuda(q, k, v, return_lse=True)
        _, lse_ref = fa.flash_attention_lse_reference(q, k, v)
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, o, lse, do)
        dq = fa.flash_bwd_dq_cuda(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        rq, rk, rv = fa.flash_bwd_reference(q, k, v, o, lse, do)
        lse_err = float((lse - lse_ref).abs().max())
        case = (b, s, hq, hkv, d)
        row = {"B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d, "lse_err": lse_err}
        for name, out, ref in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
            ok, err = _close(torch, out, ref)
            row[f"{name}_err"] = err
            if not ok:
                failures.append(f"flash bwd {name} {case}: max|d|={err}")
        if lse_err > LSE_ATOL:
            failures.append(f"flash lse {case}: max|d|={lse_err}")
        if case in (BWD_REPORTED, BWD_REPORTED_D64):
            row["dkv_ms"] = time_ms(
                torch, lambda: fa.flash_bwd_dkv_cuda(q, k, v, o, lse, do), iters)
            row["dq_ms"] = time_ms(
                torch, lambda: fa.flash_bwd_dq_cuda(q, k, v, o, lse, do), iters)
            row["plain_ms"] = time_ms(
                torch, lambda: fa.flash_bwd_reference(q, k, v, o, lse, do), iters)
            row["lse_ms"] = time_ms(
                torch, lambda: fa.flash_fwd_cuda(q, k, v, return_lse=True), iters)
            row["lse_plain_ms"] = time_ms(
                torch, lambda: fa.flash_attention_lse_reference(q, k, v), iters)
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            sdpa = _sdpa_gqa(torch, qt, kt, vt, is_causal=True)
            row["lse_library_ms"] = time_ms(
                torch, lambda: _sdpa_gqa(torch, qt, kt, vt, is_causal=True), iters)
            dot = do.transpose(1, 2)
            row["library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                sdpa, (qt, kt, vt), dot, retain_graph=True), iters)
            row["dkv_bound_ms"], row["dkv_bound_by"] = bwd_bound(b, s, hq, hkv, d, 4, "kv")
            row["dq_bound_ms"], row["dq_bound_by"] = bwd_bound(b, s, hq, hkv, d, 3, "q")
            fb, fby = flash_bound(b, s, s, hq, hkv, d)
            row["lse_bound_ms"] = max(fb, (2.0 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
                                           + 4.0 * b * hq * s) / H100_BYTES_PER_S * 1e3)
            del sdpa, qt, kt, vt
        rows.append(row)
        print("flash_bwd", json.dumps(row))
    return rows, failures


def ce_bound(n, d, v, kernel):
    """Least time (ms) for one fused CE kernel: its N x V x D matrix
    products (one forward, two with the recompute for dX and dW; 2 flops a
    MAC) over the bf16 peak, vs bytes (x, w and labels read once; forward:
    loss and lse written; dX/dW: lse read, dX or dW written once) over the
    memory rate.  The true V, not a padded one."""
    products = 1 if kernel == "fwd" else 2
    flops = 2.0 * products * n * v * d
    nbytes = 2.0 * (n * d + v * d) + 4.0 * n
    nbytes += {"fwd": 8.0 * n, "dx": 4.0 * n + 2.0 * n * d,
               "dw": 4.0 * n + 2.0 * v * d}[kernel]
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _scaled_err(torch, out, ref):
    """max |out - ref| / max |ref|."""
    ref = ref.float()
    return float((out.float() - ref).abs().max() / (ref.abs().max() + 1e-30))


def check_fused_ce(torch, device, cases=CE_CASES, iters=5):
    """The three fused CE kernels against their plain f32 versions (loss,
    lse, dX, dW with cotangent 1) on bf16 x ~ N(0, 1), w ~ 0.1 N(0, 1);
    labels include 0, V - 2 and V - 1 (the last, partial vocab tile).
    Timed at the llama_1b and gpt2_large shapes beside the unfused bf16
    path (``F.linear`` then f32 ``cross_entropy``: forward for the fwd
    kernel, ``autograd.grad`` of both inputs for the dX + dW pair)."""
    from torchdistx_tpu_torch.ops import fused_ce as fc

    F = torch.nn.functional
    g = torch.Generator(device=device).manual_seed(6)
    rows, failures = [], []
    for n, d, v in cases:
        x = torch.randn((n, d), generator=g, device=device).to(torch.bfloat16)
        w = (torch.randn((v, d), generator=g, device=device) * 0.1).to(torch.bfloat16)
        labels = torch.randint(0, v, (n,), generator=g, device=device)
        labels[: min(n, 3)] = torch.tensor([v - 1, 0, v - 2], device=device)[: min(n, 3)]
        one = torch.ones(1, dtype=torch.float32, device=device)
        loss, lse = fc.fused_ce_fwd_cuda(x, w, labels)
        dx = fc.fused_ce_dx_cuda(x, w, labels, lse, one)
        dw = fc.fused_ce_dw_cuda(x, w, labels, lse, one)
        torch.cuda.synchronize()
        r_loss, r_lse = fc.fused_ce_fwd_reference(x, w, labels)
        r_dx = fc.fused_ce_dx_reference(x, w, labels, r_lse, one)
        r_dw = fc.fused_ce_dw_reference(x, w, labels, r_lse, one)
        ref_mean = float(r_loss.mean())
        row = {"N": n, "D": d, "V": v,
               "lse_err": float((lse - r_lse).abs().max()),
               "loss_rel_err": abs(float(loss.mean()) - ref_mean) / abs(ref_mean),
               "dx_err": float((dx.float() - r_dx.float()).abs().max()),
               "dw_err": float((dw.float() - r_dw.float()).abs().max()),
               "dx_scaled_err": _scaled_err(torch, dx, r_dx),
               "dw_scaled_err": _scaled_err(torch, dw, r_dw)}
        del r_dx, r_dw
        case = (n, d, v)
        if row["lse_err"] > LSE_ATOL or row["loss_rel_err"] > CE_LOSS_RTOL:
            failures.append(f"fused_ce fwd {case}: {row}")
        for name in ("dx", "dw"):
            if row[f"{name}_scaled_err"] > CE_GRAD_TOL:
                failures.append(f"fused_ce {name} {case}: {row}")
        if n >= 4096:
            row["fwd_ms"] = time_ms(torch, lambda: fc.fused_ce_fwd_cuda(x, w, labels), iters)
            row["dx_ms"] = time_ms(
                torch, lambda: fc.fused_ce_dx_cuda(x, w, labels, lse, one), iters)
            row["dw_ms"] = time_ms(
                torch, lambda: fc.fused_ce_dw_cuda(x, w, labels, lse, one), iters)
            row["fwd_plain_ms"] = time_ms(
                torch, lambda: fc.fused_ce_fwd_reference(x, w, labels), iters)
            row["dx_plain_ms"] = time_ms(
                torch, lambda: fc.fused_ce_dx_reference(x, w, labels, lse, one), iters)
            row["dw_plain_ms"] = time_ms(
                torch, lambda: fc.fused_ce_dw_reference(x, w, labels, lse, one), iters)
            row["fwd_library_ms"] = time_ms(
                torch, lambda: F.cross_entropy(F.linear(x, w).float(), labels), iters)
            xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
            lib_loss = F.cross_entropy(F.linear(xr, wr).float(), labels)
            row["grad_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                lib_loss, (xr, wr), retain_graph=True), iters)
            del lib_loss, xr, wr
            for k in ("fwd", "dx", "dw"):
                row[f"{k}_bound_ms"], row[f"{k}_bound_by"] = ce_bound(n, d, v, k)
        rows.append(row)
        print("fused_ce", json.dumps(row))
        del x, w, labels, loss, lse, dx, dw, r_loss, r_lse
        torch.cuda.empty_cache()
    return rows, failures


def _grads(torch, model, tokens, labels, use_flash, head=None):
    """Flattened f32 gradients of one backward step.  With ``head`` (the
    model's LM-head weight getter) the loss is the fused LM-head loss of
    the hidden states, else the plain ``cross_entropy`` of the logits."""
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

    saved = model.cfg.use_flash
    model.cfg.use_flash = use_flash
    try:
        model.zero_grad(set_to_none=True)
        if head is None:
            loss = F.cross_entropy(model(tokens), labels)
        else:
            loss = fused_linear_cross_entropy(model(tokens, return_hidden=True),
                                              head(model), labels)
        loss.backward()
        return torch.cat([p.grad.float().flatten() for p in model.parameters()])
    finally:
        model.cfg.use_flash = saved


def check_grads(torch, model, ref_model, seq=512, batch=1, head=None):
    """One backward step of the bf16 model through the kernels (flash
    attention, and with ``head`` the fused LM-head loss) and through the
    plain path, each held against the f32 plain path of the same weights:
    the kernel path's gradients must be finite and no further from f32
    than LOGITS_FACTOR times the plain bf16 path's."""
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(5)
    shape = (batch, seq)
    tokens = torch.randint(0, model.cfg.vocab_size, shape, generator=g, device=dev)
    labels = torch.randint(0, model.cfg.vocab_size, shape, generator=g, device=dev)
    ref = _grads(torch, ref_model, tokens, labels, False)
    kern = _grads(torch, model, tokens, labels, True, head)
    plain = _grads(torch, model, tokens, labels, False)
    err_k = float((kern - ref).abs().max())
    err_p = float((plain - ref).abs().max())
    finite = bool(torch.isfinite(kern).all())
    ok = finite and err_k <= LOGITS_FACTOR * err_p
    return ok, {"kernel_vs_f32": err_k, "plain_vs_f32": err_p,
                "f32_max_abs": float(ref.abs().max()), "finite": finite,
                "layers": model.cfg.n_layers, "batch": batch, "seq": seq,
                "fused_ce": head is not None}


def check_deferred(torch, tt, seed):
    """``deferred_init`` of full llama_1b on the card allocates no parameter
    storage; ``materialize_module`` gives parameters on the card equal to an
    eager construction from the same seed."""
    from torchdistx_tpu_torch.models import Llama

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tt.manual_seed(seed)
    model = tt.deferred_init(Llama.from_name, "llama_1b", device="cuda")
    grew = torch.cuda.memory_allocated() - before
    deferred = tt.is_deferred(model)
    t0 = time.perf_counter()
    tt.materialize_module(model)
    torch.cuda.synchronize()
    mat_s = time.perf_counter() - t0
    tt.manual_seed(seed)
    eager = Llama.from_name("llama_1b", device="cuda")
    params = list(model.named_parameters())
    on_card = all(p.is_cuda and not tt.is_fake(p) for _, p in params)
    same = all(torch.equal(p, q) for (_, p), (_, q) in zip(params, eager.named_parameters()))
    info = {"alloc_growth_bytes": grew, "is_deferred": deferred,
            "params": sum(p.numel() for _, p in params), "tensors": len(params),
            "materialize_s": mat_s, "on_card": on_card, "bit_identical": same}
    ok = grew < 1 << 20 and deferred and on_card and same and not tt.is_deferred(model)
    return ok, info


def _reset_counters():
    from torchdistx_tpu_torch.ops import decode_attention as da
    from torchdistx_tpu_torch.ops import flash_attention as fa
    from torchdistx_tpu_torch.ops import fused_ce as fc

    fa.flash_fwd_cuda.launches = fa.flash_fwd_cuda.lse_launches = 0
    fa.flash_bwd_dkv_cuda.launches = fa.flash_bwd_dq_cuda.launches = 0
    da.decode_attention_cuda.launches = 0
    fc.fused_ce_fwd_cuda.launches = fc.fused_ce_dx_cuda.launches = 0
    fc.fused_ce_dw_cuda.launches = 0


def _read_counters():
    from torchdistx_tpu_torch.ops import decode_attention as da
    from torchdistx_tpu_torch.ops import flash_attention as fa
    from torchdistx_tpu_torch.ops import fused_ce as fc

    return {"flash_fwd": fa.flash_fwd_cuda.launches,
            "flash_fwd_lse": fa.flash_fwd_cuda.lse_launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv_cuda.launches,
            "flash_bwd_dq": fa.flash_bwd_dq_cuda.launches,
            "decode_attention": da.decode_attention_cuda.launches,
            "fused_ce_fwd": fc.fused_ce_fwd_cuda.launches,
            "fused_ce_dx": fc.fused_ce_dx_cuda.launches,
            "fused_ce_dw": fc.fused_ce_dw_cuda.launches}


def _train_failures(losses, launches, n_layers, steps, fused_ce, what):
    import math

    failures = []
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        failures.append(f"{what} losses not finite: {losses}")
    elif not losses[-1] < losses[0]:
        failures.append(f"{what} loss did not fall: {losses}")
    expect = {k: n_layers * steps for k in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq")}
    for k in ("fused_ce_fwd", "fused_ce_dx", "fused_ce_dw"):
        expect[k] = steps if fused_ce else 0
    for kernel, n in expect.items():
        if launches[kernel] != n:
            failures.append(f"{what}: {kernel} launches {launches[kernel]} != {n}")
    return failures


def train(torch, seed, steps=TRAIN_STEPS, fused_ce=False):
    """The llama_1b training main path: ``build_train_workload``
    (deferred_init -> materialize_module -> AnyPrecisionAdamW) on full
    llama_1b, optionally with the fused LM-head loss, one warm-up step,
    then ``Trainer.fit`` over ``steps`` steps with the launch counters set
    to 0 just before and read just after."""
    from torchdistx_tpu_torch.utils.benchmarks import build_train_workload

    w = build_train_workload("llama_1b", batch=2, seq=2048, remat=False,
                             device="cuda", seed=seed, fused_ce=fused_ce)
    n_layers = w["model"].cfg.n_layers
    w["run"](1)  # warm-up: cuBLAS handles and workspaces
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    losses = w["run"](steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    tokens_per_s = w["tokens_per_batch"] * steps / wall
    summary = {
        "model": w["name"], "fused_ce": fused_ce, "n_params": w["n_params"],
        "batch": w["batch_size"], "seq": w["seq"], "steps": steps, "losses": losses,
        "step_ms": wall / steps * 1e3, "tokens_per_sec": tokens_per_s,
        "mfu": w["flops_per_token"] * tokens_per_s / H100_BF16_FLOPS,
        "flops_per_token": w["flops_per_token"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches,
    }
    failures = _train_failures(losses, launches, n_layers, steps, fused_ce,
                               f"llama_1b train (fused_ce={fused_ce})")
    del w
    torch.cuda.empty_cache()
    return summary, failures


def train_gpt2(torch, seed, steps=TRAIN_STEPS, batch=8, seq=1024):
    """The GPT-2 training main path: ``examples.train_gpt2.main`` on full
    gpt2_large in bf16 with the fused loss, over a stream of 4 batches per
    epoch (so the loss can fall).  One call of one step warms up; the
    launch counters are set to 0 just before the measured call of
    ``steps`` steps and read just after.  Step time, tokens/s and MFU are
    the trainer's (steps 2..``steps``: it keeps a call's first step out of
    its window)."""
    import numpy as np
    from torchdistx_tpu_torch.examples.train_gpt2 import main as train_main

    stream = np.random.RandomState(seed).randint(0, 50257, 4 * batch * seq + 1)
    kw = dict(batch=batch, seq=seq, fused_ce=True, device="cuda",
              dtype=torch.bfloat16, stream=stream, log_fn=lambda m: None)
    warm = train_main("gpt2_large", steps=1, **kw)
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    out = train_main("gpt2_large", steps=steps, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    m = out["metrics"]
    n_layers = out["model"].cfg.n_layers
    summary = {
        "model": "gpt2_large", "dtype": "bf16", "fused_ce": True,
        "n_params": out["n_params"], "batch": batch, "seq": seq, "steps": steps,
        "losses": out["losses"], "step_ms": 1e3 / m["steps_per_sec"],
        "tokens_per_sec": m["tokens_per_sec"], "mfu": m["mfu"],
        "flops_per_token": out["flops_per_token"], "call_wall_s": wall,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
    }
    failures = _train_failures(out["losses"], launches, n_layers, steps, True,
                               "gpt2_large train")
    del out
    torch.cuda.empty_cache()
    return summary, failures


def _kernel_class(name):
    """A coarse class of a device kernel's name, for the step breakdown."""
    low = name.lower()
    for cls, keys in (("fused_ce", ("fused_ce",)), ("flash", ("flash_",)),
                      ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "cublas", "nvjet")),
                      ("memcpy/memset", ("memcpy", "memset"))):
        if any(k in low for k in keys):
            return cls
    return "elementwise/other"


def profile_gpt2(torch, seed, steps=2, batch=8, seq=1024, top=15):
    """``torch.profiler`` over ``steps`` gpt2_large training steps of the
    main path: device time per step by kernel and by class, against the
    host-clock step time (the profiler's own overhead included); the
    difference is the card's idle share.  The
    trainer calls ``log_fn`` (with ``log_every=1``, after a synchronize)
    from its second step on, so with ``steps + 3`` steps the profiler waits
    through steps 1-2, warms up on step 3 and records the last ``steps``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, schedule
    from torchdistx_tpu_torch.examples.train_gpt2 import main as train_main

    stream = np.random.RandomState(seed).randint(0, 50257, 4 * batch * seq + 1)
    marks = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=steps)) as prof:
        def on_step(m):
            marks.append(time.perf_counter())
            prof.step()

        train_main("gpt2_large", batch=batch, seq=seq, steps=steps + 3, fused_ce=True,
                   device="cuda", dtype=torch.bfloat16, stream=stream, log_every=1,
                   log_fn=on_step)
    wall_ms = (marks[-1] - marks[1]) / steps * 1e3  # the active steps, synced at each end
    cuda = torch.autograd.DeviceType.CUDA
    rows, opt_span = [], None
    for e in prof.key_averages():
        annotation = (getattr(e, "is_user_annotation", False)
                      or e.key.startswith(("ProfilerStep", "Optimizer.")))
        if e.key.startswith("Optimizer.step") and getattr(e, "device_type", None) == cuda:
            # the optimizer's span on the card's timeline, idle gaps included
            opt_span = getattr(e, "device_time_total", 0.0) / 1e3 / steps
        if annotation or getattr(e, "device_type", None) != cuda:
            continue  # CPU ranges and annotations: their kernels count as kernels
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us:
            rows.append((e.key, dev_us / 1e3 / steps, e.count // steps))
    total = sum(r[1] for r in rows)
    if not total:
        return {"device_ms_per_step": "not measured", "step_wall_ms": wall_ms}
    by_class = {}
    for name, ms, _ in rows:
        by_class[_kernel_class(name)] = by_class.get(_kernel_class(name), 0.0) + ms
    rows.sort(key=lambda r: -r[1])
    return {
        "steps": steps, "step_wall_ms": wall_ms, "device_ms_per_step": total,
        "device_idle_share": max(0.0, 1.0 - total / wall_ms),
        "optimizer_span_ms": opt_span,
        "kernels_per_step": sum(r[2] for r in rows),
        "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top": [{"kernel": n[:90], "ms_per_step": ms, "calls_per_step": c}
                for n, ms, c in rows[:top]],
    }


def _kernel_entry(name, source, replaces, launches, row, max_err):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_err, "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default=None,
                    help="also write the full report as JSON to this path")
    args = ap.parse_args(argv)

    try:
        import numpy as np
        import torch
        import torchdistx_tpu_torch as tt
        from torchdistx_tpu_torch.ops import _build
    except ImportError as e:
        _fail(f"the port is not importable here ({e}); run from a checkout", 2)
    if not torch.cuda.is_available():
        _fail("no CUDA device: this smoke test runs only on the card", 2)
    if "jax" in sys.modules or "torchdistx_tpu" in sys.modules:
        _fail("JAX or the JAX package was imported", 1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    report = {"torch": torch.__version__, "cuda": torch.version.cuda}
    failures = []

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    libs = ["flash_fwd", "flash_bwd", "decode_attention", "fused_ce"]
    built = _build.build_all(libs)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s ({', '.join(built) or 'up to date'})")
    for name in libs:
        log = _build.BUILD_DIR / f"lib{name}.log"
        if log.exists():
            used = [ln.split("info    :")[-1].strip()
                    for ln in log.read_text().splitlines() if "Used" in ln]
            print(f"  ptxas {name}: {' | '.join(used)}")
    report["build_s"] = build_s

    # -- 2. kernels vs plain versions ---------------------------------------
    try:
        flash_rows, f1 = check_flash(torch, device)
        decode_row, f2 = check_decode(torch, device)
        failures += f1 + f2
    except Exception:
        traceback.print_exc()
        _fail("kernel phase failed")
    report["flash"], report["decode"] = flash_rows, decode_row

    # -- 3. serve -----------------------------------------------------------
    try:
        Llama = tt.models.Llama
        tt.manual_seed(args.seed + 1)
        small = Llama.from_name("llama3_8b", dtype=torch.bfloat16,
                                device="cuda", n_layers=CHECK_LAYERS)
        small_f32 = Llama.from_name("llama3_8b", dtype=torch.float32,
                                    device="cuda", n_layers=CHECK_LAYERS)
        small_f32.load_state_dict(small.state_dict())
        with torch.no_grad():
            ok, info = check_logits(torch, small, small_f32)
        print("logits vs f32 plain path", json.dumps(info))
        if not ok:
            failures.append(f"model logits: {info}")
        report["logits"] = info
        del small, small_f32
        torch.cuda.empty_cache()

        tt.manual_seed(args.seed)
        t0 = time.perf_counter()
        model = Llama.from_name("llama3_8b", dtype=torch.bfloat16, device="cuda")
        model.requires_grad_(False)
        torch.cuda.synchronize()
        print(f"model: llama3_8b, {sum(p.numel() for p in model.parameters())} "
              f"params, init {time.perf_counter() - t0:.1f} s")
        rng = np.random.RandomState(args.seed)
        requests = make_requests(rng, model.cfg.vocab_size)
        results, summary, f3 = serve(torch, model, requests, 8, 2048)
        failures += f3
        print("serve", json.dumps(summary))
        same, idx = slot_independence(torch, model, requests, results, 8, 2048)
        print(f"slot independence (request {idx} alone vs in batch): {same}")
        if not same:
            failures.append(f"request {idx} alone differs from its batch stream")
        report["serve"] = summary
        del model
        torch.cuda.empty_cache()
    except Exception:
        traceback.print_exc()
        _fail("serve phase failed")

    # -- 4. backward kernels vs plain versions ------------------------------
    try:
        bwd_rows, f4 = check_flash_bwd(torch, device)
        failures += f4
    except Exception:
        traceback.print_exc()
        _fail("backward kernel phase failed")
    report["flash_bwd"] = bwd_rows

    # -- 5. gradients at 4 layers of full llama_1b width ----------------------
    try:
        tt.manual_seed(args.seed + 2)
        small = Llama.from_name("llama_1b", dtype=torch.bfloat16, device="cuda",
                                n_layers=CHECK_LAYERS, remat=False)
        small_f32 = Llama.from_name("llama_1b", dtype=torch.float32,
                                    device="cuda", n_layers=CHECK_LAYERS,
                                    remat=False)
        small_f32.load_state_dict(small.state_dict())
        ok, info = check_grads(torch, small, small_f32)
        print("grads vs f32 plain path", json.dumps(info))
        if not ok:
            failures.append(f"model grads: {info}")
        report["grads"] = info
        del small, small_f32
        torch.cuda.empty_cache()
    except Exception:
        traceback.print_exc()
        _fail("gradient phase failed")

    # -- 6. train llama_1b ----------------------------------------------------
    try:
        ok, info = check_deferred(torch, tt, args.seed)
        print("deferred_init", json.dumps(info))
        if not ok:
            failures.append(f"deferred init: {info}")
        report["deferred"] = info
        torch.cuda.empty_cache()
        train_summary, f6 = train(torch, args.seed)
        failures += f6
        print("train", json.dumps(train_summary))
        report["train"] = train_summary
        fused_summary, f6 = train(torch, args.seed, fused_ce=True)
        failures += f6
        fused_summary["vs_unfused"] = {
            "step_ms_delta": fused_summary["step_ms"] - train_summary["step_ms"],
            "peak_memory_delta_bytes": (fused_summary["peak_memory_bytes"]
                                        - train_summary["peak_memory_bytes"])}
        print("train fused_ce", json.dumps(fused_summary))
        report["train_fused_ce"] = fused_summary
    except Exception:
        traceback.print_exc()
        _fail("train phase failed")

    # -- 7. fused LM-head cross-entropy kernels vs plain versions -------------
    try:
        ce_rows, f7 = check_fused_ce(torch, device)
        failures += f7
    except Exception:
        traceback.print_exc()
        _fail("fused cross-entropy kernel phase failed")
    report["fused_ce"] = ce_rows

    # -- 8. gradients at 4 layers of full gpt2_large width --------------------
    try:
        GPT2 = tt.models.GPT2
        tt.manual_seed(args.seed + 3)
        small = GPT2.from_name("gpt2_large", dtype=torch.bfloat16, device="cuda",
                               n_layers=CHECK_LAYERS)
        small_f32 = GPT2.from_name("gpt2_large", dtype=torch.float32, device="cuda",
                                   n_layers=CHECK_LAYERS)
        small_f32.load_state_dict(small.state_dict())
        ok, info = check_grads(torch, small, small_f32, seq=1024, batch=2,
                               head=lambda m: m.tok_emb.weight)
        print("gpt2 grads vs f32 plain path", json.dumps(info))
        if not ok:
            failures.append(f"gpt2 grads: {info}")
        report["gpt2_grads"] = info
        del small, small_f32
        torch.cuda.empty_cache()
    except Exception:
        traceback.print_exc()
        _fail("gpt2 gradient phase failed")

    # -- 9. train gpt2_large ----------------------------------------------------
    try:
        gpt2_summary, f9 = train_gpt2(torch, args.seed)
        failures += f9
        print("train gpt2_large", json.dumps(gpt2_summary))
        report["train_gpt2"] = gpt2_summary
    except Exception:
        traceback.print_exc()
        _fail("gpt2 train phase failed")

    # -- 10. where a gpt2_large step's time goes ----------------------------
    try:
        prof = profile_gpt2(torch, args.seed)
        if isinstance(prof["device_ms_per_step"], float):
            # against phase 9's step time, which ran without the profiler
            prof["unprofiled_step_ms"] = gpt2_summary["step_ms"]
            prof["device_idle_share_unprofiled"] = max(
                0.0, 1.0 - prof["device_ms_per_step"] / gpt2_summary["step_ms"])
        print("profile gpt2_large", json.dumps(prof))
        report["gpt2_profile"] = prof
    except Exception:
        traceback.print_exc()
        _fail("gpt2 profile phase failed")

    # -- 11. the record ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "not read"
    report["card"] = card
    rep = next(r for r in flash_rows if (r["B"], r["S"]) == FLASH_REPORTED)

    def bwd_row(case):
        return next(r for r in bwd_rows
                    if (r["B"], r["S"], r["Hq"], r["Hkv"], r["D"]) == case)

    brep, brep64 = bwd_row(BWD_REPORTED), bwd_row(BWD_REPORTED_D64)
    # the training main paths: llama_1b unfused and fused, gpt2_large
    runs = (train_summary, fused_summary, gpt2_summary)

    def trained(kernel):
        return sum(r["launches"][kernel] for r in runs)

    def d64(key):  # the gpt2_large (head_dim 64) timings of a flash kernel
        return {f"{k}_d64": brep64[f"{key}{k}"] for k in ("ms", "bound_ms")}

    fwd = _kernel_entry(
        "flash_fwd", "torchdistx_tpu_torch/csrc/flash_fwd.cu",
        "torchdistx_tpu/ops/flash_attention.py:141",
        summary["launches"]["flash_fwd"] + trained("flash_fwd_lse"), rep,
        max(r["max_abs_err"] for r in flash_rows))
    fwd.update(launches_plain=summary["launches"]["flash_fwd"],
               launches_lse=trained("flash_fwd_lse"), lse_ms=brep["lse_ms"],
               lse_plain_ms=brep["lse_plain_ms"],
               lse_library_ms=brep["lse_library_ms"],
               lse_bound_ms=brep["lse_bound_ms"],
               lse_max_abs_err=max(r["lse_err"] for r in bwd_rows),
               lse_ms_d64=brep64["lse_ms"], lse_plain_ms_d64=brep64["lse_plain_ms"],
               lse_library_ms_d64=brep64["lse_library_ms"],
               lse_bound_ms_d64=brep64["lse_bound_ms"])
    dkv = _kernel_entry(
        "flash_bwd_dkv", "torchdistx_tpu_torch/csrc/flash_bwd.cu",
        "torchdistx_tpu/ops/flash_attention.py:299", trained("flash_bwd_dkv"),
        {"ms": brep["dkv_ms"], "plain_ms": brep["plain_ms"],
         "bound_ms": brep["dkv_bound_ms"], "bound_by": brep["dkv_bound_by"],
         "library_ms": brep["library_ms"]},
        max(max(r["dk_err"], r["dv_err"]) for r in bwd_rows))
    dkv.update(d64("dkv_"), plain_ms_d64=brep64["plain_ms"],
               library_ms_d64=brep64["library_ms"])
    dq = _kernel_entry(
        "flash_bwd_dq", "torchdistx_tpu_torch/csrc/flash_bwd.cu",
        "torchdistx_tpu/ops/flash_attention.py:373", trained("flash_bwd_dq"),
        {"ms": brep["dq_ms"], "plain_ms": brep["plain_ms"],
         "bound_ms": brep["dq_bound_ms"], "bound_by": brep["dq_bound_by"],
         "library_ms": brep["library_ms"]},
        max(r["dq_err"] for r in bwd_rows))
    dq.update(d64("dq_"), plain_ms_d64=brep64["plain_ms"],
              library_ms_d64=brep64["library_ms"])
    kernels = [
        fwd, dkv, dq,
        _kernel_entry(
            "decode_attention", "torchdistx_tpu_torch/csrc/decode_attention.cu",
            "torchdistx_tpu/ops/decode_attention.py:79",
            summary["launches"]["decode_attention"], decode_row,
            decode_row["max_abs_err"]),
    ]
    # fused CE: timed at the gpt2_large loss shape, the llama_1b one beside
    crep = next(r for r in ce_rows if (r["N"], r["D"], r["V"]) == CE_REPORTED)
    clla = next(r for r in ce_rows if (r["N"], r["D"], r["V"]) == CE_CASES[0])
    for k, line in (("fwd", 74), ("dx", 123), ("dw", 152)):
        lib = "fwd_library_ms" if k == "fwd" else "grad_library_ms"
        err = max(r["lse_err"] if k == "fwd" else r[f"{k}_err"] for r in ce_rows)
        entry = _kernel_entry(
            f"fused_ce_{k}", "torchdistx_tpu_torch/csrc/fused_ce.cu",
            f"torchdistx_tpu/ops/fused_ce.py:{line}", trained(f"fused_ce_{k}"),
            {"ms": crep[f"{k}_ms"], "plain_ms": crep[f"{k}_plain_ms"],
             "bound_ms": crep[f"{k}_bound_ms"], "bound_by": crep[f"{k}_bound_by"],
             "library_ms": crep[lib]}, err)
        entry.update(shape={"N": crep["N"], "D": crep["D"], "V": crep["V"]},
                     launches_gpt2=gpt2_summary["launches"][f"fused_ce_{k}"],
                     launches_llama=fused_summary["launches"][f"fused_ce_{k}"],
                     ms_llama=clla[f"{k}_ms"], plain_ms_llama=clla[f"{k}_plain_ms"],
                     bound_ms_llama=clla[f"{k}_bound_ms"], library_ms_llama=clla[lib])
        kernels.append(entry)
    report["kernels"] = kernels
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    if failures:
        for f in failures:
            print(f"FAIL {f}", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
