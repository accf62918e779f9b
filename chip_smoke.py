"""Chip smoke test of the PyTorch/CUDA port (``torchdistx_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N] [--report PATH]

Phases, each fatal:

1. build the port's CUDA kernels from ``torchdistx_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together), and print the
   ptxas lines (registers, spills) of each kernel of the four sources,
   ``flash_fwd.cu``, ``flash_bwd.cu`` (dbias and dtable with it),
   ``decode_attention.cu`` and ``fused_ce.cu``;
2. hold each kernel against its plain PyTorch version on the card, in bf16
   at llama3_8b shapes (Hq 32, Hkv 8, D 128), and time kernel, plain
   version and the PyTorch library call that computes the same function
   (``scaled_dot_product_attention``, a yardstick the port never calls);
   the decode kernels in every variant, {slab, paged} x {one token, a
   5-token verify block} x {bf16, int8}, at the serving geometry (8 slots,
   max_len 2048, page size 16, shuffled page tables sharing prefix pages),
   each bit for bit against a second launch; the one-token kernel also at
   the serving run's depths, bit for bit against a second launch and its
   paged variant against the slab one, timed beside SDPA by call and by
   device time;
3. a 4-layer, full-width llama3_8b through the kernels and the plain path
   against f32, decoding over the slab, the int8 cache and page pools, one
   token at a time and in the speculative verify's 5-token blocks (rows
   past a slot's end included); then
   serve 16 requests through ``ServeEngine`` on a full-width llama3_8b with
   random weights drawn from the seed, in turns chunked one step a
   dispatch, persistent (the decode loop one CUDA graph of an iteration,
   replayed), chunked eight steps a dispatch, persistent, chunked one;
   check the results, every persistent stream (greedy and sampled) equal
   to the first chunked run's, one host sync per ring drain, one graph
   replay per loop iteration, the slot independence of a greedy stream,
   and that every prefill and decode step went through the kernels
   (launch counters reset just before each run, replays counted); then
   ``torch.profiler`` over one ring of decode per mode (device ms a step,
   the card's idle share); on the same model: (b) the paged engine with
   the prefix cache, one shared system prompt, the burst twice (cold,
   then warm: prefix hits, fewer tokens prefilled), its cold streams equal
   to the slab engine's bit for bit, chunked and persistent; then, with
   the model biased to repeat its last token (``copy_bias``: a random
   model's greedy output repeats nothing that prompt lookup could draft),
   (c) the slab engine with ``speculate=4`` on repetitive prompts (more
   than one token per verify; the share of streams equal to
   ``speculate=0``'s is printed, not gated), persistent equal to chunked;
   (d) paged + speculate 4 + int8 (the cache at most 0.53 of the bf16
   one), persistent equal to chunked, and each remaining decode variant's
   engine alone; so all four decode kernels also launch from a graph;
4. hold the flash backward kernels (``flash_bwd_dkv``, its delta
   pre-pass ``flash_bwd_delta``, ``flash_bwd_dq``) and the forward's
   ``lse`` variant against their plain versions, dK/dV and dQ bit for bit
   against a second launch, and time them beside the SDPA backward (a
   yardstick the port never calls);
5. one backward step of a 4-layer, full-width llama_1b through the kernels
   and through the plain path, each held against the f32 plain path;
6. train llama_1b at full width and depth: ``deferred_init`` on the card
   allocates nothing, ``materialize_module`` is bit-identical to an eager
   construction, then ``Trainer.fit`` takes 10 AnyPrecisionAdamW steps
   (batch 2 x 2048) with every attention forward and backward through the
   kernels (launch counters reset just before the fit); then the same 10
   steps with the fused LM-head loss (``fused_ce=True``), every loss
   forward and backward through the ``fused_ce`` kernels;
7. hold the fused LM-head cross-entropy kernels (``fused_ce_fwd``, and
   ``fused_ce_bwd``, which computes dX and dW in one backward) against
   their plain versions at the llama_1b and gpt2_large loss shapes, a
   prime and a tiny token count, each bit for bit against a second
   launch, and time them beside the unfused bf16 path (``F.linear`` then
   f32 ``cross_entropy``, a yardstick the port never calls);
8. one backward step of a 4-layer, full-width gpt2_large through the
   kernels (flash at head_dim 64, fused loss on the tied head) and through
   the plain path, each held against the f32 plain path;
9. train gpt2_large at full width and depth (36 layers, bf16, batch 8 x
   1024) through ``examples.train_gpt2.main`` with the fused loss: one
   warm-up step, then 10 steps with the launch counters reset just before;
10. ``torch.profiler`` over two more gpt2_large steps: device time per
   step by kernel and kernel class against the step's host-clock time;
11. hold T5's relative-position-bias variants of the flash kernels (an
   additive bias, the bucket table; causal and not; forward with and
   without lse, dK/dV, dQ) and the ``flash_bwd_dbias`` and
   ``flash_bwd_dtable`` kernels against their plain versions at T5-3B's
   heads (B 4 x S 512, a ragged S 114, B 1 x S 2048), dbias and dtable
   each bit for bit against a second launch and against a launch on a
   given delta, and time them beside SDPA with the bias as a float mask
   (a yardstick the port never calls);
12. one backward step of a T5-3B with 4 layers per stack through the
   kernels, in each bias mode, and through the plain path, each held
   against the f32 plain path;
13. train full T5-3B (24 + 24 layers, bf16, batch 4 x 512) through
   ``build_t5_train_workload``: deferred init, materialize on the card,
   one warm-up step, then 10 ``Trainer.fit`` steps with the launch
   counters reset just before, then ``torch.profiler`` over two more
   steps, (a) with the materialized bias (dbias), (b) with the bucket
   table (dtable), whose loss and gradients are then computed twice from
   the same state and compared bit for bit (recorded, not gated);
14. hold the sliding-window variants of the three flash kernels (forward
   with and without lse, dK/dV, dQ) against their plain versions at
   Mistral's heads (B 1, Hq 32, Hkv 8, D 128; (S, window) of (37, 16),
   (1000, 300), (2048, 4096), (8192, 4096) and (777, 1)), element-wise and
   by the relative norm of each (row, head), and time them
   beside the causal kernels at the same shape, the plain versions and
   SDPA with a boolean band mask (a yardstick the port never calls);
15. a 4-layer, full-width mistral_7b through the kernels and the plain
   path against f32, with one 4600-token prompt (past the window): the
   logits of the prefill and of three decode steps, then the gradients
   of one backward step;
16. serve full mistral_7b (32 layers, random weights from the seed)
   through ``ServeEngine`` over 8 slots x 8192 rows: 8 greedy requests
   with prompts of 4097-7000 tokens and 64 new tokens, every prefill
   through the window forward kernel (counters reset just before);
17. train mistral_7b at full width and 8 of its 32 layers (batch 1 x 8192)
   through ``build_train_workload``: deferred init, materialize on the
   card, one warm-up step, then 10 ``Trainer.fit`` steps with every
   attention forward and backward through the window kernels;
18. a 2-layer, full-width mixtral_8x7b in int8 at four seeds against its
   bf16 self (the JAX package's MoE fidelity metric over 64 prompts of 16
   tokens) and, on one 2048-token prompt, against its f32 self beside the
   bf16 model's agreement with f32, then full mixtral_8x7b (32 layers,
   8 experts) built block by block (materialize one block, quantize it to
   int8, release its bf16 weights) and served through ``ServeEngine``
   with its dense MoE over 8 slots x 4096 rows: 8 requests of 16-1536
   prompt tokens and 32 new tokens, prefill through the flash forward
   kernel and decode through the slot decode kernel, peak memory under
   the card's;
19. hold the ``(m, l)`` residuals variant of the flash forward (the raw f32
   accumulator per (row, head), each row's max and sum) and the f32-output
   variants of the dK/dV and dQ kernels against their plain versions in
   f32 at llama3_8b's heads (S 8192 causal and not, a ragged S 777),
   gpt2_large's (D 64) and T5-3B's with an additive bias, and time them
   beside the lse forward and the bf16-output kernels, the plain versions
   and SDPA (a yardstick the port never calls);
20. the flash ring on one card: 4 shards of llama3_8b's heads in one
   process, each simulated rank calling the port's per-hop forward and
   backward functions in the ring's order, held against the kernels over
   the whole 32768-token sequence (and at 4 x 1024 against the plain
   versions in f32, and with T5-3B's heads and an additive bias at 4 x
   512, not causal), with the residual and f32 launches counted;
21. sequence-parallel training at world size 1: ``init_multihost`` on
   NCCL, deferred init of llama3_8b (8 of 32 layers, ``sp_axis="sp"``),
   ``materialize_module(sharding_rule=fsdp_shard_rule(mesh))`` on the
   card, ``ShardedTrainStep(batch_spec=(None, "sp"))`` and 10
   ``Trainer.fit`` steps at 1 x 8192 with every attention forward through
   the residuals kernel and every backward through the f32-output kernels
   (counters reset just before), the first loss held against the plain
   path's;
22. SlowMo on the llama_1b training path at world size 1, on phase 21's
   NCCL group: full llama_1b (16 layers, bf16, batch 2 x 2048, the fused
   loss, remat off) through ``deferred_init`` and ``materialize_module``,
   ``ShardedTrainStep(shard_axis=None, replica_axes=("node",),
   comm_hook=slowmo_hook, divergent_replicas=True)`` on
   ``hierarchical_mesh(1)`` with ``SlowMomentumOptimizer(
   AnyPrecisionAdamW(lr=1e-4), slowmo_freq=3)``: one warm-up step, then 9
   ``Trainer.fit`` steps with every attention forward and backward and
   every loss through the kernels (counters reset just before); 3 slow
   steps, each one's parameters and slow momentum within one bf16 ulp of
   the update recomputed tensor by tensor, and timed (CUDA events);
23. GossipGraD and SlowMo across two ranks on the one card: 2 spawned
   processes joined over ``gloo`` (NCCL refuses two ranks on one device;
   ``gloo``'s sends go through pinned host buffers), each with llama_1b
   at full width and 4 of its 16 layers from the same seed and its own
   half of each batch, on ``hierarchical_mesh(2)``: (a) 6 GossipGraD
   steps, after each of which the two ranks' parameters are bit-identical
   (with two nodes both take the same sum, (own + peer) * 0.5); (b) 6
   SlowMo steps (``slowmo_freq`` 3), the ranks bit-identical after steps 3
   and 6 and different after step 4, and ``consensus()`` the mean of the
   two ranks' parameters; the kernels' launches on each rank, and per step
   its ms, the bytes it exchanged and the ms the exchange took.

Phases 2, 4, 11, 14 and 19 print one ``speed`` line per forward, dK/dV and
dQ variant and per decode variant, phase 7 one per fused CE kernel and
shape, phase 11 one per dbias and dtable variant: its ms, bound and
library ms, the factor over the library and over the bound (the decode
variants also by device time); phases 22-23 one ``train slowmo llama_1b``
line and one ``gossip``/``slowmo`` line per rank.  It prints the card's name and power limit, one ``{"kernels":
[...]}`` line and, last, ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero and prints
no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
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
# decode kernels vs plain versions, also per (slot, query row) over its
# heads: the norm of the difference within ROW_RTOL of the row's norm.  At
# depth a row averages hundreds of values and is O(0.05), where ATOL alone
# would pass a dropped key tile or an off-by-one; bf16 rounding moves a row
# by about 2^-9 of its norm
ROW_RTOL = 1e-2
# the window kernels are held by the same relative norm per (row, head) of a
# (B, S, H, D) output or gradient: at S 8192, W 4096 an element is about
# sqrt(e / W) = 0.026, so ATOL alone would pass a dropped 64-key tile (which
# moves a row by about 12% of its norm).  They are held against the plain
# versions in f32 (the bf16 plain forward is itself up to 2e-2 of a row
# away from f32).  A row whose reference norm is under
# ROW_FLOOR is held relative to ROW_FLOOR instead: dq of a row that sees one
# key, and dq and dk at window 1, are zero up to f32 rounding (about 1e-6)
ROW_FLOOR = 1e-2
# the whole-model verify check: two slots of VERIFY_LEN rows (4 pages of
# 16), (depth of slot 0, depth of slot 1) per round of S = 5 tokens; the
# second round rewrites rows of the first, as a partly rejected draft does,
# and slot 1's last two rows run past the slot's end (dropped)
VERIFY_LEN = 64
VERIFY_S = 5
VERIFY_PROMPTS = (37, 58)
VERIFY_ROUNDS = ((37, 58), (40, 61))

H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12

FLASH_CASES = [(b, s) for b in (1, 2) for s in (16, 37, 128, 1000, 2048)]
FLASH_REPORTED = (1, 2048)  # the largest prefill bucket of the serve run
DECODE_POSITIONS = [0, 511, 512, 1500, 2047, 37, 1023, 1800]
# the decode variants' slot depths at page_size 16: 0, page boundaries +-1
# and max_len - 1; with S = 5 the last two slots' rows run past max_len
VARIANT_POSITIONS = {1: [0, 15, 16, 17, 1023, 1024, 1500, 2047],
                     5: [0, 12, 15, 1020, 1024, 1800, 2044, 2047]}
KERNEL_OF = {("slab", 1): "decode_attention", ("slab", 5): "decode_attention_block",
             ("paged", 1): "paged_decode_attention",
             ("paged", 5): "paged_decode_attention_block"}
# file:line of the TPU kernel each replaces
TPU_KERNEL_OF = {"decode_attention": "torchdistx_tpu/ops/decode_attention.py:79",
                 "decode_attention_block": "torchdistx_tpu/ops/decode_attention.py:297",
                 "paged_decode_attention": "torchdistx_tpu/ops/decode_attention.py:609",
                 "paged_decode_attention_block": "torchdistx_tpu/ops/decode_attention.py:509"}
# (B, S, Hq, Hkv, D) for the backward kernels; timed at the llama_1b
# training shape (D 128) and the gpt2_large one (D 64)
BWD_CASES = [(1, 37, 4, 4, 128), (1, 1000, 32, 8, 128), (2, 2048, 16, 16, 128),
             (1, 2048, 32, 8, 128), (1, 130, 8, 8, 64), (8, 1024, 20, 20, 64)]
BWD_REPORTED = (2, 2048, 16, 16, 128)
BWD_REPORTED_D64 = (8, 1024, 20, 20, 64)
# kernel lse vs the plain f32 log-sum-exp: both take f32 sums of exact
# products of the same bf16 inputs, in another order; lse is O(10)
LSE_ATOL = 1e-3
# the delta pre-pass vs its plain version: f32 sums of the same D exact
# products of bf16 values in another order (delta of O(1), rounding ~1e-6)
DELTA_ATOL = 1e-4
# the redesigned sources, whose ptxas lines (registers, spills) the build
# phase prints per kernel
HOPPER_LIBS = ("flash_fwd", "flash_bwd", "decode_attention", "fused_ce")
TRAIN_STEPS = 10
# (N, D, V) of the fused LM-head loss: llama_1b (2 x 2048 tokens), gpt2_large
# (8 x 1024 tokens, vocab 50257 with no tile divisor), a prime and a tiny N
CE_CASES = [(4096, 2048, 32000), (8192, 1280, 50257), (509, 1280, 50257), (3, 2048, 32000)]
CE_REPORTED = (8192, 1280, 50257)
# kernel vs plain f32 version: the kernels take f32 sums of the same exact
# bf16 products in another order (lse to 1e-3 absolute, loss to 1e-3
# relative); dX and dW are fed through a bf16 dP panel (p - onehot,
# relative rounding 2^-9) and rounded to bf16, so they are held, scaled by
# their max, within 2e-2
CE_LOSS_RTOL = 1e-3
CE_GRAD_TOL = 2e-2
# T5's relative-position bias in the flash kernels, at T5-3B's heads (Hq 32,
# D 128, 32 buckets, max distance 128): (B, S) of the training shape, T5's
# target length (ragged: no tile divides it) and a long S (one row), where
# the bucket mode keeps memory O(S).  Each (B, S) runs the encoder's
# variant (bidirectional, no mask) and the decoder's (causal).
BIAS_CASES = [(4, 512), (4, 114), (1, 2048)]
BIAS_REPORTED = (4, 512)
T5_HEADS, T5_DKV, T5_BUCKETS, T5_MAX_DIST = 32, 128, 32, 128
# dbias and dtable vs their plain f32 versions, scaled by their max: bf16
# outputs of f32 sums taken in another order than the plain versions'
BIAS_GRAD_TOL = 2e-2
# the T5-3B training runs: scripts/bench_t5_train.py's batch and length
T5_BATCH, T5_SEQ = 4, 512
# engine counters a serve run reports
SERVE_COUNTERS = ("prefill_calls", "decode_steps", "tokens_prefilled", "tokens_decoded",
                  "prefix_hit_tokens", "pages_evicted", "draft_tokens_proposed",
                  "draft_tokens_accepted", "host_syncs", "ring_drains",
                  "ring_full_drains", "loop_iterations")
# the main serve run's decode modes, run in turns on one model: the
# chunked engine one step a dispatch, eight, and the persistent loop (one
# CUDA graph of an iteration, replayed)
SERVE_MODES = (("chunked-1", {}), ("persistent", {"decode_mode": "persistent"}),
               ("chunked-8", {"decode_chunk": 8}),
               ("persistent", {"decode_mode": "persistent"}), ("chunked-1", {}))
# decode steps run before, and profiled in, each mode's profile window: one
# persistent ring of this capacity
PROFILE_RING = 32
# the other decode kernels' persistent engines, profiled the same way for
# each kernel's device time a call inside the graph
GRAPH_VARIANTS = (("paged_decode_attention", {"page_size": 16}),
                  ("decode_attention_block", {"speculate": 4}),
                  ("paged_decode_attention_block_int8",
                   {"page_size": 16, "speculate": 4, "kv_dtype": "int8"}))
# the window variants at Mistral's heads (B 1, Hq 32, Hkv 8, D 128): (S,
# window) with a window below S and not a multiple of the 64-row tile, a
# window at least S, the training length 8192 with Mistral's 4096, and a
# ragged S with one key a row
WINDOW_CASES = [(37, 16), (1000, 300), (2048, 4096), (8192, 4096), (777, 1)]
WINDOW_REPORTED = (8192, 4096)
# the 4-layer mistral_7b check: one prompt past the 4096-token window
MISTRAL_PROMPT = 4600
# mistral_7b training at full width is cut to this depth: 32 layers of
# weights, gradients and optimizer state take about 72 GB
MISTRAL_TRAIN_LAYERS = 8
# int8 Mixtral vs bf16, the JAX package's MoE fidelity metric as its test
# applies it (tests/test_quantization.py, 16-token prompts): a near-tie
# routing choice may flip under any precision change, so the bulk of the
# logits is held, not their max
MIXTRAL_REL_P99 = 0.05
MIXTRAL_ARGMAX = 0.9
# ... and on a 2048-token prompt, where bf16 against f32 also loses
# agreement (0.948-0.961 on the H100), int8 against f32 within this much of
# bf16 against f32 at each of MIXTRAL_SEEDS seeds (int8 0.049-0.062 below
# bf16 there; a wrong scale or code loses far more)
MIXTRAL_LONG_MARGIN = 0.08
MIXTRAL_SEEDS = 4
# the (m, l) residuals and the f32-output backward kernels, (B, S, Hq, Hkv,
# D, causal, bias): llama3_8b's heads at the SP training length, causal and
# not, and a ragged S; gpt2_large's heads at D 64; T5-3B's with an additive
# bias.  Timed at llama3_8b's causal S 8192 (the training shape), the
# non-causal one beside it.
RESIDUAL_CASES = [(1, 8192, 32, 8, 128, True, False), (1, 8192, 32, 8, 128, False, False),
                  (1, 777, 32, 8, 128, False, False), (8, 1024, 20, 20, 64, True, False),
                  (4, 512, 32, 32, 128, False, True)]
RESIDUAL_REPORTED = RESIDUAL_CASES[0]
RESIDUAL_FULL = RESIDUAL_CASES[1]
# against the plain version on the inputs widened to f32: m is the max of
# f32 sums of the same exact bf16 products taken in another order (logits
# of O(1)); l = sum_j exp(s_ij - m_i) is rescaled once per 64-key tile, so
# its relative error grows with S / 64 roundings of 2^-24
RESIDUAL_M_ATOL = 1e-5
RESIDUAL_L_RTOL = 1e-5
# the ring on one card: (case, B, S per shard, Hq, Hkv, D, causal, bias,
# held against), RING_SHARDS shards; llama3_8b's heads at 4 x 8192 (the
# kernels over all 32768 tokens), at 4 x 1024 (the plain versions in f32)
# and T5-3B's heads with an additive bias at 4 x 512, not causal
RING_SHARDS = 4
RING_CASES = [("llama3_8b_4x8192", 1, 8192, 32, 8, 128, True, False, "kernels"),
              ("llama3_8b_4x1024", 1, 1024, 32, 8, 128, True, False, "plain_f32"),
              ("t5_3b_bias_4x512", 1, 512, 32, 32, 128, False, True, "kernels")]
RING_TIMED = "llama3_8b_4x8192"
# SP training of llama3_8b at world size 1 is cut to 8 of its 32 layers:
# 32 layers of weights, gradients and AnyPrecisionAdamW state take 128 GB
SP_TRAIN_LAYERS = 8
# the first SP step's loss against the plain path's on the same weights: a
# ring of one block is the flash kernel's loop with the divide moved out of
# the epilogue, so the two agree to bf16 rounding of the logits
SP_LOSS_RTOL = 1e-2
# torch.profiler over this many more SP steps: where a step's time goes
SP_PROFILE_STEPS = 2
# phase 22: SlowMo on full llama_1b at world size 1, Trainer.fit steps after
# one warm-up, a slow step every SLOWMO_FREQ optimizer steps; each slow step's
# parameters and momentum held within SLOWMO_ULPS bf16 ulps of the update
# recomputed tensor by tensor (the foreach kernels may fuse a multiply-add
# that the per-tensor ops round twice)
SLOWMO_STEPS = 9
SLOWMO_FREQ = 3
SLOWMO_ULPS = 1.0
# phase 23: two ranks on the one card over gloo (NCCL refuses two ranks on
# one device), llama_1b at full width and GOSSIP_LAYERS of its 16 layers a
# rank, GOSSIP_STEPS steps of GossipGraD, then as many of SlowMo
GOSSIP_LAYERS = 4
GOSSIP_STEPS = 6
GOSSIP_TIMEOUT_S = 300


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


def device_ms(torch, fn, iters: int):
    """Milliseconds per call of the card's own work in ``fn``: the device
    time of every kernel and copy it launches, summed by ``torch.profiler``
    over ``iters`` calls after one warm-up call, without the host's time
    between launches (which bounds :func:`time_ms` for a call that
    launches little work).  None if the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                if getattr(e, "device_type", None) == cuda)
    return total / 1e3 / iters if total else None


def queued_ms(torch, fn, iters: int, sleep_cycles: int = 20_000_000) -> float:
    """Mean device milliseconds per call of ``fn``: CUDA events around
    ``iters`` calls queued behind a ``torch.cuda._sleep`` (about 10 ms) that
    gives the host time to enqueue them all, so a call's host time (the
    wrapper's checks, allocations and the ctypes call) drops out where it
    exceeds its kernels' time.  One warm-up call first."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
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


def _close_rows(torch, out, ref, per_head=False, floor=1e-30):
    """:func:`_close` and the relative norm of each row of a (B, S, H, D)
    tensor: per (slot, query row) over its heads, or with ``per_head`` per
    (row, head), the norm of a reference row under ``floor`` counting as
    ``floor``.  Returns (ok, max abs err, max row err)."""
    ok, err = _close(torch, out, ref)
    o, r = (x.float() if per_head else x.float().flatten(2) for x in (out, ref))
    rel = float(((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(floor)).max())
    return ok and rel <= ROW_RTOL, err, rel


def _pairs(sq, skv, window=None):
    """The (query, key) pairs the end-aligned causal mask shows, within the
    sliding ``window``'s band when one is set: sum over rows of
    min(i + diag + 1, window)."""
    diag = skv - sq
    w = skv if window is None else min(window, skv)
    return sum(min(skv, i + diag + 1, w) for i in range(sq))


def flash_bound(b, sq, skv, hq, hkv, d, window=None):
    """Least time (ms) for causal flash forward: operations over the bf16
    tensor-core peak vs bytes (q, k, v read once, o written once) over the
    memory rate.  Causal pairs counted exactly (end-aligned mask), the
    band's with a window."""
    pairs = _pairs(sq, skv, window)
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


def speed_line(phase, variant, row, ms, bound, library):
    """Print one kernel variant's time beside its bound and the library
    call's (keys of ``row``): the factor over the library and over the
    bound, and the bound's share of the kernel's time."""
    ms, bound, lib = row[ms], row[bound], row.get(library)
    line = {"phase": phase, "variant": variant, "ms": ms, "bound_ms": bound,
            "library_ms": lib, "x_library": ms / lib if lib else None,
            "x_bound": ms / bound, "bound_fraction": bound / ms}
    print("speed", json.dumps(line))
    return line


def ptxas_lines(log_text):
    """Per kernel of a ``-Xptxas -v`` log: its mangled name, then the
    registers, the spills and any warning."""
    out = []
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            out.append(ln.split("'")[1] if "'" in ln else ln.strip())
        elif "Used" in ln or "spill" in ln or "warning" in ln.lower():
            out.append("    " + ln.split("info    :")[-1].strip())
    return out


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
        if device.type == "cuda" and (b, s) == FLASH_REPORTED:
            speed_line(2, f"plain causal B{b} S{s} Hq{hq}/Hkv{hkv} D{d}", row, "ms",
                       "bound_ms", "library_ms")
    return rows, failures


def check_decode(torch, device, b=8, max_len=2048, hq=32, hkv=8, d=128,
                 positions=DECODE_POSITIONS, page_size=16, iters=50):
    """The one-token kernel at the serving run's depths against its plain
    version, bit for bit against a second launch and, over page pools that
    hold the slab's rows under shuffled tables, its paged variant against
    it; timed by call and by device time beside SDPA with the mask."""
    import numpy as np
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
    ok, err, rel = _close_rows(torch, out, ref)
    failures = [] if ok else [f"decode: max|d|={err}, row {rel}"]
    row = {"B": b, "max_len": max_len, "positions": positions[:b],
           "max_abs_err": err, "max_row_rel_err": rel, "ok": ok}
    if device.type == "cuda":
        row["bitwise_repeat"] = bool(torch.equal(out, da.decode_attention(q, ck, cv, pos)))
        pp = max_len // page_size
        tables = _shuffled_tables(torch, np.random.RandomState(2), b, pp, b * pp + 1, 0,
                                  device)
        pools = []
        for t in (ck, cv):
            pool = torch.zeros((b * pp + 1, page_size, hkv, d), dtype=t.dtype, device=device)
            pool[tables.flatten().long()] = t.reshape(b * pp, page_size, hkv, d)
            pools.append(pool)
        paged = da.paged_decode_attention(q, *pools, tables, pos)
        row["paged_equals_slab_bitwise"] = bool(torch.equal(paged, out))
        for k in ("bitwise_repeat", "paged_equals_slab_bitwise"):
            if not row[k]:
                failures.append(f"decode: {k} is false")
        qt = q.transpose(1, 2)
        kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
        mask = (torch.arange(max_len, device=device)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        row["ms"] = time_ms(torch, lambda: da.decode_attention(q, ck, cv, pos), iters)
        row["paged_ms"] = time_ms(
            torch, lambda: da.paged_decode_attention(q, *pools, tables, pos), iters)
        row["plain_ms"] = time_ms(
            torch, lambda: da.decode_attention_reference(q, ck, cv, pos), iters)
        row["library_ms"] = time_ms(
            torch, lambda: _sdpa_gqa(torch, qt, kt, vt, attn_mask=mask), iters)
        row["device_ms"] = device_ms(torch, lambda: da.decode_attention(q, ck, cv, pos), iters)
        row["paged_device_ms"] = device_ms(
            torch, lambda: da.paged_decode_attention(q, *pools, tables, pos), iters)
        row["library_device_ms"] = device_ms(
            torch, lambda: _sdpa_gqa(torch, qt, kt, vt, attn_mask=mask), iters)
    row["bound_ms"], row["bound_by"] = decode_bound(b, hq, hkv, d, positions[:b])
    print("decode", json.dumps(row))
    if device.type == "cuda":
        shape = f"decode_attention bf16 S1 B{b} max_len {max_len} Hq{hq}/Hkv{hkv} D{d} serve depths"
        speed_line(2, shape, row, "ms", "bound_ms", "library_ms")
        if row["device_ms"] and row["library_device_ms"]:
            speed_line(2, f"{shape} (device time)", row, "device_ms", "bound_ms",
                       "library_device_ms")
    return row, failures


def variant_bound(positions, s, max_len, hq, hkv, d, quant, tables=None):
    """Least time (ms) for one decode-variant call: the visible K/V rows
    (rows up to each slot's deepest query row, ``min(pos + S, max_len)``)
    in their stored type plus their f32 scales when int8, q and o in bf16,
    over the memory rate; vs Q.K and P.V at 2 flops a MAC for every
    visible (query row, key) pair over the bf16 peak.  Over page pools
    (``tables``, (B, pages per slot) numpy) the rows are the union of the
    pool rows the slots see: a page that slots share is read once.  Slab
    rows are each slot's own memory."""
    import numpy as np

    depth = [min(p + s, max_len) for p in positions]
    if tables is None:
        rows = sum(depth)
    else:
        ps = max_len // tables.shape[1]
        seen = set()
        for b, n in enumerate(depth):
            j = np.arange(n)
            seen.update((tables[b, j // ps].astype(np.int64) * ps + j % ps).tolist())
        rows = len(seen)
    per_row = hkv * (d * (1 if quant else 2) + (4 if quant else 0))
    nbytes = 2.0 * rows * per_row + 2.0 * 2 * len(positions) * s * hq * d
    pairs = sum(min(p + i, max_len - 1) + 1 for p in positions for i in range(s))
    flops = 4.0 * d * hq * pairs
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _shuffled_tables(torch, rng, b, pp, num_pages, shared, device):
    """Page tables over pool pages 1..num_pages-1 in a shuffled order, with
    slots 1..b-1 sharing slot 0's first ``shared`` pages (a common prefix)."""
    perm = rng.permutation(num_pages - 1)[: b * pp] + 1
    tables = perm.reshape(b, pp).copy()
    tables[1:, :shared] = tables[0, :shared]
    return torch.tensor(tables, dtype=torch.int32, device=device)


def check_decode_variants(torch, device, b=8, max_len=2048, hq=32, hkv=8,
                          d=128, page_size=16, iters=50):
    """Each decode kernel variant, {slab, paged} x {S = 1, S = 5} x {bf16,
    int8}, against its plain version at the llama3_8b serving geometry.
    Positions include 0, page boundaries +-1 and ``max_len - 1``; for S = 5
    some slots' rows run past ``max_len``.  The pools hold the slab's rows
    under shuffled page tables whose slots share a prefix of pages, so each
    paged output must equal the slab kernel's on the gathered rows bit for
    bit.  Timed beside the plain version and the library yardstick (SDPA
    with an explicit mask over the slab; over the gather, timed with it,
    for paged; after the dequantization, timed with it, for int8)."""
    import numpy as np
    from torchdistx_tpu_torch.ops import decode_attention as da
    from torchdistx_tpu_torch.ops.attention import _paged_gather
    from torchdistx_tpu_torch.serve.kv_cache import dequantize_kv, quantize_kv

    g = torch.Generator(device=device).manual_seed(7)
    rng = np.random.RandomState(7)

    def rnd(shape):
        return torch.randn(shape, generator=g, device=device,
                           dtype=torch.float32).to(torch.bfloat16)

    pp = max_len // page_size
    num_pages = b * pp + 1
    pools = {"k": rnd((num_pages, page_size, hkv, d)),
             "v": rnd((num_pages, page_size, hkv, d))}
    tables = _shuffled_tables(torch, rng, b, pp, num_pages, pp // 4, device)
    qpools = {n: quantize_kv(t) for n, t in pools.items()}
    rows, failures = [], []
    for layout in ("slab", "paged"):
        for s in (1, 5):
            positions = VARIANT_POSITIONS[s]
            pos = torch.tensor(positions, dtype=torch.int32, device=device)
            q = rnd((b, s, hq, d))
            for dt in ("bf16", "int8"):
                quant = dt == "int8"
                if quant:
                    (kd, ksc), (vd, vsc) = qpools["k"], qpools["v"]
                else:
                    kd, vd, ksc, vsc = pools["k"], pools["v"], None, None
                if layout == "paged":
                    cache = (kd, vd, tables)
                else:
                    cache = (_paged_gather(kd, tables).contiguous(),
                             _paged_gather(vd, tables).contiguous())
                    if quant:
                        ksc = _paged_gather(ksc, tables).contiguous()
                        vsc = _paged_gather(vsc, tables).contiguous()
                name = KERNEL_OF[(layout, s)]
                kernel = getattr(da, f"{name}_cuda")
                plain = getattr(da, f"{name}_reference")
                kw = dict(k_scale=ksc, v_scale=vsc)
                out = kernel(q, *cache, pos, **kw)
                ref = plain(q, *cache, pos, **kw)
                ok, err, rel = _close_rows(torch, out, ref)
                row = {"kernel": name, "dtype": dt, "S": s, "B": b,
                       "max_len": max_len, "page_size": page_size,
                       "positions": positions, "max_abs_err": err,
                       "max_row_rel_err": rel, "ok": ok,
                       "bitwise_repeat": bool(torch.equal(out, kernel(q, *cache, pos, **kw)))}
                if not row["bitwise_repeat"]:
                    failures.append(f"{name} {dt}: two launches differ")
                if layout == "paged":
                    # the same rows through the slab kernel: only the
                    # address of a key row differs between the two
                    slab = [_paged_gather(t, tables).contiguous() for t in (kd, vd)]
                    skw = {k: None if v is None else _paged_gather(v, tables).contiguous()
                           for k, v in kw.items()}
                    slab_fn = getattr(da, f"{KERNEL_OF[('slab', s)]}_cuda")
                    row["equals_slab_bitwise"] = bool(torch.equal(
                        out, slab_fn(q, *slab, pos, **skw)))
                    if not row["equals_slab_bitwise"]:
                        failures.append(f"{name} {dt}: differs from the slab kernel")
                if not ok:
                    failures.append(f"{name} {dt} S={s}: max|d|={err}, row {rel}")
                row["ms"] = time_ms(torch, lambda: kernel(q, *cache, pos, **kw), iters)
                row["plain_ms"] = time_ms(torch, lambda: plain(q, *cache, pos, **kw), iters)
                depth = (pos.long()[:, None] + torch.arange(s, device=device)[None, :])
                mask = (torch.arange(max_len, device=device)[None, None, :]
                        <= depth[:, :, None])[:, None]  # (B, 1, S, max_len)
                qt = q.transpose(1, 2)

                def library():
                    kk, vv = cache[0], cache[1]
                    if layout == "paged":
                        kk, vv = _paged_gather(kk, tables), _paged_gather(vv, tables)
                    if quant:
                        ks_, vs_ = ksc, vsc
                        if layout == "paged":
                            ks_, vs_ = _paged_gather(ksc, tables), _paged_gather(vsc, tables)
                        kk = dequantize_kv(kk, ks_).to(torch.bfloat16)
                        vv = dequantize_kv(vv, vs_).to(torch.bfloat16)
                    return _sdpa_gqa(torch, qt, kk.transpose(1, 2), vv.transpose(1, 2),
                                     attn_mask=mask)

                row["library_ms"] = time_ms(torch, library, iters)
                # the kernels' device time alone: a call's host time (the
                # wrapper's checks and allocations) can exceed it
                row["device_ms"] = device_ms(torch, lambda: kernel(q, *cache, pos, **kw), iters)
                row["library_device_ms"] = device_ms(torch, library, iters)
                row["bound_ms"], row["bound_by"] = variant_bound(
                    positions, s, max_len, hq, hkv, d, quant,
                    tables.cpu().numpy() if layout == "paged" else None)
                rows.append(row)
                print("decode variant", json.dumps(row))
                shape = f"{name} {dt} S{s} B{b} max_len {max_len} Hq{hq}/Hkv{hkv} D{d}"
                speed_line(2, shape, row, "ms", "bound_ms", "library_ms")
                if row["device_ms"] and row["library_device_ms"]:
                    speed_line(2, f"{shape} (device time)", row, "device_ms", "bound_ms",
                               "library_device_ms")
    return rows, failures


def _decode_cache(torch, model, slab, kv_dtype, page_size):
    """The prefilled slab ``slab`` as the decode path's cache: unchanged,
    quantized to int8, and/or scattered into page pools behind shuffled
    page tables (page 0 is the scratch page).  Returns (cache, tables)."""
    from torchdistx_tpu_torch.serve import kv_cache as kc

    tables = None
    cache = slab
    if page_size:
        b, length = slab[0][0].shape[:2]
        n = length // page_size
        g = torch.Generator(device="cpu").manual_seed(n)
        perm = (torch.randperm(2 * b * n, generator=g)[: b * n] + 1).to(model.device)
        cache = model.init_cache(2 * b * n + 1, page_size)
        for i, row in enumerate(perm.view(b, n)):
            kc.paged_scatter_rows(cache, [(k[i:i + 1], v[i:i + 1]) for k, v in slab],
                                  row, page_size, 0, n * page_size)
        tables = perm.view(b, n).to(torch.int32)
    if kv_dtype == "int8":
        cache = kc.quantize_cache(cache)
    return cache, tables


def _logit_trace(torch, model, prompt, toks, use_flash, kv_dtype=None,
                 page_size=None):
    """Last-position f32 logits of a prefill and of one decode step per
    token of ``toks`` (forced, so every path sees the same inputs), the
    decode steps over the slab, its int8 quantization or page pools."""
    saved = model.cfg.use_flash
    model.cfg.use_flash = use_flash
    try:
        s = prompt.shape[1]
        length = s + len(toks) + 1
        if page_size:
            length = -(-length // page_size) * page_size
        cache = model.init_cache(1, length)
        logits, cache = model.forward_cached(prompt, cache, 0)
        seq = [logits[:, -1].float()]
        cache, tables = _decode_cache(torch, model, cache, kv_dtype, page_size)
        extra = () if tables is None else (tables,)
        for i, tok in enumerate(toks):
            pos = torch.tensor([s + i], device=prompt.device)
            logits, cache = model.forward_decode(tok.view(1, 1), cache, pos, *extra)
            seq.append(logits[:, -1].float())
        return torch.stack(seq)
    finally:
        model.cfg.use_flash = saved


def check_logits(torch, model, ref_model, prompt_len=37, decode_steps=3,
                 kv_dtype=None, page_size=None):
    """The bf16 model through the kernels and through the plain path, each
    held against the f32 plain path of the same weights (``ref_model``,
    slab cache): prefill of one short prompt, then a few decode steps on
    the tokens the f32 reference picks, over the slab, its int8
    quantization (``kv_dtype``) or page pools (``page_size``).  The kernel
    path must be finite, of the expected shape, and no further from the
    f32 reference than LOGITS_FACTOR times the plain bf16 path (same cache)
    is."""
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, prompt_len),
                           generator=g, device=dev)
    ref = _logit_trace(torch, ref_model, prompt, [], False)
    toks = []
    for _ in range(decode_steps):
        toks.append(torch.argmax(ref[-1], dim=-1))
        ref = _logit_trace(torch, ref_model, prompt, toks, False)
    kw = dict(kv_dtype=kv_dtype, page_size=page_size)
    kern = _logit_trace(torch, model, prompt, toks, None, **kw)
    plain = _logit_trace(torch, model, prompt, toks, False, **kw)
    return _logits_verdict(torch, model, kern, plain, ref,
                           [decode_steps + 1, 1, model.cfg.vocab_size], **kw)


def _logits_verdict(torch, model, kern, plain, ref, shape, **info):
    """The kernel path's logits finite, of ``shape``, and no further from
    the f32 reference than LOGITS_FACTOR times the plain bf16 path is.
    Returns (ok, report)."""
    err_k = float((kern - ref).abs().max())
    err_p = float((plain - ref).abs().max())
    finite = bool(torch.isfinite(kern).all())
    ok = finite and list(kern.shape) == shape and err_k <= LOGITS_FACTOR * err_p
    return ok, {"kernel_vs_f32": err_k, "plain_vs_f32": err_p,
                "f32_max_abs": float(ref.abs().max()), "finite": finite,
                "shape": list(kern.shape), "layers": model.cfg.n_layers, **info}


def _verify_trace(torch, model, prompts, rounds, use_flash, kv_dtype=None,
                  page_size=None):
    """f32 logits of the speculative verify call, ``forward_decode`` of a
    (B, S) block, round after round (``rounds``: (tokens, depths)) over a
    slab of VERIFY_LEN rows per slot that one prefill per prompt filled,
    its int8 quantization or page pools."""
    from torchdistx_tpu_torch.serve import kv_cache as kc

    saved = model.cfg.use_flash
    model.cfg.use_flash = use_flash
    try:
        slab = model.init_cache(len(prompts), VERIFY_LEN)
        for i, prompt in enumerate(prompts):
            _, one = model.forward_cached(prompt, model.init_cache(1, VERIFY_LEN), 0)
            kc.write_slot(slab, one, i)
        cache, tables = _decode_cache(torch, model, slab, kv_dtype, page_size)
        extra = () if tables is None else (tables,)
        seq = []
        for toks, depths in rounds:
            logits, cache = model.forward_decode(toks, cache, depths, *extra)
            seq.append(logits.float())
        return torch.stack(seq)
    finally:
        model.cfg.use_flash = saved


def check_verify_logits(torch, model, ref_model, kv_dtype=None, page_size=None):
    """The (B, K+1) verify through the model, as ``ServeEngine(speculate=4)``
    calls it, through the kernels and through the plain path, each held
    against the f32 plain path over the slab (``ref_model``): two slots,
    two rounds at VERIFY_ROUNDS's depths on random tokens, over the slab,
    its int8 quantization or page pools; rows past a slot's end are dropped
    by the writes.  Held as :func:`check_logits` holds a decode step."""
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(5)
    vocab = model.cfg.vocab_size
    prompts = [torch.randint(0, vocab, (1, n), generator=g, device=dev)
               for n in VERIFY_PROMPTS]
    rounds = [(torch.randint(0, vocab, (len(prompts), VERIFY_S), generator=g, device=dev),
               torch.tensor(depths, device=dev)) for depths in VERIFY_ROUNDS]
    ref = _verify_trace(torch, ref_model, prompts, rounds, False)
    kw = dict(kv_dtype=kv_dtype, page_size=page_size)
    kern = _verify_trace(torch, model, prompts, rounds, None, **kw)
    plain = _verify_trace(torch, model, prompts, rounds, False, **kw)
    return _logits_verdict(torch, model, kern, plain, ref,
                           [len(rounds), len(prompts), VERIFY_S, vocab],
                           depths=VERIFY_ROUNDS, slot_len=VERIFY_LEN, **kw)


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


def serve(torch, model, requests, num_slots, max_len, expect_kernels=True,
          **engine_kw):
    """The main path: ``ServeEngine(model, ...).run(requests)``, with the
    launch counters set to 0 just before and read just after."""
    import numpy as np
    from torchdistx_tpu_torch.serve import ServeEngine

    failures = []
    engine = ServeEngine(model, num_slots=num_slots, max_len=max_len, **engine_kw)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    results = engine.run(requests)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _read_counters()
    launches = {k: got[k] for k in ("flash_fwd", "decode_attention")}
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
        "decode_mode": engine.decode_mode, "decode_chunk": engine.decode_chunk,
        "requests": len(requests), "prefills": prefills, "decode_steps": steps,
        "launches": launches, "wall_s": wall,
        "ttft_p50_s": m["histograms"]["ttft_s"]["p50"],
        "decode_tokens_per_sec": m["derived"]["decode_tokens_per_sec"],
        "host_ms_per_decode_step": engine.metrics.decode_s.total / steps * 1e3,
        "tokens_generated": m["counters"]["tokens_generated"],
        "counters": {k: m["counters"][k] for k in SERVE_COUNTERS},
        "loop_replays": engine.loop_replays,
        "graph_captured": _graph_captured(engine),
    }
    if engine.decode_mode == "persistent":
        failures += _persistent_failures("serve persistent", summary)
    if model.device.type == "cuda":
        summary["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del engine
    return results, summary, failures


def _graph_captured(engine):
    """Whether a persistent engine's loop runs a captured CUDA graph."""
    loop = getattr(engine._decode, "loop", None)
    return loop is not None and loop.graph is not None


def _persistent_failures(what, summary):
    """A persistent run's loop contract: one host sync per ring drain, one
    decode step per loop iteration, one graph replay per iteration (none
    past the loop's end), and the iteration a captured graph."""
    c = summary["counters"]
    out = []
    if c["host_syncs"] != c["ring_drains"]:
        out.append(f"{what}: host_syncs {c['host_syncs']} != ring_drains {c['ring_drains']}")
    if c["loop_iterations"] != c["decode_steps"]:
        out.append(f"{what}: loop_iterations {c['loop_iterations']} != "
                   f"decode_steps {c['decode_steps']}")
    if summary["loop_replays"] != c["loop_iterations"]:
        out.append(f"{what}: {summary['loop_replays']} replays != "
                   f"{c['loop_iterations']} loop iterations")
    if not summary["graph_captured"]:
        out.append(f"{what}: no CUDA graph captured")
    return out


def _streams(results):
    import numpy as np

    return [(np.asarray(r.tokens).tolist(), r.finish_reason) for r in results]


def serve_modes(torch, model, requests, num_slots=8, max_len=2048):
    """Phase 3's main runs: :data:`SERVE_MODES` in turns on one model, each
    persistent run's streams (greedy and sampled) and finish reasons equal
    to the first chunked-1 run's, then :func:`profile_decode` per mode."""
    failures, runs = [], []
    ref = None
    for name, kw in SERVE_MODES:
        results, summary, f = serve(torch, model, requests, num_slots, max_len, **kw)
        failures += [f"{name}: {x}" for x in f]
        summary["mode"] = name
        if ref is None:
            ref = _streams(results)
        summary["streams_equal_chunked_1"] = _streams(results) == ref
        if name == "persistent" and not summary["streams_equal_chunked_1"]:
            failures.append("persistent streams differ from chunked-1's")
        print(f"serve {name}", json.dumps(summary))
        runs.append(summary)
    profiles = {}
    variants = [(name, kw) for name, kw in dict(SERVE_MODES).items()]
    variants += [(f"persistent {k}", dict(kw, decode_mode="persistent"))
                 for k, kw in GRAPH_VARIANTS]
    for name, kw in variants:
        prof = profile_decode(torch, model, requests[:num_slots], num_slots, max_len, **kw)
        if kw.get("decode_mode") == "persistent" and "by_class_ms_per_step" in prof:
            # one decode kernel call a layer a step
            prof["decode_kernel_device_ms_per_call"] = (
                prof["by_class_ms_per_step"].get("decode_attention", 0.0)
                / model.cfg.n_layers)
        profiles[name] = prof
        print(f"serve profile {name}", json.dumps(prof))
    return runs, profiles, failures, results


def profile_decode(torch, model, requests, num_slots, max_len, **engine_kw):
    """``torch.profiler`` over one ring of decode: the requests (one a
    slot) admitted at once, :data:`PROFILE_RING` decode steps run
    unprofiled, then the next ones to the end profiled (a persistent
    engine's second ring, at ``ring_capacity=PROFILE_RING``).  Device ms a
    step is the profiler's sum of kernel and copy time; the idle share
    is 1 - that over the window's host-clock time (the profiler's own
    host overhead included)."""
    from torch.profiler import ProfilerActivity, profile
    from torchdistx_tpu_torch.serve import ServeEngine

    if engine_kw.get("decode_mode") == "persistent":
        engine_kw = dict(engine_kw, ring_capacity=PROFILE_RING)
    engine = ServeEngine(model, num_slots=num_slots, max_len=max_len, **engine_kw)
    for r in requests:
        engine.submit(**r)
    counters = engine.metrics.counters
    while counters["decode_steps"] < PROFILE_RING:
        engine.step()
    torch.cuda.synchronize()
    first = counters["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while engine.step():
            pass
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = counters["decode_steps"] - first
    cuda = torch.autograd.DeviceType.CUDA
    by_class = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == cuda:
            cls = _kernel_class(e.key) if "decode_" not in e.key else "decode_attention"
            by_class[cls] = (by_class.get(cls, 0.0)
                             + getattr(e, "self_device_time_total", 0.0) / 1e3 / max(steps, 1))
    busy = sum(by_class.values())
    del engine
    if not steps:
        return {"decode_steps": 0, "device_ms_per_step": "not measured"}
    out = {"decode_steps": steps, "wall_ms_per_step": wall_ms / steps}
    if not busy:
        out["device_ms_per_step"] = "not measured"
        return out
    out["device_ms_per_step"] = busy
    out["device_idle_share"] = max(0.0, 1.0 - busy * steps / wall_ms)
    out["by_class_ms_per_step"] = dict(sorted(by_class.items(), key=lambda kv: -kv[1]))
    return out


def run_engine(torch, engine, requests):
    """One ``engine.run(requests)`` of the main path, with every launch
    counter set to 0 just before and read just after, and the engine's
    counters of this run alone.  Returns (results, summary)."""
    before = dict(engine.metrics.counters)
    replays = engine.loop_replays
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    results = engine.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _read_counters().items() if v}
    counters = {k: v - before.get(k, 0) for k, v in engine.metrics.counters.items()}
    cold = sum(1 for r in results for name, _, data in r.events
               if name == "prefill" and data.get("cold"))
    summary = {"decode_mode": engine.decode_mode, "requests": len(requests),
               "wall_s": wall, "launches": launches, "cold_prefills": cold,
               "decode_tokens_per_sec": counters["tokens_decoded"] / wall,
               "counters": {k: counters[k] for k in SERVE_COUNTERS},
               "loop_replays": engine.loop_replays - replays,
               "graph_captured": _graph_captured(engine),
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    return results, summary


def _greedy_failures(what, requests, results, vocab):
    import numpy as np

    failures = []
    for i, (req, r) in enumerate(zip(requests, results)):
        toks = np.asarray(r.tokens)
        if r.finish_reason != "length" or toks.size != req["max_new_tokens"]:
            failures.append(f"{what} request {i}: {r.finish_reason}, {toks.size} tokens")
        if toks.size and (toks.min() < 0 or toks.max() >= vocab):
            failures.append(f"{what} request {i}: token out of [0, {vocab})")
    return failures


def _launch_failures(what, summary, expect):
    got = summary["launches"]
    return [f"{what}: {k} launches {got.get(k, 0)} != {n}"
            for k, n in expect.items() if got.get(k, 0) != n]


def prefix_share_requests(rng, vocab, n=8, max_len=2048, max_new=64, page_size=16):
    """The ``bench_serve.py`` prefix-share shape: one system prompt of half
    the longest prompt (page-aligned), a different tail per request."""
    import numpy as np

    max_prompt = min(max_len - max_new, max_len // 2)
    sys_len = max(page_size, max_prompt // 2 - (max_prompt // 2) % page_size)
    system = rng.randint(0, vocab, sys_len)
    reqs = []
    for i in range(n):
        tail = rng.randint(0, vocab, 1 + rng.randint(0, max(1, max_prompt - sys_len)))
        reqs.append({"prompt": np.concatenate([system, tail])[:max_prompt].astype("int32"),
                     "max_new_tokens": max_new, "temperature": 0.0, "seed": i})
    return reqs


def cyclic_requests(rng, vocab, n=8, max_new=64):
    """Prompts of short repeated cycles of token ids (the prompt-lookup
    workload of tests/test_spec_decode.py, at the model's vocabulary)."""
    import numpy as np

    reqs = []
    for i in range(n):
        cycle = rng.randint(0, vocab, 2 + i % 4)
        reps = 1 + (48 + 16 * i) // cycle.size
        reqs.append({"prompt": np.tile(cycle, reps).astype("int32"),
                     "max_new_tokens": max_new, "temperature": 0.0, "seed": i})
    return reqs


@contextlib.contextmanager
def copy_bias(torch, model):
    """Give the random-weight model a bias to repeat its last token: the
    embedding table scaled by 2^12 (exact in bf16), so the residual stream
    is the current token's embedding (every sublayer still reads RMS-
    normalised inputs), and the LM head tied to the unscaled table.  A
    random model's greedy output repeats no n-gram, so prompt lookup would
    draft nothing it accepts; with the bias every stream repeats, and the
    speculative runs accept drafts.  Each greedy token is then the previous
    one whatever attention computes: the runs under the bias check launch
    counts and the engine's draft, accept and finish bookkeeping, not the
    verify's numbers, which :func:`check_verify_logits` holds.  Restored on
    exit."""
    emb, head = model.tok_emb.weight, model.lm_head.weight
    saved = head.detach().clone()
    with torch.no_grad():
        head.copy_(emb)
        emb.mul_(4096.0)
    try:
        yield
    finally:
        with torch.no_grad():
            emb.div_(4096.0)
            head.copy_(saved)


def serve_variants(torch, model, rng, num_slots=8, max_len=2048):
    """Phases b-d: the paged engine with the prefix cache (cold pass, warm
    pass, against the slab engine), the speculative slab engine (against
    speculate 0), paged + speculative + int8, and each remaining
    kernel variant's engine alone; c, d and the engines alone on the
    model under :func:`copy_bias`."""
    import numpy as np
    from torchdistx_tpu_torch.serve import ServeEngine

    n_layers, vocab = model.cfg.n_layers, model.cfg.vocab_size
    failures, report = [], {}

    def engine(**kw):
        return ServeEngine(model, num_slots=num_slots, max_len=max_len, **kw)

    # -- b. paged + prefix cache, bf16 ---------------------------------------
    reqs = prefix_share_requests(rng, vocab, n=num_slots, max_len=max_len)
    paged = engine(page_size=16, prefix_cache=True)
    cold, cs = run_engine(torch, paged, reqs)
    warm, ws = run_engine(torch, paged, reqs)
    del paged
    slab = engine()
    ref, rs_ = run_engine(torch, slab, reqs)
    del slab
    same = [bool(np.array_equal(np.asarray(a.tokens), np.asarray(b.tokens)))
            for a, b in zip(cold, ref)]
    for what, res, summ in (("paged cold", cold, cs), ("paged warm", warm, ws),
                            ("slab", ref, rs_)):
        failures += _greedy_failures(what, reqs, res, vocab)
        key = "decode_attention" if what == "slab" else "paged_decode_attention"
        failures += _launch_failures(what, summ, {
            key: n_layers * summ["counters"]["decode_steps"],
            "flash_fwd": n_layers * summ["cold_prefills"]})
    if not ws["counters"]["prefix_hit_tokens"] > 0:
        failures.append(f"paged warm pass: no prefix hit {ws['counters']}")
    if not ws["counters"]["tokens_prefilled"] < cs["counters"]["tokens_prefilled"]:
        failures.append("paged warm pass prefilled no fewer tokens than the cold one")
    if not all(same):
        failures.append(f"paged cold pass differs from the slab engine: {same}")
    report["b_paged_prefix"] = {"cold": cs, "warm": ws, "slab": rs_,
                                "cold_equals_slab_bitwise": same}
    print("b. paged + prefix cache", json.dumps(report["b_paged_prefix"]))

    # -- b, persistent: the same burst through the loop's CUDA graph ----------
    paged = engine(page_size=16, prefix_cache=True, decode_mode="persistent")
    pcold, pcs = run_engine(torch, paged, reqs)
    pwarm, pws = run_engine(torch, paged, reqs)
    del paged
    slab = engine(decode_mode="persistent")
    pref, prs = run_engine(torch, slab, reqs)
    del slab
    for what, res, summ in (("persistent paged cold", pcold, pcs),
                            ("persistent paged warm", pwarm, pws),
                            ("persistent slab", pref, prs)):
        failures += _greedy_failures(what, reqs, res, vocab)
        failures += _persistent_failures(what, summ)
        key = "decode_attention" if what == "persistent slab" else "paged_decode_attention"
        failures += _launch_failures(what, summ, {
            key: n_layers * summ["counters"]["decode_steps"],
            "flash_fwd": n_layers * summ["cold_prefills"]})
    if not pws["counters"]["prefix_hit_tokens"] > 0:
        failures.append(f"persistent paged warm pass: no prefix hit {pws['counters']}")
    equal = {"cold_equals_slab_persistent": _streams(pcold) == _streams(pref),
             "slab_persistent_equals_chunked": _streams(pref) == _streams(ref)}
    failures += [f"b persistent: not {k}" for k, v in equal.items() if not v]
    report["b_paged_prefix_persistent"] = dict(cold=pcs, warm=pws, slab=prs, **equal)
    print("b. paged + prefix cache, persistent",
          json.dumps(report["b_paged_prefix_persistent"]))
    with copy_bias(torch, model):
        failures += _speculative_variants(torch, engine, rng, n_layers, vocab,
                                          num_slots, report)
    return report, failures


def _speculative_variants(torch, engine, rng, n_layers, vocab, num_slots, report):
    """Phases c, d and the remaining variants' engines alone, into
    ``report``.  Returns the failures."""
    import numpy as np

    failures = []
    # -- c. slab, speculate 4, spec_ngram 2 ------------------------------------
    reqs = cyclic_requests(rng, vocab, n=num_slots)
    spec, ss = run_engine(torch, engine(speculate=4, spec_ngram=2), reqs)
    base, bs = run_engine(torch, engine(), reqs)
    failures += _greedy_failures("speculate 4", reqs, spec, vocab)
    failures += _launch_failures("speculate 4", ss, {
        "decode_attention_block": n_layers * ss["counters"]["decode_steps"]})
    per_verify = _tokens_per_verify(ss["counters"], 4)
    if not per_verify > 1:
        failures.append(f"speculate 4: {per_verify} tokens per verify")
    share = float(np.mean([np.array_equal(np.asarray(a.tokens), np.asarray(b.tokens))
                           for a, b in zip(spec, base)]))
    specp, sps = run_engine(torch, engine(speculate=4, spec_ngram=2,
                                          decode_mode="persistent"), reqs)
    failures += _greedy_failures("persistent speculate 4", reqs, specp, vocab)
    failures += _persistent_failures("persistent speculate 4", sps)
    failures += _launch_failures("persistent speculate 4", sps, {
        "decode_attention_block": n_layers * sps["counters"]["decode_steps"]})
    sps["streams_equal_chunked"] = _streams(specp) == _streams(spec)
    if not sps["streams_equal_chunked"]:
        failures.append("persistent speculate 4 differs from chunked speculate 4")
    report["c_speculate"] = {"spec": ss, "speculate0": bs, "tokens_per_verify": per_verify,
                             "greedy_share_equal_to_speculate0": share,
                             "spec_persistent": sps}
    print("c. speculate 4", json.dumps(report["c_speculate"]))

    # -- d. paged + speculate 4 + int8 -------------------------------------------
    bf16_bytes = engine(page_size=16).cache.nbytes
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = engine(page_size=16, speculate=4, kv_dtype="int8")
    out, ds = run_engine(torch, full, reqs)
    ds["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    ds["kv_cache_bytes"], ds["bf16_kv_cache_bytes"] = full.cache.nbytes, bf16_bytes
    ds["tokens_per_verify"] = _tokens_per_verify(ds["counters"], 4)
    del full
    failures += _greedy_failures("paged + speculate 4 + int8", reqs, out, vocab)
    failures += _launch_failures("paged + speculate 4 + int8", ds, {
        "paged_decode_attention_block_int8": n_layers * ds["counters"]["decode_steps"]})
    if not ds["kv_cache_bytes"] <= 0.53 * bf16_bytes:
        failures.append(f"int8 cache {ds['kv_cache_bytes']} > 0.53 x {bf16_bytes}")
    outp, dps = run_engine(torch, engine(page_size=16, speculate=4, kv_dtype="int8",
                                         decode_mode="persistent"), reqs)
    failures += _greedy_failures("persistent paged + speculate 4 + int8", reqs, outp, vocab)
    failures += _persistent_failures("persistent paged + speculate 4 + int8", dps)
    failures += _launch_failures(
        "persistent paged + speculate 4 + int8", dps, {
            "paged_decode_attention_block_int8": n_layers * dps["counters"]["decode_steps"]})
    dps["streams_equal_chunked"] = _streams(outp) == _streams(out)
    if not dps["streams_equal_chunked"]:
        failures.append("persistent paged + speculate 4 + int8 differs from chunked")
    ds["persistent"] = dps
    report["d_paged_spec_int8"] = ds
    print("d. paged + speculate 4 + int8", json.dumps(ds))

    # -- each remaining variant's engine alone ------------------------------------
    short = [dict(r, max_new_tokens=32) for r in reqs]
    alone = {}
    for kw, kernel in ((dict(kv_dtype="int8"), "decode_attention_int8"),
                       (dict(kv_dtype="int8", page_size=16), "paged_decode_attention_int8"),
                       (dict(kv_dtype="int8", speculate=4), "decode_attention_block_int8"),
                       (dict(page_size=16, speculate=4), "paged_decode_attention_block")):
        res, summ = run_engine(torch, engine(**kw), short)
        failures += _greedy_failures(kernel, short, res, vocab)
        failures += _launch_failures(kernel, summ, {
            kernel: n_layers * summ["counters"]["decode_steps"]})
        alone[kernel] = summ
    report["alone"] = alone
    print("d. each variant alone", json.dumps(alone))
    return failures


def _serve_runs(variants):
    """Every serve-run summary of ``serve_variants``'s report."""
    b, c = variants["b_paged_prefix"], variants["c_speculate"]
    bp, d = variants["b_paged_prefix_persistent"], variants["d_paged_spec_int8"]
    return ([b["cold"], b["warm"], b["slab"], bp["cold"], bp["warm"], bp["slab"],
             c["spec"], c["speculate0"], c["spec_persistent"], d, d["persistent"]]
            + list(variants["alone"].values()))


def _tokens_per_verify(counters, k):
    """Tokens emitted per live slot-iteration of the speculative decode:
    every such iteration proposes ``k`` drafts."""
    iterations = counters["draft_tokens_proposed"] / k
    return counters["tokens_decoded"] / iterations if iterations else 0.0


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


def bwd_bound(b, s, hq, hkv, d, products, outputs, window=None):
    """Least time (ms) for one backward kernel: ``products`` matrix
    products of 2 * D flops per causal pair (the band's with a window) and
    query head, over the bf16 peak, vs bytes (q, o, dO, k, v and lse read
    once, ``outputs`` written once: "q" for dq, "kv" for dk and dv) over the
    memory rate."""
    pairs = _causal_pairs(s) if window is None else _pairs(s, s, window)
    flops = 2.0 * products * d * pairs * b * hq
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
        dk2, dv2 = fa.flash_bwd_dkv_cuda(q, k, v, o, lse, do)
        dq = fa.flash_bwd_dq_cuda(q, k, v, o, lse, do)
        delta = fa.flash_bwd_delta_cuda(o, do)
        dq2 = fa.flash_bwd_dq_cuda(q, k, v, o, lse, do, delta=delta)
        torch.cuda.synchronize()
        rq, rk, rv = fa.flash_bwd_reference(q, k, v, o, lse, do)
        lse_err = float((lse - lse_ref).abs().max())
        case = (b, s, hq, hkv, d)
        row = {"B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d, "lse_err": lse_err,
               "delta_err": float((delta - fa.flash_bwd_delta_reference(o, do)).abs().max()),
               "dkv_bitwise_repeat": bool(torch.equal(dk, dk2) and torch.equal(dv, dv2)),
               "dq_bitwise_repeat": bool(torch.equal(dq, dq2))}
        if row["delta_err"] > DELTA_ATOL:
            failures.append(f"flash bwd delta {case}: max|d|={row['delta_err']}")
        if not row["dkv_bitwise_repeat"]:
            failures.append(f"flash bwd dk/dv {case}: two launches differ")
        if not row["dq_bitwise_repeat"]:
            failures.append(f"flash bwd dq {case}: two launches differ")
        del dk2, dv2, dq2
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
            row["delta_ms"] = time_ms(torch, lambda: fa.flash_bwd_delta_cuda(o, do), iters)
            row["delta_plain_ms"] = time_ms(
                torch, lambda: fa.flash_bwd_delta_reference(o, do), iters)
            row["delta_bound_ms"] = ((2.0 * 2 * b * s * hq * d + 4.0 * b * hq * s)
                                     / H100_BYTES_PER_S * 1e3)
            # dQ alone, on the pre-pass's delta as flash_backward runs it;
            # the whole backward (one pre-pass, dK/dV, dQ) beside it
            row["dq_ms"] = time_ms(
                torch, lambda: fa.flash_bwd_dq_cuda(q, k, v, o, lse, do, delta=delta), iters)
            row["bwd_ms"] = time_ms(
                torch, lambda: fa.flash_backward(q, k, v, o, lse, do), iters)
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
            shape = f"B{b} S{s} Hq{hq}/Hkv{hkv} D{d}"
            speed_line(4, f"lse causal {shape}", row, "lse_ms", "lse_bound_ms",
                       "lse_library_ms")
            speed_line(4, f"dkv bf16 causal {shape} (library: all three gradients)", row,
                       "dkv_ms", "dkv_bound_ms", "library_ms")
            speed_line(4, f"dq bf16 causal {shape} (library: all three gradients)", row,
                       "dq_ms", "dq_bound_ms", "library_ms")
        del delta
        rows.append(row)
        print("flash_bwd", json.dumps(row))
    return rows, failures


def ce_bound(n, d, v, kernel):
    """Least time (ms) for one fused CE call: its N x V x D matrix
    products (one forward; three backward: the logits once, dW = dP^T X,
    dX = dP W; 2 flops a MAC) over the bf16 peak, vs bytes (x, w and
    labels read once; forward: loss and lse written; backward: lse read,
    dX and dW written once, and the bf16 (N, V) dP panel written once and
    read twice) over the memory rate.  The true V, not a padded one."""
    products = 1 if kernel == "fwd" else 3
    flops = 2.0 * products * n * v * d
    nbytes = 2.0 * (n * d + v * d) + 4.0 * n
    nbytes += {"fwd": 8.0 * n,
               "bwd": 4.0 * n + 2.0 * (n * d + v * d) + 3 * 2.0 * n * v}[kernel]
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _scaled_err(torch, out, ref):
    """max |out - ref| / max |ref|."""
    ref = ref.float()
    return float((out.float() - ref).abs().max() / (ref.abs().max() + 1e-30))


def check_fused_ce(torch, device, cases=CE_CASES, iters=5):
    """The fused CE kernels against their plain f32 versions (loss, lse;
    dX and dW of the one backward, with cotangent 1, against the plain
    version of its chunked algorithm at the same chunk) on bf16 x ~ N(0,
    1), w ~ 0.1 N(0, 1); labels include 0, V - 2 and V - 1 (the last,
    partial vocab tile); the backward bit for bit against a second launch.
    Timed at the llama_1b and gpt2_large shapes beside the unfused bf16
    path (``F.linear`` then f32 ``cross_entropy``: forward for the fwd
    kernel, ``autograd.grad`` of both inputs for the backward)."""
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
        loss2, lse2 = fc.fused_ce_fwd_cuda(x, w, labels)
        dx, dw = fc.fused_ce_bwd_cuda(x, w, labels, lse, one)
        again = fc.fused_ce_bwd_cuda(x, w, labels, lse, one)
        torch.cuda.synchronize()
        fwd_bitwise = bool(torch.equal(loss, loss2) and torch.equal(lse, lse2))
        bitwise = bool(torch.equal(dx, again[0]) and torch.equal(dw, again[1]))
        del again, loss2, lse2
        r_loss, r_lse = fc.fused_ce_fwd_reference(x, w, labels)
        r_dx, r_dw = fc.fused_ce_bwd_reference(x, w, labels, r_lse, one)
        ref_mean = float(r_loss.mean())
        row = {"N": n, "D": d, "V": v, "chunk": fc.bwd_chunk(n, v),
               "lse_err": float((lse - r_lse).abs().max()),
               "loss_rel_err": abs(float(loss.mean()) - ref_mean) / abs(ref_mean),
               "dx_err": float((dx.float() - r_dx.float()).abs().max()),
               "dw_err": float((dw.float() - r_dw.float()).abs().max()),
               "dx_scaled_err": _scaled_err(torch, dx, r_dx),
               "dw_scaled_err": _scaled_err(torch, dw, r_dw),
               "fwd_bitwise_repeat": fwd_bitwise, "bwd_bitwise_repeat": bitwise}
        del r_dx, r_dw
        case = (n, d, v)
        if row["lse_err"] > LSE_ATOL or row["loss_rel_err"] > CE_LOSS_RTOL:
            failures.append(f"fused_ce fwd {case}: {row}")
        for name in ("dx", "dw"):
            if row[f"{name}_scaled_err"] > CE_GRAD_TOL:
                failures.append(f"fused_ce bwd {name} {case}: {row}")
        if not fwd_bitwise:
            failures.append(f"fused_ce fwd {case}: two launches differ")
        if not bitwise:
            failures.append(f"fused_ce bwd {case}: two launches differ")
        if n >= 4096:
            row["fwd_ms"] = time_ms(torch, lambda: fc.fused_ce_fwd_cuda(x, w, labels), iters)
            row["bwd_ms"] = time_ms(
                torch, lambda: fc.fused_ce_bwd_cuda(x, w, labels, lse, one), iters)
            row["fwd_plain_ms"] = time_ms(
                torch, lambda: fc.fused_ce_fwd_reference(x, w, labels), iters)
            row["bwd_plain_ms"] = time_ms(
                torch, lambda: fc.fused_ce_bwd_reference(x, w, labels, lse, one), iters)
            row["fwd_library_ms"] = time_ms(
                torch, lambda: F.cross_entropy(F.linear(x, w).float(), labels), iters)
            xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
            lib_loss = F.cross_entropy(F.linear(xr, wr).float(), labels)
            row["grad_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                lib_loss, (xr, wr), retain_graph=True), iters)
            del lib_loss, xr, wr
            for k in ("fwd", "bwd"):
                row[f"{k}_bound_ms"], row[f"{k}_bound_by"] = ce_bound(n, d, v, k)
            shape = f"N{n} D{d} V{v}"
            speed_line(7, f"fused_ce_fwd {shape}", row, "fwd_ms", "fwd_bound_ms",
                       "fwd_library_ms")
            speed_line(7, f"fused_ce_bwd {shape}", row, "bwd_ms", "bwd_bound_ms",
                       "grad_library_ms")
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

    for fn in (fa.flash_fwd_cuda, fa.flash_bwd_dkv_cuda, fa.flash_bwd_dq_cuda):
        fn.launches = fn.bias_launches = fn.bucket_launches = fn.window_launches = 0
    fa.flash_fwd_cuda.lse_launches = fa.flash_fwd_cuda.residual_launches = 0
    fa.flash_bwd_dkv_cuda.f32_launches = fa.flash_bwd_dq_cuda.f32_launches = 0
    fa.flash_bwd_dbias_cuda.launches = fa.flash_bwd_dtable_cuda.launches = 0
    fa.flash_bwd_delta_cuda.launches = 0
    for name in KERNEL_OF.values():
        fn = getattr(da, f"{name}_cuda")
        fn.launches = fn.int8_launches = 0
    fc.fused_ce_fwd_cuda.launches = fc.fused_ce_bwd_cuda.launches = 0


def _read_counters():
    """Launches since the last reset; a decode kernel's bf16 and int8
    launches apart (``<name>`` and ``<name>_int8``)."""
    from torchdistx_tpu_torch.ops import decode_attention as da
    from torchdistx_tpu_torch.ops import flash_attention as fa
    from torchdistx_tpu_torch.ops import fused_ce as fc

    out = {"flash_fwd": fa.flash_fwd_cuda.launches,
           "flash_fwd_lse": fa.flash_fwd_cuda.lse_launches,
           "flash_fwd_residuals": fa.flash_fwd_cuda.residual_launches,
           "flash_bwd_dkv_f32": fa.flash_bwd_dkv_cuda.f32_launches,
           "flash_bwd_dq_f32": fa.flash_bwd_dq_cuda.f32_launches,
           "flash_bwd_dkv": fa.flash_bwd_dkv_cuda.launches,
           "flash_bwd_dq": fa.flash_bwd_dq_cuda.launches,
           "flash_bwd_delta": fa.flash_bwd_delta_cuda.launches,
           "flash_bwd_dbias": fa.flash_bwd_dbias_cuda.launches,
           "flash_bwd_dtable": fa.flash_bwd_dtable_cuda.launches,
           "fused_ce_fwd": fc.fused_ce_fwd_cuda.launches,
           "fused_ce_bwd": fc.fused_ce_bwd_cuda.launches}
    for key, fn in (("flash_fwd", fa.flash_fwd_cuda), ("flash_bwd_dkv", fa.flash_bwd_dkv_cuda),
                    ("flash_bwd_dq", fa.flash_bwd_dq_cuda)):
        out[f"{key}_bias"], out[f"{key}_bucket"] = fn.bias_launches, fn.bucket_launches
        out[f"{key}_window"] = fn.window_launches
    for name in KERNEL_OF.values():
        fn = getattr(da, f"{name}_cuda")
        out[name] = fn.launches - fn.int8_launches
        out[f"{name}_int8"] = fn.int8_launches
    return out


def _train_failures(losses, launches, n_layers, steps, fused_ce, what):
    import math

    failures = []
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        failures.append(f"{what} losses not finite: {losses}")
    elif not losses[-1] < losses[0]:
        failures.append(f"{what} loss did not fall: {losses}")
    # one delta pre-pass per backward, read by both gradient kernels
    expect = {k: n_layers * steps for k in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq",
                                            "flash_bwd_delta")}
    for k in ("fused_ce_fwd", "fused_ce_bwd"):
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
    from torchdistx_tpu_torch.examples.train_gpt2 import main as train_main

    stream = np.random.RandomState(seed).randint(0, 50257, 4 * batch * seq + 1)

    def drive(on_step):
        train_main("gpt2_large", batch=batch, seq=seq, steps=steps + 3, fused_ce=True,
                   device="cuda", dtype=torch.bfloat16, stream=stream, log_every=1,
                   log_fn=on_step)

    return _profile(torch, drive, steps, top)


def _profile(torch, drive, steps, top=15):
    """Profile ``drive(on_step)``, which must call ``on_step`` once after
    each synchronized step, ``steps + 2`` times: the profiler waits one
    step, warms up on one and records ``steps``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    marks = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=steps)) as prof:
        def on_step(m):
            marks.append(time.perf_counter())
            prof.step()

        drive(on_step)
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


def bias_bound(b, s, hq, hkv, d, products, causal, mode, kernel):
    """Least time (ms) of one T5 flash kernel (Sq == Skv == S):
    ``products`` matrix products of 2 * D flops per visible pair, query
    head and batch row, over the bf16 peak, vs the bytes it must move over
    the memory rate: its inputs read once (q, k, v; the backward's o, dO
    and lse too, where dbias and dtable read dO, lse and the pre-pass's
    delta and no o), the bias (2 bytes a pair per head) or the table and
    the bucket ids, and its outputs written once (``kernel``: "fwd" o and
    lse, "dkv", "dq", "dbias" (Hq, S, S) bf16 or "dtable" (Hq, buckets)
    bf16; dtable's per-tile scratch is neither input nor output)."""
    pairs = _causal_pairs(s) if causal else s * s
    flops = 2.0 * products * d * pairs * b * hq
    qo = 2.0 * b * s * hq * d
    kv = 2.0 * b * s * hkv * d
    lse = 4.0 * b * hq * s
    nbytes = qo + 2 * kv
    nbytes += {"fwd": qo + lse, "dkv": 2 * qo + lse + 2 * kv, "dq": 3 * qo + lse,
               "dbias": qo + 2 * lse + 2.0 * hq * s * s,
               "dtable": qo + 2 * lse + 2.0 * hq * T5_BUCKETS}[kernel]
    nbytes += 2.0 * hq * s * s if mode == "bias" else 2.0 * hq * T5_BUCKETS + 4.0 * (2 * s - 1)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _library_bias(torch, q, k, v, do, table, bias, causal, mode, iters, scale=None):
    """SDPA at ``scale`` with the batch-broadcast float mask (the bias,
    -inf above the diagonal when causal), and in the bucket mode the table
    lookup timed in: forward ms, backward ms of (q, k, v), and backward ms
    with the mask's (and the table's) gradient, or the reason it has none."""
    F = torch.nn.functional
    s = q.shape[1]
    ids = None
    if mode == "bucket":
        from torchdistx_tpu_torch.ops import flash_attention as fa
        ids = fa.rel_bucket_matrix(s, s, (T5_BUCKETS, T5_MAX_DIST, not causal), q.device)
    causal_mask = None
    if causal:
        ones = torch.ones((s, s), dtype=torch.bool, device=q.device)
        causal_mask = torch.zeros((s, s), dtype=q.dtype, device=q.device).masked_fill(
            ~torch.tril(ones), float("-inf"))

    def mask_of(t):
        m = (t[:, ids] if ids is not None else t)[None]
        return m + causal_mask if causal_mask is not None else m

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)
    src = (table if mode == "bucket" else bias).detach()
    out = {"fwd": time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask_of(src), scale=scale), iters)}
    y = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask_of(src), scale=scale)
    out["bwd"] = time_ms(torch, lambda: torch.autograd.grad(
        y, (qt, kt, vt), dot, retain_graph=True), iters)
    try:
        srcg = src.clone().requires_grad_()
        yg = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask_of(srcg), scale=scale)
        out["bias_bwd"] = time_ms(torch, lambda: torch.autograd.grad(
            yg, (qt, kt, vt, srcg), dot, retain_graph=True), iters)
        del yg
    except RuntimeError as e:  # a yardstick only: its absence fails nothing
        out["bias_bwd"] = None
        out["bias_bwd_why"] = str(e).splitlines()[0][:200]
    del y, qt, kt, vt
    return out


def check_flash_bias(torch, device, cases=BIAS_CASES, iters=5):
    """The bias and bucket variants of the forward and backward kernels and
    the dbias and dtable kernels against their plain versions, on bf16
    N(0, 1) inputs at T5-3B's heads with an N(0, 1) table (the bias mode
    reads that table looked up, materialized), from the same saved o and
    lse: outputs within ATOL/RTOL, lse within LSE_ATOL, dbias and dtable
    scaled within BIAS_GRAD_TOL.  Each case is checked at the default
    scale 1/sqrt(D) and at T5's scale 1.0 (q then carries the 1/sqrt(D),
    as T5's initialization folds it in, and dq is held divided by
    sqrt(D)), and timed at T5's beside its
    plain version (dbias and dtable: ``flash_bias_grad_reference``, the
    plain version of that kernel alone), its bound and SDPA with the bias
    as a float mask."""
    from torchdistx_tpu_torch.ops import flash_attention as fa

    hq = hkv = T5_HEADS
    d = T5_DKV
    g = torch.Generator(device=device).manual_seed(8)
    rows, failures = [], []
    for b, s in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)

        q0, k, v, do = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, hq, d)
        table = rnd(hq, T5_BUCKETS)
        for mode, causal, scale in itertools.product(("bias", "bucket"), (False, True),
                                                     (None, 1.0)):
            q = q0 if scale is None else (q0.float() * d ** -0.5).to(torch.bfloat16)
            cfg = (T5_BUCKETS, T5_MAX_DIST, not causal)
            kw = dict(causal=causal, scale=scale, bucket_cfg=cfg)
            bias = None
            if mode == "bias":
                ids = fa.rel_bucket_matrix(s, s, cfg, device)
                bias = kw["bias"] = table[:, ids].contiguous()
            else:
                kw["table"] = table
            out = fa.flash_fwd_cuda(q, k, v, **kw)
            o, lse = fa.flash_fwd_cuda(q, k, v, return_lse=True, **kw)
            dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, o, lse, do, **kw)
            dq = fa.flash_bwd_dq_cuda(q, k, v, o, lse, do, **kw)
            # the bias gradient three times: twice on its own pre-pass, once
            # on a given delta (all three the same bits)
            dgrad_of = _bias_grad_call(fa, (q, k, v, o, lse, do), bias, table, kw)
            dgrad, repeat = dgrad_of(), dgrad_of()
            given = dgrad_of(delta=fa.flash_bwd_delta_cuda(o, do))
            torch.cuda.synchronize()
            ref_o, ref_lse = fa.flash_attention_lse_reference(q, k, v, **kw)
            rq, rk, rv, rgrad = fa.flash_bwd_reference(q, k, v, o, lse, do, **kw)
            scale_name = "1/sqrt(D)" if scale is None else scale
            case = (b, s, mode, "causal" if causal else "full", f"scale {scale_name}")
            gname = "dbias" if mode == "bias" else "dtable"
            gkey = f"{gname}_scaled_err"
            row = {"B": b, "S": s, "mode": mode, "causal": causal, "scale": scale_name,
                   "lse_err": float((lse - ref_lse).abs().max()),
                   gkey: _scaled_err(torch, dgrad, rgrad),
                   f"{gname}_bitwise_repeat": bool(torch.equal(dgrad, repeat)),
                   f"{gname}_bitwise_delta_given": bool(torch.equal(dgrad, given))}
            if not row[f"{gname}_bitwise_repeat"]:
                failures.append(f"flash {gname} {case}: two launches differ")
            if not row[f"{gname}_bitwise_delta_given"]:
                failures.append(f"flash {gname} {case}: a given delta changes the bits")
            del repeat, given
            # at T5's scale dq is that of the folded q, sqrt(D) times the
            # gradient of the q before the fold: held as the latter, the
            # quantity the default scale holds
            fold = 1.0 if scale is None else d ** -0.5
            for name, got, ref in (("out", out, ref_o), ("o", o, ref_o),
                                   ("dq", dq.float() * fold, rq.float() * fold),
                                   ("dk", dk, rk), ("dv", dv, rv)):
                ok, err = _close(torch, got, ref)
                row[f"{name}_err"] = err
                if not ok:
                    failures.append(f"flash {mode} {name} {case}: max|d|={err}")
            if row["lse_err"] > LSE_ATOL:
                failures.append(f"flash {mode} lse {case}: max|d|={row['lse_err']}")
            if row[gkey] > BIAS_GRAD_TOL:
                failures.append(f"flash {mode} {gkey} {case}: {row[gkey]}")
            del ref_o, ref_lse, rq, rk, rv, rgrad
            if scale is not None:  # timed at T5's scale, the main path's
                _time_bias_case(torch, fa, row, q, k, v, o, lse, do, table, bias, kw, iters)
            rows.append(row)
            print("flash_bias", json.dumps(row))
            del out, o, lse, dk, dv, dq, dgrad, bias
            torch.cuda.empty_cache()
    return rows, failures


def _bias_grad_call(fa, bwd, bias, table, kw):
    """The case's dbias (with a ``bias``) or dtable kernel on ``bwd`` = (q,
    k, v, o, lse, do), as a function of its ``delta=``."""
    ckw = dict(causal=kw["causal"], scale=kw["scale"])
    if bias is not None:
        return lambda **dkw: fa.flash_bwd_dbias_cuda(*bwd, bias, **ckw, **dkw)
    return lambda **dkw: fa.flash_bwd_dtable_cuda(*bwd, table, kw["bucket_cfg"], **ckw, **dkw)


def _time_bias_case(torch, fa, row, q, k, v, o, lse, do, table, bias, kw, iters):
    """The times of one case of ``check_flash_bias`` into ``row``: each
    kernel, its plain version, its bound and the SDPA yardstick."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    mode, causal = row["mode"], row["causal"]
    bwd = (q, k, v, o, lse, do)
    gname = "dbias" if mode == "bias" else "dtable"
    row["fwd_ms"] = time_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, return_lse=True, **kw),
                            iters)
    row["dkv_ms"] = time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(*bwd, **kw), iters)
    delta = fa.flash_bwd_delta_cuda(o, do)
    row["dq_ms"] = time_ms(torch, lambda: fa.flash_bwd_dq_cuda(*bwd, delta=delta, **kw), iters)
    dgrad = _bias_grad_call(fa, bwd, bias, table, kw)  # dtable's with its tile-order sum
    # the kernel alone on the pre-pass's delta, as the backward runs it; by
    # CUDA events and by device time (a call's host time may exceed it)
    row["dgrad_ms"] = time_ms(torch, lambda: dgrad(delta=delta), iters)
    row["dgrad_device_ms"] = queued_ms(torch, lambda: dgrad(delta=delta), iters)
    # and with the pre-pass, as the WMMA kernels that read o and formed
    # delta themselves ran
    row["dgrad_with_delta_ms"] = time_ms(torch, dgrad, iters)
    row["fwd_plain_ms"] = time_ms(
        torch, lambda: fa.flash_attention_lse_reference(q, k, v, **kw), iters)
    row["bwd_plain_ms"] = time_ms(torch, lambda: fa.flash_bwd_reference(*bwd, **kw), iters)
    row["dgrad_plain_ms"] = time_ms(
        torch, lambda: fa.flash_bias_grad_reference(*bwd, **kw), iters)
    lib = _library_bias(torch, q, k, v, do, table, bias, causal, mode, iters, kw["scale"])
    row["fwd_library_ms"], row["bwd_library_ms"] = lib["fwd"], lib["bwd"]
    row["dgrad_library_ms"] = lib["bias_bwd"]
    if "bias_bwd_why" in lib:
        row["dgrad_library_why"] = lib["bias_bwd_why"]
    for key, kern, prods in (("fwd", "fwd", 2), ("dkv", "dkv", 4), ("dq", "dq", 3),
                             ("dgrad", gname, 2)):
        row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = bias_bound(
            b, s, hq, hkv, d, prods, causal, mode, kern)
    shape = f"{mode} {'causal' if causal else 'full'} B{b} S{s} H{hq} D{d}"
    speed_line(11, f"lse {shape}", row, "fwd_ms", "fwd_bound_ms", "fwd_library_ms")
    speed_line(11, f"dkv {shape} (library: all three gradients)", row, "dkv_ms",
               "dkv_bound_ms", "bwd_library_ms")
    speed_line(11, f"dq {shape} (library: all three gradients)", row, "dq_ms",
               "dq_bound_ms", "bwd_library_ms")
    speed_line(11, f"{gname} {shape} (library: dq, dk, dv and the mask's gradient)", row,
               "dgrad_ms", "dgrad_bound_ms", "dgrad_library_ms")


def _t5_grads(torch, model, src, labels, use_flash, bucket):
    """Flattened f32 gradients of one backward step of the T5 loss, the
    decoder fed the labels shifted right (T5's teacher forcing: with the
    labels themselves as its input the model copies them and the gradients
    vanish)."""
    from torchdistx_tpu_torch.nn import functional as F

    saved = model.cfg.use_flash, model.cfg.flash_bucket_bias
    model.cfg.use_flash, model.cfg.flash_bucket_bias = use_flash, bucket
    tgt = torch.cat([torch.zeros_like(labels[:, :1]), labels[:, :-1]], dim=1)
    try:
        model.zero_grad(set_to_none=True)
        F.cross_entropy(model(src, tgt), labels).backward()
        return torch.cat([p.grad.float().flatten() for p in model.parameters()])
    finally:
        model.cfg.use_flash, model.cfg.flash_bucket_bias = saved


def check_t5_grads(torch, model, ref_model, bucket, seq=T5_SEQ, batch=2):
    """One backward step of the bf16 T5 through the kernels (in the chosen
    bias mode) and through the plain path, each against the f32 plain path
    of the same weights: the kernel path's gradients finite and their max
    distance from f32 no more than LOGITS_FACTOR times the plain bf16
    path's, over all parameters, over the self-attention projections
    (q, k, v, o) alone, which the flash kernels' dq, dk, dv feed, and over
    the two ``rel_bias`` tables alone, which dbias or dtable feeds (the
    max over all is set by the MLP weights' bf16 noise)."""
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(9)
    src = torch.randint(0, model.cfg.vocab_size, (batch, seq), generator=g, device=dev)
    labels = torch.randint(0, model.cfg.vocab_size, (batch, seq), generator=g, device=dev)
    names = [n for n, _ in model.named_parameters()]
    sizes = [p.numel() for p in model.parameters()]
    ref = _t5_grads(torch, ref_model, src, labels, False, False)
    kern = _t5_grads(torch, model, src, labels, True, bucket)
    plain = _t5_grads(torch, model, src, labels, False, False)
    groups = {"all": lambda n: True,
              "self_attn": lambda n: "self_attn." in n and "rel_bias" not in n,
              "rel_bias": lambda n: "rel_bias" in n}
    info = {"bucket": bucket, "layers": model.cfg.n_layers, "batch": batch, "seq": seq,
            "finite": bool(torch.isfinite(kern).all())}
    ok = info["finite"]
    for group, keep in groups.items():
        k_, r_, p_ = (torch.cat([t for n, t in zip(names, torch.split(x, sizes)) if keep(n)])
                      for x in (kern, ref, plain))
        pre = "" if group == "all" else f"{group}_"
        info[f"{pre}kernel_vs_f32"] = float((k_ - r_).abs().max())
        info[f"{pre}plain_vs_f32"] = float((p_ - r_).abs().max())
        info[f"{pre}f32_max_abs"] = float(r_.abs().max())
        ok = ok and info[f"{pre}kernel_vs_f32"] <= LOGITS_FACTOR * info[f"{pre}plain_vs_f32"]
    return ok, info


def train_t5(torch, seed, bucket, steps=TRAIN_STEPS, name="t5_3b", device="cuda",
             profile_steps=0):
    """The T5 training main path: ``build_t5_train_workload`` (deferred_init
    -> materialize_module -> AnyPrecisionAdamW) on full T5-3B, batch 4 x
    512, in one bias mode; one warm-up step, then ``Trainer.fit`` over
    ``steps`` steps with the launch counters set to 0 just before and read
    just after.  With ``profile_steps``, ``torch.profiler`` then records
    that many more steps (after one to wait and one to warm up).  In the
    bucket mode, last, :func:`repeat_step`."""
    import math
    from torchdistx_tpu_torch.utils.benchmarks import build_t5_train_workload

    w = build_t5_train_workload(name, batch=T5_BATCH, seq=T5_SEQ,
                                flash_bucket_bias=bucket, device=device, seed=seed)
    n_layers = w["model"].cfg.n_layers
    w["run"](1)  # warm-up: optimizer state, cuBLAS handles and workspaces
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    losses = w["run"](steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    tokens_per_s = w["tokens_per_batch"] * steps / wall
    what = f"{name} train ({'bucket' if bucket else 'bias'})"
    summary = {
        "model": w["name"], "bias_mode": "bucket" if bucket else "bias",
        "n_params": w["n_params"], "layers_per_stack": n_layers, "batch": w["batch_size"],
        "seq": w["seq"], "steps": steps, "losses": losses, "loss_fell": losses[-1] < losses[0],
        "step_ms": wall / steps * 1e3, "tokens_per_sec": tokens_per_s,
        "mfu": w["flops_per_token"] * tokens_per_s / H100_BF16_FLOPS,
        "flops_per_token": w["flops_per_token"],
        "deferred_init_s": w["deferred_init_s"], "materialize_s": w["materialize_s"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
    }
    failures = []
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        failures.append(f"{what} losses not finite: {losses}")
    # every self-attention of both stacks, each step: forward with lse,
    # dK/dV, dQ and the bias (or table) gradient, in this run's variant
    per = 2 * n_layers * steps
    variant = "bucket" if bucket else "bias"
    expect = {"flash_fwd_lse": per, f"flash_fwd_{variant}": per,
              "flash_bwd_dkv": per, f"flash_bwd_dkv_{variant}": per,
              "flash_bwd_dq": per, f"flash_bwd_dq_{variant}": per, "flash_bwd_delta": per,
              "flash_bwd_dtable" if bucket else "flash_bwd_dbias": per,
              "flash_bwd_dbias" if bucket else "flash_bwd_dtable": 0,
              "flash_fwd": 0}
    for kernel, n in expect.items():
        if launches[kernel] != n:
            failures.append(f"{what}: {kernel} launches {launches[kernel]} != {n}")
    if profile_steps:
        def drive(on_step):
            w["trainer"].log_fn = on_step  # called after each synchronized step
            w["run"](profile_steps + 2)

        prof = _profile(torch, drive, profile_steps)
        if isinstance(prof["device_ms_per_step"], float):
            prof["unprofiled_step_ms"] = summary["step_ms"]
            prof["device_idle_share_unprofiled"] = max(
                0.0, 1.0 - prof["device_ms_per_step"] / summary["step_ms"])
        summary["profile"] = prof
    if bucket:
        summary["repeat_step"] = repeat_step(torch, w)
    del w
    torch.cuda.empty_cache()
    return summary, failures


def repeat_step(torch, w):
    """The loss and the gradients of one training step of workload ``w``,
    computed twice from the same state and batch (no optimizer step
    between): whether the loss, the ``rel_bias`` tables' gradients and each
    other parameter's come out the same bits, and which parameters' do not.
    Recorded, not gated: ops outside the port's kernels may add in no
    fixed order."""
    model = w["model"]
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss = w["step"].loss_fn(model, w["batch"])
        loss.backward()
        runs.append((loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                                     if p.grad is not None}))
    model.zero_grad(set_to_none=True)
    (loss0, g0), (loss1, g1) = runs
    differ = [n for n in g0 if not torch.equal(g0[n], g1[n])]
    rel = [n for n in g0 if "rel_bias" in n]
    out = {"loss": float(loss0), "loss_bitwise": bool(torch.equal(loss0, loss1)),
           "rel_bias_params": rel,
           "rel_bias_bitwise": not any(n in differ for n in rel),
           "params": len(g0), "params_differing": len(differ),
           "differing": differ[:40]}
    del runs, g0, g1
    torch.cuda.empty_cache()
    return out



# -- the sliding window (Mistral) and Mixtral ------------------------------------


def _by_head_groups(torch, fn, groups, tensors, dims, cat_dims):
    """``fn`` over ``groups`` slices of the heads at a time (each tensor
    split along its entry of ``dims``), each of its outputs concatenated
    along its entry of ``cat_dims``: at S 8192 one plain pass over every
    head would take 8.6 GB of f32 logits a copy."""
    parts = [fn(*xs) for xs in zip(*(t.chunk(groups, d) for t, d in zip(tensors, dims)))]
    return tuple(torch.cat(p, d) for p, d in zip(zip(*parts), cat_dims))


def _window_plain_fwd(torch, fa, q, k, v, window, groups):
    """The plain lse forward, by head groups."""
    return _by_head_groups(
        torch, lambda *x: fa.flash_attention_lse_reference(*x, window=window), groups,
        (q, k, v), (2, 2, 2), (2, 1))


def _window_plain_out(torch, fa, q, k, v, window, groups):
    return _by_head_groups(
        torch, lambda *x: (fa.flash_attention_reference(*x, window=window),), groups,
        (q, k, v), (2, 2, 2), (2,))[0]


def _window_plain_bwd(torch, fa, q, k, v, o, lse, do, window, groups):
    """The plain backward, by head groups."""
    return _by_head_groups(
        torch, lambda *x: fa.flash_bwd_reference(*x, window=window), groups,
        (q, k, v, o, lse, do), (2, 2, 2, 2, 1, 2), (2, 2, 2))


def _library_window(torch, q, k, v, do, window, iters):
    """SDPA with the band as a boolean ``attn_mask`` (K/V repeated to the
    query heads beforehand, outside the timing): the forward, and the
    backward of all three inputs.  Null, with the reason, if SDPA refuses."""
    s = q.shape[1]
    band = torch.ones((s, s), dtype=torch.bool, device=q.device).tril_().triu_(-(window - 1))
    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(rep, 2).transpose(1, 2).detach().requires_grad_()
              for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {"fwd_library_ms": None, "bwd_library_ms": None}
    try:
        out["fwd_library_ms"] = time_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=band), iters)
        y = sdpa(qt, kt, vt, attn_mask=band)
        dot = do.transpose(1, 2)
        out["bwd_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            y, (qt, kt, vt), dot, retain_graph=True), iters)
        del y
    except RuntimeError as e:  # out of memory, or no backend for the mask
        out["library_why_null"] = str(e).splitlines()[0][:200]
    torch.cuda.empty_cache()
    return out


def check_flash_window(torch, device, cases=WINDOW_CASES, iters=5):
    """The window variants of the three flash kernels against their plain
    versions (bf16 outputs of O(1): ATOL/RTOL; per (row, head) the relative
    norm ROW_RTOL over ROW_FLOOR against the plain versions in f32, which a
    band one key short must fail; the lse to LSE_ATOL), at Mistral's heads
    (B 1, Hq 32, Hkv 8, D 128).  At S >= 2048 each is timed
    beside the causal kernel at the same shape, the plain version and SDPA
    with a boolean band mask (a yardstick the port never calls)."""
    from torchdistx_tpu_torch.ops import flash_attention as fa

    hq, hkv, d = 32, 8, 128
    g = torch.Generator(device=device).manual_seed(6)
    rows, failures = [], []
    for s, w in cases:
        def rnd(h):
            return torch.randn((1, s, h, d), generator=g, device=device,
                               dtype=torch.float32).to(torch.bfloat16)

        q, k, v, do = rnd(hq), rnd(hkv), rnd(hkv), rnd(hq)
        groups = hkv if s >= 4096 else 1
        out = fa.flash_fwd_cuda(q, k, v, window=w)
        o, lse = fa.flash_fwd_cuda(q, k, v, return_lse=True, window=w)
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, o, lse, do, window=w)
        dq = fa.flash_bwd_dq_cuda(q, k, v, o, lse, do, window=w)
        torch.cuda.synchronize()
        # the rows are held against the plain versions of the inputs widened
        # to f32: the bf16 plain forward rounds its logits and probabilities
        # to bf16 and sits up to 2e-2 of a (row, head) from f32 itself
        f32 = [x.float() for x in (q, k, v, o, do)]
        ref, lse_ref = _window_plain_fwd(torch, fa, q, k, v, w, groups)
        ref32 = _window_plain_out(torch, fa, *f32[:3], w, groups)
        rq, rk, rv = _window_plain_bwd(torch, fa, *f32[:4], lse, f32[4], w, groups)
        row = {"B": 1, "S": s, "window": w, "Hq": hq, "Hkv": hkv, "D": d,
               "band_pairs": _pairs(s, s, w), "causal_pairs": _causal_pairs(s),
               "lse_err": float((lse - lse_ref).abs().max()),
               "plain_row_err": _close_rows(torch, ref, ref32, True, ROW_FLOOR)[2]}
        for name, x, r, r32 in (("out", out, ref, ref32), ("o", o, ref, ref32),
                                ("dq", dq, rq, rq), ("dk", dk, rk, rk), ("dv", dv, rv, rv)):
            ok, row[f"{name}_err"] = _close(torch, x, r)
            rows_ok, _, row[f"{name}_row_err"] = _close_rows(torch, x, r32, True, ROW_FLOOR)
            row[f"{name}_rows_floored"] = int((r32.norm(dim=-1) < ROW_FLOOR).sum())
            if not (ok and rows_ok):
                failures.append(f"flash window {name} S={s} W={w}: max|d|={row[f'{name}_err']}"
                                f", max row err {row[f'{name}_row_err']}")
        if row["lse_err"] > LSE_ATOL:
            failures.append(f"flash window lse S={s} W={w}: max|d|={row['lse_err']}")
        if 1 < w <= s:
            # the row check must tell a band one key short at every row
            short = fa.flash_fwd_cuda(q, k, v, window=w - 1)
            row["window_minus_1_row_err"] = _close_rows(torch, short, ref32, True, ROW_FLOOR)[2]
            if row["window_minus_1_row_err"] <= ROW_RTOL:
                failures.append(f"flash window S={s} W={w}: the row check passes window {w - 1}")
            del short
        del ref, lse_ref, ref32, rq, rk, rv, f32
        torch.cuda.empty_cache()
        if s >= 2048:
            row["fwd_ms"] = time_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, window=w), iters)
            row["lse_ms"] = time_ms(
                torch, lambda: fa.flash_fwd_cuda(q, k, v, return_lse=True, window=w), iters)
            row["dkv_ms"] = time_ms(
                torch, lambda: fa.flash_bwd_dkv_cuda(q, k, v, o, lse, do, window=w), iters)
            delta = fa.flash_bwd_delta_cuda(o, do)
            row["dq_ms"] = time_ms(torch, lambda: fa.flash_bwd_dq_cuda(
                q, k, v, o, lse, do, window=w, delta=delta), iters)
            oc, lc = fa.flash_fwd_cuda(q, k, v, return_lse=True)
            dc = fa.flash_bwd_delta_cuda(oc, do)
            row["fwd_causal_ms"] = time_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v), iters)
            row["dkv_causal_ms"] = time_ms(
                torch, lambda: fa.flash_bwd_dkv_cuda(q, k, v, oc, lc, do), iters)
            row["dq_causal_ms"] = time_ms(
                torch, lambda: fa.flash_bwd_dq_cuda(q, k, v, oc, lc, do, delta=dc), iters)
            del oc, lc, dc, delta
            for kind in ("fwd", "dkv", "dq"):
                row[f"{kind}_over_causal"] = row[f"{kind}_ms"] / row[f"{kind}_causal_ms"]
            plain_iters = 2 if s >= 4096 else iters
            row["fwd_plain_ms"] = time_ms(
                torch, lambda: _window_plain_out(torch, fa, q, k, v, w, groups), plain_iters)
            row["lse_plain_ms"] = time_ms(
                torch, lambda: _window_plain_fwd(torch, fa, q, k, v, w, groups), plain_iters)
            row["bwd_plain_ms"] = time_ms(
                torch, lambda: _window_plain_bwd(torch, fa, q, k, v, o, lse, do, w, groups),
                plain_iters)
            row["plain_head_groups"] = groups
            torch.cuda.empty_cache()
            row.update(_library_window(torch, q, k, v, do, w, plain_iters))
            row["fwd_bound_ms"], row["fwd_bound_by"] = flash_bound(1, s, s, hq, hkv, d, w)
            row["dkv_bound_ms"], row["dkv_bound_by"] = bwd_bound(1, s, hq, hkv, d, 4, "kv", w)
            row["dq_bound_ms"], row["dq_bound_by"] = bwd_bound(1, s, hq, hkv, d, 3, "q", w)
            shape = f"window {w} B1 S{s} Hq{hq}/Hkv{hkv} D{d}"
            speed_line(14, f"plain {shape}", row, "fwd_ms", "fwd_bound_ms", "fwd_library_ms")
            speed_line(14, f"lse {shape}", row, "lse_ms", "fwd_bound_ms", "fwd_library_ms")
            speed_line(14, f"dkv {shape} (library: all three gradients)", row, "dkv_ms",
                       "dkv_bound_ms", "bwd_library_ms")
            speed_line(14, f"dq {shape} (library: all three gradients)", row, "dq_ms",
                       "dq_bound_ms", "bwd_library_ms")
        rows.append(row)
        print("flash_window", json.dumps(row))
        del q, k, v, do, out, o, lse, dk, dv, dq
        torch.cuda.empty_cache()
    return rows, failures


def check_mistral(torch, tt, seed, prompt_len=MISTRAL_PROMPT):
    """A CHECK_LAYERS-layer, full-width mistral_7b through the kernels (the
    window forward in the prefill, the window forward and backward kernels
    in the gradient step) and through the plain path, each held against the
    f32 plain path as ``check_logits`` and ``check_grads`` hold Llama: one
    prompt longer than the window, so the band cuts, then decode steps
    (windowed decode is plain on both paths, as in the JAX package)."""
    Llama = tt.models.Llama
    tt.manual_seed(seed)
    small = Llama.from_name("mistral_7b", dtype=torch.bfloat16, device="cuda",
                            n_layers=CHECK_LAYERS)
    small_f32 = Llama.from_name("mistral_7b", dtype=torch.float32, device="cuda",
                                n_layers=CHECK_LAYERS)
    small_f32.load_state_dict(small.state_dict())
    failures, report = [], {}
    _reset_counters()
    with torch.no_grad():
        ok, report["logits"] = check_logits(torch, small, small_f32, prompt_len=prompt_len)
    report["logits"]["window"] = small.cfg.sliding_window
    report["logits"]["prefill_window_launches"] = _read_counters()["flash_fwd_window"]
    if not ok or report["logits"]["prefill_window_launches"] != CHECK_LAYERS:
        failures.append(f"mistral logits: {report['logits']}")
    _reset_counters()
    ok, report["grads"] = check_grads(torch, small, small_f32, seq=prompt_len)
    got = _read_counters()
    report["grads"]["window_launches"] = {k: got[f"{k}_window"] for k in
                                          ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")}
    if not ok or set(report["grads"]["window_launches"].values()) != {CHECK_LAYERS}:
        failures.append(f"mistral grads: {report['grads']}")
    del small, small_f32
    torch.cuda.empty_cache()
    return report, failures


def long_requests(rng, vocab, n=8, max_new=64, lo=4097, hi=7000):
    """Greedy requests with prompts longer than Mistral's 4096-token window."""
    return [{"prompt": rng.randint(0, vocab, size=int(m)).astype("int32"),
             "max_new_tokens": max_new, "temperature": 0.0, "seed": 2000 + i}
            for i, m in enumerate(rng.randint(lo, hi + 1, size=n))]


def serve_mistral(torch, tt, seed, num_slots=8, max_len=8192):
    """The windowed serving main path: full mistral_7b (32 layers, random
    weights from the seed) through ``ServeEngine`` over a slab of 8 slots x
    8192 rows, 8 greedy requests past the window; every prefill goes
    through the window forward kernel (its counter checked), decode is
    plain (windowed decode is jnp in the JAX package too)."""
    import numpy as np
    from torchdistx_tpu_torch.serve import ServeEngine

    tt.manual_seed(seed)
    model = tt.models.Llama.from_name("mistral_7b", dtype=torch.bfloat16, device="cuda")
    model.requires_grad_(False)
    requests = long_requests(np.random.RandomState(seed), model.cfg.vocab_size)
    engine = ServeEngine(model, num_slots=num_slots, max_len=max_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, summary = run_engine(torch, engine, requests)
    m = engine.metrics.to_json()
    n_layers, prefills = model.cfg.n_layers, summary["counters"]["prefill_calls"]
    summary.update(model="mistral_7b", window=model.cfg.sliding_window, slots=num_slots,
                   max_len=max_len, prompt_lens=[len(r["prompt"]) for r in requests],
                   ttft_p50_s=m["histograms"]["ttft_s"]["p50"],
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
    failures = _greedy_failures("mistral serve", requests, results, model.cfg.vocab_size)
    failures += _launch_failures("mistral serve", summary, {
        "flash_fwd": n_layers * prefills, "flash_fwd_window": n_layers * prefills,
        "decode_attention": 0})
    if prefills != len(requests):
        failures.append(f"mistral serve: {prefills} prefills for {len(requests)} requests")
    del engine, model
    torch.cuda.empty_cache()
    return summary, failures


def train_mistral(torch, seed, steps=TRAIN_STEPS, n_layers=MISTRAL_TRAIN_LAYERS, seq=8192):
    """The windowed training main path: ``build_train_workload`` of
    mistral_7b at full width, ``n_layers`` deep, batch 1 x ``seq``
    (deferred_init -> materialize on the card -> AnyPrecisionAdamW), one
    warm-up step, then ``Trainer.fit`` over ``steps`` steps with the launch
    counters set to 0 just before: every attention forward and backward
    through the window kernels."""
    from torchdistx_tpu_torch.utils.benchmarks import build_train_workload

    w = build_train_workload("mistral_7b", batch=1, seq=seq, device="cuda", seed=seed,
                             n_layers=n_layers)
    cfg = w["model"].cfg
    w["run"](1)
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
        "model": "mistral_7b", "layers": n_layers, "window": cfg.sliding_window,
        "n_params": w["n_params"], "batch": 1, "seq": seq, "steps": steps, "losses": losses,
        "step_ms": wall / steps * 1e3, "tokens_per_sec": tokens_per_s,
        "mfu": w["flops_per_token"] * tokens_per_s / H100_BF16_FLOPS,
        "flops_per_token": w["flops_per_token"],
        "band_pairs_per_head": _pairs(seq, seq, cfg.sliding_window),
        "causal_pairs_per_head": _causal_pairs(seq),
        "deferred_init_s": w["deferred_init_s"], "materialize_s": w["materialize_s"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
    }
    failures = _train_failures(losses, launches, n_layers, steps, False, "mistral train")
    for k in ("flash_fwd_window", "flash_bwd_dkv_window", "flash_bwd_dq_window"):
        if launches[k] != n_layers * steps:
            failures.append(f"mistral train: {k} launches {launches[k]} != {n_layers * steps}")
    del w
    torch.cuda.empty_cache()
    return summary, failures


def _keep_head(path, mod):
    return "lm_head" not in path


def build_mixtral_int8(torch, tt, **overrides):
    """``deferred_init`` of mixtral_8x7b on the card, then each block
    materialized and quantized to int8 in turn (its bf16 weights released
    before the next block's are made), then the embedding, final norm and
    LM head (kept bf16).  Returns (model, seconds, peak bytes of the
    build)."""
    from torchdistx_tpu_torch.nn import quantize_module

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tt.deferred_init(tt.models.Mixtral.from_name, "mixtral_8x7b", device="cuda",
                             **overrides)
    for blk in model.blocks:
        tt.materialize_module(blk)
        quantize_module(blk)
    tt.materialize_module(model)
    model.requires_grad_(False)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def _fidelity(torch, out, ref, g):
    """JAX's MoE metric of ``out`` against ``ref``: the 99th percentile of
    |out - ref| / max|ref| (over a sample of 4M entries) and the greedy
    argmax agreement."""
    rel = ((out - ref).abs() / ref.abs().max()).flatten()
    sample = torch.randperm(rel.numel(), device=rel.device, generator=g)[:1 << 22]
    return {"rel_p99": float(torch.quantile(rel[sample], 0.99)),
            "argmax_agree": float((out.argmax(-1) == ref.argmax(-1)).float().mean()),
            "finite": bool(torch.isfinite(out).all()),
            "max_abs_diff": float((out - ref).abs().max())}


def check_mixtral_int8(torch, tt, seeds, n_layers=2, prompts=64, prompt_len=16,
                       long_len=2048):
    """A 2-layer, full-width mixtral_8x7b at each of ``seeds``: the int8
    model's logits against the same weights in bf16, held to the JAX
    package's MoE fidelity metric as its test applies it
    (``tests/test_quantization.py``: 16-token prompts): over ``prompts``
    random prompts of ``prompt_len`` tokens, the 99th percentile of
    |int8 - bf16| / max|bf16| below MIXTRAL_REL_P99 and greedy argmax
    agreement above MIXTRAL_ARGMAX.  On one ``long_len``-token prompt the
    agreement of every precision falls with the context, so there the
    int8 model's argmax agreement with the same weights in f32 is held to
    the bf16 model's, less MIXTRAL_LONG_MARGIN."""
    from torchdistx_tpu_torch.nn import quantize_module

    runs, failures = [], []
    for seed in seeds:
        tt.manual_seed(seed)
        model = tt.deferred_init(tt.models.Mixtral.from_name, "mixtral_8x7b",
                                 device="cuda", n_layers=n_layers)
        tt.materialize_module(model)
        g = torch.Generator(device="cuda").manual_seed(seed)
        vocab = model.cfg.vocab_size
        short = torch.randint(0, vocab, (prompts, prompt_len), generator=g, device="cuda")
        long = torch.randint(0, vocab, (1, long_len), generator=g, device="cuda")
        with torch.no_grad():
            f32 = tt.models.Mixtral.from_name("mixtral_8x7b", device="cuda",
                                              dtype=torch.float32, n_layers=n_layers,
                                              use_flash=False)
            f32.load_state_dict(model.state_dict())
            ref32 = f32(long).float()
            del f32
            torch.cuda.empty_cache()
            refs = [model(t).float() for t in (short, long)]
            quantize_module(model, filter_fn=_keep_head)
            outs = [model(t).float() for t in (short, long)]
        info = {"seed": seed, **_fidelity(torch, outs[0], refs[0], g),
                "long_context": {"tokens": long_len,
                                 "int8_vs_bf16": _fidelity(torch, outs[1], refs[1], g),
                                 "bf16_vs_f32": _fidelity(torch, refs[1], ref32, g),
                                 "int8_vs_f32": _fidelity(torch, outs[1], ref32, g)}}
        del model, refs, outs, ref32
        torch.cuda.empty_cache()
        lc = info["long_context"]
        ok = (info["finite"] and info["rel_p99"] < MIXTRAL_REL_P99
              and info["argmax_agree"] > MIXTRAL_ARGMAX and lc["int8_vs_f32"]["finite"]
              and lc["int8_vs_f32"]["argmax_agree"]
              >= lc["bf16_vs_f32"]["argmax_agree"] - MIXTRAL_LONG_MARGIN)
        runs.append(info)
        if not ok:
            failures.append(f"mixtral int8 fidelity: {info}")
    return {"layers": n_layers, "prompts": prompts, "tokens": prompt_len,
            "long_margin": MIXTRAL_LONG_MARGIN, "seeds": runs}, failures


def serve_mixtral(torch, tt, seed, num_slots=8, max_len=4096):
    """The Mixtral serving main path: full mixtral_8x7b (32 layers, 8
    experts, random weights from the seed) built block by block in int8,
    then ``ServeEngine`` with its dense MoE (the JAX config's
    ``capacity_factor=None``) over 8 slots x 4096 rows, 8 requests of
    16-1536 prompt tokens and 32 new tokens: every prefill through the
    flash forward kernel, every decode step through the slot decode kernel
    (counters checked), peak memory under the card's."""
    import numpy as np
    from torchdistx_tpu_torch.serve import ServeEngine

    tt.manual_seed(seed)
    model, build_s, build_peak = build_mixtral_int8(torch, tt)
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    requests = make_requests(np.random.RandomState(seed), model.cfg.vocab_size, n=8,
                             n_greedy=8, max_new=32)
    engine = ServeEngine(model, num_slots=num_slots, max_len=max_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    results, summary = run_engine(torch, engine, requests)
    m = engine.metrics.to_json()
    n_layers = model.cfg.n_layers
    total = torch.cuda.get_device_properties(0).total_memory
    summary.update(model="mixtral_8x7b", weights="int8 (embedding and norms bf16)",
                   build_s=build_s, build_peak_bytes=build_peak, weight_bytes=weight_bytes,
                   kv_cache_bytes=engine.cache.nbytes, slots=num_slots, max_len=max_len,
                   ttft_p50_s=m["histograms"]["ttft_s"]["p50"],
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   device_memory_bytes=total)
    counters = summary["counters"]
    failures = _greedy_failures("mixtral serve", requests, results, model.cfg.vocab_size)
    failures += _launch_failures("mixtral serve", summary, {
        "flash_fwd": n_layers * counters["prefill_calls"],
        "decode_attention": n_layers * counters["decode_steps"]})
    if max(build_peak, summary["peak_memory_bytes"]) >= total:
        failures.append(f"mixtral serve: peak memory {summary['peak_memory_bytes']} "
                        f"(build {build_peak}) not under the card's {total}")
    del engine, model
    torch.cuda.empty_cache()
    return summary, failures


# -- the parallel stack: the residuals and f32 variants, the ring, SP training ---


def residual_bound(b, sq, skv, hq, hkv, d, causal, bias):
    """Least time (ms) for the residuals forward: Q.K^T and P.V over the
    visible pairs at the bf16 peak vs bytes (q, k, v and a bias read once;
    the f32 accumulator, m and l written once) over the memory rate."""
    pairs = (_pairs(sq, skv) if causal else sq * skv) * b * hq
    flops = 4.0 * d * pairs
    nbytes = (2.0 * (b * sq * hq * d + 2 * b * skv * hkv * d) + 4.0 * b * sq * hq * d
              + 8.0 * b * hq * sq + (2.0 * hq * sq * skv if bias else 0.0))
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def f32_bwd_bound(b, s, hq, hkv, d, products, outputs, causal, bias):
    """:func:`bwd_bound` for the f32-output kernels, causal or not: the
    outputs written as f32, a bias read once."""
    pairs = (_causal_pairs(s) if causal else s * s) * b * hq
    flops = 2.0 * products * d * pairs
    nbytes = 2.0 * (3 * b * s * hq * d + 2 * b * s * hkv * d) + 4.0 * b * hq * s
    nbytes += 4.0 * (b * s * hq * d if outputs == "q" else 2 * b * s * hkv * d)
    nbytes += 2.0 * hq * s * s if bias else 0.0
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _plain_residuals(torch, fa, q, k, v, causal, bias, groups):
    return _by_head_groups(
        torch, lambda *x: fa.flash_attention_residuals_reference(
            *x, causal=causal, bias=bias), groups, (q, k, v), (2, 2, 2), (2, 1, 1))


def _plain_bwd_f32(torch, fa, q, k, v, o, lse, do, causal, bias, groups):
    return _by_head_groups(
        torch, lambda *x: fa.flash_bwd_reference(
            *x, causal=causal, bias=bias, dq_dtype=torch.float32,
            part_dtype=torch.float32)[:3], groups,
        (q, k, v, o, lse, do), (2, 2, 2, 2, 1, 2), (2, 2, 2))


def check_flash_residuals(torch, device, cases=RESIDUAL_CASES, iters=5):
    """The (m, l) residuals forward and the f32-output dK/dV and dQ kernels
    against their plain versions on the inputs widened to f32: the raw
    accumulator and the f32 gradients per (row, head) within ROW_RTOL of
    the row's norm (over ROW_FLOOR), the gradients element-wise within
    ATOL/RTOL too; m within RESIDUAL_M_ATOL, l within RESIDUAL_L_RTOL of
    itself.  Cases of S >= 1024 are timed beside the lse forward and the
    bf16-output kernels at the same shape, the plain versions and SDPA (a
    yardstick the port never calls)."""
    from torchdistx_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(9)
    rows, failures = [], []
    f32 = torch.float32
    for b, s, hq, hkv, d, causal, bias in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=device, dtype=f32).to(torch.bfloat16)

        q, k, v, do = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, hq, d)
        bi = rnd(hq, s, s) if bias else None
        kw = dict(causal=causal, bias=bi)
        groups = hkv if s >= 4096 else 1
        acc, m, l = fa.flash_fwd_cuda(q, k, v, return_residuals=True, **kw)
        o, lse = fa.flash_fwd_cuda(q, k, v, return_lse=True, **kw)
        dk, dv = fa.flash_bwd_dkv_cuda(q, k, v, o, lse, do, part_dtype=f32, **kw)
        dq = fa.flash_bwd_dq_cuda(q, k, v, o, lse, do, dq_dtype=f32, **kw)
        torch.cuda.synchronize()
        wide = [x.float() for x in (q, k, v, o, do)]
        bias32 = None if bi is None else bi.float()
        ra, rm, rl = _plain_residuals(torch, fa, *wide[:3], causal, bias32, groups)
        rq, rk, rv = _plain_bwd_f32(torch, fa, *wide[:4], lse, wide[4], causal, bias32, groups)
        case = {"B": b, "S": s, "Hq": hq, "Hkv": hkv, "D": d, "causal": causal, "bias": bias}
        row = dict(case, acc_max_abs_err=float((acc - ra).abs().max()),
                   acc_row_err=_close_rows(torch, acc, ra, True, ROW_FLOOR)[2],
                   m_err=float((m - rm).abs().max()),
                   l_rel_err=float(((l - rl).abs() / rl).max()))
        if (row["acc_row_err"] > ROW_RTOL or row["m_err"] > RESIDUAL_M_ATOL
                or row["l_rel_err"] > RESIDUAL_L_RTOL):
            failures.append(f"flash residuals {case}: {row}")
        for name, x, r in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
            if x.dtype != f32:
                failures.append(f"flash f32 {name} {case}: dtype {x.dtype}")
            ok, row[f"{name}_err"], row[f"{name}_row_err"] = _close_rows(
                torch, x, r, True, ROW_FLOOR)
            if not ok:
                failures.append(f"flash f32 {name} {case}: max|d|={row[f'{name}_err']}, "
                                f"max row err {row[f'{name}_row_err']}")
        del ra, rm, rl, rq, rk, rv, wide
        torch.cuda.empty_cache()
        if s >= 1024:
            plain_iters = 2 if s >= 4096 else iters
            row["res_ms"] = time_ms(torch, lambda: fa.flash_fwd_cuda(
                q, k, v, return_residuals=True, **kw), iters)
            row["lse_ms"] = time_ms(torch, lambda: fa.flash_fwd_cuda(
                q, k, v, return_lse=True, **kw), iters)
            row["res_over_lse"] = row["res_ms"] / row["lse_ms"]
            row["res_plain_ms"] = time_ms(torch, lambda: _plain_residuals(
                torch, fa, q, k, v, causal, bi, groups), plain_iters)
            row["dkv_f32_ms"] = time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(
                q, k, v, o, lse, do, part_dtype=f32, **kw), iters)
            row["dkv_bf16_ms"] = time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(
                q, k, v, o, lse, do, **kw), iters)
            delta = fa.flash_bwd_delta_cuda(o, do)
            row["dq_f32_ms"] = time_ms(torch, lambda: fa.flash_bwd_dq_cuda(
                q, k, v, o, lse, do, dq_dtype=f32, delta=delta, **kw), iters)
            row["dq_bf16_ms"] = time_ms(torch, lambda: fa.flash_bwd_dq_cuda(
                q, k, v, o, lse, do, delta=delta, **kw), iters)
            del delta
            row["bwd_plain_ms"] = time_ms(torch, lambda: _plain_bwd_f32(
                torch, fa, q, k, v, o, lse, do, causal, bi, groups), plain_iters)
            torch.cuda.empty_cache()
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
            mask = {"attn_mask": bi.expand(b, -1, -1, -1)} if bias else {"is_causal": causal}
            row["fwd_library_ms"] = time_ms(
                torch, lambda: _sdpa_gqa(torch, qt, kt, vt, **mask), iters)
            y = _sdpa_gqa(torch, qt, kt, vt, **mask)
            dot = do.transpose(1, 2)
            row["bwd_library_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                y, (qt, kt, vt), dot, retain_graph=True), iters)
            del y, qt, kt, vt
            row["res_bound_ms"], row["res_bound_by"] = residual_bound(
                b, s, s, hq, hkv, d, causal, bias)
            row["dkv_bound_ms"], row["dkv_bound_by"] = f32_bwd_bound(
                b, s, hq, hkv, d, 4, "kv", causal, bias)
            row["dq_bound_ms"], row["dq_bound_by"] = f32_bwd_bound(
                b, s, hq, hkv, d, 3, "q", causal, bias)
            shape = (f"{'causal' if causal else 'full'}{' bias' if bias else ''} B{b} S{s} "
                     f"Hq{hq}/Hkv{hkv} D{d}")
            speed_line(19, f"residuals {shape}", row, "res_ms", "res_bound_ms",
                       "fwd_library_ms")
            speed_line(19, f"dkv f32 {shape} (library: all three gradients)", row,
                       "dkv_f32_ms", "dkv_bound_ms", "bwd_library_ms")
            speed_line(19, f"dq f32 {shape} (library: all three gradients)", row,
                       "dq_f32_ms", "dq_bound_ms", "bwd_library_ms")
        rows.append(row)
        print("flash_residuals", json.dumps(row))
        del q, k, v, do, bi, acc, m, l, o, lse, dk, dv, dq
        torch.cuda.empty_cache()
    return rows, failures


def _ring_run(torch, q, k, v, do, bias, n, causal):
    """The flash ring of ``ops.attention`` on one card: ``n`` shards of the
    sequence, each simulated rank ``idx`` calling ``ring_flash_fwd_block``
    and then ``ring_bwd_block`` on the blocks ``j`` its hops hold, in the
    ring's order (the block after rank idx's own skipped when causal); the
    dK/dV accumulators of block j add up as they would travelling with it.
    Returns out, lse, dq, dk, dv (f32 gradients) and dbias."""
    from torchdistx_tpu_torch.ops import attention as A
    from torchdistx_tpu_torch.ops.flash_attention import flash_bwd_delta

    f32 = torch.float32
    s = q.shape[1] // n

    def blk(t, i):
        return t[:, i * s:(i + 1) * s]

    def hops(idx):
        for t in range(n):
            j = (idx - t) % n
            if not (causal and j > idx):
                yield j, causal and j == idx

    b, _, hq, d = q.shape
    outs, lses = [], []
    for idx in range(n):
        bias_i = None if bias is None else bias[:, idx * s:(idx + 1) * s]
        acc = torch.zeros((b, hq, s, d), dtype=f32, device=q.device)
        m = torch.full((b, hq, s), -1e30, dtype=f32, device=q.device)
        l = torch.zeros((b, hq, s), dtype=f32, device=q.device)
        for j, diag in hops(idx):
            acc, m, l = A.ring_flash_fwd_block(blk(q, idx), blk(k, j), blk(v, j), acc, m, l,
                                               causal=diag, bias=A._ring_bias_block(bias_i, j, s))
        safe = l.clamp_min(1e-30)
        outs.append((acc / safe[..., None]).transpose(1, 2).to(q.dtype))
        lses.append(m + torch.log(safe))
    dks = [torch.zeros(blk(k, 0).shape, dtype=f32, device=q.device) for _ in range(n)]
    dvs = [torch.zeros_like(x) for x in dks]
    db = None if bias is None else torch.zeros(bias.shape, dtype=f32, device=q.device)
    dqs = []
    for idx in range(n):
        bias_i = None if bias is None else bias[:, idx * s:(idx + 1) * s]
        dq = torch.zeros(blk(q, 0).shape, dtype=f32, device=q.device)
        delta = flash_bwd_delta(outs[idx], blk(do, idx))  # one for all of the rank's hops
        for j, diag in hops(idx):
            dq_c, dk_c, dv_c, db_c = A.ring_bwd_block(
                blk(q, idx), blk(k, j), blk(v, j), outs[idx], lses[idx], blk(do, idx),
                A._ring_bias_block(bias_i, j, s), causal=diag, delta=delta)
            dq += dq_c
            dks[j] += dk_c
            dvs[j] += dv_c
            if db_c is not None:
                db[:, idx * s:(idx + 1) * s, j * s:(j + 1) * s] = db_c
        dqs.append(dq)
    return (torch.cat(outs, 1), torch.cat(lses, 2), torch.cat(dqs, 1), torch.cat(dks, 1),
            torch.cat(dvs, 1), db)


def check_ring(torch, device, cases=RING_CASES, iters=2):
    """The flash ring's per-hop functions at RING_SHARDS shards in one
    process, held against attention over the whole sequence: out and the
    gradients per (row, head) within ROW_RTOL (over ROW_FLOOR) and
    element-wise, the lse within LSE_ATOL, dbias within BIAS_GRAD_TOL of
    its max; against the PR 1-2 kernels ("kernels") or the plain versions
    in f32 ("plain_f32": the forward, then the backward from the ring's own
    output and lse).  The launches of the residual and f32 kernels
    are counted: n(n + 1)/2 blocks causal, n^2 not.  The largest case
    times the ring beside the kernels over the whole sequence."""
    from torchdistx_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(10)
    n = RING_SHARDS
    rows, failures = [], []
    for name, b, s, hq, hkv, d, causal, bias, ref in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=device,
                               dtype=torch.float32).to(torch.bfloat16)

        S = n * s
        q, k, v, do = rnd(b, S, hq, d), rnd(b, S, hkv, d), rnd(b, S, hkv, d), rnd(b, S, hq, d)
        bi = rnd(hq, S, S) if bias else None
        kw = dict(causal=causal, bias=bi)
        _reset_counters()
        out, lse, dq, dk, dv, db = _ring_run(torch, q, k, v, do, bi, n, causal)
        torch.cuda.synchronize()
        got = _read_counters()
        blocks = n * (n + 1) // 2 if causal else n * n
        launches = {key: got[key] for key in ("flash_fwd_residuals", "flash_bwd_dkv_f32",
                                              "flash_bwd_dq_f32", "flash_bwd_dbias",
                                              "flash_bwd_delta")}
        want = dict.fromkeys(("flash_fwd_residuals", "flash_bwd_dkv_f32", "flash_bwd_dq_f32"),
                             blocks)
        want["flash_bwd_dbias"] = blocks if bias else 0
        want["flash_bwd_delta"] = n
        if launches != want:
            failures.append(f"ring {name}: launches {launches} != {want}")
        if ref == "kernels":
            o_ref, lse_ref = fa.flash_fwd_cuda(q, k, v, return_lse=True, **kw)
            rk, rv = fa.flash_bwd_dkv_cuda(q, k, v, o_ref, lse_ref, do, **kw)
            rq = fa.flash_bwd_dq_cuda(q, k, v, o_ref, lse_ref, do, **kw)
            rdb = fa.flash_bwd_dbias_cuda(q, k, v, o_ref, lse_ref, do, bi, causal=causal) \
                if bias else None
        else:
            groups = hkv if S >= 4096 else 1
            wide = [x.float() for x in (q, k, v, do)]
            o_ref, lse_ref = _by_head_groups(
                torch, lambda *x: fa.flash_attention_lse_reference(*x, causal=causal), groups,
                wide[:3], (2, 2, 2), (2, 1))
            # the backward from the ring's own saved output and lse, as every
            # backward kernel is held: its delta takes the bf16 output, and
            # from the f32 one instead a row whose dq nearly cancels moved
            # by 0.168 of its norm on an H100
            rq, rk, rv = _plain_bwd_f32(torch, fa, *wide[:3], out.float(), lse, wide[3],
                                        causal, None, groups)
            rdb = None
        row = {"case": name, "B": b, "shards": n, "S_shard": s, "Hq": hq, "Hkv": hkv, "D": d,
               "causal": causal, "bias": bias, "against": ref, "launches": launches,
               "lse_err": float((lse - lse_ref).abs().max())}
        for key, x, r in (("out", out, o_ref), ("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
            ok, row[f"{key}_err"], row[f"{key}_row_err"] = _close_rows(
                torch, x, r, True, ROW_FLOOR)
            if not ok:
                failures.append(f"ring {name} {key}: max|d|={row[f'{key}_err']}, "
                                f"max row err {row[f'{key}_row_err']}")
        if row["lse_err"] > LSE_ATOL:
            failures.append(f"ring {name} lse: max|d|={row['lse_err']}")
        if bias:
            row["dbias_scaled_err"] = _scaled_err(torch, db, rdb)
            if row["dbias_scaled_err"] > BIAS_GRAD_TOL:
                failures.append(f"ring {name} dbias: {row['dbias_scaled_err']}")
        if name == RING_TIMED:
            row["ring_ms"] = time_ms(torch, lambda: _ring_run(
                torch, q, k, v, do, bi, n, causal), iters)
            row["whole_fwd_bwd_ms"] = time_ms(torch, lambda: (
                fa.flash_bwd_dkv_cuda(q, k, v, o_ref, lse_ref, do, **kw),
                fa.flash_bwd_dq_cuda(q, k, v, o_ref, lse_ref, do, **kw),
                fa.flash_fwd_cuda(q, k, v, return_lse=True, **kw)), iters)
        rows.append(row)
        print("ring", json.dumps(row))
        del q, k, v, do, bi, out, lse, dq, dk, dv, db, o_ref, lse_ref, rq, rk, rv
        torch.cuda.empty_cache()
    return rows, failures


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def train_sp_llama(torch, tt, seed, steps=TRAIN_STEPS, n_layers=SP_TRAIN_LAYERS, seq=8192):
    """The sequence-parallel training main path at world size 1 on NCCL:
    ``init_multihost`` (one NCCL all-reduce checks the group), the mesh
    ``{"fsdp": 1, "sp": 1}``, ``deferred_init`` of llama3_8b at full width
    and ``n_layers`` deep with ``sp_axis="sp"``, ``materialize_module(
    sharding_rule=fsdp_shard_rule(mesh))`` on the card, then
    ``ShardedTrainStep(shard_axis="fsdp", batch_spec=(None, "sp"))`` with
    AnyPrecisionAdamW and the next-token loss: one warm-up step, then
    ``Trainer.fit`` over ``steps`` steps with the launch counters set to 0
    just before.  Every attention forward goes through the residuals
    kernel (a ring of one block), every backward through the f32-output
    kernels; remat is off (llama3_8b's config), so one of each per layer
    and step.  The first step's loss is held against the plain path's
    (``sp_axis`` off: the flash kernels) on the same weights and batch.
    Then ``torch.profiler`` records SP_PROFILE_STEPS more steps.  The
    process group stays up for phase 22."""
    import numpy as np
    import torch.distributed as dist
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import (
        ShardedTrainStep, create_mesh, fsdp_shard_rule, init_multihost)

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      WORLD_SIZE="1", RANK="0")
    init_multihost()
    probe = torch.ones(4, device="cuda")
    dist.all_reduce(probe)
    failures = [] if float(probe.sum()) == 4.0 else [f"NCCL all-reduce gave {probe}"]
    mesh = create_mesh({"fsdp": 1, "sp": 1})
    tt.manual_seed(seed)
    t0 = time.perf_counter()
    model = tt.deferred_init(tt.models.Llama.from_name, "llama3_8b", n_layers=n_layers,
                             max_seq_len=seq, sp_axis="sp", use_flash=True, device="cuda")
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tt.materialize_module(model, sharding_rule=fsdp_shard_rule(mesh))
    torch.cuda.synchronize()
    materialize_s = time.perf_counter() - t1
    materialize_peak = torch.cuda.max_memory_allocated()
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    rs = np.random.RandomState(seed)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab_size, (1, seq + 1))).to("cuda")
    batch = (toks[:, :-1], toks[:, 1:])

    def loss_fn(m, b):
        return F.cross_entropy(m(b[0]), b[1])

    cfg.sp_axis = None  # the plain path on the same weights: flash_attention
    with torch.no_grad():
        plain_loss = float(loss_fn(model, batch))
    cfg.sp_axis = "sp"
    opt = tt.AnyPrecisionAdamW(model.parameters(), lr=1e-4)
    step = ShardedTrainStep(model, opt, loss_fn, mesh, shard_axis="fsdp",
                            batch_spec=(None, "sp"))
    trainer = tt.Trainer(step, tokens_per_batch=seq, log_every=1, log_fn=lambda _: None)
    trainer.fit([batch], 1)  # warm-up
    first_loss = float(step.losses[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t2 = time.perf_counter()
    trainer.fit(itertools.repeat(batch), 1 + steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t2
    launches = _read_counters()
    losses = [float(x) for x in step.losses[1:]]
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.dim * seq
    tokens_per_s = seq * steps / wall
    summary = {
        "model": "llama3_8b", "layers": n_layers, "world_size": dist.get_world_size(),
        "backend": dist.get_backend(), "mesh": mesh.shape, "sp_mode": cfg.sp_mode,
        "remat": cfg.remat, "n_params": n_params, "batch": 1, "seq": seq, "steps": steps,
        "losses": losses, "first_loss": first_loss, "plain_first_loss": plain_loss,
        "first_loss_rel_diff": abs(first_loss - plain_loss) / abs(plain_loss),
        "step_ms": wall / steps * 1e3, "tokens_per_sec": tokens_per_s,
        "mfu": flops_per_token * tokens_per_s / H100_BF16_FLOPS,
        "flops_per_token": flops_per_token, "deferred_init_s": t1 - t0,
        "materialize_s": materialize_s, "materialize_peak_bytes": materialize_peak,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
    }
    if len(losses) != steps or not all(np.isfinite(losses)):
        failures.append(f"sp train losses not finite: {losses}")
    elif not losses[-1] < losses[0]:
        failures.append(f"sp train loss did not fall: {losses}")
    if summary["first_loss_rel_diff"] > SP_LOSS_RTOL:
        failures.append(f"sp train first loss {first_loss} vs plain {plain_loss}")
    want = {"flash_fwd_residuals": n_layers * steps, "flash_bwd_dkv_f32": n_layers * steps,
            "flash_bwd_dq_f32": n_layers * steps, "flash_bwd_dkv": n_layers * steps,
            "flash_bwd_delta": n_layers * steps,
            "flash_bwd_dq": n_layers * steps, "flash_fwd": 0, "flash_fwd_lse": 0}
    for kernel, count in want.items():
        if launches[kernel] != count:
            failures.append(f"sp train: {kernel} launches {launches[kernel]} != {count}")

    def drive(on_step):
        trainer.log_fn = on_step  # called after each synchronized step
        trainer.fit(itertools.repeat(batch), trainer.global_step + SP_PROFILE_STEPS + 2)

    prof = _profile(torch, drive, SP_PROFILE_STEPS)
    if isinstance(prof["device_ms_per_step"], float):
        prof["unprofiled_step_ms"] = summary["step_ms"]
        prof["device_idle_share_unprofiled"] = max(
            0.0, 1.0 - prof["device_ms_per_step"] / summary["step_ms"])
    summary["profile"] = prof
    del trainer, step, opt, model
    torch.cuda.empty_cache()
    return summary, failures


def _bf16_ulps(torch, a, b) -> float:
    """The largest distance between ``a`` and ``b``, element by element, in
    bf16 units in the last place at the larger magnitude."""
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    return float(((a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max())


def _checked_slowmo(torch):
    """``SlowMomentumOptimizer`` that times each slow update with CUDA events
    and holds it against the update recomputed tensor by tensor, in JAX's
    order, from the saved ``prev``, ``v`` and fast parameters with the
    identity average (one replica).  Each slow step adds a row to
    ``self.slow``; ``host_s`` is the instrumentation's host time, which the
    step time leaves out."""
    from torchdistx_tpu_torch.slowmo import SlowMomentumOptimizer

    class Checked(SlowMomentumOptimizer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.slow = []

        def _slow_update(self, params):
            t0 = time.perf_counter()
            prev = [t.clone() for t in self.prev_params]
            mom = [t.clone() for t in self.slow_momentum]
            fast = [p.detach().clone() for p in params]
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            start.record()
            super()._slow_update(params)
            end.record()
            end.synchronize()
            t2 = time.perf_counter()
            worst_p = worst_v = 0.0
            for p, v_new, pp, v, f in zip(params, self.slow_momentum, prev, mom, fast):
                v_ref = self.slowmo_factor * v + (pp - f) / self.base_lr
                p_ref = pp - (self.slowmo_lr * self.base_lr) * v_ref
                worst_v = max(worst_v, _bf16_ulps(torch, v_new, v_ref))
                worst_p = max(worst_p, _bf16_ulps(torch, p, p_ref))
            del prev, mom, fast
            torch.cuda.synchronize()
            self.slow.append({"count": self.count, "ms": start.elapsed_time(end),
                              "param_ulps": worst_p, "momentum_ulps": worst_v,
                              "host_s": (t1 - t0) + (time.perf_counter() - t2)})

    return Checked


def _fused_loss(m, b):
    from torchdistx_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

    return fused_linear_cross_entropy(m(b[0], return_hidden=True), m.lm_head.weight, b[1])


def train_slowmo(torch, tt, seed, steps=SLOWMO_STEPS, freq=SLOWMO_FREQ, batch=2, seq=2048):
    """Phase 22, SlowMo on the llama_1b training path at world size 1 on
    phase 21's NCCL group: ``deferred_init`` of full llama_1b (remat off),
    ``materialize_module`` on the card, ``ShardedTrainStep(shard_axis=None,
    replica_axes=("node",), comm_hook=slowmo_hook, divergent_replicas=True)``
    on ``hierarchical_mesh(1)`` with ``SlowMomentumOptimizer(
    AnyPrecisionAdamW(lr=1e-4), slowmo_freq=freq, base_lr=1e-4)`` and the
    fused loss: one warm-up step, then ``Trainer.fit`` over ``steps`` steps
    with the launch counters set to 0 just before.  Each slow step is held
    against its per-tensor recomputation (``_checked_slowmo``)."""
    import numpy as np
    import torch.distributed as dist
    from torchdistx_tpu_torch.parallel import ShardedTrainStep, hierarchical_mesh
    from torchdistx_tpu_torch.slowmo import SlowMoState, slowmo_hook

    failures = [] if dist.is_initialized() else ["slowmo: phase 21's process group is gone"]
    mesh = hierarchical_mesh(1)
    tt.manual_seed(seed)
    model = tt.deferred_init(tt.models.Llama.from_name, "llama_1b", max_seq_len=seq,
                             remat=False, device="cuda")
    tt.materialize_module(model)
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    rs = np.random.RandomState(seed)
    data = tuple(torch.from_numpy(rs.randint(0, cfg.vocab_size, (batch, seq))).to("cuda")
                 for _ in range(2))
    opt = _checked_slowmo(torch)(tt.AnyPrecisionAdamW(model.parameters(), lr=1e-4),
                                 slowmo_freq=freq, base_lr=1e-4)
    step = ShardedTrainStep(model, opt, _fused_loss, mesh, shard_axis=None,
                            replica_axes=("node",), comm_hook=slowmo_hook,
                            hook_state=SlowMoState(), divergent_replicas=True)
    step.stack_replicas()
    trainer = tt.Trainer(step, tokens_per_batch=batch * seq, log_every=1, log_fn=lambda _: None)
    trainer.fit([data], 1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    warm_slow = len(opt.slow)
    t0 = time.perf_counter()
    trainer.fit(itertools.repeat(data), 1 + steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters()
    slow = opt.slow[warm_slow:]
    losses = [float(x) for x in step.losses[1:]]
    step_s = (wall - sum(r["host_s"] for r in slow)) / steps
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.dim * seq
    summary = {
        "model": "llama_1b", "layers": cfg.n_layers, "world_size": dist.get_world_size(),
        "backend": dist.get_backend(), "mesh": mesh.shape, "optimizer":
        f"SlowMomentumOptimizer(AnyPrecisionAdamW, slowmo_freq={freq})", "remat": cfg.remat,
        "n_params": n_params, "batch": batch, "seq": seq, "steps": steps, "losses": losses,
        "step_ms": step_s * 1e3, "tokens_per_sec": batch * seq / step_s,
        "mfu": flops_per_token * batch * seq / step_s / H100_BF16_FLOPS,
        "flops_per_token": flops_per_token, "slow_steps": slow,
        "slow_update_ms": [r["ms"] for r in slow], "slowmo_count": opt.count,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
    }
    failures += _train_failures(losses, launches, cfg.n_layers, steps, True, "slowmo llama_1b")
    want_slow = (1 + steps) // freq - 1 // freq
    if len(slow) != want_slow:
        failures.append(f"slowmo: {len(slow)} slow steps counted, want {want_slow}")
    for r in slow:
        if max(r["param_ulps"], r["momentum_ulps"]) > SLOWMO_ULPS:
            failures.append(f"slowmo: slow step {r['count']} off its recomputation: {r}")
    del trainer, step, opt, model
    torch.cuda.empty_cache()
    return summary, failures


def _bits_checksum(torch, tensors) -> list:
    """Two int64 sums of each tensor's bit pattern, the second weighted by
    position: equal tensors give equal sums, and a changed element changes
    them (but for a collision of the weighted sum)."""
    out = []
    for t in tensors:
        bits = t.detach().contiguous().view(torch.int16 if t.element_size() == 2
                                            else torch.int32).flatten().to(torch.int64)
        w = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 65521 + 1
        out.append([int(bits.sum()), int((bits * w).sum())])
    return out


def _gossip_runs(torch, seed, steps, n_layers, seq):
    """Phase 23 on one rank of two: llama_1b at full width, ``n_layers``
    deep, from ``seed`` on every rank, each rank its row of the (2, seq)
    batch; ``hierarchical_mesh(2)``; (a) ``steps`` GossipGraD steps, (b)
    ``steps`` SlowMo steps (``slowmo_freq`` 3) on the same model.  Returns
    the per-step rows, launches and this rank's failures."""
    import math

    import numpy as np
    import torch.distributed as dist
    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.parallel import (
        GossipGraDState, ShardedTrainStep, collectives, gossip_grad_hook, hierarchical_mesh)
    from torchdistx_tpu_torch.slowmo import (
        SlowMomentumOptimizer, SlowMoState, replica_mean, slowmo_hook)

    rank = dist.get_rank()
    mesh = hierarchical_mesh(2)
    tt.manual_seed(seed)
    model = tt.deferred_init(tt.models.Llama.from_name, "llama_1b", n_layers=n_layers,
                             max_seq_len=seq, remat=False, device="cuda")
    tt.materialize_module(model)
    rs = np.random.RandomState(seed)
    data = tuple(torch.from_numpy(rs.randint(0, model.cfg.vocab_size, (2, seq))).to("cuda")
                 for _ in range(2))
    exchange = {"ms": 0.0, "bytes": 0}

    def timed(fn, count_bytes):
        def run(*args):
            torch.cuda.synchronize()
            staged, t0 = collectives._permute.staged_bytes, time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            exchange["ms"] += (time.perf_counter() - t0) * 1e3
            exchange["bytes"] += (count_bytes(args) if count_bytes
                                  else collectives._permute.staged_bytes - staged)
            return out
        return run

    def drive(step, what):
        rows = []
        trainer = tt.Trainer(step, log_every=1, log_fn=lambda _: None)
        _reset_counters()
        for i in range(steps):
            exchange.update(ms=0.0, bytes=0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.fit([data], i + 1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            sums = [None, None]
            dist.all_gather_object(sums, _bits_checksum(torch, model.parameters()))
            rows.append({"run": what, "step": i + 1, "ms": ms, "loss": float(step.losses[-1]),
                         "exchange_ms": exchange["ms"], "exchange_bytes": exchange["bytes"],
                         "ranks_bit_identical": sums[0] == sums[1]})
        launches = _read_counters()
        fails = []
        if not all(math.isfinite(r["loss"]) for r in rows):
            fails.append(f"{what} rank {rank}: losses not finite: {[r['loss'] for r in rows]}")
        want = {k: n_layers * steps for k in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq",
                                              "flash_bwd_delta")}
        want.update(fused_ce_fwd=steps, fused_ce_bwd=steps)
        fails += [f"{what} rank {rank}: {k} launches {launches[k]} != {n}"
                  for k, n in want.items() if launches[k] != n]
        return rows, launches, fails

    # (a) GossipGraD: with two nodes each takes (own + peer) * 0.5, the same
    # sum in either order, so the ranks stay bit-identical on different data
    opt = tt.AnyPrecisionAdamW(model.parameters(), lr=1e-4)
    step = ShardedTrainStep(model, opt, _fused_loss, mesh, shard_axis=None,
                            replica_axes=("node",), comm_hook=timed(gossip_grad_hook, None),
                            hook_state=GossipGraDState(2), divergent_replicas=True)
    step.stack_replicas()
    gossip_rows, gossip_launches, failures = drive(step, "gossip")
    failures += [f"gossip rank {rank}: ranks differ after step {r['step']}"
                 for r in gossip_rows if not r["ranks_bit_identical"]]
    del step, opt

    # (b) SlowMo: the nodes meet only at the slow steps (3 and 6)
    def payload(args):
        return sum(t.numel() * t.element_size() for t in args[0])

    opt = SlowMomentumOptimizer(tt.AnyPrecisionAdamW(model.parameters(), lr=1e-4),
                                slowmo_freq=3, base_lr=1e-4,
                                average_fn=timed(replica_mean, payload))
    step = ShardedTrainStep(model, opt, _fused_loss, mesh, shard_axis=None,
                            replica_axes=("node",), comm_hook=slowmo_hook,
                            hook_state=SlowMoState(), divergent_replicas=True)
    slowmo_rows, slowmo_launches, fails = drive(step, "slowmo")
    failures += fails
    for r in slowmo_rows:
        want = r["step"] % 3 == 0
        if r["ranks_bit_identical"] != want:
            failures.append(f"slowmo rank {rank}: after step {r['step']} the ranks are "
                            f"{'equal' if r['ranks_bit_identical'] else 'different'}")
    consensus = step.consensus()
    own = step.full_params()
    with mesh:
        peer = collectives.exchange(own, "node", [1, 0], [1, 0])
    mean_equal = all(torch.equal(consensus[k], (own[k] + peer[k]) * 0.5) for k in own)
    if not mean_equal:
        failures.append(f"slowmo rank {rank}: consensus() is not the mean of the two ranks")
    return {"rank": rank, "world_size": dist.get_world_size(), "backend": dist.get_backend(),
            "mesh": mesh.shape, "layers": n_layers, "seq": seq,
            "n_params": sum(p.numel() for p in model.parameters()),
            "gossip": gossip_rows, "slowmo": slowmo_rows,
            "launches_gossip": gossip_launches, "launches_slowmo": slowmo_launches,
            "consensus_is_mean": mean_equal,
            "staged_bytes_total": collectives._permute.staged_bytes,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(), "failures": failures}


def _gossip_rank(rank, world, store_path, out_path, seed, steps, n_layers, seq):
    """One spawned rank of phase 23: joins the ``gloo`` world through a
    ``FileStore``, runs ``_gossip_runs`` on ``cuda:0`` and writes its result
    (or the traceback) as JSON to ``out_path``."""
    result = {}
    try:
        import torch
        import torch.distributed as dist
        from torchdistx_tpu_torch.parallel import init_multihost

        init_multihost(num_processes=world, process_id=rank, backend="gloo",
                       store=dist.FileStore(store_path, world), timeout_s=GOSSIP_TIMEOUT_S)
        try:
            result = _gossip_runs(torch, seed, steps, n_layers, seq)
        finally:
            dist.destroy_process_group()
    except Exception:
        result["error"] = traceback.format_exc()
    with open(out_path, "w") as f:
        json.dump(result, f)


def gossip_two_ranks(seed, steps=GOSSIP_STEPS, n_layers=GOSSIP_LAYERS, seq=2048, world=2):
    """Phase 23: ``world`` spawned processes on the one card, joined over
    ``gloo`` (NCCL refuses two ranks on one device), each running
    ``_gossip_runs``; every rank is killed if the world outlives
    GOSSIP_TIMEOUT_S.  Returns the ranks' results and failures."""
    import multiprocessing as mp
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="tdx_gossip_")
    failures, ranks, wall = [], [], None
    try:
        ctx = mp.get_context("spawn")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = [ctx.Process(target=_gossip_rank, args=(r, world, os.path.join(tmp, "store"),
                                                        outs[r], seed, steps, n_layers, seq))
                 for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        deadline = time.monotonic() + GOSSIP_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        wall = time.perf_counter() - t0
        if hung:
            failures.append(f"gossip: {len(hung)} ranks still running after {GOSSIP_TIMEOUT_S} s")
        for r, (p, out) in enumerate(zip(procs, outs)):
            if not os.path.exists(out):
                failures.append(f"gossip rank {r} exited with {p.exitcode} and wrote nothing")
                continue
            with open(out) as f:
                res = json.load(f)
            if "error" in res:
                failures.append(f"gossip rank {r} raised:\n{res['error']}")
            failures += res.get("failures", [])
            ranks.append(res)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"wall_s": wall, "ranks": ranks}, failures


def sp_kernel_entries(rows, sp_run):
    """The residuals forward and the f32-output backward kernels for the
    ``kernels`` line: timed at RESIDUAL_REPORTED (the non-causal 8192 row
    beside it, ``*_full``), launches from the SP training run, the worst
    error over every case."""
    rep = next(r for r in rows if _residual_case(r) == RESIDUAL_REPORTED)
    full = next(r for r in rows if _residual_case(r) == RESIDUAL_FULL)
    shape = {"B": rep["B"], "S": rep["S"], "Hq": rep["Hq"], "Hkv": rep["Hkv"], "D": rep["D"]}
    specs = (("flash_fwd_residuals", "flash_fwd.cu", 141, "res", "fwd_library_ms",
              "res_plain_ms", "acc_max_abs_err"),
             ("flash_bwd_dkv_f32", "flash_bwd.cu", 299, "dkv", "bwd_library_ms",
              "bwd_plain_ms", ("dk_err", "dv_err")),
             ("flash_bwd_dq_f32", "flash_bwd.cu", 373, "dq", "bwd_library_ms",
              "bwd_plain_ms", ("dq_err",)))
    out = []
    for name, src, line, key, lib, plain, errs in specs:
        errs = errs if isinstance(errs, tuple) else (errs,)
        ms_key = f"{key}_ms" if key == "res" else f"{key}_f32_ms"
        entry = _kernel_entry(
            name, f"torchdistx_tpu_torch/csrc/{src}",
            f"torchdistx_tpu/ops/flash_attention.py:{line}", sp_run["launches"][name],
            {"ms": rep[ms_key], "plain_ms": rep[plain], "bound_ms": rep[f"{key}_bound_ms"],
             "bound_by": rep[f"{key}_bound_by"], "library_ms": rep[lib]},
            max(r[e] for r in rows for e in errs))
        entry.update(shape=shape, causal=True, ms_full=full[ms_key],
                     bound_ms_full=full[f"{key}_bound_ms"], library_ms_full=full[lib])
        if key == "res":
            entry.update(lse_ms=rep["lse_ms"], over_lse=rep["res_over_lse"],
                         over_lse_full=full["res_over_lse"],
                         max_row_rel_err=max(r["acc_row_err"] for r in rows),
                         m_max_abs_err=max(r["m_err"] for r in rows),
                         l_max_rel_err=max(r["l_rel_err"] for r in rows))
        else:
            entry.update(bf16_ms=rep[f"{key}_bf16_ms"],
                         max_row_rel_err=max(r[f"{e[:-4]}_row_err"] for r in rows for e in errs))
        out.append(entry)
    return out


def _residual_case(r):
    return (r["B"], r["S"], r["Hq"], r["Hkv"], r["D"], r["causal"], r["bias"])


def window_kernel_entries(rows, serve_run, train_run):
    """The window variants of the three flash kernels for the ``kernels``
    line: timed at WINDOW_REPORTED beside the causal kernel at the same
    shape, launches from the Mistral serve (prefill) and train runs, the
    worst error and the worst (row, head) relative error over every case."""
    rep = next(r for r in rows if (r["S"], r["window"]) == WINDOW_REPORTED)
    runs = (serve_run["launches"], train_run["launches"])
    out = []
    specs = (("flash_fwd_window", "flash_fwd.cu", 141, "fwd", ("out_err", "o_err"),
              "fwd_library_ms", "fwd_plain_ms"),
             ("flash_bwd_dkv_window", "flash_bwd.cu", 299, "dkv", ("dk_err", "dv_err"),
              "bwd_library_ms", "bwd_plain_ms"),
             ("flash_bwd_dq_window", "flash_bwd.cu", 373, "dq", ("dq_err",),
              "bwd_library_ms", "bwd_plain_ms"))
    for name, src, line, key, errs, lib, plain in specs:
        entry = _kernel_entry(
            name, f"torchdistx_tpu_torch/csrc/{src}",
            f"torchdistx_tpu/ops/flash_attention.py:{line}",
            sum(r.get(name, 0) for r in runs),
            {"ms": rep[f"{key}_ms"], "plain_ms": rep[plain], "bound_ms": rep[f"{key}_bound_ms"],
             "bound_by": rep[f"{key}_bound_by"], "library_ms": rep[lib]},
            max(r[e] for r in rows for e in errs))
        entry.update(max_row_rel_err=max(r[f"{e[:-4]}_row_err"] for r in rows for e in errs),
                     shape={"B": 1, "S": rep["S"], "window": rep["window"], "Hq": rep["Hq"],
                            "Hkv": rep["Hkv"], "D": rep["D"]},
                     ms_causal=rep[f"{key}_causal_ms"], over_causal=rep[f"{key}_over_causal"],
                     band_pairs=rep["band_pairs"], causal_pairs=rep["causal_pairs"],
                     launches_serve=runs[0].get(name, 0), launches_train=runs[1].get(name, 0))
        if key == "fwd":
            entry.update(lse_ms=rep["lse_ms"], lse_plain_ms=rep["lse_plain_ms"],
                         lse_max_abs_err=max(r["lse_err"] for r in rows))
        if rep.get("library_why_null"):
            entry["library_why_null"] = rep["library_why_null"]
        out.append(entry)
    return out


def _kernel_entry(name, source, replaces, launches, row, max_err):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_err, "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
    }


def t5_kernel_entries(rows, runs):
    """The T5 variants and kernels of the ``kernels`` line: timed at
    BIAS_REPORTED and T5's scale in the encoder's variant (no mask; the
    decoder's causal one beside it, ``*_causal``), launches from runs (a)
    (bias) and (b) (bucket), the worst error over every case and scale."""
    b, s = BIAS_REPORTED
    fwd_line, dkv_line, dq_line = 141, 299, 373
    timed = [r for r in rows if "fwd_ms" in r]

    def row(mode, causal):
        return next(r for r in timed if (r["B"], r["S"], r["mode"], r["causal"])
                    == (b, s, mode, causal))

    def worst(mode, keys):
        return max(r[k] for r in rows if r["mode"] == mode for k in keys)

    out = []
    for mode, run in (("bias", runs["bias"]), ("bucket", runs["bucket"])):
        gname = "dbias" if mode == "bias" else "dtable"
        specs = (
            (f"flash_fwd_{mode}", "flash_fwd.cu", fwd_line, f"flash_fwd_{mode}", "fwd",
             ("out_err", "o_err"), "fwd_library_ms", "fwd_plain_ms"),
            (f"flash_bwd_dkv_{mode}", "flash_bwd.cu", dkv_line, f"flash_bwd_dkv_{mode}", "dkv",
             ("dk_err", "dv_err"), "bwd_library_ms", "bwd_plain_ms"),
            (f"flash_bwd_dq_{mode}", "flash_bwd.cu", dq_line, f"flash_bwd_dq_{mode}", "dq",
             ("dq_err",), "bwd_library_ms", "bwd_plain_ms"),
            (f"flash_bwd_{gname}", "flash_bwd.cu", 428 if mode == "bias" else 482,
             f"flash_bwd_{gname}", "dgrad", (f"{gname}_scaled_err",), "dgrad_library_ms",
             "dgrad_plain_ms"),
        )
        for name, src, line, counter, key, errs, lib, plain in specs:
            full, causal = row(mode, False), row(mode, True)
            entry = _kernel_entry(
                name, f"torchdistx_tpu_torch/csrc/{src}",
                f"torchdistx_tpu/ops/flash_attention.py:{line}", run["launches"][counter],
                {"ms": full[f"{key}_ms"], "plain_ms": full[plain],
                 "bound_ms": full[f"{key}_bound_ms"], "bound_by": full[f"{key}_bound_by"],
                 "library_ms": full[lib]}, worst(mode, errs))
            entry.update(shape={"B": b, "S": s, "H": T5_HEADS, "D": T5_DKV},
                         ms_causal=causal[f"{key}_ms"], plain_ms_causal=causal[plain],
                         bound_ms_causal=causal[f"{key}_bound_ms"],
                         library_ms_causal=causal[lib],
                         by_case=[{"B": r["B"], "S": r["S"], "causal": r["causal"],
                                   "ms": r[f"{key}_ms"], "bound_ms": r[f"{key}_bound_ms"]}
                                  for r in timed if r["mode"] == mode])
            if key == "dgrad" and full.get("dgrad_library_why"):
                entry["library_why_null"] = full["dgrad_library_why"]
            if key == "dgrad":
                entry["bitwise_repeat"] = all(
                    r[f"{gname}_bitwise_repeat"] and r[f"{gname}_bitwise_delta_given"]
                    for r in rows if r["mode"] == mode)
                entry["ms_with_delta"] = full["dgrad_with_delta_ms"]
                entry["device_ms"] = full["dgrad_device_ms"]
                entry["device_ms_causal"] = causal["dgrad_device_ms"]
            out.append(entry)
    return out



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--report", default=None,
                    help="also write the full report as JSON to this path")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
            if name in HOPPER_LIBS:
                report[f"ptxas_{name}"] = ptxas_lines(log.read_text())
                print("\n".join(f"    {ln}" for ln in report[f"ptxas_{name}"]))
    report["build_s"] = build_s

    # -- 2. kernels vs plain versions ---------------------------------------
    try:
        flash_rows, f1 = check_flash(torch, device)
        decode_row, f2 = check_decode(torch, device)
        variant_rows, f3 = check_decode_variants(torch, device)
        failures += f1 + f2 + f3
    except Exception:
        traceback.print_exc()
        _fail("kernel phase failed")
    report["flash"], report["decode"] = flash_rows, decode_row
    report["decode_variants"] = variant_rows

    # -- 3. serve -----------------------------------------------------------
    try:
        Llama = tt.models.Llama
        tt.manual_seed(args.seed + 1)
        small = Llama.from_name("llama3_8b", dtype=torch.bfloat16,
                                device="cuda", n_layers=CHECK_LAYERS)
        small_f32 = Llama.from_name("llama3_8b", dtype=torch.float32,
                                    device="cuda", n_layers=CHECK_LAYERS)
        small_f32.load_state_dict(small.state_dict())
        report["logits"], report["verify_logits"] = [], []
        for kw in ({}, {"kv_dtype": "int8"}, {"page_size": 16},
                   {"page_size": 16, "kv_dtype": "int8"}):
            with torch.no_grad():
                ok, info = check_logits(torch, small, small_f32, **kw)
                vok, vinfo = check_verify_logits(torch, small, small_f32, **kw)
            print("logits vs f32 plain path", json.dumps(info))
            print("verify logits vs f32 plain path", json.dumps(vinfo))
            if not ok:
                failures.append(f"model logits: {info}")
            if not vok:
                failures.append(f"model verify logits: {vinfo}")
            report["logits"].append(info)
            report["verify_logits"].append(vinfo)
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
        serve_runs, profiles, f3, results = serve_modes(torch, model, requests)
        failures += f3
        same, idx = slot_independence(torch, model, requests, results, 8, 2048)
        print(f"slot independence (request {idx} alone vs in batch): {same}")
        if not same:
            failures.append(f"request {idx} alone differs from its batch stream")
        report["serve"], report["serve_runs"] = serve_runs[0], serve_runs
        report["serve_profiles"] = profiles
        with torch.no_grad():
            variants, f3 = serve_variants(torch, model, np.random.RandomState(args.seed + 4))
        failures += f3
        report["serve_variants"] = variants
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

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 11. T5 bias kernels vs plain versions ----------------------------------
    torch.cuda.empty_cache()
    try:
        bias_rows, f11 = check_flash_bias(torch, device)
        failures += f11
    except Exception:
        traceback.print_exc()
        _fail("T5 bias kernel phase failed")
    report["flash_bias"] = bias_rows

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 12. gradients at 4 layers per stack of full T5-3B width ----------------
    try:
        T5 = tt.models.T5
        tt.manual_seed(args.seed + 5)
        small = T5.from_name("t5_3b", dtype=torch.bfloat16, device="cuda",
                             n_layers=CHECK_LAYERS)
        small_f32 = T5.from_name("t5_3b", dtype=torch.float32, device="cuda",
                                 n_layers=CHECK_LAYERS)
        small_f32.load_state_dict(small.state_dict())
        report["t5_grads"] = []
        for bucket in (False, True):
            ok, info = check_t5_grads(torch, small, small_f32, bucket)
            print("t5 grads vs f32 plain path", json.dumps(info))
            if not ok:
                failures.append(f"t5 grads: {info}")
            report["t5_grads"].append(info)
        del small, small_f32
        torch.cuda.empty_cache()
    except Exception:
        traceback.print_exc()
        _fail("T5 gradient phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 13. train T5-3B, (a) materialized bias, (b) bucket table ---------------
    try:
        t5_runs = {}
        for bucket in (False, True):
            t5_summary, f13 = train_t5(torch, args.seed, bucket, profile_steps=2)
            failures += f13
            print(f"train t5_3b {t5_summary['bias_mode']}", json.dumps(t5_summary))
            t5_runs[t5_summary["bias_mode"]] = t5_summary
        report["train_t5"] = t5_runs
    except Exception:
        traceback.print_exc()
        _fail("T5 train phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 14. the window kernels vs plain versions -----------------------------
    torch.cuda.empty_cache()
    try:
        window_rows, f14 = check_flash_window(torch, device)
        failures += f14
    except Exception:
        traceback.print_exc()
        _fail("window kernel phase failed")
    report["flash_window"] = window_rows

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 15. 4 layers of full mistral_7b width: logits, decode, gradients -----
    try:
        report["mistral_check"], f15 = check_mistral(torch, tt, args.seed + 6)
        print("mistral vs f32 plain path", json.dumps(report["mistral_check"]))
        failures += f15
    except Exception:
        traceback.print_exc()
        _fail("mistral check phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 16. serve mistral_7b past its window -----------------------------------
    try:
        mistral_serve, f16 = serve_mistral(torch, tt, args.seed + 7)
        print("serve mistral_7b", json.dumps(mistral_serve))
        failures += f16
        report["serve_mistral"] = mistral_serve
    except Exception:
        traceback.print_exc()
        _fail("mistral serve phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 17. train mistral_7b at 8192 tokens ------------------------------------
    try:
        mistral_train, f17 = train_mistral(torch, args.seed)
        print("train mistral_7b", json.dumps(mistral_train))
        failures += f17
        report["train_mistral"] = mistral_train
    except Exception:
        traceback.print_exc()
        _fail("mistral train phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 18. serve mixtral_8x7b in int8 ------------------------------------------
    try:
        report["mixtral_int8_check"], f18 = check_mixtral_int8(
            torch, tt, range(args.seed + 8, args.seed + 8 + MIXTRAL_SEEDS))
        print("mixtral int8 vs bf16", json.dumps(report["mixtral_int8_check"]))
        failures += f18
        mixtral_serve, f18 = serve_mixtral(torch, tt, args.seed + 9)
        print("serve mixtral_8x7b int8", json.dumps(mixtral_serve))
        failures += f18
        report["serve_mixtral"] = mixtral_serve
    except Exception:
        traceback.print_exc()
        _fail("mixtral serve phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 19. the residuals and f32-output variants vs plain versions -------------
    torch.cuda.empty_cache()
    try:
        residual_rows, f19 = check_flash_residuals(torch, device)
        failures += f19
    except Exception:
        traceback.print_exc()
        _fail("residuals kernel phase failed")
    report["flash_residuals"] = residual_rows

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 20. the ring on one card, four shards in one process ----------------------
    try:
        report["ring"], f20 = check_ring(torch, device)
        failures += f20
    except Exception:
        traceback.print_exc()
        _fail("ring phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 21. sequence-parallel llama3_8b training at world size 1 ------------------
    try:
        sp_train, f21 = train_sp_llama(torch, tt, args.seed + 10)
        print("train sp llama3_8b", json.dumps(sp_train))
        failures += f21
        report["train_sp"] = sp_train
    except Exception:
        traceback.print_exc()
        _fail("sequence-parallel train phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 22. SlowMo on llama_1b at world size 1, on phase 21's group ---------------
    try:
        slowmo_train, f22 = train_slowmo(torch, tt, args.seed + 11)
        print("train slowmo llama_1b", json.dumps(slowmo_train))
        failures += f22
        report["train_slowmo"] = slowmo_train
    except Exception:
        traceback.print_exc()
        _fail("slowmo train phase failed")
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 23. GossipGraD and SlowMo across two ranks on the one card ----------------
    try:
        gossip, f23 = gossip_two_ranks(args.seed + 12)
        for res in gossip["ranks"]:
            for run in ("gossip", "slowmo"):
                print(f"{run} rank {res.get('rank')}", json.dumps(res.get(run)))
        print("gossip world", json.dumps({k: v for k, v in gossip.items() if k != "ranks"}))
        failures += f23
        report["gossip_two_ranks"] = gossip
    except Exception:
        traceback.print_exc()
        _fail("two-rank gossip phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 24. the record ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "not read"
    report["card"] = card
    report["smoke_s"] = time.perf_counter() - t_start
    rep = next(r for r in flash_rows if (r["B"], r["S"]) == FLASH_REPORTED)

    def bwd_row(case):
        return next(r for r in bwd_rows
                    if (r["B"], r["S"], r["Hq"], r["Hkv"], r["D"]) == case)

    brep, brep64 = bwd_row(BWD_REPORTED), bwd_row(BWD_REPORTED_D64)
    # the training main paths: llama_1b unfused and fused, gpt2_large, and
    # llama_1b under SlowMo (phase 22)
    runs = (train_summary, fused_summary, gpt2_summary, slowmo_train)

    def trained(kernel):
        return sum(r["launches"][kernel] for r in runs)

    def d64(key):  # the gpt2_large (head_dim 64) timings of a flash kernel
        return {f"{k}_d64": brep64[f"{key}{k}"] for k in ("ms", "bound_ms")}

    mixtral_fwd = mixtral_serve["launches"].get("flash_fwd", 0)
    served_fwd = sum(r["launches"]["flash_fwd"] for r in serve_runs)
    fwd = _kernel_entry(
        "flash_fwd", "torchdistx_tpu_torch/csrc/flash_fwd.cu",
        "torchdistx_tpu/ops/flash_attention.py:141",
        served_fwd + mixtral_fwd + trained("flash_fwd_lse"), rep,
        max(r["max_abs_err"] for r in flash_rows))
    fwd.update(launches_plain=served_fwd, launches_mixtral=mixtral_fwd,
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
              library_ms_d64=brep64["library_ms"], with_delta_given=True,
              backward_ms=brep["bwd_ms"], backward_ms_d64=brep64["bwd_ms"],
              bitwise_repeat=all(r["dq_bitwise_repeat"] for r in bwd_rows))
    # the dK/dV kernel's delta pre-pass (the TPU kernel computes delta in
    # its own body); no single library call computes it in f32
    delta = _kernel_entry(
        "flash_bwd_delta", "torchdistx_tpu_torch/csrc/flash_bwd.cu",
        "torchdistx_tpu/ops/flash_attention.py:299", trained("flash_bwd_delta"),
        {"ms": brep["delta_ms"], "plain_ms": brep["delta_plain_ms"],
         "bound_ms": brep["delta_bound_ms"], "bound_by": "bytes", "library_ms": None},
        max(r["delta_err"] for r in bwd_rows))
    delta.update(part_of="flash_bwd_dkv", ms_d64=brep64["delta_ms"],
                 bound_ms_d64=brep64["delta_bound_ms"])
    # the decode kernels: launches summed over the serve runs (phase 3 and
    # b-d); the bf16 one-token kernel timed at DECODE_POSITIONS as before,
    # every variant at VARIANT_POSITIONS
    served = ([r["launches"] for r in serve_runs] + [r["launches"] for r in _serve_runs(variants)]
              + [mixtral_serve["launches"]])

    def decode_entry(name, dt, row):
        key = name if dt == "bf16" else f"{name}_int8"
        entry = _kernel_entry(
            key, "torchdistx_tpu_torch/csrc/decode_attention.cu", TPU_KERNEL_OF[name],
            sum(r.get(key, 0) for r in served), row, row["max_abs_err"])
        entry.update(dtype=dt, S=row.get("S", 1), positions=row["positions"],
                     device_ms=row.get("device_ms"),
                     library_device_ms=row.get("library_device_ms"))
        for k in ("bitwise_repeat", "paged_equals_slab_bitwise", "paged_ms",
                  "paged_device_ms"):
            if k in row:
                entry[k] = row[k]
        return entry

    kernels = [fwd, dkv, delta, dq, decode_entry("decode_attention", "bf16", decode_row)]
    for row in variant_rows:
        entry = decode_entry(row["kernel"], row["dtype"], row)
        if (row["kernel"], row["dtype"]) == ("decode_attention", "bf16"):
            kernels[-1]["variant_positions"] = {
                k: entry[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                      "max_abs_err", "positions", "device_ms",
                                      "library_device_ms")}
            continue
        if "equals_slab_bitwise" in row:
            entry["equals_slab_bitwise"] = row["equals_slab_bitwise"]
        kernels.append(entry)
    # fused CE: timed at the gpt2_large loss shape, the llama_1b one beside;
    # one backward launch replaces both TPU gradient kernels, so their two
    # entries carry the same launch and the whole backward's times
    crep = next(r for r in ce_rows if (r["N"], r["D"], r["V"]) == CE_REPORTED)
    clla = next(r for r in ce_rows if (r["N"], r["D"], r["V"]) == CE_CASES[0])
    for name, k, line in (("fused_ce_fwd", "fwd", 74), ("fused_ce_bwd_dx", "bwd", 123),
                          ("fused_ce_bwd_dw", "bwd", 152)):
        lib = "fwd_library_ms" if k == "fwd" else "grad_library_ms"
        err = max(r["lse_err"] if k == "fwd" else r[f"{name[-2:]}_err"] for r in ce_rows)
        entry = _kernel_entry(
            name, "torchdistx_tpu_torch/csrc/fused_ce.cu",
            f"torchdistx_tpu/ops/fused_ce.py:{line}", trained(f"fused_ce_{k}"),
            {"ms": crep[f"{k}_ms"], "plain_ms": crep[f"{k}_plain_ms"],
             "bound_ms": crep[f"{k}_bound_ms"], "bound_by": crep[f"{k}_bound_by"],
             "library_ms": crep[lib]}, err)
        entry.update(shape={"N": crep["N"], "D": crep["D"], "V": crep["V"]},
                     launches_gpt2=gpt2_summary["launches"][f"fused_ce_{k}"],
                     launches_llama=fused_summary["launches"][f"fused_ce_{k}"],
                     ms_llama=clla[f"{k}_ms"], plain_ms_llama=clla[f"{k}_plain_ms"],
                     bound_ms_llama=clla[f"{k}_bound_ms"], library_ms_llama=clla[lib])
        entry["bitwise_repeat"] = all(r[f"{k}_bitwise_repeat"] for r in ce_rows)
        if k == "bwd":
            entry["one_launch_computes"] = "dx and dw"
        kernels.append(entry)
    kernels += t5_kernel_entries(bias_rows, t5_runs)
    kernels += window_kernel_entries(window_rows, mistral_serve, mistral_train)
    kernels += sp_kernel_entries(residual_rows, sp_train)
    # phases 22-23 apart: SlowMo at world size 1, and each rank of the
    # two-rank run (GossipGraD and SlowMo steps together)
    counter_of = {"flash_fwd": "flash_fwd_lse", "flash_bwd_dkv": "flash_bwd_dkv",
                  "flash_bwd_delta": "flash_bwd_delta", "flash_bwd_dq": "flash_bwd_dq",
                  "fused_ce_fwd": "fused_ce_fwd", "fused_ce_bwd_dx": "fused_ce_bwd",
                  "fused_ce_bwd_dw": "fused_ce_bwd"}
    for entry in kernels:
        key = counter_of.get(entry["name"])
        if key:
            entry["launches_slowmo"] = slowmo_train["launches"][key]
            entry["launches_two_ranks"] = [r["launches_gossip"][key] + r["launches_slowmo"][key]
                                           for r in gossip["ranks"]]
    report["kernels"] = kernels
    failures += [f"{k['name']}: no launch on the main path" for k in kernels
                 if not k["launches"]]
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
