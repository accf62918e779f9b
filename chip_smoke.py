"""Chip smoke test of the PyTorch/CUDA port (``torchdistx_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N] [--report PATH]

Phases, each fatal:

1. build the port's CUDA kernels from ``torchdistx_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, started together), and print the
   ptxas lines (registers, spills) of each kernel of the four kernel
   sources, ``flash_fwd.cu``, ``flash_bwd.cu`` (dbias and dtable with it),
   ``decode_attention.cu`` and ``fused_ce.cu``, and build the streamed
   tail's host function, ``stream_ring.cu``;
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
   against f32, decoding over the slab in bf16 and int8 and int8 page
   pools, one token at a time and in the speculative verify's 5-token blocks (rows
   past a slot's end included); then
   serve 16 requests of ``SERVE_NEW`` new tokens through ``ServeEngine``
   on a full-width llama3_8b with random weights drawn from the seed, in turns chunked one step a
   dispatch, then persistent (the decode loop one CUDA graph of an
   iteration, replayed);
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
   then phase 29 on the same model (below);
4. hold the flash backward kernels (``flash_bwd_dkv``, its delta
   pre-pass ``flash_bwd_delta``, ``flash_bwd_dq``) and the forward's
   ``lse`` variant (its output and its lse) against their plain versions,
   dK/dV and dQ bit for bit against a second launch, also at the shapes
   the training paths of phases 23 (c)/(d) and 25b give them, and time
   them beside the SDPA backward (a yardstick the port never calls);
5. one backward step of a 4-layer, full-width llama_1b through the kernels
   and through the plain path, each held against the f32 plain path;
6. train llama_1b at full width and depth: ``deferred_init`` on the card
   allocates nothing, ``materialize_module`` is bit-identical to an eager
   construction, then ``Trainer.fit`` takes 5 AnyPrecisionAdamW steps
   (batch 2 x 2048) with every attention forward and backward through the
   kernels (launch counters reset just before the fit); then the same 5
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
   1024) through ``examples.train_gpt2.main`` with the fused loss:
   ``TRAIN_STEPS`` steps with the launch counters reset just before (the
   first out of the trainer's window);
10. ``torch.profiler`` over one more gpt2_large step: device time per
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
13. train T5-3B at full width and 4 of its 24 layers a stack (bf16,
   batch 4 x 512) through
   ``build_t5_train_workload``: deferred init, materialize on the card,
   one warm-up step, then ``TRAIN_STEPS`` ``Trainer.fit`` steps with the launch
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
   with prompts of 4097-7000 tokens and ``MISTRAL_NEW`` new tokens, every prefill
   through the window forward kernel (counters reset just before); then the
   same requests through a persistent engine (one captured CUDA graph an
   iteration, one host sync a ring drain), its streams equal to the chunked
   run's bit for bit;
17. train mistral_7b at full width and 8 of its 32 layers (batch 1 x 8192)
   through ``build_train_workload``: deferred init, materialize on the
   card, one warm-up step, then ``TRAIN_STEPS`` ``Trainer.fit`` steps with every
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
   the card's; then the same requests persistent, as in 16 (the graph's
   capture seconds and the reserved bytes its pool took printed);
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
   card, ``ShardedTrainStep(batch_spec=(None, "sp"))`` and 5
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
   at full width and 2 of its 16 layers from the same seed and its own
   half of each batch, on ``hierarchical_mesh(2)``: (a) ``GOSSIP_STEPS``
   GossipGraD steps, after each of which the two ranks' parameters are
   bit-identical (with two nodes both take the same sum, (own + peer) *
   0.5); (b) as many SlowMo steps (``slowmo_freq`` 3), the ranks
   bit-identical after every third step and different after the others,
   and ``consensus()`` the mean of the
   two ranks' parameters; the kernels' launches on each rank, and per step
   its ms, the bytes it exchanged and the ms the exchange took; then in
   the same world (c) tensor parallelism: llama_1b at full width and 2 of
   its 16 layers, ``materialize_module(sharding_rule=llama_tp_rule(mesh,
   "tp"))`` on ``{"tp": 2}``, ``TP_STEPS`` ``GSPMDTrainStep`` steps with
   ``llama_tp_plan`` (Megatron compute, each rank's 8 of 16 heads through
   the flash kernels), and (d) expert parallelism: mixtral_8x7b at full
   width and 1 layer under ``m.shard_rule(mesh)`` on ``{"ep": 2}`` (4 of 8
   experts a rank), 2 steps with the 1e-2 aux loss; both with plain SGD
   (a gradient off by a factor shows in the update), each held against a
   world-1 run of the same seed and batch (each step's loss within
   TP_LOSS_RTOL, the first step's gradient of every parameter within
   TP_GRAD_RTOL by norm, the update by norm within TP_UPDATE_RTOL of the
   world-1 update), the flash launches of each rank counted, and per step its ms
   and the bytes its collectives handed to ``gloo`` (staged through the
   host: a check of correctness on real CUDA tensors, not of speed);
   before the world starts, the flash kernels at the shapes of the runs
   below against their plain versions (``check_parallel_kernels``: the
   residuals forward and the f32-output backward at the ring blocks, the
   dbias kernel at T5's, rows 1-3 at llama_1b's); then in the same world
   (e) GPT-2 sequence parallelism: gpt2_large at full width and 4 of its
   36 layers on ``{"sp": 2}``, 4 x 1024 tokens (512 a rank), 3 SGD steps
   through the flash ring, then one Ulysses forward on the same weights
   against the ring's; (f) T5 sequence parallelism: t5_3b at full width
   and 2 layers a stack on ``{"sp": 2}``, the materialized bias sliced per
   rank, 2 x 1024 encoder and decoder tokens, 2 steps; (g) pipeline
   parallelism: llama_1b, 4 of 16 layers (2 a stage) on ``{"pp": 2}``, the
   embedding outside the stages and the final norm, head and loss in
   ``loss_fn``, one ``pipeline_apply`` and 2 ``pipeline_train_step`` calls
   over 8 microbatches of 1 x 2048; (h) ZeRO-2: llama_1b, 2 layers, on
   ``{"dp": 2}`` through ``GSPMDTrainStep`` with ``ShardingPlan(dp_axis=
   "dp", zero2=True)`` and AnyPrecisionAdamW, ``ZERO2_STEPS`` steps, the parameters bit
   for bit against the replicated-optimizer oracle and the optimizer's
   bytes a rank half of its; (i) resharding: llama_1b, 2 layers, on
   ``{"fsdp": 2}`` with ``on_failure="reshard"``: ``inject_device_loss(1)``
   after step 2 bounces the state through the checkpoint onto ``{"fsdp":
   1}`` on rank 0 (rank 1 leaves), and 2 more steps bit-equal to a world-1
   run resumed from the replayed state; on ``{"dp": 2}`` the same loss
   takes the live path with 0 wire bytes; (e)-(g) held against a world-1
   run with the TP tolerances, the launches of every run gated; (j)
   tensor-parallel serving (after the flash and the two decode kernels it
   runs are held against their plain versions at a rank's heads, Hq 16 and
   Hkv 4): llama3_8b at full width, 2 of 32 layers, materialized under
   ``llama_tp_plan`` on ``{"tp": 2}`` and checked by ``plan.validate``
   against the card's memory, ``ServeEngine(model, mesh=, plan=)`` serving 8
   greedy requests of 16-1024 prompt tokens, 32 new, on 8 slots x 2048,
   chunked on a bf16 slab and paged with an int8 cache, each under a comm
   audit equal to its closed form and with ``gloo``'s bytes equal to
   theirs, the flash and decode launches gated on each rank, the two
   ranks' streams equal; each run against a world-1 engine of its mode on
   rank 0 (every first token equal, greedy agreement at least 0.5, the
   logits every prefill and the first decode step sampled from within 5e-2
   of the row's largest); each run again with ``numerics=True``: the
   books (the KV digests folded over ``tp``) equal on both ranks, the
   logits count its closed form, streams, counters and audit equal to the
   run's with numerics off; a persistent TP engine over ``gloo`` must be
   refused; last in the world, ``examples.long_context_sp`` (the ring) over
   ``{"sp": 2}`` at 1024 tokens, its kernel launches gated;
25. BASELINE config 5 on one card: the flash backward kernels and the lse
   forward at llama2_7b's attention (B 1, S 4096, 32 heads, D 128,
   causal) and the fused CE kernels at its loss (N 4096, D 4096, V 32000)
   against their plain versions, timed; then, in a spawned process (its
   host RSS peak its own, the card's memory to itself once the parent
   emptied its cache), ``build_train_workload("llama2_7b", batch=1,
   seq=4096, optimizer="adamw_8bit", remat=True, remat_policy="dots",
   fused_ce=True)`` on full llama2_7b (32 layers, dim 4096, bf16):
   deferred init (no card bytes), materialize on the card, 1 warm-up
   step, 2 timed ``Trainer.fit`` steps with the launch counters set to 0
   just before (the flash forward twice a layer a step: ``dots``
   recomputes it), then ``torch.profiler`` over one more step; gated on
   finite losses, the host RSS growth under 32 GB, 6.74e9 parameters on
   the card in bf16, 2.03 bytes of 8-bit state a parameter and the
   launches;
25b. Mixtral-8x7B trained, in phase 25's process once config 5 has
   released its model, optimizer and cache: ``deferred_init`` of
   mixtral_8x7b at full width (dim 4096, 32/8 heads, 8 experts, top-2, ffn
   14336, V 32000) and 4 of its 32 layers (6.07e9 parameters, bf16, remat
   "full"), ``materialize_module(sharding_rule=m.shard_rule(mesh))`` on a
   world-1 ``{"dp": 1, "ep": 1}`` mesh, then ``GSPMDTrainStep`` with
   ``ShardingPlan(mesh, rules=MIXTRAL_EP_RULES)`` (the same placement,
   checked) and the 8-bit AdamW through ``Trainer.fit``: the loss
   ``cross_entropy + 1e-2 * aux`` through ``forward_with_aux``, its first
   value held against the plain attention path's on the same weights and
   batch (rtol 1e-4), one warm-up step, 2 timed steps at 1 x 4096 with the
   launch counters set to 0 just before (every attention forward and
   backward through the flash kernels; remat "full" runs the forward twice
   a layer a step): step ms, tokens/s, MFU on active parameters (6 x
   (non-expert + 2/8 of the expert parameters) + 12 L dim seq FLOPs a
   token), peak; the aux finite and positive; then on the same model the
   capacity dispatch, set on its MoE modules: ``"gather"`` at
   ``capacity_factor`` 4.0 (no token can drop) against the dense forward,
   each MoE layer on the input the dense forward gave it (max |difference|
   / max |output| within 2e-2), and the whole forward in both modes, its
   routing compared layer by layer (no token changes experts in the first
   MoE layer, and after it only tokens whose k-th and (k+1)-th router
   logits lay within twice the largest change the other mode made to a
   logit; the logits of the tokens routed alike in every layer within
   2e-2 of the largest, those of all tokens and the argmax agreement
   printed), and 1 timed step at 1.25; between the two,
   ``torch.profiler`` over one more dense step;
26. checkpoint, resume and the failure policy on llama_1b at full width
   and 4 of its 16 layers with the 8-bit AdamW and the fused loss:
   ``Trainer.fit`` to step 4 with a checkpoint every 2 steps, ``restore``
   of step 2 (parameters and codes bit-identical to those saved), on to
   step 4 again (losses within 2e-3 of the first run's; whether bitwise
   is printed); then a fresh ``Trainer`` with a ``FailureDetector`` and
   ``on_failure="restore"`` whose loss is made non-finite at step 3 rolls
   back to its step-2 checkpoint and logs what the CPU tests expect;
27. BASELINE config 2 in a spawned process (phase 28 follows in the same
   one): ``build_vision_train_workload("resnet50")`` in f32,
   ``deferred_init`` (no card bytes) then ``materialize_module`` on the
   card (25,557,032 parameters; deferred-init and materialize seconds,
   host RSS growth under 32 GB), its eval forward at 2 x 224 x 224 held
   against the same weights' forward on the CPU (f32, TF32 off, within
   1e-3 of the largest logit), then bf16 ResNet-50 at 128 x 224 x 224
   with AnyPrecisionAdamW: one warm-up step, 5 timed ``Trainer.fit``
   steps (step ms, images/s, MFU at 3 x 8.18e9 FLOPs an image, peak) with
   the launch counters set to 0 just before (no port kernel lies on this
   path: cuDNN's convolutions stand where the JAX package's XLA
   convolutions do), the BatchNorm running statistics unchanged (the JAX
   semantics), then ``torch.profiler`` over one more step (cuDNN's
   kernels, its layout transforms included, in the class ``conv``);
28. ViT-B/16 the same way: f32 deferred init and materialize (86,567,656
   parameters), the eval forward against the CPU at batch 2, bf16 training
   at 64 x 224 x 224 (3 x 35.1e9 FLOPs an image), one profiled step; its
   attention is the plain einsum path, as in the JAX package;
29. in phase 3's process, on its full-width llama3_8b, with the cost cards
   on and buckets (64, 512, 2048): (a) chunked prefill, 8 slots x 2048,
   slab and paged, persistent with an 8-row ring, ``chunked_prefill=512``:
   4 short requests decoding, then 4 prompts of 1200-1536 tokens and 4
   more short ones; gated on 4 chunked prefills,
   decode dispatches between chunks, the flash launches equal to the
   layers times the cold prefills and first chunks, the mid-cache chunks
   on the plain path, and the long prompt's last logits chunked against
   one unchunked prefill (CHUNK_LOGITS_RTOL); the share of streams equal
   to an unchunked engine's printed; (b) the paged engine's
   ``memory_plan()`` (weights and KV exact, ``program_temp`` from the
   cards), a budget one byte short refusing with ``why == "hbm_budget"``,
   the raised budget admitting on the next step; (c) 16 greedy requests of
   the ``diurnal`` catalog scenario (64 new tokens, in waves by arrival
   tick) through three paged persistent replicas behind
   ``AffinityPolicy`` (the busiest removed in the last wave: no drop), a
   warmed replica added (its program count unmoved by routed traffic),
   then one prefill replica and two persistent decode replicas (one
   graph capture each, replays equal to loop iterations), every stream
   bit for bit against one engine of the same geometry, every handoff
   moving pages over zero wire; (d) ``migrate_to`` an engine of 5 slots (the share of streams
   equal to an undrained run printed); (e) ``AutoscaleController`` with
   ``LoadSignal`` over a cut flash crowd, twice: identical decisions, no
   drop, a scale-up; every part's launches counted, and no cost-card
   probe failed; (c)'s disaggregated fleet records its session;
30. in phase 3's process, after phase 29, on its llama3_8b: (c) the
   streamed tail, ``persistent_stream=True`` on (c)'s one-engine geometry
   and scenario: one push a loop iteration (a host node of the captured
   iteration, ``csrc/stream_ring.cu``), each dispatch's live rows the
   tokens its drain gave, every first-token stamp before its drain, the
   streams, host syncs and tokens those of (c)'s run without the stream;
   (d) the black box: (c)'s one-engine run recorded (its counters, host
   syncs included, those of the unrecorded run), the stream's cost an
   iteration (that engine's and (c)'s captured iterations replayed in
   alternating blocks at their fixpoint, one host function a streamed
   replay), then the run replayed, (c)'s
   recorded disaggregated fleet replayed, both chains equal, both files
   valid, a copy with one token changed naming its drain and request;
   then, once llama3_8b is freed: (a) full gpt2_large (36 layers, dim
   1280, 20 heads of 64: group size 1, bf16, 774,030,080 parameters):
   one 768-token prompt's logits through the kernels against the f32
   plain path (the 2x rule), then ``ServeEngine`` over 8 slots x 1024, 16
   requests of 16-768 prompt tokens and 64 new ones (12 greedy, 4
   sampled) chunked one step a dispatch, persistent and chunked eight
   steps a dispatch (every stream equal to the first), the paged engine
   with the prefix cache cold and warm (cold equal to the slab engine),
   speculate 4 and paged + speculate 4 + int8 on repeating prompts (each
   above one token a verify; the share of streams equal to a run without
   drafts printed), each run's flash and decode launches exactly the
   layers times its cold prefills and its decode steps; one persistent
   decode ring profiled (the engine's ``serve/*`` annotations left out);
   the four decode kernels at this shape, bf16 and int8, against their
   plain versions and timed beside their bounds and SDPA (``speed`` lines
   of phase 30); (b) full T5-3B (24 + 24 layers, bf16):
   ``generate_encdec`` of 32 tokens for 4 x 512 encoder tokens with the
   materialized bias and with the bucket table, one flash launch an
   encoder layer, the first decode step's logits against the f32 plain
   model (the 2x rule); (e) phase 26's llama_1b through ``Trainer.fit``,
   3 steps with ``flight``, ``record``, ``stall_timeout_s``,
   ``cost_card`` and numerics on, then off, then numerics alone: the
   losses equal, the two numerics books of the JAX step's site families
   (``params``, ``act``, ``loss``, ``grads``) with equal integer fields;
   a step, a parameter set to NaN, a step: the failure's flight record
   names its ``params/`` site;
31. in phase 3's process, after (d), on its llama3_8b: the numerics
   observatory (``ServeEngine(numerics=True)``) over phase 3's requests,
   chunked one step a dispatch and persistent on the slab (against phase
   3's runs) and persistent paged int8 (against a run without it): the
   same streams, ``host_syncs``, ``decode_dispatches``, ``decode_steps``
   and ``prefill_calls`` equal, every book's partition identity, no
   nonfinite value, ``logits.count`` equal to its closed form
   (:func:`logits_count`), the int8 error within half a scale and no
   anomaly; the persistent run twice, both records turned into
   ``tdx-ledger-v1`` rows (each valid) and the second gated against the
   first's expectations (``ok``); decode device ms a step with numerics on
   against off (``torch.profiler``, in this call).  One ``(31) numerics``
   line a mode; the runs' launches count in the kernels line.
33. after phase 6, the examples a user runs on one card:
   ``examples.quantized_inference`` on full llama_1b (bf16, every
   ``Linear`` but the head to int8, 64 greedy tokens; the flash forward
   once a layer) and ``examples.elastic_training`` (the poisoned batch of
   step 30 rolled back to step 20's checkpoint, 60 steps, finite
   parameters).  Phase 6 also materializes llama_1b twice with
   ``TDX_NUMERICS=1``: the replays' ``replay/chunk`` books bit-identical.

Phases 2, 4, 11, 14 and 19 print one ``speed`` line per forward, dK/dV and
dQ variant and per decode variant, phase 7 one per fused CE kernel and
shape, phase 11 one per dbias and dtable variant: its ms, bound and
library ms, the factor over the library and over the bound (the decode
variants also by device time), phase 25 one per kernel at config 5's
shapes; phases 22-23 one ``train slowmo llama_1b`` line and one
``gossip``/``slowmo``/``tp llama_1b``/``ep mixtral_8x7b``/``sp gpt2_large``/``sp
t5_3b``/``pp llama_1b``/``zero2 llama_1b``/``reshard llama_1b``/``tp serve
llama3_8b`` line per rank,
phase 25 ``train llama2_7b config 5`` and ``train mixtral_8x7b``, phase 26 ``checkpoint and failure llama_1b``, phases 27-28 ``train
resnet50 config 2`` and ``train vit_b16``, phase 29 one line a part
((a) to (e): requests, tokens/s, TTFT p50, counters, launches) and
``serve fleet launches``.  Each phase's start
second is printed (``phase start``).  It prints the card's name and power limit, one ``{"kernels":
[...]}`` line and, last, ``{"ok": true, "device": {...}}``.  In the kernels
line each flash and fused-CE entry's ``launches`` counts phase 25b's
timed Mixtral steps among the training runs (also apart, as
``launches_mixtral_train``), ``launches_tp_ep_ranks`` gives each
rank's launches in phase 23 (c) and (d), ``launches_parallel_ranks``
in (e)-(i), ``launches_tp_serve_ranks`` in (j) (each rank's, a run), and
the flash forward's and the decode kernels'
``launches_serving_fleet`` phase 29's (also in ``launches``); the
flash forward's and the decode kernels' ``launches_gpt2_serving`` and
the T5 forward variants' ``launches_t5_generation`` phase 30's (also in
``launches``), and each decode entry's ``gpt2_shape`` its times at
gpt2_large's serving shape.  Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero and prints
no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# training shape (D 128) and the gpt2_large one (D 64); the last three are
# the attention of phase 25b's mixtral_8x7b and, per rank, of phase 23's
# tensor-parallel llama_1b (c) and expert-parallel mixtral_8x7b (d)
BWD_CASES = [(1, 37, 4, 4, 128), (1, 1000, 32, 8, 128), (2, 2048, 16, 16, 128),
             (1, 2048, 32, 8, 128), (1, 130, 8, 8, 64), (8, 1024, 20, 20, 64),
             (1, 4096, 32, 8, 128), (1, 2048, 8, 8, 128), (1, 1024, 32, 8, 128)]
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
# timed training steps of phases 6, 9, 13, 17 and 21 (10 before phase 30, 5
# before phase 23 (j))
TRAIN_STEPS = 3
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
# the T5-3B training runs: scripts/bench_t5_train.py's batch and length, at
# full width and T5_TRAIN_LAYERS of its 24 layers a stack (cut to keep the
# smoke inside its time: 12 with phases 25-26, 8 with phases 23 (c)/(d) and
# 25b, 4 with phase 30)
T5_BATCH, T5_SEQ = 4, 512
T5_TRAIN_LAYERS = 4
# engine counters a serve run reports
# the serve runs before phase 29 read the allocator's peak across a whole
# run, and a cost card's probe resets it at a program's first dispatch: those
# engines run with cost_cards=False (phase 29's with the cards on)
SERVE_COUNTERS = ("prefill_calls", "decode_steps", "tokens_prefilled", "tokens_decoded",
                  "prefix_hit_tokens", "pages_evicted", "draft_tokens_proposed",
                  "draft_tokens_accepted", "host_syncs", "ring_drains",
                  "ring_full_drains", "loop_iterations", "decode_dispatches")
# the main serve run's decode modes, run in turns on one model: the
# chunked engine one step a dispatch, the persistent loop (one CUDA graph
# of an iteration, replayed) (two more turns, persistent and chunked-1
# again, were cut to keep the smoke inside its time with phases 23 (c)/(d)
# and 25b; the chunked turn of eight steps a dispatch runs on gpt2_large in
# phase 30 (a) since phase 30)
SERVE_MODES = (("chunked-1", {}), ("persistent", {"decode_mode": "persistent"}))
# new tokens of each request of phase 3's serve runs and its variants (b)-(d)
# (64 before phase 23 (j))
SERVE_NEW = 32
# decode steps run before, and profiled in, each mode's profile window: one
# persistent ring of this capacity (2, not 32, to keep the smoke inside its
# time: the profiler's key_averages takes about a second a profiled step; 4
# before phase 23 (j))
PROFILE_RING = 2
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
# new tokens of each of phase 16's 8 requests (64 before phase 23 (j))
MISTRAL_NEW = 32
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
GOSSIP_LAYERS = 2  # 4 before phase 30
GOSSIP_STEPS = 4  # 6 before phase 23 (j); SlowMo syncs at step 3, parts at 4
GOSSIP_TIMEOUT_S = 480
# phase 23 (c) and (d) in the same world: tensor parallelism on {"tp": 2},
# llama_1b at full width and TP_LAYERS of its 16 layers, TP_STEPS steps at
# 1 x TP_SEQ; expert parallelism on {"ep": 2}, mixtral_8x7b at full width
# and EP_LAYERS of its 32 layers, EP_STEPS steps at 1 x EP_SEQ; both with
# plain SGD at TP_LR (the update is the gradient, scaled: a gradient off by
# a factor shows in it), held against a world-1 run of the same seed and
# batch (bf16 products summed in another order): each step's loss within
# TP_LOSS_RTOL, the first step's gradient of every parameter within
# TP_GRAD_RTOL of the world-1 one by norm, and the update every parameter
# took, p - p0, within TP_UPDATE_RTOL of the world-1 update by norm over
# the model
# phase 23 (j) in the same world: tensor-parallel serving of llama3_8b at
# full width (bf16), TP_SERVE_LAYERS of its 32 layers, on {"tp": 2}: 8
# greedy requests of 16-1024 prompt tokens, TP_SERVE_NEW new, on
# TP_SERVE_SLOTS slots x 2048, chunked 1 step a dispatch on a bf16 slab and
# paged (page 16) with an int8 cache, each under a comm audit held to the
# engine's closed form and gloo's bytes to theirs; each run held against a
# world-1 engine of the same mode on rank 0 over the same seed's model
# whole (its pieces gathered): every stream's first token equal, the greedy
# agreement at least TP_SERVE_AGREEMENT (0.738 slab, 0.699 paged int8 in
# the first runs: bf16 partial products summed in another order part the
# streams at token 5 or later), and the logits the dispatches sampled from
# (each prefill's, the first decode step's) within TP_SERVE_LOGITS_RTOL of
# the row's largest world-1 logit (0.0103 and 0.0110 for the first
# request); the two ranks' streams equal
TP_SERVE_LAYERS = 2
TP_SERVE_REQUESTS, TP_SERVE_NEW, TP_SERVE_SLOTS = 8, 32, 8
TP_SERVE_AGREEMENT = 0.5
TP_SERVE_LOGITS_RTOL = 5e-2
TP_SERVE_RUNS = (("slab", {"decode_chunk": 1}), ("paged_int8", {"page_size": 16,
                                                                 "kv_dtype": "int8"}))
# the decode variants (layout, S, dtype) those runs launch, checked at a
# rank's heads before the world starts
TP_SERVE_VARIANTS = (("slab", 1, "bf16"), ("paged", 1, "int8"))
TP_LAYERS, TP_STEPS, TP_SEQ = 2, 2, 2048  # 3 steps before phase 23 (j)
EP_LAYERS, EP_STEPS, EP_SEQ = 1, 2, 1024
TP_LR = 10.0
# about 3x the largest readings on an H100 (losses 2.6e-4, gradients
# 0.017, updates 0.030)
TP_LOSS_RTOL = 8e-4
TP_GRAD_RTOL = 0.05
TP_UPDATE_RTOL = 0.09
# phase 25: BASELINE config 5 on one card, full llama2_7b trained with the
# 8-bit AdamW and remat_policy="dots" in a spawned process (its host RSS
# peak its own, the card's memory to itself); the kernels first at its
# shapes: the flash backward at B 1, S 4096, 32 heads, D 128, causal, the
# fused CE at its loss (N 4096, D 4096, V 32000)
CONFIG5_BATCH, CONFIG5_SEQ = 1, 4096
CONFIG5_WARMUP, CONFIG5_STEPS = 1, 2  # 2, 4 before phase 30
CONFIG5_PROFILE_STEPS = 1
CONFIG5_BWD_CASE = (1, 4096, 32, 32, 128)
CONFIG5_CE_CASE = (4096, 4096, 32000)
CONFIG5_PARAMS = 6.74e9  # Llama-2-7B
CONFIG5_HOST_RSS_GB = 32.0  # BASELINE.json's host RAM target
CONFIG5_STATE_BYTES = (2.02, 2.04)  # 8-bit moments: 2 + 2 * 4 / 256 a parameter
CONFIG5_TIMEOUT_S = 600
# phase 25b, in phase 25's spawned process once config 5 has released the
# card: mixtral_8x7b at full width (dim 4096, 32/8 heads, 8 experts, top-2,
# ffn 14336) and MIXTRAL_TRAIN_LAYERS of its 32 layers, bf16, born
# expert-sharded on a world-1 {"dp", "ep"} mesh, trained through
# GSPMDTrainStep with the 8-bit AdamW, remat "full" and the Switch aux loss
# at MIXTRAL_AUX_WEIGHT: warm-up, timed steps, then the capacity dispatch
# (gather) at capacity 4.0 (no token can drop: E / top_k) against the dense
# forward and MIXTRAL_CAPACITY_STEPS steps at 1.25
MIXTRAL_TRAIN_LAYERS, MIXTRAL_TRAIN_SEQ = 4, 4096
MIXTRAL_TRAIN_WARMUP, MIXTRAL_TRAIN_STEPS = 1, 2  # 3 steps before phase 30
MIXTRAL_CAPACITY_STEPS = 1  # 2 before phase 30
MIXTRAL_PROFILE_STEPS = 1
MIXTRAL_AUX_WEIGHT = 1e-2
MIXTRAL_TRAIN_LR = 1e-5
MIXTRAL_TRAIN_PARAMS = 6.066e9  # 4 layers of 1.451e9, the embedding and the head
# the kernels' first loss against the plain path's: about 5x the gap
# measured on an H100 (1.8e-5)
MIXTRAL_LOSS_RTOL = 1e-4
# each MoE layer in gather mode against dense on the same input, by
# max |difference| / max |output| (a bf16 rounding can flip a router
# near-tie and send a token to other experts in the layers after, so the
# whole forward's logits over all tokens and its argmax agreement are
# printed, not gated)
MIXTRAL_GATHER_RTOL = 2e-2
# and in the whole forward, layer by layer, the tokens whose top-2 experts
# differ between the two modes: none in the first MoE layer (the same
# input), and after it only tokens whose router margin the other mode's
# rounding could close (``_route_flips``); the logits of the tokens routed
# alike in every layer within MIXTRAL_GATHER_RTOL of the largest
MIXTRAL_EP_RULES = ((r"\.mlp\.(w_gate|w_up|w_down)$", ("ep", None, None)),)
# phase 26: checkpoint, resume and the failure policy on llama_1b at full
# width and CKPT_LAYERS of its 16 layers; resumed losses within CKPT_LOSS_ATOL
# of the uninterrupted run's
CKPT_LAYERS = 4
CKPT_LOSS_ATOL = 2e-3
# phases 27-28: BASELINE config 2 (ResNet-50), then ViT-B/16, in one
# spawned process (its host RSS its own; the second run spares the process
# start and the first deferred init's one-time cost, about 9 s each on the
# card's machine): deferred init and materialize in f32, the eval forward
# at VISION_EVAL_BATCH x 224 x 224 against the same weights on the CPU
# (max |card - cpu| / max |cpu| within VISION_EVAL_RTOL: cuDNN's and
# oneDNN's f32 convolutions, TF32 off, over 50 layers), then bf16 training
# at the batch given, one warm-up step, VISION_STEPS timed steps and one
# profiled step
VISION_RUNS = ((27, "resnet50", 128), (28, "vit_b16", 64))
VISION_PARAMS = {"resnet50": 25_557_032, "vit_b16": 86_567_656}
VISION_EVAL_BATCH = 2
VISION_EVAL_RTOL = 1e-3
VISION_WARMUP, VISION_STEPS = 1, 3  # 10 steps before phase 30, 5 before the 600 s cut
VISION_PROFILE_STEPS = 1


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
                          d=128, page_size=16, iters=20, positions_of=VARIANT_POSITIONS,
                          phase=2, only=None):
    """Each decode kernel variant, {slab, paged} x {S = 1, S = 5} x {bf16,
    int8}, against its plain version at the llama3_8b serving geometry.
    Positions include 0, page boundaries +-1 and ``max_len - 1``; for S = 5
    some slots' rows run past ``max_len``.  The pools hold the slab's rows
    under shuffled page tables whose slots share a prefix of pages, so each
    paged output must equal the slab kernel's on the gathered rows bit for
    bit.  Timed beside the plain version and the library yardstick (SDPA
    with an explicit mask over the slab; over the gather, timed with it,
    for paged; after the dequantization, timed with it, for int8).
    ``only``: the ``(layout, S, dtype)`` variants to check (default all)."""
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
            positions = positions_of[s]
            pos = torch.tensor(positions, dtype=torch.int32, device=device)
            q = rnd((b, s, hq, d))
            for dt in ("bf16", "int8"):
                if only is not None and (layout, s, dt) not in only:
                    continue
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
                speed_line(phase, shape, row, "ms", "bound_ms", "library_ms")
                if row["device_ms"] and row["library_device_ms"]:
                    speed_line(phase, f"{shape} (device time)", row, "device_ms", "bound_ms",
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
    engine = ServeEngine(model, num_slots=num_slots, max_len=max_len, cost_cards=False,
                         **engine_kw)
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
    unprofiled, then the next PROFILE_RING profiled (a persistent
    engine's second ring, at ``ring_capacity=PROFILE_RING``).  Device ms a
    step is the sum of the card's kernel and copy times; the engine's
    ``serve/*`` regions also land on the card's timeline as annotations,
    each spanning its dispatch's kernels, and are left out (they counted
    the kernels a second time).  Busy ms a step is the union of those
    intervals; the idle share is 1 - busy over the window's host-clock
    time (the profiler's own host overhead included), unclipped."""
    from torch.profiler import ProfilerActivity, profile
    from torchdistx_tpu_torch.serve import ServeEngine

    if engine_kw.get("decode_mode") == "persistent":
        engine_kw = dict(engine_kw, ring_capacity=PROFILE_RING)
    engine = ServeEngine(model, num_slots=num_slots, max_len=max_len, cost_cards=False,
                         **engine_kw)
    for r in requests:
        engine.submit(**r)
    counters = engine.metrics.counters
    while counters["decode_steps"] < PROFILE_RING:
        engine.step()
    torch.cuda.synchronize()
    first = counters["decode_steps"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while engine.step() and counters["decode_steps"] - first < PROFILE_RING:
            pass
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = counters["decode_steps"] - first
    del engine
    if not steps:
        return {"decode_steps": 0, "device_ms_per_step": "not measured"}
    cuda = torch.autograd.DeviceType.CUDA
    by_class, spans, annotations = {}, [], 0
    for e in prof.events():
        if getattr(e, "device_type", None) != cuda:
            continue
        if getattr(e, "is_user_annotation", False) or e.name.startswith("serve/"):
            annotations += 1
            continue
        cls = _kernel_class(e.name) if "decode_" not in e.name else "decode_attention"
        by_class[cls] = by_class.get(cls, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
        spans.append((e.time_range.start, e.time_range.end))
    out = {"decode_steps": steps, "wall_ms_per_step": wall_ms / steps}
    if not spans:
        out["device_ms_per_step"] = "not measured"
        return out
    busy_us, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    busy_ms = busy_us / 1e3
    out["device_ms_per_step"] = sum(by_class.values())
    out["device_busy_ms_per_step"] = busy_ms / steps
    out["device_idle_share"] = 1.0 - busy_ms / wall_ms
    out["annotations_left_out"] = annotations
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
               "ttft_p50_s": _ttft_p50(results),
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
        return ServeEngine(model, num_slots=num_slots, max_len=max_len, cost_cards=False,
                           **kw)

    # -- b. paged + prefix cache, bf16 ---------------------------------------
    reqs = prefix_share_requests(rng, vocab, n=num_slots, max_len=max_len, max_new=SERVE_NEW)
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
    reqs = cyclic_requests(rng, vocab, n=num_slots, max_new=SERVE_NEW)
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
    short = [dict(r, max_new_tokens=16) for r in reqs]  # 32 before phase 30
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
    alone = ServeEngine(model, num_slots=num_slots, max_len=max_len, cost_cards=False).run(
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


def check_flash_bwd(torch, device, cases=BWD_CASES, iters=10,
                    timed=(BWD_REPORTED, BWD_REPORTED_D64), phase=4):
    """The backward kernels and the forward's lse variant against their
    plain versions, from the same saved ``o`` and ``lse`` (bf16 grads of
    O(1): ATOL/RTOL as for the forward, for the bf16 rounding of P, dS and
    the outputs, and f32 sums in another order); the ``timed`` cases
    timed, their ``speed`` lines under ``phase``."""
    from torchdistx_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=device).manual_seed(4)
    rows, failures = [], []
    for b, s, hq, hkv, d in cases:
        def rnd(h):
            return torch.randn((b, s, h, d), generator=g, device=device,
                               dtype=torch.float32).to(torch.bfloat16)

        q, k, v, do = rnd(hq), rnd(hkv), rnd(hkv), rnd(hq)
        o, lse = fa.flash_fwd_cuda(q, k, v, return_lse=True)
        o_ref, lse_ref = fa.flash_attention_lse_reference(q, k, v)
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
        ok, row["o_err"] = _close(torch, o, o_ref)
        if not ok:
            failures.append(f"flash lse output {case}: max|d|={row['o_err']}")
        del o_ref
        if case in timed:
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
            speed_line(phase, f"lse causal {shape}", row, "lse_ms", "lse_bound_ms",
                       "lse_library_ms")
            speed_line(phase, f"dkv bf16 causal {shape} (library: all three gradients)",
                       row, "dkv_ms", "dkv_bound_ms", "library_ms")
            speed_line(phase, f"dq bf16 causal {shape} (library: all three gradients)",
                       row, "dq_ms", "dq_bound_ms", "library_ms")
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


def check_fused_ce(torch, device, cases=CE_CASES, iters=5, phase=7):
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
            speed_line(phase, f"fused_ce_fwd {shape}", row, "fwd_ms", "fwd_bound_ms",
                       "fwd_library_ms")
            speed_line(phase, f"fused_ce_bwd {shape}", row, "bwd_ms", "bwd_bound_ms",
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
    eager construction from the same seed.  Then the same materialize twice
    with ``TDX_NUMERICS=1``: each session's ``replay/chunk`` book (every
    floating op output of the replay, one digest on the card, read once)
    equal bit for bit to the other's, no nonfinite value, the parameters
    unchanged, and the seconds with numerics on beside the run's off."""
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
    del model
    books, digests_ok = [], True
    saved = os.environ.get("TDX_NUMERICS")
    os.environ["TDX_NUMERICS"] = "1"
    try:
        for _ in range(2):  # the replay's digests: two sessions, one book
            tt.manual_seed(seed)
            twin = tt.deferred_init(Llama.from_name, "llama_1b", device="cuda")
            session = twin.tok_emb.weight._ref[0]
            t0 = time.perf_counter()
            tt.materialize_module(twin)
            torch.cuda.synchronize()
            d = session.numerics_book.digest("replay/chunk")
            books.append({"materialize_s": time.perf_counter() - t0, "count": d.count,
                          "nonfinite": d.nonfinite, "zeros": d.zeros,
                          "hist_hash": d.hist_hash, "max_abs": d.max_abs, "sumsq": d.sumsq})
            digests_ok &= all(torch.equal(p, q) for (_, p), (_, q)
                              in zip(twin.named_parameters(), eager.named_parameters()))
            del twin, session
    finally:
        if saved is None:
            os.environ.pop("TDX_NUMERICS", None)
        else:
            os.environ["TDX_NUMERICS"] = saved
    a, b = books
    same_book = all(a[k] == b[k] for k in a if k != "materialize_s")
    info["replay_digests"] = {"books": books, "bit_identical": same_book,
                              "params_unchanged": digests_ok,
                              "materialize_s_off": mat_s}
    ok = ok and same_book and digests_ok and a["nonfinite"] == 0 and a["count"] > 0
    return ok, info


def examples_phase(torch):
    """Phase 33: the examples a user runs on one card.
    ``examples.quantized_inference`` on full llama_1b (bf16; every
    ``Linear`` but ``lm_head`` to int8; 64 greedy tokens after a 32-token
    prompt), with the launch counters set to 0 just before: 7 ``Linear`` a
    layer quantized, the head kept, the weight bytes fallen, every token in
    the vocabulary, the flash forward once a layer (the prefill; decode
    through ``generate`` is plain).  ``examples.elastic_training``: the
    poisoned batch of step 30 rolled back to the checkpoint of step 20, 60
    steps done, the parameters finite, the heartbeat stamped."""
    from torchdistx_tpu_torch.examples import elastic_training, quantized_inference

    failures = []
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    q = quantized_inference.main("llama_1b", device="cuda", log_fn=lambda m: None)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counters().items() if v}
    model = q.pop("model")
    cfg = model.cfg
    q.update(seconds=time.perf_counter() - t0, launches=launches, layers=cfg.n_layers,
             head=type(model.lm_head).__name__)
    del model
    torch.cuda.empty_cache()
    if (q["n_quantized"] != 7 * cfg.n_layers or q["head"] != "Linear"
            or not q["bytes_after"] < q["bytes_before"] or len(q["tokens"]) != 64
            or not all(0 <= t < cfg.vocab_size for t in q["tokens"])):
        failures.append(f"quantized_inference: {q}")
    failures += _launch_failures("quantized_inference", q, {"flash_fwd": cfg.n_layers})
    tmp = tempfile.mkdtemp(prefix="tdx_elastic_")
    try:
        t0 = time.perf_counter()
        e = elastic_training.main(device="cuda", workdir=tmp, log_fn=lambda m: None)
        e["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    e.pop("workdir")
    if (e["failures"] != [{"step": 30, "failure": "nonfinite", "action": "restored",
                           "resumed_from": 20}]
            or e["global_step"] != 60 or not e["params_finite"]):
        failures.append(f"elastic_training: {e}")
    return {"quantized_inference": q, "elastic_training": e}, failures


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
    epoch (so the loss can fall).  The launch counters are set to 0 just
    before the call of ``steps`` steps and read just after.  Step time,
    tokens/s and MFU are the trainer's (steps 2..``steps``: it keeps a
    call's first step out of its window; a separate one-step warm-up call,
    a second build of gpt2_large, was cut for phase 23 (j))."""
    import numpy as np
    from torchdistx_tpu_torch.examples.train_gpt2 import main as train_main

    stream = np.random.RandomState(seed).randint(0, 50257, 4 * batch * seq + 1)
    kw = dict(batch=batch, seq=seq, fused_ce=True, device="cuda",
              dtype=torch.bfloat16, stream=stream, log_fn=lambda m: None)
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
                      ("conv", ("fprop", "dgrad", "wgrad", "cudnn", "convolve", "conv2d")),
                      ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "cublas", "nvjet")),
                      ("memcpy/memset", ("memcpy", "memset"))):
        if any(k in low for k in keys):
            return cls
    return "elementwise/other"


def profile_gpt2(torch, seed, steps=1, batch=8, seq=1024, top=15):
    """``torch.profiler`` over ``steps`` gpt2_large training steps of the
    main path: device time per step by kernel and by class, against the
    host-clock step time (the profiler's own overhead included); the
    difference is the card's idle share.  The
    trainer calls ``log_fn`` (with ``log_every=1``, after a synchronize)
    from its second step on, so with ``steps + 2`` steps the profiler warms
    up on step 2 and records the last ``steps``."""
    import numpy as np
    from torchdistx_tpu_torch.examples.train_gpt2 import main as train_main

    stream = np.random.RandomState(seed).randint(0, 50257, 4 * batch * seq + 1)

    def drive(on_step):
        train_main("gpt2_large", batch=batch, seq=seq, steps=steps + 2, fused_ce=True,
                   device="cuda", dtype=torch.bfloat16, stream=stream, log_every=1,
                   log_fn=on_step)

    return _profile(torch, drive, steps, top)


def _profile(torch, drive, steps, top=15):
    """Profile ``drive(on_step)``, which must call ``on_step`` once after
    each synchronized step, ``steps + 1`` times: the profiler warms up on
    one step and records ``steps`` (it waited one more step before the
    smoke's time was cut to 600 s)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    marks = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps)) as prof:
        def on_step(m):
            marks.append(time.perf_counter())
            prof.step()

        drive(on_step)
    wall_ms = (marks[-1] - marks[0]) / steps * 1e3  # the active steps, synced at each end
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
    -> materialize_module -> AnyPrecisionAdamW) on T5-3B at full width and
    ``T5_TRAIN_LAYERS`` layers a stack, batch 4 x 512, in one bias mode; one
    warm-up step, then ``Trainer.fit`` over ``steps`` steps with the launch
    counters set to 0 just before and read just after.  With
    ``profile_steps``, ``torch.profiler`` then records that many more steps
    (after one to wait and one to warm up).  In the bucket mode, last,
    :func:`repeat_step`."""
    import math
    from torchdistx_tpu_torch.utils.benchmarks import build_t5_train_workload

    w = build_t5_train_workload(name, batch=T5_BATCH, seq=T5_SEQ, n_layers=T5_TRAIN_LAYERS,
                                flash_bucket_bias=bucket, device=device, seed=seed)
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
        "n_params": w["n_params"], "layers_per_stack": T5_TRAIN_LAYERS, "batch": w["batch_size"],
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
    per = 2 * T5_TRAIN_LAYERS * steps
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
            w["run"](profile_steps + 1)

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


def persistent_twin(torch, model, requests, chunked, what, expect, num_slots, max_len):
    """The same model and requests through a persistent engine (one CUDA
    graph of a decode iteration, replayed), after the chunked engine of the
    phase is gone: the loop contract (:func:`_persistent_failures`: a
    captured graph, one host sync a ring drain), greedy streams equal to
    the chunked run's ``chunked`` results bit for bit, and ``expect(counters)``
    the launch gates.  Also the seconds of the warm-up and capture, the
    growth of the allocator's reserved bytes over the run (the graph's
    private pool takes its segments there: a dequantized int8 weight per
    product lives in it) and the run's peak over the bytes held before the
    engine was built (its cache, loop state and that pool)."""
    from torchdistx_tpu_torch.serve import ServeEngine
    from torchdistx_tpu_torch.serve.graph_loop import GraphLoop

    captures = []
    capture = GraphLoop.capture

    def timed_capture(loop, body):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        capture(loop, body)
        torch.cuda.synchronize()
        captures.append(time.perf_counter() - t0)

    torch.cuda.synchronize()
    held, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    engine = ServeEngine(model, num_slots=num_slots, max_len=max_len, cost_cards=False,
                         decode_mode="persistent")
    GraphLoop.capture = timed_capture
    try:
        results, summary = run_engine(torch, engine, requests)
    finally:
        GraphLoop.capture = capture
    summary.update(capture_s=captures[0] if captures else None,
                   reserved_growth_bytes=torch.cuda.memory_reserved() - reserved,
                   peak_over_held_bytes=summary["peak_memory_bytes"] - held,
                   streams_equal_chunked=_streams(results) == _streams(chunked))
    failures = _persistent_failures(what, summary)
    failures += _greedy_failures(what, requests, results, model.cfg.vocab_size)
    failures += _launch_failures(what, summary, expect(summary["counters"]))
    if not summary["streams_equal_chunked"]:
        failures.append(f"{what}: streams differ from the chunked run's")
    del engine
    torch.cuda.empty_cache()
    return summary, failures


def serve_mistral(torch, tt, seed, num_slots=8, max_len=8192):
    """The windowed serving main path: full mistral_7b (32 layers, random
    weights from the seed) through ``ServeEngine`` over a slab of 8 slots x
    8192 rows, 8 greedy requests past the window; every prefill goes
    through the window forward kernel (its counter checked), decode is
    plain (windowed decode is jnp in the JAX package too).  Then the same
    requests through a persistent engine (:func:`persistent_twin`: the
    windowed mask of each captured iteration built on the card from the
    slot positions), its streams equal to the chunked run's."""
    import numpy as np
    from torchdistx_tpu_torch.serve import ServeEngine

    tt.manual_seed(seed)
    model = tt.models.Llama.from_name("mistral_7b", dtype=torch.bfloat16, device="cuda")
    model.requires_grad_(False)
    requests = long_requests(np.random.RandomState(seed), model.cfg.vocab_size,
                             max_new=MISTRAL_NEW)
    engine = ServeEngine(model, num_slots=num_slots, max_len=max_len, cost_cards=False)
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
    del engine
    torch.cuda.empty_cache()
    summary["persistent"], f = persistent_twin(
        torch, model, requests, results, "mistral serve persistent",
        lambda c: {"flash_fwd": n_layers * c["prefill_calls"],
                   "flash_fwd_window": n_layers * c["prefill_calls"],
                   "decode_attention": 0}, num_slots, max_len)
    failures += f
    del model
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
    (counters checked), peak memory under the card's.  Then the same
    requests through a persistent engine (:func:`persistent_twin`: 32 MoE
    layers in one captured iteration, each int8 product's dequantized copy
    in the graph's pool), its streams equal to the chunked run's and its
    peak under the card's too, and one persistent ring profiled
    (:func:`profile_decode`: device ms a step by kernel class)."""
    import numpy as np
    from torchdistx_tpu_torch.serve import ServeEngine

    tt.manual_seed(seed)
    model, build_s, build_peak = build_mixtral_int8(torch, tt)
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    requests = make_requests(np.random.RandomState(seed), model.cfg.vocab_size, n=8,
                             n_greedy=8, max_new=32)
    engine = ServeEngine(model, num_slots=num_slots, max_len=max_len, cost_cards=False)
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
    del engine
    torch.cuda.empty_cache()
    persistent, f = persistent_twin(
        torch, model, requests, results, "mixtral serve persistent",
        lambda c: {"flash_fwd": n_layers * c["prefill_calls"],
                   "decode_attention": n_layers * c["decode_steps"]}, num_slots, max_len)
    failures += f
    if persistent["peak_memory_bytes"] >= total:
        failures.append(f"mixtral serve persistent: peak memory "
                        f"{persistent['peak_memory_bytes']} not under the card's {total}")
    # the persistent decode step's device time, by kernel class
    persistent["profile"] = profile_decode(torch, model, requests[:num_slots], num_slots,
                                           max_len, decode_mode="persistent")
    summary["persistent"] = persistent
    del model
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
    dist.all_reduce(probe)  # tdx-lint: disable=TDX103 -- the smoke's probe of NCCL in a world-1 group, not the port's traffic
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
        trainer.fit(itertools.repeat(batch), trainer.global_step + SP_PROFILE_STEPS + 1)

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
            dist.all_gather_object(sums, _bits_checksum(torch, model.parameters()))  # tdx-lint: disable=TDX103 -- the smoke's check that ranks hold equal bits, outside the audited step
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

    # (b) SlowMo: the nodes meet only at the slow steps (every third)
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


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _empty(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _rel_norm_err(torch, got, ref):
    """``|| got - ref || / || ref ||`` in f32."""
    got, ref = got.float(), ref.float()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def _bf16_update_err(torch, got, init, ref):
    """``|| (got - init) - (ref - init) || / || ref - init ||`` over every
    parameter, in f32."""
    num = den = 0.0
    for n, g in got.items():
        d_ref = ref[n].float() - init[n].float()
        num += float(((g.float() - init[n].float()) - d_ref).pow(2).sum())
        den += float(d_ref.pow(2).sum())
    return (num / max(den, 1e-30)) ** 0.5


TP_EP_CASES = (("c", "llama_1b", TP_LAYERS, TP_SEQ, TP_STEPS, {"tp": 2}),
               ("d", "mixtral_8x7b", EP_LAYERS, EP_SEQ, EP_STEPS, {"ep": 2}))


def _tp_ep_runs(torch, seed, cases=TP_EP_CASES, device="cuda"):
    """Phase 23 (c) and (d) on one rank of two: (c) ``llama_1b`` (full
    width, TP_LAYERS layers) materialized under ``llama_tp_rule`` on
    ``{"tp": 2}`` and trained TP_STEPS steps by ``GSPMDTrainStep`` with
    ``llama_tp_plan`` (Megatron compute, the flash kernels on the rank's 8
    of 16 heads); (d) ``mixtral_8x7b`` (full width, EP_LAYERS layers) under
    ``Mixtral.shard_rule`` on ``{"ep": 2}`` (4 of 8 experts a rank),
    EP_STEPS steps with the 1e-2 aux loss; both with SGD.  Each held
    against a world-1 run of the same seed and batch, made on each rank in
    turn (the card holds one at a time): the losses, the first step's
    gradients parameter by parameter and the update.  Per step its ms and the bytes its collectives
    handed to ``gloo`` (``collectives.payload_bytes``), and the launches.
    ``cases`` and ``device`` rehearse it on the CPU with tiny models."""
    import math

    import numpy as np
    import torch.distributed as dist
    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.models import Llama, Mixtral
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import (
        GSPMDTrainStep, ShardingPlan, collectives, create_mesh, llama_tp_plan, llama_tp_rule)
    from torchdistx_tpu_torch.parallel.mesh import sharding_of
    from torchdistx_tpu_torch.parallel.plan import gather_full

    rank, world = dist.get_rank(), dist.get_world_size()
    out, failures = {}, []
    for part, name, n_layers, seq, steps, axes in cases:
        cls = Llama if part == "c" else Mixtral
        mesh = create_mesh(axes)
        plan = llama_tp_plan(mesh) if part == "c" else ShardingPlan(mesh, rules=MIXTRAL_EP_RULES)
        rs = np.random.RandomState(seed + n_layers)
        vocab = cls.configs[name]["vocab_size"]
        batch = tuple(torch.from_numpy(rs.randint(0, vocab, (1, seq))).to(device)
                      for _ in range(2))

        def loss_fn(mod, b, part=part):
            if part == "d":
                logits, aux = mod.forward_with_aux(b[0])
                return F.cross_entropy(logits, b[1]) + MIXTRAL_AUX_WEIGHT * aux
            return F.cross_entropy(mod(b[0]), b[1])

        def build(sharded, cls=cls, name=name, n_layers=n_layers, seq=seq, mesh=mesh, part=part):
            tt.manual_seed(seed)
            m = tt.deferred_init(cls.from_name, name, n_layers=n_layers, max_seq_len=seq,
                                 remat=False, device=device)
            rule = None
            if sharded:
                rule = llama_tp_rule(mesh, "tp") if part == "c" else m.shard_rule(mesh)
            return tt.materialize_module(m, sharding_rule=rule)

        def opt_of(m):
            return torch.optim.SGD(m.parameters(), lr=TP_LR)

        for r in range(world):  # the world-1 run, one rank at a time
            if r == rank:
                m = build(False)
                init = {n: p.detach().clone() for n, p in m.named_parameters()}
                ref_step = tt.TrainStep(m, opt_of(m), loss_fn)
                ref_trainer = tt.Trainer(ref_step, log_every=1, log_fn=lambda _: None)
                ref_trainer.fit([batch], 1)
                ref_grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
                ref_trainer.fit([batch] * (steps - 1), steps)
                ref = {"losses": [float(x) for x in ref_step.losses],
                       "params": {n: p.detach().clone() for n, p in m.named_parameters()}}
                del m, ref_step, ref_trainer
                _empty(torch, device)
            collectives.barrier()
        m = build(True)
        local_params = sum(p.numel() for p in m.parameters())
        step = GSPMDTrainStep(m, opt_of(m), loss_fn, mesh, plan=plan)
        trainer = tt.Trainer(step, log_every=1, log_fn=lambda _: None)
        rows = []
        _reset_counters()
        for i in range(steps):
            before = dict(collectives.payload_bytes)
            _sync(torch, device)
            t0 = time.perf_counter()
            trainer.fit([batch], i + 1)
            _sync(torch, device)
            rows.append({"step": i + 1, "ms": (time.perf_counter() - t0) * 1e3,
                         "loss": float(step.losses[-1]), "ref_loss": ref["losses"][i],
                         "collective_bytes": {k: collectives.payload_bytes[k] - before[k]
                                              for k in before}})
            if i == 0:
                grad_err = {n: _rel_norm_err(torch, gather_full(p.grad, sharding_of(p)[0]),
                                             ref_grads[n])
                            for n, p in m.named_parameters()}
        launches = _read_counters()
        full = step.full_params()
        update_err = _bf16_update_err(torch, full, init, ref["params"])
        update_by_param = {n: _rel_norm_err(torch, full[n].float() - init[n].float(),
                                            ref["params"][n].float() - init[n].float())
                           for n in full}
        max_diff = max(float((full[n].float() - ref["params"][n].float()).abs().max())
                       for n in full)
        what = f"{'tp' if part == 'c' else 'ep'} {name} rank {rank}"
        for row in rows:
            rel = abs(row["loss"] - row["ref_loss"]) / abs(row["ref_loss"])
            if not (math.isfinite(row["loss"]) and rel <= TP_LOSS_RTOL):
                failures.append(f"{what}: step {row['step']} loss {row['loss']} against the "
                                f"world-1 run's {row['ref_loss']}")
        if not update_err <= TP_UPDATE_RTOL:
            failures.append(f"{what}: the update is {update_err} off the world-1 run's by norm")
        worst = max(grad_err, key=grad_err.get)
        if not grad_err[worst] <= TP_GRAD_RTOL:
            failures.append(f"{what}: the first gradient of {worst} is {grad_err[worst]} off "
                            "the world-1 run's by norm")
        want = {k: n_layers * steps for k in ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq",
                                              "flash_bwd_delta")}
        failures += [f"{what}: {k} launches {launches[k]} != {n}"
                     for k, n in want.items() if launches[k] != n]
        out[part] = {"model": name, "mesh": dict(mesh.shape), "layers": n_layers, "seq": seq,
                     "steps": rows, "launches": launches, "update_rel_err": update_err,
                     "grad_rel_err_max": grad_err[worst], "grad_rel_err_worst": worst,
                     "grad_rel_err": grad_err, "update_rel_err_by_param": update_by_param,
                     "max_abs_param_diff": max_diff, "local_params": local_params,
                     "full_params": sum(t.numel() for t in full.values()),
                     "local_forwards": len(step._layout.forwards),
                     "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                           if device == "cuda" else None)}
        del m, step, trainer, full, init, ref, ref_grads
        _empty(torch, device)
    return out, failures


# phase 23 (e)-(i) in the same world, each held against a world-1 run of the
# same seed and batch with the TP_* tolerances: (e) gpt2_large, SP_GPT2_LAYERS
# of its 36 layers at full width, on {"sp": 2}, SP_GPT2_BATCH x SP_GPT2_SEQ
# global tokens (512 a rank), SP_GPT2_STEPS SGD steps through the flash ring,
# then one Ulysses forward on the same weights (its logits within
# ULYSSES_RTOL of the ring's by norm); (f) t5_3b at full width and
# SP_T5_LAYERS layers a stack on {"sp": 2}, the materialized bias,
# SP_T5_BATCH x SP_T5_SEQ encoder and decoder tokens, SP_T5_STEPS steps;
# (g) llama_1b, PP_LAYERS of its 16 layers (PP_LAYERS / 2 a stage) on
# {"pp": 2}, PP_MICRO microbatches of 1 x PP_SEQ (the embedding outside the
# stages, the final norm, head and loss in loss_fn), PP_STEPS
# pipeline_train_step calls (SGD between them) and one pipeline_apply
# before them (its outputs within ULYSSES_RTOL of the unpipelined ones by
# norm); (h) llama_1b, ZERO2_LAYERS layers, on {"dp": 2}, ZeRO-2 against the
# replicated-optimizer oracle, AnyPrecisionAdamW, ZERO2_STEPS steps at
# 2 x ZERO2_SEQ: parameters bit-equal, optimizer bytes a rank half; (i)
# llama_1b, RESHARD_LAYERS layers, 2 x RESHARD_SEQ: {"fsdp": 2} with
# on_failure="reshard", inject_device_loss(1) after RESHARD_AFTER steps, the
# bounce onto {"fsdp": 1} on rank 0 and RESHARD_AFTER more steps bit-equal
# to a world-1 run resumed from a replayed state; then {"dp": 2} losing a
# rank takes the live path with 0 wire bytes
SP_GPT2_NAME, SP_T5_NAME, PARALLEL_LLAMA = "gpt2_large", "t5_3b", "llama_1b"
PARALLEL_COUNTERS = ("flash_fwd_lse", "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_delta",
                     "flash_fwd_residuals", "flash_bwd_dkv_f32", "flash_bwd_dq_f32",
                     "flash_bwd_dbias")
PARALLEL_LINES = (("e", "sp gpt2_large"), ("f", "sp t5_3b"), ("g", "pp llama_1b"),
                  ("h", "zero2 llama_1b"), ("i", "reshard llama_1b"))
SP_GPT2_LAYERS, SP_GPT2_BATCH, SP_GPT2_SEQ, SP_GPT2_STEPS = 4, 4, 1024, 3
SP_T5_LAYERS, SP_T5_BATCH, SP_T5_SEQ, SP_T5_STEPS = 2, 2, 1024, 2
SP_LR = 1.0  # at TP_LR (10) a tiny GPT-2's loss climbs by its third step
ULYSSES_RTOL = 2e-2
PP_LAYERS, PP_MICRO, PP_SEQ, PP_STEPS, PP_LR = 4, 8, 2048, 2, 10.0
ZERO2_LAYERS, ZERO2_SEQ, ZERO2_STEPS = 2, 2048, 2  # 3 steps before phase 23 (j)
RESHARD_LAYERS, RESHARD_SEQ, RESHARD_AFTER = 2, 2048, 2
# the ring blocks of (e) and (f) and llama_1b's attention, against their
# plain versions before the world starts: (B, S, Hq, Hkv, D, causal, bias)
# for the residuals forward and the f32-output backward (phase 19's check),
# llama_1b's (B, S, Hq, Hkv, D) for phase 4's, T5's (B, S) for phase 11's
PARALLEL_RESIDUAL_CASES = [(4, 512, 20, 20, 64, True, False), (4, 512, 20, 20, 64, False, False),
                           (2, 512, 32, 32, 128, True, True),
                           (2, 512, 32, 32, 128, False, True),
                           (2, 512, 32, 32, 128, False, False)]
PARALLEL_BWD_CASE = (1, 2048, 16, 16, 128)
PARALLEL_BIAS_CASE = (2, 512)


def check_parallel_kernels(torch, device):
    """Phase 23's kernel check: the flash kernels at the shapes the
    parallel runs give them (``PARALLEL_*``), each against its plain
    version with the phase's own bounds."""
    res, failures = check_flash_residuals(torch, device, cases=PARALLEL_RESIDUAL_CASES)
    bwd, f = check_flash_bwd(torch, device, cases=[PARALLEL_BWD_CASE], timed=(), phase=23)
    failures += f
    bias, f = check_flash_bias(torch, device, cases=[PARALLEL_BIAS_CASE], iters=2)
    failures += f
    return {"residuals": res, "bwd": bwd, "bias": bias}, failures


def _ring_blocks(causal, idx, n):
    """The blocks a ring rank computes a call: all ``n``, or ``idx + 1``
    when causal."""
    return idx + 1 if causal else n


def _window_bytes(torch, fn):
    """``fn()`` timed on the card's clock, with the bytes each collective
    kind and the pipe took (``collectives.payload_bytes``) and the bytes
    staged through the host."""
    from torchdistx_tpu_torch.parallel import collectives

    before, staged = dict(collectives.payload_bytes), collectives._permute.staged_bytes
    _sync(torch, "cuda" if torch.cuda.is_available() else "cpu")
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, "cuda" if torch.cuda.is_available() else "cpu")
    ms = (time.perf_counter() - t0) * 1e3
    sent = {k: v - before[k] for k, v in collectives.payload_bytes.items()}
    sent["staged"] = collectives._permute.staged_bytes - staged
    return out, ms, sent


def _held(torch, what, rows, ref_losses, grads, ref_grads, full, init, ref_params, failures):
    """The TP_* checks of a run against its world-1 run: each step's loss,
    the first step's gradient of every parameter by norm and the update."""
    import math

    for row, ref in zip(rows, ref_losses):
        row["ref_loss"] = ref
        if not (math.isfinite(row["loss"]) and abs(row["loss"] - ref) <= TP_LOSS_RTOL * abs(ref)):
            failures.append(f"{what}: step {row['step']} loss {row['loss']} against the "
                            f"world-1 run's {ref}")
    grad_err = {n: _rel_norm_err(torch, g, ref_grads[n]) for n, g in grads.items()}
    worst = max(grad_err, key=grad_err.get)
    if not grad_err[worst] <= TP_GRAD_RTOL:
        failures.append(f"{what}: the first gradient of {worst} is {grad_err[worst]} off the "
                        "world-1 run's by norm")
    out = {"grad_rel_err_max": grad_err[worst], "grad_rel_err_worst": worst}
    if full is not None:
        out["update_rel_err"] = _bf16_update_err(torch, full, init, ref_params)
        if not out["update_rel_err"] <= TP_UPDATE_RTOL:
            failures.append(f"{what}: the update is {out['update_rel_err']} off the world-1 "
                            "run's by norm")
    return out


def _gate(what, launches, want, failures):
    failures += [f"{what}: {k} launches {launches[k]} != {n}" for k, n in want.items()
                 if launches[k] != n]


def _world1(torch, world, rank, fn):
    """``fn()`` on each rank in turn (the card holds one at a time)."""
    from torchdistx_tpu_torch.parallel import collectives

    out = None
    for r in range(world):
        if r == rank:
            out = fn()
            _empty(torch, "cuda" if torch.cuda.is_available() else "cpu")
        collectives.barrier()
    return out


def _sp_model_run(torch, seed, part, device="cuda"):
    """(e) or (f) on one rank of two (module comment above ``SP_GPT2_LAYERS``)."""
    import numpy as np
    import torch.distributed as dist
    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.models import GPT2, T5
    from torchdistx_tpu_torch.models.gpt2 import gpt2_configs
    from torchdistx_tpu_torch.models.t5 import t5_configs
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import ShardedTrainStep, create_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    gpt2 = part == "e"
    name, cls = (SP_GPT2_NAME, GPT2) if gpt2 else (SP_T5_NAME, T5)
    n_layers, batch, seq, steps = ((SP_GPT2_LAYERS, SP_GPT2_BATCH, SP_GPT2_SEQ, SP_GPT2_STEPS)
                                   if gpt2 else (SP_T5_LAYERS, SP_T5_BATCH, SP_T5_SEQ, SP_T5_STEPS))
    lr = SP_LR
    vocab = (gpt2_configs if gpt2 else t5_configs)[name].get("vocab_size", 50257 if gpt2
                                                              else 32128)
    mesh = create_mesh({"sp": world})
    rs = np.random.RandomState(seed + n_layers)
    # (tokens, labels) for GPT-2; (sources, decoder inputs, labels) for T5,
    # whose labels are drawn apart: on its own input T5's tied head scores
    # the input token so high that the loss is about 0 (the JAX script's)
    data = tuple(torch.from_numpy(rs.randint(0, vocab, (batch, seq))).to(device)
                 for _ in range(2 if gpt2 else 3))

    def loss_fn(mod, b):
        return F.cross_entropy(mod(b[0]) if gpt2 else mod(b[0], b[1]), b[-1])

    def build(sp_axis):
        tt.manual_seed(seed)
        m = tt.deferred_init(cls.from_name, name, n_layers=n_layers, dtype=torch.bfloat16,
                             sp_axis=sp_axis, device=device)
        return tt.materialize_module(m)

    def reference():
        m = build(None)
        init = {n: p.detach().clone() for n, p in m.named_parameters()}
        step = tt.TrainStep(m, torch.optim.SGD(m.parameters(), lr=lr), loss_fn)
        step(m, step.optimizer, data)
        grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
        for _ in range(steps - 1):
            step(m, step.optimizer, data)
        return {"init": init, "grads": grads, "losses": [float(x) for x in step.losses],
                "params": {n: p.detach().clone() for n, p in m.named_parameters()}}

    ref = _world1(torch, world, rank, reference)
    m = build("sp")
    step = ShardedTrainStep(m, torch.optim.SGD(m.parameters(), lr=lr), loss_fn, mesh,
                            shard_axis=None, batch_spec=(None, "sp"))
    rows, failures, grads = [], [], None
    _reset_counters()
    for i in range(steps):
        _, ms, sent = _window_bytes(torch, lambda: step(m, step.optimizer, data))
        rows.append({"step": i + 1, "ms": ms, "loss": float(step.losses[-1]),
                     "collective_bytes": sent})
        if i == 0:
            grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
    launches = _read_counters()
    what = f"sp {name} rank {rank}"
    out = {"model": name, "mesh": dict(mesh.shape), "layers": n_layers,
           "tokens": [batch, seq], "tokens_a_rank": [batch, seq // world], "steps": rows,
           "launches": launches, "n_params": sum(p.numel() for p in m.parameters())}
    full = {n: p.detach() for n, p in m.named_parameters()}
    out.update(_held(torch, what, rows, ref["losses"], grads, ref["grads"], full, ref["init"],
                     ref["params"], failures))
    idx = mesh.axes["sp"].index
    blocks = _ring_blocks(True, idx, world)
    if gpt2:
        want = {"flash_fwd_residuals": n_layers * steps * blocks}
    else:  # encoder (full ring, bias), decoder self (causal, bias), cross (full)
        biased = n_layers * (world + blocks)
        want = {"flash_fwd_residuals": steps * (biased + n_layers * world),
                "flash_fwd_bias": steps * biased, "flash_bwd_dbias": steps * biased}
    want.update(flash_bwd_dkv_f32=want["flash_fwd_residuals"],
                flash_bwd_dq_f32=want["flash_fwd_residuals"],
                flash_bwd_delta=steps * n_layers * (1 if gpt2 else 3))
    _gate(what, launches, want, failures)
    if gpt2:  # one Ulysses forward on the trained weights, against the ring's
        local = tuple(x[:, idx * (seq // world):(idx + 1) * (seq // world)] for x in data)
        with mesh, torch.no_grad():
            ring = m(local[0])
            m.cfg.sp_mode = "ulysses"
            _reset_counters()
            uly, ms, sent = _window_bytes(torch, lambda: m(local[0]))
            m.cfg.sp_mode = "ring"
        err = _rel_norm_err(torch, uly, ring)
        out["ulysses"] = {"ms": ms, "collective_bytes": sent, "rel_err_vs_ring": err,
                          "launches": _read_counters()}
        if not err <= ULYSSES_RTOL:
            failures.append(f"{what}: the Ulysses logits are {err} off the ring's by norm")
        _gate(f"{what} ulysses", out["ulysses"]["launches"], {"flash_fwd": n_layers}, failures)
        if not sent["all_to_all"]:
            failures.append(f"{what}: the Ulysses forward handed nothing to all_to_all")
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated() if device == "cuda" else None
    return out, failures


def _pp_run(torch, seed, device="cuda"):
    """(g) on one rank of two."""
    import numpy as np
    import torch.distributed as dist
    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.models.llama import Llama, LlamaConfig, llama_configs, pp_stage
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import create_mesh
    from torchdistx_tpu_torch.parallel.pp import (pipeline_apply, pipeline_train_step,
                                                 split_microbatches, stack_pipeline_stages)

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = create_mesh({"pp": world})
    per_stage = PP_LAYERS // world
    kw = dict(llama_configs[PARALLEL_LLAMA], max_seq_len=PP_SEQ, remat=False)
    Stage = pp_stage(LlamaConfig(**dict(kw, n_layers=PP_LAYERS)), n_blocks=per_stage)
    modules = []
    for i in range(world):
        tt.manual_seed(seed + i)
        modules.append(tt.materialize_module(tt.deferred_init(Stage, device=device)))
    tt.manual_seed(seed + world)
    head = tt.materialize_module(tt.deferred_init(Llama.from_name, PARALLEL_LLAMA, n_layers=0,
                                                  max_seq_len=PP_SEQ, device=device))
    for p in head.parameters():
        p.requires_grad_(False)
    template = modules[rank]
    rs = np.random.RandomState(seed)
    toks, labels = (torch.from_numpy(rs.randint(0, kw["vocab_size"], (PP_MICRO, PP_SEQ)))
                    .to(device) for _ in range(2))
    with torch.no_grad():
        hidden = split_microbatches(head.tok_emb(toks), PP_MICRO)
    targets = split_microbatches(labels, PP_MICRO)

    def stage_fn(p, x):
        return torch.func.functional_call(template, p, (x,))

    def loss_fn(y, t):
        return F.cross_entropy(head.lm_head(head.norm(y)), t)

    def reference():
        params = [{n: p.detach().clone().requires_grad_() for n, p in mod.named_parameters()}
                  for mod in modules]
        outs, total = [], 0.0
        for i in range(PP_MICRO):
            x = hidden[i]
            for p in params:
                x = stage_fn(p, x)
            outs.append(x.detach())
            loss = loss_fn(x, targets[i]) / PP_MICRO
            loss.backward()
            total += float(loss.detach())
        return {"loss": total, "out": torch.stack(outs),
                "grads": {n: t.grad for n, t in params[rank].items()}}

    ref = _world1(torch, world, rank, reference)
    stacked = stack_pipeline_stages([dict(mod.named_parameters()) for mod in modules], mesh)
    failures, what = [], f"pp llama_1b rank {rank}"
    _reset_counters()
    with torch.no_grad():
        out, apply_ms, apply_sent = _window_bytes(
            torch, lambda: pipeline_apply(stacked, hidden, mesh=mesh, stage_fn=stage_fn))
    apply_launches = _read_counters()
    err = _rel_norm_err(torch, out, ref["out"])
    if not err <= ULYSSES_RTOL:
        failures.append(f"{what}: pipeline_apply's outputs are {err} off the unpipelined by norm")
    rows = []
    _reset_counters()
    for i in range(PP_STEPS):
        (loss, grads), ms, sent = _window_bytes(torch, lambda: pipeline_train_step(
            stacked, hidden, targets, mesh=mesh, stage_fn=stage_fn, loss_fn=loss_fn))
        rows.append({"step": i + 1, "ms": ms, "loss": float(loss), "collective_bytes": sent})
        if i == 0:
            first = {n: g[0] for n, g in grads.items()}
        with torch.no_grad():
            for n, g in grads.items():
                stacked[n].sub_(PP_LR * g)
    launches = _read_counters()
    held = _held(torch, what, rows[:1], [ref["loss"]], first, ref["grads"], None, None, None,
                 failures)
    last = rank == world - 1
    n = PP_MICRO * per_stage
    _gate(what, launches, {"flash_fwd_lse": PP_STEPS * n, "flash_bwd_dkv": PP_STEPS * n,
                           "flash_bwd_dq": PP_STEPS * n, "flash_bwd_delta": PP_STEPS * n,
                           "flash_fwd": 0 if last else PP_STEPS * n}, failures)
    _gate(f"{what} apply", apply_launches, {"flash_fwd": n}, failures)
    if not all(np.isfinite(r["loss"]) for r in rows):
        failures.append(f"{what}: losses not finite: {[r['loss'] for r in rows]}")
    return {"model": PARALLEL_LLAMA, "mesh": dict(mesh.shape), "layers": PP_LAYERS,
            "microbatches": [PP_MICRO, 1, PP_SEQ], "steps": rows, "launches": launches,
            "apply": {"ms": apply_ms, "collective_bytes": apply_sent,
                      "rel_err_vs_unpipelined": err, "launches": apply_launches},
            "ref_loss": ref["loss"], **held,
            "stage_params": sum(p.numel() for p in template.parameters()),
            "peak_memory_bytes": torch.cuda.max_memory_allocated() if device == "cuda"
            else None}, failures


def _state_bytes(torch, opt) -> int:
    """Bytes of an optimizer's state tensors on this rank, scalars left out."""
    return sum(t.numel() * t.element_size() for s in opt.state.values() for t in s.values()
               if isinstance(t, torch.Tensor) and t.ndim)


def _zero2_run(torch, seed, device="cuda"):
    """(h) on one rank of two."""
    import numpy as np
    import torch.distributed as dist
    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import GSPMDTrainStep, ShardingPlan, create_mesh

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = create_mesh({"dp": world})
    rs = np.random.RandomState(seed)
    vocab = Llama.configs[PARALLEL_LLAMA]["vocab_size"]
    data = tuple(torch.from_numpy(rs.randint(0, vocab, (world, ZERO2_SEQ))).to(device)
                 for _ in range(2))

    def loss_fn(mod, b):
        return F.cross_entropy(mod(b[0]), b[1])

    def run(plan):
        tt.manual_seed(seed)
        m = tt.materialize_module(tt.deferred_init(
            Llama.from_name, PARALLEL_LLAMA, n_layers=ZERO2_LAYERS, max_seq_len=ZERO2_SEQ,
            remat=False, device=device))
        opt = tt.AnyPrecisionAdamW(m.parameters(), lr=1e-4)
        step = GSPMDTrainStep(m, opt, loss_fn, mesh, batch_spec=("dp",), plan=plan)
        rows = []
        _reset_counters()
        for i in range(ZERO2_STEPS):
            _, ms, sent = _window_bytes(torch, lambda: step(m, opt, data))
            rows.append({"step": i + 1, "ms": ms, "loss": float(step.losses[-1]),
                         "collective_bytes": sent})
        return m, opt, step, rows, _read_counters()

    plan = ShardingPlan(mesh, dp_axis="dp", zero2=True)
    m, opt, step, rows, launches = run(plan)
    om, oopt, _, orows, _ = run(None)
    what = f"zero2 llama_1b rank {rank}"
    failures = []
    differ = [n for (n, p), q in zip(m.named_parameters(), om.parameters())
              if not torch.equal(p, q)]
    if differ:
        failures.append(f"{what}: parameters not bit-equal to the oracle's: {differ[:4]}")
    if [r["loss"] for r in rows] != [r["loss"] for r in orows]:
        failures.append(f"{what}: losses {[r['loss'] for r in rows]} against the oracle's "
                        f"{[r['loss'] for r in orows]}")
    local, whole = _state_bytes(torch, opt), _state_bytes(torch, oopt)
    if local * world != whole:
        failures.append(f"{what}: optimizer bytes {local} a rank against the oracle's {whole}")
    n = ZERO2_LAYERS * ZERO2_STEPS
    _gate(what, launches, {"flash_fwd_lse": n, "flash_bwd_dkv": n, "flash_bwd_dq": n,
                           "flash_bwd_delta": n}, failures)
    return {"model": PARALLEL_LLAMA, "mesh": dict(mesh.shape), "layers": ZERO2_LAYERS,
            "tokens": [world, ZERO2_SEQ], "steps": rows, "oracle_steps": orows,
            "launches": launches, "params_bit_equal": not differ,
            "optimizer_bytes": local, "oracle_optimizer_bytes": whole,
            "sliced_params": len(step._zero2),
            "zero2_participating_bytes": plan.zero2_participating_bytes(m),
            "peak_memory_bytes": torch.cuda.max_memory_allocated() if device == "cuda"
            else None}, failures


def _reshard_run(torch, seed, tmp, device="cuda"):
    """(i) on one rank of two; ``tmp`` the checkpoint directory both share."""
    import numpy as np
    import torch.distributed as dist
    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.parallel import ShardedTrainStep, create_mesh
    from torchdistx_tpu_torch.parallel.plan import gather_full
    from torchdistx_tpu_torch.parallel.reshard import optimizer_state_tree
    from torchdistx_tpu_torch.utils.failure import FailureDetector

    rank, world = dist.get_rank(), dist.get_world_size()
    rs = np.random.RandomState(seed)
    vocab = Llama.configs[PARALLEL_LLAMA]["vocab_size"]
    data = [tuple(torch.from_numpy(rs.randint(0, vocab, (world, RESHARD_SEQ))).to(device)
                  for _ in range(2)) for _ in range(2 * RESHARD_AFTER + 1)]

    def loss_fn(mod, b):
        return F.cross_entropy(mod(b[0]), b[1])

    def step_on(mesh, **kw):
        tt.manual_seed(seed)
        m = tt.materialize_module(tt.deferred_init(
            Llama.from_name, PARALLEL_LLAMA, n_layers=RESHARD_LAYERS, max_seq_len=RESHARD_SEQ,
            remat=False, device=device))
        return ShardedTrainStep(m, tt.AnyPrecisionAdamW(m.parameters(), lr=1e-4), loss_fn,
                                mesh, **kw)

    failures, out = [], {}
    # (i.1) the bounce: {"fsdp": 2} -> {"fsdp": 1}; first the replayed state
    # at the recovery step (a clean run to it, gathered whole)
    mesh = create_mesh({"fsdp": world})
    ref = step_on(mesh, shard_axis="fsdp")
    tt.Trainer(ref, log_every=1, log_fn=lambda _: None).fit(data, RESHARD_AFTER + 1)
    with mesh:
        params = {n: gather_full(p).clone() for n, p in ref.model.named_parameters()}
        slots = {n: {k: gather_full(v).clone() for k, v in row.items()}
                 for n, row in optimizer_state_tree(ref.optimizer, ref.model).items()}
    counts = {id(p): {k: v for k, v in st.items() if not isinstance(v, torch.Tensor)}
              for p, st in ref.optimizer.state.items()}
    for n, p in ref.model.named_parameters():
        slots[n].update(counts[id(p)])  # the step counts
    del ref
    _empty(torch, device)
    det, logs = FailureDetector(), []
    step = step_on(mesh, shard_axis="fsdp")
    tr = tt.Trainer(step, log_every=1, log_fn=logs.append, checkpoint_dir=tmp,
                    checkpoint_every=1000, failure_detector=det, on_failure="reshard")
    tr.fit(data, RESHARD_AFTER)
    det.inject_device_loss(1)
    _reset_counters()
    _, ms, sent = _window_bytes(torch, lambda: tr.fit(data[RESHARD_AFTER:],
                                                       2 * RESHARD_AFTER + 1))
    launches = _read_counters()
    what = f"reshard llama_1b rank {rank}"
    bounce = {"log": [m for m in logs if "failure" in m], "last": tr.last_reshard,
              "departed": tr.departed, "ms": ms, "collective_bytes": sent,
              "launches": launches, "t_reshard_s": tr._t_reshard}
    small = create_mesh({"fsdp": 1}, devices=[0], member=False)
    steps_run = RESHARD_AFTER + 1 if rank else 2 * RESHARD_AFTER + 1
    n = RESHARD_LAYERS * (steps_run - RESHARD_AFTER)
    _gate(what, launches, {"flash_fwd_lse": n, "flash_bwd_dkv": n, "flash_bwd_dq": n,
                           "flash_bwd_delta": n}, failures)
    if (tr.last_reshard or {}).get("mode") != "checkpoint" or tr.departed != bool(rank):
        failures.append(f"{what}: the bounce gave {tr.last_reshard}, departed {tr.departed}")
    if rank == 0:  # the world-1 run resumed from the replayed state
        bounce["losses"] = [float(x) for x in tr.step.losses[RESHARD_AFTER + 1:]]
        final = {n: p.detach().clone() for n, p in tr.step.model.named_parameters()}
        del tr, step
        _empty(torch, device)
        oracle = step_on(small, shard_axis="fsdp")
        with torch.no_grad():
            for n, p in oracle.model.named_parameters():
                p.copy_(params[n])
        names = {id(p): n for n, p in oracle.model.named_parameters()}
        for _, p, _ in oracle._params:
            oracle.optimizer.state[p] = slots[names[id(p)]]
        tt.Trainer(oracle, log_every=1, log_fn=lambda _: None).fit(data[RESHARD_AFTER + 1:])
        bounce["oracle_losses"] = [float(x) for x in oracle.losses]
        differ = [n for n, p in oracle.model.named_parameters() if not torch.equal(p, final[n])]
        bounce["bit_equal"] = not differ and bounce["losses"] == bounce["oracle_losses"]
        if not bounce["bit_equal"]:
            failures.append(f"{what}: the resumed run is not bit-equal to the oracle's "
                            f"({differ[:4]}, losses {bounce['losses']} against "
                            f"{bounce['oracle_losses']})")
        del oracle, final
    else:
        del tr, step
    del params, slots
    _empty(torch, device)
    out["bounce"] = bounce
    # (i.2) live: {"dp": 2} losing a rank keeps a whole replica on rank 0
    dp = create_mesh({"dp": world})
    det = FailureDetector()
    step = step_on(dp, shard_axis=None, replica_axes=("dp",))
    tr = tt.Trainer(step, log_every=1, log_fn=lambda _: None, checkpoint_dir=tmp,
                    checkpoint_every=1000, failure_detector=det, on_failure="reshard")
    tr.fit(data, 1)
    det.inject_device_loss(1)
    tr.fit(data[1:], 3)
    live = {"last": tr.last_reshard, "departed": tr.departed,
            "losses": [float(x) for x in tr.step.losses] if not tr.departed else None}
    last = tr.last_reshard or {}
    if (last.get("mode") != "live" or last.get("wire_bytes") != 0
            or any(last.get("payload_bytes", {1: 1}).values())):
        failures.append(f"{what}: the dp shrink gave {last}")
    out["live"] = live
    del tr, step
    _empty(torch, device)
    # (i.3) ZeRO-2: {"dp": 2} losing a rank; the optimizer's dp slices bounce
    # through the checkpoint and are cut again over {"dp": 1}, then
    # RESHARD_AFTER steps, held bit for bit against world 1 resumed from
    # the state a clean two-rank run reaches at the recovery step
    zero2, f = _zero2_bounce(torch, seed, tmp, data, loss_fn, device)
    failures += f
    out["zero2"] = zero2
    return out, failures


def _held_by_name(step) -> dict:
    """``{parameter name: the tensor the step's optimizer holds for it}``:
    a ZeRO-2 slice (``_tdx_path``) or the parameter itself."""
    name_of = {id(p): n for n, p in step.model.named_parameters()}
    return {getattr(t, "_tdx_path", None) or name_of[id(t)]: t
            for g in step.optimizer.param_groups for t in g["params"]}


def _zero2_bounce(torch, seed, tmp, data, loss_fn, device):
    """(i.3) on one rank of two (``_reshard_run``'s batches and loss)."""
    import torch.distributed as dist
    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.parallel import GSPMDTrainStep, ShardingPlan, create_mesh
    from torchdistx_tpu_torch.parallel.plan import gather_full
    from torchdistx_tpu_torch.parallel.reshard import optimizer_state_tree
    from torchdistx_tpu_torch.utils.failure import FailureDetector

    rank = dist.get_rank()
    dp = create_mesh({"dp": dist.get_world_size()})

    def step_on(mesh, params=None):
        tt.manual_seed(seed)
        m = tt.materialize_module(tt.deferred_init(
            Llama.from_name, PARALLEL_LLAMA, n_layers=RESHARD_LAYERS, max_seq_len=RESHARD_SEQ,
            remat=False, device=device))
        if params is not None:  # before the step slices them
            with torch.no_grad():
                for n, p in m.named_parameters():
                    p.copy_(params[n])
        return GSPMDTrainStep(m, tt.AnyPrecisionAdamW(m.parameters(), lr=1e-4), loss_fn,
                              mesh, batch_spec=("dp",),
                              plan=ShardingPlan(mesh, dp_axis="dp", zero2=True))

    ref = step_on(dp)
    tt.Trainer(ref, log_every=1, log_fn=lambda _: None).fit(data, RESHARD_AFTER + 1)
    tree = optimizer_state_tree(ref.optimizer, ref.model)
    with dp:
        params = {n: gather_full(p).clone() for n, p in ref.model.named_parameters()}
        slots = {n: {k: gather_full(v).clone() for k, v in row.items()}
                 for n, row in tree.items()}
    for n, t in _held_by_name(ref).items():  # the step counts
        slots[n].update({k: v for k, v in ref.optimizer.state[t].items()
                         if not isinstance(v, torch.Tensor)})
    sliced = len(ref._zero2)
    del ref, tree
    _empty(torch, device)
    det, logs = FailureDetector(), []
    step = step_on(dp)
    tr = tt.Trainer(step, log_every=1, log_fn=logs.append, checkpoint_dir=tmp,
                    checkpoint_every=1000, failure_detector=det, on_failure="reshard")
    tr.fit(data, RESHARD_AFTER)
    det.inject_device_loss(1)
    t0 = time.perf_counter()
    tr.fit(data[RESHARD_AFTER:], 2 * RESHARD_AFTER + 1)
    what = f"zero2 reshard llama_1b rank {rank}"
    out = {"log": [m for m in logs if "failure" in m], "last": tr.last_reshard,
           "departed": tr.departed, "seconds": time.perf_counter() - t0,
           "sliced_before": sliced, "t_reshard_s": tr._t_reshard}
    failures = []
    if (tr.last_reshard or {}).get("mode") != "checkpoint" or tr.departed != bool(rank):
        failures.append(f"{what}: the bounce gave {tr.last_reshard}, departed {tr.departed}")
    if rank == 0:
        out["losses"] = [float(x) for x in tr.step.losses[RESHARD_AFTER + 1:]]
        out["sliced_after"] = len(tr.step._zero2)
        final = {n: p.detach().clone() for n, p in tr.step.model.named_parameters()}
        del tr, step
        _empty(torch, device)
        oracle = step_on(create_mesh({"dp": 1}, devices=[0], member=False), params)
        for n, t in _held_by_name(oracle).items():
            oracle.optimizer.state[t] = slots[n]
        tt.Trainer(oracle, log_every=1, log_fn=lambda _: None).fit(data[RESHARD_AFTER + 1:])
        out["oracle_losses"] = [float(x) for x in oracle.losses]
        differ = [n for n, p in oracle.model.named_parameters() if not torch.equal(p, final[n])]
        out["bit_equal"] = not differ and out["losses"] == out["oracle_losses"]
        if not out["bit_equal"] or len(out["losses"]) != RESHARD_AFTER:
            failures.append(f"{what}: the resumed run is not world 1's ({differ[:4]}, losses "
                            f"{out['losses']} against {out['oracle_losses']})")
        del oracle, final
    else:
        del tr, step
    del params, slots
    _empty(torch, device)
    return out, failures


def _parallel_launches(runs, key) -> dict:
    """``{part: launches of counter key}`` of phase 23 (e)-(i) on one rank."""
    return {part: (runs[part]["bounce"] if part == "i" else runs[part])["launches"].get(key, 0)
            for part in "efghi"}


def _parallel_runs(torch, seed, tmp, device="cuda"):
    """Phase 23 (e)-(i) on one rank of two: returns ``{part: result}`` and
    the failures."""
    out, failures = {}, []
    for part, fn in (("e", lambda: _sp_model_run(torch, seed, "e", device)),
                     ("f", lambda: _sp_model_run(torch, seed, "f", device)),
                     ("g", lambda: _pp_run(torch, seed, device)),
                     ("h", lambda: _zero2_run(torch, seed, device)),
                     ("i", lambda: _reshard_run(torch, seed, tmp, device))):
        t0 = time.perf_counter()
        out[part], f = fn()
        out[part]["seconds"] = time.perf_counter() - t0
        failures += f
        _empty(torch, device)
    return out, failures


@contextlib.contextmanager
def _logits_tap(engine):
    """The logits ``engine``'s own dispatches sample from, f32 on the host:
    ``firsts``, each prefill's row at its last real prompt position in
    dispatch order, and ``decode``, the first decode step's last row of
    every slot.  A TP engine's are the head's gathered logits."""
    tap = {"firsts": [], "decode": None}
    model = engine.model
    sample_first, forward_decode = engine._sample_first, model.forward_decode

    def first(logits, true_len, temp, seed):
        tap["firsts"].append(logits[0, true_len - 1].float().cpu())
        return sample_first(logits, true_len, temp, seed)

    def decode(*args, **kw):
        logits, kv = forward_decode(*args, **kw)
        if tap["decode"] is None:
            tap["decode"] = logits[:, -1].float().cpu()
        return logits, kv

    engine._sample_first, model.forward_decode = first, decode
    try:
        yield tap
    finally:
        del engine._sample_first, model.forward_decode


def _row_rel_errs(got, want) -> list:
    """Each row's ``max |got - want| / max |want|``."""
    return [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1]))]


def _tp_serve_run(torch, seed):
    """Phase 23 (j) on one rank of two: llama3_8b at full width,
    TP_SERVE_LAYERS deep, deferred and materialized under ``llama_tp_plan``
    on ``{"tp": 2}``, checked by ``plan.validate`` against the card's
    memory, then served by ``ServeEngine(model, mesh=, plan=)`` in each of
    TP_SERVE_RUNS under ``comm_audit``.  Each run is held to: the audit
    equal to the engine's closed form (2 L all-reduces of n_tokens x dim x
    2 bytes a prefill dispatch and a decode step); what ``gloo`` carried
    (``collectives.payload_bytes``) equal to that plus the embedding's
    vocabulary all-reduce (n_tokens x dim x 2 bytes) in all-reduce, and to
    the head's logits pieces (n_tokens x vocab / 2 x 2 bytes) in
    all-gather; flash and decode launches; every stream TP_SERVE_NEW long.
    Tokens/s is reported (``gloo`` staged through the host: not a speed
    figure).  A persistent TP engine over ``gloo`` must be refused.  Rank 0
    then serves the same requests in each run's mode on a world-1 engine
    over the model whole (the pieces gathered: the same seed's weights):
    every stream's first token equal, the greedy agreement at least
    TP_SERVE_AGREEMENT, and the logits both engines' dispatches sampled
    from (every prefill's, the first decode step's) within
    TP_SERVE_LOGITS_RTOL of the row's largest world-1 logit.  Each run is
    also served again with ``numerics=True``: its book held by
    :func:`book_failures` (the folded KV digests of both ranks' heads; the
    logits count the closed form, unfolded), its streams, counters and
    audit equal to the run with numerics off; the two ranks' books equal
    (:func:`_tp_serve_failures`)."""
    import numpy as np
    import torch.distributed as dist
    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.obs import comm_audit, device_hbm_budget
    from torchdistx_tpu_torch.interop import from_torch_state_dict
    from torchdistx_tpu_torch.parallel import collectives, create_mesh, llama_tp_plan
    from torchdistx_tpu_torch.parallel.plan import gather_full
    from torchdistx_tpu_torch.serve import ServeEngine

    rank = dist.get_rank()
    failures, out = [], {"rank": rank}
    t0 = time.perf_counter()
    mesh = create_mesh({"tp": 2})
    plan = llama_tp_plan(mesh)

    tt.manual_seed(seed)
    model = tt.materialize_module(
        tt.deferred_init(Llama.from_name, "llama3_8b", n_layers=TP_SERVE_LAYERS,
                         device="cuda", dtype=torch.bfloat16), sharding_rule=plan.as_rule())
    report = plan.validate(model, budget_bytes_per_device=device_hbm_budget("cuda"))
    out["validate"] = {k: report[k] for k in ("total_bytes", "bytes_per_device", "flags",
                                              "shard_budget", "n_entries") if k in report}
    out["build_s"] = time.perf_counter() - t0
    cfg = model.cfg
    itemsize = 2  # bf16 activations and logits
    reqs = make_requests(np.random.RandomState(seed), cfg.vocab_size, n=TP_SERVE_REQUESTS,
                         n_greedy=TP_SERVE_REQUESTS, max_new=TP_SERVE_NEW, lo=16, hi=1024)
    taps = {}
    for label, kw in TP_SERVE_RUNS:
        eng = ServeEngine(model, num_slots=TP_SERVE_SLOTS, max_len=2048, mesh=mesh, plan=plan,
                          cost_cards=False, **kw)
        torch.cuda.synchronize()
        _reset_counters()
        sent = dict(collectives.payload_bytes)
        t1 = time.perf_counter()
        with comm_audit() as prof, _logits_tap(eng) as taps[label]:
            results = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        c = eng.metrics.counters
        n_tokens = c["tokens_prefilled"] + c["decode_steps"] * TP_SERVE_SLOTS
        ops = 2 * TP_SERVE_LAYERS * (c["prefill_calls"] + c["decode_steps"])
        payload = 2 * TP_SERVE_LAYERS * n_tokens * cfg.dim * itemsize
        carried = {k: v - sent[k] for k, v in collectives.payload_bytes.items()}
        want_carried = {"all_reduce": payload + n_tokens * cfg.dim * itemsize,
                        "all_gather": n_tokens * (cfg.vocab_size // 2) * itemsize}
        launches = {k: v for k, v in _read_counters().items() if v}
        row = {"audit": prof.to_json()["entries"], "closed_form_ops": ops,
               "closed_form_payload_bytes": payload, "gloo_payload_bytes": carried,
               "gloo_closed_form_bytes": want_carried,
               "launches": launches, "wall_s": wall,
               "tokens_per_sec": c["tokens_generated"] / wall,
               "counters": {k: c[k] for k in SERVE_COUNTERS},
               "kv_heads_a_rank": eng.cache.kv[0][0].shape[2],
               "memory_plan": eng.memory_plan()["components"],
               "streams": [list(map(int, r.tokens)) for r in results]}
        out[label] = row
        if (prof.ops("all_reduce", "tp") != ops or prof.payload_bytes("all_reduce", "tp") != payload
                or len(row["audit"]) != 1):
            failures.append(f"tp serve {label} rank {rank}: audit {row['audit']} != closed form "
                            f"{ops} ops, {payload} bytes")
        if any(carried[k] != v for k, v in want_carried.items()):
            failures.append(f"tp serve {label} rank {rank}: gloo carried {carried}, the closed "
                            f"forms give {want_carried}")
        want = ("decode_attention",) if label == "slab" else ("paged_decode_attention_int8",)
        for key in ("flash_fwd",) + want:
            if not launches.get(key):
                failures.append(f"tp serve {label} rank {rank}: no {key} launch")
        if any(len(s) != TP_SERVE_NEW for s in row["streams"]):
            failures.append(f"tp serve {label} rank {rank}: a stream is not {TP_SERVE_NEW} long")
    for label, kw in TP_SERVE_RUNS:  # again with the numerics observatory on
        eng = ServeEngine(model, num_slots=TP_SERVE_SLOTS, max_len=2048, mesh=mesh, plan=plan,
                          cost_cards=False, numerics=True, **kw)
        t1 = time.perf_counter()
        with comm_audit() as prof:
            results = eng.run(reqs)
        torch.cuda.synchronize()
        c, row = eng.metrics.counters, out[label]
        book = eng.numerics_book
        num = {"wall_s": time.perf_counter() - t1, "book": book.to_json()["sites"],
               "harvest_errors": eng.numerics_harvest_errors,
               "streams_equal_off": [list(map(int, r.tokens)) for r in results]
               == row["streams"],
               "counters_equal_off": {k: c[k] for k in SERVE_COUNTERS} == row["counters"],
               "audit_equal_off": prof.to_json()["entries"] == row["audit"]}
        row["numerics"] = num
        what = f"tp serve {label} numerics rank {rank}"
        failures += book_failures(what, book, c, TP_SERVE_SLOTS, cfg.vocab_size,
                                  cfg.dim // cfg.n_heads, kw.get("kv_dtype") == "int8")
        for key in ("streams_equal_off", "counters_equal_off", "audit_equal_off"):
            if not num[key]:
                failures.append(f"{what}: {key} is false")
        if num["harvest_errors"]:
            failures.append(f"{what}: {num['harvest_errors']} failed harvests")
    try:
        ServeEngine(model, num_slots=TP_SERVE_SLOTS, max_len=2048, mesh=mesh, plan=plan,
                    decode_mode="persistent", cost_cards=False)
        failures.append(f"tp serve rank {rank}: a persistent engine over gloo was built")
    except RuntimeError as e:
        out["persistent_refused"] = str(e)[:160]
    del eng
    with torch.no_grad():  # every rank takes part in the gathers
        full = {n: gather_full(p) for n, p in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    if rank == 0:  # world 1: the same seed's model whole, the same requests
        whole = tt.deferred_init(Llama.from_name, "llama3_8b", n_layers=TP_SERVE_LAYERS,
                                 device="cuda", dtype=torch.bfloat16)
        from_torch_state_dict(whole, full, {k: (k, None) for k in full})
        for label, kw in TP_SERVE_RUNS:
            eng = ServeEngine(whole, num_slots=TP_SERVE_SLOTS, max_len=2048, cost_cards=False,
                              **kw)
            with _logits_tap(eng) as ref_tap:
                ref = [list(map(int, r.tokens)) for r in eng.run(reqs)]
            row, tap = out[label], taps[label]
            parts = [_first_divergence(a, b) for a, b in zip(row["streams"], ref)]
            agree = sum(len(a) if p is None else p for a, p in zip(ref, parts))
            row["world1_agreement"] = agree / sum(len(a) for a in ref)
            row["world1_first_divergence"] = parts
            if len(tap["firsts"]) != TP_SERVE_REQUESTS or len(ref_tap["firsts"]) != TP_SERVE_REQUESTS:
                failures.append(f"tp serve {label}: {len(tap['firsts'])} and "
                                f"{len(ref_tap['firsts'])} prefills sampled, not "
                                f"{TP_SERVE_REQUESTS}")
            errs = {"prefill": _row_rel_errs(torch.stack(tap["firsts"]),
                                             torch.stack(ref_tap["firsts"])),
                    "decode": _row_rel_errs(tap["decode"], ref_tap["decode"])}
            row["world1_logits_rel_err"] = errs
            if 0 in parts:
                failures.append(f"tp serve {label}: a first token differs from world 1's "
                                f"({parts})")
            if row["world1_agreement"] < TP_SERVE_AGREEMENT:
                failures.append(f"tp serve {label}: greedy agreement with world 1 "
                                f"{row['world1_agreement']} < {TP_SERVE_AGREEMENT}")
            worst = max(errs["prefill"] + errs["decode"])
            if worst > TP_SERVE_LOGITS_RTOL:
                failures.append(f"tp serve {label}: logits against world 1 {worst} > "
                                f"{TP_SERVE_LOGITS_RTOL}")
        del whole, eng
    del full
    torch.cuda.empty_cache()
    collectives.barrier()
    out["seconds"] = time.perf_counter() - t0
    return out, failures


EXAMPLE_SP_SEQ = 1024  # TDX_SEQ of examples.long_context_sp in phase 23's world


def _sp_example_run(torch, seq=EXAMPLE_SP_SEQ):
    """``examples.long_context_sp.main`` (the ring) on one rank of phase
    23's world over ``{"sp": 2}`` at a global context of ``seq``, with the
    launch counters set to 0 just before: the residuals forward kernel
    once a ring block a layer a step and once a block for the biased ring,
    the f32 dK/dV and dQ kernels once a block a layer a step (the rank's
    blocks: ``_ring_blocks``); every loss finite and the last below the
    first, the biased output finite."""
    import torch.distributed as dist
    from torchdistx_tpu_torch.examples import long_context_sp

    rank = dist.get_rank()
    _reset_counters()
    t0 = time.perf_counter()
    out = long_context_sp.main(sp_mode="ring", seq=seq, device="cuda", log_fn=lambda m: None)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counters().items() if v}
    layers, steps = out["step"].model.cfg.n_layers, len(out["losses"])
    blocks = _ring_blocks(True, rank, out["ranks"])
    res = {k: out[k] for k in ("ranks", "sp_mode", "seq", "losses", "biased_out_shape",
                               "biased_out_finite")}
    res.update(seconds=time.perf_counter() - t0, launches=launches)
    want = {"flash_fwd_residuals": blocks * (layers * steps + 1),
            "flash_bwd_dkv_f32": blocks * layers * steps,
            "flash_bwd_dq_f32": blocks * layers * steps}
    failures = _launch_failures(f"long_context_sp rank {rank}", res, want)
    losses = res["losses"]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and res["biased_out_finite"]):
        failures.append(f"long_context_sp rank {rank}: losses {losses}, biased output "
                        f"finite {res['biased_out_finite']}")
    return res, failures


def _tp_serve_failures(ranks) -> list:
    """The two ranks' streams of phase 23 (j) equal, bit for bit."""
    runs = [r.get("tp_serve", {}) for r in ranks]
    if len(runs) != 2 or not all(runs):
        return ["tp serve: a rank returned no result"]
    out = [f"tp serve {label}: the ranks' streams differ"
           for label, _ in TP_SERVE_RUNS
           if runs[0].get(label, {}).get("streams") != runs[1].get(label, {}).get("streams")]
    books = [[r.get(label, {}).get("numerics", {}).get("book") for r in runs]
             for label, _ in TP_SERVE_RUNS]
    out += [f"tp serve {label} numerics: the ranks' books differ or are missing"
            for (label, _), (a, b) in zip(TP_SERVE_RUNS, books) if a is None or a != b]
    return out


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
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            result["tp_ep"], fails = _tp_ep_runs(torch, seed)
            result["tp_ep"]["seconds"] = time.perf_counter() - t0
            result["failures"] += fails
            torch.cuda.empty_cache()
            result["parallel"], fails = _parallel_runs(torch, seed,
                                                       os.path.dirname(store_path))
            result["failures"] += fails
            torch.cuda.empty_cache()
            result["tp_serve"], fails = _tp_serve_run(torch, seed)
            result["failures"] += fails
            torch.cuda.empty_cache()
            # phase 32, in this world: a process of its own would pay its
            # start and its first deferred init again
            t0 = time.perf_counter()
            result["config5_sharded"], fails = _config5_sharded_runs(torch, seed + 20)
            result["config5_sharded"]["seconds"] = time.perf_counter() - t0
            result["failures"] += fails
            torch.cuda.empty_cache()
            result["example_sp"], fails = _sp_example_run(torch)
            result["failures"] += fails
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


def _config5_run(torch, seed, warmup, steps):
    """Phase 25's body, in the spawned process: ``build_train_workload``
    of full llama2_7b (deferred init, materialize on the card, the 8-bit
    AdamW, ``remat_policy="dots"``, the fused loss), ``warmup`` steps, then
    ``steps`` timed ``Trainer.fit`` steps with the launch counters set to 0
    just before and read just after."""
    from torchdistx_tpu_torch import deferred_init, is_fake
    from torchdistx_tpu_torch.models.llama import Llama
    from torchdistx_tpu_torch.utils.benchmarks import _PeakRss, _rss_now_gb, build_train_workload

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.init()
    cuda_gb = _rss_now_gb()
    w = build_train_workload("llama2_7b", batch=CONFIG5_BATCH, seq=CONFIG5_SEQ,
                             optimizer="adamw_8bit", remat=True, remat_policy="dots",
                             fused_ce=True, device="cuda", seed=seed, cost_card=True)
    model, cfg = w["model"], w["model"].cfg
    params = list(model.parameters())
    info = {k: w[k] for k in ("deferred_init_s", "materialize_s", "host_rss_before_gb",
                              "peak_host_rss_gb", "host_rss_delta_gb", "card_bytes_deferred",
                              "card_bytes_materialized", "n_params", "flops_per_token")}
    info.update(model="llama2_7b", layers=cfg.n_layers, dim=cfg.dim, heads=cfg.n_heads,
                kv_heads=cfg.n_kv_heads, ffn_dim=cfg.ffn_dim, vocab=cfg.vocab_size,
                batch=w["batch_size"], seq=w["seq"], optimizer="adamw_8bit",
                remat_policy="dots", fused_ce=True, host_rss_after_cuda_init_gb=cuda_gb,
                all_on_card_bf16=all(p.is_cuda and p.dtype == torch.bfloat16
                                     and not is_fake(p) for p in params))
    # the same deferred init twice more, warm: unsampled, then under the
    # host-RSS sampler (what the first one's time owes to a cold start,
    # and what the sampler costs)
    for key, ctx in (("unsampled", contextlib.nullcontext), ("sampled", _PeakRss)):
        t0 = time.perf_counter()
        with ctx():
            twin = deferred_init(Llama.from_name, "llama2_7b", device="cuda",
                                 max_seq_len=CONFIG5_SEQ, remat=True, remat_policy="dots")
        info[f"deferred_init_warm_{key}_s"] = time.perf_counter() - t0
        del twin
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    info["warmup_losses"] = w["run"](warmup)
    torch.cuda.synchronize()
    info["warmup_s"] = time.perf_counter() - t0
    _reset_counters()
    t0 = time.perf_counter()
    info["losses"] = w["run"](steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info["launches"] = _read_counters()
    tokens_per_s = w["tokens_per_batch"] * steps / wall
    info.update(steps=steps, warmup_steps=warmup, step_ms=wall / steps * 1e3,
                tokens_per_sec=tokens_per_s,
                mfu=w["flops_per_token"] * tokens_per_s / H100_BF16_FLOPS,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                state_bytes=w["optimizer"].state_bytes())
    info["state_bytes_per_param"] = info["state_bytes"] / info["n_params"]
    # the counted card, taken on the first warm-up step: the step's FLOPs,
    # and the timed steps' MFU on them
    from torchdistx_tpu_torch.obs.cost import span_mfu

    card = w["trainer"].cost_card
    info["counted"] = None if card is None else {
        "card": card_label(), "flops": card.flops, "kernel_flops": card.kernel_flops,
        "flops_source": card.flops_source, "analytic_flops": card.analytic_flops,
        "flop_attribution": card.flop_attribution, "kernel_launches": card.kernel_launches,
        "bytes_accessed": card.bytes_accessed,
        "arithmetic_intensity": card.arithmetic_intensity,
        "mfu_xla": span_mfu(card, executions=steps, seconds=wall, peak_flops=H100_BF16_FLOPS),
        "trainer_mfu_xla": w["trainer"].metrics["mfu_xla"]}

    def drive(on_step):
        w["trainer"].log_fn = on_step  # called after each synchronized step
        w["run"](CONFIG5_PROFILE_STEPS + 1)

    # where a step's time goes, the optimizer's span among it
    info["profile"] = _profile(torch, drive, CONFIG5_PROFILE_STEPS)
    # what the f64 emulation costs the update, and what it changes
    info["update_f64_vs_f32"] = _update_f64_vs_f32(torch, w["optimizer"])
    return info


def _plain_f32_quantize(torch, x, block, signed):
    blocks = torch.nn.functional.pad(x.reshape(-1), (0, (-x.numel()) % block)).reshape(-1, block)
    absmax = blocks.abs().amax(dim=1, keepdim=True)
    if signed:
        scales = absmax / 127.0
        return torch.round(blocks / scales.clamp(min=1e-30)).to(torch.int8), scales
    unit = blocks / absmax.clamp(min=1e-30)
    return torch.round(255.0 * unit.pow(0.25)).to(torch.uint8), absmax


def _plain_f32_dequantize(torch, codes, scales, shape):
    unit = (codes.float() / 255.0).pow(4.0) if codes.dtype == torch.uint8 else codes.float()
    return (unit * scales).reshape(-1)[:shape.numel()].reshape(shape)


def _plain_f32_update(torch, p, grad, state, group, c1, c2, block):
    """``AdamW8bit``'s update of one parameter, in place, written in plain
    f32 as the JAX source reads: separate multiplies and adds, f32
    ``pow``, no f64.  Phase 25 times it beside the port's update, which
    emulates XLA's fused multiply-adds and the C library's ``powf`` in f64
    to match the JAX package's codes; the port does not use it."""
    b1, b2 = group["betas"]
    lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
    g32 = grad.float()
    m = b1 * _plain_f32_dequantize(torch, state["m_codes"], state["m_scales"], p.shape)
    m = m + (1.0 - b1) * g32
    v = b2 * _plain_f32_dequantize(torch, state["v_codes"], state["v_scales"], p.shape)
    v = v + (1.0 - b2) * g32 * g32
    denom = torch.sqrt(v / c2) + eps
    upd = -lr * ((m / c1) / denom + wd * p.float())
    p.add_(upd.to(p.dtype))
    state["m_codes"], state["m_scales"] = _plain_f32_quantize(torch, m, block, True)
    state["v_codes"], state["v_scales"] = _plain_f32_quantize(torch, v, block, False)


def _update_f64_vs_f32(torch, opt, repeats=1):
    """The 8-bit update with and without its f64 emulation, from the last
    step's gradients: on the largest parameter, both from one state, the
    share of codes and parameter values where they differ; then a whole
    step over every parameter, CUDA events around it, the port's
    ``AdamW8bit.step`` and :func:`_plain_f32_update` alternated ``repeats``
    times.  Run last: both move the parameters and the state."""
    from torchdistx_tpu_torch.optimizers.quantized import _correction

    with torch.no_grad():
        pairs = [(g, p) for g in opt.param_groups for p in g["params"] if p.grad is not None]
        group, big = max(pairs, key=lambda gp: gp[1].numel())
        b1, b2 = group["betas"]
        c1 = _correction(b1, opt.count + 1, big.device)
        c2 = _correction(b2, opt.count + 1, big.device)
        port_p, plain_p = big.detach().clone(), big.detach().clone()
        port_st = {k: v.clone() for k, v in opt.state[big].items()}
        plain_st = {k: v.clone() for k, v in opt.state[big].items()}
        opt._update(port_p, big.grad, port_st, group, c1, c2)
        _plain_f32_update(torch, plain_p, big.grad, plain_st, group, c1, c2, opt.block_size)
        out = {"leaf_numel": big.numel(),
               "leaf_params_differ": float((port_p != plain_p).float().mean()),
               **{f"leaf_{k}_differ": float((port_st[k] != plain_st[k]).float().mean())
                  for k in ("m_codes", "v_codes", "m_scales", "v_scales")}}
        del port_p, plain_p, port_st, plain_st

        def plain_step():
            opt.count += 1
            for group, p in pairs:
                b1, b2 = group["betas"]
                _plain_f32_update(torch, p, p.grad, opt.state[p], group,
                                  _correction(b1, opt.count, p.device),
                                  _correction(b2, opt.count, p.device), opt.block_size)

        spans = {"port_f64_ms": [], "plain_f32_ms": []}
        for _ in range(repeats):
            for key, step in (("port_f64_ms", opt.step), ("plain_f32_ms", plain_step)):
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                step()
                end.record()
                end.synchronize()
                spans[key].append(start.elapsed_time(end))
    return {**spans, **out}


def _spawned_child(out_path, fn_name, args):
    """A spawned phase's process: ``fn_name(torch, *args)`` of this module,
    its result (or the traceback) written as JSON to ``out_path``."""
    result = {}
    try:
        import torch
        from torchdistx_tpu_torch.utils.benchmarks import _rss_now_gb

        after_import = _rss_now_gb()
        result = globals()[fn_name](torch, *args)
        result["host_rss_after_import_gb"] = after_import
    except Exception:
        result["error"] = traceback.format_exc()
    with open(out_path, "w") as f:
        json.dump(result, f)


def _config5_failures(r):
    import math

    failures = []
    losses = r["warmup_losses"] + r["losses"]
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"config 5 losses not finite: {losses}")
    c = r.get("counted")
    if (not c or not c["flops"] or not c["kernel_flops"] or not c["mfu_xla"]
            or not c["bytes_accessed"]):
        failures.append(f"config 5 counted card: {c}")
    if not r["host_rss_delta_gb"] < CONFIG5_HOST_RSS_GB:
        failures.append(f"config 5 host RSS grew {r['host_rss_delta_gb']} GB")
    if abs(r["n_params"] - CONFIG5_PARAMS) > 0.005e9 or not r["all_on_card_bf16"]:
        failures.append(f"config 5 parameters: {r['n_params']}, "
                        f"on the card in bf16: {r['all_on_card_bf16']}")
    if r["card_bytes_deferred"] >= 1 << 20:
        failures.append(f"config 5 deferred init allocated {r['card_bytes_deferred']} bytes")
    lo, hi = CONFIG5_STATE_BYTES
    if not lo <= r["state_bytes_per_param"] <= hi:
        failures.append(f"config 5 8-bit state {r['state_bytes_per_param']} bytes a parameter")
    # dots recomputes each block's forward in the backward: the flash
    # forward launches twice a layer a step
    per = r["layers"] * r["steps"]
    expect = {"flash_fwd_lse": 2 * per, "flash_bwd_dkv": per, "flash_bwd_dq": per,
              "flash_bwd_delta": per, "fused_ce_fwd": r["steps"], "fused_ce_bwd": r["steps"]}
    for kernel, n in expect.items():
        if r["launches"][kernel] != n:
            failures.append(f"config 5: {kernel} launches {r['launches'][kernel]} != {n}")
    return failures


def _run_spawned(torch, fn_name, args, timeout, what):
    """``fn_name(torch, *args)`` in a spawned process (its host RSS peak its
    own, the card's memory to itself once the parent has given back its
    cached memory), killed after ``timeout`` s: (its result with the
    parent's card bytes and the process's seconds, failures)."""
    import multiprocessing as mp
    import shutil
    import tempfile

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    parent = {"parent_allocated_bytes": torch.cuda.memory_allocated(),
              "parent_reserved_bytes": torch.cuda.memory_reserved()}
    tmp = tempfile.mkdtemp(prefix="tdx_spawned_")
    try:
        out = os.path.join(tmp, "result.json")
        proc = mp.get_context("spawn").Process(target=_spawned_child,
                                               args=(out, fn_name, args))
        t0 = time.perf_counter()
        proc.start()
        proc.join(timeout)
        if proc.is_alive():
            proc.kill()
            proc.join()
            return parent, [f"{what} still running after {timeout} s"]
        wall = time.perf_counter() - t0
        if not os.path.exists(out):
            return parent, [f"{what} exited with {proc.exitcode} and wrote nothing"]
        with open(out) as f:
            result = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result.update(parent, process_s=wall, exitcode=proc.exitcode)
    if "error" in result:
        return result, [f"{what} raised:\n{result['error']}"]
    return result, []




def _mixtral_train_run(torch, seed, n_layers=MIXTRAL_TRAIN_LAYERS, seq=MIXTRAL_TRAIN_SEQ,
                       warmup=MIXTRAL_TRAIN_WARMUP, steps=MIXTRAL_TRAIN_STEPS,
                       name="mixtral_8x7b", device="cuda"):
    """Phase 25b's body: ``deferred_init`` of mixtral_8x7b at full width and
    ``n_layers`` layers (remat "full", bf16), ``materialize_module(
    sharding_rule=m.shard_rule(mesh))`` on a world-1 ``{"dp": 1, "ep": 1}``
    mesh, the loss ``cross_entropy + MIXTRAL_AUX_WEIGHT * aux`` through
    ``forward_with_aux`` (its first value also on the plain attention path),
    ``GSPMDTrainStep(plan=ShardingPlan(mesh, rules=MIXTRAL_EP_RULES))`` with
    the 8-bit AdamW through ``Trainer.fit``: ``warmup`` steps, then ``steps``
    timed with the launch counters set to 0 just before and read just
    after.  Then, on the same model (the MoE modules' mode set, no
    parameter changed), the gather dispatch at capacity 4.0 against the
    dense forward and MIXTRAL_CAPACITY_STEPS steps at capacity 1.25.  It
    also runs on the CPU at a small ``name`` (``"tiny"``), to rehearse."""
    import math

    import numpy as np
    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.models import Mixtral
    from torchdistx_tpu_torch.nn import functional as F
    from torchdistx_tpu_torch.nn.moe import MoE
    from torchdistx_tpu_torch.optimizers import adamw_8bit
    from torchdistx_tpu_torch.parallel import GSPMDTrainStep, ShardingPlan, create_mesh
    from torchdistx_tpu_torch.parallel.mesh import sharding_of

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    mesh = create_mesh({"dp": 1, "ep": 1})
    tt.manual_seed(seed)
    t0 = time.perf_counter()
    model = tt.deferred_init(Mixtral.from_name, name, n_layers=n_layers, remat=True,
                             max_seq_len=seq, device=device)
    deferred_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tt.materialize_module(model, sharding_rule=model.shard_rule(mesh))
    _sync(torch, device)
    materialize_s = time.perf_counter() - t0
    cfg = model.cfg
    plan = ShardingPlan(mesh, rules=MIXTRAL_EP_RULES)
    born = {n: tuple(sharding_of(p)[0].spec) for n, p in model.named_parameters()}
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    params = list(model.parameters())
    n_params = sum(p.numel() for p in params)
    n_expert = sum(m.w_gate.numel() + m.w_up.numel() + m.w_down.numel() for m in moes)
    # the Mixtral paper's active parameters: top_k of the E experts
    n_active = n_params - n_expert + n_expert * cfg.top_k / cfg.n_experts
    attn = 12 * cfg.n_layers * cfg.dim * seq
    flops_per_token = 6 * n_active + attn
    rs = np.random.RandomState(seed)
    batch = tuple(torch.from_numpy(rs.randint(0, cfg.vocab_size, (1, seq))).to(device)
                  for _ in range(2))
    auxes = []

    def loss_fn(mod, b):
        logits, aux = mod.forward_with_aux(b[0])
        auxes.append(aux.detach())
        return F.cross_entropy(logits, b[1]) + MIXTRAL_AUX_WEIGHT * aux

    # the first loss on the plain attention path, the same weights and batch
    flash = cfg.use_flash
    cfg.use_flash = False
    with torch.no_grad():
        plain_loss = float(loss_fn(model, batch))
    cfg.use_flash = flash
    auxes.clear()
    opt = adamw_8bit(params, MIXTRAL_TRAIN_LR)
    step = GSPMDTrainStep(model, opt, loss_fn, mesh, batch_spec=("dp",), plan=plan)
    trainer = tt.Trainer(step, tokens_per_batch=seq, flops_per_token=flops_per_token,
                         log_every=1, log_fn=lambda _: None)
    t0 = time.perf_counter()
    trainer.fit([batch] * warmup, warmup)
    _sync(torch, device)
    warmup_s = time.perf_counter() - t0
    _reset_counters()
    t0 = time.perf_counter()
    trainer.fit([batch] * steps, warmup + steps)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    tokens_per_s = seq * steps / wall
    info = {"model": name, "layers": cfg.n_layers, "dim": cfg.dim,
            "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "ffn_dim": cfg.ffn_dim,
            "experts": cfg.n_experts, "top_k": cfg.top_k, "vocab": cfg.vocab_size,
            "batch": 1, "seq": seq, "optimizer": "adamw_8bit", "remat_policy": cfg.remat_policy,
            "mesh": dict(mesh.shape), "deferred_init_s": deferred_s,
            "materialize_s": materialize_s, "n_params": n_params, "n_expert_params": n_expert,
            "n_active_params": n_active, "flops_per_token": flops_per_token,
            "dense_flops_per_token": 6 * n_params + attn,
            "expert_flops_executed_over_active": cfg.n_experts / cfg.top_k,
            "plan_matches_rule": born == {n: tuple(v) for n, v in plan.describe(model).items()},
            "expert_spec": born["blocks.0.mlp.w_gate"], "plain_first_loss": plain_loss,
            "warmup_s": warmup_s, "warmup_losses": [float(x) for x in step.losses[:warmup]],
            "losses": [float(x) for x in step.losses[warmup:]],
            "aux": [float(a) for a in auxes], "steps": steps, "step_ms": wall / steps * 1e3,
            "tokens_per_sec": tokens_per_s,
            "mfu_active": flops_per_token * tokens_per_s / H100_BF16_FLOPS,
            "peak_memory_bytes": peak,
            "peak_reserved_bytes": torch.cuda.max_memory_reserved() if on_card else None,
            "state_bytes": opt.state_bytes(), "launches": launches}
    if on_card:  # where a dense step's time goes

        def drive(on_step):
            trainer.log_fn = on_step  # called after each synchronized step
            done = trainer.global_step
            trainer.fit([batch] * (MIXTRAL_PROFILE_STEPS + 1), done + MIXTRAL_PROFILE_STEPS + 1)

        info["profile"] = _profile(torch, drive, MIXTRAL_PROFILE_STEPS)
        trainer.log_fn = lambda _: None
    # the capacity dispatch at Mixtral's width: set on the MoE modules
    ids = [id(p) for p in model.parameters()]

    def set_mode(cf, mode):
        for m in moes:
            m.capacity_factor, m.dispatch_mode = cf, mode

    # each MoE on the input the dense forward gave it, in both modes (the
    # same routing), then the whole forward in both, every router's logits
    # kept (a router near-tie that a rounding flips sends a token to
    # other experts in the layers after: _route_flips)
    inputs, routed = [], []
    hooks = [m.register_forward_pre_hook(lambda mod, args: inputs.append(args[0]))
             for m in moes]
    taps = [m.router.register_forward_hook(lambda mod, args, out: routed.append(out))
            for m in moes]
    with torch.no_grad():
        set_mode(None, "einsum")
        dense = model(batch[0]).float()
        for h in hooks:
            h.remove()
        dense_routed, routed[:] = routed[:], []
        per_layer = []
        for m, x in zip(moes, inputs):
            yd = m(x).float()
            m.capacity_factor, m.dispatch_mode = 4.0, "gather"
            yg = m(x).float()
            per_layer.append(float((yg - yd).abs().max() / yd.abs().max()))
        routed.clear()
        gathered = model(batch[0]).float()
        for h in taps:
            h.remove()
        flips = [_route_flips(torch, a, b, cfg.top_k) for a, b in zip(dense_routed, routed)]
        same = torch.ones(dense.shape[:-1], dtype=torch.bool, device=dense.device)
        for f in flips:
            same &= ~f.pop("mask").reshape(same.shape)
    info["gather_c4_vs_dense_by_layer"] = per_layer
    info["gather_c4_vs_dense_logits"] = float((gathered - dense).abs().max() / dense.abs().max())
    info["gather_c4_argmax_agreement"] = float(
        (gathered.argmax(-1) == dense.argmax(-1)).float().mean())
    info["gather_c4_route_flips"] = flips
    info["gather_c4_tokens_routed_alike"] = int(same.sum())
    info["gather_c4_vs_dense_logits_routed_alike"] = (
        float((gathered - dense)[same].abs().max() / dense.abs().max()) if same.any() else None)
    del dense, gathered, inputs, dense_routed, routed
    set_mode(1.25, "gather")
    cap_ms = []
    done = trainer.global_step
    for i in range(MIXTRAL_CAPACITY_STEPS):
        _sync(torch, device)
        t0 = time.perf_counter()
        trainer.fit([batch], done + i + 1)
        _sync(torch, device)
        cap_ms.append((time.perf_counter() - t0) * 1e3)
    info.update(capacity_factor=1.25, capacity_step_ms=cap_ms,
                capacity_losses=[float(x) for x in step.losses[done:]],
                mode_change_kept_parameters=[id(p) for p in model.parameters()] == ids,
                peak_memory_bytes_with_capacity=(torch.cuda.max_memory_allocated()
                                                 if on_card else None))
    info["all_finite"] = all(math.isfinite(x) for x in info["warmup_losses"] + info["losses"]
                             + info["capacity_losses"] + info["aux"])
    return info


def _route_flips(torch, a, b, k):
    """One MoE layer's routing in two runs, from its router logits ``a``
    and ``b`` (..., E): the tokens whose top-``k`` expert sets differ
    (``mask``, and how many), and how many of them had ``a``'s k-th and
    (k+1)-th logits further apart than twice the largest change of a
    logit between the runs (``unexplained``: a flip needs the gap to
    close, which that change cannot do), beside the tokens within it
    (``near_ties``), the largest change and the largest logit."""
    a, b = (x.float().reshape(-1, x.shape[-1]) for x in (a, b))
    sets = [torch.topk(x, k, dim=-1).indices.sort(-1).values for x in (a, b)]
    mask = (sets[0] != sets[1]).any(-1)
    top = torch.topk(a, k + 1, dim=-1).values
    margin = top[:, k - 1] - top[:, k]
    change = (a - b).abs().amax(-1)
    near = margin <= 2 * change
    return {"mask": mask, "flipped": int(mask.sum()), "near_ties": int(near.sum()),
            "unexplained": int((mask & ~near).sum()),
            "max_flipped_margin": float(margin[mask].max()) if mask.any() else None,
            "max_logit_change": float(change.max()), "max_abs_logit": float(a.abs().max())}


def _mixtral_failures(r):
    if "error" in r:
        return ["mixtral train raised:\n" + r["error"]]
    failures = []
    if not r["all_finite"]:
        failures.append(f"mixtral train: losses or aux not finite: {r['losses']} {r['aux']}")
    if not all(a > 0 for a in r["aux"]):
        failures.append(f"mixtral train: aux not positive: {r['aux']}")
    first = r["warmup_losses"][0]
    if not abs(first - r["plain_first_loss"]) <= MIXTRAL_LOSS_RTOL * abs(r["plain_first_loss"]):
        failures.append(f"mixtral train: first loss {first} against the plain path's "
                        f"{r['plain_first_loss']}")
    if r["layers"] == MIXTRAL_TRAIN_LAYERS and abs(r["n_params"] - MIXTRAL_TRAIN_PARAMS) > 0.01e9:
        failures.append(f"mixtral train: {r['n_params']} parameters")
    if not r["plan_matches_rule"] or tuple(r["expert_spec"]) != ("ep", None, None):
        failures.append(f"mixtral train: the plan and shard_rule disagree ({r['expert_spec']})")
    if not max(r["gather_c4_vs_dense_by_layer"]) <= MIXTRAL_GATHER_RTOL:
        failures.append("mixtral train: gather at capacity 4.0 is "
                        f"{r['gather_c4_vs_dense_by_layer']} off the dense MoE")
    alike = r["gather_c4_vs_dense_logits_routed_alike"]
    if alike is None or not alike <= MIXTRAL_GATHER_RTOL:
        failures.append(f"mixtral train: gather at capacity 4.0 is {alike} off the dense "
                        "forward's logits over the tokens routed alike")
    # the first MoE sees the same input in both modes; after it a token
    # changes experts only across a near-tie that the modes' rounding closed
    flips = r["gather_c4_route_flips"]
    if flips[0]["flipped"] or any(f["unexplained"] for f in flips):
        failures.append(f"mixtral train: routing differs between gather and dense: {flips}")
    if not r["mode_change_kept_parameters"]:
        failures.append("mixtral train: setting the MoE mode changed the parameters")
    # remat "full" recomputes each block's forward in the backward: the
    # flash forward launches twice a layer a step
    per = r["layers"] * r["steps"]
    expect = {"flash_fwd_lse": 2 * per, "flash_bwd_dkv": per, "flash_bwd_dq": per,
              "flash_bwd_delta": per, "fused_ce_fwd": 0, "fused_ce_bwd": 0}
    failures += [f"mixtral train: {k} launches {r['launches'][k]} != {n}"
                 for k, n in expect.items() if r["launches"][k] != n]
    return failures


def _phase25_runs(torch, seed, warmup, steps, vision_seed):
    """Phase 25's spawned process: config 5, then, once its model,
    optimizer and cached blocks are released, phase 25b's Mixtral run,
    then phases 27-28 (``{..., "mixtral": {...}, "vision": {...}}``): one
    process start and one first deferred init for all three."""
    import gc

    info = _config5_run(torch, seed, warmup, steps)
    for key, run in (("mixtral", lambda: _mixtral_train_run(torch, seed + 100)),
                     ("vision", lambda: _vision_runs(torch, vision_seed))):
        gc.collect()
        torch.cuda.empty_cache()
        info[f"card_bytes_before_{key}"] = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            info[key] = run()
        except Exception:
            info[key] = {"error": traceback.format_exc()}
        info[key]["phase_s"] = time.perf_counter() - t0
    return info


def train_config5(torch, seed, vision_seed, warmup=CONFIG5_WARMUP, steps=CONFIG5_STEPS):
    """Phases 25, 25b and 27-28: ``_phase25_runs`` in a spawned process,
    killed after CONFIG5_TIMEOUT_S."""
    result, failures = _run_spawned(torch, "_phase25_runs",
                                    (seed, warmup, steps, vision_seed),
                                    CONFIG5_TIMEOUT_S, "config 5")
    return result, failures or _config5_failures(result)


# -- phase 32: BASELINE config 5 sharded, two gloo ranks on the one card ------------
TRAIN_FSDP_LAYERS = 4  # of llama2_7b's 32: full width, the depth cut for time
FSDP_WORLD = 2
FSDP_STEPS = 1  # timed, after one warm-up whose update is checked bit for bit (2 before phase 33)
FSDP_LR = 1e-4  # build_train_workload's 8-bit AdamW
# losses of the two ranks against one rank over the same global batch:
# the gradients reach the update reduced in another order (bf16); the
# first call saw 2.0e-4 and 1.1e-3 on the second and third steps
FSDP_LOSS_RTOL = 1e-2
FSDP_VIT = ("vit_b16", 2)  # examples.vit_train: model, steps (of the example's 30; 3 before phase 33)


def _bits_digests(torch, named, slices=None) -> dict:
    """``{name: [sum, weighted sum]}`` of each tensor's bit pattern
    (:func:`_bits_checksum`), of ``slices[name]`` of it when given."""
    return {n: _bits_checksum(torch, [t if slices is None else t[slices[n]]])[0]
            for n, t in named}


def _fsdp_materialize_part(torch, seed, mesh, device, name="llama2_7b"):
    """(a): ``examples.deferred_init_7b`` of full llama2_7b, materialized
    FSDP-sharded over ``mesh``: seconds, host RSS, the card's bytes
    against the closed form (each sharded tensor's whole bytes over the
    mesh, each replicated one whole, the whole bytes those of
    ``obs.memory.last_materialize_report``), and the digest of every
    piece; rank 0 then materializes the model whole from the same seed and
    digests each rank's slice of it (nothing but digests crosses)."""
    import torch.distributed as dist
    from torchdistx_tpu_torch.examples import deferred_init_7b
    from torchdistx_tpu_torch.obs.memory import last_materialize_report
    from torchdistx_tpu_torch.parallel import collectives
    from torchdistx_tpu_torch.parallel.mesh import sharding_of

    rank = dist.get_rank()
    out = deferred_init_7b.main(name, device=device, seed=seed, mesh=mesh,
                                log_fn=lambda *_: None)
    model = out.pop("model")
    tensors = list(model.named_parameters()) + list(model.named_buffers())
    whole = cut_whole = held = 0
    for _, t in tensors:
        found = sharding_of(t)
        n = math.prod(found[1]) if found else t.numel()
        whole += n * t.element_size()
        if found and found[0].spec:
            cut_whole += n * t.element_size()
        held += t.untyped_storage().nbytes()
    report = last_materialize_report()
    cut = [n for n, t in model.named_parameters() if sharding_of(t) and sharding_of(t)[0].spec]
    # the closed form: the report's whole bytes less what the other ranks
    # hold of each cut tensor; the allocator's figure (card_bytes) adds the
    # slack of blocks it does not split (at most 1 MiB a block)
    out.update(rank=rank, whole_bytes=whole, report_total_bytes=report["total_bytes"],
               closed_form_bytes=report["total_bytes"] - cut_whole * (mesh.size - 1)
               // mesh.size, held_bytes=held, allocator_slack_bytes=out["card_bytes"] - held,
               sharded_params=len(cut), params=len(list(model.parameters())))
    mine = _bits_digests(torch, model.named_parameters())
    specs = {n: (tuple(sharding_of(p)[0].spec), tuple(sharding_of(p)[1]))
             for n, p in model.named_parameters()}
    names = sorted(mine)
    del model, tensors
    _empty(torch, device)
    # every rank's digests to every rank, through the booked choke point
    with mesh:
        table = collectives.all_gather(torch.tensor([mine[n] for n in names]), "fsdp")
    per_rank = table.reshape(mesh.size, len(names), 2).tolist()
    if rank == 0:
        from torchdistx_tpu_torch import deferred_init, manual_seed, materialize_module
        from torchdistx_tpu_torch.models import Llama

        manual_seed(seed)
        t0 = time.perf_counter()
        ref = materialize_module(deferred_init(Llama.from_name, name, device=device))
        _sync(torch, device)
        out["world1_materialize_s"] = time.perf_counter() - t0
        named = list(ref.named_parameters())
        differ = []
        for r, got in enumerate(per_rank):
            want = _bits_digests(torch, named, {n: _piece_of(*specs[n], r, mesh.size)
                                                for n in names})
            differ += [(r, n) for n, g in zip(names, got) if want[n] != g]
        out["pieces_equal_world1"] = not differ
        out["pieces_differ"] = differ[:8]
        del ref, named
        _empty(torch, device)
    collectives.barrier()
    return out


def _piece_of(spec, shape, index, n) -> tuple:
    """The slices of member ``index``'s piece of a ``shape`` tensor cut by
    ``spec`` over one axis of ``n`` members."""
    out = []
    for d, size in enumerate(shape):
        cut = d < len(spec) and spec[d] is not None
        out.append(slice(index * size // n, (index + 1) * size // n) if cut else slice(None))
    return tuple(out)


def _fsdp_train_part(torch, seed, mesh, device, name="llama2_7b", layers=TRAIN_FSDP_LAYERS,
                     seq=CONFIG5_SEQ, steps=FSDP_STEPS):
    """(b): config 5 at ``layers`` of llama2_7b's layers, full width,
    through ``ShardedTrainStep`` and a ``Trainer`` over ``mesh``: the
    8-bit AdamW placed by ``adam8bit_state_shardings`` (``init_optimizer``),
    ``remat_policy="dots"``, the fused loss, a global batch of
    ``world x seq`` tokens (config 5's one sequence a rank).  One warm-up
    step, whose update is held bit for bit against an unsharded
    ``AdamW8bit`` on the same gathered gradients, parameters and state,
    then ``steps`` timed steps (the launch counters set to 0 just before
    and read just after).  Rank 0 then trains the same model whole (world
    1) over the same global batch for the losses and the state bytes."""
    import numpy as np
    import torch.distributed as dist
    import torchdistx_tpu_torch as tt
    from torchdistx_tpu_torch.models import Llama
    from torchdistx_tpu_torch.obs.cost import span_mfu
    from torchdistx_tpu_torch.ops.fused_ce import fused_linear_cross_entropy
    from torchdistx_tpu_torch.optimizers import AdamW8bit
    from torchdistx_tpu_torch.parallel import ShardedTrainStep, collectives, fsdp_shard_rule
    from torchdistx_tpu_torch.parallel.mesh import sharding_of
    from torchdistx_tpu_torch.parallel.plan import gather_full

    rank, world = dist.get_rank(), dist.get_world_size()
    kw = dict(n_layers=layers, max_seq_len=seq, remat=True, remat_policy="dots",
              device=device)
    vocab = Llama.configs[name]["vocab_size"]
    rs = np.random.RandomState(seed)
    batch = tuple(torch.from_numpy(rs.randint(0, vocab, (world, seq))).to(device)
                  for _ in range(2))

    def loss_fn(m, b):
        return fused_linear_cross_entropy(m(b[0], return_hidden=True), m.lm_head.weight, b[1])

    def built(rule):
        tt.manual_seed(seed)
        m = tt.materialize_module(tt.deferred_init(Llama.from_name, name, **kw),
                                  sharding_rule=rule)
        n = sum(math.prod(sharding_of(p)[1]) if sharding_of(p) else p.numel()
                for p in m.parameters())
        return m, n, 6 * n + 12 * m.cfg.n_layers * m.cfg.dim * seq

    model, n_params, fpt = built(fsdp_shard_rule(mesh))
    opt = AdamW8bit(model.parameters(), lr=FSDP_LR)
    step = ShardedTrainStep(model, opt, loss_fn, mesh, shard_axis="fsdp")
    step.init_optimizer()
    tokens = seq  # a rank's tokens a step
    trainer = tt.Trainer(step, log_every=1, log_fn=lambda _: None, tokens_per_batch=tokens,
                         flops_per_token=fpt, cost_card=True)
    # the warm-up step's update, held against the unsharded one on the same
    # gathered gradients, parameters and state
    named = list(model.named_parameters())
    captured = {}
    plain_step = opt.step

    def capture_then_step():
        with torch.no_grad():
            st = opt.adam8bit_state(dict(named))
            names = [n for n, _ in sorted(named)]
            captured["p"] = {n: gather_full(p).clone() for n, p in named}
            captured["g"] = {n: gather_full(p.grad, sharding_of(p)[0]).clone()
                             for n, p in named}
            captured["state"] = {n: {k: gather_full(getattr(st, k)[i]).clone()
                                     for k in ("m_codes", "m_scales", "v_codes", "v_scales")}
                                 for i, n in enumerate(names)}
            captured["count"] = opt.count
        return plain_step()

    opt.step = capture_then_step
    trainer.fit([batch], 1)
    opt.step = plain_step
    _sync(torch, device)
    update_differ = _placed_update_differ(torch, opt, named, captured)
    del captured
    _empty(torch, device)
    torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    trainer.fit([batch] * steps, 1 + steps)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    launches = _read_counters()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    state_bytes = opt.state_bytes()
    prof = trainer.comm_profile
    comm = {f"{e['kind']}/{e['axis']}": [e["ops"], e["payload_bytes"]]
            for e in prof.to_json()["entries"]}
    whole_bytes = sum(math.prod(sharding_of(p)[1]) * p.element_size()
                      for p in model.parameters())
    cut = [p for p in model.parameters() if sharding_of(p)[0].spec]
    # JAX's FSDP step, traced once: a gather and a reduce-scatter of each
    # cut parameter's whole bytes, a pmean of each replicated one's, the
    # loss's pmean; the 8-bit update adds nothing (every piece is whole
    # blocks)
    want = {"all_gather/fsdp": [len(cut), sum(math.prod(sharding_of(p)[1]) * p.element_size()
                                              for p in cut)],
            "reduce_scatter/fsdp": [len(cut), sum(math.prod(sharding_of(p)[1])
                                                  * p.element_size() for p in cut)]}
    repl = [p for p in model.parameters() if not sharding_of(p)[0].spec]
    pmean = [len(repl) + 1, sum(p.numel() * p.element_size() for p in repl) + 4]
    want["pmean/fsdp"] = pmean
    card = trainer.cost_card
    out = {"rank": rank, "model": name, "layers": layers, "dim": model.cfg.dim,
           "mesh": dict(mesh.shape), "global_batch": [world, seq], "tokens_a_rank": tokens,
           "n_params": n_params, "whole_param_bytes": whole_bytes,
           "losses": [float(x) for x in step.losses], "steps": steps,
           "step_ms": wall / steps * 1e3, "tokens_per_sec": tokens * steps / wall,
           "mfu": fpt * tokens * steps / wall / H100_BF16_FLOPS,
           "mfu_xla": None if card is None else span_mfu(
               card, executions=steps, seconds=wall, peak_flops=H100_BF16_FLOPS),
           "counted_flops": None if card is None else card.flops,
           "peak_memory_bytes": peak, "state_bytes": state_bytes, "launches": launches,
           "comm": comm, "comm_want": want,
           "local_updates": sum(opt.placement(p).local for p in model.parameters()),
           "placed": len(list(model.parameters()))}
    out["update_bit_equal"] = not update_differ
    out["update_differ"] = update_differ[:8]
    del trainer, step, opt, model, named
    _empty(torch, device)
    collectives.barrier()
    if rank == 0:  # world 1: the whole model over the whole batch
        m, _, _ = built(None)
        o = AdamW8bit(m.parameters(), lr=FSDP_LR)
        one = tt.TrainStep(m, o, loss_fn)
        tt.Trainer(one, log_every=1, log_fn=lambda _: None).fit([batch] * (1 + steps))
        out["world1_losses"] = [float(x) for x in one.losses]
        out["world1_state_bytes"] = o.state_bytes()
        del m, o, one
        _empty(torch, device)
    collectives.barrier()
    return out


def _placed_update_differ(torch, opt, named, captured) -> list:
    """Where a placed ``AdamW8bit``'s last update (each rank's pieces of
    the parameters, codes and scales) differs from an unsharded one's on
    the ``captured`` whole parameters, gradients and state."""
    from torchdistx_tpu_torch.optimizers import AdamW8bit

    with torch.no_grad():
        whole = {n: torch.nn.Parameter(t) for n, t in captured["p"].items()}
        ref = AdamW8bit(list(whole.values()), lr=opt.param_groups[0]["lr"])
        ref.count = captured["count"]
        for n, q in whole.items():
            q.grad = captured["g"][n]
            ref.state[q] = captured["state"][n]
        ref.step()
        differ = []
        for n, p in named:
            pl = opt.placement(p)
            if not torch.equal(p, whole[n][pl.param_sharding.shard_slices(pl.shape)]):
                differ.append((n, "param"))
            for k in ("m_codes", "m_scales", "v_codes", "v_scales"):
                if not torch.equal(opt.state[p][k], pl.piece(k, ref.state[whole[n]][k])):
                    differ.append((n, k))
    return differ


def _fsdp_vit_part(torch, seed, mesh, device, vit=FSDP_VIT):
    """``examples.vit_train`` cut to a few steps: ViT-B/16 FSDP-sharded
    over ``mesh`` through ``ShardedTrainStep`` and ``init_optimizer``."""
    from torchdistx_tpu_torch.examples import vit_train

    name, steps = vit
    v = vit_train.main(name, steps=steps, device=device, mesh=mesh, seed=seed,
                       log_fn=lambda *_: None)
    out = {"model": name, "steps": steps, "batch": vit_train.BATCH, "losses": v["losses"],
           "n_params": v["n_params"], "fake_params_vit_l16": v["fake_params"]}
    del v
    _empty(torch, device)
    return out


def _config5_sharded_runs(torch, seed, device="cuda", name="llama2_7b", seq=CONFIG5_SEQ,
                          layers=TRAIN_FSDP_LAYERS, vit=FSDP_VIT):
    """Phase 32 on one rank of ``FSDP_WORLD`` (phase 23's world): (a), (b)
    and the ViT example; returns ``{part: result}`` and the failures.  On the CPU at a tiny
    size (``name="tiny", seq=32, layers=2, vit=("tiny", 2),
    device="cpu"``) it rehearses, and the card's gates then fail, as they
    must."""
    from torchdistx_tpu_torch.parallel import create_mesh

    mesh = create_mesh({"fsdp": FSDP_WORLD})
    out, failures = {}, []
    for part, fn in (("a", lambda: _fsdp_materialize_part(torch, seed, mesh, device, name)),
                     ("b", lambda: _fsdp_train_part(torch, seed, mesh, device, name, layers,
                                                    seq)),
                     ("vit", lambda: _fsdp_vit_part(torch, seed, mesh, device, vit))):
        t0 = time.perf_counter()
        out[part] = fn()
        out[part]["seconds"] = time.perf_counter() - t0
    failures += _config5_sharded_failures(out)
    return out, failures


def _config5_sharded_failures(out):
    import math as m_

    a, b, v = out["a"], out["b"], out["vit"]
    what = f"config 5 sharded rank {b['rank']}"
    failures = []
    if a["fake_params"] != 6_738_415_616 or a["fake_bytes_held"]:
        failures.append(f"{what}: fake mode counted {a['fake_params']}, "
                        f"held {a['fake_bytes_held']} bytes")
    if a["report_total_bytes"] != a["whole_bytes"] or a["sharded_params"] != a["params"]:
        failures.append(f"{what}: materialize report {a['report_total_bytes']} bytes against "
                        f"{a['whole_bytes']}, {a['sharded_params']} of {a['params']} cut")
    if (a["held_bytes"] != a["closed_form_bytes"]
            or not 0 <= a["allocator_slack_bytes"] <= a["params"] << 20):
        failures.append(f"{what}: {a['held_bytes']} bytes held ({a['card_bytes']} allocated) "
                        f"against the closed form {a['closed_form_bytes']}")
    if a.get("pieces_equal_world1") is False:
        failures.append(f"{what}: pieces differ from world 1's: {a['pieces_differ']}")
    if a["host_rss_peak_gb"] - a["host_rss_before_gb"] >= CONFIG5_HOST_RSS_GB:
        failures.append(f"{what}: host RSS grew {a['host_rss_peak_gb'] - a['host_rss_before_gb']}")
    losses = b["losses"]
    if not all(m_.isfinite(x) for x in losses):
        failures.append(f"{what}: losses {losses}")
    per = b["layers"] * b["steps"]
    _gate(what, b["launches"], {"flash_fwd_lse": 2 * per, "flash_bwd_dkv": per,
                                "flash_bwd_dq": per, "flash_bwd_delta": per,
                                "fused_ce_fwd": b["steps"], "fused_ce_bwd": b["steps"]},
          failures)
    if b["comm"] != b["comm_want"]:
        failures.append(f"{what}: comm audit {b['comm']} against JAX's closed form "
                        f"{b['comm_want']}")
    if b["local_updates"] != b["placed"]:
        failures.append(f"{what}: {b['placed'] - b['local_updates']} parameters not updated "
                        "in place")
    if not b["update_bit_equal"]:
        failures.append(f"{what}: the placed update differs from the unsharded one: "
                        f"{b['update_differ']}")
    if "world1_losses" in b:
        w1 = b["world1_losses"]
        if any(abs(x - y) > FSDP_LOSS_RTOL * abs(y) for x, y in zip(b["losses"], w1)):
            failures.append(f"{what}: losses {b['losses']} against world 1's {w1}")
        if b["state_bytes"] * FSDP_WORLD != b["world1_state_bytes"]:
            failures.append(f"{what}: 8-bit state {b['state_bytes']} bytes a rank against "
                            f"world 1's {b['world1_state_bytes']}")
    if not b["mfu_xla"] or not b["counted_flops"]:
        failures.append(f"{what}: counted card {b['counted_flops']}, mfu_xla {b['mfu_xla']}")
    if len(v["losses"]) != v["steps"] or not all(m_.isfinite(x) for x in v["losses"]):
        failures.append(f"{what}: vit_train losses {v['losses']}")
    return failures


def _vision_runs(torch, seed):
    """Phases 27-28 in phase 25's spawned process: ``_vision_run`` of each
    of VISION_RUNS in turn, ``{name: result}``."""
    out = {}
    for phase, name, batch in VISION_RUNS:
        t0 = time.perf_counter()
        out[name] = _vision_run(torch, name, batch, seed + phase)
        out[name].update(phase=phase, phase_s=time.perf_counter() - t0)
    return out


def _vision_run(torch, name, batch, seed):
    """One of phases 27-28: ``name`` (resnet50: BASELINE config 2) through
    ``build_vision_train_workload`` in f32
    (deferred init, materialize on the card), its eval forward at
    VISION_EVAL_BATCH against the same weights on the CPU; then in bf16 at
    ``batch`` images of 224 x 224, VISION_WARMUP steps, VISION_STEPS timed
    ``Trainer.fit`` steps with the launch counters set to 0 just before
    and read just after, and ``torch.profiler`` over VISION_PROFILE_STEPS
    more."""
    from torchdistx_tpu_torch import is_fake
    from torchdistx_tpu_torch.utils.benchmarks import build_vision_train_workload

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.init()
    w = build_vision_train_workload(name, batch=VISION_EVAL_BATCH, dtype=torch.float32,
                                    device="cuda", seed=seed)
    model = w["model"]
    info = {k: w[k] for k in ("deferred_init_s", "materialize_s", "host_rss_before_gb",
                              "peak_host_rss_gb", "host_rss_delta_gb", "card_bytes_deferred",
                              "card_bytes_materialized", "n_params", "flops_per_token",
                              "image_size", "num_classes")}
    info.update(model=name, all_on_card_f32=all(
        t.is_cuda and t.dtype == torch.float32 and not is_fake(t)
        for t in (*model.parameters(), *model.buffers())))
    images = w["batch"][0]
    with torch.no_grad():
        card = model.eval()(images).cpu()
        ref = model.cpu()(images.cpu())
    scale = ref.abs().max().item()
    info["eval"] = {"batch": VISION_EVAL_BATCH, "dtype": "f32", "tf32": False,
                    "max_abs_err": (card - ref).abs().max().item(), "ref_max_abs": scale,
                    "rel_err": (card - ref).abs().max().item() / scale,
                    "rtol": VISION_EVAL_RTOL, "finite": bool(torch.isfinite(card).all())}
    del w, model, card, ref
    torch.cuda.empty_cache()

    w = build_vision_train_workload(name, batch=batch, dtype=torch.bfloat16, device="cuda",
                                    seed=seed)
    # the same build again, warm: what the first one's seconds owe to the
    # process's first deferred op
    info.update(bf16_deferred_init_s=w["deferred_init_s"], bf16_materialize_s=w["materialize_s"])
    buffers = [b.clone() for b in w["model"].buffers()]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    info["warmup_losses"] = w["run"](VISION_WARMUP)
    torch.cuda.synchronize()
    info["warmup_s"] = time.perf_counter() - t0
    _reset_counters()
    t0 = time.perf_counter()
    info["losses"] = w["run"](VISION_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    info["launches"] = _read_counters()
    images_per_s = w["batch_size"] * VISION_STEPS / wall
    info.update(dtype="bf16", batch=batch, steps=VISION_STEPS, warmup_steps=VISION_WARMUP,
                step_ms=wall / VISION_STEPS * 1e3, images_per_sec=images_per_s,
                mfu=w["flops_per_token"] * images_per_s / H100_BF16_FLOPS,
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                peak_reserved_bytes=torch.cuda.max_memory_reserved(),
                buffers_unchanged=all(torch.equal(a, b)
                                      for a, b in zip(buffers, w["model"].buffers())))

    def drive(on_step):
        w["trainer"].log_fn = on_step  # called after each synchronized step
        w["run"](VISION_PROFILE_STEPS + 1)

    info["profile"] = _profile(torch, drive, VISION_PROFILE_STEPS)
    return info


def _vision_failures(r):
    import math

    name = r["model"]
    failures = []
    losses = r["warmup_losses"] + r["losses"]
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"{name} losses not finite: {losses}")
    if not r["host_rss_delta_gb"] < CONFIG5_HOST_RSS_GB:
        failures.append(f"{name} host RSS grew {r['host_rss_delta_gb']} GB")
    if r["n_params"] != VISION_PARAMS[name] or not r["all_on_card_f32"]:
        failures.append(f"{name} parameters: {r['n_params']}, "
                        f"on the card in f32: {r['all_on_card_f32']}")
    if r["card_bytes_deferred"] >= 1 << 20:
        failures.append(f"{name} deferred init allocated {r['card_bytes_deferred']} bytes")
    ev = r["eval"]
    if not (ev["finite"] and ev["rel_err"] <= VISION_EVAL_RTOL):
        failures.append(f"{name} eval forward on the card vs the CPU: {ev}")
    if not r["buffers_unchanged"]:
        failures.append(f"{name}: a training step wrote the BatchNorm running statistics")
    # no Pallas kernel lies on this path in the JAX package (XLA's
    # convolutions, the jnp attention): no port kernel may launch
    launched = {k: n for k, n in r["launches"].items() if n}
    if launched:
        failures.append(f"{name} launched the port's kernels: {launched}")
    return failures


def vision_failures(result):
    """Phases 27-28's checks of ``_vision_runs``'s result."""
    if "error" in result:
        return [f"phases 27-28 raised:\n{result['error']}"]
    return [f for _, name, _ in VISION_RUNS for f in _vision_failures(result[name])]


def _snapshot(torch, model, opt):
    return ([p.detach().clone() for p in model.parameters()],
            [{k: v.clone() for k, v in opt.state[p].items()} for p in model.parameters()],
            opt.count)


def _same_snapshot(torch, a, b):
    (pa, sa, ca), (pb, sb, cb) = a, b
    return ca == cb and all(torch.equal(x, y) for x, y in zip(pa, pb)) and all(
        x.keys() == y.keys() and all(x[k].dtype == y[k].dtype and torch.equal(x[k], y[k])
                                     for k in x) for x, y in zip(sa, sb))


def checkpoint_and_failure(torch, seed, name="llama_1b", n_layers=CKPT_LAYERS, batch=2,
                           seq=2048, device="cuda"):
    """Phase 26 on llama_1b at full width and ``n_layers`` layers with the
    8-bit AdamW and the fused loss: (a) ``Trainer.fit`` to step 4 with a
    checkpoint every 2 steps, ``restore`` of step 2, on to step 4 again;
    (b) a fresh ``Trainer`` with a ``FailureDetector`` and
    ``on_failure="restore"`` whose loss is made non-finite at step 3."""
    import itertools
    import math
    import shutil
    import tempfile

    from torchdistx_tpu_torch.trainer import Trainer, TrainStep
    from torchdistx_tpu_torch.utils.benchmarks import build_train_workload
    from torchdistx_tpu_torch.utils.failure import FailureDetector

    failures = []
    tmp = tempfile.mkdtemp(prefix="tdx_ckpt_")
    try:
        w = build_train_workload(name, batch=batch, seq=seq, n_layers=n_layers,
                                 optimizer="adamw_8bit", fused_ce=True, device=device,
                                 seed=seed)
        model, opt, tr = w["model"], w["optimizer"], w["trainer"]
        tr.checkpoint_dir, tr.checkpoint_every = os.path.join(tmp, "run"), 2
        _reset_counters()
        first = w["run"](2)
        saved = _snapshot(torch, model, opt)
        first += w["run"](2)
        launches = _read_counters()
        saves = tr.metrics["checkpoints_total"]
        t0 = time.perf_counter()
        tr.restore(os.path.join(tmp, "run", "step_2"))
        if device == "cuda":
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restored_bitwise = _same_snapshot(torch, _snapshot(torch, model, opt), saved)
        del saved
        resumed = w["run"](2)
        resume_err = max(abs(a - b) for a, b in zip(resumed, first[2:]))
        info = {"model": name, "layers": n_layers, "n_params": w["n_params"],
                "optimizer": "adamw_8bit", "losses": first, "resumed_losses": resumed,
                "resume_max_abs_err": resume_err, "resume_bitwise": resumed == first[2:],
                "restored_bitwise": restored_bitwise, "restore_s": restore_s,
                "checkpoints_total": saves,
                "checkpoint_bytes": os.path.getsize(
                    os.path.join(tmp, "run", "step_2", "state.pt")),
                "launches": launches}
        if not restored_bitwise:
            failures.append("checkpoint: restored parameters or codes differ from the saved")
        if not resume_err <= CKPT_LOSS_ATOL:
            failures.append(f"checkpoint: resumed losses {resumed} vs {first[2:]}")
        if tr.global_step != 4 or saves != 2:
            failures.append(f"checkpoint: step {tr.global_step}, {saves} checkpoints")

        calls = itertools.count(1)

        class NanAtStep3(TrainStep):
            def __call__(self, params, opt_state, batch):
                params, opt_state, loss = super().__call__(params, opt_state, batch)
                return params, opt_state, loss * float("nan") if next(calls) == 3 else loss

        logs = []
        tr2 = Trainer(NanAtStep3(model, opt, w["step"].loss_fn), log_every=1,
                      log_fn=logs.append, checkpoint_dir=os.path.join(tmp, "nan"),
                      checkpoint_every=2, failure_detector=FailureDetector(),
                      on_failure="restore")
        tr2.fit(itertools.repeat(w["batch"]), 4)
        shape = [(m["step"], "failure" if "failure" in m else "loss") for m in logs]
        failure_records = [m for m in logs if "failure" in m]
        info["rollback"] = {"log": logs, "global_step": tr2.global_step,
                            "failures_total": tr2.metrics["failures_total"],
                            "checkpoints_total": tr2.metrics["checkpoints_total"]}
        expect = {"step": 3, "failure": "nonfinite", "action": "restored", "resumed_from": 2}
        if (shape != [(2, "loss"), (3, "failure"), (3, "loss"), (4, "loss")]
                or failure_records != [expect] or tr2.global_step != 4
                or tr2.metrics["failures_total"] != 1
                or tr2.metrics["checkpoints_total"] != 2
                or not all(math.isfinite(m["loss"]) for m in logs if "loss" in m)):
            failures.append(f"failure policy: {info['rollback']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return info, failures


# -- phase 29: chunked prefill, the HBM gate, the fleet, the autoscaler ----------
# All on phase 3's full-width llama3_8b (random weights from the seed), the
# engines of a part sharing its weights; explicit short bucket lists keep a
# fleet replica's warm-up (two throwaway generations a bucket) cheap.
FLEET_SLOTS, FLEET_MAX_LEN = 8, 2048
FLEET_BUCKETS = (64, 512, 2048)
CHUNK = 512
# (a) the long prompt's last-position logits, chunked (first chunk through
# the flash kernel, the later ones mid-cache on the plain path) against one
# unchunked prefill (all flash): ||chunked - flash|| / ||flash|| in f32
# within CHUNK_LOGITS_RTOL (bf16: 8 significant bits a value, rounded at
# other places by the two attention paths over 32 layers), or no further
# than LOGITS_FACTOR times the plain path's own distance from the flash one
CHUNK_LOGITS_RTOL = 2e-2
# (a) 4 short requests decoding (48 new tokens), then 4 long prompts and 4
# more short ones (16 new); the engines persistent with an 8-row ring, so
# each interleaved dispatch is one ring of the loop's captured graph
CHUNK_LONG, CHUNK_SHORT, CHUNK_NEW, CHUNK_FIRST_NEW, CHUNK_RING = 4, 8, 16, 48, 8
# (c) a catalog scenario's first requests, in waves by arrival tick, greedy;
# persistent engines (the affinity replicas with a 16-row ring, so a replica
# removed in the last wave still holds running requests)
# (32 new tokens, 64 before phase 23 (j): still past the ring)
FLEET_SCENARIO, FLEET_REQUESTS, FLEET_NEW, FLEET_RING = "diurnal", 16, 32, 16
# (e) the autoscaler on a cut flash crowd, replicas of 2 slots x 256 rows,
# persistent with a 4-row ring (a scheduler tick decodes at most 4 tokens)
AUTOSCALE_POLICY = dict(min_replicas=1, max_replicas=3, windows=(2, 4), up_threshold=0.9,
                        up_sustain=2, down_sustain=4, up_cooldown=2, down_cooldown=4)
AUTOSCALE_SPEC = dict(horizon_ticks=20, flash_tick=4, flash_len=5, output_lens=(4, 6))
FLEET_LAUNCH_KEYS = ("flash_fwd", "decode_attention", "paged_decode_attention",
                     "decode_attention_block", "paged_decode_attention_block")


def _add_launches(total, got):
    for k in FLEET_LAUNCH_KEYS:
        total[k] = total.get(k, 0) + got.get(k, 0)


def _cold_prefills(requests):
    """Prefills whose first (or only) dispatch ran from cache position 0:
    the flash kernel's, one launch a layer each."""
    return sum(1 for r in requests for name, _, data in r.events
               if name == "prefill" and data.get("cold"))


def _ttft_p50(results):
    import numpy as np

    ttft = [r.ttft_s for r in results if r.ttft_s is not None]
    return float(np.median(ttft)) if ttft else None


def _first_divergence(a, b):
    """The first token index where two streams differ (None when equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def chunk_requests(rng, vocab, n_long=CHUNK_LONG, n_short=CHUNK_SHORT):
    def mk(n, new):
        return {"prompt": rng.randint(0, vocab, size=int(n)).astype("int32"),
                "max_new_tokens": new}

    shorts = [mk(n, CHUNK_FIRST_NEW if i < n_short // 2 else CHUNK_NEW)
              for i, n in enumerate(rng.randint(16, 65, size=n_short))]
    longs = [mk(n, CHUNK_NEW) for n in rng.randint(1200, 1537, size=n_long)]
    return shorts, longs


def _chunked_run(torch, engine, shorts, longs):
    """Half the shorts first, two steps, then the long prompts (chunked
    while those shorts decode) and the other shorts; the launch counters
    set to 0 just before."""
    half = len(shorts) // 2
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    handles = [engine.submit(**r) for r in shorts[:half]]
    engine.step()
    engine.step()
    handles += [engine.submit(**r) for r in longs + shorts[half:]]
    while engine.step():
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [h.result() for h in handles], _read_counters(), wall


def chunked_prefill_logits(torch, model, prompt, chunk=CHUNK):
    """The long prompt's last-position logits three ways: one cold prefill
    (flash), the chunked path (the first chunk cold, the later ones
    mid-cache), one cold prefill on the plain path.  Returns the verdict."""
    ids = torch.as_tensor(prompt, device=model.device)[None].long()
    n = ids.shape[1]
    with torch.no_grad():
        flash, _ = model.forward_cached(ids, model.init_cache(1, n), 0)
        cache = model.init_cache(1, n)
        for start in range(0, n, chunk):
            logits, cache = model.forward_cached(ids[:, start:start + chunk], cache, start)
        saved = model.cfg.use_flash
        model.cfg.use_flash = False
        try:
            plain, _ = model.forward_cached(ids, model.init_cache(1, n), 0)
        finally:
            model.cfg.use_flash = saved
    ref = flash[0, -1].float()

    def rel(x):
        return float((x[0, -1].float() - ref).norm() / ref.norm())

    chunk_err, plain_err = rel(logits), rel(plain)
    finite = bool(torch.isfinite(logits).all())
    ok = finite and chunk_err <= max(CHUNK_LOGITS_RTOL, LOGITS_FACTOR * plain_err)
    return ok, {"prompt": n, "chunk": chunk, "chunked_vs_flash_rel": chunk_err,
                "plain_vs_flash_rel": plain_err, "rtol": CHUNK_LOGITS_RTOL,
                "argmax_equal": bool(torch.argmax(logits[0, -1]) == torch.argmax(ref)),
                "finite": finite}


def chunked_part(torch, model, rng, launches):
    """(a) chunked prefill at 8 slots x 2048, slab and paged (prefix cache
    on), 512-token chunks; its streams beside an unchunked engine's."""
    import numpy as np
    from torchdistx_tpu_torch.serve import ServeEngine

    n_layers, vocab = model.cfg.n_layers, model.cfg.vocab_size
    shorts, longs = chunk_requests(rng, vocab)
    half = len(shorts) // 2
    reqs = shorts[:half] + longs + shorts[half:]  # in submission order
    failures, out, engines = [], {}, {}
    base = dict(num_slots=FLEET_SLOTS, max_len=FLEET_MAX_LEN, prefill_buckets=FLEET_BUCKETS,
                decode_mode="persistent", ring_capacity=CHUNK_RING)
    plain = ServeEngine(model, **base)
    ref, _, _ = _chunked_run(torch, plain, shorts, longs)
    errors = plain.cost_card_errors
    del plain
    for layout, kw in (("slab", {}), ("paged", {"page_size": 16})):
        engine = ServeEngine(model, chunked_prefill=CHUNK, **base, **kw)
        results, got, wall = _chunked_run(torch, engine, shorts, longs)
        _add_launches(launches, got)
        c = engine.metrics.counters
        cold = _cold_prefills(results)
        key = "paged_decode_attention" if kw else "decode_attention"
        want = {"flash_fwd": n_layers * cold, key: n_layers * c["decode_steps"]}
        failures += [f"(a) {layout}: {k} launches {got.get(k, 0)} != {v}"
                     for k, v in want.items() if got.get(k, 0) != v]
        failures += _greedy_failures(f"(a) {layout}", reqs, results, vocab)
        if c["chunked_prefills"] != len(longs):
            failures.append(f"(a) {layout}: {c['chunked_prefills']} chunked prefills")
        if not c["prefill_interleaved_dispatches"] > 0:
            failures.append(f"(a) {layout}: no decode dispatch between chunks")
        if engine.plain_prefill_chunks != c["prefill_chunks"] - c["chunked_prefills"]:
            failures.append(f"(a) {layout}: {engine.plain_prefill_chunks} mid-cache chunks")
        equal = [bool(np.array_equal(np.asarray(a.tokens), np.asarray(b.tokens)))
                 for a, b in zip(results, ref)]
        firsts = [_first_divergence(np.asarray(a.tokens).tolist(),
                                    np.asarray(b.tokens).tolist())
                  for a, b in zip(results, ref)]
        out[layout] = {
            "requests": len(reqs), "long_prompts": [len(r["prompt"]) for r in longs],
            "wall_s": wall, "tokens_per_sec": c["tokens_generated"] / wall,
            "ttft_p50_s": _ttft_p50(results), "cold_prefills": cold,
            "plain_prefill_chunks": engine.plain_prefill_chunks,
            "launches": {k: got.get(k, 0) for k in ("flash_fwd", key)},
            "counters": {k: c[k] for k in ("chunked_prefills", "prefill_chunks",
                                           "prefill_interleaved_dispatches",
                                           "tokens_prefilled", "decode_steps",
                                           "prefix_hit_tokens")},
            "streams_equal_unchunked_share": sum(equal) / len(equal),
            "first_divergent_token": firsts,
        }
        print(f"(a) chunked prefill {layout}", json.dumps(out[layout]))
        if layout == "slab":  # the paged engine's go on into (b)
            errors += engine.cost_card_errors
        engines[layout] = engine
    ok, info = chunked_prefill_logits(torch, model, longs[0]["prompt"])
    print("(a) chunked prefill logits", json.dumps(info))
    if not ok:
        failures.append(f"(a) chunked logits: {info}")
    out["logits"] = info
    return out, failures, engines["paged"], errors


def hbm_part(torch, model, engine, rng):
    """(b) the memory plan of (a)'s paged engine and the HBM gate."""
    failures = []
    plan = engine.memory_plan()
    comps = plan["components"]
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    if comps["weights"] != weights:
        failures.append(f"(b) weights {comps['weights']} != {weights}")
    if comps["kv_cache"] != engine.cache.kv_data_nbytes:
        failures.append(f"(b) kv_cache {comps['kv_cache']} != {engine.cache.kv_data_nbytes}")
    if not comps.get("program_temp", 0) > 0:
        failures.append(f"(b) no program_temp from the cost cards: {comps}")
    footprint = plan["projected_peak_bytes"]
    engine.hbm_budget = footprint - 1
    h = engine.submit(rng.randint(0, model.cfg.vocab_size, size=40).astype("int32"),
                      max_new_tokens=4)
    engine.step()
    gated = [d for name, _, d in h._request.events if name == "gated"]
    refused = engine.metrics.counters["admissions_rejected_hbm"]
    if not gated or gated[-1]["why"] != "hbm_budget" or refused < 1:
        failures.append(f"(b) not refused by name: {gated}, {refused}")
    engine.hbm_budget = footprint
    engine.step()
    admitted = any(name == "admitted" for name, _, _ in h._request.events)
    if not admitted:
        failures.append("(b) not admitted after the budget rose")
    while engine.step():
        pass
    cards = engine.cost_book.cards()
    out = {"components": comps, "budget_source": plan["budget_source"],
           "card_budget_bytes": plan["budget_bytes"], "refused_why": gated[-1]["why"]
           if gated else None, "admissions_rejected_hbm": refused,
           "admitted_after_raise": admitted, "finish": h.result().finish_reason,
           "cards": {k: {"temp_bytes": c.temp_bytes, "peak_bytes": c.peak_bytes,
                         "peak_source": c.peak_source} for k, c in sorted(cards.items())},
           "cost_card_errors": engine.cost_card_errors}
    print("(b) hbm gate", json.dumps(out))
    return out, failures


def fleet_requests(model):
    """The catalog scenario's first requests, greedy, FLEET_NEW new tokens
    each; vocabulary ids as the scenario draws them (< 256)."""
    from torchdistx_tpu_torch.serve import generate, scenario

    work = generate(scenario(FLEET_SCENARIO))[:FLEET_REQUESTS]
    return [(r.arrival_tick, dict(r.submit_kwargs(), max_new_tokens=FLEET_NEW))
            for r in work]


def run_waves(torch, target, work, launches, on_last_wave=None):
    """Submit the requests of one arrival tick, step until they are done,
    then the next tick's: each request's prefix hit is then decided by the
    earlier waves alone, in one engine and in a fleet alike.  Returns
    (handles, wall, launches)."""
    ticks = sorted({t for t, _ in work})
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    handles = []
    for i, t in enumerate(ticks):
        wave = [target.submit(**kw) for tick, kw in work if tick == t]
        handles += wave
        target.step()
        if on_last_wave is not None and i == len(ticks) - 1:
            on_last_wave()
        while not all(h.done() for h in wave):
            target.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _read_counters()
    _add_launches(launches, got)
    return handles, wall, got


def _fleet_line(what, handles, wall, got, counters, **extra):
    reqs = [h.result() for h in handles if h.done()]
    out = {"requests": len(handles), "wall_s": wall,
           "tokens_per_sec": sum(len(r.tokens) for r in reqs) / wall,
           "ttft_p50_s": _ttft_p50(reqs),
           "launches": {k: got.get(k, 0) for k in FLEET_LAUNCH_KEYS if got.get(k, 0)},
           "counters": {k: counters.get(k, 0) for k in (
               "prefill_calls", "prefix_hit_tokens", "decode_steps", "tokens_generated",
               "requests_handed_off", "handoff_pages_moved", "handoff_wire_bytes",
               "requests_migrated_out", "migration_wire_bytes", "loop_iterations")},
           **extra}
    print(what, json.dumps(out))
    return out


def fleet_part(torch, model, launches, record_dir=None):
    """(c) the fleet, every engine paged with the prefix cache, 8 slots x
    2048: three persistent replicas behind the affinity router, the
    busiest removed in the last wave; a warmed replica added; then one
    prefill replica and two persistent decode replicas.  Every stream of
    the scenario against one engine of equal geometry.  With
    ``record_dir`` the disaggregated fleet records its session there
    (``fleet.jsonl``, replayed by phase 30 (d)); the one engine's streams
    and counters are kept in the report for phase 30."""
    import numpy as np
    from torchdistx_tpu_torch.serve import LeastLoadedPolicy, ServeEngine, ServeFleet

    failures, out = [], {}
    kw = dict(num_slots=FLEET_SLOTS, max_len=FLEET_MAX_LEN, prefill_buckets=FLEET_BUCKETS,
              page_size=16, prefix_cache=True)
    loop = dict(kw, decode_mode="persistent")
    ring = dict(loop, ring_capacity=FLEET_RING)
    work = fleet_requests(model)
    single = ServeEngine(model, **loop)
    ref_h, wall, got = run_waves(torch, single, work, launches)
    ref = [np.asarray(h.result().tokens).tolist() for h in ref_h]
    out["single"] = _fleet_line("(c) one engine", ref_h, wall, got, single.metrics.counters)
    out["single_streams"], out["single_counters"] = ref, dict(single.metrics.counters)
    errors = single.cost_card_errors
    del single

    def streams(handles):
        return [np.asarray(h.result().tokens).tolist() for h in handles]

    def check(what, handles):
        got_s = streams(handles)
        if not all(h.done() for h in handles):
            failures.append(f"{what}: a request was dropped")
        if got_s != ref:
            failures.append(f"{what}: streams differ from one engine's at "
                            f"{[_first_divergence(a, b) for a, b in zip(got_s, ref)]}")
        return got_s == ref

    # -- affinity, three replicas, one removed mid-run ---------------------------
    fleet = ServeFleet([ServeEngine(model, **ring) for _ in range(3)], policy="affinity")
    removed = {}

    def remove_busiest():
        busy = max(fleet.replicas, key=lambda r: len(r.engine.scheduler.running))
        removed.update(fleet.remove(busy.rid))
        removed["cost_card_errors"] = busy.engine.cost_card_errors

    handles, wall, got = run_waves(torch, fleet, work, launches, on_last_wave=remove_busiest)
    j = fleet.metrics_json()
    routed = [d["replica"] for name, _, d in fleet.events if name == "routed"]
    eq = check("(c) affinity fleet", handles)
    if not removed.get("migrated_running"):
        failures.append(f"(c) remove moved no running request: {removed}")
    out["affinity"] = _fleet_line(
        "(c) fleet affinity", handles, wall, got, j["counters"], streams_equal=eq,
        routed=routed, removed={k: removed.get(k) for k in (
            "replica", "to", "migrated_running", "migrated_queued", "pages_moved",
            "wire_bytes")})

    errors += removed.get("cost_card_errors", 0)

    # -- a warmed replica added: routed traffic sets up no program ------------
    # (least-loaded for this wave: affinity sends every group to the warm
    # replicas, and the new one should take traffic)
    new = ServeEngine(model, **ring)
    rid = fleet.add(new)
    fleet.policy = LeastLoadedPolicy()
    warm = [d for name, _, d in fleet.events if name == "add"][-1]["warm"]
    programs = {r.rid: r.engine.num_compiled_programs() for r in fleet.replicas}
    more = [(t, dict(k, seed=k["seed"] + 100)) for t, k in work[:6]]
    n_events = len(fleet.events)
    handles2, wall2, got2 = run_waves(torch, fleet, more, launches)
    after = {r.rid: r.engine.num_compiled_programs() for r in fleet.replicas}
    if after != programs:
        failures.append(f"(c) add: programs {programs} -> {after} under routed traffic")
    if not all(h.done() for h in handles2):
        failures.append("(c) add: a request was dropped")
    out["add"] = _fleet_line("(c) fleet add", handles2, wall2, got2,
                             fleet.metrics_json()["counters"], replica=rid, warm=warm,
                             programs=after, routed_to_new=sum(
                                 1 for name, _, d in fleet.events[n_events:]
                                 if name == "routed" and d["replica"] == rid))
    errors += sum(r.engine.cost_card_errors for r in fleet.replicas)
    del fleet, new

    # -- disaggregated: one prefill (chunked mode), two persistent decode -------
    pre = ServeEngine(model, **kw)
    dec_p = ServeEngine(model, **loop)
    dec_c = ServeEngine(model, **ring)
    record = None
    if record_dir is not None:
        from torchdistx_tpu_torch.obs.blackbox import SessionRecorder

        record = SessionRecorder(os.path.join(record_dir, "fleet.jsonl"), enabled=True)
        record.record("model_spec", family="llama", name="llama3_8b", dtype="bfloat16")
    fleet = ServeFleet([pre, dec_p, dec_c], disaggregate=True,
                       roles=["prefill", "decode", "decode"], record=record)
    handles, wall, got = run_waves(torch, fleet, work, launches)
    handoffs = [d for name, _, d in fleet.events if name == "handoff"]
    eq = check("(c) disaggregated fleet", handles)
    if len(handoffs) != len(work):
        failures.append(f"(c) {len(handoffs)} handoffs for {len(work)} requests")
    bad = [h for h in handoffs if not (h["pages_moved"] > 0 and h["wire_bytes"] == 0)]
    if bad:
        failures.append(f"(c) handoffs moving no pages or booking wire: {bad[:2]}")
    loop = dec_p._decode.loop
    graph = {"captures": loop.captures if loop else 0, "replays": dec_p.loop_replays,
             "loop_iterations": dec_p.metrics.counters["loop_iterations"],
             "handed_in": dec_p.metrics.counters["requests_handed_in"]}
    if graph["captures"] != 1 or graph["replays"] != graph["loop_iterations"] \
            or not graph["handed_in"]:
        failures.append(f"(c) persistent decode target: {graph}")
    out["disaggregated"] = _fleet_line(
        "(c) fleet disaggregated", handles, wall, got, fleet.metrics_json()["counters"],
        streams_equal=eq, handoffs=len(handoffs),
        pages_moved=[h["pages_moved"] for h in handoffs],
        wire_bytes=sum(h["wire_bytes"] for h in handoffs), persistent_target=graph)
    if record is not None:
        record.close()
        out["disaggregated"]["streams"] = [np.asarray(h.result().tokens).tolist()
                                           for h in handles]
    errors += sum(e.cost_card_errors for e in (pre, dec_p, dec_c))
    del fleet, pre, dec_p, dec_c
    return out, failures, errors


def migrate_part(torch, model, launches):
    """(d) ``migrate_to`` an engine with fewer slots: the share of streams
    equal to an undrained run (a 5-slot decode batch is another cuBLAS
    shape; printed, not gated) and no drop.  Persistent engines, the
    source's ring 8 rows deep, so the requests move mid-stream."""
    import numpy as np
    from torchdistx_tpu_torch.serve import ServeEngine

    kw = dict(max_len=FLEET_MAX_LEN, prefill_buckets=FLEET_BUCKETS,
              decode_mode="persistent")
    src_kw = dict(kw, num_slots=FLEET_SLOTS, ring_capacity=CHUNK_RING)
    work = [k for _, k in fleet_requests(model)[:5]]
    ref = [np.asarray(r.tokens).tolist() for r in ServeEngine(model, **src_kw).run(work)]
    src = ServeEngine(model, **src_kw)
    dst = ServeEngine(model, num_slots=5, **kw)
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    handles = [src.submit(**k) for k in work]
    for _ in range(3):
        src.step()
    summary = src.migrate_to(dst)
    while dst.step():
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _read_counters()
    _add_launches(launches, got)
    streams = [np.asarray(h.result().tokens).tolist() for h in handles]
    firsts = [_first_divergence(a, b) for a, b in zip(streams, ref)]
    both = {k: v + dst.metrics.counters[k] for k, v in src.metrics.counters.items()}
    out = _fleet_line("(d) migrate 8 -> 5 slots", handles, wall, got, both,
                      summary=summary,
                      streams_equal_share=sum(f is None for f in firsts) / len(firsts),
                      first_divergent_token=firsts)
    failures = []
    if not all(h.done() for h in handles) or summary["migrated_running"] != len(work):
        failures.append(f"(d) migration dropped or kept requests: {summary}")
    return out, failures, src.cost_card_errors + dst.cost_card_errors


def _autoscale_run(torch, model, spec, launches):
    from torchdistx_tpu_torch.serve import (AutoscaleController, ScalingPolicy,
                                            ServeEngine, ServeFleet, generate)

    made = []

    def factory(role):
        made.append(ServeEngine(model, num_slots=2, max_len=256, prefill_buckets=(64,),
                                page_size=16, decode_mode="persistent", ring_capacity=4))
        return made[-1]

    work = generate(spec)
    fleet = ServeFleet([factory("serve")])
    ctrl = AutoscaleController(fleet, ScalingPolicy(**AUTOSCALE_POLICY),
                               engine_factory=factory, flight=False)
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    handles, decisions, k = [], [], 0
    for tick in range(spec.horizon_ticks + 40):
        while k < len(work) and work[k].arrival_tick == tick:
            handles.append(fleet.submit(**work[k].submit_kwargs()))
            k += 1
        fleet.step()
        d = ctrl.tick()
        decisions.append((d["tick"], d["action"], d["mode"], d["replica"], d["reason"],
                          d["replicas_after"], d["signal"]["pressure"]))
        if k == len(work) and all(h.done() for h in handles):
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _read_counters()
    _add_launches(launches, got)
    streams = [h.result().tokens.tolist() if h.done() else None for h in handles]
    errors = sum(e.cost_card_errors for e in made)
    return decisions, streams, dict(ctrl.counters), handles, wall, got, fleet, errors


def autoscale_part(torch, model, launches):
    """(e) ``AutoscaleController`` with ``LoadSignal`` over a seeded flash
    crowd, twice: the decision streams identical, no request dropped."""
    from torchdistx_tpu_torch.serve import scenario

    spec = scenario("flash_crowd", **AUTOSCALE_SPEC)
    runs = [_autoscale_run(torch, model, spec, launches) for _ in range(2)]
    failures = []
    (d1, s1, c1, h1, w1, g1, f1, e1), (d2, s2, c2, *_rest, e2) = runs
    if d1 != d2:
        first = next(i for i, (a, b) in enumerate(zip(d1, d2)) if a != b)
        failures.append(f"(e) decisions differ at tick {d1[first][0]}: {d1[first]} vs {d2[first]}")
    if None in s1 or None in s2:
        failures.append("(e) a request was dropped")
    if not c1["autoscale_scale_ups"]:
        failures.append(f"(e) the flash crowd scaled nothing up: {c1}")
    out = _fleet_line("(e) autoscale flash_crowd", h1, w1, g1,
                      f1.metrics_json()["counters"], decisions=len(d1),
                      decisions_identical=d1 == d2, streams_identical=s1 == s2,
                      controller=c1, actions=[d[:4] for d in d1 if d[1] != "hold"])
    return out, failures, e1 + e2


def serve_fleet_phase(torch, model, seed, record_dir=None):
    """Phase 29 on phase 3's model: (a)-(e), each fatal.  Returns (report,
    failures, launches), the launches of rows 1, 9-12 summed over every run
    of the phase (the counters set to 0 just before each run).  With
    ``record_dir``, (c)'s disaggregated fleet records its session there."""
    import numpy as np

    rng = np.random.RandomState(seed)
    launches, report, failures = {}, {}, []
    t0 = time.perf_counter()
    report["a"], f, paged, errors = chunked_part(torch, model, rng, launches)
    failures += f
    report["b"], f = hbm_part(torch, model, paged, rng)
    failures += f
    errors += paged.cost_card_errors
    del paged
    torch.cuda.empty_cache()
    report["c"], f, e = fleet_part(torch, model, launches, record_dir)
    failures += f
    errors += e
    torch.cuda.empty_cache()
    report["d"], f, e = migrate_part(torch, model, launches)
    failures += f
    errors += e
    report["e"], f, e = autoscale_part(torch, model, launches)
    failures += f
    errors += e
    torch.cuda.empty_cache()
    if errors:
        failures.append(f"phase 29: {errors} cost-card probes failed")
    report["cost_card_errors"] = errors
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t0
    print("serve fleet launches", json.dumps({"launches": launches,
                                              "seconds": report["seconds"]}))
    return report, [f"phase 29 {x}" for x in failures], launches


# -- phase 30: GPT-2 and T5 on the card, the streamed tail, the black box -------
# (a) gpt2_large at full width and depth (36 layers, dim 1280, 20 heads of 64:
# Hq = Hkv, group size 1), bf16, 8 slots x 1024, 16 requests of 16-768 prompt
# tokens, 32 new tokens (64 before phase 23 (j)), 12 greedy and 4 sampled
GPT2_SERVE, GPT2_PARAMS = "gpt2_large", 774_030_080
GPT2_SLOTS, GPT2_MAX_LEN, GPT2_PROMPTS, GPT2_NEW = 8, 1024, (16, 768), 32
GPT2_LOGITS_PROMPT = 768
# decode steps a dispatch of (a)'s fused multi-step chunked run
GPT2_DECODE_CHUNK = 8
# (c)'s stream cost: replays of each captured iteration a timed block, and
# blocks each, alternating with and without the stream
STREAM_COST_REPLAYS, STREAM_COST_ROUNDS = 20, 4  # 6 rounds before the 600 s cut
# the decode variants' slot depths at GPT-2's geometry (page 16): 0, page
# boundaries +-1, max_len - 1; with S = 5 the last slots' rows run past it
GPT2_VARIANT_POSITIONS = {1: [0, 15, 16, 17, 511, 512, 800, 1023],
                          5: [0, 12, 15, 508, 512, 900, 1020, 1023]}
# (b) T5-3B at full depth (24 + 24 layers), bf16, B 4 x 512 encoder tokens,
# 32 new tokens, in the materialized-bias and the bucket-table modes
T5_GEN, T5_GEN_BATCH, T5_GEN_SEQ, T5_GEN_NEW = "t5_3b", 4, 512, 32
# (e) phase 26's llama_1b (full width, CKPT_LAYERS layers, 8-bit AdamW, fused
# loss, 2 x 2048), TRAINER_STEPS steps with the Trainer's telemetry on and off
TRAINER_STEPS = 3
TRAINER_STALL_S = 600.0
# the "on" run's counted cost card (taken on its first step): analytic /
# counted FLOPs from the two formulas, PERF.md section 6.  A token counts
# 6 N + 12 L dim seq analytically; the card counts 6 a weight of the
# blocks' products, 8 V dim for the fused loss (2 forward, 6 backward) and
# 16 L dim seq for flash (6 the lse forward, 10 the backward), none for the
# embedding: 2,220,994,560 / 2,025,848,832 = 1.09633 at 4 layers
TRAINER_ATTRIBUTION_BAND = (1.091, 1.101)


def card_label() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "not read"


def counted_kernel_flops(launches, b, s, hq, hkv, d, n_tokens, dim, vocab):
    """What the kernels' formulas (``ops._cost``) give for a Llama train
    step's launches (``_read_counters`` keys): the flash forward (plain and
    lse), dK/dV, dQ and the delta pre-pass at (b, s, hq, hkv, d), the fused
    loss at (n_tokens, dim, vocab)."""
    from torchdistx_tpu_torch.ops import _cost

    per = {"flash_fwd": _cost.flash_fwd(b, s, s, hq, hkv, d),
           "flash_fwd_lse": _cost.flash_fwd(b, s, s, hq, hkv, d, out="lse"),
           "flash_bwd_dkv": _cost.flash_bwd_dkv(b, s, hq, hkv, d),
           "flash_bwd_dq": _cost.flash_bwd_dq(b, s, hq, hkv, d),
           "flash_bwd_delta": _cost.flash_bwd_delta(b, s, hq, d),
           "fused_ce_fwd": _cost.fused_ce_fwd(n_tokens, dim, vocab),
           "fused_ce_bwd": _cost.fused_ce_bwd(n_tokens, dim, vocab)}
    return sum(launches.get(k, 0) * c.flops for k, c in per.items())


def _counted_summary(card, launches, cfg, batch, seq, metrics):
    """The counted card's numbers and the kernels' share it should hold."""
    hq, d = cfg.n_heads, cfg.dim // cfg.n_heads
    hkv = cfg.n_kv_heads or cfg.n_heads
    return {"card": card_label(), "flops": card["flops"], "kernel_flops": card["kernel_flops"],
            "formula_kernel_flops": counted_kernel_flops(
                launches, batch, seq, hq, hkv, d, batch * seq, cfg.dim, cfg.vocab_size),
            "kernel_launches": card["kernel_launches"], "first_step_launches": launches,
            "analytic_flops": card["analytic_flops"], "bytes_accessed": card["bytes_accessed"],
            "arithmetic_intensity": card["arithmetic_intensity"],
            **{k: metrics[k] for k in ("mfu", "mfu_xla", "flop_attribution", "goodput")}}


def gpt2_serve_phase(torch, tt, seed):
    """(a) ``ServeEngine`` serving full gpt2_large through the flash kernel
    (cold prefills, D 64) and the four decode kernels at group size 1:
    chunked against persistent (every stream equal), paged with the prefix
    cache cold and warm (cold equal to the slab engine), speculate 4 (the
    block kernel), paged + speculate 4 + int8; each run's launches exact.
    Before them the kernel path's logits of one long prompt against the f32
    plain path (the 2x rule), after them one persistent decode ring under
    the profiler and the four decode kernels at this shape beside their
    plain versions, their bounds and SDPA (rows 9-12, entry G)."""
    import numpy as np
    from torchdistx_tpu_torch.serve import ServeEngine

    failures, report = [], {}
    GPT2 = tt.models.GPT2
    tt.manual_seed(seed)
    t0 = time.perf_counter()
    model = GPT2.from_name(GPT2_SERVE, dtype=torch.bfloat16, device="cuda").requires_grad_(False)
    n_params = sum(p.numel() for p in model.parameters())
    cfg = model.cfg
    n_layers, vocab = cfg.n_layers, cfg.vocab_size
    report["model"] = {"name": GPT2_SERVE, "n_params": n_params, "layers": n_layers,
                       "dim": cfg.dim, "heads": cfg.n_heads, "head_dim": cfg.dim // cfg.n_heads,
                       "init_s": time.perf_counter() - t0}
    if n_params != GPT2_PARAMS:
        failures.append(f"{GPT2_SERVE}: {n_params} parameters != {GPT2_PARAMS}")
    ref = GPT2.from_name(GPT2_SERVE, dtype=torch.float32, device="cuda").requires_grad_(False)
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        ok, info = check_logits(torch, model, ref, prompt_len=GPT2_LOGITS_PROMPT)
    del ref
    torch.cuda.empty_cache()
    print("gpt2_large logits vs f32 plain path", json.dumps(info))
    if not ok:
        failures.append(f"gpt2 logits: {info}")
    report["logits"] = info

    rng = np.random.RandomState(seed)
    reqs = make_requests(rng, vocab, n=16, n_greedy=12, max_new=GPT2_NEW,
                         lo=GPT2_PROMPTS[0], hi=GPT2_PROMPTS[1])
    runs = {}
    with torch.no_grad():
        res_c, runs["chunked"], f = serve(torch, model, reqs, GPT2_SLOTS, GPT2_MAX_LEN)
        failures += [f"gpt2 chunked: {x}" for x in f]
        res_p, runs["persistent"], f = serve(torch, model, reqs, GPT2_SLOTS, GPT2_MAX_LEN,
                                             decode_mode="persistent")
        failures += [f"gpt2 persistent: {x}" for x in f]
        runs["persistent"]["streams_equal_chunked"] = _streams(res_p) == _streams(res_c)
        if not runs["persistent"]["streams_equal_chunked"]:
            failures.append("gpt2 persistent streams differ from chunked")
        # the fused multi-step decode: GPT2_DECODE_CHUNK steps a dispatch
        res_8, runs["chunked_8"], f = serve(torch, model, reqs, GPT2_SLOTS, GPT2_MAX_LEN,
                                            decode_chunk=GPT2_DECODE_CHUNK)
        failures += [f"gpt2 chunked-{GPT2_DECODE_CHUNK}: {x}" for x in f]
        runs["chunked_8"]["streams_equal_chunked"] = _streams(res_8) == _streams(res_c)
        if not runs["chunked_8"]["streams_equal_chunked"]:
            failures.append(f"gpt2 chunked-{GPT2_DECODE_CHUNK} streams differ from chunked-1")

        def engine(**kw):
            return ServeEngine(model, num_slots=GPT2_SLOTS, max_len=GPT2_MAX_LEN,
                               cost_cards=False, **kw)

        share = prefix_share_requests(rng, vocab, n=GPT2_SLOTS, max_len=GPT2_MAX_LEN,
                                      max_new=GPT2_NEW)
        paged = engine(page_size=16, prefix_cache=True)
        cold, runs["paged_cold"] = run_engine(torch, paged, share)
        warm, runs["paged_warm"] = run_engine(torch, paged, share)
        del paged
        slab, runs["slab"] = run_engine(torch, engine(), share)
        for what, res, key in (("paged_cold", cold, "paged_decode_attention"),
                               ("paged_warm", warm, "paged_decode_attention"),
                               ("slab", slab, "decode_attention")):
            summ = runs[what]
            failures += _greedy_failures(f"gpt2 {what}", share, res, vocab)
            failures += _launch_failures(f"gpt2 {what}", summ, {
                key: n_layers * summ["counters"]["decode_steps"],
                "flash_fwd": n_layers * summ["cold_prefills"]})
        if not runs["paged_warm"]["counters"]["prefix_hit_tokens"] > 0:
            failures.append("gpt2 paged warm pass: no prefix hit")
        runs["paged_cold"]["streams_equal_slab"] = _streams(cold) == _streams(slab)
        if not runs["paged_cold"]["streams_equal_slab"]:
            failures.append("gpt2 paged cold pass differs from the slab engine")

        cyc = cyclic_requests(rng, vocab, n=GPT2_SLOTS, max_new=GPT2_NEW)
        spec, runs["speculate"] = run_engine(torch, engine(speculate=4, spec_ngram=2), cyc)
        full, runs["paged_spec_int8"] = run_engine(
            torch, engine(page_size=16, speculate=4, kv_dtype="int8"), cyc)
        # the same prompts without drafts (persistent: its streams are the
        # chunked slab engine's), for the share of greedy streams unchanged
        base, runs["speculate_0"] = run_engine(torch, engine(decode_mode="persistent"), cyc)
        failures += _greedy_failures("gpt2 speculate_0", cyc, base, vocab)
        failures += _launch_failures("gpt2 speculate_0", runs["speculate_0"], {
            "decode_attention": n_layers * runs["speculate_0"]["counters"]["decode_steps"],
            "flash_fwd": n_layers * runs["speculate_0"]["cold_prefills"]})
        for what, res, key in (("speculate", spec, "decode_attention_block"),
                               ("paged_spec_int8", full, "paged_decode_attention_block_int8")):
            summ = runs[what]
            summ["tokens_per_verify"] = _tokens_per_verify(summ["counters"], 4)
            summ["greedy_share_equal_to_speculate0"] = float(np.mean([
                np.array_equal(np.asarray(a.tokens), np.asarray(b.tokens))
                for a, b in zip(res, base)]))  # every cyclic request is greedy
            if not summ["tokens_per_verify"] > 1:
                failures.append(f"gpt2 {what}: {summ['tokens_per_verify']} tokens per verify")
            failures += _greedy_failures(f"gpt2 {what}", cyc, res, vocab)
            failures += _launch_failures(f"gpt2 {what}", summ, {
                key: n_layers * summ["counters"]["decode_steps"],
                "flash_fwd": n_layers * summ["cold_prefills"]})
        for name, summ in runs.items():
            print(f"serve gpt2_large {name}", json.dumps(summ))
        prof = profile_decode(torch, model, reqs[:GPT2_SLOTS], GPT2_SLOTS, GPT2_MAX_LEN,
                              decode_mode="persistent")
        print("serve profile persistent gpt2_large", json.dumps(prof))
    report["runs"], report["profile_persistent"] = runs, prof
    rows, f = check_decode_variants(torch, torch.device("cuda"), b=GPT2_SLOTS,
                                    max_len=GPT2_MAX_LEN, hq=cfg.n_heads, hkv=cfg.n_heads,
                                    d=cfg.dim // cfg.n_heads, iters=20,
                                    positions_of=GPT2_VARIANT_POSITIONS, phase=30)
    failures += [f"gpt2 decode variants: {x}" for x in f]
    report["decode_variants"] = rows
    del model
    torch.cuda.empty_cache()
    return report, [f"phase 30 (a) {x}" for x in failures]


def _t5_first_logits(torch, model, src, use_flash):
    """The first decode step's f32 logits (the start token at position 0)
    after the encoder, through the kernels or the plain path."""
    saved = model.cfg.use_flash
    model.cfg.use_flash = use_flash
    try:
        enc = model.encode(src)
        cache = model.init_decoder_cache(enc, 1)
        tok = torch.zeros((src.shape[0], 1), dtype=torch.long, device=src.device)
        return model.decode_step(tok, cache, 0)[0].float()
    finally:
        model.cfg.use_flash = saved


def t5_generate_phase(torch, tt, seed):
    """(b) ``generate_encdec`` on full T5-3B, bf16, B 4 x 512 encoder
    tokens, 32 new tokens, with the materialized bias and with the bucket
    table: the encoder once through the flash kernel's bias or bucket
    variant (one launch an encoder layer), the decoder on the plain path.
    The first decode step's logits through the kernel encoder are held
    against the f32 plain model within LOGITS_FACTOR times the bf16 plain
    path's distance."""
    from torchdistx_tpu_torch.generation import generate_encdec

    failures, report = [], {}
    T5 = tt.models.T5
    tt.manual_seed(seed)
    t0 = time.perf_counter()
    model = T5.from_name(T5_GEN, dtype=torch.bfloat16, device="cuda",
                         use_flash=True).requires_grad_(False)
    cfg = model.cfg
    report["model"] = {"name": T5_GEN, "layers_per_stack": cfg.n_layers, "dim": cfg.dim,
                       "heads": cfg.n_heads, "d_kv": cfg.d_kv,
                       "n_params": sum(p.numel() for p in model.parameters()),
                       "init_s": time.perf_counter() - t0}
    g = torch.Generator(device="cuda").manual_seed(seed)
    src = torch.randint(1, cfg.vocab_size, (T5_GEN_BATCH, T5_GEN_SEQ), generator=g,
                        device="cuda")
    with torch.no_grad():
        ref_model = T5.from_name(T5_GEN, dtype=torch.float32, device="cuda",
                                 use_flash=False).requires_grad_(False)
        ref_model.load_state_dict(model.state_dict())
        ref = _t5_first_logits(torch, ref_model, src, False)
        del ref_model
        torch.cuda.empty_cache()
        for bucket in (False, True):
            mode = "bucket" if bucket else "bias"
            model.cfg.flash_bucket_bias = bucket
            kern = _t5_first_logits(torch, model, src, True)
            plain = _t5_first_logits(torch, model, src, False)
            ok, info = _logits_verdict(torch, model, kern, plain, ref,
                                       [T5_GEN_BATCH, 1, cfg.vocab_size], mode=mode)
            info["layers"] = cfg.n_layers
            print(f"t5_3b first decode logits vs f32 plain path ({mode})", json.dumps(info))
            if not ok:
                failures.append(f"t5 {mode} logits: {info}")
            torch.cuda.synchronize()
            _reset_counters()
            t0 = time.perf_counter()
            out = generate_encdec(model, src, T5_GEN_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: v for k, v in _read_counters().items() if v}
            key = f"flash_fwd_{mode}"
            run = {"mode": mode, "batch": T5_GEN_BATCH, "encoder_tokens": T5_GEN_SEQ,
                   "new_tokens": T5_GEN_NEW, "wall_s": wall,
                   "s_per_generated_token": wall / T5_GEN_NEW,
                   "launches": got, "logits": info,
                   "shape": list(out.shape),
                   "in_vocab": bool(((out >= 0) & (out < cfg.vocab_size)).all())}
            print(f"generate t5_3b {mode}", json.dumps(run))
            if got.get(key, 0) != cfg.n_layers or got.get("flash_fwd", 0) != cfg.n_layers:
                failures.append(f"t5 {mode}: {key} launches {got} != {cfg.n_layers}")
            if run["shape"] != [T5_GEN_BATCH, T5_GEN_NEW] or not run["in_vocab"]:
                failures.append(f"t5 {mode}: output {run['shape']}, in vocab {run['in_vocab']}")
            report[mode] = run
    del model
    torch.cuda.empty_cache()
    return report, [f"phase 30 (b) {x}" for x in failures]


def _slot_of(req):
    return next(d["slot"] for name, _, d in req.events if name == "admitted")


def stream_waves(torch, engine, work):
    """:func:`run_waves` on a ``persistent_stream`` engine, checking each
    dispatch: its pushes are its loop iterations, the cursors 0, 1, ...,
    and each request's live rows are the tokens its drain walk took.
    Returns (handles, wall, failures)."""
    failures = []
    ticks = sorted({t for t, _ in work})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handles = []

    def step():
        reqs = [h._request for h in handles]
        before = {id(r): len(r.generated) for r in reqs}
        iters = engine.metrics.counters["loop_iterations"]
        engine.step()
        n_it = engine.metrics.counters["loop_iterations"] - iters
        events = engine.stream_events if n_it else []
        if len(events) != n_it or [e[3] for e in events] != list(range(n_it)):
            failures.append(f"(c) {len(events)} pushes for {n_it} iterations")
        for req in reqs:
            got = req.generated[before[id(req)]:]
            chunks = [d for name, _, d in req.events if name == "decode_chunk"]
            if not got or not chunks or not n_it:
                continue
            ring = got[len(got) - chunks[-1]["tokens"]:]
            slot = _slot_of(req)
            streamed = [int(toks[slot]) for _, toks, live, _ in events if live[slot]]
            if streamed[:len(ring)] != ring:
                failures.append(f"(c) request {req.rid}: streamed {streamed[:4]}... "
                                f"!= drained {ring[:4]}...")

    for t in ticks:
        wave = [engine.submit(**kw) for tick, kw in work if tick == t]
        handles += wave
        step()
        while not all(h.done() for h in wave):
            step()
    torch.cuda.synchronize()
    return handles, time.perf_counter() - t0, failures


def stream_part(torch, model, c_report):
    """(c) ``persistent_stream=True`` on phase 29 (c)'s one-engine geometry
    and scenario: one push a loop iteration (a host node of the captured
    iteration), streamed tokens equal to the drained ones, every
    first-token stamp before its drain, and the streams, host syncs and
    tokens those of (c)'s run without the stream."""
    from torchdistx_tpu_torch.serve import ServeEngine

    kw = dict(num_slots=FLEET_SLOTS, max_len=FLEET_MAX_LEN, prefill_buckets=FLEET_BUCKETS,
              page_size=16, prefix_cache=True, decode_mode="persistent")
    work = fleet_requests(model)
    engine = ServeEngine(model, persistent_stream=True, **kw)
    handles, wall, failures = stream_waves(torch, engine, work)
    c = engine.metrics.counters
    ref = c_report["single_counters"]
    streams = [h.result().tokens.tolist() for h in handles]
    before = [
        (r.rid, first, drain)
        for r in (h._request for h in handles)
        for first in [next(ts for name, ts, _ in r.events if name == "first_token")]
        for drain in [next((ts for name, ts, _ in r.events if name == "decode_chunk"), None)]
        if drain is not None and not first < drain]
    out = {"requests": len(handles), "wall_s": wall, "stream_supported": engine.stream_supported,
           "pushes": c["stream_callbacks"], "loop_iterations": c["loop_iterations"],
           "loop_replays": engine.loop_replays, "dropped": engine._decode.stream.dropped,
           "host_syncs": c["host_syncs"], "host_syncs_without_stream": ref["host_syncs"],
           "tokens_generated": c["tokens_generated"],
           "host_syncs_per_token": c["host_syncs"] / c["tokens_generated"],
           "host_syncs_per_token_without_stream": ref["host_syncs"] / ref["tokens_generated"],
           "streams_equal_without_stream": streams == c_report["single_streams"],
           "first_token_stamps_after_drain": before,
           "wall_s_without_stream": c_report["single"]["wall_s"],
           "ttft_p50_s": _ttft_p50([h.result() for h in handles]),
           "ttft_p50_s_without_stream": c_report["single"]["ttft_p50_s"]}
    print("(c) persistent_stream", json.dumps(out))
    if engine.stream_supported != "host_node":
        failures.append(f"(c) stream_supported {engine.stream_supported}")
    if not (out["pushes"] == out["loop_iterations"] == out["loop_replays"] > 0):
        failures.append(f"(c) pushes {out['pushes']}, iterations {out['loop_iterations']}, "
                        f"replays {out['loop_replays']}")
    if out["dropped"] or before:
        failures.append(f"(c) dropped {out['dropped']}, stamps after the drain {before[:3]}")
    if (c["host_syncs"], c["tokens_generated"]) != (ref["host_syncs"], ref["tokens_generated"]):
        failures.append(f"(c) host syncs {c['host_syncs']} / tokens {c['tokens_generated']} != "
                        f"{ref['host_syncs']} / {ref['tokens_generated']} without the stream")
    if not out["streams_equal_without_stream"]:
        failures.append("(c) streams differ from the run without the stream")
    return out, [f"phase 30 {x}" for x in failures], engine


def stream_cost(torch, streamed, plain):
    """The streamed tail's cost a loop iteration, in one process: two
    persistent engines of one geometry that ran the same scenario to its
    end, ``streamed`` with ``persistent_stream=True`` and ``plain``
    without, so both loops stand at their fixpoint (every slot finished:
    an iteration computes and changes no loop state) at equal positions.
    Their captured iterations, with and without the copy and the host
    node, are replayed STREAM_COST_REPLAYS times a block, in alternating
    blocks (ABBA order), STREAM_COST_ROUNDS blocks each, timed by CUDA
    events (the host node's wait included) and the host clock.  Every
    replay of the streamed graph must run its host function once."""
    import numpy as np

    n, rounds = STREAM_COST_REPLAYS, STREAM_COST_ROUNDS
    graphs = {"stream": streamed._decode.loop.graph, "plain": plain._decode.loop.graph}
    ring = streamed._decode.stream
    pushed = ring.count() + ring.dropped
    dev = {k: [] for k in graphs}
    host = {k: [] for k in graphs}
    torch.cuda.synchronize()
    for r in range(rounds):
        for name in (("stream", "plain") if r % 2 == 0 else ("plain", "stream")):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(n):
                graphs[name].replay()
            end.record()
            end.synchronize()
            host[name].append((time.perf_counter() - t0) * 1e3 / n)
            dev[name].append(start.elapsed_time(end) / n)
    pushes = ring.count() + ring.dropped - pushed
    diff = np.array(dev["stream"]) - np.array(dev["plain"])
    host_diff = np.array(host["stream"]) - np.array(host["plain"])
    out = {"replays_a_block": n, "blocks_each": rounds, "pushes": pushes,
           "device_ms_per_replay": {k: float(np.median(v)) for k, v in dev.items()},
           "device_ms_per_replay_min_max": {k: [min(v), max(v)] for k, v in dev.items()},
           "host_ms_per_replay": {k: float(np.median(v)) for k, v in host.items()},
           "stream_cost_device_ms_per_iteration": float(np.median(diff)),
           "stream_cost_device_ms_min_max": [float(diff.min()), float(diff.max())],
           "stream_cost_host_ms_per_iteration": float(np.median(host_diff)),
           "stream_cost_host_ms_min_max": [float(host_diff.min()), float(host_diff.max())]}
    print("(c) stream cost", json.dumps(out))
    failures = []
    if pushes != n * rounds:
        failures.append(f"(c) stream cost: {pushes} host functions for {n * rounds} replays")
    return out, [f"phase 30 {x}" for x in failures]


def _replay_engine(model):
    from torchdistx_tpu_torch.obs.blackbox import geometry_kwargs
    from torchdistx_tpu_torch.serve import ServeEngine

    return lambda rec, geom: ServeEngine(model, record=rec, **geometry_kwargs(geom))


def blackbox_part(torch, model, c_report, record_dir, streamed):
    """(d) the black box on phase 29 (c)'s runs: the one engine's run
    recorded again (its counters, host syncs included, those of (c)'s
    unrecorded run), then replayed in this process; (c)'s disaggregated
    three-replica fleet, recorded in (c), replayed; both files valid, both
    chains equal; a copy with one token changed in a mid-session drain
    names that drain and that request.  Between the recorded run and its
    replay, :func:`stream_cost` on that engine (no stream) and 30 (c)'s
    ``streamed`` engine, which ran the same scenario."""
    from torchdistx_tpu_torch.obs.blackbox import (SessionRecorder, load_session, rechain,
                                                   replay_session, validate_session_jsonl)
    from torchdistx_tpu_torch.serve import ServeEngine

    failures, out = [], {}
    kw = dict(num_slots=FLEET_SLOTS, max_len=FLEET_MAX_LEN, prefill_buckets=FLEET_BUCKETS,
              page_size=16, prefix_cache=True, decode_mode="persistent")
    path = os.path.join(record_dir, "engine.jsonl")
    rec = SessionRecorder(path, enabled=True)
    rec.record("model_spec", family="llama", name="llama3_8b", dtype="bfloat16")
    engine = ServeEngine(model, record=rec, **kw)
    # the recorder's own host time: every call into it, and the engine's
    # drain fold, timed (nested calls once)
    spent, depth = [0.0], [0]

    def timed(fn):
        def run(*args, **kwargs):
            depth[0] += 1
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    spent[0] += time.perf_counter() - t
        return run

    for obj, name in ((rec, "record"), (rec, "record_submit"), (rec, "register_request"),
                      (rec, "drain"), (engine, "_record_drain")):
        setattr(obj, name, timed(getattr(obj, name)))
    handles, wall, _ = run_waves(torch, engine, fleet_requests(model), {})
    rec.close()
    c, ref = dict(engine.metrics.counters), c_report["single_counters"]
    out["stream_cost"], f = stream_cost(torch, streamed, engine)
    failures += f
    del engine
    out["engine"] = {"drains": rec.drains, "host_syncs": c["host_syncs"],
                     "host_syncs_unrecorded": ref["host_syncs"],
                     "counters_equal_unrecorded": c == ref, "wall_s": wall,
                     "wall_s_unrecorded": c_report["single"]["wall_s"],
                     "loop_iterations": c["loop_iterations"],
                     "file_bytes": os.path.getsize(path),
                     "errors": validate_session_jsonl(path)}
    out["engine"]["recorder_host_s"] = spent[0]
    out["engine"]["recorder_cost_ms_per_iteration"] = (
        spent[0] / max(1, c["loop_iterations"]) * 1e3)
    if c != ref:
        failures.append(f"(d) recording moved counters: "
                        f"{ {k: (c.get(k), ref.get(k)) for k in set(c) | set(ref) if c.get(k) != ref.get(k)} }")
    t0 = time.perf_counter()
    v = replay_session(path, engine_factory=_replay_engine(model))
    out["engine"]["replay"] = {k: v.get(k) for k in (
        "verdict", "drains_recorded", "drains_replayed", "chain_recorded", "chain_replayed")}
    out["engine"]["replay"]["seconds"] = time.perf_counter() - t0
    if v["verdict"] != "match" or v["chain_recorded"] != rec.chain:
        failures.append(f"(d) engine replay: {out['engine']['replay']}")

    fleet_path = os.path.join(record_dir, "fleet.jsonl")
    t0 = time.perf_counter()
    v = replay_session(fleet_path, engine_factory=_replay_engine(model))
    out["fleet"] = {k: v.get(k) for k in (
        "verdict", "drains_recorded", "drains_replayed", "chain_recorded", "chain_replayed")}
    out["fleet"].update(seconds=time.perf_counter() - t0,
                        errors=validate_session_jsonl(fleet_path),
                        file_bytes=os.path.getsize(fleet_path))
    if v["verdict"] != "match" or v["chain_recorded"] != v["chain_replayed"]:
        failures.append(f"(d) fleet replay: {out['fleet']}")

    events, _ = load_session(path)
    drains = [e for e in events if e.get("kind") == "drain" and e.get("tokens")]
    target = drains[len(drains) // 2]
    # the copy ends at the changed drain (a killed run's file): replay
    # re-drives only the events before it
    tampered = []
    for e in events:
        e = dict(e)
        tampered.append(e)
        if e.get("kind") == "drain" and e.get("seq") == target["seq"]:
            rid = sorted(e["tokens"])[0]
            e["tokens"] = dict(e["tokens"], **{rid: [t + 1 for t in e["tokens"][rid]]})
            break
    v = replay_session(rechain(tampered), engine_factory=_replay_engine(model))
    d = v.get("first_divergence") or {}
    out["tampered"] = {"verdict": v["verdict"], "seq": d.get("seq"), "tick": d.get("tick"),
                       "rids": d.get("rids"), "counters": d.get("counters"),
                       "expected_seq": target["seq"],
                       "expected_rid": int(sorted(target["tokens"])[0])}
    if (v["verdict"] != "divergent" or d.get("seq") != target["seq"]
            or d.get("rids") != [out["tampered"]["expected_rid"]]):
        failures.append(f"(d) tampered copy: {out['tampered']}")
    for what in ("engine", "fleet"):
        if out[what]["errors"]:
            failures.append(f"(d) {what} file invalid: {out[what]['errors'][:2]}")
    print("(d) black box", json.dumps(out))
    return out, [f"phase 30 {x}" for x in failures]


def trainer_phase(torch, seed, record_dir):
    """(e) phase 26's llama_1b through ``Trainer.fit`` from the same seed
    and batch: with ``flight``, ``record``, ``stall_timeout_s``,
    ``cost_card`` and the numerics observatory all on, then all off, then
    with numerics alone (phase 31's training half).  The losses must be
    equal; the session file valid, one ``train_step`` a step; the two
    numerics books hold the JAX step's site families with equal integer
    fields.  Then a step, :data:`NUMERICS_POISON` set to NaN and one more
    step under a failure detector: the failure's flight record must name
    that parameter's ``params/`` site."""
    import itertools

    from torchdistx_tpu_torch.obs.blackbox import load_session, validate_session_jsonl
    from torchdistx_tpu_torch.obs.flight import FlightRecorder
    from torchdistx_tpu_torch.trainer import Trainer
    from torchdistx_tpu_torch.utils.benchmarks import build_train_workload
    from torchdistx_tpu_torch.utils.failure import FailureDetector

    failures, out, books = [], {}, {}
    path = os.path.join(record_dir, "train.jsonl")

    def workload(numerics):
        return build_train_workload("llama_1b", batch=2, seq=2048, n_layers=CKPT_LAYERS,
                                    optimizer="adamw_8bit", fused_ce=True, device="cuda",
                                    seed=seed, numerics=numerics)

    for run in ("on", "off", "numerics"):
        w = workload(run != "off")
        kw = (dict(flight=FlightRecorder(), record=path, stall_timeout_s=TRAINER_STALL_S,
                   cost_card=True) if run == "on" else dict(flight=False))
        tr = Trainer(w["step"], log_every=1, log_fn=lambda m: None,
                     tokens_per_batch=w["tokens_per_batch"],
                     flops_per_token=w["flops_per_token"], **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "on":  # the counted card's step first, its launches apart
            before = _read_counters()
            tr.fit(itertools.repeat(w["batch"]), 1)
            first = {k: v - before[k] for k, v in _read_counters().items() if v != before[k]}
        tr.fit(itertools.repeat(w["batch"]), TRAINER_STEPS)
        torch.cuda.synchronize()
        res = {"losses": [float(x) for x in w["step"].losses],
               "wall_s": time.perf_counter() - t0}
        if run == "on":
            tr.recorder.close()
            card = tr.cost_card
            res.update(cost_card=None if card is None else card.to_json(),
                       counted=None if card is None else _counted_summary(
                           card.to_json(), first, w["model"].cfg, 2, 2048, tr.metrics),
                       stalls=tr.watchdog.stalls_total,
                       flight_records=tr.flight.recorded_total,
                       session_errors=validate_session_jsonl(path),
                       train_steps_recorded=sum(1 for e in load_session(path)[0]
                                                if e.get("kind") == "train_step"))
        if run != "off":
            books[run] = tr.numerics_book
            res.update(numerics_sites=len(tr.numerics_book.sites()),
                       numerics_harvests=tr.numerics_book.harvests,
                       numerics_harvest_errors=tr.numerics_harvest_errors)
        out[run] = res
        del w, tr
        torch.cuda.empty_cache()
    on, off = out["on"], out["off"]
    out["losses_equal"] = on["losses"] == off["losses"] == out["numerics"]["losses"]
    a, b = books["on"], books["numerics"]
    families = sorted({s.split("/")[0] for s in a.sites()})
    out["numerics_families"] = families
    out["numerics_int_fields_equal"] = a.sites() == b.sites() and all(
        a.digest(s) == b.digest(s) and a.digest(s).hist_hash == b.digest(s).hist_hash
        for s in a.sites())
    out["numerics_first_nonfinite"] = a.first_nonfinite_site()
    # the poisoned run: a clean warm-up step, then the parameter set to NaN;
    # the detector fails the next step at its log boundary, before the NaN
    # has reached any other parameter
    w = workload(True)
    flight = FlightRecorder()
    tr = Trainer(w["step"], log_every=1, log_fn=lambda m: None, flight=flight,
                 failure_detector=FailureDetector(), on_failure="continue")
    tr.fit(itertools.repeat(w["batch"]), 1)
    with torch.no_grad():
        w["model"].get_parameter(NUMERICS_POISON).fill_(float("nan"))
    tr.fit(itertools.repeat(w["batch"]), 2)
    failed = [e for e in flight.records() if e.get("kind") == "failure"]
    want_site = "params/" + ".".join(NUMERICS_POISON.split(".")[:2])
    out["poison"] = {"parameter": NUMERICS_POISON, "failures": len(failed),
                     "nonfinite_site": failed[0].get("nonfinite_site") if failed else None,
                     "want": want_site}
    del w, tr
    torch.cuda.empty_cache()
    print("(e) trainer telemetry llama_1b", json.dumps(out))
    if not out["losses_equal"]:
        failures.append(f"(e) losses {on['losses']} != {off['losses']} with telemetry off")
    if on["session_errors"] or on["train_steps_recorded"] != TRAINER_STEPS:
        failures.append(f"(e) session: {on['session_errors']}, {on['train_steps_recorded']} steps")
    if on["cost_card"] is None or not on["cost_card"].get("peak_bytes"):
        failures.append(f"(e) no cost card: {on['cost_card']}")
    else:
        c = on["counted"]
        print("(e) counted card llama_1b", json.dumps(c))
        lo, hi = TRAINER_ATTRIBUTION_BAND
        if not (c["flop_attribution"] is not None and lo <= c["flop_attribution"] <= hi):
            failures.append(f"(e) flop_attribution {c['flop_attribution']} outside [{lo}, {hi}]")
        if c["kernel_flops"] != c["formula_kernel_flops"] or not c["kernel_flops"]:
            failures.append(f"(e) the card's kernel FLOPs {c['kernel_flops']} != the formulas "
                            f"x the first step's launches {c['formula_kernel_flops']}")
        if not (c["goodput"] is not None and 0 < c["goodput"] <= 1):
            failures.append(f"(e) goodput {c['goodput']} outside (0, 1]")
        if not c["bytes_accessed"] or not c["arithmetic_intensity"]:
            failures.append(f"(e) the counted card has no bytes: {c['bytes_accessed']}")
    if on["stalls"]:
        failures.append(f"(e) the watchdog fired {on['stalls']} times")
    if families != ["act", "grads", "loss", "params"] or not out["numerics_int_fields_equal"]:
        failures.append(f"(e) numerics books: families {families}, int fields equal "
                        f"{out['numerics_int_fields_equal']}")
    # one harvest a log boundary: every step but the first fit's warm-up
    if (a.harvests != TRAINER_STEPS - 1 or on["numerics_harvest_errors"]
            or a.first_nonfinite_site()):
        failures.append(f"(e) numerics: {a.harvests} harvests, "
                        f"{on['numerics_harvest_errors']} failed, first nonfinite "
                        f"{a.first_nonfinite_site()}")
    if out["poison"]["nonfinite_site"] != want_site:
        failures.append(f"(e) poisoned {NUMERICS_POISON}: {out['poison']}")
    return out, [f"phase 30 {x}" for x in failures]


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



# -- phase 31: the numerics observatory (obs.numerics, obs.ledger, obs.gate) --
# phase 3's requests again with numerics=True, each run held to a run of
# its mode without it: (label, engine options, phase 3's run of the mode
# or None when this phase runs its own)
NUMERICS_RUNS = (("chunked-1", {}, 0), ("persistent", {"decode_mode": "persistent"}, 1),
                 ("persistent paged int8", {"decode_mode": "persistent", "page_size": 16,
                                            "kv_dtype": "int8"}, None))
# the JAX engine's zero-overhead pin (tests/test_numerics.py)
NUMERICS_PINNED = ("host_syncs", "decode_dispatches", "decode_steps", "prefill_calls")
NUMERICS_SITES = ("logits", "kv_quant_err", "kv_quant_scale")
NUMERICS_POISON = "blocks.1.attn.wq.weight"  # phase 30 (e)'s poisoned parameter


def logits_count(counters, num_slots, vocab, speculate=0):
    """The closed form of a serve run's ``logits`` digest count: one row of
    the vocabulary a prefill dispatch (its last prompt row) and every slot's
    row of each decode step (``speculate + 1`` rows a verify), finished
    slots included (``generation._make_decode_body``)."""
    return vocab * (counters["prefill_calls"]
                    + num_slots * (speculate + 1) * counters["decode_steps"])


def book_failures(what, book, counters, num_slots, vocab, head_dim, int8):
    """A serve run's numerics book: the declared sites, every site's
    partition identity, no nonfinite value, ``logits.count`` against
    :func:`logits_count`, and for an int8 cache one error element a scale
    element's ``head_dim`` and the error within half the largest scale."""
    out = []
    if sorted(book.sites()) != sorted(NUMERICS_SITES):
        out.append(f"{what}: sites {book.sites()}")
    for site in book.sites():
        d = book.digest(site)
        if d.nonfinite + d.zeros + sum(d.exp_hist) != d.count:
            out.append(f"{what}: {site} partition {d.nonfinite} + {d.zeros} + "
                       f"{sum(d.exp_hist)} != {d.count}")
        if d.nonfinite:
            out.append(f"{what}: {site} has {d.nonfinite} nonfinite values")
    logits, err, sc = (book.digest(s) for s in NUMERICS_SITES)
    want = logits_count(counters, num_slots, vocab)
    if logits is None or logits.count != want:
        out.append(f"{what}: logits count {logits and logits.count} != {want}")
    if int8:
        if not err or not err.count or err.count != head_dim * sc.count:
            out.append(f"{what}: kv_quant_err count {err and err.count} != "
                       f"{head_dim} x kv_quant_scale {sc and sc.count}")
        elif err.max_abs > 0.5 * sc.max_abs:
            out.append(f"{what}: kv error {err.max_abs} above half the scale {sc.max_abs}")
    elif (err and err.count) or (sc and sc.count):
        out.append(f"{what}: kv digests on an unquantized cache")
    return out


def serve_record(engine, label, requests):
    """One run as ``obs.ledger.ingest_serve_record`` reads a serving
    benchmark's record: a phase with its workload keys, the engine's
    metrics and its numerics book."""
    return {"phases": {label: {
        "platform": "gpu", "model": "llama3_8b", "requests": len(requests),
        "max_new_tokens": requests[0]["max_new_tokens"], "num_slots": engine.num_slots,
        "max_len": engine.max_len, "decode_mode": engine.decode_mode,
        "decode_chunk": engine.decode_chunk, "ring_capacity": engine.ring_capacity,
        "page_size": engine.page_size, "kv_dtype": engine.kv_dtype, "numerics": True,
        "metrics": engine.metrics.to_json(),
        "numerics_book": engine.numerics_book.to_json()}}}


def numerics_phase(torch, model, requests, phase3_runs, phase3_results, profiles,
                   num_slots=8, max_len=2048):
    """Phase 31 on phase 3's model: :data:`NUMERICS_RUNS`, each against its
    mode's run without numerics (the same streams, the four pinned counters
    equal), each book held by :func:`book_failures`; the persistent slab run
    twice, both records turned into ledger rows (every row valid) and the
    second gated against expectations built from the first; decode device
    ms a step with numerics on against off, from ``profile_decode`` within
    this call.  Returns (report, failures, launches of each run)."""
    from torchdistx_tpu_torch.obs.flight import get_flight_recorder
    from torchdistx_tpu_torch.obs.gate import build_expectations, gate_rows
    from torchdistx_tpu_torch.obs.ledger import ingest_serve_record, validate_ledger_row
    from torchdistx_tpu_torch.serve import ServeEngine

    failures, report, launches = [], {}, []
    cfg = model.cfg
    head_dim, vocab, n_layers = cfg.dim // cfg.n_heads, cfg.vocab_size, cfg.n_layers
    flight = get_flight_recorder()
    records = []
    for label, kw, ref in NUMERICS_RUNS:
        int8 = kw.get("kv_dtype") == "int8"
        runs = {}
        for on in ((False, True) if ref is None else (True,)):
            engine = ServeEngine(model, num_slots=num_slots, max_len=max_len, cost_cards=False,
                                 numerics=on, **kw)
            anomalies = sum(1 for e in flight.records() if e.get("anomaly") == "kv_quant_err")
            results, summary = run_engine(torch, engine, requests)
            summary["streams"] = _streams(results)
            # phase 3's measure: the decode dispatches' host wall clock, the
            # sync included, a step (a fresh engine: this run's alone)
            summary["host_ms_per_decode_step"] = (
                engine.metrics.decode_s.total / summary["counters"]["decode_steps"] * 1e3)
            if on:
                book = engine.numerics_book
                summary["book"] = book
                summary["harvest_errors"] = engine.numerics_harvest_errors
                summary["anomalies"] = sum(1 for e in flight.records()
                                           if e.get("anomaly") == "kv_quant_err") - anomalies
                summary["record"] = serve_record(engine, label, requests)
                launches.append(summary["launches"])
            runs.setdefault(on, []).append(summary)
            del engine
        if ref is None:
            off = runs[False][0]
        else:
            off = dict(phase3_runs[ref], streams=_streams(phase3_results))
        on = runs[True][0]
        what = f"(31) {label}"
        if on["streams"] != off["streams"]:
            failures.append(f"{what}: streams differ with numerics on")
        for k in NUMERICS_PINNED:
            if on["counters"][k] != off["counters"][k]:
                failures.append(f"{what}: {k} {on['counters'][k]} != {off['counters'][k]} off")
        book = on["book"]
        failures += book_failures(what, book, on["counters"], num_slots, vocab, head_dim, int8)
        if on["harvest_errors"] or on["anomalies"]:
            failures.append(f"{what}: {on['harvest_errors']} failed harvests, "
                            f"{on['anomalies']} kv_quant_err anomalies")
        decode = ("paged_decode_attention" if kw.get("page_size") else "decode_attention") + (
            "_int8" if int8 else "")
        expect = {"flash_fwd": n_layers * on["counters"]["prefill_calls"],
                  decode: n_layers * on["counters"]["decode_steps"]}
        failures += _launch_failures(what, on, expect)
        if kw.get("decode_mode") == "persistent":
            failures += _persistent_failures(what, on)
        line = {"sites": {s: book.digest(s).to_json() for s in book.sites()},
                "logits_count": book.digest("logits").count,
                "logits_count_closed_form": logits_count(on["counters"], num_slots, vocab),
                "counters_on": {k: on["counters"][k] for k in NUMERICS_PINNED},
                "counters_off": {k: off["counters"][k] for k in NUMERICS_PINNED},
                "streams_equal": on["streams"] == off["streams"],
                "wall_s_on": on["wall_s"], "wall_s_off": off.get("wall_s"),
                "host_ms_per_decode_step_on": on["host_ms_per_decode_step"],
                "host_ms_per_decode_step_off": off.get("host_ms_per_decode_step"),
                "launches": on["launches"], "harvests": book.harvests}
        for site in line["sites"].values():
            site.pop("exp_hist")
        if label == "persistent":
            # a second run: every row valid, and gated against the first's
            rows = [ingest_serve_record(r["record"], run_id=f"numerics-{i}", git_sha=None)
                    for i, r in enumerate(runs[True] + [_second_run(
                        torch, model, requests, kw, label, num_slots, max_len)])]
            bad = [e for rs in rows for r in rs for e in validate_ledger_row(r)]
            verdict = gate_rows(rows[1], build_expectations(rows[0]), [])
            line["ledger_rows"] = [len(r) for r in rows]
            line["gate"] = {k: verdict[k] for k in ("ok", "checked_counters",
                                                     "checked_timings")}
            line["gate"]["failures"] = verdict["failures"][:5]
            if bad:
                failures.append(f"{what}: invalid ledger rows: {bad[:3]}")
            if not verdict["ok"] or verdict["failures"] or not verdict["checked_counters"]:
                failures.append(f"{what}: the second run's gate {line['gate']}")
            records.append(rows)
        # decode device ms a step, numerics on against off, in this call
        pkw = dict(kw, decode_chunk=1) if "decode_mode" not in kw else dict(kw)
        prof_on = profile_decode(torch, model, requests[:num_slots], num_slots, max_len,
                                 numerics=True, **pkw)
        prof_off = (profiles.get(label) if ref is not None else
                    profile_decode(torch, model, requests[:num_slots], num_slots, max_len,
                                   **pkw))
        line["decode_device_ms_on"] = prof_on.get("device_ms_per_step")
        line["decode_device_ms_off"] = (prof_off or {}).get("device_ms_per_step")
        line["decode_kernels_on"] = prof_on.get("by_class_ms_per_step")
        line["decode_idle_share_on"] = prof_on.get("device_idle_share")
        line["decode_idle_share_off"] = (prof_off or {}).get("device_idle_share")
        print(f"(31) numerics {label}", json.dumps(line))
        report[label] = line
    return report, [f"phase 31 {x}" for x in failures], launches


def _second_run(torch, model, requests, kw, label, num_slots, max_len):
    from torchdistx_tpu_torch.serve import ServeEngine

    engine = ServeEngine(model, num_slots=num_slots, max_len=max_len, cost_cards=False,
                         numerics=True, **kw)
    run_engine(torch, engine, requests)
    return {"record": serve_record(engine, label, requests)}


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
    libs = ["flash_fwd", "flash_bwd", "decode_attention", "fused_ce", "stream_ring"]
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

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
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

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
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
        # the slab in bf16 and int8 and the pages in int8 (paged bf16 was
        # cut for phase 23 (j): its logits equal the bf16 slab's bit for bit)
        for kw in ({}, {"kv_dtype": "int8"}, {"page_size": 16, "kv_dtype": "int8"}):
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
        requests = make_requests(rng, model.cfg.vocab_size, max_new=SERVE_NEW)
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
        torch.cuda.empty_cache()
        print(f"phase start: {time.perf_counter() - t_start:.1f} s")
        # -- 31. the numerics observatory on phase 3's runs ---------------------
        with torch.no_grad():
            numerics_report, f31, numerics_launches = numerics_phase(
                torch, model, requests, serve_runs, results, profiles)
        failures += f31
        report["numerics"] = numerics_report
        torch.cuda.empty_cache()
        print(f"phase start: {time.perf_counter() - t_start:.1f} s")
        # -- 29. chunked prefill, the HBM gate, the fleet, the autoscaler ------
        # (the session files of phase 30 (d) and (e) go to record_dir)
        record_dir = tempfile.mkdtemp(prefix="tdx_session_")
        with torch.no_grad():
            fleet_report, f29, fleet_launches = serve_fleet_phase(torch, model,
                                                                  args.seed + 15, record_dir)
        failures += f29
        report["serve_fleet"] = fleet_report
        torch.cuda.empty_cache()
        print(f"phase start: {time.perf_counter() - t_start:.1f} s")
        # -- 30 (c), (d). the streamed tail and the black box on phase 29 ------
        with torch.no_grad():
            stream_report, f30, streamed = stream_part(torch, model, fleet_report["c"])
            failures += f30
            bb_report, f30 = blackbox_part(torch, model, fleet_report["c"], record_dir,
                                           streamed)
            failures += f30
            del streamed
        report["phase30"] = {"c_stream": stream_report, "d_blackbox": bb_report}
        del model
        torch.cuda.empty_cache()
    except Exception:
        traceback.print_exc()
        _fail("serve phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 30 (a), (b), (e). GPT-2 serving, T5 generation, the Trainer's telemetry
    try:
        gpt2_serve, f30 = gpt2_serve_phase(torch, tt, args.seed + 16)
        failures += f30
        torch.cuda.empty_cache()
        print(f"phase start: {time.perf_counter() - t_start:.1f} s")
        t5_gen, f30 = t5_generate_phase(torch, tt, args.seed + 17)
        failures += f30
        print(f"phase start: {time.perf_counter() - t_start:.1f} s")
        trainer_tel, f30 = trainer_phase(torch, args.seed + 18, record_dir)
        failures += f30
        shutil.rmtree(record_dir, ignore_errors=True)
        report["phase30"].update(a_gpt2=gpt2_serve, b_t5=t5_gen, e_trainer=trainer_tel)
        torch.cuda.empty_cache()
    except Exception:
        traceback.print_exc()
        _fail("phase 30 failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 4. backward kernels vs plain versions ------------------------------
    try:
        bwd_rows, f4 = check_flash_bwd(torch, device)
        failures += f4
    except Exception:
        traceback.print_exc()
        _fail("backward kernel phase failed")
    report["flash_bwd"] = bwd_rows

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
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

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
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

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 33. the examples on one card: quantized inference, elastic training ---
    try:
        torch.cuda.empty_cache()
        report["examples"], f33 = examples_phase(torch)
        for name, row in report["examples"].items():
            print(f"(33) example {name}", json.dumps(row))
        failures += f33
    except Exception:
        traceback.print_exc()
        _fail("examples phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 7. fused LM-head cross-entropy kernels vs plain versions -------------
    try:
        ce_rows, f7 = check_fused_ce(torch, device)
        failures += f7
    except Exception:
        traceback.print_exc()
        _fail("fused cross-entropy kernel phase failed")
    report["fused_ce"] = ce_rows

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
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

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 9. train gpt2_large ----------------------------------------------------
    try:
        gpt2_summary, f9 = train_gpt2(torch, args.seed)
        failures += f9
        print("train gpt2_large", json.dumps(gpt2_summary))
        report["train_gpt2"] = gpt2_summary
    except Exception:
        traceback.print_exc()
        _fail("gpt2 train phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
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
    # -- 23. GossipGraD, SlowMo, TP, EP, SP, PP, ZeRO-2 and resharding across two
    # ranks on the one card, the flash kernels first at the parallel runs' shapes;
    # phase 32 (config 5 sharded) runs in the same world last
    try:
        torch.cuda.empty_cache()
        par_kernels, f23 = check_parallel_kernels(torch, device)
        failures += f23
        report["parallel_kernels"] = par_kernels
        # (j)'s kernels at a rank's heads of llama3_8b at tp 2: Hq 16, Hkv 4
        tp_flash, f23 = check_flash(torch, device, hq=16, hkv=4, cases=[(1, 1024)], iters=3)
        failures += f23
        tp_decode, f23 = check_decode_variants(torch, device, hq=16, hkv=4, iters=3, phase=23,
                                               only=TP_SERVE_VARIANTS)
        failures += f23
        report["tp_serve_kernels"] = {"flash": tp_flash, "decode_variants": tp_decode}
        gossip, f23 = gossip_two_ranks(args.seed + 12)
        for res in gossip["ranks"]:
            for run in ("gossip", "slowmo"):
                print(f"{run} rank {res.get('rank')}", json.dumps(res.get(run)))
            for part, what in (("c", "tp llama_1b"), ("d", "ep mixtral_8x7b")):
                print(f"{what} rank {res.get('rank')}",
                      json.dumps(res.get("tp_ep", {}).get(part)))
            for part, what in PARALLEL_LINES:
                print(f"{what} rank {res.get('rank')}",
                      json.dumps(res.get("parallel", {}).get(part)))
            print(f"tp serve llama3_8b rank {res.get('rank')}", json.dumps(res.get("tp_serve")))
            # -- 32. BASELINE config 5 sharded, in phase 23's world after (j)
            c5s = res.get("config5_sharded", {})
            for part, what in (("a", "(32a) materialize llama2_7b fsdp 2"),
                               ("b", f"(32b) train llama2_7b {TRAIN_FSDP_LAYERS} layers fsdp 2"),
                               ("vit", f"(32) vit_train {FSDP_VIT[0]} fsdp 2")):
                print(f"{what} rank {res.get('rank')}", json.dumps(c5s.get(part)))
            print(f"(32) seconds rank {res.get('rank')}", c5s.get("seconds"))
            print(f"(23) example long_context_sp rank {res.get('rank')}",
                  json.dumps(res.get("example_sp")))
        f23 += _tp_serve_failures(gossip["ranks"])
        if any("example_sp" not in r for r in gossip["ranks"]):
            f23.append("phase 23: examples.long_context_sp did not run on every rank")
        if any("b" not in r.get("config5_sharded", {}) for r in gossip["ranks"]):
            _fail("phase 32 failed: " + "; ".join(f23))
        print("gossip world", json.dumps({k: v for k, v in gossip.items() if k != "ranks"}))
        failures += f23
        report["gossip_two_ranks"] = gossip
    except Exception:
        traceback.print_exc()
        _fail("two-rank gossip phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 25. BASELINE config 5: llama2_7b, 8-bit AdamW, dots, on one card ----------
    try:
        torch.cuda.empty_cache()
        c5_bwd, f25 = check_flash_bwd(torch, device, cases=[CONFIG5_BWD_CASE],
                                      timed=(CONFIG5_BWD_CASE,), phase=25)
        failures += f25
        c5_ce, f25 = check_fused_ce(torch, device, cases=[CONFIG5_CE_CASE], phase=25)
        failures += f25
        torch.cuda.empty_cache()
        config5, f25 = train_config5(torch, args.seed + 13, args.seed)
        mixtral_train = config5.pop("mixtral", {"error": "phase 25's process did not run it"})
        vision = config5.pop("vision", {"error": "phase 25's process did not run it"})
        print("train llama2_7b config 5", json.dumps(config5))
        print("config 5 counted", json.dumps(config5.get("counted")))
        print("train mixtral_8x7b", json.dumps(mixtral_train))
        failures += f25 + _mixtral_failures(mixtral_train)
        if "launches" not in config5 or "launches" not in mixtral_train:
            _fail("config 5 phase failed: " + "; ".join(f25 + _mixtral_failures(mixtral_train)))
        report["config5"] = {"train": config5, "flash_bwd": c5_bwd, "fused_ce": c5_ce}
        report["mixtral_train"] = mixtral_train
    except Exception:
        traceback.print_exc()
        _fail("config 5 phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 26. checkpoint, resume and the failure policy on the card -----------------
    try:
        ckpt, f26 = checkpoint_and_failure(torch, args.seed + 14)
        print("checkpoint and failure llama_1b", json.dumps(ckpt))
        failures += f26
        report["checkpoint"] = ckpt
    except Exception:
        traceback.print_exc()
        _fail("checkpoint phase failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- 27-28. BASELINE config 2 (ResNet-50) and ViT-B/16, run in phase 25's
    # process after 25b -----------------------------------------------------------
    try:
        f27 = vision_failures(vision)
        for phase, name, _ in VISION_RUNS:
            label = "train resnet50 config 2" if phase == 27 else f"train {name}"
            print(label, json.dumps(vision.get(name)))
        failures += f27
        if not all("losses" in vision.get(name, {}) for _, name, _ in VISION_RUNS):
            _fail("phases 27-28 failed: " + "; ".join(f27))
        report["vision"] = vision
    except Exception:
        traceback.print_exc()
        _fail("phases 27-28 failed")

    print(f"phase start: {time.perf_counter() - t_start:.1f} s")
    # -- the record -----------------------------------------------------------
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
    # the training main paths: llama_1b unfused and fused, gpt2_large,
    # llama_1b under SlowMo (phase 22), config 5 (phase 25) and the
    # checkpointed llama_1b (phase 26)
    runs = (train_summary, fused_summary, gpt2_summary, slowmo_train, config5, ckpt,
            mixtral_train)

    def trained(kernel):
        return sum(r["launches"][kernel] for r in runs)

    def d64(key):  # the gpt2_large (head_dim 64) timings of a flash kernel
        return {f"{k}_d64": brep64[f"{key}{k}"] for k in ("ms", "bound_ms")}

    mixtral_fwd = mixtral_serve["launches"].get("flash_fwd", 0)
    # phase 3's runs and phase 31's numerics runs of the same requests
    served_fwd = (sum(r["launches"]["flash_fwd"] for r in serve_runs)
                  + sum(r.get("flash_fwd", 0) for r in numerics_launches))
    fleet_fwd = fleet_launches.get("flash_fwd", 0)
    # phase 30 (a): gpt2_large's cold prefills (D 64)
    gpt2_runs = list(gpt2_serve["runs"].values())
    gpt2_fwd = sum(r["launches"].get("flash_fwd", 0) for r in gpt2_runs)
    fwd = _kernel_entry(
        "flash_fwd", "torchdistx_tpu_torch/csrc/flash_fwd.cu",
        "torchdistx_tpu/ops/flash_attention.py:141",
        served_fwd + mixtral_fwd + fleet_fwd + gpt2_fwd + trained("flash_fwd_lse"), rep,
        max(r["max_abs_err"] for r in flash_rows))
    fwd.update(launches_plain=served_fwd, launches_mixtral=mixtral_fwd,
               launches_serving_fleet=fleet_fwd, launches_gpt2_serving=gpt2_fwd,
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
              + [mixtral_serve["launches"], fleet_launches]
              + [r["launches"] for r in gpt2_runs] + list(numerics_launches))
    # entry G: each decode variant at gpt2_large's serving shape (D 64,
    # Hq = Hkv = 20: group size 1)
    at_gpt2 = {(r["kernel"], r["dtype"]): r for r in gpt2_serve["decode_variants"]}

    def decode_entry(name, dt, row):
        key = name if dt == "bf16" else f"{name}_int8"
        entry = _kernel_entry(
            key, "torchdistx_tpu_torch/csrc/decode_attention.cu", TPU_KERNEL_OF[name],
            sum(r.get(key, 0) for r in served), row, row["max_abs_err"])
        g = at_gpt2[(name, dt)]
        entry.update(dtype=dt, S=row.get("S", 1), positions=row["positions"],
                     device_ms=row.get("device_ms"),
                     library_device_ms=row.get("library_device_ms"),
                     launches_serving_fleet=fleet_launches.get(key, 0),
                     launches_gpt2_serving=sum(r.get(key, 0) for r in
                                               (r["launches"] for r in gpt2_runs)),
                     gpt2_shape={k: g.get(k) for k in (
                         "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                         "device_ms", "library_device_ms", "max_abs_err",
                         "max_row_rel_err", "positions", "S")})
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
    t5_entries = t5_kernel_entries(bias_rows, t5_runs)
    for entry in t5_entries:  # phase 30 (b): the encoder of T5-3B's generation
        mode = {"flash_fwd_bias": "bias", "flash_fwd_bucket": "bucket"}.get(entry["name"])
        if mode is not None:
            n = t5_gen[mode]["launches"].get(f"flash_fwd_{mode}", 0)
            entry["launches"] += n
            entry["launches_t5_generation"] = n
    kernels += t5_entries
    kernels += window_kernel_entries(window_rows, mistral_serve, mistral_train)
    kernels += sp_kernel_entries(residual_rows, sp_train)
    # phases 22-23 apart: SlowMo at world size 1, and each rank of the
    # two-rank run (GossipGraD and SlowMo steps together)
    counter_of = {"flash_fwd": "flash_fwd_lse", "flash_bwd_dkv": "flash_bwd_dkv",
                  "flash_bwd_delta": "flash_bwd_delta", "flash_bwd_dq": "flash_bwd_dq",
                  "fused_ce_fwd": "fused_ce_fwd", "fused_ce_bwd_dx": "fused_ce_bwd",
                  "fused_ce_bwd_dw": "fused_ce_bwd"}
    # phase 25's shapes: (ms, plain, bound, library, error keys) of each row
    c5b, c5c = report["config5"]["flash_bwd"][0], report["config5"]["fused_ce"][0]
    at_config5 = {
        "flash_fwd": (c5b, "lse_ms", "lse_plain_ms", "lse_bound_ms", "lse_library_ms",
                      ("lse_err",)),
        "flash_bwd_dkv": (c5b, "dkv_ms", "plain_ms", "dkv_bound_ms", "library_ms",
                          ("dk_err", "dv_err")),
        "flash_bwd_delta": (c5b, "delta_ms", "delta_plain_ms", "delta_bound_ms", None,
                            ("delta_err",)),
        "flash_bwd_dq": (c5b, "dq_ms", "plain_ms", "dq_bound_ms", "library_ms", ("dq_err",)),
        "fused_ce_fwd": (c5c, "fwd_ms", "fwd_plain_ms", "fwd_bound_ms", "fwd_library_ms",
                         ("lse_err",)),
        "fused_ce_bwd_dx": (c5c, "bwd_ms", "bwd_plain_ms", "bwd_bound_ms", "grad_library_ms",
                            ("dx_err",)),
        "fused_ce_bwd_dw": (c5c, "bwd_ms", "bwd_plain_ms", "bwd_bound_ms", "grad_library_ms",
                            ("dw_err",))}
    for entry in kernels:
        key = counter_of.get(entry["name"])
        if key:
            entry["launches_slowmo"] = slowmo_train["launches"][key]
            entry["launches_two_ranks"] = [r["launches_gossip"][key] + r["launches_slowmo"][key]
                                           for r in gossip["ranks"]]
            entry["launches_config5"] = config5["launches"][key]
            entry["launches_config5_sharded_ranks"] = [
                r["config5_sharded"]["b"]["launches"][key] for r in gossip["ranks"]]
            entry["launches_checkpoint"] = ckpt["launches"][key]
            entry["launches_mixtral_train"] = mixtral_train["launches"][key]
            entry["launches_tp_ep_ranks"] = [
                {part: r["tp_ep"][part]["launches"][key] for part in ("c", "d")}
                for r in gossip["ranks"]]
            row, ms, plain, bound, lib, errs = at_config5[entry["name"]]
            entry["config5"] = {
                "shape": {k: row[k] for k in ("B", "S", "Hq", "Hkv", "D", "N", "V")
                          if k in row},
                "ms": row[ms], "plain_ms": row[plain], "bound_ms": row[bound],
                "library_ms": row[lib] if lib else None,
                "max_abs_err": max(row[e] for e in errs)}
    for entry in kernels:  # phase 23 (e)-(i): the ring's kernels and the plain ones
        key = counter_of.get(entry["name"], entry["name"])
        if key in PARALLEL_COUNTERS:
            entry["launches_parallel_ranks"] = [_parallel_launches(r["parallel"], key)
                                                for r in gossip["ranks"]]
    for entry in kernels:  # phase 23 (j): TP serving's prefill and decode, a rank
        tp_runs = [{label: r["tp_serve"][label]["launches"].get(entry["name"], 0)
                    for label, _ in TP_SERVE_RUNS} for r in gossip["ranks"]]
        if any(any(v.values()) for v in tp_runs):
            entry["launches_tp_serve_ranks"] = tp_runs
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
