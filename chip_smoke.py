#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits nonzero:

1. Environment: the card's name and power limit; build every CUDA kernel
   of the port from csrc/ (one nvcc per source, started together).
2. The ragged paged-attention kernel against its plain PyTorch version at
   the serving path's shapes (GPT-1.3B: heads 16, head_dim 128, block 16,
   batch 8; step widths 1, 5 and 128), in float32 (TF32 off, tolerance
   1e-3) and bfloat16 (tolerance 2e-2), over a float arena and over an
   int8 arena with its float32 scales, with the kernel's, the plain
   version's and one PyTorch library call's device times (CUDA-graph
   replays) beside the least time the card could take, and the kernel's
   eager per-call time. Each case names the kernel design it ran (bf16 at
   this shape: the sm_90a design, its split-row and, at width 128,
   wide-row kernels with ptxas's registers and spill bytes; float32: the
   SIMT design). Then bf16 again at 8 heads, a tp=2 rank's share of
   gpt_1p3b (phase 3h), over both arenas at the three widths.
   2b. The int8 append kernel (csrc/kv_quantize_scatter.cu) against its
   plain version (run on the CPU copy, bit-equal to the JAX function) at
   the serving shape (B 8, H 16, D 128, block 16; widths 1, 5 and 128;
   bf16 and f32 K/V; fresh blocks, growing and holding scales, a prefix
   row, padded rows, an idle lane): bit-equal outside the null block,
   with the kernel's and the plain version's device times and the bound
   (the bytes this case's blocks need: a fresh block is written whole, a
   grown scale's block read where no new token lands and written whole,
   a held scale's block written at the new tokens alone).
3. Serve: gpt_1p3b in bf16 (random weights from a seed) behind
   LLMEngine(block_size=16, max_batch=8, spec_decoding=True, warmup=True)
   answers 8 greedy requests of 64-1000 prompt tokens, four sharing a
   256-token prefix, 32 new tokens each. Warmup captures one CUDA graph
   per width bucket (1, 5, 128); no program is built during the wave and
   every step replays one. The kernels' launch counts (kept through
   replays by the step programs) are set to 0 just before and read just
   after; every kernel must have run once per layer and step, with one
   host sync per step and an idle pool after; the ragged launches are
   also reported by step width, the replays by bucket, the warmup's
   seconds, and the device busy share (CUDA events around every step's
   copy-in and replay, over the wave's wall time; recorded from the host,
   so a host gap inside the pair counts as busy: an upper bound).
   3b. The same with kv_dtype="int8": every ragged launch is the int8
   variant, and the append kernel runs for K and V in every layer and
   step.
   3c. The overcap pair (bench.py's int8 overcap wave): one byte budget of
   12 bf16 blocks, block 16, max_seq_len 128, max_batch 4, 8 prompts of
   96 tokens, 8 new tokens, served from a bf16 and from an int8 arena;
   blocks, bytes a block, preemptions, tok/s and the greedy parity rate.
   The int8 arena must hold at least 1.9x the blocks.
   3d. The bf16 and the int8 waves again, each on a fresh engine whose
   steps run their program's body eagerly (the staged inputs copied in,
   then `body()`): greedy tokens equal to phase 3's and 3b's graph
   replays, token for token.
   3e. The HTTP front door on phase 3's model and prompts:
   `ServingServer` (loopback, ephemeral port) over `AsyncLLMEngine` over
   LLMEngine(block_size=16, max_batch=8, spec_decoding=True, warmup=True,
   trace=1.0, slo=True, postmortem_dir=<tmp>), 32 greedy tokens a
   request. The 8 prompts one at a time (SSE and full responses in turn)
   give the tokens of a second engine of the same build driven by
   `step()` alone. Then all 8 at once through the server (4 streamed,
   two tenant/priority classes), with the ragged launches set to 0 just
   before and read just after (24 a step), no program built,
   `jit_retraces` 0, one host sync a step, the pool idle. Then the timed
   comparison, on the direct engine and through the server in turns
   (direct, HTTP, HTTP, direct, direct, HTTP): each wave the 8 prompts 32
   times over (256 requests), 16 live at once (a finished request's
   client sends the next), with the HTTP waves held to the same checks;
   each wave's tok/s, TTFT p50 (engine side; over HTTP also client side)
   and host ms inside steps, and their medians beside phase 3's. Then one
   wave of 32 requests each way under torch.profiler: the device busy
   share is the union of the card's kernel and copy intervals over the
   wave's wall. Then `/healthz`, `/metrics` (lifecycle, mesh, step and
   `slo_*` families), `/debug/trace` (step phases plan, build, dispatch,
   sync, emit) and `/debug/slo` (one class per one sent). Then a
   wave with a non-finite row pinned to one request (that request alone
   ends in error, one postmortem bundle) and a wave with a raising step
   (the supervisor's bisection recovers it; every request completes);
   `jit_retraces` stays 0; a drain leaves the lifecycle `stopped`.
   3f. The rest of single-card serving on phase 3's model, every engine
   LLMEngine(block_size=16, max_batch=8, spec_decoding=True, warmup=True)
   plus the feature, each wave with the kernels' counts set to 0 just
   before and read just after (one ragged launch a layer and step, int8
   appends two; no program built, one host sync a step, the pool idle):
   LoRA (lora_slots=3, lora_rank=8; adapter alpha at rank 8, alpha 16,
   beta at rank 4, alpha 8): phase 3's prompts split base / alpha / beta
   in one wave, base lanes equal to phase 3's tokens and an adapter lane
   different, tok/s beside phase 3's, the delta's device ms a step by
   width (gather, products); phase 3's traffic on a second LoRA engine,
   bit-identical to phase 3; one request naming alpha over HTTP equal to
   the same request by step(); float32 (TF32 off, 4 layers) against an
   engine over the merged weights, token parity >= 0.9. The host tier
   (num_blocks=80, host_kv_blocks=256), float and int8 arenas: a
   1024-token document with two tails cold, device-warm, churned out of
   the device, host-warm, tokens equal in every state and swaps both
   ways; TTFT p50 of each state, swap-out and swap-in GB/s, the busy
   share of a profiled host-warm serve, an export imported by a second
   engine that serves host-warm, and /debug/kvtier equal to the pool's
   tier fields. AdaRound (quantize="int8", 40 iterations, 4 calibration
   prompts of 24 tokens) on a second gpt_1p3b of the same seed, after the
   flash forward at S 24 against its plain version: calibration seconds
   and flash launches (one a layer and prompt), held-out NLL within 0.05
   of the bf16 model's, greedy parity >= 0.9 against phase 3, the
   embedding and norms unchanged, block 0's fc1 on the int8 grid up to
   bf16's rounding of q * s.
   3g. Weights from disk and the replica fleet, on phase 3's model. The
   port's `save_sharded_model` writes it to a temporary directory (bytes,
   seconds, GB/s; removed at the end). `skeleton_init()` builds gpt_1p3b
   on the meta device; replicas are LLMEngine(skeleton, checkpoint_path=
   dir, block_size=16, max_batch=8, spec_decoding=True, warmup=True,
   host_kv_blocks=256), each streaming the weights leaf by leaf onto the
   card (load seconds, GB/s, warmup seconds a replica). Gates: the load
   report's total bytes are the model's parameter bytes and all of them
   landed on the card, the host staged at most the largest leaf (wte,
   206,045,184 bytes), phase 3's traffic on a streamed replica gives
   phase 3's graph tokens exactly, param_hbm_bytes at the model's bytes
   builds and one byte below raises the JAX engine's message. Then
   `RouterServer` over `ReplicaRouter` (two streamed replicas, the
   factory streaming a new one) and a one-replica `ServingServer` take a
   shared-prefix wave (64 greedy requests over 8 system prompts of 256
   tokens with 16-64-token suffixes, 32 new tokens, 16 in flight) in
   turns F S S F F S, after 16 of them one at a time through the fleet
   (tokens equal to a direct engine's one at a time: with 16 in flight a
   row's steps take the width bucket of whatever shares them, so those
   waves' agreement with a direct engine is counted, not gated); every
   request on its affinity home but for diversions (counted), launches
   one a layer and step; tok/s, TTFT p50 and a profiled wave's CUPTI
   busy share each side, and the prefix hit rate of a wave of unseen
   prompts each side and through the fleet with affinity off. Then `rolling_drain()`
   under a continuous wave (16 clients): each restart streams and
   captures on a worker thread while the other replica serves; zero
   failed requests, migrated blocks > 0, and a probe prompt sent cold on
   r0 just before comes back host-warm after (swap-ins, the same
   tokens); restart seconds, the longest gap between tokens during a
   restart. Then one replica under `AutoScaler(min_replicas=1,
   max_replicas=2, cooldown_s=1, wait_high_s=0.2)`: a 64-client burst
   spawns a replica
   (spawn seconds, spawn TTFT), idle retires it; no failed request, and
   `torch.cuda.memory_allocated()` read right after the scale-down (one
   gc.collect(), no wait) within 64 MiB of its value before the spawn,
   itself read right after an earlier retire.
   3h. Tensor-parallel serving at tp=2 on the one card: two ranks on
   cuda:0 over an explicit gloo backend (NCCL refuses two ranks on one
   device), steps run eagerly, every collective staged through host
   memory. (a) gpt_1p3b in float32 (TF32 off) under phase 3's build and
   traffic at tp=1 (graphs) and at mesh=2: every request's greedy tokens
   equal (at a divergence the one-card model's top-2 logit gap is printed
   before the gate fails); on each rank one ragged launch a layer and
   step and 49 all-reduces and 1 all-gather a step
   (`serving_collective_budget`). (b) Phase 3's bf16 model saved with
   `save_sharded_model` and streamed per rank (each rank's load report:
   its slices only) into a tp=2 engine with kv_dtype="int8" and
   quant_allreduce=True: on each rank 24 int8 ragged launches, 48 appends,
   1 all-reduce and 97 all-gathers a step (gates); its tokens' agreement
   with phase 3b's tp=1 int8 tokens, counted. Seconds and tok/s are
   labelled "eager, gloo through the host, two ranks on one card - not a
   tp speed", the card's name and power limit beside them. The NCCL path
   with graphs needs two cards: the card test
   `test_tp2_nccl_graphs_token_identical_to_tp1` (it skips on one).
   3i. Tensor-parallel replicas behind the fleet router: gpt_1p3b in
   float32 (TF32 off) cut to 4 layers (widths full), two replicas at tp=2
   (four ranks on cuda:0 over gloo, phase 3h's build) behind
   `RouterServer`. Phase 3's 8 prompts over HTTP one at a time equal a
   one-card engine's greedy tokens (each request alone on both sides);
   every rank of both replicas makes one ragged launch a layer and step
   and `serving_collective_budget`'s calls a step (counts zeroed just
   before the wave and read just after; both replicas' rank 0 is this
   process). The second replica joins the router while the first serves
   (`add_replica`); then it is retired: its rank process ends (and with
   it that rank's card memory), this process's allocated memory returns
   within 64 MiB of its figure before that replica was built (a serving
   thread's cuBLAS workspace, ~33 MiB, outlives it; the card's free
   memory beside it), the retired engine object is collected after a gc
   pass, and the other replica serves phase 3's first prompt with the
   same tokens. Seconds labelled as phase 3h's.
4. float32 parity: gpt_1p3b widths at 4 layers, greedy LLMEngine (the
   kernel, through captured graphs) against GPT.generate (contiguous
   cache, no kernel).
   4b. The int8 engine on the card against the int8 engine on a CPU copy
   (the plain version): at least 90 % of the greedy tokens equal.
5. The flash-attention kernels (forward; dK/dV and dQ) against the plain
   version (`attention_ref` in float32 on the same values, and autograd's
   gradients) at the training shape (B 16, H 8, S 1024, D 128, causal) in
   bfloat16 (tolerance 2e-2) and in float32 at B 2 (TF32 off, 1e-3, and
   every float32 error also within 2e-5: the 3xTF32 kernels must keep f32
   accuracy), comparing O, LSE, dQ, dK and dV; with the kernels', the
   plain version's and scaled_dot_product_attention's device times (its
   forward and its forward + backward graph-replayed like the kernels)
   beside the least time the card could take (the float32 kernels' bound
   is their 3xTF32 design's, three TF32 passes a product on the tensor
   cores, with the FMA units' bound beside it). The float32 record names
   each kernel's design, as the comment above the kernel in
   flash_attention.cu states it, and ptxas's registers and spill bytes
   for the eight f32 instantiations; a spill in the forward's fails the
   run.
   5b. The flash kernels' additive-mask and dropout variants against the
   plain version on the same values, mask and seed (the same Philox keep
   bits), q/k/v being strided views of a fused projection as in the
   models: the ERNIE step's shape (B 32, S 512, H 12, D 64, non-causal,
   [B, 1, 1, S] padding mask, p 0.1) in bfloat16 with mask and dropout,
   mask alone, dropout alone and neither; causal dropout at the flagship
   shape; float32 mask + dropout at B 2 (TF32 off). Times beside SDPA
   with the same mask and dropout_p (graph-replayed) and the least time
   the card could take (float32's: 3xTF32, the FMA units' beside it).
   Then an mp=2 rank's share (phase 6e): the flagship step's rank
   (4 x 1024, heads 4-7 of 8, causal, without and with dropout), ERNIE's
   (32 x 512, heads 6-11 of 12, mask + dropout) and float32 (2 x 512, 6 of
   12): the kernels' dropout bits at the heads' model coordinate
   (`head_offset`), against the plain version at the same offset and
   against the same heads of one call over all of the model's heads.
   And a pipelined gpt_1p3b stage's share at pp2 x mp2 (phase 6f (b)):
   float32, 2 x 1024, heads 0-7 and 8-15 of 16, D 128, causal.
6. Train: the flagship GPT (vocab 32768, hidden 1024, 12 layers, 8 heads,
   seq 1024; bench.py's bench_gpt) in bf16 with AdamW(1e-4), batch 16 x
   1024 from np.random.RandomState(0): one warm-up step, then 10 timed
   steps. The flash launch counts are set to 0 just before the timed
   steps and read just after: 12 forward and 12 backward launches a step.
   Losses finite and falling (the same batch each step).
7. float32 train parity: the flagship widths at 2 layers, batch 2, seq
   256, TF32 off: two AdamW steps on the card (kernels) and on a CPU copy
   (plain attention) give the same losses and parameters; then one step
   of a pair with remat=True (2 forward launches a layer on the card).
8. ERNIE-base pretrain: ernie_base (hidden 768, 12 layers, 12 heads,
   vocab 40000) in bf16, dropout 0.1, AdamW(1e-4, weight decay 0.01),
   batch 32 x 512 with per-row real lengths uniform in 256-512 and an
   additive padding mask, MLM labels at 15 % of real positions: one
   warm-up step, then 10 timed steps. Counts set to 0 just before the
   timed steps: 12 forward and 12 backward launches a step, every one the
   mask + dropout variant; losses finite, the mean of the last 3 below the
   first. tokens/s (all and real), step p50, MFU and peak memory.
   8b. The flagship GPT with dropout 0.1 for 3 steps: finite losses and
   12 + 12 dropout launches a step.
9. float32 ERNIE parity: ERNIE widths at 2 layers, batch 2, seq 128,
   padding mask, dropout 0, TF32 off: two AdamW steps on the card and on
   a CPU copy give the same losses and parameters (phase 7's rule); then
   one step of a pair with remat=True.
6c. The training surface (run last: it sets its figures beside phases 6
   and 8). (a) The flagship GPT with remat=True, built in float32 and put
   through amp.decorate(level="O2") (bf16 parameters, float32 masters),
   AdamW(weight decay 0.01) with the learning rate of
   LinearWarmup(CosineAnnealingDecay(1e-4, T_max=100), 5 warm-up steps
   from 0) and ClipGradByGlobalNorm(1.0), batch 16 x 1024, each step an
   InstrumentedStep under enable_train_tracing(): one warm-up step, then
   10 timed steps, each under torch.cuda.set_sync_debug_mode("error")
   but for the loss read, scheduler.step() after each. Held to: finite,
   falling losses; 24 forward (12 recomputed) and 12 backward flash
   launches a step (counts set to 0 just before the timed steps);
   the float32 lr the step's update applied (opt._last_lr) equal to the
   scheduler's value read before the step; every parameter bf16 and
   equal bit for bit to its float32 master's rounding after every step;
   a finite pre-clip global norm; 11 train_step spans each with a
   dispatch child, valid Chrome JSON. Step p50, tokens/s, MFU (model
   FLOPs) and peak memory, beside the same O2 run without remat (3 timed
   steps) and phase 6's. (Every training phase's peak_mem_gib includes
   its base_mem_gib: what earlier phases left allocated as it began.) (b) ernie_base with remat=True, phase 8's batch
   and dropout, 3 counted steps: 24 + 12 launches a step, all mask +
   dropout; peak memory beside phase 8's. (c) Remat against itself on the
   card, float32, TF32 off, dropout 0.1: one step of the flagship widths
   at 2 layers (batch 2, seq 256) and of ERNIE's at 2 layers (batch 2,
   seq 128, padding mask), remat and not, from the same weights and
   dropout seeds: the same loss, gradients within 1e-5, the same
   generator states after. (d) GradScaler(init_loss_scaling=2**15) on a
   bf16 O2 flagship at 2 layers (batch 4): a step that steps, then one
   with an inf planted in a gradient: skipped (parameters and masters
   unchanged bit for bit), the scale halved; one host sync a scaler.step
   (unscale_'s, counted in set_sync_debug_mode("warn")).
6d. ZeRO data-parallel training at dp=2 on the one card (run last, after
   gc.collect() and torch.cuda.empty_cache()): two ranks on cuda:0 over an
   explicit gloo backend (NCCL refuses two ranks on one device), eager,
   every collective staged through host memory; every time is labelled
   "eager, gloo through the host, two ranks on one card - not a dp speed"
   beside the card's name and power limit. (a) float32 (TF32 off), the
   flagship widths at 2 layers, batch 4 x 256, AdamW: zero stages 0, 2
   and 3 for 3 steps give the same losses and gathered parameters bit for
   bit; stage 0 equals one process on the whole batch within 1e-5;
   gradient_merge_k=2 over 4 steps at stage 2 equals stage 0 with k=2;
   each rank's collective calls a step equal train_collective_budget(28,
   2). (b) The flagship at full width built in f32 through
   amp.decorate(level="O2"), AdamW(1e-4, weight decay 0.01), 16 x 1024 (8
   rows a rank): stage 2, then 3, one warm-up and 3 counted steps each
   (counts set to 0 just before and read just after): finite, falling
   losses; 12 + 12 flash launches a step on each rank; budget(148, 2) a
   step; each rank's optimizer state <= 0.51x the unsharded figure
   (computed from the same leaves), stage 3's resident parameters <=
   0.51x the model's; each rank's peak memory, step seconds and the
   step's phases (CUDA events). (c) (b)'s stage 2 with quant_grads=True:
   296 all-to-alls and 0 reduce-scatters a step, finite falling losses,
   the greatest drift from (b)'s stage-2 losses printed. (d) ERNIE-base
   Sharding-2: phase 8's cell through group_sharded_parallel(level="os_g")
   and make_sharded_train_step(zero_stage=2), 16 rows a rank, one warm-up
   and 3 counted steps: 12 + 12 mask + dropout launches a step on each
   rank, budget(157, 2), optimizer state <= 0.51x, the mean of the last 2
   losses below the first, tokens/s all and real. (e) A rank that raises
   (an operation it cannot run) makes the next step raise RankFailed
   within the mesh's 60 s timeout; a new mesh then trains.
6e. dp x mp hybrid training on the one card (run last): ranks on cuda:0
   over an explicit gloo backend, eager, every collective staged through
   host memory; every time is labelled "eager, gloo through the host,
   ranks sharing one card - not an mp speed" beside the card's name and
   power limit. (a) float32 (TF32 off), 3 AdamW(1e-4) steps from one set
   of weights: the flagship widths at 2 layers (batch 4 x 256) over
   {"mp": 2} and {"dp": 2, "mp": 2} against one process on the whole
   batch (losses within 1e-5 relative, every parameter entry within
   Adam's 2 * steps * lr); dropout 0.1 over {"mp": 2} against one process
   at the same seeds (through the kernels' head offset); ERNIE's widths at
   2 layers (12 heads, 6 a rank; batch 4 x 128, padding mask, dropout
   0.1) likewise. (b) The flagship at full width built in float32 through
   amp.decorate(level="O2"), AdamW(1e-4, weight decay 0.01) with
   ClipGradByGlobalNorm(1.0), over {"mp": 2}, batch 4 x 1024 on both
   ranks: one warm-up and 3 counted steps; finite, falling losses, 12 +
   12 flash launches a step on each rank at 4 heads, each rank's
   collective calls a step against the arithmetic (`_mp_budget`: 54
   all-reduces), parameter and optimizer bytes a rank <= 0.55x the
   model's and the unsharded figure, peak memory, step seconds. NCCL
   across cards is the card test `test_mp2_nccl_equals_one_process` (it
   skips on one).
6f. Pipeline-parallel training and the rest of the optimizer surface on
   the one card (run last, after gc.collect() and
   torch.cuda.empty_cache()): ranks on cuda:0 over an explicit gloo
   backend, eager, every collective and stage-to-stage hand-off staged
   through host memory; every time is labelled "eager, gloo through the
   host, ranks sharing one card - not a pp speed" beside the card's name
   and power limit. (a) float32 (TF32 off), the flagship widths at 4
   layers, batch 8 x 256 in M 4 microbatches, SGD lr 0.1, 3 steps from one
   set of weights (`models/gpt_pipeline.py`): {"pp": 2} GPipe, 1F1B and
   interleaved (V 2), {"pp": 2, "mp": 2} 1F1B, each against the
   one-process model (losses within 1e-5 relative, every parameter within
   1e-5 relative to its norm), each rank's sends, receives and
   all-reduces a step against the arithmetic (`_pp_budget`) and 2 x M
   flash launches each way. Then `HybridParallelGradScaler` over {"pp":
   2}: an inf planted in stage 1's gradient makes both stages skip
   (weights unchanged bit for bit, the scale halved). (b) BASELINE config
   3 at full width: gpt_1p3b's widths (vocab 50304, hidden 2048, 24
   layers, 16 heads, FFN 8192) in float32 over {"pp": 2, "mp": 2} (12
   layers and 8 heads a rank), 1F1B, batch 8 x 1024 in 4 microbatches of
   2 rows (a cut from a production batch), SGD lr 0.05: one warm-up and 3
   counted steps on the same batch; finite, falling losses, 48 + 48 flash
   launches a step on every rank, `_pp_budget` a step, each rank's
   parameter bytes exactly its share; each rank's peak memory, step
   seconds and phases (forward, backward, p2p, mp all-reduce, dp
   reduction, tied-embedding sum, update; CUDA events). Then one step each
   at M 8 with GPipe and with 1F1B: stage 0's peak memory under 1F1B
   below GPipe's. (c) Adamax, Adagrad, Adadelta, RMSProp, DGCMomentum,
   Lars and Lamb, one step each on the flagship widths at 2 layers from
   the same weights and gradients on the card and on a CPU copy, each
   tensor's gap within 1e-5 of the rule's own step (1e-3 for Lars and
   Lamb); Lamb on the explicit ZeRO stage-2 path at dp=2, its first step
   within 1e-3 of Lamb's own step against whole-tensor Lamb with dp's
   gradient and against one process (float-noise gradients aside), while
   the update without its norm all-reduce is at least 0.1 away; losses
   within 1e-5. NCCL across cards is the card
   test `test_pp2_nccl_equals_one_process` (it skips on one).
6g. Sequence-parallel training on the one card (run last): ranks on
   cuda:0 over an explicit gloo backend, eager, every ring hop and
   all-reduce staged through host memory; every time is labelled "eager,
   gloo through the host, ranks sharing one card - not an sp speed"
   beside the card's name and power limit. (a) The ring's steps
   (parallel/ring_attention.py) for every rank of a ring of 2 and of 4 in
   one process at gpt_1p3b's attention shape (1 x 2048, 16 heads, D 128,
   causal), float32 and bfloat16, against one flash call over the whole
   sequence: O, dQ, dK, dV within 2e-5 / 2e-2, i + 1 forward and backward
   launches on rank i, no host sync in the steps. (b) gpt_1p3b's widths
   (vocab 50304, hidden 2048, 16 heads, FFN 8192) at 4 layers
   (`SP_RING_LAYERS`) at its 2048 context in float32 with ring attention,
   2 rows, over {"sp": 2}, SGD 0.1, 3 steps against the same model in one
   process: losses within 1e-5 relative, parameters within 1e-5 relative
   to their norm; each rank's sends, receives and all-reduces a step
   equal `sp_collective_budget`, 4 x (i + 1) flash launches of each
   direction a step on sp rank i, no host sync beyond the budget's and
   the step's own three; each rank's step phases (forward and backward
   with their ring hops, the gradient all-reduce, the update), peak
   memory and seconds. (c) The flagship widths at 2 layers, float32, ring
   attention, 4 rows over {"dp": 2, "sp": 2} (four ranks) against one
   process, the same gates. (b)'s and (c)'s ranks start together after
   (a); the card's free memory is back within 64 MiB once they are gone.
   `--only 6g` builds the kernels and runs this phase alone.
6h. Expert parallelism and incubate's fused functionals (run last; `--only
   6h` runs it alone). (a) MoELayer(2048, 8192, 8, "switch") (gpt_1p3b's
   hidden and FFN widths) at x [8, 1024, 2048]: its indexed dispatch and
   combine against the dense einsum form on the same weights, out, aux
   and every gradient within 1e-5 relative in f32 (TF32 off) and 2e-2 in
   bf16; at capacity factor 0.5 the dropped count equals the overflow and
   dropped tokens output zero; forward and backward times split into
   dispatch, expert products and combine, and peak memory. (b)
   Linear(2048, 2048) -> that layer -> Linear(2048, 2048), MSE, f32, SGD
   0.1, 3 steps on 4 x 1024 rows over {"mp": 2}, {"dp": 2, "mp": 2} and
   {"sharding": 2, "mp": 2} at stage 2 (ranks on cuda:0 over gloo,
   labelled "not an ep speed"), at capacity factors 1.25 and 0.5, against
   one process: losses within 1e-5 relative, parameters within 1e-5 of
   their norm, each rank's calls a step equal `moe_collective_budget`,
   each rank 1/mp of the experts' bytes; each rank's peak and step
   phases. (c) `moe_alltoall_block` on four ranks (E 8, two a rank, H
   2048, F 8192, T 4096 a rank): O and the experts' gradients within 1e-5
   relative of the dense form over every rank's tokens, two all-to-alls
   each way a rank. (d) `fused_multi_head_attention` at ERNIE-base's
   shape (32 x 512, 768, 12 heads, padding lengths 256-512, post-LN)
   against flash's plain version on the card: 1e-5 (f32) and 2e-2 (bf16)
   at dropout 0; at dropout 0.1 the same values under one seed and one
   mask + dropout launch of each direction a call; bf16 times beside the
   same function over torch's SDPA.
6i. Sequence parallelism without a ring (run last; `--only 6i` builds the
   kernels and runs it alone): ranks on cuda:0 over an explicit gloo
   backend, every time labelled "eager, gloo through the host, ranks
   sharing one card - not an sp speed" beside the card's name and power
   limit. (a) Gathered attention's share of every rank of n = 2 and 4
   (parallel/sequence_attention.py `rank_forward`, `rank_backward` on the
   gathered K/V layout) in one process, against one flash call over the
   whole sequence sliced to the rank (O, dQ; dK and dV after summing the
   ranks' partials), at gpt_1p3b's attention shape (1 x 2048, 16 heads, D
   128, causal, dropout 0 and 0.1) and ERNIE-base's (32 x 512, 12 heads,
   D 64, padding lengths 256-512, dropout 0.1), f32 and bf16: within 2e-5
   / 2e-2 beyond one bf16 ulp; each rank's O, LSE, dQ and dK/dV partials
   against the f32 plain version at its q_row0, key prefix, mask and seed
   within 2e-5 / 2e-2 (the rows' max_abs_err); at dropout 0.1 the plain
   keep bits at the rank's q_row0 equal the whole call's rows bit for
   bit; one forward and one dK/dV + dQ launch a rank, no host sync; each
   call's bound, and at n = 2 its kernel times beside SDPA's on the same
   call (an explicit mask). (b)
   ERNIE-base at sequence 512, 8 rows, f32, over {"sp": 2}, SGD 0.1, 3
   steps, at dropout 0 and 0.1, against one process: losses within 1e-5
   relative, parameters within 1e-5 of their norm, each rank's calls a
   step `sp_collective_budget(..., bert=True)`, 12 + 12 flash launches a
   step a rank, host syncs within the budget's; each rank's phases, peak
   and seconds. (c) gpt_1p3b's widths at its 2048 context with
   attn_impl="flash", 2 layers (`GATHERED_GPT_LAYERS`), f32, 2 rows,
   over {"sp": 2}, the same gates (2 + 2 launches a step on both ranks:
   rank 1's whole prefix in one call). (b) and (c) share the two ranks; the card's free memory is
   back within 64 MiB once they are gone.
6j. Sequence parallelism beside tensor parallelism and ZeRO (run last;
   `--only 6j` builds the kernels and runs it alone): ranks on cuda:0
   over an explicit gloo backend, every time labelled "eager, gloo
   through the host, ranks sharing one card - not an sp or mp speed"
   beside the card's name and power limit. (a) Every (mp, sp) rank's
   gathered launches at n = 2 sp ranks by 2 head groups in one process
   (`head_offset` and `q_row0` together), at gpt_1p3b's attention shape
   (1 x 2048, 8 of 16 heads a rank, D 128, causal, dropout 0 and 0.1) and
   ERNIE-base's (32 x 512, 6 of 12 heads, padding lengths 256-512,
   dropout 0.1), f32 and bf16: each rank's O, LSE, dQ and dK / dV
   partials against the f32 plain version at its heads, rows, key prefix,
   mask and seed within 2e-5 / 2e-2; the plain keep bits at its heads and
   rows equal the whole call's slice bit for bit; one forward and one
   dK/dV + dQ launch a rank, no host sync; every call's bound, rank (1,
   1)'s kernel, SDPA and plain times. (b) gpt_1p3b's widths at its 2048
   context, 2 layers, 2 rows, f32, SGD 0.1, 3 steps over {"sp": 2, "mp":
   2} against one process: attn_impl="flash" at dropout 0.1, the same
   with the step's remat, and "ring" at dropout 0: losses within 1e-5
   relative, parameters within 1e-5 of their norm, each rank's calls a
   step `hybrid_collective_budget`'s (remat's term included) and its host
   syncs within them, 2 + 2 flash launches a step a rank (4 forward under
   remat; the ring 2 (i + 1) each way on sp rank i); the card's free
   memory back within 64 MiB once the ranks are gone. (c) ERNIE-base at 8
   x 512, f32, dropout 0.1, over {"sharding": 2, "sp": 2} at ZeRO stage 2
   (rows over dp and sharding, the mask whole on the sp ranks), AdamW(1e-4,
   weight decay 0.01), 3 steps, against the same rows over {"dp": 2} (a
   row share's masks key on its index, so no one process draws them):
   the loss gate, Adam's moments and every leaf but the biases within
   1e-5 of their norm, a bias (it starts at zero) entry by entry within
   Adam's 2 x steps x lr, the key biases' float-noise gradient held
   apart, the budget, 12 + 12 mask + dropout launches a step a rank, each
   rank's optimizer bytes half of one process's. The meshes' ranks start
   together after (a). (d)
   LocalSGD (k 2, 4 steps) of the flagship widths at 2 layers, f32, 4 x
   1024 over {"dp": 2, "sp": 2} against LocalSGD over {"dp": 2}: losses
   and every replica's parameters within 1e-5.

Prints a `{"kernels": [...]}` line (the flash rows also name the bf16
kernel's design and ptxas's registers and spill bytes for it; a spill in
either dQ row's instantiation fails the run; the pp_stage rows the f32
kernel's, with the FMA units' bound beside the 3xTF32 one), the
nvidia-smi name/power-limit line, and last `{"ok": true, "device":
{...}}`.
"""
import argparse
import asyncio
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H, D, BS, B = 16, 128, 16, 8             # gpt_1p3b heads/head_dim, serving
WIDTHS = (1, 5, 128)                      # decode, 1 + num_spec, chunk
TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
F32_FLASH_TOL = 2e-5      # phases 5 / 5b: the f32 flash kernels' accuracy
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32 = 495e12        # dense TF32 on the tensor cores


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters):
    """Device time of one `fn` call: `iters` calls captured in a CUDA
    graph, the graph replayed between two CUDA events. Host launch cost
    stays out (an eager call of a small kernel waits on its Python
    wrapper, not on the card). The warm-up call runs on a side stream, as
    a graph that runs autograd (SDPA's backward) needs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def event_ms(fn, iters):
    """Device time of one eager `fn` call between two CUDA events (for
    calls too large for their launch cost to matter, or that a graph
    cannot capture, such as autograd's backward)."""
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


def eager_ms(fn, iters):
    """Wall time of one eager `fn` call, host launch cost included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


# -- phase 1 ------------------------------------------------------------------

def build_kernels():
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.ops import _build

    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        list(ex.map(_build.load_library, sources))
    log(f"[build] {len(sources)} source(s) in "
        f"{time.perf_counter() - t0:.1f} s: {sources}")
    for s in sources:
        for line in (_build.build_log(s) or "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {s}: {line.strip()}")


def ptxas_report(source, entry):
    """ptxas's report on one kernel of `source`'s build: (registers,
    spill-store bytes) of the first entry function whose mangled name
    contains `entry`. With setmaxnreg, the registers are the count at
    entry (65536 / 384 = 168 for the three-warpgroup kernels; the
    consumers then take 240 and the producer gives up to 24)."""
    from paddle_tpu_torch.ops import _build

    lines = (_build.build_log(source) or "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            regs = spill = None
            for nxt in lines[i + 1:i + 5]:
                m = re.search(r"(\d+) bytes spill stores", nxt)
                spill = int(m.group(1)) if m else spill
                m = re.search(r"Used (\d+) registers", nxt)
                regs = int(m.group(1)) if m else regs
            return regs, spill
    raise SystemExit(f"no ptxas report for {entry} in {source}'s build")


# -- phase 2 ------------------------------------------------------------------

RPA_DESIGNS = {
    "sm90": "sm90: split rows (q_len <= 8) on mma.sync, 4 warp pipelines of "
            "16-key TMA stages, 256-key splits, PDL merge; wide rows wgmma "
            "64 queries x 64-key TMA ring",
    "simt": "simt v6: f32 shared tiles, 8-query tiles, 64-key chunks, "
            "split-KV + merge"}


def rpa_kernels(design, dtype, int8, width):
    """The sm_90a kernels a phase 2 case runs, with ptxas's (registers,
    spill-store bytes) for each; empty for the SIMT design."""
    if design != "sm90":
        return {}
    ta = "a" if int8 else "13__nv_bfloat16"
    names = ["split"] + (["wide"] if width > 8 else [])
    return {n: ptxas_report("ragged_paged_attention.cu",
                            f"rpa_{n}_sm90I{ta}E") for n in names}


def _case(width, gen, n_blocks, dtype, dev, heads=H):
    """A mixed batch at step width `width` over `heads` heads: decode rows,
    a prefill chunk crossing block boundaries, partly filled last blocks,
    an idle lane (null block only), null-block table padding. Contexts
    64-1000 tokens like the serving phase's prompts."""
    nb = 2048 // BS
    rs = np.random.RandomState(width)
    ctx = rs.randint(64, 1001, B)
    ctx[1] = 16 * 40 + 7            # partly filled last block
    if width > 1:
        q_lens = rs.randint(1, width + 1, B)
        q_lens[2] = width           # a full-width row
        q_lens[3] = 1               # a decode row
    else:
        q_lens = np.ones(B, np.int64)
    if width == 128:
        ctx[2] = 40 + 128           # chunk from position 40: crosses blocks
        ctx[4] = 128                # a fresh prefill chunk
    ctx = np.maximum(ctx, q_lens)
    ctx[B - 1], q_lens[B - 1] = 1, 1   # idle lane: walks the null block
    tables = np.zeros((B, nb), np.int32)
    perm = rs.permutation(np.arange(1, n_blocks))
    kv_live = (ctx - 1) // BS + 1
    o = 0
    for i in range(B - 1):
        tables[i, :kv_live[i]] = perm[o:o + kv_live[i]]
        o += kv_live[i]
    q_start = ctx - q_lens
    qpos = np.zeros((B, width), np.int32)
    for i in range(B):
        qpos[i, :q_lens[i]] = np.arange(q_start[i], ctx[i])
    to = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa
    q = torch.randn((B, width, heads, D), generator=gen,
                    device=dev).to(dtype)
    return dict(q=q, tables=to(tables), qpos=to(qpos), q_start=to(q_start),
                kv_live=to(kv_live), q_lens=to(q_lens), ctx=ctx,
                q_lens_np=q_lens, kv_live_np=kv_live)


def _bound(c, dtype, int8=False):
    """Least time for this case's work: the bytes it must move (each live
    query read and its output written once, each live row's `ctx` keys of
    K and V read once, an int8 arena's K and V scale for each live block
    and head, its live table entries and metadata), or the causal flops of
    its live queries. The idle lane (the last row), whose output is
    discarded, counts nothing."""
    isz = torch.tensor([], dtype=dtype).element_size()
    kv_isz = 1 if int8 else isz
    H = c["q"].shape[2]                              # this case's heads
    n = B - 1                                        # live rows
    ql, live, ctx = c["q_lens_np"][:n], c["kv_live_np"][:n], c["ctx"][:n]
    nbytes = (2 * ql.sum() * H * D * isz             # q in, out
              + 2 * ctx.sum() * H * D * kv_isz       # K and V, live keys
              + (2 * live.sum() * H * 4 if int8 else 0)  # their scales
              + live.sum() * 4 + 3 * n * 4)          # table entries, metadata
    flops = 0
    for i in range(n):
        keys = ctx[i] - ql[i] + 1 + np.arange(ql[i])  # causal keys per query
        flops += 4 * H * D * int(keys.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _library_call(c, k_arena, v_arena, layer, scales=None):
    """scaled_dot_product_attention on K/V gathered (and, from an int8
    arena, dequantized to q's dtype) beforehand into contiguous [B, H, L,
    D] with a boolean causal/ragged mask: the timed yardstick only, never
    used by the port."""
    F = torch.nn.functional
    H = c["q"].shape[2]
    L = int(c["kv_live_np"].max()) * BS
    bt = c["tables"][:, :L // BS].long()
    k, v = k_arena[layer][:, bt], v_arena[layer][:, bt]  # [H, B, nb, bs, D]
    if scales is not None:
        k, v = (a.float() * sc[layer][:, bt][..., None, None]
                for a, sc in zip((k, v), scales))
    k, v = (a.permute(1, 0, 2, 3, 4).reshape(B, H, L, D).to(c["q"].dtype)
            .contiguous() for a in (k, v))
    q = c["q"].transpose(1, 2).contiguous()
    kpos = torch.arange(L, device=q.device)
    mask = (kpos[None, None, None, :] <= c["qpos"][:, None, :, None])
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def kernel_cases():
    from paddle_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_layers, n_blocks, layer = 24, B * (2048 // BS) + 1, 17
    out = []
    # gpt_1p3b's 16 heads, then 8: a rank's share at tp=2 (phase 3h)
    for heads, arena, dtype in (
            (H, "float", torch.float32), (H, "float", torch.bfloat16),
            (H, "int8", torch.float32), (H, "int8", torch.bfloat16),
            (H // 2, "float", torch.bfloat16),
            (H // 2, "int8", torch.bfloat16)):
        # the serving arena's shape, random garbage in every slot
        shape = (n_layers, heads, n_blocks, BS, D)
        sc = {}
        if arena == "int8":
            k_arena, v_arena = (torch.randint(
                -127, 128, shape, generator=gen, device=dev,
                dtype=torch.int8) for _ in "kv")
            sc = dict(zip(("k_scale", "v_scale"), (
                torch.rand(shape[:3], generator=gen, device=dev) * 0.03
                + 0.002 for _ in "kv")))
        else:
            k_arena, v_arena = (torch.randn(shape, generator=gen, device=dev)
                                .to(dtype) for _ in "kv")
        for width in WIDTHS:
            c = _case(width, gen, n_blocks, dtype, dev, heads)
            args = (c["q"], k_arena, v_arena, layer, c["tables"], c["qpos"])
            meta = dict(q_start=c["q_start"], kv_live=c["kv_live"],
                        q_lens=c["q_lens"], **sc)
            got = pa.paged_attention_arrays(*args, **meta)
            want = pa.paged_attention_ref(*args, **sc)
            torch.cuda.synchronize()
            err = 0.0
            for i in range(B):
                n = int(c["q_lens_np"][i])
                if i == B - 1:
                    continue                    # the idle lane is garbage
                err = max(err, (got[i, :n].float() - want[i, :n].float())
                          .abs().max().item())
            ok = err <= TOL[dtype]
            kernel = lambda: pa.ragged_paged_attention(  # noqa: E731
                c["q"], k_arena, v_arena, layer, c["tables"], **meta)
            kms = time_ms(kernel, 50)
            pms = time_ms(lambda: pa.paged_attention_ref(*args, **sc), 5)
            lms = time_ms(_library_call(
                c, k_arena, v_arena, layer,
                (sc["k_scale"], sc["v_scale"]) if sc else None), 20)
            bms, by = _bound(c, dtype, int8=bool(sc))
            design = pa.kernel_design(dtype, D, BS)
            rec = dict(arena=arena, dtype=str(dtype).replace("torch.", ""),
                       heads=heads, width=width, design=RPA_DESIGNS[design],
                       ptxas={k: dict(registers=r, spill_bytes=sp)
                              for k, (r, sp) in rpa_kernels(
                                  design, dtype, arena == "int8",
                                  width).items()},
                       max_err=err, tol=TOL[dtype], kernel_ms=kms,
                       kernel_eager_call_ms=eager_ms(kernel, 50),
                       plain_ms=pms, library_ms=lms, bound_ms=bms,
                       bound_by=by, kv_blocks=int(c["kv_live_np"].sum()),
                       q_tokens=int(c["q_lens_np"].sum()))
            log("[kernel] " + json.dumps(rec))
            out.append(rec)
            if not ok:
                raise SystemExit(f"kernel disagrees with the plain version: "
                                 f"{rec}")
        del k_arena, v_arena, sc
        torch.cuda.empty_cache()
    return out


# -- phase 2b -----------------------------------------------------------------

def _append_case(width, dtype):
    """One serve step's int8 append at step width `width` (B 8, H 16, D
    128, block 16) over an arena of random payload and scales: a fresh row
    from position 0, rows appending small values (scale holds) and large
    ones (scale grows, payload requantized) to a partly filled block, a
    row after a shared prefix block, short rows padded to the width, an
    idle lane (every token to the null block). K is a strided view of a
    fused QKV projection, as in the model. Host metadata built as the
    engine builds it (`LLMEngine._fill_row`)."""
    from paddle_tpu_torch.serving import BlockPool

    rs = np.random.RandomState(width)
    starts = [0, 5, 7, 256, 3, 0, int(rs.randint(0, 400)), 531]
    counts = [width, width, width, width, max(1, width // 2), 0,
              max(1, width - 1), width]
    mags = [1.0, 0.01, 40.0, 2.0, 1.0, 1.0, 0.5, 8.0]
    per = [-(-(st + max(c, 1)) // BS) for st, c in zip(starts, counts)]
    N = 1 + sum(per)
    perm = rs.permutation(np.arange(1, N))
    pool = BlockPool(N, 2, BS, H, D, device="cpu", kv_dtype="int8")
    slots, offs, o = [], [], 0
    for st, c, n in zip(starts, counts, per):
        sl, of = pool.positions_to_slots(perm[o:o + n].tolist(), st, c,
                                         width)
        slots.append(sl)
        offs.append(of)
        o += n
    slots, offs = np.stack(slots), np.stack(offs)
    T = (width + BS - 2) // BS + 2
    touched = np.zeros((B, T), np.int32)
    touch_idx = np.zeros((B, width), np.int32)
    for i, (row, c) in enumerate(zip(slots, counts)):
        uniq = np.unique(row[:c][row[:c] != 0])
        touched[i, 1:1 + len(uniq)] = uniq
        lut = {int(b): j + 1 for j, b in enumerate(uniq)}
        touch_idx[i, :c] = [lut.get(int(x), 0) for x in row[:c]]
    fused = (rs.randn(B, width, H, 3, D)
             * np.asarray(mags)[:, None, None, None, None])
    t = torch.from_numpy
    return dict(
        arena=t(rs.randint(-127, 128, (2, H, N, BS, D)).astype(np.int8)),
        scales=t(rs.uniform(0.01, 0.05, (2, H, N)).astype(np.float32)),
        new=t(fused.astype(np.float32)).to(dtype),
        slots=t(slots), offs=t(offs), touched=t(touched),
        touch_idx=t(touch_idx), tokens=int(sum(counts)),
        blocks=int((touched != 0).sum()))


def _append_bytes(c, want_s, layer, isz):
    """The bytes the append must move for case `c`, from its own metadata
    and result: the live tokens read once and the metadata read once; for
    each touched (row, block, head), by what the step does to that block:
    fresh (a token at offset 0: the old payload counts for nothing) writes
    the whole block and its scale; a grown scale reads the positions no
    new token lands on and writes the whole requantized block, and reads
    and writes the scale; a held scale writes the new tokens' positions
    alone and reads the scale. The null block is scratch: nothing."""
    offs, touched = c["offs"].numpy(), c["touched"].numpy()
    touch_idx = c["touch_idx"].numpy()
    old = c["scales"][layer].numpy()
    grew = want_s[layer].numpy() != old                     # [H, N]
    n = (c["tokens"] * H * D * isz
         + (offs.size + touch_idx.size + touched.size) * 4)
    for i, t in zip(*np.nonzero(touched)):
        lanes = touch_idx[i] == t
        n_new, blk = int(lanes.sum()), touched[i, t]
        if (offs[i][lanes] == 0).any():                     # fresh
            n += H * (BS * D + 4)
            continue
        g = int(grew[:, blk].sum())
        n += g * ((2 * BS - n_new) * D + 8)
        n += (H - g) * (n_new * D + 4)
    return n


def append_cases():
    """Phase 2b: the int8 append kernel against its plain version run on
    the CPU copy (bit-equal to the JAX function; tests/test_torch_int8_kv)
    at the serve shape, widths 1, 5 and 128, bf16 and f32 input: bit-equal
    outside the null block, with the kernel's and the plain version's card
    times beside the least time the card could take. The plain version's
    own difference on the card is reported beside (`plain_on_card_err`)."""
    from paddle_tpu_torch.ops.kv_quantize_scatter import kv_quantize_scatter
    from paddle_tpu_torch.serving import block_pool

    dev, layer, out = torch.device("cuda"), 1, []
    for dtype in (torch.bfloat16, torch.float32):
        for width in WIDTHS:
            c = _append_case(width, dtype)
            want_a, want_s = c["arena"].clone(), c["scales"].clone()
            block_pool._quantize_scatter(
                want_a, want_s, layer, c["new"][:, :, :, 1], c["slots"],
                c["offs"], c["touched"], c["touch_idx"])
            d = {k: v.to(dev) for k, v in c.items()
                 if isinstance(v, torch.Tensor)}
            new = d["new"][:, :, :, 1]
            meta = (d["offs"], d["touched"], d["touch_idx"])
            got_a, got_s = d["arena"].clone(), d["scales"].clone()
            kv_quantize_scatter(got_a, got_s, layer, new, *meta)
            torch.cuda.synchronize()

            def diff(arena, scales):    # outside the null block
                return max((arena.cpu()[:, :, 1:].int()
                            - want_a[:, :, 1:].int()).abs().max().item(),
                           (scales.cpu()[:, :, 1:]
                            - want_s[:, :, 1:]).abs().max().item())

            err = diff(got_a, got_s)
            # the append is idempotent on its own output (a repeat finds
            # the grown scale and ratio 1), so repeated calls time it
            kms = time_ms(lambda: kv_quantize_scatter(
                got_a, got_s, layer, new, *meta), 50)
            pa_, ps_ = d["arena"].clone(), d["scales"].clone()
            block_pool._quantize_scatter(pa_, ps_, layer, new, d["slots"],
                                         *meta)
            plain_card_err = diff(pa_, ps_)
            pms = time_ms(lambda: block_pool._quantize_scatter(
                pa_, ps_, layer, new, d["slots"], *meta), 5)
            nbytes = _append_bytes(c, want_s, layer, new.element_size())
            rec = dict(dtype=str(dtype).replace("torch.", ""), width=width,
                       tokens=c["tokens"], blocks=c["blocks"],
                       max_err=err, plain_on_card_err=plain_card_err,
                       kernel_ms=kms, plain_ms=pms,
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       bound_by="bytes")
            log("[append] " + json.dumps(rec))
            out.append(rec)
            if err != 0:
                raise SystemExit(f"the append kernel differs from the plain "
                                 f"version: {rec}")
    return out


# -- phase 3 ------------------------------------------------------------------

def _prompts(rs, vocab):
    shared = rs.randint(0, vocab, 256).tolist()
    lens = rs.randint(64, 1001, 8)
    prompts = []
    for i, n in enumerate(lens):
        if i in (0, 5, 6, 7):           # the four that share the prefix
            n = max(n, 300)
            prompts.append(shared + rs.randint(0, vocab, n - 256).tolist())
        else:
            prompts.append(rs.randint(0, vocab, n).tolist())
    return prompts


def serving_engine(model, kv_dtype=None):
    """The serve phase's engine, built with warmup=True (one CUDA graph per
    width bucket, captured before the first request), with its metrics
    cleared but for the program builds (`jit_traces`), which the serve
    phase holds constant."""
    from paddle_tpu_torch.serving import LLMEngine

    engine = LLMEngine(model, block_size=16, max_batch=8,
                       spec_decoding=True, kv_dtype=kv_dtype, warmup=True)
    traces = engine.metrics.counters["jit_traces"]
    assert traces == len(engine._step_fns) \
        == engine.expected_program_count(), traces
    engine.metrics.counters.clear()
    engine.metrics.counters["jit_traces"] = traces
    engine.metrics.reset_schedule()
    return engine


class StepEvents:
    """CUDA events around every step program call (the staged inputs'
    copy and the graph replay), for the serve phase's device busy ms. Two
    event records a step. The events are recorded from the host, so a
    host gap between the copy-in and the replay counts as busy: an upper
    bound on the device's busy time."""

    def __enter__(self):
        from paddle_tpu_torch.serving import engine as em

        self._call = call = em._StepProgram.__call__
        self.pairs = []

        def timed(prog):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = call(prog)
            end.record()
            self.pairs.append((start, end))
            return out

        em._StepProgram.__call__ = timed
        return self

    def __exit__(self, *exc):
        from paddle_tpu_torch.serving import engine as em

        em._StepProgram.__call__ = self._call

    def busy_ms(self):
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def serve_waves(engine, prompts):
    """The serve phase's traffic: 32 greedy tokens for each prompt, sent
    as two waves (5 then 3) so the first publishes the shared prefix and
    the second hits it. Returns the outputs once the card is done."""
    outs = [o for wave in (prompts[:5], prompts[5:])
            for o in engine.generate(wave, max_new_tokens=32,
                                     temperature=0.0)]
    torch.cuda.synchronize()
    return outs


def serving_model():
    from paddle_tpu_torch.models.gpt import gpt_1p3b

    t0 = time.perf_counter()
    model = gpt_1p3b(device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    log(f"[serve] gpt_1p3b bf16 built in {time.perf_counter() - t0:.1f} s")
    return model


def _zero_counts():
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.kv_quantize_scatter import kv_quantize_scatter

    pa.ragged_paged_attention.launches = 0
    pa.ragged_paged_attention.int8_launches = 0
    pa.ragged_paged_attention.width_launches = {}
    kv_quantize_scatter.launches = 0


def _read_counts():
    """(ragged launches, of them int8, int8 append launches)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.kv_quantize_scatter import kv_quantize_scatter

    return (pa.ragged_paged_attention.launches,
            pa.ragged_paged_attention.int8_launches,
            kv_quantize_scatter.launches)


def _width_counts():
    """The ragged launches since `_zero_counts`, by step width."""
    from paddle_tpu_torch.ops import paged_attention as pa

    return {str(w): n for w, n in
            sorted(pa.ragged_paged_attention.width_launches.items())}


def _replays(engine):
    return {f"w{W}": prog.replays
            for (_, W), prog in sorted(engine._step_fns.items())}


def serve(model, kv_dtype=None):
    """Phase 3 (float arena) or 3b (kv_dtype="int8"). Returns the result
    and the greedy tokens."""
    tag = "serve" if kv_dtype is None else f"serve-{kv_dtype}"
    engine = serving_engine(model, kv_dtype)
    prompts = _prompts(np.random.RandomState(0), model.cfg.vocab_size)
    steps0 = engine.step_count
    replays0 = _replays(engine)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    with StepEvents() as ev:
        t1 = time.perf_counter()
        outs = serve_waves(engine, prompts)
        wall = time.perf_counter() - t1
    busy_ms = ev.busy_ms()
    launches, int8_launches, appends = _read_counts()
    width_launches = _width_counts()
    steps = engine.step_count - steps0
    c = engine.metrics.counters
    lat = engine.metrics.latency_summary()
    layers = model.cfg.num_layers
    res = dict(
        requests=len(outs), prompt_tokens=sum(map(len, prompts)),
        generated_tokens=int(sum(map(len, outs))), steps=steps,
        wall_s=wall, tok_per_s=sum(map(len, outs)) / wall,
        device_busy_ms=busy_ms, device_busy_share=busy_ms / 1e3 / wall,
        warmup_s=engine.metrics.gauges["warmup_seconds"],
        programs=int(c["jit_traces"]),
        program_shapes=engine.step_program_shapes(),
        replays={k: n - replays0[k] for k, n in _replays(engine).items()},
        ttft_p50_ms=lat["ttft"]["p50_ms"],
        step_p50_ms={k: v["p50_ms"] for k, v in lat.items()
                     if k.endswith("_step")},
        step_counts={k: int(c.get(k + "s", 0))
                     for k in ("mixed_step", "decode_step", "verify_step")},
        launches=launches, int8_launches=int8_launches,
        append_launches=appends, width_launches=width_launches,
        layers=layers, host_syncs=int(c.get("host_syncs", 0)),
        prefix_cache_hit_rate=engine.metrics.gauges.get(
            "prefix_cache_hit_rate", 0.0),
        spec_acceptance_rate=engine.metrics.gauges.get(
            "spec_acceptance_rate", 0.0),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        pool=engine.pool_stats())
    log(f"[{tag}] " + json.dumps(res))
    assert all(len(o) == 32 for o in outs), "a request did not finish"
    assert not c.get("nonfinite_rows"), "non-finite logits in a served row"
    # no program was built during the wave: every step replayed a graph
    # captured by warmup
    assert res["programs"] == engine.expected_program_count(), res
    assert sum(res["replays"].values()) == steps, res["replays"]
    assert launches == layers * steps, (launches, steps)
    assert sum(width_launches.values()) == launches, width_launches
    # every launch of the int8 wave is the int8 variant, none of the other,
    # and the int8 wave appends K and V through the kernel every layer
    assert int8_launches == (launches if kv_dtype else 0), int8_launches
    assert appends == (2 * layers * steps if kv_dtype else 0), appends
    assert res["host_syncs"] == steps, (res["host_syncs"], steps)
    assert res["prefix_cache_hit_rate"] > 0
    assert engine.pool.num_free == engine.pool.num_blocks - 1
    assert engine.pool._refcount == {}
    del engine
    torch.cuda.empty_cache()
    return res, outs


def eager_tokens(model, graph_outs, kv_dtype=None):
    """Phase 3d: a wave's greedy tokens from an engine like phase 3's
    (or 3b's, with kv_dtype="int8") whose steps run their program's body
    eagerly on the card (the staged inputs copied in, then `body()`, no
    replay) must equal the graph engine's token for token."""
    from paddle_tpu_torch.serving import engine as em

    engine = serving_engine(model, kv_dtype)
    prompts = _prompts(np.random.RandomState(0), model.cfg.vocab_size)
    call = em._StepProgram.__call__

    def eager(prog):
        prog.load_inputs()
        return prog.body()

    em._StepProgram.__call__ = eager
    try:
        outs = serve_waves(engine, prompts)
    finally:
        em._StepProgram.__call__ = call
    toks = [(a, b) for ga, gb in zip(graph_outs, outs)
            for a, b in zip(ga, gb)]
    res = dict(arena=kv_dtype or "float", tokens=len(toks),
               equal=int(sum(a == b for a, b in toks)),
               replays=sum(_replays(engine).values()))
    log("[graph-vs-eager] " + json.dumps(res))
    assert outs == graph_outs, res
    del engine
    torch.cuda.empty_cache()
    return res


def overcap_pair(model):
    """Phase 3c, bench.py's int8 overcap wave at gpt_1p3b: at one byte
    budget (12 bf16 blocks), the int8 arena's smaller blocks buy about
    twice the capacity, so a wave that churns the bf16 engine through
    preemptions mostly fits resident."""
    from paddle_tpu_torch.serving import LLMEngine

    cfg = model.cfg
    bs, max_seq, max_new, n_req = 16, 128, 8, 8
    per_block = (2 * cfg.num_layers * cfg.num_heads * bs
                 * (cfg.hidden_size // cfg.num_heads)
                 * model.wte.weight.element_size())
    budget = 12 * per_block
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, cfg.vocab_size, 96).tolist()
               for _ in range(n_req)]
    outs, res = {}, dict(kv_hbm_bytes=budget, requests=n_req)
    for kv_dtype in (None, "int8"):
        eng = LLMEngine(model, block_size=bs, max_batch=4,
                        max_seq_len=max_seq, kv_hbm_bytes=budget,
                        kv_dtype=kv_dtype, warmup=True)
        programs = eng.metrics.counters["jit_traces"]
        eng.metrics.counters.clear()
        steps0 = eng.step_count
        _zero_counts()
        t0 = time.perf_counter()
        outs[kv_dtype] = eng.generate(prompts, max_new_tokens=max_new,
                                      temperature=0.0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, int8_launches, appends = _read_counts()
        steps = eng.step_count - steps0
        c = eng.metrics.counters
        st = eng.pool_stats()
        rec = dict(kv_dtype=st["kv_dtype"], num_blocks=eng.pool.num_blocks,
                   blocks_total=st["blocks_total"],
                   kv_bytes_per_block=st["kv_bytes_per_block"],
                   preemptions=int(c.get("preemptions", 0)), steps=steps,
                   tok_s=c["generated_tokens"] / dt, launches=launches,
                   int8_launches=int8_launches, append_launches=appends,
                   programs=int(programs))
        res["int8" if kv_dtype else "base"] = rec
        assert all(len(o) == max_new for o in outs[kv_dtype])
        assert not c.get("jit_traces"), "a program was built in the wave"
        assert programs == eng.expected_program_count(), programs
        assert launches == cfg.num_layers * steps, (launches, steps)
        assert int8_launches == (launches if kv_dtype else 0), int8_launches
        assert appends == (2 * launches if kv_dtype else 0), appends
        assert c["host_syncs"] == steps
        assert eng.pool.num_free == eng.pool.num_blocks - 1
        del eng
        torch.cuda.empty_cache()
    res["capacity_ratio"] = (res["int8"]["num_blocks"]
                             / res["base"]["num_blocks"])
    res["greedy_parity_rate"] = float(np.mean(
        [a == b for a, b in zip(outs[None], outs["int8"])]))
    log("[overcap] " + json.dumps(res))
    assert res["capacity_ratio"] >= 1.9, res
    return res


# -- phase 3e -----------------------------------------------------------------

# the engine build of both phase 3e engines (the server's also writes
# postmortem bundles)
FRONT_DOOR = dict(block_size=16, max_batch=8, spec_decoding=True, warmup=True,
                  trace=1.0, slo=True)
# the concurrent waves' SLO classes: (tenant, priority) by request index
CLASSES = [("t0", "interactive"), ("t1", "batch")]
# the timed comparison: each wave serves the 8 prompts TIMED_ROUNDS times
# over with CLIENTS requests live at once (twice max_batch, so the batch
# stays full), seconds of wall; the profiled pair serves them
# PROFILED_ROUNDS times (a profile takes seconds to read)
TIMED_ROUNDS, CLIENTS, PROFILED_ROUNDS = 32, 16, 4


async def _post(port, body):
    """One /v1/completions exchange over loopback: (status, tokens,
    finish_reason, seconds to the first SSE token or None)."""
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode()
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(data)}\r\n\r\n").encode() + data)
    await writer.drain()
    status = int((await reader.readline()).split(b" ")[1])
    while (await reader.readline()).strip():
        pass                                   # the response headers
    toks, reason, ttft = [], None, None
    if body.get("stream"):
        while line := await reader.readline():
            if not line.startswith(b"data: ") or line.strip() == \
                    b"data: [DONE]":
                continue
            choice = json.loads(line[6:])["choices"][0]
            if choice["token_ids"] and ttft is None:
                ttft = time.perf_counter() - t0
            toks += choice["token_ids"]
            reason = choice["finish_reason"] or reason
    else:
        out = json.loads(await reader.read())
        if status == 200:
            toks = out["choices"][0]["token_ids"]
            reason = out["choices"][0]["finish_reason"]
    writer.close()
    return status, toks, reason, ttft


async def _get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), body


def _in_step_ms(engine, since):
    """Host wall ms inside `LLMEngine.step` calls that began at or after
    monotonic time `since`: the tracer's step spans (plan to emit)."""
    t = engine.tracer.ts(since)
    return sum(e["dur"] for e in engine.tracer.chrome_trace()["traceEvents"]
               if e["name"].startswith("step[") and e["ts"] >= t) / 1e3


def _direct(engine, prompts, ids, clients=None):
    """Serve `prompts` on `engine` by `step()` alone, at most `clients`
    requests live at once (all at once by default; a finished request's
    slot takes the next prompt, as a client of the server sends its next
    request when its last one ends). Returns ({id: tokens}, the wave's
    numbers)."""
    todo = list(zip(ids, prompts))[::-1]
    live, out, ttft = {}, {}, []

    def admit():
        rid, p = todo.pop()
        engine.add_request(p, max_new_tokens=32, temperature=0.0,
                           request_id=rid)
        live[rid] = engine.get_request(rid)

    steps0, mono0 = engine.step_count, time.monotonic()
    t0 = time.perf_counter()
    for _ in range(min(clients or len(todo), len(todo))):
        admit()
    while live:
        engine.step()
        for rid in [rid for rid, r in live.items() if r.finished]:
            r = live.pop(rid)
            out[rid] = list(r.output_ids)
            ttft.append(r.first_token_time - r.arrival_time)
            engine.release(rid)
            if todo:
                admit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, dict(
        requests=len(prompts), steps=engine.step_count - steps0,
        wall_s=wall, tok_per_s=sum(map(len, out.values())) / wall,
        ttft_p50_ms=float(np.median(ttft)) * 1e3,
        in_step_ms=_in_step_ms(engine, mono0))


async def _http_wave(engine, port, prompts, tag, clients=None):
    """`prompts` through the server, at most `clients` requests in flight
    (all at once by default; each client sends its next request when its
    last one ends), even ones streamed, two tenant/priority classes, the
    ragged launch counts set to 0 just before and read just after.
    Returns the wave's numbers; fails on a request that did not finish, a
    program built, a second host sync in a step, a launch count off 24 a
    step, or a busy pool after."""
    c = engine.metrics.counters
    traces0, steps0, syncs0 = (c["jit_traces"], engine.step_count,
                               c["host_syncs"])
    engine.metrics.reset_schedule()
    todo = list(enumerate(prompts))[::-1]
    wave = [None] * len(prompts)

    async def client():
        while todo:
            i, p = todo.pop()
            wave[i] = await _post(port, {
                "prompt": p, "max_tokens": 32, "stream": i % 2 == 0,
                "request_id": f"{tag}-{i}", "tenant": CLASSES[i % 2][0],
                "priority": CLASSES[i % 2][1]})

    mono0 = time.monotonic()
    _zero_counts()
    t0 = time.perf_counter()
    await asyncio.gather(*[client() for _ in range(clients or len(todo))])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, int8_launches, _ = _read_counts()
    steps = engine.step_count - steps0
    rec = dict(
        requests=len(prompts), steps=steps, wall_s=wall,
        tok_per_s=sum(len(t) for _, t, _, _ in wave) / wall,
        ttft_p50_ms=engine.metrics.latency_summary()["ttft"]["p50_ms"],
        http_ttft_p50_ms=float(np.median(
            [f for _, _, _, f in wave if f is not None])) * 1e3,
        in_step_ms=_in_step_ms(engine, mono0), launches=launches,
        host_syncs=int(c["host_syncs"] - syncs0))
    assert all(s == 200 and r == "length" and len(t) == 32
               for s, t, r, _ in wave), wave
    assert engine.pool.num_free == engine.pool.num_blocks - 1
    assert c["jit_traces"] == traces0, rec
    assert engine.metrics.gauges["jit_retraces"] == 0, rec
    assert rec["host_syncs"] == steps, rec
    assert launches == engine.model.cfg.num_layers * steps, rec
    assert not int8_launches, rec
    return rec


def _device_busy_ms(prof):
    """Device time in a torch.profiler trace: the union of its kernel,
    copy and set intervals on the card, in ms (CUPTI timestamps, so no
    host gap counts)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def _with_busy(rec, prof):
    """A wave's numbers with the device busy ms of its profile `prof`
    (read after the wave's clock stopped) and their share of its wall."""
    busy = _device_busy_ms(prof)
    return dict(rec, device_busy_ms=busy,
                device_busy_share=busy / 1e3 / rec["wall_s"])


def _medians(runs):
    return {k: float(np.median([r[k] for r in runs]))
            for k in runs[0] if k != "requests"}


def front_door(model, served):
    """Phase 3e: the HTTP front door (`ServingServer` over
    `AsyncLLMEngine` over `LLMEngine`) on phase 3's model and prompts."""
    return asyncio.run(_front_door(model, served))


async def _front_door(model, served):
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.serving import LLMEngine, ServingServer, faults

    prompts = _prompts(np.random.RandomState(0), model.cfg.vocab_size)
    n = len(prompts)
    pm_dir = tempfile.mkdtemp(prefix="front-door-pm-")
    res = {}
    try:
        # the direct engine: the same build, driven by step() alone
        direct = LLMEngine(model, **FRONT_DOOR)
        seq_direct = {}
        for i, p in enumerate(prompts):
            seq_direct.update(_direct(direct, [p], [f"s{i}"])[0])
        engine = LLMEngine(model, postmortem_dir=pm_dir, **FRONT_DOOR)
        server = ServingServer(engine, host="127.0.0.1", port=0)
        await server.start()
        port = server.port
        # 1. one request at a time, alternating SSE and full responses:
        # token for token the direct engine's
        seq = []
        for i, p in enumerate(prompts):
            seq.append(await _post(port, {
                "prompt": p, "max_tokens": 32, "stream": i % 2 == 0,
                "request_id": f"s{i}"}))
        equal = sum(toks == seq_direct[f"s{i}"]
                    for i, (_, toks, _, _) in enumerate(seq))
        res["sequential"] = dict(requests=n, equal=int(equal))
        assert all(s == 200 and r == "length" for s, _, r, _ in seq), seq
        assert equal == n, res["sequential"]

        # 2. the 8 prompts at once through the server: the checks
        res["concurrent"] = await _http_wave(engine, port, prompts, "c")

        # 3. the timed comparison: TIMED_ROUNDS x the 8 prompts on the
        # direct engine and through the server in turns (D H H D D H),
        # CLIENTS requests live at once, warm prefix caches on both after
        # the sequential pass; then one shorter wave each way under the
        # profiler for the device busy share
        timed = prompts * TIMED_ROUNDS
        runs = {"direct": [], "http": []}
        for r, way in enumerate("DHHDDH"):
            if way == "D":
                runs["direct"].append(_direct(
                    direct, timed, [f"d{r}-{i}" for i in range(len(timed))],
                    CLIENTS)[1])
            else:
                runs["http"].append(await _http_wave(
                    engine, port, timed, f"w{r}", CLIENTS))
        short = prompts * PROFILED_ROUNDS
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rec = _direct(direct, short,
                          [f"pd-{i}" for i in range(len(short))], CLIENTS)[1]
        res["profiled"] = {"direct": _with_busy(rec, prof)}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rec = await _http_wave(engine, port, short, "ph", CLIENTS)
        res["profiled"]["http"] = _with_busy(rec, prof)
        del direct
        torch.cuda.empty_cache()
        res.update(direct_waves=runs["direct"], http_waves=runs["http"])
        res["direct"], res["http"] = (_medians(runs["direct"]),
                                      _medians(runs["http"]))
        res["http_over_direct_tok_per_s"] = (res["http"]["tok_per_s"]
                                             / res["direct"]["tok_per_s"])
        res["launches"] = (res["concurrent"]["launches"]
                           + res["profiled"]["http"]["launches"]
                           + sum(w["launches"] for w in runs["http"]))
        res["phase3"] = dict(tok_per_s=served["tok_per_s"],
                             ttft_p50_ms=served["ttft_p50_ms"])
        ms, metrics = await _get(port, "/metrics")
        hs, health = await _get(port, "/healthz")
        ts, trace = await _get(port, "/debug/trace")
        ss, slo = await _get(port, "/debug/slo")
        metrics, health = metrics.decode(), json.loads(health)
        trace, slo = json.loads(trace), json.loads(slo)
        phases = {e["name"] for e in trace["traceEvents"]
                  if e.get("pid") == 1 and e.get("tid") == 0
                  and e["ph"] == "X" and not e["name"].startswith("step[")}
        classes = sorted((k["tenant"], k["priority"])
                         for k in slo["classes"])
        res["endpoints"] = dict(step_phases=sorted(phases),
                                slo_classes=classes)
        assert ms == hs == ts == ss == 200, (ms, hs, ts, ss)
        assert health["status"] == "ok" and health["mesh"]["backend"] == \
            "cuda", health
        for family in ("lifecycle_state", "mesh_tp_degree 1",
                       "mixed_step_seconds", "decode_step_seconds",
                       "slo_ttft_seconds", "slo_requests_total"):
            assert f"paddle_tpu_serving_{family}" in metrics, family
        assert phases == {"plan", "build", "dispatch", "sync", "emit"}, \
            phases
        # besides the waves': the sequential requests (no labels) and the
        # warmup's synthetic ones
        assert set(classes) == set(CLASSES) | {("-", "-"),
                                               ("_warmup", "-")}, classes

        # 4. faults: a non-finite row pinned to one request, then a raise
        # at one step of a second wave
        c = engine.metrics.counters
        traces0 = c["jit_traces"]
        faults.install(faults.FaultPlan(
            [{"point": "step_nonfinite_logits", "request_id": "f2"}]))
        nf = await asyncio.gather(*[_post(port, {
            "prompt": p, "max_tokens": 32, "stream": i % 2 == 0,
            "request_id": f"f{i}"}) for i, p in enumerate(prompts)])
        faults.clear()
        errors0 = c.get("engine_step_errors", 0)
        faults.install(faults.FaultPlan(
            [{"point": "step_raise", "at_step": engine.step_count + 3}]))
        sr = await asyncio.gather(*[_post(port, {
            "prompt": p, "max_tokens": 32, "stream": i % 2 == 0,
            "request_id": f"r{i}"}) for i, p in enumerate(prompts)])
        faults.clear()
        ends = {e["args"]["request_id"]: e["args"]["reason"]
                for e in json.loads((await _get(port, "/debug/trace"))[1])[
                    "traceEvents"] if e["name"] == "request"}
        ps, pm = await _get(port, "/debug/postmortem")
        bundles = json.loads(pm)["bundles"]
        res["faults"] = dict(
            nonfinite=[r for _, _, r, _ in nf], nonfinite_end=ends["f2"],
            step_raise=[r for _, _, r, _ in sr],
            step_errors=int(c.get("engine_step_errors", 0) - errors0),
            probes=int(c.get("engine_step_retries", 0)),
            bundles=[b["event"] for b in bundles],
            jit_retraces=engine.metrics.gauges["jit_retraces"])
        f = res["faults"]
        assert f["nonfinite"][2] == "error" and ends["f2"] == \
            "error:nonfinite_logits", f
        assert all(r == "length" and len(t) == 32
                   for i, (_, t, r, _) in enumerate(nf) if i != 2), nf
        assert all(s == 200 and r == "length" and len(t) == 32
                   for s, t, r, _ in sr), sr
        assert f["step_errors"] == 1 and f["probes"] > 0, f
        assert ps == 200 and "nonfinite_row" in f["bundles"], f
        assert f["jit_retraces"] == 0 and c["jit_traces"] == traces0, f

        # 5. drain
        await server.shutdown(drain=True)
        res["lifecycle"] = engine.lifecycle.state
        assert res["lifecycle"] == "stopped"
        assert engine.pool.num_free == engine.pool.num_blocks - 1
    finally:
        faults.clear()
        shutil.rmtree(pm_dir, ignore_errors=True)
    log("[front-door] " + json.dumps(res))
    del engine
    torch.cuda.empty_cache()
    return res


# -- phase 3f -----------------------------------------------------------------

# the build of every phase 3f engine, beside the feature under test
FEATURE_ENGINE = dict(block_size=16, max_batch=8, spec_decoding=True,
                      warmup=True)
# the LoRA wave's adapter by prompt index: base, alpha, beta in turn
LORA_WAVE = [None, "alpha", "beta", None, "alpha", "beta", None, "alpha"]
# the host-tier wave: a device pool of 80 blocks under a 1024-token
# document (64 blocks), 256 host blocks
TIER_ENGINE = dict(num_blocks=80, host_kv_blocks=256)


def _adapters(cfg):
    """The two seeded adapters: alpha at rank 8 (alpha 16), beta at rank 4
    (alpha 8, zero-padded to the table rank)."""
    from paddle_tpu_torch.models import lora

    return {"alpha": (lora.random_adapter(cfg, 8, seed=1), 16),
            "beta": (lora.random_adapter(cfg, 4, seed=2), 8)}


def _feature_engine(model, **kw):
    """A phase 3f engine (warmup=True) with its counters cleared but for
    the program builds, as `serving_engine` leaves phase 3's."""
    from paddle_tpu_torch.serving import LLMEngine

    engine = LLMEngine(model, **FEATURE_ENGINE, **kw)
    traces = engine.metrics.counters["jit_traces"]
    assert traces == len(engine._step_fns) \
        == engine.expected_program_count(), traces
    engine.metrics.counters.clear()
    engine.metrics.counters["jit_traces"] = traces
    engine.metrics.reset_schedule()
    return engine


def _wave_start(engine):
    """What a wave's checks compare against, read just before it; the
    kernels' launch counts are set to 0."""
    c = engine.metrics.counters
    _zero_counts()
    return engine.step_count, c.get("host_syncs", 0), c["jit_traces"]


def _wave_end(engine, start, tag):
    """A wave's launches and steps; fails on a program built, a second
    host sync in a step, a ragged launch count off one a layer and step,
    or a busy pool."""
    steps0, syncs0, traces0 = start
    c = engine.metrics.counters
    launches, int8_launches, appends = _read_counts()
    steps = engine.step_count - steps0
    rec = dict(steps=steps, host_syncs=int(c["host_syncs"] - syncs0),
               launches=launches, int8_launches=int8_launches,
               append_launches=appends)
    layers = engine.model.cfg.num_layers
    assert c["jit_traces"] == traces0, (tag, rec)
    assert engine.metrics.gauges.get("jit_retraces", 0) == 0, (tag, rec)
    assert rec["host_syncs"] == steps, (tag, rec)
    assert launches == layers * steps, (tag, rec)
    if engine.pool.quantized:
        assert int8_launches == launches and appends == 2 * launches, \
            (tag, rec)
    assert engine.pool.num_free == engine.pool.num_blocks - 1, tag
    assert engine.pool._refcount == {}, tag
    return rec


def _serve_each(engine, prompts, **kw):
    """`prompts` one at a time through `step()`, 32 greedy tokens each:
    (tokens, TTFT ms) per prompt. One request at a time gives every
    serve of a prompt the same step shapes whatever its cache state."""
    outs, ttft = [], []
    for p in prompts:
        rid = engine.add_request(p, max_new_tokens=32, temperature=0.0, **kw)
        req = engine.get_request(rid)
        while not req.finished:
            engine.step()
        outs.append(list(req.output_ids))
        ttft.append((req.first_token_time - req.arrival_time) * 1e3)
        engine.release(rid)
    torch.cuda.synchronize()
    return outs, ttft


def _lora_delta_ms(engine):
    """Device ms a step of the LoRA delta at the serve shapes, by width
    bucket: the per-lane gather of both targets' rows, and the two
    products plus the float32 add of both targets in every layer (models/
    gpt.py `_serving_column_parallel`)."""
    from paddle_tpu_torch.models.lora import (apply_adapter_rows,
                                              gather_adapter_rows)

    tables = engine._lora_tables
    cfg = engine.model.cfg
    slots = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1], dtype=torch.int32,
                         device=engine.device)
    rows = gather_adapter_rows(tables, slots)
    out = {}
    for W in engine.width_buckets:
        x = torch.randn((8, W, cfg.hidden_size), device=engine.device,
                        dtype=engine.model.dtype)
        ys = {t: torch.zeros((8, W, b.shape[-1]), device=engine.device,
                             dtype=x.dtype) for t, (_, b) in tables.items()}

        def products():
            for t, (a_rows, b_rows) in rows.items():
                (ys[t].float() + apply_adapter_rows(x, a_rows, b_rows, 0)
                 ).to(x.dtype)

        gather = time_ms(lambda: gather_adapter_rows(tables, slots), 20)
        prod = time_ms(products, 20) * cfg.num_layers
        out[f"w{W}"] = dict(gather_ms=gather, products_ms=prod,
                            total_ms=gather + prod)
    return out


async def _http_adapter(engine, prompt, want):
    """One /v1/completions request naming adapter alpha through a
    `ServingServer` over `engine`: its tokens must be `want`."""
    from paddle_tpu_torch.serving import ServingServer

    server = ServingServer(engine, host="127.0.0.1", port=0)
    await server.start()
    try:
        status, toks, reason, _ = await _post(server.port, {
            "prompt": prompt, "max_tokens": 32, "adapter": "alpha",
            "stream": True})
    finally:
        await server.shutdown()
    assert status == 200 and reason == "length", (status, reason)
    return toks == want


def lora_waves(model, served, graph_outs):
    """Phase 3f, LoRA: the mixed wave, phase 3's traffic on a LoRA engine,
    the delta's device ms, the adapter over HTTP, and f32 merged parity."""
    cfg = model.cfg
    prompts = _prompts(np.random.RandomState(0), cfg.vocab_size)
    res = {}
    # 1. the mixed wave: base, alpha and beta requests in one wave
    engine = _feature_engine(model, lora_slots=3, lora_rank=8)
    for name, (w, alpha) in _adapters(cfg).items():
        engine.load_adapter(name, w, alpha=alpha)
    assert engine.step_program_shapes() == served["program_shapes"]
    start = _wave_start(engine)
    with StepEvents() as ev:
        t0 = time.perf_counter()
        rids = [engine.add_request(p, max_new_tokens=32, temperature=0.0,
                                   adapter=a)
                for p, a in zip(prompts, LORA_WAVE)]
        while engine.has_unfinished():
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    outs = [engine.get_request(r).output_ids for r in rids]
    rec = _wave_end(engine, start, "lora-mixed")
    base = [i for i, a in enumerate(LORA_WAVE) if a is None]
    adapted = [i for i, a in enumerate(LORA_WAVE) if a is not None]
    rec.update(
        tok_per_s=sum(map(len, outs)) / wall, wall_s=wall,
        device_busy_share=ev.busy_ms() / 1e3 / wall,
        base_equal=sum(outs[i] == graph_outs[i] for i in base),
        base_lanes=len(base),
        adapter_differs=sum(outs[i] != graph_outs[i] for i in adapted),
        adapter_lanes=len(adapted),
        lora_requests=int(engine.metrics.counters.get("lora_requests", 0)),
        delta_ms=_lora_delta_ms(engine))
    res["mixed"] = rec
    assert all(len(o) == 32 for o in outs)
    assert engine.pool_stats()["lora"]["inflight"] == {}
    del engine
    torch.cuda.empty_cache()
    # 2. phase 3's traffic (every lane on slot 0) on a fresh LoRA engine:
    # the same schedule as phase 3, so the same tokens bit for bit
    engine = _feature_engine(model, lora_slots=3, lora_rank=8)
    for name, (w, alpha) in _adapters(cfg).items():
        engine.load_adapter(name, w, alpha=alpha)
    start = _wave_start(engine)
    t0 = time.perf_counter()
    outs = serve_waves(engine, prompts)
    wall = time.perf_counter() - t0
    rec = _wave_end(engine, start, "lora-base")
    rec.update(tok_per_s=sum(map(len, outs)) / wall, wall_s=wall,
               equal=sum(a == b for a, b in zip(outs, graph_outs)))
    res["base_traffic"] = rec
    # 3. one request naming alpha over HTTP: the tokens the engine gives
    # the same request driven by step() (both warm: served once before)
    p = prompts[1]
    direct = _serve_each(engine, [p, p], adapter="alpha")[0]
    res["http_adapter_equal"] = asyncio.run(
        _http_adapter(engine, p, direct[1]))
    del engine
    torch.cuda.empty_cache()
    res["phase3_tok_per_s"] = served["tok_per_s"]
    res["f32_merged"] = lora_f32_parity()
    log("[lora] " + json.dumps(res))
    mixed = res["mixed"]
    # slot 0 adds an exact zero: base lanes are phase 3's tokens
    assert mixed["base_equal"] == mixed["base_lanes"], mixed
    assert mixed["adapter_differs"] > 0, mixed
    assert res["base_traffic"]["equal"] == len(graph_outs), res
    assert res["http_adapter_equal"], res
    assert res["f32_merged"]["parity_rate"] >= 0.9, res
    return res


def lora_f32_parity():
    """The LoRA engine in float32 (TF32 off) at gpt_1p3b widths and 4
    layers, every request on adapter alpha, against a plain engine over
    the model with alpha merged into its weights: the greedy token
    equality rate must reach 0.9 (phase 3b's card-parity rate)."""
    from paddle_tpu_torch.models import lora
    from paddle_tpu_torch.models.gpt import gpt_1p3b
    from paddle_tpu_torch.serving import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    outs = []
    for merged in (False, True):
        model = gpt_1p3b(num_layers=4, device="cuda", dtype=torch.float32,
                         seed=1)
        rs = np.random.RandomState(1)
        prompts = [rs.randint(0, model.cfg.vocab_size, n).tolist()
                   for n in (20, 37, 64, 150)]
        w, alpha = _adapters(model.cfg)["alpha"]
        if merged:
            lora.merge_adapter_into(model, w, alpha=alpha)
            eng = LLMEngine(model, block_size=16, max_batch=4)
            kw = {}
        else:
            eng = LLMEngine(model, block_size=16, max_batch=4, lora_slots=1,
                            lora_rank=8)
            eng.load_adapter("alpha", w, alpha=alpha)
            kw = {"adapter": "alpha"}
        outs.append(eng.generate(prompts, max_new_tokens=16,
                                 temperature=0.0, **kw))
        del eng, model
        torch.cuda.empty_cache()
    toks = [(a, b) for ga, gb in zip(*outs) for a, b in zip(ga, gb)]
    rate = float(np.mean([a == b for a, b in toks]))
    return dict(layers=4, prompts=4, tokens=len(toks), parity_rate=rate)


def _tier_prompts(vocab):
    """The document (1024 tokens) with two short tails, and three rounds of
    churn: distinct prompts of 300 and 400 tokens, 46 blocks a round with
    their decode, so two rounds push the whole document out of the
    79-block device pool while the 256-block host tier keeps it and all
    three rounds."""
    rs = np.random.RandomState(3)
    doc = rs.randint(0, vocab, 1024).tolist()
    docs = [doc + rs.randint(0, vocab, n).tolist() for n in (5, 9)]
    churn = [[rs.randint(0, vocab, n).tolist() for n in (300, 400)]
             for _ in range(3)]
    return docs, churn


def _churn(engine, churn):
    for wave in churn:
        engine.generate(wave, max_new_tokens=8, temperature=0.0)


def _swap_rates(engine, blocks):
    """Swap-out and swap-in GB/s of `blocks` arena blocks: saved under
    fresh hashes, flushed and settled into the host slabs (the host clock,
    slab writes included), then restored into as many allocated blocks
    (the host clock to a synchronize)."""
    tier, pool = engine.tier, engine.pool
    per_block = pool.bytes_per_block()
    hashes = [b"rate-%d" % i for i in range(len(blocks))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for h, b in zip(hashes, blocks):
        tier.save(h, b)
    tier.flush_saves()
    tier.settle()
    out_s = time.perf_counter() - t0
    dst = pool.allocate(len(blocks))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = tier.restore(hashes, dst)
    torch.cuda.synchronize()
    in_s = time.perf_counter() - t0
    pool.release(dst)
    assert got == len(blocks), got
    nbytes = per_block * len(blocks)
    return dict(blocks=len(blocks), bytes=nbytes,
                swap_out_gb_s=nbytes / out_s / 1e9,
                swap_in_gb_s=nbytes / in_s / 1e9)


async def _http_kvtier(engine):
    """/debug/kvtier and /healthz through a `ServingServer` over `engine`:
    (snapshot, pool)."""
    from paddle_tpu_torch.serving import ServingServer

    server = ServingServer(engine, host="127.0.0.1", port=0)
    await server.start()
    try:
        ks, snap = await _get(server.port, "/debug/kvtier")
        hs, health = await _get(server.port, "/healthz")
    finally:
        await server.shutdown()
    assert ks == hs == 200, (ks, hs)
    return json.loads(snap), json.loads(health)["pool"]


def tier_wave(model, kv_dtype=None):
    """Phase 3f, the host tier over a float or an int8 arena: cold,
    device-warm, churn, host-warm; a second churn and host-warm serve
    under the profiler (its busy share); export into a second engine
    (a third host-warm serve); the swap rates; /debug/kvtier over HTTP
    (float arena)."""
    from torch.profiler import ProfilerActivity, profile

    tag = "tier" if kv_dtype is None else f"tier-{kv_dtype}"
    docs, churn = _tier_prompts(model.cfg.vocab_size)
    engine = _feature_engine(model, kv_dtype=kv_dtype, **TIER_ENGINE)
    tier = engine.tier
    start = _wave_start(engine)
    # the first document cold, then device-warm three times, then the
    # second (its tail is longer); after the churn both host-warm, the
    # second one finding the first's restored blocks on the device
    cold, cold_ttft = _serve_each(engine, docs[:1])
    warm, warm_ttft = _serve_each(engine, [docs[0]] * 3 + docs[1:])
    ins0 = tier.swap_ins
    _churn(engine, churn)
    tier.settle()
    host, host_ttft = _serve_each(engine, docs)
    rec = _wave_end(engine, start, tag)
    stats = tier.stats()
    host_warm = [host_ttft[0]]
    rec.update(
        ttft_ms=dict(cold=cold_ttft[0], device_warm=warm_ttft[:3],
                     host_warm=host_warm,
                     second_device_warm=warm_ttft[3],
                     second_after_restore=host_ttft[1]),
        tokens_equal=(cold[0] == warm[0] == warm[1] == warm[2] == host[0]
                      and warm[3] == host[1]),
        swap_ins=stats["swap_ins"] - ins0, swap_outs=stats["swap_outs"],
        host_blocks_used=stats["host_blocks_used"])
    tier.settle()
    with tier._lock:
        assert tier._pending == {} and tier._save_buf == []
    # a third host-warm serve, under the profiler for its busy share
    _churn(engine, churn)
    tier.settle()
    start = _wave_start(engine)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        outs, ttft = _serve_each(engine, docs[:1])
        wall = time.perf_counter() - t0
    host_warm.append(ttft[0])
    prof_rec = _wave_end(engine, start, tag + "-profiled")
    busy = _device_busy_ms(prof)
    rec["profiled_host_warm"] = dict(wall_s=wall, device_busy_ms=busy,
                                     device_busy_share=busy / 1e3 / wall)
    rec["profiled_host_warm"]["tokens_equal"] = outs[0] == cold[0]
    assert rec["profiled_host_warm"]["tokens_equal"], rec
    # export into a second engine of the same build: it serves host-warm
    payload = engine.export_kv_tier(demote=True)
    second = _feature_engine(model, kv_dtype=kv_dtype, **TIER_ENGINE)
    rec["imported"] = second.import_kv_tier(payload)
    del payload
    start = _wave_start(second)
    moved, ttft = _serve_each(second, docs[:1])
    host_warm.append(ttft[0])
    import_rec = _wave_end(second, start, tag + "-import")
    for k in ("launches", "int8_launches", "append_launches"):
        rec[k] += import_rec[k] + prof_rec[k]
    rec["import_swap_ins"] = second.tier.swap_ins
    rec["import_tokens_equal"] = moved[0] == cold[0]
    second.close()
    del second
    # the swap rates, on the document's 64 blocks (device-resident after
    # the host-warm serve); last, as their hashes take host slots
    blocks = [engine.pool._hash_index[h]
              for h in _doc_hashes(docs[0], engine.block_size)]
    rec["rates"] = _swap_rates(engine, blocks)
    t = rec["ttft_ms"]
    t.update(cold_p50=t["cold"], device_warm_p50=float(np.median(
        t["device_warm"])), host_warm_p50=float(np.median(host_warm)))
    rec["host_over_device_ttft"] = t["host_warm_p50"] / t["device_warm_p50"]
    rec["cold_over_host_ttft"] = t["cold_p50"] / t["host_warm_p50"]
    if kv_dtype is None:
        snap, pool = asyncio.run(_http_kvtier(engine))
        fields = ("host_blocks_total", "host_blocks_used", "swap_ins",
                  "swap_outs", "swap_in_hit_tokens", "migrated_blocks_out",
                  "migrated_blocks_in")
        rec["debug_kvtier_equal"] = all(snap[k] == pool[k] for k in fields)
    engine.close()
    log(f"[{tag}] " + json.dumps(rec))
    del engine
    torch.cuda.empty_cache()
    assert rec["tokens_equal"], (cold, warm, host)
    assert rec["swap_outs"] > 0 and rec["swap_ins"] > 0, rec
    assert rec["import_tokens_equal"] and rec["import_swap_ins"] > 0, rec
    assert rec.get("debug_kvtier_equal", True), rec
    return rec


def _doc_hashes(prompt, block_size):
    from paddle_tpu_torch.serving import chain_block_hashes

    return chain_block_hashes(prompt, block_size)[:1024 // block_size]


def _mean_nll(model, seqs):
    """Mean next-token NLL of `seqs` under `model` (full forwards)."""
    tot, n = 0.0, 0
    with torch.no_grad():
        for seq in seqs:
            logits = model(torch.tensor([seq], device=model.device))[0]
            logits = logits.float()
            lse = torch.logsumexp(logits[:-1], dim=-1)
            ll = logits[torch.arange(len(seq) - 1), seq[1:]] - lse
            tot += float(-ll.sum())
            n += len(seq) - 1
    return tot / n


def _flash_short():
    """The flash forward at calibration's shape (B 1, S 24, H 16, D 128,
    causal, bf16) against the plain version, with times: no other phase
    runs the sm_90a forward under 64 keys."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    q, k, v = (torch.randn((1, 24, H, D), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    o32 = fa.attention_ref(q.float(), k.float(), v.float(), True)
    lse32 = fa.attention_lse_ref(q.float(), k.float(), True)
    torch.cuda.synchronize()
    err = max((o.float() - o32).abs().max().item(),
              (lse - lse32).abs().max().item())
    bound = _flash_bounds(1, 24, H, D, torch.bfloat16)["fwd"]
    F = torch.nn.functional
    ql, kl, vl = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    rec = dict(shape=[1, 24, H, D], max_err=err, tol=TOL[torch.bfloat16],
               ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, True), 50),
               plain_ms=time_ms(lambda: fa.attention_ref(q, k, v, True), 50),
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                   ql, kl, vl, is_causal=True), 50),
               bound_ms=bound[0], bound_by=bound[1])
    assert err <= TOL[torch.bfloat16], rec
    return rec


def adaround(model, graph_outs):
    """Phase 3f, AdaRound: gpt_1p3b (the same seed as phase 3's) built
    with quantize="int8", quantize_iters=40 over 4 calibration prompts of
    24 tokens; the held-out NLL gate, greedy parity against phase 3, the
    untouched embedding and norms, and block 0's fc1 on the int8 grid."""
    from paddle_tpu_torch.ops import flash_attention as fa

    cfg = model.cfg
    rs = np.random.RandomState(4)
    calib = [rs.randint(0, cfg.vocab_size, 24).tolist() for _ in range(4)]
    held = [rs.randint(0, cfg.vocab_size, 32).tolist() for _ in range(4)]
    res = {"flash_s24": _flash_short()}
    base_nll = _mean_nll(model, held)
    qmodel = serving_model()
    wte = qmodel.wte.weight.detach().clone()
    ln = [qmodel.blocks[0].ln1.weight.detach().clone(),
          qmodel.ln_f.weight.detach().clone()]
    fa.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    engine = _feature_engine(qmodel, quantize="int8", calib_prompts=calib,
                             quantize_iters=40)
    build_s = time.perf_counter() - t0
    res.update(calibration_s=build_s - engine.metrics.gauges[
        "warmup_seconds"], engine_build_s=build_s,
        calibration_flash_launches=fa.flash_attention_fwd.launches)
    assert res["calibration_flash_launches"] == cfg.num_layers * len(calib)
    prompts = _prompts(np.random.RandomState(0), cfg.vocab_size)
    start = _wave_start(engine)
    outs = serve_waves(engine, prompts)
    res["wave"] = _wave_end(engine, start, "adaround")
    toks = [(a, b) for go, gq in zip(graph_outs, outs)
            for a, b in zip(go, gq)]
    res["parity_rate"] = float(np.mean([a == b for a, b in toks]))
    res["base_nll"] = base_nll
    res["int8_nll"] = _mean_nll(qmodel, held)
    res["nll_delta"] = res["int8_nll"] - base_nll
    res["untouched"] = bool(torch.equal(qmodel.wte.weight, wte) and all(
        torch.equal(a, b) for a, b in zip(
            (qmodel.blocks[0].ln1.weight, qmodel.ln_f.weight), ln)))
    w = qmodel.blocks[0].fc1.weight.detach().float().t()      # [in, out]
    s = w.abs().amax(dim=0, keepdim=True) / 127.0
    g = w / s
    res["fc1_grid_worst"] = float(((g - g.round()).abs()
                                   / g.round().abs().clamp_min(1)).max())
    log("[adaround] " + json.dumps(res))
    assert res["nll_delta"] <= 0.05, res
    assert res["parity_rate"] >= 0.9, res
    assert res["untouched"], res
    # bf16 rounds q * s to 8 significant bits: |w/s - round(w/s)| <=
    # |round(w/s)| * 2^-8
    assert bool(((g - g.round()).abs()
                 <= g.round().abs() * 2.0 ** -8 + 1e-6).all()), res
    del engine, qmodel
    torch.cuda.empty_cache()
    return res


def feature_waves(model, served, graph_outs):
    """Phase 3f: LoRA, the host tier (float and int8 arenas) and AdaRound
    on gpt_1p3b, each wave with the kernels' counts set to 0 just before
    and read just after; returns the results and the launches by
    kernel."""
    t0 = time.perf_counter()
    res = {"lora": lora_waves(model, served, graph_outs)}
    res["tier"] = tier_wave(model)
    res["tier_int8"] = tier_wave(model, "int8")
    res["adaround"] = adaround(model, graph_outs)
    res["seconds"] = time.perf_counter() - t0
    waves = [res["lora"]["mixed"], res["lora"]["base_traffic"],
             res["tier"], res["tier_int8"], res["adaround"]["wave"]]
    res["launches"] = dict(
        ragged=sum(w["launches"] - w["int8_launches"] for w in waves),
        ragged_int8=sum(w["int8_launches"] for w in waves),
        append=sum(w["append_launches"] for w in waves),
        flash_fwd=res["adaround"]["calibration_flash_launches"])
    log("[phase-3f] " + json.dumps({"seconds": res["seconds"],
                                    "launches": res["launches"]}))
    return res


# -- phase 3g -----------------------------------------------------------------

# every phase 3g replica: phase 3's build with the float arena's host tier
FLEET = dict(block_size=16, max_batch=8, spec_decoding=True, warmup=True,
             host_kv_blocks=256)
# the shared-prefix wave: FLEET_REQUESTS greedy requests over SYSTEMS
# system prompts of 256 tokens, each with a unique 16-64-token suffix, 32
# new tokens, FLEET_CLIENTS in flight; the timed turns (F: the fleet, S:
# one replica) and the autoscale burst's clients
FLEET_REQUESTS, SYSTEMS, FLEET_CLIENTS = 64, 8, 16
FLEET_TURNS = "FSSFFS"
BURST_CLIENTS = 64
# the largest leaf of gpt_1p3b in bf16: wte, 50304 x 2048 x 2 bytes
WTE_BYTES = 50304 * 2048 * 2


def _fleet_prompts(vocab, systems=SYSTEMS, n=FLEET_REQUESTS, seed=7):
    rs = np.random.RandomState(seed)
    heads = [rs.randint(0, vocab, 256).tolist() for _ in range(systems)]
    return [heads[i % systems]
            + rs.randint(0, vocab, int(rs.randint(16, 65))).tolist()
            for i in range(n)]


class Births:
    """Phase 3g's replica factory: each call builds an LLMEngine that
    streams gpt_1p3b from the checkpoint onto the card and captures its
    step programs (`FLEET`), and keeps the build's numbers in `log` and a
    weak reference to the engine in `refs` (never the engine, so a retired
    replica's memory can go). Called as
    the router's and the autoscaler's factory it returns the engine
    wrapped in an AsyncLLMEngine."""

    def __init__(self, skeleton, path):
        self.skeleton, self.path, self.log, self.refs = skeleton, path, [], []

    def engine(self, **kw):
        import threading
        import weakref

        from paddle_tpu_torch.serving import LLMEngine

        t0 = time.perf_counter()
        eng = LLMEngine(self.skeleton, checkpoint_path=self.path,
                        **{**FLEET, **kw})
        t1 = time.perf_counter()
        rep = eng.load_report
        self.log.append(dict(
            t0=t0, t1=t1, seconds=t1 - t0, load_s=rep.seconds,
            load_gb_per_s=rep.total_bytes / rep.seconds / 1e9,
            warmup_s=eng.metrics.gauges.get("warmup_seconds"),
            thread=threading.current_thread().name))
        self.refs.append(weakref.ref(eng))
        return eng

    def __call__(self, index):
        from paddle_tpu_torch.serving import AsyncLLMEngine

        return AsyncLLMEngine(self.engine())


async def _sse(port, body, times=None):
    """One streamed /v1/completions exchange: (status, tokens,
    finish_reason, seconds to the first token). `times` gets each token's
    arrival (perf_counter)."""
    t0 = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(dict(body, stream=True)).encode()
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(data)}\r\n\r\n").encode() + data)
    await writer.drain()
    status = int((await reader.readline()).split(b" ")[1])
    while (await reader.readline()).strip():
        pass
    toks, reason, ttft = [], None, None
    while line := await reader.readline():
        if not line.startswith(b"data: ") or line.strip() == b"data: [DONE]":
            continue
        choice = json.loads(line[6:])["choices"][0]
        now = time.perf_counter()
        if choice["token_ids"] and ttft is None:
            ttft = now - t0
        if times is not None:
            times.extend([now] * len(choice["token_ids"]))
        toks += choice["token_ids"]
        reason = choice["finish_reason"] or reason
    writer.close()
    return status, toks, reason, ttft


def _direct_tokens(engine, prompts, clients=FLEET_CLIENTS):
    """`prompts` served by `step()` alone, `clients` live at once (a
    finished request's slot takes the next prompt): their tokens, in
    order."""
    todo, live, out = list(enumerate(prompts))[::-1], {}, {}

    def admit():
        i, p = todo.pop()
        live[i] = engine.get_request(engine.add_request(
            p, max_new_tokens=32, temperature=0.0))

    for _ in range(min(clients, len(todo))):
        admit()
    while live:
        engine.step()
        for i in [i for i, r in live.items() if r.finished]:
            req = live.pop(i)
            out[i] = list(req.output_ids)
            engine.release(req.request_id)
            if todo:
                admit()
    return [out[i] for i in range(len(prompts))]


def _prefix_counts(engines):
    hit = lookup = 0
    for e in engines:
        c = e.metrics.counters
        hit += c.get("prefix_cache_hit_tokens", 0)
        lookup += c.get("prefix_cache_lookup_tokens", 0)
    return hit, lookup


async def _fleet_wave(port, engines, prompts, tag, clients=FLEET_CLIENTS):
    """`prompts` through the server on `port`, streamed, `clients` in
    flight (each sends its next request when its last one ends), over the
    replicas `engines`; the kernels' counts set to 0 just before and read
    just after. Returns ({request id: tokens}, the wave's numbers); fails
    on a request that did not finish, a program built, or a ragged launch
    count off one a layer and step."""
    todo = [(f"{tag}-{i}", p) for i, p in enumerate(prompts)][::-1]
    out, ttft = {}, []

    async def client():
        while todo:
            rid, p = todo.pop()
            s, toks, reason, t = await _sse(port, {
                "prompt": p, "max_tokens": 32, "request_id": rid})
            assert s == 200 and reason == "length" and len(toks) == 32, \
                (rid, s, reason, len(toks))
            out[rid] = toks
            ttft.append(t)

    steps0 = [e.step_count for e in engines]
    traces0 = [e.metrics.counters["jit_traces"] for e in engines]
    hit0, look0 = _prefix_counts(engines)
    _zero_counts()
    t0 = time.perf_counter()
    await asyncio.gather(*[client() for _ in range(clients)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, int8_launches, _ = _read_counts()
    hit1, look1 = _prefix_counts(engines)
    steps = sum(e.step_count - s for e, s in zip(engines, steps0))
    rec = dict(requests=len(prompts), steps=steps, wall_s=wall,
               tok_per_s=32 * len(prompts) / wall,
               http_ttft_p50_ms=float(np.median(ttft)) * 1e3,
               prefix_hit_rate=(hit1 - hit0) / max(1, look1 - look0),
               launches=launches)
    layers = engines[0].model.cfg.num_layers
    assert [e.metrics.counters["jit_traces"] for e in engines] == traces0
    assert launches == layers * steps and not int8_launches, rec
    return out, rec


def _host_gaps(times, windows):
    """The longest gap between two tokens of one stream, over all streams
    (`times`: each stream's arrival times), and the longest of those gaps
    that overlap a window of `windows` ((t0, t1) pairs)."""
    worst = during = 0.0
    for ts in times:
        for a, b in zip(ts, ts[1:]):
            worst = max(worst, b - a)
            if any(a < w1 and b > w0 for w0, w1 in windows):
                during = max(during, b - a)
    return worst, during


def fleet(model, graph_outs, smi):
    """Phase 3g: weights from disk and the replica fleet on gpt_1p3b."""
    return asyncio.run(_fleet(model, graph_outs, smi))


def _holder_chains(ref, depth=6, limit=6):
    """What still holds the object of weakref `ref` (nothing when it is
    gone): up to `limit` chains of `gc.get_referrers`, each link its type
    (a frame its function, file and line), each chain ending at a frame,
    a coroutine, a module or `depth` links. For the record of a retire
    whose engine outlived it."""
    import gc
    import inspect

    obj = ref()
    if obj is None:
        return []
    # `mine`: this search's own frames and referrer lists, never a holder
    chains, seen, mine = [], {id(obj)}, set()

    def describe(o):
        code, frame = ((o.f_code, o) if inspect.isframe(o) else
                       (o.cr_code, o.cr_frame) if inspect.iscoroutine(o)
                       else (None, None))
        if code is None:
            return type(o).__name__
        line = frame.f_lineno if frame is not None else "done"
        return (f"{type(o).__name__} {code.co_name} "
                f"{os.path.basename(code.co_filename)}:{line}")

    def walk(o, path):
        mine.add(id(sys._getframe()))
        refs = gc.get_referrers(o)
        mine.add(id(refs))
        for r in refs:
            if len(chains) >= limit:
                return
            if id(r) in seen or id(r) in mine or r is chains:
                continue
            seen.add(id(r))
            link = path + [describe(r)]
            if inspect.isframe(r) or inspect.iscoroutine(r) or \
                    inspect.ismodule(r) or len(link) >= depth:
                chains.append(link)
            else:
                walk(r, link)

    mine.add(id(sys._getframe()))
    walk(obj, [])
    del obj
    return chains


async def _fleet(model, graph_outs, smi):
    import gc
    import weakref

    from paddle_tpu_torch.distributed.checkpoint import save_sharded_model
    from paddle_tpu_torch.models.gpt import gpt_1p3b
    from paddle_tpu_torch.nn import skeleton_init
    from paddle_tpu_torch.serving import (AsyncLLMEngine, AutoScaler,
                                          ReplicaRouter, RouterServer,
                                          ServingServer)
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    res = dict(card=smi)
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    largest = max(p.numel() * p.element_size() for p in model.parameters())
    assert largest == WTE_BYTES, largest
    ckpt = tempfile.mkdtemp(prefix="fleet-ckpt-")
    try:
        # 1. save
        t0 = time.perf_counter()
        save_sharded_model(model, None, ckpt)
        save_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(ckpt, f))
                   for f in os.listdir(ckpt))
        res["save"] = dict(param_bytes=total, file_bytes=disk,
                           seconds=save_s, gb_per_s=total / save_s / 1e9)

        # 2. stream: two replicas from a skeleton, phase 3's traffic on
        # one, the parameter budget at the model's bytes and one below
        with skeleton_init():
            skeleton = gpt_1p3b(dtype=torch.bfloat16)
        births = Births(skeleton, ckpt)
        replicas = [births.engine(), births.engine()]
        rep = replicas[0].load_report
        res["stream"] = dict(
            report=rep.summary(), largest_leaf_bytes=largest,
            builds=[dict(b) for b in births.log])
        assert rep.total_bytes == total, (rep.total_bytes, total)
        assert rep.max_chip_bytes == total, rep.summary()
        assert rep.peak_host_bytes <= WTE_BYTES, rep.summary()
        outs = serve_waves(replicas[0],
                           _prompts(np.random.RandomState(0),
                                    model.cfg.vocab_size))
        equal = sum(a == b for a, b in zip(outs, graph_outs))
        res["stream"]["phase3_tokens_equal"] = f"{equal}/{len(outs)}"
        assert outs == graph_outs, res["stream"]
        single = births.engine(param_hbm_bytes=total)
        try:
            births.engine(param_hbm_bytes=total - 1, warmup=False,
                          host_kv_blocks=0)
            refused = None
        except ValueError as e:
            refused = str(e)
        gc.collect()
        torch.cuda.empty_cache()
        res["stream"]["budget_refusal"] = refused
        assert refused == (
            f"param_hbm_bytes {total - 1}: a device holds {total} "
            "parameter bytes — the model does not fit one chip. Serve it "
            "from a sharded checkpoint (LLMEngine(skeleton, "
            "checkpoint_path=..., mesh=N)) so no chip ever materializes "
            "the full tree"), refused
        log("[fleet] save " + json.dumps(res["save"]))
        log("[fleet] stream " + json.dumps(res["stream"]))

        # 3. the fleet over HTTP beside one replica. The gate on tokens:
        # two requests a system prompt, one at a time, streamed and not in
        # turn, against a direct engine serving them one at a time: each
        # request's steps then have one composition on both sides, so the
        # tokens must agree bit for bit. (With 16 in flight a row's steps
        # take the width bucket of whatever shares them, and cuBLAS may
        # round a bucket's products otherwise: those waves' agreement is
        # counted, not gated.)
        vocab = model.cfg.vocab_size
        prompts = _fleet_prompts(vocab)
        seq = prompts[:2 * SYSTEMS]
        seq_ref = [single.generate([p], max_new_tokens=32)[0] for p in seq]
        ref = _direct_tokens(single, prompts)
        engines = list(replicas)
        router = ReplicaRouter([AsyncLLMEngine(e) for e in replicas],
                               factory=births)
        del replicas
        server = RouterServer(router, host="127.0.0.1", port=0)
        one = ServingServer(single, host="127.0.0.1", port=0)
        await server.start()
        await one.start()
        routed = {}
        submit = router.submit

        async def recording_submit(*a, **kw):
            rs = await submit(*a, **kw)
            routed[rs.request_id] = rs
            return rs

        router.submit = recording_submit
        homes = {i: router.home_replica(p) for i, p in enumerate(prompts)}
        seq_out = []
        for i, p in enumerate(seq):
            st, toks, reason, _ = await _post(server.port, {
                "prompt": p, "max_tokens": 32, "stream": i % 2 == 0,
                "request_id": f"seq-{i}"})
            assert st == 200 and reason == "length", (i, st, reason)
            seq_out.append(toks)
            assert routed.pop(f"seq-{i}").replica == homes[i], i
        seq_equal = sum(a == b for a, b in zip(seq_out, seq_ref))
        assert seq_equal == len(seq), (seq_equal, len(seq))
        # one wave of prompts neither side has seen, each way: the prefix
        # hit rate affinity keeps under fan-out
        cold = _fleet_prompts(vocab, seed=8)
        cold_runs = {
            "fleet": (await _fleet_wave(server.port, engines, cold,
                                        "cold-f"))[1],
            "single": (await _fleet_wave(one.port, [single], cold,
                                         "cold-s"))[1]}
        # and a fresh set through the fleet with affinity off (least-loaded
        # spread): what affinity is worth under fan-out
        router.affinity = False
        cold_runs["fleet_no_affinity"] = (await _fleet_wave(
            server.port, engines, _fleet_prompts(vocab, seed=9),
            "cold-n"))[1]
        router.affinity = True
        routed.clear()
        runs = {"fleet": [], "single": []}
        waves = {"fleet": [], "single": []}
        home_served = diverted = 0
        for r, way in enumerate(FLEET_TURNS):
            side = "fleet" if way == "F" else "single"
            port, engs = ((server.port, engines) if way == "F"
                          else (one.port, [single]))
            got, rec = await _fleet_wave(port, engs, prompts, f"{way}{r}")
            toks = [got[f"{way}{r}-{i}"] for i in range(len(prompts))]
            rec["tokens_equal_direct"] = sum(
                a == b for a, b in zip(toks, ref))
            runs[side].append(rec)
            waves[side].append(toks)
            if way == "F":
                for i in range(len(prompts)):
                    rs = routed.pop(f"{way}{r}-{i}")
                    home_served += rs.replica == homes[i]
        diverted = int(router.metrics.counters.get(
            "router_affinity_diverted", 0))
        router.submit = submit
        routed.clear()
        short = prompts[:32]
        prof_runs = {}
        for side, port, engs in (("fleet", server.port, engines),
                                 ("single", one.port, [single])):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, rec = await _fleet_wave(port, engs, short, f"p{side}")
            prof_runs[side] = _with_busy(rec, prof)
        res["fleet"] = dict(
            requests=len(prompts), systems=SYSTEMS, clients=FLEET_CLIENTS,
            turns=FLEET_TURNS, waves=runs,
            fleet=_medians(runs["fleet"]), single=_medians(runs["single"]),
            profiled=prof_runs,
            sequential=dict(requests=len(seq), tokens_equal=seq_equal),
            # requests with the same tokens in the first and the last wave
            # of a side (16 in flight each time)
            waves_agree={side: sum(a == b for a, b in zip(w[0], w[-1]))
                         for side, w in waves.items()},
            home_served=home_served, diverted=diverted,
            homes={n: sum(1 for h in homes.values() if h == n)
                   for n in sorted(set(homes.values()))},
            launches=sum(w["launches"] for w in runs["fleet"])
            + prof_runs["fleet"]["launches"])
        res["fleet"]["cold_wave"] = cold_runs
        res["fleet"]["fleet_over_single_tok_per_s"] = (
            res["fleet"]["fleet"]["tok_per_s"]
            / res["fleet"]["single"]["tok_per_s"])
        n_fleet = len(prompts) * FLEET_TURNS.count("F")
        assert home_served + diverted == n_fleet, res["fleet"]
        log("[fleet] http " + json.dumps(res["fleet"]))
        await one.shutdown(drain=True)
        del single, one, engines
        gc.collect()
        torch.cuda.empty_cache()

        # 4. rolling drain under load: each restart streams and captures
        # on a worker thread while the other replica serves
        # the probe: a prompt of a ninth system prompt homed to r0, sent
        # cold just before the drain, which takes r0 out of rotation before
        # any client sends: the probe's blocks are r0's most recent when
        # its restart hands them to the new engine's host tier
        probe = next(p for seed in range(11, 1000)
                     for p in _fleet_prompts(vocab, systems=1, n=1,
                                             seed=seed)
                     if router.home_replica(p) == "r0")
        st, probe_toks, _, cold_ttft = await _sse(server.port, {
            "prompt": probe, "max_tokens": 32, "request_id": "probe-cold"})
        assert st == 200 and len(probe_toks) == 32
        c = router.metrics.counters
        failed0 = c.get("router_requests_failed", 0)
        born0 = len(births.log)
        drain = asyncio.ensure_future(router.rolling_drain())
        await asyncio.sleep(0)
        assert router.replicas[0].state == "draining"
        wave, times, seq = [], [], iter(range(1 << 30))

        async def client():
            k = 0
            while not drain.done() or k < 2:
                n = next(seq)
                k += 1
                ts = []
                wave.append(await _sse(server.port, {
                    "prompt": prompts[n % len(prompts)], "max_tokens": 32,
                    "request_id": f"drain-{n}"}, ts))
                times.append(ts)

        t0 = time.perf_counter()
        await asyncio.gather(*[client() for _ in range(FLEET_CLIENTS)])
        drained = await drain
        drain_s = time.perf_counter() - t0
        restarts = births.log[born0:]
        worst_gap, restart_gap = _host_gaps(
            times, [(b["t0"], b["t1"]) for b in restarts])
        home_eng = router.replicas[0].engine.engine
        swaps0 = home_eng.tier.swap_ins
        st, warm_toks, _, warm_ttft = await _sse(server.port, {
            "prompt": probe, "max_tokens": 32, "request_id": "probe-warm"})
        res["drain"] = dict(
            drained=drained, seconds=drain_s, requests=len(wave),
            failed=sum(1 for s, t, r, _ in wave
                       if s != 200 or r != "length" or len(t) != 32),
            router_failed=int(c.get("router_requests_failed", 0)
                              - failed0),
            restarts=[dict(b) for b in restarts],
            migrated_blocks=int(c.get("router_migrated_blocks", 0)),
            migrations=int(c.get("router_migrations", 0)),
            longest_token_gap_ms=worst_gap * 1e3,
            longest_token_gap_during_restart_ms=restart_gap * 1e3,
            probe_cold_ttft_ms=cold_ttft * 1e3,
            probe_host_warm_ttft_ms=warm_ttft * 1e3,
            probe_swap_ins=home_eng.tier.swap_ins - swaps0,
            probe_tokens_equal=warm_toks == probe_toks)
        d = res["drain"]
        log("[fleet] drain " + json.dumps(d))
        assert drained == ["r0", "r1"] and len(restarts) == 2, d
        assert all(b["thread"] != "MainThread" for b in restarts), d
        assert d["failed"] == 0 and d["router_failed"] == 0, d
        assert d["migrated_blocks"] > 0, d
        assert st == 200 and d["probe_swap_ins"] > 0, d
        assert d["probe_tokens_equal"], d
        del home_eng, wave, times

        # 5. autoscale: one replica, a burst scales up, idle scales down;
        # the card's memory comes back after the retire
        engines = {r.name: weakref.ref(r.engine.engine)
                   for r in router.replicas}
        retired = engines[await router.retire_replica()]
        # the retire has let the replica's memory go when it returns
        # (nothing holds its engine); the baseline is read right after, with
        # one gc.collect() and no wait
        gc.collect()
        earlier_freed = retired() is None
        earlier_holders = _holder_chains(retired)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        scaler = AutoScaler(router, min_replicas=1, max_replicas=2,
                            cooldown_s=1.0, wait_high_s=0.2)
        server.autoscaler = scaler
        await scaler.start()
        born0 = len(births.log)
        burst = []

        async def burster(j):
            # until the scale-up lands, then two more each: the spawned
            # replica takes part of the burst
            k = after = 0
            while after < 2:
                if scaler.metrics.counters.get("autoscale_ups", 0):
                    after += 1
                i = (j + k * BURST_CLIENTS) % len(prompts)
                k += 1
                burst.append(await _sse(server.port, {
                    "prompt": prompts[i], "max_tokens": 32,
                    "request_id": f"burst-{j}-{k}"}))

        t0 = time.perf_counter()
        await asyncio.wait_for(asyncio.gather(
            *[burster(j) for j in range(BURST_CLIENTS)]), 300)
        served_by = {r.name: r.engine.engine.metrics.counters.get(
            "requests_finished", 0) for r in router.replicas}
        while scaler.metrics.counters.get("autoscale_downs", 0) < 1:
            assert time.perf_counter() - t0 < 300, scaler.snapshot()
            await asyncio.sleep(0.25)
        await scaler.stop()
        code, body = await _get(server.port, "/debug/autoscale")
        snap = json.loads(body)
        up = next(x for x in snap["decisions"] if x["action"] == "up")
        down = next(x for x in snap["decisions"] if x["action"] == "down")
        # as for the first retire: read right after the scale-down, with
        # one gc.collect() and no wait
        gc.collect()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        spawned = births.refs[born0]()
        spawned_freed = spawned is None
        holders = ([type(r).__name__ for r in gc.get_referrers(spawned)]
                   if spawned is not None else [])
        del spawned
        res["autoscale"] = dict(
            requests=len(burst), clients=BURST_CLIENTS,
            failed=sum(1 for s, t, r, _ in burst
                       if s != 200 or r != "length" or len(t) != 32),
            spawn_s=up["spawn_s"], spawn_ttft_s=up["spawn_ttft_s"],
            spawned=up["replica"], retired=down["replica"],
            spawn_build=[dict(b) for b in births.log[born0:]],
            finished_by_replica=served_by,
            mem_before_spawn_mib=mem0 / 2**20,
            mem_after_retire_mib=mem1 / 2**20,
            earlier_retire_freed=earlier_freed,
            earlier_retire_holders=earlier_holders,
            spawned_engine_freed=spawned_freed,
            spawned_engine_holders=holders,
            endpoint=code, seconds=time.perf_counter() - t0)
        a = res["autoscale"]
        log("[fleet] autoscale " + json.dumps(a))
        assert a["failed"] == 0 and code == 200, a
        assert a["retired"] == a["spawned"], a
        # nothing holds a retired engine when its retire returns
        assert a["earlier_retire_freed"] and a["spawned_engine_freed"], a
        assert abs(mem1 - mem0) <= 64 * 2**20, a
        await server.shutdown(drain=True)
        del router, server, scaler
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[fleet] seconds {res['seconds']:.1f}")
    return res


# -- phase 3h -----------------------------------------------------------------

# every phase 3h time is of two ranks sharing one card over gloo, each
# collective staged through host memory, steps run eagerly
TP_LABEL = "eager, gloo through the host, two ranks on one card - not a tp speed"


def _tp_mesh():
    """Two ranks on cuda:0 over an explicit gloo backend: the one-card
    departure of serving/sharded.py (NCCL refuses two ranks on a device)."""
    from paddle_tpu_torch.serving import ServingMesh

    return ServingMesh(["cuda:0", "cuda:0"], backend="gloo")


def _tp_counts(engine, steps):
    """Every rank's kernel launches and collective calls since its last
    reset, with the step count they cover: [{rank, ragged, int8, append,
    collectives}]."""
    out = []
    for rep in engine.rank_reports():
        n = rep["launches"]
        out.append(dict(
            rank=rep["rank"], steps=steps,
            ragged=n["ragged_paged_attention.launches"],
            ragged_int8=n["ragged_paged_attention.int8_launches"],
            append=n["kv_quantize_scatter.launches"],
            collectives=rep["collectives"]))
    return out


def _top2_gap(model, prompt, ref, got):
    """At the first token where `got` leaves `ref` (the one-card tokens),
    the one-card model's top-2 logit gap there: how near a tie it was."""
    j = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
    with torch.no_grad():
        lg = model(torch.tensor([prompt + ref[:j]], device="cuda"))[0, -1]
    top2 = torch.topk(lg.float(), 2).values
    return j, (top2[0] - top2[1]).item()


def _tp_gate(engine, counts, kv_dtype):
    """Each rank made one ragged launch a layer and step (all of them the
    int8 variant on an int8 arena, with two appends), and exactly
    `serving_collective_budget` collective calls a step."""
    from paddle_tpu_torch.serving import serving_collective_budget

    L = engine.model.cfg.num_layers
    budget = serving_collective_budget(engine.model.cfg, 2,
                                       engine.quant_collectives)
    for c in counts:
        steps = c["steps"]
        assert c["ragged"] == L * steps, c
        assert c["ragged_int8"] == (L * steps if kv_dtype else 0), c
        assert c["append"] == (2 * L * steps if kv_dtype else 0), c
        assert c["collectives"] == {k: budget.get(k, 0) * steps for k in (
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "send", "recv")}, (
                c, budget)
    return budget


def _tp_wave(engine, prompts):
    """Phase 3's traffic on a tp engine, counts zeroed on every rank just
    before and read just after. Returns (outs, seconds, counts)."""
    engine.rank_reports(zero=True)
    steps0 = engine.step_count
    t0 = time.perf_counter()
    outs = serve_waves(engine, prompts)
    dt = time.perf_counter() - t0
    counts = _tp_counts(engine, engine.step_count - steps0)
    return outs, dt, counts


def tp_serving(model, graph_outs_int8, smi):
    """Phase 3h: tensor-parallel serving of gpt_1p3b at tp=2 on one card,
    two ranks over gloo (serving/sharded.py's one-card departure).

    (a) gpt_1p3b in float32 (TF32 off), phase 3's prompts and traffic:
    LLMEngine(block_size=16, max_batch=8, spec_decoding=True, warmup=True)
    at tp=1 (graphs) against the same at mesh=2 (eager): every request's
    greedy tokens equal (the gate; at a divergence the one-card model's
    top-2 logit gap is printed first). (b) Phase 3's bf16 model saved with
    `save_sharded_model` and streamed per rank into a tp=2 engine with the
    int8 arena and quant_allreduce=True: each rank's load report; on every
    rank 24 int8 ragged launches and 48 appends a step and exactly
    `serving_collective_budget` collective calls a step (gates); its
    tokens' agreement with phase 3b's tp=1 int8 tokens, counted. Seconds
    and tok/s are labelled: eager steps through the host, not a tp
    speed."""
    import gc

    from paddle_tpu_torch.distributed.checkpoint import save_sharded_model
    from paddle_tpu_torch.models.gpt import gpt_1p3b
    from paddle_tpu_torch.nn.layer import skeleton_init
    from paddle_tpu_torch.serving import LLMEngine

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = dict(block_size=16, max_batch=8, spec_decoding=True, warmup=True)
    prompts = _prompts(np.random.RandomState(0), model.cfg.vocab_size)
    res = dict(label=TP_LABEL, card=smi)

    # (a) float32, tp=1 against tp=2
    f32 = gpt_1p3b(device="cuda", dtype=torch.float32, seed=0)
    one = LLMEngine(f32, **build)
    t0 = time.perf_counter()
    want = serve_waves(one, prompts)
    one_s = time.perf_counter() - t0
    del one
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp = LLMEngine(f32, mesh=_tp_mesh(), **build)
    build_s = time.perf_counter() - t0
    try:
        got, dt, counts = _tp_wave(tp, prompts)
        info = tp.mesh_info()
        budget = _tp_gate(tp, counts, None)
    finally:
        tp.close()
    toks = sum(map(len, got))
    equal = sum(a == b for a, b in zip(got, want))
    gaps = [dict(zip(("request", "token", "top2_gap"),
                     (i,) + _top2_gap(f32, prompts[i], want[i], got[i])))
            for i in range(len(want)) if got[i] != want[i]]
    res["f32"] = dict(
        mesh=info, requests=len(want), equal_requests=int(equal),
        divergences=gaps, build_s=build_s, seconds=dt, tok_s=toks / dt,
        one_card_graph_s=one_s, one_card_tok_s=sum(map(len, want)) / one_s,
        steps=counts[0]["steps"], counts=counts, budget_a_step=budget)
    log(f"[tp f32] {smi} | {TP_LABEL} | " + json.dumps(res["f32"]))
    del f32
    gc.collect()
    torch.cuda.empty_cache()
    assert not gaps, f"tp=2 f32 tokens differ from tp=1: {gaps}"
    assert info == {"tp_degree": 2, "device_count": 1,
                    "backend": "cuda-gloo", "kv_dtype": "float32"}, info

    # (b) bf16, int8 arena, EQuARX all-reduce, streamed per rank
    ckpt = tempfile.mkdtemp(prefix="tp-ckpt-")
    try:
        t0 = time.perf_counter()
        save_sharded_model(model, None, ckpt)
        save_s = time.perf_counter() - t0
        with skeleton_init():
            skel = gpt_1p3b(dtype=torch.bfloat16, seed=0)
        t0 = time.perf_counter()
        tp = LLMEngine(skel, checkpoint_path=ckpt, mesh=_tp_mesh(),
                       kv_dtype="int8", quant_allreduce=True, **build)
        build_s = time.perf_counter() - t0
        try:
            loads = [r["load"] for r in tp.rank_reports()]
            got, dt, counts = _tp_wave(tp, prompts)
            budget = _tp_gate(tp, counts, "int8")
            info = tp.mesh_info()
        finally:
            tp.close()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    pairs = [(a, b) for g, w in zip(got, graph_outs_int8)
             for a, b in zip(g, w)]
    res["int8_q"] = dict(
        mesh=info, quant_collectives=["attn_proj", "ffn_fc2"],
        save_s=save_s, build_s=build_s, loads=loads,
        seconds=dt, tok_s=sum(map(len, got)) / dt,
        steps=counts[0]["steps"], counts=counts, budget_a_step=budget,
        tokens=len(pairs), tokens_equal_tp1=int(sum(a == b for a, b in pairs)),
        requests_equal_tp1=int(sum(g == w for g, w in
                                   zip(got, graph_outs_int8))))
    log(f"[tp int8+q] {smi} | {TP_LABEL} | " + json.dumps(res["int8_q"]))
    assert all(len(o) == 32 for o in got), "a request did not finish"
    for rep in loads:
        # a rank holds its shard: under half the model, plus the
        # replicated norms and position embeddings
        assert 0 < rep["max_chip_bytes"] < 0.55 * 2_631_639_040, rep
        assert 0 < rep["peak_host_bytes"] <= 206_045_184 // 2, rep
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[tp] {smi} | phase 3h seconds {res['seconds']:.1f} ({TP_LABEL})")
    return res


# -- phase 3i -----------------------------------------------------------------

# the tp fleet's depth (gpt_1p3b's widths, cut from 24 layers to stay in
# the run's time: every step of its four ranks runs eagerly through gloo)
TP_FLEET_LAYERS = 4


def _card_free_bytes():
    """The card's free bytes (every process's allocations count), after
    this process's cache is emptied."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def tp_fleet(smi):
    """Phase 3i: two tensor-parallel replicas behind the fleet router.

    gpt_1p3b in float32 (TF32 off) at TP_FLEET_LAYERS layers, every width
    full: two replicas LLMEngine(block_size=16, max_batch=8,
    spec_decoding=True, warmup=True, mesh=2 ranks on cuda:0 over gloo),
    four ranks sharing the card, behind `RouterServer` over
    `ReplicaRouter`. Phase 3's 8 prompts over HTTP one at a time (SSE and
    full responses in turn; every request alone in its steps, as phase 3g
    gates tokens) give a one-card engine's greedy tokens exactly (graphs,
    each request alone too). Then one replica is retired: its rank process
    ends, the card's free memory comes back within 64 MiB of its figure
    before that replica was built, the retired engine object is collected
    (after a gc pass; otherwise its holders are recorded), and the other
    replica serves a request with the same tokens. Seconds are labelled
    as phase 3h's."""
    import gc
    import threading
    import types
    import weakref

    from paddle_tpu_torch.models.gpt import gpt_1p3b
    from paddle_tpu_torch.serving import (AsyncLLMEngine, LLMEngine,
                                          ReplicaRouter, RouterServer)

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build = dict(block_size=16, max_batch=8, spec_decoding=True, warmup=True)
    model = gpt_1p3b(num_layers=TP_FLEET_LAYERS, device="cuda",
                     dtype=torch.float32, seed=0)
    prompts = _prompts(np.random.RandomState(0), model.cfg.vocab_size)
    one = LLMEngine(model, **build)
    want = [one.generate([p], max_new_tokens=32)[0] for p in prompts]
    del one
    res = dict(label=TP_LABEL, card=smi, layers=TP_FLEET_LAYERS)
    first = LLMEngine(model, mesh=_tp_mesh(), **build)

    async def run():
        router = ReplicaRouter([AsyncLLMEngine(first)])
        server = RouterServer(router, host="127.0.0.1", port=0)
        await server.start()
        out = {}
        try:
            # the baseline: r0 serving (its thread's cuBLAS workspace, kept
            # for the process's life, allocated), r1 not built yet
            await _post(server.port, {"prompt": prompts[0], "max_tokens": 2})
            out["free0"] = _card_free_bytes()
            out["mem0"] = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            second = LLMEngine(model, mesh=_tp_mesh(), **build)
            out["replica_build_s"] = time.perf_counter() - t0
            second_ranks = list(second._tp.procs)
            await router.add_replica(AsyncLLMEngine(second))
            del second      # the router holds the only reference
            engines = [r.engine.engine for r in router.replicas]
            steps0 = [e.step_count for e in engines]
            # (a comprehension: a for loop's variable would keep the last
            # engine, the one retired below, alive in this frame)
            [e.rank_reports(zero=True) for e in engines]
            t0 = time.perf_counter()
            got = []
            for i, p in enumerate(prompts):
                got.append(await _post(server.port, {
                    "prompt": p, "max_tokens": 32, "stream": i % 2 == 0}))
            out["wave_s"] = time.perf_counter() - t0
            out["got"] = got
            # every rank of both replicas: one ragged launch a layer and
            # step at its 8 heads, the tp budget a step. Both replicas'
            # rank 0 is this process, whose counters hold both
            # controllers' steps; each rank 1 is a process of its own
            steps = [e.step_count - s0 for e, s0 in zip(engines, steps0)]
            out["counts"] = [_tp_counts(e, n) for e, n in zip(engines, steps)]
            for c in out["counts"]:
                c[0]["steps"] = sum(steps)
            out["budget_a_step"] = [_tp_gate(e, c, None) for e, c in
                                    zip(engines, out["counts"])][0]
            del engines     # the retired replica's memory must come back
            out["debug_router_status"] = (
                await _get(server.port, "/debug/router"))[0]
            out["served_by"] = {
                r.name: r.engine.engine.metrics.counters.get(
                    "requests_finished", 0) for r in router.replicas}
            retired = weakref.ref(router.replicas[1].engine.engine)
            t0 = time.perf_counter()
            out["retired"] = await router.retire_replica("r1")
            out["retire_s"] = time.perf_counter() - t0
            out["alive"] = [p.pid for p in second_ranks if p.is_alive()]
            out["card_free1"] = _card_free_bytes()
            out["mem1"] = torch.cuda.memory_allocated()
            out["retired_engine_collected"] = retired() is None
            # after a collection: what a reference cycle held is gone, and
            # whatever still holds the engine is counted (gc-visible or
            # not)
            gc.collect()
            held = retired()
            out["retired_engine_collected_after_gc"] = held is None
            if held is not None:
                here = sys._getframe()
                # a running thread's frames are no objects until asked
                # for: materialise every thread's stack, so a frame that
                # holds the engine shows (with its thread)
                stacks = {}
                for tid, f in sys._current_frames().items():
                    name = next((t.name for t in threading.enumerate()
                                 if t.ident == tid), str(tid))
                    while f is not None:
                        stacks[id(f)] = name
                        f = f.f_back
                refs = []
                for r in gc.get_referrers(held):
                    if r is here:
                        continue
                    if isinstance(r, types.FrameType):
                        # a frame: whose, and what keeps it (a
                        # traceback, a generator, a coroutine)
                        refs.append(dict(
                            frame=f"{r.f_code.co_name} "
                                  f"{os.path.basename(r.f_code.co_filename)}"
                                  f":{r.f_lineno}",
                            thread=stacks.get(id(r)),
                            held_by=[type(x).__name__ for x in
                                     gc.get_referrers(r)][:6]))
                    else:
                        refs.append(type(r).__name__)
                out["retired_engine_holders"] = dict(
                    refcount=sys.getrefcount(held) - 2, gc_visible=refs,
                    this_frame=[k for k, v in here.f_locals.items()
                                if v is held and k != "held"])
            del held
            out["after"] = await _post(server.port, {"prompt": prompts[0],
                                                     "max_tokens": 32})
        finally:
            await server.shutdown(drain=True)
        return out

    out = asyncio.run(run())
    alive, free0, free1, mem0, mem1 = (out.pop(k) for k in (
        "alive", "free0", "card_free1", "mem0", "mem1"))
    first_alive = [p.pid for p in (first._tp.procs if first._tp else [])
                   if p.is_alive()]
    got, after = out.pop("got"), out.pop("after")
    equal = sum(t == w for (_, t, _, _), w in zip(got, want))
    toks = sum(len(t) for _, t, _, _ in got)
    res.update(out, requests=len(got), equal_requests=int(equal),
               tok_s=toks / out["wave_s"],
               statuses=sorted({st for st, _, _, _ in got}),
               retired_rank_pids_alive=alive,
               mem_mib_before_second=mem0 / 2**20,
               mem_mib_after_retire=mem1 / 2**20,
               card_free_mib_before_second=free0 / 2**20,
               card_free_mib_after_retire=free1 / 2**20,
               after_retire_status=after[0],
               after_retire_equal=after[1] == want[0],
               rank_pids_alive_after_shutdown=first_alive,
               seconds=time.perf_counter() - t_phase)
    log(f"[tp fleet] {smi} | {TP_LABEL} | " + json.dumps(res))
    del model, first
    gc.collect()
    torch.cuda.empty_cache()
    assert res["statuses"] == [200] and equal == len(want), res
    assert out["retired"] == "r1" and not alive, res
    assert res["after_retire_equal"], res
    assert abs(mem1 - mem0) <= 64 * 2**20, res
    # nothing holds the retired engine once a collection has run
    assert res["retired_engine_collected_after_gc"], res
    assert not first_alive, res
    return res


# -- phase 4 ------------------------------------------------------------------

def parity():
    from paddle_tpu_torch.models.gpt import gpt_1p3b
    from paddle_tpu_torch.serving import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = gpt_1p3b(num_layers=4, device="cuda", dtype=torch.float32,
                     seed=1)
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, model.cfg.vocab_size, n).tolist()
               for n in (20, 37, 64, 150)]
    got = LLMEngine(model, block_size=16, max_batch=4).generate(
        prompts, max_new_tokens=16, temperature=0.0)
    worst_gap, diverged = 0.0, 0
    for p, g in zip(prompts, got):
        ref = model.generate([p], max_new_tokens=16,
                             temperature=0.0)[0, len(p):].tolist()
        if g == ref:
            continue
        diverged += 1
        j = next(i for i, (a, b) in enumerate(zip(g, ref)) if a != b)
        with torch.no_grad():
            lg = model(torch.tensor([p + ref[:j]], device="cuda"))[0, -1]
        top2 = torch.topk(lg.float(), 2).values
        gap = (top2[0] - top2[1]).item()
        worst_gap = max(worst_gap, gap)
        log(f"[parity] diverged at token {j}: top-2 logit gap {gap:.3g}")
        assert gap <= 1e-3, f"divergence with top-2 gap {gap} > 1e-3"
    res = dict(prompts=len(prompts), diverged=diverged,
               worst_top2_gap=worst_gap)
    log("[parity] " + json.dumps(res))
    return res


def parity_int8():
    """Phase 4b: the int8 engine in float32 on the card (the int8 kernel)
    against the same engine on a CPU copy (the plain version); the greedy
    token parity rate must reach 0.9, the JAX package's int8 gate."""
    from paddle_tpu_torch.models.gpt import GPT, gpt_1p3b
    from paddle_tpu_torch.serving import LLMEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = gpt_1p3b(num_layers=4, device="cuda", dtype=torch.float32,
                    seed=1)
    cfg = cuda.cfg
    cpu = GPT(cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in cuda.state_dict().items()})
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist()
               for n in (20, 37, 64, 150)]
    outs, steps = [], []
    for m in (cuda, cpu):
        eng = LLMEngine(m, device=m.device, kv_dtype="int8", block_size=16,
                        max_batch=4)
        _zero_counts()
        outs.append(eng.generate(prompts, max_new_tokens=16,
                                 temperature=0.0))
        launches, int8_launches, appends = _read_counts()
        steps.append(eng.step_count)
        assert int8_launches == launches == appends // 2 == (
            cfg.num_layers * eng.step_count if m is cuda else 0)
    toks = [(a, b) for ga, gb in zip(*outs) for a, b in zip(ga, gb)]
    rate = float(np.mean([a == b for a, b in toks]))
    res = dict(layers=cfg.num_layers, prompts=len(prompts), tokens=len(toks),
               parity_rate=rate, steps_cuda=steps[0], steps_cpu=steps[1])
    log("[parity-int8] " + json.dumps(res))
    assert rate >= 0.9, res
    del cuda, cpu
    torch.cuda.empty_cache()
    return res


# -- phase 5 ------------------------------------------------------------------

FLASH_SHAPES = {torch.bfloat16: (16, 1024, 8, 128), torch.float32: (2, 1024, 8,
                                                                    128)}


def _flash_bounds(B, S, H, D, dtype, causal=True, mask_bytes=0):
    """Least time of each function at this shape: (ms, bound_by) for the
    forward (2 products over the visible pairs), dK/dV (4: S, dP, dV, dK),
    dQ (3: S, dP, dQ) and the whole backward (5), each against the bytes
    it must move (each [B, S, H, D] input read once, each output written
    once, the f32 LSE / delta rows, and the mask's own bytes once where
    there is one). The dropout bits are computed, not moved, and no
    product: they add nothing to the bound. Products count at the dtype's
    peak, but float32's: its kernels run in 3xTF32, three TF32 passes a
    product on the tensor cores (165 TFLOP/s), so their bounds ("fwd",
    "dkv", ...) are taken at that rate, and the FMA units' 67 TFLOP/s give
    "fwd_fma", "dkv_fma", ... beside them."""
    isz = torch.tensor([], dtype=dtype).element_size()
    # visible (query, key) pairs
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
    t = B * S * H * D * isz                   # one [B, S, H, D] tensor
    rows = B * H * S * 4                      # one f32 LSE or delta
    work = {"fwd": (2, 4 * t + rows), "dkv": (4, 6 * t + 2 * rows),
            "dq": (3, 5 * t + 2 * rows), "bwd": (5, 8 * t + rows)}
    out = {}
    for name, (products, nbytes) in work.items():
        t_bytes = (nbytes + mask_bytes) / HBM_BYTES_PER_S
        peaks = {name: PEAK_FLOPS[dtype]}
        if dtype == torch.float32:
            peaks = {name: PEAK_TF32 / 3, f"{name}_fma": PEAK_FLOPS[dtype]}
        for key, peak in peaks.items():
            t_ops = products * 2 * D * pairs / peak
            out[key] = (max(t_ops, t_bytes) * 1e3,
                        "operations" if t_ops >= t_bytes else "bytes")
    return out


def f32_designs():
    """The float32 kernels' designs, as the comment above each kernel in
    flash_attention.cu states them (`// design: ...`), so the record names
    the design that is built."""
    from paddle_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    out = {}
    for key, kernel in (("fwd", "flash_fwd_f32"), ("dkv", "flash_dkv_f32"),
                        ("dq", "flash_dq_f32")):
        m = re.search(r"// design: (.*(?:\n//   .*)*)\ntemplate <[^>]*>\n"
                      r"__global__[^\n]*(?:\n\s*)?" + kernel + r"\(", src)
        if m is None:
            raise SystemExit(f"no design comment above {kernel}")
        out[key] = re.sub(r"\n//  ", "", m.group(1))
    return out


def f32_ptxas():
    """ptxas's (registers, spill bytes) for the f32 forward, dK/dV and dQ
    kernels at head_dim 64 and 128: one entry each for dK/dV and dQ (the
    plain and the mask / dropout bodies are one kernel, chosen at its
    top), two for the forward (`fwd_*` without the mask / dropout code,
    the main path's; `fwd_var_*` with it). The forward keeps its O sums,
    scores and P fragments in registers: a spill there fails the run."""
    entries = {f"{k}_{d}": f"flash_{k}_f32ILi{d}EE"
               for k in ("dkv", "dq") for d in (64, 128)}
    entries.update({f"fwd{'_var' if v else ''}_{d}":
                    f"flash_fwd_f32ILi{d}ELb{v}EE"
                    for v in (0, 1) for d in (64, 128)})
    out = {}
    for key, entry in sorted(entries.items()):
        regs, spill = ptxas_report("flash_attention.cu", entry)
        if key.startswith("fwd") and spill:
            raise SystemExit(f"ptxas: {entry} spills {spill} bytes")
        out[key] = dict(registers=regs, spill_bytes=spill)
    return out


def _flash_case(dtype, gen):
    from paddle_tpu_torch.ops import flash_attention as fa

    B, S, H, D = FLASH_SHAPES[dtype]
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, do, lse, True)
    # the plain version in float32 on the same values
    # detached first: in float32 .float() is the tensor itself, which
    # must not turn into an autograd leaf for the timings below
    q32, k32, v32 = (t.detach().float().requires_grad_()
                     for t in (q, k, v))
    o32 = fa.attention_ref(q32, k32, v32, True)
    o32.backward(do.float())
    lse32 = fa.attention_lse_ref(q32.detach(), k32.detach(), True)
    torch.cuda.synchronize()
    err = {n: (a.float() - b).abs().max().item() for n, a, b in (
        ("o", o, o32), ("lse", lse, lse32), ("dq", dq, q32.grad),
        ("dk", dk, k32.grad), ("dv", dv, v32.grad))}
    del o32, q32, k32, v32
    delta = fa._delta(o, do)

    def plain_fwd():
        return fa.attention_ref(q, k, v, True)

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    og = fa.attention_ref(qg, kg, vg, True)

    def plain_bwd():
        torch.autograd.grad(og, (qg, kg, vg), do, retain_graph=True)

    F = torch.nn.functional
    ql, kl, vl = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dol = do.transpose(1, 2).contiguous()

    def library_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True), (ql, kl, vl), dol)

    times = dict(
        fwd_ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, True), 20),
        bwd_ms=time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                      True), 10),
        dkv_ms=time_ms(lambda: fa._launch_bwd(q, k, v, do, lse, delta, True,
                                              1), 10),
        dq_ms=time_ms(lambda: fa._launch_bwd(q, k, v, do, lse, delta, True,
                                             2), 10),
        plain_fwd_ms=event_ms(plain_fwd, 3),
        plain_bwd_ms=event_ms(plain_bwd, 3),
        library_fwd_ms=time_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True), 20),
        library_fwd_bwd_ms=time_ms(library_fwd_bwd, 10))
    times["library_bwd_ms"] = (times["library_fwd_bwd_ms"]
                               - times["library_fwd_ms"])
    bounds = _flash_bounds(B, S, H, D, dtype)
    rec = dict(dtype=str(dtype).replace("torch.", ""), shape=[B, S, H, D],
               causal=True, max_err=err, tol=TOL[dtype], **times,
               **{f"bound_{n}_ms": b[0] for n, b in bounds.items()},
               **{f"bound_{n}_by": b[1] for n, b in bounds.items()})
    if dtype == torch.float32:
        rec.update(f32_tol=F32_FLASH_TOL, design=f32_designs(),
                   ptxas=f32_ptxas())
    log("[flash] " + json.dumps(rec))
    if dtype == torch.float32 and max(err.values()) > F32_FLASH_TOL:
        raise SystemExit(f"a float32 flash kernel misses {F32_FLASH_TOL}: "
                         f"{rec}")
    if max(err.values()) > TOL[dtype]:
        raise SystemExit(f"a flash kernel disagrees with the plain version: "
                         f"{rec}")
    return rec


def flash_cases():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = [_flash_case(dt, gen) for dt in (torch.bfloat16, torch.float32)]
    torch.cuda.empty_cache()
    return out


# -- phase 5b -----------------------------------------------------------------

ERNIE_SHAPE = (32, 512, 12, 64)   # B, S, H, D of the ERNIE pretrain step
# name, dtype, (B, S, H, D), causal, padding mask, dropout p
VARIANT_CASES = [
    ("ernie_mask_dropout", torch.bfloat16, ERNIE_SHAPE, False, True, 0.1),
    ("ernie_mask", torch.bfloat16, ERNIE_SHAPE, False, True, 0.0),
    ("ernie_dropout", torch.bfloat16, ERNIE_SHAPE, False, False, 0.1),
    ("ernie_no_mask_no_dropout", torch.bfloat16, ERNIE_SHAPE, False, False,
     0.0),
    ("flagship_causal_dropout", torch.bfloat16, (16, 1024, 8, 128), True,
     False, 0.1),
    ("f32_mask_dropout", torch.float32, (2, 512, 12, 64), False, True, 0.1),
    # an mp=2 rank's share (phase 6e): its heads and their offset in the
    # model's (the keep bits' head coordinate), at the flagship step's
    # shape (4 rows, 4 of 8 heads) and at ERNIE's (6 of 12 heads)
    ("flagship_mp2_rank", torch.bfloat16, (4, 1024, 4, 128), True, False,
     0.0, (4, 8)),
    ("flagship_mp2_rank_dropout", torch.bfloat16, (4, 1024, 4, 128), True,
     False, 0.1, (4, 8)),
    ("ernie_mp2_rank_mask_dropout", torch.bfloat16, (32, 512, 6, 64), False,
     True, 0.1, (6, 12)),
    ("f32_mp2_rank_mask_dropout", torch.float32, (2, 512, 6, 64), False,
     True, 0.1, (6, 12)),
    # a pipelined gpt_1p3b stage's attention at pp2 x mp2 (phase 6f (b)):
    # float32, 2 rows a microbatch, 8 of 16 heads a rank (heads 0-7 and
    # 8-15), head_dim 128, causal
    ("pp_stage_f32_heads0", torch.float32, (2, 1024, 8, 128), True, False,
     0.0, (0, 16)),
    ("pp_stage_f32_heads8", torch.float32, (2, 1024, 8, 128), True, False,
     0.0, (8, 16)),
]
DROPOUT_SEED = 20261016


def padding_lengths(batch, seq, rs):
    """Per-row real lengths, uniform in seq/2 .. seq (256-512 at 512)."""
    return rs.randint(seq // 2, seq + 1, batch)


def padding_mask(lengths, seq, device):
    """ERNIE's additive padding mask [B, 1, 1, S] f32: 0 on real keys,
    -1e4 on padding ((1 - mask) * -1e4)."""
    real = np.arange(seq)[None] < np.asarray(lengths)[:, None]
    m = np.where(real, 0.0, -1e4).astype(np.float32)
    return torch.from_numpy(m)[:, None, None, :].to(device)


def _qkv_views(shape, dtype, causal, gen):
    """q, k, v as the models hand them to attention: strided views of one
    fused projection [B, S, 3 * H * D], split in the model's column order
    (ERNIE's [3, heads, head_dim] for the bidirectional cases, GPT's
    per-head groups for the causal one), so the kernels read the strides
    of the main path."""
    from paddle_tpu_torch.models.bert import split_qkv
    from paddle_tpu_torch.models.gpt import _split_fused_qkv

    B, S, H, D = shape
    qkv = torch.randn((B, S, 3 * H * D), generator=gen, device="cuda").to(
        dtype)
    return (_split_fused_qkv if causal else split_qkv)(qkv, B, S, H, D)


def _variant_case(name, dtype, shape, causal, with_mask, p, heads, gen):
    """Phase 5b: the three kernels with the additive mask and/or dropout
    against the plain version in float32 on the same values, mask and
    seed (so the same Philox bits: exact up to rounding), with the
    kernels', the plain version's and SDPA's times (the same mask and
    dropout_p) beside the least time the card could take. q, k and v are
    the strided views of a fused projection (`_qkv_views`). With `heads`
    ``(offset, total)`` the call holds heads ``[offset, offset + H)`` of
    the model's `total` (an mp rank's share): kernels and plain version
    draw those heads' keep bits, and the kernels' O must equal those
    heads of one call over all `total` heads."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, S, H, D = shape
    q, k, v = _qkv_views(shape, dtype, causal, gen)
    do = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
    mask = (padding_mask(padding_lengths(B, S, np.random.RandomState(0)),
                         S, "cuda") if with_mask else None)
    seed = DROPOUT_SEED if p > 0 else None
    off, total = heads or (0, H)
    var = (causal, mask, p, seed)
    hk = dict(head_offset=off, heads_total=total)
    # with dropout the forward also writes O in f32 for the backward's
    # delta, as FlashAttention does
    o_f32 = torch.empty(q.shape, device="cuda") if p > 0 else None
    o, lse = fa.flash_attention_fwd(q, k, v, *var, o_f32, **hk)
    o_bwd = o if o_f32 is None else o_f32
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o_bwd, do, lse, *var,
                                        **hk)
    whole_err = None
    if heads is not None:
        # the same heads inside one call over all of the model's heads
        full = [torch.zeros((B, S, total, D), dtype=dtype, device="cuda")
                for _ in range(3)]
        for f, t in zip(full, (q, k, v)):
            f[:, :, off:off + H] = t
        o_full, _ = fa.flash_attention_fwd(
            *full, causal, mask, p, seed,
            torch.empty(full[0].shape, device="cuda") if p > 0 else None)
        whole_err = (o_full[:, :, off:off + H].float()
                     - o.float()).abs().max().item()
        del full, o_full
    # detached first: in float32 .float() is the tensor itself, which
    # must not turn into an autograd leaf for the timings below
    q32, k32, v32 = (t.detach().float().requires_grad_()
                     for t in (q, k, v))
    o32 = fa.attention_ref(q32, k32, v32, *var, **hk)
    o32.backward(do.float())
    lse32 = fa.attention_lse_ref(q32.detach(), k32.detach(), causal, mask)
    torch.cuda.synchronize()
    err = {n: (a.float() - b).abs().max().item() for n, a, b in (
        ("o", o, o32), ("lse", lse, lse32), ("dq", dq, q32.grad),
        ("dk", dk, k32.grad), ("dv", dv, v32.grad))}
    del o32, q32, k32, v32, lse32
    delta = fa._delta(o_bwd, do)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    og = fa.attention_ref(qg, kg, vg, *var, **hk)

    def plain_bwd():
        torch.autograd.grad(og, (qg, kg, vg), do, retain_graph=True)

    F = torch.nn.functional
    ql, kl, vl = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dol = do.transpose(1, 2).contiguous()
    lib_kw = dict(attn_mask=None if mask is None else mask.to(dtype),
                  dropout_p=p, is_causal=causal)

    def library_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(
            ql, kl, vl, **lib_kw), (ql, kl, vl), dol)

    times = dict(
        fwd_ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, *var, o_f32,
                                                      **hk), 20),
        dkv_ms=time_ms(lambda: fa._launch_bwd(q, k, v, do, lse, delta,
                                              causal, 1, *var[1:], **hk), 10),
        dq_ms=time_ms(lambda: fa._launch_bwd(q, k, v, do, lse, delta,
                                             causal, 2, *var[1:], **hk), 10),
        plain_fwd_ms=event_ms(lambda: fa.attention_ref(q, k, v, *var, **hk),
                              3),
        plain_bwd_ms=event_ms(plain_bwd, 3),
        library_fwd_ms=time_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, **lib_kw), 10),
        library_fwd_bwd_ms=time_ms(library_fwd_bwd, 10))
    times["bwd_ms"] = times["dkv_ms"] + times["dq_ms"]
    times["library_bwd_ms"] = (times["library_fwd_bwd_ms"]
                               - times["library_fwd_ms"])
    bounds = _flash_bounds(B, S, H, D, dtype, causal,
                           0 if mask is None else mask.numel() * 4)
    rec = dict(case=name, dtype=str(dtype).replace("torch.", ""),
               shape=[B, S, H, D], causal=causal,
               mask=None if mask is None else list(mask.shape),
               dropout_p=p, head_offset=off, heads_total=total,
               whole_call_o_err=whole_err, max_err=err, tol=TOL[dtype],
               **times,
               **{f"bound_{n}_ms": b[0] for n, b in bounds.items()},
               **{f"bound_{n}_by": b[1] for n, b in bounds.items()})
    if dtype == torch.float32:
        rec["f32_tol"] = F32_FLASH_TOL
    log("[flash-variant] " + json.dumps(rec))
    if dtype == torch.float32 and max(*err.values(), whole_err or 0.0) > \
            F32_FLASH_TOL:
        raise SystemExit(f"a float32 flash kernel variant misses "
                         f"{F32_FLASH_TOL}: {rec}")
    if max(err.values()) > TOL[dtype] or (whole_err or 0.0) > TOL[dtype]:
        raise SystemExit(f"a flash kernel variant disagrees with the plain "
                         f"version: {rec}")
    return rec


def variant_cases():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    out = []
    for case in VARIANT_CASES:
        name, dtype, shape, causal, with_mask, p, *heads = case
        out.append(_variant_case(name, dtype, shape, causal, with_mask, p,
                                 heads[0] if heads else None, gen))
        torch.cuda.empty_cache()
    return out


# -- phase 6 ------------------------------------------------------------------

def _zero_flash_counts():
    from paddle_tpu_torch.ops import flash_attention as fa

    for f in (fa.flash_attention_fwd, fa.flash_attention_bwd):
        f.launches = f.mask_launches = f.dropout_launches = 0


def _read_flash_counts():
    from paddle_tpu_torch.ops import flash_attention as fa

    return {f"{d}_{n}": getattr(f, n)
            for d, f in (("fwd", fa.flash_attention_fwd),
                         ("bwd", fa.flash_attention_bwd))
            for n in ("launches", "mask_launches", "dropout_launches")}


def flagship_config(**kw):
    """bench.py's bench_gpt on a TPU: vocab 32768, hidden 1024, 12 layers,
    8 heads (head_dim 128), seq 1024, no dropout, flash attention."""
    from paddle_tpu_torch.models.gpt import GPTConfig

    cfg = dict(vocab_size=32768, hidden_size=1024, num_layers=12,
               num_heads=8, max_seq_len=1024, attn_impl="flash")
    cfg.update(kw)
    return GPTConfig(**cfg)


def train_batch(cfg, batch, seq, device):
    """ids and labels from np.random.RandomState(0), as bench.py draws
    them."""
    rs = np.random.RandomState(0)
    return [torch.from_numpy(rs.randint(0, cfg.vocab_size, (batch, seq)))
            .to(device) for _ in range(2)]


def train_step(model, opt, ids, labels):
    loss = model(ids, labels=labels)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss


def flagship_trainer(seed=0):
    """The flagship GPT in bf16 on the card with AdamW(1e-4), in train
    mode, and its batch of 16 x 1024."""
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.optimizer import AdamW

    cfg = flagship_config()
    model = GPT(cfg, device="cuda", dtype=torch.bfloat16, seed=seed)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    model.train()
    return model, opt, train_batch(cfg, 16, cfg.max_seq_len, "cuda")


def train(smi):
    from paddle_tpu_torch.profiler.flops import (gpt_train_flops_per_token,
                                                 mfu, peak_flops)

    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated() / 2**30
    model, opt, (ids, labels) = flagship_trainer()
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[train] flagship GPT bf16, {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    losses = [train_step(model, opt, ids, labels).item()]   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    steps, step_ms = 10, []
    for _ in range(steps):
        t1 = time.perf_counter()
        loss = train_step(model, opt, ids, labels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss.item())
    counts = _read_flash_counts()
    fwd, bwd = counts["fwd_launches"], counts["bwd_launches"]
    tokens = ids.numel()
    tok_s = tokens * steps / (sum(step_ms) / 1e3)
    fpt = gpt_train_flops_per_token(cfg)
    res = dict(
        batch=list(ids.shape), steps=steps, params=n_params,
        tokens_per_s=tok_s, step_p50_ms=float(np.median(step_ms)),
        step_ms=step_ms, flops_per_token=fpt,
        mfu=mfu(tok_s, fpt, torch.cuda.get_device_name(0)),
        peak_flops=peak_flops(torch.cuda.get_device_name(0)), card=smi,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        base_mem_gib=base,
        losses=losses, fwd_launches=fwd, bwd_launches=bwd,
        layers=cfg.num_layers)
    log("[train] " + json.dumps(res))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert fwd == cfg.num_layers * steps, (fwd, steps)
    assert bwd == cfg.num_layers * steps, (bwd, steps)
    del model, opt
    torch.cuda.empty_cache()
    return res


# -- phase 7 ------------------------------------------------------------------

def train_parity():
    """Two float32 AdamW steps of the flagship widths at 2 layers on the
    card and on a CPU copy, then one more pair of models with
    `remat=True` for one step (the recomputed forward on the card runs
    the kernels twice). Losses agree to 1e-5 relative; parameters to
    2e-5 (a tenth of the two steps' lr: Adam divides each gradient by its
    own magnitude, so two summation orders of a small gradient can move
    its entry by a visible share of a step), except entries whose first
    gradient is float noise (below 1e-6 of the largest in its tensor; the
    key biases' true gradient is zero), which Adam may move by up to lr a
    step either way."""
    res = _gpt_parity(flagship_config(num_layers=2), steps=2)
    res["remat"] = _gpt_parity(flagship_config(num_layers=2, remat=True),
                               steps=1)
    log("[train-parity] " + json.dumps(res))
    return res


def _gpt_parity(cfg, steps, lr=1e-4):
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    param_tol = 0.1 * lr * steps
    cuda = GPT(cfg, device="cuda", seed=2)
    cpu = GPT(cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in cuda.state_dict().items()})
    _zero_flash_counts()
    losses, grads, params = [], [], []
    for m in (cuda, cpu):
        ids, labels = train_batch(cfg, 2, 256, m.device)
        opt = AdamW(learning_rate=lr, parameters=m.parameters())
        m.train()
        run = []
        for i in range(steps):
            loss = m(ids, labels=labels)
            loss.backward()
            if i == 0:
                grads.append({n: p.grad.detach().cpu()
                              for n, p in m.named_parameters()})
            opt.step()
            opt.zero_grad(set_to_none=True)
            run.append(loss.item())
        losses.append(run)
        params.append({n: p.detach().cpu() for n, p in m.named_parameters()})
    counts = _read_flash_counts()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    worst, noisy = 0.0, 0
    for n, want in params[1].items():
        d = (params[0][n] - want).abs()
        g = grads[1][n].abs()
        noise = g < 1e-6 * g.max()
        noisy += int(noise.sum())
        assert bool((d[noise] <= 2 * steps * lr).all()), n
        if (~noise).any():
            worst = max(worst, d[~noise].max().item())
    res = dict(layers=cfg.num_layers, remat=cfg.remat, batch=[2, 256],
               steps=steps, losses_cuda=losses[0], losses_cpu=losses[1],
               loss_rel_err=loss_err, param_max_err=worst,
               noise_entries=noisy, param_tol=param_tol,
               fwd_launches=counts["fwd_launches"],
               bwd_launches=counts["bwd_launches"])
    assert loss_err < 1e-5, res
    assert worst < param_tol, res
    n = cfg.num_layers * steps
    assert res["fwd_launches"] == (2 if cfg.remat else 1) * n, res
    assert res["bwd_launches"] == n, res
    del cuda, cpu
    torch.cuda.empty_cache()
    return res


# -- phase 8 ------------------------------------------------------------------

def ernie_batch(vocab, batch, seq, device):
    """The ERNIE pretrain batch from np.random.RandomState(0): per-row real
    lengths uniform in seq/2 .. seq, token ids (0 on padding), type ids (0
    on the first half of a row's real tokens, 1 on the second), the
    additive padding mask [B, 1, 1, S], MLM labels (the token id at 15 %
    of real positions, -100 elsewhere). Returns (ids, type_ids, mask,
    labels, lengths)."""
    rs = np.random.RandomState(0)
    lens = padding_lengths(batch, seq, rs)
    pos = np.arange(seq)[None]
    real = pos < lens[:, None]
    ids = np.where(real, rs.randint(0, vocab, (batch, seq)), 0)
    type_ids = (real & (pos >= (lens // 2)[:, None])).astype(np.int64)
    labels = np.where(real & (rs.rand(batch, seq) < 0.15), ids, -100)
    to = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)  # noqa
    return (to(ids), to(type_ids), padding_mask(lens, seq, device),
            to(labels), lens)


def ernie_step(model, opt, ids, type_ids, mask, labels):
    from paddle_tpu_torch.models.bert import bert_pretrain_loss_fn

    logits, nsp = model(ids, type_ids, mask)
    loss = bert_pretrain_loss_fn((logits, nsp), labels)
    loss.backward()
    opt.step()
    opt.zero_grad(set_to_none=True)
    return loss


def ernie_trainer(seed=0):
    """ernie_base in bf16 on the card with AdamW(1e-4, weight decay 0.01),
    in train mode (dropout 0.1), its batch (ids, type_ids, mask, labels)
    of 32 x 512 and the rows' real lengths."""
    from paddle_tpu_torch.models.bert import ernie_base
    from paddle_tpu_torch.optimizer import AdamW

    model = ernie_base(device="cuda", dtype=torch.bfloat16, seed=seed)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    model.train()
    *batch, lens = ernie_batch(model.cfg.vocab_size, 32, 512, "cuda")
    return model, opt, tuple(batch), lens


def ernie_pretrain(smi):
    """Phase 8: ernie_base (hidden 768, 12 layers, 12 heads, vocab 40000)
    in bf16 with AdamW(1e-4, weight decay 0.01), dropout 0.1, batch 32 x
    512 with padding: one warm-up step, then 10 timed steps on the same
    batch. Every attention call is the mask + dropout variant of the three
    kernels: 12 forward and 12 backward launches a step."""
    from paddle_tpu_torch.profiler.flops import (bert_train_flops_per_token,
                                                 mfu, peak_flops)

    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated() / 2**30
    model, opt, batch, lens = ernie_trainer()
    cfg = model.cfg
    ids = batch[0]
    B, S = ids.shape
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[ernie] ernie_base bf16, {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    losses = [ernie_step(model, opt, *batch).item()]        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    steps, step_ms = 10, []
    for _ in range(steps):
        t1 = time.perf_counter()
        loss = ernie_step(model, opt, *batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss.item())
    counts = _read_flash_counts()
    tokens, real = ids.numel(), int(lens.sum())
    secs = sum(step_ms) / 1e3
    fpt = bert_train_flops_per_token(cfg, S)
    tok_s = tokens * steps / secs
    res = dict(
        batch=[B, S], steps=steps, params=n_params, dropout=cfg.dropout,
        real_tokens_per_step=real, tokens_per_s=tok_s,
        real_tokens_per_s=real * steps / secs,
        step_p50_ms=float(np.median(step_ms)), step_ms=step_ms,
        flops_per_token=fpt,
        flops_per_token_formula=("6 * (L * (4 H^2 + 2 H F) + H^2 + V H) "
                                 "+ 12 L S H (bidirectional attention, "
                                 "every position counted, padding too)"),
        mfu=mfu(tok_s, fpt, torch.cuda.get_device_name(0)),
        peak_flops=peak_flops(torch.cuda.get_device_name(0)), card=smi,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        base_mem_gib=base,
        losses=losses, layers=cfg.num_layers, **counts)
    log("[ernie] " + json.dumps(res))
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-3:]) < losses[0], losses
    n = cfg.num_layers * steps
    for d in ("fwd", "bwd"):
        assert (counts[f"{d}_launches"], counts[f"{d}_mask_launches"],
                counts[f"{d}_dropout_launches"]) == (n, n, n), counts
    del model, opt
    torch.cuda.empty_cache()
    return res


def gpt_dropout_train():
    """Phase 8b: the flagship GPT with dropout 0.1 (bf16, AdamW(1e-4),
    batch 16 x 1024), 3 steps: finite losses, and 12 forward and 12
    backward dropout launches a step (causal, no mask)."""
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.optimizer import AdamW

    cfg = flagship_config(dropout=0.1)
    model = GPT(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    model.train()
    ids, labels = train_batch(cfg, 16, cfg.max_seq_len, "cuda")
    _zero_flash_counts()
    steps, losses, step_ms = 3, [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(train_step(model, opt, ids, labels).item())
        step_ms.append((time.perf_counter() - t1) * 1e3)
    counts = _read_flash_counts()
    res = dict(dropout=cfg.dropout, steps=steps, losses=losses,
               step_ms=step_ms, **counts)
    log("[train-dropout] " + json.dumps(res))
    assert all(np.isfinite(losses)), losses
    n = cfg.num_layers * steps
    for d in ("fwd", "bwd"):
        assert (counts[f"{d}_launches"], counts[f"{d}_mask_launches"],
                counts[f"{d}_dropout_launches"]) == (n, 0, n), counts
    del model, opt
    torch.cuda.empty_cache()
    return res


# -- phase 9 ------------------------------------------------------------------

def ernie_parity():
    """Phase 9: ERNIE widths at 2 layers, batch 2, seq 128, padding mask,
    dropout 0, float32 with TF32 off: two AdamW steps on the card (the
    kernels' mask variant) and on a CPU copy (plain attention) give the
    same losses and parameters, with phase 7's rule; then one step of a
    pair with `remat=True`. The pooler and the NSP head get no gradient
    from the MLM loss: AdamW takes it as zero and decays them, on both
    sides alike."""
    from paddle_tpu_torch.models.bert import BertConfig

    res = _ernie_parity(BertConfig(vocab_size=40000, num_layers=2,
                                   dropout=0.0), steps=2)
    res["remat"] = _ernie_parity(BertConfig(vocab_size=40000, num_layers=2,
                                            dropout=0.0, remat=True),
                                 steps=1)
    log("[ernie-parity] " + json.dumps(res))
    return res


def _ernie_parity(cfg, steps, lr=1e-4):
    from paddle_tpu_torch.models.bert import Bert, bert_pretrain_loss_fn
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    param_tol = 0.1 * lr * steps
    cuda = Bert(cfg, device="cuda", seed=3)
    cpu = Bert(cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in cuda.state_dict().items()})
    _zero_flash_counts()
    losses, grads, params = [], [], []
    for m in (cuda, cpu):
        ids, type_ids, mask, labels, _ = ernie_batch(cfg.vocab_size, 2, 128,
                                                     m.device)
        opt = AdamW(learning_rate=lr, parameters=m.parameters())
        m.train()
        run = []
        for i in range(steps):
            logits, nsp = m(ids, type_ids, mask)
            loss = bert_pretrain_loss_fn(logits, labels)
            loss.backward()
            if i == 0:
                grads.append({n: p.grad.detach().cpu()
                              for n, p in m.named_parameters()
                              if p.grad is not None})
            opt.step()
            opt.zero_grad(set_to_none=True)
            run.append(loss.item())
        losses.append(run)
        params.append({n: p.detach().cpu() for n, p in m.named_parameters()})
    counts = _read_flash_counts()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    assert set(grads[0]) == set(grads[1])
    worst, noisy = 0.0, 0
    for n, want in params[1].items():
        d = (params[0][n] - want).abs()
        if n not in grads[1]:             # no gradient: weight decay alone
            worst = max(worst, d.max().item())
            continue
        g = grads[1][n].abs()
        noise = g < 1e-6 * g.max()
        noisy += int(noise.sum())
        assert bool((d[noise] <= 2 * steps * lr).all()), n
        if (~noise).any():
            worst = max(worst, d[~noise].max().item())
    res = dict(layers=cfg.num_layers, remat=cfg.remat, batch=[2, 128],
               steps=steps, losses_cuda=losses[0], losses_cpu=losses[1],
               loss_rel_err=loss_err, param_max_err=worst,
               noise_entries=noisy, param_tol=param_tol,
               no_grad_params=sorted(set(params[1]) - set(grads[1])),
               **counts)
    assert loss_err < 1e-5, res
    assert worst < param_tol, res
    n = cfg.num_layers * steps
    fwd = (2 if cfg.remat else 1) * n
    assert (counts["fwd_mask_launches"], counts["fwd_launches"]) == \
        (fwd, fwd), counts
    assert counts["bwd_mask_launches"] == counts["bwd_launches"] == n, counts
    del cuda, cpu
    torch.cuda.empty_cache()
    return res


# -- phase 6c -----------------------------------------------------------------
#
# Runs after phase 9: it sets its figures beside phases 6 and 8.

def _surface_trainer(remat, num_layers=12, lr=None):
    """The flagship GPT (`flagship_config`) built in float32 on the card,
    with AdamW(weight decay 0.01) whose learning rate is `lr` (None: the
    slice's schedule, LinearWarmup(CosineAnnealingDecay(1e-4, T_max=100),
    5 warm-up steps from 0 to 1e-4)) and whose grad_clip is
    ClipGradByGlobalNorm(1.0), put through amp.decorate(level="O2"): bf16
    parameters, float32 masters seeded before the cast. Returns (model,
    opt, scheduler or None, clip, (ids, labels) of 16 x 1024)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPT
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    cfg = flagship_config(num_layers=num_layers, remat=remat)
    model = GPT(cfg, device="cuda", seed=0)
    sched = None
    if lr is None:
        sched = lr = LinearWarmup(CosineAnnealingDecay(1e-4, T_max=100),
                                  warmup_steps=5, start_lr=0.0, end_lr=1e-4)
    clip = ClipGradByGlobalNorm(1.0)
    opt = AdamW(learning_rate=lr, weight_decay=0.01, grad_clip=clip,
                parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2")
    model.train()
    return model, opt, sched, clip, train_batch(cfg, 16, cfg.max_seq_len,
                                                "cuda")


def _masters_consistent(model, opt):
    """Every parameter bf16 with a float32 master, and equal bit for bit
    to the master's bf16 rounding."""
    for p in model.parameters():
        m = opt.state[p].get("master_weight")
        if (p.dtype != torch.bfloat16 or m is None
                or m.dtype != torch.float32
                or not torch.equal(p, m.to(torch.bfloat16))):
            return False
    return True


def _surface_run(smi, remat, steps):
    """Phase 6c (a)'s run: one warm-up step, then `steps` timed steps,
    each an `InstrumentedStep` under the train tracer with
    `scheduler.step()` after it; the flash counts set to 0 just before the
    timed steps and read just after; each timed step (all but the loss
    read) under ``torch.cuda.set_sync_debug_mode("error")``."""
    from paddle_tpu_torch.profiler import tracing
    from paddle_tpu_torch.profiler.flops import (gpt_train_flops_per_token,
                                                 mfu)

    base = torch.cuda.memory_allocated() / 2**30
    model, opt, sched, clip, (ids, labels) = _surface_trainer(remat)
    cfg = model.cfg
    tracing.reset_train_tracing()
    tr = tracing.enable_train_tracing()
    step = tracing.InstrumentedStep(train_step, {"remat": remat})
    losses, norms, lrs, lr_ok, masters_ok, step_ms = [], [], [], [], [], []

    def one(timed):
        want_lr = np.float32(sched())
        t1 = time.perf_counter()
        if timed:
            torch.cuda.set_sync_debug_mode("error")
        try:
            loss = step(model, opt, ids, labels)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        if timed:
            step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss.item())
        norms.append(clip.global_norm.item())
        masters_ok.append(_masters_consistent(model, opt))
        lrs.append(float(opt._last_lr))
        lr_ok.append(opt._last_lr == want_lr)
        sched.step()

    one(timed=False)                                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    for _ in range(steps):
        one(timed=True)
    counts = _read_flash_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    trace = json.loads(json.dumps(tr.chrome_trace()))
    tracing.reset_train_tracing()
    evs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    spans = {e["args"]["step"]: e for e in evs if e["name"] == "train_step"}
    dispatch = {e["args"]["step"] for e in evs if e["name"] == "dispatch"}
    tok_s = ids.numel() * steps / (sum(step_ms) / 1e3)
    fpt = gpt_train_flops_per_token(cfg)
    res = dict(
        remat=remat, batch=list(ids.shape), steps=steps,
        step_p50_ms=float(np.median(step_ms)), step_ms=step_ms,
        tokens_per_s=tok_s, flops_per_token=fpt,
        mfu=mfu(tok_s, fpt, torch.cuda.get_device_name(0)),
        peak_mem_gib=peak, base_mem_gib=base, losses=losses,
        pre_clip_norms=norms,
        lrs=lrs, lr_matches=all(lr_ok),
        masters_consistent=all(masters_ok), train_step_spans=len(spans),
        spans_with_dispatch=len(set(spans) & dispatch), card=smi,
        layers=cfg.num_layers, **counts)
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert all(np.isfinite(norms)), norms
    assert res["lr_matches"] and res["masters_consistent"], res
    n = cfg.num_layers * steps
    assert counts["fwd_launches"] == (2 if remat else 1) * n, counts
    assert counts["bwd_launches"] == n, counts
    assert len(spans) == len(dispatch) == steps + 1 \
        == res["spans_with_dispatch"], (len(spans), len(dispatch))
    del model, opt
    torch.cuda.empty_cache()
    return res


def _ernie_remat(smi, steps=3):
    """Phase 6c (b): ernie_base with remat=True, bf16, dropout 0.1, AdamW(
    1e-4, weight decay 0.01), phase 8's batch of 32 x 512 with padding:
    one warm-up step, then `steps` steps counted: 24 forward launches (12
    recomputed) and 12 backward a step, every one mask + dropout."""
    from paddle_tpu_torch.models.bert import ernie_base
    from paddle_tpu_torch.optimizer import AdamW

    base = torch.cuda.memory_allocated() / 2**30
    model = ernie_base(device="cuda", dtype=torch.bfloat16, seed=0,
                       remat=True)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.parameters())
    model.train()
    *batch, _ = ernie_batch(model.cfg.vocab_size, 32, 512, "cuda")
    losses = [ernie_step(model, opt, *batch).item()]        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    step_ms = []
    for _ in range(steps):
        t1 = time.perf_counter()
        loss = ernie_step(model, opt, *batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss.item())
    counts = _read_flash_counts()
    res = dict(steps=steps, losses=losses, step_ms=step_ms,
               step_p50_ms=float(np.median(step_ms)),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               base_mem_gib=base,
               card=smi, **counts)
    assert all(np.isfinite(losses)), losses
    n = model.cfg.num_layers * steps
    assert (counts["fwd_launches"], counts["fwd_mask_launches"],
            counts["fwd_dropout_launches"]) == (2 * n, 2 * n, 2 * n), counts
    assert (counts["bwd_launches"], counts["bwd_mask_launches"],
            counts["bwd_dropout_launches"]) == (n, n, n), counts
    del model, opt
    torch.cuda.empty_cache()
    return res


def _gen_states(model):
    g = model.dropout_generators
    return g.attn.get_state(), g.elem.get_state()


def _remat_pair(make, run, tol=1e-5):
    """One step of a remat=False and a remat=True model from the same
    weights and dropout seeds, on the card in float32 (TF32 off): the same
    loss, gradients within `tol`, the same generator states after."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plain, remat = make(False), make(True)
    remat.load_state_dict(plain.state_dict())
    out = []
    for m in (plain, remat):
        m.train()
        m.seed_dropout(7)
        _zero_flash_counts()
        loss = run(m)
        loss.backward()
        counts = _read_flash_counts()
        out.append((loss.item(), {n: p.grad for n, p in m.named_parameters()
                                  if p.grad is not None}, _gen_states(m),
                    counts))
    (l0, g0, s0, c0), (l1, g1, s1, c1) = out
    assert set(g0) == set(g1)
    err = max((g1[n] - g0[n]).abs().max().item() for n in g0)
    res = dict(loss=l0, loss_remat=l1, grad_max_err=err, tol=tol,
               generators_equal=all(torch.equal(a, b)
                                    for a, b in zip(s0, s1)),
               fwd_launches=[c0["fwd_launches"], c1["fwd_launches"]],
               dropout_launches=[c0["fwd_dropout_launches"],
                                 c1["fwd_dropout_launches"]])
    assert l0 == l1 and err <= tol and res["generators_equal"], res
    assert c1["fwd_launches"] == 2 * c0["fwd_launches"] > 0, res
    assert c0["fwd_dropout_launches"] == c0["fwd_launches"], res
    del plain, remat
    torch.cuda.empty_cache()
    return res


def _remat_against_itself():
    """Phase 6c (c): the flagship widths at 2 layers (batch 2, seq 256)
    and ERNIE's at 2 layers (batch 2, seq 128, padding mask), float32,
    dropout 0.1 on the attention kernel and the elementwise dropouts."""
    from paddle_tpu_torch.models.bert import (Bert, BertConfig,
                                              bert_pretrain_loss_fn)
    from paddle_tpu_torch.models.gpt import GPT

    gcfg = dict(num_layers=2, dropout=0.1)
    ids, labels = train_batch(flagship_config(**gcfg), 2, 256, "cuda")
    gpt = _remat_pair(
        lambda r: GPT(flagship_config(**gcfg, remat=r), device="cuda",
                      seed=2),
        lambda m: m(ids, labels=labels))
    def bcfg(remat):
        return BertConfig(vocab_size=40000, num_layers=2, dropout=0.1,
                          remat=remat)

    eids, etypes, emask, elabels, _ = ernie_batch(bcfg(False).vocab_size, 2,
                                                  128, "cuda")
    ernie = _remat_pair(
        lambda r: Bert(bcfg(r), device="cuda", seed=3),
        lambda m: bert_pretrain_loss_fn(m(eids, etypes, emask), elabels))
    return dict(gpt=gpt, ernie=ernie)


def _grad_scaler_skip():
    """Phase 6c (d): the flagship widths at 2 layers, bf16 O2 under
    GradScaler(init_loss_scaling=2**15): one step that steps (the scale
    stays), then one with an inf planted in one gradient: skipped (every
    parameter and master unchanged bit for bit), the scale halves.
    `unscale_` is the step's one host sync (counted in "warn" mode)."""
    import warnings

    from paddle_tpu_torch import amp

    model, opt, _, _, (ids, labels) = _surface_trainer(
        False, num_layers=2, lr=1e-4)
    ids, labels = ids[:4], labels[:4]
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)

    def snapshot():
        return ([p.detach().clone() for p in model.parameters()],
                [opt.state[p]["master_weight"].clone()
                 for p in model.parameters()])

    def scaled_step(plant=False):
        scaler.scale(model(ids, labels=labels)).backward()
        if plant:
            model.blocks[0].fc1.weight.grad.view(-1)[7] = float("inf")
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                scaler.step(opt)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        scaler.update()
        opt.zero_grad(set_to_none=True)
        return sum("synchroniz" in str(w.message) for w in seen)

    before = snapshot()
    syncs = [scaled_step()]
    after_good = snapshot()
    moved = any(not torch.equal(a, b) for a, b in zip(before[0],
                                                      after_good[0]))
    scale_after_good = scaler._scale
    syncs.append(scaled_step(plant=True))
    after_bad = snapshot()
    unchanged = all(torch.equal(a, b) for a, b in
                    zip(after_good[0] + after_good[1],
                        after_bad[0] + after_bad[1]))
    res = dict(scale_before=2.0 ** 15, scale_after_good=scale_after_good,
               scale_after_inf=scaler._scale, good_step_moved=moved,
               skipped_step_unchanged=unchanged, step_syncs=syncs,
               opt_steps=opt._step_count)
    assert moved and unchanged, res
    assert scale_after_good == 2.0 ** 15 and scaler._scale == 2.0 ** 14, res
    assert syncs == [1, 1] and opt._step_count == 1, res
    del model, opt
    torch.cuda.empty_cache()
    return res


def training_surface(smi, trained, ernie):
    """Phase 6c: the training surface (remat, AMP O2 masters, the LR
    schedule, the global-norm clip, the train tracer, GradScaler)."""
    t0 = time.perf_counter()
    remat = _surface_run(smi, remat=True, steps=10)
    plain = _surface_run(smi, remat=False, steps=3)
    res = dict(
        remat=remat, o2_no_remat=plain,
        remat_step_cost=remat["step_p50_ms"] / plain["step_p50_ms"],
        remat_mem_saving_gib=plain["peak_mem_gib"] - remat["peak_mem_gib"],
        phase6=dict(step_p50_ms=trained["step_p50_ms"],
                    tokens_per_s=trained["tokens_per_s"],
                    mfu=trained["mfu"],
                    peak_mem_gib=trained["peak_mem_gib"],
                    base_mem_gib=trained["base_mem_gib"]),
        ernie_remat=_ernie_remat(smi),
        phase8_peak_mem_gib=ernie["peak_mem_gib"],
        phase8_base_mem_gib=ernie["base_mem_gib"],
        phase8_step_p50_ms=ernie["step_p50_ms"],
        remat_vs_plain=_remat_against_itself(),
        grad_scaler=_grad_scaler_skip(), card=smi)
    res["seconds"] = time.perf_counter() - t0
    log("[training-surface] " + json.dumps(res))
    return res


# -- phase 6d -----------------------------------------------------------------

DP_LABEL = ("eager, gloo through the host, two ranks on one card - not a "
            "dp speed")


def _dp_mesh(timeout=300):
    """Two ranks on cuda:0 over an explicit gloo backend: the one-card
    departure of the rank meshes (NCCL refuses two ranks on a device)."""
    from paddle_tpu_torch.distributed.mesh import build_mesh

    return build_mesh({"dp": 2}, devices=["cuda:0", "cuda:0"],
                      backend="gloo", timeout=timeout)


def _dp_run(step, batch, steps, warmup=1):
    """`warmup` steps, then `steps` counted ones with every rank's counters
    set to 0 just before and read just after: (losses, per-rank counts,
    wall seconds a counted step, each rank's seconds a counted step). Each
    rank's count entry carries its median ms a counted step in each phase
    of the step (`ShardedTrainStep.last_step`: CUDA events on the rank's
    stream, so host staging shows as the device waiting)."""
    losses = [step(*batch) for _ in range(warmup)]
    step.rank_reports(zero=True)
    wall, ranks, phases, syncs = [], [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(*batch))
        wall.append(time.perf_counter() - t0)
        ranks.append([r["seconds"] for r in step.last_step])
        phases.append([r["phases_ms"] for r in step.last_step])
        syncs.append([r.get("host_syncs") for r in step.last_step])
    reports = step.rank_reports()
    counts = [dict(rank=r["rank"], steps=steps, **r["launches"],
                   collectives=r["collectives"],
                   peak_gib=r["peak_bytes"] / 2**30,
                   phase_ms_p50={k: float(np.median([p[i][k] for p in phases]))
                                 for k in phases[0][i]},
                   **({"host_syncs": [s[i] for s in syncs]}
                      if syncs[0][i] is not None else {}))
              for i, r in enumerate(reports)]
    return losses, counts, wall, ranks


def _dp_budget(counts, n_leaves, quant=False):
    """Each rank made `train_collective_budget` calls a step."""
    from paddle_tpu_torch.parallel.spmd import train_collective_budget

    b = train_collective_budget(n_leaves, 2, quant)
    for c in counts:
        steps = c["steps"]
        assert c["collectives"] == {k: b.get(k, 0) * steps for k in (
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "send", "recv")}, (
                c, b)
    return b


def _dp_launches(counts, layers, variant):
    """12 forward and 12 backward flash launches a layer and step on each
    rank; with `variant` every one the mask + dropout variant."""
    for c in counts:
        n = layers * c["steps"]
        for d in ("fwd", "bwd"):
            assert c[f"{d}_launches"] == n, c
            want = n if variant else 0
            assert (c[f"{d}_mask_launches"], c[f"{d}_dropout_launches"]) == (
                want, want), c


def _zero_parity(mesh):
    """6d (a): float32 (TF32 off), phase 7's widths at 2 layers, batch 4 x
    256 (2 rows a rank), AdamW(1e-4): zero stages 0, 2 and 3 for 3 steps;
    stages 2 and 3 give stage 0's losses and gathered parameters bit for
    bit; stage 0 equals one process on the whole batch within 1e-5;
    gradient_merge_k=2 over 4 steps at stage 2 equals stage 0 with k=2;
    each rank's collective calls a step at stages 2 and 3 are
    `train_collective_budget(28, 2)`'s."""
    from paddle_tpu_torch.models.gpt import GPT, gpt_loss_fn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.spmd import make_sharded_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = flagship_config(num_layers=2)
    batch = train_batch(cfg, 4, 256, "cpu")

    def build():
        model = GPT(cfg, device="cuda", dtype=torch.float32, seed=0)
        return model, AdamW(learning_rate=1e-4,
                            parameters=model.named_parameters())

    def run(zs, gm=1, steps=3):
        model, opt = build()
        step = make_sharded_train_step(model, gpt_loss_fn, opt, mesh,
                                       zero_stage=zs, gradient_merge_k=gm)
        try:
            losses, counts, _, _ = _dp_run(step, batch, steps, warmup=0)
            params = step.gather_params()
            n = len(step.names)
        finally:
            step.close()
        return losses, counts, params, n

    runs = {zs: run(zs) for zs in (0, 2, 3)}
    model, opt = build()
    ids, labels = (b.cuda() for b in batch)
    model.train()
    one = []
    for _ in range(3):
        loss = gpt_loss_fn(model(ids), labels)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        one.append(loss.item())
    gm0, gm2 = run(0, gm=2, steps=4), run(2, gm=2, steps=4)
    losses = {zs: r[0] for zs, r in runs.items()}
    res = dict(losses=losses, one_process=one, gm2_stage0=gm0[0],
               gm2_stage2=gm2[0], leaves=runs[2][3],
               counts={zs: runs[zs][1] for zs in (2, 3)})
    log("[zero-parity] " + json.dumps(res))
    for zs in (2, 3):
        assert losses[zs] == losses[0], (zs, losses)
        p0, p = runs[0][2], runs[zs][2]
        same = [k for k in p0 if torch.equal(p0[k], p[k])]
        assert len(same) == len(p0), (zs, set(p0) - set(same))
        _dp_budget(runs[zs][1], runs[zs][3])
    np.testing.assert_allclose(losses[0], one, rtol=1e-5)
    assert gm2[0] == gm0[0], (gm0[0], gm2[0])
    res["params_bit_equal"] = True
    return res


def _zero_flagship(mesh, smi):
    """6d (b) and (c): the flagship at full width (bench_gpt: vocab 32768,
    hidden 1024, 12 layers, 8 heads, seq 1024) built in float32 and put
    through amp.decorate(level="O2"), AdamW(1e-4, weight decay 0.01), no
    clip, batch 16 x 1024 from RandomState(0) (8 rows a rank): zero stage
    2, then 3, one warm-up and 3 counted steps each, then stage 2 with
    quant_grads=True the same way."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPT, gpt_loss_fn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.spmd import make_sharded_train_step

    cfg = flagship_config()
    model = GPT(cfg, device="cuda", dtype=torch.float32, seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2")
    batch = train_batch(cfg, 16, cfg.max_seq_len, "cpu")
    model_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    res = dict(label=DP_LABEL, card=smi, model_bytes=model_bytes,
               tokens_per_step=batch[0].numel())
    for name, zs, quant in (("stage2", 2, False), ("stage3", 3, False),
                            ("stage2_int8", 2, True)):
        t0 = time.perf_counter()
        step = make_sharded_train_step(model, gpt_loss_fn, opt, mesh,
                                       zero_stage=zs, quant_grads=quant)
        build_s = time.perf_counter() - t0
        try:
            losses, counts, wall, ranks = _dp_run(step, batch, 3)
            opt_bytes = step.per_chip_opt_state_bytes()
            unsharded = step.unsharded_opt_state_bytes()
            param_bytes = step.param_bytes()
            n = len(step.names)
        finally:
            step.close()
        r = dict(zero_stage=zs, quant_grads=quant, leaves=n, losses=losses,
                 counts=counts, build_s=build_s, step_s=wall,
                 rank_step_s=ranks,
                 tokens_per_s=batch[0].numel() * len(wall) / sum(wall),
                 opt_state_bytes=opt_bytes, unsharded_opt_state_bytes=unsharded,
                 opt_state_ratio=[b / unsharded for b in opt_bytes],
                 param_bytes=param_bytes,
                 param_ratio=[b / model_bytes for b in param_bytes])
        res[name] = r
        log(f"[zero-flagship] {name} ({DP_LABEL}; {smi}) " + json.dumps(r))
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        _dp_launches(counts, cfg.num_layers, variant=False)
        _dp_budget(counts, n, quant)
        assert max(r["opt_state_ratio"]) <= 0.51, r["opt_state_ratio"]
        if zs == 3:
            assert max(r["param_ratio"]) <= 0.51, r["param_ratio"]
    drift = max(abs(a - b) for a, b in zip(res["stage2_int8"]["losses"],
                                           res["stage2"]["losses"]))
    res["int8_loss_drift"] = drift
    log(f"[zero-flagship] int8 gradients: greatest loss drift from the "
        f"float stage-2 run {drift:.6f}")
    del model, opt
    torch.cuda.empty_cache()
    return res


def _zero_ernie(mesh, smi):
    """6d (d): phase 8's cell (ernie_base bf16, dropout 0.1, AdamW(1e-4,
    weight decay 0.01), 32 x 512 with real lengths in 256-512, the padding
    mask, MLM labels at 15 %) through group_sharded_parallel(level="os_g")
    and make_sharded_train_step(..., zero_stage=2) at dp=2 (16 rows a
    rank): one warm-up and 3 counted steps."""
    from paddle_tpu_torch.distributed import group_sharded_parallel
    from paddle_tpu_torch.models.bert import bert_pretrain_loss_fn
    from paddle_tpu_torch.parallel.spmd import make_sharded_train_step

    model, opt, batch, lens = ernie_trainer()
    wrapped, wopt, _ = group_sharded_parallel(model, opt, level="os_g")
    t0 = time.perf_counter()
    step = make_sharded_train_step(wrapped, bert_pretrain_loss_fn, wopt,
                                   mesh, zero_stage=2)
    build_s = time.perf_counter() - t0
    try:
        losses, counts, wall, ranks = _dp_run(step, batch, 3)
        opt_bytes = step.per_chip_opt_state_bytes()
        unsharded = step.unsharded_opt_state_bytes()
        n = len(step.names)
    finally:
        step.close()
    secs = sum(wall)
    tokens, real = batch[0].numel(), int(lens.sum())
    res = dict(label=DP_LABEL, card=smi, leaves=n, losses=losses,
               counts=counts, build_s=build_s, step_s=wall,
               rank_step_s=ranks, tokens_per_s=tokens * len(wall) / secs,
               real_tokens_per_s=real * len(wall) / secs,
               opt_state_bytes=opt_bytes, unsharded_opt_state_bytes=unsharded,
               opt_state_ratio=[b / unsharded for b in opt_bytes])
    log(f"[zero-ernie] ({DP_LABEL}; {smi}) " + json.dumps(res))
    assert all(np.isfinite(losses)), losses
    assert np.mean(losses[-2:]) < losses[0], losses
    _dp_launches(counts, model.cfg.num_layers, variant=True)
    _dp_budget(counts, n)
    assert max(res["opt_state_ratio"]) <= 0.51, res["opt_state_ratio"]
    del model, opt, wrapped, wopt
    torch.cuda.empty_cache()
    return res


def _zero_failure():
    """6d (e): a rank that raises (an operation it cannot run, injected as
    the CPU tests inject it) makes the controller's next step raise
    RankFailed within the mesh's timeout; then a new mesh trains."""
    from paddle_tpu_torch.distributed.ranks import RankFailed
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.spmd import make_sharded_train_step

    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=256)
    batch = train_batch(cfg, 4, 128, "cpu")

    def step_on(mesh):
        model = GPT(cfg, device="cuda", seed=0)
        opt = AdamW(learning_rate=1e-3, parameters=model.named_parameters())
        return make_sharded_train_step(model, gpt_loss_fn, opt, mesh,
                                       zero_stage=2)

    timeout = 60
    mesh = _dp_mesh(timeout)
    try:
        step = step_on(mesh)
        step(*batch)
        mesh.ranks.send("no_such_operation")
        t0 = time.perf_counter()
        try:
            step(*batch)
        except RankFailed as e:
            raised = (e.rank, e.detail.strip().splitlines()[-1])
        else:
            raise AssertionError("a failed rank went unnoticed")
        secs = time.perf_counter() - t0
    finally:
        mesh.close()
    assert raised[0] == 1 and "KeyError" in raised[1], raised
    assert secs < timeout, secs
    fresh = _dp_mesh(timeout)
    try:
        after = step_on(fresh)(*batch)
    finally:
        fresh.close()
    assert np.isfinite(after)
    res = dict(rank=raised[0], error=raised[1], seconds_to_raise=secs,
               mesh_timeout_s=timeout, new_mesh_loss=after)
    log("[zero-failure] " + json.dumps(res))
    return res


def zero_dp(smi):
    """Phase 6d: ZeRO data-parallel training at dp=2 on the one card (two
    ranks on cuda:0 over an explicit gloo backend, every collective staged
    through host memory). Run last, after gc.collect() and
    torch.cuda.empty_cache()."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated() / 2**30
    log(f"[zero] phase 6d starts with {base:.2f} GiB allocated ({smi})")
    mesh = _dp_mesh()
    try:
        res = dict(base_mem_gib=base, parity=_zero_parity(mesh),
                   flagship=_zero_flagship(mesh, smi),
                   ernie=_zero_ernie(mesh, smi))
    finally:
        mesh.close()
    res["failure"] = _zero_failure()
    res["seconds"] = time.perf_counter() - t0
    log(f"[zero] phase 6d {res['seconds']:.1f} s")
    return res


# -- phase 6e -----------------------------------------------------------------

MP_LABEL = ("eager, gloo through the host, ranks sharing one card - not an "
            "mp speed")


def _hybrid_mesh(degrees, timeout=300):
    """``prod(degrees)`` ranks on cuda:0 over an explicit gloo backend (the
    one-card departure: NCCL refuses two ranks on a device)."""
    from paddle_tpu_torch.distributed.mesh import build_mesh

    n = int(np.prod(list(degrees.values())))
    return build_mesh(degrees, devices=["cuda:0"] * n, backend="gloo",
                      timeout=timeout)


def _mp_budget(kind, layers, mp, dp, n_leaves, clip=False):
    """A hybrid step's collective calls on every rank, as arithmetic
    (tests/test_torch_hybrid.py states GPT's). At mp > 1, all-reduces:
    GPT's forward makes the vocab-parallel embedding's 1, proj's and
    fc2's 2 a layer and the vocab-parallel head loss's 3, its backward
    the column-parallel inputs' 2 a layer and the head's hidden state's
    1; ERNIE's the same but for the head: its MLM logits are gathered (1
    all-gather) and the transform's output summed in the backward (1);
    the clip 1. At dp > 1: the loss 1, ERNIE's labelled-position count 1,
    and one a gradient leaf."""
    ar = ag = 0
    if mp > 1:
        if kind == "gpt":
            ar += (1 + 2 * layers + 3) + (2 * layers + 1)
        else:
            ar += (1 + 2 * layers) + (2 * layers + 1)
            ag += 1
        ar += 1 if clip else 0
    if dp > 1:
        ar += 1 + (kind == "ernie") + n_leaves
    return {"all-reduce": ar, "all-gather": ag, "reduce-scatter": 0,
            "all-to-all": 0, "send": 0, "recv": 0}


def _mp_gate(counts, kind, layers, mp, dp, n_leaves, clip=False,
             mask=False, dropout=False):
    """Each rank: `_mp_budget`'s calls a step, and one flash forward and
    one backward launch a layer and step (every one the mask variant with
    `mask`, the dropout variant with `dropout`)."""
    b = _mp_budget(kind, layers, mp, dp, n_leaves, clip)
    for c in counts:
        assert c["collectives"] == {k: v * c["steps"] for k, v in b.items()
                                    }, (c, b)
        n = layers * c["steps"]
        for d in ("fwd", "bwd"):
            assert (c[f"{d}_launches"], c[f"{d}_mask_launches"],
                    c[f"{d}_dropout_launches"]) == (
                        n, n * mask, n * dropout), c
    return b


def _hybrid_parity(meshes):
    """6e (a): float32 (TF32 off), 3 AdamW(1e-4) steps from one set of
    weights: the flagship widths at 2 layers, batch 4 x 256, over
    {"mp": 2} and {"dp": 2, "mp": 2} against one process on the whole
    batch (losses within 1e-5 relative, every gathered parameter entry
    within Adam's 2 * steps * lr of it); with dropout 0.1 over {"mp": 2}
    against one process at the same seeds (losses within 1e-5: the ranks'
    flash kernels draw their heads' model bits, `head_offset`); ERNIE's
    widths at 2 layers (12 heads, 6 a rank), batch 4 x 128, padding mask
    and dropout 0.1, over {"mp": 2} likewise. Each rank's collectives
    and flash launches a step against the arithmetic (`_mp_budget`)."""
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models.bert import (Bert, BertConfig,
                                              bert_pretrain_loss_fn)
    from paddle_tpu_torch.models.gpt import GPT, gpt_loss_fn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.spmd import make_sharded_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr, steps = 1e-4, 3
    gbatch = train_batch(flagship_config(), 4, 256, "cpu")
    ebatch = ernie_batch(40000, 4, 128, "cpu")[:4]
    one = build_mesh({"dp": 1}, device="cuda")

    def run(kind, mesh, dropout=0.0, n=steps):
        if kind == "gpt":
            model = GPT(flagship_config(num_layers=2, dropout=dropout),
                        device="cuda", dtype=torch.float32, seed=0)
            loss_fn, batch = gpt_loss_fn, gbatch
        else:
            model = Bert(BertConfig(vocab_size=40000, num_layers=2,
                                    dropout=dropout), device="cuda",
                         dtype=torch.float32, seed=0)
            loss_fn, batch = bert_pretrain_loss_fn, ebatch
        opt = AdamW(learning_rate=lr, parameters=model.named_parameters())
        step = make_sharded_train_step(model, loss_fn, opt, mesh)
        try:
            losses, counts, _, _ = _dp_run(step, batch, n, warmup=0)
            params = step.gather_params()
            leaves = len(step.names)
        finally:
            step.close()
        return losses, counts, params, leaves

    res = {}
    for name, kind, dropout, keys in (
            ("gpt", "gpt", 0.0, ("mp2", "dp2mp2")),
            ("gpt_dropout", "gpt", 0.1, ("mp2",)),
            ("ernie_mask_dropout", "ernie", 0.1, ("mp2",))):
        n = steps if dropout == 0.0 else 2
        want, _, wparams, _ = run(kind, one, dropout, n)
        rec = dict(one_process=want)
        for key in keys:
            losses, counts, params, leaves = run(kind, meshes[key], dropout,
                                                 n)
            deg = {"mp2": (2, 1), "dp2mp2": (2, 2)}[key]
            budget = _mp_gate(counts, kind, 2, *deg, leaves,
                              mask=kind == "ernie", dropout=dropout > 0)
            worst = max((params[k] - w).abs().max().item()
                        for k, w in wparams.items())
            rel = max(((params[k] - w).norm() / w.norm()).item()
                      for k, w in wparams.items())
            rec[key] = dict(losses=losses, budget_a_step=budget,
                            counts=counts, param_max_abs_diff=worst,
                            param_max_rel_norm_diff=rel)
            np.testing.assert_allclose(losses, want, rtol=1e-5)
            assert worst <= 2 * n * lr, (name, key, worst)
        res[name] = rec
        log(f"[hybrid-parity] {name} " + json.dumps(rec))
    return res


def _hybrid_flagship(mesh, smi):
    """6e (b): the flagship at full width (bench_gpt) built in float32 and
    put through amp.decorate(level="O2"), AdamW(1e-4, weight decay 0.01)
    with ClipGradByGlobalNorm(1.0), over {"mp": 2} (two ranks on cuda:0,
    each holding 4 of 8 heads and half of every Megatron layer), batch 4 x
    1024 (the 4 rows on both ranks): one warm-up and 3 counted steps."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models.gpt import GPT, gpt_loss_fn
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.spmd import make_sharded_train_step

    cfg = flagship_config()
    model = GPT(cfg, device="cuda", dtype=torch.float32, seed=0)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0),
                parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2")
    batch = train_batch(cfg, 4, cfg.max_seq_len, "cpu")
    model_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    t0 = time.perf_counter()
    step = make_sharded_train_step(model, gpt_loss_fn, opt, mesh)
    build_s = time.perf_counter() - t0
    try:
        losses, counts, wall, ranks = _dp_run(step, batch, 3)
        opt_bytes = step.per_chip_opt_state_bytes()
        unsharded = step.unsharded_opt_state_bytes()
        param_bytes = step.param_bytes()
        n = len(step.names)
    finally:
        step.close()
    res = dict(label=MP_LABEL, card=smi, model_bytes=model_bytes,
               heads_a_rank=cfg.num_heads // 2, leaves=n, losses=losses,
               counts=counts, build_s=build_s, step_s=wall,
               rank_step_s=ranks,
               tokens_per_s=batch[0].numel() * len(wall) / sum(wall),
               opt_state_bytes=opt_bytes,
               unsharded_opt_state_bytes=unsharded,
               opt_state_ratio=[b / unsharded for b in opt_bytes],
               param_bytes=param_bytes,
               param_ratio=[b / model_bytes for b in param_bytes],
               peak_gib=[c["peak_gib"] for c in counts])
    res["budget_a_step"] = _mp_gate(counts, "gpt", cfg.num_layers, 2, 1, n,
                                    clip=True)
    log(f"[hybrid-flagship] ({MP_LABEL}; {smi}) " + json.dumps(res))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    # each rank holds half of every Megatron leaf and all of the rest
    assert max(res["opt_state_ratio"]) <= 0.55, res["opt_state_ratio"]
    assert max(res["param_ratio"]) <= 0.55, res["param_ratio"]
    del model, opt
    torch.cuda.empty_cache()
    return res


def hybrid_train(smi):
    """Phase 6e: dp x mp hybrid training on the one card (ranks on cuda:0
    over an explicit gloo backend, every collective staged through host
    memory). Run last, after gc.collect() and torch.cuda.empty_cache()."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated() / 2**30
    log(f"[hybrid] phase 6e starts with {base:.2f} GiB allocated ({smi})")
    meshes = {"mp2": _hybrid_mesh({"mp": 2}),
              "dp2mp2": _hybrid_mesh({"dp": 2, "mp": 2})}
    try:
        res = dict(base_mem_gib=base, parity=_hybrid_parity(meshes))
        meshes.pop("dp2mp2").close()
        res["flagship"] = _hybrid_flagship(meshes["mp2"], smi)
    finally:
        for m in meshes.values():
            m.close()
    res["seconds"] = time.perf_counter() - t0
    log(f"[hybrid] phase 6e {res['seconds']:.1f} s")
    return res


# -- phase 6f -----------------------------------------------------------------

PP_LABEL = ("eager, gloo through the host, ranks sharing one card - not a "
            "pp speed")


def _pp_budget(cfg, shape, M, stage, n_chunks=1, n_leaves=0):
    """A pipelined GPT step's counted calls on a rank of stage `stage`, as
    arithmetic (independent of the port's `pipeline_collective_budget`):
    each of the rank's V chunks that has a next virtual stage posts one
    send a microbatch forward and receives one gradient back, and each
    that has a previous one receives one input and posts one gradient: M
    (forward + backward hand-offs). All-reduces: the loss over the stage
    line (pp > 1), the tied embedding's sum on the first and last stage
    (pp > 1), at mp > 1 four a layer and microbatch (the two
    column-parallel inputs' gradients, the two row-parallel sums), and at
    dp > 1 the loss and one a weight (`n_leaves`)."""
    P, V = shape["pp"], n_chunks
    virt = [c * P + stage for c in range(V)]
    hand = sum(g < V * P - 1 for g in virt) + sum(g > 0 for g in virt)
    ar = 0
    if P > 1:
        ar += 1 + (stage in (0, P - 1))
    if shape["mp"] > 1:
        ar += 4 * (cfg.num_layers // P) * M
    if shape["dp"] > 1:
        ar += 1 + n_leaves
    return {"all-reduce": ar, "all-gather": 0, "reduce-scatter": 0,
            "all-to-all": 0, "send": M * hand, "recv": M * hand}


def _pp_gate(mesh, reports, cfg, M, steps, n_chunks=1):
    """Each rank: `_pp_budget`'s calls a step, and one flash forward and
    one backward launch for each of its layers and microbatches."""
    out = []
    for r, rep in enumerate(reports):
        stage = mesh.coords(r)["pp"]
        b = _pp_budget(cfg, mesh.shape, M, stage, n_chunks)
        assert rep["collectives"] == {k: v * steps for k, v in b.items()}, (
            r, rep["collectives"], b)
        n = cfg.num_layers // mesh.shape["pp"] * M * steps
        lc = rep["launches"]
        assert (lc["fwd_launches"], lc["bwd_launches"]) == (n, n), (r, lc)
        assert lc["fwd_mask_launches"] == lc["fwd_dropout_launches"] == 0
        out.append(dict(rank=r, stage=stage, budget_a_step=b,
                        collectives=rep["collectives"],
                        fwd_launches=lc["fwd_launches"],
                        bwd_launches=lc["bwd_launches"],
                        peak_gib=rep["peak_bytes"] / 2**30))
    return out


def _pp_flat(params):
    out = {k: v for k, v in params.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in params["blocks"].items()})
    return out


def _pp_parity(meshes):
    """6f (a): float32 (TF32 off), the flagship widths at 4 layers (seq
    256), batch 8 x 256 in M 4, SGD lr 0.1, 3 steps from one set of
    weights: {"pp": 2} GPipe, 1F1B and interleaved (V 2), {"pp": 2,
    "mp": 2} 1F1B, each against the one-process model (one rank, every
    layer, the same microbatches): losses within 1e-5 relative, every
    parameter within 1e-5 of it relative to its norm; each rank's calls
    a step against `_pp_budget` and 2 x M flash launches each way."""
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models.gpt_pipeline import (init_params,
                                                      layer_stack,
                                                      make_pipelined_gpt,
                                                      stage_stack)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = flagship_config(num_layers=4, max_seq_len=256)
    ids, labels = train_batch(cfg, 8, 256, "cpu")
    M, steps, lr = 4, 3, 0.1
    one = init_params(cfg, 1, seed=0, device="cuda")
    layers = layer_stack(one["blocks"])

    def run(mesh, sched, n_chunks):
        params = dict(one, blocks=stage_stack(layers, mesh.shape["pp"],
                                              n_chunks))
        _, step = make_pipelined_gpt(cfg, mesh, M, sched, n_chunks,
                                     params=params)
        try:
            step.rank_reports(zero=True)
            losses = [step(ids, labels, lr) for _ in range(steps)]
            reports = step.rank_reports()
            got = step.gather_params()
        finally:
            step.close()
        got["blocks"] = stage_stack(layer_stack(got["blocks"], n_chunks), 1)
        return losses, reports, _pp_flat(got)

    want, _, wparams = run(build_mesh({"dp": 1}, device="cuda"), "gpipe",
                           1)
    res = {"one_process": want}
    for name, key, sched, V in (("pp2_gpipe", "pp2", "gpipe", 1),
                                ("pp2_1f1b", "pp2", "1f1b", 1),
                                ("pp2_interleaved_v2", "pp2", "interleaved",
                                 2),
                                ("pp2mp2_1f1b", "pp2mp2", "1f1b", 1)):
        losses, reports, got = run(meshes[key], sched, V)
        rel = max(float((got[k] - w).norm() / w.norm())
                  for k, w in wparams.items())
        rec = dict(losses=losses, param_max_rel_norm_diff=rel,
                   ranks=_pp_gate(meshes[key], reports, cfg, M, steps, V))
        res[name] = rec
        log(f"[pp-parity] {name} " + json.dumps(rec))
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        assert rel < 1e-5, (name, rel)
    torch.cuda.empty_cache()
    return res


def _pp_1p3b(mesh, smi):
    """6f (b): BASELINE config 3 at full width: gpt_1p3b's widths (vocab
    50304, hidden 2048, 24 layers, 16 heads, FFN 8192) in float32 over
    {"pp": 2, "mp": 2} (four ranks on cuda:0: 12 layers and 8 heads a
    rank), 1F1B, batch 8 x 1024 in 4 microbatches of 2 rows, SGD lr 0.05:
    one warm-up and 3 counted steps on the same batch. Then one step each
    at M 8 (one row a microbatch) with GPipe and with 1F1B, every rank's
    peak memory set to 0 just before: stage 0's peak under 1F1B below
    GPipe's."""
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.models.gpt_pipeline import (init_params,
                                                      make_pipelined_gpt,
                                                      rank_entries)

    cfg = GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=24,
                    num_heads=16, max_seq_len=1024, intermediate_size=8192)
    M, lr = 4, 0.05
    params = init_params(cfg, 2, seed=0, device="cuda")
    model_bytes = sum(t.numel() * 4 for t in _pp_flat(params).values())
    blocks_bytes = sum(t.numel() * 4 for t in params["blocks"].values())
    shares = [rank_entries(params, mesh.shape, mesh.coords(r))
              for r in range(mesh.size)]
    want_bytes = [sum(t.numel() * 4 for _, t in sh) for sh in shares]
    blocks_share = [sum(t.numel() * 4 for k, t in sh if k[0] == "blocks")
                    / blocks_bytes for sh in shares]
    del shares
    t0 = time.perf_counter()
    _, step = make_pipelined_gpt(cfg, mesh, M, "1f1b", params=params)
    build_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    ids, labels = train_batch(cfg, 8, 1024, "cpu")
    try:
        losses = [step(ids, labels, lr)]
        step.rank_reports(zero=True)
        wall, ranks = [], []
        for _ in range(3):
            t1 = time.perf_counter()
            losses.append(step(ids, labels, lr))
            wall.append(time.perf_counter() - t1)
            ranks.append(step.last_step)
        reports = step.rank_reports()
        param_bytes = step.param_bytes()
        peaks = {}
        for sched in ("1f1b", "gpipe"):
            step.rank_reports(zero=True)
            step(ids, labels, lr, schedule=sched, n_microbatches=8)
            peaks[sched] = [r["peak_bytes"] for r in step.last_step]
            peaks[sched + "_in_flight"] = [r["peak_in_flight"]
                                           for r in step.last_step]
    finally:
        step.close()
    per_rank = []
    for r in range(mesh.size):
        ph = [s[r]["phases_ms"] for s in ranks]
        per_rank.append(dict(
            rank=r, stage=mesh.coords(r)["pp"],
            step_s=[s[r]["seconds"] for s in ranks],
            peak_gib=[s[r]["peak_bytes"] / 2**30 for s in ranks],
            peak_in_flight=ranks[-1][r]["peak_in_flight"],
            phase_ms_p50={k: float(np.median([p[k] for p in ph]))
                          for k in ph[0]}))
    res = dict(label=PP_LABEL, card=smi, config="gpt_1p3b widths, f32",
               mesh=dict(mesh.shape), schedule="1f1b", batch=[8, 1024],
               microbatches=M, heads_a_rank=cfg.num_heads // 2,
               layers_a_rank=cfg.num_layers // 2, lr=lr, losses=losses,
               build_s=build_s, step_s=wall,
               tokens_per_s=ids.numel() * len(wall) / sum(wall),
               model_bytes=model_bytes, param_bytes=param_bytes,
               want_param_bytes=want_bytes,
               blocks_share=blocks_share,
               ranks=_pp_gate(mesh, reports, cfg, M, 3), per_rank=per_rank,
               m8_peak_gib={k: [v / 2**30 for v in peaks[k]]
                            for k in ("1f1b", "gpipe")},
               m8_in_flight={k: peaks[k + "_in_flight"]
                             for k in ("1f1b", "gpipe")})
    log(f"[pp-1p3b] ({PP_LABEL}; {smi}) " + json.dumps(res))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert param_bytes == want_bytes, (param_bytes, want_bytes)
    stage0 = [r for r in range(mesh.size) if mesh.coords(r)["pp"] == 0]
    for r in stage0:
        assert peaks["1f1b"][r] < peaks["gpipe"][r], (r, peaks)
    torch.cuda.empty_cache()
    return res


class _ScalerStage:
    """Phase 6f (c): one stage's share of the hybrid scaler's check, a
    rank job of the port's parallel/spmd.py: a weight of its own (its
    stage's), SGD through `HybridParallelOptimizer`, and
    `HybridParallelGradScaler` over the mesh."""

    JOB_OPS = frozenset(("step",))

    def __init__(self, spec, mesh):
        self.mesh = mesh
        self.stage = mesh.coords()["pp"]
        self.w = torch.nn.Parameter(torch.full((1024,), 1.0 + self.stage,
                                               device=mesh.device))

    def step(self, plant):
        from paddle_tpu_torch.amp import GradScaler
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            HybridParallelGradScaler, HybridParallelOptimizer)
        from paddle_tpu_torch.optimizer import SGD

        opt = HybridParallelOptimizer(SGD(learning_rate=0.1,
                                          parameters=[self.w]), self.mesh)
        scaler = HybridParallelGradScaler(GradScaler(
            init_loss_scaling=2.0 ** 15), self.mesh)
        scaler.scale((self.w * 3.0).sum()).backward()
        if self.stage == plant:
            with torch.no_grad():
                self.w.grad[7] = float("inf")
        before = self.w.detach().clone()
        scaler.step(opt)
        scaler.update()
        self.w.grad = None
        return dict(stage=self.stage, plant=plant,
                    unchanged=bool(torch.equal(before, self.w.detach())),
                    scale=float(scaler._scale))


def _pp_scaler(mesh):
    """6f (c): `HybridParallelGradScaler` over {"pp": 2} on the card: with
    an inf planted in stage 1's gradient both stages skip (weights
    unchanged bit for bit, the scale halved); with none both step."""
    from paddle_tpu_torch.parallel import spmd

    skipped, stepped = spmd.run_on_ranks(mesh, _ScalerStage, ("step", 1),
                                         ("step", None))
    res = dict(planted_in_stage_1=skipped, clean=stepped)
    log("[pp-scaler] " + json.dumps(res))
    assert all(r["unchanged"] and r["scale"] == 2.0 ** 14 for r in skipped)
    assert all(not r["unchanged"] and r["scale"] == 2.0 ** 15
               for r in stepped)
    return res


# a rule's update, held against another computation of it: the gap's norm
# relative to the norm of the reference's own step. An elementwise rule's
# gap is each device's rounding of its arithmetic. Lars and Lamb take
# more: Lars' step at lr 1e-4 is ~1e-7, some 40 float32 ulps of the
# weight it moves, so a last-bit difference in its intermediates flips
# the final rounding of an entry by 2.5 % of its step; Lamb's epsilon
# makes its update of a small gradient follow that gradient's rounding
# (a zero-initialised bias, whose trust ratio is 1, shows it most)
RULE_STEP_TOL = 1e-5
TRUST_STEP_TOL = 1e-3


def _step_gap(before, got, want, noise=None):
    """One tensor's two updates from `before`: ``(gap, flip)``. `gap` is
    the norm of ``got - want`` over the entries that are not `noise` (a
    bool mask; None: every entry counts), relative to the norm of
    `want`'s own step there (0 when both are 0). `flip` is the largest
    gap on a noise entry relative to the tensor's largest step entry: at
    most 2 when such an entry's step reverses (a gradient of float noise
    can take either sign)."""
    if noise is None:
        noise = torch.zeros(before.shape, dtype=torch.bool)
    step, d = want - before, got - want
    keep = ~noise
    num, den = float(d[keep].norm()), float(step[keep].norm())
    gap = num / den if den > 0 else (0.0 if num == 0 else float("inf"))
    top = float(step.abs().max())
    nz = float(d[noise].abs().max()) if bool(noise.any()) else 0.0
    flip = nz / top if top > 0 else (0.0 if nz == 0 else float("inf"))
    return gap, flip


def _noise(g_want, g_got):
    """Float-noise entries of a gradient: below 1e-6 of the largest in its
    tensor (phase 7's test), or where the two computations of it disagree
    by more than half of it."""
    gg = g_want.abs()
    return (gg < 1e-6 * gg.max()) | ((g_got - g_want).abs() > 0.5 * gg)


def _norm_errs(t):
    """The float32 norm of `t` summed on the card and on the CPU, each
    relative to its float64 norm."""
    ref = float(t.double().norm())
    return {dev: abs(float(torch.sqrt(torch.sum(torch.square(
        t.to(dev).float())))) - ref) / ref for dev in ("cuda", "cpu")}


def _pp_rules():
    """6f (c): each of the seven new rules (Adamax, Adagrad, Adadelta,
    RMSProp, DGCMomentum, Lars, Lamb) one step at lr 1e-4 on the flagship
    widths at 2 layers (f32, TF32 off), on the card and on a CPU copy
    from the same weights and the same gradients (the card's backward of
    one batch), tensor by tensor against the rule's own step
    (`_step_gap` over every entry, within `RULE_STEP_TOL`, Lars and
    Lamb within `TRUST_STEP_TOL`). The tolerance scales with each rule's
    own step, however small (Lars', Adadelta's); with one set of
    gradients, what is left is each device's rounding of the rule's
    arithmetic. For Lars and Lamb the worst tensor's float32 norms (its
    weights' and gradient's), summed on each device, are printed against
    float64."""
    from paddle_tpu_torch import optimizer as optim
    from paddle_tpu_torch.models.gpt import GPT

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, lr = flagship_config(num_layers=2), 1e-4
    model = GPT(cfg, device="cuda", seed=3)
    ids, labels = train_batch(cfg, 2, 256, "cuda")
    model.train()
    model(ids, labels=labels).backward()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    del model
    names = ("Adamax", "Adagrad", "Adadelta", "RMSProp", "DGCMomentum",
             "Lars", "Lamb")
    res = {}
    for name in names:
        after = []
        for dev in ("cuda", "cpu"):
            params = {n: torch.nn.Parameter(w.to(dev).clone())
                      for n, w in before.items()}
            opt = getattr(optim, name)(learning_rate=lr,
                                       parameters=list(params.items()))
            for n, p in params.items():
                p.grad = grads[n].to(dev).clone()
            opt.step()
            after.append({n: p.detach().cpu() for n, p in params.items()})
        gaps = {n: _step_gap(before[n].cpu(), after[0][n], want)[0]
                for n, want in after[1].items()}
        worst = max(gaps, key=gaps.get)
        res[name] = dict(
            step_gap=gaps[worst], worst_leaf=worst,
            step_rms=float(np.sqrt(np.mean([
                float(((after[1][n] - before[n].cpu()) ** 2).mean())
                for n in before]))),
            tol=TRUST_STEP_TOL if name in _TRUST else RULE_STEP_TOL)
        if name in _TRUST:
            res[name]["norm_errs"] = dict(w=_norm_errs(before[worst]),
                                          g=_norm_errs(grads[worst]))
    log("[pp-rules] " + json.dumps(res))
    for name in names:
        assert res[name]["step_gap"] <= res[name]["tol"], (name, res[name])
    torch.cuda.empty_cache()
    return res


_TRUST = ("Lars", "Lamb")


def _lamb_whole(params, grads, lr, shards=1):
    """Lamb's first step of each tensor of `params` with `grads`, each cut
    into `shards` flat pieces whose norms are their own (with 2, the
    explicit path's update without its norm all-reduce)."""
    from paddle_tpu_torch.optimizer import Lamb

    out = {}
    for n, w in params.items():
        flat, g = w.reshape(-1), grads[n].reshape(-1)
        pad = (-flat.numel()) % shards
        fw, fg = (torch.nn.functional.pad(t, (0, pad)) for t in (flat, g))
        k = fw.numel() // shards
        parts = []
        for i in range(shards):
            p = torch.nn.Parameter(fw[i * k:(i + 1) * k].clone())
            opt = Lamb(learning_rate=lr, parameters=[("w", p)])
            p.grad = fg[i * k:(i + 1) * k].clone()
            opt.step()
            parts.append(p.detach())
        out[n] = torch.cat(parts)[:flat.numel()].view(w.shape).cpu()
    return out


def _pp_lamb_zero():
    """6f (c): Lamb on the explicit ZeRO stage-2 path at dp=2 (two ranks on
    cuda:0, gloo; each norm an all-reduce of the shards' squared sums),
    the flagship widths at 2 layers (f32), batch 4 x 256, lr 1e-3. Its
    first step, tensor by tensor against Lamb's own step (`_step_gap`):
    (1) against Lamb on whole tensors here with dp's own gradient (the
    mean of the two ranks' gradients over 2 rows each): within
    `TRUST_STEP_TOL` on every entry; (2) against one process (the
    gradient over all 4 rows): within it over the entries whose gradient
    is not float noise between the two (`_noise`), a noise entry at most
    2 of the tensor's largest step. The same metric shows what it
    catches: Lamb on the shards with their own norms (the update without
    its all-reduce) must be at least 100 `TRUST_STEP_TOL` from (1)'s
    reference. Losses of 2 steps within 1e-5 of one process's. The
    largest relative difference to one process's weights is printed with
    its leaf (`param_max_rel_norm_diff`)."""
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models.gpt import GPT, gpt_loss_fn
    from paddle_tpu_torch.optimizer import Lamb
    from paddle_tpu_torch.parallel.spmd import make_sharded_train_step

    cfg, lr = flagship_config(num_layers=2), 1e-3
    batch = train_batch(cfg, 4, 256, "cpu")

    def run(mesh, zs):
        model = GPT(cfg, device="cuda", dtype=torch.float32, seed=0)
        opt = Lamb(learning_rate=lr, parameters=model.named_parameters())
        step = make_sharded_train_step(model, gpt_loss_fn, opt, mesh,
                                       zero_stage=zs)
        try:
            losses = [step(*batch)]
            first = step.gather_params()
            losses.append(step(*batch))
            return losses, step.explicit_update, first
        finally:
            step.close()

    want, _, one = run(build_mesh({"dp": 1}, device="cuda"), 0)
    mesh = _dp_mesh()
    try:
        got, explicit, zero = run(mesh, 2)
    finally:
        mesh.close()
    model = GPT(cfg, device="cuda", dtype=torch.float32, seed=0)
    model.train()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ids, labels = (t.cuda() for t in batch)

    def grads(rows):
        model.zero_grad(set_to_none=True)
        model(ids[rows], labels=labels[rows]).backward()
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters()}

    g_one = grads(slice(0, 4))
    g0, g1 = grads(slice(0, 2)), grads(slice(2, 4))
    g_dp = {n: (g0[n] + g1[n]) / 2 for n in g0}
    whole = _lamb_whole(before, g_dp, lr)
    local = _lamb_whole(before, g_dp, lr, shards=2)
    before = {n: t.cpu() for n, t in before.items()}
    zero = {n: t.cpu() for n, t in zero.items()}
    one = {n: t.cpu() for n, t in one.items()}
    noise = {n: _noise(g_one[n].cpu(), g_dp[n].cpu()) for n in before}
    own = {n: _step_gap(before[n], zero[n], whole[n])[0]
           for n in before}
    vs_one = {n: _step_gap(before[n], zero[n], one[n], noise[n])
              for n in before}
    unmasked = {n: _step_gap(before[n], zero[n], one[n])[0]
                for n in before}
    rel_norm = {n: float((zero[n] - one[n]).norm() / one[n].norm())
                for n in before}
    mutant = {n: _step_gap(before[n], local[n], whole[n])[0]
              for n in before}
    top = lambda d: max(d, key=d.get)  # noqa: E731
    res = dict(
        one_process=want, zero2_dp2=got, explicit=explicit,
        own_gradient_gap=own[top(own)], own_worst_leaf=top(own),
        one_process_gap=max(g for g, _ in vs_one.values()),
        one_process_noise_flip=max(f for _, f in vs_one.values()),
        one_process_unmasked_gap=unmasked[top(unmasked)],
        unmasked_worst_leaf=top(unmasked),
        unmasked_worst_noise_entries=int(noise[top(unmasked)].sum()),
        param_max_rel_norm_diff=rel_norm[top(rel_norm)],
        rel_norm_worst_leaf=top(rel_norm),
        rel_norm_worst_noise_entries=int(noise[top(rel_norm)].sum()),
        rel_norm_worst_numel=int(before[top(rel_norm)].numel()),
        noise_entries=int(sum(int(x.sum()) for x in noise.values())),
        grad_gap={n: float((g_dp[n] - g_one[n]).norm() / g_one[n].norm())
                  for n in before},
        one_process_gaps={n: g for n, (g, _) in vs_one.items()},
        shard_local_norms_gap=mutant[top(mutant)],
        shard_local_worst_leaf=top(mutant), tol=TRUST_STEP_TOL)
    log("[pp-lamb-zero2] " + json.dumps(res))
    assert explicit
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert res["own_gradient_gap"] <= TRUST_STEP_TOL, res
    assert res["one_process_gap"] <= TRUST_STEP_TOL, res
    assert res["one_process_noise_flip"] <= 2.0 + 1e-3, res
    assert res["shard_local_norms_gap"] >= 100 * TRUST_STEP_TOL, res
    del model
    torch.cuda.empty_cache()
    return res


def pipeline_train(smi):
    """Phase 6f: pipeline-parallel training and the rest of the optimizer
    surface on the one card (ranks on cuda:0 over an explicit gloo
    backend, every collective and hand-off staged through host memory).
    Run last, after gc.collect() and torch.cuda.empty_cache()."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated() / 2**30
    log(f"[pp] phase 6f starts with {base:.2f} GiB allocated ({smi})")
    meshes = {"pp2": _hybrid_mesh({"pp": 2}),
              "pp2mp2": _hybrid_mesh({"pp": 2, "mp": 2})}
    try:
        res = dict(base_mem_gib=base, parity=_pp_parity(meshes))
        res["scaler"] = _pp_scaler(meshes["pp2"])
        meshes.pop("pp2").close()
        res["gpt_1p3b"] = _pp_1p3b(meshes["pp2mp2"], smi)
    finally:
        for m in meshes.values():
            m.close()
    res["rules"] = _pp_rules()
    res["lamb_zero2"] = _pp_lamb_zero()
    res["seconds"] = time.perf_counter() - t0
    log(f"[pp] phase 6f {res['seconds']:.1f} s")
    return res


# -- phase 6g -----------------------------------------------------------------

SP_LABEL = ("eager, gloo through the host, ranks sharing one card - not an "
            "sp speed")
RING_SHAPE = (1, 2048, 16, 128)    # gpt_1p3b's attention over its context
RING_TOL = {torch.float32: F32_FLASH_TOL, torch.bfloat16: 2e-2}


def _bf16_ulp(t):
    """One bfloat16 ulp at each value of `t`: 2^(e - 8) for |t| = m 2^e
    with m in [0.5, 1) (8 significant bits)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _ring_arithmetic():
    """6g (a): the ring's steps (parallel/ring_attention.py `rank_forward`,
    `rank_backward`) for every rank of a ring of n = 2 and 4 in one
    process on cuda:0, at gpt_1p3b's attention shape (1 x 2048, 16 heads,
    D 128, causal), float32 and bfloat16, against one flash forward and
    backward over the whole sequence on the same values: O, dQ, dK and dV
    within 2e-5 (float32), and in bfloat16 within 2e-2 plus one bf16 ulp
    of the one call's value (its own rounding: two roundings of one value
    differ by up to an ulp, 0.03 at |dV| = 4). Rank i launches the
    forward and the backward pair i + 1 times (nothing above the
    diagonal), and its steps make no host sync (under
    set_sync_debug_mode("error")). Times: the busiest rank's (n - 1)
    forward and backward beside the whole sequence's one call (CUDA
    events, eager)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel.ring_attention import (rank_backward,
                                                          rank_forward)

    gen = torch.Generator(device="cuda").manual_seed(20)
    B, S, H, D = RING_SHAPE
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn((B, S, H, D), generator=gen,
                                   device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        want = dict(zip(("o", "dq", "dk", "dv"), (o,) + tuple(
            fa.flash_attention_bwd(q, k, v, o, do, lse, True))))

        def whole():
            o, lse = fa.flash_attention_fwd(q, k, v, True)
            fa.flash_attention_bwd(q, k, v, o, do, lse, True)

        for n in (2, 4):
            L = S // n

            def cut(t, i):
                return t[:, i * L:(i + 1) * L]

            blocks = [(cut(k, j), cut(v, j)) for j in range(n)]
            got = {"o": [], "dq": [],
                   "dk": [torch.zeros((B, L, H, D), device="cuda")
                          for _ in range(n)],
                   "dv": [torch.zeros((B, L, H, D), device="cuda")
                          for _ in range(n)]}
            launches = []

            def rank(i):
                oi, lsei = rank_forward(cut(q, i), blocks, i, True)
                dqi, parts = rank_backward(cut(q, i), blocks, oi, cut(do, i),
                                           lsei, i, True)
                return oi, dqi, parts

            for i in range(n):
                _zero_flash_counts()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    oi, dqi, parts = rank(i)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                c = _read_flash_counts()
                launches.append([c["fwd_launches"], c["bwd_launches"]])
                got["o"].append(oi)
                got["dq"].append(dqi)
                for j, (a, b) in parts.items():
                    got["dk"][j] += a.float()
                    got["dv"][j] += b.float()
            diff = {name: (torch.cat(got[name], 1) - w.float()).abs()
                    for name, w in want.items()}
            err = {name: d.max().item() for name, d in diff.items()}
            # the error beyond the one call's own rounding (bf16), and
            # the largest magnitude each output reaches
            excess = {name: (d - (_bf16_ulp(want[name])
                                  if dtype == torch.bfloat16 else 0.0))
                      .max().item() for name, d in diff.items()}
            rec = dict(dtype=str(dtype).replace("torch.", ""), n=n,
                       shape=[B, S, H, D], causal=True, max_err=err,
                       max_err_beyond_ulp=excess,
                       max_abs={name: w.float().abs().max().item()
                                for name, w in want.items()},
                       tol=RING_TOL[dtype], rank_launches=launches,
                       last_rank_ms=event_ms(lambda: rank(n - 1), 3),
                       whole_call_ms=event_ms(whole, 3))
            log("[ring] " + json.dumps(rec))
            out.append(rec)
            assert launches == [[i + 1, i + 1] for i in range(n)], launches
            if max(excess.values()) > RING_TOL[dtype]:
                raise SystemExit(f"the ring misses {RING_TOL[dtype]} against "
                                 f"one flash call: {rec}")
        del q, k, v, do, o, lse, want
    torch.cuda.empty_cache()
    return out


# 6g (b)'s depth, cut from gpt_1p3b's 24 layers (an 18.4 s step on an H100
# 80GB HBM3 at 700 W) so that the whole script, 6j included, stays inside
# its time limit; 6j (b) runs the ring at gpt_1p3b's widths beside mp
SP_RING_LAYERS = 4


def _sp_1p3b(smi, mesh):
    """6g (b): gpt_1p3b's widths (vocab 50304, hidden 2048, 16 heads, FFN
    8192) at its 2048 context in float32 with ring attention, 4 layers
    (`SP_RING_LAYERS`), 2 rows, over {"sp": 2} (two ranks on cuda:0: 1024
    positions of each row a rank), SGD 0.1, 3 steps against the same model
    in one process: `_gathered_train`'s gates with the ring's (4 x (i + 1)
    flash launches of each direction a step on sp rank i). Each rank's
    step phases (forward and backward with their ring hops, the gradient
    all-reduce, the update), peak memory and seconds."""
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn

    cfg = GPTConfig(vocab_size=50304, hidden_size=2048,
                    num_layers=SP_RING_LAYERS, num_heads=16, max_seq_len=2048,
                    intermediate_size=8192, attn_impl="ring")
    res = _gathered_train(
        smi, mesh, lambda p: GPT(cfg, device="cuda", dtype=torch.float32,
                                 seed=0),
        gpt_loss_fn, tuple(train_batch(cfg, 2, 2048, "cpu")),
        (("dp", "sp"),) * 2, SP_RING_LAYERS, bert=False, drops=(0.0,),
        ring=True)
    log(f"[sp-1p3b] ({SP_LABEL}; {smi}) " + json.dumps(res))
    return res


def _sp_flagship(smi, mesh):
    """6g (c): the flagship widths (vocab 32768, hidden 1024, 8 heads,
    seq 1024) at 2 layers with ring attention, float32, 4 rows, over
    {"dp": 2, "sp": 2} (four ranks on cuda:0: 2 rows and 512 positions a
    rank), SGD 0.1, 3 steps against one process: `_gathered_train`'s
    gates (the gradient's mean over dp x sp) with the ring's."""
    from paddle_tpu_torch.models.gpt import GPT, gpt_loss_fn

    cfg = flagship_config(num_layers=2, attn_impl="ring")
    res = _gathered_train(
        smi, mesh, lambda p: GPT(cfg, device="cuda", dtype=torch.float32,
                                 seed=0),
        gpt_loss_fn, tuple(train_batch(cfg, 4, 1024, "cpu")),
        (("dp", "sp"),) * 2, 2, bert=False, drops=(0.0,), ring=True)
    log(f"[sp-dp2sp2] ({SP_LABEL}; {smi}) " + json.dumps(res))
    return res


def sequence_train(smi):
    """Phase 6g: sequence-parallel training on the one card (ranks on
    cuda:0 over an explicit gloo backend, every ring hop and all-reduce
    staged through host memory). Run last, after gc.collect() and
    torch.cuda.empty_cache(). Both meshes' ranks start together after (a)
    and before (b), so that no step is timed while a rank starts; the
    card's free memory is back within 64 MiB once they are gone."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated() / 2**30
    log(f"[sp] phase 6g starts with {base:.2f} GiB allocated ({smi})")
    meshes = {"gpt_1p3b": _hybrid_mesh({"sp": 2}),
              "dp2sp2": _hybrid_mesh({"dp": 2, "sp": 2})}
    try:
        res = dict(base_mem_gib=base, ring=_ring_arithmetic())
        # after (a): this process's first launches grow its own context
        free0 = _card_free_bytes()
        t1 = time.perf_counter()
        _spawn_ranks(list(meshes.values()))
        res["spawn_s"] = time.perf_counter() - t1
        res["gpt_1p3b"] = _sp_1p3b(smi, meshes["gpt_1p3b"])
        meshes.pop("gpt_1p3b").close()
        res["dp2sp2"] = _sp_flagship(smi, meshes["dp2sp2"])
    finally:
        for m in meshes.values():
            m.close()
    free1 = _card_free_bytes()
    res.update(card_free_gib_before=free0 / 2**30,
               card_free_gib_after=free1 / 2**30)
    assert (free1 - free0) / 2**20 >= -64, ("card memory not back", res)
    res["seconds"] = time.perf_counter() - t0
    log(f"[sp] phase 6g {res['seconds']:.1f} s")
    return res


# -- phase 6h -----------------------------------------------------------------

MOE_LABEL = ("eager, gloo through the host, ranks sharing one card - not an "
             "ep speed")
MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
MOE_SHAPE = (8, 1024, 2048)     # 6h (a): x [8, 1024, 2048], T 8192
MOE_WIDTHS = (2048, 8192, 8)    # gpt_1p3b's hidden and FFN, 8 experts


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def _moe_grads(layer, x, do, dense):
    """One forward and backward of `layer` (``sum(out * dO) + aux``) in its
    own indexed form, or with `dense` in the JAX package's dense einsum
    form on the same weights: {"out", "aux", "x", and each parameter's
    gradient}."""
    from paddle_tpu_torch.distributed import moe

    layer.zero_grad(set_to_none=True)
    xg = x.detach().requires_grad_()
    if dense:
        flat = xg.reshape(-1, x.shape[-1])
        gates = layer.gate.gate_fn(flat)
        cap = moe.expert_capacity(layer.capacity_factor, flat.shape[0],
                                  layer.num_experts)
        out = moe.dense_moe(flat, gates, layer.w1, layer.b1, layer.w2,
                            layer.b2, cap).reshape(x.shape)
        aux = moe.switch_aux_loss(gates, gates.argmax(-1))
    else:
        out = layer(xg)
        aux = layer.aux_loss
    ((out * do).sum() + aux).backward()
    res = dict(out=out.detach(), aux=aux.detach(), x=xg.grad)
    res.update({n: p.grad for n, p in layer.named_parameters()})
    return res


def _moe_parts_ms(layer, x, do):
    """6h (a)'s split of the layer's time (CUDA events, eager): the
    router and dispatch, the expert products and the combine, forward and
    backward each, and the whole layer's forward and forward + backward."""
    from paddle_tpu_torch.distributed import moe

    E = layer.num_experts
    flat = x.reshape(-1, x.shape[-1]).detach().requires_grad_()
    do2 = do.reshape(flat.shape)
    cap = moe.expert_capacity(layer.capacity_factor, flat.shape[0], E)
    ws = (layer.w1, layer.b1, layer.w2, layer.b2)

    def route_dispatch():
        gates = layer.gate.gate_fn(flat)
        expert, slot, keep, prob = moe.route(gates, cap)
        disp, dest = moe.dispatch(flat, expert, slot, keep, E, cap)
        return disp, dest, prob

    disp, dest, prob = route_dispatch()
    g_disp = torch.randn_like(disp)
    g_prob = torch.randn_like(prob)
    disp_in = disp.detach().requires_grad_()
    eout = moe.expert_mlp(disp_in, *ws)
    g_eout = torch.randn_like(eout)
    eout_in = eout.detach().requires_grad_()
    prob_in = prob.detach().requires_grad_()
    out = moe.combine(eout_in, dest, prob_in)

    def whole():
        layer(x).backward(do)

    return dict(
        dispatch_fwd_ms=event_ms(route_dispatch, 5),
        dispatch_bwd_ms=event_ms(lambda: torch.autograd.grad(
            (disp, prob), (flat, layer.gate.gate), (g_disp, g_prob),
            retain_graph=True), 5),
        experts_fwd_ms=event_ms(lambda: moe.expert_mlp(disp_in, *ws), 5),
        experts_bwd_ms=event_ms(lambda: torch.autograd.grad(
            eout, (disp_in,) + ws, g_eout, retain_graph=True), 5),
        combine_fwd_ms=event_ms(lambda: moe.combine(eout_in, dest, prob_in),
                                5),
        combine_bwd_ms=event_ms(lambda: torch.autograd.grad(
            out, (eout_in, prob_in), do2, retain_graph=True), 5),
        layer_fwd_ms=event_ms(lambda: layer(x), 5),
        layer_fwd_bwd_ms=event_ms(whole, 3))


def _moe_peak_gib(layer, fn):
    """Peak GiB `fn` allocates above what was allocated before it, with
    `layer`'s gradients dropped first."""
    layer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def _moe_layer_card(smi):
    """6h (a): MoELayer(2048, 8192, 8, "switch") at x [8, 1024, 2048] (T
    8192, C 1280 at capacity factor 1.25; 640 at 0.5). f32 with TF32 off:
    the indexed form against the dense einsum form on the same weights,
    out, aux and every gradient within 1e-5 relative (max error over the
    tensor's max); bf16 within 2e-2. At 0.5: the dropped count equals the
    routed counts' overflow and the dropped tokens' output is zero. Times
    (CUDA events) split into dispatch, experts and combine, each way, the
    whole layer beside the dense form's, and peak memory of a forward and
    backward in each form."""
    from paddle_tpu_torch.distributed import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d, f, E = MOE_WIDTHS
    gen = torch.Generator(device="cuda").manual_seed(21)
    x32 = torch.randn(MOE_SHAPE, generator=gen, device="cuda")
    do32 = torch.randn(MOE_SHAPE, generator=gen, device="cuda")
    out = []
    for dtype, cf in ((torch.float32, 1.25), (torch.float32, 0.5),
                      (torch.bfloat16, 1.25)):
        layer = moe.MoELayer(d, f, E, gate="switch", capacity_factor=cf,
                             device="cuda", seed=3).to(dtype)
        x, do = x32.to(dtype), do32.to(dtype)
        got = _moe_grads(layer, x, do, dense=False)
        want = _moe_grads(layer, x, do, dense=True)
        err = {k: _rel_err(got[k], want[k]) for k in want}
        flat = x.reshape(-1, d)
        gates = layer.gate.gate_fn(flat)
        cap = moe.expert_capacity(cf, flat.shape[0], E)
        _, _, keep, _ = moe.route(gates, cap)
        counts = torch.bincount(gates.argmax(-1), minlength=E)
        overflow = int((counts - cap).clamp(min=0).sum())
        dropped = int((~keep).sum())
        dropped_out_zero = bool(
            (got["out"].reshape(-1, d)[~keep] == 0).all())
        del got, want
        rec = dict(dtype=str(dtype).replace("torch.", ""),
                   capacity_factor=cf, shape=list(MOE_SHAPE),
                   widths=list(MOE_WIDTHS), capacity=cap,
                   routed=counts.tolist(), dropped=dropped,
                   overflow=overflow, dropped_out_zero=dropped_out_zero,
                   max_rel_err=err, tol=MOE_TOL[dtype], card=smi,
                   expert_flop_a_step=3 * 2 * 2 * E * cap * d * f,
                   dense_combine_flop_a_step=3 * 2 * flat.shape[0] * E
                   * cap * d)
        if cf == 1.25:
            rec.update(_moe_parts_ms(layer, x, do))
            layer.zero_grad(set_to_none=True)
            rec["dense_fwd_bwd_ms"] = event_ms(
                lambda: _moe_grads(layer, x, do, dense=True), 3)
            rec["layer_peak_gib"] = _moe_peak_gib(
                layer, lambda: _moe_grads(layer, x, do, dense=False))
            rec["dense_peak_gib"] = _moe_peak_gib(
                layer, lambda: _moe_grads(layer, x, do, dense=True))
        log("[moe-layer] " + json.dumps(rec))
        out.append(rec)
        del layer
        torch.cuda.empty_cache()
        if max(err.values()) > MOE_TOL[dtype]:
            raise SystemExit(f"the MoE layer's indexed form misses "
                             f"{MOE_TOL[dtype]} against the dense form: "
                             f"{rec}")
        if dropped != overflow or not dropped_out_zero or \
                (cf < 1 and not dropped):
            raise SystemExit(f"the MoE layer's drops are wrong: {rec}")
    return out


def _moe_net(cf, seed=0):
    """6h (b)'s model: Linear(2048, 2048) -> MoELayer(2048, 8192, 8,
    "switch") -> Linear(2048, 2048), float32 on cuda:0 from `seed`."""
    from paddle_tpu_torch.distributed import moe

    d, f, E = MOE_WIDTHS
    torch.manual_seed(seed)
    return torch.nn.Sequential(
        torch.nn.Linear(d, d, device="cuda"),
        moe.MoELayer(d, f, E, gate="switch", capacity_factor=cf,
                     device="cuda", seed=seed),
        torch.nn.Linear(d, d, device="cuda"))


def _moe_batch():
    """4 x 1024 rows of 2048 in and out (CPU; each rank takes its rows)."""
    g = torch.Generator().manual_seed(22)
    return (torch.randn((4, 1024, MOE_WIDTHS[0]), generator=g),
            torch.randn((4, 1024, MOE_WIDTHS[0]), generator=g))


def _moe_one_process(cf, batch, steps, lr):
    """The model's `steps` SGD steps in this process: (losses, params,
    the largest norm of a leaf's change over its norm)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.optimizer import SGD

    net = _moe_net(cf)
    init = {n: p.detach().clone() for n, p in net.named_parameters()}
    opt = SGD(learning_rate=lr, parameters=net.named_parameters())
    x, y = (t.cuda() for t in batch)
    losses = []
    for _ in range(steps):
        loss = F.mse_loss(net(x), y)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(loss.item())
    params = {n: p.detach().clone() for n, p in net.named_parameters()}
    moved = max(float((params[n] - w).norm() / w.norm())
                for n, w in init.items() if w.norm() > 0)
    return losses, params, moved


class _A2AShare:
    """6h (c): one rank's share of the all-to-all block, a rank job of
    the port's parallel/spmd.py: its own 4096 tokens, its two experts of
    eight (every rank draws the whole model from one seed), the block's
    forward and backward of ``sum(out ** 2)`` through the counted
    all-to-all, and the dense form over every rank's tokens as the
    oracle (the sum of the ranks' losses)."""

    JOB_OPS = frozenset(("run",))

    def __init__(self, spec, mesh):
        self.mesh = mesh

    def run(self, T, seed):
        from paddle_tpu_torch.distributed import moe
        from paddle_tpu_torch.parallel import collectives

        torch.backends.cuda.matmul.allow_tf32 = False
        group, r = self.mesh.group, self.mesh.rank
        n = group.size
        H, F_, E = MOE_WIDTHS
        e = E // n
        dev = self.mesh.device
        g = torch.Generator(device=dev).manual_seed(seed)
        gw = torch.randn((H, E), generator=g, device=dev) * H ** -0.5
        w1 = torch.randn((E, H, F_), generator=g, device=dev) * H ** -0.5
        b1 = torch.randn((E, F_), generator=g, device=dev) * 0.1
        w2 = torch.randn((E, F_, H), generator=g, device=dev) * F_ ** -0.5
        b2 = torch.randn((E, H), generator=g, device=dev) * 0.1
        xs = [torch.randn((T, H), generator=g, device=dev)
              for _ in range(n)]
        mine = [t[r * e:(r + 1) * e].clone().requires_grad_()
                for t in (w1, b1, w2, b2)]
        x = xs[r].clone().requires_grad_()
        calls = collectives.all_to_all.calls
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = moe.moe_alltoall_block(x, gw, *mine, group)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        fwd_calls = collectives.all_to_all.calls - calls
        (out ** 2).sum().backward()
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        bwd_calls = collectives.all_to_all.calls - calls - fwd_calls
        cap = moe.expert_capacity(1.25, T, E)
        full = [t.detach().requires_grad_() for t in (w1, b1, w2, b2)]
        want_out = None
        for j, x in enumerate(xs):
            o = moe.dense_moe(x, torch.softmax(x @ gw, -1), *full, cap)
            (o ** 2).sum().backward()
            if j == r:
                want_out = o.detach()
        err = dict(o=_rel_err(out.detach(), want_out),
                   **{k: _rel_err(m.grad, f.grad[r * e:(r + 1) * e])
                      for k, m, f in zip(("w1", "b1", "w2", "b2"), mine,
                                         full)})
        return dict(rank=r, experts=[r * e, (r + 1) * e], capacity=cap,
                    fwd_all_to_all=fwd_calls, bwd_all_to_all=bwd_calls,
                    max_rel_err=err, fwd_s=t1 - t0, bwd_s=t2 - t1)


def _moe_a2a(mesh, smi):
    """6h (c): `moe_alltoall_block` on the four ranks of `mesh` (its world
    group, on cuda:0 over gloo), E 8 (two a rank), H 2048, F 8192, T 4096
    a rank, f32 with TF32 off: each rank's O and its experts' gradients
    of w1, b1, w2 and b2 within 1e-5 relative of the dense form over every
    rank's tokens; two all-to-alls a forward and two a backward a rank."""
    from paddle_tpu_torch.parallel import spmd

    ranks, = spmd.run_on_ranks(mesh, _A2AShare, ("run", 4096, 23))
    res = dict(label=MOE_LABEL, card=smi, world=mesh.size,
               widths=list(MOE_WIDTHS), tokens_a_rank=4096, ranks=ranks,
               tol=MOE_TOL[torch.float32])
    log("[moe-a2a] " + json.dumps(res))
    for r in ranks:
        assert (r["fwd_all_to_all"], r["bwd_all_to_all"]) == (2, 2), r
        if max(r["max_rel_err"].values()) > MOE_TOL[torch.float32]:
            raise SystemExit(f"the all-to-all block misses "
                             f"{MOE_TOL[torch.float32]}: {r}")
    torch.cuda.empty_cache()
    return res


def _moe_hybrid(smi):
    """6h (b) and (c): the model of `_moe_net`, float32 (TF32 off), SGD
    0.1, 3 steps on `_moe_batch` over {"mp": 2}, {"dp": 2, "mp": 2} and
    {"sharding": 2, "mp": 2} at ZeRO stage 2 (ranks on cuda:0 over gloo),
    at capacity factors 1.25 and 0.5, each against one process: losses
    within 1e-5 relative, every gathered parameter within 1e-5 of its
    norm; each rank's calls a step equal `moe_collective_budget`, and
    each holds 1/mp of the experts' bytes beside the rest whole. Each
    rank's peak memory and step phases. (c) runs on the 4-rank dp x mp
    mesh before it closes."""
    import torch.nn.functional as F

    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel import spmd
    from paddle_tpu_torch.parallel.spmd import (make_sharded_train_step,
                                                moe_collective_budget)

    torch.backends.cuda.matmul.allow_tf32 = False
    steps, lr = 3, 0.1
    batch = _moe_batch()
    want = {cf: _moe_one_process(cf, batch, steps, lr) for cf in (1.25, 0.5)}
    out, a2a = [], None
    for degrees, zs in (({"mp": 2}, 0), ({"dp": 2, "mp": 2}, 0),
                        ({"sharding": 2, "mp": 2}, 2)):
        mesh = _hybrid_mesh(degrees)
        try:
            for cf in (1.25, 0.5):
                net = _moe_net(cf)
                opt = SGD(learning_rate=lr,
                          parameters=net.named_parameters())
                t0 = time.perf_counter()
                step = make_sharded_train_step(net, F.mse_loss, opt, mesh,
                                               zero_stage=zs)
                build_s = time.perf_counter() - t0
                try:
                    losses, counts, wall, rank_s = _dp_run(step, batch,
                                                           steps, warmup=0)
                    t1 = time.perf_counter()
                    params = step.gather_params()
                    gather_s = time.perf_counter() - t1
                    held = step.param_bytes()
                    n_leaves = len(step.names)
                    zero = sum(z is not None for _, _, z in spmd.leaf_layouts(
                        step.model, mesh, zs).values())
                finally:
                    step.close()
                mp, dp = mesh.shape["mp"], mesh.shape["dp"]
                budget = moe_collective_budget(1, mp, (dp,), n_leaves, zero)
                experts = sum(p.numel() * 4 for n, p in net.named_parameters()
                              if n.startswith("1.w") or n.startswith("1.b"))
                whole = sum(p.numel() * 4 for p in net.parameters())
                one, wparams, moved = want[cf]
                rel = max(float((params[k].to(w.device) - w).norm()
                                / w.norm()) for k, w in wparams.items())
                rec = dict(label=MOE_LABEL, card=smi, mesh=degrees,
                           zero_stage=zs, capacity_factor=cf,
                           batch=[4, 1024], lr=lr, losses=losses,
                           one_process=one, param_max_rel_norm_diff=rel,
                           one_process_max_rel_update=moved,
                           build_s=build_s, gather_s=gather_s,
                           step_s=wall, rank_step_s=rank_s,
                           budget_a_step=budget, zero_leaves=zero,
                           param_bytes=held,
                           want_param_bytes=whole - experts + experts // mp,
                           counts=counts,
                           peak_gib=[c["peak_gib"] for c in counts])
                log(f"[moe-hybrid] ({MOE_LABEL}; {smi}) " + json.dumps(rec))
                out.append(rec)
                del net, opt, step, params
                np.testing.assert_allclose(losses, one, rtol=1e-5)
                assert rel < 1e-5, rec
                for c in counts:
                    assert c["collectives"] == {
                        k: v * steps for k, v in budget.items()}, (c, budget)
                assert held == [rec["want_param_bytes"]] * mesh.size, rec
            if mesh.size == 4 and degrees.get("dp", 1) == 2:
                a2a = _moe_a2a(mesh, smi)
        finally:
            mesh.close()
        torch.cuda.empty_cache()
    return out, a2a


def _plain_flash(q, k, v, causal=False, mask=None, dropout_p=0.0, seed=None,
                 head_offset=0, heads_total=None):
    """Flash attention's plain version (autograd through `attention_ref`)
    on any device: 6h (d)'s oracle."""
    from paddle_tpu_torch.ops import flash_attention as fa

    return fa.attention_ref(q, k, v, causal, mask, dropout_p, seed,
                            head_offset, heads_total)


def _sdpa_flash(q, k, v, causal=False, mask=None, dropout_p=0.0, seed=None,
                head_offset=0, heads_total=None):
    """torch's `scaled_dot_product_attention` on [B, S, H, D] with the
    additive mask and dropout_p: 6h (d)'s yardstick (timing only)."""
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=None if mask is None else mask.to(q.dtype),
        dropout_p=dropout_p, is_causal=causal)
    return o.transpose(1, 2)


@contextlib.contextmanager
def _attention_through(fn):
    """ops/common_nn's attention through `fn` inside (None: the kernels as
    they are; the comparisons and the yardstick of 6h (d); the port's own
    path has no switch)."""
    from paddle_tpu_torch.ops import common_nn

    kernels = common_nn.flash_attention
    common_nn.flash_attention = fn or kernels
    try:
        yield
    finally:
        common_nn.flash_attention = kernels


def _mha_call(inputs, grad_of, p, seed):
    """`fused_multi_head_attention` (post-LN, a padding mask) on `inputs`
    with dropout `p` (attention and output), after torch.manual_seed(seed)
    unless `seed` is None: the output and, for a non-empty `grad_of`, the
    gradients of ``sum(out * dO)`` for those inputs."""
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_multi_head_attention

    ts = {k: (t.detach().requires_grad_() if k in grad_of else t)
          for k, t in inputs.items() if k != "do"}
    if seed is not None:
        torch.manual_seed(seed)
    with torch.set_grad_enabled(bool(grad_of)):
        out = fused_multi_head_attention(
            **ts, dropout_rate=p, attn_dropout_rate=p, training=True)
    if not grad_of:
        return dict(out=out)
    out.backward(inputs["do"])
    return dict(out=out.detach(), **{k: ts[k].grad for k in grad_of})


def _fused_mha(smi):
    """6h (d): `fused_multi_head_attention` at ERNIE-base's shape (32 x
    512, embed 768, 12 heads, a padding mask of real lengths 256-512,
    post-LN). Dropout 0: the kernels against flash's plain version on the
    card (the same function through `attention_ref`), out and the
    gradients of x, the qkv and output weights within 1e-5 relative in
    f32 (TF32 off) and 2e-2 in bf16. Dropout 0.1 (attention and output,
    the same seed on both sides): one forward and one backward launch a
    call, each the mask + dropout variant, and the kernels' values equal
    the plain version's forward and backward (the same keep bits both
    ways). bf16 times of the whole function (CUDA events) beside the same
    function with torch's SDPA in its attention (timing only)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, E, Hn = 32, 512, 768, 12
    g = torch.Generator(device="cuda").manual_seed(24)
    lengths = padding_lengths(B, S, np.random.RandomState(24))
    base = dict(
        x=torch.randn((B, S, E), generator=g, device="cuda"),
        qkv_weight=torch.randn((3, Hn, E // Hn, E), generator=g,
                               device="cuda") * E ** -0.5,
        qkv_bias=torch.randn((3, Hn, E // Hn), generator=g,
                             device="cuda") * 0.1,
        linear_weight=torch.randn((E, E), generator=g, device="cuda")
        * E ** -0.5,
        linear_bias=torch.randn((E,), generator=g, device="cuda") * 0.1,
        ln_scale=1 + 0.1 * torch.randn((E,), generator=g, device="cuda"),
        ln_bias=0.1 * torch.randn((E,), generator=g, device="cuda"),
        do=torch.randn((B, S, E), generator=g, device="cuda"))
    mask = padding_mask(lengths, S, "cuda")
    grad_of = ("x", "qkv_weight", "linear_weight")
    res = dict(card=smi, shape=[B, S, E], heads=Hn,
               lengths=[int(lengths.min()), int(lengths.max())])
    for dtype in (torch.float32, torch.bfloat16):
        inputs = {k: t.to(dtype) for k, t in base.items()}
        inputs["attn_mask"] = mask
        name = str(dtype).replace("torch.", "")
        for p in (0.0, 0.1):
            _zero_flash_counts()
            got = _mha_call(inputs, grad_of, p, 25)
            counts = _read_flash_counts()
            with _attention_through(_plain_flash):
                want = _mha_call(inputs, grad_of, p, 25)
            err = {k: _rel_err(got[k], want[k]) for k in want}
            rec = dict(max_rel_err=err, tol=MOE_TOL[dtype], **counts)
            res[f"{name}_p{p}"] = rec
            drop = int(p > 0)
            assert counts == {"fwd_launches": 1, "fwd_mask_launches": 1,
                              "fwd_dropout_launches": drop,
                              "bwd_launches": 1, "bwd_mask_launches": 1,
                              "bwd_dropout_launches": drop}, counts
            if max(err.values()) > MOE_TOL[dtype]:
                raise SystemExit(f"fused_multi_head_attention misses "
                                 f"{MOE_TOL[dtype]} against the plain "
                                 f"version: {dtype} p {p} {rec}")
            del got, want
        if dtype == torch.bfloat16:
            def fwd():
                _mha_call(inputs, (), 0.1, None)

            def fwd_bwd():
                _mha_call(inputs, grad_of, 0.1, None)

            # kernels, SDPA, SDPA, kernels: the mean of each pair
            times = {}
            for name, fn in (("", _attention_through(None)),
                             ("sdpa_", _attention_through(_sdpa_flash)),
                             ("sdpa_", _attention_through(_sdpa_flash)),
                             ("", _attention_through(None))):
                with fn:
                    for what, call in (("fwd", fwd), ("fwd_bwd", fwd_bwd)):
                        times.setdefault(f"bf16_p0.1_{name}{what}_ms",
                                         []).append(event_ms(call, 10))
            res.update({k: float(np.mean(v)) for k, v in times.items()})
            res["bf16_p0.1_times_ms"] = times
    log("[fused-mha] " + json.dumps(res))
    torch.cuda.empty_cache()
    return res


def moe_train(smi):
    """Phase 6h: expert parallelism and incubate's fused functionals on
    the one card (run last): (a) the MoE layer at full width, (b) the
    hybrid step with MoE over mp, dp x mp and sharding x mp, (c) the
    all-to-all block over four ranks, (d) fused_multi_head_attention at
    ERNIE-base's shape through the flash kernels."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[moe] phase 6h starts with "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated ({smi})")
    res = dict(layer=_moe_layer_card(smi))
    t1 = time.perf_counter()
    res["fused_mha"] = _fused_mha(smi)
    t2 = time.perf_counter()
    res["hybrid"], res["alltoall"] = _moe_hybrid(smi)
    res["seconds"] = time.perf_counter() - t0
    res["part_seconds"] = {"a": t1 - t0, "d": t2 - t1,
                           "b_c": res["seconds"] - (t2 - t0)}
    log(f"[moe] phase 6h {res['seconds']:.1f} s")
    return res


# -- phase 6i -----------------------------------------------------------------

# 6i (a)'s calls: name, (B, S, H, D), causal, padding mask, dropout ps
GATHER_CASES = (
    ("gpt_1p3b", (1, 2048, 16, 128), True, False, (0.0, 0.1)),
    ("ernie_base", (32, 512, 12, 64), False, True, (0.1,)),
)
GATHER_TIMED = 2     # the n whose calls are timed (plain times: rank 1)
# 6i (a): a rank's launches against the float32 plain version (phase 5's
# gates: the f32 kernels' accuracy, bf16 against f32 as in the variants)
GATHER_PLAIN_TOL = {torch.float32: F32_FLASH_TOL,
                    torch.bfloat16: TOL[torch.bfloat16]}


def _rank_bounds(B, Sq, Sk, H, D, dtype, causal, q_row0, mask_bytes=0):
    """`_flash_bounds` of one rank's launch: its Sq queries from row
    `q_row0` against Sk keys (the prefix ``q_row0 + Sq`` when causal).
    Pairs: ``Sq * q_row0 + Sq (Sq + 1) / 2`` a batch*head when causal,
    ``Sq * Sk`` otherwise; bytes: q, k, v in and O out (forward, plus the
    f32 LSE), q, dO, k, v, LSE, delta in and dK, dV out (dK/dV), q, dO, k,
    v, LSE, delta in and dQ out (dQ), the mask's own bytes once."""
    isz = torch.tensor([], dtype=dtype).element_size()
    pairs = B * H * (Sq * q_row0 + Sq * (Sq + 1) // 2 if causal else Sq * Sk)
    tq, tk = B * Sq * H * D * isz, B * Sk * H * D * isz
    rows = B * H * Sq * 4
    work = {"fwd": (2, 2 * tq + 2 * tk + rows),
            "dkv": (4, 2 * tq + 4 * tk + 2 * rows),
            "dq": (3, 3 * tq + 2 * tk + 2 * rows)}
    peak = PEAK_TF32 / 3 if dtype == torch.float32 else PEAK_FLOPS[dtype]
    out = {}
    for name, (products, nbytes) in work.items():
        t_ops = products * 2 * D * pairs / peak
        t_bytes = (nbytes + mask_bytes) / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def _gathered_times(qr, kp, vp, dor, lse, o_bwd, r, causal, m, p, seed,
                    o32, views, plain, **heads):
    """One rank's call timed: the forward, dK/dV and dQ kernels (CUDA graph
    replays) and SDPA's forward and forward + backward on the same call
    (its mask explicit: a bottom-right causal bool mask, or the padding
    mask; SDPA's `is_causal` is top-left aligned); with `plain`, the plain
    version's forward and whole backward (CUDA events, eager). `heads`:
    the rank's ``head_offset`` and ``heads_total`` (an mp rank's)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    F = torch.nn.functional
    L, keys = qr.shape[1], kp.shape[1]
    var = dict(q_row0=r * L, **heads)
    delta = fa._delta(o_bwd, dor)
    t = dict(
        fwd_ms=time_ms(lambda: fa.flash_attention_fwd(
            qr, kp, vp, causal, m, p, seed, o32, **var), 5),
        dkv_ms=time_ms(lambda: fa._launch_bwd(
            qr, kp, vp, dor, lse, delta, causal, 1, m, p, seed, **var,
            out=views), 5),
        dq_ms=time_ms(lambda: fa._launch_bwd(
            qr, kp, vp, dor, lse, delta, causal, 2, m, p, seed, **var), 5))
    ql, kl, vl = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (qr, kp, vp))
    dol = dor.transpose(1, 2).contiguous()
    am = (torch.ones((L, keys), dtype=torch.bool, device="cuda").tril(r * L)
          if causal else m.to(qr.dtype))

    def sdpa():
        return F.scaled_dot_product_attention(ql, kl, vl, attn_mask=am,
                                              dropout_p=p)

    t["library_fwd_ms"] = time_ms(sdpa, 5)
    t["library_bwd_ms"] = time_ms(
        lambda: torch.autograd.grad(sdpa(), (ql, kl, vl), dol), 5) \
        - t["library_fwd_ms"]
    if plain:
        qg, kg, vg = (x.detach().float().requires_grad_()
                      for x in (qr, kp, vp))
        og = fa.attention_ref(qg, kg, vg, causal, m, p, seed, **var)
        t["plain_fwd_ms"] = event_ms(lambda: fa.attention_ref(
            qg, kg, vg, causal, m, p, seed, **var), 2)
        t["plain_bwd_ms"] = event_ms(lambda: torch.autograd.grad(
            og, (qg, kg, vg), dor.float(), retain_graph=True), 2)
    return t


def _rank_plain_err(qr, kp, vp, dor, m, r, causal, p, seed, got, **heads):
    """One rank's launches (`got`: its o, lse, dq and the dK / dV partials
    over the keys it attended) against the float32 plain version on the
    same inputs: `attention_ref`, `attention_lse_ref` and
    `attention_bwd_ref` at the rank's `q_row0`, key prefix, mask, dropout
    seed and `heads` (an mp rank's ``head_offset`` and ``heads_total``).
    The largest absolute error of each."""
    from paddle_tpu_torch.ops import flash_attention as fa

    q32, k32, v32, do32 = (x.detach().float() for x in (qr, kp, vp, dor))
    var = dict(q_row0=r * qr.shape[1], **heads)
    o = fa.attention_ref(q32, k32, v32, causal, m, p, seed, **var)
    lse = fa.attention_lse_ref(q32, k32, causal, m)
    dq, dk, dv = fa.attention_bwd_ref(q32, k32, v32, o, do32, lse, causal,
                                      m, p, seed, **var)
    want = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv)
    return {x: (got[x].float() - w).abs().max().item()
            for x, w in want.items()}


def _gathered_arithmetic():
    """6i (a): gathered sequence attention's share of every rank of n = 2
    and 4 (parallel/sequence_attention.py `rank_forward`,
    `rank_backward`, on K/V in the gathered [S, B, 2, H, D] layout, the
    partials written into such a buffer) in one process on cuda:0,
    against one flash forward and backward over the whole sequence sliced
    to the rank: O and dQ, and dK and dV after summing the ranks'
    partials, within 2e-5 (f32) or 2e-2 beyond one bf16 ulp (bf16); and
    each rank's O, LSE, dQ and dK / dV partials against the float32 plain
    version at its `q_row0`, key prefix, mask and seed (`_rank_plain_err`),
    within 2e-5 (f32) or 2e-2 (bf16). At dropout 0.1 the plain
    `dropout_factors` at the rank's `q_row0` equal the whole call's rows
    bit for bit. Each rank launches one forward and
    one dK/dV + dQ pair and makes no host sync (set_sync_debug_mode
    "error"). Every call's bound; at n = 2 each call's kernel times beside
    SDPA's on the same call, and at rank 1 the plain version's."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel.sequence_attention import (
        attended_keys, rank_backward, rank_forward, rank_mask)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(23)
    out = []
    for name, (B, S, H, D), causal, with_mask, ps in GATHER_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn((B, S, H, D), generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            mask = (padding_mask(padding_lengths(
                B, S, np.random.RandomState(0)), S, "cuda")
                if with_mask else None)
            whole = torch.empty((S, B, 2, H, D), dtype=dtype, device="cuda")
            whole[:, :, 0] = k.transpose(0, 1)
            whole[:, :, 1] = v.transpose(0, 1)
            kw, vw = (whole.permute(1, 0, 2, 3, 4)[:, :, j] for j in (0, 1))
            for p in ps:
                seed = DROPOUT_SEED if p else None
                o32 = torch.empty(q.shape, device="cuda") if p else None
                o, lse = fa.flash_attention_fwd(q, k, v, causal, mask, p,
                                                seed, o32)
                want = dict(zip(("o", "dq", "dk", "dv"), (o,) + tuple(
                    fa.flash_attention_bwd(q, k, v, o if o32 is None else
                                           o32, do, lse, causal, mask, p,
                                           seed))))
                whole_f = (fa.dropout_factors(seed, p, B, H, S, S, "cuda")
                           if p else None)
                for n in (2, 4):
                    L = S // n
                    got = {"o": [], "dq": [],
                           "dk": torch.zeros((B, S, H, D), device="cuda"),
                           "dv": torch.zeros((B, S, H, D), device="cuda")}
                    ranks = []
                    for r in range(n):
                        rows = slice(r * L, (r + 1) * L)
                        qr, dor = q[:, rows], do[:, rows]
                        keys = attended_keys(r, L, S, causal)
                        parts = torch.zeros((S, B, 2, H, D), dtype=dtype,
                                            device="cuda")
                        views = [parts[:keys, :, j].transpose(0, 1)
                                 for j in (0, 1)]
                        or32 = (torch.empty((B, L, H, D), device="cuda")
                                if p else None)
                        _zero_flash_counts()
                        torch.cuda.set_sync_debug_mode("error")
                        try:
                            orr, lser = rank_forward(qr, kw, vw, r, causal,
                                                     mask, p, seed, o32=or32)
                            o_bwd = orr if or32 is None else or32
                            dqr, _, _ = rank_backward(
                                qr, kw, vw, o_bwd, dor, lser, r, causal,
                                mask, p, seed, out=views)
                        finally:
                            torch.cuda.set_sync_debug_mode(0)
                        c = _read_flash_counts()
                        got["o"].append(orr)
                        got["dq"].append(dqr)
                        got["dk"] += parts[:, :, 0].transpose(0, 1).float()
                        got["dv"] += parts[:, :, 1].transpose(0, 1).float()
                        m = rank_mask(mask, r, L, keys)
                        plain_err = _rank_plain_err(
                            qr, kw[:, :keys], vw[:, :keys], dor, m, r,
                            causal, p, seed, dict(o=orr, lse=lser, dq=dqr,
                                                  dk=views[0], dv=views[1]))
                        rec_r = dict(
                            rank=r, q_row0=r * L, keys=keys,
                            launches=[c["fwd_launches"], c["bwd_launches"]],
                            plain_err=plain_err,
                            keep_bits_equal=None if not p else bool(
                                torch.equal(fa.dropout_factors(
                                    seed, p, B, H, L, S, "cuda",
                                    q_row0=r * L), whole_f[:, :, rows])),
                            **(_gathered_times(
                                qr, kw[:, :keys], vw[:, :keys], dor, lser,
                                o_bwd, r, causal, m, p, seed, or32, views,
                                plain=r == 1) if n == GATHER_TIMED else {}))
                        bounds = _rank_bounds(
                            B, L, keys, H, D, dtype, causal, r * L,
                            0 if mask is None else B * keys * 4)
                        rec_r.update({f"bound_{k}_ms": b[0]
                                      for k, b in bounds.items()})
                        rec_r.update({f"bound_{k}_by": b[1]
                                      for k, b in bounds.items()})
                        ranks.append(rec_r)
                    joined = {"o": torch.cat(got["o"], 1),
                              "dq": torch.cat(got["dq"], 1),
                              "dk": got["dk"], "dv": got["dv"]}
                    diff = {x: (joined[x].float() - w.float()).abs()
                            for x, w in want.items()}
                    excess = {x: (d - (_bf16_ulp(want[x])
                                       if dtype == torch.bfloat16 else 0.0))
                              .max().item() for x, d in diff.items()}
                    rec = dict(case=name, dtype=str(dtype)[6:], n=n,
                               shape=[B, S, H, D], causal=causal,
                               mask=None if mask is None
                               else list(mask.shape), dropout_p=p,
                               plain_max_err={
                                   x: max(rr["plain_err"][x] for rr in ranks)
                                   for x in ranks[0]["plain_err"]},
                               plain_tol=GATHER_PLAIN_TOL[dtype],
                               max_err={x: d.max().item()
                                        for x, d in diff.items()},
                               max_err_beyond_ulp=excess,
                               tol=RING_TOL[dtype], ranks=ranks)
                    log("[gathered] " + json.dumps(rec))
                    out.append(rec)
                    assert all(x["launches"] == [1, 1] for x in ranks), rec
                    assert all(x["keep_bits_equal"] in (None, True)
                               for x in ranks), rec
                    if max(excess.values()) > RING_TOL[dtype]:
                        raise SystemExit(
                            f"gathered attention misses {RING_TOL[dtype]} "
                            f"against one flash call: {rec}")
                    if max(rec["plain_max_err"].values()) > \
                            GATHER_PLAIN_TOL[dtype]:
                        raise SystemExit(
                            f"a rank's gathered launches miss "
                            f"{GATHER_PLAIN_TOL[dtype]} against the plain "
                            f"version: {rec}")
                del o, lse, want, whole_f, o32
            del q, k, v, do, whole, kw, vw
            torch.cuda.empty_cache()
    return out


def _sp_budget(mesh, layers, n_leaves, bert, ring=False, remat=False,
               n_zero_leaves=0):
    """`hybrid_collective_budget` of a sequence-split step of `layers`
    layers over `mesh` (the rows over its dp and sharding axes, the
    sequence over sp): the ring's hops or the gathered attention's calls,
    BERT's terms with `bert`, at mp above 1 the mp layers' calls as
    `_mp_budget` states them (GPT's vocab-parallel head; ERNIE's gathered
    MLM logits), the step's remat and the ZeRO gathers."""
    from paddle_tpu_torch.parallel.spmd import hybrid_collective_budget

    s = mesh.shape
    fwd = (1 + 2 * layers + (0 if bert else 3), int(bert))
    return hybrid_collective_budget(
        n_leaves, (s["dp"], s["sharding"]), sp_degree=s["sp"],
        ring_layers=layers if ring else 0,
        gathered_layers=0 if ring else layers, first_token=bert,
        weighted_loss=bert, mp_degree=s["mp"],
        mp_calls=(fwd[0] + 2 * layers + 1, fwd[1]), mp_forward=fwd,
        remat=remat, n_zero_leaves=n_zero_leaves)


def _gathered_gate(mesh, counts, layers, n_leaves, n_arrays, bert, p,
                   ring=False, remat=False, n_zero_leaves=0):
    """Each rank: `_sp_budget`'s calls a step; flash launches a step:
    gathered, `layers` of each direction on every rank (each rank's whole
    key prefix in one call), with the ring `layers` x (i + 1) on sp rank i
    (nothing above the diagonal), the forward's twice under `remat` (the
    recomputed forward launches again); ERNIE's all mask launches, and at
    `p` > 0 (gathered) all dropout launches; no host sync a step beyond
    the budget's (a staged collective two: out and back; a send or a
    receive one) and the step's own (its `n_arrays` batch arrays in, the
    loss out)."""
    b = _sp_budget(mesh, layers, n_leaves, bert, ring, remat, n_zero_leaves)
    allowed = n_arrays + 1 + b["send"] + b["recv"] + 2 * (
        b["all-reduce"] + b["all-gather"] + b["reduce-scatter"])
    for c in counts:
        steps = c["steps"]
        assert c["collectives"] == {k: v * steps for k, v in b.items()}, (
            c, b)
        blocks = mesh.coords(c["rank"])["sp"] + 1 if ring else 1
        n = layers * blocks * steps
        for d, nd in (("fwd", n * (1 + remat)), ("bwd", n)):
            assert c[f"{d}_launches"] == nd, (d, c)
            assert c[f"{d}_mask_launches"] == (nd if bert else 0), c
            assert c[f"{d}_dropout_launches"] == (
                nd if p and not ring else 0), c
        assert max(c["host_syncs"]) <= allowed, (c["host_syncs"], allowed)
    return dict(budget_a_step=b, host_syncs_allowed=allowed)


def _sgd(model):
    from paddle_tpu_torch.optimizer import SGD

    return SGD(learning_rate=0.1, parameters=model.named_parameters())


def _params_and_opt(step, adam):
    """(optimizer state dict or None, natural parameters) of `step`: with
    `adam` both from one `state_dict` (one gather), else the
    parameters alone."""
    if not adam:
        return None, step.gather_params()
    sd = step.state_dict()
    return sd["optimizer"], sd["params"]


# 6j (c)'s AdamW gates. A leaf that starts at zero (a bias) is held entry
# by entry, not by its norm: its norm is Adam's three steps, each up to lr
# (1e-4) whatever its gradient's size, so the rounding of a gradient that
# nearly cancels, which Adam divides by that gradient's own size, is no
# small part of it. 5e-6 is 10x the readings (5.03e-7 an entry) and 1/20
# of one Adam step. An entry whose gradient is zero in exact arithmetic
# (the key bias) is held by its first moment, float noise in both runs
ADAM_ZERO_START_TOL = 5e-6
NOISE_MOMENT_TOL = 1e-4


def _param_gate(want, got, noisy=None, zero=(), want_opt=None, got_opt=None):
    """The parameter gate between a reference run's parameters `want` and
    a run's `got` ({name: tensor}): each leaf within 1e-5 of the
    reference's norm. With Adam's state (`want_opt`, `got_opt`: the two
    runs' optimizer state dicts) the gradients the update saw are held
    directly, both moments of every leaf within 1e-5 of their norm, and
    a leaf that starts at zero (`zero`) entry by entry within
    `ADAM_ZERO_START_TOL` of the reference's in place of its norm. The
    `noisy` entries ({name: index}: a gradient zero in exact arithmetic,
    whose sign Adam's step follows) are left out of those gates and held
    by their first moment, below `NOISE_MOMENT_TOL` of their leaf's
    largest in both runs. Returns the record; raises when a gate
    fails."""
    noisy = noisy or {}
    adam = want_opt is not None
    assert adam or not noisy, "float-noise entries are held by Adam's state"

    def kept(k, t):
        t = t.float().cpu()
        if k not in noisy:
            return t
        keep = torch.ones_like(t, dtype=torch.bool)
        keep[noisy[k]] = False
        return t[keep]

    def rel(k, a, b):
        a, b = kept(k, a), kept(k, b)
        return float((a - b).norm() / max(float(b.norm()), 1e-12))

    zeros = [k for k in want if adam and k in zero]
    rels = {k: rel(k, got[k], want[k]) for k in want}
    out = dict(param_max_rel_norm_diff=max(rels[k] for k in want
                                           if k not in zeros),
               param_max_abs_diff=max(float((got[k] - want[k]).abs().max())
                                      for k in want),
               param_worst=[(k, rels[k], float((got[k] - want[k]).abs()
                                               .max()))
                            for k in sorted(rels, key=rels.get)[-4:]])
    if adam:
        moments = {slot: rel(k, got_opt[slot], want_opt[slot])
                   for k in want for slot in (f"{k}_moment1", f"{k}_moment2")}

        def noise_ratio(opt, k):
            m = opt[f"{k}_moment1"].float().abs().cpu()
            return float(m[noisy[k]].max() / m.max())

        out.update(
            moment_max_rel_norm_diff=max(moments.values()),
            moment_worst=sorted(moments.items(), key=lambda x: x[1])[-2:],
            zero_start_leaves=len(zeros),
            zero_start_max_abs_diff=max(
                (float((kept(k, got[k]) - kept(k, want[k])).abs().max())
                 for k in zeros), default=0.0),
            zero_start_tol=ADAM_ZERO_START_TOL,
            noise_leaves=len(noisy),
            noise_moment_max_ratio=max(
                (noise_ratio(o, k) for o in (want_opt, got_opt)
                 for k in noisy), default=0.0),
            noise_moment_tol=NOISE_MOMENT_TOL)
        assert out["moment_max_rel_norm_diff"] < 1e-5, out
        assert out["zero_start_max_abs_diff"] <= ADAM_ZERO_START_TOL, out
        assert out["noise_moment_max_ratio"] < NOISE_MOMENT_TOL, out
    assert out["param_max_rel_norm_diff"] < 1e-5, out
    return out


def _gathered_train(smi, mesh, make, loss_fn, batch, specs, layers, bert,
                    steps=3, drops=(0.0, 0.1), ring=False, remats=(False,),
                    zero_stage=0, make_opt=_sgd, ref_mesh=None, noise=None):
    """`steps` float32 steps (the optimizer `make_opt(model)`: SGD 0.1) of
    the model `make(p)` builds on one batch, for each dropout p of
    `drops`: the reference first, in one process (a ``{"dp": 1}`` mesh,
    the same step code and seeds) or over `ref_mesh` with `specs` (the
    hybrid path), then over `mesh` with `specs`, `zero_stage` and each
    remat flag of `remats` (every rank's counters set to 0 just before
    and read just after, its host syncs counted): losses within 1e-5
    relative, `_param_gate` (every parameter within 1e-5 of the
    reference's norm; under Adam its moments too, and a leaf that starts
    at zero entry by entry), `_gathered_gate` on every rank, each
    rank's optimizer bytes reported. `noise(name)` may name entries of a
    leaf whose gradient is float noise (`_param_gate`). Returns the
    records by run (``"p0.1"``, ``"p0.1_remat"``; each rank's step
    phases, peak and seconds in `counts`)."""
    from paddle_tpu_torch.parallel.spmd import (leaf_layouts,
                                                make_sharded_train_step)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for p in drops:
        model = make(p)
        zero = {k for k, t in model.named_parameters() if not t.any()}
        opt = make_opt(model)
        adam = "moment2" in getattr(opt, "_slot_names", ())
        mesh1 = _hybrid_mesh({"dp": 1}) if ref_mesh is None else ref_mesh
        step = make_sharded_train_step(
            model, loss_fn, opt, mesh1,
            **({} if ref_mesh is None else dict(
                batch_specs=specs, zero_stage=zero_stage,
                explicit_update=False)))
        try:
            t0 = time.perf_counter()
            want = [step(*batch) for _ in range(steps)]
            one_s = (time.perf_counter() - t0) / steps
            ref_opt = step.per_chip_opt_state_bytes()
            want_opt, wparams = _params_and_opt(step, adam)
        finally:
            step.close()
            if ref_mesh is None:
                mesh1.close()
        del model, step
        for remat in remats:
            model = make(p)
            zl = sum(zs is not None for _, _, zs in leaf_layouts(
                model, mesh, zero_stage).values())
            t0 = time.perf_counter()
            step = make_sharded_train_step(model, loss_fn, make_opt(model),
                                           mesh, batch_specs=specs,
                                           zero_stage=zero_stage,
                                           remat=remat)
            build_s = time.perf_counter() - t0
            step.count_host_syncs()
            try:
                losses, counts, wall, ranks = _dp_run(step, batch, steps,
                                                      warmup=0)
                n_leaves = len(step.names)
                opt_bytes = step.per_chip_opt_state_bytes()
                whole_opt = step.unsharded_opt_state_bytes()
                got_opt, params = _params_and_opt(step, adam)
            finally:
                step.close()
            noisy = {k: noise(k) for k in wparams} if noise else {}
            noisy = {k: i for k, i in noisy.items() if i is not None}
            rec = dict(label=SP_LABEL, card=smi, mesh=dict(mesh.shape),
                       dropout=p, remat=remat, zero_stage=zero_stage,
                       reference=("one process" if ref_mesh is None
                                  else dict(ref_mesh.shape)),
                       one_process=want, one_process_step_s=one_s,
                       losses=losses, build_s=build_s, step_s=wall,
                       rank_step_s=ranks, leaves=n_leaves,
                       zero_leaves=zl, counts=counts,
                       peak_gib=[c["peak_gib"] for c in counts],
                       opt_bytes=opt_bytes, reference_opt_bytes=ref_opt,
                       unsharded_opt_bytes=whole_opt)
            runs[f"p{p}" + ("_remat" if remat else "")] = rec
            del model, step
            try:
                rec.update(_gathered_gate(mesh, counts, layers, n_leaves,
                                          len(batch), bert, p, ring, remat,
                                          zl))
                np.testing.assert_allclose(losses, want, rtol=1e-5)
                assert all(np.isfinite(losses)), losses
                rec.update(_param_gate(wparams, params, noisy, zero,
                                       want_opt, got_opt))
            finally:
                log(f"[sp-run] {json.dumps(rec, default=str)}")
            del params, got_opt
        del wparams, want_opt
    return dict(runs=runs)


def _gathered_ernie(smi, mesh):
    """6i (b): ERNIE-base (vocab 40000, hidden 768, 12 layers, 12 heads,
    FFN 3072) at sequence 512, 8 rows of phase 8's batch (token types,
    padding mask whole on both ranks, MLM labels), float32, over {"sp":
    2}, SGD 0.1, 3 steps, at dropout 0 and 0.1, against one process."""
    from paddle_tpu_torch.models.bert import (bert_pretrain_loss_fn,
                                              ernie_base)

    batch = tuple(ernie_batch(40000, 8, 512, "cpu")[:4])

    def make(p):
        return ernie_base(device="cuda", dtype=torch.float32, seed=0,
                          dropout=p)

    res = _gathered_train(smi, mesh, make, bert_pretrain_loss_fn, batch,
                          (("dp", "sp"), ("dp", "sp"), "dp", ("dp", "sp")),
                          12, bert=True)
    log(f"[sp-ernie] ({SP_LABEL}; {smi}) " + json.dumps(res))
    return res


# 6i (c)'s depth, cut from 4 layers so that the whole script, 6j included,
# stays inside its time limit
GATHERED_GPT_LAYERS = 2


def _gathered_gpt(smi, mesh):
    """6i (c): gpt_1p3b's widths (vocab 50304, hidden 2048, 16 heads, FFN
    8192) at its 2048 context with attn_impl="flash", 2 layers
    (`GATHERED_GPT_LAYERS`), float32, 2 rows, over {"sp": 2}, SGD 0.1, 3
    steps, at dropout 0 and 0.1, against one process; each rank's 2
    forward and 2 backward launches a step cover its whole key prefix
    (rank 1: one call over 2048 keys)."""
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn

    def cfg(p):
        return GPTConfig(vocab_size=50304, hidden_size=2048,
                         num_layers=GATHERED_GPT_LAYERS,
                         num_heads=16, max_seq_len=2048,
                         intermediate_size=8192, attn_impl="flash",
                         dropout=p)

    batch = tuple(train_batch(cfg(0.0), 2, 2048, "cpu"))
    res = _gathered_train(
        smi, mesh, lambda p: GPT(cfg(p), device="cuda", dtype=torch.float32,
                                 seed=0),
        gpt_loss_fn, batch, (("dp", "sp"),) * 2, GATHERED_GPT_LAYERS,
        bert=False)
    log(f"[sp-gpt-flash] ({SP_LABEL}; {smi}) " + json.dumps(res))
    return res


def gathered_sequence_train(smi):
    """Phase 6i: sequence parallelism without a ring on the one card
    (ranks on cuda:0 over an explicit gloo backend, every collective
    staged through host memory): (a) the gathered attention's arithmetic
    per rank, (b) ERNIE-base over {"sp": 2}, (c) gpt_1p3b's widths with
    flash attention over {"sp": 2}. Run last."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[sp-gathered] phase 6i starts with "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated ({smi})")
    res = dict(label=SP_LABEL, card=smi, arithmetic=_gathered_arithmetic())
    t1 = time.perf_counter()
    # (b) and (c) share the two ranks; the card's free memory must come
    # back within 64 MiB once they are gone
    free0 = _card_free_bytes()
    mesh = _hybrid_mesh({"sp": 2})
    try:
        res["ernie"] = _gathered_ernie(smi, mesh)
        t2 = time.perf_counter()
        res["gpt_1p3b"] = _gathered_gpt(smi, mesh)
    finally:
        mesh.close()
    gc.collect()
    free1 = _card_free_bytes()
    res.update(card_free_gib_before=free0 / 2**30,
               card_free_gib_after=free1 / 2**30)
    assert (free1 - free0) / 2**20 >= -64, ("card memory not back", res)
    res["seconds"] = time.perf_counter() - t0
    res["part_seconds"] = {"a": t1 - t0, "b": t2 - t1,
                           "c": res["seconds"] - (t2 - t0)}
    log(f"[sp-gathered] phase 6i {res['seconds']:.1f} s")
    return res


# -- phase 6j -----------------------------------------------------------------

HYBRID_SP_LABEL = ("eager, gloo through the host, ranks sharing one card - "
                   "not an sp or mp speed")
# 6j (a)'s calls: name, (B, S, H, D), causal, padding mask, dropout ps; n = 2
# sp ranks by mp = 2 head groups
HYBRID_CASES = (
    ("gpt_1p3b", (1, 2048, 16, 128), True, False, (0.0, 0.1)),
    ("ernie_base", (32, 512, 12, 64), False, True, (0.1,)),
)
HYBRID_SP = HYBRID_MP = 2


def _hybrid_rank_arithmetic():
    """6j (a): every (mp, sp) rank's share of gathered attention at n = 2
    sp ranks by 2 head groups (`rank_forward`, `rank_backward` on the
    gathered [S, B, 2, H/2, D] layout of its heads, the partials written
    into such a buffer) in one process on cuda:0, at gpt_1p3b's attention
    shape (1 x 2048, 8 of 16 heads a rank, D 128, causal, dropout 0 and
    0.1) and ERNIE-base's (32 x 512, 6 of 12 heads, padding lengths
    256-512, dropout 0.1), f32 and bf16: each launch at ``head_offset``
    0 or H/2 and ``q_row0`` 0 or S/2 together. Each rank's O, LSE, dQ and
    dK / dV partials against the float32 plain version at its heads,
    rows, key prefix, mask and seed (`_rank_plain_err`) within 2e-5 (f32)
    or 2e-2 (bf16); at dropout 0.1 the plain keep bits at the rank's heads
    and rows equal the whole call's ``[rows, heads]`` slice bit for bit;
    one forward and one dK/dV + dQ launch a rank, no host sync. Every
    call's bound; rank (1, 1)'s kernel times beside SDPA's on the same call
    and the plain version's."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel.sequence_attention import (
        attended_keys, rank_backward, rank_forward, rank_mask)

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(24)
    out = []
    for name, (B, S, H, D), causal, with_mask, ps in HYBRID_CASES:
        L, Hr = S // HYBRID_SP, H // HYBRID_MP
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.randn((B, S, H, D), generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            mask = (padding_mask(padding_lengths(
                B, S, np.random.RandomState(0)), S, "cuda")
                if with_mask else None)
            # each mp rank's gathered K/V: its heads, sequence-major
            whole = []
            for m in range(HYBRID_MP):
                hs = slice(m * Hr, (m + 1) * Hr)
                w = torch.empty((S, B, 2, Hr, D), dtype=dtype, device="cuda")
                w[:, :, 0] = k[:, :, hs].transpose(0, 1)
                w[:, :, 1] = v[:, :, hs].transpose(0, 1)
                whole.append([w.permute(1, 0, 2, 3, 4)[:, :, j]
                              for j in (0, 1)])
            for p in ps:
                seed = DROPOUT_SEED if p else None
                whole_f = (fa.dropout_factors(seed, p, B, H, S, S, "cuda")
                           if p else None)
                ranks = []
                for m in range(HYBRID_MP):
                    hs = slice(m * Hr, (m + 1) * Hr)
                    heads = dict(head_offset=m * Hr, heads_total=H)
                    kw, vw = whole[m]
                    for r in range(HYBRID_SP):
                        rows = slice(r * L, (r + 1) * L)
                        qr, dor = q[:, rows, hs], do[:, rows, hs]
                        keys = attended_keys(r, L, S, causal)
                        parts = torch.zeros((S, B, 2, Hr, D), dtype=dtype,
                                            device="cuda")
                        views = [parts[:keys, :, j].transpose(0, 1)
                                 for j in (0, 1)]
                        or32 = (torch.empty((B, L, Hr, D), device="cuda")
                                if p else None)
                        _zero_flash_counts()
                        torch.cuda.set_sync_debug_mode("error")
                        try:
                            orr, lser = rank_forward(qr, kw, vw, r, causal,
                                                     mask, p, seed, **heads,
                                                     o32=or32)
                            o_bwd = orr if or32 is None else or32
                            dqr, _, _ = rank_backward(
                                qr, kw, vw, o_bwd, dor, lser, r, causal,
                                mask, p, seed, **heads, out=views)
                        finally:
                            torch.cuda.set_sync_debug_mode(0)
                        c = _read_flash_counts()
                        mr = rank_mask(mask, r, L, keys)
                        rec_r = dict(
                            mp_rank=m, sp_rank=r, q_row0=r * L, keys=keys,
                            **heads,
                            launches=[c["fwd_launches"], c["bwd_launches"]],
                            plain_err=_rank_plain_err(
                                qr, kw[:, :keys], vw[:, :keys], dor, mr, r,
                                causal, p, seed,
                                dict(o=orr, lse=lser, dq=dqr, dk=views[0],
                                     dv=views[1]), **heads),
                            keep_bits_equal=None if not p else bool(
                                torch.equal(fa.dropout_factors(
                                    seed, p, B, Hr, L, S, "cuda",
                                    q_row0=r * L, **heads),
                                    whole_f[:, hs, rows])),
                            **(_gathered_times(
                                qr, kw[:, :keys], vw[:, :keys], dor, lser,
                                o_bwd, r, causal, mr, p, seed, or32, views,
                                plain=True, **heads)
                               if (m, r) == (1, 1) else {}))
                        bounds = _rank_bounds(
                            B, L, keys, Hr, D, dtype, causal, r * L,
                            0 if mask is None else B * keys * 4)
                        rec_r.update({f"bound_{x}_ms": b[0]
                                      for x, b in bounds.items()})
                        rec_r.update({f"bound_{x}_by": b[1]
                                      for x, b in bounds.items()})
                        ranks.append(rec_r)
                rec = dict(case=name, dtype=str(dtype)[6:], sp=HYBRID_SP,
                           mp=HYBRID_MP, shape=[B, S, H, D], causal=causal,
                           mask=None if mask is None else list(mask.shape),
                           dropout_p=p,
                           plain_max_err={
                               x: max(rr["plain_err"][x] for rr in ranks)
                               for x in ranks[0]["plain_err"]},
                           plain_tol=GATHER_PLAIN_TOL[dtype], ranks=ranks)
                log("[sp-mp-arith] " + json.dumps(rec))
                out.append(rec)
                assert all(x["launches"] == [1, 1] for x in ranks), rec
                assert all(x["keep_bits_equal"] in (None, True)
                           for x in ranks), rec
                if max(rec["plain_max_err"].values()) > \
                        GATHER_PLAIN_TOL[dtype]:
                    raise SystemExit(
                        f"an sp x mp rank's launches miss "
                        f"{GATHER_PLAIN_TOL[dtype]} against the plain "
                        f"version: {rec}")
                del whole_f
            del q, k, v, do, whole
            torch.cuda.empty_cache()
    return out


def _hybrid_gpt(smi, mesh):
    """6j (b): gpt_1p3b's widths (vocab 50304, hidden 2048, 16 heads, FFN
    8192) at its 2048 context, 2 layers, 2 rows, float32, SGD 0.1, 3
    steps over {"sp": 2, "mp": 2} (four ranks: 8 heads and 1024 positions
    a rank) against the same model in one process: attn_impl="flash" at
    dropout 0.1, without and with the step's remat (the recomputed
    forward launches again), and "ring" at dropout 0 (the ring takes no
    attention dropout). `_gathered_train`'s gates on every rank."""
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn

    def cfg(impl="flash", p=0.0):
        return GPTConfig(vocab_size=50304, hidden_size=2048, num_layers=2,
                         num_heads=16, max_seq_len=2048,
                         intermediate_size=8192, attn_impl=impl, dropout=p)

    def make(impl):
        return lambda p: GPT(cfg(impl, p), device="cuda",
                             dtype=torch.float32, seed=0)

    batch = tuple(train_batch(cfg(), 2, 2048, "cpu"))
    specs = (("dp", "sp"),) * 2
    res = {"flash": _gathered_train(smi, mesh, make("flash"), gpt_loss_fn,
                                    batch, specs, 2, bert=False,
                                    drops=(0.1,), remats=(False, True)),
           "ring": _gathered_train(smi, mesh, make("ring"), gpt_loss_fn,
                                   batch, specs, 2, bert=False,
                                   drops=(0.0,), ring=True)}
    log(f"[sp-mp-gpt] ({HYBRID_SP_LABEL}; {smi}) " + json.dumps(res))
    return res


def _hybrid_ernie(smi, mesh, ref_mesh):
    """6j (c): ERNIE-base (vocab 40000, hidden 768, 12 layers, 12 heads, FFN
    3072) at 8 x 512 (phase 8's batch: token types, the padding mask, MLM
    labels), float32, dropout 0.1, over {"sharding": 2, "sp": 2} at ZeRO
    stage 2, the rows over dp and sharding (``(("dp", "sharding"),
    "sp")``, the mask ``("dp", "sharding")``), AdamW(1e-4, weight decay
    0.01), 3 steps. The reference is the same rows over `ref_mesh`
    ({"dp": 2}, the hybrid path: a pure-dp mesh slices no update, and the
    numbers are stage 2's): a row share's dropout masks key on its index
    (JAX folds the replica's index into the key), so no one process draws
    them, while the same two row shares without sp draw the same masks
    whole. `_gathered_train`'s gates (`_param_gate`
    with Adam's moments); each rank's optimizer bytes half of one
    process's within 1 % (the leaves too small to slice stay whole). The
    key bias (the middle third of each fused QKV bias: the columns are
    ``[3, heads, head_dim]``) has no gradient in exact arithmetic, since
    a query's scores all move by its q . b_k and the softmax takes none
    of it: its float-noise gradient is held apart, by its first moment
    in both runs (`NOISE_MOMENT_TOL`)."""
    from paddle_tpu_torch.models.bert import (bert_pretrain_loss_fn,
                                              ernie_base)
    from paddle_tpu_torch.optimizer import AdamW

    def adamw(model):
        return AdamW(learning_rate=1e-4, weight_decay=0.01,
                     parameters=model.named_parameters())

    rows = ("dp", "sharding")
    res = _gathered_train(
        smi, mesh, lambda p: ernie_base(device="cuda", dtype=torch.float32,
                                        seed=0, dropout=p),
        bert_pretrain_loss_fn, tuple(ernie_batch(40000, 8, 512, "cpu")[:4]),
        ((rows, "sp"), (rows, "sp"), rows, (rows, "sp")), 12, bert=True,
        drops=(0.1,), zero_stage=2, make_opt=adamw, ref_mesh=ref_mesh,
        noise=lambda name: (slice(768, 1536) if name.endswith(
            "attn.qkv.bias") else None))
    rec = res["runs"]["p0.1"]
    ratio = [b / rec["unsharded_opt_bytes"] for b in rec["opt_bytes"]]
    rec["opt_bytes_over_one_process"] = ratio
    log(f"[sp-zero-ernie] ({HYBRID_SP_LABEL}; {smi}) " + json.dumps(res))
    assert all(abs(x - 0.5) < 0.01 for x in ratio), ratio
    return res


def _localsgd_sp(smi, mesh, ref_mesh):
    """6j (d): LocalSGD (k 2, 4 steps, SGD 0.1) of the flagship widths at 2
    layers, float32, 4 x 1024, over {"dp": 2, "sp": 2} (each replica's
    sequence split over its sp ranks, the parameters averaged over dp)
    against the port's LocalSGD over {"dp": 2}: losses within 1e-5
    relative, every replica's parameters within 1e-5 of the reference's
    relative to their norm; each rank's launches (2 of each direction a
    step), phases, peak and seconds."""
    from paddle_tpu_torch.models.gpt import GPT, gpt_loss_fn
    from paddle_tpu_torch.parallel.spmd import LocalSGDTrainStep

    cfg = flagship_config(num_layers=2)
    batch = tuple(train_batch(cfg, 4, 1024, "cpu"))
    out = {}
    for key, m, specs in (("dp2", ref_mesh, None),
                          ("dp2sp2", mesh, (("dp", "sp"),) * 2)):
        model = GPT(cfg, device="cuda", dtype=torch.float32, seed=0)
        step = LocalSGDTrainStep(model, gpt_loss_fn, _sgd(model), m,
                                 k_steps=2, batch_specs=specs)
        try:
            losses, counts, wall, ranks = _dp_run(step, batch, 4, warmup=0)
            reps = step.replica_params()
        finally:
            step.close()
        out[key] = dict(losses=losses, counts=counts, step_s=wall,
                        rank_step_s=ranks, replicas=reps)
        del model, step
    want, got = out["dp2"], out["dp2sp2"]
    rel = max(float((got["replicas"][k] - w).norm()
                    / max(float(w.norm()), 1e-12))
              for k, w in want["replicas"].items())
    for rec in out.values():
        del rec["replicas"]
    res = dict(label=HYBRID_SP_LABEL, card=smi, k=2, runs=out,
               param_max_rel_norm_diff=rel)
    log(f"[sp-localsgd] ({HYBRID_SP_LABEL}; {smi}) " + json.dumps(res))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert rel < 1e-5, res
    for c in got["counts"]:
        assert (c["fwd_launches"], c["bwd_launches"]) == (8, 8), c
    return res


def _spawn_ranks(meshes):
    """Start every mesh's rank processes at once, each on a thread of its
    own (`spmd._ranks_of`: spawn, join the data plane, wait until ready),
    so that their start-ups overlap, and wait for all of them (raising
    the first failure). No kernel is timed meanwhile: a rank's CUDA
    context start would share the card with it."""
    import threading

    from paddle_tpu_torch.parallel import spmd

    errors = []

    def start(mesh):
        try:
            spmd._ranks_of(mesh)
        except BaseException as e:          # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=start, args=(m,)) for m in meshes]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def hybrid_sequence_train(smi):
    """Phase 6j: sequence parallelism beside tensor parallelism and ZeRO on
    the one card (ranks on cuda:0 over an explicit gloo backend, every
    collective staged through host memory): (a) every (mp, sp) rank's
    flash launches, (b) gpt_1p3b's widths over {"sp": 2, "mp": 2}, (c)
    ERNIE-base over {"sharding": 2, "sp": 2} at stage 2, (d) LocalSGD
    over {"dp": 2, "sp": 2}; (c) and (d) against the same rows over one
    {"dp": 2} mesh. Every mesh's ranks start together after (a) and
    before (b), so that no step is timed while a rank starts. Run last;
    the card's free memory is back within 64 MiB once the ranks are
    gone."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    log(f"[sp-mp] phase 6j starts with "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated ({smi})")
    meshes = {k: _hybrid_mesh(d) for k, d in (
        ("gpt_1p3b", {"sp": 2, "mp": 2}), ("ernie", {"sharding": 2, "sp": 2}),
        ("localsgd", {"dp": 2, "sp": 2}), ("ref", {"dp": 2}))}
    res = dict(label=HYBRID_SP_LABEL, card=smi)
    marks = [t0]
    try:
        res["arithmetic"] = _hybrid_rank_arithmetic()
        marks.append(time.perf_counter())
        # after (a): this process's first launches grow its own context
        free0 = _card_free_bytes()
        _spawn_ranks(list(meshes.values()))
        marks.append(time.perf_counter())
        for key, run in (("gpt_1p3b", _hybrid_gpt), ("ernie", _hybrid_ernie),
                         ("localsgd", _localsgd_sp)):
            if key == "gpt_1p3b":
                res[key] = run(smi, meshes[key])
            else:
                res[key] = run(smi, meshes[key], meshes["ref"])
            meshes.pop(key).close()
            marks.append(time.perf_counter())
            log(f"[sp-mp] 6j ({key}) {marks[-1] - marks[-2]:.1f} s")
    finally:
        for m in meshes.values():
            m.close()
    free1 = _card_free_bytes()
    res.update(card_free_gib_before=free0 / 2**30,
               card_free_gib_after=free1 / 2**30)
    assert (free1 - free0) / 2**20 >= -64, ("card memory not back", res)
    res["seconds"] = time.perf_counter() - t0
    res["part_seconds"] = dict(zip(("a", "ranks", "b", "c", "d"),
                                   np.diff(marks).tolist()))
    log(f"[sp-mp] phase 6j {res['seconds']:.1f} s {res['part_seconds']}")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
    ap.add_argument("--only", choices=("6g", "6h", "6i", "6j"),
                    help="build the kernels and run this phase alone (its "
                         "results, the card line and the device line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[env] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    build_kernels()
    if args.only:
        name, phase = {"6g": ("sequence", sequence_train),
                       "6h": ("moe", moe_train),
                       "6i": ("gathered", gathered_sequence_train),
                       "6j": ("hybrid_sp", hybrid_sequence_train)}[
                           args.only]
        res = {name: phase(smi)}
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(card=smi, kind=kind, **res), f, indent=1)
        print(json.dumps(res))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    cases = kernel_cases()
    appends = append_cases()
    model = serving_model()
    served, graph_outs = serve(model)
    served_int8, graph_outs_int8 = serve(model, "int8")
    overcap = overcap_pair(model)
    graph_eager = [eager_tokens(model, graph_outs),
                   eager_tokens(model, graph_outs_int8, "int8")]
    http = front_door(model, served)
    feature = feature_waves(model, served, graph_outs)
    fleet_res = fleet(model, graph_outs, smi)
    tp_res = tp_serving(model, graph_outs_int8, smi)
    del model
    tp_fleet_res = tp_fleet(smi)
    torch.cuda.empty_cache()
    par = parity()
    par_int8 = parity_int8()
    flash = flash_cases()
    variants = variant_cases()
    trained = train(smi)
    tpar = train_parity()
    ernie = ernie_pretrain(smi)
    gpt_drop = gpt_dropout_train()
    epar = ernie_parity()
    surface = training_surface(smi, trained, ernie)
    zero = zero_dp(smi)
    hybrid = hybrid_train(smi)
    pipeline = pipeline_train(smi)
    sequence = sequence_train(smi)
    moe = moe_train(smi)
    gathered = gathered_sequence_train(smi)
    hybrid_sp = hybrid_sequence_train(smi)
    # the kernel line's headline numbers: the bf16 decode case (width 1),
    # the launch shape the serving path runs most, and the bf16 flash case
    # at the training shape
    rpa = []
    for arena, launches in (("float", served["launches"]),
                            ("int8", served_int8["int8_launches"])):
        mine = [r for r in cases if r["arena"] == arena]
        head = next(r for r in mine if r["dtype"] == "bfloat16"
                    and r["width"] == 1 and r["heads"] == H)
        wide = next(r for r in mine if r["dtype"] == "bfloat16"
                    and r["width"] == 128 and r["heads"] == H)
        # a tp=2 rank's share (8 heads), the launch shape of phase 3h
        tp_head = next(r for r in mine if r["dtype"] == "bfloat16"
                       and r["width"] == 1 and r["heads"] == H // 2)
        rpa.append({
            "name": "ragged_paged_attention"
                    + ("_int8" if arena == "int8" else ""),
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/paged_attention.py:108",
            "launches": launches,
            # the HTTP front door's concurrent wave (phase 3e) and the
            # fleet's waves (phase 3g) launch the float arena's kernels
            # too, and phase 3f's waves both
            **({"front_door_launches": http["launches"],
                "fleet_launches": fleet_res["fleet"]["launches"]}
               if arena == "float" else {}),
            "phase3f_launches": feature["launches"][
                "ragged_int8" if arena == "int8" else "ragged"],
            # phase 3h: each tp=2 rank's launches at its 8 heads (f32 on
            # the float arena, bf16 on the int8 one), and the 8-head case
            "tp2_rank_launches": [
                c["ragged_int8" if arena == "int8" else "ragged"]
                for c in tp_res["int8_q" if arena == "int8"
                                else "f32"]["counts"]],
            "tp2_shard_case": {k: tp_head[k] for k in (
                "heads", "width", "max_err", "kernel_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")},
            # phase 3i: every rank of the two tp replicas behind the
            # router (f32, float arena)
            **({"tp_fleet_rank_launches": [
                c["ragged"] for rep_counts in tp_fleet_res["counts"]
                for c in rep_counts]} if arena == "float" else {}),
            "max_abs_err": max(r["max_err"] for r in mine
                               if r["dtype"] == "bfloat16"),
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "design": head["design"],
            # ptxas on the split-row kernel (the decode case's), and on the
            # wide-row kernel the width-128 case adds
            "registers": head["ptxas"]["split"]["registers"],
            "spill_bytes": head["ptxas"]["split"]["spill_bytes"],
            "wide_registers": wide["ptxas"]["wide"]["registers"],
            "wide_spill_bytes": wide["ptxas"]["wide"]["spill_bytes"],
            "cases": mine,
        })
    # the int8 append at the decode width (bf16 K/V, as the int8 wave
    # appends them); every case in "cases"
    head = next(r for r in appends if r["dtype"] == "bfloat16"
                and r["width"] == 1)
    rpa.append({
        "name": "kv_quantize_scatter", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/kv_quantize_scatter.cu",
        "replaces": "paddle_tpu/serving/block_pool.py:185",
        "launches": served_int8["append_launches"],
        "phase3f_launches": feature["launches"]["append"],
        "tp2_rank_launches": [c["append"]
                              for c in tp_res["int8_q"]["counts"]],
        "max_abs_err": max(r["max_err"] for r in appends),
        "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None, "cases": appends,
    })
    fl = flash[0]
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    tpu = "paddle_tpu/ops/pallas/flash_attention.py"
    # the bf16 designs, and ptxas's report on the instantiation each row
    # times (head_dim, mask kind 0 none / 1 key-only, dropout)
    design = {
        "fwd": "sm90 wgmma+tma, 128x128 tiles, 2 consumer warpgroups "
               "(ping-pong) + 1 TMA producer",
        "dkv": "sm90 wgmma+tma, 128 keys x 64-query ring, 2 consumer "
               "warpgroups + 1 TMA producer",
        "dq": "sm90 wgmma+tma, 128 queries x 64-key ring, 2 consumer "
              "warpgroups (ping-pong) + 1 TMA producer"}

    def report(kname, d, mask_kind, drop):
        entry = f"flash_{kname}_sm90ILi{d}ELi{mask_kind}ELb{int(drop)}E"
        regs, spill = ptxas_report("flash_attention.cu", entry)
        # the dQ kernel's consumers hold S, dP, dS and the dQ accumulator
        # in registers: a spill on the main path's instantiations fails
        if kname == "dq" and spill:
            raise SystemExit(f"ptxas: {entry} spills {spill} bytes")
        return {"design": design[kname], "registers": regs,
                "spill_bytes": spill}

    def dp2(counts, key):
        # phase 6d: each dp=2 rank's launches over its counted steps
        return [c[key] for c in counts]

    zf, ze = zero["flagship"], zero["ernie"]
    hf = hybrid["flagship"]
    he = hybrid["parity"]["ernie_mask_dropout"]["mp2"]

    def mp2_case(name):
        # phase 5b's case at an mp=2 rank's shape and head offset
        c = next(r for r in variants if r["case"] == name)
        return {k: c[k] for k in (
            "shape", "head_offset", "heads_total", "dropout_p",
            "whole_call_o_err", "max_err", "fwd_ms", "dkv_ms", "dq_ms",
            "plain_fwd_ms", "plain_bwd_ms", "library_fwd_ms",
            "library_bwd_ms", "bound_fwd_ms", "bound_fwd_by",
            "bound_dkv_ms", "bound_dkv_by", "bound_dq_ms", "bound_dq_by")}
    kernels = rpa + [{
        "name": "flash_attention_fwd", "route": "cuda", "source": src,
        "replaces": f"{tpu}:121", "launches": trained["fwd_launches"],
        "max_abs_err": max(fl["max_err"]["o"], fl["max_err"]["lse"]),
        "ms": fl["fwd_ms"], "plain_ms": fl["plain_fwd_ms"],
        "bound_ms": fl["bound_fwd_ms"], "bound_by": fl["bound_fwd_by"],
        "library_ms": fl["library_fwd_ms"], **report("fwd", 128, 0, False),
        # phase 6c's remat + O2 run: each block's forward runs twice
        "remat_launches": surface["remat"]["fwd_launches"],
        # AdaRound's calibration forwards (phase 3f) at S 24
        "calibration_launches": feature["launches"]["flash_fwd"],
        "dp2_rank_launches": {k: dp2(zf[k]["counts"], "fwd_launches")
                              for k in ("stage2", "stage3", "stage2_int8")},
        # phase 6e (b): each mp=2 rank's launches at its 4 heads, and the
        # kernels at that shape (5b)
        "mp2_rank_launches": dp2(hf["counts"], "fwd_launches"),
        "mp2_shard_case": mp2_case("flagship_mp2_rank"),
        "calibration_case": feature["adaround"]["flash_s24"],
        "cases": flash,
    }, {
        # one counted backward launch runs dK/dV then dQ; plain_ms is the
        # plain version's whole backward (autograd computes the three
        # gradients together); no one library call computes dK/dV alone
        "name": "flash_attention_dkv", "route": "cuda", "source": src,
        "replaces": f"{tpu}:238", "launches": trained["bwd_launches"],
        "remat_launches": surface["remat"]["bwd_launches"],
        "dp2_rank_launches": {k: dp2(zf[k]["counts"], "bwd_launches")
                              for k in ("stage2", "stage3", "stage2_int8")},
        "mp2_rank_launches": dp2(hf["counts"], "bwd_launches"),
        "mp2_shard_case": mp2_case("flagship_mp2_rank"),
        "max_abs_err": max(fl["max_err"]["dk"], fl["max_err"]["dv"]),
        "ms": fl["dkv_ms"], "plain_ms": fl["plain_bwd_ms"],
        "bound_ms": fl["bound_dkv_ms"], "bound_by": fl["bound_dkv_by"],
        "library_ms": None, **report("dkv", 128, 0, False),
    }, {
        "name": "flash_attention_dq", "route": "cuda", "source": src,
        "replaces": f"{tpu}:295", "launches": trained["bwd_launches"],
        "remat_launches": surface["remat"]["bwd_launches"],
        "dp2_rank_launches": {k: dp2(zf[k]["counts"], "bwd_launches")
                              for k in ("stage2", "stage3", "stage2_int8")},
        "mp2_rank_launches": dp2(hf["counts"], "bwd_launches"),
        "mp2_shard_case": mp2_case("flagship_mp2_rank"),
        "max_abs_err": fl["max_err"]["dq"],
        "ms": fl["dq_ms"], "plain_ms": fl["plain_bwd_ms"],
        "bound_ms": fl["bound_dq_ms"], "bound_by": fl["bound_dq_by"],
        "library_ms": None, **report("dq", 128, 0, False),
    }]
    # the ERNIE step's launch shape: mask + dropout, B 32, S 512, H 12, D 64
    ev = next(r for r in variants if r["case"] == "ernie_mask_dropout")
    er = surface["ernie_remat"]
    for kname, site, key, errs, launches, remat_launches, lib in (
            ("fwd", 143, "fwd", ("o", "lse"), ernie["fwd_mask_launches"],
             er["fwd_mask_launches"], ev["library_fwd_ms"]),
            ("dkv", 263, "dkv", ("dk", "dv"), ernie["bwd_mask_launches"],
             er["bwd_mask_launches"], None),
            ("dq", 319, "dq", ("dq",), ernie["bwd_mask_launches"],
             er["bwd_mask_launches"], None)):
        kernels.append({
            "name": f"flash_attention_{kname}_mask_dropout", "route": "cuda",
            "source": src, "replaces": f"{tpu}:{site}",
            "launches": launches, "remat_launches": remat_launches,
            "dp2_rank_launches": dp2(ze["counts"], "fwd_mask_launches"
                                     if kname == "fwd" else
                                     "bwd_mask_launches"),
            # phase 6e (a): each mp=2 rank's ERNIE launches at 6 of 12
            # heads, and the kernels at the ERNIE step's rank shape (5b)
            "mp2_rank_launches": dp2(he["counts"], "fwd_mask_launches"
                                     if kname == "fwd" else
                                     "bwd_mask_launches"),
            "mp2_shard_case": mp2_case("ernie_mp2_rank_mask_dropout"),
            # phase 6h (d): one fused_multi_head_attention call at ERNIE's
            # shape with dropout 0.1 (bf16)
            "fused_mha_launches": moe["fused_mha"]["bfloat16_p0.1"][
                "fwd_mask_launches" if kname == "fwd"
                else "bwd_mask_launches"],
            "max_abs_err": max(ev["max_err"][e] for e in errs),
            "ms": ev[f"{key}_ms"],
            "plain_ms": ev["plain_fwd_ms" if key == "fwd"
                           else "plain_bwd_ms"],
            "bound_ms": ev[f"bound_{key}_ms"],
            "bound_by": ev[f"bound_{key}_by"], "library_ms": lib,
            **report(kname, ev["shape"][3], 1, True),
            **({"cases": variants} if key == "fwd" else {}),
        })
    # phase 6f (b): each pp2 x mp2 rank's launches over the counted steps
    # of the pipelined gpt_1p3b, at the stage's shape (5b's cases)
    pr = pipeline["gpt_1p3b"]["ranks"]
    for kname, site, key, errs in (("fwd", 121, "fwd", ("o", "lse")),
                                   ("dkv", 238, "dkv", ("dk", "dv")),
                                   ("dq", 295, "dq", ("dq",))):
        cases = [r for r in variants if r["case"].startswith("pp_stage")]
        head = cases[0]
        lk = "fwd_launches" if kname == "fwd" else "bwd_launches"
        kernels.append({
            "name": f"flash_attention_{kname}_pp_stage", "route": "cuda",
            "source": src, "replaces": f"{tpu}:{site}",
            "launches": pr[0]["fwd_launches" if kname == "fwd"
                              else "bwd_launches"],
            "pp_rank_launches": [r["fwd_launches" if kname == "fwd"
                                   else "bwd_launches"] for r in pr],
            "shape": head["shape"], "dtype": head["dtype"],
            "heads": [[c["head_offset"], c["head_offset"] + c["shape"][2]]
                      for c in cases], "heads_total": head["heads_total"],
            "max_abs_err": max(c["max_err"][e] for c in cases for e in errs),
            "tol": head["tol"],
            "ms": head[f"{key}_ms"], "kernel_ms": head[f"{key}_ms"],
            "kernel_ms_heads8": cases[1][f"{key}_ms"],
            "plain_ms": head["plain_fwd_ms" if key == "fwd"
                             else "plain_bwd_ms"],
            "bound_ms": head[f"bound_{key}_ms"],
            "bound_by": head[f"bound_{key}_by"],
            # the bound is 3xTF32's; the FMA units' beside it
            "bound_fma_ms": head[f"bound_{key}_fma_ms"],
            "bound_fma_by": head[f"bound_{key}_fma_by"],
            **flash[1]["ptxas"][f"{kname}_128"],
            "design": flash[1]["design"][kname],
            "library_ms": head["library_fwd_ms"] if key == "fwd" else None,
            "library_bwd_ms": head["library_bwd_ms"],
            # phase 6g: each rank's launches over the counted steps of
            # gpt_1p3b's widths at 4 layers over {"sp": 2} (f32, 2 x 1024
            # a rank, 16 heads; i + 1 blocks a layer on sp rank i) and of
            # the flagship
            # widths over {"dp": 2, "sp": 2}; the ring's f32 error
            # against one call over the whole sequence (6g (a))
            "sp2_rank_launches": [
                c[lk] for c in sequence["gpt_1p3b"]["runs"]["p0.0"][
                    "counts"]],
            "dp2sp2_rank_launches": [
                c[lk] for c in sequence["dp2sp2"]["runs"]["p0.0"][
                    "counts"]],
            "ring_f32_max_abs_err": max(
                r["max_err"][e] for r in sequence["ring"]
                if r["dtype"] == "float32"
                for e in (("o",) if key == "fwd" else errs)),
        })
    # phase 6i (a): each kernel at a sequence-parallel rank's call (the
    # gathered K/V, the rank's query rows from q_row0): the headline is
    # gpt_1p3b sp2 rank 1 in float32 (1 x 1024 against 2048 keys, causal),
    # ERNIE-base sp2 rank 1 beside it (32 x 256 against 512, padding mask,
    # dropout 0.1); launches are 6i (b)'s and (c)'s, a step on each rank
    ga = gathered["arithmetic"]

    def headline(case, dtype, p):
        rec = next(r for r in ga if r["case"] == case and r["dtype"] == dtype
                   and r["dropout_p"] == p and r["n"] == GATHER_TIMED)
        return rec["ranks"][1]

    gh = headline("gpt_1p3b", "float32", 0.0)
    for kname, site, errs in (("fwd", 121, ("o",)),
                              ("dkv", 238, ("dk", "dv")),
                              ("dq", 295, ("dq",))):
        lk = "fwd_launches" if kname == "fwd" else "bwd_launches"
        perrs = errs + ("lse",) if kname == "fwd" else errs
        kernels.append({
            "name": f"flash_attention_{kname}_sp_gathered", "route": "cuda",
            "source": src, "replaces": f"{tpu}:{site}",
            "launches": gathered["ernie"]["runs"]["p0.1"]["counts"][0][lk],
            "sp2_rank_launches": {
                f"{model}_p{p}": [c[lk] for c in gathered[model]["runs"][
                    f"p{p}"]["counts"]]
                for model in ("ernie", "gpt_1p3b") for p in (0.0, 0.1)},
            # every rank's launches against the f32 plain version
            "max_abs_err": max(r["plain_max_err"][e] for r in ga
                               if r["dtype"] == "float32" for e in perrs),
            "bf16_max_abs_err": max(r["plain_max_err"][e] for r in ga
                                    if r["dtype"] == "bfloat16"
                                    for e in perrs),
            # the ranks joined against one whole-sequence flash call
            "whole_call_max_abs_err": max(
                r["max_err"][e] for r in ga
                if r["dtype"] == "float32" for e in errs),
            "bf16_whole_call_max_err_beyond_ulp": max(
                r["max_err_beyond_ulp"][e] for r in ga
                if r["dtype"] == "bfloat16" for e in errs),
            "ms": gh[f"{kname}_ms"],
            "plain_ms": gh["plain_fwd_ms" if kname == "fwd"
                           else "plain_bwd_ms"],
            "bound_ms": gh[f"bound_{kname}_ms"],
            "bound_by": gh[f"bound_{kname}_by"],
            "library_ms": gh["library_fwd_ms"] if kname == "fwd" else None,
            "library_bwd_ms": gh["library_bwd_ms"],
            "headline": "gpt_1p3b sp2 rank 1, float32, 1 x 1024 queries "
                        "from row 1024 against 2048 keys, causal",
            "rank_cases": {
                f"{case}_{dtype}_p{p}": {
                    k: headline(case, dtype, p)[k] for k in (
                        f"{kname}_ms", f"bound_{kname}_ms",
                        f"bound_{kname}_by", "library_fwd_ms",
                        "library_bwd_ms")}
                for case, p in (("gpt_1p3b", 0.0), ("gpt_1p3b", 0.1),
                                ("ernie_base", 0.1))
                for dtype in ("float32", "bfloat16")},
        })
    # phase 6j (a): each kernel at an sp x mp rank's call (its heads from
    # head_offset, its rows from q_row0, over its gathered key prefix): the
    # headline is gpt_1p3b's rank (mp 1, sp 1) in float32 at dropout 0.1
    # (1 x 1024 queries from row 1024, heads 8-15 of 16, against 2048
    # keys, causal); launches are 6j (b)'s flash run's, a step on each rank
    ja = hybrid_sp["arithmetic"]

    def jhead(case, dtype, p):
        rec = next(r for r in ja if r["case"] == case
                   and r["dtype"] == dtype and r["dropout_p"] == p)
        return next(r for r in rec["ranks"]
                    if (r["mp_rank"], r["sp_rank"]) == (1, 1))

    jg = jhead("gpt_1p3b", "float32", 0.1)
    hg = hybrid_sp["gpt_1p3b"]
    for kname, site, errs in (("fwd", 121, ("o", "lse")),
                              ("dkv", 238, ("dk", "dv")),
                              ("dq", 295, ("dq",))):
        lk = "fwd_launches" if kname == "fwd" else "bwd_launches"
        mk = lk.replace("launches", "mask_launches")
        kernels.append({
            "name": f"flash_attention_{kname}_sp_mp", "route": "cuda",
            "source": src, "replaces": f"{tpu}:{site}",
            "launches": hg["flash"]["runs"]["p0.1"]["counts"][0][lk],
            # 6j (b): every rank's launches over the 3 counted steps of
            # each run; (c) ERNIE's mask launches; (d) LocalSGD's
            "sp2mp2_rank_launches": {
                f"{impl}_{run}": [c[lk] for c in rec["counts"]]
                for impl in ("flash", "ring")
                for run, rec in hg[impl]["runs"].items()},
            "sharding2sp2_rank_mask_launches": [
                c[mk] for c in hybrid_sp["ernie"]["runs"]["p0.1"]["counts"]],
            "localsgd_dp2sp2_rank_launches": [
                c[lk] for c in hybrid_sp["localsgd"]["runs"]["dp2sp2"][
                    "counts"]],
            "max_abs_err": max(r["plain_max_err"][e] for r in ja
                               if r["dtype"] == "float32" for e in errs),
            "bf16_max_abs_err": max(r["plain_max_err"][e] for r in ja
                                    if r["dtype"] == "bfloat16"
                                    for e in errs),
            "ms": jg[f"{kname}_ms"],
            "plain_ms": jg["plain_fwd_ms" if kname == "fwd"
                           else "plain_bwd_ms"],
            "bound_ms": jg[f"bound_{kname}_ms"],
            "bound_by": jg[f"bound_{kname}_by"],
            "library_ms": jg["library_fwd_ms"] if kname == "fwd" else None,
            "library_bwd_ms": jg["library_bwd_ms"],
            "headline": "gpt_1p3b sp2 x mp2 rank (1, 1), float32, dropout "
                        "0.1, 1 x 1024 queries from row 1024, heads 8-15 "
                        "of 16, against 2048 keys, causal",
            "rank_cases": {
                f"{case}_{dtype}_p{p}": {
                    k: jhead(case, dtype, p)[k] for k in (
                        f"{kname}_ms", f"bound_{kname}_ms",
                        f"bound_{kname}_by", "library_fwd_ms",
                        "library_bwd_ms")}
                for case, p in (("gpt_1p3b", 0.0), ("gpt_1p3b", 0.1),
                                ("ernie_base", 0.1))
                for dtype in ("float32", "bfloat16")},
        })
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, kind=kind, kernels=kernels,
                           appends=appends, graph_vs_eager=graph_eager,
                           serve=served, serve_int8=served_int8,
                           front_door=http, phase3f=feature,
                           fleet=fleet_res, tp=tp_res, tp_fleet=tp_fleet_res,
                           overcap=overcap, parity=par, parity_int8=par_int8,
                           train=trained, train_parity=tpar, ernie=ernie,
                           train_dropout=gpt_drop, ernie_parity=epar,
                           training_surface=surface, zero_dp=zero,
                           hybrid=hybrid, pipeline=pipeline,
                           sequence=sequence, moe=moe, gathered=gathered,
                           hybrid_sp=hybrid_sp),
                      f,
                      indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
