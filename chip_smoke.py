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
   SIMT design).
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
4. float32 parity: gpt_1p3b widths at 4 layers, greedy LLMEngine (the
   kernel, through captured graphs) against GPT.generate (contiguous
   cache, no kernel).
   4b. The int8 engine on the card against the int8 engine on a CPU copy
   (the plain version): at least 90 % of the greedy tokens equal.
5. The flash-attention kernels (forward; dK/dV and dQ) against the plain
   version (`attention_ref` in float32 on the same values, and autograd's
   gradients) at the training shape (B 16, H 8, S 1024, D 128, causal) in
   bfloat16 (tolerance 2e-2) and in float32 at B 2 (TF32 off, 1e-3),
   comparing O, LSE, dQ, dK and dV; with the kernels', the plain
   version's and scaled_dot_product_attention's device times beside the
   least time the card could take.
   5b. The flash kernels' additive-mask and dropout variants against the
   plain version on the same values, mask and seed (the same Philox keep
   bits), q/k/v being strided views of a fused projection as in the
   models: the ERNIE step's shape (B 32, S 512, H 12, D 64, non-causal,
   [B, 1, 1, S] padding mask, p 0.1) in bfloat16 with mask and dropout,
   mask alone, dropout alone and neither; causal dropout at the flagship
   shape; float32 mask + dropout at B 2 (TF32 off). Times beside SDPA
   with the same mask and dropout_p and the least time the card could
   take.
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

Prints a `{"kernels": [...]}` line (the flash rows also name the bf16
kernel's design and ptxas's registers and spill bytes for it; a spill in
either dQ row's instantiation fails the run), the
nvidia-smi name/power-limit line, and last `{"ok": true, "device":
{...}}`.
"""
import argparse
import asyncio
import json
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
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters):
    """Device time of one `fn` call: `iters` calls captured in a CUDA
    graph, the graph replayed between two CUDA events. Host launch cost
    stays out (an eager call of a small kernel waits on its Python
    wrapper, not on the card)."""
    fn()
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


def _case(width, gen, n_blocks, dtype, dev):
    """A mixed batch at step width `width`: decode rows, a prefill chunk
    crossing block boundaries, partly filled last blocks, an idle lane
    (null block only), null-block table padding. Contexts 64-1000 tokens
    like the serving phase's prompts."""
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
    q = torch.randn((B, width, H, D), generator=gen, device=dev).to(dtype)
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
    # the serving arena's shape, random garbage in every slot
    shape = (n_layers, H, n_blocks, BS, D)
    out = []
    for arena, dtype in (("float", torch.float32), ("float", torch.bfloat16),
                         ("int8", torch.float32), ("int8", torch.bfloat16)):
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
            c = _case(width, gen, n_blocks, dtype, dev)
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
                       width=width, design=RPA_DESIGNS[design],
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
    product: they add nothing to the bound."""
    isz = torch.tensor([], dtype=dtype).element_size()
    # visible (query, key) pairs
    pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * S
    t = B * S * H * D * isz                   # one [B, S, H, D] tensor
    rows = B * H * S * 4                      # one f32 LSE or delta
    work = {"fwd": (2, 4 * t + rows), "dkv": (4, 6 * t + 2 * rows),
            "dq": (3, 5 * t + 2 * rows), "bwd": (5, 8 * t + rows)}
    out = {}
    for name, (products, nbytes) in work.items():
        t_ops = products * 2 * D * pairs / PEAK_FLOPS[dtype]
        t_bytes = (nbytes + mask_bytes) / HBM_BYTES_PER_S
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def _flash_case(dtype, gen):
    from paddle_tpu_torch.ops import flash_attention as fa

    B, S, H, D = FLASH_SHAPES[dtype]
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, do, lse, True)
    # the plain version in float32 on the same values
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
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
    ql, kl, vl = (t.transpose(1, 2).contiguous().requires_grad_()
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
        library_fwd_bwd_ms=event_ms(library_fwd_bwd, 10))
    times["library_bwd_ms"] = (times["library_fwd_bwd_ms"]
                               - times["library_fwd_ms"])
    bounds = _flash_bounds(B, S, H, D, dtype)
    rec = dict(dtype=str(dtype).replace("torch.", ""), shape=[B, S, H, D],
               causal=True, max_err=err, tol=TOL[dtype], **times,
               **{f"bound_{n}_ms": b[0] for n, b in bounds.items()},
               **{f"bound_{n}_by": b[1] for n, b in bounds.items()})
    log("[flash] " + json.dumps(rec))
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


def _variant_case(name, dtype, shape, causal, with_mask, p, gen):
    """Phase 5b: the three kernels with the additive mask and/or dropout
    against the plain version in float32 on the same values, mask and
    seed (so the same Philox bits: exact up to rounding), with the
    kernels', the plain version's and SDPA's times (the same mask and
    dropout_p) beside the least time the card could take. q, k and v are
    the strided views of a fused projection (`_qkv_views`)."""
    from paddle_tpu_torch.ops import flash_attention as fa

    B, S, H, D = shape
    q, k, v = _qkv_views(shape, dtype, causal, gen)
    do = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
    mask = (padding_mask(padding_lengths(B, S, np.random.RandomState(0)),
                         S, "cuda") if with_mask else None)
    seed = DROPOUT_SEED if p > 0 else None
    var = (causal, mask, p, seed)
    # with dropout the forward also writes O in f32 for the backward's
    # delta, as FlashAttention does
    o_f32 = torch.empty(q.shape, device="cuda") if p > 0 else None
    o, lse = fa.flash_attention_fwd(q, k, v, *var, o_f32)
    o_bwd = o if o_f32 is None else o_f32
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o_bwd, do, lse, *var)
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
    o32 = fa.attention_ref(q32, k32, v32, *var)
    o32.backward(do.float())
    lse32 = fa.attention_lse_ref(q32.detach(), k32.detach(), causal, mask)
    torch.cuda.synchronize()
    err = {n: (a.float() - b).abs().max().item() for n, a, b in (
        ("o", o, o32), ("lse", lse, lse32), ("dq", dq, q32.grad),
        ("dk", dk, k32.grad), ("dv", dv, v32.grad))}
    del o32, q32, k32, v32, lse32
    delta = fa._delta(o_bwd, do)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    og = fa.attention_ref(qg, kg, vg, *var)

    def plain_bwd():
        torch.autograd.grad(og, (qg, kg, vg), do, retain_graph=True)

    F = torch.nn.functional
    ql, kl, vl = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dol = do.transpose(1, 2).contiguous()
    lib_kw = dict(attn_mask=None if mask is None else mask.to(dtype),
                  dropout_p=p, is_causal=causal)

    def library_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(
            ql, kl, vl, **lib_kw), (ql, kl, vl), dol)

    times = dict(
        fwd_ms=time_ms(lambda: fa.flash_attention_fwd(q, k, v, *var, o_f32),
                       20),
        dkv_ms=time_ms(lambda: fa._launch_bwd(q, k, v, do, lse, delta,
                                              causal, 1, *var[1:]), 10),
        dq_ms=time_ms(lambda: fa._launch_bwd(q, k, v, do, lse, delta,
                                             causal, 2, *var[1:]), 10),
        plain_fwd_ms=event_ms(lambda: fa.attention_ref(q, k, v, *var), 3),
        plain_bwd_ms=event_ms(plain_bwd, 3),
        library_fwd_ms=event_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, **lib_kw), 10),
        library_fwd_bwd_ms=event_ms(library_fwd_bwd, 10))
    times["bwd_ms"] = times["dkv_ms"] + times["dq_ms"]
    times["library_bwd_ms"] = (times["library_fwd_bwd_ms"]
                               - times["library_fwd_ms"])
    bounds = _flash_bounds(B, S, H, D, dtype, causal,
                           0 if mask is None else mask.numel() * 4)
    rec = dict(case=name, dtype=str(dtype).replace("torch.", ""),
               shape=[B, S, H, D], causal=causal,
               mask=None if mask is None else list(mask.shape),
               dropout_p=p, max_err=err, tol=TOL[dtype], **times,
               **{f"bound_{n}_ms": b[0] for n, b in bounds.items()},
               **{f"bound_{n}_by": b[1] for n, b in bounds.items()})
    log("[flash-variant] " + json.dumps(rec))
    if max(err.values()) > TOL[dtype]:
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
        out.append(_variant_case(*case, gen))
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every result to this JSON file")
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
    del model
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
    # the kernel line's headline numbers: the bf16 decode case (width 1),
    # the launch shape the serving path runs most, and the bf16 flash case
    # at the training shape
    rpa = []
    for arena, launches in (("float", served["launches"]),
                            ("int8", served_int8["int8_launches"])):
        mine = [r for r in cases if r["arena"] == arena]
        head = next(r for r in mine if r["dtype"] == "bfloat16"
                    and r["width"] == 1)
        wide = next(r for r in mine if r["dtype"] == "bfloat16"
                    and r["width"] == 128)
        rpa.append({
            "name": "ragged_paged_attention"
                    + ("_int8" if arena == "int8" else ""),
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/paged_attention.py:108",
            "launches": launches,
            # the HTTP front door's concurrent wave (phase 3e) launches
            # the float arena's kernels too, and phase 3f's waves both
            **({"front_door_launches": http["launches"]}
               if arena == "float" else {}),
            "phase3f_launches": feature["launches"][
                "ragged_int8" if arena == "int8" else "ragged"],
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
        "calibration_case": feature["adaround"]["flash_s24"],
        "cases": flash,
    }, {
        # one counted backward launch runs dK/dV then dQ; plain_ms is the
        # plain version's whole backward (autograd computes the three
        # gradients together); no one library call computes dK/dV alone
        "name": "flash_attention_dkv", "route": "cuda", "source": src,
        "replaces": f"{tpu}:238", "launches": trained["bwd_launches"],
        "remat_launches": surface["remat"]["bwd_launches"],
        "max_abs_err": max(fl["max_err"]["dk"], fl["max_err"]["dv"]),
        "ms": fl["dkv_ms"], "plain_ms": fl["plain_bwd_ms"],
        "bound_ms": fl["bound_dkv_ms"], "bound_by": fl["bound_dkv_by"],
        "library_ms": None, **report("dkv", 128, 0, False),
    }, {
        "name": "flash_attention_dq", "route": "cuda", "source": src,
        "replaces": f"{tpu}:295", "launches": trained["bwd_launches"],
        "remat_launches": surface["remat"]["bwd_launches"],
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
            "max_abs_err": max(ev["max_err"][e] for e in errs),
            "ms": ev[f"{key}_ms"],
            "plain_ms": ev["plain_fwd_ms" if key == "fwd"
                           else "plain_bwd_ms"],
            "bound_ms": ev[f"bound_{key}_ms"],
            "bound_by": ev[f"bound_{key}_by"], "library_ms": lib,
            **report(kname, ev["shape"][3], 1, True),
            **({"cases": variants} if key == "fwd" else {}),
        })
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, kind=kind, kernels=kernels,
                           appends=appends, graph_vs_eager=graph_eager,
                           serve=served, serve_int8=served_int8,
                           front_door=http, phase3f=feature,
                           overcap=overcap, parity=par, parity_int8=par_int8,
                           train=trained, train_parity=tpar, ernie=ernie,
                           train_dropout=gpt_drop, ernie_parity=epar,
                           training_surface=surface), f,
                      indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
