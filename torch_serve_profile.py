#!/usr/bin/env python3
"""Where a serving step's time goes on the card, for the PyTorch port.

Serves the same traffic as chip_smoke.py's serve phase (gpt_1p3b in bf16,
LLMEngine(block_size=16, max_batch=8, spec_decoding=True, warmup=True), 8
greedy requests, four sharing a 256-token prefix, 32 new tokens each):
first `--repeats` times without the profiler, each on a fresh warmed
engine (the spread of tok/s, step latency and the device busy share by
CUDA events around each step's copy-in and graph replay), then once under
`torch.profiler`, and prints the device time by kernel, the device's busy
share of the wall time, the replays of each width bucket's CUDA graph,
the host time per step kind, and the card's clock and power after the
runs. The ragged paged-attention kernels' device time (every `rpa_*`
kernel) and, with `--kv-dtype int8`, the int8 append kernel's
(`kv_quantize_scatter_kernel`; a replayed graph carries no
`record_function` ranges, so kernels are found by name) are reported
apart with their shares of the busy time. It also times the step's
sampler alone at the wave's shapes (B 8, vocab 50304, scored windows of 1
and 5): the branch-free decision the step runs (`spec_emit_arrays`)
beside a greedy-only decision (argmax, drafts' accept, leading-accept
walk; `greedy_decision` here, which no step runs), the device time that
running the sampler on every step costs:

    python3 torch_serve_profile.py [--repeats 3] [--kv-dtype int8]
                                   [--out profile.json] [--trace trace.json]

Needs one CUDA card and nvcc (the kernels are built on first use).
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def greedy_decision(lg, ids, spec_lens):
    """The decision a step of greedy rows alone needs: the argmax at
    every scored position, each draft accepted while it equals the argmax
    before it, and the stop slot's argmax. The sampler's timing baseline."""
    greedy = torch.argmax(lg.float(), dim=-1)
    j = torch.arange(ids.shape[1] - 1, device=lg.device)[None, :]
    alive = (ids[:, 1:] == greedy[:, :-1]) & (j < spec_lens[:, None])
    n_acc = torch.cumprod(alive.to(torch.int32), dim=1).sum(dim=1)
    return torch.gather(greedy, 1, n_acc[:, None]), n_acc


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the summary to this JSON file")
    ap.add_argument("--trace", help="export the Chrome trace to this file")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--kv-dtype", choices=["int8"], default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import (StepEvents, _prompts, serve_waves,
                            serving_engine, time_ms)
    from paddle_tpu_torch.models.gpt import gpt_1p3b
    from paddle_tpu_torch.serving.spec import spec_emit_arrays

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    model = gpt_1p3b(device="cuda", dtype=torch.bfloat16, seed=0)
    prompts = _prompts(np.random.RandomState(0), model.cfg.vocab_size)

    def fresh_engine():
        eng = serving_engine(model, args.kv_dtype)
        return eng, eng.step_count

    def serve(eng):
        serve_waves(eng, prompts)

    def replays(eng):
        return {f"w{W}": p.replays for (_, W), p in sorted(
            eng._step_fns.items())}

    runs = []
    for _ in range(args.repeats):
        engine, steps0 = fresh_engine()
        replays0 = replays(engine)
        with StepEvents() as ev:
            t0 = time.perf_counter()
            serve(engine)
            wall = time.perf_counter() - t0
        busy = ev.busy_ms()
        lat = engine.metrics.latency_summary()
        runs.append(dict(
            wall_ms=wall * 1e3, steps=engine.step_count - steps0,
            tok_per_s=engine.metrics.counters["generated_tokens"] / wall,
            device_busy_ms=busy, device_busy_share=busy / (wall * 1e3),
            warmup_s=engine.metrics.gauges["warmup_seconds"],
            replays={k: n - replays0[k]
                     for k, n in replays(engine).items()},
            ttft_p50_ms=lat["ttft"]["p50_ms"],
            step_p50_ms={k: v["p50_ms"] for k, v in lat.items()
                         if k.endswith("_step")}))
        print(json.dumps(runs[-1]), flush=True)
    # the sampler alone at the wave's shapes: what the branch-free step
    # pays for running it on every (here greedy) row; its draws come from
    # the default generator, which every captured graph registers
    gen = torch.Generator(device="cuda").manual_seed(0)
    sampler_ms = {}
    for k1 in (1, 5):
        lg = torch.randn((8, k1, model.cfg.vocab_size), device="cuda",
                         generator=gen)
        ids = torch.zeros((8, k1), dtype=torch.int32, device="cuda")
        lens = torch.full((8,), k1 - 1, dtype=torch.int32, device="cuda")
        knobs = (torch.zeros(8, device="cuda"),
                 torch.zeros(8, dtype=torch.int32, device="cuda"),
                 torch.ones(8, device="cuda"))
        sampler_ms[f"window{k1}"] = {
            "branch_free": time_ms(lambda: spec_emit_arrays(
                lg, ids, lens, *knobs), 20),
            "greedy_only": time_ms(lambda: greedy_decision(
                lg, ids, lens), 20)}
    print(json.dumps({"sampler_ms": sampler_ms}), flush=True)
    engine, steps0 = fresh_engine()
    replays0 = replays(engine)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(engine)
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in events}
    busy_ms = sum(dev_us.values()) / 1e3
    qs_ms = sum(us for k, us in dev_us.items()
                if "kv_quantize_scatter" in k) / 1e3
    rpa_ms = sum(us for k, us in dev_us.items() if "rpa_" in k) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:args.top]

    def share(ms):   # None where the trace shows no device time
        return ms / busy_ms if busy_ms else None

    lat = engine.metrics.latency_summary()
    c = engine.metrics.counters
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = dict(
        card=card, clocks_power_temp_after=clocks,
        kv_dtype=engine.pool.kv_dtype, unprofiled_runs=runs,
        sampler_ms=sampler_ms,
        replays={k: n - replays0[k] for k, n in replays(engine).items()},
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_busy_share=busy_ms / wall_ms,
        quantize_scatter_device_ms=qs_ms,
        quantize_scatter_share_of_busy=share(qs_ms),
        # the ragged paged-attention kernels (every design's: rpa_*)
        ragged_attention_device_ms=rpa_ms,
        ragged_attention_share_of_busy=share(rpa_ms),
        steps=engine.step_count - steps0,
        step_ms={k: {"count": v["count"], "total_ms": v["total_ms"],
                     "p50_ms": v["p50_ms"]}
                 for k, v in lat.items() if k.endswith("_step")},
        kernels_ms=[{"name": k[:120], "ms": us / 1e3,
                     "share_of_busy": share(us / 1e3),
                     "calls": next(e.count for e in events if e.key == k)}
                    for k, us in top],
        generated_tokens=int(c.get("generated_tokens", 0)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
