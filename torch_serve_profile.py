#!/usr/bin/env python3
"""Where a serving step's time goes on the card, for the PyTorch port.

Serves the same traffic as chip_smoke.py's serve phase (gpt_1p3b in bf16,
LLMEngine(block_size=16, max_batch=8, spec_decoding=True), 8 greedy
requests, four sharing a 256-token prefix, 32 new tokens each): first
`--repeats` times without the profiler, each on a fresh engine (the spread
of tok/s and step latency), then once under `torch.profiler`, and prints
the device time by kernel, the device's busy share of the wall time, the
host time per step kind, and the card's clock and power after the runs.
The ragged paged-attention kernels' device time (every `rpa_*` kernel)
and its share of the busy time are reported apart.
`--kv-dtype int8` serves from the int8 KV arena; the profiled run then
also reports the device time of the plain-PyTorch quantize-scatter
(`block_pool._quantize_scatter`, annotated with `record_function`) and
its share of the busy time:

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
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import _prompts, serve_waves, serving_engine
    from paddle_tpu_torch.models.gpt import gpt_1p3b
    from paddle_tpu_torch.serving import block_pool

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

    runs = []
    for _ in range(args.repeats):
        engine, steps0 = fresh_engine()
        t0 = time.perf_counter()
        serve(engine)
        wall = time.perf_counter() - t0
        lat = engine.metrics.latency_summary()
        runs.append(dict(
            wall_ms=wall * 1e3, steps=engine.step_count - steps0,
            tok_per_s=engine.metrics.counters["generated_tokens"] / wall,
            ttft_p50_ms=lat["ttft"]["p50_ms"],
            step_p50_ms={k: v["p50_ms"] for k, v in lat.items()
                         if k.endswith("_step")}))
        print(json.dumps(runs[-1]), flush=True)
    engine, steps0 = fresh_engine()
    quantize_scatter = block_pool._quantize_scatter

    def annotated(*a, **kw):
        with record_function("quantize_scatter"):
            return quantize_scatter(*a, **kw)

    block_pool._quantize_scatter = annotated
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            serve(engine)
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        block_pool._quantize_scatter = quantize_scatter
    averages = prof.key_averages()
    # the annotation's device time: the kernels launched inside it (its
    # device-side twin, a span over those kernels and the gaps between
    # them, is left out of the busy time)
    qs_ms = sum(e.device_time_total for e in averages
                if e.key == "quantize_scatter"
                and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key != "quantize_scatter"]
    dev_us = {e.key: e.self_device_time_total for e in events}
    busy_ms = sum(dev_us.values()) / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:args.top]
    lat = engine.metrics.latency_summary()
    c = engine.metrics.counters
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = dict(
        card=card, clocks_power_temp_after=clocks,
        kv_dtype=engine.pool.kv_dtype, unprofiled_runs=runs,
        wall_ms=wall_ms, device_busy_ms=busy_ms,
        device_busy_share=busy_ms / wall_ms,
        quantize_scatter_device_ms=qs_ms,
        quantize_scatter_share_of_busy=qs_ms / busy_ms,
        # the ragged paged-attention kernels (every design's: rpa_*)
        ragged_attention_device_ms=sum(
            us for k, us in dev_us.items() if "rpa_" in k) / 1e3,
        ragged_attention_share_of_busy=sum(
            us for k, us in dev_us.items() if "rpa_" in k) / 1e3 / busy_ms,
        steps=engine.step_count - steps0,
        step_ms={k: {"count": v["count"], "total_ms": v["total_ms"],
                     "p50_ms": v["p50_ms"]}
                 for k, v in lat.items() if k.endswith("_step")},
        kernels_ms=[{"name": k[:120], "ms": us / 1e3,
                     "share_of_busy": us / 1e3 / busy_ms,
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
