#!/usr/bin/env python3
"""Where a training step's time goes on the card, for the PyTorch port.

Trains chip_smoke.py's flagship GPT (`--model gpt`: vocab 32768, hidden
1024, 12 layers, 8 heads, seq 1024, bf16, AdamW(1e-4), batch 16 x 1024
from np.random.RandomState(0)), the same GPT as phase 6c trains it
(`--model gpt-o2`: built in float32, amp.decorate(level="O2") masters,
AdamW(weight decay 0.01) under the warm-up + cosine schedule, stepped
after each step, and ClipGradByGlobalNorm(1.0); `gpt-o2-remat` with
remat=True as well) or its ERNIE-base pretrain step (`--model ernie`:
hidden 768, 12 layers, 12 heads, vocab 40000, bf16, dropout 0.1, batch
32 x 512 with a padding mask): two warm-up steps, then `--steps`
steps with CUDA events between forward, backward and optimizer (device
time of each phase), then `--steps` steps under `torch.profiler`, and
prints the device time by kernel and by kind of kernel, the device's busy
share of the wall time, and the card's clock and power after the runs:

    python3 torch_train_profile.py [--model gpt|gpt-o2|gpt-o2-remat|ernie]
                                   [--steps 5]
                                   [--out profile.json] [--trace trace.json]

Needs one CUDA card and nvcc (the kernels are built on first use).
"""
import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# kinds of kernel, by name (first match wins)
KINDS = [("flash_fwd", r"flash_fwd"), ("flash_dkv", r"flash_dkv"),
         ("flash_dq", r"flash_dq"),
         ("gemm", r"gemm|Gemm|GEMM|sm90_|cutlass|xmma|nvjet|cublas"),
         ("optimizer", r"multi_tensor|foreach"),
         ("rng", r"distribution|uniform|bernoulli|philox"),
         ("softmax_reduce", r"reduce|softmax|logsumexp|Reduce"),
         ("layernorm", r"layer_norm|LayerNorm|GammaBeta"),
         ("elementwise_copy", r"elementwise|vectorized|unrolled|copy|Copy"
                              r"|index|scatter|gather|fill")]


def kind_of(name):
    return next((k for k, pat in KINDS if re.search(pat, name)), "other")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the summary to this JSON file")
    ap.add_argument("--trace", help="export the Chrome trace to this file")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--model", default="gpt",
                    choices=("gpt", "gpt-o2", "gpt-o2-remat", "ernie"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sched = None
    if args.model == "gpt":
        model, opt, (ids, labels) = chip_smoke.flagship_trainer()
    elif args.model.startswith("gpt-o2"):
        model, opt, sched, _, (ids, labels) = chip_smoke._surface_trainer(
            remat=args.model.endswith("remat"))
    if args.model.startswith("gpt"):
        def loss_fn():
            return model(ids, labels=labels)
    else:
        from paddle_tpu_torch.models.bert import bert_pretrain_loss_fn

        model, opt, batch, _ = chip_smoke.ernie_trainer()

        def loss_fn():
            logits, nsp = model(*batch[:3])
            return bert_pretrain_loss_fn((logits, nsp), batch[3])

    def step():
        loss = loss_fn()
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        if sched is not None:
            sched.step()

    for _ in range(2):
        step()
    torch.cuda.synchronize()

    phases = {"forward": [], "backward": [], "optimizer": [], "step": []}
    for _ in range(args.steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = loss_fn()
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        opt.zero_grad(set_to_none=True)
        ev[3].record()
        if sched is not None:
            sched.step()
        torch.cuda.synchronize()
        for name, (a, b) in zip(phases, ((0, 1), (1, 2), (2, 3), (0, 3))):
            phases[name].append(ev[a].elapsed_time(ev[b]))
    phase_ms = {k: float(np.median(v)) for k, v in phases.items()}
    print(json.dumps({"phase_p50_ms": phase_ms}), flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a record_function range (such as the optimizer's
    # "Optimizer.step#AdamW.step") also shows on the device timeline and
    # would count its kernels twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    dev_us = {e.key: e.self_device_time_total for e in events}
    calls = {e.key: e.count for e in events}
    busy_ms = sum(dev_us.values()) / 1e3
    by_kind = {}
    for k, us in dev_us.items():
        by_kind[kind_of(k)] = by_kind.get(kind_of(k), 0.0) + us / 1e3
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:args.top]
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = dict(
        model=args.model, card=card, clocks_power_temp_after=clocks,
        steps=args.steps,
        phase_p50_ms=phase_ms, profiled_wall_ms=wall_ms,
        device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
        busy_ms_per_step=busy_ms / args.steps,
        by_kind_ms_per_step={k: v / args.steps for k, v in
                             sorted(by_kind.items(), key=lambda kv: -kv[1])},
        kernels_ms=[{"name": k[:120], "ms": us / 1e3, "calls": calls[k],
                     "kind": kind_of(k), "share_of_busy": us / 1e3 / busy_ms}
                    for k, us in top])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
