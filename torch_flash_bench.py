#!/usr/bin/env python3
"""Time the flash-attention kernels at chip_smoke.py's phase 5 / 5b shapes.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 torch_flash_bench.py [--root DIR] [--tag NAME] [--out f.json]

`--root` imports `paddle_tpu_torch` from another tree (a copy of the repo
with one change, or an older commit unpacked with `git archive`), so two
versions of a kernel can be compared in one process order on one card:
run the script once per tree, in the order A, B, B, A. Prints one line,
`[time TAG] {case: {"fwd": ms, "dkv": ms, "dq": ms}}`: device time of one
launch (20 or 10 launches captured in a CUDA graph, replayed between two
CUDA events), bf16 throughout. Cases: the flagship causal shape (B 16,
S 1024, H 8, D 128, contiguous q/k/v), the ERNIE shape (B 32, S 512,
H 12, D 64) with its [B, 1, 1, S] padding mask and/or dropout 0.1 on
strided views of a fused projection, and the flagship shape with causal
dropout.
"""
import argparse
import json
import sys

import numpy as np
import torch

CASES = [
    # name, (B, S, H, D), causal, padding mask, dropout p, q/k/v layout
    ("flagship", (16, 1024, 8, 128), True, False, 0.0, "contiguous"),
    ("ernie_mask_dropout", (32, 512, 12, 64), False, True, 0.1, "ernie"),
    ("ernie_mask", (32, 512, 12, 64), False, True, 0.0, "ernie"),
    ("ernie_dropout", (32, 512, 12, 64), False, False, 0.1, "ernie"),
    ("ernie_neither", (32, 512, 12, 64), False, False, 0.0, "ernie"),
    ("flagship_causal_dropout", (16, 1024, 8, 128), True, False, 0.1, "gpt"),
]


def time_ms(fn, iters):
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="import paddle_tpu_torch from this tree")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bench: no CUDA device", file=sys.stderr)
        return 1
    if args.root:
        sys.path.insert(0, args.root)
    from paddle_tpu_torch.models.bert import split_qkv
    from paddle_tpu_torch.models.gpt import _split_fused_qkv
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    for name, (B, S, H, D), causal, with_mask, p, layout in CASES:
        if layout == "contiguous":
            q, k, v = (torch.randn((B, S, H, D), generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(3))
        else:
            qkv = torch.randn((B, S, 3 * H * D), generator=gen,
                              device="cuda").bfloat16()
            split = split_qkv if layout == "ernie" else _split_fused_qkv
            q, k, v = split(qkv, B, S, H, D)
        do = torch.randn((B, S, H, D), generator=gen,
                         device="cuda").bfloat16()
        mask = None
        if with_mask:
            lens = np.random.RandomState(0).randint(S // 2, S + 1, B)
            real = np.arange(S)[None] < lens[:, None]
            mask = torch.from_numpy(np.where(real, 0.0, -1e4).astype(
                np.float32))[:, None, None, :].cuda()
        seed = 20261016 if p > 0 else None
        o32 = torch.empty(q.shape, device="cuda") if p > 0 else None
        o, lse = fa.flash_attention_fwd(q, k, v, causal, mask, p, seed, o32)
        delta = fa._delta(o if o32 is None else o32, do)
        var = (mask, p, seed)
        out[name] = dict(
            fwd=time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal, *var,
                                                       o32), 20),
            dkv=time_ms(lambda: fa._launch_bwd(q, k, v, do, lse, delta,
                                               causal, 1, *var), 10),
            dq=time_ms(lambda: fa._launch_bwd(q, k, v, do, lse, delta,
                                              causal, 2, *var), 10))
    print(f"[time {args.tag}] " + json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(tag=args.tag, root=args.root, ms=out), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
