#!/usr/bin/env python3
"""Time the ragged paged-attention kernel at chip_smoke.py's phase 2 cases.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 torch_paged_bench.py [--root DIR] [--tag NAME] [--out f.json]

`--root` imports `paddle_tpu_torch` from another tree (a copy of the repo
with one change, or an older commit unpacked with `git archive`), so two
versions of the kernel can be compared in one process order on one card:
run the script once per tree, in the order A, B, B, A. The cases are
phase 2's (`chip_smoke._case`, built from this checkout's chip_smoke.py):
gpt_1p3b's serving shape (batch 8, heads 16, head_dim 128, block 16) at
step widths 1, 5 and 128, over a float arena and an int8 arena with its
float32 scales, q in bfloat16 and in float32. Prints one line,
`[time TAG] {case: ms}`: the device time of one call (50 calls captured
in a CUDA graph, replayed between two CUDA events), and the card's
`nvidia-smi` name and power limit.
"""
import argparse
import json
import subprocess
import sys

import torch

import chip_smoke as cs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="import paddle_tpu_torch from this tree")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_paged_bench: no CUDA device", file=sys.stderr)
        return 1
    if args.root:
        sys.path.insert(0, args.root)
    from paddle_tpu_torch.ops import paged_attention as pa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_layers, n_blocks, layer = 24, cs.B * (2048 // cs.BS) + 1, 17
    shape = (n_layers, cs.H, n_blocks, cs.BS, cs.D)
    out = {}
    for arena in ("float", "int8"):
        for dtype in (torch.bfloat16, torch.float32):
            sc = {}
            if arena == "int8":
                k, v = (torch.randint(-127, 128, shape, generator=gen,
                                      device=dev, dtype=torch.int8)
                        for _ in "kv")
                sc = dict(k_scale=torch.rand(shape[:3], generator=gen,
                                             device=dev) * 0.03 + 0.002,
                          v_scale=torch.rand(shape[:3], generator=gen,
                                             device=dev) * 0.03 + 0.002)
            else:
                k, v = (torch.randn(shape, generator=gen, device=dev)
                        .to(dtype) for _ in "kv")
            for width in cs.WIDTHS:
                c = cs._case(width, gen, n_blocks, dtype, dev)
                name = (f"{arena}_{str(dtype).replace('torch.', '')}"
                        f"_w{width}")
                out[name] = cs.time_ms(
                    lambda: pa.ragged_paged_attention(  # noqa: B023
                        c["q"], k, v, layer, c["tables"],
                        q_start=c["q_start"], kv_live=c["kv_live"],
                        q_lens=c["q_lens"], **sc), 50)
            del k, v, sc
            torch.cuda.empty_cache()
    print(f"[time {args.tag}] " + json.dumps(out), flush=True)
    print(f"[card] {smi}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(tag=args.tag, root=args.root, card=smi, ms=out),
                      f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
