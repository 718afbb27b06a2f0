#!/usr/bin/env python3
"""How often a fleet retire leaves its engine alive, for the PyTorch port.

Runs chip_smoke.py's phase 3g (gpt_1p3b saved to disk, streamed into two
replicas behind `RouterServer`, a rolling drain under load, a manual
`retire_replica()`, then the autoscaler's burst, spawn and retire) `--runs`
times in one process on one card, after phase 3's serve wave that gives
the tokens 3g holds its replicas to. Each run's line says whether the
phase passed, whether each retired engine was gone when its retire
returned (`earlier_retire_freed`, `spawned_engine_freed`), and, where the
checkout's phase records them, what still held it. A run whose phase
fails is counted and the next one starts; a failed run may leave its
replicas on the card.

`--root` names the checkout whose chip_smoke.py and paddle_tpu_torch run
(default: this file's own), so that two trees are compared with one copy
of this script:

    python3 torch_fleet_retire.py [--root DIR] [--runs 3] [--out FILE]

Prints one JSON object per run, then the card's name and power limit,
then a summary object. Needs one CUDA card and nvcc (the kernels are
built from the checkout's sources first).
"""
import argparse
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", help="also write the runs to this JSON file")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_fleet_retire: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.build_kernels()
    model = cs.serving_model()
    _, graph_outs = cs.serve(model)
    runs = []
    for i in range(args.runs):
        t0 = time.perf_counter()
        rec = dict(run=i, root=root)
        try:
            a = cs.fleet(model, graph_outs, card)["autoscale"]
            rec["passed"] = True
        except (AssertionError, SystemExit) as e:
            a = e.args[0] if e.args and isinstance(e.args[0], dict) else {}
            rec.update(passed=False, error=repr(e)[:2000])
        rec.update({k: a.get(k) for k in (
            "earlier_retire_freed", "earlier_retire_holders",
            "spawned_engine_freed", "spawned_engine_holders",
            "mem_before_spawn_mib", "mem_after_retire_mib")},
            seconds=time.perf_counter() - t0)
        print(json.dumps(rec), flush=True)
        runs.append(rec)
        torch.cuda.empty_cache()
    summary = dict(
        root=root, card=card, runs=len(runs),
        passed=sum(r["passed"] for r in runs),
        earlier_retire_alive=sum(r["earlier_retire_freed"] is False
                                 for r in runs),
        spawned_engine_alive=sum(r["spawned_engine_freed"] is False
                                 for r in runs))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(summary=summary, runs=runs), f, indent=1)
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
