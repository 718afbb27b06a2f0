"""Tensor-parallel replicas behind the fleet router (serving/router.py,
serving/autoscale.py and the CLI's ``--tp-degree`` with ``--replicas`` /
``--autoscale-max``), on the CPU.

Each replica is an `LLMEngine` over its own two-rank CPU mesh (spawned gloo
ranks, collectives timing out after 60 s), placed as the JAX CLI places a
replica: over the first ``tp`` devices. What holds:

- ``--tp-degree 2 --replicas 2 --device cpu`` and ``--tp-degree 2
  --autoscale-max 3`` serve the one-card greedy tokens (`GPT.generate`
  on the CLI's seed-0 model, float32);
- a retired tp replica's rank processes end, and the other keeps serving;
- a rank that dies takes its replica out (its engine thread ends on the
  `RankFailed`, its other ranks end with it) and the fleet keeps serving
  on the other replica.
"""
import asyncio
import json
import os
import re
import select
import signal
import subprocess
import sys
import time

import pytest
import torch

from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_tiny
from paddle_tpu_torch.serving import AsyncLLMEngine, LLMEngine, ReplicaRouter
from paddle_tpu_torch.serving.sharded import build_serving_mesh
from test_torch_router import http
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = [1, 2, 3]


def _one_card_tokens(n=3):
    """The CLI's model (gpt_tiny, seed 0, float32), greedy on one card."""
    model = gpt_tiny(device="cpu", seed=0)
    out = model.generate(torch.tensor([PROMPT]), max_new_tokens=n,
                         temperature=0.0)
    return out[0, len(PROMPT):].tolist()


@pytest.mark.parametrize("fleet", [["--replicas", "2"],
                                   ["--autoscale-max", "3"]])
def test_cli_serves_tp_replicas_with_the_one_card_tokens(fleet):
    """The fleet switches with ``--tp-degree 2``: every replica over its own
    two CPU ranks, the one-card greedy tokens, its ranks ended on SIGINT."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_TPU_")}
    argv = [sys.executable, "-m", "paddle_tpu_torch.serving.server",
            "--device", "cpu", "--port", "0", "--max-seq-len", "64",
            "--tp-degree", "2"] + fleet
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        assert select.select([proc.stdout], [], [], 120)[0], \
            "the server printed no address in 120 s"
        line = proc.stdout.readline()
        port = int(re.search(r":(\d+) \(", line).group(1))
        got = []
        for _ in range(2):
            status, body = asyncio.run(asyncio.wait_for(http(
                port, "POST", "/v1/completions",
                {"prompt": PROMPT, "max_tokens": 3}), 120))
            assert status == 200, body
            got.append(json.loads(body)["choices"][0]["token_ids"])
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, proc.stderr.read()
    assert "over 2 tp ranks each" in line
    assert got == [_one_card_tokens()] * 2


def _tp_engine(model):
    return LLMEngine(model, device="cpu", block_size=8, max_batch=4,
                     max_seq_len=64,
                     mesh=build_serving_mesh(2, device="cpu", timeout=60))


def test_router_over_tp_replicas_retires_and_survives_a_dead_rank():
    """Two tp=2 replicas behind the router: both serve the one-card
    tokens; retiring one ends its rank process and the other serves on;
    then a rank of a fresh second replica is killed: the replica leaves
    rotation, its engine closes (no rank process left), and the fleet
    serves on the first."""
    model = GPT(GPTConfig(vocab_size=1024, hidden_size=256, num_layers=4,
                          num_heads=8, max_seq_len=256), device="cpu",
                seed=0)
    want = model.generate(torch.tensor([PROMPT]), max_new_tokens=4,
                          temperature=0.0)[0, len(PROMPT):].tolist()

    async def serve(router):
        st = await router.submit(PROMPT, max_new_tokens=4, temperature=0.0)
        return await st.collect()

    async def main():
        fronts = [AsyncLLMEngine(_tp_engine(model)) for _ in range(2)]
        router = ReplicaRouter(fronts, sweep_interval_s=0.02,
                               probe_interval_s=60.0)
        await router.start()
        out = {"both": [await serve(router) for _ in range(2)]}
        retired = router.replicas[1].engine.engine
        ranks = list(retired._tp.procs)
        await router.retire_replica("r1", drain_timeout_s=10)
        out["retired_alive"] = [p for p in ranks if p.is_alive()]
        out["after_retire"] = await serve(router)
        # a second replica again, then one of its ranks dies
        extra = await router.add_replica(AsyncLLMEngine(_tp_engine(model)))
        victim = extra.engine.engine
        dead = victim._tp.procs[0]
        dead.kill()
        dead.join(10)
        deadline = time.monotonic() + 60
        while extra.state == "active" and time.monotonic() < deadline:
            # route to the victim until its step meets the dead rank
            try:
                st = extra.engine.submit(PROMPT, max_new_tokens=4,
                                         temperature=0.0)
                await st.collect()
            except Exception:  # noqa: BLE001 — closed admission
                pass
            await asyncio.sleep(0.05)
        out["victim_state"] = extra.state
        deadline = time.monotonic() + 30
        while victim._tp.procs and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        # closed: the rank set was ended (and emptied) by the dying thread
        out["victim_ranks"] = victim._tp.procs
        out["survivor"] = [await serve(router) for _ in range(2)]
        await router.shutdown()
        out["left"] = [p for f in fronts for p in
                       (f.engine._tp.procs if f.engine._tp else [])
                       if p.is_alive()]
        return out

    out = asyncio.run(main())
    assert out["both"] == [(want, "length")] * 2
    assert out["retired_alive"] == []
    assert out["after_retire"] == (want, "length")
    assert out["victim_state"] == "ejected"
    assert out["victim_ranks"] == []
    assert out["survivor"] == [(want, "length")] * 2
    assert out["left"] == []


def test_a_closed_tp_engine_is_freed():
    """Once closed, a tensor-parallel engine gives its memory back when
    its last reference goes: the engine, its shard of the weights and its
    arena are garbage like any other object (its rank-ending finalizer,
    whose arguments hold the step programs and so the engine, is
    detached), and the caller's model is untouched."""
    import gc
    import weakref

    model = gpt_tiny(device="cpu", seed=0)
    engine = _tp_engine(model)
    engine.generate([PROMPT], max_new_tokens=2)
    refs = [weakref.ref(x) for x in (engine, engine.model, engine.pool.k)]
    engine.close()
    assert engine._tp.alive() == []
    del engine
    gc.collect()
    assert [r() for r in refs] == [None] * 3
    assert all(not p.is_meta for p in model.parameters())
