"""The rank processes of a tensor-parallel engine: what each builds and
the operations it serves.

``LLMEngine(model, mesh=N)`` stays the one controller (rank 0, in the
caller's process) and starts N - 1 rank processes through
`distributed.ranks.RankSet` (spawn, one pipe a rank, `RankFailed`, a
bounded close; the machinery data-parallel training shares). Each rank
builds its own `LLMEngine` over its shard of the weights and of the arena
(serving/sharded.py) and then applies every device-mutating operation of
the controller in the controller's order:

- ``build``: a width bucket's program, which the controller sends before
  it builds its own (over NCCL a build runs and captures the body's
  collectives, so every rank builds in the controller's order);
- ``step``: the width bucket and the program's two staged buffers (one
  int32 and one float32 array, `_StepProgram._host_ints` /
  ``_host_floats``); the rank copies them into its own program and runs it.
  Every rank runs the whole body, sampler included, so its generator
  stays in step with rank 0's, whose packed result the host reads;
- ``copy_blocks`` (copy-on-write), ``lora_write`` / ``lora_zero`` (adapter
  slots), ``tier_save`` / ``tier_restore`` / ``tier_read`` /
  ``tier_write`` (the host tier's per-rank slabs);
- ``report`` (launch and collective counters, parameter bytes, the load
  report, the rank's imported top-level modules; ``zero=True`` resets the
  counters) and ``close``.

A step's data moves over the data plane only (`parallel.collectives`);
the pipes carry the few kilobytes a step stages. Weights placed from the
caller's model go rank 0 -> rank r over the data plane at construction. A
rank that fails makes the controller raise `RankFailed` from the step
that met it or the next one (`RankSet.check` runs after every step); the
engine never steps again.
"""
from __future__ import annotations

import os
import sys

import torch

from ..distributed.ranks import rank_loop


def rank_main(smesh, store, spec, conn):
    """A rank process's entry point (`distributed.ranks.rank_loop`): build
    this rank's engine over the model's skeleton (`spec`: ``skeleton``,
    ``engine_kw``, ``num_threads``, ``tf32``), report ready and serve the
    channel's operations inside the engine's device scope until
    ``close``."""
    def build():
        from .engine import LLMEngine

        engine = LLMEngine(spec["skeleton"], device=smesh.device, mesh=smesh,
                           **spec["engine_kw"])
        return engine, rank_report(engine)

    rank_loop(smesh, store, spec, conn, build, _OPS,
              finish=lambda engine: engine.close(),
              scope=lambda engine: engine.device_scope())


def _build(engine, W):
    engine._get_step_fn(engine.max_batch, W)


def _step(engine, W, ints, floats):
    prog = engine._get_step_fn(engine.max_batch, W)
    prog._host_ints.copy_(torch.from_numpy(ints))
    prog._host_floats.copy_(torch.from_numpy(floats))
    prog()


def _copy_blocks(engine, src, dst):
    engine.pool.copy_blocks(src, dst)


def _lora_write(engine, slot, packed):
    from ..models import lora

    lora.write_slot(engine._lora_tables, slot,
                    lora.shard_adapter(packed, engine._smesh))


def _lora_zero(engine, slot):
    from ..models import lora

    lora.zero_slot(engine._lora_tables, slot)


def _tier_save(engine, pairs):
    engine.tier._copy_out(pairs)


def _tier_restore(engine, slots, blocks):
    engine.tier._copy_in(slots, blocks)


def _tier_read(engine, slots):
    engine.tier._quiesce()
    return engine.tier._read_slots(slots)


def _tier_write(engine, slots, entries):
    engine.tier._quiesce()
    engine.tier._write_slots(slots, entries)


def rank_report(engine, zero=False):
    """A rank's report, as the controller asks for it (and rank 0 reads
    its own): its launch and collective counters (reset after reading
    with `zero`), its parameter bytes, its weight load report and the
    top-level modules its process has imported."""
    from ..parallel.collectives import (collective_counts,
                                        reset_collective_counts)
    from .engine import _counted_wrappers

    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    launches = {}
    for fn in _counted_wrappers():
        for name, v in vars(fn).items():
            launches[f"{fn.__name__}.{name}"] = (dict(v) if isinstance(v, dict)
                                                 else v)
    out = {"rank": engine._smesh.rank, "device": str(engine.device),
           "pid": os.getpid(), "launches": launches,
           "collectives": collective_counts(),
           "param_bytes": sum(engine.param_bytes_by_device().values()),
           "load": (None if engine.load_report is None
                    else engine.load_report.summary()),
           "modules": sorted({m.split(".")[0] for m in sys.modules})}
    if zero:
        reset_collective_counts()
        for fn in _counted_wrappers():
            for name, v in vars(fn).items():
                setattr(fn, name, {} if isinstance(v, dict) else 0)
    return out


_OPS = {"build": _build, "step": _step, "copy_blocks": _copy_blocks,
        "lora_write": _lora_write, "lora_zero": _lora_zero,
        "tier_save": _tier_save, "tier_restore": _tier_restore,
        "tier_read": _tier_read, "tier_write": _tier_write,
        "report": rank_report}

__all__ = ["rank_main", "rank_report"]
