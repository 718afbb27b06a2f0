"""The rank processes of a tensor-parallel engine and their command channel.

The JAX engine drives its mesh from one process; PyTorch runs one rank a
device. ``LLMEngine(model, mesh=N)`` stays the one controller (rank 0, in
the caller's process) and starts N - 1 rank processes with the ``spawn``
start method (never ``fork``: the caller may hold CUDA or other runtime
threads). Each rank builds its own `LLMEngine` over its shard of the
weights and of the arena (serving/sharded.py) and then loops on the
channel, applying every device-mutating operation of the controller in the
controller's order:

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

**The channel** is one duplex pipe a rank, on the host, whatever the data
plane. A rank blocks in ``recv`` while the engine idles, with no timeout to
expire, and sees EOF, and exits, when the controller's process ends. A
step's data moves over the data plane only (`parallel.collectives`); the
pipes carry the few kilobytes a step stages. Weights placed from the
caller's model go rank 0 -> rank r over the data plane at construction.

**Failure.** A rank that raises sends its traceback and exits. Its peers'
next collective then fails (a gloo peer sees the closed connection), and
the controller raises `RankFailed` with the rank's traceback, from the
operation that met it or from the next one (`RankSet.check` runs after
every step); the engine never steps again. `RankSet.close` ends every rank
(``close`` first, then terminate after a timeout); nothing outlives it.
"""
from __future__ import annotations

import multiprocessing
import os
import shutil
import signal
import sys
import tempfile
import time
import traceback

import torch


class RankFailed(RuntimeError):
    """A tensor-parallel rank raised or died; the engine cannot step
    again. ``rank`` is its index, ``detail`` its traceback or exit code."""

    fatal = True

    def __init__(self, rank, detail):
        super().__init__(f"tensor-parallel rank {rank} failed: {detail}")
        self.rank = rank
        self.detail = detail


def join_group(smesh, store_path):
    """This process's `TPGroup` on the mesh's data plane: a process group
    built straight on a file store (no default group, no TCP rendezvous),
    with the mesh's timeout. Every rank calls it at start-up; it returns
    once the group is connected (gloo connects in its constructor; NCCL
    builds its communicator at its first collective, so one all-reduce of
    one element is made here, while every rank is in this call)."""
    import torch.distributed as dist

    from ..parallel.collectives import TPGroup

    store = dist.FileStore(store_path, smesh.tp_degree)
    if smesh.backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = smesh.timedelta()
        pg = dist.ProcessGroupNCCL(store, smesh.rank, smesh.tp_degree, opts)
        pg.allreduce([torch.ones(1, device=smesh.device)]).wait()
        torch.cuda.synchronize(smesh.device)
    else:
        pg = dist.ProcessGroupGloo(store, smesh.rank, smesh.tp_degree,
                                   smesh.timedelta())
    return TPGroup(pg, smesh.rank, smesh.tp_degree, smesh.backend)


class RankSet:
    """The controller's end of the channel: one process and one pipe per
    rank 1 .. N-1 (rank order)."""

    def __init__(self, procs, conns, workdir):
        self.procs = procs
        self.conns = conns
        self.workdir = workdir
        self.failed = None        # the RankFailed once a rank failed

    @classmethod
    def start(cls, smesh, spec, hello_timeout=300.0):
        """Spawn ranks 1 .. N-1 (`rank_main`), wait until each has
        imported the port, then join the data plane as rank 0 (which
        returns once every rank has joined). `spec` is what a rank needs
        to build its engine (`rank_main`)."""
        ctx = multiprocessing.get_context("spawn")
        workdir = tempfile.mkdtemp(prefix="paddle-tp-")
        store = os.path.join(workdir, "store")
        procs, conns = [], []
        ranks = cls(procs, conns, workdir)
        try:
            for r in range(1, smesh.tp_degree):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(target=rank_main,
                                args=(smesh.for_rank(r), store, spec, theirs),
                                name=f"paddle-tp-rank{r}", daemon=True)
                p.start()
                theirs.close()
                procs.append(p)
                conns.append(mine)
            for r in range(1, smesh.tp_degree):
                ranks._expect(r, "hello", hello_timeout)
            smesh.group = join_group(smesh, store)
        except BaseException:
            ranks.close()
            raise
        return ranks

    # -- messages ----------------------------------------------------------

    def _recv(self, r, timeout=None):
        """The next message of rank `r`; raises RankFailed when the rank
        sent an error, died, or stayed silent past `timeout` seconds."""
        conn, proc = self.conns[r - 1], self.procs[r - 1]
        deadline = None if timeout is None else time.monotonic() + timeout
        while not conn.poll(0.05):
            if not proc.is_alive() and not conn.poll(0.05):
                self._fail(r, f"exited with code {proc.exitcode}")
            if deadline is not None and time.monotonic() > deadline:
                self._fail(r, f"no answer in {timeout:.0f} s")
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            self._fail(r, f"exited with code {proc.exitcode}")
        if msg[0] == "error":
            self._fail(r, msg[1])
        return msg

    def _expect(self, r, kind, timeout=None):
        msg = self._recv(r, timeout)
        if msg[0] != kind:
            self._fail(r, f"sent {msg[0]!r} where {kind!r} was due")
        return msg[1]

    def _fail(self, r, detail):
        if self.failed is None:
            self.failed = RankFailed(r, detail)
        raise self.failed

    def _live(self):
        if self.failed is not None:
            raise self.failed

    def send(self, op, *args):
        """Run `op(*args)` on every rank, in order after everything sent
        before; no reply."""
        self._live()
        for r, conn in enumerate(self.conns, start=1):
            try:
                conn.send((op, args, False))
            except (BrokenPipeError, OSError):
                self._recv(r, timeout=5.0)   # raises with the rank's error
                raise
        return None

    def call(self, op, *args):
        """Run `op(*args)` on every rank and return their results in rank
        order (1 .. N-1)."""
        self._live()
        for conn in self.conns:
            conn.send((op, args, True))
        return [self._expect(r, "ok") for r in range(1, 1 + len(self.conns))]

    def wait_ready(self):
        """Each rank's report once its engine is built (rank order)."""
        return [self._expect(r, "ready") for r in range(1, 1 + len(self.conns))]

    def check(self):
        """Raise RankFailed if a rank has reported an error or died; a
        cheap poll after every step."""
        self._live()
        for r, (conn, proc) in enumerate(zip(self.conns, self.procs), 1):
            if conn.poll() or not proc.is_alive():
                self._recv(r, timeout=5.0)
                self._fail(r, "sent a message nobody asked for")

    def failure(self, exc):
        """After `exc` escaped a step the ranks were told of: raise the
        failed rank's RankFailed (from `exc`), or, when none reports a
        failure within 5 s, rank 0's own: the other ranks may wait inside
        a collective rank 0 never reached, so the engine cannot step
        again either way."""
        if self.failed is not None:
            raise self.failed from exc
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            try:
                self.check()
            except RankFailed as failed:
                raise failed from exc
            time.sleep(0.05)
        self._fail(0, f"{type(exc).__name__}: {exc}")

    def close(self, leave=None, timeout=30.0):
        """End every rank: ``close`` over the channel, then run `leave`
        (this process's side of the group's shutdown, which the ranks run
        as they close) unless a rank has failed, join, terminate (then
        kill) what is still alive; after a failure the others may wait in
        a collective, so they get 2 s. Idempotent."""
        if self.failed is not None:
            timeout = min(timeout, 2.0)
        for conn in self.conns:
            try:
                conn.send(("close", (), False))
            except (BrokenPipeError, OSError):
                pass
        if leave is not None and self.conns and self.failed is None:
            leave()
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        for conn in self.conns:
            conn.close()
        self.conns, self.procs = [], []
        shutil.rmtree(self.workdir, ignore_errors=True)

    def alive(self):
        """The rank processes still running."""
        return [p for p in self.procs if p.is_alive()]


# -- the rank's side ---------------------------------------------------------


def rank_main(smesh, store, spec, conn):
    """A rank process's entry point: clear the engine's environment
    switches (the controller passes every value resolved), join the data
    plane, build this rank's engine over the model's skeleton (`spec`:
    ``skeleton``, ``engine_kw``, ``num_threads``, ``tf32``), report ready
    and serve the channel until ``close`` or EOF. Any exception is sent to
    the controller and ends the process. A rank ignores SIGINT."""
    # a terminal's interrupt reaches the whole process group: the
    # controller ends its ranks itself, in order
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    try:
        for k in [k for k in os.environ if k.startswith("PADDLE_TPU_")]:
            del os.environ[k]
        if spec.get("num_threads"):
            torch.set_num_threads(int(spec["num_threads"]))
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = spec["tf32"]
        if smesh.device_type == "cuda":
            torch.cuda.set_device(smesh.device)
        conn.send(("hello", smesh.rank))
        smesh.group = join_group(smesh, store)
        from .engine import LLMEngine

        engine = LLMEngine(spec["skeleton"], device=smesh.device, mesh=smesh,
                           **spec["engine_kw"])
        conn.send(("ready", rank_report(engine)))
        _serve(engine, conn)
    except (EOFError, BrokenPipeError):
        os._exit(0)        # the controller is gone
    except BaseException:  # noqa: BLE001 — every failure goes to rank 0
        try:
            conn.send(("error", traceback.format_exc()))
        finally:
            os._exit(1)
    os._exit(0)


def _serve(engine, conn):
    """Apply the controller's operations in order until ``close``."""
    while True:
        op, args, reply = conn.recv()
        if op == "close":
            engine.close()
            return
        with engine.device_scope():
            out = _OPS[op](engine, *args)
        if reply:
            conn.send(("ok", out))


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

__all__ = ["RankFailed", "RankSet", "join_group", "rank_main",
           "rank_report"]
