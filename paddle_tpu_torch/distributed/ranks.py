"""Rank processes driven by one controller, shared by tensor-parallel
serving (serving/tp_worker.py) and data-parallel training
(parallel/spmd.py).

The JAX package drives a device mesh from one process; PyTorch runs one
rank a device. The port keeps the one controller: the caller's process is
rank 0, and a mesh of N ranks starts N - 1 rank processes with the
``spawn`` start method (never ``fork``: the caller may hold CUDA or other
runtime threads). Each rank builds what its user asks for (an engine, a
training replica) and then loops on its channel, applying the
controller's operations in the controller's order.

**The mesh rules** (`RankMesh`): one rank a device, every device of one
kind. The data plane is NCCL when the devices are distinct CUDA devices
and gloo for CPU ranks. A device list that names one CUDA device more than
once runs only over an explicit ``backend="gloo"``: NCCL refuses two ranks
on one device, and no code here swaps NCCL for gloo on its own. Its
collectives are staged through host memory (parallel/collectives.py).

**The channel** is one duplex pipe a rank, on the host, whatever the data
plane. A rank blocks in ``recv`` while the controller idles, with no
timeout to expire, and sees EOF, and exits, when the controller's process
ends. Tensors move over the data plane only; the pipes carry small
arguments and replies.

**Failure.** A rank that raises sends its traceback and exits. Its peers'
next collective then fails (a gloo peer sees the closed connection), and
the controller raises `RankFailed` with the rank's traceback, from the
operation that met it or from the next one (`RankSet.check`). Nothing
catches a rank's failure and carries on: the rank set never runs an
operation again. `RankSet.close` ends every rank (``close`` first, then
terminate after a timeout); nothing outlives it.
"""
from __future__ import annotations

import copy
import datetime
import multiprocessing
import os
import shutil
import signal
import tempfile
import time
import traceback

import torch


class RankFailed(RuntimeError):
    """A rank raised or died; what it served cannot run again. ``rank`` is
    its index, ``detail`` its traceback or exit code."""

    fatal = True

    def __init__(self, rank, detail):
        super().__init__(f"rank {rank} failed: {detail}")
        self.rank = rank
        self.detail = detail


class RankMesh:
    """One rank a device, over ``len(devices)`` ranks.

    `devices` lists each rank's device in rank order. `backend` is the
    data plane ("nccl" or "gloo"); None picks NCCL for distinct CUDA
    devices and gloo for CPU ranks. A CUDA device named twice needs an
    explicit ``backend="gloo"`` (module docstring). `timeout` bounds each
    collective. `group` is this process's
    `parallel.collectives.RankGroup` once the ranks have started, and
    `rank` its index (0 in the controller's process)."""

    def __init__(self, devices, backend=None, timeout=1800.0):
        self.devices = [torch.device(d) for d in devices]
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(
                f"a mesh runs on CPU ranks or CUDA devices, one kind; got "
                f"{[str(d) for d in self.devices]}")
        self.device_type = kinds.pop()
        cuda = self.device_type == "cuda"
        self.devices = [torch.device("cuda", d.index or 0) if cuda else d
                        for d in self.devices]
        repeated = cuda and len(set(self.devices)) < len(self.devices)
        if backend is None and not repeated:
            backend = "nccl" if cuda else "gloo"
        if backend not in ("nccl", "gloo"):
            if backend is not None:
                raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
        if backend != "gloo" and (not cuda or repeated):
            raise ValueError(
                "NCCL needs one distinct CUDA device a rank; a device list "
                f"{[str(d) for d in self.devices]} that names a device "
                "twice runs only over an explicit backend='gloo'")
        self.backend = backend
        self.timeout = float(timeout)
        self.group = None
        self.rank = 0

    @property
    def size(self):
        """The number of ranks."""
        return len(self.devices)

    @property
    def device(self):
        """This rank's device."""
        return self.devices[self.rank]

    def for_rank(self, rank):
        """A copy of this mesh description as rank `rank` sees it (no
        group yet)."""
        other = copy.copy(self)
        other.rank, other.group = int(rank), None
        return other

    def timedelta(self):
        return datetime.timedelta(seconds=self.timeout)


def join_group(mesh, store_path):
    """This process's `RankGroup` on the mesh's data plane: a process
    group built straight on a file store (no default group, no TCP
    rendezvous), with the mesh's timeout. Every rank calls it at start-up;
    it returns once the group is connected (gloo connects in its
    constructor; NCCL builds its communicator at its first collective, so
    one all-reduce of one element is made here, while every rank is in
    this call). A training mesh with axes (distributed/mesh.py) also gets
    this rank's group along each axis in ``mesh.groups``."""
    import torch.distributed as dist

    from ..parallel.collectives import RankGroup

    store = dist.FileStore(store_path, mesh.size)
    world = RankGroup(_process_group(mesh, store, mesh.rank, mesh.size),
                      mesh.rank, mesh.size, mesh.backend)
    # a hybrid mesh's axis groups (distributed/mesh.py): every rank walks
    # every group in one order and joins its own, on its own store prefix
    for axis, lists in getattr(mesh, "group_lists", dict)().items():
        for i, members in enumerate(lists):
            if mesh.rank in members:
                sub = dist.PrefixStore(f"{axis}/{i}", store)
                r = members.index(mesh.rank)
                mesh.groups[axis] = RankGroup(
                    _process_group(mesh, sub, r, len(members)), r,
                    len(members), mesh.backend)
    return world


def _process_group(mesh, store, rank, size):
    """A gloo or NCCL process group of `size` ranks on `store`, with the
    mesh's timeout (NCCL's communicator built here by one all-reduce)."""
    import torch.distributed as dist

    if mesh.backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = mesh.timedelta()
        pg = dist.ProcessGroupNCCL(store, rank, size, opts)
        pg.allreduce([torch.ones(1, device=mesh.device)]).wait()
        torch.cuda.synchronize(mesh.device)
        return pg
    return dist.ProcessGroupGloo(store, rank, size, mesh.timedelta())


def leave_group(mesh):
    """Shut this rank's side of an NCCL group down, as every rank does at
    the same time when what it serves closes (a group left to its
    destructor after its peers have gone aborts alone and can hang the
    process's exit). Gloo groups need nothing. Idempotent."""
    group = mesh.group
    if group is None or group.backend != "nccl" or group.pg is None:
        return
    torch.cuda.synchronize(mesh.device)
    for sub in getattr(mesh, "groups", {}).values():
        sub.shutdown()
    group.shutdown()


class RankSet:
    """The controller's end of the channel: one process and one pipe per
    rank 1 .. N-1 (rank order)."""

    def __init__(self, procs, conns, workdir):
        self.procs = procs
        self.conns = conns
        self.workdir = workdir
        self.failed = None        # the RankFailed once a rank failed

    @classmethod
    def start(cls, mesh, target, spec, hello_timeout=300.0, name="rank"):
        """Spawn ranks 1 .. N-1, each running ``target(mesh.for_rank(r),
        store, spec, conn)`` (a module-level function that calls
        `rank_loop`), wait until each has imported the port, then join the
        data plane as rank 0 (which returns once every rank has joined)."""
        ctx = multiprocessing.get_context("spawn")
        workdir = tempfile.mkdtemp(prefix="paddle-ranks-")
        store = os.path.join(workdir, "store")
        procs, conns = [], []
        ranks = cls(procs, conns, workdir)
        try:
            for r in range(1, mesh.size):
                mine, theirs = ctx.Pipe()
                p = ctx.Process(target=target,
                                args=(mesh.for_rank(r), store, spec, theirs),
                                name=f"paddle-{name}{r}", daemon=True)
                p.start()
                theirs.close()
                procs.append(p)
                conns.append(mine)
            for r in range(1, mesh.size):
                ranks._expect(r, "hello", hello_timeout)
            mesh.group = join_group(mesh, store)
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

    def post(self, op, *args, per_rank=None, reply=False):
        """Run `op(*args)` on every rank, in order after everything posted
        before; with `per_rank` (one value a rank, 1 .. N-1) each rank's
        value is its last argument. With `reply`, `collect` reads the
        results."""
        self._live()
        for r, conn in enumerate(self.conns, start=1):
            full = args if per_rank is None else args + (per_rank[r - 1],)
            try:
                conn.send((op, full, reply))
            except (BrokenPipeError, OSError):
                self._recv(r, timeout=5.0)   # raises with the rank's error
                raise
        return None

    def collect(self):
        """The results of the last `post(..., reply=True)`, rank order."""
        return [self._expect(r, "ok") for r in range(1, 1 + len(self.conns))]

    def send(self, op, *args):
        """Run `op(*args)` on every rank, in order after everything sent
        before; no reply."""
        return self.post(op, *args)

    def call(self, op, *args):
        """Run `op(*args)` on every rank and return their results in rank
        order (1 .. N-1)."""
        self.post(op, *args, reply=True)
        return self.collect()

    def wait_ready(self):
        """Each rank's report once it has built what it serves (rank
        order)."""
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
        """After `exc` escaped an operation the ranks were told of: raise
        the failed rank's RankFailed (from `exc`), or, when none reports a
        failure within 5 s, rank 0's own: the other ranks may wait inside
        a collective rank 0 never reached, so nothing can run on them
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


def rank_loop(mesh, store, spec, conn, build, ops, finish, scope=None):
    """A rank process's body: clear the port's environment switches (the
    controller passes every value resolved), take `spec`'s ``num_threads``
    and ``tf32``, join the data plane, run ``build()`` (returning the
    object the ops act on and the ready report), report ready and apply
    the channel's operations (``ops[op](obj, *args)``, inside
    ``scope(obj)`` when given) until ``close`` (which runs
    ``finish(obj)``) or EOF. Any exception is sent to the controller and
    ends the process. A rank ignores SIGINT: a terminal's interrupt
    reaches the whole process group, and the controller ends its ranks
    itself, in order."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    try:
        for k in [k for k in os.environ if k.startswith("PADDLE_TPU_")]:
            del os.environ[k]
        if spec.get("num_threads"):
            torch.set_num_threads(int(spec["num_threads"]))
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = spec["tf32"]
        if mesh.device_type == "cuda":
            torch.cuda.set_device(mesh.device)
        conn.send(("hello", mesh.rank))
        mesh.group = join_group(mesh, store)
        obj, report = build()
        conn.send(("ready", report))
        while True:
            op, args, reply = conn.recv()
            if op == "close":
                finish(obj)
                break
            if scope is None:
                out = ops[op](obj, *args)
            else:
                with scope(obj):
                    out = ops[op](obj, *args)
            if reply:
                conn.send(("ok", out))
    except (EOFError, BrokenPipeError):
        os._exit(0)        # the controller is gone
    except BaseException:  # noqa: BLE001 — every failure goes to rank 0
        try:
            conn.send(("error", traceback.format_exc()))
        finally:
            os._exit(1)
    os._exit(0)


def rank_spec(device_type):
    """The process settings every rank takes from the controller: one CPU
    thread a rank on the CPU (the ranks share one host), and this
    process's TF32 switches (float32 products as the controller computes
    them)."""
    return {"num_threads": 1 if device_type == "cpu" else None,
            "tf32": (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)}


__all__ = ["RankFailed", "RankMesh", "RankSet", "join_group", "leave_group",
           "rank_loop", "rank_spec"]
