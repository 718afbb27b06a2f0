"""Cross-rank collectives of the port, counted, and the EQuARX int8
collectives (the JAX package's `parallel/collectives.py`, in PyTorch's
idiom: one rank a process over `torch.distributed`).

`RankGroup` is one rank's handle on the data plane: a c10d process group
built straight on a store (never the default group, so one process can
hold the groups of several engines or training steps), this rank's index
and the group's size. NCCL runs on CUDA tensors as they are; gloo takes
host tensors, so on a CUDA tensor its calls stage through host memory,
which also makes them synchronous (gloo cannot be captured in a CUDA
graph).

A serving step makes `all_reduce` and `all_gather` calls; a data-parallel
training step (parallel/spmd.py) adds `reduce_scatter` and `all_to_all`;
a pipeline (parallel/pipeline.py) hands activations and their gradients
from stage to stage with `send` and `recv_`, point to point (posted sends,
so a stage can post one and go on to its next receive; through the host
under gloo, card to card under NCCL);
a tensor-parallel (``mp``) training step all-reduces with SUM and MAX (the
vocab-parallel softmax) over its mp group. Any of them takes any group:
the world of a mesh's ranks, or one of its axis groups (`mp`, `dp`,
`sharding`; distributed/mesh.py).
Each call adds one to its counter (``all_reduce.calls`` and so on)
through `ops/counts.py`, so a captured graph's replays count as its
launches do and a step's calls can be held against
`serving/sharded.serving_collective_budget` or
`parallel/spmd.train_collective_budget`.

EQuARX (arXiv:2506.17615): the payload of a dense-activation or gradient
collective tolerates int8 when each shard's contribution is quantized
once with its own scale and the reduction accumulates in float32, so
error never compounds across shards. `quantized_allgather_sum` moves the
int8 payload and the float32 scale through two all-gathers in place of
one float32 all-reduce (serving's row-parallel projection);
`quantized_psum_scatter` moves them through two all-to-alls in place of
one float32 reduce-scatter (training's gradient reduction).
"""
from __future__ import annotations

import torch

from ..ops import counts


class RankGroup:
    """This rank's view of a process group (tensor- or data-parallel).

    ``pg`` is a ``ProcessGroupGloo`` or ``ProcessGroupNCCL`` over ``size``
    ranks; ``backend`` names it ("gloo" or "nccl")."""

    def __init__(self, pg, rank, size, backend):
        self.pg = pg
        self.rank = int(rank)
        self.size = int(size)
        self.backend = backend

    def shutdown(self):
        """Release this rank's communicators; the group makes no call
        after it. Every rank of an NCCL group shuts down together, while
        all are alive (serving/engine.py `_leave_group`)."""
        pg, self.pg = self.pg, None
        if pg is not None:
            pg.shutdown()

    def barrier(self, device):
        """Return once every rank of the group has called it: one
        uncounted all-reduce of one element on `device`."""
        self.all_reduce_(torch.zeros(1, device=device))

    def _staged(self, t):
        """Whether `t` must pass through host memory (gloo on CUDA)."""
        return self.backend == "gloo" and t.device.type != "cpu"

    def all_reduce_(self, t, op="sum"):
        """Reduce `t` over the ranks in place: the sum, or with ``op="max"``
        the elementwise maximum."""
        import torch.distributed as dist

        buf = t.cpu() if self._staged(t) else t
        opts = dist.AllreduceOptions()
        opts.reduceOp = {"sum": dist.ReduceOp.SUM,
                         "max": dist.ReduceOp.MAX}[op]
        self.pg.allreduce([buf], opts).wait()
        if buf is not t:
            t.copy_(buf)
        return t

    def all_gather(self, t):
        """Every rank's `t`, stacked in rank order: ``[size, *t.shape]``
        (one flat all-gather into one buffer: no per-rank outputs to copy
        out, which a captured NCCL call would have to)."""
        src = t.contiguous().reshape(-1)
        if self._staged(src):
            src = src.cpu()
        out = torch.empty(self.size * src.numel(), dtype=src.dtype,
                          device=src.device)
        self.pg._allgather_base(out, src).wait()
        out = out.view((self.size,) + tuple(t.shape))
        return out.to(t.device) if out.device != t.device else out

    def reduce_scatter(self, flat):
        """This rank's ``[n / size]`` chunk of the sum over the ranks of
        the flat ``[n]`` tensor `flat` (n divisible by the size), in its
        own dtype."""
        src = flat.contiguous()
        if self._staged(src):
            src = src.cpu()
        out = torch.empty(src.numel() // self.size, dtype=src.dtype,
                          device=src.device)
        self.pg._reduce_scatter_base(out, src).wait()
        return out.to(flat.device) if out.device != flat.device else out

    def all_to_all(self, t):
        """`t`'s rows ``t[j]`` (``t`` is ``[size, ...]``) sent to rank j;
        returns the ``[size, ...]`` rows every rank sent here, in rank
        order."""
        src = t.contiguous()
        if self._staged(src):
            src = src.cpu()
        out = torch.empty_like(src)
        self.pg.alltoall_base(out, src, [], []).wait()
        return out.to(t.device) if out.device != t.device else out

    def send(self, t, dst, tag=0, wait=True):
        """Point-to-point `t` to rank `dst` under `tag`. With `wait` False
        the send is posted and a `Pending` is returned: its ``wait()``
        ends it (the staged copy lives until then), so a rank can post a
        send and go on to its next receive."""
        buf = t.contiguous().cpu() if self._staged(t) else t.contiguous()
        work = self.pg.send([buf], int(dst), int(tag))
        if not wait:
            return Pending(work, buf)
        work.wait()
        return None

    def recv_(self, t, src, tag=0):
        """Receive into `t` from rank `src` under `tag`, in place."""
        buf = torch.empty(t.shape, dtype=t.dtype) if self._staged(t) else t
        self.pg.recv([buf], int(src), int(tag)).wait()
        if buf is not t:
            t.copy_(buf)
        return t


class Pending:
    """A posted send: ``wait()`` blocks until it has gone (and holds its
    buffer until then)."""

    def __init__(self, work, buf):
        self.work = work
        self.buf = buf

    def wait(self):
        if self.work is not None:
            self.work.wait()
            self.work = self.buf = None


def all_reduce(t, group, op="sum"):
    """Sum (or with ``op="max"`` the maximum of) `t` over `group`'s ranks,
    in place (one counted call)."""
    counts.tick(all_reduce, "calls")
    return group.all_reduce_(t, op)


all_reduce.calls = 0


def all_gather(t, group):
    """``[size, *t.shape]``: every rank's `t` in rank order (one counted
    call)."""
    counts.tick(all_gather, "calls")
    return group.all_gather(t)


all_gather.calls = 0


def reduce_scatter(flat, group):
    """This rank's chunk of the sum of the flat `flat` over `group`'s ranks
    (one counted call)."""
    counts.tick(reduce_scatter, "calls")
    return group.reduce_scatter(flat)


reduce_scatter.calls = 0


def all_to_all(t, group):
    """Row j of ``[size, ...]`` `t` to rank j; the rows every rank sent
    here, in rank order (one counted call)."""
    counts.tick(all_to_all, "calls")
    return group.all_to_all(t)


all_to_all.calls = 0

def send(t, dst, group, tag=0):
    """Post `t` to rank `dst` of `group` (one counted call; a pipeline's
    stage-to-stage hand-off). Returns the `Pending` send: the caller
    waits on it before the step ends."""
    counts.tick(send, "calls")
    return group.send(t, dst, tag, wait=False)


send.calls = 0


def recv_(t, src, group, tag=0):
    """Receive into `t` from rank `src` of `group` (one counted call)."""
    counts.tick(recv_, "calls")
    return group.recv_(t, src, tag)


recv_.calls = 0

_COUNTED = {"all-reduce": all_reduce, "all-gather": all_gather,
            "reduce-scatter": reduce_scatter, "all-to-all": all_to_all,
            "send": send, "recv": recv_}


def collective_counts():
    """{"all-reduce": n, "all-gather": n, "reduce-scatter": n,
    "all-to-all": n, "send": n, "recv": n}: the calls counted so far, in
    the collective budgets' names."""
    return {name: fn.calls for name, fn in _COUNTED.items()}


def reset_collective_counts():
    for fn in _COUNTED.values():
        fn.calls = 0


def absmax_quantize(x, axis=None):
    """Symmetric int8 quantization with an absmax/127 scale.

    ``axis=None``: one scalar scale for the whole tensor (serving's
    per-shard partial sum); ``axis=k``: one scale per slice along every
    other axis. Returns ``(q, scale)``, ``q`` int8 and ``scale`` float32
    shaped like `x` reduced over `axis`. Bit for bit the JAX function:
    ``torch.round`` rounds half to even as ``jnp.round`` does."""
    xf = x.float()
    if axis is None:
        sc = torch.clamp(xf.abs().amax() / 127.0, min=1e-12)
        q = torch.clamp(torch.round(xf / sc), -127, 127).to(torch.int8)
        return q, sc
    sc = torch.clamp(xf.abs().amax(dim=axis, keepdim=True) / 127.0,
                     min=1e-12)
    q = torch.clamp(torch.round(xf / sc), -127, 127).to(torch.int8)
    return q, sc.squeeze(axis)


def quantized_allgather_sum(part, group):
    """Sum per-rank float32 partials over `group` with an int8 wire:
    quantize the local partial with one scalar scale, all-gather payload
    and scale (the two gathers `serving_collective_budget` counts per
    quantized projection), dequantize and sum in float32."""
    q, sc = absmax_quantize(part)
    qg = all_gather(q, group)                  # [size, ...] int8
    sg = all_gather(sc.reshape(1), group)      # [size, 1] float32
    return torch.tensordot(sg[:, 0], qg.float(), dims=([0], [0]))


def quantized_psum_scatter(flat, group):
    """Reduce-scatter the flat float32 ``[n]`` `flat` over `group` (n
    divisible by the size) with an int8 wire: the gradient-reduction half
    of ZeRO weight-update sharding with EQuARX's recipe.

    Each rank cuts its contribution into ``size`` destination chunks,
    quantizes each chunk with its own absmax scale, and trades chunks
    through two all-to-alls (int8 payload, float32 scales: the pair
    `train_collective_budget` counts in place of the leaf's
    reduce-scatter). The receiving rank dequantizes the ``size``
    contributions and sums them in float32 in rank order, so each is
    rounded once whatever the degree. Returns this rank's reduced ``[n /
    size]`` chunk."""
    ch = flat.reshape(group.size, -1)              # [ranks, chunk]
    q, sc = absmax_quantize(ch, axis=1)            # int8, float32 [ranks]
    qx = all_to_all(q, group)
    sx = all_to_all(sc, group)
    out = qx[0].float() * sx[0]
    for j in range(1, group.size):
        out = out + qx[j].float() * sx[j]
    return out


# the name serving and its tests use
TPGroup = RankGroup
