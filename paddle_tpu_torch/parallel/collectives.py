"""Cross-rank collectives of tensor-parallel serving, counted, and the
EQuARX int8 all-reduce (the JAX package's `parallel/collectives.py`, in
PyTorch's idiom: one rank a process over `torch.distributed`).

`TPGroup` is one rank's handle on the data plane: a c10d process group
built straight on a store (never the default group, so one process can
hold the groups of several engines), this rank's index and the group's
size. NCCL runs on CUDA tensors as they are; gloo takes host tensors, so
on a CUDA tensor its calls stage through host memory, which also makes
them synchronous (gloo cannot be captured in a CUDA graph).

`all_reduce` and `all_gather` are the only collectives a serving step
makes. Each call adds one to its counter (``all_reduce.calls``,
``all_gather.calls``) through `ops/counts.py`, so a captured graph's
replays count as its launches do and a step's calls can be held against
`serving/sharded.serving_collective_budget`.

EQuARX (arXiv:2506.17615): the payload of a dense-activation collective
tolerates int8 when each shard's contribution is quantized once with its
own scale and the reduction accumulates in float32, so error never
compounds across shards. `quantized_allgather_sum` moves the int8 payload
and the float32 scale through two all-gathers in place of one float32
all-reduce. (`quantized_psum_scatter`, the training half, is not ported
yet.)
"""
from __future__ import annotations

import torch

from ..ops import counts


class TPGroup:
    """This rank's view of a tensor-parallel process group.

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

    def _staged(self, t):
        """Whether `t` must pass through host memory (gloo on CUDA)."""
        return self.backend == "gloo" and t.device.type != "cpu"

    def all_reduce_(self, t):
        """Sum `t` over the ranks, in place."""
        buf = t.cpu() if self._staged(t) else t
        self.pg.allreduce([buf]).wait()
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

    def send(self, t, dst):
        """Point-to-point `t` to rank `dst` (weight placement)."""
        buf = t.contiguous().cpu() if self._staged(t) else t.contiguous()
        self.pg.send([buf], int(dst), 0).wait()

    def recv_(self, t, src):
        """Receive into `t` from rank `src`, in place."""
        buf = torch.empty(t.shape, dtype=t.dtype) if self._staged(t) else t
        self.pg.recv([buf], int(src), 0).wait()
        if buf is not t:
            t.copy_(buf)
        return t


def all_reduce(t, group):
    """Sum `t` over `group`'s ranks in place (one counted call)."""
    counts.tick(all_reduce, "calls")
    return group.all_reduce_(t)


all_reduce.calls = 0


def all_gather(t, group):
    """``[size, *t.shape]``: every rank's `t` in rank order (one counted
    call)."""
    counts.tick(all_gather, "calls")
    return group.all_gather(t)


all_gather.calls = 0


def collective_counts():
    """{"all-reduce": n, "all-gather": n}: the calls counted so far, in
    `serving_collective_budget`'s names."""
    return {"all-reduce": all_reduce.calls, "all-gather": all_gather.calls}


def reset_collective_counts():
    all_reduce.calls = 0
    all_gather.calls = 0


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
