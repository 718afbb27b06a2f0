"""Ring attention over the ``sp`` axis (the JAX package's
`paddle_tpu/parallel/ring_attention.py`, in PyTorch's idiom: one rank a
device over `torch.distributed`).

The sequence is split over the ranks of an ``sp`` group: rank i holds
positions ``[i * S/n, (i + 1) * S/n)`` of q, k and v (``[B, S/n, H,
D]``). K/V blocks travel around the ring (rank i sends to i + 1 and
receives from i - 1) while each rank merges its queries' attention over
every block it holds; after n - 1 hops every rank has seen every block.
The JAX ring is plain XLA (an online softmax over einsums, no Pallas);
here each block is one launch of the hand-written flash kernels
(ops/flash_attention.py), which give the block's O and log-sum-exp:

- **forward**: `flash_attention_fwd` on block j, causal on the diagonal
  (j = i: equal lengths, so the kernels' bottom-right alignment is the
  JAX mask ``qpos >= kpos``), in full below it (j < i), and no launch
  above it (j > i), where every JAX score is masked and the block adds
  exactly 0. Each ``(o_j, lse_j)`` is merged into a running float32
  ``(o, lse)`` by the log-sum-exp rule;
- **backward**: `flash_attention_bwd` on each block the forward launched,
  with the merged float32 O and the row's whole LSE, so delta and P are
  the whole row's: the block's dQ adds to the rank's, and its dK / dV
  partials (float32) travel around the ring with K and V and arrive home
  after the n-th hop.

A hop is one counted `send`, posted, then one counted `recv_`
(parallel/collectives.py) of one byte buffer: K and V in the forward; K,
V and the dK / dV partials in the backward, the last hop the partials
alone. A layer makes n - 1 hops forward and n backward (`ring_hops`).

On a CPU tensor the same loop runs over the plain versions
(`attention_ref`, `attention_lse_ref`, `attention_bwd_ref`): the device
chooses, as everywhere in the port, and nothing falls back. There is no
attention dropout: the JAX ring takes none. With no group, or a group of
one rank, it is `flash_attention` (the JAX ring's fallback,
`_attention_xla`).

The per-step arithmetic (`forward_step`, `backward_step`) and a rank's
walk over the blocks it is handed (`rank_forward`, `rank_backward`)
stand alone, so the n steps of a ring run in one process without ranks.
"""
from __future__ import annotations

import torch

from ..ops.flash_attention import (attention_bwd_ref, attention_lse_ref,
                                   attention_ref, flash_attention,
                                   flash_attention_bwd, flash_attention_fwd)
from .collectives import recv_, send

_ALIGN = 16          # bytes: the flash kernels read 16-byte aligned rows


def ring_hops(n):
    """(forward, backward) hops of one ring attention over `n` ranks: each
    hop one send and one receive on every rank."""
    n = int(n)
    return (n - 1, n) if n > 1 else (0, 0)


def block_causality(rank, src, causal):
    """How rank `rank`'s queries attend the K/V block of rank `src`: True
    (the causal diagonal), False (in full), or None (not at all: above the
    diagonal of a causal ring)."""
    if not causal:
        return False
    if src == rank:
        return True
    return False if src < rank else None


def _device_check(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ring attention for device {q.device}")


def forward_step(q, k, v, causal, o=None, lse=None):
    """One ring step's forward: attention of `q` over the block (`k`,
    `v`) (the flash forward kernel on a CUDA tensor, the plain version on
    a CPU one), merged into the running float32 ``o`` [B, Sq, H, D] and
    ``lse`` [B*H, Sq] (None: the first block). Returns the merged pair."""
    _device_check(q)
    if q.device.type == "cuda":
        o_j, lse_j = flash_attention_fwd(q, k, v, causal)
    else:
        o_j = attention_ref(q, k, v, causal)
        lse_j = attention_lse_ref(q, k, causal)
    o_j = o_j.float()
    if o is None:
        return o_j, lse_j
    B, Sq, H, _ = q.shape
    new = torch.logaddexp(lse, lse_j)

    def weight(x):
        return torch.exp(x - new).view(B, H, Sq).transpose(1, 2)[..., None]

    return o * weight(lse) + o_j * weight(lse_j), new


def backward_step(q, k, v, o, do, lse, causal):
    """One ring step's backward: the block's (dq, dk, dv) in q's dtype
    from the merged float32 `o` and the whole row's `lse` (the flash
    backward kernels on a CUDA tensor, the plain version on a CPU
    one)."""
    _device_check(q)
    if q.device.type == "cuda":
        return flash_attention_bwd(q, k, v, o, do, lse, causal)
    return attention_bwd_ref(q, k, v, o, do, lse, causal)


def rank_forward(q, blocks, rank, causal):
    """Rank `rank`'s forward over `blocks` (``[(k_j, v_j)]`` by source
    rank) in the order its ring brings them: the merged float32 ``(o,
    lse)``."""
    n, o, lse = len(blocks), None, None
    for t in range(n):
        src = (rank - t) % n
        kind = block_causality(rank, src, causal)
        if kind is not None:
            o, lse = forward_step(q, *blocks[src], kind, o, lse)
    return o, lse


def rank_backward(q, blocks, o, do, lse, rank, causal):
    """Rank `rank`'s backward over `blocks` in its ring's order, from its
    merged ``(o, lse)``: ``(dq, {src: (dk, dv)})``, dq float32 and each
    launched block's dK / dV partial in q's dtype."""
    n = len(blocks)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    parts = {}
    for t in range(n):
        src = (rank - t) % n
        kind = block_causality(rank, src, causal)
        if kind is not None:
            g = backward_step(q, *blocks[src], o, do, lse, kind)
            dq += g[0]
            parts[src] = (g[1], g[2])
    return dq, parts


# -- a hop's buffer ------------------------------------------------------------


def _layout(tensors):
    """``([(shape, dtype, offset, nbytes)], total bytes)`` of `tensors`
    packed one after another, each part starting 16-byte aligned."""
    out, off = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        out.append((tuple(t.shape), t.dtype, off, n))
        off += -(-n // _ALIGN) * _ALIGN
    return out, off


def _pack(tensors, layout):
    buf = torch.empty(layout[1], dtype=torch.uint8,
                      device=tensors[0].device)
    for t, (_, _, off, n) in zip(tensors, layout[0]):
        buf[off:off + n].copy_(t.contiguous().reshape(-1).view(torch.uint8))
    return buf


def _unpack(buf, layout):
    """Views of `buf`'s parts, in their shapes and dtypes."""
    return [buf[off:off + n].view(dtype).view(shape)
            for shape, dtype, off, n in layout[0]]


def _hop(buf, group):
    """One hop: post `buf` to the next rank, receive the previous rank's
    buffer of the same size, wait for the send. Returns what came."""
    n, i = group.size, group.rank
    pending = send(buf, (i + 1) % n, group)
    got = recv_(torch.empty_like(buf), (i - 1) % n, group)
    pending.wait()
    return got


class _RingAttention(torch.autograd.Function):
    """Ring attention over `group`'s ranks (the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        n, i = group.size, group.rank
        layout = _layout([k, v])
        buf = _pack([k, v], layout)
        o = lse = None
        for t in range(n):
            pending = (send(buf, (i + 1) % n, group) if t < n - 1
                       else None)
            kind = block_causality(i, (i - t) % n, causal)
            if kind is not None:
                o, lse = forward_step(q, *_unpack(buf, layout), kind, o,
                                      lse)
            if pending is not None:
                # the block's launch runs on the card meanwhile
                nxt = recv_(torch.empty_like(buf), (i - 1) % n, group)
                pending.wait()
                buf = nxt
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal = group, causal
        return o.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, i = group.size, group.rank
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
               for _ in range(2)]
        layout = _layout([k, v] + acc)
        buf = _pack([k, v] + acc, layout)
        for t in range(n):
            kb, vb, dkb, dvb = _unpack(buf, layout)
            kind = block_causality(i, (i - t) % n, causal)
            if kind is not None:
                g = backward_step(q, kb, vb, o, do, lse, kind)
                dq += g[0]
                dkb += g[1]
                dvb += g[2]
            if t < n - 1:
                buf = _hop(buf, group)
        # the last hop takes each block's partials home
        home = _layout([dkb, dvb])
        dk, dv = _unpack(_hop(_pack([dkb, dvb], home), group), home)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None)


def ring_attention(q, k, v, group=None, causal=False):
    """Attention of this rank's ``[B, S/n, H, D]`` slices of q, k and v
    over the whole sequence split across `group`'s n ranks in rank order
    (a `parallel.collectives.RankGroup`, the mesh's ``sp`` group): this
    rank's ``[B, S/n, H, D]`` output slice, differentiable in q, k and v.
    Every rank of the group calls it together. With no group or a group
    of one, `flash_attention(q, k, v, causal)`."""
    if group is None or group.size == 1:
        return flash_attention(q, k, v, causal)
    _device_check(q)
    return _RingAttention.apply(q, k, v, group, bool(causal))


__all__ = ["backward_step", "block_causality", "forward_step",
           "rank_backward", "rank_forward", "ring_attention", "ring_hops"]
