"""Sequence-parallel attention by gathering K/V over the ``sp`` group.

What JAX's GSPMD step gives a model whose input is split over ``sp``
(``P("dp", "sp")``) and whose attention is not a ring: attention of each
rank's queries over the whole sequence. Rank r of n holds positions ``[r
L, (r + 1) L)`` (``L = S / n``) of q, k and v (``[B, L, H, D]``):

- **forward**: one counted `all_gather` (parallel/collectives.py) of a
  buffer packing the rank's K and V sequence-major, ``[L, B, 2, H, D]``,
  so the gathered ``[S, B, 2, H, D]`` holds the whole sequence's K and V
  as two strided ``[B, S, H, D]`` views the kernels read in place. Then
  one `flash_attention_fwd` of the rank's queries over the keys they
  need: all S, or under causal masking the prefix ``[0, (r + 1) L)``,
  where the kernels' bottom-right diagonal ``i + (Sk - Sq) >= j`` sits at
  the absolute row ``r L + i`` and no key block above it is visited.
  Attention dropout draws the whole sequence's keep bits for the rank's
  rows (``q_row0 = r L``, ops/flash_attention.py) and the model's heads
  (``head_offset``, ``heads_total``).
- **backward**: one `flash_attention_bwd` gives the rank's dQ and the
  dK / dV partials of every key it attended, written by the dK/dV kernel
  straight into a ``[S, B, 2, H, D]`` buffer (zero past a causal prefix);
  one counted `reduce_scatter` of that buffer gives each rank the sum of
  every rank's partials for its own keys. The sum is taken in float32:
  each bf16 partial is rounded once by the kernel, then widened, summed
  by the reduce-scatter and rounded once more (the ring rounds its
  running bf16 partial at each of n hops).

A layer makes one all-gather forward and one reduce-scatter backward
(`gathered_calls`). The mask is the whole sequence's, broadcastable to
``[B, H, S, S]``: its key axis is cut to the keys the rank attends and its
query axis, where it has one, to the rank's rows; a mask that needs a
gradient is not taken. With no group, or a group of one, it is
`flash_attention`.

`rank_forward` and `rank_backward` are a rank's arithmetic on the whole
sequence's K and V, with no transport, so the n ranks of a group run in
one process. On a CPU tensor they run the plain versions
(`attention_ref`, `attention_lse_ref`, `attention_bwd_ref`): the device
chooses, as everywhere in the port, and nothing falls back.
"""
from __future__ import annotations

import torch

from ..ops.flash_attention import (_check_dropout, attention_bwd_ref,
                                   attention_lse_ref, attention_ref,
                                   flash_attention, flash_attention_bwd,
                                   flash_attention_fwd)
from .collectives import all_gather, reduce_scatter


def gathered_calls(n):
    """(all-gathers forward, reduce-scatters backward) of one gathered
    attention over `n` ranks."""
    return (1, 1) if int(n) > 1 else (0, 0)


def attended_keys(rank, rows, seq, causal):
    """How many keys, from the sequence's start, rank `rank`'s `rows`
    queries attend in a sequence of `seq`: the prefix up to its last row
    under causal masking, else all of them."""
    return (rank + 1) * rows if causal else seq


def _device_check(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no gathered attention for device {q.device}")


def rank_mask(mask, rank, rows, keys):
    """Rank `rank`'s share of the whole sequence's `mask` (None, or
    broadcastable to [B, H, S, S]): its query rows ``[rank * rows, (rank
    + 1) * rows)`` where the mask has a query axis, and its first `keys`
    keys where it has a key axis. A view, no copy."""
    if mask is None:
        return None
    if mask.dim() > 4:
        raise ValueError(f"mask must have at most 4 dims; got "
                         f"{tuple(mask.shape)}")
    m = mask.reshape((1,) * (4 - mask.dim()) + tuple(mask.shape))
    if m.shape[2] != 1:
        m = m.narrow(2, rank * rows, rows)
    if m.shape[3] != 1:
        m = m.narrow(3, 0, keys)
    return m


def rank_forward(q, k, v, rank, causal=False, mask=None, dropout_p=0.0,
                 seed=None, head_offset=0, heads_total=None, o32=None):
    """Rank `rank`'s forward: its queries `q` [B, L, H, D] (rows ``rank *
    L`` on) over the whole sequence's `k`, `v` [B, S, H, D] (strided
    views the kernels take), cut to the keys it attends
    (`attended_keys`); the flash forward kernel on a CUDA tensor, the
    plain version on a CPU one. Returns (o [B, L, H, D], lse [B*H, L]
    f32); `o32` as `flash_attention_fwd` takes it (CUDA, dropout)."""
    _device_check(q)
    rows = q.shape[1]
    keys = attended_keys(rank, rows, k.shape[1], causal)
    kp, vp = k[:, :keys], v[:, :keys]
    m = rank_mask(mask, rank, rows, keys)
    heads = dict(head_offset=head_offset, heads_total=heads_total,
                 q_row0=rank * rows)
    if q.device.type == "cuda":
        return flash_attention_fwd(q, kp, vp, causal, m, dropout_p, seed,
                                   o32, **heads)
    return (attention_ref(q, kp, vp, causal, m, dropout_p, seed, **heads),
            attention_lse_ref(q, kp, causal, m))


def rank_backward(q, k, v, o, do, lse, rank, causal=False, mask=None,
                  dropout_p=0.0, seed=None, head_offset=0, heads_total=None,
                  out=None):
    """Rank `rank`'s backward from its `o` and `lse` (`rank_forward`'s; o
    may be the f32 `o32`): (dq [B, L, H, D], dk, dv), dk and dv its
    partials for the keys it attended, [B, keys, H, D] in q's dtype,
    written into `out` (a (dk, dv) pair of such views) when given. The
    flash backward kernels on a CUDA tensor, the plain version on a CPU
    one."""
    _device_check(q)
    rows = q.shape[1]
    keys = attended_keys(rank, rows, k.shape[1], causal)
    kp, vp = k[:, :keys], v[:, :keys]
    m = rank_mask(mask, rank, rows, keys)
    args = (q, kp, vp, o, do, lse, causal, m, dropout_p, seed, head_offset,
            heads_total, rank * rows)
    if q.device.type == "cuda":
        return flash_attention_bwd(*args, out=out)
    dq, dk, dv = attention_bwd_ref(*args)
    if out is None:
        return dq, dk, dv
    out[0].copy_(dk)
    out[1].copy_(dv)
    return dq, out[0], out[1]


def _kv_views(whole):
    """The whole sequence's K and V, [B, S, H, D] strided views of the
    gathered ``[S, B, 2, H, D]`` buffer."""
    kv = whole.permute(1, 0, 2, 3, 4)
    return kv[:, :, 0], kv[:, :, 1]


class _GatheredAttention(torch.autograd.Function):
    """Gathered attention over `group`'s ranks (the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, group, causal, dropout_p, seed,
                head_offset, heads_total):
        n, r = group.size, group.rank
        B, L, H, D = k.shape
        mine = torch.empty((L, B, 2, H, D), dtype=k.dtype, device=k.device)
        mine[:, :, 0].copy_(k.transpose(0, 1))
        mine[:, :, 1].copy_(v.transpose(0, 1))
        whole = all_gather(mine, group).view(n * L, B, 2, H, D)
        kw, vw = _kv_views(whole)
        # with dropout in bf16, the backward's delta takes the f32 O
        o32 = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
               if dropout_p > 0.0 and q.dtype != torch.float32
               and q.device.type == "cuda" else None)
        o, lse = rank_forward(q, kw, vw, r, causal, mask, dropout_p, seed,
                              head_offset, heads_total, o32)
        ctx.save_for_backward(q, whole, o if o32 is None else o32, lse,
                              mask)
        ctx.group, ctx.causal = group, causal
        ctx.drop = (dropout_p, seed, head_offset, heads_total)
        return o

    @staticmethod
    def backward(ctx, do):
        q, whole, o, lse, mask = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, r = group.size, group.rank
        S, B, _, H, D = whole.shape
        L = S // n
        keys = attended_keys(r, L, S, causal)
        parts = (torch.zeros if keys < S else torch.empty)(
            (S, B, 2, H, D), dtype=q.dtype, device=q.device)
        dk_all, dv_all = _kv_views(parts)
        dq, _, _ = rank_backward(q, *_kv_views(whole), o, do.contiguous(),
                                 lse, r, causal, mask, *ctx.drop,
                                 out=(dk_all[:, :keys], dv_all[:, :keys]))
        # each owner's keys: every rank's partials summed in float32
        mine = reduce_scatter(parts.view(-1).float(), group).view(
            L, B, 2, H, D)
        dk, dv = _kv_views(mine)
        return (dq, dk.to(q.dtype), dv.to(q.dtype), None, None, None, None,
                None, None, None)


def gathered_attention(q, k, v, group=None, causal=False, mask=None,
                       dropout_p=0.0, seed=None, head_offset=0,
                       heads_total=None):
    """Attention of this rank's ``[B, S/n, H, D]`` slices of q, k and v
    over the whole sequence split across `group`'s n ranks in rank order
    (a `parallel.collectives.RankGroup`, the mesh's ``sp`` group): this
    rank's ``[B, S/n, H, D]`` output slice, differentiable in q, k and v.
    `mask` is the whole sequence's (module docstring); dropout
    (`dropout_p` > 0, with `seed`) draws the whole sequence's keep bits
    for this rank's rows, its heads numbered from `head_offset` of
    `heads_total`. Every rank of the group calls it together. With no
    group or a group of one, `flash_attention`."""
    if group is None or group.size == 1:
        return flash_attention(q, k, v, causal, mask, dropout_p, seed,
                               head_offset, heads_total)
    _device_check(q)
    _check_dropout(dropout_p, seed)
    if mask is not None and mask.requires_grad:
        raise ValueError("gathered attention takes no mask gradient: each "
                         "rank holds the whole sequence's mask")
    if k.shape[1] != q.shape[1] or v.shape != k.shape:
        raise ValueError(f"q, k and v must be one rank's slices of one "
                         f"sequence; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return _GatheredAttention.apply(q, k, v, mask, group, bool(causal),
                                    float(dropout_p), seed, int(head_offset),
                                    heads_total)


__all__ = ["attended_keys", "gathered_attention", "gathered_calls",
           "rank_backward", "rank_forward", "rank_mask"]
