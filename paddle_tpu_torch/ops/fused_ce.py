"""Linear + softmax cross-entropy over a tied vocab head, whole or chunked.

The counterpart of `paddle_tpu/ops/fused_ce.py`. For a [B, S, H] hidden
state and a [V, H] tied embedding the [B, S, V] logits are the largest
tenant of a GPT train step. `fused_linear_cross_entropy` walks the
sequence in chunks: the forward keeps only each token's log-sum-exp, the
backward recomputes each chunk's logits (one extra [chunk, V] product,
FLOPs traded for memory) and accumulates dW in float32.
`linear_cross_entropy` is the one-product head: it keeps the float32
logits for the backward instead (the JAX model's unfused branch).

Both follow the JAX package's rounding: the logits are the float32 sums of
exact products (`preferred_element_type=f32`), and the backward rounds
dlogits to the weight's dtype before the two products. The products are
plain `torch.mm`; XLA computed them outside any Pallas kernel.

On a tensor-parallel (``mp``) rank the tied weight holds the rank's vocab
rows ``[V/mp, H]`` (`distributed/fleet/meta_parallel/mp_layers.py`), and
the same two heads run vocab-parallel (`vocab_parallel_linear_cross_
entropy`): each rank's f32 logits ``[N, V/mp]`` stay local, and three
all-reduces over the group a chunk give the row max (MAX), the sum of
exponentials (SUM) and the picked logit (SUM, from the rank that holds
the label). The backward is ``softmax_local - onehot_local`` on the
rank's columns; the hidden state's gradient, a partial sum over the
vocab shards, is summed over the group by `copy_to_mp` in front of the
head. `vocab_parallel_cross_entropy` is the per-token form over logits
the caller already holds (`ParallelCrossEntropy`).
"""
from __future__ import annotations

import torch


def _pick_chunks(B, S, V, n_chunks):
    """Choose a sequence-chunk count: cap per-chunk f32 logits near 256 MB.
    n_chunks None or <1 means auto."""
    if n_chunks is not None and int(n_chunks) >= 1:
        n = int(n_chunks)
    else:
        budget = 256e6
        n = 1
        while (B * (S // n) * V * 4 > budget and n < S and S % (n * 2) == 0):
            n *= 2
    while S % n:
        n -= 1
    return max(n, 1)


def mm_f32(a, b):
    """a @ b as float32 sums of exact products, whatever the inputs' dtype
    (XLA's ``preferred_element_type=f32``): cuBLAS writes f32 straight from
    bf16 inputs on the card; the CPU multiplies the upcast values."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk(t, i, c):
    """Sequence chunk i (width c) of [B, S, ...] flattened to [B*c, ...]."""
    part = t[:, i * c:(i + 1) * c]
    return part.reshape((-1,) + tuple(t.shape[2:]))


def _lse_and_picked(logits, labels, mp=None):
    """Each row's log-sum-exp and its label's logit, f32 ``[N]``. On an mp
    rank `logits` are its ``[N, V/mp]`` columns and `labels` global ids:
    the row max (MAX), the sum of exponentials and the picked logit (SUM)
    are each one all-reduce over the group."""
    if mp is None or mp.size <= 1:
        lse = torch.logsumexp(logits, dim=-1)
        return lse, logits.gather(1, labels[:, None])[:, 0]
    from ..parallel.collectives import all_reduce

    local, mine = _local_labels(labels, logits.shape[1], mp)
    m = all_reduce(logits.amax(dim=-1), mp.group, op="max")
    se = all_reduce(torch.exp(logits - m[:, None]).sum(-1), mp.group)
    picked = logits.gather(1, local[:, None])[:, 0]
    picked = all_reduce(torch.where(mine, picked, torch.zeros_like(picked)),
                        mp.group)
    return m + torch.log(se), picked


def _local_labels(labels, n, mp):
    """(`labels` as this rank's column index, clamped; whether the rank
    holds each label) for a rank holding columns ``[rank * n, (rank + 1)
    * n)``."""
    local = labels - mp.rank * n
    mine = (local >= 0) & (local < n)
    return local.clamp(0, n - 1), mine


def _sub_onehot(ds, labels, mp=None):
    """``ds[row, label] -= 1`` in place, on the columns this rank holds."""
    rows = torch.arange(ds.shape[0], device=ds.device)
    if mp is None or mp.size <= 1:
        ds[rows, labels] -= 1.0
        return ds
    local, mine = _local_labels(labels, ds.shape[1], mp)
    ds[rows, local] -= mine.to(ds.dtype)
    return ds


class _LinearCE(torch.autograd.Function):
    """Mean CE of x @ w^T against labels over n sequence chunks. With
    `keep_logits` (n must be 1) the forward keeps the f32 logits and the
    backward turns them into dlogits in place; otherwise it keeps only the
    log-sum-exp and recomputes each chunk. With an active `mp`, `w` is
    this rank's vocab rows and the softmax is reduced over the group
    (module docstring); dx is then this rank's partial sum."""

    @staticmethod
    def forward(ctx, x, w, labels, n, keep_logits, mp=None):
        B, S, _ = x.shape
        c = S // n
        lses = torch.empty((B, S), dtype=torch.float32, device=x.device)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            logits = mm_f32(_chunk(x, i, c), w.t())       # [B*c, V] f32
            lse, picked = _lse_and_picked(logits, _chunk(labels, i, c), mp)
            total = total + (lse - picked).sum()
            lses[:, i * c:(i + 1) * c] = lse.view(B, c)
        ctx.save_for_backward(x, w, labels, lses)
        ctx.n, ctx.mp = n, mp
        ctx.logits = logits if keep_logits else None
        return total / (B * S)

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lses = ctx.saved_tensors
        B, S, H = x.shape
        n = ctx.n
        c = S // n
        scale = (g / (B * S)).float()
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        for i in range(n):
            xc = _chunk(x, i, c)
            if ctx.logits is not None:
                ds, ctx.logits = ctx.logits, None          # reused in place
            else:
                ds = mm_f32(xc, w.t())
            ds.sub_(_chunk(lses, i, c)[:, None]).exp_()   # p = softmax
            _sub_onehot(ds, _chunk(labels, i, c), ctx.mp)
            ds.mul_(scale)                                 # (p - onehot) * g/N
            dsw = ds.to(w.dtype)
            dsx = dsw if x.dtype == w.dtype else ds.to(x.dtype)
            dx[:, i * c:(i + 1) * c] = mm_f32(dsw, w).to(x.dtype).view(
                B, c, H)
            dw += mm_f32(dsx.t(), xc)
        return dx, dw.to(w.dtype), None, None, None, None


def fused_linear_cross_entropy(x, weight, labels, n_chunks=None):
    """Mean token cross-entropy of ``x @ weight.T`` against `labels`,
    computed in sequence chunks so the full [B, S, V] logits never exist.

    x: [B, S, H]; weight: [V, H] (e.g. a tied wte); labels: [B, S] int.
    n_chunks: sequence chunks (None = auto, ~256 MB f32 logits per chunk).
    """
    B, S, _ = x.shape
    n = _pick_chunks(B, S, weight.shape[0], n_chunks)
    return _LinearCE.apply(x, weight, labels.long(), n, False)


def linear_cross_entropy(x, weight, labels):
    """The same loss from one [B*S, V] product whose f32 logits are kept
    for the backward (no recompute)."""
    return _LinearCE.apply(x, weight, labels.long(), 1, True)


def vocab_parallel_linear_cross_entropy(x, weight, labels, mp,
                                        n_chunks=1):
    """The tied head's mean cross-entropy on an mp rank: `weight` is the
    rank's ``[V/mp, H]`` vocab rows, `x` the replicated hidden state; one
    product (`n_chunks` 1, logits kept for the backward) or `n_chunks`
    sequence chunks (None = auto) with the recompute. Without an active
    `mp` it is `linear_cross_entropy` / `fused_linear_cross_entropy`."""
    from ..distributed.fleet.meta_parallel.mp_layers import copy_to_mp

    B, S, _ = x.shape
    n = 1 if n_chunks == 1 else _pick_chunks(B, S, weight.shape[0],
                                             n_chunks)
    return _LinearCE.apply(copy_to_mp(x, mp), weight, labels.long(), n,
                           n == 1, mp)


class _ParallelCE(torch.autograd.Function):
    """Per-token CE of f32 logits ``[N, V(/mp)]``; 0 (and no gradient)
    where the label is `ignore`."""

    @staticmethod
    def forward(ctx, logits, labels, mp, ignore):
        lg = logits.float()
        valid = labels != ignore
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        lse, picked = _lse_and_picked(lg, safe, mp)
        ctx.save_for_backward(lg, safe, valid, lse)
        ctx.mp, ctx.dtype = mp, logits.dtype
        return torch.where(valid, lse - picked, torch.zeros_like(lse))

    @staticmethod
    def backward(ctx, g):
        lg, safe, valid, lse = ctx.saved_tensors
        ds = _sub_onehot(torch.exp(lg - lse[:, None]), safe, ctx.mp)
        ds.mul_(torch.where(valid, g.float(), torch.zeros_like(g.float()))
                [:, None])
        return ds.to(ctx.dtype), None, None, None


def vocab_parallel_cross_entropy(logits, labels, mp=None, ignore_index=-100):
    """Per-token cross-entropy ``[...]`` of `logits` ``[..., V/mp]`` (this
    rank's columns of the class dim) against global `labels` ``[...]``;
    0 where the label is `ignore_index`. Without an active `mp`, the
    plain per-token cross-entropy of the whole row."""
    lead = logits.shape[:-1]
    out = _ParallelCE.apply(logits.reshape(-1, logits.shape[-1]),
                            torch.as_tensor(labels, device=logits.device)
                            .long().reshape(-1), mp, ignore_index)
    return out.reshape(lead)
