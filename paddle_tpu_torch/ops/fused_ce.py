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


class _LinearCE(torch.autograd.Function):
    """Mean CE of x @ w^T against labels over n sequence chunks. With
    `keep_logits` (n must be 1) the forward keeps the f32 logits and the
    backward turns them into dlogits in place; otherwise it keeps only the
    log-sum-exp and recomputes each chunk."""

    @staticmethod
    def forward(ctx, x, w, labels, n, keep_logits):
        B, S, _ = x.shape
        c = S // n
        lses = torch.empty((B, S), dtype=torch.float32, device=x.device)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            logits = mm_f32(_chunk(x, i, c), w.t())       # [B*c, V] f32
            lse = torch.logsumexp(logits, dim=-1)
            picked = logits.gather(1, _chunk(labels, i, c)[:, None])[:, 0]
            total = total + (lse - picked).sum()
            lses[:, i * c:(i + 1) * c] = lse.view(B, c)
        ctx.save_for_backward(x, w, labels, lses)
        ctx.n = n
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
            rows = torch.arange(ds.shape[0], device=ds.device)
            ds[rows, _chunk(labels, i, c)] -= 1.0
            ds.mul_(scale)                                 # (p - onehot) * g/N
            dsw = ds.to(w.dtype)
            dsx = dsw if x.dtype == w.dtype else ds.to(x.dtype)
            dx[:, i * c:(i + 1) * c] = mm_f32(dsw, w).to(x.dtype).view(
                B, c, H)
            dw += mm_f32(dsx.t(), xc)
        return dx, dw.to(w.dtype), None, None, None


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
