"""Tensor-parallel (Megatron) layers for training (the JAX package's
`paddle_tpu/distributed/fleet/meta_parallel/mp_layers.py`, in PyTorch's
idiom: each rank of an ``mp`` group holds its shard and the layers make
the collectives).

The JAX layers hold the full weight annotated with a GSPMD sharding over
the ``mp`` mesh axis, and XLA inserts the collectives. Here a layer holds
the full weight until a train step over a mesh with ``mp`` > 1 shards it
(`shard_for_mp`: each rank's copy keeps its slice and the rank's
`MPGroup`); then its forward makes the Megatron collectives through two
autograd functions:

- `copy_to_mp`: identity forward, all-reduce of the input's gradient over
  the group backward (the entry of a column-parallel product: every rank
  holds the replicated input, each adds its partial gradient);
- `reduce_from_mp`: all-reduce forward (the sum of the row-parallel
  partials), identity backward.

Without a group, or at mp degree 1, every layer is its dense counterpart
(`nn.Linear`, `nn.Embedding`): the same parameters, names and numbers.

Weights are in `nn.Linear`'s ``[out, in]`` layout, so ``sharding_axes``
(the JAX attribute, here in the port's layout) name dim 0 of a
column-parallel weight (JAX's ``(None, "mp")``) and dim 1 of a
row-parallel one (JAX's ``("mp", None)``). A column-parallel layer whose
output is ``out_groups`` equal blocks (BERT's fused QKV: ``[3, heads,
head_dim]``) is cut block by block, so a rank holds the same heads of q,
k and v.

The vocab-parallel cross-entropy (`ParallelCrossEntropy`, and the tied
heads' losses in `ops/fused_ce.py`) reduces the row max, the sum of
exponentials and the picked logit over the group.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ....ops.fused_ce import mm_f32
from ....parallel.collectives import all_gather, all_reduce


class MPGroup:
    """A rank's place in its model-parallel group: the group
    (`parallel.collectives.RankGroup`, over the mp peers), this rank's
    index in it and its size."""

    def __init__(self, group, rank, size):
        self.group = group
        self.rank = int(rank)
        self.size = int(size)


def active(mp):
    """Whether `mp` (an `MPGroup` or None) asks for collectives."""
    return mp is not None and mp.size > 1


class _CopyToMP(torch.autograd.Function):
    """Identity forward; backward, the gradient summed over the group (in
    float32, rounded back to its dtype)."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = g.float().contiguous()
        all_reduce(s, ctx.mp.group)
        return s.to(g.dtype), None


class _ReduceFromMP(torch.autograd.Function):
    """The sum over the group forward (in place on a fresh tensor);
    identity backward."""

    @staticmethod
    def forward(ctx, x, mp):
        out = x.contiguous().clone()
        return all_reduce(out, mp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromMP(torch.autograd.Function):
    """Every rank's ``[..., n]`` slice of the last dim concatenated in rank
    order forward; backward, this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp, ctx.n = mp, x.shape[-1]
        g = all_gather(x.contiguous(), mp.group)          # [mp, ..., n]
        return torch.movedim(g, 0, -2).reshape(*x.shape[:-1], -1)

    @staticmethod
    def backward(ctx, g):
        n, r = ctx.n, ctx.mp.rank
        return g[..., r * n:(r + 1) * n].contiguous(), None


class _SplitToMP(torch.autograd.Function):
    """This rank's slice of the last dim forward; backward, the slices'
    gradients gathered over the group."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        n = x.shape[-1] // mp.size
        return x[..., mp.rank * n:(mp.rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _GatherFromMP.forward(ctx, g, ctx.mp), None


def copy_to_mp(x, mp):
    """`x` unchanged; its gradient summed over `mp`'s ranks."""
    return _CopyToMP.apply(x, mp) if active(mp) else x


def reduce_from_mp(x, mp):
    """`x` summed over `mp`'s ranks (one all-reduce); the gradient passes
    unchanged."""
    return _ReduceFromMP.apply(x, mp) if active(mp) else x


def gather_from_mp(x, mp):
    """The ranks' slices of the last dim, concatenated (one all-gather)."""
    return _GatherFromMP.apply(x, mp) if active(mp) else x


class _RowParallel(torch.autograd.Function):
    """``x @ w.T`` summed over the group plus the replicated bias: each
    rank's float32 partial product over its slice of the input dim, one
    all-reduce, the bias added in float32 after the sum, the result
    rounded once to x's dtype. Backward: the plain linear's gradients of
    this rank's slice (the sum's gradient is the output's)."""

    @staticmethod
    def forward(ctx, x, w, b, mp):
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        y = all_reduce(mm_f32(x2, w.t()), mp.group)
        if b is not None:
            y = y + b.float()
        ctx.save_for_backward(x2, w)
        ctx.has_bias, ctx.lead = b is not None, lead
        return y.to(x.dtype).reshape(*lead, w.shape[0])

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = (g2 @ w.to(g2.dtype)).reshape(*ctx.lead, w.shape[1])
        dw = (g2.t() @ x2.to(g2.dtype)).to(w.dtype)
        db = g2.float().sum(0).to(w.dtype) if ctx.has_bias else None
        return dx.to(x2.dtype), dw, db, None


class VocabParallelEmbedding(nn.Embedding):
    """Weight ``[vocab, hidden]``, vocab rows sharded over ``mp``
    (reference mp_layers.py:35). On an mp rank it holds rows ``[rank *
    V/mp, (rank + 1) * V/mp)``: each rank looks up the ids in its range,
    zeroes the others, and one all-reduce sums the ranks' rows (exact: one
    rank holds each id); the gradient reaches only the rank's own rows."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        super().__init__(num_embeddings, embedding_dim, device=device,
                         dtype=dtype)
        self.weight.sharding_axes = ("mp", None)
        self.mp = None

    def forward(self, ids):
        if not active(self.mp):
            return super().forward(ids)
        return vocab_parallel_embedding(self.weight, ids, self.mp)


def vocab_parallel_embedding(weight, ids, mp):
    """The lookup of `ids` in this rank's vocab rows of `weight`, summed
    over `mp` (zeros where another rank holds the id)."""
    n = weight.shape[0]
    local = ids.long() - mp.rank * n
    mine = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), weight)
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return reduce_from_mp(rows, mp)


class ColumnParallelLinear(nn.Linear):
    """``[out, in]`` weight and ``[out]`` bias sharded on the out dim over
    ``mp`` (reference :173). The input is replicated (`copy_to_mp`); with
    `gather_output` the ranks' output columns are gathered, else each
    rank keeps its own. `out_groups` > 1: the output is that many equal
    blocks, each cut over ``mp`` (a port-only argument)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, out_groups=1, device=None,
                 dtype=None):
        super().__init__(in_features, out_features, bias=has_bias,
                         device=device, dtype=dtype)
        self.gather_output = gather_output
        self.out_groups = int(out_groups)
        self.weight.sharding_axes = ("mp", None)
        if self.bias is not None:
            self.bias.sharding_axes = ("mp",)
        self.mp = None

    def forward(self, x):
        if not active(self.mp):
            return super().forward(x)
        y = F.linear(copy_to_mp(x, self.mp), self.weight, self.bias)
        if not self.gather_output:
            return y
        if self.out_groups > 1:
            raise NotImplementedError(
                "gather_output with out_groups > 1: the gathered blocks "
                "would interleave the ranks' columns")
        return gather_from_mp(y, self.mp)


class RowParallelLinear(nn.Linear):
    """``[out, in]`` weight sharded on the in dim over ``mp`` (reference
    :332); the bias is replicated and added after the sum. With
    `input_is_parallel` the input is already each rank's slice (a
    column-parallel output), else the rank takes its slice of it."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        super().__init__(in_features, out_features, bias=has_bias,
                         device=device, dtype=dtype)
        self.input_is_parallel = input_is_parallel
        self.weight.sharding_axes = (None, "mp")
        self.mp = None

    def forward(self, x):
        if not active(self.mp):
            return super().forward(x)
        if not self.input_is_parallel:
            x = _SplitToMP.apply(x, self.mp)
        return _RowParallel.apply(x, self.weight, self.bias, self.mp)


class ParallelCrossEntropy(nn.Module):
    """Per-token cross-entropy of logits whose class dim is sharded over
    ``mp`` (reference :498, ``c_softmax_with_cross_entropy``): `input` is
    this rank's ``[..., V/mp]`` float logits, `label` the global class ids;
    returns the ``[...]`` losses, 0 where `label` is `ignore_index`.
    Without a group it is the plain per-token cross-entropy."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self.mp = None

    def forward(self, input, label):
        from ....ops.fused_ce import vocab_parallel_cross_entropy

        return vocab_parallel_cross_entropy(input, label, self.mp,
                                            self.ignore_index)


# the dim of each mp layer's parameters sharded over mp ([out, in] layout)
_MP_DIMS = {VocabParallelEmbedding: {"weight": 0},
            ColumnParallelLinear: {"weight": 0, "bias": 0},
            RowParallelLinear: {"weight": 1}}


def _mp_dims(module):
    """{leaf: dim} of `module`'s parameters sharded over ``mp``: an mp
    layer's, or those a module that runs its own mp collectives names in
    its ``mp_dims`` (distributed/moe.py `MoELayer`'s experts)."""
    for cls, dims in _MP_DIMS.items():
        if isinstance(module, cls):
            return dims
    return getattr(module, "mp_dims", None) or {}


def mp_layout(module, leaf):
    """How `module`'s parameter `leaf` is cut over ``mp``: ``(dim,
    blocks)`` (the dim its ``sharding_axes`` names, and the equal blocks
    that dim holds: a grouped column-parallel layer's `out_groups`), or
    None. Only the modules that make their own mp collectives shard (the
    mp layers, MoE's experts): a parameter of any other module stays
    replicated, whatever it is annotated with."""
    dims = _mp_dims(module)
    if leaf not in dims:
        return None
    dim = dims[leaf]
    return dim, getattr(module, "out_groups", 1) if dim == 0 else 1


def shard_for_mp(model, mp):
    """Make `model` (a skeleton on the ``meta`` device, or any model whose
    tensors the caller fills next) rank ``mp.rank``'s shard of an ``mp``
    group: each mp layer's (or MoE layer's) sharded parameters take their
    slice's shape (uninitialised ``meta`` stand-ins) and the layer its
    `MPGroup`; each module with a ``shard_heads(mp)`` method (the models'
    attention) takes its share of the heads. Returns `model`."""
    for module in model.modules():
        dims = _mp_dims(module)
        if dims or isinstance(module, ParallelCrossEntropy):
            module.mp = mp
        for leaf, dim in dims.items():
            p = getattr(module, leaf, None)
            if p is None:
                continue
            shape = list(p.shape)
            if shape[dim] % mp.size:
                raise ValueError(
                    f"mp degree {mp.size} does not divide dim {dim} of a "
                    f"{type(module).__name__} {leaf} {tuple(p.shape)}")
            shape[dim] //= mp.size
            q = nn.Parameter(torch.empty(shape, dtype=p.dtype,
                                         device="meta"),
                             requires_grad=p.requires_grad)
            q.__dict__.update(p.__dict__)   # annotations
            setattr(module, leaf, q)
    for module in model.modules():
        if hasattr(module, "shard_heads"):
            module.shard_heads(mp)
    return model


def mp_cut(t, dim, rank, size, groups=1):
    """Rank `rank`'s slice of the natural `t` along `dim` over `size`
    ranks: contiguous, or, with `groups` > 1, the rank's slice of each of
    the dim's equal blocks, concatenated (the inverse of `mp_join`)."""
    if groups == 1:
        n = t.shape[dim] // size
        return t.narrow(dim, rank * n, n)
    shape = list(t.shape)
    blocks = t.reshape(shape[:dim] + [groups, shape[dim] // groups]
                       + shape[dim + 1:])
    n = shape[dim] // groups // size
    part = blocks.narrow(dim + 1, rank * n, n)
    shape[dim] = groups * n
    return part.reshape(shape)


def mp_join(parts, dim, groups=1):
    """The natural tensor from the ranks' slices (`mp_cut`'s inverse)."""
    if groups == 1:
        return torch.cat(list(parts), dim)
    split = []
    for p in parts:
        shape = list(p.shape)
        split.append(p.reshape(shape[:dim] + [groups, shape[dim] // groups]
                               + shape[dim + 1:]))
    joined = torch.cat(split, dim + 1)
    shape = list(parts[0].shape)
    shape[dim] *= len(parts)
    return joined.reshape(shape)


__all__ = ["ColumnParallelLinear", "MPGroup", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding", "copy_to_mp",
           "gather_from_mp", "mp_cut", "mp_join", "mp_layout",
           "reduce_from_mp", "shard_for_mp", "vocab_parallel_embedding"]
