"""BERT / ERNIE encoder (BASELINE config 3: ERNIE-3.0 / BERT-base
pretraining), in PyTorch.

The counterpart of `paddle_tpu/models/bert.py`, with its parameter names
(`weights.py` carries a JAX state dict over) and its Megatron layers
(`distributed/fleet/meta_parallel/mp_layers.py`: dense until a training
mesh with ``mp`` > 1 shards them). On an mp rank the word embedding is
vocab-parallel, fc1 and the fused QKV column-parallel, the attention
output and fc2 row-parallel, and attention runs the rank's ``heads / mp``
heads with their offset. The QKV columns are ``[3, heads, head_dim]``,
so a rank's QKV rows are three strided head groups (``out_groups=3``:
the rank's heads of q, of k and of v). The MLM head's logits are
gathered over the group (one all-gather), since the loss is the caller's
function of the full logits. What the model computes, as in the JAX
package:

- embeddings: word + position (+ token type, only when `token_type_ids`
  is given), LayerNorm, dropout;
- post-LN blocks: ``ln1(x + drop(attn(x)))``, ``ln2(x + drop(mlp(x)))``
  with the erf GELU; attention is bidirectional through
  `scaled_dot_product_attention` with the caller's `attention_mask` and
  attention dropout (the flash kernels' mask and dropout variants on the
  card, the plain version on the CPU). The fused QKV projection's columns
  are ``[3, heads, head_dim]`` (q of every head, then k, then v: the JAX
  model's reshape), not GPT's per-head grouping;
- heads: a tanh pooler on ``x[:, 0]`` into the NSP head, and the MLM
  transform (Linear, erf GELU, LayerNorm) into the head tied to
  `word_emb` with no bias.

All LayerNorms use eps 1e-5. Dropout draws from the model's own
`DropoutGenerators`, seeded explicitly (`seed_dropout`).

On an ``sp`` rank of a training mesh (`shard_sequence`,
parallel/spmd.py) the input is the rank's slice of each row's sequence,
its positions from `pos_offset`: each layer's attention spans the whole
sequence through `parallel/sequence_attention.py` (K/V gathered over the
group, the caller's mask whole on its key axis, attention dropout drawn
at the rank's rows), each elementwise dropout mask is the rank's slice of
the whole sequence's draw, and the pooler reads the sequence's first
token, which sp rank 0 holds: one counted all-gather of ``x[:, 0]`` over
the group hands rank 0's row to every rank (its gradient, when a loss
reads the NSP head, comes home in one counted reduce-scatter), so every
rank returns the whole sequence's ``nsp_logits``. With
`BertConfig(remat=True)` each layer runs under
`distributed/fleet/utils.recompute` while autograd records, with its
attention mask and the dropout generators as the forward found them. The
JAX model's remat drops the mask (`recompute(self._inner, x)`): that
fault is not copied.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .._device import resolve_device
from ..distributed.fleet.meta_parallel.mp_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    copy_to_mp, gather_from_mp)
from ..distributed.fleet.utils import recompute
from ..ops.common_nn import (DropoutGenerators, attention_dropout, dropout,
                             scaled_dot_product_attention, seq_split)


class BertConfig:
    """The JAX package's BertConfig fields."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 dropout=0.1, remat=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.remat = remat


def split_qkv(qkv, b, s, num_heads, head_dim):
    """Split the fused QKV projection [b, s, 3 * hidden] in the JAX BERT's
    column order ``[3, heads, head_dim]``; returns strided views [b, s,
    heads, head_dim] with unit stride on head_dim."""
    qkv = qkv.view(b, s, 3, num_heads, head_dim)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


class _FirstToken(torch.autograd.Function):
    """sp rank 0's rows `x0` [b, hidden] on every rank of `group` (the
    sequence's first token): one counted all-gather forward; backward, one
    counted reduce-scatter sums every rank's gradient into rank 0's (the
    other ranks' own rows get none)."""

    @staticmethod
    def forward(ctx, x0, group):
        from ..parallel.collectives import all_gather

        ctx.group = group
        return all_gather(x0.contiguous(), group)[0]

    @staticmethod
    def backward(ctx, g):
        from ..parallel.collectives import reduce_scatter

        group = ctx.group
        send = torch.zeros((group.size,) + tuple(g.shape), dtype=g.dtype,
                           device=g.device)
        send[0] = g
        mine = reduce_scatter(send.view(-1), group)
        return mine.view(g.shape), None


class BertSelfAttention(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.dropout = cfg.dropout
        # the model's heads this module holds: [head_offset, + num_heads)
        self.head_offset, self.heads_total = 0, cfg.num_heads
        self.sp = None       # the sp group of a sequence-split rank
        kw = {"device": device, "dtype": dtype}
        self.qkv = ColumnParallelLinear(cfg.hidden_size, 3 * cfg.hidden_size,
                                        gather_output=False, out_groups=3,
                                        **kw)
        self.out = RowParallelLinear(cfg.hidden_size, cfg.hidden_size,
                                     input_is_parallel=True, **kw)

    def shard_heads(self, mp):
        """Hold mp rank ``mp.rank``'s share of the heads (its QKV rows are
        those heads' q, k and v rows)."""
        self.num_heads = self.heads_total // mp.size
        self.head_offset = mp.rank * self.num_heads

    def forward(self, x, attn_mask=None, generator=None):
        b, s, _ = x.shape
        q, k, v = split_qkv(self.qkv(x), b, s, self.num_heads, self.head_dim)
        if seq_split(self.sp) is not None:
            from ..parallel.sequence_attention import gathered_attention

            p, seed = attention_dropout(self.dropout, self.training,
                                        generator)
            o = gathered_attention(q, k, v, self.sp, False, attn_mask, p,
                                   seed, self.head_offset, self.heads_total)
        else:
            o = scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                training=self.training, generator=generator,
                head_offset=self.head_offset, heads_total=self.heads_total)
        return self.out(o.reshape(b, s, self.num_heads * self.head_dim))


class BertLayer(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.attn = BertSelfAttention(cfg, **kw)
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        self.fc1 = ColumnParallelLinear(cfg.hidden_size, cfg.intermediate_size,
                                        gather_output=False, **kw)
        self.fc2 = RowParallelLinear(cfg.intermediate_size, cfg.hidden_size,
                                     input_is_parallel=True, **kw)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        self.p = cfg.dropout
        self.remat = cfg.remat
        self.sp = None

    def forward(self, x, attn_mask=None, gens=None):
        if self.remat and torch.is_grad_enabled():
            return recompute(self._inner, x, attn_mask, gens,
                             generators=(gens.attn, gens.elem) if gens
                             else ())
        return self._inner(x, attn_mask, gens)

    def _inner(self, x, attn_mask=None, gens=None):
        attn_gen, elem_gen = (gens.attn, gens.elem) if gens else (None, None)

        def drop(y):
            return dropout(y, self.p, self.training, elem_gen,
                           seq_split=seq_split(self.sp))

        x = self.ln1(x + drop(self.attn(x, attn_mask, attn_gen)))
        return self.ln2(x + drop(self.fc2(F.gelu(self.fc1(x)))))


class Bert(nn.Module):
    """The encoder with its pooler, NSP head and tied MLM head.

    Built on `device` (None = CUDA, which must exist) in `dtype`, with
    weights drawn from a `torch.Generator` seeded with `seed`: Xavier-normal
    Linear and word-embedding weights, normal(0, 1/sqrt(hidden)) position
    and type embeddings, zero biases, unit LayerNorm scales (the JAX
    package's initialisers). Dropout draws from generators seeded with
    `seed` (`seed_dropout` reseeds them)."""

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden_size
        kw = {"device": device, "dtype": dtype}
        self.word_emb = VocabParallelEmbedding(cfg.vocab_size, h, **kw)
        self.pos_emb = nn.Embedding(cfg.max_position_embeddings, h, **kw)
        self.type_emb = nn.Embedding(cfg.type_vocab_size, h, **kw)
        self.ln = nn.LayerNorm(h, eps=1e-5, **kw)
        self.layers = nn.ModuleList(
            [BertLayer(cfg, **kw) for _ in range(cfg.num_layers)])
        self.pooler = nn.Linear(h, h, **kw)
        self.mlm_transform = nn.Linear(h, h, **kw)
        self.mlm_ln = nn.LayerNorm(h, eps=1e-5, **kw)
        self.nsp = nn.Linear(h, 2, **kw)
        self.sp = None
        self._init_weights(seed)
        self.seed_dropout(seed)
        self.eval()

    @property
    def device(self):
        return self.word_emb.weight.device

    def seed_dropout(self, seed):
        """Reseed the generators every dropout of the model draws from."""
        self.dropout_generators = DropoutGenerators(seed, self.device)

    def shard_sequence(self, group):
        """Run as rank ``group.rank`` of an ``sp`` group (a
        `parallel.collectives.RankGroup`; None: the whole sequence here):
        the input is that rank's slice of each row (its positions from
        `pos_offset`), attention spans the group, each dropout mask is
        the rank's slice of the whole sequence's, and the pooler reads the
        sequence's first token (module docstring)."""
        self.sp = group
        for layer in self.layers:
            layer.sp = layer.attn.sp = group
        return self

    @torch.no_grad()
    def _init_weights(self, seed):
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))

        def xavier(w):
            std = math.sqrt(2.0 / (w.shape[0] + w.shape[1]))
            w.normal_(0.0, std, generator=g)

        xavier(self.word_emb.weight)
        for emb in (self.pos_emb, self.type_emb):
            emb.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.hidden_size),
                               generator=g)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                xavier(m.weight)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                pos_offset=0):
        """(MLM logits [b, s, vocab], NSP logits [b, 2]) in the model's
        dtype. `attention_mask` is added to every layer's attention scores
        (float) or keeps them where True (bool), broadcast to [b, heads, s,
        s]: ERNIE's padding mask is ``(1 - mask)[:, None, None] * -1e4``.
        On an sp rank `input_ids` are positions ``pos_offset ..`` of each
        row and the mask is the whole row's (`shard_sequence`)."""
        b, s = input_ids.shape
        gens = self.dropout_generators
        pos = pos_offset + torch.arange(s, device=input_ids.device)[None]
        x = self.word_emb(input_ids) + self.pos_emb(pos)
        if token_type_ids is not None:
            x = x + self.type_emb(token_type_ids)
        x = dropout(self.ln(x), self.cfg.dropout, self.training, gens.elem,
                    seq_split=seq_split(self.sp))
        for layer in self.layers:
            x = layer(x, attention_mask, gens)
        first = x[:, 0]
        if seq_split(self.sp) is not None:
            first = _FirstToken.apply(first, self.sp)
        pooled = torch.tanh(self.pooler(first))
        mlm = self.mlm_ln(F.gelu(self.mlm_transform(x)))
        mp = self.word_emb.mp
        logits = gather_from_mp(copy_to_mp(mlm, mp) @ self.word_emb.weight.t(),
                                mp)
        return logits, self.nsp(pooled)


def bert_base(device=None, dtype=torch.float32, seed=0, **kw):
    return Bert(BertConfig(**kw), device=device, dtype=dtype, seed=seed)


def ernie_base(device=None, dtype=torch.float32, seed=0, **kw):
    """ERNIE-3.0-base shape (BASELINE north star): BERT-base with a
    40000-token vocabulary."""
    kw.setdefault("vocab_size", 40000)
    return Bert(BertConfig(**kw), device=device, dtype=dtype, seed=seed)


def bert_pretrain_loss_fn(outputs, labels):
    """Mean MLM cross-entropy in float32 over the labelled positions
    (label -100 is ignored); `outputs` is the model's (logits, nsp) or the
    logits alone. The JAX package's function. Its `loss_weight` (the
    labelled positions of a batch) lets a train step whose rows split
    over ranks take the mean over the whole batch's labelled positions,
    as the JAX package's GSPMD step does, rather than the mean of the
    ranks' means (parallel/spmd.py)."""
    logits = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
    labels = torch.as_tensor(labels, device=logits.device).long()
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, safe[..., None])[..., 0]
    picked = torch.where(valid, picked, torch.zeros_like(picked))
    return -picked.sum() / valid.sum().clamp(min=1)


def _labelled_positions(labels):
    return (torch.as_tensor(labels) != -100).sum()


bert_pretrain_loss_fn.loss_weight = _labelled_positions
