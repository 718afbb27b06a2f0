"""GPT: the decoder-only LM (BASELINE config 4: GPT-1.3B), in PyTorch.

The counterpart of `paddle_tpu/models/gpt.py` for serving and training.
Its tensor-parallel layers run at tp=1 here, so they are plain
`nn.Linear` and `nn.Embedding`. Parameter names are the JAX package's
(`weights.py` carries a JAX state dict over). Three attention paths:

- the paged path, when `caches` is a `PagedState` (`serving/block_pool.py`):
  new K/V go into the block arena and attention goes through
  `ops/paged_attention.py` (the CUDA kernel on the card, the plain version
  on the CPU);
- the contiguous-cache decode of `generate`, with fixed-size per-layer
  ``(k_buf [b, L, h, d], v_buf, cur)`` caches updated in place;
- no cache (training, and a full forward): causal attention over the
  whole input through `ops/common_nn.py` `scaled_dot_product_attention`,
  i.e. the flash-attention kernels on the card and the plain version on
  the CPU.

With `labels`, `forward` returns the mean next-token cross-entropy from
the hidden states through the tied head (`ops/fused_ce.py`). In train mode
with `dropout` > 0, the JAX model's dropouts apply: on the embeddings, on
each block's two residual branches (the full forward only) and on the
attention probabilities (the flash kernels' dropout variant), drawn from
the model's own `DropoutGenerators` (`seed_dropout`). With
`GPTConfig(remat=True)` each block's full forward runs under
`distributed/fleet/utils.recompute` while autograd records (the JAX
model's `recompute(self._inner, x)`): its activations are recomputed in
the backward, the flash forward kernel with them, from the dropout
generators as the forward found them.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .._device import resolve_device
from ..distributed.fleet.utils import recompute
from ..ops.common_nn import (DropoutGenerators, dropout,
                             scaled_dot_product_attention)
from ..ops.fused_ce import fused_linear_cross_entropy, linear_cross_entropy

_NEG_INF = -1e30


class GPTConfig:
    """The JAX package's GPTConfig fields. attn_impl 'ring' is not ported
    and raises NotImplementedError. ('flash' and 'xla' both take
    scaled_dot_product_attention, as in the JAX model.)
    `dtype` is stored and never read, as in the JAX model: the parameter
    dtype is the `dtype` argument of `GPT` and `gpt_*`."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=1024, intermediate_size=None,
                 dropout=0.0, attn_impl="flash", remat=False,
                 dtype="float32", fused_head_chunks=None):
        if attn_impl not in ("flash", "xla"):
            raise NotImplementedError(
                f"GPTConfig: attn_impl={attn_impl!r} is not ported "
                "(ROADMAP Queue 1, item 8: ring attention)")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.dropout = dropout
        self.attn_impl = attn_impl
        self.remat = remat
        self.dtype = dtype
        self.fused_head_chunks = fused_head_chunks


def _split_fused_qkv(qkv, b, s, num_heads, head_dim):
    """Split the fused QKV projection per head group: the column block of
    head i is its contiguous ``[q_i, k_i, v_i]`` (the JAX package's order).
    Returns strided views [b, s, heads, head_dim] with unit stride on
    head_dim."""
    qkv = qkv.view(b, s, num_heads, 3, head_dim)
    return qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]


def _attend(q, k, v, qpos, kpos, scale):
    """softmax(q k^T * scale, masked to kpos <= qpos) v in the [b, L, h, d]
    layout; scores and softmax in fp32, P cast to v's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(kpos[None, None, None, :] <= qpos[None, None, :, None],
                    s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


def _serving_column_parallel(linear, x, op_name, cache):
    """A column-parallel projection on the paged serving path, with each
    lane's LoRA delta added when the threaded-through `PagedState` carries
    gathered adapter rows for `op_name` (models/lora.py: ``y + x @
    A[slot] @ B[slot]``, slot 0 all zeros = base). With no rows (a
    lora-off engine, or any other path) it is the plain projection.

    The sum is taken in float32 and rounded back to y's dtype. This is the
    one place where the port's bf16 dtype differs from the JAX package,
    whose ``y + delta`` promotes to the float32 delta and carries float32
    on from there: rounding back keeps the bf16 path, its CUDA graphs and
    the bf16 ragged kernels on their bf16 forms, and slot 0's exact zero
    leaves a base lane's y bit for bit. In float32 the two are the
    same."""
    y = linear(x)
    lora = getattr(getattr(cache, "state", None), "lora", None)
    if lora is None or op_name not in lora:
        return y
    from .lora import apply_adapter_rows

    a_rows, b_rows = lora[op_name]
    delta = apply_adapter_rows(x, a_rows, b_rows, cache.layer)
    return (y.float() + delta).to(y.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.dropout = cfg.dropout
        kw = {"device": device, "dtype": dtype}
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size, **kw)
        self.proj = nn.Linear(cfg.hidden_size, cfg.hidden_size, **kw)

    def forward(self, x, cache=None, generator=None):
        b, s, _ = x.shape
        qkv = _serving_column_parallel(self.qkv, x, "attn_qkv", cache)
        q, k, v = _split_fused_qkv(qkv, b, s, self.num_heads, self.head_dim)
        width = self.num_heads * self.head_dim
        if cache is not None and getattr(cache, "is_paged", False):
            from ..serving.block_pool import paged_attention

            o = paged_attention(q, k, v, cache)
            return self.proj(o.reshape(b, s, width)), cache
        if cache is not None:
            # incremental decode over a fixed-size cache, updated in place
            k_buf, v_buf, cur = cache
            k_buf[:, cur:cur + s] = k
            v_buf[:, cur:cur + s] = v
            kpos = torch.arange(k_buf.shape[1], device=x.device)
            qpos = cur + torch.arange(s, device=x.device)
            o = _attend(q, k_buf, v_buf, qpos, kpos,
                        1.0 / math.sqrt(self.head_dim))
            return self.proj(o.reshape(b, s, width)), (k_buf, v_buf, cur + s)
        o = scaled_dot_product_attention(q, k, v, is_causal=True,
                                         dropout_p=self.dropout,
                                         training=self.training,
                                         generator=generator)
        return self.proj(o.reshape(b, s, width))


class GPTBlock(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        self.attn = CausalSelfAttention(cfg, **kw)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)
        self.p = cfg.dropout
        self.remat = cfg.remat

    def _mlp(self, x, cache=None):
        h = _serving_column_parallel(self.fc1, self.ln2(x), "ffn_fc1", cache)
        return self.fc2(F.gelu(h, approximate="tanh"))

    def forward(self, x, cache=None, gens=None):
        if cache is not None:
            attn_out, new_cache = self.attn(self.ln1(x), cache=cache)
            x = x + attn_out
            return x + self._mlp(x, cache), new_cache
        if self.remat and torch.is_grad_enabled():
            return recompute(self._inner, x, gens,
                             generators=(gens.attn, gens.elem) if gens
                             else ())
        return self._inner(x, gens)

    def _inner(self, x, gens=None):
        attn_gen, elem_gen = (gens.attn, gens.elem) if gens else (None, None)

        def drop(y):
            return dropout(y, self.p, self.training, elem_gen)

        x = x + drop(self.attn(self.ln1(x), generator=attn_gen))
        return x + drop(self._mlp(x))


class GPT(nn.Module):
    """The GPT decoder with its LM head tied to `wte`.

    Built on `device` (None = CUDA, which must exist) in `dtype`, with
    weights drawn from a `torch.Generator` seeded with `seed`: Xavier-normal
    Linear and token-embedding weights, normal(0, 1/sqrt(hidden)) position
    embeddings, zero biases, unit LayerNorm scales (the JAX package's
    initialisers). Dropout draws from generators seeded with
    `seed` (`seed_dropout` reseeds them)."""

    def __init__(self, cfg, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        kw = {"device": device, "dtype": dtype}
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size, **kw)
        self.blocks = nn.ModuleList(
            [GPTBlock(cfg, **kw) for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=1e-5, **kw)
        self._init_weights(seed)
        self.seed_dropout(seed)
        self.eval()

    @property
    def device(self):
        return self.wte.weight.device

    def seed_dropout(self, seed):
        """Reseed the generators every dropout of the model draws from."""
        self.dropout_generators = DropoutGenerators(seed, self.device)

    @property
    def dtype(self):
        return self.wte.weight.dtype

    @torch.no_grad()
    def _init_weights(self, seed):
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))

        def xavier(w):
            # nn.Linear stores [out, in]; fan sum is symmetric anyway
            std = math.sqrt(2.0 / (w.shape[0] + w.shape[1]))
            w.normal_(0.0, std, generator=g)

        xavier(self.wte.weight)
        self.wpe.weight.normal_(0.0, 1.0 / math.sqrt(self.cfg.hidden_size),
                                generator=g)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                xavier(m.weight)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def hidden(self, input_ids, caches=None, pos_offset=0):
        """Final-LayerNorm hidden states [b, s, hidden] and the caches.

        `caches` is None (full causal forward), a `PagedState` (positions
        are its `qpos`; each layer writes the arena in place) or the
        per-layer contiguous caches of `init_caches` (positions start at
        `pos_offset`)."""
        b, s = input_ids.shape
        paged = caches is not None and getattr(caches, "is_paged", False)
        if paged:
            pos = caches.qpos
        else:
            pos = pos_offset + torch.arange(s, device=input_ids.device)[None]
        gens = self.dropout_generators
        x = dropout(self.wte(input_ids) + self.wpe(pos), self.cfg.dropout,
                    self.training, gens.elem)
        new_caches = [] if caches is not None and not paged else None
        for i, blk in enumerate(self.blocks):
            if paged:
                x, _ = blk(x, cache=caches.layer(i))
            elif caches is not None:
                x, c = blk(x, cache=caches[i])
                new_caches.append(c)
            else:
                x = blk(x, gens=gens)
        x = self.ln_f(x)
        return x, (caches if paged else new_caches)

    def logits(self, h):
        """The tied LM head: h @ wte.weight^T."""
        return h @ self.wte.weight.t()

    def head_loss(self, h, labels):
        """Mean cross-entropy of the tied head's f32 logits against
        `labels` (the targets themselves: no shift). The chunked fused
        head runs when `fused_head_chunks` asks for it, or when bf16
        logits would pass 1.5e9 bytes; otherwise one product whose logits
        are kept for the backward (the JAX model's switch)."""
        b, s, _ = h.shape
        labels = torch.as_tensor(labels, device=h.device)
        n_chunks = self.cfg.fused_head_chunks
        logits_bytes = 2 * b * s * self.cfg.vocab_size
        if (n_chunks or 0) != 1 and (n_chunks is not None
                                     or logits_bytes > 1.5e9):
            return fused_linear_cross_entropy(h, self.wte.weight, labels,
                                              n_chunks)
        return linear_cross_entropy(h, self.wte.weight, labels)

    def forward(self, input_ids, caches=None, pos_offset=0, labels=None):
        h, new_caches = self.hidden(input_ids, caches, pos_offset)
        if labels is not None and caches is None:
            return self.head_loss(h, labels)
        logits = self.logits(h)
        return logits if caches is None else (logits, new_caches)

    def init_caches(self, batch_size, max_len, dtype=None):
        """Fixed-size per-layer KV caches for incremental decode, in the
        model's dtype unless `dtype` says otherwise."""
        dt = self.dtype if dtype is None else dtype
        shape = (batch_size, max_len, self.cfg.num_heads,
                 self.cfg.hidden_size // self.cfg.num_heads)
        return [(torch.zeros(shape, dtype=dt, device=self.device),
                 torch.zeros(shape, dtype=dt, device=self.device), 0)
                for _ in range(self.cfg.num_layers)]

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=None, seed=0, eos_token_id=None):
        """Autoregressive decode with a fixed-size KV cache: prefill once,
        then one [b, 1] step per token. Greedy (temperature 0) is an
        argmax; sampling draws from a `torch.Generator` seeded with `seed`
        on the model's device. Returns [b, prompt + new] int64."""
        ids = torch.as_tensor(input_ids).to(self.device).long()
        b, prompt_len = ids.shape
        if max_new_tokens <= 0:
            return ids
        max_len = prompt_len + max_new_tokens
        if max_len > self.cfg.max_seq_len:
            raise ValueError(
                f"generate: prompt {prompt_len} + {max_new_tokens} new tokens "
                f"exceeds max_seq_len {self.cfg.max_seq_len}")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))

        def sample(logits_last):
            lg = logits_last.float() / max(temperature, 1e-6)
            if top_k is not None:
                kth = torch.sort(lg, dim=-1).values[:, -int(top_k)][:, None]
                lg = torch.where(lg < kth, torch.full_like(lg, -math.inf), lg)
            if temperature == 0.0:
                return torch.argmax(lg, dim=-1)
            return torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                     generator=gen)[:, 0]

        caches = self.init_caches(b, max_len)
        logits, caches = self(ids, caches=caches, pos_offset=0)
        tok = sample(logits[:, -1])
        out = [tok]
        for t in range(1, max_new_tokens):
            logits, caches = self(tok[:, None], caches=caches,
                                  pos_offset=prompt_len + t - 1)
            tok = sample(logits[:, -1])
            out.append(tok)
            if eos_token_id is not None and bool((tok == eos_token_id).all()):
                break
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)


def gpt_loss_fn(logits, labels):
    """Mean next-token cross-entropy of logits [b, s, vocab] against
    labels [b, s], in float32 (the JAX package's functional loss)."""
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - picked).mean()


def gpt_tiny(**kw):
    return GPT(GPTConfig(vocab_size=1024, hidden_size=256, num_layers=4,
                         num_heads=8, max_seq_len=256), **kw)


def gpt_small(**kw):
    return GPT(GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                         num_heads=12, max_seq_len=1024), **kw)


def gpt_1p3b(num_layers=24, **kw):
    """GPT-3 1.3B shape (BASELINE config 4). `num_layers` cuts depth only."""
    return GPT(GPTConfig(vocab_size=50304, hidden_size=2048,
                         num_layers=num_layers, num_heads=16,
                         max_seq_len=2048), **kw)
