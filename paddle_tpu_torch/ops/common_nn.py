"""Functional layers of the port (the JAX package's `ops/common_nn.py`)."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention

_SEED_HIGH = 2 ** 63 - 1


class DropoutGenerators:
    """The two generators a model's dropout draws from, both seeded with
    `seed`: `attn`, a CPU generator for the attention kernels' seeds (one
    draw a call, no wait on the card), and `elem`, a generator on `device`
    for the elementwise `dropout`."""

    def __init__(self, seed, device):
        self.attn = torch.Generator().manual_seed(int(seed))
        self.elem = torch.Generator(device=device).manual_seed(int(seed))


def draw_seed(generator=None):
    """A dropout seed in [0, 2**63 - 1) from a CPU `torch.Generator` (None:
    torch's default one). Drawing it never waits on the card."""
    if generator is not None and generator.device.type != "cpu":
        raise ValueError(f"the attention-dropout seed comes from a CPU "
                         f"generator; got one on {generator.device}")
    return int(torch.randint(0, _SEED_HIGH, (1,), generator=generator))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None):
    """Attention on [batch, seq, heads, head_dim] through `flash_attention`
    (the CUDA kernels on the card, the plain version on the CPU), with an
    additive float or a bool `attn_mask` broadcastable to [batch, heads,
    seq_q, seq_k]. While `training`, `dropout_p` > 0 drops attention
    probabilities under a seed drawn from `generator` (a CPU
    `torch.Generator`; None: torch's default one)."""
    p = dropout_p if training else 0.0
    seed = draw_seed(generator) if p > 0.0 else None
    return flash_attention(query, key, value, causal=is_causal,
                           mask=attn_mask, dropout_p=p, seed=seed)


def dropout(x, p=0.5, training=True, generator=None, name=None):
    """Dropout in the ``upscale_in_train`` mode: while `training`, each
    entry is kept with probability 1 - p and scaled by 1/(1 - p), else
    zeroed; the identity otherwise. The draw is `torch.rand` on x's device
    from `generator` (a generator on that device; None: torch's default
    one). Plain torch: the JAX package's dropout is no Pallas kernel
    either."""
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability must lie in [0, 1]; got {p}")
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
