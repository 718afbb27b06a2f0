"""Functional layers of the port (the JAX package's `ops/common_nn.py`)."""
from __future__ import annotations

from .flash_attention import flash_attention


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention on [batch, seq, heads, head_dim] through `flash_attention`
    (the CUDA kernels on the card, the plain version on the CPU). An
    `attn_mask`, or `dropout_p > 0` while training, raises
    NotImplementedError: those kernel variants are not ported yet."""
    return flash_attention(query, key, value, causal=is_causal,
                           mask=attn_mask,
                           dropout_p=dropout_p if training else 0.0)
