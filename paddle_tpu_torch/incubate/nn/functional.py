"""incubate.nn.functional of the port: the fused functionals of the JAX
package's `paddle_tpu/incubate/nn/functional.py` on plain tensors, in
Paddle's layouts (a linear weight is ``[in, out]``).

`fused_multi_head_attention` runs its attention through
`ops/common_nn.scaled_dot_product_attention`, non-causal: the hand-written
flash kernels on the card (with their padding-mask and dropout
variants), their plain version on the CPU, as the JAX function reaches
the Pallas flash kernel. The rest is plain PyTorch, as the JAX package
leaves it to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops import common_nn


def fused_matmul_bias(x, y, bias=None, transpose_x=False, transpose_y=False,
                      name=None):
    """``x @ y + bias``, each of x and y transposed in its last two dims
    first when asked."""
    out = torch.matmul(x.mT if transpose_x else x, y.mT if transpose_y else y)
    return out if bias is None else out + bias


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """``x @ weight + bias`` with `weight` ``[in, out]`` (``[out, in]``
    with `transpose_weight`)."""
    out = torch.matmul(x, (weight.t() if transpose_weight
                           else weight).to(x.dtype))
    return out if bias is None else out + bias.to(out.dtype)


def _layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, x.shape[-1:],
                        None if scale is None else scale.to(x.dtype),
                        None if bias is None else bias.to(x.dtype), eps)


def fused_multi_head_attention(
        x, qkv_weight, linear_weight, pre_layer_norm=False, pre_ln_scale=None,
        pre_ln_bias=None, ln_scale=None, ln_bias=None, pre_ln_epsilon=1e-5,
        qkv_bias=None, linear_bias=None, cache_kv=None, attn_mask=None,
        dropout_rate=0.5, attn_dropout_rate=0.5, ln_epsilon=1e-5,
        training=True, mode="upscale_in_train", ring_id=-1,
        add_residual=True, num_heads=-1, transpose_qkv_wb=False, name=None):
    """The attention block from raw weights (reference
    incubate/nn/functional/fused_transformer.py): the pre-LN (with
    `pre_layer_norm`), the qkv product ``bse,khde->kbshd`` with
    `qkv_weight` ``[3, heads, head_dim, embed_dim]`` (with
    `transpose_qkv_wb`: ``[embed_dim, 3 * embed_dim]`` and `num_heads`),
    attention over `attn_mask` (additive or bool, broadcastable to ``[b,
    heads, s, s]``) with `attn_dropout_rate` while `training`, the output
    product with `linear_weight` ``[embed_dim, embed_dim]``, dropout, the
    residual and the post-LN (without `pre_layer_norm`). The dropout draws
    come from torch's default generators."""
    if cache_kv is not None:
        raise NotImplementedError(
            "fused_multi_head_attention: cache_kv (incremental decode) is not "
            "supported — use nn.MultiHeadAttention with its cache API")
    if mode != "upscale_in_train":
        raise NotImplementedError(
            f"fused_multi_head_attention: dropout mode {mode!r} not supported")
    b, s, e = x.shape
    qkv_w = qkv_weight
    if transpose_qkv_wb:
        if num_heads <= 0:
            raise ValueError(
                "fused_multi_head_attention: transpose_qkv_wb=True requires "
                "num_heads > 0 (weight is [embed_dim, 3*embed_dim])")
        qkv_w = qkv_w.reshape(e, 3, num_heads, e // num_heads).permute(
            1, 2, 3, 0)
        if qkv_bias is not None and qkv_bias.dim() == 1:
            qkv_bias = qkv_bias.reshape(3, num_heads, e // num_heads)
    _, n_heads, head_dim, _ = qkv_w.shape
    h = _layer_norm(x, pre_ln_scale, pre_ln_bias, pre_ln_epsilon) \
        if pre_layer_norm else x
    qkv = torch.einsum("bse,khde->kbshd", h, qkv_w.to(h.dtype))
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.to(qkv.dtype)[:, None, None]
    # q, k and v as [b, s, heads, head_dim] slices of one contiguous
    # buffer (the kernels take unit stride on head_dim)
    qkv = qkv.contiguous()
    ctx = common_nn.scaled_dot_product_attention(
        qkv[0], qkv[1], qkv[2], attn_mask=attn_mask,
        dropout_p=attn_dropout_rate if training else 0.0, is_causal=False,
        training=training)
    out = fused_linear(ctx.reshape(b, s, n_heads * head_dim), linear_weight,
                       linear_bias)
    if training and dropout_rate:
        out = common_nn.dropout(out, dropout_rate, training=True)
    if add_residual:
        out = x + out
    if not pre_layer_norm:
        out = _layer_norm(out, ln_scale, ln_bias, ln_epsilon)
    return out


def fused_ec_moe(x, gate, bmm0_weight, bmm0_bias, bmm1_weight, bmm1_bias,
                 act_type="gelu"):
    """Every expert's FFN weighted by the softmax of `gate` (reference
    incubate/nn/functional/fused_ec_moe.py, the JAX package's dense
    evaluation): x ``[b, s, d]``, gate ``[b, s, e]``, bmm0 ``[e, d, f]``
    with bias ``[e, 1, f]``, bmm1 ``[e, f, d]`` with bias ``[e, 1, d]``;
    `act_type` "gelu" (the tanh form, jax.nn.gelu's) or "relu"."""
    if act_type not in ("gelu", "relu"):
        raise ValueError(f"unsupported act_type {act_type}")
    hidden = torch.einsum("bsd,edf->ebsf", x, bmm0_weight) + bmm0_bias[:, None]
    hidden = F.gelu(hidden, approximate="tanh") if act_type == "gelu" \
        else F.relu(hidden)
    out = torch.einsum("ebsf,efd->ebsd", hidden, bmm1_weight) \
        + bmm1_bias[:, None]
    return torch.einsum("ebsd,bse->bsd", out, torch.softmax(gate, -1))


__all__ = ["fused_ec_moe", "fused_linear", "fused_matmul_bias",
           "fused_multi_head_attention"]
