"""incubate.nn of the port: the fused functionals (`functional`) and
`FusedEcMoe` (the JAX package's `paddle_tpu/incubate/nn/__init__.py`)."""
from __future__ import annotations

import torch
from torch import nn

from ...distributed.moe import MoELayer
from . import functional  # noqa: F401


class FusedEcMoe(nn.Module):
    """The expert-choice MoE layer as the JAX package gives it: a
    `MoELayer(hidden_size, inter_size, num_experts)` (the naive router,
    top-1 capacity routing, tanh GELU) that ignores `gate_logits`,
    `act_type` and the attributes, as the JAX layer does."""

    def __init__(self, hidden_size, inter_size, num_experts,
                 act_type="gelu", weight_attr=None, bias_attr=None,
                 device=None, dtype=torch.float32, seed=0):
        super().__init__()
        self.moe = MoELayer(hidden_size, inter_size, num_experts,
                            device=device, dtype=dtype, seed=seed)

    def forward(self, x, gate_logits=None):
        return self.moe(x)


__all__ = ["FusedEcMoe", "functional"]
