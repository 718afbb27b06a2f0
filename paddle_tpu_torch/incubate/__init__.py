"""paddle.incubate of the port (the JAX package's `paddle_tpu/incubate/`):
its fused functionals and `FusedEcMoe` (`nn`). The fused transformer
layers built on `nn.MultiHeadAttention` / `nn.Linear` wait for the core
layer API (ROADMAP Queue 1, item 8c)."""
from . import nn  # noqa: F401

__all__ = ["nn"]
