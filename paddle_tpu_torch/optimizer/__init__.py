"""Optimizers of the port (the JAX package's `paddle_tpu.optimizer`)."""
from .optimizers import AdamW

__all__ = ["AdamW"]
