"""Optimizers of the port (the JAX package's `paddle_tpu.optimizer`)."""
from . import lr  # noqa: F401
from .optimizer import L2Decay, Optimizer
from .optimizers import SGD, Adam, AdamW, Momentum

__all__ = ["Adam", "AdamW", "L2Decay", "Momentum", "Optimizer", "SGD", "lr"]
