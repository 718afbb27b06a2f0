"""Optimizers of the port (the JAX package's `paddle_tpu.optimizer`)."""
from . import lr  # noqa: F401
from .optimizer import L2Decay, Optimizer
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         DGCMomentum, Lamb, Lars, Momentum, RMSProp,
                         sharded_norms)

__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "AdamW", "DGCMomentum",
           "L2Decay", "Lamb", "Lars", "Momentum", "Optimizer", "RMSProp",
           "SGD", "lr", "sharded_norms"]
