"""Layers and helpers of the port (the JAX package's `paddle_tpu.nn`)."""
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer import is_skeleton, skeleton_init

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_", "is_skeleton",
           "skeleton_init"]
