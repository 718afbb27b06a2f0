"""Carry weights from the JAX package's GPT into the port's GPT."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def from_jax_state_dict(model, arrays):
    """Load `arrays` ({name: array}, the JAX package's
    ``state_dict_arrays(model)[0]`` as numpy) into `model` in place.

    Key names are identical on both sides (``blocks.0.attn.qkv.weight``).
    The JAX package stores Linear weights as ``[in, out]``; they are
    transposed into `nn.Linear`'s ``[out, in]``. Raises on a missing or
    unexpected key and on a shape mismatch. Returns `model`."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(arrays))
    unexpected = sorted(set(arrays) - set(params))
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    linear = {f"{name}.weight" for name, m in model.named_modules()
              if isinstance(m, nn.Linear)}
    with torch.no_grad():
        for name, p in params.items():
            a = np.asarray(arrays[name])
            if name in linear:
                a = a.T
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: array shape {tuple(a.shape)} does "
                                 f"not fit parameter {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a)))
    return model
