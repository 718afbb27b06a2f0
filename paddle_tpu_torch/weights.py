"""Carry weights between the JAX package's models and the port's.

Serves every model of the port (`models/gpt.py` GPT, `models/bert.py`
Bert): parameter names are the same on both sides, so the carry works by
name. A tied weight is one parameter on both sides (GPT's `wte`, BERT's
`word_emb`); `nn.Linear` weights are transposed between the JAX
package's ``[in, out]`` and torch's ``[out, in]``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _linear_weights(model):
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, nn.Linear)}


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
    linear = _linear_weights(model)
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


def to_jax_state_dict(model):
    """The inverse of `from_jax_state_dict`: {name: numpy array} in the JAX
    package's layout (Linear weights transposed back to ``[in, out]``),
    in each parameter's dtype (bfloat16 comes back as float32, which holds
    it exactly; numpy has no bfloat16)."""
    linear = _linear_weights(model)
    out = {}
    for name, p in model.named_parameters():
        t = p.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.numpy()
        out[name] = np.ascontiguousarray(a.T) if name in linear else a.copy()
    return out
