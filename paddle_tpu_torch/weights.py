"""Carry weights between the JAX package's models and the port's.

Serves every model of the port (`models/gpt.py` GPT, `models/bert.py`
Bert): parameter names are the same on both sides, so the carry works by
name. A tied weight is one parameter on both sides (GPT's `wte`, BERT's
`word_emb`); `nn.Linear` weights are transposed between the JAX
package's ``[in, out]`` and torch's ``[out, in]``. The optimizer's state
crosses the same way (`from_jax_optimizer_state`,
`to_jax_optimizer_state`): the JAX compiled step's state, ``{name: {slot:
array}}`` from `init_state_arrays` / `apply_gradients_arrays`, beside its
scheduler's `state_dict()`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .optimizer.lr import LRScheduler


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


def from_jax_optimizer_state(optimizer, model, state, lr_state=None):
    """Load the JAX compiled step's optimizer state into `optimizer` (a
    port optimizer over `model`'s parameters) in place: `state` is
    ``{name: {slot: array}}`` (moments, beta powers, velocity,
    ``master_weight``) as numpy, `lr_state` the JAX scheduler's
    `state_dict()` (loaded into the optimizer's scheduler). Slots of a
    Linear weight are transposed as the weight is. A run resumed from it
    takes the JAX run's next steps. Raises on a missing or unexpected
    name. Returns `optimizer`."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    unexpected = sorted(set(state) - set(params))
    if missing or unexpected:
        raise KeyError(f"optimizer state mismatch: missing {missing}, "
                       f"unexpected {unexpected}")
    linear = _linear_weights(model)
    for name, slots in state.items():
        p = params[name]
        optimizer.state[p] = {}
        st = optimizer._state_of(p)
        for slot, a in slots.items():
            a = np.asarray(a)
            if slot in optimizer._host_slots:
                st[slot] = np.float32(a)
                continue
            if name in linear:
                a = a.T
            st[slot] = torch.from_numpy(np.array(a, np.float32)).to(p.device)
    if lr_state is not None:
        sched = optimizer._learning_rate
        if not isinstance(sched, LRScheduler):
            raise ValueError("lr_state given, but the optimizer's learning "
                             "rate is no scheduler")
        sched.set_state_dict(lr_state)
    return optimizer


def to_jax_optimizer_state(optimizer, model):
    """The inverse of `from_jax_optimizer_state`: ``({name: {slot: numpy
    array}}, scheduler state dict or None)`` in the JAX compiled step's
    layout (Linear slots transposed back, the beta powers as float32
    0-d arrays)."""
    linear = _linear_weights(model)
    state = {}
    for name, p in model.named_parameters():
        slots = {}
        for slot, v in optimizer.state.get(p, {}).items():
            if slot in optimizer._host_slots:
                slots[slot] = np.asarray(v, np.float32)
                continue
            a = v.detach().cpu().numpy()
            slots[slot] = np.ascontiguousarray(a.T) if name in linear \
                else a.copy()
        state[name] = slots
    sched = optimizer._learning_rate
    lr_state = (sched.state_dict() if isinstance(sched, LRScheduler)
                else None)
    return state, lr_state
