"""Carry weights between the JAX package's models and the port's.

Serves every model of the port (`models/gpt.py` GPT, `models/bert.py`
Bert): parameter names are the same on both sides, so the carry works by
name. A tied weight is one parameter on both sides (GPT's `wte`, BERT's
`word_emb`); `nn.Linear` weights are transposed between the JAX
package's ``[in, out]`` and torch's ``[out, in]``. The optimizer's state
crosses the same way (`from_jax_optimizer_state`,
`to_jax_optimizer_state`): the JAX compiled step's state, ``{name: {slot:
array}}`` from `init_state_arrays` / `apply_gradients_arrays`, beside its
scheduler's `state_dict()`. A train step's state (parallel/spmd.py)
crosses at natural shapes (`to_jax_train_state`, `from_jax_train_state`),
whatever flat, padded layout the JAX explicit ZeRO step keeps it in; on a
hybrid step the natural arrays become each rank's mp and sharding slices
(the step's own placement: a column-parallel weight's rows, a
row-parallel weight's columns, ERNIE's QKV as three strided head groups),
and come back joined.
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


def _jax_natural(a, shape, linear):
    """A JAX train state's array `a` of a leaf whose port shape is `shape`,
    in the port's layout: a flat padded leaf of the JAX explicit ZeRO step
    (``[n + pad]``, the JAX natural layout flattened) is cut and reshaped
    first; a Linear weight's ``[in, out]`` is transposed."""
    a = np.asarray(a)
    jshape = tuple(shape[::-1]) if linear else tuple(shape)
    if a.shape != jshape:
        n = int(np.prod(jshape)) if jshape else 1
        a = a.reshape(-1)[:n].reshape(jshape)
    return a.T if linear else a


def from_jax_train_state(step, params, opt_state, lr_state=None):
    """Load the JAX package's train state into `step` (a port
    `ShardedTrainStep` or `LocalSGDTrainStep` over the same model) and
    re-shard it over the step's ranks: `params` ``{name: array}`` and
    `opt_state` ``{name: {slot: array}}`` as the JAX step carries them
    (natural, or the explicit ZeRO path's flat padded leaves: stage-3
    parameters and every parameter-shaped slot), `lr_state` the JAX
    scheduler's `state_dict()`. A run resumed from it takes the JAX run's
    next steps."""
    linear = _linear_weights(step.model)
    shapes = {n: tuple(p.shape) for n, p in step.model.named_parameters()}
    state = {"params": {}, "optimizer": {}}
    for name, a in params.items():
        state["params"][name] = torch.from_numpy(np.array(
            _jax_natural(a, shapes[name], name in linear)))
    host = step.optimizer._host_slots
    for name, slots in opt_state.items():
        for slot, a in slots.items():
            key = f"{name}_{slot}"
            if slot in host:
                state["optimizer"][key] = np.float32(np.asarray(a))
            else:
                state["optimizer"][key] = torch.from_numpy(np.array(
                    _jax_natural(a, shapes[name], name in linear),
                    np.float32))
    for name, p in step.model.named_parameters():
        if name not in state["params"]:
            raise KeyError(f"train state has no parameter {name!r}")
        state["params"][name] = state["params"][name].to(p.dtype)
    if lr_state is not None:
        state["optimizer"]["LR_Scheduler"] = lr_state
    step.set_state_dict(state)
    return step


def to_jax_train_state(step):
    """``(params, opt_state, lr_state)`` of `step` at natural shapes in the
    JAX package's layout (Linear weights and their slots ``[in, out]``,
    host slots float32 0-d arrays): what the JAX step's `gather_params`
    and a natural optimizer state hold."""
    sd = step.state_dict()
    linear = _linear_weights(step.model)

    def jax_layout(name, t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.numpy()
        return np.ascontiguousarray(a.T) if name in linear else a.copy()

    params = {n: jax_layout(n, t) for n, t in sd["params"].items()}
    opt_state = {}
    slot_names = tuple(step.optimizer._slot_names) + ("master_weight",)
    for name in params:
        slots = {}
        for slot in slot_names:
            v = sd["optimizer"].get(f"{name}_{slot}")
            if v is None:
                continue
            slots[slot] = (np.asarray(v, np.float32) if not torch.is_tensor(v)
                           else jax_layout(name, v))
        opt_state[name] = slots
    return params, opt_state, sd["optimizer"].get("LR_Scheduler")


# -- the pipelined GPT ---------------------------------------------------------


def from_jax_pipeline_params(step, params):
    """Load the JAX `make_pipelined_gpt` parameters (numpy or JAX arrays:
    ``blocks`` leaves ``[pp, K, ...]``, or ``[pp, V, K, ...]`` for an
    interleaved step, and ``wte``, ``wpe``, ``lnf_g``, ``lnf_b``) onto the
    port's pipelined step (`models.gpt_pipeline.PipelinedGPTStep`): each
    rank takes its stage's blocks (its mp slice of them) and the
    embedding, head and norm its stage holds. Returns `step`."""
    step.set_params({k: ({n: np.asarray(a) for n, a in v.items()}
                         if k == "blocks" else np.asarray(v))
                     for k, v in params.items()})
    return step


def to_jax_pipeline_params(step):
    """The inverse of `from_jax_pipeline_params`: the step's parameters
    gathered from its ranks, as the JAX pytree of numpy arrays."""
    natural = step.gather_params()
    return {k: ({n: a.numpy() for n, a in v.items()} if k == "blocks"
                else v.numpy()) for k, v in natural.items()}
