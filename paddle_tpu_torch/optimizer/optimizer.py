"""The optimizer base (the JAX package's `paddle_tpu/optimizer/optimizer.py`).

`Optimizer` is a `torch.optim.Optimizer` that applies the JAX package's
per-parameter rule in the order of its compiled step
(`Optimizer.apply_gradients_arrays`), on lists of tensors
(`torch._foreach_*`: a few launches for the whole model):

1. the learning rate is read as a Python float at every `step()`: a number,
   or the current value of an `lr.LRScheduler` (`get_lr`);
2. `grad_clip` (`nn/clip.py`) clips the gradients the parameters have;
3. a parameter that got no gradient (``.grad`` None) takes a zero gradient,
   as the compiled step hands it one; a parameter that does not require a
   gradient is left alone;
4. the gradient (in the parameter's dtype, as torch keeps it) is cast to
   the dtype of the weights the rule updates: the parameter, or its
   float32 ``master_weight`` slot under `multi_precision` (bfloat16/float16
   parameters only);
5. coupled weight decay (`L2Decay`, or a number) adds ``wd * work`` to
   the gradient; decoupled decay (AdamW) subtracts ``lr * wd * work`` in
   float32 from the rule's result, taken from the weights before the step;
6. with a master, the result is stored float32 in the master and the
   parameter becomes ``master.to(param.dtype)``.

Python scalars are rounded to the dtype they multiply, as JAX's weakly
typed scalars are, so bfloat16 results carry JAX's bits.
`state_dict()`/`set_state_dict()` use the JAX package's key scheme:
``{name}_{slot}``, ``LR_Scheduler``, ``@step`` and ``@param_order``, with
names from ``(name, parameter)`` pairs (``model.named_parameters()``) or,
for bare parameters, ``param_{i}`` by position.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .lr import LRScheduler

_MASTER_DTYPES = (torch.bfloat16, torch.float16)


class L2Decay:
    """Coupled L2 weight decay: ``grad += coeff * weight``."""

    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def as_dtype(x, dtype):
    """The Python float `x` rounded to `dtype`: what a weakly typed JAX
    scalar becomes in an op on an array of that dtype."""
    return torch.tensor(float(x), dtype=dtype).item()


class Optimizer(torch.optim.Optimizer):
    """The base of the port's optimizers. Subclasses define `_init_slots`
    (the state of one parameter) and `_update` (the rule on lists)."""

    # the state slots of one parameter, besides ``master_weight``
    _slot_names = ()
    # decoupled (AdamW) against coupled L2 decay
    _decoupled_wd = False
    # slots held on the host as float32 scalars (the beta powers)
    _host_slots = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 apply_decay_param_fun=None):
        if parameters is None:
            raise ValueError(f"{type(self).__name__} needs its parameters")
        items = list(parameters)
        named = bool(items) and isinstance(items[0], tuple)
        if apply_decay_param_fun is not None and not named:
            raise ValueError("apply_decay_param_fun needs (name, parameter) "
                             "pairs: pass model.named_parameters()")
        params = [p for _, p in items] if named else items
        self._names = ({id(p): n for n, p in items} if named else
                       {id(p): f"param_{i}" for i, p in enumerate(params)})
        self._learning_rate = learning_rate
        if isinstance(weight_decay, (float, int)):
            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._step_count = 0
        self._last_lr = None
        super().__init__(params, {})

    # ---- lr ---------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        self._learning_rate = float(value)

    # ---- state ------------------------------------------------------------
    @property
    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def _init_slots(self, p):
        return {}

    def _state_of(self, p):
        st = self.state[p]
        if not st:
            st.update(self._init_slots(p))
            if self._multi_precision and p.dtype in _MASTER_DTYPES:
                st["master_weight"] = p.detach().float()
        return st

    def _seed_master_weights(self):
        """Float32 master copies of the parameters as they are now. Called
        by `amp.decorate(..., level="O2")` before the model is cast down,
        so the masters start from the float32 values."""
        self._multi_precision = True
        for p in self._params:
            st = self._state_of(p)
            if "master_weight" not in st:
                st["master_weight"] = p.detach().float().clone()

    def _wd_coeff(self):
        wd = self._weight_decay
        return wd.coeff if isinstance(wd, L2Decay) else 0.0

    def _decays(self, p):
        fn = self._apply_decay_param_fun
        return fn is None or bool(fn(self._names[id(p)]))

    # ---- the rule (override) ------------------------------------------------
    def _update(self, works, works32, grads, lr, states):
        """New weights (new tensors, in each work's dtype) from `works` (the
        parameters or their masters; `works32` the same in float32),
        their `grads` (in the works' dtype) and the float32 `lr`; updates
        the `states` in place."""
        raise NotImplementedError

    # ---- the step -----------------------------------------------------------
    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError(
                f"{type(self).__name__}.step: closures are not supported")
        self._step_count += 1
        params = [p for p in self._params if p.requires_grad]
        grads = [p.grad for p in params]
        if self._grad_clip is not None:
            live = [i for i, g in enumerate(grads) if g is not None]
            clipped = self._grad_clip.clip_arrays([grads[i] for i in live])
            for i, g in zip(live, clipped):
                grads[i] = g
        lr = np.float32(self.get_lr())
        self._last_lr = lr      # the float32 lr this step's update applied
        # one list per (device, dtypes): a _foreach op takes one of each
        buckets = {}
        for p, g in zip(params, grads):
            st = self._state_of(p)
            work = st.get("master_weight", p)
            key = (p.device, p.dtype, work.dtype, "master_weight" in st)
            buckets.setdefault(key, []).append((p, g, st))
        for items in buckets.values():
            self._apply(items, lr)

    def _apply(self, items, lr):
        ps = [p for p, _, _ in items]
        states = [st for _, _, st in items]
        works = [st.get("master_weight", p) for p, _, st in items]
        wdt = works[0].dtype
        grads = [torch.zeros_like(w) if g is None else g.to(wdt)
                 for w, (_, g, _) in zip(works, items)]
        wd = self._wd_coeff()
        decay = [i for i, p in enumerate(ps) if wd and self._decays(p)]
        works32 = [w.float() for w in works]
        if decay and not self._decoupled_wd:
            # not in place: a gradient may be the parameter's own .grad
            summed = torch._foreach_add(
                [grads[i] for i in decay],
                torch._foreach_mul([works[i] for i in decay],
                                   as_dtype(wd, wdt)))
            for i, g in zip(decay, summed):
                grads[i] = g
        new = self._update(works, works32, grads, lr, states)
        if decay and self._decoupled_wd:
            dec = torch._foreach_mul([works32[i] for i in decay],
                                     float(lr * np.float32(wd)))
            torch._foreach_sub_([new[i] for i in decay],
                                [d.to(wdt) for d in dec])
        if "master_weight" in states[0]:
            # the rule's results are new tensors: they become the masters
            for st, n in zip(states, new):
                st["master_weight"] = n
        torch._foreach_copy_(ps, new)

    # ---- gradients ----------------------------------------------------------
    def clear_grad(self, set_to_zero=False):
        """The JAX package's name for ``zero_grad``: gradients dropped, or
        zeroed with `set_to_zero`."""
        self.zero_grad(set_to_none=not set_to_zero)

    # ---- checkpointing ------------------------------------------------------
    def state_dict(self):
        """The optimizer's state in the JAX package's key scheme: one
        ``{name}_{slot}`` entry per slot (a copy: float32 tensors, the
        host slots as float32 scalars), ``LR_Scheduler`` (the scheduler's
        own state dict), ``@step`` and ``@param_order`` (the names in
        parameter order, so a fresh optimizer matches slots by
        position)."""
        sd = OrderedDict()
        order = []
        for p in self._params:
            name = self._names[id(p)]
            order.append(name)
            for slot, v in self.state.get(p, {}).items():
                sd[f"{name}_{slot}"] = (np.float32(v) if slot in
                                        self._host_slots else
                                        v.detach().clone())
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        sd["@step"] = self._step_count
        sd["@param_order"] = order
        return sd

    def set_state_dict(self, state_dict):
        """Load a `state_dict()` of this package's optimizer, and only
        that: its slots are torch tensors in the parameters' own layout.
        The JAX package's state is refused (its slots are not torch
        tensors, and a Linear weight's slots are ``[in, out]`` there): it
        goes through `weights.from_jax_optimizer_state`, which transposes
        them. Each parameter takes the slots saved under its position's
        name, else its own name; a saved slot that fits neither in shape
        raises."""
        self._step_count = int(state_dict.get("@step", 0))
        if ("LR_Scheduler" in state_dict
                and isinstance(self._learning_rate, LRScheduler)):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        order = state_dict.get("@param_order")
        slot_names = tuple(self._slot_names) + ("master_weight",)
        for i, p in enumerate(self._params):
            names = [order[i]] if order is not None and i < len(order) else []
            if self._names[id(p)] not in names:
                names.append(self._names[id(p)])
            slots = {}
            for slot in slot_names:
                found = [state_dict[k] for k in (f"{nm}_{slot}" for nm in names)
                         if k in state_dict]
                if slot in self._host_slots:
                    if found:
                        slots[slot] = np.float32(found[0])
                    continue
                for v in found:
                    if not torch.is_tensor(v):
                        raise TypeError(
                            f"{type(self).__name__}.set_state_dict takes this "
                            f"package's state_dict(); slot {slot!r} is a "
                            f"{type(v).__name__}. Load the JAX package's "
                            "optimizer state with "
                            "weights.from_jax_optimizer_state")
                fits = [v for v in found
                        if v.numel() == 1 or tuple(v.shape) == tuple(p.shape)]
                if found and not fits:
                    raise ValueError(
                        f"{type(self).__name__}.set_state_dict: slot {slot!r} "
                        f"of {names} has shape {tuple(found[0].shape)}, the "
                        f"parameter {tuple(p.shape)}")
                if fits:
                    slots[slot] = fits[0].detach().to(p.device, torch.float32,
                                                      copy=True)
            if slots:
                self.state[p] = {}
                self._state_of(p).update(slots)

    load_state_dict = set_state_dict
