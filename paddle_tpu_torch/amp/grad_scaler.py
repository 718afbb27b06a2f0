"""Loss scaling (the JAX package's `paddle_tpu/amp/grad_scaler.py`).

`GradScaler` keeps the JAX package's per-optimizer INIT / UNSCALED /
STEPPED bookkeeping, so ``scaler.unscale_(opt); clip; scaler.step(opt);
scaler.update()`` unscales once, and its dynamic scale: a step whose
gradients hold an inf or a NaN is skipped and the scale shrinks by
`decr_ratio` (never below 1); `incr_every_n_steps` good steps in a row
grow it by `incr_ratio`.

`unscale_` multiplies every gradient of the optimizer by 1/scale in
place (`torch._foreach_mul_`, one list per device and dtype; 1/scale is
rounded to the gradients' dtype first, as the JAX package's weakly typed
scalar is) and then checks the unscaled values, as the JAX package does:
the norms of ``g * 0`` (NaN exactly where an entry is inf or NaN) summed
into one device flag, read once. One host sync an `unscale_`, where the
JAX package syncs once per parameter; the decisions are the same.
"""
from __future__ import annotations

import enum
import math

import torch

from ..optimizer.optimizer import as_dtype


class OptimizerState(enum.Enum):
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


def _params(optimizer):
    return [p for g in optimizer.param_groups for p in g["params"]]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False   # OR over optimizers since the last update()
        self._optimizer_states = {}     # id(optimizer) -> OptimizerState
        self._optimizer_found_inf = {}  # id(optimizer) -> bool

    def _state_of(self, optimizer):
        return self._optimizer_states.get(id(optimizer),
                                          OptimizerState.INIT)

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer):
        if not self._enable:
            return
        st = self._state_of(optimizer)
        if st is OptimizerState.UNSCALED:
            raise RuntimeError("unscale_() has already been called on this "
                               "optimizer since the last update().")
        if st is OptimizerState.STEPPED:
            raise RuntimeError("unscale_() is being called after step().")
        buckets = {}
        for p in _params(optimizer):
            if p.grad is not None:
                buckets.setdefault((p.grad.device, p.grad.dtype),
                                   []).append(p.grad)
        # one flag a device, NaN when any of its gradients is not finite
        flags = {}
        for (device, dtype), grads in buckets.items():
            torch._foreach_mul_(grads, as_dtype(1.0 / self._scale, dtype))
            probe = torch.stack(torch._foreach_norm(
                torch._foreach_mul(grads, 0.0))).sum()
            flags[device] = probe if device not in flags \
                else flags[device] + probe
        found = not all(math.isfinite(f) for f in flags.values())
        # the per-optimizer flag decides the skip; the global one (an OR,
        # so a second optimizer's clean gradients cannot erase an earlier
        # inf) drives the dynamic scale
        self._optimizer_found_inf[id(optimizer)] = found
        self._found_inf = self._found_inf or found
        self._optimizer_states[id(optimizer)] = OptimizerState.UNSCALED

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        st = self._state_of(optimizer)
        if st is OptimizerState.STEPPED:
            raise RuntimeError(
                "step() has already been called since the last update().")
        if st is OptimizerState.INIT:
            self.unscale_(optimizer)
        if not self._optimizer_found_inf.get(id(optimizer), False):
            optimizer.step()
        self._optimizer_states[id(optimizer)] = OptimizerState.STEPPED

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        if not self._enable:
            return
        self._optimizer_states.clear()
        self._optimizer_found_inf.clear()
        if not self._dynamic:
            self._found_inf = False
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("incr_count", 0)
        self._bad_steps = sd.get("decr_count", 0)
