"""SGD, Momentum, Adam and AdamW with the JAX package's exact update rules.

The counterparts of `paddle_tpu/optimizer/optimizers.py` `SGD`,
`Momentum`, `Adam` and `AdamW`, on the base in `optimizer.py` (learning
rate or scheduler, grad clip, coupled or decoupled decay, master weights,
the JAX state-dict keys). `torch.optim.AdamW` is not the JAX rule: it
decays the parameter before the Adam step and rounds low-precision
parameters at other points. Per weight w (the parameter, or its float32
master) with gradient g in w's dtype:

- SGD: ``w - lr g`` (lr rounded to w's dtype);
- Momentum: ``v = mu v + g`` (v float32); ``w - lr v``, or with Nesterov
  ``w - lr (g + mu v)``, in float32 and rounded to w's dtype;
- Adam / AdamW, all in float32 with w's dtype for the result::

      m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g;  b1p *= b1;  b2p *= b2
      w - lr (m / (1 - b1p)) / (sqrt(v / (1 - b2p)) + eps)

  with the beta powers float32 scalars on the host. AdamW decays
  decoupled: ``new - (lr wd w_old).to(w.dtype)``.

The other rules of the JAX package (Adamax, Adagrad, Adadelta, RMSProp,
DGCMomentum, Lars, Lamb) are not ported yet (ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

import numpy as np
import torch

from .optimizer import L2Decay, Optimizer, as_dtype

_F32 = np.float32


class SGD(Optimizer):
    """SGD(learning_rate, parameters, weight_decay, grad_clip,
    multi_precision) with the JAX package's signature and rule."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)

    def _update(self, works, works32, grads, lr, states):
        step = torch._foreach_mul(grads, as_dtype(lr, works[0].dtype))
        return torch._foreach_sub(works, step)


class Momentum(Optimizer):
    """Momentum(learning_rate, momentum, parameters, use_nesterov,
    weight_decay, grad_clip, multi_precision) with the JAX package's
    signature and rule; the velocity is float32 whatever the parameter's
    dtype."""

    _slot_names = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _init_slots(self, p):
        return {"velocity": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, works, works32, grads, lr, states):
        mu = self._momentum
        vel = [s["velocity"] for s in states]
        g32 = [g.float() for g in grads]
        torch._foreach_mul_(vel, mu)
        torch._foreach_add_(vel, g32)
        step = (torch._foreach_add(g32, torch._foreach_mul(vel, mu))
                if self._use_nesterov else vel)
        new = torch._foreach_sub(
            works32, torch._foreach_mul(step, as_dtype(lr, works[0].dtype)))
        return [n.to(w.dtype) for n, w in zip(new, works)]


class Adam(Optimizer):
    """Adam(learning_rate, beta1, beta2, epsilon, parameters, weight_decay,
    grad_clip, lazy_mode, multi_precision) with the JAX package's
    signature and rule (a `weight_decay` is coupled L2)."""

    _slot_names = ("moment1", "moment2", "beta1_pow", "beta2_pow")
    _host_slots = ("beta1_pow", "beta2_pow")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None, apply_decay_param_fun=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, apply_decay_param_fun)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": _F32(1.0), "beta2_pow": _F32(1.0)}

    def _update(self, works, works32, grads, lr, states):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = [s["moment1"] for s in states]
        v = [s["moment2"] for s in states]
        g = [x.float() for x in grads]
        # the beta powers: float32 scalars per parameter, rounded as the
        # JAX package's f32 state is
        for s in states:
            s["beta1_pow"] = s["beta1_pow"] * _F32(b1)
            s["beta2_pow"] = s["beta2_pow"] * _F32(b2)
        # the moments update in place: no second copy of the f32 state
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        gg = torch._foreach_mul(g, 1 - b2)
        torch._foreach_mul_(gg, g)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, gg)
        mhat = torch._foreach_div(
            m, [float(_F32(1) - s["beta1_pow"]) for s in states])
        vhat = torch._foreach_div(
            v, [float(_F32(1) - s["beta2_pow"]) for s in states])
        den = torch._foreach_add(torch._foreach_sqrt(vhat), eps)
        step = torch._foreach_div(torch._foreach_mul(mhat, float(lr)), den)
        return [n.to(w.dtype) for n, w in
                zip(torch._foreach_sub(works32, step), works)]


class AdamW(Adam):
    """AdamW(learning_rate, beta1, beta2, epsilon, parameters,
    weight_decay, lr_ratio, apply_decay_param_fun, grad_clip, lazy_mode,
    multi_precision) with the JAX package's signature and rule: Adam with
    decoupled decay. `parameters` is an iterable of tensors or of
    ``(name, tensor)`` pairs (``model.named_parameters()``);
    `apply_decay_param_fun(name)` says whether a parameter is decayed
    (default: every one) and needs the names. `lr_ratio` and `lazy_mode`
    are taken and not read, as in the JAX package."""

    _decoupled_wd = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if weight_decay is None:
            weight_decay = 0.0
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision,
                         name, apply_decay_param_fun)


__all__ = ["SGD", "Momentum", "Adam", "AdamW", "L2Decay"]
