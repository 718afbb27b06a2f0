"""AdamW with the JAX package's exact update rule.

The counterpart of `paddle_tpu/optimizer/optimizers.py` `Adam`/`AdamW` and
the decoupled weight decay of `Optimizer.apply_gradients_arrays`
(`paddle_tpu/optimizer/optimizer.py`). `torch.optim.AdamW` is not that
rule: it decays the parameter before the Adam step and rounds low-precision
parameters at other points. Per parameter p with gradient g:

    g32 = g.to(p.dtype).float();  m = b1 m + (1 - b1) g32
    v = b2 v + (1 - b2) g32 g32;  b1p *= b1;  b2p *= b2      (all f32)
    step = lr (m / (1 - b1p)) / (sqrt(v / (1 - b2p)) + eps)
    new = (p.float() - step).to(p.dtype)
    new = new - (lr * wd * p_old.float()).to(p.dtype)         (if decayed)

with the moments and the beta powers kept in float32 whatever the
parameter's dtype, and the decay taken from the parameter before the step.
A parameter the optimizer was given that got no gradient (``.grad`` None)
takes a zero gradient, as the JAX package's compiled step hands it one: its
moments decay, its Adam step is 0 and weight decay still applies (where
`torch.optim` skips it). A parameter that does not require a gradient is
left alone.
The arithmetic runs on lists of tensors (`torch._foreach_*`), a few
launches for the whole model instead of a dozen per parameter.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

_TODO = "is not ported yet (ROADMAP Queue 1, item 4)"


class AdamW(torch.optim.Optimizer):
    """AdamW(learning_rate, beta1, beta2, epsilon, parameters, weight_decay,
    apply_decay_param_fun) with the JAX package's signature and rule.

    `parameters` is an iterable of tensors or of ``(name, tensor)`` pairs
    (``model.named_parameters()``); `apply_decay_param_fun(name)` says
    whether a parameter is decayed (default: every one) and needs the
    names. `grad_clip`, `multi_precision` and an LR scheduler raise
    NotImplementedError."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=False):
        if not isinstance(learning_rate, numbers.Real):
            raise NotImplementedError(f"AdamW: an LR scheduler {_TODO}")
        if grad_clip is not None:
            raise NotImplementedError(f"AdamW: grad_clip {_TODO}")
        if multi_precision:
            raise NotImplementedError(
                f"AdamW: multi_precision (master weights) {_TODO}")
        if parameters is None:
            raise ValueError("AdamW needs its parameters")
        items = list(parameters)
        named = bool(items) and isinstance(items[0], tuple)
        if apply_decay_param_fun is not None and not named:
            raise ValueError("apply_decay_param_fun needs (name, parameter) "
                             "pairs: pass model.named_parameters()")
        params = [p for _, p in items] if named else items
        self._names = {id(p): n for n, p in items} if named else {}
        self._apply_decay_param_fun = apply_decay_param_fun
        super().__init__(params, dict(lr=float(learning_rate), beta1=beta1,
                                      beta2=beta2, eps=epsilon,
                                      weight_decay=float(weight_decay)))

    def _decays(self, p):
        fn = self._apply_decay_param_fun
        return fn is None or bool(fn(self._names[id(p)]))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("AdamW.step: closures are not "
                                      "supported")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.requires_grad]
            # one list per (device, dtype): a _foreach op takes one of each
            buckets = {}
            for p in params:
                buckets.setdefault((p.device, p.dtype), []).append(p)
            for ps in buckets.values():
                self._update(ps, group)

    def _update(self, ps, group):
        b1, b2, eps = group["beta1"], group["beta2"], group["eps"]
        f32 = np.float32
        for p in ps:
            if not self.state[p]:
                self.state[p] = {
                    "moment1": torch.zeros_like(p, dtype=torch.float32),
                    "moment2": torch.zeros_like(p, dtype=torch.float32),
                    "beta1_pow": f32(1.0), "beta2_pow": f32(1.0)}
        states = [self.state[p] for p in ps]
        m = [s["moment1"] for s in states]
        v = [s["moment2"] for s in states]
        g = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
             else p.grad.to(p.dtype).float() for p in ps]
        # the beta powers: float32 scalars per parameter, rounded as the
        # JAX package's f32 state is
        for s in states:
            s["beta1_pow"] = s["beta1_pow"] * f32(b1)
            s["beta2_pow"] = s["beta2_pow"] * f32(b2)
        lr = f32(group["lr"])
        # the moments update in place: no second copy of the f32 state
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        gg = torch._foreach_mul(g, 1 - b2)
        torch._foreach_mul_(gg, g)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, gg)
        mhat = torch._foreach_div(
            m, [float(f32(1) - s["beta1_pow"]) for s in states])
        vhat = torch._foreach_div(
            v, [float(f32(1) - s["beta2_pow"]) for s in states])
        den = torch._foreach_add(torch._foreach_sqrt(vhat), eps)
        step = torch._foreach_div(torch._foreach_mul(mhat, float(lr)), den)
        old = [p.float() for p in ps]
        new = [n.to(p.dtype) for n, p in
               zip(torch._foreach_sub(old, step), ps)]
        wd = group["weight_decay"]
        decay = [i for i, p in enumerate(ps) if wd and self._decays(p)]
        if decay:
            dec = torch._foreach_mul([old[i] for i in decay],
                                     float(lr * f32(wd)))
            torch._foreach_sub_([new[i] for i in decay],
                                [d.to(ps[i].dtype) for d, i in
                                 zip(dec, decay)])
        torch._foreach_copy_(ps, new)
