"""The JAX package's update rules, with its exact arithmetic and state keys.

The counterparts of `paddle_tpu/optimizer/optimizers.py` (SGD, Momentum,
Adam, AdamW, Adamax, Adagrad, Adadelta, RMSProp, DGCMomentum, Lars, Lamb),
on the base in `optimizer.py` (learning
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

Adamax, Adagrad, Adadelta and RMSProp are elementwise, in float32 with
w's dtype for the result, as the JAX rules write them. DGCMomentum (top-k
sparsification with error feedback), Lars and Lamb (trust ratios) reduce
over a whole tensor, so they mark ``_elementwise_update = False``. Every
norm of Lars and Lamb is `_tensor_norm`: the square root of the float32
sum of squares, where the sum is first all-reduced (one counted call a
norm) over the leaf's group, when the leaf is a shard: the group
`sharded_norms(group, optimizer)` holds on the optimizer (the explicit
ZeRO path's flat 1/dp shards, parallel/spmd.py), else the group the base
says the leaf is sharded over (a hybrid step's mp or sharding slices). Zero padding adds nothing to a
sum of squares, so each shard's rule sees the whole tensor's norm.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .optimizer import L2Decay, Optimizer, as_dtype

_F32 = np.float32


@contextlib.contextmanager
def sharded_norms(group, optimizer):
    """While on, every per-tensor norm of `optimizer`'s rule all-reduces
    its squared sum over `group` (a `parallel.collectives.RankGroup`; the
    group is held on the optimizer as ``_norm_group``): the explicit ZeRO
    path runs a trust-ratio rule over flat 1/dp shards inside it."""
    prev = getattr(optimizer, "_norm_group", None)
    optimizer._norm_group = group
    try:
        yield
    finally:
        optimizer._norm_group = prev


def _tensor_norm(x, group=None):
    """The L2 norm of a whole tensor, in float32: the one norm primitive
    of the trust-ratio rules. `x` is a shard when `group` is given (the
    leaf's ``_leaf_groups`` entry): its squared sum is all-reduced over
    that group before the square root."""
    sq = torch.sum(torch.square(x.float()))
    if group is not None:
        from ..parallel.collectives import all_reduce

        sq = all_reduce(sq.reshape(1).clone(), group)[0]
    return torch.sqrt(sq)


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


def _beta_pow(states, slot, beta):
    """Advance the float32 host scalar `slot` of every state by `beta`."""
    for st in states:
        st[slot] = st[slot] * _F32(beta)


def _finish(new32, works):
    return [n.to(w.dtype) for n, w in zip(new32, works)]


class Adamax(Optimizer):
    """Adamax(learning_rate, beta1, beta2, epsilon, parameters,
    weight_decay, grad_clip): ``m = b1 m + (1 - b1) g``, ``u = max(b2 u,
    |g| + eps)``, ``w - lr m / ((1 - b1^t) u)``."""

    _slot_names = ("moment", "inf_norm", "beta1_pow")
    _host_slots = ("beta1_pow",)

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {"moment": torch.zeros_like(p, dtype=torch.float32),
                "inf_norm": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": _F32(1.0)}

    def _update(self, works, works32, grads, lr, states):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        g = [x.float() for x in grads]
        m = [s["moment"] for s in states]
        u = [s["inf_norm"] for s in states]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(u, b2)
        torch._foreach_maximum_(u, torch._foreach_add(
            torch._foreach_abs(g), eps))
        _beta_pow(states, "beta1_pow", b1)
        den = torch._foreach_mul(
            u, [float(_F32(1) - s["beta1_pow"]) for s in states])
        step = torch._foreach_div(torch._foreach_mul(m, float(lr)), den)
        return _finish(torch._foreach_sub(works32, step), works)


class Adagrad(Optimizer):
    """Adagrad(learning_rate, epsilon, parameters, weight_decay,
    grad_clip, initial_accumulator_value): ``mom += g g``, ``w - lr g /
    (sqrt(mom) + eps)``."""

    _slot_names = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_value = initial_accumulator_value

    def _init_slots(self, p):
        return {"moment": torch.full_like(p, self._init_value,
                                          dtype=torch.float32)}

    def _update(self, works, works32, grads, lr, states):
        g = [x.float() for x in grads]
        mom = [s["moment"] for s in states]
        torch._foreach_add_(mom, torch._foreach_mul(g, g))
        den = torch._foreach_add(torch._foreach_sqrt(mom), self._epsilon)
        step = torch._foreach_div(torch._foreach_mul(g, float(lr)), den)
        return _finish(torch._foreach_sub(works32, step), works)


class Adadelta(Optimizer):
    """Adadelta(learning_rate, epsilon, rho, parameters, weight_decay,
    grad_clip): ``asg = rho asg + (1 - rho) g g``, ``d = g sqrt(asu + eps)
    / sqrt(asg + eps)``, ``asu = rho asu + (1 - rho) d d``, ``w - lr d``."""

    _slot_names = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon, self._rho = epsilon, rho

    def _init_slots(self, p):
        return {"avg_squared_grad": torch.zeros_like(p, dtype=torch.float32),
                "avg_squared_update": torch.zeros_like(
                    p, dtype=torch.float32)}

    def _update(self, works, works32, grads, lr, states):
        rho, eps = self._rho, self._epsilon
        g = [x.float() for x in grads]
        asg = [s["avg_squared_grad"] for s in states]
        asu = [s["avg_squared_update"] for s in states]
        torch._foreach_mul_(asg, rho)
        torch._foreach_add_(asg, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - rho))
        upd = torch._foreach_div(
            torch._foreach_mul(g, torch._foreach_sqrt(
                torch._foreach_add(asu, eps))),
            torch._foreach_sqrt(torch._foreach_add(asg, eps)))
        torch._foreach_mul_(asu, rho)
        torch._foreach_add_(asu, torch._foreach_mul(
            torch._foreach_mul(upd, upd), 1 - rho))
        step = torch._foreach_mul(upd, float(lr))
        return _finish(torch._foreach_sub(works32, step), works)


class RMSProp(Optimizer):
    """RMSProp(learning_rate, rho, epsilon, momentum, centered,
    parameters, weight_decay, grad_clip): ``ms = rho ms + (1 - rho) g g``
    (centered: ``mg = rho mg + (1 - rho) g``, ``den = sqrt(ms - mg mg +
    eps)``; else ``sqrt(ms + eps)``), ``mom = mu mom + lr g / den``, ``w -
    mom``."""

    _slot_names = ("momentum", "mean_square", "mean_grad")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_slots(self, p):
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k in self._slot_names}

    def _update(self, works, works32, grads, lr, states):
        rho, eps, mu = self._rho, self._epsilon, self._momentum
        g = [x.float() for x in grads]
        ms = [s["mean_square"] for s in states]
        mg = [s["mean_grad"] for s in states]
        mom = [s["momentum"] for s in states]
        torch._foreach_mul_(ms, rho)
        torch._foreach_add_(ms, torch._foreach_mul(
            torch._foreach_mul(g, g), 1 - rho))
        if self._centered:
            torch._foreach_mul_(mg, rho)
            torch._foreach_add_(mg, torch._foreach_mul(g, 1 - rho))
            den = torch._foreach_sqrt(torch._foreach_add(
                torch._foreach_sub(ms, torch._foreach_mul(mg, mg)), eps))
        else:
            den = torch._foreach_sqrt(torch._foreach_add(ms, eps))
        torch._foreach_mul_(mom, mu)
        torch._foreach_add_(mom, torch._foreach_div(
            torch._foreach_mul(g, float(lr)), den))
        return _finish(torch._foreach_sub(works32, mom), works)


class DGCMomentum(Optimizer):
    """Deep Gradient Compression momentum (the JAX `DGCMomentum`): each
    step adds the error-feedback residual to the gradient, keeps the
    entries at or above the k-th largest magnitude (k = max(1, int(n (1 -
    sparsity)))), banks the rest as the next residual, and runs momentum
    on the kept part. Before step `rampup_begin_step` + 1 every entry is
    kept. A one-element tensor is always kept whole."""

    _slot_names = ("velocity", "residual")
    _elementwise_update = False

    def __init__(self, learning_rate=0.001, momentum=0.9, sparsity=0.999,
                 rampup_begin_step=0, parameters=None, weight_decay=None,
                 grad_clip=None, use_nesterov=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._sparsity = float(sparsity)
        self._rampup_begin = int(rampup_begin_step)
        self._use_nesterov = use_nesterov
        self._dgc_step = 0

    def _init_slots(self, p):
        return {"velocity": torch.zeros_like(p, dtype=torch.float32),
                "residual": torch.zeros_like(p, dtype=torch.float32)}

    def step(self, closure=None):
        self._dgc_step += 1
        return super().step(closure)

    def _update(self, works, works32, grads, lr, states):
        on = self._dgc_step > self._rampup_begin
        out = []
        for w32, w, grad, st in zip(works32, works, grads, states):
            g = grad.float() + st["residual"]
            if g.numel() > 1 and on:
                k = max(1, int(g.numel() * (1.0 - self._sparsity)))
                kth = torch.topk(g.abs().reshape(-1), k).values[-1]
                mask = (g.abs() >= kth).to(g.dtype)
            else:
                mask = torch.ones_like(g)
            sent = g * mask
            st["residual"] = g * (1.0 - mask)
            v = self._momentum * st["velocity"] + sent
            st["velocity"] = v
            step = sent + self._momentum * v if self._use_nesterov else v
            out.append((w32 - float(lr) * step).to(w.dtype))
        return out


class Lars(Optimizer):
    """LARS momentum (the JAX `Lars`): ``local_lr = lr coeff ||w|| /
    (||g|| + wd ||w|| + eps)`` when both norms are positive (else lr),
    ``v = mu v + local_lr (g + wd w)``, ``w - v`` (Nesterov: ``w -
    (local_lr (g + wd w) + mu v)``). A parameter whose name holds one of
    `exclude_from_weight_decay`'s substrings takes wd 0 in both places."""

    _slot_names = ("velocity",)
    _elementwise_update = False
    _sharded_norm_ready = True

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, epsilon=0.0,
                 grad_clip=None, exclude_from_weight_decay=None,
                 use_nesterov=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._epsilon = epsilon
        self._use_nesterov = use_nesterov
        self._exclude = tuple(exclude_from_weight_decay or ())

    def _init_slots(self, p):
        return {"velocity": torch.zeros_like(p, dtype=torch.float32)}

    def _name_decays(self, name):
        return not any(tok in (name or "") for tok in self._exclude)

    def _update(self, works, works32, grads, lr, states):
        out = []
        for i, (p32, w, grad, st) in enumerate(zip(works32, works, grads,
                                                   states)):
            g = grad.float()
            wd = (self._lars_wd if self._name_decays(self._leaf_names[i])
                  else 0.0)
            w_norm = _tensor_norm(p32, self._leaf_groups[i])
            g_norm = _tensor_norm(g, self._leaf_groups[i])
            denom = g_norm + wd * w_norm + self._epsilon
            lr_t = torch.tensor(float(lr), dtype=torch.float32,
                                device=g.device)
            local_lr = torch.where(
                (w_norm > 0) & (g_norm > 0),
                lr_t * self._lars_coeff * w_norm / torch.clamp(denom,
                                                               min=1e-20),
                lr_t)
            d = local_lr * (g + wd * p32)
            v = self._momentum * st["velocity"] + d
            st["velocity"] = v
            step = d + self._momentum * v if self._use_nesterov else v
            out.append((p32 - step).to(w.dtype))
        return out


class Lamb(Optimizer):
    """LAMB (the JAX `Lamb`): Adam's moments and bias correction, ``r =
    m^ / (sqrt(v^) + eps) + wd w``, ``w - lr (||w|| / ||r||) r`` (ratio 1
    when either norm is 0). `exclude_from_weight_decay_fn` is taken and
    not read, as in the JAX package."""

    _slot_names = ("moment1", "moment2", "beta1_pow", "beta2_pow")
    _host_slots = ("beta1_pow", "beta2_pow")
    _elementwise_update = False
    _sharded_norm_ready = True

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._lamb_wd = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": _F32(1.0), "beta2_pow": _F32(1.0)}

    def _update(self, works, works32, grads, lr, states):
        b1, b2, eps, wd = (self._beta1, self._beta2, self._epsilon,
                           self._lamb_wd)
        _beta_pow(states, "beta1_pow", b1)
        _beta_pow(states, "beta2_pow", b2)
        out = []
        for i, (p32, w, grad, st) in enumerate(zip(works32, works, grads,
                                                   states)):
            g = grad.float()
            m = b1 * st["moment1"] + (1 - b1) * g
            v = b2 * st["moment2"] + (1 - b2) * g * g
            st["moment1"], st["moment2"] = m, v
            mhat = m / float(_F32(1) - st["beta1_pow"])
            vhat = v / float(_F32(1) - st["beta2_pow"])
            r = mhat / (torch.sqrt(vhat) + eps) + wd * p32
            w_norm = _tensor_norm(p32, self._leaf_groups[i])
            r_norm = _tensor_norm(r, self._leaf_groups[i])
            ratio = torch.where((w_norm > 0) & (r_norm > 0),
                                w_norm / r_norm, torch.ones_like(w_norm))
            out.append((p32 - float(lr) * ratio * r).to(w.dtype))
        return out


__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
           "Adadelta", "RMSProp", "DGCMomentum", "Lars", "Lamb", "L2Decay",
           "sharded_norms"]
