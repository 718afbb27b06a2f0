"""AdaRound: learned weight rounding for post-training quantization (the
JAX package's `quantization/adaround.py`, in PyTorch).

Instead of round-to-nearest, each weight learns whether to round up or
down by minimizing its layer's output reconstruction error on calibration
data, with a rectified-sigmoid relaxation annealed toward binary:
``h(alpha) = clip(1.2 * sigmoid(alpha) - 0.1, 0, 1)``, ``w_soft = (floor(w
/ s) + h(alpha)) * s``, ``loss = MSE + lam * sum(1 - |2h - 1|^beta)`` with
beta annealed high to low so h hardens to {0, 1}. The loop is the JAX
module's: torch autograd takes ``jax.grad``'s place, the Adam step is the
same hand-written one, and it runs on the weight's device.

`adaround_conv2d` (needs the Paddle-API tail's `QuantedConv2D`, ROADMAP
Queue 1 item 8) is not ported yet.
"""
from __future__ import annotations

import torch


def _h(alpha):
    return torch.clamp(torch.sigmoid(alpha) * 1.2 - 0.1, 0.0, 1.0)


def learn_rounding(w, scales, apply_fn, calib_inputs, targets, w_qmax,
                   iters=300, lr=1e-2, lam=0.01, beta_hi=20.0, beta_lo=2.0,
                   seed=0):
    """Optimize rounding for one layer's weight.

    w: float weight (array or tensor); scales: broadcastable per-channel
    scales; apply_fn(w_q, x) -> the layer's output; calib_inputs/targets:
    lists of calibration batches and the float layer's outputs on them.
    Everything runs in float32 on w's device (the CPU for an array).
    Returns the learned integer grid ``clip(floor(w/s) + (h > 0.5))`` as a
    float32 tensor on that device (the JAX function returns numpy).
    `seed` is accepted as in the JAX function, which does not read it
    either."""
    w = torch.as_tensor(w).float()
    dev = w.device
    s = torch.as_tensor(scales).to(dev, torch.float32)
    w_floor = torch.floor(w / s)
    # init alpha so h(alpha) starts at the round-to-nearest fraction
    # (paper init): frac in [0,1], alpha = -log(1.2/(frac+0.1) - 1)
    frac = torch.clamp(w / s - w_floor, 1e-4, 1 - 1e-4)
    alpha = -torch.log(1.2 / (frac + 0.1) - 1.0)

    xs = [torch.as_tensor(x).to(dev) for x in calib_inputs]
    ys = [torch.as_tensor(y).to(dev, torch.float32) for y in targets]

    def loss_fn(alpha, x, y, beta):
        soft = torch.clamp(w_floor + _h(alpha), -w_qmax, w_qmax) * s
        out = apply_fn(soft, x).float()
        mse = torch.mean((out - y) ** 2)
        h = _h(alpha)
        round_reg = torch.sum(1.0 - torch.abs(2.0 * h - 1.0) ** beta)
        return mse + lam * round_reg

    m = torch.zeros_like(alpha)
    v = torch.zeros_like(alpha)
    n = len(xs)
    for i in range(iters):
        # anneal beta high -> low: free movement early, hard rounding late
        beta = beta_hi + (beta_lo - beta_hi) * (i / max(iters - 1, 1))
        a = alpha.detach().requires_grad_()
        (g,) = torch.autograd.grad(loss_fn(a, xs[i % n], ys[i % n], beta),
                                   a)
        t = float(i + 1)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** t)
        vh = v / (1 - 0.999 ** t)
        alpha = alpha - lr * mh / (torch.sqrt(vh) + 1e-8)
    hard = (_h(alpha) > 0.5).float()
    return torch.clamp(w_floor + hard, -w_qmax, w_qmax)


@torch.no_grad()
def _reference_outputs(apply_fn, w, calib_xs):
    return [apply_fn(w, torch.as_tensor(x).to(w.device)) for x in calib_xs]


def adaround_linear(linear, calib_xs, w_qmax, **kw):
    """Learned rounding grid for an `nn.Linear`'s weight (the JAX function
    takes a `QuantedLinear` around one; the port has no such wrapper yet).
    Works in the JAX package's ``[in, out]`` orientation: returns the
    integer grid ``[in, out]`` and the per-output-channel absmax scales
    ``[out]`` (``q * scales / w_qmax`` is the quantized weight), float32
    tensors on the weight's device."""
    w = linear.weight.detach().float().t()                     # [in, out]
    scales = torch.clamp(w.abs().amax(dim=0), min=1e-8)[None, :] / w_qmax
    bias = (None if linear.bias is None
            else linear.bias.detach().float())

    def apply_fn(wq, x):
        y = x.float() @ wq
        return y if bias is None else y + bias

    targets = _reference_outputs(apply_fn, w, calib_xs)
    q = learn_rounding(w, scales, apply_fn, calib_xs, targets, w_qmax, **kw)
    return q, scales[0] * w_qmax
