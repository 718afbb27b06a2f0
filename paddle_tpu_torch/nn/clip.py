"""Gradient clipping (the JAX package's `paddle_tpu/nn/clip.py`).

`ClipGradByValue`, `ClipGradByNorm` and `ClipGradByGlobalNorm` with the
JAX package's arithmetic, on lists of tensors: `clip_arrays(grads)` (the
form an optimizer's `grad_clip` calls) and ``clip(params_grads)`` on
``(parameter, gradient)`` pairs. `clip_grad_norm_` and `clip_grad_value_`
clip the parameters' ``.grad`` in place.

Every scale stays a device tensor: no `.item()`, no host sync. Python
scalars meet a tensor in its own dtype, as JAX's weakly typed scalars do,
and the global-norm clip multiplies in float32 before rounding back, as
the JAX ``(g * scale).astype(g.dtype)`` does for a float32 `scale`, so
bfloat16 gradients come out with the JAX package's bits.

Over sharded gradients (a tensor-parallel or ZeRO rank's slices:
parallel/spmd.py), `clip_arrays` takes ``groups``, one entry a gradient:
the `parallel.collectives.RankGroup` its tensor is sharded over, or None
for a replicated one. A norm then sums each sharded leaf's squared norm
over its group (one all-reduce a group for the global norm, one a leaf
for the per-tensor norm), and counts each replicated leaf once.
"""
from __future__ import annotations

import torch


def _sq_sums(grads, groups):
    """{group key: (group, f32 sum of the squared norms of the gradients
    sharded over it)}; key None for the replicated ones."""
    out = {}
    for g, grp in zip(grads, groups):
        sq = torch.sum(torch.square(g.float()))
        key = None if grp is None else id(grp)
        have = out.get(key)
        out[key] = (grp, sq if have is None else have[1] + sq)
    return out


def _group_sum(sq, group):
    """`sq` summed over `group`'s ranks (one counted all-reduce)."""
    from ..parallel.collectives import all_reduce

    return all_reduce(sq.reshape(1).clone(), group)[0]


class ClipGradBase:
    def __call__(self, params_grads):
        """Clip the gradients of ``(parameter, gradient)`` pairs; a None
        gradient, or a parameter with ``need_clip`` False, passes as it
        is."""
        idx = [i for i, (p, g) in enumerate(params_grads)
               if g is not None and getattr(p, "need_clip", True)]
        out = list(params_grads)
        clipped = self.clip_arrays([params_grads[i][1] for i in idx])
        for i, g in zip(idx, clipped):
            out[i] = (params_grads[i][0], g)
        return out


class ClipGradByValue(ClipGradBase):
    """Each gradient entry clamped to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def clip_arrays(self, grads, groups=None):
        return [None if g is None else torch.clamp(g, self.min, self.max)
                for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by min(clip_norm / max(|g|, 1e-12), 1), its
    norm taken in its own dtype."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def clip_arrays(self, grads, groups=None):
        out = []
        for i, g in enumerate(grads):
            if g is None:
                out.append(None)
                continue
            grp = None if groups is None else groups[i]
            if grp is None:
                norm = torch.sqrt(torch.sum(torch.square(g)))
            else:
                sq = torch.sum(torch.square(g.float()))
                norm = torch.sqrt(_group_sum(sq, grp)).to(g.dtype)
            scale = torch.clamp(torch.full_like(norm, self.clip_norm)
                                / torch.clamp(norm, min=1e-12), max=1.0)
            out.append(g * scale)
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by clip_norm / max(global norm, clip_norm),
    the global norm taken over all of them in float32. `global_norm`
    holds the last call's pre-clip norm (a float32 tensor on the
    gradients' device; reading it syncs)."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.global_norm = None

    def clip_arrays(self, grads, groups=None):
        live = [g for g in grads if g is not None]
        if not live:
            return grads
        if groups is not None and any(x is not None for x in groups):
            sums = _sq_sums(live, [x for g, x in zip(grads, groups)
                                   if g is not None])
            total = None
            for key, (grp, sq) in sums.items():
                sq = sq if key is None else _group_sum(sq, grp)
                total = sq if total is None else total + sq
            self.global_norm = torch.sqrt(total)
        else:
            norms = torch._foreach_norm(live, 2, dtype=torch.float32)
            self.global_norm = torch.linalg.vector_norm(torch.stack(norms))
        scale = (torch.full_like(self.global_norm, self.clip_norm)
                 / torch.clamp(self.global_norm, min=self.clip_norm))
        clipped = iter(torch._foreach_mul([g.float() for g in live], scale))
        return [None if g is None else next(clipped).to(g.dtype)
                for g in grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``.grad`` of `parameters` in place by min(max_norm /
    max(total, 1e-6), 1), total = (sum |g|^norm_type)^(1/norm_type) in
    the gradients' dtype; returns total (a tensor; 0.0 with no gradient).
    `error_if_nonfinite` is taken and not read, as in the JAX package."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return torch.tensor(0.0)
    total = None
    for p in params:
        s = torch.sum(torch.pow(torch.abs(p.grad), norm_type))
        total = s if total is None else total + s
    total = torch.pow(total, 1.0 / norm_type)
    scale = torch.clamp(torch.full_like(total, max_norm)
                        / torch.clamp(total, min=1e-6), max=1.0)
    for p in params:
        p.grad = p.grad * scale
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp every ``.grad`` of `parameters` to [-clip_value, clip_value]
    in place."""
    for p in parameters:
        if p.grad is not None:
            p.grad = torch.clamp(p.grad, -clip_value, clip_value)
