"""ZeRO / Group Sharded stages 1-3 (the JAX package's
`paddle_tpu/distributed/fleet/meta_parallel/sharding.py`).

Reference parity: dygraph_sharding_optimizer.py:29 (stage 1),
group_sharded_stage2.py:46 + group_sharded_optimizer_stage2.py:53 (stage
2), group_sharded_stage3.py:59 (stage 3), public API group_sharded.py:37.

As in the JAX package these classes are markers carrying ``zero_stage``:
the train step (`parallel.spmd.make_sharded_train_step`) does the
sharding: over the dp ranks on a pure-dp mesh (the explicit path), over
the ``sharding`` axis of a hybrid mesh otherwise, where a parameter that
`shard_parameters_over` annotated lives as its slice over that axis. It takes a wrapped model and optimizer as it takes any
other, through their inner model and optimizer, so parameter names and
state keys are the inner model's. A wrapped model's eager forward runs
the inner model unsharded and warns once that it does.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
from torch import nn


def _warn_unsharded_eager(wrapper, stage):
    """A Stage2/3 wrapper only marks the model for the sharded train step:
    a plain eager forward runs the inner model unsharded. Warn once, so a
    ZeRO wrapper in an eager loop never trains without ZeRO unnoticed."""
    if getattr(wrapper, "_warned_unsharded", False):
        return
    wrapper._warned_unsharded = True
    warnings.warn(
        f"GroupShardedStage{stage}: this eager forward runs the wrapped "
        "layer UNSHARDED — the ZeRO wrapper only marks the model for the "
        "sharded train step. Train through "
        f"parallel.spmd.make_sharded_train_step(..., zero_stage={stage}) "
        "over a dp mesh to get sharded memory and communication.",
        stacklevel=3,
    )


def _largest_divisible_dim(shape, degree):
    best = None
    for i, s in enumerate(shape):
        if s % degree == 0 and (best is None or s > shape[best]):
            best = i
    return best


def shard_parameters_over(layer, degree, axis_name="sharding", min_numel=1):
    """Annotate each parameter's largest divisible dim for ZeRO-3 (a
    ``sharding_axes`` tuple on the `nn.Parameter`).

    `min_numel` plays the reference's segment_size role
    (group_sharded_stage3.py:59 `segment_size`, in elements here): params
    below it stay replicated — sharding tiny tensors buys no memory and
    costs an all-gather per use. A parameter already annotated with a
    non-empty axis keeps its annotation."""
    for _, p in layer.named_parameters():
        axes = getattr(p, "sharding_axes", None)
        if axes is not None and any(a for a in axes):
            continue
        dim = _largest_divisible_dim(tuple(p.shape), degree)
        if dim is not None and int(np.prod(p.shape)) >= max(degree,
                                                            min_numel):
            axes = [None] * p.dim()
            axes[dim] = axis_name
            p.sharding_axes = tuple(axes)


class DygraphShardingOptimizer:
    """Stage 1 (reference :29): optimizer-state sharding marker."""

    def __init__(self, optimizer, hcg=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self.zero_stage = 1

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)


class GroupShardedOptimizerStage2:
    """Stage 2 (reference group_sharded_optimizer_stage2.py:53): optimizer
    state and gradients sharded. The train step reads ``zero_stage=2``
    from its caller and reduce-scatters the gradients."""

    def __init__(self, params, optim, group=None, offload=False,
                 device="gpu", **kw):
        if offload:
            raise NotImplementedError(
                "GroupShardedOptimizerStage2(offload=True): host-offloaded "
                "optimizer state is not supported — the memory saving comes "
                "from sharding over the data-parallel ranks (grow the dp "
                "degree instead); a host-resident Adam step would serialize "
                "every update through host transfers")
        self._inner_opt = optim
        self.zero_stage = 2

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)


class GroupShardedStage2(nn.Module):
    """Stage 2 model marker (reference group_sharded_stage2.py:46)."""

    def __init__(self, layer, sharding_optimizer, group=None,
                 sync_buffers=False, buffer_max_size=2**23,
                 auto_refresh_trainable=True, device="gpu"):
        super().__init__()
        self._layers = layer
        self._sharding_optimizer = sharding_optimizer
        self.zero_stage = 2

    def forward(self, *inputs, **kwargs):
        _warn_unsharded_eager(self, 2)
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)


class GroupShardedStage3(nn.Module):
    """Stage 3 model marker (reference group_sharded_stage3.py:59)."""

    def __init__(self, layer, optimizer, group=None, sync_buffers=False,
                 device="gpu", segment_size=None, pertrain_sync_models=True,
                 offload=False, sync_comm=False, **kw):
        super().__init__()
        if offload:
            raise NotImplementedError(
                "GroupShardedStage3(offload=True): host offload is not "
                "supported — shard over more data-parallel ranks instead "
                "(see GroupShardedOptimizerStage2 for the reason)")
        self._layers = layer
        self._optimizer = optimizer
        self.zero_stage = 3
        # segment_size (bytes in the reference) maps to a replicate-below
        # threshold: sharding tiny tensors buys no memory and costs an
        # all-gather per use. None = shard everything divisible. The
        # 4-byte divisor assumes f32 params (for bf16 it errs toward
        # replicating more small tensors, never toward running out of
        # memory).
        degree = self._degree(group)
        min_numel = (degree if segment_size is None
                     else max(1, int(segment_size) // 4))
        if degree > 1:
            shard_parameters_over(layer, degree, min_numel=min_numel)

    @staticmethod
    def _degree(group):
        """The group's size (``nranks`` or ``size``), else the process
        mesh's 'sharding' degree (distributed/mesh.py)."""
        for attr in ("nranks", "size"):
            if group is not None and hasattr(group, attr):
                return int(getattr(group, attr))
        from ...mesh import get_mesh

        mesh = get_mesh()
        return mesh.shape.get("sharding", 1) if mesh is not None else 1

    def forward(self, *inputs, **kwargs):
        _warn_unsharded_eager(self, 3)
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)

    def get_all_parameters(self, convert2cpu=False):
        return self._layers.parameters()


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2**23, segment_size=None,
                           sync_comm=False):
    """Reference distributed/sharding/group_sharded.py:37: wrap `model` and
    `optimizer` for ZeRO `level` "os" (stage 1), "os_g" (stage 2) or
    "p_g_os" (stage 3). Returns ``(model, optimizer, scaler)``."""
    if level == "os":
        opt = DygraphShardingOptimizer(optimizer)
        return model, opt, scaler
    if level == "os_g":
        opt = GroupShardedOptimizerStage2(model.parameters(), optimizer, group,
                                          offload)
        wrapped = GroupShardedStage2(model, opt, group, sync_buffers,
                                     buffer_max_size)
        return wrapped, opt, scaler
    if level == "p_g_os":
        wrapped = GroupShardedStage3(model, optimizer, group, sync_buffers,
                                     segment_size=segment_size,
                                     offload=offload)
        return wrapped, optimizer, scaler
    raise ValueError(f"level must be os | os_g | p_g_os, got {level}")


def save_group_sharded_model(model, output, optimizer=None):
    """Save the inner model's state dict to ``output + ".pdparams"`` and the
    optimizer's to ``output + ".pdopt"`` (`torch.save`)."""
    torch.save(model.state_dict(), output + ".pdparams")
    if optimizer is not None:
        torch.save(optimizer.state_dict(), output + ".pdopt")


__all__ = ["DygraphShardingOptimizer", "GroupShardedOptimizerStage2",
           "GroupShardedStage2", "GroupShardedStage3",
           "group_sharded_parallel", "save_group_sharded_model",
           "shard_parameters_over"]
