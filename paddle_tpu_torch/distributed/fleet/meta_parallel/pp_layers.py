"""Pipeline-parallel layer partitioning (the JAX package's
`paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py`: reference
parallel_layers/pp_layers.py, LayerDesc:57, SharedLayerDesc:77,
PipelineLayer:209).

`PipelineLayer` builds every layer of its descriptions in this process
(the controller's copy, on which the user's optimizer steps) and records
how they split into stages (`segment_parts`, `get_stage_from_index`);
`PipelineParallel` (parallel_wrappers.py) runs them as a pipeline over
the mesh's ``pp`` ranks. Run whole, it is every stage in order (degree-1
semantics), as in the JAX package. A `SharedLayerDesc` builds its layer
once under its key: every use holds the same module, so a tied weight is
one parameter (counted once by ``parameters()``) whose gradient sums
every use.

``seg_method="cost"`` (the JAX package's cost-model balancing) waits with
the cost model (ROADMAP Queue 1, item 8i).
"""
from __future__ import annotations

import math

from torch import nn


class LayerDesc:
    """A layer to build later: `layer_cls(*inputs, **kwargs)`, an
    `nn.Module` subclass."""

    def __init__(self, layer_cls, *inputs, **kwargs):
        if not (isinstance(layer_cls, type)
                and issubclass(layer_cls, nn.Module)):
            raise TypeError("layer_cls must be a Layer subclass")
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """A layer shared by every description with its `key` (e.g. the
    embedding and the unembedding); `forward_func(layer, x)`, when given,
    is this use's forward."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _SharedCall(nn.Module):
    """One use of a shared layer through its `forward_func`."""

    def __init__(self, inner, fwd):
        super().__init__()
        self.inner = inner
        self._fwd = fwd

    def forward(self, x):
        return self._fwd(self.inner, x)


class PipelineLayer(nn.Module):
    """The layers of `layers` (descriptions, modules or plain callables)
    in order, split into `num_stages` stages by `seg_method`
    ("uniform", or "layer:ClassName": an even split of that class's
    layers). `loss_fn(output, label)` is the pipeline's loss."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None,
                 seg_sample_input=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        self.num_stages = num_stages or 1
        self._layer_descs = list(layers)
        self.shared_layers = nn.ModuleDict()
        # this process is rank 0 of the mesh: the first stage
        self.stage_id = 0
        self.run_all = True
        built = [self._build_one(d) for d in self._layer_descs]
        self.run_function = nn.ModuleList(
            [m for m in built if isinstance(m, nn.Module)])
        self._funcs = built
        self.seg_cost_us = None
        if seg_method == "cost":
            raise NotImplementedError(
                "PipelineLayer(seg_method='cost') balances stages with the "
                "cost model, which is not ported yet (ROADMAP Queue 1, "
                "item 8i)")
        self.segment_parts = self._segment(seg_method)

    def _build_one(self, desc):
        if isinstance(desc, SharedLayerDesc):
            if desc.layer_name not in self.shared_layers:
                self.shared_layers[desc.layer_name] = desc.build_layer()
            base = self.shared_layers[desc.layer_name]
            if desc.forward_func is None:
                return base
            return _SharedCall(base, desc.forward_func)
        if isinstance(desc, LayerDesc):
            return desc.build_layer()
        return desc

    def _segment(self, method):
        n = len(self._layer_descs)
        k = self.num_stages
        if method == "uniform" or not method.startswith("layer:"):
            per = int(math.ceil(n / k))
            return [min(i * per, n) for i in range(k)] + [n]
        name = method.split(":", 1)[1]
        idxs = [i for i, d in enumerate(self._layer_descs)
                if getattr(getattr(d, "layer_cls", type(d)), "__name__",
                           "") == name]
        per = int(math.ceil(len(idxs) / k))
        bounds = [idxs[min(i * per, len(idxs) - 1)] for i in range(k)]
        return [0] + bounds[1:] + [n]

    def get_stage_from_index(self, idx):
        for stage in range(self.num_stages):
            if self.segment_parts[stage] <= idx < \
                    self.segment_parts[stage + 1]:
                return stage
        return self.num_stages - 1

    def forward(self, x):
        for fn in self._funcs:
            x = fn(x)
        return x

    def loss(self, output, label):
        return self._loss_fn(output, label) if self._loss_fn else output


__all__ = ["LayerDesc", "PipelineLayer", "SharedLayerDesc"]
