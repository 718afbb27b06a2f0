"""Meta-parallel model and optimizer wrappers (the JAX package's
`paddle_tpu/distributed/fleet/meta_parallel/parallel_wrappers.py`:
reference meta_parallel/tensor_parallel.py:27,
dygraph_optimizer/hybrid_parallel_optimizer.py:186).

As in the JAX package these mark intent: the train step over the mesh
(parallel/spmd.py) does the partitioning and the gradient sync, and takes
a wrapped model and optimizer through their inner ones (``_layers``,
``_inner_opt``), so parameter names and state keys are the inner model's.
A wrapped model's eager forward is the inner model's; the global-norm clip
of a `HybridParallelOptimizer` inside the step sums over the mp and
sharding groups (nn/clip.py). The strategy's meta-optimizers (Lars, DGC,
gradient merge, LocalSGD) are not taken here: gradient merge and LocalSGD
are the step's own options (``gradient_merge_k``, `LocalSGDTrainStep`),
Lars and DGC wait with the optimizer rules of ROADMAP item 8. The
pipeline wrappers wait for item 8 too.
"""
from __future__ import annotations

from torch import nn


class _Wrapper(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self._layers = layers

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)


class DataParallel(_Wrapper):
    """A data-parallel marker (the JAX `distributed.DataParallel`): the
    train step all-reduces the gradients over dp."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__(layers)
        self.find_unused_parameters = find_unused_parameters


class TensorParallel(_Wrapper):
    """A tensor-parallel marker (reference tensor_parallel.py:27)."""

    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers)
        self._hcg = hcg


class HybridParallelOptimizer:
    """Wraps the inner optimizer (reference hybrid_parallel_optimizer.py:
    186); every attribute is the inner one's."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        for flag, why in (("lars", "Lars"), ("dgc", "DGCMomentum")):
            if strategy is not None and getattr(strategy, flag, False):
                raise NotImplementedError(
                    f"strategy.{flag}: {why} is not ported yet (ROADMAP "
                    "Queue 1, item 8)")
        for flag, where in (("gradient_merge",
                             "make_sharded_train_step(gradient_merge_k=)"),
                            ("localsgd", "parallel.spmd.LocalSGDTrainStep")):
            if strategy is not None and getattr(strategy, flag, False):
                raise NotImplementedError(
                    f"strategy.{flag} through the wrapper is not ported: the "
                    f"train step does it ({where})")
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)


__all__ = ["DataParallel", "HybridParallelOptimizer", "TensorParallel"]
