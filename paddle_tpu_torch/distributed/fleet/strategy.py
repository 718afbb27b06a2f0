"""DistributedStrategy (the JAX package's
`paddle_tpu/distributed/fleet/strategy.py`: reference
fleet/base/distributed_strategy.py:117 over distributed_strategy.proto).

A plain config object. `fleet.init` reads ``hybrid_configs`` (the dp /
mp / pp / sharding / sep degrees); the other fields keep the JAX
package's names and defaults and are read by whatever takes the strategy.
"""
from __future__ import annotations


class HybridConfig(dict):
    """The hybrid degrees, a dict with attribute access."""

    def __init__(self, **kw):
        super().__init__(dp_degree=1, mp_degree=1, pp_degree=1,
                         sharding_degree=1, sep_degree=1)
        self.update(kw)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = HybridConfig()
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0,
            "use_dynamic_loss_scaling": True,
            "use_pure_fp16": False,
            "custom_white_list": [],
            "custom_black_list": [],
            "dtype": "bfloat16",
        }
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "degree": 1, "offload": False}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.lamb = False
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                             "epsilon": 0.0}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "sparsity": [0.999]}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.find_unused_parameters = False
        self.heter_ccl_mode = False
        self.without_graph_optimization = True

    @property
    def sharding_degree(self):
        return self.sharding_configs.get("degree", 1)

    def __repr__(self):
        keys = ["hybrid_configs", "amp", "recompute", "sharding", "pipeline"]
        return "DistributedStrategy(" + ", ".join(
            f"{k}={getattr(self, k)}" for k in keys) + ")"


__all__ = ["DistributedStrategy", "HybridConfig"]
