"""fleet.meta_parallel of the port: the Megatron layers, the meta-parallel
wrappers and the Group Sharded (ZeRO) markers."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .parallel_wrappers import (DataParallel, HybridParallelOptimizer,
                                TensorParallel)
from .sharding import (DygraphShardingOptimizer, GroupShardedOptimizerStage2,
                       GroupShardedStage2, GroupShardedStage3,
                       group_sharded_parallel, save_group_sharded_model,
                       shard_parameters_over)

__all__ = ["ColumnParallelLinear", "DataParallel", "DygraphShardingOptimizer",
           "GroupShardedOptimizerStage2", "GroupShardedStage2",
           "GroupShardedStage3", "HybridParallelOptimizer",
           "ParallelCrossEntropy", "RowParallelLinear", "TensorParallel",
           "VocabParallelEmbedding", "group_sharded_parallel",
           "save_group_sharded_model", "shard_parameters_over"]
