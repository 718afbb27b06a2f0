"""fleet.meta_parallel of the port: the Megatron layers, the meta-parallel
wrappers, the pipeline layers and the Group Sharded (ZeRO) markers."""
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                        RowParallelLinear, VocabParallelEmbedding)
from .parallel_wrappers import (DataParallel, HybridParallelGradScaler,
                                HybridParallelOptimizer, PipelineParallel,
                                TensorParallel)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc
from .sharding import (DygraphShardingOptimizer, GroupShardedOptimizerStage2,
                       GroupShardedStage2, GroupShardedStage3,
                       group_sharded_parallel, save_group_sharded_model,
                       shard_parameters_over)

__all__ = ["ColumnParallelLinear", "DataParallel", "DygraphShardingOptimizer",
           "GroupShardedOptimizerStage2", "GroupShardedStage2",
           "GroupShardedStage3", "HybridParallelGradScaler",
           "HybridParallelOptimizer", "LayerDesc", "PipelineLayer",
           "PipelineParallel", "SharedLayerDesc",
           "ParallelCrossEntropy", "RowParallelLinear", "TensorParallel",
           "VocabParallelEmbedding", "group_sharded_parallel",
           "save_group_sharded_model", "shard_parameters_over"]
