"""fleet.meta_parallel of the port: the Group Sharded (ZeRO) markers."""
from .sharding import (DygraphShardingOptimizer, GroupShardedOptimizerStage2,
                       GroupShardedStage2, GroupShardedStage3,
                       group_sharded_parallel, save_group_sharded_model,
                       shard_parameters_over)

__all__ = ["DygraphShardingOptimizer", "GroupShardedOptimizerStage2",
           "GroupShardedStage2", "GroupShardedStage3",
           "group_sharded_parallel", "save_group_sharded_model",
           "shard_parameters_over"]
