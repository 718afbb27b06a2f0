"""Distributed helpers of the port (the JAX package's
`paddle_tpu.distributed`): `fleet` (`init`, the strategy, the Megatron
layers, `utils.recompute`), Mixture of Experts (`moe.py`), the checkpoint
(`checkpoint.py`: save, load and streamed load, one process), the rank
processes (`ranks.py`), the training mesh and hybrid topology (`mesh.py`)
and the Group Sharded markers (`fleet.meta_parallel`)."""
from . import checkpoint  # noqa: F401
from . import fleet  # noqa: F401
from . import moe  # noqa: F401
from .checkpoint import (load_sharded_model, load_state, save_sharded_model,
                         save_state)
from .fleet.meta_parallel import (group_sharded_parallel,
                                  save_group_sharded_model)
from .mesh import (CommunicateTopology, HybridCommunicateGroup, build_mesh,
                   get_hybrid_communicate_group, get_mesh, init_mesh,
                   set_mesh)

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "build_mesh",
           "checkpoint", "fleet", "get_hybrid_communicate_group",
           "get_mesh", "group_sharded_parallel", "init_mesh", "moe",
           "load_sharded_model", "load_state", "save_group_sharded_model",
           "save_sharded_model", "save_state", "set_mesh"]
