"""The port's `fleet` (the JAX package's `paddle_tpu.distributed.fleet`):
`init`, `DistributedStrategy`, the topology, `distributed_model` /
`distributed_optimizer`, the meta-parallel layers and wrappers, and
`utils.recompute`."""
from ..mesh import (CommunicateTopology, HybridCommunicateGroup,  # noqa: F401
                    get_hybrid_communicate_group)
from . import meta_parallel  # noqa: F401
from .fleet import (Fleet, distributed_model,  # noqa: F401
                    distributed_optimizer, distributed_scaler, fleet, init)
from .strategy import DistributedStrategy  # noqa: F401
from .utils import recompute  # noqa: F401
