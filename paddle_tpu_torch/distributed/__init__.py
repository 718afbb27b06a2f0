"""Distributed helpers of the port (the JAX package's
`paddle_tpu.distributed`): `fleet.utils.recompute` and the checkpoint
(`checkpoint.py`: save, load and streamed load, one process)."""
from . import checkpoint  # noqa: F401
from .checkpoint import (load_sharded_model, load_state, save_sharded_model,
                         save_state)

__all__ = ["checkpoint", "load_sharded_model", "load_state",
           "save_sharded_model", "save_state"]
