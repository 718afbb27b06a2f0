"""Cross-rank collectives of the port (the JAX package's
`paddle_tpu.parallel.collectives`): the counted all-reduce and all-gather
of tensor-parallel serving and the EQuARX int8 all-reduce."""
from .collectives import (TPGroup, absmax_quantize, all_gather, all_reduce,
                          quantized_allgather_sum)

__all__ = ["TPGroup", "absmax_quantize", "all_gather", "all_reduce",
           "quantized_allgather_sum"]
