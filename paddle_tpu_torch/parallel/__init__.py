"""Cross-rank collectives and data-parallel training of the port (the JAX
package's `paddle_tpu.parallel`): the counted collectives and EQuARX int8
collectives (`collectives.py`), the ZeRO train step and LocalSGD
(`spmd.py`), the pipeline schedules (`pipeline.py`), and attention over
``sp``: the ring (`ring_attention.py`) and K/V gathered over the group
(`sequence_attention.py`)."""
from .collectives import (RankGroup, TPGroup, absmax_quantize, all_gather,
                          all_reduce, all_to_all, quantized_allgather_sum,
                          quantized_psum_scatter, recv_, reduce_scatter,
                          send)

__all__ = ["RankGroup", "TPGroup", "absmax_quantize", "all_gather",
           "all_reduce", "all_to_all", "quantized_allgather_sum",
           "quantized_psum_scatter", "recv_", "reduce_scatter", "send"]
