"""Distributed training helpers of the port (the JAX package's
`paddle_tpu.distributed`): so far `fleet.utils.recompute`."""
