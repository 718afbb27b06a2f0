"""The port's `fleet` (the JAX package's `paddle_tpu.distributed.fleet`)."""
