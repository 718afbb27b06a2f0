"""Post-training weight quantization (the JAX package's `quantization`):
AdaRound's learned rounding (adaround.py)."""
