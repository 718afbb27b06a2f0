"""Mixed precision of the port (the JAX package's `paddle_tpu.amp`)."""
from .auto_cast import (amp_dtype_for, amp_guard, amp_state, auto_cast,
                        decorate, is_bf16_supported, is_float16_supported)
from .grad_scaler import GradScaler

__all__ = ["GradScaler", "amp_dtype_for", "amp_guard", "amp_state",
           "auto_cast", "decorate", "is_bf16_supported",
           "is_float16_supported"]
