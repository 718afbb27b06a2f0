"""Automatic mixed precision (the JAX package's `paddle_tpu/amp/auto_cast.py`).

- `auto_cast` / `amp_guard` set a thread-local state (`amp_state`) that
  `amp_dtype_for(op_name)` reads. As in the JAX package, no op of the
  package reads it, so O1 changes no number: the port keeps the same
  state and casts by it nowhere, and enters no `torch.autocast`.
- `decorate(models, optimizers, level="O2")` is what changes dtypes: it
  seeds each optimizer's float32 master weights from the parameters as
  they are, then casts the models to `dtype` (``Module.to`` keeps each
  `Parameter` object and swaps its data, so the optimizer's state stays
  keyed by the same parameters). The optimizer then updates the masters
  and re-casts the parameters from them (`optimizer/optimizer.py`).
"""
from __future__ import annotations

import contextlib
import threading

import torch

# ops cast to low precision (matmul/conv class): the amp white list
WHITE_LIST = {"matmul", "conv2d", "conv1d", "conv3d", "linear", "bmm", "mm",
              "einsum"}
# ops kept in float32 (reductions prone to overflow): the black list
BLACK_LIST = {"softmax", "log_softmax", "cross_entropy", "layer_norm",
              "batch_norm", "mean", "sum", "norm"}


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = "bfloat16"
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def amp_state():
    return _state


def is_bf16_supported():
    return True


def is_float16_supported():
    return True


def _torch_dtype(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    prev = (_state.enabled, _state.dtype, _state.level, _state.custom_white,
            _state.custom_black)
    _state.enabled = enable
    _state.dtype = dtype
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level, _state.custom_white,
         _state.custom_black) = prev


amp_guard = auto_cast


def amp_dtype_for(op_name):
    """The dtype an op named `op_name` would run in under the current
    `auto_cast`, or None (no cast)."""
    if not _state.enabled:
        return None
    if op_name in _state.custom_black or op_name in BLACK_LIST:
        return torch.float32
    if (_state.level == "O2" or op_name in WHITE_LIST
            or op_name in _state.custom_white):
        return _torch_dtype(_state.dtype)
    return None


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: float32 master weights in each optimizer, seeded from the
    parameters before the cast (`master_weight` None means True at O2),
    then the models cast to `dtype`. O1 changes nothing. Returns the
    models (and the optimizers) as given: one object or a list."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    opt_single = (optimizers is not None
                  and not isinstance(optimizers, (list, tuple)))
    opt_list = ([] if optimizers is None else
                [optimizers] if opt_single else list(optimizers))
    if level == "O2":
        if master_weight is None or master_weight:
            for opt in opt_list:
                opt._seed_master_weights()
        for m in model_list:
            m.to(dtype=_torch_dtype(dtype))
    if optimizers is None:
        return models if single else model_list
    return ((models if single else model_list),
            (optimizers if opt_single else opt_list))
