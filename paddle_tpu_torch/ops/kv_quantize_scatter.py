"""The int8 KV append on the card: a hand-written CUDA kernel.

`kv_quantize_scatter` launches ``csrc/kv_quantize_scatter.cu``, the port's
counterpart of the JAX package's `_quantize_scatter` (XLA fuses it into the
compiled serve step). It appends one step's new tokens to one layer of an
int8 arena in place, growing each touched block's float32 scale and
requantizing the block's payload to it, bit-equal to the JAX function
outside the null block (which it leaves untouched: it is scratch). The
plain PyTorch version, the CPU path and the kernel's oracle, is
`serving/block_pool._quantize_scatter`; `serving/block_pool.paged_attention`
picks between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_SOURCE = "kv_quantize_scatter.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BLOCK_SIZE = 128


def _library():
    lib = _build.load_library(_SOURCE)
    fn = lib.kv_quantize_scatter_launch
    if fn.argtypes is None:
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = [
            ctypes.c_int,                          # dtype of the new tokens
            i64, i64, i64, i64, i64, i64, i64,     # B S H D bs T N
            ptr, i64, i64, i64,                    # new + strides
            ptr, i64, i64,                         # arena layer + strides
            ptr, i64,                              # scales layer + stride
            ptr, ptr, ptr,                         # offs touched touch_idx
            ptr,                                   # stream
        ]
        fn.restype = ctypes.c_int
    return lib


def _check_meta(name, t, shape, device):
    if (t.device != device or t.dtype != torch.int32
            or not t.is_contiguous() or tuple(t.shape) != shape):
        raise ValueError(f"{name} must be a contiguous int32 tensor of shape "
                         f"{shape} on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def kv_quantize_scatter(arena, scales, layer, new, offs, touched, touch_idx):
    """Append `new` [B, S, H, D] (float32 or bfloat16, unit stride on D)
    into layer `layer` of the int8 `arena` [layers, H, N, bs, D] and its
    float32 `scales` [layers, H, N] (both contiguous), in place.

    `touched` [B, T] lists the blocks each row's tokens land in (slot 0 =
    the null block), `touch_idx` [B, S] maps each token to its slot and
    `offs` [B, S] gives its offset in the block: a token's block is
    ``touched[b, touch_idx[b, s]]``, which the engine builds equal to its
    scatter slot (`_quantize_scatter` takes the slots themselves). Int32 and
    contiguous on the arena's device. Launches on the current stream without
    synchronising; the count of launches is ``kv_quantize_scatter.launches``.
    """
    dev = arena.device
    if dev.type != "cuda":
        raise ValueError(f"kv_quantize_scatter runs on CUDA tensors; the "
                         f"arena is on {dev} (block_pool._quantize_scatter "
                         "is the plain version)")
    if arena.dtype != torch.int8 or arena.dim() != 5 \
            or not arena.is_contiguous():
        raise ValueError("arena must be a contiguous int8 [layers, H, N, bs, "
                         f"D] tensor; got {arena.dtype} {tuple(arena.shape)}")
    n_layers, H, N, bs, D = arena.shape
    if (scales.device != dev or scales.dtype != torch.float32
            or not scales.is_contiguous()
            or tuple(scales.shape) != (n_layers, H, N)):
        raise ValueError(f"scales must be a contiguous float32 tensor of "
                         f"shape {(n_layers, H, N)} on {dev}")
    if new.device != dev or new.dtype not in _DTYPES:
        raise ValueError(f"new must be float32 or bfloat16 on {dev}; got "
                         f"{new.dtype} on {new.device}")
    if new.dim() != 4 or new.shape[2:] != (H, D) or new.stride(3) != 1:
        raise ValueError(f"new must be [B, S, {H}, {D}] with unit stride on "
                         f"head_dim; got {tuple(new.shape)}")
    if not 1 <= bs <= _MAX_BLOCK_SIZE:
        raise ValueError(f"block_size {bs} not in [1, {_MAX_BLOCK_SIZE}]")
    layer = int(layer)
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range [0, {n_layers})")
    B, S = new.shape[:2]
    if touched.dim() != 2:
        raise ValueError(f"touched must be [B, T]; got {tuple(touched.shape)}")
    T = touched.shape[1]
    _check_meta("offs", offs, (B, S), dev)
    _check_meta("touched", touched, (B, T), dev)
    _check_meta("touch_idx", touch_idx, (B, S), dev)
    a, sc = arena[layer], scales[layer]
    with torch.cuda.device(dev):
        err = _library().kv_quantize_scatter_launch(
            _DTYPES[new.dtype], B, S, H, D, bs, T, N,
            new.data_ptr(), new.stride(0), new.stride(1), new.stride(2),
            a.data_ptr(), a.stride(0), a.stride(1), sc.data_ptr(),
            sc.stride(0), offs.data_ptr(), touched.data_ptr(),
            touch_idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kv_quantize_scatter launch failed: CUDA error "
                           f"{err}")
    kv_quantize_scatter.launches += 1


kv_quantize_scatter.launches = 0
