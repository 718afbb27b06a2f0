"""Flash attention: the hand-written CUDA kernels and their plain version.

The counterpart of `paddle_tpu/ops/pallas/flash_attention.py`, on
``[batch, seq, heads, head_dim]`` tensors with scale 1/sqrt(head_dim) and
bottom-right causal alignment (query i sees key j when i + sk - sq >= j).

- `attention_ref` is the plain PyTorch version (`_attention_xla` without
  mask or dropout): f32 scores, P cast to v's dtype before P V.
- `flash_attention_fwd` launches the forward kernel of
  ``csrc/flash_attention.cu`` (the port of `_fwd_kernel`) and returns O and
  the f32 log-sum-exp ``[B*H, Sq]``; `flash_attention_bwd` computes
  ``delta = rowsum(dO * O)`` in plain torch (plain XLA in the JAX package)
  and launches the dK/dV and dQ kernels (`_dkv_kernel`, `_dq_kernel`).
- `FlashAttention` is the autograd function around the two directions
  (the counterpart of `_flash_custom`).
- `flash_attention` chooses by the tensor's device alone: a CPU tensor
  takes autograd through `attention_ref`, a CUDA tensor the kernels. There
  is no switch and no fallback: a CUDA call the kernels cannot take raises.
  Unlike the JAX dispatch, there is no fallback for sequence lengths the
  tiles do not divide either: the kernels mask their own ragged edge.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_NEG_INF = -1e30
_SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MASK_TODO = ("the additive-mask variant of the flash kernels is not ported "
              "yet (ROADMAP Queue 2, items 2-4)")
_DROPOUT_TODO = ("the dropout variant of the flash kernels is not ported "
                 "yet (ROADMAP Queue 2, items 2-4)")


def _scores(q, k, causal):
    """Scaled f32 scores [B, H, Sq, Sk], masked to -1e30 above the
    bottom-right causal diagonal."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    if causal:
        keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        s = s.masked_fill(~keep.tril(sk - sq), _NEG_INF)
    return s


def attention_ref(q, k, v, causal=False):
    """Plain attention on [B, S, H, D]: softmax of the f32 scores, P cast
    to v's dtype before P V. Returns [B, Sq, H, D] in v's dtype."""
    p = torch.softmax(_scores(q, k, causal), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def attention_lse_ref(q, k, causal=False):
    """The log-sum-exp of each query's scores, [B*H, Sq] f32: what the
    forward kernel stores for the backward."""
    s = _scores(q, k, causal)
    return torch.logsumexp(s, dim=-1).reshape(-1, q.shape[1])


class _View(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_int64),
                ("ss", ctypes.c_int64), ("sh", ctypes.c_int64)]


class _Args(ctypes.Structure):
    """`FlashArgs` of csrc/flash_attention.cu, field for field."""
    _fields_ = ([(n, ctypes.c_int64) for n in ("B", "H", "Sq", "Sk")]
                + [(n, _View) for n in ("q", "k", "v", "o", "dout", "dq",
                                        "dk", "dv")]
                + [("lse", ctypes.c_void_p), ("delta", ctypes.c_void_p),
                   ("scale", ctypes.c_float), ("causal", ctypes.c_int32)])


def _library():
    lib = _build.load_library(_SOURCE)
    if lib.flash_attention_fwd_launch.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        args = ctypes.POINTER(_Args)
        lib.flash_attention_fwd_launch.argtypes = [ctypes.c_int, i64, args,
                                                   ptr]
        lib.flash_attention_fwd_launch.restype = ctypes.c_int
        lib.flash_attention_bwd_launch.argtypes = [ctypes.c_int, i64,
                                                   ctypes.c_int, args, ptr]
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
    return lib


def _view(t):
    return _View(t.data_ptr(), t.stride(0), t.stride(1), t.stride(2))


def _check(name, t, shape, dtype, device):
    """Raise unless `t` is a [B, S, H, D] CUDA tensor the kernels read:
    the given shape and dtype, unit stride on D, every row 16-byte
    aligned."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}; got {t.dtype} "
                         f"on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    size = t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16 or any(
            s * size % 16 for s in t.stride()[:3]):
        raise ValueError(f"{name} needs unit stride on head_dim and "
                         "16-byte aligned rows")


def _check_qkv(q, k, v):
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels run on CUDA tensors; q is on "
                         f"{q.device} (attention_ref is the plain version)")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D]; got {tuple(q.shape)}")
    B, Sq, H, D = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernels take "
                         "float32 and bfloat16")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"batch * heads = {B * H} exceeds 65535")
    _check("q", q, q.shape, q.dtype, q.device)
    Sk = k.shape[1] if k.dim() == 4 else -1
    _check("k", k, (B, Sk, H, D), q.dtype, q.device)
    _check("v", v, (B, Sk, H, D), q.dtype, q.device)
    return B, Sq, Sk, H, D


def _args(q, k, v, causal, **views):
    B, Sq, H, D = q.shape
    a = _Args(B=B, H=H, Sq=Sq, Sk=k.shape[1], q=_view(q), k=_view(k),
              v=_view(v), scale=1.0 / math.sqrt(D), causal=int(bool(causal)))
    for name, t in views.items():
        if name in ("lse", "delta"):
            setattr(a, name, t.data_ptr())
        else:
            setattr(a, name, _view(t))
    return a


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def flash_attention_fwd(q, k, v, causal=False):
    """The forward kernel. q: [B, Sq, H, D], k and v: [B, Sk, H, D] on the
    card, float32 or bfloat16, D 64 or 128, unit stride on D. Returns
    (o [B, Sq, H, D] in q's dtype, lse [B*H, Sq] f32). Launches on the
    current stream without synchronising. The count of launches is
    ``flash_attention_fwd.launches``."""
    B, Sq, Sk, H, D = _check_qkv(q, k, v)
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    a = _args(q, k, v, causal, o=o, lse=lse)
    with torch.cuda.device(q.device):
        err = _library().flash_attention_fwd_launch(
            _DTYPES[q.dtype], D, ctypes.byref(a),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def _launch_bwd(q, k, v, do, lse, delta, causal, which):
    """Launch the dK/dV kernel (`which` 1), the dQ kernel (2) or both (3);
    returns (dq, dk, dv), None for what was not computed. Counts nothing:
    `flash_attention_bwd` is the counted entry."""
    B, Sq, Sk, H, D = _check_qkv(q, k, v)
    _check("do", do, q.shape, q.dtype, q.device)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (B * H, Sq) or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[{B * H}, {Sq}] on {q.device}")
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) \
        if which & 2 else None
    dk = torch.empty((B, Sk, H, D), dtype=q.dtype, device=q.device) \
        if which & 1 else None
    dv = torch.empty_like(dk) if which & 1 else None
    views = {n: t for n, t in (("dq", dq), ("dk", dk), ("dv", dv))
             if t is not None}
    a = _args(q, k, v, causal, dout=do, lse=lse, delta=delta, **views)
    with torch.cuda.device(q.device):
        err = _library().flash_attention_bwd_launch(
            _DTYPES[q.dtype], D, which, ctypes.byref(a),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention_bwd")
    return dq, dk, dv


def _delta(o, do):
    """rowsum(dO * O) in f32, [B*H, Sq]: the backward's precompute (plain
    XLA in the JAX package)."""
    B, Sq, H, _ = o.shape
    return (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
        B * H, Sq).contiguous()


def flash_attention_bwd(q, k, v, o, do, lse, causal=False):
    """The backward: delta = rowsum(dO * O) in f32 (plain torch), then the
    dK/dV kernel and the dQ kernel. q, k, v, o and lse as the forward
    took and gave them; do is dL/dO [B, Sq, H, D]. Returns (dq, dk, dv) in
    q's dtype. One counted launch (``flash_attention_bwd.launches``) is the
    pair of CUDA kernels, `flash_dkv` then `flash_dq`."""
    out = _launch_bwd(q, k, v, do, lse, _delta(o, do), causal, 3)
    flash_attention_bwd.launches += 1
    return out


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention on CUDA tensors: the forward kernel saves q, k, v,
    o and the LSE; the backward runs the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal=False, mask=None, dropout_p=0.0):
    """Attention on [B, S, H, D], differentiable, chosen by q's device: a
    CPU tensor takes autograd through `attention_ref`, a CUDA tensor the
    kernels. An additive mask or dropout raises NotImplementedError (those
    variants of the kernels are not ported yet)."""
    if mask is not None:
        raise NotImplementedError(f"flash_attention: {_MASK_TODO}")
    if dropout_p > 0.0:
        raise NotImplementedError(f"flash_attention: {_DROPOUT_TODO}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal)
    if q.device.type == "cuda":
        return FlashAttention.apply(q, k, v, bool(causal))
    raise ValueError(f"no flash attention for device {q.device}")
