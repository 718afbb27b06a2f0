"""Flash attention: the hand-written CUDA kernels and their plain version.

The counterpart of `paddle_tpu/ops/pallas/flash_attention.py`, on
``[batch, seq, heads, head_dim]`` tensors with scale 1/sqrt(head_dim) and
bottom-right causal alignment (query i sees key j when i + sk - sq >= j),
with `_attention_xla`'s optional mask and dropout:

- a float mask broadcastable to ``[B, H, Sq, Sk]`` is added to the scaled
  scores; a bool mask keeps the scores where it is True and puts -1e30
  elsewhere;
- dropout with probability `dropout_p` scales the kept probabilities by
  1/(1 - p); the keep bits are `ops/philox.py`'s, a pure function of
  (seed, batch*head, query, key), so the kernels and the plain version
  drop the same entries. The head coordinate is the model's: a
  tensor-parallel rank that holds heads ``[head_offset, head_offset + H)``
  of ``heads_total`` passes both, and its bits are ``b * heads_total +
  head_offset + h``, the ones the whole model draws for those heads
  (defaults: ``heads_total = H``, offset 0). The query coordinate is the
  whole sequence's too: a launch whose queries start at row ``q_row0`` of
  it (a sequence-parallel rank's slice, parallel/sequence_attention.py;
  `flash_attention_fwd` / `_bwd` and the plain versions take it) draws
  rows ``q_row0 + i``; the key coordinate is k's own row, k holding the
  sequence from its start (default ``q_row0 = 0``).

- `attention_ref` is the plain PyTorch version, with the kernels' rounding
  points: f32 scores, P (zeroed where dropout drops it) cast to v's dtype
  before P V, and dropout's 1/(1 - p) applied to the f32 product. The TPU
  kernel rounds P/(1 - p) instead, one bf16 rounding more; in float32 the
  two agree to a rounding.
- `flash_attention_fwd` launches the forward kernel of
  ``csrc/flash_attention.cu`` (the port of `_fwd_kernel`) and returns O and
  the f32 log-sum-exp ``[B*H, Sq]`` of the undropped scores;
  `flash_attention_bwd` computes ``delta = rowsum(dO * O)`` in plain torch
  (plain XLA in the JAX package) and launches the dK/dV and dQ kernels
  (`_dkv_kernel`, `_dq_kernel`). Each counts its launches in `.launches`,
  and those with a mask or dropout also in `.mask_launches` /
  `.dropout_launches`. In bfloat16 all three kernels are the sm_90a
  designs (TMA tile loads through tensor maps over the views' strides,
  wgmma); in float32 all three run split-precision (3xTF32) products on
  the tensor cores through mma.sync, to f32 accuracy.
- `FlashAttention` is the autograd function around the two directions
  (the counterpart of `_flash_custom`). With dropout on bfloat16 inputs
  the forward kernel also writes O in f32, and the backward's delta is
  taken from it: where attention sits on one key, O = v/(1 - p) is not a
  bf16 value, and a delta from the rounded O carries that rounding into
  dQ and dK (the TPU kernel takes the rounded O). A mask that requires a
  gradient gets ``P * (dP D - delta)`` (D the dropout factors),
  recomputed in plain torch from the saved LSE and summed over the mask's
  broadcast dims.
- `flash_attention` chooses by the tensor's device alone: a CPU tensor
  takes autograd through `attention_ref`, a CUDA tensor the kernels. There
  is no switch and no fallback: a CUDA call the kernels cannot take raises.
  Unlike the JAX dispatch, there is no fallback for sequence lengths the
  tiles do not divide, nor for mask plus dropout (the kernels replay the
  same bits): the kernels mask their own ragged edge.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import philox

_NEG_INF = -1e30
_SOURCE = "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _scores(q, k, causal, mask=None):
    """Scaled f32 scores [B, H, Sq, Sk], masked to -1e30 above the
    bottom-right causal diagonal, then the mask applied: added when it is
    a float mask, -1e30 where a bool mask is False."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    if causal:
        keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        s = s.masked_fill(~keep.tril(sk - sq), _NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            s = s.masked_fill(~mask, _NEG_INF)
        else:
            s = s + mask.float()
    return s


def _check_dropout(dropout_p, seed):
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must lie in [0, 1); got {dropout_p}")
    if dropout_p > 0.0 and seed is None:
        raise ValueError("dropout needs a seed (the keep bits are "
                         "philox(seed, batch*head, query, key))")


def drop_heads(b, h, head_offset=0, heads_total=None, device=None):
    """The keep bits' batch*head coordinates of a [b, ., h, .] call, in
    (batch, head) order: ``b * heads_total + head_offset + h`` (the
    model's head numbering; ``heads_total`` defaults to `h`)."""
    total = h if heads_total is None else int(heads_total)
    if head_offset < 0 or head_offset + h > total:
        raise ValueError(f"heads [{head_offset}, {head_offset + h}) do not "
                         f"lie in the model's {total}")
    bi = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    hi = torch.arange(h, dtype=torch.int64, device=device)[None, :]
    return (bi * total + head_offset + hi).reshape(-1)


def dropout_factors(seed, dropout_p, b, h, sq, sk, device=None,
                    head_offset=0, heads_total=None, q_row0=0):
    """The dropout factors D [b, h, sq, sk] f32: 1/(1 - p) where
    `philox.keep_mask` keeps, 0 where it drops (heads numbered as
    `drop_heads` numbers them, queries from row `q_row0`)."""
    keep = philox.keep_mask(seed, dropout_p, drop_heads(
        b, h, head_offset, heads_total, device), sq, sk, device, q_row0)
    return keep.view(b, h, sq, sk).float() * (1.0 / (1.0 - dropout_p))


def attention_ref(q, k, v, causal=False, mask=None, dropout_p=0.0,
                  seed=None, head_offset=0, heads_total=None, q_row0=0):
    """Plain attention on [B, S, H, D]: softmax of the f32 scores (with the
    mask), P cast to v's dtype before P V. With `dropout_p` > 0, P is
    zeroed where `philox.keep_mask` of `seed` drops it before the cast
    (heads numbered from `head_offset` of `heads_total`, queries from row
    `q_row0`), and the f32 product is scaled by 1/(1 - p), as the kernels
    do. Returns [B, Sq, H, D] in v's dtype."""
    _check_dropout(dropout_p, seed)
    p = torch.softmax(_scores(q, k, causal, mask), dim=-1)
    if dropout_p == 0.0:
        return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    B, Sq, H, _ = q.shape
    keep = philox.keep_mask(seed, dropout_p, drop_heads(
        B, H, head_offset, heads_total, q.device), Sq, k.shape[1], q.device,
        q_row0)
    p = p.masked_fill(~keep.view(p.shape), 0.0).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return (o * (1.0 / (1.0 - dropout_p))).to(v.dtype)


def attention_lse_ref(q, k, causal=False, mask=None):
    """The log-sum-exp of each query's scores, [B*H, Sq] f32: what the
    forward kernel stores for the backward."""
    s = _scores(q, k, causal, mask)
    return torch.logsumexp(s, dim=-1).reshape(-1, q.shape[1])


def attention_bwd_ref(q, k, v, o, do, lse, causal=False, mask=None,
                      dropout_p=0.0, seed=None, head_offset=0,
                      heads_total=None, q_row0=0):
    """The plain version of `flash_attention_bwd`: (dq, dk, dv) in q's
    dtype from the saved `o` and `lse` ([B*H, Sq] f32), with P = exp(S -
    lse), delta = rowsum(dO * O) and the dropout factors D of
    `dropout_factors` (1 without dropout): dV = (P D)^T dO, dS = P (dO V^T
    D - delta) / sqrt(head_dim), as the kernels take them, all in f32.
    Given the LSE and O of a longer row than `k` covers (ring attention's
    merged ones), it is that block's share of the gradients."""
    B, Sq, H, D = q.shape
    p = torch.exp(_scores(q, k, causal, mask) - lse.view(B, H, Sq, 1))
    dof = do.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    pd = p
    if dropout_p > 0.0:
        f = dropout_factors(seed, dropout_p, B, H, Sq, k.shape[1], q.device,
                            head_offset, heads_total, q_row0)
        dp, pd = dp * f, p * f
    ds = p * (dp - _delta(o, do).view(B, H, Sq, 1)) * (1.0 / math.sqrt(D))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", pd, dof)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


class _View(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_int64),
                ("ss", ctypes.c_int64), ("sh", ctypes.c_int64)]


class _MaskView(ctypes.Structure):
    """`MaskView` of csrc/flash_attention.cu: the f32 mask's pointer and
    its batch, head, query and key strides in elements (0 broadcasts)."""
    _fields_ = [("p", ctypes.c_void_p)] + [
        (n, ctypes.c_int64) for n in ("sb", "sh", "sq", "sk")]


class _Args(ctypes.Structure):
    """`FlashArgs` of csrc/flash_attention.cu, field for field."""
    _fields_ = ([(n, ctypes.c_int64) for n in ("B", "H", "Sq", "Sk")]
                + [(n, _View) for n in ("q", "k", "v", "o", "dout", "dq",
                                        "dk", "dv")]
                + [("lse", ctypes.c_void_p), ("delta", ctypes.c_void_p),
                   ("scale", ctypes.c_float), ("causal", ctypes.c_int32),
                   ("has_mask", ctypes.c_int32),
                   ("has_dropout", ctypes.c_int32),
                   ("keep_threshold", ctypes.c_uint32),
                   ("drop_scale", ctypes.c_float),
                   ("seed", ctypes.c_uint64), ("mask", _MaskView),
                   ("o32", _View), ("heads_total", ctypes.c_int64),
                   ("head_offset", ctypes.c_int64),
                   ("q_row0", ctypes.c_int64)])


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


def _mask_view(mask, B, H, Sq, Sk, device):
    """The mask as the kernels read it: f32 on `device`, expanded (no copy)
    to [B, H, Sq, Sk], so a broadcast dim has stride 0. A bool mask becomes
    0 where True and -1e30 where False."""
    if mask.device != device:
        raise ValueError(f"mask must be on {device}; got {mask.device}")
    if mask.dim() > 4:
        raise ValueError(f"mask must have at most 4 dims; got "
                         f"{tuple(mask.shape)}")
    if mask.dtype == torch.bool:
        mask = torch.zeros(mask.shape, device=device).masked_fill_(
            ~mask, _NEG_INF)
    elif not mask.is_floating_point():
        raise ValueError(f"mask must be float or bool; got {mask.dtype}")
    try:
        return mask.to(torch.float32).expand(B, H, Sq, Sk)
    except RuntimeError:
        raise ValueError(f"mask of shape {tuple(mask.shape)} does not "
                         f"broadcast to [B, H, Sq, Sk] = "
                         f"{[B, H, Sq, Sk]}") from None


def _args(q, k, v, causal, mask=None, dropout_p=0.0, seed=None,
          head_offset=0, heads_total=None, q_row0=0, **views):
    B, Sq, H, D = q.shape
    total = H if heads_total is None else int(heads_total)
    if head_offset < 0 or head_offset + H > total:
        raise ValueError(f"heads [{head_offset}, {head_offset + H}) do not "
                         f"lie in the model's {total}")
    if q_row0 < 0 or q_row0 + Sq > 2 ** 32:
        raise ValueError(f"query rows [{q_row0}, {q_row0 + Sq}) do not lie "
                         "in the keep bits' 32-bit row coordinate")
    a = _Args(B=B, H=H, Sq=Sq, Sk=k.shape[1], q=_view(q), k=_view(k),
              v=_view(v), scale=1.0 / math.sqrt(D), causal=int(bool(causal)),
              heads_total=total, head_offset=int(head_offset),
              q_row0=int(q_row0))
    if mask is not None:
        a.has_mask = 1
        a.mask = _MaskView(mask.data_ptr(), *mask.stride())
    _check_dropout(dropout_p, seed)
    if dropout_p > 0.0:
        a.has_dropout = 1
        a.keep_threshold = philox.threshold(dropout_p)
        a.drop_scale = 1.0 / (1.0 - dropout_p)
        a.seed = int(seed)
    for name, t in views.items():
        if name in ("lse", "delta"):
            setattr(a, name, t.data_ptr())
        else:
            setattr(a, name, _view(t))
    return a


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _count(fn, mask, dropout_p):
    fn.launches += 1
    fn.mask_launches += mask is not None
    fn.dropout_launches += dropout_p > 0.0


def flash_attention_fwd(q, k, v, causal=False, mask=None, dropout_p=0.0,
                        seed=None, o32=None, head_offset=0, heads_total=None,
                        q_row0=0):
    """The forward kernel. q: [B, Sq, H, D], k and v: [B, Sk, H, D] on the
    card, float32 or bfloat16, D 64 or 128, unit stride on D; `mask`
    (float or bool, broadcastable to [B, H, Sq, Sk]) and dropout as in
    `attention_ref`. Returns (o [B, Sq, H, D] in q's dtype, lse [B*H, Sq]
    f32). With dropout, an `o32` [B, Sq, H, D] f32 tensor is also filled
    with O unrounded: the backward's delta = rowsum(dO * O) from it is
    exact, where a bf16 O is not (1/(1 - p) makes O unrepresentable where
    attention sits on one key). `head_offset` and `heads_total` number
    the heads for the keep bits (a tensor-parallel rank's share of the
    model's heads), `q_row0` their query rows (a sequence-parallel rank's
    offset in the whole sequence). Launches on the current stream without
    synchronising. Counts launches in ``flash_attention_fwd.launches``
    (and `.mask_launches`, `.dropout_launches`)."""
    B, Sq, Sk, H, D = _check_qkv(q, k, v)
    mv = None if mask is None else _mask_view(mask, B, H, Sq, Sk, q.device)
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, Sq), dtype=torch.float32, device=q.device)
    views = dict(o=o, lse=lse)
    if o32 is not None:
        if dropout_p == 0.0:
            raise ValueError("o32 is written by the dropout variant only")
        _check("o32", o32, q.shape, torch.float32, q.device)
        views["o32"] = o32
    a = _args(q, k, v, causal, mv, dropout_p, seed, head_offset,
              heads_total, q_row0, **views)
    with torch.cuda.device(q.device):
        err = _library().flash_attention_fwd_launch(
            _DTYPES[q.dtype], D, ctypes.byref(a),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(err, "flash_attention_fwd")
    _count(flash_attention_fwd, mask, dropout_p)
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.mask_launches = 0
flash_attention_fwd.dropout_launches = 0


def _launch_bwd(q, k, v, do, lse, delta, causal, which, mask=None,
                dropout_p=0.0, seed=None, head_offset=0, heads_total=None,
                q_row0=0, out=None):
    """Launch the dK/dV kernel (`which` 1), the dQ kernel (2) or both (3);
    returns (dq, dk, dv), None for what was not computed. `out`: the (dk,
    dv) views the dK/dV kernel writes (None: new contiguous tensors).
    Counts nothing: `flash_attention_bwd` is the counted entry."""
    B, Sq, Sk, H, D = _check_qkv(q, k, v)
    _check("do", do, q.shape, q.dtype, q.device)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (B * H, Sq) or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[{B * H}, {Sq}] on {q.device}")
    mv = None if mask is None else _mask_view(mask, B, H, Sq, Sk, q.device)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) \
        if which & 2 else None
    dk = dv = None
    if which & 1 and out is not None:
        dk, dv = out
        for name, t in (("dk", dk), ("dv", dv)):
            _check(name, t, (B, Sk, H, D), q.dtype, q.device)
    elif which & 1:
        dk = torch.empty((B, Sk, H, D), dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
    views = {n: t for n, t in (("dq", dq), ("dk", dk), ("dv", dv))
             if t is not None}
    a = _args(q, k, v, causal, mv, dropout_p, seed, head_offset, heads_total,
              q_row0, dout=do, lse=lse, delta=delta, **views)
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


def flash_attention_bwd(q, k, v, o, do, lse, causal=False, mask=None,
                        dropout_p=0.0, seed=None, head_offset=0,
                        heads_total=None, q_row0=0, out=None):
    """The backward: delta = rowsum(dO * O) in f32 (plain torch), then the
    dK/dV kernel and the dQ kernel. q, k, v, o, lse, the mask and the
    dropout arguments as the forward took and gave them (o may be the
    forward's `o32`); do is dL/dO [B, Sq, H, D]. `out`: optional (dk, dv)
    [B, Sk, H, D] views in q's dtype (unit stride on D, 16-byte aligned
    rows) the dK/dV kernel writes in place. Returns (dq, dk, dv) in q's
    dtype. One counted launch (``flash_attention_bwd.launches``, and
    `.mask_launches`, `.dropout_launches`) is the pair of CUDA kernels,
    dK/dV then dQ."""
    out = _launch_bwd(q, k, v, do, lse, _delta(o, do), causal, 3, mask,
                      dropout_p, seed, head_offset, heads_total, q_row0, out)
    _count(flash_attention_bwd, mask, dropout_p)
    return out


flash_attention_bwd.launches = 0
flash_attention_bwd.mask_launches = 0
flash_attention_bwd.dropout_launches = 0


def _sum_to(g, shape):
    """Sum `g` [B, H, Sq, Sk] over the dims a tensor of `shape` was
    broadcast along, back to `shape`."""
    lead = g.dim() - len(shape)
    g = g.sum(dim=tuple(range(lead))) if lead else g
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


def mask_grad(q, k, v, o, do, lse, mask, causal=False, dropout_p=0.0,
              seed=None, head_offset=0, heads_total=None):
    """dL/dmask = P * (dP D - delta), in plain torch from the saved LSE
    (`_flash_custom`'s recompute, plus the dropout factors D), summed over
    the mask's broadcast dims; in the mask's dtype and shape."""
    B, Sq, H, _ = q.shape
    p = torch.exp(_scores(q, k, causal, mask) - lse.view(B, H, Sq, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    if dropout_p > 0.0:
        dp = dp * dropout_factors(seed, dropout_p, B, H, Sq, k.shape[1],
                                  q.device, head_offset, heads_total)
    ds = p * (dp - _delta(o, do).view(B, H, Sq, 1))
    return _sum_to(ds, mask.shape).to(mask.dtype)


class FlashAttention(torch.autograd.Function):
    """Flash attention on CUDA tensors: the forward kernel saves q, k, v,
    o (in f32 with dropout), the LSE and the mask; the backward runs the
    two backward kernels, and `mask_grad` when the mask needs a
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, dropout_p, seed, head_offset=0,
                heads_total=None):
        # with dropout in bf16, the backward's delta takes the f32 O
        o32 = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
               if dropout_p > 0.0 and q.dtype != torch.float32 else None)
        o, lse = flash_attention_fwd(q, k, v, causal, mask, dropout_p, seed,
                                     o32, head_offset, heads_total)
        ctx.save_for_backward(q, k, v, o if o32 is None else o32, lse, mask)
        ctx.causal, ctx.dropout_p, ctx.seed = causal, dropout_p, seed
        ctx.heads = (head_offset, heads_total)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mask = ctx.saved_tensors
        do = do.contiguous()
        drop = dict(dropout_p=ctx.dropout_p, seed=ctx.seed,
                    head_offset=ctx.heads[0], heads_total=ctx.heads[1])
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, ctx.causal,
                                         mask, **drop)
        dmask = None
        if ctx.needs_input_grad[3]:
            dmask = mask_grad(q, k, v, o, do, lse, mask, ctx.causal, **drop)
        return dq, dk, dv, dmask, None, None, None, None, None


def flash_attention(q, k, v, causal=False, mask=None, dropout_p=0.0,
                    seed=None, head_offset=0, heads_total=None):
    """Attention on [B, S, H, D], differentiable (in q, k, v and a float
    mask), chosen by q's device: a CPU tensor takes autograd through
    `attention_ref`, a CUDA tensor the kernels. Dropout (`dropout_p` > 0)
    needs `seed`, a uint64; its keep bits number the heads from
    `head_offset` of `heads_total` (a tensor-parallel rank's share)."""
    _check_dropout(dropout_p, seed)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal, mask, dropout_p, seed,
                             head_offset, heads_total)
    if q.device.type == "cuda":
        return FlashAttention.apply(q, k, v, mask, bool(causal),
                                    float(dropout_p), seed, int(head_offset),
                                    heads_total)
    raise ValueError(f"no flash attention for device {q.device}")
