"""Ragged paged attention: the hand-written CUDA kernel and its plain version.

K/V live in a head-major block arena ``[layers, heads, num_blocks,
block_size, head_dim]`` and every batch row attends through its own block
table. One launch serves a mixed batch: decode rows (one live query token)
beside prefill-chunk and speculative-verify rows.

- `paged_attention_ref` is the plain PyTorch version: it gathers the full
  padded block table into the ``[B, L, H, D]`` layout and einsum order of
  `models/gpt.py`'s contiguous-cache decode, so greedy serving on the CPU is
  token-identical to `GPT.generate`.
- `ragged_paged_attention` launches ``csrc/ragged_paged_attention.cu``, which
  walks only each row's live KV blocks and live query tiles (the port of the
  TPU kernel `_ragged_kernel`, float and int8 arena variants), in the design
  `kernel_design` picks by shape: the sm_90a one (TMA, mma.sync split rows,
  wgmma wide rows) at the serving shape, the SIMT one elsewhere.
- An int8 arena comes with float32 scale sidecars ``[layers, heads,
  num_blocks]`` (`k_scale`, `v_scale`): one scale per (layer, head, block)
  dequantizes that block's tile before any product, in both versions.
- `paged_attention_arrays` chooses by the tensor's device alone: a CPU tensor
  takes the plain version, a CUDA tensor the kernel. There is no switch and
  no fallback: a CUDA call the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_NEG_INF = -1e30
_SOURCE = "ragged_paged_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT8 = 2  # the kernel's code for an int8 arena
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_BLOCK_SIZE = 128
_DESIGNS = {"simt": 0, "sm90": 1}
_SM90_BLOCK_SIZES = (16, 32, 64, 128)


def kernel_design(dtype, head_dim, block_size):
    """Which design of the CUDA kernel a call runs, by shape alone:
    ``"sm90"`` (TMA, mma.sync split rows, wgmma wide rows) for bfloat16 q
    at head_dim 128 with a block size of 16, 32, 64 or 128, over either
    arena; ``"simt"`` (the f32 shared-tile design) for everything else,
    float32 included. Inside one sm90 launch a row with at most 8 live
    queries (decode, verify) is a split row, a longer one (a prefill chunk)
    a wide row."""
    if (dtype == torch.bfloat16 and head_dim == 128
            and block_size in _SM90_BLOCK_SIZES):
        return "sm90"
    return "simt"


def paged_attention_ref(q, k_arena, v_arena, layer, block_tables, qpos,
                        scale=None, k_scale=None, v_scale=None):
    """Plain paged attention over the full padded block table.

    q: [B, S, H, D]; arenas: [layers, H, num_blocks, block_size, D];
    block_tables: [B, max_blocks] int (0 = null block); qpos: [B, S]
    absolute query positions (padding carries 0 and is discarded by the
    caller). `k_scale`/`v_scale` [layers, H, num_blocks] float32 dequantize
    an int8 arena to float32 before the products. Scores and softmax in
    fp32; P is cast to V's dtype before the PV product (float32 after a
    dequant). Returns [B, S, H, D] in q's dtype.
    """
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    bt = block_tables.long()
    k_seq = k_arena[layer][:, bt]  # [H, B, nb, bs, D]
    v_seq = v_arena[layer][:, bt]
    if k_scale is not None:
        k_seq = k_seq.float() * k_scale[layer][:, bt][..., None, None]
        v_seq = v_seq.float() * v_scale[layer][:, bt][..., None, None]
    nb, bs = k_seq.shape[2], k_seq.shape[3]
    L = nb * bs
    k_seq = k_seq.permute(1, 2, 3, 0, 4).reshape(B, L, H, D)
    v_seq = v_seq.permute(1, 2, 3, 0, 4).reshape(B, L, H, D)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_seq.float()) * scale
    kpos = torch.arange(L, device=q.device)[None, None, None, :]
    qp = qpos.to(kpos.dtype)[:, None, :, None]
    s = torch.where(kpos <= qp, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v_seq.dtype), v_seq)
    return o.to(q.dtype)


def _library():
    lib = _build.load_library(_SOURCE)
    if lib.ragged_paged_attention_launch.argtypes is None:
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn = lib.ragged_paged_attention_launch
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # design dtype arena
            i64,                                   # layers of the arena
            i64, i64, i64, i64, i64, i64, i64,     # B S H D bs nb num_blocks
            ptr, i64, i64, i64,                    # q + strides
            ptr, ptr, i64, i64, i64,               # k v layer_off a_sh a_sn
            ptr, ptr, i64, i64,                    # k_scale v_scale + strides
            ptr, ptr, ptr, ptr,                    # tables q_start kv_live q_lens
            ptr, i64, i64, i64,                    # out + strides
            ptr, ctypes.c_float, ptr,              # workspace scale stream
        ]
        fn.restype = ctypes.c_int
        ws = lib.ragged_paged_attention_workspace
        ws.argtypes = [i64] * 5
        ws.restype = i64
    return lib


def _check_meta(name, t, shape, device):
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor on "
                         f"{device}; got {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")


def ragged_paged_attention(q, k_arena, v_arena, layer, block_tables,
                           q_start, kv_live, q_lens=None, scale=None,
                           k_scale=None, v_scale=None):
    """The CUDA ragged paged-attention kernel over live KV blocks and live
    query tiles only.

    q: [B, S, H, D] (unit stride on D), float32 or bfloat16; arenas:
    [layers, H, num_blocks, bs, D] contiguous and 16-byte aligned, either
    of q's dtype or int8 with `k_scale`/`v_scale` (float32 [layers, H,
    num_blocks], contiguous); block_tables: [B, max_blocks]; q_start: [B]
    first query position per row; kv_live: [B] live KV blocks per row
    (clamped to >= 1); q_lens: [B] live query tokens per row (None = every
    row full width). Metadata is int32 on q's device. Returns [B, S, H, D]
    in q's dtype; rows past each row's live tokens hold garbage. Launches
    on the current stream without synchronising; the workspace for split
    rows' partials comes from `torch.empty`. The count of launches is
    ``ragged_paged_attention.launches`` (of them, those over an int8 arena
    also count in ``ragged_paged_attention.int8_launches``, and
    ``ragged_paged_attention.width_launches`` counts them by step width S);
    one launch is the CUDA kernels a call runs: in the SIMT design the
    attend pass (`rpa_attend`) and the merge of split rows' partials
    (`rpa_combine`); in the sm_90a design the wide rows' pass
    (`rpa_wide_sm90`, when S > 8), the split rows' (`rpa_split_sm90`) and
    their merge (`rpa_combine`, launched as a programmatic dependent).
    """
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on CUDA tensors; q is "
                         f"on {q.device} (paged_attention_ref is the plain "
                         "version)")
    dev = q.device
    B, S, H, D = q.shape
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernel takes "
                         "float32 and bfloat16")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    if q.stride(-1) != 1:
        raise ValueError("q needs unit stride on head_dim")
    quant = k_scale is not None or v_scale is not None
    arena_dtype = torch.int8 if quant else q.dtype
    for name, a in (("k_arena", k_arena), ("v_arena", v_arena)):
        if a.device != dev or a.dtype != arena_dtype or not a.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous {arena_dtype} on {dev}"
                + (" (an int8 arena needs k_scale and v_scale)"
                   if a.dtype == torch.int8 and not quant else ""))
        if a.dim() != 5 or a.shape[1] != H or a.shape[4] != D:
            raise ValueError(f"{name} shape {tuple(a.shape)} does not match "
                             f"[layers, {H}, blocks, block_size, {D}]")
    if k_arena.shape != v_arena.shape:
        raise ValueError("k_arena and v_arena shapes differ")
    if k_arena.data_ptr() % 16 or v_arena.data_ptr() % 16:
        raise ValueError("the arenas must be 16-byte aligned")
    n_layers, _, num_blocks, bs, _ = k_arena.shape
    sc_st = (0, 0)
    if quant:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (sc is None or sc.device != dev or sc.dtype != torch.float32
                    or not sc.is_contiguous()
                    or sc.shape != k_arena.shape[:3]):
                raise ValueError(
                    f"{name} must be a contiguous float32 tensor of shape "
                    f"{tuple(k_arena.shape[:3])} on {dev}")
        sc_st = k_scale.stride()
    layer = int(layer)
    if not 0 <= layer < n_layers:
        raise ValueError(f"layer {layer} out of range [0, {n_layers})")
    if not 1 <= bs <= _MAX_BLOCK_SIZE:
        raise ValueError(f"block_size {bs} not in [1, {_MAX_BLOCK_SIZE}]")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables shape {tuple(block_tables.shape)} "
                         f"is not [{B}, max_blocks]")
    nb = block_tables.shape[1]
    _check_meta("block_tables", block_tables, (B, nb), dev)
    _check_meta("q_start", q_start, (B,), dev)
    _check_meta("kv_live", kv_live, (B,), dev)
    if q_lens is None:
        q_lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    _check_meta("q_lens", q_lens, (B,), dev)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    lib = _library()
    ws = torch.empty(lib.ragged_paged_attention_workspace(B, H, D, bs, nb),
                     dtype=torch.float32, device=dev)
    a_st = k_arena.stride()
    with torch.cuda.device(dev):
        err = lib.ragged_paged_attention_launch(
            _DESIGNS[kernel_design(q.dtype, D, bs)],
            _DTYPES[q.dtype], _INT8 if quant else _DTYPES[q.dtype],
            n_layers, B, S, H, D, bs, nb, num_blocks,
            q.data_ptr(), q.stride(0), q.stride(1), q.stride(2),
            k_arena.data_ptr(), v_arena.data_ptr(), layer * a_st[0],
            a_st[1], a_st[2],
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            layer * sc_st[0], sc_st[1],
            block_tables.data_ptr(), q_start.data_ptr(),
            kv_live.data_ptr(), q_lens.data_ptr(),
            out.data_ptr(), out.stride(0), out.stride(1), out.stride(2),
            ws.data_ptr(), float(scale),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention launch failed: CUDA "
                           f"error {err}")
    ragged_paged_attention.launches += 1
    widths = ragged_paged_attention.width_launches
    widths[S] = widths.get(S, 0) + 1
    if quant:
        ragged_paged_attention.int8_launches += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.int8_launches = 0
ragged_paged_attention.width_launches = {}


def paged_attention_arrays(q, k_arena, v_arena, layer, block_tables, qpos,
                           q_start=None, kv_live=None, q_lens=None,
                           scale=None, k_scale=None, v_scale=None):
    """Attend q through the block table, chosen by q's device: the plain
    version for a CPU tensor, the CUDA kernel for a CUDA tensor (which
    needs the ragged metadata `q_start`/`kv_live`, and raises without it).
    `scale` defaults to 1/sqrt(head_dim) on both; `k_scale`/`v_scale` are
    an int8 arena's scale sidecars."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_arena, v_arena, layer, block_tables,
                                   qpos, scale, k_scale=k_scale,
                                   v_scale=v_scale)
    if q.device.type == "cuda":
        if q_start is None or kv_live is None:
            raise ValueError("the CUDA path needs q_start and kv_live")
        return ragged_paged_attention(q, k_arena, v_arena, layer,
                                      block_tables, q_start, kv_live,
                                      q_lens=q_lens, scale=scale,
                                      k_scale=k_scale, v_scale=v_scale)
    raise ValueError(f"no paged attention for device {q.device}")
