"""Many-adapter LoRA serving over one shared base GPT (the JAX package's
`models/lora.py`, in PyTorch).

One base model, N per-request low-rank adapters, one step program per
ragged width bucket:

- **Adapter weights are an extra ``[num_slots, ...]`` table next to the
  base parameters.** Each column-parallel target op (the fused QKV and the
  FFN up-projection) gets a pair of stacked float32 tables on the engine's
  device: ``A [S, L, in, r]`` and ``B [S, L, r, out]``. On a
  tensor-parallel rank (the ``smesh`` argument, serving/sharded.py) A is
  replicated and B holds the rank's columns of the out axis, the base
  column weight's layout (`table_shardings`), so the delta lands in the
  rank's own output columns with no collective.
- **Slot 0 is the base model.** Both tables are all zeros there, so a lane
  whose request carries no adapter adds an exact zero: the engine with
  adapters enabled serves plain requests bit for bit as the base engine.
  Idle and padded lanes also read slot 0.
- **The per-row gather runs inside the step program.** The engine packs
  one ``adapter_slots [B] int32`` field per step beside ``q_start`` and
  friends, and the step body gathers each lane's rows from the tables
  (`gather_adapter_rows`). Shapes depend only on ``(max_batch, width)``:
  which adapters a step mixes never keys a program.
- **The tables are written in place.** A captured CUDA graph reads them by
  address, so `write_slot` and `zero_slot` copy into the existing tensors
  (on the engine's stream, from the engine's thread); rebinding them would
  leave the graphs serving the old adapters.
- **KV is adapter-dependent.** The same prompt under different adapters
  never shares prefix-cache blocks: the engine salts `chain_block_hashes`
  with the request's adapter name (serving/block_pool.py).

The engine's registry (`LLMEngine.load_adapter` / `unload_adapter`,
bounded ``lora_slots``, LRU eviction of idle adapters) owns slot
assignment; this module owns the math and the table layout. Token identity
is tested against `merge_adapter_into`: folding ``W + A @ B`` into a
dedicated engine's base weights reproduces the multi-adapter engine's
greedy tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

# column-parallel serving ops that accept adapters, by the op names
# models/gpt.py passes to `_serving_column_parallel`
LORA_TARGETS = ("attn_qkv", "ffn_fc1")


def target_dims(cfg, target):
    """(d_in, d_out) of a target op's base weight, in the JAX package's
    ``[in, out]`` orientation (`nn.Linear` stores the transpose)."""
    if target == "attn_qkv":
        return cfg.hidden_size, 3 * cfg.hidden_size
    if target == "ffn_fc1":
        return cfg.hidden_size, cfg.intermediate_size
    raise ValueError(f"unknown LoRA target {target!r} "
                     f"(supported: {LORA_TARGETS})")


def init_adapter_tables(cfg, num_slots, rank, targets=LORA_TARGETS,
                        smesh=None, device=None):
    """Zeroed stacked adapter tables for an engine with ``num_slots`` slots
    (slot 0 = the all-zeros base): {target: (A [S, L, in, r], B [S, L, r,
    out])}, float32 on `device` (None = CUDA, which must exist). On a
    serving mesh `smesh`, B holds this rank's ``out / tp`` columns."""
    device = resolve_device(device)
    tables = {}
    for t in targets:
        d_in, d_out = target_dims(cfg, t)
        if smesh is not None:
            if d_out % smesh.tp_degree:
                raise ValueError(
                    f"LoRA target {t!r}: out dim {d_out} not divisible by "
                    f"tp degree {smesh.tp_degree}")
            d_out //= smesh.tp_degree
        tables[t] = (
            torch.zeros((num_slots, cfg.num_layers, d_in, rank),
                        dtype=torch.float32, device=device),
            torch.zeros((num_slots, cfg.num_layers, rank, d_out),
                        dtype=torch.float32, device=device))
    return tables


def table_shardings(targets, smesh):
    """The tables' layout on a serving mesh, as sharded dimensions
    ({target: (A's, B's)}, None = replicated): A replicated, B sharded on
    its out axis (dim 3 of ``[S, L, r, out]``), as in the JAX function.
    `smesh` is accepted for its signature (every degree shares the
    layout)."""
    del smesh
    return {t: (None, 3) for t in targets}


def shard_adapter(packed, smesh):
    """`pack_adapter`'s output as a rank of `smesh` stores it: each B cut
    to the rank's out columns (None: one card, unchanged)."""
    if smesh is None:
        return packed
    tp, r = smesh.tp_degree, smesh.rank
    out = {}
    for t, (a, b) in packed.items():
        n = b.shape[-1] // tp
        out[t] = (a, b[..., r * n:(r + 1) * n])
    return out


def pack_adapter(cfg, weights, rank, targets, alpha=None):
    """Validate and normalize one adapter's host weights for a table slot.

    `weights` maps each target (a subset of `targets` is fine: missing
    targets stay zero) to ``(A [L, in, r'], B [L, r', out])`` with ``r' <=
    rank``; narrower adapters are zero-padded up to the table rank. The
    conventional ``alpha / r'`` LoRA scale is folded into B here, so the
    serving path never multiplies by a per-request scalar. Returns
    {target: (A, B)} float32 numpy arrays at the table rank."""
    packed = {}
    for t, (a, b) in weights.items():
        if t not in targets:
            raise ValueError(
                f"adapter target {t!r} not enabled on this engine "
                f"(lora_targets={tuple(targets)})")
        d_in, d_out = target_dims(cfg, t)
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        r = a.shape[-1]
        if a.shape != (cfg.num_layers, d_in, r):
            raise ValueError(
                f"adapter {t!r} A shape {a.shape} != "
                f"({cfg.num_layers}, {d_in}, r)")
        if b.shape != (cfg.num_layers, r, d_out):
            raise ValueError(
                f"adapter {t!r} B shape {b.shape} != "
                f"({cfg.num_layers}, r, {d_out})")
        if r > rank:
            raise ValueError(
                f"adapter {t!r} rank {r} exceeds the engine's table "
                f"rank {rank}")
        if alpha is not None:
            b = b * (float(alpha) / r)
        if r < rank:
            a = np.concatenate(
                [a, np.zeros((cfg.num_layers, d_in, rank - r), np.float32)],
                axis=-1)
            b = np.concatenate(
                [b, np.zeros((cfg.num_layers, rank - r, d_out), np.float32)],
                axis=1)
        packed[t] = (a, b)
    if not packed:
        raise ValueError("adapter has no target weights")
    return packed


@torch.no_grad()
def write_slot(tables, slot, packed, zero_missing=True):
    """Write `packed` into `slot` of `tables` IN PLACE (targets absent from
    `packed` are zeroed when `zero_missing`) and return `tables`. The copy
    is enqueued on the current stream, so the caller runs it on the stream
    its step programs replay on; the tensors keep their addresses, which a
    captured graph has baked in."""
    for t, (a, b) in tables.items():
        if t in packed:
            pa, pb = packed[t]
            a[slot].copy_(torch.as_tensor(pa))
            b[slot].copy_(torch.as_tensor(pb))
        elif zero_missing:
            a[slot].zero_()
            b[slot].zero_()
    return tables


def zero_slot(tables, slot):
    """Zero `slot` in place (unload hygiene: a freed slot holds no stale
    weights even though no live request can index it)."""
    return write_slot(tables, slot, {}, zero_missing=True)


def gather_adapter_rows(tables, slots):
    """Per-lane adapter rows, gathered inside the step body: {target:
    (a_rows [B, L, in, r], b_rows [B, L, r, out])}. ``slots`` is the
    step's ``adapter_slots [B] int32`` (0 = base = zeros). Returns None for
    empty tables, so a lora-off engine runs the step body it always has."""
    if not tables:
        return None
    return {t: (a.index_select(0, slots), b.index_select(0, slots))
            for t, (a, b) in tables.items()}


def apply_adapter_rows(x, a_rows, b_rows, layer):
    """One layer's per-lane LoRA delta for a column-parallel op, float32:
    ``delta[i] = x[i] @ A[slot_i, layer] @ B[slot_i, layer]``, batched over
    lanes. As in the JAX function, ``h = x @ A`` is computed in float32
    and rounded to x's dtype before the product with the float32 B; the
    delta stays float32 (JAX's promotion), and the caller decides the sum's
    dtype."""
    a = a_rows[:, layer]     # [B, in, r]
    b = b_rows[:, layer]     # [B, r, out]
    h = torch.bmm(x.float(), a).to(x.dtype)
    return torch.bmm(h.float(), b)


def random_adapter(cfg, rank, targets=LORA_TARGETS, seed=0, scale=0.05):
    """A reproducible nonzero test adapter (both factors random, so the
    delta moves logits): {target: (A [L, in, r], B [L, r, out])} float32
    host arrays, the JAX function's draws from the same seed."""
    rs = np.random.RandomState(seed)
    out = {}
    for t in targets:
        d_in, d_out = target_dims(cfg, t)
        out[t] = (
            rs.normal(0.0, scale, (cfg.num_layers, d_in, rank))
            .astype(np.float32),
            rs.normal(0.0, scale, (cfg.num_layers, rank, d_out))
            .astype(np.float32),
        )
    return out


def _target_layer(model, target, layer):
    blk = model.blocks[layer]
    if target == "attn_qkv":
        return blk.attn.qkv
    if target == "ffn_fc1":
        return blk.fc1
    raise ValueError(f"unknown LoRA target {target!r}")


@torch.no_grad()
def merge_adapter_into(model, weights, alpha=None):
    """Fold an adapter into a model's base weights IN PLACE: ``W_l += A_l @
    B_l`` per target per layer (alpha folded as in `pack_adapter`). The
    product is taken in float32 numpy and rounded to the weight's dtype
    before the add, as in the JAX function. This is the token-identity
    reference: an engine over the merged model emits what the
    multi-adapter engine emits for requests on this adapter. Merge before
    building an engine (its step programs bake in parameter addresses and
    values). Returns `model`."""
    for t, (a, b) in weights.items():
        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        if alpha is not None:
            b = b * (float(alpha) / a.shape[-1])
        for layer in range(model.cfg.num_layers):
            w = _target_layer(model, t, layer).weight     # [out, in]
            delta = torch.from_numpy(np.ascontiguousarray(
                (a[layer] @ b[layer]).T)).to(w.device, w.dtype)
            w.add_(delta)
    return model
