"""Paged KV cache: a global block arena plus per-sequence block tables.

K/V live in ONE head-major arena ``[layers, heads, num_blocks, block_size,
head_dim]`` on the engine's device, and every sequence owns a list of block
ids. Each (layer, head, block) slice is a contiguous ``[block_size,
head_dim]`` tile, which the CUDA kernel reads straight from device memory
(ops/paged_attention.py). Appending tokens is an in-place scatter.

Block 0 is the NULL block: the allocator never hands it out, and every
padded or inactive scatter is routed there, so out-of-range writes can
never corrupt a live sequence. Reads through padding see garbage from block
0, which the causal ``kpos <= qpos`` mask discards.

**Int8 arena** (``kv_dtype="int8"``): the payload is int8 and every
(layer, head, block) carries one float32 dequant scale in the sidecars
``k_scale``/``v_scale`` ``[layers, heads, num_blocks]``. The append
(`_quantize_scatter`) grows a block's scale to fit its new tokens and
requantizes the block's existing payload to the grown scale; attention
dequantizes each tile with its scale before any product.

Host-side bookkeeping is plain Python. **Automatic prefix caching**: every
block carries a refcount, and FULL blocks can be published under a chained
content hash into a hash->block index. A published block whose refcount
drops to zero moves to a **cached-free LRU tier** instead of the truly-free
list: its KV stays valid and `match_prefix` can hand it to a later request
with the same token prefix. ``num_free`` counts both tiers; `allocate`
pops truly-free blocks first and evicts cached blocks oldest-first only
when the free list runs dry. Writes into a block shared by several
sequences go through copy-on-write (`copy_blocks` + the scheduler's
`_ensure_writable`).

**Host tier** (serving/kv_tier.py, `attach_tier`): an evicted cached-free
block is handed to the tier, which copies its bytes to host memory before
the next arena write, and a later prompt that walks past the device index
into host-resident hashes gets them back through `adopt`.

With a lifecycle tracer (serving/trace.py) the pool marks evictions and
injected ``alloc_fail`` faults (serving/faults.py) as instants on its
``block-pool`` track; without one each hook is one pointer test.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch

from .._device import resolve_device
from . import faults


def blocks_for(num_tokens, block_size):
    """KV blocks `num_tokens` tokens occupy (>= 1)."""
    return max(1, -(-int(num_tokens) // int(block_size)))


def kv_capacity_blocks(kv_bytes, num_layers, num_heads, block_size,
                       head_dim, dtype_itemsize, scale_itemsize=0):
    """KV blocks a byte budget buys on one card: K + V payloads of
    `dtype_itemsize` bytes a value, plus, for an int8 arena, the two
    per-(layer, head) scale entries of `scale_itemsize` (4, float32) each
    block carries. The JAX package's single-chip formula
    (serving/sharded.py `kv_capacity_blocks` at tp_degree 1). Returns the
    raw count (possibly 0 or 1); the engine rejects a budget too small to
    serve."""
    per_block = (2 * int(num_layers) * int(num_heads) * int(block_size)
                 * int(head_dim) * int(dtype_itemsize)
                 + 2 * int(num_layers) * int(num_heads) * int(scale_itemsize))
    return int(kv_bytes) // per_block


def chain_block_hashes(token_ids, block_size, salt=None):
    """Chained sha256 digests of each FULL block of `token_ids`:
    ``h_i = sha256(h_{i-1} || tokens[i*bs:(i+1)*bs] as int64)`` from an
    empty seed (or `salt`). Two sequences share digest i iff their first
    ``(i+1)*block_size`` tokens are identical; the trailing partial block
    gets no digest. A cryptographic digest, not Python's ``hash``: the index
    serves KV across requests, so an engineered collision would hand one
    prompt another prompt's KV. Byte-identical to the JAX package's."""
    bs = int(block_size)
    hashes = []
    h = b"" if salt is None else str(salt).encode("utf-8")
    for i in range(len(token_ids) // bs):
        m = hashlib.sha256(h)
        m.update(np.asarray(token_ids[i * bs:(i + 1) * bs],
                            np.int64).tobytes())
        h = m.digest()
        hashes.append(h)
    return hashes


class PagedLayerView:
    """One layer's window onto a paged forward: `CausalSelfAttention`
    receives it as its `cache` and calls `paged_attention`."""

    is_paged = True

    def __init__(self, state, layer):
        self.state = state
        self.layer = layer


class PagedState:
    """Arena and step metadata threaded through `GPT.hidden`.

    Tensors, all on the engine's device:
      k, v          [layers, heads, num_blocks, block_size, head_dim]
      block_tables  [B, max_blocks] int32 (padded with 0 = null block)
      slots         [B, S] int32 — destination block of each new token
      offs          [B, S] int32 — destination offset inside that block
      qpos          [B, S] int32 — absolute position of each query token
                    (also the model's position-embedding indices)
      q_start       [B] int32 — first query position per row
      kv_live       [B] int32 — live KV blocks per row (>= 1)
      q_lens        [B] int32 — live query tokens per row (None = full)

    An int8 arena adds four more (None on a float arena):
      k_scale, v_scale  [layers, heads, num_blocks] float32 — per-block
                    per-head dequant scales
      touched       [B, T] int32 — the blocks this step's scatter can write
                    per row, slot 0 reserved for the null block (padded
                    tokens route their scale updates there)
      touch_idx     [B, S] int32 — each fed token's index into its row's
                    `touched` list (0 = the null slot)

    A LoRA engine adds ``lora``: {target op -> (a_rows [B, L, in, r],
    b_rows [B, L, r, out])}, the step's lanes' adapter rows
    (models/lora.py `gather_adapter_rows`), or None; models/gpt.py's
    column-parallel hook reads it per op.
    """

    is_paged = True

    def __init__(self, k, v, block_tables, slots, offs, qpos, q_start=None,
                 kv_live=None, q_lens=None, k_scale=None, v_scale=None,
                 touched=None, touch_idx=None, lora=None):
        self.k = k
        self.v = v
        self.block_tables = block_tables
        self.slots = slots
        self.offs = offs
        self.qpos = qpos
        self.q_start = q_start
        self.kv_live = kv_live
        self.q_lens = q_lens
        self.k_scale = k_scale
        self.v_scale = v_scale
        self.touched = touched
        self.touch_idx = touch_idx
        self.lora = lora

    def layer(self, i):
        return PagedLayerView(self, i)


def scatter_kv(arena, layer, slots, offs, new):
    """Write `new` [B, S, H, D] into ``arena[layer]`` at (slots, offs), in
    place. ``arena[layer]`` is a view [H, N, bs, D]; the two adjacent index
    tensors make the indexed result [H, B, S, D] (torch applies the integer
    `layer` first, unlike numpy, whose broadcast dims would land in front),
    hence the permute of `new`."""
    arena[layer][:, slots, offs] = new.permute(2, 0, 1, 3).to(arena.dtype)


def _quantize_scatter(arena, scales, layer, new, slots, offs, touched,
                      touch_idx):
    """Int8 arena append with per-(layer, head, block) scale growth, in
    place on `arena` and `scales` (the JAX package's functional
    `_quantize_scatter`, same arithmetic).

    `new` [B, S, H, D] tokens land in blocks `slots`/`offs`; every block
    the step can write is listed in `touched` [B, T] (slot 0 = the null
    block) and `touch_idx` [B, S] maps each token to its row's touched
    slot. Scales only grow while a block is owned: when a new token's
    per-head absmax exceeds the block's stored scale, the block's existing
    payload is requantized to the grown scale before the new tokens
    scatter, so earlier tokens keep dequantizing correctly. A block's first
    write under its current owner always carries offset 0, so ``offs ==
    0`` marks the block fresh and its stale scale from a prior occupant is
    ignored (its stale bytes requantize to zero). Duplicate `touched`
    entries only ever name the null block, whose payload and scale are
    scratch. Rounding is half to even and clipped to [-127, 127]."""
    B, S, H, _ = new.shape
    T = touched.shape[1]
    dev = new.device
    flat_t = touched.reshape(-1).long()                        # [B*T]
    gidx = (touch_idx.long()
            + torch.arange(B, device=dev)[:, None] * T).reshape(-1)
    am = new.float().abs().amax(dim=3).reshape(B * S, H)       # [B*S, H]
    blk_am = torch.zeros((B * T, H), dtype=torch.float32, device=dev)
    blk_am.scatter_reduce_(0, gidx[:, None].expand(-1, H), am, "amax")
    fresh = torch.zeros(B * T, dtype=torch.float32, device=dev)
    fresh.scatter_reduce_(0, gidx, (offs.reshape(-1) == 0).float(), "amax")
    old_sc = scales[layer][:, flat_t]                          # [H, B*T]
    old_eff = torch.where(fresh[None, :] > 0, torch.zeros_like(old_sc),
                          old_sc)
    new_sc = torch.maximum(old_eff, blk_am.T / 127.0).clamp_min(1e-8)
    # requantize the touched blocks' existing payload to the grown scale;
    # torch applies the integer `layer` first, so the indexed view is
    # [H, B*T, bs, D], the gathered payload's own layout
    ratio = old_eff / new_sc
    old_q = arena[layer][:, flat_t]                            # [H, B*T, bs, D]
    req = torch.round(old_q.float() * ratio[..., None, None]).clamp(-127, 127)
    arena[layer][:, flat_t] = req.to(arena.dtype)
    scales[layer][:, flat_t] = new_sc
    # quantize the new tokens at their block's (grown) scale and scatter
    tok_sc = new_sc.T[gidx].reshape(B, S, H)
    qn = torch.round(new.float() / tok_sc[..., None]).clamp(-127, 127)
    scatter_kv(arena, layer, slots, offs, qn)


def paged_attention(q, k_new, v_new, view, scale=None):
    """Append `k_new`/`v_new` [B, S, heads, head_dim] into the arena and
    attend `q` through the block table (ops/paged_attention.py's dispatch).
    An int8 arena appends by the arena's device: a CPU arena through the
    plain `_quantize_scatter`, any other through the CUDA kernel
    (ops/kv_quantize_scatter.py), which raises off CUDA. Returns [B, S,
    heads, head_dim]."""
    from ..ops.kv_quantize_scatter import kv_quantize_scatter
    from ..ops.paged_attention import paged_attention_arrays

    st, layer = view.state, view.layer
    if st.k_scale is not None:
        for arena, scales, new in ((st.k, st.k_scale, k_new),
                                   (st.v, st.v_scale, v_new)):
            if arena.device.type == "cpu":
                _quantize_scatter(arena, scales, layer, new, st.slots,
                                  st.offs, st.touched, st.touch_idx)
            else:
                kv_quantize_scatter(arena, scales, layer, new, st.offs,
                                    st.touched, st.touch_idx)
    else:
        scatter_kv(st.k, layer, st.slots, st.offs, k_new)
        scatter_kv(st.v, layer, st.slots, st.offs, v_new)
    return paged_attention_arrays(
        q, st.k, st.v, layer, st.block_tables, st.qpos,
        q_start=st.q_start, kv_live=st.kv_live, q_lens=st.q_lens,
        scale=scale, k_scale=st.k_scale, v_scale=st.v_scale)


class BlockPool:
    """Host-side allocator over the device arena.

    Owns the K/V arena tensors plus the two-tier free bookkeeping:
    ``_free`` (truly free blocks) and ``_cached`` (refcount-0 blocks whose
    full-block KV is still valid and published in ``_hash_index``, LRU
    order). A held block lives in ``_refcount``; every holder releases
    exactly once, and a release below zero raises. The arena lives on
    `device` (None = CUDA, which must exist). ``kv_dtype="int8"`` stores an
    int8 payload with zeroed float32 scale sidecars ``k_scale``/``v_scale``
    ``[layers, heads, num_blocks]`` (``quantized`` is True); None keeps a
    `dtype` arena and no sidecars.
    """

    def __init__(self, num_blocks, num_layers, block_size, num_heads,
                 head_dim, dtype=torch.float32, device=None, metrics=None,
                 tracer=None, kv_dtype=None):
        if num_blocks < 2:
            raise ValueError("BlockPool needs >= 2 blocks (block 0 is null)")
        if kv_dtype not in (None, "int8"):
            raise ValueError(f"kv_dtype {kv_dtype!r} not supported: 'int8' "
                             "or None (the weight dtype)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.device = resolve_device(device)
        shape = (num_layers, num_heads, self.num_blocks, self.block_size,
                 head_dim)
        self.quantized = kv_dtype == "int8"
        dt = torch.int8 if self.quantized else dtype
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        self.k_scale = self.v_scale = None
        if self.quantized:
            self.k_scale = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros_like(self.k_scale)
        self.kv_dtype = str(dt).replace("torch.", "")
        # block 0 reserved as the null/scratch block
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._refcount = {}           # block -> holders (held blocks only)
        self._hash_index = {}         # content hash -> block
        self._block_hash = {}         # block -> content hash (inverse)
        self._cached = OrderedDict()  # refcount-0 indexed blocks, LRU order
        self.evictions = 0
        self.metrics = metrics
        self.tracer = tracer          # serving/trace.py EngineTracer or None
        self.tier = None              # host-memory tier (serving/kv_tier.py)

    def attach_tier(self, tier):
        """Install the host-memory tier (serving/kv_tier.py): evicted
        cached-free blocks demote to host instead of dying, and the
        scheduler can swap them back on a prefix match. One pointer: None
        keeps every hook below a single test."""
        self.tier = tier

    @property
    def num_free(self):
        """Allocatable blocks: truly free PLUS evictable cached-free."""
        return len(self._free) + len(self._cached)

    @property
    def num_truly_free(self):
        """Blocks allocatable without evicting a cached prefix block."""
        return len(self._free)

    @property
    def num_cached_blocks(self):
        return len(self._cached)

    def cached_blocks(self):
        """``(block, hash)`` pairs parked in the cached-free tier, LRU
        order: the demote walk of `LLMEngine.export_kv_tier`."""
        return list(self._cached.items())

    def blocks_for(self, num_tokens):
        return blocks_for(num_tokens, self.block_size)

    def bytes_per_block(self):
        """Device bytes one block costs: K + V payloads over all layers,
        plus an int8 arena's two scale-sidecar entries per (layer, head)."""
        L, H, _, bs, D = self.k.shape
        per = 2 * L * H * bs * D * self.k.element_size()
        if self.quantized:
            per += 2 * L * H * self.k_scale.element_size()
        return per

    def refcount(self, block):
        return self._refcount.get(int(block), 0)

    def block_hash(self, block):
        return self._block_hash.get(int(block))

    def allocate(self, n, evict=True):
        """Pop `n` blocks, or None if not enough. Truly-free blocks go
        first; then cached-free blocks are evicted LRU-first. ``evict=False``
        restricts the request to truly-free blocks (speculative
        reservations never push a cached prefix out). An armed
        ``alloc_fail`` fault reports the pool dry: callers defer or
        preempt exactly as under real block pressure."""
        if faults._PLAN is not None:
            fp = faults._PLAN.match("alloc_fail")
            if fp is not None:
                if self.tracer is not None:
                    self.tracer.pool_instant("fault[alloc_fail]", {"n": n})
                return None
        if n > (self.num_free if evict else len(self._free)):
            return None
        out = []
        n_evicted = 0
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, _ = self._cached.popitem(last=False)  # LRU victim
                h = self._block_hash.pop(b)
                del self._hash_index[h]
                if self.tier is not None:
                    # demote instead of dying: the tier buffers the (hash,
                    # block) pair and copies the bytes out at its next
                    # flush, which every arena-write site runs first
                    self.tier.save(h, b)
                self.evictions += 1
                n_evicted += 1
                if self.metrics is not None:
                    self.metrics.inc("prefix_cache_evictions")
            self._refcount[b] = 1
            out.append(b)
        if self.tracer is not None and n_evicted:
            self.tracer.pool_instant(
                "evict", {"blocks": n_evicted,
                          "cached_free": len(self._cached),
                          "truly_free": len(self._free)})
        return out

    def release(self, blocks, hashes=()):
        """Drop one holder's reference on each of `blocks`. A block whose
        refcount reaches zero retires to the cached-free tier when
        ``hashes[i]`` supplies its content hash, to the truly-free list
        otherwise. Raises on the null block and on a double free."""
        for i, b in enumerate(blocks):
            b = int(b)
            if b == 0:
                raise ValueError("cannot free the null block")
            rc = self._refcount.get(b)
            if rc is None:
                raise ValueError(f"double free of block {b}")
            if rc > 1:
                self._refcount[b] = rc - 1
                continue
            del self._refcount[b]
            self._retire(b, hashes[i] if i < len(hashes) else None)

    def _retire(self, b, h):
        """Move refcount-0 block `b` to its tier, keeping ``_hash_index``
        and ``_block_hash`` exact inverses."""
        old = self._block_hash.get(b)
        if h is None:
            if old is not None:
                del self._hash_index[old]
                del self._block_hash[b]
            self._free.append(b)
            return
        if old is not None and old != h:
            del self._hash_index[old]
            del self._block_hash[b]
        owner = self._hash_index.get(h)
        if owner is not None and owner != b:
            # another block already serves this content: free truly
            self._free.append(b)
            return
        self._hash_index[h] = b
        self._block_hash[b] = h
        self._cached[b] = h           # MRU end of the LRU order

    def match_prefix(self, hashes):
        """Longest cached prefix: pin (refcount++) every block `hashes`
        walks through the index, stopping at the first miss. Returns the
        pinned block ids in prefix order."""
        out = []
        for h in hashes:
            b = self._hash_index.get(h)
            if b is None:
                break
            if b in self._cached:
                del self._cached[b]
                self._refcount[b] = 1
            else:
                self._refcount[b] += 1
            out.append(b)
        return out

    def adopt(self, blocks, hashes):
        """Publish freshly allocated (held) blocks into the content index:
        the tier's swap-in path. A restored block holds valid full-block
        KV for ``hashes[i]`` and is matchable by later admissions exactly
        like a device-warm block. A hash already served by another block
        is skipped (the block stays held and correct, just unpublished),
        so the index and its inverse stay exact."""
        for b, h in zip(blocks, hashes):
            b = int(b)
            if self._hash_index.get(h) is not None:
                continue
            old = self._block_hash.get(b)
            if old is not None:
                del self._hash_index[old]
            self._hash_index[h] = b
            self._block_hash[b] = h

    def copy_blocks(self, src, dst):
        """Copy arena blocks `src` into blocks `dst` in place (the
        copy-on-write path), over every layer and head; an int8 arena's
        copies carry their sources' scales."""
        if self.tier is not None:
            # arena-write ordering: buffered demotions copy their (still
            # valid) bytes out before this copy lands on them
            self.tier.flush_saves()
        s = torch.as_tensor(src, dtype=torch.long, device=self.device)
        d = torch.as_tensor(dst, dtype=torch.long, device=self.device)
        for t in (self.k, self.v, self.k_scale, self.v_scale):
            if t is not None:
                t.index_copy_(2, d, t.index_select(2, s))

    def table_for(self, blocks, max_blocks):
        """Padded [max_blocks] int32 block table (0-padded)."""
        t = np.zeros(max_blocks, np.int32)
        t[: len(blocks)] = blocks
        return t

    def positions_to_slots(self, blocks, start, count, width):
        """(slots[width], offs[width]) scatter targets for token positions
        [start, start+count); positions beyond `count` go to the null
        block. `width` is the padded step width."""
        pos = np.arange(width)
        idx = (start + pos) // self.block_size
        offs = ((start + pos) % self.block_size).astype(np.int32)
        btab = np.asarray(blocks, np.int64)
        valid = (pos < count) & (idx < len(btab))
        slots = np.where(valid, btab[np.minimum(idx, len(btab) - 1)], 0)
        return slots.astype(np.int32), np.where(valid, offs, 0).astype(np.int32)
