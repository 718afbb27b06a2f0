"""Host-memory KV block tier: copy-out on eviction, copy-back on match, and
the payload of a replica-to-replica handoff (the JAX package's
`serving/kv_tier.py`, in PyTorch).

The device arena (block_pool.py) bounds the prefix cache at device size;
host RAM is far larger. This module adds a third tier under the pool's two
(truly free, cached-free): when LRU eviction claims a cached-free block,
its contents are copied to a host slab and its content hash stays
matchable in the tier's index. A later request whose prompt walks past the
device index into host-resident hashes gets those blocks copied back into
freshly allocated arena blocks, charged exactly like device cache hits.

The four rules of the JAX module, in PyTorch terms:

1. **Save buffers, flush gathers.** `save(h, b)` (called by the pool inside
   its eviction branch) only buffers the pair: the block's bytes stay valid
   on the device until the next arena write. `flush_saves()` gathers each
   chunk of buffered blocks with `index_select` into a device staging chunk
   on the engine's stream, starts a non-blocking copy of each block into
   its slot of the pinned host slabs, records a CUDA event, and hands the
   chunk's entries and event to the drain thread, which waits on the event
   and marks them landed. Every arena write flushes first: the engine
   between `schedule()` and the step's replay, `BlockPool.copy_blocks`
   before the copy-on-write copy, and `restore` before its own copy-back.
   Stream order then guarantees the gather reads the bytes from before the
   write.
2. **Restore at plan time.** A host hit allocates device blocks (evictions
   it causes are flushed first, rule 1), copies each block from its pinned
   slab slot into a device staging buffer with a non-blocking copy, and
   `index_copy_`s the buffer into the arena in place, all enqueued on the
   stream the step programs replay on, ahead of the step that reads them.
   Every copy into or out of a slab runs on that one stream, so a restore
   of a block whose save is still in flight, or a save into a slot that a
   restore is still reading, is ordered by the stream and needs no wait.
3. **Per-shard slabs.** Under tensor parallelism each rank's slab holds its
   own heads (`ServingMesh.tp_head_ranges`): the controller keeps the
   index and rank 0's slab, and every copy into or out of a slab runs on
   every rank with the same (block, slot) lists, through the engine's
   channel (``peers``, serving/tp_worker.py) in the controller's order, so
   a save never gathers across ranks. On one card the slab covers every
   head.
4. **One lock.** All index, slab and pending state is guarded by
   ``KVTier._lock``; it never nests with another lock, no device sync runs
   on the engine thread (the one host sync a step stays the step's), and
   the drain thread talks to the engine thread only through a
   ``queue.Queue`` plus that lock. A late slab write that races a host-LRU
   eviction is dropped by a per-slot generation counter.

An int8 arena's blocks carry their per-(layer, head) float32 scales
through every path: save, restore, export and import.

Migration (`export` / `import_payload`) hands the host-resident blocks to
another engine as ``hash -> [L, H, bs, D]`` CPU tensors (plus ``[L, H]``
scales for an int8 arena), oldest first, every head whatever the
topology: a tensor-parallel tier joins its ranks' slabs on export and
cuts its ranks' heads on import, so a payload moves across tp degrees.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from collections import OrderedDict

import torch


class KVTier:
    """Host-memory block tier under one `BlockPool`.

    Thread model: the engine thread calls `save`/`flush_saves`/`match`/
    `restore`; `export`/`import_payload` run on a quiescent (drained)
    engine from any thread; the ``kvtier-drain`` thread owns nothing but
    `_land_chunk`. Every shared access takes ``self._lock``. Device work
    is enqueued on `stream` (the engine's; None on a CPU engine).

    Slabs are slot-major: ``[host_blocks, L, H, bs, D]`` in the arena's
    dtype (and ``[host_blocks, L, H]`` float32 scales for an int8 arena),
    so one block's host copy is contiguous; on a CUDA engine they are
    pinned, so the card copies straight into and out of them.
    """

    def __init__(self, pool, host_blocks, mesh=None, metrics=None,
                 swap_chunk=4, stream=None):
        if host_blocks < 1:
            raise ValueError("host_kv_blocks must be >= 1")
        self.pool = pool
        self.metrics = metrics
        self.stream = stream
        self.host_blocks = int(host_blocks)
        self.swap_chunk = max(1, int(swap_chunk))
        self.quantized = bool(pool.quantized)
        L, H, _, Bs, D = pool.k.shape
        # this rank's head range; the payload's logical block has them all
        self.shards = ([(0, H)] if mesh is None
                       else mesh.tp_head_ranges(H * mesh.tp_degree))
        self.heads = self.shards[0 if mesh is None else mesh.rank]
        self.peers = None             # tp controller: the ranks' channel
        self._shape = (L, H * len(self.shards), Bs, D)
        self._dtype = pool.k.dtype
        self._pin = pool.device.type == "cuda"
        self._slabs = tuple(
            torch.zeros((self.host_blocks,) + tuple(a.shape[:2])
                        + tuple(a.shape[3:]), dtype=a.dtype,
                        pin_memory=self._pin)
            for a in self._arenas())
        self._lock = threading.Lock()
        self._index = OrderedDict()   # hash -> slot (LRU order, MRU last)
        self._slot_gen = [0] * self.host_blocks  # bumps on slot reuse
        self._free_slots = list(range(self.host_blocks - 1, -1, -1))
        self._save_buf = []           # buffered (hash, device block) saves
        self._pending = {}            # hash -> (slot, gen): copy in flight
        self.swap_ins = 0
        self.swap_outs = 0
        self.swap_in_hit_tokens = 0
        self.migrated_blocks_out = 0
        self.migrated_blocks_in = 0
        self._queue = queue.Queue()
        self._drain = threading.Thread(target=self._drain_loop,
                                       name="kvtier-drain", daemon=True)
        self._drain.start()

    def _arenas(self):
        """The arena tensors a block lives in, each ``[L, H, N, ...]``:
        K and V, plus an int8 arena's scale sidecars."""
        p = self.pool
        return ((p.k, p.v, p.k_scale, p.v_scale) if self.quantized
                else (p.k, p.v))

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _device_index(self, ids):
        """`ids` as a long tensor on the arena's device, copied from pinned
        memory without a sync on CUDA."""
        t = torch.tensor(ids, dtype=torch.long)
        if self._pin:
            t = t.pin_memory().to(self.pool.device, non_blocking=True)
        return t

    # -- save path (engine thread) -----------------------------------------

    def save(self, h, block):
        """Buffer one evicted cached-free block for demotion to host.
        Called by the pool inside its eviction branch: the block's arena
        bytes stay valid until the next arena write, and every arena-write
        site flushes this buffer first (module docstring, rule 1)."""
        with self._lock:
            if h in self._index and h not in self._pending:
                self._index.move_to_end(h)   # already resident: refresh
                return
            self._save_buf.append((h, int(block)))

    def flush_saves(self):
        """Gather every buffered save into device staging chunks, start
        their copies into the host slabs, and hand them to the drain
        thread. Runs before any arena write; a cheap no-op when the buffer
        is empty."""
        with self._lock:
            if not self._save_buf:
                return
            buf, self._save_buf = self._save_buf, []
            plan = []                 # (hash, block, slot, gen)
            for h, b in buf:
                if h in self._index:
                    self._index.move_to_end(h)
                    continue
                slot = self._take_slot_locked()
                self._index[h] = slot
                plan.append((h, b, slot, self._slot_gen[slot]))
        if not plan:
            return
        for i in range(0, len(plan), self.swap_chunk):
            chunk = plan[i:i + self.swap_chunk]
            pairs = [(b, slot) for _, b, slot, _ in chunk]
            if self.peers is not None:
                self.peers.send("tier_save", pairs)
            event = self._copy_out(pairs)
            entries = [(h, slot, gen) for h, _, slot, gen in chunk]
            with self._lock:
                for h, slot, gen in entries:
                    self._pending[h] = (slot, gen)
            self._queue.put((entries, event))

    def _copy_out(self, pairs):
        """Gather arena blocks into a device staging chunk and start their
        copies into slab slots (`pairs`: ``(block, slot)``) on the
        engine's stream; returns the chunk's CUDA event (None on the
        CPU). A tensor-parallel rank runs this for the controller's
        saves."""
        with self._on_stream():
            src = self._device_index([b for b, _ in pairs])
            dev = tuple(a.index_select(2, src).movedim(2, 0).contiguous()
                        for a in self._arenas())
            for j, (_, slot) in enumerate(pairs):
                for slab, d in zip(self._slabs, dev):
                    slab[slot].copy_(d[j], non_blocking=self._pin)
            event = None
            if self._pin:
                event = torch.cuda.Event()
                event.record()
        return event

    def _take_slot_locked(self):
        """One host slot, evicting the host-LRU entry when full. Caller
        holds the lock."""
        if self._free_slots:
            return self._free_slots.pop()
        for h in self._index:          # oldest first
            if h not in self._pending:
                slot = self._index.pop(h)
                self._slot_gen[slot] += 1
                return slot
        # everything resident is a pending save: evict the oldest pending
        # entry anyway (its copy and the next one into the slot are ordered
        # on the stream; the gen bump keeps the first from counting)
        h, slot = next(iter(self._index.items()))
        del self._index[h]
        del self._pending[h]
        self._slot_gen[slot] += 1
        return slot

    # -- drain thread ------------------------------------------------------

    def _drain_loop(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                self._land_chunk(*item)
            finally:
                self._queue.task_done()

    def _land_chunk(self, entries, event):
        """Wait for one chunk's copies into the slabs, then mark its
        entries landed under the lock. An entry whose slot host-LRU evicted
        while the copy was in flight (generation mismatch) is not
        counted."""
        if event is not None:
            event.synchronize()
        written = 0
        with self._lock:
            for h, slot, gen in entries:
                pend = self._pending.get(h)
                if pend is None or pend[1] != gen:
                    continue
                del self._pending[h]
                if self._slot_gen[slot] != gen:
                    continue
                written += 1
                self.swap_outs += 1
        if self.metrics is not None and written:
            self.metrics.inc("swap_outs", written)

    # -- restore path (engine thread) --------------------------------------

    def match(self, hashes):
        """Longest consecutive host-resident run of `hashes` (resident =
        slab written OR still pending its slab write). Refreshes LRU."""
        n = 0
        with self._lock:
            for h in hashes:
                if h not in self._index:
                    break
                self._index.move_to_end(h)
                n += 1
        return n

    def restore(self, hashes, blocks):
        """Copy `hashes` (host-resident per a prior `match`) back into the
        freshly allocated arena `blocks`, on the engine's stream. Host
        copies are kept (still matchable; a re-eviction of the restored
        block is a free re-save). Returns the number of LEADING blocks
        actually restored: an entry evicted between match and restore trims
        the run, and the caller charges (and publishes) only that many."""
        self.flush_saves()   # rule 1: evictions for `blocks` gather first
        slots = []
        with self._lock:
            for h in hashes:
                slot = self._index.get(h)
                if slot is None:
                    break
                slots.append(slot)
            n = len(slots)
            self.swap_ins += n
            self.swap_in_hit_tokens += n * self.pool.block_size
        if n == 0:
            return 0
        if self.peers is not None:
            self.peers.send("tier_restore", slots, list(blocks[:n]))
        self._copy_in(slots, blocks[:n])
        if self.metrics is not None:
            self.metrics.inc("swap_ins", n)
            self.metrics.inc("swap_in_hit_tokens", n * self.pool.block_size)
        return n

    def _copy_in(self, slots, blocks):
        """Copy slab `slots` into arena `blocks` on the engine's stream. The
        copies need no lock: only the engine thread takes slots, and every
        copy into a slab is ordered on the stream (rule 2). A
        tensor-parallel rank runs this for the controller's restores."""
        with self._on_stream():
            dst = self._device_index(blocks)
            for arena, slab in zip(self._arenas(), self._slabs):
                stage = torch.empty((len(slots),) + slab.shape[1:],
                                    dtype=slab.dtype, device=self.pool.device)
                for r, slot in enumerate(slots):
                    stage[r].copy_(slab[slot], non_blocking=self._pin)
                arena.index_copy_(2, dst, stage.movedim(0, 2))

    # -- migration (quiescent engine, any thread) --------------------------

    def settle(self):
        """Block until every dispatched save has landed in its slab."""
        self.flush_saves()
        self._queue.join()

    def _quiesce(self):
        """Settle, and let every copy out of the slabs finish, before the
        host writes a slab."""
        self.settle()
        if self.stream is not None:
            self.stream.synchronize()

    def export(self):
        """Every host-resident block as ``(hash, k, v)`` (int8: ``(hash, k,
        v, k_scale, v_scale)``) with ``[L, H, bs, D]`` (scales ``[L, H]``)
        CPU tensors, oldest first (so an importer's LRU order mirrors
        ours). Call `settle` (or `LLMEngine.export_kv_tier`) first so
        pending saves are included."""
        with self._lock:
            resident = [(h, slot) for h, slot in self._index.items()
                        if h not in self._pending]
            slots = [slot for _, slot in resident]
            parts = [self._read_slots(slots)]
            if self.peers is not None:
                parts += self.peers.call("tier_read", slots)
            # every rank's heads, in rank order (head axis 1 of [L, H, ...])
            entries = [(h,) + tuple(torch.cat([p[i][k] for p in parts], 1)
                                    for k in range(len(self._slabs)))
                       for i, (h, _) in enumerate(resident)]
            self.migrated_blocks_out += len(entries)
        if self.metrics is not None and entries:
            self.metrics.inc("kv_migrated_blocks_out", len(entries))
        return {"shape": self._shape, "dtype": _dtype_name(self._dtype),
                "block_size": self.pool.block_size, "entries": entries}

    def import_payload(self, payload):
        """Adopt an exported payload into this tier (oldest first, LRU
        evicting our own cold entries as needed). Shape, dtype and
        block-size mismatches raise: adopting foreign-geometry KV would
        serve one model's cache to another. Returns blocks imported."""
        if (tuple(payload["shape"]) != self._shape
                or payload["dtype"] != _dtype_name(self._dtype)
                or payload["block_size"] != self.pool.block_size):
            raise ValueError(
                f"kv tier geometry mismatch: theirs "
                f"{payload['shape']}/{payload['dtype']}/bs"
                f"{payload['block_size']}, ours {self._shape}/"
                f"{_dtype_name(self._dtype)}/bs{self.pool.block_size}")
        self._quiesce()
        n = 0
        with self._lock:
            slots, taken = [], []
            for entry in payload["entries"]:
                h = entry[0]
                if h in self._index:
                    self._index.move_to_end(h)
                    continue
                slot = self._take_slot_locked()
                self._index[h] = slot
                slots.append(slot)
                taken.append(tuple(torch.as_tensor(t) for t in entry[1:]))
                n += 1
            if self.peers is not None:
                self.peers.send("tier_write", slots, taken)
            self._write_slots(slots, taken)
            self.migrated_blocks_in += n
        if self.metrics is not None and n:
            self.metrics.inc("kv_migrated_blocks_in", n)
        return n

    def _read_slots(self, slots):
        """Copies of slab `slots` (this rank's heads): one tuple of
        ``[L, h, bs, D]`` (scales ``[L, h]``) CPU tensors per slot. The
        caller has let the slabs settle."""
        return [tuple(slab[slot].clone() for slab in self._slabs)
                for slot in slots]

    def _write_slots(self, slots, entries):
        """Write full-head payload `entries` (one tuple of tensors per
        slot) into slab `slots`, keeping this rank's heads. The caller
        has quiesced the slabs."""
        h0, h1 = self.heads
        for slot, arrays in zip(slots, entries):
            for slab, t in zip(self._slabs, arrays):
                slab[slot].copy_(t[:, h0:h1])

    # -- observability -----------------------------------------------------

    def stats(self):
        """Gauges and counters for pool_stats() and the debug surfaces."""
        with self._lock:
            return {
                "host_blocks_total": self.host_blocks,
                "host_blocks_used": len(self._index),
                "swap_ins": self.swap_ins,
                "swap_outs": self.swap_outs,
                "swap_in_hit_tokens": self.swap_in_hit_tokens,
                "migrated_blocks_out": self.migrated_blocks_out,
                "migrated_blocks_in": self.migrated_blocks_in,
            }

    def debug_snapshot(self):
        """The /debug/kvtier body: stats plus the resident hash ring
        (hex-truncated, LRU to MRU) and slab geometry."""
        s = self.stats()
        with self._lock:
            s["pending_saves"] = len(self._pending)
            s["resident"] = [h.hex()[:16] for h in self._index]
        s["swap_chunk"] = self.swap_chunk
        s["block_shape"] = list(self._shape)
        s["dtype"] = _dtype_name(self._dtype)
        s["quantized"] = self.quantized
        s["shards"] = [list(r) for r in self.shards]
        return s

    def close(self):
        """Stop the drain thread (idempotent). Queued chunks are written
        first, so no save is silently dropped."""
        if self._drain.is_alive():
            self._queue.put(None)
            self._drain.join(timeout=10.0)


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")
