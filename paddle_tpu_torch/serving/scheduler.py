"""Continuous-batching scheduler: chunked-prefill mixed batching, FCFS
admission, preemption-by-recompute. Host-only code.

Each `schedule()` call plans ONE mixed device step: every running sequence
gets a row, and a row is either

- a **decode row** — the sequence's single pending token (its last sampled
  token, fed at position ``num_cached``), always scheduled, never gated; or
- a **prefill-chunk row** — the next ``<= prefill_chunk`` tokens of a
  sequence whose prompt (or post-preemption replay) is not yet in the KV
  arena, admitted FCFS under a per-step ``token_budget`` of prefill tokens.

A row emits a token only when it reaches the sequence's last pending
position, so a replay after preemption never re-emits tokens.

Admission is FCFS into free lanes (``max_batch`` rows). KV blocks are
allocated chunk by chunk, oldest sequence first; when the pool runs dry a
row preempts the youngest running sequence that holds blocks (older may
reclaim from younger, never the reverse): the victim's blocks are freed and
its prompt+generated tokens re-queue at the FRONT of the waiting queue. The
OLDEST sequence failing to grow means the pool cannot hold even one
sequence, which fails loudly as a config error.

**Prefix caching** hooks in at admission (`_match_prefix` pins the longest
cached full-block prefix), before a row's scatter (`_ensure_writable`
copies a shared block on write), and at release (`_release_blocks`
publishes the hashes of fully written prompt blocks).

**Speculative decoding**: with a drafter, `_attach_drafts` asks the n-gram
drafter for candidate continuations of each emitting row and reserves KV
blocks for them from truly-free blocks only (speculation never evicts a
cached prefix or preempts anyone). After verification the engine calls
`reclaim_spec_blocks`, which frees the rejected tail's reservation.
"""
from __future__ import annotations

import itertools
import time
from collections import deque, namedtuple

_rid_counter = itertools.count()
_arrival_counter = itertools.count()

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"
ABORTED = "aborted"

# One planned row of the next mixed step: feed `req.all_ids[start:start+count]`
# at positions [start, start+count); `emit` marks rows whose last fed position
# is the sequence's final pending token. `draft` carries drafted candidates fed
# AFTER the pending token; their blocks are already reserved.
ScheduledRow = namedtuple(
    "ScheduledRow", ["req", "start", "count", "emit", "draft"],
    defaults=((),),
)


class Request:
    """One generation request and its host-side serving state."""

    def __init__(self, prompt_ids, max_new_tokens=16, temperature=0.0,
                 eos_token_id=None, request_id=None, top_k=None, top_p=None,
                 spec_decoding=None, num_spec_tokens=None):
        self.request_id = (
            request_id if request_id is not None else next(_rid_counter)
        )
        self.prompt_ids = [int(t) for t in prompt_ids]
        if not self.prompt_ids:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.temperature = float(temperature)
        self.top_k = None if top_k in (None, 0) else int(top_k)
        if self.top_k is not None and self.top_k < 1:
            raise ValueError("top_k must be >= 1 (or 0/None to disable)")
        self.top_p = None if top_p is None else float(top_p)
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        # speculative decoding overrides: None defers to the engine; False
        # (or num_spec_tokens=0) opts out; num_spec_tokens lowers the cap
        self.spec_decoding = spec_decoding
        self.num_spec_tokens = (
            None if num_spec_tokens is None else int(num_spec_tokens)
        )
        if self.num_spec_tokens is not None and self.num_spec_tokens < 0:
            raise ValueError("num_spec_tokens must be >= 0")
        self.eos_token_id = eos_token_id
        self.output_ids = []
        self.state = WAITING
        self.finish_reason = None
        self.blocks = []            # arena block ids owned by this sequence
        self.num_cached = 0         # tokens whose K/V live in the arena
        self.block_hashes = []      # chained full-block prompt hashes
        self.num_matched_blocks = 0  # cache-hit pins from this admission
        self.preemptions = 0
        self.arrival_time = time.monotonic()   # TTFT anchor
        self.admit_time = None
        self.first_token_time = None
        self.prefix_hit_tokens = 0
        self.spec_accepted = 0
        # total arrival order, stable across preemption/re-admission
        self.arrival_seq = next(_arrival_counter)

    @property
    def all_ids(self):
        """Prompt + generated tokens — what a recompute prefill replays."""
        return self.prompt_ids + self.output_ids

    @property
    def num_tokens(self):
        return len(self.prompt_ids) + len(self.output_ids)

    @property
    def num_pending(self):
        """Tokens not yet fed through the model (>= 1 while running)."""
        return self.num_tokens - self.num_cached

    @property
    def finished(self):
        return self.state in (FINISHED, ABORTED)

    @property
    def aborted(self):
        return self.state == ABORTED

    @property
    def last_token(self):
        return self.output_ids[-1] if self.output_ids else self.prompt_ids[-1]

    def remaining_new_tokens(self):
        return self.max_new_tokens - len(self.output_ids)


class Scheduler:
    def __init__(self, pool, max_batch=8, token_budget=2048,
                 prefill_chunk=None, metrics=None, prefix_cache=True,
                 drafter=None, width_buckets=None):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.token_budget = int(token_budget)
        if self.token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        self.prefill_chunk = min(
            int(prefill_chunk) if prefill_chunk is not None
            else self.token_budget,
            self.token_budget,
        )
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.metrics = metrics
        self.prefix_cache = bool(prefix_cache)
        self.drafter = drafter
        # the engine's ragged width buckets: draft attachment may neither
        # exceed the widest nor bump a step into a wider bucket than its
        # drafted work amortizes. None means widths at face value.
        self.width_buckets = (sorted(int(w) for w in width_buckets)
                              if width_buckets else None)
        self.waiting = deque()
        self.running = []

    def _bucket(self, w):
        """Smallest width bucket covering `w` (identity with no table)."""
        if self.width_buckets is None:
            return w
        for b in self.width_buckets:
            if b >= w:
                return b
        return self.width_buckets[-1]

    # -- queue ops ---------------------------------------------------------

    def add(self, req):
        self.waiting.append(req)

    def has_unfinished(self):
        return bool(self.waiting or self.running)

    def _release_blocks(self, req):
        """The ONE place a request's KV blocks return to the pool. Full
        prompt blocks whose KV is completely written (or that were matched
        at admission) publish their content hash; the rest free truly."""
        if req.blocks:
            n_pub = 0
            if self.prefix_cache:
                n_pub = min(len(req.block_hashes),
                            max(req.num_cached // self.pool.block_size,
                                req.num_matched_blocks),
                            len(req.blocks))
            self.pool.release(req.blocks, req.block_hashes[:n_pub])
            req.blocks = []
        req.num_cached = 0
        req.num_matched_blocks = 0

    def finish(self, req):
        req.state = FINISHED
        self._release_blocks(req)
        if req in self.running:
            self.running.remove(req)

    def abort(self, req):
        """Remove a request in ANY live state, freeing its KV blocks.
        Idempotent for already-terminal requests."""
        if req.finished:
            return
        req.state = ABORTED
        self._release_blocks(req)
        if req in self.running:
            self.running.remove(req)
        try:
            self.waiting.remove(req)
        except ValueError:
            pass
        if self.metrics is not None:
            self.metrics.inc("requests_aborted")

    def _preempt(self, req):
        """Preempt-by-recompute: drop the KV, re-queue at the front. The
        released blocks publish their hashes, so a victim whose cached
        prefix survives until re-admission repins it."""
        self._release_blocks(req)
        req.state = WAITING
        req.preemptions += 1
        if req in self.running:
            self.running.remove(req)
        self.waiting.appendleft(req)
        if self.metrics is not None:
            self.metrics.inc("preemptions")

    # -- policy ------------------------------------------------------------

    def _match_prefix(self, req):
        """Pin the longest cached full-block prefix of `req`'s prompt.
        ``num_cached`` starts at the first uncached token, capped at
        ``num_tokens - 1`` so the last token always runs as the query."""
        if self.metrics is not None:
            self.metrics.inc("prefix_cache_lookup_tokens",
                             len(req.block_hashes) * self.pool.block_size)
        hit = self.pool.match_prefix(req.block_hashes)
        if not hit:
            return
        req.blocks = list(hit)
        req.num_matched_blocks = len(hit)
        req.num_cached = min(len(hit) * self.pool.block_size,
                             req.num_tokens - 1)
        req.prefix_hit_tokens = len(hit) * self.pool.block_size
        if self.metrics is not None:
            self.metrics.inc("prefix_cache_hit_tokens",
                             len(hit) * self.pool.block_size)

    def _take_block(self, req):
        """One block for `req`, preempting strictly younger sequences when
        the pool is dry. Returns the block id, or None to defer the row."""
        while True:
            got = self.pool.allocate(1)
            if got is not None:
                return got[0]
            victim = max(
                (r for r in self.running
                 if r.arrival_seq > req.arrival_seq and r.blocks),
                key=lambda r: r.arrival_seq, default=None,
            )
            if victim is not None:
                self._preempt(victim)
                continue
            if not any(r.arrival_seq < req.arrival_seq for r in self.running):
                # the oldest sequence cannot grow: the pool cannot hold
                # even one sequence — a config error, not a scheduling state
                raise ValueError(
                    f"request {req.request_id}: needs more KV blocks but "
                    f"the pool only has {self.pool.num_free} free with no "
                    "younger sequences to preempt — raise num_blocks or "
                    "shorten the request"
                )
            return None

    def _grow(self, req, need):
        """Grow `req.blocks` to `need` blocks. Returns False to defer."""
        while len(req.blocks) < need:
            b = self._take_block(req)
            if b is None:
                return False
            req.blocks.append(b)
        return True

    def _ensure_writable(self, req, start, count):
        """Copy-on-write: any block receiving scatters for positions
        [start, start+count) that is shared with another holder is first
        duplicated via `copy_blocks`, and `req` swaps its table entry to
        the private copy. Returns False to defer (pool dry)."""
        bs = self.pool.block_size
        for idx in range(start // bs, (start + count - 1) // bs + 1):
            b = req.blocks[idx]
            if self.pool.refcount(b) <= 1:
                continue
            nb = self._take_block(req)
            if nb is None:
                return False
            if self.pool.refcount(b) <= 1:
                # preempting for `nb` released the other holder
                self.pool.release([nb])
                continue
            self.pool.copy_blocks([b], [nb])
            # drop OUR reference only; co-holders and the index keep it
            self.pool.release([b], [self.pool.block_hash(b)])
            req.blocks[idx] = nb
            if self.metrics is not None:
                self.metrics.inc("prefix_cache_cow_copies")
        return True

    def _admit(self, req):
        req.state = RUNNING
        if (self.prefix_cache and req.block_hashes and not req.blocks
                and req.num_cached == 0):
            self._match_prefix(req)
        if req.admit_time is None:
            req.admit_time = time.monotonic()
        self.running.append(req)

    def schedule(self):
        """Plan one mixed step. Returns the list of ScheduledRows (empty =
        idle): waiting requests are admitted FCFS into free lanes, then
        every running sequence gets its decode token or its next prefill
        chunk, budget and pool permitting."""
        while self.waiting and len(self.running) < self.max_batch:
            self._admit(self.waiting.popleft())
        budget = self.token_budget
        rows = []
        # plan oldest first: the oldest request gets first claim on the
        # budget and on pool blocks (the no-livelock guarantee)
        for req in sorted(self.running, key=lambda r: r.arrival_seq):
            if req not in self.running:
                continue  # preempted while an earlier row grew its blocks
            pending = req.num_pending
            if pending == 1:
                count = 1   # decode rows are never gated on the budget
            else:
                count = min(pending, self.prefill_chunk, budget)
                if count < 1:
                    continue  # budget spent; this chunk waits a step
            start = req.num_cached
            if not self._grow(req, self.pool.blocks_for(start + count)):
                continue
            if not self._ensure_writable(req, start, count):
                continue
            if pending > 1:
                budget -= count
            rows.append(ScheduledRow(req, start, count, emit=count == pending))
        if self.drafter is not None and rows:
            rows = self._attach_drafts(rows, budget)
        return rows

    # -- speculative decoding ----------------------------------------------

    def _attach_drafts(self, rows, budget):
        """Ask the drafter for candidate continuations of each emitting
        row and reserve KV for them; drafted tokens are charged to the
        remaining step `budget`.

        Width gate: a chunk-carrying (mixed) step already pays its width
        bucket for every lane, so emitting rows there draft for free as
        long as ``count + k`` stays inside that bucket. A pure-decode step
        would widen from bucket 1 to ``bucket(1 + max k)``, so drafts attach
        only when ``sum(k_i) >= bucket - 1``."""
        mixed = any(r.count > 1 for r in rows)
        base_w = self._bucket(max(r.count for r in rows))
        top_w = (self.width_buckets[-1] if self.width_buckets is not None
                 else None)
        proposals = []
        for row in rows:
            req = row.req
            cap = self.drafter.num_spec_tokens
            if req.num_spec_tokens is not None:
                cap = min(cap, req.num_spec_tokens)
            # the accepted run emits up to k+1 tokens; never draft past the
            # request's remaining token allowance
            cap = min(cap, req.remaining_new_tokens() - 1)
            if mixed:
                cap = min(cap, base_w - row.count)
            elif top_w is not None:
                cap = min(cap, top_w - row.count)
            draft = []
            if row.emit and req.spec_decoding is not False and cap >= 1:
                draft = self.drafter.propose(req.all_ids, cap)
            proposals.append(draft)
        if not mixed:
            w_new = self._bucket(1 + max((len(d) for d in proposals),
                                         default=0))
            if sum(len(d) for d in proposals) < w_new - 1:
                return rows
        out = []
        for row, draft in zip(rows, proposals):
            draft = draft[:budget]
            if draft:
                draft = self._reserve_spec(
                    row.req, row.start + row.count - 1, draft)
            if draft:
                budget -= len(draft)
                row = row._replace(draft=tuple(draft))
            out.append(row)
        return out

    def _reserve_spec(self, req, start, draft):
        """Reserve truly-free KV blocks for `draft` tokens after the
        pending token at `start`; returns the (possibly trimmed) draft.
        Every reserved block is fresh (refcount 1, unpublished), so
        `reclaim_spec_blocks` can free a rejected tail safely."""
        bs = self.pool.block_size
        avail = self.pool.num_truly_free
        k = min(len(draft), (len(req.blocks) + avail) * bs - start - 1)
        if k < 1:
            return []
        need = self.pool.blocks_for(start + 1 + k) - len(req.blocks)
        if need > 0:
            got = self.pool.allocate(need, evict=False)
            if got is None:
                return []
            req.blocks.extend(got)
        return draft[:k]

    def reclaim_spec_blocks(self, req):
        """After a verify step keep the blocks covering the sequence's
        tokens and truly-free the rejected tail's reservation."""
        keep = self.pool.blocks_for(req.num_tokens)
        if len(req.blocks) > keep:
            self.pool.release(req.blocks[keep:])
            del req.blocks[keep:]
