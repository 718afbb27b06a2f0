"""Replica-fleet router: prefix-affinity routing, health-aware ejection,
retry-elsewhere, and rolling drain over N engine replicas (the JAX
package's `serving/router.py`, over the port's engines).

`ReplicaRouter` fronts N `AsyncLLMEngine` replicas inside one asyncio
process (on one card they share it: each replica owns its weights, arena
and step programs) and decides, per request, *which* replica serves it
and *what happens when that replica fails*:

**Routing.** Requests whose prompt spans at least one full KV block get a
prefix-affinity key — one of the chained block hashes
(`block_pool.chain_block_hashes`), ``affinity_prefix_blocks`` deep — and
are **rendezvous-hashed** (highest-random-weight, sha256 of key and
replica name: the JAX router's homes exactly) onto a home replica. Two
requests sharing a system prompt share the key, land on the same replica
and hit its prefix cache; when a replica leaves rotation only ITS keys
move, everyone else's cache stays warm. Cache-cold traffic (no full
block) spreads least-loaded. An affinity-homed request whose home
replica's predicted queue wait would blow its deadline is diverted to the
least-loaded replica.

**Health-aware ejection.** Each replica runs a state machine — ``active``
/ ``draining`` / ``ejected`` / ``probing`` — driven by the ``/healthz``
word (`AsyncLLMEngine.healthz_state`: ``ok`` / ``draining`` /
``unhealthy`` / ``engine_dead``) observed by a periodic sweep and at
every admission rejection. ``unhealthy``/``engine_dead`` ejects;
``draining`` routes around without ejecting. A replica whose supervisor
reports poison isolations from ≥ ``poison_source_threshold`` DISTINCT
sources inside its sliding window is also ejected (`poison_stats` — a sick
card poisons everyone; one adversarial tenant is one source and can never
trip this). Ejected replicas are re-admitted through a **half-open
probe**: after ``probe_interval_s`` (exponential backoff per failed
probe) the router sends ONE trial request; only a completed probe
re-admits. Sticky-unhealthy replicas are rebuilt through the optional
``factory`` before probing.

**Retry-elsewhere + safe retry.** A rejected admission (429/503) is
retried on the next eligible replica immediately; when every replica has
rejected, the router backs off — jittered exponential, honoring each
replica's ``Retry-After`` via a per-replica ``not_before`` window — and
burns one unit of the bounded ``retry_budget``. After admission, the
**safe-retry rule**: a stream that dies with a REPLICA-attributed fault
(its replica's healthz left ``ok``) and **zero delivered tokens** is
replayed elsewhere with its *remaining* deadline and its tenant/priority
unchanged; a mid-stream victim gets exactly ONE structured terminal
``error`` event; a request whose replica stayed healthy owns its own
failure and is never replayed onto a second replica.

**Deadline-aware early rejection.** When even the least-loaded replica's
predicted queue wait (per-replica EWMA of observed service time × queue
depth) exceeds a request's remaining ``deadline_s``, the router rejects
at admission with ``EngineOverloadedError(reason=
"deadline_unattainable")`` (HTTP 429 + Retry-After).

**Rolling drain.** `rolling_drain()` walks the fleet one replica at a
time: stop routing to it, close its own admission, wait for in-flight
zero, restart it via the factory (or `resume_admitting` when no factory
is configured), re-admit, move on — a restart in which no request fails.

**Threads.** All router state lives on the event loop (submit, sweep,
probe, drain). Work that blocks runs elsewhere: the factory (streaming a
checkpoint and capturing CUDA graphs while the other replicas keep
serving) on a worker thread, and the host-tier handoff of a restart,
retire or ejection through each engine's own thread (`AsyncLLMEngine.
call`: an import into a live replica settles its tier's saves, which only
the thread that steps it may do) or, for a salvage off a sick replica, as
a host-only read of its settled slabs on a worker thread. `RouterServer`
(serving/server.py) exposes the fleet over HTTP.
"""
from __future__ import annotations

import asyncio
import hashlib
import random
import time
from collections import deque

from .block_pool import chain_block_hashes
from .frontend import EngineClosedError, EngineOverloadedError
from .metrics import ServingMetrics

_END = object()

ACTIVE, DRAINING, EJECTED, PROBING = ("active", "draining", "ejected",
                                      "probing")


class Replica:
    """One engine replica behind the router: the `AsyncLLMEngine` plus
    the router-side state machine and routing bookkeeping."""

    def __init__(self, name, engine, index):
        self.name = name
        self.index = index
        self.engine = engine            # AsyncLLMEngine
        self.state = ACTIVE
        self.router_draining = False    # router-initiated (rolling) drain
        self.eject_reason = None
        self.not_before = 0.0           # Retry-After backpressure window
        self.next_probe_at = 0.0
        self.probe_failures = 0
        self.restarts = 0
        self.ewma_service_s = None      # observed e2e service time

    def snapshot(self):
        state, _ = self.engine.healthz_state()
        return {
            "name": self.name,
            "state": self.state,
            "healthz": state,
            "lifecycle": getattr(self.engine, "lifecycle_state",
                                 lambda: None)(),
            "inflight": self.engine.inflight,
            "eject_reason": self.eject_reason,
            "probe_failures": self.probe_failures,
            "restarts": self.restarts,
            "ewma_service_s": (None if self.ewma_service_s is None
                               else round(self.ewma_service_s, 4)),
        }


class RoutedStream:
    """The consumer-facing token stream of one routed request.

    Mirrors `RequestStream`'s read surface (``async for``, `collect`,
    `finish_reason`, `error`) so the HTTP layer serves either. The
    router's forwarding task feeds it; across replays the consumer sees
    ONE seamless stream — a replay only ever happens before the first
    token was delivered, and a terminal event is delivered exactly once
    (`terminal_events` counts delivery attempts so chaos tests can
    assert the invariant, not just observe idempotence).
    """

    def __init__(self):
        self.queue = asyncio.Queue()
        self.request_id = None
        self.replica = None             # name of the (last) serving replica
        self.n_tokens = 0               # tokens delivered to this stream
        self.replays = 0
        self.finished = False
        self.finish_reason = None
        self.error = None
        self.terminal_events = 0        # attempts; must end the serve at 1
        self.done = asyncio.Event()
        self.req = None                 # last replica-side Request record
        self._abort = None

    async def tokens(self):
        while True:
            item = await self.queue.get()
            if item is _END:
                return
            yield item

    __aiter__ = tokens

    async def collect(self):
        """Drain the whole stream; returns (token_list, finish_reason)."""
        toks = []
        async for t in self.tokens():
            toks.append(t)
        return toks, self.finish_reason

    def abort(self):
        """Cancel this request on whichever replica currently serves it
        (client disconnect). Safe after finish."""
        if self._abort is not None and not self.finished:
            self._abort()


class _RouteCtx:
    """Per-request routing context threaded through admission, replay,
    and deadline accounting."""

    def __init__(self, prompt_ids, kwargs, deadline_s, key, arrival):
        self.prompt_ids = prompt_ids
        self.kwargs = kwargs            # replica submit kwargs (no timeout)
        self.deadline_s = deadline_s    # the ORIGINAL end-to-end deadline
        self.key = key
        self.arrival = arrival
        self.tried = set()              # replica names tried this round
        self.budget_used = 0
        self.last_error = None
        self.current = None             # (replica, inner RequestStream)
        self.aborted = False

    def remaining(self, now):
        """Deadline left from the router's own arrival clock — what a
        re-routed hop may still spend (satellite: SLO verdicts stay
        truthful across hops)."""
        if self.deadline_s is None:
            return None
        return self.deadline_s - (now - self.arrival)


class ReplicaRouter:
    def __init__(self, replicas, *, factory=None, affinity=True,
                 affinity_prefix_blocks=1, retry_budget=3,
                 backoff_base_s=0.05, backoff_max_s=2.0,
                 probe_interval_s=1.0, probe_max_interval_s=30.0,
                 probe_timeout_s=10.0, sweep_interval_s=0.05,
                 poison_source_threshold=3, service_time_init_s=None,
                 default_timeout_s=None, seed=0, migrate_on_drain=True):
        """`replicas` is a list of `AsyncLLMEngine`s (bare `LLMEngine`s
        are wrapped with frontend defaults); all must share `block_size`
        — the affinity key is a block hash, and a fleet that chunks
        prompts differently has no shared key space. `factory(index)`
        (optional) builds a replacement engine for probe-recovery
        restarts and rolling drains."""
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.factory = factory
        self.affinity = bool(affinity)
        self.affinity_prefix_blocks = max(1, int(affinity_prefix_blocks))
        self.retry_budget = max(0, int(retry_budget))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_max_interval_s = float(probe_max_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.sweep_interval_s = float(sweep_interval_s)
        self.poison_source_threshold = max(2, int(poison_source_threshold))
        self.service_time_init_s = service_time_init_s
        self.default_timeout_s = default_timeout_s
        # host-tier KV migration (serving/kv_tier.py): on a restart-drain
        # or ejection, carry the outgoing engine's warm prefix blocks to
        # a live replica so affinity remaps stay zero-rewarm. A no-op on
        # tierless engines (export returns None).
        self.migrate_on_drain = bool(migrate_on_drain)
        self.metrics = ServingMetrics()
        self._rng = random.Random(seed)   # backoff jitter (reproducible)
        self._replicas = [Replica(f"r{i}", self._wrap(e), i)
                          for i, e in enumerate(replicas)]
        sizes = {r.engine.engine.block_size for r in self._replicas}
        if len(sizes) != 1:
            raise ValueError(
                f"replicas must share one block_size (saw {sorted(sizes)}) "
                "— the prefix-affinity key is a block content hash"
            )
        self._block_size = sizes.pop()
        self._events = deque(maxlen=256)  # lifecycle log for /debug/router
        self._closed = False
        self._started = False
        self._sweep_task = None
        self._probe_tasks = set()
        self._forward_tasks = set()

    @staticmethod
    def _wrap(eng):
        from .engine import LLMEngine
        from .frontend import AsyncLLMEngine

        if isinstance(eng, AsyncLLMEngine):
            return eng
        if isinstance(eng, LLMEngine):
            return AsyncLLMEngine(eng)
        raise TypeError(
            f"replica must be an AsyncLLMEngine or LLMEngine, "
            f"got {type(eng).__name__}"
        )

    # -- lifecycle ---------------------------------------------------------

    @property
    def replicas(self):
        """The replica records, routing order (read-only view)."""
        return tuple(self._replicas)

    async def start(self):
        """Start every replica engine and the health sweep."""
        if self._started:
            return self
        for r in self._replicas:
            if not r.engine.started:
                await r.engine.start()
        self._started = True
        self._sweep_task = asyncio.ensure_future(self._sweep_loop())
        self._update_gauges()
        return self

    def stop_admitting(self):
        """Router-level drain: new submissions raise EngineClosedError
        while in-flight streams run to completion."""
        self._closed = True

    async def shutdown(self, drain=True, timeout_s=30.0):
        """Stop admitting, cancel sweeps/probes, shut every replica down
        (each engine's own drain semantics), and reap forwarding tasks."""
        self._closed = True
        if self._sweep_task is not None:
            self._sweep_task.cancel()
            try:
                await self._sweep_task
            except asyncio.CancelledError:
                pass
            self._sweep_task = None
        for t in list(self._probe_tasks):
            t.cancel()
        if self._probe_tasks:
            await asyncio.gather(*self._probe_tasks, return_exceptions=True)
        for r in self._replicas:
            try:
                await r.engine.shutdown(drain=drain, timeout_s=timeout_s)
            except Exception:  # noqa: BLE001 — a wedged replica must not
                pass               # block the rest of the fleet's shutdown
        if self._forward_tasks:
            # replica shutdown terminated every inner stream, so the
            # forwarders finish on their own; the wait is a backstop
            await asyncio.wait(list(self._forward_tasks), timeout=5.0)
            for t in list(self._forward_tasks):
                t.cancel()

    # -- routing -----------------------------------------------------------

    def affinity_key(self, prompt_ids, adapter=None):
        """This request's affinity key (a chained block hash,
        ``affinity_prefix_blocks`` deep) or None for cache-cold prompts
        shorter than one full block. Keyed by ``(adapter, prefix)`` via
        the same hash salt the replicas' prefix caches use: the same
        prompt under two adapters caches DIFFERENT KV blocks, so homing
        them together would warm nothing."""
        hashes = chain_block_hashes(prompt_ids, self._block_size,
                                    salt=adapter)
        if not hashes:
            return None
        return hashes[min(self.affinity_prefix_blocks, len(hashes)) - 1]

    def home_replica(self, prompt_ids, adapter=None):
        """The replica name this request would route to right now (None
        when nothing is eligible) — debugging/test surface."""
        now = time.monotonic()
        elig = self._eligible(set(), now)
        if not elig:
            return None
        key = self.affinity_key(prompt_ids, adapter)
        if self.affinity and key is not None:
            return self._rendezvous(key, elig).name
        return self._least_loaded(elig).name

    def _eligible(self, tried, now):
        return [r for r in self._replicas
                if r.state == ACTIVE and r.name not in tried
                and now >= r.not_before]

    @staticmethod
    def _rendezvous(key, candidates):
        """Highest-random-weight pick: each replica scores
        sha256(key || name); the max wins. Removing a replica moves only
        ITS keys (everyone else's top score is unchanged), so an
        ejection never cold-starts the survivors' caches."""
        best, best_score = None, b""
        for r in candidates:
            score = hashlib.sha256(key + r.name.encode()).digest()
            if best is None or score > best_score:
                best, best_score = r, score
        return best

    def _least_loaded(self, candidates):
        return min(candidates,
                   key=lambda r: (self._predicted_wait(r),
                                  r.engine.inflight, r.index))

    def _predicted_wait(self, replica):
        """Coarse queue-wait estimate for a NEW request on `replica`:
        requests ahead of a free lane × EWMA service time / lanes. Zero
        until a service time is known (never early-reject blind)."""
        svc = replica.ewma_service_s
        if svc is None:
            svc = self.service_time_init_s
        if svc is None:
            return 0.0
        slots = max(1, replica.engine.engine.max_batch)
        ahead = max(0, replica.engine.inflight + 1 - slots)
        return ahead * svc / slots

    def _note_service(self, replica, seconds):
        replica.ewma_service_s = (
            seconds if replica.ewma_service_s is None
            else 0.7 * replica.ewma_service_s + 0.3 * seconds)

    def _pick(self, ctx, now, rem):
        """One routing decision: (replica, "affinity"|"load") or
        (None, None) when nothing is eligible. Raises the early-reject
        error when even the best replica's predicted wait blows the
        remaining deadline."""
        elig = self._eligible(ctx.tried, now)
        if not elig:
            return None, None
        if self.affinity and ctx.key is not None:
            pick, how = self._rendezvous(ctx.key, elig), "affinity"
        else:
            pick, how = self._least_loaded(elig), "load"
        if rem is not None and self._predicted_wait(pick) > rem:
            alt = self._least_loaded(elig)
            wait = self._predicted_wait(alt)
            if wait > rem:
                # reject-early beats miss-SLO (the Gemma serving
                # comparison): nobody can serve this inside its deadline
                self.metrics.inc("router_early_rejections")
                raise EngineOverloadedError(
                    f"predicted queue wait {wait:.3f}s on the best "
                    f"replica exceeds the remaining deadline {rem:.3f}s",
                    reason="deadline_unattainable", retry_after_s=wait,
                )
            if alt is not pick:
                self.metrics.inc("router_affinity_diverted")
                pick, how = alt, "load"
        return pick, how

    # -- admission (retry-elsewhere) ----------------------------------------

    async def _admit(self, ctx):
        """Admit `ctx` somewhere: try eligible replicas immediately in
        routing order; when every one has rejected, burn one unit of the
        retry budget on a jittered exponential backoff (honoring each
        replica's Retry-After via `not_before`) and go again. Raises the
        last admission error once the budget (or the deadline) is
        exhausted."""
        while True:
            now = time.monotonic()
            rem = ctx.remaining(now)
            if rem is not None and rem <= 0.0:
                self.metrics.inc("router_early_rejections")
                raise EngineOverloadedError(
                    "deadline exhausted before admission",
                    reason="deadline_unattainable", retry_after_s=None,
                )
            pick, how = self._pick(ctx, now, rem)
            if pick is not None:
                try:
                    st = pick.engine.submit(
                        ctx.prompt_ids,
                        timeout_s=(rem if ctx.deadline_s is not None
                                   else self.default_timeout_s),
                        **ctx.kwargs)
                except EngineOverloadedError as e:
                    ctx.tried.add(pick.name)
                    ctx.last_error = e
                    pick.not_before = now + (e.retry_after_s
                                             or self.backoff_base_s)
                    self.metrics.inc("router_admission_rejects")
                except EngineClosedError as e:
                    ctx.tried.add(pick.name)
                    ctx.last_error = e
                    self._observe_closed(pick, e, now)
                else:
                    self.metrics.inc(f"router_routed_{how}")
                    self.metrics.inc_labeled(
                        "router_replica_requests",
                        {"replica": pick.name, "route": how})
                    return pick, st
                continue   # retry-elsewhere: next replica, no sleep
            # every eligible replica rejected (or none is eligible):
            # one backoff round costs one unit of the retry budget
            ctx.budget_used += 1
            if ctx.budget_used > self.retry_budget:
                if ctx.last_error is not None:
                    raise ctx.last_error
                raise EngineClosedError(
                    "no healthy replica in rotation",
                    reason="no_replica", retry_after_s=self.backoff_max_s,
                )
            self.metrics.inc("router_retries")
            delay = min(self.backoff_max_s,
                        self.backoff_base_s * (2 ** (ctx.budget_used - 1)))
            delay *= 0.5 + 0.5 * self._rng.random()   # jitter
            if rem is not None:
                delay = min(delay, max(rem, 0.0))
            await asyncio.sleep(delay)
            ctx.tried.clear()

    def _observe_closed(self, replica, exc, now):
        reason = getattr(exc, "reason", "draining")
        if reason in ("unhealthy", "engine_dead"):
            self._eject(replica, f"submit:{reason}", now)
        else:
            # draining: route around without ejecting (planned exit)
            if replica.state == ACTIVE and not replica.router_draining:
                replica.state = DRAINING
                self._update_gauges()
            ra = getattr(exc, "retry_after_s", None)
            if ra:
                replica.not_before = now + ra

    # -- the public request surface -----------------------------------------

    async def submit(self, prompt_ids, max_new_tokens=16, temperature=0.0,
                     eos_token_id=None, deadline_s=None, timeout_s=None,
                     request_id=None, top_k=None, top_p=None,
                     spec_decoding=None, num_spec_tokens=None, trace=None,
                     tenant=None, priority=None, adapter=None):
        """Route one request; returns its `RoutedStream` after the first
        successful replica admission. Raises `EngineOverloadedError`
        (all replicas overloaded past the retry budget, or
        ``deadline_unattainable``) / `EngineClosedError` (router
        draining, no healthy replica) / `ValueError` (bad request) —
        the same admission contract as `AsyncLLMEngine.submit`, so the
        HTTP layer maps errors identically. ``deadline_s`` (alias
        ``timeout_s``) is end-to-end across hops: a replayed request
        carries only its REMAINING deadline. ``tenant``/``priority``
        stamp through to the serving replica unchanged; ``adapter``
        names a LoRA adapter loaded on the replicas and keys prefix
        affinity alongside the prompt."""
        if not self._started:
            raise RuntimeError("ReplicaRouter.start() has not been awaited")
        if self._closed:
            raise EngineClosedError(
                "router is draining; not admitting",
                reason="draining", retry_after_s=5.0,
            )
        if deadline_s is None:
            deadline_s = timeout_s
        prompt_ids = [int(t) for t in prompt_ids]
        ctx = _RouteCtx(
            prompt_ids,
            dict(max_new_tokens=max_new_tokens, temperature=temperature,
                 eos_token_id=eos_token_id, request_id=request_id,
                 top_k=top_k, top_p=top_p, spec_decoding=spec_decoding,
                 num_spec_tokens=num_spec_tokens, trace=trace,
                 tenant=tenant, priority=priority, adapter=adapter),
            deadline_s,
            (self.affinity_key(prompt_ids, adapter)
             if self.affinity else None),
            time.monotonic(),
        )
        self.metrics.inc("router_requests")
        replica, st = await self._admit(ctx)
        rs = RoutedStream()
        rs.request_id = st.request_id
        rs.replica = replica.name
        rs.req = st.req
        ctx.current = (replica, st)
        rs._abort = lambda: self._abort_current(ctx)
        task = asyncio.ensure_future(
            self._forward(rs, replica, replica.engine, st, ctx))
        self._forward_tasks.add(task)
        task.add_done_callback(self._forward_tasks.discard)
        return rs

    async def generate(self, prompt_ids, **kwargs):
        """Non-streaming convenience: (token_list, finish_reason)."""
        rs = await self.submit(prompt_ids, **kwargs)
        return await rs.collect()

    def _abort_current(self, ctx):
        ctx.aborted = True
        if ctx.current is not None:
            replica, st = ctx.current
            replica.engine.abort(st.request_id)

    # -- stream forwarding + safe retry --------------------------------------

    async def _forward(self, rs, replica, hop_engine, st, ctx):
        """Pump the replica stream into `rs`; on a replica-attributed
        failure with zero delivered tokens, replay elsewhere (safe-retry
        rule); otherwise deliver exactly one terminal event.
        `hop_engine` is the engine that admitted THIS hop — attribution
        must consult it, never `replica.engine`, which a concurrent
        restart may already have swapped for a fresh (healthy) one."""
        try:
            while True:
                async for tok in st:
                    rs.n_tokens += 1
                    rs.queue.put_nowait(tok)
                reason, error = st.finish_reason, st.error
                rs.req = st.req
                now = time.monotonic()
                replica_fault = False
                if reason in ("length", "stop"):
                    # SERVICE time: first lane admission -> finish on the
                    # serving replica. Not router sojourn — backoff
                    # rounds, failed hops, and queue wait belong to the
                    # predicted-wait queue-depth term, and folding them
                    # into the EWMA would compound under load into
                    # spurious deadline_unattainable rejections
                    req = st.req
                    t0 = (req.admit_time if req.admit_time is not None
                          else req.arrival_time)
                    self._note_service(replica, now - t0)
                    self.metrics.inc("router_requests_completed")
                elif reason == "error":
                    state, _ = hop_engine.healthz_state()
                    # replica-attributed ONLY when the replica left
                    # rotation (thread death, watchdog trip, wedge) —
                    # an error on a still-serving replica (healthz ok OR
                    # merely draining) is the REQUEST's own failure
                    # (poison isolation, non-finite row) and must never
                    # eject the replica or poison a second one
                    replica_fault = state in ("unhealthy", "engine_dead")
                    if replica_fault:
                        self._eject(replica, f"stream_error:{state}", now)
                elif reason == "cancelled" and not ctx.aborted:
                    # the ENGINE cancelled on its own (hard drain /
                    # forced restart) — the client never asked: replica-
                    # attributed by construction, but not a health event
                    # (the drain machinery owns the state), so replay
                    # without ejecting
                    replica_fault = True
                if (replica_fault and rs.n_tokens == 0 and not ctx.aborted
                        and ctx.budget_used < self.retry_budget):
                    # safe retry: nothing was delivered, so a replay
                    # elsewhere is a seamless stream — carrying only the
                    # REMAINING deadline
                    ctx.budget_used += 1
                    ctx.tried.add(replica.name)
                    self.metrics.inc("router_replays")
                    rs.replays += 1
                    try:
                        replica, st = await self._admit(ctx)
                    except (EngineClosedError, EngineOverloadedError) as e:
                        self.metrics.inc("router_requests_failed")
                        self._terminal(
                            rs, "error",
                            f"replay failed after replica fault: {e}")
                        return
                    hop_engine = replica.engine
                    ctx.current = (replica, st)
                    rs.replica = replica.name
                    rs.req = st.req
                    if ctx.aborted:
                        # the client went away while the replay was
                        # backing off — don't serve it blind
                        replica.engine.abort(st.request_id)
                    continue
                if reason == "error":
                    if replica_fault and rs.n_tokens > 0:
                        # mid-stream victim: replaying could fork the
                        # already-delivered token stream — fail it with
                        # ONE structured terminal error instead
                        self.metrics.inc("router_midstream_errors")
                    self.metrics.inc("router_requests_failed")
                self._terminal(rs, reason, error)
                return
        except asyncio.CancelledError:
            self._terminal(rs, "cancelled", None)
            raise
        except Exception as e:  # noqa: BLE001 — the terminal event must
            # never be lost, whatever the forwarding loop tripped on
            self.metrics.inc("router_requests_failed")
            self._terminal(rs, "error",
                           f"router: {type(e).__name__}: {e}")

    def _terminal(self, rs, reason, error):
        rs.terminal_events += 1
        if rs.finished:
            return
        # a finished stream's abort is a no-op: drop the routing context
        # it closes over, so a kept stream never keeps a retired replica
        # (and its card memory) alive
        rs._abort = None
        rs.finished = True
        rs.finish_reason = reason
        rs.error = error
        rs.queue.put_nowait(_END)
        rs.done.set()

    # -- ejection / half-open probes ----------------------------------------

    def _log_event(self, replica, event, reason=None):
        self._events.append({
            "t": round(time.monotonic(), 3), "replica": replica.name,
            "event": event, "reason": reason,
        })
        self.metrics.inc_labeled(
            "router_replica_events",
            {"replica": replica.name, "event": event})

    def _eject(self, replica, reason, now):
        if replica.state in (EJECTED, PROBING):
            return
        replica.state = EJECTED
        replica.eject_reason = reason
        replica.probe_failures = 0
        replica.next_probe_at = now + self.probe_interval_s
        self.metrics.inc("router_ejections")
        self._log_event(replica, "eject", reason)
        if self.migrate_on_drain:
            # salvage the victim's SETTLED host-tier blocks for the
            # replicas its affinity keys remap to. demote=False: an
            # ejected replica is NOT quiescent (its engine thread may be
            # mid-step or dead), so only lock-protected host slabs are
            # read — never the device arena. Fire-and-forget task:
            # ejection must never wait on a sick replica's host copies.
            try:
                t = asyncio.ensure_future(self._migrate_from(replica))
                self._probe_tasks.add(t)
                t.add_done_callback(self._probe_tasks.discard)
            except RuntimeError:
                pass   # no running loop (unit-level sweep): skip salvage
        self._update_gauges()

    async def _migrate_from(self, replica):
        """Best-effort salvage of an ejected replica's host tier into
        every live replica (they share the remapped affinity keys)."""
        try:
            payload = await asyncio.to_thread(
                replica.engine.engine.export_kv_tier, demote=False)
        except Exception:  # noqa: BLE001 — sick replica, nothing to save
            return
        if not payload or not payload["entries"]:
            return
        n = 0
        for r in self._replicas:
            if r is replica or r.state not in (ACTIVE, DRAINING):
                continue
            try:
                n += await self._import_into(r.engine, payload)
            except Exception:  # noqa: BLE001 — per-destination best-effort
                continue
        if n:
            self.metrics.inc("router_migrations")
            self.metrics.inc("router_migrated_blocks", n)
            self._log_event(replica, "migrate", f"{n} blocks salvaged")

    async def _import_into(self, fe, payload):
        """Import a host-tier payload into the live replica `fe` (an
        `AsyncLLMEngine`) on its own engine thread."""
        eng = fe.engine
        return await fe.call(lambda: eng.import_kv_tier(payload),
                             timeout_s=self.probe_timeout_s)

    async def _export_from(self, fe):
        """A drained replica's host tier with its device-cached prefixes
        demoted first, on its own engine thread (it is quiescent; a
        wedged one times out and loses its cache)."""
        eng = fe.engine
        return await fe.call(lambda: eng.export_kv_tier(demote=True),
                             timeout_s=self.probe_timeout_s)

    @staticmethod
    def engine_lifecycle(replica):
        """The replica engine's lifecycle word, or None (test doubles
        without one)."""
        fn = getattr(replica.engine, "lifecycle_state", None)
        return None if fn is None else fn()

    async def _sweep_loop(self):
        while True:
            await asyncio.sleep(self.sweep_interval_s)
            self._sweep_once(time.monotonic())

    def _sweep_once(self, now):
        """One health pass: observe every replica's healthz word and
        poison window, eject/adjust accordingly, and launch half-open
        probes for ejected replicas whose backoff expired."""
        for r in self._replicas:
            if r.state in (ACTIVE, DRAINING):
                state, info = r.engine.healthz_state()
                if state in ("unhealthy", "engine_dead"):
                    why = info.get("reason") if isinstance(info, dict) \
                        else None
                    self._eject(
                        r, f"healthz:{state}" + (f":{why}" if why else ""),
                        now)
                    continue
                stats = r.engine.supervisor.poison_stats()
                if stats["distinct_sources"] >= self.poison_source_threshold:
                    # poison attributions across several unrelated
                    # sources = the card, not the requests, is sick
                    self._eject(
                        r, f"poison_rate:{stats['distinct_sources']}"
                           "_sources", now)
                    continue
                if not r.router_draining:
                    observed = DRAINING if state == "draining" else ACTIVE
                    if observed != r.state:
                        r.state = observed
                        self._update_gauges()
            elif r.state == EJECTED and now >= r.next_probe_at:
                r.state = PROBING
                self._update_gauges()
                task = asyncio.ensure_future(self._probe(r))
                self._probe_tasks.add(task)
                task.add_done_callback(self._probe_tasks.discard)

    async def _probe(self, replica):
        """Half-open re-admission: restart a sticky-unhealthy/dead
        replica through the factory (if any), then prove it serves with
        ONE trial request. Pass → back in rotation; fail → ejected with
        exponential probe backoff. A replica still being BORN — lifecycle
        cold/loading/warm, i.e. streaming its weights or capturing its
        step programs — is never probed with traffic: the trial would
        time out against that latency and punish the replica with
        exponential backoff for being mid-birth. It is deferred at the
        base probe interval (no failure counted) until its lifecycle
        reaches serving/draining/stopped, then probed normally."""
        lc = self.engine_lifecycle(replica)
        if lc in ("cold", "loading", "warm"):
            replica.state = EJECTED
            replica.next_probe_at = time.monotonic() + self.probe_interval_s
            self.metrics.inc("router_probe_deferrals")
            self._log_event(replica, "probe_deferred", f"lifecycle:{lc}")
            self._update_gauges()
            return
        self.metrics.inc("router_probes")
        ok = False
        try:
            state, _ = replica.engine.healthz_state()
            # a poison-rate-ejected replica still reports healthz "ok"
            # and would pass the trivial trial below — the probe must
            # hold it out while the poison evidence is fresh (the window
            # slides, so a genuinely recovered card re-admits once it
            # drains), or restart it outright when a factory exists
            poisoned = (replica.engine.supervisor.poison_stats()
                        ["distinct_sources"]
                        >= self.poison_source_threshold)
            if (state != "ok" or poisoned) and self.factory is not None:
                await self._restart(replica)
                state, _ = replica.engine.healthz_state()
                poisoned = False       # fresh engine, fresh window
            if state == "ok" and not poisoned:
                st = replica.engine.submit(
                    [0], max_new_tokens=1, temperature=0.0,
                    timeout_s=self.probe_timeout_s)
                _, reason = await asyncio.wait_for(
                    st.collect(), self.probe_timeout_s + 5.0)
                ok = reason in ("length", "stop")
        except asyncio.CancelledError:
            replica.state = EJECTED
            raise
        except Exception:  # noqa: BLE001 — a failing probe is the
            ok = False         # expected outcome, not a router bug
        now = time.monotonic()
        if ok:
            replica.state = ACTIVE
            replica.eject_reason = None
            replica.probe_failures = 0
            replica.not_before = 0.0
            self.metrics.inc("router_readmissions")
            self._log_event(replica, "readmit")
        else:
            replica.probe_failures += 1
            replica.state = EJECTED
            replica.next_probe_at = now + min(
                self.probe_max_interval_s,
                self.probe_interval_s * (2 ** replica.probe_failures))
        self._update_gauges()

    async def _restart(self, replica):
        """Replace a replica's engine via the factory (probe recovery,
        rolling drain). The FRESH engine is swapped in before the old
        one is torn down: a draining replica stays sweep-visible through
        its restart, and the sweep observing the old engine's corpse
        mid-teardown would eject a replica that is about to be healthy.
        The old engine gets a hard shutdown — its streams were already
        drained or failed over."""
        old = replica.engine
        # off the event loop: a factory that streams a checkpoint and
        # captures CUDA graphs must not stall the other replicas' streams
        fresh = self._wrap(await asyncio.to_thread(self.factory,
                                                   replica.index))
        replica.engine = await fresh.start()
        replica.restarts += 1
        replica.ewma_service_s = None
        self.metrics.inc("router_restarts")
        self._log_event(replica, "restart")
        if self.migrate_on_drain:
            # zero-rewarm handoff (serving/kv_tier.py): the old engine is
            # drained (inflight 0, step loop idle-polling), so demoting
            # its device-cached blocks into its host tier and importing
            # them into the fresh engine is race-free. Each side on its
            # own engine thread; best-effort — a wedged old engine loses
            # its cache, never the restart.
            try:
                payload = await self._export_from(old)
                n = await self._import_into(replica.engine, payload)
                if n:
                    self.metrics.inc("router_migrations")
                    self.metrics.inc("router_migrated_blocks", n)
                    self._log_event(replica, "migrate", f"{n} blocks")
            except Exception as e:  # noqa: BLE001 — cache carryover is
                self._log_event(       # an optimization, never a gate
                    replica, "migrate_failed", f"{type(e).__name__}: {e}")
        try:
            await old.shutdown(drain=False, timeout_s=self.probe_timeout_s)
        except Exception:  # noqa: BLE001 — a wedged old engine is
            pass               # exactly why we are replacing it

    # -- rolling drain -------------------------------------------------------

    async def rolling_drain(self, drain_timeout_s=60.0, restart=None):
        """Zero-downtime restart: ONE replica at a time, stop routing to
        it, close its own admission, wait for its in-flight count to
        reach zero, then restart it via the factory (default when one is
        configured) or reopen admission, and put it back in rotation
        before touching the next. Returns the drained replica names."""
        if restart is None:
            restart = self.factory is not None
        drained = []
        for r in list(self._replicas):
            if r.state != ACTIVE:
                continue
            r.router_draining = True
            r.state = DRAINING
            r.engine.stop_admitting()
            self.metrics.inc("router_drains")
            self._log_event(r, "drain")
            self._update_gauges()
            try:
                t0 = time.monotonic()
                while (r.engine.inflight > 0
                       and time.monotonic() - t0 < drain_timeout_s):
                    await asyncio.sleep(0.02)
                if r.engine.inflight > 0:
                    # stragglers past the bound get hard-aborted by the
                    # restart; their zero-token streams replay elsewhere
                    # (engine-initiated cancel, _forward's safe-retry)
                    self._log_event(r, "drain_timeout",
                                    f"{r.engine.inflight} in flight")
                if restart and self.factory is not None:
                    await self._restart(r)
                else:
                    r.engine.resume_admitting()
                drained.append(r.name)
            except Exception as e:  # noqa: BLE001 — the replica broke
                # mid-drain (watchdog trip, thread death, factory
                # failure): hand it to the sweep/probe machinery and
                # keep draining the REST of the fleet
                self._log_event(r, "drain_failed",
                                f"{type(e).__name__}: {e}")
            finally:
                # never leak router_draining: it suppresses the sweep's
                # state resync for this replica forever
                r.router_draining = False
                if r.state == DRAINING:
                    r.state = ACTIVE
                self._update_gauges()
        return drained

    # -- elastic fleet (serving/autoscale.py drives these) -------------------

    def next_index(self):
        """The next free replica index — what the autoscaler passes to
        the factory for a spawn. Indices are never reused within a
        router's life, so a replica's name stays unambiguous in the
        event log across scale-up/-down cycles."""
        return max((r.index for r in self._replicas), default=-1) + 1

    async def add_replica(self, engine, name=None, index=None):
        """Scale-up: wrap + start `engine` and put it in rotation.
        The engine should arrive warm (the factory path: streamed
        checkpoint load + warmup wave), so `start()` is the only latency
        between this call and the replica taking traffic. Returns the
        new `Replica`."""
        if index is None:
            index = self.next_index()
        r = Replica(name or f"r{index}", self._wrap(engine), index)
        bs = r.engine.engine.block_size
        if bs != self._block_size:
            raise ValueError(
                f"new replica block_size {bs} != fleet {self._block_size}"
                " — the prefix-affinity key space must stay shared")
        if not r.engine.started:
            await r.engine.start()
        self._replicas.append(r)
        self.metrics.inc("router_scale_ups")
        self._log_event(r, "add")
        self._update_gauges()
        return r

    async def retire_replica(self, replica=None, drain_timeout_s=60.0):
        """Scale-down: drain ONE replica out of rotation for good — stop
        routing to it, close its admission, wait for in-flight zero
        (bounded by `drain_timeout_s`), hand its warm host-tier KV blocks
        to the survivors (``migrate_on_drain``: the drained engine is
        quiescent, so ``demote=True`` carries device-cached prefixes too
        — scale-down is zero-rewarm), remove it, and shut it down.
        `replica` may be a `Replica`, a name, or None (the highest-index
        active replica). Refuses to retire the last active replica.
        Returns the retired replica's name."""
        if isinstance(replica, str):
            name = replica
            replica = next((r for r in self._replicas if r.name == name),
                           None)
            if replica is None:
                raise ValueError(f"no replica named {name!r}")
        active = [r for r in self._replicas if r.state == ACTIVE]
        if replica is None:
            replica = max(active, key=lambda r: r.index, default=None)
        if replica is None or replica not in self._replicas:
            raise ValueError("no replica eligible to retire")
        if not [r for r in active if r is not replica]:
            raise ValueError(
                "cannot retire the last active replica — the fleet would "
                "stop serving (lower autoscale min_replicas instead?)")
        replica.router_draining = True
        replica.state = DRAINING
        replica.engine.stop_admitting()
        self.metrics.inc("router_drains")
        self._log_event(replica, "retire")
        self._update_gauges()
        t0 = time.monotonic()
        while (replica.engine.inflight > 0
               and time.monotonic() - t0 < drain_timeout_s):
            await asyncio.sleep(0.02)
        if self.migrate_on_drain:
            try:
                payload = await self._export_from(replica.engine)
                n = 0
                if payload and payload["entries"]:
                    for r in self._replicas:
                        if r is replica or r.state not in (ACTIVE,
                                                           DRAINING):
                            continue
                        n += await self._import_into(r.engine, payload)
                if n:
                    self.metrics.inc("router_migrations")
                    self.metrics.inc("router_migrated_blocks", n)
                    self._log_event(replica, "migrate", f"{n} blocks")
            except Exception as e:  # noqa: BLE001 — cache carryover is
                self._log_event(       # an optimization, never a gate
                    replica, "migrate_failed", f"{type(e).__name__}: {e}")
        # out of the fleet before its engine stops: a health sweep that saw
        # the stopped engine would eject the replica and start a salvage
        # task holding its engine (and card memory) past this return
        self._replicas.remove(replica)
        try:
            await replica.engine.shutdown(drain=True,
                                          timeout_s=drain_timeout_s)
        except Exception:  # noqa: BLE001 — a wedged replica must not
            pass               # survive scale-down by being wedged
        self.metrics.inc("router_scale_downs")
        self._log_event(replica, "remove")
        self._update_gauges()
        return replica.name

    # -- observability -------------------------------------------------------

    def _update_gauges(self):
        counts = {ACTIVE: 0, DRAINING: 0, EJECTED: 0, PROBING: 0}
        inflight = 0
        for r in self._replicas:
            counts[r.state] += 1
            inflight += r.engine.inflight
        m = self.metrics
        m.set_gauge("router_replicas_active", counts[ACTIVE])
        m.set_gauge("router_replicas_draining", counts[DRAINING])
        m.set_gauge("router_replicas_ejected", counts[EJECTED])
        m.set_gauge("router_replicas_probing", counts[PROBING])
        m.set_gauge("router_inflight", inflight)

    def refresh_metrics(self):
        """Scrape-time gauge refresh: replica-state counts, fleet
        in-flight, and the fleet-aggregate prefix-cache hit rate (the
        number the affinity policy exists to protect under fan-out)."""
        self._update_gauges()
        hit = lookup = 0.0
        for r in self._replicas:
            c = r.engine.engine.metrics.counters
            hit += c.get("prefix_cache_hit_tokens", 0)
            lookup += c.get("prefix_cache_lookup_tokens", 0)
        if lookup:
            self.metrics.set_gauge("router_prefix_cache_hit_rate",
                                   hit / lookup)

    def snapshot(self):
        """JSON-able fleet view for ``/healthz`` and ``/debug/router``:
        per-replica state machine + healthz word, recent lifecycle
        events, and the routing knobs."""
        return {
            "replicas": [r.snapshot() for r in self._replicas],
            "events": list(self._events),
            "affinity": self.affinity,
            "affinity_prefix_blocks": self.affinity_prefix_blocks,
            "retry_budget": self.retry_budget,
            "probe_interval_s": self.probe_interval_s,
            "poison_source_threshold": self.poison_source_threshold,
        }
