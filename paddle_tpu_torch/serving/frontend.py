"""AsyncLLMEngine: the asyncio frontend over the synchronous LLMEngine.

The engine step loop (graph-replayed device steps + host-side scheduling)
runs in ONE background thread that owns the engine outright; the asyncio
side never touches the scheduler. On a CUDA engine that thread enters the
engine's device and the stream its step programs stage and replay on
(`LLMEngine.device_scope`): PyTorch's current device and stream are per
thread, and the graphs `warmup()` captured on the constructing thread
replay from this one. The two sides talk through

- a thread-safe **command queue** into the engine thread (`add`, `abort`,
  `stop`) drained between steps, so every scheduler mutation happens on the
  engine thread — continuous batching needs no locks; and
- `loop.call_soon_threadsafe` **event dispatch** out of it: each step's
  tokens fan out to per-request bounded `asyncio.Queue`s on the event loop.

Backpressure is lossless and never reaches the scheduler: when a consumer
falls behind and its queue fills, the producer stops enqueueing for that
stream (sticky `overflow`, counted in `backpressure_drops`) instead of
blocking — the authoritative token record is the request's own
`output_ids`, so the consumer drains the queue's ordered prefix and then
catches up by index. A stalled client can therefore never stall the step
loop or any other request's stream.

Robustness contract (tested in tests/test_serving_frontend.py):

- **admission control** — at most ``engine.max_batch + max_waiting``
  requests in flight; beyond that `submit` raises `EngineOverloadedError`
  (HTTP 429 in serving/server.py) instead of queueing unboundedly;
- **deadlines** — a per-request ``timeout_s`` aborts in-flight work from
  the engine thread (KV blocks freed mid-generation, stream finishes with
  ``finish_reason="timeout"``);
- **cancellation** — `abort()` (wired to client disconnects by the server)
  propagates into `LLMEngine.abort`, which removes the request from the
  scheduler in any state and returns its blocks to the pool;
- **graceful drain** — `shutdown(drain=True)` stops admitting, lets
  in-flight requests finish (or hard-aborts them after ``timeout_s``),
  then exits the engine thread;
- **fault tolerance** (serving/supervisor.py, tests/test_serving_chaos.py)
  — every `eng.step()` runs under `EngineSupervisor`: a raising step is
  bisected down to the one poisoned request (everyone else recomputes and
  completes token-identically), non-finite logits abort only their row,
  an exception escaping the loop itself runs the crash-safe exit
  (``try/finally``: every live stream gets a terminal ``error`` event,
  the engine marks unhealthy, later `submit` fails fast), a dead engine
  thread is detected AT `submit` (`EngineClosedError(reason=
  "engine_dead")` — never an enqueue into a queue nobody drains), and an
  optional `StepWatchdog` (``watchdog_step_timeout_s``) turns a stuck
  device step into a 503 ``/healthz`` + structured stream errors instead
  of silence.
"""
from __future__ import annotations

import asyncio
import logging
import queue
import threading
import time

from . import faults
from .faults import FaultInjected
from .supervisor import EngineHealth, EngineSupervisor, StepWatchdog

_log = logging.getLogger("paddle_tpu_torch.serving.frontend")

_END = "__end__"
# no-op queue sentinel: flipping a stream into catch-up mode must WAKE a
# consumer already parked on queue.get() (the organic overflow flip in
# _push_token can never race a parked consumer — the queue is full there
# — but the post-recovery catchup flip can)
_SYNC = "__sync__"


class EngineOverloadedError(RuntimeError):
    """Admission rejected on a FULL resource — retry later (HTTP 429).
    ``reason`` says which resource: ``queue_full`` (the bounded wait
    queue) or ``kv_capacity`` (the worst-case KV commitment gate);
    ``retry_after_s`` feeds the Retry-After header."""

    def __init__(self, message, reason="queue_full", retry_after_s=1.0):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


class EngineClosedError(RuntimeError):
    """No new admissions (HTTP 503). ``reason`` distinguishes the LB
    action: ``draining`` (planned — come back after the deploy),
    ``unhealthy`` (watchdog/supervisor tripped — pull the replica), or
    ``engine_dead`` (the engine thread is gone — pull the replica)."""

    def __init__(self, message, reason="draining", retry_after_s=None):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


class RequestStream:
    """One request's async token stream (``async for tok in stream``).

    Tokens arrive through a bounded queue; if the consumer lags until the
    queue fills, delivery switches to catch-up reads from the request's
    `output_ids` (see module docstring) — order-exact, nothing dropped,
    nothing duplicated. After iteration ends, `finish_reason` is one of
    ``"length" | "stop" | "timeout" | "cancelled" | "error"`` (``error``
    carries detail in `error`).
    """

    def __init__(self, request_id, req, maxsize):
        self.request_id = request_id
        self.req = req                    # engine Request: output_ids is
        self.queue = asyncio.Queue(maxsize)  # the authoritative record
        self.wake = asyncio.Event()
        self.done = asyncio.Event()
        self.overflow = False             # sticky: producer gave up on the
        self.finished = False             # queue, consumer reads by index
        self.finish_reason = None
        self.error = None
        self.consumed = 0                 # tokens yielded so far

    async def tokens(self):
        while True:
            if not self.overflow:
                item = await self.queue.get()
                if item is _END:
                    return
                if item is _SYNC:
                    continue      # re-check overflow at the loop top
                self.consumed += 1
                yield item
                continue
            # overflow mode: drain the queue's ordered prefix first, then
            # catch up from output_ids by index
            try:
                item = self.queue.get_nowait()
            except asyncio.QueueEmpty:
                item = None
            if item is _SYNC:
                item = None       # the flip sentinel is always last in
            if item is not None:  # the queue — fall through to catch-up
                if item is _END:
                    return
                self.consumed += 1
                yield item
                continue
            out = self.req.output_ids
            if self.consumed < len(out):
                tok = out[self.consumed]
                self.consumed += 1
                yield tok
                continue
            if self.finished:
                return
            # every engine-thread token append is followed by a dispatch
            # that sets `wake`, so clearing here cannot lose a wakeup
            self.wake.clear()
            if self.consumed < len(self.req.output_ids) or self.finished:
                continue
            await self.wake.wait()

    __aiter__ = tokens

    async def collect(self):
        """Drain the whole stream; returns (token_list, finish_reason)."""
        toks = []
        async for t in self.tokens():
            toks.append(t)
        return toks, self.finish_reason


class AsyncLLMEngine:
    def __init__(self, engine, max_waiting=64, stream_queue_size=64,
                 default_timeout_s=None, idle_poll_s=0.02,
                 max_step_retries=3, watchdog_step_timeout_s=None,
                 watchdog_poll_s=None, max_kv_commit_blocks=None,
                 hard_stop_timeout_s=30.0, poison_window_s=60.0):
        self.engine = engine
        self.metrics = engine.metrics
        self.max_waiting = int(max_waiting)
        self.stream_queue_size = max(1, int(stream_queue_size))
        self.default_timeout_s = default_timeout_s
        self._idle_poll_s = float(idle_poll_s)
        # failure supervision (serving/supervisor.py): poison-step
        # bisection + health; the watchdog thread only exists when a
        # step timeout is configured
        self.health = EngineHealth()
        self._sup = EngineSupervisor(
            engine, max_step_retries=max_step_retries, health=self.health,
            poison_window_s=poison_window_s)
        self.watchdog_step_timeout_s = watchdog_step_timeout_s
        self._watchdog = (
            None if watchdog_step_timeout_s is None
            else StepWatchdog(self._sup, watchdog_step_timeout_s,
                              poll_s=watchdog_poll_s,
                              on_trip=self._on_watchdog_trip)
        )
        # optional worst-case KV admission gate: total blocks the admitted
        # in-flight set could need at its longest. None = off (the
        # scheduler's preempt-by-recompute handles oversubscription); set
        # it to bound recompute thrash and surface 429 kv_capacity early.
        self.max_kv_commit_blocks = (
            None if max_kv_commit_blocks is None
            else int(max_kv_commit_blocks))
        self._kv_committed = 0
        self._kv_need = {}                # rid -> committed blocks
        # last-resort window for declaring the engine thread wedged at
        # shutdown; generous because one legitimate step can run long
        # (e.g. a first step that captures its CUDA graph)
        self.hard_stop_timeout_s = float(hard_stop_timeout_s)
        self._cmds = queue.Queue()
        self._streams = {}                # rid -> RequestStream (loop side)
        self._inflight = 0
        self._closed = False
        self._loop = None
        self._thread = None
        self._stopped = None

    # -- lifecycle ---------------------------------------------------------

    def _lc_to(self, state, reason):
        """Drive the engine's lifecycle word (serving/lifecycle.py) from
        the frontend's admission/thread events. Guarded twice: a wrapped
        engine without a lifecycle (test doubles) is a no-op, and racing
        daemons (a watchdog trip vs the thread-death epilogue) may lose
        the race to a terminal state — a late illegal edge is dropped
        here, not raised into a crash handler."""
        lc = getattr(self.engine, "lifecycle", None)
        if lc is None:
            return
        from .lifecycle import LifecycleError
        try:
            lc.to(state, reason)
        except LifecycleError:
            pass

    def lifecycle_state(self):
        """The engine's lifecycle word (``"cold"``..``"stopped"``), or
        None for engines without one: tells a caller whether the engine
        is still loading/compiling without firing a trial request."""
        lc = getattr(self.engine, "lifecycle", None)
        return None if lc is None else lc.state

    def lifecycle_snapshot(self):
        lc = getattr(self.engine, "lifecycle", None)
        return None if lc is None else lc.snapshot()

    async def start(self):
        """Bind to the running event loop and start the engine thread."""
        if self._thread is not None:
            return self
        self._loop = asyncio.get_running_loop()
        self._stopped = asyncio.Event()
        self.metrics.set_gauge("engine_unhealthy", 0.0)
        self._thread = threading.Thread(
            target=self._engine_loop, name="paddle-tpu-engine", daemon=True
        )
        # ownership stamp BEFORE start (the happens-before edge above
        # covers it): while this thread lives, the engine's synchronous
        # drive surface (step/generate/stream) rejects foreign threads —
        # see LLMEngine._guard_thread for the race it closes
        self.engine._engine_thread = self._thread
        self._thread.start()
        if self._watchdog is not None:
            self._watchdog.start()
        self._lc_to("serving", "start")
        return self

    @property
    def started(self):
        return self._thread is not None

    @property
    def inflight(self):
        return self._inflight

    @property
    def supervisor(self):
        """The EngineSupervisor running this engine's steps — the health
        word plus the poison-isolation window ``/healthz`` reports."""
        return self._sup

    def healthz_state(self):
        """The ``/healthz`` word as ``(state, health_snapshot)``
        without the HTTP layer: ``"ok"`` / ``"draining"`` /
        ``"unhealthy"`` / ``"engine_dead"``. This is THE one derivation
        of the engine's externally visible health — `ServingServer`
        renders it on ``/healthz`` from this one place. Precedence: a dead engine thread outranks everything
        (nothing can serve), sticky-unhealthy (watchdog trip, thread
        death recorded by the crash handler) outranks draining, and
        draining (admission closed, or never started) outranks ok.
        The snapshot carries the engine's lifecycle word (when it has
        one) so every surface rendering health shows the engine's
        birth/death phase too."""
        h = self.health.snapshot()
        lc = getattr(self.engine, "lifecycle", None)
        if lc is not None:
            h["lifecycle"] = lc.state
        thread_dead = self._thread is not None and not self._thread.is_alive()
        if thread_dead or (not h["healthy"] and h.get("reason") in
                           ("engine_thread_died", "engine_thread_wedged")):
            return "engine_dead", h
        if not h["healthy"]:
            return "unhealthy", h
        if self._closed or self._thread is None:
            return "draining", h
        return "ok", h

    def stop_admitting(self):
        """Flip admission off (submit raises EngineClosedError) without
        stopping the step loop — the load-balancer drain pattern: stop
        taking traffic first, `shutdown()` once drained."""
        self._closed = True
        self._lc_to("draining", "stop_admitting")

    def resume_admitting(self):
        """Reopen admission after `stop_admitting` — a drain that waited
        for in-flight zero and then reopens instead of restarting. Only a
        live, healthy engine may reopen: raising here instead of silently
        staying closed keeps a drain from \"completing\" against an
        engine that can never serve again."""
        if self._thread is None or not self._thread.is_alive():
            raise EngineClosedError(
                "engine thread is dead; cannot resume admission",
                reason="engine_dead", retry_after_s=None,
            )
        if not self.health.healthy:
            raise EngineClosedError(
                f"engine unhealthy: {self.health.reason}; cannot resume "
                "admission", reason="unhealthy", retry_after_s=None,
            )
        self._closed = False
        self._lc_to("serving", "resume_admitting")

    async def shutdown(self, drain=True, timeout_s=30.0):
        """Graceful drain: stop admitting, finish (or, past ``timeout_s``,
        abort) in-flight requests, then join the engine thread. With
        ``drain=False`` everything in flight is aborted immediately. A
        WEDGED engine thread (stuck device step — watchdog territory)
        cannot be joined: past ``hard_stop_timeout_s`` of no progress the
        loop-side state is cleaned up anyway (streams terminated, callers
        released) and the daemon thread is left to the OS."""
        self._closed = True
        self._lc_to("draining", "shutdown")
        if self._thread is None:
            # never started: there is no engine loop whose epilogue would
            # stamp the terminal state — do it here
            self._lc_to("stopped", "shutdown before start")
            return
        self._cmds.put(("stop", bool(drain)))
        stopped = await self._await_stopped(
            timeout_s if drain else self.hard_stop_timeout_s)
        if not stopped:
            self._cmds.put(("stop", False))
            stopped = await self._await_stopped(self.hard_stop_timeout_s)
        while not stopped:
            # slow is not wedged: as long as steps keep FINISHING the
            # thread is alive and will reach the hard-stop command —
            # keep waiting. Only a thread with no step progress for a
            # full window is declared wedged.
            if (time.monotonic() - self._sup.last_step_finished
                    >= self.hard_stop_timeout_s):
                break
            stopped = await self._await_stopped(self.hard_stop_timeout_s)
        if self._watchdog is not None:
            self._watchdog.request_stop()
        if not stopped:
            # the engine thread is not draining its command queue and has
            # made no step progress — it is stuck inside a step (or dead
            # in a way the crash handler could not reach). Do its
            # loop-side last rites ourselves so no consumer or caller
            # waits on a thread we cannot kill.
            self.health.mark_unhealthy("engine_thread_wedged")
            self.metrics.set_gauge("engine_unhealthy", 1.0)
            self._fail_all_streams(
                "error", "engine thread wedged during shutdown")
            self._stopped.set()
            return
        # Thread.join blocks; _stopped was set by the engine thread's last
        # act, so this is near-instant — but a hung thread must stall an
        # executor worker, never the event loop (JL007)
        await asyncio.get_running_loop().run_in_executor(
            None, self._thread.join, 5.0)
        close = getattr(self.engine, "close", None)
        if close is not None:
            # release engine-owned background resources (the host-tier
            # drain thread) now that the engine thread is gone
            await asyncio.get_running_loop().run_in_executor(None, close)

    async def _await_stopped(self, timeout_s):
        """True once the engine thread signalled `_stopped` (bounded by
        `timeout_s`; None waits forever)."""
        try:
            await asyncio.wait_for(self._stopped.wait(), timeout_s)
            return True
        except asyncio.TimeoutError:
            return False

    # -- request API (event-loop thread) -----------------------------------

    def submit(self, prompt_ids, max_new_tokens=16, temperature=0.0,
               eos_token_id=None, timeout_s=None, request_id=None,
               top_k=None, top_p=None, spec_decoding=None,
               num_spec_tokens=None, trace=None, tenant=None,
               priority=None, adapter=None):
        """Admit one request; returns its RequestStream. Raises
        EngineClosedError when draining/stopped, EngineOverloadedError when
        the bounded wait queue is full, ValueError on a bad request —
        all BEFORE the request reaches the engine thread. `top_k`/`top_p`
        restrict the sampling support; `spec_decoding`/`num_spec_tokens`
        opt out of (or cap) speculative drafting per request;
        `trace=True`/`False` forces this request into (out of) the
        engine's lifecycle tracer regardless of its sampling fraction;
        `tenant`/`priority` label the request's SLO accounting class
        (serving/slo.py) and the effective ``timeout_s`` becomes its
        deadline-attainment target; `adapter` names a loaded LoRA
        adapter to decode through (engine.load_adapter)."""
        from .scheduler import Request

        if not self.health.healthy:
            raise EngineClosedError(
                f"engine unhealthy: {self.health.reason}",
                reason="unhealthy", retry_after_s=None,
            )
        if self._closed:
            raise EngineClosedError(
                "engine is draining; not admitting",
                reason="draining", retry_after_s=5.0,
            )
        if self._thread is None:
            raise RuntimeError("AsyncLLMEngine.start() has not been awaited")
        if not self._thread.is_alive() or self._stopped.is_set():
            # a dead engine thread that slipped past the crash handler
            # (e.g. interpreter teardown): fail fast, never enqueue into
            # a command queue nobody drains. `_stopped` covers the unwind
            # window where the epilogue has posted but the OS thread is
            # still exiting (is_alive() briefly True)
            raise EngineClosedError(
                "engine thread is dead; not admitting",
                reason="engine_dead", retry_after_s=None,
            )
        limit = self.engine.max_batch + self.max_waiting
        if self._inflight >= limit:
            self.metrics.inc("requests_rejected")
            raise EngineOverloadedError(
                f"{self._inflight} requests in flight (limit {limit}: "
                f"max_batch {self.engine.max_batch} + max_waiting "
                f"{self.max_waiting})",
                reason="queue_full", retry_after_s=1.0,
            )
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        req = Request(prompt_ids, max_new_tokens=max_new_tokens,
                      temperature=temperature, eos_token_id=eos_token_id,
                      request_id=request_id, top_k=top_k, top_p=top_p,
                      spec_decoding=spec_decoding,
                      num_spec_tokens=num_spec_tokens, trace=trace,
                      tenant=tenant, priority=priority, adapter=adapter,
                      # the enforced timeout IS the SLO deadline: the
                      # ledger judges met/missed against what the serve
                      # actually promised
                      deadline_s=timeout_s)
        worst_case_blocks = self.engine.validate(req)
        need = 0
        if self.max_kv_commit_blocks is not None:
            # worst-case KV commitment: admitting past the gate would let
            # the in-flight set oversubscribe KV so far that the scheduler
            # thrashes preempt-by-recompute — reject with the reason
            # (kv_capacity, not queue_full) so clients back off correctly.
            # Checked BEFORE the prompt is hashed: a rejected retry storm
            # must not pay O(prompt) hashing on the event-loop thread
            need = worst_case_blocks
            if self._kv_committed + need > self.max_kv_commit_blocks:
                self.metrics.inc("requests_rejected")
                raise EngineOverloadedError(
                    f"worst-case KV commitment {self._kv_committed} + "
                    f"{need} blocks exceeds max_kv_commit_blocks "
                    f"{self.max_kv_commit_blocks}",
                    reason="kv_capacity", retry_after_s=1.0,
                )
        if self.engine.prefix_cache:
            # chain the prompt's block hashes HERE, off the engine thread:
            # engine.add skips recomputing them, so a long prompt's hashing
            # cost never lands between two device steps
            from .block_pool import chain_block_hashes

            req.block_hashes = chain_block_hashes(
                req.prompt_ids, self.engine.block_size, salt=req.adapter
            )
        if req.request_id in self._streams:
            raise ValueError(f"duplicate request id {req.request_id}")
        st = RequestStream(req.request_id, req, self.stream_queue_size)
        self._streams[req.request_id] = st
        if need:
            self._kv_committed += need
            self._kv_need[req.request_id] = need
        self._inflight += 1
        self.metrics.set_gauge("frontend_inflight", self._inflight)
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        self._cmds.put(("add", req, deadline))
        return st

    async def generate(self, prompt_ids, **kwargs):
        """Non-streaming convenience: (token_list, finish_reason)."""
        return await self.submit(prompt_ids, **kwargs).collect()

    def abort(self, request_id, reason="cancelled"):
        """Cancel a request (client disconnect, server policy). Safe for
        unknown/finished ids. The stream finishes with `reason`."""
        self._cmds.put(("abort", request_id, reason))

    # -- event dispatch (event-loop thread) --------------------------------

    def _dispatch(self, events):
        for ev in events:
            kind, rid = ev[0], ev[1]
            if kind == "fail_all":
                # watchdog trip / engine-thread death: every live stream
                # gets ONE terminal error event instead of silence
                _, _, reason, detail = ev
                self._fail_all_streams(reason, detail)
                continue
            st = self._streams.get(rid)
            if st is None:
                continue
            if kind == "catchup":
                # post-recovery re-sync: a step that raised mid-emission
                # may have appended tokens (even finished the request)
                # without the queue pushes ever happening — flip the
                # stream into the lossless catch-up mode, which reads
                # the authoritative output_ids by index. The sentinel
                # wakes a consumer already parked on queue.get(); if the
                # queue is full the consumer is behind and will see the
                # flip before it can park again.
                st.overflow = True
                try:
                    st.queue.put_nowait(_SYNC)
                except asyncio.QueueFull:
                    pass
                st.wake.set()
                continue
            if kind == "tok":
                _, _, tok, reason = ev
                self._push_token(st, tok)
                if reason is not None:
                    self._finish_stream(st, reason)
            else:  # ("finish", rid, reason, detail)
                _, _, reason, detail = ev
                st.error = detail
                self._finish_stream(st, reason)

    def _push_token(self, st, tok):
        if not st.overflow:
            try:
                st.queue.put_nowait(tok)
            except asyncio.QueueFull:
                st.overflow = True
                self.metrics.inc("backpressure_drops")
        st.wake.set()

    def _finish_stream(self, st, reason):
        if st.finished:
            return
        st.finished = True
        st.finish_reason = reason
        if not st.overflow:
            try:
                st.queue.put_nowait(_END)
            except asyncio.QueueFull:
                st.overflow = True
        st.wake.set()
        st.done.set()
        del self._streams[st.request_id]
        self._kv_committed -= self._kv_need.pop(st.request_id, 0)
        self._inflight -= 1
        self.metrics.set_gauge("frontend_inflight", self._inflight)

    def _fail_all_streams(self, reason, detail):
        """Terminate every live stream with `reason`/`detail` (loop
        thread). Used by the crash-safe engine-thread exit and the
        watchdog trip — the single-terminal-event invariant holds because
        `_finish_stream` is idempotent per stream."""
        for st in list(self._streams.values()):
            st.error = detail
            self._finish_stream(st, reason)

    def _on_stopped(self):
        # hard-stop/drain already finished every stream; anything left
        # (e.g. an add command raced the stop) is cancelled here
        for st in list(self._streams.values()):
            self._finish_stream(st, "cancelled")
        self._stopped.set()

    def _to_loop(self, events):
        try:
            self._loop.call_soon_threadsafe(self._dispatch, events)
        except RuntimeError:
            pass  # event loop already closed (interpreter teardown)

    # -- watchdog trip (watchdog thread) -----------------------------------

    def _on_watchdog_trip(self, stuck_for_s):
        """The engine thread has been inside one step for longer than
        ``watchdog_step_timeout_s``. It cannot be killed; what can be done
        is drain the blast radius: health goes unhealthy (503 /healthz →
        the LB pulls this replica), admission closes, and every in-flight
        consumer gets a structured terminal error instead of silence."""
        self._sup.on_watchdog_trip(stuck_for_s)   # health + metrics + trace
        self._closed = True
        self._lc_to("draining", "watchdog_trip")
        self._to_loop([(
            "fail_all", None, "error",
            f"step_stuck: engine step has been running for "
            f"{stuck_for_s:.1f}s (watchdog_step_timeout_s="
            f"{self.watchdog_step_timeout_s})")])

    # -- engine thread -----------------------------------------------------

    def _engine_loop(self):
        """Engine-thread main: the crash-safe shell around the real loop.
        NOTHING may escape without the epilogue running — an exception
        that skipped `_on_stopped` would leave every pending consumer
        parked on a queue nobody will ever fill."""
        try:
            with self.engine.device_scope():
                self._run_engine_loop()
        except BaseException as e:  # noqa: BLE001 — thread epilogue:
            # fan a terminal error to every live stream, mark the engine
            # unhealthy/closed, and fail fast on later submits
            self._closed = True
            self.health.mark_unhealthy(
                "engine_thread_died", error=f"{type(e).__name__}: {e}")
            self.metrics.inc("engine_thread_deaths")
            self.metrics.set_gauge("engine_unhealthy", 1.0)
            _log.exception("engine thread died")
            try:
                # this thread owns the engine and is about to stop being
                # able to: return every KV block while it still can
                for rid in self.engine.live_requests():
                    self.engine.abort(rid, reason="error:engine_thread_died")
            except Exception:  # noqa: BLE001 — best-effort last rites on
                pass               # state the escaping exception may have
                                   # already corrupted
            self._to_loop([(
                "fail_all", None, "error",
                f"engine thread died: {type(e).__name__}: {e}")])
            rec = getattr(self.engine, "recorder", None)
            if rec is not None:
                # the dying thread's last observability act: one durable
                # bundle (record never raises — postmortem.py). AFTER
                # fail_all is posted: a slow postmortem volume must not
                # delay failure delivery to waiting clients.
                rec.record("engine_thread_died",
                           detail=f"{type(e).__name__}: {e}",
                           health=self.health.snapshot())
        finally:
            self._closed = True
            # terminal lifecycle stamp: exactly one, from the one thread
            # that owns "the engine can no longer step" (clean stop and
            # crash alike end here)
            self._lc_to("stopped", "engine thread exited")
            if self._watchdog is not None:
                self._watchdog.request_stop()
            try:
                self._loop.call_soon_threadsafe(self._on_stopped)
            except RuntimeError:
                pass

    def _run_engine_loop(self):
        eng = self.engine
        deadlines = {}   # rid -> monotonic deadline
        live = set()     # rids this thread admitted and not yet retired
        draining = False
        stop = False

        def retire(rid, req, last_token):
            """Natural completion: drop loop bookkeeping, release the
            engine record, return the finish reason (the ONE stop-vs-
            length derivation)."""
            live.discard(rid)
            deadlines.pop(rid, None)
            eng.release(rid)
            return ("stop"
                    if req.eos_token_id is not None
                    and last_token == req.eos_token_id
                    else "length")

        while not stop:
            if faults._PLAN is not None:
                fp = faults._PLAN.match("thread_die")
                if fp is not None:
                    raise FaultInjected("thread_die")
            # drain commands; park on the queue (poll interval) when idle
            cmds = []
            try:
                if eng.has_unfinished():
                    cmds.append(self._cmds.get_nowait())
                else:
                    cmds.append(self._cmds.get(timeout=self._idle_poll_s))
            except queue.Empty:
                pass
            while True:
                try:
                    cmds.append(self._cmds.get_nowait())
                except queue.Empty:
                    break
            events = []
            for cmd in cmds:
                kind = cmd[0]
                if kind == "add":
                    _, req, deadline = cmd
                    if draining:
                        events.append(
                            ("finish", req.request_id, "cancelled", None))
                        continue
                    try:
                        eng.add(req)
                    except Exception as e:  # noqa: BLE001 — fail the one
                        events.append(       # request, not the loop
                            ("finish", req.request_id, "error", str(e)))
                        continue
                    live.add(req.request_id)
                    if deadline is not None:
                        deadlines[req.request_id] = deadline
                elif kind == "abort":
                    _, rid, reason = cmd
                    if eng.abort(rid):
                        live.discard(rid)
                        deadlines.pop(rid, None)
                        self.metrics.inc("requests_cancelled")
                        events.append(("finish", rid, reason, None))
                elif kind == "stop":
                    draining = True
                    if not cmd[1]:  # hard stop: abort everything in flight
                        for rid in list(live):
                            if eng.abort(rid):
                                self.metrics.inc("requests_cancelled")
                                events.append(
                                    ("finish", rid, "cancelled", None))
                        live.clear()
                        deadlines.clear()
                        stop = True
            now = time.monotonic()
            for rid, dl in list(deadlines.items()):
                if now >= dl:
                    deadlines.pop(rid)
                    # reason "timeout" labels the trace span/request-log
                    # line and maps to the SLO ledger's `missed` verdict
                    if eng.abort(rid, reason="timeout"):
                        live.discard(rid)
                        self.metrics.inc("requests_timeout")
                        events.append(("finish", rid, "timeout", None))
            if not stop and eng.has_unfinished():
                # supervised step: a raising step is bisected down to the
                # one poisoned request (everyone else recomputes), rows
                # with non-finite logits are contained per-row, and only
                # max_step_retries consecutive unattributable failures
                # fall back to failing everything (supervisor.py)
                outs, failures = self._sup.step()
                for rid, detail in failures:
                    live.discard(rid)
                    deadlines.pop(rid, None)
                    events.append(("finish", rid, "error", detail))
                # a recovery means the failed step's emission was lost:
                # re-sync every touched stream from output_ids (lossless
                # catch-up), and requests that FINISHED inside that step
                # get the terminal event its emit loop never dispatched
                for rid in self._sup.last_touched:
                    if rid not in live:
                        continue
                    req = eng.peek_request(rid)
                    if req is None:
                        continue       # aborted: covered by failures
                    events.append(("catchup", rid))
                    if req.finished:
                        reason = retire(
                            rid, req,
                            req.output_ids[-1] if req.output_ids else None)
                        events.append(("finish", rid, reason, None))
                if self._watchdog is not None and self._watchdog.tripped:
                    # the stuck step finally returned, but its consumers
                    # were already failed over — retire the orphaned
                    # requests so the pool drains to idle (the engine
                    # stays unhealthy/closed; the LB pulled the replica)
                    for rid in list(live):
                        if eng.abort(rid, reason="error:step_stuck"):
                            events.append((
                                "finish", rid, "error",
                                "step_stuck: aborted after watchdog trip"))
                    live.clear()
                    deadlines.clear()
                for o in outs:
                    reason = None
                    if o.finished:
                        req = eng.peek_request(o.request_id)
                        if req is None:
                            # finished during a recovery probe and already
                            # released by the reconciliation above (its
                            # stream got catchup + finish; the token
                            # arrives via catch-up, not this event)
                            continue
                        reason = retire(o.request_id, req, o.token)
                    events.append(("tok", o.request_id, o.token, reason))
            if events:
                self._to_loop(events)
            if draining and not stop and not eng.has_unfinished():
                stop = True
