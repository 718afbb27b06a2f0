"""Engine supervision: poison-request isolation, stuck-step watchdog, health.

The serving stack's failure-boundary layer. `LLMEngine.step` is fast and
correct on the happy path, but production traffic eventually produces the
three failures this module exists for:

- a **poisoned step** — `step()` raises (a request whose inputs trip a
  device error, an injected `step_raise` fault). Killing every in-flight
  request for one offender is the availability bug this PR removes:
  `EngineSupervisor` re-queues every row of the failed step
  (preempt-by-recompute — the engine holds no partial step state, aborts
  and preemptions return every KV block), then **bisects** the planned
  batch: probe steps re-run the step restricted to half the suspect set
  (`LLMEngine.step(only=...)`, O(log B) extra steps), the surviving
  candidate is verified by a singleton probe, and only a request whose
  presence *reproduces* the failure is aborted — with a structured
  ``error`` finish carrying the exception class. A transient fault that
  does not re-fire attributes nobody and everyone recomputes. Only after
  ``max_step_retries`` CONSECUTIVE unattributable failures does the
  supervisor fall back to the old abort-everything behavior.
- a **stuck step** — the device call never returns. The engine thread is
  wedged inside a device call and cannot be killed; what CAN be done is making the
  failure visible and draining the blast radius: `StepWatchdog` (its own
  thread) polls the supervisor's ``step_started_at`` and, past
  ``watchdog_step_timeout_s``, flips `EngineHealth` to unhealthy
  (``/healthz`` goes 503 with ``{"reason": "step_stuck", ...}`` so the
  load balancer pulls the replica), closes admission, and fans a terminal
  error to every consumer stream instead of silence. If the step later
  returns, the engine thread aborts the orphaned requests so the pool
  still drains to idle.
- **non-finite logits** — handled inside `LLMEngine.step` (per-row
  NaN/Inf detection in the step program, the TrainMonitor discipline
  applied to serving); the supervisor relays the engine's ``step_faults``
  so those rows terminate their streams with ``error`` instead of
  sampling garbage.

An exception marked ``fatal`` — a tensor-parallel rank that raised or died
(`distributed.ranks.RankFailed`) — is no request's fault and leaves an
engine that cannot step again: the supervisor does not bisect it but lets
it escape, so it surfaces as the engine's exception (the async frontend's
engine thread dies with it, fails every stream with its message and marks
the replica unhealthy).

`EngineHealth` is the shared, thread-safe health word the HTTP ``/healthz``
endpoint renders: healthy (200) / unhealthy (503 + reason). Unhealthy is
sticky — the first cause wins, and a replica that tripped its watchdog or
lost its engine thread stays out of rotation until restarted.

Metrics: counters ``engine_step_errors`` (steps that raised),
``engine_step_retries`` (bisection probe steps), ``poison_requests_isolated``
(culprits attributed and aborted), ``watchdog_trips``; gauge
``engine_unhealthy`` (0/1). Trace: every fault fire, probe, verdict, and
watchdog trip is an instant on the tracer's ``supervisor`` track, so a
chaos run reads end-to-end in one Perfetto view.

All of this is driven by the `AsyncLLMEngine` engine thread
(serving/frontend.py); the classes are framework-free so tests can run the
supervisor synchronously against a bare `LLMEngine`.
"""
from __future__ import annotations

import threading
import time
from collections import deque


class EngineHealth:
    """Thread-safe engine health word (the ``/healthz`` source of truth).

    Healthy until the first `mark_unhealthy`, then sticky: the first
    cause wins and later calls are ignored — an operator debugging a 503
    needs the ORIGINAL failure, not whatever cascaded from it.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._healthy = True
        self._reason = None
        self._info = {}
        self._since = None

    @property
    def healthy(self):
        with self._lock:
            return self._healthy

    @property
    def reason(self):
        with self._lock:
            return self._reason

    def mark_unhealthy(self, reason, **info):
        """Flip to unhealthy with a machine-readable `reason` (e.g.
        ``step_stuck``, ``engine_thread_died``) plus free-form detail
        fields. Returns True if this call was the one that flipped."""
        with self._lock:
            if not self._healthy:
                return False
            self._healthy = False
            self._reason = str(reason)
            self._info = dict(info)
            self._since = time.monotonic()
            return True

    def snapshot(self):
        """JSON-able view for ``/healthz``: ``{"healthy": true}`` or the
        unhealthy record with its reason, detail fields (e.g.
        ``stuck_for_s`` at trip time), and live ``unhealthy_for_s``."""
        with self._lock:
            if self._healthy:
                return {"healthy": True}
            out = {
                "healthy": False,
                "reason": self._reason,
                "unhealthy_for_s": round(
                    time.monotonic() - self._since, 3),
            }
            out.update(self._info)
            return out


class EngineSupervisor:
    """Runs `LLMEngine.step` under failure supervision (see module doc).

    `step()` is the engine thread's one entry point; it returns
    ``(outs, failures)`` where `outs` are the usual StepOutputs (probe
    steps during recovery emit real tokens too) and `failures` are
    ``(request_id, detail)`` pairs for requests the supervisor or the
    engine's non-finite containment terminated with an ``error`` finish.
    """

    def __init__(self, engine, max_step_retries=3, health=None,
                 poison_window_s=60.0):
        self.engine = engine
        self.max_step_retries = max(1, int(max_step_retries))
        self.health = EngineHealth() if health is None else health
        # sliding poison-isolation window: every bisection attribution is recorded with
        # its request SOURCE — the tenant label, or "-" for untenanted
        # traffic — so `poison_stats` can distinguish one adversarial
        # client feeding poison (one distinct source, however many
        # isolations) from a sick chip poisoning everyone's requests
        # (many distinct sources). ``/healthz`` reports both counts.
        self.poison_window_s = float(poison_window_s)
        self._poison_lock = threading.Lock()
        self._poison_events = deque()   # (monotonic_t, source)
        # read by the watchdog thread (a single attribute load under the
        # GIL): monotonic start of the step in flight, or None
        self.step_started_at = None
        self.last_step_finished = time.monotonic()
        self._unattributable = 0   # consecutive failures nobody owned
        # requests the most recent recovery touched (the failed step's
        # whole plan — the frontend re-syncs their streams from
        # output_ids, because a step that raised mid-emission lost its
        # StepOutputs for anything it had already appended/finished)
        self.last_touched = []

    # -- the one engine-thread entry ----------------------------------------

    def step(self):
        """One supervised engine step; returns ``(outs, failures)``.
        After a recovery, ``last_touched`` names every request of the
        failed step's plan (else it is empty)."""
        eng = self.engine
        self.last_touched = []
        try:
            outs = self._timed_step()
        except Exception as e:  # noqa: BLE001 — ANY step escape goes
            if getattr(e, "fatal", False):
                raise             # a dead rank: no request to isolate
            return self._recover(e)   # through isolation, not the loop
        self._unattributable = 0
        return outs, list(eng.step_faults)

    def _timed_step(self, only=None):
        self.step_started_at = time.monotonic()
        try:
            return self.engine.step(only=only)
        finally:
            self.step_started_at = None
            self.last_step_finished = time.monotonic()

    # -- poison isolation ----------------------------------------------------

    def _recover(self, exc):
        """A step raised: re-queue its rows, bisect for the offender,
        abort ONLY a reproducible culprit; abort everything only after
        ``max_step_retries`` consecutive unattributable failures.

        Known limit: a PERSISTENT batch-independent failure (the device
        itself broken — every probe raises no matter who is in it) is
        indistinguishable from a stream of genuinely poisonous requests,
        so it is isolated one request at a time. The terminal outcome
        per request is the same as the old abort-everything behavior
        (each ends ``error``), just O(log B) probe steps slower — and
        treating repeated attributions as engine failure would let one
        adversarial client unhealthy a replica, which is worse."""
        eng = self.engine
        tr = eng.tracer
        detail = f"{type(exc).__name__}: {exc}"
        eng.metrics.inc("engine_step_errors")
        # rows the failed step CONTAINED before raising (non-finite
        # aborts) already terminated engine-side — their streams still
        # need the terminal event, raise or no raise
        failures = list(eng.step_faults)
        self.last_touched = list(eng.last_planned)
        suspects = [rid for rid in eng.last_planned
                    if not self._finished(rid)]
        # preempt-by-recompute every row of the failed step: whatever the
        # step did or did not reach on the device, a replay from blocks-
        # returned state is correct by construction. Reversed: _preempt
        # re-queues at the FRONT, so walking the plan backwards keeps the
        # suspects' FCFS order in the waiting queue.
        for rid in reversed(suspects):
            eng.requeue(rid)
        if eng.slo is not None:
            # recovery wait is failure-boundary time, not an ordinary
            # preemption: re-label the suspects' phase clock so the SLO
            # decomposition attributes bisection/replay waits to
            # `stalled` (re-admission flips them back to compute)
            for rid in suspects:
                req = eng._requests.get(rid)
                if req is not None and not req.finished:
                    eng.slo.transition(req, "stalled")
        if tr is not None:
            tr.supervisor_instant("step_failed", {
                "step": eng.step_count, "error": detail,
                "suspects": len(suspects)})
        culprit, outs, probe_failures = self._bisect(suspects)
        failures += probe_failures
        if culprit is not None:
            victim = eng._requests.get(culprit)
            eng.abort(culprit, reason=f"error:{type(exc).__name__}")
            eng.metrics.inc("poison_requests_isolated")
            self._note_poison(victim)
            if eng.recorder is not None:
                # one bundle per isolation, carrying the culprit's final
                # ledger decomposition (record never raises)
                eng.recorder.record("poison_isolated", detail=detail,
                                    victim=victim,
                                    health=self.health.snapshot())
            if tr is not None:
                tr.supervisor_instant("poison_isolated", {
                    "request_id": culprit, "error": detail})
            self._unattributable = 0
            failures.append((culprit, detail))
            return outs, failures
        self._unattributable += 1
        if self._unattributable < self.max_step_retries:
            return outs, failures
        # last resort (the pre-supervisor behavior): the failure keeps
        # reproducing but no single request owns it — fail everything
        # loudly rather than looping a broken engine forever
        self._unattributable = 0
        if tr is not None:
            tr.supervisor_instant("abort_all", {"error": detail})
        for rid in eng.live_requests():
            eng.abort(rid, reason="error:unattributable")
            failures.append(
                (rid, f"unattributable step failures: {detail}"))
        return outs, failures

    def _bisect(self, suspects):
        """Binary-search `suspects` with probe steps; returns
        ``(culprit_or_None, outs, failures)``. Each probe re-runs the
        step restricted to half the live suspect set — innocents in a
        clean probe make real progress (their tokens flow back to the
        caller). A clean probe exonerates ONLY the ids it actually
        STEPPED: a probed request the scheduler deferred (phantom/real
        pool pressure) stays suspect, and a probe that stepped nothing
        is inconclusive — the other half is probed instead. Every
        productive round strictly shrinks the suspect set (normally by
        half, so isolation stays O(log B) extra steps); a round that
        can neither step nor reproduce anything gives up without
        attributing. The surviving candidate must REPRODUCE the failure
        in a final singleton probe, so a transient fault attributes
        nobody."""
        outs, failures = [], []
        suspects = list(suspects)
        while len(suspects) > 1:
            half = suspects[:len(suspects) // 2]
            other = suspects[len(suspects) // 2:]
            progressed = False
            raised, stepped, o, f = self._probe(half)
            outs += o
            failures += f
            if raised:
                suspects = half
                progressed = True
            else:
                if stepped:
                    cleared = set(stepped)
                    suspects = [r for r in suspects if r not in cleared]
                    progressed = True
                if len(suspects) > 1 and not stepped:
                    raised2, stepped2, o2, f2 = self._probe(other)
                    outs += o2
                    failures += f2
                    if raised2:
                        suspects = other
                        progressed = True
                    elif stepped2:
                        cleared = set(stepped2)
                        suspects = [r for r in suspects
                                    if r not in cleared]
                        progressed = True
            suspects = [r for r in suspects if not self._finished(r)]
            if not progressed:
                # nothing could be stepped and nothing reproduced:
                # unattributed, nobody aborted
                return None, outs, failures
        if not suspects:
            return None, outs, failures
        raised, _, o, f = self._probe(suspects)
        outs += o
        failures += f
        return (suspects[0] if raised else None), outs, failures

    def _probe(self, ids):
        """One bisection probe: step ONLY `ids`. Returns
        ``(raised, stepped, outs, failures)``: `raised` means the probe
        REPRODUCED the failure (probed rows re-queued again); otherwise
        `stepped` lists the ids the scheduler actually planned — the
        only ids the clean probe exonerates (a deferred id learned
        nothing and must stay suspect)."""
        eng = self.engine
        eng.metrics.inc("engine_step_retries")
        if eng.tracer is not None:
            eng.tracer.supervisor_instant(
                "bisect_probe", {"request_ids": list(ids)})
        before = eng.step_count
        try:
            outs = self._timed_step(only=frozenset(ids))
        except Exception:  # noqa: BLE001 — the probe REPRODUCING the
            # failure is the signal bisection wants (reversed: keep the
            # probed rows' FCFS order through the front-of-queue requeue)
            for rid in reversed(ids):
                if not self._finished(rid):
                    eng.requeue(rid)
            return True, [], [], list(eng.step_faults)
        if eng.step_count == before:
            stepped = []       # nothing planned (last_planned is stale)
        else:
            planned = set(eng.last_planned)
            stepped = [r for r in ids if r in planned]
        return False, stepped, outs, list(eng.step_faults)

    def _finished(self, rid):
        req = self.engine._requests.get(rid)
        return req is None or req.finished

    # -- poison-isolation window --------------------------------------------

    def _prune_poison(self, now):
        # caller holds _poison_lock
        horizon = now - self.poison_window_s
        while self._poison_events and self._poison_events[0][0] < horizon:
            self._poison_events.popleft()

    def _note_poison(self, victim):
        """Record one bisection attribution in the sliding window, keyed
        by the victim's SOURCE: its tenant label, or "-" when untenanted.
        Distinct request ids are deliberately NOT the key — an adversarial
        client can mint unlimited request ids but only speaks for one
        tenant, so serial poison from one source can never read as a
        sick chip."""
        src = "-" if victim is None or victim.tenant is None \
            else victim.tenant
        now = time.monotonic()
        with self._poison_lock:
            self._poison_events.append((now, src))
            self._prune_poison(now)
            n = len(self._poison_events)
            k = len({s for _, s in self._poison_events})
        self.engine.metrics.set_gauge("poison_isolated_in_window", n)
        self.engine.metrics.set_gauge("poison_distinct_sources", k)

    def poison_stats(self):
        """Sliding-window poison-isolation view for ``/healthz``:
        isolations in the last ``poison_window_s`` seconds and how many
        DISTINCT sources (tenants) they came from. Attributions spread
        across several unrelated sources are evidence the engine itself
        (a sick card) is poisoning requests; ``distinct_sources`` is the
        count one adversarial client cannot inflate. Refreshes the two
        gauges so a scrape decays with the window."""
        now = time.monotonic()
        with self._poison_lock:
            self._prune_poison(now)
            events = list(self._poison_events)
        n = len(events)
        k = len({s for _, s in events})
        self.engine.metrics.set_gauge("poison_isolated_in_window", n)
        self.engine.metrics.set_gauge("poison_distinct_sources", k)
        return {"window_s": self.poison_window_s,
                "isolated_in_window": n,
                "distinct_sources": k}

    # -- watchdog ------------------------------------------------------------

    def on_watchdog_trip(self, stuck_for_s):
        """Record a watchdog trip: health goes unhealthy (sticky),
        metrics and trace mark the event. The frontend layers stream
        fan-out and admission close on top of this."""
        eng = self.engine
        self.health.mark_unhealthy(
            "step_stuck", stuck_for_s=round(stuck_for_s, 3),
            step=eng.step_count)
        eng.metrics.inc("watchdog_trips")
        eng.metrics.set_gauge("engine_unhealthy", 1.0)
        if eng.slo is not None:
            # the engine thread is wedged inside the step (by definition
            # not touching these clocks): attribute the hung-step wait
            # of every planned request to `stalled` from here on
            for rid in eng.last_planned:
                req = eng._requests.get(rid)
                if req is not None and not req.finished:
                    eng.slo.transition(req, "stalled")
        if eng.recorder is not None:
            eng.recorder.record(
                "watchdog_trip",
                detail=f"step stuck for {stuck_for_s:.3f}s",
                health=self.health.snapshot())
        if eng.tracer is not None:
            eng.tracer.supervisor_instant("watchdog_trip", {
                "stuck_for_s": round(stuck_for_s, 3),
                "step": eng.step_count})


class StepWatchdog:
    """Monitor thread for the stuck-step failure mode.

    Polls ``supervisor.step_started_at`` every ``poll_s``; a step in
    flight for more than ``timeout_s`` fires ``on_trip(stuck_for_s)``
    ONCE (from the watchdog thread — the engine thread is the one that's
    stuck) and the watchdog retires. Health-flip latency is therefore
    bounded by ``timeout_s + poll_s``.
    """

    def __init__(self, supervisor, timeout_s, poll_s=None, on_trip=None):
        self.supervisor = supervisor
        self.timeout_s = float(timeout_s)
        if self.timeout_s <= 0:
            raise ValueError("watchdog timeout_s must be > 0")
        self.poll_s = (max(0.005, min(self.timeout_s / 4.0, 1.0))
                       if poll_s is None else float(poll_s))
        self.on_trip = (supervisor.on_watchdog_trip
                        if on_trip is None else on_trip)
        self.tripped = False
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="paddle-tpu-watchdog", daemon=True)
            self._thread.start()
        return self

    def request_stop(self):
        """Ask the watchdog to exit (non-blocking; safe from any thread,
        including event-loop callbacks)."""
        self._stop.set()

    def stop(self, join_timeout_s=2.0):
        """Stop and join (bounded — the poll loop exits within one
        ``poll_s`` of the stop event)."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(join_timeout_s)

    def _run(self):
        while not self._stop.wait(self.poll_s):
            started = self.supervisor.step_started_at
            if started is None:
                continue
            stuck = time.monotonic() - started
            if stuck >= self.timeout_s:
                self.tripped = True
                self.on_trip(stuck)
                return   # sticky: one trip per watchdog lifetime
