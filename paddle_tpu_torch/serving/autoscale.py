"""SLO-driven autoscaler: the router-side control loop that makes the
fleet elastic (the JAX package's `serving/autoscale.py`, over the port's
router).

The SLO ledger gives per-class deadline attainment and the router
predicts queue wait per replica; this loop closes them: when windowed
attainment of ANY (tenant, priority) class drops below
``target_attainment``, or even the least-loaded replica's predicted wait
exceeds ``wait_high_s``, for ``up_streak`` consecutive ticks, it spawns a
replica through the factory (streamed checkpoint load + warmup, so the
time from decision to first served token — the spawn TTFT — is bounded by
load and capture, not by a cold first request); when the fleet is
comfortably over target and every replica's predicted wait sits under
``wait_low_s`` for ``down_streak`` ticks, it retires one through
`ReplicaRouter.retire_replica` (drain + ``migrate_on_drain`` host-tier
handoff — scale-down never rewarms the survivors' caches). A retired
engine is dropped by the router; its weights, arena, CUDA graphs (and
their private pool) and its tier's pinned slabs are freed with it.

Flap control is structural, not tuned: asymmetric streaks (scaling up is
cheap to undo, scaling down is not, so ``down_streak`` defaults much
longer), a shared ``cooldown_s`` window after ANY scale event, and hard
``min_replicas``/``max_replicas`` clamps. Every decision — including the
refusals — lands in `decisions` (the ``/debug/autoscale`` endpoint,
serving/server.py) and on each active replica's engine tracer as an
``autoscale`` supervisor instant, so a scaling flap shows up next to the
steps it caused.

Threads: ALL autoscaler state lives on the event loop — the tick task,
spawn and retire all run there, like the router's sweep/probe machinery;
the only off-loop work is the factory call (on a worker thread: engine
construction streams weights and captures CUDA graphs while the other
replicas keep serving) and the host-tier migration (on the engines' own
threads). The engine-side objects it reads (SLO ledgers, metrics
counters) are locked by their owners.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque

from .metrics import ServingMetrics
from .router import ACTIVE

_DEADLINE_KEYS = ("met", "missed", "aborted")


class AutoScaler:
    def __init__(self, router, factory=None, *, min_replicas=1,
                 max_replicas=4, target_attainment=0.99,
                 interval_s=0.25, cooldown_s=3.0, up_streak=2,
                 down_streak=8, wait_high_s=0.5, wait_low_s=0.05,
                 min_window_events=4, spawn_ttft_budget_s=None,
                 drain_timeout_s=30.0, probe_prompt=None):
        """`router` is the `ReplicaRouter` to scale; `factory(index)`
        builds a ready-to-serve engine (default: the router's own
        factory) — for bounded spawns it should construct via
        ``LLMEngine(skeleton, checkpoint_path=..., warmup=True)``.
        ``spawn_ttft_budget_s`` (optional) is the decision-to-first-token
        bound: a spawn exceeding it is recorded as a breach
        (``autoscale_spawn_ttft_breaches``), never rolled back — slow
        capacity still beats no capacity."""
        self.router = router
        self.factory = factory if factory is not None else router.factory
        if self.factory is None:
            raise ValueError(
                "AutoScaler needs a replica factory — pass factory= here "
                "or construct the ReplicaRouter with one")
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.target_attainment = float(target_attainment)
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.up_streak = max(1, int(up_streak))
        self.down_streak = max(1, int(down_streak))
        self.wait_high_s = float(wait_high_s)
        self.wait_low_s = float(wait_low_s)
        self.min_window_events = max(1, int(min_window_events))
        self.spawn_ttft_budget_s = (None if spawn_ttft_budget_s is None
                                    else float(spawn_ttft_budget_s))
        self.drain_timeout_s = float(drain_timeout_s)
        self.probe_prompt = list(probe_prompt or [1, 2, 3])
        self.metrics = ServingMetrics()
        self.decisions = deque(maxlen=128)
        # event-loop-only control state (see module docstring)
        self._task = None
        self._busy = False          # a scale op is in flight
        self._cooldown_until = 0.0
        self._streak_up = 0
        self._streak_down = 0
        self._baseline = {}         # class key -> cumulative deadline counts
        self._update_gauges()

    # -- loop ---------------------------------------------------------------

    async def start(self):
        if self._task is None:
            self._task = asyncio.ensure_future(self._loop())
        return self

    async def stop(self):
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self):
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — a failed scale op
                # (factory crash, drain timeout) must not kill the loop:
                # record it, cool down, keep observing
                self._record("error", f"{type(e).__name__}: {e}", {})
                self._cooldown_until = (time.monotonic()
                                        + self.cooldown_s)
                self._busy = False

    async def tick(self):
        """One control-loop pass: read signals, update streaks, maybe
        scale. Public so tests (and a manual operator) can drive the
        loop synchronously without the timer."""
        now = time.monotonic()
        action, reason, sig = self.decide(now)
        self._update_gauges()
        if action == "up":
            await self._scale_up(reason, sig)
        elif action == "down":
            await self._scale_down(reason, sig)

    # -- signals + decision --------------------------------------------------

    def signals(self):
        """The control inputs, computed fresh: per-class WINDOWED
        deadline attainment (counts since the previous tick — the
        cumulative ledger would average an incident away) and the fleet's
        predicted-wait envelope."""
        active = [r for r in self.router.replicas if r.state == ACTIVE]
        ledgers = [r.engine.engine.slo for r in self.router.replicas
                   if r.engine.engine.slo is not None]
        worst, events = None, 0
        if ledgers:
            from .slo import SLOLedger

            merged = SLOLedger.merged_rollup(ledgers)
            cum = {}
            for c in merged["classes"]:
                key = (c["tenant"], c["priority"])
                cum[key] = {k: c["deadline"][k] for k in _DEADLINE_KEYS}
                base = self._baseline.get(key)
                if base is None or any(cum[key][k] < base[k]
                                       for k in _DEADLINE_KEYS):
                    # new class, or a retired replica's counts left the
                    # merge: re-baseline rather than read a bogus delta
                    continue
                d = {k: cum[key][k] - base[k] for k in _DEADLINE_KEYS}
                n = sum(d.values())
                events += n
                if n >= self.min_window_events:
                    att = d["met"] / n
                    if worst is None or att < worst:
                        worst = att
            self._baseline = cum
        waits = [self.router._predicted_wait(r) for r in active]
        return {
            "active": len(active),
            "replicas": len(self.router.replicas),
            "worst_attainment": worst,
            "window_events": events,
            "min_wait_s": round(min(waits), 4) if waits else 0.0,
            "max_wait_s": round(max(waits), 4) if waits else 0.0,
            "inflight": sum(r.engine.inflight for r in active),
        }

    def decide(self, now):
        """(action, reason, signals): ``("up", ...)``, ``("down", ...)``,
        or ``(None, ...)``. Pure control logic over `signals()` — the
        streak counters are the only state it advances — so the fast
        tests can drive it without an event loop."""
        sig = self.signals()
        if self._busy:
            return None, "scale op in flight", sig
        pressure = ((sig["worst_attainment"] is not None
                     and sig["worst_attainment"] < self.target_attainment)
                    or sig["min_wait_s"] > self.wait_high_s)
        idle = (sig["max_wait_s"] <= self.wait_low_s
                and (sig["worst_attainment"] is None
                     or sig["worst_attainment"] >= self.target_attainment))
        self._streak_up = self._streak_up + 1 if pressure else 0
        self._streak_down = self._streak_down + 1 if idle else 0
        if now < self._cooldown_until:
            return None, "cooldown", sig
        if (pressure and self._streak_up >= self.up_streak
                and sig["active"] < self.max_replicas):
            why = (f"attainment {sig['worst_attainment']} < "
                   f"{self.target_attainment}"
                   if sig["worst_attainment"] is not None
                   and sig["worst_attainment"] < self.target_attainment
                   else f"min predicted wait {sig['min_wait_s']}s > "
                        f"{self.wait_high_s}s")
            return "up", why, sig
        if (idle and self._streak_down >= self.down_streak
                and sig["active"] > self.min_replicas):
            return "down", (f"idle: max predicted wait {sig['max_wait_s']}s"
                            f" <= {self.wait_low_s}s"), sig
        return None, "steady", sig

    # -- actuation -----------------------------------------------------------

    async def _scale_up(self, reason, sig):
        self._busy = True
        t0 = time.monotonic()
        try:
            index = self.router.next_index()
            # factory off the event loop: streamed checkpoint load +
            # warmup block on device copies and CUDA-graph captures
            engine = await asyncio.to_thread(self.factory, index)
            replica = await self.router.add_replica(engine, index=index)
            ttft = await self._spawn_ttft(replica)
        finally:
            self._busy = False
        now = time.monotonic()
        self._cooldown_until = now + self.cooldown_s
        self._streak_up = self._streak_down = 0
        self.metrics.inc("autoscale_ups")
        self.metrics.observe_hist("autoscale_spawn_ttft_s", now - t0)
        detail = dict(sig, replica=replica.name,
                      spawn_s=round(now - t0, 3),
                      spawn_ttft_s=(None if ttft is None
                                    else round(ttft, 3)))
        if (ttft is not None and self.spawn_ttft_budget_s is not None
                and ttft > self.spawn_ttft_budget_s):
            self.metrics.inc("autoscale_spawn_ttft_breaches")
            detail["ttft_budget_breached"] = True
        self._record("up", reason, detail)
        self._update_gauges()

    async def _spawn_ttft(self, replica):
        """Decision-to-first-token proof: one tiny request against the
        just-spawned replica. A warm replica answers without a capture —
        this is the measured half of the spawn-TTFT bound (the warmup
        wave is the guaranteed half). Best-effort: a failed probe returns
        None and the replica stays in rotation (the sweep owns health)."""
        try:
            t0 = time.monotonic()
            st = replica.engine.submit(list(self.probe_prompt),
                                       max_new_tokens=1, temperature=0.0,
                                       tenant="_autoscale")
            async for _tok in st:
                return time.monotonic() - t0
            return None
        except Exception:  # noqa: BLE001 — measurement, not admission
            return None

    async def _scale_down(self, reason, sig):
        self._busy = True
        try:
            name = await self.router.retire_replica(
                drain_timeout_s=self.drain_timeout_s)
        finally:
            self._busy = False
        self._cooldown_until = time.monotonic() + self.cooldown_s
        self._streak_up = self._streak_down = 0
        self.metrics.inc("autoscale_downs")
        self._record("down", reason, dict(sig, replica=name))
        self._update_gauges()

    # -- observability -------------------------------------------------------

    def _record(self, action, reason, detail):
        row = {"t": round(time.monotonic(), 3), "action": action,
               "reason": reason, **detail}
        self.decisions.append(row)
        # every decision lands next to the steps it caused: the active
        # replicas' engine tracers get an `autoscale` supervisor instant
        for r in self.router.replicas:
            tr = getattr(r.engine.engine, "tracer", None)
            if tr is not None:
                tr.supervisor_instant("autoscale", args=row)

    def _update_gauges(self):
        self.metrics.set_gauge("autoscale_replicas",
                               float(len(self.router.replicas)))
        self.metrics.set_gauge("autoscale_min_replicas",
                               float(self.min_replicas))
        self.metrics.set_gauge("autoscale_max_replicas",
                               float(self.max_replicas))
        self.metrics.set_gauge("autoscale_streak_up",
                               float(self._streak_up))
        self.metrics.set_gauge("autoscale_streak_down",
                               float(self._streak_down))

    def snapshot(self):
        """The ``GET /debug/autoscale`` JSON: knobs, control state, and
        the bounded decision log."""
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "target_attainment": self.target_attainment,
            "interval_s": self.interval_s,
            "cooldown_s": self.cooldown_s,
            "up_streak": self.up_streak,
            "down_streak": self.down_streak,
            "wait_high_s": self.wait_high_s,
            "wait_low_s": self.wait_low_s,
            "spawn_ttft_budget_s": self.spawn_ttft_budget_s,
            "busy": self._busy,
            "cooldown_remaining_s": round(
                max(0.0, self._cooldown_until - time.monotonic()), 3),
            "streaks": {"up": self._streak_up, "down": self._streak_down},
            "replicas": len(self.router.replicas),
            "decisions": list(self.decisions),
        }
