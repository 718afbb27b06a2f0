"""Replica lifecycle: the explicit birth-to-death state machine of one
serving engine.

Without it an engine is born implicitly: weights appear wherever the
model happens to live, the first real request pays every width bucket's
program build inside its own TTFT, and a caller can only infer "still
warming" from a trial request timing out. `ReplicaLifecycle` makes the
phases explicit and observable:

    cold -> loading -> warm -> serving <-> draining -> stopped

- **cold**: the engine object exists; no weights placed.
- **loading**: weights are being placed (streamed from a checkpoint or
  device_put from the eager model) and — when the engine was built with
  ``warmup=True`` — every width-bucket program is being compiled by the
  synthetic warmup wave (`LLMEngine.warmup`).
- **warm**: weights placed; with ``warmup`` the full program table is
  compiled, so the first served step is guaranteed 0 retraces
  (``lifecycle.warmed`` records which; tests assert via the `jit_traces`
  sentinel). Not yet admitting.
- **serving**: `AsyncLLMEngine.start()` / `resume_admitting()` — the
  ONLY state in which the engine admits traffic.
- **draining**: admission closed (`stop_admitting`, watchdog trip);
  in-flight work finishes. `resume_admitting()` returns to serving (the
  restartless drain path).
- **stopped**: terminal — engine thread exited (shutdown, crash). There
  is exactly one terminal state and no edge leaves it.

Transitions are validated against `LEGAL` (an illegal hop raises
`LifecycleError` — a serving engine can never "skip back" to cold),
recorded with timestamps in `history`, and surfaced on ``/healthz``
(payload ``lifecycle``) and ``/metrics`` (``lifecycle_state`` gauge +
``lifecycle`` info series).

Thread model: transitions happen on whichever thread drives the phase
(constructor thread during load/warmup, event loop for serving/draining,
engine thread for the crash path), so the tiny state word is guarded by
its own lock — a leaf in the lock order (nothing is acquired while
holding it), covered by the runtime witness like every other lock node.
"""
from __future__ import annotations

import threading
import time

COLD, LOADING, WARM, SERVING, DRAINING, STOPPED = (
    "cold", "loading", "warm", "serving", "draining", "stopped")

STATES = (COLD, LOADING, WARM, SERVING, DRAINING, STOPPED)

# every legal edge; anything else raises. draining -> serving is the one
# backward edge (resume_admitting / restartless rolling drain); stopped
# is terminal by construction (no outgoing edges).
LEGAL = {
    COLD: (LOADING, STOPPED),
    LOADING: (WARM, STOPPED),
    WARM: (SERVING, DRAINING, STOPPED),
    SERVING: (DRAINING, STOPPED),
    DRAINING: (SERVING, STOPPED),
    STOPPED: (),
}


class LifecycleError(RuntimeError):
    """An illegal lifecycle transition was attempted."""


class ReplicaLifecycle:
    def __init__(self, metrics=None, history_cap=64):
        self._lock = threading.Lock()
        self._state = COLD
        self._metrics = metrics
        self._history_cap = int(history_cap)
        self._history = [(COLD, time.monotonic(), None)]
        # warmed: the synthetic warmup wave compiled the FULL width-bucket
        # program table (LLMEngine.warmup) — the 0-retrace guarantee the
        # lifecycle tests assert
        self.warmed = False
        self.programs_compiled = 0
        self._gauge()

    # -- transitions --------------------------------------------------------

    def to(self, state, reason=None):
        """Transition to `state`. Same-state is an idempotent no-op
        (returns False); an illegal edge raises `LifecycleError`. Returns
        True when the state actually changed."""
        if state not in STATES:
            raise LifecycleError(f"unknown lifecycle state {state!r}")
        with self._lock:
            cur = self._state
            if state == cur:
                return False
            if state not in LEGAL[cur]:
                raise LifecycleError(
                    f"illegal lifecycle transition {cur} -> {state}"
                    + (f" ({reason})" if reason else "")
                )
            self._state = state
            self._history.append((state, time.monotonic(), reason))
            if len(self._history) > self._history_cap:
                del self._history[0]
        self._gauge()
        return True

    # -- reads --------------------------------------------------------------

    @property
    def state(self):
        with self._lock:
            return self._state

    def is_(self, *states):
        with self._lock:
            return self._state in states

    @property
    def terminal(self):
        return self.state == STOPPED

    def transitions(self):
        """The observed (from, to) edge list — what the soak test checks
        for monotonicity (every edge legal, exactly one terminal)."""
        with self._lock:
            h = list(self._history)
        return [(h[i][0], h[i + 1][0]) for i in range(len(h) - 1)]

    def snapshot(self):
        with self._lock:
            state = self._state
            hist = [{"state": s, "t": round(t, 3), "reason": r}
                    for s, t, r in self._history[-8:]]
        return {
            "state": state,
            "warmed": self.warmed,
            "programs_compiled": self.programs_compiled,
            "history": hist,
        }

    def _gauge(self):
        if self._metrics is None:
            return
        self._metrics.set_gauge("lifecycle_state",
                                float(STATES.index(self._state)))
        self._metrics.set_info("lifecycle", {"state": self._state})
