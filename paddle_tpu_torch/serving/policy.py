"""Multi-tenant scheduling policy: priority classes, tenant fairness,
deadline-aware early rejection.

Without a policy the scheduler (serving/scheduler.py) is strictly FCFS:
admission pops the waiting queue left-to-right, planning walks
``arrival_seq``, and a dry pool preempts the arrival-youngest holder. That
is the right default for a single tenant, and it stays the default — an
engine built without a policy is byte-identical to the FCFS engine. This
module is the pluggable layer between admission and the step planner that
ROADMAP item 4 asks for, with three orthogonal mechanisms:

- **Priority classes with strict ordering.** ``priorities`` names the
  classes highest-first (e.g. ``("interactive", "standard", "batch")``);
  a request's ``priority`` label maps to its rank (unknown/None ranks
  below every named class). A request's static **precedence** is
  ``(rank, arrival_seq)`` — priority first, FCFS age within a class.
  Precedence replaces raw arrival age everywhere the scheduler compares
  requests: admission order, planning order, preemption eligibility
  (strictly-lower precedence may be preempted, never a peer or better —
  which preserves the scheduler's no-livelock guarantee exactly as FCFS
  age did: the top-precedence running request can always grow or fails
  loudly as a config error).

- **Per-tenant token-rate fairness.** Every row a tenant's requests feed
  through the device (prefill chunks + emitted/accepted tokens —
  compute actually consumed, not just emissions) is noted into a sliding
  ``fairness_window_s`` window. Within a priority class, admission picks
  the tenant with the LEAST windowed served tokens first, and a dry pool
  preempts the eligible victim whose tenant has the MOST (ties broken
  arrival-youngest — the FCFS victim rule, fairness-weighted). A
  bursting tenant therefore pays for its own burst: its requests queue
  behind lighter tenants at equal priority and its sequences are the
  first reclaimed, but it is never starved outright — once its windowed
  share drains below the others it admits again. Tenant cardinality is
  bounded (``max_tenants``): excess tenants fold into one ``"_other"``
  bucket so an adversarial tenant-per-request stream cannot grow the
  accounting without bound.

- **Deadline-aware early rejection.** At lane admission the policy
  predicts the request's completion time from an EWMA of recent step
  wall time (one decode step ≈ one token per running sequence; prefill
  ≈ ``ceil(pending / prefill_chunk)`` chunked steps). A request whose
  prediction already overshoots its remaining ``deadline_s`` is rejected
  THERE — before it occupies a lane, evicts cached blocks, or preempts
  anyone (reject-early beats miss-SLO).
  The engine surfaces it as an aborted request with reason
  ``policy_reject:deadline_unattainable`` on the same channel as
  non-finite containment, so frontend consumers get a terminal event,
  not silence. Until ``min_samples`` steps have been observed the
  predictor abstains (no rejections off a cold estimate).

Observability: `snapshot()` renders the live per-class queue depths and
windowed shares for ``/healthz``'s pool dict and ``/debug/slo``; the
engine exports the same numbers as labeled gauges
(``policy_queue_depth``, ``policy_served_share``) plus the
``policy_preemptions`` / ``policy_early_rejections`` labeled counters on
``/metrics`` (serving/metrics.py `inc_labeled` / `set_labeled_gauge`).
"""
from __future__ import annotations

import time
from collections import deque

# the fold bucket for tenants beyond max_tenants — same bounded-
# cardinality discipline as the SLO ledger's class fold
OTHER = "_other"

EARLY_REJECT_REASON = "policy_reject:deadline_unattainable"


class SchedulingPolicy:
    """Pluggable admission/preemption policy for the continuous-batching
    scheduler. Pass to ``LLMEngine(policy=...)`` (an instance, ``True``
    for defaults, or a kwargs dict); None keeps the FCFS engine
    byte-identical. Host-side only — nothing here touches a compiled
    program or a device array."""

    def __init__(self, priorities=("interactive", "standard", "batch"),
                 fairness_window_s=30.0, max_tenants=64,
                 deadline_early_reject=True, ewma_alpha=0.3,
                 min_samples=4, assumed_step_s=None):
        self.priorities = tuple(str(p) for p in (priorities or ()))
        self._rank = {p: i for i, p in enumerate(self.priorities)}
        self.fairness_window_s = float(fairness_window_s)
        if self.fairness_window_s <= 0:
            raise ValueError("fairness_window_s must be > 0")
        self.max_tenants = max(1, int(max_tenants))
        self.deadline_early_reject = bool(deadline_early_reject)
        self.ewma_alpha = float(ewma_alpha)
        self.min_samples = int(min_samples)
        # tenant -> deque[(monotonic_t, tokens)] inside the window
        self._served = {}
        # EWMA of step wall time; `assumed_step_s` seeds it (tests and
        # cold replicas that want rejection before min_samples warm it)
        self._step_ewma = (None if assumed_step_s is None
                           else float(assumed_step_s))
        self._step_samples = 0 if assumed_step_s is None else min_samples
        # counters mirrored into snapshot() (the engine owns the
        # /metrics export; these make the policy self-describing in unit
        # tests that run a bare scheduler)
        self.early_rejections = 0
        self.policy_preemptions = 0

    # -- priority ----------------------------------------------------------

    def rank(self, req):
        """0 = highest named class; unknown/None priorities rank below
        every named class (len(priorities))."""
        return self._rank.get(req.priority, len(self.priorities))

    def precedence(self, req):
        """The static total order replacing raw arrival age: priority
        class first, FCFS arrival within a class. SMALLER tuples are
        stronger. Static per request (labels are immutable after
        construction), so the scheduler's no-livelock argument carries
        over: the minimum-precedence running request can preempt every
        other holder and therefore always grows or fails loudly."""
        return (self.rank(req), req.arrival_seq)

    # -- tenant fairness ---------------------------------------------------

    def _tenant_key(self, tenant):
        if tenant is None:
            tenant = "-"
        if tenant in self._served:
            return tenant
        if len(self._served) >= self.max_tenants:
            return OTHER
        return tenant

    def note_served(self, req, tokens, now=None):
        """Charge `tokens` device work to the request's tenant window.
        The engine calls this once per planned row per step with the
        row's fed chunk width + accepted speculative tokens."""
        if tokens <= 0:
            return
        now = time.monotonic() if now is None else now
        key = self._tenant_key(req.tenant)
        dq = self._served.get(key)
        if dq is None:
            dq = self._served[key] = deque()
        dq.append((now, int(tokens)))

    def _prune(self, now):
        horizon = now - self.fairness_window_s
        for key in list(self._served):
            dq = self._served[key]
            while dq and dq[0][0] < horizon:
                dq.popleft()
            if not dq and key != OTHER:
                del self._served[key]

    def served_tokens(self, tenant, now=None):
        """Tokens this tenant consumed inside the sliding window."""
        now = time.monotonic() if now is None else now
        self._prune(now)
        dq = self._served.get(self._tenant_key(tenant))
        return sum(n for _, n in dq) if dq else 0

    def served_shares(self, now=None):
        """{tenant: windowed fraction of total served tokens} — the
        number the fairness bench asserts a floor on. Empty when nothing
        was served inside the window."""
        now = time.monotonic() if now is None else now
        self._prune(now)
        totals = {k: sum(n for _, n in dq)
                  for k, dq in self._served.items() if dq}
        total = sum(totals.values())
        if not total:
            return {}
        return {k: v / total for k, v in totals.items()}

    # -- admission ordering ------------------------------------------------

    def admission_key(self, req, now=None):
        """Sort key for pulling the next request out of the waiting
        queue: priority class first, then LEAST windowed tenant
        consumption (the fairness half), then FCFS age."""
        return (self.rank(req), self.served_tokens(req.tenant, now),
                req.arrival_seq)

    # -- preemption victim selection ---------------------------------------

    def select_victim(self, running, req):
        """The sequence `req` may reclaim a block from when the pool is
        dry, or None when nothing is eligible. Eligible = strictly lower
        precedence than `req` (never a peer or better — the no-livelock
        rule) and currently holding blocks. Among eligibles the victim
        is the one whose tenant consumed the MOST windowed tokens, ties
        broken arrival-youngest (the FCFS rule, fairness-weighted)."""
        mine = self.precedence(req)
        now = time.monotonic()
        eligible = [r for r in running
                    if self.precedence(r) > mine and r.blocks]
        if not eligible:
            return None
        return max(eligible,
                   key=lambda r: (self.served_tokens(r.tenant, now),
                                  r.arrival_seq))

    # -- deadline prediction -----------------------------------------------

    def observe_step(self, seconds):
        """Feed one step's wall time into the EWMA the deadline
        predictor runs on (the engine calls this after every step)."""
        s = float(seconds)
        if self._step_ewma is None:
            self._step_ewma = s
        else:
            a = self.ewma_alpha
            self._step_ewma = a * s + (1.0 - a) * self._step_ewma
        self._step_samples += 1

    def predicted_serve_s(self, req, prefill_chunk):
        """Predicted wall time to finish `req` from its CURRENT state:
        chunked-prefill steps for what is still pending plus one decode
        step per remaining token. None while the EWMA is cold."""
        if self._step_ewma is None or self._step_samples < self.min_samples:
            return None
        chunks = -(-max(req.num_pending - 1, 0) // max(1, int(prefill_chunk)))
        return (chunks + max(req.remaining_new_tokens(), 1)) * self._step_ewma

    def early_reject(self, req, prefill_chunk, now=None):
        """``EARLY_REJECT_REASON`` when `req`'s predicted completion
        already overshoots its remaining deadline, else None. Deadline-
        less requests and cold predictors never reject."""
        if not self.deadline_early_reject or req.deadline_s is None:
            return None
        predicted = self.predicted_serve_s(req, prefill_chunk)
        if predicted is None:
            return None
        now = time.monotonic() if now is None else now
        remaining = req.deadline_s - (now - req.arrival_time)
        if predicted > remaining:
            self.early_rejections += 1
            return EARLY_REJECT_REASON
        return None

    # -- observability -----------------------------------------------------

    def class_labels(self, req):
        """The (tenant, priority) label dict the engine stamps on the
        policy's labeled counters — the SLO ledger's class convention
        (None reads "-"), tenant folded at the cardinality cap."""
        return {"tenant": self._tenant_key(req.tenant),
                "priority": req.priority if req.priority is not None
                else "-"}

    def snapshot(self, waiting=(), running=(), now=None):
        """JSON-able policy state for /healthz's pool dict and
        /debug/slo: per-class queue depth, windowed served-token shares,
        the step-time estimate, and the reject/preempt totals."""
        now = time.monotonic() if now is None else now
        depth = {}
        for req in waiting:
            lbl = (self._tenant_key(req.tenant),
                   req.priority if req.priority is not None else "-")
            depth["/".join(lbl)] = depth.get("/".join(lbl), 0) + 1
        return {
            "priorities": list(self.priorities),
            "fairness_window_s": self.fairness_window_s,
            "queue_depth": depth,
            "served_share": {k: round(v, 4)
                             for k, v in self.served_shares(now).items()},
            "running": len(tuple(running)),
            "step_ewma_ms": (None if self._step_ewma is None
                             else round(self._step_ewma * 1e3, 3)),
            "early_rejections": self.early_rejections,
            "policy_preemptions": self.policy_preemptions,
        }


def as_policy(policy):
    """Coerce ``LLMEngine(policy=...)``'s accepted forms — None (FCFS,
    the byte-identical default), True (defaults), a kwargs dict, or a
    SchedulingPolicy instance — to a SchedulingPolicy or None."""
    if policy is None or policy is False:
        return None
    if policy is True:
        return SchedulingPolicy()
    if isinstance(policy, dict):
        return SchedulingPolicy(**policy)
    if isinstance(policy, SchedulingPolicy):
        return policy
    raise ValueError(
        f"policy must be None, True, a kwargs dict, or a SchedulingPolicy "
        f"— got {type(policy).__name__}")
