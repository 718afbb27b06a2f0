"""Serving SLO ledger: per-request latency attribution + per-class accounting.

Aggregate metrics (serving/metrics.py) can say *that* p95 TTFT spiked;
the lifecycle tracer (serving/trace.py) can show *one* request's timeline
— but neither answers the operator question "where does a slow request's
time go, per tenant, right now?". The ledger answers it with a
**phase clock** on every request: at each lifecycle transition the
current phase closes (its wall time accumulates into ``req.phases``) and
the next opens, so the decomposition telescopes — *the phase durations
sum to the request's end-to-end wall time exactly*, whatever interleaving
of preemptions, faults, and recoveries ran (tests/test_serving_slo.py
enforces it under chaos). The phases are exhaustive and non-overlapping:

- ``queued``          — arrival -> first admission (and nothing else:
  post-preemption waits are ``preempted``/``stalled``);
- ``prefill_compute`` — admitted with >1 pending token: prompt chunks
  (or a post-preemption replay) streaming into the KV arena;
- ``decode_compute``  — one pending token: steady-state decoding (opens
  at admission for decode re-admissions, or at the first emitted token);
- ``preempted``       — preempt-by-recompute round trips: blocks gone,
  waiting to be re-admitted for replay;
- ``stalled``         — failure-boundary time: from a raising step or a
  watchdog trip until re-admission/abort (supervisor recovery, bisection
  probes the request sat out, hung-step wait);
- ``emit``            — final-token bookkeeping (finish, block release/
  publish, terminal logging).

Requests carry optional ``tenant`` and ``priority`` dimensions
(`add_request`/`submit`/``/v1/completions``), and the ledger rolls every
finalized request up per (tenant, priority) class: p50/p95 TTFT, **TPOT**
(inter-token latency, first -> last emitted token over n-1 gaps),
tokens/s, preemption share, phase totals, and **deadline attainment**
against the request's ``deadline_s`` (the frontend stamps its
``timeout_s`` there): ``met`` (finished in time), ``missed`` (finished
late, or aborted by the deadline), ``aborted`` (any other abort).

Exports, all derived from the SAME finalize call so they can never
disagree on the same traffic:

- `rollup()` — the ``GET /debug/slo`` JSON (per-class and total);
- cumulative **Prometheus histograms** ``slo_ttft_seconds`` /
  ``slo_tpot_seconds`` / ``slo_e2e_seconds`` labeled
  ``{tenant, priority}`` plus labeled counters (``slo_requests``,
  ``slo_output_tokens``, ``slo_phase_seconds`` by phase,
  ``slo_deadline_met/missed/aborted``) on ``/metrics`` — true unbounded
  histograms, not the bounded-window summaries;
- the per-request decomposition on the request-log JSON line
  (``phase_<name>_ms`` fields) and in postmortem bundles.

Off by default (``PADDLE_TPU_SLO=1`` / ``LLMEngine(slo=True)``): when
off, ``engine.slo`` is None and every hook site is one pointer test —
the disabled serve is byte-identical. The ledger rides along whenever
the request log or the flight recorder is on (both embed the
decomposition). Label cardinality is bounded: past ``max_classes``
distinct (tenant, priority) pairs, new classes fold into ``_other``.
"""
from __future__ import annotations

import threading
import time

from .metrics import _quantile

# The exhaustive, non-overlapping phase vocabulary. The request-log line
# derives its phase_<name>_ms fields from THIS tuple and the schema test
# asserts against it, so the line and the ledger cannot drift.
PHASES = ("queued", "prefill_compute", "decode_compute", "preempted",
          "stalled", "emit")


def class_key(req):
    """The (tenant, priority) accounting class of a request; unset
    dimensions read "-" so every class is visible in label values."""
    return ("-" if req.tenant is None else req.tenant,
            "-" if req.priority is None else req.priority)


def decompose(req):
    """{phase: ms} over the full vocabulary (0.0 for phases the request
    never entered). Valid mid-flight and after finalize — the flight
    recorder uses it on victims in any state."""
    return {p: round(req.phases.get(p, 0.0) * 1e3, 3) for p in PHASES}


def _new_class():
    return {
        "requests": 0, "finished": 0, "aborted": 0, "preemptions": 0,
        "output_tokens": 0, "e2e_total_s": 0.0,
        "phase_s": {p: 0.0 for p in PHASES},
        "deadline": {"met": 0, "missed": 0, "aborted": 0},
        "ttft": [], "tpot": [], "e2e": [],
        "t_first": None, "t_last": None,
    }


def _pct_ms(window):
    if not window:
        return {"count": 0, "p50": None, "p95": None}
    s = sorted(window)
    return {"count": len(s),
            "p50": round(s[len(s) // 2] * 1e3, 3),
            "p95": round(_quantile(s, 95) * 1e3, 3)}


class SLOLedger:
    """Per-request phase clock + per-class rollups for one engine.

    The engine thread drives `begin`/`transition`/`finalize`; the
    supervisor's watchdog path may transition from its own thread while
    the engine thread is wedged inside a step, and a hung step returning
    right at the watchdog timeout makes the two genuinely concurrent —
    so every phase-clock close+open runs under the ledger lock (a few
    LIFECYCLE transitions per request, never per step or per token).
    `rollup` may be called from any thread (the HTTP event loop); the
    same lock covers the per-class aggregates.
    """

    def __init__(self, metrics=None, window=2048, max_classes=64):
        self.metrics = metrics
        self.window = max(16, int(window))
        self.max_classes = max(1, int(max_classes))
        self._lock = threading.Lock()
        self._classes = {}

    # -- phase clock (engine/scheduler/supervisor hook sites) --------------

    def begin(self, req):
        """Open the clock at arrival: the ``queued`` phase starts at
        ``arrival_time`` (set in Request.__init__, so frontend command-
        queue transit is queued time too)."""
        req.phases = {}
        req.phase = "queued"
        req.phase_since = req.arrival_time

    def transition(self, req, phase, now=None):
        """Close the current phase into ``req.phases`` and open `phase`.
        No-op for requests the ledger never began (or already finalized).
        Durations are deliberately NOT clamped at zero: the telescoping
        sum equals e2e wall time exactly only if every segment keeps its
        sign. Runs under the ledger lock: the watchdog thread re-labels
        phases while the engine thread is wedged inside a step, and if
        the step returns right at the timeout both threads touch the
        same clock — the lock keeps each close+open atomic so the
        telescoping sum survives that window."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if req.phase is None:
                return
            req.phases[req.phase] = (
                req.phases.get(req.phase, 0.0) + (now - req.phase_since))
            req.phase = phase
            req.phase_since = now

    def finalize(self, req, reason, now=None):
        """Close the clock (finish AND abort funnel here, exactly once
        per request), classify the deadline verdict, fold the request
        into its class rollup, and emit the labeled histogram/counter
        observations. Returns the per-request summary (also stored as
        ``req.slo_summary`` for the request log / flight recorder)."""
        if now is None:
            now = time.monotonic()
        n_out = len(req.output_ids)
        tpot = None
        with self._lock:
            # clock close is under the same lock as transition(): the
            # watchdog may be re-labeling this request's phase while the
            # engine thread finalizes it (hung step returning right at
            # the timeout)
            if req.phase is None:
                return getattr(req, "slo_summary", None)
            if req.first_token_time is not None and n_out >= 2:
                # the "emit" transition timestamp IS the last token's
                # emission; an abort mid-decode falls back to the abort
                # time
                t_last = req.phase_since if req.phase == "emit" else now
                tpot = (t_last - req.first_token_time) / (n_out - 1)
            req.phases[req.phase] = (
                req.phases.get(req.phase, 0.0) + (now - req.phase_since))
            req.phase = None
        e2e = now - req.arrival_time
        ttft = (None if req.first_token_time is None
                else req.first_token_time - req.arrival_time)
        verdict = None
        if req.deadline_s is not None:
            if reason == "finished":
                verdict = "met" if e2e <= req.deadline_s else "missed"
            elif reason == "timeout":
                verdict = "missed"
            else:
                verdict = "aborted"
        summary = {
            "reason": reason, "deadline": verdict,
            "e2e_s": e2e, "ttft_s": ttft, "tpot_s": tpot,
            "phases_ms": decompose(req),
        }
        req.slo_summary = summary
        key = class_key(req)
        with self._lock:
            c = self._classes.get(key)
            if c is None:
                if len(self._classes) >= self.max_classes:
                    # cardinality bound: /metrics label sets (and this
                    # dict) must not grow with adversarial tenant churn
                    key = ("_other", "_other")
                    c = self._classes.get(key)
                if c is None:
                    c = self._classes[key] = _new_class()
            c["requests"] += 1
            c["finished" if reason == "finished" else "aborted"] += 1
            c["preemptions"] += req.preemptions
            c["output_tokens"] += n_out
            c["e2e_total_s"] += e2e
            for p in PHASES:
                c["phase_s"][p] += req.phases.get(p, 0.0)
            if verdict is not None:
                c["deadline"][verdict] += 1
            for name, v in (("ttft", ttft), ("tpot", tpot), ("e2e", e2e)):
                if v is None:
                    continue
                c[name].append(v)
                if len(c[name]) > self.window:
                    del c[name][: -self.window]
            c["t_first"] = (req.arrival_time if c["t_first"] is None
                            else min(c["t_first"], req.arrival_time))
            c["t_last"] = now if c["t_last"] is None else max(c["t_last"],
                                                              now)
            m = self.metrics
            if m is not None:
                labels = {"tenant": key[0], "priority": key[1]}
                m.observe_hist("slo_e2e_seconds", e2e, labels)
                if ttft is not None:
                    m.observe_hist("slo_ttft_seconds", ttft, labels)
                if tpot is not None:
                    m.observe_hist("slo_tpot_seconds", tpot, labels)
                m.inc_labeled("slo_requests", labels)
                if n_out:
                    m.inc_labeled("slo_output_tokens", labels, n_out)
                if verdict is not None:
                    m.inc_labeled(f"slo_deadline_{verdict}", labels)
                for p in PHASES:
                    v = req.phases.get(p, 0.0)
                    if v > 0.0:
                        m.inc_labeled("slo_phase_seconds",
                                      dict(labels, phase=p), v)
        return summary

    # -- export -------------------------------------------------------------

    @staticmethod
    def _entry(tenant, priority, c):
        dl = dict(c["deadline"])
        denom = dl["met"] + dl["missed"] + dl["aborted"]
        dl["attainment"] = round(dl["met"] / denom, 4) if denom else None
        span = (None if c["t_first"] is None or c["t_last"] is None
                else max(c["t_last"] - c["t_first"], 1e-9))
        e2e_total = c["e2e_total_s"]
        return {
            "tenant": tenant, "priority": priority,
            "requests": c["requests"], "finished": c["finished"],
            "aborted": c["aborted"], "preemptions": c["preemptions"],
            "output_tokens": c["output_tokens"],
            # class throughput over its first-arrival..last-finish span
            "tokens_per_s": (None if span is None else
                             round(c["output_tokens"] / span, 3)),
            # share of the class's request wall time spent preempted
            # (stalled has its own phase total in phases_ms)
            "preemption_share": (
                round(c["phase_s"]["preempted"] / e2e_total, 4)
                if e2e_total > 0 else 0.0),
            "ttft_ms": _pct_ms(c["ttft"]),
            "tpot_ms": _pct_ms(c["tpot"]),
            "e2e_ms": _pct_ms(c["e2e"]),
            "phases_ms": {p: round(c["phase_s"][p] * 1e3, 3)
                          for p in PHASES},
            "deadline": dl,
        }

    def _snapshot_classes(self):
        """Deep-copied ``[(class_key, aggregates)]`` under the lock — the
        one snapshot `rollup` and `merged_rollup` both build from."""
        with self._lock:
            return [(k, {
                **{f: c[f] for f in ("requests", "finished", "aborted",
                                     "preemptions", "output_tokens",
                                     "e2e_total_s", "t_first", "t_last")},
                "phase_s": dict(c["phase_s"]),
                "deadline": dict(c["deadline"]),
                "ttft": list(c["ttft"]), "tpot": list(c["tpot"]),
                "e2e": list(c["e2e"]),
            }) for k, c in self._classes.items()]

    @classmethod
    def _rollup_from_snapshot(cls, snap):
        total = _new_class()
        for _, c in snap:
            for f in ("requests", "finished", "aborted", "preemptions",
                      "output_tokens", "e2e_total_s"):
                total[f] += c[f]
            for p in PHASES:
                total["phase_s"][p] += c["phase_s"][p]
            for v in ("met", "missed", "aborted"):
                total["deadline"][v] += c["deadline"][v]
            for w in ("ttft", "tpot", "e2e"):
                total[w].extend(c[w])
            for t, pick in (("t_first", min), ("t_last", max)):
                if c[t] is not None:
                    total[t] = (c[t] if total[t] is None
                                else pick(total[t], c[t]))
        return {
            "phases": list(PHASES),
            "classes": [cls._entry(k[0], k[1], c)
                        for k, c in sorted(snap)],
            "total": cls._entry("*", "*", total),
        }

    def rollup(self):
        """The ``GET /debug/slo`` JSON: one entry per (tenant, priority)
        class plus a ``total`` aggregate, all from the same finalize
        stream the ``slo_*`` Prometheus series are built on. Percentiles
        use the bounded recent window (`window` per class, the
        metrics.py convention); the histograms are cumulative — the two
        agree on quiesced traffic and the tests lock the bracket."""
        return self._rollup_from_snapshot(self._snapshot_classes())

    @classmethod
    def merged_rollup(cls, ledgers):
        """One fleet rollup over several replicas' ledgers — the router's
        ``GET /debug/slo``. Each ledger is snapshotted under its own lock;
        same-class aggregates merge by summing counters and concatenating
        the percentile windows (merged percentiles come from the pooled
        observations: per-replica p95s cannot be averaged), and the result
        has exactly `rollup`'s shape, so a dashboard reading one replica
        reads the fleet unchanged."""
        merged = {}
        for ledger in ledgers:
            for k, c in ledger._snapshot_classes():
                t = merged.get(k)
                if t is None:
                    merged[k] = c
                    continue
                for f in ("requests", "finished", "aborted", "preemptions",
                          "output_tokens", "e2e_total_s"):
                    t[f] += c[f]
                for p in PHASES:
                    t["phase_s"][p] += c["phase_s"][p]
                for v in ("met", "missed", "aborted"):
                    t["deadline"][v] += c["deadline"][v]
                for w in ("ttft", "tpot", "e2e"):
                    t[w].extend(c[w])
                for tk, pick in (("t_first", min), ("t_last", max)):
                    if c[tk] is not None:
                        t[tk] = (c[tk] if t[tk] is None
                                 else pick(t[tk], c[tk]))
        return cls._rollup_from_snapshot(sorted(merged.items()))

    def reset(self):
        """Drop the per-class aggregates (e.g. after a bench warmup) —
        the cumulative Prometheus series are NOT rewound (scrapers
        require monotonic counters); only the rollup restarts."""
        with self._lock:
            self._classes = {}
