"""Shared ring-buffered Chrome/Perfetto trace-event recorder.

`Tracer` is the substrate the serving tracer (`serving.trace.EngineTracer`)
builds on: a bounded ring of trace events behind a lock (any thread may
export mid-run), a monotonic epoch, span/instant emitters, step-id
allocation, and the Perfetto-loadable `chrome_trace()`/`dump()` export. It
knows nothing about requests or batches — producers subclass it and name
their own tracks.

**Device-capture join**: every traced serve step dispatch runs under a
`torch.profiler.record_function` range named ``paddle_tpu.step <id>``
(`STEP_ANNOTATION_PREFIX`) carrying the SAME id as the host span, so a
torch-profiler trace of the card lines up against the host ``step[kind]``
spans by name.

**Off by default, free when off**: ``PADDLE_TPU_TRACE`` (an on/off switch
or a request sampling fraction) turns tracing on, ``PADDLE_TPU_TRACE_BUF``
bounds the ring (default 65536 events); every hook site is a single
``if tr is not None`` pointer test.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

# The device-capture join key: host step spans and the profiler range
# wrapping the matching device dispatch share "paddle_tpu.step <id>".
STEP_ANNOTATION_PREFIX = "paddle_tpu.step "


def trace_sample_from_env(env="PADDLE_TPU_TRACE"):
    """The PADDLE_TPU_TRACE knob as a sampling fraction: unset/falsy -> 0.0
    (tracing off), truthy -> 1.0, a float string -> that fraction of
    requests (clamped to [0, 1]; step spans are always on while > 0)."""
    v = os.environ.get(env, "").strip().lower()
    if v in ("", "0", "0.0", "false", "off", "no"):
        return 0.0
    try:
        f = float(v)
    except ValueError:
        return 1.0
    return min(max(f, 0.0), 1.0)


def trace_capacity_from_env(env="PADDLE_TPU_TRACE_BUF", default=65536):
    try:
        cap = int(os.environ.get(env, "") or default)
    except ValueError:
        cap = default
    return max(16, cap)


class Tracer:
    """Bounded trace-event recorder: the generic core.

    All timestamps come from ``time.monotonic()`` — one clock per process,
    so spans from different producers (and the metrics built on the same
    clock) agree by construction. The producing thread is the only writer;
    `chrome_trace()` may be called from any thread mid-run — a lock covers
    the ring append and the export snapshot, because iterating a deque
    that another thread is appending to raises RuntimeError.

    Memory is bounded by the ring (`capacity` events): a long-running
    producer overwrites its oldest events instead of growing. Track
    metadata (`self._meta`, filled by subclasses) lives OUTSIDE the ring
    so track names survive after the events that created them wrapped.
    """

    producer = "paddle_tpu_torch.profiler.tracing"

    def __init__(self, capacity=65536, sample=1.0):
        self.capacity = int(capacity)
        self.sample = float(sample)
        self.events = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.epoch = time.monotonic()
        self.dropped = 0          # events overwritten by the ring
        self._step_id = 0
        self._meta = []           # subclass-provided track metadata events

    # -- low-level event plumbing -----------------------------------------

    @staticmethod
    def _meta_ev(name, pid, tid, args):
        return {"name": name, "ph": "M", "pid": pid, "tid": tid,
                "ts": 0, "args": args}

    def ts(self, t):
        """monotonic seconds -> trace microseconds."""
        return (t - self.epoch) * 1e6

    def _push(self, ev):
        with self._lock:
            if len(self.events) == self.capacity:
                self.dropped += 1
            self.events.append(ev)

    def complete(self, name, pid, tid, start, end, args=None):
        """One 'X' (complete) span from monotonic `start` to `end`."""
        ev = {"name": name, "ph": "X", "pid": pid, "tid": tid,
              "ts": round(self.ts(start), 3),
              "dur": round(max(end - start, 0.0) * 1e6, 3)}
        if args:
            ev["args"] = args
        self._push(ev)

    def instant(self, name, pid, tid, t=None, args=None):
        ev = {"name": name, "ph": "i", "s": "t", "pid": pid, "tid": tid,
              "ts": round(self.ts(time.monotonic() if t is None else t), 3)}
        if args:
            ev["args"] = args
        self._push(ev)

    # -- step ids + phased spans -------------------------------------------

    def next_step_id(self):
        sid = self._step_id
        self._step_id += 1
        return sid

    def step_annotation(self, step_id):
        """Name for the `torch.profiler.record_function` range wrapping
        this step's device dispatch — the join key between this host trace
        and a torch-profiler capture of the card."""
        return f"{STEP_ANNOTATION_PREFIX}{step_id}"

    def phased_span(self, name, pid, tid, step_id, phases, phase_order,
                    args=None):
        """Emit one parent span covering min(start)..max(end) of `phases`
        ({phase: (start, end)} in monotonic seconds) plus one child span
        per phase in `phase_order`; parent and children all carry the
        step id so a join/sort never depends on timestamps."""
        s0 = min(t0 for t0, _ in phases.values())
        s1 = max(t1 for _, t1 in phases.values())
        a = {"step": step_id}
        if args:
            a.update(args)
        self.complete(name, pid, tid, s0, s1, a)
        for ph in phase_order:
            if ph in phases:
                t0, t1 = phases[ph]
                self.complete(ph, pid, tid, t0, t1, {"step": step_id})

    # -- export -------------------------------------------------------------

    def chrome_trace(self):
        """The trace as a Chrome/Perfetto trace-event JSON object. Track
        metadata is kept outside the ring, so lane names survive even
        after the ring has overwritten the events that created them.
        The meta snapshot shares the ring's lock: producers append lane
        metadata mid-run (EngineTracer._lane) while any thread exports."""
        with self._lock:
            ring = list(self.events)
            meta = list(self._meta)
        return {
            "traceEvents": meta + ring,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": self.producer,
                "sample": self.sample,
                "capacity": self.capacity,
                "dropped_events": self.dropped,
            },
        }

    def dump(self, path):
        """Write the Perfetto-loadable JSON to `path`; returns the event
        count written."""
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])
