"""The port's training tracer (`paddle_tpu_torch.profiler.tracing`:
`TrainTracer`, `train_dispatch_span`, `InstrumentedStep`, `train_tracer`
and the enable/disable/reset functions) against the JAX package's
(`paddle_tpu.profiler.tracing`), after `tests/test_train_trace.py`:

- the schema canary: a traced training loop exports valid Chrome trace
  JSON whose event vocabulary (names, phases, tracks, argument keys) is
  the JAX tracer's for the same calls;
- span nesting, `train_dispatch_span`, `InstrumentedStep`'s delegation,
  the ``PADDLE_TPU_TRACE`` / ``PADDLE_TPU_TRACE_BUF`` knobs, and tracing
  off leaving the loss trajectory bit-identical;
- the device-capture join key: each traced step runs under a
  ``paddle_tpu.step <id>`` `torch.profiler.record_function` range.

The JAX file's scenarios that drive hapi `Model.fit` (the five phases of
fit's instrumentation, `TrainMonitor`, the recompile sentinel) wait for
the port of hapi (ROADMAP Queue 1, item 8).
"""
import json

import numpy as np
import pytest
import torch

from paddle_tpu.profiler import tracing as jtracing
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.profiler import tracing
from paddle_tpu_torch.profiler.tracing import InstrumentedStep, TrainTracer
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

_PH = {"X", "i", "M"}
_PHASES = {"data", "shard", "dispatch", "sync", "callback"}
CFG = dict(vocab_size=128, hidden_size=32, num_layers=1, num_heads=2,
           max_seq_len=16)


@pytest.fixture(autouse=True)
def _fresh_tracing():
    tracing.reset_train_tracing()
    yield
    tracing.reset_train_tracing()


def _validate(trace):
    json.loads(json.dumps(trace))
    for ev in trace["traceEvents"]:
        assert ev["ph"] in _PH, ev
        assert isinstance(ev["name"], str) and ev["name"], ev
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0, ev
        if ev["ph"] == "X":
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0, ev


def _train(steps=4, seed=0):
    """A small GPT trained `steps` steps on the CPU, each step an
    `InstrumentedStep`; returns the losses."""
    model = GPT(GPTConfig(**CFG), device="cpu", seed=seed)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    rs = np.random.RandomState(seed)
    ids = torch.from_numpy(rs.randint(0, 128, (2, 16)))

    def step(ids, labels):
        loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss

    traced = InstrumentedStep(step, {"source": "gpt"})
    model.train()
    return [traced(ids, ids).item() for _ in range(steps)]


def _vocabulary(trace):
    """What a consumer of the trace reads: (name, ph, pid, tid, arg keys)
    of every event, metadata with its arguments."""
    out = []
    for ev in trace["traceEvents"]:
        args = ev.get("args", {})
        out.append((ev["name"], ev["ph"], ev["pid"], ev["tid"],
                    tuple(sorted(args.items())) if ev["ph"] == "M"
                    else tuple(sorted(args))))
    return out


def test_train_trace_schema_canary():
    tr = tracing.enable_train_tracing()
    _train(steps=4)
    trace = tr.chrome_trace()
    _validate(trace)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"train_step", "dispatch"} <= names
    procs = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {"paddle-tpu-train"}
    steps = [e for e in trace["traceEvents"] if e["name"] == "train_step"]
    assert [e["args"]["step"] for e in steps] == [0, 1, 2, 3]
    assert all(e["args"]["source"] == "gpt" for e in steps)
    assert trace["otherData"]["producer"] == \
        "paddle_tpu_torch.profiler.tracing.train"


def test_event_vocabulary_is_the_jax_tracers():
    """The same recording calls on both tracers give the same events, but
    for the times and the producer's name."""
    traces = []
    for mod in (jtracing, tracing):
        tr = mod.TrainTracer(capacity=256)
        tr.record_train_step(tr.next_step_id(), {
            "data": (1.0, 1.1), "shard": (1.1, 1.2), "dispatch": (1.2, 1.5),
            "sync": (1.5, 1.6), "callback": (1.6, 1.7)}, {"loss": 2.0})
        with mod.train_dispatch_span(tr, {"source": "unit"}):
            pass
        traces.append(tr.chrome_trace())
    assert _vocabulary(traces[1]) == _vocabulary(traces[0])
    assert tracing.TrainTracer.PHASES == jtracing.TrainTracer.PHASES
    assert set(traces[1]["otherData"]) == set(traces[0]["otherData"])
    assert tracing.STEP_ANNOTATION_PREFIX == jtracing.STEP_ANNOTATION_PREFIX


def test_phases_nest_inside_their_train_step():
    tr = tracing.enable_train_tracing()
    _train(steps=3)
    tr.record_train_step(tr.next_step_id(), {
        "data": (tr.epoch + 1.0, tr.epoch + 1.1),
        "dispatch": (tr.epoch + 1.1, tr.epoch + 1.4),
        "sync": (tr.epoch + 1.4, tr.epoch + 1.5)})
    evs = tr.chrome_trace()["traceEvents"]
    steps = {e["args"]["step"]: e for e in evs
             if e.get("ph") == "X" and e["name"] == "train_step"}
    phases = [e for e in evs if e.get("ph") == "X" and e["name"] in _PHASES]
    assert len(steps) == 4 and len(phases) == 6
    eps = 1e-3
    for ph in phases:
        parent = steps[ph["args"]["step"]]
        assert ph["ts"] >= parent["ts"] - eps, (ph, parent)
        assert (ph["ts"] + ph["dur"]
                <= parent["ts"] + parent["dur"] + eps), (ph, parent)
    by_step = {}
    for ph in phases:
        by_step.setdefault(ph["args"]["step"], set()).add(ph["name"])
    assert by_step == {0: {"dispatch"}, 1: {"dispatch"}, 2: {"dispatch"},
                       3: {"data", "dispatch", "sync"}}


def test_trace_off_loss_trajectory_identical(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_TRACE", raising=False)
    tracing.reset_train_tracing()
    assert tracing.train_tracer() is None        # hook sites see None
    off = _train(steps=3)
    tr = tracing.enable_train_tracing()
    on = _train(steps=3)
    assert on == off                             # tracing changes no number
    assert off[-1] < off[0]
    assert len(tr.chrome_trace()["traceEvents"]) > 0


def test_env_knobs(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACE", "1")
    monkeypatch.setenv("PADDLE_TPU_TRACE_BUF", "64")
    tracing.reset_train_tracing()
    tr = tracing.train_tracer()
    assert isinstance(tr, TrainTracer) and tr.capacity == 64
    assert tracing.train_tracer() is tr          # stable across calls
    monkeypatch.setenv("PADDLE_TPU_TRACE", "0")
    tracing.reset_train_tracing()
    assert tracing.train_tracer() is None
    # the explicit API wins over the env
    monkeypatch.setenv("PADDLE_TPU_TRACE", "1")
    tracing.disable_train_tracing()
    assert tracing.train_tracer() is None
    assert tracing.enable_train_tracing(capacity=8).capacity == 16


def test_train_dispatch_span_unit():
    tr = TrainTracer(capacity=256)
    with tracing.train_dispatch_span(tr, {"source": "unit"}) as sid:
        pass
    evs = tr.chrome_trace()["traceEvents"]
    span = next(e for e in evs if e["name"] == "train_step")
    assert span["args"]["step"] == sid and span["args"]["source"] == "unit"
    child = next(e for e in evs if e["name"] == "dispatch")
    assert child["args"]["step"] == sid
    # a raising body still closes its span
    with pytest.raises(ValueError):
        with tracing.train_dispatch_span(tr):
            raise ValueError("boom")
    assert sum(e["name"] == "train_step"
               for e in tr.chrome_trace()["traceEvents"]) == 2


def test_instrumented_step_delegates_and_traces():
    """Transparent when off, one span per call when on, and every other
    attribute reaches the wrapped callable (here a module)."""
    lin = torch.nn.Linear(3, 2)
    step = InstrumentedStep(lin, {"source": "unit"})
    assert step.weight is lin.weight                 # delegation
    assert [p for p in step.parameters()] == list(lin.parameters())
    x = torch.ones(1, 3)
    tracing.disable_train_tracing()
    assert torch.equal(step(x), lin(x))
    tr = tracing.enable_train_tracing()
    assert torch.equal(step(x), lin(x))
    spans = [e for e in tr.chrome_trace()["traceEvents"]
             if e["name"] == "train_step"]
    assert len(spans) == 1 and spans[0]["args"]["source"] == "unit"


def test_traced_steps_carry_the_join_annotation():
    """Each traced step runs under a ``paddle_tpu.step <id>`` profiler
    range with its span's id: the key a torch-profiler capture of the
    card joins on."""
    tr = tracing.enable_train_tracing()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _train(steps=2)
    ranges = {e.key for e in prof.key_averages()
              if e.key.startswith(tracing.STEP_ANNOTATION_PREFIX)}
    spans = [e["args"]["step"] for e in tr.chrome_trace()["traceEvents"]
             if e["name"] == "train_step"]
    assert ranges == {tr.step_annotation(s) for s in spans} == {
        "paddle_tpu.step 0", "paddle_tpu.step 1"}
