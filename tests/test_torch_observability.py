"""The port's tracer, SLO ledger, flight recorder, lifecycle, scheduling
policy, fault plans and environment switches against the JAX package's,
on the CPU.

Engine-level cases build both packages' engines over the same tiny GPT
weights (`test_torch_server.make_sides`) and serve the same requests
synchronously: the trace's span and step-phase names (times are not
compared), the SLO rollup's classes and counts, the flight recorder's
bundle keys, the request log line's keys, the lifecycle's transitions and
the admission order under a priority/deadline policy mix must be equal.
The pure-Python modules are also held case by case against the JAX
module's own calls with a fixed clock.
"""
import json
import logging

import pytest

import paddle_tpu.serving.faults as jfaults
import paddle_tpu.serving.lifecycle as jlifecycle
import paddle_tpu.serving.policy as jpolicy
import paddle_tpu_torch.serving.faults as tfaults
import paddle_tpu_torch.serving.lifecycle as tlifecycle
import paddle_tpu_torch.serving.policy as tpolicy
from paddle_tpu.serving.scheduler import Request as JRequest
from paddle_tpu_torch.serving.scheduler import Request as TRequest
from test_torch_server import idle, make_sides, prompts, run_both

P = prompts((5, 9, 13, 7, 20), seed=5)


@pytest.fixture(scope="module")
def sides():
    return make_sides()


def _serve(eng, reqs, n=6):
    """Add `reqs` ((prompt, kwargs) pairs) and step the bare engine to the
    end; returns the requests by id."""
    out = {}
    for i, (p, kw) in enumerate(reqs):
        rid = eng.add_request(p, max_new_tokens=n, request_id=f"q{i}", **kw)
        out[rid] = eng.get_request(rid)
    while eng.has_unfinished():
        eng.step()
    return out


def _trace(side):
    eng = side.engine(trace=1.0, spec_decoding=True, num_spec_tokens=3)
    _serve(eng, [(p, {}) for p in P])
    events = eng.tracer.chrome_trace()["traceEvents"]
    steps = [e for e in events if e["name"].startswith("step[")]
    phases = {e["name"] for e in events if e.get("tid") == 0
              and e.get("pid") == 1 and e["ph"] == "X"
              and not e["name"].startswith("step[")}
    meta = sorted((e["pid"], e["tid"], e["args"]["name"]) for e in events
                  if e["ph"] == "M")
    closed = sorted(e["args"]["request_id"] for e in events
                    if e["name"] == "request")
    return ({e["name"] for e in events}, phases, meta, closed,
            sorted(steps[0]["args"]), eng.tracer.step_annotation(7),
            eng.metrics.counters["host_syncs"] == eng.step_count)


def test_trace_span_and_phase_names_match_jax(sides):
    got = run_both(sides, _trace)
    assert got["torch"] == got["jax"]
    names, phases, _, closed, _, annotation, one_sync = got["torch"]
    assert phases == {"plan", "build", "dispatch", "sync", "emit"}
    assert {"request", "ttft", "queued", "enqueue"} <= names
    assert closed == [f"q{i}" for i in range(len(P))]
    assert annotation == "paddle_tpu.step 7" and one_sync


def test_step_dispatch_runs_under_a_profiler_range(sides):
    """The traced dispatch runs under `record_function` named after the
    step id, so a torch-profiler capture joins the host timeline."""
    import torch

    eng = sides["torch"].engine(trace=1.0)
    eng.add_request(P[0], max_new_tokens=2)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        while eng.has_unfinished():
            eng.step()
    ranges = {e.key for e in prof.key_averages()
              if e.key.startswith("paddle_tpu.step ")}
    assert ranges == {f"paddle_tpu.step {i}" for i in range(eng.step_count)}


def _slo(side):
    eng = side.engine(slo=True, max_batch=2, num_blocks=5)
    reqs = [(P[0], {"tenant": "a", "priority": "interactive"}),
            (P[1], {"tenant": "a", "priority": "batch"}),
            (P[2], {"tenant": "b", "deadline_s": 3600.0}),
            (P[3], {}),
            (P[4], {"tenant": "b", "deadline_s": 3600.0})]
    served = _serve(eng, reqs)
    roll = eng.slo.rollup()
    classes = sorted(
        (c["tenant"], c["priority"], c["requests"], c["finished"],
         c["aborted"], c["output_tokens"],
         tuple(sorted(c["deadline"].items())))
        for c in roll["classes"])
    # the phase clock telescopes: the phases sum to the e2e wall time
    sums = all(abs(sum(r.slo_summary["phases_ms"].values())
                   - r.slo_summary["e2e_s"] * 1e3) < 1e-2
               for r in served.values())
    return (classes, sorted(roll), sorted(roll["total"]), sums,
            sum(r.preemptions for r in served.values()) > 0, idle(eng))


def test_slo_rollup_classes_and_counts_match_jax(sides):
    got = run_both(sides, _slo)
    assert got["torch"] == got["jax"]
    classes, _, _, sums, preempted, is_idle = got["torch"]
    assert [c[:2] for c in classes] == [("-", "-"), ("a", "batch"),
                                        ("a", "interactive"), ("b", "-")]
    assert sums and preempted and is_idle


def _postmortem(side, tmp):
    side.faults.install(side.faults.FaultPlan(
        [{"point": "step_nonfinite_logits", "request_id": "q1"}]))
    try:
        eng = side.engine(postmortem_dir=str(tmp / side.name),
                          postmortem_keep=4, trace=1.0)
        _serve(eng, [(p, {"tenant": "t"}) for p in P[:3]])
    finally:
        side.faults.clear()
    (man,) = eng.recorder.list_bundles()
    with open(tmp / side.name / man["name"] / "bundle.json") as f:
        bundle = json.load(f)
    return (sorted(bundle), sorted(bundle["manifest"]),
            sorted(bundle["victim"]), sorted(bundle["request_log_tail"][0]),
            man["event"], man["victim"], man["files"], bundle["mesh"],
            sorted(bundle["fault_plan"]["fired"][0]),
            eng.metrics.counters["postmortem_bundles"])


def test_postmortem_bundle_keys_match_jax(sides, tmp_path):
    got = run_both(sides, lambda side: _postmortem(side, tmp_path))
    # the mesh record names each engine's own backend
    assert got["torch"][:7] == got["jax"][:7]
    assert got["torch"][8:] == got["jax"][8:]
    assert got["torch"][4:7] == ("nonfinite_row", "q1",
                                 ["bundle.json", "trace.json"])
    assert got["torch"][7]["backend"] == "cpu"


def _request_log(side, caplog):
    logger = ("paddle_tpu.serving.request" if side.name == "jax"
              else "paddle_tpu_torch.serving.request")
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger):
        _serve(side.engine(request_log=True),
               [(P[0], {"tenant": "t", "priority": "p"})], n=4)
    (line,) = [json.loads(r.getMessage()) for r in caplog.records
               if r.name == logger]
    return sorted(line), line["reason"], line["output_tokens"]


def test_request_log_line_matches_jax(sides, caplog):
    got = run_both(sides, lambda side: _request_log(side, caplog))
    assert got["torch"] == got["jax"]
    assert got["torch"][1:] == ("finished", 4)


def _policy_order(side):
    """One lane: the admission order under priority classes, tenant
    fairness and a deadline the predictor calls doomed."""
    eng = side.engine(max_batch=1, policy={"assumed_step_s": 30.0})
    order, first = [], {}
    reqs = [(P[0], {"tenant": "a", "priority": "batch"}),
            (P[1], {"tenant": "a", "priority": "interactive"}),
            (P[2], {"tenant": "b", "priority": "batch"}),
            (P[3], {"tenant": "c", "priority": "interactive",
                    "deadline_s": 0.5}),
            (P[4], {"tenant": "b", "priority": "standard"})]
    for i, (p, kw) in enumerate(reqs):
        eng.add_request(p, max_new_tokens=3, request_id=f"q{i}", **kw)
    faults = []
    while eng.has_unfinished():
        for o in eng.step():
            if o.request_id not in first:
                first[o.request_id] = len(first)
                order.append(o.request_id)
        faults += eng.step_faults
    return (order, faults, eng.metrics.counters["policy_early_rejections"],
            sorted(eng.pool_stats()["policy"]), idle(eng))


def test_policy_admission_order_matches_jax(sides):
    got = run_both(sides, _policy_order)
    assert got["torch"] == got["jax"]
    order, faults, rejected, _, is_idle = got["torch"]
    assert order == ["q1", "q4", "q0", "q2"]
    assert faults == [("q3", "policy_reject:deadline_unattainable")]
    assert rejected == 1 and is_idle


def _lifecycle(side):
    eng = side.engine(warmup=True)
    snap = eng.lifecycle.snapshot()
    return ([s for s, _ in eng.lifecycle.transitions()], eng.lifecycle.state,
            snap["warmed"], snap["programs_compiled"],
            eng.metrics.gauges["lifecycle_state"])


def test_engine_lifecycle_matches_jax(sides):
    got = run_both(sides, _lifecycle)
    assert got["torch"] == got["jax"] == (["cold", "loading"], "warm", True,
                                          2, 2.0)


@pytest.mark.parametrize("edge", [(a, b) for a in jlifecycle.STATES
                                  for b in jlifecycle.STATES])
def test_lifecycle_edge_matches_jax(edge):
    a, b = edge

    def walk(mod):
        lc = mod.ReplicaLifecycle()
        path = {"cold": [], "loading": ["loading"],
                "warm": ["loading", "warm"],
                "serving": ["loading", "warm", "serving"],
                "draining": ["loading", "warm", "draining"],
                "stopped": ["stopped"]}[a]
        for s in path:
            lc.to(s)
        try:
            lc.to(b)
        except mod.LifecycleError:
            return "illegal", lc.state
        return "ok", lc.state

    assert walk(tlifecycle) == walk(jlifecycle)


def _policy_calls(mod, req_cls):
    """A fixed-clock script of SchedulingPolicy calls."""
    p = mod.SchedulingPolicy(max_tenants=2, fairness_window_s=10.0,
                             assumed_step_s=0.05)
    reqs = [req_cls([1, 2, 3], tenant=t, priority=pr, deadline_s=d)
            for t, pr, d in (("a", "batch", None), ("b", "interactive", 1.0),
                             ("c", None, 0.01), (None, "standard", None),
                             ("a", "bulk", 5.0))]
    t0 = 1000.0
    out = []
    for i, r in enumerate(reqs):
        p.note_served(r, 10 * (i + 1), now=t0 + i)
    for r in reqs:
        out.append((p.rank(r), p.precedence(r)[0], p.class_labels(r),
                    p.admission_key(r, t0 + 5)[:2],
                    p.early_reject(r, 4, now=r.arrival_time + 0.001)))
    p.observe_step(0.02)
    out.append((p.served_shares(now=t0 + 5), p.served_tokens("a", t0 + 5),
                p.served_shares(now=t0 + 30),
                p.select_victim(reqs, reqs[1]) is None,
                p.predicted_serve_s(reqs[0], 2)))
    return out


def test_policy_module_matches_jax_with_a_fixed_clock():
    assert _policy_calls(tpolicy, TRequest) == _policy_calls(jpolicy,
                                                              JRequest)
    for v in (None, False, True, {"priorities": ("x", "y")}):
        a, b = tpolicy.as_policy(v), jpolicy.as_policy(v)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.priorities == b.priorities
    with pytest.raises(ValueError):
        tpolicy.as_policy("priority")


FAULT_SPECS = [
    [{"point": "step_raise", "at_step": 3}],
    [{"point": "alloc_fail", "nth_call": 2, "times": 1}],
    [{"point": "slow_step_ms", "probability": 0.4, "seed": 7, "ms": 1}],
    [{"point": "step_nonfinite_logits", "request_id": "x", "times": 2},
     {"point": "step_raise", "probability": 0.5, "seed": 3}],
    {"points": [{"point": "thread_die", "nth_call": 4}]},
]


@pytest.mark.parametrize("spec", FAULT_SPECS,
                         ids=lambda s: json.dumps(s)[:40])
def test_fault_plan_fires_like_jax(spec):
    def fires(mod):
        plan = mod.plan_from_json(json.dumps(spec))
        for step in range(12):
            for point in mod.POINTS:
                plan.match(point, step=step, request_ids=("x", "y"))
        return plan.fired, [(fp.calls, fp.fires) for fp in plan.points]

    assert fires(tfaults) == fires(jfaults)
    assert tfaults.POINTS == jfaults.POINTS
    for bad in ({"point": "nope"}, {"point": "alloc_fail", "at_step": 1},
                {"point": "step_raise", "nth_call": 0}):
        with pytest.raises(ValueError):
            tfaults.FaultPoint(**bad)


def test_fault_plan_env_switch_matches_jax(sides, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FAULTS",
                       '[{"point": "step_raise", "at_step": 1}]')
    try:
        for side in sides.values():
            eng = side.engine()
            plan = side.faults.active()
            assert plan is not None and plan.points[0].at_step == 1
            eng.add_request(P[0], max_new_tokens=2)
            with pytest.raises(side.faults.FaultInjected):
                eng.step()
    finally:
        jfaults.clear()
        tfaults.clear()


ENV_CASES = [
    ("PADDLE_TPU_PREFIX_CACHE", "0", lambda e: e.prefix_cache),
    ("PADDLE_TPU_SPEC_DECODE", "1", lambda e: e.spec_decoding),
    ("PADDLE_TPU_KV_DTYPE", "int8", lambda e: e.pool.kv_dtype),
    ("PADDLE_TPU_WIDTH_BUCKETS", "4,8", lambda e: e.width_buckets),
    ("PADDLE_TPU_HOST_KV_BLOCKS", "8",
     lambda e: (e.pool_stats(), e.swap_program_shapes())),
    ("PADDLE_TPU_TRACE", "0.5", lambda e: e.tracer.sample),
    ("PADDLE_TPU_TRACE_BUF", "64", lambda e: e.tracer),
    ("PADDLE_TPU_REQUEST_LOG", "1",
     lambda e: (e.request_log, e.slo is not None)),
    ("PADDLE_TPU_SLO", "1", lambda e: e.slo is not None),
    ("PADDLE_TPU_POSTMORTEM_DIR", "pm", lambda e: e.recorder.keep),
    ("PADDLE_TPU_POSTMORTEM_KEEP", "3", lambda e: e.recorder),
]


@pytest.mark.parametrize("name,value,read", ENV_CASES,
                         ids=[c[0] for c in ENV_CASES])
def test_env_switch_reads_like_jax(sides, monkeypatch, tmp_path, name, value,
                                   read):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv(name, value)
    got = run_both(sides, lambda side: read(side.engine()))
    assert got["torch"] == got["jax"]
    # an explicit keyword wins over the switch
    if name == "PADDLE_TPU_PREFIX_CACHE":
        assert sides["torch"].engine(prefix_cache=True).prefix_cache


@pytest.mark.parametrize("name,value", [
    ("PADDLE_TPU_TP", "2"), ("PADDLE_TPU_QUANT_ALLREDUCE", "attn_proj")])
def test_later_env_switches_raise(sides, monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    with pytest.raises(NotImplementedError, match=name):
        sides["torch"].engine()
    monkeypatch.setenv(name, {"PADDLE_TPU_TP": "1"}.get(name, "0"))
    sides["torch"].engine()


@pytest.mark.parametrize("option", [
    {"policy": True}, {"policy": {"priorities": ("a", "b")}},
    {"trace": True}, {"trace": 0.25, "trace_buffer": 64}, {"slo": True},
    {"request_log": True}, {"postmortem_dir": "pm", "postmortem_keep": 2}])
def test_observability_options_are_accepted(sides, monkeypatch, tmp_path,
                                            option):
    monkeypatch.chdir(tmp_path)
    eng = sides["torch"].engine(**option)
    out = eng.generate([P[0]], max_new_tokens=3)
    assert out == sides["torch"].engine().generate([P[0]], max_new_tokens=3)
    assert idle(eng) and eng.lifecycle.state == "warm"
