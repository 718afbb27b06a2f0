"""The port's `EngineSupervisor`, `StepWatchdog` and fault plans against
the JAX package's, on the CPU.

The same tiny GPT weights in both packages (`test_torch_server.make_sides`)
and the same `FaultPlan` in each package's `faults` module. Against bare
engines, driven synchronously: a `step_raise` pinned to one request is
bisected down to it (`step(only=...)` probes) and only it fails; a
transient fault attributes nobody; `step_nonfinite_logits` aborts only its
row; `alloc_fail` pressure is absorbed; `requeue`, `live_requests`,
`peek_request` and `step(only=...)` behave alike; a hung step trips the
watchdog. Through each package's HTTP server: the same plan fails the same
request ids with the same finish reasons while the others finish with the
same tokens, and a dying engine thread leaves the same 503s. Failures,
tokens and the supervisor's counters must be equal across the packages.
"""
import asyncio
import json
import threading
import time

import pytest

from test_torch_server import (completion, http, idle, make_sides, prompts,
                               run_both, wait_for)
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

P = prompts((5, 9, 13, 7), seed=0)
IDS = ["r0", "r1", "r2", "r3"]
COUNTERS = ("engine_step_errors", "engine_step_retries",
            "poison_requests_isolated", "nonfinite_rows", "requests_aborted")


@pytest.fixture(scope="module")
def sides():
    return make_sides()


def _supervised(side, plan, n=6):
    """Serve P under `plan` through a bare engine and its supervisor:
    (failures, tokens by id, counters, steps, idle)."""
    eng = side.engine()
    sup = side.serving.EngineSupervisor(eng)
    if plan is not None:
        side.faults.install(side.faults.FaultPlan(plan))
    reqs = {rid: eng.get_request(eng.add_request(p, max_new_tokens=n,
                                                 request_id=rid))
            for rid, p in zip(IDS, P)}
    failures = []
    for _ in range(300):
        if not eng.has_unfinished():
            break
        _, f = sup.step()
        failures += f
    c = eng.metrics.counters
    return (failures, {rid: list(r.output_ids) for rid, r in reqs.items()},
            {k: int(c.get(k, 0)) for k in COUNTERS}, eng.step_count,
            idle(eng) and eng.pool._refcount == {})


PLANS = {
    "poison": [{"point": "step_raise", "request_id": "r2",
                "exc": "DeviceBoom"}],
    "transient": [{"point": "step_raise", "at_step": 3}],
    "nonfinite": [{"point": "step_nonfinite_logits", "request_id": "r1"}],
    "alloc_fail": [{"point": "alloc_fail", "nth_call": 2},
                   {"point": "alloc_fail", "nth_call": 5}],
    "slow": [{"point": "slow_step_ms", "ms": 1.0}],
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_supervised_fault_plan_matches_jax(sides, case):
    got = run_both(sides, lambda side: _supervised(side, PLANS[case]))
    assert got["torch"] == got["jax"]
    failures, toks, counters, _, is_idle = got["torch"]
    clean = _supervised(sides["torch"], None)[1]
    assert is_idle
    failed = {rid for rid, _ in failures}
    assert failed == {"poison": {"r2"}, "nonfinite": {"r1"}}.get(case, set())
    for rid in IDS:
        if rid not in failed:
            assert toks[rid] == clean[rid], rid
    if case == "poison":
        assert "FaultInjected" in failures[0][1]
        assert "DeviceBoom" in failures[0][1]
        assert counters["poison_requests_isolated"] == 1
        assert counters["engine_step_retries"] >= 2
    if case == "transient":
        assert counters["engine_step_errors"] == 1
        assert counters["poison_requests_isolated"] == 0
    if case == "nonfinite":
        assert failures == [("r1", "nonfinite_logits")]


def _requeue_and_only(side):
    eng = side.engine()
    a = eng.add_request(P[0], max_new_tokens=4, request_id="a")
    b = eng.add_request(P[1], max_new_tokens=4, request_id="b")
    out = [eng.requeue(a)]                       # waiting: already queued
    outs = eng.step(only={a})
    req_a, req_b = eng.get_request(a), eng.get_request(b)
    out += [[o.request_id for o in outs], eng.last_planned, req_b.state,
            req_b.num_cached, req_a.state, bool(req_a.blocks)]
    out += [eng.requeue(a), req_a.state, bool(req_a.blocks),
            sorted(eng.live_requests()), eng.requeue("nope"),
            eng.peek_request("nope")]
    while eng.has_unfinished():
        eng.step()
    out += [eng.requeue(a),
            getattr(eng.peek_request(b), "finish_reason", None),
            list(req_a.output_ids), list(req_b.output_ids), idle(eng)]
    return out


def test_requeue_live_peek_and_only_match_jax(sides):
    got = run_both(sides, _requeue_and_only)
    # the JAX Request records no finish_reason; the port's does
    jax_out, mine = got["jax"], got["torch"]
    assert mine[:14] + mine[15:] == jax_out[:14] + jax_out[15:]
    assert mine[:7] == [True, ["a"], ["a"], "waiting", 0, "running", True]
    assert mine[7:11] == [True, "waiting", False, ["a", "b"]]
    assert mine[14] == "finished" and mine[-1] is True


def _watchdog(side):
    eng = side.engine()
    sup = side.serving.EngineSupervisor(eng)
    plan = side.faults.install(side.faults.FaultPlan(
        [{"point": "step_hang", "at_step": 1, "timeout_s": 30.0}]))
    eng.add_request(P[0], max_new_tokens=3, request_id="hung")
    wd = side.serving.StepWatchdog(sup, timeout_s=0.1, poll_s=0.02).start()

    def run():
        while eng.has_unfinished():
            sup.step()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + 10.0
    while sup.health.healthy and time.monotonic() < deadline:
        time.sleep(0.01)
    snap = sup.health.snapshot()
    plan.release_hangs()
    t.join(10.0)
    wd.stop()
    return (snap["reason"], snap["stuck_for_s"] >= 0.1, snap["step"],
            wd.tripped, eng.metrics.counters["watchdog_trips"],
            eng.metrics.gauges["engine_unhealthy"], t.is_alive(), idle(eng))


def test_watchdog_trip_matches_jax(sides):
    got = run_both(sides, _watchdog)
    assert got["torch"] == got["jax"] == ("step_stuck", True, 1, True, 1,
                                          1.0, False, True)


async def _http_faults(side):
    """One server, four requests at once (two streamed) under one plan: a
    non-finite row pinned to r1, a raising step pinned to r2, and a slow
    step everywhere."""
    side.faults.install(side.faults.FaultPlan(
        PLANS["nonfinite"] + PLANS["poison"] + PLANS["slow"]))
    engine = side.engine(trace=1.0)
    server = side.server(engine)
    await server.start()
    try:
        res = await asyncio.gather(*[
            http(server.port, "POST", "/v1/completions",
                 {"prompt": p, "max_tokens": 6, "stream": i % 2 == 1,
                  "request_id": rid})
            for i, (rid, p) in enumerate(zip(IDS, P))])
        hs, _, hb = await http(server.port, "GET", "/healthz")
    finally:
        await server.shutdown(drain=True)
    out = {rid: completion(s, b, i % 2 == 1)
           for i, (rid, (s, _, b)) in enumerate(zip(IDS, res))}
    ends = sorted((e["args"]["request_id"], e["args"]["reason"])
                  for e in engine.tracer.chrome_trace()["traceEvents"]
                  if e["name"] == "request")
    return (out, ends, hs, json.loads(hb)["poison"]["isolated_in_window"],
            idle(engine))


def test_http_fault_plan_matches_jax(sides):
    got = run_both(sides, _http_faults)
    assert got["torch"] == got["jax"]
    out, ends, hs, isolated, is_idle = got["torch"]
    # r1 streamed: its SSE stream ends with finish_reason "error"; r2 is
    # not: a 500 engine_error body
    assert out["r1"] == (200, [], "error")
    assert out["r2"][0] == 500
    assert out["r0"][0] == out["r3"][0] == 200
    assert ("r1", "error:nonfinite_logits") in ends
    assert ("r2", "error:FaultInjected") in ends
    assert hs == 200 and isolated == 1 and is_idle


async def _thread_die(side):
    side.faults.install(side.faults.FaultPlan(
        [{"point": "thread_die", "nth_call": 1}]))
    server = side.server()
    await server.start()
    try:
        await wait_for(lambda: not server.engine._thread.is_alive(),
                       msg="engine thread death")
        s, _, b = await http(server.port, "POST", "/v1/completions",
                             {"prompt": P[0], "max_tokens": 2})
        hs, _, hb = await http(server.port, "GET", "/healthz")
    finally:
        await server.shutdown(drain=True)
    health = json.loads(hb)
    return (s, json.loads(b)["error"]["reason"], hs, health["status"],
            # a 503 payload carries the health snapshot's lifecycle word
            health["reason"], health["lifecycle"],
            server.engine.metrics.counters["engine_thread_deaths"])


def test_thread_death_matches_jax(sides):
    got = run_both(sides, _thread_die)
    assert got["torch"] == got["jax"] == (
        # submit checks health first: the dead thread marked it unhealthy
        503, "unhealthy", 503, "engine_dead", "engine_thread_died",
        "stopped", 1)
