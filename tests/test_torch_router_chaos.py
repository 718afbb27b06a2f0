"""Router chaos on both packages: injected replica faults driven through
the fleet (the non-soak cases of `tests/test_serving_router_chaos.py`),
each run on the JAX package's router and on the port's (`side`), over the
same tiny GPT (`test_torch_router.make_fleets`), on the CPU.

One of 3 replicas killed mid-wave: everyone not in flight on it completes
token-identical to an unrouted serve, its zero-token requests replay
elsewhere, mid-stream victims get exactly one structured terminal error.
A watchdog-stuck replica is ejected while hung and re-admitted after a
half-open probe restarts it through the factory. Poison isolations that
span distinct tenants eject a replica (a sick card), one adversarial
tenant never does; a poison on a draining replica is the request's own;
a poison-ejected replica stays out while its window holds the evidence.
The randomized drain-under-load soak is the reference's `slow` case and
is not repeated here.
"""
import asyncio
import time

import numpy as np
import pytest

from test_torch_router import SIDES, make_fleets
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def fleets():
    return make_fleets()


@pytest.fixture(autouse=True)
def _disarm(fleets):
    yield
    for f in fleets.values():
        plan = f.faults.active()
        if plan is not None:
            plan.release_hangs()
        f.faults.clear()


@pytest.fixture(scope="module")
def refs(fleets):
    return {s: f.engine(max_batch=2) for s, f in fleets.items()}


def _prompt(seed, n=10):
    return np.random.RandomState(seed).randint(0, 128, (n,)).tolist()


def _replica(f, **kw):
    return f.front(f.engine(max_batch=2), max_waiting=8, **kw)


def _homed(router, home, seed0, n=12):
    seed = seed0
    while True:
        seed += 1
        p = _prompt(seed, n)
        if router.home_replica(p) == home:
            return p


@pytest.mark.parametrize("side", SIDES)
def test_replica_thread_die_mid_wave(side, fleets, refs):
    f = fleets[side]

    async def main():
        replicas = [_replica(f) for _ in range(3)]
        for r in replicas:   # warm: a first step is a slow step
            r.engine.generate([[0]], max_new_tokens=2, temperature=0.0)
        router = f.router(replicas, sweep_interval_s=0.02,
                          probe_interval_s=60.0)
        await router.start()
        buckets = {r.name: [] for r in router.replicas}
        seed = 0
        while any(len(v) < 4 for v in buckets.values()):
            seed += 1
            p = _prompt(seed)
            h = router.home_replica(p)
            if len(buckets[h]) < 4:
                buckets[h].append(p)
        ps = [p for i in range(4)
              for p in (buckets["r0"][i], buckets["r1"][i],
                        buckets["r2"][i])]
        want = refs[side].generate(ps, max_new_tokens=24, temperature=0.0)
        streams = [await router.submit(p, max_new_tokens=24,
                                       temperature=0.0) for p in ps]
        victim = next(r for r in router.replicas if r.name == "r1")
        victim_streams = [s for s in streams if s.replica == "r1"]

        def victim_arranged():
            started = sum(1 for s in victim_streams
                          if len(s.req.output_ids) >= 1)
            zero = sum(1 for s in victim_streams
                       if len(s.req.output_ids) == 0)
            return started >= 2 and zero >= 2

        t0 = time.monotonic()
        while not victim_arranged():
            assert time.monotonic() - t0 < 30, "victim never arranged"
            await asyncio.sleep(0.005)

        def die():
            raise f.faults.FaultInjected("thread_die (pinned to r1)")

        victim.engine._sup.step = die
        results = await asyncio.wait_for(
            asyncio.gather(*[s.collect() for s in streams]), 60.0)
        dead = [r for r in router.replicas
                if r.engine.healthz_state()[0] == "engine_dead"]
        t0 = time.monotonic()
        while dead and dead[0].state != "ejected":
            assert time.monotonic() - t0 < 10
            await asyncio.sleep(0.02)
        c = dict(router.metrics.counters)
        states = {r.name: r.state for r in router.replicas}
        await router.shutdown()
        return streams, results, want, dead, c, states

    streams, results, want, dead, c, states = asyncio.run(main())
    assert len(dead) == 1
    dead_name = dead[0].name
    assert states[dead_name] == "ejected"
    assert sum(1 for s in states.values() if s == "active") == 2
    n_ok = n_err = 0
    for s, (toks, reason), ref in zip(streams, results, want):
        assert s.terminal_events == 1, (s.request_id, s.terminal_events)
        if reason == "length":
            assert toks == ref
            n_ok += 1
        else:
            assert reason == "error" and s.error and s.n_tokens > 0
            assert s.replays == 0
            n_err += 1
    assert n_ok == 10 and n_err == 2
    assert c["router_replays"] == 2
    assert c["router_midstream_errors"] == 2
    assert c["router_ejections"] == 1
    replayed = [s for s in streams if s.replays]
    assert len(replayed) == 2
    assert all(s.replica != dead_name and s.finish_reason == "length"
               for s in replayed)


@pytest.mark.parametrize("side", SIDES)
def test_watchdog_stuck_replica_ejected_then_readmitted(side, fleets, refs):
    f = fleets[side]

    def mk():
        eng = f.engine(max_batch=2)
        # warm before arming a 0.3 s watchdog: a first step is slow
        eng.generate([list(range(1, 10))], max_new_tokens=2,
                     temperature=0.0)
        return f.front(eng, max_waiting=8, watchdog_step_timeout_s=0.3,
                       hard_stop_timeout_s=2.0)

    async def main():
        router = f.router([mk(), mk()], factory=lambda i: mk(),
                          sweep_interval_s=0.02, probe_interval_s=0.2,
                          probe_timeout_s=15.0)
        await router.start()
        plan = f.faults.install(f.faults.FaultPlan([
            {"point": "step_hang", "request_id": "hangme", "times": 1}]))
        p = _prompt(50)
        hang_st = await router.submit(p, max_new_tokens=8, temperature=0.0,
                                      request_id="hangme")
        victim_name = hang_st.replica
        other = [r for r in router.replicas if r.name != victim_name][0]
        p2 = _homed(router, other.name, seed0=100)
        inno = await router.submit(p2, max_new_tokens=6, temperature=0.0)
        toks_h, reason_h = await asyncio.wait_for(hang_st.collect(), 30.0)
        toks_i, reason_i = await asyncio.wait_for(inno.collect(), 30.0)
        victim = [r for r in router.replicas if r.name == victim_name][0]
        t0 = time.monotonic()
        while victim.state not in ("ejected", "probing"):
            assert time.monotonic() - t0 < 10, victim.state
            await asyncio.sleep(0.02)
        stuck_eject_state = victim.state
        plan.release_hangs()
        t0 = time.monotonic()
        while victim.state != "active" or victim.restarts < 1:
            assert time.monotonic() - t0 < 60, (victim.state,
                                                victim.restarts)
            await asyncio.sleep(0.05)
        f.faults.clear()
        post = await router.generate(
            _homed(router, victim_name, seed0=200),
            max_new_tokens=3, temperature=0.0)
        c = dict(router.metrics.counters)
        await router.shutdown()
        return (hang_st, toks_h, reason_h, toks_i, reason_i, p, p2,
                stuck_eject_state, victim, post, c, other.name)

    (hang_st, toks_h, reason_h, toks_i, reason_i, p, p2,
     stuck_eject_state, victim, post, c, other_name) = asyncio.run(main())
    ref = refs[side]
    assert reason_h == "length" and hang_st.replays == 1
    assert hang_st.replica == other_name
    assert toks_h == ref.generate([p], max_new_tokens=8,
                                  temperature=0.0)[0]
    assert reason_i == "length"
    assert toks_i == ref.generate([p2], max_new_tokens=6,
                                  temperature=0.0)[0]
    assert stuck_eject_state in ("ejected", "probing")
    assert victim.restarts == 1
    assert post[1] == "length"
    assert c["router_ejections"] == 1
    assert c["router_readmissions"] == 1
    assert c["router_restarts"] == 1


@pytest.mark.parametrize("side", SIDES)
def test_poison_rate_ejects_sick_chip_not_adversarial_tenant(side, fleets):
    f = fleets[side]

    async def run(tenants):
        router = f.router([_replica(f) for _ in range(2)],
                          sweep_interval_s=0.02, probe_interval_s=60.0,
                          poison_source_threshold=3)
        await router.start()
        shared = _prompt(300, n=8)           # one full block: one home
        home = router.home_replica(shared + [1])
        f.faults.install(f.faults.FaultPlan([
            {"point": "step_raise", "request_id": f"poison{i}"}
            for i in range(len(tenants))]))
        for i, tenant in enumerate(tenants):
            st = await router.submit(
                shared + [i], max_new_tokens=4, temperature=0.0,
                request_id=f"poison{i}", tenant=tenant)
            assert st.replica == home
            _, reason = await asyncio.wait_for(st.collect(), 30.0)
            assert reason == "error" and st.replays == 0
            assert st.terminal_events == 1
        await asyncio.sleep(0.3)
        victim = [r for r in router.replicas if r.name == home][0]
        state, why = victim.state, victim.eject_reason
        stats = victim.engine.supervisor.poison_stats()
        f.faults.clear()
        ok = await router.generate(_prompt(400), max_new_tokens=3,
                                   temperature=0.0)
        await router.shutdown()
        return state, why, stats, ok

    state, why, stats, ok = asyncio.run(
        run(["tenant-a", "tenant-b", "tenant-c"]))
    assert state == "ejected" and why.startswith("poison_rate:")
    assert stats["distinct_sources"] == 3
    assert ok[1] == "length"

    state, why, stats, ok = asyncio.run(
        run(["mallory", "mallory", "mallory"]))
    assert state == "active" and why is None
    assert stats["isolated_in_window"] == 3
    assert stats["distinct_sources"] == 1
    assert ok[1] == "length"


@pytest.mark.parametrize("side", SIDES)
def test_poison_on_draining_replica_is_request_attributed(side, fleets):
    f = fleets[side]

    async def main():
        router = f.router([_replica(f) for _ in range(2)],
                          sweep_interval_s=0.02, probe_interval_s=60.0)
        await router.start()
        home_name = router.home_replica(_prompt(600))
        home = [r for r in router.replicas if r.name == home_name][0]
        innocent = await router.submit(_prompt(600), max_new_tokens=20,
                                       temperature=0.0)
        assert innocent.replica == home_name
        poison = await router.submit(
            _homed(router, home_name, seed0=700),
            max_new_tokens=20, temperature=0.0, request_id="latepoison")
        assert poison.replica == home_name
        home.engine.stop_admitting()
        assert home.engine.healthz_state()[0] == "draining"
        f.faults.install(f.faults.FaultPlan([
            {"point": "step_raise", "request_id": "latepoison"}]))
        _, reason_p = await asyncio.wait_for(poison.collect(), 30.0)
        _, reason_i = await asyncio.wait_for(innocent.collect(), 30.0)
        await asyncio.sleep(0.2)
        state = home.state
        c = dict(router.metrics.counters)
        f.faults.clear()
        home.engine.resume_admitting()
        await router.shutdown()
        return poison, reason_p, reason_i, state, c

    poison, reason_p, reason_i, state, c = asyncio.run(main())
    assert reason_p == "error" and poison.replays == 0
    assert poison.terminal_events == 1
    assert reason_i == "length"
    assert state == "draining"
    assert c.get("router_ejections", 0) == 0
    assert c.get("router_replays", 0) == 0


@pytest.mark.parametrize("side", SIDES)
def test_poison_ejected_replica_stays_out_until_window_clears(side, fleets):
    f = fleets[side]

    def mk():
        return f.front(f.engine(max_batch=2), max_waiting=8,
                       poison_window_s=1.5)

    async def main():
        router = f.router([mk(), mk()], sweep_interval_s=0.02,
                          probe_interval_s=0.05, poison_source_threshold=2)
        await router.start()
        shared = _prompt(500, n=8)
        home = router.home_replica(shared + [1])
        f.faults.install(f.faults.FaultPlan([
            {"point": "step_raise", "request_id": f"poison{i}"}
            for i in range(2)]))
        for i, tenant in enumerate(["ta", "tb"]):
            st = await router.submit(
                shared + [i], max_new_tokens=4, temperature=0.0,
                request_id=f"poison{i}", tenant=tenant)
            await asyncio.wait_for(st.collect(), 30.0)
        f.faults.clear()
        victim = [r for r in router.replicas if r.name == home][0]
        t0 = time.monotonic()
        while victim.state not in ("ejected", "probing"):
            assert time.monotonic() - t0 < 10
            await asyncio.sleep(0.02)
        await asyncio.sleep(0.5)
        held_out = victim.state in ("ejected", "probing")
        readmissions_during = router.metrics.counters.get(
            "router_readmissions", 0)
        t0 = time.monotonic()
        while victim.state != "active":
            assert time.monotonic() - t0 < 30, victim.state
            await asyncio.sleep(0.05)
        post = await router.generate(shared + [9], max_new_tokens=3,
                                     temperature=0.0)
        c = dict(router.metrics.counters)
        await router.shutdown()
        return held_out, readmissions_during, post, c

    held_out, readmissions_during, post, c = asyncio.run(main())
    assert held_out and readmissions_during == 0
    assert post[1] == "length"
    assert c["router_readmissions"] == 1
    assert c["router_probes"] >= 2
