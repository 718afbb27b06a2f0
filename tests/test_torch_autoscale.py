"""The port's SLO-driven autoscaler (`paddle_tpu_torch.serving.AutoScaler`)
against the JAX package's, on the CPU: the non-soak cases of
`tests/test_autoscale.py`, each on both packages (`side`).

The control logic (`decide` over a stub router: streaks, cooldown,
hysteresis, min/max clamps, the busy guard) and one real scale-up →
scale-down round trip with forced signals through each package's router
and `RouterServer` (a spawn through the factory on a worker thread, its
first-token time measured; the retired replica drains to exactly one
terminal lifecycle state), plus ``/debug/autoscale``'s 404 hint when the
autoscaler is off. The ramp soak is the reference's `slow` case and is
not repeated here. On the port's side alone: a retired replica's engine is
gone when the retire returns (its thread ended, nothing left holding it),
so a card's memory comes back with it.
"""
import asyncio
import concurrent.futures
import gc
import json
import time
import types
import weakref

import pytest

from paddle_tpu.serving import lifecycle as jlifecycle
from paddle_tpu.serving import router as jrouter
from paddle_tpu_torch.serving import lifecycle as tlifecycle
from paddle_tpu_torch.serving import router as trouter
from test_torch_router import SIDES, homed_prompt, http, make_fleets
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

ACTIVE = {"jax": jrouter.ACTIVE, "torch": trouter.ACTIVE}
LEGAL = {"jax": jlifecycle.LEGAL, "torch": tlifecycle.LEGAL}


@pytest.fixture(scope="module")
def fleets():
    return make_fleets()


class _StubRouter:
    def __init__(self, side, n=1, wait=0.0):
        self.wait = wait
        self.factory = lambda i: None
        self.replicas = []
        for i in range(n):
            eng = types.SimpleNamespace(
                engine=types.SimpleNamespace(slo=None, tracer=None),
                inflight=0)
            self.replicas.append(types.SimpleNamespace(
                state=ACTIVE[side], name=f"r{i}", engine=eng, index=i))

    def _predicted_wait(self, _r):
        return self.wait


def _scaler(fleets, side, router, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 2)
    kw.setdefault("up_streak", 2)
    kw.setdefault("down_streak", 3)
    kw.setdefault("cooldown_s", 0.0)
    return fleets[side].serving.AutoScaler(router, **kw)


@pytest.mark.parametrize("side", SIDES)
def test_factory_is_required(side, fleets):
    r = _StubRouter(side)
    r.factory = None
    with pytest.raises(ValueError, match="factory"):
        fleets[side].serving.AutoScaler(r)


@pytest.mark.parametrize("side", SIDES)
def test_wait_pressure_scales_up_after_streak(side, fleets):
    sc = _scaler(fleets, side, _StubRouter(side, n=1, wait=1.0),
                 wait_high_s=0.5)
    a1, r1, _ = sc.decide(time.monotonic())
    assert a1 is None and r1 == "steady"
    a2, r2, sig = sc.decide(time.monotonic())
    assert a2 == "up" and "predicted wait" in r2
    assert sig["min_wait_s"] == 1.0


@pytest.mark.parametrize("side", SIDES)
def test_attainment_pressure_scales_up(side, fleets):
    sc = _scaler(fleets, side, _StubRouter(side, n=1), up_streak=1,
                 target_attainment=0.99)
    sc.signals = lambda: {"active": 1, "replicas": 1,
                          "worst_attainment": 0.5, "window_events": 10,
                          "min_wait_s": 0.0, "max_wait_s": 0.0,
                          "inflight": 0}
    action, reason, _ = sc.decide(time.monotonic())
    assert action == "up" and "attainment 0.5" in reason


@pytest.mark.parametrize("side", SIDES)
def test_max_replicas_clamps_scale_up(side, fleets):
    sc = _scaler(fleets, side, _StubRouter(side, n=2, wait=1.0),
                 up_streak=1, wait_high_s=0.5, max_replicas=2)
    assert sc.decide(time.monotonic())[0] is None


@pytest.mark.parametrize("side", SIDES)
def test_idle_scales_down_after_streak_and_min_clamps(side, fleets):
    sc = _scaler(fleets, side, _StubRouter(side, n=2, wait=0.0),
                 down_streak=3)
    for _ in range(2):
        assert sc.decide(time.monotonic())[0] is None
    action, reason, _ = sc.decide(time.monotonic())
    assert action == "down" and "idle" in reason
    sc2 = _scaler(fleets, side, _StubRouter(side, n=1, wait=0.0),
                  down_streak=1)
    assert sc2.decide(time.monotonic())[0] is None


@pytest.mark.parametrize("side", SIDES)
def test_cooldown_and_busy_block_decisions(side, fleets):
    sc = _scaler(fleets, side, _StubRouter(side, n=1, wait=1.0),
                 up_streak=1, wait_high_s=0.5, cooldown_s=60.0)
    sc._cooldown_until = time.monotonic() + 60.0
    action, reason, _ = sc.decide(time.monotonic())
    assert action is None and reason == "cooldown"
    sc._cooldown_until = 0.0
    sc._busy = True
    action, reason, _ = sc.decide(time.monotonic())
    assert action is None and reason == "scale op in flight"
    sc._busy = False
    assert sc.decide(time.monotonic())[0] == "up"


@pytest.mark.parametrize("side", SIDES)
def test_pressure_resets_the_idle_streak(side, fleets):
    sc = _scaler(fleets, side, _StubRouter(side, n=2, wait=0.0),
                 down_streak=2)
    assert sc.decide(time.monotonic())[0] is None
    sc.router.wait = 1.0
    sc.decide(time.monotonic())
    sc.router.wait = 0.0
    assert sc.decide(time.monotonic())[0] is None
    assert sc.decide(time.monotonic())[0] == "down"


@pytest.mark.parametrize("side", SIDES)
def test_scale_up_then_down_round_trip(side, fleets):
    f = fleets[side]
    born = []

    def factory(i):
        fe = f.front(f.engine(max_batch=2, warmup=True))
        born.append(fe)
        return fe

    async def run():
        router = f.router([factory(0)], factory=factory,
                          sweep_interval_s=3600.0)
        sc = f.serving.AutoScaler(router, factory=factory, min_replicas=1,
                                  max_replicas=2, up_streak=1,
                                  down_streak=1, cooldown_s=0.0)
        server = f.serving.RouterServer(router, port=0, autoscaler=sc)
        await server.start()
        await sc.stop()            # this test drives the loop by hand
        pressure = {"active": 1, "replicas": 1, "worst_attainment": None,
                    "window_events": 0, "min_wait_s": 9.9, "max_wait_s": 9.9,
                    "inflight": 0}
        sc.signals = lambda: dict(pressure, active=len(router.replicas),
                                  replicas=len(router.replicas))
        await sc.tick()
        assert len(router.replicas) == 2
        assert sc.metrics.counters["autoscale_ups"] == 1
        up = sc.decisions[-1]
        assert up["action"] == "up" and up["spawn_ttft_s"] is not None
        assert router.replicas[1].engine.lifecycle_state() == "serving"
        st = await router.submit([1, 2, 3, 4], max_new_tokens=2,
                                 temperature=0.0)
        toks, reason = await st.collect()
        assert reason in ("length", "stop") and len(toks) == 2
        code, body = await http(server.port, "GET", "/debug/autoscale")
        snap = json.loads(body)
        assert code == 200 and snap["replicas"] == 2
        assert snap["decisions"][-1]["action"] == "up"
        code, body = await http(server.port, "GET", "/metrics")
        assert code == 200 and b"autoscale_replicas 2" in body

        pressure.update(min_wait_s=0.0, max_wait_s=0.0)
        sc._cooldown_until = 0.0
        await sc.tick()
        assert len(router.replicas) == 1
        assert sc.metrics.counters["autoscale_downs"] == 1
        assert sc.decisions[-1]["action"] == "down"
        retired = born[1]
        assert retired.lifecycle_state() == "stopped"
        tr = retired.engine.lifecycle.transitions()
        assert all(b in LEGAL[side][a] for a, b in tr)
        assert sum(1 for _, b in tr if b == "stopped") == 1
        await server.shutdown()
        return toks

    toks = asyncio.run(run())
    assert toks == f.engine().generate([[1, 2, 3, 4]], max_new_tokens=2)[0]


@pytest.mark.parametrize("side", SIDES)
def test_autoscale_endpoint_404_when_off(side, fleets):
    f = fleets[side]

    async def run():
        router = f.router([f.front(f.engine(max_batch=2))],
                          sweep_interval_s=3600.0)
        server = f.serving.RouterServer(router, port=0)
        await server.start()
        code, body = await http(server.port, "GET", "/debug/autoscale")
        assert code == 404 and b"autoscale-max" in body
        await server.shutdown()

    asyncio.run(run())


class _LateWorkers(concurrent.futures.ThreadPoolExecutor):
    """Workers that let go of what they ran only late (here: never), as a
    worker does that waits for the GIL after its result has already woken
    the event loop."""

    def __init__(self):
        super().__init__(max_workers=4)
        self.ran = []

    def submit(self, fn, /, *args, **kwargs):
        self.ran.append((fn, args, kwargs))
        return super().submit(fn, *args, **kwargs)


@pytest.mark.parametrize("how", ["retire", "scale_down"])
def test_a_retired_engine_is_gone_when_the_retire_returns(fleets, how):
    """The port's scale-down frees the replica it retires before it
    returns: right after `retire_replica` (or the autoscaler's scale-down
    of a spawned replica that streamed over HTTP), the retired
    AsyncLLMEngine's thread is not alive, and after one gc.collect(), with
    no wait, weak references to it and to its LLMEngine are dead, even
    with executor workers that hold on to what they ran."""
    f = fleets["torch"]

    def factory(i):
        return f.front(f.engine(max_batch=2, warmup=True,
                                host_kv_blocks=8))

    async def run():
        workers = _LateWorkers()
        asyncio.get_running_loop().set_default_executor(workers)
        router = f.router([factory(0), factory(1)], factory=factory,
                          sweep_interval_s=0.05)
        sc = f.serving.AutoScaler(router, factory=factory, min_replicas=1,
                                  max_replicas=3, up_streak=1,
                                  down_streak=1, cooldown_s=0.0)
        server = f.serving.RouterServer(router, port=0, autoscaler=sc)
        await server.start()
        await sc.stop()            # this test drives the loop by hand
        if how == "scale_down":
            sc.signals = lambda: {
                "active": len(router.replicas),
                "replicas": len(router.replicas), "worst_attainment": None,
                "window_events": 0, "min_wait_s": 9.9, "max_wait_s": 9.9,
                "inflight": 0}
            await sc.tick()
            assert len(router.replicas) == 3
        home = router.replicas[-1].name
        for i in range(3):
            code, body = await http(server.port, "POST", "/v1/completions", {
                "prompt": homed_prompt(router, home, seed0=100 * i),
                "max_tokens": 3, "stream": i % 2 == 0})
            assert code == 200, body
        fe = router.replicas[-1].engine
        thread, front, engine = fe._thread, weakref.ref(fe), weakref.ref(
            fe.engine)
        del fe
        if how == "scale_down":
            sc.signals = lambda: {
                "active": len(router.replicas),
                "replicas": len(router.replicas), "worst_attainment": None,
                "window_events": 0, "min_wait_s": 0.0, "max_wait_s": 0.0,
                "inflight": 0}
            sc._cooldown_until = 0.0
            await sc.tick()
            assert sc.decisions[-1]["action"] == "down"
        else:
            assert await router.retire_replica() == home
        alive = thread.is_alive()
        del thread
        gc.collect()
        gone = front() is None, engine() is None
        await server.shutdown()
        workers.ran.clear()
        return alive, gone

    alive, gone = asyncio.run(run())
    assert not alive
    assert gone == (True, True)


def test_a_sweep_during_a_retire_leaves_the_retired_replica_alone(fleets):
    """A health sweep that runs while `retire_replica` shuts the retired
    engine down (its thread gone: healthz "engine_dead") finds the replica
    already out of the fleet: it ejects nothing and starts no salvage task
    that would hold the engine, so the engine is gone when the retire
    returns (after one gc.collect(), with no wait)."""
    f = fleets["torch"]

    def factory(i):
        return f.front(f.engine(max_batch=2, host_kv_blocks=8))

    async def run():
        # the loop's own sweep stays idle: this test sweeps by hand
        router = f.router([factory(0), factory(1)], factory=factory,
                          sweep_interval_s=3600.0)
        await router.start()
        fe = router.replicas[-1].engine
        name, engine = router.replicas[-1].name, weakref.ref(fe.engine)
        stop = [fe.shutdown]     # emptied by its call: holds fe no longer

        async def shutdown_then_sweep(*args, **kwargs):
            await stop.pop()(*args, **kwargs)
            router._sweep_once(time.monotonic())

        fe.shutdown = shutdown_then_sweep
        del fe
        assert await router.retire_replica() == name
        gc.collect()
        gone = engine() is None
        events = [e["event"] for e in router.snapshot()["events"]
                  if e["replica"] == name]
        await router.shutdown()
        return gone, events

    gone, events = asyncio.run(run())
    assert "eject" not in events, events
    assert gone
