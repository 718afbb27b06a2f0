"""The port's `AsyncLLMEngine` against the JAX package's, on the CPU.

The same tiny GPT weights in both packages (`test_torch_server.make_sides`)
and the same scenarios through each package's asyncio frontend: streamed
greedy tokens, a lagging consumer (lossless catch-up), cancellation,
deadlines, the bounded wait queue and the KV commitment gate, graceful
and hard shutdown, the engine-thread guard, and the lifecycle's
transition sequence. Each scenario's outcome must be equal across the
two packages, and the pool idle afterwards.
"""
import asyncio
import threading

import pytest

from test_torch_server import idle, make_sides, prompts, run_both, wait_for
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

P = prompts((7, 12, 4, 20), seed=3)


@pytest.fixture(scope="module")
def sides():
    return make_sides()


async def _streams(side):
    """Four streams at once, one consumer lagging behind a queue of 2."""
    engine = side.engine()
    fe = side.serving.AsyncLLMEngine(engine, stream_queue_size=2)
    await fe.start()
    try:
        streams = [fe.submit(p, max_new_tokens=12, request_id=f"s{i}")
                   for i, p in enumerate(P)]
        # the last consumer reads nothing until its request is done, so
        # its queue overflows and it catches up from output_ids
        await asyncio.wait_for(streams[-1].done.wait(), 60.0)
        outs = await asyncio.gather(*[st.collect() for st in streams])
    finally:
        await fe.shutdown(drain=True)
    direct = side.engine().generate(P, max_new_tokens=12)
    return (outs, direct, engine.metrics.counters.get("backpressure_drops",
                                                      0) > 0, idle(engine))


def test_streamed_tokens_and_backpressure_match_jax(sides):
    got = run_both(sides, _streams)
    assert got["torch"] == got["jax"]
    outs, direct, dropped, is_idle = got["torch"]
    assert [t for t, _ in outs] == direct
    assert all(r == "length" for _, r in outs)
    assert dropped and is_idle


async def _cancel_and_deadline(side):
    engine = side.engine()
    fe = side.serving.AsyncLLMEngine(engine)
    await fe.start()
    try:
        st = fe.submit(P[0], max_new_tokens=50)
        first = await st.tokens().__anext__()
        fe.abort(st.request_id)
        await st.done.wait()
        dl = fe.submit(P[1], max_new_tokens=50, timeout_s=0.001)
        await dl.done.wait()
        after = await fe.generate(P[2], max_new_tokens=5)
    finally:
        await fe.shutdown(drain=True)
    c = engine.metrics.counters
    return (isinstance(first, int), st.finish_reason, dl.finish_reason,
            after, c["requests_cancelled"], c["requests_timeout"],
            idle(engine))


def test_cancellation_and_deadline_match_jax(sides):
    got = run_both(sides, _cancel_and_deadline)
    assert got["torch"] == got["jax"]
    ok, cancelled, timeout, after, n_cancel, n_timeout, is_idle = \
        got["torch"]
    assert ok and cancelled == "cancelled" and timeout == "timeout"
    assert len(after[0]) == 5 and after[1] == "length"
    assert n_cancel == n_timeout == 1 and is_idle


async def _admission(side):
    """The wait-queue bound and the worst-case KV gate reject with their
    reasons; drain then refuses with `draining`."""
    engine = side.engine(max_batch=1)
    fe = side.serving.AsyncLLMEngine(engine, max_waiting=1,
                                     max_kv_commit_blocks=12)
    serving = side.serving
    await fe.start()
    out = []
    try:
        a = fe.submit(P[0], max_new_tokens=40)     # 6 blocks at worst
        try:
            fe.submit(P[3], max_new_tokens=40)     # 8 more: past 12
        except serving.EngineOverloadedError as e:
            out.append(("kv", e.reason, e.retry_after_s))
        b = fe.submit(P[2], max_new_tokens=4)      # 1 block: fits
        try:
            fe.submit(P[2], max_new_tokens=4)      # lanes + queue full
        except serving.EngineOverloadedError as e:
            out.append(("queue", e.reason, e.retry_after_s))
        res = await asyncio.gather(a.collect(), b.collect())
        fe.stop_admitting()
        try:
            fe.submit(P[2], max_new_tokens=4)
        except serving.EngineClosedError as e:
            out.append(("closed", e.reason, e.retry_after_s))
        out.append(fe.healthz_state()[0])
    finally:
        await fe.shutdown(drain=True)
    return out, [r for _, r in res], idle(engine)


def test_admission_control_matches_jax(sides):
    got = run_both(sides, _admission)
    assert got["torch"] == got["jax"]
    out, reasons, is_idle = got["torch"]
    assert out == [("kv", "kv_capacity", 1.0), ("queue", "queue_full", 1.0),
                   ("closed", "draining", 5.0), "draining"]
    assert reasons == ["length", "length"] and is_idle


async def _shutdowns(side):
    """A hard shutdown cancels what is in flight; the lifecycle walks the
    same states in both packages; the guard refuses a foreign thread.
    Slowed steps keep the request in flight until the stop lands."""
    side.faults.install(side.faults.FaultPlan(
        [{"point": "slow_step_ms", "ms": 5.0}]))
    engine = side.engine()
    fe = side.serving.AsyncLLMEngine(engine)
    await fe.start()
    guard = []

    def foreign():
        try:
            engine.step()
        except RuntimeError as e:
            guard.append("AsyncLLMEngine" in str(e))

    t = threading.Thread(target=foreign)
    t.start()
    t.join()
    st = fe.submit(P[3], max_new_tokens=40)
    await st.tokens().__anext__()
    await fe.shutdown(drain=False)
    await st.done.wait()
    return (st.finish_reason, guard, [s for s, _ in
                                      engine.lifecycle.transitions()],
            engine.lifecycle.state, fe.healthz_state()[0], idle(engine),
            fe._thread.is_alive())


def test_hard_shutdown_guard_and_lifecycle_match_jax(sides):
    got = run_both(sides, _shutdowns)
    assert got["torch"] == got["jax"]
    reason, guard, path, state, health, is_idle, alive = got["torch"]
    assert reason == "cancelled" and guard == [True]
    assert path == ["cold", "loading", "warm", "serving", "draining"]
    assert state == "stopped" and health == "engine_dead"
    assert is_idle and not alive


async def _drain(side):
    """Graceful drain: in-flight work finishes, the thread exits, the
    engine can be driven synchronously again."""
    engine = side.engine(warmup=True)
    fe = side.serving.AsyncLLMEngine(engine)
    await fe.start()
    st = fe.submit(P[1], max_new_tokens=8)
    await wait_for(lambda: len(st.req.output_ids) > 0, msg="first token")
    await fe.shutdown(drain=True)
    toks, reason = await st.collect()
    again = engine.generate([P[1]], max_new_tokens=8)[0]
    return (toks, reason, toks == again, engine.lifecycle.snapshot()["warmed"],
            engine.metrics.gauges["jit_retraces"], idle(engine))


def test_graceful_drain_matches_jax(sides):
    got = run_both(sides, _drain)
    assert got["torch"] == got["jax"]
    toks, reason, same, warmed, retraces, is_idle = got["torch"]
    assert len(toks) == 8 and reason == "length" and same
    assert warmed and retraces == 0 and is_idle
