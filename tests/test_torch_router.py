"""The port's fleet router (`paddle_tpu_torch.serving.ReplicaRouter`,
`RouterServer`) against the JAX package's, on the CPU.

Each scenario of `tests/test_serving_router.py` runs on both packages
(`side` is "jax" or "torch"), over one tiny GPT whose weights are the same
numbers on both sides (`from_jax_state_dict`), and holds each side to the
reference test's assertions: prefix affinity co-locates shared prefixes
and keeps the single-replica hit rate, retry-elsewhere, the retry budget's
429, deadline-aware early rejection, the restartless rolling drain, the
fleet-merged SLO rollup and the RouterServer surface. Across the
packages: the same requests through both routers give the same tokens
(an adapter request included); `home_replica` is the JAX router's for 200
seeded prompts, adapter-salted keys included; `SLOLedger.merged_rollup`
equals the JAX one on the same ledger events. The fleet cases of
`tests/test_kv_tier.py` close the file: the merged `/debug/kvtier`, the
rolling drain's host-tier handoff and the salvage off an ejected
replica.

The helpers here (`Fleet`, `make_fleets`, `prompts`, `homed_prompt`,
`http`, `parse_prom`) are shared with `test_torch_router_chaos.py` and
`test_torch_autoscale.py`.
"""
import asyncio
import json
import re
import threading
import time

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.serving as jserving
import paddle_tpu_torch.serving as tserving
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models import lora as jlora
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch.models import lora as tlora
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.weights import from_jax_state_dict
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)
SIDES = ("jax", "torch")


class Fleet:
    """One package's fleet surface over one model: `serving` is the
    package's `serving` module; `engine(**kw)` builds its LLMEngine (the
    port's on the CPU) with the reference tests' defaults."""

    def __init__(self, name, serving, model):
        self.name = name
        self.serving = serving
        self.faults = serving.faults
        self.model = model

    def engine(self, **kw):
        kw.setdefault("block_size", 8)
        kw.setdefault("max_batch", 4)
        kw.setdefault("max_seq_len", 64)
        if self.name == "torch":
            kw["device"] = "cpu"
        return self.serving.LLMEngine(self.model, **kw)

    def front(self, engine=None, **kw):
        return self.serving.AsyncLLMEngine(
            self.engine() if engine is None else engine, **kw)

    def router(self, replicas, **kw):
        return self.serving.ReplicaRouter(replicas, **kw)


def make_fleets():
    """{"jax": Fleet, "torch": Fleet} over one set of random weights."""
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, attn_impl="xla", dropout=0.0))
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in state_dict_arrays(jm)[0].items()}
    tm = from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"), arrays)
    return {"jax": Fleet("jax", jserving, jm),
            "torch": Fleet("torch", tserving, tm)}


def prompts(lengths, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, (n,)).tolist() for n in lengths]


def homed_prompt(router, home, length=12, seed0=1000):
    """A fresh random prompt whose affinity key rendezvous-routes to
    `home`."""
    seed = seed0
    while True:
        seed += 1
        p = np.random.RandomState(seed).randint(0, 128, (length,)).tolist()
        if router.home_replica(p) == home:
            return p


def fleet_idle(router):
    for r in router.replicas:
        eng = r.engine.engine
        assert eng.pool._refcount == {}
        assert eng.pool.num_free == eng.pool.num_blocks - 1


async def http(port, method, path, obj=None):
    """One loopback HTTP exchange: (status, body bytes)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(obj).encode() if obj is not None else b""
    writer.write(
        (f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
         f"Content-Type: application/json\r\n"
         f"Content-Length: {len(data)}\r\n\r\n").encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionError, OSError):
        pass
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), body


_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prom(text):
    """Exposition conformance: every non-comment line parses and every
    label body is fully consumed by valid pairs. (types, samples)."""
    types, samples = {}, []
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        assert m is not None, f"unparseable sample line: {line!r}"
        labels = {}
        if m.group(2):
            body = m.group(2)[1:-1]
            rebuilt = ",".join(f'{k}="{v}"'
                               for k, v in _LABEL_RE.findall(body))
            assert rebuilt == body, f"bad label body: {body!r}"
            labels = dict(_LABEL_RE.findall(body))
        samples.append((m.group(1), labels, float(m.group(3))))
    return types, samples


@pytest.fixture(scope="module")
def fleets():
    return make_fleets()


@pytest.fixture(scope="module")
def refs(fleets):
    """{side: a shared no-fault engine} for reference outputs."""
    return {s: f.engine() for s, f in fleets.items()}


_TOKENS = {}   # (scenario, side) -> the tokens it served, for crossing


# -- routing policy -----------------------------------------------------------


@pytest.mark.parametrize("side", SIDES)
def test_affinity_routes_shared_prefixes_to_one_home(side, fleets, refs):
    f = fleets[side]
    shared = prompts((16,), seed=1)[0]      # two full blocks of 8
    ps = [shared + s for s in prompts((3, 5, 7, 4), seed=2)]
    want = refs[side].generate(ps, max_new_tokens=6, temperature=0.0)

    async def main():
        router = f.router([f.front() for _ in range(2)],
                          sweep_interval_s=0.02)
        await router.start()
        home = router.home_replica(ps[0])
        streams = [await router.submit(p, max_new_tokens=6, temperature=0.0)
                   for p in ps]
        outs = [await s.collect() for s in streams]
        other = [r.name for r in router.replicas if r.name != home][0]
        spread = homed_prompt(router, other)
        assert router.home_replica(spread) == other
        snap = router.snapshot()
        await router.shutdown()
        return home, streams, outs, snap

    home, streams, outs, snap = asyncio.run(main())
    assert all(s.replica == home for s in streams)          # co-located
    assert all(s.terminal_events == 1 for s in streams)
    for (toks, reason), ref in zip(outs, want):
        assert reason == "length" and toks == ref
    assert {r["state"] for r in snap["replicas"]} == {"active"}
    _TOKENS[("affinity", side)] = (home, [t for t, _ in outs])


def test_affinity_wave_matches_jax_fleet(fleets, refs):
    """The same shared-prefix wave through both routers: the same home
    and the same tokens, request by request."""
    for side in SIDES:
        if ("affinity", side) not in _TOKENS:
            test_affinity_routes_shared_prefixes_to_one_home(side, fleets,
                                                             refs)
    assert _TOKENS[("affinity", "torch")] == _TOKENS[("affinity", "jax")]


@pytest.mark.parametrize("side", SIDES)
def test_affinity_hit_rate_matches_single_replica_warm_serve(side, fleets):
    f = fleets[side]
    shared = prompts((24,), seed=3)[0]      # three full blocks
    ps = [shared + s for s in prompts((3, 4, 5, 6, 3, 4, 5, 6), seed=4)]

    def hit_rate(engines):
        hit = lookup = 0.0
        for e in engines:
            c = e.engine.metrics.counters
            hit += c.get("prefix_cache_hit_tokens", 0)
            lookup += c.get("prefix_cache_lookup_tokens", 0)
        return hit / lookup if lookup else 0.0

    async def wave(n_replicas, affinity):
        engines = [f.front() for _ in range(n_replicas)]
        router = f.router(engines, affinity=affinity, sweep_interval_s=0.05)
        await router.start()
        streams = [await router.submit(p, max_new_tokens=4, temperature=0.0)
                   for p in ps]
        outs = [await s.collect() for s in streams]
        assert all(r == "length" for _, r in outs)
        rate = hit_rate(engines)
        fleet_idle(router)
        await router.shutdown()
        return rate

    async def main():
        return (await wave(1, True), await wave(2, True),
                await wave(2, False))

    single, affin, spread = asyncio.run(main())
    assert single > 0.3
    assert affin == pytest.approx(single, abs=0.02)
    assert affin > spread


@pytest.mark.parametrize("side", SIDES)
def test_retry_elsewhere_on_draining_replica(side, fleets, refs):
    f = fleets[side]

    async def main():
        router = f.router([f.front() for _ in range(2)],
                          sweep_interval_s=0.02)
        await router.start()
        victim = router.replicas[0]
        p = homed_prompt(router, victim.name)
        victim.engine.stop_admitting()       # replica-side drain
        st = await router.submit(p, max_new_tokens=5, temperature=0.0)
        toks, reason = await st.collect()
        c = dict(router.metrics.counters)
        state = victim.state
        await router.shutdown()
        return st, toks, reason, c, state, p

    st, toks, reason, c, state, p = asyncio.run(main())
    assert reason == "length"
    assert st.replica == "r1"
    assert toks == refs[side].generate([p], max_new_tokens=5,
                                       temperature=0.0)[0]
    assert c.get("router_retries", 0) == 0
    assert state == "draining"


@pytest.mark.parametrize("side", SIDES)
def test_overload_retry_budget_exhausts_to_429(side, fleets):
    f = fleets[side]

    async def main():
        engines = [f.front(f.engine(max_batch=1), max_waiting=0)
                   for _ in range(2)]
        router = f.router(engines, retry_budget=1, backoff_base_s=0.01,
                          sweep_interval_s=0.05)
        await router.start()
        occupy = [await router.submit(p, max_new_tokens=40, temperature=0.0)
                  for p in prompts((4, 5), seed=5)]
        assert {s.replica for s in occupy} == {"r0", "r1"}
        with pytest.raises(f.serving.EngineOverloadedError) as ei:
            await router.submit(prompts((6,), seed=6)[0], max_new_tokens=2)
        err = ei.value
        for s in occupy:
            await s.collect()
        c = dict(router.metrics.counters)
        await router.shutdown()
        return err, c

    err, c = asyncio.run(main())
    assert err.reason == "queue_full"
    assert c["router_admission_rejects"] >= 2
    assert c["router_retries"] >= 1


@pytest.mark.parametrize("side", SIDES)
def test_deadline_aware_early_rejection(side, fleets):
    f = fleets[side]

    async def main():
        router = f.router([f.front(f.engine(max_batch=1), max_waiting=8)],
                          service_time_init_s=10.0, sweep_interval_s=0.05)
        await router.start()
        long = await router.submit(prompts((4,), seed=7)[0],
                                   max_new_tokens=40, temperature=0.0)
        with pytest.raises(f.serving.EngineOverloadedError) as ei:
            await router.submit(prompts((5,), seed=8)[0],
                                max_new_tokens=2, deadline_s=0.2)
        ok = await router.submit(prompts((5,), seed=8)[0],
                                 max_new_tokens=2, temperature=0.0)
        await long.collect()
        _, reason = await ok.collect()
        c = dict(router.metrics.counters)
        await router.shutdown()
        return ei.value, reason, c

    err, reason, c = asyncio.run(main())
    assert err.reason == "deadline_unattainable"
    assert err.retry_after_s is not None and err.retry_after_s > 0.2
    assert reason == "length"
    assert c["router_early_rejections"] == 1


@pytest.mark.parametrize("side", SIDES)
def test_rolling_drain_without_factory_reopens_admission(side, fleets, refs):
    f = fleets[side]
    ps = prompts((6, 9, 12, 7, 10, 8), seed=9)
    want = refs[side].generate(ps, max_new_tokens=8, temperature=0.0)

    async def main():
        router = f.router([f.front() for _ in range(2)],
                          sweep_interval_s=0.02)
        await router.start()
        streams = [await router.submit(p, max_new_tokens=8, temperature=0.0)
                   for p in ps]
        drained = await router.rolling_drain()
        outs = [await s.collect() for s in streams]
        post = [await router.generate(p, max_new_tokens=3, temperature=0.0)
                for p in ps[:2]]
        c = dict(router.metrics.counters)
        states = [r.state for r in router.replicas]
        fleet_idle(router)
        await router.shutdown()
        return drained, outs, post, c, states

    drained, outs, post, c, states = asyncio.run(main())
    assert drained == ["r0", "r1"]
    assert c["router_drains"] == 2
    assert states == ["active", "active"]
    for (toks, reason), ref in zip(outs, want):
        assert reason == "length" and toks == ref
    assert all(r == "length" for _, r in post)
    assert c.get("router_requests_failed", 0) == 0


# -- fleet SLO rollup ---------------------------------------------------------


def _ledger_events(serving, ledgers):
    """The reference test's events: per ledger three deadline-met
    requests of one class and one aborted request of its own tenant."""
    for i, led in enumerate(ledgers):
        for _ in range(3):
            req = serving.Request([1, 2, 3], tenant="acme", priority="hi",
                                  deadline_s=30.0)
            led.begin(req)
            req.output_ids = [1, 2]
            req.first_token_time = time.monotonic()
            led.finalize(req, "finished")
        req = serving.Request([1, 2, 3], tenant=f"solo{i}")
        led.begin(req)
        led.finalize(req, "aborted")


@pytest.mark.parametrize("side", SIDES)
def test_merged_rollup_sums_replica_ledgers(side, fleets):
    serving = fleets[side].serving
    ledgers = [serving.SLOLedger(), serving.SLOLedger()]
    _ledger_events(serving, ledgers)
    merged = serving.SLOLedger.merged_rollup(ledgers)
    assert merged["total"]["requests"] == 8
    by_class = {(c["tenant"], c["priority"]): c for c in merged["classes"]}
    acme = by_class[("acme", "hi")]
    assert acme["requests"] == 6 and acme["finished"] == 6
    assert acme["e2e_ms"]["count"] == 6
    assert acme["deadline"]["met"] == 6
    assert by_class[("solo0", "-")]["aborted"] == 1
    assert by_class[("solo1", "-")]["aborted"] == 1
    assert merged.keys() == ledgers[0].rollup().keys()


def test_merged_rollup_equals_jax_on_the_same_events(fleets, monkeypatch):
    """The same ledger events through both packages' ledgers, on a frozen
    clock: equal merged rollups, every number included."""
    out = {}
    for side in SIDES:
        serving = fleets[side].serving
        clock = iter(np.arange(0.0, 1000.0, 0.125))
        monkeypatch.setattr(time, "monotonic", lambda: float(next(clock)))
        ledgers = [serving.SLOLedger(), serving.SLOLedger()]
        _ledger_events(serving, ledgers)
        out[side] = serving.SLOLedger.merged_rollup(ledgers)
        monkeypatch.undo()
    assert out["torch"] == out["jax"]


# -- prefix affinity: the same homes as the JAX router --------------------------


@pytest.mark.parametrize("adapter", [None, "alpha", "beta"])
def test_home_replica_equals_the_jax_routers(fleets, adapter):
    """200 seeded prompts (shorter than a block, one block, several),
    optionally salted by an adapter name: the port's `home_replica` is the
    JAX router's, replica for replica, and the affinity keys are equal
    bytes."""
    async def homes(side):
        f = fleets[side]
        router = f.router([f.front() for _ in range(3)],
                          sweep_interval_s=3600.0)
        rs = np.random.RandomState(42)
        ps = [rs.randint(0, 128, (int(n),)).tolist()
              for n in rs.randint(1, 40, 200)]
        out = [(router.home_replica(p, adapter=adapter),
                router.affinity_key(p, adapter=adapter)) for p in ps]
        await router.shutdown()
        return out

    got = {side: asyncio.run(homes(side)) for side in SIDES}
    assert got["torch"] == got["jax"]
    names = [h for h, _ in got["torch"]]
    assert set(names) == {"r0", "r1", "r2"}     # the keys spread


@pytest.mark.parametrize("side", SIDES)
def test_router_affinity_keys_on_adapter(side, fleets):
    """The router homes (adapter, prefix) pairs: the same prompt under an
    adapter has another key, and an adapter request routes end to end to
    the tokens of a direct engine serving it through the adapter (f32:
    the packages' LoRA sums agree)."""
    f = fleets[side]
    lora = jlora if side == "jax" else tlora
    w = lora.random_adapter(f.model.cfg, 4, lora.LORA_TARGETS, seed=7,
                            scale=0.5)
    prompt = list(range(1, 11))

    def engine():
        e = f.engine(lora_slots=1, lora_rank=4)
        e.load_adapter("a", w, alpha=8)
        return e

    want = engine().generate([prompt], max_new_tokens=6, adapter="a")[0]

    async def main():
        router = f.router([f.front(engine()) for _ in range(2)],
                          sweep_interval_s=0.02)
        await router.start()
        keys = (router.affinity_key(prompt),
                router.affinity_key(prompt, "a"))
        rs = await router.submit(prompt, max_new_tokens=6, adapter="a")
        got = await rs.collect()
        await router.shutdown()
        return keys, got

    (base_key, adapter_key), (toks, reason) = asyncio.run(main())
    assert base_key != adapter_key
    assert reason == "length" and toks == want
    _TOKENS[("adapter", side)] = toks


def test_adapter_route_matches_jax(fleets):
    for side in SIDES:
        if ("adapter", side) not in _TOKENS:
            test_router_affinity_keys_on_adapter(side, fleets)
    assert _TOKENS[("adapter", "torch")] == _TOKENS[("adapter", "jax")]


# -- RouterServer HTTP surface + exposition conformance -----------------------


@pytest.mark.parametrize("side", SIDES)
def test_router_server_endpoints_and_metrics_conformance(side, fleets, refs):
    f = fleets[side]
    ps = prompts((9, 13, 11), seed=10)
    want = refs[side].generate(ps, max_new_tokens=5, temperature=0.0)

    async def main():
        router = f.router([f.front(f.engine(slo=True)) for _ in range(2)],
                          sweep_interval_s=0.02)
        server = f.serving.RouterServer(router, port=0)
        await server.start()
        full = await http(server.port, "POST", "/v1/completions",
                          {"prompt": ps[0], "max_tokens": 5,
                           "tenant": "acme", "timeout_s": 30.0})
        sse = await http(server.port, "POST", "/v1/completions",
                         {"prompt": ps[1], "max_tokens": 5,
                          "stream": True, "tenant": "free"})
        bad = await http(server.port, "POST", "/v1/completions",
                         {"prompt": "nope"})
        await http(server.port, "POST", "/v1/completions",
                   {"prompt": ps[2], "max_tokens": 5})
        health = await http(server.port, "GET", "/healthz")
        table = await http(server.port, "GET", "/debug/router")
        slo = await http(server.port, "GET", "/debug/slo")
        metrics = await http(server.port, "GET", "/metrics")
        await server.shutdown()
        return full, sse, bad, health, table, slo, metrics

    full, sse, bad, health, table, slo, metrics = asyncio.run(main())
    assert full[0] == 200
    assert json.loads(full[1])["choices"][0]["token_ids"] == want[0]
    assert sse[0] == 200 and b"[DONE]" in sse[1]
    sse_toks = []
    for line in sse[1].decode().splitlines():
        if line.startswith("data: ") and line != "data: [DONE]":
            sse_toks.extend(json.loads(line[6:])["choices"][0]["token_ids"])
    assert sse_toks == want[1]
    assert bad[0] == 400

    assert health[0] == 200
    h = json.loads(health[1])
    assert h["status"] == "ok" and h["replicas_active"] == 2
    assert {r["name"] for r in h["replicas"]} == {"r0", "r1"}
    assert all(r["state"] == "active" and r["healthz"] == "ok"
               for r in h["replicas"])

    assert table[0] == 200
    snap = json.loads(table[1])
    assert snap["affinity"] is True and len(snap["replicas"]) == 2

    assert slo[0] == 200
    roll = json.loads(slo[1])
    assert roll["total"]["requests"] == 3
    assert {"acme", "free", "-"} <= {c["tenant"] for c in roll["classes"]}

    assert metrics[0] == 200
    text = metrics[1].decode()
    types, samples = parse_prom(text)
    pre = "paddle_tpu_serving_"
    names = {n for n, _, _ in samples}
    for fam, kind in (("router_requests_total", "counter"),
                      ("router_replica_requests_total", "counter"),
                      ("router_replicas_active", "gauge"),
                      ("router_inflight", "gauge"),
                      ("router_prefix_cache_hit_rate", "gauge")):
        assert pre + fam in names, fam
        assert types[pre + fam] == kind
        assert f"# HELP {pre}{fam} " in text
    replica_labels = {tuple(sorted(lab.items()))
                      for n, lab, _ in samples
                      if n == pre + "router_replica_requests_total"}
    assert all(dict(lt).get("replica") in ("r0", "r1")
               for lt in replica_labels)
    _TOKENS[("server", side)] = [
        json.loads(full[1])["choices"][0]["token_ids"], sse_toks]


def test_router_server_tokens_match_jax(fleets, refs):
    for side in SIDES:
        if ("server", side) not in _TOKENS:
            test_router_server_endpoints_and_metrics_conformance(
                side, fleets, refs)
    assert _TOKENS[("server", "torch")] == _TOKENS[("server", "jax")]


@pytest.mark.parametrize("side", SIDES)
def test_router_healthz_poison_field_on_single_server(side, fleets):
    f = fleets[side]

    async def main():
        server = f.serving.ServingServer(f.engine(), port=0)
        await server.start()
        status, body = await http(server.port, "GET", "/healthz")
        mstatus, mbody = await http(server.port, "GET", "/metrics")
        await server.shutdown()
        return status, json.loads(body), mstatus, mbody.decode()

    status, health, mstatus, metrics = asyncio.run(main())
    assert status == 200
    assert health["poison"] == {"window_s": 60.0, "isolated_in_window": 0,
                                "distinct_sources": 0}
    assert mstatus == 200
    assert "paddle_tpu_serving_poison_distinct_sources 0" in metrics


# -- the host KV tier across the fleet (tests/test_kv_tier.py's fleet cases) --


def _tier_engine(f, **kw):
    kw.setdefault("host_kv_blocks", 24)
    return f.engine(**kw)


@pytest.fixture
def _no_tier_env(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_TP", raising=False)
    monkeypatch.delenv("PADDLE_TPU_HOST_KV_BLOCKS", raising=False)


@pytest.mark.parametrize("side", SIDES)
def test_router_debug_kvtier_merges_replicas(side, fleets, _no_tier_env):
    f = fleets[side]

    async def main():
        bare = f.router([f.front() for _ in range(2)],
                        sweep_interval_s=0.05)
        off = f.serving.RouterServer(bare, port=0)
        await off.start()
        off_resp = await http(off.port, "GET", "/debug/kvtier")
        await off.shutdown()
        router = f.router([f.front(_tier_engine(f)) for _ in range(2)],
                          sweep_interval_s=0.05)
        server = f.serving.RouterServer(router, port=0)
        await server.start()
        resp = await http(server.port, "GET", "/debug/kvtier")
        await server.shutdown()
        return off_resp, resp

    off_resp, resp = asyncio.run(main())
    assert off_resp[0] == 404 and b"host_kv_blocks" in off_resp[1]
    assert resp[0] == 200
    snaps = json.loads(resp[1])
    assert set(snaps) == {"r0", "r1"}
    assert all(s["host_blocks_total"] == 24 for s in snaps.values())


@pytest.mark.parametrize("side", SIDES)
def test_rolling_drain_migrates_and_serves_host_warm(side, fleets, refs,
                                                     _no_tier_env):
    """A rolling drain with a factory restarts every replica (the factory
    runs on a worker thread), the old home's cache rides along through the
    host tier (export and import each on its engine's own thread), zero
    requests fail, and a re-serve after the drain hits the new engines'
    host tier with the same tokens."""
    f = fleets[side]
    shared = prompts((16,), seed=3)[0]
    ps = [shared + t for t in prompts((3, 5, 4), seed=4)]
    want = refs[side].generate(ps, max_new_tokens=6, temperature=0.0)

    def factory(i):
        return f.front(_tier_engine(f, num_blocks=12))

    async def main():
        router = f.router([factory(i) for i in range(2)], factory=factory,
                          sweep_interval_s=0.05)
        await router.start()
        warm = [await (await router.submit(
            p, max_new_tokens=6, temperature=0.0)).collect() for p in ps]
        streams = [await router.submit(p, max_new_tokens=6, temperature=0.0)
                   for p in ps]
        drained = await router.rolling_drain()
        mid = [await s.collect() for s in streams]
        post = [await (await router.submit(
            p, max_new_tokens=6, temperature=0.0)).collect() for p in ps]
        swap_ins = sum(r.engine.engine.tier.swap_ins
                       for r in router.replicas)
        c = dict(router.metrics.counters)
        await router.shutdown()
        return drained, warm, mid, post, swap_ins, c

    drained, warm, mid, post, swap_ins, c = asyncio.run(main())
    assert drained == ["r0", "r1"]
    assert c["router_restarts"] == 2
    assert c["router_migrations"] >= 1
    assert c["router_migrated_blocks"] > 0
    assert c.get("router_requests_failed", 0) == 0
    for (toks, reason), ref in zip(warm + mid + post, want * 3):
        assert reason == "length" and toks == ref
    assert swap_ins > 0


@pytest.mark.parametrize("side", SIDES)
def test_ejection_salvages_host_tier_to_live_replicas(side, fleets,
                                                      _no_tier_env):
    """Salvaging an ejected replica's SETTLED host blocks reads only its
    slabs (safe on a live engine); each peer adopts them on its own
    engine thread."""
    f = fleets[side]

    async def main():
        router = f.router([f.front(_tier_engine(f, num_blocks=10))
                           for _ in range(2)], sweep_interval_s=0.05)
        await router.start()
        victim = router.replicas[0]
        eng = victim.engine.engine
        for r in range(2):
            for p in prompts((17, 25, 19), seed=5 + 7 * r):
                await victim.engine.submit(
                    p, max_new_tokens=4, temperature=0.0).collect()
        await asyncio.to_thread(eng.tier.settle)
        await router._migrate_from(victim)
        peer = router.replicas[1].engine.engine
        c = dict(router.metrics.counters)
        got = peer.tier.migrated_blocks_in
        await router.shutdown()
        return c, got

    c, got = asyncio.run(main())
    assert c["router_migrations"] == 1
    assert got > 0 and c["router_migrated_blocks"] == got


def test_import_into_a_live_replica_goes_through_its_thread(fleets,
                                                            _no_tier_env):
    """While an AsyncLLMEngine drives the port's engine, a host-tier import
    from another thread is refused (`_guard_thread`); through
    `AsyncLLMEngine.call` it runs on the engine thread."""
    f = fleets["torch"]

    async def main():
        src = _tier_engine(f, num_blocks=10)
        for p in prompts((17, 25, 19), seed=5):
            src.generate([p], max_new_tokens=4)
        payload = src.export_kv_tier(demote=True)
        fe = f.front(_tier_engine(f))
        await fe.start()
        with pytest.raises(RuntimeError, match="background loop"):
            await asyncio.to_thread(fe.engine.import_kv_tier, payload)
        n = await fe.call(lambda: fe.engine.import_kv_tier(payload))
        thread = await fe.call(lambda: threading.current_thread())
        await fe.shutdown()
        return payload, n, thread, fe

    payload, n, thread, fe = asyncio.run(main())
    assert n == len(payload["entries"]) > 0
    assert thread is fe._thread
