"""The port's host KV tier (`paddle_tpu_torch.serving.kv_tier`) against the
JAX package's, on the CPU and on one device.

Both packages serve a tiny GPT built from the same numpy weights. The
acceptance case is the JAX package's (`tests/test_kv_tier.py`): a document
prompt served cold, again device-warm, churned out of a tight device pool
(its blocks demoted to the host tier) and served host-warm must give the
same greedy tokens each time and the JAX engine's, over a float and an
int8 arena; the int8 arena's restored blocks carry their scales back bit
for bit. Around it: a churn sweep of swap-ins, swap-outs, copy-on-write,
preemptions and aborts leaves pool and tier idle; a small tier keeps its
newest entries; `/debug/kvtier` and the tier's pool stats read as the JAX
server's; and an export from one port engine imports into another and
serves host-warm.
"""
import asyncio
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jserving
import paddle_tpu_torch.serving as tserving
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.serving import LLMEngine
from paddle_tpu_torch.weights import from_jax_state_dict
from test_torch_server import http
from test_torch_serving_sharded import cpu_mesh
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)
ENGINE = dict(block_size=8, max_batch=4, max_seq_len=64)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, attn_impl="xla", dropout=0.0))
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in state_dict_arrays(jm)[0].items()}
    return jm, from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"),
                                   arrays)


@pytest.fixture(autouse=True)
def _no_env_knobs(monkeypatch):
    for var in ("PADDLE_TPU_HOST_KV_BLOCKS", "PADDLE_TPU_KV_DTYPE"):
        monkeypatch.delenv(var, raising=False)


def _prompts(lengths, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, (n,)).tolist() for n in lengths]


def _engine(model, **kw):
    kw = {**ENGINE, "host_kv_blocks": 24, **kw}
    return LLMEngine(model, device="cpu", **kw)


def _idle(engine):
    assert engine.pool._refcount == {}
    assert engine.pool.num_free == engine.pool.num_blocks - 1


def _tier_consistent(tier):
    """Host-slot conservation: every slot is exactly one of free or
    indexed, and nothing is pending after a settle."""
    tier.settle()
    with tier._lock:
        assert tier._pending == {}
        assert tier._save_buf == []
        used = set(tier._index.values())
        assert len(used) == len(tier._index)          # no slot aliasing
        assert used.isdisjoint(tier._free_slots)
        assert len(used) + len(tier._free_slots) == tier.host_blocks


def _churn(engine, rounds=3, seed=5):
    """Over-capacity distinct-prefix traffic: fills the device pool and
    forces LRU evictions (host-tier demotions) every round."""
    for r in range(rounds):
        engine.generate(_prompts((17, 25, 19), seed=seed + 7 * r),
                        max_new_tokens=4, temperature=0.0)


def _doc_prompts():
    doc = _prompts((24,), seed=1)[0]                   # three full blocks
    return [doc + t for t in _prompts((3, 5), seed=2)]


# -- token parity: host-warm == cold == device-warm == JAX ---------------------


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_host_warm_matches_cold_device_warm_and_jax(models, kv_dtype):
    jm, tm = models
    prompts = _doc_prompts()
    want = jserving.LLMEngine(jm, kv_dtype=kv_dtype, **ENGINE).generate(
        prompts, max_new_tokens=6, temperature=0.0)

    engine = _engine(tm, num_blocks=12, kv_dtype=kv_dtype)   # 11 usable
    cold = engine.generate(prompts, max_new_tokens=6, temperature=0.0)
    pool = engine.pool
    saved = {h: [a[:, :, b].clone() for a in engine.tier._arenas()]
             for h, b in pool._hash_index.items()}
    warm = engine.generate(prompts, max_new_tokens=6, temperature=0.0)
    ins_before = engine.tier.swap_ins
    _churn(engine)                                     # demote doc blocks
    engine.tier.settle()
    assert engine.tier.swap_outs > 0
    hostwarm = engine.generate(prompts, max_new_tokens=6, temperature=0.0)
    assert cold == warm == hostwarm == want
    assert engine.tier.swap_ins > ins_before           # came from host
    assert engine.tier.swap_in_hit_tokens >= \
        (engine.tier.swap_ins - ins_before) * pool.block_size
    # the restored blocks hold the cold serve's bytes (and an int8 arena's
    # scales) bit for bit
    restored = [h for h in saved if h in pool._hash_index]
    assert restored
    for h in restored:
        b = pool._hash_index[h]
        for before, arena in zip(saved[h], engine.tier._arenas()):
            assert torch.equal(arena[:, :, b], before)
    assert len(engine.tier._arenas()) == (4 if kv_dtype else 2)
    c = engine.metrics.counters
    assert c["host_syncs"] == engine.step_count
    assert c["swap_ins"] == engine.tier.swap_ins
    _idle(engine)
    _tier_consistent(engine.tier)
    engine.close()


# -- tensor parallel: per-shard slabs, cross-topology migration ---------------


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_tp2_per_shard_slabs_and_spec_on_parity(models, kv_dtype):
    """tp=2 with speculative decoding: each rank's slab holds its own head
    range (a save never gathers across ranks), and cold and host-warm
    serves give the one-card tokens, the JAX engine's and the JAX tp=2
    tier engine's."""
    jm, tm = models
    prompts = _doc_prompts()
    spec = dict(spec_decoding=True, num_spec_tokens=3)
    want = jserving.LLMEngine(jm, kv_dtype=kv_dtype, **ENGINE,
                              **spec).generate(prompts, max_new_tokens=6,
                                               temperature=0.0)
    jtp2 = jserving.LLMEngine(jm, kv_dtype=kv_dtype, mesh=2, num_blocks=12,
                              host_kv_blocks=24, **ENGINE, **spec)
    engine = _engine(tm, num_blocks=12, mesh=cpu_mesh(2), kv_dtype=kv_dtype, **spec)
    try:
        tier = engine.tier
        assert tier.shards == [(0, 1), (1, 2)]
        assert [(h0, h1) for h0, h1, _, _ in jtp2.tier._slabs] \
            == tier.shards
        assert tier._slabs[0].shape[2] == 1            # rank 0's one head
        for eng in (engine, jtp2):
            assert eng.generate(prompts, max_new_tokens=6,
                                temperature=0.0) == want
            _churn(eng)
            eng.tier.settle()
            assert eng.tier.swap_outs > 0
            assert eng.generate(prompts, max_new_tokens=6,
                                temperature=0.0) == want   # host-warm
            assert eng.tier.swap_ins > 0
        assert tier.debug_snapshot()["shards"] == [[0, 1], [1, 2]]
        _idle(engine)
        _tier_consistent(tier)
    finally:
        engine.close()


def test_cross_topology_migration_parity(models):
    """Migration is topology-portable: a tp=2 engine's export (full-head
    [L, H, bs, D] payloads, its ranks' slabs joined) imports into a
    one-card engine, and that one's back into a tp=2 engine; each serves
    host-warm tokens equal to the cold one-card serve."""
    _, tm = models
    prompts = _doc_prompts()[:1]
    refs = _engine(tm, num_blocks=12).generate(prompts, max_new_tokens=6,
                                               temperature=0.0)
    src = _engine(tm, num_blocks=12, mesh=cpu_mesh(2))
    back = _engine(tm, num_blocks=12, mesh=cpu_mesh(2))
    try:
        assert src.generate(prompts, max_new_tokens=6,
                            temperature=0.0) == refs
        payload = src.export_kv_tier(demote=True)
        assert payload["entries"]
        assert tuple(payload["entries"][0][1].shape) == (2, 2, 8, 16)
        dst = _engine(tm, num_blocks=12)
        n = dst.import_kv_tier(payload)
        assert n == len(payload["entries"]) == dst.tier.migrated_blocks_in
        assert dst.generate(prompts, max_new_tokens=6,
                            temperature=0.0) == refs
        assert dst.tier.swap_ins > 0                   # served FROM import
        # the exported payloads are the one-card tier's bytes, head for head
        mine = {e[0]: e for e in dst.export_kv_tier(demote=False)["entries"]}
        for h, k, v in payload["entries"]:
            if h in mine:
                assert torch.equal(mine[h][1], k)
                assert torch.equal(mine[h][2], v)
        assert back.import_kv_tier(dst.export_kv_tier()) > 0
        assert back.generate(prompts, max_new_tokens=6,
                             temperature=0.0) == refs
        assert back.tier.swap_ins > 0
        with pytest.raises(ValueError, match="geometry mismatch"):
            back.import_kv_tier(dict(payload,
                                     block_size=payload["block_size"] + 1))
        dst.close()
    finally:
        src.close()
        back.close()


# -- churn sweep: accounting across interleavings -----------------------------


def test_churn_sweep_interleavings_leave_pool_and_tier_idle(models):
    """Randomized rounds of shared-prefix traffic over a pool too small
    for it (swap-outs, swap-back hits, copy-on-write on shared tails,
    preemption and mid-flight aborts interleave): every round ends with
    refcounts drained, the free count restored, and the host tier's slot
    accounting balanced."""
    _, tm = models
    rs = np.random.RandomState(11)
    engine = _engine(tm, num_blocks=10, block_size=4, host_kv_blocks=16,
                     host_swap_chunk=2)
    prefixes = [rs.randint(0, 128, (12,)).tolist() for _ in range(3)]
    idle_free = engine.pool.num_free
    for rnd in range(4):
        reqs = []
        for _ in range(int(rs.randint(3, 6))):
            p = (prefixes[rs.randint(len(prefixes))]
                 + rs.randint(0, 128, (rs.randint(0, 7),)).tolist())
            reqs.append(engine.add_request(
                p, max_new_tokens=int(rs.randint(2, 7)), temperature=0.0))
        doomed = set(rs.choice(reqs, size=len(reqs) // 3,
                               replace=False).tolist())
        steps = 0
        while engine.has_unfinished():
            engine.step()
            steps += 1
            if steps == 2:
                for rid in doomed:
                    engine.abort(rid)
        for rid in reqs:
            if rid not in doomed:
                engine.release(rid)
        assert engine.pool._refcount == {}, f"round {rnd}"
        assert engine.pool.num_free == idle_free, f"round {rnd}"
        _tier_consistent(engine.tier)
    assert engine.tier.swap_outs > 0
    assert engine.tier.swap_ins > 0
    assert engine.metrics.counters.get("preemptions", 0) > 0
    assert engine.metrics.counters.get("prefix_cache_cow_copies", 0) > 0
    engine.close()


def test_tier_lru_eviction_keeps_newest(models):
    """A tier smaller than the churn evicts its oldest entries; the slot
    accounting still balances, and the resident ring is the JAX tier's."""
    jm, tm = models
    engines = [_engine(tm, num_blocks=10, host_kv_blocks=4),
               jserving.LLMEngine(jm, num_blocks=10, host_kv_blocks=4,
                                  **ENGINE)]
    snaps = []
    for engine in engines:
        _churn(engine, rounds=4)
        engine.tier.settle()
        snaps.append(engine.tier.debug_snapshot())
        engine.close()
    tier = engines[0].tier
    _tier_consistent(tier)
    with tier._lock:
        assert len(tier._index) == tier.host_blocks       # full, not over
    assert tier.swap_outs > tier.host_blocks              # evicted, reused
    assert snaps[0] == snaps[1]


# -- observability: /debug/kvtier and pool agreement --------------------------


def test_debug_kvtier_endpoint_matches_jax(models):
    """/debug/kvtier 404s with a hint when the tier is off and serves the
    snapshot when on, equal to the JAX server's on the same traffic; the
    /healthz pool dict carries the tier's stats, equal to the snapshot's
    numbers."""
    jm, tm = models
    doc = _prompts((24,), seed=1)[0]

    async def scenario(serving, model, kw):
        off = serving.ServingServer(
            serving.LLMEngine(model, **ENGINE, **kw), host="127.0.0.1",
            port=0)
        await off.start()
        off_resp = await http(off.port, "GET", "/debug/kvtier")
        await off.shutdown()
        eng = serving.LLMEngine(model, num_blocks=12, host_kv_blocks=24,
                                **ENGINE, **kw)
        server = serving.ServingServer(eng, host="127.0.0.1", port=0)
        await server.start()
        await server.engine.submit(doc, max_new_tokens=4).collect()
        for r in range(2):
            for p in _prompts((17, 25, 19), seed=5 + 7 * r):
                await server.engine.submit(p, max_new_tokens=4).collect()
        await asyncio.to_thread(eng.tier.settle)
        await server.engine.submit(doc, max_new_tokens=4).collect()
        dbg = await http(server.port, "GET", "/debug/kvtier")
        hz = await http(server.port, "GET", "/healthz")
        await server.shutdown()
        return off_resp, dbg, hz

    out = {}
    for name, serving, model, kw in (
            ("jax", jserving, jm, {}),
            ("torch", tserving, tm, {"device": "cpu"})):
        out[name] = asyncio.run(scenario(serving, model, kw))
    (off_status, _, off_body), dbg, hz = out["torch"]
    assert off_status == 404 and b"host_kv_blocks" in off_body
    assert dbg[0] == 200
    snap = json.loads(dbg[2])
    assert snap == json.loads(out["jax"][1][2])
    assert snap["host_blocks_total"] == 24 and snap["swap_outs"] > 0
    assert snap["swap_ins"] > 0
    assert snap["host_blocks_used"] == len(snap["resident"])
    assert snap["shards"] == [[0, 2]]
    pool = json.loads(hz[2])["pool"]
    for k in ("host_blocks_total", "host_blocks_used", "swap_ins",
              "swap_outs", "swap_in_hit_tokens", "migrated_blocks_out",
              "migrated_blocks_in"):
        assert pool[k] == snap[k], k


# -- migration: export -> import between two port engines --------------------


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_export_import_serves_host_warm(models, kv_dtype):
    _, tm = models
    prompts = _doc_prompts()[:1]
    src = _engine(tm, num_blocks=12, kv_dtype=kv_dtype)
    cold = src.generate(prompts, max_new_tokens=6, temperature=0.0)
    payload = src.export_kv_tier(demote=True)          # quiescent: demote
    assert payload["entries"]
    assert payload["dtype"] == ("int8" if kv_dtype else "float32")
    entry = payload["entries"][0]
    assert len(entry) == (5 if kv_dtype else 3)
    assert tuple(entry[1].shape) == (2, 2, 8, 16)

    dst = _engine(tm, num_blocks=12, kv_dtype=kv_dtype)
    n = dst.import_kv_tier(payload)
    assert n == len(payload["entries"]) == dst.tier.migrated_blocks_in
    assert dst.generate(prompts, max_new_tokens=6, temperature=0.0) == cold
    assert dst.tier.swap_ins > 0                       # served from import
    with pytest.raises(ValueError, match="geometry mismatch"):
        dst.import_kv_tier(dict(payload,
                                block_size=payload["block_size"] + 1))
    other = _engine(tm, num_blocks=12,
                    kv_dtype=None if kv_dtype else "int8")
    with pytest.raises(ValueError, match="geometry"):
        other.import_kv_tier(payload)
    for e in (src, dst, other):
        e.close()
    assert not dst.tier._drain.is_alive()
