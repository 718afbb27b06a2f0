"""The port's many-adapter LoRA serving (`paddle_tpu_torch.models.lora` and
the engine's adapter registry) against the JAX package's, on the CPU.

Both packages get the same tiny GPT (weights carried over with
`from_jax_state_dict`) and the same seeded adapters (`random_adapter`
draws the same numbers in both). The acceptance case serves three classes
of traffic interleaved on one engine, base, adapter alpha (rank 4) and
adapter beta (rank 2, zero-padded), with speculative decoding and prefix
caching on: each request's greedy tokens must equal those of an engine
over the merged weights (``W + A @ B``) and those of the JAX
multi-adapter engine. Around it, the JAX package's registry cases
(`tests/test_serving_lora.py`) run on the port: table layout, pack
validation, the lora-off engine, unknown adapters, LRU eviction, in-flight
refusals, the abort pin release, prefix isolation across adapters, and
the adapter threaded through the completion parser and the frontend.
"""
import asyncio

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.models import lora as jlora
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.serving import LLMEngine as JaxLLMEngine
from paddle_tpu.serving import build_serving_mesh as jax_build_serving_mesh
from paddle_tpu_torch.models import lora
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.serving import AsyncLLMEngine, LLMEngine, ServingMesh
from paddle_tpu_torch.serving.block_pool import chain_block_hashes
from paddle_tpu_torch.serving.server import _parse_completion_spec
from paddle_tpu_torch.weights import from_jax_state_dict
from test_torch_serving_sharded import cpu_mesh
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)
# spec decoding and prefix caching on: adapter identity must survive the
# whole decode machinery, not just plain greedy steps
ENG = dict(block_size=8, num_blocks=48, max_batch=4, spec_decoding=True,
           prefix_cache=True)
PROMPT = list(range(1, 11))


@pytest.fixture(scope="module")
def arrays():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, attn_impl="xla", dropout=0.0))
    jm.eval()
    return jm, {k: np.asarray(v)
                for k, v in state_dict_arrays(jm)[0].items()}


def make_model(arrays):
    """A fresh port model with the shared weights (merge_adapter_into
    mutates weights in place, so each reference engine needs its own)."""
    return from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"),
                               arrays[1])


def engine(arrays, **kw):
    return LLMEngine(make_model(arrays), device="cpu", **ENG, **kw)


def _adapter(cfg, seed, rank=4, scale=0.5):
    return lora.random_adapter(cfg, rank, lora.LORA_TARGETS, seed=seed,
                               scale=scale)


def _drain(eng, max_steps=400):
    for _ in range(max_steps):
        eng.step()
        if not eng.has_unfinished():
            return
    raise AssertionError("engine did not drain")


def _serve_one(eng, prompt=PROMPT, n=12, adapter=None):
    rid = eng.add_request(prompt, max_new_tokens=n, adapter=adapter)
    _drain(eng)
    return eng.get_request(rid).output_ids


# -- tables and packing ------------------------------------------------------


def test_adapter_tables_layout_matches_jax():
    cfg = GPTConfig(**CFG)
    tables = lora.init_adapter_tables(cfg, 3, 4, device="cpu")
    jtables = jlora.init_adapter_tables(JaxGPTConfig(**CFG), 3, 4)
    assert set(tables) == set(jtables) == set(lora.LORA_TARGETS)
    for t in tables:
        for mine, theirs in zip(tables[t], jtables[t]):
            assert tuple(mine.shape) == tuple(theirs.shape)
            assert mine.dtype == torch.float32 and not mine.any()

    w = _adapter(cfg, seed=1, rank=2)     # narrower than the table rank
    packed = lora.pack_adapter(cfg, w, 4, lora.LORA_TARGETS, alpha=8)
    jpacked = jlora.pack_adapter(cfg, w, 4, jlora.LORA_TARGETS, alpha=8)
    for t in packed:
        for mine, theirs in zip(packed[t], jpacked[t]):
            np.testing.assert_array_equal(mine, theirs)
    pa, pb = packed["attn_qkv"]
    assert pa.shape[-1] == 4 and not pa[..., 2:].any() and not pb[:, 2:].any()

    a = tables["attn_qkv"][0]
    assert lora.write_slot(tables, 1, packed) is tables
    assert tables["attn_qkv"][0] is a          # written in place
    np.testing.assert_array_equal(a[1].numpy(), pa)
    assert not a[0].any()                       # slot 0 stays the base
    lora.zero_slot(tables, 1)
    assert not a[1].any()
    # on a serving mesh, A is replicated and B holds the rank's out
    # columns: the JAX tables' shardings, rank 1 of 2 shown
    smesh = ServingMesh(["cpu", "cpu"]).for_rank(1)
    sharded = lora.init_adapter_tables(cfg, 3, 4, smesh=smesh, device="cpu")
    jmesh = jax_build_serving_mesh(2)
    jspecs = jlora.table_shardings(jlora.LORA_TARGETS, jmesh)
    assert lora.table_shardings(lora.LORA_TARGETS, smesh) == {
        t: tuple(list(s.spec).index("tp") if "tp" in s.spec else None
                 for s in jspecs[t]) for t in jspecs}
    for t, (ta, tb) in sharded.items():
        assert tuple(ta.shape) == tuple(tables[t][0].shape)
        assert tb.shape[-1] * 2 == tables[t][1].shape[-1]
    pb_rank1 = lora.shard_adapter(packed, smesh)["attn_qkv"][1]
    np.testing.assert_array_equal(pb_rank1, pb[..., pb.shape[-1] // 2:])


@pytest.mark.parametrize("case,match", [
    ("target", "not enabled"), ("shape", "A shape"), ("rank", "exceeds"),
    ("empty", "no target weights")])
def test_pack_adapter_validation_matches_jax(case, match):
    cfg = GPTConfig(**CFG)
    good = _adapter(cfg, seed=1)
    weights = {"target": {"attn_proj": good["attn_qkv"]},
               "shape": {"attn_qkv": (good["attn_qkv"][0][:, :-1],
                                      good["attn_qkv"][1])},
               "rank": _adapter(cfg, seed=1, rank=8),
               "empty": {}}[case]
    for pack in (lora.pack_adapter, jlora.pack_adapter):
        with pytest.raises(ValueError, match=match):
            pack(cfg, weights, 4, lora.LORA_TARGETS)


def test_apply_adapter_rows_matches_jax():
    import jax.numpy as jnp

    rs = np.random.RandomState(3)
    x = rs.normal(size=(3, 5, 32)).astype(np.float32)
    a = rs.normal(size=(3, 2, 32, 4)).astype(np.float32)
    b = rs.normal(size=(3, 2, 4, 96)).astype(np.float32)
    for layer in (0, 1):
        mine = lora.apply_adapter_rows(torch.from_numpy(x),
                                       torch.from_numpy(a),
                                       torch.from_numpy(b), layer)
        theirs = jlora.apply_adapter_rows(jnp.asarray(x), jnp.asarray(a),
                                          jnp.asarray(b), layer)
        assert mine.dtype == torch.float32
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   rtol=1e-5, atol=1e-5)
    rows = lora.gather_adapter_rows(
        {"attn_qkv": (torch.from_numpy(a), torch.from_numpy(b))},
        torch.tensor([2, 0, 2], dtype=torch.int32))
    assert torch.equal(rows["attn_qkv"][0][1], torch.from_numpy(a[0]))
    assert lora.gather_adapter_rows({}, torch.zeros(3)) is None


# -- token identity ------------------------------------------------------------


def test_adapters_token_identical_to_merged_and_jax_engines(arrays):
    """THE acceptance case: base, alpha and beta requests interleaved in
    one wave on one engine, each token-identical to its merged-weight
    engine and to the JAX multi-adapter engine, with no program built
    beyond the table (one per width bucket, as without adapters)."""
    cfg = GPTConfig(**CFG)
    w_a = _adapter(cfg, seed=7, rank=4)
    w_b = _adapter(cfg, seed=11, rank=2)
    classes = [None, "alpha", "beta", None, "beta", "alpha"]
    prompts = [PROMPT + [20 + i] for i in range(len(classes))]

    def wave(eng):
        eng.load_adapter("alpha", w_a, alpha=8)
        eng.load_adapter("beta", w_b, alpha=4)
        rids = [eng.add_request(p, max_new_tokens=10, adapter=ad)
                for p, ad in zip(prompts, classes)]
        while eng.has_unfinished():
            eng.step()
        return [eng.get_request(r).output_ids for r in rids]

    eng = engine(arrays, lora_slots=3, lora_rank=4)
    got = wave(eng)
    want_jax = wave(JaxLLMEngine(arrays[0], lora_slots=3, lora_rank=4,
                                 **ENG))
    plain = engine(arrays)
    refs = {None: plain,
            "alpha": LLMEngine(lora.merge_adapter_into(
                make_model(arrays), w_a, alpha=8), device="cpu", **ENG),
            "beta": LLMEngine(lora.merge_adapter_into(
                make_model(arrays), w_b, alpha=4), device="cpu", **ENG)}
    merged = [_serve_one(refs[ad], prompt=p, n=10)
              for p, ad in zip(prompts, classes)]
    assert got == merged
    assert got == want_jax
    assert got[0] != got[1]          # the adapters really steer decoding
    c = eng.metrics.counters
    assert c["jit_traces"] == len(eng._step_fns) \
        <= eng.expected_program_count() == plain.expected_program_count()
    assert eng.step_program_shapes() == plain.step_program_shapes()
    assert c["host_syncs"] == eng.step_count
    stats = eng.pool_stats()["lora"]
    assert stats == {"slots": 3, "rank": 4, "loaded": ["alpha", "beta"],
                     "inflight": {}}
    assert c["lora_requests"] == 4
    assert eng.pool.num_free == eng.pool.num_blocks - 1


def test_tp2_adapters_token_identical_to_jax_tp2(arrays):
    """The same interleaved wave on a two-rank engine (B tables cut to each
    rank's columns, every adapter write sent to every rank): the JAX
    engine's tokens at tp=2, and the one-card port engine's."""
    cfg = GPTConfig(**CFG)
    w_a = _adapter(cfg, seed=7, rank=4)
    w_b = _adapter(cfg, seed=11, rank=2)
    classes = [None, "alpha", "beta", "alpha"]
    prompts = [PROMPT + [30 + i] for i in range(len(classes))]

    def wave(eng):
        eng.load_adapter("alpha", w_a, alpha=8)
        eng.load_adapter("beta", w_b, alpha=4)
        rids = [eng.add_request(p, max_new_tokens=8, adapter=ad)
                for p, ad in zip(prompts, classes)]
        _drain(eng)
        out = [eng.get_request(r).output_ids for r in rids]
        eng.unload_adapter("beta")
        return out

    eng = engine(arrays, lora_slots=2, lora_rank=4, mesh=cpu_mesh(2))
    try:
        got = wave(eng)
        assert eng.pool_stats()["lora"]["loaded"] == ["alpha"]
    finally:
        eng.close()
    want = wave(JaxLLMEngine(arrays[0], lora_slots=2, lora_rank=4,
                             mesh=2, **ENG))
    one = wave(engine(arrays, lora_slots=2, lora_rank=4))
    assert got == want == one
    assert got[0] != got[1]


def test_lora_off_engine_is_untouched(arrays):
    eng = engine(arrays)
    assert eng._lora_tables == {} and eng.lora_targets == ()
    with pytest.raises(ValueError, match="lora_slots=0"):
        eng.add_request(PROMPT, adapter="alpha")
    with pytest.raises(RuntimeError, match="lora_slots=0"):
        eng.load_adapter("alpha", {})


# -- registry lifecycle --------------------------------------------------------


def test_unknown_adapter_rejected_at_admission(arrays):
    eng = engine(arrays, lora_slots=2, lora_rank=4)
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.add_request(PROMPT, adapter="nope")
    assert not eng.scheduler.waiting


def test_lru_eviction_and_slot_reuse(arrays):
    cfg = GPTConfig(**CFG)
    eng = engine(arrays, lora_slots=2, lora_rank=4)
    s_a = eng.load_adapter("a", _adapter(cfg, seed=1))
    s_b = eng.load_adapter("b", _adapter(cfg, seed=2))
    assert {s_a, s_b} == {1, 2}
    assert eng.metrics.gauges["lora_adapters_loaded"] == 2
    # serving on "a" makes it most recently used: a third load evicts the
    # idle "b" and reuses its slot
    _serve_one(eng, adapter="a")
    s_c = eng.load_adapter("c", _adapter(cfg, seed=3))
    assert s_c == s_b
    assert eng.pool_stats()["lora"]["loaded"] == ["a", "c"]
    assert eng.metrics.counters["lora_adapter_evictions"] == 1
    # reloading a live name overwrites in place: no eviction, same slot
    assert eng.load_adapter("a", _adapter(cfg, seed=4)) == s_a
    assert eng.metrics.counters["lora_adapter_evictions"] == 1


def test_unload_refuses_while_inflight(arrays):
    cfg = GPTConfig(**CFG)
    eng = engine(arrays, lora_slots=1, lora_rank=4)
    eng.load_adapter("a", _adapter(cfg, seed=1))
    rid = eng.add_request(PROMPT, max_new_tokens=16, adapter="a")
    eng.step()
    assert not eng.get_request(rid).finished
    with pytest.raises(RuntimeError, match="in flight"):
        eng.unload_adapter("a")
    with pytest.raises(RuntimeError, match="slots hold adapters"):
        eng.load_adapter("b", _adapter(cfg, seed=2))
    _drain(eng)
    eng.unload_adapter("a")
    assert eng.metrics.gauges["lora_adapters_loaded"] == 0
    assert not eng._lora_tables["attn_qkv"][0][1].any()   # scrubbed
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.unload_adapter("a")


def test_abort_releases_adapter_pin(arrays):
    eng = engine(arrays, lora_slots=1, lora_rank=4)
    eng.load_adapter("a", _adapter(GPTConfig(**CFG), seed=1))
    rid = eng.add_request(PROMPT, max_new_tokens=16, adapter="a")
    eng.step()
    eng.abort(rid)
    eng.unload_adapter("a")


# -- KV and prefix-cache isolation ---------------------------------------------


def test_prefix_cache_never_shared_across_adapters(arrays):
    assert (chain_block_hashes(PROMPT, 8)
            != chain_block_hashes(PROMPT, 8, salt="a"))
    assert (chain_block_hashes(PROMPT, 8, salt="a")
            != chain_block_hashes(PROMPT, 8, salt="b"))
    eng = engine(arrays, lora_slots=1, lora_rank=4)
    eng.load_adapter("a", _adapter(GPTConfig(**CFG), seed=7))
    prompt = list(range(1, 17))          # two full cacheable blocks
    _serve_one(eng, prompt=prompt, n=4)              # warm: base
    hits0 = eng.metrics.counters.get("prefix_cache_hit_tokens", 0)
    _serve_one(eng, prompt=prompt, n=4, adapter="a")  # cold: adapter
    assert eng.metrics.counters.get("prefix_cache_hit_tokens", 0) == hits0
    _serve_one(eng, prompt=prompt, n=4, adapter="a")  # warm: same adapter
    assert eng.metrics.counters.get("prefix_cache_hit_tokens", 0) > hits0


# -- the stack threads the adapter -------------------------------------------


def test_completion_parser_accepts_adapter():
    kw, _ = _parse_completion_spec(b'{"prompt": [1, 2, 3], "adapter": "a"}')
    assert kw["adapter"] == "a"
    kw, _ = _parse_completion_spec(b'{"prompt": [1, 2, 3]}')
    assert kw["adapter"] is None


def test_async_frontend_threads_adapter(arrays):
    w = _adapter(GPTConfig(**CFG), seed=7)
    want = _serve_one(LLMEngine(lora.merge_adapter_into(
        make_model(arrays), w, alpha=8), device="cpu", **ENG), n=8)
    eng = engine(arrays, lora_slots=1, lora_rank=4)
    eng.load_adapter("a", w, alpha=8)

    async def main():
        fe = await AsyncLLMEngine(eng).start()
        toks, reason = await fe.generate(PROMPT, max_new_tokens=8,
                                         adapter="a")
        # unknown adapters bounce at submit, before the engine thread
        with pytest.raises(ValueError, match="unknown adapter"):
            fe.submit(PROMPT, adapter="nope")
        # the engine thread owns the tables while the frontend runs
        with pytest.raises(RuntimeError, match="AsyncLLMEngine"):
            eng.load_adapter("b", w)
        await fe.shutdown()
        return toks, reason

    toks, reason = asyncio.run(main())
    assert reason == "length" and toks == want
