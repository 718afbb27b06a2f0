"""The port's LLMEngine against the JAX package's, on the CPU.

Both engines get the same weights (carried over with `from_jax_state_dict`)
and the same greedy wave: prompts longer than `prefill_chunk=8` (chunked
prefill), a repeated prompt prefix admitted after its first owner finished
(prefix-cache hits, copy-on-write of a shared tail block), prompt-lookup
speculative decoding, and, in the second configuration, a pool too small
for the wave (preempt-by-recompute). Greedy outputs must be token-identical.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.serving import LLMEngine as JaxLLMEngine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.serving import BlockPool, LLMEngine
from paddle_tpu_torch.weights import from_jax_state_dict

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64)
ENGINE = dict(block_size=4, max_batch=2, prefill_chunk=8, max_seq_len=64,
              spec_decoding=True, num_spec_tokens=4)
NEW_TOKENS = 12


def _prompts():
    rs = np.random.RandomState(7)
    shared = rs.randint(0, 512, 16).tolist()
    return [
        shared + rs.randint(0, 512, 5).tolist(),   # 21 tokens: 3 chunks
        rs.randint(0, 512, 13).tolist(),
        shared + rs.randint(0, 512, 2).tolist(),   # prefix hit on `shared`
        shared,                                    # fully cached prompt
        rs.randint(0, 512, 3).tolist(),
        [5, 6, 7, 5, 6, 7, 5, 6, 7, 5],            # drafter-friendly cycle
    ]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, attn_impl="xla"))
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in state_dict_arrays(jm)[0].items()}
    tm = from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"), arrays)
    return jm, tm


# num_blocks None: the default pool (no pressure); 12: too few blocks for
# two concurrent sequences, so the younger one is preempted and replayed
@pytest.mark.parametrize("num_blocks", [None, 12])
def test_greedy_wave_matches_jax_engine(models, num_blocks):
    jm, tm = models
    prompts = _prompts()
    jeng = JaxLLMEngine(jm, num_blocks=num_blocks, prefix_cache=True,
                        **ENGINE)
    want = jeng.generate(prompts, max_new_tokens=NEW_TOKENS,
                         temperature=0.0)
    eng = LLMEngine(tm, device="cpu", num_blocks=num_blocks, **ENGINE)
    got = eng.generate(prompts, max_new_tokens=NEW_TOKENS, temperature=0.0)
    assert got == want
    c = eng.metrics.counters
    # the program table: one program per width bucket the wave reached,
    # built once each, as the JAX engine traces its programs
    assert c["jit_traces"] == len(eng._step_fns) \
        == jeng.metrics.counters["jit_traces"] == len(jeng._step_fns)
    assert eng.expected_program_count() == jeng.expected_program_count()
    assert eng.step_program_shapes() == jeng.step_program_shapes()
    assert c["prefix_cache_hit_tokens"] > 0
    assert c["spec_proposed_tokens"] > 0
    assert c["mixed_steps"] > 0
    if num_blocks is not None:
        assert c["preemptions"] >= 1
    # one device->host read per step
    assert c["host_syncs"] == eng.step_count
    # the pool is idle again: no block held, every refcount released
    assert eng.pool.num_free == eng.pool.num_blocks - 1
    assert eng.pool._refcount == {}
    assert not eng.has_unfinished()


def test_warmup_matches_jax_engine(models):
    """`warmup()` builds the whole program table on both engines and
    leaves the port's idle: the prefix cache back on, an empty pool, no
    request record. A wave served afterwards builds nothing and emits what
    an unwarmed engine emits."""
    jm, tm = models
    cfg = ENGINE
    jeng = JaxLLMEngine(jm, **cfg)
    eng = LLMEngine(tm, device="cpu", **cfg)
    n = eng.warmup()
    assert n == jeng.warmup() == len(eng.width_buckets) == 3
    assert eng.metrics.gauges["warmup_programs"] == n
    assert eng.metrics.gauges["warmup_seconds"] >= 0
    assert eng.prefix_cache and eng.scheduler.prefix_cache
    assert eng.pool.num_free == eng.pool.num_blocks - 1
    assert eng.pool._refcount == {} and eng.pool.num_cached_blocks == 0
    assert eng._requests == {} and not eng.has_unfinished()
    traces = eng.metrics.counters["jit_traces"]
    assert traces == n
    prompts = _prompts()
    got = eng.generate(prompts, max_new_tokens=NEW_TOKENS)
    assert eng.metrics.counters["jit_traces"] == traces
    assert got == LLMEngine(tm, device="cpu", **cfg).generate(
        prompts, max_new_tokens=NEW_TOKENS)
    with pytest.raises(RuntimeError, match="idle engine"):
        eng.add_request(prompts[0], max_new_tokens=2)
        eng.warmup()


def test_warmup_of_a_drafted_only_bucket_matches_jax_engine(models):
    """At chunk 4 the spec bucket 5 is wider than any prefill chunk, so
    warmup reaches it only through a drafted decode step of its cyclic
    prompt, which needs the model's first token to continue the cycle.
    This random model's does not: both engines build buckets 1 and 4 and
    raise for bucket 5 alike."""
    jm, tm = models
    cfg = dict(ENGINE, prefill_chunk=4)
    jeng = JaxLLMEngine(jm, **cfg)
    eng = LLMEngine(tm, device="cpu", **cfg)
    assert eng.width_buckets == jeng.width_buckets == [1, 4, 5]
    for e in (jeng, eng):
        with pytest.raises(RuntimeError, match=r"buckets \[5\] were never"):
            e.warmup()
    assert sorted(eng._step_fns) == sorted(jeng._step_fns) == [(2, 1),
                                                              (2, 4)]
    assert eng.prefix_cache and not eng.has_unfinished()


def test_recompile_sentinel_zero_retraces_steady_state(models):
    """tests/test_serving_engine.py's sentinel contract on the port: the
    table never exceeds `expected_program_count()`, and after a warming
    wave greedy, sampled and cache-hit traffic builds nothing more —
    `jit_traces` stays equal to the programs built, `jit_retraces` 0, and
    the sentinel never warns."""
    import warnings

    _, tm = models
    engine = LLMEngine(tm, device="cpu", block_size=8, max_batch=2,
                       max_seq_len=64, spec_decoding=True, num_spec_tokens=3)
    assert engine.expected_program_count() == 3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        engine.generate([[7] * 24], max_new_tokens=12)
        assert len(engine._step_fns) <= engine.expected_program_count()
        warm = engine.metrics.counters["jit_traces"]
        assert warm == len(engine._step_fns)
        rs = np.random.RandomState(1)
        for _ in range(3):
            prompts = [rs.randint(0, 128, (n,)).tolist() for n in (5, 17, 9)]
            engine.generate(prompts[:2], max_new_tokens=8)
            engine.generate([prompts[2]], max_new_tokens=4,
                            temperature=0.8, top_k=5)
            engine.generate([prompts[1]], max_new_tokens=2)   # cache hit
    assert engine.metrics.counters["prefix_cache_hit_tokens"] > 0
    assert len(engine._step_fns) <= engine.expected_program_count()
    assert engine.metrics.counters["jit_traces"] == len(engine._step_fns)
    assert engine.metrics.gauges["jit_retraces"] == 0


def test_recompile_sentinel_warns_on_surplus_trace(models):
    """A build beyond one per program is what the sentinel catches: the
    next step warns once, sets the gauge, and never warns again."""
    import warnings

    _, tm = models
    engine = LLMEngine(tm, device="cpu", block_size=8, max_batch=2,
                       max_seq_len=64)
    rs = np.random.RandomState(0)
    engine.generate([rs.randint(0, 512, 9).tolist()], max_new_tokens=2)
    engine.metrics.inc("jit_traces")         # a phantom rebuild
    with pytest.warns(RuntimeWarning, match="recompile sentinel"):
        engine.generate([rs.randint(0, 512, 7).tolist()], max_new_tokens=2)
    assert engine.metrics.gauges["jit_retraces"] == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        engine.generate([rs.randint(0, 512, 5).tolist()], max_new_tokens=2)


def test_prefill_buckets_and_interval_are_ignored(models):
    """Accepted for API compatibility and ignored, as in the JAX engine:
    chunked prefill replaced the per-bucket prefill programs."""
    _, tm = models
    prompts = _prompts()
    base = LLMEngine(tm, device="cpu", **ENGINE).generate(
        prompts, max_new_tokens=NEW_TOKENS)
    eng = LLMEngine(tm, device="cpu", prefill_buckets=(16, 32),
                    prefill_interval=2, **ENGINE)
    assert eng.generate(prompts, max_new_tokens=NEW_TOKENS) == base


def test_stream_matches_generate(models):
    _, tm = models
    prompt = _prompts()[0]
    ref = tm.generate(np.asarray([prompt]), max_new_tokens=NEW_TOKENS,
                      temperature=0.0)[0, len(prompt):].tolist()
    eng = LLMEngine(tm, device="cpu", **ENGINE)
    outs = list(eng.stream(prompt, max_new_tokens=NEW_TOKENS))
    assert [o.token for o in outs] == ref
    assert [o.finished for o in outs] == [False] * (NEW_TOKENS - 1) + [True]
    assert eng._requests == {}


def test_sampling_is_seeded_and_within_top_k(models):
    """Temperature sampling draws from the engine's torch.Generator: the
    same seed gives the same tokens, and top_k=1 collapses to greedy."""
    _, tm = models
    prompts = _prompts()[:3]

    def run(seed, **kw):
        eng = LLMEngine(tm, device="cpu", seed=seed, **ENGINE)
        return eng.generate(prompts, max_new_tokens=6, temperature=0.8, **kw)

    assert run(3) == run(3)
    greedy = LLMEngine(tm, device="cpu", **ENGINE).generate(
        prompts, max_new_tokens=6, temperature=0.0)
    assert run(5, top_k=1) == greedy


def test_abort_returns_blocks(models):
    _, tm = models
    eng = LLMEngine(tm, device="cpu", **ENGINE)
    rid = eng.add_request(_prompts()[0], max_new_tokens=NEW_TOKENS)
    eng.step()
    assert eng.pool.num_free < eng.pool.num_blocks - 1
    assert eng.abort(rid)
    assert rid not in eng._requests
    assert eng.pool.num_free == eng.pool.num_blocks - 1
    assert not eng.has_unfinished()


def test_engine_without_device_raises_when_cuda_is_absent(models,
                                                          monkeypatch):
    """The model, the engine and the KV pool default to CUDA and raise
    without it."""
    _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(tm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT(GPTConfig(**CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockPool(8, 2, 4, 4, 16)


def test_engine_rejects_a_model_on_another_device(models):
    _, tm = models
    with pytest.raises(ValueError, match="build the model"):
        LLMEngine(tm, device="meta")


@pytest.mark.parametrize("option", [
    {"mesh": 2}, {"param_hbm_bytes": 1 << 30}, {"checkpoint_path": "ckpt"},
    {"quant_allreduce": True},
])
def test_left_out_options_raise(models, option):
    _, tm = models
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        LLMEngine(tm, device="cpu", **option)


# the options the port took over from the left-out list: each builds an
# engine whose pool, tier and adapter surfaces read as the JAX engine's
@pytest.mark.parametrize("option", [
    {"kv_dtype": "int8", "host_kv_blocks": 8}, {"quantize": "int8"},
    {"lora_slots": 2}, {"host_kv_blocks": 8}, {"lora_rank": 4},
    {"calib_prompts": [[1, 2, 3]]},
])
def test_ported_options_act_as_in_the_jax_engine(option):
    cfg = dict(block_size=4, max_batch=2, max_seq_len=64)
    if "quantize" in option:
        option = dict(option, quantize_iters=0)   # round-to-nearest
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, attn_impl="xla"))
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in state_dict_arrays(jm)[0].items()}
    tm = from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"), arrays)
    jeng = JaxLLMEngine(jm, **cfg, **option)
    eng = LLMEngine(tm, device="cpu", **cfg, **option)
    try:
        assert eng.pool_stats() == jeng.pool_stats()
        assert eng.swap_program_shapes() == jeng.swap_program_shapes()
        assert eng.quantize == jeng.quantize
        assert eng.lora_targets == jeng.lora_targets
        assert (eng.generate([[5, 6, 7, 8, 9]], max_new_tokens=4)
                == jeng.generate([[5, 6, 7, 8, 9]], max_new_tokens=4))
    finally:
        eng.close()
        jeng.close()


def test_left_out_options_accept_their_off_values(models):
    _, tm = models
    eng = LLMEngine(tm, device="cpu", mesh=None, kv_dtype=None,
                    quantize=False, lora_slots=0, trace=False, slo=None)
    assert eng.expected_program_count() == 1 + 1  # widths {1, chunk}


def test_validate_rejects_impossible_requests(models):
    _, tm = models
    eng = LLMEngine(tm, device="cpu", num_blocks=4, **ENGINE)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.add_request([1] * 60, max_new_tokens=8)
    with pytest.raises(ValueError, match="KV blocks"):
        eng.add_request([1] * 20, max_new_tokens=8)


def test_kv_hbm_bytes_sizes_the_pool(models):
    _, tm = models
    # K + V, 2 layers, 4 heads, block 4, head_dim 16, float32
    per_block = 2 * 2 * 4 * 4 * 16 * 4
    eng = LLMEngine(tm, device="cpu", kv_hbm_bytes=per_block * 40 + 7,
                    **ENGINE)
    assert eng.pool.num_blocks == 40
    assert eng.pool_stats()["kv_bytes_per_block"] == per_block
    with pytest.raises(ValueError, match="not both"):
        LLMEngine(tm, device="cpu", num_blocks=40,
                  kv_hbm_bytes=per_block * 40, **ENGINE)
    # one max_seq_len sequence needs 16 blocks plus the null block
    with pytest.raises(ValueError, match="buys only"):
        LLMEngine(tm, device="cpu", kv_hbm_bytes=per_block * 16, **ENGINE)


def test_width_buckets_keep_greedy_output(models):
    _, tm = models
    prompts = _prompts()
    base = LLMEngine(tm, device="cpu", **ENGINE).generate(
        prompts, max_new_tokens=NEW_TOKENS)
    eng = LLMEngine(tm, device="cpu", width_buckets=[2, 3, 99], **ENGINE)
    assert eng.width_buckets == [1, 2, 3, 5, 8]   # 99 exceeds every row
    assert eng.expected_program_count() == 5
    assert eng.generate(prompts, max_new_tokens=NEW_TOKENS) == base
    with pytest.raises(ValueError, match=">= 1"):
        LLMEngine(tm, device="cpu", width_buckets=[0], **ENGINE)
