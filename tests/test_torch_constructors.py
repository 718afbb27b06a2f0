"""The port's constructors take every keyword of the JAX package's.

For `LLMEngine.__init__`, `GPTConfig.__init__` and `BertConfig.__init__`,
each keyword of the JAX signature is one case: passed at its JAX default
it is accepted; passed at another value it is accepted or raises
`NotImplementedError` (a part the port has not reached yet), never
`TypeError`. For the engine, which of the two is asserted: since the
tensor-parallel slice every keyword is accepted (``mesh=2`` builds a
two-rank engine on CPU ranks, closed after the case). A config that
accepts a value stores it.
"""
import inspect

import pytest

from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.serving import LLMEngine as JaxLLMEngine
from paddle_tpu_torch.distributed.checkpoint import save_sharded_model
from paddle_tpu_torch.models.bert import BertConfig
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.serving import LLMEngine
from test_torch_serving_sharded import tp_timeout  # noqa: F401
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)


def _keywords(fn, skip=("self", "model")):
    """{name: default} of a signature's keyword parameters."""
    return {n: p.default for n, p in inspect.signature(fn).parameters.items()
            if n not in skip and p.kind in (p.POSITIONAL_OR_KEYWORD,
                                            p.KEYWORD_ONLY)}


JAX_ENGINE = _keywords(JaxLLMEngine.__init__)
JAX_GPT = _keywords(JaxGPTConfig.__init__)
JAX_BERT = _keywords(JaxBertConfig.__init__)

# a value other than the JAX default for each keyword, valid in the JAX
# engine's terms, at the tiny model below
ENGINE_OTHER = {
    "block_size": 8, "num_blocks": 40, "max_batch": 2, "prefill_chunk": 16,
    "token_budget": 32, "max_seq_len": 32, "prefill_buckets": (16, 32),
    "prefill_interval": 2, "seed": 3, "prefix_cache": False,
    "spec_decoding": True, "num_spec_tokens": 2, "spec_max_ngram": 2,
    "spec_min_ngram": 2, "trace": True, "trace_buffer": 128,
    "request_log": "requests.jsonl", "mesh": 2, "kv_hbm_bytes": 1 << 20,
    "slo": {"ttft_ms": 100.0}, "postmortem_dir": "postmortem",
    "postmortem_keep": 3, "width_buckets": (4,), "host_kv_blocks": 16,
    "host_swap_chunk": 2, "kv_dtype": "int8", "quantize": "int8",
    "calib_prompts": [[1, 2, 3]], "quantize_iters": 10,
    "quant_allreduce": True, "checkpoint_path": "ckpt",
    "param_hbm_bytes": 1 << 30, "policy": True, "lora_slots": 2,
    "lora_rank": 4, "lora_targets": ("qkv",), "warmup": True,
}
GPT_OTHER = {
    "vocab_size": 256, "hidden_size": 128, "num_layers": 2, "num_heads": 2,
    "max_seq_len": 128, "intermediate_size": 256, "dropout": 0.1,
    "attn_impl": "ring", "remat": True, "dtype": "bfloat16",
    "fused_head_chunks": 4,
}
BERT_OTHER = {
    "vocab_size": 256, "hidden_size": 128, "num_layers": 2, "num_heads": 2,
    "intermediate_size": 256, "max_position_embeddings": 128,
    "type_vocab_size": 3, "dropout": 0.0, "remat": True,
}


@pytest.fixture(scope="module")
def model():
    return GPT(GPTConfig(vocab_size=512, hidden_size=64, num_layers=2,
                         num_heads=4, max_seq_len=64), device="cpu")


def _accepted_or_not_implemented(make, name, value):
    """True when `make(name=value)` constructs, False when it raises
    NotImplementedError; any other exception (TypeError) fails the test."""
    try:
        obj = make(**{name: value})
    except NotImplementedError:
        return False, None
    return True, obj


def test_every_jax_keyword_has_a_non_default_value():
    assert set(ENGINE_OTHER) == set(JAX_ENGINE)
    assert set(GPT_OTHER) == set(JAX_GPT)
    assert set(BERT_OTHER) == set(JAX_BERT)
    for table, defaults in ((ENGINE_OTHER, JAX_ENGINE), (GPT_OTHER, JAX_GPT),
                            (BERT_OTHER, JAX_BERT)):
        for name, value in table.items():
            assert value != defaults[name], name


@pytest.mark.parametrize("name", sorted(JAX_ENGINE))
def test_engine_takes_jax_keyword(model, name, tmp_path, monkeypatch,
                                  tp_timeout):
    # relative paths (postmortem_dir) land in a scratch directory
    monkeypatch.chdir(tmp_path)

    if name == "checkpoint_path":   # a checkpoint of this model to stream
        save_sharded_model(model, None, ENGINE_OTHER[name])

    def make(**kw):
        return LLMEngine(model, device="cpu", **kw)

    ok, _ = _accepted_or_not_implemented(make, name, JAX_ENGINE[name])
    assert ok, f"{name} at its JAX default {JAX_ENGINE[name]!r} must be " \
               "accepted"
    ok, eng = _accepted_or_not_implemented(make, name, ENGINE_OTHER[name])
    assert ok, name
    eng.close()      # a mesh=2 engine's rank processes end here
    if name == "mesh":
        assert eng.mesh_info()["tp_degree"] == 2 and not eng._tp.alive()
    if name == "warmup":    # warmup=True builds the whole program table
        assert eng.metrics.counters["jit_traces"] == len(eng._step_fns) \
            == eng.expected_program_count()


# the config values the port refuses (NotImplementedError): none since
# ring attention was ported (parallel/ring_attention.py); remat is ported
# in both configs
GPT_REFUSED = set()


@pytest.mark.parametrize("name", sorted(JAX_GPT))
def test_gpt_config_takes_jax_keyword(name):
    ok, cfg = _accepted_or_not_implemented(GPTConfig, name, JAX_GPT[name])
    assert ok
    if name != "intermediate_size":  # None resolves to 4 * hidden, as in JAX
        assert getattr(cfg, name) == JAX_GPT[name]
    ok, cfg = _accepted_or_not_implemented(GPTConfig, name, GPT_OTHER[name])
    assert ok == (name not in GPT_REFUSED), name
    if ok:
        assert getattr(cfg, name) == GPT_OTHER[name]


@pytest.mark.parametrize("name", sorted(JAX_BERT))
def test_bert_config_takes_jax_keyword(name):
    ok, cfg = _accepted_or_not_implemented(BertConfig, name, JAX_BERT[name])
    assert ok and getattr(cfg, name) == JAX_BERT[name]
    ok, cfg = _accepted_or_not_implemented(BertConfig, name,
                                           BERT_OTHER[name])
    assert ok, name
    assert getattr(cfg, name) == BERT_OTHER[name]


def test_gpt_config_stores_dtype_as_jax_does():
    assert GPTConfig(dtype="bfloat16").dtype == "bfloat16"
    assert GPTConfig().dtype == JaxGPTConfig().dtype == "float32"


def test_engine_none_defaults_mean_the_jax_defaults(model):
    """prefix_cache=None and spec_decoding=None (the JAX defaults) give the
    JAX engine's defaults with its env switches unset: prefix caching on,
    speculative decoding off."""
    eng = LLMEngine(model, device="cpu", prefix_cache=None,
                    spec_decoding=None)
    assert eng.prefix_cache is True and eng.spec_decoding is False
