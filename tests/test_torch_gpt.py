"""The port's GPT against the JAX package's, on the CPU in float32.

Weights are carried over with `from_jax_state_dict`; inputs come from a
seeded numpy RNG and go to both models.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_tiny
from paddle_tpu_torch.weights import from_jax_state_dict

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64)
LOGIT_ATOL = 1e-4   # float32 forward, two frameworks' summation orders


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, attn_impl="xla"))
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in state_dict_arrays(jm)[0].items()}
    tm = from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"), arrays)
    return jm, tm, arrays


def _ids(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, 512, (b, s)).astype(np.int64)


def test_state_dict_keys_match(pair):
    jm, tm, arrays = pair
    assert set(tm.state_dict()) == set(arrays)
    assert set(dict(tm.named_parameters())) == set(arrays)


@pytest.mark.parametrize("b,s", [(2, 9), (1, 64)])
def test_full_forward_logits_match(pair, b, s):
    jm, tm, _ = pair
    ids = _ids(b, s, seed=s)
    want = jm(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (b, s, CFG["vocab_size"])
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_incremental_decode_matches_full_forward(pair):
    """The contiguous-cache path (prefill, then one token) gives the full
    forward's logits at the same positions."""
    _, tm, _ = pair
    ids = torch.from_numpy(_ids(2, 9))
    with torch.no_grad():
        full = tm(ids)
        caches = tm.init_caches(2, 16)
        lg, caches = tm(ids[:, :8], caches=caches, pos_offset=0)
        lg2, _ = tm(ids[:, 8:], caches=caches, pos_offset=8)
    torch.testing.assert_close(lg, full[:, :8], atol=LOGIT_ATOL, rtol=0)
    torch.testing.assert_close(lg2[:, 0], full[:, 8], atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("b,s,new", [(2, 8, 16), (3, 12, 8)])
def test_greedy_generate_matches_jax(pair, b, s, new):
    jm, tm, _ = pair
    ids = _ids(b, s, seed=100 + s)
    want = jm.generate(paddle.to_tensor(ids), max_new_tokens=new,
                       temperature=0.0).numpy()
    got = tm.generate(ids, max_new_tokens=new, temperature=0.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampling_is_seeded(pair):
    _, tm, _ = pair
    ids = _ids(2, 6)
    a = tm.generate(ids, max_new_tokens=8, temperature=0.9, top_k=20, seed=1)
    b = tm.generate(ids, max_new_tokens=8, temperature=0.9, top_k=20, seed=1)
    torch.testing.assert_close(a, b)
    assert a.shape == (2, 14)
    with pytest.raises(ValueError, match="max_seq_len"):
        tm.generate(ids, max_new_tokens=60)


def test_from_jax_state_dict_rejects_key_mismatch(pair):
    _, tm, arrays = pair
    missing = dict(arrays)
    missing.pop("ln_f.bias")
    with pytest.raises(KeyError, match="ln_f.bias"):
        from_jax_state_dict(tm, missing)
    extra = dict(arrays, **{"lm_head.weight": arrays["wte.weight"]})
    with pytest.raises(KeyError, match="lm_head.weight"):
        from_jax_state_dict(tm, extra)
    wrong = dict(arrays, **{"wpe.weight": arrays["wpe.weight"][:8]})
    with pytest.raises(ValueError, match="wpe.weight"):
        from_jax_state_dict(tm, wrong)


def test_linear_weights_are_transposed(pair):
    _, tm, arrays = pair
    np.testing.assert_array_equal(
        tm.blocks[0].attn.qkv.weight.detach().numpy(),
        arrays["blocks.0.attn.qkv.weight"].T)
    np.testing.assert_array_equal(tm.wte.weight.detach().numpy(),
                                  arrays["wte.weight"])


def test_seeded_init_is_deterministic():
    a = gpt_tiny(device="cpu", seed=3)
    b = gpt_tiny(device="cpu", seed=3)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert a.dtype == torch.float32 and a.device.type == "cpu"
