"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels (forward, dK/dV, dQ) in interpret
mode with 32-wide tiles, so several tiles and the causal tile skip run;
`jax.grad` goes through its custom VJP. The port's CPU path is autograd
through `attention_ref`. Inputs come from a seeded numpy RNG and go to
both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas.flash_attention import (_attention_xla,
                                                   flash_attention_array)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops.common_nn import scaled_dot_product_attention

ATOL = 1e-5   # float32, two frameworks' summation orders


def _inputs(b, sq, sk, h, d, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, sq, h, d).astype(np.float32)
    k = rs.randn(b, sk, h, d).astype(np.float32)
    v = rs.randn(b, sk, h, d).astype(np.float32)
    do = rs.randn(b, sq, h, d).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(64, 64), (32, 96), (1, 40)])
def test_attention_ref_matches_attention_xla(causal, sq, sk):
    q, k, v, _ = _inputs(2, sq, sk, 3, 16)
    want = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal))
    got = fa.attention_ref(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(64, 64), (32, 64)])
def test_flash_forward_and_grads_match_pallas_kernels(monkeypatch, causal,
                                                      sq, sk):
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    q, k, v, do = _inputs(1, sq, sk, 2, 32, seed=sq + causal)

    def jax_loss(q, k, v):
        o = flash_attention_array(q, k, v, causal=causal, block_q=32,
                                  block_k=32)
        return jnp.sum(o * do), o

    calls = jfa._flash_custom.cache_info()
    (_, want_o), want_g = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    after = jfa._flash_custom.cache_info()
    assert after.hits + after.misses > calls.hits + calls.misses, \
        "the JAX side did not take its Pallas kernels"
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got_o = fa.flash_attention(tq, tk, tv, causal=causal)
    got_o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got_o.detach().numpy(), np.asarray(want_o),
                               atol=ATOL, rtol=0)
    for name, got, want in zip("qkv", (tq, tk, tv), want_g):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=f"d{name}")


def test_lse_ref_is_the_softmax_normalizer():
    q, k, _, _ = _inputs(2, 16, 24, 2, 8)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    lse = fa.attention_lse_ref(tq, tk, causal=True)
    s = torch.einsum("bqhd,bkhd->bhqk", tq, tk) / np.sqrt(8)
    keep = torch.ones(16, 24, dtype=torch.bool).tril(8)
    want = torch.logsumexp(s.masked_fill(~keep, -1e30), -1)
    assert lse.shape == (2 * 2, 16)
    torch.testing.assert_close(lse, want.reshape(4, 16))


def test_sdpa_routes_to_flash_attention_and_refuses_what_is_not_ported():
    q, k, v, _ = _inputs(1, 8, 8, 2, 8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    torch.testing.assert_close(
        scaled_dot_product_attention(tq, tk, tv, is_causal=True),
        fa.attention_ref(tq, tk, tv, causal=True))
    # dropout outside training is no dropout, as in the JAX package
    torch.testing.assert_close(
        scaled_dot_product_attention(tq, tk, tv, dropout_p=0.5,
                                     training=False),
        fa.attention_ref(tq, tk, tv))
    with pytest.raises(NotImplementedError, match="dropout"):
        scaled_dot_product_attention(tq, tk, tv, dropout_p=0.1)
    with pytest.raises(NotImplementedError, match="mask"):
        scaled_dot_product_attention(tq, tk, tv,
                                     attn_mask=torch.zeros(1, 1, 8, 8))
    with pytest.raises(NotImplementedError, match="mask"):
        fa.flash_attention(tq, tk, tv, mask=torch.zeros(1, 1, 8, 8))


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, _ = _inputs(1, 8, 8, 2, 64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(tq, tk, tv)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(tq, tk, tv, tq, tq, torch.zeros(2, 8))
