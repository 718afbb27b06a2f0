"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels (forward, dK/dV, dQ, with and without
the additive mask) in interpret mode with 32-wide tiles, so several tiles
and the causal tile skip run; `jax.grad` goes through its custom VJP.
Masks the JAX dispatch sends to XLA (bool, [B, 1, 1, Sk]) are held against
`_attention_xla`. Dropout cannot match the TPU's bits, so it is held
against its own formula with the Philox keep mask, by seed, and by being
unbiased. The port's CPU path is autograd through `attention_ref`. Inputs
come from a seeded numpy RNG and go to both packages.
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
from paddle_tpu_torch.ops import philox
from paddle_tpu_torch.ops.common_nn import (draw_seed, dropout,
                                            scaled_dot_product_attention)

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
    """SDPA goes through `flash_attention` with its mask and, while
    training, dropout under a seed drawn from the CPU generator it is
    given; what the kernels do not take raises."""
    q, k, v, _ = _inputs(1, 8, 8, 2, 8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    torch.testing.assert_close(
        scaled_dot_product_attention(tq, tk, tv, is_causal=True),
        fa.attention_ref(tq, tk, tv, causal=True))
    mask = torch.from_numpy(np.random.RandomState(1).randn(1, 2, 8, 8)
                            .astype(np.float32))
    torch.testing.assert_close(
        scaled_dot_product_attention(tq, tk, tv, attn_mask=mask),
        fa.attention_ref(tq, tk, tv, mask=mask))
    # dropout outside training is no dropout, as in the JAX package
    torch.testing.assert_close(
        scaled_dot_product_attention(tq, tk, tv, dropout_p=0.5,
                                     training=False),
        fa.attention_ref(tq, tk, tv))
    gen = torch.Generator().manual_seed(3)
    seed = draw_seed(torch.Generator().manual_seed(3))
    torch.testing.assert_close(
        scaled_dot_product_attention(tq, tk, tv, dropout_p=0.1,
                                     generator=gen),
        fa.attention_ref(tq, tk, tv, dropout_p=0.1, seed=seed))
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention(tq, tk, tv, dropout_p=0.1)
    with pytest.raises(ValueError, match="dropout_p"):
        scaled_dot_product_attention(tq, tk, tv, dropout_p=1.0)


# -- the additive mask ---------------------------------------------------------

MASK_CASES = [  # batch, mask shape (S = 64, heads 2): test_jit_amp_io's cases
    (2, (1, 1, 64, 64)), (2, (2, 2, 64, 64)), (2, (2, 1, 64, 64)),
    (2, (1, 2, 64, 64)), (1, (1, 2, 64, 64))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,mshape", MASK_CASES)
def test_mask_matches_pallas_kernels(monkeypatch, causal, b, mshape):
    """An additive float mask broadcast from each of its shapes: O, dQ, dK,
    dV and dmask of the port's CPU path against the JAX Pallas kernels in
    interpret mode (`_flash_custom`, 32-wide tiles, the mask gradient
    recomputed from the LSE), f32 at 1e-5."""
    monkeypatch.setenv("PADDLE_TPU_PALLAS_INTERPRET", "1")
    q, k, v, do = _inputs(b, 64, 64, 2, 32, seed=7 + causal)
    mask = (np.random.RandomState(8).randn(*mshape) * 0.5).astype(np.float32)

    def jax_loss(q, k, v, m):
        o = flash_attention_array(q, k, v, mask=m, causal=causal,
                                  block_q=32, block_k=32)
        return jnp.sum(o * do), o

    calls = jfa._flash_custom.cache_info()
    (_, want_o), want_g = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True)(
            *map(jnp.asarray, (q, k, v, mask)))
    after = jfa._flash_custom.cache_info()
    assert after.hits + after.misses > calls.hits + calls.misses, \
        "the JAX side did not take its Pallas kernels"
    tq, tk, tv, tm = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v, mask))
    got_o = fa.flash_attention(tq, tk, tv, causal=causal, mask=tm)
    got_o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got_o.detach().numpy(), np.asarray(want_o),
                               atol=ATOL, rtol=0)
    assert np.abs(np.asarray(want_g[3])).max() > 1e-4   # a real gradient
    for name, got, want in zip(("q", "k", "v", "mask"), (tq, tk, tv, tm),
                               want_g):
        assert got.grad.shape == want.shape, name
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=f"d{name}")


def _padding(b, s, seed=0):
    rs = np.random.RandomState(seed)
    return np.arange(s)[None] < rs.randint(s // 2, s + 1, b)[:, None]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["padding", "bool_padding", "bool_full"])
def test_padding_and_bool_masks_match_attention_xla(causal, kind):
    """The masks the JAX dispatch sends to XLA: an additive [B, 1, 1, Sk]
    padding mask (ERNIE's -1e4 convention) and bool masks ([B, 1, 1, Sk]
    and [B, 1, Sq, Sk]: keep where True). O and every gradient against
    `_attention_xla` under jax.grad, f32 at 1e-5."""
    q, k, v, do = _inputs(2, 48, 48, 2, 16, seed=11)
    real = _padding(2, 48)[:, None, None, :]
    if kind == "padding":
        mask = np.where(real, 0.0, -1e4).astype(np.float32)
    elif kind == "bool_padding":
        mask = real
    else:
        mask = np.random.RandomState(12).rand(2, 1, 48, 48) > 0.3
        mask[..., 0] = True
    float_mask = mask.dtype != np.bool_
    argnums = (0, 1, 2, 3) if float_mask else (0, 1, 2)

    def jax_loss(q, k, v, m):
        o = _attention_xla(q, k, v, mask=m, causal=causal)
        return jnp.sum(o * do), o

    (_, want_o), want_g = jax.value_and_grad(
        jax_loss, argnums=argnums, has_aux=True)(
            *map(jnp.asarray, (q, k, v, mask)))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tm = torch.from_numpy(mask)
    if float_mask:
        tm.requires_grad_()
        ins.append(tm)
    got_o = fa.flash_attention(*ins[:3], causal=causal, mask=tm)
    got_o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got_o.detach().numpy(), np.asarray(want_o),
                               atol=ATOL, rtol=0)
    for t, want in zip(ins, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)


# -- dropout --------------------------------------------------------------------

def _dropout_formula(q, k, v, causal, mask, p, seed):
    """Dropout attention written out: f32 scores + causal -1e30 + the
    mask, softmax, then ``where(keep, P / (1 - p), 0)`` with the keep bits
    materialized from philox.py, then P V."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    if causal:
        s = torch.where(torch.ones(sq, sk, dtype=torch.bool).tril(sk - sq),
                        s, torch.full_like(s, -1e30))
    if mask is not None:
        s = s + mask
    pr = torch.softmax(s, -1)
    keep = philox.keep_mask(seed, p, b * h, sq, sk).view(b, h, sq, sk)
    pr = torch.where(keep, pr / (1 - p), torch.zeros_like(pr))
    return torch.einsum("bhqk,bkhd->bqhd", pr, v)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_dropout_is_the_formula_with_the_philox_keep_mask(causal, with_mask):
    """The plain version with dropout (alone, and with a mask that needs a
    gradient) equals the formula with the keep mask materialized from
    philox.py: forward and every gradient; `mask_grad` (the kernels'
    dmask recompute, plain torch from the LSE) equals autograd's dmask."""
    q, k, v, do = _inputs(2, 40, 56, 2, 16, seed=21)
    mask = (np.random.RandomState(22).randn(2, 1, 40, 56) * 0.5).astype(
        np.float32) if with_mask else None
    p, seed = 0.2, 123456789
    grads = []
    for fn in (lambda *a: fa.flash_attention(*a[:3], causal, a[3], p, seed),
               lambda *a: _dropout_formula(*a[:3], causal, a[3], p, seed)):
        ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        tm = None if mask is None else torch.from_numpy(mask).requires_grad_()
        o = fn(*ins, tm)
        o.backward(torch.from_numpy(do))
        grads.append([o.detach()] + [t.grad for t in ins]
                     + ([] if tm is None else [tm.grad]))
    for name, got, want in zip(("o", "dq", "dk", "dv", "dmask"), *grads):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5,
                                   msg=name)
    if with_mask:
        tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
        o = fa.attention_ref(tq, tk, tv, causal, tm, p, seed)
        lse = fa.attention_lse_ref(tq, tk, causal, tm)
        got = fa.mask_grad(tq, tk, tv, o, torch.from_numpy(do), lse, tm,
                           causal, p, seed)
        torch.testing.assert_close(got, grads[1][4], atol=1e-6, rtol=1e-5)


def test_dropout_seeds_and_eval():
    """One seed gives one output, another seed another; no dropout
    (dropout_p 0, or SDPA outside training) is attention_ref."""
    tq, tk, tv, _ = map(torch.from_numpy, _inputs(1, 32, 32, 2, 16))
    a = fa.flash_attention(tq, tk, tv, dropout_p=0.3, seed=1)
    assert torch.equal(a, fa.flash_attention(tq, tk, tv, dropout_p=0.3,
                                             seed=1))
    assert (a - fa.flash_attention(tq, tk, tv, dropout_p=0.3, seed=2)
            ).abs().max() > 1e-2
    ref = fa.attention_ref(tq, tk, tv)
    assert (a - ref).abs().max() > 1e-2
    torch.testing.assert_close(fa.flash_attention(tq, tk, tv, seed=1), ref)
    torch.testing.assert_close(scaled_dot_product_attention(
        tq, tk, tv, dropout_p=0.3, training=False), ref)


def test_dropout_is_unbiased():
    """The mean over 256 seeds of the dropout output approaches the output
    without dropout: every entry within 6 standard errors of the mean
    (its own spread over the seeds / 16), p 0.1."""
    tq, tk, tv, _ = map(torch.from_numpy, _inputs(2, 32, 32, 2, 16, seed=4))
    outs = torch.stack([fa.attention_ref(tq, tk, tv, True, None, 0.1, s)
                        for s in range(256)]).double()
    ref = fa.attention_ref(tq, tk, tv, True).double()
    err = (outs.mean(0) - ref).abs()
    assert bool((err <= 6 * outs.std(0) / 16 + 1e-7).all()), err.max()


def test_elementwise_dropout():
    """`dropout` keeps 1 - p of the entries, scaled by 1/(1 - p); it is the
    identity outside training and zero at p = 1; a seeded generator
    repeats it."""
    x = torch.ones(256, 1024)
    y = dropout(x, 0.25, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 6 * np.sqrt(
        0.25 * 0.75 / x.numel())
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(y, dropout(x, 0.25, generator=torch.Generator()
                                  .manual_seed(0)))
    assert dropout(x, 0.25, training=False) is x
    assert not dropout(x, 1.0).any()


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, _ = _inputs(1, 8, 8, 2, 64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(tq, tk, tv)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd(tq, tk, tv, tq, tq, torch.zeros(2, 8))
