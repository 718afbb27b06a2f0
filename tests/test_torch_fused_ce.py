"""The port's linear + cross-entropy heads against the JAX package's
`fused_linear_cross_entropy`, on the CPU in float32: the loss and its
gradients with respect to the hidden states and the tied weight."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.fused_ce import _pick_chunks as jax_pick_chunks
from paddle_tpu.ops.fused_ce import fused_linear_cross_entropy as jax_fused
from paddle_tpu_torch.ops.fused_ce import (_pick_chunks,
                                           fused_linear_cross_entropy,
                                           linear_cross_entropy)

B, S, H, V = 2, 32, 16, 96
TOL = dict(atol=1e-6, rtol=1e-5)   # float32, different summation orders


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    return (rs.randn(B, S, H).astype(np.float32),
            (rs.randn(V, H) * 0.3).astype(np.float32),
            rs.randint(0, V, (B, S)).astype(np.int64))


def _jax(x, w, labels, n_chunks):
    loss, (dx, dw) = jax.value_and_grad(
        lambda x, w: jax_fused(x, w, jnp.asarray(labels), n_chunks),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    return float(loss), np.asarray(dx), np.asarray(dw)


def _torch(fn, x, w, labels):
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = fn(tx, tw, torch.from_numpy(labels))
    loss.backward()
    return loss.item(), tx.grad.numpy(), tw.grad.numpy()


@pytest.mark.parametrize("n_chunks", [1, 4, None])
def test_fused_ce_matches_jax(data, n_chunks):
    want = _jax(*data, n_chunks)
    got = _torch(lambda x, w, lab: fused_linear_cross_entropy(
        x, w, lab, n_chunks), *data)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    np.testing.assert_allclose(got[2], want[2], **TOL)


@pytest.mark.parametrize("n_chunks", [1, 4, None])
def test_unfused_head_matches_jax_fused(data, n_chunks):
    """The one-product head that keeps its logits gives the chunked
    head's value and gradients (the JAX package asserts the same)."""
    want = _jax(*data, n_chunks)
    got = _torch(linear_cross_entropy, *data)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_unfused_head_matches_plain_autograd(data):
    x, w, labels = data
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    torch.nn.functional.cross_entropy(
        (tx @ tw.t()).reshape(-1, V), torch.from_numpy(labels).reshape(-1)
    ).backward()
    got = _torch(linear_cross_entropy, *data)
    np.testing.assert_allclose(got[1], tx.grad.numpy(), **TOL)
    np.testing.assert_allclose(got[2], tw.grad.numpy(), **TOL)


@pytest.mark.parametrize("b,s,v,n", [(2, 1024, 32768, None), (32, 1024,
                                     32768, None), (1, 6, 10, 4),
                                     (4, 64, 512, 3), (8, 128, 1000, 0)])
def test_pick_chunks_is_the_jax_rule(b, s, v, n):
    assert _pick_chunks(b, s, v, n) == jax_pick_chunks(b, s, v, n)
