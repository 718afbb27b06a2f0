"""The port's ring attention (parallel/ring_attention.py) against the JAX
package's (`paddle_tpu.parallel.ring_attention.ring_attention`), on the
CPU.

The port's ranks are threads, one gloo group a ring (`run_ranks`); each
holds its ``[B, S/n, H, D]`` slices of q, k and v, made from a numpy seed.
The JAX ring runs on a ``{"sp": n}`` mesh of the 8-fake-device CPU
platform, as `tests/test_distributed_spmd.py` runs it, and its gradients
come from `jax.grad` through it. At sp 2 and 4, causal and not:

- the output slices, joined, within 2e-5 of the JAX output;
- dq, dk and dv within 2e-5 of `jax.grad`'s (each rank's dk / dv are its
  own block's, home after the ring's last hop);
- each rank's sends and receives equal `ring_hops` (n - 1 hops forward,
  n backward, one send and one receive a hop).

Also: with no group, or a group of one, it is `flash_attention` (the JAX
ring's fallback); the single-process steps (`rank_forward`,
`rank_backward`) over the n blocks give one plain attention call's output
and gradients, and launch nothing above a causal diagonal.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.distributed.mesh import init_mesh as jax_init_mesh
from paddle_tpu.distributed.mesh import set_mesh as jax_set_mesh
from paddle_tpu.parallel.ring_attention import ring_attention as jax_ring
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parallel import collectives as coll
from paddle_tpu_torch.parallel.ring_attention import (block_causality,
                                                      rank_backward,
                                                      rank_forward,
                                                      ring_attention,
                                                      ring_hops)
from test_torch_collectives import run_ranks
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

B, S, H, D = 2, 64, 2, 16
TOL = 2e-5


def teardown_module():
    jax_set_mesh(None)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, S, H, D).astype(np.float32) for _ in range(4)]


def _jax(n, causal, q, k, v, do):
    """The JAX ring's output and its (dq, dk, dv) by `jax.grad` of
    ``sum(out * do)`` on a ``{"sp": n}`` mesh."""
    mesh = jax_init_mesh({"sp": n})
    try:
        def f(q, k, v):
            return jax_ring(q, k, v, mesh=mesh, causal=causal)

        out = f(*map(jnp.asarray, (q, k, v)))
        grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(do)),
                         argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
        return [np.asarray(out)] + [np.asarray(g) for g in grads]
    finally:
        jax_set_mesh(None)


def _port(tmp_path, n, causal, q, k, v, do):
    """Each of n thread ranks runs the ring on its slices: the joined
    (out, dq, dk, dv) and each rank's (sends, receives)."""
    def rank(group):
        sl = slice(group.rank * S // n, (group.rank + 1) * S // n)
        qs, ks, vs = (torch.from_numpy(t[:, sl]).requires_grad_()
                      for t in (q, k, v))
        before = coll.collective_counts()
        out = ring_attention(qs, ks, vs, group, causal)
        out.backward(torch.from_numpy(do[:, sl]))
        after = coll.collective_counts()
        return ([out.detach(), qs.grad, ks.grad, vs.grad],
                {k: after[k] - before[k] for k in ("send", "recv")})

    res = run_ranks(tmp_path, n, rank)
    joined = [torch.cat([r[0][i] for r in res], 1).numpy() for i in range(4)]
    return joined, [r[1] for r in res]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_ring_and_its_grad(tmp_path, n, causal):
    q, k, v, do = _inputs()
    want = _jax(n, causal, q, k, v, do)
    coll.reset_collective_counts()
    got, _ = _port(tmp_path, n, causal, q, k, v, do)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=name)
    # the thread ranks share the process's counters: n ranks' hops
    fwd, bwd = ring_hops(n)
    counts = coll.collective_counts()
    assert counts["send"] == counts["recv"] == n * (fwd + bwd)


def test_group_of_one_is_flash_attention():
    """No group, or a group of one rank: `flash_attention` itself (the
    JAX ring's fallback without a mesh), gradients too."""
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(1))
    want = fa.flash_attention(q, k, v, True)
    one = types.SimpleNamespace(rank=0, size=1)
    for group in (None, one):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        out = ring_attention(qs, ks, vs, group, causal=True)
        assert torch.equal(out, want)
        out.backward(do)
        assert qs.grad is not None and ks.grad is not None
    jw = _jax(1, True, *[t.numpy() for t in (q, k, v, do)])
    np.testing.assert_allclose(out.detach().numpy(), jw[0], atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_single_process_steps_equal_one_plain_call(n, causal):
    """The n ranks' steps run in one process (no transport): joined, the
    outputs and gradients of one plain attention call over the whole
    sequence, within 2e-5; a causal rank i attends i + 1 blocks."""
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(2))
    qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
    o = fa.attention_ref(qq, kk, vv, causal)
    o.backward(do)
    step = S // n
    qs, ks, vs, dos = ([t[:, i * step:(i + 1) * step] for i in range(n)]
                       for t in (q, k, v, do))
    blocks = list(zip(ks, vs))
    outs, dq, dk, dv = [], [], [torch.zeros_like(t) for t in ks], \
        [torch.zeros_like(t) for t in vs]
    for i in range(n):
        oi, lse = rank_forward(qs[i], blocks, i, causal)
        outs.append(oi)
        dqi, parts = rank_backward(qs[i], blocks, oi, dos[i], lse, i, causal)
        assert sorted(parts) == [j for j in range(n)
                                 if block_causality(i, j, causal) is not None]
        assert len(parts) == (i + 1 if causal else n)
        dq.append(dqi)
        for j, (a, b) in parts.items():
            dk[j] += a
            dv[j] += b
    for name, g, w in (("out", outs, o.detach()), ("dq", dq, qq.grad),
                       ("dk", dk, kk.grad), ("dv", dv, vv.grad)):
        torch.testing.assert_close(torch.cat(g, 1), w, atol=TOL, rtol=0,
                                   msg=name)


def test_block_causality_and_hops():
    """The diagonal causal, below it in full, above it nothing; without
    causality every block in full. n - 1 hops forward, n backward."""
    assert block_causality(2, 2, True) is True
    assert block_causality(2, 1, True) is False
    assert block_causality(1, 2, True) is None
    assert all(block_causality(i, j, False) is False
               for i in range(3) for j in range(3))
    assert [ring_hops(n) for n in (1, 2, 4)] == [(0, 0), (1, 2), (3, 4)]
