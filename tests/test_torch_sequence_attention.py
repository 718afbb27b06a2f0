"""The port's gathered sequence attention (parallel/sequence_attention.py)
and the keep bits at a query-row offset (ops/philox.py,
ops/flash_attention.py) against the JAX package's reference attention
(`paddle_tpu.ops.pallas.flash_attention._attention_xla`, what GSPMD runs
for a sequence-split input), on the CPU.

The port's ranks are threads, one gloo group a degree (`run_ranks`); each
holds its ``[B, S/n, H, D]`` slices of q, k and v, made from a numpy seed.
At n = 2 and 4, causal and with a padding mask:

- each rank's output and its dq, dk, dv (every rank's dK / dV partials
  reduce-scattered home) within 1e-5 of the JAX attention over the whole
  sequence and `jax.grad` through it, sliced to the rank;
- each rank makes one all-gather and one reduce-scatter a call
  (`gathered_calls`, the budget's term);
- the plain keep bits and dropout factors at ``q_row0`` equal the whole
  call's rows bit for bit, `attention_ref` at ``q_row0`` the whole call's
  rows within 1e-6, and with dropout the ranks' outputs and gradients
  equal one plain call's (the JAX package's PRNG cannot match the keep
  bits, so dropout stays inside the port);
- with no group, or a group of one, it is `flash_attention`; the ranks'
  arithmetic runs in one process (`rank_forward`, `rank_backward`), a
  causal rank attending its prefix alone.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import _attention_xla
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import philox
from paddle_tpu_torch.parallel import collectives as coll
from paddle_tpu_torch.parallel.sequence_attention import (
    attended_keys, gathered_attention, gathered_calls, rank_backward,
    rank_forward, rank_mask)
from test_torch_collectives import run_ranks
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

B, S, H, D = 2, 64, 2, 16
TOL = 1e-5
SEED, P = 1234, 0.1


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(B, S, H, D).astype(np.float32)
                   for _ in range(4))
    lens = rs.randint(S // 2, S + 1, B)
    mask = np.where(np.arange(S)[None] < lens[:, None], 0.0,
                    -1e4).astype(np.float32)[:, None, None, :]
    return q, k, v, do, mask


def _jax(causal, q, k, v, do, mask):
    """JAX's attention over the whole sequence and (dq, dk, dv) by
    `jax.grad` of ``sum(out * do)``."""
    m = None if mask is None else jnp.asarray(mask)

    def f(q, k, v):
        return _attention_xla(q, k, v, mask=m, causal=causal)

    args = [jnp.asarray(t) for t in (q, k, v)]
    grads = jax.grad(lambda *a: jnp.sum(f(*a) * jnp.asarray(do)),
                     argnums=(0, 1, 2))(*args)
    return [np.asarray(f(*args))] + [np.asarray(g) for g in grads]


def _ranks(tmp_path, n, causal, q, k, v, do, mask, p=0.0):
    """Each of n thread ranks runs gathered attention on its slices: the
    joined (out, dq, dk, dv) and each rank's (all-gathers,
    reduce-scatters)."""
    m = None if mask is None else torch.from_numpy(mask)

    def rank(group):
        sl = slice(group.rank * S // n, (group.rank + 1) * S // n)
        qs, ks, vs = (torch.from_numpy(t[:, sl]).requires_grad_()
                      for t in (q, k, v))
        before = coll.collective_counts()
        out = gathered_attention(qs, ks, vs, group, causal, m, p,
                                 SEED if p else None)
        out.backward(torch.from_numpy(do[:, sl]))
        after = coll.collective_counts()
        return ([out.detach(), qs.grad, ks.grad, vs.grad],
                {c: after[c] - before[c] for c in ("all-gather",
                                                   "reduce-scatter")})

    res = run_ranks(tmp_path, n, rank)
    joined = [torch.cat([r[0][i] for r in res], 1).numpy() for i in range(4)]
    return joined, [r[1] for r in res]


@pytest.mark.parametrize("causal,masked", [(True, False), (False, True)],
                         ids=["causal", "padding"])
@pytest.mark.parametrize("n", [2, 4])
def test_gathered_matches_jax_and_its_grad(tmp_path, n, causal, masked):
    q, k, v, do, mask = _inputs()
    mask = mask if masked else None
    want = _jax(causal, q, k, v, do, mask)
    coll.reset_collective_counts()
    got, _ = _ranks(tmp_path, n, causal, q, k, v, do, mask)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=name)
    # the thread ranks share the process's counters: n ranks' calls
    fwd, bwd = gathered_calls(n)
    counts = coll.collective_counts()
    assert (counts["all-gather"], counts["reduce-scatter"]) == (n * fwd,
                                                                n * bwd)
    assert (counts["all-reduce"], counts["send"]) == (0, 0)


@pytest.mark.parametrize("causal", [False, True])
def test_dropout_ranks_equal_one_plain_call(tmp_path, causal):
    """Attention dropout 0.1 over two ranks: each rank draws the whole
    sequence's keep bits at its rows, so the joined output and gradients
    equal one plain call's over the whole sequence (autograd through
    `attention_ref`) within 1e-5."""
    q, k, v, do, mask = _inputs(3)
    mask = None if causal else mask
    ts = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    o = fa.attention_ref(*ts, causal, None if mask is None
                         else torch.from_numpy(mask), P, SEED)
    o.backward(torch.from_numpy(do))
    want = [o.detach()] + [t.grad for t in ts]
    got, _ = _ranks(tmp_path, 2, causal, q, k, v, do, mask, P)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w.numpy(), atol=TOL, rtol=0,
                                   err_msg=name)
    undropped, _ = _ranks(tmp_path, 2, causal, q, k, v, do, mask)
    assert np.abs(got[0] - undropped[0]).max() > 1e-2   # it dropped


@pytest.mark.parametrize("n", [2, 4])
def test_keep_bits_at_a_row_offset_are_the_whole_calls_rows(n):
    """The plain keep bits and dropout factors of rank r's rows at
    ``q_row0 = r * S / n`` equal the whole call's rows bit for bit (every
    head, heads numbered from an offset too); `attention_ref` at the
    offset equals the whole call's rows within 1e-6, causal over the
    rank's key prefix and masked over every key."""
    L = S // n
    q, k, v, _, mask = (torch.from_numpy(t) for t in _inputs(4))
    heads = torch.arange(3, 3 + B * H)
    whole_bits = philox.dropout_bits(SEED, heads, S, S)
    whole_f = fa.dropout_factors(SEED, P, B, H, S, S, head_offset=1,
                                 heads_total=4)
    o_c = fa.attention_ref(q, k, v, True, None, P, SEED)
    o_m = fa.attention_ref(q, k, v, False, mask, P, SEED)
    for r in range(n):
        rows = slice(r * L, (r + 1) * L)
        assert torch.equal(philox.dropout_bits(SEED, heads, L, S,
                                               q_row0=r * L),
                           whole_bits[:, rows])
        assert torch.equal(fa.dropout_factors(SEED, P, B, H, L, S,
                                              head_offset=1, heads_total=4,
                                              q_row0=r * L),
                           whole_f[:, :, rows])
        keys = attended_keys(r, L, S, True)
        got_c = fa.attention_ref(q[:, rows], k[:, :keys], v[:, :keys], True,
                                 None, P, SEED, q_row0=r * L)
        got_m = fa.attention_ref(q[:, rows], k, v, False, mask, P, SEED,
                                 q_row0=r * L)
        torch.testing.assert_close(got_c, o_c[:, rows], atol=1e-6, rtol=0)
        torch.testing.assert_close(got_m, o_m[:, rows], atol=1e-6, rtol=0)
    # the default offset is row 0: the call as before
    assert torch.equal(philox.keep_mask(SEED, P, heads, S, S),
                       philox.keep_mask(SEED, P, heads, S, S, q_row0=0))


@pytest.mark.parametrize("p", [0.0, P])
@pytest.mark.parametrize("causal", [False, True])
def test_rank_steps_in_one_process_equal_one_plain_call(causal, p):
    """The n = 4 ranks' arithmetic in one process (no transport): the
    outputs and dQ joined, and the dK / dV partials summed over the
    ranks, equal one plain call over the whole sequence within 1e-5; a
    causal rank's partials cover its key prefix alone."""
    n, L = 4, S // 4
    q, k, v, do, mask = (torch.from_numpy(t) for t in _inputs(5))
    mask = None if causal else mask
    seed = SEED if p else None
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.attention_ref(*ts, causal, mask, p, seed)
    o.backward(do)
    outs, dq = [], []
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for r in range(n):
        rows = slice(r * L, (r + 1) * L)
        o_r, lse = rank_forward(q[:, rows], k, v, r, causal, mask, p, seed)
        dq_r, dk_r, dv_r = rank_backward(q[:, rows], k, v, o_r, do[:, rows],
                                         lse, r, causal, mask, p, seed)
        keys = attended_keys(r, L, S, causal)
        assert dk_r.shape[1] == dv_r.shape[1] == keys
        outs.append(o_r)
        dq.append(dq_r)
        dk[:, :keys] += dk_r
        dv[:, :keys] += dv_r
    for name, g, w in (("out", torch.cat(outs, 1), o.detach()),
                       ("dq", torch.cat(dq, 1), ts[0].grad),
                       ("dk", dk, ts[1].grad), ("dv", dv, ts[2].grad)):
        torch.testing.assert_close(g, w, atol=TOL, rtol=0, msg=name)


def test_group_of_one_is_flash_attention():
    """No group, or a group of one rank: `flash_attention` itself, with
    the mask and dropout, gradients too."""
    q, k, v, do, mask = (torch.from_numpy(t) for t in _inputs(1))
    want = fa.flash_attention(q, k, v, False, mask, P, SEED)
    one = types.SimpleNamespace(rank=0, size=1)
    for group in (None, one):
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        out = gathered_attention(qs, ks, vs, group, False, mask, P, SEED)
        assert torch.equal(out, want)
        out.backward(do)
        assert qs.grad is not None and ks.grad is not None


def test_rank_mask_and_what_it_refuses():
    """A rank's mask: its query rows where the mask has them, the keys it
    attends where it has a key axis, a broadcast axis left as it is (a
    view). A mask that needs a gradient, dropout without a seed and
    slices of unequal length raise."""
    full = torch.randn(B, H, S, S)
    m = rank_mask(full, 1, 16, 32)
    assert m.shape == (B, H, 16, 32) and torch.equal(m, full[:, :, 16:32,
                                                             :32])
    assert m.data_ptr() == full[:, :, 16:].data_ptr()
    pad = torch.zeros(B, 1, 1, S)
    assert rank_mask(pad, 3, 16, S).shape == (B, 1, 1, S)
    assert rank_mask(torch.zeros(S, S), 2, 16, 48).shape == (1, 1, 16, 48)
    assert rank_mask(None, 0, 16, S) is None
    two = types.SimpleNamespace(rank=0, size=2)
    q = torch.zeros(B, 32, H, D)
    with pytest.raises(ValueError, match="mask gradient"):
        gathered_attention(q, q, q, two, False, pad.requires_grad_())
    with pytest.raises(ValueError, match="seed"):
        gathered_attention(q, q, q, two, False, None, 0.1)
    with pytest.raises(ValueError, match="slices of one sequence"):
        gathered_attention(q, q[:, :16], q[:, :16], two)
