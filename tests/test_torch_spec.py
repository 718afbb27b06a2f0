"""The port's speculative-decoding pieces against the JAX package's, with
inputs from a seeded numpy RNG handed to both."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.serving import spec as jspec
from paddle_tpu_torch.serving import spec as tspec
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)


def _histories():
    rs = np.random.RandomState(0)
    out = [[], [1], [1, 2], [3, 3, 3, 3], [5, 6, 7, 5, 6, 7, 5, 6],
           [1, 2, 3, 9, 1, 2, 3, 8, 1, 2, 3]]
    for n in (10, 40, 200):
        out.append(rs.randint(0, 6, n).tolist())       # many repeats
        out.append(rs.randint(0, 1000, n).tolist())    # few repeats
    return out


@pytest.mark.parametrize("num_spec,max_ngram,min_ngram,max_tokens", [
    (4, 3, 1, None), (2, 2, 1, 1), (6, 4, 2, 5), (3, 1, 1, None),
])
def test_ngram_drafter_matches_jax(num_spec, max_ngram, min_ngram,
                                   max_tokens):
    jd = jspec.NgramDrafter(num_spec, max_ngram, min_ngram)
    td = tspec.NgramDrafter(num_spec, max_ngram, min_ngram)
    for hist in _histories():
        assert td.propose(hist, max_tokens) == jd.propose(hist, max_tokens)


def _logits(B, S, V, seed):
    rs = np.random.RandomState(seed)
    lg = rs.randn(B, S, V).astype(np.float32) * 3.0
    lg[0, 0, :4] = lg[0, 0].max() + 1.0   # ties at the top
    return lg


@pytest.mark.parametrize("seed", range(4))
def test_greedy_spec_emit_matches_jax(seed):
    B, S, V = 5, 5, 64
    rs = np.random.RandomState(100 + seed)
    lg = _logits(B, S, V, seed)
    greedy = lg.argmax(-1)
    ids = rs.randint(0, V, (B, S)).astype(np.int32)
    # drafts that follow the greedy chain for a random number of slots
    for b in range(B):
        n_ok = rs.randint(0, S)
        ids[b, 1:1 + n_ok] = greedy[b, :n_ok]
    spec_lens = rs.randint(0, S, B).astype(np.int32)
    temps = np.zeros(B, np.float32)
    top_ks = np.zeros(B, np.int32)
    top_ps = np.ones(B, np.float32)
    j_run, j_nacc = jspec.spec_emit_arrays(
        jnp.asarray(lg), jnp.asarray(ids), jnp.asarray(spec_lens),
        jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps),
        jax.random.PRNGKey(0))
    t_run, t_nacc = tspec.spec_emit_arrays(
        torch.from_numpy(lg), torch.from_numpy(ids),
        torch.from_numpy(spec_lens), torch.from_numpy(temps),
        torch.from_numpy(top_ks), torch.from_numpy(top_ps))
    np.testing.assert_array_equal(t_nacc.numpy(), np.asarray(j_nacc))
    for b in range(B):
        n = int(t_nacc[b])
        np.testing.assert_array_equal(t_run[b, :n + 1].numpy(),
                                      np.asarray(j_run)[b, :n + 1])


def test_width_one_spec_emit_is_the_greedy_sampler():
    lg = _logits(3, 1, 32, 9)
    z = np.zeros(3, np.int32)
    run, n_acc = tspec.spec_emit_arrays(
        torch.from_numpy(lg), torch.zeros((3, 1), dtype=torch.int32),
        torch.from_numpy(z), torch.zeros(3), torch.from_numpy(z),
        torch.ones(3))
    assert n_acc.tolist() == [0, 0, 0]
    assert run[:, 0].tolist() == lg[:, 0].argmax(-1).tolist()


@pytest.mark.parametrize("seed", range(3))
def test_top_k_top_p_masks_match_jax(seed):
    B, V = 6, 128
    lg = _logits(1, B, V, seed)[0]
    top_ks = np.array([0, 1, 5, 40, 0, 200], np.int32)
    top_ps = np.array([1.0, 1.0, 0.9, 0.5, 0.3, 1.0], np.float32)
    want = np.asarray(jspec._apply_top_k_top_p(
        jnp.asarray(lg), jnp.asarray(top_ks), jnp.asarray(top_ps)))
    got = tspec.apply_top_k_top_p(torch.from_numpy(lg),
                                  torch.from_numpy(top_ks),
                                  torch.from_numpy(top_ps)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    keep = ~np.isneginf(want)
    np.testing.assert_array_equal(got[keep], want[keep])


def test_top_k_top_p_gate_skips_when_no_row_filters():
    lg = torch.from_numpy(_logits(1, 3, 16, 0)[0])
    off_k, off_p = torch.zeros(3, dtype=torch.int32), torch.ones(3)
    assert torch.equal(tspec.apply_top_k_top_p(lg, off_k, off_p), lg)
    # top-k at the vocab size keeps everything, as top-k 0 does
    assert torch.equal(tspec.apply_top_k_top_p(lg, off_k + 16, off_p), lg)


def test_sampled_spec_emit_is_seeded_and_respects_top_k():
    B, S, V = 4, 3, 50
    lg = torch.from_numpy(_logits(B, S, V, 3))
    ids = torch.randint(0, V, (B, S), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    spec_lens = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    temps = torch.full((B,), 0.7)
    top_ks = torch.full((B,), 3, dtype=torch.int32)
    top_ps = torch.ones(B)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tspec.spec_emit_arrays(lg, ids, spec_lens, temps, top_ks,
                                      top_ps, generator=g)

    (r1, n1), (r2, n2) = run(11), run(11)
    assert torch.equal(r1, r2) and torch.equal(n1, n2)
    top3 = torch.topk(lg, 3, dim=-1).indices
    for b in range(B):
        n = int(n1[b])
        assert 0 <= n <= int(spec_lens[b])
        # the stop-slot token is drawn from slot n's top-3 support
        assert int(r1[b, n]) in top3[b, n].tolist()


@pytest.mark.parametrize("case", ["drafts", "nonfinite"])
def test_branch_free_decision_on_greedy_rows_is_greedy(case):
    """The engine's step always runs the sampler, so one captured body
    serves every row; on all-greedy rows it must emit the greedy oracle
    (each drafted token accepted while it equals the argmax before it,
    then the argmax at the stop slot), token for token: with drafts
    accepted and rejected, and with non-finite logits in some rows (the
    engine aborts those rows, but the packed result must not differ)."""
    B, S, V = 6, 5, 64
    rs = np.random.RandomState(7)
    lg = _logits(B, S, V, 5)
    greedy = lg.argmax(-1)
    ids = rs.randint(0, V, (B, S)).astype(np.int32)
    for b in range(B):
        n_ok = rs.randint(0, S)
        ids[b, 1:1 + n_ok] = greedy[b, :n_ok]
    spec_lens = rs.randint(0, S, B).astype(np.int32)
    if case == "nonfinite":
        lg[1, 0, 3] = np.nan
        lg[2, 2, :] = np.inf
        lg[4, 1, 7] = -np.inf
    greedy = torch.argmax(torch.from_numpy(lg), dim=-1).numpy()
    want_n = np.zeros(B, np.int32)
    want_run = np.zeros((B, S), np.int32)
    for b in range(B):
        n = 0
        while n < spec_lens[b] and ids[b, n + 1] == greedy[b, n]:
            n += 1
        want_n[b] = n
        want_run[b, :n] = ids[b, 1:n + 1]
        want_run[b, n:] = greedy[b, n]
    args = [torch.from_numpy(a) for a in (
        lg, ids, spec_lens, np.zeros(B, np.float32), np.zeros(B, np.int32),
        np.ones(B, np.float32))]
    got_run, got_n = tspec.spec_emit_arrays(
        *args, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    np.testing.assert_array_equal(got_run.numpy(), want_run)
    if case == "drafts":
        assert want_n.max() > 0 and (want_n < spec_lens).any()
