"""The port's Megatron layers (distributed/fleet/meta_parallel/mp_layers.py),
the vocab-parallel losses (ops/fused_ce.py), the group-aware clip
(nn/clip.py) and the flash wrapper's head offset (ops/flash_attention.py),
on the CPU.

Without a group the layers are their dense counterparts, equal to the JAX
package's layers on the same numpy weights (`tests/test_distributed_spmd.py
:57`'s bar). On two ranks (one thread each over one gloo group, as
`test_torch_collectives.run_ranks` builds them) each rank holds its shard,
and the outputs and the gradients, gathered, equal the dense layer's
within 1e-5. With a head offset the plain attention's dropout draws the
bits the whole model draws for those heads.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.meta_parallel import (
    ColumnParallelLinear as JaxColumn, RowParallelLinear as JaxRow,
    VocabParallelEmbedding as JaxVocab, ParallelCrossEntropy as JaxPCE)
from paddle_tpu.distributed.mesh import set_mesh as jax_set_mesh
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
    VocabParallelEmbedding)
from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers as mpl
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByNorm
from paddle_tpu_torch.ops import fused_ce
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.parallel import collectives as coll
from test_torch_collectives import run_ranks, shared_cores  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def teardown_module():
    jax_set_mesh(None)


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(
        shape).astype(np.float32))


# -- dense at degree 1, against the JAX layers ---------------------------------


def test_layers_without_a_group_equal_the_jax_layers():
    """ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding and
    ParallelCrossEntropy with no mesh: the JAX layers' outputs on the same
    weights (a Linear weight transposed), and JAX's ``sharding_axes`` in
    the port's ``[out, in]`` layout."""
    jax_set_mesh(None)
    paddle.seed(0)
    jcol, jrow, jemb = JaxColumn(8, 16), JaxRow(16, 8), JaxVocab(32, 8)
    col, row, emb = (ColumnParallelLinear(8, 16, device="cpu"),
                     RowParallelLinear(16, 8, device="cpu"),
                     VocabParallelEmbedding(32, 8, device="cpu"))
    with torch.no_grad():
        for mine, theirs in ((col, jcol), (row, jrow)):
            mine.weight.copy_(torch.from_numpy(theirs.weight.numpy().T))
            mine.bias.copy_(torch.from_numpy(theirs.bias.numpy()))
        emb.weight.copy_(torch.from_numpy(jemb.weight.numpy()))
    x, y = np.random.RandomState(1).rand(2, 8), \
        np.random.RandomState(2).rand(2, 16)
    x, y = x.astype(np.float32), y.astype(np.float32)
    np.testing.assert_allclose(col(torch.from_numpy(x)).detach().numpy(),
                               jcol(paddle.to_tensor(x)).numpy(), **TOL)
    np.testing.assert_allclose(row(torch.from_numpy(y)).detach().numpy(),
                               jrow(paddle.to_tensor(y)).numpy(), **TOL)
    ids = np.array([[1, 5, 31]])
    np.testing.assert_allclose(emb(torch.from_numpy(ids)).detach().numpy(),
                               jemb(paddle.to_tensor(ids)).numpy())
    logits = np.random.RandomState(3).standard_normal((4, 32)).astype(
        np.float32)
    labels = np.array([3, -100, 31, 0])
    np.testing.assert_allclose(
        ParallelCrossEntropy()(torch.from_numpy(logits),
                               torch.from_numpy(labels)).numpy(),
        np.asarray(JaxPCE()(paddle.to_tensor(logits),
                            paddle.to_tensor(labels)).numpy()).reshape(-1),
        **TOL)
    assert col.weight.sharding_axes == tuple(jcol.weight.sharding_axes)[::-1]
    assert row.weight.sharding_axes == tuple(jrow.weight.sharding_axes)[::-1]
    assert emb.weight.sharding_axes == jemb.weight.sharding_axes
    assert col.bias.sharding_axes == jcol.bias.sharding_axes


# -- two ranks -----------------------------------------------------------------


def _sharded(module, group, mp):
    """A copy of `module` as mp rank ``group.rank`` holds it."""
    shard = mpl.shard_for_mp(torch.nn.Sequential(
        _meta_copy(module)), mpl.MPGroup(group, group.rank, mp))[0]
    shard.to_empty(device="cpu")
    with torch.no_grad():
        for leaf in ("weight", "bias"):
            p = getattr(module, leaf, None)
            if p is None:
                continue
            layout = mpl.mp_layout(module, leaf)
            v = p if layout is None else mpl.mp_cut(
                p, layout[0], group.rank, mp, layout[1])
            getattr(shard, leaf).copy_(v)
    return shard


def _meta_copy(module):
    from paddle_tpu_torch.nn.layer import meta_copy

    return meta_copy(module)


# kind: (dense layer, whether a rank's output is its columns (and how many
# blocks they come in), whether a rank's input is its slice of the last dim)
CASES = {
    "column": (lambda: ColumnParallelLinear(8, 12, gather_output=False),
               1, False),
    "column_gather": (lambda: ColumnParallelLinear(8, 12), None, False),
    "column_qkv": (lambda: ColumnParallelLinear(8, 24, out_groups=3,
                                                gather_output=False),
                   3, False),
    "row": (lambda: RowParallelLinear(12, 8, input_is_parallel=True),
            None, True),
    "row_split": (lambda: RowParallelLinear(12, 8), None, False),
    "vocab": (lambda: VocabParallelEmbedding(16, 8), None, False),
}


@pytest.mark.parametrize("kind", list(CASES))
def test_two_ranks_equal_the_dense_layer(tmp_path, kind):
    """Each rank's shard: the replicated output (or the rank's columns)
    and, after the backward, the input's gradient (or the rank's slice of
    it) and the rank's slice of the parameters' gradients equal the dense
    layer's."""
    torch.manual_seed(0)
    build, cols, sliced_in = CASES[kind]
    dense = build()
    if kind == "vocab":
        x = torch.tensor([[0, 3, 8, 15], [9, 7, 2, 12]])
    else:
        x = _rand(3, dense.in_features)

    def run(module, xin, g):
        xin = xin.clone().requires_grad_(xin.is_floating_point())
        y = module(xin)
        y.backward(g)
        return y.detach(), xin.grad, {k: p.grad for k, p in
                                      module.named_parameters()}

    def cut_cols(t, r):
        return t if cols is None else mpl.mp_cut(t, t.dim() - 1, r, 2, cols)

    def cut_in(t, r):
        n = t.shape[-1] // 2
        return t[..., r * n:(r + 1) * n] if sliced_in else t

    y0 = dense(x)
    g_full = _rand(*y0.shape, seed=5)
    want_y, want_dx, want_dp = run(dense, x, g_full)
    got = run_ranks(tmp_path, 2, lambda group: run(
        _sharded(dense, group, 2), cut_in(x, group.rank),
        cut_cols(g_full, group.rank)))
    for r, (y, dx, dp) in enumerate(got):
        torch.testing.assert_close(y, cut_cols(want_y, r), **TOL)
        if want_dx is not None:
            torch.testing.assert_close(dx, cut_in(want_dx, r), **TOL)
        for k, g in dp.items():
            layout = mpl.mp_layout(dense, k)
            want = want_dp[k] if layout is None else mpl.mp_cut(
                want_dp[k], layout[0], r, 2, layout[1])
            torch.testing.assert_close(g, want, **TOL)


def test_mp_cut_and_join_invert_each_other():
    t = _rand(12, 5)
    for groups in (1, 3):
        for dim, n in ((0, 12), (1, 5)):
            if n % (2 * groups):
                continue
            parts = [mpl.mp_cut(t, dim, r, 2, groups) for r in range(2)]
            assert torch.equal(mpl.mp_join(parts, dim, groups), t)
    # the qkv-major cut: a rank's rows are its heads of q, of k and of v
    rows = torch.arange(12.0)[:, None]
    got = mpl.mp_cut(rows, 0, 1, 2, 3)[:, 0].tolist()
    assert got == [2.0, 3.0, 6.0, 7.0, 10.0, 11.0]


@pytest.mark.parametrize("n_chunks", [1, 2])
def test_vocab_parallel_head_loss_equals_the_dense_head(tmp_path, n_chunks):
    """The tied head's loss over two ranks' vocab rows (whole: logits kept;
    chunked: recomputed), three all-reduces a chunk forward: the dense
    loss, the hidden state's gradient (summed over the ranks by
    `copy_to_mp`) and each rank's rows of the weight's gradient."""
    x, w = _rand(2, 4, 6, seed=1), _rand(10, 6, seed=2)
    labels = torch.tensor([[0, 9, 5, 4], [6, 1, 2, 8]])
    xd, wd = x.clone().requires_grad_(), w.clone().requires_grad_()
    fused_ce.fused_linear_cross_entropy(xd, wd, labels, n_chunks).backward()
    want = fused_ce.fused_linear_cross_entropy(x, w, labels, n_chunks)
    coll.reset_collective_counts()

    def rank(group):
        mp = mpl.MPGroup(group, group.rank, 2)
        xr = x.clone().requires_grad_()
        wr = w[group.rank * 5:(group.rank + 1) * 5].clone().requires_grad_()
        loss = fused_ce.vocab_parallel_linear_cross_entropy(xr, wr, labels,
                                                            mp, n_chunks)
        loss.backward()
        return loss.detach(), xr.grad, wr.grad

    got = run_ranks(tmp_path, 2, rank)
    counts = coll.collective_counts()
    assert counts["all-reduce"] == 2 * (3 * n_chunks + 1)
    for r, (loss, dx, dw) in enumerate(got):
        torch.testing.assert_close(loss, want, **TOL)
        torch.testing.assert_close(dx, xd.grad, **TOL)
        torch.testing.assert_close(dw, wd.grad[r * 5:(r + 1) * 5], **TOL)


def test_parallel_cross_entropy_over_two_ranks(tmp_path):
    """Per-token losses of logits sharded on the class dim (ignored labels
    0): the dense per-token cross-entropy, and each rank's columns of its
    gradient."""
    logits = _rand(5, 8, seed=3)
    labels = torch.tensor([1, 7, -100, 4, 0])
    ld = logits.clone().requires_grad_()
    want = F.cross_entropy(ld, labels, reduction="none", ignore_index=-100)
    want.sum().backward()

    def rank(group):
        pce = ParallelCrossEntropy()
        pce.mp = mpl.MPGroup(group, group.rank, 2)
        lr = logits[:, group.rank * 4:(group.rank + 1) * 4].clone()
        lr.requires_grad_()
        out = pce(lr, labels)
        out.sum().backward()
        return out.detach(), lr.grad

    for r, (out, g) in enumerate(run_ranks(tmp_path, 2, rank)):
        torch.testing.assert_close(out, want.detach(), **TOL)
        torch.testing.assert_close(g, ld.grad[:, r * 4:(r + 1) * 4], **TOL)


@pytest.mark.parametrize("clip_cls", [ClipGradByGlobalNorm, ClipGradByNorm])
def test_clip_over_sharded_gradients_equals_the_dense_clip(tmp_path,
                                                           clip_cls):
    """A sharded leaf's squared norm sums over its group, a replicated one
    counts once: the clipped shards are the dense clip's slices."""
    full = [_rand(6, 4, seed=1), _rand(4, seed=2)]      # sharded, replicated
    want = clip_cls(0.5).clip_arrays([g.clone() for g in full])

    def rank(group):
        mine = [full[0][group.rank * 3:(group.rank + 1) * 3], full[1]]
        return clip_cls(0.5).clip_arrays(mine, groups=[group, None])

    for r, got in enumerate(run_ranks(tmp_path, 2, rank)):
        torch.testing.assert_close(got[0], want[0][r * 3:(r + 1) * 3], **TOL)
        torch.testing.assert_close(got[1], want[1], **TOL)


def test_all_reduce_max_counts_one_call(tmp_path):
    coll.reset_collective_counts()
    got = run_ranks(tmp_path, 2, lambda g: coll.all_reduce(
        torch.tensor([float(g.rank), -float(g.rank)]), g, op="max").tolist())
    assert got == [[1.0, 0.0], [1.0, 0.0]]
    assert coll.collective_counts()["all-reduce"] == 2


# -- the keep bits' head coordinate ----------------------------------------------


@pytest.mark.parametrize("causal,with_mask", [(True, False), (False, True)])
def test_head_offset_draws_the_whole_models_keep_bits(causal, with_mask):
    """Attention over heads [2, 4) of 4 with `head_offset` 2 equals those
    heads of the whole 4-head call, dropout included (forward, the dK/dV
    and dQ gradients through the plain version, and the mask's gradient);
    the default offset draws what the call always drew."""
    B, S, H, D = 2, 8, 4, 16
    q, k, v = (_rand(B, S, H, D, seed=s) for s in (1, 2, 3))
    mask = (_rand(B, 1, 1, S, seed=4) if with_mask else None)
    p, seed = 0.3, 1234
    qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
    full = fa.attention_ref(qf, kf, vf, causal, mask, p, seed)
    g = _rand(*full.shape, seed=9)
    full.backward(g)
    hs = slice(2, 4)
    qs, ks, vs = (t[:, :, hs].clone().requires_grad_() for t in (q, k, v))
    part = fa.attention_ref(qs, ks, vs, causal, mask, p, seed,
                            head_offset=2, heads_total=4)
    part.backward(g[:, :, hs])
    torch.testing.assert_close(part, full[:, :, hs].detach(), **TOL)
    for a, b in ((qs, qf), (ks, kf), (vs, vf)):
        torch.testing.assert_close(a.grad, b.grad[:, :, hs], **TOL)
    own = fa.attention_ref(qs.detach(), ks.detach(), vs.detach(), causal,
                           mask, p, seed)
    assert not torch.allclose(own, part.detach())     # other heads' bits
    d = fa.dropout_factors(seed, p, B, 2, S, S, head_offset=2, heads_total=4)
    torch.testing.assert_close(d, fa.dropout_factors(seed, p, B, 4, S, S)
                               [:, 2:4])
    with pytest.raises(ValueError, match="do not lie"):
        fa.drop_heads(B, 2, head_offset=3, heads_total=4)
