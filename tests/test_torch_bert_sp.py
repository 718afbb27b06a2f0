"""Sequence-parallel ERNIE / BERT pretraining in the port
(`Bert.shard_sequence`, parallel/sequence_attention.py, parallel/spmd.py's
sequence split) against the JAX package's GSPMD step, on the CPU.

The port's ranks are spawned gloo processes, one mesh a degree set
(``{"sp": 2}``, ``{"dp": 2, "sp": 2}``, ``{"sp": 4}``), kept for the
module. The JAX side runs `make_sharded_train_step(..., batch_specs=(P("dp",
"sp"),) * 2)` with its `Bert` and `bert_pretrain_loss_fn` over the same
degrees on the 8-fake-device CPU mesh. Both start from the same numpy
weights (`weights.from_jax_state_dict`) and train float32 with SGD 0.1
for 3 steps on one seeded batch of ids and MLM labels:

- the losses agree within 1e-5 relative (the MLM mean over the whole
  batch's labelled positions: each rank's mean weighed by its count over
  the dp and sp groups) and every gathered parameter within 2e-5
  (`to_jax_train_state`, the JAX layout, untouched by the split);
- each rank's calls a step equal `sp_collective_budget(..., bert=True)`;
- with ERNIE's padding mask (whole on every sp rank: its spec is
  ``"dp"``), token types and dropout 0.1 (attention included),
  ``{"sp": 2}`` equals the port's one process at the same seed (the JAX
  package's PRNG cannot match, so this stays inside the port);
- the NSP head reads the sequence's first token on every sp rank (rank
  0's row, handed over the group), so its logits are the whole
  sequence's, and a loss through it gives one process's gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.distributed.mesh import init_mesh as jax_init_mesh
from paddle_tpu.distributed.mesh import set_mesh as jax_set_mesh
from paddle_tpu.models.bert import Bert as JaxBert
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import bert_pretrain_loss_fn as jax_bert_loss
from paddle_tpu.parallel import spmd as jspmd
from paddle_tpu_torch.distributed.mesh import build_mesh
from paddle_tpu_torch.models.bert import Bert, BertConfig
from paddle_tpu_torch.models.bert import bert_pretrain_loss_fn
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.parallel import collectives as coll
from paddle_tpu_torch.parallel.spmd import (make_sharded_train_step,
                                            sp_collective_budget)
from paddle_tpu_torch.weights import from_jax_state_dict, to_jax_train_state
from test_torch_collectives import run_ranks
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

STEPS, TIMEOUT, LR = 3, 60, 0.1
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           intermediate_size=64, max_position_embeddings=64)
ROWS, SEQ = 4, 32
DEGREES = {"sp2": {"sp": 2}, "dp2sp2": {"dp": 2, "sp": 2},
           "sp4": {"sp": 4}}
SPEC = (("dp", "sp"),) * 2
# ids, token types, the padding mask (whole on every sp rank), labels
MASK_SPEC = (("dp", "sp"), ("dp", "sp"), "dp", ("dp", "sp"))
KEYS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "send",
        "recv")


@pytest.fixture(scope="module")
def meshes():
    ms = {k: build_mesh(d, device="cpu", timeout=TIMEOUT)
          for k, d in DEGREES.items()}
    yield ms
    for m in ms.values():
        m.close()


def teardown_module():
    jax_set_mesh(None)


def _batch(seed=0):
    """ids and MLM labels (15 % of positions; -100 elsewhere)."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, CFG["vocab_size"], (ROWS, SEQ))
    labels = np.where(rs.rand(ROWS, SEQ) < 0.15, ids, -100)
    return ids.astype(np.int32), labels.astype(np.int32)


def _masked_batch(seed=1):
    """ids, token types, the additive padding mask [B, 1, 1, S] (real
    lengths S/2..S) and MLM labels on real positions."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(SEQ // 2, SEQ + 1, ROWS)
    real = np.arange(SEQ)[None] < lens[:, None]
    ids = np.where(real, rs.randint(0, CFG["vocab_size"], (ROWS, SEQ)), 0)
    types = real & (np.arange(SEQ)[None] >= (lens // 2)[:, None])
    labels = np.where(real & (rs.rand(ROWS, SEQ) < 0.15), ids, -100)
    mask = np.where(real, 0.0, -1e4).astype(np.float32)[:, None, None, :]
    return (ids.astype(np.int32), types.astype(np.int32), mask,
            labels.astype(np.int32))


_JAX = {}


def _jax_run(key):
    """The JAX GSPMD step over DEGREES[key] from paddle.seed(0): (initial
    numpy weights, losses, natural numpy params)."""
    if key not in _JAX:
        jmesh = jax_init_mesh(DEGREES[key])
        paddle.seed(0)
        model = JaxBert(JaxBertConfig(**CFG, dropout=0.0))
        init = {k: np.asarray(v)
                for k, v in state_dict_arrays(model)[0].items()}
        opt = paddle.optimizer.SGD(learning_rate=LR,
                                   parameters=model.parameters())
        P = jax.sharding.PartitionSpec
        step = jspmd.make_sharded_train_step(
            model, jax_bert_loss, opt, jmesh,
            batch_specs=(P("dp", "sp"),) * 2)
        params, buffers, opt_state = step.init_state()
        b = step.shard_batch(*_batch())
        losses = []
        for _ in range(STEPS):
            loss, params, buffers, opt_state = step(
                params, buffers, opt_state, jnp.float32(LR),
                jax.random.PRNGKey(0), *b)
            losses.append(float(np.asarray(loss)))
        jax_set_mesh(None)
        _JAX[key] = (init, losses,
                     {k: np.asarray(v) for k, v in params.items()})
    return _JAX[key]


def _port_model(init, dropout=0.0):
    model = Bert(BertConfig(**CFG, dropout=dropout), device="cpu")
    return from_jax_state_dict(model, init)


def _port_step(mesh, init, dropout=0.0, specs=SPEC):
    model = _port_model(init, dropout)
    opt = SGD(learning_rate=LR, parameters=model.named_parameters())
    return make_sharded_train_step(model, bert_pretrain_loss_fn, opt, mesh,
                                   batch_specs=specs)


@pytest.mark.parametrize("key", list(DEGREES))
def test_bert_sp_steps_match_jax_gspmd(meshes, key):
    """3 float32 SGD steps over the same degrees: the JAX losses within
    1e-5 relative and every gathered parameter within 2e-5; each rank's
    calls a step are `sp_collective_budget`'s for BERT."""
    init, want, jparams = _jax_run(key)
    step = _port_step(meshes[key], init)
    try:
        step.rank_reports(zero=True)
        got = [step(*_batch()) for _ in range(STEPS)]
        counts = step.collective_counts()
        params, _, _ = to_jax_train_state(step)
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert set(params) == set(jparams)
    for k, w in jparams.items():
        np.testing.assert_allclose(params[k], w, atol=2e-5, rtol=0,
                                   err_msg=k)
    deg = DEGREES[key]
    budget = sp_collective_budget(CFG["num_layers"], deg["sp"],
                                  deg.get("dp", 1), len(step.names),
                                  bert=True)
    assert len(counts) == meshes[key].size
    for c in counts:
        assert {k: c[k] for k in KEYS} == {k: STEPS * budget[k]
                                           for k in KEYS}, (c, budget)


def test_mask_and_dropout_at_sp2_equal_one_process(meshes):
    """ERNIE's step as phase 8 runs it (token types, the padding mask,
    dropout 0.1 on the embeddings, attention and residual branches) over
    {"sp": 2}, the mask whole on both ranks: one process's losses and
    parameters at the same seed within 1e-5 / 2e-5."""
    init = _jax_run("sp2")[0]
    batch = _masked_batch()
    one = _port_step(build_mesh({"dp": 1}, device="cpu"), init, dropout=0.1,
                     specs=None)
    try:
        want = [one(*batch, seed=9) for _ in range(2)]
        wparams = one.gather_params()
    finally:
        one.close()
    step = _port_step(meshes["sp2"], init, dropout=0.1, specs=MASK_SPEC)
    try:
        got = [step(*batch, seed=9) for _ in range(2)]
        params = step.gather_params()
        with pytest.raises(ValueError, match="batch_specs"):
            step.shard_batch(*batch[:3])
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    undropped = _port_step(build_mesh({"dp": 1}, device="cpu"), init,
                           specs=None)
    try:
        assert abs(undropped(*batch) - want[0]) > 1e-3   # it dropped
    finally:
        undropped.close()
    for k, w in wparams.items():
        np.testing.assert_allclose(params[k].numpy(), w.numpy(), atol=2e-5,
                                   rtol=0, err_msg=k)


def test_nsp_head_reads_the_sequences_first_token(tmp_path):
    """On two thread ranks each holding half of every row: both ranks'
    NSP logits equal one process's (rank 0's first token, handed over the
    group), their MLM logits the process's rows; a loss through the NSP
    head alone, averaged over the ranks as the step averages it, gives
    one process's gradients within 1e-6. Each rank makes one all-gather
    and one reduce-scatter a layer, and one more of each for the first
    token."""
    init = _jax_run("sp2")[0]
    ids = torch.from_numpy(_batch()[0]).long()

    def nsp_loss(nsp):
        return (nsp.float() ** 2).mean()

    one = _port_model(init)
    logits, nsp = one(ids)
    nsp_loss(nsp).backward()
    want = {n: p.grad for n, p in one.named_parameters()}
    n, half = 2, SEQ // 2

    def rank(group):
        model = _port_model(init).shard_sequence(group)
        before = coll.collective_counts()
        rows = slice(group.rank * half, (group.rank + 1) * half)
        lg, ns = model(ids[:, rows], pos_offset=group.rank * half)
        nsp_loss(ns).backward()
        after = coll.collective_counts()
        return (lg.detach(), ns.detach(),
                {k: p.grad for k, p in model.named_parameters()},
                {c: after[c] - before[c] for c in ("all-gather",
                                                   "reduce-scatter")})

    coll.reset_collective_counts()
    res = run_ranks(tmp_path, n, rank)
    for r, (lg, ns, _, _) in enumerate(res):
        torch.testing.assert_close(ns, nsp.detach(), atol=1e-6, rtol=0)
        torch.testing.assert_close(lg, logits.detach()[:, r * half:
                                                       (r + 1) * half],
                                   atol=1e-5, rtol=0)
    for name, w in want.items():
        if w is None:       # the MLM head's leaves: off the NSP loss
            assert all(r[2][name] is None for r in res), name
            continue
        got = sum(r[2][name] for r in res) / n
        torch.testing.assert_close(got, w, atol=1e-6, rtol=0, msg=name)
    L = CFG["num_layers"]
    counts = coll.collective_counts()
    assert (counts["all-gather"], counts["reduce-scatter"]) == (
        n * (L + 1), n * (L + 1))
