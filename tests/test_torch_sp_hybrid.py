"""Sequence parallelism beside the other axes of the hybrid step in the port
(parallel/spmd.py, distributed/mesh.py, parallel/sequence_attention.py,
parallel/ring_attention.py, the Megatron layers) against the JAX package's
GSPMD step, on the CPU.

The port's ranks are spawned gloo processes, one mesh a degree set, kept
for the module, collectives timing out after 60 s. The JAX side runs
`make_sharded_train_step(..., batch_specs=(P("dp", "sp"),) * 2)` over the
same degrees on the 8-fake-device CPU mesh (BERT's rows over dp and
sharding: ``P(("dp", "sharding"), "sp")``). Both start from the same numpy
weights (`weights.from_jax_state_dict`) and train float32 with SGD 0.1 for
3 steps on one seeded batch:

- GPT (``"flash"``: K/V gathered over sp, on the rank's heads and rows;
  ``"ring"``: the ring over the rank's heads) and BERT (its MLM mean
  weighed over dp and sp, its pooler's first token from sp rank 0) at
  ``sp2 x mp2`` and ``dp2 x sp2 x mp2``; BERT at ``sharding2 x sp2``
  (ZeRO stage 2) and ``dp2 x sharding2 x sp2`` (stage 1): the losses
  within 1e-5 relative and every gathered parameter within 2e-5, and each
  rank's calls a step equal `hybrid_collective_budget`;
- with AdamW (lr 1e-4) at ``sharding2 x sp2`` and ``dp2 x sharding2 x
  sp2`` each rank holds its sharding slice of the optimizer state, JAX's
  bytes a device; the losses, both moments (1e-5 of their norm) and the
  parameters (the key bias's float-noise gradient aside) are JAX's;
- the step's remat at ``sp2`` and ``sp2 x mp2`` (GPT, flash and ring)
  against the JAX remat step, with the budget's remat term; with dropout
  0.1 the remat step equals the port's own step without remat (the
  generators replay), and BERT's remat equals the port's one process
  (the JAX BERT's remat drops the mask: ROADMAP Queue 3);
- with dropout 0.1 at ``sp2 x mp2`` both models equal the port's one
  process at the same seed (the JAX package's PRNG cannot match);
- LocalSGD at ``dp2 x sp2`` (GPT, and BERT with its padding mask) gives
  the JAX LocalSGD step's numbers and the port's LocalSGD at ``dp2``'s
  (each replica's sequence split, the average over dp), with its calls;
- the train state crosses from the JAX layout onto an ``sp2 x mp2`` step;
- the budget's arithmetic, remat's term included, stands on its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.distributed.mesh import init_mesh as jax_init_mesh
from paddle_tpu.distributed.mesh import set_mesh as jax_set_mesh
from paddle_tpu.models.bert import Bert as JaxBert
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import bert_pretrain_loss_fn as jax_bert_loss
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss
from paddle_tpu.parallel import spmd as jspmd
from paddle_tpu_torch.distributed.mesh import build_mesh
from paddle_tpu_torch.models.bert import Bert, BertConfig
from paddle_tpu_torch.models.bert import bert_pretrain_loss_fn
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.parallel.spmd import (LocalSGDTrainStep,
                                            hybrid_collective_budget,
                                            make_sharded_train_step)
from paddle_tpu_torch.weights import (from_jax_state_dict,
                                      from_jax_train_state,
                                      to_jax_train_state)
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

STEPS, TIMEOUT, LR = 3, 60, 0.1
# 6j (c)'s rate on the card. At 1e-2 Adam's steps (each entry up to lr)
# magnify the rounding of a near-cancelling gradient past these gates:
# the JAX step itself then differs between one device and sharding2 x
# sp2 by more than 2e-5 on an entry of layer 1's key weights
ADAMW_LR = 1e-4
GPT_CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
               max_seq_len=64)
BERT_CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                intermediate_size=64, max_position_embeddings=64)
GPT_ROWS, GPT_SEQ, BERT_ROWS, BERT_SEQ = 4, 64, 4, 32
DEGREES = {"sp2": {"sp": 2}, "sp2mp2": {"sp": 2, "mp": 2},
           "dp2sp2mp2": {"dp": 2, "sp": 2, "mp": 2},
           "sh2sp2": {"sharding": 2, "sp": 2},
           "dp2sh2sp2": {"dp": 2, "sharding": 2, "sp": 2},
           "dp2sp2": {"dp": 2, "sp": 2}, "dp2": {"dp": 2}}
# BERT's ZeRO stage a mesh with a sharding axis runs
STAGE = {"sh2sp2": 2, "dp2sh2sp2": 1}
KEYS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "send",
        "recv")


@pytest.fixture(scope="module")
def meshes():
    """The module's port meshes (ranks spawned by the first step over
    each, kept for every step of the module)."""
    ms = {k: build_mesh(d, device="cpu", timeout=TIMEOUT)
          for k, d in DEGREES.items()}
    yield ms
    for m in ms.values():
        m.close()


def teardown_module():
    jax_set_mesh(None)


def _rows(key):
    """The axes a batch's rows split over on mesh `key`."""
    return ("dp", "sharding") if "sharding" in DEGREES[key] else "dp"


def _specs(kind, key, masked=False):
    """The port's batch specs: every array's sequence over sp but a
    padding mask's, which stays whole."""
    seq = (_rows(key), "sp")
    if kind == "gpt":
        return (seq,) * 2
    if masked:
        return (seq, seq, _rows(key), seq)
    return (seq,) * 2


def _gpt_batch():
    rs = np.random.RandomState(0)
    shape = (GPT_ROWS, GPT_SEQ)
    return (rs.randint(0, GPT_CFG["vocab_size"], shape, dtype=np.int32),
            rs.randint(0, GPT_CFG["vocab_size"], shape, dtype=np.int32))


def _bert_batch():
    """ids and MLM labels (15 % of positions; -100 elsewhere)."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, BERT_CFG["vocab_size"], (BERT_ROWS, BERT_SEQ))
    labels = np.where(rs.rand(BERT_ROWS, BERT_SEQ) < 0.15, ids, -100)
    return ids.astype(np.int32), labels.astype(np.int32)


def _masked_batch():
    """ids, token types, the additive padding mask [B, 1, 1, S] (real
    lengths S/2..S) and MLM labels on real positions."""
    rs = np.random.RandomState(1)
    S = BERT_SEQ
    lens = rs.randint(S // 2, S + 1, BERT_ROWS)
    real = np.arange(S)[None] < lens[:, None]
    ids = np.where(real, rs.randint(0, BERT_CFG["vocab_size"],
                                    (BERT_ROWS, S)), 0)
    types = real & (np.arange(S)[None] >= (lens // 2)[:, None])
    labels = np.where(real & (rs.rand(BERT_ROWS, S) < 0.15), ids, -100)
    mask = np.where(real, 0.0, -1e4).astype(np.float32)[:, None, None, :]
    return (ids.astype(np.int32), types.astype(np.int32), mask,
            labels.astype(np.int32))


def _batch(kind, masked=False):
    if kind == "gpt":
        return _gpt_batch()
    return _masked_batch() if masked else _bert_batch()


# -- the JAX side --------------------------------------------------------------

_JAX = {}


def _jax_model(kind, attn_impl):
    if kind == "gpt":
        return JaxGPT(JaxGPTConfig(**GPT_CFG, attn_impl=attn_impl)), \
            jax_gpt_loss
    return JaxBert(JaxBertConfig(**BERT_CFG, dropout=0.0)), jax_bert_loss


def _jax_run(kind, key, attn_impl="flash", remat=False, localsgd=0,
             adamw=False, masked=False):
    """The JAX step over DEGREES[key] from paddle.seed(0): the GSPMD step
    (with `remat`; with `adamw`, AdamW at `ADAMW_LR` in place of SGD), or
    with `localsgd` k the LocalSGD step, 4 steps (BERT's batch with its
    padding mask and token types if `masked`). Returns (initial numpy
    weights, losses, natural numpy params, the GSPMD step's optimizer
    state: its bytes a device and its natural numpy slots)."""
    cache = (kind, key, attn_impl, remat, localsgd, adamw, masked)
    if cache not in _JAX:
        jmesh = jax_init_mesh(DEGREES[key])
        paddle.seed(0)
        model, loss_fn = _jax_model(kind, attn_impl)
        init = {k: np.asarray(v)
                for k, v in state_dict_arrays(model)[0].items()}
        opt = (paddle.optimizer.AdamW(learning_rate=ADAMW_LR,
                                      parameters=model.parameters())
               if adamw else
               paddle.optimizer.SGD(learning_rate=LR,
                                    parameters=model.parameters()))
        P = jax.sharding.PartitionSpec
        rows = _rows(key)
        # the padding mask's rows alone, every other array's sequence too
        specs = tuple(P(rows) if s == rows else P(rows, "sp")
                      for s in _specs(kind, key, masked))
        key0 = jax.random.PRNGKey(0)
        losses = []
        if localsgd:
            step = jspmd.LocalSGDTrainStep(model, loss_fn, opt, jmesh,
                                           k_steps=localsgd,
                                           batch_specs=specs)
            params, buffers, opt_state, count = step.init_state()
            # the rows of each replica over sp, as its jit's batch
            # shardings name them
            b = tuple(jax.device_put(a, jax.sharding.NamedSharding(
                jmesh, s)) for a, s in zip(
                    step.shard_batch(*_batch(kind, masked)), specs))
            for _ in range(4):
                loss, params, buffers, opt_state, count = step(
                    params, buffers, opt_state, count, jnp.float32(LR),
                    key0, *b)
                losses.append(float(np.asarray(loss)))
            params = {k: np.asarray(v) for k, v in params.items()}
        else:
            step = jspmd.make_sharded_train_step(
                model, loss_fn, opt, jmesh, batch_specs=specs,
                zero_stage=STAGE.get(key, 0), remat=remat)
            params, buffers, opt_state = step.init_state()
            b = step.shard_batch(*_batch(kind))
            lr = ADAMW_LR if adamw else LR
            for _ in range(STEPS):
                loss, params, buffers, opt_state = step(
                    params, buffers, opt_state, jnp.float32(lr), key0, *b)
                losses.append(float(np.asarray(loss)))
            params = {k: np.asarray(v) for k, v in params.items()}
            opt = (jspmd.per_chip_opt_state_bytes(opt_state),
                   {k: {s: np.asarray(a) for s, a in v.items()}
                    for k, v in opt_state.items()})
        jax_set_mesh(None)
        _JAX[cache] = (init, losses, params, None if localsgd else opt)
    return _JAX[cache]


# -- the port's side -----------------------------------------------------------


def _port_model(kind, init, attn_impl="flash", dropout=0.0):
    if kind == "gpt":
        model = GPT(GPTConfig(**GPT_CFG, dropout=dropout,
                              attn_impl=attn_impl), device="cpu")
    else:
        model = Bert(BertConfig(**BERT_CFG, dropout=dropout), device="cpu")
    return from_jax_state_dict(model, init)


def _loss(kind):
    return gpt_loss_fn if kind == "gpt" else bert_pretrain_loss_fn


def _port_step(kind, mesh, key, init, attn_impl="flash", dropout=0.0,
               remat=False, masked=False, adamw=False):
    model = _port_model(kind, init, attn_impl, dropout)
    opt = (AdamW(learning_rate=ADAMW_LR, parameters=model.named_parameters())
           if adamw else
           SGD(learning_rate=LR, parameters=model.named_parameters()))
    specs = None if key is None else _specs(kind, key, masked)
    return make_sharded_train_step(model, _loss(kind), opt, mesh,
                                   batch_specs=specs,
                                   zero_stage=STAGE.get(key, 0),
                                   remat=remat)


def _one_process(kind, init, batch, seed, attn_impl="flash", dropout=0.1,
                 steps=2):
    """The same run in this process with no mesh: (losses, params)."""
    step = _port_step(kind, build_mesh({"dp": 1}, device="cpu"), None, init,
                      attn_impl, dropout)
    try:
        return ([step(*batch, seed=seed) for _ in range(steps)],
                step.gather_params())
    finally:
        step.close()


def _budget(kind, key, n_leaves, attn_impl="flash", remat=False,
            n_zero_leaves=0):
    """`hybrid_collective_budget` of one step of `kind` over DEGREES[key].
    The mp layers' calls (at mp above 1), forward and backward: GPT's
    vocab-parallel embedding 1 all-reduce, proj and fc2 2 a layer and the
    vocab-parallel loss 3 forward, its column-parallel inputs 2 a layer
    and the head's hidden state 1 backward; BERT's embedding 1 and 2 a
    layer forward with the MLM logits gathered (1 all-gather), 2 a layer
    and the MLM head's input 1 backward."""
    deg = DEGREES[key]
    L = GPT_CFG["num_layers"] if kind == "gpt" else BERT_CFG["num_layers"]
    bert = kind == "bert"
    ring = attn_impl == "ring" and not bert
    fwd = (1 + 2 * L + (0 if bert else 3), int(bert))
    calls = (fwd[0] + 2 * L + 1, fwd[1])
    return hybrid_collective_budget(
        n_leaves, (deg.get("dp", 1), deg.get("sharding", 1)),
        sp_degree=deg.get("sp", 1), ring_layers=L if ring else 0,
        gathered_layers=0 if ring else L, first_token=bert,
        weighted_loss=bert, mp_degree=deg.get("mp", 1), mp_calls=calls,
        mp_forward=fwd, remat=remat, n_zero_leaves=n_zero_leaves)


def _zero_leaves(step):
    """The leaves whose update the sharding axis slices (stages 1, 2)."""
    return sum(zs is not None for _, _, zs in step._place.layouts.values())


def _run(step, batch, steps=STEPS):
    """`steps` steps: (losses, each rank's calls, gathered JAX-layout
    params)."""
    step.rank_reports(zero=True)
    got = [step(*batch) for _ in range(steps)]
    counts = step.collective_counts()
    params, _, _ = to_jax_train_state(step)
    return got, counts, params


def _assert_matches(got, params, want, jparams):
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert set(params) == set(jparams)
    for k, w in jparams.items():
        np.testing.assert_allclose(params[k], w, atol=2e-5, rtol=0,
                                   err_msg=k)


def _assert_budget(counts, budget, steps=STEPS):
    for c in counts:
        assert {k: c[k] for k in KEYS} == {k: steps * budget[k]
                                           for k in KEYS}, (c, budget)


# -- parity with the JAX package -----------------------------------------------


@pytest.mark.parametrize("key", ["sp2mp2", "dp2sp2mp2"])
@pytest.mark.parametrize("attn_impl", ["flash", "ring"])
def test_gpt_sp_beside_mp_matches_jax(meshes, attn_impl, key):
    """GPT over sp x mp (and dp): each rank's attention on its heads over
    its sp group, its loss through the vocab-parallel head on its slice;
    the JAX step's losses and parameters, and the budget on every
    rank."""
    init, want, jparams, _ = _jax_run("gpt", key, attn_impl)
    step = _port_step("gpt", meshes[key], key, init, attn_impl)
    try:
        got, counts, params = _run(step, _gpt_batch())
    finally:
        step.close()
    _assert_matches(got, params, want, jparams)
    assert len(counts) == meshes[key].size
    _assert_budget(counts, _budget("gpt", key, len(step.names), attn_impl))


@pytest.mark.parametrize("key", ["sp2mp2", "dp2sp2mp2", "sh2sp2",
                                 "dp2sh2sp2"])
def test_bert_sp_beside_mp_and_sharding_matches_jax(meshes, key):
    """BERT over sp x mp (and dp), and over sharding x sp at ZeRO stage 2
    (and dp x sharding x sp at stage 1, the rows over dp and sharding):
    the JAX step's losses and parameters, and the budget on every rank
    (at a sharding axis, one all-gather a leaf whose update it slices)."""
    init, want, jparams, _ = _jax_run("bert", key)
    step = _port_step("bert", meshes[key], key, init)
    try:
        got, counts, params = _run(step, _bert_batch())
        zl = _zero_leaves(step)
    finally:
        step.close()
    _assert_matches(got, params, want, jparams)
    assert (zl > 0) == ("sharding" in DEGREES[key])
    _assert_budget(counts, _budget("bert", key, len(step.names),
                                   n_zero_leaves=zl))


@pytest.mark.parametrize("key", ["sh2sp2", "dp2sh2sp2"])
def test_adamw_state_is_sliced_over_sharding_beside_sp(meshes, key):
    """BERT with AdamW (the JAX rule) at sharding x sp: each rank's
    optimizer state is its sharding slice, the bytes of JAX's per-device
    state over the same mesh (below one process's); the losses are the
    JAX step's within 1e-5 relative, both gathered moments within 1e-5 of
    their norm, and every parameter within 2e-5 but the entries whose
    gradient is float noise. Those are set apart by JAX's first moment
    (nonzero, below 1e-6 of its leaf's largest): exactly the key bias,
    the middle third of each fused QKV bias, whose gradient is zero in
    exact arithmetic (a query's scores all move by its q . b_k, which the
    softmax drops), and Adam divides a gradient by its own size. The
    port's first moment there is float noise too."""
    init, want, jparams, (jbytes, jopt) = _jax_run("bert", key, adamw=True)
    step = _port_step("bert", meshes[key], key, init, adamw=True)
    try:
        got = [step(*_bert_batch()) for _ in range(STEPS)]
        params, opt, _ = to_jax_train_state(step)
        per_rank = step.per_chip_opt_state_bytes()
        whole = step.unsharded_opt_state_bytes()
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert per_rank == [jbytes] * meshes[key].size, (per_rank, jbytes)
    assert jbytes < whole
    H = BERT_CFG["hidden_size"]
    for k, w in jparams.items():
        for slot in ("moment1", "moment2"):
            a, b = opt[k][slot], jopt[k][slot]
            assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), (k, slot)
        m1 = np.abs(jopt[k]["moment1"])
        noise = (m1 > 0) & (m1 < 1e-6 * m1.max())
        kbias = np.zeros(w.shape, bool)
        if k.endswith("attn.qkv.bias"):
            kbias[H:2 * H] = True
        np.testing.assert_array_equal(noise, kbias, err_msg=k)
        port_m1 = np.abs(opt[k]["moment1"])
        assert (port_m1[noise] < 1e-6 * port_m1.max()).all(), k
        np.testing.assert_allclose(params[k][~noise], w[~noise], atol=2e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("key", ["sp2", "sp2mp2"])
@pytest.mark.parametrize("attn_impl", ["flash", "ring"])
def test_remat_under_sp_matches_jax(meshes, attn_impl, key):
    """The step's remat under sp (and sp x mp): the JAX remat step's
    losses and parameters; the recomputed forward makes its gathers (or
    ring hops) and mp all-reduces again, as the budget's remat term
    says."""
    init, want, jparams, _ = _jax_run("gpt", key, attn_impl, remat=True)
    step = _port_step("gpt", meshes[key], key, init, attn_impl, remat=True)
    try:
        got, counts, params = _run(step, _gpt_batch())
    finally:
        step.close()
    _assert_matches(got, params, want, jparams)
    _assert_budget(counts, _budget("gpt", key, len(step.names), attn_impl,
                                   remat=True))


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_localsgd_under_sp_matches_jax_and_dp(meshes, kind):
    """LocalSGD (k 2, 4 steps) at dp2 x sp2: each replica's step split
    over its sp group, the parameters averaged over dp every second step;
    BERT with its padding mask (whole on the sp ranks), token types and
    MLM labels, each replica's MLM mean weighed over its own sequence
    slices. The JAX LocalSGD step splits no sequence, so its numbers and
    the port's LocalSGD at dp2 are the ones to give. Each rank's calls:
    the sp group's hybrid budget a step, one all-reduce of the loss over
    dp a step, and one a leaf over dp every second step."""
    masked = kind == "bert"
    init, want, jparams, _ = _jax_run(kind, "dp2sp2", localsgd=2,
                                      masked=masked)
    batch = _batch(kind, masked)
    out = {}
    for key in ("dp2sp2", "dp2"):
        model = _port_model(kind, init)
        opt = SGD(learning_rate=LR, parameters=model.named_parameters())
        step = LocalSGDTrainStep(
            model, _loss(kind), opt, meshes[key], k_steps=2,
            batch_specs=_specs(kind, key, masked) if "sp" in key else None)
        try:
            step.rank_reports(zero=True)
            losses = [step(*batch) for _ in range(4)]
            out[key] = (losses, to_jax_train_state(step)[0],
                        step.collective_counts(), len(step.names))
        finally:
            step.close()
    got, params, counts, n = out["dp2sp2"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, out["dp2"][0], rtol=1e-5)
    for k, w in jparams.items():
        # the fourth step averaged the replicas: they agree again
        np.testing.assert_allclose(params[k], w[0], atol=2e-5, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(params[k], out["dp2"][1][k], atol=2e-5,
                                   rtol=0, err_msg=k)
    L = GPT_CFG["num_layers"] if kind == "gpt" else BERT_CFG["num_layers"]
    sp = hybrid_collective_budget(
        n, (), sp_degree=2, gathered_layers=L, first_token=masked,
        weighted_loss=masked)
    dp = {k: 0 for k in KEYS}
    dp["all-reduce"] = 4 + 2 * n
    assert len(counts) == 4
    for want_calls, cs in ((4 * sp["all-reduce"] + dp["all-reduce"], counts),
                           (dp["all-reduce"], out["dp2"][2])):
        for c in cs:
            assert c["all-reduce"] == want_calls, (c, sp)
    for c in counts:
        assert {k: c[k] for k in KEYS if k != "all-reduce"} == {
            k: 4 * sp[k] for k in KEYS if k != "all-reduce"}, (c, sp)


def test_train_state_crosses_the_jax_layout_on_an_sp_mp_step(meshes):
    """The state of 2 steps at sp2 x mp2 taken to the JAX layout
    (`to_jax_train_state`) and loaded onto a new step over the same mesh
    (`from_jax_train_state`: each rank takes its mp slice) takes the JAX
    run's third step."""
    init, want, _, _ = _jax_run("gpt", "sp2mp2")
    step = _port_step("gpt", meshes["sp2mp2"], "sp2mp2", init)
    try:
        first = [step(*_gpt_batch()) for _ in range(2)]
        jparams, jopt, _ = to_jax_train_state(step)
        fresh = _port_step("gpt", meshes["sp2mp2"], "sp2mp2", init)
        try:
            from_jax_train_state(fresh, jparams, jopt)
            got = fresh(*_gpt_batch())
        finally:
            fresh.close()
    finally:
        step.close()
    np.testing.assert_allclose(first + [got], want, rtol=1e-5)


# -- the port's own bars -------------------------------------------------------


@pytest.mark.parametrize("kind", ["gpt", "bert"])
def test_dropout_at_sp2_mp2_equals_one_process(meshes, kind):
    """Dropout 0.1 at sp2 x mp2 (GPT flash; BERT with its padding mask and
    token types): one process's losses and parameters at the same seed.
    The mp peers of a sequence slice draw one elementwise mask, the slice
    of the whole row's; attention's keep bits are drawn at the rank's
    heads and rows."""
    init = _jax_run(kind, "sp2mp2")[0]
    batch = _gpt_batch() if kind == "gpt" else _masked_batch()
    want, wparams = _one_process(kind, init, batch, seed=7)
    step = _port_step(kind, meshes["sp2mp2"], "sp2mp2", init, dropout=0.1,
                      masked=True)
    try:
        got = [step(*batch, seed=7) for _ in range(2)]
        params = step.gather_params()
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    no_drop = _one_process(kind, init, batch, seed=7, dropout=0.0, steps=1)
    assert got[0] != no_drop[0][0]          # the masks dropped something
    for k, w in wparams.items():
        np.testing.assert_allclose(params[k].numpy(), w.numpy(), atol=2e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("kind,key", [("gpt", "sp2mp2"), ("bert", "sp2"),
                                      ("bert", "sp2mp2")])
def test_remat_under_sp_with_dropout_replays(meshes, kind, key):
    """Remat at dropout 0.1: the recomputed forward draws the masks it drew
    (attention's seed and the elementwise masks replay bit-equal), so the
    remat step gives the port's one process's losses and parameters. For
    BERT (its padding mask kept) the port's one process is the bar: the
    JAX BERT's remat drops the mask."""
    init = _jax_run(kind, "sp2mp2")[0]
    batch = _gpt_batch() if kind == "gpt" else _masked_batch()
    want, wparams = _one_process(kind, init, batch, seed=3)
    step = _port_step(kind, meshes[key], key, init, dropout=0.1, remat=True,
                      masked=True)
    try:
        got = [step(*batch, seed=3) for _ in range(2)]
        params = step.gather_params()
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k, w in wparams.items():
        np.testing.assert_allclose(params[k].numpy(), w.numpy(), atol=2e-5,
                                   rtol=0, err_msg=k)


# -- the arithmetic ------------------------------------------------------------


@pytest.mark.parametrize("sp,mp,dp,ring,remat", [
    (2, 2, 1, False, False), (2, 2, 2, True, False), (2, 2, 1, True, True),
    (2, 1, 1, False, True), (4, 2, 2, True, True), (1, 2, 1, False, True)])
def test_hybrid_budget_with_remat_arithmetic(sp, mp, dp, ring, remat):
    """At L layers over sp x mp (x dp): the data groups' all-reduces (the
    loss and a leaf each); each ring layer's sp - 1 hops forward and sp
    backward, each gathered layer's all-gather and reduce-scatter; the mp
    calls as given. Remat adds the forward's share once more: the mp
    forward calls, the ring's forward hops, the gathers."""
    L, leaves, calls, fwd = 3, 40, (17, 1), (9, 1)
    b = hybrid_collective_budget(
        leaves, (dp,), sp_degree=sp, ring_layers=L if ring else 0,
        gathered_layers=0 if ring else L, mp_degree=mp, mp_calls=calls,
        mp_forward=fwd, remat=remat)
    again = int(remat)
    groups = (dp > 1) + (sp > 1)
    hops = L * ((1 + again) * (sp - 1) + sp) if ring and sp > 1 else 0
    gathers = L if not ring and sp > 1 else 0
    mp_ar, mp_ag = ((calls[0] + again * fwd[0], calls[1] + again * fwd[1])
                    if mp > 1 else (0, 0))
    assert b == {"all-reduce": groups * (1 + leaves) + mp_ar,
                 "all-gather": (1 + again) * gathers + mp_ag,
                 "reduce-scatter": gathers, "all-to-all": 0,
                 "send": hops, "recv": hops}
