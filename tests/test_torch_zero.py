"""Data-parallel training in the port (parallel/spmd.py,
distributed/mesh.py, the Group Sharded markers) against the JAX package's
explicit ZeRO step, on the CPU.

The port's ranks are spawned gloo processes (one mesh of dp=2 for the
module, every step built over it, collectives timing out after 60 s); the
JAX side runs on the 8-fake-device CPU mesh. Both start from the same
numpy weights (carried with `weights.from_jax_state_dict`) and train on
the batch of `tests/test_zero_explicit.py` (8 rows of 16 tokens, 4 rows a
rank) with AdamW(0.01) on `tiny_gpt_config()` widths:

- at dp=2 every sum has two terms, so ZeRO stages 2 and 3 (gradient merge
  1/2, remat off/on) give the port's stage-0 losses bit for bit, and the
  JAX explicit step's losses within rtol 1e-5 over 4 steps;
- int8 gradients pass JAX's own gates (drift under 0.02 from the float32
  trajectory, the loss falling by more than 0.5) and stay within 0.02 of
  the JAX int8 trajectory; `quantized_psum_scatter` is bit-equal to JAX's
  at dp=2 and within one float32 ulp at dp=4;
- a step's collective calls on every rank equal `train_collective_budget`,
  and a reduce-scatter patched into an all-reduce (same numbers) breaks
  it: the counterpart of the JAX package's IR001 trip test;
- the optimizer state a rank holds, stage-3 `gather_params`, resuming from
  a dp=1 state and from the JAX step's state, the guards, LocalSGD, ERNIE
  with a padding mask (and with dropout), the Group Sharded API and a
  rank that fails.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as paddle
from paddle_tpu.analysis.ir import tiny_gpt_config
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.distributed.mesh import init_mesh as jax_init_mesh
from paddle_tpu.distributed.mesh import set_mesh as jax_set_mesh
from paddle_tpu.models.bert import Bert as JaxBert
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import bert_pretrain_loss_fn as jax_bert_loss
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss
from paddle_tpu.parallel import collectives as jcoll
from paddle_tpu.parallel import spmd as jspmd
from paddle_tpu.parallel._compat import shard_map
from paddle_tpu_torch.distributed import group_sharded_parallel
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    GroupShardedOptimizerStage2, GroupShardedStage2, GroupShardedStage3,
    save_group_sharded_model, shard_parameters_over)
from paddle_tpu_torch.distributed.mesh import DeviceMesh, build_mesh
from paddle_tpu_torch.distributed.ranks import RankFailed
from paddle_tpu_torch.models.bert import Bert, BertConfig
from paddle_tpu_torch.models.bert import bert_pretrain_loss_fn
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.layer import meta_copy
from paddle_tpu_torch.optimizer import SGD, AdamW, Momentum
from paddle_tpu_torch.parallel import collectives as coll
from paddle_tpu_torch.parallel import spmd
from paddle_tpu_torch.parallel.spmd import (LocalSGDTrainStep,
                                            make_sharded_train_step,
                                            train_collective_budget)
from paddle_tpu_torch.weights import (from_jax_state_dict,
                                      from_jax_train_state,
                                      to_jax_train_state)
from test_torch_collectives import run_ranks, shared_cores  # noqa: F401

DP, STEPS, TIMEOUT, LR = 2, 4, 60, 0.01
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)
KEYS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


@pytest.fixture(scope="module")
def mesh():
    """The module's port mesh: two gloo ranks (spawned by the first step),
    kept for every step of the module."""
    m = build_mesh({"dp": DP}, device="cpu", timeout=TIMEOUT)
    yield m
    m.close()


def teardown_module():
    jax_set_mesh(None)


def _batch():
    rs = np.random.RandomState(0)
    return (rs.randint(0, 64, (8, 16), dtype=np.int32),
            rs.randint(0, 64, (8, 16), dtype=np.int32))


# -- the JAX side --------------------------------------------------------------

_JAX = {}


def _jax_run(zs, gm=1, remat=False, quant=False, steps=STEPS):
    """The JAX explicit (or stage-0) step over dp=2: (losses, step, params,
    opt_state), cached."""
    key = (zs, gm, remat, quant, steps)
    if key not in _JAX:
        jmesh = jax_init_mesh({"dp": DP})
        paddle.seed(0)
        model = JaxGPT(tiny_gpt_config())
        opt = paddle.optimizer.AdamW(learning_rate=LR,
                                     parameters=model.parameters())
        step = jspmd.make_sharded_train_step(
            model, jax_gpt_loss, opt, jmesh, zero_stage=zs,
            gradient_merge_k=gm, remat=remat, quant_grads=quant)
        params, buffers, opt_state = step.init_state()
        batch = step.shard_batch(*_batch())
        k = jax.random.PRNGKey(0)
        losses = []
        for _ in range(steps):
            loss, params, buffers, opt_state = step(
                params, buffers, opt_state, jnp.float32(LR), k, *batch)
            losses.append(float(np.asarray(loss)))
        _JAX[key] = (losses, step, params, opt_state)
    return _JAX[key]


_INIT = []


def _init():
    """The JAX tiny GPT's initial weights (paddle.seed(0)), numpy."""
    if not _INIT:
        paddle.seed(0)
        jm = JaxGPT(tiny_gpt_config())
        _INIT.append({k: np.asarray(v)
                      for k, v in state_dict_arrays(jm)[0].items()})
    return _INIT[0]


# -- the port side -------------------------------------------------------------


def _model():
    return from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"), _init())


def _port_step(mesh, zs, gm=1, remat=False, quant=False, opt_cls=AdamW,
               **kw):
    model = _model()
    opt = opt_cls(learning_rate=LR, parameters=model.named_parameters(),
                  **kw)
    return make_sharded_train_step(model, gpt_loss_fn, opt, mesh,
                                   zero_stage=zs, gradient_merge_k=gm,
                                   remat=remat, quant_grads=quant)


def _port_run(mesh, zs, gm=1, remat=False, quant=False, steps=STEPS,
              keep=False):
    step = _port_step(mesh, zs, gm, remat, quant)
    ids, labels = _batch()
    losses = [step(ids, labels) for _ in range(steps)]
    if not keep:
        step.close()
    return losses, step


_REFS = {}


def _reference(mesh, gm, remat):
    """The port's stage-0 trajectory of one (gm, remat) cell, shared."""
    if (gm, remat) not in _REFS:
        _REFS[(gm, remat)] = _port_run(mesh, 0, gm, remat)[0]
    return _REFS[(gm, remat)]


# -- collectives ---------------------------------------------------------------


@pytest.mark.parametrize("dp", [2, 4])
def test_quantized_psum_scatter_matches_jax(tmp_path, dp):
    """The int8 reduce-scatter: each rank's chunk equals the JAX function's
    in a shard_map, bit for bit at dp=2 (a sum of two terms has one order)
    and within one float32 ulp at dp=4; two all-to-alls a call."""
    rs = np.random.RandomState(dp)
    x = (rs.standard_normal((dp, dp * 24)) * 3).astype(np.float32)
    x[1, :5] *= 50.0                     # an outlier chunk on rank 1
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:dp]), ("dp",))
    fn = shard_map(lambda v: jcoll.quantized_psum_scatter(v[0], "dp", dp),
                   mesh=jmesh, in_specs=jax.sharding.PartitionSpec("dp"),
                   out_specs=jax.sharding.PartitionSpec("dp"))
    want = np.asarray(fn(jnp.asarray(x))).reshape(dp, -1)
    coll.reset_collective_counts()
    got = run_ranks(tmp_path, dp, lambda g: coll.quantized_psum_scatter(
        torch.from_numpy(x[g.rank]), g).numpy())
    assert coll.collective_counts()["all-to-all"] == 2 * dp
    for r in range(dp):
        if dp == 2:
            np.testing.assert_array_equal(got[r], want[r])
        else:
            np.testing.assert_array_max_ulp(got[r], want[r], maxulp=1)


def test_reduce_scatter_and_all_to_all_count_one_call(tmp_path):
    """The plain reduce-scatter sums in rank order and hands each rank its
    chunk; all-to-all trades rows; each adds one to its counter a rank."""
    coll.reset_collective_counts()

    def rank(g):
        rsum = coll.reduce_scatter(torch.arange(6.0) * (g.rank + 1), g)
        rows = coll.all_to_all(torch.tensor([[g.rank, 0], [g.rank, 1]],
                                            dtype=torch.int8), g)
        return rsum.tolist(), rows.tolist()

    got = run_ranks(tmp_path, 2, rank)
    assert got[0] == ([0.0, 3.0, 6.0], [[0, 0], [1, 0]])
    assert got[1] == ([9.0, 12.0, 15.0], [[0, 1], [1, 1]])
    assert coll.collective_counts() == {"all-reduce": 0, "all-gather": 0,
                                        "reduce-scatter": 2, "all-to-all": 2,
                                        "send": 0, "recv": 0}


@pytest.mark.parametrize("n,dp,quant,nbuf", [
    (28, 2, False, 0), (28, 2, True, 0), (148, 2, False, 0),
    (157, 4, True, 3), (5, 1, False, 0), (1, 8, False, 2)])
def test_train_collective_budget_equals_jax(n, dp, quant, nbuf):
    assert train_collective_budget(n, dp, quant, nbuf) == \
        jspmd.train_collective_budget(n, dp, quant, nbuf)


# -- the stages ----------------------------------------------------------------


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("gm", [1, 2])
@pytest.mark.parametrize("zs", [2, 3])
def test_stages_equal_stage0_bit_for_bit_and_jax(mesh, zs, gm, remat):
    """ZeRO 2/3 on the explicit path replay the port's stage-0 (all-reduce)
    losses bit for bit, and the JAX explicit step's within rtol 1e-5."""
    ref = _reference(mesh, gm, remat)
    got, step = _port_run(mesh, zs, gm, remat)
    assert step.explicit_update and step.zero_stage == zs
    assert got == ref, (zs, gm, remat, got, ref)
    want = _jax_run(zs, gm, remat)[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_int8_gradients_pass_the_jax_gates(mesh):
    """int8 gradients (two all-to-alls a leaf): within 0.02 of the port's
    float32 trajectory, the loss falling by more than 0.5 (JAX's own
    gates), and within 0.02 of the JAX int8 trajectory."""
    ref = _reference(mesh, 1, False)
    got, step = _port_run(mesh, 2, quant=True)
    assert step.quant_grads
    drift = max(abs(a - b) for a, b in zip(got, ref))
    assert drift < 0.02, (drift, got, ref)
    assert got[-1] < got[0] - 0.5, got
    jq = _jax_run(2, quant=True)[0]
    assert max(abs(a - b) for a, b in zip(got, jq)) < 0.02, (got, jq)


def test_o2_masters_and_decay_by_name_on_the_shards(mesh):
    """AMP O2 (bf16 parameters, float32 masters seeded by `amp.decorate`)
    with `apply_decay_param_fun`: the shard-local update keeps the rule, so
    stages 2 and 3 give stage 0's bf16 losses bit for bit, and the state
    comes back under a one-process optimizer's keys, masters float32."""
    from paddle_tpu_torch import amp

    ids, labels = _batch()
    decays = lambda n: "ln" not in n  # noqa: E731

    def build():
        model = _model()
        opt = AdamW(learning_rate=LR, parameters=model.named_parameters(),
                    apply_decay_param_fun=decays)
        return amp.decorate(model, opt, level="O2")

    got = {}
    for zs in (0, 2, 3):
        model, opt = build()
        step = make_sharded_train_step(model, gpt_loss_fn, opt, mesh,
                                       zero_stage=zs)
        try:
            got[zs] = [step(ids, labels) for _ in range(2)]
            sd = step.state_dict()
        finally:
            step.close()
    assert got[2] == got[0] and got[3] == got[0], got
    model, opt = build()
    # the settings a rank rebuilds its optimizer from pickle, decay by name
    # included
    import pickle

    from paddle_tpu_torch.optimizer.optimizer import from_settings

    named = list(model.named_parameters())
    rebuilt = from_settings(pickle.loads(pickle.dumps(opt.settings())), named)
    assert [rebuilt._decays(p) for _, p in named] == \
        [decays(n) for n, _ in named]
    assert type(rebuilt) is AdamW and rebuilt._multi_precision
    model.train()
    gpt_loss_fn(model(torch.as_tensor(ids)), torch.as_tensor(labels)).backward()
    opt.step()
    want = opt.state_dict()
    assert set(sd["optimizer"]) - {"@param_order"} == \
        set(want) - {"@param_order"}
    masters = [k for k in sd["optimizer"] if k.endswith("_master_weight")]
    assert len(masters) == len(sd["params"])
    for k in masters:
        assert sd["optimizer"][k].dtype == torch.float32, k
    assert all(t.dtype == torch.bfloat16 for t in sd["params"].values())


# -- the budget ----------------------------------------------------------------


@pytest.mark.parametrize("zs,quant", [(2, False), (3, False), (2, True)])
def test_step_counts_equal_the_budget_on_every_rank(mesh, zs, quant):
    step = _port_step(mesh, zs, quant=quant)
    try:
        step.rank_reports(zero=True)
        ids, labels = _batch()
        for _ in range(2):
            step(ids, labels)
        budget = train_collective_budget(len(step.names), DP, quant)
        counts = step.collective_counts()
        phases = [r["phases_ms"] for r in step.last_step]
    finally:
        step.close()
    assert len(counts) == DP
    for c in counts:
        # the budget's four collectives, and no point-to-point call
        assert c == {**{k: 2 * budget[k] for k in KEYS}, "send": 0,
                     "recv": 0}, (c, budget)
    for ph in phases:      # each rank's step, phase by phase
        assert set(ph) == {"gather", "forward_backward", "loss_reduce",
                           "grad_reduce", "update", "param_gather"}, ph
        assert all(v >= 0 for v in ph.values()), ph


def test_a_lost_reduce_scatter_breaks_the_budget(tmp_path, monkeypatch):
    """Two ranks of the explicit stage-2 step, one a thread: their calls
    together equal twice the budget. With the reduce-scatter patched into a
    full all-reduce and a local slice (the same numbers, the wrong
    collective) the losses stay the same and the counts break the budget
    on both sides: a surplus all-reduce and a missing reduce-scatter."""
    model = _model()
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
    base = DeviceMesh({"dp": DP}, ["cpu"] * DP, timeout=TIMEOUT)
    spec = spmd.job_spec("sharded", model, gpt_loss_fn, opt, base,
                         stage3=False, explicit=True, quant=False, gm_k=1,
                         gm_avg=True, remat=False, k_steps=1)
    ids, labels = _batch()
    rows = [(ids[r * 4:(r + 1) * 4], labels[r * 4:(r + 1) * 4])
            for r in range(DP)]

    def run():
        coll.reset_collective_counts()

        def rank(g):
            m = base.for_rank(g.rank)
            m.group = g
            rep = spmd._Replica(dict(spec, skeleton=meta_copy(model)), m)
            rep.load({("p", n): p.detach()
                      for n, p in model.named_parameters()}, {})
            return rep.step(np.float32(LR), 0, rows[g.rank])[0]

        losses = run_ranks(tmp_path, DP, rank)
        return losses, coll.collective_counts()

    budget = train_collective_budget(len(spec["names"]), DP)
    losses, counts = run()
    assert counts == {**{k: DP * budget[k] for k in KEYS}, "send": 0,
                      "recv": 0}

    def all_reduce_then_slice(flat, group):
        full = flat.clone()
        coll.all_reduce(full, group)
        n = flat.numel() // group.size
        return full[group.rank * n:(group.rank + 1) * n]

    monkeypatch.setattr(spmd, "reduce_scatter", all_reduce_then_slice)
    lost, counts = run()
    assert lost == losses
    assert counts["reduce-scatter"] == 0 != budget["reduce-scatter"]
    assert counts["all-reduce"] > DP * budget["all-reduce"]


# -- layout and state ----------------------------------------------------------


def test_optimizer_state_on_each_rank_is_one_dp_th(mesh):
    """Each rank holds 1/dp of every parameter-shaped slot (the flat leaf
    padded to a dp multiple) and the replicated beta powers: the bytes JAX
    counts for its placed stage-2 state; stage 0 holds it all, as JAX's
    stage 0 does, which is also what `unsharded_opt_state_bytes` computes
    without building it."""
    _, s0 = _port_run(mesh, 0, steps=1, keep=True)
    _, s2 = _port_run(mesh, 2, steps=1, keep=True)
    try:
        b0, b2 = s0.per_chip_opt_state_bytes(), s2.per_chip_opt_state_bytes()
        unsharded = s2.unsharded_opt_state_bytes()
        meta = s2._flat_meta
    finally:
        s0.close()
        s2.close()
    j0 = jspmd.per_chip_opt_state_bytes(_jax_run(0, steps=1)[3])
    j2 = jspmd.per_chip_opt_state_bytes(_jax_run(2, steps=1)[3])
    want = sum(2 * 4 * (num + pad) // DP + 2 * 4
               for _, num, pad in meta.values())
    assert b2 == [want] * DP == [j2] * DP
    assert b0 == [unsharded] * DP == [j0] * DP
    pad_bytes = sum(2 * 4 * pad for _, _, pad in meta.values())
    host = 2 * 4 * len(meta)
    assert DP * b2[0] - b0[0] == pad_bytes + host


def test_stage3_gather_params_round_trips(mesh):
    """Stage 3 keeps 1/dp of the parameters between steps (stage 2 the
    model's bytes once: its shards are slices of the parameters);
    `gather_params` gives natural shapes equal to stage 0's parameters bit
    for bit (one order of two-term sums), and `state_dict` ->
    `set_state_dict` of a fresh stage-3 step continues the run exactly."""
    _, s0 = _port_run(mesh, 0, steps=2, keep=True)
    _, s2 = _port_run(mesh, 2, steps=2, keep=True)
    _, s3 = _port_run(mesh, 3, steps=2, keep=True)
    try:
        p0, p2, p3 = s0.gather_params(), s2.gather_params(), \
            s3.gather_params()
        held0, held2, held3 = (s0.param_bytes(), s2.param_bytes(),
                               s3.param_bytes())
        sd = s3.state_dict()
        ids, labels = _batch()
        cont = [s3(ids, labels) for _ in range(2)]
    finally:
        s0.close()
        s2.close()
        s3.close()
    assert set(p3) == set(p0) == set(p2)
    for k in p0:
        assert p3[k].shape == p0[k].shape, k
        assert torch.equal(p3[k], p0[k]) and torch.equal(p2[k], p0[k]), k
    assert held2 == held0
    pad = sum(4 * pad for _, _, pad in s3._flat_meta.values())
    assert [DP * h for h in held3] == [h + pad for h in held0]
    fresh = _port_step(mesh, 3)
    try:
        fresh.set_state_dict(sd)
        assert [fresh(ids, labels) for _ in range(2)] == cont
    finally:
        fresh.close()


def test_resume_at_dp2_from_a_dp1_state(mesh):
    """A one-rank run's state after 2 steps, re-sharded over the stage-2
    and stage-3 steps at dp=2, takes the uninterrupted dp=2 run's next
    losses (rtol 1e-5: one rank sums the batch in another order); a dp=2
    stage-2 state resumed at stage 3 gives them bit for bit."""
    ids, labels = _batch()
    full = _reference(mesh, 1, False)
    one = build_mesh({"dp": 1}, device="cpu", timeout=TIMEOUT)
    s1 = _port_step(one, 0)
    for _ in range(2):
        s1(ids, labels)
    sd1 = s1.state_dict()
    _, s2 = _port_run(mesh, 2, steps=2, keep=True)
    sd2 = s2.state_dict()
    s2.close()
    assert set(sd1["optimizer"]) == set(sd2["optimizer"])
    for zs, sd in ((2, sd1), (3, sd1), (3, sd2)):
        step = _port_step(mesh, zs)
        try:
            step.set_state_dict(sd)
            got = [step(ids, labels) for _ in range(2)]
        finally:
            step.close()
        if sd is sd2:
            assert got == full[2:]
        else:
            np.testing.assert_allclose(got, full[2:], rtol=1e-5)


def test_resume_from_the_jax_steps_state(mesh):
    """The JAX explicit stage-2 step's state after 2 steps (natural
    parameters, flat padded slots) loads into the port's stage-2 step
    through `weights.from_jax_train_state`; `to_jax_train_state` gives the
    JAX state back at natural shapes, and the port takes the JAX run's
    next two losses."""
    _, jstep, jparams, jstate = _jax_run(2, steps=2)
    want = _jax_run(2)[0][2:]
    step = _port_step(mesh, 2)
    try:
        from_jax_train_state(step, {k: np.asarray(v)
                                    for k, v in jparams.items()},
                             {k: {s: np.asarray(a) for s, a in sl.items()}
                              for k, sl in jstate.items()})
        params, opt_state, _ = to_jax_train_state(step)
        ids, labels = _batch()
        got = [step(ids, labels) for _ in range(2)]
    finally:
        step.close()
    for k, v in jparams.items():
        np.testing.assert_array_equal(params[k], np.asarray(v))
        for s, a in jstate[k].items():
            a = np.asarray(a)
            n = params[k].size
            nat = a if a.ndim == 0 else a.reshape(-1)[:n].reshape(
                params[k].shape)
            np.testing.assert_array_equal(opt_state[k][s], nat)
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- guards --------------------------------------------------------------------


def _jax_message(fn):
    with pytest.raises(Exception) as exc:
        fn()
    return str(exc.value)


def test_guards_raise_with_the_jax_words(mesh):
    """The JAX step's guards, in its words: quant_grads off the explicit
    path, grad_clip and a rule with per-tensor reductions other than
    sharded norms on it, explicit_update below stage 2 or off a pure-dp
    mesh. Lamb and Lars build on the explicit path, as in the JAX step;
    'mp', 'sharding' and 'pp' meshes build, and an 'sp' axis is refused
    naming its ROADMAP item."""
    model = _model()
    jmesh = jax_init_mesh({"dp": DP})
    paddle.seed(0)
    jmodel = JaxGPT(tiny_gpt_config())

    def port(opt, m=mesh, **kw):
        return make_sharded_train_step(model, gpt_loss_fn, opt, m, **kw)

    def jax_step(opt, m=jmesh, **kw):
        return jspmd.make_sharded_train_step(jmodel, jax_gpt_loss, opt, m,
                                             **kw)

    sgd = lambda **kw: SGD(learning_rate=0.1,  # noqa: E731
                           parameters=model.named_parameters(), **kw)
    jsgd = lambda **kw: paddle.optimizer.SGD(  # noqa: E731
        learning_rate=0.1, parameters=jmodel.parameters(), **kw)

    class DGCMomentum(Momentum):
        _elementwise_update = False

    from paddle_tpu.optimizer.optimizers import DGCMomentum as JaxDGC

    cases = [
        (lambda: port(sgd(), zero_stage=0, quant_grads=True),
         lambda: jax_step(jsgd(), zero_stage=0, quant_grads=True),
         "quant_grads"),
        (lambda: port(sgd(grad_clip=ClipGradByGlobalNorm(1.0)),
                      zero_stage=2),
         lambda: jax_step(jsgd(grad_clip=paddle.nn.ClipGradByGlobalNorm(
             1.0)), zero_stage=2), "grad_clip"),
        (lambda: port(DGCMomentum(learning_rate=0.01,
                                  parameters=model.named_parameters()),
                      zero_stage=2),
         lambda: jax_step(JaxDGC(learning_rate=0.01,
                                 parameters=jmodel.parameters()),
                          zero_stage=2), "per-tensor"),
        (lambda: port(sgd(), zero_stage=1, explicit_update=True),
         lambda: jax_step(jsgd(), zero_stage=1, explicit_update=True),
         "zero_stage >= 2"),
    ]
    for mine, theirs, words in cases:
        with pytest.raises(ValueError, match=words) as exc:
            mine()
        assert str(exc.value) == _jax_message(theirs)
    one = build_mesh({"dp": 1}, device="cpu", timeout=TIMEOUT)
    with pytest.raises(ValueError, match="pure-dp"):
        port(sgd(), m=one, zero_stage=2, explicit_update=True)
    assert not port(sgd(), m=one, zero_stage=2).explicit_update

    # Lamb and Lars now build on the explicit path (their norms sum the
    # shards over dp: test_torch_meta_optimizers.py trains them), as in
    # the JAX step; 'pp' and 'sp' meshes build, and 'sp' beside 'sharding'
    # (test_torch_sp_hybrid.py trains it); 'sp' beside 'pp' is refused
    from paddle_tpu_torch.optimizer import Lamb, Lars

    for rule in (Lamb, Lars):
        step = port(rule(learning_rate=0.01,
                         parameters=model.named_parameters()), zero_stage=2)
        assert step.explicit_update
        step.close()
    assert build_mesh({"dp": 2, "mp": 2}, device="cpu").size == 4
    assert build_mesh({"dp": 1, "sharding": 2}, device="cpu").size == 2
    assert build_mesh({"dp": 2, "pp": 2}, device="cpu").size == 4
    assert build_mesh({"dp": 2, "sp": 2}, device="cpu").size == 4
    assert build_mesh({"sp": 2, "sharding": 2}, device="cpu").size == 4
    with pytest.raises(NotImplementedError, match="item 8b"):
        build_mesh({"sp": 2, "pp": 2}, device="cpu")
    with pytest.raises(ValueError, match="unknown mesh axes"):
        build_mesh({"tp": 2}, device="cpu")


# -- LocalSGD ------------------------------------------------------------------


def _linear_pair():
    """A JAX nn.Linear(6, 3) (paddle.seed(0)) with SGD(0.05), and a torch
    one with its weights (the JAX [in, out] weight transposed)."""
    paddle.seed(0)
    jnet = paddle.nn.Linear(6, 3)
    jopt = paddle.optimizer.SGD(learning_rate=0.05,
                                parameters=jnet.parameters())
    tnet = torch.nn.Linear(6, 3)
    arrays = {k: np.asarray(v) for k, v in state_dict_arrays(jnet)[0].items()}
    with torch.no_grad():
        tnet.weight.copy_(torch.from_numpy(arrays["weight"].T.copy()))
        tnet.bias.copy_(torch.from_numpy(arrays["bias"].copy()))
    topt = SGD(learning_rate=0.05, parameters=tnet.named_parameters())
    return (jnet, jopt), (tnet, topt)


def test_localsgd_against_jax(mesh):
    """k=1 (average every step) equals the port's stage-0 step within 1e-4
    and the JAX LocalSGD step within 1e-5; k=3 lets the replicas diverge
    for two steps and averages them on the third, as JAX's do."""
    rs = np.random.RandomState(2)
    X = rs.randn(8, 6).astype(np.float32)
    Y = rs.randn(8, 3).astype(np.float32)
    jmesh = jax_init_mesh({"dp": DP})
    key = jax.random.PRNGKey(0)

    def jax_local(k):
        (jnet, jopt), _ = _linear_pair()
        ls = jspmd.LocalSGDTrainStep(
            jnet, lambda o, y: jnp.mean((o - y) ** 2), jopt, jmesh,
            k_steps=k)
        params, buffers, opt_state, count = ls.init_state()
        losses, weights = [], []
        for _ in range(3):
            loss, params, buffers, opt_state, count = ls(
                params, buffers, opt_state, count, np.float32(0.05), key,
                *ls.shard_batch(X, Y))
            losses.append(float(loss))
            weights.append(np.asarray(params["weight"]))
        return losses, weights

    for k in (1, 3):
        _, (tnet, topt) = _linear_pair()
        step = LocalSGDTrainStep(tnet, F.mse_loss, topt, mesh, k_steps=k)
        try:
            losses, spreads, weights = [], [], []
            for _ in range(3):
                losses.append(step(X, Y))
                w = step.replica_params()["weight"].numpy()
                spreads.append(np.abs(w - w.mean(0, keepdims=True)).max())
                weights.append(w)
        finally:
            step.close()
        jl, jw = jax_local(k)
        np.testing.assert_allclose(losses, jl, rtol=1e-5)
        for w, j in zip(weights, jw):       # JAX: [R, in, out]
            np.testing.assert_allclose(w, j.transpose(0, 2, 1), atol=1e-6)
        if k == 1:
            assert max(spreads) < 1e-6
            _, (tnet0, topt0) = _linear_pair()
            s0 = make_sharded_train_step(tnet0, F.mse_loss, topt0, mesh)
            try:
                ref = [s0(X, Y) for _ in range(3)]
                w0 = s0.gather_params()["weight"].numpy()
            finally:
                s0.close()
            np.testing.assert_allclose(losses, ref, rtol=1e-4)
            np.testing.assert_allclose(weights[-1][0], w0, rtol=1e-4,
                                       atol=1e-5)
        else:
            assert spreads[0] > 1e-6 and spreads[1] > 1e-6, spreads
            assert spreads[2] < 1e-6, spreads


# -- ERNIE ---------------------------------------------------------------------

BERT = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=256, max_position_embeddings=64)


def _bert_batch(B=8, S=64):
    """ids, type ids, the additive padding mask [B, 1, 1, S] and MLM labels
    (15 % of real positions; -100 elsewhere), as test_torch_bert.py draws
    them."""
    rs = np.random.RandomState(0)
    lens = rs.randint(S // 2, S + 1, B)
    real = np.arange(S)[None] < lens[:, None]
    ids = np.where(real, rs.randint(0, BERT["vocab_size"], (B, S)), 0)
    types = real & (np.arange(S)[None] >= (lens // 2)[:, None])
    labels = np.where(real & (rs.rand(B, S) < 0.15), ids, -100)
    mask = np.where(real, 0.0, -1e4).astype(np.float32)[:, None, None, :]
    return (ids.astype(np.int32), types.astype(np.int32), mask,
            labels.astype(np.int32))


def test_ernie_stage2_matches_jax(mesh):
    """ERNIE-shaped BERT at tiny widths, dp=2, stage 2, a padding mask and
    dropout 0: the losses equal the JAX explicit step's on `Bert` within
    rtol 1e-5. With dropout 0.1 the two ranks draw different masks (each
    rank's loss differs from a dropout-free rank's) and the losses stay
    finite and fall."""
    batch = _bert_batch()
    jmesh = jax_init_mesh({"dp": DP})
    paddle.seed(0)
    jm = JaxBert(JaxBertConfig(**BERT, dropout=0.0))
    init = {k: np.asarray(v) for k, v in state_dict_arrays(jm)[0].items()}
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters())
    P = jax.sharding.PartitionSpec
    jstep = jspmd.make_sharded_train_step(
        jm, jax_bert_loss, jopt, jmesh, batch_specs=(P("dp"),) * 4,
        zero_stage=2)
    params, buffers, opt_state = jstep.init_state()
    jb = jstep.shard_batch(*batch)
    want = []
    for _ in range(3):
        loss, params, buffers, opt_state = jstep(
            params, buffers, opt_state, jnp.float32(1e-3),
            jax.random.PRNGKey(0), *jb)
        want.append(float(loss))

    def port(dropout):
        model = from_jax_state_dict(
            Bert(BertConfig(**BERT, dropout=dropout), device="cpu"), init)
        opt = AdamW(learning_rate=1e-3, parameters=model.named_parameters())
        return make_sharded_train_step(model, bert_pretrain_loss_fn, opt,
                                       mesh, zero_stage=2)

    step = port(0.0)
    try:
        got = [step(*batch) for _ in range(3)]
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    step = port(0.1)
    try:
        dropped = [step(*batch, seed=7) for _ in range(4)]
    finally:
        step.close()
    assert np.all(np.isfinite(dropped))
    assert dropped[0] != got[0]
    assert np.mean(dropped[-2:]) < dropped[0], dropped


def test_ranks_draw_their_own_dropout_masks():
    """Each rank reseeds its model's dropout generators from the step's
    seed and its rank: two ranks' seeds differ, one rank's repeat."""
    assert spmd._rank_seed(7, 0) != spmd._rank_seed(7, 1)
    assert spmd._rank_seed(7, 1) == spmd._rank_seed(7, 1)
    assert spmd._rank_seed(7, 0) != spmd._rank_seed(8, 0)


# -- the Group Sharded API -----------------------------------------------------


def test_group_sharded_offload_rejected():
    """offload=True fails loudly, not silently dropped."""
    net = torch.nn.Linear(16, 16)
    opt = AdamW(parameters=net.named_parameters())
    for level in ("os_g", "p_g_os"):
        with pytest.raises(NotImplementedError):
            group_sharded_parallel(net, opt, level, offload=True)
    with pytest.raises(ValueError, match="os | os_g | p_g_os"):
        group_sharded_parallel(net, opt, "all")


def test_group_sharded_segment_size_threshold():
    """segment_size maps to a replicate-below threshold for stage 3."""
    group = types.SimpleNamespace(nranks=8)
    net = torch.nn.Sequential(torch.nn.Linear(16, 32),
                              torch.nn.Linear(32, 8))
    opt = AdamW(parameters=net.named_parameters())
    group_sharded_parallel(net, opt, "p_g_os", group=group,
                           segment_size=2**20)
    assert not [p for p in net.parameters()
                if any(getattr(p, "sharding_axes", None) or ())]


def test_group_sharded_parallel_api(tmp_path):
    """Stage 3 annotates the weights' largest divisible dim; stage 2 wraps
    model and optimizer (zero_stage 2 markers, the inner names); the
    wrapped model's eager forward warns once that it runs unsharded; the
    markers save the inner state dicts."""
    net = torch.nn.Sequential(torch.nn.Linear(16, 32),
                              torch.nn.Linear(32, 8))
    opt = AdamW(parameters=net.named_parameters())
    model, opt3, _ = group_sharded_parallel(
        net, opt, "p_g_os", group=types.SimpleNamespace(nranks=8))
    assert isinstance(model, GroupShardedStage3) and opt3 is opt
    sharded = [p.sharding_axes for p in net.parameters()
               if any(getattr(p, "sharding_axes", None) or ())]
    assert len(sharded) >= 2
    assert net[0].weight.sharding_axes == ("sharding", None)
    net2 = torch.nn.Linear(4, 4)
    opt2 = AdamW(parameters=net2.named_parameters())
    model2, wopt, scaler = group_sharded_parallel(net2, opt2, "os_g")
    assert isinstance(model2, GroupShardedStage2)
    assert isinstance(wopt, GroupShardedOptimizerStage2)
    assert model2.zero_stage == wopt.zero_stage == 2 and scaler is None
    assert wopt.get_lr() == opt2.get_lr()
    assert set(model2.state_dict()) == {"weight", "bias"}
    with pytest.warns(UserWarning, match="UNSHARDED"):
        model2(torch.ones(1, 4))
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        model2(torch.ones(1, 4))          # once only
    save_group_sharded_model(model2, str(tmp_path / "m"), wopt)
    assert set(torch.load(tmp_path / "m.pdparams")) == {"weight", "bias"}
    assert (tmp_path / "m.pdopt").exists()
    shard_parameters_over(net2, 2)
    assert net2.weight.sharding_axes in (("sharding", None),
                                         (None, "sharding"))


def test_the_step_takes_the_markers_inner_model(mesh):
    """make_sharded_train_step over group_sharded_parallel's wrapped model
    and optimizer trains the inner model under its own names: the losses
    equal an unwrapped stage-2 step's."""
    ids, labels = _batch()
    model = _model()
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
    wrapped, wopt, _ = group_sharded_parallel(model, opt, "os_g")
    step = make_sharded_train_step(wrapped, gpt_loss_fn, wopt, mesh,
                                   zero_stage=2)
    try:
        got = [step(ids, labels) for _ in range(2)]
        names = set(step.gather_params())
    finally:
        step.close()
    assert names == {n for n, _ in model.named_parameters()}
    assert got == _reference(mesh, 1, False)[:2]


# -- failure -------------------------------------------------------------------


def test_a_rank_that_raises_gives_rank_failed():
    """A rank that raises (an operation it cannot run) makes the
    controller's next step raise `RankFailed` naming it, well within the
    60 s mesh timeout; the mesh's ranks stay failed; close() ends them; a
    new mesh trains."""
    import time

    own = build_mesh({"dp": DP}, device="cpu", timeout=TIMEOUT)
    try:
        step = _port_step(own, 2)
        ids, labels = _batch()
        step(ids, labels)
        own.ranks.send("no_such_operation")
        t0 = time.monotonic()
        with pytest.raises(RankFailed, match="KeyError") as exc:
            step(ids, labels)
        assert time.monotonic() - t0 < 30
        assert exc.value.rank == 1
        with pytest.raises(RankFailed):
            step(ids, labels)
        procs = list(own.ranks.procs)
    finally:
        own.close()
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        step(ids, labels)
    fresh = build_mesh({"dp": DP}, device="cpu", timeout=TIMEOUT)
    try:
        assert np.isfinite(_port_step(fresh, 2)(ids, labels))
    finally:
        fresh.close()
