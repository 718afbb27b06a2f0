"""dp x mp hybrid training in the port (parallel/spmd.py's hybrid path,
distributed/mesh.py, the Megatron layers of
distributed/fleet/meta_parallel/mp_layers.py, the mp paths of
models/gpt.py and models/bert.py) against the JAX package's GSPMD step, on
the CPU.

The port's ranks are spawned gloo processes: one mesh of ``{"mp": 2}`` (2
ranks) and one of ``{"dp": 2, "mp": 2}`` (4 ranks) for the module, every
step built over them, collectives timing out after 60 s. The JAX side runs
`make_sharded_train_step` over the same degrees on the 8-fake-device CPU
mesh. Both start from the same numpy weights (`weights.from_jax_state_dict`)
and train float32 for 3 steps:

- GPT-tiny (`tiny_gpt_config()` widths) and ERNIE-tiny (a BERT with a
  padding mask; its QKV rows are three strided head groups a rank) give
  the JAX losses within 1e-5 relative, with AdamW and with SGD. Under SGD
  each gathered parameter is within 1e-5 of JAX's relative to its norm.
  Under AdamW every entry is within ``2 * steps * lr``: Adam divides a
  gradient by its own magnitude, so an entry whose gradient is float
  noise (the key bias, whose true gradient is zero) or nearly cancels
  moves by up to lr on a rounding, as `test_torch_gpt_train.py` allows;
- with dropout, ``{"mp": 2}`` equals one process at the same seed (port
  only: the JAX package's PRNG cannot match), so the mp peers draw the
  whole model's masks, attention dropout's head coordinate included;
- the global-norm clip over mp-sharded gradients equals one process;
- a step's collective calls on every rank equal the arithmetic below;
- the train state crosses to and from the JAX layout on a hybrid step;
- the topology answers, the "pure-dp" guard, and ``sp`` beside ``pp``
  refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.analysis.ir import tiny_gpt_config
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.distributed import mesh as jax_mesh_mod
from paddle_tpu.distributed.mesh import init_mesh as jax_init_mesh
from paddle_tpu.distributed.mesh import set_mesh as jax_set_mesh
from paddle_tpu.models.bert import Bert as JaxBert
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.bert import bert_pretrain_loss_fn as jax_bert_loss
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss
from paddle_tpu.parallel import spmd as jspmd
from paddle_tpu_torch.distributed import mesh as port_mesh_mod
from paddle_tpu_torch.distributed.mesh import build_mesh
from paddle_tpu_torch.models.bert import Bert, BertConfig
from paddle_tpu_torch.models.bert import bert_pretrain_loss_fn
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import SGD, AdamW
from paddle_tpu_torch.parallel.spmd import make_sharded_train_step
from paddle_tpu_torch.weights import (from_jax_state_dict,
                                      from_jax_train_state,
                                      to_jax_train_state)
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

STEPS, TIMEOUT, LR = 3, 60, 0.01
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)
BERT = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
            intermediate_size=256, max_position_embeddings=64)
DEGREES = {"mp2": {"mp": 2}, "dp2mp2": {"dp": 2, "mp": 2}}
KEYS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")


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


def _gpt_batch():
    rs = np.random.RandomState(0)
    return (rs.randint(0, 64, (8, 16), dtype=np.int32),
            rs.randint(0, 64, (8, 16), dtype=np.int32))


def _bert_batch(B=8, S=32):
    """ids, type ids, the additive padding mask [B, 1, 1, S] and MLM labels
    (15 % of real positions; -100 elsewhere)."""
    rs = np.random.RandomState(0)
    lens = rs.randint(S // 2, S + 1, B)
    real = np.arange(S)[None] < lens[:, None]
    ids = np.where(real, rs.randint(0, BERT["vocab_size"], (B, S)), 0)
    types = real & (np.arange(S)[None] >= (lens // 2)[:, None])
    labels = np.where(real & (rs.rand(B, S) < 0.15), ids, -100)
    mask = np.where(real, 0.0, -1e4).astype(np.float32)[:, None, None, :]
    return (ids.astype(np.int32), types.astype(np.int32), mask,
            labels.astype(np.int32))


# -- the JAX side --------------------------------------------------------------

_JAX = {}


def _jax_run(model_kind, key, steps=STEPS, opt="adamw"):
    """The JAX GSPMD step over DEGREES[key] from paddle.seed(0): (initial
    numpy weights, losses, natural numpy params, the step's state)."""
    cache = (model_kind, key, steps, opt)
    if cache not in _JAX:
        jmesh = jax_init_mesh(DEGREES[key])
        paddle.seed(0)
        if model_kind == "gpt":
            model, loss_fn, batch = (JaxGPT(tiny_gpt_config()),
                                     jax_gpt_loss, _gpt_batch())
        else:
            model, loss_fn, batch = (
                JaxBert(JaxBertConfig(**BERT, dropout=0.0)), jax_bert_loss,
                _bert_batch())
        init = {k: np.asarray(v)
                for k, v in state_dict_arrays(model)[0].items()}
        opt = {"adamw": paddle.optimizer.AdamW, "sgd": paddle.optimizer.SGD}[
            opt](learning_rate=LR, parameters=model.parameters())
        P = jax.sharding.PartitionSpec
        step = jspmd.make_sharded_train_step(
            model, loss_fn, opt, jmesh, batch_specs=(P("dp"),) * len(batch))
        params, buffers, opt_state = step.init_state()
        b = step.shard_batch(*batch)
        losses = []
        for _ in range(steps):
            loss, params, buffers, opt_state = step(
                params, buffers, opt_state, jnp.float32(LR),
                jax.random.PRNGKey(0), *b)
            losses.append(float(np.asarray(loss)))
        _JAX[cache] = (init, losses,
                       {k: np.asarray(v) for k, v in params.items()},
                       jax.tree_util.tree_map(np.asarray, opt_state))
    return _JAX[cache]


# -- the port side -------------------------------------------------------------


def _port_model(model_kind, init=None, dropout=0.0):
    if model_kind == "gpt":
        model = GPT(GPTConfig(dropout=dropout, **CFG), device="cpu")
    else:
        model = Bert(BertConfig(**BERT, dropout=dropout), device="cpu")
    return model if init is None else from_jax_state_dict(model, init)


def _port_step(model_kind, mesh, init=None, dropout=0.0, clip=None,
               opt="adamw", **kw):
    model = _port_model(model_kind, init, dropout)
    opt = {"adamw": AdamW, "sgd": SGD}[opt](
        learning_rate=LR, parameters=model.named_parameters(),
        grad_clip=clip)
    loss_fn = gpt_loss_fn if model_kind == "gpt" else bert_pretrain_loss_fn
    return make_sharded_train_step(model, loss_fn, opt, mesh, **kw)


def _batch(model_kind):
    return _gpt_batch() if model_kind == "gpt" else _bert_batch()


def _assert_params_close(got, want, opt, steps=STEPS):
    """SGD: each tensor of `got` within 1e-5 of `want` relative to its
    norm. AdamW: every entry within ``2 * steps * lr`` (module
    docstring)."""
    for k, w in want.items():
        g = np.asarray(got[k], np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if opt == "sgd":
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
            assert err <= 1e-5, (k, err)
        else:
            assert np.abs(g - w).max() <= 2 * steps * LR, k


# -- parity with the JAX package -----------------------------------------------


@pytest.mark.parametrize("opt", ["adamw", "sgd"])
@pytest.mark.parametrize("model_kind", ["gpt", "ernie"])
@pytest.mark.parametrize("key", list(DEGREES))
def test_trajectory_and_params_match_jax(meshes, model_kind, key, opt):
    """3 float32 steps over the same degrees: the JAX losses within 1e-5
    relative and the gathered parameters (`to_jax_train_state`, the JAX
    layout) as `_assert_params_close` holds them."""
    init, want, jparams, _ = _jax_run(model_kind, key, opt=opt)
    step = _port_step(model_kind, meshes[key], init, opt=opt)
    try:
        batch = _batch(model_kind)
        got = [step(*batch) for _ in range(STEPS)]
        params, _, _ = to_jax_train_state(step)
    finally:
        step.close()
    assert not step.explicit_update
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(params, jparams, opt)


@pytest.mark.parametrize("model_kind", ["gpt", "ernie"])
def test_resume_from_the_jax_state_on_a_hybrid_step(meshes, model_kind):
    """The JAX run's state after 2 steps at dp2 x mp2 re-sharded onto a
    port step over the same mesh (`from_jax_train_state`: each rank takes
    its mp slice, ERNIE's QKV as three strided head groups) takes the JAX
    run's third step."""
    init, want, _, _ = _jax_run(model_kind, "dp2mp2")
    _, _, jparams, jstate = _jax_run(model_kind, "dp2mp2", steps=2)
    step = _port_step(model_kind, meshes["dp2mp2"], init)
    try:
        from_jax_train_state(step, jparams, jstate)
        got = step(*_batch(model_kind))
    finally:
        step.close()
    np.testing.assert_allclose(got, want[2], rtol=1e-5)


# -- the port's own bars ---------------------------------------------------------


def _one_process(model_kind, init, steps, seed=None, dropout=0.0, clip=None,
                 opt="adamw"):
    """The same run in this process with no mesh: (losses, natural params)."""
    mesh = build_mesh({"dp": 1}, device="cpu")
    step = _port_step(model_kind, mesh, init, dropout, clip, opt)
    try:
        batch = _batch(model_kind)
        losses = [step(*batch, seed=seed) for _ in range(steps)]
        return losses, step.gather_params()
    finally:
        step.close()


@pytest.mark.parametrize("model_kind", ["gpt", "ernie"])
def test_dropout_at_mp2_equals_one_process(meshes, model_kind):
    """With dropout 0.1 (embeddings, residual branches, attention), mp=2
    gives one process's losses and (SGD) parameters at the same seed: the
    mp peers draw the same elementwise masks and the attention kernels'
    keep bits at each head's model coordinate (`head_offset`)."""
    init = _jax_run(model_kind, "mp2")[0]
    want, wparams = _one_process(model_kind, init, 2, seed=11, dropout=0.1,
                                 opt="sgd")
    step = _port_step(model_kind, meshes["mp2"], init, dropout=0.1,
                      opt="sgd")
    try:
        batch = _batch(model_kind)
        got = [step(*batch, seed=11) for _ in range(2)]
        params = step.gather_params()
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    no_drop = _one_process(model_kind, init, 1)[0]
    assert got[0] != no_drop[0]           # the masks did drop something
    _assert_params_close(params, wparams, "sgd")


def test_global_norm_clip_over_mp_shards_equals_one_process(meshes):
    """ClipGradByGlobalNorm inside the step sums each mp-sharded leaf's
    squared norm over the mp group and counts the replicated ones once:
    dp2 x mp2 clips as one process does (the clip bites: the norm is
    above 0.05)."""
    init = _jax_run("gpt", "dp2mp2")[0]
    want, _ = _one_process("gpt", init, STEPS,
                           clip=ClipGradByGlobalNorm(0.05))
    unclipped, _ = _one_process("gpt", init, STEPS)
    step = _port_step("gpt", meshes["dp2mp2"], init,
                      clip=ClipGradByGlobalNorm(0.05))
    try:
        got = [step(*_gpt_batch()) for _ in range(STEPS)]
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert abs(got[-1] - unclipped[-1]) > 1e-3


def _gpt_budget(L, mp, dp, n_leaves, clip=False, remat=False):
    """The collective calls of one GPT step (`gpt_loss_fn`) on every rank,
    as arithmetic: at mp > 1, forward all-reduces: the vocab-parallel
    embedding 1, proj and fc2 2 a layer, the vocab-parallel loss of the
    tied head 3 (max, sum, picked);
    backward: the column-parallel inputs (qkv, fc1) 2 a layer and the
    head's hidden state 1; the step's remat runs the whole forward again
    in the backward (its all-reduces twice); the clip 1 (the mp-sharded
    leaves' squared norms). At dp > 1: the loss 1 and one a gradient
    leaf. No other collective."""
    ar = 0
    if mp > 1:
        fwd = 1 + 2 * L + 3
        ar += fwd * (2 if remat else 1) + (2 * L + 1)
        ar += 1 if clip else 0
    if dp > 1:
        ar += 1 + n_leaves
    return {"all-reduce": ar, "all-gather": 0, "reduce-scatter": 0,
            "all-to-all": 0}


@pytest.mark.parametrize("key,clip,remat", [
    ("mp2", False, False), ("mp2", True, True), ("dp2mp2", True, False)])
def test_collectives_a_step_equal_the_arithmetic(meshes, key, clip, remat):
    init = _jax_run("gpt", key)[0]
    step = _port_step("gpt", meshes[key], init,
                      clip=ClipGradByGlobalNorm(1.0) if clip else None,
                      remat=remat)
    try:
        step.rank_reports(zero=True)
        for _ in range(2):
            step(*_gpt_batch())
        counts = step.collective_counts()
    finally:
        step.close()
    deg = DEGREES[key]
    want = _gpt_budget(CFG["num_layers"], deg.get("mp", 1),
                       deg.get("dp", 1), len(step.names), clip, remat)
    assert len(counts) == meshes[key].size
    for c in counts:
        assert {k: c[k] for k in KEYS} == {k: 2 * v for k, v in
                                           want.items()}, (c, want)


def test_o2_masters_are_kept_per_shard(meshes):
    """AMP O2 at mp=2: each rank's float32 masters are its shards (the
    optimizer state a rank holds is its share), and the bf16 run's state
    comes back at natural shapes with float32 masters."""
    from paddle_tpu_torch import amp

    init = _jax_run("gpt", "mp2")[0]
    model = _port_model("gpt", init)
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
    model, opt = amp.decorate(model, opt, level="O2")
    step = make_sharded_train_step(model, gpt_loss_fn, opt, meshes["mp2"])
    try:
        losses = [step(*_gpt_batch()) for _ in range(2)]
        per_rank = step.per_chip_opt_state_bytes()
        unsharded = step.unsharded_opt_state_bytes()
        sd = step.state_dict()
    finally:
        step.close()
    assert np.all(np.isfinite(losses)) and losses[1] < losses[0]
    masters = {k: v for k, v in sd["optimizer"].items()
               if k.endswith("_master_weight")}
    assert len(masters) == len(sd["params"])
    for k, v in masters.items():
        name = k[:-len("_master_weight")]
        assert v.dtype == torch.float32
        assert tuple(v.shape) == tuple(sd["params"][name].shape), k
    assert per_rank[0] == per_rank[1] < unsharded


# -- the mesh, the topology and the guards -------------------------------------


def test_mesh_orders_ranks_as_the_jax_mesh_orders_devices():
    """Rank r sits where device r sits in the JAX mesh over the same
    degrees (mp fastest); the groups are the lines along each axis."""
    for deg in ({"dp": 2, "mp": 2}, {"mp": 2, "sharding": 2},
                {"dp": 2, "sharding": 2, "mp": 2}):
        port = build_mesh(deg, device="cpu")
        jm = jax_mesh_mod.build_mesh(deg, jax.devices()[:port.size])
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r in range(port.size):
            c = port.coords(r)
            assert ids[tuple(c[a] for a in port_mesh_mod.AXES)] == \
                jax.devices()[r].id
            assert port.rank_of(**c) == r
        for axis in port.group_axes():
            lines = port.comm_lists(axis)
            assert sorted(sum(lines, [])) == list(range(port.size))
            for line in lines:
                cs = [port.coords(r) for r in line]
                assert [c[axis] for c in cs] == list(range(deg[axis]))
                assert all({a: v for a, v in c.items() if a != axis}
                           == {a: v for a, v in cs[0].items() if a != axis}
                           for c in cs)


def test_topology_and_hcg_answer_as_jax():
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu_torch.distributed import fleet

    jt = jax_mesh_mod.CommunicateTopology(dims=(2, 2, 1, 2))
    pt = port_mesh_mod.CommunicateTopology(dims=(2, 2, 1, 2))
    assert pt.world_size() == jt.world_size() == 8
    for r in range(8):
        assert pt.get_coord(r) == jt.get_coord(r)
    for name in ("data", "pipe", "sharding", "model"):
        assert pt.get_comm_list(name) == jt.get_comm_list(name)
        assert pt.get_axis_list(name, 0) == jt.get_axis_list(name, 0)
        assert pt.get_dim(name) == jt.get_dim(name)
    assert pt.get_rank(data=1, pipe=0, sharding=0, model=1) == \
        jt.get_rank(data=1, pipe=0, sharding=0, model=1)
    answers = {}
    for pkg, fl, kw in (("jax", jfleet, {}), ("port", fleet,
                                              {"device": "cpu"})):
        strategy = fl.DistributedStrategy()
        strategy.hybrid_configs.update(dict(dp_degree=2, mp_degree=2,
                                            pp_degree=1, sharding_degree=2))
        fl.init(is_collective=True, strategy=strategy, **kw)
        h = fl.fleet.get_hybrid_communicate_group()
        answers[pkg] = (
            h.get_data_parallel_world_size(),
            h.get_model_parallel_world_size(),
            h.get_sharding_parallel_world_size(),
            h.get_pipe_parallel_world_size(), h.get_parallel_mode(),
            h.get_data_parallel_rank(), h.get_model_parallel_rank(),
            h.get_sharding_parallel_rank(), h.get_stage_id(),
            h.is_first_stage(), h.is_last_stage(),
            h.get_model_parallel_group().nranks,
            h.get_data_parallel_group().nranks,
            h.get_sharding_parallel_group().nranks,
            dict(h.mesh.shape))
    jax_set_mesh(None)
    port_mesh_mod.set_mesh(None)
    assert answers["port"] == answers["jax"]
    assert answers["port"][4] == "sharding_parallel"


def test_fleet_wrappers_train_through_the_step(meshes):
    """`fleet.distributed_model` / `distributed_optimizer` wrap thinly: the
    step takes the inner model and optimizer (names and state keys are the
    inner ones') and trains as the bare pair does."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        HybridParallelOptimizer, TensorParallel)

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(dict(mp_degree=2))
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    init = _jax_run("gpt", "mp2")[0]
    model = _port_model("gpt", init)
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
    wrapped = fleet.distributed_model(model)
    wopt = fleet.distributed_optimizer(opt)
    assert isinstance(wrapped, TensorParallel)
    assert isinstance(wopt, HybridParallelOptimizer)
    assert wopt.get_lr() == LR
    step = make_sharded_train_step(wrapped, gpt_loss_fn, wopt,
                                   meshes["mp2"])
    try:
        got = [step(*_gpt_batch()) for _ in range(2)]
        assert set(step.state_dict()["params"]) == \
            {n for n, _ in model.named_parameters()}
    finally:
        step.close()
        port_mesh_mod.set_mesh(None)
    want = _jax_run("gpt", "mp2")[1][:2]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the strategy's lars switch now swaps a Momentum for Lars (and
    # passes any other rule through), as the JAX wrapper does
    from paddle_tpu_torch.optimizer import Lars, Momentum

    strategy.lars = True
    assert fleet.distributed_optimizer(opt, strategy)._inner_opt is opt
    mom = Momentum(learning_rate=LR, parameters=model.named_parameters())
    assert isinstance(fleet.distributed_optimizer(mom, strategy)._inner_opt,
                      Lars)


def test_explicit_update_on_a_hybrid_mesh_raises_the_jax_error(meshes):
    model = _port_model("gpt")
    sgd = SGD(learning_rate=LR, parameters=model.named_parameters())
    with pytest.raises(ValueError, match="pure-dp"):
        make_sharded_train_step(model, gpt_loss_fn, sgd, meshes["dp2mp2"],
                                zero_stage=2, explicit_update=True)
    jmodel = JaxGPT(tiny_gpt_config())
    jsgd = paddle.optimizer.SGD(learning_rate=LR,
                                parameters=jmodel.parameters())
    with pytest.raises(ValueError, match="pure-dp"):
        jspmd.make_sharded_train_step(
            jmodel, jax_gpt_loss, jsgd, jax_init_mesh({"dp": 2, "mp": 2}),
            zero_stage=2, explicit_update=True)
    # zero_stage=2 there keeps the hybrid (GSPMD) path, in both packages
    step = make_sharded_train_step(model, gpt_loss_fn, sgd,
                                   meshes["dp2mp2"], zero_stage=2)
    try:
        assert not step.explicit_update
        assert not jspmd.make_sharded_train_step(
            jmodel, jax_gpt_loss, jsgd, jax_init_mesh({"dp": 2, "mp": 2}),
            zero_stage=2).explicit_update
    finally:
        step.close()


@pytest.mark.parametrize("deg", [{"pp": 2}, {"sp": 2}, {"dp": 2, "pp": 2}])
def test_pipeline_and_sequence_axes_are_refused_naming_item_8(deg):
    """A 'pp' axis builds (the pipeline's stage lines, models/
    gpt_pipeline.py); so does 'sp' (the rings of parallel/
    ring_attention.py), beside 'mp' too, while beside 'pp' it is still
    refused, naming its ROADMAP item."""
    if "sp" in deg:
        mesh = build_mesh(deg, device="cpu")
        assert mesh.size == 2 and mesh.axis_group("sp") is mesh.group
        assert build_mesh(dict(deg, mp=2), device="cpu").size == 4
        with pytest.raises(NotImplementedError, match="item 8b"):
            build_mesh(dict(deg, pp=2), device="cpu")
        return
    mesh = build_mesh(deg, device="cpu")
    assert mesh.size == 2 * deg.get("dp", 1)
    assert mesh.comm_lists("pp") == ([[0, 1]] if "dp" not in deg
                                     else [[0, 1], [2, 3]])


def test_rows_split_only_over_dp_and_sharding():
    model = _port_model("gpt")
    sgd = SGD(learning_rate=LR, parameters=model.named_parameters())
    mesh = build_mesh({"dp": 1}, device="cpu")
    for bad in (("mp",), ("dp", "mp"), ("sharding",)):
        with pytest.raises(ValueError, match="rows split"):
            make_sharded_train_step(model, gpt_loss_fn, sgd, mesh,
                                    batch_specs=(bad, bad))


def test_gpt_logits_are_gathered_for_a_loss_of_its_own(meshes):
    """A loss over the model's logits (here the MLM loss on GPT's, every
    label valid: the same mean cross-entropy) takes GPT's logits gathered
    over mp (one all-gather a step), and gives the vocab-parallel head's
    losses."""
    init = _jax_run("gpt", "mp2")[0]
    got = {}
    for loss_fn in (gpt_loss_fn, bert_pretrain_loss_fn):
        model = _port_model("gpt", init)
        opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
        step = make_sharded_train_step(model, loss_fn, opt, meshes["mp2"])
        try:
            step.rank_reports(zero=True)
            got[loss_fn] = [step(*_gpt_batch()) for _ in range(2)]
            counts = step.collective_counts()
        finally:
            step.close()
        assert all(c["all-gather"] == (2 if loss_fn is
                                       bert_pretrain_loss_fn else 0)
                   for c in counts), counts
    np.testing.assert_allclose(got[bert_pretrain_loss_fn], got[gpt_loss_fn],
                               rtol=1e-5)
