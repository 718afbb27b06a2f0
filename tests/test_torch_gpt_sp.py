"""Sequence-parallel GPT training in the port (parallel/spmd.py's sequence
split, parallel/ring_attention.py, parallel/sequence_attention.py,
distributed/mesh.py's ``sp`` axis) against the JAX package's GSPMD step,
on the CPU.

The port's ranks are spawned gloo processes, one mesh a degree set
(``{"sp": 2}``, ``{"dp": 2, "sp": 2}``, ``{"sp": 4}``), kept for the
module, collectives timing out after 60 s. The JAX side runs
`make_sharded_train_step(..., batch_specs=(P("dp", "sp"),) * 2)` with
``GPTConfig(attn_impl="ring")`` over the same degrees on the
8-fake-device CPU mesh (its ring is `ring_attention`'s shard_map), and
with ``"flash"`` and ``"xla"`` (attention over the sequence-split input
as GSPMD partitions it; the port gathers K/V over the sp group). Both
start from the same numpy weights (`weights.from_jax_state_dict`) and
train float32 with SGD 0.1 for 3 steps on one seeded batch:

- the losses agree within 1e-5 relative and every gathered parameter
  within 2e-5 (`to_jax_train_state`, the JAX layout);
- with dropout 0.1 (embeddings and residual branches; the ring takes no
  attention dropout, flash's draws the whole sequence's keep bits at each
  rank's rows) ``{"sp": 2}`` equals the port's one process at the same
  seed: each rank's masks are its slice of the whole row's draw (the JAX
  package's PRNG cannot match, so this stays inside the port);
- each rank's sends, receives, all-gathers, reduce-scatters and
  all-reduces a step equal `sp_collective_budget`, whose arithmetic is
  held on its own;
- ``sp`` builds beside ``mp`` and ``sharding`` and is refused beside
  ``pp``, naming its ROADMAP item; remat and LocalSGD run under it
  (test_torch_sp_hybrid.py holds them against the JAX package); a model
  without `shard_sequence` raises `NotImplementedError`, and a sequence
  that ``sp`` does not divide raises.
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
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss
from paddle_tpu.parallel import spmd as jspmd
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import mesh as port_mesh_mod
from paddle_tpu_torch.distributed.mesh import build_mesh
from paddle_tpu_torch.models.bert import Bert, BertConfig
from paddle_tpu_torch.models.bert import bert_pretrain_loss_fn
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.parallel.spmd import (LocalSGDTrainStep,
                                            make_sharded_train_step,
                                            sp_collective_budget)
from paddle_tpu_torch.weights import from_jax_state_dict, to_jax_train_state
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

STEPS, TIMEOUT, LR = 3, 60, 0.1
CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)
DEGREES = {"sp2": {"sp": 2}, "dp2sp2": {"dp": 2, "sp": 2},
           "sp4": {"sp": 4}}
SPEC = (("dp", "sp"),) * 2
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


def _batch(rows=4, seq=64, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, CFG["vocab_size"], (rows, seq), dtype=np.int32),
            rs.randint(0, CFG["vocab_size"], (rows, seq), dtype=np.int32))


_JAX = {}


def _jax_run(key, attn_impl="ring"):
    """The JAX GSPMD step with `attn_impl` over DEGREES[key] from
    paddle.seed(0): (initial numpy weights, losses, natural numpy
    params)."""
    if (key, attn_impl) not in _JAX:
        jmesh = jax_init_mesh(DEGREES[key])
        paddle.seed(0)
        model = JaxGPT(JaxGPTConfig(**CFG, attn_impl=attn_impl))
        init = {k: np.asarray(v)
                for k, v in state_dict_arrays(model)[0].items()}
        opt = paddle.optimizer.SGD(learning_rate=LR,
                                   parameters=model.parameters())
        P = jax.sharding.PartitionSpec
        step = jspmd.make_sharded_train_step(
            model, jax_gpt_loss, opt, jmesh, batch_specs=(P("dp", "sp"),) * 2)
        params, buffers, opt_state = step.init_state()
        b = step.shard_batch(*_batch())
        losses = []
        for _ in range(STEPS):
            loss, params, buffers, opt_state = step(
                params, buffers, opt_state, jnp.float32(LR),
                jax.random.PRNGKey(0), *b)
            losses.append(float(np.asarray(loss)))
        jax_set_mesh(None)
        _JAX[key, attn_impl] = (init, losses,
                                {k: np.asarray(v) for k, v in params.items()})
    return _JAX[key, attn_impl]


def _port_step(mesh, init, dropout=0.0, attn_impl="ring", specs=SPEC,
               **kw):
    model = GPT(GPTConfig(**CFG, dropout=dropout, attn_impl=attn_impl),
                device="cpu")
    from_jax_state_dict(model, init)
    opt = SGD(learning_rate=LR, parameters=model.named_parameters())
    return make_sharded_train_step(model, gpt_loss_fn, opt, mesh,
                                   batch_specs=specs, **kw)


# -- parity with the JAX package -----------------------------------------------


@pytest.mark.parametrize("key", list(DEGREES))
def test_sp_steps_match_jax_gspmd(meshes, key):
    """3 float32 SGD steps over the same degrees: the JAX ring step's
    losses within 1e-5 relative and every gathered parameter within 2e-5;
    each rank's calls a step are `sp_collective_budget`'s."""
    init, want, jparams = _jax_run(key)
    step = _port_step(meshes[key], init)
    try:
        step.rank_reports(zero=True)
        step.count_host_syncs()
        got = [step(*_batch()) for _ in range(STEPS)]
        counts = step.collective_counts()
        for r in step.last_step:          # CPU ranks count no host sync
            assert r["host_syncs"] is None
            assert {"forward", "backward", "grad_reduce"} <= set(
                r["phases_ms"])
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
                                  deg.get("dp", 1), len(step.names))
    assert len(counts) == meshes[key].size
    for c in counts:
        assert {k: c[k] for k in KEYS} == {k: STEPS * budget[k]
                                           for k in KEYS}, (c, budget)


@pytest.mark.parametrize("key", list(DEGREES))
@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_gathered_sp_steps_match_jax_gspmd(meshes, attn_impl, key):
    """``attn_impl="flash"`` and ``"xla"`` over the same degrees: K/V
    gathered over the sp group, the JAX step's losses within 1e-5
    relative and every gathered parameter within 2e-5; each rank's calls
    a step are `sp_collective_budget`'s (an all-gather and a
    reduce-scatter a layer, no hop)."""
    init, want, jparams = _jax_run(key, attn_impl)
    step = _port_step(meshes[key], init, attn_impl=attn_impl)
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
                                  ring=False)
    assert budget["all-gather"] == budget["reduce-scatter"] == \
        CFG["num_layers"] and budget["send"] == 0
    for c in counts:
        assert {k: c[k] for k in KEYS} == {k: STEPS * budget[k]
                                           for k in KEYS}, (c, budget)


def test_ring_model_equals_one_process_without_a_mesh(meshes):
    """The same weights, batch and steps on one process (no mesh, the
    ring's fallback: flash attention over the whole row) give the sp=2
    losses within 1e-5 relative: the split changes nothing but rounding."""
    init, want, _ = _jax_run("sp2")
    one = _port_step(build_mesh({"dp": 1}, device="cpu"), init,
                     specs=None)
    try:
        got = [one(*_batch()) for _ in range(STEPS)]
    finally:
        one.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_dropout_at_sp2_equals_one_process(meshes):
    """Dropout 0.1 on the embeddings and residual branches: {"sp": 2}
    gives one process's losses and parameters at the same seed (each
    rank's masks are its slice of the whole row's draw; the sp peers of
    a row share take one seed)."""
    init = _jax_run("sp2")[0]
    one = _port_step(build_mesh({"dp": 1}, device="cpu"), init, dropout=0.1,
                     specs=None)
    try:
        want = [one(*_batch(), seed=11) for _ in range(2)]
        wparams = one.gather_params()
    finally:
        one.close()
    step = _port_step(meshes["sp2"], init, dropout=0.1)
    try:
        got = [step(*_batch(), seed=11) for _ in range(2)]
        params = step.gather_params()
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[0] != _jax_run("sp2")[1][0]      # the masks dropped something
    for k, w in wparams.items():
        np.testing.assert_allclose(params[k].numpy(), w.numpy(), atol=2e-5,
                                   rtol=0, err_msg=k)


def test_flash_attention_dropout_at_sp2_equals_one_process(meshes):
    """``attn_impl="flash"`` with dropout 0.1, attention dropout included:
    {"sp": 2} gives one process's losses and parameters at the same seed
    (each rank draws the whole sequence's keep bits at its rows, and its
    slice of every elementwise mask)."""
    init = _jax_run("sp2")[0]
    one = _port_step(build_mesh({"dp": 1}, device="cpu"), init, dropout=0.1,
                     attn_impl="flash", specs=None)
    try:
        want = [one(*_batch(), seed=5) for _ in range(2)]
        wparams = one.gather_params()
    finally:
        one.close()
    step = _port_step(meshes["sp2"], init, dropout=0.1, attn_impl="flash")
    try:
        got = [step(*_batch(), seed=5) for _ in range(2)]
        params = step.gather_params()
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k, w in wparams.items():
        np.testing.assert_allclose(params[k].numpy(), w.numpy(), atol=2e-5,
                                   rtol=0, err_msg=k)


# -- the arithmetic and the refusals -------------------------------------------


@pytest.mark.parametrize("layers,sp,dp,leaves", [
    (2, 2, 1, 28), (24, 2, 1, 292), (2, 2, 2, 28), (2, 4, 1, 28),
    (3, 1, 2, 40)])
def test_sp_collective_budget_arithmetic(layers, sp, dp, leaves):
    """Each layer's ring: sp - 1 hops forward and sp backward, a send and
    a receive each; the loss and each leaf all-reduced once over each of
    the dp and sp groups of degree above 1. Gathered attention: an
    all-gather and a reduce-scatter a layer in place of the hops; BERT's
    adds its labelled-position count a group and the first token's
    all-gather."""
    b = sp_collective_budget(layers, sp, dp, leaves)
    hops = layers * (2 * sp - 1) if sp > 1 else 0
    groups = (dp > 1) + (sp > 1)
    assert b == {"all-reduce": groups * (1 + leaves), "all-gather": 0,
                 "reduce-scatter": 0, "all-to-all": 0, "send": hops,
                 "recv": hops}
    g = layers if sp > 1 else 0
    assert sp_collective_budget(layers, sp, dp, leaves, ring=False) == {
        "all-reduce": groups * (1 + leaves), "all-gather": g,
        "reduce-scatter": g, "all-to-all": 0, "send": 0, "recv": 0}
    assert sp_collective_budget(layers, sp, dp, leaves, bert=True) == {
        "all-reduce": groups * (2 + leaves), "all-gather": g + int(sp > 1),
        "reduce-scatter": g, "all-to-all": 0, "send": 0, "recv": 0}


def test_meshes_and_topology_take_sp():
    """`build_mesh` takes sp alone and beside dp, mp and sharding (sp
    fastest, every axis's groups in `AXES` order), and refuses it beside
    pp naming item 8b.1 and why; fleet's sep_degree reaches the mesh's sp
    axis."""
    m = build_mesh({"dp": 2, "sp": 2}, device="cpu")
    assert m.comm_lists("sp") == [[0, 1], [2, 3]]
    assert m.comm_lists("dp") == [[0, 2], [1, 3]]
    assert build_mesh({"sp": 4}, device="cpu").size == 4
    m = build_mesh({"sp": 2, "mp": 2}, device="cpu")
    assert m.comm_lists("sp") == [[0, 1], [2, 3]]
    assert m.comm_lists("mp") == [[0, 2], [1, 3]]
    m = build_mesh({"dp": 2, "sp": 2, "mp": 2}, device="cpu")
    assert m.comm_lists("sp") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert m.comm_lists("mp") == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert m.comm_lists("dp") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    m = build_mesh({"sharding": 2, "sp": 2}, device="cpu")
    assert m.comm_lists("sp") == [[0, 1], [2, 3]]
    assert m.comm_lists("sharding") == [[0, 2], [1, 3]]
    with pytest.raises(NotImplementedError,
                       match="item 8b.1.*never splits the sequence"):
        build_mesh({"sp": 2, "pp": 2}, device="cpu")
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs.update(dict(dp_degree=2, sep_degree=2))
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    h = fleet.fleet.get_hybrid_communicate_group()
    try:
        assert dict(h.mesh.shape) == {"dp": 2, "pp": 1, "sharding": 1,
                                      "mp": 1, "sp": 2}
        assert h.get_sep_parallel_world_size() == 2
        assert h.get_sep_parallel_group().nranks == 2
        assert h.get_data_parallel_world_size() == 2
        assert h.get_parallel_mode() == "segment_parallel"
    finally:
        port_mesh_mod.set_mesh(None)


def test_what_the_split_does_not_cover_raises(meshes):
    """At sp > 1 the step's remat, BERT's own remat and LocalSGD run (one
    step each, the split step's first loss); a model without
    `shard_sequence` raises NotImplementedError; a batch_specs that does
    not split the sequence, and a sequence sp does not divide, raise
    ValueError. None of the refused computes."""
    init, want, _ = _jax_run("sp2")
    mesh = meshes["sp2"]
    for step in (_port_step(mesh, init, remat=True),
                 LocalSGDTrainStep(*_gpt_parts(init), mesh,
                                   batch_specs=SPEC)):
        try:
            np.testing.assert_allclose(step(*_batch()), want[0], rtol=1e-5)
        finally:
            step.close()
    with pytest.raises(ValueError, match="batch_specs"):
        _port_step(mesh, init, specs=None)
    bert = Bert(BertConfig(vocab_size=64, hidden_size=32, num_layers=1,
                           num_heads=2, intermediate_size=64,
                           max_position_embeddings=64, remat=True),
                device="cpu")
    step = make_sharded_train_step(
        bert, bert_pretrain_loss_fn,
        SGD(learning_rate=LR, parameters=bert.named_parameters()),
        mesh, batch_specs=(("dp", "sp"),) * 2)
    try:
        ids = np.random.RandomState(0).randint(0, 64, (2, 32))
        assert np.isfinite(step(ids, ids))
    finally:
        step.close()
    plain = torch.nn.Linear(4, 4)
    with pytest.raises(NotImplementedError, match="no shard_sequence"):
        make_sharded_train_step(
            plain, gpt_loss_fn,
            SGD(learning_rate=LR, parameters=plain.named_parameters()),
            mesh, batch_specs=SPEC)
    step = _port_step(mesh, init)
    try:
        with pytest.raises(ValueError, match="does not split over sp"):
            step.shard_batch(*_batch(seq=63))
        with pytest.raises(ValueError, match="'sp' splits the sequence"):
            _port_step(mesh, init, specs=(("sp", "dp"),) * 2)
    finally:
        step.close()


def _gpt_parts(init):
    """A ring GPT from `init`, its loss and an SGD over it."""
    model = GPT(GPTConfig(**CFG, attn_impl="ring"), device="cpu")
    from_jax_state_dict(model, init)
    return model, gpt_loss_fn, SGD(learning_rate=LR,
                                   parameters=model.named_parameters())
