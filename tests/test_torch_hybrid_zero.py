"""The legacy ``sharding``-axis ZeRO of the hybrid path (parallel/spmd.py)
against the JAX package's GSPMD step, on the CPU.

The port's ranks are spawned gloo processes: one mesh of ``{"dp": 2,
"sharding": 2, "mp": 2}`` (8 ranks) for the module. The JAX side runs on
the 8-fake-device CPU mesh over the same degrees.

- the Adam MLP of Column/Row-parallel layers at dp2 x mp2 x sharding2
  (`tests/test_distributed_spmd.py:131`) gives the JAX step's losses
  within that test's 1e-4, and one device's;
- the layout rule (`_zero_shard_spec`, `param_pspec`, `module_param_specs`,
  `_state_spec_like`, `grad_pspec`) answers as JAX's on GPT-tiny,
  transposed for the port's ``[out, in]`` Linear weights;
- the optimizer state a rank holds at stages 1, 2 and 3 equals JAX's
  `per_chip_opt_state_bytes`; every stage gives stage 0's losses and
  parameters bit for bit (the update is elementwise on any slice), and
  stage 3 holds its ZeRO leaves as slices between steps;
- `group_sharded_parallel` over the sharding axis, and a ``{"sharding": 2,
  "mp": 2}`` mesh, train.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.analysis.ir import tiny_gpt_config
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.distributed.fleet.meta_parallel import (
    ColumnParallelLinear as JaxColumn, RowParallelLinear as JaxRow)
from paddle_tpu.distributed.mesh import init_mesh as jax_init_mesh
from paddle_tpu.distributed.mesh import set_mesh as jax_set_mesh
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss
from paddle_tpu.parallel import spmd as jspmd
from paddle_tpu_torch.distributed import group_sharded_parallel
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear)
from paddle_tpu_torch.distributed.mesh import build_mesh, set_mesh
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.parallel import spmd
from paddle_tpu_torch.parallel.spmd import make_sharded_train_step
from paddle_tpu_torch.weights import from_jax_state_dict
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

TIMEOUT, LR = 60, 0.01
DEG = {"dp": 2, "sharding": 2, "mp": 2}
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)


@pytest.fixture(scope="module")
def mesh():
    m = build_mesh(DEG, device="cpu", timeout=TIMEOUT)
    yield m
    m.close()


def teardown_module():
    jax_set_mesh(None)
    set_mesh(None)


def _gpt_batch():
    rs = np.random.RandomState(0)
    return (rs.randint(0, 64, (8, 16), dtype=np.int32),
            rs.randint(0, 64, (8, 16), dtype=np.int32))


_INIT = []


def _gpt_init():
    if not _INIT:
        paddle.seed(0)
        _INIT.append({k: np.asarray(v) for k, v in state_dict_arrays(
            JaxGPT(tiny_gpt_config()))[0].items()})
    return _INIT[0]


def _port_gpt():
    return from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"),
                               _gpt_init())


# -- the Adam MLP of test_distributed_spmd.py:131 ------------------------------


def _jax_mlp_run(degrees, zs):
    """test_distributed_spmd.py's MLP over `degrees`: (numpy weights,
    losses)."""

    class MLP(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = JaxColumn(16, 32, gather_output=False)
            self.fc2 = JaxRow(32, 4, input_is_parallel=True)
            self.act = jnn.ReLU()

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

    def loss_fn(out, labels):
        logp = jax.nn.log_softmax(out, -1)
        return -jnp.mean(jnp.take_along_axis(
            logp, labels[..., None].astype("int32"), -1))

    rs = np.random.RandomState(1)
    x = rs.rand(4, 16).astype(np.float32)
    y = rs.randint(0, 4, (4,))
    jmesh = jax_init_mesh(degrees)
    paddle.seed(0)
    net = MLP()
    init = {k: np.asarray(v) for k, v in state_dict_arrays(net)[0].items()}
    opt = paddle.optimizer.Adam(learning_rate=LR, parameters=net.parameters())
    P = jax.sharding.PartitionSpec
    step = jspmd.make_sharded_train_step(net, loss_fn, opt, jmesh,
                                         batch_specs=(P("dp"), P("dp")),
                                         zero_stage=zs)
    params, buffers, opt_state = step.init_state()
    losses = []
    for _ in range(3):
        xs, ys = step.shard_batch(x, y)
        loss, params, buffers, opt_state = step(
            params, buffers, opt_state, np.float32(LR),
            jax.random.PRNGKey(0), xs, ys)
        losses.append(float(np.asarray(loss)))
    return init, losses, (x, y)


def test_adam_mlp_at_dp2_mp2_sharding2_matches_jax(mesh):
    """The JAX test's MLP (ColumnParallelLinear -> ReLU ->
    RowParallelLinear, Adam 0.01, ZeRO-1): the port over dp2 x mp2 x
    sharding2 gives the JAX step's losses over the same mesh and one
    device's within the JAX test's 1e-4."""
    init, want, (x, y) = _jax_mlp_run(DEG, 1)
    _, one, _ = _jax_mlp_run({"dp": 1}, 0)
    net = torch.nn.Sequential(
        ColumnParallelLinear(16, 32, gather_output=False, device="cpu"),
        torch.nn.ReLU(),
        RowParallelLinear(32, 4, input_is_parallel=True, device="cpu"))
    with torch.no_grad():
        for port, jname in (("0", "fc1"), ("2", "fc2")):
            net.get_submodule(port).weight.copy_(
                torch.from_numpy(init[f"{jname}.weight"].T.copy()))
            net.get_submodule(port).bias.copy_(
                torch.from_numpy(init[f"{jname}.bias"].copy()))
    opt = Adam(learning_rate=LR, parameters=net.named_parameters())
    step = make_sharded_train_step(net, F.cross_entropy, opt, mesh,
                                   zero_stage=1)
    try:
        got = [step(x, y.astype(np.int64)) for _ in range(3)]
    finally:
        step.close()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, one, atol=1e-4)


# -- the layout rule -------------------------------------------------------------


def _jax_t(spec, linear):
    spec = tuple(spec)
    return spec[::-1] if linear else spec


@pytest.mark.parametrize("zs", [0, 1, 2, 3])
def test_layout_rule_answers_as_jax(zs):
    """`module_param_specs`, `_state_spec_like` and `grad_pspec` on GPT-tiny
    over dp2 x sharding2 x mp2 equal JAX's (a Linear weight's spec
    transposed); `_zero_shard_spec` on bare shapes too."""
    jmesh = jax_init_mesh(DEG)
    port_mesh = build_mesh(DEG, device="cpu")
    paddle.seed(0)
    jm = JaxGPT(tiny_gpt_config())
    model = _port_gpt()
    linear = spmd._linear_names(model)
    want = jspmd.module_param_specs(jm, jmesh, zs)
    got = spmd.module_param_specs(model, port_mesh, zs)
    named = jm.named_parameters_dict()
    assert set(got) == set(want)
    for k, p in model.named_parameters():
        lin = k in linear
        assert _jax_t(got[k], lin) == tuple(want[k]), (k, got[k], want[k])
        jshape = tuple(named[k].shape)
        slot = jnp.zeros(jshape)
        assert _jax_t(spmd._state_spec_like(got[k], p.shape, p, port_mesh,
                                            zs, lin), lin) == tuple(
            jspmd._state_spec_like(want[k], jshape, slot, jmesh, zs)), k
        assert _jax_t(spmd.grad_pspec(got[k], p.shape, port_mesh, zs, lin),
                      lin) == tuple(jspmd.grad_pspec(want[k], jshape, jmesh,
                                                     zs)), k
    for shape in ((64, 32), (32,), (256,), (3, 5), (512, 2), (2, 512)):
        j = jspmd._zero_shard_spec(shape, jmesh)
        assert spmd._zero_shard_spec(shape, port_mesh) == \
            (None if j is None else tuple(j)), shape


# -- ZeRO over the sharding axis -------------------------------------------------

_RUNS = {}


def _port_run(mesh, zs, steps=2):
    """GPT-tiny, AdamW, `steps` steps at stage `zs`: (losses, natural
    params, opt-state bytes a rank, parameter bytes a rank)."""
    if zs not in _RUNS:
        model = _port_gpt()
        opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
        step = make_sharded_train_step(model, gpt_loss_fn, opt, mesh,
                                       zero_stage=zs)
        try:
            losses = [step(*_gpt_batch()) for _ in range(steps)]
            _RUNS[zs] = (losses, step.gather_params(),
                         step.per_chip_opt_state_bytes(), step.param_bytes())
        finally:
            step.close()
    return _RUNS[zs]


@pytest.mark.parametrize("zs", [1, 2, 3])
def test_opt_state_bytes_a_rank_equal_jax(mesh, zs):
    """The optimizer state one rank holds at stages 1-3 (a leaf mp shards
    keeps its mp slice; a replicated leaf of at least degree * 128
    elements is cut over sharding; the rest is whole) equals JAX's
    `per_chip_opt_state_bytes` over the same mesh, and is below the
    unsharded figure."""
    jmesh = jax_init_mesh(DEG)
    paddle.seed(0)
    jm = JaxGPT(tiny_gpt_config())
    jopt = paddle.optimizer.AdamW(learning_rate=LR,
                                  parameters=jm.parameters())
    jstep = jspmd.make_sharded_train_step(jm, jax_gpt_loss, jopt, jmesh,
                                          zero_stage=zs)
    params, buffers, opt_state = jstep.init_state()
    _, params, buffers, opt_state = jstep(
        params, buffers, opt_state, jnp.float32(LR), jax.random.PRNGKey(0),
        *jstep.shard_batch(*_gpt_batch()))
    want = jspmd.per_chip_opt_state_bytes(opt_state)
    got = _port_run(mesh, zs)[2]
    assert got == [want] * mesh.size, (got, want)
    assert want < _port_run(mesh, 0)[2][0]


def test_every_stage_gives_stage0_bit_for_bit(mesh):
    """The update is elementwise, so a sharding slice's update is the
    whole leaf's: stages 1-3 give stage 0's losses and gathered parameters
    bit for bit; stage 3 holds its ZeRO leaves as slices between steps
    (fewer parameter bytes a rank), stages 1 and 2 whole."""
    base = _port_run(mesh, 0)
    for zs in (1, 2, 3):
        got = _port_run(mesh, zs)
        assert got[0] == base[0], zs
        for k in base[1]:
            assert torch.equal(got[1][k], base[1][k]), (zs, k)
    assert _port_run(mesh, 1)[3] == base[3]
    assert all(s3 < s0 for s3, s0 in zip(_port_run(mesh, 3)[3], base[3]))


def test_group_sharded_stage3_over_the_sharding_axis(mesh):
    """`group_sharded_parallel(level="p_g_os")` with the mesh installed:
    `shard_parameters_over` annotates each parameter over the sharding
    degree (the mp layers' keep their mp annotation), and the step holds
    those as slices; the losses are stage 0's."""
    set_mesh(mesh)
    try:
        model = _port_gpt()
        opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
        wrapped, wopt, _ = group_sharded_parallel(model, opt, "p_g_os")
        axes = {n: getattr(p, "sharding_axes", None)
                for n, p in model.named_parameters()}
        assert "sharding" in axes["wpe.weight"]
        assert axes["wte.weight"] == ("mp", None)
        step = make_sharded_train_step(wrapped, gpt_loss_fn, wopt, mesh,
                                       zero_stage=3)
        try:
            got = [step(*_gpt_batch()) for _ in range(2)]
            held = step.param_bytes()
        finally:
            step.close()
    finally:
        set_mesh(None)
    assert got == _port_run(mesh, 0)[0]
    assert all(h < b for h, b in zip(held, _port_run(mesh, 0)[3]))


def test_an_mp_and_sharding_mesh_trains():
    """``{"sharding": 2, "mp": 2}`` builds on four CPU ranks and trains
    at stage 2 as one process does."""
    m = build_mesh({"sharding": 2, "mp": 2}, device="cpu", timeout=TIMEOUT)
    one = build_mesh({"dp": 1}, device="cpu")
    try:
        out = []
        for mesh in (m, one):
            model = _port_gpt()
            opt = AdamW(learning_rate=LR,
                        parameters=model.named_parameters())
            step = make_sharded_train_step(model, gpt_loss_fn, opt, mesh,
                                           zero_stage=2)
            out.append([step(*_gpt_batch()) for _ in range(2)])
            step.close()
        assert m.groups and set(m.groups) == {"sharding", "mp"}
    finally:
        m.close()
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5)


def test_rows_split_over_dp_and_sharding(mesh):
    """``batch_specs`` naming ``("dp", "sharding")`` splits the rows over
    both axes (four row shares on this mesh; the mp peers of a share hold
    the same rows) and sums the gradients over both groups: the losses of
    one process on the whole batch."""
    out = []
    for m, specs in ((mesh, (("dp", "sharding"),) * 2),
                     (build_mesh({"dp": 1}, device="cpu"), None)):
        model = _port_gpt()
        opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
        step = make_sharded_train_step(model, gpt_loss_fn, opt, m,
                                       batch_specs=specs, zero_stage=1)
        try:
            out.append([step(*_gpt_batch()) for _ in range(2)])
            rows = step.shard_batch(*_gpt_batch())
        finally:
            step.close()
        if m is mesh:
            # rank r's rows: share dp * 2 + sharding of four, mp peers alike
            ids = _gpt_batch()[0]
            for r in range(mesh.size):
                c = mesh.coords(r)
                share = c["dp"] * 2 + c["sharding"]
                assert np.array_equal(rows[r][0], ids[2 * share:
                                                      2 * share + 2])
    np.testing.assert_allclose(out[0], out[1], rtol=1e-5)


def test_localsgd_over_a_hybrid_mesh_is_refused(mesh):
    """LocalSGD over a hybrid mesh is no longer refused: it runs as the
    JAX step does over any mesh, the replicas on dp (each replica's
    Megatron layers sharded over its mp group, the sharding peers holding
    it whole). At k=2 the two replicas differ after the first step and
    agree after the second (test_torch_meta_optimizers.py holds it
    against the pure-dp trajectory)."""
    from paddle_tpu_torch.parallel.spmd import LocalSGDTrainStep

    model = _port_gpt()
    opt = AdamW(learning_rate=LR, parameters=model.named_parameters())
    step = LocalSGDTrainStep(model, gpt_loss_fn, opt, mesh, k_steps=2)
    try:
        spreads = []
        for _ in range(2):
            assert np.isfinite(step(*_gpt_batch()))
            w = step.replica_params()["blocks.0.fc1.weight"].numpy()
            assert w.shape[0] == DEG["dp"]
            spreads.append(np.abs(w - w.mean(0, keepdims=True)).max())
    finally:
        step.close()
    assert spreads[0] > 1e-6 and spreads[1] < 1e-6, spreads
