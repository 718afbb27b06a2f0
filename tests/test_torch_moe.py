"""The port's Mixture of Experts (distributed/moe.py) and expert
parallelism on the hybrid train step (parallel/spmd.py) against the JAX
package's `paddle_tpu.distributed.moe`, on the CPU.

Inputs are made from numpy seeds; the JAX layers are built from
``paddle.seed`` and their weights carried into the port
(`weights.from_jax_state_dict`: the MoE leaves cross as they are). Every
comparison is float32:

- `_dense_dispatch` equals the JAX one exactly, on random routes and on
  `tests/test_pipeline_moe.py`'s overflow case;
- `MoELayer`'s output, Switch loss and the gradients of x, the router,
  w1, b1, w2 and b2 are within 1e-5 of the JAX layer's for each gate, at
  capacity factors 1.25 and 0.5. The routes are asserted equal first,
  and the data is asserted free of near-ties (the smallest top-1 margin
  above 1e-4): a tie is a property of the data, not a tolerance. The
  indexed dispatch and combine equal the dense einsum form;
- `moe_alltoall_block` over gloo thread ranks: the JAX shard_map block of
  `tests/test_pipeline_moe.py:103` ({"mp": 4}, replicated tokens) and
  `__graft_entry__.py`'s config C ({"mp": 2} beside dp 2) within 1e-5,
  loss and the gradients of w1 and w2 (the JAX output's ``P()`` makes the
  ranks' outputs one value, so each rank's loss is its 1/n share of it);
  with tokens of each rank's own and two experts a rank, within 1e-5 of
  `jax.grad` through the dense form over every rank's tokens;
- the hybrid step (`make_sharded_train_step`) of the Motivation's probe,
  ``Linear(8, 16) -> MoELayer(16, 32, 4, "switch") -> Linear(16, 4)``,
  MSE, SGD 0.1, 3 steps over {"mp": 2}, {"mp": 4}, {"dp": 2, "mp": 2}
  and {"sharding": 2, "mp": 2} at stage 2, at capacity factors 1.25 and
  0.5: the JAX GSPMD step's losses within 1e-5 relative and every
  parameter within 1e-5 of its norm. At 0.5 half the tokens overflow, and
  at dp 2 the overflow is decided over the global batch. Each rank's
  calls equal `moe_collective_budget`, each holds 1/mp of the experts'
  bytes, and experts on another axis than mp are refused;
- the same probe with ColumnParallelLinear -> ReLU -> RowParallelLinear
  before the MoE layer over {"dp": 2, "mp": 2}: the JAX step's losses and
  parameters, and calls equal to `hybrid_collective_budget`'s sum of the
  mp layers', MoE's and the data group's terms;
- over {"dp": 2}, JAX's explicit ZeRO path (shard_map) and its LocalSGD
  step (vmap) route each dp shard alone: the port's explicit path and
  LocalSGD give their losses and parameters within 1e-5 at capacity
  factors 1.25 and 0.5;
- `spmd.run_on_ranks` runs a share's calls on every rank.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.distributed import moe as jmoe
from paddle_tpu.distributed.fleet.meta_parallel import (
    ColumnParallelLinear as JaxColumn, RowParallelLinear as JaxRow)
from paddle_tpu.distributed.mesh import init_mesh as jax_init_mesh
from paddle_tpu.distributed.mesh import set_mesh as jax_set_mesh
from paddle_tpu.parallel import spmd as jspmd
from paddle_tpu.parallel._compat import shard_map
from paddle_tpu_torch.distributed import moe
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear)
from paddle_tpu_torch.distributed.mesh import build_mesh
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.parallel import collectives, spmd
from paddle_tpu_torch.parallel.spmd import (LocalSGDTrainStep,
                                            hybrid_collective_budget,
                                            make_sharded_train_step,
                                            moe_collective_budget)
from paddle_tpu_torch.weights import (from_jax_state_dict,
                                      to_jax_state_dict, to_jax_train_state)
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)
from test_torch_pipeline import run_mesh

TOL, MARGIN, LR, STEPS, TIMEOUT = 1e-5, 1e-4, 0.1, 3, 60
GATES = ("naive", "switch", "gshard")


def teardown_module():
    jax_set_mesh(None)


def _margin(gates):
    """The smallest gap between a token's top router probability and its
    second."""
    top2 = np.sort(np.asarray(gates), -1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def _jax_gates(x, gw):
    return np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(gw), -1))


# -- the dispatch -------------------------------------------------------------


@pytest.mark.parametrize("T,E,cf,seed", [(16, 4, 1.25, 0), (48, 4, 0.5, 1),
                                         (33, 3, 1.0, 2), (64, 8, 2.0, 3)])
def test_dense_dispatch_equals_jax(T, E, cf, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(T, 8).astype(np.float32)
    gates = _jax_gates(x, rs.randn(8, E).astype(np.float32))
    assert _margin(gates) > MARGIN
    cap = moe.expert_capacity(cf, T, E)
    assert cap == int(np.ceil(cf * T / E))
    want = jmoe._dense_dispatch(jnp.asarray(x), jnp.asarray(gates), cap)
    got = moe._dense_dispatch(torch.from_numpy(x), torch.from_numpy(gates),
                              cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dense_dispatch_drops_the_overflow_as_jax():
    """`tests/test_pipeline_moe.py:136`: eight tokens all routed to expert
    0 at capacity 2 dispatch the first two and drop the rest."""
    T, E, cap = 8, 2, 2
    x = np.ones((T, 4), np.float32)
    gates = np.tile(np.asarray([[0.9, 0.1]], np.float32), (T, 1))
    want = jmoe._dense_dispatch(jnp.asarray(x), jnp.asarray(gates), cap)
    got = moe._dense_dispatch(torch.from_numpy(x), torch.from_numpy(gates),
                              cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[1].sum()) == pytest.approx(cap * 0.9)
    _, slot, keep, prob = moe.route(torch.from_numpy(gates), cap)
    assert slot.tolist() == list(range(T))
    assert keep.sum() == cap and float(prob[cap:].abs().sum()) == 0.0


# -- the layer ----------------------------------------------------------------


def _jax_layer(gate, cf, seed=0, shape=(2, 12, 16)):
    """The JAX MoELayer(16, 32, 4) from paddle.seed(seed): its weights,
    output, aux loss and the gradients of ``sum(out * dO) + aux / 2``
    (x's under "x")."""
    paddle.seed(seed)
    layer = jmoe.MoELayer(16, 32, 4, gate=gate, capacity_factor=cf)
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    do = rs.randn(*shape).astype(np.float32)
    weights = {k: np.asarray(v)
               for k, v in state_dict_arrays(layer)[0].items()}
    xt = paddle.to_tensor(x)
    xt.stop_gradient = False
    out = layer(xt)
    loss = (out * paddle.to_tensor(do)).sum() + layer.aux_loss * 0.5
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy())
             for n, p in layer.named_parameters()}
    grads["x"] = np.asarray(xt.grad.numpy())
    return (weights, x, do, np.asarray(out.numpy()),
            float(np.asarray(layer.aux_loss.numpy())), grads)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("gate", GATES)
def test_layer_forward_and_backward_match_jax(gate, cf):
    weights, x, do, want, want_aux, want_g = _jax_layer(gate, cf)
    layer = from_jax_state_dict(
        moe.MoELayer(16, 32, 4, gate=gate, capacity_factor=cf,
                     device="cpu"), weights)
    flat = x.reshape(-1, 16)
    gates = _jax_gates(flat, weights["gate.gate"])
    assert _margin(gates) > MARGIN
    port_gates = layer.gate.gate_fn(torch.from_numpy(flat))
    np.testing.assert_array_equal(port_gates.argmax(-1).numpy(),
                                  gates.argmax(-1))
    xt = torch.tensor(x, requires_grad=True)
    out = layer(xt)
    (out * torch.from_numpy(do)).sum().add(layer.aux_loss * 0.5).backward()
    np.testing.assert_allclose(out.detach().numpy(), want, atol=TOL,
                               rtol=TOL)
    assert float(layer.aux_loss.detach()) == pytest.approx(want_aux,
                                                          rel=TOL)
    got_g = {n: p.grad.numpy() for n, p in layer.named_parameters()}
    got_g["x"] = xt.grad.numpy()
    assert set(got_g) == set(want_g)
    for n, w in want_g.items():
        np.testing.assert_allclose(got_g[n], w, atol=TOL, rtol=TOL,
                                   err_msg=n)
    # the tokens over capacity are dropped: no output at all
    cap = moe.expert_capacity(cf, flat.shape[0], 4)
    _, _, keep, _ = moe.route(torch.from_numpy(gates), cap)
    dropped = ~keep.numpy()
    assert dropped.any() or cf > 1
    np.testing.assert_array_equal(want.reshape(-1, 16)[dropped], 0.0)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_indexed_form_equals_the_dense_einsum_form(cf):
    """The layer's indexed dispatch and combine against `dense_moe` (the
    one-hot einsums) on the same weights: the output and every gradient
    within 1e-6 (a sum of zeros and one product is that product)."""
    torch.manual_seed(3)
    layer = moe.MoELayer(16, 32, 4, gate="switch", capacity_factor=cf,
                         device="cpu", seed=5)
    x = torch.randn(48, 16, requires_grad=True)
    do = torch.randn(48, 16)
    (layer(x) * do).sum().backward()
    got = {n: p.grad.clone() for n, p in layer.named_parameters()}
    got["x"], got["out"] = x.grad.clone(), layer(x).detach()
    layer.zero_grad()
    x.grad = None
    gates = layer.gate.gate_fn(x)
    assert _margin(gates.detach().numpy()) > MARGIN
    ref = moe.dense_moe(x, gates, layer.w1, layer.b1, layer.w2, layer.b2,
                        moe.expert_capacity(cf, 48, 4))
    (ref * do).sum().backward()
    want = {n: p.grad for n, p in layer.named_parameters()}
    want["x"], want["out"] = x.grad, ref.detach()
    for n, w in want.items():
        torch.testing.assert_close(got[n], w, atol=1e-6, rtol=1e-6,
                                   msg=n)


def test_layer_init_follows_the_jax_initialisers():
    """Xavier-uniform bounds of the JAX package (the stacked weights' fans
    ``in * out`` and ``E * out``), zero biases, annotations on dim 0."""
    layer = moe.MoELayer(16, 32, 4, device="cpu")
    for name, fans in (("w1", 16 * 32 + 4 * 32), ("w2", 32 * 16 + 4 * 16),
                       ("gate.gate", 16 + 4)):
        w = layer.get_parameter(name)
        limit = np.sqrt(6.0 / fans)
        assert float(w.abs().max()) <= limit
        assert float(w.abs().max()) > 0.8 * limit
    assert float(layer.b1.abs().sum() + layer.b2.abs().sum()) == 0.0
    assert layer.w1.sharding_axes == ("mp", None, None)
    assert layer.b2.sharding_axes == ("mp", None)
    assert set(layer.mp_dims) == {"w1", "b1", "w2", "b2"}
    assert moe.MoELayer(16, 32, 4, ep_axis="dp", device="cpu").mp_dims == {}
    sd = to_jax_state_dict(layer)
    assert sd["w1"].shape == (4, 16, 32) and sd["gate.gate"].shape == (16, 4)


def test_a_layer_that_ran_copies_as_a_skeleton():
    """A train step copies its model as a skeleton (`nn.layer.meta_copy`);
    the last forward's Switch loss, a graph's output, is not copied."""
    from paddle_tpu_torch.nn.layer import meta_copy

    layer = moe.MoELayer(16, 32, 4, gate="switch", device="cpu")
    layer(torch.randn(2, 3, 16)).sum().backward()
    assert layer.aux_loss.grad_fn is not None
    copy = meta_copy(layer)
    assert copy.aux_loss is None and copy.w1.is_meta
    assert copy.w1.sharding_axes == ("mp", None, None)


# -- the all-to-all block -----------------------------------------------------


def _a2a_inputs(T, H, F_, E, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(T, H).astype(np.float32)
    gw = (rs.rand(H, E) * 0.1).astype(np.float32)
    w1 = (rs.rand(E, H, F_) * 0.1).astype(np.float32)
    w2 = (rs.rand(E, F_, H) * 0.1).astype(np.float32)
    return x, gw, w1, np.zeros((E, F_), np.float32), w2, \
        np.zeros((E, H), np.float32)


def _jax_block(degrees, args):
    """The JAX shard_map block over `degrees` (experts on mp, everything
    else replicated): out, and the loss sum(out ** 2) with its gradients
    of w1 and w2 (`__graft_entry__.py`'s config C)."""
    mesh = jax_init_mesh(degrees)
    x, gw, w1, b1, w2, b2 = map(jnp.asarray, args)
    fn = shard_map(
        lambda x_, gw_, w1_, b1_, w2_, b2_: jmoe.moe_alltoall_block(
            x_, gw_, w1_, b1_, w2_, b2_, mesh, "mp"),
        mesh=mesh, in_specs=(P(), P(), P("mp"), P("mp"), P("mp"), P("mp")),
        out_specs=P(), check_vma=False)

    def loss(w1_, w2_):
        return jnp.sum(fn(x, gw, w1_, b1, w2_, b2) ** 2)

    out = jax.jit(fn)(x, gw, w1, b1, w2, b2)
    value, (g1, g2) = jax.jit(jax.value_and_grad(loss, (0, 1)))(w1, w2)
    jax_set_mesh(None)
    return np.asarray(out), float(value), np.asarray(g1), np.asarray(g2)


def _port_block(tmp_path, degrees, args, share=1.0):
    """`moe_alltoall_block` on every rank of a thread mesh of `degrees`
    over its mp group: each rank's (out, loss, dw1, dw2 of its experts,
    all-to-all calls), the loss scaled by `share` before the backward."""
    def rank(m):
        g = m.axis_group("mp")
        r, n = g.rank, g.size
        x, gw, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args[r])
        x.requires_grad_()
        e = w1.shape[0] // n
        mine = [t[r * e:(r + 1) * e].clone().requires_grad_()
                for t in (w1, b1, w2, b2)]
        before = moe.all_to_all.calls
        out = moe.moe_alltoall_block(x, gw, *mine, g)
        fwd = moe.all_to_all.calls - before
        loss = (out ** 2).sum()
        (loss * share).backward()
        return (out.detach().numpy(), float(loss.detach()),
                mine[0].grad.numpy(), mine[2].grad.numpy(), fwd)

    return run_mesh(tmp_path, degrees, rank)


@pytest.mark.parametrize("case", ["pipeline_moe", "graft_config_c"])
def test_alltoall_block_matches_the_jax_shard_map(tmp_path, case):
    """Replicated tokens, one expert a rank: every rank's output equals
    the JAX block's and the dense form's; each rank's 1/n share of the
    loss gives the JAX gradients of its experts (the JAX output is one
    value over the n ranks). Counted: two all-to-alls a forward (the
    per-thread counters are the process's, so the calls are taken over
    the mesh)."""
    if case == "pipeline_moe":
        jdeg, pdeg, H, F_, E, T = {"mp": 4}, {"mp": 4}, 16, 32, 4, 64
    else:
        jdeg, pdeg = {"mp": 2, "dp": 4}, {"dp": 2, "mp": 2}
        H, F_, E, T = 16, 32, 2, 64
    args = _a2a_inputs(T, H, F_, E)
    assert _margin(_jax_gates(args[0], args[1])) > MARGIN
    out, value, g1, g2 = _jax_block(jdeg, args)
    x, gw, w1, b1, w2, b2 = map(torch.from_numpy, args)
    dense = moe.dense_moe(x, torch.softmax(x @ gw, -1), w1, b1, w2, b2,
                          moe.expert_capacity(1.25, T, E))
    np.testing.assert_allclose(out, dense.numpy(), atol=TOL, rtol=TOL)
    n = pdeg["mp"]
    before = moe.all_to_all.calls
    got = _port_block(tmp_path, pdeg, [args] * (n * pdeg.get("dp", 1)),
                      share=1.0 / n)
    size = n * pdeg.get("dp", 1)
    assert moe.all_to_all.calls - before == 4 * size
    e = E // n
    for r, (o, loss, d1, d2, _) in enumerate(got):
        m = r % n
        np.testing.assert_allclose(o, out, atol=TOL, rtol=TOL)
        assert loss == pytest.approx(value, rel=TOL)
        np.testing.assert_allclose(d1, g1[m * e:(m + 1) * e], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(d2, g2[m * e:(m + 1) * e], atol=TOL,
                                   rtol=TOL)


def test_alltoall_block_with_tokens_of_each_rank_and_two_experts_a_rank(
        tmp_path):
    """Each of 2 ranks routes its own 64 tokens over 4 experts (two a
    rank): its output is the dense form of its tokens at its own
    capacity, and its experts' gradients are `jax.grad`'s of the summed
    loss over both ranks' tokens through the JAX dense dispatch."""
    H, F_, E, T, n = 16, 32, 4, 64, 2
    shared = list(_a2a_inputs(T, H, F_, E, seed=4))
    shared[1] = np.random.RandomState(5).randn(H, E).astype(np.float32)
    xs = [np.random.RandomState(10 + r).randn(T, H).astype(np.float32)
          for r in range(n)]
    gw, w1, b1, w2, b2 = map(jnp.asarray, shared[1:])
    for x in xs:
        assert _margin(_jax_gates(x, shared[1])) > MARGIN
    cap = int(np.ceil(1.25 * T / E))

    def dense(x, w1_, w2_):
        gates = jax.nn.softmax(x @ gw, -1)
        disp, comb = jmoe._dense_dispatch(x, gates, cap)
        h = jax.nn.gelu(jnp.einsum("ech,ehf->ecf", disp, w1_) + b1[:, None])
        eout = jnp.einsum("ecf,efh->ech", h, w2_) + b2[:, None]
        return jnp.einsum("tec,ech->th", comb, eout)

    def loss(w1_, w2_):
        return sum(jnp.sum(dense(jnp.asarray(x), w1_, w2_) ** 2) for x in xs)

    g1, g2 = jax.grad(loss, (0, 1))(w1, w2)
    got = _port_block(tmp_path, {"mp": n},
                      [(x,) + tuple(shared[1:]) for x in xs])
    for r, (o, _, d1, d2, _) in enumerate(got):
        want = np.asarray(dense(jnp.asarray(xs[r]), w1, w2))
        np.testing.assert_allclose(o, want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(d1, np.asarray(g1)[2 * r:2 * r + 2],
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(d2, np.asarray(g2)[2 * r:2 * r + 2],
                                   atol=TOL, rtol=TOL)


# -- the hybrid step ----------------------------------------------------------

MESHES = {"mp2": ({"mp": 2}, 0), "mp4": ({"mp": 4}, 0),
          "dp2mp2": ({"dp": 2, "mp": 2}, 0),
          "sharding2mp2": ({"sharding": 2, "mp": 2}, 2)}
# the shard-local paths' mesh (pure dp: the explicit path at stage 2), and
# the GSPMD step on it (JAX only)
DP2 = {"dp2": ({"dp": 2}, 2), "dp2_gspmd": ({"dp": 2}, 0)}


@pytest.fixture(scope="module")
def meshes():
    made = {}

    def get(key):
        if key not in made:
            made[key] = build_mesh({**MESHES, **DP2}[key][0], device="cpu",
                                   timeout=TIMEOUT)
        return made[key]

    yield get
    for m in made.values():
        m.close()


def _probe_batch():
    rs = np.random.RandomState(0)
    return (rs.randn(8, 6, 8).astype(np.float32),
            rs.randn(8, 6, 4).astype(np.float32))


def _jax_mse(out, y):
    return jnp.mean((out - y) ** 2)


_JAX = {}


def _jax_probe_net(cf, mixed=False):
    """The probe; `mixed` puts ColumnParallelLinear(16, 32) -> ReLU ->
    RowParallelLinear(32, 16) between the first Linear and the MoE
    layer."""
    paddle.seed(0)
    mp = [JaxColumn(16, 32, gather_output=False), jnn.ReLU(),
          JaxRow(32, 16, input_is_parallel=True)] if mixed else []
    net = jnn.Sequential(jnn.Linear(8, 16), *mp,
                         jmoe.MoELayer(16, 32, 4, gate="switch",
                                       capacity_factor=cf),
                         jnn.Linear(16, 4))
    init = {k: np.asarray(v) for k, v in state_dict_arrays(net)[0].items()}
    opt = paddle.optimizer.SGD(learning_rate=LR, parameters=net.parameters())
    return net, opt, init


def _router_margin(p, x, mixed=False):
    """The smallest top-1 margin of the router on rows `x` under the JAX
    params `p`."""
    h = x.reshape(-1, 8) @ p["0.weight"] + p["0.bias"]
    if mixed:
        h = np.maximum(h @ p["1.weight"] + p["1.bias"], 0)
        h = h @ p["3.weight"] + p["3.bias"]
    return _margin(_jax_gates(h, p[f"{4 if mixed else 1}.gate.gate"]))


def _jax_probe(key, cf, mixed=False):
    """The Motivation's probe on the JAX GSPMD step: (initial weights,
    losses, natural params, the smallest routing margin over the steps)."""
    if (key, cf, mixed) not in _JAX:
        degrees, zs = {**MESHES, **DP2}[key]
        jmesh = jax_init_mesh(degrees)
        net, opt, init = _jax_probe_net(cf, mixed)
        step = jspmd.make_sharded_train_step(
            net, _jax_mse, opt, jmesh, batch_specs=(P("dp"), P("dp")),
            zero_stage=zs)
        params, buffers, state = step.init_state()
        x, y = _probe_batch()
        losses, margin = [], np.inf
        for _ in range(STEPS):
            p = {k: np.asarray(v) for k, v in params.items()}
            margin = min(margin, _router_margin(p, x, mixed))
            loss, params, buffers, state = step(
                params, buffers, state, jnp.float32(LR),
                jax.random.PRNGKey(0), *step.shard_batch(x, y))
            losses.append(float(np.asarray(loss)))
        _JAX[key, cf, mixed] = (init, losses,
                                {k: np.asarray(v) for k, v in params.items()},
                                margin)
    return _JAX[key, cf, mixed]


def _probe_net(init, cf, ep_axis="mp", mixed=False):
    mp = [ColumnParallelLinear(16, 32, gather_output=False, device="cpu"),
          torch.nn.ReLU(),
          RowParallelLinear(32, 16, input_is_parallel=True,
                            device="cpu")] if mixed else []
    net = torch.nn.Sequential(
        torch.nn.Linear(8, 16), *mp,
        moe.MoELayer(16, 32, 4, gate="switch", capacity_factor=cf,
                     ep_axis=ep_axis, device="cpu"),
        torch.nn.Linear(16, 4))
    return net if init is None else from_jax_state_dict(net, init)


def _probe_step(mesh, init, cf, zs):
    net = _probe_net(init, cf)
    opt = SGD(learning_rate=LR, parameters=net.named_parameters())
    return make_sharded_train_step(net, F.mse_loss, opt, mesh,
                                   zero_stage=zs)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("key", list(MESHES))
def test_hybrid_step_matches_the_jax_gspmd_step(meshes, key, cf):
    init, want, jparams, margin = _jax_probe(key, cf)
    assert margin > MARGIN
    degrees, zs = MESHES[key]
    mesh = meshes(key)
    step = _probe_step(mesh, init, cf, zs)
    try:
        step.rank_reports(zero=True)
        got = [step(*_probe_batch()) for _ in range(STEPS)]
        counts = step.collective_counts()
        params, _, _ = to_jax_train_state(step)
        held = step.param_bytes()
        zero_leaves = sum(zs_ is not None for _, _, zs_ in
                          spmd.leaf_layouts(step.model, mesh, zs).values())
        n_leaves = len(step.names)
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert set(params) == set(jparams)
    for k, w in jparams.items():
        err = np.linalg.norm(params[k] - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= TOL, (k, err)
    mp, dp = degrees.get("mp", 1), degrees.get("dp", 1)
    budget = moe_collective_budget(1, mp, (dp,), n_leaves, zero_leaves)
    for c in counts:
        assert c == {k: STEPS * v for k, v in budget.items()}, (c, budget)
    # every rank holds 1/mp of the experts and the rest whole
    net = _probe_net(init, cf)
    experts = sum(p.numel() * 4 for n, p in net.named_parameters()
                  if n.split(".")[1] in ("w1", "b1", "w2", "b2"))
    whole = sum(p.numel() * 4 for p in net.parameters())
    assert held == [whole - experts + experts // mp] * mesh.size


def test_row_share_slots_follow_the_lower_shares(meshes):
    """At dp 2 and capacity factor 0.5, routing each share's tokens alone
    (the local capacity) gives other losses than the global routing the
    JAX step takes: the step's losses are the global ones."""
    init, want, _, _ = _jax_probe("dp2mp2", 0.5)
    net = _probe_net(init, 0.5)
    x, y = _probe_batch()
    local = []
    with torch.no_grad():
        for half in (slice(0, 4), slice(4, 8)):
            out = net(torch.from_numpy(x[half]))
            local.append(float(F.mse_loss(out, torch.from_numpy(y[half]))))
    assert abs(np.mean(local) - want[0]) > 1e-4


def _jax_localsgd(cf, k):
    """The probe on the JAX `LocalSGDTrainStep` over {"dp": 2} (vmap over
    the replicas): (losses, each replica's params, the smallest routing
    margin over the steps and replicas)."""
    if ("localsgd", cf, k) not in _JAX:
        jmesh = jax_init_mesh({"dp": 2})
        net, opt, _ = _jax_probe_net(cf)
        step = jspmd.LocalSGDTrainStep(net, _jax_mse, opt, jmesh, k_steps=k)
        params, buffers, state, count = step.init_state()
        x, y = _probe_batch()
        losses, margin = [], np.inf
        for _ in range(STEPS):
            for r, half in enumerate((slice(0, 4), slice(4, 8))):
                p = {n: np.asarray(v[r]) for n, v in params.items()}
                margin = min(margin, _router_margin(p, x[half]))
            loss, params, buffers, state, count = step(
                params, buffers, state, count, np.float32(LR),
                jax.random.PRNGKey(0), *step.shard_batch(x, y))
            losses.append(float(np.asarray(loss)))
        _JAX["localsgd", cf, k] = (
            losses, {n: np.asarray(v) for n, v in params.items()}, margin)
    return _JAX["localsgd", cf, k]


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("path", ["explicit", "localsgd"])
def test_shard_local_paths_route_each_shard_as_jax(meshes, path, cf):
    """Over {"dp": 2}, JAX's explicit ZeRO path (a shard_map, taken by
    default at stage 2) and its LocalSGD step (a vmap over the replicas)
    route each dp shard's tokens alone: capacity from the shard's tokens,
    slots from 0. The port's explicit path and LocalSGD (k 2, so the
    replicas differ after the third step) give the same losses within
    1e-5 relative and the same parameters within 1e-5 of their norm, at
    capacity factors 1.25 and 0.5. The shard-local routing is not the
    GSPMD step's: the JAX explicit losses differ from its stage-0 ones."""
    init = _jax_probe("dp2", cf)[0]
    net = _probe_net(init, cf)
    opt = SGD(learning_rate=LR, parameters=net.named_parameters())
    mesh = meshes("dp2")
    if path == "explicit":
        _, want, jparams, margin = _jax_probe("dp2", cf)
        step = make_sharded_train_step(net, F.mse_loss, opt, mesh,
                                       zero_stage=2)
        assert step.explicit_update
    else:
        want, jparams, margin = _jax_localsgd(cf, 2)
        step = LocalSGDTrainStep(net, F.mse_loss, opt, mesh, k_steps=2)
    assert margin > MARGIN
    try:
        got = [step(*_probe_batch()) for _ in range(STEPS)]
        if path == "explicit":
            params = to_jax_train_state(step)[0]
        else:
            params = {n: v.numpy() for n, v in step.replica_params().items()}
            for n in ("0.weight", "2.weight"):
                params[n] = params[n].transpose(0, 2, 1)
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert set(params) == set(jparams)
    for k, w in jparams.items():
        err = np.linalg.norm(params[k] - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= TOL, (k, err)
    assert abs(want[0] - _jax_probe("dp2_gspmd", cf)[1][0]) > 1e-4


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_megatron_layers_beside_moe_match_jax_and_the_summed_budget(
        meshes, cf):
    """Linear -> ColumnParallelLinear -> ReLU -> RowParallelLinear ->
    MoELayer -> Linear over {"dp": 2, "mp": 2}: the JAX GSPMD step's
    losses within 1e-5 relative and parameters within 1e-5 of their norm,
    and each rank's calls equal `hybrid_collective_budget` with the mp
    layers' two all-reduces (the column-parallel input's gradient, the
    row-parallel output) beside the MoE layer's and the data group's."""
    init, want, jparams, margin = _jax_probe("dp2mp2", cf, mixed=True)
    assert margin > MARGIN
    mesh = meshes("dp2mp2")
    net = _probe_net(init, cf, mixed=True)
    opt = SGD(learning_rate=LR, parameters=net.named_parameters())
    step = make_sharded_train_step(net, F.mse_loss, opt, mesh)
    try:
        step.rank_reports(zero=True)
        got = [step(*_probe_batch()) for _ in range(STEPS)]
        counts = step.collective_counts()
        params, _, _ = to_jax_train_state(step)
        n_leaves = len(step.names)
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=TOL)
    for k, w in jparams.items():
        err = np.linalg.norm(params[k] - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= TOL, (k, err)
    budget = hybrid_collective_budget(n_leaves, (2,), mp_degree=2,
                                      mp_calls=(2, 0), moe_layers=1)
    assert budget["all-reduce"] == 1 + n_leaves + 2 + 2
    for c in counts:
        assert c == {k: STEPS * v for k, v in budget.items()}, (c, budget)


def test_budget_arithmetic():
    b = moe_collective_budget(2, 2, (2, 2), 10, 3)
    assert b == {"all-reduce": 4 + 2 * 11, "all-gather": 4 + 3,
                 "reduce-scatter": 0, "all-to-all": 0, "send": 0,
                 "recv": 0}
    assert moe_collective_budget(1, 1, (1,), 5) == dict(
        b, **{"all-reduce": 0, "all-gather": 0})
    # each feature's term adds: the mp layers', MoE's, the ring's and
    # the data groups' (two row axes and sp)
    assert hybrid_collective_budget(
        10, (2, 2), sp_degree=2, ring_layers=3, mp_degree=2,
        mp_calls=(7, 1), moe_layers=2, n_zero_leaves=3) == {
            "all-reduce": 3 * 11 + 7 + 4, "all-gather": 4 + 3 + 1,
            "reduce-scatter": 0, "all-to-all": 0, "send": 9, "recv": 9}
    assert hybrid_collective_budget(10, (2,), mp_degree=1,
                                    mp_calls=(7, 1), moe_layers=2) == dict(
        b, **{"all-reduce": 11, "all-gather": 2})


class _RankShare:
    """`run_on_ranks`' share in the test below: each rank's rank and the
    sum over the mesh of ``(rank + 1) * scale``."""

    JOB_OPS = frozenset(("total",))

    def __init__(self, spec, mesh):
        self.mesh = mesh

    def total(self, scale):
        t = torch.full((1,), (self.mesh.rank + 1) * float(scale))
        collectives.all_reduce(t, self.mesh.group)
        return self.mesh.rank, float(t)


def test_run_on_ranks_runs_each_call_on_every_rank(meshes):
    """`run_on_ranks` builds the share on every rank with nothing to
    load, runs each call on every rank in turn (rank order) and drops the
    share: a later job over the same ranks still runs."""
    mesh = meshes("dp2")
    first, second = spmd.run_on_ranks(mesh, _RankShare, ("total", 1),
                                      ("total", 2.5))
    assert first == [(0, 3.0), (1, 3.0)]
    assert second == [(0, 7.5), (1, 7.5)]
    again, = spmd.run_on_ranks(mesh, _RankShare, ("total", -1))
    assert again == [(0, -3.0), (1, -3.0)]


def test_experts_on_another_axis_are_refused(meshes):
    """ep_axis "dp" over dp 2 raises naming item 8b.5; over a mesh where
    that axis is 1 the layer runs as one process."""
    init = _jax_probe("dp2mp2", 1.25)[0]
    net = _probe_net(init, 1.25, ep_axis="dp")
    opt = SGD(learning_rate=LR, parameters=net.named_parameters())
    with pytest.raises(NotImplementedError, match="8b.5"):
        make_sharded_train_step(net, F.mse_loss, opt, meshes("dp2mp2"))
    step = make_sharded_train_step(net, F.mse_loss, opt, meshes("mp2"))
    try:
        got = [step(*_probe_batch()) for _ in range(STEPS)]
    finally:
        step.close()
    np.testing.assert_allclose(got, _jax_probe("mp2", 1.25)[1], rtol=TOL)
