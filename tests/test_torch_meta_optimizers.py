"""The strategy's meta-optimizers through the port's
`HybridParallelOptimizer`, the `HybridParallelGradScaler`, the fleet
facade's additions, Lamb and Lars on the explicit ZeRO path, and LocalSGD
over a hybrid mesh, against the JAX package (tests/test_meta_optimizers.py,
test_zero_explicit.py:111, test_pipeline_schedules.py:315) on the CPU.

Eager cases train a Linear(6, 3) from the JAX one's weights (`paddle.seed
(0)`) on seeded rows in both packages: gradient merge at k=2 over half
batches equals one full-batch step (and JAX's merged trajectory), the
``lars`` and ``dgc`` switches swap Momentum for the rule and give JAX's
weights within 1e-6 relative after 3 steps. Multi-rank cases run spawned
gloo processes (dp=2 and dp2 x mp2 meshes for the module) or threads of
this process (the scaler over pp=2).
"""
import threading

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
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss
from paddle_tpu.parallel import spmd as jspmd
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    HybridParallelGradScaler, HybridParallelOptimizer)
from paddle_tpu_torch.distributed.mesh import build_mesh
from paddle_tpu_torch.distributed.ranks import join_group
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
from paddle_tpu_torch.optimizer import SGD, DGCMomentum, Lamb, Lars, Momentum
from paddle_tpu_torch.parallel import collectives as coll
from paddle_tpu_torch.parallel.spmd import (LocalSGDTrainStep,
                                            make_sharded_train_step)
from paddle_tpu_torch.weights import from_jax_state_dict
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

TIMEOUT = 60
CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)


@pytest.fixture(scope="module")
def meshes():
    ms = {"dp2": build_mesh({"dp": 2}, device="cpu", timeout=TIMEOUT),
          "dp2mp2": build_mesh({"dp": 2, "mp": 2}, device="cpu",
                               timeout=TIMEOUT)}
    yield ms
    for m in ms.values():
        m.close()


def teardown_module():
    jax_set_mesh(None)
    from paddle_tpu_torch.distributed import mesh as port_mesh

    port_mesh.set_mesh(None)


def _rows(seed):
    rs = np.random.RandomState(seed)
    return rs.randn(8, 6).astype(np.float32), rs.randn(8, 3).astype(
        np.float32)


def _strategy(pkg, **flags):
    s = pkg.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                        "sharding_degree": 1}
    for k, v in flags.items():
        setattr(s, k, v)
    return s


def _jax_net(opt_cls, **kw):
    paddle.seed(0)
    net = paddle.nn.Linear(6, 3)
    return net, opt_cls(parameters=net.parameters(), **kw)


def _torch_net(opt_cls, **kw):
    jnet, _ = _jax_net(paddle.optimizer.SGD, learning_rate=0.1)
    arrays = {k: np.asarray(v) for k, v in state_dict_arrays(jnet)[0].items()}
    net = torch.nn.Linear(6, 3)
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(arrays["weight"].T.copy()))
        net.bias.copy_(torch.from_numpy(arrays["bias"].copy()))
    return net, opt_cls(parameters=net.named_parameters(), **kw)


def _jax_train(strategy, opt_cls, X, Y, steps, halves=False, **kw):
    from paddle_tpu.distributed import fleet as jfleet

    net, base = _jax_net(opt_cls, **kw)
    jfleet.init(is_collective=True, strategy=strategy)
    opt = jfleet.fleet.distributed_optimizer(base)
    loss_fn = paddle.nn.MSELoss()
    parts = [slice(0, 4), slice(4, 8)] if halves else [slice(0, 8)]
    for _ in range(steps):
        for sl in parts:
            loss = loss_fn(net(paddle.to_tensor(X[sl])),
                           paddle.to_tensor(Y[sl]))
            loss.backward()
            opt.step()
            opt.clear_grad()
    return np.asarray(net.weight.numpy()).T, opt


def _port_train(strategy, opt_cls, X, Y, steps, halves=False, **kw):
    net, base = _torch_net(opt_cls, **kw)
    opt = HybridParallelOptimizer(base, None, strategy)
    parts = [slice(0, 4), slice(4, 8)] if halves else [slice(0, 8)]
    for _ in range(steps):
        for sl in parts:
            loss = F.mse_loss(net(torch.from_numpy(X[sl])),
                              torch.from_numpy(Y[sl]))
            loss.backward()
            opt.step()
            opt.clear_grad()
    return net.weight.detach().numpy(), opt


def test_gradient_merge_equals_the_doubled_batch_and_jax():
    """k=2 over the two halves equals one SGD step on the whole batch,
    differs from not merging, and equals the JAX wrapper's merge."""
    from paddle_tpu.distributed import fleet as jfleet

    X, Y = _rows(0)
    gm = dict(gradient_merge=True,
              gradient_merge_configs={"k_steps": 2, "avg": True})
    got, _ = _port_train(_strategy(fleet, **gm), SGD, X, Y, 1, halves=True,
                         learning_rate=0.1)
    whole, _ = _port_train(_strategy(fleet), SGD, X, Y, 1,
                           learning_rate=0.1)
    np.testing.assert_allclose(got, whole, rtol=1e-5, atol=1e-6)
    plain, _ = _port_train(_strategy(fleet), SGD, X, Y, 1, halves=True,
                           learning_rate=0.1)
    assert not np.allclose(got, plain)
    want, _ = _jax_train(_strategy(jfleet, **gm), paddle.optimizer.SGD, X,
                         Y, 1, halves=True, learning_rate=0.1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("flag,rule", [("lars", Lars), ("dgc", DGCMomentum)])
def test_strategy_swaps_momentum_as_jax_does(flag, rule):
    """``lars`` / ``dgc`` swap the inner Momentum for the rule (JAX
    tests/test_meta_optimizers.py:211, :258): 3 steps give JAX's weights
    within 1e-6 relative and differ from plain Momentum."""
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu.optimizer import Lars as JaxLars
    from paddle_tpu.optimizer.optimizers import DGCMomentum as JaxDGC

    X, Y = _rows(3 if flag == "lars" else 5)
    extra = {"dgc_configs": {"rampup_begin_step": 0, "sparsity": [0.9]}} \
        if flag == "dgc" else {}
    kw = dict(learning_rate=0.1, momentum=0.9)
    got, opt = _port_train(_strategy(fleet, **{flag: True}, **extra),
                           Momentum, X, Y, 3, **kw)
    assert isinstance(opt._inner_opt, rule)
    want, jopt = _jax_train(_strategy(jfleet, **{flag: True}, **extra),
                            paddle.optimizer.Momentum, X, Y, 3, **kw)
    assert isinstance(jopt._inner_opt, JaxLars if flag == "lars" else JaxDGC)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    plain, _ = _port_train(_strategy(fleet), Momentum, X, Y, 3, **kw)
    assert not np.allclose(got, plain)
    # any other rule passes through
    _, kept = _port_train(_strategy(fleet, **{flag: True}, **extra), SGD, X,
                          Y, 1, learning_rate=0.1)
    assert type(kept._inner_opt) is SGD


def test_localsgd_without_a_dp_group_steps_alone():
    X, Y = _rows(2)
    s = _strategy(fleet, localsgd=True,
                  localsgd_configs={"k_steps": 2, "begin_step": 1})
    got, _ = _port_train(s, SGD, X, Y, 2, learning_rate=0.05)
    want, _ = _port_train(_strategy(fleet), SGD, X, Y, 2,
                          learning_rate=0.05)
    np.testing.assert_array_equal(got, want)


def run_mesh(tmp_path, degrees, fn):
    """`fn(mesh)` on every rank of a CPU gloo mesh, one thread a rank."""
    mesh = build_mesh(degrees, device="cpu", timeout=TIMEOUT)
    store = str(tmp_path / f"store-{id(mesh)}")
    out, errs = [None] * mesh.size, []

    def rank(r):
        try:
            m = mesh.for_rank(r)
            m.group = join_group(m, store)
            out[r] = fn(m)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errs:
        raise errs[0]
    return out


@pytest.mark.parametrize("plant", [None, 1])
def test_hybrid_scaler_agrees_on_found_inf_across_stages(tmp_path, plant):
    """Over pp=2 each stage holds its own weights; an inf planted in stage
    1's gradient makes both stages skip (weights unchanged bit for bit,
    the scale halved), one counted MAX all-reduce each; without it both
    step (JAX tests/test_pipeline_schedules.py:315's contract)."""
    def rank(mesh):
        stage = mesh.coords()["pp"]
        w = torch.nn.Parameter(torch.full((4,), 2.0 + stage))
        opt = HybridParallelOptimizer(SGD(learning_rate=0.1, parameters=[w]),
                                      mesh)
        scaler = HybridParallelGradScaler(
            GradScaler(init_loss_scaling=4.0), mesh)
        scaler.scale((w * 3.0).sum()).backward()
        if plant == stage:
            w.grad[1] = float("inf")
        before = w.detach().clone()
        scaler.step(opt)
        scaler.update()
        return (torch.equal(w.detach(), before), float(scaler._scale),
                w.detach().clone())

    calls = coll.all_reduce.calls
    out = run_mesh(tmp_path, {"pp": 2}, rank)
    assert coll.all_reduce.calls - calls == 2
    for s, (unchanged, scale, w) in enumerate(out):
        if plant is None:
            assert not unchanged and scale == 4.0
            torch.testing.assert_close(w, torch.full((4,), 2.0 + s - 0.3))
        else:
            assert unchanged and scale == 2.0


def test_scaler_unscales_once_through_the_wrapper():
    """The JAX fleet scaler's contract (tests/test_pipeline_schedules.py:
    315, one process): step() alone and unscale_() then step() each
    divide by the scale exactly once."""
    fleet.init(is_collective=True, strategy=_strategy(fleet), device="cpu")
    w = torch.nn.Parameter(torch.tensor([2.0]))
    opt = fleet.distributed_optimizer(SGD(learning_rate=0.1, parameters=[w]))
    scaler = fleet.distributed_scaler(GradScaler(
        init_loss_scaling=4.0, use_dynamic_loss_scaling=False))
    assert isinstance(scaler, HybridParallelGradScaler)
    scaler.scale((w * 3.0).sum()).backward()
    scaler.step(opt)
    scaler.update()
    assert abs(float(w.detach()) - (2.0 - 0.3)) < 1e-6
    opt.clear_grad()
    scaler.scale((w * 3.0).sum()).backward()
    scaler.unscale_(opt)
    before = float(w.detach())
    scaler.step(opt)
    scaler.update()
    assert abs(float(w.detach()) - (before - 0.3)) < 1e-6
    # the rest of the facade: a one-process controller waits for nobody,
    # minimize is the eager one, stop_worker and save_persistables are
    # the JAX package's no-ops
    fleet.fleet.barrier_worker()
    w.grad = None
    fleet.fleet.minimize(opt, (w * 1.0).sum())
    assert abs(float(w.detach()) - (before - 0.4)) < 1e-6
    assert fleet.fleet.stop_worker() is None
    assert fleet.fleet.save_persistables(None, "unused") is None


# -- Lamb and Lars on the explicit path; LocalSGD on a hybrid mesh ------------

_JAX = {}


def _batch():
    rs = np.random.RandomState(0)
    return (rs.randint(0, 64, (8, 16), dtype=np.int32),
            rs.randint(0, 64, (8, 16), dtype=np.int32))


def _jax_explicit(rule, zs, steps=4):
    """The JAX explicit (zs 2, 3) or stage-0 step at dp=2 with `rule`:
    (initial numpy weights, losses)."""
    key = (rule, zs)
    if key not in _JAX:
        jmesh = jax_init_mesh({"dp": 2})
        paddle.seed(0)
        model = JaxGPT(tiny_gpt_config())
        init = {k: np.asarray(v) for k, v in state_dict_arrays(model)[0].items()}
        opt = getattr(paddle.optimizer, rule)(learning_rate=0.01,
                                              parameters=model.parameters())
        step = jspmd.make_sharded_train_step(model, jax_gpt_loss, opt, jmesh,
                                             zero_stage=zs)
        params, buffers, opt_state = step.init_state()
        batch = step.shard_batch(*_batch())
        k = jax.random.PRNGKey(0)
        losses = []
        for _ in range(steps):
            loss, params, buffers, opt_state = step(
                params, buffers, opt_state, jnp.float32(0.01), k, *batch)
            losses.append(float(np.asarray(loss)))
        _JAX[key] = (init, losses)
    return _JAX[key]


@pytest.mark.parametrize("rule", ["Lamb", "Lars"])
@pytest.mark.parametrize("zs", [1, 2, 3])
def test_trust_ratio_rules_on_the_explicit_path(meshes, rule, zs):
    """Lamb and Lars at ZeRO stages 1-3 over dp=2: stages 2 and 3 take the
    explicit path's flat 1/dp shards (each norm a counted all-reduce of
    the shards' squared sums), stage 1 the plain path (a pure-dp mesh
    shards nothing at stage 1, in both packages): the JAX step's losses
    within 1e-5 relative, and the port's stage-0 losses within the JAX
    test's 1e-5 drift (test_zero_explicit.py:111)."""
    init, want = _jax_explicit(rule, zs)
    cls = {"Lamb": Lamb, "Lars": Lars}[rule]

    def run(z):
        model = from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"),
                                    init)
        opt = cls(learning_rate=0.01, parameters=model.named_parameters())
        step = make_sharded_train_step(model, gpt_loss_fn, opt,
                                       meshes["dp2"], zero_stage=z)
        try:
            return [step(*_batch()) for _ in range(4)], step.explicit_update
        finally:
            step.close()

    got, explicit = run(zs)
    assert explicit == (zs >= 2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref, _ = run(0)
    assert max(abs(a - b) for a, b in zip(got, ref)) < 1e-5
    assert got[-1] < got[0]


def test_dgc_is_refused_where_a_step_slices_its_leaves(meshes):
    model = GPT(GPTConfig(**CFG), device="cpu")
    opt = DGCMomentum(learning_rate=0.01, parameters=model.named_parameters())
    with pytest.raises(ValueError, match="per-tensor"):
        make_sharded_train_step(model, gpt_loss_fn, opt, meshes["dp2mp2"])


def test_localsgd_over_dp2_mp2_equals_dp2(meshes):
    """LocalSGD over {"dp": 2, "mp": 2} (each replica's Megatron layers
    sharded over its mp group) trains as over {"dp": 2}: k=1 equals dp
    (losses within 1e-5), and k=3 lets the replicas diverge for two steps
    and averages them on the third, as the JAX test's do
    (tests/test_meta_optimizers.py:143)."""
    paddle.seed(0)
    init = {k: np.asarray(v) for k, v in
            state_dict_arrays(JaxGPT(tiny_gpt_config()))[0].items()}

    def run(mesh, k):
        model = from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"),
                                    init)
        opt = SGD(learning_rate=0.05, parameters=model.named_parameters())
        step = LocalSGDTrainStep(model, gpt_loss_fn, opt, mesh, k_steps=k)
        try:
            losses, spreads = [], []
            for _ in range(3):
                losses.append(step(*_batch()))
                w = step.replica_params()["blocks.0.fc1.weight"].numpy()
                spreads.append(np.abs(w - w.mean(0, keepdims=True)).max())
            return losses, spreads, w
        finally:
            step.close()

    for k in (1, 3):
        got, spreads, w = run(meshes["dp2mp2"], k)
        want, wspreads, ww = run(meshes["dp2"], k)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(w, ww, rtol=1e-5, atol=1e-6)
        if k == 1:
            assert max(spreads) < 1e-6
        else:
            assert spreads[0] > 1e-6 and spreads[1] > 1e-6, spreads
            assert spreads[2] < 1e-6, spreads
