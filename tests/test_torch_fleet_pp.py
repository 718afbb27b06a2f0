"""`PipelineLayer` / `PipelineParallel` through the port's fleet over a
``pp`` mesh, against the JAX package's (tests/test_pipeline_schedules.py
:235, :269), on the CPU.

A PipelineLayer of [Linear(8, 16), 4 x Block(16), Linear(16, 4)] with an
MSE loss, built in both packages from the JAX one's weights
(`paddle.seed`), trains 4 `train_batch` steps of 4 microbatches over
``pp_degree`` 2 with SGD through `fleet.distributed_optimizer`: the
port's 1F1B pipeline (its two stages are spawned gloo ranks) gives the
JAX compiled 1F1B's losses and its own sequential fallback's within 1e-5
relative. With a global-norm clip and one trunk stage's weights blown up
20x (so its gradients dominate the norm), the same three agree: the clip
sees every stage's gradients.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.mesh import set_mesh as jax_set_mesh
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import mesh as port_mesh
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    LayerDesc, PipelineLayer, PipelineParallel, SharedLayerDesc)
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import SGD
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)


class Block(torch.nn.Module):
    def __init__(self, h):
        super().__init__()
        self.fc = torch.nn.Linear(h, h)

    def forward(self, x):
        return torch.tanh(self.fc(x))


class _JaxBlock(paddle.nn.Layer):
    def __init__(self, h):
        super().__init__()
        self.fc = paddle.nn.Linear(h, h)

    def forward(self, x):
        return paddle.tanh(self.fc(x))


def teardown_module():
    jax_set_mesh(None)
    port_mesh.set_mesh(None)


def _strategy(pkg):
    s = pkg.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 2,
                        "sharding_degree": 1}
    s.pipeline_configs = {"accumulate_steps": 4, "micro_batch_size": 2}
    return s


def _jax_model(seed):
    from paddle_tpu.distributed.fleet.meta_parallel import (
        LayerDesc as JLayerDesc, PipelineLayer as JPipelineLayer)

    paddle.seed(seed)
    descs = ([JLayerDesc(paddle.nn.Linear, 8, 16)]
             + [JLayerDesc(_JaxBlock, 16) for _ in range(4)]
             + [JLayerDesc(paddle.nn.Linear, 16, 4)])
    return JPipelineLayer(layers=descs, num_stages=2,
                          loss_fn=paddle.nn.MSELoss())


def _linears(jmodel):
    out = []
    for f in jmodel._funcs:
        lin = f.fc if isinstance(f, _JaxBlock) else f
        out.append((np.asarray(lin.weight.numpy()),
                    np.asarray(lin.bias.numpy())))
    return out


def _port_model(weights):
    descs = ([LayerDesc(torch.nn.Linear, 8, 16)]
             + [LayerDesc(Block, 16) for _ in range(4)]
             + [LayerDesc(torch.nn.Linear, 16, 4)])
    m = PipelineLayer(layers=descs, num_stages=2,
                      loss_fn=torch.nn.MSELoss())
    with torch.no_grad():
        for f, (w, b) in zip(m._funcs, weights):
            lin = f.fc if isinstance(f, Block) else f
            lin.weight.copy_(torch.from_numpy(w.T.copy()))
            lin.bias.copy_(torch.from_numpy(b.copy()))
    return m


def _skew(weights):
    # blow up the last trunk block's weights: its gradients dominate the
    # global norm, so a per-stage norm would clip wrongly
    w, b = weights[-2]
    return weights[:-2] + [(w * 20.0, b)] + weights[-1:]


def _jax_losses(seed, clip, X, Y, skew=False):
    from paddle_tpu.distributed import fleet as jfleet

    jfleet.init(is_collective=True, strategy=_strategy(jfleet))
    m = _jax_model(seed)
    if skew:
        big = [f for f in m._funcs if isinstance(f, paddle.nn.Linear)
               or isinstance(f, _JaxBlock)][-2].fc
        big.weight.set_value(np.asarray(big.weight.numpy()) * 20.0)
    kw = {"grad_clip": paddle.nn.ClipGradByGlobalNorm(0.5)} if clip else {}
    opt = paddle.optimizer.SGD(learning_rate=0.05 if clip else 0.1,
                               parameters=m.parameters(), **kw)
    wrapped = jfleet.fleet.distributed_model(m)
    opt = jfleet.fleet.distributed_optimizer(opt)
    X, Y = paddle.to_tensor(X), paddle.to_tensor(Y)
    losses = [float(np.asarray(wrapped.train_batch((X, Y), opt)._array))
              for _ in range(4)]
    return losses, _linears(_jax_model(seed))


def _port_losses(weights, clip, X, Y, fallback):
    hcg = fleet.init(is_collective=True, strategy=_strategy(fleet),
                     device="cpu").get_hybrid_communicate_group()
    m = _port_model(weights)
    kw = {"grad_clip": ClipGradByGlobalNorm(0.5)} if clip else {}
    opt = fleet.distributed_optimizer(SGD(
        learning_rate=0.05 if clip else 0.1,
        parameters=m.named_parameters(), **kw))
    wrapped = fleet.distributed_model(m)
    assert isinstance(wrapped, PipelineParallel)
    if fallback:
        wrapped._pipe = False
    try:
        losses = [float(wrapped.train_batch(
            (torch.from_numpy(X), torch.from_numpy(Y)), opt))
            for _ in range(4)]
        piped = bool(wrapped._pipe)
    finally:
        wrapped.close()
        hcg.mesh.close()
    return losses, piped


@pytest.mark.parametrize("clip", [False, True])
def test_pipeline_equals_fallback_and_jax(clip):
    rs = np.random.RandomState(1 if clip else 0)
    X = rs.randn(8, 8).astype(np.float32)
    Y = (rs.randn(8, 4) * (5 if clip else 1)).astype(np.float32)
    seed = 13 if clip else 7
    paddle.seed(seed)
    weights = _linears(_jax_model(seed))
    if clip:
        weights = _skew(weights)
    want, _ = _jax_losses(seed, clip, X, Y, skew=clip)
    piped, built = _port_losses(weights, clip, X, Y, fallback=False)
    assert built, "PipelineParallel did not build its pipeline"
    seq, _ = _port_losses(weights, clip, X, Y, fallback=True)
    np.testing.assert_allclose(piped, want, rtol=1e-5)
    np.testing.assert_allclose(seq, piped, rtol=1e-5)
    assert np.isfinite(piped).all()
    if not clip:
        assert piped[-1] < piped[0]


def _in_thread(fn, timeout=120):
    """`fn()` on a thread that must end within `timeout` seconds (a
    collective that waits on idle ranks would hang the test instead)."""
    import threading

    out, errs = [], []

    def run():
        try:
            out.append(fn())
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "a call waited on ranks that were not there"
    if errs:
        raise errs[0]
    return out[0]


def test_eager_collectives_after_train_batch_meet_their_ranks():
    """Once `train_batch` has started the ranks of a pp2·dp2 mesh, the
    controller's eager calls between steps do not wait on ranks idling on
    their channel: LocalSGD's sync inside `train_batch`'s optimizer step
    has no replicas to average on the controller (the losses are the
    sequential fallback's), `barrier_worker` runs on every rank as an
    operation of the channel, the hybrid scaler decides on the
    controller's own gradients (which are all of them), and the next
    `train_batch` still runs."""
    rs = np.random.RandomState(3)
    X, Y = rs.randn(8, 8).astype(np.float32), rs.randn(8, 4).astype(
        np.float32)
    paddle.seed(5)
    weights = _linears(_jax_model(5))

    def train(fallback):
        from paddle_tpu_torch.amp import GradScaler

        s = _strategy(fleet)
        s.hybrid_configs = dict(s.hybrid_configs, dp_degree=2)
        s.localsgd = True
        s.localsgd_configs = {"k_steps": 2, "begin_step": 1}
        hcg = fleet.init(is_collective=True, strategy=s,
                         device="cpu").get_hybrid_communicate_group()
        hcg.mesh.timeout = 60.0
        m = _port_model(weights)
        opt = fleet.distributed_optimizer(SGD(
            learning_rate=0.1, parameters=m.named_parameters()))
        wrapped = fleet.distributed_model(m)
        if fallback:
            wrapped._pipe = False
        data = (torch.from_numpy(X), torch.from_numpy(Y))
        try:
            losses = [float(wrapped.train_batch(data, opt))
                      for _ in range(3)]
            if fallback:
                return losses, None
            ranks = hcg.mesh.ranks
            assert ranks is not None and len(ranks.alive()) == 3
            fleet.fleet.barrier_worker()
            scaler = fleet.distributed_scaler(GradScaler(
                init_loss_scaling=4.0))
            w = m._funcs[0].weight
            scaler.scale(m.loss(m(data[0]), data[1])).backward()
            before = w.detach().clone()
            scaler.step(opt)
            scaler.update()
            stepped = not torch.equal(before, w.detach())
            losses.append(float(wrapped.train_batch(data, opt)))
            return losses, (stepped, float(scaler._scale))
        finally:
            wrapped.close()
            hcg.mesh.close()

    piped, (stepped, scale) = _in_thread(lambda: train(False))
    seq, _ = _in_thread(lambda: train(True))
    np.testing.assert_allclose(piped[:3], seq, rtol=1e-5)
    assert stepped and scale == 4.0
    assert np.isfinite(piped).all()


class _Shift(torch.nn.Module):
    """A layer whose output reads a buffer (a position table's kind)."""

    def __init__(self, h):
        super().__init__()
        self.register_buffer("offset", torch.linspace(-1.0, 1.0, h))

    def forward(self, x):
        return x + self.offset


def test_buffered_ends_train_as_the_fallback():
    """A prologue that reads a buffer and an epilogue with a BatchNorm:
    the ranks get the ends' buffers with the weights, and the running
    statistics come back, so the pipeline's losses, weights and buffers
    are the sequential fallback's within 1e-5 (microbatches of 8 rows: a
    batch norm over 2 rows would amplify the two sums' rounding)."""
    rs = np.random.RandomState(4)
    X, Y = rs.randn(32, 8).astype(np.float32), rs.randn(32, 4).astype(
        np.float32)

    def train(fallback):
        hcg = fleet.init(is_collective=True, strategy=_strategy(fleet),
                         device="cpu").get_hybrid_communicate_group()
        hcg.mesh.timeout = 60.0
        torch.manual_seed(0)
        descs = ([LayerDesc(torch.nn.Linear, 8, 16), LayerDesc(_Shift, 16)]
                 + [LayerDesc(Block, 16) for _ in range(4)]
                 + [LayerDesc(torch.nn.BatchNorm1d, 16),
                    LayerDesc(torch.nn.Linear, 16, 4)])
        m = PipelineLayer(layers=descs, num_stages=2,
                          loss_fn=torch.nn.MSELoss())
        opt = SGD(learning_rate=0.1, parameters=m.named_parameters())
        wrapped = fleet.distributed_model(m)
        if fallback:
            wrapped._pipe = False
        try:
            losses = [float(wrapped.train_batch(
                (torch.from_numpy(X), torch.from_numpy(Y)), opt))
                for _ in range(3)]
            piped = bool(wrapped._pipe)
        finally:
            wrapped.close()
            hcg.mesh.close()
        return losses, piped, {k: v.detach().clone()
                               for k, v in m.state_dict().items()}

    got, piped, state = _in_thread(lambda: train(False))
    want, _, wstate = train(True)
    assert piped, "PipelineParallel did not build its pipeline"
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert any("running_mean" in k for k in state)
    for k, v in wstate.items():
        torch.testing.assert_close(state[k], v, rtol=1e-5, atol=1e-6,
                                   msg=k)
    bn = [k for k in state if k.endswith("num_batches_tracked")]
    assert bn and all(int(state[k]) == 3 * 4 for k in bn)


def test_a_model_without_a_trunk_falls_back_with_the_jax_warning():
    hcg = fleet.init(is_collective=True, strategy=_strategy(fleet),
                     device="cpu").get_hybrid_communicate_group()
    m = PipelineLayer([LayerDesc(torch.nn.Linear, 8, 16),
                       LayerDesc(torch.nn.Linear, 16, 4)], num_stages=2,
                      loss_fn=torch.nn.MSELoss())
    opt = SGD(learning_rate=0.1, parameters=m.named_parameters())
    wrapped = fleet.distributed_model(m)
    X, Y = torch.randn(8, 8), torch.randn(8, 4)
    try:
        with pytest.warns(UserWarning, match="homogeneous trunk"):
            loss = wrapped.train_batch((X, Y), opt)
        assert torch.isfinite(loss) and wrapped._pipe is False
        assert wrapped.eval_batch((X, Y)).numel() == 1
        assert set(wrapped.state_dict()) == set(m.state_dict())
    finally:
        hcg.mesh.close()


def test_pipeline_layer_bookkeeping():
    """Segments, stage lookup and a shared layer tied once (the JAX
    PipelineLayer's surface)."""
    descs = ([SharedLayerDesc("emb", torch.nn.Linear, None, "weight", 4, 4)]
             + [LayerDesc(Block, 4) for _ in range(4)]
             + [SharedLayerDesc("emb", torch.nn.Linear, None, "weight", 4,
                                4)])
    m = PipelineLayer(descs, num_stages=3, loss_fn=torch.nn.MSELoss())
    assert m.segment_parts == [0, 2, 4, 6]
    assert [m.get_stage_from_index(i) for i in range(6)] == [0, 0, 1, 1, 2,
                                                             2]
    assert m._funcs[0] is m._funcs[-1]
    # the tied weight is one parameter
    assert len(list(m.parameters())) == 2 + 4 * 2
    x = torch.randn(3, 4)
    assert m(x).shape == (3, 4)
    assert m.loss(m(x), x).numel() == 1
    with pytest.raises(TypeError):
        LayerDesc(int)
    with pytest.raises(NotImplementedError, match="8i"):
        PipelineLayer(descs, num_stages=2, seg_method="cost")
    by_class = PipelineLayer(descs, num_stages=2, seg_method="layer:Block")
    assert by_class.segment_parts == [0, 3, 6]
