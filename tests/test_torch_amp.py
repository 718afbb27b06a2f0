"""The port's mixed precision (`paddle_tpu_torch.amp`, master weights in the
optimizers, `GradScaler`) and `recompute`, scenario for scenario against
the JAX package:

- the four scenarios of `tests/test_amp_master_weights.py`: SGD stuck in
  bf16 without masters; SGD with masters tracking float32; Adam bf16 with
  masters against the JAX `apply_gradients_arrays(multi_precision=True)`
  on the same gradients (masters within 1e-6 relative); the master
  checkpoint round trip (the JAX package's optimizer state crossing
  only through `weights.from_jax_optimizer_state`, Linear slots
  transposed);
- the `GradScaler` scenarios of `tests/test_jit_amp_io.py` (autocast
  flags, the disabled no-op flow, the dynamic scale, one unscale around a
  clip, two optimizers) and its `test_recompute`, run in both packages
  with the same numbers;
- `decorate(level="O2")` keeps the optimizer's state keyed by the same
  parameters across ``model.to(bfloat16)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.amp.auto_cast import amp_state as jax_amp_state
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu_torch import amp, optimizer as toptim
from paddle_tpu_torch.amp.auto_cast import amp_dtype_for, amp_state
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.weights import (from_jax_optimizer_state,
                                      from_jax_state_dict, to_jax_state_dict)
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

STEPS = 300
EXPECTED = 1.0 - STEPS * 1.0 * 1e-4  # SGD lr=1.0: w -= 1e-4 each step


class JaxOneParam(jnn.Layer):
    def __init__(self, n=64):
        super().__init__()
        self.w = self.create_parameter(
            [n], default_initializer=paddle.nn.initializer.Constant(1.0))

    def forward(self):
        # a constant gradient of 1e-4: far below bf16's epsilon at w ~ 1
        return (self.w * 1e-4).sum()


class OneParam(torch.nn.Module):
    def __init__(self, n=64):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(n))

    def forward(self):
        return (self.w * 1e-4).sum()


def _jax_eager(master_weight, steps=STEPS):
    paddle.seed(0)
    model = JaxOneParam()
    opt = paddle.optimizer.SGD(learning_rate=1.0,
                               parameters=model.parameters())
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     master_weight=master_weight)
    for _ in range(steps):
        model().backward()
        opt.step()
        opt.clear_grad()
    return model, opt


def _torch_eager(master_weight, steps=STEPS):
    model = OneParam()
    opt = toptim.SGD(learning_rate=1.0, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2",
                              master_weight=master_weight)
    assert model.w.dtype == torch.bfloat16
    for _ in range(steps):
        model().backward()
        opt.step()
        opt.clear_grad()
    return model, opt


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_bf16_only_is_stuck():
    jm, _ = _jax_eager(master_weight=False)
    tm, topt = _torch_eager(master_weight=False)
    w = tm.w.float().detach().numpy()
    # every sub-epsilon update rounded away: the parameter never moved
    assert np.allclose(w, 1.0), w[:4]
    np.testing.assert_array_equal(w, _np(jm.w._array))
    assert "master_weight" not in topt.state[tm.w]


def test_master_weight_tracks_fp32():
    jm, jopt = _jax_eager(master_weight=True)
    tm, topt = _torch_eager(master_weight=True)
    w = tm.w.float().detach().numpy()
    assert np.allclose(w, EXPECTED, atol=4e-3), (w[:4], EXPECTED)
    master = topt.state[tm.w]["master_weight"]
    assert master.dtype == torch.float32
    assert np.allclose(master.numpy(), EXPECTED, atol=1e-4)
    # the same arithmetic as the JAX package, bit for bit
    np.testing.assert_array_equal(
        master.numpy(), np.asarray(jopt._accumulators[id(jm.w)]
                                   ["master_weight"]))
    np.testing.assert_array_equal(w, _np(jm.w._array))
    # the parameter is the master's bf16 rounding
    assert torch.equal(tm.w.detach(), master.to(torch.bfloat16))


def test_adam_master_weight_matches_jax_and_fp32_run():
    """bf16 + master Adam against the JAX package's compiled
    `apply_gradients_arrays(multi_precision=True)` on the same gradients:
    masters within 1e-6 relative; and, as the JAX test holds it, the
    master run tracks a float32 run while bf16 alone drifts."""
    rs = np.random.RandomState(0)
    w0 = _np(jnp.asarray(rs.rand(128).astype(np.float32) + 0.5,
                         jnp.bfloat16))
    # the gradients a bf16 parameter gets are bf16 values: both packages
    # (and the float32 reference) take the same ones
    grads = _np(jnp.asarray(rs.rand(STEPS, 128).astype(np.float32) + 0.5,
                            jnp.bfloat16))

    def run_jax(dtype, multi_precision):
        o = paddle.optimizer.Adam(learning_rate=1e-4,
                                  multi_precision=multi_precision)
        params = {"w": jnp.asarray(w0, dtype)}
        state = o.init_state_arrays(params)

        @jax.jit
        def step(params, state, g):
            return o.apply_gradients_arrays(params, {"w": g}, state,
                                            jnp.float32(1e-4))

        for i in range(STEPS):
            params, state = step(params, state, jnp.asarray(grads[i]))
        return _np(params["w"]), state

    def run_torch(dtype, multi_precision):
        w = torch.nn.Parameter(torch.tensor(w0).to(dtype))
        o = toptim.Adam(learning_rate=1e-4, parameters=[w],
                        multi_precision=multi_precision)
        for i in range(STEPS):
            w.grad = torch.tensor(grads[i]).to(dtype)
            o.step()
        return w.detach().float().numpy(), o.state[w]

    ref, _ = run_torch(torch.float32, False)
    got, state = run_torch(torch.bfloat16, True)
    stuck, _ = run_torch(torch.bfloat16, False)
    err_master = np.abs(got - ref).max()
    err_stuck = np.abs(stuck - ref).max()
    assert err_master < 6e-3, err_master
    assert err_stuck > 3 * err_master, (err_stuck, err_master)
    want, jstate = run_jax(jnp.bfloat16, True)
    np.testing.assert_allclose(state["master_weight"].numpy(),
                               np.asarray(jstate["w"]["master_weight"]),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(
        got, _np(jnp.asarray(state["master_weight"].numpy())
                 .astype(jnp.bfloat16)))
    assert np.abs(got - want).max() <= np.abs(np.spacing(
        want.astype(jnp.bfloat16)).astype(np.float32)).max()


def test_master_weight_checkpoint_roundtrip():
    tm, topt = _torch_eager(master_weight=True)
    sd = topt.state_dict()
    master_keys = [k for k in sd if k.endswith("_master_weight")]
    assert master_keys == ["param_0_master_weight"], list(sd)
    assert sd["@param_order"] == ["param_0"] and sd["@step"] == STEPS

    def fresh():
        m = OneParam()
        o = toptim.SGD(learning_rate=1.0, parameters=m.parameters())
        return amp.decorate(m, o, level="O2", master_weight=True)

    m2, o2 = fresh()
    o2.set_state_dict(sd)
    torch.testing.assert_close(o2.state[m2.w]["master_weight"],
                               topt.state[tm.w]["master_weight"], rtol=0,
                               atol=0)
    # resumed training continues the float32 trajectory exactly
    for _ in range(10):
        m2().backward()
        o2.step()
        o2.clear_grad()
    master = o2.state[m2.w]["master_weight"].numpy()
    assert np.allclose(master, EXPECTED - 10 * 1e-4, atol=1e-4)
    # a JAX optimizer's state crosses through weights.from_jax_optimizer_state
    jm, jopt = _jax_eager(master_weight=True)
    with pytest.raises(TypeError, match="from_jax_optimizer_state"):
        fresh()[1].set_state_dict(jopt.state_dict())
    m3, o3 = fresh()
    from_jax_optimizer_state(o3, m3, {"w": {
        k: np.asarray(v) for k, v in jopt._accumulators[id(jm.w)].items()}})
    np.testing.assert_array_equal(o3.state[m3.w]["master_weight"].numpy(),
                                  np.asarray(jopt._accumulators[id(jm.w)]
                                             ["master_weight"]))


class JaxTwoLinear(jnn.Layer):
    def __init__(self):
        super().__init__()
        self.a = jnn.Linear(4, 4)
        self.b = jnn.Linear(4, 6)

    def forward(self, x):
        return self.b(self.a(x))


class TwoLinear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(4, 4)
        self.b = torch.nn.Linear(4, 6)

    def forward(self, x):
        return self.b(self.a(x))


def test_linear_optimizer_state_crosses_only_through_weights():
    """A square (`a`, 4x4) and a non-square (`b`, 4x6) Linear weight under
    Adam. The JAX optimizer's `state_dict()` keeps Linear slots ``[in,
    out]``: the port's `set_state_dict` refuses it, as the JAX package's
    tensors, as numpy, and as torch tensors (where only the non-square
    slot can show it), so the square slot never loads transposed.
    `weights.from_jax_optimizer_state` transposes every Linear slot, and
    the port then takes the JAX run's next two steps (atol 1e-6)."""
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    paddle.seed(0)
    jm = JaxTwoLinear()
    jopt = paddle.optimizer.Adam(learning_rate=1e-2,
                                 parameters=jm.parameters())

    def jax_steps(n):
        for _ in range(n):
            y = jm(paddle.to_tensor(x))
            (y * y).mean().backward()
            jopt.step()
            jopt.clear_grad()

    jax_steps(2)
    tm = from_jax_state_dict(TwoLinear(), {
        k: np.asarray(v) for k, v in state_dict_arrays(jm)[0].items()})
    topt = toptim.Adam(learning_rate=1e-2, parameters=tm.named_parameters())
    jsd = jopt.state_dict()
    as_numpy = {k: (v.numpy() if hasattr(v, "numpy") else v)
                for k, v in jsd.items()}
    as_torch = {k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
                    else v) for k, v in as_numpy.items()}
    for sd, err in ((jsd, TypeError), (as_numpy, TypeError),
                    (as_torch, ValueError)):
        with pytest.raises(err):
            topt.set_state_dict(sd)
    named = dict(jm.named_parameters())
    from_jax_optimizer_state(topt, tm, {
        n: {k: np.asarray(v) for k, v in jopt._accumulators[id(p)].items()}
        for n, p in named.items()})
    for n, p in tm.named_parameters():
        for slot in ("moment1", "moment2"):
            want = np.asarray(jopt._accumulators[id(named[n])][slot])
            np.testing.assert_array_equal(
                topt.state[p][slot].numpy(), want.T if n.endswith(
                    "weight") else want, err_msg=f"{n} {slot}")
    jax_steps(2)
    for _ in range(2):
        (tm(torch.from_numpy(x)) ** 2).mean().backward()
        topt.step()
        topt.clear_grad()
    got = to_jax_state_dict(tm)
    for k, v in state_dict_arrays(jm)[0].items():
        np.testing.assert_allclose(got[k], np.asarray(v), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_decorate_keeps_the_optimizer_keyed_by_the_same_parameters():
    model = torch.nn.Linear(4, 3)
    params = list(model.parameters())
    opt = toptim.AdamW(learning_rate=1e-3, parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2")
    assert [p for p in model.parameters()] == params        # same objects
    assert all(p.dtype == torch.bfloat16 for p in params)
    for p in params:
        st = opt.state[p]
        assert st["master_weight"].dtype == torch.float32
        assert torch.equal(st["master_weight"].to(torch.bfloat16), p)
    model(torch.ones(2, 4, dtype=torch.bfloat16)).sum().backward()
    opt.step()
    assert set(opt.state) == set(params)
    for p in params:
        assert torch.equal(opt.state[p]["master_weight"].to(torch.bfloat16),
                           p)
    # O1 changes no dtype; a list of models comes back as a list
    m1 = torch.nn.Linear(2, 2)
    assert amp.decorate([m1], level="O1") == [m1]
    assert m1.weight.dtype == torch.float32


# -- GradScaler and autocast (tests/test_jit_amp_io.py), in both packages ----

def test_amp_autocast_flags():
    for state, ac in ((jax_amp_state, paddle.amp.auto_cast),
                      (amp_state, amp.auto_cast)):
        assert not state().enabled
        with ac():
            assert state().enabled and state().dtype == "bfloat16"
        assert not state().enabled
    # the state is read by nothing in either package; its answers agree
    with amp.auto_cast(level="O1", custom_black_list={"matmul"}):
        assert amp_dtype_for("matmul") == torch.float32
        assert amp_dtype_for("linear") == torch.bfloat16
        assert amp_dtype_for("relu") is None
    assert amp_dtype_for("linear") is None


def _jax_w(v):
    return paddle.Parameter(np.array([v], np.float32))


def _torch_w(v):
    return torch.nn.Parameter(torch.tensor([v]))


def test_grad_scaler_noop_flow():
    out = []
    for w, sgd, scaler in (
            (_jax_w(1.0), paddle.optimizer.SGD, paddle.amp.GradScaler),
            (_torch_w(1.0), toptim.SGD, amp.GradScaler)):
        opt = sgd(learning_rate=0.1, parameters=[w])
        s = scaler(enable=False)
        s.scale((w * 2.0).sum()).backward()
        s.step(opt)
        out.append(float(w.detach().numpy()[0]) if torch.is_tensor(w)
                   else float(w.numpy()[0]))
    assert abs(out[1] - 0.8) < 1e-6 and out[0] == out[1]


def test_grad_scaler_dynamic():
    scales = []
    for w, sgd, scaler in (
            (_jax_w(1.0), paddle.optimizer.SGD, paddle.amp.GradScaler),
            (_torch_w(1.0), toptim.SGD, amp.GradScaler)):
        s = scaler(init_loss_scaling=4.0, incr_every_n_steps=1)
        opt = sgd(learning_rate=0.1, parameters=[w])
        s.scale((w * 1.0).sum()).backward()
        s.step(opt)
        s.update()
        scales.append(s._scale)
    assert scales == [8.0, 8.0]             # grew after a good step


def _value(w):
    return float(w.detach()[0]) if torch.is_tensor(w) else float(
        w.numpy()[0])


def test_grad_scaler_single_unscale_with_clip():
    """unscale_ -> clip -> step divides by the scale once; a second
    unscale_ or step before update() raises (both packages)."""
    for w, sgd, scaler in (
            (_jax_w(1.0), paddle.optimizer.SGD, paddle.amp.GradScaler),
            (_torch_w(1.0), toptim.SGD, amp.GradScaler)):
        s = scaler(init_loss_scaling=4.0, use_dynamic_loss_scaling=False)
        opt = sgd(learning_rate=0.1, parameters=[w])
        s.scale((w * 2.0).sum()).backward()     # grad = 8
        s.unscale_(opt)                         # grad = 2
        if torch.is_tensor(w):
            ClipGradByGlobalNorm(10.0)([(w, w.grad)])
        s.step(opt)                             # no second unscale
        s.update()
        assert abs(_value(w) - (1.0 - 0.1 * 2.0)) < 1e-6
        s.scale((w * 2.0).sum()).backward()
        s.unscale_(opt)
        with pytest.raises(RuntimeError):
            s.unscale_(opt)
        s.step(opt)
        with pytest.raises(RuntimeError):
            s.step(opt)
        s.update()                              # resets the bookkeeping
        opt.clear_grad()


def test_grad_scaler_two_optimizers_independent_inf():
    """One optimizer's inf must not be erased by another's clean unscale_:
    the first skips its step, the second steps, the scale backs off."""
    out = []
    for mk, sgd, scaler in ((_jax_w, paddle.optimizer.SGD,
                             paddle.amp.GradScaler),
                            (_torch_w, toptim.SGD, amp.GradScaler)):
        s = scaler(init_loss_scaling=2.0)
        w1, w2 = mk(1.0), mk(1.0)
        opt1 = sgd(learning_rate=0.1, parameters=[w1])
        opt2 = sgd(learning_rate=0.1, parameters=[w2])
        if torch.is_tensor(w1):
            w1.grad = torch.tensor([np.inf])
            w2.grad = torch.tensor([2.0])
        else:
            w1._grad = jnp.asarray(np.array([np.inf], np.float32))
            w2._grad = jnp.asarray(np.array([2.0], np.float32))
        s.unscale_(opt1)
        s.unscale_(opt2)
        s.step(opt1)
        s.step(opt2)
        s.update()
        out.append((_value(w1), _value(w2), s._scale))
    assert out[1][0] == 1.0                          # skipped
    assert abs(out[1][1] - (1.0 - 0.1 * 1.0)) < 1e-6  # grad 2 / scale 2
    assert out[1][2] == 1.0                          # backed off from 2
    assert out[0] == out[1]


def test_grad_scaler_unscale_is_one_pass_over_mixed_dtypes():
    """bf16 and float32 gradients of one optimizer unscale by 1/scale
    rounded to their dtype; one non-finite entry in either skips the
    step; the state dict carries the scale and counters."""
    a = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    b = torch.nn.Parameter(torch.ones(2))
    opt = toptim.SGD(learning_rate=1.0, parameters=[a, b])
    s = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    a.grad = torch.full((3,), 2.0 ** 14, dtype=torch.bfloat16)
    b.grad = torch.full((2,), 2.0 ** 13)
    s.step(opt)
    s.update()
    assert torch.equal(a.detach(), torch.full((3,), 0.5,
                                              dtype=torch.bfloat16))
    assert torch.equal(b.detach(), torch.full((2,), 0.75))
    b.grad = torch.tensor([1.0, float("nan")])
    a.grad = torch.ones(3, dtype=torch.bfloat16)
    before = (a.detach().clone(), b.detach().clone())
    s.step(opt)
    s.update()
    assert torch.equal(a.detach(), before[0])
    assert torch.equal(b.detach(), before[1])
    assert s._scale == 2.0 ** 14
    assert s.state_dict()["scale"] == 2.0 ** 14
    assert float(s.get_loss_scaling()) == 2.0 ** 14


def test_recompute():
    """`recompute(layer, x)`: gradients reach the layer's weights and the
    input, equal to the JAX package's `recompute` on the same weights."""
    from paddle_tpu.distributed.fleet.utils import recompute as jrecompute

    paddle.seed(0)
    jlin = jnn.Linear(4, 4)
    rs = np.random.RandomState(0)
    xv = rs.randn(2, 4).astype(np.float32)
    jx = paddle.to_tensor(xv)
    jx.stop_gradient = False
    jrecompute(jlin, jx).sum().backward()
    assert jlin.weight.grad is not None and jx.grad is not None

    lin = torch.nn.Linear(4, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(jlin.weight.numpy().T))
        lin.bias.copy_(torch.tensor(jlin.bias.numpy()))
    x = torch.from_numpy(xv).requires_grad_()
    y = recompute(lin, x)
    torch.testing.assert_close(y.detach(), lin(x).detach(), rtol=0, atol=0)
    y.sum().backward()
    np.testing.assert_allclose(lin.weight.grad.numpy().T,
                               jlin.weight.grad.numpy(), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), jx.grad.numpy(), rtol=1e-6)
