"""The port's AdamW against the JAX package's `AdamW.apply_gradients_arrays`
over three steps, on the same parameters and gradients (seeded numpy)."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.optimizer import AdamW

SHAPES = {"fc.weight": (8, 6), "fc.bias": (6,), "ln.weight": (6,)}
LR = 1e-3


def _params_and_grads(steps=3, seed=0):
    rs = np.random.RandomState(seed)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rs.randn(*s) * 10 ** rs.uniform(-3, 1)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _run_jax(params, grads, dtype, **kw):
    opt = JaxAdamW(learning_rate=LR, **kw)
    p = {k: jnp.asarray(a, dtype) for k, a in params.items()}
    state = opt.init_state_arrays(p)
    for g in grads:
        p, state = opt.apply_gradients_arrays(
            p, {k: jnp.asarray(a, dtype) for k, a in g.items()}, state,
            jnp.asarray(LR, jnp.float32))
    return {k: np.asarray(a.astype(jnp.float32)) for k, a in p.items()}


def _run_torch(params, grads, dtype, **kw):
    p = {k: torch.nn.Parameter(torch.tensor(a, dtype=dtype))
         for k, a in params.items()}
    opt = AdamW(learning_rate=LR, parameters=list(p.items()), **kw)
    for g in grads:
        for k, t in p.items():
            t.grad = torch.from_numpy(g[k]).to(dtype)
        opt.step()
        opt.zero_grad(set_to_none=True)
    return {k: t.detach().float().numpy() for k, t in p.items()}


@pytest.mark.parametrize("decay_fun", [None,
                                       lambda name: "bias" not in name])
def test_adamw_float32_matches_jax(decay_fun):
    params, grads = _params_and_grads()
    want = _run_jax(params, grads, jnp.float32,
                    apply_decay_param_fun=decay_fun)
    got = _run_torch(params, grads, torch.float32,
                     apply_decay_param_fun=decay_fun)
    for k in SHAPES:
        # float32: a rounding or two apart at most
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    if decay_fun is not None:
        # the exempt bias moved by the Adam step alone
        undecayed = _run_torch(params, grads, torch.float32, weight_decay=0.0)
        np.testing.assert_array_equal(got["fc.bias"], undecayed["fc.bias"])
        assert not np.array_equal(got["fc.weight"], undecayed["fc.weight"])


@pytest.mark.parametrize("decay_fun", [None,
                                       lambda name: "bias" not in name])
def test_adamw_bfloat16_within_one_ulp_of_jax(decay_fun):
    params, grads = _params_and_grads(seed=1)
    want = _run_jax(params, grads, jnp.bfloat16,
                    apply_decay_param_fun=decay_fun)
    got = _run_torch(params, grads, torch.bfloat16,
                     apply_decay_param_fun=decay_fun)
    for k in SHAPES:
        ulp = np.abs(np.spacing(want[k].astype(ml_dtypes.bfloat16))
                     .astype(np.float32))
        assert np.all(np.abs(got[k] - want[k]) <= ulp), k


def test_adamw_missing_gradient_is_a_zero_gradient():
    """A parameter that got no gradient (``.grad`` None) steps as the JAX
    step does with a zero gradient: moments decay, weight decay applies.
    Here `ln.weight` has none on the second and third steps, `fc.bias`
    none at all; a parameter that does not require a gradient is left
    alone."""
    params, grads = _params_and_grads(seed=2)
    for i, g in enumerate(grads):
        g["fc.bias"] = np.zeros_like(g["fc.bias"])
        if i:
            g["ln.weight"] = np.zeros_like(g["ln.weight"])
    want = _run_jax(params, grads, jnp.float32)
    p = {k: torch.nn.Parameter(torch.tensor(a)) for k, a in params.items()}
    frozen = torch.nn.Parameter(torch.ones(3), requires_grad=False)
    opt = AdamW(learning_rate=LR, parameters=list(p.values()) + [frozen])
    for i, g in enumerate(grads):
        p["fc.weight"].grad = torch.from_numpy(g["fc.weight"])
        if i == 0:
            p["ln.weight"].grad = torch.from_numpy(g["ln.weight"])
        opt.step()
        opt.zero_grad(set_to_none=True)
    for k in SHAPES:
        np.testing.assert_allclose(p[k].detach().numpy(), want[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert not np.array_equal(p["fc.bias"].detach().numpy(),
                              params["fc.bias"])
    assert torch.equal(frozen, torch.ones(3)) and frozen not in opt.state


def test_adamw_keeps_float32_moments_for_bfloat16_parameters():
    p = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    opt = AdamW(parameters=[p])
    p.grad = torch.full((4,), 0.5, dtype=torch.bfloat16)
    opt.step()
    st = opt.state[p]
    assert st["moment1"].dtype == st["moment2"].dtype == torch.float32
    assert p.dtype == torch.bfloat16


def test_adamw_refuses_what_is_not_ported():
    """What this test once saw refused now works, against the JAX compiled
    step: AdamW with an LR scheduler, `grad_clip` and `multi_precision` on
    bfloat16 parameters, three steps, masters within 1e-6 relative and
    parameters their bf16 rounding. Only `apply_decay_param_fun` without
    names still raises."""
    from paddle_tpu.nn import ClipGradByGlobalNorm as JaxClip
    from paddle_tpu.optimizer.lr import LinearWarmup as JaxWarmup
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer.lr import LinearWarmup

    params, grads = _params_and_grads(seed=3)
    params = {k: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
              for k, a in params.items()}
    jsched = JaxWarmup(LR, 2, 0.0, LR)
    jopt = JaxAdamW(learning_rate=jsched, grad_clip=JaxClip(1.0),
                    multi_precision=True)
    jp = {k: jnp.asarray(a, jnp.bfloat16) for k, a in params.items()}
    state = jopt.init_state_arrays(jp)
    p = {k: torch.nn.Parameter(torch.tensor(a, dtype=torch.bfloat16))
         for k, a in params.items()}
    sched = LinearWarmup(LR, 2, 0.0, LR)
    opt = AdamW(learning_rate=sched, parameters=list(p.items()),
                grad_clip=ClipGradByGlobalNorm(1.0), multi_precision=True)
    for g in grads:
        gb = {k: jnp.asarray(a, jnp.bfloat16) for k, a in g.items()}
        jp, state = jopt.apply_gradients_arrays(jp, gb, state)
        for k, t in p.items():
            t.grad = torch.from_numpy(np.asarray(gb[k].astype(jnp.float32))
                                      ).to(torch.bfloat16)
        assert opt.get_lr() == jopt.get_lr()
        opt.step()
        opt.zero_grad(set_to_none=True)
        jsched.step()
        sched.step()
    for k, t in p.items():
        master = opt.state[t]["master_weight"]
        np.testing.assert_allclose(master.numpy(),
                                   np.asarray(state[k]["master_weight"]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        assert torch.equal(t.detach(), master.to(torch.bfloat16)), k
    with pytest.raises(ValueError, match="named_parameters"):
        AdamW(parameters=[torch.nn.Parameter(torch.ones(2))],
              apply_decay_param_fun=lambda n: True)
