"""The training surface end to end on the CPU, against the JAX package's
step built the way `bench.py` builds it (`functional_call`,
`jax.value_and_grad`, `apply_gradients_arrays` with the optimizer's
scheduler and clip), at `test_torch_gpt_train.py`'s bar (loss 1e-5
relative, gradients and parameters 2e-5 absolute, noise-level entries
held to 2 * steps * lr):

- a 2-layer float32 GPT with `remat=True`, AdamW whose learning rate is
  `LinearWarmup(CosineAnnealingDecay)` and whose `grad_clip` is
  `ClipGradByGlobalNorm` (taken every step), each port step an
  `InstrumentedStep` under the train tracer, three steps;
- `from_jax_optimizer_state`: the port resumes a JAX run's parameters,
  moments, beta powers and scheduler after three steps and takes the JAX
  run's next three; `to_jax_optimizer_state` gives the JAX state back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.functional import functional_call, state_dict_arrays
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nn import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.profiler import tracing
from paddle_tpu_torch.weights import (from_jax_optimizer_state,
                                      from_jax_state_dict,
                                      to_jax_optimizer_state,
                                      to_jax_state_dict)
from test_torch_gpt_train import (ATOL, CFG, LOSS_RTOL, NOISE, _batch,
                                  _grads_in_jax_layout)
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

PEAK, CLIP, STEPS = 1e-3, 0.5, 3


def _sched(mod):
    return mod.LinearWarmup(mod.CosineAnnealingDecay(PEAK, T_max=10),
                            warmup_steps=2, start_lr=1e-4, end_lr=PEAK)


class JaxRun:
    """The JAX package's jitted GPT step with remat, AdamW, the scheduler
    and the clip."""

    def __init__(self):
        paddle.seed(0)
        self.model = JaxGPT(JaxGPTConfig(**CFG, remat=True))
        self.params, buffers = state_dict_arrays(self.model)
        self.init = {k: np.asarray(v) for k, v in self.params.items()}
        self.sched = _sched(jlr)
        self.opt = JaxAdamW(learning_rate=self.sched, grad_clip=JaxClip(CLIP),
                            parameters=self.model.parameters())
        self.state = self.opt.init_state_arrays(self.params)
        ids, labels = _batch()
        ids, labels = jnp.asarray(ids, jnp.int32), jnp.asarray(labels,
                                                               jnp.int32)
        model, opt = self.model, self.opt

        def step(params, state, lr):
            def loss_fn(p):
                loss, _ = functional_call(model, p, buffers, args=(ids,),
                                          kwargs={"labels": labels},
                                          training=True)
                return loss
            loss, grads = jax.value_and_grad(loss_fn)(params)
            new_params, new_state = opt.apply_gradients_arrays(
                params, grads, state, lr)
            return loss, grads, new_params, new_state

        self.jstep = jax.jit(step)

    def run(self, steps):
        """(losses, lrs, first step's gradients) of `steps` steps."""
        losses, lrs, first = [], [], None
        for _ in range(steps):
            lrs.append(self.opt.get_lr())
            loss, grads, self.params, self.state = self.jstep(
                self.params, self.state,
                jnp.asarray(self.opt.get_lr(), jnp.float32))
            self.sched.step()
            losses.append(float(loss))
            first = first or {k: np.asarray(v) for k, v in grads.items()}
        return losses, lrs, first

    def numpy_state(self):
        return {k: {s: np.asarray(a) for s, a in slots.items()}
                for k, slots in self.state.items()}


def _port(init):
    model = from_jax_state_dict(GPT(GPTConfig(**CFG, remat=True),
                                    device="cpu"), init)
    sched = _sched(tlr)
    clip = ClipGradByGlobalNorm(CLIP)
    opt = AdamW(learning_rate=sched, grad_clip=clip,
                parameters=model.parameters())
    return model, opt, sched, clip


def _run_port(model, opt, sched, clip, steps):
    ids, labels = map(torch.from_numpy, _batch())
    norms, first = [], None

    def step():
        loss = model(ids, labels=labels)
        loss.backward()
        grads = _grads_in_jax_layout(model)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss, grads

    traced = tracing.InstrumentedStep(step)
    model.train()
    losses, lrs = [], []
    for _ in range(steps):
        lrs.append(opt.get_lr())
        loss, grads = traced()
        # the lr the update applied: the JAX step's jnp.float32(get_lr())
        assert opt._last_lr == np.float32(lrs[-1])
        sched.step()
        losses.append(loss.item())
        norms.append(clip.global_norm.item())
        first = first or grads
    return losses, lrs, first, norms


def _assert_params(got, want, grads, lr_total):
    for k, w in want.items():
        w = np.asarray(w)
        g = np.abs(grads[k])
        noise = g < NOISE * g.max()
        np.testing.assert_allclose(got[k][~noise], w[~noise], atol=ATOL,
                                   rtol=0, err_msg=f"param {k}")
        assert np.all(np.abs(got[k] - w)[noise] <= 2 * lr_total), k


@pytest.fixture(autouse=True)
def _fresh_tracing():
    tracing.reset_train_tracing()
    yield
    tracing.reset_train_tracing()


def test_remat_schedule_clip_steps_match_jax():
    jrun = JaxRun()
    want_losses, want_lrs, want_grads = jrun.run(STEPS)
    tr = tracing.enable_train_tracing()
    model, opt, sched, clip = _port(jrun.init)
    losses, lrs, grads, norms = _run_port(model, opt, sched, clip, STEPS)
    assert lrs == want_lrs and len(set(lrs)) == STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert all(n > CLIP for n in norms), norms         # the clip was taken
    for k in want_grads:
        np.testing.assert_allclose(grads[k], want_grads[k], atol=ATOL,
                                   rtol=0, err_msg=f"grad {k}")
    _assert_params(to_jax_state_dict(model), jrun.params, want_grads,
                   sum(lrs))
    assert sum(e["name"] == "train_step"
               for e in tr.chrome_trace()["traceEvents"]) == STEPS


def test_from_jax_optimizer_state_resumes_the_jax_run():
    jrun = JaxRun()
    jrun.run(STEPS)
    params = {k: np.asarray(v) for k, v in jrun.params.items()}
    state = jrun.numpy_state()
    lr_state = jrun.sched.state_dict()
    want_losses, want_lrs, want_grads = jrun.run(STEPS)

    model, opt, sched, clip = _port(params)
    from_jax_optimizer_state(opt, model, state, lr_state)
    back, back_lr = to_jax_optimizer_state(opt, model)
    assert back_lr == lr_state
    for k, slots in state.items():
        assert set(back[k]) == set(slots), k
        for s, a in slots.items():
            np.testing.assert_array_equal(back[k][s], a, err_msg=f"{k} {s}")
    losses, lrs, grads, _ = _run_port(model, opt, sched, clip, STEPS)
    assert lrs == want_lrs
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_params(to_jax_state_dict(model), jrun.params, want_grads,
                   sum(lrs))
    # and the state it ends in is the JAX run's
    got_state, _ = to_jax_optimizer_state(opt, model)
    for k, slots in jrun.numpy_state().items():
        np.testing.assert_allclose(got_state[k]["beta1_pow"],
                                   slots["beta1_pow"], rtol=0, atol=0)
        # the first moment averages gradients: held as gradients are
        np.testing.assert_allclose(got_state[k]["moment1"],
                                   slots["moment1"], rtol=0, atol=ATOL,
                                   err_msg=k)


def test_from_jax_optimizer_state_refuses_a_mismatch():
    jrun = JaxRun()
    model, opt, _, _ = _port(jrun.init)
    state = jrun.numpy_state()
    state.pop("wte.weight")
    with pytest.raises(KeyError, match="wte.weight"):
        from_jax_optimizer_state(opt, model, state)
    plain = AdamW(learning_rate=1e-3, parameters=model.parameters())
    with pytest.raises(ValueError, match="scheduler"):
        from_jax_optimizer_state(plain, model, jrun.numpy_state(),
                                 jrun.sched.state_dict())
