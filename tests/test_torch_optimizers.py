"""The port's Adamax, Adagrad, Adadelta, RMSProp, DGCMomentum, Lars and
Lamb against the JAX package's rules (`apply_gradients_arrays`), and
`sharded_norms` against whole-tensor norms.

Each rule takes three steps on the same float32 parameters and gradients
(seeded numpy) in both packages: parameters within 1e-6 relative (as
`tests/test_torch_optimizer.py` holds AdamW), the state in the JAX key
scheme equal within the same tolerance, and the state crosses both ways
(`weights.from_jax_optimizer_state` / `to_jax_optimizer_state`): a fourth
step from the other package's state gives the other package's fourth
step.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.optimizer import optimizers as jopt
from paddle_tpu_torch.optimizer import (Adadelta, Adagrad, Adamax,
                                        DGCMomentum, Lamb, Lars, RMSProp,
                                        sharded_norms)
from paddle_tpu_torch.optimizer.optimizers import _tensor_norm
from paddle_tpu_torch.parallel import collectives as coll
from paddle_tpu_torch.weights import (from_jax_optimizer_state,
                                      to_jax_optimizer_state)
from test_torch_collectives import run_ranks, shared_cores  # noqa: F401

SHAPES = {"w": (8, 6), "b": (6,), "ln": (6,)}
LR = 0.01
RULES = {
    "Adamax": (Adamax, jopt.Adamax, {}),
    "Adagrad": (Adagrad, jopt.Adagrad, {"learning_rate": LR}),
    "Adadelta": (Adadelta, jopt.Adadelta, {}),
    "RMSProp": (RMSProp, jopt.RMSProp, {"learning_rate": LR,
                                        "momentum": 0.9}),
    "RMSProp_centered": (RMSProp, jopt.RMSProp,
                         {"learning_rate": LR, "centered": True}),
    "DGCMomentum": (DGCMomentum, jopt.DGCMomentum, {"sparsity": 0.5}),
    "Lars": (Lars, jopt.Lars, {"lars_coeff": 0.01,
                               "exclude_from_weight_decay": ["b"]}),
    "Lamb": (Lamb, jopt.Lamb, {}),
}


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for k, a in arrays.items():
            setattr(self, k, torch.nn.Parameter(torch.tensor(a)))


def _data(steps=4, seed=0):
    rs = np.random.RandomState(seed)
    params = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rs.randn(*s) * 10 ** rs.uniform(-2, 0)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _kw(name):
    kw = dict(RULES[name][2])
    kw.setdefault("learning_rate", LR)
    return kw


def _jax_steps(name, params, grads, state=None):
    opt = RULES[name][1](**_kw(name))
    p = {k: jnp.asarray(a) for k, a in params.items()}
    state = opt.init_state_arrays(p) if state is None else state
    for g in grads:
        p, state = opt.apply_gradients_arrays(
            p, {k: jnp.asarray(a) for k, a in g.items()}, state,
            jnp.asarray(LR, jnp.float32))
    return ({k: np.asarray(a) for k, a in p.items()},
            {k: {s: np.asarray(v) for s, v in sl.items()}
             for k, sl in state.items()})


def _port_opt(name, params):
    model = _Params(params)
    return model, RULES[name][0](parameters=model.named_parameters(),
                                 **_kw(name))


def _port_steps(model, opt, grads):
    for g in grads:
        for k, t in model.named_parameters():
            t.grad = torch.from_numpy(g[k])
        opt.step()
        opt.zero_grad(set_to_none=True)
    return {k: t.detach().numpy().copy() for k, t in model.named_parameters()}


def _close(got, want, what):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name", sorted(RULES))
def test_three_steps_and_state_cross_both_ways(name):
    params, grads = _data()
    want, jstate = _jax_steps(name, params, grads[:3])
    model, opt = _port_opt(name, params)
    got = _port_steps(model, opt, grads[:3])
    _close(got, want, "params")
    pstate = to_jax_optimizer_state(opt, model)[0]
    assert set(pstate) == set(jstate)
    for k, slots in jstate.items():
        assert set(pstate[k]) == set(slots), k
        _close(pstate[k], slots, f"state {k}")
    # JAX's state into a fresh port optimizer: the fourth step is JAX's
    want4, _ = _jax_steps(name, want, grads[3:], state={
        k: {s: jnp.asarray(v) for s, v in sl.items()}
        for k, sl in jstate.items()})
    model2, opt2 = _port_opt(name, want)
    from_jax_optimizer_state(opt2, model2, jstate)
    if name == "DGCMomentum":
        opt2._dgc_step = 3
    _close(_port_steps(model2, opt2, grads[3:]), want4, "JAX state in")
    # the port's state into the JAX rule: the fourth step is the port's
    got4 = _port_steps(model, opt, grads[3:])
    jfrom, _ = _jax_steps(name, got, grads[3:], state={
        k: {s: jnp.asarray(v) for s, v in sl.items()}
        for k, sl in pstate.items()})
    _close(got4, jfrom, "port state out")


def test_state_dict_uses_the_jax_keys():
    params, grads = _data()
    model, opt = _port_opt("Lamb", params)
    _port_steps(model, opt, grads[:1])
    sd = opt.state_dict()
    assert {"w_moment1", "w_moment2", "w_beta1_pow", "w_beta2_pow",
            "@step", "@param_order"} <= set(sd)
    model2, opt2 = _port_opt("Lamb", params)
    opt2.set_state_dict(sd)
    assert torch.equal(opt2.state[model2.w]["moment1"],
                       opt.state[model.w]["moment1"])
    assert opt2.state[model2.w]["beta1_pow"] == np.float32(0.9)


def test_dgc_error_feedback_conserves_gradient_mass():
    """The JAX package's own check (test_meta_optimizers.py:287): what
    top-k drops comes back through the residual, so the applied mass
    plus the banked residual is the whole gradient mass, and some
    entries were never sent."""
    w = torch.nn.Parameter(torch.zeros(8))
    opt = DGCMomentum(learning_rate=1.0, momentum=0.0, sparsity=0.75,
                      parameters=[w])
    g = torch.arange(1, 9, dtype=torch.float32)
    for _ in range(2):
        w.grad = g.clone()
        opt.step()
    applied = -w.detach()
    residual = opt.state[w]["residual"]
    np.testing.assert_allclose(float(applied.sum() + residual.sum()),
                               2 * float(g.sum()), rtol=1e-6)
    assert int((applied > 0).sum()) < g.numel()


def test_dgc_rampup_keeps_every_entry_until_it_begins():
    w = torch.nn.Parameter(torch.zeros(8))
    opt = DGCMomentum(learning_rate=1.0, momentum=0.0, sparsity=0.75,
                      rampup_begin_step=1, parameters=[w])
    w.grad = torch.arange(1, 9, dtype=torch.float32)
    opt.step()
    assert torch.equal(-w.detach(), torch.arange(1, 9, dtype=torch.float32))
    assert float(opt.state[w]["residual"].abs().sum()) == 0.0


def test_lars_one_step_against_the_hand_computed_update():
    """The JAX test's hand-computed step (test_meta_optimizers.py:238)."""
    w0 = torch.tensor([[3.0, 4.0]])
    p = torch.nn.Parameter(w0.clone())
    opt = Lars(learning_rate=1.0, momentum=0.0, lars_coeff=0.01,
               lars_weight_decay=0.0, parameters=[p])
    p.grad = torch.tensor([[0.6, 0.8]])
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(),
                               (w0 - 0.05 * p.grad).numpy(), rtol=1e-6)


def test_all_optimizers_step():
    """The JAX package's smoke check (tests/test_optimizer.py:59), on the
    port: one step of ``(w * w).sum()`` moves every rule's weights."""
    for cls, kw in [(Adamax, {}), (Adagrad, {"learning_rate": 0.1}),
                    (Adadelta, {}), (RMSProp, {"learning_rate": 0.01}),
                    (Lamb, {}), (Lars, {}), (DGCMomentum, {})]:
        w = torch.nn.Parameter(torch.ones(3))
        opt = cls(parameters=[w], **kw)
        (w * w).sum().backward()
        opt.step()
        assert (w.detach() - 1.0).abs().max() > 1e-7, cls.__name__
        assert not cls._elementwise_update or cls not in (DGCMomentum, Lars,
                                                          Lamb)


def test_sharded_norms_sum_each_shard_over_the_group(tmp_path):
    """Over `group` (what `sharded_norms(group, optimizer)` gives every
    norm of a rule) each rank's norm of its zero-padded flat shard is the
    whole tensor's norm, one counted all-reduce a norm; without it, the
    shard's own."""
    rs = np.random.RandomState(1)
    full = torch.from_numpy(rs.randn(7, 5).astype(np.float32))
    flat = torch.nn.functional.pad(full.reshape(-1), (0, 1))   # 36 = 2 x 18

    def rank(group):
        shard = flat[group.rank * 18:(group.rank + 1) * 18]
        before = coll.all_reduce.calls
        whole = _tensor_norm(shard, group)
        calls = coll.all_reduce.calls - before
        return float(whole), float(_tensor_norm(shard)), calls

    out = run_ranks(tmp_path, 2, rank)
    want = float(torch.linalg.vector_norm(full))
    for whole, own, _ in out:
        np.testing.assert_allclose(whole, want, rtol=1e-6)
        assert own < want
    assert sum(c for _, _, c in out) >= 2


def test_lamb_on_shards_equals_lamb_on_the_whole(tmp_path):
    """Lamb over each rank's flat 1/2 shard under `sharded_norms` steps
    exactly as Lamb over the whole tensor: the trust ratio sees the whole
    norms."""
    params, grads = _data(steps=2, seed=3)
    full = {k: np.pad(a.reshape(-1), (0, (-a.size) % 2))
            for k, a in params.items()}
    fgrads = [{k: np.pad(a.reshape(-1), (0, (-a.size) % 2))
               for k, a in g.items()} for g in grads]
    model, opt = _port_opt("Lamb", full)
    want = _port_steps(model, opt, fgrads)

    def rank(group):
        r = group.rank
        cut = lambda a: a[r * (a.size // 2):(r + 1) * (a.size // 2)].copy()  # noqa: E731
        m, o = _port_opt("Lamb", {k: cut(a) for k, a in full.items()})
        with sharded_norms(group, o):
            return _port_steps(m, o, [{k: cut(a) for k, a in g.items()}
                                      for g in fgrads])

    out = run_ranks(tmp_path, 2, rank)
    for k, a in want.items():
        got = np.concatenate([out[0][k], out[1][k]])
        np.testing.assert_allclose(got, a, rtol=1e-6, atol=1e-7, err_msg=k)


def test_jax_rules_exist_for_every_port_rule():
    for name in ("Adamax", "Adagrad", "Adadelta", "RMSProp", "Lamb"):
        assert hasattr(paddle.optimizer, name)
