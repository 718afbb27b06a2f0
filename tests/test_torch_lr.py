"""The port's LR schedulers (`paddle_tpu_torch.optimizer.lr`) against the
JAX package's (`paddle_tpu.optimizer.lr`): every scheduler gives the same
value over 30 steps (rtol 1e-12: both are the same Python arithmetic), the
same `state_dict`, and a state dict saved by either package resumes the
other's schedule on the same values; `ReduceOnPlateau.step(metrics)` is
driven by one seeded series of metrics in both."""
import math

import numpy as np
import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

STEPS = 30
RTOL = 1e-12


def _lam(epoch):
    return 0.95 ** epoch


def _mult(epoch):
    return 0.9 if epoch % 3 else 1.1


# (class name, positional args, keyword args); LinearWarmup's inner
# scheduler is built in each package by `_make`
CASES = [
    ("NoamDecay", (64, 10), {"learning_rate": 2.0}),
    ("PiecewiseDecay", ([3, 9, 20], [0.1, 0.05, 0.01, 0.001]), {}),
    ("NaturalExpDecay", (0.5, 0.1), {}),
    ("InverseTimeDecay", (0.5, 0.2), {}),
    ("PolynomialDecay", (0.1, 12), {"end_lr": 0.001, "power": 2.0}),
    ("PolynomialDecay", (0.1, 7), {"end_lr": 0.001, "cycle": True}),
    ("LinearWarmup", (0.1, 5, 0.0, 0.1), {}),
    ("LinearWarmup", ("cosine", 5, 0.0, 1e-4), {}),
    ("ExponentialDecay", (0.1, 0.9), {}),
    ("MultiStepDecay", (0.1, [4, 10, 17]), {"gamma": 0.5}),
    ("StepDecay", (0.1, 4), {"gamma": 0.7}),
    ("LambdaDecay", (0.1, _lam), {}),
    ("MultiplicativeDecay", (0.1, _mult), {}),
    ("CosineAnnealingDecay", (0.1, 13), {"eta_min": 0.001}),
    ("ReduceOnPlateau", (0.1,), {"patience": 2, "cooldown": 1,
                                 "factor": 0.5}),
    ("CyclicLR", (0.01, 0.1, 4), {"step_size_down": 6}),
    ("CyclicLR", (0.01, 0.1, 3), {"mode": "triangular2"}),
    ("CyclicLR", (0.01, 0.1, 3), {"mode": "exp_range", "exp_gamma": 0.97}),
    ("OneCycleLR", (0.1, 25), {}),
    ("OneCycleLR", (0.1, 25), {"anneal_strategy": "linear",
                               "phase_pct": 0.4}),
]
IDS = [f"{name}-{i}" for i, (name, _, _) in enumerate(CASES)]


def _make(mod, name, args, kw):
    if args and args[0] == "cosine":
        args = (mod.CosineAnnealingDecay(1e-4, T_max=100),) + args[1:]
    return getattr(mod, name)(*args, **kw)


def _metrics(n=STEPS, seed=0):
    rs = np.random.RandomState(seed)
    # a falling loss that stalls, so the plateau rule fires
    return [float(v) for v in
            np.maximum(np.linspace(2.0, 0.5, n), 1.0) + 0.01 * rs.rand(n)]


def _step(s, metric):
    if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        s.step(metric)
    else:
        s.step()


def _run(s, n, metrics):
    out = []
    for i in range(n):
        out.append(s())
        _step(s, metrics[i])
    return out


def test_every_scheduler_is_covered():
    names = {n for n, _, _ in CASES}
    jax_names = {n for n, v in vars(jlr).items() if isinstance(v, type)
                 and issubclass(v, jlr.LRScheduler) and v is not
                 jlr.LRScheduler}
    assert names == jax_names and len(names) == 15
    assert {n for n, v in vars(tlr).items() if isinstance(v, type)
            and issubclass(v, tlr.LRScheduler)} == jax_names | {"LRScheduler"}


@pytest.mark.parametrize("name,args,kw", CASES, ids=IDS)
def test_schedule_matches_jax(name, args, kw):
    metrics = _metrics()
    want = _run(_make(jlr, name, args, kw), STEPS, metrics)
    got = _run(_make(tlr, name, args, kw), STEPS, metrics)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert all(math.isfinite(v) for v in got)
    assert len(set(got)) > 1, got          # the schedule moves


@pytest.mark.parametrize("name,args,kw", CASES, ids=IDS)
def test_state_dict_round_trips_between_packages(name, args, kw):
    metrics = _metrics(2 * STEPS, seed=1)
    j, t = _make(jlr, name, args, kw), _make(tlr, name, args, kw)
    _run(j, 10, metrics)
    _run(t, 10, metrics)
    assert t.state_dict() == j.state_dict()
    # each package resumes from the other's state dict
    j2, t2 = _make(jlr, name, args, kw), _make(tlr, name, args, kw)
    j2.set_state_dict(t.state_dict())
    t2.set_state_dict(j.state_dict())
    rest = metrics[10:]
    want = _run(j, STEPS, rest)
    np.testing.assert_allclose(_run(j2, STEPS, rest), want, rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(_run(t2, STEPS, rest), want, rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(_run(t, STEPS, rest), want, rtol=RTOL, atol=0)
