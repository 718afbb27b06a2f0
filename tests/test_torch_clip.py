"""The port's gradient clipping (`paddle_tpu_torch.nn.clip`) against the JAX
package's (`paddle_tpu.nn.clip`), on the same seeded numpy gradients:

- `ClipGradByValue`, `ClipGradByNorm`, `ClipGradByGlobalNorm` through
  `clip_arrays` (the compiled step's form) and through the
  ``(param, grad)`` call (`_dygraph_clip`, with a ``need_clip=False``
  parameter passed through), and `clip_grad_norm_` / `clip_grad_value_`
  on parameters' gradients;
- float32 gradients within 1e-7 absolute (the norms sum in another order:
  a rounding of the scale apart, on gradients below 0.5) and the returned
  norm within one float32 rounding (2^-23 relative), bfloat16 bit-equal;
- the SGD scenarios of `tests/test_optimizer.py` (clip inside the
  optimizer, coupled weight decay, a scheduler read by `get_lr`) in both
  packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as joptim
from paddle_tpu.nn import clip as jclip
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as toptim
from paddle_tpu_torch.nn import clip as tclip

SHAPES = [(8, 6), (6,), (16, 5), (3,)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32_ATOL = 1e-7
CLASSES = [("ClipGradByValue", (0.3,), {"min": -0.2}),
           ("ClipGradByNorm", (0.5,), {}),
           ("ClipGradByGlobalNorm", (1.0,), {})]


def _grads(seed, scale=0.5):
    """Gradients with entries in (-scale, scale) and one tensor far
    smaller than the rest, so every clip path sees both sides of its
    threshold."""
    rs = np.random.RandomState(seed)
    gs = [(rs.rand(*s) * 2 - 1).astype(np.float32) * scale for s in SHAPES]
    gs[1] *= 1e-3
    return gs


def _check(got, want, dtype, rtol=0.0, atol=F32_ATOL):
    for g, w in zip(got, want):
        g = g.float().numpy()
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,args,kw", CLASSES,
                         ids=[c[0] for c in CLASSES])
def test_clip_arrays_match_jax(name, args, kw, seed, dtype):
    jdt, tdt = DTYPES[dtype]
    gs = _grads(seed)
    want = getattr(jclip, name)(*args, **kw).clip_arrays(
        [jnp.asarray(g, jdt) for g in gs])
    got = getattr(tclip, name)(*args, **kw).clip_arrays(
        [torch.from_numpy(g).to(tdt) for g in gs])
    assert all(g.dtype == tdt for g in got)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name,args,kw", CLASSES,
                         ids=[c[0] for c in CLASSES])
def test_param_grad_pairs_match_jax_dygraph_clip(name, args, kw, dtype):
    """The ``(param, grad)`` form: a None gradient and a parameter with
    ``need_clip`` False pass as they are."""
    jdt, tdt = DTYPES[dtype]
    gs = _grads(7, scale=2.0)
    jp = [paddle.Parameter(np.zeros(s, np.float32)) for s in SHAPES]
    tp = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    jp[2].need_clip = tp[2].need_clip = False
    jpairs = [(p, paddle.to_tensor(np.asarray(jnp.asarray(g, jdt)
                                              .astype(jnp.float32)))
               .astype(dtype)) for p, g in zip(jp, gs)]
    tpairs = [(p, torch.from_numpy(g).to(tdt)) for p, g in zip(tp, gs)]
    jpairs[3] = (jp[3], None)
    tpairs[3] = (tp[3], None)
    want = getattr(jclip, name)(*args, **kw)(jpairs)
    got = getattr(tclip, name)(*args, **kw)(tpairs)
    assert got[3][1] is None and want[3][1] is None
    assert got[2][1] is tpairs[2][1]          # need_clip False: untouched
    _check([g for _, g in got[:3]], [w._array for _, w in want[:3]], dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("norm_type", [2.0, 1.0])
def test_clip_grad_norm_matches_jax(dtype, norm_type):
    jdt, tdt = DTYPES[dtype]
    gs = _grads(3, scale=1.5)
    jp = [paddle.Parameter(np.zeros(s, np.float32)) for s in SHAPES]
    tp = [torch.nn.Parameter(torch.zeros(s, dtype=tdt)) for s in SHAPES]
    for p, q, g in zip(jp, tp, gs):
        p._grad = jnp.asarray(g, jdt)
        q.grad = torch.from_numpy(g).to(tdt)
    jp[1]._grad = None
    tp[1].grad = None
    want_total = jclip.clip_grad_norm_(jp, 1.0, norm_type)
    got_total = tclip.clip_grad_norm_(tp, 1.0, norm_type)
    _check([got_total], [want_total._array], dtype, rtol=2.0 ** -23,
           atol=0.0)
    assert tp[1].grad is None
    _check([tp[i].grad for i in (0, 2, 3)], [jp[i]._grad for i in (0, 2, 3)],
           dtype)
    assert float(got_total) > 1.0              # the clip was taken


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_clip_grad_value_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    gs = _grads(4, scale=1.0)
    jp = [paddle.Parameter(np.zeros(s, np.float32)) for s in SHAPES]
    tp = [torch.nn.Parameter(torch.zeros(s, dtype=tdt)) for s in SHAPES]
    for p, q, g in zip(jp, tp, gs):
        p._grad = jnp.asarray(g, jdt)
        q.grad = torch.from_numpy(g).to(tdt)
    jclip.clip_grad_value_(jp, 0.3)
    tclip.clip_grad_value_(tp, 0.3)
    _check([p.grad for p in tp], [p._grad for p in jp], dtype)


def test_global_norm_is_kept_on_the_device_and_clip_reads_no_host_value():
    """The pre-clip norm stays a tensor (`global_norm`): the clip never
    asks the host for a value."""
    gs = [torch.from_numpy(g) for g in _grads(5, scale=3.0)]
    clip = tnn.ClipGradByGlobalNorm(1.0)
    out = clip.clip_arrays(gs)
    assert torch.is_tensor(clip.global_norm) and clip.global_norm.dtype \
        == torch.float32
    want = torch.sqrt(sum((g.double() ** 2).sum() for g in gs))
    assert abs(clip.global_norm.item() - want.item()) < 1e-5
    total = torch.sqrt(sum((g.double() ** 2).sum() for g in out))
    assert abs(total.item() - 1.0) < 1e-6


# -- the SGD scenarios of tests/test_optimizer.py, in both packages ---------

def _sgd_pair(value, **kw):
    jw = paddle.Parameter(np.array([value], np.float32))
    tw = torch.nn.Parameter(torch.tensor([value]))
    return jw, tw


def test_grad_clip_in_optimizer():
    jw, tw = _sgd_pair(1.0)
    jopt = joptim.SGD(learning_rate=1.0, parameters=[jw],
                      grad_clip=jnn.ClipGradByGlobalNorm(0.1))
    topt = toptim.SGD(learning_rate=1.0, parameters=[tw],
                      grad_clip=tnn.ClipGradByGlobalNorm(0.1))
    (jw * 100.0).sum().backward()
    (tw * 100.0).sum().backward()
    jopt.step()
    topt.step()
    assert abs(tw.item() - 0.9) < 1e-4       # the clipped gradient is 0.1
    assert tw.item() == float(jw.numpy()[0])
    assert tw.grad.item() == 100.0           # the clip leaves .grad alone


def test_weight_decay_coupled():
    jw, tw = _sgd_pair(2.0)
    jopt = joptim.SGD(learning_rate=0.1, parameters=[jw], weight_decay=0.5)
    topt = toptim.SGD(learning_rate=0.1, parameters=[tw], weight_decay=0.5)
    (jw * 0.0).sum().backward()
    (tw * 0.0).sum().backward()
    jopt.step()
    topt.step()
    assert abs(tw.item() - (2.0 - 0.1 * 0.5 * 2.0)) < 1e-5
    assert tw.item() == float(jw.numpy()[0])
    assert tw.grad.item() == 0.0             # the decay leaves .grad alone


def test_scheduler_in_optimizer():
    jw, tw = _sgd_pair(1.0)
    jsched = joptim.lr.StepDecay(0.1, step_size=1, gamma=0.1)
    tsched = toptim.lr.StepDecay(0.1, step_size=1, gamma=0.1)
    jopt = joptim.SGD(learning_rate=jsched, parameters=[jw])
    topt = toptim.SGD(learning_rate=tsched, parameters=[tw])
    assert topt.get_lr() == jopt.get_lr() == pytest.approx(0.1)
    for _ in range(3):
        (jw * 3.0).sum().backward()
        (tw * 3.0).sum().backward()
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        jsched.step()
        tsched.step()
        assert topt.get_lr() == jopt.get_lr()
        assert tw.item() == float(jw.numpy()[0])
    assert topt.get_lr() == pytest.approx(1e-4)
    topt.set_lr(0.5)
    assert topt.get_lr() == 0.5
