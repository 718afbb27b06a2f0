"""The port's incubate (paddle_tpu_torch/incubate) against the JAX
package's `paddle_tpu.incubate.nn`, on the CPU, on the same numpy inputs
(`tests/test_domains.py:171` and `:193`'s functions), float32 within
1e-5:

- `fused_ec_moe` (tanh GELU and ReLU; biases ``[e, 1, f]``) and its
  gradients; `FusedEcMoe` (a `MoELayer` that ignores `gate_logits`) from
  the JAX layer's weights;
- `fused_matmul_bias` (each transpose) and `fused_linear` (with and
  without `transpose_weight`);
- `fused_multi_head_attention` at dropout 0, pre- and post-LN, with and
  without a padding mask (additive and bool), with `transpose_qkv_wb`,
  the output and the gradients of x and the weights; the errors JAX
  raises for `cache_kv`, another dropout mode, and `transpose_qkv_wb`
  without `num_heads`.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.incubate import nn as jinc
from paddle_tpu.incubate.nn import functional as jF
from paddle_tpu_torch.incubate import nn as inc
from paddle_tpu_torch.incubate.nn import functional as pF
from paddle_tpu_torch.weights import from_jax_state_dict
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

TOL = 1e-5


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL, err_msg=msg)


def _jax_call(fn, arrays, grad_of=(), **kw):
    """`fn` on paddle tensors of `arrays` ({name: numpy}); the output, and
    the gradients of ``sum(out * dO)`` (dO from a seed) for `grad_of`."""
    ts = {}
    for k, a in arrays.items():
        t = paddle.to_tensor(a)
        if k in grad_of:
            t.stop_gradient = False
        ts[k] = t
    out = fn(**ts, **kw)
    grads = {}
    if grad_of:
        do = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
        (out * paddle.to_tensor(do)).sum().backward()
        grads = {k: np.asarray(ts[k].grad.numpy()) for k in grad_of}
    return np.asarray(out.numpy()), grads


def _port_call(fn, arrays, grad_of=(), **kw):
    ts = {k: torch.tensor(a, requires_grad=k in grad_of)
          for k, a in arrays.items()}
    out = fn(**ts, **kw)
    grads = {}
    if grad_of:
        do = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
        (out * torch.from_numpy(do)).sum().backward()
        grads = {k: ts[k].grad.numpy() for k in grad_of}
    return out.detach().numpy(), grads


# -- fused_ec_moe -------------------------------------------------------------


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_ec_moe_matches_jax(act):
    rs = np.random.RandomState(1)
    b, s, d, f, e = 2, 4, 8, 16, 3
    arrays = dict(x=rs.randn(b, s, d), gate=rs.randn(b, s, e),
                  bmm0_weight=rs.randn(e, d, f) * 0.2,
                  bmm0_bias=rs.randn(e, 1, f) * 0.1,
                  bmm1_weight=rs.randn(e, f, d) * 0.2,
                  bmm1_bias=rs.randn(e, 1, d) * 0.1)
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    names = tuple(arrays)
    want, wg = _jax_call(jF.fused_ec_moe, arrays, names, act_type=act)
    got, gg = _port_call(pF.fused_ec_moe, arrays, names, act_type=act)
    _close(got, want)
    for k in names:
        _close(gg[k], wg[k], k)
    with pytest.raises(ValueError, match="act_type"):
        pF.fused_ec_moe(*(torch.from_numpy(a) for a in arrays.values()),
                        act_type="swish")


def test_fused_ec_moe_layer_matches_jax():
    """`FusedEcMoe(8, 16, 4)` from the JAX layer's weights: the same
    output, whatever `gate_logits` says."""
    paddle.seed(2)
    jl = jinc.FusedEcMoe(8, 16, 4)
    weights = {k: np.asarray(v) for k, v in state_dict_arrays(jl)[0].items()}
    port = from_jax_state_dict(inc.FusedEcMoe(8, 16, 4, device="cpu"),
                               weights)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 6, 8).astype(np.float32)
    logits = rs.randn(2, 6, 4).astype(np.float32)
    want = np.asarray(jl(paddle.to_tensor(x), paddle.to_tensor(logits))
                      .numpy())
    got = port(torch.from_numpy(x), torch.from_numpy(logits))
    _close(got.detach(), want)
    _close(port(torch.from_numpy(x)).detach(), want)


# -- the fused linears --------------------------------------------------------


@pytest.mark.parametrize("tx,ty", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_fused_matmul_bias_matches_jax(tx, ty):
    rs = np.random.RandomState(4)
    x = rs.randn(3, 5, 6).astype(np.float32)
    y = rs.randn(6, 7).astype(np.float32)
    x = x.transpose(0, 2, 1).copy() if tx else x
    y = y.T.copy() if ty else y
    bias = rs.randn(7).astype(np.float32)
    for kw in ({"bias": bias}, {}):
        arrays = dict(x=x, y=y, **kw)
        want, _ = _jax_call(jF.fused_matmul_bias, arrays, transpose_x=tx,
                            transpose_y=ty)
        got, _ = _port_call(pF.fused_matmul_bias, arrays, transpose_x=tx,
                            transpose_y=ty)
        _close(got, want)


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_matches_jax(transpose):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 3, 6).astype(np.float32)
    w = rs.randn(6, 4).astype(np.float32)
    w = w.T.copy() if transpose else w
    arrays = dict(x=x, weight=w, bias=rs.randn(4).astype(np.float32))
    want, wg = _jax_call(jF.fused_linear, arrays, ("x", "weight"),
                         transpose_weight=transpose)
    got, gg = _port_call(pF.fused_linear, arrays, ("x", "weight"),
                         transpose_weight=transpose)
    _close(got, want)
    for k in wg:
        _close(gg[k], wg[k], k)


# -- fused_multi_head_attention -----------------------------------------------

B, S, E, HEADS = 2, 8, 16, 4


def _mha_arrays(transpose_qkv_wb, seed=0):
    """`tests/test_domains.py:171`'s shapes, with biases and LN affine
    weights drawn (not zero and one) so that each reaches the output."""
    rs = np.random.RandomState(seed)
    d = E // HEADS
    arrays = dict(
        x=rs.randn(B, S, E),
        qkv_weight=(rs.randn(E, 3 * E) if transpose_qkv_wb
                    else rs.randn(3, HEADS, d, E)) * 0.2,
        qkv_bias=(rs.randn(3 * E) if transpose_qkv_wb
                  else rs.randn(3, HEADS, d)) * 0.1,
        linear_weight=rs.randn(E, E) * 0.2, linear_bias=rs.randn(E) * 0.1,
        pre_ln_scale=1 + 0.1 * rs.randn(E), pre_ln_bias=0.1 * rs.randn(E),
        ln_scale=1 + 0.1 * rs.randn(E), ln_bias=0.1 * rs.randn(E))
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _mask(kind):
    """A padding mask [B, 1, 1, S] of real lengths S and S - 3: additive
    (0 / -1e4) or bool (True where real)."""
    real = np.arange(S)[None] < np.asarray([S, S - 3])[:, None]
    if kind == "additive":
        return np.where(real, 0.0, -1e4).astype(np.float32)[:, None, None]
    return real[:, None, None]


@pytest.mark.parametrize("mask", [None, "additive", "bool"])
@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("transpose_qkv_wb", [False, True])
def test_fused_multi_head_attention_matches_jax(pre_ln, mask,
                                                transpose_qkv_wb):
    arrays = _mha_arrays(transpose_qkv_wb)
    if mask is not None:
        arrays["attn_mask"] = _mask(mask)
    kw = dict(pre_layer_norm=pre_ln, dropout_rate=0.0, attn_dropout_rate=0.0,
              training=True, transpose_qkv_wb=transpose_qkv_wb,
              num_heads=HEADS if transpose_qkv_wb else -1)
    grad_of = ("x", "qkv_weight", "qkv_bias", "linear_weight",
               "ln_scale" if not pre_ln else "pre_ln_scale")
    want, wg = _jax_call(jF.fused_multi_head_attention, arrays, grad_of,
                         **kw)
    got, gg = _port_call(pF.fused_multi_head_attention, arrays, grad_of,
                         **kw)
    assert got.shape == (B, S, E)
    _close(got, want)
    for k in grad_of:
        _close(gg[k], wg[k], k)


def test_fused_multi_head_attention_in_eval_ignores_the_rates():
    """training=False: the dropout rates do nothing (JAX's defaults are
    0.5 each)."""
    arrays = _mha_arrays(False)
    want, _ = _jax_call(jF.fused_multi_head_attention, arrays,
                        training=False)
    got, _ = _port_call(pF.fused_multi_head_attention, arrays,
                        training=False)
    _close(got, want)


def test_fused_multi_head_attention_raises_as_jax():
    arrays = _mha_arrays(False)
    cases = ((NotImplementedError, "cache_kv",
              dict(cache_kv=arrays["x"])),
             (NotImplementedError, "mode", dict(mode="downscale_in_infer")),
             (ValueError, "num_heads", dict(transpose_qkv_wb=True)))
    for err, words, kw in cases:
        for fn, conv in ((jF.fused_multi_head_attention, paddle.to_tensor),
                         (pF.fused_multi_head_attention, torch.from_numpy)):
            args = {k: conv(arrays[k])
                    for k in ("x", "qkv_weight", "linear_weight")}
            kw2 = {k: conv(v) if isinstance(v, np.ndarray) else v
                   for k, v in kw.items()}
            with pytest.raises(err, match=words):
                fn(**args, **kw2)
