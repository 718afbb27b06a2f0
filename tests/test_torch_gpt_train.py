"""The port's GPT training step against the JAX package's, on the CPU in
float32: the loss, the gradients, and three AdamW steps (loss trajectory
and final parameters), with the one-product head and the chunked fused
head. Weights are carried over with `from_jax_state_dict` and back with
`to_jax_state_dict`; ids and labels come from a seeded numpy RNG.

The port's step is the PyTorch idiom (`model.train()`, `loss.backward()`,
`opt.step()`, `opt.zero_grad()`); the JAX step is `bench.py`'s
(`functional_call(..., labels=...)`, `jax.value_and_grad`,
`apply_gradients_arrays`), jitted.
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
from paddle_tpu.models.gpt import gpt_loss_fn as jax_gpt_loss_fn
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import from_jax_state_dict, to_jax_state_dict
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64)
LR = 1e-3
STEPS = 3
# float32 on both sides, different summation orders: the loss to 1e-5
# relative, gradients and parameters after three steps to 2e-5 absolute
LOSS_RTOL, ATOL = 1e-5, 2e-5
# Gradients below this share of the largest in their tensor are float
# noise: the key bias's gradient is exactly zero (softmax ignores a shift
# shared by all of a query's scores), and Adam scales noise up to a step of
# about lr either way. Those entries are held to the bound of that
# difference, 2 * STEPS * lr, instead.
NOISE = 1e-6


def _batch(b=2, s=64, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 512, (b, s)).astype(np.int64),
            rs.randint(0, 512, (b, s)).astype(np.int64))


def _jax_run(fused_head_chunks, ids, labels):
    """Loss per step, the first step's gradients and the final parameters
    of the JAX package's jitted train step."""
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, fused_head_chunks=fused_head_chunks))
    params, buffers = state_dict_arrays(jm)
    init = {k: np.asarray(v) for k, v in params.items()}
    opt = JaxAdamW(learning_rate=LR, parameters=jm.parameters())
    opt_state = opt.init_state_arrays(params)

    def step(params, opt_state, ids, labels):
        def loss_fn(p):
            loss, _ = functional_call(jm, p, buffers, args=(ids,),
                                      kwargs={"labels": labels},
                                      training=True)
            return loss
        loss, grads = jax.value_and_grad(loss_fn)(params)
        new_params, new_opt = opt.apply_gradients_arrays(
            params, grads, opt_state, jnp.asarray(LR, jnp.float32))
        return loss, grads, new_params, new_opt

    jstep = jax.jit(step)
    losses, first_grads = [], None
    for _ in range(STEPS):
        loss, grads, params, opt_state = jstep(
            params, opt_state, jnp.asarray(ids, jnp.int32),
            jnp.asarray(labels, jnp.int32))
        losses.append(float(loss))
        first_grads = first_grads or {k: np.asarray(v)
                                      for k, v in grads.items()}
    return init, losses, first_grads, {k: np.asarray(v)
                                       for k, v in params.items()}


def _torch_run(init, fused_head_chunks, ids, labels):
    model = from_jax_state_dict(
        GPT(GPTConfig(**CFG, fused_head_chunks=fused_head_chunks),
            device="cpu"), init)
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    ids, labels = torch.from_numpy(ids), torch.from_numpy(labels)
    model.train()
    losses, first_grads = [], None
    for _ in range(STEPS):
        loss = model(ids, labels=labels)
        loss.backward()
        if first_grads is None:
            first_grads = _grads_in_jax_layout(model)
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(loss.item())
    return losses, first_grads, to_jax_state_dict(model)


def _grads_in_jax_layout(model):
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        out[name] = g.T if isinstance(
            model.get_submodule(name.rsplit(".", 1)[0]),
            torch.nn.Linear) and name.endswith("weight") else g
    return out


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.mark.parametrize("fused_head_chunks", [None, 4])
def test_train_steps_match_jax(batch, fused_head_chunks):
    init, want_losses, want_grads, want_params = _jax_run(
        fused_head_chunks, *batch)
    losses, grads, params = _torch_run(init, fused_head_chunks, *batch)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    assert set(grads) == set(want_grads) == set(params) == set(want_params)
    for k in grads:
        np.testing.assert_allclose(grads[k], want_grads[k], atol=ATOL,
                                   rtol=0, err_msg=f"grad {k}")
    for k in params:
        assert params[k].shape == want_params[k].shape, k
        g = np.abs(want_grads[k])
        noise = g < NOISE * g.max()
        np.testing.assert_allclose(params[k][~noise], want_params[k][~noise],
                                   atol=ATOL, rtol=0, err_msg=f"param {k}")
        assert np.all(np.abs(params[k] - want_params[k])[noise]
                      <= 2 * STEPS * LR), k
    # the noise-level entries are the key biases and a handful of others
    n_noise = sum(int((np.abs(g) < NOISE * np.abs(g).max()).sum())
                  for g in want_grads.values())
    assert n_noise < 200


def test_heads_agree_and_loss_fn_matches_jax(batch):
    """The unfused head, the fused head and `gpt_loss_fn` on the logits
    give one loss; `gpt_loss_fn` is the JAX package's."""
    ids, labels = map(torch.from_numpy, batch)
    losses = []
    for chunks in (None, 1, 4):
        m = GPT(GPTConfig(**CFG, fused_head_chunks=chunks), device="cpu",
                seed=3)
        with torch.no_grad():
            losses.append(m(ids, labels=labels).item())
    with torch.no_grad():
        logits = m(ids)
    got = gpt_loss_fn(logits, labels).item()
    want = float(jax_gpt_loss_fn(jnp.asarray(logits.numpy()),
                                 jnp.asarray(batch[1], jnp.int32)))
    np.testing.assert_allclose(losses + [got], [want] * 4, rtol=LOSS_RTOL)


def test_to_jax_state_dict_inverts_from_jax_state_dict():
    m = GPT(GPTConfig(**CFG), device="cpu", seed=5)
    arrays = to_jax_state_dict(m)
    assert arrays["blocks.0.attn.qkv.weight"].shape == (64, 192)
    back = from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu", seed=6),
                               arrays)
    for (n, a), (_, b) in zip(m.named_parameters(), back.named_parameters()):
        assert torch.equal(a, b), n
    bf = to_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu", seed=5,
                               dtype=torch.bfloat16))
    assert bf["wte.weight"].dtype == np.float32


@pytest.mark.parametrize("kw,match", [(dict(remat=True), "remat"),
                                      (dict(attn_impl="ring"), "ring")])
def test_unported_config_values_raise(batch, kw, match):
    """Both values, once refused here, are ported. Ring attention: at
    dropout 0 the loss and gradients of ``GPTConfig(attn_impl="ring")``
    with no mesh equal the JAX GPT's with ``attn_impl="ring"`` on one
    device (its ring's fallback: causal attention, no dropout); at
    dropout 0.1 they equal, under the same generators, the port's flash
    model whose attention takes no dropout (the JAX ring branch drops
    none; the JAX PRNG cannot match, so that check stays in the port).
    Remat: a remat model's training loss and gradients equal the plain
    model's (`test_torch_remat.py` holds it against JAX)."""
    if match == "ring":
        _ring_matches_jax_and_drops_no_attention(batch)
        return
    ids, labels = map(torch.from_numpy, batch)
    runs = []
    for cfg in (GPTConfig(**CFG), GPTConfig(**CFG, **kw)):
        m = GPT(cfg, device="cpu", seed=1)
        m.train()
        loss = m(ids, labels=labels)
        loss.backward()
        runs.append((loss.item(), [p.grad for p in m.parameters()]))
    assert runs[1][0] == runs[0][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def _ring_matches_jax_and_drops_no_attention(batch):
    from paddle_tpu.distributed.mesh import set_mesh as jax_set_mesh

    jax_set_mesh(None)             # one device: the JAX ring's fallback
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, attn_impl="ring"))
    params, buffers = state_dict_arrays(jm)
    init = {k: np.asarray(v) for k, v in params.items()}

    def loss_fn(p):
        loss, _ = functional_call(jm, p, buffers, args=(
            jnp.asarray(batch[0], jnp.int32),), kwargs={
                "labels": jnp.asarray(batch[1], jnp.int32)}, training=True)
        return loss

    want, jgrads = jax.value_and_grad(loss_fn)(params)
    ids, labels = map(torch.from_numpy, batch)
    m = from_jax_state_dict(GPT(GPTConfig(**CFG, attn_impl="ring"),
                                device="cpu"), init)
    m.train()
    loss = m(ids, labels=labels)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    grads = _grads_in_jax_layout(m)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k], np.asarray(g), atol=ATOL,
                                   rtol=0, err_msg=k)
    runs = []
    for impl in ("ring", "flash"):
        m = GPT(GPTConfig(**CFG, attn_impl=impl, dropout=0.1), device="cpu",
                seed=1)
        for blk in m.blocks:
            blk.attn.dropout = 0.0      # the flash model's: none either
        m.train()
        loss = m(ids, labels=labels)
        loss.backward()
        runs.append((loss.item(), [p.grad for p in m.parameters()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dropout_trains_and_eval_equals_no_dropout(batch):
    """GPTConfig(dropout=0.1) trains on the CPU (embedding, residual and
    attention dropout, the JAX model's sites): losses finite and falling
    on one batch; in eval it equals the dropout-0 model with the same
    weights, and train mode differs from it."""
    ids, labels = map(torch.from_numpy, batch)
    model = GPT(GPTConfig(**CFG, dropout=0.1), device="cpu", seed=4)
    model.seed_dropout(9)
    plain = GPT(GPTConfig(**CFG), device="cpu", seed=4)
    with torch.no_grad():
        torch.testing.assert_close(model(ids), plain(ids), atol=0, rtol=0)
        model.train()
        assert (model(ids) - plain(ids)).abs().max() > 1e-3
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    losses = []
    for _ in range(6):
        loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(loss.item())
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < losses[0], losses
