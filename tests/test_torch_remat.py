"""Remat (`GPTConfig(remat=True)`, `BertConfig(remat=True)`, through
`paddle_tpu_torch.distributed.fleet.utils.recompute`) on the CPU:

1. the port's GPT with remat against the JAX GPT with remat at 2 layers in
   float32, at `test_torch_gpt_train.py`'s bar (loss 1e-5 relative,
   gradients and parameters after three AdamW steps 2e-5 absolute);
2. the port's remat against its own no-remat run with dropout 0.1 (the
   attention dropout's seed and the elementwise dropouts' masks drawn
   inside the recomputed block): losses and gradients equal, and the
   dropout generators left where the no-remat run leaves them; a
   recompute that is not told the generators gets other masks;
3. BERT with remat and a padding mask equal to BERT without remat;
4. the JAX BERT's remat drops the mask (its output equals the maskless
   one); the port's differs from the maskless one: the fault is not
   copied.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.functional import functional_call, state_dict_arrays
from paddle_tpu.models.bert import Bert as JaxBert
from paddle_tpu.models.bert import BertConfig as JaxBertConfig
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.distributed.fleet.utils import recompute
from paddle_tpu_torch.models.bert import Bert, BertConfig
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import from_jax_state_dict, to_jax_state_dict
from test_torch_gpt_train import (ATOL, CFG, LOSS_RTOL, LR, NOISE, STEPS,
                                  _batch, _grads_in_jax_layout)
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

BERT_CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                intermediate_size=256, max_position_embeddings=64)


@pytest.fixture(scope="module")
def batch():
    return _batch()


def test_gpt_remat_matches_jax_remat(batch):
    ids, labels = batch
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, remat=True))
    params, buffers = state_dict_arrays(jm)
    init = {k: np.asarray(v) for k, v in params.items()}
    jopt = JaxAdamW(learning_rate=LR, parameters=jm.parameters())
    jstate = jopt.init_state_arrays(params)

    @jax.jit
    def jstep(params, state):
        def loss_fn(p):
            loss, _ = functional_call(jm, p, buffers, args=(
                jnp.asarray(ids, jnp.int32),), kwargs={
                "labels": jnp.asarray(labels, jnp.int32)}, training=True)
            return loss
        loss, grads = jax.value_and_grad(loss_fn)(params)
        new_params, new_state = jopt.apply_gradients_arrays(
            params, grads, state, jnp.asarray(LR, jnp.float32))
        return loss, grads, new_params, new_state

    model = from_jax_state_dict(GPT(GPTConfig(**CFG, remat=True),
                                    device="cpu"), init)
    opt = AdamW(learning_rate=LR, parameters=model.parameters())
    model.train()
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    want_losses, losses = [], []
    for i in range(STEPS):
        loss, jgrads, params, jstate = jstep(params, jstate)
        want_losses.append(float(loss))
        tl = model(tids, labels=tlabels)
        tl.backward()
        if i == 0:
            want_grads = {k: np.asarray(v) for k, v in jgrads.items()}
            grads = _grads_in_jax_layout(model)
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(tl.item())
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    for k in want_grads:
        np.testing.assert_allclose(grads[k], want_grads[k], atol=ATOL,
                                   rtol=0, err_msg=f"grad {k}")
    got = to_jax_state_dict(model)
    for k, want in params.items():
        want = np.asarray(want)
        g = np.abs(want_grads[k])
        noise = g < NOISE * g.max()
        np.testing.assert_allclose(got[k][~noise], want[~noise], atol=ATOL,
                                   rtol=0, err_msg=f"param {k}")
        assert np.all(np.abs(got[k] - want)[noise] <= 2 * STEPS * LR), k


def _gen_states(model):
    g = model.dropout_generators
    return g.attn.get_state(), g.elem.get_state()


def _one_step(model, run):
    """One forward and backward of `run(model)` with dropout generators
    seeded 7; returns (loss, {name: grad}, generator states after)."""
    model.train()
    model.seed_dropout(7)
    loss = run(model)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads, _gen_states(model)


def _gpt_pair(remat_a=False, remat_b=True, dropout=0.1):
    a = GPT(GPTConfig(**CFG, dropout=dropout, remat=remat_a), device="cpu",
            seed=4)
    b = GPT(GPTConfig(**CFG, dropout=dropout, remat=remat_b), device="cpu",
            seed=4)
    return a, b


def _assert_same_step(a, b):
    la, ga, sa = a
    lb, gb, sb = b
    assert la == lb
    assert set(ga) == set(gb)
    for n in ga:
        torch.testing.assert_close(ga[n], gb[n], rtol=0, atol=0, msg=n)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


def test_gpt_remat_with_dropout_equals_no_remat(batch):
    ids, labels = map(torch.from_numpy, batch)
    plain, remat = _gpt_pair()

    def run(m):
        return m(ids, labels=labels)

    want = _one_step(plain, run)
    got = _one_step(remat, run)
    _assert_same_step(got, want)
    # dropout did act: the loss differs from the dropout-free model's
    free = GPT(GPTConfig(**CFG), device="cpu", seed=4)
    free.train()
    assert abs(free(ids, labels=labels).item() - want[0]) > 1e-4


def test_recompute_without_its_generators_draws_other_masks(batch):
    """What the generators argument is for: the same block recomputed
    without restoring the model's dropout generators sees other keep
    masks in the backward, so its gradients differ."""
    ids, labels = map(torch.from_numpy, batch)
    plain, _ = _gpt_pair()
    blind, _ = _gpt_pair()
    for blk in blind.blocks:
        inner = blk._inner
        blk.forward = (lambda x, cache=None, gens=None, inner=inner:
                       recompute(inner, x, gens))

    def run(m):
        return m(ids, labels=labels)

    want = _one_step(plain, run)
    got = _one_step(blind, run)
    assert got[0] == want[0]                     # the forward is the same
    assert max((got[1][n] - want[1][n]).abs().max().item()
               for n in want[1]) > 1e-4


def _bert_batch(seed=0, b=2, s=64):
    rs = np.random.RandomState(seed)
    lens = np.array([s // 2, s - 5])[:b]
    real = np.arange(s)[None] < lens[:, None]
    ids = np.where(real, rs.randint(0, BERT_CFG["vocab_size"], (b, s)), 0)
    labels = np.where(real & (rs.rand(b, s) < 0.15), ids, -100)
    mask = np.where(real, 0.0, -1e4).astype(np.float32)[:, None, None, :]
    return (torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask),
            torch.from_numpy(labels.astype(np.int64)))


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_bert_remat_with_padding_mask_equals_no_remat(dropout):
    from paddle_tpu_torch.models.bert import bert_pretrain_loss_fn

    ids, mask, labels = _bert_batch()
    plain = Bert(BertConfig(**BERT_CFG, dropout=dropout), device="cpu",
                 seed=2)
    remat = Bert(BertConfig(**BERT_CFG, dropout=dropout, remat=True),
                 device="cpu", seed=2)

    def run(m):
        return bert_pretrain_loss_fn(m(ids, None, mask), labels)

    _assert_same_step(_one_step(remat, run), _one_step(plain, run))


def test_bert_remat_keeps_the_mask_the_reference_drops():
    """The JAX BERT's remat calls ``recompute(self._inner, x)``: the mask
    never reaches attention, so its output equals the maskless one. The
    port's remat output equals the JAX no-remat output with the mask and
    differs from the maskless one."""
    ids, mask, _ = _bert_batch(1)
    paddle.seed(0)
    jm = JaxBert(JaxBertConfig(**BERT_CFG, dropout=0.0))
    params, buffers = state_dict_arrays(jm)
    arrays = {k: np.asarray(v) for k, v in params.items()}

    def jax_logits(remat, with_mask):
        jm.cfg.remat = remat
        for layer in jm.layers:
            layer._cfg.remat = remat
        out, _ = functional_call(
            jm, params, buffers, training=True,
            args=(jnp.asarray(ids.numpy(), jnp.int32), None,
                  jnp.asarray(mask.numpy()) if with_mask else None))
        return np.asarray(out[0])

    jax_masked = jax_logits(False, True)
    np.testing.assert_array_equal(jax_logits(True, True),
                                  jax_logits(True, False))
    model = from_jax_state_dict(
        Bert(BertConfig(**BERT_CFG, dropout=0.0, remat=True), device="cpu"),
        arrays)
    model.train()
    logits, _ = model(ids, None, mask)
    maskless, _ = model(ids, None, None)
    np.testing.assert_allclose(logits.detach().numpy(), jax_masked,
                               atol=1e-5, rtol=0)
    assert (logits - maskless).abs().max().item() > 1e-3
