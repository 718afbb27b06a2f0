"""The port's BERT / ERNIE encoder against the JAX package's, on the CPU in
float32: MLM and NSP logits (no mask, a [B, 1, 1, S] padding mask, a
[B, 1, S, S] mask), the pretrain loss, and three AdamW steps with the
padding mask; then what holds with dropout, the QKV column order, the
weights' round trip and what is not ported. Weights are carried over with
`from_jax_state_dict`; ids, masks and labels come from a seeded numpy RNG.
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
from paddle_tpu.models.bert import bert_pretrain_loss_fn as jax_loss_fn
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.models.bert import (Bert, BertConfig,
                                          bert_pretrain_loss_fn, ernie_base,
                                          split_qkv)
from paddle_tpu_torch.models.gpt import _split_fused_qkv
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.weights import from_jax_state_dict, to_jax_state_dict
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

CFG = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=256, max_position_embeddings=64)
B, S = 2, 64
ATOL = 1e-5          # float32 logits, two frameworks' summation orders
LR, WD, STEPS = 1e-3, 0.01, 3
# as in test_torch_gpt_train: the loss to 1e-5 relative, gradients and
# parameters to 2e-5; entries whose gradient is float noise (the key
# bias's is zero) are held to 2 * STEPS * LR instead
LOSS_RTOL, STEP_ATOL, NOISE = 1e-5, 2e-5, 1e-6


def _batch(seed=0):
    """ids, type ids (segment B on each row's second half), the additive
    padding mask [B, 1, 1, S] (0 on real keys, -1e4 on padding), and MLM
    labels (the id at 15 % of real positions, -100 elsewhere)."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(S // 2, S + 1, B)
    real = np.arange(S)[None] < lens[:, None]
    ids = np.where(real, rs.randint(0, CFG["vocab_size"], (B, S)), 0)
    types = (real & (np.arange(S)[None] >= (lens // 2)[:, None]))
    labels = np.where(real & (rs.rand(B, S) < 0.15), ids, -100)
    mask = np.where(real, 0.0, -1e4).astype(np.float32)[:, None, None, :]
    return (ids.astype(np.int64), types.astype(np.int64), mask,
            labels.astype(np.int64))


def _jax_model(dropout=0.0):
    paddle.seed(0)
    jm = JaxBert(JaxBertConfig(**CFG, dropout=dropout))
    params, buffers = state_dict_arrays(jm)
    return jm, params, buffers


def _port(params, dropout=0.0):
    arrays = {k: np.asarray(v) for k, v in params.items()}
    return from_jax_state_dict(
        Bert(BertConfig(**CFG, dropout=dropout), device="cpu"), arrays)


@pytest.fixture(scope="module")
def jax_model():
    return _jax_model()


@pytest.mark.parametrize("mask_kind", ["none", "padding", "full"])
def test_logits_match_jax(jax_model, mask_kind):
    jm, params, buffers = jax_model
    ids, types, pad, _ = _batch()
    mask = {"none": None, "padding": pad,
            "full": (np.random.RandomState(3).randn(B, 1, S, S) * 0.5
                     ).astype(np.float32)}[mask_kind]
    jm.eval()
    (want_lg, want_nsp), _ = functional_call(
        jm, params, buffers, training=False,
        args=(jnp.asarray(ids, jnp.int32), jnp.asarray(types, jnp.int32),
              None if mask is None else jnp.asarray(mask)))
    model = _port(params)
    with torch.no_grad():
        lg, nsp = model(torch.from_numpy(ids), torch.from_numpy(types),
                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(lg.numpy(), np.asarray(want_lg), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(nsp.numpy(), np.asarray(want_nsp), atol=ATOL,
                               rtol=0)


def test_pretrain_loss_matches_jax():
    rs = np.random.RandomState(5)
    logits = rs.randn(B, S, 512).astype(np.float32) * 3
    _, _, _, labels = _batch()
    want = float(jax_loss_fn((jnp.asarray(logits), None),
                             jnp.asarray(labels)))
    got = bert_pretrain_loss_fn((torch.from_numpy(logits), None),
                                torch.from_numpy(labels)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # no labelled position: zero, not a division by zero
    none = bert_pretrain_loss_fn(torch.from_numpy(logits),
                                 torch.full((B, S), -100))
    assert none.item() == 0.0


def _grads_in_jax_layout(model):
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        g = p.grad.numpy()
        out[name] = g.T if isinstance(
            model.get_submodule(name.rsplit(".", 1)[0]),
            torch.nn.Linear) and name.endswith("weight") else g
    return out


def test_train_steps_with_padding_match_jax():
    """Three AdamW steps with the padding mask: the JAX jitted step
    (functional_call, jax.value_and_grad, apply_gradients_arrays) against
    the port's PyTorch idiom. The MLM loss does not reach the pooler and
    the NSP head: JAX hands AdamW a zero gradient there, the port's
    autograd none, and both AdamWs decay them alike."""
    jm, params, buffers = _jax_model()
    init = {k: np.asarray(v) for k, v in params.items()}
    ids, types, mask, labels = _batch(1)
    opt = JaxAdamW(learning_rate=LR, weight_decay=WD,
                   parameters=jm.parameters())
    opt_state = opt.init_state_arrays(params)

    def step(params, opt_state):
        def loss_fn(p):
            out, _ = functional_call(
                jm, p, buffers, training=True,
                args=(jnp.asarray(ids, jnp.int32),
                      jnp.asarray(types, jnp.int32), jnp.asarray(mask)))
            return jax_loss_fn(out, jnp.asarray(labels))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        new_params, new_opt = opt.apply_gradients_arrays(
            params, grads, opt_state, jnp.asarray(LR, jnp.float32))
        return loss, grads, new_params, new_opt

    jstep = jax.jit(step)
    want_losses, want_grads = [], None
    for _ in range(STEPS):
        loss, grads, params, opt_state = jstep(params, opt_state)
        want_losses.append(float(loss))
        want_grads = want_grads or {k: np.asarray(v)
                                    for k, v in grads.items()}
    want_params = {k: np.asarray(v) for k, v in params.items()}

    model = _port(init)
    topt = AdamW(learning_rate=LR, weight_decay=WD,
                 parameters=model.parameters())
    model.train()
    losses, grads = [], None
    batch = [torch.from_numpy(a) for a in (ids, types, mask)]
    for _ in range(STEPS):
        loss = bert_pretrain_loss_fn(model(*batch), torch.from_numpy(labels))
        loss.backward()
        grads = grads or _grads_in_jax_layout(model)
        topt.step()
        topt.zero_grad(set_to_none=True)
        losses.append(loss.item())
    got_params = to_jax_state_dict(model)

    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    no_grad = set(want_grads) - set(grads)
    assert no_grad == {"pooler.weight", "pooler.bias", "nsp.weight",
                       "nsp.bias"}
    for k in no_grad:
        assert not np.any(want_grads[k])
        np.testing.assert_allclose(want_params[k],
                                   init[k] * (1 - LR * WD) ** STEPS,
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(got_params[k], want_params[k],
                                   atol=STEP_ATOL, rtol=0, err_msg=k)
    for k in grads:
        np.testing.assert_allclose(grads[k], want_grads[k], atol=STEP_ATOL,
                                   rtol=0, err_msg=f"grad {k}")
        g = np.abs(want_grads[k])
        noise = g < NOISE * g.max()
        np.testing.assert_allclose(got_params[k][~noise],
                                   want_params[k][~noise], atol=STEP_ATOL,
                                   rtol=0, err_msg=f"param {k}")
        assert np.all(np.abs(got_params[k] - want_params[k])[noise]
                      <= 2 * STEPS * LR), k


def test_dropout_trains_and_eval_is_deterministic(jax_model):
    """dropout 0.1: losses finite and falling over a few steps on one
    batch; eval is deterministic and equals a dropout-0 model with the
    same weights; train mode differs from eval."""
    _, params, _ = jax_model
    ids, types, mask, labels = _batch(2)
    batch = [torch.from_numpy(a) for a in (ids, types, mask)]
    model = _port(params, dropout=0.1)
    model.seed_dropout(7)
    plain = _port(params)
    model.eval()
    with torch.no_grad():
        a, b, c = model(*batch)[0], model(*batch)[0], plain(*batch)[0]
        model.train()
        d = model(*batch)[0]
    assert torch.equal(a, b)
    torch.testing.assert_close(a, c, atol=0, rtol=0)
    assert (d - a).abs().max() > 1e-3
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
    losses = []
    for _ in range(6):
        loss = bert_pretrain_loss_fn(model(*batch), torch.from_numpy(labels))
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(loss.item())
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < losses[0], losses
    # reseeding repeats the draw
    model.seed_dropout(7)
    with torch.no_grad():
        e = model(*batch)[0]
        model.seed_dropout(7)
        assert torch.equal(e, model(*batch)[0])


def test_qkv_column_order_is_three_heads_head_dim():
    """BERT's fused QKV columns are [3, heads, head_dim] (the JAX model's
    reshape to [b, s, 3, heads, head_dim]): q of every head, then k, then
    v. GPT's are grouped per head ([heads, 3, head_dim])."""
    nh, hd = 4, 16
    qkv = torch.arange(2 * 3 * 3 * nh * hd, dtype=torch.float32).view(
        2, 3, 3 * nh * hd)
    q, k, v = split_qkv(qkv, 2, 3, nh, hd)
    for which, t in enumerate((q, k, v)):
        assert t.shape == (2, 3, nh, hd)
        assert t.stride(-1) == 1
        for h in range(nh):
            lo = which * nh * hd + h * hd
            assert torch.equal(t[:, :, h], qkv[..., lo:lo + hd])
    gq, _, _ = _split_fused_qkv(qkv, 2, 3, nh, hd)
    assert not torch.equal(gq, q)


def test_weights_round_trip(jax_model):
    """`from_jax_state_dict` and `to_jax_state_dict` carry every Bert
    parameter both ways: the tied word embedding [vocab, hidden] once,
    Linear weights transposed between [in, out] and [out, in]."""
    _, params, _ = jax_model
    arrays = {k: np.asarray(v) for k, v in params.items()}
    model = _port(params)
    assert set(arrays) == {n for n, _ in model.named_parameters()}
    assert model.layers[0].attn.qkv.weight.shape == (192, 64)
    assert arrays["layers.0.attn.qkv.weight"].shape == (64, 192)
    back = to_jax_state_dict(model)
    assert set(back) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    assert back["word_emb.weight"].shape == (512, 64)


def test_unported_and_shapes():
    """Remat, once refused here, is ported: with the padding mask the
    remat model's training loss and gradients equal the plain model's
    (`test_torch_remat.py` holds the rest). Then ernie_base's shapes."""
    ids, types, mask, labels = map(torch.from_numpy, _batch(2))
    runs = []
    for cfg in (BertConfig(**CFG), BertConfig(**CFG, remat=True)):
        m = Bert(cfg, device="cpu", seed=1)
        m.train()
        m.seed_dropout(5)
        loss = bert_pretrain_loss_fn(m(ids, types, mask), labels)
        loss.backward()
        runs.append((loss.item(), [p.grad for p in m.parameters()]))
    assert runs[1][0] == runs[0][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        if a is None:
            assert b is None
        else:
            torch.testing.assert_close(b, a, rtol=0, atol=0)
    m = ernie_base(device="cpu", num_layers=1, hidden_size=64, num_heads=4,
                   intermediate_size=128)
    assert m.cfg.vocab_size == 40000 and m.cfg.dropout == 0.1
    assert m.cfg.max_position_embeddings == 512
    with torch.no_grad():
        lg, nsp = m(torch.zeros(1, 8, dtype=torch.long))
    assert lg.shape == (1, 8, 40000) and nsp.shape == (1, 2)
