"""The port's AdaRound (`paddle_tpu_torch.quantization.adaround`) and the
engine's ``quantize="int8"`` against the JAX package's, on the CPU.

- `learn_rounding` with no iterations (round-to-nearest through the
  relaxation's initial state) gives the JAX function's integer grid
  exactly; after 40 Adam iterations the two grids agree on at least 99 %
  of their entries (measured: 100 % on this layer). The two frameworks'
  float32 reductions (the MSE's mean, the regularizer's sum) differ in
  order, so a rounding decision that sits at one half after the updates
  may flip.
- The learned grid reconstructs a Linear's outputs better than
  round-to-nearest (the JAX package's `tests/test_adaround.py` case).
- ``LLMEngine(quantize="int8")`` passes the JAX package's quality gates
  (`tests/test_int8_kv.py`) at a tiny size: the held-out mean NLL within
  0.05 nats of the float model's, greedy parity at least 0.9 on a mixed
  wave, embeddings and norms untouched, the block Linears on the int8
  grid; and it refuses a sharded engine as the JAX engine does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.quantization.adaround import \
    learn_rounding as jax_learn_rounding
from paddle_tpu.serving import LLMEngine as JaxLLMEngine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.quantization.adaround import (adaround_linear,
                                                    learn_rounding)
from paddle_tpu_torch.serving import LLMEngine
from paddle_tpu_torch.weights import from_jax_state_dict

VOCAB = 128
PARITY_RATE = 0.9     # tests/test_int8_kv.py's gates
NLL_DELTA = 0.05
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=96)


def _layer(seed=0):
    """A Linear's float32 weight [in, out], bias, calibration batches and
    its outputs on them, as numpy."""
    rs = np.random.RandomState(seed)
    w = rs.normal(0.0, 0.2, (32, 16)).astype(np.float32)
    b = rs.normal(0.0, 0.1, (16,)).astype(np.float32)
    xs = [rs.rand(64, 32).astype(np.float32) for _ in range(4)]
    scales = np.maximum(np.abs(w).max(axis=0), 1e-8)[None, :] / 127.0
    return w, b, xs, scales, [x @ w + b for x in xs]


def _grids(iters):
    w, b, xs, scales, ys = _layer()
    bt = torch.from_numpy(b)
    mine = learn_rounding(w, scales, lambda wq, x: x.float() @ wq + bt, xs,
                          ys, 127.0, iters=iters)
    bj = jnp.asarray(b)
    theirs = jax_learn_rounding(w, scales, lambda wq, x: x @ wq + bj, xs,
                                ys, 127.0, iters=iters)
    return mine.numpy(), np.asarray(theirs)


def test_learn_rounding_without_iterations_equals_jax():
    mine, theirs = _grids(0)
    np.testing.assert_array_equal(mine, theirs)


def test_learn_rounding_agrees_with_jax_after_adam():
    mine, theirs = _grids(40)
    rate = float(np.mean(mine == theirs))
    assert rate >= 0.99, rate
    assert np.abs(mine - theirs).max() <= 1.0


def test_adaround_beats_nearest_on_linear():
    torch.manual_seed(0)
    lin = torch.nn.Linear(32, 16)
    rs = np.random.RandomState(0)
    xs = [rs.rand(64, 32).astype(np.float32) for _ in range(4)]
    w = lin.weight.detach().numpy().T                     # [in, out]
    b = lin.bias.detach().numpy()
    w_qmax = 127.0
    q_learned, full_scales = adaround_linear(lin, xs, w_qmax, iters=250)
    q_learned, full_scales = q_learned.numpy(), full_scales.numpy()
    scales = np.maximum(np.abs(w).max(axis=0), 1e-8)
    np.testing.assert_allclose(full_scales, scales, rtol=1e-6)
    q_nearest = np.clip(np.round(w / scales[None] * w_qmax), -w_qmax, w_qmax)
    # the learned grid stays on the integer lattice, within 1 of nearest
    assert np.all(np.abs(q_learned - np.round(q_learned)) < 1e-5)
    assert np.abs(q_learned - q_nearest).max() <= 1.0 + 1e-5

    def out_err(q):
        wq = q * scales[None] / w_qmax
        return float(np.mean([np.mean((x @ wq + b - (x @ w + b)) ** 2)
                              for x in xs]))

    assert out_err(q_learned) < out_err(q_nearest)


# -- the engine's int8 weights ------------------------------------------------


@pytest.fixture(scope="module")
def arrays():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, attn_impl="xla", dropout=0.0))
    jm.eval()
    return jm, {k: np.asarray(v)
                for k, v in state_dict_arrays(jm)[0].items()}


def _model(arrays):
    return from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"),
                               arrays[1])


def _serve_wave(model, **kw):
    """The JAX gate's mixed wave: warm a shared prefix, then serve prompts
    sharing it, one longer than the prefill chunk and one the drafter
    matches, with spec decoding on. Returns (engine, outputs)."""
    rs = np.random.RandomState(0)
    shared = rs.randint(0, VOCAB, (24,)).tolist()
    motif = [7, 11, 13]
    prompts = [shared + rs.randint(0, VOCAB, (4,)).tolist(),
               shared + rs.randint(0, VOCAB, (6,)).tolist(),
               rs.randint(0, VOCAB, (40,)).tolist(),
               rs.randint(0, VOCAB, (5,)).tolist() + motif * 4]
    eng = LLMEngine(model, device="cpu", block_size=8, max_batch=4,
                    max_seq_len=96, prefill_chunk=8, spec_decoding=True,
                    num_spec_tokens=3, **kw)
    eng.generate([shared], max_new_tokens=2)
    return eng, eng.generate(prompts, max_new_tokens=10)


def _mean_nll(model, seqs):
    tot, n = 0.0, 0
    with torch.no_grad():
        for seq in seqs:
            logits = model(torch.tensor([seq]))[0].float()     # [s, vocab]
            lse = torch.logsumexp(logits[:-1], dim=-1)
            ll = logits[torch.arange(len(seq) - 1), seq[1:]] - lse
            tot += float(-ll.sum())
            n += len(seq) - 1
    return tot / n


def test_adaround_engine_passes_the_nll_and_parity_gates(arrays):
    rs = np.random.RandomState(3)
    calib = [rs.randint(0, VOCAB, (24,)).tolist() for _ in range(4)]
    held = [rs.randint(0, VOCAB, (32,)).tolist() for _ in range(4)]
    base = _model(arrays)
    q = _model(arrays)
    wte_before = q.wte.weight.detach().clone()
    ln_before = q.blocks[0].ln1.weight.detach().clone()
    _, ref = _serve_wave(base)
    eng, outs = _serve_wave(q, quantize="int8", calib_prompts=calib,
                            quantize_iters=40)
    assert eng.quantize == "int8"
    delta = _mean_nll(q, held) - _mean_nll(base, held)
    assert delta <= NLL_DELTA, delta
    toks = [(a, b) for ro, rr in zip(outs, ref) for a, b in zip(ro, rr)]
    assert np.mean([a == b for a, b in toks]) >= PARITY_RATE, (outs, ref)
    assert torch.equal(q.wte.weight, wte_before)
    assert torch.equal(q.blocks[0].ln1.weight, ln_before)
    for blk in q.blocks:
        for lin in (blk.attn.qkv, blk.attn.proj, blk.fc1, blk.fc2):
            w = lin.weight.detach().t().numpy()               # [in, out]
            scales = np.abs(w).max(axis=0, keepdims=True) / 127.0
            grid = w / np.maximum(scales, 1e-12)
            assert np.allclose(grid, np.round(grid), atol=1e-3)


def test_adaround_rejects_a_sharded_engine(arrays):
    for make, model in ((LLMEngine, _model(arrays)),
                        (JaxLLMEngine, arrays[0])):
        kw = {"device": "cpu"} if make is LLMEngine else {}
        with pytest.raises(ValueError, match="quantize first"):
            make(model, block_size=8, max_batch=2, max_seq_len=96, mesh=2,
                 quantize="int8", **kw)
