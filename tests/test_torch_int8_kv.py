"""The port's int8 KV arena against the JAX package's, on the CPU.

- `_quantize_scatter` (the int8 append: per-block scale growth,
  requantization of a block's existing payload, the fresh-block reset)
  against the JAX function on the same arena, scales and step metadata;
- `paged_attention_ref` with scale sidecars against `paged_attention_xla`
  and the TPU kernel `_ragged_kernel` (``quant=True``) in Pallas interpret
  mode, on the ragged cases of tests/test_torch_paged_attention.py;
- `LLMEngine(kv_dtype="int8")` against the JAX int8 engine on the
  acceptance wave of tests/test_int8_kv.py (a warmed prefix, prompts
  longer than `prefill_chunk`, spec decoding, and a pool small enough to
  force preemption): greedy tokens identical, and at least `PARITY_RATE`
  of them equal to the float arena's;
- capacity at one `kv_hbm_bytes` budget, copy-on-write of the scales, and
  the scale invariants after churn.

The CUDA kernel's int8 variant runs only on the card:
tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.ops.pallas.paged_attention import (
    paged_attention_xla,
    ragged_paged_attention as jax_ragged_paged_attention,
)
from paddle_tpu.serving import LLMEngine as JaxLLMEngine
from paddle_tpu.serving import block_pool as jbp
from paddle_tpu.serving import kv_capacity_blocks as jax_kv_capacity_blocks
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import LLMEngine, kv_capacity_blocks
from paddle_tpu_torch.serving import block_pool as tbp
from paddle_tpu_torch.weights import from_jax_state_dict
from test_torch_paged_attention import KERNEL_TOL, RAGGED, REF_TOL, _case
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

VOCAB = 128
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=96)
WAVE = dict(block_size=8, max_batch=4, max_seq_len=96, prefill_chunk=8,
            spec_decoding=True, num_spec_tokens=3)
# the JAX package's own gate (tests/test_int8_kv.py): at least this share
# of greedy tokens served from the int8 arena equal the float arena's
PARITY_RATE = 0.9


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, attn_impl="xla", dropout=0.0))
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in state_dict_arrays(jm)[0].items()}
    tm = from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"), arrays)
    return jm, tm


# -- the int8 append ------------------------------------------------------------

def _touch_lists(slots, width, T):
    """The engine's per-row touched-block lists (slot 0 = null block)."""
    touched = np.zeros((len(slots), T), np.int32)
    touch_idx = np.zeros(slots.shape, np.int32)
    for i, row in enumerate(slots):
        sl = row[:width[i]]
        uniq = np.unique(sl[sl != 0])
        touched[i, 1:1 + len(uniq)] = uniq
        lut = {int(b): j + 1 for j, b in enumerate(uniq)}
        touch_idx[i, :width[i]] = [lut.get(int(s), 0) for s in sl]
    return touched, touch_idx


@pytest.mark.parametrize("layer", [0, 1])
def test_quantize_scatter_matches_jax(layer):
    """Row 0 starts two fresh blocks; row 1 appends small values to a
    partly filled block (its scale holds) and opens a fresh one; row 2
    appends large values to a partly filled block (its scale grows and its
    payload is requantized) and pads the rest of the step. Payload and
    scales must be equal outside the null block 0, which is scratch."""
    L, H, N, BS, D, S = 2, 3, 12, 4, 8, 6
    rs = np.random.RandomState(layer)
    arena = rs.randint(-127, 128, (L, H, N, BS, D)).astype(np.int8)
    scales = rs.uniform(0.01, 0.05, (L, H, N)).astype(np.float32)
    scales[:, :, 5] = 0.0                       # a never-written block
    pool = tbp.BlockPool(N, L, BS, H, D, device="cpu")
    rows = [([2, 5], 0, 6, 1.0), ([3, 7], 2, 4, 0.05), ([9], 1, 2, 40.0)]
    slots, offs = zip(*(pool.positions_to_slots(b, s, c, S)
                        for b, s, c, _ in rows))
    slots, offs = np.stack(slots), np.stack(offs)
    new = np.stack([rs.randn(S, H, D) * mag for *_, mag in rows])
    new = new.astype(np.float32)
    touched, touch_idx = _touch_lists(slots, [c for _, _, c, _ in rows],
                                      (S + BS - 2) // BS + 2)
    want_a, want_s = jbp._quantize_scatter(
        jnp.asarray(arena), jnp.asarray(scales), layer, jnp.asarray(new),
        jnp.asarray(slots), jnp.asarray(offs), jnp.asarray(touched),
        jnp.asarray(touch_idx))
    got_a, got_s = torch.from_numpy(arena.copy()), torch.from_numpy(
        scales.copy())
    tbp._quantize_scatter(got_a, got_s, layer, torch.from_numpy(new),
                          torch.from_numpy(slots), torch.from_numpy(offs),
                          torch.from_numpy(touched),
                          torch.from_numpy(touch_idx))
    want_a, want_s = np.asarray(want_a), np.asarray(want_s)
    np.testing.assert_array_equal(got_a.numpy()[:, :, 1:], want_a[:, :, 1:])
    np.testing.assert_array_equal(got_s.numpy()[:, :, 1:], want_s[:, :, 1:])
    # the case exercises what it claims: block 9's scale grew and its old
    # token (offset 0) was requantized, block 3's scale held, block 2's
    # stale scale was ignored (fresh: its tokens' absmax alone sets it)
    assert (want_s[layer, :, 9] > scales[layer, :, 9]).all()
    assert not np.array_equal(want_a[layer, :, 9, 0], arena[layer, :, 9, 0])
    assert (want_s[layer, :, 3] == scales[layer, :, 3]).all()
    np.testing.assert_allclose(want_s[layer, :, 2],
                               np.abs(new[0, :BS]).max(axis=(0, 2)) / 127,
                               rtol=1e-6)


def test_int8_append_dispatches_by_device(monkeypatch):
    """`block_pool.paged_attention` appends a CPU arena's K and V through
    the plain `_quantize_scatter` (the CUDA kernel's wrapper is not
    reached), and the kernel's wrapper refuses CPU tensors: no fallback."""
    from paddle_tpu_torch.ops.kv_quantize_scatter import kv_quantize_scatter

    L, H, N, BS, D, S = 2, 2, 8, 4, 8, 3
    pool = tbp.BlockPool(N, L, BS, H, D, device="cpu", kv_dtype="int8")
    slots, offs = (torch.from_numpy(a)[None] for a in
                   pool.positions_to_slots([3, 5], 2, S, S))
    touched, touch_idx = (torch.from_numpy(a) for a in _touch_lists(
        slots.numpy(), [S], (S + BS - 2) // BS + 2))
    z = torch.zeros((1,), dtype=torch.int32)
    state = tbp.PagedState(
        pool.k, pool.v, torch.tensor([[3, 5, 0, 0]], dtype=torch.int32),
        slots, offs, torch.arange(2, 2 + S, dtype=torch.int32)[None],
        q_start=z + 2, kv_live=z + 2, k_scale=pool.k_scale,
        v_scale=pool.v_scale, touched=touched, touch_idx=touch_idx)
    calls = []
    plain = tbp._quantize_scatter
    monkeypatch.setattr(tbp, "_quantize_scatter",
                        lambda *a: calls.append(a[0]) or plain(*a))
    launches = kv_quantize_scatter.launches
    q, k, v = (torch.randn(1, S, H, D) for _ in "qkv")
    out = tbp.paged_attention(q, k, v, state.layer(1))
    assert [a is b for a, b in zip(calls, (pool.k, pool.v))] == [True, True]
    assert kv_quantize_scatter.launches == launches
    assert out.shape == (1, S, H, D) and torch.isfinite(out).all()
    assert (pool.k_scale[1, :, [3, 5]] > 0).all()
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        kv_quantize_scatter(pool.k, pool.k_scale, 1, k, offs, touched,
                            touch_idx)


# -- attention over an int8 arena ------------------------------------------------

def _int8_case(lengths_counts, block_size, pad_to=None, seed=0):
    c = _case(lengths_counts, block_size=block_size, pad_to=pad_to,
              seed=seed)
    rs = np.random.RandomState(seed + 100)
    for n in ("k", "v"):
        c[n] = rs.randint(-127, 128, c[n].shape).astype(np.int8)
        c[n + "_scale"] = rs.uniform(0.002, 0.03,
                                     c[n].shape[:3]).astype(np.float32)
    return c


def _ref(c, q_dtype=torch.float32):
    t = {n: torch.from_numpy(c[n]) for n in
         ("k", "v", "k_scale", "v_scale", "tables", "qpos")}
    return pa.paged_attention_ref(
        torch.from_numpy(c["q"]).to(q_dtype), t["k"], t["v"], c["layer"],
        t["tables"], t["qpos"], k_scale=t["k_scale"], v_scale=t["v_scale"])


def _jax(c, name):
    return jnp.asarray(c[name])


@pytest.mark.parametrize("lengths_counts,block_size", RAGGED)
def test_int8_ref_matches_jax_gather_reference(lengths_counts, block_size):
    c = _int8_case(lengths_counts, block_size)
    want = np.asarray(paged_attention_xla(
        _jax(c, "q"), _jax(c, "k"), _jax(c, "v"), c["layer"],
        _jax(c, "tables"), _jax(c, "qpos"), k_scale=_jax(c, "k_scale"),
        v_scale=_jax(c, "v_scale")))
    np.testing.assert_allclose(_ref(c).numpy(), want, atol=REF_TOL, rtol=0)


@pytest.mark.parametrize("lengths_counts,block_size", RAGGED)
def test_int8_ref_matches_jax_interpret_kernel(lengths_counts, block_size):
    c = _int8_case(lengths_counts, block_size)
    out_k = np.asarray(jax_ragged_paged_attention(
        _jax(c, "q"), _jax(c, "k"), _jax(c, "v"), c["layer"],
        _jax(c, "tables"), _jax(c, "q_start"), _jax(c, "kv_live"),
        q_lens=_jax(c, "q_lens"), interpret=True,
        k_scale=_jax(c, "k_scale"), v_scale=_jax(c, "v_scale")))
    got = _ref(c).numpy()
    for i, (_, count) in enumerate(lengths_counts):
        err = np.abs(got[i, :count] - out_k[i, :count]).max()
        assert err < KERNEL_TOL, f"row {i} (count {count}): max err {err}"


def test_int8_ref_bf16_query_keeps_p_in_float32():
    """A bf16 query over an int8 arena: the products run in float32 on the
    dequantized K/V and P is not rounded to bf16 (JAX promotes the same
    way); only the output is rounded to q's dtype."""
    c = _int8_case([(18, 1), (5, 5), (13, 7)], 8)
    c["q"] = np.asarray(torch.from_numpy(c["q"]).bfloat16().float())
    want = np.asarray(paged_attention_xla(
        jnp.asarray(c["q"], jnp.bfloat16), _jax(c, "k"), _jax(c, "v"),
        c["layer"], _jax(c, "tables"), _jax(c, "qpos"),
        k_scale=_jax(c, "k_scale"), v_scale=_jax(c, "v_scale")))
    got = _ref(c, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    exact = _ref(c).numpy()                       # float32 output
    np.testing.assert_allclose(exact, want, atol=REF_TOL, rtol=0)
    # bf16 output: within half a bf16 ulp of the float32 result
    np.testing.assert_allclose(got.float().numpy(), exact,
                               rtol=2 ** -8, atol=1e-6)


def test_int8_dispatch_on_cpu_and_kernel_wrapper_refuses_cpu(monkeypatch):
    c = _int8_case([(18, 1), (5, 5), (13, 7)], 8)
    t = {n: torch.from_numpy(c[n]) for n in c if n != "layer"}
    before = (pa.ragged_paged_attention.launches,
              pa.ragged_paged_attention.int8_launches)
    with pytest.raises(ValueError, match="CUDA"):
        pa.ragged_paged_attention(t["q"], t["k"], t["v"], 1, t["tables"],
                                  t["q_start"], t["kv_live"],
                                  k_scale=t["k_scale"], v_scale=t["v_scale"])
    monkeypatch.setattr(pa, "ragged_paged_attention", None)
    got = pa.paged_attention_arrays(
        t["q"], t["k"], t["v"], 1, t["tables"], t["qpos"],
        q_start=t["q_start"], kv_live=t["kv_live"], q_lens=t["q_lens"],
        k_scale=t["k_scale"], v_scale=t["v_scale"])
    torch.testing.assert_close(got, _ref(c), atol=0, rtol=0)
    monkeypatch.undo()
    assert (pa.ragged_paged_attention.launches,
            pa.ragged_paged_attention.int8_launches) == before


# -- the engine ---------------------------------------------------------------

def _wave_prompts(seed=0):
    """tests/test_int8_kv.py's acceptance wave: two prompts sharing a
    cached prefix, one longer than the prefill chunk, drafter fodder."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, VOCAB, (24,)).tolist()
    motif = [7, 11, 13]
    return shared, [
        shared + rs.randint(0, VOCAB, (4,)).tolist(),
        shared + rs.randint(0, VOCAB, (6,)).tolist(),
        rs.randint(0, VOCAB, (40,)).tolist(),
        rs.randint(0, VOCAB, (5,)).tolist() + motif * 4,
    ]


def _serve_wave(eng):
    shared, prompts = _wave_prompts()
    eng.generate([shared], max_new_tokens=2, temperature=0.0)
    return eng.generate(prompts, max_new_tokens=10, temperature=0.0)


def _parity_rate(outs, ref):
    toks = [t for row in outs for t in row]
    want = [t for row in ref for t in row]
    assert len(toks) == len(want)
    return float(np.mean([a == b for a, b in zip(toks, want)]))


def _assert_idle(eng):
    assert eng.pool.num_free == eng.pool.num_blocks - 1
    assert eng.pool._refcount == {}
    assert not eng.has_unfinished()


# num_blocks None: the default pool; 12: too few blocks for the wave, so
# the scheduler preempts and replays (fresh blocks restart their scales)
@pytest.mark.parametrize("num_blocks", [None, 12])
def test_int8_wave_matches_jax_int8_engine(models, num_blocks):
    jm, tm = models
    want = _serve_wave(JaxLLMEngine(jm, mesh=1, kv_dtype="int8",
                                    num_blocks=num_blocks, **WAVE))
    eng = LLMEngine(tm, device="cpu", kv_dtype="int8", num_blocks=num_blocks,
                    **WAVE)
    got = _serve_wave(eng)
    assert got == want
    f32 = _serve_wave(LLMEngine(tm, device="cpu", num_blocks=num_blocks,
                                **WAVE))
    assert _parity_rate(got, f32) >= PARITY_RATE, (got, f32)
    c = eng.metrics.counters
    assert c["prefix_cache_hit_tokens"] > 0
    assert c["spec_proposed_tokens"] > 0
    assert c["mixed_steps"] > 0
    if num_blocks is not None:
        assert c["preemptions"] >= 1
    assert c["host_syncs"] == eng.step_count
    _assert_idle(eng)
    assert eng.pool.kv_dtype == "int8"
    assert eng.pool_stats()["kv_dtype"] == "int8"
    assert eng.metrics.infos["kv"] == {"dtype": "int8"}
    assert (eng.metrics.gauges["kv_bytes_per_block"]
            == eng.pool.bytes_per_block())


def test_int8_capacity_at_one_budget(models):
    jm, tm = models
    budget = 1 << 20
    kw = dict(block_size=8, max_batch=4, max_seq_len=96, kv_hbm_bytes=budget)
    eng_q = LLMEngine(tm, device="cpu", kv_dtype="int8", **kw)
    eng_f = LLMEngine(tm, device="cpu", **kw)
    jeng_q = JaxLLMEngine(jm, mesh=1, kv_dtype="int8", **kw)
    assert eng_q.pool.num_blocks == jeng_q.pool.num_blocks
    assert eng_q.pool.num_blocks >= 2 * eng_f.pool.num_blocks
    assert eng_q.pool.bytes_per_block() == jeng_q.pool.bytes_per_block()
    assert eng_q.pool_stats()["kv_bytes_per_block"] == \
        jeng_q.pool_stats()["kv_bytes_per_block"]
    assert eng_q.pool.k.dtype == torch.int8
    assert eng_q.pool.v.dtype == torch.int8
    for sc in (eng_q.pool.k_scale, eng_q.pool.v_scale):
        assert sc.shape == eng_q.pool.k.shape[:3]
        assert sc.dtype == torch.float32
        assert not sc.any()
    assert eng_f.pool.k_scale is None and not eng_f.pool.quantized


@pytest.mark.parametrize("args", [
    (1 << 20, 2, 2, 8, 16, 1, 4), (1 << 20, 2, 2, 8, 16, 4, 0),
    (12 * 3145728, 24, 16, 16, 128, 1, 4),      # gpt_1p3b: 23 int8 blocks
    (12 * 3145728, 24, 16, 16, 128, 2, 0),      # and 12 bf16 blocks
])
def test_kv_capacity_blocks_matches_jax(args):
    *head, scale_itemsize = args
    got = kv_capacity_blocks(*head, scale_itemsize=scale_itemsize)
    assert got == jax_kv_capacity_blocks(*head,
                                         scale_itemsize=scale_itemsize)


def test_copy_on_write_carries_scales_like_jax_pool():
    L, H, N, BS, D = 2, 3, 10, 4, 8
    jp = jbp.BlockPool(N, L, BS, H, D, kv_dtype="int8")
    tp = tbp.BlockPool(N, L, BS, H, D, device="cpu", kv_dtype="int8")
    rs = np.random.RandomState(3)
    arrays = [rs.randint(-127, 128, (L, H, N, BS, D)).astype(np.int8)
              for _ in "kv"]
    arrays += [rs.uniform(0.01, 0.05, (L, H, N)).astype(np.float32)
               for _ in "kv"]
    jp.k, jp.v, jp.k_scale, jp.v_scale = map(jnp.asarray, arrays)
    for t, a in zip((tp.k, tp.v, tp.k_scale, tp.v_scale), arrays):
        t.copy_(torch.from_numpy(a))
    for src, dst in [([2], [5]), ([1, 3], [7, 8])]:
        jp.copy_blocks(src, dst)
        tp.copy_blocks(src, dst)
        for name in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(jp, name)))
    np.testing.assert_array_equal(tp.k_scale[:, :, 7].numpy(),
                                  arrays[2][:, :, 1])
    assert tp.bytes_per_block() == jp.bytes_per_block()


def test_churn_keeps_scales_valid(models):
    """Distinct prompts through a pool too small for them, three rounds:
    every scale stays finite and >= 0, every block the pool owns has
    positive K and V scales, and each round passes the parity gate."""
    _, tm = models
    kw = dict(block_size=8, max_batch=4, max_seq_len=96, prefill_chunk=8,
              num_blocks=18)
    eng = LLMEngine(tm, device="cpu", kv_dtype="int8", **kw)
    ref = LLMEngine(tm, device="cpu", **kw)
    rs = np.random.RandomState(11)
    for r in range(3):
        prompts = [rs.randint(0, VOCAB, (n,)).tolist() for n in (17, 25, 19)]
        got = eng.generate(prompts, max_new_tokens=4, temperature=0.0)
        want = ref.generate(prompts, max_new_tokens=4, temperature=0.0)
        assert _parity_rate(got, want) >= PARITY_RATE, (r, got, want)
        for sc in (eng.pool.k_scale, eng.pool.v_scale):
            assert torch.isfinite(sc).all() and (sc >= 0).all()
        owned = [b for b in range(1, eng.pool.num_blocks)
                 if eng.pool.refcount(b) > 0]
        for b in owned:
            assert (eng.pool.k_scale[:, :, b] > 0).all()
            assert (eng.pool.v_scale[:, :, b] > 0).all()
    _assert_idle(eng)


@pytest.mark.parametrize("kv_dtype", ["fp8", "int4", "float32"])
def test_unsupported_kv_dtype_raises(models, kv_dtype):
    _, tm = models
    with pytest.raises(ValueError, match="kv_dtype"):
        LLMEngine(tm, device="cpu", kv_dtype=kv_dtype)
    with pytest.raises(ValueError, match="kv_dtype"):
        tbp.BlockPool(4, 2, 8, 2, 16, device="cpu", kv_dtype=kv_dtype)
