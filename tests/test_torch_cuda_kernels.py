"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA GPU and nvcc (the kernels have no CPU mode), so they
carry the `cuda` marker and skip elsewhere. This file imports neither JAX
nor the JAX package, so it runs where only PyTorch is installed (skip
tests/conftest.py, which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import re

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops.kv_quantize_scatter import kv_quantize_scatter
from paddle_tpu_torch.serving import BlockPool, LLMEngine
from paddle_tpu_torch.serving import block_pool as bp
from paddle_tpu_torch.serving import engine as eng_mod

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-3, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(lengths_counts, block_size, head_dim, dtype, dev, pad_to=None,
          heads=4, layers=2, seed=0, int8=False):
    """Ragged batch over a random arena (garbage in every slot, so the
    result must come from masking); returns tensors on `dev`. `int8`: the
    arena is int8 with float32 scale sidecars (k_scale, v_scale)."""
    g = torch.Generator().manual_seed(seed)
    B = len(lengths_counts)
    per = [max(1, -(-t // block_size)) for t, _ in lengths_counts]
    n_blocks = 1 + sum(per)
    tables = torch.zeros((B, max(per) + 1), dtype=torch.int32)
    order = torch.randperm(n_blocks - 1, generator=g) + 1
    o = 0
    for i, n in enumerate(per):
        tables[i, :n] = order[o:o + n]
        o += n
    S = pad_to or max(c for _, c in lengths_counts)
    qpos = torch.zeros((B, S), dtype=torch.int32)
    meta = torch.zeros((3, B), dtype=torch.int32)
    for i, (total, count) in enumerate(lengths_counts):
        qpos[i, :count] = torch.arange(total - count, total)
        meta[:, i] = torch.tensor([total - count, (total - 1) // block_size
                                   + 1, count])
    shape = (layers, heads, n_blocks, block_size, head_dim)
    c = {}
    if int8:
        k, v = (torch.randint(-127, 128, shape, generator=g,
                              dtype=torch.int8).to(dev) for _ in "kv")
        c["k_scale"], c["v_scale"] = (
            (torch.rand(shape[:3], generator=g) * 0.03 + 0.002).to(dev)
            for _ in "kv")
    else:
        k, v = (torch.randn(shape, generator=g).to(dev, dtype) for _ in "kv")
    q = torch.randn((B, S, heads, head_dim), generator=g).to(dev, dtype)
    return dict(q=q, k=k, v=v, tables=tables.to(dev), qpos=qpos.to(dev),
                q_start=meta[0].to(dev), kv_live=meta[1].to(dev),
                q_lens=meta[2].to(dev), **c)


SHAPES = [
    ([(18, 1), (5, 5), (13, 7)], 8, None),        # decode, prefill, crossing
    ([(31, 15), (32, 1), (3, 3), (20, 4)], 4, 16),
    ([(700, 1), (300, 1), (16, 16)], 16, 16),     # long contexts
    ([(9, 1)], 8, 8),                             # partial block, wide launch
    ([(67, 5), (1000, 5), (129, 1)], 16, 8),      # verify rows across chunks
    ([(200, 40), (64, 64), (65, 1)], 16, 64),     # prefill tiles over chunks
    ([(300, 3), (257, 1), (40, 12)], 32, 16),     # two blocks per chunk
    ([(300, 3), (257, 1), (40, 12)], 128, 16),    # one block per chunk
    ([(50, 2), (7, 7)], 1, 8),                    # 64 one-token blocks
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("lengths_counts,block_size,pad_to", SHAPES)
def test_kernel_matches_plain_version(dev, dtype, head_dim, lengths_counts,
                                      block_size, pad_to):
    c = _case(lengths_counts, block_size, head_dim, dtype, dev, pad_to)
    before = pa.ragged_paged_attention.launches
    got = pa.paged_attention_arrays(
        c["q"], c["k"], c["v"], 1, c["tables"], c["qpos"],
        q_start=c["q_start"], kv_live=c["kv_live"], q_lens=c["q_lens"])
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    want = pa.paged_attention_ref(c["q"], c["k"], c["v"], 1, c["tables"],
                                  c["qpos"])
    for i, (_, count) in enumerate(lengths_counts):
        err = (got[i, :count].float() - want[i, :count].float()).abs().max()
        assert err.item() < TOL[dtype], f"row {i}: max err {err.item()}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("lengths_counts,block_size,pad_to", SHAPES)
def test_int8_kernel_matches_plain_version(dev, dtype, head_dim,
                                           lengths_counts, block_size,
                                           pad_to):
    """The int8-arena variant: q (and the output) float32 or bfloat16, the
    arena int8 with one float32 scale per (layer, head, block)."""
    c = _case(lengths_counts, block_size, head_dim, dtype, dev, pad_to,
              int8=True)
    sc = dict(k_scale=c["k_scale"], v_scale=c["v_scale"])
    before = (pa.ragged_paged_attention.launches,
              pa.ragged_paged_attention.int8_launches)
    got = pa.paged_attention_arrays(
        c["q"], c["k"], c["v"], 1, c["tables"], c["qpos"],
        q_start=c["q_start"], kv_live=c["kv_live"], q_lens=c["q_lens"], **sc)
    torch.cuda.synchronize()
    assert (pa.ragged_paged_attention.launches,
            pa.ragged_paged_attention.int8_launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert got.dtype == dtype
    want = pa.paged_attention_ref(c["q"], c["k"], c["v"], 1, c["tables"],
                                  c["qpos"], **sc)
    for i, (_, count) in enumerate(lengths_counts):
        err = (got[i, :count].float() - want[i, :count].float()).abs().max()
        assert err.item() < TOL[dtype], f"row {i}: max err {err.item()}"


# bf16, head_dim 128 (the serving shape): the sm_90a design, both regimes
SM90_SHAPES = [
    # a 128-wide chunk from position 40 (mid-block), decode rows beside it
    [(40 + 128, 128), (300, 1), (17, 1)],
    # q_len 8 (a split row), 9 and 16 (wide rows), a decode row
    [(100, 8), (100, 9), (64, 16), (33, 1)],
    # a context of 2000 keys: split rows over 8 splits, a wide row
    [(2000, 1), (2000, 5), (2000, 64)],
    # a chunk over two 64-query tiles, a whole block, a one-token row
    [(129, 129), (16, 16), (1, 1)],
]


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("block_size", [16, 64])
@pytest.mark.parametrize("lengths_counts", SM90_SHAPES)
def test_sm90_design_matches_plain_version(dev, lengths_counts, block_size,
                                           int8):
    assert pa.kernel_design(torch.bfloat16, 128, block_size) == "sm90"
    c = _case(lengths_counts, block_size, 128, torch.bfloat16, dev,
              int8=int8)
    sc = dict(k_scale=c["k_scale"], v_scale=c["v_scale"]) if int8 else {}
    before = pa.ragged_paged_attention.launches
    got = pa.paged_attention_arrays(
        c["q"], c["k"], c["v"], 1, c["tables"], c["qpos"],
        q_start=c["q_start"], kv_live=c["kv_live"], q_lens=c["q_lens"], **sc)
    torch.cuda.synchronize()
    assert pa.ragged_paged_attention.launches == before + 1
    want = pa.paged_attention_ref(c["q"], c["k"], c["v"], 1, c["tables"],
                                  c["qpos"], **sc)
    for i, (_, count) in enumerate(lengths_counts):
        err = (got[i, :count].float() - want[i, :count].float()).abs().max()
        assert err.item() < TOL[torch.bfloat16], \
            f"row {i}: max err {err.item()}"


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_sm90_split_rows_are_deterministic(dev, int8):
    """Split rows of many splits (2000-2048 keys: 8 splits of 256) and a
    wide row: two runs give bit-identical outputs (partials merge in a
    fixed order, no atomics)."""
    c = _case([(2000, 1), (1500, 3), (2048, 8), (700, 40)], 16, 128,
              torch.bfloat16, dev, int8=int8, seed=3)
    sc = dict(k_scale=c["k_scale"], v_scale=c["v_scale"]) if int8 else {}
    runs = [pa.ragged_paged_attention(
        c["q"], c["k"], c["v"], 1, c["tables"], c["q_start"], c["kv_live"],
        q_lens=c["q_lens"], **sc) for _ in range(2)]
    torch.cuda.synchronize()
    for i, n in enumerate((1, 3, 8, 40)):
        assert torch.equal(runs[0][i, :n], runs[1][i, :n])


def test_kernel_custom_scale_and_strided_q(dev):
    c = _case([(40, 6), (17, 1)], 16, 64, torch.float32, dev)
    # q as a strided view, the way the fused QKV split hands it over
    wide = torch.randn((2, 6, 4, 3, 64), device=dev)
    q = wide[:, :, :, 0]
    assert not q.is_contiguous()
    got = pa.ragged_paged_attention(q, c["k"], c["v"], 0, c["tables"],
                                    c["q_start"], c["kv_live"],
                                    q_lens=c["q_lens"], scale=0.05)
    want = pa.paged_attention_ref(q, c["k"], c["v"], 0, c["tables"],
                                  c["qpos"], scale=0.05)
    for i, n in enumerate((6, 1)):
        torch.testing.assert_close(got[i, :n], want[i, :n], atol=1e-3,
                                   rtol=0)


def test_kernel_rejects_what_it_cannot_take(dev):
    c = _case([(9, 1)], 8, 48, torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim"):
        pa.ragged_paged_attention(c["q"], c["k"], c["v"], 0, c["tables"],
                                  c["q_start"], c["kv_live"])
    c = _case([(9, 1)], 8, 32, torch.float16, dev)
    with pytest.raises(ValueError, match="dtype"):
        pa.ragged_paged_attention(c["q"], c["k"], c["v"], 0, c["tables"],
                                  c["q_start"], c["kv_live"])


def test_int8_kernel_rejects_what_it_cannot_take(dev):
    c = _case([(9, 1)], 8, 32, torch.bfloat16, dev, int8=True)
    args = (c["q"], c["k"], c["v"], 0, c["tables"], c["q_start"],
            c["kv_live"])
    before = pa.ragged_paged_attention.launches
    with pytest.raises(ValueError, match="needs k_scale and v_scale"):
        pa.ragged_paged_attention(*args)                 # no sidecars
    with pytest.raises(ValueError, match="v_scale"):
        pa.ragged_paged_attention(*args, k_scale=c["k_scale"])
    for bad in (c["v_scale"].double(), c["v_scale"][:, :, :-1],
                c["v_scale"].cpu(), c["v_scale"].transpose(0, 1)):
        with pytest.raises(ValueError, match="v_scale"):
            pa.ragged_paged_attention(*args, k_scale=c["k_scale"],
                                      v_scale=bad)
    f = _case([(9, 1)], 8, 32, torch.bfloat16, dev)      # float arena
    with pytest.raises(ValueError, match="int8"):
        pa.ragged_paged_attention(f["q"], f["k"], f["v"], 0, f["tables"],
                                  f["q_start"], f["kv_live"],
                                  k_scale=c["k_scale"], v_scale=c["v_scale"])
    assert pa.ragged_paged_attention.launches == before


def test_engine_greedy_matches_generate_on_the_card(dev):
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, max_seq_len=128)
    model = GPT(cfg, device=dev, seed=0)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 512, n).tolist() for n in (5, 20, 33, 70)]
    eng = LLMEngine(model, device=dev, block_size=16, max_batch=2,
                    prefill_chunk=16, spec_decoding=True)
    before = pa.ragged_paged_attention.launches
    got = eng.generate(prompts, max_new_tokens=12, temperature=0.0)
    assert (pa.ragged_paged_attention.launches - before
            == cfg.num_layers * eng.step_count)
    assert eng.metrics.counters["host_syncs"] == eng.step_count
    for p, g in zip(prompts, got):
        ref = model.generate([p], max_new_tokens=12, temperature=0.0)
        assert g == ref[0, len(p):].tolist()


def test_int8_engine_on_the_card_matches_the_cpu(dev):
    """LLMEngine(kv_dtype="int8") in float32 on the card (the int8 kernel;
    TF32 off) against the same engine on a CPU copy (the plain version):
    one kernel launch per layer and step, one host sync per step, and at
    least 90 % of the greedy tokens equal (the JAX package's int8 gate)."""
    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=4, max_seq_len=128)
    models = [GPT(cfg, device=d, seed=0) for d in (dev, "cpu")]
    models[1].load_state_dict({k: t.cpu() for k, t in
                               models[0].state_dict().items()})
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 512, n).tolist() for n in (5, 20, 33, 70)]
    outs = []
    for m in models:
        eng = LLMEngine(m, device=m.device, kv_dtype="int8", block_size=16,
                        max_batch=2, prefill_chunk=16, spec_decoding=True)
        before = pa.ragged_paged_attention.int8_launches
        outs.append(eng.generate(prompts, max_new_tokens=12,
                                 temperature=0.0))
        launched = pa.ragged_paged_attention.int8_launches - before
        assert launched == (cfg.num_layers * eng.step_count
                            if m.device.type == "cuda" else 0)
        assert eng.metrics.counters["host_syncs"] == eng.step_count
        assert eng.pool.num_free == eng.pool.num_blocks - 1
    toks = [(a, b) for ga, gb in zip(*outs) for a, b in zip(ga, gb)]
    assert np.mean([a == b for a, b in toks]) >= 0.9, outs


# -- the int8 append and the compiled serve step ----------------------------

def _append_case(width, dtype, seed=0):
    """One serve step's int8 append at step width `width`: B 8 rows over
    an arena of random payload and scales (H 4, D 128, block 16) — a
    fresh row from position 0, rows appending small values (scale holds)
    and large ones (scale grows, payload requantized) to a partly filled
    block, a prefix row starting at a block boundary after a shared block,
    short rows padded to the width, and an idle lane (every token to the
    null block). K comes as a strided view of a fused projection, as in
    the model."""
    L, H, D, bs, B = 2, 4, 128, 16, 8
    rs = np.random.RandomState(seed + width)
    starts = [0, 5, 7, 16, 3, 0, int(rs.randint(0, 40)), 31]
    counts = [width, width, width, width, max(1, width // 2), 0,
              max(1, width - 1), width]
    mags = [1.0, 0.01, 40.0, 2.0, 1.0, 1.0, 0.5, 8.0]
    per = [-(-(st + max(c, 1)) // bs) for st, c in zip(starts, counts)]
    N = 1 + sum(per) + 4
    perm = rs.permutation(np.arange(1, N))
    pool = BlockPool(N, L, bs, H, D, device="cpu", kv_dtype="int8")
    slots, offs, o = [], [], 0
    for st, c, n in zip(starts, counts, per):
        sl, of = pool.positions_to_slots(perm[o:o + n].tolist(), st, c, width)
        slots.append(sl)
        offs.append(of)
        o += n
    slots, offs = np.stack(slots), np.stack(offs)
    T = (width + bs - 2) // bs + 2
    touched = np.zeros((B, T), np.int32)
    touch_idx = np.zeros((B, width), np.int32)
    for i, (row, c) in enumerate(zip(slots, counts)):
        uniq = np.unique(row[:c][row[:c] != 0])
        touched[i, 1:1 + len(uniq)] = uniq
        lut = {int(b): j + 1 for j, b in enumerate(uniq)}
        touch_idx[i, :c] = [lut.get(int(x), 0) for x in row[:c]]
    fused = rs.randn(B, width, H, 3, D).astype(np.float32)
    fused *= np.asarray(mags, np.float32)[:, None, None, None, None]
    arena = rs.randint(-127, 128, (L, H, N, bs, D)).astype(np.int8)
    scales = rs.uniform(0.01, 0.05, (L, H, N)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return dict(arena=t(arena), scales=t(scales), new=t(fused).to(dtype),
                slots=t(slots), offs=t(offs), touched=t(touched),
                touch_idx=t(touch_idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 5, 128])
def test_kv_quantize_scatter_matches_plain_version(dev, width, dtype):
    """The CUDA append is bit-equal to the plain `_quantize_scatter` (itself
    bit-equal to the JAX function) outside the null block, payload and
    scales, and leaves the other layer alone."""
    c = _append_case(width, dtype)
    layer = 1
    want_a, want_s = c["arena"].clone(), c["scales"].clone()
    k_new = c["new"][:, :, :, 1]
    bp._quantize_scatter(want_a, want_s, layer, k_new, c["slots"], c["offs"],
                         c["touched"], c["touch_idx"])
    got_a, got_s = c["arena"].to(dev), c["scales"].to(dev)
    new = c["new"].to(dev)[:, :, :, 1]
    before = kv_quantize_scatter.launches
    kv_quantize_scatter(got_a, got_s, layer, new, c["offs"].to(dev),
                        c["touched"].to(dev), c["touch_idx"].to(dev))
    torch.cuda.synchronize()
    assert kv_quantize_scatter.launches == before + 1
    assert torch.equal(got_a.cpu()[:, :, 1:], want_a[:, :, 1:])
    assert torch.equal(got_s.cpu()[:, :, 1:], want_s[:, :, 1:])
    # the case exercises what it claims: among the touched blocks some
    # scales grew and some held
    tb = c["touched"][c["touched"] != 0].long()
    old, new_sc = c["scales"][layer][:, tb], want_s[layer][:, tb]
    assert (new_sc > old).any() and (new_sc == old).any()


def test_kv_quantize_scatter_rejects_what_it_cannot_take(dev):
    c = _append_case(5, torch.float32)
    args = [c["arena"].to(dev), c["scales"].to(dev), 0,
            c["new"].to(dev)[:, :, :, 1], c["offs"].to(dev),
            c["touched"].to(dev), c["touch_idx"].to(dev)]
    bad = [(0, args[0].float()), (1, args[1].double()), (2, 5),
           (3, args[3].half()), (4, args[4].long()),
           (6, args[6][:, :2].contiguous())]
    for i, value in bad:
        with pytest.raises(ValueError):
            kv_quantize_scatter(*(args[:i] + [value] + args[i + 1:]))


def _tiny_bf16_engine(dev, **kw):
    """A bf16 engine at head_dim 128, block 16: the sm_90a ragged design."""
    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=256)
    model = GPT(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    return LLMEngine(model, device=dev, block_size=16, max_batch=4,
                     prefill_chunk=32, spec_decoding=True, **kw)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_graph_replay_matches_the_eager_body(dev, monkeypatch, kv_dtype):
    """Every step of a greedy wave replays its bucket's CUDA graph; the
    eager body on the same static inputs, run from the arena as it stood
    before the replay, gives the same packed result and leaves the same
    arena outside the null block (payload and, for int8, scales), and the
    kernels' counts through replays equal the launches."""
    engine = _tiny_bf16_engine(dev, kv_dtype=kv_dtype, warmup=True)
    assert engine.metrics.counters["jit_traces"] == 3
    pool = engine.pool
    state = [t for t in (pool.k, pool.v, pool.k_scale, pool.v_scale)
             if t is not None]
    pairs = []
    replay = eng_mod._StepProgram.__call__

    def checked(prog):
        before = [t.clone() for t in state]
        got = replay(prog).clone()
        after = [t.clone() for t in state]
        for t, b in zip(state, before):
            t.copy_(b)
        counts = eng_mod._launch_counts()     # the eager run's launches
        want = prog.body().clone()            # are not the replay's
        for (fn, name), v in counts.items():
            setattr(fn, name, v)
        pairs.append((got, want))
        for t, a in zip(state, after):       # the null block is scratch
            assert torch.equal(t[:, :, 1:], a[:, :, 1:])
        return got

    monkeypatch.setattr(eng_mod._StepProgram, "__call__", checked)
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 512, n).tolist() for n in (5, 40, 70, 12)]
    prompts.append([5, 6, 7] * 6)
    launches = pa.ragged_paged_attention.launches
    appends = kv_quantize_scatter.launches
    steps = engine.step_count
    replays = sum(p.replays for p in engine._step_fns.values())
    engine.generate(prompts, max_new_tokens=10)
    steps = engine.step_count - steps
    assert len(pairs) == steps
    for got, want in pairs:
        assert torch.equal(got, want)
    assert pa.ragged_paged_attention.launches - launches == 2 * steps
    assert kv_quantize_scatter.launches - appends == (
        2 * 2 * steps if kv_dtype else 0)
    assert engine.metrics.counters["jit_traces"] == 3
    assert sum(p.replays for p in engine._step_fns.values()) \
        == replays + steps


def test_sampled_draws_differ_between_replays(dev):
    """The engine's generator is registered with each graph: replays of
    one step with a sampling row draw new numbers."""
    engine = _tiny_bf16_engine(dev)
    prog = engine._get_step_fn(engine.max_batch, 1)
    draws = set()
    for _ in range(8):
        a = prog.host_arrays()
        a["temps"][0] = 5.0
        draws.add(int(prog()[0, 0]))
    assert len(draws) > 1
    assert prog.replays == 8


def test_replayed_graph_reads_an_adapter_rewritten_in_place(dev):
    """`load_adapter` writes the tables in place, so graphs captured before
    a load serve it: the same request on one adapter name gives other
    tokens after a different adapter is loaded into the same slot, every
    step a replay, and the base lanes keep their tokens."""
    from paddle_tpu_torch.models import lora

    engine = _tiny_bf16_engine(dev, lora_slots=1, lora_rank=4, warmup=True)
    cfg = engine.model.cfg
    prompt = list(range(1, 40))
    base = engine.generate([prompt], max_new_tokens=12)
    outs = []
    for seed in (1, 2):
        slot = engine.load_adapter("a", lora.random_adapter(cfg, 4,
                                                            seed=seed),
                                   alpha=8)
        assert slot == 1
        outs.append(engine.generate([prompt], max_new_tokens=12,
                                    adapter="a"))
    assert outs[0] != outs[1]
    assert base != outs[0]
    assert engine.generate([prompt], max_new_tokens=12) == base
    assert engine.metrics.counters["jit_traces"] == 3     # no rebuild


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_tier_round_trip_is_bit_equal(dev, kv_dtype):
    """Blocks demoted to the host tier and copied back hold their bytes
    (and an int8 arena's scales) bit for bit, with no host sync beyond
    one a step, and the host-warm serve emits the cold serve's tokens."""
    engine = _tiny_bf16_engine(dev, kv_dtype=kv_dtype, num_blocks=24,
                               host_kv_blocks=32, warmup=True)
    rs = np.random.RandomState(0)
    doc = rs.randint(0, 512, 96).tolist()
    cold = engine.generate([doc + [1, 2]], max_new_tokens=8)
    pool, tier = engine.pool, engine.tier
    saved = {h: [a[:, :, b].clone() for a in tier._arenas()]
             for h, b in pool._hash_index.items()}
    for r in range(3):                      # churn the doc out of the pool
        engine.generate([rs.randint(0, 512, 150).tolist()],
                        max_new_tokens=4)
    tier.settle()
    assert tier.swap_outs > 0
    assert engine.generate([doc + [1, 2]], max_new_tokens=8) == cold
    assert tier.swap_ins > 0
    restored = [h for h in saved if h in pool._hash_index]
    assert restored
    for h in restored:
        for before, arena in zip(saved[h], tier._arenas()):
            assert torch.equal(arena[:, :, pool._hash_index[h]], before)
    c = engine.metrics.counters
    assert c["host_syncs"] == engine.step_count
    assert c["jit_traces"] == 3
    engine.close()


# -- flash attention -----------------------------------------------------------

def _flash_inputs(b, sq, sk, h, d, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn((b, sq, h, d), generator=g) for _ in "qo")
    k, v = (torch.randn((b, sk, h, d), generator=g) for _ in "kv")
    return [t.to(dev, dtype) for t in (q, k, v, do)]


def _flash_ref(q, k, v, do, causal):
    """The plain version in float32 on the same (possibly bf16) values:
    O, LSE and autograd's dQ, dK, dV."""
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
    o = fa.attention_ref(q32, k32, v32, causal)
    o.backward(do.float())
    lse = fa.attention_lse_ref(q32.detach(), k32.detach(), causal)
    return o.detach(), lse, q32.grad, k32.grad, v32.grad


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(1024, 1024), (77, 77), (200, 200),
                                   (77, 200), (1, 130), (64, 64), (127, 127),
                                   (128, 128), (129, 129)])
def test_flash_kernels_match_plain_version(dev, dtype, head_dim, causal, sq,
                                           sk):
    """Forward (O, LSE) and both backward kernels (dQ; dK, dV) against the
    plain version and its autograd gradients, sq <= sk (a query row always
    sees a key), ragged edges included (the bf16 kernels' 128-row tiles:
    64, 127, 128, 129; one consumer's rows all dead at 1 and 64)."""
    q, k, v, do = _flash_inputs(2, sq, sk, 3, head_dim, dtype, dev)
    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, do, lse, causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == f0 + 1
    assert fa.flash_attention_bwd.launches == b0 + 1
    want = _flash_ref(q, k, v, do, causal)
    for name, got, ref in zip(("o", "lse", "dq", "dk", "dv"),
                              (o, lse, dq, dk, dv), want):
        assert got.dtype == (torch.float32 if name == "lse" else dtype)
        assert got.shape == ref.shape, name
        err = _max_err(got, ref)
        assert err < TOL[dtype], f"{name}: max err {err}"


def _split_views(qkv, split, b, s, h, d):
    """q, k, v as strided views of one fused projection: [b, s, h, 3, d]
    ("heads"), the encoder's [3, heads, head_dim] columns ("split_qkv") or
    the decoder's per-head groups ("fused_gpt")."""
    from paddle_tpu_torch.models.bert import split_qkv
    from paddle_tpu_torch.models.gpt import _split_fused_qkv

    if split == "heads":
        x = qkv.view(b, s, h, 3, d)
        return x[:, :, :, 0], x[:, :, :, 1], x[:, :, :, 2]
    return (split_qkv if split == "split_qkv" else _split_fused_qkv)(
        qkv, b, s, h, d)


@pytest.mark.parametrize("dtype,head_dim,split", [
    (torch.float32, 64, "heads"),
    (torch.bfloat16, 64, "split_qkv"), (torch.bfloat16, 64, "fused_gpt"),
    (torch.bfloat16, 128, "split_qkv"), (torch.bfloat16, 128, "fused_gpt")])
def test_flash_autograd_through_strided_views(dev, dtype, head_dim, split):
    """The training path: q, k, v as strided views of one fused QKV
    projection (read in place: the bf16 kernels' tensor maps carry the
    views' strides), gradients through `flash_attention` against the plain
    version in float32 on the same values."""
    b, s, h = 2, 100, 4
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn((b, s, 3 * h * head_dim), generator=g).to(dev, dtype)
    do = torch.randn((b, s, h, head_dim), generator=g).to(dev, dtype)
    got_in = qkv.clone().requires_grad_()
    q, k, v = _split_views(got_in, split, b, s, h, head_dim)
    assert not q.is_contiguous()
    fa.flash_attention(q, k, v, causal=True).backward(do)
    ref_in = qkv.float().requires_grad_()
    fa.attention_ref(*_split_views(ref_in, split, b, s, h, head_dim),
                     causal=True).backward(do.float())
    assert _max_err(got_in.grad, ref_in.grad) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", [1, 2], ids=["dkv", "dq"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("variant", ["plain", "padding+dropout"])
def test_flash_backward_is_deterministic(dev, dtype, which, head_dim,
                                         variant):
    """The dK/dV kernel (`which` 1) and the dQ kernel (2) each sum a
    gradient in one fixed order (no atomics; the f32 kernels add their two
    halves' sums in one order too): two launches on the same inputs give
    bit-identical results."""
    b, sq, h = 2, 300, 3
    q, k, v, do = _flash_inputs(b, sq, sq, h, head_dim, dtype, dev, seed=6)
    mask, p, seed = None, 0.0, None
    if variant != "plain":
        mask, p, seed = _padding_mask(b, sq, dev), 0.1, 99
    o, lse = fa.flash_attention_fwd(q, k, v, True, mask, p, seed)
    delta = fa._delta(o, do)
    runs = [fa._launch_bwd(q, k, v, do, lse, delta, True, which, mask, p,
                           seed)
            for _ in range(2)]
    torch.cuda.synchronize()
    # (dq, dk, dv): which of them the launch computed
    computed = (False, True, True) if which == 1 else (True, False, False)
    for x, y, want in zip(runs[0], runs[1], computed):
        assert (x is not None, y is not None) == (want, want)
        if want:
            assert torch.equal(x, y)


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
def test_f32_backward_at_the_pipeline_stage_shape(dev, dropout_p):
    """The f32 dK/dV and dQ kernels (3xTF32) at a pipelined gpt_1p3b
    stage's attention (2 x 1024, heads 8-15 of 16, head_dim 128, causal):
    within 2e-5 of the plain f32 version (TF32 off), and heads 8-15 equal
    the same heads of one 16-head call bit for bit."""
    b, s, h, total, d = 2, 1024, 8, 16, 128
    q, k, v, do = _flash_inputs(b, s, s, total, d, torch.float32, dev,
                                seed=11)
    seed = 2024 if dropout_p > 0 else None
    var = (True, None, dropout_p, seed)
    mine = [t[:, :, h:].contiguous() for t in (q, k, v, do)]
    hk = dict(head_offset=h, heads_total=total)
    o32 = torch.empty(mine[0].shape, device=dev) if dropout_p else None
    o, lse = fa.flash_attention_fwd(*mine[:3], *var, o32, **hk)
    o_b = o if o32 is None else o32
    got = fa.flash_attention_bwd(*mine[:3], o_b, mine[3], lse, *var, **hk)
    o32_all = torch.empty(q.shape, device=dev) if dropout_p else None
    o_all, lse_all = fa.flash_attention_fwd(q, k, v, *var, o32_all)
    whole = fa.flash_attention_bwd(q, k, v, o_all if o32_all is None
                                   else o32_all, do, lse_all, *var)
    torch.cuda.synchronize()
    for x, y in zip(got, whole):
        assert torch.equal(x, y[:, :, h:])
    q32, k32, v32 = (t.clone().requires_grad_() for t in mine[:3])
    fa.attention_ref(q32, k32, v32, *var, **hk).backward(mine[3])
    for name, x, y in zip(("dq", "dk", "dv"), got,
                          (q32.grad, k32.grad, v32.grad)):
        err = _max_err(x, y)
        assert err < 2e-5, f"{name}: max err {err}"


F32_GATE = 2e-5  # the f32 kernels (3xTF32) against the plain f32 version


def _f32_forward_case(case, head_dim, dev):
    """(q, k, v, causal, mask, dropout_p, seed, heads) of a float32 forward
    card case: causal with Sq < Sk and with S off the 64-row tile, q/k/v
    as strided views of GPT's fused projection, a key-only [B, 1, 1, Sk]
    and a full [B, H, Sq, Sk] mask, and dropout on heads 3-5 of 8."""
    b, h, d = 2, 3, head_dim
    if case == "fused_qkv":
        g = torch.Generator().manual_seed(12)
        qkv = torch.randn((b, 200, 3 * h * d), generator=g).to(dev)
        return (*_split_views(qkv, "fused_gpt", b, 200, h, d), True, None,
                0.0, None, {})
    sq, sk = {"causal_sq_lt_sk": (77, 200), "causal_ragged": (200, 200)
              }.get(case, (130, 130))
    q, k, v, _ = _flash_inputs(b, sq, sk, h, d, torch.float32, dev, seed=13)
    if case == "key_mask":
        return q, k, v, False, _padding_mask(b, sk, dev), 0.0, None, {}
    if case == "full_mask":
        g = torch.Generator().manual_seed(14)
        return (q, k, v, True, torch.randn((b, h, sq, sk), generator=g).to(
            dev), 0.0, None, {})
    if case == "dropout_heads":
        return (q, k, v, False, _padding_mask(b, sk, dev), 0.1, 31,
                dict(head_offset=3, heads_total=8))
    return q, k, v, True, None, 0.0, None, {}


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("case", ["causal_sq_lt_sk", "causal_ragged",
                                  "fused_qkv", "key_mask", "full_mask",
                                  "dropout_heads"])
def test_flash_f32_forward_holds_the_f32_gate(dev, head_dim, case):
    """The f32 forward (`flash_fwd_f32`, 3xTF32): O and LSE within 2e-5 of
    the plain f32 version (TF32 off), with the f32 copy of O equal to O
    under dropout, and a second launch bit-identical to the first."""
    q, k, v, causal, mask, p, seed, hk = _f32_forward_case(case, head_dim,
                                                           dev)
    runs = []
    for _ in range(2):
        o32 = torch.empty(q.shape, device=dev) if p > 0 else None
        runs.append((*fa.flash_attention_fwd(q, k, v, causal, mask, p, seed,
                                             o32, **hk), o32))
    torch.cuda.synchronize()
    (o, lse, o32), (o_b, lse_b, _) = runs
    assert torch.equal(o, o_b) and torch.equal(lse, lse_b)
    if o32 is not None:
        assert torch.equal(o, o32)
    want = fa.attention_ref(q, k, v, causal, mask, p, seed, **hk)
    want_lse = fa.attention_lse_ref(q, k, causal, mask)
    for name, got, ref in (("o", o, want), ("lse", lse, want_lse)):
        err = _max_err(got, ref)
        assert err < F32_GATE, f"{name}: max err {err}"


def test_flash_f32_forward_does_not_spill(dev):
    """ptxas's report on the f32 forward at head_dim 64 and 128, without
    and with the mask / dropout code: no spill stores (its O accumulator,
    scores and P fragments live in registers)."""
    from paddle_tpu_torch.ops import _build

    _build.load_library("flash_attention.cu")
    lines = _build.build_log("flash_attention.cu").splitlines()
    for entry in (f"flash_fwd_f32ILi{d}ELb{v}EE" for d in (64, 128)
                  for v in (0, 1)):
        at = [i for i, line in enumerate(lines)
              if "Compiling entry function" in line and entry in line]
        assert at, f"no ptxas report for {entry}"
        spill = next(re.search(r"(\d+) bytes spill stores", line)
                     for line in lines[at[0] + 1:]
                     if "spill stores" in line)
        assert spill.group(1) == "0", spill.string


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("sq,sk", [(77, 200), (129, 129)])
def test_flash_dq_alone_matches_plain_version(dev, dtype, head_dim, sq, sk):
    """The dQ kernel launched alone (`which` 2) at a ragged causal shape:
    dQ matches the plain version's gradient, and dK, dV are not
    computed."""
    q, k, v, do = _flash_inputs(2, sq, sk, 3, head_dim, dtype, dev, seed=7)
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    dq, dk, dv = fa._launch_bwd(q, k, v, do, lse, fa._delta(o, do), True, 2)
    torch.cuda.synchronize()
    assert dk is None and dv is None
    want = _flash_ref(q, k, v, do, True)[2]
    assert dq.dtype == dtype and dq.shape == want.shape
    err = _max_err(dq, want)
    assert err < TOL[dtype], f"dq: max err {err}"


def test_flash_rejects_what_it_cannot_take(dev):
    q, k, v, _ = _flash_inputs(1, 16, 16, 2, 32, torch.float32, dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v, _ = _flash_inputs(1, 16, 16, 2, 64, torch.float16, dev)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v, _ = _flash_inputs(1, 16, 16, 2, 64, torch.float32, dev)
    with pytest.raises(ValueError, match="shape"):
        fa.flash_attention_fwd(q, k[:, :, :1], v)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(q, k, torch.randn(1, 16, 2, 65, device=dev)
                               [..., 1:])
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q.cpu(), k.cpu(), v.cpu())
    before = fa.flash_attention_fwd.launches
    with pytest.raises(ValueError, match="broadcast"):
        fa.flash_attention(q, k, v, mask=torch.zeros(1, 1, 16, 15,
                                                     device=dev))
    with pytest.raises(ValueError, match="mask must be on"):
        fa.flash_attention(q, k, v, mask=torch.zeros(1, 1, 16, 16))
    with pytest.raises(ValueError, match="seed"):
        fa.flash_attention(q, k, v, dropout_p=0.1)
    with pytest.raises(ValueError, match="dropout_p"):
        fa.flash_attention(q, k, v, dropout_p=1.0, seed=0)
    assert fa.flash_attention_fwd.launches == before


RING_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_steps_match_one_flash_call(dev, dtype, n):
    """The n ranks' ring steps (`rank_forward`, `rank_backward`) in one
    process at gpt_1p3b's attention shape (1 x 2048, 16 heads, D 128,
    causal): O, dQ, dK and dV within 2e-5 (f32) of one flash call over
    the whole sequence, in bf16 within 2e-2 plus one bf16 ulp of the one
    call's value (its own rounding); rank i launches the forward and the
    backward pair i + 1 times, and its steps make no host sync."""
    from paddle_tpu_torch.parallel.ring_attention import (rank_backward,
                                                          rank_forward)

    B, S, H, D = 1, 2048, 16, 128
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    want = (o,) + tuple(fa.flash_attention_bwd(q, k, v, o, do, lse, True))
    L = S // n
    cut = [lambda t, i=i: t[:, i * L:(i + 1) * L] for i in range(n)]
    blocks = [(cut[j](k), cut[j](v)) for j in range(n)]
    outs, dqs = [], []
    dks = [torch.zeros((B, L, H, D), device=dev) for _ in range(n)]
    dvs = [torch.zeros((B, L, H, D), device=dev) for _ in range(n)]
    for i in range(n):
        f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            oi, lsei = rank_forward(cut[i](q), blocks, i, True)
            dqi, parts = rank_backward(cut[i](q), blocks, oi, cut[i](do), lsei,
                                       i, True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert (fa.flash_attention_fwd.launches - f0,
                fa.flash_attention_bwd.launches - b0) == (i + 1, i + 1)
        assert sorted(parts) == list(range(i + 1))
        outs.append(oi)
        dqs.append(dqi)
        for j, (a, b) in parts.items():
            dks[j] += a.float()
            dvs[j] += b.float()
    for name, got, w in zip(("o", "dq", "dk", "dv"), (outs, dqs, dks, dvs),
                            want):
        err = (torch.cat(got, 1) - w.float()).abs()
        if dtype == torch.bfloat16:
            _, e = torch.frexp(w.float())
            err = err - torch.ldexp(torch.ones_like(err), e - 8)
        assert err.max().item() <= RING_TOL[dtype], (name, err.max().item())


def test_ring_on_the_card_never_takes_the_plain_path(dev, monkeypatch):
    """On CUDA tensors the ring's steps launch the kernels and never call
    the plain versions (made to raise here); a group of one is one flash
    call."""
    from paddle_tpu_torch.parallel import ring_attention as ra

    def refuse(*a, **k):
        raise AssertionError("the plain path ran on a CUDA tensor")

    for name in ("attention_ref", "attention_lse_ref", "attention_bwd_ref"):
        monkeypatch.setattr(ra, name, refuse)
    q, k, v, do = _flash_inputs(1, 256, 256, 2, 64, torch.float32, dev)
    o, lse = ra.rank_forward(q, [(k, v)], 0, True)
    ra.rank_backward(q, [(k, v)], o, do.contiguous(), lse, 0, True)
    f0 = fa.flash_attention_fwd.launches
    one = ra.ring_attention(q, k, v, None, causal=True)
    assert fa.flash_attention_fwd.launches == f0 + 1
    torch.testing.assert_close(one, fa.flash_attention_fwd(q, k, v, True)[0],
                               rtol=0, atol=0)


# -- keep bits at a query-row offset; gathered sequence attention -------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal,q_row0,sq,sk", [
    (True, 128, 128, 256), (False, 192, 64, 256)],
    ids=["causal_rank1of2", "padding_rank3of4"])
def test_flash_kernels_at_a_query_row_offset(dev, dtype, head_dim, causal,
                                             q_row0, sq, sk):
    """A sequence-parallel rank's launch: its `sq` queries from row
    `q_row0` of a sequence of `sk` keys, dropout 0.1 (with a padding mask
    when not causal). Forward (O, LSE) and both backward kernels (dQ; dK,
    dV) against the plain version at the same `q_row0`, within 2e-5 in
    float32 and 2e-2 in bfloat16; the keep bits move with the offset (O
    differs from the launch at row 0)."""
    b, h, p, seed = 2, 3, 0.1, 97
    q, k, v, do = _flash_inputs(b, sq, sk, h, head_dim, dtype, dev, seed=8)
    mask = None if causal else _padding_mask(b, sk, dev)
    o32 = torch.empty(q.shape, device=dev)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, mask, p, seed, o32,
                                    q_row0=q_row0)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o32, do, lse, causal, mask,
                                        p, seed, q_row0=q_row0)
    at0, _ = fa.flash_attention_fwd(q, k, v, causal, mask, p, seed)
    torch.cuda.synchronize()
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
    ref = fa.attention_ref(q32, k32, v32, causal, mask, p, seed,
                           q_row0=q_row0)
    ref.backward(do.float())
    want = (ref.detach(), fa.attention_lse_ref(q32.detach(), k32.detach(),
                                               causal, mask),
            q32.grad, k32.grad, v32.grad)
    gate = F32_GATE if dtype == torch.float32 else TOL[dtype]
    for name, got, w in zip(("o", "lse", "dq", "dk", "dv"),
                            (o, lse, dq, dk, dv), want):
        err = _max_err(got, w)
        assert err < gate, f"{name}: max err {err}"
    assert _max_err(o, at0) > 0.1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "padding"])
def test_flash_kernels_at_a_head_and_row_offset(dev, dtype, head_dim,
                                                causal):
    """An sp x mp rank's launch: heads [3, 6) of 6 (`head_offset` 3) and
    queries from row 128 (`q_row0`) over 256 keys, dropout 0.1, with a
    padding mask when not causal. The keep bits the plain version draws at
    those heads and rows are the whole call's ``[heads, rows]`` slice bit
    for bit; forward (O, LSE) and both backward kernels (dQ; dK, dV)
    against the plain version at the same offsets, within 2e-5 in float32
    and 2e-2 in bfloat16; the bits move with both offsets (O differs from
    the launch at head 0 and row 0)."""
    b, h, total, off, q_row0, sq, sk = 2, 3, 6, 3, 128, 128, 256
    p, seed = 0.1, 131
    q, k, v, do = _flash_inputs(b, sq, sk, h, head_dim, dtype, dev, seed=9)
    mask = None if causal else _padding_mask(b, sk, dev)
    at = dict(head_offset=off, heads_total=total, q_row0=q_row0)
    whole = fa.dropout_factors(seed, p, b, total, q_row0 + sq, sk, dev)
    mine = fa.dropout_factors(seed, p, b, h, sq, sk, dev, **at)
    assert torch.equal(mine, whole[:, off:, q_row0:])
    o32 = torch.empty(q.shape, device=dev)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, mask, p, seed, o32,
                                    **at)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o32, do, lse, causal, mask,
                                        p, seed, **at)
    at0, _ = fa.flash_attention_fwd(q, k, v, causal, mask, p, seed)
    torch.cuda.synchronize()
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
    ref = fa.attention_ref(q32, k32, v32, causal, mask, p, seed, **at)
    ref.backward(do.float())
    want = (ref.detach(), fa.attention_lse_ref(q32.detach(), k32.detach(),
                                               causal, mask),
            q32.grad, k32.grad, v32.grad)
    gate = F32_GATE if dtype == torch.float32 else TOL[dtype]
    for name, got, w in zip(("o", "lse", "dq", "dk", "dv"),
                            (o, lse, dq, dk, dv), want):
        err = _max_err(got, w)
        assert err < gate, f"{name}: max err {err}"
    assert _max_err(o, at0) > 0.1


def _row0_zero_digests(dev, **row0):
    """sha256 (16 hex digits) of every output of one forward and one
    backward launch on fixed inputs (2 x 200, 3 heads, from a seeded CPU
    generator), for each dtype, head_dim and variant the main paths run
    (plain causal, padding mask, causal dropout, padding + dropout, a full
    mask). `row0` is passed to both launches (``q_row0=0`` or nothing)."""
    import hashlib

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128):
            for causal, variant in ((True, "plain"), (False, "padding"),
                                    (True, "dropout"),
                                    (False, "padding+dropout"),
                                    (True, "mask")):
                q, k, v, do = _flash_inputs(2, 200, 200, 3, d, dtype, dev,
                                            seed=21)
                mask = None
                if variant == "mask":
                    g = torch.Generator().manual_seed(22)
                    mask = torch.randn((2, 3, 200, 200), generator=g).to(dev)
                elif variant.startswith("padding"):
                    mask = _padding_mask(2, 200, dev)
                p, seed = (0.1, 4242) if "dropout" in variant else (0.0, None)
                o32 = (torch.empty(q.shape, device=dev)
                       if p and dtype != torch.float32 else None)
                o, lse = fa.flash_attention_fwd(q, k, v, causal, mask, p,
                                                seed, o32, **row0)
                grads = fa.flash_attention_bwd(
                    q, k, v, o if o32 is None else o32, do, lse, causal,
                    mask, p, seed, **row0)
                h = hashlib.sha256()
                for t in (o, lse) + tuple(grads):
                    h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                             .tobytes())
                out[f"{str(dtype)[6:]}-{d}-{variant}"] = h.hexdigest()[:16]
    return out


# `_row0_zero_digests` of the kernels before the keep bits took a query-row
# offset, on an H100 80GB HBM3 (700 W) with CUDA 12 (the tree at the parent
# of the change that added `q_row0`, built from its own csrc)
ROW0_ZERO_DIGESTS = {
    "float32-64-plain": "693e0f894b8a8ee9",
    "float32-64-padding": "38814c256890a28f",
    "float32-64-dropout": "bfa138d246dc239c",
    "float32-64-padding+dropout": "4da8119200757fd1",
    "float32-64-mask": "f7747fbcf2236593",
    "float32-128-plain": "9082ce79778e524f",
    "float32-128-padding": "999fc41c629c5fa6",
    "float32-128-dropout": "03bb9c81f841a155",
    "float32-128-padding+dropout": "c785804218b7e6d6",
    "float32-128-mask": "71fcc55ad02580b7",
    "bfloat16-64-plain": "72b372d4836f6162",
    "bfloat16-64-padding": "c1ef48074de96355",
    "bfloat16-64-dropout": "400fbbcd20624181",
    "bfloat16-64-padding+dropout": "3e0d4ff80ea2c5ee",
    "bfloat16-64-mask": "0724882369a11a6c",
    "bfloat16-128-plain": "b5cdb16c4b2bfa6a",
    "bfloat16-128-padding": "0f6958bb7ab659b0",
    "bfloat16-128-dropout": "bb4dfa130834700b",
    "bfloat16-128-padding+dropout": "404d977bf23a1915",
    "bfloat16-128-mask": "3c4be6f722d93a49",
}


def test_row0_zero_launches_are_bit_equal_to_the_kernels_before_it(dev):
    """Every launch at ``q_row0 = 0`` (and with no `q_row0` at all) gives
    the outputs the kernels gave before the offset existed, bit for bit
    (their digests, recorded from that tree on the card)."""
    assert ROW0_ZERO_DIGESTS, "no recorded digests"
    assert _row0_zero_digests(dev) == ROW0_ZERO_DIGESTS
    assert _row0_zero_digests(dev, q_row0=0) == ROW0_ZERO_DIGESTS


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gathered_steps_match_one_flash_call(dev, dtype, n):
    """The n ranks' gathered steps (`rank_forward`, `rank_backward`) in
    one process at gpt_1p3b's attention shape (1 x 2048, 16 heads, D 128,
    causal, dropout 0.1): O and dQ joined, dK and dV summed over the
    ranks' partials (each rank's written into a strided [S, B, 2, H, D]
    buffer, as the reduce-scatter takes them), within 2e-5 (f32) of one
    flash call over the whole sequence, in bf16 within 2e-2 plus one bf16
    ulp; each rank launches the forward and the backward pair once, over
    its key prefix, with no host sync."""
    from paddle_tpu_torch.parallel.sequence_attention import (
        rank_backward, rank_forward)

    B, S, H, D = 1, 2048, 16, 128
    p, seed = 0.1, 77
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    o32 = torch.empty(q.shape, device=dev)
    o, lse = fa.flash_attention_fwd(q, k, v, True, None, p, seed, o32)
    want = (o,) + tuple(fa.flash_attention_bwd(q, k, v, o32, do, lse, True,
                                               None, p, seed))
    L = S // n
    outs, dqs = [], []
    dk, dv = (torch.zeros((B, S, H, D), device=dev) for _ in "kv")
    for i in range(n):
        rows = slice(i * L, (i + 1) * L)
        parts = torch.zeros((S, B, 2, H, D), dtype=dtype, device=dev)
        views = [parts[:(i + 1) * L, :, j].transpose(0, 1) for j in (0, 1)]
        oi32 = torch.empty((B, L, H, D), device=dev)
        f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            oi, lsei = rank_forward(q[:, rows], k, v, i, True, None, p, seed,
                                    o32=oi32)
            dqi, _, _ = rank_backward(q[:, rows], k, v, oi32, do[:, rows],
                                      lsei, i, True, None, p, seed,
                                      out=views)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert (fa.flash_attention_fwd.launches - f0,
                fa.flash_attention_bwd.launches - b0) == (1, 1)
        outs.append(oi)
        dqs.append(dqi)
        dk += parts[:, :, 0].transpose(0, 1).float()
        dv += parts[:, :, 1].transpose(0, 1).float()
    for name, got, w in zip(("o", "dq", "dk", "dv"),
                            (torch.cat(outs, 1), torch.cat(dqs, 1), dk, dv),
                            want):
        err = (got.float() - w.float()).abs()
        if dtype == torch.bfloat16:
            _, e = torch.frexp(w.float())
            err = err - torch.ldexp(torch.ones_like(err), e - 8)
        assert err.max().item() <= RING_TOL[dtype], (name, err.max().item())


def test_gathered_attention_on_the_card_never_takes_the_plain_path(
        dev, monkeypatch):
    """On CUDA tensors a rank's gathered steps launch the kernels and never
    call the plain versions (made to raise here); a group of one is one
    flash call."""
    from paddle_tpu_torch.parallel import sequence_attention as sa

    def refuse(*a, **k):
        raise AssertionError("the plain path ran on a CUDA tensor")

    for name in ("attention_ref", "attention_lse_ref", "attention_bwd_ref"):
        monkeypatch.setattr(sa, name, refuse)
    q, k, v, do = _flash_inputs(1, 256, 256, 2, 64, torch.float32, dev)
    o, lse = sa.rank_forward(q[:, 128:], k, v, 1, True)
    sa.rank_backward(q[:, 128:], k, v, o, do[:, 128:].contiguous(), lse, 1,
                     True)
    f0 = fa.flash_attention_fwd.launches
    one = sa.gathered_attention(q, k, v, None, causal=True)
    assert fa.flash_attention_fwd.launches == f0 + 1
    torch.testing.assert_close(one, fa.flash_attention_fwd(q, k, v, True)[0],
                               rtol=0, atol=0)


def test_sp2_gloo_ranks_on_the_card_equal_one_process(dev):
    """A float32 ring GPT (2 layers, 2 heads of D 128, 2 x 512) over
    {"sp": 2}: two rank processes on one card over gloo (every hop staged
    through the host) give one process's losses within 1e-5 relative;
    sp rank i launches the forward and the backward pair (i + 1) times a
    layer and step, and its host syncs a step are counted."""
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models.gpt import gpt_loss_fn
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.parallel.spmd import make_sharded_train_step

    cfg = GPTConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                    num_heads=2, max_seq_len=512, attn_impl="ring")
    rs = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rs.randint(0, 1024, (2, 512)))
                   for _ in range(2))
    model = GPT(cfg, device=dev, seed=0)
    opt = SGD(learning_rate=0.1, parameters=model.named_parameters())
    model.train()
    want = []
    for _ in range(2):
        loss = model(ids.to(dev), labels=labels.to(dev))
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        want.append(loss.item())
    model = GPT(cfg, device=dev, seed=0)
    opt = SGD(learning_rate=0.1, parameters=model.named_parameters())
    mesh = build_mesh({"sp": 2}, devices=[str(dev)] * 2, backend="gloo",
                      timeout=120)
    try:
        step = make_sharded_train_step(model, gpt_loss_fn, opt, mesh,
                                       batch_specs=(("dp", "sp"),) * 2)
        step.rank_reports(zero=True)
        step.count_host_syncs()
        got = [step(ids, labels) for _ in range(2)]
        reports = step.rank_reports()
        syncs = [r["host_syncs"] for r in step.last_step]
        step.close()
    finally:
        mesh.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for i, rep in enumerate(reports):
        n = cfg.num_layers * (i + 1) * 2
        assert (rep["launches"]["fwd_launches"],
                rep["launches"]["bwd_launches"]) == (n, n), (i, rep)
        assert rep["collectives"]["send"] == rep["collectives"]["recv"] == \
            2 * cfg.num_layers * 3
    assert all(isinstance(n, int) and n > 0 for n in syncs), syncs


def test_gpt_train_step_on_the_card_matches_the_cpu(dev):
    """Two AdamW steps of a small GPT in float32: the card (flash kernels)
    against a CPU copy (plain attention), same weights and batch."""
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=96)
    models = [GPT(cfg, device=d, seed=0) for d in (dev, "cpu")]
    models[1].load_state_dict({k: t.cpu() for k, t in
                               models[0].state_dict().items()})
    rs = np.random.RandomState(0)
    ids, labels = (torch.from_numpy(rs.randint(0, 512, (2, 96)))
                   for _ in "il")
    losses = []
    f0 = fa.flash_attention_fwd.launches
    for m in models:
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
        m.train()
        run = []
        for _ in range(2):
            loss = m(ids.to(m.device), labels=labels.to(m.device))
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            run.append(loss.item())
        losses.append(run)
    assert fa.flash_attention_fwd.launches - f0 == 2 * cfg.num_layers
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    for (n, a), (_, b) in zip(models[0].named_parameters(),
                              models[1].named_parameters()):
        assert _max_err(a.cpu(), b) < 1e-3, n


# -- flash attention: the mask and dropout variants ----------------------------

def _padding_mask(b, sk, dev, seed=0):
    """ERNIE's additive padding mask [b, 1, 1, sk]: 0 on each row's real
    keys (at least half of them), -1e4 on the rest."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(sk // 2, sk + 1, b)
    keep = np.arange(sk)[None] < lens[:, None]
    return torch.from_numpy(np.where(keep, 0.0, -1e4).astype(np.float32)
                            ).view(b, 1, 1, sk).to(dev)


def _variant_ref(q, k, v, do, causal, mask, p, seed):
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
    o = fa.attention_ref(q32, k32, v32, causal, mask, p, seed)
    o.backward(do.float())
    lse = fa.attention_lse_ref(q32.detach(), k32.detach(), causal, mask)
    return o.detach(), lse, q32.grad, k32.grad, v32.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("variant", ["mask", "padding", "dropout",
                                     "padding+dropout"])
@pytest.mark.parametrize("sq,sk", [(256, 256), (77, 200), (200, 200)])
def test_flash_variants_match_plain_version(dev, dtype, head_dim, causal,
                                            variant, sq, sk):
    """The three kernels with an additive mask ([B, H, Sq, Sk] random, or
    a [B, 1, 1, Sk] padding mask read through stride-0 dims), with dropout
    (p 0.1, the plain version replaying the same Philox bits), and with
    both, against the plain version in float32 on the same values."""
    b, h = 2, 3
    q, k, v, do = _flash_inputs(b, sq, sk, h, head_dim, dtype, dev, seed=3)
    mask = None
    if variant == "mask":
        g = torch.Generator().manual_seed(4)
        mask = torch.randn((b, h, sq, sk), generator=g).to(dev)
    elif variant.startswith("padding"):
        mask = _padding_mask(b, sk, dev)
    p, seed = (0.1, 1234567) if "dropout" in variant else (0.0, None)
    counts = [(f.launches, f.mask_launches, f.dropout_launches)
              for f in (fa.flash_attention_fwd, fa.flash_attention_bwd)]
    # with dropout the forward also writes O in f32, which the backward's
    # delta takes (as FlashAttention does)
    o32 = torch.empty(q.shape, device=dev) if p > 0 else None
    o, lse = fa.flash_attention_fwd(q, k, v, causal, mask, p, seed, o32)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o if o32 is None else o32,
                                        do, lse, causal, mask, p, seed)
    torch.cuda.synchronize()
    if o32 is not None:
        assert _max_err(o, o32) < TOL[dtype]
    for f, (n, nm, nd) in zip((fa.flash_attention_fwd,
                               fa.flash_attention_bwd), counts):
        assert (f.launches, f.mask_launches, f.dropout_launches) == (
            n + 1, nm + (mask is not None), nd + (p > 0))
    want = _variant_ref(q, k, v, do, causal, mask, p, seed)
    for name, got, ref in zip(("o", "lse", "dq", "dk", "dv"),
                              (o, lse, dq, dk, dv), want):
        err = _max_err(got, ref)
        assert err < TOL[dtype], f"{name}: max err {err}"


def test_padding_mask_is_read_in_place(dev):
    """A [B, 1, 1, Sk] float32 mask reaches the kernel as an expanded view
    (stride 0 on heads and queries, no copy), and gives what the same mask
    materialized to [B, H, Sq, Sk] gives."""
    q, k, v, do = _flash_inputs(2, 130, 130, 4, 64, torch.bfloat16, dev)
    mask = _padding_mask(2, 130, dev)
    view = fa._mask_view(mask, 2, 4, 130, 130, q.device)
    assert view.data_ptr() == mask.data_ptr()
    assert view.stride() == (130, 0, 0, 1)
    full = mask.expand(2, 4, 130, 130).contiguous()
    a = fa.flash_attention_fwd(q, k, v, False, mask, 0.1, 9)
    b = fa.flash_attention_fwd(q, k, v, False, full, 0.1, 9)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_bool_mask_and_mask_grad_on_the_card(dev):
    """A bool mask keeps the scores where True (as `where(mask, s, -1e30)`),
    and a float mask that requires a gradient gets P * (dP D - delta),
    summed over its broadcast head dim, as autograd gives on the CPU."""
    q, k, v, do = _flash_inputs(2, 96, 96, 3, 64, torch.float32, dev)
    g = torch.Generator().manual_seed(5)
    keep = torch.rand((2, 1, 96, 96), generator=g) > 0.3
    keep[..., 0] = True
    got = fa.flash_attention(q, k, v, mask=keep.to(dev))
    want = fa.attention_ref(q, k, v, mask=keep.to(dev))
    assert _max_err(got, want) < TOL[torch.float32]
    m = torch.randn((2, 1, 96, 96), generator=g)
    grads = []
    for d in (dev, "cpu"):
        mt = m.to(d).requires_grad_()
        o = fa.flash_attention(q.to(d), k.to(d), v.to(d), causal=True,
                               mask=mt, dropout_p=0.2, seed=77)
        o.backward(do.to(d))
        grads.append(mt.grad.cpu())
    assert grads[0].shape == m.shape
    assert _max_err(grads[0], grads[1]) < TOL[torch.float32]


def test_bert_train_step_on_the_card_matches_the_cpu(dev):
    """Two AdamW steps of a 2-layer ERNIE-width encoder in float32 with a
    padding mask (dropout 0): the card (the flash kernels' mask variant)
    against a CPU copy (plain attention), same weights and batch."""
    from paddle_tpu_torch.models.bert import (Bert, BertConfig,
                                              bert_pretrain_loss_fn)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = BertConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                     num_heads=4, intermediate_size=1024,
                     max_position_embeddings=128, dropout=0.0)
    models = [Bert(cfg, device=d, seed=0) for d in (dev, "cpu")]
    models[1].load_state_dict({k: t.cpu() for k, t in
                               models[0].state_dict().items()})
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, 1024, (2, 128)))
    labels = torch.where(torch.from_numpy(rs.rand(2, 128) < 0.15), ids,
                         torch.full_like(ids, -100))
    mask = _padding_mask(2, 128, "cpu")
    losses = []
    f0 = fa.flash_attention_fwd.mask_launches
    for m in models:
        opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
        m.train()
        run = []
        for _ in range(2):
            out = m(ids.to(m.device), None, mask.to(m.device))
            loss = bert_pretrain_loss_fn(out, labels.to(m.device))
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
            run.append(loss.item())
        losses.append(run)
    assert fa.flash_attention_fwd.mask_launches - f0 == 2 * cfg.num_layers
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)
    for (n, a), (_, b) in zip(models[0].named_parameters(),
                              models[1].named_parameters()):
        assert _max_err(a.cpu(), b) < 1e-3, n


# -- the training surface: remat, O2 masters, clip, GradScaler -----------------

def _small_gpt_cfg(**kw):
    return GPTConfig(vocab_size=512, hidden_size=128, num_layers=2,
                     num_heads=1, max_seq_len=96, **kw)


@pytest.mark.parametrize("model", ["gpt", "bert"])
def test_remat_with_dropout_equals_no_remat_on_the_card(dev, model):
    """float32, dropout 0.1 in the attention kernel and the elementwise
    dropouts: a remat step gives the no-remat loss and gradients (the
    recomputed kernel drew the same Philox keep bits), leaves the dropout
    generators where the plain step leaves them, and runs the forward
    kernel twice a layer."""
    from paddle_tpu_torch.models.bert import (Bert, BertConfig,
                                              bert_pretrain_loss_fn)

    rs = np.random.RandomState(1)
    ids = torch.from_numpy(rs.randint(0, 512, (2, 96))).to(dev)
    if model == "gpt":
        def make(remat):
            return GPT(_small_gpt_cfg(dropout=0.1, remat=remat), device=dev,
                       seed=0)

        def run(m):
            return m(ids, labels=ids)
    else:
        mask = _padding_mask(2, 96, dev)

        def make(remat):
            return Bert(BertConfig(vocab_size=512, hidden_size=128,
                                   num_layers=2, num_heads=2,
                                   intermediate_size=256,
                                   max_position_embeddings=96, dropout=0.1,
                                   remat=remat), device=dev, seed=0)

        def run(m):
            return bert_pretrain_loss_fn(m(ids, None, mask), ids)
    out = []
    for remat in (False, True):
        m = make(remat)
        m.train()
        m.seed_dropout(5)
        f0 = fa.flash_attention_fwd.dropout_launches
        loss = run(m)
        loss.backward()
        g = m.dropout_generators
        out.append((loss.item(), [p.grad for p in m.parameters()],
                    (g.attn.get_state(), g.elem.get_state()),
                    fa.flash_attention_fwd.dropout_launches - f0))
    (l0, g0, s0, n0), (l1, g1, s1, n1) = out
    assert l0 == l1
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            assert _max_err(a, b) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert n1 == 2 * n0 == 4


def test_o2_step_with_clip_and_schedule_raises_no_host_sync(dev):
    """A bf16 O2 step of a small GPT with remat, AdamW under a scheduler
    and the global-norm clip runs under set_sync_debug_mode("error"), and
    leaves every parameter the bf16 rounding of its float32 master."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    m = GPT(_small_gpt_cfg(remat=True), device=dev, seed=0)
    sched = LinearWarmup(CosineAnnealingDecay(1e-3, T_max=10), 2, 0.0, 1e-3)
    clip = ClipGradByGlobalNorm(0.5)
    opt = AdamW(learning_rate=sched, grad_clip=clip,
                parameters=m.parameters())
    m, opt = amp.decorate(m, opt, level="O2")
    m.train()
    ids = torch.from_numpy(np.random.RandomState(2).randint(
        0, 512, (2, 96))).to(dev)
    losses = []
    for _ in range(3):
        torch.cuda.set_sync_debug_mode("error")
        try:
            loss = m(ids, labels=ids)
            loss.backward()
            opt.step()
            opt.zero_grad(set_to_none=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sched.step()
        losses.append(loss.item())
        for p in m.parameters():
            master = opt.state[p]["master_weight"]
            assert p.dtype == torch.bfloat16
            assert torch.equal(p, master.to(torch.bfloat16))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert np.isfinite(clip.global_norm.item())


def test_grad_scaler_skips_a_step_with_an_inf_on_the_card(dev):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.optimizer import AdamW

    m = GPT(_small_gpt_cfg(), device=dev, seed=0)
    opt = AdamW(learning_rate=1e-3, parameters=m.parameters())
    m, opt = amp.decorate(m, opt, level="O2")
    m.train()
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, 512, (2, 96))).to(dev)
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 15)
    scaler.scale(m(ids, labels=ids)).backward()
    m.blocks[1].fc2.weight.grad.view(-1)[3] = float("nan")
    before = [p.detach().clone() for p in m.parameters()]
    scaler.step(opt)
    scaler.update()
    assert all(torch.equal(a, p) for a, p in zip(before, m.parameters()))
    assert scaler._scale == 2.0 ** 14 and opt._step_count == 0


# -- the fleet on one card: captures beside stepping replicas, streamed
# weights, memory back after a replica goes --------------------------------

_CAPTURE_BESIDE = r"""
import json, sys, threading, torch
mode = sys.argv[1]
dev = torch.device("cuda")
x = torch.ones(1 << 16, device=dev)
side = torch.cuda.Stream(dev)
side.wait_stream(torch.cuda.current_stream(dev))
with torch.cuda.stream(side):
    y = x * 2                       # warm the kernel outside the capture
torch.cuda.current_stream(dev).wait_stream(side)
torch.cuda.synchronize()
other = {}

def replica_step():
    # what another replica's step does: allocate, compute, copy back
    try:
        t = torch.arange(1 << 20, device=dev, dtype=torch.float32) + 1.0
        other["sum"] = float(t.sum().cpu())
    except Exception as e:
        other["error"] = f"{type(e).__name__}: {e}"

g = torch.cuda.CUDAGraph()
res = {"mode": mode}
try:
    with torch.cuda.graph(g, stream=side, capture_error_mode=mode):
        y = x * 2
        th = threading.Thread(target=replica_step)
        th.start()
        th.join()
    g.replay()
    torch.cuda.synchronize()
    res["replay_ok"] = bool((y == 2).all())
except Exception as e:
    res["capture_error"] = f"{type(e).__name__}: {e}"
res.update(other)
print(json.dumps(res))
"""


@pytest.mark.parametrize("mode", ["global", "thread_local"])
def test_capture_beside_another_threads_step(dev, mode):
    """What a replica's step on another thread does to a CUDA-graph
    capture (run in a fresh process: a failed capture can leave the
    caching allocator mid-capture). In "global" mode the other thread's
    allocation and copy back are refused and the capture fails; in
    "thread_local" mode, the engine's (`_StepProgram._capture`), both go
    through and the graph replays."""
    import json
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "-c", _CAPTURE_BESIDE, mode],
                         capture_output=True, text=True, timeout=120)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    if mode == "global":
        assert "error" in res or "capture_error" in res, res
    else:
        assert res.get("replay_ok") is True, res
        assert res["sum"] == float(sum(range(1, (1 << 20) + 1))), res


def test_replica_captures_while_another_serves(dev):
    """A replica builds and captures its step programs on this thread
    while another replica serves on its own thread: no capture and no
    step fails, the serving replica's tokens are those of a quiet run,
    and the launch counts equal one a layer per step of either (capture
    ticks are recorded aside, ops/counts.py)."""
    import threading

    serving = _tiny_bf16_engine(dev, warmup=True)
    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 512, n).tolist() for n in (9, 40, 70, 12)]
    quiet = serving.generate(prompts, max_new_tokens=12)
    pa.ragged_paged_attention.launches = 0
    steps0 = serving.step_count
    done, outs, errors = threading.Event(), [], []

    def serve():
        try:
            with serving.device_scope():
                while not done.is_set():
                    outs.append(serving.generate(prompts, max_new_tokens=12))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    th = threading.Thread(target=serve)
    th.start()
    built = []
    try:
        for _ in range(3):
            built.append(_tiny_bf16_engine(dev, warmup=True))
    finally:
        done.set()
        th.join()
    assert not errors, errors
    assert outs and all(o == quiet for o in outs)
    steps = serving.step_count - steps0 + sum(e.step_count for e in built)
    assert pa.ragged_paged_attention.launches == 2 * steps
    for e in built:
        assert e.generate(prompts, max_new_tokens=12) == quiet


def test_streamed_engine_on_the_card(dev, tmp_path):
    """A bf16 skeleton streamed from a checkpoint onto the card holds the
    saved weights bit for bit and serves the eager engine's tokens."""
    from paddle_tpu_torch.distributed.checkpoint import save_sharded_model
    from paddle_tpu_torch.nn import is_skeleton, skeleton_init

    eager = _tiny_bf16_engine(dev)
    save_sharded_model(eager.model, None, str(tmp_path))
    with skeleton_init():
        skel = GPT(eager.model.cfg, dtype=torch.bfloat16)
    streamed = LLMEngine(skel, device=dev, block_size=16, max_batch=4,
                         prefill_chunk=32, spec_decoding=True,
                         checkpoint_path=str(tmp_path))
    assert is_skeleton(skel) and streamed.model.device.type == "cuda"
    for a, b in zip(streamed.model.parameters(), eager.model.parameters()):
        assert torch.equal(a, b)
    rep = streamed.load_report
    assert rep.max_chip_bytes == rep.total_bytes == sum(
        p.numel() * p.element_size() for p in eager.model.parameters())
    prompts = [[5, 6, 7] * 6, list(range(1, 40))]
    assert streamed.generate(prompts, max_new_tokens=8) == \
        eager.generate(prompts, max_new_tokens=8)


def test_dropped_replica_gives_its_memory_back(dev, tmp_path):
    """A streamed replica with captured graphs and a host tier, served
    through its AsyncLLMEngine and shut down: once dropped, the card's
    allocated bytes are back where they were before it was built. (The
    first replica's life is not measured: it creates this thread's cuBLAS
    workspace on the capture stream, which cuBLAS keeps for the process.
    The second's must leave nothing.)"""
    import asyncio
    import gc

    from paddle_tpu_torch.distributed.checkpoint import save_sharded_model
    from paddle_tpu_torch.nn import skeleton_init
    from paddle_tpu_torch.serving import AsyncLLMEngine

    src = GPT(GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                        num_heads=2, max_seq_len=256), device=dev,
              dtype=torch.bfloat16, seed=0)
    save_sharded_model(src, None, str(tmp_path))
    with skeleton_init():
        skel = GPT(src.cfg, dtype=torch.bfloat16)
    del src

    async def life():
        fe = AsyncLLMEngine(LLMEngine(
            skel, device=dev, block_size=16, max_batch=4, prefill_chunk=32,
            spec_decoding=True, warmup=True, host_kv_blocks=16,
            checkpoint_path=str(tmp_path)))
        await fe.start()
        toks, reason = await fe.submit(list(range(1, 60)),
                                       max_new_tokens=8).collect()
        await fe.shutdown()
        return len(toks), reason

    assert asyncio.run(life()) == (8, "length")
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    assert asyncio.run(life()) == (8, "length")
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before


def _tp_wave(engine):
    rs = np.random.RandomState(3)
    shared = rs.randint(0, 512, 40).tolist()
    prompts = [shared + rs.randint(0, 512, n).tolist() for n in (3, 30)]
    prompts += [rs.randint(0, 512, n).tolist() for n in (7, 70)]
    engine.generate(prompts[:1], max_new_tokens=2, temperature=0.0)
    return engine.generate(prompts, max_new_tokens=12, temperature=0.0)


def _tp_model():
    return GPT(GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                         num_heads=2, max_seq_len=256), device="cuda")


def _tp_budget_held(engine):
    """Every rank made `serving_collective_budget` calls a step (through
    graph replays as well as eager steps)."""
    from paddle_tpu_torch.serving import serving_collective_budget

    engine.rank_reports(zero=True)
    steps0 = engine.step_count
    engine.generate([[1, 2, 3, 4, 5]], max_new_tokens=6, temperature=0.0)
    steps = engine.step_count - steps0
    b = serving_collective_budget(engine.model.cfg, 2,
                                  engine.quant_collectives)
    for rep in engine.rank_reports():
        assert rep["collectives"] == {k: b.get(k, 0) * steps for k in (
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "send", "recv")}


@pytest.mark.parametrize("quant", [False, True])
def test_tp2_nccl_graphs_token_identical_to_tp1(dev, quant):
    """tp=2 over NCCL, one rank a card, the collectives captured in each
    width bucket's CUDA graph: the one-card greedy tokens (f32, spec and
    prefix hits on), and the collective budget a step on every rank. Needs
    two cards; on one it skips (phase 3h runs the gloo path there)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs torch.cuda.device_count() >= 2: NCCL takes one "
                    "rank a card")
    from paddle_tpu_torch.serving import build_serving_mesh

    kw = dict(block_size=16, max_batch=4, spec_decoding=True,
              num_spec_tokens=3, prefill_chunk=32, warmup=True)
    model = _tp_model()
    want = _tp_wave(LLMEngine(model, **kw))
    # cuda:0 and cuda:1, NCCL picked as for mesh=2; a missed collective
    # fails in 120 s instead of the default's 30 minutes
    eng = LLMEngine(model, mesh=build_serving_mesh(2, timeout=120),
                    quant_allreduce=quant or None, **kw)
    try:
        assert eng.mesh_info()["backend"] == "cuda"
        assert all(p.graph is not None for p in eng._step_fns.values())
        got = _tp_wave(eng)
        if not quant:
            assert got == want
        _tp_budget_held(eng)
    finally:
        eng.close()
    # every rank shut its communicators down together: none is left for
    # a destructor to abort alone at exit
    assert eng._smesh.group.pg is None and not eng._tp.alive()


def _zero_losses(mesh, zero_stage, steps=3):
    """f32 losses of `steps` AdamW steps of `_tp_model` at `zero_stage`
    over `mesh` (batch 4 x 128 from RandomState(0), 2 rows a rank); the
    step's collective calls on every rank."""
    from paddle_tpu_torch.models.gpt import gpt_loss_fn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.spmd import make_sharded_train_step

    model = _tp_model()
    opt = AdamW(learning_rate=1e-3, parameters=model.named_parameters())
    step = make_sharded_train_step(model, gpt_loss_fn, opt, mesh,
                                   zero_stage=zero_stage)
    rs = np.random.RandomState(0)
    ids, labels = (rs.randint(0, 512, (4, 128)) for _ in range(2))
    try:
        step.rank_reports(zero=True)
        losses = [step(ids, labels) for _ in range(steps)]
        counts = step.collective_counts()
        n = len(step.names)
    finally:
        step.close()
    return losses, counts, n


def test_zero2_nccl_dp2_equals_zero0(dev):
    """ZeRO stages 2 and 3 over NCCL, one rank a card (cuda:0, cuda:1), in
    float32 (TF32 off): the losses equal stage 0's bit for bit (two-term
    sums have one order), and each rank's collective calls a step are
    `train_collective_budget`'s. Every rank shuts its communicators down
    together at close. Needs two cards; on one it skips (chip_smoke phase
    6d runs the gloo path there)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs torch.cuda.device_count() >= 2: NCCL takes one "
                    "rank a card")
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.parallel.spmd import train_collective_budget

    mesh = build_mesh({"dp": 2}, timeout=120)
    assert mesh.backend == "nccl"
    try:
        got = {zs: _zero_losses(mesh, zs) for zs in (0, 2, 3)}
        group, ranks = mesh.group, mesh.ranks
    finally:
        mesh.close()
    assert got[2][0] == got[0][0] and got[3][0] == got[0][0], got
    for zs in (2, 3):
        _, counts, n = got[zs]
        b = train_collective_budget(n, 2)
        for c in counts:
            assert c == {k: 3 * b.get(k, 0) for k in c}, (zs, c, b)
    assert group.pg is None and not ranks.alive()


def test_tp2_gloo_on_one_card_token_identical_to_tp1(dev):
    """Two ranks on one card over an explicit gloo backend (the one-card
    departure): eager steps, every collective staged through the host,
    the one-card greedy tokens and the collective budget on every rank."""
    from paddle_tpu_torch.serving import ServingMesh

    kw = dict(block_size=16, max_batch=4, spec_decoding=True,
              num_spec_tokens=3, prefill_chunk=32)
    model = _tp_model()
    want = _tp_wave(LLMEngine(model, **kw))
    with pytest.raises(ValueError, match="backend='gloo'"):
        LLMEngine(model, mesh=ServingMesh(["cuda:0", "cuda:0"]), **kw)
    eng = LLMEngine(model, mesh=ServingMesh(["cuda:0", "cuda:0"],
                                            backend="gloo"), **kw)
    try:
        assert eng.mesh_info()["backend"] == "cuda-gloo"
        assert _tp_wave(eng) == want
        assert all(p.graph is None for p in eng._step_fns.values())
        _tp_budget_held(eng)
    finally:
        eng.close()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,with_mask", [(True, False), (False, True)])
def test_flash_head_offset_matches_plain_version(dev, dtype, causal,
                                                 with_mask):
    """An mp rank's share of the heads (heads [4, 8) of 8, `head_offset`):
    the forward, dK/dV and dQ kernels with dropout against the plain
    version at the same offset (the same keep bits), and the rank's O
    against those heads of one call over all 8; offset 0 of the call's
    own heads draws the bits it always drew, bit for bit."""
    B, S, H, D = 2, 256, 4, 128 if causal else 64
    g = torch.Generator(device="cuda").manual_seed(0)
    full = [torch.randn((B, S, 2 * H, D), generator=g, device="cuda")
            .to(dtype) for _ in range(4)]
    q, k, v, do = (t[:, :, H:].contiguous() for t in full)
    mask = None
    if with_mask:
        lens = torch.tensor([S, S // 2], device="cuda")
        real = torch.arange(S, device="cuda")[None] < lens[:, None]
        mask = torch.where(real, 0.0, -1e4)[:, None, None, :]
    var = (causal, mask, 0.2, 4242)
    hk = dict(head_offset=H, heads_total=2 * H)
    o32 = torch.empty(q.shape, device="cuda")
    o, lse = fa.flash_attention_fwd(q, k, v, *var, o32, **hk)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o32, do, lse, *var, **hk)
    qr, kr, vr = (t.float().requires_grad_() for t in (q, k, v))
    ref = fa.attention_ref(qr, kr, vr, *var, **hk)
    ref.backward(do.float())
    tol = TOL[dtype]
    for got, want in ((o, ref), (dq, qr.grad), (dk, kr.grad),
                      (dv, vr.grad)):
        assert (got.float() - want).abs().max().item() <= tol
    whole, _ = fa.flash_attention_fwd(*full[:3], *var,
                                      torch.empty(full[0].shape,
                                                  device="cuda"))
    assert (whole[:, :, H:].float() - o.float()).abs().max().item() <= tol
    plain, _ = fa.flash_attention_fwd(q, k, v, *var, None)
    same, _ = fa.flash_attention_fwd(q, k, v, *var, None, head_offset=0,
                                     heads_total=H)
    assert torch.equal(plain, same)
    assert not torch.equal(plain, o)


def test_mp2_nccl_equals_one_process(dev):
    """{"mp": 2} over NCCL, one rank a card (cuda:0, cuda:1), float32 (TF32
    off): 3 AdamW steps of `_tp_model` give one process's losses within
    1e-5, and with dropout 0.1 too (the rank's kernels draw their heads'
    model bits); every rank shuts its communicators down together at
    close. Needs two cards; on one it skips (chip_smoke phase 6e runs the
    gloo path there)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs torch.cuda.device_count() >= 2: NCCL takes one "
                    "rank a card")
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models.gpt import gpt_loss_fn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.spmd import make_sharded_train_step

    rs = np.random.RandomState(0)
    ids, labels = (rs.randint(0, 512, (4, 128)) for _ in range(2))

    def losses(mesh, dropout):
        model = GPT(GPTConfig(vocab_size=512, hidden_size=256, num_layers=2,
                              num_heads=2, max_seq_len=256, dropout=dropout),
                    device="cuda")
        opt = AdamW(learning_rate=1e-3, parameters=model.named_parameters())
        step = make_sharded_train_step(model, gpt_loss_fn, opt, mesh)
        try:
            return [step(ids, labels, seed=7) for _ in range(3)]
        finally:
            step.close()

    one = build_mesh({"dp": 1})
    mesh = build_mesh({"mp": 2}, timeout=120)
    assert mesh.backend == "nccl"
    try:
        got = {p: losses(mesh, p) for p in (0.0, 0.1)}
        group, ranks = mesh.group, mesh.ranks
    finally:
        mesh.close()
    for p in (0.0, 0.1):
        np.testing.assert_allclose(got[p], losses(one, p), rtol=1e-5)
    assert group.pg is None and not ranks.alive()


def _closed_tp_engine_life(model, kw, how):
    """Build a tp=2 engine on cuda:0 (gloo), serve, close and drop it:
    on this thread ("main"), on a worker thread that then ends
    ("thread"), or behind an `AsyncLLMEngine` whose serving thread steps
    it ("async", as a fleet replica is served). Returns the weak
    reference to the engine."""
    import asyncio
    import threading
    import weakref

    from paddle_tpu_torch.serving import AsyncLLMEngine, ServingMesh

    box = []

    def build():
        return LLMEngine(model, mesh=ServingMesh(["cuda:0", "cuda:0"],
                                                 backend="gloo"), **kw)

    def life():
        eng = build()
        eng.generate([[1, 2, 3, 4]], max_new_tokens=4, temperature=0.0)
        box.append(weakref.ref(eng))
        eng.close()

    async def served():
        eng = build()
        fe = AsyncLLMEngine(eng)
        await fe.start()
        await fe.submit([1, 2, 3, 4], max_new_tokens=4).collect()
        await fe.shutdown()
        box.append(weakref.ref(eng))
        eng.close()

    if how == "thread":
        t = threading.Thread(target=life)
        t.start()
        t.join(120)
    elif how == "async":
        asyncio.run(served())
    else:
        life()
    return box[0]


def _holders(obj):
    """The gc-visible referrers of `obj` (their types and modules) and the
    count of references gc cannot list."""
    import gc
    import sys
    import types

    refs = [r for r in gc.get_referrers(obj)
            if not isinstance(r, types.FrameType)]
    # the caller's name, this parameter and getrefcount's argument
    count = sys.getrefcount(obj) - 3
    return {"refcount": count, "gc_visible": len(refs),
            "outside_gc": count - len(refs),
            "referrers": [f"{type(r).__module__}.{type(r).__name__}"
                          for r in refs][:8]}


def _allocated(clear_cublas):
    """This process's allocated card bytes after a collection; with
    `clear_cublas`, cuBLAS's per-(thread, stream) workspaces dropped first
    (the process-wide cache the port leaves alone while any engine may
    run)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    if clear_cublas:
        torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def test_a_closed_tp_engine_is_freed_on_the_card(dev):
    """Beside tests/test_torch_router_tp.py::test_a_closed_tp_engine_is_freed
    (the CPU check): on the card, a closed tp=2 engine (two ranks on
    cuda:0 over gloo), served on this thread, on a worker thread that
    ends, and behind an `AsyncLLMEngine`, is collected (no reference to
    it left, the port's or any other) and gives its card memory back
    within 64 MiB of the figure before it was built, cuBLAS's workspaces
    aside (33 MiB for each new thread and stream that ran a product,
    kept by cuBLAS for the process). Each life's survival, holders and
    deltas with and without those workspaces are printed."""
    kw = dict(block_size=16, max_batch=4, spec_decoding=True,
              num_spec_tokens=3, prefill_chunk=32)
    model = _tp_model()
    LLMEngine(model, **kw).generate([[1, 2, 3]], max_new_tokens=2)
    report = {}
    for how in ("main", "thread", "async"):
        raw0, before = _allocated(False), _allocated(True)
        ref = _closed_tp_engine_life(model, kw, how)
        raw = _allocated(False) - raw0
        after = _allocated(True)
        obj = ref()
        held = None if obj is None else _holders(obj)
        del obj
        report[how] = dict(alive=held is not None, holders=held,
                           delta_mib=(after - before) / 2**20,
                           delta_with_cublas_workspaces_mib=raw / 2**20)
        print(f"[closed-tp-engine] {how}: {report[how]}")
    for how, rec in report.items():
        assert not rec["alive"], report
        assert rec["delta_mib"] <= 64, report


def test_pp2_nccl_equals_one_process(dev):
    """The pipelined GPT over {"pp": 2} with 1F1B over NCCL, one stage a
    card (cuda:0, cuda:1), float32 (TF32 off): 3 SGD steps from one set
    of weights give the one-process model's losses within 1e-5 relative
    and its parameters within 1e-5 relative to their norms; the stage
    hand-offs go card to card. Needs two cards; on one it skips
    (chip_smoke phase 6f runs the gloo path there)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs torch.cuda.device_count() >= 2: NCCL takes one "
                    "rank a card")
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models.gpt_pipeline import (init_params,
                                                      layer_stack,
                                                      make_pipelined_gpt,
                                                      stage_stack)

    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_layers=4,
                    num_heads=2, max_seq_len=256)
    one_params = init_params(cfg, 1, device="cuda")
    layers = layer_stack(one_params["blocks"])
    rs = np.random.RandomState(0)
    ids, labels = (rs.randint(0, 512, (8, 256)) for _ in range(2))

    def run(mesh, params):
        _, step = make_pipelined_gpt(cfg, mesh, 4, "1f1b", params=params)
        try:
            losses = [step(ids, labels, 0.1) for _ in range(3)]
            got = step.gather_params()
        finally:
            step.close()
        got["blocks"] = stage_stack(layer_stack(got["blocks"]), 1)
        return losses, got

    mesh = build_mesh({"pp": 2}, timeout=120)
    assert mesh.backend == "nccl"
    try:
        got, params = run(mesh, dict(one_params,
                                     blocks=stage_stack(layers, 2)))
        group, ranks = mesh.group, mesh.ranks
    finally:
        mesh.close()
    want, wparams = run(build_mesh({"dp": 1}), one_params)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    flat = lambda p: {**{k: v for k, v in p.items() if k != "blocks"},  # noqa: E731
                      **{f"b.{k}": v for k, v in p["blocks"].items()}}
    for k, w in flat(wparams).items():
        g = flat(params)[k]
        assert float((g - w).norm() / w.norm()) < 1e-5, k
    assert group.pg is None and not ranks.alive()


# -- expert parallelism and incubate (chip_smoke phase 6h, small) ------------

MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _rel(got, want):
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def _moe_fwd_bwd(layer, x, do, dense):
    """The layer's out, aux and gradients of ``sum(out * dO) + aux`` in
    its indexed form, or (`dense`) in the dense einsum form."""
    from paddle_tpu_torch.distributed import moe

    layer.zero_grad(set_to_none=True)
    xg = x.detach().requires_grad_()
    if dense:
        flat = xg.reshape(-1, x.shape[-1])
        gates = layer.gate.gate_fn(flat)
        cap = moe.expert_capacity(layer.capacity_factor, flat.shape[0],
                                  layer.num_experts)
        out = moe.dense_moe(flat, gates, layer.w1, layer.b1, layer.w2,
                            layer.b2, cap).reshape(x.shape)
        aux = moe.switch_aux_loss(gates, gates.argmax(-1))
    else:
        out = layer(xg)
        aux = layer.aux_loss
    ((out * do).sum() + aux).backward()
    res = dict(out=out.detach(), aux=aux.detach(), x=xg.grad)
    res.update({n: p.grad for n, p in layer.named_parameters()})
    return res


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_indexed_form_matches_the_dense_form(dev, dtype, cf):
    """Phase 6h (a) at a small size: MoELayer(256, 512, 8, "switch") on
    x [4, 128, 256], its indexed dispatch and combine against the dense
    einsum form on the same weights: out, aux and every gradient within
    1e-5 relative (f32, TF32 off) or 2e-2 (bf16)."""
    from paddle_tpu_torch.distributed import moe

    layer = moe.MoELayer(256, 512, 8, gate="switch", capacity_factor=cf,
                         device=dev, seed=3).to(dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    x, do = (torch.randn((4, 128, 256), generator=g, device=dev).to(dtype)
             for _ in range(2))
    got = _moe_fwd_bwd(layer, x, do, dense=False)
    want = _moe_fwd_bwd(layer, x, do, dense=True)
    err = {k: _rel(got[k], want[k]) for k in want}
    assert max(err.values()) <= MOE_TOL[dtype], err


def _plain_attention(q, k, v, causal=False, mask=None, dropout_p=0.0,
                     seed=None, head_offset=0, heads_total=None):
    return fa.attention_ref(q, k, v, causal, mask, dropout_p, seed,
                            head_offset, heads_total)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mha_through_the_flash_kernels_matches_plain(dev, dtype,
                                                           monkeypatch):
    """Phase 6h (d) at a small size: `fused_multi_head_attention` (4 x
    128, embed 256, 4 heads of 64, a padding mask, post-LN) through the
    kernels against the same function through flash's plain version on
    the card, out and the gradients of x, the qkv and output weights
    (1e-5 relative in f32, 2e-2 in bf16); at dropout 0.1 under one seed
    the same values, from one mask + dropout launch each way."""
    from paddle_tpu_torch.incubate.nn.functional import \
        fused_multi_head_attention
    from paddle_tpu_torch.ops import common_nn

    B, S, E, Hn = 4, 128, 256, 4
    g = torch.Generator(device=dev).manual_seed(1)
    real = torch.arange(S, device=dev)[None] < torch.tensor(
        [128, 100, 64, 77], device=dev)[:, None]
    args = dict(
        x=torch.randn((B, S, E), generator=g, device=dev),
        qkv_weight=torch.randn((3, Hn, E // Hn, E), generator=g,
                               device=dev) * E ** -0.5,
        linear_weight=torch.randn((E, E), generator=g, device=dev)
        * E ** -0.5,
        qkv_bias=torch.randn((3, Hn, E // Hn), generator=g, device=dev)
        * 0.1)
    args = {k: t.to(dtype) for k, t in args.items()}
    mask = torch.where(real, 0.0, -1e4)[:, None, None]
    do = torch.randn((B, S, E), generator=g, device=dev).to(dtype)

    def run(p):
        ts = {k: t.detach().requires_grad_() for k, t in args.items()}
        torch.manual_seed(5)
        out = fused_multi_head_attention(
            **ts, attn_mask=mask, dropout_rate=p, attn_dropout_rate=p)
        out.backward(do)
        return dict(out=out.detach(), **{k: t.grad for k, t in ts.items()})

    for p in (0.0, 0.1):
        for f in (fa.flash_attention_fwd, fa.flash_attention_bwd):
            f.launches = f.mask_launches = f.dropout_launches = 0
        got = run(p)
        launches = [(f.launches, f.mask_launches, f.dropout_launches)
                    for f in (fa.flash_attention_fwd,
                              fa.flash_attention_bwd)]
        assert launches == [(1, 1, int(p > 0))] * 2, launches
        with monkeypatch.context() as m:
            m.setattr(common_nn, "flash_attention", _plain_attention)
            want = run(p)
        err = {k: _rel(got[k], want[k]) for k in want}
        assert max(err.values()) <= MOE_TOL[dtype], (p, err)
