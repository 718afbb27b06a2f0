"""The port's CUDA kernels on the card, against their plain versions.

These need an NVIDIA GPU and nvcc (the kernels have no CPU mode), so they
carry the `cuda` marker and skip elsewhere. This file imports neither JAX
nor the JAX package, so it runs where only PyTorch is installed (skip
tests/conftest.py, which sets JAX up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
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


@pytest.mark.parametrize("which", [1, 2], ids=["dkv", "dq"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("variant", ["plain", "padding+dropout"])
def test_flash_backward_is_deterministic(dev, which, head_dim, variant):
    """The dK/dV kernel (`which` 1) and the dQ kernel (2) each sum a
    gradient in one fixed order (no atomics): two launches on the same
    inputs give bit-identical results."""
    b, sq, h = 2, 300, 3
    q, k, v, do = _flash_inputs(b, sq, sq, h, head_dim, torch.bfloat16, dev,
                                seed=6)
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
