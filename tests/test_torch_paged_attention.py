"""The port's paged attention against the JAX package's.

`paged_attention_ref` (the plain PyTorch version) is held against the JAX
gather reference `paged_attention_xla` and against the TPU kernel
`_ragged_kernel` run in Pallas interpret mode, on the ragged cases of
tests/test_paged_attention_kernel.py: mixed decode / prefill rows, chunks
crossing block boundaries, a partly filled last block, null-block table
padding and random garbage in every arena slot. The CUDA kernel itself
runs only on the card: tests/test_torch_cuda_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas.paged_attention import (
    paged_attention_xla,
    ragged_paged_attention as jax_ragged_paged_attention,
)
from paddle_tpu_torch.ops import paged_attention as pa
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

REF_TOL = 1e-5      # float32 gather reference vs gather reference
KERNEL_TOL = 1e-3   # the TPU kernel's own acceptance bar vs its reference


def _case(lengths_counts, *, block_size, num_heads=2, head_dim=16,
          num_layers=2, layer=1, seed=0, pad_to=None):
    """Random arena + ragged batch as numpy. `lengths_counts` lists
    (total_tokens, chunk_count): each row's query chunk is the LAST
    `count` positions of its `total` tokens. Garbage everywhere, so
    correctness must come from masking."""
    rs = np.random.RandomState(seed)
    B = len(lengths_counts)
    blocks_per = [max(1, -(-total // block_size))
                  for total, _ in lengths_counts]
    num_blocks = 1 + sum(blocks_per)
    max_blocks = max(blocks_per) + 1  # leave table padding to exercise
    k = rs.randn(num_layers, num_heads, num_blocks, block_size,
                 head_dim).astype(np.float32)
    v = rs.randn(num_layers, num_heads, num_blocks, block_size,
                 head_dim).astype(np.float32)
    tables = np.zeros((B, max_blocks), np.int32)
    nxt = 1
    for i, nb in enumerate(blocks_per):
        tables[i, :nb] = np.arange(nxt, nxt + nb)
        nxt += nb
    S = pad_to or max(c for _, c in lengths_counts)
    q = rs.randn(B, S, num_heads, head_dim).astype(np.float32)
    qpos = np.zeros((B, S), np.int32)
    q_start = np.zeros(B, np.int32)
    kv_live = np.ones(B, np.int32)
    q_lens = np.zeros(B, np.int32)
    for i, (total, count) in enumerate(lengths_counts):
        start = total - count
        qpos[i, :count] = np.arange(start, total)
        q_start[i] = start
        kv_live[i] = (total - 1) // block_size + 1
        q_lens[i] = count
    return dict(q=q, k=k, v=v, layer=layer, tables=tables, qpos=qpos,
                q_start=q_start, kv_live=kv_live, q_lens=q_lens)


def _torch(c, device="cpu", dtype=torch.float32):
    t = {n: torch.from_numpy(c[n]).to(device)
         for n in ("tables", "qpos", "q_start", "kv_live", "q_lens")}
    for n in ("q", "k", "v"):
        t[n] = torch.from_numpy(c[n]).to(device, dtype)
    return t


def _ref(c, t, scale=None):
    return pa.paged_attention_ref(t["q"], t["k"], t["v"], c["layer"],
                                  t["tables"], t["qpos"], scale=scale)


RAGGED = [
    ([(18, 1), (5, 5), (13, 7)], 8),                 # decode, prefill, crossing
    ([(9, 1)], 8),                                   # partial last block
    ([(31, 15), (32, 1), (3, 3), (20, 4)], 4),       # ragged mixed batch
    ([(8, 1), (8, 8), (24, 12), (5, 2)], 16),        # decode + chunks
    ([(17, 17)], 16),                                # one past a boundary
]


@pytest.mark.parametrize("lengths_counts,block_size", RAGGED)
def test_ref_matches_jax_gather_reference(lengths_counts, block_size):
    c = _case(lengths_counts, block_size=block_size)
    want = np.asarray(paged_attention_xla(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        c["layer"], jnp.asarray(c["tables"]), jnp.asarray(c["qpos"])))
    got = _ref(c, _torch(c)).numpy()
    np.testing.assert_allclose(got, want, atol=REF_TOL, rtol=0)


def test_ref_custom_scale_matches_jax():
    c = _case([(13, 7), (4, 1)], block_size=4)
    want = np.asarray(paged_attention_xla(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        c["layer"], jnp.asarray(c["tables"]), jnp.asarray(c["qpos"]),
        scale=0.3))
    got = _ref(c, _torch(c), scale=0.3).numpy()
    np.testing.assert_allclose(got, want, atol=REF_TOL, rtol=0)


@pytest.mark.parametrize("lengths_counts,block_size,pad_to", [
    ([(18, 1), (5, 5), (13, 7)], 8, None),
    ([(9, 1)], 8, None),
    ([(18, 1), (5, 5), (16, 16)], 8, 16),   # ragged q_lens, two q tiles
    ([(9, 1), (23, 1)], 8, 8),              # decode rows in a wide launch
])
def test_ref_matches_jax_interpret_kernel(lengths_counts, block_size, pad_to):
    c = _case(lengths_counts, block_size=block_size, pad_to=pad_to)
    out_k = np.asarray(jax_ragged_paged_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        c["layer"], jnp.asarray(c["tables"]), jnp.asarray(c["q_start"]),
        jnp.asarray(c["kv_live"]), q_lens=jnp.asarray(c["q_lens"]),
        interpret=True))
    got = _ref(c, _torch(c)).numpy()
    for i, (_, count) in enumerate(lengths_counts):
        err = np.abs(got[i, :count] - out_k[i, :count]).max()
        assert err < KERNEL_TOL, f"row {i} (count {count}): max err {err}"


def test_dispatch_on_cpu_takes_the_plain_version(monkeypatch):
    c = _case([(18, 1), (5, 5), (13, 7)], block_size=8)
    t = _torch(c)

    def no_kernel(*a, **kw):
        raise AssertionError("the CUDA kernel was called for a CPU tensor")

    monkeypatch.setattr(pa, "ragged_paged_attention", no_kernel)
    got = pa.paged_attention_arrays(
        t["q"], t["k"], t["v"], c["layer"], t["tables"], t["qpos"],
        q_start=t["q_start"], kv_live=t["kv_live"], q_lens=t["q_lens"])
    torch.testing.assert_close(got, _ref(c, t), atol=0, rtol=0)


def test_kernel_wrapper_raises_on_cpu_tensors():
    c = _case([(9, 1)], block_size=8)
    t = _torch(c)
    before = pa.ragged_paged_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        pa.ragged_paged_attention(t["q"], t["k"], t["v"], c["layer"],
                                  t["tables"], t["q_start"], t["kv_live"],
                                  q_lens=t["q_lens"])
    assert pa.ragged_paged_attention.launches == before


def test_dispatch_raises_on_other_devices():
    q = torch.empty((1, 1, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no paged attention"):
        pa.paged_attention_arrays(q, q, q, 0, q, q)


@pytest.mark.parametrize("dtype,head_dim,block_size,want", [
    (torch.bfloat16, 128, 16, "sm90"),   # the serving shape (gpt_1p3b)
    (torch.bfloat16, 128, 32, "sm90"),
    (torch.bfloat16, 128, 64, "sm90"),
    (torch.bfloat16, 128, 128, "sm90"),
    (torch.float32, 128, 16, "simt"),    # the card-vs-CPU parity path
    (torch.bfloat16, 64, 16, "simt"),
    (torch.bfloat16, 32, 16, "simt"),
    (torch.bfloat16, 128, 8, "simt"),
    (torch.bfloat16, 128, 4, "simt"),
    (torch.bfloat16, 128, 1, "simt"),
])
def test_kernel_design_is_chosen_by_shape(dtype, head_dim, block_size, want):
    assert pa.kernel_design(dtype, head_dim, block_size) == want


def test_serving_shape_takes_the_sm90_design():
    """gpt_1p3b (hidden 2048, 16 heads) in bf16 behind the engine's default
    block size takes the sm_90a design, over either arena (the design does
    not depend on the arena's dtype)."""
    import inspect

    from paddle_tpu_torch.serving import LLMEngine

    block_size = inspect.signature(LLMEngine).parameters["block_size"]
    assert pa.kernel_design(torch.bfloat16, 2048 // 16,
                            block_size.default) == "sm90"
