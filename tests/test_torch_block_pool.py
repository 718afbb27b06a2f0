"""The port's block pool against the JAX package's: digests, scatter
targets, the in-place arena scatter, and the same allocator operation
sequence on both pools."""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import block_pool as jbp
from paddle_tpu_torch.serving import block_pool as tbp
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

L, H, N, BS, D = 2, 3, 10, 4, 8


@pytest.mark.parametrize("salt", [None, "adapter-a"])
@pytest.mark.parametrize("n_tokens", [0, 3, 4, 17, 64])
def test_chain_block_hashes_are_byte_equal(salt, n_tokens):
    toks = np.random.RandomState(n_tokens).randint(0, 50304,
                                                   n_tokens).tolist()
    assert (tbp.chain_block_hashes(toks, BS, salt=salt)
            == jbp.chain_block_hashes(toks, BS, salt=salt))
    assert tbp.blocks_for(n_tokens, BS) == jbp.blocks_for(n_tokens, BS)


def _pools():
    return (jbp.BlockPool(N, L, BS, H, D),
            tbp.BlockPool(N, L, BS, H, D, device="cpu"))


@pytest.mark.parametrize("blocks,start,count,width", [
    ([3], 0, 1, 1), ([3, 7], 2, 5, 8), ([3, 7, 2], 5, 3, 5),
    ([4, 1], 7, 1, 4), ([9], 0, 4, 6),
])
def test_positions_to_slots_match(blocks, start, count, width):
    jp, tp = _pools()
    for a, b in zip(tp.positions_to_slots(blocks, start, count, width),
                    jp.positions_to_slots(blocks, start, count, width)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tp.table_for(blocks, 6),
                                  jp.table_for(blocks, 6))


def test_advanced_indexing_layout_is_pinned():
    """Torch applies the integer layer before the advanced indices, so
    ``arena[layer, :, slots, offs]`` is [H, B, S, D]; numpy (and JAX)
    broadcast the separated advanced indices to the front, [B, S, H, D].
    `scatter_kv` is written for torch's layout."""
    arena = torch.zeros(L, H, N, BS, D)
    slots = torch.zeros((2, 5), dtype=torch.int32)
    offs = torch.zeros((2, 5), dtype=torch.int32)
    assert arena[1, :, slots, offs].shape == (H, 2, 5, D)
    assert arena[1][:, slots, offs].shape == (H, 2, 5, D)
    assert np.zeros(arena.shape)[1, :, slots.numpy(),
                                 offs.numpy()].shape == (2, 5, H, D)
    # a one-element index tensor for the layer gives numpy's layout
    layer_t = torch.tensor([1])
    assert arena[layer_t, :, slots, offs].shape == (2, 5, H, D)


def test_scatter_kv_writes_in_place_like_numpy():
    rs = np.random.RandomState(0)
    arena_np = rs.randn(L, H, N, BS, D).astype(np.float32)
    arena = torch.from_numpy(arena_np.copy())
    ptr = arena.data_ptr()
    _, tp = _pools()
    slots, offs = zip(*(tp.positions_to_slots(b, s, c, 6) for b, s, c in
                        [([3, 5], 2, 6), ([7], 1, 2), ([9, 2], 3, 4)]))
    slots, offs = np.stack(slots), np.stack(offs)
    new = rs.randn(3, 6, H, D).astype(np.float32)
    # padded positions all land on (null block, 0): keep one writer there
    # so the expected value is well defined
    new[:, :, :, :] = np.where((slots == 0)[..., None, None], 0.0, new)
    tbp.scatter_kv(arena, 1, torch.from_numpy(slots), torch.from_numpy(offs),
                   torch.from_numpy(new))
    arena_np[1, :, slots, offs] = new
    assert arena.data_ptr() == ptr
    np.testing.assert_array_equal(arena.numpy(), arena_np)


def _state(p):
    return (p.num_free, p.num_truly_free, p.num_cached_blocks,
            dict(p._refcount), dict(p._hash_index), list(p._cached),
            sorted(p._free))


def test_allocator_sequence_matches_jax_pool():
    jp, tp = _pools()
    h = [bytes([i]) * 32 for i in range(8)]
    ops = [
        ("allocate", (3,)), ("allocate", (2,)),
        ("release", ([1, 2], [h[0], h[1]])),     # publish two blocks
        ("match_prefix", ([h[0], h[1], h[2]],)),  # pin both back
        ("release", ([1], [h[0]])),
        ("allocate", (4,)),
        ("allocate", (1, False)),                 # truly-free only
        ("release", ([3, 4, 5], [h[3], h[4], None])),
        ("allocate", (5,)),                       # evicts cached LRU-first
        ("match_prefix", ([h[4], h[0]],)),
        ("allocate", (20,)),                      # too many: None
    ]
    for name, args in ops:
        assert getattr(tp, name)(*args) == getattr(jp, name)(*args), name
        assert _state(tp) == _state(jp), name
    assert tp.evictions == jp.evictions
    with pytest.raises(ValueError, match="null block"):
        tp.release([0])
    _, fresh = _pools()
    (b,) = fresh.allocate(1)
    fresh.release([b])
    with pytest.raises(ValueError, match="double free"):
        fresh.release([b])


def test_copy_on_write_matches_jax_pool():
    jp, tp = _pools()
    rs = np.random.RandomState(1)
    k = rs.randn(L, H, N, BS, D).astype(np.float32)
    v = rs.randn(L, H, N, BS, D).astype(np.float32)
    import jax.numpy as jnp

    jp.k, jp.v = jnp.asarray(k), jnp.asarray(v)
    tp.k.copy_(torch.from_numpy(k))
    tp.v.copy_(torch.from_numpy(v))
    ptr = tp.k.data_ptr()
    for src, dst in [([2], [5]), ([1, 3], [7, 8])]:
        jp.copy_blocks(src, dst)
        tp.copy_blocks(src, dst)
        np.testing.assert_array_equal(tp.k.numpy(), np.asarray(jp.k))
        np.testing.assert_array_equal(tp.v.numpy(), np.asarray(jp.v))
    assert tp.k.data_ptr() == ptr
    assert tp.bytes_per_block() == jp.bytes_per_block()


def test_paged_attention_appends_then_attends():
    """`paged_attention` scatters the step's K/V into the arena and its
    output equals the plain reference over the updated arena."""
    from paddle_tpu_torch.ops.paged_attention import paged_attention_ref

    rs = np.random.RandomState(2)
    _, tp = _pools()
    tp.k.normal_(generator=torch.Generator().manual_seed(0))
    tp.v.normal_(generator=torch.Generator().manual_seed(1))
    blocks, start, count, W = [4, 6], 3, 3, 4
    slots, offs = tp.positions_to_slots(blocks, start, count, W)
    qpos = np.zeros((1, W), np.int32)
    qpos[0, :count] = np.arange(start, start + count)
    q, kn, vn = (torch.from_numpy(rs.randn(1, W, H, D).astype(np.float32))
                 for _ in range(3))
    st = tbp.PagedState(
        tp.k, tp.v, torch.from_numpy(tp.table_for(blocks, 3)[None]),
        torch.from_numpy(slots[None]), torch.from_numpy(offs[None]),
        torch.from_numpy(qpos), q_start=torch.tensor([start]),
        kv_live=torch.tensor([2]), q_lens=torch.tensor([count]))
    out = tbp.paged_attention(q, kn, vn, st.layer(1))
    torch.testing.assert_close(tp.k[1, :, 4, 3], kn[0, 0])
    torch.testing.assert_close(tp.v[1, :, 6, 1], vn[0, 2])
    want = paged_attention_ref(q, tp.k, tp.v, 1, st.block_tables,
                               st.qpos)
    torch.testing.assert_close(out[:, :count], want[:, :count], atol=0,
                               rtol=0)
