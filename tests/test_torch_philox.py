"""The port's dropout keep bits (`paddle_tpu_torch/ops/philox.py`).

Philox4x32-10 is pinned to Random123's known-answer vectors; the keep bits
are a pure function of (seed, batch*head, query, key), so any tiling of the
score matrix draws the same ones (the CUDA kernels' 64 x 64 tiles, the
plain version's whole matrix); the keep rule is the JAX kernel's
threshold, and the keep share is 1 - p.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import philox


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's kat_vectors for philox4x32_10 (zero, all-ones, pi)."""
    got = philox.philox4x32_10(*counter, *key)
    assert tuple(int(w) for w in got) == want


def test_philox_is_elementwise_over_tensors():
    c0 = torch.tensor([0, 0xFFFFFFFF, 0x243F6A88])
    c1 = torch.tensor([0, 0xFFFFFFFF, 0x85A308D3])
    one = [philox.philox4x32_10(int(a), int(b), 7, 0, 11, 13)
           for a, b in zip(c0, c1)]
    many = philox.philox4x32_10(c0, c1, 7, 0, 11, 13)
    for i, words in enumerate(one):
        assert [int(w) for w in words] == [int(m[i]) for m in many]


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_keep_share_is_one_minus_p(p):
    """Over 2**20 (query, key) pairs the kept share lies within 6 sigma of
    1 - p (sigma = sqrt(p (1 - p) / n), a binomial's spread)."""
    keep = philox.keep_mask(seed=2024, p=p, bh=4, sq=512, sk=512)
    n = keep.numel()
    assert n >= 2 ** 20
    share = keep.double().mean().item()
    assert abs(share - (1 - p)) <= 6 * np.sqrt(p * (1 - p) / n), share


def _bits_one_by_one(seed, bh, i, j):
    """bits(seed, bh, i, j) straight from the definition, per element:
    philox(counter=(j >> 2, i, bh, 0), key=(seed lo, seed hi))[j & 3]."""
    words = philox.philox4x32_10(j >> 2, i, bh, 0, seed & 0xFFFFFFFF,
                                 seed >> 32)
    return torch.stack(words, -1).gather(-1, (j & 3)[..., None])[..., 0]


@pytest.mark.parametrize("seed", [0, 77, 2 ** 40 + 5])
def test_bits_depend_only_on_coordinates(seed):
    """The whole-matrix bits equal the definition evaluated element by
    element, and any tile of them (odd offsets and sizes, a key range not
    on a multiple of 4) equals the same tile drawn alone."""
    full = philox.dropout_bits(seed, 3, 70, 90)
    assert full.shape == (3, 70, 90)
    bh = torch.arange(3)[:, None, None]
    i = torch.arange(70)[None, :, None]
    j = torch.arange(90)[None, None, :]
    bh, i, j = torch.broadcast_tensors(bh, i, j)
    assert torch.equal(full, _bits_one_by_one(seed, bh, i, j))
    for b, i0, j0, n, m in ((1, 5, 13, 17, 31), (2, 64, 64, 6, 26)):
        tile = _bits_one_by_one(
            seed, torch.full((n, m), b), torch.arange(i0, i0 + n)[:, None]
            .expand(n, m), torch.arange(j0, j0 + m)[None].expand(n, m))
        assert torch.equal(full[b, i0:i0 + n, j0:j0 + m], tile)
    # a subset of batch*head rows draws the same bits as the whole
    assert torch.equal(philox.dropout_bits(seed, [2, 0], 70, 90),
                       full[[2, 0]])


def test_seeds_and_heads_give_different_masks():
    base = philox.keep_mask(1, 0.5, 2, 64, 64)
    for other in (philox.keep_mask(2, 0.5, 2, 64, 64),
                  philox.keep_mask(1 + 2 ** 32, 0.5, 2, 64, 64)):
        assert (base != other).float().mean() > 0.4
    assert (base[0] != base[1]).float().mean() > 0.4
    assert torch.equal(base, philox.keep_mask(1, 0.5, 2, 64, 64))


@pytest.mark.parametrize("p", [0.0, 0.1, 0.3, 0.5, 0.9, 1e-9])
def test_threshold_is_the_jax_kernels(p):
    """`threshold(p)` is `_tile_keep`'s ``np.uint32(int(dropout_p *
    float(2**32 - 1)))`` and keep means ``bits >= threshold``."""
    want = int(np.uint32(int(p * float(2 ** 32 - 1))))
    assert philox.threshold(p) == want
    bits = philox.dropout_bits(5, 1, 8, 8)
    t = philox.threshold(p)
    assert torch.equal(philox.keep_mask(5, p, 1, 8, 8), bits >= t)


def test_seed_must_be_a_uint64():
    with pytest.raises(ValueError, match="uint64"):
        philox.dropout_bits(-1, 1, 4, 4)
    with pytest.raises(ValueError, match="uint64"):
        philox.dropout_bits(2 ** 64, 1, 4, 4)
