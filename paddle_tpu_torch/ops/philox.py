"""The keep bits of attention dropout: Philox4x32-10 on absolute coordinates.

The counterpart of `_tile_keep` (`paddle_tpu/ops/pallas/flash_attention.py`),
which seeds the TPU's own generator once per (batch*head, query tile, key
tile) and so ties its bits to the TPU's tile sizes. The port instead makes
the bits a pure function of where they land:

    bits(seed, bh, i, j) = philox4x32_10(counter=(j >> 2, i, bh, 0),
                                         key=(seed & 0xffffffff, seed >> 32))[j & 3]

with `i` the query position, `j` the key position and ``bh = b * H + h``.
The CUDA kernels of ``csrc/flash_attention.cu`` draw the same bits in any
tiling, and the plain version here replays them, so forward, backward and
the mask gradient all see one dropout mask with nothing stored.

`keep_mask` keeps a probability where ``bits >= threshold(p)``, the JAX
kernel's rule. Everything is plain torch on int64 tensors (the same code on
CPU and CUDA tensors): a 32 x 32-bit product does not fit a signed int64,
so `_mulhilo` splits one factor into 16-bit halves.
"""
from __future__ import annotations

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
ROUNDS = 10
_U32 = 0xFFFFFFFF


def threshold(p):
    """The uint32 keep threshold of drop probability `p`: the JAX kernel's
    ``np.uint32(int(p * float(2**32 - 1)))``, as a Python int."""
    return int(p * float(2 ** 32 - 1)) & _U32


def _mulhilo(a, m):
    """(hi, lo) 32-bit words of a * m, for int64 tensors `a` in [0, 2**32)
    and a 32-bit constant `m`, with no intermediate past 2**49."""
    lo16, hi16 = a & 0xFFFF, a >> 16
    p_lo = lo16 * m                       # < 2**48
    p_hi = hi16 * m                       # < 2**48, weight 2**16
    mid = (p_hi & 0xFFFF) * 65536 + p_lo  # < 2**49
    return (p_hi >> 16) + (mid >> 32), mid & _U32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32 with 10 rounds (Random123's `philox4x32`), elementwise
    over int64 tensors (or ints) holding uint32 values; the key words are
    ints. Returns the four uint32 output words as int64 tensors."""
    dev = next((x.device for x in (c0, c1, c2, c3)
                if isinstance(x, torch.Tensor)), None)
    c = torch.broadcast_tensors(*(torch.as_tensor(x, dtype=torch.int64,
                                                  device=dev)
                                  for x in (c0, c1, c2, c3)))
    c0, c1, c2, c3 = c
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & _U32, (k1 + PHILOX_W1) & _U32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(seed, bh, sq, sk, device=None):
    """The uint32 bits (as int64) of every (bh, query, key) position:
    ``[len(bh), sq, sk]`` for a sequence of batch*head indices `bh`, or
    ``[bh, sq, sk]`` for all of ``range(bh)`` when `bh` is an int."""
    seed = int(seed)
    if seed < 0 or seed >= 2 ** 64:
        raise ValueError(f"dropout seed must be a uint64; got {seed}")
    if isinstance(bh, int):
        bh = torch.arange(bh, device=device)
    bh = torch.as_tensor(bh, dtype=torch.int64, device=device)
    groups = (sk + 3) // 4
    i = torch.arange(sq, dtype=torch.int64, device=bh.device)
    g = torch.arange(groups, dtype=torch.int64, device=bh.device)
    out = philox4x32_10(g[None, None, :], i[None, :, None], bh[:, None, None],
                        0, seed & _U32, seed >> 32)
    # [bh, sq, groups, 4] -> key j = 4 * group + word
    return torch.stack(out, dim=-1).reshape(len(bh), sq, 4 * groups)[..., :sk]


def keep_mask(seed, p, bh, sq, sk, device=None):
    """Bool ``[bh, sq, sk]``: True where the probability is kept (``bits >=
    threshold(p)``), for drop probability `p` (see `dropout_bits`)."""
    return dropout_bits(seed, bh, sq, sk, device) >= threshold(p)
