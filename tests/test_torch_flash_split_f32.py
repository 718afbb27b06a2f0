"""The float32 flash kernels' split-precision arithmetic, on the CPU.

The card's float32 forward, dK/dV and dQ kernels (`flash_fwd_f32`,
`flash_dkv_f32`, `flash_dq_f32` in
``paddle_tpu_torch/csrc/flash_attention.cu``) run every product on the
tensor cores in 3xTF32: each f32 operand x is hi + lo, hi = x rounded to
TF32 (to nearest, ties away from zero) and lo = x - hi, of which the
tensor core reads the top 19 bits; each product is lo_a hi_b + hi_a lo_b
+ hi_a hi_b. The tensor core adds into its f32 accumulator rounding
toward zero, so the kernels keep every chain of k-steps short (four
k-steps, 32 of the depth) and add the chains up in f32.

Here that arithmetic is emulated: the TF32 roundings by bit arithmetic, an
mma step as its exact sum (float64) rounded toward zero. The backward's
five products (S, dP, dV, dK, dQ) run through it at a small size, and the
gradients are held to the kernels' 2e-5 gate against float64 autograd,
which one TF32 pass misses; one long chain a product drifts further than
the short ones. The forward runs as its kernel does: 64-key tiles, each
warp's half of 32 keys with its own online softmax (S in four-k-step
chains, P V one chain of four k-steps added after the alpha rescale), the
halves merged at the end; its O and LSE hold 2e-5 against float64 and
against the JAX package's `_attention_xla`, causal and with a padding
mask. The helpers live in this test: the port's plain version
(`attention_ref`) stays in full f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from paddle_tpu.ops.pallas.flash_attention import _attention_xla
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

GATE = 2e-5  # the f32 kernels' error bound against the plain version
S, B_H = 256, 2  # sequence, batch * heads


def tf32(x):
    """x rounded to TF32 (10 mantissa bits): round to nearest on the low
    13 bits of the f32 pattern, ties away from zero (adding half an ulp to
    the magnitude bits works for either sign)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x):
    """What the tensor core reads of an f32 register: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32_truncated(x - hi)


def _round_toward_zero(x):
    """float64 -> float32, rounding toward zero."""
    y = x.to(torch.float32)
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def mm_chains(a, b, chain):
    """a @ b as the kernels compute it: per k-step of 8, three mma
    (lo hi, hi lo, hi hi), each adding its exact sum into the running f32
    accumulator rounded toward zero; every `chain` k-steps the accumulator
    is added into the result in f32 and starts again from 0."""
    (ahi, alo), (bhi, blo) = split(a), split(b)
    passes = [(alo, bhi), (ahi, blo), (ahi, bhi)]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    acc = torch.zeros_like(out)
    for i, k in enumerate(range(0, a.shape[-1], 8)):
        for x, y in passes:
            acc = _round_toward_zero(
                acc.double() + x[..., k:k + 8].double() @ y[..., k:k + 8, :]
                .double())
        if (i + 1) % chain == 0 or k + 8 >= a.shape[-1]:
            out, acc = out + acc, torch.zeros_like(acc)
    return out


def _inputs(d, seed):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.standard_normal((B_H, S, d)).astype(
        np.float32)) for _ in range(4)]


def _reference(q, k, v, do, causal):
    """Float64 autograd of softmax(Q K^T / sqrt(D)) V; also its LSE and
    delta = rowsum(dO * O), which the kernels take from the forward."""
    q, k, v = (t.double().requires_grad_() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                          float("-inf"))
    o = torch.softmax(s, -1) @ v
    o.backward(do.double())
    lse = torch.logsumexp(s.detach(), -1, keepdim=True)
    delta = (do.double() * o.detach()).sum(-1, keepdim=True)
    return lse, delta, q.grad, k.grad, v.grad


def _backward(q, k, v, do, lse, delta, causal, mm):
    """The kernels' backward in f32, every product through `mm(a, b,
    chain)` with the kernels' chains of four k-steps: P recomputed from S
    and the LSE, dV = P^T dO, dP = dO V^T, dS = P (dP - delta) / sqrt(D),
    dK = dS^T Q, dQ = dS K."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(mm(q, k.transpose(-1, -2), 4) * scale - lse.float())
    if causal:
        p = p.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), 0.0)
    dv = mm(p.transpose(-1, -2), do, 4)
    ds = p * (mm(do, v.transpose(-1, -2), 4) - delta.float()) * scale
    return mm(ds, k, 4), mm(ds.transpose(-1, -2), q, 4), dv


def _errors(mm, causal, d, seed=0):
    q, k, v, do = _inputs(d, seed)
    lse, delta, *want = _reference(q, k, v, do, causal)
    got = _backward(q, k, v, do, lse, delta, causal, mm)
    return [(g.double() - w).abs().max().item() for g, w in zip(got, want)]


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10   # TF32's spacing at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 * 0.99,
                      1 + ulp * 1.5, 3.0, 0.0], dtype=torch.float32)
    assert tf32(x).tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0,
                                0.0]
    assert tf32_truncated(x).tolist() == [1.0, -1.0, 1.0, 1 + ulp, 3.0, 0.0]


def test_split_keeps_all_but_two_to_the_minus_21():
    x = torch.from_numpy(np.random.RandomState(1).standard_normal(4096)
                         .astype(np.float32)) * 100
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    rem = (x.double() - hi.double() - lo.double()).abs()
    assert (rem <= 2.0 ** -21 * x.double().abs()).all()


def test_round_toward_zero():
    x = torch.tensor([1 + 2.0 ** -30, -(1 + 2.0 ** -30), 1 - 2.0 ** -30],
                     dtype=torch.float64)
    assert _round_toward_zero(x).tolist() == [1.0, -1.0,
                                              float(np.nextafter(
                                                  np.float32(1), 0))]


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_backward_holds_the_f32_gate(causal, head_dim):
    """dQ, dK, dV with all five products in 3xTF32, short chains rounded
    toward zero, stay within 2e-5 of float64, as plain f32 products do."""
    split_err = _errors(mm_chains, causal, head_dim)
    f32_err = _errors(lambda a, b, chain: a @ b, causal, head_dim)
    assert max(split_err) < GATE, split_err
    assert max(f32_err) < GATE, f32_err


def test_one_chain_a_product_drifts():
    """The same products with one chain over the whole depth (what a
    kernel accumulating in place does) drift several times further: the
    rounding toward zero adds up."""
    short = _errors(mm_chains, True, 64)
    long = _errors(lambda a, b, chain: mm_chains(a, b, 10 ** 9), True, 64)
    assert max(long) > 3 * max(short), (long, short)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_one_tf32_pass_misses_the_gate(head_dim):
    """One TF32 pass (10-bit mantissas) is what the split is for: it
    misses the same gate by orders of magnitude."""
    err = _errors(lambda a, b, chain: tf32(a) @ tf32(b), True, head_dim)
    assert max(err) > 10 * GATE, err


# -- the forward --------------------------------------------------------------

_LOG2E, _NEG = 1.4426950408889634, -1e30


def _forward(q, k, v, causal, mask, mm):
    """The forward kernel's arithmetic in f32 on [BH, Sq, D] / [BH, Sk, D]
    (`mask`: an additive [BH, Sk] f32 key mask or None): key tiles of 64,
    each split into two halves of 32 keys with their own online softmax in
    base 2 (m, l, O); S through `mm(q, k_half^T, 4)`, P V through `mm(p,
    v_half, 4)` (one chain) added into O after the alpha rescale; then the
    halves merged (each scaled by exp2(m_h - m)) and O divided by l.
    Returns (O, LSE)."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    sl2 = torch.tensor(d ** -0.5, dtype=torch.float32) * _LOG2E
    seen = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        seen = seen.tril(sk - sq)
    halves = []
    for h in range(2):
        m = torch.full((q.shape[0], sq, 1), _NEG)
        l = torch.zeros(q.shape[0], sq, 1)
        o = torch.zeros(q.shape[0], sq, d)
        for k0 in range(32 * h, sk, 64):
            cols = slice(k0, min(k0 + 32, sk))
            x = torch.where(seen[:, cols], mm(q, k[:, cols].transpose(-1, -2),
                                              4) * sl2, _NEG)
            if mask is not None:
                x = torch.where(seen[:, cols], torch.clamp(
                    x + mask[:, None, cols] * _LOG2E, min=_NEG), x)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + mm(p, v[:, cols], 4)
            m = m_new
        halves.append((m, l, o))
    (m0, l0, o0), (m1, l1, o1) = halves
    m = torch.maximum(m0, m1)
    f0, f1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
    l = torch.clamp(l0 * f0 + l1 * f1, min=1e-30)
    o = (o0 * f0 + o1 * f1) * (1.0 / l)
    return o, (m * 0.6931471805599453 + torch.log(l))[..., 0]


def _fwd_inputs(d, seed, sq=S, sk=S, b_h=B_H, padding=False):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((b_h, sq, d)).astype(np.float32)
    k, v = (rs.standard_normal((b_h, sk, d)).astype(np.float32)
            for _ in range(2))
    mask = None
    if padding:  # ERNIE's: 0 on each row's real keys, -1e4 on the rest
        lens = rs.randint(sk // 2, sk + 1, b_h)
        mask = np.where(np.arange(sk)[None] < lens[:, None], 0.0,
                        -1e4).astype(np.float32)
    return q, k, v, mask


def _fwd_errors(mm, causal, d, sq=S, sk=S, padding=False):
    """The emulated forward's O and LSE errors against float64."""
    q, k, v, mask = _fwd_inputs(d, 5, sq, sk, padding=padding)
    got = _forward(*(torch.from_numpy(t) for t in (q, k, v)), causal,
                   None if mask is None else torch.from_numpy(mask), mm)
    s = torch.from_numpy(q).double() @ torch.from_numpy(k).double(
    ).transpose(-1, -2) / d ** 0.5
    if causal:
        s = s.masked_fill(~torch.ones(sq, sk, dtype=torch.bool).tril(
            sk - sq), float("-inf"))
    if mask is not None:
        s = s + torch.from_numpy(mask).double()[:, None]
    want = (torch.softmax(s, -1) @ torch.from_numpy(v).double(),
            torch.logsumexp(s, -1))
    return [(g.double() - w).abs().max().item() for g, w in zip(got, want)]


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal,sq,sk,padding", [
    (False, S, S, False), (True, S, S, False), (True, 77, 200, False),
    (False, S, S, True)], ids=["full", "causal", "causal_sq_lt_sk",
                               "padding"])
def test_3xtf32_forward_holds_the_f32_gate(causal, sq, sk, padding,
                                           head_dim):
    """O and LSE with S and P V in 3xTF32, four-k-step chains rounded
    toward zero, the online softmax over 64-key tiles in two halves and
    their merge, stay within 2e-5 of float64, as plain f32 products do."""
    split_err = _fwd_errors(mm_chains, causal, head_dim, sq, sk, padding)
    f32_err = _fwd_errors(lambda a, b, chain: a @ b, causal, head_dim, sq,
                          sk, padding)
    assert max(split_err) < GATE, split_err
    assert max(f32_err) < GATE, f32_err


@pytest.mark.parametrize("head_dim", [64, 128])
def test_one_tf32_pass_misses_the_forward_gate(head_dim):
    """The forward with one TF32 pass a product misses the same gate."""
    err = _fwd_errors(lambda a, b, chain: tf32(a) @ tf32(b), True, head_dim)
    assert max(err) > 10 * GATE, err


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal,padding", [(True, False), (False, True)],
                         ids=["causal", "padding"])
def test_3xtf32_forward_matches_jax_attention(causal, padding, head_dim):
    """The emulated forward against the JAX package's `_attention_xla` on
    the same seeded inputs ([B, S, 1, D], the padding mask as [B, 1, 1, S]):
    within 2e-5."""
    q, k, v, mask = _fwd_inputs(head_dim, 9, padding=padding)
    got, _ = _forward(*(torch.from_numpy(t) for t in (q, k, v)), causal,
                      None if mask is None else torch.from_numpy(mask),
                      mm_chains)
    want = _attention_xla(
        *(jnp.asarray(t[:, :, None]) for t in (q, k, v)),
        mask=None if mask is None else jnp.asarray(mask[:, None, None]),
        causal=causal)
    err = np.abs(got.numpy() - np.asarray(want)[:, :, 0]).max()
    assert err < GATE, err
