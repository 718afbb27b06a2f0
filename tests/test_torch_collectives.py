"""The port's tensor-parallel collectives (paddle_tpu_torch/parallel/
collectives.py) against the JAX package's, on the CPU.

`absmax_quantize` must be bit-equal to the JAX function. The collectives run
over real gloo groups built the way the engine builds them (a process group
straight on a file store under ``tmp_path``, timeout 60 s): one rank a
thread here, each with its own group, joined with a timeout. The JAX side
runs `quantized_allgather_sum` and `quantized_row_parallel` under
`shard_map` on the 8-fake-device CPU mesh with the same numpy inputs.
"""
import datetime
import os
import threading
import uuid

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.parallel import collectives as jcoll
from paddle_tpu.parallel._compat import shard_map
from paddle_tpu.serving.sharded import \
    quantized_row_parallel as jax_quantized_row_parallel
from paddle_tpu_torch.parallel import collectives as coll
from paddle_tpu_torch.serving.sharded import quantized_row_parallel


@pytest.fixture(scope="module", autouse=True)
def shared_cores():
    """Share the machine's cores among pytest-xdist's workers while a
    module runs. torch's default, one intra-op thread a core in every
    worker (and in every rank thread a test starts), puts several threads
    on each core, and small products then wait on each other far longer
    than they compute. The port's test modules import this fixture from
    here (it is autouse); the count goes back when the module ends.
    Spawned rank processes take one thread of their own
    (`distributed.ranks.rank_spec`)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    yield
    torch.set_num_threads(before)


def run_ranks(tmp_path, tp, fn):
    """`fn(group)` on `tp` ranks, one thread each over one gloo group on a
    file store; returns the results in rank order. A rank that raises, or
    does not finish in 60 s, fails the test."""
    import torch.distributed as dist

    store_path = str(tmp_path / f"store-{tp}-{uuid.uuid4().hex}")
    out, errs = [None] * tp, []

    def rank(r):
        try:
            store = dist.FileStore(store_path, tp)
            pg = dist.ProcessGroupGloo(store, r, tp,
                                       datetime.timedelta(seconds=60))
            out[r] = fn(coll.TPGroup(pg, r, tp, "gloo"))
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errs:
        raise errs[0]
    return out


def _jax_mesh(tp):
    return Mesh(np.asarray(jax.devices()[:tp]), ("tp",))


@pytest.mark.parametrize("shape,axis,dtype", [
    ((4, 8), None, np.float32), ((3, 5, 16), None, np.float32),
    ((4, 16), 1, np.float32), ((6, 7), 0, np.float32),
    ((2, 64), None, "bfloat16"), ((5,), None, "zeros")])
def test_absmax_quantize_bit_equal_to_jax(shape, axis, dtype):
    rs = np.random.RandomState(3)
    x = (rs.standard_normal(shape) * 3).astype(np.float32)
    if dtype == "zeros":
        x[:] = 0.0          # the 1e-12 floor of the scale
    if dtype == "bfloat16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    q, sc = coll.absmax_quantize(xt, axis=axis)
    jq, jsc = jcoll.absmax_quantize(xj, axis=axis)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))


@pytest.mark.parametrize("tp", [2, 4])
def test_quantized_allgather_sum_matches_jax(tmp_path, tp):
    rs = np.random.RandomState(tp)
    # each rank's partial at its own scale
    parts = (rs.standard_normal((tp, 3, 24))
             * np.arange(1, tp + 1)[:, None, None]).astype(np.float32)
    got = run_ranks(tmp_path, tp, lambda g: coll.quantized_allgather_sum(
        torch.from_numpy(parts[g.rank]), g).numpy())
    fn = shard_map(lambda p: jcoll.quantized_allgather_sum(p[0], "tp"),
                   mesh=_jax_mesh(tp), in_specs=(P("tp"),), out_specs=P())
    want = np.asarray(fn(jnp.asarray(parts)))
    for r in range(tp):
        # the same int8 payloads and scales; the sum of tp products may
        # round once differently (XLA's dot against torch's tensordot)
        np.testing.assert_allclose(got[r], want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[0], got[-1])    # every rank alike
    # quantized once per rank: within one rounding step of the true sum
    step = np.abs(parts).max(axis=(1, 2)).sum() / 127.0
    assert np.abs(got[0] - parts.sum(0)).max() <= step


@pytest.mark.parametrize("tp", [2, 4])
def test_quantized_row_parallel_matches_jax(tmp_path, tp):
    """A rank holds its ``[out, in / tp]`` slice of the weight and its
    slice of the input; the bias adds after the int8 reduction."""
    rs = np.random.RandomState(10 + tp)
    x = rs.standard_normal((2, 3, 32)).astype(np.float32)
    w = (rs.standard_normal((32, 16)) * 0.2).astype(np.float32)  # [in, out]
    b = rs.standard_normal(16).astype(np.float32)
    n = 32 // tp

    def rank(g):
        sl = slice(g.rank * n, (g.rank + 1) * n)
        wt = torch.from_numpy(np.ascontiguousarray(w[sl].T))   # [out, in/tp]
        return quantized_row_parallel(torch.from_numpy(x[..., sl]), wt,
                                      torch.from_numpy(b), g).numpy()

    got = run_ranks(tmp_path, tp, rank)
    want = np.asarray(jax_quantized_row_parallel(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), _jax_mesh(tp)))
    for r in range(tp):
        np.testing.assert_allclose(got[r], want, rtol=1e-5, atol=1e-5)


def test_collectives_count_one_call_per_rank(tmp_path):
    """Each all-reduce and all-gather adds one to its counter on every
    rank that makes it (here the ranks share one process's counters)."""
    coll.reset_collective_counts()

    def rank(g):
        t = torch.full((3,), float(g.rank + 1))
        coll.all_reduce(t, g)
        gathered = coll.all_gather(torch.tensor([g.rank], dtype=torch.int8),
                                   g)
        return t.tolist(), gathered[:, 0].tolist()

    got = run_ranks(tmp_path, 2, rank)
    assert got == [([3.0] * 3, [0, 1])] * 2
    assert coll.collective_counts() == {"all-reduce": 2, "all-gather": 2,
                                        "reduce-scatter": 0, "all-to-all": 0,
                                        "send": 0, "recv": 0}
    coll.reset_collective_counts()
    assert coll.collective_counts() == {"all-reduce": 0, "all-gather": 0,
                                        "reduce-scatter": 0, "all-to-all": 0,
                                        "send": 0, "recv": 0}


def test_gathered_scales_are_per_rank(tmp_path):
    """The two gathers of the int8 all-reduce: payload [tp, ...] int8 and
    scale [tp] float32, each rank's own."""
    parts = [np.full((2, 4), 1.0, np.float32),
             np.full((2, 4), 254.0, np.float32)]

    def rank(g):
        q, sc = coll.absmax_quantize(torch.from_numpy(parts[g.rank]))
        return (coll.all_gather(q, g).numpy(),
                coll.all_gather(sc.reshape(1), g)[:, 0].numpy())

    (q0, s0), (q1, s1) = run_ranks(tmp_path, 2, rank)
    np.testing.assert_array_equal(q0, q1)
    assert q0.dtype == np.int8 and (q0 == 127).all()
    np.testing.assert_array_equal(s0, np.float32([1.0, 254.0]) / 127.0)


def test_quantized_row_parallel_ignores_tokenless_rows(tmp_path):
    """One scale covers a rank's whole partial, so rows that carry no token
    (padding, idle lanes: the ragged kernel leaves them unwritten) are
    zeroed first: a NaN or a huge value there changes no live row."""
    rs = np.random.RandomState(4)
    x = rs.standard_normal((2, 3, 32)).astype(np.float32)
    w = (rs.standard_normal((16, 32)) * 0.2).astype(np.float32)  # [out, in]
    live = np.array([[True, True, False], [True, False, False]])
    dirty = x.copy()
    dirty[0, 2] = np.nan
    dirty[1, 1] = 1e30

    def rank(g, xs):
        sl = slice(g.rank * 16, (g.rank + 1) * 16)
        return quantized_row_parallel(
            torch.from_numpy(np.ascontiguousarray(xs[..., sl])),
            torch.from_numpy(np.ascontiguousarray(w[:, sl])), None, g,
            live=torch.from_numpy(live)).numpy()

    clean = run_ranks(tmp_path, 2, lambda g: rank(g, x))
    got = run_ranks(tmp_path, 2, lambda g: rank(g, dirty))
    for r in range(2):
        assert np.isfinite(got[r]).all()
        np.testing.assert_array_equal(got[r][live], clean[r][live])
        assert not got[r][~live].any()
