"""The port's pipeline schedules (parallel/pipeline.py) against the JAX
package's `gpipe`, `one_f_one_b` and `interleaved_one_f_one_b`, on the
CPU.

The port's stages are threads of this process, each a rank of a gloo
mesh (`build_mesh` + `join_group`: the stage lines and the dp lines are
its ``pp`` and ``dp`` groups); the JAX side runs on the 8-fake-device CPU
mesh. Both take the stacked tanh-MLP stages of `tests/
test_pipeline_schedules.py` (M 6 microbatches of 4 rows, width 8) from
the same numpy weights: losses within 1e-5 relative, weight, head and
input gradients within 1e-4 relative (the JAX tests' own tolerances), at
``pp=2`` and ``pp=2 x dp=2``; the interleaved schedule at V 2 and at M 5
(not a multiple of the stages). Also: the forward pipeline alone, the
schedules' stage-to-stage calls against their arithmetic, 1F1B's
in-flight bound (at most ``pp - stage`` microbatches at M 8, where GPipe
holds all 8), and `make_pipeline_loss` training a prologue through the
input gradients.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from paddle_tpu.distributed.mesh import init_mesh as jax_init_mesh
from paddle_tpu.distributed.mesh import set_mesh as jax_set_mesh
from paddle_tpu.parallel import pipeline as jpipe
from paddle_tpu_torch.distributed.mesh import build_mesh
from paddle_tpu_torch.distributed.ranks import join_group
from paddle_tpu_torch.parallel import collectives as coll
from paddle_tpu_torch.parallel import pipeline as pipe_mod
from paddle_tpu_torch.parallel.pipeline import (Pipe, gpipe, gpipe_forward,
                                                interleaved_one_f_one_b,
                                                make_pipeline_loss,
                                                one_f_one_b)
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

M, MB, D = 6, 4, 8


def teardown_module():
    jax_set_mesh(None)


def run_mesh(tmp_path, degrees, fn):
    """`fn(mesh)` on every rank of a CPU gloo mesh of `degrees`, one
    thread a rank (its groups joined); the results in rank order."""
    mesh = build_mesh(degrees, device="cpu", timeout=60)
    store = str(tmp_path / f"store-{threading.get_ident()}-{id(mesh)}")
    out, errs = [None] * mesh.size, []

    def rank(r):
        try:
            m = mesh.for_rank(r)
            m.group = join_group(m, store)
            out[r] = fn(m)
        except BaseException as e:  # noqa: BLE001 — reported below
            errs.append(e)

    threads = [threading.Thread(target=rank, args=(r,))
               for r in range(mesh.size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errs:
        raise errs[0]
    return out


def _stages(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"w": (rs.randn(D, D) * 0.3).astype(np.float32),
             "b": (rs.randn(D) * 0.1).astype(np.float32)} for _ in range(n)]


def _data(seed=0, m=M):
    rs = np.random.RandomState(seed)
    return (rs.randn(M, MB, D).astype(np.float32)[:m],
            rs.randn(M, MB, D).astype(np.float32)[:m])


def _jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_loss(y, lab):
    return jnp.mean((y - lab) ** 2)


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _loss(y, lab):
    return torch.mean((y - lab) ** 2)


def _leaves(p):
    return {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}


def _rows(a, mesh):
    """This rank's dp share of ``[M, MB, ...]`` (the JAX io_spec
    ``P(None, "dp")``)."""
    c, dp = mesh.coords(), mesh.shape["dp"]
    n = a.shape[1] // dp
    return torch.from_numpy(a[:, c["dp"] * n:(c["dp"] + 1) * n].copy())


def _jax_1f1b(stages, x, labs, degrees, loss_fn=_jax_loss, **kw):
    mesh = jax_init_mesh(degrees)
    dp = {} if "dp" not in degrees else dict(
        io_spec=P(None, "dp"), label_spec=P(None, "dp"),
        reduce_axes=("dp",))
    js = jpipe.stack_stage_params([{k: jnp.asarray(v) for k, v in s.items()}
                                   for s in stages])
    return jpipe.one_f_one_b(_jax_stage, loss_fn, js, jnp.asarray(x),
                             jnp.asarray(labs), mesh, **dp, **kw)


@pytest.mark.parametrize("sched", ["1f1b", "gpipe"])
@pytest.mark.parametrize("degrees", [{"pp": 2}, {"pp": 2, "dp": 2}])
def test_schedules_match_jax(tmp_path, sched, degrees):
    stages = _stages(2)
    x, labs = _data()
    loss, grads = _jax_1f1b(stages, x, labs, degrees)
    fn = one_f_one_b if sched == "1f1b" else gpipe

    def rank(mesh):
        pipe = Pipe.of_mesh(mesh)
        p = _leaves(stages[pipe.stage])
        got = fn(_stage, _loss, p, _rows(x, mesh), _rows(labs, mesh), pipe,
                 reduce_groups=(mesh.axis_group("dp"),))
        return pipe.stage, float(got), {k: t.grad.numpy() for k, t in
                                        p.items()}

    for s, got, g in run_mesh(tmp_path, degrees, rank):
        np.testing.assert_allclose(got, float(loss), rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], np.asarray(grads[k])[s],
                                       rtol=1e-4, atol=1e-6)


def test_head_and_input_grads_match_jax(tmp_path):
    """The JAX test's fused head (an extra linear in the last stage's
    loss) and d(loss)/d(microbatches) (tests/test_pipeline_schedules.py:
    81)."""
    stages = _stages(2)
    rs = np.random.RandomState(3)
    head = {"wh": (rs.randn(D, D) * 0.3).astype(np.float32)}
    x, labs = _data(3)
    loss, grads, hgrads, dmbs = _jax_1f1b(
        stages, x, labs, {"pp": 2},
        loss_fn=lambda h, y, lab: _jax_loss(y @ h["wh"], lab),
        head_params={"wh": jnp.asarray(head["wh"])}, return_input_grads=True)

    def rank(mesh):
        pipe = Pipe.of_mesh(mesh)
        p = _leaves(stages[pipe.stage])
        h = _leaves(head)
        got, dx = one_f_one_b(
            _stage, lambda hh, y, lab: _loss(y @ hh["wh"], lab), p,
            torch.from_numpy(x), torch.from_numpy(labs), pipe, head_params=h,
            return_input_grads=True)
        return (pipe.stage, float(got), p["w"].grad.numpy(),
                h["wh"].grad, None if dx is None else dx.numpy())

    out = run_mesh(tmp_path, {"pp": 2}, rank)
    for s, got, gw, gh, dx in out:
        np.testing.assert_allclose(got, float(loss), rtol=1e-5)
        np.testing.assert_allclose(gw, np.asarray(grads["w"])[s],
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out[1][3].numpy(), np.asarray(hgrads["wh"]),
                               rtol=1e-4, atol=1e-6)
    assert out[0][3] is None
    np.testing.assert_allclose(out[0][4], np.asarray(dmbs), rtol=1e-4,
                               atol=1e-6)
    assert out[1][4] is None


@pytest.mark.parametrize("m,degrees", [(M, {"pp": 2, "dp": 2}),
                                       (5, {"pp": 2})])
def test_interleaved_matches_jax(tmp_path, m, degrees):
    """V 2 chunks a stage (tests/test_pipeline_schedules.py:114, :131):
    at M 6 over pp2 x dp2, and at M 5, not a multiple of the stages."""
    vstages = _stages(4, seed=1 if m == M else 2)
    x, labs = _data(1 if m == M else 3, m)
    mesh = jax_init_mesh(degrees)
    dp = {} if "dp" not in degrees else dict(
        io_spec=P(None, "dp"), label_spec=P(None, "dp"),
        reduce_axes=("dp",))
    js = jpipe.stack_interleaved_params(
        [{k: jnp.asarray(v) for k, v in s.items()} for s in vstages], 2)
    loss, grads = jpipe.interleaved_one_f_one_b(
        _jax_stage, _jax_loss, js, jnp.asarray(x), jnp.asarray(labs), mesh,
        n_chunks=2, **dp)

    def rank(mesh):
        pipe = Pipe.of_mesh(mesh)
        chunks = [_leaves(vstages[c * 2 + pipe.stage]) for c in range(2)]
        got = interleaved_one_f_one_b(
            _stage, _loss, chunks, _rows(x, mesh), _rows(labs, mesh), pipe,
            2, reduce_groups=(mesh.axis_group("dp"),))
        return pipe.stage, float(got), [{k: t.grad.numpy() for k, t in
                                         c.items()} for c in chunks]

    for s, got, gs in run_mesh(tmp_path, degrees, rank):
        np.testing.assert_allclose(got, float(loss), rtol=1e-5)
        for c in range(2):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    gs[c][k], np.asarray(grads[k])[s, c], rtol=1e-4,
                    atol=1e-6)


def test_forward_pipeline_matches_sequential_and_jax(tmp_path):
    """The JAX gpipe's own check (tests/test_pipeline_moe.py:21) at pp
    4: the last stage's outputs are the stages run one after another."""
    rs = np.random.RandomState(0)
    ws = [(rs.rand(8, 8) * 0.3).astype(np.float32) for _ in range(4)]
    mbs = rs.rand(3, 2, 8).astype(np.float32)
    want = jpipe.gpipe(lambda p, x: jnp.tanh(x @ p["w"]),
                       jpipe.stack_stage_params([{"w": jnp.asarray(w)}
                                                 for w in ws]),
                       jnp.asarray(mbs), jax_init_mesh({"pp": 4}))

    def rank(mesh):
        pipe = Pipe.of_mesh(mesh)
        w = torch.from_numpy(ws[pipe.stage])
        return gpipe_forward(lambda p, x: torch.tanh(x @ p), w,
                             torch.from_numpy(mbs), pipe)

    out = run_mesh(tmp_path, {"pp": 4}, rank)
    assert out[:3] == [None] * 3
    np.testing.assert_allclose(out[3].numpy(), np.asarray(want), atol=1e-6)


def test_gpipe_gradients_reach_every_stage(tmp_path):
    """The JAX check (tests/test_pipeline_moe.py:45): with the loss
    sum(out**2) every stage's weight gets a gradient, equal to jax.grad
    of the JAX gpipe."""
    rs = np.random.RandomState(0)
    ws = [(rs.rand(4, 4) * 0.3).astype(np.float32) for _ in range(2)]
    mbs = rs.rand(2, 2, 4).astype(np.float32)
    jmesh = jax_init_mesh({"pp": 2})

    def jloss(params):
        out = jpipe.gpipe(lambda p, x: jnp.tanh(x @ p["w"]), params,
                          jnp.asarray(mbs), jmesh)
        return jnp.sum(out ** 2)

    want = jax.grad(jloss)(jpipe.stack_stage_params(
        [{"w": jnp.asarray(w)} for w in ws]))["w"]

    def rank(mesh):
        pipe = Pipe.of_mesh(mesh)
        w = torch.tensor(ws[pipe.stage], requires_grad=True)
        # the mean over 2 microbatches of each one's sum, times 2: the sum
        gpipe(lambda p, x: torch.tanh(x @ p), lambda y, _: 2 * (y ** 2).sum(),
              w, torch.from_numpy(mbs), torch.zeros(2), pipe)
        return pipe.stage, w.grad.numpy()

    for s, g in run_mesh(tmp_path, {"pp": 2}, rank):
        assert np.linalg.norm(g) > 0
        np.testing.assert_allclose(g, np.asarray(want)[s], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("sched", ["1f1b", "gpipe", "interleaved"])
def test_sends_and_receives_a_schedule_makes(tmp_path, sched):
    """Each stage posts one send a microbatch to its next stage (but the
    last) and one back to its previous (but the first), and receives the
    same, in counted calls; one all-reduce of the loss over the line."""
    stages = _stages(4)
    x, labs = _data()
    coll.reset_collective_counts()

    def rank(mesh):
        pipe = Pipe.of_mesh(mesh)
        if sched == "interleaved":
            chunks = [_leaves(stages[c * 2 + pipe.stage]) for c in range(2)]
            interleaved_one_f_one_b(_stage, _loss, chunks,
                                    torch.from_numpy(x),
                                    torch.from_numpy(labs), pipe, 2)
        else:
            fn = one_f_one_b if sched == "1f1b" else gpipe
            fn(_stage, _loss, _leaves(stages[pipe.stage]),
               torch.from_numpy(x), torch.from_numpy(labs), pipe)

    n_stages = 2 if sched == "interleaved" else 4
    run_mesh(tmp_path, {"pp": n_stages}, rank)
    # virtual stages 4 either way: 3 forward and 3 backward hand-offs a
    # microbatch
    got = coll.collective_counts()
    assert got["send"] == got["recv"] == 2 * 3 * M, got
    assert got["all-reduce"] == n_stages, got


@pytest.mark.parametrize("n_mb", [8, 3])
def test_one_f_one_b_holds_at_most_pp_minus_stage(tmp_path, n_mb):
    """At M 8 over 4 stages 1F1B keeps at most ``pp - stage``
    microbatches' graphs (4, 3, 2, 1), whatever M; GPipe keeps all M
    (the JAX memory check, tests/test_pipeline_schedules.py:191)."""
    rs = np.random.RandomState(0)
    x = rs.randn(n_mb, 2, D).astype(np.float32)
    stages = _stages(4)

    def rank(mesh):
        pipe = Pipe.of_mesh(mesh)
        peaks = {}
        for name, fn in (("1f1b", one_f_one_b), ("gpipe", gpipe)):
            fn(_stage, _loss, _leaves(stages[pipe.stage]),
               torch.from_numpy(x), torch.from_numpy(x), pipe)
            peaks[name] = pipe.peak_in_flight
        return pipe.stage, peaks

    for s, peaks in run_mesh(tmp_path, {"pp": 4}, rank):
        assert peaks["1f1b"] == min(4 - s, n_mb), (s, peaks)
        assert peaks["gpipe"] == n_mb, (s, peaks)


def test_schedule_orders_are_what_their_docstrings_say():
    ops = pipe_mod.one_f_one_b_ops(2, 0, 4)
    assert [(k, i) for k, _, i, _ in ops] == [
        ("F", 0), ("F", 1), ("B", 0), ("F", 2), ("B", 1), ("F", 3),
        ("B", 2), ("B", 3)]
    last = pipe_mod.one_f_one_b_ops(2, 1, 4)
    # the last stage receives the next forward's input before posting
    # each backward's gradient
    assert [p for k, _, _, p in last if k == "B"] == [(0, 1), (0, 2),
                                                      (0, 3), None]
    for s in range(2):
        ops = pipe_mod.interleaved_ops(2, s, 5, 2)
        assert sorted((k, c, i) for k, c, i, _ in ops) == sorted(
            (k, c, i) for k in "FB" for c in range(2) for i in range(5))


def test_pipeline_loss_trains_a_prologue(tmp_path):
    """`make_pipeline_loss`: a prologue (a linear layer on the first
    stage) before a 2-stage 1F1B pipeline and a fused head get the
    gradients one process's autograd gives the same composite."""
    stages = _stages(2)
    rs = np.random.RandomState(4)
    w_in = (rs.randn(5, D) * 0.3).astype(np.float32)
    wh = (rs.randn(D, D) * 0.3).astype(np.float32)
    inp = rs.randn(M * MB, 5).astype(np.float32)
    labs = rs.randn(M, MB, D).astype(np.float32)

    def head_loss(h, y, lab):
        return _loss(y @ h["wh"], lab)

    # one process
    pw = torch.tensor(w_in, requires_grad=True)
    ps = [_leaves(s) for s in stages]
    ph = _leaves({"wh": wh})
    h = (torch.from_numpy(inp) @ pw).reshape(M, MB, D)
    total = 0
    for i in range(M):
        y = h[i]
        for p in ps:
            y = _stage(p, y)
        total = total + head_loss(ph, y, torch.from_numpy(labs[i]))
    (total / M).backward()

    def rank(mesh):
        pipe = Pipe.of_mesh(mesh)
        p = _leaves(stages[pipe.stage])
        w = torch.tensor(w_in, requires_grad=True)
        hp = _leaves({"wh": wh}) if pipe.stage == 1 else None
        x = ((torch.from_numpy(inp) @ w).reshape(M, MB, D)
             if pipe.stage == 0 else torch.zeros(M, MB, D))
        ploss = make_pipeline_loss(_stage, head_loss, pipe, "1f1b")
        loss = ploss(p, hp, x, torch.from_numpy(labs))
        loss.backward()
        return (pipe.stage, float(loss.detach()), p["w"].grad, w.grad,
                None if hp is None else hp["wh"].grad)

    out = run_mesh(tmp_path, {"pp": 2}, rank)
    for s, loss, gw, _, _ in out:
        np.testing.assert_allclose(loss, float(total / M), rtol=1e-5)
        torch.testing.assert_close(gw, ps[s]["w"].grad, rtol=1e-4,
                                   atol=1e-6)
    torch.testing.assert_close(out[0][3], pw.grad, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(out[1][4], ph["wh"].grad, rtol=1e-4,
                               atol=1e-6)
