"""The port's pipelined GPT (models/gpt_pipeline.py) against the JAX
package's `make_pipelined_gpt`, on the CPU.

The JAX test's model (tests/test_pipeline_schedules.py:181: vocab 128,
hidden 32, 4 layers, 2 heads, seq 32; batch 8 x 32 in 4 microbatches)
trains 3 SGD steps at lr 0.1 in both packages from the JAX step's own
initial weights (`weights.from_jax_pipeline_params`), over the same
degrees: ``{"pp": 2}`` with GPipe and 1F1B, ``{"pp": 2, "mp": 2}`` with
1F1B. The port's ranks are spawned gloo processes (one mesh of each kind
for the module); the JAX side runs on the 8-fake-device CPU mesh. Held:
losses within 1e-5 relative, every parameter (`to_jax_pipeline_params`)
within 1e-5 of JAX's relative to its norm, the tied embedding's two
copies equal after the steps, and each rank's counted calls a step
against `pipeline_collective_budget`. The interleaved schedule and
``pp=2 x dp=2`` are held against the port's one-stage model.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.distributed.mesh import init_mesh as jax_init_mesh
from paddle_tpu.distributed.mesh import set_mesh as jax_set_mesh
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt_pipeline import make_pipelined_gpt as jax_make
from paddle_tpu_torch.distributed.mesh import build_mesh
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.models.gpt_pipeline import (layer_stack,
                                                  make_pipelined_gpt,
                                                  pipeline_collective_budget,
                                                  stage_stack)
from paddle_tpu_torch.weights import (from_jax_pipeline_params,
                                      to_jax_pipeline_params)
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

CFG = dict(vocab_size=128, hidden_size=32, num_layers=4, num_heads=2,
           max_seq_len=32)
M, STEPS, LR, TIMEOUT = 4, 3, 0.1, 60
KEYS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "send",
        "recv")


@pytest.fixture(scope="module")
def meshes():
    ms = {"pp2": build_mesh({"pp": 2}, device="cpu", timeout=TIMEOUT),
          "pp2mp2": build_mesh({"pp": 2, "mp": 2}, device="cpu",
                               timeout=TIMEOUT),
          "pp2dp2": build_mesh({"pp": 2, "dp": 2}, device="cpu",
                               timeout=TIMEOUT),
          "pp3": build_mesh({"pp": 3}, device="cpu", timeout=TIMEOUT),
          "one": build_mesh({"dp": 1}, device="cpu", timeout=TIMEOUT)}
    yield ms
    for m in ms.values():
        m.close()


def teardown_module():
    jax_set_mesh(None)


def _batch():
    rs = np.random.RandomState(0)
    return (rs.randint(0, 128, (8, 32)).astype(np.int32),
            rs.randint(0, 128, (8, 32)).astype(np.int32))


_JAX = {}


def _jax_run(degrees, sched):
    key = (tuple(sorted(degrees.items())), sched)
    if key not in _JAX:
        params, step = jax_make(JaxGPTConfig(**CFG), jax_init_mesh(degrees),
                                n_microbatches=M, schedule=sched)
        init = _numpy(params)
        ids, labels = (jnp.asarray(a) for a in _batch())
        losses = []
        for _ in range(STEPS):
            loss, params = step(params, ids, labels, jnp.float32(LR))
            losses.append(float(loss))
        _JAX[key] = (init, losses, _numpy(params))
    return _JAX[key]


def _numpy(params):
    return {k: ({n: np.asarray(a) for n, a in v.items()} if k == "blocks"
                else np.asarray(v)) for k, v in params.items()}


def _port(mesh, sched, init, n_chunks=1):
    _, step = make_pipelined_gpt(GPTConfig(**CFG), mesh, M, sched, n_chunks)
    from_jax_pipeline_params(step, init)
    return step


def _leaves(params):
    out = {k: v for k, v in params.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in params["blocks"].items()})
    return out


def _close_params(got, want):
    for k, w in _leaves(want).items():
        g = _leaves(got)[k]
        assert g.shape == w.shape, k
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12)
        assert rel < 1e-5, (k, rel)


@pytest.mark.parametrize("key,degrees,sched", [
    ("pp2", {"pp": 2}, "gpipe"), ("pp2", {"pp": 2}, "1f1b"),
    ("pp2mp2", {"pp": 2, "mp": 2}, "1f1b")])
def test_three_steps_equal_jax(meshes, key, degrees, sched):
    init, want, wparams = _jax_run(degrees, sched)
    step = _port(meshes[key], sched, init)
    try:
        step.rank_reports(zero=True)
        got = [step(*_batch(), LR) for _ in range(STEPS)]
        reports = step.rank_reports()
        params = to_jax_pipeline_params(step)
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    _close_params(params, wparams)
    mesh = meshes[key]
    for r, rep in enumerate(reports):
        budget = pipeline_collective_budget(GPTConfig(**CFG), mesh.shape, M,
                                            mesh.coords(r)["pp"])
        assert {k: rep["collectives"][k] for k in KEYS} == {
            k: STEPS * budget[k] for k in KEYS}, (r, rep["collectives"])


def test_the_tied_embedding_copies_stay_equal(meshes):
    """The first stage's wte (the embedding) and the last stage's (the
    head) take the sum of both uses' gradients, so after training they
    are still one weight."""
    init, _, _ = _jax_run({"pp": 2}, "1f1b")
    step = _port(meshes["pp2"], "1f1b", init)
    try:
        for _ in range(2):
            step(*_batch(), LR)
        by_rank = step._call("collect")[0]
    finally:
        step.close()
    np.testing.assert_array_equal(by_rank[0][("wte",)].numpy(),
                                  by_rank[1][("wte",)].numpy())
    assert not np.array_equal(by_rank[0][("wte",)].numpy(), init["wte"])


@pytest.mark.parametrize("key,sched,n_chunks", [
    ("pp2", "interleaved", 2), ("pp2dp2", "1f1b", 1)])
def test_interleaved_and_dp_equal_one_stage(meshes, key, sched, n_chunks):
    """The interleaved schedule (V 2 chunks a stage) and 1F1B over pp2 x
    dp2 train as the one-stage model on one rank does: losses within 1e-5
    relative, parameters within 1e-5 relative to their norms."""
    init, _, _ = _jax_run({"pp": 2}, "gpipe")
    layers = layer_stack({k: np.asarray(v) for k, v in
                          init["blocks"].items()})
    one = dict(init, blocks=stage_stack(layers, 1))
    ref = _port(meshes["one"], "gpipe", one)
    try:
        want = [ref(*_batch(), LR) for _ in range(STEPS)]
        wparams = to_jax_pipeline_params(ref)
    finally:
        ref.close()
    mine = dict(init, blocks=stage_stack(layers, 2, n_chunks))
    step = _port(meshes[key], sched, mine, n_chunks)
    try:
        got = [step(*_batch(), LR) for _ in range(STEPS)]
        params = to_jax_pipeline_params(step)
        flights = [r["peak_in_flight"] for r in step.last_step]
    finally:
        step.close()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    params["blocks"] = {k: v.numpy() for k, v in stage_stack(
        layer_stack(params["blocks"], n_chunks), 1).items()}
    _close_params(params, wparams)
    if sched == "1f1b":
        assert flights == [2, 1, 2, 1], flights   # pp - stage, rank order


def test_three_stages_tie_the_embedding_over_the_end_ranks(meshes):
    """Over three stages the tied embedding's two copies (stage 0 and
    stage 2) sum their gradients over the line's end ranks alone (the
    mesh's "pp_ends" group; the middle stage holds no copy): 6 layers
    train as on one rank."""
    cfg = GPTConfig(**dict(CFG, num_layers=6))
    from paddle_tpu_torch.models.gpt_pipeline import init_params

    one = init_params(cfg, 1, seed=3, device="cpu")
    layers = layer_stack(one["blocks"])

    def run(mesh, pp):
        _, step = make_pipelined_gpt(cfg, mesh, M, "1f1b", params=dict(
            one, blocks=stage_stack(layers, pp)))
        try:
            step.rank_reports(zero=True)
            return ([step(*_batch(), LR) for _ in range(STEPS)],
                    step.gather_params(), step.collective_counts())
        finally:
            step.close()

    want, wparams, _ = run(meshes["one"], 1)
    got, params, counts = run(meshes["pp3"], 3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(params["wte"].numpy(),
                               wparams["wte"].numpy(), rtol=1e-5, atol=1e-7)
    # the loss over the line a step on every stage, the tie on the ends
    assert [c["all-reduce"] for c in counts] == [2 * STEPS, STEPS,
                                                 2 * STEPS]


def test_stage_layout_is_the_jax_stacking():
    """`stage_stack` lays layers out as the JAX `stack_stage_params` and
    `stack_interleaved_params` do: entry [s] holds stage s's layers, entry
    [s, c] virtual stage c * pp + s."""
    from paddle_tpu.parallel import pipeline as jpipe

    rs = np.random.RandomState(0)
    layers = {"w": rs.randn(8, 3).astype(np.float32)}
    for n_chunks in (1, 2):
        K = 8 // (2 * n_chunks)
        virtual = [{"w": layers["w"][g * K:(g + 1) * K]}
                   for g in range(2 * n_chunks)]
        want = (jpipe.stack_interleaved_params(virtual, 2) if n_chunks > 1
                else jpipe.stack_stage_params(virtual))["w"]
        got = stage_stack(layers, 2, n_chunks)["w"].numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
        back = layer_stack(stage_stack(layers, 2, n_chunks), n_chunks)
        np.testing.assert_array_equal(back["w"].numpy(), layers["w"])


def test_budget_arithmetic():
    cfg = GPTConfig(**CFG)
    b = pipeline_collective_budget(cfg, {"pp": 2, "mp": 2, "dp": 1}, 4, 0)
    # 2 layers a stage x 4 microbatches x 4 mp calls, the loss, the tie
    assert b["all-reduce"] == 32 + 1 + 1
    assert b["send"] == b["recv"] == 4
    mid = pipeline_collective_budget(
        GPTConfig(**dict(CFG, num_layers=6)), {"pp": 3, "mp": 1, "dp": 1},
        4, 1)
    assert mid["all-reduce"] == 1 and mid["send"] == 8
