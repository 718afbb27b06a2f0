"""Tensor-parallel serving in the port (serving/sharded.py, tp_worker.py)
against the JAX package's, on the CPU.

The port's ``LLMEngine(model, device="cpu", mesh=N)`` serves over N rank
processes (rank 0 is this process; the others are spawned, one intra-op
thread each, over a gloo group on a file store) and the JAX engine over N
of the 8 fake CPU devices. Both get the same weights (`from_jax_state_dict`)
and serve `tests/test_serving_sharded.py`'s mixed wave (chunked prefill,
decode, speculative drafts, prefix-cache hits): greedy tokens must equal
the JAX engine's at the same degree and the one-card engines'. Around that:
the mesh, layout, capacity and topology units of the JAX file, temperature
sampling bit-identical to tp=1, the int8 arena with the EQuARX all-reduce
(`tests/test_int8_kv.py`'s tp case) against the JAX engine, each step's
collective calls on every rank against `serving_collective_budget`, a
rank's failure raising on the controller, and no rank process outliving
`close()`. Every engine this file starts is closed by it.
"""
import asyncio
import functools
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.serving import LLMEngine as JaxLLMEngine
from paddle_tpu.serving import build_serving_mesh as jax_build_serving_mesh
from paddle_tpu.serving import kv_capacity_blocks as jax_kv_capacity_blocks
from paddle_tpu.serving import \
    serving_collective_budget as jax_serving_collective_budget
from paddle_tpu.serving import serving_param_specs as jax_serving_param_specs
import paddle_tpu_torch.serving.sharded as tsharded
from paddle_tpu_torch.models.gpt import GPT, GPTConfig
from paddle_tpu_torch.serving import (EngineSupervisor, LLMEngine,
                                      RankFailed, ServingMesh,
                                      ServingServer, as_serving_mesh,
                                      build_serving_mesh, faults,
                                      kv_capacity_blocks,
                                      serving_collective_budget,
                                      serving_param_specs)
from paddle_tpu_torch.serving.faults import FaultPlan
from paddle_tpu_torch.serving.scheduler import Request
from paddle_tpu_torch.weights import _linear_weights, from_jax_state_dict
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

# every process group a test starts gives up a collective after this many
# seconds: a rank that misses one fails its test instead of hanging the run
TP_TIMEOUT = 60


def cpu_mesh(tp):
    """A `tp`-rank CPU serving mesh whose collectives time out after
    TP_TIMEOUT seconds."""
    return build_serving_mesh(tp, device="cpu", timeout=TP_TIMEOUT)


@pytest.fixture
def tp_timeout(monkeypatch):
    """Meshes built from a degree (``mesh=N``, PADDLE_TPU_TP) time out
    after TP_TIMEOUT seconds, as `cpu_mesh`'s do."""
    monkeypatch.setattr(tsharded, "build_serving_mesh", functools.partial(
        build_serving_mesh, timeout=TP_TIMEOUT))


CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=96)
WAVE = dict(block_size=8, max_batch=4, max_seq_len=96, prefill_chunk=8,
            spec_decoding=True, num_spec_tokens=3)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxGPT(JaxGPTConfig(**CFG, attn_impl="xla", dropout=0.0))
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in state_dict_arrays(jm)[0].items()}
    tm = from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"), arrays)
    return jm, tm


@pytest.fixture(autouse=True)
def _no_env_tp(monkeypatch):
    """A PADDLE_TPU_TP left in the environment must not shard this file's
    one-card reference engines."""
    monkeypatch.delenv("PADDLE_TPU_TP", raising=False)
    monkeypatch.delenv("PADDLE_TPU_QUANT_ALLREDUCE", raising=False)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    plan = faults.active()
    if plan is not None:
        plan.release_hangs()
    faults.clear()


def _wave_prompts(seed=0):
    """The JAX file's mixed wave: two prompts sharing a cached prefix, one
    longer than the prefill chunk, one the n-gram drafter hits."""
    rs = np.random.RandomState(seed)
    shared = rs.randint(0, 128, (24,)).tolist()
    motif = [7, 11, 13]
    return shared, [
        shared + rs.randint(0, 128, (4,)).tolist(),
        shared + rs.randint(0, 128, (6,)).tolist(),
        rs.randint(0, 128, (40,)).tolist(),
        rs.randint(0, 128, (5,)).tolist() + motif * 4,
    ]


def _serve_wave(make, **kw):
    """Warm the prefix cache with the shared prefix, then serve the wave;
    returns (engine, outputs)."""
    shared, prompts = _wave_prompts()
    eng = make(**WAVE, **kw)
    eng.generate([shared], max_new_tokens=2, temperature=0.0)
    return eng, eng.generate(prompts, max_new_tokens=10, temperature=0.0)


def _port(tm):
    def make(mesh=None, **kw):
        if mesh is not None and mesh > 1:
            mesh = cpu_mesh(mesh)
        return LLMEngine(tm, device="cpu", mesh=mesh, **kw)
    return make


def _jax(jm):
    return lambda **kw: JaxLLMEngine(jm, **kw)


def _idle(engine):
    assert engine.pool._refcount == {}
    return engine.pool.num_free == engine.pool.num_blocks - 1


def _closed(engine):
    """Close a tp engine; every rank process has ended, cleanly."""
    procs = list(engine._tp.procs)
    engine.close()
    assert procs and not any(p.is_alive() for p in procs)
    assert [p.exitcode for p in procs] == [0] * len(procs)


@pytest.fixture(scope="module")
def jax_ref(models):
    """The JAX one-card wave: the anchor every engine here must meet."""
    jm, _ = models
    eng, outs = _serve_wave(_jax(jm), mesh=1)
    return eng, outs


@pytest.fixture(scope="module")
def tp2(models):
    _, tm = models
    eng, outs = _serve_wave(_port(tm), mesh=2)
    yield eng, outs
    _closed(eng)


@pytest.fixture(scope="module")
def tp4(models):
    _, tm = models
    eng, outs = _serve_wave(_port(tm), mesh=4)
    yield eng, outs
    _closed(eng)


# -- units: mesh construction, layout, capacity --------------------------------


def test_build_serving_mesh_validation():
    with pytest.raises(ValueError, match="tp_degree >= 2"):
        build_serving_mesh(1)
    with pytest.raises(ValueError, match="devices"):
        build_serving_mesh(4096)
    sm = build_serving_mesh(2, device="cpu")
    assert sm.tp_degree == 2 and sm.device_count == 2
    assert sm.info() == {"tp_degree": 2, "device_count": 2,
                         "backend": "cpu"}
    assert as_serving_mesh(None) is None
    assert as_serving_mesh(sm) is sm
    assert as_serving_mesh(2, device="cpu").tp_degree == 2
    # a degree-1 mesh is the explicit one-card request in every form
    assert as_serving_mesh(1) is None
    assert as_serving_mesh(ServingMesh(["cpu"])) is None


def test_repeated_cuda_device_needs_explicit_gloo():
    """The one departure from the JAX function: one card may hold two
    ranks, over gloo only, and only when asked for by name."""
    with pytest.raises(ValueError, match="backend='gloo'"):
        ServingMesh(["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="backend='gloo'"):
        ServingMesh(["cuda:0", "cuda:0"], backend="nccl")
    sm = ServingMesh(["cuda:0", "cuda:0"], backend="gloo")
    assert sm.info() == {"tp_degree": 2, "device_count": 1,
                         "backend": "cuda-gloo"}
    assert not sm.graphs
    nccl = ServingMesh(["cuda:0", "cuda:1"])
    assert nccl.backend == "nccl" and nccl.graphs
    assert nccl.info()["backend"] == "cuda"
    with pytest.raises(ValueError, match="one\\s+kind"):
        ServingMesh(["cpu", "cuda:0"], backend="gloo")


def test_cuda_mesh_without_cards_raises(models, monkeypatch):
    """A CUDA mesh never quietly becomes a CPU or one-rank engine: without
    the cards it raises, from the mesh and from the engine."""
    _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        build_serving_mesh(2)
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        LLMEngine(tm, mesh=2)


def test_serving_param_specs_layout(models):
    """The JAX layout, each PartitionSpec's 'tp' axis moved to nn.Linear's
    [out, in] layout: heads / FFN columns / vocab rows sharded, norms,
    position embeddings and row-parallel biases replicated."""
    jm, tm = models
    jspecs = jax_serving_param_specs(jm, jax_build_serving_mesh(2))
    specs = serving_param_specs(tm)
    linear = _linear_weights(tm)
    assert set(specs) == set(jspecs)
    for name, spec in jspecs.items():
        axes = list(spec)
        jdim = axes.index("tp") if "tp" in axes else None
        want = jdim
        if jdim is not None and name in linear:
            want = 1 - jdim
        assert specs[name] == want, name
    assert specs["blocks.0.attn.proj.bias"] is None


def test_validate_model_divisibility(models):
    _, tm = models
    with pytest.raises(ValueError, match="num_heads"):
        LLMEngine(tm, device="cpu", mesh=8)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_kv_capacity_blocks_per_shard(tp):
    kw = dict(kv_bytes=1 << 20, num_layers=2, num_heads=8, block_size=16,
              head_dim=32, dtype_itemsize=4)
    assert kv_capacity_blocks(**kw, tp_degree=tp) \
        == jax_kv_capacity_blocks(**kw, tp_degree=tp)
    assert kv_capacity_blocks(**kw, tp_degree=tp, scale_itemsize=4) \
        == jax_kv_capacity_blocks(**kw, tp_degree=tp, scale_itemsize=4)
    assert kv_capacity_blocks(**kw, tp_degree=tp) \
        == tp * kv_capacity_blocks(**kw)


@pytest.mark.parametrize("quant", [(), ("attn_proj",),
                                   ("attn_proj", "ffn_fc2")])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_serving_collective_budget_is_the_jax_arithmetic(tp, quant):
    cfg = GPTConfig(num_layers=24)
    assert serving_collective_budget(cfg, tp, quant) \
        == jax_serving_collective_budget(cfg, tp, quant)


@pytest.fixture(scope="module")
def tp4_budget(models):
    """A tp=4 engine sized by the byte budget a one-card engine cannot
    serve (with the attn_proj all-reduce quantized, for the budget
    test)."""
    _, tm = models
    per_block = 2 * CFG["num_layers"] * CFG["num_heads"] * 8 * 16 * 4
    eng = LLMEngine(tm, device="cpu", block_size=8, max_batch=2,
                    max_seq_len=96, mesh=cpu_mesh(4),
                    kv_hbm_bytes=12 * per_block,
                    quant_allreduce=("attn_proj",))
    yield eng, per_block
    _closed(eng)


def test_kv_hbm_bytes_admission_per_shard(models, tp4_budget):
    """The same per-card budget serves at tp=4 what one card cannot
    hold: the one-card engine fails at construction, the tp=4 engine gets
    4x the blocks and admits a max-length request."""
    _, tm = models
    e4, per_block = tp4_budget
    budget = 12 * per_block
    with pytest.raises(ValueError, match="kv_hbm_bytes"):
        LLMEngine(tm, device="cpu", block_size=8, max_batch=2,
                  max_seq_len=96, kv_hbm_bytes=budget)
    e13 = LLMEngine(tm, device="cpu", block_size=8, max_batch=2,
                    max_seq_len=96, kv_hbm_bytes=13 * per_block)
    assert e13.validate(Request([1] * 46, max_new_tokens=50)) == 12
    assert e4.pool.num_blocks == 4 * 12
    long_req = Request([1] * 40, max_new_tokens=50)
    assert e4.validate(long_req) == e4.pool.blocks_for(89)
    # each rank's arena holds its one head; the logical block all four
    assert tuple(e4.pool.k.shape[:3]) == (2, 1, 48)
    assert e4.pool.bytes_per_block() == per_block


def test_explicit_tp1_beats_env(models, monkeypatch, tp_timeout):
    _, tm = models
    monkeypatch.setenv("PADDLE_TPU_TP", "2")
    assert LLMEngine(tm, device="cpu", block_size=8, mesh=1)._smesh is None
    eng = LLMEngine(tm, device="cpu", block_size=8)
    try:
        assert eng._smesh is not None and eng._smesh.tp_degree == 2
    finally:
        _closed(eng)


# -- the acceptance wave -------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_mixed_wave_token_parity(models, jax_ref, tp2, tp4, tp):
    """tp=2 and tp=4 serves of the mixed wave are greedy token-identical to
    the JAX engine at the same degree, to the JAX one-card engine and to
    the port's one-card engine; one program per width bucket, built
    once; the pool drains; cache and spec counters equal the JAX one-card
    engine's."""
    jm, tm = models
    jref_eng, jref = jax_ref
    eng, outs = {2: tp2, 4: tp4}[tp]
    _, jouts = _serve_wave(_jax(jm), mesh=tp)
    _, ref = _serve_wave(_port(tm))
    assert outs == jouts == jref == ref
    assert set(eng._step_fns) <= {(eng.max_batch, w)
                                  for w in eng.width_buckets}
    assert (int(eng.metrics.counters["jit_traces"]) == len(eng._step_fns)
            <= eng.expected_program_count())
    assert eng.metrics.gauges.get("jit_retraces", 0) == 0
    for name in ("prefix_cache_hit_tokens", "spec_accepted_tokens"):
        assert eng.metrics.counters[name] > 0
        assert eng.metrics.counters[name] == jref_eng.metrics.counters[name]
    assert eng.metrics.counters["host_syncs"] == eng.step_count
    assert _idle(eng)


def test_tp2_temperature_sampling_bit_identical(models):
    """Every rank samples from the same replicated logits with a generator
    seeded alike, so a tp=2 sampled serve draws the one-card tokens."""
    _, tm = models
    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, 128, (n,)).tolist() for n in (6, 11, 17)]
    kw = dict(block_size=8, max_batch=3, max_seq_len=96, prefill_chunk=8,
              seed=123)
    sample = dict(max_new_tokens=12, temperature=0.9, top_k=20, top_p=0.95)
    want = LLMEngine(tm, device="cpu", **kw).generate(prompts, **sample)
    eng = LLMEngine(tm, device="cpu", mesh=cpu_mesh(2), **kw)
    try:
        assert eng.generate(prompts, **sample) == want
        assert _idle(eng)
    finally:
        _closed(eng)


def test_tp2_arena_and_param_placement(models, tp2):
    """Each rank holds its head slab of the arena and its shard of each
    tensor-parallel weight; mesh_info reads as the JAX engine's."""
    _, tm = models
    eng, _ = tp2
    assert tuple(eng.pool.k.shape) == (2, 2, eng.pool.num_blocks, 8, 16)
    own = dict(eng.model.named_parameters())
    assert own["blocks.0.attn.qkv.weight"].shape == (96, 64)
    assert own["blocks.1.fc2.weight"].shape == (64, 128)
    assert own["wte.weight"].shape == (64, 64)
    assert own["blocks.0.ln1.weight"].shape == (64,)
    # rank 0 holds the first head group of the caller's fused QKV
    np.testing.assert_array_equal(
        own["blocks.0.attn.qkv.weight"].numpy(),
        tm.blocks[0].attn.qkv.weight.detach()[:96].numpy())
    assert eng.model.blocks[0].attn.num_heads == 2
    assert eng.mesh_info() == {"tp_degree": 2, "device_count": 2,
                               "backend": "cpu", "kv_dtype": "float32"}
    # the caller's model is not mutated
    assert tm.blocks[0].attn.num_heads == 4
    assert tm.wte.weight.shape == (128, 64)


def test_single_chip_reports_degree_one(jax_ref, models):
    _, tm = models
    eng = LLMEngine(tm, device="cpu", block_size=8)
    assert eng.mesh_info() == {"tp_degree": 1, "device_count": 1,
                               "backend": "cpu", "kv_dtype": "float32"}
    assert eng.metrics.gauges["mesh_tp_degree"] == 1
    assert eng.rank_reports() == []


# -- int8 arena + EQuARX all-reduce --------------------------------------------


@pytest.fixture(scope="module")
def int8q(models):
    _, tm = models
    eng, outs = _serve_wave(_port(tm), mesh=2, kv_dtype="int8",
                            quant_allreduce=True)
    yield eng, outs
    _closed(eng)


def test_int8_kv_tp2_with_quantized_allreduce_matches_jax(models, int8q):
    """tp=2 with both int8 stories on (int8 arena + the EQuARX
    row-parallel all-reduces): the JAX engine's tokens at the same
    configuration."""
    jm, _ = models
    eng, outs = int8q
    jeng, jouts = _serve_wave(_jax(jm), mesh=2, kv_dtype="int8",
                              quant_allreduce=True)
    assert outs == jouts
    assert eng.quant_collectives == jeng.quant_collectives \
        == {"attn_proj", "ffn_fc2"}
    assert eng.mesh_info() == {"tp_degree": 2, "device_count": 2,
                               "backend": "cpu", "kv_dtype": "int8"}
    assert tuple(eng.pool.k_scale.shape) == (2, 2, eng.pool.num_blocks)
    assert _idle(eng)


@pytest.mark.parametrize("case", ["tp2", "tp4", "tp2-int8-q",
                                  "tp4-q-attn_proj"])
def test_collective_calls_per_step_equal_budget(models, tp2, tp4, int8q,
                                                tp4_budget, case):
    """Every rank makes exactly `serving_collective_budget` calls a step:
    2L+1 all-reduces and one all-gather in float32, and each quantized
    projection trades its all-reduce for two all-gathers."""
    eng = {"tp2": tp2, "tp4": tp4, "tp2-int8-q": int8q,
           "tp4-q-attn_proj": tp4_budget}[case][0]
    eng.rank_reports(zero=True)
    steps0 = eng.step_count
    rs = np.random.RandomState(5)
    eng.generate([rs.randint(0, 128, (n,)).tolist() for n in (3, 12)],
                 max_new_tokens=4)
    steps = eng.step_count - steps0
    budget = serving_collective_budget(eng.model.cfg, eng.mesh_info()[
        "tp_degree"], eng.quant_collectives)
    reports = eng.rank_reports()
    assert len(reports) == eng.mesh_info()["tp_degree"]
    assert [r["rank"] for r in reports] == list(range(len(reports)))
    for rep in reports:
        assert rep["collectives"] == {
            k: budget.get(k, 0) * steps for k in rep["collectives"]}, \
            rep["rank"]
        assert set(rep["collectives"]) == {"all-reduce", "all-gather",
                                           "reduce-scatter", "all-to-all",
                                           "send", "recv"}


# -- supervision, the front door, failure and shutdown -------------------------


def test_supervisor_poison_isolation_tp2(jax_ref, tp2):
    """Bisection against a tp=2 engine: a step_raise pinned to one request
    (fired on the controller before any rank is told of the step) aborts
    exactly that request; the others' tokens match the one-card wave."""
    _, ref_outs = jax_ref
    eng, _ = tp2
    shared, prompts = _wave_prompts()
    eng.generate([shared], max_new_tokens=2, temperature=0.0)
    for i, p in enumerate(prompts):
        eng.add_request(p, max_new_tokens=10, request_id=f"r{i}")
    faults.install(FaultPlan([
        {"point": "step_raise", "request_id": "r2", "exc": "ShardBoom"}]))
    sup = EngineSupervisor(eng)
    outs, failures, steps = [], [], 0
    while eng.has_unfinished():
        o, f = sup.step()
        outs += o
        failures += f
        steps += 1
        assert steps < 300, "supervised sharded serve did not converge"
    faults.clear()
    assert [rid for rid, _ in failures] == ["r2"]
    assert "ShardBoom" in failures[0][1]
    got = {}
    for o in outs:
        got.setdefault(o.request_id, []).append(o.token)
    for i in (0, 1, 3):
        assert got[f"r{i}"] == ref_outs[i]
    assert _idle(eng)
    eng._tp.check()           # every rank is still well


def _prom_gauge(text, name):
    for line in text.splitlines():
        if line.startswith(f"paddle_tpu_serving_{name} "):
            return float(line.split()[-1])
    raise AssertionError(f"gauge {name} not in /metrics")


def test_mesh_gauges_healthz_metrics_agree(models):
    """A tp=2 replica behind HTTP: one completion served, and the mesh_*
    gauges and mesh_info backend label on /metrics agree with /healthz's
    mesh object."""
    _, tm = models
    engine = LLMEngine(tm, device="cpu", block_size=8, max_batch=2,
                       max_seq_len=96, mesh=cpu_mesh(2))

    async def get(port, path, body=None):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        if body is None:
            writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
        else:
            data = json.dumps(body).encode()
            writer.write(
                f"POST {path} HTTP/1.1\r\nHost: t\r\nContent-Type: "
                f"application/json\r\nContent-Length: {len(data)}\r\n\r\n"
                .encode() + data)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        return raw.partition(b"\r\n\r\n")[2]

    async def main():
        server = ServingServer(engine, host="127.0.0.1", port=0)
        await server.start()
        try:
            done = json.loads(await get(server.port, "/v1/completions",
                                        {"prompt": [1, 2, 3],
                                         "max_tokens": 4}))
            health = json.loads(await get(server.port, "/healthz"))
            text = (await get(server.port, "/metrics")).decode()
        finally:
            await server.shutdown(drain=True)
        return done, health, text

    procs = list(engine._tp.procs)
    try:
        done, health, text = asyncio.run(main())
    finally:
        engine.close()
    # the frontend's shutdown closed the engine, and its ranks with it
    assert not any(p.is_alive() for p in procs)
    assert [p.exitcode for p in procs] == [0]
    want = tm.generate(torch.tensor([[1, 2, 3]]), max_new_tokens=4,
                       temperature=0.0)[0, 3:].tolist()
    assert done["choices"][0]["token_ids"] == want
    mesh = health["mesh"]
    assert mesh["tp_degree"] == 2 and mesh["device_count"] == 2
    assert mesh["backend"] == "cpu"
    assert _prom_gauge(text, "mesh_tp_degree") == mesh["tp_degree"]
    assert _prom_gauge(text, "mesh_device_count") == mesh["device_count"]
    assert (f'paddle_tpu_serving_mesh_info{{backend="{mesh["backend"]}"}} 1'
            in text)


@pytest.mark.parametrize("how", ["raises", "dies", "controller", "build"])
def test_rank_failure_raises_on_the_controller(models, monkeypatch, how):
    """A rank that raises (an operation it cannot run) or dies (killed)
    makes the controller's next step raise `RankFailed` naming the rank
    and its error, never hang; so does rank 0 raising inside a step the
    ranks were told of (they wait in a collective it never reaches), or
    while building a program they were told to build. The
    supervisor does not bisect it but lets it escape; the engine stays
    failed; close() still ends every rank."""
    from paddle_tpu_torch.serving import engine as em

    _, tm = models
    eng = LLMEngine(tm, device="cpu", block_size=8, max_batch=2,
                    max_seq_len=96, mesh=cpu_mesh(2))
    try:
        assert eng.generate([[1, 2, 3]], max_new_tokens=2)
        rank = 1
        if how == "raises":
            eng._tp.send("no_such_operation")
            detail = "KeyError"
        elif how == "dies":
            eng._tp.procs[0].kill()
            eng._tp.procs[0].join(10)
            detail = "exited with code"
        elif how == "controller":
            def boom(prog):
                raise RuntimeError("rank 0 boom")

            monkeypatch.setattr(em._StepProgram, "__call__", boom)
            rank, detail = 0, "rank 0 boom"
        else:
            def boom(prog, engine, W):
                raise RuntimeError("rank 0 build boom")

            monkeypatch.setattr(em._StepProgram, "__init__", boom)
            eng._step_fns.clear()          # the next step builds anew
            rank, detail = 0, "rank 0 build boom"
        eng.add_request([4, 5, 6], max_new_tokens=3)
        with pytest.raises(RankFailed, match=detail) as exc:
            EngineSupervisor(eng).step()
        assert exc.value.rank == rank
        with pytest.raises(RankFailed):
            eng.step()
    finally:
        procs = list(eng._tp.procs)
        eng.close()
    assert not any(p.is_alive() for p in procs)


def test_ranks_build_each_program_before_the_controller(models,
                                                      monkeypatch):
    """The controller tells every rank to build a width bucket's program
    before it builds its own, and only then sends steps of that width:
    over NCCL a build runs and captures the step's collectives, which
    every rank must make together."""
    from paddle_tpu_torch.serving import engine as em

    _, tm = models
    events = []

    class Recorded(em._StepProgram):
        def __init__(self, engine, W):
            events.append(("program", W))
            super().__init__(engine, W)

    monkeypatch.setattr(em, "_StepProgram", Recorded)
    eng = LLMEngine(tm, device="cpu", mesh=cpu_mesh(2), **WAVE)
    send = eng._tp.send

    def spy(op, *args):
        if op in ("build", "step"):
            events.append((op, args[0]))
        return send(op, *args)

    eng._tp.send = spy
    try:
        _, prompts = _wave_prompts()
        assert eng.generate(prompts, max_new_tokens=6, temperature=0.0)
    finally:
        _closed(eng)
    built = [W for kind, W in events if kind == "program"]
    assert len(built) >= 2 and len(set(built)) == len(built)
    for W in built:
        i = events.index(("program", W))
        assert events[i - 1] == ("build", W)
        first_step = events.index(("step", W))
        assert first_step > i
    assert [e for e in events if e[0] == "build"] == [
        ("build", W) for W in built]


def test_no_rank_process_outlives_close(models):
    _, tm = models
    eng = LLMEngine(tm, device="cpu", block_size=8, max_batch=2,
                    max_seq_len=96, mesh=cpu_mesh(4))
    procs = list(eng._tp.procs)
    assert len(procs) == 3 and all(p.is_alive() for p in procs)
    assert eng.generate([[1, 2, 3]], max_new_tokens=2)
    eng.close()
    assert not any(p.is_alive() for p in procs)
    assert [p.exitcode for p in procs] == [0, 0, 0]
    eng.close()                  # idempotent
