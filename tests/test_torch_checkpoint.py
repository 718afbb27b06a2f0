"""The port's checkpoint (`paddle_tpu_torch.distributed.checkpoint`),
skeleton models and streamed engine against the JAX package's, on the CPU.

The one-device cases of `tests/test_stream_checkpoint.py` run against
both packages (`side` is "jax" or "torch"): the streamed load equals the
eager load, the ``stream=True`` flag is the same load, a skeleton has
shapes and no storage, an engine refuses a skeleton without a checkpoint,
and checkpoint streaming excludes AdaRound. Then the crossings: a
JAX-saved float32 model loads into the port bit for bit and a port engine
streamed from it gives the JAX engine's greedy tokens; a port-saved
float32 checkpoint loads into the JAX package bit for bit; a JAX-saved
bfloat16 checkpoint loads into the port bit for bit and the port's bf16
members are the JAX package's bytes, header ``'<V2'`` included. The JAX
package cannot load that bf16 checkpoint itself (a reference fault this
file pins). The streamed engine's bounds: ``peak_host_bytes`` is the
largest leaf, ``max_chip_bytes`` the whole model, the budget refuses at
one byte below it, and the CLI serves two replicas from a checkpoint.
"""
import asyncio
import json
import os
import re
import signal
import subprocess
import sys
import zipfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.checkpoint as jckpt
import paddle_tpu_torch.distributed.checkpoint as tckpt
from paddle_tpu.core.functional import state_dict_arrays
from paddle_tpu.models.gpt import GPT as JaxGPT
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.nn.layer import is_skeleton as jax_is_skeleton
from paddle_tpu.nn.layer import skeleton_init as jax_skeleton_init
from paddle_tpu.serving import LLMEngine as JaxLLMEngine
from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_tiny
from paddle_tpu_torch.nn.layer import is_skeleton, skeleton_init
from paddle_tpu_torch.serving import LLMEngine
from paddle_tpu_torch.weights import from_jax_state_dict, to_jax_state_dict
from test_torch_serving_sharded import cpu_mesh
from test_torch_collectives import shared_cores  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=64)
ENGINE = dict(block_size=8, max_batch=2, max_seq_len=64)
SIDES = ("jax", "torch")


def _jax_model(**over):
    paddle.seed(0)
    m = JaxGPT(JaxGPTConfig(**{**CFG, **over}, attn_impl="xla",
                            dropout=0.0))
    m.eval()
    return m


def _jax_arrays(m):
    return {k: np.asarray(v) for k, v in state_dict_arrays(m)[0].items()}


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model) with the same float32 weights."""
    jm = _jax_model()
    tm = from_jax_state_dict(GPT(GPTConfig(**CFG), device="cpu"),
                             _jax_arrays(jm))
    return jm, tm


@pytest.fixture(scope="module")
def ckpts(models, tmp_path_factory):
    """{side: checkpoint dir} of the same model, each saved by its own
    package's `save_sharded_model`."""
    jm, tm = models
    root = tmp_path_factory.mktemp("ckpts")
    jckpt.save_sharded_model(jm, None, str(root / "jax"))
    tckpt.save_sharded_model(tm, None, str(root / "torch"))
    return {"jax": str(root / "jax"), "torch": str(root / "torch")}


def _np(a):
    """A loaded leaf as numpy (bf16 tensors as their int16 bits)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    return np.asarray(a)


def _skeleton(side, dtype=None, **over):
    cfg = {**CFG, **over}
    if side == "jax":
        with jax_skeleton_init():
            m = JaxGPT(JaxGPTConfig(**cfg, attn_impl="xla", dropout=0.0))
        m.eval()
        return m
    with skeleton_init():
        return GPT(GPTConfig(**cfg), dtype=dtype or torch.float32)


def _engine(side, model, **kw):
    if side == "jax":
        return JaxLLMEngine(model, **ENGINE, **kw)
    return LLMEngine(model, device="cpu", **ENGINE, **kw)


def _mod(side):
    return jckpt if side == "jax" else tckpt


PROMPTS = [np.random.RandomState(0).randint(0, 128, (n,)).tolist()
           for n in (5, 11, 8)]


def _greedy(engine):
    return engine.generate(PROMPTS, max_new_tokens=6, temperature=0.0)


# -- the one-device cases of test_stream_checkpoint.py, on both packages ----


@pytest.mark.parametrize("side", SIDES)
def test_stream_load_matches_eager_load(side, ckpts):
    mod = _mod(side)
    path = ckpts[side]
    eager = mod.load_state(path)
    tree, report = mod.stream_load_state(path)
    assert sorted(tree) == sorted(eager)
    for group in tree:
        assert sorted(tree[group]) == sorted(eager[group])
        for k, arr in tree[group].items():
            np.testing.assert_array_equal(_np(arr), _np(eager[group][k]))
    # the host bound: staging peaks at ONE leaf, never the tree
    assert 0 < report.peak_host_bytes < report.total_bytes
    assert report.arrays == sum(len(v) for v in eager.values())
    assert report.summary()["total_bytes"] == report.total_bytes


@pytest.mark.parametrize("side", SIDES)
def test_load_state_stream_flag_is_equivalent(side, ckpts):
    mod = _mod(side)
    a = mod.load_state(ckpts[side])
    b = mod.load_state(ckpts[side], stream=True)
    for group in a:
        for k in a[group]:
            np.testing.assert_array_equal(_np(a[group][k]), _np(b[group][k]))


@pytest.mark.parametrize("side", SIDES)
def test_skeleton_model_has_shapes_not_arrays(side):
    import jax

    skel = _skeleton(side)
    if side == "jax":
        assert jax_is_skeleton(skel)
        for _, p in skel.named_parameters_dict().items():
            assert isinstance(p._array, jax.ShapeDtypeStruct)
        assert not jax_is_skeleton(_jax_model())
        return
    assert is_skeleton(skel)
    assert all(p.is_meta for p in skel.parameters())
    assert skel.dropout_generators is None
    assert not is_skeleton(GPT(GPTConfig(**CFG), device="cpu"))


@pytest.mark.parametrize("side", SIDES)
def test_skeleton_engine_requires_checkpoint(side):
    with pytest.raises(ValueError, match="checkpoint_path"):
        _engine(side, _skeleton(side))


@pytest.mark.parametrize("side", SIDES)
def test_checkpoint_and_quantize_are_exclusive(side, models, ckpts):
    model = models[0] if side == "jax" else models[1]
    with pytest.raises(ValueError, match="mutually exclusive"):
        _engine(side, model, quantize="int8", checkpoint_path=ckpts[side])


@pytest.mark.parametrize("side", SIDES)
def test_streamed_engine_matches_the_eager_engine(side, models, ckpts):
    """A streamed skeleton engine serves the eager engine's greedy tokens
    (one package's checkpoint, one package's engines)."""
    model = models[0] if side == "jax" else models[1]
    got = _greedy(_engine(side, _skeleton(side),
                          checkpoint_path=ckpts[side]))
    assert got == _greedy(_engine(side, model))


@pytest.mark.parametrize("side", SIDES)
def test_streamed_engine_names_missing_and_mismatched_arrays(side, ckpts):
    """The two refusals of a checkpoint that does not fit the model, in
    the same words on both packages."""
    path = ckpts[side]
    with pytest.raises(ValueError, match=r"is missing model arrays .* was "
                       r"it saved from this architecture"):
        _engine(side, _skeleton(side, num_layers=3), checkpoint_path=path)
    with pytest.raises(ValueError) as e:
        _engine(side, _skeleton(side, vocab_size=256), checkpoint_path=path)
    assert str(e.value) == (
        f"checkpoint {path!r}: param 'wte.weight' is float32(128, 32) but "
        "the model declares float32(256, 32) — checkpoint and model config "
        "disagree")


def test_tree_helpers_match_jax():
    """`_flatten`, `_unflatten` and `_shard_slices` give the JAX package's
    keys and boxes."""
    tree = {"params": {"a.weight": 1, "b": {"c": 2}}, "buffers": {},
            "opt": {"a.weight": {"moment1": 3}}}
    assert tckpt._flatten(tree) == jckpt._flatten(tree)
    flat = tckpt._flatten(tree)
    assert tckpt._unflatten(flat) == jckpt._unflatten(flat)
    for index, shape in (((slice(None), slice(2, 4)), (3, 5)),
                         ((slice(1, None),), (7,)), ((), ())):
        assert tckpt._shard_slices(index, shape) == \
            jckpt._shard_slices(index, shape)


# -- tensor parallel: each rank streams its own slices -----------------------


def test_stream_load_reshards_onto_ranks(tmp_path):
    """A leaf saved whole streams back one box a rank: each rank gets
    exactly its slice, and its host staging and device bytes are 1/tp of
    the leaf, the JAX package's per-device numbers."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    w = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    tckpt.save_state({"params": {"w": torch.from_numpy(w)}},
                     str(tmp_path / "c"))
    mesh = Mesh(np.array(jax.devices()[:4]), ("tp",))
    _, jrep = jckpt.stream_load_state(
        str(tmp_path / "c"),
        shardings={"params/w": NamedSharding(mesh, P("tp", None))})
    for r in range(4):
        tree, rep = tckpt.stream_load_state(
            str(tmp_path / "c"), device="cpu",
            boxes={"params/w": [[4 * r, 4 * r + 4], [0, 8]]})
        np.testing.assert_array_equal(tree["params"]["w"].numpy(),
                                      w[4 * r:4 * r + 4])
        assert rep.max_chip_bytes == jrep.max_chip_bytes == w.nbytes // 4
        assert rep.peak_host_bytes == jrep.peak_host_bytes == w.nbytes // 4


def test_load_sharded_model_onto_a_rank(models, ckpts):
    """``load_sharded_model(mesh=...)`` fills a rank's shard module with
    its slices of each sharded parameter (Linear weights transposed back)
    and every replicated one whole."""
    from paddle_tpu_torch.serving.sharded import (ServingMesh, shard_module,
                                                  shard_of, tp_dim)

    _, tm = models
    mesh = ServingMesh(["cpu", "cpu"]).for_rank(1)
    own = shard_module(_skeleton("torch"), mesh, torch.device("cpu"))
    tckpt.load_sharded_model(own, None, ckpts["jax"], mesh=mesh)
    full = dict(tm.named_parameters())
    for name, p in own.named_parameters():
        want = shard_of(full[name].detach(), tp_dim(name), 1, 2)
        assert torch.equal(p.detach(), want), name
    assert own.blocks[0].attn.qkv.weight.shape == (48, 32)


@pytest.fixture(scope="module")
def streamed_tp4(ckpts):
    eng = LLMEngine(_skeleton("torch"), device="cpu", mesh=cpu_mesh(4),
                    checkpoint_path=ckpts["torch"], **ENGINE)
    yield eng
    eng.close()


def test_streamed_engine_reports_the_bound(models, streamed_tp4):
    """Per rank: its device holds its own shards, never the full tree,
    and its host staging peaks at one slice."""
    _, tm = models
    full = sum(p.numel() * p.element_size() for p in tm.parameters())
    reps = [r["load"] for r in streamed_tp4.rank_reports()]
    assert len(reps) == 4
    for rep in reps:
        assert 0 < rep["max_chip_bytes"] < full
        assert 0 < rep["peak_host_bytes"] < rep["total_bytes"]
        assert rep["devices"] == 1
    assert reps[0] == streamed_tp4.load_report.summary()
    assert streamed_tp4.metrics.gauges["ckpt_stream_max_chip_bytes"] == \
        streamed_tp4.load_report.max_chip_bytes
    assert len(streamed_tp4.param_bytes_by_device()) == 4


def test_too_big_for_eager_serves_streamed(models, ckpts, streamed_tp4):
    """The per-rank budget the streamed tp=4 engine meets refuses the
    eager path at construction (the caller's full model is charged to
    rank 0's device), before any rank is started."""
    _, tm = models
    budget = max(streamed_tp4.param_bytes_by_device().values())
    eng = LLMEngine(_skeleton("torch"), device="cpu", mesh=cpu_mesh(4),
                    checkpoint_path=ckpts["torch"], param_hbm_bytes=budget,
                    **ENGINE)
    try:
        assert max(eng.param_bytes_by_device().values()) <= budget
    finally:
        eng.close()
    with pytest.raises(ValueError, match="param_hbm_bytes"):
        LLMEngine(tm, device="cpu", mesh=cpu_mesh(4), param_hbm_bytes=budget,
                  **ENGINE)


def test_streamed_tp4_greedy_parity(models, ckpts, streamed_tp4):
    """Greedy serve off the streamed tp=4 engine equals a one-card engine
    streamed from the same checkpoint and the JAX streamed tp=4 engine."""
    ref = _greedy(_engine("torch", _skeleton("torch"),
                          checkpoint_path=ckpts["torch"]))
    jax_tp4 = _greedy(_engine("jax", _skeleton("jax"), mesh=4,
                              checkpoint_path=ckpts["torch"]))
    assert _greedy(streamed_tp4) == ref == jax_tp4


# -- crossings between the packages -----------------------------------------


def test_jax_saved_f32_loads_in_the_port_bit_for_bit(models, ckpts):
    jm, _ = models
    want = _jax_arrays(jm)
    tree = tckpt.load_state(ckpts["jax"])
    assert sorted(tree["params"]) == sorted(want)
    for k, a in want.items():
        assert np.array_equal(_np(tree["params"][k]), a), k
    fresh = GPT(GPTConfig(**CFG), device="cpu", seed=7)
    tckpt.load_sharded_model(fresh, None, ckpts["jax"])
    for k, a in to_jax_state_dict(fresh).items():
        assert np.array_equal(a, want[k]), k


def test_port_engine_from_a_jax_checkpoint_gives_jax_tokens(models, ckpts):
    jm, _ = models
    port = _greedy(_engine("torch", _skeleton("torch"),
                           checkpoint_path=ckpts["jax"]))
    assert port == _greedy(_engine("jax", jm))


def test_port_saved_f32_loads_in_jax_bit_for_bit(models, ckpts):
    jm, _ = models
    want = _jax_arrays(jm)
    for load in (jckpt.load_state,
                 lambda p: jckpt.stream_load_state(p)[0]):
        tree = load(ckpts["torch"])
        assert sorted(tree["params"]) == sorted(want)
        for k, a in want.items():
            assert np.array_equal(np.asarray(tree["params"][k]), a), k
    # and a JAX engine streamed from it serves the JAX model's tokens
    got = _greedy(_engine("jax", _skeleton("jax"),
                          checkpoint_path=ckpts["torch"]))
    assert got == _greedy(_engine("jax", jm))


@pytest.fixture(scope="module")
def bf16_ckpts(models, tmp_path_factory):
    """The JAX model's weights rounded to bf16, saved by JAX `save_state`
    (dir "jax") and by the port's (dir "torch") from the same values."""
    jm, _ = models
    root = tmp_path_factory.mktemp("bf16")
    jax_tree = {"params": {k: jnp.asarray(v, jnp.bfloat16)
                           for k, v in _jax_arrays(jm).items()}}
    jckpt.save_state(jax_tree, str(root / "jax"))
    port_tree = {"params": {k: torch.from_numpy(np.asarray(v, np.float32))
                            .to(torch.bfloat16)
                            for k, v in jax_tree["params"].items()}}
    tckpt.save_state(port_tree, str(root / "torch"))
    return jax_tree, str(root / "jax"), str(root / "torch")


def test_jax_saved_bf16_loads_in_the_port_bit_for_bit(bf16_ckpts):
    jax_tree, jdir, _ = bf16_ckpts
    for tree in (tckpt.load_state(jdir), tckpt.stream_load_state(jdir)[0]):
        for k, a in jax_tree["params"].items():
            got = tree["params"][k]
            assert got.dtype == torch.bfloat16
            assert np.array_equal(_np(got), np.asarray(a).view(np.int16)), k


def test_port_bf16_members_have_jax_bytes_and_header(bf16_ckpts):
    _, jdir, tdir = bf16_ckpts
    with zipfile.ZipFile(os.path.join(jdir, "shard_0.npz")) as jz, \
            zipfile.ZipFile(os.path.join(tdir, "shard_0.npz")) as tz:
        names = sorted(jz.namelist())
        assert sorted(tz.namelist()) == names
        for name in names:
            raw = tz.read(name)
            assert raw == jz.read(name), name
            assert b"'descr': '<V2'" in raw[:128]
    for d in (jdir, tdir):
        with open(os.path.join(d, "index.json")) as f:
            idx = json.load(f)
        assert {e["dtype"] for e in idx["arrays"].values()} == {"bfloat16"}


def test_port_bf16_engine_streams_a_jax_bf16_checkpoint(models, bf16_ckpts):
    """A bf16 skeleton streamed from the JAX-saved bf16 checkpoint serves
    the tokens of an eager port model holding the same bf16 values."""
    _, jdir, _ = bf16_ckpts
    eager = GPT(GPTConfig(**CFG), device="cpu", dtype=torch.bfloat16)
    tckpt.load_sharded_model(eager, None, jdir)
    streamed = _engine("torch", _skeleton("torch", dtype=torch.bfloat16),
                       checkpoint_path=jdir)
    for a, b in zip(streamed.model.parameters(), eager.parameters()):
        assert torch.equal(a, b)
    assert _greedy(streamed) == _greedy(_engine("torch", eager))


def test_jax_package_cannot_load_a_bf16_leaf(bf16_ckpts):
    """Reference fault, pinned and not copied: the JAX `save_state` writes
    a bf16 leaf as a '<V2' npy member, which its own `stream_load_state`
    and `load_state` then cannot read (ROADMAP Queue 3)."""
    _, jdir, _ = bf16_ckpts
    with pytest.raises(TypeError, match="not a valid JAX array type"):
        jckpt.stream_load_state(jdir)
    with pytest.raises(ValueError, match="No cast function"):
        jckpt.load_state(jdir)


# -- the streamed engine's bounds ---------------------------------------------


def test_peak_host_bytes_is_the_largest_leaf(models, ckpts):
    _, tm = models
    eng = _engine("torch", _skeleton("torch"), checkpoint_path=ckpts["torch"])
    rep = eng.load_report
    sizes = [p.numel() * p.element_size() for p in tm.parameters()]
    assert rep.peak_host_bytes == max(sizes)
    assert rep.total_bytes == rep.max_chip_bytes == sum(sizes)
    assert rep.arrays == len(sizes)
    assert list(rep.chip_bytes) == [torch.device("cpu")]
    assert eng.metrics.gauges["ckpt_stream_max_chip_bytes"] == sum(sizes)
    assert eng.metrics.gauges["ckpt_stream_peak_host_bytes"] == max(sizes)
    assert eng.param_bytes_by_device() == {torch.device("cpu"): sum(sizes)}


def test_budget_refuses_one_byte_below_the_model(models, ckpts):
    _, tm = models
    total = sum(p.numel() * p.element_size() for p in tm.parameters())
    path = ckpts["torch"]
    eng = _engine("torch", _skeleton("torch"), checkpoint_path=path,
                  param_hbm_bytes=total)
    assert max(eng.param_bytes_by_device().values()) == total
    with pytest.raises(ValueError, match=f"param_hbm_bytes {total - 1}: a "
                       f"device holds {total} parameter bytes"):
        _engine("torch", _skeleton("torch"), checkpoint_path=path,
                param_hbm_bytes=total - 1)
    # the eager path is charged for the caller's model as well
    with pytest.raises(ValueError, match="param_hbm_bytes"):
        _engine("torch", tm, param_hbm_bytes=total - 1)


def test_streamed_replicas_share_nothing_with_the_skeleton(ckpts):
    """Every streamed engine owns its module; the skeleton stays on meta."""
    skel = _skeleton("torch")
    a = _engine("torch", skel, checkpoint_path=ckpts["torch"])
    b = _engine("torch", skel, checkpoint_path=ckpts["torch"])
    assert is_skeleton(skel)
    assert a.model is not b.model and a.model is not skel
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q) and p.data_ptr() != q.data_ptr()
    assert _greedy(a) == _greedy(b)


async def _post(port, obj):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(obj).encode()
    writer.write((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(data)}\r\n\r\n").encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ")[1]), body


def test_cli_serves_two_replicas_from_a_checkpoint(tmp_path):
    """`python -m paddle_tpu_torch.serving.server --device cpu --replicas
    2 --checkpoint DIR` boots the fleet router over two streamed replicas,
    answers a completion with the eager model's tokens and drains on
    SIGINT."""
    model = gpt_tiny(device="cpu", seed=0)
    tckpt.save_sharded_model(model, None, str(tmp_path / "ckpt"))
    want = LLMEngine(model, device="cpu", max_seq_len=64).generate(
        [[1, 2, 3, 4]], max_new_tokens=3)[0]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_TPU_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.server",
         "--device", "cpu", "--port", "0", "--max-seq-len", "64",
         "--replicas", "2", "--checkpoint", str(tmp_path / "ckpt")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        port = int(re.search(r":(\d+) \(", line).group(1))
        status, body = asyncio.run(_post(
            port, {"prompt": [1, 2, 3, 4], "max_tokens": 3}))
        assert status == 200
        assert json.loads(body)["choices"][0]["token_ids"] == want
        assert "2-replica router on cpu" in line and "streamed" in line
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, proc.stderr.read()
