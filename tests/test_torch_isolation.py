"""The port stands alone: no module of `paddle_tpu_torch`, and none of
`chip_smoke.py`, `torch_serve_profile.py`, `torch_train_profile.py`,
`torch_flash_bench.py` and `torch_paged_bench.py`, imports JAX, anything
of the JAX package `paddle_tpu`, or ml_dtypes (the card's machine has no
ml_dtypes: the port reads and writes bfloat16 checkpoints without it).
A tensor-parallel engine's rank process and a data-parallel training
rank, spawned from a test process that holds JAX, import none of them
either.

Roots are compared exactly: ``"paddle_tpu_torch".startswith("paddle_tpu")``
holds, so a prefix test would wrongly flag the port's own imports."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu", "ml_dtypes"}


def _port_files():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    return files + [ROOT / name for name in (
        "chip_smoke.py", "torch_serve_profile.py", "torch_train_profile.py",
        "torch_flash_bench.py", "torch_paged_bench.py")]


def _import_roots(path):
    """(line, root module) of every absolute import in `path`."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module.split(".")[0]))
    return out


def test_port_has_modules_and_a_smoke_script():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for want in ("paddle_tpu_torch/ops/paged_attention.py",
                 "paddle_tpu_torch/ops/kv_quantize_scatter.py",
                 "paddle_tpu_torch/ops/flash_attention.py",
                 "paddle_tpu_torch/ops/fused_ce.py",
                 "paddle_tpu_torch/optimizer/optimizers.py",
                 "paddle_tpu_torch/serving/engine.py",
                 "paddle_tpu_torch/serving/server.py",
                 "paddle_tpu_torch/serving/frontend.py",
                 "paddle_tpu_torch/models/gpt.py",
                 "paddle_tpu_torch/models/lora.py",
                 "paddle_tpu_torch/serving/kv_tier.py",
                 "paddle_tpu_torch/quantization/adaround.py",
                 "paddle_tpu_torch/optimizer/lr.py",
                 "paddle_tpu_torch/optimizer/optimizer.py",
                 "paddle_tpu_torch/nn/clip.py",
                 "paddle_tpu_torch/amp/auto_cast.py",
                 "paddle_tpu_torch/amp/grad_scaler.py",
                 "paddle_tpu_torch/distributed/fleet/utils.py",
                 "paddle_tpu_torch/profiler/tracing.py",
                 "paddle_tpu_torch/distributed/checkpoint.py",
                 "paddle_tpu_torch/nn/layer.py",
                 "paddle_tpu_torch/serving/router.py",
                 "paddle_tpu_torch/serving/autoscale.py",
                 "paddle_tpu_torch/serving/sharded.py",
                 "paddle_tpu_torch/serving/tp_worker.py",
                 "paddle_tpu_torch/parallel/collectives.py",
                 "paddle_tpu_torch/parallel/spmd.py",
                 "paddle_tpu_torch/distributed/ranks.py",
                 "paddle_tpu_torch/distributed/mesh.py",
                 "paddle_tpu_torch/distributed/fleet/meta_parallel/"
                 "sharding.py",
                 "paddle_tpu_torch/distributed/fleet/meta_parallel/"
                 "mp_layers.py",
                 "paddle_tpu_torch/distributed/fleet/meta_parallel/"
                 "parallel_wrappers.py",
                 "paddle_tpu_torch/distributed/fleet/fleet.py",
                 "paddle_tpu_torch/distributed/fleet/strategy.py",
                 "paddle_tpu_torch/distributed/fleet/meta_parallel/"
                 "pp_layers.py",
                 "paddle_tpu_torch/parallel/pipeline.py",
                 "paddle_tpu_torch/models/gpt_pipeline.py",
                 "paddle_tpu_torch/distributed/moe.py",
                 "paddle_tpu_torch/incubate/nn/functional.py",
                 "paddle_tpu_torch/parallel/sequence_attention.py",
                 "chip_smoke.py"):
        assert want in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_paddle_tpu_imports(path):
    bad = [(ln, root) for ln, root in _import_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_root_comparison_is_exact(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import paddle_tpu_torch.serving\n"
                 "from paddle_tpu.models import gpt\nimport jax.numpy\n")
    roots = [r for _, r in _import_roots(f)]
    assert roots == ["paddle_tpu_torch", "paddle_tpu", "jax"]
    assert [r for r in roots if r in FORBIDDEN] == ["paddle_tpu", "jax"]


def test_a_rank_process_imports_no_jax_or_paddle_tpu():
    """Spawned from this process (which has imported JAX), a tensor-parallel
    rank builds its engine from the port alone."""
    import jax  # noqa: F401  (the parent holds JAX)
    import torch

    from paddle_tpu_torch.models.gpt import GPT, GPTConfig
    from paddle_tpu_torch.serving import LLMEngine, build_serving_mesh

    model = GPT(GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                          num_heads=2, max_seq_len=32), device="cpu")
    eng = LLMEngine(model, device="cpu", block_size=8,
                    mesh=build_serving_mesh(2, device="cpu", timeout=60))
    try:
        assert eng.generate([[1, 2, 3]], max_new_tokens=2)
        roots = eng.rank_reports()[1]["modules"]
    finally:
        eng.close()
    assert "torch" in roots and "paddle_tpu_torch" in roots
    assert not FORBIDDEN & set(roots), sorted(FORBIDDEN & set(roots))
    assert torch is not None


def test_a_training_rank_imports_no_jax_or_paddle_tpu():
    """Spawned from this process (which has imported JAX), a data-parallel
    training rank builds its replica and steps from the port alone."""
    import jax  # noqa: F401  (the parent holds JAX)
    import numpy as np

    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.spmd import make_sharded_train_step

    model = GPT(GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                          num_heads=2, max_seq_len=32), device="cpu")
    opt = AdamW(learning_rate=0.01, parameters=model.named_parameters())
    mesh = build_mesh({"dp": 2}, device="cpu", timeout=60)
    try:
        step = make_sharded_train_step(model, gpt_loss_fn, opt, mesh,
                                       zero_stage=2)
        ids = np.arange(32).reshape(2, 16) % 64
        assert np.isfinite(step(ids, ids))
        roots = step.rank_reports()[1]["modules"]
    finally:
        mesh.close()
    assert "torch" in roots and "paddle_tpu_torch" in roots
    assert not FORBIDDEN & set(roots), sorted(FORBIDDEN & set(roots))


def test_an_mp_training_rank_imports_no_jax_or_paddle_tpu():
    """Spawned from this process (which has imported JAX), a rank of a dp
    x mp mesh builds its shard of the replica and steps (its Megatron
    layers' collectives included) from the port alone."""
    import jax  # noqa: F401  (the parent holds JAX)
    import numpy as np

    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models.gpt import GPT, GPTConfig, gpt_loss_fn
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.spmd import make_sharded_train_step

    model = GPT(GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                          num_heads=2, max_seq_len=32), device="cpu")
    opt = AdamW(learning_rate=0.01, parameters=model.named_parameters())
    mesh = build_mesh({"mp": 2}, device="cpu", timeout=60)
    try:
        step = make_sharded_train_step(model, gpt_loss_fn, opt, mesh)
        ids = np.arange(32).reshape(2, 16) % 64
        assert np.isfinite(step(ids, ids))
        roots = step.rank_reports()[1]["modules"]
    finally:
        mesh.close()
    assert "torch" in roots and "paddle_tpu_torch" in roots
    assert not FORBIDDEN & set(roots), sorted(FORBIDDEN & set(roots))


def test_a_pipeline_stage_rank_imports_no_jax_or_paddle_tpu():
    """Spawned from this process (which has imported JAX), the second
    stage of a pipelined GPT over {"pp": 2} builds its stage and trains
    (its sends and receives included) from the port alone."""
    import jax  # noqa: F401  (the parent holds JAX)
    import numpy as np

    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.models.gpt_pipeline import make_pipelined_gpt

    cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=2, max_seq_len=16)
    mesh = build_mesh({"pp": 2}, device="cpu", timeout=60)
    try:
        _, step = make_pipelined_gpt(cfg, mesh, 2, "1f1b")
        ids = np.arange(64).reshape(4, 16) % 64
        assert np.isfinite(step(ids, ids, 0.1))
        roots = step.rank_reports()[1]["modules"]
    finally:
        mesh.close()
    assert "torch" in roots and "paddle_tpu_torch" in roots
    assert not FORBIDDEN & set(roots), sorted(FORBIDDEN & set(roots))
